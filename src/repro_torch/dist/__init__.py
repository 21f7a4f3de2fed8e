"""Distributed helpers: checkpoints in the reference's format and the tree
key paths they use, the data resume layout and mesh re-planning, the
logical-axis sharding rules and each rank's shard of a tree, and the
collectives of tensor-parallel serving."""
