"""Distributed helpers the port needs so far: checkpoints in the
reference's format, the tree key paths they use, the data resume layout."""
