"""Deterministic data resume: the sequence-index layout of
:meth:`repro_torch.data.synthetic.SyntheticLM.batch`.

Mesh re-planning (``plan_mesh``) arrives with the distributed slice.
"""
from __future__ import annotations

from typing import Tuple


def resume_batch_indices(step: int, batch_per_host: int, host: int,
                         n_hosts: int) -> Tuple[int, ...]:
    """Global sequence indices host ``host`` of ``n_hosts`` draws at
    ``step`` — the exact strided layout of ``SyntheticLM.batch`` (host
    shards interleave so the global batch is invariant to ``n_hosts``)."""
    if not 0 <= host < n_hosts:
        raise ValueError(f"host {host} out of range for n_hosts={n_hosts}")
    base = step * batch_per_host * n_hosts
    return tuple(base + j * n_hosts + host for j in range(batch_per_host))
