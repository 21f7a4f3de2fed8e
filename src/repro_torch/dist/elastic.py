"""Elastic re-mesh planning and deterministic data resume.

When a host dies mid-run the job restarts on fewer chips.  Two things
re-derive deterministically, as in the reference:

* the mesh — :func:`plan_mesh` shrinks the **data** axis (model
  parallelism is fixed by the weight layout) to the largest grid that fits
  the surviving chips, never idling a full replica row;
* the data position — :func:`resume_batch_indices` reproduces exactly the
  sequence indices :meth:`repro_torch.data.synthetic.SyntheticLM.batch`
  hands a given ``(step, host, n_hosts)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple


class MeshPlan(NamedTuple):
    """A usable ``pods x data x model`` grid over surviving chips."""
    data: int
    model: int
    pods: int
    used_chips: int
    idle_chips: int
    old_data: Optional[int]

    @property
    def data_scale(self) -> Optional[float]:
        """new / old data-parallel width (per-replica batch rescale
        factor); None when the pre-failure width is unknown."""
        return None if self.old_data is None else self.data / self.old_data


def plan_mesh(chips: int, *, model: int, old_data: Optional[int] = None,
              pods: int = 1) -> MeshPlan:
    """Largest ``pods x data x model`` grid on ``chips`` surviving chips:
    ``model`` and ``pods`` are fixed, so ``data = chips // (pods *
    model)``; leftover chips idle.  Raises ``RuntimeError`` when not even
    one replica fits."""
    if model < 1 or pods < 1:
        raise ValueError(f"model={model} and pods={pods} must be >= 1")
    data = chips // (pods * model)
    if data < 1:
        raise RuntimeError(
            f"{chips} chips cannot hold one pods={pods} x model={model} "
            f"replica ({pods * model} chips needed)")
    used = pods * data * model
    return MeshPlan(data=data, model=model, pods=pods, used_chips=used,
                    idle_chips=chips - used, old_data=old_data)


def resume_batch_indices(step: int, batch_per_host: int, host: int,
                         n_hosts: int) -> Tuple[int, ...]:
    """Global sequence indices host ``host`` of ``n_hosts`` draws at
    ``step`` — the exact strided layout of ``SyntheticLM.batch`` (host
    shards interleave so the global batch is invariant to ``n_hosts``)."""
    if not 0 <= host < n_hosts:
        raise ValueError(f"host {host} out of range for n_hosts={n_hosts}")
    base = step * batch_per_host * n_hosts
    return tuple(base + j * n_hosts + host for j in range(batch_per_host))
