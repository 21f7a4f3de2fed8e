"""Model registry: build an architecture from its config (dense family so
far; the other families arrive with their slices)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from .dense import DenseLM

FAMILIES = {
    "dense": DenseLM,
}


def build_model(cfg: ModelConfig):
    try:
        cls = FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown or not yet ported family {cfg.family!r} "
                         f"for {cfg.name}") from None
    return cls(cfg)
