"""Model registry: build an architecture from its config (the dense and
MoE families so far; the others arrive with their slices)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from .dense import DenseLM
from .moe import MoELM

FAMILIES = {
    "dense": DenseLM,
    "moe": MoELM,
}


def build_model(cfg: ModelConfig):
    try:
        cls = FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown or not yet ported family {cfg.family!r} "
                         f"for {cfg.name}") from None
    return cls(cfg)
