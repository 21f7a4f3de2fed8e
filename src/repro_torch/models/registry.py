"""Model registry: build an architecture from its config (the dense, MoE,
VLM and hybrid families so far; the others arrive with their slices)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from .dense import DenseLM
from .hymba import HymbaLM
from .moe import MoELM
from .vlm import VLM

FAMILIES = {
    "dense": DenseLM,
    "moe": MoELM,
    "vlm": VLM,
    "hybrid": HymbaLM,
}


def build_model(cfg: ModelConfig):
    try:
        cls = FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown or not yet ported family {cfg.family!r} "
                         f"for {cfg.name}") from None
    return cls(cfg)
