"""Model registry: build an architecture from its config (every family
of the reference: dense, MoE, VLM, hybrid, ssm and audio)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from .dense import DenseLM
from .hymba import HymbaLM
from .moe import MoELM
from .vlm import VLM
from .whisper import WhisperLM
from .xlstm import XLSTMLM

FAMILIES = {
    "dense": DenseLM,
    "moe": MoELM,
    "vlm": VLM,
    "hybrid": HymbaLM,
    "ssm": XLSTMLM,
    "audio": WhisperLM,
}


def build_model(cfg: ModelConfig):
    try:
        cls = FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r} for {cfg.name}") \
            from None
    return cls(cfg)
