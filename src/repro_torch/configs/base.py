"""Model configuration dataclass (the port's own copy of ``ModelConfig``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    rope_theta: float = 5e5
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = False             # checkpoint each block in the layer scan
    kv_cache_bits: int = 16         # 8 -> int8 KV cache (+per-entry scales)
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    shared_expert_ff: int = 0
    moe_capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0            # 0 -> ceil(d_model / 16)
    slstm_every: int = 0            # xLSTM: a sLSTM block every k layers
    sliding_window: int = 0         # hymba attention branch window (0 = full)
    # --- enc-dec (whisper) ---
    n_encoder_layers: int = 0
    encoder_len: int = 1536         # stub frame count (1500 padded for sharding)
    # --- vlm ---
    mrope_sections: Tuple[int, ...] = ()
    patch_len: int = 256            # stub image patch count

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    def tiny(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=256 if self.d_ff else 0,
            head_dim=32,
            vocab_size=512,
            dtype="float32",
            n_experts=min(self.n_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            shared_expert_ff=256 if self.shared_expert_ff else 0,
            ssm_state=min(self.ssm_state, 8),
            ssm_dt_rank=8 if self.ssm_state else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_len=32,
            sliding_window=16 if self.sliding_window else 0,
            slstm_every=self.slstm_every,
            patch_len=8 if self.patch_len and self.family == "vlm" else self.patch_len,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """A production shape: sequence length and global batch of a train,
    prefill or decode run (the reference's cells, entry for entry)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeCell("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeCell("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeCell("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeCell("long_500k", 524288, 1, "decode")

SHAPE_CELLS = {c.name: c for c in
               (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# Families with sub-quadratic sequence mixing: the only ones that run
# long_500k (the reference's DESIGN.md section 6).
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> bool:
    """Whether ``cfg`` runs ``cell`` (the reference's rule: long_500k only
    for the sub-quadratic families)."""
    if cell.name == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True
