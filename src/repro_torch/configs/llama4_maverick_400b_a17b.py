"""llama4-maverick-400b-a17b [moe] — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts
top-1 + 1 shared expert per layer.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128, rope_theta=5e5,
    n_experts=128, experts_per_token=1,
    n_shared_experts=1, shared_expert_ff=8192,
)
