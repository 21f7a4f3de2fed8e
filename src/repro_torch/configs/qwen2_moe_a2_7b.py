"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (kv=16, MHA) per-expert d_ff=1408 vocab=151936,
60 routed experts top-4 (padded to 64 for the 16-way expert-parallel
axis; pad experts are masked in the router) + shared expert block of
intermediate 4*1408=5632.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936, head_dim=128, rope_theta=1e6,
    n_experts=60, experts_per_token=4,
    n_shared_experts=1, shared_expert_ff=5632,
)
