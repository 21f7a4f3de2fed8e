"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
The attention branch uses a sliding window (1024), which makes the arch
sub-quadratic.  Vocab padded 32001 -> 32256 internally.  Every quantized
input width (1600, 3200, 5504) is a multiple of 64, so int4 at g = 64
keeps g = 64 (at g = 128, d_model 1600 falls back to 100).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64, rope_theta=1e4,
    ssm_state=16, ssm_expand=2, ssm_conv=4, sliding_window=1024,
)
