"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.  Backbone only:
the vision tower is a stub, and batches carry precomputed patch
embeddings that are prepended to the token stream.  M-RoPE sections
(t,h,w) = (16, 24, 24) over head_dim/2 = 64.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128, rope_theta=1e6,
    mrope_sections=(16, 24, 24), patch_len=256,
)
