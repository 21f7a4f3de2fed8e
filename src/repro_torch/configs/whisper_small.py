"""whisper-small [audio] — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356; hf:openai/whisper-small].

12L decoder d_model=768 12H (kv=12, MHA) d_ff=3072 vocab=51865 (padded
to 52224).  12 encoder layers over stub frame embeddings: 1500 frames
padded to 1536.  Entry points take precomputed frame embeddings ``frames
(B, 1536, 768)``; there is no mel / conv frontend.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64, rope_theta=1e4,
    n_encoder_layers=12, encoder_len=1536,
)
