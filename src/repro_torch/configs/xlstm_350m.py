"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

24L d_model=1024 4H (kv=4) d_ff=0 (the projections live inside the xLSTM
blocks, proj_factor 2: d_inner 2048) vocab=50304 (padded to 50432).  An
sLSTM block every 4th layer (positions 3, 7, ...), the rest mLSTM.  The
mLSTM head is d_inner / 4 = 512 wide and the sLSTM head d_model / 4 =
256; ``head_dim=256`` is the sLSTM's.  Recurrent state, no KV cache.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=256, rope_theta=1e4,
    ssm_state=0, slstm_every=4,
)
