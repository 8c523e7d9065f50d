"""xLSTM 1.3B — 48 blocks d_model=2048 4H (kv=4) vocab=50304,
mLSTM blocks with sLSTM every 8th (7:1 ratio) [arXiv:2405.04517;
unverified].  d_ff=0: xLSTM blocks have no separate FFN.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=512,
    act="gelu",
    slstm_every=8,
    chunk=256,
    tie_embeddings=True,
    logits_chunk=1024,
))
