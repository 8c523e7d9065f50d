"""Gemma 7B — 28L d_model=3072 16H (kv=16, i.e. MHA) d_ff=24576
vocab=256000, GeGLU, head_dim=256 [arXiv:2403.08295; hf].
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab=256000,
    head_dim=256,
    act="geglu",
    tie_embeddings=True,
    rope_theta=10000.0,
    attn_chunk=1024,
    logits_chunk=256,
))
