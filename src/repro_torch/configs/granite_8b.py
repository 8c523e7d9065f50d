"""Granite 8B (code) — 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152, llama-arch SwiGLU [arXiv:2405.04324; hf].
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    act="swiglu",
    rope_theta=10000.0,
    attn_chunk=1024,
    logits_chunk=1024,
))
