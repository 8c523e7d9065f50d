"""Phi-3-mini 3.8B — 32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064,
RoPE SwiGLU [arXiv:2404.14219; unverified].
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    act="swiglu",
    rope_theta=10000.0,
    attn_chunk=1024,
    logits_chunk=None,
))
