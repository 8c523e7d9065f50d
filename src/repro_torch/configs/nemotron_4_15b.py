"""Nemotron-4 15B — 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000, squared-ReLU MLP [arXiv:2402.16819; unverified].
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    act="sqrelu",
    norm="layernorm",
    rope_theta=10000.0,
    attn_chunk=1024,
    logits_chunk=256,
))
