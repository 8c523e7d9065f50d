"""Mixtral 8x7B — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8 experts top-2, sliding-window attention (4096) [arXiv:2401.04088; hf].
"""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    act="swiglu",
    window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25,
                  group_size=4096),
    rope_theta=1e6,
    attn_chunk=1024,
    logits_chunk=None,
))
