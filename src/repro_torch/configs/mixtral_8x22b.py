"""Mixtral 8x22B — 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention [arXiv:2401.04088; hf].
"""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    act="swiglu",
    window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25,
                  group_size=4096),
    rope_theta=1e6,
    attn_chunk=1024,
    logits_chunk=None,
))
