"""Pixtral 12B — 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072,
Mistral-Nemo backbone with Pixtral-ViT frontend (STUB: ``input_specs``
provides precomputed patch embeddings) [hf:mistralai/Pixtral-12B-2409;
unverified].  head_dim=128 (explicit, not d_model/n_heads).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    act="swiglu",
    n_prefix_tokens=1024,           # 32x32-patch image prefix (stub)
    rope_theta=1e6,
    attn_chunk=1024,
    logits_chunk=512,
))
