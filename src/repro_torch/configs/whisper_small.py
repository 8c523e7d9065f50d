"""Whisper small — 12L enc + 12L dec, d_model=768 12H (kv=12) d_ff=3072
vocab=51865, encoder-decoder with conv frontend (STUB: ``input_specs``
provides precomputed frame embeddings; kernels/conv1d demonstrates the
real op) [arXiv:2212.04356; unverified].
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=24,                    # total (12 enc + 12 dec) for bookkeeping
    n_enc_layers=12,
    n_dec_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    rope_theta=10000.0,
    attn_chunk=1024,
    logits_chunk=1024,
))
