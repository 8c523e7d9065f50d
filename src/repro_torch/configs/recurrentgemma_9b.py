"""RecurrentGemma 9B (Griffin) — 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000, RG-LRU + local attention 1:2 pattern
[arXiv:2402.19427; unverified].
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    act="geglu",
    tie_embeddings=True,
    block_pattern=("rec", "rec", "attn"),
    rnn_width=4096,
    conv_width=4,
    local_window=2048,
    rope_theta=10000.0,
    attn_chunk=1024,
    logits_chunk=256,
))
