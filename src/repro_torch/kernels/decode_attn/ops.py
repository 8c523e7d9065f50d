"""Entry point of K7: flash decode attention on any device."""
from __future__ import annotations

from .decode_attn import DEFAULT_BLOCK_S, check_args, decode_attention_cuda
from .ref import decode_attention_ref


def decode_attention(q, k, v, lengths, block_s: int = DEFAULT_BLOCK_S):
    """q: [B,H,hd]; k,v: [B,S,K,hd]; lengths: [B] int32 → [B,H,hd].  CUDA
    tensors launch the kernels (split and combine; ``block_s`` cache
    positions per step of a split block's loop) or raise; CPU tensors run
    the plain version."""
    check_args(q, k, v, lengths, block_s)
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k, v, lengths, block_s)
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return decode_attention_ref(q, k, v, lengths)
