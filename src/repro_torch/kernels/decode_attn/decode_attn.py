"""K7 on Hopper: the CUDA kernel of flash decode attention and its launch.

Replaces the JAX package's ``kernels/decode_attn/decode_attn.py``
``decode_attention_pallas`` / ``_kernel``.  CUDA source
``csrc/decode_attn.cu``: one thread block per (batch row, KV head) walks
the cache ``block_s`` positions at a time up to the row's length, each
block of key and value rows staged in shared memory, q·k by warp
reductions over ``hd``, the online-softmax state (m, l, acc) in f32 in
shared memory.  Bound: device-memory bytes (K and V read once up to each
row's length).  As in the JAX package, nothing on the serving path calls
it: the model's decode attention is ``layers._sdpa``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
MAX_SMEM = 232448             # bytes of shared memory a block may use (H100)


@functools.lru_cache(maxsize=None)
def source() -> "_build.Source":
    """The kernel's translation unit (read at first use)."""
    return _build.csrc_source("decode_attn", "decode_attn.cu")


def smem_bytes(G: int, hd: int, block_s: int, itemsize: int) -> int:
    """Shared memory of one block: q rows and acc ([G, hd] f32 each), the
    block's logits ([G, block_s] f32), m, l and the correction, and the
    staged key and value rows ([block_s, hd] each, ``itemsize`` bytes)."""
    return 4 * (2 * G * hd + G * block_s + 3 * G) + 2 * block_s * hd * itemsize


def check_args(q, k, v, lengths, block_s: int) -> None:
    """Raise on what the kernel does not take: q ``[B, H, hd]``, k and v
    ``[B, S, K, hd]`` with ``K`` dividing ``H`` and ``hd ≤ 256``, one dtype
    of ``DTYPES``, ``lengths`` ``[B]`` int32, all on one device and
    contiguous, and a shared-memory footprint a block can have."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[2] \
            or q.shape[1] % k.shape[2] or tuple(lengths.shape) != (q.shape[0],):
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} must be [B, H, hd], k "
            f"{tuple(k.shape)} and v {tuple(v.shape)} [B, S, K, hd] with K "
            f"dividing H, lengths {tuple(lengths.shape)} [B]")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"decode_attention: q, k, v must share one dtype of "
                        f"{DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"decode_attention: lengths must be int32, got "
                        f"{lengths.dtype}")
    if len({t.device for t in (q, k, v, lengths)}) != 1:
        raise ValueError("decode_attention: q, k, v and lengths must be on "
                         "one device")
    if not all(t.is_contiguous() for t in (q, k, v, lengths)):
        raise ValueError("decode_attention: inputs must be contiguous")
    B, H, hd = q.shape
    G = H // k.shape[2]
    smem = smem_bytes(G, hd, block_s, q.element_size())
    if hd > MAX_HEAD_DIM or block_s < 1 or smem > MAX_SMEM:
        raise ValueError(
            f"decode_attention: head_dim {hd} (≤ {MAX_HEAD_DIM}), G {G} and "
            f"block_s {block_s} need {smem} bytes of shared memory "
            f"(≤ {MAX_SMEM})")


def decode_attention_cuda(q, k, v, lengths, block_s: int = 64):
    """Launch K7 on the current stream of ``q``'s CUDA device; returns
    ``[B, H, hd]`` like ``q``.  Counts launches in
    ``decode_attention_cuda.launches``.  Raises for tensors off the card or
    on a failed launch."""
    check_args(q, k, v, lengths, block_s)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_cuda: tensors on {q.device}, "
                         "not on a CUDA device")
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    fn = _build.load(source(), "rt_decode_attn", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 o.data_ptr(), B, S, K, H // K, hd, block_s, hd ** -0.5,
                 int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    decode_attention_cuda.launches += 1
    return o


decode_attention_cuda.launches = 0
