"""K7 on Hopper: the CUDA kernels of flash decode attention and their launch.

Replaces the JAX package's ``kernels/decode_attn/decode_attn.py``
``decode_attention_pallas`` / ``_kernel``.  CUDA source
``csrc/decode_attn.cu``, split over the sequence (flash-decoding) in two
hand-written kernels: the split pass gives each (split, KV head, batch
row) block a contiguous range of ``chunk`` positions, walked ``block_s``
at a time with the key and value rows copied into shared memory by
``cp.async`` (16-byte copies, double-buffered), and writes its partial
online-softmax state (m, l, acc) in f32; the combine pass merges the
partials of each (batch row, KV head, query row) into the output.
``split_plan`` picks the number of splits from ``B·K`` and the card's SM
count.  Bound: device-memory bytes (K and V read once up to each row's
length).  As in the JAX package, nothing on the serving path calls it: the
model's decode attention is ``layers._sdpa``.

``decode_attention_cuda.launches`` counts calls (two kernel launches a
call); ``split_cuda.launches`` and ``combine_cuda.launches`` count each
kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_SPLIT_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 8 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
_COMBINE_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8 + (
    ctypes.c_void_p,)
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
HEAD_DIM_MULTIPLE = 8         # a lane holds 8 cells of a row (16-byte copies)
MAX_GROUP = 32                # query heads a KV head serves (4 rows a warp)
MAX_SMEM = 232448             # bytes of shared memory a block may use (H100)
BLOCKS_PER_SM = 2             # split blocks the plan aims at, per SM
DEFAULT_BLOCK_S = 32          # positions a step of a split block's loop


@functools.lru_cache(maxsize=None)
def source() -> "_build.Source":
    """The kernels' translation unit (read at first use)."""
    return _build.csrc_source("decode_attn", "decode_attn.cu")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(B: int, K: int, S: int, block_s: int, n_sm: int):
    """``(splits, chunk)``: the split pass runs ``splits`` blocks for each
    of the ``B·K`` (batch row, KV head) pairs, block ``s`` taking positions
    ``[s·chunk, (s+1)·chunk)``.  ``chunk`` is a multiple of ``block_s``,
    chosen so that the grid holds about ``BLOCKS_PER_SM`` blocks for each
    of the ``n_sm`` SMs (at least one split), and ``splits`` covers ``S``."""
    want = max(1, -(-BLOCKS_PER_SM * n_sm // max(1, B * K)))
    chunk = max(1, -(-S // want))
    chunk = -(-chunk // block_s) * block_s
    return max(1, -(-S // chunk)), chunk


def smem_bytes(G: int, hd: int, block_s: int, itemsize: int) -> int:
    """Shared memory of one split block: the query rows ([G, hd] f32), the
    tile's logits ([G, block_s] f32), m, l and the correction, and two
    stages of the tile's key and value rows ([block_s, hd] each,
    ``itemsize`` bytes)."""
    return 4 * (G * hd + G * block_s + 3 * G) + 4 * block_s * hd * itemsize


def check_args(q, k, v, lengths, block_s: int) -> None:
    """Raise on what the kernels do not take: q ``[B, H, hd]``, k and v
    ``[B, S, K, hd]`` with ``K`` dividing ``H`` into groups of at most
    ``MAX_GROUP``, ``hd`` a multiple of 8 and at most 256, one dtype of
    ``DTYPES``, ``lengths`` ``[B]`` int32, all on one device and
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
    if hd > MAX_HEAD_DIM or hd % HEAD_DIM_MULTIPLE or G > MAX_GROUP \
            or block_s < 1 or smem > MAX_SMEM:
        raise ValueError(
            f"decode_attention: head_dim {hd} (a multiple of "
            f"{HEAD_DIM_MULTIPLE}, ≤ {MAX_HEAD_DIM}), G {G} (≤ {MAX_GROUP}) "
            f"and block_s {block_s} need {smem} bytes of shared memory "
            f"(≤ {MAX_SMEM})")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def split_cuda(q, k, v, lengths, block_s: int, splits: int, chunk: int):
    """The split pass on the current stream: returns the partials
    ``(acc [B, K, splits, G, hd], ml [B, K, splits, G, 2])`` in f32 (m, l
    in ``ml``); only splits ``i < ceil(length / chunk)`` of a row are
    written.  Counts launches in ``split_cuda.launches``."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention: q, k and v must be 16-byte "
                             "aligned (the kernel copies 16 bytes at a time)")
    acc = torch.empty((B, K, splits, G, hd), dtype=torch.float32,
                      device=q.device)
    ml = torch.empty((B, K, splits, G, 2), dtype=torch.float32, device=q.device)
    fn = _build.load(source(), "rt_decode_attn_split", _SPLIT_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 acc.data_ptr(), ml.data_ptr(), B, S, K, G, hd, block_s,
                 splits, chunk, hd ** -0.5, int(q.dtype == torch.bfloat16),
                 _stream(q))
    if err:
        raise RuntimeError(f"decode_attention split launch failed: "
                           f"cudaError {err}")
    split_cuda.launches += 1
    return acc, ml


def combine_cuda(acc, ml, lengths, S: int, chunk: int, dtype):
    """The combine pass on the current stream: ``[B, K·G, hd]`` of
    ``dtype`` from the split pass's partials.  Counts launches in
    ``combine_cuda.launches``."""
    B, K, splits, G, hd = acc.shape
    o = torch.empty((B, K * G, hd), dtype=dtype, device=acc.device)
    fn = _build.load(source(), "rt_decode_attn_combine", _COMBINE_ARGTYPES)
    with torch.cuda.device(acc.device):
        err = fn(acc.data_ptr(), ml.data_ptr(), lengths.data_ptr(),
                 o.data_ptr(), B, S, K, G, hd, splits, chunk,
                 int(dtype == torch.bfloat16), _stream(acc))
    if err:
        raise RuntimeError(f"decode_attention combine launch failed: "
                           f"cudaError {err}")
    combine_cuda.launches += 1
    return o


def decode_attention_cuda(q, k, v, lengths, block_s: int = DEFAULT_BLOCK_S):
    """K7 on the current stream of ``q``'s CUDA device: the split pass and
    the combine pass (``split_plan``); returns ``[B, H, hd]`` like ``q``.
    Counts calls in ``decode_attention_cuda.launches``.  Raises for
    tensors off the card or on a failed launch."""
    check_args(q, k, v, lengths, block_s)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_cuda: tensors on {q.device}, "
                         "not on a CUDA device")
    B, S, K = k.shape[0], k.shape[1], k.shape[2]
    index = q.device.index
    splits, chunk = split_plan(B, K, S, block_s, sm_count(
        torch.cuda.current_device() if index is None else index))
    acc, ml = split_cuda(q, k, v, lengths, block_s, splits, chunk)
    o = combine_cuda(acc, ml, lengths, S, chunk, q.dtype)
    decode_attention_cuda.launches += 1
    return o


decode_attention_cuda.launches = 0
split_cuda.launches = 0
combine_cuda.launches = 0
