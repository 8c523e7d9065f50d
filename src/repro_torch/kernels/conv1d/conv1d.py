"""K6 on Hopper: the CUDA kernel of the causal depthwise conv1d and its
launch.

Replaces the JAX package's ``kernels/conv1d/conv1d.py``
``causal_conv1d_pallas`` / ``_kernel``.  CUDA source ``csrc/conv1d.cu``:
each thread walks a run of ``rows`` time rows of one sequence for its
channels, with the ``cw`` weights in registers and the ``cw - 1`` previous
inputs in a register queue, so every input row is loaded once (but for a
run's halo); f32 products and sums rounded once to the output type.  Two
builds of one body, chosen here from the shapes and pointers
(``build_of``): ``"vector"``, a 16-byte vector of channels a thread, and
``"lane"``, one channel a thread, for what the vector build cannot take.
Bound: device-memory bytes (x and w read once, y written once).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)
DTYPES = (torch.float32, torch.bfloat16)
# the largest conv width the kernel is built for (a compile-time queue)
MAX_WIDTH = 8
# time rows a thread walks (``tools/conv1d_tiles_ab.py`` times the others)
ROWS = 64
# bytes a thread of the vector build loads and stores a row
VECTOR_BYTES = 16


@functools.lru_cache(maxsize=None)
def source() -> "_build.Source":
    """The kernel's translation unit (read at first use)."""
    return _build.csrc_source("conv1d", "conv1d.cu")


def check_args(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on what the kernel does not take: ``x`` ``[B, T, W]`` and
    ``w`` ``[cw, W]`` (``1 ≤ cw ≤ MAX_WIDTH``), one dtype of ``DTYPES``,
    on one device, contiguous."""
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2] \
            or not 1 <= w.shape[0] <= MAX_WIDTH:
        raise ValueError(f"causal_conv1d: x {tuple(x.shape)} must be "
                         f"[B, T, W] and w {tuple(w.shape)} [cw, W] with "
                         f"1 <= cw <= {MAX_WIDTH}")
    if x.dtype != w.dtype or x.dtype not in DTYPES:
        raise TypeError(f"causal_conv1d: x and w must share one dtype of "
                        f"{DTYPES}, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"causal_conv1d: x on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("causal_conv1d: x and w must be contiguous")
    if x.shape[0] * x.shape[1] >= 2 ** 31:
        raise ValueError("causal_conv1d: B * T must be below 2^31")


def build_of(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor) -> str:
    """``"vector"`` where the width is a multiple of the 16-byte vector and
    the three bases lie on 16-byte boundaries, else ``"lane"``."""
    vec = VECTOR_BYTES // x.element_size()
    aligned = all(t.data_ptr() % VECTOR_BYTES == 0 for t in (x, w, y))
    return "vector" if x.shape[2] % vec == 0 and aligned else "lane"


def causal_conv1d_cuda(x: torch.Tensor, w: torch.Tensor, *,
                       rows: int = ROWS, build: str = None) -> torch.Tensor:
    """Launch K6 on the current stream of ``x``'s CUDA device; returns
    ``y`` like ``x``.  ``rows``: time rows a thread walks; ``build``: the
    build to launch (default ``build_of``; ``"vector"`` is refused where
    ``build_of`` says ``"lane"``).  Counts launches in
    ``causal_conv1d_cuda.launches``.  Raises for tensors off the card or on
    a failed launch."""
    check_args(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"causal_conv1d_cuda: tensors on {x.device}, "
                         "not on a CUDA device")
    B, T, W = x.shape
    y = torch.empty_like(x)
    chosen = build_of(x, w, y)
    build = build or chosen
    if build not in ("vector", "lane") or (build == "vector" and chosen != build):
        raise ValueError(f"causal_conv1d_cuda: build {build!r} does not take "
                         f"these tensors (build_of: {chosen!r})")
    if rows < 1:
        raise ValueError(f"causal_conv1d_cuda: rows {rows} < 1")
    fn = _build.load(source(), "rt_causal_conv1d", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), B, T, W,
                 w.shape[0], int(x.dtype == torch.bfloat16),
                 int(build == "vector"), rows,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"causal_conv1d launch failed: cudaError {err}")
    causal_conv1d_cuda.launches += 1
    return y


causal_conv1d_cuda.launches = 0
