"""StencilIR → hand-written Hopper CUDA kernels: the fused time-loop plan.

``CudaPlan`` is the counterpart of the JAX package's ``PallasPlan``: it
splits a fused time loop into

  ``to_padded``   — one-time layout stage per fusion window: each operand
                    grid cut to its layout halo ``hw`` and made contiguous
                    (one conversion per grid, counted in ``PAD_COUNT``;
                    a grid whose halo already equals ``hw`` is used as it
                    is, so its buffer is then advanced in place);
  ``step``        — one kernel launch per time step on the layout buffers:
                    K1 (``fused_step``, templates gmem/smem/f4) or K2
                    (``stream_step``, templates shift/unroll); outputs are
                    written in place, which is legal because output grids
                    must have center-only taps;
  ``from_padded`` — write the touched grids' layout interiors back.

Grids named in ``swap`` share one layout halo, the larger of their tap
halos, so their buffers can trade names between steps.  There is no
whole-block ring as on the TPU: the kernels mask their own ragged edge, so
``hbm_bytes_per_step`` counts what they actually move.  2D stencils run as
3D ones of shape ``(R0, 1, R1)`` (tap ``(a, b)`` → ``(a, 0, b)``).

The kernels' structure is hand-written (``csrc/fused_step.cuh``,
``csrc/stream_step.cuh``); only the per-point expression is generated
(``emit.py``) and compiled at first use (``_build.py``).
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import analysis, ir

from . import emit

# threads cover b1 x b2 points; the streaming kernel walks b0 planes
DEFAULT_BLOCK = {"fused": {2: (1, 256), 3: (1, 8, 32)},
                 "stream": {2: (64, 256), 3: (64, 8, 32)}}
STREAM_TEMPLATES = ("shift", "unroll")
SMEM_LIMIT = 227 * 1024          # shared memory one block may use on sm_90

# layout conversions per grid name: one per grid per fusion window
PAD_COUNT: collections.Counter = collections.Counter()
# modeled traffic of the fused path: grid reads, grid writes, steps
TRAFFIC_COUNT: collections.Counter = collections.Counter()


def reset_pad_count() -> None:
    """Clear ``PAD_COUNT``."""
    PAD_COUNT.clear()


def reset_traffic_count() -> None:
    """Clear ``TRAFFIC_COUNT``."""
    TRAFFIC_COUNT.clear()


def to3(t, fill: int) -> Tuple[int, int, int]:
    """A 2D tuple in the kernels' 3D form: ``(a, b)`` → ``(a, fill, b)``."""
    t = tuple(int(x) for x in t)
    return t if len(t) == 3 else (t[0], fill, t[1])


def choose_block(user_block, template: str, ndim: int) -> Tuple[int, ...]:
    """The tile in points (the port's own defaults, see ``DEFAULT_BLOCK``)."""
    if user_block is not None:
        if len(user_block) != ndim:
            raise ValueError(f"block must have {ndim} dims")
        return tuple(int(b) for b in user_block)
    kind = "stream" if template in STREAM_TEMPLATES else "fused"
    return DEFAULT_BLOCK[kind][ndim]


class CudaPlan:
    """Layout and per-step kernel stage of the hopper backend for one
    (kernel, halos, interior, backend, swap); see the module docstring."""

    def __init__(self, kernel: ir.StencilIR,
                 halos: Dict[str, Tuple[int, ...]],
                 interior_shape: Tuple[int, ...],
                 backend,
                 swap: Optional[Tuple[str, str]] = None):
        info = analysis.analyze(kernel)
        ndim = kernel.ndim
        if ndim not in (2, 3):
            raise ValueError("hopper backend supports 2D and 3D stencils")
        template = backend.template
        R =tuple(int(s) for s in interior_shape)
        if min(R) < 1:
            raise ValueError(f"empty interior {R}")
        in_grids, out_grids = info.input_grids, info.output_grids
        opnd_grids = tuple(g for g in kernel.grid_params
                           if g in set(in_grids) | set(out_grids))
        gh = {g: info.halo_per_grid.get(g, (0,) * ndim) for g in opnd_grids}
        for g in out_grids:
            if any(gh[g]):
                raise ValueError(
                    f"fused time stepping requires center-only taps of the "
                    f"output grid '{g}' (its padded buffer is written "
                    "in-place while neighbors still read it)")
        hw = dict(gh)
        if swap is not None:
            a, b = swap
            if a not in opnd_grids or b not in opnd_grids:
                raise ValueError(f"swap grids {swap} must appear in kernel")
            m = tuple(max(gh[a][ax], gh[b][ax]) for ax in range(ndim))
            hw[a] = hw[b] = m
        for g in opnd_grids:
            for ax in range(ndim):
                if halos[g][ax] < hw[g][ax]:
                    raise ValueError(
                        f"grid '{g}' halo {halos[g][ax]} too small for "
                        f"layout halo {hw[g][ax]} on axis {ax}")
        B = choose_block(backend.block, template, ndim)
        B3 = to3(B, 1)
        if min(B3) < 1 or B3[1] * B3[2] > 1024:
            raise ValueError(f"block {B}: a thread block covers b1·b2 points "
                             "(1 to 1024)")
        streaming = template in STREAM_TEMPLATES
        R3 = to3(R, 1)
        if not streaming and R3[0] > 65535:
            raise ValueError("fused-step kernel: axis 0 extent must be <= 65535")
        gh3 = {g: to3(gh[g], 0) for g in opnd_grids}
        if streaming:
            smem = 4 * sum((2 * h[0] + 1) * (B3[1] + 2 * h[1]) * (B3[2] + 2 * h[2])
                           for h in gh3.values() if any(h))
            if smem > SMEM_LIMIT:
                raise ValueError(f"streaming tile needs {smem} B of shared "
                                 f"memory (> {SMEM_LIMIT}); reduce block")

        self.kernel, self.info, self.backend = kernel, info, backend
        self.template, self.streaming = template, streaming
        self.ndim, self.R, self.B = ndim, R, B
        self.R3, self.B3 = R3, B3
        self.halos = {g: tuple(halos[g]) for g in opnd_grids}
        self.gh, self.hw, self.swap = gh, hw, swap
        self.gh3 = gh3
        self.hw3 = {g: to3(hw[g], 0) for g in opnd_grids}
        self.in_grids, self.out_grids = in_grids, out_grids
        self.opnd_grids = opnd_grids
        self.scal_names = [n for n, _ in kernel.scalar_params]
        self.padded_shapes = {g: tuple(R[ax] + 2 * hw[g][ax]
                                       for ax in range(ndim))
                              for g in opnd_grids}
        self.touched = tuple(g for g in opnd_grids
                             if g in set(out_grids) | set(swap or ()))
        self._source: Optional[str] = None

    # -- traffic model -----------------------------------------------------
    def hbm_bytes_per_step(self, itemsize: int = 4) -> float:
        """Modeled bytes one step moves.  K1: each operand grid read once
        over the reach of its taps (``R + 2·gh``) and each output written
        once — the compulsory traffic, with tap re-reads served by L1/L2
        (a grid that is only written is not read).
        K2: the loads the blocks issue — per tile and chunk the halo'd
        window of each ringed grid, clipped to the tap reach — plus the
        point-read grids and the writes (an upper bound on device-memory
        traffic, since L2 serves the overlaps)."""
        R3, B3 = self.R3, self.B3
        read = 0
        for g in self.in_grids:
            h = self.gh3[g]
            if self.streaming and any(h):
                read += math.prod(R3[ax] + 2 * h[ax] * -(-R3[ax] // B3[ax])
                                  for ax in range(3))
            else:
                read += math.prod(R3[ax] + 2 * h[ax] for ax in range(3))
        write = len(self.out_grids) * math.prod(R3)
        return float((read + write) * itemsize)

    def count_window(self, steps: int) -> None:
        """Accumulate the modeled reads/writes of a window of ``steps``
        single-step launches into ``TRAFFIC_COUNT``."""
        TRAFFIC_COUNT["grid_reads"] += int(steps) * len(self.opnd_grids)
        TRAFFIC_COUNT["grid_writes"] += int(steps) * len(self.out_grids)
        TRAFFIC_COUNT["steps"] += int(steps)

    # -- layout stage ------------------------------------------------------
    def to_padded(self, arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each operand grid cut to its layout halo and made contiguous (a
        view of the grid itself when its halo is the layout halo)."""
        padded = {}
        for g in self.opnd_grids:
            ha, w = self.halos[g], self.hw[g]
            sl = tuple(slice(ha[ax] - w[ax], ha[ax] + self.R[ax] + w[ax])
                       for ax in range(self.ndim))
            padded[g] = arrays[g][sl].contiguous()
            PAD_COUNT[g] += 1
            PAD_COUNT["total"] += 1
        return padded

    def buf3(self, t: torch.Tensor) -> torch.Tensor:
        """A layout buffer in the kernels' 3D form (a view)."""
        return t if self.ndim == 3 else t.unsqueeze(1)

    def interior3(self, g: str, t: torch.Tensor, x=None) -> torch.Tensor:
        """View of grid ``g``'s interior in its 3D layout buffer (plane
        ``x`` only, when given)."""
        w, R = self.hw3[g], self.R3
        b = self.buf3(t)
        lead = slice(w[0], w[0] + R[0]) if x is None else w[0] + x
        return b[lead, w[1]:w[1] + R[1], w[2]:w[2] + R[2]]

    # -- kernel stage ------------------------------------------------------
    def source(self) -> str:
        """Full CUDA source of this plan's kernel: the generated header and
        the hand-written template it includes."""
        if self._source is None:
            tmpl = "stream_step.cuh" if self.streaming else "fused_step.cuh"
            self._source = (emit.header(self.kernel, self.opnd_grids,
                                        self.out_grids, self.gh3, self.B3)
                            + f'#include "{tmpl}"\n')
        return self._source

    def launch_args(self, padded: Dict[str, torch.Tensor], scalars):
        """(meta, scal) ctypes arrays for the C entry (layout in
        ``csrc/common.cuh``), after checking the buffers."""
        ptrs, sx, sy, org = [], [], [], []
        device = padded[self.opnd_grids[0]].device
        for g in self.opnd_grids:
            t = padded[g]
            if t.device != device:
                raise ValueError(f"grid '{g}' is on {t.device}, not {device}")
            if t.dtype != torch.float32:
                raise TypeError(f"grid '{g}': the CUDA kernels take float32, "
                                f"got {t.dtype}")
            if tuple(t.shape) != self.padded_shapes[g] or not t.is_contiguous():
                raise ValueError(f"grid '{g}': expected a contiguous layout "
                                 f"buffer of shape {self.padded_shapes[g]}")
            b = self.buf3(t)
            w = self.hw3[g]
            ptrs.append(t.data_ptr())
            sx.append(b.stride(0))
            sy.append(b.stride(1))
            org.append(w[0] * b.stride(0) + w[1] * b.stride(1) + w[2])
        meta = (ctypes.c_longlong * (4 * len(ptrs) + 3))(
            *ptrs, *sx, *sy, *org, *self.R3)
        vals = [float(scalars[n]) for n in self.scal_names] or [0.0]
        scal = (ctypes.c_float * len(vals))(*vals)
        return meta, scal

    def step(self, padded: Dict[str, torch.Tensor],
             scalars: Dict[str, float]) -> Dict[str, torch.Tensor]:
        """One time step on the layout buffers, outputs in place: K2 for
        the streaming templates, else K1.  Returns ``padded``."""
        from .fused_step import fused_step
        from .stream_step import stream_step
        (stream_step if self.streaming else fused_step)(self, padded, scalars)
        return padded

    # -- boundary stage ----------------------------------------------------
    def from_padded(self, padded: Dict[str, torch.Tensor],
                    arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Write the touched grids' layout interiors back into the full
        (grid-halo'd) arrays, in place; a layout buffer that is a view of
        its grid needs no copy."""
        for g in self.touched:
            ha, w, R = self.halos[g], self.hw[g], self.R
            dst = arrays[g][tuple(slice(ha[ax], ha[ax] + R[ax])
                                  for ax in range(self.ndim))]
            src = padded[g][tuple(slice(w[ax], w[ax] + R[ax])
                                  for ax in range(self.ndim))]
            if dst.data_ptr() == src.data_ptr() and dst.stride() == src.stride():
                continue
            dst.copy_(src)
        return dict(arrays)


def plan_cuda(kernel: ir.StencilIR,
              halos: Dict[str, Tuple[int, ...]],
              interior_shape: Tuple[int, ...],
              backend,
              swap: Optional[Tuple[str, str]] = None) -> CudaPlan:
    """Build the split (layout / per-step kernel) lowering used by the
    fused time-loop engine (``repro_torch.core.timeloop``)."""
    return CudaPlan(kernel, halos, interior_shape, backend, swap=swap)
