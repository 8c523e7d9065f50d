"""StencilIR → hand-written Hopper CUDA kernels: the fused time-loop plan.

``CudaPlan`` is the counterpart of the JAX package's ``PallasPlan``: it
splits a fused time loop into

  ``to_padded``   — one-time layout stage per fusion window: each operand
                    grid cut to its layout halo ``hw`` and made contiguous
                    (one conversion per grid, counted in ``PAD_COUNT``;
                    a grid whose halo already equals ``hw`` is used as it
                    is, so its buffer is then advanced in place);
  ``step``        — one kernel launch on the layout buffers.  With
                    ``time_block=1`` it advances one step in place: K1
                    (``fused_step``, templates gmem/smem/f4), K2
                    (``stream_step``, shift/unroll) or K5 (``semi_step``,
                    semi); writing in place is legal because output grids
                    must have center-only taps.  With ``time_block=k>1``
                    it runs K3 (``temporal_step``, every template): k
                    leapfrog sub-steps in one launch, both swap buffers
                    written to *spare* buffers (``make_spares``), never to
                    the buffers it reads, since its blocks read k·h cells
                    into their neighbours' tiles while those run;
  ``from_padded`` — write the touched grids' layout interiors back.

Grids named in ``swap`` share one layout halo, the larger of their tap
halos, so their buffers can trade names between steps.  There is no
whole-block ring as on the TPU: the kernels mask their own ragged edge, so
``hbm_bytes_per_step`` counts what they actually move.  2D stencils run as
3D ones of shape ``(R0, 1, R1)`` (tap ``(a, b)`` → ``(a, 0, b)``).

The kernels' structure is hand-written (``csrc/*.cuh``); only the per-point
expression (K5: the per-offset scatter) is generated (``emit.py``) and
compiled at first use (``_build.py``).  The layout halo stays ``hw`` under
temporal blocking: K3 clamps its loads to the tap reach ``[-h, R + h)``.
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
STREAM_TEMPLATES = ("shift", "unroll", "semi")
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


def choose_block(user_block, template: str, ndim: int,
                 time_block: int = 1) -> Tuple[int, ...]:
    """The tile in points (the port's own defaults, see ``DEFAULT_BLOCK``;
    K3 walks chunks of planes like the streaming kernels)."""
    if user_block is not None:
        if len(user_block) != ndim:
            raise ValueError(f"block must have {ndim} dims")
        return tuple(int(b) for b in user_block)
    kind = ("stream" if template in STREAM_TEMPLATES or time_block > 1
            else "fused")
    return DEFAULT_BLOCK[kind][ndim]


def semi_linearize(kernel: ir.StencilIR):
    """The semi template's form of ``kernel``: output grid → ([(grid,
    offsets, coefficient)], constant), and the streaming halo ``H``, the
    largest axis-0 offset of a term.  Coefficients and the constant may
    read center-only taps (coefficient fields such as acoustic's ``vp2``);
    every off-center tap is a term.  Raises ``analysis.NotLinearError`` for
    a kernel that is not linear in its taps and ``ValueError`` for one that
    reads a grid an earlier statement wrote (the JAX package's
    ``_semi_linearize``)."""
    lin = {}
    written = set()
    for a in analysis.inline_locals(kernel):
        terms, const = analysis.linearize(a.expr, allow_center_fields=True)
        for t in ir.StencilIR(kernel.name, kernel.ndim, kernel.grid_params,
                              kernel.scalar_params, (a,)).taps():
            if t.grid in written:
                raise ValueError("semi template does not support reading "
                                 "a previously-written grid")
        written.add(a.grid)
        lin[a.grid] = ([(g, offs, c) for (g, offs), c in terms.items()],
                       const)
    H = max((abs(offs[0]) for terms, _ in lin.values()
             for _, offs, _ in terms), default=0)
    return lin, H


def _cover(R: int, B: int, e: int, c: int, clip_tile: bool) -> int:
    """Cells one axis of a tiled load touches, summed over the tiles: tile
    ``[s, s + B)`` (cut at ``R`` when ``clip_tile``) widened by ``e`` per
    side and clipped to ``[-c, R + c)``."""
    total = 0
    for s in range(0, R, B):
        end = min(s + B, R) if clip_tile else s + B
        total += max(0, min(end + e, R + c) - max(s - e, -c))
    return total


def _window_cells(R3, B3, e3, c3) -> int:
    """Cells a tiled kernel loads for one grid: per tile (axes 1, 2) and
    chunk (axis 0, cut at ``R0``) the window widened by ``e3`` and clipped
    to ``[-c3, R + c3)``, summed over tiles and chunks."""
    return math.prod(_cover(R3[ax], B3[ax], e3[ax], c3[ax], ax == 0)
                     for ax in range(3))


KERNEL_FILES = {"fused": "fused_step.cuh", "stream": "stream_step.cuh",
                "semi": "semi_step.cuh", "temporal": "temporal_step.cuh"}


class CudaPlan:
    """Layout and per-step kernel stage of the hopper backend for one
    (kernel, halos, interior, backend, swap); see the module docstring.
    ``kind`` names the kernel ``step`` launches: ``"fused"`` (K1),
    ``"stream"`` (K2), ``"semi"`` (K5) or ``"temporal"`` (K3)."""

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
        R = tuple(int(s) for s in interior_shape)
        if min(R) < 1:
            raise ValueError(f"empty interior {R}")
        k = int(backend.time_block)       # >= 1, checked by st.hopper
        in_grids, out_grids = info.input_grids, info.output_grids
        if k > 1:
            if swap is None:
                raise ValueError(
                    "time_block > 1 requires a swap pair: the in-kernel "
                    "sub-steps are the leapfrog write+rotate sequence")
            if len(out_grids) != 1 or out_grids[0] != swap[0]:
                raise ValueError(
                    "time_block > 1 supports single-output kernels writing "
                    f"swap[0] (outputs: {out_grids}, swap: {swap})")
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
        B = choose_block(backend.block, template, ndim, k)
        B3 = to3(B, 1)
        if min(B3) < 1 or B3[1] * B3[2] > 1024:
            raise ValueError(f"block {B}: a thread block covers b1·b2 points "
                             "(1 to 1024)")
        # the semi template needs a kernel linear in its taps, also when
        # K3 runs the steps (as in the JAX package)
        lin, H = semi_linearize(kernel) if template == "semi" else (None, 0)
        if k > 1:
            kind = "temporal"
        elif template == "semi":
            kind = "semi"
        else:
            kind = "stream" if template in STREAM_TEMPLATES else "fused"
        R3 = to3(R, 1)
        if kind == "fused" and R3[0] > 65535:
            raise ValueError("fused-step kernel: axis 0 extent must be <= 65535")
        gh3 = {g: to3(gh[g], 0) for g in opnd_grids}
        ring = [h for h in gh3.values() if any(h)]
        if kind == "stream":
            smem = 4 * sum((2 * h[0] + 1) * (B3[1] + 2 * h[1]) * (B3[2] + 2 * h[2])
                           for h in ring)
        elif kind == "semi":           # one double-buffered plane per grid
            smem = 8 * sum((B3[1] + 2 * h[1]) * (B3[2] + 2 * h[2]) for h in ring)
        elif kind == "temporal":       # k rings of 2h+1 widened planes
            h = gh3[swap[1]]
            smem = 4 * (2 * h[0] + 1) * sum(
                (B3[1] + 2 * (k - 1 - r) * h[1]) * (B3[2] + 2 * (k - 1 - r) * h[2])
                for r in range(-1, k - 1))
        else:
            smem = 0
        if smem > SMEM_LIMIT:
            what = (f"time_block={k}: the {k} plane rings of block {B} need"
                    if kind == "temporal" else f"{kind} tile of block {B} needs")
            raise ValueError(f"{what} {smem} B of shared memory "
                             f"(> {SMEM_LIMIT}); reduce block or time_block")

        self.kernel, self.info, self.backend = kernel, info, backend
        self.template, self.kind, self.time_block = template, kind, k
        self.ndim, self.R, self.B = ndim, R, B
        self.R3, self.B3 = R3, B3
        self.halos = {g: tuple(halos[g]) for g in opnd_grids}
        self.gh, self.hw, self.swap = gh, hw, swap
        self.gh3 = gh3
        self.hw3 = {g: to3(hw[g], 0) for g in opnd_grids}
        self.in_grids, self.out_grids = in_grids, out_grids
        self.opnd_grids = opnd_grids
        # the buffers one launch writes: with k > 1 both swap buffers
        self.step_out_grids = tuple(swap) if k > 1 else tuple(out_grids)
        self.lin, self.H = lin, H
        self.smem_bytes = smem
        self.scal_names = [n for n, _ in kernel.scalar_params]
        self.padded_shapes = {g: tuple(R[ax] + 2 * hw[g][ax]
                                       for ax in range(ndim))
                              for g in opnd_grids}
        self.touched = tuple(g for g in opnd_grids
                             if g in set(out_grids) | set(swap or ()))
        self._source: Optional[str] = None

    # -- traffic model -----------------------------------------------------
    def hbm_bytes_per_step(self, itemsize: int = 4) -> float:
        """Modeled bytes one step moves: the loads the blocks make plus the
        writes, an upper bound on device-memory traffic where L1/L2 serve
        re-reads (tile halos of neighbouring blocks, chunk overlaps).  The
        compulsory traffic, each input read and each written buffer written
        once per launch, is the smaller figure ``chip_smoke.py`` bounds with.

        K1: each operand grid read once over the reach of its taps
        (``R + 2·gh``) and each output written once (a grid that is only
        written is not read).  K2: per tile and chunk the halo'd window of
        each ringed grid, clipped to the tap reach, plus the point-read
        grids.  K5: per tile and chunk each term grid's planes
        ``[x0 - H, x1 + H)`` with its y/z halo, clipped to its reach, plus
        one read per point of each grid its coefficients read.  K3, per
        launch of ``k`` steps divided by ``k``: the read grid's window
        widened by ``k·h`` (clipped to the reach ``[-h, R + h)``), the halo
        cells each sub-step's ring takes from the buffer it stands for, one
        read per computed point and sub-step of every grid read at the
        point, and one write of each swap buffer.  The spares K3 writes are
        written, not fetched: no destination read (the TPU kernel DMAs its
        destination blocks in)."""
        R3, B3, k = self.R3, self.B3, self.time_block
        n = math.prod(R3)
        zero = (0, 0, 0)
        read = 0
        if self.kind == "temporal":
            written, other = self.swap
            h = self.gh3[other]
            kh = tuple(k * x for x in h)
            read += _window_cells(R3, B3, kh, h)
            for j in range(k):
                e = tuple((k - 1 - j) * x for x in h)
                inner = _window_cells(R3, B3, e, zero)
                if j < k - 1:        # halo cells of sub-step j's ring
                    read += _window_cells(R3, B3, e, h) - inner
                point = [g for g in self.in_grids if g not in self.swap]
                if j == 0 and written in self.in_grids:
                    point.append(written)
                read += len(point) * inner
            write = len(self.step_out_grids) * n
            return float((read + write) * itemsize) / k
        if self.kind == "semi":
            # center taps are what the coefficients and constants read
            fields = {t.grid for t in self.kernel.taps() if not any(t.offsets)}
            for g in self.in_grids:
                h = self.gh3[g]
                if any(h):
                    read += _window_cells(R3, B3, (self.H,) + h[1:], h)
                if g in fields:
                    read += n
        else:
            for g in self.in_grids:
                h = self.gh3[g]
                if self.kind == "stream" and any(h):
                    read += _window_cells(R3, B3, h, h)
                else:
                    read += math.prod(R3[ax] + 2 * h[ax] for ax in range(3))
        write = len(self.out_grids) * n
        return float((read + write) * itemsize)

    def count_window(self, steps: int) -> None:
        """Accumulate the modeled grid reads/writes of a fusion window of
        ``steps`` into ``TRAFFIC_COUNT``: ``steps // k`` K3 launches (each
        reads every operand grid once and writes both swap buffers) plus
        the remainder as single steps, as the engine runs it."""
        m, r = divmod(int(steps), self.time_block)
        TRAFFIC_COUNT["grid_reads"] += (m + r) * len(self.opnd_grids)
        TRAFFIC_COUNT["grid_writes"] += (m * len(self.step_out_grids)
                                         + r * len(self.out_grids))
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

    def make_spares(self, padded: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The destination buffers of the first K3 launch of a window, one
        per ``step_out_grids`` entry: a copy of that grid's layout buffer,
        so its halo is the grid's own (K3 writes interiors only)."""
        return {g: padded[g].clone() for g in self.step_out_grids}

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
            src = emit.header(self.kernel, self.opnd_grids, self.out_grids,
                              self.gh3, self.B3)
            if self.kind == "semi":
                src += emit.semi_functions(self.kernel, self.opnd_grids,
                                           self.out_grids, self.lin, self.H)
            elif self.kind == "temporal":
                src += (f"#define RT_K {self.time_block}\n"
                        f"#define RT_GW {self.opnd_grids.index(self.swap[0])}\n"
                        f"#define RT_GO {self.opnd_grids.index(self.swap[1])}\n")
            self._source = src + f'#include "{KERNEL_FILES[self.kind]}"\n'
        return self._source

    def launch_args(self, padded: Dict[str, torch.Tensor], scalars,
                    spares: Optional[Dict[str, torch.Tensor]] = None):
        """(meta, scal) ctypes arrays for the C entry (layout in
        ``csrc/common.cuh``; K3 appends its destination pointers), after
        checking the buffers."""
        ptrs, sx, sy, org = [], [], [], []
        device = padded[self.opnd_grids[0]].device

        def check(g, t):
            if t.device != device:
                raise ValueError(f"grid '{g}' is on {t.device}, not {device}")
            if t.dtype != torch.float32:
                raise TypeError(f"grid '{g}': the CUDA kernels take float32, "
                                f"got {t.dtype}")
            if tuple(t.shape) != self.padded_shapes[g] or not t.is_contiguous():
                raise ValueError(f"grid '{g}': expected a contiguous layout "
                                 f"buffer of shape {self.padded_shapes[g]}")

        for g in self.opnd_grids:
            t = padded[g]
            check(g, t)
            b = self.buf3(t)
            w = self.hw3[g]
            ptrs.append(t.data_ptr())
            sx.append(b.stride(0))
            sy.append(b.stride(1))
            org.append(w[0] * b.stride(0) + w[1] * b.stride(1) + w[2])
        dst = []
        for g in (self.step_out_grids if spares is not None else ()):
            check(g, spares[g])
            if any(spares[g].data_ptr() == t.data_ptr() for t in padded.values()):
                raise ValueError(f"spare of '{g}' aliases a buffer the "
                                 "kernel reads")
            dst.append(spares[g].data_ptr())
        meta = (ctypes.c_longlong * (4 * len(ptrs) + 3 + len(dst)))(
            *ptrs, *sx, *sy, *org, *self.R3, *dst)
        vals = [float(scalars[n]) for n in self.scal_names] or [0.0]
        scal = (ctypes.c_float * len(vals))(*vals)
        return meta, scal

    def step(self, padded: Dict[str, torch.Tensor],
             scalars: Dict[str, float],
             spares: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        """One launch on the layout buffers.  ``time_block=1``: one step,
        outputs in place (K1, K2 or K5 by template); returns ``padded``.
        ``time_block=k>1``: K3 advances ``k`` steps and writes both swap
        buffers into ``spares`` (``make_spares``; required), leaving the
        buffers it reads intact; returns ``padded`` with the swap names
        bound to the spares.  Buffer↔name bindings are otherwise untouched:
        the caller applies the leapfrog rotation parity (``k`` rotations)
        to the names, and the buffers just read become the next launch's
        spares."""
        from .fused_step import fused_step
        from .semi_step import semi_step
        from .stream_step import stream_step
        from .temporal_step import temporal_step
        if self.kind == "temporal":
            if spares is None:
                raise ValueError(
                    "time_block > 1 kernel stage is double-buffered: pass "
                    "spares= destination buffers (plan.make_spares)")
            temporal_step(self, padded, spares, scalars)
            return {**padded, **{g: spares[g] for g in self.step_out_grids}}
        {"fused": fused_step, "stream": stream_step,
         "semi": semi_step}[self.kind](self, padded, scalars)
        return padded

    # -- boundary stage ----------------------------------------------------
    def from_padded(self, padded: Dict[str, torch.Tensor],
                    arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Write the touched grids' layout interiors back into the full
        (grid-halo'd) arrays, in place; a layout buffer that is a view of
        its grid needs no copy (after K3 the final buffer may be a spare,
        which is copied)."""
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
