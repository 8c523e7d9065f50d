"""K2 — the 2.5D streaming kernel (templates shift/unroll) and its plain
version.

Replaces the JAX package's ``kernels/stencil/codegen.py``
``_make_body_fused`` streaming branch → ``_stream_outputs`` (shift/unroll
rolling window of ``2h+1`` planes along axis 0).  CUDA source:
``csrc/stream_step.cuh`` with the ring geometry of ``csrc/stream_ring.cuh``:
a block covers an 8 x 64 tile of the two fast axes (each thread two
columns along axis 1) and walks a chunk of ``b0`` planes.  Each grid with
an off-center tap keeps a ring of ``N = 2H + 1 + P`` halo'd planes in
shared memory (H the largest axis-0 halo, P = ``STREAM_PREFETCH`` planes
copied ahead by the TMA or by 4-byte ``cp.async`` granules,
``CudaPlan.stream_tma``); each thread keeps the grid's axis-0 taps at its
column's centre in a register queue of ``2h0 + 1`` cells and reads the
ring only for taps that leave the column.  Center-only grids are read
two planes ahead of the point.  Bound: device memory bytes.

The plain version walks the same chunks, ring slots and queues, with one
tile spanning the whole plane: local plane ``i`` of a chunk (plane ``x0 -
H + i``) lives in slot ``i mod N``; the prologue stages planes ``0 .. 2H
+ P - 1``, plane ``t`` of the chunk stages plane ``t + 2H + P`` (none past
``x1 + H``, none outside the grid's tap reach); at plane ``t = base + r``
(``base`` a multiple of ``N``, the kernel's loop unrolled by ``N``) a tap
at ``dx`` that leaves the column reads slot ``(r + H + dx) mod N``, one on
the column the queue.  So the CPU tests exercise the kernel's slot,
prefetch and queue arithmetic.

It also runs K4's streaming templates (shift/unroll of ``st.map``, a
``MapPlan``: ``_make_body_streaming`` → ``_stream_outputs``, reached from
``lower_pallas``): the same source built with ``RT_MAP``, on the grids'
full tensors with the origin at the region's first point, outputs into
the plan's destinations.

Both versions read f32 or bf16 buffers (the rings hold the grids' own
type), compute in f32 and round once, when they store an output cell.

Under ``batch=B`` (the fused path) the buffers carry a leading scenario
axis: the kernel advances every scenario in one launch, the plain version
each scenario as its own step (``CudaPlan.scenarios``).

Writes: both versions write the output grids' interiors (``MapPlan``: the
region, in place or into ``dst``); nothing else is written.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.core import lowering
from repro_torch.core.dsl import scalar_tensors

from .. import _build
from .codegen import STREAM_PREFETCH
from .emit import offsets3

# center-only grids are read this many planes ahead of the point
AHEAD = 2


def stream_step_plain(plan, padded: Dict[str, torch.Tensor],
                      scalars: Dict[str, float],
                      dst: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """K2's plain PyTorch version (see the module docstring)."""
    if plan.batch_of(padded[plan.out_grids[0]]):
        for args in plan.scenarios(padded, scalars, dst):
            stream_step_plain(plan, *args)
        return
    R0, R1, R2 = plan.R3
    chunk = plan.B3[0]
    dtype, device = torch.float32, padded[plan.out_grids[0]].device
    scal = scalar_tensors(scalars, device)
    ring_grids = plan.ring_grids()
    center = [g for g in plan.opnd_grids
              if g not in ring_grids and g in plan.in_grids]
    bufs = {g: plan.buf3(padded[g]) for g in plan.opnd_grids}
    H = max((plan.gh3[g][0] for g in ring_grids), default=0)
    N = 2 * H + 1 + STREAM_PREFETCH

    for x0 in range(0, R0, chunk):
        x1 = min(x0 + chunk, R0)
        rings = {g: torch.zeros((N, R1 + 2 * plan.gh3[g][1],
                                 R2 + 2 * plan.gh3[g][2]),
                                dtype=bufs[g].dtype, device=device)
                 for g in ring_grids}

        def stage(i):
            # local plane i into slot i mod N: planes past the chunk's last
            # need (x1 + H) are not copied, nor planes outside a grid's tap
            # reach [-h0, R0 + h0) (no interior point reads them)
            xp = x0 - H + i
            if xp >= x1 + H:
                return
            for g in ring_grids:
                h, w = plan.gh3[g], plan.org3[g]
                if -h[0] <= xp < R0 + h[0]:
                    rings[g][i % N] = bufs[g][w[0] + xp, w[1] - h[1]:w[1] + R1 + h[1],
                                              w[2] - h[2]:w[2] + R2 + h[2]]

        def centre(g, slot):
            h = plan.gh3[g]
            return rings[g][slot, h[1]:h[1] + R1, h[2]:h[2] + R2].float()

        for i in range(2 * H + STREAM_PREFETCH):
            stage(i)
        # each ring grid's queue: its column's centre at planes x - h0 ..
        # x + h0, the leading one filled at plane x
        queues = {g: [None] + [centre(g, (H - plan.gh3[g][0] + s) % N)
                               for s in range(2 * plan.gh3[g][0])]
                  for g in ring_grids}
        ahead = [{g: plan.interior3(g, padded[g], x).float() for g in center}
                 for x in range(x0, min(x0 + AHEAD, x1))]
        for t in range(x1 - x0):
            x, r = x0 + t, t % N
            stage(t + 2 * H + STREAM_PREFETCH)
            if t + AHEAD < x1 - x0:
                ahead.append({g: plan.interior3(g, padded[g], x + AHEAD).float()
                              for g in center})
            for g in ring_grids:
                q = queues[g]
                q[:] = q[1:] + [centre(g, (r + H + plan.gh3[g][0]) % N)]

            def tap_read(g, offs, r=r):
                d = offsets3(offs)
                if g in center:
                    return ahead[0][g]
                h = plan.gh3[g]
                if d[1] == 0 and d[2] == 0:
                    return queues[g][h[0] + d[0]]
                return rings[g][(r + H + d[0]) % N, h[1] + d[1]:h[1] + d[1] + R1,
                                h[2] + d[2]:h[2] + d[2] + R2].float()

            env = lowering.exec_statements(plan.kernel, tap_read, scal,
                                           (R1, R2), dtype, device)
            for g in plan.out_grids:
                plan.out3(g, padded, dst, x).copy_(env[g])
            ahead.pop(0)


def stream_step(plan, padded: Dict[str, torch.Tensor],
                scalars: Dict[str, float],
                dst: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """One time step of ``plan`` on its layout buffers, or one application
    of a ``MapPlan`` on the grids' full tensors with outputs into ``dst``
    (None: in place).  CPU tensors run the plain version; CUDA tensors
    launch the kernel (counted in ``stream_step.launches``) on the current
    stream, or raise."""
    device = padded[plan.out_grids[0]].device
    if device.type == "cpu":
        stream_step_plain(plan, padded, scalars, dst)
        return
    if device.type != "cuda":
        raise ValueError(f"stream_step: unsupported device {device}")
    meta, scal = (plan.launch_args(padded, scalars) if dst is None
                  else plan.launch_args(padded, scalars, dst))
    fn = _build.load(plan.source(padded[plan.out_grids[0]].dtype),
                     "rt_stream_step")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(meta), ctypes.addressof(scal),
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"stream_step launch failed: cudaError {err}")
    stream_step.launches += 1


stream_step.launches = 0
