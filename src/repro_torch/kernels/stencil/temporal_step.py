"""K3 — the temporal-blocking kernel (``time_block=k > 1``, every template)
and its plain version.

Replaces the JAX package's ``kernels/stencil/codegen.py``
``_make_body_temporal`` (``PallasPlan._call_for`` with ``time_block > 1``,
destinations from ``PallasPlan.make_spares``).  CUDA source:
``csrc/temporal_step.cuh`` with the geometry of ``csrc/temporal_ring.cuh``:
``k`` pipelined 2.5D stages along axis 0, stage ``j`` computing sub-step
``j`` over the tile widened by ``(k-1-j)·h`` and lagging stage ``j-1`` by
``h0`` planes; both swap buffers are written to spares.  Ring -1 holds
``2h0 + 1 + P`` planes of the read swap buffer over the tile widened by
``k·h`` (P = ``TEMPORAL_PREFETCH`` planes copied ahead by the TMA or by
4-byte granules, ``CudaPlan.stream_tma``); ring ``j`` (0 .. k-2) holds
the ``h0 - dlo + 1`` planes of sub-step ``j`` that taps leaving the column
read (``CudaPlan.temporal_dlo``).  Each thread owns fixed cells of sub-step
0's tile; at each of them queue ``j`` (-1 .. k-2) holds sub-step ``j`` at
planes ``tick - (j+2)·h0 .. tick - j·h0`` (queue -1: the read buffer, from
ring -1's newest plane), from which sub-step ``j+1`` takes its axis-0 taps
on the column and sub-step ``j+2`` its centre value.  Bound:
device-memory bytes (per launch each input grid read once and both swap
buffers written once, for ``k`` steps).

The plain version walks the same chunks, ticks, stages, ring slots (ring
-1: local plane ``i`` = plane ``x0 - k·h0 + i`` in slot ``i mod N``, the
prologue staging ``i < 2h0 + P``, tick ``x0 - (k-1)·h0 + l`` staging ``l +
2h0 + P``; ring ``j``: plane ``p`` in slot ``(p - x0 + k·h0) mod (h0 - dlo +
1)``), queues and widened extents, with one tile spanning the whole plane,
and takes every cell outside the interior as the kernel does: the halo of
the buffer the sub-step stands for within the tap reach ``[-h, R + h)``, 0
beyond it.  The CPU tests thus exercise the kernel's stage, slot, queue
and halo arithmetic; ``tests/test_torch_stream_paths.py`` compiles the
cells a thread owns with ``g++``.

Both versions read f32 or bf16 buffers and compute in f32; the rings of
sub-step values and the queues hold f32, so a sub-step's values reach the
next one unrounded, and only the stores into the spares round.

Under ``batch=B`` the buffers and spares carry a leading scenario axis:
the kernel advances every scenario in one launch (the ring -1 TMA map has
a scenario dimension), the plain version each scenario as its own launch
(``CudaPlan.scenarios``).

Writes: both versions write the interiors of the two spares only; the
layout buffers they read are left as they were.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core import lowering
from repro_torch.core.dsl import scalar_tensors

from .. import _build
from .codegen import TEMPORAL_PREFETCH
from .emit import offsets3


def temporal_step_plain(plan, padded: Dict[str, torch.Tensor],
                        spares: Dict[str, torch.Tensor],
                        scalars: Dict[str, float]) -> None:
    """K3's plain PyTorch version (see the module docstring)."""
    if plan.batch_of(padded[plan.swap[1]]):
        for p_b, scal_b, sp_b in plan.scenarios(padded, scalars, spares):
            temporal_step_plain(plan, p_b, sp_b, scal_b)
        return
    R0, R1, R2 = plan.R3
    k, chunk = plan.time_block, plan.B3[0]
    written, other = plan.swap
    h0, h1, h2 = plan.gh3[other]
    n_in = 2 * h0 + 1 + TEMPORAL_PREFETCH
    n_r = h0 - plan.temporal_dlo() + 1
    L = 2 * h0 + 1
    role = (written, other)            # sub-step j stands for role[j % 2]
    dtype, device = torch.float32, padded[other].device
    scal = scalar_tensors(scalars, device)
    bufs = {g: plan.buf3(padded[g]) for g in plan.opnd_grids}

    def frame(g, x, e):
        """Plane ``x`` of buffer ``g`` over ``[-e, R + e)`` in y/z: the
        buffer within the tap reach, 0 beyond it."""
        out = torch.zeros((R1 + 2 * e * h1, R2 + 2 * e * h2), dtype=dtype,
                          device=device)
        if -h0 <= x < R0 + h0:
            c1, c2 = min(e, 1) * h1, min(e, 1) * h2
            w = plan.hw3[g]
            out[e * h1 - c1:e * h1 + R1 + c1, e * h2 - c2:e * h2 + R2 + c2] = \
                bufs[g][w[0] + x, w[1] - c1:w[1] + R1 + c1,
                        w[2] - c2:w[2] + R2 + c2]
        return out

    def inner(t, e):
        """The interior part of a plane widened by ``e·h``."""
        return t[e * h1:e * h1 + R1, e * h2:e * h2 + R2]

    for x0 in range(0, R0, chunk):
        x1 = min(x0 + chunk, R0)
        first = x0 - k * h0                  # ring -1's local plane 0
        ring_in = torch.zeros((n_in, R1 + 2 * k * h1, R2 + 2 * k * h2),
                              dtype=dtype, device=device)
        # ring j (0 .. k-2): planes of sub-step j, widened by (k-1-j)·h
        rings = {j: torch.zeros((n_r, R1 + 2 * (k - 1 - j) * h1,
                                 R2 + 2 * (k - 1 - j) * h2),
                                dtype=dtype, device=device)
                 for j in range(k - 1)}
        # queue j (-1 .. k-2) over sub-step 0's tile (each cell a thread's)
        zero0 = torch.zeros((R1 + 2 * (k - 1) * h1, R2 + 2 * (k - 1) * h2),
                            dtype=dtype, device=device)
        queues = {j: [zero0] * L for j in range(-1, k - 1)}

        def ring_in_cells(i):
            """Sub-step 0's tile of ring -1's plane in slot ``i``."""
            return ring_in[i][h1:h1 + zero0.shape[0], h2:h2 + zero0.shape[1]]

        def stage_in(i):
            # planes past the last tick's need (x1 + k·h0) and outside the
            # tap reach [-h0, R0 + h0) are not copied
            x = first + i
            if x < x1 + k * h0 and -h0 <= x < R0 + h0:
                ring_in[i % n_in] = frame(other, x, k)

        def in_slot(x):
            return (x - first) % n_in

        def slot(x):
            return (x - first) % n_r

        for i in range(2 * h0 + TEMPORAL_PREFETCH):
            stage_in(i)
        queues[-1] = [zero0] + [ring_in_cells(i).clone() for i in range(2 * h0)]
        for lt, tick in enumerate(range(x0 - (k - 1) * h0, x1 + (k - 1) * h0)):
            # queue -1 takes plane tick + h0, then the next plane is staged
            queues[-1] = queues[-1][1:] + [ring_in_cells(in_slot(tick + h0)).clone()]
            stage_in(lt + 2 * h0 + TEMPORAL_PREFETCH)
            for j in range(k):
                x, e = tick - j * h0, k - 1 - j
                v = None
                if x0 - e * h0 <= x < x1 + e * h0:
                    v = frame(role[j % 2], x, e)
                    if 0 <= x < R0:
                        def tap_read(g, offs, j=j, x=x):
                            d = offsets3(offs)
                            if g == other and j == 0:      # F_{-1}
                                if d[1] == 0 and d[2] == 0:
                                    return inner(queues[-1][h0 + d[0]], k - 1)
                                r = ring_in[in_slot(x + d[0])]
                                a, b = k * h1 + d[1], k * h2 + d[2]
                                return r[a:a + R1, b:b + R2]
                            if g == other:                 # sub-step j-1
                                if d[1] == 0 and d[2] == 0:
                                    return inner(queues[j - 1][h0 + d[0]], k - 1)
                                r = rings[j - 1][slot(x + d[0])]
                                a, b = (k - j) * h1 + d[1], (k - j) * h2 + d[2]
                                return r[a:a + R1, b:b + R2]
                            if g == written:               # sub-step j-2
                                if j == 0:
                                    return plan.interior3(g, padded[g], x).float()
                                return inner(queues[j - 2][0], k - 1)
                            w = plan.hw3[g]
                            return bufs[g][w[0] + x + d[0],
                                           w[1] + d[1]:w[1] + d[1] + R1,
                                           w[2] + d[2]:w[2] + d[2] + R2].float()

                        val = lowering.exec_statements(
                            plan.kernel, tap_read, scal, (R1, R2), dtype,
                            device)[written]
                        inner(v, e).copy_(val)
                        if j >= k - 2 and x0 <= x < x1:
                            g = role[j % 2]
                            plan.interior3(g, spares[g], x).copy_(val)
                if j < k - 1:
                    if v is not None:
                        rings[j][slot(x)] = v
                    # the queue takes this tick's plane of sub-step j (0
                    # where the stage computes nothing: no stage reads it)
                    q0 = zero0.clone()
                    if v is not None:
                        q0[j * h1:j * h1 + v.shape[0], j * h2:j * h2 + v.shape[1]] = v
                    queues[j] = queues[j][1:] + [q0]


def temporal_step(plan, padded: Dict[str, torch.Tensor],
                  spares: Dict[str, torch.Tensor],
                  scalars: Dict[str, float]) -> None:
    """``plan.time_block`` steps of ``plan``: reads the layout buffers and
    writes both swap grids' new interiors into ``spares``.  CPU tensors run
    the plain version; CUDA tensors launch the kernel (counted in
    ``temporal_step.launches``) on the current stream, or raise."""
    device = padded[plan.out_grids[0]].device
    if device.type == "cpu":
        temporal_step_plain(plan, padded, spares, scalars)
        return
    if device.type != "cuda":
        raise ValueError(f"temporal_step: unsupported device {device}")
    meta, scal = plan.launch_args(padded, scalars, spares)
    fn = _build.load(plan.source(padded[plan.out_grids[0]].dtype),
                     "rt_temporal_step")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(meta), ctypes.addressof(scal),
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"temporal_step launch failed: cudaError {err}")
    temporal_step.launches += 1


temporal_step.launches = 0
