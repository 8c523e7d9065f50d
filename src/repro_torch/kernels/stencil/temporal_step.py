"""K3 — the temporal-blocking kernel (``time_block=k > 1``, every template)
and its plain version.

Replaces the JAX package's ``kernels/stencil/codegen.py``
``_make_body_temporal`` (``PallasPlan._call_for`` with ``time_block > 1``,
destinations from ``PallasPlan.make_spares``).  CUDA source:
``csrc/temporal_step.cuh``: ``k`` pipelined 2.5D stages along axis 0, stage
``j`` computing sub-step ``j`` over the tile widened by ``(k-1-j)·h`` from a
ring of ``2h0+1`` planes of sub-step ``j-1`` in shared memory and lagging
stage ``j-1`` by ``h0`` planes; both swap buffers are written to spares.
Bound: device-memory bytes (per launch each input grid read once and both
swap buffers written once, for ``k`` steps).

The plain version walks the same chunks, ticks, stages, ring slots (plane
``p`` in slot ``(p - x0 + k·h0) mod (2h0+1)``) and widened extents, with one
tile spanning the whole plane, and takes every cell outside the interior
as the kernel does: the halo of the buffer the sub-step stands for within
the tap reach ``[-h, R + h)``, 0 beyond it.  The CPU tests thus exercise
the kernel's stage, slot and halo arithmetic.

Both versions read f32 or bf16 buffers and compute in f32; the rings
hold f32, so a sub-step's values reach the next one unrounded, and only
the stores into the spares round.

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
from .emit import offsets3


def temporal_step_plain(plan, padded: Dict[str, torch.Tensor],
                        spares: Dict[str, torch.Tensor],
                        scalars: Dict[str, float]) -> None:
    """K3's plain PyTorch version (see the module docstring)."""
    R0, R1, R2 = plan.R3
    k, chunk = plan.time_block, plan.B3[0]
    written, other = plan.swap
    h0, h1, h2 = plan.gh3[other]
    nr = 2 * h0 + 1
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

    for x0 in range(0, R0, chunk):
        x1 = min(x0 + chunk, R0)
        # ring r (-1 .. k-2): planes of sub-step r, widened by (k-1-r)·h
        rings = {r: torch.zeros((nr, R1 + 2 * (k - 1 - r) * h1,
                                 R2 + 2 * (k - 1 - r) * h2),
                                dtype=dtype, device=device)
                 for r in range(-1, k - 1)}

        def slot(x, x0=x0):
            return (x - x0 + k * h0) % nr

        for x in range(x0 - k * h0, x0 - k * h0 + 2 * h0):
            rings[-1][slot(x)] = frame(other, x, k)
        for tick in range(x0 - (k - 1) * h0, x1 + (k - 1) * h0):
            rings[-1][slot(tick + h0)] = frame(other, tick + h0, k)
            for j in range(k):
                x, e = tick - j * h0, k - 1 - j
                if not x0 - e * h0 <= x < x1 + e * h0:
                    continue
                v = frame(role[j % 2], x, e)
                if 0 <= x < R0:
                    def tap_read(g, offs, j=j, x=x):
                        d = offsets3(offs)
                        if g == other:          # sub-step j-1, ring j-1
                            r = rings[j - 1][slot(x + d[0])]
                            a, b = (k - j) * h1 + d[1], (k - j) * h2 + d[2]
                            return r[a:a + R1, b:b + R2]
                        if g == written:        # sub-step j-2, center only
                            if j == 0:
                                return plan.interior3(g, padded[g], x).float()
                            r = rings[j - 2][slot(x)]
                            a, b = (k + 1 - j) * h1, (k + 1 - j) * h2
                            return r[a:a + R1, b:b + R2]
                        w = plan.hw3[g]
                        return bufs[g][w[0] + x + d[0],
                                       w[1] + d[1]:w[1] + d[1] + R1,
                                       w[2] + d[2]:w[2] + d[2] + R2].float()

                    val = lowering.exec_statements(
                        plan.kernel, tap_read, scal, (R1, R2), dtype,
                        device)[written]
                    v[e * h1:e * h1 + R1, e * h2:e * h2 + R2] = val
                    if j >= k - 2 and x0 <= x < x1:
                        g = role[j % 2]
                        plan.interior3(g, spares[g], x).copy_(val)
                if j < k - 1:
                    rings[j][slot(x)] = v


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
