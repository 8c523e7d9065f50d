"""K2 — the 2.5D streaming kernel (templates shift/unroll) and its plain
version.

Replaces the JAX package's ``kernels/stencil/codegen.py``
``_make_body_fused`` streaming branch → ``_stream_outputs`` (shift/unroll
rolling window of ``2h+1`` planes along axis 0).  CUDA source:
``csrc/stream_step.cuh``: a thread block covers a tile of the two fast axes
and walks a chunk of ``b0`` planes, each grid with an off-center tap kept
as a ring of ``2·h0+1`` halo'd planes in shared memory.  Bound: device
memory bytes.

The plain version walks the same chunks and the same ring slots (plane
``p`` of a chunk in slot ``(p + h0) mod n``; a tap at ``dx`` on plane ``t``
reads slot ``(t + h0 + dx) mod n``), with one tile spanning the whole
plane, so the CPU tests exercise the kernel's slot arithmetic.

In place: both versions write the output grids' interiors into their
layout buffers; nothing else is written.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core import lowering
from repro_torch.core.dsl import scalar_tensors

from . import _build
from .emit import offsets3


def stream_step_plain(plan, padded: Dict[str, torch.Tensor],
                      scalars: Dict[str, float]) -> None:
    """K2's plain PyTorch version (see the module docstring)."""
    R0, R1, R2 = plan.R3
    chunk = plan.B3[0]
    out0 = padded[plan.out_grids[0]]
    dtype, device = out0.dtype, out0.device
    scal = scalar_tensors(scalars, device)
    ring_grids = [g for g in plan.opnd_grids if any(plan.gh3[g])]
    bufs = {g: plan.buf3(padded[g]) for g in plan.opnd_grids}

    for x0 in range(0, R0, chunk):
        rings = {}
        for g in ring_grids:
            h = plan.gh3[g]
            rings[g] = torch.zeros((2 * h[0] + 1, R1 + 2 * h[1], R2 + 2 * h[2]),
                                   dtype=dtype, device=device)

        def load(g, xp, slot):
            # cells outside the tap reach [-h, R + h) are never read
            h, w = plan.gh3[g], plan.hw3[g]
            if -h[0] <= xp < R0 + h[0]:
                rings[g][slot] = bufs[g][w[0] + xp, w[1] - h[1]:w[1] + R1 + h[1],
                                         w[2] - h[2]:w[2] + R2 + h[2]]

        for g in ring_grids:
            h0 = plan.gh3[g][0]
            for q in range(-h0, h0):
                load(g, x0 + q, (q + h0) % (2 * h0 + 1))
        for t in range(min(chunk, R0 - x0)):
            x = x0 + t
            for g in ring_grids:
                h0 = plan.gh3[g][0]
                load(g, x + h0, (t + 2 * h0) % (2 * h0 + 1))

            def tap_read(g, offs, t=t, x=x):
                d = offsets3(offs)
                if g not in rings:
                    return plan.interior3(g, padded[g], x)   # center only
                h = plan.gh3[g]
                n = 2 * h[0] + 1
                slot = t % n + h[0] + d[0]
                slot -= n if slot >= n else 0
                return rings[g][slot, h[1] + d[1]:h[1] + d[1] + R1,
                                h[2] + d[2]:h[2] + d[2] + R2]

            env = lowering.exec_statements(plan.kernel, tap_read, scal,
                                           (R1, R2), dtype, device)
            for g in plan.out_grids:
                plan.interior3(g, padded[g], x).copy_(env[g])


def stream_step(plan, padded: Dict[str, torch.Tensor],
                scalars: Dict[str, float]) -> None:
    """One time step of ``plan`` on its layout buffers.  CPU tensors run
    the plain version; CUDA tensors launch the kernel (counted in
    ``stream_step.launches``) on the current stream, or raise."""
    device = padded[plan.out_grids[0]].device
    if device.type == "cpu":
        stream_step_plain(plan, padded, scalars)
        return
    if device.type != "cuda":
        raise ValueError(f"stream_step: unsupported device {device}")
    meta, scal = plan.launch_args(padded, scalars)
    fn = _build.load(plan.source(), "rt_stream_step")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(meta), ctypes.addressof(scal),
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"stream_step launch failed: cudaError {err}")
    stream_step.launches += 1


stream_step.launches = 0
