"""K1 — the fused-step kernel (templates gmem/smem/f4) and its plain version.

Replaces the JAX package's ``kernels/stencil/codegen.py``
``_make_body_fused`` tap branch (``PallasPlan._call_for`` with
``time_block=1``).  CUDA source: K4 gmem's body, ``csrc/map_step.cuh``
(``RT_MAP_T 0``), its destinations the output grids' own layout buffers
(the same build as ``map_step``'s gmem in place): a thread block covers a
``b0 × b1 × b2`` tile of the interior, each thread walks its column's
``b0`` points, taps from global memory, outputs in place.  Bound: device
memory bytes (each operand grid read once, each output written once per
step).

Both versions read f32 or bf16 buffers, compute in f32 and round once,
when they store an output cell.

In place: both versions write the output grids' interiors into their
layout buffers; nothing else is written.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core import lowering
from repro_torch.core.dsl import scalar_tensors

from .. import _build
from .emit import offsets3


def fused_step_plain(plan, padded: Dict[str, torch.Tensor],
                     scalars: Dict[str, float]) -> None:
    """K1's plain PyTorch version: the same per-point update, evaluated
    over the whole interior at once with shifted slices of the layout
    buffers."""
    R0, R1, R2 = plan.R3
    device = padded[plan.out_grids[0]].device

    def tap_read(g, offs):
        d, w = offsets3(offs), plan.hw3[g]
        b = plan.buf3(padded[g])
        return b[w[0] + d[0]:w[0] + d[0] + R0, w[1] + d[1]:w[1] + d[1] + R1,
                 w[2] + d[2]:w[2] + d[2] + R2].float()

    env = lowering.exec_statements(plan.kernel, tap_read,
                                   scalar_tensors(scalars, device),
                                   plan.R3, torch.float32, device)
    for g in plan.out_grids:
        plan.interior3(g, padded[g]).copy_(env[g])


def fused_step(plan, padded: Dict[str, torch.Tensor],
               scalars: Dict[str, float]) -> None:
    """One time step of ``plan`` on its layout buffers.  CPU tensors run
    the plain version; CUDA tensors launch the kernel (counted in
    ``fused_step.launches``) on the current stream, or raise."""
    device = padded[plan.out_grids[0]].device
    if device.type == "cpu":
        fused_step_plain(plan, padded, scalars)
        return
    if device.type != "cuda":
        raise ValueError(f"fused_step: unsupported device {device}")
    meta, scal = plan.launch_args(padded, scalars)
    fn = _build.load(plan.source(padded[plan.out_grids[0]].dtype), "rt_map_step")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(meta), ctypes.addressof(scal),
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_step launch failed: cudaError {err}")
    fused_step.launches += 1


fused_step.launches = 0
