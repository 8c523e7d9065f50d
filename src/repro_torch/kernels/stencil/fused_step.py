"""K1 — the fused-step kernel (templates gmem/smem/f4) and its plain version.

Replaces the JAX package's ``kernels/stencil/codegen.py``
``_make_body_fused`` tap branch (``PallasPlan._call_for`` with
``time_block=1``).  CUDA source: K4 gmem's body, ``csrc/map_step.cuh``
(``RT_MAP_T 0``, lanes and queues in ``csrc/gmem_column.cuh``), its
destinations the output grids' own layout buffers (the same build as
``map_step``'s gmem in place): a thread block covers a ``b0 × b1 × b2``
tile of the interior, each lane walks its column's ``b0`` planes, two
points adjacent along axis 2 where the block allows, with the column's
axis-0 taps in register queues, the axis-2 taps in its own cells from
there too and the other taps loaded from device memory at constant
offsets (aligned pairs where the rows allow), outputs in place.  Bound: device memory bytes (each operand grid
read once, each output written once per step).

The plain version walks the same chunks of ``b0`` planes and reads each
tap where the kernel does (``map_step.gmem_taps``).

Both versions read f32 or bf16 buffers, compute in f32 and round once,
when they store an output cell.

Under ``batch=B`` the buffers carry a leading scenario axis: the kernel
advances every scenario in one launch, the plain version each scenario as
its own step (``CudaPlan.scenarios``).

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
from .map_step import gmem_taps


def fused_step_plain(plan, padded: Dict[str, torch.Tensor],
                     scalars: Dict[str, float]) -> None:
    """K1's plain PyTorch version: the same per-point update, chunk by
    chunk of ``b0`` planes as the kernel's lanes walk them, outputs
    written into the layout buffers' interiors.  ``scalars``: a dict of
    floats, or the ``(B, NS)`` array of a batched launch."""
    if plan.batch_of(padded[plan.out_grids[0]]):
        for args in plan.scenarios(padded, scalars):
            fused_step_plain(plan, *args)
        return
    R0, R1, R2 = plan.R3
    device = padded[plan.out_grids[0]].device
    scal = scalar_tensors(scalars, device)
    for x0 in range(0, R0, plan.B3[0]):
        x1 = min(x0 + plan.B3[0], R0)
        env = lowering.exec_statements(plan.kernel, gmem_taps(plan, padded, x0, x1),
                                       scal, (x1 - x0, R1, R2), torch.float32, device)
        for g in plan.out_grids:
            plan.interior3(g, padded[g])[x0:x1].copy_(env[g])


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
    fn = _build.load(plan.source(padded[plan.out_grids[0]].dtype, padded), "rt_map_step")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(meta), ctypes.addressof(scal),
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_step launch failed: cudaError {err}")
    fused_step.launches += 1


fused_step.launches = 0
