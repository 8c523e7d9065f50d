"""K4 — the per-application kernel of ``st.map`` (templates gmem, f4,
smem) and its plain version.

Replaces the JAX package's ``kernels/stencil/codegen.py`` ``lower_pallas``
with ``_make_body_blocked`` (gmem/f4: taps concatenated from neighbour
blocks; smem: the halo'd tile pasted into VMEM scratch).  CUDA source:
``csrc/map_step.cuh`` (f4's rows: ``csrc/f4_rows.cuh``): a thread block
covers a ``b0 × b1 × b2`` tile of the region and each thread walks its
column's ``b0`` points; gmem reads taps from device memory, f4 computes 4
consecutive points along axis 2 from tap rows loaded as aligned float4s,
smem stages the halo'd tile of each grid with an off-center tap in shared
memory.  The gmem body, built without a destination, is also K1
(``fused_step``).  Bound: device-memory bytes (each input grid read once,
each output written once per application).

The plain version walks the same chunks of ``b0`` planes, with one tile
spanning the whole plane: gmem reads the grids, smem the staged tile (the
grid's cells within the tap reach), f4 the rows of each group of 4 points
gathered as the kernel loads them (aligned down to a multiple of 4
elements, float4s past the needed cells left 0, realigned by the row's
offset; cells past the tensor's end, which only points past the region's
end read, are taken from its last cell).  The CPU tests thus exercise the kernel's index arithmetic.

Both versions read f32 or bf16 grids, compute in f32 and round once, when
they store an output cell.

Writes: both versions write the outputs' region, into the grids when the
plan writes in place and else into the destination buffers; nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.core import lowering
from repro_torch.core.dsl import scalar_tensors

from .. import _build
from .emit import f4_rows, offsets3


def _f4_taps(plan, bufs, x0: int, x1: int):
    """Tap reader of the f4 groups of planes ``[x0, x1)``: each row's cells
    gathered as the kernel loads them, then read per point."""
    R1, R2 = plan.R3[1], plan.R3[2]
    ngrp = -(-R2 // 4)
    dev = bufs[plan.opnd_grids[0]].device
    x = torch.arange(x0, x1, device=dev).view(-1, 1, 1)
    y = torch.arange(R1, device=dev).view(1, -1, 1)
    z0 = 4 * torch.arange(ngrp, device=dev).view(1, 1, -1)
    m = torch.clamp(R2 - z0, max=4)
    rows = {}
    for g, dx, dy, lo, hi in f4_rows(plan.kernel, plan.opnd_grids,
                                     plan.out_grids):
        b, o = plan.buf3(bufs[g]), plan.org3[g]
        sx, sy = b.stride(0), b.stride(1)
        flat = b.reshape(-1)
        first = (o[0] * sx + o[1] * sy + o[2] + (x + dx) * sx + (y + dy) * sy
                 + z0 + lo)
        end = first + m + hi - lo             # one past the last needed cell
        a = first - first % 4                 # aligned down
        width = 4 + hi - lo
        nv = (width + 6) // 4
        k4 = 4 * torch.arange(nv, device=dev)
        start = a.unsqueeze(-1) + k4          # each float4's first element
        idx = (start.unsqueeze(-1) + torch.arange(4, device=dev)).flatten(-2)
        # a loaded float4 may end past the tensor: those cells feed only
        # points past the region's end, so any value serves
        w = flat[idx.clamp(max=flat.numel() - 1)]
        w = torch.where((start < end.unsqueeze(-1)).repeat_interleave(4, -1),
                        w, w.new_zeros(()))
        off = (first - a).unsqueeze(-1) + torch.arange(width, device=dev)
        rows[(g, dx, dy)] = (torch.gather(w, -1, off.expand(*w.shape[:-1], width))
                             .float(), lo)

    def tap_read(g, offs):
        dx, dy, dz = offsets3(offs)
        v, lo = rows[(g, dx, dy)]
        pts = torch.stack([v[..., j + dz - lo] for j in range(4)], dim=-1)
        return pts.flatten(-2)[..., :R2]
    return tap_read


def map_step_plain(plan, bufs: Dict[str, torch.Tensor],
                   scalars: Dict[str, float],
                   dst: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """K4's plain PyTorch version (see the module docstring)."""
    R0, R1, R2 = plan.R3
    device = bufs[plan.opnd_grids[0]].device
    scal = scalar_tensors(scalars, device)
    grids = {g: plan.buf3(bufs[g]) for g in plan.opnd_grids}

    def box(t, o, x0, x1, d, e=(0, 0, 0)):
        """Planes ``[x0, x1)`` of ``t`` at origin ``o`` shifted by ``d`` and
        widened by ``e`` per side."""
        return t[o[0] + d[0] + x0 - e[0]:o[0] + d[0] + x1 + e[0],
                 o[1] + d[1] - e[1]:o[1] + d[1] + R1 + e[1],
                 o[2] + d[2] - e[2]:o[2] + d[2] + R2 + e[2]]

    for x0 in range(0, R0, plan.B3[0]):
        x1 = min(x0 + plan.B3[0], R0)
        if plan.template == "f4":
            tap_read = _f4_taps(plan, bufs, x0, x1)
        elif plan.template == "smem":
            # the staged tile: every cell of it lies within the tap reach
            tiles = {g: box(grids[g], plan.org3[g], x0, x1, (0, 0, 0),
                            plan.gh3[g]).float()
                     for g in plan.opnd_grids if any(plan.gh3[g])}

            def tap_read(g, offs, x0=x0, x1=x1, tiles=tiles):
                d = offsets3(offs)
                if g not in tiles:                 # center-only grid
                    return box(grids[g], plan.org3[g], x0, x1, d).float()
                h = plan.gh3[g]
                return tiles[g][h[0] + d[0]:h[0] + d[0] + x1 - x0,
                                h[1] + d[1]:h[1] + d[1] + R1,
                                h[2] + d[2]:h[2] + d[2] + R2]
        else:
            def tap_read(g, offs, x0=x0, x1=x1):
                return box(grids[g], plan.org3[g], x0, x1,
                           offsets3(offs)).float()
        env = lowering.exec_statements(plan.kernel, tap_read, scal,
                                       (x1 - x0, R1, R2), torch.float32,
                                       device)
        for g in plan.out_grids:
            plan.out3(g, bufs, dst)[x0:x1].copy_(env[g])


def map_step(plan, bufs: Dict[str, torch.Tensor], scalars: Dict[str, float],
             dst: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """One application of ``plan`` (a ``MapPlan`` of template gmem, f4 or
    smem) on the grids' full tensors, outputs into ``dst`` (None: in
    place).  CPU tensors run the plain version; CUDA tensors launch the
    kernel (counted in ``map_step.launches``) on the current stream, or
    raise."""
    device = bufs[plan.opnd_grids[0]].device
    if device.type == "cpu":
        map_step_plain(plan, bufs, scalars, dst)
        return
    if device.type != "cuda":
        raise ValueError(f"map_step: unsupported device {device}")
    meta, scal = plan.launch_args(bufs, scalars, dst)
    fn = _build.load(plan.source(bufs[plan.opnd_grids[0]].dtype), "rt_map_step")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(meta), ctypes.addressof(scal),
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"map_step launch failed: cudaError {err}")
    map_step.launches += 1


map_step.launches = 0
