"""K4 — the per-application kernel of ``st.map`` (templates gmem, f4,
smem) and its plain version.

Replaces the JAX package's ``kernels/stencil/codegen.py`` ``lower_pallas``
with ``_make_body_blocked`` (gmem/f4: taps concatenated from neighbour
blocks; smem: the halo'd tile pasted into VMEM scratch).  CUDA source:
``csrc/map_step.cuh``.  gmem (``csrc/gmem_column.cuh``): a thread block
covers a ``b0 × b1 × b2`` tile of the region and each lane walks its
column's ``b0`` planes, two points adjacent along axis 2 a plane where the
block allows, reading taps from device memory: its axis-0 taps from
register queues, its axis-2 taps in its own cells from there too, the
others as loads at constant offsets (of aligned pairs of cells where the
grid's rows allow, ``MapPlan.gmem_pairs``).  f4 (``csrc/f4_rows.cuh``): each thread
walks a column of groups of 4 points along axis 2, its tap rows loaded as
aligned vectors of 4 cells and carried along axis 0 in register queues
(``emit.f4_pieces``), each row's place in its vector fixed by the plan
where the pitches allow (``MapPlan.f4_org_mod4``).  smem
(``csrc/map_smem.cuh``): persistent blocks stage each tile's halo'd box by
TMA or 4-byte ``cp.async`` (``MapPlan.smem_tma``) into one of two stages
while they evaluate the other.  The gmem body, built without a
destination, is also K1 (``fused_step``).  Bound: device-memory bytes
(each input grid read once, each output written once per application).

The plain version walks the same chunks of ``b0`` planes, with one tile
spanning the whole plane: gmem (``gmem_taps``) reads each axis-0 tap from
the queue slot the kernel reads and each axis-2 tap in the lane's own
cells from its queue, the other taps from the grids; smem the staged
box of
each chunk in the grids' own type (planes ``[x0 - h0, x0 + b0 + h0)``;
cells outside the tap reach are NaN, so a read of one would show), and the
column's axis-0 taps from its centre as the register queue holds them;
f4 each queue piece of each plane loaded once as the kernel loads it (from
the plan's fixed place, or aligned down at run time; vectors past the
family's last needed cell left 0; cells past the tensor's end, which only
points past the region's end read, taken from its last cell) and read at
each axis-0 offset from the queue's slot.  The CPU tests thus exercise the
kernel's index arithmetic.

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
from .emit import f4_pieces, f4_rows, offsets3


def _f4_taps(plan, bufs, x0: int, x1: int):
    """Tap reader of the f4 groups of planes ``[x0, x1)``: each queue piece
    (``emit.f4_pieces``) of every plane in ``[x0 + a, x1 - 1 + b]`` loaded
    once, as the kernel loads a queue's leading slot, then read at axis-0
    offset ``dx`` from slot ``(x + dx) - (x0 + a)``."""
    R1, R2 = plan.R3[1], plan.R3[2]
    ngrp = -(-R2 // 4)
    dev = bufs[plan.opnd_grids[0]].device
    y = torch.arange(R1, device=dev).view(1, -1, 1)
    z0 = 4 * torch.arange(ngrp, device=dev).view(1, 1, -1)
    m = torch.clamp(R2 - z0, max=4)
    families, pieces = f4_pieces(
        f4_rows(plan.kernel, plan.opnd_grids, plan.out_grids),
        plan.f4_org_mod4())
    fam_of = {(g, dy): f for f, (g, dy, _) in enumerate(families)}
    loaded = []
    for pc in pieces:
        g, dy, hi = families[pc.fam]
        b = plan.buf3(bufs[g])
        sx, sy = b.stride(0), b.stride(1)
        flat = b.reshape(-1)
        o = plan.org3[g]
        xp = torch.arange(x0 + pc.a, x1 + pc.b, device=dev).view(-1, 1, 1)
        row = o[0] * sx + o[1] * sy + o[2] + xp * sx + (y + dy) * sy + z0
        first = row + pc.c0
        last = row + m - 1 + hi          # the last cell the family may need
        width = pc.c1 - pc.c0 + 1
        if pc.off is None:               # aligned down at run time
            a = first - first % 4
            nv = (width + 6) // 4
        else:                            # the plan's fixed place
            a = first - pc.off
            nv = (pc.off + width + 3) // 4
            assert bool((a % 4 == 0).all()), "f4: a row's place differs from the plan's"
        start = a.unsqueeze(-1) + 4 * torch.arange(nv, device=dev)
        idx = (start.unsqueeze(-1) + torch.arange(4, device=dev)).flatten(-2)
        # a loaded vector may end past the tensor: those cells feed only
        # points past the region's end, so any value serves
        w = flat[idx.clamp(max=flat.numel() - 1)]
        w = torch.where((start <= last.unsqueeze(-1)).repeat_interleave(4, -1),
                        w, w.new_zeros(()))
        off = (first - a).unsqueeze(-1) + torch.arange(width, device=dev)
        loaded.append(torch.gather(w, -1, off.expand(*w.shape[:-1], width))
                      .float())

    def piece_of(f, c):
        return next(i for i, pc in enumerate(pieces)
                    if pc.fam == f and pc.c0 <= c <= pc.c1)

    def tap_read(g, offs):
        dx, dy, dz = offsets3(offs)
        f = fam_of[(g, dy)]
        pts = []
        for j in range(4):
            p = piece_of(f, dz + j)
            s0 = dx - pieces[p].a
            pts.append(loaded[p][s0:s0 + x1 - x0, ..., dz + j - pieces[p].c0])
        return torch.stack(pts, dim=-1).flatten(-2)[..., :R2]
    return tap_read


def gmem_taps(plan, bufs: Dict[str, torch.Tensor], x0: int, x1: int):
    """Tap reader of K1's and K4 gmem's planes ``[x0, x1)`` over the whole
    region: each axis-0 tap from the queue slot the kernel reads, every
    lane's unit loaded as the kernel loads it (the lanes past the region's
    end too, their cells clamped to the grid's reach), each axis-2 tap in
    the lane's own cells from its queue, every other tap from the grid."""
    R0, R1, R2 = plan.R3
    dev = bufs[plan.opnd_grids[0]].device
    P = plan.gmem_column().cells
    nz = -(-R2 // plan.B3[2]) * plan.B3[2]
    pos = torch.arange(nz, device=dev)          # every lane's cells
    rows = torch.arange(R1, device=dev)
    grids = {g: plan.buf3(bufs[g]) for g in plan.opnd_grids}
    memo = {}

    def unit(g, slot):
        """Queue slot ``slot`` of grid ``g`` at each plane: every lane's
        unit of plane ``x - h0 + slot``."""
        if (g, slot) not in memo:
            b, o, h = grids[g], plan.org3[g], plan.gh3[g]
            xs = torch.arange(x0 - h[0] + slot, x1 - h[0] + slot, device=dev)
            idx = ((o[0] + xs).view(-1, 1, 1) * b.stride(0)
                   + (o[1] + rows).view(1, -1, 1) * b.stride(1)
                   + (o[2] + pos.clamp(max=R2 - 1 + h[2])).view(1, 1, -1))
            memo[(g, slot)] = b.reshape(-1)[idx].float()
        return memo[(g, slot)]

    def load(g, dx, dy, dz):
        b, o = grids[g], plan.org3[g]
        return b[o[0] + x0 + dx:o[0] + x1 + dx, o[1] + dy:o[1] + dy + R1,
                 o[2] + dz:o[2] + dz + R2].float()

    def tap_read(g, offs):
        dx, dy, dz = offsets3(offs)
        h0 = plan.gh3[g][0]
        if dy == 0 and dz == 0:
            return unit(g, h0 + dx)[..., :R2]
        if dx == 0 and dy == 0:
            # cell j + dz of point j of a lane, in the lane's own unit
            z = torch.arange(R2, device=dev)
            k = z % P + dz
            own = (k >= 0) & (k < P)
            return torch.where(own, unit(g, h0)[..., (z + dz).clamp(0, nz - 1)],
                               load(g, 0, 0, dz))
        return load(g, dx, dy, dz)
    return tap_read


def _smem_tile(plan, t: torch.Tensor, g: str, x0: int) -> torch.Tensor:
    """The smem kernel's staged box of grid ``g`` (3D buffer ``t``) for the
    chunk at plane ``x0``: planes ``[x0 - h0, x0 + b0 + h0)`` with the tap
    halo along axes 1 and 2 (one tile spanning the whole plane), in the
    grid's own type.  Cells outside the tap reach ``[-h, R + h)`` (the
    chunk's box runs past the region's last plane) are NaN: a point of the
    region never reads them."""
    h, o, R = plan.gh3[g], plan.org3[g], plan.R3
    tile = t.new_full((plan.B3[0] + 2 * h[0], R[1] + 2 * h[1], R[2] + 2 * h[2]),
                      float("nan"))
    n = min(plan.B3[0] + 2 * h[0], R[0] + h[0] - (x0 - h[0]))
    tile[:n] = t[o[0] + x0 - h[0]:o[0] + x0 - h[0] + n,
                 o[1] - h[1]:o[1] + R[1] + h[1], o[2] - h[2]:o[2] + R[2] + h[2]]
    return tile


def map_step_plain(plan, bufs: Dict[str, torch.Tensor],
                   scalars: Dict[str, float],
                   dst: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """K4's plain PyTorch version (see the module docstring)."""
    R0, R1, R2 = plan.R3
    device = bufs[plan.opnd_grids[0]].device
    scal = scalar_tensors(scalars, device)
    grids = {g: plan.buf3(bufs[g]) for g in plan.opnd_grids}

    def box(t, o, x0, x1, d):
        """Planes ``[x0, x1)`` of ``t`` at origin ``o`` shifted by ``d``."""
        return t[o[0] + d[0] + x0:o[0] + d[0] + x1, o[1] + d[1]:o[1] + d[1] + R1,
                 o[2] + d[2]:o[2] + d[2] + R2]

    for x0 in range(0, R0, plan.B3[0]):
        x1 = min(x0 + plan.B3[0], R0)
        if plan.template == "f4":
            tap_read = _f4_taps(plan, bufs, x0, x1)
        elif plan.template == "smem":
            tiles = {g: _smem_tile(plan, grids[g], g, x0)
                     for g in plan.opnd_grids if any(plan.gh3[g])}

            def tap_read(g, offs, x0=x0, x1=x1, tiles=tiles):
                d = offsets3(offs)
                if g not in tiles:                 # center-only grid
                    return box(grids[g], plan.org3[g], x0, x1, d).float()
                h = plan.gh3[g]
                if d[1] == 0 and d[2] == 0:
                    # the register queue: the column's centre, a plane a step
                    t = tiles[g][:, h[1]:h[1] + R1, h[2]:h[2] + R2]
                    return t[h[0] + d[0]:h[0] + d[0] + x1 - x0].float()
                return tiles[g][h[0] + d[0]:h[0] + d[0] + x1 - x0,
                                h[1] + d[1]:h[1] + d[1] + R1,
                                h[2] + d[2]:h[2] + d[2] + R2].float()
        else:
            tap_read = gmem_taps(plan, bufs, x0, x1)
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
    fn = _build.load(plan.source(bufs[plan.opnd_grids[0]].dtype, bufs), "rt_map_step")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(meta), ctypes.addressof(scal),
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"map_step launch failed: cudaError {err}")
    map_step.launches += 1


map_step.launches = 0
