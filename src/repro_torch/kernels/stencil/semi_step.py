"""K5 — the semi-stencil kernel (template semi) and its plain version.

Replaces the JAX package's ``kernels/stencil/codegen.py`` ``_stream_outputs``
semi branch (with ``_semi_linearize`` and ``_stream_halo``), reached from
``_make_body_fused`` (``PallasPlan._call_for``, ``time_block=1``).  CUDA
source: ``csrc/semi_step.cuh`` with the per-column ring of
``csrc/semi_ring.cuh``: a thread block covers a tile of the two fast axes
and walks a chunk of ``b0`` planes; each input plane is copied once into a
ring of staged planes in shared memory (``cp.async``, two planes ahead of
the one being scattered) and scattered into ``2H+1`` partial output planes
per column, kept in registers.  The terms of an output are grouped by the
residual of their coefficient (``emit.semi_plan``): a term adds ``κ·tap``
to its group's partial sum, and each residual is evaluated once a point,
when the plane is emitted.  The scatter itself is generated
(``emit.semi_functions``).  Bound: device-memory bytes.

The plain version walks the same chunks and the same ring slots (output
plane ``o = x_in - D`` of input plane ``x_in``, local index ``i``, in slot
``(i + H - D) mod (2H+1)``; plane ``x_in - H`` is emitted from slot
``i mod (2H+1)``), adds the terms into the same groups in the kernel's
order, finishes a plane as the kernel does (``Σ_g φ_g · P_g`` in group
order, then the constant) and, like the kernel, adds only into planes of
the chunk; one tile spans the whole plane.  Both versions read f32 or
bf16 grids, compute in f32 and round once, when they store an output cell.

It also runs K5's per-application call (template semi of ``st.map``, a
``MapPlan``: ``_make_body_streaming`` → ``_stream_outputs``, reached from
``lower_pallas``): the same source built with ``RT_MAP``, on the grids'
full tensors with the origin at the region's first point, outputs into
the plan's destinations.

Under ``batch=B`` (the fused path) the buffers carry a leading scenario
axis: the kernel advances every scenario in one launch, the plain version
each scenario as its own step (``CudaPlan.scenarios``).

Writes: both versions write the output grids' interiors (``MapPlan``: the
region, in place or into ``dst``); nothing else is written.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import lowering
from repro_torch.core.dsl import scalar_tensors

from .. import _build
from .emit import semi_plan


def semi_step_plain(plan, padded: Dict[str, torch.Tensor],
                    scalars: Dict[str, float],
                    dst: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """K5's plain PyTorch version (see the module docstring)."""
    if plan.batch_of(padded[plan.out_grids[0]]):
        for args in plan.scenarios(padded, scalars, dst):
            semi_step_plain(plan, *args)
        return
    R0, R1, R2 = plan.R3
    H, chunk = plan.H, plan.B3[0]
    nr = 2 * H + 1
    device = padded[plan.out_grids[0]].device
    scal = scalar_tensors(scalars, device)
    groups = semi_plan(plan.lin, plan.out_grids)
    bufs = {g: plan.buf3(padded[g]) for g in plan.opnd_grids}

    def field_at(plane):
        # coefficient fields: center taps at output plane ``plane``
        return lambda g, offs: plan.interior3(g, padded[g], plane).float()

    def tap(g, xin, d):
        w = plan.org3[g]
        return bufs[g][w[0] + xin, w[1] + d[1]:w[1] + d[1] + R1,
                       w[2] + d[2]:w[2] + d[2] + R2].float()

    def finish(o, phis, acc, plane):
        # Σ_g φ_g · P_g in group order, then the constant (emit.semi_functions)
        rd = field_at(plane)
        val = None
        for grp, phi in enumerate(phis):
            part = acc[grp]
            if phi is not None:
                part = lowering.eval_expr(phi, rd, scal, {}) * part
            val = part if val is None else val + part
        cv = lowering.eval_expr(plan.lin[plan.out_grids[o]][1], rd, scal, {})
        if not (isinstance(cv, float) and cv == 0.0) or val is None:
            val = cv if val is None else val + cv
        return torch.as_tensor(val, dtype=torch.float32, device=device)

    for x0 in range(0, R0, chunk):
        x1 = min(x0 + chunk, R0)
        acc = [torch.zeros((nr, len(phis), R1, R2), dtype=torch.float32,
                           device=device) for phis, _ in groups]
        for i in range(x1 - x0 + 2 * H):
            xin = x0 - H + i
            for o, (phis, by_d) in enumerate(groups):
                for d in range(-H, H + 1):
                    if not x0 <= xin - d < x1:
                        continue
                    for g, offs, grp, kappa in by_d.get(d, ()):
                        acc[o][(i + H - d) % nr, grp] += \
                            float(np.float32(kappa)) * tap(g, xin, offs)
                if x0 <= xin - H < x1:
                    plan.out3(plan.out_grids[o], padded, dst, xin - H).copy_(
                        finish(o, phis, acc[o][i % nr], xin - H))
                acc[o][i % nr].zero_()


def semi_step(plan, padded: Dict[str, torch.Tensor],
              scalars: Dict[str, float],
              dst: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """One time step of ``plan`` on its layout buffers, or one application
    of a ``MapPlan`` on the grids' full tensors with outputs into ``dst``
    (None: in place).  CPU tensors run the plain version; CUDA tensors
    launch the kernel (counted in ``semi_step.launches``) on the current
    stream, or raise."""
    device = padded[plan.out_grids[0]].device
    if device.type == "cpu":
        semi_step_plain(plan, padded, scalars, dst)
        return
    if device.type != "cuda":
        raise ValueError(f"semi_step: unsupported device {device}")
    meta, scal = (plan.launch_args(padded, scalars) if dst is None
                  else plan.launch_args(padded, scalars, dst))
    fn = _build.load(plan.source(padded[plan.out_grids[0]].dtype),
                     "rt_semi_step")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(meta), ctypes.addressof(scal),
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"semi_step launch failed: cudaError {err}")
    semi_step.launches += 1


semi_step.launches = 0
