"""Acoustic isotropic wave propagation (paper §2.2 / §6.2) as a StencilPy
application: 25-point star stencil (8th order in space, 2nd order in time),
PML absorbing boundaries, per-iteration source perturbation.

Update (leapfrog with damping η = damp·dt, unified-domain form — PML folded
in as a coefficient field so the same kernel covers inner + PML regions;
regions.py provides the 2/7-region decomposition alternative):

    p_next = (2·p1 − (1−η)·p0 + (vp²·dt²)·Δ₈p1) / (1+η)

Δ₈ is the 8th-order 25-point star Laplacian (unit grid spacing; the dx
scaling is folded into vp²·dt²).  The kernel's source text is the JAX
package's, so both frontends parse the same IR.

In place: ``inject_source`` adds to ``p.data`` (out of place, rebinding
``p.data``, when autograd records it: the adjoint's hook); the targets
advance the grids' buffers in place (``st.timeloop``/``st.map``).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import dsl as st
from . import regions
from . import trace as _trace

# 8th-order central second-derivative coefficients
C0 = -205.0 / 72.0
C1 = 8.0 / 5.0
C2 = -1.0 / 5.0
C3 = 8.0 / 315.0
C4 = -1.0 / 560.0
ORDER = 4


@st.kernel
def acoustic_iso_kernel(p0: st.grid, p1: st.grid, vp2: st.grid,
                        damp: st.grid, dt: st.f32):
    lap = (3.0 * -2.8472222 * p1.at(0, 0, 0)
           + 1.6 * (p1.at(-1, 0, 0) + p1.at(1, 0, 0)
                    + p1.at(0, -1, 0) + p1.at(0, 1, 0)
                    + p1.at(0, 0, -1) + p1.at(0, 0, 1))
           - 0.2 * (p1.at(-2, 0, 0) + p1.at(2, 0, 0)
                    + p1.at(0, -2, 0) + p1.at(0, 2, 0)
                    + p1.at(0, 0, -2) + p1.at(0, 0, 2))
           + 0.025396825 * (p1.at(-3, 0, 0) + p1.at(3, 0, 0)
                            + p1.at(0, -3, 0) + p1.at(0, 3, 0)
                            + p1.at(0, 0, -3) + p1.at(0, 0, 3))
           - 0.0017857143 * (p1.at(-4, 0, 0) + p1.at(4, 0, 0)
                             + p1.at(0, -4, 0) + p1.at(0, 4, 0)
                             + p1.at(0, 0, -4) + p1.at(0, 0, 4)))
    p0.at(0, 0, 0).set(
        (2.0 * p1.at(0, 0, 0)
         - (1.0 - damp.at(0, 0, 0) * dt) * p0.at(0, 0, 0)
         + vp2.at(0, 0, 0) * dt * dt * lap)
        / (1.0 + damp.at(0, 0, 0) * dt))


def make_fields(shape: Tuple[int, int, int], pml_width: int = 10,
                vp: float = 1.5, dt: float = 0.3,
                damp_strength: float = 0.2, device=None,
                batch: Optional[int] = None):
    """Build (p0, p1, vp2, damp) grids for a domain of ``shape`` interior
    points on ``device`` (None: the card), plus ``dt`` as f32.  vp in
    km/s-ish units; dt chosen CFL-stable for vp=1.5.  ``batch=B``: B shots,
    each grid with a leading scenario axis (every shot starts from the same
    model; give each its own ``vp2`` and source position,
    ``inject_source(pos=[...])``)."""
    dev = st.resolve_device(device)
    g = lambda: st.grid(dtype=st.f32, shape=shape, order=ORDER,  # noqa: E731
                        device=dev, batch=batch)
    lead = (batch,) if batch else ()
    p0, p1 = g(), g()
    vp2 = g()
    vp2.interior = np.full(lead + tuple(shape), vp * vp, np.float32)
    damp = g()
    damp.interior = np.broadcast_to(
        regions.damping_mask(shape, pml_width, strength=damp_strength),
        lead + tuple(shape)).copy()
    return p0, p1, vp2, damp, np.float32(dt)


def source_wavelet(t: int, f0: float = 0.015, t0: int = 40) -> float:
    """Ricker wavelet sample at integer time step t."""
    a = (np.pi * f0 * (t - t0)) ** 2
    return float((1.0 - 2.0 * a) * np.exp(-a))


def inject_source(p: st.grid, t: int,
                  pos: Union[None, Tuple[int, ...], Sequence[Tuple[int, ...]]] = None,
                  amp: float = 1.0) -> None:
    """Paper §6.2: 'simulates the source perturbation after each time
    iteration' — add a wavelet sample at the source point (default: the
    centre), in place.  A batched grid takes one position for every shot,
    or a sequence of one a shot.  Where autograd records the grid (the
    adjoint's hook) the sum is out of place, ``p.data`` a new tensor, so
    that it is differentiated as the JAX package's ``.at[].add`` is; the
    values are the same."""
    with _trace.span("rt.inject_source"):
        if pos is None:
            pos = tuple(s // 2 for s in p.shape)
        o = p.order
        val = amp * source_wavelet(t)
        if p.batch:
            shots = [tuple(pos)] * p.batch if np.ndim(pos) == 1 else [tuple(q) for q in pos]
            if len(shots) != p.batch:
                raise ValueError(f"{len(shots)} source positions for {p.batch} shots")
            idx = (torch.arange(p.batch, device=p.data.device),) + tuple(
                torch.tensor([o + q[ax] for q in shots], device=p.data.device)
                for ax in range(len(p.shape)))
        else:
            idx = tuple(o + q for q in pos)
        if torch.is_grad_enabled() and p.data.requires_grad:
            idx = tuple(torch.as_tensor(i, device=p.data.device) for i in idx)
            add = torch.full(idx[0].shape, val, dtype=p.dtype, device=p.data.device)
            p.data = p.data.index_put(idx, add, accumulate=True)
        else:
            p.data[idx] += val


@st.target
def acoustic_target(p0: st.grid, p1: st.grid, vp2: st.grid, damp: st.grid,
                    dt: st.f32, iters: st.i32):
    """Time loop: stencil update + buffer swap (source injection is done by
    the caller between launches, matching the paper's host-side loop)."""
    for _t in range(iters):
        st.map(e=p0.shape)(acoustic_iso_kernel)(p0, p1, vp2, damp, dt)
        (p0.data, p1.data) = (p1.data, p0.data)


@st.target
def acoustic_target_fused(p0: st.grid, p1: st.grid, vp2: st.grid,
                          damp: st.grid, dt: st.f32, iters: st.i32,
                          between=None):
    """Fused time loop: the whole step sequence (update + swap) runs per
    fusion window (``st.launch(..., fuse_steps=K)``), syncing with the host
    — and running ``between`` for source injection — only at window
    boundaries."""
    return st.timeloop(iters, swap=("p0", "p1"), between=between)(
        acoustic_iso_kernel)(p0, p1, vp2, damp, dt)


def run(shape=(64, 64, 64), iters: int = 10, backend=None, mesh=None,
        pml_width: int = 8, with_source: bool = True,
        fuse_steps: int = None, device=None):
    """Convenience entry point.  Returns (final wavefield grid, launch profile).

    Without ``fuse_steps`` the per-step path runs (the paper's host-side
    loop): one ``st.map`` launch per step under ``backend`` (default
    ``st.torch()``; ``st.hopper(template=...)`` runs the per-application
    kernels), with the wavelet injected every step.  ``fuse_steps``
    switches to the fused time-loop engine: the wavelet is then injected
    every ``fuse_steps`` steps instead of every step — identical when
    ``fuse_steps=1``.  Fields live on ``device`` (None: the card).  With
    ``backend=st.distributed(...)`` both paths run on ``mesh``'s shards
    (``repro_torch.launch.mesh.make_mesh``), as in the JAX package.  The
    per-step path is one launch of the whole step loop, injections
    included: on the card its host work runs one application ahead of the
    kernels and the launch returns when they have finished.  Its profile
    is the launch's phases and ``loop``, the host seconds of the loop.
    """
    p0, p1, vp2, damp, dt = make_fields(shape, pml_width=pml_width,
                                        device=device)
    backend = backend or st.torch()
    if fuse_steps is not None:
        if with_source:
            inject_source(p1, 0)

            def between(t, grids):
                inject_source(grids["p1"], t)
        else:
            between = None
        res = st.launch(backend=backend, mesh=mesh, fuse_steps=fuse_steps)(
            acoustic_target_fused)(p0, p1, vp2, damp, dt, iters,
                                   between=between)
        return p1, res.profile
    @st.target
    def steps(p0, p1, vp2, damp, dt):
        for t in range(iters):
            if with_source:
                inject_source(p1, t)
            acoustic_target(p0, p1, vp2, damp, dt, 1)

    t0 = time.perf_counter()
    prof = st.launch(backend=backend, mesh=mesh)(steps)(p0, p1, vp2, damp, dt).profile
    prof["loop"] = time.perf_counter() - t0
    return p1, prof
