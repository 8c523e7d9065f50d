"""The acoustic-ISO kernel (paper §2.2/§6.2): its seeded initial state,
made on the device, and its binding to the program's DSL.

State: the wavefields ``p0`` and ``p1`` start at zero.  ``vp2`` holds vp²
of a layered model along axis 0 (depth): ``velocity.layers`` layers whose
speeds rise evenly from ``vp_top`` to ``vp_bottom``; the seed moves each
interface by up to ``interface_jitter`` cells from its even spacing, so
every seed does the same work.  ``damp`` is the quadratic PML profile of
width ``pml_width`` and strength ``damping_strength``, zero inside.  ``dt``
gives the configured Courant number at the fastest layer (unit spacing).

Hooks: the Ricker source sits ``wavelet.depth_below_pml`` cells below the
top PML at the centre of the surface; ``inject(t)`` adds its sample ``t``
to the newest field, ``record()`` is that field's plane at the source's
depth (the receivers).
"""
from __future__ import annotations

import inspect

import numpy as np

from portbench.reference.acoustic_iso import source_position
from portbench.stencils import Program, full_shape, interior, leapfrog_pairs


def damping(cfg, device):
    """The PML profile on the interior, in f32: per axis
    ``strength · (d / w)²`` with ``d`` the distance into the layer, summed
    over the axes."""
    import torch
    w = max(cfg["pml_width"], 1)
    nd = len(cfg["shape"])
    total = torch.zeros(tuple(cfg["shape"]), dtype=torch.float32, device=device)
    for ax, n in enumerate(cfg["shape"]):
        x = torch.arange(n, dtype=torch.float32, device=device)
        d = torch.clamp(w - x, min=0) + torch.clamp(x - (n - 1 - w), min=0)
        shp = [1] * nd
        shp[ax] = n
        total += (cfg["damping_strength"] * (d / w) ** 2).reshape(shp)
    return total


def make_state(cfg, gen, device):
    """(tensors, scalars): zero wavefields, the seeded layered vp², the PML
    profile, and ``dt``."""
    import torch
    vel = cfg["velocity"]
    n0 = cfg["shape"][0]
    k = vel["layers"]
    speeds = torch.linspace(vel["vp_top"], vel["vp_bottom"], k, dtype=torch.float64)
    w = cfg["pml_width"]
    nominal = torch.tensor([w + (n0 - 2 * w) * i / k for i in range(1, k)],
                           dtype=torch.float64)
    j = vel["interface_jitter"]
    shift = torch.randint(-j, j + 1, (k - 1,), generator=gen, device=device).cpu()
    tops = (nominal.round() + shift).long()
    layer = torch.bucketize(torch.arange(n0), tops, right=True)
    vp = speeds[layer].to(torch.float32).to(device)
    full = full_shape(cfg)
    vp2 = torch.zeros(full, dtype=torch.float32, device=device)
    vp2[interior(cfg)] = (vp * vp).reshape(-1, 1, 1)
    damp = torch.zeros(full, dtype=torch.float32, device=device)
    damp[interior(cfg)] = damping(cfg, device)
    p0 = torch.zeros(full, dtype=torch.float32, device=device)
    dt = float(np.float32(cfg["courant"] / vel["vp_bottom"]))
    return ({"p0": p0, "p1": torch.zeros_like(p0), "vp2": vp2, "damp": damp},
            {"dt": dt})


def kernel():
    """The program's DSL kernel: ``core/acoustic.py``'s."""
    from repro_torch.core import acoustic
    return acoustic.acoustic_iso_kernel


def bind(cfg, tensors, scalars, dtype="f32"):
    """The program's kernel, grids and hooks on ``tensors`` (cast to
    ``dtype``).  The program's source has a fixed wavelet: a configuration
    with another one is refused."""
    from repro_torch.core import acoustic
    from repro_torch.core import dsl as st
    defaults = inspect.signature(acoustic.source_wavelet).parameters
    wv = cfg["wavelet"]
    if (wv["f0"], wv["t0"]) != (defaults["f0"].default, defaults["t0"].default):
        raise ValueError(f"the program's wavelet is f0={defaults['f0'].default}, "
                         f"t0={defaults['t0'].default}; the configuration asks "
                         f"for f0={wv['f0']}, t0={wv['t0']}")
    k = kernel()
    grids = {n: st.grid(dtype=getattr(st, dtype), shape=tuple(cfg["shape"]),
                        order=cfg["order"], data=tensors[n])
             for n in k.ir.grid_params}
    pos = source_position(cfg)
    p1 = grids["p1"]
    return Program(
        kernel=k, grids=grids,
        args=[grids[n] for n in k.ir.grid_params] + [np.float32(scalars["dt"])],
        pairs=leapfrog_pairs(cfg["swap"]),
        inject=lambda t: acoustic.inject_source(p1, t, pos=pos, amp=wv["amp"]),
        record=lambda: p1.interior[pos[0]])
