"""Pseudo-acoustic TTI (Zhang, Zhang and Zhang 2011): its seeded initial
state, made on the device, and its binding to the program's DSL.

State: the wavefields ``p0``, ``p1``, ``r0``, ``r1`` start at zero.  The
model is layered along axis 0 (depth) as the acoustic configuration's:
``velocity.layers`` layers whose vp rises evenly from ``vp_top`` to
``vp_bottom``, each interface moved by up to ``interface_jitter`` cells by
the seed; ``epsilon`` and ``delta`` rise evenly by layer over their
``anisotropy`` ranges (ε ≥ δ in every layer: the system is stable there).
The tilt varies smoothly: ``theta`` a ramp along axis 2 and ``phi`` a ramp
along axis 1 over their ``tilt`` ranges, so that each of the six terms of
``Hz`` is nonzero at the source.  Within the wave's reach below the
source the seed places a lens (``anomaly``): a smooth bump of ``radius``
cells, zero outside it, that adds its amplitudes to ``theta``, ``phi``,
``epsilon`` and ``delta`` and scales ``vp`` by its own (ε − δ grows in it
and the horizontal speed stays under its layer's), its centre ``depth``
cells below the source and up to ``lateral`` cells aside along axes 1 and
2: the shot crosses coefficients that vary, differently for every seed.
``damp`` is the acoustic stencil's PML profile.  ``dt`` gives the
configured Courant number at the fastest horizontal speed,
``vp_bottom·√(1 + 2ε)`` of the bottom layer.

Hooks: the Ricker source sits ``wavelet.depth_below_pml`` cells below the
top PML at the centre of the surface; ``inject(t)`` adds its sample ``t``
to both newest fields (the program's ``tti.inject_source``), ``record()``
is ``p1``'s plane at the source's depth (the receivers).
"""
from __future__ import annotations

import inspect

import numpy as np

from portbench.reference.acoustic_iso import source_position
from portbench.stencils import Program, full_shape, interior, leapfrog_pairs
from portbench.stencils.acoustic_iso import damping


def layers(cfg, gen, device):
    """Each depth's layer index (``velocity.layers`` layers over the
    interior, their interfaces moved by the seed), on the CPU."""
    import torch
    vel = cfg["velocity"]
    n0, k, w = cfg["shape"][0], vel["layers"], cfg["pml_width"]
    nominal = torch.tensor([w + (n0 - 2 * w) * i / k for i in range(1, k)],
                           dtype=torch.float64)
    j = vel["interface_jitter"]
    shift = torch.randint(-j, j + 1, (k - 1,), generator=gen, device=device).cpu()
    return torch.bucketize(torch.arange(n0), (nominal.round() + shift).long(), right=True)


def ramp(lo, hi, n, ax, device):
    """``lo`` to ``hi`` evenly over ``n`` cells along axis ``ax`` of a 3D
    interior, in f32."""
    import torch
    shape = [1, 1, 1]
    shape[ax] = n
    return torch.linspace(lo, hi, n, dtype=torch.float64).to(torch.float32).reshape(
        shape).to(device)


def lens(cfg, gen, device):
    """The seeded bump ``(1 − (r/R)²)²`` inside radius ``R`` (0 outside) of
    ``anomaly`` over the interior, in f32; ``r`` is the distance from its
    centre, ``depth`` cells below the source and up to ``lateral`` aside."""
    import torch
    an = cfg["anomaly"]
    lo, hi = an["depth"]
    w = an["lateral"]
    aside = torch.randint(-w, w + 1, (2,), generator=gen, device=device).cpu()
    down = torch.randint(lo, hi + 1, (1,), generator=gen, device=device).cpu()
    z, y, x = source_position(cfg)
    centre = (z + int(down[0]), y + int(aside[0]), x + int(aside[1]))
    rr = sum(((torch.arange(n, dtype=torch.float32, device=device) - c) ** 2).reshape(
        [-1 if a == ax else 1 for a in range(3)])
        for ax, (n, c) in enumerate(zip(cfg["shape"], centre))) / float(an["radius"]) ** 2
    return (1.0 - rr).clamp(min=0.0) ** 2


def make_state(cfg, gen, device):
    """(tensors, scalars): zero wavefields, the seeded layered model, the
    tilt ramps, the PML profile, and ``dt``."""
    import torch
    vel, an, tilt = cfg["velocity"], cfg["anisotropy"], cfg["tilt"]
    k = vel["layers"]
    layer = layers(cfg, gen, device)

    def by_layer(lo, hi):
        v = torch.linspace(lo, hi, k, dtype=torch.float64)[layer]
        return v.to(torch.float32).reshape(-1, 1, 1).to(device)
    full = full_shape(cfg)
    n0, n1, n2 = cfg["shape"]
    inner = interior(cfg)

    def grid(values=None):
        g = torch.zeros(full, dtype=torch.float32, device=device)
        if values is not None:
            g[inner] = values
        return g
    bump, amp = lens(cfg, gen, device), cfg["anomaly"]
    vp = by_layer(vel["vp_top"], vel["vp_bottom"]) * (1.0 + amp["vp"] * bump)
    state = {"p0": grid(), "p1": grid(), "r0": grid(), "r1": grid(),
             "vp2": grid(vp * vp),
             "epsilon": grid(by_layer(an["epsilon_top"], an["epsilon_bottom"])
                             + amp["epsilon"] * bump),
             "delta": grid(by_layer(an["delta_top"], an["delta_bottom"])
                           + amp["delta"] * bump),
             "theta": grid(ramp(tilt["theta_from"], tilt["theta_to"], n2, 2, device)
                           + amp["theta"] * bump),
             "phi": grid(ramp(tilt["phi_from"], tilt["phi_to"], n1, 1, device)
                         + amp["phi"] * bump),
             "damp": grid(damping(cfg, device))}
    eps_max = max(an["epsilon_top"], an["epsilon_bottom"])
    dt = float(np.float32(cfg["courant"] / (vel["vp_bottom"] * np.sqrt(1.0 + 2.0 * eps_max))))
    return state, {"dt": dt}


def kernel():
    """The program's DSL kernel: ``core/tti.py``'s."""
    from repro_torch.core import tti
    return tti.tti_kernel


def bind(cfg, tensors, scalars, dtype="f32"):
    """The program's kernel, grids and hooks on ``tensors`` (cast to
    ``dtype``).  The program's source has a fixed wavelet: a configuration
    with another one is refused."""
    from repro_torch.core import acoustic, tti
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
    p1, r1 = grids["p1"], grids["r1"]
    return Program(
        kernel=k, grids=grids,
        args=[grids[n] for n in k.ir.grid_params] + [np.float32(scalars["dt"])],
        pairs=leapfrog_pairs(cfg["swap"]),
        inject=lambda t: tti.inject_source(p1, r1, t, pos=pos, amp=wv["amp"]),
        record=lambda: p1.interior[pos[0]])
