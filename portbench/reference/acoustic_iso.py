"""Plain PyTorch acoustic ISO (paper §2.2/§6.2), copied from the program's
kernel text: the 8th-order 25-point star Laplacian of ``p1`` and the
damped leapfrog update of ``p0``,

    p0 = (2·p1 − (1 − damp·dt)·p0 + vp2·dt·dt·lap) / (1 + damp·dt),

with the Ricker source (``wavelet``) added to ``p1`` at the source point
and the receivers' plane read from ``p1`` at the source's depth."""
from __future__ import annotations

import math

import torch

from portbench.reference.star3d4r import shifted

CENTER = 3.0 * -2.8472222
RINGS = ((1, 1.6), (2, -0.2), (3, 0.025396825), (4, -0.0017857143))


def wavelet(t: int, f0: float, t0: int) -> float:
    """Ricker wavelet sample at integer time step ``t``."""
    a = (math.pi * f0 * (t - t0)) ** 2
    return (1.0 - 2.0 * a) * math.exp(-a)


def source_position(cfg):
    """(depth, row, column) of the source in interior coordinates: the
    inputs' geometry, which the benchmark hands to the program too."""
    n0, n1, n2 = cfg["shape"]
    return (cfg["pml_width"] + cfg["wavelet"]["depth_below_pml"], n1 // 2, n2 // 2)


def prepare(state, scalars, cfg):
    """The coefficients of the update, from ``damp``, ``vp2`` and ``dt``."""
    dt = torch.tensor(scalars["dt"], dtype=torch.float32)
    c = lambda g: shifted(state[g], (0, 0, 0), cfg)  # noqa: E731
    damp_dt = c("damp") * dt.to(state["damp"].device)
    return {"keep": -(1.0 - damp_dt), "div": 1.0 + damp_dt,
            "vdt2": c("vp2") * dt.item() * dt.item(),
            "lap": torch.empty_like(damp_dt)}


def update(state, scratch, cfg):
    p1 = state["p1"]
    lap = scratch["lap"]
    torch.mul(shifted(p1, (0, 0, 0), cfg), CENTER, out=lap)
    for d, w in RINGS:
        for ax in range(3):
            for sgn in (-1, 1):
                off = [0, 0, 0]
                off[ax] = sgn * d
                lap.add_(shifted(p1, off, cfg), alpha=w)
    p0 = shifted(state["p0"], (0, 0, 0), cfg)
    p0.mul_(scratch["keep"])
    p0.add_(shifted(p1, (0, 0, 0), cfg), alpha=2.0)
    p0.addcmul_(scratch["vdt2"], lap)
    p0.div_(scratch["div"])


def inject(state, t, cfg):
    wv = cfg["wavelet"]
    o = cfg["order"]
    z, y, x = source_position(cfg)
    state["p1"][o + z, o + y, o + x] += wv["amp"] * wavelet(t, wv["f0"], wv["t0"])


def record(state, cfg):
    return shifted(state["p1"], (0, 0, 0), cfg)[source_position(cfg)[0]]
