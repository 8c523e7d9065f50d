"""Plain PyTorch ``star3d4r``: ``v = Σ w · u[shifted]`` over Table 4's 25
taps, the weights the program's suite states (center-heavy, normalized),
copied here to six decimals as the suite writes them."""
from __future__ import annotations

import torch

TAPS = (
    ((0, 0, 0), 0.808096),
    ((-1, 0, 0), 0.010775),
    ((1, 0, 0), 0.008081),
    ((-2, 0, 0), 0.006465),
    ((2, 0, 0), 0.005387),
    ((-3, 0, 0), 0.004618),
    ((3, 0, 0), 0.004040),
    ((-4, 0, 0), 0.016162),
    ((4, 0, 0), 0.010775),
    ((0, -1, 0), 0.008081),
    ((0, 1, 0), 0.006465),
    ((0, -2, 0), 0.005387),
    ((0, 2, 0), 0.004618),
    ((0, -3, 0), 0.004040),
    ((0, 3, 0), 0.016162),
    ((0, -4, 0), 0.010775),
    ((0, 4, 0), 0.008081),
    ((0, 0, -1), 0.006465),
    ((0, 0, 1), 0.005387),
    ((0, 0, -2), 0.004618),
    ((0, 0, 2), 0.004040),
    ((0, 0, -3), 0.016162),
    ((0, 0, 3), 0.010775),
    ((0, 0, -4), 0.008081),
    ((0, 0, 4), 0.006465),
)


def shifted(a: torch.Tensor, off, cfg) -> torch.Tensor:
    """The view of full grid ``a`` whose cell ``i`` is interior cell
    ``i + off``."""
    o = cfg["order"]
    return a[tuple(slice(o + d, o + d + n) for d, n in zip(off, cfg["shape"]))]


def prepare(state, scalars, cfg):
    return {}


def update(state, scratch, cfg):
    u, out = state["u"], shifted(state["v"], (0, 0, 0), cfg)
    (off, w), rest = TAPS[0], TAPS[1:]
    torch.mul(shifted(u, off, cfg), w, out=out)
    for off, w in rest:
        out.add_(shifted(u, off, cfg), alpha=w)
