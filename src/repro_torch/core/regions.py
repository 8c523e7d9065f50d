"""Inner/PML region bookkeeping (paper §2.2, Table 3 'domain decompositions').

Seismic modeling surrounds the computational domain with a Perfectly-Matched
Layer.  The framework decomposes the data domain and launches dedicated
kernels accordingly:

* ``unified``      — one kernel over the whole domain (PML damping folded in
                     as a coefficient field, zero inside).
* ``two_region``   — inner box + the PML shell (returned as disjoint boxes,
                     launched with the same PML kernel).
* ``seven_region`` — 3-D: inner box + 6 face slabs (2-D: 1 + 4 = five
                     regions); each slab is a separate ``st.map`` region.

Regions are ``((begin, end), ...)`` tuples in interior coordinates, directly
usable as ``st.map(begin=..., end=...)`` arguments.  Nothing here mutates.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

Region = Tuple[Tuple[int, int], ...]


def inner_region(shape: Sequence[int], pml_width: int) -> Region:
    """The box inside the PML of width ``pml_width``."""
    return tuple((pml_width, s - pml_width) for s in shape)


def pml_shell(shape: Sequence[int], pml_width: int) -> List[Region]:
    """Disjoint boxes covering the PML shell: 2·ndim slabs (the 'seven
    region' decomposition for 3-D: inner + these 6)."""
    nd = len(shape)
    w = pml_width
    out: List[Region] = []
    for ax in range(nd):
        # axes before `ax` restricted to the inner extent → disjointness
        lo, hi = [], []
        for a in range(nd):
            if a < ax:
                lo.append((w, shape[a] - w))
                hi.append((w, shape[a] - w))
            elif a == ax:
                lo.append((0, w))
                hi.append((shape[a] - w, shape[a]))
            else:
                lo.append((0, shape[a]))
                hi.append((0, shape[a]))
        out.append(tuple(lo))
        out.append(tuple(hi))
    return out


def two_region(shape: Sequence[int], pml_width: int):
    """(inner box, PML shell boxes)."""
    return inner_region(shape, pml_width), pml_shell(shape, pml_width)


def seven_region(shape: Sequence[int], pml_width: int):
    """[inner box] + the 2·ndim PML face slabs."""
    inner = inner_region(shape, pml_width)
    return [inner] + pml_shell(shape, pml_width)


def damping_mask(shape: Sequence[int], pml_width: int,
                 strength: float = 0.1, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """Quadratic PML damping coefficient field (zero in the inner region) —
    the 'unified' form.  Computed in numpy f32 exactly as the JAX package
    does, then moved to ``device`` (None: the CPU)."""
    nd = len(shape)
    w = max(pml_width, 1)
    total = np.zeros(shape, np.float32)
    for ax in range(nd):
        n = shape[ax]
        x = np.arange(n, dtype=np.float32)
        d = np.maximum(w - x, 0) + np.maximum(x - (n - 1 - w), 0)
        prof = strength * (d / w) ** 2
        shp = [1] * nd
        shp[ax] = n
        total = total + prof.reshape(shp)
    return torch.as_tensor(total, dtype=dtype, device=device)
