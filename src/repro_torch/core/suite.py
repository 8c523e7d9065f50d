"""Paper Table 4 kernel suite: star/box × 2D/3D × order 1..4 + Jacobi kernels.

Kernels are synthesized as DSL *source text* with literal coefficients and
run through the real ``@st.kernel`` frontend — so the suite exercises the
parser/analysis path exactly like hand-written code, while staying compact.
Coefficients are deterministic (AN5D-style distinct per tap, normalized so
iterated application stays bounded).  The source text is the JAX package's,
character for character, so both frontends parse the same kernels.
Nothing here mutates a grid after ``make_grids`` fills it.
"""
from __future__ import annotations

import itertools
from typing import Dict, Tuple

from . import dsl as st

__all__ = ["get_kernel", "KERNEL_NAMES", "kernel_meta", "make_grids",
           "swap_pair"]


def _fmt(x: float) -> str:
    return f"{x:.6f}"


def _star_source(name: str, ndim: int, r: int) -> str:
    taps = [((0,) * ndim)]
    for ax, d in itertools.product(range(ndim), range(1, r + 1)):
        for sgn in (-1, 1):
            off = [0] * ndim
            off[ax] = sgn * d
            taps.append(tuple(off))
    return _source_from_taps(name, ndim, taps)


def _box_source(name: str, ndim: int, r: int) -> str:
    taps = list(itertools.product(range(-r, r + 1), repeat=ndim))
    return _source_from_taps(name, ndim, taps)


def _source_from_taps(name: str, ndim: int, taps) -> str:
    n = len(taps)
    # center-heavy normalized weights: w_i = a_i / sum(a), a_center = n
    raw = []
    for i, off in enumerate(taps):
        raw.append(float(n) if not any(off) else 1.0 / (2.0 + (i % 7)))
    s = sum(raw)
    terms = []
    for off, a in zip(taps, raw):
        offs = ", ".join(str(o) for o in off)
        terms.append(f"{_fmt(a / s)} * u.at({offs})")
    body = "\n        + ".join(terms)
    params = "u: st.grid, v: st.grid"
    center = ", ".join("0" for _ in range(ndim))
    return (
        f"def {name}({params}):\n"
        f"    v.at({center}).set({body})\n"
    )


_JACOBI = {
    # name: (ndim, source)
    "j2d5pt": (2, """
def j2d5pt(u: st.grid, v: st.grid):
    v.at(0, 0).set(0.20 * (u.at(0, 0) + u.at(-1, 0) + u.at(1, 0)
                   + u.at(0, -1) + u.at(0, 1)))
"""),
    "j2d9pt": (2, """
def j2d9pt(u: st.grid, v: st.grid):
    v.at(0, 0).set(0.2 * u.at(0, 0)
                   + 0.1 * (u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1))
                   + 0.1 * (u.at(-2, 0) + u.at(2, 0) + u.at(0, -2) + u.at(0, 2)))
"""),
    "j2d9pt_gol": (2, """
def j2d9pt_gol(u: st.grid, v: st.grid):
    v.at(0, 0).set(0.2 * u.at(0, 0)
                   + 0.1 * (u.at(-1, -1) + u.at(-1, 0) + u.at(-1, 1)
                   + u.at(0, -1) + u.at(0, 1)
                   + u.at(1, -1) + u.at(1, 0) + u.at(1, 1)))
"""),
    "j3d27pt": (3, """
def j3d27pt(u: st.grid, v: st.grid):
    v.at(0, 0, 0).set(0.5 * u.at(0, 0, 0)
        + 0.02 * (u.at(-1, -1, -1) + u.at(-1, -1, 0) + u.at(-1, -1, 1)
        + u.at(-1, 0, -1) + u.at(-1, 0, 0) + u.at(-1, 0, 1)
        + u.at(-1, 1, -1) + u.at(-1, 1, 0) + u.at(-1, 1, 1)
        + u.at(0, -1, -1) + u.at(0, -1, 0) + u.at(0, -1, 1)
        + u.at(0, 0, -1) + u.at(0, 0, 1)
        + u.at(0, 1, -1) + u.at(0, 1, 0) + u.at(0, 1, 1)
        + u.at(1, -1, -1) + u.at(1, -1, 0) + u.at(1, -1, 1)
        + u.at(1, 0, -1) + u.at(1, 0, 0) + u.at(1, 0, 1)
        + u.at(1, 1, -1) + u.at(1, 1, 0) + u.at(1, 1, 1)))
"""),
}


def _make(name: str) -> st.Kernel:
    if name in _JACOBI:
        src = _JACOBI[name][1]
    elif name.startswith("star"):
        ndim, r = int(name[4]), int(name[6])
        src = _star_source(name, ndim, r)
    elif name.startswith("box"):
        ndim, r = int(name[3]), int(name[5])
        src = _box_source(name, ndim, r)
    else:
        raise KeyError(name)
    ns: Dict = {"st": st}
    exec(compile(src, f"<suite:{name}>", "exec"), ns)  # noqa: S102
    fn = ns[name]
    fn.__stencil_source__ = src
    return st.kernel(fn)


KERNEL_NAMES: Tuple[str, ...] = tuple(
    [f"star{d}d{r}r" for d in (2, 3) for r in (1, 2, 3, 4)]
    + [f"box{d}d{r}r" for d in (2, 3) for r in (1, 2, 3, 4)]
    + list(_JACOBI)
)

_CACHE: Dict[str, st.Kernel] = {}


def get_kernel(name: str) -> st.Kernel:
    """The parsed suite kernel ``name`` (cached)."""
    if name not in _CACHE:
        _CACHE[name] = _make(name)
    return _CACHE[name]


def kernel_meta(name: str):
    """(ndim, shape, order) for reporting (paper Table 4 columns)."""
    k = get_kernel(name)
    return k.info.ndim, k.info.shape, k.info.order


def make_grids(name: str, shape: Tuple[int, ...] = None,
               seed: int = 0, device=None) -> Dict[str, st.grid]:
    """Ready-to-launch grids for a suite kernel (randomized interiors,
    zero halos), keyed by the kernel's grid-parameter names, on ``device``
    (None: the card) — bit-identical to the JAX package's grids."""
    k = get_kernel(name)
    if shape is None:
        if k.info.ndim == 2:
            shape = (64, 64)
        elif k.info.order <= 2:
            shape = (16, 16, 32)
        else:
            # high-order 3D kernels (e.g. the paper's 25-point star3d4r)
            # need extents that admit in-kernel temporal blocking up to
            # k=4: the k·h expanded halo (16 cells at order 4) must fit
            # the block on every axis
            shape = (32, 32, 64)
    return {g: st.grid(dtype=st.f32, shape=shape, order=k.info.order,
                       device=device).randomize(seed + i)
            for i, g in enumerate(k.ir.grid_params)}


def swap_pair(name: str) -> Tuple[str, str]:
    """The (written, read) leapfrog buffer pair of a suite kernel —
    every suite kernel is ``u → v``, so this is ``("v", "u")``."""
    k = get_kernel(name)
    return (k.ir.output_grids()[0], k.ir.input_grids()[0])
