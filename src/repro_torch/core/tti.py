"""Pseudo-acoustic TTI (tilted transverse isotropy) as a StencilPy
application: two coupled wavefields ``p`` and ``r`` in the self-adjoint
form of Zhang, Zhang and Zhang 2011 ("A stable TTI reverse time migration
and its implementation", Geophysics 76(3) WA3), as Devito's
``examples/seismic/tti`` centred kernel discretizes it; the propagator of
reverse-time migration and FWI on anisotropic models.

Axis 0 is depth (z), axis 1 is y and axis 2 is x.  The symmetry axis has
direction cosines ``n = (c, b, a)`` along (z, y, x), ``a = sinθ cosφ``,
``b = sinθ sinφ``, ``c = cosθ``, read at each point, and

    Hz f = Σ_k D_k(n_k · G f),   G f = Σ_j n_j D_j f,   H0 = ∇² − Hz,
    p_tt = vp²[(1+2ε) H0 p + √(1+2δ) Hz r],
    r_tt = vp²[√(1+2δ) H0 p + Hz r].

``D_k`` is the 4th-order centred first derivative along axis ``k``
(``FIRST``: weights at ±1 and ±2, each with its own sign; half the
scheme's order, as Devito's ``order // 2``), so that ``Hz = −Gᵀ G`` with
the tilt's cosines between its two passes: ``Hz`` and ``H0`` are symmetric
and negative semidefinite at any tilt, and the system is stable where
ε ≥ δ.  Where the tilt is constant ``Hz`` is ``a²∂xx + b²∂yy + c²∂zz +
2ab∂xy + 2ac∂xz + 2bc∂yz``.  (Devito's ``Gzz_centered`` takes ``−c`` for
the depth cosine: its tilt is measured the other way.)  ``∇²`` is the
acoustic kernel's 8th-order Laplacian (``acoustic.C0`` .. ``C4``).
``G f`` is worked out at each of the 12 cells ``x + m·e_k`` (m = ±1, ±2)
that the outer ``D_k`` reads, from the tilt there: 73 distinct taps of
each field (25 on the axes, 16 in each coordinate plane), 146 a point,
and ``θ``, ``φ`` at the 12 cells.  The leapfrog update with damping
``η = damp·dt`` (the unified PML as a coefficient, as in ``acoustic``):

    p0 ← (2·p1 − (1−η)·p0 + vp2·dt²·[(1+2ε)·H0 p1 + √(1+2δ)·Hz r1]) / (1+η)
    r0 ← (2·r1 − (1−η)·r0 + vp2·dt²·[√(1+2δ)·H0 p1 + Hz r1]) / (1+η)

``p0`` and ``r0`` are read only at the centre, so ``st.map`` writes both
in place.  The kernel's text is generated (``kernel_source``), each sum in
the order written above and the terms of each ``D`` and of ``Hz`` in
``FIRST``'s order of offsets; the cosines at each cell and the anisotropy
coefficients are locals, so ``Kernel.info`` counts each once.  The source
adds the Ricker sample to both fields, as Devito's TTI injects into both.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import numpy as np

from . import acoustic
from . import dsl as st
from . import regions
from . import trace as _trace

ORDER = acoustic.ORDER
# 4th-order first-derivative weights d_m, each with its own sign
FIRST: Dict[int, float] = {-2: 1.0 / 12.0, -1: -2.0 / 3.0, 1: 2.0 / 3.0, 2: -1.0 / 12.0}
SECOND = (acoustic.C0, acoustic.C1, acoustic.C2, acoustic.C3, acoustic.C4)
AXES = "zyx"
GRIDS = ("p0", "p1", "r0", "r1", "vp2", "epsilon", "delta", "theta", "phi", "damp")


def _offset(ax: int, d: int, base=(0, 0, 0)) -> Tuple[int, int, int]:
    off = list(base)
    off[ax] += d
    return tuple(off)


def _tap(f: str, off) -> str:
    return f"{f}.at({off[0]}, {off[1]}, {off[2]})"


def _signed_sum(terms) -> str:
    """``w0 * e0 ± |w1| * e1 ± ...`` for ``[(w, e)]``: each product added
    or subtracted by the sign of its weight, left to right."""
    (w0, e0), rest = terms[0], terms[1:]
    out = f"{w0!r} * {e0}"
    for w, e in rest:
        out += f" {'-' if w < 0 else '+'} {abs(w)!r} * {e}"
    return out


def second(f: str, ax: int) -> str:
    """``∂ii f`` along axis ``ax``: the ring at ±1, then the centre, then
    the rings at ±2, ±3, ±4 (a leading negative weight would be a counted
    negation: ``C0`` comes second)."""
    def at(d):
        return _tap(f, _offset(ax, d))
    terms = [(SECOND[1], f"({at(-1)} + {at(1)})"), (SECOND[0], at(0))]
    terms += [(SECOND[d], f"({at(-d)} + {at(d)})") for d in (2, 3, 4)]
    return _signed_sum(terms)


def first(f: str, ax: int, base) -> str:
    """``D_ax f`` at the cell ``base``: ``Σ_m d_m f(base + m·e_ax)``."""
    return _signed_sum([(w, _tap(f, _offset(ax, m, base))) for m, w in FIRST.items()])


def cells():
    """The cells ``(k, m, name)`` where ``G f`` is worked out, axis by axis
    and in ``FIRST``'s order (``zm2``: two cells up, ``xp1``: one along x)."""
    return [(k, m, f"{AXES[k]}{'m' if m < 0 else 'p'}{abs(m)}")
            for k in range(3) for m in FIRST]


def kernel_source() -> str:
    """The DSL text of ``tti_kernel``."""
    lines = [
        "def tti_kernel(p0: st.grid, p1: st.grid, r0: st.grid, r1: st.grid, vp2: st.grid,",
        "               epsilon: st.grid, delta: st.grid, theta: st.grid, phi: st.grid,",
        "               damp: st.grid, dt: st.f32):",
    ]
    for k, m, q in cells():
        th, ph = _tap("theta", _offset(k, m)), _tap("phi", _offset(k, m))
        lines += [f"    s_{q} = sin({th})",
                  f"    nx_{q} = s_{q} * cos({ph})",
                  f"    ny_{q} = s_{q} * sin({ph})",
                  f"    nz_{q} = cos({th})"]
    lines += [
        "    e2 = 1.0 + 2.0 * epsilon.at(0, 0, 0)",
        "    sd = sqrt(1.0 + 2.0 * delta.at(0, 0, 0))",
        "    eta = damp.at(0, 0, 0) * dt",
        "    keep = 1.0 - eta",
        "    div = 1.0 + eta",
        "    vdt2 = vp2.at(0, 0, 0) * dt * dt",
    ]
    for f in ("p", "r"):
        for k, m, q in cells():
            lines.append(f"    g{f}_{q} = " + " + ".join(
                f"n{AXES[j]}_{q} * ({first(f + '1', j, _offset(k, m))})" for j in range(3)))
        lines.append(f"    hz{f} = " + _signed_sum(
            [(FIRST[m], f"(n{AXES[k]}_{q} * g{f}_{q})") for k, m, q in cells()]))
    lines += [f"    p{AXES[ax] * 2} = {second('p1', ax)}" for ax in range(3)]
    lines += [
        "    h0p = pxx + pyy + pzz - hzp",
        "    p0.at(0, 0, 0).set((2.0 * p1.at(0, 0, 0) - keep * p0.at(0, 0, 0)"
        " + vdt2 * (e2 * h0p + sd * hzr)) / div)",
        "    r0.at(0, 0, 0).set((2.0 * r1.at(0, 0, 0) - keep * r0.at(0, 0, 0)"
        " + vdt2 * (sd * h0p + hzr)) / div)",
    ]
    return "\n".join(lines) + "\n"


def make_kernel() -> st.Kernel:
    """``tti_kernel`` parsed from ``kernel_source()``."""
    src = kernel_source()
    ns: Dict = {"st": st}
    exec(compile(src, "<tti_kernel>", "exec"), ns)  # noqa: S102
    fn = ns["tti_kernel"]
    fn.__stencil_source__ = src
    return st.kernel(fn)


tti_kernel = make_kernel()


def make_fields(shape: Tuple[int, int, int], pml_width: int = 10,
                vp: float = 1.5, epsilon: float = 0.2, delta: float = 0.1,
                theta: float = 0.4, phi: float = 0.6, dt: float = 0.25, device=None):
    """Build (p0, p1, r0, r1, vp2, epsilon, delta, theta, phi, damp) grids
    of ``shape`` interior points on ``device`` (None: the card), plus
    ``dt`` as f32: zero wavefields, a homogeneous model and the PML
    profile of strength 0.2, as ``acoustic.make_fields``.  The default
    ``dt`` is stable for these defaults (Courant ≈ 0.44 at the horizontal
    speed vp·√(1+2ε))."""
    dev = st.resolve_device(device)

    def g(value=None):
        out = st.grid(dtype=st.f32, shape=shape, order=ORDER, device=dev)
        if value is not None:
            out.interior = np.full(tuple(shape), value, np.float32)
        return out
    damp = g()
    damp.interior = regions.damping_mask(shape, pml_width, strength=0.2)
    return (g(), g(), g(), g(), g(vp * vp), g(epsilon), g(delta), g(theta), g(phi),
            damp, np.float32(dt))


def inject_source(p: st.grid, r: st.grid, t: int,
                  pos: Union[None, Tuple[int, ...], Sequence[Tuple[int, ...]]] = None,
                  amp: float = 1.0) -> None:
    """Add the Ricker sample ``t`` (``acoustic.source_wavelet``) to both
    fields at the source point (default: the centre), in place, inside one
    ``rt.inject_source`` span; positions as ``acoustic.inject_source``."""
    with _trace.span("rt.inject_source"):
        val = amp * acoustic.source_wavelet(t)
        acoustic.add_sample(p, val, pos)
        acoustic.add_sample(r, val, pos)
