"""Plain PyTorch pseudo-acoustic TTI in the self-adjoint form of Zhang,
Zhang and Zhang 2011, as Devito's ``examples/seismic/tti`` centred kernel
discretizes it (``Gzz_centered``: the transpose of rotated first
derivatives of half the scheme's order, the tilt's cosines between the
passes), each sum in the order of the program's kernel text, so that f32
rounding follows it step for step.

Axis 0 is depth (z), axis 1 y, axis 2 x; the symmetry axis ``n = (c, b,
a)`` along (z, y, x), ``a = sinθ cosφ``, ``b = sinθ sinφ``, ``c = cosθ``,
each at its own cell; ``D_k`` the 4th-order centred first derivative along
axis ``k`` (weights ``FIRST``) and ``∇²`` the 8th-order Laplacian;

    G f = Σ_j n_j D_j f,   Hz f = Σ_k D_k(n_k · G f),   H0 = ∇² − Hz,
    p0 = (2·p1 − (1 − η)·p0 + vp2·dt²·((1+2ε)·H0 p1 + √(1+2δ)·Hz r1)) / (1 + η),
    r0 = (2·r1 − (1 − η)·r0 + vp2·dt²·(√(1+2δ)·H0 p1 + Hz r1)) / (1 + η),

with η = damp·dt.  ``G f`` is worked out once over the interior widened
by 2 cells on every side, which is the program's arithmetic cell by cell
(it works ``G f`` out at each of the 12 cells that the outer ``D_k``
reads).  Departures from the published description, all of them the
program's: (1) the depth cosine is ``+c`` (Devito's ``Gzz_centered``
takes ``−c``: the tilt measured the other way); (2) the PML is the
unified damping coefficient η folded into the leapfrog update, not a
split PML; (3) the Ricker sample is added to both ``p1`` and ``r1`` at the
source point, as Devito's TTI injects into both fields.  The receivers'
plane is ``p1``'s at the source's depth."""
from __future__ import annotations

import torch

from portbench.reference.acoustic_iso import source_position, wavelet

# the 8th-order second-derivative weights of ring 0..4 and the 4th-order
# first-derivative weights d_m
SECOND = (-205.0 / 72.0, 8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0, -1.0 / 560.0)
FIRST = {-2: 1.0 / 12.0, -1: -2.0 / 3.0, 1: 2.0 / 3.0, 2: -1.0 / 12.0}
AXES = "zyx"
WIDE = 2            # the reach of FIRST: G f's cells around the interior


def window(a: torch.Tensor, cfg, off=(0, 0, 0), ext=0) -> torch.Tensor:
    """The view of full grid ``a`` whose cell ``i`` is interior cell ``i +
    off − ext``, ``2·ext`` cells longer than the interior along each axis."""
    o = cfg["order"]
    return a[tuple(slice(o + d - ext, o + d + n + ext) for d, n in zip(off, cfg["shape"]))]


def narrow(a: torch.Tensor, cfg, off) -> torch.Tensor:
    """The interior cells shifted by ``off`` of ``a``, a tensor over the
    interior widened by ``WIDE``."""
    return a[tuple(slice(WIDE + d, WIDE + d + n) for d, n in zip(off, cfg["shape"]))]


def offset(ax, d):
    off = [0, 0, 0]
    off[ax] = d
    return tuple(off)


def second(f, ax, cfg, out, pair, tmp) -> None:
    """``∂ii f`` along axis ``ax`` into ``out``: the ring at ±1, the
    centre, then the rings at ±2, ±3, ±4."""
    def at(d):
        return window(f, cfg, offset(ax, d))
    torch.add(at(-1), at(1), out=pair)
    torch.mul(pair, SECOND[1], out=out)
    torch.mul(at(0), abs(SECOND[0]), out=tmp)
    out.sub_(tmp)
    for d in (2, 3, 4):
        torch.add(at(-d), at(d), out=pair)
        pair.mul_(abs(SECOND[d]))
        if SECOND[d] < 0:
            out.sub_(pair)
        else:
            out.add_(pair)


def signed_sum(acc, tmp, terms) -> None:
    """``acc = w0·v0 ± |w1|·v1 ± ...`` for ``[(w, v)]``, left to right, each
    product rounded before its sum (the program's ``w * tap`` then ``+`` or
    ``−``)."""
    (w0, v0), rest = terms[0], terms[1:]
    torch.mul(v0, w0, out=acc)
    for w, v in rest:
        torch.mul(v, abs(w), out=tmp)
        if w < 0:
            acc.sub_(tmp)
        else:
            acc.add_(tmp)


def prepare(state, scalars, cfg):
    """The cosines of the tilt over the widened interior, the coefficients
    of the update, in the program's order, and the buffers of a step.
    TF32 off: every operation here is elementwise f32, and stays so."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = torch.tensor(scalars["dt"], dtype=torch.float32, device=state["p1"].device)
    c = lambda g: window(state[g], cfg)  # noqa: E731
    theta, phi = window(state["theta"], cfg, ext=WIDE), window(state["phi"], cfg, ext=WIDE)
    s = torch.sin(theta)
    n = {"x": s * torch.cos(phi), "y": s * torch.sin(phi), "z": torch.cos(theta)}
    del s
    eta = c("damp") * dt
    coef = {"e2": 1.0 + 2.0 * c("epsilon"), "sd": torch.sqrt(1.0 + 2.0 * c("delta")),
            "keep": 1.0 - eta, "div": 1.0 + eta, "vdt2": c("vp2") * dt * dt}
    del eta

    def empty(like):
        return torch.empty(like.shape, dtype=torch.float32, device=like.device)
    bufs = {k: empty(c("p1")) for k in ("xx", "yy", "zz", "pair", "tmp", "hzp", "h0p", "hzr")}
    bufs.update({k: empty(theta) for k in ("g", "d", "tmp_wide")})
    return {**{f"n{a}": v for a, v in n.items()}, **coef, **bufs}


def hz(f, s, cfg, out) -> None:
    """``Hz f`` into ``out``: ``G f`` over the widened interior (``D_z``,
    ``D_y``, ``D_x`` each by its cosine, summed in that order), then
    ``Σ_k Σ_m d_m · (n_k · G f)`` at the cells ``m·e_k``."""
    g, d, tmp = s["g"], s["d"], s["tmp_wide"]
    for j in range(3):
        signed_sum(d, tmp, [(w, window(f, cfg, offset(j, m), WIDE)) for m, w in FIRST.items()])
        if j == 0:
            torch.mul(s["n" + AXES[j]], d, out=g)
        else:
            torch.mul(s["n" + AXES[j]], d, out=tmp)
            g.add_(tmp)
    prod, lead = s["tmp"], True
    for k in range(3):
        for m, w in FIRST.items():
            off = offset(k, m)
            torch.mul(narrow(s["n" + AXES[k]], cfg, off), narrow(g, cfg, off), out=prod)
            if lead:
                torch.mul(prod, w, out=out)
                lead = False
            else:
                prod.mul_(abs(w))
                if w < 0:
                    out.sub_(prod)
                else:
                    out.add_(prod)


def update(state, s, cfg):
    hz(state["p1"], s, cfg, s["hzp"])
    hz(state["r1"], s, cfg, s["hzr"])
    for ax in range(3):
        second(state["p1"], ax, cfg, s[AXES[ax] * 2], s["pair"], s["tmp"])
    torch.add(s["xx"], s["yy"], out=s["h0p"])
    s["h0p"].add_(s["zz"]).sub_(s["hzp"])
    t1, t2, t3, t4 = s["xx"], s["yy"], s["zz"], s["pair"]
    # p: (2·p1 − keep·p0 + vdt2·(e2·h0p + sd·hzr)) / div
    p0 = window(state["p0"], cfg)
    torch.mul(window(state["p1"], cfg), 2.0, out=t1)
    torch.mul(s["keep"], p0, out=t2)
    t1.sub_(t2)
    torch.mul(s["e2"], s["h0p"], out=t3)
    torch.mul(s["sd"], s["hzr"], out=t4)
    t3.add_(t4).mul_(s["vdt2"])
    t1.add_(t3)
    torch.div(t1, s["div"], out=p0)
    # r: (2·r1 − keep·r0 + vdt2·(sd·h0p + hzr)) / div
    r0 = window(state["r0"], cfg)
    torch.mul(window(state["r1"], cfg), 2.0, out=t1)
    torch.mul(s["keep"], r0, out=t2)
    t1.sub_(t2)
    torch.mul(s["sd"], s["h0p"], out=t3)
    t3.add_(s["hzr"]).mul_(s["vdt2"])
    t1.add_(t3)
    torch.div(t1, s["div"], out=r0)


def inject(state, t, cfg):
    wv = cfg["wavelet"]
    o = cfg["order"]
    z, y, x = source_position(cfg)
    val = wv["amp"] * wavelet(t, wv["f0"], wv["t0"])
    state["p1"][o + z, o + y, o + x] += val
    state["r1"][o + z, o + y, o + x] += val


def record(state, cfg):
    return window(state["p1"], cfg)[source_position(cfg)[0]]
