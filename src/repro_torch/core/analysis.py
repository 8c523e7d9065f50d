"""Static analyses over StencilIR (paper §4.4 "analysis phase").

Infers the domain parameters of paper Table 3 that are "Inferred by kernel
definition": stencil order (halo width per axis), stencil shape
(point / star / box / compact), FLOPs per point, bytes moved per point, and
arithmetic intensity — the quantities the template selector and the roofline
model consume.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from . import ir


@dataclasses.dataclass(frozen=True)
class StencilInfo:
    name: str
    ndim: int
    shape: str                         # 'point' | 'star' | 'box'
    order: int                         # max halo width over axes
    halo: Tuple[int, ...]              # per-axis halo width (max over grids)
    halo_per_grid: Dict[str, Tuple[int, ...]]
    n_taps: int                        # distinct taps
    flops_per_point: int               # adds+muls+divs per output point
    reads_per_point: int               # grid reads per output point
    writes_per_point: int
    input_grids: Tuple[str, ...]
    output_grids: Tuple[str, ...]

    @property
    def bytes_per_point_f32(self) -> int:
        # cold-cache model: each distinct tap is a 4-byte read, each update a
        # 4-byte write (perfect-cache lower bound reads each grid cell once).
        return 4 * (len(self.input_grids) + self.writes_per_point)

    @property
    def arithmetic_intensity_f32(self) -> float:
        return self.flops_per_point / max(self.bytes_per_point_f32, 1)


def _count_flops(e: ir.Expr) -> int:
    if isinstance(e, ir.BinOp):
        return 1 + _count_flops(e.lhs) + _count_flops(e.rhs)
    if isinstance(e, ir.Neg):
        return 1 + _count_flops(e.operand)
    if isinstance(e, ir.Call):
        return 1 + sum(_count_flops(a) for a in e.args)
    return 0


class NotLinearError(ValueError):
    """Raised when a kernel is not an affine combination of taps (the
    Semi-stencil template requires linearity — paper §3 'certain high-order
    stencils')."""


def inline_locals(k: ir.StencilIR):
    """Return the Assign statements with LocalRefs substituted away."""
    env = {}

    def sub(e: ir.Expr) -> ir.Expr:
        if isinstance(e, ir.LocalRef):
            return env[e.name]
        if isinstance(e, ir.BinOp):
            return ir.BinOp(e.op, sub(e.lhs), sub(e.rhs))
        if isinstance(e, ir.Neg):
            return ir.Neg(sub(e.operand))
        if isinstance(e, ir.Call):
            return ir.Call(e.fn, tuple(sub(a) for a in e.args))
        return e

    out = []
    for stmt in k.body:
        if isinstance(stmt, ir.LocalDef):
            env[stmt.name] = sub(stmt.expr)
        else:
            out.append(ir.Assign(stmt.grid, stmt.offsets, sub(stmt.expr)))
    return tuple(out)


def _tapfree(e: ir.Expr) -> bool:
    if isinstance(e, ir.Tap):
        return False
    if isinstance(e, ir.BinOp):
        return _tapfree(e.lhs) and _tapfree(e.rhs)
    if isinstance(e, ir.Neg):
        return _tapfree(e.operand)
    if isinstance(e, ir.Call):
        return all(_tapfree(a) for a in e.args)
    return True


def _center_fieldlike(e: ir.Expr) -> bool:
    """True if every tap in ``e`` is a center tap (all offsets zero) —
    such subtrees act as per-point *coefficient fields* (e.g. vp² in the
    acoustic-ISO update) and are admissible semi-stencil coefficients."""
    if isinstance(e, ir.Tap):
        return not any(e.offsets)
    if isinstance(e, ir.BinOp):
        return _center_fieldlike(e.lhs) and _center_fieldlike(e.rhs)
    if isinstance(e, ir.Neg):
        return _center_fieldlike(e.operand)
    if isinstance(e, ir.Call):
        return all(_center_fieldlike(a) for a in e.args)
    return True


def linearize(e: ir.Expr, allow_center_fields: bool = False):
    """Decompose ``e`` into ``Σ coeff_i * tap_i + const``.

    Returns ``(terms, const)`` where terms maps ``(grid, offsets)`` to a
    coefficient Expr and ``const`` is a coefficient-class Expr.  With
    ``allow_center_fields`` the coefficient class is "center-only taps
    allowed" (evaluated per output point by the backend); otherwise it is
    strictly tap-free.  Raises ``NotLinearError`` for products/divisions of
    non-coefficient tap-bearing subtrees.
    """
    ok_coeff = _center_fieldlike if allow_center_fields else _tapfree
    C0, C1 = ir.Const(0.0), ir.Const(1.0)

    def add(a, b):
        if a == C0:
            return b
        if b == C0:
            return a
        return ir.BinOp("+", a, b)

    def mul(a, b):
        if a == C0 or b == C0:
            return C0
        if a == C1:
            return b
        if b == C1:
            return a
        return ir.BinOp("*", a, b)

    def rec(e):
        if isinstance(e, ir.Tap):
            if allow_center_fields and not any(e.offsets):
                return {}, e  # center tap = coefficient field → const part
            return {(e.grid, e.offsets): C1}, C0
        if ok_coeff(e):
            return {}, e
        if isinstance(e, ir.Neg):
            t, c = rec(e.operand)
            return ({k: ir.Neg(v) for k, v in t.items()}, ir.Neg(c))
        if isinstance(e, ir.BinOp):
            if e.op in ("+", "-"):
                lt, lc = rec(e.lhs)
                rt, rc = rec(e.rhs)
                if e.op == "-":
                    rt = {k: ir.Neg(v) for k, v in rt.items()}
                    rc = ir.Neg(rc)
                out = dict(lt)
                for k, v in rt.items():
                    out[k] = add(out[k], v) if k in out else v
                return out, add(lc, rc)
            if e.op == "*":
                if ok_coeff(e.lhs):
                    t, c = rec(e.rhs)
                    return ({k: mul(e.lhs, v) for k, v in t.items()},
                            mul(e.lhs, c))
                if ok_coeff(e.rhs):
                    t, c = rec(e.lhs)
                    return ({k: mul(e.rhs, v) for k, v in t.items()},
                            mul(e.rhs, c))
                raise NotLinearError("product of tap-bearing expressions")
            if e.op == "/" and ok_coeff(e.rhs):
                t, c = rec(e.lhs)
                return ({k: ir.BinOp("/", v, e.rhs) for k, v in t.items()},
                        ir.BinOp("/", c, e.rhs))
            raise NotLinearError(f"non-linear op {e.op}")
        raise NotLinearError(f"non-linear node {type(e).__name__}")

    return rec(e)


def check_read_after_write(k: ir.StencilIR) -> None:
    """Reject non-center taps of grids written by earlier statements —
    such reads would need a global sync between statements and are not a
    stencil (the map over points must stay parallel)."""
    written = set()
    for stmt in k.body:
        def _taps(e):
            return (x for x in _walk_one(e) if isinstance(x, ir.Tap))
        for t in _taps(stmt.expr):
            if t.grid in written and any(o != 0 for o in t.offsets):
                raise ValueError(
                    f"kernel {k.name}: non-center read of '{t.grid}' after "
                    "it was written in an earlier statement")
        if isinstance(stmt, ir.Assign):
            written.add(stmt.grid)


def _walk_one(e):
    yield e
    if isinstance(e, ir.BinOp):
        yield from _walk_one(e.lhs)
        yield from _walk_one(e.rhs)
    elif isinstance(e, ir.Neg):
        yield from _walk_one(e.operand)
    elif isinstance(e, ir.Call):
        for a in e.args:
            yield from _walk_one(a)


def analyze(k: ir.StencilIR) -> StencilInfo:
    taps = k.taps()
    ndim = k.ndim

    halo_per_grid: Dict[str, list] = {}
    for t in taps:
        h = halo_per_grid.setdefault(t.grid, [0] * ndim)
        for ax, off in enumerate(t.offsets):
            h[ax] = max(h[ax], abs(off))
    halo = tuple(
        max((h[ax] for h in halo_per_grid.values()), default=0)
        for ax in range(ndim)
    )
    order = max(halo) if halo else 0

    # shape classification: star = every tap is on an axis (≤1 nonzero
    # offset component); box otherwise; point if no nonzero offsets.
    distinct = {(t.grid, t.offsets) for t in taps}
    nonzero = [offs for _, offs in distinct if any(o != 0 for o in offs)]
    if not nonzero:
        shape = "point"
    elif all(sum(1 for o in offs if o != 0) <= 1 for offs in nonzero):
        shape = "star"
    else:
        shape = "box"

    flops = 0
    writes = 0
    for stmt in k.body:
        flops += _count_flops(stmt.expr)
        if isinstance(stmt, ir.Assign):
            writes += 1

    return StencilInfo(
        name=k.name,
        ndim=ndim,
        shape=shape,
        order=order,
        halo=halo,
        halo_per_grid={g: tuple(h) for g, h in halo_per_grid.items()},
        n_taps=len(distinct),
        flops_per_point=flops,
        reads_per_point=len(taps),
        writes_per_point=writes,
        input_grids=k.input_grids(),
        output_grids=k.output_grids(),
    )
