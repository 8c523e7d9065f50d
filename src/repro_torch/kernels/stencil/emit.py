"""StencilIR → the CUDA C++ point function the hand-written kernels call.

Only the per-point expression is generated; the kernels' structure (thread
mapping, plane ring, masking, launch) lives in ``csrc/*.cuh``.  The emitted
function is

    template <class Rd>
    __host__ __device__ inline void stencil_point(const Rd& rd,
                                                  const float* s, float* out)

where ``rd.template at<G>(dx, dy, dz)`` reads operand grid ``G`` at a tap
offset (2D kernels map ``(dx, dy)`` to ``(dx, 0, dy)``: see
``CudaPlan``), ``s`` holds the f32 scalars in signature order and
``out[o]`` receives the new value of output grid ``o``.  K1, K2, K3 and
K4 call it, each with its own reader; K4's f4 template reads whole tap
rows instead, as ``rd.template at<r, dz>()`` (``f4_functions``).

The semi-stencil kernel K5 calls the scatter ``semi_scatter<O, D>(rd, s,
acc)`` instead.  Each term's coefficient is split into a number κ and a
residual φ (``split_coefficient``), and the terms of an output are grouped
by φ (``semi_plan``): the scatter adds, term by term in the order
``semi_linearize`` gives, ``κ`` times the input plane's tap
``rd.template tap<G>(dy, dz)`` of each axis-0 offset ``D`` term of output
``O`` to its group's partial sum ``acc[g]``; ``semi_finish<O>(rd, s,
acc)`` turns the group sums of the emitted plane into its value,
``Σ_g φ_g · acc[g] + const``, reading each coefficient field once at that
plane (``rd.template cf<G>(RT_H)``).

The grids' element type (``RT_ELEM``: ``float`` or ``__nv_bfloat16``) is
part of the header; the generated code sees f32 values either way.

Statement semantics follow the JAX package's ``_exec_statements``: a
``LocalDef`` becomes a ``const`` local; a center read of a grid written by
an earlier statement returns the new value.  Arithmetic is f32 throughout:
constant subtrees fold in Python double precision exactly as ``eval_expr``
folds them, and reach the code as f32 literals; math calls use the f32
functions (``expf``, ``powf``, ``fminf``...), so nothing is promoted to
double.  Nothing here mutates.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import ir

_CALLS = {"exp": "expf", "sqrt": "sqrtf", "abs": "fabsf", "sin": "sinf",
          "cos": "cosf", "tanh": "tanhf", "min": "fminf", "max": "fmaxf"}


def f32_literal(v: float) -> str:
    """An exact f32 literal: the shortest decimal that reads back as the
    f32 rounding of ``v``, with the ``f`` suffix."""
    x = np.float32(v)
    if not np.isfinite(x):
        raise ValueError(f"constant {v!r} is not finite in f32")
    s = np.format_float_scientific(x, unique=True, trim="0")
    return f"{s}f"


def offsets3(offs: Sequence[int]) -> Tuple[int, int, int]:
    """Tap offsets in the kernels' 3D form: 2D ``(a, b)`` → ``(a, 0, b)``."""
    offs = tuple(int(o) for o in offs)
    if len(offs) == 3:
        return offs
    if len(offs) == 2:
        return (offs[0], 0, offs[1])
    raise ValueError("the hopper kernels take 2D and 3D stencils")


class _Emitter:
    def __init__(self, kernel: ir.StencilIR, opnd_grids: Sequence[str],
                 tap=None):
        self.kernel = kernel
        self.tap = tap          # C source of a Tap, when not the default
        self.gidx = {g: i for i, g in enumerate(opnd_grids)}
        self.sidx = {n: i for i, (n, _) in enumerate(kernel.scalar_params)}
        self.lines: List[str] = []
        self.locals: Dict[str, object] = {}
        self.written: Dict[str, str] = {}
        self.n_tmp = 0

    # an expression is either a Python float (constant) or C source (str)
    def expr(self, e: ir.Expr):
        if isinstance(e, ir.Const):
            return float(e.value)
        if isinstance(e, ir.ScalarRef):
            return f"s[{self.sidx[e.name]}]"
        if isinstance(e, ir.LocalRef):
            return self.locals[e.name]
        if isinstance(e, ir.Tap):
            if e.grid in self.written and not any(e.offsets):
                return self.written[e.grid]
            if self.tap is not None:
                return self.tap(e)
            dx, dy, dz = offsets3(e.offsets)
            return f"rd.template at<{self.gidx[e.grid]}>({dx}, {dy}, {dz})"
        if isinstance(e, ir.Neg):
            v = self.expr(e.operand)
            return -v if isinstance(v, float) else f"(-{v})"
        if isinstance(e, ir.BinOp):
            l, r = self.expr(e.lhs), self.expr(e.rhs)
            if isinstance(l, float) and isinstance(r, float):
                return {"+": l + r, "-": l - r, "*": l * r, "/": l / r,
                        "**": l ** r}[e.op]
            l, r = self.c(l), self.c(r)
            if e.op == "**":
                return f"powf({l}, {r})"
            if e.op not in "+-*/":
                raise ValueError(f"bad op {e.op}")
            return f"({l} {e.op} {r})"
        if isinstance(e, ir.Call):
            args = ", ".join(self.c(self.expr(a)) for a in e.args)
            return f"{_CALLS[e.fn]}({args})"
        raise TypeError(f"bad expr {e!r}")

    @staticmethod
    def c(v) -> str:
        return f32_literal(v) if isinstance(v, float) else v

    def body(self, out_grids: Sequence[str]) -> List[str]:
        for stmt in self.kernel.body:
            v = self.expr(stmt.expr)
            if isinstance(stmt, ir.LocalDef) and isinstance(v, float):
                self.locals[stmt.name] = v      # folds on, like eval_expr
                continue
            name = (f"l_{stmt.name}" if isinstance(stmt, ir.LocalDef)
                    else f"w{self.n_tmp}_{stmt.grid}")
            self.n_tmp += 1
            self.lines.append(f"  const float {name} = {self.c(v)};")
            if isinstance(stmt, ir.LocalDef):
                self.locals[stmt.name] = name
            else:
                self.written[stmt.grid] = name
        for o, g in enumerate(out_grids):
            self.lines.append(f"  out[{o}] = {self.written[g]};")
        return self.lines


def point_function(kernel: ir.StencilIR, opnd_grids: Sequence[str],
                   out_grids: Sequence[str], tap=None) -> str:
    """C++ source of ``stencil_point`` for ``kernel``; operand grid ``G``
    is ``opnd_grids[G]`` and ``out[o]`` is ``out_grids[o]``.  ``tap``, when
    given, maps an ``ir.Tap`` read through the reader to its C source."""
    lines = _Emitter(kernel, opnd_grids, tap).body(out_grids)
    return "\n".join(
        [f"// point function of stencil '{kernel.name}' (generated from "
         "StencilIR by emit.py)",
         "template <class Rd>",
         "__host__ __device__ inline void stencil_point("
         "const Rd& rd, const float* s, float* out) {",
         "  (void)s;"] + lines + ["}"])


def _table(name: str, vals, arg: str = "g") -> str:
    """A ``constexpr int name(int arg)`` returning ``vals[arg]`` (0 past
    the end)."""
    cases = " : ".join(f"{arg} == {i} ? {v}" for i, v in enumerate(vals))
    body = f"{cases} : 0" if vals else "0"
    return (f"__host__ __device__ constexpr int {name}(int {arg}) "
            f"{{ return {body}; }}")


def header(kernel: ir.StencilIR, opnd_grids: Sequence[str],
           out_grids: Sequence[str], halo3: Dict[str, Tuple[int, int, int]],
           block3: Tuple[int, int, int], point: str = None,
           elem: str = "float") -> str:
    """The generated part of a kernel source: the grids' element type
    ``elem`` (``float`` or ``__nv_bfloat16``), sizes, per-grid tap halos
    (3D form; a grid with any off-center tap is kept in the streaming
    kernel's plane ring), the output → operand map, and the point function
    (``point``, default ``point_function``'s)."""
    ng, no = len(opnd_grids), len(out_grids)
    ns = len(kernel.scalar_params)
    table = _table
    h = [halo3[g] for g in opnd_grids]
    oidx = [list(opnd_grids).index(g) for g in out_grids]
    return "\n".join([
        f"#define RT_ELEM {elem}",
        f"#define RT_NG {ng}",
        f"#define RT_NS {ns}",
        f"#define RT_NO {no}",
        f"#define RT_TB0 {block3[0]}",
        f"#define RT_TB1 {block3[1]}",
        f"#define RT_TB2 {block3[2]}",
        table("grid_h0", [x[0] for x in h]),
        table("grid_h1", [x[1] for x in h]),
        table("grid_h2", [x[2] for x in h]),
        table("grid_ring", [int(any(x)) for x in h]),
        table("out_grid", oidx, "o"),
        point or point_function(kernel, opnd_grids, out_grids),
        "",
    ])


def f4_rows(kernel: ir.StencilIR, opnd_grids: Sequence[str],
            out_grids: Sequence[str]) -> List[Tuple[str, int, int, int, int]]:
    """The f4 template's tap rows ``(grid, dx, dy, lo, hi)`` in
    ``f4_functions``' order (``lo``/``hi``: the range of the row's ``dz``
    taps)."""
    rows: Dict[Tuple[str, int, int], List[int]] = {}
    _f4_point(kernel, opnd_grids, out_grids, rows)
    return [(g, dx, dy, min(dzs), max(dzs)) for (g, dx, dy), dzs in rows.items()]


def _f4_point(kernel, opnd_grids, out_grids, rows) -> str:
    def tap(t):
        dx, dy, dz = offsets3(t.offsets)
        rows.setdefault((t.grid, dx, dy), []).append(dz)
        return f"rd.template at<{list(rows).index((t.grid, dx, dy))}, {dz}>()"
    return point_function(kernel, opnd_grids, out_grids, tap)


def f4_functions(kernel: ir.StencilIR, opnd_grids: Sequence[str],
                 out_grids: Sequence[str]) -> str:
    """The f4 template's generated part (K4, ``csrc/f4_rows.cuh``): the
    tap rows the point function reads through the reader, in the order it
    first reads them (row ``r``: grid, ``(dx, dy)`` and the range of its
    ``dz`` taps), and ``stencil_point`` reading tap ``dz`` of row ``r`` as
    ``rd.template at<r, dz>()``.  A center read of a grid an earlier
    statement wrote is served from the new value and makes no row."""
    gidx = {g: i for i, g in enumerate(opnd_grids)}
    rows: Dict[Tuple[str, int, int], List[int]] = {}
    point = _f4_point(kernel, opnd_grids, out_grids, rows)
    keys = list(rows)
    return "\n".join([
        f"#define RT_F4_ROWS {len(keys)}",
        _table("f4_row_grid", [gidx[g] for g, _, _ in keys], "r"),
        _table("f4_row_dx", [dx for _, dx, _ in keys], "r"),
        _table("f4_row_dy", [dy for _, _, dy in keys], "r"),
        _table("f4_row_lo", [min(rows[k]) for k in keys], "r"),
        _table("f4_row_hi", [max(rows[k]) for k in keys], "r"),
        point,
        "",
    ])


def split_coefficient(c: ir.Expr) -> Tuple[float, Optional[ir.Expr]]:
    """``(κ, φ)`` with ``c == κ · φ``: κ the numbers pulled out of ``c``'s
    chain of products, quotients and negations, φ what is left (``None``
    when nothing is).  ``((vp2·dt·dt)·1.6) / (1 + damp·dt)`` gives ``(1.6,
    (vp2·dt·dt) / (1 + damp·dt))``; any other node is its own residual."""
    if isinstance(c, ir.Const):
        return float(c.value), None
    if isinstance(c, ir.Neg):
        k, phi = split_coefficient(c.operand)
        return -k, phi
    if isinstance(c, ir.BinOp) and c.op in ("*", "/"):
        kl, pl = split_coefficient(c.lhs)
        kr, pr = split_coefficient(c.rhs)
        if c.op == "*":
            phi = pr if pl is None else pl if pr is None else ir.BinOp("*", pl, pr)
            return kl * kr, phi
        if kr != 0.0:
            if pr is None:
                return kl / kr, pl
            return kl / kr, ir.BinOp("/", ir.Const(1.0) if pl is None else pl, pr)
    return 1.0, c


def semi_plan(lin, out_grids: Sequence[str]):
    """Per output grid ``O`` (in ``out_grids`` order): ``(phis, by_d)``.
    ``phis`` lists the residuals of its term groups, in the order of their
    first term (``None``: the group of numeric coefficients); ``by_d`` maps
    an axis-0 offset ``D`` to its terms ``[(grid, offsets3, group, κ)]`` in
    ``semi_linearize`` order, the order in which K5 and its plain version
    add them.  Residuals are compared structurally; a coefficient that
    does not factor is its own group with κ = 1."""
    plan = []
    for og in out_grids:
        phis: List[Optional[ir.Expr]] = []
        by_d: Dict[int, list] = {}
        for g, offs, c in lin[og][0]:
            kappa, phi = split_coefficient(c)
            if phi not in phis:
                phis.append(phi)
            d = offsets3(offs)
            by_d.setdefault(d[0], []).append((g, d, phis.index(phi), kappa))
        plan.append((phis, by_d))
    return plan


def _constexpr_chain(cases, default) -> List[str]:
    """``if constexpr (cond) {...} else if ... else {default}`` lines."""
    lines = []
    for i, (cond, body) in enumerate(cases):
        lines.append(("  " if i == 0 else "  } else ")
                     + f"if constexpr ({cond}) {{")
        lines += ["    " + b for b in body]
    if not cases:
        return ["  " + b for b in default]
    lines.append("  } else {")
    lines += ["    " + b for b in default]
    return lines + ["  }"]


def semi_functions(kernel: ir.StencilIR, opnd_grids: Sequence[str],
                   out_grids: Sequence[str], lin, H: int) -> str:
    """C++ source of K5's generated part: ``RT_H``, ``RT_NR`` (the ring of
    ``2H+1`` partial planes), ``RT_NGR`` (term groups an output has at
    most), ``semi_scatter`` and ``semi_finish`` (see the module docstring)
    for the linearized kernel ``lin``."""
    gidx = {g: i for i, g in enumerate(opnd_grids)}
    plan = semi_plan(lin, out_grids)
    ngr = max([len(phis) for phis, _ in plan] + [1])

    scatter, finish = [], []
    for o, (phis, by_d) in enumerate(plan):
        for d, terms in sorted(by_d.items()):
            body = []
            for g, offs, grp, kappa in terms:
                tap = f"rd.template tap<{gidx[g]}>({offs[1]}, {offs[2]})"
                body.append(f"acc[{grp}] += {tap};" if kappa == 1.0 else
                            f"acc[{grp}] += {f32_literal(kappa)} * {tap};")
            scatter.append((f"O == {o} && D == {d}", body))
        # each coefficient field read once, at the emitted plane
        fields: List[int] = []

        def field(t):
            if gidx[t.grid] not in fields:
                fields.append(gidx[t.grid])
            return f"f{gidx[t.grid]}"
        em = _Emitter(kernel, opnd_grids, tap=field)
        parts = [f"acc[{i}]" if phi is None else
                 f"{em.c(em.expr(phi))} * acc[{i}]" for i, phi in enumerate(phis)]
        const = em.expr(lin[out_grids[o]][1])
        if not (isinstance(const, float) and const == 0.0) or not parts:
            parts.append(em.c(const))
        value = parts[0]
        for part in parts[1:]:
            value = f"({value} + {part})"
        finish.append((f"O == {o}",
                       [f"const float f{g} = rd.template cf<{g}>(RT_H);"
                        for g in fields] + [f"return {value};"]))
    return "\n".join([
        f"#define RT_H {H}",
        f"#define RT_NR {2 * H + 1}",
        f"#define RT_NGR {ngr}",
        f"// semi-stencil scatter of stencil '{kernel.name}' (generated from "
        "StencilIR by emit.py)",
        "template <int O, int D, class Rd>",
        "__host__ __device__ inline void semi_scatter("
        "const Rd& rd, const float* s, float (&acc)[RT_NGR]) {",
        "  (void)rd; (void)s; (void)acc;",
        *_constexpr_chain(scatter, []),
        "}",
        "template <int O, class Rd>",
        "__host__ __device__ inline float semi_finish(const Rd& rd, "
        "const float* s, const float (&acc)[RT_NGR]) {",
        "  (void)rd; (void)s; (void)acc;",
        *_constexpr_chain(finish, ["return 0.0f;"]),
        "}",
        "",
    ])
