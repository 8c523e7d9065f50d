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
``out[o]`` receives the new value of output grid ``o``.  K2, K3 and K4
smem call it, each with its own reader; K1 and K4 gmem read each tap at
compile-time offsets, as ``rd.template at<G, dx, dy, dz>()``
(``gmem_functions``), and K4's f4 template reads its tap rows from
register queues, as ``rd.template at<f, dx, dz>()`` (``f4_functions``).

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

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

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


# each f32 operation rounded once by itself: no FMA contraction (the
# functions are defined with semi_functions' output)
_STRICT = {"+": "rt_fadd", "-": "rt_fsub", "*": "rt_fmul", "/": "rt_fdiv"}


class _Emitter:
    def __init__(self, kernel: ir.StencilIR, opnd_grids: Sequence[str],
                 tap=None, strict: bool = False):
        self.kernel = kernel
        self.tap = tap          # C source of a Tap, when not the default
        self.strict = strict    # operations as _STRICT's intrinsics
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
            if self.strict:
                return f"{_STRICT[e.op]}({l}, {r})"
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


def int_table(name: str, vals, arg: str = "g") -> str:
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
        int_table("grid_h0", [x[0] for x in h]),
        int_table("grid_h1", [x[1] for x in h]),
        int_table("grid_h2", [x[2] for x in h]),
        int_table("grid_ring", [int(any(x)) for x in h]),
        int_table("out_grid", oidx, "o"),
        point or point_function(kernel, opnd_grids, out_grids),
        "",
    ])


def gmem_functions(kernel: ir.StencilIR, opnd_grids: Sequence[str],
                   out_grids: Sequence[str]) -> str:
    """K1's and K4 gmem's point function (``csrc/gmem_column.cuh``): it
    reads tap ``(dx, dy, dz)`` of grid ``G`` as ``rd.template at<G, dx, dy,
    dz>()``, so the kernel resolves each tap (a queue slot, a cell of the
    lane's own unit or a load at a constant offset) when it is
    compiled."""
    gidx = {g: i for i, g in enumerate(opnd_grids)}

    def tap(t):
        dx, dy, dz = offsets3(t.offsets)
        return f"rd.template at<{gidx[t.grid]}, {dx}, {dy}, {dz}>()"
    return point_function(kernel, opnd_grids, out_grids, tap)


def f4_rows(kernel: ir.StencilIR, opnd_grids: Sequence[str],
            out_grids: Sequence[str]) -> List[Tuple[str, int, int, int, int]]:
    """The f4 template's tap rows ``(grid, dx, dy, lo, hi)`` in the order
    the point function first reads them (``lo``/``hi``: the range of the
    row's ``dz`` taps).  A center read of a grid an earlier statement
    wrote is served from the new value and makes no row."""
    rows: Dict[Tuple[str, int, int], List[int]] = {}
    _f4_point(kernel, opnd_grids, out_grids, rows)
    return [(g, dx, dy, min(dzs), max(dzs)) for (g, dx, dy), dzs in rows.items()]


def _f4_point(kernel, opnd_grids, out_grids, rows) -> str:
    """The point function reading tap ``dz`` of the rows of family ``f``
    (the ``(grid, dy)`` pairs, in first-read order) at axis-0 offset ``dx``
    as ``rd.template at<f, dx, dz>()``; fills ``rows``."""
    def tap(t):
        dx, dy, dz = offsets3(t.offsets)
        rows.setdefault((t.grid, dx, dy), []).append(dz)
        fams = list(dict.fromkeys((g, y) for g, _, y in rows))
        return f"rd.template at<{fams.index((t.grid, dy))}, {dx}, {dz}>()"
    return point_function(kernel, opnd_grids, out_grids, tap)


class F4Piece(NamedTuple):
    """A run of cells of one family that one queue carries: cells
    ``[c0, c1]`` relative to the group's first point ``z0``, needed by the
    rows at axis-0 offsets ``[a, b]``; ``off`` is the cell ``c0``'s place
    in its aligned vector of 4 when the plan fixes it (the aligned path),
    None where the kernel finds it at run time."""
    fam: int
    c0: int
    c1: int
    a: int
    b: int
    off: Optional[int]


def f4_pieces(rows, org_mod4: Dict[str, Optional[int]]):
    """The f4 template's families and queue pieces for ``rows``
    (``f4_rows``): families ``[(grid, dy, hi)]`` (``hi``: the largest
    ``dz`` of their rows) and ``[F4Piece]``.  A point ``j`` (0..3) of a
    group reads cell ``dz + j`` of the row at ``dx``, so the row at ``dx``
    needs cells ``[lo, hi + 3]``; cells needed by the same range of ``dx``
    form a piece.  The row of plane ``x + dx`` is the row of plane ``x``
    at offset ``dx`` one plane later, so a piece is one queue of
    ``b - a + 1`` slots along the thread's column, and each plane loads
    only its leading slot (plane ``x + b``).  ``org_mod4`` maps a grid to
    the place of its region's first cell in an aligned vector of 4 when
    both pitches are multiples of 4 cells (then every row of a group that
    starts at a multiple of 4 has that place), else to None."""
    fams: Dict[Tuple[str, int], List[Tuple[int, int, int]]] = {}
    for g, dx, dy, lo, hi in rows:
        fams.setdefault((g, dy), []).append((dx, lo, hi))
    families, pieces = [], []
    for f, ((g, dy), rs) in enumerate(fams.items()):
        families.append((g, dy, max(hi for _, _, hi in rs)))
        runs: List[list] = []          # [c0, c1, (a, b)]
        for c in range(min(lo for _, lo, _ in rs), max(hi for _, _, hi in rs) + 4):
            dxs = [dx for dx, lo, hi in rs if lo <= c <= hi + 3]
            if not dxs:
                continue
            rng = (min(dxs), max(dxs))
            if runs and runs[-1][2] == rng and runs[-1][1] == c - 1:
                runs[-1][1] = c
            else:
                runs.append([c, c, rng])
        off = org_mod4[g]
        pieces += [F4Piece(f, c0, c1, a, b, None if off is None else (off + c0) % 4)
                   for c0, c1, (a, b) in runs]
    return families, pieces


def f4_functions(kernel: ir.StencilIR, opnd_grids: Sequence[str],
                 out_grids: Sequence[str],
                 org_mod4: Dict[str, Optional[int]]) -> str:
    """The f4 template's generated part (K4, ``csrc/f4_rows.cuh``): the
    families (grid, ``dy``, largest ``dz``) and queue pieces of
    ``f4_pieces`` (``f4_piece_off`` -1 where the kernel aligns at run
    time), and ``stencil_point`` reading tap ``dz`` of family ``f`` at
    axis-0 offset ``dx`` as ``rd.template at<f, dx, dz>()``."""
    gidx = {g: i for i, g in enumerate(opnd_grids)}
    rows: Dict[Tuple[str, int, int], List[int]] = {}
    point = _f4_point(kernel, opnd_grids, out_grids, rows)
    families, pieces = f4_pieces(
        [(g, dx, dy, min(d), max(d)) for (g, dx, dy), d in rows.items()],
        org_mod4)
    return "\n".join([
        f"#define RT_F4_FAMS {len(families)}",
        int_table("f4_fam_grid", [gidx[g] for g, _, _ in families], "f"),
        int_table("f4_fam_dy", [dy for _, dy, _ in families], "f"),
        int_table("f4_fam_hi", [hi for _, _, hi in families], "f"),
        f"#define RT_F4_PIECES {len(pieces)}",
        int_table("f4_piece_fam", [p.fam for p in pieces], "p"),
        int_table("f4_piece_c0", [p.c0 for p in pieces], "p"),
        int_table("f4_piece_c1", [p.c1 for p in pieces], "p"),
        int_table("f4_piece_a", [p.a for p in pieces], "p"),
        int_table("f4_piece_b", [p.b for p in pieces], "p"),
        int_table("f4_piece_off", [-1 if p.off is None else p.off for p in pieces], "p"),
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
        # each operation of the finish rounded by itself: the plane's value
        # must not depend on which products the compiler contracts into
        # FMAs, which differs with where the scalars come from (the
        # parameter block or a scenario's row, csrc/common.cuh)
        em = _Emitter(kernel, opnd_grids, tap=field, strict=True)
        parts = [f"acc[{i}]" if phi is None else
                 f"rt_fmul({em.c(em.expr(phi))}, acc[{i}])" for i, phi in enumerate(phis)]
        const = em.expr(lin[out_grids[o]][1])
        if not (isinstance(const, float) and const == 0.0) or not parts:
            parts.append(em.c(const))
        value = parts[0]
        for part in parts[1:]:
            value = f"rt_fadd({value}, {part})"
        finish.append((f"O == {o}",
                       [f"const float f{g} = rd.template cf<{g}>(RT_H);"
                        for g in fields] + [f"return {value};"]))
    return "\n".join([
        f"#define RT_H {H}",
        f"#define RT_NR {2 * H + 1}",
        f"#define RT_NGR {ngr}",
        "// f32 operations that round once each and are never contracted into",
        "// an FMA (the card's __f*_rn intrinsics; plain operations on a host)",
        *[f"__host__ __device__ inline float rt_{name}(float a, float b) {{\n"
          f"#ifdef __CUDA_ARCH__\n  return __{name}_rn(a, b);\n#else\n"
          f"  return a {op} b;\n#endif\n}}"
          for name, op in (("fadd", "+"), ("fsub", "-"), ("fmul", "*"), ("fdiv", "/"))],
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
