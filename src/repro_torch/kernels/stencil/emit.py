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
``out[o]`` receives the new value of output grid ``o``.

Statement semantics follow the JAX package's ``_exec_statements``: a
``LocalDef`` becomes a ``const`` local; a center read of a grid written by
an earlier statement returns the new value.  Arithmetic is f32 throughout:
constant subtrees fold in Python double precision exactly as ``eval_expr``
folds them, and reach the code as f32 literals; math calls use the f32
functions (``expf``, ``powf``, ``fminf``...), so nothing is promoted to
double.  Nothing here mutates.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

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
    def __init__(self, kernel: ir.StencilIR, opnd_grids: Sequence[str]):
        self.kernel = kernel
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
                   out_grids: Sequence[str]) -> str:
    """C++ source of ``stencil_point`` for ``kernel``; operand grid ``G``
    is ``opnd_grids[G]`` and ``out[o]`` is ``out_grids[o]``."""
    lines = _Emitter(kernel, opnd_grids).body(out_grids)
    return "\n".join(
        [f"// point function of stencil '{kernel.name}' (generated from "
         "StencilIR by emit.py)",
         "template <class Rd>",
         "__host__ __device__ inline void stencil_point("
         "const Rd& rd, const float* s, float* out) {",
         "  (void)s;"] + lines + ["}"])


def header(kernel: ir.StencilIR, opnd_grids: Sequence[str],
           out_grids: Sequence[str], halo3: Dict[str, Tuple[int, int, int]],
           block3: Tuple[int, int, int]) -> str:
    """The generated part of a kernel source: sizes, per-grid tap halos (3D
    form; a grid with any off-center tap is kept in the streaming kernel's
    plane ring), the output → operand map, and the point function."""
    ng, no = len(opnd_grids), len(out_grids)
    ns = len(kernel.scalar_params)

    def table(name, vals):
        cases = " : ".join(f"g == {i} ? {v}" for i, v in enumerate(vals))
        return (f"__host__ __device__ constexpr int {name}(int g) "
                f"{{ return {cases} : 0; }}")

    h = [halo3[g] for g in opnd_grids]
    oidx = [list(opnd_grids).index(g) for g in out_grids]
    return "\n".join([
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
        table("out_grid", oidx).replace("(int g)", "(int o)")
        .replace("g == ", "o == "),
        point_function(kernel, opnd_grids, out_grids),
        "",
    ])
