"""DSL frontend: parse ``@st.kernel`` Python functions into StencilIR.

Mirrors the paper's frontend layer (§4.2): the DSL is hosted in Python, type
hints are *required* on kernel parameters, and only the stencil constructs of
Table 1 (``at`` / ``at.set``) plus ordinary arithmetic are admitted.  Parsing
uses the stdlib ``ast`` module; errors are reported as ``StencilSyntaxError``
with source locations.
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Dict, List, Tuple

from . import ir

_MATH_FNS = frozenset({"exp", "sqrt", "abs", "min", "max", "sin", "cos", "tanh"})

_GRID_ANNOTATIONS = frozenset({"grid"})
_SCALAR_ANNOTATIONS = frozenset({"f32", "f64", "bf16", "i32", "i64"})


class StencilSyntaxError(SyntaxError):
    pass


def _err(node: ast.AST, msg: str) -> StencilSyntaxError:
    return StencilSyntaxError(f"line {getattr(node, 'lineno', '?')}: {msg}")


def _annotation_name(node: ast.expr) -> str:
    """'st.grid' / 'st.f32' → 'grid' / 'f32' (module alias ignored)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    raise _err(node, "unsupported type annotation; use st.grid / st.f32 / st.i32")


def _const_int(node: ast.expr) -> int:
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_const_int(node.operand)
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    raise _err(node, "stencil offsets must be integer literals")


class _KernelParser:
    def __init__(self, fn_name: str, tree: ast.FunctionDef):
        self.fn_name = fn_name
        self.tree = tree
        self.grids: List[str] = []
        self.scalars: List[Tuple[str, str]] = []
        self.locals: Dict[str, bool] = {}
        self.ndim: int = -1

    # -- signature ---------------------------------------------------------
    def parse_signature(self) -> None:
        args = self.tree.args
        if args.kwonlyargs or args.vararg or args.kwarg or args.posonlyargs:
            raise _err(self.tree, "kernels take plain positional parameters only")
        for a in args.args:
            if a.annotation is None:
                raise _err(a, f"parameter '{a.arg}' needs a type hint "
                              "(st.grid or scalar st.f32/st.i32 ...)")
            ann = _annotation_name(a.annotation)
            if ann in _GRID_ANNOTATIONS:
                self.grids.append(a.arg)
            elif ann in _SCALAR_ANNOTATIONS:
                self.scalars.append((a.arg, ann))
            else:
                raise _err(a, f"unknown annotation '{ann}' on '{a.arg}'")

    # -- expressions -------------------------------------------------------
    def parse_expr(self, node: ast.expr) -> ir.Expr:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float)):
                return ir.Const(float(node.value))
            raise _err(node, f"unsupported constant {node.value!r}")
        if isinstance(node, ast.Name):
            if node.id in self.locals:
                return ir.LocalRef(node.id)
            for name, _ in self.scalars:
                if name == node.id:
                    return ir.ScalarRef(node.id)
            if node.id in self.grids:
                raise _err(node, f"grid '{node.id}' must be read via .at(...)")
            raise _err(node, f"unknown name '{node.id}'")
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.USub):
                return ir.Neg(self.parse_expr(node.operand))
            if isinstance(node.op, ast.UAdd):
                return self.parse_expr(node.operand)
            raise _err(node, "unsupported unary operator")
        if isinstance(node, ast.BinOp):
            ops = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*",
                   ast.Div: "/", ast.Pow: "**"}
            for a_ty, sym in ops.items():
                if isinstance(node.op, a_ty):
                    return ir.BinOp(sym, self.parse_expr(node.left),
                                    self.parse_expr(node.right))
            raise _err(node, "unsupported binary operator")
        if isinstance(node, ast.Call):
            return self.parse_call(node)
        raise _err(node, f"unsupported expression {ast.dump(node)[:60]}")

    def parse_call(self, node: ast.Call) -> ir.Expr:
        # u.at(dx, dy[, dz])  — grid tap
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "at" and \
                isinstance(f.value, ast.Name) and f.value.id in self.grids:
            offs = tuple(_const_int(a) for a in node.args)
            self._check_ndim(node, len(offs))
            return ir.Tap(f.value.id, offs)
        # whitelisted math functions: st.exp(x), exp(x), abs(x), ...
        fn_name = None
        if isinstance(f, ast.Attribute):
            fn_name = f.attr
        elif isinstance(f, ast.Name):
            fn_name = f.id
        if fn_name in _MATH_FNS:
            return ir.Call(fn_name, tuple(self.parse_expr(a) for a in node.args))
        raise _err(node, "unsupported call (only grid.at(...) and "
                         f"math fns {sorted(_MATH_FNS)} allowed)")

    def _check_ndim(self, node: ast.AST, n: int) -> None:
        if self.ndim == -1:
            self.ndim = n
        elif self.ndim != n:
            raise _err(node, f"inconsistent offset arity: {n} vs {self.ndim}")

    # -- statements --------------------------------------------------------
    def parse_body(self) -> List[ir.Stmt]:
        out: List[ir.Stmt] = []
        for stmt in self.tree.body:
            if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant) \
                    and isinstance(stmt.value.value, str):
                continue  # docstring
            if isinstance(stmt, ast.Assign):
                if len(stmt.targets) != 1 or not isinstance(stmt.targets[0], ast.Name):
                    raise _err(stmt, "local assignment must be 'name = expr'")
                name = stmt.targets[0].id
                expr = self.parse_expr(stmt.value)
                self.locals[name] = True
                out.append(ir.LocalDef(name, expr))
                continue
            if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
                out.append(self.parse_set(stmt.value))
                continue
            raise _err(stmt, "kernels may only contain local assignments and "
                             "grid.at(...).set(...) statements")
        if not any(isinstance(s, ir.Assign) for s in out):
            raise _err(self.tree, "kernel has no grid.at(...).set(...) update")
        return out

    def parse_set(self, node: ast.Call) -> ir.Assign:
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr == "set"):
            raise _err(node, "expected grid.at(...).set(expr)")
        at_call = f.value
        if not (isinstance(at_call, ast.Call)
                and isinstance(at_call.func, ast.Attribute)
                and at_call.func.attr == "at"
                and isinstance(at_call.func.value, ast.Name)
                and at_call.func.value.id in self.grids):
            raise _err(node, "expected grid.at(...).set(expr)")
        grid = at_call.func.value.id
        offs = tuple(_const_int(a) for a in at_call.args)
        self._check_ndim(node, len(offs))
        if any(o != 0 for o in offs):
            raise _err(node, "stencil updates must write the center point "
                             "(all .set offsets must be 0)")
        if len(node.args) != 1:
            raise _err(node, ".set takes exactly one expression")
        return ir.Assign(grid, offs, self.parse_expr(node.args[0]))


def parse_kernel(fn) -> ir.StencilIR:
    """Parse a Python function decorated with ``@st.kernel`` into StencilIR."""
    src = getattr(fn, "__stencil_source__", None)  # synthesized kernels
    if src is None:
        src = inspect.getsource(fn)
    src = textwrap.dedent(src)
    mod = ast.parse(src)
    fndefs = [n for n in mod.body if isinstance(n, ast.FunctionDef)]
    if len(fndefs) != 1:
        raise StencilSyntaxError("expected exactly one function definition")
    tree = fndefs[0]
    # strip decorators
    p = _KernelParser(fn.__name__, tree)
    p.parse_signature()
    body = p.parse_body()
    if p.ndim == -1:
        raise StencilSyntaxError("kernel contains no .at(...) accesses")
    return ir.StencilIR(
        name=fn.__name__,
        ndim=p.ndim,
        grid_params=tuple(p.grids),
        scalar_params=tuple(p.scalars),
        body=tuple(body),
    )
