"""StencilIR: the intermediate representation produced by the DSL frontend.

The paper (§4.4) parses DSL code into an AST, then lowers it to a sequence of
IRs annotated with stencil shape / looping pattern / grid updates.  We keep a
single typed IR that captures everything the analyses and code generators
need:

  * ``Tap``        — a read of a grid at a constant integer offset from the
                     current stencil point (``u.at(-4, 0)``).
  * ``Assign``     — an update of a grid at the center point
                     (``v.at(0, 0).set(expr)``).
  * ``LocalDef``   — a local temporary (``lap = ...``) usable by later
                     statements; enables multi-statement stencils such as the
                     acoustic-ISO update.
  * expression nodes: ``Const``, ``ScalarRef``, ``LocalRef``, ``BinOp``,
    ``Neg``, ``Call`` (a small whitelisted math-function set).

Offsets must be compile-time integer constants — this is what makes the
stencil *shape* statically analyzable, which is the property the whole
paper's template machinery rests on.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------


class Expr:
    """Base class for StencilIR expressions (frozen dataclasses below)."""

    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    value: float


@dataclasses.dataclass(frozen=True)
class ScalarRef(Expr):
    """Reference to a scalar kernel parameter (``st.f32``/``st.i32``)."""

    name: str


@dataclasses.dataclass(frozen=True)
class LocalRef(Expr):
    """Reference to a ``LocalDef`` temporary."""

    name: str


@dataclasses.dataclass(frozen=True)
class Tap(Expr):
    """Read grid ``grid`` at constant ``offsets`` from the center point."""

    grid: str
    offsets: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    op: str  # '+', '-', '*', '/', '**'
    lhs: Expr
    rhs: Expr


@dataclasses.dataclass(frozen=True)
class Neg(Expr):
    operand: Expr


@dataclasses.dataclass(frozen=True)
class Call(Expr):
    """Whitelisted elementwise math call (exp, sqrt, abs, min, max...)."""

    fn: str
    args: Tuple[Expr, ...]


# --------------------------------------------------------------------------
# Statements
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LocalDef:
    name: str
    expr: Expr


@dataclasses.dataclass(frozen=True)
class Assign:
    """``grid.at(0, ..).set(expr)`` — center-point update.

    ``offsets`` is retained for generality but non-zero write offsets are
    rejected by the frontend (stencils write the center point; this is also
    what makes the map parallel).
    """

    grid: str
    offsets: Tuple[int, ...]
    expr: Expr


Stmt = Union[LocalDef, Assign]


@dataclasses.dataclass(frozen=True)
class StencilIR:
    """A parsed stencil kernel.

    grid_params   : names of grid parameters in positional order
    scalar_params : (name, dtype-str) of scalar parameters in positional order
    ndim          : dimensionality of every ``at`` offset tuple
    body          : statements in program order
    """

    name: str
    ndim: int
    grid_params: Tuple[str, ...]
    scalar_params: Tuple[Tuple[str, str], ...]
    body: Tuple[Stmt, ...]

    # -- convenience ------------------------------------------------------
    def walk_exprs(self):
        """Yield every expression node in the body (pre-order)."""

        def _walk(e):
            yield e
            if isinstance(e, BinOp):
                yield from _walk(e.lhs)
                yield from _walk(e.rhs)
            elif isinstance(e, Neg):
                yield from _walk(e.operand)
            elif isinstance(e, Call):
                for a in e.args:
                    yield from _walk(a)

        for stmt in self.body:
            yield from _walk(stmt.expr)

    def taps(self):
        return [e for e in self.walk_exprs() if isinstance(e, Tap)]

    def output_grids(self) -> Tuple[str, ...]:
        seen = []
        for stmt in self.body:
            if isinstance(stmt, Assign) and stmt.grid not in seen:
                seen.append(stmt.grid)
        return tuple(seen)

    def input_grids(self) -> Tuple[str, ...]:
        seen = []
        for t in self.taps():
            if t.grid not in seen:
                seen.append(t.grid)
        return tuple(seen)
