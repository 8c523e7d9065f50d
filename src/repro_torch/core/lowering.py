"""Lower StencilIR to plain PyTorch shifted-slice code (the ``torch`` backend).

This is the port's always-correct lowering and the oracle every hand-written
CUDA kernel is held against (``kernels/stencil/ref.py`` re-exports it).  Each
``Tap(grid, offsets)`` becomes a slice view of the halo-padded grid tensor and
the expression tree is evaluated over the whole region at once.

Scenarios (``batch=B``): every grid carries a leading scenario axis, the
taps index the spatial axes after it, and a ``(B,)`` scalar takes one value
a scenario (a float or 0-d scalar is shared); each scenario's arithmetic is
the unbatched lowering's.

In place: ``lower_torch``'s function writes each output grid's region into
the tensor it was given (the other grids are only read), and
``lower_torch_window`` therefore advances the tensors of its ``arrays`` dict
in place as well; the returned dicts hold the same tensors under the rotated
names.  ``lower_torch_window(fresh=True)`` and the masked serving window
``lower_torch_window_masked`` are the exceptions: they write new tensors and
leave their arguments as they were.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from . import ir


def _as_tensor(x, like: Optional[torch.Tensor]):
    if isinstance(x, torch.Tensor):
        return x
    if like is None:
        return torch.tensor(x, dtype=torch.float32)
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _math(fn):
    """Wrap a torch op so Python-number arguments become tensors of the
    dtype/device of the first tensor argument (``jnp`` ops accept numbers)."""
    def call(*args):
        like = next((a for a in args if isinstance(a, torch.Tensor)), None)
        return fn(*(_as_tensor(a, like) for a in args))
    return call


_MATH = {
    "exp": _math(torch.exp), "sqrt": _math(torch.sqrt), "abs": _math(torch.abs),
    "sin": _math(torch.sin), "cos": _math(torch.cos), "tanh": _math(torch.tanh),
    "min": _math(torch.minimum), "max": _math(torch.maximum),
}


def eval_expr(e: ir.Expr, read: Callable[[str, Tuple[int, ...]], torch.Tensor],
              scalars: Mapping[str, torch.Tensor],
              local_env: Dict[str, torch.Tensor]):
    """Evaluate an IR expression with a pluggable tap-``read`` function.

    Shared by this lowering and the plain versions of the CUDA kernels —
    each supplies its own ``read`` (slice of the grid, of the layout buffer
    or of a plane ring).  Constant subtrees fold in Python double precision
    exactly as in the JAX package; the CUDA emitter folds them the same way.
    """
    if isinstance(e, ir.Const):
        return e.value
    if isinstance(e, ir.ScalarRef):
        return scalars[e.name]
    if isinstance(e, ir.LocalRef):
        return local_env[e.name]
    if isinstance(e, ir.Tap):
        return read(e.grid, e.offsets)
    if isinstance(e, ir.Neg):
        return -eval_expr(e.operand, read, scalars, local_env)
    if isinstance(e, ir.BinOp):
        l = eval_expr(e.lhs, read, scalars, local_env)
        r = eval_expr(e.rhs, read, scalars, local_env)
        if e.op == "+":
            return l + r
        if e.op == "-":
            return l - r
        if e.op == "*":
            return l * r
        if e.op == "/":
            return l / r
        if e.op == "**":
            return l ** r
        raise ValueError(f"bad op {e.op}")
    if isinstance(e, ir.Call):
        args = [eval_expr(a, read, scalars, local_env) for a in e.args]
        return _MATH[e.fn](*args)
    raise TypeError(f"bad expr {e!r}")


def _fill(val, dtype, shape, device) -> torch.Tensor:
    """``jnp.broadcast_to(jnp.asarray(val, dtype), shape)`` in torch.  A bare
    tap is a view of a grid, possibly of the one being written: copy it."""
    if isinstance(val, torch.Tensor) and val._is_view():
        val = val.clone()
    return torch.as_tensor(val, dtype=dtype, device=device).expand(shape)


def run_statements(kernel: ir.StencilIR,
                   read_from: Callable[[torch.Tensor, str, Tuple[int, ...]],
                                       torch.Tensor],
                   arrays: Dict[str, torch.Tensor],
                   scalars: Mapping[str, torch.Tensor],
                   write: Callable[[torch.Tensor, torch.Tensor, str], None],
                   region_shape: Tuple[int, ...],
                   dtype) -> Dict[str, torch.Tensor]:
    """Execute kernel statements sequentially over ``arrays``; ``write``
    stores each statement's value into its grid's tensor in place (or
    returns a new tensor that takes the grid's place), so a later statement
    reads the new value."""
    local_env: Dict[str, torch.Tensor] = {}
    arrays = dict(arrays)
    device = next(iter(arrays.values())).device

    def read(g, offs):
        return read_from(arrays[g], g, offs)

    for stmt in kernel.body:
        if isinstance(stmt, ir.LocalDef):
            local_env[stmt.name] = eval_expr(stmt.expr, read, scalars, local_env)
        else:
            val = eval_expr(stmt.expr, read, scalars, local_env)
            new = write(arrays[stmt.grid], _fill(val, dtype, region_shape, device),
                        stmt.grid)
            if new is not None:
                arrays[stmt.grid] = new
    return arrays


def exec_statements(kernel: ir.StencilIR, tap_read, scalars, shape, dtype,
                    device) -> Dict[str, torch.Tensor]:
    """Run the kernel's statements over one block of ``shape`` and return
    {output grid: new value} (the JAX package's ``_exec_statements``, used
    by the plain versions of the CUDA kernels).

    ``tap_read(grid, offsets)`` reads *old* values; a center read of a grid
    written by an earlier statement returns the new value."""
    env: Dict[str, torch.Tensor] = {}
    locals_env: Dict[str, torch.Tensor] = {}

    def read(g, offs):
        if g in env and not any(offs):
            return env[g]
        return tap_read(g, offs)

    for stmt in kernel.body:
        val = eval_expr(stmt.expr, read, scalars, locals_env)
        if isinstance(stmt, ir.LocalDef):
            locals_env[stmt.name] = val
        else:
            env[stmt.grid] = _fill(val, dtype, shape, device)
    return env


def lower_torch(kernel: ir.StencilIR,
                halos: Mapping[str, Tuple[int, ...]],
                interior_shape: Tuple[int, ...],
                region: Optional[Tuple[Tuple[int, int], ...]] = None,
                batch: int = 0,
                fresh: bool = False):
    """Build ``fn(arrays: dict, scalars: dict) -> dict`` for this kernel
    (the counterpart of the JAX package's ``lower_jax``).

    ``arrays`` map grid-param name → full (halo-padded) tensor, with a
    leading axis of ``batch`` scenarios when it is set; the function writes
    the output grids on ``region`` (interior coordinates, default the whole
    interior) in place and returns the dict.  ``fresh``: each write goes to
    a copy of the grid made once its value is computed, so no tensor given
    is written and autograd can record the step.  ``fn(arrays, scalars,
    out)``: each output's region goes to ``out[grid]`` (a tensor of the
    grid's shape), which takes the grid's place in the returned dict; the
    grids given are only read.
    """
    ndim = kernel.ndim
    if region is None:
        region = tuple((0, s) for s in interior_shape)
    region_shape = ((batch,) if batch else ()) + tuple(e - b for b, e in region)

    def read_from(arr, g, offs):
        h = halos[g]
        return arr[(...,) + tuple(slice(h[ax] + region[ax][0] + offs[ax],
                                        h[ax] + region[ax][1] + offs[ax])
                                  for ax in range(ndim))]

    def fn(arrays: Dict[str, torch.Tensor], scalars: Mapping[str, torch.Tensor],
           out: Optional[Dict[str, torch.Tensor]] = None):
        def write(arr, val, g):
            h = halos[g]
            new = out is not None or fresh
            if out is not None:
                arr = out[g]
            elif fresh:
                arr = arr.clone()
            arr[(...,) + tuple(slice(h[ax] + region[ax][0], h[ax] + region[ax][1])
                               for ax in range(ndim))] = val
            return arr if new else None

        dtype = arrays[kernel.output_grids()[0]].dtype
        if batch:
            # a (B,) scalar: one value a scenario, broadcast over its grid
            scalars = {n: (v.reshape((-1,) + (1,) * ndim)
                           if isinstance(v, torch.Tensor) and v.dim() == 1 else v)
                       for n, v in scalars.items()}
        return run_statements(kernel, read_from, arrays, scalars, write,
                              region_shape, dtype)

    return fn


def lower_torch_window(kernel: ir.StencilIR,
                       halos: Mapping[str, Tuple[int, ...]],
                       interior_shape: Tuple[int, ...],
                       region: Optional[Tuple[Tuple[int, int], ...]],
                       swap: Optional[Tuple[str, str]],
                       steps: int,
                       batch: int = 0,
                       fresh: bool = False):
    """Fused time-loop window on the torch backend: ``steps`` applications
    of the kernel plus the leapfrog name rotation of the ``swap`` pair
    (written, other) after each application (the counterpart of
    ``lower_jax_window``), over ``batch`` scenarios when it is set.
    Returns ``fn(arrays, scalars) -> arrays``.

    ``fresh=True`` is the step the adjoint differentiates
    (``core/adjoint.py``): each step writes its outputs into new tensors,
    so the arguments are left as they were and autograd records the step
    as a function of them.  The adjoint keeps one carry a step and
    differentiates one step at a time, the counterpart of the JAX
    package's ``remat=True`` window: a window recorded whole would hold
    every tap's temporaries for ``steps`` steps."""
    step_fn = lower_torch(kernel, halos, interior_shape, region, batch, fresh)

    def window(arrays: Dict[str, torch.Tensor],
               scalars: Mapping[str, torch.Tensor]):
        arrs = dict(arrays)
        for _ in range(steps):
            arrs = step_fn(arrs, scalars)
            if swap is not None:
                arrs[swap[0]], arrs[swap[1]] = arrs[swap[1]], arrs[swap[0]]
        return arrs

    return window


def lower_torch_window_masked(kernel: ir.StencilIR,
                              halos: Mapping[str, Tuple[int, ...]],
                              interior_shape: Tuple[int, ...],
                              swap: Optional[Tuple[str, str]],
                              steps: int,
                              batch: int = 0):
    """Masked fused window for shape-bucketed serving (the counterpart of
    ``lower_jax_window_masked``): the step update is confined to a
    ``mask``-selected sub-domain and to scenarios whose step budget has not
    run out.

    Semantics (exact):

      * **spatial** — interior cells where ``mask`` is False are frozen:
        they keep each buffer's value and behave like grid-halo cells.  The
        freeze happens in buffer space, before the rotation, so frozen
        cells travel with their buffers as halo cells do.
      * **temporal** — a scenario stops changing (its rotation included)
        once the step index ``start + i`` reaches its ``limit``; it keeps
        both buffers.

    Returns ``fn(arrays, scalars, mask, start, limit) -> arrays``: ``mask``
    a bool tensor over the interior, ``limit`` the step budget and
    ``start`` the index of the window's first step.  Under ``batch=B``
    ``mask`` is ``(B,) + interior`` and ``limit`` ``(B,)`` (per scenario),
    ``start`` shared, and the spatial axes follow the scenario axis.  Both
    freezes are ``torch.where`` selects on new tensors, so the arguments
    are left as they were and autograd freezes masked cells exactly: a
    frozen cell's cotangent passes through the step unchanged and the
    discarded update contributes nothing.
    """
    step_fn = lower_torch(kernel, halos, interior_shape, None, batch, fresh=True)
    written = kernel.output_grids()
    ndim = kernel.ndim

    def interior_idx(g):
        h = halos[g]
        return (...,) + tuple(slice(h[ax], h[ax] + interior_shape[ax])
                              for ax in range(ndim))

    def window(arrays: Dict[str, torch.Tensor],
               scalars: Mapping[str, torch.Tensor],
               mask: torch.Tensor,
               start,
               limit: torch.Tensor):
        arrs = dict(arrays)
        limit = torch.as_tensor(limit, device=mask.device)
        for i in range(steps):
            out = dict(step_fn(arrs, scalars))
            act = (start + i) < limit
            if batch:
                act = act.reshape((-1,) + (1,) * ndim)
            for g in written:
                # out[g] is the step's own copy of the grid: its halo is
                # the old buffer's; freeze its masked interior cells too
                idx = interior_idx(g)
                out[g][idx] = torch.where(mask, out[g][idx], arrs[g][idx])
            if swap is not None:
                w, o = swap
                # per-scenario rotation: a frozen scenario keeps both
                # buffers, an active one trades them
                new_w = torch.where(act, arrs[o], arrs[w])
                new_o = torch.where(act, out[w], arrs[o])
                out[w], out[o] = new_w, new_o
            else:
                for g in written:
                    out[g] = torch.where(act, out[g], arrs[g])
            arrs = out
        return arrs

    return window
