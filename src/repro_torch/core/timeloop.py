"""Fused time-loop execution engine on PyTorch.

``TimeloopEngine.run`` advances a kernel ``steps`` applications (plus the
leapfrog rotation of the ``swap`` pair) in fusion windows of ``fuse_steps``;
the host syncs with the device, and the optional ``between`` hook runs,
only at window boundaries.  Per backend:

  torch   — a window is ``fuse_steps`` applications of the plain shifted-
            slice lowering (``lowering.lower_torch_window``).
  hopper  — lowering is split as in the JAX package's Pallas path: a
            one-time layout stage per window (``CudaPlan.to_padded``: each
            grid cut to its layout halo and made contiguous, counted once
            per grid per window in ``codegen.PAD_COUNT``), then CUDA kernel
            launches on the layout buffers (``CudaPlan.step``), then the
            write-back of the touched grids' interiors
            (``CudaPlan.from_padded``).  With ``time_block=k`` a window of
            ``kw`` steps is ``kw // k`` launches of K3, each advancing
            ``k`` steps into spare buffers, then ``kw % k`` single steps
            through a second plan with ``time_block=1`` on the same layout
            (the JAX engine's decomposition); ``fuse_steps`` is never
            rounded to a multiple of ``k``.  A window is a Python loop of
            kernel launches on the current stream.

Scenarios (``batch=B``): every grid carries a leading axis of B
independent scenarios, advanced together: the torch window indexes the
spatial axes after it, and each hopper launch advances all B (the kernels'
``blockIdx.z`` walks the scenarios' tiles).  Scalars are floats (shared)
or ``(B,)`` values (one a scenario).

In place: ``run`` advances the tensors of the ``arrays`` dict it is given
(the output and swap grids' buffers); the returned dict holds those tensors
under the rotated names.  Callers that need the initial state clone first.
An engine built with ``differentiable=True`` never writes the caller's
tensors: each window writes buffers of its own (``window_arrays``, the
carries of the adjoint, ``core/adjoint.py``), and a grid no window writes
is passed on as it is.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from . import ir as _ir
from . import lowering
from .dsl import scalar_tensors


def window_parts(kw: int, k_inner: int) -> list:
    """Decompose a fusion window that is not a multiple of the temporal
    depth: the largest ``k_inner`` multiple plus the remainder (the
    invariant the JAX engine's window decomposition states)."""
    if k_inner > 1 and kw > k_inner and kw % k_inner:
        return [kw - kw % k_inner, kw % k_inner]
    return [kw]


def backend_time_block(backend) -> int:
    """Effective in-kernel temporal depth of a backend (1 unless the
    backend carries ``time_block``)."""
    return int(getattr(backend, "time_block", 1) or 1)


def normalize_fuse(fuse_steps: Optional[int], steps: int,
                   max_fuse: Optional[int] = None) -> int:
    """The fusion window that runs: the request clamped to the loop length
    (and ``max_fuse``), never rounded — ``fuse_steps`` is the host-sync /
    ``between``-hook cadence and is honored exactly."""
    steps = int(steps)
    if steps <= 0:
        return 1
    if fuse_steps is None:
        fuse = steps
    else:
        fuse = int(fuse_steps)
        if fuse < 1:
            raise ValueError("fuse_steps must be >= 1")
    fuse = min(fuse, steps)
    if max_fuse is not None:
        fuse = min(fuse, max_fuse)
    return fuse


def launch_steps(steps: int, fuse_steps: Optional[int], k: int) -> Tuple[int, int, int]:
    """(steps run by K3 launches, steps run singly, windows) of a loop of
    ``steps`` in windows of ``fuse_steps`` at temporal depth ``k``: each
    window of ``kw`` steps is ``kw // k`` K3 launches and ``kw % k``
    single steps (all single when ``k`` is 1), as ``TimeloopEngine`` runs
    it."""
    steps = int(steps)
    if steps <= 0:
        return 0, 0, 0
    fuse = normalize_fuse(fuse_steps, steps)
    blocked = single = 0
    for kw, n in ((fuse, steps // fuse), (steps % fuse, 1)):
        m, r = divmod(kw, k) if k > 1 else (0, kw)
        blocked += n * m * k
        single += n * r
    return blocked, single, -(-steps // fuse)


def hopper_plans(kernel: _ir.StencilIR, halos, interior_shape, backend,
                 swap: Optional[Tuple[str, str]] = None):
    """The plans a hopper engine runs: the window's plan and the single-step
    plan that runs a window's remainder (``kw mod k`` steps, on K3's tile
    and the same layout buffers); both the same plan when ``time_block``
    is 1.  Raises ``ValueError`` for a geometry the kernels cannot take."""
    from repro_torch.kernels.stencil import codegen as _codegen
    plan = _codegen.plan_cuda(kernel, halos, interior_shape, backend, swap=swap)
    if plan.time_block == 1:
        return plan, plan
    be1 = dataclasses.replace(backend, time_block=1, block=plan.B)
    return plan, _codegen.plan_cuda(kernel, halos, interior_shape, be1,
                                    swap=swap)


def normalize_swap(kernel: _ir.StencilIR,
                   swap: Optional[Tuple[str, str]]) -> Optional[Tuple[str, str]]:
    """Validate and orient a swap pair as (written, other)."""
    if swap is None:
        return None
    a, b = swap
    params = set(kernel.grid_params)
    for g in (a, b):
        if g not in params:
            raise ValueError(f"swap grid '{g}' is not a kernel parameter")
    outs = set(kernel.output_grids())
    wr = [g for g in (a, b) if g in outs]
    if len(wr) != 1:
        raise ValueError(
            f"swap pair {swap} must contain exactly one output grid "
            f"(outputs: {sorted(outs)})")
    written = wr[0]
    other = b if written == a else a
    return (written, other)


def _rotate(arrays: Dict[str, torch.Tensor], swap) -> Dict[str, torch.Tensor]:
    out = dict(arrays)
    out[swap[0]], out[swap[1]] = out[swap[1]], out[swap[0]]
    return out


class TimeloopEngine:
    """Backend-specific fused windows for one (kernel, geometry).

    ``run(arrays, scalars, steps, fuse_steps, between)`` executes ``steps``
    applications of the kernel (+ buffer rotation when ``swap`` is set) in
    fusion windows of ``fuse_steps`` and returns the final arrays dict
    (after each step the ``swap`` names trade buffers).
    """

    def __init__(self, kernel: _ir.StencilIR,
                 halos: Mapping[str, Tuple[int, ...]],
                 interior_shape: Tuple[int, ...],
                 backend,
                 swap: Optional[Tuple[str, str]] = None,
                 profile_cb: Optional[Callable[[str, float], None]] = None,
                 batch: int = 0,
                 differentiable: bool = False):
        self.kernel = kernel
        self.halos = {g: tuple(h) for g, h in halos.items()}
        self.interior = tuple(interior_shape)
        self.backend = backend
        self.swap = normalize_swap(kernel, swap)
        self.batch = int(batch)
        if self.batch < 0:
            raise ValueError("batch must be >= 0 (0 = unbatched)")
        self.differentiable = bool(differentiable)
        # the grids a window writes: outputs, and the swap pair that
        # trades buffers with them
        self.touched = tuple(g for g in kernel.grid_params
                             if g in set(kernel.output_grids()) | set(self.swap or ()))
        self._profile_cb = profile_cb
        self._windows: Dict[int, Callable] = {}
        self._plan = self._plan1 = None
        self.time_block = 1
        if backend.kind == "hopper":
            self._plan, self._plan1 = hopper_plans(kernel, self.halos,
                                                   self.interior, backend,
                                                   self.swap)
            self.time_block = self._plan.time_block
        elif backend.kind != "torch":
            raise ValueError(f"timeloop: unsupported backend {backend.kind}")

    def _add(self, phase: str, dt: float) -> None:
        if self._profile_cb is not None:
            self._profile_cb(phase, dt)

    def _window(self, kw: int) -> Callable:
        fn = self._windows.get(kw)
        if fn is None:
            fn = lowering.lower_torch_window(self.kernel, self.halos,
                                             self.interior, None, self.swap,
                                             kw, batch=self.batch)
            self._windows[kw] = fn
        return fn

    def launch_scalars(self, scalars: Mapping[str, object], device):
        """``scalars`` in the form a window takes them, rounded to f32 as
        in the JAX package: 0-d tensors (torch backend) or floats (hopper);
        under ``batch=B`` each a ``(B,)`` tensor (torch) or one ``(B, NS)``
        array on the card (hopper: ``CudaPlan.scenario_scalars``), a float
        or a 0-d value shared by the scenarios."""
        if self._plan is None:
            return scalar_tensors(scalars, device, self.batch)
        if not self.batch:                  # the kernels take f32 by value
            return {n: float(np.float32(float(v))) for n, v in scalars.items()}
        scal = scalar_tensors(scalars, "cpu", self.batch)     # checks the counts
        return self._plan.scenario_scalars(scal, self.batch, device)

    def check_batch(self, arrays: Mapping[str, torch.Tensor]) -> None:
        """Raise unless every grid carries the engine's scenario axis (none
        when unbatched)."""
        nd = len(self.interior)
        for g, a in arrays.items():
            if self.batch and (a.dim() != nd + 1 or a.shape[0] != self.batch):
                raise ValueError(
                    f"batched timeloop: grid '{g}' must carry a leading "
                    f"scenario axis of {self.batch} (got {tuple(a.shape)})")
            if not self.batch and a.dim() != nd:
                raise ValueError(f"grid '{g}' has {a.dim()} axes; an unbatched "
                                 f"timeloop of a {nd}D kernel takes {nd}")

    def window_arrays(self, kw: int) -> Callable:
        """``fn(arrays, scalars) -> arrays``: one fused window of ``kw``
        steps that leaves its arguments as they were (the grids it writes
        get buffers of their own; a grid it does not write is passed on),
        ``scalars`` in ``launch_scalars``'s form.  On the hopper backend the
        layout round trip and the leapfrog name parity are folded in, so it
        maps full (grid-halo'd) arrays to full arrays on every backend.
        The carry surface of the adjoint (``core/adjoint.py``): its forward
        pass and its replay run these windows on the engine's kernels.
        Unlike ``run``, no profiling, host sync or traffic count happens
        here."""
        def fn(arrays, scal):
            return self._apply_window(dict(arrays), scal, kw, fresh=True)
        return fn

    def window_for(self, steps: int, fuse_steps: Optional[int] = None) -> int:
        """The fusion-window size that actually runs for this request
        (see ``normalize_fuse``); idempotent."""
        return normalize_fuse(fuse_steps, steps)

    def run(self, arrays: Dict[str, torch.Tensor],
            scalars: Mapping[str, object],
            steps: int,
            fuse_steps: Optional[int] = None,
            between: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        """Advance the grids ``steps`` applications and return the final
        buffers (same keys as ``arrays``; the tensors are advanced in
        place, unless the engine is ``differentiable``).  ``scalars`` are
        rounded to f32; under ``batch=B`` each is a float (shared) or
        ``(B,)`` values.  ``between(t, arrays) -> arrays`` runs at every
        window boundary before the last."""
        fuse = self.window_for(steps, fuse_steps)
        arrays = dict(arrays)
        self.check_batch(arrays)
        device = next(iter(arrays.values())).device
        scal = self.launch_scalars(scalars, device)
        t = 0
        while t < steps:
            kw = min(fuse, steps - t)
            t0 = time.perf_counter()
            arrays = self._apply_window(arrays, scal, kw,
                                        fresh=self.differentiable, count=True)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            self._add("kernel", time.perf_counter() - t0)
            t += kw
            if between is not None and t < steps:
                arrays = between(t, arrays) or arrays
        return arrays

    def _apply_window(self, arrays, scal, kw, fresh: bool = False,
                      count: bool = False):
        """One window of ``kw`` steps.  ``fresh``: the caller's tensors are
        not written (``window_arrays``); ``count``: profile the layout stage
        and count the window's traffic (``run``)."""
        if self._plan is None:
            if fresh:
                arrays = {g: (a.clone() if g in self.touched else a)
                          for g, a in arrays.items()}
            return self._window(kw)(arrays, scal)
        plan, swap, k = self._plan, self.swap, self.time_block
        t0 = time.perf_counter()
        padded = plan.to_padded(arrays, fresh)   # ONE layout cut/grid/window
        if count:
            self._add("layout", time.perf_counter() - t0)
            plan.count_window(kw, self.batch)
        m, r = divmod(kw, k) if k > 1 else (0, kw)
        if m:
            spares = plan.make_spares(padded)
            for _ in range(m):
                # K3 writes into the spares; the buffers just read become
                # the next launch's spares.  k rotations net to k mod 2,
                # applied to the names of both, so every name keeps a
                # spare carrying its own halo
                out = plan.step(padded, scal, spares=spares)
                spares = {g: padded[g] for g in plan.step_out_grids}
                padded = out
                if swap and k % 2:
                    padded = _rotate(padded, swap)
                    spares = _rotate(spares, swap)
        for _ in range(r):
            padded = self._plan1.step(padded, scal)
            if swap:
                padded = _rotate(padded, swap)
        # the layout buffers rotated kw times; apply the same parity to the
        # full arrays so halos travel with their buffers, then write the
        # layout interiors back
        if swap and kw % 2:
            arrays = _rotate(arrays, swap)
        return plan.from_padded(padded, arrays, fresh)


def run_timeloop(kernel: _ir.StencilIR,
                 arrays: Dict[str, torch.Tensor],
                 scalars: Mapping[str, object],
                 steps: int,
                 *,
                 halos: Mapping[str, Tuple[int, ...]],
                 interior_shape: Tuple[int, ...],
                 backend,
                 swap: Optional[Tuple[str, str]] = None,
                 fuse_steps: Optional[int] = None,
                 between: Optional[Callable] = None,
                 batch: int = 0) -> Dict[str, torch.Tensor]:
    """One-shot convenience wrapper (builds a fresh engine)."""
    eng = TimeloopEngine(kernel, halos, interior_shape, backend, swap=swap,
                         batch=batch)
    return eng.run(dict(arrays), scalars, steps, fuse_steps, between)
