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
            per grid per window in ``codegen.PAD_COUNT``), then one CUDA
            kernel launch per step on the layout buffers
            (``CudaPlan.step``), then the write-back of the touched grids'
            interiors (``CudaPlan.from_padded``).  A window is a Python loop
            of kernel launches on the current stream.

In place: ``run`` advances the tensors of the ``arrays`` dict it is given
(the output and swap grids' buffers); the returned dict holds those tensors
under the rotated names.  Callers that need the initial state clone first.
"""
from __future__ import annotations

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
                 profile_cb: Optional[Callable[[str, float], None]] = None):
        self.kernel = kernel
        self.halos = {g: tuple(h) for g, h in halos.items()}
        self.interior = tuple(interior_shape)
        self.backend = backend
        self.swap = normalize_swap(kernel, swap)
        self._profile_cb = profile_cb
        self._windows: Dict[int, Callable] = {}
        self._plan = None
        if backend.kind == "hopper":
            from repro_torch.kernels.stencil import codegen as _codegen
            self._plan = _codegen.plan_cuda(kernel, self.halos, self.interior,
                                            backend, swap=self.swap)
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
                                             kw)
            self._windows[kw] = fn
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
        place).  ``scalars`` are rounded to f32.  ``between(t, arrays) ->
        arrays`` runs at every window boundary before the last."""
        fuse = self.window_for(steps, fuse_steps)
        arrays = dict(arrays)
        device = next(iter(arrays.values())).device
        if self._plan is not None:      # the kernels take f32 by value
            scal = {n: float(np.float32(float(v))) for n, v in scalars.items()}
        else:
            scal = scalar_tensors(scalars, device)
        t = 0
        while t < steps:
            kw = min(fuse, steps - t)
            t0 = time.perf_counter()
            arrays = self._run_window(arrays, scal, kw)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            self._add("kernel", time.perf_counter() - t0)
            t += kw
            if between is not None and t < steps:
                arrays = between(t, arrays) or arrays
        return arrays

    def _run_window(self, arrays, scal, kw):
        if self._plan is None:
            return self._window(kw)(arrays, scal)
        plan, swap = self._plan, self.swap
        t0 = time.perf_counter()
        padded = plan.to_padded(arrays)          # ONE layout cut/grid/window
        self._add("layout", time.perf_counter() - t0)
        plan.count_window(kw)
        for _ in range(kw):
            padded = plan.step(padded, scal)
            if swap:
                padded = _rotate(padded, swap)
        # the layout buffers rotated kw times; apply the same parity to the
        # full arrays so halos travel with their buffers, then write the
        # layout interiors back
        if swap and kw % 2:
            arrays = _rotate(arrays, swap)
        return plan.from_padded(padded, arrays)


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
                 between: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """One-shot convenience wrapper (builds a fresh engine)."""
    eng = TimeloopEngine(kernel, halos, interior_shape, backend, swap=swap)
    return eng.run(dict(arrays), scalars, steps, fuse_steps, between)
