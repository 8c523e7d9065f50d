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
  distributed — (``TimeloopEngine(mesh=)``) a window is
            ``distributed.lower_distributed_window`` on the mesh's shards:
            depth-k exchange groups (k = ``time_steps`` × the inner's
            ``time_block``) of slab copies and per-shard passes of the
            inner's per-application kernel (hopper: K4 on regions) or of
            the torch lowering.  The state lives in the shards across
            windows; it is gathered into the caller's tensors before a
            ``between`` hook and at the end of ``run``, and scattered again
            after a hook.

Scenarios (``batch=B``): every grid carries a leading axis of B
independent scenarios, advanced together: the torch window indexes the
spatial axes after it, and each hopper launch advances all B (the kernels'
``blockIdx.z`` walks the scenarios' tiles).  Scalars are floats (shared)
or ``(B,)`` values (one a scenario).  A batched torch engine also runs
*masked* windows for shape-bucketed serving
(``lowering.lower_torch_window_masked``, ``run(domain_mask=,
step_limits=)``): a per-scenario spatial mask freezes cells outside a
request's true sub-domain and a per-scenario step budget freezes finished
scenarios, both exactly.  The kernels take no mask, as the JAX package's
Pallas kernels take none: masked windows need the torch backend.

In place: ``run`` advances the tensors of the ``arrays`` dict it is given
(the output and swap grids' buffers); the returned dict holds those tensors
under the rotated names.  Callers that need the initial state clone first
(``run_resilient`` does).  An engine built with ``differentiable=True``
never writes the caller's tensors: each window writes buffers of its own
(``window_arrays``, the carries of the adjoint, ``core/adjoint.py``), and a
grid no window writes is passed on as it is.  Masked windows write new
tensors too.

``run_resilient`` drives the engine one restartable window at a time with
checkpoints on disk (``train/checkpoint.py``, ``train/fault_tolerance.py``),
bit for bit the uninterrupted run.
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
    """Effective in-kernel temporal depth of a backend: the knob rides on
    the backend itself for hopper, on the ``inner`` for distributed
    wrappers, and is 1 everywhere else (the engine and the distributed
    lowering read it here, so they agree on the exchange depth)."""
    if getattr(backend, "kind", "") == "distributed":
        backend = getattr(backend, "inner", None)
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
                 differentiable: bool = False,
                 mesh=None):
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
        self._windows: Dict[Tuple[int, bool], Callable] = {}
        self._plan = self._plan1 = None
        self.time_block = 1
        # what runs the steps: the backend, or a distributed backend's inner
        self.exec_kind = backend.kind
        self.mesh = None
        if backend.kind == "hopper":
            self._plan, self._plan1 = hopper_plans(kernel, self.halos,
                                                   self.interior, backend,
                                                   self.swap)
            self.time_block = self._plan.time_block
        elif backend.kind == "distributed":
            from . import distributed as _dist
            if mesh is None:
                raise ValueError("distributed backend requires launch(mesh=...)")
            if self.swap is None:
                raise ValueError("distributed timeloop requires swap=(a, b)")
            self.mesh, self.exec_kind = mesh, backend.inner.kind
            self.time_block = backend_time_block(backend)
            self._dwins: Dict[tuple, object] = {}
            self._layouts: Dict[int, object] = {}
            # validates the geometry (divisibility, axes, depth) now
            _dist.window_depth(kernel, self.interior, backend, mesh, self.swap, 1)
        elif backend.kind != "torch":
            raise ValueError(f"timeloop: unsupported backend {backend.kind}")

    def _add(self, phase: str, dt: float) -> None:
        if self._profile_cb is not None:
            self._profile_cb(phase, dt)

    def _window(self, kw: int, masked: bool = False) -> Callable:
        """The torch window of ``kw`` steps; ``masked``: the serving variant
        ``fn(arrays, scalars, mask, start, limits)`` (batched torch
        engines only)."""
        fn = self._windows.get((kw, masked))
        if fn is None:
            if masked:
                self.check_masked()
                fn = lowering.lower_torch_window_masked(
                    self.kernel, self.halos, self.interior, self.swap, kw,
                    batch=self.batch)
            else:
                fn = lowering.lower_torch_window(self.kernel, self.halos,
                                                 self.interior, None, self.swap,
                                                 kw, batch=self.batch)
            self._windows[(kw, masked)] = fn
        return fn

    def distributed_window(self, kw: int, fuse: Optional[int] = None,
                           masked: bool = False):
        """The sharded window of ``kw`` steps (``distributed.
        DistributedWindow``) in a run of windows of ``fuse`` (default
        ``kw``): the windows of one run share the shards' tensors, padded
        for the widest exchange of a window of ``fuse``."""
        from . import distributed as _dist
        depth = _dist.window_depth(self.kernel, self.interior, self.backend,
                                   self.mesh, self.swap, fuse or kw, masked)
        win = self._dwins.get((kw, masked, depth))
        if win is None:
            layout = self._layouts.get(depth)
            if layout is None:
                layout = self._layouts[depth] = _dist.window_layout(
                    self.kernel, self.interior, self.backend, self.mesh,
                    self.swap, depth, self.batch)
            win = self._dwins[(kw, masked, depth)] = _dist.lower_distributed_window(
                self.kernel, self.interior, self.backend, self.mesh, self.swap,
                kw, batch=self.batch, masked=masked, layout=layout)
        return win

    def adjoint_step(self, masked: bool = False) -> Callable:
        """One step of the torch lowering that the adjoint differentiates
        (new tensors out): the fresh window of one step, the masked
        window's step, or on a mesh ``distributed.sharded_step`` (per-shard
        VJPs and the transposed exchange)."""
        if self.mesh is not None:
            from . import distributed as _dist
            return _dist.sharded_step(self.kernel, self.interior, self.backend,
                                      self.mesh, self.swap, self.batch, masked)
        if masked:
            return lowering.lower_torch_window_masked(
                self.kernel, self.halos, self.interior, self.swap, 1,
                batch=self.batch)
        return lowering.lower_torch_window(self.kernel, self.halos, self.interior,
                                           None, self.swap, 1, batch=self.batch,
                                           fresh=True)

    def check_masked(self) -> None:
        """Raise ``ValueError`` unless the engine can run masked windows
        (batched, torch backend or a distributed one with a torch
        inner)."""
        if not self.batch or self.exec_kind != "torch":
            raise ValueError(
                "domain_mask / step_limits require a batched torch timeloop "
                "(the serving path; the kernels take no mask)")

    def masked_operands(self, domain_mask, step_limits, steps: int, device):
        """``(mask, limits)`` of a masked run on ``device``: the bool mask
        ``(B,) + interior`` (all True when None) and the int step budgets
        ``(B,)`` (``steps`` each when None).  Raises ``ValueError`` unless
        the engine is batched torch and the shapes fit."""
        self.check_masked()
        full = (self.batch,) + self.interior
        if domain_mask is None:
            mask = torch.ones(full, dtype=torch.bool, device=device)
        else:
            mask = torch.as_tensor(domain_mask, dtype=torch.bool, device=device)
            if tuple(mask.shape) != full:
                raise ValueError(f"domain_mask must have shape {full} "
                                 f"(got {tuple(mask.shape)})")
        if step_limits is None:
            limits = torch.full((self.batch,), int(steps), dtype=torch.int32,
                                device=device)
        else:
            limits = torch.as_tensor(step_limits, dtype=torch.int32, device=device)
            if tuple(limits.shape) != (self.batch,):
                raise ValueError(f"step_limits must have shape ({self.batch},) "
                                 f"(got {tuple(limits.shape)})")
        return mask, limits

    def launch_scalars(self, scalars: Mapping[str, object], device):
        """``scalars`` in the form a window takes them, rounded to f32 as
        in the JAX package: 0-d tensors (torch backend) or floats (hopper);
        under ``batch=B`` each a ``(B,)`` tensor (torch) or one ``(B, NS)``
        array on the card (hopper: ``CudaPlan.scenario_scalars``), a float
        or a 0-d value shared by the scenarios.  On a mesh:
        ``distributed.shard_scalars``."""
        if self.mesh is not None:
            from . import distributed as _dist
            return _dist.shard_scalars(self.exec_kind, scalars, device, self.batch)
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

    def window_arrays(self, kw: int, masked: bool = False) -> Callable:
        """``fn(arrays, scalars) -> arrays``: one fused window of ``kw``
        steps that leaves its arguments as they were (the grids it writes
        get buffers of their own; a grid it does not write is passed on),
        ``scalars`` in ``launch_scalars``'s form (masked: ``fn(arrays,
        scalars, mask, start, limits)``, ``masked_operands``'s tensors and
        the window's first step).  On the hopper backend the layout round
        trip and the leapfrog name parity are folded in, so it maps full
        (grid-halo'd) arrays to full arrays on every backend.  The carry
        surface of the adjoint (``core/adjoint.py``): its forward pass and
        its replay run these windows on the engine's kernels.  Unlike
        ``run``, no profiling, host sync or traffic count happens here."""
        if self.mesh is not None:
            return self.distributed_window(kw, kw, masked)
        if masked:
            return self._window(kw, masked=True)

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
            between: Optional[Callable] = None,
            *,
            domain_mask=None,
            step_limits=None) -> Dict[str, torch.Tensor]:
        """Advance the grids ``steps`` applications and return the final
        buffers (same keys as ``arrays``; the tensors are advanced in
        place, unless the engine is ``differentiable`` or the run masked).
        ``scalars`` are rounded to f32; under ``batch=B`` each is a float
        (shared) or ``(B,)`` values.  ``between(t, arrays) -> arrays`` runs
        at every window boundary before the last.

        ``domain_mask`` (bool, ``(B,) + interior``: False cells keep their
        values) and ``step_limits`` (``(B,)``: scenario ``b`` stops after
        ``step_limits[b]`` applications) select the masked serving windows;
        they need a batched torch engine (``ValueError`` otherwise) and go
        to the grids' device once a run."""
        fuse = self.window_for(steps, fuse_steps)
        arrays = dict(arrays)
        self.check_batch(arrays)
        device = next(iter(arrays.values())).device
        scal = self.launch_scalars(scalars, device)
        masked = domain_mask is not None or step_limits is not None
        if masked:
            mask, limits = self.masked_operands(domain_mask, step_limits, steps,
                                                device)
        if self.mesh is not None:
            return self._run_distributed(arrays, scal, steps, fuse, between,
                                         *((mask, limits) if masked else (None, None)))
        t = 0
        while t < steps:
            kw = min(fuse, steps - t)
            t0 = time.perf_counter()
            if masked:
                arrays = self._window(kw, masked=True)(arrays, scal, mask, t, limits)
            else:
                arrays = self._apply_window(arrays, scal, kw,
                                            fresh=self.differentiable, count=True)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            self._add("kernel", time.perf_counter() - t0)
            t += kw
            if between is not None and t < steps:
                arrays = between(t, arrays) or arrays
        return arrays

    def _sync_mesh(self) -> None:
        for d in dict.fromkeys(self.mesh.devices.flat):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _run_distributed(self, arrays, scal, steps, fuse, between, mask, limits):
        """``run`` on a mesh: the state scattered into the shards once, the
        windows advanced there, gathered before each ``between`` hook (and
        scattered again after it) and at the end, into the caller's tensors
        (new tensors when the engine is differentiable).  Profile phases:
        ``kernel`` (the windows), ``gather`` and ``scatter``."""
        masked = mask is not None
        main = self.distributed_window(fuse, fuse, masked)
        t0 = time.perf_counter()
        st = main.scatter(arrays)
        self._sync_mesh()
        self._add("scatter", time.perf_counter() - t0)
        t = 0
        while t < steps:
            kw = min(fuse, steps - t)
            win = main if kw == fuse else self.distributed_window(kw, fuse, masked)
            t0 = time.perf_counter()
            win.advance(st, scal, mask, t, limits)
            self._sync_mesh()
            self._add("kernel", time.perf_counter() - t0)
            t += kw
            if between is not None and t < steps:
                t0 = time.perf_counter()
                arrays = main.gather(st, arrays, self.touched, self.differentiable)
                self._sync_mesh()
                self._add("gather", time.perf_counter() - t0)
                arrays = between(t, arrays) or arrays
                t0 = time.perf_counter()
                main.layout.scatter(st.bufs, arrays, self.kernel.grid_params)
                self._sync_mesh()
                self._add("scatter", time.perf_counter() - t0)
        t0 = time.perf_counter()
        arrays = main.gather(st, arrays, self.touched, self.differentiable)
        self._sync_mesh()
        self._add("gather", time.perf_counter() - t0)
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
                 mesh=None,
                 batch: int = 0) -> Dict[str, torch.Tensor]:
    """One-shot convenience wrapper (builds a fresh engine; ``mesh`` for a
    distributed backend)."""
    eng = TimeloopEngine(kernel, halos, interior_shape, backend, swap=swap,
                         mesh=mesh, batch=batch)
    return eng.run(dict(arrays), scalars, steps, fuse_steps, between)


def run_resilient(engine: TimeloopEngine,
                  arrays: Dict[str, torch.Tensor],
                  scalars: Mapping[str, object],
                  steps: int,
                  fuse_steps: Optional[int] = None,
                  between: Optional[Callable] = None,
                  *,
                  ckpt_dir: str,
                  ckpt_every: int = 1,
                  max_failures: int = 3,
                  injector=None,
                  watchdog=None,
                  on_restart: Optional[Callable] = None,
                  loss: Optional[Callable] = None):
    """Fault-tolerant timeloop run: checkpoint/restore of the leapfrog
    carry through ``train.checkpoint`` and ``train.fault_tolerance`` (the
    JAX package's ``run_resilient``).

    The run advances one fusion window per restartable step; every
    ``ckpt_every`` windows the whole arrays dict (both swap buffers and the
    coefficient grids) is saved atomically to ``ckpt_dir``.  After a
    failure, or in a fresh process pointed at the same directory, the run
    restores the latest snapshot and resumes at that window boundary.  A
    window replays the same launches on the same carry, so a resumed run
    is bit for bit an uninterrupted ``engine.run``.  ``between`` runs at
    the same window boundaries as in ``engine.run`` (a window is never
    split), so source injections survive restarts; a run that ends at
    ``steps`` does not run the hook at that boundary, so a longer run
    resumed from its last checkpoint lacks the injection there, as in the
    JAX package.

    ``arrays`` are left as they were: the engine advances tensors in place,
    so every start or restart without a checkpoint begins from clones of
    them.  ``on_restart(failures, error)`` is called at each restart
    (``fault_tolerance.run_with_restarts``).

    ``loss`` (a scalar function of the final arrays) makes it a
    fault-tolerant gradient run (``adjoint.resilient_grad``, which needs
    ``differentiable=True``): it returns ``{"value", "grad_arrays",
    "grad_scalars"}`` in place of the final arrays.
    """
    from repro_torch.train import fault_tolerance as _ft

    if loss is not None:
        from . import adjoint as _adj
        return _adj.resilient_grad(
            engine, arrays, scalars, steps, loss, fuse_steps=fuse_steps,
            between=between, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
            max_failures=max_failures, injector=injector, watchdog=watchdog,
            on_restart=on_restart)

    fuse = engine.window_for(steps, fuse_steps)
    n_windows = -(-steps // fuse) if steps > 0 else 0
    init_arrays = dict(arrays)

    def init_fn():
        return {g: a.clone() for g, a in init_arrays.items()}

    def step_fn(state, wi):
        t0 = wi * fuse
        kw = min(fuse, steps - t0)
        out = engine.run(dict(state), scalars, kw, kw)
        t1 = t0 + kw
        if between is not None and t1 < steps:
            out = between(t1, out) or out
        return out

    if n_windows == 0:
        return init_fn()
    return _ft.run_with_restarts(
        init_fn=init_fn, step_fn=step_fn, n_steps=n_windows,
        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, max_failures=max_failures,
        injector=injector, watchdog=watchdog, on_restart=on_restart)
