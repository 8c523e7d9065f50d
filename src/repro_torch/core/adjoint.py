"""Adjoint wave propagation: a checkpointed backward pass for the fused
time loop (the counterpart of the JAX package's ``core/adjoint.py``).

Inversion workloads (FWI / RTM: what seismic users of high-order stencils
run) need gradients of a ``steps``-long leapfrog recursion with respect to
the initial grids, the coefficient grids (the velocity model) and the
scalars.  Reverse mode through the windows as they run would keep every
step's carry and every tap's temporaries; this module keeps ≈ ⌈√T⌉ carries
instead, over the engine's own fusion windows:

  forward   — a ``torch.autograd.Function`` over the window sequence of
              ``TimeloopEngine`` (its own windows, ``engine.window_arrays``:
              on the hopper backend the CUDA kernels K1/K2/K3/K5), run
              without autograd, keeping the carry at every ``stride``-th
              window start.  A grid no window writes (a velocity model, a
              damping mask) is the same tensor in every carry: shared, not
              copied.
  backward  — per checkpoint segment, newest first: REPLAY the segment's
              windows from its checkpoint on the engine's windows (the
              same kernels, so bit for bit the forward pass's carries);
              then, window by window in reverse, replay the window one
              step at a time on the engine (one kernel launch a step,
              ``window_arrays(1)``), keeping one carry a step, and pull
              the cotangent back through the trailing ``between`` hook and
              then through each step.

Each step's cotangent goes through the torch reference lowering
(``lowering.lower_torch_window(fresh=True)``, one step), linearized at the
replayed carry: autograd RECOMPUTES the step's graph and takes its VJP, one
step at a time.  This is the JAX design: there ``pallas_call`` defines no
VJP and the cotangent chain runs through the xla reference window at the
carries the kernels replay; here the CUDA kernels define no backward and
the chain runs through the torch lowering, whose arithmetic the kernels
are held against.  Batched engines differentiate per scenario: ``(B,
...)`` grids and ``(B,)`` scalars receive per-scenario cotangents.

Peak backward memory: ⌈W/stride⌉ checkpoints + one segment of replayed
window carries (≤ stride) + one window of per-step carries (≤ fuse) + one
step's graph; with the default schedule (fuse ≈ ⌈√T⌉) every term but the
last is O(√T) carries.

Masked (serving) windows, ``domain_mask`` / ``step_limits`` on a batched
torch engine, differentiate through ``lowering.lower_torch_window_masked``,
whose ``torch.where`` freeze makes the adjoint freeze masked cells and
budget-exhausted scenarios too.

``resilient_grad`` drives the same schedule one restartable unit at a time
with its state on disk (``run_resilient(..., loss=)``): a failure anywhere,
mid-backward included, resumes from the latest snapshot, bit for bit the
result of ``differentiable_run``.

``between`` hooks run at the same window boundaries as
``TimeloopEngine.run``, as ``between(t, arrays) -> arrays``, and are
differentiated as part of the window chain: a hook must compute with torch
operations and may write in place only the grids a window writes (those
are the window's own new tensors); ``acoustic.inject_source`` adds out of
place when autograd records it.

User entry point: ``st.differentiable_timeloop`` in ``core/dsl.py``.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch


__all__ = ["ceil_sqrt", "window_schedule", "checkpoint_stride",
           "differentiable_run", "resilient_grad", "CHECKPOINT_STATS",
           "SECONDS", "reset_stats"]

#: accounting of the most recent forward/backward pass: ``checkpoints`` is
#: the number of carries kept (the O(√T) bound tests pin),
#: ``replayed_windows``/``vjp_windows`` count the backward pass's work
CHECKPOINT_STATS: Dict[str, int] = {
    "checkpoints": 0, "replayed_windows": 0, "vjp_windows": 0}
#: wall seconds of the same passes, the device synced at each boundary:
#: ``forward`` (the windows and the checkpoints), and the backward pass
#: split into ``replay`` (the engine's windows and steps from the
#: checkpoints), ``recompute`` (autograd recording each step's torch
#: lowering at its replayed carry) and ``vjp`` (the cotangent pulled
#: through it)
SECONDS: Dict[str, float] = {
    "forward": 0.0, "replay": 0.0, "recompute": 0.0, "vjp": 0.0}


def reset_stats() -> None:
    """Zero ``CHECKPOINT_STATS`` and ``SECONDS``."""
    for k in CHECKPOINT_STATS:
        CHECKPOINT_STATS[k] = 0
    for k in SECONDS:
        SECONDS[k] = 0.0


def ceil_sqrt(n: int) -> int:
    """⌈√n⌉ for n ≥ 0 (exact, no float round-trip)."""
    if n <= 0:
        return 0
    return math.isqrt(n - 1) + 1


def window_schedule(steps: int, fuse: int) -> Tuple[Tuple[int, ...],
                                                    Tuple[int, ...]]:
    """(window sizes, window start steps) of a ``steps``-long run driven in
    fusion windows of ``fuse``: the decomposition ``run`` executes."""
    sizes: List[int] = []
    starts: List[int] = []
    t = 0
    while t < steps:
        kw = min(fuse, steps - t)
        sizes.append(kw)
        starts.append(t)
        t += kw
    return tuple(sizes), tuple(starts)


def checkpoint_stride(n_windows: int, steps: int) -> int:
    """Checkpoint thinning: keep the carry every ``stride``-th window start
    so the checkpoint count stays ≈ ⌈√T⌉ even when the window cadence is
    much finer (fuse_steps=1 → T windows).  With the default fuse ≈ ⌈√T⌉
    this is 1 (every window start is a checkpoint)."""
    target = max(1, ceil_sqrt(steps))
    return max(1, -(-n_windows // target))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _AdjointPlan:
    """The window schedule, the checkpoint thinning and the per-window
    primal and adjoint callables of one ``differentiable_run``."""

    def __init__(self, engine, steps, fuse_steps, between, domain_mask,
                 step_limits, checkpoint_stride_windows):
        if not engine.differentiable:
            raise ValueError(
                "the checkpointed adjoint requires TimeloopEngine(..., "
                "differentiable=True): an engine that writes its windows' "
                "inputs cannot keep or replay a carry")
        self.engine = engine
        self.between = between
        self.steps = steps = int(steps)
        self.fuse = engine.window_for(
            steps, ceil_sqrt(steps) if fuse_steps is None else fuse_steps)
        self.sizes, self.starts = window_schedule(steps, self.fuse)
        self.W = len(self.sizes)
        self.stride = (int(checkpoint_stride_windows)
                       if checkpoint_stride_windows
                       else checkpoint_stride(self.W, steps))
        self.n_ckpts = -(-self.W // self.stride) if self.W else 0
        self.masked = domain_mask is not None or step_limits is not None
        if self.masked:
            engine.check_masked()
        self._mask_args = (domain_mask, step_limits)
        self._masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._primal: Dict[int, Callable] = {}
        self._adjoint: Optional[Callable] = None

    def masks(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The masked windows' ``(mask, limits)``, moved to the grids'
        ``device`` once."""
        if self._masks is None:
            self._masks = self.engine.masked_operands(*self._mask_args,
                                                      self.steps, device)
        return self._masks

    def window(self, fn: Callable, start: int) -> Callable:
        """``fn`` (a window of the engine or of the torch lowering) as a
        function of (carry, scalars), the masked operands bound with the
        window's first step ``start``."""
        if not self.masked:
            return fn

        def run(arrays, scalars):
            mask, limits = self.masks(next(iter(arrays.values())).device)
            return fn(arrays, scalars, mask, start, limits)
        return run

    # primal/replay: the engine's own windows (on the hopper backend the
    # CUDA kernels), bit for bit the same carries every time
    def primal_window(self, kw: int) -> Callable:
        fn = self._primal.get(kw)
        if fn is None:
            fn = self._primal[kw] = self.engine.window_arrays(kw, self.masked)
        return fn

    # adjoint: one step of the torch reference lowering, new tensors out
    # (masked: the masked window's step, whose selects freeze the cotangent)
    # on a mesh: per-shard steps, the cotangents through the transposed
    # exchange (``distributed.sharded_step``)
    def adjoint_step(self) -> Callable:
        if self._adjoint is None:
            self._adjoint = self.engine.adjoint_step(self.masked)
        return self._adjoint

    def chain(self, i: int) -> Callable:
        """Window i as a function of (carry, scalars): the engine's fused
        window plus the ``between`` hook at its trailing boundary, the
        exact per-window step ``engine.run`` executes."""
        kw, t1 = self.sizes[i], self.starts[i] + self.sizes[i]
        win = self.window(self.primal_window(kw), self.starts[i])
        hook = self.hook(t1)

        def fn(arrays, scalars):
            out = dict(win(arrays, scalars))
            return dict(hook(out)) if hook is not None else out
        return fn

    def hook(self, t: int) -> Optional[Callable]:
        """The ``between`` hook at step boundary ``t`` as a function of the
        carry (None where it does not run: no hook, or the last step)."""
        if self.between is None or t >= self.steps:
            return None
        return lambda arrays: self.between(t, dict(arrays))

    def normalize_scalars(self, scalars) -> Dict[str, torch.Tensor]:
        """Each scalar a tensor (floats as f32; a floating tensor keeps its
        type), ``(B,)`` under ``batch=B`` (a shared value broadcast: its
        gradient sums over the scenarios)."""
        out = {}
        for n, v in ({} if scalars is None else scalars).items():
            t = torch.as_tensor(v)
            if not t.is_floating_point():
                t = t.to(torch.float32)
            if self.engine.batch:
                t = t.reshape(-1).expand(self.engine.batch)
            out[n] = t
        return out

    def primal_scalars(self, scal: Dict[str, torch.Tensor], device):
        """The scalars as the engine's windows take them: the tensors
        themselves on the torch backend, f32 values for the kernels."""
        if self.engine.exec_kind == "torch":
            return {n: v.detach().to(device) for n, v in scal.items()}
        return self.engine.launch_scalars({n: v.detach().cpu() for n, v in scal.items()},
                                          device)

    def vjp_window(self, i: int, carry, scal, pscal, cot, need):
        """Pull ``cot`` backward through window i from its start carry:
        replay the window a step at a time on the engine (``pscal``: the
        scalars as its windows take them), then the hook's VJP and each
        step's, newest first.  ``need``: the grids and scalars whose
        cotangents are wanted.  Returns (carry cotangent, scalar
        cotangents)."""
        device = next(iter(carry.values())).device
        kw, start = self.sizes[i], self.starts[i]
        t0 = time.perf_counter()
        carries = [carry]
        for s in range(kw):
            carries.append(self.window(self.primal_window(1), start + s)(
                carries[-1], pscal))
        _sync(device)
        SECONDS["replay"] += time.perf_counter() - t0
        d_scal = {n: torch.zeros_like(v) for n, v in scal.items()}
        hook = self.hook(start + kw)
        if hook is not None:
            cot, _ = self._vjp(lambda x, s: hook(x), carries[kw], {}, cot, need)
        for s in reversed(range(kw)):
            adj = self.window(self.adjoint_step(), start + s)
            cot, gs = self._vjp(adj, carries[s], scal, cot, need)
            carries[s + 1] = None
            for n in gs:
                d_scal[n] = d_scal[n] + gs[n]
        return cot, d_scal

    def backward_segment(self, seg: int, ckpt, scal, pscal, cot, g_scal, need):
        """Checkpoint segment ``seg`` of the backward pass: replay its
        windows from ``ckpt`` (its first window's start carry) on the
        engine's windows, then pull ``cot`` back through each window,
        newest first, adding the scalar cotangents to ``g_scal``.  Returns
        (carry cotangent, scalar cotangents)."""
        device = next(iter(ckpt.values())).device
        first = seg * self.stride
        last = min(first + self.stride, self.W)
        # bit for bit the forward pass's window carries: the same windows
        t0 = time.perf_counter()
        carries = [ckpt]
        for i in range(first, last - 1):
            carries.append(self.chain(i)(carries[-1], pscal))
            CHECKPOINT_STATS["replayed_windows"] += 1
        _sync(device)
        SECONDS["replay"] += time.perf_counter() - t0
        g_scal = dict(g_scal)
        for i in reversed(range(first, last)):
            cot, gs = self.vjp_window(i, carries[i - first], scal, pscal, cot, need)
            carries[i - first] = None
            for n in gs:
                g_scal[n] = g_scal[n] + gs[n]
            CHECKPOINT_STATS["vjp_windows"] += 1
        return cot, g_scal

    @staticmethod
    def _vjp(fn, carry, scal, cot, need):
        """(carry cotangent, scalar cotangents) of ``fn(carry, scal)`` at
        ``carry``, of the grids and scalars in ``need``: autograd records
        ``fn`` (the recompute), then pulls ``cot`` through it (the VJP)."""
        device = next(iter(carry.values())).device
        with torch.enable_grad():
            x = {g: c.detach().requires_grad_(g in need and c.is_floating_point())
                 for g, c in carry.items()}
            s = {n: v.detach().requires_grad_(n in need) for n, v in scal.items()}
            t0 = time.perf_counter()
            y = fn(x, s)
            _sync(device)
            t1 = time.perf_counter()
            outs = [g for g in y if y[g].requires_grad]
            ins = [t for t in (*x.values(), *s.values()) if t.requires_grad]
            grads = torch.autograd.grad([y[g] for g in outs], ins,
                                        [cot[g] for g in outs], allow_unused=True)
            _sync(device)
            SECONDS["recompute"] += t1 - t0
            SECONDS["vjp"] += time.perf_counter() - t1
        got = dict(zip([id(t) for t in ins], grads))

        def grad_of(t, like):
            g = got.get(id(t))
            return torch.zeros_like(like) if g is None else g
        return ({g: grad_of(x[g], c) for g, c in carry.items() if g in need},
                {n: grad_of(s[n], v) for n, v in scal.items() if n in need})


class _Adjoint(torch.autograd.Function):
    """The window sequence with its checkpointed backward pass."""

    @staticmethod
    def forward(ctx, plan, names, snames, *tensors):
        arrays = dict(zip(names, tensors[:len(names)]))
        scal = dict(zip(snames, tensors[len(names):]))
        device = tensors[0].device
        pscal = plan.primal_scalars(scal, device)
        t0 = time.perf_counter()
        ckpts = []
        carry = dict(arrays)
        for i in range(plan.W):
            if i % plan.stride == 0:
                ckpts.append(carry)
            carry = plan.chain(i)(carry, pscal)
        _sync(device)
        SECONDS["forward"] += time.perf_counter() - t0
        CHECKPOINT_STATS["checkpoints"] = len(ckpts)
        ctx.plan, ctx.names, ctx.snames = plan, names, snames
        ctx.ckpts, ctx.pscal = ckpts, pscal
        ctx.scal = {n: v.detach().to(device) for n, v in scal.items()}
        ctx.scal_like = [torch.empty((), dtype=v.dtype, device=v.device)
                         for v in scal.values()]
        return tuple(carry[g] for g in names)

    @staticmethod
    def backward(ctx, *cots):
        plan, names, snames, ckpts = ctx.plan, ctx.names, ctx.snames, ctx.ckpts
        wants = ctx.needs_input_grad[3:]
        # the cotangents wanted: the grids the windows write (they carry the
        # others' cotangents) and every input that asks for one
        need = {g for g, w in zip(names, wants) if w} | set(plan.engine.touched)
        need |= {n for n, w in zip(snames, wants[len(names):]) if w}
        cot = {g: (torch.zeros_like(ckpts[0][g]) if c is None else c)
               for g, c in zip(names, cots) if g in need}
        g_scal = {n: torch.zeros_like(v) for n, v in ctx.scal.items()}
        for seg in reversed(range(plan.n_ckpts)):
            cot, g_scal = plan.backward_segment(seg, ckpts[seg], ctx.scal, ctx.pscal,
                                                cot, g_scal, need)
            ckpts[seg] = None
        ctx.ckpts = None
        return (None, None, None, *[cot[g] if g in need else None for g in names],
                *[g_scal[n].to(like) if n in need else None
                  for n, like in zip(snames, ctx.scal_like)])


def differentiable_run(engine,
                       steps: int,
                       fuse_steps: Optional[int] = None,
                       between: Optional[Callable] = None,
                       *,
                       domain_mask=None,
                       step_limits=None,
                       checkpoint_stride_windows: Optional[int] = None
                       ) -> Callable:
    """Differentiable counterpart of ``TimeloopEngine.run``.

    Returns ``fn(arrays, scalars) -> arrays`` computing the window sequence
    ``engine.run(arrays, scalars, steps, fuse_steps, between)`` executes,
    writing none of its arguments, and differentiable by autograd with the
    O(√T) checkpointed backward pass of the module docstring.  Gradients
    flow to every grid in ``arrays`` (initial wavefields and coefficient
    grids riding in the carry) and to every scalar given as a floating
    tensor that requires grad.

    ``fuse_steps=None`` picks the adjoint default ⌈√steps⌉ (the memory-
    optimal single-level schedule) instead of ``run``'s whole-loop default;
    pass it explicitly to pin a ``between``-hook cadence.
    ``checkpoint_stride_windows`` overrides the checkpoint thinning.
    ``domain_mask`` / ``step_limits`` select the masked serving windows
    (batched torch engines only; ``ValueError`` otherwise), constants of
    the differentiation: a frozen cell's cotangent passes through.

    The engine must be built with ``differentiable=True``, so that its
    windows never write their inputs.

    Example::

        eng = TimeloopEngine(k.ir, halos, shape, st.hopper(), swap=("v", "u"),
                             differentiable=True)
        fn = differentiable_run(eng, steps=100)
        out = fn(arrays, {"a": a})             # a: a tensor, requires_grad
        (out["v"] ** 2).sum().backward()
    """
    steps = int(steps)
    if steps <= 0:
        def identity(arrays, scalars=None):
            return dict(arrays)
        identity.schedule = {"windows": (), "starts": (), "stride": 1,
                             "checkpoints": 0, "fuse": 1}
        return identity

    plan = _AdjointPlan(engine, steps, fuse_steps, between, domain_mask,
                        step_limits, checkpoint_stride_windows)

    def fn(arrays: Dict[str, torch.Tensor], scalars=None):
        names = list(arrays)
        scal = plan.normalize_scalars(scalars)
        tensors = [torch.as_tensor(arrays[g]) for g in names]
        engine.check_batch(dict(zip(names, tensors)))
        outs = _Adjoint.apply(plan, names, list(scal), *tensors, *scal.values())
        return dict(zip(names, outs))

    fn.schedule = {"windows": plan.sizes, "starts": plan.starts,
                   "stride": plan.stride, "checkpoints": plan.n_ckpts,
                   "fuse": plan.fuse}
    return fn


def _seed(loss: Callable, carry, need):
    """(loss value, its gradient on the grids in ``need``) at ``carry``:
    the cotangent the backward pass starts from (zeros where the loss does
    not read a grid)."""
    with torch.enable_grad():
        x = {g: c.detach().requires_grad_(g in need) for g, c in carry.items()}
        value = loss(x)
        ins = [g for g in x if x[g].requires_grad]
        grads = torch.autograd.grad(value, [x[g] for g in ins], allow_unused=True)
    got = dict(zip(ins, grads))
    return value.detach(), {g: (torch.zeros_like(carry[g]) if got.get(g) is None
                                else got[g]) for g in carry if g in need}


def resilient_grad(engine,
                   arrays: Dict[str, torch.Tensor],
                   scalars,
                   steps: int,
                   loss: Callable,
                   *,
                   fuse_steps: Optional[int] = None,
                   between: Optional[Callable] = None,
                   domain_mask=None,
                   step_limits=None,
                   checkpoint_stride_windows: Optional[int] = None,
                   ckpt_dir: str,
                   ckpt_every: int = 1,
                   max_failures: int = 3,
                   injector=None,
                   watchdog=None,
                   on_restart: Optional[Callable] = None) -> Dict[str, object]:
    """Fault-tolerant checkpointed gradient: the value of ``loss(final
    arrays)`` and its gradient with respect to every floating grid of
    ``arrays`` and every scalar, through the same schedule as
    ``differentiable_run`` (the JAX package's ``resilient_grad``), driven
    one restartable unit at a time by
    ``train.fault_tolerance.run_with_restarts``.

    The units: one fusion window per forward step (the checkpoints ride in
    the saved state), one step seeding the cotangent with the gradient of
    ``loss``, then one checkpoint segment per backward step
    (``_AdjointPlan.backward_segment``: replay up to ``stride`` windows,
    pull the cotangent through each in reverse).  A failure anywhere,
    mid-backward included, resumes from the latest snapshot and gives the
    same bits: the units run the same windows and steps in the same order
    as ``differentiable_run`` and a ``backward()`` through it.

    The saved state: the forward carry, each checkpoint's grids that a
    window writes (a grid no window writes, such as a velocity model, is
    the carry's and is saved once), the cotangents, the scalar cotangents
    and the value (f64, so an f32 or f64 loss keeps its bits).  The JAX
    package saves every grid in every checkpoint slot.

    Returns ``{"value", "grad_arrays", "grad_scalars"}``; needs
    ``TimeloopEngine(..., differentiable=True)``.
    """
    from repro_torch.train import fault_tolerance as _ft

    steps = int(steps)
    init_arrays = {g: torch.as_tensor(a) for g, a in arrays.items()}
    engine.check_batch(init_arrays)
    names = list(init_arrays)
    device = init_arrays[names[0]].device
    need = {g for g, a in init_arrays.items() if a.is_floating_point()}
    plan = _AdjointPlan(engine, steps, fuse_steps, between, domain_mask,
                        step_limits, checkpoint_stride_windows)
    if steps <= 0:
        value, cot = _seed(loss, init_arrays, need)
        return {"value": value, "grad_arrays": cot,
                "grad_scalars": {n: torch.zeros_like(v) for n, v in
                                 plan.normalize_scalars(scalars).items()}}
    W, stride, n_ckpts = plan.W, plan.stride, plan.n_ckpts
    scal = plan.normalize_scalars(scalars)
    pscal = plan.primal_scalars(scal, device)
    scal = {n: v.detach().to(device) for n, v in scal.items()}
    need |= set(engine.touched) | set(scal)
    written = [g for g in names if g in engine.touched]

    # a constant structure: every unit saves the same tree, so any snapshot
    # restores into the template of any unit
    def init_fn():
        return {"carry": dict(init_arrays),
                "ckpts": [{g: torch.zeros_like(init_arrays[g]) for g in written}
                          for _ in range(n_ckpts)],
                "cot": {g: torch.zeros_like(init_arrays[g]) for g in names if g in need},
                "g_scal": {n: torch.zeros_like(v) for n, v in scal.items()},
                "value": torch.zeros((), dtype=torch.float64, device=device)}

    def step_fn(state, wi):
        state = dict(state)
        if wi < W:                                   # forward window wi
            if wi % stride == 0:
                ckpts = list(state["ckpts"])
                ckpts[wi // stride] = {g: state["carry"][g] for g in written}
                state["ckpts"] = ckpts
            t0 = time.perf_counter()
            state["carry"] = plan.chain(wi)(state["carry"], pscal)
            _sync(device)
            SECONDS["forward"] += time.perf_counter() - t0
        elif wi == W:                                # seed the cotangent
            CHECKPOINT_STATS["checkpoints"] = n_ckpts
            value, state["cot"] = _seed(loss, state["carry"], need)
            state["value"] = value.to(torch.float64)
        else:                                        # backward segment
            seg = n_ckpts - 1 - (wi - W - 1)
            slot = state["ckpts"][seg]
            ckpt = {g: slot.get(g, state["carry"][g]) for g in names}
            state["cot"], state["g_scal"] = plan.backward_segment(
                seg, ckpt, scal, pscal, state["cot"], state["g_scal"], need)
        return state

    final = _ft.run_with_restarts(
        init_fn=init_fn, step_fn=step_fn, n_steps=W + 1 + n_ckpts,
        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, max_failures=max_failures,
        injector=injector, watchdog=watchdog, on_restart=on_restart)
    return {"value": final["value"], "grad_arrays": final["cot"],
            "grad_scalars": final["g_scal"]}
