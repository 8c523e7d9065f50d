"""StencilPy user-facing DSL (paper Table 1 constructs) on PyTorch.

Usage mirrors paper Listing 1::

    from repro_torch.core import dsl as st

    @st.kernel
    def star2d1r(u: st.grid, v: st.grid):
        v.at(0, 0).set(0.5 * u.at(0, 0)
                       + 0.125 * (u.at(-1, 0) + u.at(1, 0))
                       + 0.125 * (u.at(0, -1) + u.at(0, 1)))

    @st.target
    def run(u: st.grid, v: st.grid, iters: st.i32):
        st.timeloop(iters, swap=("v", "u"))(star2d1r)(u, v)

    u = st.grid(dtype=st.f32, shape=(512, 512), order=1).randomize(0)
    v = st.grid(dtype=st.f32, shape=(512, 512), order=1)
    st.launch(backend=st.cuda(template="gmem"))(run)(u, v, 10)

Backends: ``torch`` (plain PyTorch shifted slices, the reference and the
default) and ``hopper`` (hand-written CUDA kernels for sm_90a, see
``repro_torch.kernels.stencil``); ``cuda`` is the paper-compatible alias of
``hopper``.  Grids live on the card unless the caller asks for the CPU
(``device="cpu"``); on a CPU tensor the hopper backend runs its kernels'
plain PyTorch versions.

Scenarios: ``st.grid(..., batch=B)`` holds B independent copies of its
domain along a leading axis, advanced together by ``st.timeloop(...,
batch=B)`` (on the hopper backend one launch a step advances all B).
``st.differentiable_timeloop`` is the adjoint: a function of the grids'
tensors whose gradients autograd computes with O(√steps) checkpoints
(``core/adjoint.py``).

In place: a grid's ``data`` tensor is updated in place by ``st.map`` and
``st.timeloop`` (output grids, and the swap pair's buffers), by
``interior = ...`` and by ``randomize``; ``copy()`` clones.
``st.differentiable_timeloop``'s function writes none of its arguments.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch as _torch

from . import analysis as _analysis
from . import frontend as _frontend
from . import ir as _ir
from . import lowering as _lowering

__all__ = [
    "grid", "kernel", "target", "map", "timeloop", "launch",
    "differentiable_timeloop",
    "f32", "f64", "bf16", "i32", "i64",
    "torch", "torch_backend", "hopper", "cuda", "distributed",
    "Kernel", "LaunchResult", "TimeloopResult", "resolve_device",
]


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error every not-yet-ported feature raises, naming its ROADMAP.md
    item."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md: {item})")


def resolve_device(device=None) -> _torch.device:
    """``None`` means the card: ``"cuda"``.  Raises when no CUDA device is
    present rather than running on the CPU quietly; pass ``device="cpu"``
    to ask for the CPU."""
    if device is None:
        if not _torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU by default but torch finds no "
                "CUDA device; pass device='cpu' to run on the CPU")
        return _torch.device("cuda")
    return _torch.device(device)


# --------------------------------------------------------------------------
# dtype markers
# --------------------------------------------------------------------------
class _DType:
    def __init__(self, name: str, torch_dtype):
        self.name = name
        self.dtype = torch_dtype

    def __repr__(self):
        return f"st.{self.name}"


f32 = _DType("f32", _torch.float32)
f64 = _DType("f64", _torch.float64)
bf16 = _DType("bf16", _torch.bfloat16)
i32 = _DType("i32", _torch.int32)
i64 = _DType("i64", _torch.int64)

_NP_DTYPE = {_torch.float32: np.float32, _torch.float64: np.float64,
             _torch.int32: np.int32, _torch.int64: np.int64}


# --------------------------------------------------------------------------
# grid
# --------------------------------------------------------------------------
class grid:
    """A stencil data grid: ``shape`` interior points + ``order`` halo cells
    on each side of every axis (paper §2.1), held in ``data``, a tensor on
    ``device`` (None: the card).  Also the kernel parameter annotation
    (``u: st.grid``).  ``data`` may be a tensor or an array of the full
    halo-padded shape; a tensor's device is kept when ``device`` is None.

    ``batch=B`` adds a leading *scenario* axis: the grid holds B independent
    copies of the (halo-padded) domain, advanced together by
    ``st.timeloop(..., batch=B)``.  The scenario axis carries no halo."""

    def __init__(self, dtype: _DType = f32, shape: Tuple[int, ...] = (),
                 order: int = 0, data=None, batch: Optional[int] = None,
                 device=None):
        self.shape = tuple(shape)
        self.order = int(order)
        self.batch = int(batch) if batch else None
        self.dtype = dtype.dtype if isinstance(dtype, _DType) else dtype
        full = tuple(s + 2 * self.order for s in self.shape)
        if self.batch:
            full = (self.batch,) + full
        if isinstance(data, _torch.Tensor) and device is None:
            device = data.device
        dev = resolve_device(device)
        if data is not None:
            assert tuple(data.shape) == full, (tuple(data.shape), full)
            self.data = _torch.as_tensor(data, dtype=self.dtype, device=dev)
        else:
            self.data = _torch.zeros(full, dtype=self.dtype, device=dev)

    @property
    def device(self) -> _torch.device:
        """The device ``data`` lives on."""
        return self.data.device

    @property
    def halo(self) -> Tuple[int, ...]:
        """Per-axis halo width, ``(order,) * ndim`` (the scenario axis has
        none)."""
        return (self.order,) * len(self.shape)

    @property
    def _interior_idx(self):
        o = self.order
        idx = tuple(slice(o, o + s) for s in self.shape)
        return ((slice(None),) + idx) if self.batch else idx

    @property
    def interior(self) -> _torch.Tensor:
        """View of the halo-free interior, shape ``([batch,] *shape)``;
        assigning writes into ``data`` in place (cast to the grid dtype),
        leaving the halo untouched."""
        return self.data[self._interior_idx]

    @interior.setter
    def interior(self, value) -> None:
        self.data[self._interior_idx] = _torch.as_tensor(
            value, dtype=self.dtype, device=self.data.device)

    def randomize(self, seed: int = 0, scale: float = 1.0) -> "grid":
        """Fill the interior with ``scale`` × standard-normal noise drawn by
        ``numpy.random.default_rng(seed)``: bit-identical to the JAX
        package's ``grid.randomize``.  Returns this grid."""
        rng = np.random.default_rng(seed)
        shape = ((self.batch,) + self.shape) if self.batch else self.shape
        vals = scale * rng.standard_normal(shape)
        self.interior = _torch.from_numpy(
            np.asarray(vals, dtype=_NP_DTYPE.get(self.dtype, np.float32)))
        return self

    def copy(self) -> "grid":
        """Deep copy: backends update ``data`` in place, so the copy clones
        the tensor to keep the state for a reference run."""
        g = grid.__new__(grid)
        g.shape, g.order, g.dtype, g.batch = (self.shape, self.order,
                                              self.dtype, self.batch)
        g.data = self.data.clone()
        return g

    def __repr__(self):
        b = f", batch={self.batch}" if self.batch else ""
        return (f"st.grid(shape={self.shape}, order={self.order}, "
                f"dtype={self.dtype}{b}, device={self.data.device})")


# --------------------------------------------------------------------------
# kernel
# --------------------------------------------------------------------------
class Kernel:
    """A parsed stencil kernel: the object ``@st.kernel`` returns.

    Holds the kernel's ``ir`` (StencilIR), its static analysis in ``info``
    and a per-(backend, shapes) cache of built callables and engines.
    """

    def __init__(self, fn: Callable):
        self.fn = fn
        self.name = fn.__name__
        t0 = time.perf_counter()
        self.ir: _ir.StencilIR = _frontend.parse_kernel(fn)
        self.frontend_time = time.perf_counter() - t0
        _analysis.check_read_after_write(self.ir)
        self.info: _analysis.StencilInfo = _analysis.analyze(self.ir)
        self._cache: Dict = {}

    def __repr__(self):
        i = self.info
        return (f"<st.kernel {self.name}: {i.ndim}D {i.shape} order={i.order} "
                f"flops/pt={i.flops_per_point}>")


def kernel(fn: Callable) -> Kernel:
    """Decorator parsing a Python stencil function into a :class:`Kernel`
    (through the AST; the function itself never executes)."""
    return Kernel(fn)


def target(fn: Callable) -> Callable:
    """Decorator marking a function that orchestrates stencil calls, for
    ``st.launch``."""
    fn._is_stencil_target = True
    return fn


# --------------------------------------------------------------------------
# backends
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Backend:
    """Base class for backend selectors: an immutable value naming a
    lowering path and carrying its knobs."""
    kind: str = "torch"

    def cache_key(self):
        """Hashable tuple identifying this configuration."""
        return dataclasses.astuple(self)


@dataclasses.dataclass(frozen=True)
class torch_backend(Backend):
    """Plain PyTorch shifted-slice lowering (``core/lowering.py``): the
    reference the CUDA kernels are held against.  Exposed as ``st.torch()``,
    the counterpart of the JAX package's ``st.xla()``."""
    kind: str = "torch"


# ``st.torch()``, the counterpart of the JAX package's ``st.xla()``
torch = torch_backend

_TEMPLATES = ("gmem", "smem", "f4", "shift", "unroll", "semi")


@dataclasses.dataclass(frozen=True)
class hopper(Backend):
    """Hand-written CUDA kernels for sm_90a (``kernels/stencil``).

    In ``st.timeloop``, ``template`` gmem/smem/f4 run the fused-step
    kernel K1 (K4 gmem's build, in place: taps from global memory);
    shift/unroll run the 2.5D streaming kernel K2 (a ring of halo'd planes
    in shared memory along axis 0); semi runs the semi-stencil kernel K5
    (each input plane scattered once into a register ring of partial
    output planes; the kernel must be linear in its taps).  In ``st.map``
    gmem/f4/smem run the per-application kernel K4 (taps from global
    memory; 4 points a thread from aligned float4 rows; a halo'd tile in
    shared memory), shift/unroll and semi the per-application builds of K2
    and K5.  ``time_block=k > 1`` runs the
    temporal-blocking kernel K3 under every template: one launch advances
    ``k`` leapfrog steps of ``st.timeloop`` (a swap pair and one output,
    ``swap[0]``, are required), and a fusion window that is not a multiple
    of ``k`` ends with single steps of the template's kernel.  ``block``
    is the tile in points, ``(b0, b1, b2)`` in 3D or ``(b0, b1)`` in 2D:
    the thread block covers ``b1 × b2`` (2D: ``b1``) points (K4's f4: a
    quarter as many threads, 4 points each), the streaming kernels walk
    ``b0`` planes per block and K1's and K4's threads ``b0`` points each.
    ``mem_type`` (``"registers"`` or ``"vmem"``) is accepted for
    compatibility with the paper's knob; both run the same kernels.
    """
    kind: str = "hopper"
    template: str = "gmem"
    block: Optional[Tuple[int, ...]] = None
    mem_type: Optional[str] = None
    time_block: int = 1

    def __post_init__(self):
        if self.template not in _TEMPLATES:
            raise ValueError(f"unknown template {self.template!r}")
        if int(self.time_block) < 1:
            raise ValueError("time_block must be >= 1")
        if self.mem_type not in (None, "registers", "vmem"):
            raise ValueError(f"mem_type must be 'registers' or 'vmem', got "
                             f"{self.mem_type!r}")


def cuda(computeCapability: str = "", threadsPerBlock: Optional[Tuple[int, ...]] = None,
         template: str = "gmem", **kw) -> hopper:
    """Paper-compat alias: Listing 1's ``st.cuda(...)`` selects the Hopper
    backend (``threadsPerBlock`` → ``block``)."""
    del computeCapability
    return hopper(template=template, block=threadsPerBlock, **kw)


def distributed(*args, **kw):
    """Domain decomposition across cards: not ported yet."""
    raise not_ported("st.distributed", "queue 1, item 9 (distributed)")


# --------------------------------------------------------------------------
# launch context + profiler
# --------------------------------------------------------------------------
class _Ctx(threading.local):
    def __init__(self):
        self.backend: Backend = torch_backend()
        self.profile: Dict[str, float] = {}
        self.active = False
        self.fuse_steps: Optional[int] = None
        self.time_block: Optional[int] = None
        self.autotune: Optional[dict] = None

    def add(self, phase: str, dt: float):
        self.profile[phase] = self.profile.get(phase, 0.0) + dt


_CTX = _Ctx()


@dataclasses.dataclass
class LaunchResult:
    """What a launched target returns: the target's own return ``value``
    and ``profile``, phase name → accumulated seconds (``codegen``,
    ``layout``, ``kernel``, ``autotune``, ``total``)."""
    value: object
    profile: Dict[str, float]


def _sync(device: _torch.device) -> None:
    if device.type == "cuda":
        _torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# map — apply a kernel over a region
# --------------------------------------------------------------------------
class _MapCall:
    def __init__(self, begin=None, end=None, e=None):
        if e is not None:
            begin = tuple(0 for _ in e)
            end = tuple(e)
        self.begin, self.end = begin, end

    def __call__(self, k: Kernel):
        def apply(*args):
            return _apply_kernel(k, args, self.begin, self.end)
        return apply


def map(begin=None, end=None, e=None) -> _MapCall:  # noqa: A001 (paper name)
    """Apply a kernel over an interior region (paper §4.2's ``map``):
    ``st.map(e=u.shape)(k)(u, v)`` sweeps the whole interior,
    ``st.map(begin=..., end=...)`` a sub-box.  Output grids are updated in
    place on the region; every other cell keeps its value.  Under
    ``st.hopper(template=...)`` one application is one launch of a
    hand-written kernel (``codegen.lower_hopper``): gmem/f4/smem run K4,
    shift/unroll K4's streaming kernel (K2's source), semi K5; taps read the
    old values, also of an output grid read off-center, and on CPU grids
    the kernels' plain versions run.  The host syncs after each
    application."""
    return _MapCall(begin=begin, end=end, e=e)


def _bind_args(k: Kernel, args):
    """Split positional args into (grids dict, scalars dict) per the kernel
    signature, checking types and interior-shape consistency."""
    grids: Dict[str, grid] = {}
    scalars: Dict[str, object] = {}
    gi = 0
    for name in k.ir.grid_params:
        g = args[gi]
        if not isinstance(g, grid):
            raise TypeError(f"argument {gi} for '{name}' must be st.grid")
        grids[name] = g
        gi += 1
    for name, _dt in k.ir.scalar_params:
        scalars[name] = args[gi]
        gi += 1
    if gi != len(args):
        raise TypeError(f"{k.name} expects {gi} args, got {len(args)}")
    interior = next(iter(grids.values())).shape
    for g in grids.values():
        if g.shape != interior:
            raise ValueError("all grids in one map must share interior shape")
    if len({g.device for g in grids.values()}) > 1:
        raise ValueError("all grids must live on one device")
    batches = {g.batch for g in grids.values()}
    if len(batches) > 1:
        raise ValueError(
            f"all grids must share the scenario batch dimension "
            f"(got {sorted(b or 0 for b in batches)})")
    return grids, scalars


def scalar_tensors(scalars, device, batch: int = 0) -> Dict[str, _torch.Tensor]:
    """Scalars arrive as f32, as in the JAX package: 0-d tensors on
    ``device``, or under ``batch=B`` ``(B,)`` tensors, each scalar a float
    (shared by the scenarios) or B values (one a scenario)."""
    if not batch:
        return {n: _torch.tensor(float(np.float32(float(v))), dtype=_torch.float32,
                                 device=device)
                for n, v in scalars.items()}
    out = {}
    for n, v in scalars.items():
        t = _torch.as_tensor(v, dtype=_torch.float32).reshape(-1)
        if t.numel() not in (1, batch):
            raise ValueError(f"scalar '{n}': a float or {batch} values (one a "
                             f"scenario), got {t.numel()}")
        out[n] = t.expand(batch).to(device)
    return out


def _apply_kernel(k: Kernel, args, begin, end):
    grids, scalars = _bind_args(k, args)
    if next(iter(grids.values())).batch:
        raise ValueError("st.map does not support batched grids; use "
                         "st.timeloop(..., batch=B)")
    interior = next(iter(grids.values())).shape
    region = None
    if begin is not None:
        region = tuple((int(b), int(e)) for b, e in zip(begin, end))
        if region == tuple((0, s) for s in interior):
            region = None
    backend = _CTX.backend if _CTX.active else torch_backend()
    key = ("map", backend.cache_key(),
           tuple(sorted((n, g.shape, g.order, str(g.dtype))
                        for n, g in grids.items())), region)
    fn = k._cache.get(key)
    if fn is None:
        t0 = time.perf_counter()
        halos = {n: g.halo for n, g in grids.items()}
        if backend.kind == "hopper":
            from repro_torch.kernels.stencil import codegen as _codegen
            fn = _codegen.lower_hopper(k.ir, halos, interior, region,
                                       backend).apply
        else:
            lowered = _lowering.lower_torch(k.ir, halos, interior, region)
            fn = lambda arrays, scal: lowered(  # noqa: E731
                arrays, scalar_tensors(scal, next(iter(arrays.values())).device))
        _CTX.add("codegen", time.perf_counter() - t0)
        k._cache[key] = fn
    device = next(iter(grids.values())).device
    t0 = time.perf_counter()
    fn({n: g.data for n, g in grids.items()}, scalars)
    _sync(device)
    _CTX.add("kernel", time.perf_counter() - t0)
    return None


# --------------------------------------------------------------------------
# timeloop — fused time stepping (kernel application + buffer swap)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class TimeloopResult:
    """Execution report of a ``st.timeloop`` application: ``steps``
    requested, the ``fuse_steps`` window that ran, the number of
    ``windows`` and the wall-clock ``seconds`` including device syncs."""
    steps: int
    fuse_steps: int
    windows: int
    seconds: float

    @property
    def steps_per_s(self) -> float:
        """Time-step throughput, ``steps / seconds`` (inf when untimed)."""
        return self.steps / self.seconds if self.seconds > 0 else float("inf")


class _TimeloopCall:
    def __init__(self, steps: int, swap=None, fuse_steps=None, between=None,
                 batch: int = 0):
        self.steps = int(steps)
        self.swap = tuple(swap) if swap is not None else None
        self.fuse_steps = fuse_steps
        self.between = between
        self.batch = int(batch)

    def __call__(self, k: Kernel):
        def apply(*args) -> TimeloopResult:
            return _run_timeloop(k, args, self)
        return apply


def timeloop(steps: int, swap=None, fuse_steps: Optional[int] = None,
             between=None, batch: int = 0) -> _TimeloopCall:
    """Fused time stepping: ``steps`` applications of the kernel plus the
    leapfrog rotation of the ``swap`` pair, in fusion windows of
    ``fuse_steps`` (default: the whole loop, or the enclosing
    ``st.launch(..., fuse_steps=K)``).  The host syncs, and the optional
    ``between(t, grids)`` hook runs, only at window boundaries.  The grids'
    buffers are advanced in place; after the loop each grid's ``data`` is
    the buffer that holds its name under the rotation convention.

    ``batch=B`` advances B independent scenarios (grids built with
    ``st.grid(..., batch=B)``, scalar params passed as floats or ``(B,)``
    values) together: each scenario equals its own unbatched run exactly,
    and under ``st.hopper`` one launch a step advances all B.  Defaults to
    the grids' own batch dimension when they carry one.  A batched loop
    under ``st.launch(autotune=True)`` is not tuned: it runs the launch's
    backend."""
    return _TimeloopCall(steps, swap=swap, fuse_steps=fuse_steps,
                         between=between, batch=batch)


def _run_timeloop(k: Kernel, args, call: _TimeloopCall) -> TimeloopResult:
    from . import timeloop as _tl

    grids, scalars = _bind_args(k, args)
    interior = next(iter(grids.values())).shape
    grid_batch = next(iter(grids.values())).batch or 0
    if call.batch and grid_batch and call.batch != grid_batch:
        raise ValueError(
            f"st.timeloop(batch={call.batch}) but grids carry "
            f"batch={grid_batch}")
    if call.batch and not grid_batch:
        raise ValueError(
            f"st.timeloop(batch={call.batch}) requires grids built with "
            f"st.grid(..., batch={call.batch})")
    batch = call.batch or grid_batch
    backend = _CTX.backend if _CTX.active else torch_backend()
    swap = _tl.normalize_swap(k.ir, call.swap)
    at_cfg = _CTX.autotune if _CTX.active else None
    tuned_fuse = None
    if at_cfg is not None and swap is not None and not batch and call.steps > 0:
        # st.launch(autotune=...): pick the backend (and default fusion
        # window) by the two-stage search.  The measurement launches inside
        # tune() run under their own _Launcher, whose autotune=None stops
        # recursion.
        from . import autotune as _at
        t0 = time.perf_counter()
        tuned = _at.tune(
            k, grids, iters=at_cfg["iters"], space=at_cfg["space"],
            swap=swap, steps=min(call.steps, at_cfg["steps"]),
            fuse_space=at_cfg["fuse_space"],
            time_block_space=at_cfg["time_block_space"],
            cache_dir=at_cfg["cache_dir"], top_k=at_cfg["top_k"],
            cost_model=at_cfg["cost_model"], scalars=scalars)
        _CTX.add("autotune", time.perf_counter() - t0)
        backend = tuned.backend
        tuned_fuse = tuned.fuse_steps
    tb = _CTX.time_block if _CTX.active else None
    if tb is not None:
        # launch-level override of the in-kernel temporal-blocking depth
        if backend.kind == "hopper":
            backend = dataclasses.replace(backend, time_block=int(tb))
        elif int(tb) != 1:
            # silently running without blocking would let a user believe
            # the depth is active while measuring the plain fused loop
            raise ValueError(f"time_block={tb} requires a hopper backend; "
                             f"got '{backend.kind}'")
    fuse = call.fuse_steps
    if fuse is None and _CTX.active:
        fuse = _CTX.fuse_steps
    if fuse is None:
        fuse = tuned_fuse        # the tuned window, unless overridden
    if fuse is not None:
        fuse = max(1, int(fuse))

    key = ("timeloop", backend.cache_key(),
           tuple(sorted((n, g.shape, g.order, str(g.dtype))
                        for n, g in grids.items())), swap, batch)
    engine = k._cache.get(key)
    if engine is None:
        t0 = time.perf_counter()
        engine = _tl.TimeloopEngine(
            k.ir, {n: g.halo for n, g in grids.items()}, interior, backend,
            swap=swap, profile_cb=_CTX.add if _CTX.active else None,
            batch=batch)
        _CTX.add("codegen", time.perf_counter() - t0)
        k._cache[key] = engine
    fuse = engine.window_for(call.steps, fuse)

    def between_arrays(t, arrays):
        for n, g in grids.items():
            g.data = arrays[n]
        call.between(t, grids)
        return {n: g.data for n, g in grids.items()}

    t0 = time.perf_counter()
    arrays = engine.run({n: g.data for n, g in grids.items()}, scalars,
                        call.steps, fuse,
                        between_arrays if call.between else None)
    seconds = time.perf_counter() - t0
    for n, g in grids.items():
        g.data = arrays[n]
    return TimeloopResult(
        steps=call.steps, fuse_steps=fuse,
        windows=-(-call.steps // fuse) if call.steps else 0,
        seconds=seconds)


def _proxy(g: grid) -> grid:
    """A grid object of ``g``'s geometry whose ``data`` a hook may rebind
    without touching ``g``."""
    p = grid.__new__(grid)
    p.shape, p.order, p.dtype, p.batch = g.shape, g.order, g.dtype, g.batch
    p.data = g.data
    return p


def differentiable_timeloop(k: Kernel, *args,
                            steps: int,
                            swap=None,
                            fuse_steps: Optional[int] = None,
                            between=None,
                            domain_mask=None,
                            step_limits=None,
                            checkpoint_stride: Optional[int] = None,
                            backend=None,
                            mesh=None):
    """Differentiable fused time stepping (the adjoint wave propagator).

    Takes the SAME positional arguments a ``k(u, v, dt, st.timeloop(...))``
    call would (grids then scalars) and returns a function

        fn(arrays: dict[str, torch.Tensor] | None, scal: dict | None) -> dict

    computing ``steps`` fused applications of the kernel (+ leapfrog
    ``swap`` rotation and ``between`` hook) exactly like ``st.timeloop``,
    writing none of its arguments, and differentiable by autograd
    (``torch.autograd.grad``, ``.backward()``) with O(√steps) checkpointed
    recomputation instead of O(steps) stored carries (``core/adjoint.py``).
    Gradients flow to every grid tensor that requires grad (initial
    wavefields and coefficient grids such as a velocity model) and every
    scalar given as a floating tensor that requires grad; batched grids
    differentiate per scenario.

    The positional args fix shapes and types and provide defaults:
    ``fn.arrays`` / ``fn.scalars`` hold the bound initial values, and
    ``fn()`` runs them as they are.  ``fn.schedule`` reports the window and
    checkpoint plan, ``fn.engine`` the engine (built with
    ``differentiable=True``, cached apart from ``st.timeloop``'s).
    ``between(t, grids)`` runs at window boundaries on grid objects of its
    own (the bound grids are not touched) and must compute with torch
    operations, rebinding ``g.data`` or writing in place only the grids the
    kernel writes, e.g. ``acoustic.inject_source``; pass ``fuse_steps=1``
    for a per-step cadence.  The backend comes from ``backend=``, else the
    enclosing ``st.launch`` (default ``st.torch()``).  Under ``st.hopper``
    the forward pass and the backward pass's replay run the engine's CUDA
    kernels; the cotangents run through the torch lowering, one step at a
    time, by design (the kernels define no backward, as ``pallas_call``
    defines no VJP in the JAX package).  ``mesh``, ``domain_mask`` and
    ``step_limits`` are not ported and raise.

    Example::

        fn = st.differentiable_timeloop(k, u, v, c, dt, steps=200,
                                        swap=("v", "u"), backend=st.hopper())
        arrays = {n: a.detach().requires_grad_() for n, a in fn.arrays.items()}
        loss = (fn(arrays)["v"] ** 2).sum()
        loss.backward()              # arrays["c"].grad: the model's gradient
    """
    from . import adjoint as _adj
    from . import timeloop as _tl

    if mesh is not None:
        raise not_ported("st.differentiable_timeloop(mesh=...)",
                         "queue 1, item 9 (distributed)")
    grids, scalars = _bind_args(k, args)
    interior = next(iter(grids.values())).shape
    batch = next(iter(grids.values())).batch or 0
    if backend is None:
        backend = _CTX.backend if _CTX.active else torch_backend()
    swap = _tl.normalize_swap(k.ir, tuple(swap) if swap is not None else None)

    key = ("difftimeloop", backend.cache_key(),
           tuple(sorted((n, g.shape, g.order, str(g.dtype))
                        for n, g in grids.items())), swap, batch)
    engine = k._cache.get(key)
    if engine is None:
        engine = _tl.TimeloopEngine(
            k.ir, {n: g.halo for n, g in grids.items()}, interior, backend,
            swap=swap, batch=batch, differentiable=True)
        k._cache[key] = engine

    between_arrays = None
    if between is not None:
        views = {n: _proxy(g) for n, g in grids.items()}

        def between_arrays(t, arrays):
            for n, g in views.items():
                g.data = arrays[n]
            between(t, views)
            return {n: g.data for n, g in views.items()}

    run = _adj.differentiable_run(
        engine, steps, fuse_steps, between_arrays,
        domain_mask=domain_mask, step_limits=step_limits,
        checkpoint_stride_windows=checkpoint_stride)

    def fn(arrays=None, scal=None):
        if arrays is None:
            arrays = {n: g.data for n, g in grids.items()}
        if scal is None:
            scal = scalars
        return run(arrays, scal)

    fn.arrays = {n: g.data for n, g in grids.items()}
    fn.scalars = dict(scalars)
    fn.schedule = run.schedule
    fn.engine = engine
    return fn


# --------------------------------------------------------------------------
# launch
# --------------------------------------------------------------------------
class _Launcher:
    def __init__(self, backend: Backend, fuse_steps: Optional[int] = None,
                 time_block: Optional[int] = None,
                 autotune: Optional[dict] = None):
        self.backend = backend
        self.fuse_steps = fuse_steps
        self.time_block = time_block
        self.autotune = autotune

    def __call__(self, tgt: Callable):
        def run(*args, **kw) -> LaunchResult:
            prev = (_CTX.backend, _CTX.profile, _CTX.active, _CTX.fuse_steps,
                    _CTX.time_block, _CTX.autotune)
            _CTX.backend, _CTX.profile, _CTX.active = self.backend, {}, True
            _CTX.fuse_steps, _CTX.time_block = self.fuse_steps, self.time_block
            _CTX.autotune = self.autotune
            t0 = time.perf_counter()
            try:
                value = tgt(*args, **kw)
            finally:
                prof = _CTX.profile
                prof["total"] = time.perf_counter() - t0
                (_CTX.backend, _CTX.profile, _CTX.active,
                 _CTX.fuse_steps, _CTX.time_block, _CTX.autotune) = prev
            return LaunchResult(value=value, profile=prof)
        return run


def launch(backend: Backend = None, mesh=None, profile: bool = True,
           fuse_steps: Optional[int] = None,
           time_block: Optional[int] = None,
           autotune: bool = False,
           autotune_space: Optional[List] = None,
           autotune_cache: Optional[str] = None,
           autotune_top_k: Optional[int] = 3,
           autotune_steps: int = 16,
           autotune_iters: int = 1,
           autotune_fuse_space: Sequence[int] = (1, 4, 16),
           autotune_time_block_space: Sequence[int] = (1, 2, 4),
           autotune_cost_model=None) -> _Launcher:
    """Run a ``@st.target`` under ``backend`` (default ``st.torch()``).
    ``fuse_steps`` sets the default fusion window of every ``st.timeloop``
    inside the target.  ``time_block=k`` replaces the temporal-blocking
    depth of a hopper backend for those time loops; under another backend
    a ``k`` other than 1 raises ``ValueError`` rather than run without
    blocking.

    ``autotune=True`` replaces the fixed ``backend`` of each
    ``st.timeloop`` with a swap pair and steps by the winner of the
    two-stage search (``core/autotune.py``) over ``autotune_space``
    (default: ``autotune.default_space``), the kernel's scalars and the
    grids' device: every candidate is ranked by predicted cost, only the
    ``autotune_top_k`` cheapest (``None``: all) are measured over
    ``min(steps, autotune_steps)`` steps, ``autotune_iters`` times each,
    and the result is cached in-process and, with ``autotune_cache``, on
    disk.  The tuned fusion window applies unless ``fuse_steps`` (or the
    time loop's own) overrides it; ``time_block`` still applies on top of
    the tuned backend.  The tune's seconds are the profile's
    ``autotune`` phase.  ``mesh`` is not ported yet and raises."""
    del profile
    if mesh is not None:
        raise not_ported("st.launch(mesh=...)", "queue 1, item 9 (distributed)")
    at_cfg = None
    if autotune:
        at_cfg = {"space": autotune_space, "cache_dir": autotune_cache,
                  "top_k": autotune_top_k, "steps": int(autotune_steps),
                  "iters": int(autotune_iters),
                  "fuse_space": tuple(autotune_fuse_space),
                  "time_block_space": tuple(autotune_time_block_space),
                  "cost_model": autotune_cost_model}
    return _Launcher(backend or torch_backend(), fuse_steps=fuse_steps,
                     time_block=time_block, autotune=at_cfg)
