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

In place: a grid's ``data`` tensor is updated in place by ``st.map`` and
``st.timeloop`` (output grids, and the swap pair's buffers), by
``interior = ...`` and by ``randomize``; ``copy()`` clones.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional, Tuple

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
    halo-padded shape; a tensor's device is kept when ``device`` is None."""

    def __init__(self, dtype: _DType = f32, shape: Tuple[int, ...] = (),
                 order: int = 0, data=None, batch: Optional[int] = None,
                 device=None):
        if batch:
            raise not_ported("st.grid(batch=B)",
                             "queue 1, item 4 (batch=B scenario axis)")
        self.shape = tuple(shape)
        self.order = int(order)
        self.batch = None
        self.dtype = dtype.dtype if isinstance(dtype, _DType) else dtype
        full = tuple(s + 2 * self.order for s in self.shape)
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
        """Per-axis halo width, ``(order,) * ndim``."""
        return (self.order,) * len(self.shape)

    @property
    def _interior_idx(self):
        o = self.order
        return tuple(slice(o, o + s) for s in self.shape)

    @property
    def interior(self) -> _torch.Tensor:
        """View of the halo-free interior; assigning writes into ``data``
        in place (cast to the grid dtype), leaving the halo untouched."""
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
        vals = scale * rng.standard_normal(self.shape)
        self.interior = _torch.from_numpy(
            np.asarray(vals, dtype=_NP_DTYPE.get(self.dtype, np.float32)))
        return self

    def copy(self) -> "grid":
        """Deep copy: backends update ``data`` in place, so the copy clones
        the tensor to keep the state for a reference run."""
        g = grid.__new__(grid)
        g.shape, g.order, g.dtype, g.batch = (self.shape, self.order,
                                              self.dtype, None)
        g.data = self.data.clone()
        return g

    def __repr__(self):
        return (f"st.grid(shape={self.shape}, order={self.order}, "
                f"dtype={self.dtype}, device={self.data.device})")


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

    ``template`` gmem/smem/f4 run the fused-step kernel (one thread per
    interior point, taps from global memory); shift/unroll run the 2.5D
    streaming kernel (a ring of halo'd planes in shared memory along axis
    0).  ``block`` is the tile in points, ``(b0, b1, b2)`` in 3D or
    ``(b0, b1)`` in 2D: the thread block covers ``b1 × b2`` (2D: ``b1``)
    points and the streaming kernel walks ``b0`` planes per block.
    ``mem_type`` is accepted for compatibility with the paper's knob.
    """
    kind: str = "hopper"
    template: str = "gmem"
    block: Optional[Tuple[int, ...]] = None
    mem_type: Optional[str] = None
    time_block: int = 1

    def __post_init__(self):
        if self.template not in _TEMPLATES:
            raise ValueError(f"unknown template {self.template!r}")
        if self.template == "semi":
            raise not_ported("template 'semi'", "kernel K5 (semi-stencil)")
        if int(self.time_block) < 1:
            raise ValueError("time_block must be >= 1")
        if int(self.time_block) > 1:
            raise not_ported("time_block > 1",
                             "kernel K3 (in-kernel temporal blocking)")


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

    def add(self, phase: str, dt: float):
        self.profile[phase] = self.profile.get(phase, 0.0) + dt


_CTX = _Ctx()


@dataclasses.dataclass
class LaunchResult:
    """What a launched target returns: the target's own return ``value``
    and ``profile``, phase name → accumulated seconds (``codegen``,
    ``layout``, ``kernel``, ``total``)."""
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
    place.  Runs under ``st.torch()``; the per-application CUDA kernel (K4)
    is not ported yet."""
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
    return grids, scalars


def scalar_tensors(scalars, device) -> Dict[str, _torch.Tensor]:
    """Scalars arrive as f32 (0-d tensors on ``device``), as in the JAX
    package."""
    return {n: _torch.tensor(float(np.float32(float(v))), dtype=_torch.float32,
                             device=device)
            for n, v in scalars.items()}


def _apply_kernel(k: Kernel, args, begin, end):
    grids, scalars = _bind_args(k, args)
    interior = next(iter(grids.values())).shape
    region = None
    if begin is not None:
        region = tuple((int(b), int(e)) for b, e in zip(begin, end))
        if region == tuple((0, s) for s in interior):
            region = None
    backend = _CTX.backend if _CTX.active else torch_backend()
    if backend.kind != "torch":
        raise not_ported(f"st.map under the {backend.kind} backend",
                         "kernel K4 (per-application st.map kernels)")
    key = ("map", backend.cache_key(),
           tuple(sorted((n, g.shape, g.order, str(g.dtype))
                        for n, g in grids.items())), region)
    fn = k._cache.get(key)
    if fn is None:
        t0 = time.perf_counter()
        fn = _lowering.lower_torch(k.ir, {n: g.halo for n, g in grids.items()},
                                   interior, region)
        _CTX.add("codegen", time.perf_counter() - t0)
        k._cache[key] = fn
    device = next(iter(grids.values())).device
    t0 = time.perf_counter()
    fn({n: g.data for n, g in grids.items()}, scalar_tensors(scalars, device))
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
        if batch:
            raise not_ported("st.timeloop(batch=B)",
                             "queue 1, item 4 (batch=B scenario axis)")
        self.steps = int(steps)
        self.swap = tuple(swap) if swap is not None else None
        self.fuse_steps = fuse_steps
        self.between = between

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
    the buffer that holds its name under the rotation convention."""
    return _TimeloopCall(steps, swap=swap, fuse_steps=fuse_steps,
                         between=between, batch=batch)


def _run_timeloop(k: Kernel, args, call: _TimeloopCall) -> TimeloopResult:
    from . import timeloop as _tl

    grids, scalars = _bind_args(k, args)
    interior = next(iter(grids.values())).shape
    backend = _CTX.backend if _CTX.active else torch_backend()
    swap = _tl.normalize_swap(k.ir, call.swap)
    fuse = call.fuse_steps
    if fuse is None and _CTX.active:
        fuse = _CTX.fuse_steps
    if fuse is not None:
        fuse = max(1, int(fuse))

    key = ("timeloop", backend.cache_key(),
           tuple(sorted((n, g.shape, g.order, str(g.dtype))
                        for n, g in grids.items())), swap)
    engine = k._cache.get(key)
    if engine is None:
        t0 = time.perf_counter()
        engine = _tl.TimeloopEngine(
            k.ir, {n: g.halo for n, g in grids.items()}, interior, backend,
            swap=swap, profile_cb=_CTX.add if _CTX.active else None)
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


def differentiable_timeloop(*args, **kw):
    """Differentiable fused time stepping: not ported yet."""
    raise not_ported("st.differentiable_timeloop", "queue 1, item 6 (adjoint)")


# --------------------------------------------------------------------------
# launch
# --------------------------------------------------------------------------
class _Launcher:
    def __init__(self, backend: Backend, fuse_steps: Optional[int] = None):
        self.backend = backend
        self.fuse_steps = fuse_steps

    def __call__(self, tgt: Callable):
        def run(*args, **kw) -> LaunchResult:
            prev = (_CTX.backend, _CTX.profile, _CTX.active, _CTX.fuse_steps)
            _CTX.backend, _CTX.profile, _CTX.active = self.backend, {}, True
            _CTX.fuse_steps = self.fuse_steps
            t0 = time.perf_counter()
            try:
                value = tgt(*args, **kw)
            finally:
                prof = _CTX.profile
                prof["total"] = time.perf_counter() - t0
                (_CTX.backend, _CTX.profile, _CTX.active,
                 _CTX.fuse_steps) = prev
            return LaunchResult(value=value, profile=prof)
        return run


def launch(backend: Backend = None, mesh=None, profile: bool = True,
           fuse_steps: Optional[int] = None,
           time_block: Optional[int] = None,
           autotune: bool = False, **autotune_kw) -> _Launcher:
    """Run a ``@st.target`` under ``backend`` (default ``st.torch()``).
    ``fuse_steps`` sets the default fusion window of every ``st.timeloop``
    inside the target.  ``mesh``, ``time_block > 1`` and ``autotune`` are
    not ported yet and raise."""
    del profile
    if mesh is not None:
        raise not_ported("st.launch(mesh=...)", "queue 1, item 9 (distributed)")
    if time_block is not None and int(time_block) != 1:
        raise not_ported("st.launch(time_block=k)",
                         "kernel K3 (in-kernel temporal blocking)")
    if autotune or autotune_kw:
        raise not_ported("st.launch(autotune=...)",
                         "queue 1, item 5 (cost model + autotuner)")
    return _Launcher(backend or torch_backend(), fuse_steps=fuse_steps)
