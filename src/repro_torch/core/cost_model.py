"""Analytical cost model for autotune candidates: predict, don't measure.

The counterpart of the JAX package's ``core/cost_model.py``.  A
candidate's cost is roofline time over its modeled traffic plus a
per-window overhead (the JAX formula)::

    seconds ≈ (steps · bytes_per_step + windows · bytes_per_window)
              / bytes_per_s  +  windows · overhead_s

where the traffic terms are geometry, never measurements:

  * hopper candidates — the engine's plans are constructed (never built:
    no ``nvcc``) and charged ``plan.hbm_bytes_per_step()`` a step plus
    ``plan.layout_bytes_per_window()`` a window.  With ``time_block=k`` a
    window's remainder (``kw mod k`` steps) runs the single-step plan,
    charged at its own bytes and rate.  A plan that raises ``ValueError``
    (a tile over 227 KB of shared memory, a kernel semi cannot take, …)
    predicts ``inf``.
  * torch candidates — the shifted-slice lowering's reads and writes are
    counted from the IR (``torch_step_bytes``): each elementwise operation
    reads its full-size operands and writes its result.

``(bytes_per_s, overhead_s)`` is a ``Rate`` per execution class
(``exec_key``: ``torch``, or ``hopper-<kernel family>``, since each family
runs at its own share of its bound on the card) and dtype.  It is
calibrated once per process by the JAX package's protocol: a fully fused
run and a run of one window a step (K3: one launch a window) of the same
loop, whose difference in windows gives the overhead and whose fused time
gives the rate against this model's own bytes; ``st.map`` classes time
single applications at two sizes instead.  The probe runs the tuned
kernel on a crop of the tuned grids' own values, at most ``PROBE`` cells
an axis (on the card each grid is then larger than the 50 MB L2), so a
rate is keyed ``<class>@<kernel fingerprint>@<probe shape>/<dtype>``: on
this card one kernel family's share of its bound differs between kernels
(K2 is the fastest build of ``star3d4r`` and 1.12–1.43× slower than K1 on
acoustic ISO, whose division takes a slow path on mostly-zero fields), so
a rate probed on another stencil ranks the builds of this one wrongly.
Every class's probe sources are built in one ``nvcc`` wave.  Rates persist
next to the autotune disk cache (``roofline-v{CALIBRATION_VERSION}-{device
tag}.json``).  ``CostModel(calibrate=False)`` never probes and uses
``DEFAULT_RATES`` (deterministic: what the tests rank with); a calibrating
model raises when a probe fails.

The model's job is ranking: ``autotune.tune`` measures only the ``top_k``
cheapest predicted candidates.  Distributed pricing (the JAX ``link``
rates) waits for the distributed layer: ``predict`` on a mesh raises.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import sys
import tempfile
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from . import dsl as st
from . import ir as _ir
from . import timeloop as _tl

__all__ = ["CALIBRATION_VERSION", "Rate", "DEFAULT_RATES", "CostModel",
           "default_model", "reset_default_models", "exec_key",
           "kernel_fingerprint", "device_tag", "torch_step_bytes",
           "rate_key"]

#: bump when the prediction formula or the probe protocol changes:
#: persisted calibrations (and disk tune entries, which key on this via
#: ``autotune._disk_key``) then miss and re-derive
CALIBRATION_VERSION = 1

#: probe geometry: at most this many interior cells an axis and the steps
#: of a fused probe, by device type and rank; ``small`` is the second size
#: of the ``st.map`` probe
PROBE = {"cuda": {3: (256, 256, 256), 2: (4096, 4096)},
         "cpu": {3: (12, 16, 20), 2: (32, 32)}}
PROBE_SMALL = {3: (8, 8, 16), 2: (16, 16)}
PROBE_STEPS = {"cuda": 16, "cpu": 6}

# recursion limit while a kernel's IR repr is taken (box3d4r's nests 729
# binary operations)
_REPR_DEPTH = 20000

# the backend each class is probed with: the template's default tile, K3
# at k=2
_CLASS_BACKENDS = {
    "torch": st.torch(), "torch-map": st.torch(),
    "hopper-K1": st.hopper(template="gmem"),
    "hopper-K2": st.hopper(template="shift"),
    "hopper-K3": st.hopper(template="shift", time_block=2),
    "hopper-K5": st.hopper(template="semi"),
    "hopper-K4-gmem": st.hopper(template="gmem"),
    "hopper-K4-f4": st.hopper(template="f4"),
    "hopper-K4-smem": st.hopper(template="smem"),
    "hopper-K2-map": st.hopper(template="shift"),
    "hopper-K5-map": st.hopper(template="semi"),
}


def kernel_fingerprint(kernel: st.Kernel) -> str:
    """Content hash of a kernel: name + its StencilIR repr (the JAX
    package's; equal for the same kernel in both packages).  Editing the
    kernel body changes the fingerprint, invalidating disk entries.  The
    repr of a 729-tap box nests deeper than Python's default recursion
    limit (the JAX package raises ``RecursionError`` for ``box3d4r``), so
    the limit is raised while it is taken."""
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, _REPR_DEPTH))
    try:
        text = f"{kernel.name}:{kernel.ir!r}"
    finally:
        sys.setrecursionlimit(limit)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def device_tag(device) -> str:
    """``cpu``, or the card's name and compute capability (for example
    ``NVIDIA_H100_80GB_HBM3-sm90``): calibrations and tune entries of one
    card do not serve another."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    cc = torch.cuda.get_device_capability(device)
    name = torch.cuda.get_device_name(device).replace(" ", "_")
    return f"{name}-sm{cc[0]}{cc[1]}"


def _device(device) -> torch.device:
    """``st.resolve_device`` with the card's index filled in, so that
    ``cuda`` and ``cuda:0`` name one device."""
    dev = st.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def plan_class(plan) -> str:
    """The execution class of a hopper plan: ``hopper-<kernel family>``."""
    return "hopper-" + plan.kernel_class


def exec_key(backend, swap=None) -> Optional[str]:
    """Calibration class of a backend, which measured rate applies:
    ``torch`` for ``st.torch()`` (``torch-map`` for single applications,
    timed by another protocol), ``hopper-<kernel family>`` for a hopper
    backend (``codegen.kernel_class`` of its template and ``time_block``,
    in ``st.timeloop`` when ``swap`` is given, else ``st.map``).  ``None``:
    no class, the candidate is unpredictable."""
    kind = getattr(backend, "kind", None)
    if kind == "torch":
        return "torch" if swap is not None else "torch-map"
    if kind == "hopper":
        from repro_torch.kernels.stencil import codegen as _codegen
        return "hopper-" + _codegen.kernel_class(
            backend.template, backend.time_block, swap is not None)
    return None


@dataclasses.dataclass(frozen=True)
class Rate:
    """Calibrated execution rate for one (execution class, dtype):
    effective bandwidth against the model's own byte accounting, plus a
    fixed per-dispatch overhead charged once per fusion window."""
    bytes_per_s: float
    overhead_s: float


#: rates of a model that does not calibrate (``calibrate=False``); a
#: calibrating model never falls back to them.  The time-loop classes' and
#: torch's are ``star3d4r``'s calibration (256³ f32 probe) on an NVIDIA
#: H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase 10; K3's overhead is
#: the solve's floor); the ``st.map`` classes' bandwidths are its modeled
#: bytes at 512³ over its phase-3 kernel times, with torch's overhead.
DEFAULT_RATES: Dict[str, Rate] = {
    "torch": Rate(2.61e12, 4.9e-5), "torch-map": Rate(2.61e12, 4.9e-5),
    "hopper-K1": Rate(1.51e12, 7.7e-5), "hopper-K2": Rate(2.88e12, 9.3e-5),
    "hopper-K3": Rate(1.00e12, 1e-8), "hopper-K5": Rate(1.63e12, 4.0e-5),
    "hopper-K4-gmem": Rate(1.94e12, 4.9e-5), "hopper-K4-f4": Rate(1.97e12, 4.9e-5),
    "hopper-K4-smem": Rate(1.99e12, 4.9e-5),
    "hopper-K2-map": Rate(3.58e12, 4.9e-5), "hopper-K5-map": Rate(1.97e12, 4.9e-5),
}


def _dtype_name(dtype) -> str:
    dtype = getattr(dtype, "dtype", dtype)        # st.f32 -> torch.float32
    return str(dtype).replace("torch.", "")


def torch_step_bytes(kernel: _ir.StencilIR, shape, itemsize: int) -> float:
    """Bytes one application of the torch lowering (``lowering.lower_torch``)
    moves over a region of ``shape``, counted from the IR: a tap is a view
    of its grid, a scalar a 0-d tensor and a constant folds, so only
    operations with a full-size operand move data; each reads its
    full-size operands and writes its result.  A statement's store reads
    its value and writes the grid's region (a bare view is cloned first,
    ``lowering._fill``; a value that is not full-size is broadcast, a
    write only)."""
    n = math.prod(shape)
    cells = 0
    full: Dict[str, bool] = {}
    bare: Dict[str, bool] = {}

    def walk(e) -> bool:
        nonlocal cells
        if isinstance(e, _ir.Tap):
            return True
        if isinstance(e, _ir.LocalRef):
            return full[e.name]
        if isinstance(e, (_ir.Const, _ir.ScalarRef)):
            return False
        ops = ([e.operand] if isinstance(e, _ir.Neg) else
               [e.lhs, e.rhs] if isinstance(e, _ir.BinOp) else list(e.args))
        big = [walk(a) for a in ops]
        if any(big):
            cells += (sum(big) + 1) * n
        return any(big)

    for stmt in kernel.body:
        big = walk(stmt.expr)
        is_view = isinstance(stmt.expr, _ir.Tap) or (
            isinstance(stmt.expr, _ir.LocalRef) and bare[stmt.expr.name])
        if isinstance(stmt, _ir.LocalDef):
            full[stmt.name], bare[stmt.name] = big, is_view
            continue
        if is_view:
            cells += 2 * n
        cells += (2 if big else 1) * n
    return float(cells * itemsize)


class _Probe(NamedTuple):
    """What a calibration runs: the tuned kernel, its grids (values and
    halos), swap pair and scalars."""
    kernel: st.Kernel
    grids: Dict[str, st.grid]
    swap: Optional[Tuple[str, str]]
    scalars: Dict[str, object]


def _scenario0(grids: Dict[str, st.grid], scalars):
    """Scenario 0 of batched grids as unbatched grids (views), and its
    scalars: what a calibration of a batched loop probes."""
    one = {}
    for n, g in grids.items():
        v = st.grid.__new__(st.grid)
        v.shape, v.order, v.dtype, v.batch = g.shape, g.order, g.dtype, None
        v.data = g.data[0]
        one[n] = v
    scal = {n: float(torch.as_tensor(v, dtype=torch.float32).reshape(-1)[0])
            for n, v in (scalars or {}).items()}
    return one, scal


def _probe_shape(probe: _Probe) -> Tuple[int, ...]:
    """The interior a probe runs: the tuned grids' shape, at most
    ``PROBE`` cells an axis for their device."""
    g0 = next(iter(probe.grids.values()))
    cap = PROBE[g0.device.type][len(g0.shape)]
    return tuple(min(s, c) for s, c in zip(g0.shape, cap))


def rate_key(key: str, dtype, probe: Optional[_Probe] = None) -> str:
    """Where a rate is stored: ``<class>[@<kernel fingerprint>@<probe
    shape>]/<dtype>``, the part in brackets naming the kernel and geometry
    ``probe`` runs (a rate of the class alone without it).
    ``CostModel(rates=...)`` takes rates under these keys."""
    if probe is None:
        return f"{key}/{_dtype_name(dtype)}"
    return (f"{key}@{kernel_fingerprint(probe.kernel)}@"
            f"{'x'.join(map(str, _probe_shape(probe)))}/{_dtype_name(dtype)}")


def _atomic_write_json(path: str, obj) -> None:
    """Write ``obj`` to ``path`` through a temporary file in its directory
    and a rename, so readers never see a torn file; an ``OSError`` leaves
    the old file (or none) in place."""
    cdir = os.path.dirname(path)
    os.makedirs(cdir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=cdir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def time_timeloop(kernel, grids, scalars, backend, fuse: int, steps: int,
                  swap, iters: int) -> List[float]:
    """Host seconds of ``iters`` runs of ``steps`` fused steps on copies of
    ``grids`` after one warm-up run (the engine syncs at every window's
    end); the copies are freed on return."""
    gs = {n: g.copy() for n, g in grids.items()}
    args = tuple(gs.values()) + tuple(scalars.values())

    def tgt(*a):
        return st.timeloop(steps, swap=swap, fuse_steps=fuse)(kernel)(*a)

    run = st.launch(backend=backend)
    run(tgt)(*args)
    return [run(tgt)(*args).value.seconds for _ in range(iters)]


def time_map(kernel, grids, scalars, backend, iters: int,
             apps: int = 1) -> List[float]:
    """Host seconds of one ``st.map`` application over the interior (each
    ends in a sync), averaged over runs of ``apps`` applications, for
    ``iters`` runs on copies of ``grids`` after one warm-up application."""
    gs = {n: g.copy() for n, g in grids.items()}
    args = tuple(gs.values()) + tuple(scalars.values())

    def tgt(*a):
        for _ in range(apps):
            st.map(e=a[0].shape)(kernel)(*a)

    run = st.launch(backend=backend)
    run(lambda *a: st.map(e=a[0].shape)(kernel)(*a))(*args)
    return [run(tgt)(*args).profile["kernel"] / apps for _ in range(iters)]


def _crop(grids: Dict[str, st.grid], shape) -> Dict[str, st.grid]:
    """Grids of interior ``shape`` holding the central box of ``grids``
    with its neighbouring cells as halos (copies)."""
    out = {}
    for n, g in grids.items():
        o = g.order
        lo = [(s - p) // 2 for s, p in zip(g.shape, shape)]
        sl = tuple(slice(b, b + p + 2 * o) for b, p in zip(lo, shape))
        out[n] = st.grid(g.dtype, shape, o, data=g.data[sl].clone())
    return out


class CostModel:
    """Deterministic candidate-cost predictor (see the module docstring)
    for grids on ``device`` (None: the card).

    ``cache_dir`` — persist/load calibrated rates next to the autotune
    disk cache.  ``calibrate=False`` — never probe; use ``rates`` then
    ``DEFAULT_RATES`` (the testing configuration).  ``rates`` — pre-seeded
    ``{rate_key(...): Rate}``, taken before any stored or probed rate.
    """

    def __init__(self, cache_dir: Optional[str] = None,
                 calibrate: bool = True,
                 rates: Optional[Dict[str, Rate]] = None,
                 device=None):
        self.cache_dir = cache_dir
        self.calibrate = calibrate
        self.device = _device(device)
        self.tag = device_tag(self.device)
        self._rates: Dict[str, Rate] = dict(rates or {})
        self._plans_memo: Dict = {}
        if cache_dir:
            self._load_rates()

    # -- plans and traffic -------------------------------------------------
    def plans(self, kernel: st.Kernel, halos, interior, backend, swap):
        """The plans a hopper candidate launches (``timeloop.hopper_plans``
        in a time loop, the ``MapPlan`` of one application without
        ``swap``), ``()`` for torch, ``None`` for a geometry the kernels
        cannot take.  Memoized; constructing a plan builds nothing."""
        key = (kernel_fingerprint(kernel),
               tuple(sorted((g, tuple(h)) for g, h in halos.items())),
               tuple(interior), backend.cache_key(),
               tuple(swap) if swap else None)
        if key in self._plans_memo:
            return self._plans_memo[key]
        if backend.kind == "torch":
            out = ()
        elif backend.kind != "hopper":
            raise ValueError(f"cost model: no plans for backend {backend.kind!r}")
        else:
            from repro_torch.kernels.stencil import codegen as _codegen
            try:
                if swap is None:
                    out = (_codegen.lower_hopper(kernel.ir, dict(halos),
                                                 tuple(interior), None, backend),)
                else:
                    out = _tl.hopper_plans(kernel.ir, dict(halos),
                                           tuple(interior), backend, tuple(swap))
            except ValueError:
                out = None
        self._plans_memo[key] = out
        return out

    def step_bytes(self, kernel: st.Kernel, halos, interior, backend,
                   swap, dtype) -> Optional[Tuple[float, float]]:
        """(bytes per time step, bytes per fusion window) of a candidate's
        window plan, from geometry alone.  ``(inf, 0)`` marks an
        infeasible plan; ``None`` a backend the model cannot account."""
        if exec_key(backend, swap) is None:
            return None
        itemsize = torch.empty((), dtype=getattr(dtype, "dtype", dtype)).element_size()
        plans = self.plans(kernel, halos, interior, backend, swap)
        if plans is None:
            return float("inf"), 0.0
        if not plans:
            return torch_step_bytes(kernel.ir, interior, itemsize), 0.0
        return (plans[0].hbm_bytes_per_step(itemsize),
                plans[0].layout_bytes_per_window(itemsize))

    # -- prediction --------------------------------------------------------
    def predict(self, kernel: st.Kernel, grids: Dict[str, st.grid],
                backend, fuse: int, steps: int,
                swap: Optional[Tuple[str, str]],
                mesh=None, scalars=None) -> Optional[float]:
        """Predicted seconds for the quantity the tuner measures: ``steps``
        fused time steps (or one application when ``swap`` is None).
        ``None`` — unpredictable backend; ``inf`` — infeasible candidate.
        ``scalars`` are the kernel's, for a calibration the prediction
        needs.  Batched grids (``batch=B``) move B times the bytes in the
        same launches: traffic × B, plus the windows' overheads, as in the
        JAX package; a calibration probes scenario 0."""
        if mesh is not None:
            raise st.not_ported("cost_model.predict(mesh=...)",
                                "queue 1, item 9 (distributed)")
        if exec_key(backend, swap) is None:
            return None
        g0 = next(iter(grids.values()))
        if g0.device != self.device:
            raise ValueError(f"cost model for {self.device}, grids on {g0.device}")
        batch = max(1, int(g0.batch or 1))
        if g0.batch:
            grids, scalars = _scenario0(grids, scalars)
        interior = tuple(g0.shape)
        halos = {n: g.halo for n, g in grids.items()}
        itemsize = g0.data.element_size()
        plans = self.plans(kernel, halos, interior, backend, swap)
        if plans is None:
            return float("inf")
        probe = _Probe(kernel, grids, swap, dict(scalars or {}))
        if not plans:
            rate = self.rate_for(exec_key(backend, swap), g0.dtype, probe)
            per_step = batch * torch_step_bytes(kernel.ir, interior, itemsize)
            if swap is None:
                return per_step / rate.bytes_per_s + rate.overhead_s
            _, _, windows = _tl.launch_steps(steps, fuse, 1)
            steps = max(1, int(steps))
            return (steps * per_step / rate.bytes_per_s
                    + windows * rate.overhead_s)
        if swap is None:
            plan = plans[0]
            rate = self.rate_for(plan_class(plan), g0.dtype, probe)
            return plan.hbm_bytes_per_step(itemsize) / rate.bytes_per_s + rate.overhead_s
        plan, plan1 = plans
        blocked, single, windows = _tl.launch_steps(max(1, int(steps)),
                                                    max(1, int(fuse)),
                                                    plan.time_block)
        # the window's terms at the class of the plan that runs it: K3, or
        # the single-step plan where no window holds k steps
        wplan = plan if blocked else plan1
        wrate = self.rate_for(plan_class(wplan), g0.dtype, probe)
        seconds = windows * (wplan.layout_bytes_per_window(itemsize, batch)
                             / wrate.bytes_per_s + wrate.overhead_s)
        for p, n in ((plan, blocked), (plan1, single)):
            if n:
                r = self.rate_for(plan_class(p), g0.dtype, probe)
                seconds += n * p.hbm_bytes_per_step(itemsize, batch) / r.bytes_per_s
        return seconds

    # -- rates -------------------------------------------------------------
    def rate_for(self, key: str, dtype, probe: Optional[_Probe] = None) -> Rate:
        """The rate of one execution class × dtype: the stored rate for
        ``probe``'s kernel and geometry (or, without ``probe``, the class
        alone), else a probe of the class when the model calibrates
        (persisted next to the tune cache), else ``DEFAULT_RATES``."""
        rk = rate_key(key, dtype, probe)
        r = self._rates.get(rk)
        if r is not None:
            return r
        if not self.calibrate:
            return DEFAULT_RATES[key]
        if probe is None:
            raise ValueError(f"no rate for {rk}: a calibration needs the "
                             "tuned kernel and grids")
        self.calibrate_classes(probe, [key])
        return self._rates[rk]

    def calibrate_classes(self, probe: _Probe, keys) -> None:
        """Probe every class of ``keys`` that has no rate for ``probe``'s
        kernel and geometry yet, their sources built in one ``nvcc`` wave on
        the card, and persist the rates.  Raises when a probe fails."""
        g0 = next(iter(probe.grids.values()))
        missing = [k for k in dict.fromkeys(keys)
                   if rate_key(k, g0.dtype, probe) not in self._rates]
        if not self.calibrate or not missing:
            return
        big = _crop(probe.grids, _probe_shape(probe))
        small = big if probe.swap is not None else _crop(probe.grids, tuple(
            min(s, c) for s, c in zip(g0.shape, PROBE_SMALL[len(g0.shape)])))
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            sources = []
            for k in missing:
                for gs in ((big,) if small is big else (big, small)):
                    plans = self._probe_plans(probe, k, gs)
                    sources += [p.source(g0.dtype) for p in plans]
            _build.build_many(sources)
        for k in missing:
            self._rates[rate_key(k, g0.dtype, probe)] = self._probe(
                probe, k, big, small)
        if self.cache_dir:
            self._store_rates()

    def _probe_plans(self, probe: _Probe, key: str, grids):
        plans = self.plans(probe.kernel, {n: g.halo for n, g in grids.items()},
                           next(iter(grids.values())).shape,
                           _CLASS_BACKENDS[key], probe.swap)
        if plans is None:
            raise ValueError(f"cannot probe {key}: the kernels do not take "
                             f"{probe.kernel.name} at the probe geometry")
        return tuple(dict.fromkeys(plans))

    def _probe(self, probe: _Probe, key: str, big, small) -> Rate:
        """Measure one class's Rate.  In a time loop (the JAX protocol): a
        fully fused run of ``S`` steps (``W_f`` = 1 window) and a run of
        ``W_s`` windows of ``k`` steps (one K3 launch a window; ``k`` = 1
        for the other classes) differ only in their windows, so with ``b``
        and ``w`` this model's bytes a step and a window::

            overhead_s  = (t_s·(S·b + W_f·w) − t_f·(S·b + W_s·w))
                          / (S·b·(W_s − W_f))
            bytes_per_s = (S·b + W_f·w) / (t_f − W_f·overhead_s)

        (the JAX formulas where ``w`` is 0).  ``st.map`` classes: one
        application at the probe size and at a small one, ``t = b/bw + o``
        solved from the two (all of it bandwidth where the sizes are
        equal)."""
        backend = _CLASS_BACKENDS[key]
        g0 = next(iter(big.values()))
        itemsize = g0.data.element_size()
        steps = PROBE_STEPS[self.device.type]
        if probe.swap is None:
            b_big = self._probe_bytes(probe, key, big, itemsize)
            t_big = min(time_map(probe.kernel, big, probe.scalars, backend,
                                 2, steps))
            o = 0.0
            b_small = self._probe_bytes(probe, key, small, itemsize)
            if b_big > b_small:
                t_small = min(time_map(probe.kernel, small, probe.scalars,
                                       backend, 2, steps))
                o = t_small - b_small * (t_big - t_small) / (b_big - b_small)
            o = max(o, 1e-8)
            return Rate(max(b_big / max(t_big - o, 1e-9), 1.0), o)
        k, b, w = 1, self._probe_bytes(probe, key, big, itemsize), 0.0
        if key.startswith("hopper"):
            plan = self._probe_plans(probe, key, big)[0]
            k, w = plan.time_block, plan.layout_bytes_per_window(itemsize)
        t_f = min(time_timeloop(probe.kernel, big, probe.scalars, backend,
                                steps, steps, probe.swap, 2))
        t_s = min(time_timeloop(probe.kernel, big, probe.scalars, backend, k,
                                steps, probe.swap, 2))
        W_f, W_s, S = 1, steps // k, steps
        o = ((t_s * (S * b + W_f * w) - t_f * (S * b + W_s * w))
             / (S * b * (W_s - W_f)))
        o = max(o, 1e-8)
        bw = (S * b + W_f * w) / max(t_f - W_f * o, 1e-9)
        return Rate(max(bw, 1.0), o)

    def _probe_bytes(self, probe, key, grids, itemsize) -> float:
        if key.startswith("torch"):
            return torch_step_bytes(probe.kernel.ir, next(iter(grids.values())).shape,
                                    itemsize)
        return self._probe_plans(probe, key, grids)[0].hbm_bytes_per_step(itemsize)

    # -- calibration persistence (next to the autotune disk cache) ---------
    def _cal_path(self) -> str:
        return os.path.join(self.cache_dir,
                            f"roofline-v{CALIBRATION_VERSION}-{self.tag}.json")

    def _load_rates(self) -> None:
        try:
            with open(self._cal_path()) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        if data.get("version") != CALIBRATION_VERSION:
            return
        for rk, r in data.get("rates", {}).items():
            try:
                self._rates.setdefault(
                    rk, Rate(float(r["bytes_per_s"]), float(r["overhead_s"])))
            except (KeyError, TypeError, ValueError):
                continue

    def _store_rates(self) -> None:
        _atomic_write_json(self._cal_path(), {
            "version": CALIBRATION_VERSION,
            "device": self.tag,
            "rates": {rk: {"bytes_per_s": r.bytes_per_s,
                           "overhead_s": r.overhead_s}
                      for rk, r in self._rates.items()},
        })


# -- shared default models (one calibration per process per cache dir) -----
_MODELS: Dict[Tuple[Optional[str], str], CostModel] = {}


def default_model(cache_dir: Optional[str] = None, device=None) -> CostModel:
    """Process-wide calibrated model per cache directory and device: the
    one ``autotune.tune`` builds when pruning without an explicit model, so
    repeated tunes share probes and plans."""
    dev = _device(device)
    m = _MODELS.get((cache_dir, str(dev)))
    if m is None:
        m = CostModel(cache_dir=cache_dir, calibrate=True, device=dev)
        _MODELS[(cache_dir, str(dev))] = m
    return m


def reset_default_models() -> None:
    """Drop shared models (tests / simulating a fresh process)."""
    _MODELS.clear()
