"""Simulation as a service: shape-bucketed continuous batching of stencil
jobs (the JAX package's ``serving/stencil_serve.py``, on PyTorch): many
small and medium simulations from many users, not one giant run.

A ``SimServer`` accepts (kernel name, shape, steps, payload) requests and
serves them from one engine a bucket:

  1. **bucket** — requests group by ``(kernel, shape bucket, dtype)``; the
     bucket rounds every interior extent up to a power of two
     (``autotune.shape_bucket``, the bucketing the autotune cache keys on).
  2. **pack** — up to ``batch_cap`` requests embed into one batched
     grid-set at the bucket shape, on the server's device.  A request's
     cells land at the corner of the bucket domain; everything outside its
     true sub-domain is frozen by a per-scenario spatial mask (exactly like
     halo cells, so the embedded run is the small-domain run).  Waves
     shorter than the cap are padded with dummy scenarios (mask all False,
     step budget 0), so every wave runs the same windows.
  3. **run** — one batched masked timeloop advances the whole wave.  The
     wave runs to the longest request's step count rounded up to a
     multiple of the fuse window; each request freezes at its own budget
     through the per-scenario step limits
     (``lowering.lower_torch_window_masked``).
  4. **unpack** — each request's true sub-domain is sliced back out.

Admission (``bucket_key``), packing (``pack_wave``) and unpacking
(``unpack_wave``) are plain functions; the server is a thin queue around
them.  The kernels K1–K5 take no mask operand (neither do the JAX
package's Pallas kernels), so the server runs ``st.torch()`` engines, as
the JAX server runs ``st.xla()`` engines.

With ``autotune_cache=<dir>`` the server consults the persistent autotune
cache once a bucket to pick the fuse window (measuring only on a cold
cache; a warm process serves its first request with no candidate
measured).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import autotune as _at
from repro_torch.core import dsl as st
from repro_torch.core import suite as _suite
from repro_torch.core import timeloop as _tl

__all__ = ["SimRequest", "SimServer", "bucket_key", "pack_wave",
           "unpack_wave", "form_waves", "default_swap"]

_TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass
class SimRequest:
    """One simulation job.

    ``payload`` maps grid-param name → numpy array, either the bare
    interior (``shape``) or the full halo-padded field (``shape + 2·order``
    per axis) when the job carries boundary values.  ``scalars`` are
    per-request kernel scalar parameters.  ``result`` (set when served)
    maps grid name → interior numpy array at the true shape, under the
    engine's name-rotation convention."""
    uid: int
    kernel: str
    shape: Tuple[int, ...]
    steps: int
    payload: Dict[str, np.ndarray]
    scalars: Dict[str, float] = dataclasses.field(default_factory=dict)
    dtype: str = "float32"
    submitted_at: float = 0.0
    done_at: float = 0.0
    result: Optional[Dict[str, np.ndarray]] = None


# --------------------------------------------------------------------------
# admission, packing, unpacking
# --------------------------------------------------------------------------
def bucket_key(kernel: str, shape: Sequence[int],
               dtype: str = "float32") -> Tuple[str, Tuple[int, ...], str]:
    """(kernel, padded shape bucket, dtype): requests sharing a key share
    one engine."""
    return (kernel, _at.shape_bucket(shape), str(np.dtype(dtype)))


def default_swap(k: st.Kernel) -> Optional[Tuple[str, str]]:
    """Leapfrog pair for serving: the kernel's (written, other) grids when
    it has exactly two grid params (every suite kernel), else None —
    kernels with more grids pass their pair explicitly."""
    if len(k.ir.grid_params) != 2:
        return None
    out = k.ir.output_grids()[0]
    other = next(g for g in k.ir.grid_params if g != out)
    return (out, other)


def pack_wave(k: st.Kernel, bucket: Tuple[int, ...],
              requests: Sequence[SimRequest], batch_cap: int,
              dtype="float32", device=None):
    """Embed ≤ ``batch_cap`` requests into one batched grid-set on
    ``device`` (None: the card).

    Returns ``(arrays, mask, limits)``: halo-padded ``(cap,) + bucket``
    tensors per grid, the per-scenario bool mask over the bucket interior
    and the per-scenario step budgets (int32).  Request ``i``'s field (its
    halo included; zero halos for an interior-only payload) sits at the
    corner of the bucket domain; slots past ``len(requests)`` are dummies
    (mask all False, budget 0), so partial waves run the full cap."""
    if len(requests) > batch_cap:
        raise ValueError(f"wave of {len(requests)} exceeds cap {batch_cap}")
    dev = st.resolve_device(device)
    order = k.info.order
    full = tuple(b + 2 * order for b in bucket)
    tdt = _TORCH_DTYPE[str(np.dtype(dtype))]
    arrays = {g: torch.zeros((batch_cap,) + full, dtype=tdt, device=dev)
              for g in k.ir.grid_params}
    mask = torch.zeros((batch_cap,) + tuple(bucket), dtype=torch.bool, device=dev)
    limits = torch.zeros((batch_cap,), dtype=torch.int32)
    for i, r in enumerate(requests):
        s = tuple(r.shape)
        if any(a > b for a, b in zip(s, bucket)):
            raise ValueError(f"request shape {s} exceeds bucket {bucket}")
        mask[(i,) + tuple(slice(0, e) for e in s)] = True
        limits[i] = int(r.steps)
        sfull = tuple(e + 2 * order for e in s)
        for g in k.ir.grid_params:
            val = np.asarray(r.payload.get(g, 0.0))
            if val.ndim == 0:
                continue  # absent grid → zeros
            if tuple(val.shape) == sfull:
                idx = tuple(slice(0, e) for e in sfull)
            elif tuple(val.shape) == s:
                idx = tuple(slice(order, order + e) for e in s)
            else:
                raise ValueError(
                    f"payload '{g}' must be shape {s} (interior) or "
                    f"{sfull} (halo-padded); got {tuple(val.shape)}")
            arrays[g][(i,) + idx] = torch.as_tensor(val, dtype=tdt).to(dev)
    return arrays, mask, limits.to(dev)


def unpack_wave(k: st.Kernel, out_arrays: Mapping[str, torch.Tensor],
                requests: Sequence[SimRequest]) -> List[Dict[str, np.ndarray]]:
    """Slice each request's true-shape interiors back out of the batched
    bucket arrays, as numpy arrays (no name-parity correction: a
    scenario's buffers stop rotating at its step budget, so its names
    follow the engine's convention at exactly ``steps`` steps)."""
    order = k.info.order
    out = []
    for i, r in enumerate(requests):
        idx = (i,) + tuple(slice(order, order + e) for e in r.shape)
        out.append({g: out_arrays[g][idx].cpu().numpy()
                    for g in k.ir.grid_params})
    return out


def form_waves(queue: Sequence[SimRequest],
               batch_cap: int) -> List[List[SimRequest]]:
    """Split one bucket's FIFO queue into waves of ≤ ``batch_cap``."""
    return [list(queue[i:i + batch_cap])
            for i in range(0, len(queue), batch_cap)]


# --------------------------------------------------------------------------
# server
# --------------------------------------------------------------------------
class SimServer:
    """Continuous-batching front end over the batched masked timeloop.

    ``batch_cap`` scenarios a wave (one engine a bucket); ``deadline_s``
    bounds how long a partly filled wave may wait; ``fuse_window`` is the
    host-sync cadence (wave step counts round up to a multiple of it).
    ``kernels`` maps extra kernel names to ``st.Kernel`` objects (suite
    names resolve themselves); ``autotune_cache`` enables the persistent
    autotune cache for a tuned fuse window a bucket: a cold start ranks the
    ``tune_fuse_space`` candidates with the cost model and measures only
    the ``tune_top_k`` cheapest (``None``: all; ``tune_cost_model`` a
    ``cost_model.CostModel`` to use).  Engines and wave tensors live on
    ``device`` (None: the card).
    """

    def __init__(self, batch_cap: int = 8, deadline_s: float = 0.05,
                 fuse_window: int = 8,
                 kernels: Optional[Mapping[str, st.Kernel]] = None,
                 swaps: Optional[Mapping[str, Tuple[str, str]]] = None,
                 autotune_cache: Optional[str] = None,
                 tune_steps: int = 8,
                 tune_fuse_space: Sequence[int] = (1, 2, 4, 8, 16),
                 tune_top_k: Optional[int] = 2,
                 tune_cost_model=None,
                 device=None):
        if batch_cap < 1:
            raise ValueError("batch_cap must be >= 1")
        self.device = st.resolve_device(device)
        self.batch_cap = int(batch_cap)
        self.deadline_s = float(deadline_s)
        self.fuse_window = int(fuse_window)
        self._kernels = dict(kernels or {})
        self._swaps = dict(swaps or {})
        self.autotune_cache = autotune_cache
        self.tune_steps = int(tune_steps)
        self.tune_fuse_space = tuple(tune_fuse_space)
        self.tune_top_k = tune_top_k
        self.tune_cost_model = tune_cost_model
        self._queues: Dict[Tuple, List[SimRequest]] = {}
        self._engines: Dict[Tuple, Tuple[_tl.TimeloopEngine, int]] = {}
        self._uid = itertools.count()
        self.waves_run = 0

    # -- kernel resolution -------------------------------------------------
    def _kernel(self, name: str) -> st.Kernel:
        k = self._kernels.get(name)
        if k is None:
            k = _suite.get_kernel(name)
            self._kernels[name] = k
        return k

    def _swap(self, name: str) -> Optional[Tuple[str, str]]:
        if name in self._swaps:
            return self._swaps[name]
        return default_swap(self._kernel(name))

    # -- submission --------------------------------------------------------
    def submit(self, kernel: str, shape: Sequence[int], steps: int,
               payload: Mapping[str, np.ndarray],
               scalars: Optional[Mapping[str, float]] = None,
               dtype: str = "float32") -> int:
        k = self._kernel(kernel)
        shape = tuple(int(s) for s in shape)
        if len(shape) != k.info.ndim:
            raise ValueError(f"kernel '{kernel}' is {k.info.ndim}D; "
                             f"got shape {shape}")
        if int(steps) < 0:
            raise ValueError("steps must be >= 0")
        r = SimRequest(uid=next(self._uid), kernel=kernel, shape=shape,
                       steps=int(steps), payload=dict(payload),
                       scalars=dict(scalars or {}), dtype=str(np.dtype(dtype)),
                       submitted_at=time.perf_counter())
        self._queues.setdefault(bucket_key(kernel, shape, dtype), []).append(r)
        return r.uid

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # -- engine and tuned window a bucket ----------------------------------
    def _engine_for(self, key) -> Tuple[_tl.TimeloopEngine, int]:
        entry = self._engines.get(key)
        if entry is not None:
            return entry
        name, bucket, _dtype = key
        k = self._kernel(name)
        swap = self._swap(name)
        fuse = self.fuse_window
        if self.autotune_cache and swap is not None:
            # the fuse window of this bucket from the persistent cache: a
            # cold process ranks the candidates with the cost model and
            # measures the tune_top_k cheapest; a warm one reads the tuned
            # window from disk and measures nothing (MEASURE_COUNT stays)
            grids = {g: st.grid(st.f32, bucket, k.info.order,
                                device=self.device).randomize(i)
                     for i, g in enumerate(k.ir.grid_params)}
            res = _at.tune(k, grids, iters=1, space=[st.torch()], swap=swap,
                           steps=self.tune_steps,
                           fuse_space=self.tune_fuse_space,
                           time_block_space=(1,),
                           cache_dir=self.autotune_cache,
                           top_k=self.tune_top_k,
                           cost_model=self.tune_cost_model,
                           scalars={n: 0.0 for n, _ in k.ir.scalar_params})
            fuse = max(1, int(res.fuse_steps))
        halos = {g: (k.info.order,) * k.info.ndim for g in k.ir.grid_params}
        eng = _tl.TimeloopEngine(k.ir, halos, bucket, st.torch(), swap=swap,
                                 batch=self.batch_cap)
        self._engines[key] = (eng, fuse)
        return eng, fuse

    # -- serving loop ------------------------------------------------------
    def _ready(self, key, now: float, force: bool) -> bool:
        q = self._queues[key]
        if not q:
            return False
        if force or len(q) >= self.batch_cap:
            return True
        return (now - q[0].submitted_at) >= self.deadline_s

    def step(self, force: bool = False) -> List[SimRequest]:
        """Run at most one wave: the oldest bucket that is ready (full to
        the cap, past its deadline, or any with ``force``).  Returns the
        completed requests (empty when nothing is ready)."""
        now = time.perf_counter()
        ready = [key for key in self._queues if self._ready(key, now, force)]
        if not ready:
            return []
        key = min(ready, key=lambda k2: self._queues[k2][0].submitted_at)
        q = self._queues[key]
        wave, self._queues[key] = q[:self.batch_cap], q[self.batch_cap:]
        return self._run_wave(key, wave)

    def run_until_drained(self) -> Dict[int, SimRequest]:
        """Serve everything queued (partial waves run immediately)."""
        done: Dict[int, SimRequest] = {}
        while self.pending():
            for r in self.step(force=True):
                done[r.uid] = r
        return done

    def _run_wave(self, key, wave: List[SimRequest]) -> List[SimRequest]:
        name, bucket, dtype = key
        k = self._kernel(name)
        eng, fuse = self._engine_for(key)
        arrays, mask, limits = pack_wave(k, bucket, wave, self.batch_cap, dtype,
                                         self.device)
        # every wave runs a whole number of windows of one size: steps round
        # UP to a multiple of the window, and each request's budget stops it
        # at its own count
        top = max([int(r.steps) for r in wave] + [1])
        steps = -(-top // fuse) * fuse
        scalars = {n: [float(r.scalars.get(n, 0.0)) for r in wave]
                   + [0.0] * (self.batch_cap - len(wave))
                   for n, _ in k.ir.scalar_params}
        out = eng.run(arrays, scalars, steps, fuse,
                      domain_mask=mask, step_limits=limits)
        results = unpack_wave(k, out, wave)
        now = time.perf_counter()
        for r, res in zip(wave, results):
            r.result, r.done_at = res, now
        self.waves_run += 1
        return wave
