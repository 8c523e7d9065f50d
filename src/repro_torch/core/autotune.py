"""Auto-tuner over backend templates and their knobs: the counterpart of the
JAX package's ``core/autotune.py`` (grid search with measured
time-to-solution, the paper's own metric)::

    from repro_torch.core import autotune, dsl as st
    best = autotune.tune(kernel, grids, swap=("v", "u"), steps=16)
    st.launch(backend=best.backend, fuse_steps=best.fuse_steps)(target)(...)

With a ``swap`` pair the tuner measures ``steps`` fused time-loop steps per
candidate and searches the fusion window ``fuse_steps`` and, for hopper
candidates, the temporal depth ``time_block`` beside the backend; without
one it measures single ``st.map`` applications.  ``default_space`` holds
``st.torch()`` and the port's templates, each at its plan's default tile
and at most one runner-up that the repo's A/B tools timed on the card.

Candidates are deduplicated on the builds their run launches and their
window, not on ``backend.cache_key()``: in ``st.timeloop`` gmem, smem and
f4 all run K1, shift and unroll both run K2, ``mem_type`` changes no
kernel, and a ``time_block=k`` candidate whose windows hold fewer than
``k`` steps runs only its single-step kernel.

**Two-stage search** (``top_k``): when the deduplicated space exceeds
``top_k`` candidates, every candidate is ranked by the analytical cost
model (``core/cost_model.py``: modeled traffic over calibrated rates, no
build) and only the ``top_k`` cheapest predicted are measured.  Before
measuring, every shortlisted candidate's sources are built in one
``nvcc`` wave, so the build time (``TuneResult.timing["build"]``) is
apart from the measured times, which also exclude each candidate's
warm-up run.  ``top_k=None`` recovers the exhaustive search.
``TuneResult`` records the predictions, the pruned count and the
predicted rank of the measured winner (``rank_error``).

On the card nothing is turned into a default: only a plan's
``ValueError`` (the infeasible geometry the JAX package also prices as
``inf``) scores ``inf``, without a launch; a failed build, launch, probe or
prediction raises out of ``tune``.

Results are cached in-process (``clear_cache()``) over an optional
on-disk JSON cache (one file per entry, atomic writes) keyed by (kernel
fingerprint, interior *shape bucket*, search configuration, calibration
version, device tag), enabled by ``cache_dir=`` or
``$REPRO_AUTOTUNE_CACHE``.  ``MEASURE_COUNT`` counts measured and pruned
candidates; a warm hit leaves it untouched.  Each measured candidate's
grid copies are freed before the next is measured.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import cost_model as _cost
from . import dsl as st
from . import timeloop as _tl
from .cost_model import kernel_fingerprint  # noqa: F401  (re-export)

_CACHE: Dict = {}

#: bump when the on-disk entry layout changes: old entries then miss (and
#: ``purge_stale`` removes them on first touch of the directory)
SCHEMA_VERSION = 2

#: environment variable naming the on-disk cache directory
CACHE_ENV = "REPRO_AUTOTUNE_CACHE"

#: ``MEASURE_COUNT["measured_candidates"]`` counts each (backend, fuse)
#: configuration timed, ``MEASURE_COUNT["pruned_candidates"]`` each one the
#: cost model pruned; a warm cache (in-process or disk) touches neither
MEASURE_COUNT: collections.Counter = collections.Counter()

#: runner-up tiles of the default space (3D), each timed on an H100 beside
#: its template's default at 512³: K1's by ``tools/gmem_block_ab.py``, K2's
#: by ``tools/stream_tiles_ab.py``
RUNNER_UP = {"gmem": (16, 8, 64), "shift": (64, 16, 64)}


def clear_cache() -> None:
    """Drop all memoized tuning results (in-process layer only)."""
    _CACHE.clear()


def reset_measure_count() -> None:
    """Zero the ``MEASURE_COUNT`` counters."""
    MEASURE_COUNT.clear()


def shape_bucket(shape: Sequence[int]) -> Tuple[int, ...]:
    """Round each interior extent up to a power of two (floor 8): disk
    entries of every shape in a bucket are shared."""
    return tuple(max(8, 1 << (int(s) - 1).bit_length()) for s in shape)


@dataclasses.dataclass
class TuneResult:
    backend: st.Backend
    seconds: float
    trials: List[Tuple[st.Backend, int, float]]  # (backend, fuse_steps, s)
    fuse_steps: int = 1
    #: every candidate with its modeled cost: (backend, fuse_steps,
    #: predicted seconds | inf (infeasible) | None (unpredictable)); empty
    #: when no cost model ran (small space, no explicit model)
    predicted: List[Tuple[st.Backend, int, Optional[float]]] = \
        dataclasses.field(default_factory=list)
    #: candidates ranked out of the measured shortlist by the cost model
    pruned_candidates: int = 0
    #: candidates actually timed (== len(trials))
    measured_candidates: int = 0
    #: predicted rank (0-based) of the measured-best candidate; None
    #: without a model
    rank_error: Optional[int] = None
    #: the shortlist size this result was tuned with (None = exhaustive)
    top_k: Optional[int] = None
    #: host seconds of the tune that measured this result, by stage:
    #: ``calibrate``, ``predict``, ``build``, ``measure``
    timing: Dict[str, float] = dataclasses.field(default_factory=dict)


# --------------------------------------------------------------------------
# on-disk cache (read-through under _CACHE)
# --------------------------------------------------------------------------
def _backend_to_json(b) -> Optional[dict]:
    """JSON form of a tunable backend (torch / hopper)."""
    if b.kind == "torch":
        return {"kind": "torch"}
    if b.kind == "hopper":
        return {"kind": "hopper", "template": b.template,
                "block": list(b.block) if b.block else None,
                "mem_type": b.mem_type, "time_block": int(b.time_block)}
    return None


def _backend_from_json(d: dict):
    if d["kind"] == "torch":
        return st.torch()
    return st.hopper(template=d["template"],
                     block=tuple(d["block"]) if d["block"] else None,
                     mem_type=d["mem_type"], time_block=d["time_block"])


def _seconds_to_json(s: float):
    return None if s == float("inf") else float(s)


def _pred_to_json(p: Optional[float]):
    """Predictions tell inf (infeasible) from None (unpredictable), and
    JSON has no inf: it is the string "inf"."""
    if p is None:
        return None
    return "inf" if p == float("inf") else float(p)


def _pred_from_json(p):
    if p is None:
        return None
    return float("inf") if p == "inf" else float(p)


def cache_dir_from_env() -> Optional[str]:
    """Disk-cache directory from ``$REPRO_AUTOTUNE_CACHE``, or ``None``
    when unset or empty."""
    return os.environ.get(CACHE_ENV) or None


def _disk_key(kernel, grids, iters, space, swap, steps, fuse_space,
              time_block_space, top_k) -> Tuple[str, dict]:
    """(digest, human-readable key dict) for one disk entry: the JAX
    package's key with the device tag (``cost_model.device_tag``) in place
    of the JAX backend.  Geometry enters as the shape bucket, halo order
    and dtype."""
    g0 = next(iter(grids.values()))
    readable = {
        "schema": SCHEMA_VERSION,
        "kernel": kernel.name,
        "fingerprint": kernel_fingerprint(kernel),
        "shape_bucket": list(shape_bucket(g0.shape)),
        "geometry": sorted([n, g.order, _cost._dtype_name(g.dtype)]
                           for n, g in grids.items()),
        "iters": int(iters),
        "space": repr(_space_key(space)),
        "swap": list(swap) if swap else None,
        "steps": int(steps) if swap else None,
        "fuse_space": [int(f) for f in fuse_space] if swap else None,
        "time_block_space":
            [int(t) for t in time_block_space] if swap else None,
        "top_k": int(top_k) if top_k is not None else None,
        # a recalibrated cost model can change the shortlist
        "calibration": _cost.CALIBRATION_VERSION,
        "device": _cost.device_tag(g0.device),
    }
    blob = json.dumps(readable, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:24], readable


def _disk_load(cdir: str, digest: str, readable: dict) -> Optional[TuneResult]:
    path = os.path.join(cdir, f"tune-{digest}.json")
    try:
        with open(path) as f:
            entry = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if entry.get("schema") != SCHEMA_VERSION or entry.get("key") != readable:
        return None  # schema bump or (hash-collision-safe) key mismatch
    try:
        trials = [(_backend_from_json(b), int(fs),
                   float("inf") if s is None else float(s))
                  for b, fs, s in entry["trials"]]
        predicted = [(_backend_from_json(b), int(fs), _pred_from_json(p))
                     for b, fs, p in entry.get("predicted", [])]
        search = entry.get("search", {})
        best = entry["best"]
        rank = search.get("rank_error")
        tk = search.get("top_k")
        return TuneResult(backend=_backend_from_json(best["backend"]),
                          seconds=float("inf") if best["seconds"] is None
                          else float(best["seconds"]),
                          trials=trials, fuse_steps=int(best["fuse_steps"]),
                          predicted=predicted,
                          pruned_candidates=int(
                              search.get("pruned_candidates", 0)),
                          measured_candidates=int(
                              search.get("measured_candidates",
                                         len(trials))),
                          rank_error=int(rank) if rank is not None else None,
                          top_k=int(tk) if tk is not None else None,
                          timing={k: float(v) for k, v in
                                  entry.get("timing", {}).items()})
    except (KeyError, TypeError, ValueError):
        return None


def _disk_store(cdir: str, digest: str, readable: dict,
                result: TuneResult) -> None:
    entry = {
        "schema": SCHEMA_VERSION,
        "key": readable,
        "best": {"backend": _backend_to_json(result.backend),
                 "fuse_steps": int(result.fuse_steps),
                 "seconds": _seconds_to_json(result.seconds)},
        "trials": [[_backend_to_json(b), int(f), _seconds_to_json(s)]
                   for b, f, s in result.trials],
        "predicted": [[_backend_to_json(b), int(f), _pred_to_json(p)]
                      for b, f, p in result.predicted],
        "search": {"top_k": result.top_k,
                   "pruned_candidates": int(result.pruned_candidates),
                   "measured_candidates": int(result.measured_candidates),
                   "rank_error": result.rank_error},
        "timing": dict(result.timing),
    }
    _cost._atomic_write_json(os.path.join(cdir, f"tune-{digest}.json"), entry)


#: directories already swept by ``purge_stale`` this process (one-shot)
_PURGED: set = set()


def _tune_files(cdir: Optional[str]) -> List[str]:
    if not cdir or not os.path.isdir(cdir):
        return []
    return [os.path.join(cdir, n) for n in os.listdir(cdir)
            if n.startswith("tune-") and n.endswith(".json")]


def purge_stale(cdir: Optional[str] = None) -> int:
    """Remove tune entries written under a different ``SCHEMA_VERSION``
    (or unreadable ones) from ``cdir`` (default: the env-var directory);
    ``tune`` runs this once per directory per process on first touch.
    Returns the number of entries removed."""
    n = 0
    for path in _tune_files(cdir or cache_dir_from_env()):
        try:
            with open(path) as f:
                stale = json.load(f).get("schema") != SCHEMA_VERSION
        except (OSError, json.JSONDecodeError):
            stale = True
        if stale:
            try:
                os.unlink(path)
                n += 1
            except OSError:
                pass
    return n


def clear_disk_cache(cdir: Optional[str] = None) -> int:
    """Remove all on-disk entries in ``cdir`` (default: the env-var
    directory).  Returns the number of entries removed."""
    n = 0
    for path in _tune_files(cdir or cache_dir_from_env()):
        try:
            os.unlink(path)
            n += 1
        except OSError:
            pass
    return n


def default_space(ndim: int, interior: Sequence[int],
                  swap=None) -> List[st.Backend]:
    """Candidate backends on this card: ``st.torch()`` and the port's
    templates, gmem, shift and semi in a time loop (``swap`` given; smem,
    f4 and unroll run the same kernels there), gmem, f4, smem, shift and
    semi for ``st.map``; each at its plan's default tile and, in 3D, gmem
    and shift also at their ``RUNNER_UP`` tile."""
    del interior
    templates = (("gmem", "shift", "semi") if swap is not None
                 else ("gmem", "f4", "smem", "shift", "semi"))
    out: List[st.Backend] = [st.torch()]
    for t in templates:
        out.append(st.hopper(template=t))
        if ndim == 3 and t in RUNNER_UP:
            out.append(st.hopper(template=t, block=RUNNER_UP[t]))
    return out


def _normalize_space(space, ndim, interior, swap, steps, fuse_space,
                     time_block_space=(1,), identity=None):
    """Expand the search space into (backend, fuse_steps) candidates (the
    JAX package's expansion).  With ``swap``, plain backend entries are
    expanded over ``fuse_space`` and, for hopper backends, over
    ``time_block_space`` (keeping the entry's own depth); ``(backend,
    fuse)`` entries are taken verbatim.  Candidates whose
    ``identity(backend, fuse)`` (default: ``(backend.cache_key(), fuse)``)
    repeats an earlier one's are dropped, so none is measured twice."""
    base = space or default_space(ndim, interior, swap)
    identity = identity or (lambda b, f: (b.cache_key(), f))

    def _norm_fuse(f):
        # the engine's window normalization: requests >= steps collapse to
        # one whole-loop window
        return _tl.normalize_fuse(max(1, int(f)), steps)

    cands: List[Tuple[st.Backend, int]] = []
    for entry in base:
        if isinstance(entry, tuple):
            b, f = entry
            cands.append((b, _norm_fuse(f) if swap is not None else 1))
        elif swap is not None:
            backends = [entry]
            if entry.kind == "hopper":
                tbs = dict.fromkeys(
                    [int(getattr(entry, "time_block", 1) or 1)]
                    + [int(tb) for tb in time_block_space])
                backends = [dataclasses.replace(entry, time_block=tb)
                            for tb in tbs]
            for b in backends:
                for f in fuse_space:
                    cands.append((b, _norm_fuse(f)))
        else:
            cands.append((entry, 1))
    seen, out = set(), []
    for b, f in cands:
        key = identity(b, f)
        if key not in seen:
            seen.add(key)
            out.append((b, f))
    return out


def _space_key(space):
    if space is None:
        return None
    out = []
    for entry in space:
        if isinstance(entry, tuple):
            b, f = entry
            out.append((b.cache_key(), int(f)))
        else:
            out.append((entry.cache_key(), None))
    return tuple(out)


def shortlist_indices(predictions: Sequence[Optional[float]],
                      top_k: int) -> List[int]:
    """Candidate indices the two-stage search measures: the ``top_k``
    cheapest predicted (ties broken by original order), plus every
    candidate the model cannot predict (``None``).  Original order is
    preserved."""
    ranked = sorted((i for i, p in enumerate(predictions) if p is not None),
                    key=lambda i: (predictions[i], i))
    keep = set(ranked[:max(0, int(top_k))])
    keep.update(i for i, p in enumerate(predictions) if p is None)
    return sorted(keep)


def _launched(cm, kernel, grids, backend, fuse, steps, swap):
    """The plans a candidate's run launches: ``()`` under torch, ``None``
    for a geometry the kernels cannot take; in a time loop the window's
    plan if it runs K3 launches and the single-step plan if it runs single
    steps."""
    g0 = next(iter(grids.values()))
    plans = cm.plans(kernel, {n: g.halo for n, g in grids.items()}, g0.shape,
                     backend, swap)
    if not plans or swap is None:
        return plans
    blocked, single, _ = _tl.launch_steps(steps, fuse, plans[0].time_block)
    return tuple(p for p, n in ((plans[0], blocked), (plans[1], single)) if n)


def _measure(kernel, grids, scalars, backend, iters: int) -> float:
    """Median host seconds of one ``st.map`` application (after a warm-up
    application; each ends in a sync)."""
    return statistics.median(_cost.time_map(kernel, grids, scalars, backend,
                                            iters))


def _measure_timeloop(kernel, grids, scalars, backend, fuse: int, steps: int,
                      swap, iters: int) -> float:
    """Median host seconds of ``steps`` fused time steps (after a warm-up
    run; each window ends in a sync)."""
    return statistics.median(_cost.time_timeloop(kernel, grids, scalars,
                                                 backend, fuse, steps, swap,
                                                 iters))


def tune(kernel: st.Kernel, grids: Dict[str, st.grid], iters: int = 3,
         space: Optional[List] = None,
         verbose: bool = False,
         swap: Optional[Tuple[str, str]] = None,
         steps: int = 16,
         fuse_space: Sequence[int] = (1, 4, 16),
         time_block_space: Sequence[int] = (1, 2, 4),
         cache_dir: Optional[str] = None,
         top_k: Optional[int] = 3,
         cost_model: Optional[_cost.CostModel] = None,
         mesh=None,
         scalars: Optional[Dict[str, object]] = None) -> TuneResult:
    """Search the backend (and, with ``swap``, the fusion window and the
    temporal depth): predict with the cost model, measure a shortlist.

    ``grids`` are the kernel's grids in parameter order and ``scalars`` its
    scalar arguments by name (the JAX package's ``tune`` takes no scalars,
    and scores a kernel that has them ``inf`` on every candidate); the
    candidates run on copies of the grids, on their device.  ``space``
    entries may be backends or ``(backend, fuse_steps)`` pairs.  ``top_k``
    — when the deduplicated space exceeds it, rank every candidate with
    the cost model (``cost_model`` if given, else the process-shared
    calibrated ``cost_model.default_model``) and measure only the ``top_k``
    cheapest predicted (plus any the model cannot predict); ``None`` forces
    the exhaustive search.  An explicit ``cost_model`` predicts even when
    nothing is pruned.  ``cache_dir`` (or ``$REPRO_AUTOTUNE_CACHE``)
    enables the disk cache: a miss in the in-process layer reads the entry
    for this configuration before predicting or measuring anything, and a
    fresh result is written back.  ``mesh`` is not ported yet and
    raises."""
    if mesh is not None:
        raise st.not_ported("autotune.tune(mesh=...)",
                            "queue 1, item 9 (distributed)")
    if top_k is not None and int(top_k) < 1:
        raise ValueError(f"top_k must be >= 1 or None (got {top_k})")
    scalars = dict(scalars or {})
    names = [n for n, _ in kernel.ir.scalar_params]
    if sorted(scalars) != sorted(names):
        raise TypeError(f"tune: {kernel.name} takes the scalars {names}, "
                        f"got {sorted(scalars)}")
    scalars = {n: scalars[n] for n in names}
    g0 = next(iter(grids.values()))
    key = (kernel.name,
           tuple(sorted((n, g.shape, g.order, str(g.dtype), str(g.device))
                        for n, g in grids.items())),
           int(iters), _space_key(space),
           tuple(swap) if swap else None,
           int(steps) if swap else None,
           tuple(int(f) for f in fuse_space) if swap else None,
           tuple(int(t) for t in time_block_space) if swap else None,
           int(top_k) if top_k is not None else None)
    if key in _CACHE:
        return _CACHE[key]
    cdir = cache_dir or cache_dir_from_env()
    digest = readable = None
    if cdir:
        if cdir not in _PURGED:
            _PURGED.add(cdir)
            purge_stale(cdir)
        digest, readable = _disk_key(kernel, grids, iters, space, swap,
                                     steps, fuse_space, time_block_space,
                                     top_k)
        result = _disk_load(cdir, digest, readable)
        if result is not None:
            _CACHE[key] = result
            return result

    # the plans come from the model even when nothing is predicted (a
    # model probes only to predict): the dedup and the build wave read them
    cm = cost_model or _cost.default_model(cdir, g0.device)

    def identity(b, f):
        runs = _launched(cm, kernel, grids, b, f, steps, swap)
        if runs is None:
            return ("infeasible", b.cache_key(), f)
        return tuple(p.build_identity(g0.dtype) for p in runs) or ("torch",), f

    cands = _normalize_space(space, kernel.info.ndim, g0.shape, swap,
                             steps, fuse_space,
                             time_block_space if swap else (1,), identity)
    runs = [_launched(cm, kernel, grids, b, f, steps, swap) for b, f in cands]
    timing = {"calibrate": 0.0, "predict": 0.0, "build": 0.0, "measure": 0.0}

    # stage 1: rank by predicted cost whenever pruning applies or a model
    # was given; every class the candidates launch is calibrated first,
    # in one build wave
    preds: List[Optional[float]] = []
    if cost_model is not None or (top_k is not None
                                  and len(cands) > int(top_k)):
        classes = set()
        for (b, _), r in zip(cands, runs):
            if r is not None:
                classes.update([_cost.plan_class(p) for p in r]
                               or [_cost.exec_key(b, swap)])
        t0 = time.perf_counter()
        cm.calibrate_classes(_cost._Probe(kernel, grids, swap, scalars),
                             sorted(classes))
        timing["calibrate"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for backend, fuse in cands:
            p = cm.predict(kernel, grids, backend, fuse, steps, swap,
                           scalars=scalars)
            preds.append(p)
            if verbose and p is not None:
                print(f"  predict {backend} fuse={fuse}: {p:.5f}s",
                      flush=True)
        timing["predict"] = time.perf_counter() - t0
    measure_idx = list(range(len(cands)))
    pruned = 0
    if top_k is not None and len(cands) > int(top_k):
        measure_idx = shortlist_indices(preds, int(top_k))
        pruned = len(cands) - len(measure_idx)
        MEASURE_COUNT["pruned_candidates"] += pruned

    # stage 2: build the shortlist in one wave, then measure it
    if g0.device.type == "cuda":
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.build_many([p.source(g0.dtype) for i in measure_idx
                           for p in runs[i] or ()])
        timing["build"] = time.perf_counter() - t0
    trials = []
    t0 = time.perf_counter()
    for i in measure_idx:
        backend, fuse = cands[i]
        if runs[i] is None:
            dt = float("inf")         # a plan's ValueError: nothing to run
        elif swap is None:
            dt = _measure(kernel, grids, scalars, backend, iters)
        else:
            dt = _measure_timeloop(kernel, grids, scalars, backend, fuse,
                                   steps, swap, iters)
        MEASURE_COUNT["measured_candidates"] += 1
        trials.append((backend, fuse, dt))
        if verbose:
            print(f"  {backend} fuse={fuse}: {dt:.4f}s", flush=True)
    timing["measure"] = time.perf_counter() - t0
    best = min(trials, key=lambda t: t[2])

    rank_error = None
    predicted = []
    if preds:
        predicted = [(cands[i][0], cands[i][1], preds[i])
                     for i in range(len(cands))]
        order = sorted((i for i, p in enumerate(preds) if p is not None),
                       key=lambda i: (preds[i], i))
        best_key = (best[0].cache_key(), best[1])
        for rank, i in enumerate(order):
            if (cands[i][0].cache_key(), cands[i][1]) == best_key:
                rank_error = rank
                break
    result = TuneResult(backend=best[0], seconds=best[2], trials=trials,
                        fuse_steps=best[1], predicted=predicted,
                        pruned_candidates=pruned,
                        measured_candidates=len(trials),
                        rank_error=rank_error,
                        top_k=int(top_k) if top_k is not None else None,
                        timing=timing)
    _CACHE[key] = result
    if cdir:
        _disk_store(cdir, digest, readable, result)
    return result
