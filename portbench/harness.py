"""Load a cell by the names ``BENCHMARK.json`` gives and run it.

Every piece is found by name, so a later cell, traffic mix or metric is a
new file and a new entry, never an edit:

- ``BENCHMARK.json`` ``configs[].file``: the deployment (stencil, sizes,
  dtype, model, geometry);
- ``stencils/<stencil>.py`` and ``reference/<stencil>.py``: the seeded
  state with the binding to the program, and the plain reference;
- ``traffic/<traffic>.json``: the parameters of the window loop, whose
  ``driver`` names ``drivers/<driver>.py``;
- ``metrics/<metric>.py``: one reader a metric, ``read(ctx)`` returning a
  number or None (then the metric is left out of the line);
- ``limits/<workload>.json``: the limit of each answer the check compares.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import pathlib
import sys
from typing import Callable, Dict, List, Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
# the traced run traces this much of its window: the per-layer readers
# need a steady stretch, not the whole run
TRACE_SECONDS = 5.0


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold ``.`` and
    ``-``)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    mod_name = f"portbench.{kind}.{name}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: pathlib.Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    stencil: object
    reference: object
    driver: object
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(workload: str, bench: Optional[dict] = None,
              cfg_over: Optional[dict] = None,
              traffic_over: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``bench`` (default: the checkout's
    ``BENCHMARK.json``); ``cfg_over``/``traffic_over`` replace keys (the
    tests' small sizes)."""
    bench = bench or _read_json(ROOT / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if wl is None:
        raise KeyError(f"no workload '{workload}' in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    cfg = {**_read_json(ROOT / conf["file"]), **(cfg_over or {})}
    traffic = {**_read_json(HERE / "traffic" / f"{wl['traffic']}.json"),
               **(traffic_over or {})}

    def mine(group):
        return [m for m in bench[group]
                if "workloads" not in m or workload in m["workloads"]]
    return Cell(name=workload, chips=int(wl["chips"]), cfg=cfg, traffic=traffic,
                stencil=load_module("stencils", cfg["stencil"]),
                reference=load_module("reference", cfg["stencil"]),
                driver=load_module("drivers", traffic["driver"]),
                limits=_read_json(HERE / "limits" / f"{workload}.json"),
                end_to_end=mine("end_to_end"), per_layer=mine("per_layer"))


def build(cell: Cell, seed: int, device, dtype: str = "f32", traced: bool = False):
    """(init, scalars, driver): the seeded state made on ``device`` from
    ``seed``, held apart from the program's own copy, and the window loop
    bound to the program (its grids in ``dtype``; ``traced``: with the
    benchmark's spans)."""
    import torch
    from portbench.drivers import Probe
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    init, scalars = cell.stencil.make_state(cell.cfg, gen, device)
    prog = cell.stencil.bind(cell.cfg, {n: t.clone() for n, t in init.items()},
                             scalars, dtype)
    return init, scalars, cell.driver.Driver(prog, init, cell.traffic, Probe(device, traced))


def judge(cell: Cell, got, schedule, init, scalars):
    """The checks of a solve's answers ``got`` against the reference, worked
    out again from ``init`` (consumed) on ``schedule``; the caller has
    freed the program's other state."""
    import torch
    from portbench import check
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    want = check.reference_run(cell.reference, cell.cfg, init, scalars, schedule)
    return check.compare(got, want, cell.limits)


@dataclasses.dataclass
class Ctx:
    """What a metric reader is fed: the cell's configuration, the card's
    name, the window's samples and, in a traced run, its trace."""
    cfg: dict
    kind: str
    points: int
    window_s: float
    steps: int
    boundaries: int
    solve_s: List[float]
    setup_s: float
    trace: object = None


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        since_start: Callable[[], float], marks=()) -> dict:
    """One run of the cell: set-up, warm-up, the window (traced: its first
    ``TRACE_SECONDS``), the check, the metrics.  Returns the result line's
    object; its ``checks`` key comes last.  ``marks``: (stage, seconds
    since the start) the caller passed before the run."""
    import torch
    from portbench.metrics import timeline, yardstick
    device = torch.device(device)
    cuda = device.type == "cuda"
    marks = [*marks, ("run", since_start())]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        marks.append(("card", since_start()))
    init, scalars, driver = build(cell, seed, device, traced=trace)
    marks.append(("state_and_plans", since_start()))
    driver.warmup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = since_start()
    marks.append(("warmup", setup_s))
    # the start-up heap (PyTorch's and the program's modules) out of the
    # collector's way, so its scans do not land in the window at random
    gc.collect()
    gc.freeze()
    try:
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts) as prof:
                win = driver.window(min(seconds, TRACE_SECONDS))
        else:
            win = driver.window(seconds)
    finally:
        gc.unfreeze()
    tr = None
    if trace:
        tr = timeline.Trace.from_profiler(prof)
        del prof
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    driver.finish()
    got, schedule = driver.outputs(), driver.schedule
    del driver
    checks = judge(cell, got, schedule, init, scalars)
    del got, init
    kind = torch.cuda.get_device_name() if cuda else str(device)
    ctx = Ctx(cell.cfg, kind, yardstick.points(cell.cfg), win.seconds,
              win.steps, win.boundaries, win.solve_s, setup_s, tr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type, "kind": kind,
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": all(c.ok for c in checks), "attempted": win.attempted,
           "failed": 0 if all(c.ok for c in checks) else 1,
           "metrics": metrics, "device": dev}
    # where the set-up went: each stage's own seconds
    out["setup_parts"] = {n: t - (marks[i - 1][1] if i else 0.0)
                          for i, (n, t) in enumerate(marks)}
    if win.solve_s:
        xs = sorted(win.solve_s)
        out["window"] = {"seconds": win.seconds, "steps": win.steps, "solves": len(xs),
                         "solve_ms": {"min": xs[0] * 1e3, "median": xs[len(xs) // 2] * 1e3,
                                      "max": xs[-1] * 1e3}}
    if tr is not None:
        out["trace_clock_shift_us"] = tr.offset_us
        dev["busy_s"] = tr.busy_us() / 1e6
        dev["window_s"] = tr.span_us / 1e6
        out["breakdown"] = timeline.breakdown(tr)
    # a gap that is not finite prints as the largest float (JSON has no inf)
    out["checks"] = {c.name: {"value": min(c.value, sys.float_info.max), "limit": c.limit}
                     for c in checks}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
