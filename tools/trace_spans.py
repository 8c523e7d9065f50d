"""What the program's spans (``repro_torch/core/trace.py``) show in a traced
window of a benchmark cell, and what they cost.

    PYTHONPATH=src python3 tools/trace_spans.py --workload acoustic-iso-512-shot \\
        --seed 2147483711 [--seconds 5] [--out chiprun_out/spans.json]

On the card (``--device cpu`` runs the CPU tests' small sizes, whose
device has no operations).  It builds the cell as ``portbench/run.py``
does, warms it up, traces ``--seconds`` of its window under
``torch.profiler`` and prints one JSON object:

- ``idle_us_per_step``: the window's idle time split instant by instant
  over the innermost host span (``portbench/metrics/host_layers.py``), in
  microseconds a step;
- ``shares``: the four ``idle_*_pct`` readings, ``device_idle_pct``,
  ``dispatch_us.map`` and what of the idle share no ``.map`` share (or the
  ``.fused`` one) takes;
- ``spans_per_step``: how many times each span opened;
- ``sync_tail_us``: for ``rt.map.sync`` and ``rt.engine.sync``, each
  wait's end minus the end of the last stencil kernel that ended inside
  it (the host's wake-up; a wait that found its kernel finished has
  none), on the benchmark's constant offset (``timeline``) and on
  ``host_layers.aligned``'s drift-free clock: the host's and the device's
  times on one clock, as the readers assume;
- ``queued_kernel_gap_us``: the idle gaps between consecutive stencil
  kernels where the second was already launched (the device's own);
- ``span_us``: host microseconds of one ``trace.span`` (no phase) and of
  one bare ``record_function``, with and without a recording profiler.
"""
import argparse
import bisect
import json
import pathlib
import statistics
import sys
import time
import timeit

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def sync_tail(tr, name):
    """For each span ``name``, its end minus the end of the last stencil
    kernel that ended inside it."""
    ends = sorted(o.end for o in tr.ops if o.stencil)
    out = []
    for s in tr.spans:
        if s.name == name:
            i = bisect.bisect_right(ends, s.end) - 1
            if i >= 0 and ends[i] >= s.start:
                out.append(s.end - ends[i])
    return out


def queued_gaps(tr):
    """Idle gaps between consecutive stencil kernels where the second was
    launched before the first ended: the device's own gap between
    kernels, with no host work in the way."""
    ks = sorted((o for o in tr.in_window() if o.stencil), key=lambda o: o.start)
    return [b.start - a.end for a, b in zip(ks, ks[1:])
            if b.launch is not None and b.launch < a.end <= b.start]


def stats(xs):
    return ({"min": min(xs), "median": statistics.median(xs), "max": max(xs),
             "count": len(xs), "sum": sum(xs)} if xs else None)


def span_costs(n=20000):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core import trace

    def span():
        with trace.span("rt.cost"):
            pass

    def bare():
        with record_function("rt.cost"):
            pass
    out = {"span_off": timeit.timeit(span, number=n) / n * 1e6,
           "record_function_off": timeit.timeit(bare, number=n // 10) / (n // 10) * 1e6}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        out["span_traced"] = timeit.timeit(span, number=n // 10) / (n // 10) * 1e6
        out["record_function_traced"] = timeit.timeit(bare, number=n // 10) / (n // 10) * 1e6
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from portbench import harness
    from portbench.metrics import host_layers, timeline
    torch.set_num_threads(1)
    if args.device == "cpu":
        from portbench.tests.conftest import small_cell
        cell = small_cell(args.workload)
    else:
        cell = harness.load_cell(args.workload)
    _, _, driver = harness.build(cell, args.seed, torch.device(args.device), traced=True)
    driver.warmup()
    cuda = args.device != "cpu"
    if cuda:
        torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        win = driver.window(args.seconds)
    tr = timeline.Trace.from_profiler(prof)
    al = host_layers.aligned(tr)
    steps = max(win.steps, 1)
    idle = host_layers.idle_by_span(tr)
    ctx = harness.Ctx(cell.cfg, "", 0, win.seconds, win.steps, win.boundaries, [], 0.0, tr)
    shares = {}
    for name in ("idle_dispatch_pct.map", "idle_sync_pct.map", "idle_hooks_pct.map",
                 "idle_launch_pct.fused", "device_idle_pct", "dispatch_us.map"):
        shares[name] = harness.load_module("metrics", name).read(ctx)
    if shares["device_idle_pct"] is not None and shares["idle_sync_pct.map"] is not None:
        shares["remainder_pct.map"] = shares["device_idle_pct"] - sum(
            shares[f"idle_{n}_pct.map"] for n in ("dispatch", "sync", "hooks"))
        shares["remainder_pct.fused"] = shares["device_idle_pct"] - shares["idle_launch_pct.fused"]
    counts = {}
    a, b = tr.window
    for s in tr.spans:
        if a <= s.start and s.end <= b and s.name != "window":
            counts[s.name] = counts.get(s.name, 0) + 1
    out = {"workload": args.workload, "seed": args.seed, "steps": win.steps,
           "window_s": tr.span_us / 1e6, "busy_s": tr.busy_us() / 1e6,
           "card": torch.cuda.get_device_name() if cuda else "cpu",
           "idle_us_per_step": {str(k): v / steps for k, v in
                                sorted(idle.items(), key=lambda kv: -kv[1])},
           "shares": shares,
           "spans_per_step": {k: v / steps for k, v in sorted(counts.items())},
           "trace_clock_shift_us": tr.offset_us,
           "sync_tail_us": {n: {"offset": stats(sync_tail(tr, n)),
                                "drift_free": stats(sync_tail(al, n))}
                            for n in ("rt.map.sync", "rt.engine.sync")},
           "queued_kernel_gap_us": stats(queued_gaps(al)),
           "span_us": span_costs()}
    line = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"trace_spans: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
