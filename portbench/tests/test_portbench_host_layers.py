"""The idle split by host span (``metrics/host_layers.py``) and its four
readers, on synthetic traces read by ``Trace.from_rows``."""
import pytest

from portbench import harness
from portbench.metrics import host_layers, timeline
from portbench.metrics.timeline import Trace

K4 = "void map_step_kernel<false>(Params, Scenarios)"
ADD = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>"
COPY = "Memcpy DtoD (Device -> Device)"


def rows(window, spans, ops):
    """Chrome-trace rows: the window, the host ranges, and each device
    operation with its launch call at its start (no clock shift)."""
    out = [("user_annotation", "window", *window, None)]
    out += [("user_annotation", n, a, b, None) for n, a, b in spans]
    for i, (name, a, b) in enumerate(ops):
        kind = "gpu_memcpy" if name == COPY else "kernel"
        call = "cudaMemcpyAsync" if kind == "gpu_memcpy" else "cudaLaunchKernel"
        out += [("cuda_runtime", call, a, a + 1, i), (kind, name, a, b, i)]
    return Trace.from_rows(out)


def ctx(trace):
    return harness.Ctx({}, "NVIDIA H100 80GB HBM3", 0, 1.0, 1, 1, [], 1.0, trace)


def read(name, trace):
    return harness.load_module("metrics", name).read(ctx(trace))


def shot_step():
    """One step of a shot with hooks over 0..200 µs: the receivers' copy,
    the injection's add, ``st.map``'s dispatch, K4 (100..180) and the
    sync that wakes 8 µs after K4 ends; the driver's loop after it."""
    spans = [("shot", 1, 199),
             ("receivers", 2, 12),
             ("inject_source", 14, 40), ("rt.inject_source", 15, 39),
             ("st.map", 42, 190), ("rt.map", 43, 189),
             ("rt.map.launch", 60, 101), ("rt.map.sync", 101, 188)]
    ops = [(COPY, 10, 12), (ADD, 30, 31), (K4, 100, 180)]
    return rows((0, 200), spans, ops)


def test_a_gap_is_split_between_the_spans_that_cover_it():
    """The gap 31..100 opens in the injection and lasts through the
    dispatch: ``breakdown`` charges it all to ``rt.inject_source``, the
    split gives each span its own piece."""
    t = shot_step()
    assert (31, 100) in timeline.idle_gaps(t)
    assert dict(timeline.breakdown(t)["idle_gaps"])["rt.inject_source"] == pytest.approx(69e-6)
    idle = host_layers.idle_by_span(t)
    assert idle["rt.inject_source"] == pytest.approx((30 - 15) + (39 - 31))
    assert idle["inject_source"] == pytest.approx(1 + 1)        # 14..15, 39..40
    assert idle["st.map"] == pytest.approx(1 + 1)               # 42..43, 189..190
    assert idle["rt.map"] == pytest.approx((60 - 43) + (189 - 188))
    assert idle["rt.map.launch"] == pytest.approx(100 - 60)
    assert idle["rt.map.sync"] == pytest.approx(188 - 180)


def test_a_program_span_inside_a_benchmark_span_wins():
    t = rows((0, 100), [("st.map", 10, 90), ("rt.map", 12, 88)], [(K4, 0, 5), (K4, 95, 100)])
    assert host_layers.idle_by_span(t) == pytest.approx(
        {None: 5 + 5, "st.map": 2 + 2, "rt.map": 76})


def test_a_gap_under_no_span_counts_in_no_share():
    t = rows((0, 100), [("rt.map", 10, 20)], [(K4, 20, 60)])
    assert host_layers.idle_by_span(t) == pytest.approx({None: 10 + 40, "rt.map": 10})
    assert read("idle_dispatch_pct.map", t) == pytest.approx(10.0)
    for name in ("idle_sync_pct.map", "idle_hooks_pct.map", "idle_launch_pct.fused"):
        assert read(name, t) == 0.0


def test_the_map_shares_and_the_remainder_make_the_idle_share():
    """Dispatch, sync and hooks, plus the idle under other spans (the
    driver's loop, the benchmark's own ranges) and under none, are the
    whole of ``device_idle_pct``."""
    t = shot_step()
    shares = {n: read(f"idle_{n}_pct.map", t) for n in ("dispatch", "sync", "hooks")}
    assert shares["dispatch"] == pytest.approx(100 * (18 + 40) / 200)
    assert shares["sync"] == pytest.approx(100 * 8 / 200)
    # receivers 2..10, the injection 15..30 and 31..39
    assert shares["hooks"] == pytest.approx(100 * (8 + 23) / 200)
    idle = read("device_idle_pct.map", t)
    assert idle == pytest.approx(100 * (1 - (2 + 1 + 80) / 200))
    assigned = {"rt.map", "rt.map.launch", "rt.build", "rt.map.sync",
                "rt.inject_source", "receivers"}
    remainder = sum(v for n, v in host_layers.idle_by_span(t).items() if n not in assigned)
    assert sum(shares.values()) + 100 * remainder / 200 == pytest.approx(idle)
    assert sum(shares.values()) <= idle


def test_idle_launch_leaves_out_the_engines_sync():
    """A solve: the reset's copy, then the launch's host work before the
    first K1 (counted), the window's sync after the last K1 (not), and the
    return through ``rt.timeloop`` and ``rt.launch`` (counted)."""
    spans = [("solve", 1, 299), ("reset", 2, 10), ("st.launch", 11, 298),
             ("rt.launch", 12, 297), ("rt.timeloop", 13, 296),
             ("rt.engine.scalars", 20, 25), ("rt.engine.window", 30, 294),
             ("rt.engine.pad", 31, 35), ("rt.engine.steps", 36, 60),
             ("rt.engine.unpad", 61, 65), ("rt.engine.sync", 66, 290)]
    t = rows((0, 300), spans, [(COPY, 5, 15), ("K1", 50, 280)])
    # counted: all of 15..50 (rt.timeloop, scalars, window, pad, steps),
    # then 290..294 window, 294..296 rt.timeloop, 296..297 rt.launch; not
    # 280..290 (the sync) nor 297..300 (st.launch, solve, none)
    counted = 35 + 4 + 2 + 1
    assert read("idle_launch_pct.fused", t) == pytest.approx(100 * counted / 300)
    assert host_layers.idle_by_span(t)["rt.engine.sync"] == pytest.approx(10)


def test_no_program_span_no_reading():
    """A trace of a program that opens no ``rt.*`` span (the benchmark's
    spans only), or no trace, gives no reading."""
    t = rows((0, 100), [("st.map", 10, 90), ("receivers", 1, 9)], [(K4, 50, 60)])
    for name in ("idle_dispatch_pct.map", "idle_sync_pct.map", "idle_hooks_pct.map",
                 "idle_launch_pct.fused"):
        assert read(name, t) is None
        assert harness.load_module("metrics", name).read(ctx(None)) is None


def test_segments_cover_the_window_once():
    t = shot_step()
    segs = host_layers.segments(t)
    assert segs[0][0] == 0 and segs[-1][1] == 200
    assert all(a < b for a, b, _ in segs)
    assert all(segs[i][1] == segs[i + 1][0] for i in range(len(segs) - 1))
    assert sum(b - a for a, b, _ in segs) == pytest.approx(200)


def drifted(steps, drift):
    """``steps`` of ``shot_step`` back to back, the device's clock running
    ``drift`` (a fraction) fast against the host's from 300 µs behind."""
    one = shot_step()
    spans = [(s.name, s.start, s.end) for s in one.spans if s.name != "window"]
    ops = [(o.name, o.start, o.end) for o in one.ops]
    out = [("user_annotation", "window", 0, 200 * steps, None)]
    for k in range(steps):
        t = 200 * k
        out += [("user_annotation", n, a + t, b + t, None) for n, a, b in spans]
        for i, (name, a, b) in enumerate(ops):
            kind = "gpu_memcpy" if name == COPY else "kernel"
            corr = 10 * k + i
            dev = lambda x: x + t - 300 + drift * (x + t)  # noqa: E731
            out += [("cuda_runtime", "cudaLaunchKernel", a + t, a + t + 1, corr),
                    (kind, name, dev(a), dev(b), corr)]
    return Trace.from_rows(out)


def test_the_clocks_drift_is_taken_out(monkeypatch):
    """A device clock drifting 500 ppm (the card showed ≈ 120) against the
    host's: after the constant offset the last steps' kernels sit 10 µs
    late, so their sync's idle reads short and their dispatch's long; the
    hull puts every operation back on its launch."""
    steps = 100
    want = {n: v * steps for n, v in host_layers.idle_by_span(shot_step()).items()}
    t = drifted(steps, 5e-4)
    got = host_layers.idle_by_span(t)
    assert got == pytest.approx(want, rel=1e-3)
    assert [o.start - o.launch for o in host_layers.aligned(t).ops] == pytest.approx(
        [0.0] * len(t.ops), abs=1e-6)
    monkeypatch.setattr(host_layers, "aligned", lambda tr: tr)
    assert host_layers.idle_by_span(t)["rt.map.sync"] < 0.95 * want["rt.map.sync"]


def test_queued_launches_do_not_bend_the_clock():
    """Solves of a reset's copy launched on an idle card and five kernels
    launched at once behind it: the queued kernels' long launch-to-start
    gaps (the last solve's too) leave the times as they are."""
    ops, spans, corr = [], [], 0
    for k in range(4):
        t = 1000 * k
        spans.append(("rt.engine.sync", t + 60, t + 990))
        ops.append((COPY, t + 10, t + 20, t + 10))
        for j in range(5):
            ops.append(("K1", t + 30 + 180 * j, t + 200 + 180 * j, t + 25 + j))
    out = [("user_annotation", "window", 0, 4000, None)]
    out += [("user_annotation", n, a, b, None) for n, a, b in spans]
    for name, a, b, launch in ops:
        kind = "gpu_memcpy" if name == COPY else "kernel"
        out += [("cuda_runtime", "cudaLaunchKernel", launch, launch + 1, corr),
                (kind, name, a, b, corr)]
        corr += 1
    t = Trace.from_rows(out)
    assert [(o.start, o.end) for o in host_layers.aligned(t).ops] == pytest.approx(
        [(o.start, o.end) for o in t.ops])
