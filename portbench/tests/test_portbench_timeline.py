"""The trace readers on synthetic traces: idle share, auxiliary share,
roofline share, dispatch time and the breakdown."""
import pytest

from portbench import harness
from portbench.metrics import timeline
from portbench.metrics.timeline import Op, Span, Trace

K = "map_step_kernel(Params)"
COPY = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>"


def shot_trace():
    """A window of 0..100 µs: two st.map calls whose kernels are launched
    8 µs and 28 µs after their spans start and start 2 µs later; an ATen
    kernel and a memcpy beside them."""
    ops = [Op(K, "kernel", 15, 40, 13), Op(COPY, "kernel", 42, 44, 41.5),
           Op("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 44, 46),
           Op(K, "kernel", 80, 95, 78), Op(K, "kernel", 200, 300, 198)]
    spans = [Span("window", 0, 100), Span("shot", 1, 99), Span("st.map", 5, 41),
             Span("inject_source", 41, 43), Span("st.map", 50, 96)]
    return Trace(ops, spans, (0, 100))


def ctx(trace, steps=2, boundaries=2, kind="NVIDIA H100 80GB HBM3"):
    cfg = {"shape": [512, 512, 512], "flops_per_point": 43, "dtype": "f32",
           "reads": ["p0", "p1", "vp2", "damp"], "writes": ["p0"]}
    return harness.Ctx(cfg, kind, 512 ** 3, 1.0, steps, boundaries, [], 1.0, trace)


def read(name, c):
    return harness.load_module("metrics", name).read(c)


def test_union_and_gaps():
    assert timeline.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    t = shot_trace()
    assert t.busy_us() == 25 + 4 + 15
    assert timeline.idle_gaps(t) == [(0, 15), (40, 42), (46, 80), (95, 100)]


def test_device_idle_pct():
    assert read("device_idle_pct", ctx(shot_trace())) == pytest.approx(100 * (1 - 44 / 100))


def test_aux_device_pct():
    assert read("aux_device_pct", ctx(shot_trace())) == pytest.approx(100 * 4 / 44)


def test_kernel_roofline_pct():
    # two byte-bound steps (0.801 ms each) over 40 µs of stencil kernels
    want = 100 * 2 * 5 * 512 ** 3 * 4 / 3.35e12 / 40e-6
    assert read("kernel_roofline_pct", ctx(shot_trace())) == pytest.approx(want)
    assert read("kernel_roofline_pct", ctx(None)) is None


def test_dispatch_us_map():
    assert read("dispatch_us.map", ctx(shot_trace())) == pytest.approx((8 + 28) / 2)
    empty = Trace([], [Span("window", 0, 10)], (0, 10))
    assert read("dispatch_us.map", ctx(empty)) is None


def test_breakdown_names_gaps_by_host_span():
    b = timeline.breakdown(shot_trace())
    assert b["device_ops"][0] == [K, pytest.approx(40e-6)]
    # gaps 0..15 (window only), 40..42 and 95..100 (inside st.map), 46..80
    # (between two st.map calls of the shot)
    assert dict(b["idle_gaps"]) == {"window": pytest.approx(15e-6),
                                    "st.map": pytest.approx(7e-6),
                                    "shot": pytest.approx(34e-6)}
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_host_spans_at_sweep():
    t = shot_trace()
    assert timeline.host_spans_at(t, [0.5, 3, 6, 42, 60, 99.5]) == [
        "window", "shot", "st.map", "inject_source", "st.map", "window"]


def test_device_times_align_to_the_launches():
    """A device clock 600 µs behind the host's: shifted so the fastest
    launch-to-start gap is 0; spans and launches keep the host's times."""
    rows = [("user_annotation", "window", 0, 2000, None),
            ("user_annotation", "st.map", 100, 900, None),
            ("cuda_runtime", "cudaLaunchKernel", 110, 115, 7),
            ("kernel", K, 712, 1312, 7),
            ("cuda_runtime", "cudaMemcpyAsync", 950, 960, 8),
            ("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 1700, 1710, 8)]
    t = Trace.from_rows(rows)
    assert t.offset_us == 602
    assert t.ops[0] == Op(K, "kernel", 110, 710, 110)
    assert t.ops[1].start == 1098 and t.ops[1].launch == 950
    assert t.window == (0, 2000) and [s.name for s in t.spans] == ["window", "st.map"]
