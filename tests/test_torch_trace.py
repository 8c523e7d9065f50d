"""The port's host spans (``core/trace.py``): no profiler range opened while
no profiler records, the spans' nesting in a profiler's trace on the CPU,
their names, and the launch profile they feed."""
import ast
import json
import os
import pathlib
import tempfile

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import acoustic, trace  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"
# the ranges the benchmark (portbench/drivers) opens around its calls
BENCH_SPANS = {"window", "solve", "shot", "reset", "st.launch", "st.map",
               "inject_source", "receivers"}
EPS = 0.01      # µs: the Chrome trace rounds each start and length


def _fields(shape=(16, 16, 16)):
    return acoustic.make_fields(shape, pml_width=3, device="cpu")


def _inject(t, grids):
    acoustic.inject_source(grids["p1"], t)


@st.target
def _shot(p0, p1, vp2, damp, dt, steps, k=acoustic.acoustic_iso_kernel):
    """The benchmark's shot, step by step: injection, then one st.map."""
    for t in range(steps):
        acoustic.inject_source(p1, t)
        st.map(e=p0.shape)(k)(p0, p1, vp2, damp, dt)
        p0.data, p1.data = p1.data, p0.data


def _ranges(prof):
    """The trace's ``record_function`` ranges, ``(name, start, end)`` in µs,
    outer before inner."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _within(ranges, outer, name):
    return [r for r in ranges if r[0] == name and r is not outer
            and outer[1] - EPS <= r[1] and r[2] <= outer[2] + EPS]


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def _span_names():
    """Every name given to ``span(...)`` in the port's source."""
    names = set()
    for path in SRC.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and node.args
                    and getattr(node.func, "attr", getattr(node.func, "id", None)) == "span"
                    and isinstance(node.args[0], ast.Constant)):
                names.add(node.args[0].value)
    return names


def test_no_profiler_opens_no_range(monkeypatch):
    """With no profiler recording, ``st.map``, ``st.timeloop`` and
    ``inject_source`` (inside and outside a launch) open no
    ``record_function``; a span with no phase outside a launch is the
    shared no-op after one check of the profiler's flag."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")
    monkeypatch.setattr(trace, "record_function", refuse)
    p0, p1, vp2, damp, dt = _fields()
    st.launch(backend=st.hopper())(_shot)(p0, p1, vp2, damp, dt, 2)
    st.launch(backend=st.hopper(), fuse_steps=2)(acoustic.acoustic_target_fused)(
        p0, p1, vp2, damp, dt, 4, between=_inject)
    st.map(e=p0.shape)(acoustic.acoustic_iso_kernel)(p0, p1, vp2, damp, dt)
    st.timeloop(3, swap=("p0", "p1"))(acoustic.acoustic_iso_kernel)(p0, p1, vp2, damp, dt)
    acoustic.inject_source(p1, 5)

    checks = []
    monkeypatch.setattr(trace, "_profiler_enabled", lambda: checks.append(1) or False)
    assert trace.span("rt.map") is trace.span("rt.map.sync", phase="kernel") is trace._OFF
    assert len(checks) == 2


def test_map_spans_nest_once_a_call():
    """Each ``st.map`` is one ``rt.map`` holding one ``rt.map.launch`` and
    one ``rt.map.sync``; each injection one ``rt.inject_source``; all of a
    launch inside its ``rt.launch``."""
    p0, p1, vp2, damp, dt = _fields()
    st.launch(backend=st.hopper())(_shot)(p0, p1, vp2, damp, dt, 1)     # builds
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st.launch(backend=st.hopper())(_shot)(p0, p1, vp2, damp, dt, 3)
    ranges = _ranges(prof)
    (launch,) = _named(ranges, "rt.launch")
    maps = _named(ranges, "rt.map")
    assert len(maps) == 3 and len(_within(ranges, launch, "rt.map")) == 3
    for m in maps:
        assert len(_within(ranges, m, "rt.map.launch")) == 1
        assert len(_within(ranges, m, "rt.map.sync")) == 1
        assert not _within(ranges, m, "rt.build")
    assert len(_within(ranges, launch, "rt.inject_source")) == 3
    assert {r[0] for r in ranges} <= _span_names()


@pytest.mark.parametrize("template", ["torch", "gmem"])
def test_timeloop_spans_nest_once_a_solve(template):
    """Each ``st.timeloop`` solve is one ``rt.timeloop`` holding the
    engine's spans: the scalars once, per window ``rt.engine.window`` with
    its sync (and, on the hopper backend, the layout cut, the launches and
    the write-back), the hook between windows with its injection."""
    be = st.torch() if template == "torch" else st.hopper(template=template)
    p0, p1, vp2, damp, dt = _fields()
    run = st.launch(backend=be, fuse_steps=2)(acoustic.acoustic_target_fused)
    run(p0, p1, vp2, damp, dt, 6, between=_inject)                      # builds
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            run(p0, p1, vp2, damp, dt, 6, between=_inject)
    ranges = _ranges(prof)
    loops = _named(ranges, "rt.timeloop")
    assert len(loops) == 2
    per_window = ["rt.engine.window", "rt.engine.sync"]
    if template != "torch":
        per_window += ["rt.engine.pad", "rt.engine.steps", "rt.engine.unpad"]
    for loop in loops:
        assert len(_within(ranges, loop, "rt.engine.scalars")) == 1
        for name in per_window:
            assert len(_within(ranges, loop, name)) == 3, name
        hooks = _within(ranges, loop, "rt.engine.between")
        assert len(hooks) == 2
        for h in hooks:
            assert len(_within(ranges, h, "rt.inject_source")) == 1
        assert not _within(ranges, loop, "rt.build")
    for w in _named(ranges, "rt.engine.window"):
        assert len(_within(ranges, w, "rt.engine.sync")) == 1
    assert {r[0] for r in ranges} <= _span_names()


def test_span_names_are_the_programs_own():
    """Every span of the port is named ``rt.…`` and none is a name of the
    benchmark's own ranges; each is listed in ``trace``'s table."""
    names = _span_names()
    assert len(names) >= 17
    for n in names:
        assert n.startswith(trace.PREFIX) and n not in BENCH_SPANS, n
        assert f"``{n}``" in trace.__doc__, n


def test_build_span_only_on_a_cache_miss():
    """``rt.build`` marks the first call of a shape (``st.map`` and
    ``st.timeloop``), not the second."""
    k = st.Kernel(acoustic.acoustic_iso_kernel.fn)
    p0, p1, vp2, damp, dt = _fields((12, 14, 18))
    for run in (st.launch(backend=st.hopper())(lambda *a: _shot(*a, k=k)),
                st.launch(backend=st.hopper())(
                    lambda *a: st.timeloop(a[-1], swap=("p0", "p1"))(k)(*a[:-1]))):
        counts = []
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                res = run(p0, p1, vp2, damp, dt, 2)
            counts.append(len(_named(_ranges(prof), "rt.build")))
            assert ("codegen" in res.profile) == (len(counts) == 1)
        assert counts == [1, 0]


_KEYS = {"map": ({"codegen", "kernel", "total"}, {"kernel", "total"}),
         "timeloop": ({"codegen", "kernel", "total"}, {"kernel", "total"}),
         "timeloop-hopper": ({"codegen", "layout", "kernel", "total"},
                             {"layout", "kernel", "total"}),
         "mesh": ({"codegen", "scatter", "kernel", "gather", "total"},
                  {"scatter", "kernel", "gather", "total"})}


@pytest.mark.parametrize("path", ["map", "timeloop", "mesh"])
@pytest.mark.parametrize("inner", ["torch", "gmem"])
def test_launch_profile_keeps_its_phases(path, inner):
    """``LaunchResult.profile`` holds the phases it held before the spans
    fed it, on the first call (with ``codegen``) and the next, and its
    ``total`` covers its other phases."""
    be = st.torch() if inner == "torch" else st.hopper(template=inner)
    key = path + ("-hopper" if path == "timeloop" and inner != "torch" else "")
    k = st.Kernel(acoustic.acoustic_iso_kernel.fn)
    p0, p1, vp2, damp, dt = _fields()
    if path == "map":
        run = st.launch(backend=be)(lambda *a: _shot(*a, k=k))
        args = (p0, p1, vp2, damp, dt, 2)
    else:
        mesh = None
        if path == "mesh":
            mesh = pmesh.make_mesh((2,), ("data",), devices=[torch.device("cpu")] * 2)
            be = st.distributed(grid_axes=("data", None, None), inner=be)

        @st.target
        def run_(*a):
            return st.timeloop(4, swap=("p0", "p1"), between=_inject)(k)(*a)
        run = st.launch(backend=be, mesh=mesh, fuse_steps=2)(run_)
        args = (p0, p1, vp2, damp, dt)
    for want in _KEYS[key]:
        prof = run(*args).profile
        assert set(prof) == want
        assert prof["total"] >= max(v for n, v in prof.items() if n != "total") > 0


def test_nested_launch_keeps_its_own_profile():
    """A launch inside a launch (the autotuner's measurements) fills its
    own profile; the outer one resumes after it."""
    p0, p1, vp2, damp, dt = _fields()
    inner = {}

    @st.target
    def outer(*a):
        inner["profile"] = st.launch(backend=st.torch())(_shot)(*a, 1).profile
        st.map(e=p0.shape)(acoustic.acoustic_iso_kernel)(*a)

    prof = st.launch(backend=st.torch())(outer)(p0, p1, vp2, damp, dt).profile
    assert set(inner["profile"]) >= {"kernel", "total"}
    assert set(prof) >= {"kernel", "total"}
    assert prof["total"] > inner["profile"]["total"]
    with trace.span("rt.map.launch", phase="kernel"):        # no launch: no sink
        pass
    assert trace._SINK.profile is None
