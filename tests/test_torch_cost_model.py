"""Port parity and checks of the analytical cost model
(``repro_torch.core.cost_model``) against the JAX package's.

Equal for equal: ``kernel_fingerprint`` on the suite kernels, and
``predict``'s formula given the same bytes and rates (1e-12 relative: the
same float operations in another order).  The byte accounting is checked
against the plans and, for the torch lowering, against an independent
count of the elements each PyTorch operation reads and writes.  Rates are
``DEFAULT_RATES`` (``calibrate=False``) except where a test seeds them
(``CostModel(rates=...)``) or probes on the CPU at the tiny probe
geometry.
"""
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cost_model as jcm  # noqa: E402
from repro.core import dsl as jst  # noqa: E402
from repro.core import suite as jsuite  # noqa: E402
from repro_torch.core import acoustic, lowering, suite  # noqa: E402
from repro_torch.core import autotune as at  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.core import timeloop as tl  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stencil import codegen  # noqa: E402

F32 = st.f32


def _grids(name="star2d1r", shape=(16, 16)):
    return suite.get_kernel(name), suite.make_grids(name, shape, device="cpu")


def _model(**kw):
    """Deterministic model: no probe timing, default rates."""
    return cm.CostModel(calibrate=False, device="cpu", **kw)


def _seeded(k, grids, swap, rates):
    """A deterministic model holding ``rates`` ({class: Rate}) for this
    kernel and shape."""
    probe = cm._Probe(k, grids, swap, {})
    return _model(rates={cm.rate_key(c, F32, probe): r
                         for c, r in rates.items()})


@pytest.fixture(autouse=True)
def _fresh():
    at.clear_cache()
    at.reset_measure_count()
    cm.reset_default_models()
    yield
    at.clear_cache()
    at.reset_measure_count()
    cm.reset_default_models()


# -- parity ----------------------------------------------------------------
@pytest.mark.parametrize("name", suite.KERNEL_NAMES)
def test_kernel_fingerprint_matches_jax(name):
    # the JAX package takes box3d4r's deep repr only under a raised
    # recursion limit (the port raises it itself)
    import sys
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, cm._REPR_DEPTH))
    try:
        want = jcm.kernel_fingerprint(jsuite.get_kernel(name))
    finally:
        sys.setrecursionlimit(limit)
    assert cm.kernel_fingerprint(suite.get_kernel(name)) == want
    assert sys.getrecursionlimit() == limit


def test_fingerprint_of_acoustic_matches_jax():
    from repro.core import acoustic as jacoustic
    assert (cm.kernel_fingerprint(acoustic.acoustic_iso_kernel)
            == jcm.kernel_fingerprint(jacoustic.acoustic_iso_kernel))


PREDICT_CASES = [  # (backend, fuse, steps): no window remainder under K3
    ("torch", 1, 8), ("torch", 4, 8), ("torch", 8, 8), ("torch", 3, 10),
    ("gmem", 1, 8), ("gmem", 3, 10), ("shift", 4, 16), ("semi", 16, 16),
    ("gmem-k2", 4, 8), ("gmem-k2", 8, 8), ("shift-k4", 8, 16),
]


def _backends(label):
    if label == "torch":
        return st.torch(), jst.xla()
    t, _, k = label.partition("-k")
    k = int(k or 1)
    return (st.hopper(template=t, time_block=k),
            jst.pallas(template=t, time_block=k))


@pytest.mark.parametrize("label,fuse,steps", PREDICT_CASES,
                         ids=[f"{b}-f{f}-s{s}" for b, f, s in PREDICT_CASES])
def test_predict_formula_matches_jax(label, fuse, steps, monkeypatch):
    """Given the port's bytes and one rate, JAX's ``predict`` and the
    port's agree to 1e-12 relative."""
    name, shape = "star3d4r", (16, 24, 40)
    k, grids = _grids(name, shape)
    jk = jsuite.get_kernel(name)
    jgrids = jsuite.make_grids(name, shape)
    be, jbe = _backends(label)
    swap = ("v", "u")
    rate = cm.Rate(bytes_per_s=3.1e11, overhead_s=7.3e-5)
    port = _seeded(k, grids, swap, dict.fromkeys(cm.DEFAULT_RATES, rate))
    halos = {n: g.halo for n, g in grids.items()}
    sb = port.step_bytes(k, halos, shape, be, swap, torch.float32)
    jmodel = jcm.CostModel(calibrate=False)
    monkeypatch.setattr(jmodel, "step_bytes", lambda *a, **kw: sb)
    monkeypatch.setattr(jmodel, "rate_for",
                        lambda *a, **kw: jcm.Rate(rate.bytes_per_s, rate.overhead_s))
    got = port.predict(k, grids, be, fuse, steps, swap)
    want = jmodel.predict(jk, jgrids, jbe, fuse, steps, swap)
    assert math.isfinite(got) and got > 0
    assert got == pytest.approx(want, rel=1e-12, abs=0)


def test_predict_single_application_matches_jax(monkeypatch):
    k, grids = _grids("star3d4r", (16, 24, 40))
    rate = cm.Rate(2e11, 3e-5)
    port = _seeded(k, grids, None, dict.fromkeys(cm.DEFAULT_RATES, rate))
    sb = port.step_bytes(k, {n: g.halo for n, g in grids.items()},
                         (16, 24, 40), st.hopper(template="f4"), None,
                         torch.float32)
    jmodel = jcm.CostModel(calibrate=False)
    monkeypatch.setattr(jmodel, "step_bytes", lambda *a, **kw: sb)
    monkeypatch.setattr(jmodel, "rate_for", lambda *a, **kw: jcm.Rate(2e11, 3e-5))
    got = port.predict(k, grids, st.hopper(template="f4"), 1, 1, None)
    want = jmodel.predict(jsuite.get_kernel("star3d4r"),
                          jsuite.make_grids("star3d4r", (16, 24, 40)),
                          jst.pallas(template="f4"), 1, 1, None)
    assert got == pytest.approx(want, rel=1e-12, abs=0)


# -- byte accounting -------------------------------------------------------
@pytest.mark.parametrize("template,k", [("gmem", 1), ("shift", 1),
                                        ("semi", 1), ("gmem", 2)])
def test_hopper_step_bytes_match_plan(template, k):
    kern, grids = _grids()
    halos = {n: g.halo for n, g in grids.items()}
    backend = st.hopper(template=template, time_block=k)
    plan = codegen.plan_cuda(kern.ir, halos, (16, 16), backend,
                             swap=("v", "u"))
    per_step, per_window = _model().step_bytes(kern, halos, (16, 16), backend,
                                               ("v", "u"), F32)
    assert per_step == plan.hbm_bytes_per_step(4) > 0
    assert per_window == plan.layout_bytes_per_window(4)
    assert plan.kernel_class == {"gmem": "K1", "shift": "K2",
                                 "semi": "K5"}[template] if k == 1 else "K3"


def test_infeasible_plan_costs_inf():
    # a thread block of 2 x 64 x 64 points is 4096 threads: the plan raises
    # ValueError, the model charges inf (and builds nothing)
    k, grids = _grids("star3d4r", shape=(8, 8, 8))
    halos = {n: g.halo for n, g in grids.items()}
    backend = st.hopper(template="gmem", block=(2, 64, 64))
    with pytest.raises(ValueError):
        codegen.plan_cuda(k.ir, halos, (8, 8, 8), backend, swap=("v", "u"))
    sb = _model().step_bytes(k, halos, (8, 8, 8), backend, ("v", "u"), F32)
    assert math.isinf(sb[0])
    assert math.isinf(_model().predict(k, grids, backend, 4, 8, ("v", "u")))


@st.kernel
def _product(u: st.grid, v: st.grid):
    v.at(0, 0).set(u.at(1, 0) * u.at(-1, 0))


def test_semi_on_a_nonlinear_kernel_costs_inf():
    k = _product
    grids = {g: st.grid(F32, (16, 16), 1, device="cpu").randomize(i)
             for i, g in enumerate(k.ir.grid_params)}
    swap = tl.normalize_swap(k.ir, (k.ir.output_grids()[0],
                                    k.ir.input_grids()[0]))
    assert math.isinf(_model().predict(k, grids, st.hopper(template="semi"),
                                       4, 8, swap))


def _counted_torch_bytes(kernel, grids):
    """Elements each PyTorch operation of one ``lower_torch`` application
    reads and writes (full-size tensors only; views and 0-d tensors move
    nothing), counted by a dispatch mode while it runs."""
    from torch.utils._python_dispatch import TorchDispatchMode
    g0 = next(iter(grids.values()))
    n = math.prod(g0.shape)
    views = {"slice", "select", "view", "expand", "as_strided", "alias",
             "unsqueeze", "detach", "lift_fresh"}

    class Count(TorchDispatchMode):
        cells = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func._schema.name.split("::")[-1]
            if name not in views:
                ins = [a for a in list(args) + list((kwargs or {}).values())
                       if isinstance(a, torch.Tensor)]
                if name.endswith("_"):          # in place: self is written
                    ins = ins[1:]
                Count.cells += sum(a.numel() for a in ins if a.numel() == n
                                   and a.stride() != (0,) * a.dim())
                if isinstance(out, torch.Tensor) and out.numel() == n:
                    Count.cells += n
            return out

    fn = lowering.lower_torch(kernel.ir, {k: g.halo for k, g in grids.items()},
                              g0.shape)
    scal = st.scalar_tensors({s: 0.5 for s, _ in kernel.ir.scalar_params},
                             g0.device)
    with Count():
        fn({k: g.data for k, g in grids.items()}, scal)
    return Count.cells * g0.data.element_size()


@pytest.mark.parametrize("name", ["star2d1r", "star3d2r", "box2d1r", "j2d5pt",
                                  "acoustic"])
def test_torch_step_bytes_count_the_lowering(name):
    if name == "acoustic":
        k = acoustic.acoustic_iso_kernel
        fields = acoustic.make_fields((6, 7, 8), pml_width=2, device="cpu")
        grids = dict(zip(k.ir.grid_params, fields[:4]))
    else:
        k, grids = _grids(name, (6, 7, 8) if "3d" in name else (9, 11))
    g0 = next(iter(grids.values()))
    assert cm.torch_step_bytes(k.ir, g0.shape, 4) == _counted_torch_bytes(k, grids)


def test_layout_bytes_per_window():
    # star3d4r: halo = layout halo, the buffers are the grids (0 bytes);
    # acoustic: vp2 and damp (layout halo 0 in halo 4 grids) are cut each
    # window; K3 adds its spares and the copy-back of both swap buffers
    R = (8, 10, 12)
    star = codegen.plan_cuda(suite.get_kernel("star3d4r").ir,
                             {"u": (4,) * 3, "v": (4,) * 3}, R,
                             st.hopper(), swap=("v", "u"))
    assert star.layout_bytes_per_window(4) == 0.0
    ak = acoustic.acoustic_iso_kernel
    halos = {g: (4,) * 3 for g in ak.ir.grid_params}
    plan = codegen.plan_cuda(ak.ir, halos, R, st.hopper(), swap=("p0", "p1"))
    n = math.prod(R)
    assert plan.layout_bytes_per_window(4) == 4 * 2 * 2 * n
    k3 = codegen.plan_cuda(ak.ir, halos, R, st.hopper(time_block=2),
                           swap=("p0", "p1"))
    padded = math.prod(r + 8 for r in R)
    assert k3.layout_bytes_per_window(2) == 2 * (2 * 2 * n + 2 * 2 * padded
                                                 + 2 * 2 * n)
    map_plan = codegen.lower_hopper(ak.ir, halos, R, None, st.hopper())
    assert map_plan.layout_bytes_per_window(4) == 0.0


# -- prediction ------------------------------------------------------------
def test_larger_fuse_predicts_cheaper():
    k, grids = _grids()
    model = _model()
    backend = st.hopper(template="gmem")
    p1 = model.predict(k, grids, backend, 1, 8, ("v", "u"))
    p8 = model.predict(k, grids, backend, 8, 8, ("v", "u"))
    assert p8 < p1  # fewer windows => less layout traffic + overhead


def test_window_remainder_runs_the_single_step_class():
    """k=2, windows of 3: each window is one K3 launch and one single step
    of the template's kernel, each charged at its own class's rate."""
    k, grids = _grids("star2d1r", (16, 16))
    model = _seeded(k, grids, ("v", "u"), {"hopper-K3": cm.Rate(1e9, 1e-4),
                                           "hopper-K1": cm.Rate(4e9, 2e-4)})
    plan, plan1 = model.plans(k, {n: g.halo for n, g in grids.items()},
                              (16, 16), st.hopper(time_block=2), ("v", "u"))
    got = model.predict(k, grids, st.hopper(time_block=2), 3, 9, ("v", "u"))
    want = (3 * (plan.layout_bytes_per_window(4) / 1e9 + 1e-4)
            + 6 * plan.hbm_bytes_per_step(4) / 1e9
            + 3 * plan1.hbm_bytes_per_step(4) / 4e9)
    assert got == pytest.approx(want, rel=1e-12)
    # windows of 1 hold no K3 launch: only the single-step kernel runs
    got1 = model.predict(k, grids, st.hopper(time_block=2), 1, 4, ("v", "u"))
    want1 = 4 * (plan1.layout_bytes_per_window(4) / 4e9 + 2e-4
                 + plan1.hbm_bytes_per_step(4) / 4e9)
    assert got1 == pytest.approx(want1, rel=1e-12)


@pytest.mark.parametrize("template,k,fused,want", [
    ("gmem", 1, True, "hopper-K1"), ("smem", 1, True, "hopper-K1"),
    ("f4", 1, True, "hopper-K1"), ("shift", 1, True, "hopper-K2"),
    ("unroll", 1, True, "hopper-K2"), ("semi", 1, True, "hopper-K5"),
    ("gmem", 2, True, "hopper-K3"), ("semi", 4, True, "hopper-K3"),
    ("gmem", 1, False, "hopper-K4-gmem"), ("f4", 1, False, "hopper-K4-f4"),
    ("smem", 1, False, "hopper-K4-smem"), ("shift", 1, False, "hopper-K2-map"),
    ("semi", 1, False, "hopper-K5-map")])
def test_exec_key_is_the_plans_kernel_class(template, k, fused, want):
    be = st.hopper(template=template, time_block=k)
    swap = ("v", "u") if fused else None
    assert cm.exec_key(be, swap) == want
    kern, grids = _grids("star3d1r", (8, 8, 16))
    halos = {n: g.halo for n, g in grids.items()}
    if fused:
        plan = codegen.plan_cuda(kern.ir, halos, (8, 8, 16), be, swap=swap)
    else:
        plan = codegen.lower_hopper(kern.ir, halos, (8, 8, 16), None, be)
    assert "hopper-" + plan.kernel_class == want


def test_exec_key_of_torch_and_unknown():
    assert cm.exec_key(st.torch(), ("v", "u")) == "torch"
    assert cm.exec_key(st.torch(), None) == "torch-map"
    assert cm.exec_key(object()) is None


def test_predicting_builds_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the cost model built a kernel")
    monkeypatch.setattr(_build, "build_many", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "nvcc", refuse)
    k, grids = _grids("star3d4r", (16, 16, 32))
    model = _model()
    for b in at.default_space(3, (16, 16, 32), ("v", "u")):
        for tb in (1, 2, 4):
            be = b if b.kind == "torch" else st.hopper(
                template=b.template, block=b.block, time_block=tb)
            p = model.predict(k, grids, be, 4, 8, ("v", "u"))
            assert p is not None and p > 0
    for b in at.default_space(3, (16, 16, 32)):
        assert model.predict(k, grids, b, 1, 1, None) > 0


def test_build_identity_builds_nothing_and_tells_builds_apart(monkeypatch):
    monkeypatch.setattr(_build, "build_many", None)
    k, grids = _grids("star3d4r", (16, 16, 32))
    halos = {n: g.halo for n, g in grids.items()}

    def ident(**kw):
        return codegen.plan_cuda(k.ir, halos, (16, 16, 32), st.hopper(**kw),
                                 swap=("v", "u")).build_identity()
    assert ident(template="gmem") == ident(template="smem") == ident(
        template="f4", mem_type="vmem")
    assert ident(template="shift") == ident(template="unroll")
    assert len({ident(template="gmem"), ident(template="shift"),
                ident(template="gmem", block=(16, 8, 64)),
                ident(template="semi"), ident(time_block=2)}) == 5
    assert ident(template="gmem")[1] == (16, 16, 32)


def test_predict_on_a_mesh_is_not_ported():
    k, grids = _grids()
    with pytest.raises(NotImplementedError, match="item 9"):
        _model().predict(k, grids, st.torch(), 1, 8, ("v", "u"),
                         mesh={"data": 4})


def test_grids_on_another_device_are_refused():
    k, grids = _grids()
    model = _model()
    model.device = torch.device("meta")
    with pytest.raises(ValueError, match="cost model for"):
        model.predict(k, grids, st.torch(), 1, 8, ("v", "u"))


# -- rates and calibration -------------------------------------------------
def test_no_calibration_uses_default_rates(monkeypatch):
    monkeypatch.setattr(cm, "time_timeloop", None)   # a probe would fail
    k, grids = _grids()
    probe = cm._Probe(k, grids, ("v", "u"), {})
    model = _model()
    for key, rate in cm.DEFAULT_RATES.items():
        assert model.rate_for(key, F32, probe) == rate
        assert model.rate_for(key, F32) == rate
    assert not model._rates


def test_a_failed_probe_raises(monkeypatch):
    """A calibrating model never falls back to ``DEFAULT_RATES``."""
    def boom(*a, **kw):
        raise RuntimeError("probe launch failed: cudaError 700")
    monkeypatch.setattr(cm, "time_timeloop", boom)
    k, grids = _grids()
    model = cm.CostModel(calibrate=True, device="cpu")
    with pytest.raises(RuntimeError, match="cudaError 700"):
        model.predict(k, grids, st.hopper(), 4, 8, ("v", "u"))
    with pytest.raises(ValueError, match="needs the tuned kernel"):
        model.rate_for("hopper-K1", F32)


@pytest.mark.parametrize("key,k,w", [("hopper-K1", 1, 0.0),
                                     ("hopper-K3", 2, 0.0),
                                     ("hopper-K1", 1, 3e6),
                                     ("torch", 1, 0.0)])
def test_probe_solves_the_model(key, k, w, monkeypatch):
    """Times made by the model's own formula from a known rate give that
    rate back, with and without per-window bytes."""
    true = cm.Rate(bytes_per_s=2.5e9, overhead_s=4e-4)
    kern, grids = _grids()
    model = cm.CostModel(calibrate=True, device="cpu")
    probe = cm._Probe(kern, grids, ("v", "u"), {})
    big = cm._crop(grids, cm._probe_shape(probe))
    b = model._probe_bytes(probe, key, big, 4)
    if key.startswith("hopper"):
        plan = model._probe_plans(probe, key, big)[0]
        monkeypatch.setattr(type(plan), "layout_bytes_per_window",
                            lambda self, itemsize=4: w)

    def fake(kernel, grids, scalars, backend, fuse, steps, swap, iters):
        blocked, single, windows = tl.launch_steps(steps, fuse, k)
        return [(steps * b + windows * w) / true.bytes_per_s
                + windows * true.overhead_s] * iters
    monkeypatch.setattr(cm, "time_timeloop", fake)
    got = model._probe(probe, key, big, big)
    assert got.bytes_per_s == pytest.approx(true.bytes_per_s, rel=1e-9)
    assert got.overhead_s == pytest.approx(true.overhead_s, rel=1e-9)


def test_map_probe_solves_the_model(monkeypatch):
    true = cm.Rate(bytes_per_s=1.5e9, overhead_s=2e-4)
    kern, grids = _grids("star2d1r", (32, 32))
    model = cm.CostModel(calibrate=True, device="cpu")
    probe = cm._Probe(kern, grids, None, {})
    big = cm._crop(grids, (32, 32))
    small = cm._crop(grids, (16, 16))

    def fake(kernel, grids, scalars, backend, iters, apps=1):
        b = model._probe_bytes(probe, "hopper-K4-gmem", grids, 4)
        return [b / true.bytes_per_s + true.overhead_s] * iters
    monkeypatch.setattr(cm, "time_map", fake)
    got = model._probe(probe, "hopper-K4-gmem", big, small)
    assert got.bytes_per_s == pytest.approx(true.bytes_per_s, rel=1e-9)
    assert got.overhead_s == pytest.approx(true.overhead_s, rel=1e-9)


def test_cpu_probe_calibrates_persists_and_reloads(tmp_path):
    """A calibrating model on CPU grids probes the plain versions at the
    tiny probe geometry, keys each rate by kernel and geometry, and
    persists them beside the tune cache."""
    k, grids = _grids("star2d1r", (40, 24))
    model = cm.CostModel(cache_dir=str(tmp_path), calibrate=True, device="cpu")
    p = model.predict(k, grids, st.hopper(template="gmem"), 4, 8, ("v", "u"))
    assert math.isfinite(p) and p > 0
    (rk,) = model._rates
    assert rk == f"hopper-K1@{cm.kernel_fingerprint(k)}@32x24/float32"
    r = model._rates[rk]
    assert r.bytes_per_s >= 1.0 and r.overhead_s >= 1e-8
    files = os.listdir(tmp_path)
    assert files == [f"roofline-v{cm.CALIBRATION_VERSION}-cpu.json"]
    again = cm.CostModel(cache_dir=str(tmp_path), calibrate=False, device="cpu")
    assert again.predict(k, grids, st.hopper(template="gmem"), 4, 8,
                         ("v", "u")) == p


def test_rates_persist_next_to_cache(tmp_path):
    cdir = str(tmp_path)
    r = cm.Rate(bytes_per_s=3e9, overhead_s=5e-5)
    m = _model(cache_dir=cdir, rates={cm.rate_key("torch", F32): r})
    m._store_rates()
    files = [f for f in os.listdir(cdir) if f.startswith("roofline-")]
    assert len(files) == 1
    assert f"v{cm.CALIBRATION_VERSION}" in files[0] and "-cpu" in files[0]
    m2 = _model(cache_dir=cdir)
    assert m2.rate_for("torch", F32) == r


def test_seeded_rates_come_before_stored_and_default_ones(tmp_path):
    """``rates=`` holds for its kernel and probe geometry only: a stored
    rate of the same key is not read over it, and another shape still
    takes ``DEFAULT_RATES``."""
    k, grids = _grids("star2d1r", (16, 16))
    probe = cm._Probe(k, grids, ("v", "u"), {})
    rk = cm.rate_key("hopper-K1", F32, probe)
    assert rk == f"hopper-K1@{cm.kernel_fingerprint(k)}@16x16/float32"
    stored = cm.Rate(1e9, 1e-3)
    _model(cache_dir=str(tmp_path), rates={rk: stored})._store_rates()
    seeded = cm.Rate(7e9, 2e-5)
    m = _model(cache_dir=str(tmp_path), rates={rk: seeded})
    assert m.rate_for("hopper-K1", F32, probe) == seeded
    assert m.rate_for("hopper-K2", F32, probe) == cm.DEFAULT_RATES["hopper-K2"]
    k2, grids2 = _grids("star2d1r", (16, 24))
    assert (m.rate_for("hopper-K1", F32, cm._Probe(k2, grids2, ("v", "u"), {}))
            == cm.DEFAULT_RATES["hopper-K1"])
    assert _model(cache_dir=str(tmp_path)).rate_for("hopper-K1", F32, probe) == stored


def test_stale_calibration_version_ignored(tmp_path):
    cdir = str(tmp_path)
    m = _model(cache_dir=cdir, rates={cm.rate_key("torch", F32): cm.Rate(3e9, 5e-5)})
    m._store_rates()
    path = m._cal_path()
    with open(path) as f:
        blob = json.load(f)
    blob["version"] = cm.CALIBRATION_VERSION + 1
    with open(path, "w") as f:
        json.dump(blob, f)
    m2 = _model(cache_dir=cdir)
    assert m2.rate_for("torch", F32) == cm.DEFAULT_RATES["torch"]


def test_device_tag_and_default_device(monkeypatch):
    assert cm.device_tag("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cm.CostModel()
    assert cm.default_model(None, "cpu") is cm.default_model(None, "cpu")
    assert cm.default_model("x", "cpu") is not cm.default_model(None, "cpu")


def test_crop_keeps_the_central_box_and_its_neighbours():
    g = st.grid(F32, (10, 12), 2, device="cpu")
    g.data.copy_(torch.arange(14 * 16, dtype=torch.float32).view(14, 16))
    (c,) = cm._crop({"u": g}, (4, 6)).values()
    assert c.shape == (4, 6) and c.order == 2
    np.testing.assert_array_equal(c.data.numpy(), g.data[3:11, 3:13].numpy())
    c.data.zero_()
    assert g.data.abs().sum() > 0          # a copy
