"""Port parity and checks of the autotuner (``repro_torch.core.autotune``)
and ``st.launch(autotune=True)`` against the JAX package.

Equal for equal: ``shape_bucket``, ``shortlist_indices`` on seeded random
prediction lists with ``None``/``inf``/ties, and ``_normalize_space`` on the
same space (``pallas`` → ``hopper``, ``xla`` → ``torch``).  Then the JAX
package's disk-cache and two-stage cases (``tests/test_autotune_cache.py``,
``tests/test_cost_model.py``) on CPU tensors, where the hopper candidates
run their kernels' plain versions; the port's own rules: only a plan's
``ValueError`` scores ``inf``, every other failure raises out of ``tune``;
candidates that launch the same builds are timed once; and a tuned
``st.launch`` equals ``st.torch()`` (f32, 1e-5: the suite's weights sum to
1, so values stay O(1)).
"""
import glob
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import autotune as jat  # noqa: E402
from repro.core import dsl as jst  # noqa: E402
from repro_torch.core import acoustic, suite  # noqa: E402
from repro_torch.core import autotune as at  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

SPACE = [st.torch()]
FUSE = (1, 4)


def _grids(name="star2d1r", shape=(12, 18), dtype=st.f32):
    k = suite.get_kernel(name)
    return k, {g: st.grid(dtype, shape, k.info.order, device="cpu").randomize(i)
               for i, g in enumerate(k.ir.grid_params)}


def _tune(cdir, shape=(12, 18), name="star2d1r", space=SPACE, fuse=FUSE):
    k, grids = _grids(name, shape)
    return at.tune(k, grids, iters=1, space=space,
                   swap=suite.swap_pair(name), steps=4, fuse_space=fuse,
                   time_block_space=(1,), cache_dir=str(cdir))


def _measured():
    return at.MEASURE_COUNT["measured_candidates"]


def _model():
    return cm.CostModel(calibrate=False, device="cpu")


@pytest.fixture(autouse=True)
def _fresh_counters():
    at.clear_cache()
    at.reset_measure_count()
    cm.reset_default_models()
    yield
    at.clear_cache()
    at.reset_measure_count()
    cm.reset_default_models()


# -- parity ------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_shape_bucket_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        shape = tuple(int(s) for s in rng.integers(0, 2000,
                                                   size=rng.integers(0, 4)))
        assert at.shape_bucket(shape) == jat.shape_bucket(shape)


@pytest.mark.parametrize("seed", range(6))
def test_shortlist_indices_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(0, 12))
        pool = [None, float("inf"), 1.0, 2.0]
        preds = [pool[int(rng.integers(0, 4))] if rng.random() < 0.5
                 else float(rng.integers(0, 5)) for _ in range(n)]
        top_k = int(rng.integers(1, 6))
        assert at.shortlist_indices(preds, top_k) == \
            jat.shortlist_indices(preds, top_k)


def _to_jax(entry):
    def one(b):
        if b.kind == "torch":
            return jst.xla()
        return jst.pallas(template=b.template, block=b.block,
                          mem_type=b.mem_type, time_block=b.time_block)
    return (one(entry[0]), entry[1]) if isinstance(entry, tuple) else one(entry)


def _flat(cands):
    return [(b.kind.replace("xla", "torch").replace("pallas", "hopper"),
             getattr(b, "template", None), getattr(b, "block", None),
             getattr(b, "mem_type", None), int(getattr(b, "time_block", 1) or 1),
             f) for b, f in cands]


NORM_SPACES = {
    "default-2d": [st.torch(), st.hopper(template="gmem"),
                   st.hopper(template="shift", block=(16, 128)),
                   st.hopper(template="semi", mem_type="vmem")],
    "pinned-depth": [st.hopper(template="gmem", time_block=8)],
    "pairs": [st.hopper(template="gmem"),
              (st.hopper(template="gmem", time_block=2), 4),
              (st.torch(), 9), (st.hopper(template="f4", time_block=4), 6)],
    "overlap": [st.hopper(template="gmem"), st.hopper(template="gmem"),
                (st.hopper(template="gmem"), 4)],
}


@pytest.mark.parametrize("swap", [("v", "u"), None], ids=["loop", "map"])
@pytest.mark.parametrize("steps,fuse,tbs", [(8, (1, 4, 16), (1, 2, 4)),
                                            (20, (8,), (1, 2)),
                                            (5, (2, 3), (3,))])
@pytest.mark.parametrize("space", sorted(NORM_SPACES))
def test_normalize_space_matches_jax(space, steps, fuse, tbs, swap):
    entries = NORM_SPACES[space]
    got = at._normalize_space(entries, 2, (16, 24), swap, steps, fuse,
                              tbs if swap else (1,))
    want = jat._normalize_space([_to_jax(e) for e in entries], 2, (16, 24),
                                swap, steps, fuse, tbs if swap else (1,))
    assert _flat(got) == _flat(want)


def test_default_space_on_this_card():
    loop = at.default_space(3, (512,) * 3, ("v", "u"))
    assert [(b.kind, getattr(b, "template", None), getattr(b, "block", None))
            for b in loop] == [
        ("torch", None, None), ("hopper", "gmem", None),
        ("hopper", "gmem", (16, 8, 64)), ("hopper", "shift", None),
        ("hopper", "shift", (64, 16, 64)), ("hopper", "semi", None)]
    per_app = at.default_space(3, (512,) * 3)
    assert [getattr(b, "template", None) for b in per_app] == [
        None, "gmem", "gmem", "f4", "smem", "shift", "shift", "semi"]
    assert [getattr(b, "template", None)
            for b in at.default_space(2, (64, 64), ("v", "u"))] == [
        None, "gmem", "shift", "semi"]


# -- disk cache (the JAX package's tests/test_autotune_cache.py) ------------
def test_round_trip_warm_measures_nothing(tmp_path):
    res = _tune(tmp_path)
    assert _measured() == len(SPACE) * len(FUSE)
    files = glob.glob(str(tmp_path / "tune-*.json"))
    assert len(files) == 1
    at.clear_cache()
    at.reset_measure_count()
    warm = _tune(tmp_path)
    assert _measured() == 0
    assert warm.fuse_steps == res.fuse_steps
    assert warm.backend.kind == res.backend.kind
    assert len(warm.trials) == len(res.trials)
    assert warm.timing == pytest.approx(res.timing)
    assert not glob.glob(str(tmp_path / "*.tmp"))


def test_same_bucket_different_shape_hits(tmp_path):
    _tune(tmp_path, shape=(12, 18))         # bucket (16, 32)
    at.clear_cache()
    at.reset_measure_count()
    _tune(tmp_path, shape=(9, 17))          # same bucket
    assert _measured() == 0
    at.clear_cache()
    at.reset_measure_count()
    _tune(tmp_path, shape=(20, 20))         # bucket (32, 32) -> cold
    assert _measured() == len(SPACE) * len(FUSE)


@pytest.mark.parametrize("change", ["fuse", "kernel"])
def test_config_change_invalidates(tmp_path, change):
    _tune(tmp_path)
    at.clear_cache()
    at.reset_measure_count()
    if change == "fuse":
        _tune(tmp_path, fuse=(1, 2))        # different search space
    else:
        _tune(tmp_path, name="star2d2r")    # different kernel fingerprint
    assert _measured() > 0


def test_schema_bump_invalidates(tmp_path):
    _tune(tmp_path)
    (path,) = glob.glob(str(tmp_path / "tune-*.json"))
    with open(path) as f:
        entry = json.load(f)
    entry["schema"] = at.SCHEMA_VERSION + 1
    entry["key"]["schema"] = at.SCHEMA_VERSION + 1
    with open(path, "w") as f:
        json.dump(entry, f)
    at.clear_cache()
    at.reset_measure_count()
    _tune(tmp_path)
    assert _measured() == len(SPACE) * len(FUSE)


def test_corrupt_entry_is_a_miss(tmp_path):
    _tune(tmp_path)
    (path,) = glob.glob(str(tmp_path / "tune-*.json"))
    with open(path, "w") as f:
        f.write("{ not json")
    at.clear_cache()
    at.reset_measure_count()
    res = _tune(tmp_path)
    assert _measured() == len(SPACE) * len(FUSE)
    assert res.fuse_steps in FUSE
    with open(path) as f:
        assert json.load(f)["schema"] == at.SCHEMA_VERSION


def test_clear_disk_cache(tmp_path):
    _tune(tmp_path)
    _tune(tmp_path, shape=(20, 20))
    assert at.clear_disk_cache(str(tmp_path)) == 2
    assert not glob.glob(str(tmp_path / "tune-*.json"))
    assert at.clear_disk_cache(str(tmp_path / "nonexistent")) == 0


def test_env_var_directory(tmp_path, monkeypatch):
    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path))
    assert at.cache_dir_from_env() == str(tmp_path)
    k, grids = _grids()
    at.tune(k, grids, iters=1, space=SPACE, swap=("v", "u"), steps=4,
            fuse_space=FUSE, time_block_space=(1,))
    assert len(glob.glob(str(tmp_path / "tune-*.json"))) == 1


def test_fingerprint_and_bucket_helpers():
    k = suite.get_kernel("star2d1r")
    fp = at.kernel_fingerprint(k)
    assert fp == at.kernel_fingerprint(k) and len(fp) == 16
    assert fp != at.kernel_fingerprint(suite.get_kernel("star2d2r"))
    assert at.shape_bucket((12, 18)) == (16, 32)
    assert at.shape_bucket((3, 8, 513)) == (8, 8, 1024)


def test_shape_bucket_edge_cases():
    assert at.shape_bucket(()) == ()
    assert at.shape_bucket((1, 1)) == (8, 8)
    assert at.shape_bucket((0,)) == (8,)
    assert at.shape_bucket((8,)) == (8,)
    assert at.shape_bucket((17, 100, 513)) == (32, 128, 1024)


def test_disk_key_distinguishes_dtype():
    k = suite.get_kernel("star2d1r")

    def key_for(dtype):
        grids = {g: st.grid(dtype, (12, 18), k.info.order, device="cpu")
                 for g in k.ir.grid_params}
        return at._disk_key(k, grids, 1, SPACE, ("v", "u"), 4, FUSE, (1,),
                            3)

    d32, r32 = key_for(st.f32)
    d64, r64 = key_for(st.f64)
    assert d32 != d64
    assert r32["geometry"] == [["u", 1, "float32"], ["v", 1, "float32"]]


def test_disk_key_includes_top_k_calibration_and_device():
    k, grids = _grids()

    def key_for(top_k):
        return at._disk_key(k, grids, 1, SPACE, ("v", "u"), 4, FUSE, (1,),
                            top_k)
    d3, readable = key_for(3)
    d_none, _ = key_for(None)
    assert d3 != d_none
    assert readable["calibration"] == cm.CALIBRATION_VERSION
    assert readable["device"] == "cpu" and "jax_backend" not in readable


def test_purge_stale_removes_old_schema_entries(tmp_path):
    _tune(tmp_path)
    _tune(tmp_path, shape=(20, 20))
    files = sorted(glob.glob(str(tmp_path / "tune-*.json")))
    assert len(files) == 2
    with open(files[0]) as f:
        entry = json.load(f)
    entry["schema"] = at.SCHEMA_VERSION - 1
    with open(files[0], "w") as f:
        json.dump(entry, f)
    assert at.purge_stale(str(tmp_path)) == 1
    assert glob.glob(str(tmp_path / "tune-*.json")) == [files[1]]
    with open(files[1], "w") as f:
        f.write("{ not json")
    assert at.purge_stale(str(tmp_path)) == 1
    assert not glob.glob(str(tmp_path / "tune-*.json"))
    assert at.purge_stale(str(tmp_path / "missing")) == 0


def test_first_touch_purges_then_retunes(tmp_path):
    _tune(tmp_path)
    (path,) = glob.glob(str(tmp_path / "tune-*.json"))
    with open(path) as f:
        entry = json.load(f)
    entry["schema"] = at.SCHEMA_VERSION - 1
    with open(path, "w") as f:
        json.dump(entry, f)
    at.clear_cache()
    at.reset_measure_count()
    at._PURGED.discard(str(tmp_path))
    _tune(tmp_path)
    assert _measured() == len(SPACE) * len(FUSE)
    (path2,) = glob.glob(str(tmp_path / "tune-*.json"))
    with open(path2) as f:
        assert json.load(f)["schema"] == at.SCHEMA_VERSION


def test_disk_round_trip_preserves_search_stats(tmp_path):
    k = suite.get_kernel("star2d1r")

    def tune(top_k):
        _, grids = _grids()
        return at.tune(k, grids, iters=1,
                       space=[st.torch(), st.hopper(template="gmem")],
                       swap=("v", "u"), steps=4, fuse_space=(1, 2, 4),
                       time_block_space=(1, 2), cache_dir=str(tmp_path),
                       top_k=top_k, cost_model=_model())

    cold = tune(3)
    assert cold.pruned_candidates == 6 and cold.measured_candidates == 3
    at.clear_cache()
    at.reset_measure_count()
    warm = tune(3)
    assert _measured() == 0
    assert warm.pruned_candidates == cold.pruned_candidates
    assert warm.measured_candidates == cold.measured_candidates
    assert warm.rank_error == cold.rank_error
    assert warm.top_k == 3
    assert len(warm.predicted) == len(cold.predicted) == 9
    got = [(b.cache_key(), f, p) for b, f, p in warm.predicted]
    want = [(b.cache_key(), f, p) for b, f, p in cold.predicted]
    assert got == want


# -- two-stage search (the JAX package's tests/test_cost_model.py) -----------
TWO_STAGE = [st.torch(), st.hopper(template="gmem")]


def _two_stage(top_k, model, iters=1):
    k, grids = _grids("star2d1r", (16, 16))
    return at.tune(k, grids, iters=iters, space=TWO_STAGE, swap=("v", "u"),
                   steps=4, fuse_space=(1, 2, 4), time_block_space=(1, 2),
                   top_k=top_k, cost_model=model)


def test_two_stage_measures_exactly_top_k():
    # torch x 3 fuse + gmem x 3 fuse x 2 time_block = 9 candidates
    res = _two_stage(3, _model())
    assert len(res.predicted) == 9
    assert res.measured_candidates == 3
    assert res.pruned_candidates == 6
    assert at.MEASURE_COUNT["measured_candidates"] == 3
    assert at.MEASURE_COUNT["pruned_candidates"] == 6
    assert res.top_k == 3
    assert all(p is not None for _, _, p in res.predicted)


def test_exhaustive_when_top_k_none():
    res = _two_stage(None, _model())
    assert res.measured_candidates == 9
    assert res.pruned_candidates == 0
    assert res.top_k is None
    assert len(res.predicted) == 9


def test_no_model_no_predictions_when_not_pruning():
    res = _two_stage(None, None)
    assert res.predicted == []
    assert res.rank_error is None
    assert res.measured_candidates == 9


def test_rank_error_within_shortlist():
    res = _two_stage(3, _model())
    assert res.rank_error is not None and res.rank_error < 3


def test_two_stage_winner_close_to_exhaustive(monkeypatch):
    # the JAX case times µs-scale runs on the host and bounds the ratio by
    # 1.5; here each candidate "measures" its default-rate prediction
    # (deterministic), so the two-stage winner is the exhaustive one
    model = _model()

    def timed(kernel, grids, scalars, backend, fuse, steps, swap, iters):
        return model.predict(kernel, grids, backend, fuse, steps, swap)
    monkeypatch.setattr(at, "_measure_timeloop", timed)
    exhaustive = _two_stage(None, model, iters=3)
    at.clear_cache()
    pruned = _two_stage(3, model, iters=3)
    ex = {(b.cache_key(), f): dt for b, f, dt in exhaustive.trials}
    assert ex[(pruned.backend.cache_key(), pruned.fuse_steps)] \
        <= exhaustive.seconds * 1.5
    assert pruned.rank_error == 0


def test_top_k_zero_rejected():
    with pytest.raises(ValueError):
        _two_stage(0, _model())


def test_shortlist_keeps_cheapest_and_unpredictable():
    preds = [5.0, 1.0, None, 3.0, 2.0, None]
    assert at.shortlist_indices(preds, 2) == [1, 2, 4, 5]
    assert at.shortlist_indices(preds, 1) == [1, 2, 5]
    assert at.shortlist_indices([None, None], 1) == [0, 1]
    assert at.shortlist_indices([], 3) == []


def test_shortlist_tie_break_is_original_order():
    assert at.shortlist_indices([1.0, 1.0, 1.0], 2) == [0, 1]


def test_shortlist_inf_ranks_last():
    assert at.shortlist_indices([float("inf"), 2.0, 1.0], 2) == [1, 2]


def test_autotune_expansion_keeps_user_time_block():
    b = st.hopper(template="gmem", time_block=8)
    cands = at._normalize_space([b], 2, (16, 24), ("v", "u"), steps=8,
                                fuse_space=(8,), time_block_space=(1, 2))
    assert [bb.time_block for bb, _ in cands] == [8, 1, 2]


def test_autotune_searches_time_block_and_fuse():
    k, grids = _grids("star2d1r", (16, 16))
    res = at.tune(k, grids, iters=1, space=[st.hopper(template="gmem")],
                  swap=("v", "u"), steps=8, fuse_space=(1, 8),
                  time_block_space=(1, 2), top_k=None)
    # (k=1, 1), (k=1, 8), (k=2, 8); (k=2, 1) runs only K1 on K3's tile, a
    # build of its own
    assert len(res.trials) == 4
    assert {b.time_block for b, _, _ in res.trials} == {1, 2}
    assert res.seconds < float("inf")
    g2 = _grids("star2d1r", (16, 16))[1]
    st.launch(backend=res.backend, fuse_steps=res.fuse_steps)(
        lambda u, v: st.timeloop(4, swap=("v", "u"))(k)(u, v))(g2["u"], g2["v"])


# -- the port's rules ----------------------------------------------------------
def test_dedup_times_one_kernel_once():
    """In ``st.timeloop`` gmem, smem and f4 run K1, shift and unroll K2, and
    ``mem_type`` changes no kernel: each build is timed once."""
    k, grids = _grids("star3d4r", (16, 16, 32))
    space = [st.hopper(template=t, mem_type=m)
             for t in ("gmem", "smem", "f4", "shift", "unroll")
             for m in (None, "registers", "vmem")]
    res = at.tune(k, grids, iters=1, space=space, swap=("v", "u"), steps=4,
                  fuse_space=(4,), time_block_space=(1,), top_k=None)
    assert [(b.template, f) for b, f, _ in res.trials] == [("gmem", 4),
                                                           ("shift", 4)]
    assert _measured() == 2
    # under st.map the three K4 templates are three kernels
    per_app = at.tune(k, grids, iters=1, space=space, top_k=None)
    assert [b.template for b, _, _ in per_app.trials] == [
        "gmem", "smem", "f4", "shift"]


def test_a_plans_value_error_scores_inf_without_a_launch(monkeypatch):
    k, grids = _grids("star3d4r", (8, 8, 8))
    bad = st.hopper(template="gmem", block=(2, 64, 64))   # 4096 threads
    launched = []
    from repro_torch.kernels.stencil import fused_step as fs
    real = fs.fused_step
    monkeypatch.setattr(fs, "fused_step",
                        lambda *a: (launched.append(1), real(*a)))
    res = at.tune(k, grids, iters=1, space=[bad, st.hopper(template="gmem")],
                  swap=("v", "u"), steps=2, fuse_space=(2,),
                  time_block_space=(1,), top_k=None, cost_model=_model())
    times = {b.block: dt for b, _, dt in res.trials}
    assert math.isinf(times[(2, 64, 64)]) and math.isfinite(times[None])
    assert res.backend.block is None
    pred = {b.block: p for b, _, p in res.predicted}
    assert math.isinf(pred[(2, 64, 64)])


@pytest.mark.parametrize("where", ["step", "predict"])
def test_a_runtime_error_raises_out_of_tune(where, monkeypatch):
    """A launch failure (or a failed prediction) is not scored as ``inf``
    or ``None``: it raises."""
    k, grids = _grids("star2d1r", (16, 16))

    def boom(*a, **kw):
        raise RuntimeError("fused_step launch failed: cudaError 700")
    if where == "step":
        from repro_torch.kernels.stencil import fused_step as fs
        monkeypatch.setattr(fs, "fused_step", boom)
        model = _model()
    else:
        model = _model()
        monkeypatch.setattr(model, "predict", boom)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        at.tune(k, grids, iters=1, space=[st.hopper(template="gmem")],
                swap=("v", "u"), steps=2, fuse_space=(2,),
                time_block_space=(1,), top_k=None, cost_model=model)
    assert at._CACHE == {}


def test_tune_on_cpu_builds_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("built a kernel on CPU tensors")
    monkeypatch.setattr(_build, "build_many", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    k, grids = _grids("star2d1r", (16, 16))
    res = at.tune(k, grids, iters=1, swap=("v", "u"), steps=4,
                  fuse_space=(4,), time_block_space=(1,), cost_model=_model())
    assert res.timing["build"] == 0.0 and res.measured_candidates == 3


def test_tune_with_a_mesh_is_not_ported(tmp_path):
    """Ported: ``tune(mesh=)`` prices and measures distributed candidates
    on the mesh (a shape-only mapping prices them); a mesh-tuned result
    stays in the in-process cache, never on disk (the JAX package's
    rule)."""
    from repro_torch.launch.mesh import make_mesh
    k, grids = _grids("star2d1r", (16, 12))
    mesh = make_mesh((4,), ("data",), devices=["cpu"])
    space = [(st.distributed(grid_axes=("data", None), time_steps=ts), 4)
             for ts in (1, 2)]
    res = at.tune(k, grids, iters=1, space=space, swap=("v", "u"), steps=4,
                  top_k=None, cost_model=_model(), mesh=mesh,
                  cache_dir=str(tmp_path))
    assert res.measured_candidates == 2 and res.backend in [b for b, _ in space]
    assert all(p is not None and math.isfinite(p) for _, _, p in res.predicted)
    assert not glob.glob(str(tmp_path / "*.json"))
    cm_ = _model()
    assert cm_.predict(k, grids, space[0][0], 4, 4, ("v", "u"), mesh={"data": 4}) \
        == res.predicted[0][2]


def test_scalars_reach_the_candidates():
    """Acoustic ISO takes ``dt``: every candidate runs with it (the JAX
    ``tune`` passes no scalars and scores such a kernel ``inf``)."""
    p0, p1, vp2, damp, dt = acoustic.make_fields((8, 8, 12), pml_width=2,
                                                 device="cpu")
    acoustic.inject_source(p1, 0)
    grids = {"p0": p0, "p1": p1, "vp2": vp2, "damp": damp}
    res = at.tune(acoustic.acoustic_iso_kernel, grids, iters=1,
                  space=[st.torch(), st.hopper(template="gmem")],
                  swap=("p0", "p1"), steps=2, fuse_space=(2,),
                  time_block_space=(1,), scalars={"dt": dt}, top_k=None)
    assert all(math.isfinite(dt) for _, _, dt in res.trials)
    with pytest.raises(TypeError, match=r"takes the scalars \['dt'\]"):
        at.clear_cache()
        at.tune(acoustic.acoustic_iso_kernel, grids, iters=1, space=SPACE,
                swap=("p0", "p1"), steps=2, fuse_space=(2,), top_k=None)


# -- st.launch(autotune=True) ---------------------------------------------------
def _star_run(backend=None, steps=20, **launch_kw):
    k = suite.get_kernel("star3d4r")
    grids = suite.make_grids("star3d4r", (16, 16, 16), device="cpu")

    @st.target
    def tgt(u, v):
        return st.timeloop(steps, swap=("v", "u"))(k)(u, v)
    res = st.launch(backend=backend, **launch_kw)(tgt)(grids["u"], grids["v"])
    return grids, res


def test_launch_autotune_matches_torch(tmp_path):
    want, _ = _star_run(st.torch())
    got, res = _star_run(autotune=True, autotune_cache=str(tmp_path),
                         autotune_cost_model=_model())
    assert res.profile["autotune"] > 0
    assert res.value.steps == 20
    (tuned,) = at._CACHE.values()
    assert res.value.fuse_steps == tuned.fuse_steps
    assert tuned.measured_candidates == 3 and tuned.pruned_candidates > 0
    for g in want:
        np.testing.assert_allclose(got[g].data.numpy(), want[g].data.numpy(),
                                   atol=1e-5, rtol=0)
    # a fresh model and an empty in-process cache: the disk answers
    at.clear_cache()
    at.reset_measure_count()
    again, res2 = _star_run(autotune=True, autotune_cache=str(tmp_path))
    assert _measured() == 0
    for g in want:
        np.testing.assert_allclose(again[g].data.numpy(),
                                   want[g].data.numpy(), atol=1e-5, rtol=0)


def test_launch_overrides_beat_the_tuned_ones(monkeypatch):
    """An explicit ``fuse_steps`` replaces the tuned window; ``time_block``
    applies on top of the tuned backend (K3's plain version counts its
    launches)."""
    from repro_torch.kernels.stencil import temporal_step as ts
    calls = []
    real = ts.temporal_step_plain
    monkeypatch.setattr(ts, "temporal_step_plain",
                        lambda *a: (calls.append(1), real(*a)))
    space = dict(autotune_cost_model=_model(),
                 autotune_space=[st.hopper(template="shift")],
                 autotune_fuse_space=(20,), autotune_time_block_space=(1,))
    _, res = _star_run(autotune=True, fuse_steps=5, **space)
    assert res.value.fuse_steps == 5 and not calls
    _, res = _star_run(autotune=True, time_block=2, **space)
    # the tune ran min(20, 16) steps, so its window is 16: 8 + 2 K3 launches
    assert res.value.fuse_steps == 16 and len(calls) == 10


def test_launch_autotune_skips_loops_without_a_swap_or_steps():
    k = suite.get_kernel("star2d1r")
    _, grids = _grids("star2d1r", (16, 16))
    res = st.launch(autotune=True)(
        lambda u, v: st.timeloop(0, swap=("v", "u"))(k)(u, v))(
        grids["u"], grids["v"])
    assert "autotune" not in res.profile and at._CACHE == {}


def test_launch_with_a_mesh_is_not_ported():
    """Ported: ``st.launch(mesh=)`` runs ``st.map`` under
    ``st.distributed`` on the mesh (equal to the unsharded run), and a
    distributed backend without a mesh is refused, as in the JAX
    package."""
    from repro_torch.launch.mesh import make_mesh
    k = suite.get_kernel("star2d1r")
    mesh = make_mesh((2,), ("data",), devices=["cpu"])

    def tgt(u, v):
        st.map(e=u.shape)(k)(u, v)
    a = suite.make_grids("star2d1r", (8, 6), device="cpu")
    b = {g: x.copy() for g, x in a.items()}
    st.launch(backend=st.distributed(grid_axes=("data", None)), mesh=mesh)(tgt)(
        a["u"], a["v"])
    st.launch()(tgt)(b["u"], b["v"])
    assert torch.equal(a["v"].interior, b["v"].interior)
    with pytest.raises(ValueError, match="mesh"):
        st.launch(backend=st.distributed(grid_axes=("data", None)))(tgt)(
            b["u"], b["v"])
