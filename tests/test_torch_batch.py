"""Port parity: batched scenarios (``st.grid(batch=B)``,
``st.timeloop(batch=B)``) under ``st.torch()`` and ``st.hopper()`` (on CPU
tensors: the kernels' plain versions, each scenario as its own step) vs
the JAX package's batched ``st.timeloop`` under ``st.xla()``; each
scenario against its own unbatched run of the port (exactly), per-scenario
and shared scalars, the ``between`` cadence, the grid views and checks,
the launch layout of a batched step, and the cost model's batch term.

Tolerance: f32, atol 1e-5 against JAX (the suite kernels' weights sum to
1, so values stay O(1) and per-step rounding differences do not grow);
a batched run of the port and its serial runs are compared bit for bit
(the same arithmetic per scenario).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dsl as jst  # noqa: E402
from repro.core import acoustic as jacoustic  # noqa: E402
from repro.core import suite as jsuite  # noqa: E402
from repro_torch.core import acoustic, cost_model, suite, timeloop  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.kernels.stencil import codegen  # noqa: E402

B = 3
STEPS = 6
FUSE = 4            # windows of 4 and 2: K3 at k=3 leaves a remainder
ATOL = 1e-5
SHAPES = {"star2d2r": (12, 18), "star3d1r": (6, 8, 10)}
TEMPLATES = ("gmem", "smem", "f4", "shift", "unroll", "semi")


def _inits(names, shape, seed=0, nb=B):
    rng = np.random.default_rng(seed)
    return {g: rng.standard_normal((nb,) + shape).astype(np.float32) for g in names}


def _port_grids(k, shape, inits, batch=B):
    gs = {g: st.grid(st.f32, shape, k.info.order, batch=batch, device="cpu")
          for g in k.ir.grid_params}
    for g in gs:
        gs[g].interior = torch.from_numpy(inits[g] if batch else inits[g][0])
    return gs


def _port_run(k, shape, inits, backend, swap, scalars=(), steps=STEPS, fuse=FUSE,
              batch=B, between=None):
    gs = _port_grids(k, shape, inits, batch)
    args = [gs[g] for g in k.ir.grid_params] + list(scalars)
    res = st.launch(backend=backend)(lambda: st.timeloop(
        steps, swap=swap, fuse_steps=fuse, batch=batch, between=between)(k)(*args))()
    return {g: gs[g].interior.numpy() for g in gs}, res.value


def _jax_run(k, shape, inits, swap, scalars=(), steps=STEPS, fuse=FUSE, between=None):
    gs = {g: jst.grid(jst.f32, shape, k.info.order, batch=B) for g in k.ir.grid_params}
    for g in gs:
        gs[g].interior = inits[g]
    args = [gs[g] for g in k.ir.grid_params] + [jnp.asarray(s) for s in scalars]
    jst.launch(backend=jst.xla())(lambda: jst.timeloop(
        steps, swap=swap, fuse_steps=fuse, batch=B, between=between)(k)(*args))()
    return {g: np.asarray(gs[g].interior) for g in gs}


def _close(got, want, label):
    for g in want:
        np.testing.assert_allclose(got[g], want[g], atol=ATOL, rtol=0,
                                   err_msg=f"{label} {g}")


_BACKENDS = [("torch", 1)] + [(t, kb) for t in TEMPLATES for kb in (1, 2, 3)]


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("template,time_block", _BACKENDS,
                         ids=[f"{t}-k{kb}" for t, kb in _BACKENDS])
def test_batched_matches_jax_xla(name, template, time_block):
    k, jk = suite.get_kernel(name), jsuite.get_kernel(name)
    shape, swap = SHAPES[name], suite.swap_pair(name)
    inits = _inits(k.ir.grid_params, shape)
    be = (st.torch() if template == "torch"
          else st.hopper(template=template, time_block=time_block))
    got, res = _port_run(k, shape, inits, be, swap)
    assert (res.steps, res.fuse_steps, res.windows) == (STEPS, FUSE, 2)
    _close(got, _jax_run(jk, shape, inits, swap), f"{name}/{template}/k={time_block}")


@pytest.mark.parametrize("template,time_block",
                         [("torch", 1), ("gmem", 1), ("shift", 2), ("semi", 1)])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_each_scenario_equals_its_serial_run(name, template, time_block):
    k = suite.get_kernel(name)
    shape, swap = SHAPES[name], suite.swap_pair(name)
    inits = _inits(k.ir.grid_params, shape, seed=5)
    be = (st.torch() if template == "torch"
          else st.hopper(template=template, time_block=time_block))
    got, _ = _port_run(k, shape, inits, be, swap)
    for b in range(B):
        one, _ = _port_run(k, shape, {g: a[b:b + 1] for g, a in inits.items()},
                           be, swap, batch=0)
        for g in got:
            np.testing.assert_array_equal(got[g][b], one[g], err_msg=f"{g} b={b}")


@st.kernel
def _damped(u: st.grid, v: st.grid, a: st.f32):
    v.at(0, 0).set(a * u.at(0, 0)
                   + 0.1 * (u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1)))


@jst.kernel
def _jdamped(u: jst.grid, v: jst.grid, a: jst.f32):
    v.at(0, 0).set(a * u.at(0, 0)
                   + 0.1 * (u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1)))


@pytest.mark.parametrize("backend", ["torch", "gmem", "shift", "shift-k2", "semi"])
@pytest.mark.parametrize("scalar", ["per-scenario", "shared"])
def test_scalars_per_scenario_and_shared(backend, scalar):
    """(B,) scalars give each scenario its own value; a float is shared."""
    shape = (10, 14)
    inits = _inits(("u", "v"), shape, seed=2)
    a = np.array([0.3, 0.5, 0.7], np.float32) if scalar == "per-scenario" else 0.5
    be = {"torch": st.torch(), "gmem": st.hopper(), "shift": st.hopper(template="shift"),
          "shift-k2": st.hopper(template="shift", time_block=2),
          "semi": st.hopper(template="semi")}[backend]
    port_a = torch.from_numpy(a) if scalar == "per-scenario" else a
    got, _ = _port_run(_damped, shape, inits, be, ("v", "u"), (port_a,))
    _close(got, _jax_run(_jdamped, shape, inits, ("v", "u"), (a,)), backend)
    if scalar == "per-scenario":
        assert not np.allclose(got["v"][0], got["v"][1])


def test_between_hook_cadence_and_per_scenario_injection():
    """The hook fires at the window boundaries and sees the batched grids;
    a per-scenario injection matches the JAX package's."""
    k, jk = suite.get_kernel("star2d1r"), jsuite.get_kernel("star2d1r")
    shape = (10, 12)
    inits = _inits(("u", "v"), shape, seed=3)
    amps = np.array([1.0, 2.0, 3.0], np.float32)
    hits = []

    def port_between(t, grids):
        hits.append(t)
        inj = torch.zeros(grids["u"].interior.shape)
        inj[..., 4, 5] = torch.from_numpy(amps)
        grids["u"].interior = grids["u"].interior + inj

    def jax_between(t, grids):
        inj = np.zeros(grids["u"].interior.shape, np.float32)
        inj[..., 4, 5] = amps
        grids["u"].interior = grids["u"].interior + inj

    for be in (st.torch(), st.hopper(template="shift")):
        hits.clear()
        got, _ = _port_run(k, shape, inits, be, ("v", "u"), fuse=2,
                           between=port_between)
        assert hits == [2, 4]
        _close(got, _jax_run(jk, shape, inits, ("v", "u"), fuse=2,
                             between=jax_between), be.kind)


def test_acoustic_shots_match_jax_serial_runs():
    """make_fields(batch=B) with a model and a source position a shot,
    under the hopper backend, against the JAX package's unbatched run of
    each shot (rtol 1e-4 of the field's max: the leapfrog carries rounding
    differences forward)."""
    shape, pml, steps, fuse = (10, 12, 14), 3, 7, 3
    pos = [(2, 3, 4), (5, 6, 7), (7, 8, 9)]
    rng = np.random.default_rng(9)
    vp2s = (2.25 * (1 + 0.1 * rng.random((B,) + shape))).astype(np.float32)
    p0, p1, vp2, damp, dt = acoustic.make_fields(shape, pml_width=pml, device="cpu",
                                                 batch=B)
    vp2.interior = torch.from_numpy(vp2s)
    acoustic.inject_source(p1, 0, pos=pos)

    def between(t, grids):
        acoustic.inject_source(grids["p1"], t, pos=pos)

    st.launch(backend=st.hopper(template="gmem"), fuse_steps=fuse)(
        acoustic.acoustic_target_fused)(p0, p1, vp2, damp, dt, steps, between=between)
    for b in range(B):
        j = jacoustic.make_fields(shape, pml_width=pml)
        j[2].interior = vp2s[b]
        jacoustic.inject_source(j[1], 0, pos=pos[b])
        jst.launch(backend=jst.xla(), fuse_steps=fuse)(jacoustic.acoustic_target_fused)(
            *j, steps, between=lambda t, g, b=b: jacoustic.inject_source(g["p1"], t,
                                                                       pos=pos[b]))
        want = np.asarray(j[1].data)
        assert np.abs(want).max() > 1e-3
        np.testing.assert_allclose(p1.data[b].numpy(), want,
                                   atol=1e-4 * np.abs(want).max(), rtol=0)


def test_grid_batch_views():
    g = st.grid(st.f32, (4, 6), order=2, batch=5, device="cpu").randomize(1)
    j = jst.grid(jst.f32, (4, 6), order=2, batch=5).randomize(1)
    assert tuple(g.data.shape) == (5, 8, 10) and tuple(g.interior.shape) == (5, 4, 6)
    np.testing.assert_array_equal(g.data.numpy(), np.asarray(j.data))
    assert "batch=5" in repr(g)
    c = g.copy()
    assert c.batch == 5 and c.data.shape == g.data.shape
    assert c.data.data_ptr() != g.data.data_ptr()
    assert not torch.allclose(g.interior[0], g.interior[1])
    assert g.halo == (2, 2)


def test_batch_mismatch_raises():
    k = suite.get_kernel("star2d1r")
    u = st.grid(st.f32, (8, 8), 1, batch=2, device="cpu")
    v = st.grid(st.f32, (8, 8), 1, batch=3, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        st.timeloop(2, swap=("v", "u"), batch=2)(k)(u, v)
    v2 = st.grid(st.f32, (8, 8), 1, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        st.timeloop(2, swap=("v", "u"), batch=2)(k)(u, v2)
    u1 = st.grid(st.f32, (8, 8), 1, device="cpu")
    with pytest.raises(ValueError, match="requires grids built with"):
        st.timeloop(2, swap=("v", "u"), batch=2)(k)(u1, v2)
    v3 = st.grid(st.f32, (8, 8), 1, batch=3, device="cpu")
    with pytest.raises(ValueError, match=r"batch=2\) but grids carry batch=3"):
        st.timeloop(2, swap=("v", "u"), batch=2)(k)(v.copy(), v3)
    with pytest.raises(ValueError, match="a float or 3 values"):
        st.timeloop(2, swap=("v", "u"))(_damped)(v.copy(), v3, torch.ones(2))


def test_map_rejects_batched_grids():
    k = suite.get_kernel("star2d1r")
    u = st.grid(st.f32, (8, 8), 1, batch=2, device="cpu")
    v = st.grid(st.f32, (8, 8), 1, batch=2, device="cpu")
    for be in (st.torch(), st.hopper()):
        with pytest.raises(ValueError, match="batched"):
            st.launch(backend=be)(lambda: st.map(e=u.shape)(k)(u, v))()


def test_engine_checks_the_scenario_axis():
    k = suite.get_kernel("star2d1r")
    halos = {g: (1, 1) for g in k.ir.grid_params}
    eng = timeloop.TimeloopEngine(k.ir, halos, (8, 8), st.hopper(), swap=("v", "u"),
                                  batch=2)
    with pytest.raises(ValueError, match="leading scenario axis of 2"):
        eng.run({g: torch.zeros(3, 10, 10) for g in halos}, {}, 2)
    one = timeloop.TimeloopEngine(k.ir, halos, (8, 8), st.hopper(), swap=("v", "u"))
    with pytest.raises(ValueError, match="unbatched"):
        one.run({g: torch.zeros(2, 10, 10) for g in halos}, {}, 2)
    with pytest.raises(ValueError, match="batch must be >= 0"):
        timeloop.TimeloopEngine(k.ir, halos, (8, 8), st.torch(), batch=-1)


def test_batched_launch_layout():
    """A batched step's parameter block (csrc/common.cuh): the scenario
    count, the (B, NS) scalars' address and each grid's scenario stride
    after R; a batched launch refuses scalars that are not that array, and
    more than 65535 blocks along z."""
    k = acoustic.acoustic_iso_kernel
    shape = (6, 7, 9)
    halos = {g: (4, 4, 4) for g in k.ir.grid_params}
    plan = codegen.plan_cuda(k.ir, halos, shape, st.hopper(), swap=("p0", "p1"))
    arrays = {g: torch.zeros((B,) + tuple(s + 8 for s in shape)) for g in halos}
    padded = plan.to_padded(arrays)
    sc = plan.scenario_scalars({"dt": torch.tensor([0.1, 0.2, 0.3])}, B, "cpu")
    assert tuple(sc.shape) == (B, 1) and sc[:, 0].tolist() == pytest.approx([0.1, 0.2, 0.3])
    meta, scal = plan.launch_args(padded, sc)
    ng = len(plan.opnd_grids)
    m = list(meta)
    assert m[4 * ng:4 * ng + 3] == list(plan.R3)
    assert m[4 * ng + 3:4 * ng + 5] == [B, sc.data_ptr()]
    assert m[4 * ng + 5:5 * ng + 5] == [padded[g][0].numel() for g in plan.opnd_grids]
    # K1's destinations, each with its grid's scenario stride
    out = plan.opnd_grids.index("p0")
    assert m[5 * ng + 5:] == [m[out], m[ng + out], m[2 * ng + out], m[3 * ng + out],
                              m[4 * ng + 5 + out]]
    with pytest.raises(ValueError, match=r"\(3, 1\) float32 tensor"):
        plan.launch_args(padded, {"dt": 0.1})
    # unbatched: one scenario, scalars by value
    meta1, scal1 = plan.launch_args(plan.to_padded({g: a[0] for g, a in arrays.items()}),
                                    {"dt": 0.25})
    assert list(meta1)[4 * ng + 3:4 * ng + 5] == [1, 0] and list(scal1) == [0.25]
    deep = codegen.plan_cuda(k.ir, halos, (40000, 1, 1), st.hopper(block=(1, 1, 1)),
                             swap=("p0", "p1"))
    big = {g: torch.zeros((2, 40008, 9, 9)) for g in halos}
    with pytest.raises(ValueError, match="65535"):
        deep.launch_args(deep.to_padded(big), deep.scenario_scalars({"dt": 0.1}, 2, "cpu"))


def test_traffic_and_cost_model_scale_with_batch():
    """count_window and the byte model scale by B (the JAX package's
    count); CostModel.predict prices traffic × B plus the windows'
    overheads."""
    k = acoustic.acoustic_iso_kernel
    shape = (8, 9, 10)
    halos = {g: (4, 4, 4) for g in k.ir.grid_params}
    plan = codegen.plan_cuda(k.ir, halos, shape, st.hopper(template="shift", time_block=2),
                             swap=("p0", "p1"))
    codegen.reset_traffic_count()
    plan.count_window(5)
    one = dict(codegen.TRAFFIC_COUNT)
    codegen.reset_traffic_count()
    plan.count_window(5, batch=B)
    assert codegen.TRAFFIC_COUNT["grid_reads"] == B * one["grid_reads"]
    assert codegen.TRAFFIC_COUNT["grid_writes"] == B * one["grid_writes"]
    assert codegen.TRAFFIC_COUNT["steps"] == one["steps"] == 5
    assert plan.hbm_bytes_per_step(4, B) == B * plan.hbm_bytes_per_step(4)
    assert plan.layout_bytes_per_window(4, B) == B * plan.layout_bytes_per_window(4)

    # predict: B x the bytes over the rate, plus the windows' overheads,
    # which B does not change: linear in B with the unbatched slope
    cm = cost_model.CostModel(calibrate=False, device="cpu")
    kern = acoustic.acoustic_iso_kernel

    def fields(nb):
        return dict(zip(("p0", "p1", "vp2", "damp"), acoustic.make_fields(
            shape, pml_width=2, device="cpu", batch=nb)[:4]))

    for be in (st.hopper(), st.hopper(template="shift", time_block=2), st.torch()):
        t = {nb: cm.predict(kern, fields(nb), be, 4, 10, ("p0", "p1"),
                            scalars={"dt": 0.3}) for nb in (None, 3, 6)}
        assert t[3] > t[None]
        assert (t[6] - t[3]) / 3 == pytest.approx((t[3] - t[None]) / 2, rel=1e-9), be


def test_batched_loop_is_not_tuned():
    """st.launch(autotune=True) leaves a batched loop on the launch's
    backend, as the JAX package does."""
    k = suite.get_kernel("star2d1r")
    shape = (8, 10)
    inits = _inits(("u", "v"), shape, seed=4)
    gs = _port_grids(k, shape, inits)
    res = st.launch(backend=st.hopper(template="shift"), autotune=True)(
        lambda: st.timeloop(4, swap=("v", "u"), batch=B)(k)(gs["u"], gs["v"]))()
    assert "autotune" not in res.profile
    got, _ = _port_run(k, shape, inits, st.hopper(template="shift"), ("v", "u"),
                       steps=4, fuse=None)
    for g in gs:
        np.testing.assert_array_equal(gs[g].interior.numpy(), got[g])
