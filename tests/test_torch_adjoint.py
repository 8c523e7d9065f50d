"""Port parity: the checkpointed adjoint (``core/adjoint.py``,
``st.differentiable_timeloop``) vs the JAX package's on ``st.xla()``.

The schedule helpers, the schedule and ``CHECKPOINT_STATS`` equal JAX's;
gradients on every grid and scalar, with B = 2 scenarios, match
``jax.grad`` through the JAX package's ``differentiable_run`` (f32: within
1e-4 of each gradient's max) under ``st.torch()`` and under every hopper
template (on CPU tensors the forward pass and the replay run the kernels'
plain versions; the cotangents run through the torch lowering as on the
card); a port-only f64 test holds the gradients against central finite
differences.  Also: the ``between`` hook differentiated, per-scenario
gradients, the masked serving windows raising ``not_ported``, and an engine
built with ``differentiable=True`` never writing the caller's tensors.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import acoustic as jacoustic  # noqa: E402
from repro.core import adjoint as jadjoint  # noqa: E402
from repro.core import dsl as jst  # noqa: E402
from repro.core import suite as jsuite  # noqa: E402
from repro.core import timeloop as jtimeloop  # noqa: E402
from repro_torch.core import acoustic, adjoint, suite, timeloop  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402

B = 2
RTOL = 1e-4          # f32, of each gradient's max


def _backend(name):
    if name == "torch":
        return st.torch()
    template, _, k = name.partition("-k")
    return st.hopper(template=template, time_block=int(k or 1))


BACKENDS = ["torch", "gmem", "smem", "f4", "shift", "unroll", "semi", "shift-k2",
            "gmem-k3"]


@st.kernel
def _heat(u: st.grid, v: st.grid, c: st.grid, a: st.f32):
    v.at(0, 0).set(u.at(0, 0) + a * c.at(0, 0) * (
        u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1) - 4.0 * u.at(0, 0)))


@jst.kernel
def _jheat(u: jst.grid, v: jst.grid, c: jst.grid, a: jst.f32):
    v.at(0, 0).set(u.at(0, 0) + a * c.at(0, 0) * (
        u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1) - 4.0 * u.at(0, 0)))


def _heat_inputs(shape=(8, 9), nb=B, seed=0):
    rng = np.random.default_rng(seed)
    lead = (nb,) if nb else ()
    arrays = {g: rng.standard_normal(lead + tuple(s + 2 for s in shape)).astype(np.float32)
              for g in ("u", "v", "c")}
    arrays["c"] = np.abs(arrays["c"]) + 0.5
    a = np.array([0.1, 0.05][:nb] if nb else 0.1, np.float32)
    return arrays, a


def _jax_grads(jk, arrays, scal, shape, steps, fuse, swap, between=None, nb=B,
               weights=None):
    halos = {g: (1,) * len(shape) for g in arrays}
    eng = jtimeloop.TimeloopEngine(jk.ir, halos, shape, jst.xla(), swap=swap,
                                   batch=nb, differentiable=True)
    fn = jadjoint.differentiable_run(eng, steps, fuse_steps=fuse, between=between)

    def loss(arrs, s):
        out = fn(arrs, s)
        return sum(jnp.sum((weights or {}).get(g, 1.0) * o ** 2) for g, o in out.items())

    ja = {g: jnp.asarray(a) for g, a in arrays.items()}
    js = {n: jnp.asarray(v) for n, v in scal.items()}
    ga, gs = jax.grad(loss, argnums=(0, 1))(ja, js)
    return ({g: np.asarray(x) for g, x in ga.items()},
            {n: np.asarray(x) for n, x in gs.items()}, fn.schedule)


def _port_grads(k, arrays, scal, shape, steps, fuse, swap, backend, between=None,
                nb=B, weights=None, dtype=torch.float32, halo=1):
    halos = {g: (halo,) * len(shape) for g in arrays}
    eng = timeloop.TimeloopEngine(k.ir, halos, shape, backend, swap=swap, batch=nb,
                                  differentiable=True)
    fn = adjoint.differentiable_run(eng, steps, fuse_steps=fuse, between=between)
    ta = {g: torch.tensor(a, dtype=dtype, requires_grad=True) for g, a in arrays.items()}
    ts = {n: torch.tensor(v, dtype=dtype, requires_grad=True) for n, v in scal.items()}
    out = fn(ta, ts)
    loss = sum(((weights or {}).get(g, 1.0) * o ** 2).sum() for g, o in out.items())
    loss.backward()
    return ({g: t.grad.numpy() for g, t in ta.items()},
            {n: t.grad.numpy() for n, t in ts.items()}, fn.schedule)


def _assert_grads(got, want, label):
    for g, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.isfinite(got[g]).all(), (label, g)
        err = float(np.abs(got[g] - w).max())
        assert err <= RTOL * scale, f"{label}/{g}: {err} > {RTOL} x {scale}"


# ---- the schedule ---------------------------------------------------------------
def test_schedule_helpers_match_jax():
    for n in range(0, 130):
        assert adjoint.ceil_sqrt(n) == jadjoint.ceil_sqrt(n)
        assert adjoint.ceil_sqrt(n) == (int(math.ceil(math.sqrt(n))) if n else 0)
    for steps in (1, 7, 10, 36, 100, 101):
        for fuse in (1, 3, 4, 10, 200):
            assert adjoint.window_schedule(steps, fuse) == \
                jadjoint.window_schedule(steps, fuse)
    for w in range(1, 120, 7):
        for steps in (1, 9, 100, 1000):
            assert adjoint.checkpoint_stride(w, steps) == \
                jadjoint.checkpoint_stride(w, steps)


@pytest.mark.parametrize("fuse", (None, 1, 5))
@pytest.mark.parametrize("steps", (7, 16, 36, 100))
def test_schedule_and_checkpoint_stats_match_jax(steps, fuse):
    k, jk = suite.get_kernel("star2d1r"), jsuite.get_kernel("star2d1r")
    shape = (6, 8)
    rng = np.random.default_rng(1)
    arrays = {g: rng.standard_normal((8, 10)).astype(np.float32) for g in ("u", "v")}
    jadjoint.reset_stats()
    _, _, jsched = _jax_grads(jk, arrays, {}, shape, steps, fuse, ("v", "u"), nb=0)
    want = dict(jadjoint.CHECKPOINT_STATS)
    adjoint.reset_stats()
    _, _, sched = _port_grads(k, arrays, {}, shape, steps, fuse, ("v", "u"),
                              st.torch(), nb=0)
    assert sched == jsched
    assert dict(adjoint.CHECKPOINT_STATS) == want
    assert want["checkpoints"] <= adjoint.ceil_sqrt(steps) + 1
    assert want["vjp_windows"] == len(sched["windows"])


# ---- gradients vs the JAX package ------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_grads_match_jax_xla(backend):
    """Every grid (initial fields, the coefficient grid) and the (B,)
    scalar, B = 2, against jax.grad through the JAX package's adjoint."""
    shape, steps, fuse = (8, 9), 7, 3
    arrays, a = _heat_inputs(shape)
    ga, gs, jsched = _jax_grads(_jheat, arrays, {"a": a}, shape, steps, fuse, ("v", "u"))
    pa, ps, sched = _port_grads(_heat, arrays, {"a": a}, shape, steps, fuse, ("v", "u"),
                                _backend(backend))
    assert sched == jsched
    _assert_grads(pa, ga, backend)
    _assert_grads(ps, gs, backend)
    assert ps["a"].shape == (B,)


@pytest.mark.parametrize("backend", ["torch", "shift", "semi"])
def test_dsl_grads_match_jax_dsl(backend):
    """st.differentiable_timeloop on batch=2 grids against the JAX
    package's, grid objects in, fn.arrays / fn.scalars as the defaults."""
    shape = (8, 9)
    arrays, a = _heat_inputs(shape, seed=6)
    jg = {g: jst.grid(jst.f32, shape, 1, batch=B) for g in ("u", "v", "c")}
    pg = {g: st.grid(st.f32, shape, 1, batch=B, device="cpu") for g in ("u", "v", "c")}
    for g in arrays:
        jg[g].data = jnp.asarray(arrays[g])
        pg[g].data = torch.tensor(arrays[g])
    jfn = jst.differentiable_timeloop(_jheat, jg["u"], jg["v"], jg["c"], jnp.asarray(a),
                                      steps=6, swap=("v", "u"), backend=jst.xla())
    pfn = st.differentiable_timeloop(_heat, pg["u"], pg["v"], pg["c"], torch.tensor(a),
                                     steps=6, swap=("v", "u"), backend=_backend(backend))
    assert pfn.schedule == jfn.schedule
    ga, gs = jax.grad(lambda x, s: jnp.sum(jfn(x, s)["v"] ** 2), argnums=(0, 1))(
        jfn.arrays, jfn.scalars)
    ta = {g: t.detach().clone().requires_grad_() for g, t in pfn.arrays.items()}
    ts = {"a": pfn.scalars["a"].detach().clone().requires_grad_()}
    (pfn(ta, ts)["v"] ** 2).sum().backward()
    _assert_grads({g: t.grad.numpy() for g, t in ta.items()},
                  {g: np.asarray(x) for g, x in ga.items()}, backend)
    _assert_grads({"a": ts["a"].grad.numpy()}, {"a": np.asarray(gs["a"])}, backend)


@pytest.mark.parametrize("backend", ["torch", "gmem", "shift-k2", "semi"])
def test_acoustic_grads_with_sources_match_jax(backend):
    """Acoustic ISO, B = 2 shots with a source position each, injected in
    the between hook (the FWI surface): gradients on p0, p1, vp2, damp and
    dt against the JAX package's."""
    shape, steps, fuse = (8, 9, 10), 7, 3
    pos = [(2, 3, 4), (5, 6, 5)]
    p0, p1, vp2, damp, dt = acoustic.make_fields(shape, pml_width=2, device="cpu",
                                                 batch=B)
    rng = np.random.default_rng(4)
    vp2.interior = torch.from_numpy(
        (2.25 * (1 + 0.1 * rng.random((B,) + shape))).astype(np.float32))
    p1.randomize(6, 0.1)
    arrays = {n: g.data.numpy() for n, g in zip(("p0", "p1", "vp2", "damp"),
                                                (p0, p1, vp2, damp))}
    o = acoustic.ORDER
    xs, ys, zs = (np.array([o + q[ax] for q in pos]) for ax in range(3))

    def jax_between(t, arrs):
        out = dict(arrs)
        out["p1"] = out["p1"].at[np.arange(B), xs, ys, zs].add(
            acoustic.source_wavelet(t, f0=0.1, t0=2))
        return out

    # the same wavelet samples added at the shots' positions (f0, t0 chosen
    # so that the early steps carry a signal)
    def port_hook(t, arrs):
        out = dict(arrs)
        idx = (torch.arange(B), *(torch.from_numpy(v) for v in (xs, ys, zs)))
        val = acoustic.source_wavelet(t, f0=0.1, t0=2)
        out["p1"] = out["p1"].index_put(idx, torch.full((B,), val), accumulate=True)
        return out

    scal = {"dt": np.float32(dt)}
    jk = jacoustic.acoustic_iso_kernel
    halos = {g: (o,) * 3 for g in arrays}
    eng = jtimeloop.TimeloopEngine(jk.ir, halos, shape, jst.xla(), swap=("p0", "p1"),
                                   batch=B, differentiable=True)
    jfn = jadjoint.differentiable_run(eng, steps, fuse_steps=fuse, between=jax_between)

    def jloss(arrs, s):
        return jnp.sum(jfn(arrs, s)["p1"] ** 2)

    ga, gs = jax.grad(jloss, argnums=(0, 1))(
        {g: jnp.asarray(x) for g, x in arrays.items()}, {"dt": jnp.asarray(dt)})
    pa, ps, _ = _port_grads(acoustic.acoustic_iso_kernel, arrays, scal, shape, steps,
                            fuse, ("p0", "p1"), _backend(backend), between=port_hook,
                            weights={"p0": 0.0, "vp2": 0.0, "damp": 0.0}, halo=o)
    _assert_grads(pa, {g: np.asarray(x) for g, x in ga.items()}, backend)
    _assert_grads(ps, {"dt": np.asarray(gs["dt"])}, backend)
    assert float(np.abs(pa["vp2"]).max()) > 0


def test_inject_source_is_differentiated_and_unchanged_for_timeloop():
    """acoustic.inject_source adds out of place under autograd (its
    gradient is the identity) and in place otherwise, with the same
    values."""
    p = acoustic.make_fields((6, 7, 8), pml_width=2, device="cpu", batch=B)[1]
    p.randomize(2)
    base = p.data.clone()
    p.data = base.clone().requires_grad_()
    leaf = p.data
    acoustic.inject_source(p, 3, pos=[(1, 2, 3), (4, 5, 6)])
    assert p.data is not leaf
    p.data.sum().backward()
    assert torch.equal(leaf.grad, torch.ones_like(base))
    q = base.clone()
    g = st.grid(st.f32, (6, 7, 8), acoustic.ORDER, batch=B, data=q)
    acoustic.inject_source(g, 3, pos=[(1, 2, 3), (4, 5, 6)])
    assert g.data is q
    assert torch.equal(q, p.data.detach())
    assert float((q - base).abs().sum()) > 0


def test_grad_vs_finite_differences_f64():
    """Port only: f64 gradients on st.torch() against central differences
    at random cells of every grid and the scalar."""
    shape, steps = (6, 7), 5
    arrays, a = _heat_inputs(shape, nb=0, seed=2)
    halos = {g: (1, 1) for g in arrays}
    for fuse in (None, 1, 4):
        eng = timeloop.TimeloopEngine(_heat.ir, halos, shape, st.torch(),
                                      swap=("v", "u"), differentiable=True)
        fn = adjoint.differentiable_run(eng, steps, fuse_steps=fuse)

        def loss(arrs, s):
            return sum((o ** 2).sum() for o in fn(arrs, s).values())

        ta = {g: torch.tensor(x, dtype=torch.float64, requires_grad=True)
              for g, x in arrays.items()}
        ts = {"a": torch.tensor(float(a), dtype=torch.float64, requires_grad=True)}
        loss(ta, ts).backward()
        rng = np.random.default_rng(7)
        eps = 1e-6
        for g, x in arrays.items():
            for _ in range(2):
                idx = tuple(int(rng.integers(0, s)) for s in x.shape)
                hi = {h: torch.tensor(y, dtype=torch.float64) for h, y in arrays.items()}
                lo = {h: t.clone() for h, t in hi.items()}
                hi[g][idx] += eps
                lo[g][idx] -= eps
                s0 = {"a": torch.tensor(float(a), dtype=torch.float64)}
                fd = (float(loss(hi, s0)) - float(loss(lo, s0))) / (2 * eps)
                ad = float(ta[g].grad[idx])
                assert abs(ad - fd) <= 1e-6 * max(1.0, abs(fd)), (fuse, g, idx, ad, fd)
        base = {h: torch.tensor(y, dtype=torch.float64) for h, y in arrays.items()}
        fd = (float(loss(base, {"a": torch.tensor(float(a) + eps, dtype=torch.float64)}))
              - float(loss(base, {"a": torch.tensor(float(a) - eps, dtype=torch.float64)}))
              ) / (2 * eps)
        assert abs(float(ts["a"].grad) - fd) <= 1e-6 * max(1.0, abs(fd)), (fuse, fd)


@pytest.mark.parametrize("backend", ["torch", "gmem", "shift-k2"])
def test_between_hook_is_differentiated(backend):
    shape = (6, 8)
    rng = np.random.default_rng(3)
    arrays = {g: rng.standard_normal((B, 8, 10)).astype(np.float32) for g in ("u", "v")}

    def jhook(t, arrs):
        out = dict(arrs)
        out["u"] = out["u"] * 1.01
        return out

    def phook(t, arrs):
        out = dict(arrs)
        out["u"] = out["u"] * 1.01
        return out

    ga, _, _ = _jax_grads(jsuite.get_kernel("star2d1r"), arrays, {}, shape, 5, 1,
                          ("v", "u"), between=jhook)
    pa, _, _ = _port_grads(suite.get_kernel("star2d1r"), arrays, {}, shape, 5, 1,
                           ("v", "u"), _backend(backend), between=phook)
    _assert_grads(pa, ga, backend)
    nohook, _, _ = _port_grads(suite.get_kernel("star2d1r"), arrays, {}, shape, 5, 1,
                               ("v", "u"), _backend(backend))
    assert not np.allclose(pa["u"], nohook["u"])


@pytest.mark.parametrize("backend", ["torch", "shift"])
def test_batched_grads_are_per_scenario(backend):
    k = suite.get_kernel("star2d2r")
    shape = (8, 10)
    rng = np.random.default_rng(5)
    arrays = {g: rng.standard_normal((3, 12, 14)).astype(np.float32) for g in ("u", "v")}
    halos = {g: (2, 2) for g in arrays}
    eng = timeloop.TimeloopEngine(k.ir, halos, shape, _backend(backend), swap=("v", "u"),
                                  batch=3, differentiable=True)
    fn = adjoint.differentiable_run(eng, 4)
    ta = {g: torch.tensor(a, requires_grad=True) for g, a in arrays.items()}
    (fn(ta, {})["v"][1] ** 2).sum().backward()
    norms = [float(ta["u"].grad[i].norm()) for i in range(3)]
    assert norms[1] > 0 and norms[0] == 0 and norms[2] == 0


# ---- guard rails ----------------------------------------------------------------
def test_masked_windows_raise_not_ported():
    k = suite.get_kernel("star2d1r")
    grids = suite.make_grids("star2d1r", (6, 8), device="cpu")
    for kw in ({"domain_mask": np.ones((6, 8), bool)}, {"step_limits": [3]}):
        with pytest.raises(NotImplementedError, match="queue 1, item 8"):
            st.differentiable_timeloop(k, grids["u"], grids["v"], steps=4,
                                       swap=("v", "u"), **kw)
    with pytest.raises(NotImplementedError, match="item 9"):
        st.differentiable_timeloop(k, grids["u"], grids["v"], steps=4, swap=("v", "u"),
                                   mesh={"data": 2})


def test_requires_differentiable_engine():
    k = suite.get_kernel("star2d1r")
    eng = timeloop.TimeloopEngine(k.ir, {"u": (1, 1), "v": (1, 1)}, (6, 8), st.torch(),
                                  swap=("v", "u"))
    with pytest.raises(ValueError, match="differentiable=True"):
        adjoint.differentiable_run(eng, 4)


@pytest.mark.parametrize("backend", ["torch", "gmem", "shift", "shift-k2", "semi"])
def test_differentiable_engine_never_writes_the_callers_tensors(backend):
    """run and window_arrays of a differentiable engine leave their
    arguments as they were, also where the layout buffer would be a view of
    the grid (acoustic's p0/p1: halo = layout halo); a grid no window
    writes (vp2, damp) is passed on as the same tensor, which is how the
    adjoint's checkpoints share it."""
    k = acoustic.acoustic_iso_kernel
    shape = (6, 7, 8)
    fields = acoustic.make_fields(shape, pml_width=2, device="cpu", batch=B)
    fields[1].randomize(1)
    arrays = {n: g.data for n, g in zip(("p0", "p1", "vp2", "damp"), fields)}
    before = {g: a.clone() for g, a in arrays.items()}
    halos = {g: (4, 4, 4) for g in arrays}
    eng = timeloop.TimeloopEngine(k.ir, halos, shape, _backend(backend),
                                  swap=("p0", "p1"), batch=B, differentiable=True)
    scal = eng.launch_scalars({"dt": 0.3}, torch.device("cpu"))
    out = eng.window_arrays(3)(arrays, scal)
    assert out["vp2"] is arrays["vp2"] and out["damp"] is arrays["damp"]
    assert {out["p0"].data_ptr(), out["p1"].data_ptr()}.isdisjoint(
        {a.data_ptr() for a in arrays.values()})
    res = eng.run(arrays, {"dt": 0.3}, 5, 2)
    for g, a in arrays.items():
        assert torch.equal(a, before[g]), g
    plain = timeloop.TimeloopEngine(k.ir, halos, shape, _backend(backend),
                                    swap=("p0", "p1"), batch=B)
    want = plain.run({g: a.clone() for g, a in arrays.items()}, {"dt": 0.3}, 5, 2)
    for g in want:
        assert torch.equal(res[g], want[g]), g


@pytest.mark.parametrize("backend", ["torch", "gmem", "shift-k2"])
def test_primal_matches_engine_run(backend):
    k = suite.get_kernel("star2d2r")
    shape = (9, 11)
    rng = np.random.default_rng(8)
    arrays = {g: torch.tensor(rng.standard_normal((13, 15)).astype(np.float32))
              for g in ("u", "v")}
    halos = {g: (2, 2) for g in arrays}
    eng = timeloop.TimeloopEngine(k.ir, halos, shape, _backend(backend), swap=("v", "u"),
                                  differentiable=True)
    fn = adjoint.differentiable_run(eng, 5, fuse_steps=2)
    got = fn(arrays, {})
    want = eng.run(dict(arrays), {}, 5, fuse_steps=2)
    for g in arrays:
        assert torch.equal(got[g], want[g]), g


def test_dsl_differentiable_timeloop_surface():
    """fn(), fn.arrays/scalars/schedule/engine; the engine is cached apart
    from st.timeloop's; fn() equals st.timeloop's result and leaves the
    bound grids (and the between hook's grid objects) untouched."""
    p0, p1, vp2, damp, dt = acoustic.make_fields((6, 7, 8), pml_width=2, device="cpu")
    p1.randomize(3, 0.1)
    ptr = p1.data
    before = p1.data.clone()

    def between(t, grids):
        acoustic.inject_source(grids["p1"], t)

    be = st.hopper(template="shift")
    fn = st.differentiable_timeloop(acoustic.acoustic_iso_kernel, p0, p1, vp2, damp, dt,
                                    steps=7, swap=("p0", "p1"), fuse_steps=3,
                                    between=between, backend=be)
    assert fn.schedule == {"windows": (3, 3, 1), "starts": (0, 3, 6), "stride": 1,
                           "checkpoints": 3, "fuse": 3}
    assert fn.engine.differentiable and set(fn.arrays) == {"p0", "p1", "vp2", "damp"}
    assert fn.scalars == {"dt": dt}
    out = fn()
    assert p1.data is ptr and torch.equal(p1.data, before)
    q = [g.copy() for g in (p0, p1, vp2, damp)]
    st.launch(backend=be)(lambda: st.timeloop(7, swap=("p0", "p1"), fuse_steps=3,
                                              between=between)(
        acoustic.acoustic_iso_kernel)(*q, dt))()
    for g, x in zip(("p0", "p1", "vp2", "damp"), q):
        assert torch.equal(out[g], x.data), g
    keys = [key[0] for key in acoustic.acoustic_iso_kernel._cache]
    assert "difftimeloop" in keys and "timeloop" in keys
    assert st.differentiable_timeloop(acoustic.acoustic_iso_kernel, p0, p1, vp2, damp,
                                      dt, steps=7, swap=("p0", "p1"),
                                      backend=be).engine is fn.engine
