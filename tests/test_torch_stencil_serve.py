"""Port parity: shape-bucketed stencil serving (``serving/stencil_serve.py``)
and the masked windows it runs on (``lowering.lower_torch_window_masked``,
``TimeloopEngine.run(domain_mask=, step_limits=)``, the masked adjoint),
against the JAX package's on ``st.xla()``.

The fourteen cases of ``tests/test_stencil_serve.py`` run on the port's
``SimServer`` (CPU) and on the JAX package's with the same payloads: the
packed waves and the admission helpers are equal, and every served result
is within the forward tolerance of ``tests/test_torch_timeloop.py`` (atol
1e-5, suite kernels) of the JAX server's and within the JAX test's own
``rtol=1e-5, atol=1e-6`` of the request's serial unbatched ``st.torch()``
run.  The masked window is held against the vmapped
``lower_jax_window_masked`` at the same tolerance, frozen cells bit for
bit equal to their input; the masked gradient against ``jax.grad``
through the JAX package's ``differentiable_run(domain_mask=,
step_limits=)`` within 1e-4 of each gradient's max (f32); and, in f64, the
frozen-cell identity of ``tests/test_timeloop_grad.py`` (which cannot
collect under the installed JAX).  Masked windows under ``st.hopper``
raise ``ValueError``, as the JAX package's do under Pallas.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import adjoint as jadjoint  # noqa: E402
from repro.core import autotune as jat  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import dsl as jst  # noqa: E402
from repro.core import lowering as jlowering  # noqa: E402
from repro.core import suite as jsuite  # noqa: E402
from repro.core import timeloop as jtimeloop  # noqa: E402
from repro.serving import stencil_serve as jserve  # noqa: E402
from repro_torch.core import adjoint, autotune, cost_model, lowering, suite  # noqa: E402
from repro_torch.core import timeloop  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.serving import stencil_serve as serve  # noqa: E402
from repro_torch.serving.stencil_serve import (SimServer, bucket_key,  # noqa: E402
                                               default_swap, form_waves, pack_wave,
                                               unpack_wave)

ATOL = 1e-5          # port vs JAX, suite kernels, f32
GRAD_RTOL = 1e-4     # f32 gradients, of each gradient's max


def _k():
    return suite.get_kernel("star2d1r")


def _server(**kw):
    return SimServer(device="cpu", **kw)


def _serial(kernel, shape, steps, payload, scalars=None):
    """Per-request reference: one unbatched ``st.timeloop`` run of the port."""
    k = suite.get_kernel(kernel) if isinstance(kernel, str) else kernel
    gs = {g: st.grid(st.f32, shape, k.info.order, device="cpu") for g in k.ir.grid_params}
    for g, val in payload.items():
        gs[g].interior = torch.from_numpy(val)
    if steps:
        args = [gs[g] for g in k.ir.grid_params] + \
               [float(v) for v in (scalars or {}).values()]
        st.launch(backend=st.torch())(lambda: st.timeloop(
            steps, swap=default_swap(k))(k)(*args))()
    return {g: gs[g].interior.numpy() for g in gs}


def _both(jobs, cap, fuse, kernels=None, jkernels=None):
    """Serve ``jobs`` [(kernel, shape, steps, payload, scalars)] on the
    port's server and on the JAX package's; (port, JAX, uids, servers)."""
    srv = _server(batch_cap=cap, fuse_window=fuse, kernels=kernels)
    jsrv = jserve.SimServer(batch_cap=cap, fuse_window=fuse, kernels=jkernels)
    uids = []
    for name, shape, steps, payload, scal in jobs:
        uids.append(srv.submit(name, shape, steps, payload, scalars=scal))
        assert jsrv.submit(name, shape, steps, payload, scalars=scal) == uids[-1]
    return srv.run_until_drained(), jsrv.run_until_drained(), uids, (srv, jsrv)


def _close_to_jax(mine, theirs):
    for g, want in theirs.items():
        np.testing.assert_allclose(mine[g], np.asarray(want), rtol=0, atol=ATOL, err_msg=g)


# ---- admission, packing, unpacking ------------------------------------------------
def test_bucket_key_pow2_rounding():
    cases = [((12, 18), "float32"), ((3, 5), "float32"), ((16, 32), "float32"),
             ((9, 17), "float32"), ((12, 18), "float64")]
    for shape, dt in cases:
        assert bucket_key("star2d1r", shape, dt) == jserve.bucket_key("star2d1r", shape, dt)
    assert bucket_key("star2d1r", (12, 18)) == ("star2d1r", (16, 32), "float32")
    assert bucket_key("star2d1r", (3, 5)) == ("star2d1r", (8, 8), "float32")
    assert bucket_key("star2d1r", (16, 32)) == bucket_key("star2d1r", (9, 17))
    assert bucket_key("star2d1r", (12, 18), "float64")[2] == "float64"


def test_default_swap():
    assert default_swap(_k()) == jserve.default_swap(jsuite.get_kernel("star2d1r")) \
        == ("v", "u")

    @st.kernel
    def three(u: st.grid, v: st.grid, c: st.grid):
        v.at(0, 0).set(c.at(0, 0) * u.at(0, 0))
    assert default_swap(three) is None


def test_form_waves():
    reqs = list(range(7))
    waves = form_waves(reqs, 3)
    assert waves == jserve.form_waves(reqs, 3)
    assert [len(w) for w in waves] == [3, 3, 1]
    assert [x for w in waves for x in w] == reqs
    assert form_waves([], 3) == []


def _one_request(srv, shape, steps, payload):
    uid = srv.submit("star2d1r", shape, steps, payload)
    (req,) = srv._queues[bucket_key("star2d1r", shape)]
    return uid, req


def test_pack_wave_embeds_and_pads():
    bucket = (16, 16)
    u0 = np.arange(10 * 12, dtype=np.float32).reshape(10, 12)
    uid, req = _one_request(_server(), (10, 12), 4, {"u": u0})
    _, jreq = _one_request(jserve.SimServer(), (10, 12), 4, {"u": u0})
    arrays, mask, limits = pack_wave(_k(), bucket, [req], batch_cap=3, device="cpu")
    jarrays, jmask, jlimits = jserve.pack_wave(jsuite.get_kernel("star2d1r"), bucket,
                                               [jreq], batch_cap=3)
    for g in jarrays:
        np.testing.assert_array_equal(arrays[g].numpy(), np.asarray(jarrays[g]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(limits.numpy(), np.asarray(jlimits))
    assert arrays["u"].shape == (3, 18, 18)
    np.testing.assert_array_equal(arrays["u"][0, 1:11, 1:13].numpy(), u0)
    assert float(arrays["u"][0, 0].abs().max()) == 0
    m = mask.numpy()
    assert m[0, :10, :12].all() and not m[0, 10:, :].any() and not m[0, :, 12:].any()
    assert not m[1:].any() and float(arrays["u"][1:].abs().max()) == 0
    assert limits.tolist() == [4, 0, 0] and limits.dtype == torch.int32
    assert uid == req.uid


def test_pack_wave_halo_padded_payload():
    full = np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32)
    _, req = _one_request(_server(), (6, 6), 2, {"u": full})
    _, jreq = _one_request(jserve.SimServer(), (6, 6), 2, {"u": full})
    arrays, _, _ = pack_wave(_k(), (8, 8), [req], batch_cap=1, device="cpu")
    jarrays, _, _ = jserve.pack_wave(jsuite.get_kernel("star2d1r"), (8, 8), [jreq],
                                     batch_cap=1)
    np.testing.assert_array_equal(arrays["u"][0, :8, :8].numpy(), full)
    np.testing.assert_array_equal(arrays["u"].numpy(), np.asarray(jarrays["u"]))


def test_pack_wave_errors():
    k = _k()

    def mk(shape, payload):
        return _one_request(_server(), shape, 1, payload)[1]

    with pytest.raises(ValueError, match="exceeds cap"):
        pack_wave(k, (8, 8), [mk((4, 4), {})] * 3, batch_cap=2, device="cpu")
    with pytest.raises(ValueError, match="exceeds bucket"):
        pack_wave(k, (8, 8), [mk((9, 4), {})], batch_cap=1, device="cpu")
    with pytest.raises(ValueError, match="payload 'u'"):
        pack_wave(k, (8, 8), [mk((4, 4), {"u": np.zeros((5, 5), np.float32)})],
                  batch_cap=1, device="cpu")


def test_unpack_wave_roundtrip():
    k = _k()
    rng = np.random.default_rng(1)
    srv, jsrv = _server(), jserve.SimServer()
    shapes = [(5, 7), (8, 8)]
    payloads = [{g: rng.standard_normal(s).astype(np.float32) for g in k.ir.grid_params}
                for s in shapes]
    for s, p in zip(shapes, payloads):
        srv.submit("star2d1r", s, 0, p)
        jsrv.submit("star2d1r", s, 0, p)
    reqs = [r for q in srv._queues.values() for r in q]
    jreqs = [r for q in jsrv._queues.values() for r in q]
    arrays, _, _ = pack_wave(k, (8, 8), reqs, batch_cap=4, device="cpu")
    outs = unpack_wave(k, arrays, reqs)
    jk = jsuite.get_kernel("star2d1r")
    jouts = jserve.unpack_wave(jk, jserve.pack_wave(jk, (8, 8), jreqs, 4)[0], jreqs)
    for p, o, jo in zip(payloads, outs, jouts):
        for g in k.ir.grid_params:
            np.testing.assert_array_equal(o[g], p[g])
            np.testing.assert_array_equal(o[g], jo[g])


# ---- end to end ----------------------------------------------------------------
def test_server_matches_serial_mixed_stream():
    """Mixed shapes and steps across two buckets, a steps=0 request among
    them: every result equals its own serial small-domain run, and the
    JAX server's."""
    rng = np.random.default_rng(2)
    jobs = [((10, 12), 5), ((16, 16), 3), ((9, 14), 0), ((10, 12), 7), ((4, 4), 2)]
    payloads = [{"u": rng.standard_normal(s).astype(np.float32)} for s, _ in jobs]
    done, jdone, uids, (srv, jsrv) = _both(
        [("star2d1r", s, n, p, None) for (s, n), p in zip(jobs, payloads)], 3, 4)
    assert srv.pending() == 0
    assert srv.waves_run == jsrv.waves_run == 3
    for uid, (shape, steps), p in zip(uids, jobs, payloads):
        ref = _serial("star2d1r", shape, steps, p)
        for g, want in ref.items():
            np.testing.assert_allclose(done[uid].result[g], want, rtol=1e-5, atol=1e-6,
                                       err_msg=g)
        _close_to_jax(done[uid].result, jdone[uid].result)
        assert done[uid].done_at >= done[uid].submitted_at


def test_server_per_request_scalars():
    @st.kernel
    def damped(u: st.grid, v: st.grid, a: st.f32):
        v.at(0, 0).set(a * u.at(0, 0) + 0.1 * (u.at(-1, 0) + u.at(1, 0)))

    @jst.kernel
    def jdamped(u: jst.grid, v: jst.grid, a: jst.f32):
        v.at(0, 0).set(a * u.at(0, 0) + 0.1 * (u.at(-1, 0) + u.at(1, 0)))

    rng = np.random.default_rng(3)
    jobs = [("damped", (6, 6), 4, {"u": rng.standard_normal((6, 6)).astype(np.float32)},
             {"a": a}) for a in (0.25, 0.75)]
    done, jdone, uids, _ = _both(jobs, 2, 2, kernels={"damped": damped},
                                 jkernels={"damped": jdamped})
    for uid, (_, shape, steps, p, scal) in zip(uids, jobs):
        ref = _serial(damped, shape, steps, p, scal)
        np.testing.assert_allclose(done[uid].result["v"], ref["v"], rtol=1e-5, atol=1e-6)
        _close_to_jax(done[uid].result, jdone[uid].result)
    assert not np.allclose(done[uids[0]].result["v"], done[uids[1]].result["v"])


def test_deadline_and_cap_gating():
    for make in (lambda **kw: _server(**kw), jserve.SimServer):
        srv = make(batch_cap=2, deadline_s=3600.0)
        srv.submit("star2d1r", (4, 4), 1, {})
        assert srv.step() == []                   # partial wave, deadline far
        assert srv.pending() == 1
        srv.submit("star2d1r", (4, 4), 1, {})
        served = srv.step()                       # cap reached: ready
        assert len(served) == 2 and srv.pending() == 0
        srv.submit("star2d1r", (4, 4), 1, {})
        assert len(srv.step(force=True)) == 1     # force overrides the deadline
        srv2 = make(batch_cap=8, deadline_s=0.0)
        srv2.submit("star2d1r", (4, 4), 1, {})
        assert len(srv2.step()) == 1              # zero deadline: immediate


def test_waves_share_one_engine_per_bucket():
    jobs = [("star2d1r", (6, 7), steps, {"u": np.ones((6, 7), np.float32)}, None)
            for steps in (1, 3, 6, 2, 5)]
    done, jdone, uids, (srv, jsrv) = _both(jobs, 2, 2)
    assert srv.waves_run == jsrv.waves_run == 3
    assert len(srv._engines) == 1                 # one engine
    (eng, fuse) = next(iter(srv._engines.values()))
    assert fuse == 2 and eng.batch == 2 and eng.backend.kind == "torch"
    for uid in uids:
        _close_to_jax(done[uid].result, jdone[uid].result)


def test_submit_validation():
    srv = _server()
    with pytest.raises(ValueError, match="2D"):
        srv.submit("star2d1r", (4, 4, 4), 1, {})
    with pytest.raises(ValueError, match="steps"):
        srv.submit("star2d1r", (4, 4), -1, {})
    with pytest.raises(ValueError):
        _server(batch_cap=0)


def _tuned_serve(tmp_path, top_k, port=True):
    k = suite.get_kernel("star2d1r")
    rng = np.random.default_rng(0)
    payload = {g: rng.standard_normal((12, 18)).astype(np.float32) for g in k.ir.grid_params}
    if port:
        at, srv = autotune, _server(batch_cap=2, autotune_cache=str(tmp_path / "port"),
                                    tune_top_k=top_k,
                                    tune_cost_model=cost_model.CostModel(
                                        calibrate=False, device="cpu"))
    else:
        at, srv = jat, jserve.SimServer(batch_cap=2, autotune_cache=str(tmp_path / "jax"),
                                        tune_top_k=top_k,
                                        tune_cost_model=jcm.CostModel(calibrate=False))
    at.clear_cache()
    at.reset_measure_count()
    uid = srv.submit("star2d1r", (12, 18), 4, payload)
    done = srv.run_until_drained()
    return (at.MEASURE_COUNT["measured_candidates"],
            at.MEASURE_COUNT["pruned_candidates"], done[uid].result)


def test_tuned_server_prunes_with_cost_model(tmp_path):
    """A cold start measures only the tune_top_k shortlist; a warm process
    reads the disk entry and measures nothing; both as the JAX server."""
    cold = _tuned_serve(tmp_path, 2)
    jcold = _tuned_serve(tmp_path, 2, port=False)
    # fuse space (1, 2, 4, 8, 16) at tune_steps=8 dedups to 4 candidates
    assert cold[:2] == jcold[:2] == (2, 2)
    warm = _tuned_serve(tmp_path, 2)
    assert warm[0] == _tuned_serve(tmp_path, 2, port=False)[0] == 0
    _close_to_jax(cold[2], jcold[2])
    for g in cold[2]:
        np.testing.assert_array_equal(warm[2][g], cold[2][g])


def test_tuned_server_exhaustive_when_top_k_none(tmp_path):
    got = _tuned_serve(tmp_path, None)
    jgot = _tuned_serve(tmp_path, None, port=False)
    assert got[:2] == jgot[:2] == (4, 0)
    _close_to_jax(got[2], jgot[2])


# ---- the masked window, the engine and the adjoint ------------------------------------
MASK_SHAPE = (8, 10)
MB = 3


def _masked_inputs(name="star2d2r", seed=0, dtype=np.float32):
    k = suite.get_kernel(name)
    h = k.info.order
    rng = np.random.default_rng(seed)
    arrays = {g: rng.standard_normal((MB,) + tuple(s + 2 * h for s in MASK_SHAPE))
              .astype(dtype) for g in k.ir.grid_params}
    mask = np.ones((MB,) + MASK_SHAPE, bool)
    mask[1, :, 5:] = False
    mask[2, 3:, :] = False
    limits = np.array([5, 2, 4], np.int32)
    return k, {g: (h, h) for g in arrays}, arrays, mask, limits


@pytest.mark.parametrize("name", ["star2d1r", "star2d2r"])
@pytest.mark.parametrize("start", [0, 3])
def test_masked_window_matches_jax(name, start):
    k, halos, arrays, mask, limits = _masked_inputs(name)
    jk = jsuite.get_kernel(name)
    jwin = jax.vmap(jlowering.lower_jax_window_masked(jk.ir, halos, MASK_SHAPE, ("v", "u"), 5),
                    in_axes=(0, 0, 0, None, 0))
    want = jwin({g: jnp.asarray(a) for g, a in arrays.items()}, {}, jnp.asarray(mask),
                jnp.int32(start), jnp.asarray(limits))
    win = lowering.lower_torch_window_masked(k.ir, halos, MASK_SHAPE, ("v", "u"), 5,
                                             batch=MB)
    ins = {g: torch.tensor(a) for g, a in arrays.items()}
    got = win(ins, {}, torch.from_numpy(mask), start, torch.from_numpy(limits))
    for g in arrays:
        np.testing.assert_array_equal(ins[g].numpy(), arrays[g])   # arguments kept
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want[g]), rtol=0, atol=ATOL)
    # frozen cells and a scenario past its budget keep their input bits
    h = halos["u"][0]
    inner = (slice(h, h + MASK_SHAPE[0]), slice(h, h + MASK_SHAPE[1]))
    steps_run = np.clip(limits - start, 0, 5)
    for b in range(MB):
        if steps_run[b] == 0:
            for g in arrays:
                np.testing.assert_array_equal(got[g][b].numpy(), arrays[g][b])
            continue
        # after an even number of rotations the names hold their own buffers
        names = {"u": "u", "v": "v"} if steps_run[b] % 2 == 0 else {"u": "v", "v": "u"}
        frozen = ~mask[b]
        for g, src in names.items():
            np.testing.assert_array_equal(got[g][b][inner].numpy()[frozen],
                                          arrays[src][b][inner][frozen])


def test_engine_masked_run_matches_jax_and_keeps_its_arguments():
    k, halos, arrays, mask, limits = _masked_inputs("star2d2r", seed=1)
    eng = timeloop.TimeloopEngine(k.ir, halos, MASK_SHAPE, st.torch(), swap=("v", "u"),
                                  batch=MB)
    ins = {g: torch.tensor(a) for g, a in arrays.items()}
    got = eng.run(ins, {}, 7, 3, domain_mask=mask, step_limits=limits)
    jk = jsuite.get_kernel("star2d2r")
    jeng = jtimeloop.TimeloopEngine(jk.ir, halos, MASK_SHAPE, jst.xla(), swap=("v", "u"),
                                    batch=MB)
    want = jeng.run({g: jnp.asarray(a) for g, a in arrays.items()}, {}, 7, 3,
                    domain_mask=jnp.asarray(mask), step_limits=jnp.asarray(limits))
    for g in arrays:
        np.testing.assert_array_equal(ins[g].numpy(), arrays[g])
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want[g]), rtol=0, atol=ATOL)
    # the defaults: no mask freezes nothing, no limits run every step
    full = eng.run({g: torch.tensor(a) for g, a in arrays.items()}, {}, 7, 3,
                   step_limits=[7] * MB)
    plain = eng.run({g: torch.tensor(a) for g, a in arrays.items()}, {}, 7, 3)
    for g in arrays:
        assert torch.equal(full[g], plain[g])


def test_masked_windows_need_a_batched_torch_engine():
    k, halos, arrays, mask, limits = _masked_inputs()
    hop = timeloop.TimeloopEngine(k.ir, halos, MASK_SHAPE, st.hopper(), swap=("v", "u"),
                                  batch=MB)
    with pytest.raises(ValueError, match="batched torch"):
        hop.run({g: torch.tensor(a) for g, a in arrays.items()}, {}, 2,
                domain_mask=mask)
    flat = timeloop.TimeloopEngine(k.ir, halos, MASK_SHAPE, st.torch(), swap=("v", "u"))
    with pytest.raises(ValueError, match="batched torch"):
        flat.run({g: torch.tensor(a[0]) for g, a in arrays.items()}, {}, 2,
                 step_limits=[2])
    eng = timeloop.TimeloopEngine(k.ir, halos, MASK_SHAPE, st.torch(), swap=("v", "u"),
                                  batch=MB)
    with pytest.raises(ValueError, match="domain_mask must have shape"):
        eng.run({g: torch.tensor(a) for g, a in arrays.items()}, {}, 2,
                domain_mask=mask[0])
    with pytest.raises(ValueError, match="step_limits must have shape"):
        eng.run({g: torch.tensor(a) for g, a in arrays.items()}, {}, 2,
                step_limits=[1, 2])
    grids = {g: st.grid(st.f32, MASK_SHAPE, 2, batch=MB, device="cpu") for g in ("u", "v")}
    with pytest.raises(ValueError, match="batched torch"):
        st.differentiable_timeloop(k, grids["u"], grids["v"], steps=2, swap=("v", "u"),
                                   domain_mask=mask, backend=st.hopper())


def test_masked_gradient_matches_jax():
    k, halos, arrays, mask, limits = _masked_inputs("star2d2r", seed=2)
    jk = jsuite.get_kernel("star2d2r")
    jeng = jtimeloop.TimeloopEngine(jk.ir, halos, MASK_SHAPE, jst.xla(), swap=("v", "u"),
                                    batch=MB, differentiable=True)
    jfn = jadjoint.differentiable_run(jeng, 6, fuse_steps=2, domain_mask=jnp.asarray(mask),
                                      step_limits=jnp.asarray(limits))
    jg = jax.grad(lambda a: sum(jnp.sum(o ** 2) for o in jfn(a, {}).values()))(
        {g: jnp.asarray(a) for g, a in arrays.items()})
    grids = {g: st.grid(st.f32, MASK_SHAPE, 2, batch=MB, device="cpu",
                        data=torch.tensor(a)) for g, a in arrays.items()}
    fn = st.differentiable_timeloop(k, grids["u"], grids["v"], steps=6, swap=("v", "u"),
                                    fuse_steps=2, domain_mask=mask, step_limits=limits)
    x = {g: torch.tensor(a, requires_grad=True) for g, a in arrays.items()}
    sum((o ** 2).sum() for o in fn(x).values()).backward()
    for g in arrays:
        want = np.asarray(jg[g])
        scale = float(np.abs(want).max())
        assert float(np.abs(x[g].grad.numpy() - want).max()) <= GRAD_RTOL * scale, g


def test_masked_window_grads_freeze_masked_cells():
    """The frozen-cell identity of ``tests/test_timeloop_grad.py`` (f64): a
    cell deep in a frozen region passes its value through unchanged, so
    its cotangent is exactly the output cotangent; and the gradient agrees
    with central differences."""
    B, shape = 2, (8, 10)
    k = suite.get_kernel("star2d2r")
    grids = {g: st.grid(st.f64, shape, 2, batch=B, device="cpu").randomize(i)
             for i, g in enumerate(k.ir.grid_params)}
    arrays = {g: gr.data for g, gr in grids.items()}
    mask = np.ones((B,) + shape, bool)
    mask[1, :, 5:] = False                 # scenario 1: right half frozen
    limits = np.array([4, 2], np.int32)    # scenario 1 stops at step 2
    eng = timeloop.TimeloopEngine(k.ir, {g: (2, 2) for g in arrays}, shape, st.torch(),
                                  swap=("v", "u"), batch=B, differentiable=True)
    fn = adjoint.differentiable_run(eng, 4, domain_mask=mask, step_limits=limits)

    def loss(arrs):
        out = fn(arrs, {})
        return (out["u"][1] ** 2).sum() + (out["v"][1] ** 2).sum()

    x = {g: a.clone().requires_grad_() for g, a in arrays.items()}
    loss(x).backward()
    out = fn(arrays, {})
    o = 2
    frozen = (1, o + 4, o + 8)             # beyond the active cells' tap reach
    for g in ("u", "v"):
        assert float(x[g].grad[frozen]) == pytest.approx(2.0 * float(out[g][frozen]),
                                                         rel=1e-12)
    rng = np.random.default_rng(7)
    eps = 1e-6
    for g, a in arrays.items():
        for _ in range(2):
            idx = tuple(int(rng.integers(0, s)) for s in a.shape)
            ap, am = a.clone(), a.clone()
            ap[idx] += eps
            am[idx] -= eps
            fd = (float(loss({**arrays, g: ap})) - float(loss({**arrays, g: am}))) / (2 * eps)
            ad = float(x[g].grad[idx])
            assert abs(ad - fd) <= 1e-3 * max(abs(fd), abs(ad), 1e-8), (g, idx, ad, fd)


def test_server_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.pack_wave(_k(), (8, 8), [], 1)
