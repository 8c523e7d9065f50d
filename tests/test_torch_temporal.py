"""Port parity: in-kernel temporal blocking (``st.hopper(time_block=k)``,
kernel K3) vs the JAX package's ``st.timeloop`` under ``st.xla()``.

K3 is CUDA C++ and runs only on the card (``chip_smoke.py``); on CPU
tensors ``st.timeloop`` runs its plain version, which walks the kernel's
chunks, pipelined stages, ring slots and widened extents and takes the
cells outside the interior as the kernel does.  These tests prove that
algorithm, the window decomposition (K3 launches plus single-step
remainder on the same layout), the spare ping-pong and the rotation
parity against the JAX package; they do not prove the CUDA code.

Every cell of every grid is random, halos included, with different
values in the two swap buffers, so a sub-step that took the halo of the
wrong buffer would fail.  Tolerance: f32, atol 1e-5 for the suite kernels
and 1e-4 of the field's max for the leapfrog kernels (acoustic ISO and a
wave equation), whose updates carry rounding differences forward.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import acoustic as jacoustic  # noqa: E402
from repro.core import dsl as jst  # noqa: E402
from repro.core import suite as jsuite  # noqa: E402
from repro.kernels.stencil import codegen as jcodegen  # noqa: E402
from repro_torch.core import acoustic, suite  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.kernels.stencil import codegen, ops  # noqa: E402
from repro_torch.kernels.stencil.temporal_step import temporal_step  # noqa: E402

ATOL = 1e-5
TB_SHAPE = (13, 21)            # no block divides it


def _arrays(kernel, shape, seed=0, halos=None):
    """Random f32 values in every cell, a different draw per grid."""
    rng = np.random.default_rng(seed)
    h = kernel.info.order
    return {g: rng.standard_normal(tuple(
        s + 2 * (halos[g] if halos else h) for s in shape)).astype(np.float32)
        for g in kernel.ir.grid_params}


def _suite_pair(name, shape, steps, backend, fuse=None, seed=0, between=None,
                launch_kw=None):
    """(xla result, port result, port TimeloopResult) of ``steps`` fused
    steps of suite kernel ``name`` on the same random grids."""
    k = suite.get_kernel(name)
    arrays = _arrays(k, shape, seed)
    h = k.info.order
    sw = suite.swap_pair(name)

    jk = jsuite.get_kernel(name)
    jg = {g: jst.grid(shape=shape, order=h, data=jnp.asarray(a))
          for g, a in arrays.items()}
    jst.launch(backend=jst.xla())(
        lambda *a: jst.timeloop(steps, swap=sw, fuse_steps=fuse)(jk)(*a))(
        *[jg[g] for g in jk.ir.grid_params])

    tg = {g: st.grid(shape=shape, order=h, data=torch.tensor(a))
          for g, a in arrays.items()}
    res = st.launch(backend=backend, **(launch_kw or {}))(
        lambda *a: st.timeloop(steps, swap=sw, fuse_steps=fuse,
                               between=between)(k)(*a))(
        *[tg[g] for g in k.ir.grid_params])
    return ({g: np.asarray(x.data) for g, x in jg.items()},
            {g: x.data.numpy() for g, x in tg.items()}, res.value)


@pytest.mark.parametrize("template", ("gmem", "smem", "f4", "shift",
                                      "unroll", "semi"))
@pytest.mark.parametrize("time_block", (1, 2, 3, 4))
def test_time_block_matches_xla_all_templates(template, time_block):
    """k steps per launch == the xla loop, on a shape no block divides,
    with a remainder (5 steps), for every template; the outermost k·h
    interior cells, where the shrinking stages meet the grid halo, are
    checked on their own."""
    name = "star2d2r"
    be = st.hopper(template=template, time_block=time_block, block=(4, 16))
    want, got, res = _suite_pair(name, TB_SHAPE, 5, be)
    assert res.steps == 5 and res.fuse_steps == 5
    o = suite.get_kernel(name).info.order
    kh = time_block * o
    for g in ("u", "v"):
        np.testing.assert_allclose(got[g], want[g], atol=ATOL, rtol=0,
                                   err_msg=f"{template}/k={time_block}/{g}")
        for ax in range(2):
            for sl in (slice(o, o + kh), slice(-o - kh, -o)):
                idx = tuple(sl if a == ax else slice(None) for a in range(2))
                np.testing.assert_allclose(
                    got[g][idx], want[g][idx], atol=ATOL, rtol=0,
                    err_msg=f"{template}/k={time_block}/{g}/boundary ax{ax}")


@pytest.mark.parametrize("name", ("star2d2r", "box2d1r", "star3d2r",
                                  "box3d1r", "j2d5pt", "j3d27pt"))
def test_time_block4_matches_xla_suite(name):
    shape = (16, 24) if suite.get_kernel(name).info.ndim == 2 else (8, 10, 16)
    want, got, _ = _suite_pair(name, shape, 5,
                               st.hopper(template="gmem", time_block=4),
                               fuse=4)
    for g in ("u", "v"):
        np.testing.assert_allclose(got[g], want[g], atol=ATOL, rtol=0,
                                   err_msg=f"{name}/{g}")


@pytest.mark.parametrize("fuse", (1, 3, 7), ids=("fuse1", "fuse3", "fuse7"))
def test_time_block_star3d4r_matches_xla(fuse):
    seen = []
    want, got, res = _suite_pair(
        "star3d4r", (11, 9, 13), 7,
        st.hopper(template="shift", time_block=2, block=(4, 4, 8)), fuse=fuse,
        between=lambda t, g: seen.append(t))
    assert seen == list(range(fuse, 7, fuse))
    assert res.windows == -(-7 // fuse)
    for g in ("u", "v"):
        np.testing.assert_allclose(got[g], want[g], atol=ATOL, rtol=0,
                                   err_msg=g)


def _acoustic_pair(backend, fuse, shape=(12, 10, 14), steps=7, seed=4):
    """Acoustic ISO with the source injected in ``between``, from random
    pressure fields (halos included), on both packages."""
    rng = np.random.default_rng(seed)
    full = tuple(s + 8 for s in shape)
    p = [(0.1 * rng.standard_normal(full)).astype(np.float32) for _ in range(2)]
    out = []
    for mod, dsl, be, kw in ((jacoustic, jst, jst.xla(), {}),
                             (acoustic, st, backend, {"device": "cpu"})):
        p0, p1, vp2, damp, dt = mod.make_fields(shape, pml_width=3, **kw)
        p0.data = p0.data * 0 + (jnp.asarray(p[0]) if mod is jacoustic
                                  else torch.tensor(p[0]))
        p1.data = p1.data * 0 + (jnp.asarray(p[1]) if mod is jacoustic
                                  else torch.tensor(p[1]))
        mod.inject_source(p1, 0)

        def between(t, grids, mod=mod):
            mod.inject_source(grids["p1"], t)
        dsl.launch(backend=be, fuse_steps=fuse)(mod.acoustic_target_fused)(
            p0, p1, vp2, damp, dt, steps, between=between)
        out.append({"p0": np.asarray(p0.data), "p1": np.asarray(p1.data)})
    return out


@pytest.mark.parametrize("fuse", (1, 3, 7), ids=("fuse1", "fuse3", "fuse7"))
def test_time_block_acoustic_with_between_matches_xla(fuse):
    want, got = _acoustic_pair(
        st.hopper(template="shift", time_block=2, block=(5, 4, 8)), fuse)
    scale = max(np.abs(w).max() for w in want.values())
    for g in want:
        np.testing.assert_allclose(got[g], want[g], atol=1e-4 * scale, rtol=0,
                                   err_msg=g)


@pytest.mark.parametrize("time_block", (3, 5))
def test_time_block_odd_rotation_parity(time_block):
    """Odd depths rotate the output names and the spare names together."""
    want, got, _ = _suite_pair("star2d1r", TB_SHAPE, 7,
                               st.hopper(template="gmem",
                                         time_block=time_block))
    for g in ("u", "v"):
        np.testing.assert_allclose(got[g], want[g], atol=ATOL, rtol=0,
                                   err_msg=f"k={time_block}/{g}")


@pytest.mark.parametrize("fuse,want_seen", [
    (None, []), (16, []), (3, [3, 6, 9]), (1, list(range(1, 10)))])
def test_between_cadence_unchanged_by_time_block(fuse, want_seen):
    """fuse_steps is the between-hook cadence, honored exactly and never
    rounded to a multiple of the depth (10 steps, k=4)."""
    seen = []
    want, got, res = _suite_pair(
        "star2d1r", (16, 24), 10, st.hopper(template="gmem", time_block=4),
        fuse=fuse, between=lambda t, g: seen.append(t))
    assert seen == want_seen
    assert res.fuse_steps == min(fuse or 10, 10)
    for g in ("u", "v"):
        np.testing.assert_allclose(got[g], want[g], atol=ATOL, rtol=0)


def test_launch_time_block_overrides_hopper_backend():
    """st.launch(time_block=k) replaces the depth of a hopper backend (the
    counted traffic shows K3 ran); under st.torch() a depth other than 1
    raises instead of running unblocked."""
    codegen.reset_traffic_count()
    want, got, res = _suite_pair("star2d1r", (16, 24), 10,
                                 st.hopper(template="gmem"), fuse=3,
                                 launch_kw={"time_block": 2})
    assert (res.fuse_steps, res.windows) == (3, 4)
    # windows 3, 3, 3, 1: each 3-step window is one K3 launch (2 reads, 2
    # writes) and one single step (2 reads, 1 write)
    assert dict(codegen.TRAFFIC_COUNT) == {"grid_reads": 14,
                                           "grid_writes": 10, "steps": 10}
    for g in ("u", "v"):
        np.testing.assert_allclose(got[g], want[g], atol=ATOL, rtol=0)
    grids = suite.make_grids("star2d1r", (8, 8), device="cpu")
    k = suite.get_kernel("star2d1r")
    with pytest.raises(ValueError, match="hopper backend"):
        st.launch(backend=st.torch(), time_block=2)(
            lambda u, v: st.timeloop(2, swap=("v", "u"))(k)(u, v))(
            grids["u"], grids["v"])
    st.launch(backend=st.torch(), time_block=1)(
        lambda u, v: st.timeloop(2, swap=("v", "u"))(k)(u, v))(
        grids["u"], grids["v"])
    with pytest.raises(ValueError, match="time_block must be >= 1"):
        st.launch(backend=st.hopper(), time_block=0)(
            lambda u, v: st.timeloop(2, swap=("v", "u"))(k)(u, v))(
            grids["u"], grids["v"])


def test_time_block_one_pad_per_grid_per_window():
    codegen.reset_pad_count()
    _suite_pair("star2d1r", (16, 24), 12,
                st.hopper(template="gmem", time_block=2), fuse=4)
    assert codegen.PAD_COUNT["u"] == 3 and codegen.PAD_COUNT["v"] == 3
    assert codegen.PAD_COUNT["total"] == 6
    codegen.reset_pad_count()


def test_time_block_reduces_counted_traffic():
    """Counted grid reads and writes per step fall by at least 2× at k=4."""
    def ratio(tb):
        codegen.reset_traffic_count()
        _suite_pair("star2d1r", (16, 24), 8,
                    st.hopper(template="gmem", time_block=tb), fuse=8)
        t = dict(codegen.TRAFFIC_COUNT)
        return t["grid_reads"] / t["steps"], t["grid_writes"] / t["steps"]

    (r1, w1), (r4, w4) = ratio(1), ratio(4)
    codegen.reset_traffic_count()
    assert r1 / r4 >= 2 and w1 / w4 >= 2, (r1, r4, w1, w4)


def test_temporal_hbm_model():
    """K3's modeled traffic at 512³: the widened read window, the halo and
    point reads per sub-step, both writes, over k; the compulsory bound of
    the chip script (1.5 passes per step for star3d4r at k=2) is below."""
    k = suite.get_kernel("star3d4r")
    halos = {"u": (4, 4, 4), "v": (4, 4, 4)}
    R = (512, 512, 512)
    p2 = codegen.plan_cuda(k.ir, halos, R, st.hopper(time_block=2),
                           swap=("v", "u"))
    assert p2.B == (128, 16, 64) and p2.kind == "temporal"
    assert p2.step_out_grids == ("v", "u")
    n = 512 ** 3
    # u's window: per chunk 128 + 2·8 planes, per tile 16 + 16 rows and 64
    # + 16 columns, clipped to the reach [-4, 516) at the ends of each axis
    win = (4 * 144 - 8) * (32 * 32 - 8) * (8 * 80 - 8)
    # sub-step 0's ring (widened by 4) takes its cells outside the
    # interior from v: the widened window less its interior part
    ring0 = 4 * 136 * 32 * 24 * 8 * 72 - (4 * 136 - 8) * (32 * 24 - 8) * (8 * 72 - 8)
    got = p2.hbm_bytes_per_step()
    assert got > 4 * 1.5 * n           # above the compulsory traffic
    assert got == 4 * (win + ring0 + 2 * n) / 2


def test_time_block_validation_matches_jax():
    """The temporal-blocking checks raise the JAX package's messages."""
    @st.kernel
    def two(u: st.grid, a: st.grid, b: st.grid):
        a.at(0, 0).set(0.5 * u.at(1, 0))
        b.at(0, 0).set(0.5 * u.at(-1, 0))

    @jst.kernel
    def jtwo(u: jst.grid, a: jst.grid, b: jst.grid):
        a.at(0, 0).set(0.5 * u.at(1, 0))
        b.at(0, 0).set(0.5 * u.at(-1, 0))

    k, jk = suite.get_kernel("star2d1r"), jsuite.get_kernel("star2d1r")
    cases = [((k, jk), None), ((k, jk), ("u", "v")), ((two, jtwo), ("a", "u"))]
    for (pk, jkk), swap in cases:
        halos = {g: (1, 1) for g in pk.ir.grid_params}
        with pytest.raises(ValueError) as want:
            jcodegen.plan_pallas(jkk.ir, halos, (16, 24),
                                 jst.pallas(template="gmem", time_block=2),
                                 swap=swap)
        with pytest.raises(ValueError) as got:
            codegen.plan_cuda(pk.ir, halos, (16, 24),
                              st.hopper(template="gmem", time_block=2),
                              swap=swap)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="time_block must be >= 1"):
        st.hopper(time_block=0)


def test_temporal_shared_memory_limit_raises():
    """K3's default tile is the first of ``TEMPORAL_BLOCKS`` whose rings
    fit; an explicit tile whose rings do not raises."""
    k = suite.get_kernel("star3d4r")
    halos = {"u": (4, 4, 4), "v": (4, 4, 4)}
    p4 = codegen.plan_cuda(k.ir, halos, (64, 64, 64), st.hopper(time_block=4),
                           swap=("v", "u"))
    # ring -1: 11 planes of 48 x 64 cells (the (16, 32) tile widened by
    # 4·4); rings 0-2: 5 planes each (a star reads them at dx = 0 only);
    # the slack to align the base and 11 mbarriers
    assert p4.B == (128, 16, 32)
    assert p4.smem_bytes == (128 + 4 * 11 * 48 * 64
                             + 4 * 5 * (40 * 56 + 32 * 48 + 24 * 40) + 8 * 11)
    p5 = codegen.plan_cuda(k.ir, halos, (64, 64, 64), st.hopper(time_block=5),
                           swap=("v", "u"))
    assert p5.B == codegen.TEMPORAL_BLOCKS[3][-1]
    assert p5.smem_bytes <= codegen.SMEM_LIMIT
    with pytest.raises(ValueError, match=r"time_block=5: the 5 plane rings of "
                                         r"block \(128, 16, 64\) need \d+ B of "
                                         r"shared memory \(> 232448\)"):
        codegen.plan_cuda(k.ir, halos, (64, 64, 64),
                          st.hopper(time_block=5, block=(128, 16, 64)),
                          swap=("v", "u"))


def test_temporal_step_writes_only_spares():
    """K3 (plain version) leaves the buffers it reads as they were, refuses
    to run without spares or with a spare aliasing a read buffer."""
    k = suite.get_kernel("star3d2r")
    shape = (9, 7, 10)
    arrays = {g: torch.tensor(a) for g, a in _arrays(k, shape, 3).items()}
    plan = codegen.plan_cuda(k.ir, {g: (2, 2, 2) for g in arrays}, shape,
                             st.hopper(time_block=3, block=(4, 2, 8)),
                             swap=("v", "u"))
    padded = plan.to_padded(arrays)
    before = {g: t.clone() for g, t in padded.items()}
    with pytest.raises(ValueError, match="double-buffered"):
        plan.step(padded, {})
    spares = plan.make_spares(padded)
    out = plan.step(padded, {}, spares=spares)
    for g in padded:
        assert torch.equal(padded[g], before[g]), g
        assert out[g] is spares[g]
    # the spares' halos are their grids' own
    assert torch.equal(spares["u"][:2], before["u"][:2])
    with pytest.raises(ValueError, match="aliases a buffer"):
        plan.launch_args(padded, {}, spares={"v": padded["u"], "u": spares["u"]})
    meta = {g: torch.empty(13, 11, 14, device="meta") for g in ("u", "v")}
    with pytest.raises(ValueError, match="unsupported device"):
        temporal_step(plan, meta, meta, {})


@st.kernel
def _tapped_coef(u: st.grid, v: st.grid, c: st.grid, w: st.grid):
    v.at(0, 0).set(0.5 * u.at(0, 0) - 0.25 * v.at(0, 0)
                   + 0.1 * c.at(1, 0) * (u.at(0, 1) + u.at(-1, 0))
                   + 0.05 * w.at(0, 0) * u.at(1, -1))


@jst.kernel
def _jtapped_coef(u: jst.grid, v: jst.grid, c: jst.grid, w: jst.grid):
    v.at(0, 0).set(0.5 * u.at(0, 0) - 0.25 * v.at(0, 0)
                   + 0.1 * c.at(1, 0) * (u.at(0, 1) + u.at(-1, 0))
                   + 0.05 * w.at(0, 0) * u.at(1, -1))


@pytest.mark.parametrize("time_block", (2, 3))
def test_time_block_leapfrog_with_tapped_coefficient(time_block):
    """A leapfrog kernel that reads the written grid at the center (its
    value two sub-steps back) and a coefficient grid off-center (read at
    the point in every sub-step)."""
    shape = (11, 17)
    arrays = _arrays(_tapped_coef, shape, 5)
    jg = {g: jst.grid(shape=shape, order=1, data=jnp.asarray(a))
          for g, a in arrays.items()}
    jst.launch(backend=jst.xla())(
        lambda *a: jst.timeloop(7, swap=("v", "u"))(_jtapped_coef)(*a))(
        *[jg[g] for g in ("u", "v", "c", "w")])
    tg = {g: st.grid(shape=shape, order=1, data=torch.tensor(a))
          for g, a in arrays.items()}
    st.launch(backend=st.hopper(template="unroll", time_block=time_block,
                                block=(3, 8)))(
        lambda *a: st.timeloop(7, swap=("v", "u"))(_tapped_coef)(*a))(
        *[tg[g] for g in ("u", "v", "c", "w")])
    scale = max(np.abs(np.asarray(jg[g].data)).max() for g in ("u", "v"))
    for g in arrays:
        np.testing.assert_allclose(tg[g].data.numpy(), np.asarray(jg[g].data),
                                   atol=1e-4 * scale, rtol=0, err_msg=g)


def test_ops_stencil_timeloop_time_block_matches_xla():
    k = suite.get_kernel("star3d4r")
    arrays = _arrays(k, (9, 10, 12), 1)
    jg = {g: jst.grid(shape=(9, 10, 12), order=4, data=jnp.asarray(a))
          for g, a in arrays.items()}
    jst.launch(backend=jst.xla())(
        lambda u, v: jst.timeloop(5, swap=("v", "u"))(
            jsuite.get_kernel("star3d4r"))(u, v))(jg["u"], jg["v"])
    got = ops.stencil_timeloop(k, {g: torch.tensor(a) for g, a in arrays.items()},
                               5, swap=("v", "u"), template="shift",
                               fuse_steps=3, time_block=2)
    for g in arrays:
        np.testing.assert_allclose(got[g].numpy(), np.asarray(jg[g].data),
                                   atol=ATOL, rtol=0, err_msg=g)
