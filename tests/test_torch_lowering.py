"""Port parity: the plain torch lowering and the DSL surface vs the JAX
package's xla lowering.

Inputs are made with numpy from a seed and handed to both.  Tolerance:
f32, atol 1e-5 — both sides evaluate the same expression tree in f32 with
the same constant folding, but XLA may contract or fuse differently, so
results agree to a few ulp, not bit for bit.  Initial conditions
(``randomize``, ``make_grids``, ``make_fields``, ``damping_mask``) are
compared exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import acoustic as jacoustic  # noqa: E402
from repro.core import dsl as jst  # noqa: E402
from repro.core import lowering as jlowering  # noqa: E402
from repro.core import regions as jregions  # noqa: E402
from repro.core import suite as jsuite  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import acoustic, autotune, lowering, regions, suite  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402

ATOL = 1e-5
SHAPE_2D = (24, 40)
SHAPE_3D = (12, 16, 20)


def _inputs(kernel, interior, seed=0, halos=None):
    rng = np.random.default_rng(seed)
    halos = halos or {g: kernel.info.halo for g in kernel.ir.grid_params}
    arrays = {g: rng.standard_normal(
        tuple(s + 2 * h for s, h in zip(interior, halos[g]))).astype(np.float32)
        for g in kernel.ir.grid_params}
    return arrays, halos


def _jax(arrays):
    return {g: jnp.asarray(a) for g, a in arrays.items()}


def _torch(arrays):
    return {g: torch.tensor(a) for g, a in arrays.items()}


def _close(got, want, atol=ATOL):
    for g in want:
        np.testing.assert_allclose(np.asarray(got[g]), np.asarray(want[g]),
                                   atol=atol, rtol=0, err_msg=g)


@pytest.mark.parametrize("name", suite.KERNEL_NAMES)
def test_lower_torch_matches_lower_jax(name):
    k = suite.get_kernel(name)
    interior = SHAPE_2D if k.info.ndim == 2 else SHAPE_3D
    arrays, halos = _inputs(k, interior)
    want = jlowering.lower_jax(jsuite.get_kernel(name).ir, halos,
                               interior)(_jax(arrays), {})
    got = lowering.lower_torch(k.ir, halos, interior)(_torch(arrays), {})
    _close(got, want)


@pytest.mark.parametrize("steps", (1, 4, 7))
@pytest.mark.parametrize("name", ("star2d1r", "star3d4r", "box2d2r"))
def test_lower_torch_window_matches_lower_jax_window(name, steps):
    k = suite.get_kernel(name)
    interior = SHAPE_2D if k.info.ndim == 2 else SHAPE_3D
    arrays, halos = _inputs(k, interior, seed=steps)
    swap = suite.swap_pair(name)
    want = jlowering.lower_jax_window(jsuite.get_kernel(name).ir, halos,
                                      interior, None, swap, steps)(
        _jax(arrays), {})
    got = lowering.lower_torch_window(k.ir, halos, interior, None, swap,
                                      steps)(_torch(arrays), {})
    _close(got, want)


@pytest.mark.parametrize("steps", (1, 4, 7))
def test_acoustic_window_matches(steps):
    k, jk = acoustic.acoustic_iso_kernel, jacoustic.acoustic_iso_kernel
    interior = (12, 10, 16)
    arrays, halos = _inputs(k, interior, seed=11)
    # physical coefficients (vp² > 0, small damping) keep the update stable
    rng = np.random.default_rng(12)
    arrays["vp2"] = rng.uniform(1.0, 2.25, arrays["vp2"].shape).astype(np.float32)
    arrays["damp"] = rng.uniform(0.0, 0.2, arrays["damp"].shape).astype(np.float32)
    scal = {"dt": np.float32(0.3)}
    want = jlowering.lower_jax_window(jk.ir, halos, interior, None,
                                      ("p0", "p1"), steps)(
        _jax(arrays), {"dt": jnp.float32(0.3)})
    got = lowering.lower_torch_window(k.ir, halos, interior, None,
                                      ("p0", "p1"), steps)(
        _torch(arrays), st.scalar_tensors(scal, "cpu"))
    _close(got, want)


def test_region_matches():
    k = suite.get_kernel("star2d2r")
    arrays, halos = _inputs(k, SHAPE_2D, seed=5)
    region = ((4, 20), (8, 32))
    want = jlowering.lower_jax(jsuite.get_kernel("star2d2r").ir, halos,
                               SHAPE_2D, region)(_jax(arrays), {})
    got = lowering.lower_torch(k.ir, halos, SHAPE_2D, region)(
        _torch(arrays), {})
    _close(got, want)


@st.kernel
def _mathy(u: st.grid, v: st.grid, a: st.f32):
    t = exp(-abs(u.at(1, 0))) + sqrt(abs(u.at(0, -1)) + 1.0)  # noqa: F821
    v.at(0, 0).set(max(t, a) - min(u.at(0, 0), 2.0 ** 0.5)  # noqa: F821
                   + tanh(u.at(-1, 0)) * cos(u.at(0, 1)) / (2.0 + sin(a)))  # noqa: F821


@jst.kernel
def _jmathy(u: jst.grid, v: jst.grid, a: jst.f32):
    t = exp(-abs(u.at(1, 0))) + sqrt(abs(u.at(0, -1)) + 1.0)  # noqa: F821
    v.at(0, 0).set(max(t, a) - min(u.at(0, 0), 2.0 ** 0.5)  # noqa: F821
                   + tanh(u.at(-1, 0)) * cos(u.at(0, 1)) / (2.0 + sin(a)))  # noqa: F821


def test_math_calls_match():
    arrays, halos = _inputs(_mathy, (9, 13), seed=2)
    want = jlowering.lower_jax(_jmathy.ir, halos, (9, 13))(
        _jax(arrays), {"a": jnp.float32(0.7)})
    got = lowering.lower_torch(_mathy.ir, halos, (9, 13))(
        _torch(arrays), st.scalar_tensors({"a": 0.7}, "cpu"))
    _close(got, want)


# ---- initial conditions are bit-identical ----------------------------------
def test_randomize_bit_identical():
    a = st.grid(dtype=st.f32, shape=(6, 7, 8), order=2, device="cpu").randomize(3)
    b = jst.grid(dtype=jst.f32, shape=(6, 7, 8), order=2).randomize(3)
    np.testing.assert_array_equal(a.data.numpy(), np.asarray(b.data))


@pytest.mark.parametrize("name", ("star2d1r", "star3d4r", "j3d27pt"))
def test_make_grids_bit_identical(name):
    a = suite.make_grids(name, seed=4, device="cpu")
    b = jsuite.make_grids(name, seed=4)
    for g in b:
        np.testing.assert_array_equal(a[g].data.numpy(), np.asarray(b[g].data))


def test_acoustic_fields_bit_identical():
    a = acoustic.make_fields((10, 12, 14), pml_width=3, device="cpu")
    b = jacoustic.make_fields((10, 12, 14), pml_width=3)
    for ga, gb in zip(a[:4], b[:4]):
        np.testing.assert_array_equal(ga.data.numpy(), np.asarray(gb.data))
    assert a[4] == b[4]
    np.testing.assert_array_equal(
        regions.damping_mask((7, 9), 2, 0.3).numpy(),
        np.asarray(jregions.damping_mask((7, 9), 2, 0.3)))
    assert regions.seven_region((10, 12, 14), 3) == \
        jregions.seven_region((10, 12, 14), 3)


def test_interop_grids_from_numpy():
    jg = jsuite.make_grids("star3d2r", shape=(5, 6, 7), seed=1)
    arrays = {n: np.asarray(g.data) for n, g in jg.items()}
    grids = interop.grids_from_numpy(arrays, {n: 2 for n in arrays}, "cpu")
    for n, g in grids.items():
        assert g.shape == (5, 6, 7) and g.order == 2
        np.testing.assert_array_equal(g.data.numpy(), arrays[n])
    with pytest.raises(ValueError, match="one halo width"):
        interop.grids_from_numpy({"u": arrays["u"]}, {"u": (2, 1, 2)}, "cpu")


# ---- DSL surface --------------------------------------------------------------
def test_map_matches_jax_per_step_loop():
    k, jk = suite.get_kernel("star2d1r"), jsuite.get_kernel("star2d1r")
    u0 = np.random.default_rng(7).standard_normal((18, 18)).astype(np.float32)

    def tgt(u, v, k):
        for _ in range(5):
            st.map(e=u.shape)(k)(u, v)
            (u.data, v.data) = (v.data, u.data)
        return u

    def jtgt(u, v):
        for _ in range(5):
            jst.map(e=u.shape)(jk)(u, v)
            (u.data, v.data) = (v.data, u.data)
        return u

    u = st.grid(shape=(16, 16), order=1, data=torch.tensor(u0))
    v = st.grid(shape=(16, 16), order=1, device="cpu")
    got = st.launch(backend=st.torch())(tgt)(u, v, k).value.interior
    ju = jst.grid(shape=(16, 16), order=1, data=jnp.asarray(u0))
    jv = jst.grid(shape=(16, 16), order=1)
    want = jst.launch(backend=jst.xla())(jtgt)(ju, jv).value.interior
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_acoustic_run_per_step_matches():
    p_t, _ = acoustic.run(shape=(10, 12, 14), iters=4, pml_width=3,
                          device="cpu")
    p_j, _ = jacoustic.run(shape=(10, 12, 14), iters=4, pml_width=3)
    np.testing.assert_allclose(p_t.data.numpy(), np.asarray(p_j.data),
                               atol=ATOL)


def test_grid_copy_clones():
    a = st.grid(shape=(4, 4), order=1, device="cpu").randomize(0)
    b = a.copy()
    a.data += 1.0
    assert float((a.data - b.data).abs().max()) == 1.0


def test_cuda_alias_selects_hopper():
    be = st.cuda("sm_90a", (4, 64), template="shift")
    assert isinstance(be, st.hopper)
    assert (be.kind, be.template, be.block) == ("hopper", "shift", (4, 64))
    assert st.torch().kind == "torch"
    with pytest.raises(ValueError, match="unknown template"):
        st.hopper(template="tma")


@pytest.mark.parametrize("call", [
    # st.launch(autotune=True) runs since the autotuner was ported; tuning
    # over a mesh waits for the distributed layer
    lambda: autotune.tune(None, None, mesh={"data": 2}),
    lambda: st.distributed(grid_axes=("data",)),
    # the adjoint, batch=B and its masked serving windows were ported; the
    # adjoint over a mesh waits for the distributed layer
    lambda: st.differentiable_timeloop(
        suite.get_kernel("star2d1r"),
        *suite.make_grids("star2d1r", (4, 4), device="cpu").values(),
        steps=1, swap=("v", "u"), mesh={"data": 2}),
], ids=["autotune", "distributed", "adjoint"])
def test_not_ported_features_raise(call):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        call()


def test_map_under_hopper_raises():
    """``st.map`` runs under hopper (K4); it refuses grids its f32 kernels
    do not take, on the CPU as on the card."""
    k = suite.get_kernel("star2d1r")
    g = {n: st.grid(dtype=st.f64, shape=(8, 8), order=1, device="cpu")
         for n in ("u", "v")}

    def tgt(u, v):
        st.map(e=u.shape)(k)(u, v)

    with pytest.raises(TypeError, match="float32"):
        st.launch(backend=st.hopper())(tgt)(g["u"], g["v"])


@st.kernel
def _squared(u: st.grid, v: st.grid):
    v.at(0, 0).set(u.at(1, 0) * u.at(-1, 0))


@pytest.mark.parametrize("backend", [st.hopper(template="semi"),
                                     st.hopper(time_block=2)],
                         ids=["semi", "time_block"])
def test_map_under_semi_and_time_block_raises(backend):
    """``st.map`` refuses, as the JAX package's does: the semi template for
    a kernel that is not linear in its taps, and the temporal knob, which
    belongs to the fused time loop."""
    g = suite.make_grids("star2d1r", shape=(8, 8), device="cpu")
    k = _squared if backend.template == "semi" else suite.get_kernel("star2d1r")
    with pytest.raises(ValueError,
                       match="tap-bearing|time_block > 1"):
        st.launch(backend=backend)(
            lambda u, v: st.map(e=u.shape)(k)(u, v))(g["u"], g["v"])
