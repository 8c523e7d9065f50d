"""Port parity: the fused time-loop engine under ``st.torch()`` and
``st.hopper()`` (on CPU tensors: the kernels' plain versions) vs the JAX
package's ``st.timeloop`` under ``st.xla()``.

Tolerance: f32, atol 1e-5 for the suite kernels (weights sum to 1, so
values stay O(1) and per-step rounding differences do not grow), and
rtol 1e-4 of the field's max for acoustic ISO, whose leapfrog update
carries rounding differences forward from step to step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import acoustic as jacoustic  # noqa: E402
from repro.core import dsl as jst  # noqa: E402
from repro.core import suite as jsuite  # noqa: E402
from repro_torch.core import acoustic, suite, timeloop  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.kernels.stencil import codegen, ops  # noqa: E402

ATOL = 1e-5
BACKENDS = {
    "torch": lambda nd: st.torch(),
    "hopper-gmem": lambda nd: st.hopper(template="gmem"),
    "hopper-shift": lambda nd: st.hopper(template="shift",
                                         block=(5, 4, 8) if nd == 3 else (5, 16)),
}
SHAPES = {"star2d1r": (24, 40), "star3d4r": (12, 16, 20)}


def _suite_run(mod, name, steps, fuse, backend, **kw):
    grids = mod.make_grids(name, SHAPES[name], seed=2, **kw)
    k = mod.get_kernel(name)
    sw = mod.swap_pair(name)
    dsl = st if mod is suite else jst

    @dsl.target
    def tgt(*args):
        return dsl.timeloop(steps, swap=sw, fuse_steps=fuse)(k)(*args)

    res = dsl.launch(backend=backend)(tgt)(*[grids[g] for g in k.ir.grid_params])
    return {g: np.asarray(grids[g].data) for g in grids}, res.value


@pytest.mark.parametrize("fuse", (1, 3, None), ids=("fuse1", "fuse3", "fuseall"))
@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_suite_timeloop_matches_xla(name, backend, fuse):
    want, _ = _suite_run(jsuite, name, 7, fuse, jst.xla())
    be = BACKENDS[backend](len(SHAPES[name]))
    got, res = _suite_run(suite, name, 7, fuse, be, device="cpu")
    assert res.steps == 7
    assert res.fuse_steps == (fuse or 7)
    assert res.windows == -(-7 // (fuse or 7))
    for g in want:
        np.testing.assert_allclose(got[g], want[g], atol=ATOL, rtol=0,
                                   err_msg=f"{name}/{backend}/{g}")


def _acoustic_run(mod, backend, fuse, **kw):
    p, _ = mod.run(shape=(12, 14, 16), iters=7, backend=backend, pml_width=3,
                   fuse_steps=fuse, **kw)
    return np.asarray(p.data)


@pytest.mark.parametrize("fuse", (1, 3, 7), ids=("fuse1", "fuse3", "fuseall"))
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_acoustic_with_between_hook_matches_xla(backend, fuse):
    want = _acoustic_run(jacoustic, jst.xla(), fuse)
    got = _acoustic_run(acoustic, BACKENDS[backend](3), fuse, device="cpu")
    assert np.abs(want).max() > 1e-3         # the source did inject
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)


def test_between_hook_cadence():
    seen = []
    grids = suite.make_grids("star2d1r", (8, 8), device="cpu")
    k = suite.get_kernel("star2d1r")
    st.timeloop(10, swap=("v", "u"), fuse_steps=4,
                between=lambda t, g: seen.append(t))(k)(grids["u"], grids["v"])
    assert seen == [4, 8]


@pytest.mark.parametrize("fuse", (1, 3, 7))
def test_pad_count_one_per_grid_per_window(fuse):
    codegen.reset_pad_count()
    codegen.reset_traffic_count()
    grids = acoustic.make_fields((6, 7, 8), pml_width=2, device="cpu")
    st.launch(backend=st.hopper(), fuse_steps=fuse)(
        acoustic.acoustic_target_fused)(*grids, 7)
    windows = -(-7 // fuse)
    for g in ("p0", "p1", "vp2", "damp"):
        assert codegen.PAD_COUNT[g] == windows
    assert codegen.PAD_COUNT["total"] == 4 * windows
    assert codegen.TRAFFIC_COUNT["steps"] == 7
    assert codegen.TRAFFIC_COUNT["grid_reads"] == 7 * 4
    assert codegen.TRAFFIC_COUNT["grid_writes"] == 7


def test_ops_stencil_timeloop_matches_xla():
    k = suite.get_kernel("star3d4r")
    grids = jsuite.make_grids("star3d4r", (9, 10, 12), seed=1)
    arrays = {g: np.asarray(x.data) for g, x in grids.items()}

    @jst.target
    def tgt(u, v):
        jst.timeloop(5, swap=("v", "u"))(jsuite.get_kernel("star3d4r"))(u, v)

    jst.launch(backend=jst.xla())(tgt)(grids["u"], grids["v"])
    got = ops.stencil_timeloop(k, {g: torch.tensor(a) for g, a in arrays.items()},
                               5, swap=("v", "u"), template="shift",
                               fuse_steps=2)
    for g in grids:
        np.testing.assert_allclose(got[g].numpy(), np.asarray(grids[g].data),
                                   atol=ATOL, rtol=0)


def test_engine_advances_buffers_in_place():
    grids = suite.make_grids("star2d1r", (8, 8), device="cpu")
    ptrs = {grids["u"].data.data_ptr(), grids["v"].data.data_ptr()}
    st.launch(backend=st.hopper())(
        lambda u, v: st.timeloop(3, swap=("v", "u"))(
            suite.get_kernel("star2d1r"))(u, v))(grids["u"], grids["v"])
    assert {grids["u"].data.data_ptr(), grids["v"].data.data_ptr()} == ptrs


def test_helpers_match_jax_engine():
    from repro.core import timeloop as jtimeloop
    for args in ((None, 10), (3, 10), (20, 10), (4, 0)):
        assert timeloop.normalize_fuse(*args) == jtimeloop.normalize_fuse(*args)
    for args in ((10, 4), (8, 4), (3, 4), (7, 1)):
        assert timeloop.window_parts(*args) == jtimeloop.window_parts(*args)
    k = suite.get_kernel("star2d1r")
    assert timeloop.normalize_swap(k.ir, ("u", "v")) == ("v", "u")
    with pytest.raises(ValueError, match="exactly one output"):
        timeloop.normalize_swap(k.ir, ("u", "u"))
    with pytest.raises(ValueError, match="not a kernel parameter"):
        timeloop.normalize_swap(k.ir, ("v", "w"))
    with pytest.raises(ValueError, match="fuse_steps must be >= 1"):
        timeloop.normalize_fuse(0, 5)
    assert timeloop.backend_time_block(st.hopper()) == 1
