"""Port parity: ``st.map`` on the hopper backend — K4 (templates gmem, f4,
smem), K4's streaming build of K2 (shift/unroll) and K5's per-application
call (semi) — vs the JAX package's per-application Pallas kernels
(``ops.stencil_apply(..., interpret=True)``), its oracle
(``ref.reference_apply``) and its ``st.map``.

The kernels are CUDA C++ and run only on the card (``chip_smoke.py``,
``tests/test_torch_gpu.py``).  On CPU tensors ``MapPlan.apply`` runs their
plain versions, which walk the kernels' geometry: chunks of ``b0`` planes,
f4's groups of 4 points with the float4 windows aligned down from each
tap row's first cell, smem's staged tile, the plane rings of K2 and K5,
and the destination buffers of a kernel that reads an output grid
off-center.  The f4 rows (``csrc/f4_rows.cuh``) and the emitted f4 point
function are compiled here with the host ``g++`` and held against the
plain version.  These tests prove the geometry and the index math, not
the CUDA code.

Tolerance: f32, atol 1e-5 as ``tests/test_stencil_kernels.py``: the same
expression tree in another summation order and contraction.
"""
import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import acoustic as jacoustic  # noqa: E402
from repro.core import dsl as jst  # noqa: E402
from repro.core import suite as jsuite  # noqa: E402
from repro.kernels.stencil import codegen as jcodegen  # noqa: E402
from repro.kernels.stencil import ops as jops  # noqa: E402
from repro.kernels.stencil import ref as jref  # noqa: E402
from repro_torch.core import acoustic, regions, suite  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stencil import codegen, emit, ops  # noqa: E402
from repro_torch.kernels.stencil.map_step import map_step, map_step_plain  # noqa: E402

ATOL = 1e-5
SHAPE_2D = (24, 40)
SHAPE_3D = (12, 16, 20)
TEMPLATES = ("gmem", "smem", "f4", "shift", "unroll", "semi")


# ---- kernels beyond the suite (the same source for both frontends) -----------
@st.kernel
def _wave(u: st.grid, v: st.grid, vp: st.grid, dt2: st.f32):
    lap = (-2.847 * u.at(0, 0, 0)
           + 1.6 * (u.at(-1, 0, 0) + u.at(1, 0, 0) + u.at(0, -1, 0)
                    + u.at(0, 1, 0) + u.at(0, 0, -1) + u.at(0, 0, 1))
           - 0.2 * (u.at(-2, 0, 0) + u.at(2, 0, 0) + u.at(0, -2, 0)
                    + u.at(0, 2, 0) + u.at(0, 0, -2) + u.at(0, 0, 2)))
    v.at(0, 0, 0).set(2.0 * u.at(0, 0, 0) - v.at(0, 0, 0)
                      + dt2 * vp.at(0, 0, 0) * lap)


@jst.kernel
def _jwave(u: jst.grid, v: jst.grid, vp: jst.grid, dt2: jst.f32):
    lap = (-2.847 * u.at(0, 0, 0)
           + 1.6 * (u.at(-1, 0, 0) + u.at(1, 0, 0) + u.at(0, -1, 0)
                    + u.at(0, 1, 0) + u.at(0, 0, -1) + u.at(0, 0, 1))
           - 0.2 * (u.at(-2, 0, 0) + u.at(2, 0, 0) + u.at(0, -2, 0)
                    + u.at(0, 2, 0) + u.at(0, 0, -2) + u.at(0, 0, 2)))
    v.at(0, 0, 0).set(2.0 * u.at(0, 0, 0) - v.at(0, 0, 0)
                      + dt2 * vp.at(0, 0, 0) * lap)


# a Jacobi sweep: reads the grid it writes off-center (legal for st.map,
# whose taps read old values)
@st.kernel
def _jacobi(u: st.grid, f: st.grid):
    u.at(0, 0).set(0.25 * (u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1))
                   - 0.5 * f.at(0, 0))


@jst.kernel
def _jjacobi(u: jst.grid, f: jst.grid):
    u.at(0, 0).set(0.25 * (u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1))
                   - 0.5 * f.at(0, 0))


# two outputs; the second reads the first's new center value (not linear:
# no semi)
@st.kernel
def _two_out(u: st.grid, a: st.grid, b: st.grid, c: st.f32):
    a.at(0, 0).set(0.5 * (u.at(1, 0) + u.at(-1, 0)) - c * u.at(0, -2))
    b.at(0, 0).set(a.at(0, 0) * 2.0 + b.at(0, 0) - u.at(0, 2) ** 2.0)


@jst.kernel
def _jtwo_out(u: jst.grid, a: jst.grid, b: jst.grid, c: jst.f32):
    a.at(0, 0).set(0.5 * (u.at(1, 0) + u.at(-1, 0)) - c * u.at(0, -2))
    b.at(0, 0).set(a.at(0, 0) * 2.0 + b.at(0, 0) - u.at(0, 2) ** 2.0)


# name → (port kernel, JAX kernel, per-grid halos or None, scalars)
EXTRA = {
    "wave": (_wave, _jwave, {"u": (2, 2, 2), "v": (0, 0, 0), "vp": (0, 0, 0)},
             {"dt2": 0.002}),
    "jacobi": (_jacobi, _jjacobi, {"u": (1, 1), "f": (0, 0)}, {}),
    "two_out": (_two_out, _jtwo_out, {"u": (1, 2), "a": (0, 0), "b": (0, 0)},
                {"c": 0.25}),
}


def _kernels(name):
    if name in EXTRA:
        return EXTRA[name]
    return suite.get_kernel(name), jsuite.get_kernel(name), None, {}


def _inputs(kernel, interior, halos=None, seed=0):
    """Random f32 values in every cell, halos included."""
    rng = np.random.default_rng(seed)
    halos = halos or {g: kernel.info.halo for g in kernel.ir.grid_params}
    arrays = {g: rng.standard_normal(
        tuple(s + 2 * h for s, h in zip(interior, halos[g]))).astype(np.float32)
        for g in kernel.ir.grid_params}
    return arrays, halos


def _port(kernel, arrays, halos, scal, template, **kw):
    """``ops.stencil_apply`` on CPU tensors (the plain versions)."""
    out = ops.stencil_apply(kernel, {g: torch.tensor(a) for g, a in arrays.items()},
                            scal, halos=halos, template=template, **kw)
    return {g: t.numpy() for g, t in out.items()}


def _jax(jk, arrays, halos, scal, template=None, region=None, **kw):
    """The JAX package's per-application kernel in interpret mode, or with
    ``template=None`` its oracle."""
    ja = {g: jnp.asarray(a) for g, a in arrays.items()}
    if template is None:
        g0 = jk.ir.grid_params[0]
        interior = tuple(s - 2 * h for s, h in zip(arrays[g0].shape, halos[g0]))
        out = jref.reference_apply(jk.ir, halos, interior, ja,
                                   {n: jnp.float32(v) for n, v in scal.items()},
                                   region=region)
    else:
        out = jops.stencil_apply(jk, ja, scal, halos=halos, template=template,
                                 region=region, interpret=True, **kw)
    return {g: np.asarray(x) for g, x in out.items()}


def _close(got, want, grids, what):
    for g in grids:
        np.testing.assert_allclose(got[g], want[g], atol=ATOL, rtol=0,
                                   err_msg=f"{what}/{g}")


# ---- the plain versions against the JAX package ----------------------------------
@pytest.mark.parametrize("name", ("star2d4r", "star3d4r", "box2d2r", "box3d2r"))
@pytest.mark.parametrize("template", TEMPLATES)
def test_every_template_matches_pallas_interpret(name, template):
    k, jk, halos, scal = _kernels(name)
    interior = SHAPE_2D if k.ir.ndim == 2 else SHAPE_3D
    arrays, halos = _inputs(k, interior, halos)
    got = _port(k, arrays, halos, scal, template)
    # every grid: the outputs' halos and the inputs stay as they were
    _close(got, _jax(jk, arrays, halos, scal, template), k.ir.grid_params,
           f"{name}/{template}")


@pytest.mark.parametrize("name", suite.KERNEL_NAMES)
@pytest.mark.parametrize("template", ("gmem", "semi"))
def test_suite_kernels_match_reference(name, template):
    """Every suite kernel against the JAX oracle (which the JAX package's
    own tests hold its interpret-mode kernels against)."""
    k, jk, halos, scal = _kernels(name)
    interior = SHAPE_2D if k.ir.ndim == 2 else SHAPE_3D
    arrays, halos = _inputs(k, interior, halos, seed=1)
    _close(_port(k, arrays, halos, scal, template),
           _jax(jk, arrays, halos, scal), k.ir.grid_params, f"{name}/{template}")


@functools.lru_cache(maxsize=None)
def _jax_mem_type(mem_type):
    k, jk, halos, scal = _kernels("box3d1r")
    arrays, halos = _inputs(k, SHAPE_3D, halos, seed=2)
    return arrays, halos, _jax(jk, arrays, halos, scal, "shift",
                               mem_type=mem_type)


@pytest.mark.parametrize("mem_type", ("registers", "vmem"))
@pytest.mark.parametrize("template", ("shift", "gmem"))
def test_mem_types(mem_type, template):
    """Both values of the knob run (the same kernels on Hopper), against
    the JAX package's streaming body under the same value."""
    k = suite.get_kernel("box3d1r")
    arrays, halos, want = _jax_mem_type(mem_type)
    got = _port(k, arrays, halos, {}, template, mem_type=mem_type)
    _close(got, want, k.ir.grid_params, f"{template}/{mem_type}")


@pytest.mark.parametrize("name,interior,region", [
    ("star2d2r", SHAPE_2D, ((4, 20), (8, 32))),
    ("star3d1r", SHAPE_3D, ((0, 3), (0, 16), (0, 20))),     # a thin PML face
    ("star3d2r", SHAPE_3D, ((2, 9), (3, 13), (5, 18))),     # z-start 5
    ("box2d2r", SHAPE_2D, ((0, 24), (33, 40))),             # the far z face
])
def test_sub_regions(name, interior, region):
    """A region's taps read the real neighbouring cells; every cell outside
    it keeps its value, on every template."""
    k, jk, halos, scal = _kernels(name)
    arrays, halos = _inputs(k, interior, halos, seed=3)
    want = _jax(jk, arrays, halos, scal, "gmem", region=region)
    _close(want, _jax(jk, arrays, halos, scal, region=region),
           k.ir.grid_params, "JAX interpret vs oracle")
    for template in TEMPLATES:
        got = _port(k, arrays, halos, scal, template, region=region)
        _close(got, want, k.ir.grid_params, f"{name}/{template}")


@pytest.mark.parametrize("template", TEMPLATES)
def test_multistatement_scalar_kernel(template):
    """Acoustic's pattern: one grid tapped off-center with its own halo,
    the output and a coefficient grid with none, a scalar."""
    k, jk, halos, scal = EXTRA["wave"]
    arrays, halos = _inputs(k, (12, 10, 24), halos, seed=4)
    got = _port(k, arrays, halos, scal, template)
    _close(got, _jax(jk, arrays, halos, scal), k.ir.grid_params, template)
    if template in ("gmem", "shift"):
        _close(got, _jax(jk, arrays, halos, scal, template), ("v",), template)


@pytest.mark.parametrize("region", (None, ((3, 17), (5, 38))), ids=("whole", "region"))
@pytest.mark.parametrize("template", TEMPLATES)
def test_output_read_off_center(template, region):
    """A Jacobi sweep reads the grid it writes off-center: the plan writes
    into a destination buffer and copies the region back."""
    k, jk, halos, scal = EXTRA["jacobi"]
    arrays, halos = _inputs(k, SHAPE_2D, halos, seed=5)
    plan = codegen.lower_hopper(k.ir, halos, SHAPE_2D, region,
                                st.hopper(template=template))
    assert not plan.in_place
    got = _port(k, arrays, halos, scal, template, region=region)
    _close(got, _jax(jk, arrays, halos, scal, region=region), ("u", "f"),
           template)
    if template == "gmem":
        _close(got, _jax(jk, arrays, halos, scal, "gmem", region=region),
               ("u",), template)


@pytest.mark.parametrize("template", ("gmem", "smem", "f4", "shift", "unroll"))
def test_second_output_reads_first(template):
    k, jk, halos, scal = EXTRA["two_out"]
    arrays, halos = _inputs(k, (14, 22), halos, seed=6)
    plan = codegen.lower_hopper(k.ir, halos, (14, 22), None,
                                st.hopper(template=template))
    assert plan.in_place
    _close(_port(k, arrays, halos, scal, template),
           _jax(jk, arrays, halos, scal), k.ir.grid_params, template)


# ---- st.map --------------------------------------------------------------------
@pytest.mark.parametrize("template", TEMPLATES)
def test_map_iterated_swap_matches_pallas(template):
    """Five ``st.map`` applications with the ``.data`` swap, under hopper on
    CPU grids and under the JAX package's pallas backend."""
    k, jk = suite.get_kernel("star2d1r"), jsuite.get_kernel("star2d1r")
    u0 = np.random.default_rng(7).standard_normal((18, 18)).astype(np.float32)

    def loop(sd, u, v, kern):
        for _ in range(5):
            sd.map(e=u.shape)(kern)(u, v)
            (u.data, v.data) = (v.data, u.data)
        return u

    u = st.grid(shape=(16, 16), order=1, data=torch.tensor(u0))
    v = st.grid(shape=(16, 16), order=1, device="cpu")
    got = st.launch(backend=st.hopper(template=template))(
        lambda u, v: loop(st, u, v, k))(u, v)
    ju = jst.grid(shape=(16, 16), order=1, data=jnp.asarray(u0))
    jv = jst.grid(shape=(16, 16), order=1)
    want = jst.launch(backend=jst.pallas(template=template))(
        lambda u, v: loop(jst, u, v, jk))(ju, jv)
    np.testing.assert_allclose(got.value.data.numpy(), np.asarray(want.value.data),
                               atol=ATOL, rtol=0)
    assert set(got.profile) >= {"codegen", "kernel", "total"}


@st.kernel
def _listing1(u: st.grid, v: st.grid):
    v.at(0, 0).set(0.25005 * u.at(0, 0)
                   + 0.11111 * (u.at(-4, 0) + u.at(4, 0))
                   + 0.06251 * (u.at(-3, 0) + u.at(3, 0))
                   + 0.06255 * (u.at(-2, 0) + u.at(2, 0))
                   + 0.06245 * (u.at(-1, 0) + u.at(1, 0))
                   + 0.06248 * (u.at(0, -1) + u.at(0, 1))
                   + 0.06243 * (u.at(0, -2) + u.at(0, 2))
                   + 0.06253 * (u.at(0, -3) + u.at(0, 3))
                   - 0.22220 * (u.at(0, -4) + u.at(0, 4)))


@jst.kernel
def _jlisting1(u: jst.grid, v: jst.grid):
    v.at(0, 0).set(0.25005 * u.at(0, 0)
                   + 0.11111 * (u.at(-4, 0) + u.at(4, 0))
                   + 0.06251 * (u.at(-3, 0) + u.at(3, 0))
                   + 0.06255 * (u.at(-2, 0) + u.at(2, 0))
                   + 0.06245 * (u.at(-1, 0) + u.at(1, 0))
                   + 0.06248 * (u.at(0, -1) + u.at(0, 1))
                   + 0.06243 * (u.at(0, -2) + u.at(0, 2))
                   + 0.06253 * (u.at(0, -3) + u.at(0, 3))
                   - 0.22220 * (u.at(0, -4) + u.at(0, 4)))


def test_listing1_loop():
    """Paper Listing 1 (``examples/quickstart.py``) at 32×48: ``st.map``
    under ``st.cuda(computeCapability="9.0", threadsPerBlock=(8, 128))``,
    the same call on both packages."""
    def loop(sd, kern, u, v, iters):
        for _ in range(iters):
            sd.map(e=u.shape)(kern)(u, v)
            (u.data, v.data) = (v.data, u.data)

    be = dict(computeCapability="9.0", threadsPerBlock=(8, 128), template="gmem")
    u = st.grid(dtype=st.f32, shape=(32, 48), order=4, device="cpu").randomize(0)
    v = st.grid(dtype=st.f32, shape=(32, 48), order=4, device="cpu")
    st.launch(backend=st.cuda(**be))(
        lambda u, v: loop(st, _listing1, u, v, 4))(u, v)
    ju = jst.grid(dtype=jst.f32, shape=(32, 48), order=4).randomize(0)
    jv = jst.grid(dtype=jst.f32, shape=(32, 48), order=4)
    jst.launch(backend=jst.cuda(**be))(
        lambda u, v: loop(jst, _jlisting1, u, v, 4))(ju, jv)
    want = np.asarray(ju.interior)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(u.interior.numpy() - want).max()) / scale < ATOL


@functools.lru_cache(maxsize=None)
def _jax_acoustic():
    p, _ = jacoustic.run(shape=(12, 16, 24), iters=6, pml_width=3,
                         backend=jst.xla())
    return np.asarray(p.data)


@pytest.mark.parametrize("template", TEMPLATES)
def test_acoustic_per_step_matches_xla(template):
    """``acoustic.run`` without ``fuse_steps``: one ``st.map`` a step, the
    source injected every step (the paper's host-side loop)."""
    p, prof = acoustic.run(shape=(12, 16, 24), iters=6, pml_width=3,
                           backend=st.hopper(template=template), device="cpu")
    want = _jax_acoustic()
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(p.data.numpy(), want, atol=ATOL, rtol=0)
    assert 0 < prof["kernel"] <= prof["loop"]


@pytest.mark.parametrize("template", ("gmem", "f4", "smem", "shift", "semi"))
def test_seven_regions_match_whole(template):
    """``regions.seven_region``: seven ``st.map(begin, end)`` calls equal
    one whole-interior ``st.map``."""
    k = suite.get_kernel("star3d2r")
    shape = (12, 14, 18)
    init = suite.make_grids("star3d2r", shape, seed=8, device="cpu")
    init["v"].data.normal_(generator=torch.Generator().manual_seed(9))
    be = st.hopper(template=template)
    whole = {g: x.copy() for g, x in init.items()}
    st.launch(backend=be)(lambda u, v: st.map(e=u.shape)(k)(u, v))(
        whole["u"], whole["v"])
    parts = {g: x.copy() for g, x in init.items()}
    boxes = regions.seven_region(shape, 3)
    assert len(boxes) == 7

    def seven(u, v):
        for r in boxes:
            st.map(begin=[b for b, _ in r], end=[e for _, e in r])(k)(u, v)
    st.launch(backend=be)(seven)(parts["u"], parts["v"])
    for g in ("u", "v"):
        np.testing.assert_allclose(parts[g].data.numpy(), whole[g].data.numpy(),
                                   atol=ATOL, rtol=0, err_msg=g)


# ---- validation -----------------------------------------------------------------
def test_too_small_halo_at_region_raises_like_jax():
    k, jk = suite.get_kernel("star2d2r"), jsuite.get_kernel("star2d2r")
    halos = {"u": (1, 2), "v": (1, 2)}
    region = ((0, 6), (0, 8))
    arrays, _ = _inputs(k, (8, 8), halos)
    with pytest.raises(ValueError) as want:
        jcodegen.lower_pallas(jk.ir, halos, (8, 8), region,
                              jst.pallas(interpret=True))(
            {g: jnp.asarray(a) for g, a in arrays.items()}, {})
    with pytest.raises(ValueError) as got:
        codegen.lower_hopper(k.ir, halos, (8, 8), region, st.hopper())
    assert str(got.value) == str(want.value)
    # at the far side as well (where a tap would leave the tensor)
    with pytest.raises(ValueError, match="too small"):
        codegen.lower_hopper(k.ir, halos, (8, 8), ((2, 8), (0, 8)), st.hopper())


@pytest.mark.parametrize("make,err,match", [
    (lambda: codegen.lower_hopper(
        suite.get_kernel("star3d1r").ir, {"u": (1,) * 3, "v": (1,) * 3},
        (8, 8, 8), None, st.hopper(time_block=2)),
     ValueError, "time_block > 1"),
    (lambda: codegen.lower_hopper(
        suite.get_kernel("star3d1r").ir, {"u": (1,) * 3, "v": (1,) * 3},
        (8, 8, 8), None, st.hopper(template="f4", block=(4, 8, 30))),
     ValueError, "multiple of 4"),
    (lambda: codegen.lower_hopper(
        suite.get_kernel("box3d4r").ir, {"u": (4,) * 3, "v": (4,) * 3},
        (64, 64, 64), None, st.hopper(template="smem", block=(32, 16, 64))),
     ValueError, "shared memory"),
    (lambda: codegen.lower_hopper(
        suite.get_kernel("star2d1r").ir, {"u": (1, 1), "v": (1, 1)},
        (8, 8), ((0, 9), (0, 8)), st.hopper()),
     ValueError, "region"),
    (lambda: codegen.lower_hopper(
        suite.get_kernel("star2d1r").ir, {"u": (1, 1), "v": (1, 1)},
        (8, 8), None, st.hopper(mem_type="hbm")),
     ValueError, "mem_type"),
    (lambda: codegen.lower_hopper(
        suite.get_kernel("star3d1r").ir, {"u": (1,) * 3, "v": (1,) * 3},
        (8, 8, 8), None, st.hopper(block=(1, 64, 32))),
     ValueError, "1 to 1024"),
], ids=["time_block", "f4_b2", "smem", "region", "mem_type", "threads"])
def test_plan_validation(make, err, match):
    with pytest.raises(err, match=match):
        make()


def test_time_block_on_map_raises_like_jax():
    k, jk = suite.get_kernel("star2d1r"), jsuite.get_kernel("star2d1r")
    with pytest.raises(ValueError) as want:
        jcodegen.lower_pallas(jk.ir, {"u": (1, 1), "v": (1, 1)}, (8, 8), None,
                              jst.pallas(time_block=2))
    g = suite.make_grids("star2d1r", shape=(8, 8), device="cpu")
    with pytest.raises(ValueError) as got:
        st.launch(backend=st.hopper(time_block=2))(
            lambda u, v: st.map(e=u.shape)(k)(u, v))(g["u"], g["v"])
    assert str(got.value).split(";")[1] == str(want.value).split(";")[1]


@pytest.mark.parametrize("dtype", (st.bf16, st.f64), ids=("bf16", "f64"))
def test_other_dtypes_raise(dtype):
    """The per-application kernels take f32 and bf16 grids, all of one
    type: bf16 grids run (``tests/test_torch_bf16.py`` holds them against
    the JAX package), a bf16 grid beside an f32 one raises, and so do f64
    grids."""
    k = suite.get_kernel("star2d1r")

    def run(*g):
        st.launch(backend=st.hopper(template="shift"))(
            lambda u, v: st.map(e=u.shape)(k)(u, v))(*g)
    if dtype is st.bf16:
        g = [st.grid(dtype=dtype, shape=(8, 8), order=1,
                     device="cpu").randomize(s) for s in range(2)]
        run(*g)
        assert g[1].data.dtype == torch.bfloat16 and g[1].data.abs().max() > 0
        g[0] = st.grid(dtype=st.f32, shape=(8, 8), order=1, device="cpu")
    else:
        g = [st.grid(dtype=dtype, shape=(8, 8), order=1, device="cpu")
             for _ in range(2)]
    with pytest.raises(TypeError, match="float32"):
        run(*g)


def test_wrapper_refuses_other_devices_and_aliasing_destinations():
    k = EXTRA["jacobi"][0]
    halos = {"u": (1, 1), "f": (0, 0)}
    plan = codegen.lower_hopper(k.ir, halos, (8, 8), None, st.hopper())
    meta = {"u": torch.empty(10, 10, device="meta"),
            "f": torch.empty(8, 8, device="meta")}
    with pytest.raises(ValueError, match="unsupported device"):
        map_step(plan, meta, {}, plan.make_dst(meta))
    bufs = {"u": torch.zeros(10, 10), "f": torch.zeros(8, 8)}
    with pytest.raises(ValueError, match="aliases"):
        plan.launch_args(bufs, {}, {"u": bufs["f"]})
    with pytest.raises(ValueError, match="None exactly"):
        plan.launch_args(bufs, {}, None)
    before = map_step.launches
    map_step(plan, bufs, {}, plan.make_dst(bufs))
    assert map_step.launches == before          # the plain version: no launch


def test_map_plan_geometry():
    k = suite.get_kernel("star3d4r")
    halos = {"u": (4, 4, 4), "v": (4, 4, 4)}
    R = (64, 64, 64)
    gmem = codegen.lower_hopper(k.ir, halos, R, None, st.hopper())
    assert (gmem.kind, gmem.B, gmem.in_place) == ("map", (16, 4, 64), True)
    # the fused plan's model: u read over its reach, v written once
    assert gmem.hbm_bytes_per_step() == 4 * (72 ** 3 + 64 ** 3)
    f4 = codegen.lower_hopper(k.ir, halos, R, None, st.hopper(template="f4"))
    assert f4.B == (16, 8, 128)
    smem = codegen.lower_hopper(k.ir, halos, R, ((1, 40), (0, 64), (3, 64)),
                                st.hopper(template="smem"))
    # two stages of the halo'd (8, 16, 64) tile, rows of 72 cells, with the
    # slack to align the base to 128 bytes and two mbarriers
    assert smem.B == (8, 16, 64)
    assert smem.smem_bytes == 128 + 2 * 4 * 16 * 24 * 72 + 16
    assert smem.org3["u"] == (5, 4, 7)
    assert smem.R3 == (39, 64, 61)
    for t, kind in (("shift", "stream"), ("unroll", "stream"), ("semi", "semi")):
        assert codegen.lower_hopper(k.ir, halos, R, None,
                                    st.hopper(template=t)).kind == kind
    # a destination adds its copy into the grid: one read, one write
    jac = codegen.lower_hopper(_jacobi.ir, {"u": (1, 1), "f": (0, 0)},
                               (16, 16), None, st.hopper())
    n = 16 * 16
    assert jac.hbm_bytes_per_step() == 4 * (18 * 18 + n + n + 2 * n)
    # 2D runs as (R0, 1, R1)
    assert jac.R3 == (16, 1, 16) and jac.org3["u"] == (1, 0, 1)


def test_f4_rows():
    rows = emit.f4_rows(acoustic.acoustic_iso_kernel.ir,
                        ("p0", "p1", "vp2", "damp"), ("p0",))
    assert rows[0] == ("p1", 0, 0, -4, 4)
    assert ("p1", 3, 0, 0, 0) in rows and ("damp", 0, 0, 0, 0) in rows
    assert len(rows) == 1 + 16 + 3
    # a center read of a grid written by an earlier statement makes no row
    two = emit.f4_rows(_two_out.ir, ("u", "a", "b"), ("a", "b"))
    assert [r[0] for r in two] == ["u", "u", "u", "b"]


_HARNESS = r"""
#include <cmath>
#include <cstring>
%s
#define __forceinline__ inline
#include "f4_rows.cuh"
struct HostLoad {
  void operator()(const float* p, float* out) const { std::memcpy(out, p, 16); }
};
// every column of groups of 4 points, in the kernel's chunks of RT_TB0
// planes, as one thread of the f4 kernel walks it through its queues
extern "C" void host_f4(const long long* m, const float* s) {
  float* g[RT_NG]; long long sx[RT_NG], sy[RT_NG], org[RT_NG];
  for (int i = 0; i < RT_NG; ++i) {
    g[i] = reinterpret_cast<float*>(m[i]); sx[i] = m[RT_NG + i];
    sy[i] = m[2 * RT_NG + i]; org[i] = m[3 * RT_NG + i];
  }
  const int R0 = m[4 * RT_NG], R1 = m[4 * RT_NG + 1], R2 = m[4 * RT_NG + 2];
  const long long* d = m + 5 * RT_NG + 5;   // past nb, sc and bs (csrc/common.cuh)
  for (int x0 = 0; x0 < R0; x0 += RT_TB0)
    for (int y = 0; y < R1; ++y)
      for (int z0 = 0; z0 < R2; z0 += 4) {
        const int n = R2 - z0 < 4 ? R2 - z0 : 4;
        const int x1 = x0 + RT_TB0 < R0 ? x0 + RT_TB0 : R0;
        f4_column(g, sx, sy, org, s, x0, x1, y, z0, n, HostLoad{},
                  [&](int x, const float (&out)[4][RT_NO]) {
          for (int j = 0; j < n; ++j)
            for (int o = 0; o < RT_NO; ++o)
              reinterpret_cast<float*>(d[o])[d[3 * RT_NO + o] + x * d[RT_NO + o] +
                                             y * d[2 * RT_NO + o] + z0 + j] = out[j][o];
        });
      }
}
"""


def _slack(a):
    """``a`` as a tensor whose storage runs on past its end: the host's
    float4 loads, like the card's, may read a few bytes beyond it."""
    flat = torch.zeros(a.size + 16)
    t = flat[:a.size].view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t


# (name, interior, region, block, aligned): ``aligned`` says whether every
# grid's pitches are multiples of 4 cells (the plan fixes the rows' places)
# or none's are (the kernel aligns each row at run time); a block with a
# short b0 walks several chunks, each starting its queues anew
F4_HARNESS_CASES = [
    ("star3d4r", (9, 10, 13), ((1, 9), (0, 10), (3, 13)), None, False),
    ("box2d2r", (10, 23), None, None, False),
    ("wave", (7, 8, 11), ((0, 7), (2, 8), (1, 10)), None, False),
    ("two_out", (10, 13), None, None, False),
    ("jacobi", (9, 14), ((2, 9), (1, 13)), None, None),
    ("acoustic", (8, 9, 14), None, None, False),
    ("star3d4r", (9, 8, 12), None, (3, 4, 8), True),
    ("star3d4r", (9, 8, 12), ((1, 9), (0, 8), (3, 12)), (4, 2, 8), True),
    ("box2d2r", (10, 24), ((1, 10), (2, 23)), (3, 16), True),
    ("acoustic", (8, 8, 16), None, (3, 8, 16), True),
    ("acoustic", (11, 9, 14), None, (4, 8, 16), False),
]


@pytest.mark.parametrize("name,interior,region,block,aligned", F4_HARNESS_CASES,
                         ids=[f"{c[0]}-{'aligned' if c[4] else 'runtime' if c[4] is False else 'mixed'}"
                              f"{'-region' if c[2] else ''}{'-chunks' if c[3] else ''}"
                              for c in F4_HARNESS_CASES])
def test_f4_rows_compile_and_match(name, interior, region, block, aligned,
                                   tmp_path):
    """``csrc/f4_rows.cuh`` and the emitted f4 point function compiled with
    ``g++`` walk every column as the kernel's threads do (queues, aligned
    and run-time loads), and match the plain version to 1e-6."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    if name == "acoustic":
        k, halos, scal = acoustic.acoustic_iso_kernel, None, {"dt": 0.3}
    else:
        k, _, halos, scal = _kernels(name)
    arrays, halos = _inputs(k, interior, halos, seed=10)
    if name == "acoustic":
        arrays["vp2"] = np.abs(arrays["vp2"]) + 1.0
    plan = codegen.lower_hopper(k.ir, halos, interior, region,
                                st.hopper(template="f4", block=block))
    paths = {o is not None for o in plan.f4_org_mod4().values()}
    assert paths == ({True, False} if aligned is None else {aligned})
    header = plan.source().rsplit("#include", 1)[0]
    cpp = tmp_path / "harness.cpp"
    cpp.write_text(_HARNESS % header)
    so = tmp_path / "libharness.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-D__host__=", "-D__device__=", "-I", str(_build.STENCIL_CSRC),
                    "-o", str(so), str(cpp)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.host_f4.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.host_f4.restype = None

    scal32 = {n: float(np.float32(v)) for n, v in scal.items()}
    ref = {g: torch.tensor(a) for g, a in arrays.items()}
    rdst = plan.make_dst(ref)
    map_step_plain(plan, ref, scal32, rdst)
    bufs = {g: _slack(a) for g, a in arrays.items()}
    dst = plan.make_dst(bufs)
    meta, sc = plan.launch_args(bufs, scal32, dst)
    lib.host_f4(ctypes.addressof(meta), ctypes.addressof(sc))
    for g in plan.out_grids:
        got, want = ((bufs[g], ref[g]) if dst is None else (dst[g], rdst[g]))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=g)
