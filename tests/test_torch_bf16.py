"""Port parity in bf16: ``st.map`` and ``st.timeloop`` under
``st.hopper(...)`` on bf16 grids, against the JAX package's bf16 kernels.

The JAX package runs every stencil template in the grid's dtype
(``tests/test_stencil_kernels.py`` ``test_dtypes``); the port takes f32 and
bf16 grids on every template and on ``time_block=k``.  Its kernels and
their plain versions (which these CPU tests run) read bf16 cells, compute
in f32 and round once when they store an output cell; the JAX bodies round
to bf16 at every operation.  Tolerance: atol 1e-1, the JAX package's own
for bf16 (``tests/test_stencil_kernels.py``).  Inputs are made in f32 from
a numpy seed and rounded to bf16 once, so both packages start from the
same bf16 values.  The CUDA kernels themselves are held against these
plain versions on the card (``chip_smoke.py``, ``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dsl as jst  # noqa: E402
from repro.core import lowering as jlowering  # noqa: E402
from repro.core import suite as jsuite  # noqa: E402
from repro.kernels.stencil import ops as jops  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.core import suite  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stencil import codegen  # noqa: E402

ATOL = 1e-1
SHAPE_3D = (12, 16, 20)
TEMPLATES = ("gmem", "shift", "smem", "f4", "unroll", "semi")


def _inputs(name, interior, seed):
    """Every cell of every grid, halos included, standard normal from a
    numpy seed, rounded to bf16: {grid: f32 array of bf16 values}."""
    k = suite.get_kernel(name)
    rng = np.random.default_rng(seed)
    h = k.info.halo
    return {g: torch.tensor(rng.standard_normal(
        tuple(s + 2 * hh for s, hh in zip(interior, h))).astype(np.float32))
        .bfloat16().float().numpy() for g in k.ir.grid_params}


def _grids(arrays, interior, order):
    return {g: st.grid(dtype=st.bf16, shape=interior, order=order,
                       data=torch.tensor(a), device="cpu")
            for g, a in arrays.items()}


@pytest.mark.parametrize("template", TEMPLATES)
def test_map_bf16_matches_jax_kernel(template):
    """One ``st.map`` of ``star3d2r`` on bf16 grids under each template vs
    the JAX package's per-application kernel of the same template in bf16
    (interpret mode)."""
    k, jk = suite.get_kernel("star3d2r"), jsuite.get_kernel("star3d2r")
    arrays = _inputs("star3d2r", SHAPE_3D, seed=0)
    halos = {g: k.info.halo for g in arrays}
    want = jops.stencil_apply(
        jk, {g: jnp.asarray(a, jnp.bfloat16) for g, a in arrays.items()},
        halos=halos, template=template, interpret=True)
    g = _grids(arrays, SHAPE_3D, k.info.order)
    st.launch(backend=st.hopper(template=template))(
        lambda u, v: st.map(e=u.shape)(k)(u, v))(g["u"], g["v"])
    for name in arrays:
        assert g[name].data.dtype == torch.bfloat16
        np.testing.assert_allclose(g[name].data.float().numpy(),
                                   np.asarray(want[name], np.float32),
                                   atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("template,time_block", [
    ("gmem", 1), ("shift", 1), ("semi", 1), ("f4", 2), ("shift", 2),
    ("unroll", 3)], ids=["gmem", "shift", "semi", "f4-k2", "shift-k2",
                         "unroll-k3"])
def test_timeloop_bf16_matches_jax_xla(template, time_block):
    """Four fused steps of ``star3d2r`` on bf16 grids (K1, K2, K5 and K3
    through their plain versions) vs the JAX package's xla window in
    bf16."""
    k = suite.get_kernel("star3d2r")
    arrays = _inputs("star3d2r", SHAPE_3D, seed=1)
    halos = {g: k.info.halo for g in arrays}
    want = jlowering.lower_jax_window(
        jsuite.get_kernel("star3d2r").ir, halos, SHAPE_3D, None, ("v", "u"),
        4)({g: jnp.asarray(a, jnp.bfloat16) for g, a in arrays.items()}, {})
    g = _grids(arrays, SHAPE_3D, k.info.order)
    st.launch(backend=st.hopper(template=template, time_block=time_block))(
        lambda u, v: st.timeloop(4, swap=("v", "u"))(k)(u, v))(g["u"], g["v"])
    for name in arrays:
        assert g[name].data.dtype == torch.bfloat16
        np.testing.assert_allclose(g[name].data.float().numpy(),
                                   np.asarray(want[name], np.float32),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_plain_versions_round_once():
    """The plain versions compute in f32 and round once: a bf16 application
    equals the f32 application on the same values, rounded to bf16."""
    k = suite.get_kernel("star3d2r")
    arrays = _inputs("star3d2r", SHAPE_3D, seed=2)
    out = {}
    for dtype in (st.f32, st.bf16):
        g = {n: st.grid(dtype=dtype, shape=SHAPE_3D, order=k.info.order,
                        data=torch.tensor(a), device="cpu")
             for n, a in arrays.items()}
        st.launch(backend=st.hopper(template="semi"))(
            lambda u, v: st.map(e=u.shape)(k)(u, v))(g["u"], g["v"])
        out[dtype] = g["v"].data
    assert torch.equal(out[st.f32].bfloat16(), out[st.bf16])


@pytest.mark.parametrize("kind", ["fused", "map"])
def test_bf16_sources_are_their_own_builds(kind):
    """The dtype is part of a kernel's source, so of its build key."""
    k = suite.get_kernel("star3d2r")
    halos = {g: k.info.halo for g in k.ir.grid_params}
    plan = (codegen.plan_cuda(k.ir, halos, SHAPE_3D, st.hopper(),
                              swap=("v", "u")) if kind == "fused"
            else codegen.lower_hopper(k.ir, halos, SHAPE_3D, None,
                                      st.hopper(template="f4")))
    f32, bf16 = plan.source(torch.float32), plan.source(torch.bfloat16)
    assert "#define RT_ELEM float\n" in f32
    assert "#define RT_ELEM __nv_bfloat16\n" in bf16
    assert _build.source_hash(f32) != _build.source_hash(bf16)
    assert plan.source() is f32


def test_launch_args_take_bf16_and_refuse_mixed_and_f64():
    k = suite.get_kernel("star2d1r")
    plan = codegen.plan_cuda(k.ir, {"u": (1, 1), "v": (1, 1)}, (8, 8),
                             st.hopper())
    # v is tapped at the center only: its layout buffer has no halo
    bf = {g: torch.zeros(plan.padded_shapes[g], dtype=torch.bfloat16)
          for g in ("u", "v")}
    meta, _ = plan.launch_args(bf, {})
    assert meta[0] == bf["u"].data_ptr()
    with pytest.raises(TypeError, match="one dtype"):
        plan.launch_args({"u": bf["u"], "v": bf["v"].float()}, {})
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        plan.launch_args({g: t.double() for g, t in bf.items()}, {})
    # f4 loads vectors of 4 bf16 cells: 8-byte alignment
    mp = codegen.lower_hopper(k.ir, {"u": (1, 1), "v": (1, 1)}, (8, 8), None,
                              st.hopper(template="f4"))
    flat = torch.zeros(104, dtype=torch.bfloat16)
    v = torch.zeros(10, 10, dtype=torch.bfloat16)
    mp.launch_args({"u": flat[4:].view(10, 10), "v": v}, {})
    with pytest.raises(ValueError, match="8-byte aligned"):
        mp.launch_args({"u": flat[2:102].view(10, 10), "v": v}, {})
