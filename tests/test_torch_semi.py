"""Port parity: the semi-stencil kernel K5 (``st.hopper(template="semi")``)
vs the JAX package's semi Pallas kernel (interpret mode) and its xla
lowering.

K5 is CUDA C++ and runs only on the card (``chip_smoke.py``); on a CPU
tensor its wrapper runs the plain version, which walks the kernel's
chunks and ring slots and adds the terms in the kernel's order.  The
generated scatter and the ring logic of ``csrc/semi_ring.cuh`` are
compiled here with the host ``g++`` and held against the plain version.
These tests prove the linearization, the ring arithmetic and the
generated scatter, not the CUDA kernel.

Tolerance: f32, atol 1e-5 per step (the semi form sums the same terms in
another order than the direct form); 1e-4 of the field's max for the
acoustic time loop, whose leapfrog update carries rounding forward.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import acoustic as jacoustic  # noqa: E402
from repro.core import dsl as jst  # noqa: E402
from repro.core import lowering as jlowering  # noqa: E402
from repro.core import suite as jsuite  # noqa: E402
from repro.kernels.stencil import codegen as jcodegen  # noqa: E402
from repro.kernels.stencil import ops as jops  # noqa: E402
from repro_torch.core import acoustic, analysis, suite  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stencil import codegen  # noqa: E402
from repro_torch.kernels.stencil.semi_step import semi_step, semi_step_plain  # noqa: E402

ATOL = 1e-5


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


# two outputs; the second reads the first's new center value and squares
# a tap: not linear, refused by the semi template
@st.kernel
def _two_out(u: st.grid, a: st.grid, b: st.grid, c: st.f32):
    a.at(0, 0).set(0.5 * (u.at(1, 0) + u.at(-1, 0)) - c * u.at(0, -2))
    b.at(0, 0).set(a.at(0, 0) * 2.0 + b.at(0, 0) - u.at(0, 2) ** 2.0)


@jst.kernel
def _jtwo_out(u: jst.grid, a: jst.grid, b: jst.grid, c: jst.f32):
    a.at(0, 0).set(0.5 * (u.at(1, 0) + u.at(-1, 0)) - c * u.at(0, -2))
    b.at(0, 0).set(a.at(0, 0) * 2.0 + b.at(0, 0) - u.at(0, 2) ** 2.0)


# two independent linear outputs with a different x-reach each
@st.kernel
def _two_lin(u: st.grid, a: st.grid, b: st.grid, c: st.f32):
    a.at(0, 0).set(0.5 * (u.at(1, 0) + u.at(-1, 0)) - c * u.at(0, -2))
    b.at(0, 0).set(b.at(0, 0) * 2.0 - 0.25 * u.at(0, 2) + c * u.at(-2, 1))


@jst.kernel
def _jtwo_lin(u: jst.grid, a: jst.grid, b: jst.grid, c: jst.f32):
    a.at(0, 0).set(0.5 * (u.at(1, 0) + u.at(-1, 0)) - c * u.at(0, -2))
    b.at(0, 0).set(b.at(0, 0) * 2.0 - 0.25 * u.at(0, 2) + c * u.at(-2, 1))


@st.kernel
def _mathy(u: st.grid, v: st.grid, a: st.f32):
    v.at(0, 0, 0).set(exp(-abs(u.at(1, 0, 0))) + a * u.at(0, 0, 1))  # noqa: F821


@jst.kernel
def _jmathy(u: jst.grid, v: jst.grid, a: jst.f32):
    v.at(0, 0, 0).set(exp(-abs(u.at(1, 0, 0))) + a * u.at(0, 0, 1))  # noqa: F821


# linear, but its second statement reads the grid the first one wrote
@st.kernel
def _chained(u: st.grid, a: st.grid, b: st.grid):
    a.at(0, 0).set(0.5 * u.at(1, 0))
    b.at(0, 0).set(a.at(0, 0) + u.at(0, 1))


@jst.kernel
def _jchained(u: jst.grid, a: jst.grid, b: jst.grid):
    a.at(0, 0).set(0.5 * u.at(1, 0))
    b.at(0, 0).set(a.at(0, 0) + u.at(0, 1))


# name → (port kernel, JAX kernel, per-grid halos or None, scalars)
KERNELS = {
    "star3d4r": (suite.get_kernel("star3d4r"), jsuite.get_kernel("star3d4r"),
                 None, {}),
    "star2d4r": (suite.get_kernel("star2d4r"), jsuite.get_kernel("star2d4r"),
                 None, {}),
    "acoustic": (acoustic.acoustic_iso_kernel, jacoustic.acoustic_iso_kernel,
                 None, {"dt": 0.3}),
    "wave": (_wave, _jwave, {"u": (2, 2, 2), "v": (0, 0, 0), "vp": (0, 0, 0)},
             {"dt2": 0.002}),
    "two_lin": (_two_lin, _jtwo_lin, {"u": (2, 2), "a": (0, 0), "b": (0, 0)},
                {"c": 0.25}),
}
# ragged shapes, several chunks (and tiles) of the port's block
CASES = [("star3d4r", (10, 8, 12), (4, 3, 8)),
         ("star2d4r", (23, 37), (5, 16)),
         ("acoustic", (10, 8, 12), (3, 4, 8)),
         ("wave", (12, 10, 20), (5, 2, 16)),
         ("two_lin", (14, 22), (3, 8))]


def _inputs(kernel, interior, halos, seed=0):
    """Random f32 values in every cell; acoustic's coefficient fields in
    their physical ranges (vp2 >= 1, damp >= 0), so that 1 + damp·dt stays
    away from 0 and the values O(1)."""
    rng = np.random.default_rng(seed)
    halos = halos or {g: kernel.info.halo for g in kernel.ir.grid_params}
    arrays = {g: rng.standard_normal(
        tuple(s + 2 * h for s, h in zip(interior, halos[g]))).astype(np.float32)
        for g in kernel.ir.grid_params}
    if "vp2" in arrays:
        arrays["vp2"] = np.abs(arrays["vp2"]) + 1.0
        arrays["damp"] = 0.2 * np.abs(arrays["damp"])
    return arrays, halos


def _semi_step(kernel, arrays, halos, interior, scal, block):
    """One step through the semi plan's layout and K5's wrapper (on CPU
    tensors: the plain version)."""
    plan = codegen.plan_cuda(kernel.ir, halos, interior,
                             st.hopper(template="semi", block=block))
    assert plan.kind == "semi"
    tarr = {g: torch.tensor(a) for g, a in arrays.items()}
    padded = plan.to_padded(tarr)
    plan.step(padded, {n: float(np.float32(v)) for n, v in scal.items()})
    return plan.from_padded(padded, tarr)


@pytest.mark.parametrize("name,interior,block", CASES)
def test_semi_matches_pallas_interpret(name, interior, block):
    k, jk, halos, scal = KERNELS[name]
    arrays, halos = _inputs(k, interior, halos, seed=3)
    want = jops.stencil_apply(jk, {g: jnp.asarray(a) for g, a in arrays.items()},
                              scal, halos=halos, template="semi",
                              interpret=True)
    got = _semi_step(k, arrays, halos, interior, scal, block)
    for g in k.ir.output_grids():
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want[g]),
                                   atol=ATOL, rtol=0, err_msg=f"{name}/{g}")


@pytest.mark.parametrize("name,interior,block", CASES)
def test_semi_matches_xla_step(name, interior, block):
    k, jk, halos, scal = KERNELS[name]
    arrays, halos = _inputs(k, interior, halos, seed=4)
    want = jlowering.lower_jax_window(jk.ir, halos, interior, None, None, 1)(
        {g: jnp.asarray(a) for g, a in arrays.items()},
        {n: jnp.float32(v) for n, v in scal.items()})
    got = _semi_step(k, arrays, halos, interior, scal, block)
    for g in k.ir.grid_params:
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want[g]),
                                   atol=ATOL, rtol=0, err_msg=f"{name}/{g}")


@pytest.mark.parametrize("port,jax_kernel,halos", [
    (_mathy, _jmathy, {"u": (1, 1, 1), "v": (0, 0, 0)}),
    (_two_out, _jtwo_out, {"u": (1, 2), "a": (0, 0), "b": (0, 0)}),
    (_chained, _jchained, {"u": (1, 1), "a": (0, 0), "b": (0, 0)}),
], ids=["mathy", "two_out", "chained"])
def test_semi_rejects_what_jax_rejects(port, jax_kernel, halos):
    with pytest.raises(ValueError) as want:
        jcodegen._semi_linearize(jax_kernel.ir)
    interior = (6,) * port.ir.ndim
    with pytest.raises(ValueError) as got:
        codegen.plan_cuda(port.ir, halos, interior, st.hopper(template="semi"))
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    # K3 under the semi template refuses the same kernels
    if port is _mathy:
        with pytest.raises(analysis.NotLinearError):
            codegen.plan_cuda(port.ir, {"u": (1, 1, 1), "v": (1, 1, 1)},
                              interior,
                              st.hopper(template="semi", time_block=2),
                              swap=("v", "u"))


def test_semi_linearize_matches_jax():
    for name in ("star3d4r", "acoustic", "wave", "two_lin"):
        k, jk = KERNELS[name][:2]
        lin, H = codegen.semi_linearize(k.ir)
        jlin, jH = jcodegen._semi_linearize(jk.ir)
        assert H == jH
        assert {g: ([(t[0], t[1]) for t in terms], str(c))
                for g, (terms, c) in lin.items()} == \
            {g: ([(t[0], t[1]) for t in terms], str(c))
             for g, (terms, c) in jlin.items()}


@pytest.mark.parametrize("fuse", (1, 3, 7), ids=("fuse1", "fuse3", "fuse7"))
def test_semi_acoustic_timeloop_matches_xla(fuse):
    p_t, _ = acoustic.run(shape=(12, 14, 16), iters=7, pml_width=3,
                          fuse_steps=fuse, device="cpu",
                          backend=st.hopper(template="semi", block=(5, 4, 8)))
    p_j, _ = jacoustic.run(shape=(12, 14, 16), iters=7, pml_width=3,
                           fuse_steps=fuse, backend=jst.xla())
    want = np.asarray(p_j.data)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(p_t.data.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)


def test_semi_star3d4r_timeloop_matches_xla():
    grids = jsuite.make_grids("star3d4r", (9, 10, 12), seed=2)
    arrays = {g: np.asarray(x.data) for g, x in grids.items()}
    jst.launch(backend=jst.xla())(
        lambda u, v: jst.timeloop(6, swap=("v", "u"))(
            jsuite.get_kernel("star3d4r"))(u, v))(grids["u"], grids["v"])
    tg = {g: st.grid(shape=(9, 10, 12), order=4, data=torch.tensor(a))
          for g, a in arrays.items()}
    st.launch(backend=st.hopper(template="semi", block=(4, 4, 8)))(
        lambda u, v: st.timeloop(6, swap=("v", "u"), fuse_steps=4)(
            suite.get_kernel("star3d4r"))(u, v))(tg["u"], tg["v"])
    for g in tg:
        np.testing.assert_allclose(tg[g].data.numpy(), np.asarray(grids[g].data),
                                   atol=ATOL, rtol=0, err_msg=g)


def test_semi_coefficient_groups():
    """Each term's coefficient splits into a number κ and a residual φ; the
    terms of an output group by φ.  Acoustic ISO: one group, φ =
    vp2·dt·dt / (1 + damp·dt), κ the Laplacian's weights; star3d4r: one
    group of numbers; a kernel with a scalar coefficient: two."""
    from repro_torch.core import ir
    from repro_torch.kernels.stencil import emit
    lin, _ = codegen.semi_linearize(acoustic.acoustic_iso_kernel.ir)
    [(phis, by_d)] = emit.semi_plan(lin, ["p0"])
    assert len(phis) == 1
    assert str(phis[0]) == str(ir.BinOp(
        "/", ir.BinOp("*", ir.BinOp("*", ir.Tap("vp2", (0, 0, 0)),
                                    ir.ScalarRef("dt")), ir.ScalarRef("dt")),
        ir.BinOp("+", ir.Const(1.0), ir.BinOp("*", ir.Tap("damp", (0, 0, 0)),
                                              ir.ScalarRef("dt")))))
    kappas = sorted({round(t[3], 7) for terms in by_d.values() for t in terms})
    assert kappas == [-0.2, -0.0017857, 0.0253968, 1.6]
    assert sum(len(t) for t in by_d.values()) == 24
    assert all(t[2] == 0 for terms in by_d.values() for t in terms)
    # the generated finish evaluates the residual once, from fields read once
    src = codegen.plan_cuda(acoustic.acoustic_iso_kernel.ir,
                            {g: (4, 4, 4) for g in ("p0", "p1", "vp2", "damp")},
                            (16, 16, 16), st.hopper(template="semi"),
                            swap=("p0", "p1")).source()
    assert "#define RT_NGR 1" in src
    scatter, finish = src.split("inline float semi_finish")
    assert " / " not in scatter.split("inline void semi_scatter")[1]
    # (each of the finish's operations rounded by itself: rt_fdiv)
    assert finish.count("rd.template cf<") == 4 and finish.count("rt_fdiv(") == 2
    lin, _ = codegen.semi_linearize(suite.get_kernel("star3d4r").ir)
    [(phis, by_d)] = emit.semi_plan(lin, ["v"])
    assert phis == [None] and sum(len(t) for t in by_d.values()) == 24
    lin, _ = codegen.semi_linearize(KERNELS["two_lin"][0].ir)
    plan = emit.semi_plan(lin, ["a", "b"])
    assert [[None if p is None else str(p) for p in phis] for phis, _ in plan] == \
        [[None, str(ir.ScalarRef("c"))], [None, str(ir.ScalarRef("c"))]]


@pytest.mark.parametrize("coef,want", [
    ("3.0", (3.0, None)),
    ("-(2.0 * s)", (-2.0, "s")),
    ("(s * 4.0) / 2.0", (2.0, "s")),
    ("2.0 / s", (2.0, "1.0 / s")),
    ("s + 1.0", (1.0, "s + 1.0")),
    ("s / 0.0", (1.0, "s / 0.0")),
])
def test_split_coefficient(coef, want):
    from repro_torch.core import ir
    from repro_torch.kernels.stencil import emit
    e = {"3.0": ir.Const(3.0),
         "-(2.0 * s)": ir.Neg(ir.BinOp("*", ir.Const(2.0), ir.ScalarRef("s"))),
         "(s * 4.0) / 2.0": ir.BinOp("/", ir.BinOp("*", ir.ScalarRef("s"),
                                                   ir.Const(4.0)), ir.Const(2.0)),
         "2.0 / s": ir.BinOp("/", ir.Const(2.0), ir.ScalarRef("s")),
         "s + 1.0": ir.BinOp("+", ir.ScalarRef("s"), ir.Const(1.0)),
         "s / 0.0": ir.BinOp("/", ir.ScalarRef("s"), ir.Const(0.0))}[coef]
    kappa, phi = emit.split_coefficient(e)
    residual = {None: None, "s": ir.ScalarRef("s"),
                "1.0 / s": ir.BinOp("/", ir.Const(1.0), ir.ScalarRef("s")),
                "s + 1.0": e, "s / 0.0": e}[want[1]]
    assert (kappa, phi) == (want[0], residual)


def test_semi_plan_geometry():
    k = acoustic.acoustic_iso_kernel
    halos = {g: (4, 4, 4) for g in k.ir.grid_params}
    plan = codegen.plan_cuda(k.ir, halos, (64, 64, 64),
                             st.hopper(template="semi"), swap=("p0", "p1"))
    # a 16×32 tile: with f32 grids a thread walks two columns along y
    assert (plan.kind, plan.H, plan.B) == ("semi", 4, (64, 16, 32))
    # a ring of three staged 24×40 planes of p1 (f32)
    assert plan.smem_bytes == 3 * 4 * 24 * 40
    # p1's planes [x0 - 4, x1 + 4) with its 4-cell y/z halo (one chunk, 4
    # tiles of 16 rows, 2 of 32 columns), the four coefficient fields read
    # once a point, one write
    n = 64 ** 3
    assert plan.hbm_bytes_per_step() == 4 * (72 * (64 + 4 * 8) * (64 + 2 * 8)
                                             + 4 * n + n)


def test_semi_wrapper_refuses_other_devices():
    k = suite.get_kernel("star2d1r")
    plan = codegen.plan_cuda(k.ir, {"u": (1, 1), "v": (1, 1)}, (8, 8),
                             st.hopper(template="semi"))
    meta = {g: torch.empty(10, 10, device="meta") for g in ("u", "v")}
    with pytest.raises(ValueError, match="unsupported device"):
        semi_step(plan, meta, {})
    before = semi_step.launches
    semi_step(plan, {g: torch.zeros(10, 10) for g in ("u", "v")}, {})
    assert semi_step.launches == before        # the plain version: no launch


_HARNESS = r"""
#include <cmath>
%s
#define __forceinline__ inline
#include "semi_ring.cuh"
// reads the layout buffers directly: tap<G> at input plane xin, cf<G> at
// output plane xin - d
struct HostSemiReader {
  float* const* g; const long long* sx; const long long* sy; const long long* org;
  int xin; long long y, z;
  template <int G> float tap(int dy, int dz) const {
    return g[G][org[G] + xin * sx[G] + (y + dy) * sy[G] + z + dz];
  }
  template <int G> float cf(int d) const {
    return g[G][org[G] + (xin - d) * sx[G] + y * sy[G] + z];
  }
};
// every column walks its chunks as one thread of the kernel does
extern "C" void host_semi(const long long* m, const float* s) {
  float* g[RT_NG]; long long sx[RT_NG], sy[RT_NG], org[RT_NG];
  for (int i = 0; i < RT_NG; ++i) {
    g[i] = reinterpret_cast<float*>(m[i]); sx[i] = m[RT_NG + i];
    sy[i] = m[2 * RT_NG + i]; org[i] = m[3 * RT_NG + i];
  }
  const int R0 = m[4 * RT_NG], R1 = m[4 * RT_NG + 1], R2 = m[4 * RT_NG + 2];
  for (int x0 = 0; x0 < R0; x0 += RT_TB0) {
    const int x1 = x0 + RT_TB0 < R0 ? x0 + RT_TB0 : R0;
    for (long long y = 0; y < R1; ++y)
      for (long long z = 0; z < R2; ++z) {
        SemiAcc acc = {};
        for (int i = 0; i < x1 - x0 + 2 * RT_H; ++i) {
          const HostSemiReader rd{g, sx, sy, org, x0 - RT_H + i, y, z};
          float out[RT_NO];
          if (semi_plane(rd, s, acc, i %% RT_NR, x0, x1, out))
            for (int o = 0; o < RT_NO; ++o) {
              const int q = out_grid(o);
              g[q][org[q] + (rd.xin - RT_H) * sx[q] + y * sy[q] + z] = out[o];
            }
        }
      }
  }
}
"""


@pytest.mark.parametrize("name,interior,block", CASES)
def test_emitted_semi_scatter_compiles_and_matches(name, interior, block,
                                                   tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    k, _, halos, scal = KERNELS[name]
    arrays, halos = _inputs(k, interior, halos, seed=9)
    plan = codegen.plan_cuda(k.ir, halos, interior,
                             st.hopper(template="semi", block=block))
    header = plan.source().rsplit("#include", 1)[0]
    cpp = tmp_path / "harness.cpp"
    cpp.write_text(_HARNESS % header)
    so = tmp_path / "libharness.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-D__host__=", "-D__device__=", "-I", str(_build.STENCIL_CSRC),
                    "-o", str(so), str(cpp)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.host_semi.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.host_semi.restype = None

    scal32 = {n: float(np.float32(v)) for n, v in scal.items()}
    ref = plan.to_padded({g: torch.tensor(a) for g, a in arrays.items()})
    semi_step_plain(plan, ref, scal32)
    pad = plan.to_padded({g: torch.tensor(a) for g, a in arrays.items()})
    meta, sc = plan.launch_args(pad, scal32)
    lib.host_semi(ctypes.addressof(meta), ctypes.addressof(sc))
    for g in plan.out_grids:
        np.testing.assert_allclose(pad[g].numpy(), ref[g].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=g)
