"""Port parity: the plain versions of the CUDA kernels K1 (fused step) and
K2 (2.5D streaming), run in the port's layout, vs the JAX package.

K1/K2 themselves are CUDA C++ and run only on the card (``chip_smoke.py``);
on a CPU tensor each wrapper runs its plain version, which repeats the
kernel's geometry: the layout cut (``to_padded``/``from_padded``), the 2D →
3D mapping, and for K2 the chunks along axis 0 and the ring-slot
arithmetic.  These tests prove that geometry and the index math against
the JAX package, not the CUDA code.  The emitted point function is
compiled here with the host ``g++`` and held against the plain version.

Tolerance: f32, atol 1e-5 against the JAX xla lowering and the Pallas
interpret kernels (same expression tree and constant folding, different
fusion/contraction: a few ulp).
"""
import ctypes
import re
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
from repro.kernels.stencil import ops as jops  # noqa: E402
from repro_torch.core import acoustic, suite  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.kernels.stencil import codegen, emit  # noqa: E402
from repro_torch.kernels.stencil.fused_step import fused_step, fused_step_plain  # noqa: E402
from repro_torch.kernels.stencil.stream_step import stream_step  # noqa: E402

ATOL = 1e-5


# ---- kernels beyond the suite ------------------------------------------------
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


# two outputs; the second reads the first's new center value
@st.kernel
def _two_out(u: st.grid, a: st.grid, b: st.grid, c: st.f32):
    a.at(0, 0).set(0.5 * (u.at(1, 0) + u.at(-1, 0)) - c * u.at(0, -2))
    b.at(0, 0).set(a.at(0, 0) * 2.0 + b.at(0, 0) - u.at(0, 2) ** 2.0)


@jst.kernel
def _jtwo_out(u: jst.grid, a: jst.grid, b: jst.grid, c: jst.f32):
    a.at(0, 0).set(0.5 * (u.at(1, 0) + u.at(-1, 0)) - c * u.at(0, -2))
    b.at(0, 0).set(a.at(0, 0) * 2.0 + b.at(0, 0) - u.at(0, 2) ** 2.0)


@st.kernel
def _mathy(u: st.grid, v: st.grid, a: st.f32):
    t = exp(-abs(u.at(1, 0, 0))) + sqrt(abs(u.at(0, -1, 0)) + 1.0)  # noqa: F821
    v.at(0, 0, 0).set(max(t, a) - min(u.at(0, 0, 0), 2.0 ** 0.5)  # noqa: F821
                      + tanh(u.at(0, 0, -1)) * cos(u.at(-1, 0, 0))  # noqa: F821
                      / (2.0 + sin(a)) + u.at(0, 0, 1) ** 3.0)  # noqa: F821


# name → (port kernel, JAX kernel, per-grid halos or None, scalars)
KERNELS = {
    "star3d4r": (suite.get_kernel("star3d4r"), jsuite.get_kernel("star3d4r"),
                 None, {}),
    "star2d4r": (suite.get_kernel("star2d4r"), jsuite.get_kernel("star2d4r"),
                 None, {}),
    "box3d1r": (suite.get_kernel("box3d1r"), jsuite.get_kernel("box3d1r"),
                None, {}),
    "j2d9pt_gol": (suite.get_kernel("j2d9pt_gol"),
                   jsuite.get_kernel("j2d9pt_gol"), None, {}),
    "acoustic": (acoustic.acoustic_iso_kernel, jacoustic.acoustic_iso_kernel,
                 None, {"dt": 0.3}),
    "wave": (_wave, _jwave, {"u": (2, 2, 2), "v": (0, 0, 0), "vp": (0, 0, 0)},
             {"dt2": 0.002}),
    "two_out": (_two_out, _jtwo_out, {"u": (1, 2), "a": (0, 0), "b": (0, 0)},
                {"c": 0.25}),
}


def _inputs(kernel, interior, halos, seed=0):
    rng = np.random.default_rng(seed)
    halos = halos or {g: kernel.info.halo for g in kernel.ir.grid_params}
    arrays = {g: rng.standard_normal(
        tuple(s + 2 * h for s, h in zip(interior, halos[g]))).astype(np.float32)
        for g in kernel.ir.grid_params}
    return arrays, halos


def _layout_step(kernel, arrays, halos, interior, scal, template, block=None):
    """One step through the plan's layout and the K1/K2 wrapper (on CPU
    tensors: the plain versions)."""
    plan = codegen.plan_cuda(kernel.ir, halos, interior,
                             st.hopper(template=template, block=block))
    tarr = {g: torch.tensor(a) for g, a in arrays.items()}
    padded = plan.to_padded(tarr)
    plan.step(padded, {n: float(np.float32(v)) for n, v in scal.items()})
    return plan.from_padded(padded, tarr)


CASES = [
    ("star3d4r", (12, 16, 20), "gmem", None),
    ("star3d4r", (12, 16, 20), "shift", None),
    ("star3d4r", (11, 13, 19), "unroll", (5, 4, 8)),   # ragged, 3 chunks
    ("star2d4r", (23, 37), "f4", None),
    ("star2d4r", (23, 37), "shift", (5, 16)),
    ("box3d1r", (9, 10, 13), "smem", None),
    ("box3d1r", (9, 10, 13), "shift", (4, 3, 8)),
    ("j2d9pt_gol", (17, 29), "shift", (6, 8)),
    ("acoustic", (12, 10, 16), "gmem", None),
    ("acoustic", (12, 10, 16), "shift", (5, 4, 8)),
    ("wave", (12, 10, 20), "gmem", None),
    ("wave", (12, 10, 20), "shift", (7, 2, 16)),
    ("two_out", (14, 22), "gmem", None),
    ("two_out", (14, 22), "shift", (3, 8)),
]


@pytest.mark.parametrize("name,interior,template,block", CASES)
def test_plain_kernels_match_xla_step(name, interior, template, block):
    k, jk, halos, scal = KERNELS[name]
    arrays, halos = _inputs(k, interior, halos)
    want = jlowering.lower_jax_window(jk.ir, halos, interior, None, None, 1)(
        {g: jnp.asarray(a) for g, a in arrays.items()},
        {n: jnp.float32(v) for n, v in scal.items()})
    got = _layout_step(k, arrays, halos, interior, scal, template, block)
    for g in k.ir.grid_params:
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want[g]),
                                   atol=ATOL, rtol=0, err_msg=f"{name}/{g}")


@pytest.mark.parametrize("name,interior,template", [
    ("star3d4r", (12, 16, 20), "gmem"),
    ("star3d4r", (12, 16, 20), "shift"),
    ("wave", (12, 10, 20), "gmem"),
    ("wave", (12, 10, 20), "shift"),
])
def test_plain_kernels_match_pallas_interpret(name, interior, template):
    k, jk, halos, scal = KERNELS[name]
    arrays, halos = _inputs(k, interior, halos, seed=3)
    want = jops.stencil_apply(jk, {g: jnp.asarray(a) for g, a in arrays.items()},
                              scal, halos=halos, template=template,
                              interpret=True)
    got = _layout_step(k, arrays, halos, interior, scal, template)
    for g in k.ir.output_grids():
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want[g]),
                                   atol=ATOL, rtol=0, err_msg=f"{name}/{g}")


# ---- plan geometry and validation ---------------------------------------------
def test_layout_aliases_grid_when_halo_equals_layout_halo():
    k = suite.get_kernel("star3d4r")
    g = suite.make_grids("star3d4r", shape=(6, 7, 9), device="cpu")
    plan = codegen.plan_cuda(k.ir, {n: x.halo for n, x in g.items()},
                             (6, 7, 9), st.hopper(), swap=("v", "u"))
    padded = plan.to_padded({n: x.data for n, x in g.items()})
    assert padded["u"].data_ptr() == g["u"].data.data_ptr()
    assert plan.hw["v"] == plan.hw["u"] == (4, 4, 4)
    # acoustic's coefficient grids have center-only taps: cut and copied
    a = acoustic.make_fields((6, 7, 9), pml_width=2, device="cpu")
    plan = codegen.plan_cuda(acoustic.acoustic_iso_kernel.ir,
                             {n: (4, 4, 4) for n in ("p0", "p1", "vp2", "damp")},
                             (6, 7, 9), st.hopper(), swap=("p0", "p1"))
    padded = plan.to_padded(dict(zip(("p0", "p1", "vp2", "damp"),
                                     (x.data for x in a[:4]))))
    assert tuple(padded["vp2"].shape) == (6, 7, 9)
    assert padded["vp2"].is_contiguous()
    assert plan.touched == ("p0", "p1")


def test_hbm_bytes_per_step():
    k = suite.get_kernel("star3d4r")
    halos = {"u": (4, 4, 4), "v": (4, 4, 4)}
    R = (64, 64, 64)
    fused = codegen.plan_cuda(k.ir, halos, R, st.hopper(template="gmem"))
    assert fused.hbm_bytes_per_step() == 4 * (72 ** 3 + 64 ** 3)
    stream = codegen.plan_cuda(k.ir, halos, R, st.hopper(template="shift"))
    # per tile/chunk halo'd windows: 1 chunk of 64 planes, 8 tiles of 8
    # rows, 1 tile of 64 columns, each with 2·4 halo cells
    assert stream.B == (64, 8, 64)
    assert stream.hbm_bytes_per_step() == 4 * (72 * (64 + 8 * 8) * (64 + 8)
                                               + 64 ** 3)


@pytest.mark.parametrize("make,match", [
    (lambda: codegen.plan_cuda(suite.get_kernel("star2d1r").ir,
                               {"u": (1, 1), "v": (1, 1)}, (8, 8),
                               st.hopper(), swap=("v", "w")),
     "must appear"),
    (lambda: codegen.plan_cuda(suite.get_kernel("star2d2r").ir,
                               {"u": (1, 1), "v": (2, 2)}, (8, 8),
                               st.hopper()),
     "too small"),
    (lambda: codegen.plan_cuda(suite.get_kernel("star3d1r").ir,
                               {"u": (1, 1, 1), "v": (1, 1, 1)}, (8, 8, 8),
                               st.hopper(block=(1, 64, 32))),
     "1 to 1024"),
    (lambda: codegen.plan_cuda(suite.get_kernel("star3d4r").ir,
                               {"u": (4, 4, 4), "v": (4, 4, 4)}, (8, 8, 8),
                               st.hopper(template="shift", block=(8, 1, 1024))),
     "shared memory"),
], ids=["swap", "halo", "threads", "smem"])
def test_plan_validation(make, match):
    with pytest.raises(ValueError, match=match):
        make()


def test_plan_rejects_noncenter_output_taps():
    @st.kernel
    def selfish(u: st.grid, v: st.grid):
        v.at(0, 0).set(u.at(0, 0) + v.at(1, 0))

    with pytest.raises(ValueError, match="center-only taps"):
        codegen.plan_cuda(selfish.ir, {"u": (1, 1), "v": (1, 1)}, (8, 8),
                          st.hopper())


def test_wrappers_refuse_other_devices_and_types():
    k = suite.get_kernel("star2d1r")
    plan = codegen.plan_cuda(k.ir, {"u": (1, 1), "v": (1, 1)}, (8, 8),
                             st.hopper())
    meta = {g: torch.empty(10, 10, device="meta") for g in ("u", "v")}
    with pytest.raises(ValueError, match="unsupported device"):
        fused_step(plan, meta, {})
    with pytest.raises(ValueError, match="unsupported device"):
        stream_step(plan, meta, {})
    f64 = {g: torch.zeros(10, 10, dtype=torch.float64) for g in ("u", "v")}
    with pytest.raises(TypeError, match="float32"):
        plan.launch_args(f64, {})
    mixed = {"u": torch.zeros(10, 10), "v": torch.empty(10, 10, device="meta")}
    with pytest.raises(ValueError, match="is on meta"):
        plan.launch_args(mixed, {})
    before = (fused_step.launches, stream_step.launches)
    fused_step(plan, {g: torch.zeros(10, 10) for g in ("u", "v")}, {})
    assert (fused_step.launches, stream_step.launches) == before  # no launch


# ---- the emitted point function -------------------------------------------------
def test_emitted_literals_are_f32():
    for name in ("acoustic", "wave", "two_out"):
        k = KERNELS[name][0]
        plan = codegen.plan_cuda(k.ir, {g: (4,) * k.ir.ndim
                                        for g in k.ir.grid_params},
                                 (8,) * k.ir.ndim, st.hopper())
        src = plan.source()
        assert "double" not in src
        for lit in re.findall(r"[0-9.]+e[+-][0-9]+f?", src):
            assert lit.endswith("f"), lit
    assert emit.f32_literal(0.1) == "1.0e-01f"
    for v in (3.0 * -2.8472222, 1.0 / 3.0, 1e-30, 2.0 ** 0.5):
        assert np.float32(float(emit.f32_literal(v)[:-1])) == np.float32(v)


_HARNESS = r"""
#include <cmath>
%s
struct HostReader {
  float* const* g; const long long* sx; const long long* sy; long long idx[RT_NG];
  template <int G, int DX, int DY, int DZ> float at() const {
    return g[G][idx[G] + DX * sx[G] + DY * sy[G] + DZ];
  }
};
extern "C" void host_step(const long long* m, const float* s) {
  float* g[RT_NG]; long long sx[RT_NG], sy[RT_NG], org[RT_NG];
  for (int i = 0; i < RT_NG; ++i) {
    g[i] = reinterpret_cast<float*>(m[i]); sx[i] = m[RT_NG + i];
    sy[i] = m[2 * RT_NG + i]; org[i] = m[3 * RT_NG + i];
  }
  const long long R0 = m[4 * RT_NG], R1 = m[4 * RT_NG + 1], R2 = m[4 * RT_NG + 2];
  for (long long x = 0; x < R0; ++x)
    for (long long y = 0; y < R1; ++y)
      for (long long z = 0; z < R2; ++z) {
        HostReader rd{g, sx, sy, {}};
        for (int i = 0; i < RT_NG; ++i) rd.idx[i] = org[i] + x * sx[i] + y * sy[i] + z;
        float out[RT_NO];
        stencil_point(rd, s, out);
        for (int o = 0; o < RT_NO; ++o) g[out_grid(o)][rd.idx[out_grid(o)]] = out[o];
      }
}
"""


@pytest.mark.parametrize("name,interior", [
    ("acoustic", (9, 10, 12)), ("star3d4r", (9, 10, 12)),
    ("two_out", (10, 13)), ("mathy", (6, 7, 9)), ("wave", (7, 8, 10)),
])
def test_emitted_point_function_compiles_and_matches(name, interior, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    if name == "mathy":
        k, halos, scal = _mathy, None, {"a": 0.7}
    else:
        k, _, halos, scal = KERNELS[name]
    arrays, halos = _inputs(k, interior, halos, seed=9)
    if name == "acoustic":
        arrays["vp2"] = np.abs(arrays["vp2"]) + 1.0
    plan = codegen.plan_cuda(k.ir, halos, interior, st.hopper())
    header = plan.source().rsplit("#include", 1)[0]
    cpp = tmp_path / "harness.cpp"
    cpp.write_text(_HARNESS % header)
    so = tmp_path / "libharness.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-D__host__=", "-D__device__=", "-o", str(so), str(cpp)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.host_step.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.host_step.restype = None

    scal32 = {n: float(np.float32(v)) for n, v in scal.items()}
    ref = plan.to_padded({g: torch.tensor(a) for g, a in arrays.items()})
    fused_step_plain(plan, ref, scal32)
    pad = plan.to_padded({g: torch.tensor(a) for g, a in arrays.items()})
    meta, sc = plan.launch_args(pad, scal32)
    lib.host_step(ctypes.addressof(meta), ctypes.addressof(sc))
    for g in plan.out_grids:
        np.testing.assert_allclose(pad[g].numpy(), ref[g].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=g)
