"""The port's CUDA kernels on the card, at configurations ``chip_smoke.py``
does not reach: 2D stencils (run as ``(R0, 1, R1)``), box taps, a
coefficient grid read off-center, K3 at k=4 (its rings near the 227 KB
shared-memory limit) and at odd depths, K5 with two outputs; and the
per-application kernels of ``st.map`` (K4 gmem/f4/smem, K2's and K5's
builds with a destination) in 2D, with box taps, with an output read
off-center (into a destination buffer), with two outputs where the second
reads the first, at a thin region at each face, f4 at a ragged pitch and
region start, and under both ``mem_type`` values; K4 gmem on
pseudo-acoustic TTI (170 taps, off-axis taps and coefficients read off the
centre, two outputs, its own register budget) and its run-ahead; every stencil source built for bf16 grids (within one bf16
ulp of max(1, |plain|): both versions compute in f32 and round once), K5
with two coefficient groups, and K7's
split and combine passes with lengths 0, 1, S and one past a split
boundary, at B=1 and with 32 query heads to a KV head; ``batch=B`` under
K1, K2, K3 (k=2 and 3) and K5 in f32 and bf16 (each scenario bit for bit
against its own unbatched run, a window's launches those of the unbatched
window), per-scenario ``(B, NS)`` scalars against the plain versions, and
the adjoint under ``st.hopper`` against the same adjoint under
``st.torch()`` (within 1e-3 of each gradient's max: the two forward
passes differ by f32 rounding); and the loss and gradients of one layer
of each language-model family on the card against the CPU (no kernel of
the port: the PyTorch operators on CUDA tensors).

Each kernel is held against its plain version on the same CUDA tensors
(the plain versions are held against the JAX package on the CPU by the
other ``test_torch_*`` files), within 2e-5 × max(1, |plain|) as in
``chip_smoke.py``: f32 sums in another order, with FMA contraction.
Every test needs a CUDA device and skips without one:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import ctypes
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import acoustic  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.core import suite  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stencil import codegen  # noqa: E402
from repro_torch.kernels.stencil.fused_step import fused_step, fused_step_plain  # noqa: E402
from repro_torch.kernels.stencil.map_step import map_step, map_step_plain  # noqa: E402
from repro_torch.kernels.stencil.semi_step import semi_step, semi_step_plain  # noqa: E402
from repro_torch.kernels.stencil.stream_step import stream_step, stream_step_plain  # noqa: E402
from repro_torch.kernels.stencil.temporal_step import (  # noqa: E402
    temporal_step, temporal_step_plain)

pytestmark = pytest.mark.gpu
RTOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@st.kernel
def _tapped_coef(u: st.grid, v: st.grid, c: st.grid, w: st.grid):
    v.at(0, 0).set(0.5 * u.at(0, 0) - 0.25 * v.at(0, 0)
                   + 0.1 * c.at(1, 0) * (u.at(0, 1) + u.at(-1, 0))
                   + 0.05 * w.at(0, 0) * u.at(1, -1))


@st.kernel
def _two_lin(u: st.grid, a: st.grid, b: st.grid, c: st.f32):
    a.at(0, 0).set(0.5 * (u.at(1, 0) + u.at(-1, 0)) - c * u.at(0, -2))
    b.at(0, 0).set(b.at(0, 0) * 2.0 - 0.25 * u.at(0, 2) + c * u.at(-2, 1))


@st.kernel
def _two_out(u: st.grid, a: st.grid, b: st.grid, c: st.f32):
    a.at(0, 0).set(0.5 * (u.at(1, 0) + u.at(-1, 0)) - c * u.at(0, -2))
    b.at(0, 0).set(a.at(0, 0) * 2.0 + b.at(0, 0) - u.at(0, 2) ** 2.0)


@st.kernel
def _jacobi2(u: st.grid, f: st.grid):
    u.at(0, 0).set(0.25 * (u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1))
                   - 0.5 * f.at(0, 0))


@st.kernel
def _jacobi3(u: st.grid, f: st.grid):
    u.at(0, 0, 0).set(0.16666667 * (u.at(-1, 0, 0) + u.at(1, 0, 0)
                                    + u.at(0, -1, 0) + u.at(0, 1, 0)
                                    + u.at(0, 0, -1) + u.at(0, 0, 1))
                      - 0.5 * f.at(0, 0, 0))


def _kernel(name):
    if name == "tapped_coef":
        return _tapped_coef, ("v", "u"), {}
    if name == "two_lin":
        return _two_lin, None, {"c": 0.25}
    if name == "two_out":
        return _two_out, None, {"c": 0.25}
    if name in ("jacobi2", "jacobi3"):
        return {"jacobi2": _jacobi2, "jacobi3": _jacobi3}[name], None, {}
    if name == "acoustic":
        return acoustic.acoustic_iso_kernel, ("p0", "p1"), {"dt": 0.3}
    k = suite.get_kernel(name)
    return k, suite.swap_pair(name), {}


def _layout(kernel, shape, device, seed):
    """Random layout buffers (every cell, halos included) of ``kernel``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h = kernel.info.order
    arrays = {g: torch.randn(tuple(s + 2 * h for s in shape), generator=gen,
                             device=device)
              for g in kernel.ir.grid_params}
    return arrays, {g: (h,) * kernel.ir.ndim for g in arrays}


def _check(got, want, key):
    assert bool(torch.isfinite(got).all()), key
    err = float((got - want).abs().max())
    assert err <= RTOL * max(1.0, float(want.abs().max())), (key, err)


@pytest.mark.parametrize("name,shape,time_block,block", [
    ("star2d2r", (61, 133), 2, (8, 64)),
    ("star2d2r", (61, 133), 3, (8, 64)),
    ("star2d2r", (61, 133), 4, None),
    ("box2d1r", (70, 45), 4, (5, 32)),
    ("j2d9pt_gol", (33, 70), 3, None),
    ("box3d1r", (21, 30, 47), 3, (4, 4, 16)),
    ("star3d4r", (40, 37, 70), 4, None),
    ("tapped_coef", (45, 77), 2, (6, 32)),
    ("tapped_coef", (45, 77), 3, None),
])
def test_temporal_kernel_matches_plain(cuda, name, shape, time_block, block):
    k, swap, scal = _kernel(name)
    arrays, halos = _layout(k, shape, cuda, 1)
    plan = codegen.plan_cuda(k.ir, halos, shape,
                             st.hopper(template="shift", time_block=time_block,
                                       block=block), swap=swap)
    padded = plan.to_padded(arrays)
    before = {g: t.clone() for g, t in padded.items()}
    spares, ref = plan.make_spares(padded), plan.make_spares(padded)
    n = temporal_step.launches
    temporal_step(plan, padded, spares, scal)
    temporal_step_plain(plan, padded, ref, scal)
    torch.cuda.synchronize()
    assert temporal_step.launches == n + 1
    for g in plan.step_out_grids:
        _check(spares[g], ref[g], f"{name}/k={time_block}/{g}")
    for g, t in padded.items():
        assert torch.equal(t, before[g]), f"{name}: wrote its read buffer {g}"


@pytest.mark.parametrize("name,shape,block", [
    ("star2d4r", (61, 133), None),
    ("star2d4r", (61, 133), (5, 32)),
    ("two_lin", (50, 90), (7, 64)),
    ("j3d27pt", (21, 30, 47), (4, 4, 16)),
    ("box3d1r", (21, 30, 47), None),
])
def test_semi_kernel_matches_plain(cuda, name, shape, block):
    k, _, scal = _kernel(name)
    arrays, halos = _layout(k, shape, cuda, 2)
    plan = codegen.plan_cuda(k.ir, halos, shape,
                             st.hopper(template="semi", block=block))
    padded = plan.to_padded(arrays)
    ref = {g: t.clone() for g, t in padded.items()}
    n = semi_step.launches
    semi_step(plan, padded, scal)
    semi_step_plain(plan, ref, scal)
    torch.cuda.synchronize()
    assert semi_step.launches == n + 1
    for g in plan.out_grids:
        _check(padded[g], ref[g], f"{name}/{g}")


@pytest.mark.parametrize("template", ("gmem", "shift"))
@pytest.mark.parametrize("name", ("star2d4r", "two_lin", "tapped_coef"))
def test_single_step_kernels_2d_match_plain(cuda, template, name):
    k, _, scal = _kernel(name)
    arrays, halos = _layout(k, (61, 133), cuda, 3)
    plan = codegen.plan_cuda(k.ir, halos, (61, 133),
                             st.hopper(template=template))
    padded = plan.to_padded(arrays)
    ref = {g: t.clone() for g, t in padded.items()}
    kern, plain = ((fused_step, fused_step_plain) if template == "gmem"
                   else (stream_step, stream_step_plain))
    kern(plan, padded, scal)
    plain(plan, ref, scal)
    torch.cuda.synchronize()
    for g in plan.out_grids:
        _check(padded[g], ref[g], f"{name}/{template}/{g}")


# (name, interior, block, dtype): user blocks whose b0 does not divide R0,
# rows of 16 and 24 lanes, an odd b2 (one point a lane), and the default
# block at 64³ (pair loads) and on ragged shapes (rows of 141 cells: bf16
# rows that start on odd cells, single-cell loads), 2D, off-axis taps
FUSED_WALK_CASES = [
    ("star2d4r", (61, 133), (5, 64), torch.float32),
    ("tapped_coef", (45, 77), (3, 32), torch.float32),
    ("star3d4r", (61, 70, 133), (3, 4, 32), torch.float32),
    ("box3d1r", (21, 30, 47), (8, 2, 16), torch.float32),
    ("box3d1r", (21, 30, 47), (8, 2, 16), torch.bfloat16),
    ("box3d1r", (21, 30, 47), (8, 2, 15), torch.bfloat16),
    ("star3d4r", (37, 21, 100), (8, 3, 24), torch.float32),
    ("star3d4r", (64, 64, 64), None, torch.float32),
    ("star3d4r", (64, 64, 64), None, torch.bfloat16),
    ("star3d4r", (61, 70, 133), None, torch.float32),
    ("star3d4r", (61, 70, 133), None, torch.bfloat16),
    ("acoustic", (61, 70, 133), None, torch.float32),
    ("acoustic", (64, 64, 64), None, torch.bfloat16),
    ("acoustic", (61, 70, 133), None, torch.bfloat16),
    ("star2d4r", (61, 133), None, torch.bfloat16),
    ("star2d4r", (64, 128), None, torch.float32),
    ("box3d2r", (21, 30, 47), None, torch.bfloat16),
    ("box3d2r", (20, 30, 48), None, torch.float32),
]


@pytest.mark.parametrize("name,shape,block,dtype", FUSED_WALK_CASES,
                         ids=[f"{c[0]}-{'x'.join(map(str, c[1]))}-"
                              f"{'x'.join(map(str, c[2])) if c[2] else 'default'}-"
                              f"{str(c[3])[6:]}" for c in FUSED_WALK_CASES])
def test_fused_step_column_walk_matches_plain(cuda, name, shape, block, dtype):
    """K1's lanes walk ``b0`` planes of a column, in place: a ragged last
    column along axis 0 and ragged lanes along axis 2, outputs read at
    their center; f32 within 2e-5 x max(1, |plain|), bf16 within one bf16
    ulp (both compute in f32 and round once)."""
    k, _, scal = _kernel(name)
    arrays, halos = _layout(k, shape, cuda, 6)
    if name == "acoustic":       # coefficients in their physical ranges
        arrays["vp2"] = 0.5 + 1.5 * arrays["vp2"].abs().clamp(max=1)
        arrays["damp"] = 0.2 * arrays["damp"].abs().clamp(max=1)
    arrays = {g: t.to(dtype) for g, t in arrays.items()}
    plan = codegen.plan_cuda(k.ir, halos, shape, st.hopper(block=block))
    padded = plan.to_padded(arrays)
    ref = {g: t.clone() for g, t in padded.items()}
    n = fused_step.launches
    fused_step(plan, padded, scal)
    fused_step_plain(plan, ref, scal)
    torch.cuda.synchronize()
    assert fused_step.launches == n + 1
    for g in plan.opnd_grids:
        if dtype == torch.float32:
            _check(padded[g], ref[g], f"{name}/{g}")
        else:
            scale = max(1.0, float(ref[g].float().abs().max()))
            err = float((padded[g].float() - ref[g].float()).abs().max())
            assert err <= _bf16_ulp(scale), (name, g, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gmem_off_an_aligned_base_and_other_pitches(cuda, dtype):
    """K4 gmem on a grid whose base is one cell off a pair (its loads then
    read single cells) at a region that starts on an odd cell; a build
    refuses buffers of pitches other than its own."""
    k, _, scal = _kernel("star3d4r")
    shape, region = (40, 30, 64), ((2, 38), (1, 29), (3, 61))
    halos = {g: (4, 4, 4) for g in k.ir.grid_params}
    plan = codegen.lower_hopper(k.ir, halos, shape, region, st.hopper())
    full = plan.full_shapes["u"]
    gen = torch.Generator(device=cuda).manual_seed(9)
    store = torch.randn(math.prod(full) + 1, generator=gen, device=cuda).to(dtype)
    bufs = {"u": store[1:].view(full),
            "v": torch.randn(full, generator=gen, device=cuda).to(dtype)}
    assert not plan.gmem_pairs(dtype, bufs)["u"]
    ref = {g: t.clone() for g, t in bufs.items()}
    map_step(plan, bufs, scal, None)
    map_step_plain(plan, ref, scal, None)
    torch.cuda.synchronize()
    scale = max(1.0, float(ref["v"].float().abs().max()))
    err = float((bufs["v"].float() - ref["v"].float()).abs().max())
    assert err <= (RTOL * scale if dtype == torch.float32 else _bf16_ulp(scale)), err
    other = codegen.lower_hopper(k.ir, halos, (40, 30, 66), region, st.hopper())
    fn = _build.load(plan.source(dtype, bufs), "rt_map_step")
    wide = {g: torch.zeros(other.full_shapes[g], device=cuda, dtype=dtype)
            for g in ("u", "v")}
    meta, sc = other.launch_args(wide, scal)
    assert fn(ctypes.addressof(meta), ctypes.addressof(sc),
              torch.cuda.current_stream().cuda_stream) != 0


@pytest.mark.parametrize("template,time_block", [
    ("gmem", 3), ("semi", 2), ("unroll", 4), ("semi", 1)])
def test_timeloop_on_the_card_matches_torch(cuda, template, time_block):
    """``st.timeloop`` on CUDA grids, K3 launches plus remainder steps, vs
    ``st.torch()`` on the card."""
    k = suite.get_kernel("star2d2r")
    rng = np.random.default_rng(4)
    init = {g: rng.standard_normal((133 + 4, 70 + 4)).astype(np.float32)
            for g in ("u", "v")}
    out = []
    for be in (st.torch(), st.hopper(template=template, time_block=time_block)):
        g = {n: st.grid(shape=(133, 70), order=2, data=torch.tensor(a),
                        device=cuda) for n, a in init.items()}
        st.launch(backend=be)(
            lambda u, v: st.timeloop(11, swap=("v", "u"), fuse_steps=5)(k)(
                u, v))(g["u"], g["v"])
        out.append(g)
    for n in ("u", "v"):
        _check(out[1][n].data, out[0][n].data, n)


# ---- per-application kernels (st.map) -------------------------------------------
MAP_TEMPLATES = ("gmem", "f4", "smem", "shift", "semi")
MAP_WRAPPERS = {"map": (map_step, map_step_plain),
                "stream": (stream_step, stream_step_plain),
                "semi": (semi_step, semi_step_plain)}
FACE_SHAPE = (20, 24, 37)


def _faces(shape, width=3):
    """A region ``width`` thick at each face of the interior."""
    out = []
    for ax in range(len(shape)):
        for lo in (True, False):
            r = [(0, n) for n in shape]
            r[ax] = (0, width) if lo else (shape[ax] - width, shape[ax])
            out.append(tuple(r))
    return out


# (id, kernel, interior, region, template, block, mem_type)
MAP_CASES = []
for _t in MAP_TEMPLATES:
    MAP_CASES += [
        (f"2d-{_t}", "star2d4r", (61, 133), None, _t, None, None),
        (f"2d-listing1-block-{_t}", "star2d4r", (61, 133), None, _t, (8, 128), None),
        (f"box-{_t}", "box3d2r", (21, 30, 47), None, _t, None, None),
        (f"offcenter2d-{_t}", "jacobi2", (45, 77), ((3, 40), (5, 77)), _t, None, None),
        (f"offcenter3d-{_t}", "jacobi3", (21, 30, 47), None, _t, None, None),
    ]
    if _t != "semi":        # not linear in its taps
        MAP_CASES.append((f"two_out-{_t}", "two_out", (50, 90), None, _t, None, None))
    MAP_CASES += [(f"face{i}-{_t}", "star3d4r", FACE_SHAPE, r, _t, None, None)
                  for i, r in enumerate(_faces(FACE_SHAPE))]
MAP_CASES += [
    ("f4-ragged-pitch", "star3d2r", (9, 11, 13), ((1, 9), (2, 11), (1, 13)),
     "f4", (2, 4, 8), None),
    ("f4-ragged-pitch-2d", "box2d1r", (33, 71), ((0, 33), (3, 70)), "f4", (3, 16), None),
]
MAP_CASES += [(f"mem-{mt}-{t}", "box3d1r", (21, 30, 47), None, t, None, mt)
              for t in ("gmem", "shift") for mt in ("registers", "vmem")]
# K4 gmem's lanes: a region whose first cell is not on a warp boundary, on
# the ragged shape, under the default block and one whose b0 does not
# divide the region; rows of 8 and 12 lanes; acoustic (three center-only
# grids); Jacobi into a destination at an unaligned region, its queue on
# the output grid
MAP_CASES += [
    ("gmem-region", "star3d4r", (61, 70, 133), ((5, 50), (3, 61), (10, 127)),
     "gmem", None, None),
    ("gmem-region-b0", "star3d4r", (61, 70, 133), ((5, 50), (3, 61), (10, 127)),
     "gmem", (7, 4, 64), None),
    ("gmem-rows16", "star3d4r", (21, 30, 47), ((0, 21), (1, 30), (5, 47)),
     "gmem", (4, 2, 16), None),
    ("gmem-rows24", "box3d2r", (21, 30, 47), None, "gmem", (4, 3, 24), None),
    ("gmem-acoustic", "acoustic", (61, 70, 133), None, "gmem", None, None),
    ("gmem-jacobi-region", "jacobi3", (61, 70, 133), ((5, 50), (3, 61), (10, 127)),
     "gmem", None, None),
]


def _map_plan(name, shape, region, template, block, mem_type):
    k, _, _ = _kernel(name)
    halos = {g: (k.info.order,) * k.ir.ndim for g in k.ir.grid_params}
    return codegen.lower_hopper(k.ir, halos, shape, region,
                                st.hopper(template=template, block=block,
                                          mem_type=mem_type))


@pytest.fixture(scope="module")
def map_built():
    """Every source of the map cases, built in parallel (one nvcc each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.build_many([_map_plan(*c[1:]).source() for c in MAP_CASES])


@pytest.mark.parametrize("case", MAP_CASES, ids=[c[0] for c in MAP_CASES])
def test_map_kernel_matches_plain(cuda, map_built, case):
    _, name, shape, region, template, block, mem_type = case
    k, _, scal = _kernel(name)
    plan = _map_plan(name, shape, region, template, block, mem_type)
    assert plan.in_place == (not name.startswith("jacobi"))
    gen = torch.Generator(device=cuda).manual_seed(5)
    bufs = {g: torch.randn(plan.full_shapes[g], generator=gen, device=cuda)
            for g in plan.opnd_grids}
    if name == "acoustic":       # coefficients in their physical ranges
        bufs["vp2"] = 0.5 + 1.5 * bufs["vp2"].abs().clamp(max=1)
        bufs["damp"] = 0.2 * bufs["damp"].abs().clamp(max=1)
    ref = {g: t.clone() for g, t in bufs.items()}
    dst, rdst = plan.make_dst(bufs), plan.make_dst(ref)
    kern, plain = MAP_WRAPPERS[plan.kind]
    n = kern.launches
    kern(plan, bufs, scal, dst)
    plain(plan, ref, scal, rdst)
    torch.cuda.synchronize()
    assert kern.launches == n + 1
    for g in plan.out_grids:
        # in place the whole tensor: cells outside the region keep theirs
        if dst is None:
            _check(bufs[g], ref[g], f"{case[0]}/{g}")
        else:
            _check(dst[g], rdst[g], f"{case[0]}/{g}")
    if dst is not None:
        for g in bufs:
            assert torch.equal(bufs[g], ref[g]), f"{case[0]}: wrote grid {g}"


@pytest.mark.parametrize("template", MAP_TEMPLATES)
def test_map_on_the_card_matches_torch(cuda, template):
    """Five ``st.map`` applications with the ``.data`` swap on CUDA grids
    vs ``st.torch()`` on the card, one launch each."""
    k = suite.get_kernel("star2d2r")
    rng = np.random.default_rng(6)
    init = {g: rng.standard_normal((133 + 4, 70 + 4)).astype(np.float32)
            for g in ("u", "v")}
    out = []
    for be in (st.torch(), st.hopper(template=template)):
        g = {n: st.grid(shape=(133, 70), order=2, data=torch.tensor(a),
                        device=cuda) for n, a in init.items()}
        counts = [w.launches for w, _ in MAP_WRAPPERS.values()]

        def loop(u, v):
            for _ in range(5):
                st.map(e=u.shape)(k)(u, v)
                (u.data, v.data) = (v.data, u.data)
        st.launch(backend=be)(loop)(g["u"], g["v"])
        added = sum(w.launches for w, _ in MAP_WRAPPERS.values()) - sum(counts)
        assert added == (5 if be.kind == "hopper" else 0)
        out.append(g)
    for n in ("u", "v"):
        _check(out[1][n].data, out[0][n].data, n)


@pytest.mark.parametrize("template", ["gmem", "torch"])
def test_map_run_ahead_equals_a_sync_after_each_step(cuda, template):
    """200 acoustic steps at 128³ with the source and a receiver plane each
    step, as one launch: with ``st.map`` one application ahead of the card
    the wavefields and the seismogram are bit for bit those of the same
    steps with a ``torch.cuda.synchronize()`` after each ``st.map``, and
    under ``set_sync_debug_mode("warn")`` no call of the step synchronizes."""
    import warnings
    be = st.torch() if template == "torch" else st.hopper(template=template)
    shape, steps = (128, 128, 128), 200
    step = st.map(e=shape)(acoustic.acoustic_iso_kernel)

    def shot(synced):
        """The launch of one shot, and the state it leaves."""
        p0, p1, vp2, damp, dt = acoustic.make_fields(shape, pml_width=10, device=cuda)
        seis = torch.empty((steps,) + shape[1:], device=cuda)

        @st.target
        def run():
            for t in range(steps):
                seis[t].copy_(p1.interior[shape[0] // 2])
                acoustic.inject_source(p1, t)
                step(p0, p1, vp2, damp, dt)
                if synced:
                    torch.cuda.synchronize()
                p0.data, p1.data = p1.data, p0.data
        return st.launch(backend=be)(run), lambda: (p0.data, p1.data, seis)

    run, synced = shot(synced=True)
    run()                                   # builds the kernel
    run, ahead = shot(synced=False)
    torch.cuda.synchronize()

    def syncing(fn):
        """The synchronizing calls ``fn`` makes, as the debug mode warns."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return [str(w.message) for w in caught
                if "called a synchronizing" in str(w.message)]
    assert syncing(lambda: torch.ones(1, device=cuda).item())    # the mode sees one
    found = syncing(run)
    assert not found, found[:3]
    for a, b, n in zip(ahead(), synced(), ("p0", "p1", "seis")):
        assert torch.equal(a, b), n
    assert float(synced()[2].abs().max()) > 0


# ---- K4 gmem on pseudo-acoustic TTI: 170 taps, off-axis taps in every ----------
# coordinate plane, θ and φ read only off the centre, 48 sin/cos and a sqrt,
# two outputs written in place, its build budgeted for fewer blocks an SM
# (codegen.gmem_min_blocks).  Boxes: odd
# pitches (every tap a load of one cell, lanes past the region clamped),
# even pitches with an odd region (aligned pair loads, clamped at the
# region's end) and a sub-region starting at odd cells
TTI_CASES = [((37, 29, 45), None), ((37, 29, 46), None),
             ((37, 29, 46), ((3, 34), (1, 28), (5, 41)))]


def _tti_fields(shape, device, seed):
    """TTI's full tensors on ``device``: standard-normal wavefields, each
    coefficient random in its physical range (ε ≥ δ)."""
    from repro_torch.core import tti
    gen = torch.Generator(device=device).manual_seed(seed)
    full = tuple(n + 2 * tti.ORDER for n in shape)
    out = {g: torch.randn(full, generator=gen, device=device) for g in tti.GRIDS}

    def unit(g):
        return torch.rand(full, generator=gen, device=device)
    out["vp2"] = (1.5 + 3.0 * unit("vp2")) ** 2
    out["delta"] = 0.05 + 0.05 * unit("delta")
    out["epsilon"] = out["delta"] + 0.15 * unit("epsilon")
    out["theta"] = 0.15 + 0.45 * unit("theta")
    out["phi"] = 0.2 + unit("phi")
    out["damp"] = 0.2 * unit("damp")
    return out


@pytest.fixture(scope="module")
def tti_built():
    """The TTI builds of the cases, in parallel (one nvcc each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import tti
    k = tti.tti_kernel
    halos = {g: (tti.ORDER,) * 3 for g in k.ir.grid_params}
    plans = [codegen.lower_hopper(k.ir, halos, shape, region, st.hopper())
             for shape, region in TTI_CASES]
    cuda = torch.device("cuda")
    srcs = [pl.source(torch.float32, {g: t for g, t in _tti_fields(sh, cuda, 0).items()})
            for pl, (sh, _) in zip(plans, TTI_CASES)]
    _build.build_many(srcs)
    return srcs


@pytest.mark.parametrize("case", TTI_CASES, ids=["odd-pitch", "pairs", "pairs-region"])
def test_tti_map_matches_torch(cuda, tti_built, case):
    """One ``st.map`` of TTI under ``st.hopper()`` (K4 gmem) against
    ``st.torch()`` on the card: both outputs written in place over the
    region, every other cell and grid as it was."""
    from repro_torch.core import tti
    shape, region = case
    fields = _tti_fields(shape, cuda, 7)
    span = ({} if region is None else
            {"begin": tuple(b for b, _ in region), "end": tuple(e for _, e in region)})
    out = []
    for be in (st.torch(), st.hopper()):
        grids = [st.grid(shape=shape, order=tti.ORDER, data=fields[g].clone())
                 for g in tti.GRIDS]
        n = map_step.launches
        mapped = st.map(**span) if span else st.map(e=shape)
        st.launch(backend=be)(lambda *a: mapped(tti.tti_kernel)(*a))(*grids, np.float32(0.07))
        assert map_step.launches == n + (be.kind == "hopper")
        out.append(dict(zip(tti.GRIDS, grids)))
    for g in tti.GRIDS:
        if g in ("p0", "r0"):
            _check(out[1][g].data, out[0][g].data, g)
            assert not torch.equal(out[1][g].data, fields[g]), g
        else:
            assert torch.equal(out[1][g].data, fields[g]), g
    plan_src = tti_built[TTI_CASES.index(case)]
    assert "#define RT_MIN_BLOCKS" in plan_src


def test_tti_run_ahead_equals_a_sync_after_each_step(cuda):
    """20 TTI steps at 48³ as one launch, the source into both fields and
    a receiver plane each step: with ``st.map`` one application ahead of
    the card, the four wavefields and the seismogram are bit for bit those
    of the same steps with a sync after each ``st.map``, and within f32
    rounding of ``st.torch()``'s."""
    from repro_torch.core import tti
    shape, steps = (48, 48, 48), 20

    def shot(be, synced):
        f = tti.make_fields(shape, pml_width=6, device=cuda)
        p0, p1, r0, r1 = f[:4]
        seis = torch.empty((steps,) + shape[1:], device=cuda)
        step = st.map(e=shape)(tti.tti_kernel)

        @st.target
        def run():
            for t in range(steps):
                seis[t].copy_(p1.interior[shape[0] // 2])
                tti.inject_source(p1, r1, t, amp=100.0)
                step(*f)
                if synced:
                    torch.cuda.synchronize()
                p0.data, p1.data = p1.data, p0.data
                r0.data, r1.data = r1.data, r0.data
        st.launch(backend=be)(run)()
        torch.cuda.synchronize()
        return p0.data, p1.data, r0.data, r1.data, seis

    synced = shot(st.hopper(), True)
    ahead = shot(st.hopper(), False)
    plain = shot(st.torch(), False)
    for a, b, c, n in zip(ahead, synced, plain, ("p0", "p1", "r0", "r1", "seis")):
        assert torch.equal(a, b), n
        _check(a, c, n)
    assert float(synced[1].abs().max()) > 1.0


# ---- K4 f4's load paths and smem's staging paths --------------------------------
# (shape, region, f4 aligned, smem by TMA): pitches that are multiples of 4
# cells (f4 fixes each row's place at plan time) and of 16 bytes (smem's
# TMA), at the region's first cell 0 or 3 mod 4 (at 3, smem's boxes would
# start off a 16-byte boundary: granules); the ragged 61 x 70 x 133 (rows
# of 141 cells: f4 aligns at run time, smem copies 4-byte granules) and its
# sub-region whose z-start is not a multiple of 4
PATH_CASES = [((64, 64, 64), None, True, True),
              ((64, 64, 64), ((1, 40), (0, 64), (8, 60)), True, True),
              ((64, 64, 64), ((1, 40), (0, 64), (7, 60)), True, False),
              ((61, 70, 133), None, False, False),
              ((61, 70, 133), ((5, 50), (3, 61), (10, 127)), False, False)]


def _path_plan(name, shape, region, template):
    k, _, _ = _kernel(name)
    halos = {g: (k.info.order,) * 3 for g in k.ir.grid_params}
    return codegen.lower_hopper(k.ir, halos, shape, region,
                                st.hopper(template=template))


@pytest.fixture(scope="module")
def paths_built():
    """Every source of the path cases, built in parallel (one nvcc each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.build_many([_path_plan(n, s, r, t).source(d)
                       for n in ("star3d4r", "acoustic")
                       for s, r, _, _ in PATH_CASES for t in ("f4", "smem")
                       for d in (torch.float32, torch.bfloat16)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("template", ["f4", "smem"])
@pytest.mark.parametrize("name", ["star3d4r", "acoustic"])
@pytest.mark.parametrize("case", PATH_CASES,
                         ids=["64", "64-region8", "64-region7", "ragged",
                              "ragged-region"])
def test_map_paths_match_plain(cuda, paths_built, case, name, template, dtype):
    """Each load path of f4 and staging path of smem against its plain
    version: f32 within 2e-5 x max(1, |plain|), bf16 within one bf16 ulp."""
    shape, region, aligned, tma = case
    k, _, scal = _kernel(name)
    plan = _path_plan(name, shape, region, template)
    if template == "f4":
        assert all((o is not None) == aligned
                   for o in plan.f4_org_mod4().values())
    else:
        assert set(plan.smem_tma(dtype).values()) == {tma}
    gen = torch.Generator(device=cuda).manual_seed(8)
    bufs = {g: torch.randn(plan.full_shapes[g], generator=gen, device=cuda)
            for g in plan.opnd_grids}
    if name == "acoustic":       # coefficients in their physical ranges
        bufs["vp2"] = 0.5 + 1.5 * bufs["vp2"].abs().clamp(max=1)
        bufs["damp"] = 0.2 * bufs["damp"].abs().clamp(max=1)
    bufs = {g: t.to(dtype) for g, t in bufs.items()}
    ref = {g: t.clone() for g, t in bufs.items()}
    n = map_step.launches
    map_step(plan, bufs, scal, None)
    map_step_plain(plan, ref, scal, None)
    torch.cuda.synchronize()
    assert map_step.launches == n + 1
    for g in plan.out_grids:
        if dtype == torch.float32:
            _check(bufs[g], ref[g], f"{case}/{name}/{template}/{g}")
        else:
            scale = max(1.0, float(ref[g].float().abs().max()))
            err = float((bufs[g].float() - ref[g].float()).abs().max())
            assert err <= _bf16_ulp(scale), (case, name, template, g, err)


@st.kernel
def _two_ring(u: st.grid, c: st.grid, v: st.grid):
    v.at(0, 0, 0).set(0.5 * u.at(0, 0, 0)
                      + 0.1 * (u.at(-1, 0, 0) + u.at(0, 1, 0) + u.at(0, 0, 1))
                      + 0.2 * c.at(1, 0, 0) * c.at(0, 0, -1))


@pytest.mark.parametrize("case", ["2d", "2d-bf16", "mixed"])
def test_smem_tma_in_2d_and_beside_granules(cuda, case):
    """smem's TMA path in 2D (a block whose box fits a TMA box), and one
    kernel staging one grid by TMA and another by granules (rows of 66
    cells), against the plain version."""
    if case == "mixed":
        k, shape = _two_ring, (30, 30, 62)
        halos = {"u": (5,) * 3, "c": (2,) * 3, "v": (0,) * 3}
        block, dtype, want = None, torch.float32, {"u": True, "c": False}
    else:
        k, shape = suite.get_kernel("star2d4r"), (64, 120)
        halos = {"u": (4, 4), "v": (4, 4)}
        block, want = (16, 128), {"u": True}
        dtype = torch.bfloat16 if case == "2d-bf16" else torch.float32
    plan = codegen.lower_hopper(k.ir, halos, shape, None,
                                st.hopper(template="smem", block=block))
    assert plan.smem_tma(dtype) == want
    gen = torch.Generator(device=cuda).manual_seed(9)
    bufs = {g: torch.randn(plan.full_shapes[g], generator=gen,
                           device=cuda).to(dtype) for g in plan.opnd_grids}
    ref = {g: t.clone() for g, t in bufs.items()}
    map_step(plan, bufs, {}, None)
    map_step_plain(plan, ref, {}, None)
    torch.cuda.synchronize()
    for g in plan.out_grids:
        scale = max(1.0, float(ref[g].float().abs().max()))
        err = float((bufs[g].float() - ref[g].float()).abs().max())
        tol = RTOL * scale if dtype == torch.float32 else _bf16_ulp(scale)
        assert err <= tol, (case, g, err)


# ---- K6 (causal conv1d) and K7 (flash decode attention) ------------------------
# at the shapes of the CPU parity tests (tests/test_torch_conv1d.py,
# tests/test_torch_decode_attn.py), held against their plain versions on
# the card.  K6 rounds as its plain version does (f32 products and sums,
# no contraction, one rounding), so the two agree bit for bit; K7 sums in
# another order (f32 2e-5 of the magnitude; bf16 one rounding of the
# output, 1e-2).
CONV_SHAPES = [(2, 32, 16, 4), (1, 100, 24, 4), (3, 16, 128, 2),
               (2, 64, 8, 1), (1, 8, 16, 8)]
ATTN_SHAPES = [(2, 64, 8, 4, 16, 16), (3, 100, 4, 1, 32, 32),
               (1, 33, 16, 16, 8, 8), (2, 128, 8, 2, 16, 128),
               (4, 48, 8, 8, 64, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,W,cw", CONV_SHAPES)
def test_conv1d_kernel_matches_plain(cuda, B, T, W, cw, dtype):
    from repro_torch.kernels.conv1d.conv1d import causal_conv1d_cuda
    from repro_torch.kernels.conv1d.ref import causal_conv1d_ref
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((B, T, W), generator=gen, device=cuda).to(dtype)
    w = torch.randn((cw, W), generator=gen, device=cuda).to(dtype)
    n = causal_conv1d_cuda.launches
    got = causal_conv1d_cuda(x, w)
    want = causal_conv1d_ref(x, w)
    torch.cuda.synchronize()
    assert causal_conv1d_cuda.launches == n + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want)


# K6's two builds at the serving decode shape, a prefill-sized one and a
# ragged one (4100 channels: whole f32 vectors, no whole bf16 vector, so
# bf16 takes the lane build only), cw 1-4, with runs of 1, 3 and 64 rows
# (a run's halo comes from the run before it); bit for bit against the
# plain version
CONV_BUILD_SHAPES = {"decode": (4, 4, 4096), "prefill": (4, 2048, 4096),
                     "ragged": (3, 1001, 4100)}
CONV_BUILD_CASES = [(label, build) for label in CONV_BUILD_SHAPES
                    for build in ("vector", "lane")]


@pytest.mark.parametrize("cw", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("label,build", CONV_BUILD_CASES,
                         ids=[f"{a}-{b}" for a, b in CONV_BUILD_CASES])
def test_conv1d_builds_match_plain(cuda, label, build, dtype, cw):
    from repro_torch.kernels.conv1d import conv1d
    from repro_torch.kernels.conv1d.ref import causal_conv1d_ref
    B, T, W = CONV_BUILD_SHAPES[label]
    gen = torch.Generator(device=cuda).manual_seed(cw)
    x = torch.randn((B, T, W), generator=gen, device=cuda).to(dtype)
    w = (0.3 * torch.randn((cw, W), generator=gen, device=cuda)).to(dtype)
    whole = W % (16 // x.element_size()) == 0
    assert conv1d.build_of(x, w, x) == ("vector" if whole else "lane")
    if build == "vector" and not whole:
        with pytest.raises(ValueError, match="does not take"):
            conv1d.causal_conv1d_cuda(x, w, build=build)
        return
    want = causal_conv1d_ref(x, w)
    for rows in (1, 3, 64):
        got = conv1d.causal_conv1d_cuda(x, w, rows=rows, build=build)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (rows, float((got.float()
                                                     - want.float()).abs().max()))


def test_conv1d_off_a_16_byte_base_takes_the_lane_build(cuda):
    from repro_torch.kernels.conv1d import conv1d
    from repro_torch.kernels.conv1d.ref import causal_conv1d_ref
    flat = torch.randn(2 * 33 * 64 + 1, device=cuda).bfloat16()
    x = flat[1:].view(2, 33, 64)
    w = torch.randn((4, 64), device=cuda).bfloat16()
    assert conv1d.build_of(x, w, torch.empty_like(x)) == "lane"
    with pytest.raises(ValueError, match="does not take"):
        conv1d.causal_conv1d_cuda(x, w, build="vector")
    got = conv1d.causal_conv1d_cuda(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, causal_conv1d_ref(x, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 4099, 4096), (3, 37, 100)],
                         ids=["train", "ragged"])
def test_conv1d_backward_on_the_card(cuda, shape, dtype):
    """``CausalConv1dFn`` on the card (K6 forward, K6 on the reversed
    cotangent for dx, the f32 reduction for dw) against
    ``torch.autograd.grad`` of the plain version: dx sums the same taps in
    another order (f32 1e-6, bf16 one rounding, 8e-3 of the magnitude); dw
    sums B·T products in another order (f32 1e-4, bf16 8e-3)."""
    from repro_torch.kernels.conv1d import conv1d, ops
    from repro_torch.kernels.conv1d.ref import causal_conv1d_ref
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = (0.3 * torch.randn((4, shape[2]), generator=gen, device=cuda)).to(dtype)
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    n = conv1d.causal_conv1d_cuda.launches
    y = ops.CausalConv1dFn.apply(xa, wa)
    dx, dw = torch.autograd.grad(y, (xa, wa), g)
    torch.cuda.synchronize()
    assert conv1d.causal_conv1d_cuda.launches == n + 2
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    yr = causal_conv1d_ref(xr, wr)
    assert torch.equal(y, yr)
    rdx, rdw = torch.autograd.grad(yr, (xr, wr), g)
    f32 = dtype == torch.float32
    for got, want, tol in ((dx, rdx, 1e-6 if f32 else 8e-3),
                           (dw, rdw, 1e-4 if f32 else 8e-3)):
        assert got.dtype == want.dtype == dtype
        scale = max(1.0, float(want.float().abs().max()))
        assert float((got.float() - want.float()).abs().max()) <= tol * scale


def test_tiny_train_step_on_the_card_matches_the_cpu(cuda):
    """One AdamW step of tiny RecurrentGemma in f32 on the card (K6 in the
    forward, the recompute and dx) against the same step on the CPU (the
    plain conv): matmuls sum in another order, 1e-4 of the magnitude."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels.conv1d import conv1d
    from repro_torch.train import data, optimizer, train_loop
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.models import griffin
    cfg = dataclasses.replace(configs.tiny(configs.get("recurrentgemma-9b")),
                              dtype="float32", remat=True, attn_chunk=16)
    n_rec = griffin.block_types(cfg).count("rec")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=2)
    batch = data.make_batch_fn(cfg, shape, seed=0)(0)
    tc = train_loop.TrainConfig(opt=optimizer.OptConfig(warmup_steps=0))
    states = {}
    for dev in ("cpu", "cuda"):
        st = train_loop.init_state(cfg, device="cpu", seed=1)
        if dev == "cuda":
            st = {"params": optimizer.tree_map(lambda t: t.cuda(), st["params"]),
                  "opt": optimizer.tree_map(lambda t: t.cuda(), st["opt"]),
                  "step": 0}
        n = conv1d.causal_conv1d_cuda.launches
        st, m = train_loop.make_train_step(cfg, tc)(st, batch)
        torch.cuda.synchronize()
        launches = conv1d.causal_conv1d_cuda.launches - n
        # forward, recompute and dx of each recurrent layer
        assert launches == (0 if dev == "cpu" else 3 * n_rec)
        states[dev] = (st, float(m["loss"]))
    (cpu, lc), (gpu, lg) = states["cpu"], states["cuda"]
    assert abs(lc - lg) <= 1e-4 * abs(lc)
    for a, b in zip(optimizer.tree_leaves(gpu["opt"]),
                    optimizer.tree_leaves(cpu["opt"])):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("B,S,H,K,hd,bs", ATTN_SHAPES)
def test_decode_attn_kernel_matches_plain(cuda, B, S, H, K, hd, bs):
    from repro_torch.kernels.decode_attn.decode_attn import decode_attention_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((B, H, hd), generator=gen, device=cuda)
    k = torch.randn((B, S, K, hd), generator=gen, device=cuda)
    v = torch.randn((B, S, K, hd), generator=gen, device=cuda)
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=cuda,
                            dtype=torch.int32)
    n = decode_attention_cuda.launches
    got = decode_attention_cuda(q, k, v, lengths, block_s=bs)
    want = decode_attention_ref(q, k, v, lengths)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == n + 1
    _check(got, want, f"decode_attn {B, S, H, K, hd, bs}")


def test_decode_attn_kernel_bf16_and_masked_tail(cuda):
    from repro_torch.kernels.decode_attn.decode_attn import decode_attention_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).bfloat16()
               for s in ((2, 8, 32), (2, 64, 4, 32), (2, 64, 4, 32)))
    lengths = torch.tensor([5, 17], dtype=torch.int32, device=cuda)
    got = decode_attention_cuda(q, k, v, lengths, block_s=16)
    want = decode_attention_ref(q, k, v, lengths)
    k2, v2 = k.clone(), v.clone()
    k2[:, 32:] = 999.0
    v2[:, 32:] = -999.0
    got2 = decode_attention_cuda(q, k2, v2, lengths, block_s=16)
    zero = decode_attention_cuda(q, k, v, torch.zeros_like(lengths))
    torch.cuda.synchronize()
    assert torch.equal(got, got2)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 1e-2 * max(1.0, float(want.float().abs().max())), err
    assert bool((zero == 0).all())          # length 0: output 0, as on the TPU


# ---- bf16 grids on every stencil source ------------------------------------------
BF16_CASES = [("fused", "gmem", 1, None), ("fused", "shift", 1, None),
              ("fused", "shift", 2, None), ("fused", "semi", 1, None)]
BF16_CASES += [("map", t, 1, None) for t in MAP_TEMPLATES]
# a region whose rows start at odd element indices (K5 stages bf16 rows
# from the granule below, K4 gmem loads single cells) and whose z-start is
# not a multiple of 4 (f4)
BF16_CASES += [("map", t, 1, ((1, 20), (2, 29), (3, 46)))
               for t in ("semi", "f4", "gmem")]
BF16_SHAPE = (21, 30, 47)


def _bf16_ulp(scale):
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


@pytest.mark.parametrize("name", ["star3d4r", "acoustic"])
@pytest.mark.parametrize("case", BF16_CASES,
                         ids=[f"{c[0]}-{c[1]}-k{c[2]}{'-region' if c[3] else ''}"
                              for c in BF16_CASES])
def test_bf16_kernels_match_plain(cuda, name, case):
    kind, template, time_block, region = case
    k, swap, scal = _kernel(name)
    arrays, halos = _layout(k, BF16_SHAPE, cuda, 7)
    if name == "acoustic":       # coefficients in their physical ranges
        arrays["vp2"] = 0.5 + 1.5 * arrays["vp2"].abs().clamp(max=1)
        arrays["damp"] = 0.2 * arrays["damp"].abs().clamp(max=1)
    arrays = {g: t.bfloat16() for g, t in arrays.items()}
    if kind == "fused":
        plan = codegen.plan_cuda(k.ir, halos, BF16_SHAPE,
                                 st.hopper(template=template,
                                           time_block=time_block), swap=swap)
        padded = plan.to_padded(arrays)
        ref = {g: t.clone() for g, t in padded.items()}
        if time_block > 1:
            got, want = plan.make_spares(padded), plan.make_spares(padded)
            temporal_step(plan, padded, got, scal)
            temporal_step_plain(plan, padded, want, scal)
        else:
            kern, plain = {"gmem": (fused_step, fused_step_plain),
                           "shift": (stream_step, stream_step_plain),
                           "semi": (semi_step, semi_step_plain)}[template]
            kern(plan, padded, scal)
            plain(plan, ref, scal)
            got, want = padded, ref
        outs = plan.step_out_grids
    else:
        plan = codegen.lower_hopper(k.ir, halos, BF16_SHAPE, region,
                                    st.hopper(template=template))
        bufs = {g: arrays[g] for g in plan.opnd_grids}
        ref = {g: t.clone() for g, t in bufs.items()}
        kern, plain = MAP_WRAPPERS[plan.kind]
        kern(plan, bufs, scal, None)
        plain(plan, ref, scal, None)
        got, want, outs = bufs, ref, plan.out_grids
    torch.cuda.synchronize()
    for g in outs:
        assert got[g].dtype == torch.bfloat16
        assert bool(torch.isfinite(got[g]).all())
        scale = max(1.0, float(want[g].float().abs().max()))
        err = float((got[g].float() - want[g].float()).abs().max())
        assert err <= _bf16_ulp(scale), (name, case, g, err)


# ---- K7: the split over the sequence and its combine ------------------------------
@pytest.mark.parametrize("B,S,H,K,hd,dtype", [
    (8, 2048, 16, 1, 256, torch.bfloat16),     # RecurrentGemma's decode shape
    (1, 2048, 16, 1, 256, torch.bfloat16),
    (4, 1000, 8, 2, 128, torch.float32),
    (4, 300, 32, 1, 64, torch.bfloat16),       # 32 query heads to a KV head
], ids=["recurrentgemma", "B1", "gqa-f32", "G32"])
def test_decode_attn_split_and_combine_match_plain(cuda, B, S, H, K, hd, dtype):
    from repro_torch.kernels.decode_attn import decode_attn as da
    from repro_torch.kernels.decode_attn import ref as dref
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(sh, generator=gen, device=cuda).to(dtype)
               for sh in ((B, H, hd), (B, S, K, hd), (B, S, K, hd)))
    bs = da.DEFAULT_BLOCK_S
    splits, chunk = da.split_plan(B, K, S, bs, da.sm_count(0))
    special = [0, 1, S, chunk + 1]
    cases = ([torch.tensor(special + [S] * (B - 4), dtype=torch.int32,
                           device=cuda)] if B >= 4 else
             [torch.full((B,), n, dtype=torch.int32, device=cuda)
              for n in special])
    tol = 1e-2 if dtype == torch.bfloat16 else RTOL
    for lengths in cases:
        n = (da.decode_attention_cuda.launches, da.split_cuda.launches,
             da.combine_cuda.launches)
        got = da.decode_attention_cuda(q, k, v, lengths)
        assert (da.decode_attention_cuda.launches, da.split_cuda.launches,
                da.combine_cuda.launches) == tuple(c + 1 for c in n)
        want = dref.decode_attention_ref(q, k, v, lengths)
        acc, ml = da.split_cuda(q, k, v, lengths, bs, splits, chunk)
        racc, rml = dref.split_ref(q, k, v, lengths, splits, chunk)
        comb = da.combine_cuda(racc, rml, lengths, S, chunk, dtype)
        rcomb = dref.combine_ref(racc, rml, lengths, S, chunk, dtype)
        torch.cuda.synchronize()
        live = lengths > 0
        assert got.dtype == dtype and bool((got[~live] == 0).all())
        if bool(live.any()):
            err = float((got[live].float() - want[live].float()).abs().max())
            assert err <= tol * max(1.0, float(want[live].float().abs().max()))
        used = (torch.arange(splits, device=cuda)[None]
                < ((lengths + chunk - 1) // chunk)[:, None])
        sel = used[:, None, :].expand(-1, K, -1)
        if bool(sel.any()):         # a split holds positions
            for a, b in ((acc[sel], racc[sel]), (ml[sel], rml[sel])):
                _check(a, b, f"partials {lengths.tolist()}")
        err = float((comb.float() - rcomb.float()).abs().max())
        assert err <= tol * max(1.0, float(rcomb.float().abs().max()))


# ---- K2's and K3's staging paths (TMA and granules) -----------------------------
# K2 fused and with RT_MAP, K3 at k=2 and k=3, f32 and bf16: at 64³ (pitches
# of 72 cells, the TMA), 61 x 70 x 133 (rows of 141 cells: 4-byte granules)
# and, for K2's RT_MAP build, a region of 64³ whose z-start is 7 (the TMA
# box starts 3 cells before the plane; 7 in bf16) and one of the ragged
# shape (granules)
STREAM_REGIONS = {(64, 64, 64): ((1, 40), (0, 64), (7, 60)),
                  (61, 70, 133): ((5, 50), (3, 61), (10, 127))}
STREAM_CASES = []
for _n in ("star3d4r", "acoustic"):
    for _s in STREAM_REGIONS:
        STREAM_CASES.append(("fused", _n, _s, None, 1))
        STREAM_CASES += [("map", _n, _s, r, 1) for r in (None, STREAM_REGIONS[_s])]
        STREAM_CASES += [("fused", _n, _s, None, k) for k in (2, 3)]


def _stream_plan(kind, name, shape, region, time_block):
    k, swap, _ = _kernel(name)
    halos = {g: (k.info.order,) * 3 for g in k.ir.grid_params}
    if kind == "map":
        return codegen.lower_hopper(k.ir, halos, shape, region,
                                    st.hopper(template="shift"))
    return codegen.plan_cuda(k.ir, halos, shape,
                             st.hopper(template="shift", time_block=time_block),
                             swap=swap)


@pytest.fixture(scope="module")
def stream_built():
    """Every source of the stream cases, built in parallel (one nvcc each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.build_many([_stream_plan(*c).source(d) for c in STREAM_CASES
                       for d in (torch.float32, torch.bfloat16)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", STREAM_CASES,
                         ids=[f"{c[0]}-{c[1]}-{'x'.join(map(str, c[2]))}"
                              f"{'-region' if c[3] else ''}-k{c[4]}"
                              for c in STREAM_CASES])
def test_stream_paths_match_plain(cuda, stream_built, case, dtype):
    """K2 (fused, RT_MAP) and K3 on each staging path against their plain
    versions: f32 within 2e-5 x max(1, |plain|), bf16 within one bf16 ulp
    (both compute in f32 and round once)."""
    kind, name, shape, region, time_block = case
    k, _, scal = _kernel(name)
    plan = _stream_plan(*case)
    assert set(plan.stream_tma(dtype).values()) == {shape == (64, 64, 64)}
    gen = torch.Generator(device=cuda).manual_seed(10)
    full = {g: torch.randn(tuple(s + 2 * k.info.order for s in shape), generator=gen,
                           device=cuda) for g in k.ir.grid_params}
    if name == "acoustic":       # coefficients in their physical ranges
        full["vp2"] = 0.5 + 1.5 * full["vp2"].abs().clamp(max=1)
        full["damp"] = 0.2 * full["damp"].abs().clamp(max=1)
    full = {g: t.to(dtype) for g, t in full.items()}
    if kind == "map":
        bufs = {g: full[g] for g in plan.opnd_grids}
        ref = {g: t.clone() for g, t in bufs.items()}
        n = stream_step.launches
        stream_step(plan, bufs, scal, None)
        stream_step_plain(plan, ref, scal, None)
        got, want, outs = bufs, ref, plan.out_grids
        assert stream_step.launches == n + 1
    else:
        padded = plan.to_padded(full)
        if time_block > 1:
            before = {g: t.clone() for g, t in padded.items()}
            got, want = plan.make_spares(padded), plan.make_spares(padded)
            n = temporal_step.launches
            temporal_step(plan, padded, got, scal)
            temporal_step_plain(plan, padded, want, scal)
            torch.cuda.synchronize()
            assert temporal_step.launches == n + 1
            for g, t in padded.items():
                assert torch.equal(t, before[g]), f"wrote its read buffer {g}"
        else:
            want = {g: t.clone() for g, t in padded.items()}
            n = stream_step.launches
            stream_step(plan, padded, scal)
            stream_step_plain(plan, want, scal)
            got = padded
            assert stream_step.launches == n + 1
        outs = plan.step_out_grids
    torch.cuda.synchronize()
    for g in outs:
        assert bool(torch.isfinite(got[g]).all())
        scale = max(1.0, float(want[g].float().abs().max()))
        err = float((got[g].float() - want[g].float()).abs().max())
        tol = RTOL * scale if dtype == torch.float32 else _bf16_ulp(scale)
        assert err <= tol, (case, g, err)


# ---- the cost model and the autotuner on the card ------------------------------
def _autotune_grids(cuda):
    return suite.make_grids("star3d4r", (64, 64, 64), seed=5, device=cuda)


def test_autotune_on_the_card_exhaustive_and_two_stage(cuda, tmp_path):
    """64³ star3d4r: every candidate of the default space measured once
    (after one build wave), the two-stage search measuring 3 of them, both
    winners finite, and the two-stage winner's 20 steps vs ``st.torch()``."""
    from repro_torch.core import autotune as at, cost_model as cm
    at.clear_cache()
    at.reset_measure_count()
    k = suite.get_kernel("star3d4r")
    model = cm.CostModel(cache_dir=str(tmp_path), device=cuda)
    two = at.tune(k, _autotune_grids(cuda), iters=1, swap=("v", "u"),
                  steps=8, top_k=3, cost_model=model)
    ex = at.tune(k, _autotune_grids(cuda), iters=1, swap=("v", "u"), steps=8,
                 top_k=None, cost_model=model)
    assert two.measured_candidates == 3
    assert two.pruned_candidates == len(two.predicted) - 3
    assert ex.measured_candidates == len(ex.predicted) == len(two.predicted)
    assert math.isfinite(two.seconds) and math.isfinite(ex.seconds)
    assert two.rank_error is not None and ex.rank_error is not None
    # the two-stage tune calibrated every class; the exhaustive one reuses
    assert two.timing["calibrate"] > 0 and ex.timing["calibrate"] < 0.05
    out = []
    for be, fuse in ((st.torch(), None), (two.backend, two.fuse_steps)):
        g = _autotune_grids(cuda)
        st.launch(backend=be, fuse_steps=fuse)(
            lambda u, v: st.timeloop(20, swap=("v", "u"))(k)(u, v))(
            g["u"], g["v"])
        out.append(g)
    for n in ("u", "v"):
        _check(out[1][n].data, out[0][n].data, n)
    at.clear_cache()


def test_probe_writes_and_reloads_the_calibration(cuda, tmp_path):
    from repro_torch.core import cost_model as cm
    k = suite.get_kernel("star3d4r")
    grids = _autotune_grids(cuda)
    probe = cm._Probe(k, grids, ("v", "u"), {})
    model = cm.CostModel(cache_dir=str(tmp_path), device=cuda)
    model.calibrate_classes(probe, ["hopper-K1", "hopper-K2", "torch"])
    rates = {key: model.rate_for(key, torch.float32, probe)
             for key in ("hopper-K1", "hopper-K2", "torch")}
    for r in rates.values():
        assert 1e9 < r.bytes_per_s < 1e13 and 1e-8 <= r.overhead_s < 1e-1
    (path,) = tmp_path.glob("roofline-*.json")
    assert path.name == (f"roofline-v{cm.CALIBRATION_VERSION}-"
                         f"{cm.device_tag(cuda)}.json")
    again = cm.CostModel(cache_dir=str(tmp_path), calibrate=False, device=cuda)
    assert {key: again.rate_for(key, torch.float32, probe)
            for key in rates} == rates


def test_autotune_disk_cache_hit_measures_nothing(cuda, tmp_path):
    from repro_torch.core import autotune as at, cost_model as cm
    k = suite.get_kernel("star3d4r")
    kw = dict(iters=1, swap=("v", "u"), steps=4, fuse_space=(4,),
              time_block_space=(1,), cache_dir=str(tmp_path),
              space=[st.hopper(template="gmem"), st.hopper(template="shift")])
    at.clear_cache()
    cold = at.tune(k, _autotune_grids(cuda), **kw)
    at.clear_cache()
    cm.reset_default_models()
    at.reset_measure_count()
    warm = at.tune(k, _autotune_grids(cuda), **kw)
    assert at.MEASURE_COUNT["measured_candidates"] == 0
    assert warm.backend == cold.backend and warm.trials == cold.trials
    at.clear_cache()


def test_autotune_per_application_on_the_card(cuda, tmp_path):
    """Without a swap pair the tuner times single ``st.map`` applications:
    the K4/K2-map/K5-map classes probed at two sizes, 3 of the default
    space's candidates measured, the winner's application vs
    ``st.torch()``."""
    from repro_torch.core import autotune as at, cost_model as cm
    at.clear_cache()
    k = suite.get_kernel("star3d4r")
    model = cm.CostModel(cache_dir=str(tmp_path), device=cuda)
    res = at.tune(k, _autotune_grids(cuda), iters=1, top_k=3, cost_model=model)
    assert res.measured_candidates == 3 and math.isfinite(res.seconds)
    assert {key.split("@")[0] for key in model._rates} == {
        "torch-map", "hopper-K4-gmem", "hopper-K4-f4", "hopper-K4-smem",
        "hopper-K2-map", "hopper-K5-map"}
    out = []
    for be in (st.torch(), res.backend):
        g = _autotune_grids(cuda)
        st.launch(backend=be)(lambda u, v: st.map(e=u.shape)(k)(u, v))(
            g["u"], g["v"])
        out.append(g)
    _check(out[1]["v"].data, out[0]["v"].data, "v")
    at.clear_cache()


# ---- batch=B: one launch advances every scenario -----------------------------
BATCH_CASES = [("star3d4r", (20, 24, 70)), ("acoustic", (18, 22, 40)),
               ("tapped_coef", (45, 77))]
BATCH_BACKENDS = [("gmem", 1), ("shift", 1), ("shift", 2), ("shift", 3), ("semi", 1)]


def _batched_grids(k, shape, dtype, device, nb, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    h = k.info.order
    return {g: st.grid(dtype=dtype, shape=shape, order=h, device=device, batch=nb,
                       data=torch.randn((nb,) + tuple(s + 2 * h for s in shape),
                                        generator=gen, device=device).to(dtype))
            for g in k.ir.grid_params}


def _launches():
    return (fused_step.launches, stream_step.launches, temporal_step.launches,
            semi_step.launches)


@pytest.fixture(scope="module")
def batch_built():
    """Every source the batch and adjoint cases run, built in parallel (one
    nvcc each): the window's plan and the single-step plan of K3's
    remainders."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import timeloop
    cases = [(name, shape, t, kb, d) for name, shape in BATCH_CASES
             for t, kb in BATCH_BACKENDS for d in (torch.float32, torch.bfloat16)
             if not (t == "semi" and name == "tapped_coef")]
    cases += [("acoustic", (14, 16, 18), t, kb, torch.float32)
              for t, kb in (("gmem", 1), ("shift", 2), ("semi", 1))]
    sources = []
    for name, shape, t, kb, d in cases:
        k, swap, _ = _kernel(name)
        halos = {g: (k.info.order,) * k.ir.ndim for g in k.ir.grid_params}
        for plan in timeloop.hopper_plans(k.ir, halos, shape,
                                          st.hopper(template=t, time_block=kb), swap):
            sources.append(plan.source(d))
    _build.build_many(sources)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("template,time_block", BATCH_BACKENDS,
                         ids=[f"{t}-k{k}" for t, k in BATCH_BACKENDS])
@pytest.mark.parametrize("name,shape", BATCH_CASES, ids=[c[0] for c in BATCH_CASES])
def test_batched_kernels_equal_serial_runs(cuda, batch_built, name, shape, template,
                                           time_block, dtype):
    """Each scenario of a batched loop equals its own unbatched run bit for
    bit, and a window launches as many kernels as the unbatched window."""
    k, swap, scal = _kernel(name)
    if template == "semi" and name == "tapped_coef":
        pytest.skip("semi takes kernels linear in their taps")
    nb, steps, fuse = 3, 5, 3
    be = st.hopper(template=template, time_block=time_block)
    grids = _batched_grids(k, shape, dtype, cuda, nb, 4)
    serial, per_run = [], None
    for b in range(nb):
        one = {g: st.grid(dtype=dtype, shape=shape, order=x.order, device=cuda,
                          data=x.data[b].clone()) for g, x in grids.items()}
        n0 = _launches()
        st.launch(backend=be)(lambda: st.timeloop(steps, swap=swap, fuse_steps=fuse)(k)(
            *[one[g] for g in k.ir.grid_params], *scal.values()))()
        per_run = [a - c for a, c in zip(_launches(), n0)]
        serial.append(one)
    n0 = _launches()
    st.launch(backend=be)(lambda: st.timeloop(steps, swap=swap, fuse_steps=fuse, batch=nb)(k)(
        *[grids[g] for g in k.ir.grid_params], *scal.values()))()
    assert [a - c for a, c in zip(_launches(), n0)] == per_run
    for b in range(nb):
        for g in grids:
            assert torch.equal(grids[g].data[b], serial[b][g].data), (name, g, b)


@pytest.mark.parametrize("template,time_block", BATCH_BACKENDS,
                         ids=[f"{t}-k{k}" for t, k in BATCH_BACKENDS])
def test_batched_per_scenario_scalars_on_the_card(cuda, batch_built, template, time_block):
    """(B, NS) scalars: each scenario's kernel reads its own row; the launch
    matches its plain version and each scenario its serial run."""
    k = acoustic.acoustic_iso_kernel
    shape, nb = (18, 22, 40), 3
    dts = torch.tensor([0.2, 0.25, 0.3])
    be = st.hopper(template=template, time_block=time_block)
    grids = _batched_grids(k, shape, torch.float32, cuda, nb, 5)
    plan = codegen.plan_cuda(k.ir, {g: x.halo for g, x in grids.items()}, shape, be,
                             swap=("p0", "p1"))
    sc = plan.scenario_scalars({"dt": dts}, nb, cuda)
    padded = plan.to_padded({g: x.data.clone() for g, x in grids.items()})
    ref = {g: t.clone() for g, t in padded.items()}
    if time_block > 1:
        spares, rsp = plan.make_spares(padded), plan.make_spares(ref)
        temporal_step(plan, padded, spares, sc)
        temporal_step_plain(plan, ref, rsp, sc)
        got, want = spares, rsp
    else:
        plan.step(padded, sc)
        {"fused": fused_step_plain, "stream": stream_step_plain,
         "semi": semi_step_plain}[plan.kind](plan, ref, sc)
        got, want = padded, ref
    for g in plan.step_out_grids:
        _check(got[g], want[g], (template, g))
    serial = []
    for b in range(nb):
        one = [st.grid(dtype=torch.float32, shape=shape, order=x.order, device=cuda,
                       data=x.data[b].clone()) for x in grids.values()]
        st.launch(backend=be)(lambda: st.timeloop(4, swap=("p0", "p1"))(k)(
            *one, float(dts[b])))()
        serial.append(one)
    st.launch(backend=be)(lambda: st.timeloop(4, swap=("p0", "p1"), batch=nb)(k)(
        *grids.values(), dts))()
    for b in range(nb):
        for x, y in zip(grids.values(), serial[b]):
            assert torch.equal(x.data[b], y.data)
    assert not torch.equal(grids["p1"].data[0], grids["p1"].data[2])


@pytest.mark.parametrize("template,time_block", [("gmem", 1), ("shift", 2), ("semi", 1)])
def test_hopper_adjoint_matches_torch_adjoint(cuda, batch_built, template, time_block):
    """The adjoint under st.hopper (forward and replay on the kernels, the
    cotangents through the torch lowering) against the same adjoint under
    st.torch(): every gradient within 1e-3 of its max."""
    nb = 2
    p0, p1, vp2, damp, dt = acoustic.make_fields((14, 16, 18), pml_width=3,
                                                 device=cuda, batch=nb)
    p1.randomize(3, 0.1)
    vp2.interior = vp2.interior * (1.0 + 0.1 * torch.rand(vp2.interior.shape, device=cuda))

    def between(t, g):
        acoustic.inject_source(g["p1"], t, pos=[(4, 5, 6), (9, 8, 7)])

    grads = {}
    for be in (st.torch(), st.hopper(template=template, time_block=time_block)):
        fn = st.differentiable_timeloop(acoustic.acoustic_iso_kernel, p0, p1, vp2, damp,
                                        dt, steps=9, swap=("p0", "p1"),
                                        between=between, backend=be)
        arrays = {n: a.detach().clone().requires_grad_() for n, a in fn.arrays.items()}
        d = torch.tensor(float(dt), device=cuda, requires_grad=True)
        out = fn(arrays, {"dt": d})
        (out["p1"] ** 2).sum().backward()
        grads[be.kind] = {**{n: a.grad for n, a in arrays.items()}, "dt": d.grad}
    for n, want in grads["torch"].items():
        got = grads["hopper"][n]
        assert bool(torch.isfinite(got).all()), n
        err = float((got - want).abs().max())
        assert err <= 1e-3 * float(want.abs().max()), (n, err)


# ---- resilience and masked serving windows -------------------------------------
def test_run_resilient_on_k1_is_bit_exact(cuda, tmp_path):
    """run_resilient under st.hopper(template="gmem") (K1) at 64³ with two
    injected failures: bit for bit the uninterrupted engine.run, one restart
    a failure, the caller's tensors left as given."""
    from repro_torch.core import timeloop
    from repro_torch.train.fault_tolerance import FailureInjector
    k = acoustic.acoustic_iso_kernel
    shape = (64, 64, 64)
    fields = acoustic.make_fields(shape, pml_width=6, device=cuda)
    acoustic.inject_source(fields[1], 0)
    arrays = {n: f.data for n, f in zip(("p0", "p1", "vp2", "damp"), fields)}
    first = {n: a.clone() for n, a in arrays.items()}
    halos = {n: f.halo for n, f in zip(arrays, fields)}

    def engine():
        return timeloop.TimeloopEngine(k.ir, halos, shape, st.hopper(template="gmem"),
                                       swap=("p0", "p1"))

    def between(t, a):
        a["p1"][tuple(4 + s // 2 for s in shape)] += acoustic.source_wavelet(t)
        return a

    scal = {"dt": float(fields[4])}
    ref = engine().run({n: a.clone() for n, a in first.items()}, scal, 30, 5, between)
    inj, restarts = FailureInjector([1, 4]), []
    n0 = fused_step.launches
    got = timeloop.run_resilient(engine(), arrays, scal, 30, 5, between,
                                 ckpt_dir=str(tmp_path / "ck"), ckpt_every=2, injector=inj,
                                 on_restart=lambda n, e: restarts.append(str(e)))
    assert fused_step.launches - n0 >= 30
    assert inj.fired == [1, 4] and len(restarts) == 2
    for n in ref:
        assert torch.equal(got[n], ref[n]), n
        assert torch.equal(arrays[n], first[n]), n


def test_masked_window_on_the_card_matches_the_cpu(cuda):
    from repro_torch.core import timeloop
    k = suite.get_kernel("star3d4r")
    shape, nb = (20, 24, 30), 3
    gen = torch.Generator().manual_seed(6)
    arrays = {g: torch.randn((nb,) + tuple(s + 8 for s in shape), generator=gen)
              for g in ("u", "v")}
    mask = torch.ones((nb,) + shape, dtype=torch.bool)
    mask[1, :, 10:] = False
    mask[2, :7] = False
    limits = torch.tensor([9, 4, 0], dtype=torch.int32)
    eng = timeloop.TimeloopEngine(k.ir, {g: (4, 4, 4) for g in arrays}, shape, st.torch(),
                                  swap=("v", "u"), batch=nb)
    want = eng.run({g: a.clone() for g, a in arrays.items()}, {}, 9, 4, domain_mask=mask,
                   step_limits=limits)
    got = eng.run({g: a.to(cuda) for g, a in arrays.items()}, {}, 9, 4,
                  domain_mask=mask.to(cuda), step_limits=limits)
    for g in arrays:
        _check(got[g].cpu(), want[g], ("masked", g))
        assert torch.equal(got[g][2].cpu(), arrays[g][2])   # budget 0: untouched


def test_async_checkpoint_snapshots_a_cuda_tensor(cuda, tmp_path):
    """save(blocking=False) copies every leaf off the card before it
    returns: a kernel that overwrites the tensor right after the save does
    not reach the checkpoint."""
    from repro_torch.train import checkpoint
    x = torch.randn(1 << 22, device=cuda)
    b = torch.randn(1 << 16, device=cuda).to(torch.bfloat16)
    before = (x.cpu().clone(), b.cpu().clone())
    checkpoint.save(str(tmp_path / "ck"), 1, {"x": x, "b": b}, blocking=False)
    x.mul_(-2.0).add_(1.0)
    b.zero_()
    checkpoint.wait()
    got = checkpoint.restore(str(tmp_path / "ck"), {"x": x, "b": b})
    assert got["x"].device == x.device and got["x"].data_ptr() != x.data_ptr()
    assert torch.equal(got["x"].cpu(), before[0])
    assert torch.equal(got["b"].cpu().view(torch.int16), before[1].view(torch.int16))


# -- the distributed layer on the card ---------------------------------------------
# a (2, 2) mesh on one card: every pass of a shard under a hopper inner is K4
# (or K2's ``RT_MAP`` build) on a region of the shard's padded tensors
SHARD_TEMPLATES = ("gmem", "f4", "smem", "shift")


def _card_mesh():
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((2, 2), ("data", "model"))


@pytest.mark.parametrize("template", SHARD_TEMPLATES)
@pytest.mark.parametrize("ts", [1, 2])
def test_sharded_regions_match_plain(cuda, template, ts):
    """K4 on the regions of a sharded window (sub-steps on shrinking
    regions, the deep interior, the bands; written in place or into the
    spare) against its plain version on the same CUDA tensors."""
    from repro_torch.core import timeloop as tl
    k = acoustic.acoustic_iso_kernel
    halos = {g: (acoustic.ORDER,) * 3 for g in k.ir.grid_params}
    be = st.distributed(grid_axes=("data", "model", None), time_steps=ts,
                        inner=st.hopper(template=template))
    eng = tl.TimeloopEngine(k.ir, halos, (48, 40, 36), be, swap=("p0", "p1"),
                            mesh=_card_mesh())
    win = eng.distributed_window(4, 4)
    _build.build_many([p.source(torch.float32) for p in win.plans()])
    rng = np.random.default_rng(ts)
    lay = win.layout
    wrapper = {"map": (map_step, map_step_plain),
               "stream": (stream_step, stream_step_plain)}
    for _, _, steps, pre, bands in win._fns.values():
        for op in [*steps, pre, *bands]:
            if op is None:
                continue
            plan = op.plan
            bufs = {g: torch.from_numpy(rng.standard_normal(lay.shape(g)).astype(
                np.float32)).to(cuda) for g in k.ir.grid_params}
            # coefficients in their physical ranges, as the other tests'
            bufs["vp2"] = 0.5 + 1.5 * bufs["vp2"].abs().clamp(max=1)
            bufs["damp"] = 0.2 * bufs["damp"].abs().clamp(max=1)
            out = {"p0": torch.zeros_like(bufs["p0"])}
            kern, plain = wrapper[plan.kind]
            for dst in (None, out):
                a = {g: t.clone() for g, t in bufs.items()}
                b = {g: t.clone() for g, t in bufs.items()}
                da = None if dst is None else {"p0": out["p0"].clone()}
                db = None if dst is None else {"p0": out["p0"].clone()}
                kern(plan, {g: a[g] for g in plan.opnd_grids}, {"dt": 0.3}, da)
                plain(plan, {g: b[g] for g in plan.opnd_grids}, {"dt": 0.3}, db)
                got = a["p0"] if dst is None else da["p0"]
                want = b["p0"] if dst is None else db["p0"]
                err = float((got - want).abs().max())
                assert err <= RTOL * max(1.0, float(want.abs().max())), (op.region, err)


@pytest.mark.parametrize("ts,overlap", [(1, True), (1, False), (2, True)])
def test_sharded_window_matches_unsharded(cuda, ts, overlap):
    """Acoustic ISO through ``st.timeloop`` on a (2, 2) mesh of the card
    under K4 gmem against the unsharded K1 run (interiors, 2e-5 of the
    field's max), the launches those ``HaloSpec`` implies."""
    from repro_torch.core import distributed as dist
    mesh = _card_mesh()
    shape, steps, fuse = (64, 48, 40), 12, 4

    def run(backend, m):
        p0, p1, vp2, damp, dt = acoustic.make_fields(shape, pml_width=6)
        acoustic.inject_source(p1, 0)

        def between(t, grids):
            acoustic.inject_source(grids["p1"], t)
        map_step.launches = 0
        st.launch(backend=backend, mesh=m, fuse_steps=fuse)(
            acoustic.acoustic_target_fused)(p0, p1, vp2, damp, dt, steps,
                                            between=between)
        inner = tuple(slice(4, 4 + n) for n in shape)
        return p0.data[inner], p1.data[inner], map_step.launches

    want = run(st.hopper(template="gmem"), None)
    be = st.distributed(grid_axes=("data", "model", None), time_steps=ts,
                        overlap=overlap, inner=st.hopper(template="gmem"))
    got = run(be, mesh)
    scale = max(float(want[0].abs().max()), float(want[1].abs().max()))
    for a, b in zip(got[:2], want[:2]):
        assert float((a - b).abs().max()) <= RTOL * scale
    from repro_torch.core.halo import HaloSpec
    spec = HaloSpec.build({"p0": (0,) * 3, "p1": (4,) * 3, "vp2": (0,) * 3,
                           "damp": (0,) * 3}, ("data", "model", None), shape,
                          {"data": 2, "model": 2}, depth=ts, swap=("p0", "p1"))
    assert got[2] == 4 * (steps // fuse) * dist.launch_counts(spec, fuse, overlap)


@pytest.mark.parametrize("name,kw", [
    ("granite-8b", {"n_layers": 1}), ("mixtral-8x7b", {"n_layers": 1}),
    ("pixtral-12b", {"n_layers": 1}), ("xlstm-1.3b", {"n_layers": 2}),
    ("whisper-small", {"n_layers": 2, "n_enc_layers": 1, "n_dec_layers": 1})],
    ids=["dense", "moe", "vlm", "ssm", "audio"])
def test_lm_family_loss_and_grads_on_the_card_match_the_cpu(cuda, name, kw):
    """``chip_smoke.py`` phase 15 (d) at tiny widths: one layer of each
    family (xLSTM one (mLSTM, sLSTM) cycle, whisper 1 + 1), f32, TF32 off,
    the loss and every gradient leaf on the card against the CPU on the
    same parameters: the loss within 1e-5 relative, a leaf within 1e-4 of
    its max; a leaf that f32 rounding alone moves further (xLSTM's mLSTM
    normalizer) is held to the CPU in f64 instead, within 1e-9."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.models import api
    from repro_torch.train import data, optimizer, train_loop
    cfg = dataclasses.replace(configs.tiny(configs.get(name)), dtype="float32",
                              **kw)
    seq = {"vlm": 64 + cfg.n_prefix_tokens, "audio": 128}.get(cfg.family, 64)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq, global_batch=2)
    batch = data.make_batch_fn(cfg, shape, seed=0)(0)
    params = api.init_params(cfg, device="cpu", seed=1)

    def run(dev, dt):
        c = dataclasses.replace(cfg, dtype=dt, param_dtype=dt)
        p = optimizer.tree_map(lambda t: t.to(dev, getattr(torch, dt)), params)
        loss, g = train_loop.make_loss_and_grad(c)(
            p, {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        return float(loss), [x.cpu() for x in optimizer.tree_leaves(g)]

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        (lg, got), (lc, want) = run("cuda", "float32"), run("cpu", "float32")
        assert abs(lg - lc) <= 1e-5 * abs(lc)
        over = [i for i, (g, w) in enumerate(zip(got, want))
                if float((g - w).abs().max()) > 1e-4 * float(w.abs().max())]
        if over:
            (_, got64), (_, want64) = run("cuda", "float64"), run("cpu", "float64")
            for i in over:
                assert float((got64[i] - want64[i]).abs().max()) <= \
                    1e-9 * float(want64[i].abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "granite-8b"])
def test_sharded_step_on_the_card_matches_the_cpu(cuda, name):
    """``chip_smoke.py`` phase 16 (a) at tiny widths: one sharded AdamW step
    on a (2, 2) mesh of the card (Griffin: K6 on each model shard's slice,
    forward, recompute and dx, 3 x recurrent layers x 2 model shards x 2
    data groups launches) against the unsharded step on the CPU, f32, TF32
    off: loss 1e-5 relative, the moments within 1e-4 of each leaf's max."""
    import dataclasses
    from repro_torch import configs, sharding
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.kernels.conv1d import conv1d
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import griffin
    from repro_torch.train import data, optimizer, train_loop
    cfg = dataclasses.replace(configs.tiny(configs.get(name)), dtype="float32",
                              remat=True)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=4)
    batch = data.make_batch_fn(cfg, shape, seed=0)(0)
    tc = train_loop.TrainConfig(opt=optimizer.OptConfig(warmup_steps=0))
    mesh = make_mesh((2, 2), ("data", "model"))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        state = sharding.device_put(train_loop.init_state(cfg, device="cpu", seed=1),
                                    train_loop.state_shardings(cfg, mesh))
        _, step = train_loop.compile_train_step(cfg, tc, mesh, batch)
        n = conv1d.causal_conv1d_cuda.launches
        state, m = step(state, batch)
        torch.cuda.synchronize()
        n_rec = griffin.block_types(cfg).count("rec") if cfg.family == "hybrid" else 0
        assert conv1d.causal_conv1d_cuda.launches - n == 3 * n_rec * 2 * 2
        ref, mr = train_loop.make_train_step(cfg, tc)(
            train_loop.init_state(cfg, device="cpu", seed=1), batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(float(m["loss"]) - float(mr["loss"])) <= 1e-5 * abs(float(mr["loss"]))
    got = sharding.gather(state["opt"], device="cpu")
    for a, b in zip(optimizer.tree_leaves(got), optimizer.tree_leaves(ref["opt"])):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-30)
