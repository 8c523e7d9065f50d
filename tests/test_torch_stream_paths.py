"""K2 (2.5D streaming, also K4's streaming build of ``st.map``) and K3
(temporal blocking): the staging path and tile each plan picks, their ring
geometry, and their plain versions in the new geometry.

K2 keeps each grid with an off-center tap in a ring of ``2H + 1 +
STREAM_PREFETCH`` planes of an 8 x 64 tile (``csrc/stream_ring.cuh``), K3
its read swap buffer in a ring of ``2h0 + 1 + TEMPORAL_PREFETCH`` planes of
the tile widened by ``k·h`` and each sub-step's values in rings of ``h0 -
dlo + 1`` planes and per-thread register queues
(``csrc/temporal_ring.cuh``).  The TMA copies a ring's planes where both
pitches of the grid's buffer and the tile's width are multiples of 16
bytes (``_Plan.stream_tma``; the box then starts ``lead`` cells before the
plane, on a 16-byte boundary), 4-byte ``cp.async`` granules elsewhere.
Both headers are compiled here with ``g++`` and held against the Python
layout (``_Plan.ring_layout``).

The plain versions walk the kernels' ring slots, prefetch order and
queues (one tile spanning the plane) and are held against the JAX
package: the fused path against its xla window (its fused Pallas path
fails under JAX 0.9.0), K4 streaming against ``ops.stencil_apply(...,
interpret=True)``.  Tolerance: f32 atol 1e-5 (the same expression tree,
another summation order), 1e-4 of the field's max for acoustic over
several steps; bf16 atol 1e-1 (the port computes in f32 and rounds once,
the JAX package rounds every operation).  The CUDA code runs only on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import acoustic as jacoustic  # noqa: E402
from repro.core import lowering as jlowering  # noqa: E402
from repro.core import suite as jsuite  # noqa: E402
from repro.kernels.stencil import ops as jops  # noqa: E402
from repro_torch.core import acoustic, regions, suite  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stencil import codegen, ops  # noqa: E402

ATOL = 1e-5
BF16_ATOL = 1e-1


def _kernels(name):
    if name == "acoustic":
        return acoustic.acoustic_iso_kernel, jacoustic.acoustic_iso_kernel
    return suite.get_kernel(name), jsuite.get_kernel(name)


def _swap(name):
    return ("p0", "p1") if name == "acoustic" else suite.swap_pair(name)


def _fused(name, interior, template="shift", time_block=1, block=None):
    k, _ = _kernels(name)
    halos = {g: (k.info.order,) * k.ir.ndim for g in k.ir.grid_params}
    return codegen.plan_cuda(k.ir, halos, interior,
                             st.hopper(template=template, time_block=time_block,
                                       block=block), swap=_swap(name))


def _map(name, interior, region=None, block=None):
    k, _ = _kernels(name)
    halos = {g: (k.info.order,) * k.ir.ndim for g in k.ir.grid_params}
    return codegen.lower_hopper(k.ir, halos, interior, region,
                                st.hopper(template="shift", block=block))


# ---- the staging path and the tile ---------------------------------------------
# (plan, dtype, TMA, lead): layout buffers of 72-cell rows (16-byte
# pitches), of 141-cell rows (granules), a region whose first cell is 3
# mod 4 (the box starts 3 cells early, 7 in bf16), K3's ring widened by
# k·h, 2D, and a tile whose width is no 16-byte multiple
PATHS = [
    ("fused-64", lambda: _fused("star3d4r", (64, 64, 64)), torch.float32, True, 0),
    ("fused-64-bf16", lambda: _fused("star3d4r", (64, 64, 64)), torch.bfloat16, True, 0),
    ("fused-ragged", lambda: _fused("star3d4r", (61, 70, 133)), torch.float32, False, 0),
    ("acoustic-512", lambda: _fused("acoustic", (512, 512, 512)), torch.float32, True, 0),
    ("map-region7", lambda: _map("star3d4r", (64, 64, 64), ((1, 40), (0, 64), (7, 60))),
     torch.float32, True, 3),
    ("map-region7-bf16", lambda: _map("star3d4r", (64, 64, 64), ((1, 40), (0, 64), (7, 60))),
     torch.bfloat16, True, 7),
    ("map-ragged", lambda: _map("star3d4r", (61, 70, 133)), torch.float32, False, 0),
    ("k2-64", lambda: _fused("star3d4r", (64, 64, 64), time_block=2), torch.float32, True, 0),
    ("k2-64-bf16", lambda: _fused("star3d4r", (64, 64, 64), time_block=2),
     torch.bfloat16, True, 4),
    ("k3-ragged", lambda: _fused("star3d4r", (61, 70, 133), time_block=3),
     torch.float32, False, 0),
    ("2d-128", lambda: _fused("star2d4r", (64, 128)), torch.float32, True, 0),
    ("2d-ragged", lambda: _fused("star2d4r", (61, 133)), torch.float32, False, 0),
    ("narrow-tile", lambda: _fused("star3d4r", (64, 64, 64), block=(8, 4, 6)),
     torch.float32, False, 0),
]


@pytest.mark.parametrize("make,dtype,tma,lead", [p[1:] for p in PATHS],
                         ids=[p[0] for p in PATHS])
def test_stream_path_is_chosen_from_the_pitches(make, dtype, tma, lead):
    plan = make()
    lay = plan.ring_layout(dtype)
    ring = lay.planes[-1] if plan.kind == "temporal" else lay.planes[plan.ring_grids()[0]]
    assert set(plan.stream_tma(dtype).values()) == {tma}
    assert (ring.tma, ring.lead) == (tma, lead)
    es = codegen.ELEM_BYTES[dtype]
    assert ring.pitch * es % 16 == 0 and ring.pitch >= ring.lead + ring.w2
    if tma:
        assert ring.pitch <= codegen.TMA_BOX_MAX and ring.w1 <= codegen.TMA_BOX_MAX
    # the path is part of the source, so of the build key
    src = plan.source(dtype)
    assert "grid_tma" in src and f"#define RT_PRE" in src


@pytest.mark.parametrize("name", ("star3d4r", "acoustic"))
def test_tile_is_chosen_by_time_block(name):
    """K2 takes an 8 x 64 tile; K3 the first of ``TEMPORAL_BLOCKS`` whose
    rings fit 227 KB: 16 x 64 at k=2, 16 x 32 at k=3 for a halo of 4."""
    want = {1: (64, 8, 64), 2: (128, 16, 64), 3: (128, 16, 32)}
    for k, B in want.items():
        plan = _fused(name, (512, 512, 512), time_block=k)
        assert plan.B == B, k
        assert plan.smem_bytes == plan.ring_layout().smem <= codegen.SMEM_LIMIT
        assert plan.kind == ("stream" if k == 1 else "temporal")
    # sub-step 0 over 24 x 72 cells for 16 x 64 outputs at k=2 (1.69
    # evaluations a point), and ring -1 stages 32 x 80 cells
    lay = _fused(name, (512, 512, 512), time_block=2).ring_layout()
    assert (lay.planes[-1].w1, lay.planes[-1].w2) == (32, 80)
    assert (lay.planes[0].w1, lay.planes[0].w2) == (24, 72)
    assert lay.slots == {-1: 9 + codegen.TEMPORAL_PREFETCH, 0: 5}
    assert codegen.temporal_threads((128, 16, 64), (4, 4, 4), 2) == (864, 2)
    assert codegen.temporal_threads((128, 16, 32), (4, 4, 4), 3) == (768, 2)


def test_ring_dlo_follows_the_taps():
    """Rings of sub-step values keep the planes taps leaving the column
    read: a star only its own plane (h0 + 1 slots), a box 2h0 + 1."""
    assert _fused("star3d4r", (16, 16, 16), time_block=2).temporal_dlo() == 0
    box = _fused("box3d1r", (16, 16, 16), time_block=2)
    assert box.temporal_dlo() == -1
    assert box.ring_layout().slots[0] == 3


def test_shared_memory_budget_raises():
    with pytest.raises(ValueError, match=r"stream tile of block \(8, 1, 1024\) "
                                         r"needs \d+ B of shared memory"):
        _fused("star3d4r", (16, 16, 1024), block=(8, 1, 1024))
    with pytest.raises(ValueError, match=r"shift tile of block \(8, 1, 1024\) "
                                         r"needs \d+ B of shared memory"):
        _map("star3d4r", (16, 16, 1024), block=(8, 1, 1024))
    with pytest.raises(ValueError, match=r"time_block=3: the 3 plane rings"):
        _fused("star3d4r", (64, 64, 64), time_block=3, block=(128, 16, 64))


def test_launch_args_check_the_tma_base():
    """A TMA grid needs a 16-byte aligned base, a granule grid a 4-byte
    one; both plans append each buffer's extent along axis 0."""
    plan = _fused("star3d4r", (16, 16, 16))
    assert plan.stream_tma() == {"u": True}
    store = torch.zeros(24 ** 3 * 2 + 1)
    padded = {"u": store[1:1 + 24 ** 3].view(24, 24, 24),
              "v": torch.zeros(24, 24, 24)}
    with pytest.raises(ValueError, match="16-byte aligned"):
        plan.launch_args(padded, {})
    padded["u"] = torch.zeros(24, 24, 24)
    meta, _ = plan.launch_args(padded, {})
    assert list(meta)[-2:] == [24, 24]


# ---- the ring headers compiled with g++ -----------------------------------------
_STREAM_HARNESS = r"""
struct __nv_bfloat16 { unsigned short x; };
%s
typedef RT_ELEM elem_t;
#include "stream_ring.cuh"
extern "C" int smem_bytes() { return kSmemBytes; }
extern "C" int slots() { return kSlots; }
extern "C" int threads() { return kThreads; }
extern "C" int rows() { return kRows; }
extern "C" int pitch(int g) { return ring_p2(g); }
extern "C" int plane(int g) { return plane_bytes(g); }
extern "C" int offset(int g) { return ring_offset(g); }
extern "C" int slot(int r, int dx) { return tap_slot(r, dx); }
"""

_TEMPORAL_HARNESS = r"""
struct __nv_bfloat16 { unsigned short x; };
%s
typedef RT_ELEM elem_t;
#include "temporal_ring.cuh"
extern "C" int smem_bytes() { return kSmemBytes; }
extern "C" int in_pitch() { return kInP2; }
extern "C" int in_bytes() { return kInBytes; }
extern "C" int in_slots() { return kInSlots; }
extern "C" int r_slots() { return kRSlots; }
extern "C" int ring_offset(int j) { return ring_off(j); }
extern "C" int cells() { return kCells; }
extern "C" int threads() { return kThreads; }
extern "C" int owned(int tid, int c, int* yz) { return owned_cell(tid, c, &yz[0], &yz[1]); }
extern "C" int inside(int j, int cy, int cz) { return in_stage(j, cy, cz); }
"""


def _compile(harness, plan, dtype, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    header = plan.source(dtype).rsplit("#include", 1)[0]
    cpp = tmp_path / "ring.cpp"
    cpp.write_text(harness % header)
    so = tmp_path / "libring.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-D__host__=", "-D__device__=", "-I", str(_build.STENCIL_CSRC),
                    "-o", str(so), str(cpp)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


@pytest.mark.parametrize("make,dtype", [
    (lambda: _fused("star3d4r", (64, 64, 64)), torch.float32),
    (lambda: _fused("acoustic", (61, 70, 133)), torch.bfloat16),
    (lambda: _map("star3d4r", (64, 64, 64), ((1, 40), (0, 64), (7, 60))), torch.bfloat16),
    (lambda: _fused("star2d4r", (64, 128)), torch.float32),
    (lambda: _map("box3d2r", (20, 24, 40), block=(3, 5, 24)), torch.float32),
], ids=["star", "acoustic-bf16", "region-bf16", "2d", "box-odd"])
def test_stream_ring_header_matches_layout(make, dtype, tmp_path):
    """``csrc/stream_ring.cuh``: its pitches, plane bytes, ring offsets,
    slots and block bytes equal ``ring_layout``, and the unrolled loop's
    slots walk the ring as local plane ``t + kH + dx`` would."""
    plan = make()
    lib = _compile(_STREAM_HARNESS, plan, dtype, tmp_path)
    lay = plan.ring_layout(dtype)
    assert lib.smem_bytes() == lay.smem
    n = lib.slots()
    assert set(lay.slots.values()) == {n}
    kr = 2 if plan.B3[1] % 2 == 0 else 1
    assert (lib.rows(), lib.threads()) == (kr, plan.B3[1] * plan.B3[2] // kr)
    for g, pl in lay.planes.items():
        i = plan.opnd_grids.index(g)
        assert (lib.pitch(i), lib.plane(i), lib.offset(i)) == (
            pl.pitch, pl.nbytes, lay.offsets[g])
    H = max(plan.gh3[g][0] for g in lay.planes)
    for t in range(3 * n):
        for dx in range(-H, H + 1):
            assert lib.slot(t % n, dx) == (t + H + dx) % n


@pytest.mark.parametrize("make,dtype", [
    (lambda: _fused("star3d4r", (64, 64, 64), time_block=2), torch.float32),
    (lambda: _fused("star3d4r", (64, 64, 64), time_block=3), torch.bfloat16),
    (lambda: _fused("acoustic", (61, 70, 133), time_block=2), torch.float32),
    (lambda: _fused("box3d1r", (9, 10, 13), time_block=3, block=(4, 2, 8)), torch.float32),
    (lambda: _fused("star2d2r", (61, 133), time_block=2), torch.bfloat16),
], ids=["k2", "k3-bf16", "acoustic-ragged", "box-k3", "2d"])
def test_temporal_ring_header_matches_layout(make, dtype, tmp_path):
    """``csrc/temporal_ring.cuh``: ring -1's pitch, plane bytes and slots,
    the rings' offsets and the block bytes equal ``ring_layout``; the
    threads own every cell of sub-step 0's tile once, at most ``kCells``
    each, and sub-step j's cells are its tile."""
    plan = make()
    lib = _compile(_TEMPORAL_HARNESS, plan, dtype, tmp_path)
    lay = plan.ring_layout(dtype)
    k, h = plan.time_block, plan.gh3[plan.swap[1]]
    assert lib.smem_bytes() == lay.smem
    assert (lib.in_pitch(), lib.in_bytes(), lib.in_slots()) == (
        lay.planes[-1].pitch, lay.planes[-1].nbytes, lay.slots[-1])
    for j in range(k - 1):
        assert lib.r_slots() == lay.slots[j]
        assert lib.ring_offset(j) == lay.offsets[j]
    threads, cells = codegen.temporal_threads(plan.B3, h, k)
    assert (lib.threads(), lib.cells()) == (threads, cells)
    w1 = plan.B3[1] + 2 * (k - 1) * h[1]
    w2 = plan.B3[2] + 2 * (k - 1) * h[2]
    hits = np.zeros((w1, w2), int)
    yz = (ctypes.c_int * 2)()
    for tid in range(threads):
        for c in range(cells):
            if lib.owned(tid, c, yz):
                hits[yz[0], yz[1]] += 1
    assert (hits == 1).all()
    for j in range(k):
        n = sum(lib.inside(j, a, b) for a in range(w1) for b in range(w2))
        assert n == ((plan.B3[1] + 2 * (k - 1 - j) * h[1])
                     * (plan.B3[2] + 2 * (k - 1 - j) * h[2]))


# ---- the plain versions against the JAX package ---------------------------------
def _random(kernel, interior, seed):
    rng = np.random.default_rng(seed)
    h = kernel.info.order
    return {g: rng.standard_normal(tuple(s + 2 * h for s in interior)).astype(np.float32)
            for g in kernel.ir.grid_params}


def _timeloop_pair(name, interior, steps, backend, dtype=np.float32, seed=0):
    """(JAX xla window, port st.timeloop under ``backend``) after ``steps``
    fused steps on the same random grids (every cell, halos included)."""
    k, jk = _kernels(name)
    arrays = _random(k, interior, seed)
    if name == "acoustic":       # coefficients in their physical ranges
        arrays["vp2"] = 0.5 + np.abs(arrays["vp2"]).clip(max=1)
        arrays["damp"] = 0.2 * np.abs(arrays["damp"]).clip(max=1)
    h = k.info.order
    halos = {g: (h,) * k.ir.ndim for g in arrays}
    scal = {"dt": 0.3} if name == "acoustic" else {}
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    want = jlowering.lower_jax_window(jk.ir, halos, interior, None, _swap(name), steps)(
        {g: jnp.asarray(a, jdt) for g, a in arrays.items()},
        {n: jnp.float32(v) for n, v in scal.items()})
    tdt = st.bf16 if dtype == "bf16" else st.f32
    g = {n: st.grid(dtype=tdt, shape=interior, order=h, data=torch.tensor(a),
                    device="cpu") for n, a in arrays.items()}
    args = [g[n] for n in k.ir.grid_params]
    if name == "acoustic":
        st.launch(backend=backend, fuse_steps=steps)(
            lambda *a: st.timeloop(steps, swap=_swap(name))(k)(*a, 0.3))(*args)
    else:
        st.launch(backend=backend, fuse_steps=steps)(
            lambda *a: st.timeloop(steps, swap=_swap(name))(k)(*a))(*args)
    return ({n: np.asarray(want[n], np.float32) for n in arrays},
            {n: x.data.float().numpy() for n, x in g.items()})


def _assert_close(want, got, atol, rel=False):
    scale = max(np.abs(w).max() for w in want.values()) if rel else 1.0
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=atol * scale, rtol=0, err_msg=n)


@pytest.mark.parametrize("name,interior,steps", [
    ("star3d4r", (61, 70, 133), 1),
    ("star3d4r", (21, 18, 70), 3),
    ("acoustic", (19, 21, 70), 3),
    ("star2d4r", (61, 133), 2),
], ids=["star-ragged", "star", "acoustic", "2d"])
def test_k2_plain_matches_xla_window(name, interior, steps):
    """K2's plain version (default 16 x 64 tile, several chunks along axis
    0 where the interior is longer than 64 planes)."""
    want, got = _timeloop_pair(name, interior, steps, st.hopper(template="shift"))
    _assert_close(want, got, 1e-4 if name == "acoustic" else ATOL, name == "acoustic")


@pytest.mark.parametrize("k,steps", [(2, 2), (2, 3), (3, 3), (3, 4)],
                         ids=["k2-even", "k2-odd", "k3-odd", "k3-even"])
@pytest.mark.parametrize("name", ("star3d4r", "acoustic"))
def test_k3_plain_matches_xla_window(name, k, steps):
    """K3's plain version at both leapfrog parities (a window of ``steps``
    is ``steps // k`` K3 launches and the rest K2 steps), with chunks of 8
    planes so that a launch walks several."""
    want, got = _timeloop_pair(name, (19, 21, 70), steps,
                               st.hopper(template="shift", time_block=k,
                                         block=(8, 16, 32)), seed=k)
    _assert_close(want, got, 1e-4, rel=True)


@pytest.mark.parametrize("template,k", [("shift", 1), ("shift", 2), ("unroll", 3)])
def test_bf16_plain_matches_xla_window(template, k):
    want, got = _timeloop_pair("star3d4r", (13, 18, 70), 3,
                               st.hopper(template=template, time_block=k),
                               dtype="bf16", seed=5)
    _assert_close(want, got, BF16_ATOL)


def test_k4_streaming_seven_regions_match_pallas_interpret():
    """K4 streaming on each of the seven regions (its planes and tile halos
    outside the region are the real neighbouring cells) against the JAX
    package's streaming kernel in interpret mode on the same region."""
    k, jk = _kernels("star3d2r")
    shape = (12, 14, 18)
    arrays = _random(k, shape, 11)
    halos = {g: (2, 2, 2) for g in arrays}
    for r in regions.seven_region(shape, 3):
        got = ops.stencil_apply(k, {g: torch.tensor(a) for g, a in arrays.items()},
                                {}, halos=halos, template="shift", region=r)
        want = jops.stencil_apply(jk, {g: jnp.asarray(a) for g, a in arrays.items()},
                                  {}, halos=halos, template="shift", region=r,
                                  interpret=True)
        for g in arrays:
            np.testing.assert_allclose(got[g].numpy(), np.asarray(want[g]), atol=ATOL,
                                       rtol=0, err_msg=f"{r}/{g}")
