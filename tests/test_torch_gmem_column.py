"""K1 (the fused step under gmem/smem/f4) and K4 gmem (``st.map`` under
gmem): the one-step gmem build's column walk and its plain versions.

The build (``csrc/map_step.cuh``, ``RT_MAP_T 0``) has each lane walk
``b0`` planes of a column, each grid a tap reads keeping its ``2h0 + 1``
centre-column units in a register queue.  A lane computes two points
adjacent along axis 2 where the block's rows hold an even number of
points; a tap in the lane's own cells comes from its queue, every other
tap is a load, of the aligned pair of cells that holds it where both
pitches are even and the region's first cell is at an even element index
(``_Plan.gmem_pairs``).  The geometry (``csrc/gmem_column.cuh``) is
compiled here with ``g++`` and held against the plan
(``_Plan.gmem_column``).

The plain versions (``fused_step_plain``, ``map_step_plain``) read every
tap where the kernel reads it (``map_step.gmem_taps``) and are held
against the JAX package: K1 against its xla window (its fused Pallas path
fails under JAX 0.9.0), K4 gmem against ``ops.stencil_apply(...,
interpret=True)``.  Tolerance: f32 atol 1e-5 (the same expression tree,
another summation order), 1e-4 of the field's max for acoustic over
several steps; bf16 atol 1e-1 (the port computes in f32 and rounds once,
the JAX package rounds every operation).  The CUDA code runs only on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import ctypes
import functools
import math
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
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stencil import codegen, ops  # noqa: E402
from repro_torch.kernels.stencil.emit import int_table as emit_table  # noqa: E402
from repro_torch.kernels.stencil.map_step import gmem_taps  # noqa: E402

ATOL = 1e-5
BF16_ATOL = 1e-1
RAGGED = (61, 70, 133)
# a region of the ragged shape whose first cell is on no warp boundary
# (z-start 10) and whose rows start at odd element indices every other row
SUB_REGION = ((5, 50), (3, 61), (10, 127))


@st.kernel
def _jacobi3(u: st.grid, f: st.grid):
    u.at(0, 0, 0).set(0.16666667 * (u.at(-1, 0, 0) + u.at(1, 0, 0)
                                    + u.at(0, -1, 0) + u.at(0, 1, 0)
                                    + u.at(0, 0, -1) + u.at(0, 0, 1))
                      - 0.5 * f.at(0, 0, 0))


@jst.kernel
def _jjacobi3(u: jst.grid, f: jst.grid):
    u.at(0, 0, 0).set(0.16666667 * (u.at(-1, 0, 0) + u.at(1, 0, 0)
                                    + u.at(0, -1, 0) + u.at(0, 1, 0)
                                    + u.at(0, 0, -1) + u.at(0, 0, 1))
                      - 0.5 * f.at(0, 0, 0))


def _kernels(name):
    if name == "acoustic":
        return acoustic.acoustic_iso_kernel, jacoustic.acoustic_iso_kernel
    if name == "jacobi3":
        return _jacobi3, _jjacobi3
    return suite.get_kernel(name), jsuite.get_kernel(name)


def _swap(name):
    return ("p0", "p1") if name == "acoustic" else suite.swap_pair(name)


def _scal(name):
    return {"dt": 0.3} if name == "acoustic" else {}


def _random(name, interior, seed, bf16=False):
    """Every cell of every grid, halos included, from a numpy seed
    (acoustic's coefficients in their physical ranges; rounded to bf16
    values when ``bf16``)."""
    k, _ = _kernels(name)
    rng = np.random.default_rng(seed)
    h = k.info.order
    arrays = {g: rng.standard_normal(tuple(s + 2 * h for s in interior)).astype(np.float32)
              for g in k.ir.grid_params}
    if name == "acoustic":
        arrays["vp2"] = 0.5 + np.abs(arrays["vp2"]).clip(max=1)
        arrays["damp"] = 0.2 * np.abs(arrays["damp"]).clip(max=1)
    if bf16:
        arrays = {g: torch.tensor(a).bfloat16().float().numpy() for g, a in arrays.items()}
    return arrays, {g: (h,) * k.ir.ndim for g in arrays}


def _fused_plan(name, interior, block=None):
    k, _ = _kernels(name)
    halos = {g: (k.info.order,) * k.ir.ndim for g in k.ir.grid_params}
    return codegen.plan_cuda(k.ir, halos, interior,
                             st.hopper(template="gmem", block=block), swap=_swap(name))


def _map_plan(name, interior, region=None, block=None):
    k, _ = _kernels(name)
    halos = {g: (k.info.order,) * k.ir.ndim for g in k.ir.grid_params}
    return codegen.lower_hopper(k.ir, halos, interior, region,
                                st.hopper(template="gmem", block=block))


# ---- the column walk's geometry ---------------------------------------------------
# (id, plan, (cells, threads)): two points a lane where b2 is even, else
# one; 2D runs as (R0, 1, R1)
GEOMETRY = [
    ("star", lambda: _fused_plan("star3d4r", (64, 64, 64)), (2, 128)),
    ("acoustic", lambda: _map_plan("acoustic", RAGGED), (2, 128)),
    ("b24", lambda: _fused_plan("star3d4r", (37, 21, 100), (8, 3, 24)), (2, 36)),
    ("odd-b2", lambda: _fused_plan("box3d1r", (21, 30, 47), (8, 2, 15)), (1, 30)),
    ("narrow", lambda: _map_plan("star3d4r", (20, 20, 20), block=(4, 4, 4)), (2, 8)),
    ("2d", lambda: _fused_plan("star2d4r", (61, 133)), (2, 128)),
    ("jacobi", lambda: _map_plan("jacobi3", RAGGED, SUB_REGION), (2, 128)),
]


@pytest.mark.parametrize("make,want", [g[1:] for g in GEOMETRY],
                         ids=[g[0] for g in GEOMETRY])
def test_gmem_column_from_the_block(make, want):
    plan = make()
    col = plan.gmem_column()
    assert (col.cells, col.threads) == want
    assert col.queues == {g: 2 * plan.gh3[g][0] + 1 for g in plan.in_grids}
    for dtype in codegen.ELEM_TYPES:
        assert f"#define RT_GMEM_P {col.cells}" in plan.source(dtype)


def test_default_block():
    assert codegen.DEFAULT_BLOCK["step"] == {2: (16, 256), 3: (16, 4, 64)}
    assert _fused_plan("star3d4r", (64, 64, 64)).B == (16, 4, 64)
    # 2D runs as (R0, 1, R1): a block row is one row of lanes
    assert _fused_plan("star2d4r", (61, 133)).B3 == (16, 1, 256)


@pytest.mark.parametrize("make,dtype,want", [
    (lambda: _fused_plan("star3d4r", (64, 64, 64)), torch.float32, True),
    (lambda: _fused_plan("star3d4r", (64, 64, 64)), torch.bfloat16, True),
    (lambda: _fused_plan("star3d4r", RAGGED), torch.float32, False),
    (lambda: _map_plan("star3d4r", (64, 64, 64), ((1, 40), (0, 64), (8, 60))),
     torch.float32, True),
    (lambda: _map_plan("star3d4r", (64, 64, 64), ((1, 40), (0, 64), (7, 60))),
     torch.bfloat16, False),
    (lambda: _map_plan("star3d4r", RAGGED, SUB_REGION), torch.float32, False),
    (lambda: _fused_plan("star3d4r", (37, 21, 100), (8, 3, 15)), torch.float32, False),
], ids=["64", "64-bf16", "ragged-pitch", "region-even", "region-odd", "ragged-region",
        "one-point-a-lane"])
def test_pair_loads_follow_the_rows(make, dtype, want):
    """The load build reads aligned pairs where both pitches are even and
    the region's first cell is at an even element index, and the grid's
    base is aligned to a pair; the choice is part of the source."""
    plan = make()
    assert set(plan.gmem_pairs(dtype).values()) == {want}
    src = plan.source(dtype)
    n = len(plan.opnd_grids)
    assert emit_table("grid_vec", [int(want)] * n) in src
    if want:
        full = plan.full_shapes if hasattr(plan, "full_shapes") else plan.padded_shapes
        es = codegen.ELEM_BYTES[dtype]
        store = torch.empty(math.prod(full["u"]) + 1, dtype=dtype)
        bufs = {g: torch.empty(full[g], dtype=dtype) for g in plan.opnd_grids}
        bufs["u"] = store[1:].view(full["u"])        # a base off the pair
        assert bufs["u"].data_ptr() % (2 * es)
        pairs = plan.gmem_pairs(dtype, bufs)
        assert not pairs["u"] and all(v for g, v in pairs.items() if g != "u")
        assert plan.source(dtype, bufs) != src


_HARNESS = r"""
%s
typedef RT_ELEM elem_t;
#include "gmem_column.cuh"
extern "C" int cells() { return kP; }
extern "C" int threads() { return kThreads; }
extern "C" int queue(int g) { return queue_len(g); }
extern "C" int prologue(int g) { return prologue_planes(g); }
extern "C" int slot(int g, int dx) { return tap_slot(g, dx); }
extern "C" int lane(int k) { return lane_of(k); }
extern "C" int cell(int k) { return cell_of(k); }
"""


@pytest.mark.parametrize("make,dtype", [(g[1], d) for g in GEOMETRY
                                        for d in (torch.float32, torch.bfloat16)],
                         ids=[f"{g[0]}-{d}" for g in GEOMETRY for d in ("f32", "bf16")])
def test_gmem_column_header_matches_plan(make, dtype, tmp_path):
    """``csrc/gmem_column.cuh`` compiled with ``g++``: its points a lane,
    threads, queues, prologue and slots equal the plan's, and a tap's
    cell ``k`` lies in unit ``floor(k / P)`` at cell ``k mod P``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    plan = make()
    header = plan.source(dtype).rsplit("#include", 1)[0]
    cpp = tmp_path / "column.cpp"
    cpp.write_text("struct __nv_bfloat16 { unsigned short x; };\n" + _HARNESS % header)
    so = tmp_path / "libcolumn.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-D__host__=", "-D__device__=", "-I", str(_build.STENCIL_CSRC),
                    "-o", str(so), str(cpp)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    col = plan.gmem_column()
    assert (lib.cells(), lib.threads()) == (col.cells, col.threads)
    first = 0
    for i, g in enumerate(plan.opnd_grids):
        n = col.queues.get(g, 0)
        h0 = plan.gh3[g][0]
        assert (lib.queue(i), lib.prologue(i)) == (n, 2 * h0 if n else 0)
        for dx in range(-h0, h0 + 1) if n else ():
            assert lib.slot(i, dx) == first + h0 + dx
        first += n
    P = col.cells
    h2 = max(plan.gh3[g][2] for g in plan.in_grids)
    for k in range(-h2 - P, h2 + P):
        assert (lib.lane(k), lib.cell(k)) == (k // P, k % P)


# ---- the plain versions against the JAX package ---------------------------------
def _xla_pair(name, interior, steps, block=None, bf16=False, seed=0):
    """(JAX xla window, port ``st.timeloop`` under gmem: K1's plain
    version) after ``steps`` fused steps on the same random grids."""
    k, jk = _kernels(name)
    arrays, halos = _random(name, interior, seed, bf16)
    scal = _scal(name)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    want = jlowering.lower_jax_window(jk.ir, halos, interior, None, _swap(name), steps)(
        {g: jnp.asarray(a, jdt) for g, a in arrays.items()},
        {n: jnp.float32(v) for n, v in scal.items()})
    g = {n: st.grid(dtype=st.bf16 if bf16 else st.f32, shape=interior,
                    order=k.info.order, data=torch.tensor(a), device="cpu")
         for n, a in arrays.items()}
    args = [g[n] for n in k.ir.grid_params] + list(scal.values())
    st.launch(backend=st.hopper(template="gmem", block=block), fuse_steps=steps)(
        lambda *a: st.timeloop(steps, swap=_swap(name))(k)(*a))(*args)
    return ({n: np.asarray(want[n], np.float32) for n in arrays},
            {n: x.data.float().numpy() for n, x in g.items()})


@pytest.mark.parametrize("name,interior,steps,block,bf16", [
    ("star3d4r", (64, 64, 64), 1, None, False),
    ("acoustic", (64, 64, 64), 2, None, False),
    ("star3d4r", RAGGED, 1, None, False),
    ("star2d4r", (61, 133), 2, None, False),
    ("box3d2r", (21, 30, 47), 1, None, False),
    ("star3d4r", (37, 21, 100), 1, (8, 3, 24), False),
    ("star3d4r", RAGGED, 1, None, True),
    ("acoustic", (19, 21, 70), 2, None, True),
], ids=["star-64", "acoustic-64", "star-ragged", "2d", "box", "no-segment",
        "star-ragged-bf16", "acoustic-bf16"])
def test_k1_plain_matches_xla_window(name, interior, steps, block, bf16):
    """K1's plain version (``st.timeloop`` on CPU grids) against the JAX
    package's xla window."""
    want, got = _xla_pair(name, interior, steps, block, bf16)
    scale = max(np.abs(w).max() for w in want.values()) if name == "acoustic" else 1.0
    atol = BF16_ATOL if bf16 else (1e-4 * scale if name == "acoustic" else ATOL)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=atol, rtol=0, err_msg=n)


@functools.lru_cache(maxsize=None)
def _pallas(name, interior, region, bf16):
    """The JAX package's gmem kernel in interpret mode on ``_random``'s
    grids (seed 3), as numpy arrays."""
    _, jk = _kernels(name)
    arrays, halos = _random(name, interior, 3, bf16)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    out = jops.stencil_apply(jk, {g: jnp.asarray(a, jdt) for g, a in arrays.items()},
                             _scal(name), halos=halos, template="gmem", region=region,
                             interpret=True)
    return {g: np.asarray(v, np.float32) for g, v in out.items()}


@pytest.mark.parametrize("name,interior,region,block,bf16", [
    ("star3d4r", (64, 64, 64), None, None, False),
    ("acoustic", (64, 64, 64), None, None, False),
    ("star3d4r", RAGGED, None, None, False),
    ("star3d4r", RAGGED, SUB_REGION, None, False),
    ("star3d4r", RAGGED, SUB_REGION, (7, 4, 64), False),
    ("star2d4r", (61, 133), ((3, 60), (9, 130)), None, False),
    ("j3d27pt", (21, 30, 47), None, None, False),
    ("box3d2r", (21, 30, 47), ((0, 21), (1, 30), (5, 47)), (4, 2, 16), False),
    ("jacobi3", RAGGED, SUB_REGION, None, False),
    ("star3d4r", RAGGED, SUB_REGION, None, True),
    ("acoustic", (21, 30, 47), ((1, 20), (2, 29), (3, 46)), None, True),
], ids=["star-64", "acoustic-64", "star-ragged", "star-region", "star-region-b0",
        "2d-region", "j3d27pt", "box-width16", "jacobi-destination",
        "star-region-bf16", "acoustic-region-bf16"])
def test_k4_gmem_plain_matches_pallas_interpret(name, interior, region, block, bf16):
    """K4 gmem's plain version (``st.map`` on CPU tensors) against the JAX
    package's gmem kernel in interpret mode, on the same region: its taps
    read the real neighbouring cells and every cell outside the region
    keeps its value; the Jacobi sweep reads its output grid off-center (a
    destination buffer, its queue on the output grid)."""
    k, jk = _kernels(name)
    arrays, halos = _random(name, interior, 3, bf16)
    scal = _scal(name)
    plan = _map_plan(name, interior, region, block)
    assert plan.in_place == (name != "jacobi3")
    tdt = torch.bfloat16 if bf16 else torch.float32
    got = ops.stencil_apply(k, {g: torch.tensor(a).to(tdt) for g, a in arrays.items()},
                            scal, halos=halos, template="gmem", region=region,
                            block=block)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    want = _pallas(name, interior, region, bf16)
    for g in arrays:
        np.testing.assert_allclose(got[g].float().numpy(), want[g],
                                   atol=BF16_ATOL if bf16 else ATOL, rtol=0, err_msg=g)


@pytest.mark.parametrize("shift", (0, 1), ids=("even-base", "odd-base"))
def test_plain_taps_read_the_kernels_cells(shift):
    """The plain version's taps are the grid's cells: from the queue (the
    lane's unit, axis 0 and its own cells along axis 2) and from loads,
    at a region of rows that start on odd cells, on a bf16 grid whose
    first cell is a pair's first or second half."""
    plan = _map_plan("star3d4r", RAGGED, SUB_REGION)
    arrays, _ = _random("star3d4r", RAGGED, 9, bf16=True)
    store = torch.empty(arrays["u"].size + 1, dtype=torch.bfloat16)
    u = store[shift:shift + arrays["u"].size].view(arrays["u"].shape)
    u.copy_(torch.tensor(arrays["u"]))
    bufs = {"u": u, "v": torch.tensor(arrays["v"]).bfloat16()}
    assert not plan.gmem_pairs(torch.bfloat16, bufs)["u"]
    taps = gmem_taps(plan, bufs, 0, 7)
    o, R = plan.org3["u"], plan.R3
    for dx, dy, dz in ((0, 0, 0), (2, 0, 0), (-4, 0, 0), (0, 0, 1), (0, 0, -1),
                       (0, 0, 4), (0, 0, -3), (0, 3, 0)):
        want = u[o[0] + dx:o[0] + dx + 7, o[1] + dy:o[1] + dy + R[1],
                 o[2] + dz:o[2] + dz + R[2]]
        assert torch.equal(taps("u", (dx, dy, dz)), want.float()), (dx, dy, dz)
