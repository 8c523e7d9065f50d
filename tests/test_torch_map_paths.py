"""K4 f4's and smem's paths, chosen when the plan is made, and smem's
staging geometry.

f4 loads its tap rows as aligned vectors of 4 cells: where both pitches of
a grid are multiples of 4 cells the plan fixes each row's place in its
vector (``MapPlan.f4_org_mod4``, emitted as ``f4_piece_off``), elsewhere
the kernel aligns each row at run time; the rows are grouped into queue
pieces carried along axis 0 (``emit.f4_pieces``).  smem stages each
tile's halo'd box by TMA where both pitches are multiples of 16 bytes
(``MapPlan.smem_tma``) and by 4-byte ``cp.async`` granules elsewhere, in
two stages (``codegen.smem_layout``, ``csrc/smem_tile.cuh``, compiled here
with ``g++`` and held against the Python layout).

The plain versions walk the new geometry (f4's pieces and queues, smem's
chunks of ``b0`` planes with cells outside the tap reach NaN) and are held
against the JAX package's per-application kernels in interpret mode, atol
1e-5 as ``tests/test_torch_map.py`` (f32: the same expression tree in
another summation order and contraction).  The CUDA code runs only on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import suite as jsuite  # noqa: E402
from repro.kernels.stencil import ops as jops  # noqa: E402
from repro_torch.core import acoustic, suite  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stencil import codegen, emit, ops  # noqa: E402

ATOL = 1e-5


def _plan(name, interior, template, region=None, block=None, halos=None):
    k = acoustic.acoustic_iso_kernel if name == "acoustic" else suite.get_kernel(name)
    ir = k.ir
    if halos is None:
        halos = {g: (k.info.order,) * ir.ndim for g in ir.grid_params}
    return codegen.lower_hopper(ir, halos, interior, region,
                                st.hopper(template=template, block=block))


# ---- f4: the load path per grid and the queue pieces -------------------------
@pytest.mark.parametrize("interior,halos,region,want", [
    # full 72^3: pitches 5184 and 72, the region's first cell at 0 mod 4
    ((64, 64, 64), {"u": (4,) * 3, "v": (4,) * 3}, None, {"u": 0, "v": 0}),
    # the main path's 520^3
    ((512, 512, 512), {"u": (4,) * 3, "v": (4,) * 3}, None, {"u": 0, "v": 0}),
    # a region starting at z = 7 (org 4 + 7 along axis 2, pitches 0 mod 4)
    ((64, 64, 64), {"u": (4,) * 3, "v": (4,) * 3}, ((1, 40), (0, 64), (7, 60)),
     {"u": 3, "v": 3}),
    # the ragged 61 x 70 x 133: rows of 141 cells
    ((61, 70, 133), {"u": (4,) * 3, "v": (4,) * 3}, None, {"u": None, "v": None}),
    # per grid: v with no halo has rows of 64 cells, u's are 66
    ((64, 64, 64), {"u": (1,) * 3, "v": (0,) * 3}, None, {"u": None, "v": 0}),
], ids=["64", "512", "region", "ragged", "per-grid"])
def test_f4_path_is_chosen_from_the_pitches(interior, halos, region, want):
    name = "star3d4r" if halos["u"][0] == 4 else "star3d1r"
    plan = _plan(name, interior, "f4", region, halos=halos)
    assert plan.f4_org_mod4() == want
    src = plan.source()
    _, pieces = emit.f4_pieces(emit.f4_rows(plan.kernel, plan.opnd_grids,
                                            plan.out_grids), want)
    offs = [-1 if p.off is None else p.off for p in pieces]
    assert ("f4_piece_off(int p) { return "
            + " : ".join(f"p == {i} ? {o}" for i, o in enumerate(offs))
            + " : 0; }") in src


def test_f4_pieces_star3d4r():
    """The centre row's cells [-4, 7] split into three pieces: [0, 3] is
    read at every dx (a queue of 9 slots), [-4, -1] and [4, 7] only at
    dx = 0; each of the 8 rows off axis 0 is a piece of its own: 11 vector
    loads a group of 4 points, 13 + 8 queued vectors."""
    k = suite.get_kernel("star3d4r")
    rows = emit.f4_rows(k.ir, ("u", "v"), ("v",))
    fams, pieces = emit.f4_pieces(rows, {"u": 0, "v": 0})
    assert fams[0] == ("u", 0, 4) and len(fams) == 9
    assert [tuple(p)[1:5] for p in pieces[:3]] == [(-4, -1, 0, 0), (0, 3, -4, 4),
                                                   (4, 7, 0, 0)]
    assert all(tuple(p)[1:6] == (0, 3, 0, 0, 0) for p in pieces[3:])
    assert len(pieces) == 11
    # misaligned by 2: each piece's first cell sits at place 2 of its vector
    _, shifted = emit.f4_pieces(rows, {"u": 2, "v": 2})
    assert [p.off for p in shifted[:3]] == [2, 2, 2]
    _, runtime = emit.f4_pieces(rows, {"u": None, "v": None})
    assert all(p.off is None for p in runtime)


def test_f4_pieces_split_by_the_range_of_dx():
    """Cells needed by different ranges of dx are different pieces, and a
    cell no row needs is in none."""
    @st.kernel
    def lopsided(u: st.grid, v: st.grid):
        v.at(0, 0).set(u.at(-2, 0) + u.at(2, 6) + 0.5 * u.at(0, 1))
    rows = emit.f4_rows(lopsided.ir, ("u", "v"), ("v",))
    _, pieces = emit.f4_pieces(rows, {"u": None, "v": None})
    # dx=-2 needs [0, 3], dx=0 [1, 4], dx=2 [6, 9]: 5 is needed by none
    assert [(p.c0, p.c1, p.a, p.b) for p in pieces] == [
        (0, 0, -2, -2), (1, 3, -2, 0), (4, 4, 0, 0), (6, 9, 2, 2)]


# ---- smem: the staging path per grid, the layout, the default tile -----------
@pytest.mark.parametrize("interior,dtype,block,want", [
    ((64, 64, 64), torch.float32, None, True),       # rows of 72 x 4 B
    ((512, 512, 512), torch.float32, None, True),    # 520 x 4 B
    ((512, 512, 512), torch.bfloat16, None, True),   # 520 x 2 B = 65 x 16 B
    ((61, 70, 133), torch.float32, None, False),     # 141 x 4 B
    ((61, 70, 133), torch.bfloat16, None, False),
    ((64, 64, 68), torch.bfloat16, None, False),     # 76 x 2 B
    ((64, 64, 68), torch.float32, None, True),       # 76 x 4 B
    ((64, 64, 64), torch.float32, (1, 2, 256), False),   # a 264-cell box row
], ids=["64", "512", "512-bf16", "ragged", "ragged-bf16", "76-bf16", "76",
        "wide-box"])
def test_smem_path_is_chosen_from_the_pitches(interior, dtype, block, want):
    plan = _plan("star3d4r", interior, "smem", block=block)
    assert plan.smem_tma(dtype) == {"u": want}
    src = plan.source(dtype)
    assert f"grid_tma(int g) {{ return g == 0 ? {int(want)} : g == 1 ? 0 : 0; }}" in src


@pytest.mark.parametrize("z0,block,dtype,want", [
    (8, None, torch.float32, True),      # boxes start at z 8 + 64k: 32 B
    (8, None, torch.bfloat16, True),     # 16 B
    (4, None, torch.float32, True),
    (4, None, torch.bfloat16, False),    # 8 B
    (7, None, torch.float32, False),
    (0, (8, 16, 62), torch.float32, False),   # tiles 62 cells apart
], ids=["8", "8-bf16", "4", "4-bf16", "7", "b2-62"])
def test_smem_tma_needs_aligned_box_starts(z0, block, dtype, want):
    """The card refuses a TMA box whose start along axis 2 is not on a
    16-byte boundary (cudaError 715 on an H100): such regions take the
    granule path."""
    plan = _plan("star3d4r", (64, 64, 64), "smem", ((0, 64), (0, 64), (z0, 64)),
                 block=block)
    assert plan.smem_tma(dtype) == {"u": want}


def test_smem_default_tile_fits_two_stages():
    """The default tile is the largest of ``SMEM_BLOCKS`` whose two stages
    fit: (8, 16, 64) for star3d4r and acoustic (one staged grid), a
    smaller one for a kernel that stages two grids at a halo of 4; a user
    block that does not fit raises."""
    assert _plan("star3d4r", (64,) * 3, "smem").B == (8, 16, 64)
    assert _plan("acoustic", (64,) * 3, "smem").B == (8, 16, 64)

    @st.kernel
    def two_ring(u: st.grid, w: st.grid, v: st.grid):
        v.at(0, 0, 0).set(u.at(4, 0, 0) + u.at(0, -4, 0) + w.at(0, 0, 4)
                          + w.at(-4, 0, 0) + u.at(0, 0, -4) + w.at(0, 4, 0))
    plan = codegen.lower_hopper(two_ring.ir, {g: (4,) * 3 for g in "uwv"},
                                (64,) * 3, None, st.hopper(template="smem"))
    assert plan.B == (4, 8, 64)
    assert plan.smem_bytes == 128 + 2 * 2 * 4 * 12 * 16 * 72 + 16
    assert plan.smem_bytes <= codegen.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        codegen.lower_hopper(two_ring.ir, {g: (4,) * 3 for g in "uwv"},
                             (64,) * 3, None,
                             st.hopper(template="smem", block=(8, 16, 64)))


def test_smem_launch_args_check_the_tma_base():
    """A TMA grid needs a 16-byte aligned base (a view may start anywhere);
    the meta block ends with each grid's extent along axis 0."""
    plan = _plan("star3d1r", (8, 8, 8), "smem")     # rows of 10 cells
    assert plan.smem_tma() == {"u": False}
    plan = _plan("star3d1r", (8, 8, 6), "smem")     # rows of 8 cells
    assert plan.smem_tma() == {"u": True}
    flat = torch.zeros(10 * 10 * 8 + 8)
    v = torch.zeros(10, 10, 8)
    meta, _ = plan.launch_args({"u": flat[4:804].view(10, 10, 8), "v": v}, {})
    assert list(meta)[-2:] == [10, 10]
    with pytest.raises(ValueError, match="16-byte aligned"):
        plan.launch_args({"u": flat[1:801].view(10, 10, 8), "v": v}, {})
    granule = _plan("star3d1r", (8, 8, 8), "smem")
    g = torch.zeros(10 * 10 * 10 + 2)
    granule.launch_args({"u": g[1:1001].view(10, 10, 10),
                         "v": torch.zeros(10, 10, 10)}, {})


@pytest.mark.parametrize("template,want", [
    ("gmem", "map_step.cuh"), ("f4", "map_step.cuh"), ("smem", "map_smem.cuh"),
    ("shift", "stream_step.cuh"), ("semi", "semi_step.cuh")])
def test_plan_names_the_header_of_its_kernel(template, want):
    """A plan names the hand-written header that holds its kernel's body
    (smem's is included by ``map_step.cuh``, which the source includes)."""
    plan = _plan("star3d4r", (16, 16, 16), template)
    assert plan.source_file == want
    assert (_build.STENCIL_CSRC / want).is_file()
    assert f'#include "{codegen.KERNEL_FILES[plan.kind]}"' in plan.source()


_SMEM_HARNESS = r"""
struct __nv_bfloat16 { unsigned short x; };
%s
typedef RT_ELEM elem_t;
#define __forceinline__ inline
#include "smem_tile.cuh"
extern "C" int stage_bytes() { return kStageBytes; }
extern "C" int smem_bytes() { return kSmemBytes; }
extern "C" int tma_bytes_all() { return kTmaBytes; }
extern "C" int threads() { return kThreads; }
extern "C" int pitch(int g) { return tile_p2(g); }
extern "C" int offset(int g) { return tile_offset(g); }
extern "C" void origin(int t, int R1, int R2, int* out) {
  const TileOrigin o = tile_origin(t, R1, R2);
  out[0] = o.x0; out[1] = o.y0; out[2] = o.z0;
}
// the (row, granule) pairs thread tid copies of grid g, counted into hits
template <int G>
void granules_of(int g, int tid, int* hits) {
  if constexpr (G < RT_NG) {
    if (g == G)
      for_granules<G>(tid, [&](int row, int k) { ++hits[row * (tile_p2(G) / kGranule) + k]; });
    granules_of<G + 1>(g, tid, hits);
  }
}
extern "C" void granules(int g, int tid, int* hits) { granules_of<0>(g, tid, hits); }
"""


@pytest.mark.parametrize("name,interior,block,dtype", [
    ("star3d4r", (61, 70, 133), None, torch.float32),
    ("star3d4r", (61, 70, 133), None, torch.bfloat16),
    ("acoustic", (64, 64, 64), None, torch.float32),
    ("star2d4r", (61, 133), None, torch.bfloat16),
    ("box3d2r", (20, 24, 40), (3, 5, 24), torch.float32),
    ("star3d1r", (9, 9, 9), (2, 1, 1000), torch.float32),   # rows > threads
], ids=["star", "star-bf16", "acoustic", "2d-bf16", "box-odd", "wide"])
def test_smem_tile_header_matches_layout(name, interior, block, dtype, tmp_path):
    """``csrc/smem_tile.cuh`` compiled with ``g++``: its pitches, tile
    offsets, stage and block bytes equal ``codegen.smem_layout`` and the
    plan's ``smem_bytes`` (f32; bf16 takes less), its TMA bytes the tiles of
    the TMA grids, the tiles' origins cover the region once, in order along
    axis 2 first, and the threads' granule copies cover every granule of
    every row exactly once."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    plan = _plan(name, interior, "smem", block=block)
    header = plan.source(dtype).rsplit("#include", 1)[0]
    cpp = tmp_path / "smem.cpp"
    cpp.write_text(_SMEM_HARNESS % header)
    so = tmp_path / "libsmem.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-D__host__=", "-D__device__=", "-I", str(_build.STENCIL_CSRC),
                    "-o", str(so), str(cpp)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    es = codegen.ELEM_BYTES[dtype]
    layout, stage = codegen.smem_layout(plan.B3, plan.gh3, es)
    assert lib.stage_bytes() == stage
    assert lib.smem_bytes() == 128 + 2 * stage + 16
    if dtype == torch.float32:
        assert lib.smem_bytes() == plan.smem_bytes
    else:
        assert lib.smem_bytes() <= plan.smem_bytes
    assert lib.threads() == plan.B3[2] * plan.B3[1]
    tma = plan.smem_tma(dtype)
    want_tma = 0
    for g, (box, p2, off) in layout.items():
        i = plan.opnd_grids.index(g)
        assert (lib.pitch(i), lib.offset(i)) == (p2, off)
        assert p2 * es % 16 == 0 and p2 >= box[2] + 4 // es - 1 and off % 128 == 0
        want_tma += tma[g] * box[0] * box[1] * p2 * es
    assert lib.tma_bytes_all() == want_tma
    # the tiles' first points
    R = plan.R3
    n = [-(-R[ax] // plan.B3[ax]) for ax in range(3)]
    out = (ctypes.c_int * 3)()
    seen = []
    for t in range(n[0] * n[1] * n[2]):
        lib.origin(t, R[1], R[2], out)
        seen.append(tuple(out))
    assert seen == [(a * plan.B3[0], b * plan.B3[1], c * plan.B3[2])
                    for a in range(n[0]) for b in range(n[1]) for c in range(n[2])]
    # every granule of every row of the staged box, once
    for g, (box, p2, _) in layout.items():
        i = plan.opnd_grids.index(g)
        cells = box[0] * box[1] * (p2 // (4 // es))
        hits = (ctypes.c_int * cells)()
        for tid in range(lib.threads()):
            lib.granules(i, tid, hits)
        assert set(hits) == {1}


# ---- the plain versions in the new geometry against the JAX package ----------
@pytest.mark.parametrize("name,interior,region,block", [
    ("star3d4r", (12, 16, 20), None, (3, 4, 8)),                    # aligned
    ("star3d4r", (11, 13, 19), None, (5, 4, 8)),                    # run time
    ("star3d4r", (12, 16, 20), ((1, 11), (2, 16), (5, 19)), (4, 8, 8)),
    ("box3d2r", (9, 10, 13), ((0, 9), (1, 9), (2, 13)), (2, 2, 8)),
    ("star2d4r", (23, 37), None, (7, 16)),
], ids=["aligned", "runtime", "region-offset", "box-region", "2d"])
@pytest.mark.parametrize("template", ("f4", "smem"))
def test_plain_versions_in_chunks_match_pallas_interpret(name, interior, region,
                                                         block, template):
    """Several chunks of ``b0`` planes with a ragged last one, f4's queues
    refilled at every chunk, smem's boxes running past the region's last
    plane (NaN there): against the JAX package's kernel of the same
    template in interpret mode."""
    k, jk = suite.get_kernel(name), jsuite.get_kernel(name)
    halos = {g: (k.info.order,) * k.ir.ndim for g in k.ir.grid_params}
    rng = np.random.default_rng(11)
    arrays = {g: rng.standard_normal(tuple(s + 2 * h for s, h in
                                           zip(interior, halos[g])))
              .astype(np.float32) for g in k.ir.grid_params}
    got = ops.stencil_apply(k, {g: torch.tensor(a) for g, a in arrays.items()},
                            {}, halos=halos, template=template, block=block,
                            region=region)
    want = jops.stencil_apply(jk, {g: jnp.asarray(a) for g, a in arrays.items()},
                              {}, halos=halos, template=template, region=region,
                              interpret=True)
    for g in k.ir.grid_params:
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want[g]),
                                   atol=ATOL, rtol=0, err_msg=g)
