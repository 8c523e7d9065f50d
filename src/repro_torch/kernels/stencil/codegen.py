"""StencilIR → hand-written Hopper CUDA kernels: the fused time-loop plan
(``CudaPlan``) and the per-application plan (``MapPlan``, ``st.map``).

``CudaPlan`` is the counterpart of the JAX package's ``PallasPlan``: it
splits a fused time loop into

  ``to_padded``   — one-time layout stage per fusion window: each operand
                    grid cut to its layout halo ``hw`` and made contiguous
                    (one conversion per grid, counted in ``PAD_COUNT``;
                    a grid whose halo already equals ``hw`` is used as it
                    is, so its buffer is then advanced in place);
  ``step``        — one kernel launch on the layout buffers.  With
                    ``time_block=1`` it advances one step in place: K1
                    (``fused_step``, templates gmem/smem/f4: K4 gmem's
                    body in the layout buffers), K2
                    (``stream_step``, shift/unroll) or K5 (``semi_step``,
                    semi); writing in place is legal because output grids
                    must have center-only taps.  With ``time_block=k>1``
                    it runs K3 (``temporal_step``, every template): k
                    leapfrog sub-steps in one launch, both swap buffers
                    written to *spare* buffers (``make_spares``), never to
                    the buffers it reads, since its blocks read k·h cells
                    into their neighbours' tiles while those run;
  ``from_padded`` — write the touched grids' layout interiors back.

Grids named in ``swap`` share one layout halo, the larger of their tap
halos, so their buffers can trade names between steps.  There is no
whole-block ring as on the TPU: the kernels mask their own ragged edge, so
``hbm_bytes_per_step`` counts what they actually move.  2D stencils run as
3D ones of shape ``(R0, 1, R1)`` (tap ``(a, b)`` → ``(a, 0, b)``).

The kernels' structure is hand-written (``csrc/*.cuh``); only the per-point
expression (K5: the per-offset scatter) is generated (``emit.py``) and
compiled at first use (``kernels/_build.py``).  The layout halo stays ``hw`` under
temporal blocking: K3 clamps its loads to the tap reach ``[-h, R + h)``.

Scenarios (``st.timeloop(batch=B)``): a grid then holds B copies of its
domain along a leading axis, and so does each layout buffer (``(B,) +
padded_shapes[g]``, contiguous).  One launch advances every scenario: the
kernels walk the scenarios' tiles along ``blockIdx.z``, each grid's
scenario ``b`` ``bs[g]`` elements after scenario 0, and read each
scenario's scalars from a ``(B, NS)`` f32 array on the card
(``scenario_scalars``, copied into the build's constant memory before the
launch); K2's and K3's TMA maps give the scenario a dimension of its own.
B is a run-time argument of the same build: each kernel is a template on
whether it has a scenario index, and the unbatched launch runs the
instantiation without one, its scalars by value in the parameter block
(``csrc/common.cuh``).  The plain versions run each scenario as its own
unbatched step.

Grids are f32 or bf16, as the JAX package's Pallas kernels take them; all
the grids of one launch share one type, which is part of the kernel's
source (``source(dtype)``, ``ELEM_TYPES``) and so of its build key.  The
kernels compute in f32 and round once, when they store an output cell.

``MapPlan`` (``lower_hopper``) is the counterpart of the JAX package's
``lower_pallas``: one application over the interior or a sub-region, with
no layout stage.  Each grid's full halo'd tensor goes to the kernel with
its origin at the region's first point and the region's extent as ``R``,
so taps outside the region read the real neighbouring cells.  Templates
gmem/f4/smem run K4 (``map_step``), shift/unroll K2's source with a
destination (K4 streaming), semi K5's.  Outputs are written in place when
every output grid has center-only taps; otherwise into a destination
buffer that no block reads, whose region is then copied into the grid.
f4's load path and smem's staging path follow from the grids' full shapes
and the region (``f4_org_mod4``, ``smem_tma``), so they are part of the
source and of its build key.

What the cost model (``repro_torch.core.cost_model``) reads from a plan,
without building it: its kernel family (``kernel_class``: K1, K2, K3 or
K5 for ``CudaPlan``; K4-gmem, K4-f4, K4-smem, K2-map or K5-map for
``MapPlan``), its modeled bytes a step (``hbm_bytes_per_step``) and a
window (``layout_bytes_per_window``), and its ``build_identity`` (the
hash of its source and the box it launches over), on which the autotuner
tells candidates apart.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import analysis, ir

from . import emit

# threads cover b1 x b2 points; the streaming kernels walk b0 planes, and
# the one-step kernels' lanes (K1, K4 gmem) b0 planes of a column, two
# points a lane along axis 2, with the column's axis-0 taps in register
# queues (csrc/gmem_column.cuh): 16 x 4 x 64, 128 lanes a block, six
# blocks an SM at 80 registers (tools/gmem_block_ab.py times the others).
# K5's threads walk two columns along axis 1 with f32 grids (csrc/semi_step.cuh
# kCols).  K2's threads walk two columns along axis 1 of an 8 x 64 tile
# (csrc/stream_ring.cuh), three blocks an SM: at a halo of 4 a staged
# plane is 16 x 72 cells, 2.25 a point (16 x 64 stages 1.69, but holds one
# block an SM, and acoustic's center-only loads then wait;
# tools/stream_tiles_ab.py times both).  K4 f4's threads walk a column of
# groups of 4 points along axis 2, long enough to amortise the prologue of
# their axis-0 register queue (csrc/f4_rows.cuh).  K4 smem's persistent
# blocks stage two halo'd tiles of b0 x b1 x b2 (csrc/map_smem.cuh): its
# default is the first of SMEM_BLOCKS whose two stages fit in shared
# memory, (8, 16, 64) in 3D for one staged grid at a halo of 4.  K3's
# default is the first of TEMPORAL_BLOCKS whose rings fit
# (csrc/temporal_ring.cuh): 16 x 64 at k=2, 16 x 32 at k=3 for a halo of 4,
# chunks of 128 planes (a chunk re-evaluates 2(k-1)h0 planes of sub-step 0).
DEFAULT_BLOCK = {"step": {2: (16, 256), 3: (16, 4, 64)},
                 "stream": {2: (64, 128), 3: (64, 8, 64)},
                 "semi": {2: (64, 256), 3: (64, 16, 32)},
                 "f4": {2: (16, 512), 3: (16, 8, 128)}}
SMEM_BLOCKS = {2: ((32, 256), (16, 128), (8, 64), (4, 32)),
               3: ((8, 16, 64), (4, 16, 64), (4, 8, 64), (4, 8, 32),
                   (2, 4, 32))}
TEMPORAL_BLOCKS = {2: ((128, 128), (128, 64), (64, 32)),
                   3: ((128, 16, 64), (128, 16, 32), (64, 8, 32), (64, 4, 32),
                       (32, 4, 16))}
# planes each staged ring copies ahead of the plane it evaluates: K2's
# rings (RT_PRE, csrc/stream_ring.cuh) and K3's input ring
STREAM_PREFETCH = 4
TEMPORAL_PREFETCH = 2
# K3's threads: at most this many, each owning fixed cells of every stage
TEMPORAL_THREADS = 1024
STREAM_TEMPLATES = ("shift", "unroll", "semi")
# RT_MAP_T of K4's blocked templates (csrc/map_step.cuh)
MAP_TEMPLATES = {"gmem": 0, "f4": 1, "smem": 2}
SMEM_LIMIT = 227 * 1024          # shared memory one block may use on sm_90
# grid dtype -> the kernels' element type (RT_ELEM, csrc/common.cuh)
ELEM_TYPES = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}
ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
# staged planes of K5's ring (csrc/semi_step.cuh kStages)
SEMI_STAGES = 3
# scalars a batched launch holds, all its scenarios' (csrc/common.cuh
# kScenarioScalars: the kernels read them from constant memory)
SCENARIO_SCALARS = 8192

# layout conversions per grid name: one per grid per fusion window
PAD_COUNT: collections.Counter = collections.Counter()
# modeled traffic of the fused path: grid reads, grid writes, steps
TRAFFIC_COUNT: collections.Counter = collections.Counter()


def reset_pad_count() -> None:
    """Clear ``PAD_COUNT``."""
    PAD_COUNT.clear()


def reset_traffic_count() -> None:
    """Clear ``TRAFFIC_COUNT``."""
    TRAFFIC_COUNT.clear()


def to3(t, fill: int) -> Tuple[int, int, int]:
    """A 2D tuple in the kernels' 3D form: ``(a, b)`` → ``(a, fill, b)``."""
    t = tuple(int(x) for x in t)
    return t if len(t) == 3 else (t[0], fill, t[1])


def choose_block(user_block, template: str, ndim: int,
                 per_application: bool = False) -> Tuple[int, ...]:
    """The tile in points (the port's own defaults, see ``DEFAULT_BLOCK``;
    K5 a tile twice as tall as K2's; K4's f4, ``per_application``, takes a
    longer, wider tile; K4 smem's default is ``MapPlan``'s, from
    ``SMEM_BLOCKS``, and K3's ``CudaPlan``'s, from ``TEMPORAL_BLOCKS``)."""
    if user_block is not None:
        if len(user_block) != ndim:
            raise ValueError(f"block must have {ndim} dims")
        return tuple(int(b) for b in user_block)
    if template == "semi":
        kind = "semi"
    elif template in STREAM_TEMPLATES:
        kind = "stream"
    elif per_application and template == "f4":
        kind = "f4"
    else:
        kind = "step"
    return DEFAULT_BLOCK[kind][ndim]


def kernel_class(template: str, time_block: int = 1, fused: bool = True) -> str:
    """The kernel family a hopper configuration launches: in ``st.timeloop``
    (``fused``) K3 for ``time_block > 1``, else K5 (semi), K2 (shift,
    unroll) or K1 (gmem, smem, f4); in ``st.map`` K4-gmem, K4-f4, K4-smem,
    K2-map (shift, unroll) or K5-map (semi).  Each family runs at its own
    share of its bound on the card, so the cost model calibrates one rate
    for each."""
    if fused:
        if int(time_block) > 1:
            return "K3"
        if template == "semi":
            return "K5"
        return "K2" if template in STREAM_TEMPLATES else "K1"
    if template == "semi":
        return "K5-map"
    return "K2-map" if template in STREAM_TEMPLATES else f"K4-{template}"


def semi_linearize(kernel: ir.StencilIR):
    """The semi template's form of ``kernel``: output grid → ([(grid,
    offsets, coefficient)], constant), and the streaming halo ``H``, the
    largest axis-0 offset of a term.  Coefficients and the constant may
    read center-only taps (coefficient fields such as acoustic's ``vp2``);
    every off-center tap is a term.  Raises ``analysis.NotLinearError`` for
    a kernel that is not linear in its taps and ``ValueError`` for one that
    reads a grid an earlier statement wrote (the JAX package's
    ``_semi_linearize``)."""
    lin = {}
    written = set()
    for a in analysis.inline_locals(kernel):
        terms, const = analysis.linearize(a.expr, allow_center_fields=True)
        for t in ir.StencilIR(kernel.name, kernel.ndim, kernel.grid_params,
                              kernel.scalar_params, (a,)).taps():
            if t.grid in written:
                raise ValueError("semi template does not support reading "
                                 "a previously-written grid")
        written.add(a.grid)
        lin[a.grid] = ([(g, offs, c) for (g, offs), c in terms.items()],
                       const)
    H = max((abs(offs[0]) for terms, _ in lin.values()
             for _, offs, _ in terms), default=0)
    return lin, H


def _cover(R: int, B: int, e: int, c: int, clip_tile: bool) -> int:
    """Cells one axis of a tiled load touches, summed over the tiles: tile
    ``[s, s + B)`` (cut at ``R`` when ``clip_tile``) widened by ``e`` per
    side and clipped to ``[-c, R + c)``."""
    total = 0
    for s in range(0, R, B):
        end = min(s + B, R) if clip_tile else s + B
        total += max(0, min(end + e, R + c) - max(s - e, -c))
    return total


def _window_cells(R3, B3, e3, c3) -> int:
    """Cells a tiled kernel loads for one grid: per tile (axes 1, 2) and
    chunk (axis 0, cut at ``R0``) the window widened by ``e3`` and clipped
    to ``[-c3, R + c3)``, summed over tiles and chunks."""
    return math.prod(_cover(R3[ax], B3[ax], e3[ax], c3[ax], ax == 0)
                     for ax in range(3))


KERNEL_FILES = {"fused": "map_step.cuh", "stream": "stream_step.cuh",
                "semi": "semi_step.cuh", "temporal": "temporal_step.cuh",
                "map": "map_step.cuh"}


# K4 smem (csrc/smem_tile.cuh): each staged tile starts on a 128-byte
# boundary (a TMA destination); a block's dynamic shared memory is the
# slack to align its base, two stages and two 8-byte mbarriers
SMEM_TILE_ALIGN = 128
SMEM_BARRIER_BYTES = 16
# a TMA box extent is at most 256 cells
TMA_BOX_MAX = 256


def smem_layout(B3, gh3, itemsize: int = 4):
    """K4 smem's stage (``csrc/smem_tile.cuh``) on grids of ``itemsize``
    bytes: ``({grid: (box, pitch, offset)}, stage bytes)`` for every grid
    with an off-center tap.  ``box`` is the halo'd tile ``(b0 + 2h0, b1 +
    2h1, b2 + 2h2)``; its rows lie ``pitch`` cells apart (the row plus one
    4-byte granule of slack, rounded up to 16 bytes: also the inner extent
    of the grid's TMA box); ``offset`` is the tile's byte offset in the
    stage, a multiple of 128."""
    gran, vec = 4 // itemsize, 16 // itemsize
    out, off = {}, 0
    for g, h in gh3.items():
        if not any(h):
            continue
        box = tuple(B3[ax] + 2 * h[ax] for ax in range(3))
        pitch = -(-(box[2] + gran - 1) // vec) * vec
        out[g] = (box, pitch, off)
        nbytes = box[0] * box[1] * pitch * itemsize
        off += -(-nbytes // SMEM_TILE_ALIGN) * SMEM_TILE_ALIGN
    return out, off


class RingPlane(NamedTuple):
    """One staged plane of a ring (``csrc/stream_ring.cuh``,
    ``csrc/temporal_ring.cuh``): the tile widened by ``e·h`` per side in
    y/z, ``w1`` rows of ``w2`` cells that lie ``pitch`` cells apart, the
    row's first cell ``lead`` cells after the start of its staged row,
    copied by the TMA (``tma``) or in 4-byte granules, ``nbytes`` a plane
    (a multiple of 128: a TMA destination)."""
    w1: int
    w2: int
    pitch: int
    lead: int
    tma: bool
    nbytes: int


def ring_plane(B3, h3, e: int, itemsize: int, org_z: int, pitches,
               allow_tma: bool = True) -> RingPlane:
    """The staged plane of a grid with tap halo ``h3`` over tile ``B3``
    widened by ``e·h``, in a buffer of pitches ``(sx, sy)`` cells whose
    computed box starts at cell ``org_z`` of its rows.  The TMA copies it
    where both pitches and the tile's extent along axis 2 are multiples of
    16 bytes and the box fits a TMA box (at most 256 cells an axis); its
    box then starts ``lead`` cells before the plane's first cell, on a
    16-byte boundary (the card refuses other inner starts).  Else the
    threads copy 4-byte granules; a row's granules start at the one holding
    its first cell, found at run time (bf16).  ``allow_tma=False`` takes
    the granules."""
    gran, vec = 4 // itemsize, 16 // itemsize
    w1, w2 = B3[1] + 2 * e * h3[1], B3[2] + 2 * e * h3[2]
    lead = (org_z - e * h3[2]) % vec
    pitch = -(-(lead + w2 + gran - 1) // vec) * vec
    tma = (allow_tma and all(x * itemsize % 16 == 0 for x in pitches)
           and B3[2] * itemsize % 16 == 0
           and pitch <= TMA_BOX_MAX and w1 <= TMA_BOX_MAX)
    if not tma:
        lead = 0
        pitch = -(-(w2 + gran - 1) // vec) * vec
    nbytes = -(-w1 * pitch * itemsize // SMEM_TILE_ALIGN) * SMEM_TILE_ALIGN
    return RingPlane(w1, w2, pitch, lead, tma, nbytes)


class RingLayout(NamedTuple):
    """A kernel's staged rings in shared memory: each ring's plane, slots
    and byte offset; the slots of the mbarriers (one a slot of the TMA-fed
    ring); the block's dynamic shared memory (slack to align the base to
    128 bytes, the rings, 8 bytes a barrier)."""
    planes: Dict[object, RingPlane]
    slots: Dict[object, int]
    offsets: Dict[object, int]
    barriers: int
    smem: int


def _ring_layout(planes, slots, barriers) -> RingLayout:
    offsets, off = {}, 0
    for r, pl in planes.items():
        offsets[r] = off
        off += slots[r] * pl.nbytes
    return RingLayout(planes, slots, offsets, barriers,
                      SMEM_TILE_ALIGN + off + 8 * barriers)


class GmemColumn(NamedTuple):
    """K1's and K4 gmem's column walk (``csrc/gmem_column.cuh``): each
    lane computes ``cells`` points adjacent along axis 2; ``threads`` a
    block; ``queues``: the slots of each read grid's axis-0 register
    queue, ``2h0 + 1``."""
    cells: int
    threads: int
    queues: Dict[str, int]


# points a lane of K1 and K4 gmem computes along axis 2, where the block's
# rows hold a multiple of them (csrc/gmem_column.cuh)
GMEM_POINTS = 2


def gmem_column(B3, gh3, read_grids) -> GmemColumn:
    """The column walk of tile ``B3`` for the grids ``read_grids``, each
    with tap halo ``gh3[g]``."""
    P = GMEM_POINTS if B3[2] % GMEM_POINTS == 0 else 1
    return GmemColumn(P, B3[1] * (B3[2] // P),
                      {g: 2 * gh3[g][0] + 1 for g in read_grids})


def _smem_bytes(kind: str, B3, gh3) -> int:
    """Shared memory one block of ``kind`` takes with f32 grids (bf16 ones
    take no more): K5's ring of ``SEMI_STAGES`` staged planes, K4 smem's
    two stages of halo'd tiles (``smem_layout``) with their alignment slack
    and mbarriers, of every grid with an off-center tap.  K2's and K3's
    rings: ``_Plan.ring_layout``."""
    ring = [h for h in gh3.values() if any(h)]
    if kind == "semi":
        return 4 * SEMI_STAGES * sum((B3[1] + 2 * h[1]) * (B3[2] + 2 * h[2])
                                     for h in ring)
    if kind == "smem":
        stage = smem_layout(B3, gh3)[1]
        return SMEM_TILE_ALIGN + 2 * stage + SMEM_BARRIER_BYTES
    return 0


def temporal_threads(B3, h3, k: int) -> Tuple[int, int]:
    """K3's threads and the cells each owns (``csrc/temporal_ring.cuh``):
    the cells of sub-step 0's tile (``B3`` widened by ``(k-1)·h``) in
    units of two cells adjacent along axis 1 (one where the tile has an odd
    number of rows or ``h1`` is odd), unit ``i`` (row-major) to thread ``i
    mod threads``."""
    w1 = B3[1] + 2 * (k - 1) * h3[1]
    w2 = B3[2] + 2 * (k - 1) * h3[2]
    pair = 2 if w1 % 2 == 0 and h3[1] % 2 == 0 else 1
    units = w1 * w2 // pair
    threads = min(TEMPORAL_THREADS, -(-units // 32) * 32)
    return threads, pair * -(-units // threads)


def _pitches(shape) -> Tuple[int, int]:
    """The pitches ``(sx, sy)`` in cells of a contiguous tensor of
    ``shape`` in the kernels' 3D form (2D: ``(R0, 1, R1)``)."""
    return (shape[1] * shape[2], shape[2]) if len(shape) == 3 else (shape[1], shape[1])


def check_dtype(what: str, t: torch.Tensor, dtype) -> None:
    """Raise ``TypeError`` unless ``t`` is of a type the kernels take and
    of the launch's ``dtype``."""
    if t.dtype not in ELEM_TYPES:
        raise TypeError(f"{what}: the CUDA kernels take float32 or bfloat16, "
                        f"got {t.dtype}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: the grids of one launch share one dtype, "
                        f"got {t.dtype} and {dtype}")


class _Plan:
    """What the fused and the per-application plans share: the buffers'
    3D form, the view of the region the kernel computes, and the traffic
    model.  A subclass sets ``kernel``, ``kind``, ``ndim``, ``R3``, ``B3``,
    ``gh3``, ``org3`` (each grid's element origin of the computed box, 3D
    form), ``in_grids``, ``out_grids``, ``opnd_grids``, ``time_block``,
    ``swap``, ``step_out_grids`` and ``H``."""

    @property
    def source_file(self) -> str:
        """The hand-written header under ``csrc/`` that holds this plan's
        kernel."""
        return KERNEL_FILES[self.kind]

    def buf3(self, t: torch.Tensor) -> torch.Tensor:
        """A buffer in the kernels' 3D form (a view)."""
        return t if self.ndim == 3 else t.unsqueeze(1)

    def batch_of(self, t: torch.Tensor) -> int:
        """The scenarios a buffer holds along its leading axis (0: an
        unbatched buffer)."""
        return int(t.shape[0]) if t.dim() == self.ndim + 1 else 0

    def scenarios(self, bufs: Dict[str, torch.Tensor], scalars, *more):
        """Each scenario of a launch as the unbatched launch's arguments:
        ``(bufs, scalars, *more)`` with every buffer dict cut to scenario
        ``b`` (views) and ``scalars`` row ``b`` of the ``(B, NS)`` array as
        a dict of floats.  An unbatched launch is its one scenario."""
        nb = self.batch_of(next(iter(bufs.values())))
        if not nb:
            yield (bufs, scalars) + more
            return
        rows = scalars.tolist()
        for b in range(nb):
            scal = dict(zip(self.scal_names, rows[b]))
            yield ((({g: t[b] for g, t in bufs.items()}), scal)
                   + tuple(None if m is None else {g: t[b] for g, t in m.items()}
                           for m in more))

    def scenario_scalars(self, scalars, nb: int, device) -> torch.Tensor:
        """The ``(B, NS)`` f32 array of a batched launch's scalars, on
        ``device``: each scalar a float (shared by the scenarios) or ``B``
        values (one a scenario), rounded to f32 as the kernels take them."""
        cols = [torch.as_tensor(scalars[n], dtype=torch.float32).reshape(-1)
                .expand(nb) for n in self.scal_names]
        out = (torch.stack(cols, 1) if cols
               else torch.zeros((nb, 0), dtype=torch.float32))
        return out.to(device).contiguous()

    def interior3(self, g: str, t: torch.Tensor, x=None) -> torch.Tensor:
        """View of the box grid ``g``'s kernel computes (the interior, or
        ``MapPlan``'s region) in its 3D buffer (plane ``x`` only, when
        given)."""
        w, R = self.org3[g], self.R3
        b = self.buf3(t)
        lead = slice(w[0], w[0] + R[0]) if x is None else w[0] + x
        return b[lead, w[1]:w[1] + R[1], w[2]:w[2] + R[2]]

    def out3(self, g: str, bufs: Dict[str, torch.Tensor], dst=None,
             x=None) -> torch.Tensor:
        """Where the kernel writes output ``g`` (plane ``x`` only, when
        given): its grid's box, or ``dst[g]`` (of the box's shape)."""
        if dst is None:
            return self.interior3(g, bufs[g], x)
        b = self.buf3(dst[g])
        return b if x is None else b[x]

    # K2's and K3's staging path: the TMA where ``ring_plane`` allows it,
    # else granules; False forces granules (a measurement of the two paths
    # sets it before the plan's first ``source``)
    allow_tma = True

    def ring_grids(self):
        """The grids K2 stages in plane rings: those with an off-center
        tap."""
        return [g for g in self.opnd_grids if any(self.gh3[g])]

    def temporal_dlo(self) -> int:
        """The lowest axis-0 offset (at most 0) of a tap of the grid K3's
        sub-steps read off-center that leaves the column (dy or dz not 0):
        its rings of sub-step values keep planes ``x + dlo .. x + h0``."""
        go = self.swap[1]
        return min([0] + [emit.offsets3(t.offsets)[0]
                          for t in self.kernel.taps() if t.grid == go
                          and any(emit.offsets3(t.offsets)[1:])])

    def ring_layout(self, dtype=torch.float32) -> RingLayout:
        """The staged rings of K2 or K3 on grids of ``dtype``
        (``csrc/stream_ring.cuh``, ``csrc/temporal_ring.cuh``).  K2: every
        grid with an off-center tap keeps ``2H + 1 + STREAM_PREFETCH``
        planes (H the largest axis-0 halo; one mbarrier a slot) of the tile
        widened by its halo, in its own type.  K3: ring -1 keeps ``2h0 + 1
        + TEMPORAL_PREFETCH`` planes of the read swap buffer over the tile
        widened by ``k·h`` (its own type, one mbarrier a slot), ring ``j``
        (0 .. k-2) ``h0 - dlo + 1`` planes of sub-step ``j`` over the tile
        widened by ``(k-1-j)·h``, in f32, rows unpadded."""
        es = ELEM_BYTES[dtype]
        if self.kind == "temporal":
            k, go = self.time_block, self.swap[1]
            h = self.gh3[go]
            planes = {-1: ring_plane(self.B3, h, k, es, self.org3[go][2],
                                     self.pitch3[go], self.allow_tma)}
            slots = {-1: 2 * h[0] + 1 + TEMPORAL_PREFETCH}
            for j in range(k - 1):
                w1 = self.B3[1] + 2 * (k - 1 - j) * h[1]
                w2 = self.B3[2] + 2 * (k - 1 - j) * h[2]
                planes[j] = RingPlane(w1, w2, w2, 0, False, -(-w1 * w2 * 4 // 16) * 16)
                slots[j] = h[0] - self.temporal_dlo() + 1
            return _ring_layout(planes, slots, slots[-1])
        ring = self.ring_grids()
        n = 2 * max((self.gh3[g][0] for g in ring), default=0) + 1 + STREAM_PREFETCH
        planes = {g: ring_plane(self.B3, self.gh3[g], 1, es, self.org3[g][2],
                                self.pitch3[g], self.allow_tma) for g in ring}
        return _ring_layout(planes, {g: n for g in planes}, n)

    def stream_tma(self, dtype=torch.float32) -> Dict[str, bool]:
        """K2's and K3's staging path of each ring grid (K3: the read swap
        buffer) on grids of ``dtype``: the TMA or 4-byte ``cp.async``
        granules (``ring_plane``); the wrapper checks that a TMA grid's base
        is 16-byte aligned."""
        lay = self.ring_layout(dtype)
        if self.kind == "temporal":
            return {self.swap[1]: lay.planes[-1].tma}
        return {g: pl.tma for g, pl in lay.planes.items()}

    def ring_source(self, dtype) -> str:
        """The generated tables of K2's and K3's staged rings on grids of
        ``dtype``: each grid's staging path (``grid_tma``) and box lead
        (``grid_lead``), whether a tap reads it (``grid_read``), the planes
        copied ahead (``RT_PRE``); K3 also ``RT_DLO`` (``temporal_dlo``)
        and its thread count ``RT_THREADS``.  Part of the source, so of the
        build key."""
        lay = self.ring_layout(dtype)
        if self.kind == "temporal":
            planes = {self.swap[1]: lay.planes[-1]}
            pre = TEMPORAL_PREFETCH
        else:
            planes, pre = lay.planes, STREAM_PREFETCH
        g_of = self.opnd_grids
        lines = [
            emit.int_table("grid_tma", [int(g in planes and planes[g].tma) for g in g_of]),
            emit.int_table("grid_lead", [planes[g].lead if g in planes else 0 for g in g_of]),
            emit.int_table("grid_read", [int(g in self.in_grids) for g in g_of]),
            f"#define RT_PRE {pre}"]
        if self.kind == "temporal":
            threads, _ = temporal_threads(self.B3, self.gh3[self.swap[1]],
                                          self.time_block)
            lines += [f"#define RT_DLO ({self.temporal_dlo()})",
                      f"#define RT_THREADS {threads}"]
        return "\n".join(lines + [""])

    def gmem_column(self) -> GmemColumn:
        """The column walk of K1 and K4 gmem (``gmem_column``)."""
        return gmem_column(self.B3, self.gh3, self.in_grids)

    def gmem_pairs(self, dtype=torch.float32, bufs=None) -> Dict[str, bool]:
        """Whether K1 and K4 gmem read each grid's units and loaded taps as
        aligned pairs of cells: two points a lane, both pitches even and
        the region's first cell at an even element index (so every lane's
        first cell is), and, given the buffers, the grid's base aligned to
        a pair.  Else each cell is its own load."""
        P = self.gmem_column().cells
        es = ELEM_BYTES[dtype]
        out = {}
        for g in self.opnd_grids:
            sx, sy = self.pitch3[g]
            o = self.org3[g]
            out[g] = (P == 2 and sx % 2 == 0 and sy % 2 == 0
                      and (o[0] * sx + o[1] * sy + o[2]) % 2 == 0
                      and (bufs is None or bufs[g].data_ptr() % (2 * es) == 0))
        return out

    def gmem_source(self, pairs) -> str:
        """The generated part of K1's and K4 gmem's build: the points a lane
        computes (``RT_GMEM_P``), whether a tap reads each grid
        (``grid_read``), each grid's pitches (``grid_sx``, ``grid_sy``: the
        taps' offsets are constants of the code; the launch refuses buffers
        of other pitches) and its pair loads (``grid_vec``,
        ``gmem_pairs``)."""
        g_of = self.opnd_grids
        return "\n".join([
            f"#define RT_GMEM_P {self.gmem_column().cells}",
            emit.int_table("grid_read", [int(g in self.in_grids) for g in g_of]),
            emit.int_table("grid_sx", [self.pitch3[g][0] for g in g_of]),
            emit.int_table("grid_sy", [self.pitch3[g][1] for g in g_of]),
            emit.int_table("grid_vec", [int(pairs[g]) for g in g_of]),
            ""])

    @property
    def kernel_class(self) -> str:
        """The kernel family this plan launches (``kernel_class``)."""
        return kernel_class(self.template, self.time_block,
                            isinstance(self, CudaPlan))

    def build_identity(self, dtype=torch.float32) -> Tuple[str, Tuple[int, int, int]]:
        """What tells this plan's launches apart from another plan's: the
        hash of the source it would compile on grids of ``dtype`` (its
        tile, paths and tables are part of the text) and the box ``R3``
        each launch covers.  Computing it builds nothing."""
        text = self.source(dtype)
        return hashlib.sha256(text.encode()).hexdigest()[:16], self.R3

    def layout_bytes_per_window(self, itemsize: int = 4, batch: int = 0) -> float:
        """Modeled bytes of the once-a-window stages: none for a plan
        without a layout stage (``MapPlan``)."""
        del itemsize, batch
        return 0.0

    # -- traffic model -----------------------------------------------------
    def hbm_bytes_per_step(self, itemsize: int = 4, batch: int = 0) -> float:
        """Modeled bytes one step moves: the loads the blocks make plus the
        writes, an upper bound on device-memory traffic where L1/L2 serve
        re-reads (tile halos of neighbouring blocks, chunk overlaps).  The
        compulsory traffic, each input read and each written buffer written
        once per launch, is the smaller figure ``chip_smoke.py`` bounds with.

        K1 and K4's blocked templates: each operand grid read once over the
        reach of its taps (``R + 2·gh``) and each output written once (a
        grid that is only written is not read).  K2: per tile and chunk the
        halo'd window of each ringed grid, clipped to the tap reach, plus
        the point-read grids.  K5: per tile and chunk each term grid's
        planes ``[x0 - H, x1 + H)`` with its y/z halo, clipped to its reach,
        plus one read per point of each grid its coefficients read.  K3, per
        launch of ``k`` steps divided by ``k``: the read grid's window
        widened by ``k·h`` (clipped to the reach ``[-h, R + h)``), the halo
        cells each sub-step's ring takes from the buffer it stands for, one
        read per computed point and sub-step of every grid read at the
        point, and one write of each swap buffer.  The spares K3 writes are
        written, not fetched: no destination read (the TPU kernel DMAs its
        destination blocks in).  ``batch=B`` scenarios move B times the
        bytes of one."""
        nb = max(1, int(batch))
        R3, B3, k = self.R3, self.B3, self.time_block
        n = math.prod(R3)
        zero = (0, 0, 0)
        read = 0
        if self.kind == "temporal":
            written, other = self.swap
            h = self.gh3[other]
            kh = tuple(k * x for x in h)
            read += _window_cells(R3, B3, kh, h)
            for j in range(k):
                e = tuple((k - 1 - j) * x for x in h)
                inner = _window_cells(R3, B3, e, zero)
                if j < k - 1:        # halo cells of sub-step j's ring
                    read += _window_cells(R3, B3, e, h) - inner
                point = [g for g in self.in_grids if g not in self.swap]
                if j == 0 and written in self.in_grids:
                    point.append(written)
                read += len(point) * inner
            write = len(self.step_out_grids) * n
            return float(nb * (read + write) * itemsize) / k
        if self.kind == "semi":
            # center taps are what the coefficients and constants read
            fields = {t.grid for t in self.kernel.taps() if not any(t.offsets)}
            for g in self.in_grids:
                h = self.gh3[g]
                if any(h):
                    read += _window_cells(R3, B3, (self.H,) + h[1:], h)
                if g in fields:
                    read += n
        else:
            for g in self.in_grids:
                h = self.gh3[g]
                if self.kind == "stream" and any(h):
                    read += _window_cells(R3, B3, h, h)
                else:
                    read += math.prod(R3[ax] + 2 * h[ax] for ax in range(3))
        write = len(self.out_grids) * n
        return float(nb * (read + write) * itemsize)


class CudaPlan(_Plan):
    """Layout and per-step kernel stage of the hopper backend for one
    (kernel, halos, interior, backend, swap); see the module docstring.
    ``kind`` names the kernel ``step`` launches: ``"fused"`` (K1),
    ``"stream"`` (K2), ``"semi"`` (K5) or ``"temporal"`` (K3)."""

    def __init__(self, kernel: ir.StencilIR,
                 halos: Dict[str, Tuple[int, ...]],
                 interior_shape: Tuple[int, ...],
                 backend,
                 swap: Optional[Tuple[str, str]] = None):
        info = analysis.analyze(kernel)
        ndim = kernel.ndim
        if ndim not in (2, 3):
            raise ValueError("hopper backend supports 2D and 3D stencils")
        template = backend.template
        R = tuple(int(s) for s in interior_shape)
        if min(R) < 1:
            raise ValueError(f"empty interior {R}")
        k = int(backend.time_block)       # >= 1, checked by st.hopper
        in_grids, out_grids = info.input_grids, info.output_grids
        if k > 1:
            if swap is None:
                raise ValueError(
                    "time_block > 1 requires a swap pair: the in-kernel "
                    "sub-steps are the leapfrog write+rotate sequence")
            if len(out_grids) != 1 or out_grids[0] != swap[0]:
                raise ValueError(
                    "time_block > 1 supports single-output kernels writing "
                    f"swap[0] (outputs: {out_grids}, swap: {swap})")
        opnd_grids = tuple(g for g in kernel.grid_params
                           if g in set(in_grids) | set(out_grids))
        gh = {g: info.halo_per_grid.get(g, (0,) * ndim) for g in opnd_grids}
        for g in out_grids:
            if any(gh[g]):
                raise ValueError(
                    f"fused time stepping requires center-only taps of the "
                    f"output grid '{g}' (its padded buffer is written "
                    "in-place while neighbors still read it)")
        hw = dict(gh)
        if swap is not None:
            a, b = swap
            if a not in opnd_grids or b not in opnd_grids:
                raise ValueError(f"swap grids {swap} must appear in kernel")
            m = tuple(max(gh[a][ax], gh[b][ax]) for ax in range(ndim))
            hw[a] = hw[b] = m
        for g in opnd_grids:
            for ax in range(ndim):
                if halos[g][ax] < hw[g][ax]:
                    raise ValueError(
                        f"grid '{g}' halo {halos[g][ax]} too small for "
                        f"layout halo {hw[g][ax]} on axis {ax}")
        # the semi template needs a kernel linear in its taps, also when
        # K3 runs the steps (as in the JAX package)
        lin, H = semi_linearize(kernel) if template == "semi" else (None, 0)
        if k > 1:
            kind = "temporal"
        elif template == "semi":
            kind = "semi"
        else:
            kind = "stream" if template in STREAM_TEMPLATES else "fused"
        R3 = to3(R, 1)
        gh3 = {g: to3(gh[g], 0) for g in opnd_grids}

        self.kernel, self.info, self.backend = kernel, info, backend
        self.template, self.kind, self.time_block = template, kind, k
        self.ndim, self.R, self.R3 = ndim, R, R3
        self.halos = {g: tuple(halos[g]) for g in opnd_grids}
        self.gh, self.hw, self.swap = gh, hw, swap
        self.gh3 = gh3
        self.hw3 = {g: to3(hw[g], 0) for g in opnd_grids}
        self.org3 = self.hw3        # the interior starts after the layout halo
        self.in_grids, self.out_grids = in_grids, out_grids
        self.opnd_grids = opnd_grids
        # the buffers one launch writes: with k > 1 both swap buffers
        self.step_out_grids = tuple(swap) if k > 1 else tuple(out_grids)
        self.lin, self.H = lin, H
        self.scal_names = [n for n, _ in kernel.scalar_params]
        self.padded_shapes = {g: tuple(R[ax] + 2 * hw[g][ax]
                                       for ax in range(ndim))
                              for g in opnd_grids}
        self.pitch3 = {g: _pitches(f) for g, f in self.padded_shapes.items()}

        if k > 1 and backend.block is None:
            # the largest default tile whose rings fit
            B = next((b for b in TEMPORAL_BLOCKS[ndim]
                      if self._fit(b)[0] <= SMEM_LIMIT),
                     TEMPORAL_BLOCKS[ndim][-1])
        else:
            B = choose_block(backend.block, template, ndim)
        B3 = to3(B, 1)
        if min(B3) < 1 or B3[1] * B3[2] > 1024:
            raise ValueError(f"block {B}: a thread block covers b1·b2 points "
                             "(1 to 1024)")
        if kind == "fused" and (-(-R3[0] // B3[0]) > 65535
                                or -(-R3[1] // B3[1]) > 65535):
            raise ValueError(f"block {B}: more than 65535 blocks along axis "
                             f"0 or 1 of the interior {R}")
        smem, B3 = self._fit(B)
        if smem > SMEM_LIMIT:
            what = (f"time_block={k}: the {k} plane rings of block {B} need"
                    if kind == "temporal" else f"{kind} tile of block {B} needs")
            raise ValueError(f"{what} {smem} B of shared memory "
                             f"(> {SMEM_LIMIT}); reduce block or time_block")
        self.B, self.B3 = B, B3
        self.smem_bytes = smem
        self.touched = tuple(g for g in opnd_grids
                             if g in set(out_grids) | set(swap or ()))
        self._sources: Dict[tuple, str] = {}

    def _fit(self, B):
        """(shared memory of a block of tile ``B`` with f32 grids, ``B`` in
        3D form)."""
        self.B3 = to3(B, 1)
        if self.kind in ("stream", "temporal"):
            return self.ring_layout().smem, self.B3
        return _smem_bytes(self.kind, self.B3, self.gh3), self.B3

    def count_window(self, steps: int, batch: int = 0) -> None:
        """Accumulate the modeled grid reads/writes of a fusion window of
        ``steps`` into ``TRAFFIC_COUNT``: ``steps // k`` K3 launches (each
        reads every operand grid once and writes both swap buffers) plus
        the remainder as single steps, as the engine runs it.  With
        ``batch=B`` every grid's traffic scales by B; ``steps`` stay one
        scenario's time steps (the JAX package's count)."""
        m, r = divmod(int(steps), self.time_block)
        nb = max(1, int(batch))
        TRAFFIC_COUNT["grid_reads"] += nb * (m + r) * len(self.opnd_grids)
        TRAFFIC_COUNT["grid_writes"] += nb * (m * len(self.step_out_grids)
                                              + r * len(self.out_grids))
        TRAFFIC_COUNT["steps"] += int(steps)

    def layout_bytes_per_window(self, itemsize: int = 4, batch: int = 0) -> float:
        """Modeled bytes of the once-a-window stages that
        ``hbm_bytes_per_step`` leaves out (the counterpart of the JAX
        package's ``PallasPlan.layout_bytes_per_window``): ``to_padded``
        reads and writes the layout window of each operand grid whose halo
        is not its layout halo (a buffer that is a view of its grid costs
        0), ``make_spares`` (K3) copies each buffer a launch writes, and
        ``from_padded`` reads and writes the interior of each touched grid
        whose buffer is not a view of it; after K3 the last buffer may be a
        spare, so a K3 plan charges every touched grid.  ``batch=B``
        scenarios move B times the bytes of one."""
        view = {g: self.halos[g] == self.hw[g] for g in self.opnd_grids}
        cells = sum(2 * math.prod(self.padded_shapes[g])
                    for g in self.opnd_grids if not view[g])
        if self.time_block > 1:
            cells += sum(2 * math.prod(self.padded_shapes[g])
                         for g in self.step_out_grids)
        cells += sum(2 * math.prod(self.R) for g in self.touched
                     if self.time_block > 1 or not view[g])
        return float(max(1, int(batch)) * cells * itemsize)

    # -- layout stage ------------------------------------------------------
    def to_padded(self, arrays: Dict[str, torch.Tensor],
                  fresh: bool = False) -> Dict[str, torch.Tensor]:
        """Each operand grid cut to its layout halo and made contiguous (a
        view of the grid itself when its halo is the layout halo), with a
        leading scenario axis when the grids carry one.  ``fresh``: a grid
        the window writes gets a buffer of its own also then, so the window
        leaves the caller's tensors as they were (the adjoint's carries);
        a grid no window writes may stay a view."""
        padded = {}
        for g in self.opnd_grids:
            ha, w = self.halos[g], self.hw[g]
            sl = (...,) + tuple(slice(ha[ax] - w[ax], ha[ax] + self.R[ax] + w[ax])
                                for ax in range(self.ndim))
            t = arrays[g][sl].contiguous()
            if fresh and g in self.touched and (t.untyped_storage().data_ptr()
                                                == arrays[g].untyped_storage().data_ptr()):
                t = t.clone()
            padded[g] = t
            PAD_COUNT[g] += 1
            PAD_COUNT["total"] += 1
        return padded

    def make_spares(self, padded: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The destination buffers of the first K3 launch of a window, one
        per ``step_out_grids`` entry: a copy of that grid's layout buffer,
        so its halo is the grid's own (K3 writes interiors only)."""
        return {g: padded[g].clone() for g in self.step_out_grids}

    # -- kernel stage ------------------------------------------------------
    def source(self, dtype=torch.float32, bufs=None) -> str:
        """Full CUDA source of this plan's kernel on grids of ``dtype``: the
        generated header and the hand-written template it includes (K1: its
        pair loads follow from the buffers' alignment when ``bufs`` are
        given, else from the plan alone, ``gmem_pairs``)."""
        pairs = (tuple(self.gmem_pairs(dtype, bufs).items())
                 if self.kind == "fused" else ())
        src = self._sources.get((dtype, pairs))
        if src is None:
            point = (emit.gmem_functions(self.kernel, self.opnd_grids, self.out_grids)
                     if self.kind == "fused" else None)
            src = emit.header(self.kernel, self.opnd_grids, self.out_grids,
                              self.gh3, self.B3, point, ELEM_TYPES[dtype])
            if self.kind == "fused":
                # K4 gmem's build, its destinations the grids themselves
                src = ("#define RT_MAP 1\n"
                       f"#define RT_MAP_T {MAP_TEMPLATES['gmem']}\n" + src
                       + self.gmem_source(dict(pairs)))
            elif self.kind == "semi":
                src += emit.semi_functions(self.kernel, self.opnd_grids,
                                           self.out_grids, self.lin, self.H)
            elif self.kind == "temporal":
                src += (f"#define RT_K {self.time_block}\n"
                        f"#define RT_GW {self.opnd_grids.index(self.swap[0])}\n"
                        f"#define RT_GO {self.opnd_grids.index(self.swap[1])}\n")
            if self.kind in ("stream", "temporal"):
                src += self.ring_source(dtype)
            src = self._sources[(dtype, pairs)] = \
                src + f'#include "{KERNEL_FILES[self.kind]}"\n'
        return src

    def launch_args(self, padded: Dict[str, torch.Tensor], scalars,
                    spares: Optional[Dict[str, torch.Tensor]] = None):
        """(meta, scal) ctypes arrays for the C entry (layout in
        ``csrc/common.cuh``; K3 appends its destination pointers, K1 the
        ``RT_MAP`` destinations, which are its output grids' buffers),
        after checking the buffers.  ``scalars``: a dict of floats, or for
        buffers with a scenario axis the ``(B, NS)`` array of
        ``scenario_scalars``."""
        ptrs, sx, sy, org, bs = [], [], [], [], []
        t0 = padded[self.opnd_grids[0]]
        device = t0.device
        nb = self.batch_of(t0)
        lead = (nb,) if nb else ()
        tma = (self.stream_tma(t0.dtype) if self.kind in ("stream", "temporal")
               and t0.dtype in ELEM_BYTES else {})

        def check(g, t):
            if t.device != device:
                raise ValueError(f"grid '{g}' is on {t.device}, not {device}")
            check_dtype(f"grid '{g}'", t, t0.dtype)
            shape = lead + self.padded_shapes[g]
            if tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"grid '{g}': expected a contiguous layout "
                                 f"buffer of shape {shape}")
            # K2, K3 and K5 copy 4-byte granules, and the TMA needs a
            # 16-byte aligned base
            align = 16 if tma.get(g) else 4
            if self.kind in ("semi", "stream", "temporal") and t.data_ptr() % align:
                raise ValueError(f"grid '{g}': the {self.kind} kernel copies "
                                 f"{align}-byte units and needs a {align}-byte "
                                 "aligned buffer")

        for g in self.opnd_grids:
            t = padded[g]
            check(g, t)
            b = self.buf3(t[0] if nb else t)
            w = self.hw3[g]
            ptrs.append(t.data_ptr())
            sx.append(b.stride(0))
            sy.append(b.stride(1))
            org.append(w[0] * b.stride(0) + w[1] * b.stride(1) + w[2])
            bs.append(b.numel())
        dst = []
        for g in (self.step_out_grids if spares is not None else ()):
            check(g, spares[g])
            if any(spares[g].data_ptr() == t.data_ptr() for t in padded.values()):
                raise ValueError(f"spare of '{g}' aliases a buffer the "
                                 "kernel reads")
            dst.append(spares[g].data_ptr())
        if self.kind == "fused":
            i = [self.opnd_grids.index(g) for g in self.out_grids]
            dst = [v[j] for v in (ptrs, sx, sy, org, bs) for j in i]
        # K2's and K3's TMA maps need each buffer's extent along axis 0
        n0 = ([padded[g].shape[-self.ndim] for g in self.opnd_grids]
              if self.kind in ("stream", "temporal") else [])
        tiles = max(1, nb) * -(-self.R3[0] // self.B3[0])
        if tiles > 65535:
            raise ValueError(f"{max(1, nb)} scenarios of {self.R3[0]} planes in "
                             f"tiles of {self.B3[0]}: {tiles} blocks along z "
                             "(at most 65535)")
        sc = 0
        if nb:
            # the scenarios' scalars: a (B, NS) f32 array on the card
            ns = len(self.scal_names)
            if (not isinstance(scalars, torch.Tensor) or tuple(scalars.shape) != (nb, ns)
                    or scalars.dtype != torch.float32 or scalars.device != device
                    or not scalars.is_contiguous()):
                raise ValueError(f"a launch of {nb} scenarios takes its scalars as "
                                 f"a contiguous ({nb}, {ns}) float32 tensor on "
                                 f"{device} (scenario_scalars)")
            if nb * ns > SCENARIO_SCALARS:
                raise ValueError(f"{nb} scenarios of {ns} scalars: more than the "
                                 f"{SCENARIO_SCALARS} a launch holds (csrc/common.cuh)")
            sc = scalars.data_ptr() if ns else 0
            vals = [0.0] * max(1, ns)
        else:
            vals = [float(scalars[n]) for n in self.scal_names] or [0.0]
        meta = (ctypes.c_longlong * (5 * len(ptrs) + 5 + len(dst) + len(n0)))(
            *ptrs, *sx, *sy, *org, *self.R3, max(1, nb), sc, *bs, *dst, *n0)
        scal = (ctypes.c_float * len(vals))(*vals)
        return meta, scal

    def step(self, padded: Dict[str, torch.Tensor],
             scalars: Dict[str, float],
             spares: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        """One launch on the layout buffers.  ``time_block=1``: one step,
        outputs in place (K1, K2 or K5 by template); returns ``padded``.
        ``time_block=k>1``: K3 advances ``k`` steps and writes both swap
        buffers into ``spares`` (``make_spares``; required), leaving the
        buffers it reads intact; returns ``padded`` with the swap names
        bound to the spares.  Buffer↔name bindings are otherwise untouched:
        the caller applies the leapfrog rotation parity (``k`` rotations)
        to the names, and the buffers just read become the next launch's
        spares."""
        from .fused_step import fused_step
        from .semi_step import semi_step
        from .stream_step import stream_step
        from .temporal_step import temporal_step
        if self.kind == "temporal":
            if spares is None:
                raise ValueError(
                    "time_block > 1 kernel stage is double-buffered: pass "
                    "spares= destination buffers (plan.make_spares)")
            temporal_step(self, padded, spares, scalars)
            return {**padded, **{g: spares[g] for g in self.step_out_grids}}
        {"fused": fused_step, "stream": stream_step,
         "semi": semi_step}[self.kind](self, padded, scalars)
        return padded

    # -- boundary stage ----------------------------------------------------
    def from_padded(self, padded: Dict[str, torch.Tensor],
                    arrays: Dict[str, torch.Tensor],
                    fresh: bool = False) -> Dict[str, torch.Tensor]:
        """Write the touched grids' layout interiors back into the full
        (grid-halo'd) arrays, in place; a layout buffer that is a view of
        its grid needs no copy (after K3 the final buffer may be a spare,
        which is copied).  ``fresh`` (``to_padded(fresh=True)``'s buffers):
        the arrays are not written; a touched grid's result is its layout
        buffer where that is the whole grid, else a copy of the grid with
        the interior replaced."""
        out = dict(arrays)
        for g in self.touched:
            ha, w, R = self.halos[g], self.hw[g], self.R
            inner = lambda h: (...,) + tuple(slice(h[ax], h[ax] + R[ax])  # noqa: E731
                                             for ax in range(self.ndim))
            if fresh:
                if ha == w:
                    out[g] = padded[g]
                    continue
                out[g] = arrays[g].clone()
            dst, src = out[g][inner(ha)], padded[g][inner(w)]
            if dst.data_ptr() == src.data_ptr() and dst.stride() == src.stride():
                continue
            dst.copy_(src)
        return out


def plan_cuda(kernel: ir.StencilIR,
              halos: Dict[str, Tuple[int, ...]],
              interior_shape: Tuple[int, ...],
              backend,
              swap: Optional[Tuple[str, str]] = None) -> CudaPlan:
    """Build the split (layout / per-step kernel) lowering used by the
    fused time-loop engine (``repro_torch.core.timeloop``)."""
    return CudaPlan(kernel, halos, interior_shape, backend, swap=swap)


class MapPlan(_Plan):
    """Per-application kernel stage of the hopper backend (``st.map``) for
    one (kernel, halos, interior, region, backend); see the module
    docstring.  ``kind`` names the kernel ``apply`` launches: ``"map"`` (K4
    gmem/f4/smem), ``"stream"`` (K4 shift/unroll, K2's source) or
    ``"semi"`` (K5).  ``in_place`` is True when every output grid has
    center-only taps: no thread then reads a point another thread writes."""

    def __init__(self, kernel: ir.StencilIR,
                 halos: Dict[str, Tuple[int, ...]],
                 interior_shape: Tuple[int, ...],
                 region,
                 backend):
        info = analysis.analyze(kernel)
        ndim = kernel.ndim
        if ndim not in (2, 3):
            raise ValueError("hopper backend supports 2D and 3D stencils")
        interior = tuple(int(s) for s in interior_shape)
        if region is None:
            region = tuple((0, s) for s in interior)
        region = tuple((int(b), int(e)) for b, e in region)
        if len(region) != ndim or not all(
                0 <= b < e <= n for (b, e), n in zip(region, interior)):
            raise ValueError(f"region {region} is not a non-empty box of the "
                             f"interior {interior}")
        R = tuple(e - b for b, e in region)
        if int(getattr(backend, "time_block", 1) or 1) > 1:
            raise ValueError(
                "time_block > 1 is a fused time-loop feature (st.timeloop / "
                "plan_cuda); the per-application path advances one step")
        template = backend.template
        in_grids, out_grids = info.input_grids, info.output_grids
        opnd_grids = tuple(g for g in kernel.grid_params
                           if g in set(in_grids) | set(out_grids))
        gh = {g: info.halo_per_grid.get(g, (0,) * ndim) for g in opnd_grids}
        # a tap may leave the region by the kernel halo, never the grid
        for g in in_grids:
            for ax in range(ndim):
                h, b, e = halos[g][ax], region[ax][0], region[ax][1]
                if h + b < gh[g][ax] or e + gh[g][ax] > interior[ax] + h:
                    raise ValueError(
                        f"grid '{g}' halo {h} too small for kernel halo "
                        f"{gh[g][ax]} at region {region[ax]}")
        gh3 = {g: to3(gh[g], 0) for g in opnd_grids}
        if template == "smem" and backend.block is None:
            # the largest default tile whose two stages fit
            B = next((b for b in SMEM_BLOCKS[ndim] if _smem_bytes(
                "smem", to3(b, 1), gh3) <= SMEM_LIMIT), SMEM_BLOCKS[ndim][-1])
        else:
            B = choose_block(backend.block, template, ndim,
                             per_application=True)
        B3 = to3(B, 1)
        if template == "f4" and B3[2] % 4:
            raise ValueError(f"f4 template: block {B} must cover a multiple "
                             "of 4 points along the last axis (each thread "
                             "computes 4)")
        threads = B3[1] * B3[2] // (4 if template == "f4" else 1)
        if min(B3) < 1 or not 1 <= threads <= 1024:
            raise ValueError(f"block {B}: a thread block of {threads} "
                             "threads (1 to 1024)")
        R3 = to3(R, 1)
        # smem's persistent blocks walk the tiles, the others launch one
        # block a tile
        if template != "smem" and (-(-R3[0] // B3[0]) > 65535
                                   or -(-R3[1] // B3[1]) > 65535):
            raise ValueError(f"block {B}: more than 65535 blocks along axis "
                             f"0 or 1 of the region {R}")
        lin, H = semi_linearize(kernel) if template == "semi" else (None, 0)
        if template == "semi":
            kind = "semi"
        else:
            kind = "stream" if template in STREAM_TEMPLATES else "map"

        self.kernel, self.info, self.backend = kernel, info, backend
        self.template, self.kind, self.time_block = template, kind, 1
        self.ndim, self.R, self.B = ndim, R, B
        self.R3, self.B3 = R3, B3
        self.interior, self.region = interior, region
        self.halos = {g: tuple(halos[g]) for g in opnd_grids}
        self.gh, self.gh3, self.swap = gh, gh3, None
        self.org3 = {g: to3([halos[g][ax] + region[ax][0]
                             for ax in range(ndim)], 0) for g in opnd_grids}
        self.full_shapes = {g: tuple(n + 2 * halos[g][ax]
                                     for ax, n in enumerate(interior))
                            for g in opnd_grids}
        # the pitches (sx, sy) of each contiguous full tensor in 3D form
        self.pitch3 = {g: _pitches(f) for g, f in self.full_shapes.items()}
        self.in_grids, self.out_grids = in_grids, out_grids
        self.opnd_grids = opnd_grids
        self.step_out_grids = tuple(out_grids)
        self.in_place = not any(any(gh[g]) for g in out_grids)
        self.lin, self.H = lin, H
        smem = (self.ring_layout().smem if kind == "stream" else
                _smem_bytes("smem" if template == "smem" else kind, B3, gh3))
        if smem > SMEM_LIMIT:
            raise ValueError(f"{template} tile of block {B} needs {smem} B of "
                             f"shared memory (> {SMEM_LIMIT}); reduce block")
        self.smem_bytes = smem
        self.scal_names = [n for n, _ in kernel.scalar_params]
        self._sources: Dict[tuple, str] = {}

    @property
    def source_file(self) -> str:
        """The hand-written header that holds this plan's kernel: smem's is
        ``map_smem.cuh``, which ``map_step.cuh`` includes."""
        return "map_smem.cuh" if self.template == "smem" else KERNEL_FILES[self.kind]

    def hbm_bytes_per_step(self, itemsize: int = 4) -> float:
        """The fused plan's model of the kernel's traffic (``_Plan``) plus,
        when the outputs go to destination buffers, the copy of each into
        its grid (one read, one write per point)."""
        copy = 0 if self.in_place else 2 * len(self.out_grids) * math.prod(self.R3)
        return super().hbm_bytes_per_step(itemsize) + float(copy * itemsize)

    def f4_org_mod4(self) -> Dict[str, Optional[int]]:
        """K4 f4's load path per grid: where both pitches are multiples of 4
        cells, the place of the region's first cell in its aligned vector of
        4 (then every tap row of a group starting at a multiple of 4 from
        it has a place fixed by the plan: the aligned path); else None (the
        kernel aligns each row at run time)."""
        out = {}
        for g in self.opnd_grids:
            sx, sy = self.pitch3[g]
            o = self.org3[g]
            out[g] = ((o[0] * sx + o[1] * sy + o[2]) % 4
                      if sx % 4 == 0 and sy % 4 == 0 else None)
        return out

    def smem_tma(self, dtype=torch.float32) -> Dict[str, bool]:
        """K4 smem's staging path per grid with an off-center tap, on grids
        of ``dtype``: TMA where both pitches are multiples of 16 bytes,
        every tile's box starts on a 16-byte boundary along axis 2 (the
        card refuses a box whose inner start is not: its first cell is
        ``z0 - h2`` of the region, z0 a multiple of b2) and the halo'd box
        fits a TMA box (at most 256 cells an axis); the wrapper checks that
        the base is 16-byte aligned.  Else ``cp.async`` in 4-byte
        granules."""
        es = ELEM_BYTES[dtype]
        layout, _ = smem_layout(self.B3, self.gh3, es)
        return {g: all(p * es % 16 == 0 for p in self.pitch3[g])
                and (self.org3[g][2] - self.gh3[g][2]) * es % 16 == 0
                and self.B3[2] * es % 16 == 0
                and max(box[0], box[1], pitch) <= TMA_BOX_MAX
                for g, (box, pitch, _) in layout.items()}

    def source(self, dtype=torch.float32, bufs=None) -> str:
        """Full CUDA source of this plan's kernel on grids of ``dtype``:
        ``RT_MAP``, the generated header (f4: the families and queue pieces
        of its tap rows, with the load path each grid's pitches allow, and
        their point function; smem: each grid's staging path, and whether
        a tap reads it, so that an output none reads is not loaded; gmem:
        its lanes, pitches and pair loads, ``gmem_source``, the pair loads
        following from the grids' alignment when ``bufs`` are given) and
        the hand-written template it includes.  The paths follow from the
        grids' full shapes and the region, so they are part of the build
        key."""
        gmem = self.kind == "map" and self.template == "gmem"
        pairs = tuple(self.gmem_pairs(dtype, bufs).items()) if gmem else ()
        src = self._sources.get((dtype, pairs))
        if src is None:
            src = "#define RT_MAP 1\n"
            point = None
            if self.kind == "map":
                src += f"#define RT_MAP_T {MAP_TEMPLATES[self.template]}\n"
                if self.template == "f4":
                    point = emit.f4_functions(self.kernel, self.opnd_grids,
                                              self.out_grids,
                                              self.f4_org_mod4())
                elif gmem:
                    point = emit.gmem_functions(self.kernel, self.opnd_grids,
                                                self.out_grids)
            src += emit.header(self.kernel, self.opnd_grids, self.out_grids,
                               self.gh3, self.B3, point, ELEM_TYPES[dtype])
            if self.template == "smem":
                tma = self.smem_tma(dtype)
                src += "\n".join([
                    emit.int_table("grid_tma", [int(tma.get(g, False))
                                                for g in self.opnd_grids]),
                    emit.int_table("grid_read", [int(g in self.in_grids)
                                                 for g in self.opnd_grids]),
                    ""])
            if gmem:
                src += self.gmem_source(dict(pairs))
            if self.kind == "semi":
                src += emit.semi_functions(self.kernel, self.opnd_grids,
                                           self.out_grids, self.lin, self.H)
            if self.kind == "stream":
                src += self.ring_source(dtype)
            src = self._sources[(dtype, pairs)] = \
                src + f'#include "{KERNEL_FILES[self.kind]}"\n'
        return src

    def make_dst(self, bufs: Dict[str, torch.Tensor]):
        """The destination buffers of one application: None when it writes
        in place, else one uninitialised tensor of the region's shape per
        output grid, on the grids' device."""
        if self.in_place:
            return None
        t = bufs[self.opnd_grids[0]]
        return {g: torch.empty(self.R, dtype=t.dtype, device=t.device)
                for g in self.out_grids}

    def launch_args(self, bufs: Dict[str, torch.Tensor], scalars,
                    dst: Optional[Dict[str, torch.Tensor]] = None):
        """(meta, scal) ctypes arrays for the C entry (layout in
        ``csrc/common.cuh`` with ``RT_MAP``), after checking the grids and
        the destinations (``dst``: None when in place, else ``make_dst``'s
        buffers, which may not overlap a grid)."""
        t0 = bufs[self.opnd_grids[0]]
        device = t0.device
        # f4 loads vectors of 4 cells, semi and smem copy 4-byte granules,
        # and smem's TMA copies need a 16-byte aligned base
        align = 1
        if self.kind == "map" and self.template == "f4":
            align = 4 * t0.element_size()
        elif self.kind in ("semi", "stream") or self.template == "smem":
            align = 4
        tma = (self.smem_tma(t0.dtype) if self.template == "smem" else
               self.stream_tma(t0.dtype) if self.kind == "stream" else {})

        def check(what, t, shape, align=align):
            if t.device != device:
                raise ValueError(f"{what} is on {t.device}, not {device}")
            check_dtype(what, t, t0.dtype)
            if tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"{what}: expected a contiguous tensor of "
                                 f"shape {shape}")
            if t.data_ptr() % align:
                raise ValueError(f"{what}: the {self.template} template loads "
                                 f"{align}-byte units and needs a {align}-byte "
                                 "aligned tensor")

        def span(t):
            return t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()

        ptrs, sx, sy, org = [], [], [], []
        for g in self.opnd_grids:
            t = bufs[g]
            check(f"grid '{g}'", t, self.full_shapes[g],
                  16 if tma.get(g) else align)
            b, w = self.buf3(t), self.org3[g]
            ptrs.append(t.data_ptr())
            sx.append(b.stride(0))
            sy.append(b.stride(1))
            org.append(w[0] * b.stride(0) + w[1] * b.stride(1) + w[2])
        full = {g: dst is not None and self.full_dst(g, dst[g])
                for g in self.out_grids}
        if dst is None and not self.in_place:
            raise ValueError("destinations: None exactly when the plan "
                             "writes in place (make_dst)")
        if self.in_place and dst is not None and not all(full.values()):
            raise ValueError("destinations of the region's shape: only where "
                             "the plan does not write in place (make_dst)")
        d, dsx, dsy, dorg = [], [], [], []
        for g in self.out_grids:
            if dst is None:
                i = self.opnd_grids.index(g)
                d.append(ptrs[i])
                dsx.append(sx[i])
                dsy.append(sy[i])
                dorg.append(org[i])
                continue
            t = dst[g]
            check(f"destination of '{g}'", t,
                  self.full_shapes[g] if full[g] else self.R)
            lo, hi = span(t)
            if any(lo < span(b)[1] and span(b)[0] < hi for b in bufs.values()):
                raise ValueError(f"destination of '{g}' aliases a grid the "
                                 "kernel reads")
            b, w = self.buf3(t), self.org3[g]
            d.append(t.data_ptr())
            dsx.append(b.stride(0))
            dsy.append(b.stride(1))
            dorg.append(w[0] * b.stride(0) + w[1] * b.stride(1) + w[2]
                        if full[g] else 0)
        # smem's and K2's TMA maps need each grid's extent along axis 0
        n0 = ([bufs[g].shape[0] for g in self.opnd_grids]
              if self.template == "smem" or self.kind == "stream" else [])
        # one scenario, scalars by value
        bs = [bufs[g].numel() for g in self.opnd_grids]
        meta = (ctypes.c_longlong * (5 * len(ptrs) + 5 + 5 * len(d) + len(n0)))(
            *ptrs, *sx, *sy, *org, *self.R3, 1, 0, *bs, *d, *dsx, *dsy, *dorg,
            *([0] * len(d)), *n0)
        vals = [float(scalars[n]) for n in self.scal_names] or [0.0]
        scal = (ctypes.c_float * len(vals))(*vals)
        return meta, scal

    def full_dst(self, g: str, t: torch.Tensor) -> bool:
        """Whether ``t``, a destination of output ``g``, has the grid's full
        shape (the kernel then writes its region at the grid's place) rather
        than the region's."""
        return tuple(t.shape) == self.full_shapes[g]

    def out3(self, g: str, bufs: Dict[str, torch.Tensor], dst=None,
             x=None) -> torch.Tensor:
        """``_Plan.out3``; a destination of the grid's full shape is written
        at the region's place in it."""
        if dst is not None and self.full_dst(g, dst[g]):
            return self.interior3(g, dst[g], x)
        return super().out3(g, bufs, dst, x)

    def apply(self, arrays: Dict[str, torch.Tensor],
              scalars: Dict[str, float],
              out: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, torch.Tensor]:
        """One application on the grids' full tensors: the kernel of
        ``kind`` (on CPU tensors its plain version) writes the outputs'
        region in place or into ``make_dst``'s buffers, which are then
        copied into it.  Cells outside the region, halos included, keep
        their values.  ``out`` (a tensor of each output grid's full shape,
        overlapping no grid) takes the region's values instead of the
        grids, which are then only read: the kernel writes it directly, so
        taps read the old values wherever they reach.  Returns
        ``arrays``."""
        from .map_step import map_step
        from .semi_step import semi_step
        from .stream_step import stream_step
        bufs = {g: arrays[g] for g in self.opnd_grids}
        dtype = bufs[self.opnd_grids[0]].dtype
        for g, t in bufs.items():
            check_dtype(f"grid '{g}'", t, dtype)
        if out is not None:
            dst = {g: out[g] for g in self.out_grids}
            for g, t in dst.items():
                check_dtype(f"destination of '{g}'", t, dtype)
                if not self.full_dst(g, t):
                    raise ValueError(f"out['{g}']: expected the grid's shape "
                                     f"{self.full_shapes[g]}")
        else:
            dst = self.make_dst(bufs)
        {"map": map_step, "stream": stream_step,
         "semi": semi_step}[self.kind](self, bufs, scalars, dst)
        if dst is not None and out is None:
            for g in self.out_grids:
                self.interior3(g, bufs[g]).copy_(self.buf3(dst[g]))
        return arrays


def lower_hopper(kernel: ir.StencilIR,
                 halos: Dict[str, Tuple[int, ...]],
                 interior_shape: Tuple[int, ...],
                 region,
                 backend) -> MapPlan:
    """The per-application lowering of ``st.map`` on the hopper backend
    (the counterpart of the JAX package's ``lower_pallas``); the plan's
    ``apply(arrays, scalars)`` runs it."""
    return MapPlan(kernel, halos, interior_shape, region, backend)
