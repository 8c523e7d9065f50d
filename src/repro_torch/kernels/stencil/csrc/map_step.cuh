// One application of a kernel over a box of points, one launch: K4, the
// per-application kernel of st.map, under the blocked templates gmem
// (RT_MAP_T 0), f4 (1) and smem (2, map_smem.cuh); and K1, the fused time
// step of st.timeloop (the gmem build, every blocked template).
//
// K4 replaces the JAX package's kernels/stencil/codegen.py lower_pallas
// with _make_body_blocked: gmem and f4 read each tap by concatenating
// slices of neighbour blocks, smem pastes them into a VMEM scratch tile
// first.  Here the grids are their full halo'd tensors (RT_MAP,
// common.cuh): org is the region's first point, so a tap outside the
// region reads the real neighbouring cell, as the JAX body does through
// its padded slice, and outputs go to the plan's destinations (store_out):
// in place when every output grid has center-only taps, else a buffer no
// block reads.
//
// K1 replaces _make_body_fused, tap branch (PallasPlan._call_for,
// time_block=1): one step in the persistent layout, outputs written in
// place, the old value kept outside the interior.  Its grids are the
// plan's layout buffers with org at the interior's first point, and its
// destinations are its output grids' own buffers: legal because CudaPlan
// admits only output grids with center-only taps, so no thread reads a
// point another thread writes.  The pass-through outside the interior is
// cells no lane stores.
//
// gmem: a thread block covers an RT_TB0 x RT_TB1 x RT_TB2 tile of the box;
// its lanes (gmem_column.cuh) cover the RT_TB1 x RT_TB2 face, two points
// adjacent along axis 2 a lane where the block allows, and each walks the
// RT_TB0 planes of its column.  Taps come from device memory through the
// read-only path, with no staging, so the build takes any pitch, region
// origin, 2D shape and destination:
//   axis 0: each grid a tap reads keeps its 2h0 + 1 centre-column units in
//           a register queue (a prologue of 2h0 loads, then one load a
//           plane, issued a plane ahead; center-only grids: one slot);
//   axis 2: taps in the lane's own cells come from the queue too;
//   other taps are loads at constant offsets: the plan's pitches are part
//   of the source (grid_sx, grid_sy; the launch refuses others).  Where a
//   grid's rows start on even cells (grid_vec, _Plan.gmem_pairs) every
//   load of it reads the aligned pair of cells that holds its tap (8 bytes
//   f32, 4 bf16), so a warp's row of 64 cells is 2 (f32) or 1 (bf16) lines
//   for one load instruction.
//   Lanes past the box load clamped cells and do not store.  A thread
//   reads ahead only cells of its own column, so writing in place stays
//   legal (output grids have center-only taps).  star3d4r: 13 loads a
//   lane for its 2 points (the queue's 1, axis 1's 8, axis 2's 4 pairs),
//   against 50 when every tap was a load.
// f4: each thread computes 4 consecutive points along axis 2 from tap rows
//   loaded as aligned vectors of 4 cells and carried along its column in
//   register queues (f4_rows.cuh): the TPU's lane-aligned blocks become
//   16-byte loads (8-byte ones of 4 bf16 cells), each loaded once a
//   column; where the grids' pitches are multiples of 4 cells the rows'
//   alignment is fixed when the plan is made.
// smem: persistent blocks stage each tile's halo'd box by TMA or cp.async
// into one of two stages while they evaluate the other (map_smem.cuh).
//
// Bound: device-memory bytes.  One application must read each input grid
// once and write each output once: star3d4r at 512^3 moves 2 x 512^3 x 4 B
// = 1.07 GB, 0.321 ms at 3.35 TB/s; acoustic ISO five grid passes, 0.801
// ms (bf16 grids: half the bytes).  The 2h+1 taps along each axis are
// re-read from L1/L2 (gmem: axes 1 and off-axis), from registers (gmem
// along axes 0 and 2, f4) or from shared memory (smem, and registers along
// axis 0); the designs differ only in where those re-reads are served.
#include "common.cuh"

#if RT_MAP_T == 1
#include "f4_rows.cuh"
constexpr int kRowThreads = RT_TB2 / 4;
constexpr int kThreads = RT_TB1 * kRowThreads;

// the aligned vector of 4 cells at ptr, as f32
struct DevLoad {
  __device__ __forceinline__ void operator()(const float* ptr, float* out) const {
    const float4 q = __ldg(reinterpret_cast<const float4*>(ptr));
    out[0] = q.x;
    out[1] = q.y;
    out[2] = q.z;
    out[3] = q.w;
  }
  __device__ __forceinline__ void operator()(const __nv_bfloat16* ptr, float* out) const {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(ptr));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  }
};

// the m points of a group in the region, stored
struct DevStore {
  const Params& p;
  int y, z0, m;
  __device__ __forceinline__ void operator()(int x, const float (&out)[4][RT_NO]) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < m) {
#pragma unroll
        for (int o = 0; o < RT_NO; ++o) store_out(p, o, x, y, z0 + j, out[j][o]);
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads) map_step_kernel(const Params p) {
  const int z0 = blockIdx.x * RT_TB2 + 4 * threadIdx.x;
  const int y = blockIdx.y * RT_TB1 + threadIdx.y;
  const int x0 = blockIdx.z * RT_TB0;
  if (z0 >= p.R2 || y >= p.R1) return;
  const int m = min(4, p.R2 - z0);
  f4_column(p.g, p.sx, p.sy, p.org, p.s, x0, min(x0 + RT_TB0, p.R0), y, z0, m, DevLoad{},
            DevStore{p, y, z0, m});
}

#elif RT_MAP_T == 2
#include "map_smem.cuh"

#else
#include "gmem_column.cuh"
constexpr int kRowThreads = RT_TB2 / kP;
// blocks an SM the registers are budgeted for: three of 256 threads
constexpr int kMinBlocks = kThreads < 768 ? 768 / kThreads : 1;

// a lane's kP cells of one row of a grid, as f32
struct Unit {
  float v[kP];
};

// the aligned pair of cells at ptr, as f32 (one 8-byte or 4-byte load)
__device__ __forceinline__ void ld_pair(const float* ptr, float* out) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(ptr));
  out[0] = v.x;
  out[1] = v.y;
}
__device__ __forceinline__ void ld_pair(const __nv_bfloat16* ptr, float* out) {
  const unsigned v = __ldg(reinterpret_cast<const unsigned*>(ptr));
  out[0] = __uint_as_float(v << 16);
  out[1] = __uint_as_float(v & 0xffff0000u);
}

// Grid G's cell (DX, DY, DZ) from `base` (a lane's cell of plane 0 of its
// row) at plane xp: the pitches are the plan's (grid_sx, grid_sy), so the
// tap's offset is a constant of the load.
template <int G, int DX = 0, int DY = 0, int DZ = 0>
__device__ __forceinline__ const elem_t* cell(const elem_t* base, int xp) {
  return base + static_cast<long long>(xp) * grid_sx(G) +
         (static_cast<long long>(DX) * grid_sx(G) + static_cast<long long>(DY) * grid_sy(G) + DZ);
}

// Grid G's unit of plane xp at the lane's column (`row`: the grid's row at
// plane 0; zl: the lane's first point), its cells clamped to the grid's
// reach along axis 2 (a lane past the region's end loads cells no stored
// point reads): an aligned pair where the grid's rows start on even cells.
template <int G>
__device__ __forceinline__ Unit load_unit(const Params& p, const elem_t* const* row, int xp,
                                          int zl) {
  const int zhi = p.R2 - 1 + grid_h2(G);
  Unit u;
  if constexpr (kP == 2 && grid_vec(G)) {
    ld_pair(cell<G>(row[G] + min(zl, zhi & ~1), xp), u.v);
  } else {
#pragma unroll
    for (int j = 0; j < kP; ++j) u.v[j] = ld_elem(cell<G>(row[G] + min(zl + j, zhi), xp));
  }
  return u;
}

// Before the column's first plane x0: each queue's planes x0 - h0 ..
// x0 + h0 - 1 and the lead, plane x0 + h0.
template <int G>
__device__ __forceinline__ void prologue(const Params& p, const elem_t* const* row, int zl,
                                         int x0, Unit* q, Unit* lead) {
  if constexpr (G < RT_NG) {
    if constexpr (grid_read(G) != 0) {
#pragma unroll
      for (int s = 0; s < prologue_planes(G); ++s)
        q[queue_offset(G) + s] = load_unit<G>(p, row, x0 - grid_h0(G) + s, zl);
      lead[G] = load_unit<G>(p, row, x0 + grid_h0(G), zl);
    }
    prologue<G + 1>(p, row, zl, x0, q, lead);
  }
}

// At plane x: the lead (plane x + h0) into the queue's last slot.
template <int G>
__device__ __forceinline__ void advance(Unit* q, const Unit* lead) {
  if constexpr (G < RT_NG) {
    if constexpr (grid_read(G) != 0) q[queue_offset(G) + 2 * grid_h0(G)] = lead[G];
    advance<G + 1>(q, lead);
  }
}

// The lead of plane x1 = x + 1 (plane x1 + h0), loaded before plane x's
// arithmetic.
template <int G>
__device__ __forceinline__ void issue(const Params& p, const elem_t* const* row, int zl, int x1,
                                      Unit* lead) {
  if constexpr (G < RT_NG) {
    if constexpr (grid_read(G) != 0) lead[G] = load_unit<G>(p, row, x1 + grid_h0(G), zl);
    issue<G + 1>(p, row, zl, x1, lead);
  }
}

// every queue one slot on, for the next plane
template <int G>
__device__ __forceinline__ void shift(Unit* q) {
  if constexpr (G < RT_NG) {
#pragma unroll
    for (int i = 0; i + 1 < queue_len(G); ++i) q[queue_offset(G) + i] = q[queue_offset(G) + i + 1];
    shift<G + 1>(q);
  }
}

// The tap reader of the lane's point J at plane x (zl: the lane's first
// point; zp: the point along axis 2, clamped to the region).
template <int J>
struct ColumnReader {
  const Params& p;
  const Unit* q;
  const elem_t* const* row;
  int x, zl, zp;
  template <int G, int DX, int DY, int DZ>
  __device__ __forceinline__ float at() const {
    if constexpr (DY == 0 && DZ == 0) {
      return q[tap_slot(G, DX)].v[J];
    } else if constexpr (DX == 0 && DY == 0 && lane_of(J + DZ) == 0) {
      return q[tap_slot(G, 0)].v[cell_of(J + DZ)];     // a cell of the lane's own unit
    } else if constexpr (kP == 2 && grid_vec(G)) {
      // the aligned pair holding the cell, its start clamped to the tap's
      // reach (a no-op for a point in the region)
      constexpr int e = (J + DZ) & ~1;
      float v[2];
      ld_pair(cell<G, DX, DY, e>(row[G] + min(zl, ((p.R2 - 1 + DZ) & ~1) - e), x), v);
      return v[J + DZ - e];
    } else {
      return ld_elem(cell<G, DX, DY, DZ>(row[G] + zp, x));
    }
  }
};

template <int J>
__device__ __forceinline__ void points(const Params& p, const float* s, const Unit* q,
                                       const elem_t* const* row, int x, int zl,
                                       float (&out)[kP][RT_NO]) {
  if constexpr (J < kP) {
    const ColumnReader<J> rd{p, q, row, x, zl, min(zl + J, p.R2 - 1)};
    stencil_point(rd, s, out[J]);
    points<J + 1>(p, s, q, row, x, zl, out);
  }
}

template <bool kBatch>
__global__ void __launch_bounds__(kThreads, kMinBlocks) map_step_kernel(const Params p,
                                                                        const Scenarios sn) {
  const int zl = blockIdx.x * RT_TB2 + kP * threadIdx.x;
  const int y = blockIdx.y * RT_TB1 + threadIdx.y;
  int x0;
  const int b = scenario_of<kBatch>(p, RT_TB0, &x0);
  const int nx = min(x0 + RT_TB0, p.R0) - x0;
  const float* s = scenario_scalars<kBatch>(p, b);
  // each grid's row at plane 0 (rows past the region's end: its last row,
  // whose points are not stored)
  const elem_t* row[RT_NG];
#pragma unroll
  for (int g = 0; g < RT_NG; ++g)
    row[g] = grid_buf<kBatch>(p, sn, g, b) + p.org[g] +
             static_cast<long long>(min(y, p.R1 - 1)) * grid_sy(g);
  Unit q[kQueue], lead[RT_NG];
  prologue<0>(p, row, zl, x0, q, lead);
  for (int t = 0; t < nx; ++t) {
    const int x = x0 + t;
    advance<0>(q, lead);
    if (t + 1 < nx) issue<0>(p, row, zl, x + 1, lead);   // the same for the block
    float out[kP][RT_NO];
    points<0>(p, s, q, row, x, zl, out);
    if (y < p.R1) {
#pragma unroll
      for (int j = 0; j < kP; ++j) {
        if (zl + j < p.R2) {
#pragma unroll
          for (int o = 0; o < RT_NO; ++o) store_out<kBatch>(p, sn, o, x, y, zl + j, out[j][o], b);
        }
      }
    }
    shift<0>(q);
  }
}
#endif

#if RT_MAP_T != 2
extern "C" int rt_map_step(const void* meta, const void* scal, void* stream) {
  const Params p = rt_params(meta, scal);
  const Scenarios sn = rt_scenarios(meta);
#if RT_MAP_T == 0
  // the build's pitches are the plan's: buffers of another shape are refused
  for (int g = 0; g < RT_NG; ++g)
    if (p.sx[g] != grid_sx(g) || p.sy[g] != grid_sy(g))
      return static_cast<int>(cudaErrorInvalidValue);
#endif
  const dim3 threads(kRowThreads, RT_TB1, 1);
#if RT_MAP_T == 0
  // every scenario's axis-0 tiles (one scenario but for K1 under batch=B)
  const unsigned nz = scenario_blocks(p, sn, RT_TB0);
  if (nz == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
#else
  if (batched(sn)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nz = (p.R0 + RT_TB0 - 1) / RT_TB0;
#endif
  const dim3 blocks((p.R2 + RT_TB2 - 1) / RT_TB2, (p.R1 + RT_TB1 - 1) / RT_TB1, nz);
#if RT_MAP_T == 0
  const cudaError_t e = scenario_scalars_to(sn, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (batched(sn))
    map_step_kernel<true><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(p, sn);
  else
    map_step_kernel<false><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(p, sn);
#else
  map_step_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
#endif
  return static_cast<int>(cudaGetLastError());
}
#endif
