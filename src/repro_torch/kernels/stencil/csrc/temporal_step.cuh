// K3 — in-kernel temporal blocking: RT_K leapfrog sub-steps per launch, as
// RT_K pipelined 2.5D stages along axis 0 (every template).
//
// Replaces the JAX package's kernels/stencil/codegen.py _make_body_temporal
// (PallasPlan._call_for with time_block > 1, destinations from
// PallasPlan.make_spares).  The TPU body keeps both swap frames of the
// whole block plus k·h per side resident; on this card that frame does not
// fit, so the sub-steps stream.
//
// Fields: F_{-2} and F_{-1} are the buffers named swap[0] (RT_GW, written)
// and swap[1] (RT_GO, read with taps of reach h = grid_h*(RT_GO)).
// Sub-step j computes F_j from F_{j-1}'s taps and F_{j-2}'s center (the
// written grid is tapped at the center only) plus the other grids.  F_j
// stands for buffer RT_GW when j is even and RT_GO when odd: outside the
// interior it holds that buffer's halo, which is what the per-step loop
// leaves there (the TPU body's _valid_mask re-imposition).  Only cells
// within the tap reach [-h, R + h) are read for an interior point; the
// others of a sub-step's plane are 0.
//
// A thread block covers an RT_TB1 x RT_TB2 tile (16 x 64 at k=2, 16 x 32 at
// k=3 by default) and walks a chunk [x0, x1) of RT_TB0 planes.  At tick t
// stage j computes plane t - j·h0 of F_j over the tile widened by
// (RT_K-1-j)·h: stage j lags stage j-1 by h0 planes.  Layout of the rings
// and the cells each thread owns: temporal_ring.cuh.  Stages RT_K-2 and
// RT_K-1 write their tile's F into the spare of the role they stand for
// (dst[j % 2]): K3 never writes a buffer it reads, since neighbouring
// blocks read k·h cells into this tile while it runs.
//
// Bound: device-memory bytes.  Per launch the kernel must read each input
// grid once and write both swap buffers once: star3d4r at k=2 moves 1.5
// grid passes per step where K1 moves 2.  The old design (8 x 32 tiles,
// every stage's cells spread anew over the threads, every plane loaded
// through registers between barriers, taps of F_{j-1} and F_{j-2} from
// shared memory, the steps' unchanged grids from device memory at every
// tap) ran at 8-10x its bound.  This one:
//   - redundant work: at 16 x 64, h=4, k=2 stage 0 evaluates 24 x 72 cells
//     for 1024 outputs, 1.34 evaluations a point and step (8 x 32: 1.75),
//     and ring -1 stages 32 x 80 cells, 2.5 a point (8 x 32: 4.5);
//   - latency: ring -1 keeps RT_PRE planes in flight, copied by the TMA
//     where the plan found the buffer 16-byte aligned (grid_tma(RT_GO): one
//     request a plane, completion on the slot's mbarrier; the TMA fills
//     the cells outside the buffer, which is the tap reach, with 0), else
//     by 4-byte cp.async granules of the cells in reach;
//   - reads: each thread owns fixed cells of every stage's tile, in pairs
//     adjacent along axis 1 whose shared tap reads are one read, and keeps
//     F_j (j = -1 .. RT_K-2) at each of them in a register queue of 2h0 + 1
//     planes (queue -1 takes its cell of ring -1's newest plane each
//     tick): sub-step j + 1 takes its axis-0 taps at the column from
//     queue j, sub-step j + 2 its F_j centre, and the rings are read only
//     by taps that leave the column; the rings of F_j keep only the planes
//     those read (a star: h0 + 1).  With up to 1024 threads a block, two
//     cells a thread at 16 x 64, k=2, so that the queues stay in registers;
//   - the steps' center-only grids (acoustic's vp2, damp) and F_{-2} are
//     read at the start of each tick, for every stage, before the wait
//     for the next plane, so their loads overlap it.
// The rings of sub-step values and the queues hold f32 whatever the grids'
// type: a sub-step's values reach the next one unrounded, and only the
// spares' stores round.
#include "common.cuh"
#include "tma_copy.cuh"
#include "temporal_ring.cuh"

constexpr int kQ = 2 * kH0 + 1;                 // a queue: planes of one column
constexpr int kQRings = RT_K - 1 > 0 ? RT_K - 1 : 1;

struct TParams {
  Params p;
  elem_t* dst[2];         // spares standing for RT_GW (0) and RT_GO (1)
};

// meta as rt_params, followed by the two spare pointers (each spare has
// the layout, scenarios included, of the buffer whose role it takes)
static inline TParams rt_tparams(const void* meta, const void* scal) {
  TParams t;
  t.p = rt_params(meta, scal);
  const long long* m = static_cast<const long long*>(meta);
  t.dst[0] = reinterpret_cast<elem_t*>(m[kMetaLen]);
  t.dst[1] = reinterpret_cast<elem_t*>(m[kMetaLen + 1]);
  return t;
}

// ring -1's TMA map and the read buffer's interior origin in its cells
struct TempArgs {
  CUtensorMap map;
  int ox, oy, oz;
};

__device__ __forceinline__ long long index_of(const Params& p, int g, int x, int y, int z) {
  return p.org[g] + static_cast<long long>(x) * p.sx[g] + static_cast<long long>(y) * p.sy[g] + z;
}
__device__ __forceinline__ bool in_reach(const Params& p, int x, int y, int z) {
  return x >= -kH0 && x < p.R0 + kH0 && y >= -kH1 && y < p.R1 + kH1 && z >= -kH2 &&
         z < p.R2 + kH2;
}
__device__ __forceinline__ bool in_interior(const Params& p, int x, int y, int z) {
  return x >= 0 && x < p.R0 && y >= 0 && y < p.R1 && z >= 0 && z < p.R2;
}
// grids the steps do not change, read at the point only
__host__ __device__ constexpr bool center_only(int g) {
  return g != RT_GO && g != RT_GW && !grid_ring(g) && grid_read(g);
}

// Local plane i of ring -1 (global first + i) into slot i mod kInSlots,
// unless no tick needs it (at or past x_end); planes outside the tap reach
// are not copied (no interior point reads them) and their barrier phase
// completes empty.
template <bool kBatch>
__device__ __forceinline__ void stage_input(const Params& p, const Scenarios& sn,
                                            const TempArgs& a, unsigned char* smem,
                                            unsigned long long* bar, int tid, int b, int i,
                                            int first, int x_end, int y0, int z0) {
  const int xp = first + i;
  if (xp >= x_end) return;
  const int slot = i % kInSlots;
  unsigned char* dst = smem + slot * kInBytes;
  const bool reach = xp >= -kH0 && xp < p.R0 + kH0;
  const int zs = z0 - RT_K * kH2;             // the staged rows' first cell
  if constexpr (grid_tma(RT_GO) != 0) {
    if (tid == 0) {
      fence_proxy_async();
      if (reach) {
        mbar_expect_tx(&bar[slot], kInPayload);
        if constexpr (kBatch)
          tma_load_4d(dst, &a.map, &bar[slot], a.oz + zs - kInLead, a.oy + y0 - RT_K * kH1,
                      a.ox + xp, b);
        else
          tma_load_3d(dst, &a.map, &bar[slot], a.oz + zs - kInLead, a.oy + y0 - RT_K * kH1,
                      a.ox + xp);
      } else {
        mbar_arrive(&bar[slot]);
      }
    }
  } else if (reach) {
    // element indices from scenario 0's buffer (its granules are aligned)
    const long long base =
        scenario_offset<kBatch>(sn, RT_GO, b) + p.org[RT_GO] +
        static_cast<long long>(xp) * p.sx[RT_GO] + zs;
    const int zlo = max(0, -kH2 - zs), zhi = min(kInW2, p.R2 + kH2 - zs);
    copy_granules<kInP2, kInW1, kThreads>(
        reinterpret_cast<elem_t*>(dst), p.g[RT_GO], tid,
        [&](int yr, long long& rs, long long& lo, long long& hi) {
          const int gy = y0 - RT_K * kH1 + yr;
          if (gy < -kH1 || gy >= p.R1 + kH1) return false;
          rs = base + static_cast<long long>(gy) * p.sy[RT_GO];
          lo = rs + zlo;
          hi = rs + zhi;
          return true;
        });
  }
}

// Cell (row, col) of ring -1's plane in slot `slot` (global plane xp), as
// f32; a granule-copied bf16 row starts at the even cell below its first
// cell, found from the low bits of its element index (lowin: of row 0 at
// plane 0).
__device__ __forceinline__ float in_at(const Params& p, const unsigned char* smem, int slot,
                                       int lowin, int xp, int row, int col) {
  int off = kInLead;
  if constexpr (kGranule > 1 && !grid_tma(RT_GO))
    off = (lowin + xp * static_cast<int>(p.sx[RT_GO]) + row * static_cast<int>(p.sy[RT_GO])) &
          (kGranule - 1);
  const elem_t* t = reinterpret_cast<const elem_t*>(smem + slot * kInBytes);
  return to_float(t[row * kInP2 + off + col]);
}

__device__ __forceinline__ int wrap(int s, int n) { return s >= n ? s - n : s; }

// Tap reader of stage J at cell (cy, cz) of sub-step 0's tile, point
// (x, y, z).  in0: ring -1's slot of plane x - h0; rb: ring J-1's slot of
// plane x + RT_DLO.
template <bool kBatch, int J>
struct StageReader {
  const Params& p;
  const Scenarios& sn;
  const unsigned char* smem;
  const float* q1;        // queue J-1 at this cell (F_{J-1}, planes x - h0 .. x + h0)
  const float* q2;        // queue J-2 at this cell (F_{J-2} at plane x first)
  const float* qi;        // the read buffer's queue at this cell (F_{-1}, planes
                          // tick - h0 .. tick + h0)
  const float* cen;       // center-only grids (and F_{-2} at stage 0) at the point
  int b, in0, rb, lowin, x, y, z, cy, cz;
  template <int G>
  __device__ __forceinline__ float at(int dx, int dy, int dz) const {
    if constexpr (G == RT_GO) {               // F_{J-1}
      if constexpr (J == 0) {
        if (dy == 0 && dz == 0) return qi[kH0 + dx];
        return in_at(p, smem, wrap(in0 + kH0 + dx, kInSlots), lowin, x + dx, cy + kH1 + dy,
                     cz + kH2 + dz);
      } else {
        if (dy == 0 && dz == 0) return q1[kH0 + dx];
        constexpr int W2 = stage_w2(J - 1);
        const float* r = reinterpret_cast<const float*>(
            smem + ring_off(J - 1) + wrap(rb + dx - RT_DLO, kRSlots) * ring_bytes(J - 1));
        return r[(cy - (J - 1) * kH1 + dy) * W2 + (cz - (J - 1) * kH2 + dz)];
      }
    } else if constexpr (G == RT_GW) {        // F_{J-2}, center only
      if constexpr (J == 0) {
        return cen[G];
      } else if constexpr (J == 1) {
        return qi[0];
      } else {
        return q2[0];
      }
    } else if constexpr (center_only(G)) {
      return cen[G];
    } else {                                  // a grid the steps do not change
      return ld_elem(grid_buf<kBatch>(p, sn, G, b) + index_of(p, G, x + dx, y + dy, z + dz));
    }
  }
};

// Stage J at tick `tick`: plane x = tick - J·h0 of F_J over the tile
// widened by (RT_K-1-J)·h, at this thread's cells; into ring J and queue J
// (J < RT_K-1) and, for the tile's own points, into the spare of the role
// F_J stands for (J >= RT_K-2).  The cells of a unit are evaluated
// together (their shared tap reads are one read) where either is in the
// interior; queue J takes a plane every tick (0 where the stage computes
// nothing: no stage reads it).
template <bool kBatch, int J>
__device__ __forceinline__ void stage(const TParams& t, const Scenarios& sn, const float* s,
                                      unsigned char* smem,
                                      float (&q)[kQRings][kCells][kQ],
                                      const float (&qin)[kCells][kQ],
                                      const float (&cen)[RT_K][kCells][RT_NG], int tid, int b,
                                      int tick, int first, int lowin, int x0, int x1, int y0,
                                      int z0) {
  const Params& p = t.p;
  constexpr int E = RT_K - 1 - J;
  constexpr int role = J % 2 == 0 ? RT_GW : RT_GO;
  const int x = tick - J * kH0;
  const bool active = x >= x0 - E * kH0 && x < x1 + E * kH0;   // the same for the block
  // slots (the local planes are >= 0 where the stage is active)
  const int in0 = active ? (x - kH0 - first) % kInSlots : 0;
  const int rb = active ? (x + RT_DLO - first) % kRSlots : 0;
  const int rw = active ? (x - first) % kRSlots : 0;
  float v[kCells];
#pragma unroll
  for (int c = 0; c < kCells; ++c) v[c] = 0.0f;
#pragma unroll
  for (int u = 0; u < kCells / kPair; ++u) {
    int cy, cz;
    const bool valid = owned_cell(tid, u * kPair, &cy, &cz);
    if (!(active && valid && in_stage(J, cy, cz))) continue;
    const int y = y0 - (RT_K - 1) * kH1 + cy, z = z0 - (RT_K - 1) * kH2 + cz;
    bool inner[kPair];
    bool any = false;
#pragma unroll
    for (int r = 0; r < kPair; ++r) {
      inner[r] = in_interior(p, x, y + r, z);
      any = any || inner[r];
    }
    if (any) {
#pragma unroll
      for (int r = 0; r < kPair; ++r) {
        const int c = u * kPair + r;
        const StageReader<kBatch, J> rd{p, sn, smem, q[J >= 1 ? J - 1 : 0][c],
                                        q[J >= 2 ? J - 2 : 0][c],
                                qin[c], cen[J][c], b, in0, rb, lowin, x, y + r, z, cy + r, cz};
        float out[RT_NO];
        stencil_point(rd, s, out);
        v[c] = out[0];
      }
    }
#pragma unroll
    for (int r = 0; r < kPair; ++r) {
      const int c = u * kPair + r;
      if (inner[r]) {
        if constexpr (J >= RT_K - 2) {
          if (x >= x0 && x < x1 && y + r >= y0 && y + r < y0 + RT_TB1 && z >= z0 &&
              z < z0 + RT_TB2)
            st_elem(t.dst[J % 2] + scenario_offset<kBatch>(sn, role, b) +
                        index_of(p, role, x, y + r, z), v[c]);
        }
      } else {
        v[c] = in_reach(p, x, y + r, z)
                   ? ld_elem(grid_buf<kBatch>(p, sn, role, b) + index_of(p, role, x, y + r, z))
                   : 0.0f;
      }
    }
  }
  if constexpr (J < RT_K - 1) {
    float* ring = reinterpret_cast<float*>(smem + ring_off(J) + rw * ring_bytes(J));
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      int cy, cz;
      if (owned_cell(tid, c, &cy, &cz) && active && in_stage(J, cy, cz))
        ring[(cy - J * kH1) * stage_w2(J) + (cz - J * kH2)] = v[c];
#pragma unroll
      for (int i = 0; i + 1 < kQ; ++i) q[J][c][i] = q[J][c][i + 1];
      q[J][c][kQ - 1] = v[c];
    }
  }
}

template <bool kBatch, int J>
__device__ __forceinline__ void stages(const TParams& t, const Scenarios& sn, const float* s,
                                       unsigned char* smem,
                                       float (&q)[kQRings][kCells][kQ],
                                       const float (&qin)[kCells][kQ],
                                       const float (&cen)[RT_K][kCells][RT_NG], int tid, int b,
                                       int tick, int first, int lowin, int x0, int x1, int y0,
                                       int z0) {
  if constexpr (J < RT_K) {
    stage<kBatch, J>(t, sn, s, smem, q, qin, cen, tid, b, tick, first, lowin, x0, x1, y0, z0);
    if constexpr (J < RT_K - 1) __syncthreads();   // ring J complete before stage J+1
    stages<kBatch, J + 1>(t, sn, s, smem, q, qin, cen, tid, b, tick, first, lowin, x0, x1, y0,
                          z0);
  }
}

// The center-only grids, and F_{-2} for stage 0, at each stage's plane of
// tick `tick` and each of this thread's cells where it computes a point.
template <bool kBatch, int J>
__device__ __forceinline__ void center_loads(const Params& p, const Scenarios& sn,
                                             float (&cen)[RT_K][kCells][RT_NG],
                                             int tid, int b, int tick, int x0, int x1, int y0,
                                             int z0) {
  if constexpr (J < RT_K) {
    const int x = tick - J * kH0;
    if (x >= max(0, x0 - (RT_K - 1 - J) * kH0) && x < min(p.R0, x1 + (RT_K - 1 - J) * kH0)) {
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        int cy, cz;
        if (!owned_cell(tid, c, &cy, &cz) || !in_stage(J, cy, cz)) continue;
        const int y = y0 - (RT_K - 1) * kH1 + cy, z = z0 - (RT_K - 1) * kH2 + cz;
        if (y < 0 || y >= p.R1 || z < 0 || z >= p.R2) continue;
#pragma unroll
        for (int g = 0; g < RT_NG; ++g)
          if (center_only(g) || (J == 0 && g == RT_GW))
            cen[J][c][g] = ld_elem(grid_buf<kBatch>(p, sn, g, b) + index_of(p, g, x, y, z));
      }
    }
    center_loads<kBatch, J + 1>(p, sn, cen, tid, b, tick, x0, x1, y0, z0);
  }
}

template <bool kBatch>
__global__ void __launch_bounds__(kThreads)
temporal_step_kernel(const TParams t, const Scenarios sn, const __grid_constant__ TempArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(smem_raw) + kPlaneAlign - 1) &
      ~static_cast<unsigned long long>(kPlaneAlign - 1));
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem + kRingBytes);
  const Params& p = t.p;
  const int tid = threadIdx.x;
  const int z0 = blockIdx.x * RT_TB2, y0 = blockIdx.y * RT_TB1;
  int x0;
  const int b = scenario_of<kBatch>(p, RT_TB0, &x0);
  const int x1 = min(x0 + RT_TB0, p.R0);
  const float* s = scenario_scalars<kBatch>(p, b);
  const int first = x0 - RT_K * kH0;          // ring -1's local plane 0
  const int x_end = x1 + RT_K * kH0;          // planes the last tick reads end here
  constexpr bool kTma = grid_tma(RT_GO) != 0;
  if constexpr (kTma) {
    if (tid == 0) {
      for (int s = 0; s < kInSlots; ++s) mbar_init(&bar[s]);
      mbar_init_fence();
    }
  }
  __syncthreads();
  for (int i = 0; i < 2 * kH0 + RT_PRE; ++i) {
    stage_input<kBatch>(p, sn, a, smem, bar, tid, b, i, first, x_end, y0, z0);
    if constexpr (!kTma) cp_async_commit();
  }
  if constexpr (kTma) {
    for (int s = 0; s < 2 * kH0; ++s) mbar_wait(&bar[s], 0);
  } else {
    cp_async_wait<RT_PRE>();
  }
  const int lowin = static_cast<int>(scenario_offset<kBatch>(sn, RT_GO, b) + p.org[RT_GO] +
                                     static_cast<long long>(y0 - RT_K * kH1) * p.sy[RT_GO] + z0 -
                                     RT_K * kH2);
  float q[kQRings][kCells][kQ];
#pragma unroll
  for (int j = 0; j < kQRings; ++j)
#pragma unroll
    for (int c = 0; c < kCells; ++c)
#pragma unroll
      for (int i = 0; i < kQ; ++i) q[j][c][i] = 0.0f;
  // the read buffer's queue at each cell: planes first .. first + 2h0 - 1
  // before the first tick
  float qin[kCells][kQ];
  __syncthreads();          // everyone's granule copies of those planes
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    int cy, cz;
    const bool valid = owned_cell(tid, c, &cy, &cz);
#pragma unroll
    for (int s = 1; s < kQ; ++s)
      qin[c][s] = valid ? in_at(p, smem, s - 1, lowin, first + s - 1, cy + kH1, cz + kH2) : 0.0f;
  }
  const int n_ticks = x1 - x0 + 2 * (RT_K - 1) * kH0;
  for (int lt = 0; lt < n_ticks; ++lt) {
    const int tick = x0 - (RT_K - 1) * kH0 + lt;
    float cen[RT_K][kCells][RT_NG];
    center_loads<kBatch, 0>(p, sn, cen, tid, b, tick, x0, x1, y0, z0);
    // plane tick + h0 (ring -1's local lt + 2h0) has arrived
    if constexpr (kTma) {
      mbar_wait(&bar[(lt + 2 * kH0) % kInSlots], ((lt + 2 * kH0) / kInSlots) & 1);
    } else {
      cp_async_wait<RT_PRE - 1>();
    }
    __syncthreads();        // and every stage of the last tick is done
    stage_input<kBatch>(p, sn, a, smem, bar, tid, b, lt + 2 * kH0 + RT_PRE, first, x_end, y0,
                        z0);
    if constexpr (!kTma) cp_async_commit();   // (an empty group past the end)
    // the read buffer's queues take plane tick + h0
    const int slot = (lt + 2 * kH0) % kInSlots;
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      int cy, cz;
      const bool valid = owned_cell(tid, c, &cy, &cz);
#pragma unroll
      for (int i = 0; i + 1 < kQ; ++i) qin[c][i] = qin[c][i + 1];
      qin[c][kQ - 1] = valid ? in_at(p, smem, slot, lowin, tick + kH0, cy + kH1, cz + kH2) : 0.0f;
    }
    stages<kBatch, 0>(t, sn, s, smem, q, qin, cen, tid, b, tick, first, lowin, x0, x1, y0, z0);
  }
  if constexpr (!kTma) cp_async_wait<0>();
}

// meta as rt_tparams, followed by each grid's extent along axis 0.
// Returns a cudaError_t, or 10000 + a CUresult when the TMA map cannot be
// encoded.
extern "C" int rt_temporal_step(const void* meta, const void* scal, void* stream) {
  const TParams t = rt_tparams(meta, scal);
  const Scenarios sn = rt_scenarios(meta);
  const long long* n0 = static_cast<const long long*>(meta) + kMetaLen + 2;
  TempArgs args{};
  const Params& p = t.p;
  const unsigned nz = scenario_blocks(p, sn, RT_TB0);
  if (nz == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool many = batched(sn);  // the scenario dimension of the TMA map
  origin_cells(p.org[RT_GO], p.sx[RT_GO], p.sy[RT_GO], &args.ox, &args.oy, &args.oz);
  std::unique_lock<std::mutex> lock(host_state_mutex);
  if (grid_tma(RT_GO)) {
    const CUresult r = tma_map(RT_GO, p.g[RT_GO], n0[RT_GO], p.sx[RT_GO], p.sy[RT_GO],
                               many ? sn.nb : 0, sn.bs[RT_GO], kInP2, kInW1, 1, &args.map);
    if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool ready[64];
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(temporal_step_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(temporal_step_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = true;
  }
  lock.unlock();
  const dim3 blocks((p.R2 + RT_TB2 - 1) / RT_TB2, (p.R1 + RT_TB1 - 1) / RT_TB1, nz);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = scenario_scalars_to(sn, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (many)
    temporal_step_kernel<true><<<blocks, kThreads, kSmemBytes, st>>>(t, sn, args);
  else
    temporal_step_kernel<false><<<blocks, kThreads, kSmemBytes, st>>>(t, sn, args);
  return static_cast<int>(cudaGetLastError());
}
