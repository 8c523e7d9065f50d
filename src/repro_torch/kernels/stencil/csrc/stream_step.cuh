// K2 — 2.5D streaming along axis 0 (templates shift and unroll).
//
// Replaces the JAX package's kernels/stencil/codegen.py _make_body_fused,
// streaming branch -> _stream_outputs shift/unroll (rolling window of 2h+1
// planes along axis 0).  A thread block covers an RT_TB1 x RT_TB2 tile of
// the two fast axes (8 x 64 by default, three blocks an SM) and walks a
// chunk of RT_TB0 planes along axis 0; each thread walks kRows columns
// adjacent along axis 1.  Layout of the rings: stream_ring.cuh.
//
// Bound: device-memory bytes, as K1.  The old design (8 x 32 tiles, each
// plane loaded through registers between two barriers, 25 shared reads a
// point with a run-time ring slot per tap) ran at 3.1-3.8x its bound.
// This one answers each of those:
//   - staging: at 8 x 64 a halo of 4 stages 16 x 72 cells a plane, 2.25 a
//     point (8 x 32 staged 2.5; 16 x 64 stages 1.69 but holds one block an
//     SM, whose center-only loads then wait); a chunk re-reads 2H planes.
//   - latency: each ring grid keeps kSlots = 2H + 1 + RT_PRE planes.  While
//     the block evaluates plane x, the copies of planes x + H + 1 ..
//     x + H + RT_PRE are in flight: one thread asks the TMA for a plane's
//     box (completion on the slot's mbarrier) where the plan found the
//     grid's base, pitches and tile width 16-byte aligned (grid_tma; the
//     box starts grid_lead cells before the plane's first cell, on a
//     16-byte boundary), else every thread copies 4-byte granules with
//     cp.async (one group a plane).  One barrier a plane orders the copies
//     and the reuse of the slot the next copy fills (fence.proxy.async
//     before the TMA writes a slot the threads have read).
//   - reads: each thread keeps each ring grid's axis-0 taps at its
//     columns' centre in a register queue of 2h0 + 1 cells (one shared
//     read a plane); the ring is read only for taps that leave the column
//     (star3d4r: 16 + 1 shared reads a point, not 25).  The plane loop is
//     unrolled by kSlots, so every ring slot is a compile-time constant.
//   - center-only grids (acoustic's p0, vp2, damp) are read from device
//     memory kAhead planes ahead of the point that uses them.
// Cells stay in the grids' element type in the rings and are converted at
// the read; arithmetic is f32 and store_out rounds once.  Outputs are
// written in place (center-only taps, as K1).
//
// With RT_MAP this is K4's streaming kernel (templates shift/unroll of the
// per-application path: _make_body_streaming -> _stream_outputs, reached
// from lower_pallas): the grids are the full halo'd tensors with org at
// the region's first point, planes and tile halos outside the region are
// the real neighbouring cells, and outputs go to the plan's destinations
// (store_out).  The JAX body's common x-halo H = max h0 with zero planes
// beyond a grid's own h0 gives the same values as these per-grid rings.
#include "common.cuh"
#include "tma_copy.cuh"
#include "stream_ring.cuh"

// The launch's TMA maps (grids on the TMA path) and each grid's region
// origin in its tensor's coordinates, kernel parameters.
struct StreamArgs {
  CUtensorMap map[RT_NG];
  int ox[RT_NG], oy[RT_NG], oz[RT_NG];
};

// grids read at the point only (an output no tap reads is not one)
__host__ __device__ constexpr bool center_only(int g) { return !grid_ring(g) && grid_read(g); }

// every ring grid's queue of axis-0 taps at a column's centre
__host__ __device__ constexpr int queue_len(int g) { return grid_ring(g) ? 2 * grid_h0(g) + 1 : 0; }
__host__ __device__ constexpr int queue_offset(int g) {
  return g <= 0 ? 0 : queue_offset(g - 1) + queue_len(g - 1);
}
constexpr int kQueue = queue_offset(RT_NG) > 0 ? queue_offset(RT_NG) : 1;
// center-only grids are read this many planes ahead of the point
constexpr int kAhead = 2;
// blocks an SM should hold (registers a thread at most 65536 / (this x
// kThreads)): three of the default 8 x 64 tile's 256 threads
constexpr int kMinBlocks = kThreads < 768 ? 768 / kThreads : 1;


// Start the copies of global plane xp of every ring grid into slot `slot`
// (planes outside a grid's tap reach [-h0, R0 + h0) are not copied: no
// interior point reads them).  TMA grids by thread 0, which first arrives
// on the slot's barrier with the bytes to expect.
template <bool kBatch, int G>
__device__ __forceinline__ void stage_grids(const Params& p, const Scenarios& sn,
                                            const StreamArgs& a, unsigned char* ring,
                                            unsigned long long* bar, int tid, int b, int xp,
                                            int slot, int y0, int z0) {
  if constexpr (G < RT_NG) {
    if constexpr (grid_ring(G) != 0) {
      constexpr int h0 = grid_h0(G), h1 = grid_h1(G), h2 = grid_h2(G);
      unsigned char* dst = ring + ring_offset(G) + slot * plane_bytes(G);
      if (xp >= -h0 && xp < p.R0 + h0) {
        if constexpr (grid_tma(G)) {
          if (tid == 0) {
            if constexpr (kBatch)
              tma_load_4d(dst, &a.map[G], bar, a.oz[G] + z0 - h2 - grid_lead(G),
                          a.oy[G] + y0 - h1, a.ox[G] + xp, b);
            else
              tma_load_3d(dst, &a.map[G], bar, a.oz[G] + z0 - h2 - grid_lead(G),
                          a.oy[G] + y0 - h1, a.ox[G] + xp);
          }
        } else {
          // rows and cells of the tap reach [-h, R + h) only, as element
          // indices from scenario 0's buffer (its granules are aligned)
          const long long base = scenario_offset<kBatch>(sn, G, b) + p.org[G] +
                                 static_cast<long long>(xp) * p.sx[G] + z0 - h2;
          const long long yend = p.R1 + h1, zend = p.R2 + h2;
          copy_granules<ring_p2(G), ring_w1(G), kThreads>(
              reinterpret_cast<elem_t*>(dst), p.g[G], tid,
              [&](int yr, long long& rs, long long& lo, long long& hi) {
                const int gy = y0 - h1 + yr;
                if (gy >= yend) return false;
                rs = lo = base + static_cast<long long>(gy) * p.sy[G];
                hi = rs + min(static_cast<long long>(ring_w2(G)), zend - (z0 - h2));
                return true;
              });
        }
      }
    }
    stage_grids<kBatch, G + 1>(p, sn, a, ring, bar, tid, b, xp, slot, y0, z0);
  }
}

// bytes the TMA delivers for global plane xp
__device__ __forceinline__ unsigned tma_bytes(const Params& p, int xp) {
  unsigned n = 0;
#pragma unroll
  for (int g = 0; g < RT_NG; ++g)
    if (grid_ring(g) && grid_tma(g) && xp >= -grid_h0(g) && xp < p.R0 + grid_h0(g))
      n += plane_payload(g);
  return n;
}

// Local plane i of the chunk (global x0 - kH + i) into slot i mod kSlots,
// unless no plane of the chunk needs it (i >= nx + 2kH).
template <bool kBatch>
__device__ __forceinline__ void stage_plane(const Params& p, const Scenarios& sn,
                                            const StreamArgs& a,
                                            unsigned char* ring, unsigned long long* bar,
                                            int tid, int b, int i, int slot, int nx, int x0,
                                            int y0, int z0) {
  if (i >= nx + 2 * kH) return;
  const int xp = x0 - kH + i;
  if constexpr (kAnyTma) {
    if (tid == 0) {
      fence_proxy_async();
      const unsigned n = tma_bytes(p, xp);
      if (n > 0) mbar_expect_tx(&bar[slot], n);
      else mbar_arrive(&bar[slot]);
    }
  }
  stage_grids<kBatch, 0>(p, sn, a, ring, &bar[slot], tid, b, xp, slot, y0, z0);
}

// Cell (yr, zr) (from the staged plane's first cell) of grid G's plane in
// slot `slot`, the plane being global xp, as f32.  A granule-copied bf16
// row starts at the even cell below its first cell: its shift comes from
// the low bits of its first cell's element index, low (32-bit arithmetic
// keeps them).
template <int G>
__device__ __forceinline__ float ring_at(const Params& p, const unsigned char* ring, int slot,
                                         int low, int xp, int yr, int zr) {
  int off = grid_lead(G);
  if constexpr (kGranule > 1 && !grid_tma(G))
    off = (low + xp * static_cast<int>(p.sx[G]) + yr * static_cast<int>(p.sy[G])) &
          (kGranule - 1);
  const elem_t* t =
      reinterpret_cast<const elem_t*>(ring + ring_offset(G) + slot * plane_bytes(G));
  return to_float(t[yr * ring_p2(G) + off + zr]);
}

struct RingReader {
  const Params& p;
  const unsigned char* ring;
  const float* q;               // this column's queues
  const int* low;               // low bits of each grid's staged row 0 at plane 0
  const float* cen;             // each center-only grid at the point
  int r, x, ty, tz;             // the plane's place in the unrolled loop, the plane, row, lane
  template <int G>
  __device__ __forceinline__ float at(int dx, int dy, int dz) const {
    if constexpr (grid_ring(G) != 0) {
      constexpr int h0 = grid_h0(G), h1 = grid_h1(G), h2 = grid_h2(G);
      if (dy == 0 && dz == 0) return q[queue_offset(G) + h0 + dx];
      return ring_at<G>(p, ring, tap_slot(r, dx), low[G], x + dx, ty + h1 + dy, tz + h2 + dz);
    } else {
      return cen[G];  // center-only grid
    }
  }
};

// every center-only grid at (x, y, z) of scenario b
template <bool kBatch>
__device__ __forceinline__ void center_load(const Params& p, const Scenarios& sn, int b, int x,
                                            int y, int z, float* v) {
#pragma unroll
  for (int g = 0; g < RT_NG; ++g)
    if (center_only(g))
      v[g] = ld_elem(grid_buf<kBatch>(p, sn, g, b) + p.org[g] + static_cast<long long>(x) * p.sx[g] +
                     static_cast<long long>(y) * p.sy[g] + z);
}

// the leading cell of every ring grid's queue: plane x + h0 at the column,
// in slot tap_slot(r, h0)
template <int G>
__device__ __forceinline__ void queue_lead(const Params& p, const unsigned char* ring, float* q,
                                           const int* low, int r, int x, int ty, int tz) {
  if constexpr (G < RT_NG) {
    if constexpr (grid_ring(G) != 0) {
      constexpr int h0 = grid_h0(G);
      q[queue_offset(G) + 2 * h0] =
          ring_at<G>(p, ring, tap_slot(r, h0), low[G], x + h0, ty + grid_h1(G), tz + grid_h2(G));
    }
    queue_lead<G + 1>(p, ring, q, low, r, x, ty, tz);
  }
}

template <int G>
__device__ __forceinline__ void queue_shift(float* q) {
  if constexpr (G < RT_NG) {
#pragma unroll
    for (int i = 0; i + 1 < queue_len(G); ++i) q[queue_offset(G) + i] = q[queue_offset(G) + i + 1];
    queue_shift<G + 1>(q);
  }
}

// every ring grid's queue before the chunk's first plane: planes x0 - h0
// .. x0 + h0 - 1 (local kH - h0 .. kH + h0 - 1) at the column
template <int G>
__device__ __forceinline__ void queue_fill(const Params& p, const unsigned char* ring, float* q,
                                           const int* low, int x0, int ty, int tz) {
  if constexpr (G < RT_NG) {
    if constexpr (grid_ring(G) != 0) {
      constexpr int h0 = grid_h0(G);
#pragma unroll
      for (int s = 0; s < 2 * h0; ++s)
        q[queue_offset(G) + s] = ring_at<G>(p, ring, (kH - h0 + s) % kSlots, low[G],
                                            x0 - h0 + s, ty + grid_h1(G), tz + grid_h2(G));
    }
    queue_fill<G + 1>(p, ring, q, low, x0, ty, tz);
  }
}

template <bool kBatch>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stream_step_kernel(const Params p, const Scenarios sn, const __grid_constant__ StreamArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(smem_raw) + kPlaneAlign - 1) &
      ~static_cast<unsigned long long>(kPlaneAlign - 1));
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(ring + kRingBytes);
  const int z0 = blockIdx.x * RT_TB2, y0 = blockIdx.y * RT_TB1;
  int x0;
  const int b = scenario_of<kBatch>(p, RT_TB0, &x0);
  const int tz = threadIdx.x, ty0 = threadIdx.y * kRows;
  const int tid = threadIdx.y * RT_TB2 + threadIdx.x;
  const int nx = min(x0 + RT_TB0, p.R0) - x0;
  const float* s = scenario_scalars<kBatch>(p, b);
  const int z = z0 + tz, zc = min(z, p.R2 - 1);
  if constexpr (kAnyTma) {
    if (tid == 0) {
      for (int s = 0; s < kSlots; ++s) mbar_init(&bar[s]);
      mbar_init_fence();
    }
  }
  __syncthreads();
  // the chunk's first 2kH + RT_PRE planes
  for (int i = 0; i < 2 * kH + RT_PRE; ++i) {
    stage_plane<kBatch>(p, sn, a, ring, bar, tid, b, i, i, nx, x0, y0, z0);
    if constexpr (kAnyGranule) cp_async_commit();
  }
  if constexpr (kAnyGranule) cp_async_wait<RT_PRE>();
  if constexpr (kAnyTma) {
    for (int s = 0; s < 2 * kH; ++s) mbar_wait(&bar[s], 0);
  }
  __syncthreads();
  // low bits of the element index of each grid's staged row 0 at plane 0
  int low[RT_NG];
#pragma unroll
  for (int g = 0; g < RT_NG; ++g)
    low[g] = static_cast<int>(scenario_offset<kBatch>(sn, g, b) + p.org[g] +
                              static_cast<long long>(y0 - grid_h1(g)) * p.sy[g] + z0 - grid_h2(g));
  float q[kRows][kQueue];
  float cen[kRows][kAhead + 1][RT_NG];   // center-only grids at planes x .. x + kAhead
#pragma unroll
  for (int c = 0; c < kRows; ++c) {
    queue_fill<0>(p, ring, q[c], low, x0, ty0 + c, tz);
    const int yc = min(y0 + ty0 + c, p.R1 - 1);
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (k < nx) center_load<kBatch>(p, sn, b, x0 + k, yc, zc, cen[c][k]);
  }
  for (int base = 0; base < nx; base += kSlots) {
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
      const int t = base + r;
      if (t >= nx) break;                     // the same for the whole block
      const int x = x0 + t;
      // plane x + kH (local t + 2kH) has arrived
      if constexpr (kAnyGranule) cp_async_wait<RT_PRE - 1>();
      if constexpr (kAnyTma)
        mbar_wait(&bar[(r + 2 * kH) % kSlots], ((t + 2 * kH) / kSlots) & 1);
      __syncthreads();                        // and everyone is done with plane x - 1
      // local t + 2kH + RT_PRE into the slot plane x - kH - 1 left
      stage_plane<kBatch>(p, sn, a, ring, bar, tid, b, t + 2 * kH + RT_PRE,
                          (r + 2 * kH + RT_PRE) % kSlots, nx, x0, y0, z0);
      if constexpr (kAnyGranule) cp_async_commit();   // (an empty group past the end)
#pragma unroll
      for (int c = 0; c < kRows; ++c) {
        const int ty = ty0 + c, y = y0 + ty;
        if (t + kAhead < nx)
          center_load<kBatch>(p, sn, b, x + kAhead, min(y, p.R1 - 1), zc, cen[c][kAhead]);
        queue_lead<0>(p, ring, q[c], low, r, x, ty, tz);
        const RingReader rd{p, ring, q[c], low, cen[c][0], r, x, ty, tz};
        float out[RT_NO];
        stencil_point(rd, s, out);
        if (z < p.R2 && y < p.R1) {
#pragma unroll
          for (int o = 0; o < RT_NO; ++o) store_out<kBatch>(p, sn, o, x, y, z, out[o], b);
        }
        queue_shift<0>(q[c]);
#pragma unroll
        for (int k = 0; k < kAhead; ++k)
#pragma unroll
          for (int g = 0; g < RT_NG; ++g)
            if (center_only(g)) cen[c][k][g] = cen[c][k + 1][g];
      }
    }
  }
  if constexpr (kAnyGranule) cp_async_wait<0>();
}

// meta as in common.cuh, followed by each grid's extent along axis 0.
// Returns a cudaError_t, or 10000 + a CUresult when a TMA map cannot be
// encoded.
extern "C" int rt_stream_step(const void* meta, const void* scal, void* stream) {
  const Params p = rt_params(meta, scal);
  const Scenarios sn = rt_scenarios(meta);
  const long long* n0 = static_cast<const long long*>(meta) + kMetaLen;
  const unsigned nz = scenario_blocks(p, sn, RT_TB0);
  if (nz == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  StreamArgs args{};            // kernel parameters (copied at the launch)
  const bool many = batched(sn);  // the scenario dimension of the TMA maps
  std::unique_lock<std::mutex> lock(host_state_mutex);
  for (int g = 0; g < RT_NG; ++g) {
    origin_cells(p.org[g], p.sx[g], p.sy[g], &args.ox[g], &args.oy[g], &args.oz[g]);
    if (grid_ring(g) && grid_tma(g)) {
      const CUresult r = tma_map(g, p.g[g], n0[g], p.sx[g], p.sy[g], many ? sn.nb : 0, sn.bs[g],
                                 ring_p2(g), ring_w1(g), 1, &args.map[g]);
      if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
    }
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool ready[64];
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(stream_step_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(stream_step_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = true;
  }
  lock.unlock();
  const dim3 threads(RT_TB2, RT_TB1 / kRows, 1);
  const dim3 blocks((p.R2 + RT_TB2 - 1) / RT_TB2, (p.R1 + RT_TB1 - 1) / RT_TB1, nz);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = scenario_scalars_to(sn, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (many)
    stream_step_kernel<true><<<blocks, threads, kSmemBytes, st>>>(p, sn, args);
  else
    stream_step_kernel<false><<<blocks, threads, kSmemBytes, st>>>(p, sn, args);
  return static_cast<int>(cudaGetLastError());
}
