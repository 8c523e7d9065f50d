// K4's smem template (RT_MAP_T 2, included by map_step.cuh): one
// application of a kernel over the region, each block tile's halo'd box of
// every grid with an off-center tap staged in shared memory by
// asynchronous copies, the next tile's copy overlapping this tile's
// evaluation.
//
// Replaces the JAX package's kernels/stencil/codegen.py lower_pallas with
// _make_body_blocked(use_scratch=True): the TPU kernel pastes the
// neighbour blocks into a VMEM scratch tile, then evaluates the block from
// it.  On the H100 a tile must be large for its halo to be cheap, the copy
// must not cost the threads an instruction a cell, and it must overlap the
// arithmetic:
//   - tiles: RT_TB0 x RT_TB1 x RT_TB2, (8, 16, 64) by default: at a halo
//     of 4 the staged box is 16 x 24 x 72 = 3.4 cells a point (the old
//     (4, 8, 32) tile staged 7.5), 110.6 KB in f32, so two fit in the
//     227 KB a block may use (smem_tile.cuh);
//   - copies: where a grid's base is 16-byte aligned, its pitches are
//     multiples of 16 bytes and every box starts on a 16-byte boundary
//     along axis 2 (the TMA refuses other starts; the plan decides from the
//     pitches and the region, grid_tma, the wrapper checks the base), one
//     thread asks the TMA for the whole
//     box (cp.async.bulk.tensor.3d, completion on an mbarrier; boxes may
//     start before the tensor or end past it: those cells arrive as 0 and
//     no point of the region reads them).  Elsewhere the threads copy the
//     box's rows in 4-byte granules with cp.async (as K5's ring; a bf16 row
//     with an odd first index starts at the cell before it, and the reader
//     adds that offset back), skipping rows and cells outside the tap reach
//     [-h, R + h); a thread's granule of a row is fixed, so there is one
//     division a thread a tile, none a cell;
//   - overlap: blocks are persistent (as many as fit on the card) and walk
//     the tiles t = blockIdx.x, + gridDim.x, ...; two stages alternate, and
//     the copy of a block's next tile is issued before it evaluates this
//     one.  A stage is refilled only after the barrier that ends the
//     evaluation of the tile it held, and a thread issues
//     fence.proxy.async before the TMA writes it;
//   - reads: a thread walks the RT_TB0 points of its column, keeping each
//     grid's axis-0 taps at the column's centre in a register queue of
//     2h0 + 1 cells (one shared-memory read a plane instead of 2h0 + 1 a
//     point: for star3d4r 18 reads a point with the queue's prologue, not
//     25); cells stay in the grid's element type and are converted at the
//     read (a bf16 stage is half as large).
// Grids with center-only taps (acoustic's p0, vp2, damp) are read from
// device memory, kAhead planes ahead of the point that uses them: with one
// block an SM (two stages fill its shared memory) a load issued at the
// point left the warps waiting on device memory.
//
// Bound: device-memory bytes, as K1: each input grid read once and each
// output written once; halo cells a neighbouring tile also stages are
// re-read, mostly from L2 (the tiles that run together are neighbours).
#include "smem_tile.cuh"
#include "tma_copy.cuh"

// each ring grid's queue of axis-0 taps at the column's centre
__host__ __device__ constexpr int queue_len(int g) { return grid_ring(g) ? 2 * grid_h0(g) + 1 : 0; }
__host__ __device__ constexpr int queue_offset(int g) {
  return g <= 0 ? 0 : queue_offset(g - 1) + queue_len(g - 1);
}
constexpr int kQueue = queue_offset(RT_NG) > 0 ? queue_offset(RT_NG) : 1;

// The launch's TMA maps (grids on the TMA path) and each grid's region
// origin in its tensor's coordinates, kernel parameters.
struct SmemArgs {
  CUtensorMap map[RT_NG];
  int ox[RT_NG], oy[RT_NG], oz[RT_NG];
};

// Issue the copies of tile (x0, y0, z0) of every ring grid into stage st:
// TMA grids by thread 0, the others by every thread (one cp.async group).
template <int G>
__device__ __forceinline__ void stage_grids(const Params& p, const SmemArgs& args,
                                            unsigned char* st, unsigned long long* bar, int tid,
                                            int x0, int y0, int z0) {
  if constexpr (G < RT_NG) {
    if constexpr (grid_ring(G) && grid_tma(G)) {
      if (tid == 0)
        tma_load_3d(st + tile_offset(G), &args.map[G], bar, args.oz[G] + z0 - grid_h2(G),
                    args.oy[G] + y0 - grid_h1(G), args.ox[G] + x0 - grid_h0(G));
    } else if constexpr (grid_ring(G)) {
      constexpr int h0 = grid_h0(G), h1 = grid_h1(G), h2 = grid_h2(G), T1 = tile_t1(G);
      elem_t* dst = reinterpret_cast<elem_t*>(st + tile_offset(G));
      // cells a row needs: to the end of the tap reach along axis 2
      const int n = min(tile_w2(G), p.R2 + 2 * h2 - z0);
      const long long base = p.org[G] + static_cast<long long>(x0 - h0) * p.sx[G] +
                             static_cast<long long>(y0 - h1) * p.sy[G] + z0 - h2;
      const int xend = p.R0 + 2 * h0 - x0, yend = p.R1 + 2 * h1 - y0;   // rows in reach
      for_granules<G>(tid, [&](int row, int k) {
        const int xr = row / T1, yr = row - xr * T1;
        if (xr >= xend || yr >= yend) return;
        const long long rs = base + xr * p.sx[G] + yr * p.sy[G];
        const long long a = rs & ~static_cast<long long>(kGranule - 1);
        if (a + k * kGranule < rs + n)
          cp_async4(dst + row * tile_p2(G) + k * kGranule, p.g[G] + a + k * kGranule);
      });
    }
    stage_grids<G + 1>(p, args, st, bar, tid, x0, y0, z0);
  }
}

__device__ __forceinline__ void stage_tile(const Params& p, const SmemArgs& args,
                                           unsigned char* st, unsigned long long* bar, int tid,
                                           int t) {
  const TileOrigin o = tile_origin(t, p.R1, p.R2);
  if constexpr (kAnyTma) {
    if (tid == 0) {
      // the stage was last read through the generic proxy
      fence_proxy_async();
      mbar_expect_tx(bar, kTmaBytes);
    }
  }
  stage_grids<0>(p, args, st, bar, tid, o.x0, o.y0, o.z0);
}

// Cell (xr, yr, zr) of grid G's staged box (zr from the box's first
// cell), as f32.  A granule-copied bf16 row starts at the even cell below
// its first cell: its shift comes from the low bits of the element index
// where the box's first row starts, low (32-bit arithmetic keeps them).
template <int G>
__device__ __forceinline__ float tile_at(const Params& p, const unsigned char* st, int low,
                                         int xr, int yr, int zr) {
  int off = 0;
  if constexpr (kGranule > 1 && !grid_tma(G))
    off = (low + xr * static_cast<int>(p.sx[G]) + yr * static_cast<int>(p.sy[G])) &
          (kGranule - 1);
  const elem_t* t = reinterpret_cast<const elem_t*>(st + tile_offset(G));
  return to_float(t[(xr * tile_t1(G) + yr) * tile_p2(G) + off + zr]);
}

struct TileReader {
  const Params& p;
  const unsigned char* st;      // the stage
  const float* q;               // this column's queues
  const int* low;               // low bits of each grid's first row start
  const float* cen;             // each center-only grid at the point
  int xl, ty, tz;               // the point's plane (0..RT_TB0), row and lane in the tile
  template <int G>
  __device__ __forceinline__ float at(int dx, int dy, int dz) const {
    if constexpr (grid_ring(G) != 0) {
      constexpr int h0 = grid_h0(G), h1 = grid_h1(G), h2 = grid_h2(G);
      if (dy == 0 && dz == 0) return q[queue_offset(G) + h0 + dx];
      return tile_at<G>(p, st, low[G], xl + h0 + dx, ty + h1 + dy, tz + h2 + dz);
    } else {
      return cen[G];  // center-only grid
    }
  }
};

// grids read at the point only (an output no tap reads is not one)
__host__ __device__ constexpr bool center_only(int g) { return !grid_ring(g) && grid_read(g); }

// every center-only grid at (x, y, z)
__device__ __forceinline__ void center_load(const Params& p, int x, int y, int z, float* v) {
#pragma unroll
  for (int g = 0; g < RT_NG; ++g)
    if (center_only(g))
      v[g] = ld_elem(p.g[g] + p.org[g] + x * p.sx[g] + y * p.sy[g] + z);
}

// every ring grid's queue: the column's centre at box planes 0 .. 2h0 - 1
// (before the column's first point, `lead` false) or plane xl + 2h0 into
// the leading slot (at its point xl)
template <int G>
__device__ __forceinline__ void queue_fill(const Params& p, const unsigned char* st, float* q,
                                           const int* low, bool lead, int xl, int ty, int tz) {
  if constexpr (G < RT_NG) {
    if constexpr (grid_ring(G) != 0) {
      constexpr int L = queue_len(G), yr = grid_h1(G), zr = grid_h2(G);
      if (lead) {
        q[queue_offset(G) + L - 1] = tile_at<G>(p, st, low[G], xl + L - 1, ty + yr, tz + zr);
      } else {
#pragma unroll
        for (int s = 0; s + 1 < L; ++s)
          q[queue_offset(G) + s] = tile_at<G>(p, st, low[G], s, ty + yr, tz + zr);
      }
    }
    queue_fill<G + 1>(p, st, q, low, lead, xl, ty, tz);
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

// center-only grids are read this many planes ahead of the point that
// uses them
constexpr int kAhead = 2;

// Evaluate tile t from stage st: each thread walks its column.
__device__ __forceinline__ void eval_tile(const Params& p, const unsigned char* st, int t) {
  const TileOrigin o = tile_origin(t, p.R1, p.R2);
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int z = o.z0 + tz, y = o.y0 + ty, nx = min(RT_TB0, p.R0 - o.x0);
  // points outside the region read cells of its edge and store nothing
  const int yc = min(y, p.R1 - 1), zc = min(z, p.R2 - 1);
  int low[RT_NG];
#pragma unroll
  for (int g = 0; g < RT_NG; ++g)
    low[g] = static_cast<int>(p.org[g] + static_cast<long long>(o.x0 - grid_h0(g)) * p.sx[g] +
                              static_cast<long long>(o.y0 - grid_h1(g)) * p.sy[g] + o.z0 -
                              grid_h2(g));
  float q[kQueue];
  queue_fill<0>(p, st, q, low, false, 0, ty, tz);
  float cen[kAhead + 1][RT_NG];   // center-only grids at planes x .. x + kAhead
#pragma unroll
  for (int a = 0; a < kAhead; ++a)
    if (a < nx) center_load(p, o.x0 + a, yc, zc, cen[a]);
  for (int xl = 0; xl < nx; ++xl) {
    const int x = o.x0 + xl;
    if (xl + kAhead < nx) center_load(p, x + kAhead, yc, zc, cen[kAhead]);
    queue_fill<0>(p, st, q, low, true, xl, ty, tz);
    const TileReader rd{p, st, q, low, cen[0], xl, ty, tz};
    float out[RT_NO];
    stencil_point(rd, p.s, out);
    if (z < p.R2 && y < p.R1) {
#pragma unroll
      for (int k = 0; k < RT_NO; ++k) store_out(p, k, x, y, z, out[k]);
    }
    queue_shift<0>(q);
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
#pragma unroll
      for (int g = 0; g < RT_NG; ++g)
        if (center_only(g)) cen[a][g] = cen[a + 1][g];
  }
}

__global__ void __launch_bounds__(kThreads)
map_step_kernel(const Params p, const __grid_constant__ SmemArgs args) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(smem_raw) + kTileAlign - 1) &
      ~static_cast<unsigned long long>(kTileAlign - 1));
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem + 2 * kStageBytes);
  const int tid = threadIdx.y * RT_TB2 + threadIdx.x;
  const int n_tiles = (p.R0 + RT_TB0 - 1) / RT_TB0 * ((p.R1 + RT_TB1 - 1) / RT_TB1) *
                      ((p.R2 + RT_TB2 - 1) / RT_TB2);
  if constexpr (kAnyTma) {
    if (tid == 0) {
      mbar_init(&bar[0]);
      mbar_init(&bar[1]);
      mbar_init_fence();
    }
  }
  __syncthreads();
  int t = blockIdx.x;
  if (t < n_tiles) stage_tile(p, args, smem, &bar[0], tid, t);
  if constexpr (kAnyGranule) cp_async_commit();
  for (int i = 0; t < n_tiles; ++i, t += gridDim.x) {
    const int b = i & 1;
    // the next tile's copy into the other stage, read last by tile i - 1
    if (t + static_cast<int>(gridDim.x) < n_tiles)
      stage_tile(p, args, smem + (b ^ 1) * kStageBytes, &bar[b ^ 1], tid, t + gridDim.x);
    if constexpr (kAnyGranule) {
      cp_async_commit();          // (an empty group past the last tile)
      cp_async_wait<1>();         // this thread's copies of tile i
    }
    if constexpr (kAnyTma) mbar_wait(&bar[b], (i >> 1) & 1);
    __syncthreads();              // everyone's copies of tile i
    eval_tile(p, smem + b * kStageBytes, t);
    __syncthreads();              // stage b read: free for tile i + 2
  }
  if constexpr (kAnyGranule) cp_async_wait<0>();
}

// meta as in common.cuh (RT_MAP), followed by each grid's extent along
// axis 0.  Returns a cudaError_t, or 10000 + a CUresult when a TMA map
// cannot be encoded.
extern "C" int rt_map_step(const void* meta, const void* scal, void* stream) {
  const Params p = rt_params(meta, scal);
  const long long* n0 = static_cast<const long long*>(meta) + kMetaLen;
  SmemArgs args{};            // kernel parameters (copied at the launch)
  std::unique_lock<std::mutex> lock(host_state_mutex);
  for (int g = 0; g < RT_NG; ++g) {
    args.ox[g] = static_cast<int>(p.org[g] / p.sx[g]);
    args.oy[g] = static_cast<int>(p.org[g] % p.sx[g] / p.sy[g]);
    args.oz[g] = static_cast<int>(p.org[g] % p.sy[g]);
    if (grid_ring(g) && grid_tma(g)) {
      const CUresult r = tma_map(g, p.g[g], n0[g], p.sx[g], p.sy[g], 0, 0, tile_p2(g),
                                 tile_t1(g), tile_t0(g), &args.map[g]);
      if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
    }
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // per device: SMs, and blocks of this kernel an SM holds
  static int sms[64], per_sm[64];
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    e = cudaFuncSetAttribute(map_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], map_step_kernel, kThreads,
                                                        kSmemBytes);
    if (e != cudaSuccess) {
      sms[dev] = 0;
      return static_cast<int>(e);
    }
    if (per_sm[dev] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const long long n_tiles = static_cast<long long>((p.R0 + RT_TB0 - 1) / RT_TB0) *
                            ((p.R1 + RT_TB1 - 1) / RT_TB1) * ((p.R2 + RT_TB2 - 1) / RT_TB2);
  const long long fit = static_cast<long long>(sms[dev]) * per_sm[dev];
  lock.unlock();
  const dim3 threads(RT_TB2, RT_TB1, 1);
  const dim3 blocks(static_cast<unsigned>(n_tiles < fit ? n_tiles : fit), 1, 1);
  map_step_kernel<<<blocks, threads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p, args);
  return static_cast<int>(cudaGetLastError());
}
