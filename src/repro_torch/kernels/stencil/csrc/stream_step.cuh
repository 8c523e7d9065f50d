// K2 — 2.5D streaming along axis 0 (templates shift and unroll).
//
// Replaces the JAX package's kernels/stencil/codegen.py _make_body_fused,
// streaming branch -> _stream_outputs shift/unroll (rolling window of 2h+1
// planes along axis 0).  A thread block covers an RT_TB1 x RT_TB2 tile of
// the two fast axes and walks a chunk of RT_TB0 planes along axis 0.  Each
// grid with an off-center tap keeps a ring of 2*h0+1 halo'd planes
// ((RT_TB1 + 2*h1) x (RT_TB2 + 2*h2)) in shared memory: every plane is
// loaded from device memory once per block and then read by all the taps
// of the 2*h0+1 output planes that need it.  Grids tapped only at the
// center are read at the point.
//
// Ring slots: local plane p (the chunk's first plane is 0, the prologue
// loads p = -h0 .. h0-1) lives in slot (p + h0) mod (2*h0+1); at plane t
// the kernel loads p = t + h0 into slot (t + 2*h0) mod n, and a tap at
// offset dx reads slot (t + h0 + dx) mod n — the JAX body's
// `slot = gh0 + offs[0]` on a ring instead of a shift register.
//
// Bound: device-memory bytes, as K1.  The halo'd tiles re-read the edge
// columns of neighbouring tiles (from L2) and each chunk re-reads 2*h0
// planes; those re-reads are what the tile and chunk sizes trade against
// occupancy.  Outputs are written in place (center-only taps, as K1).
#include "common.cuh"

__host__ __device__ constexpr int ring_elems(int g) {
  return grid_ring(g) ? (2 * grid_h0(g) + 1) * (RT_TB1 + 2 * grid_h1(g)) *
                            (RT_TB2 + 2 * grid_h2(g))
                      : 0;
}
__host__ __device__ constexpr int ring_offset(int g) {
  return g <= 0 ? 0 : ring_offset(g - 1) + ring_elems(g - 1);
}
constexpr int kSmemFloats = ring_offset(RT_NG);
constexpr int kThreads = RT_TB1 * RT_TB2;

// Load local plane p (global plane xp) of grid G into its ring slot; cells
// outside the grid's tap reach [-h, R + h) are never read for an interior
// output and are skipped.
template <int G>
__device__ __forceinline__ void load_plane(const Params& p, float* smem, int xp,
                                           int slot, int y0, int z0) {
  constexpr int h0 = grid_h0(G), h1 = grid_h1(G), h2 = grid_h2(G);
  constexpr int W1 = RT_TB1 + 2 * h1, W2 = RT_TB2 + 2 * h2;
  if (xp < -h0 || xp >= p.R0 + h0) return;
  float* dst = smem + ring_offset(G) + slot * (W1 * W2);
  const float* src = p.g[G] + p.org[G] + xp * p.sx[G];
  for (int i = threadIdx.y * RT_TB2 + threadIdx.x; i < W1 * W2; i += kThreads) {
    const int gy = y0 - h1 + i / W2;
    const int gz = z0 - h2 + i % W2;
    if (gy < p.R1 + h1 && gz < p.R2 + h2) dst[i] = __ldg(src + gy * p.sy[G] + gz);
  }
}

// At local plane t (global x) every ring grid loads plane x + h0.
template <int G>
__device__ __forceinline__ void load_all(const Params& p, float* smem, int x,
                                         int t, int y0, int z0) {
  if constexpr (G < RT_NG) {
    if constexpr (grid_ring(G) != 0) {
      constexpr int h0 = grid_h0(G), n = 2 * h0 + 1;
      load_plane<G>(p, smem, x + h0, (t + 2 * h0) % n, y0, z0);
    }
    load_all<G + 1>(p, smem, x, t, y0, z0);
  }
}

template <int G>
__device__ __forceinline__ void prologue(const Params& p, float* smem, int x0,
                                         int y0, int z0) {
  if constexpr (G < RT_NG) {
    if constexpr (grid_ring(G) != 0) {
      constexpr int h0 = grid_h0(G), n = 2 * h0 + 1;
      for (int q = -h0; q < h0; ++q) load_plane<G>(p, smem, x0 + q, (q + h0) % n, y0, z0);
    }
    prologue<G + 1>(p, smem, x0, y0, z0);
  }
}

struct RingReader {
  const Params& p;
  const float* smem;
  int t, ty, tz;          // local plane, thread position in the tile
  long long idx[RT_NG];   // element index of this point in each buffer
  template <int G>
  __device__ __forceinline__ float at(int dx, int dy, int dz) const {
    if constexpr (grid_ring(G) != 0) {
      constexpr int h0 = grid_h0(G), h1 = grid_h1(G), h2 = grid_h2(G);
      constexpr int n = 2 * h0 + 1, W1 = RT_TB1 + 2 * h1, W2 = RT_TB2 + 2 * h2;
      int slot = t % n + h0 + dx;       // in [0, 2n)
      slot -= slot >= n ? n : 0;
      return smem[ring_offset(G) + slot * (W1 * W2) + (ty + h1 + dy) * W2 +
                  (tz + h2 + dz)];
    } else {
      return __ldg(p.g[G] + idx[G]);    // center-only grid
    }
  }
};

__global__ void __launch_bounds__(RT_TB1 * RT_TB2)
stream_step_kernel(const Params p) {
  extern __shared__ float smem[];
  const int z0 = blockIdx.x * RT_TB2, y0 = blockIdx.y * RT_TB1;
  const int x0 = blockIdx.z * RT_TB0;
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int z = z0 + tz, y = y0 + ty;
  const bool inside = z < p.R2 && y < p.R1;
  const int x1 = min(x0 + RT_TB0, p.R0);
  prologue<0>(p, smem, x0, y0, z0);
  for (int x = x0; x < x1; ++x) {
    const int t = x - x0;
    load_all<0>(p, smem, x, t, y0, z0);
    __syncthreads();
    if (inside) {
      RingReader rd{p, smem, t, ty, tz, {}};
#pragma unroll
      for (int g = 0; g < RT_NG; ++g)
        rd.idx[g] = p.org[g] + x * p.sx[g] + y * p.sy[g] + z;
      float out[RT_NO];
      stencil_point(rd, p.s, out);
#pragma unroll
      for (int o = 0; o < RT_NO; ++o) p.g[out_grid(o)][rd.idx[out_grid(o)]] = out[o];
    }
    __syncthreads();   // the next plane overwrites the oldest slot
  }
}

extern "C" int rt_stream_step(const void* meta, const void* scal, void* stream) {
  const Params p = rt_params(meta, scal);
  const size_t smem_bytes = sizeof(float) * (kSmemFloats > 0 ? kSmemFloats : 1);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 threads(RT_TB2, RT_TB1, 1);
  const dim3 blocks((p.R2 + RT_TB2 - 1) / RT_TB2, (p.R1 + RT_TB1 - 1) / RT_TB1,
                    (p.R0 + RT_TB0 - 1) / RT_TB0);
  stream_step_kernel<<<blocks, threads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
