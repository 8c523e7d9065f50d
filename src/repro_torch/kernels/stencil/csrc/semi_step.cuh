// K5 — semi-stencil: forward scatter of each input plane into a register
// ring of partial output planes (template semi).
//
// Replaces the JAX package's kernels/stencil/codegen.py _stream_outputs,
// semi branch (with _semi_linearize and _stream_halo), reached from
// _make_body_fused (PallasPlan._call_for, time_block=1).  The kernel is
// linear in its taps (CudaPlan checks): out = sum_i coeff_i * tap_i + const,
// where coefficients and the constant read center-only "coefficient
// fields" (acoustic's vp2, damp) and scalars.
//
// A thread block covers an RT_TB1 x RT_TB2 tile of the two fast axes and
// walks a chunk of RT_TB0 output planes along axis 0.  Each input plane of
// every grid with an off-center tap is read from device memory once per
// block, staged in shared memory with its y/z halo (double-buffered, one
// barrier per plane), and scattered by each thread into the RT_NR = 2H+1
// partial sums of its column, kept in registers (semi_ring.cuh); an output
// plane completes 2H planes after its first input plane.  Coefficient
// fields are read at the point from device memory (L1/L2 serve the 2H+1
// reads of one plane).
//
// Bound: device-memory bytes, as K1 (each operand grid read once, each
// output written once).  The design keeps one staged plane per grid where
// K2 keeps a ring of 2h+1, at the price of 2H+1 register partial sums per
// output and of re-reading the coefficient fields once per offset.
// Outputs are written in place: they have center-only taps, and a block
// reads an output grid only at its own chunk's points, each before it
// writes it.
//
// With RT_MAP this is K5's per-application call (template semi of
// lower_pallas, _make_body_streaming -> _stream_outputs): the grids are the
// full halo'd tensors with org at the region's first point and outputs go
// to the plan's destinations (store_out).
#include "common.cuh"

__host__ __device__ constexpr int plane_elems(int g) {
  return grid_ring(g) ? (RT_TB1 + 2 * grid_h1(g)) * (RT_TB2 + 2 * grid_h2(g)) : 0;
}
__host__ __device__ constexpr int plane_offset(int g) {
  return g <= 0 ? 0 : plane_offset(g - 1) + plane_elems(g - 1);
}
constexpr int kPlaneFloats = plane_offset(RT_NG);
constexpr int kThreads = RT_TB1 * RT_TB2;

#include "semi_ring.cuh"

// Stage plane xin of grid G with its y/z halo; planes and cells outside the
// grid's tap reach [-h, R + h) are skipped (they only feed planes outside
// [0, R0), which semi_ring.cuh never adds to).
template <int G>
__device__ __forceinline__ void load_plane(const Params& p, float* buf, int xin,
                                           int y0, int z0) {
  if constexpr (G < RT_NG) {
    if constexpr (grid_ring(G) != 0) {
      constexpr int h0 = grid_h0(G), h1 = grid_h1(G), h2 = grid_h2(G);
      constexpr int W1 = RT_TB1 + 2 * h1, W2 = RT_TB2 + 2 * h2;
      if (xin >= -h0 && xin < p.R0 + h0) {
        float* dst = buf + plane_offset(G);
        const float* src = p.g[G] + p.org[G] + static_cast<long long>(xin) * p.sx[G];
        for (int i = threadIdx.y * RT_TB2 + threadIdx.x; i < W1 * W2; i += kThreads) {
          const int gy = y0 - h1 + i / W2;
          const int gz = z0 - h2 + i % W2;
          if (gy < p.R1 + h1 && gz < p.R2 + h2) dst[i] = __ldg(src + gy * p.sy[G] + gz);
        }
      }
    }
    load_plane<G + 1>(p, buf, xin, y0, z0);
  }
}

struct SemiReader {
  const Params& p;
  const float* buf;       // the staged input plane xin
  int xin, ty, tz, y, z;
  // input plane xin of grid G at (y + dy, z + dz)
  template <int G>
  __device__ __forceinline__ float tap(int dy, int dz) const {
    constexpr int W2 = RT_TB2 + 2 * grid_h2(G);
    return buf[plane_offset(G) + (ty + grid_h1(G) + dy) * W2 + (tz + grid_h2(G) + dz)];
  }
  // coefficient field G at output plane xin - d, this column
  template <int G>
  __device__ __forceinline__ float cf(int d) const {
    return __ldg(p.g[G] + p.org[G] + static_cast<long long>(xin - d) * p.sx[G] +
                 y * p.sy[G] + z);
  }
};

__global__ void __launch_bounds__(RT_TB1 * RT_TB2)
semi_step_kernel(const Params p) {
  extern __shared__ float smem[];
  const int z0 = blockIdx.x * RT_TB2, y0 = blockIdx.y * RT_TB1;
  const int x0 = blockIdx.z * RT_TB0;
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int z = z0 + tz, y = y0 + ty;
  const bool inside = z < p.R2 && y < p.R1;
  const int x1 = min(x0 + RT_TB0, p.R0);
  const int n_in = x1 - x0 + 2 * RT_H;
  float acc[RT_NO][RT_NR] = {};
  for (int base = 0; base < n_in; base += RT_NR) {
#pragma unroll
    for (int r = 0; r < RT_NR; ++r) {
      const int i = base + r;
      if (i >= n_in) break;                  // the same for the whole block
      const int xin = x0 - RT_H + i;
      // double buffer: the plane staged two iterations ago was last read
      // before the previous barrier
      float* buf = smem + (i & 1) * kPlaneFloats;
      load_plane<0>(p, buf, xin, y0, z0);
      __syncthreads();
      if (inside) {
        const SemiReader rd{p, buf, xin, ty, tz, y, z};
        float out[RT_NO];
        if (semi_plane(rd, p.s, acc, r, x0, x1, out)) {
          const int o = xin - RT_H;
#pragma unroll
          for (int k = 0; k < RT_NO; ++k) store_out(p, k, o, y, z, out[k]);
        }
      }
    }
  }
}

extern "C" int rt_semi_step(const void* meta, const void* scal, void* stream) {
  const Params p = rt_params(meta, scal);
  const size_t smem_bytes = sizeof(float) * 2 * (kPlaneFloats > 0 ? kPlaneFloats : 1);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        semi_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 threads(RT_TB2, RT_TB1, 1);
  const dim3 blocks((p.R2 + RT_TB2 - 1) / RT_TB2, (p.R1 + RT_TB1 - 1) / RT_TB1,
                    (p.R0 + RT_TB0 - 1) / RT_TB0);
  semi_step_kernel<<<blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
