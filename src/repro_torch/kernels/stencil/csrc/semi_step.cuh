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
// walks a chunk of RT_TB0 output planes along axis 0; a thread walks
// kCols columns adjacent along y (two for f32 grids when RT_TB1 is even).
// Each input plane of
// every grid with an off-center tap is read from device memory once per
// block and staged with its y/z halo in a ring of kStages planes in
// shared memory, in the grids' own element type; each thread scatters it
// into the partial sums of its column, kept in registers (semi_ring.cuh);
// an output plane completes 2H planes after its first input plane.
//
// Bound: device-memory bytes, as K1 (each operand grid read once, each
// output written once).  Two things keep a semi-stencil from it, and the
// design answers both:
//   - coefficients: evaluated per term, acoustic ISO's ((vp2*dt*dt)*C) /
//     (1 + damp*dt) costs two loads and a division for each of 24 terms.
//     The generated code groups the terms by the residual of their
//     coefficient (emit.py semi_functions): a term adds kappa * tap to its
//     group's partial sum, and each group's residual is evaluated once a
//     point, from the fields at the output point, when the plane is
//     emitted;
//   - latency: a plane loaded only after the previous one was scattered
//     costs each plane a full device-memory round trip.  Plane i+2 is
//     copied with cp.async (4-byte granules: a halo'd row start z0 - h2 is
//     not 16-byte aligned) into the ring while plane i is scattered; one
//     barrier a plane orders the copies and the ring's reuse.
// Outputs are written in place: they have center-only taps, and a block
// reads an output grid only at its own chunk's points, each before it
// writes it.
//
// Rows of a staged plane start at the granule below their first cell: a
// bf16 row whose first cell has an odd element index is staged from the
// cell before it, and the reader adds that offset back.
//
// With RT_MAP this is K5's per-application call (template semi of
// lower_pallas, _make_body_streaming -> _stream_outputs): the grids are the
// full halo'd tensors with org at the region's first point and outputs go
// to the plan's destinations (store_out).
#include "common.cuh"

constexpr int kStages = 3;                      // staged planes in the ring
constexpr int kAlign = 4 / sizeof(elem_t);      // cells of one 4-byte granule
__host__ __device__ constexpr int row_pitch(int g) {
  return (RT_TB2 + 2 * grid_h2(g) + 2 * (kAlign - 1)) / kAlign * kAlign;
}
__host__ __device__ constexpr int plane_elems(int g) {
  return grid_ring(g) ? (RT_TB1 + 2 * grid_h1(g)) * row_pitch(g) : 0;
}
__host__ __device__ constexpr int plane_offset(int g) {
  return g <= 0 ? 0 : plane_offset(g - 1) + plane_elems(g - 1);
}
constexpr int kPlaneElems = plane_offset(RT_NG);
// columns a thread walks, adjacent along y: their taps on the staged plane
// share rows, so the compiler loads each shared cell once for both.  f32
// only: a bf16 row's granule offset differs between the two columns' rows,
// and two bf16 columns a thread ran slower than one on the card.
constexpr int kCols = sizeof(elem_t) == 4 && RT_TB1 % 2 == 0 ? 2 : 1;
constexpr int kThreads = RT_TB1 / kCols * RT_TB2;

#include "semi_ring.cuh"

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// element index of the first halo'd cell of row gy of plane xin of grid G
// in scenario b, from scenario 0's buffer (its granules are aligned)
template <bool kBatch, int G>
__device__ __forceinline__ long long row_start(const Params& p, const Scenarios& sn, int b,
                                               int xin, int gy, int z0) {
  return scenario_offset<kBatch>(sn, G, b) + p.org[G] + static_cast<long long>(xin) * p.sx[G] +
         static_cast<long long>(gy) * p.sy[G] + z0 - grid_h2(G);
}

// Issue the copies of plane xin of every ring grid with its y/z halo into
// the staged plane buf; planes, rows and cells outside the grid's tap
// reach [-h, R + h) are skipped (they only feed planes outside [0, R0),
// which semi_ring.cuh never adds to).
template <bool kBatch, int G>
__device__ __forceinline__ void stage_plane(const Params& p, const Scenarios& sn, elem_t* buf,
                                            int b, int xin, int y0, int z0) {
  if constexpr (G < RT_NG) {
    if constexpr (grid_ring(G) != 0) {
      constexpr int h0 = grid_h0(G), h1 = grid_h1(G), h2 = grid_h2(G);
      constexpr int W1 = RT_TB1 + 2 * h1, W2 = RT_TB2 + 2 * h2;
      constexpr int GR = row_pitch(G) / kAlign;          // granules a row
      if (xin >= -h0 && xin < p.R0 + h0) {
        elem_t* dst = buf + plane_offset(G);
        const int n = min(W2, p.R2 + h2 - (z0 - h2));      // cells a row needs
        for (int i = threadIdx.y * RT_TB2 + threadIdx.x; i < W1 * GR; i += kThreads) {
          const int row = i / GR, k = i - row * GR;
          const int gy = y0 - h1 + row;
          if (gy >= p.R1 + h1) continue;
          const long long rs = row_start<kBatch, G>(p, sn, b, xin, gy, z0);
          const long long a = rs & ~static_cast<long long>(kAlign - 1);
          if (a + k * kAlign < rs + n)
            cp_async4(dst + row * row_pitch(G) + k * kAlign, p.g[G] + a + k * kAlign);
        }
      }
    }
    stage_plane<kBatch, G + 1>(p, sn, buf, b, xin, y0, z0);
  }
}

template <bool kBatch>
struct SemiReader {
  const Params& p;
  const Scenarios& sn;
  const elem_t* buf;      // the staged input plane xin
  int b, xin, y0, z0, ty, tz, y, z;
  // input plane xin of grid G at (y + dy, z + dz)
  template <int G>
  __device__ __forceinline__ float tap(int dy, int dz) const {
    const int row = ty + grid_h1(G) + dy;
    int off = 0;          // the row's first cell within its first granule
    if constexpr (kAlign > 1) {
      // low bits of the row's start index (32-bit arithmetic keeps them)
      const int first = static_cast<int>(row_start<kBatch, G>(p, sn, b, xin, y0 - grid_h1(G), z0));
      off = (first + row * static_cast<int>(p.sy[G])) & (kAlign - 1);
    }
    return to_float(buf[plane_offset(G) + row * row_pitch(G) + off + tz + grid_h2(G) + dz]);
  }
  // coefficient field G at output plane xin - d, this column
  template <int G>
  __device__ __forceinline__ float cf(int d) const {
    return ld_elem(grid_buf<kBatch>(p, sn, G, b) + p.org[G] + static_cast<long long>(xin - d) * p.sx[G] +
                   static_cast<long long>(y) * p.sy[G] + z);
  }
};

template <bool kBatch>
__global__ void __launch_bounds__(kThreads)
semi_step_kernel(const Params p, const Scenarios sn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  elem_t* smem = reinterpret_cast<elem_t*>(smem_raw);
  const int z0 = blockIdx.x * RT_TB2, y0 = blockIdx.y * RT_TB1;
  int x0;
  const int b = scenario_of<kBatch>(p, RT_TB0, &x0);
  const float* s = scenario_scalars<kBatch>(p, b);
  const int tz = threadIdx.x, ty0 = threadIdx.y * kCols;   // first column's row
  const int z = z0 + tz;
  const int x1 = min(x0 + RT_TB0, p.R0);
  const int n_in = x1 - x0 + 2 * RT_H;
  SemiAcc acc[kCols] = {};
  // the ring's first two planes; plane i + 2 is issued at plane i
  stage_plane<kBatch, 0>(p, sn, smem, b, x0 - RT_H, y0, z0);
  cp_async_commit();
  if (n_in > 1) stage_plane<kBatch, 0>(p, sn, smem + kPlaneElems, b, x0 - RT_H + 1, y0, z0);
  cp_async_commit();
  int slot = 0;                               // i mod kStages
  for (int base = 0; base < n_in; base += RT_NR) {
#pragma unroll
    for (int r = 0; r < RT_NR; ++r) {
      const int i = base + r;
      if (i >= n_in) break;                  // the same for the whole block
      const int xin = x0 - RT_H + i;
      cp_async_wait<1>();                    // this thread's copies of plane i
      __syncthreads();                       // everyone's; plane i-1 done with
      const int next = slot == 0 ? 2 : slot - 1;   // (i + 2) mod kStages
      if (i + 2 < n_in) stage_plane<kBatch, 0>(p, sn, smem + next * kPlaneElems, b, xin + 2, y0, z0);
      cp_async_commit();                     // (an empty group past the end)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int y = y0 + ty0 + c;
        if (z < p.R2 && y < p.R1) {
          const SemiReader<kBatch> rd{p, sn, smem + slot * kPlaneElems, b, xin, y0, z0,
                                      ty0 + c, tz, y, z};
          float out[RT_NO];
          if (semi_plane(rd, s, acc[c], r, x0, x1, out)) {
            const int o = xin - RT_H;
#pragma unroll
            for (int k = 0; k < RT_NO; ++k) store_out<kBatch>(p, sn, k, o, y, z, out[k], b);
          }
        }
      }
      slot = slot == kStages - 1 ? 0 : slot + 1;
    }
  }
  cp_async_wait<0>();
}

extern "C" int rt_semi_step(const void* meta, const void* scal, void* stream) {
  const Params p = rt_params(meta, scal);
  const Scenarios sn = rt_scenarios(meta);
  const unsigned nz = scenario_blocks(p, sn, RT_TB0);
  if (nz == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem_bytes =
      sizeof(elem_t) * kStages * (kPlaneElems > 0 ? kPlaneElems : 1);
  const bool many = batched(sn);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        many ? semi_step_kernel<true> : semi_step_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 threads(RT_TB2, RT_TB1 / kCols, 1);
  const dim3 blocks((p.R2 + RT_TB2 - 1) / RT_TB2, (p.R1 + RT_TB1 - 1) / RT_TB1, nz);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = scenario_scalars_to(sn, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (many)
    semi_step_kernel<true><<<blocks, threads, smem_bytes, st>>>(p, sn);
  else
    semi_step_kernel<false><<<blocks, threads, smem_bytes, st>>>(p, sn);
  return static_cast<int>(cudaGetLastError());
}
