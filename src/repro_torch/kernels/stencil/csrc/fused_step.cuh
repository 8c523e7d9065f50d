// K1 — fused time step, one thread per interior point (templates gmem,
// smem and f4, which share one body in fused mode).
//
// Replaces the JAX package's kernels/stencil/codegen.py _make_body_fused,
// tap branch (PallasPlan._call_for, time_block=1): one step in the
// persistent layout, outputs written in place, the old value kept outside
// the interior.  Here a thread exists only for interior points, so the
// pass-through is threads that do nothing; writing in place is legal
// because output grids have center-only taps (CudaPlan rejects others):
// no thread reads a point another thread writes.
//
// Bound: device-memory bytes.  Per point the kernel must read each operand
// grid once and write each output once (star3d4r: 8 B, 49 flop; acoustic
// ISO: 20 B); the 2h+1 taps along each axis are re-read from L1/L2 by
// neighbouring threads.  Threads run along the dense axis 2, so a warp's
// taps at one offset are one coalesced 128-byte line.  Staging tiles in
// shared memory is a later step.
#include "common.cuh"

struct GmemReader {
  const Params& p;
  long long idx[RT_NG];   // element index of this point in each buffer
  template <int G>
  __device__ __forceinline__ float at(int dx, int dy, int dz) const {
    return __ldg(p.g[G] + idx[G] + dx * p.sx[G] + dy * p.sy[G] + dz);
  }
};

__global__ void __launch_bounds__(RT_TB1 * RT_TB2)
fused_step_kernel(const Params p) {
  const int z = blockIdx.x * RT_TB2 + threadIdx.x;
  const int y = blockIdx.y * RT_TB1 + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= p.R2 || y >= p.R1) return;   // outside the interior: keep
  GmemReader rd{p, {}};
#pragma unroll
  for (int g = 0; g < RT_NG; ++g)
    rd.idx[g] = p.org[g] + x * p.sx[g] + y * p.sy[g] + z;
  float out[RT_NO];
  stencil_point(rd, p.s, out);
#pragma unroll
  for (int o = 0; o < RT_NO; ++o) p.g[out_grid(o)][rd.idx[out_grid(o)]] = out[o];
}

extern "C" int rt_fused_step(const void* meta, const void* scal, void* stream) {
  const Params p = rt_params(meta, scal);
  const dim3 threads(RT_TB2, RT_TB1, 1);
  const dim3 blocks((p.R2 + RT_TB2 - 1) / RT_TB2, (p.R1 + RT_TB1 - 1) / RT_TB1,
                    p.R0);
  fused_step_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
