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
// threads that do nothing.
//
// gmem and f4: a thread block covers an RT_TB0 x RT_TB1 x RT_TB2 tile of
// the box; its threads cover the RT_TB1 x RT_TB2 face (f4: RT_TB2 / 4
// groups of 4) and each walks the RT_TB0 points of its column.
//   gmem: taps through __ldg from device memory; threads run along the
//         dense axis 2, so a warp's taps at one offset are one coalesced
//         128-byte line, and a thread's axis-0 taps of consecutive points
//         fall on the lines its previous points loaded.
//   f4:   each thread computes 4 consecutive points along axis 2 from tap
//         rows loaded as aligned vectors of 4 cells and carried along its
//         column in register queues (f4_rows.cuh): the TPU's lane-aligned
//         blocks become 16-byte loads (8-byte ones of 4 bf16 cells), each
//         loaded once a column; where the grids' pitches are multiples of 4
//         cells the rows' alignment is fixed when the plan is made.
// smem: persistent blocks stage each tile's halo'd box by TMA or cp.async
// into one of two stages while they evaluate the other (map_smem.cuh).
//
// Bound: device-memory bytes.  One application must read each input grid
// once and write each output once: star3d4r at 512^3 moves 2 x 512^3 x 4 B
// = 1.07 GB, 0.321 ms at 3.35 TB/s; acoustic ISO five grid passes, 0.801
// ms (bf16 grids: half the bytes).  The 2h+1 taps along each axis are
// re-read from L1/L2 (gmem), from registers (f4: along axes 0 and 2) or
// from shared memory (smem, and registers along axis 0); the designs
// differ only in where those re-reads are served.
#include "common.cuh"

#if RT_MAP_T == 1
#include "f4_rows.cuh"
constexpr int kThreads = RT_TB1 * RT_TB2 / 4;

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
constexpr int kThreads = RT_TB1 * RT_TB2;

struct GmemReader {
  const Params& p;
  long long idx[RT_NG];   // element index of this point in each buffer
  template <int G>
  __device__ __forceinline__ float at(int dx, int dy, int dz) const {
    return ld_elem(p.g[G] + idx[G] + dx * p.sx[G] + dy * p.sy[G] + dz);
  }
};

__global__ void __launch_bounds__(kThreads) map_step_kernel(const Params p) {
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int z0 = blockIdx.x * RT_TB2, y0 = blockIdx.y * RT_TB1;
  const int x0 = blockIdx.z * RT_TB0;
  const int z = z0 + tz, y = y0 + ty;
  const int x1 = min(x0 + RT_TB0, p.R0);
  if (z >= p.R2 || y >= p.R1) return;   // outside the box: keep
  for (int x = x0; x < x1; ++x) {
    GmemReader rd{p, {}};
#pragma unroll
    for (int g = 0; g < RT_NG; ++g) rd.idx[g] = p.org[g] + x * p.sx[g] + y * p.sy[g] + z;
    float out[RT_NO];
    stencil_point(rd, p.s, out);
#pragma unroll
    for (int o = 0; o < RT_NO; ++o) store_out(p, o, x, y, z, out[o]);
  }
}
#endif

#if RT_MAP_T != 2
extern "C" int rt_map_step(const void* meta, const void* scal, void* stream) {
  const Params p = rt_params(meta, scal);
  const dim3 threads(RT_MAP_T == 1 ? RT_TB2 / 4 : RT_TB2, RT_TB1, 1);
  const dim3 blocks((p.R2 + RT_TB2 - 1) / RT_TB2, (p.R1 + RT_TB1 - 1) / RT_TB1,
                    (p.R0 + RT_TB0 - 1) / RT_TB0);
  map_step_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
#endif
