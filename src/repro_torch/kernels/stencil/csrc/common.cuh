// Shared parameter block and element type of the stencil kernels.
//
// A kernel source is the generated header (emit.py: RT_ELEM, the grids'
// element type, float or __nv_bfloat16; RT_NG operand grids,
// RT_NS scalars, RT_NO outputs, the tile RT_TB0 x RT_TB1 x RT_TB2, the
// per-grid tap halos grid_h0/1/2, grid_ring, out_grid and the point
// function stencil_point) followed by one of the kernel templates
// (map_step.cuh, stream_step.cuh, semi_step.cuh, temporal_step.cuh), which
// include this file.
//
// Every grid is a buffer contiguous along axis 2: on the fused path a
// layout buffer (CudaPlan.to_padded: the interior plus the grid's layout
// halo), on the per-application path (MapPlan) the grid's full halo'd
// tensor, with org at the region's first point and R the region's extent.
// With RT_MAP (every MapPlan build, and K1) outputs go to destinations of
// their own.  2D stencils run as 3D ones of shape (R0, 1, R1).
// Indices are 64-bit.
//
// Scenarios (st.timeloop(batch=B), K1, K2, K3 and K5): one launch advances
// nb of them.  Each grid's buffer holds nb scenarios of its layout one
// after another, bs[g] elements apart (Scenarios, a kernel argument beside
// Params), and blockIdx.z walks scenario b's axis-0 tiles at b x (axis-0
// tiles) + tile (scenario_of).  A scenario's scalars are row b of sc, an
// (nb, RT_NS) f32 array on the card that the wrapper allocates, copied into
// the build's constant memory before the launch.  Each of those kernels is
// a template on kBatch: the build holds both instantiations; a launch of
// one scenario with its scalars by value (sc null: every unbatched launch)
// runs kBatch = false, the kernel without a scenario index (b = 0, s in the
// parameter block), any other kBatch = true, with B a run-time argument.
// A scenario's arithmetic is the unbatched launch's (K5 emits its finish
// without FMA contraction, emit.py: which products the compiler contracts
// follows where the scalars are read from).  The per-application kernels
// (K4) take nb = 1 and sc null.
//
// Arithmetic is f32 whatever RT_ELEM is: every grid cell is read through
// ld_elem (or converted when a kernel stages it), and store_out rounds
// once, to nearest even, when it writes an output cell.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#ifndef RT_ELEM
#define RT_ELEM float
#endif
typedef RT_ELEM elem_t;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
// one grid cell, read through the read-only path, as f32
__device__ __forceinline__ float ld_elem(const float* ptr) { return __ldg(ptr); }
__device__ __forceinline__ float ld_elem(const __nv_bfloat16* ptr) {
  return __bfloat162float(__ldg(ptr));
}
// v rounded to the element type, written at ptr
__device__ __forceinline__ void st_elem(float* ptr, float v) { *ptr = v; }
__device__ __forceinline__ void st_elem(__nv_bfloat16* ptr, float v) {
  *ptr = __float2bfloat16_rn(v);
}

constexpr int kNS = RT_NS > 0 ? RT_NS : 1;

struct Params {
  elem_t* g[RT_NG];         // layout buffer of each operand grid
  long long sx[RT_NG];      // element stride of axis 0
  long long sy[RT_NG];      // element stride of axis 1 (axis 2 is dense)
  long long org[RT_NG];     // element index of interior point (0, 0, 0)
  float s[kNS];
  int R0, R1, R2;           // interior (RT_MAP: region) extent
#ifdef RT_MAP
  // where output o goes: its own grid (in place) or a destination buffer
  // of the region's shape that no block reads
  elem_t* d[RT_NO];
  long long dsx[RT_NO], dsy[RT_NO], dorg[RT_NO];
#endif
};

// A launch's scenarios, a kernel argument of its own beside Params (a
// larger Params compiles K1's scenario-less build with fewer registers
// and 9 % slower on star3d4r at 512^3 on an H100).
struct Scenarios {
  int nb;                   // scenarios
  const float* sc;          // (nb, RT_NS) scalars on the card, or null: s
  long long bs[RT_NG];      // element stride of the scenario axis
  long long dbs[RT_NO];     // the same of each destination (RT_MAP)
};

// int64s of meta that rt_params and rt_scenarios read; a kernel's own
// entries follow
#ifdef RT_MAP
constexpr int kMetaLen = 5 * RT_NG + 5 + 5 * RT_NO;
#else
constexpr int kMetaLen = 5 * RT_NG + 5;
#endif

// meta = [g x NG, sx x NG, sy x NG, org x NG, R0, R1, R2, nb, sc, bs x NG]
// as int64 (with RT_MAP followed by [d x NO, dsx x NO, dsy x NO, dorg x NO,
// dbs x NO]), scal = NS floats; both in host memory.
static inline Params rt_params(const void* meta, const void* scal) {
  const long long* m = static_cast<const long long*>(meta);
  const float* sc = static_cast<const float*>(scal);
  Params p;
  for (int i = 0; i < RT_NG; ++i) {
    p.g[i] = reinterpret_cast<elem_t*>(m[i]);
    p.sx[i] = m[RT_NG + i];
    p.sy[i] = m[2 * RT_NG + i];
    p.org[i] = m[3 * RT_NG + i];
  }
  for (int i = 0; i < (RT_NS > 0 ? RT_NS : 1); ++i) p.s[i] = RT_NS > 0 ? sc[i] : 0.0f;
  p.R0 = static_cast<int>(m[4 * RT_NG]);
  p.R1 = static_cast<int>(m[4 * RT_NG + 1]);
  p.R2 = static_cast<int>(m[4 * RT_NG + 2]);
#ifdef RT_MAP
  const long long* d = m + 5 * RT_NG + 5;
  for (int o = 0; o < RT_NO; ++o) {
    p.d[o] = reinterpret_cast<elem_t*>(d[o]);
    p.dsx[o] = d[RT_NO + o];
    p.dsy[o] = d[2 * RT_NO + o];
    p.dorg[o] = d[3 * RT_NO + o];
  }
#endif
  return p;
}
static inline Scenarios rt_scenarios(const void* meta) {
  const long long* m = static_cast<const long long*>(meta);
  Scenarios a{};
  a.nb = static_cast<int>(m[4 * RT_NG + 3]);
  a.sc = reinterpret_cast<const float*>(m[4 * RT_NG + 4]);
  for (int i = 0; i < RT_NG; ++i) a.bs[i] = m[4 * RT_NG + 5 + i];
#ifdef RT_MAP
  for (int o = 0; o < RT_NO; ++o) a.dbs[o] = m[5 * RT_NG + 5 + 4 * RT_NO + o];
#endif
  return a;
}

// Whether a launch takes the scenario-indexed instantiation (kBatch).
static inline bool batched(const Scenarios& a) { return a.nb != 1 || a.sc != nullptr; }
// The launch's grid along z: every scenario's axis-0 tiles of tb0 planes;
// 0 past the card's 65535.
static inline unsigned scenario_blocks(const Params& p, const Scenarios& a, int tb0) {
  const long long n = static_cast<long long>(a.nb) * ((p.R0 + tb0 - 1) / tb0);
  return n <= 65535 ? static_cast<unsigned>(n) : 0u;
}
// This block's scenario (0 without a scenario index), and its first plane
// along axis 0.
template <bool kBatch>
__device__ __forceinline__ int scenario_of(const Params& p, int tb0, int* x0) {
  if constexpr (!kBatch) {
    *x0 = blockIdx.z * tb0;
    return 0;
  } else {
    const int tiles0 = (p.R0 + tb0 - 1) / tb0;
    const int b = static_cast<int>(blockIdx.z) / tiles0;
    *x0 = (static_cast<int>(blockIdx.z) - b * tiles0) * tb0;
    return b;
  }
}
// Scenario b's buffer of grid g.
template <bool kBatch>
__device__ __forceinline__ elem_t* grid_buf(const Params& p, const Scenarios& a, int g, int b) {
  if constexpr (!kBatch) {
    return p.g[g];
  } else {
    return p.g[g] + b * a.bs[g];
  }
}
// Scenario b's element offset in grid g's buffer.
template <bool kBatch>
__device__ __forceinline__ long long scenario_offset(const Scenarios& a, int g, int b) {
  if constexpr (!kBatch) {
    return 0;
  } else {
    return b * a.bs[g];
  }
}
// A batched launch's scalars: the (nb, RT_NS) array sc, copied into this
// build's constant memory before the launch (scenario_scalars_to), read
// with a uniform index, as the parameter block is (codegen.py
// SCENARIO_SCALARS).
constexpr int kScenarioScalars = 8192;
__constant__ float scenario_sc[kScenarioScalars];
static inline cudaError_t scenario_scalars_to(const Scenarios& a, cudaStream_t stream) {
  if (!batched(a) || RT_NS == 0) return cudaSuccess;
  if (static_cast<long long>(a.nb) * RT_NS > kScenarioScalars) return cudaErrorInvalidValue;
  return cudaMemcpyToSymbolAsync(scenario_sc, a.sc, sizeof(float) * a.nb * RT_NS, 0,
                                 cudaMemcpyDeviceToDevice, stream);
}
// The scalars of scenario b: its row of scenario_sc (kBatch), or the
// launch's own in the parameter block.
template <bool kBatch>
__device__ __forceinline__ const float* scenario_scalars(const Params& p, int b) {
  if constexpr (!kBatch) {
    return p.s;
  } else {
    return scenario_sc + b * RT_NS;
  }
}

// Store output o of point (x, y, z), rounded to the element type: into its
// grid, or with RT_MAP into the plan's destination for it.
__device__ __forceinline__ void store_out(const Params& p, int o, int x, int y, int z,
                                          float v) {
#ifdef RT_MAP
  st_elem(p.d[o] + p.dorg[o] + x * p.dsx[o] + y * p.dsy[o] + z, v);
#else
  const int g = out_grid(o);
  st_elem(p.g[g] + p.org[g] + x * p.sx[g] + y * p.sy[g] + z, v);
#endif
}
// The same for scenario b.
template <bool kBatch>
__device__ __forceinline__ void store_out(const Params& p, const Scenarios& a, int o, int x,
                                          int y, int z, float v, int b) {
  if constexpr (!kBatch) {
    store_out(p, o, x, y, z, v);
  } else {
#ifdef RT_MAP
    st_elem(p.d[o] + b * a.dbs[o] + p.dorg[o] + x * p.dsx[o] + y * p.dsy[o] + z, v);
#else
    const int g = out_grid(o);
    st_elem(p.g[g] + b * a.bs[g] + p.org[g] + x * p.sx[g] + y * p.sy[g] + z, v);
#endif
  }
}
