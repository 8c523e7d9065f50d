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

struct Params {
  elem_t* g[RT_NG];         // layout buffer of each operand grid
  long long sx[RT_NG];      // element stride of axis 0
  long long sy[RT_NG];      // element stride of axis 1 (axis 2 is dense)
  long long org[RT_NG];     // element index of interior point (0, 0, 0)
  float s[RT_NS > 0 ? RT_NS : 1];
  int R0, R1, R2;           // interior (RT_MAP: region) extent
#ifdef RT_MAP
  // where output o goes: its own grid (in place) or a destination buffer
  // of the region's shape that no block reads
  elem_t* d[RT_NO];
  long long dsx[RT_NO], dsy[RT_NO], dorg[RT_NO];
#endif
};

// meta = [g x NG, sx x NG, sy x NG, org x NG, R0, R1, R2] as int64 (with
// RT_MAP followed by [d x NO, dsx x NO, dsy x NO, dorg x NO]), scal = NS
// floats; both in host memory.
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
  const long long* d = m + 4 * RT_NG + 3;
  for (int o = 0; o < RT_NO; ++o) {
    p.d[o] = reinterpret_cast<elem_t*>(d[o]);
    p.dsx[o] = d[RT_NO + o];
    p.dsy[o] = d[2 * RT_NO + o];
    p.dorg[o] = d[3 * RT_NO + o];
  }
#endif
  return p;
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
