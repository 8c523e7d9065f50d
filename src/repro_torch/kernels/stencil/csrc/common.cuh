// Shared parameter block of the stencil kernels.
//
// A kernel source is the generated header (emit.py: RT_NG operand grids,
// RT_NS scalars, RT_NO outputs, the tile RT_TB0 x RT_TB1 x RT_TB2, the
// per-grid tap halos grid_h0/1/2, grid_ring, out_grid and the point
// function stencil_point) followed by one of fused_step.cuh or
// stream_step.cuh, which include this file.
//
// Every grid is a layout buffer (CudaPlan.to_padded): the interior plus the
// grid's layout halo, contiguous along axis 2.  2D stencils run as 3D ones
// of shape (R0, 1, R1).  Indices are 64-bit.
#pragma once
#include <cuda_runtime.h>

struct Params {
  float* g[RT_NG];          // layout buffer of each operand grid
  long long sx[RT_NG];      // element stride of axis 0
  long long sy[RT_NG];      // element stride of axis 1 (axis 2 is dense)
  long long org[RT_NG];     // element index of interior point (0, 0, 0)
  float s[RT_NS > 0 ? RT_NS : 1];
  int R0, R1, R2;           // interior extent
};

// meta = [g x NG, sx x NG, sy x NG, org x NG, R0, R1, R2] as int64,
// scal = NS floats; both in host memory.
static inline Params rt_params(const void* meta, const void* scal) {
  const long long* m = static_cast<const long long*>(meta);
  const float* sc = static_cast<const float*>(scal);
  Params p;
  for (int i = 0; i < RT_NG; ++i) {
    p.g[i] = reinterpret_cast<float*>(m[i]);
    p.sx[i] = m[RT_NG + i];
    p.sy[i] = m[2 * RT_NG + i];
    p.org[i] = m[3 * RT_NG + i];
  }
  for (int i = 0; i < (RT_NS > 0 ? RT_NS : 1); ++i) p.s[i] = RT_NS > 0 ? sc[i] : 0.0f;
  p.R0 = static_cast<int>(m[4 * RT_NG]);
  p.R1 = static_cast<int>(m[4 * RT_NG + 1]);
  p.R2 = static_cast<int>(m[4 * RT_NG + 2]);
  return p;
}
