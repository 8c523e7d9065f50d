// K5's per-column ring of partial output planes (semi-stencil), shared by
// the kernel (semi_step.cuh) and any host code that walks a column the
// same way: nothing here touches CUDA's runtime.
//
// The generated part (emit.py semi_functions) writes each output as
//   out(o) = sum_g phi_g(o) * P_g(o) + const(o),
// where the coefficient of every term is kappa_t * phi_g(t): kappa a
// number, phi_g a residual that reads coefficient fields at the output
// point only (acoustic ISO: one group, vp2*dt*dt / (1 + damp*dt); a
// constant-coefficient star: one group with phi = 1).  The ring holds the
// group sums P_g = sum_t kappa_t * tap_t, one per group (RT_NGR) and ring
// slot; phi_g is evaluated once a point, when its plane is emitted
// (semi_finish).
//
// A column (one y/z point) walks the input planes x_in = x0 - RT_H ..
// x1 + RT_H - 1 of its chunk [x0, x1), local index i = x_in - (x0 - RT_H).
// Output plane o = x_in - D (D = -RT_H .. RT_H) lives in ring slot
// (i + RT_H - D) mod RT_NR; with the plane loop unrolled by RT_NR (i = base
// + r, base a multiple of RT_NR) the slot is (r + RT_H - D) mod RT_NR, a
// compile-time constant once r is, so the ring stays in registers.  At
// x_in the scatter adds each offset-D term to the plane it feeds (only
// planes of the chunk), then plane x_in - RT_H, in slot r, is complete:
// semi_finish turns its group sums into the value, and the slot is
// cleared for plane x_in - RT_H + RT_NR.  This is the JAX body's
// `P.at[H - d].add(...)` / `P[0] + const` / shift, on a ring.
#pragma once

typedef float SemiAcc[RT_NO][RT_NR][RT_NGR];

template <int O, int D, class Rd>
__host__ __device__ __forceinline__ void semi_scatter_from(
    const Rd& rd, const float* s, float (&acc)[RT_NR][RT_NGR], int r, int x0, int x1) {
  if constexpr (D <= RT_H) {
    const int o = rd.xin - D;
    if (o >= x0 && o < x1) semi_scatter<O, D>(rd, s, acc[(r + RT_H - D) % RT_NR]);
    semi_scatter_from<O, D + 1>(rd, s, acc, r, x0, x1);
  }
}

template <int O, class Rd>
__host__ __device__ __forceinline__ void semi_outputs(
    const Rd& rd, const float* s, SemiAcc& acc, int r, int x0, int x1, bool emit,
    float* out) {
  if constexpr (O < RT_NO) {
    semi_scatter_from<O, -RT_H>(rd, s, acc[O], r, x0, x1);
    if (emit) out[O] = semi_finish<O>(rd, s, acc[O][r]);
#pragma unroll
    for (int g = 0; g < RT_NGR; ++g) acc[O][r][g] = 0.0f;
    semi_outputs<O + 1>(rd, s, acc, r, x0, x1, emit, out);
  }
}

// Scatter input plane rd.xin (ring position r = i mod RT_NR) of one column;
// returns true when plane rd.xin - RT_H lies in [x0, x1), out then holding
// its value for every output grid.
template <class Rd>
__host__ __device__ __forceinline__ bool semi_plane(
    const Rd& rd, const float* s, SemiAcc& acc, int r, int x0, int x1, float* out) {
  const bool emit = rd.xin - RT_H >= x0 && rd.xin - RT_H < x1;
  semi_outputs<0>(rd, s, acc, r, x0, x1, emit, out);
  return emit;
}
