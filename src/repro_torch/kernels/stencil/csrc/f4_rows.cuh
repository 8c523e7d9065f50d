// K4's f4 template: the tap rows of one thread's group of 4 points along
// axis 2, loaded as aligned float4s and realigned in registers.  Shared by
// the kernel (map_step.cuh) and any host code that walks a group the same
// way: nothing here touches CUDA's runtime.
//
// The generated header (emit.py f4_functions) lists the rows the point
// function reads: row r is grid f4_row_grid(r) at (dx, dy) = (f4_row_dx(r),
// f4_row_dy(r)), with its dz taps in [f4_row_lo(r), f4_row_hi(r)]; the
// point function reads tap dz of row r for point J as rd.template at<r,
// dz>().
//
// For a group at z0 with m = min(4, R2 - z0) points inside the region, a
// row needs the n = m + hi - lo cells that start at `first`, the element
// index of (x + dx, y + dy, z0 + lo).  It loads the vectors of 4 cells
// (float4s; 8-byte vectors of 4 bf16) from a = first rounded down to a
// multiple of 4 (the buffer's base is aligned to 4 cells, which the
// wrapper checks) while a + 4k < first + n: each vector then holds at
// least one needed cell, and none crosses a boundary of its own size, so
// none leaves the allocation whatever the pitch, the ragged edge or the
// region's start.  The rows are f32 whatever the cells' type.  Cell i of the row (z0 + lo + i) is w[off + i], off =
// first - a, taken by a 4-way select so that every index is a compile-time
// constant and the rows stay in registers.
#pragma once

__host__ __device__ constexpr int f4_width(int r) { return 4 + f4_row_hi(r) - f4_row_lo(r); }
// float4s that cover f4_width(r) cells from any of the 4 alignments
__host__ __device__ constexpr int f4_vecs(int r) { return (f4_width(r) + 6) / 4; }
__host__ __device__ constexpr int f4_offset(int r) {
  return r <= 0 ? 0 : f4_offset(r - 1) + f4_width(r - 1);
}
constexpr int kF4Floats = f4_offset(RT_F4_ROWS);

struct F4Rows {
  float v[kF4Floats > 0 ? kF4Floats : 1];
};

// Row R of the group; ld(ptr, out4) loads the aligned vector of 4 cells
// at ptr as f32.
template <int R, class E, class Ld>
__host__ __device__ __forceinline__ void f4_fill(F4Rows& rows, const E* base, long long first,
                                                 int n, const Ld& ld) {
  constexpr int NV = f4_vecs(R), W = f4_width(R);
  const long long a = first & ~3LL;
  const int off = static_cast<int>(first - a);
  float w[4 * NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (a + 4 * k < first + n) {
      ld(base + a + 4 * k, w + 4 * k);
    } else {
      w[4 * k] = w[4 * k + 1] = w[4 * k + 2] = w[4 * k + 3] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < W; ++i)
    rows.v[f4_offset(R) + i] =
        off == 0 ? w[i] : off == 1 ? w[i + 1] : off == 2 ? w[i + 2] : w[i + 3];
}

// Every row of the group at (x, y, z0) with m points in the region; g, sx,
// sy and org as in Params.
template <int R, class E, class Ld>
__host__ __device__ __forceinline__ void f4_fill_rows(E* const* g, const long long* sx,
                                                      const long long* sy, const long long* org,
                                                      F4Rows& rows, int x, int y, int z0, int m,
                                                      const Ld& ld) {
  if constexpr (R < RT_F4_ROWS) {
    constexpr int G = f4_row_grid(R);
    const long long first = org[G] + static_cast<long long>(x + f4_row_dx(R)) * sx[G] +
                            static_cast<long long>(y + f4_row_dy(R)) * sy[G] + z0 +
                            f4_row_lo(R);
    f4_fill<R>(rows, g[G], first, m + f4_row_hi(R) - f4_row_lo(R), ld);
    f4_fill_rows<R + 1>(g, sx, sy, org, rows, x, y, z0, m, ld);
  }
}

// The tap reader of point J (0..3) of the group.
template <int J>
struct F4Reader {
  const F4Rows& rows;
  template <int R, int DZ>
  __host__ __device__ __forceinline__ float at() const {
    return rows.v[f4_offset(R) + J + DZ - f4_row_lo(R)];
  }
};

// The point function at the group's 4 points (those past the region's end
// read zeros or cells of the next row and are not stored).
template <int J>
__host__ __device__ __forceinline__ void f4_points(const F4Rows& rows, const float* s,
                                                   float (&out)[4][RT_NO]) {
  if constexpr (J < 4) {
    stencil_point(F4Reader<J>{rows}, s, out[J]);
    f4_points<J + 1>(rows, s, out);
  }
}
