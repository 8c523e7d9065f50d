// K4's f4 template: one thread's column of groups of 4 points along axis 2,
// its tap rows loaded as aligned vectors of 4 cells (float4s; 8-byte
// vectors of 4 bf16 cells) and carried along axis 0 in register queues.
// Shared by the kernel (map_step.cuh) and any host code that walks a
// column the same way: nothing here touches CUDA's runtime.
//
// The generated header (emit.py f4_functions) groups the tap rows into
// families, one for each (grid, dy) the point function reads: family f is
// grid f4_fam_grid(f) at dy = f4_fam_dy(f), and f4_fam_hi(f) is the
// largest dz of its rows.  Point J (0..3) of the group at z0 reads tap dz
// of the row at axis-0 offset dx as cell dz + J of that row, so the row at
// dx needs cells [lo, hi + 3] relative to z0.  The cells that the same
// range of dx needs form a piece p: cells [f4_piece_c0(p), f4_piece_c1(p)]
// of family f4_piece_fam(p), needed at dx in [f4_piece_a(p),
// f4_piece_b(p)].  The row of plane x + dx at offset dx is the row the
// point one plane further on reads at dx - 1, so a piece is a queue of
// b - a + 1 slots: slot s holds plane x + a + s, a plane loads only the
// leading slot (plane x + b), and the queue shifts by one slot a plane.
// For star3d4r that is 11 vector loads a group of 4 points (the centre
// row's 3 and one for each of the 8 rows off axis 0), against 36 when
// every row of every plane was loaded.
//
// Loads.  The buffers' bases are aligned to 4 cells (the wrapper checks).
// Where both pitches of a grid are multiples of 4 cells, a piece's first
// cell has the same place in its aligned vector for every group (z0 is a
// multiple of 4 from the region's first point), and the plan emits it as
// f4_piece_off(p): the piece then loads exactly the ceil((off + W) / 4)
// vectors that hold its W cells and reads them at compile-time indices.
// Elsewhere (f4_piece_off(p) == -1) it loads (W + 6) / 4 vectors from the
// cell aligned down and realigns them by a 4-way select, so that every
// index is still a compile-time constant and the queues stay in registers.
// Either way a vector is loaded only when it starts at or before the last
// cell the family may need, (z0 + m - 1 + f4_fam_hi(f)) of the row, which
// lies in the grid's tap reach: each loaded vector thus holds a cell of
// the tensor and none crosses a boundary of its own size, so none leaves
// the allocation, whatever the pitch, the ragged edge or the region's
// start.  Vectors past that cell read as 0.  The queues are f32 whatever
// the cells' type.
#pragma once

// cells of piece p, slots of its queue, and its first float in the queues
__host__ __device__ constexpr int f4_width(int p) { return f4_piece_c1(p) - f4_piece_c0(p) + 1; }
__host__ __device__ constexpr int f4_depth(int p) { return f4_piece_b(p) - f4_piece_a(p) + 1; }
__host__ __device__ constexpr int f4_base(int p) {
  return p <= 0 ? 0 : f4_base(p - 1) + f4_width(p - 1) * f4_depth(p - 1);
}
// vectors one load of piece p reads
__host__ __device__ constexpr int f4_vecs(int p) {
  return f4_piece_off(p) >= 0 ? (f4_piece_off(p) + f4_width(p) + 3) / 4 : (f4_width(p) + 6) / 4;
}
// the piece of family f that holds cell c (-1: none)
__host__ __device__ constexpr int f4_piece_of(int f, int c) {
  for (int p = 0; p < RT_F4_PIECES; ++p)
    if (f4_piece_fam(p) == f && f4_piece_c0(p) <= c && c <= f4_piece_c1(p)) return p;
  return -1;
}
constexpr int kF4Floats = f4_base(RT_F4_PIECES);

struct F4Queues {
  float v[kF4Floats > 0 ? kF4Floats : 1];
};

// Load piece P of plane xp into slot S of its queue, for the group at
// (y, z0) with m points in the region; g, sx, sy and org as in Params;
// ld(ptr, out4) loads the aligned vector of 4 cells at ptr as f32.
template <int P, int S, class E, class Ld>
__host__ __device__ __forceinline__ void f4_load(F4Queues& q, E* const* g, const long long* sx,
                                                 const long long* sy, const long long* org,
                                                 int xp, int y, int z0, int m, const Ld& ld) {
  constexpr int F = f4_piece_fam(P), G = f4_fam_grid(F);
  constexpr int W = f4_width(P), NV = f4_vecs(P), OFF = f4_piece_off(P);
  const long long row = org[G] + static_cast<long long>(xp) * sx[G] +
                        static_cast<long long>(y + f4_fam_dy(F)) * sy[G] + z0;
  const long long first = row + f4_piece_c0(P);
  const long long last = row + m - 1 + f4_fam_hi(F);
  const long long a = OFF >= 0 ? first - OFF : first & ~3LL;
  float w[4 * NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (a + 4 * k <= last) {
      ld(g[G] + a + 4 * k, w + 4 * k);
    } else {
      w[4 * k] = w[4 * k + 1] = w[4 * k + 2] = w[4 * k + 3] = 0.0f;
    }
  }
  float* dst = q.v + f4_base(P) + S * W;
  if constexpr (OFF >= 0) {
#pragma unroll
    for (int i = 0; i < W; ++i) dst[i] = w[OFF + i];
  } else {
    const int off = static_cast<int>(first - a);
#pragma unroll
    for (int i = 0; i < W; ++i)
      dst[i] = off == 0 ? w[i] : off == 1 ? w[i + 1] : off == 2 ? w[i + 2] : w[i + 3];
  }
}

// Slots 0 .. depth - 2 of every piece's queue, for the first plane x0 of
// a column: planes x0 + a .. x0 + b - 1.
template <int P, int S = 0, class E, class Ld>
__host__ __device__ __forceinline__ void f4_prologue(F4Queues& q, E* const* g, const long long* sx,
                                                     const long long* sy, const long long* org,
                                                     int x0, int y, int z0, int m, const Ld& ld) {
  if constexpr (P < RT_F4_PIECES) {
    if constexpr (S < f4_depth(P) - 1) {
      f4_load<P, S>(q, g, sx, sy, org, x0 + f4_piece_a(P) + S, y, z0, m, ld);
      f4_prologue<P, S + 1>(q, g, sx, sy, org, x0, y, z0, m, ld);
    } else {
      f4_prologue<P + 1, 0>(q, g, sx, sy, org, x0, y, z0, m, ld);
    }
  }
}

// The leading slot of every queue at plane x: plane x + b.
template <int P, class E, class Ld>
__host__ __device__ __forceinline__ void f4_lead(F4Queues& q, E* const* g, const long long* sx,
                                                 const long long* sy, const long long* org, int x,
                                                 int y, int z0, int m, const Ld& ld) {
  if constexpr (P < RT_F4_PIECES) {
    f4_load<P, f4_depth(P) - 1>(q, g, sx, sy, org, x + f4_piece_b(P), y, z0, m, ld);
    f4_lead<P + 1>(q, g, sx, sy, org, x, y, z0, m, ld);
  }
}

// Every queue one slot on, for the next plane.
template <int P>
__host__ __device__ __forceinline__ void f4_shift(F4Queues& q) {
  if constexpr (P < RT_F4_PIECES) {
    constexpr int B = f4_base(P), W = f4_width(P);
#pragma unroll
    for (int i = 0; i < W * (f4_depth(P) - 1); ++i) q.v[B + i] = q.v[B + i + W];
    f4_shift<P + 1>(q);
  }
}

// The tap reader of point J (0..3) of the group.
template <int J>
struct F4Reader {
  const F4Queues& q;
  template <int F, int DX, int DZ>
  __host__ __device__ __forceinline__ float at() const {
    constexpr int P = f4_piece_of(F, DZ + J);
    static_assert(P >= 0, "a tap outside every piece of its family");
    return q.v[f4_base(P) + (DX - f4_piece_a(P)) * f4_width(P) + DZ + J - f4_piece_c0(P)];
  }
};

// The point function at the group's 4 points (those past the region's end
// read zeros or cells of the next row and are not stored).
template <int J>
__host__ __device__ __forceinline__ void f4_points(const F4Queues& q, const float* s,
                                                   float (&out)[4][RT_NO]) {
  if constexpr (J < 4) {
    stencil_point(F4Reader<J>{q}, s, out[J]);
    f4_points<J + 1>(q, s, out);
  }
}

// One thread's column: the groups at (x, y, z0) for x in [x0, x1), m of
// whose points lie in the region; st(x, out) stores the group's outputs.
template <class E, class Ld, class St>
__host__ __device__ __forceinline__ void f4_column(E* const* g, const long long* sx,
                                                   const long long* sy, const long long* org,
                                                   const float* s, int x0, int x1, int y, int z0,
                                                   int m, const Ld& ld, const St& st) {
  F4Queues q;
  f4_prologue<0>(q, g, sx, sy, org, x0, y, z0, m, ld);
  for (int x = x0; x < x1; ++x) {
    f4_lead<0>(q, g, sx, sy, org, x, y, z0, m, ld);
    float out[4][RT_NO];
    f4_points<0>(q, s, out);
    st(x, out);
    f4_shift<0>(q);
  }
}
