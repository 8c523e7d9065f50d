// K2's plane rings: their shared-memory layout and the threads' columns.
// Shared by the kernel (stream_step.cuh) and host code that checks the
// geometry: nothing here touches CUDA's runtime.  The includer defines
// elem_t and the generated header (RT_TB0/1/2, the per-grid tables
// grid_h0/1/2, grid_ring, grid_tma, grid_lead, and RT_PRE).
//
// A block covers an RT_TB1 x RT_TB2 tile of the two fast axes; each thread
// walks kRows columns adjacent along axis 1 (their taps share staged
// rows).  Every grid with an off-center tap keeps a ring of kSlots planes
// of the tile widened by its halo, (RT_TB1 + 2h1) x (RT_TB2 + 2h2) cells in
// the grid's own element type, rows ring_p2(g) cells apart: the row after
// grid_lead(g) cells (the TMA box starts there, on a 16-byte boundary),
// with one granule of slack (a bf16 row copied in 4-byte granules starts
// at the granule holding its first cell), rounded up to 16 bytes, which
// is the inner extent of the grid's TMA box.  A plane takes a multiple of
// 128 bytes (a TMA destination).  kSlots = 2H + 1 + RT_PRE, H the largest
// axis-0 halo: the 2H + 1 planes the taps of one plane read and the
// RT_PRE planes in flight.  After the rings, one 8-byte mbarrier a slot.
#pragma once

constexpr int kRows = RT_TB1 % 2 == 0 ? 2 : 1;
constexpr int kThreads = RT_TB2 * (RT_TB1 / kRows);
constexpr int kGranule = 4 / static_cast<int>(sizeof(elem_t));   // cells of 4 bytes
constexpr int kVec = 16 / static_cast<int>(sizeof(elem_t));       // cells of 16 bytes
constexpr int kPlaneAlign = 128;

__host__ __device__ constexpr int max_h0(int g) {
  return g <= 0 ? 0
                : (grid_ring(g - 1) && grid_h0(g - 1) > max_h0(g - 1) ? grid_h0(g - 1)
                                                                       : max_h0(g - 1));
}
constexpr int kH = max_h0(RT_NG);
constexpr int kSlots = 2 * kH + 1 + RT_PRE;

__host__ __device__ constexpr int ring_w1(int g) { return RT_TB1 + 2 * grid_h1(g); }
__host__ __device__ constexpr int ring_w2(int g) { return RT_TB2 + 2 * grid_h2(g); }
__host__ __device__ constexpr int ring_p2(int g) {
  return (grid_lead(g) + ring_w2(g) + kGranule - 1 + kVec - 1) / kVec * kVec;
}
// bytes of one staged plane of grid g, and what its TMA copy delivers
__host__ __device__ constexpr int plane_payload(int g) {
  return ring_w1(g) * ring_p2(g) * static_cast<int>(sizeof(elem_t));
}
__host__ __device__ constexpr int plane_bytes(int g) {
  return grid_ring(g) ? (plane_payload(g) + kPlaneAlign - 1) / kPlaneAlign * kPlaneAlign : 0;
}
// byte offset of grid g's ring
__host__ __device__ constexpr int ring_offset(int g) {
  return g <= 0 ? 0 : ring_offset(g - 1) + kSlots * plane_bytes(g - 1);
}
constexpr int kRingBytes = ring_offset(RT_NG);
// dynamic shared memory of a block: room to align the base to 128 bytes,
// the rings and one mbarrier a slot
constexpr int kSmemBytes = kPlaneAlign + kRingBytes + 8 * kSlots;
__host__ __device__ constexpr bool any_tma(int g) {
  return g > 0 && ((grid_ring(g - 1) && grid_tma(g - 1)) || any_tma(g - 1));
}
__host__ __device__ constexpr bool any_granule(int g) {
  return g > 0 && ((grid_ring(g - 1) && !grid_tma(g - 1)) || any_granule(g - 1));
}
constexpr bool kAnyTma = any_tma(RT_NG);
constexpr bool kAnyGranule = any_granule(RT_NG);

// Local plane i of a chunk starting at plane x0 is plane x0 - kH + i and
// lives in slot i mod kSlots.  The plane loop is unrolled by kSlots: at
// plane t = base + r of the chunk (base a multiple of kSlots) a tap at dx
// reads slot (r + kH + dx) mod kSlots, a constant.
__host__ __device__ constexpr int tap_slot(int r, int dx) { return (r + kH + dx) % kSlots; }
