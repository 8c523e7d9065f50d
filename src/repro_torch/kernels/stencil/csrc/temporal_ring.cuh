// K3's rings and the cells each thread owns.  Shared by the kernel
// (temporal_step.cuh) and host code that checks the geometry: nothing here
// touches CUDA's runtime.  The includer defines elem_t and the generated
// header (RT_TB0/1/2, grid_h0/1/2, grid_lead, RT_K, RT_GO, RT_PRE, RT_DLO,
// RT_THREADS).
//
// Sub-step j (0 .. RT_K-1) is computed over the tile widened by
// (RT_K-1-j)·h per side (stage_w1/2).  Ring -1 holds kInSlots = 2h0 + 1 +
// RT_PRE planes of the read swap buffer over the tile widened by RT_K·h,
// in the grid's own type, rows kInP2 cells apart (the row after
// grid_lead(RT_GO) cells, one granule of slack, rounded up to 16 bytes:
// the inner extent of its TMA box), each plane a multiple of 128 bytes (a
// TMA destination).  Ring j (0 .. RT_K-2) holds kRSlots = h0 - RT_DLO + 1
// planes of sub-step j, f32, unpadded: the planes x + RT_DLO .. x + h0
// that the taps of sub-step j + 1 at plane x leaving the column read.
// Then one 8-byte mbarrier a slot of ring -1.
//
// The RT_THREADS threads own the cells of sub-step 0's tile (owned_cell);
// sub-step j's tile lies inside it, j·h from its edges, so a cell keeps its
// thread through every sub-step, and the thread keeps the cell's column of
// each sub-step in a register queue.
#pragma once

constexpr int kH0 = grid_h0(RT_GO), kH1 = grid_h1(RT_GO), kH2 = grid_h2(RT_GO);
constexpr int kThreads = RT_THREADS;
constexpr int kGranule = 4 / static_cast<int>(sizeof(elem_t));   // cells of 4 bytes
constexpr int kVec = 16 / static_cast<int>(sizeof(elem_t));       // cells of 16 bytes
constexpr int kPlaneAlign = 128;

__host__ __device__ constexpr int stage_w1(int j) { return RT_TB1 + 2 * (RT_K - 1 - j) * kH1; }
__host__ __device__ constexpr int stage_w2(int j) { return RT_TB2 + 2 * (RT_K - 1 - j) * kH2; }

// ring -1
constexpr int kInW1 = stage_w1(-1), kInW2 = stage_w2(-1);
constexpr int kInLead = grid_lead(RT_GO);
constexpr int kInP2 = (kInLead + kInW2 + kGranule - 1 + kVec - 1) / kVec * kVec;
constexpr int kInPayload = kInW1 * kInP2 * static_cast<int>(sizeof(elem_t));
constexpr int kInBytes = (kInPayload + kPlaneAlign - 1) / kPlaneAlign * kPlaneAlign;
constexpr int kInSlots = 2 * kH0 + 1 + RT_PRE;

// rings 0 .. RT_K-2
constexpr int kRSlots = kH0 - RT_DLO + 1;
__host__ __device__ constexpr int ring_bytes(int j) { return (stage_w1(j) * stage_w2(j) * 4 + 15) / 16 * 16; }
__host__ __device__ constexpr int ring_off(int j) {
  return j <= 0 ? kInSlots * kInBytes : ring_off(j - 1) + kRSlots * ring_bytes(j - 1);
}
constexpr int kRingBytes = ring_off(RT_K - 1);
// dynamic shared memory of a block: room to align the base to 128 bytes,
// the rings and one mbarrier a slot of ring -1
constexpr int kSmemBytes = kPlaneAlign + kRingBytes + 8 * kInSlots;

// Threads own units of kPair cells adjacent along axis 1 (two where sub-step
// 0's tile has an even number of rows and h1 is even, so that no unit
// straddles the edge of a sub-step's tile): the two cells' off-column taps
// share staged rows.  Unit i (row-major over the tile's kPair-row bands)
// belongs to thread i mod RT_THREADS; kCells cells a thread at most.
constexpr int kPair = stage_w1(0) % 2 == 0 && kH1 % 2 == 0 ? 2 : 1;
constexpr int kCells0 = stage_w1(0) * stage_w2(0);
constexpr int kUnits0 = kCells0 / kPair;
constexpr int kCells = kPair * ((kUnits0 + kThreads - 1) / kThreads);

// Cell c of thread tid in sub-step 0's tile: false past the tile's end.
__host__ __device__ inline bool owned_cell(int tid, int c, int* cy, int* cz) {
  const int i = tid + c / kPair * kThreads;
  *cy = kPair * (i / stage_w2(0)) + c % kPair;
  *cz = i % stage_w2(0);
  return i < kUnits0;
}
// whether cell (cy, cz) of sub-step 0's tile lies in sub-step j's
__host__ __device__ constexpr bool in_stage(int j, int cy, int cz) {
  return cy >= j * kH1 && cy < stage_w1(0) - j * kH1 && cz >= j * kH2 &&
         cz < stage_w2(0) - j * kH2;
}
