// K1's and K4 gmem's column walk (map_step.cuh, RT_MAP_T 0): the points a
// lane computes along axis 2 and the register queues along axis 0.
// Shared by the kernel and host code that checks the geometry: nothing
// here touches CUDA's runtime.  The includer defines elem_t and the
// generated header (RT_NG, RT_TB0/1/2, the per-grid tables grid_h0/1/2 and
// grid_read, and RT_GMEM_P).
//
// Lanes.  A thread (a lane) computes kP = RT_GMEM_P points adjacent along
// axis 2, its unit of cells: two where the block's rows hold an even
// number of points, else one.  The lanes of a block row lie along axis 2,
// so a warp's loads of one tap are one run of adjacent cells.  A tap
// (0, 0, dz) of the lane's point j is cell k = j + dz of its row, in the
// unit lane_of(k) units from the lane's own, at cell cell_of(k) of it: a
// cell of the lane's own unit comes from its queue, any other tap is a
// load at a constant offset.  Loads, not warp shuffles, for the taps of
// the neighbouring lanes: on the H100 a shuffle took a SHFL, a select and
// convergence checks where a load at a constant offset is one LDG, and a
// build that shuffled ran 1.1-1.6x slower (PERF.md, Findings).
//
// Queues.  Each grid a tap reads keeps its 2 h0 + 1 centre-column units,
// planes x - h0 .. x + h0, slot h0 + dx holding plane x + dx: before the
// column's first plane the prologue loads 2 h0 planes, and each plane adds
// one (center-only grids: h0 = 0, one slot).  The queue shifts by a slot a
// plane, so every slot index is a constant of the code.
#pragma once

constexpr int kP = RT_GMEM_P;
constexpr int kThreads = RT_TB1 * (RT_TB2 / kP);

// unit offset and cell of cell k (from a lane's first cell)
__host__ __device__ constexpr int lane_of(int k) { return k >= 0 ? k / kP : -((kP - 1 - k) / kP); }
__host__ __device__ constexpr int cell_of(int k) { return k - kP * lane_of(k); }

// each read grid's queue: its length, its first slot, the slot of tap dx
__host__ __device__ constexpr int queue_len(int g) { return grid_read(g) ? 2 * grid_h0(g) + 1 : 0; }
__host__ __device__ constexpr int queue_offset(int g) {
  return g <= 0 ? 0 : queue_offset(g - 1) + queue_len(g - 1);
}
__host__ __device__ constexpr int tap_slot(int g, int dx) { return queue_offset(g) + grid_h0(g) + dx; }
__host__ __device__ constexpr int prologue_planes(int g) { return grid_read(g) ? 2 * grid_h0(g) : 0; }
constexpr int kQueue = queue_offset(RT_NG) > 0 ? queue_offset(RT_NG) : 1;
