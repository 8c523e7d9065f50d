// K4 smem's staged tiles: their shared-memory layout, the tiles' order and
// the threads' share of a granule copy.  Shared by the kernel
// (map_smem.cuh) and host code that checks the geometry: nothing here
// touches CUDA's runtime.  The includer defines elem_t and the generated
// header (RT_TB0/1/2, the per-grid tables grid_h0/1/2, grid_ring,
// grid_tma, grid_read).
//
// A stage holds, for every grid with an off-center tap, the halo'd tile
// (RT_TB0 + 2h0) x (RT_TB1 + 2h1) x (RT_TB2 + 2h2) of one block tile in
// the grid's own element type, rows tile_p2(g) cells apart: the row, one
// granule of slack (a bf16 row copied in 4-byte granules starts at the
// granule below its first cell) and rounded up to 16 bytes, which is also
// the inner extent of the grid's TMA box (a multiple of 16 bytes).  Each
// grid's tile starts on a 128-byte boundary (a TMA destination); two stages
// alternate, then the two stages' mbarriers.
#pragma once

// a block: RT_TB2 x RT_TB1 threads, each walking one column of the tile
constexpr int kThreads = RT_TB2 * RT_TB1;
constexpr int kGranule = 4 / static_cast<int>(sizeof(elem_t));   // cells of 4 bytes
constexpr int kVec = 16 / static_cast<int>(sizeof(elem_t));       // cells of 16 bytes
constexpr int kTileAlign = 128;

__host__ __device__ constexpr int tile_t0(int g) { return RT_TB0 + 2 * grid_h0(g); }
__host__ __device__ constexpr int tile_t1(int g) { return RT_TB1 + 2 * grid_h1(g); }
__host__ __device__ constexpr int tile_w2(int g) { return RT_TB2 + 2 * grid_h2(g); }
__host__ __device__ constexpr int tile_p2(int g) {
  return (tile_w2(g) + kGranule - 1 + kVec - 1) / kVec * kVec;
}
__host__ __device__ constexpr int tile_cells(int g) {
  return grid_ring(g) ? tile_t0(g) * tile_t1(g) * tile_p2(g) : 0;
}
// byte offset of grid g's tile in a stage
__host__ __device__ constexpr int tile_offset(int g) {
  return g <= 0 ? 0
                : tile_offset(g - 1) +
                      (tile_cells(g - 1) * static_cast<int>(sizeof(elem_t)) + kTileAlign - 1) /
                          kTileAlign * kTileAlign;
}
constexpr int kStageBytes = tile_offset(RT_NG);
// dynamic shared memory of a block: room to align the base to 128 bytes,
// two stages and two 8-byte mbarriers
constexpr int kSmemBytes = kTileAlign + 2 * kStageBytes + 16;
// bytes the TMA copies of one stage deliver
__host__ __device__ constexpr int tma_bytes(int g) {
  return g <= 0 ? 0
                : tma_bytes(g - 1) + (grid_tma(g - 1) ? tile_cells(g - 1) *
                                                            static_cast<int>(sizeof(elem_t))
                                                      : 0);
}
__host__ __device__ constexpr bool any_granule(int g) {
  return g > 0 && ((grid_ring(g - 1) && !grid_tma(g - 1)) || any_granule(g - 1));
}
constexpr int kTmaBytes = tma_bytes(RT_NG);
constexpr bool kAnyTma = kTmaBytes > 0;
constexpr bool kAnyGranule = any_granule(RT_NG);

// The first point (x0, y0, z0) of tile t of a region of extent R: tiles
// run along axis 2 first, so the blocks that work at one time take
// neighbouring tiles, whose halos meet in L2.
struct TileOrigin {
  int x0, y0, z0;
};
__host__ __device__ inline TileOrigin tile_origin(int t, int R1, int R2) {
  const int n2 = (R2 + RT_TB2 - 1) / RT_TB2, n1 = (R1 + RT_TB1 - 1) / RT_TB1;
  const int t2 = t % n2, t12 = t / n2;
  return {t12 / n1 * RT_TB0, t12 % n1 * RT_TB1, t2 * RT_TB2};
}

// The granule copy of grid G's tile: thread tid copies granule k of rows
// row0, row0 + step, ... (row = xr * tile_t1 + yr); f(row, k) for each.
// One division a thread a tile, none a granule, while a row's granules fit
// the block's threads.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <int G, class F>
__host__ __device__ __forceinline__ void for_granules(int tid, const F& f) {
  constexpr int GR = tile_p2(G) / kGranule;
  constexpr int ROWS = tile_t0(G) * tile_t1(G);
  if constexpr (GR <= kThreads) {
    constexpr int STEP = kThreads / GR;
    if (tid < STEP * GR) {
      const int k = tid % GR;
      for (int row = tid / GR; row < ROWS; row += STEP) f(row, k);
    }
  } else {
    for (int row = 0; row < ROWS; ++row)
      for (int k = tid; k < GR; k += kThreads) f(row, k);
  }
}
