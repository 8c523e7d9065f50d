// Asynchronous copies into shared memory, shared by the kernels that stage
// halo'd boxes or planes (K4 smem: map_smem.cuh; K2: stream_step.cuh; K3:
// temporal_step.cuh): 4-byte cp.async granules, mbarriers, the TMA's 3D
// and 4D (a scenario axis) tiled copies, and on the host the encoding and cache of its maps.  The
// includer defines elem_t (common.cuh).
//
// Rules the card imposes (found on an H100): a TMA box's inner start must
// lie on a 16-byte boundary (else cudaError 715), the tensor's base and
// pitches must be 16-byte multiples, and no box extent may pass 256 cells;
// a shared-memory buffer the threads last read through the generic proxy
// is handed to the TMA only after a barrier and fence.proxy.async.  A wait
// for a copy that never arrives traps after 10 s of wall time instead of
// hanging the card.
#pragma once
#include <cuda.h>

#include <mutex>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// the arrival of a phase that copies nothing
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// the buffer about to be refilled by the TMA was last read through the
// generic proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// wait for the phase of parity `parity` to complete; a copy that never
// arrives traps (after 10 s of wall time, far past any healthy copy even on
// a time-sliced card) instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  const unsigned long long t0 = global_ns();
  while (!done) {
    if (global_ns() - t0 > 10000000000ULL) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// the box of `map` at cell (c0, c1, c2) (inner first) into dst, completing
// on bar; cells outside the tensor arrive as 0
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            unsigned long long* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// the same with a fourth coordinate c3: the scenario of a map with one
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            unsigned long long* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The granule copy of ROWS staged rows, P2 cells apart, by THREADS
// threads: row(yr, rs, lo, hi) gives row yr's first staged cell rs and the
// cells [lo, hi) it must hold (element indices of grid g; false: skip the
// row); the row is staged from the 4-byte granule holding rs (a bf16 row
// whose rs is odd starts one cell early, and its reader adds that offset
// back), and each granule holding a cell of [lo, hi) is copied.  A
// thread's granule of a row is fixed: one division a thread, none a cell,
// while a row's granules fit the block's threads.
template <int P2, int ROWS, int THREADS, class Row>
__device__ __forceinline__ void copy_granules(elem_t* dst, const elem_t* g, int tid,
                                              const Row& row) {
  constexpr int GRAN = 4 / static_cast<int>(sizeof(elem_t));
  constexpr int GR = P2 / GRAN;
  auto one = [&](int yr, int k) {
    long long rs, lo, hi;
    if (!row(yr, rs, lo, hi)) return;
    const long long ga = (rs & ~static_cast<long long>(GRAN - 1)) + k * GRAN;
    if (ga + GRAN > lo && ga < hi) cp_async4(dst + yr * P2 + k * GRAN, g + ga);
  };
  if constexpr (GR <= THREADS) {
    constexpr int STEP = THREADS / GR;
    if (tid < STEP * GR) {
      const int k = tid % GR;
      for (int yr = tid / GR; yr < ROWS; yr += STEP) one(yr, k);
    }
  } else {
    for (int yr = 0; yr < ROWS; ++yr)
      for (int k = tid; k < GR; k += THREADS) one(yr, k);
  }
}

// guards the host state below (the driver entry point, the TMA map cache,
// each kernel's per-device launch state) against host threads calling at
// once
static std::mutex host_state_mutex;

// cuTensorMapEncodeTiled, a CUDA driver API function, reached through the
// runtime (the build links no libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The TMA map of grid g's tensor at ptr (its extents n0 x sx/sy x sy,
// pitches sx, sy in cells) with boxes of b2 x b1 x b0 cells (inner first),
// cached by (grid, pointer, shape, scenarios, box): encoding is host work on
// every launch otherwise.  With nb > 0 the tensor holds nb scenarios, bs
// cells apart, and the map has a fourth dimension, the scenario, with a box
// of one: a box at one scenario's edge reads what it reads unbatched (the
// TMA's zeros past axis 0), never the next scenario's planes.  nb = 0: a
// map of three dimensions.  The caller holds host_state_mutex.
static CUresult tma_map(int g, void* ptr, long long n0, long long sx, long long sy, int nb,
                        long long bs, int b2, int b1, int b0, CUtensorMap* out) {
  struct Entry {
    int g;
    void* ptr;
    long long n0, sx, sy;
    int nb;
    long long bs;
    int b2, b1, b0;
    CUtensorMap map;
  };
  constexpr int kCache = 32;
  static Entry cache[kCache];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.g == g && e.ptr == ptr && e.n0 == n0 && e.sx == sx && e.sy == sy && e.nb == nb &&
        e.bs == bs && e.b2 == b2 && e.b1 == b1 && e.b0 == b0) {
      *out = e.map;
      return CUDA_SUCCESS;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  constexpr cuuint64_t es = sizeof(elem_t);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(sy), static_cast<cuuint64_t>(sx / sy),
                              static_cast<cuuint64_t>(n0), static_cast<cuuint64_t>(nb)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sy) * es, static_cast<cuuint64_t>(sx) * es,
                                 static_cast<cuuint64_t>(bs) * es};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(b2), static_cast<cuuint32_t>(b1),
                             static_cast<cuuint32_t>(b0), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map, sizeof(elem_t) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      nb > 0 ? 4 : 3, ptr, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return r;
  Entry& e = used < kCache ? cache[used++] : cache[next++ % kCache];
  e = Entry{g, ptr, n0, sx, sy, nb, bs, b2, b1, b0, map};
  *out = map;
  return CUDA_SUCCESS;
}

// grid g's region origin (element index org, pitches sx, sy) as the cell
// coordinates (ox, oy, oz) of its tensor
static inline void origin_cells(long long org, long long sx, long long sy, int* ox, int* oy,
                                int* oz) {
  *ox = static_cast<int>(org / sx);
  *oy = static_cast<int>(org % sx / sy);
  *oz = static_cast<int>(org % sy);
}
