// K6: causal depthwise conv1d with zero history, for Hopper (sm_90a).
//
// Replaces the JAX package's kernels/conv1d/conv1d.py `_kernel` and
// `causal_conv1d_pallas` (the pl.pallas_call at conv1d.py:50):
//
//     y[b, t, c] = sum_{k < cw} w[k, c] * x[b, t - cw + 1 + k, c],  x = 0 below t = 0.
//
// The TPU kernel blocks the time axis and hands each block the previous
// one as its causal halo, because its grid runs in order through VMEM.
// Here blocks run in no order, so each thread walks a run of `rows`
// consecutive time rows of one sequence on its own: it owns a group of
// channels, loads the cw weights of its channels once into registers, the
// cw - 1 rows before its run (the halo, zero below t = 0) into a register
// queue whose slots are compile-time indices (cw is a template
// parameter), and then loads each row of its run once, kUnroll rows in
// flight, computes the row's outputs from the queue and the new row,
// stores them and shifts the queue by one slot.  Every x row is read once
// but for the cw - 1 halo rows of each run, which the previous run read
// too (from L2).
//
// Two builds of the one body, chosen by the launch (Python:
// conv1d.build_of) from the shapes and pointers, never by a failure:
//   * vector: a thread owns one 16-byte vector of channels (4 f32 or 8
//     bf16), loaded and stored as one 16-byte access a row.  Needs W a
//     multiple of the vector and x, w, y on 16-byte boundaries.
//   * lane: a thread owns one channel, with loads and stores of one
//     element: the ragged widths and the unaligned bases.
// The grid is (channel groups / kThreads) x (B * runs), runs = ceil(T / rows),
// with a grid-stride loop over the second axis past 65535.
//
// Numerics: products and sums in f32, each rounded on its own (no FMA
// contraction), in tap order, then one rounding to the output type: the
// plain version (ref.causal_conv1d_ref) does the same operations, so the
// two agree bit for bit.
//
// Bound: device-memory bytes (x read once, w once, y written once).  On
// the serving path it runs at [B, cw, 4096] once per recurrent layer and
// decode step, where one launch takes longer than its bytes; on the
// training path at [B, S + cw - 1, 4096] (forward, its recompute, and the
// input gradient on the time-reversed cotangent).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxWidth = 8;   // largest cw built (conv1d.MAX_WIDTH)
constexpr int kUnroll = 4;     // rows loaded before the first of them is used

// 16 bytes of channels a thread: 4 f32.
struct VecF32 {
  using elem = float;
  static constexpr int N = 4;
  using raw = uint4;
  __device__ static __forceinline__ raw load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static __forceinline__ void unpack(const raw& r, float (&v)[N]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static __forceinline__ void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                                              __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

// 16 bytes of channels a thread: 8 bf16, two to a 32-bit word (the lower
// channel in the low half).
struct VecBF16 {
  using elem = __nv_bfloat16;
  static constexpr int N = 8;
  using raw = uint4;
  __device__ static __forceinline__ raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static __forceinline__ void pair(uint32_t u, float& lo, float& hi) {
    lo = __uint_as_float(u << 16);
    hi = __uint_as_float(u & 0xffff0000u);
  }
  __device__ static __forceinline__ void unpack(const raw& r, float (&v)[N]) {
    pair(r.x, v[0], v[1]);
    pair(r.y, v[2], v[3]);
    pair(r.z, v[4], v[5]);
    pair(r.w, v[6], v[7]);
  }
  __device__ static __forceinline__ uint32_t round2(float lo, float hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p, const float (&v)[N]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(round2(v[0], v[1]), round2(v[2], v[3]),
                                              round2(v[4], v[5]), round2(v[6], v[7]));
  }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One channel a thread.
template <typename T>
struct Lane {
  using elem = T;
  static constexpr int N = 1;
  using raw = T;
  __device__ static __forceinline__ raw load(const T* p) { return *p; }
  __device__ static __forceinline__ void unpack(const raw& r, float (&v)[N]) { v[0] = to_f(r); }
  __device__ static __forceinline__ void store(T* p, const float (&v)[N]) {
    *p = from_f<T>(v[0]);
  }
};

template <typename IO, int CW>
__global__ void __launch_bounds__(kThreads) causal_conv1d_kernel(
    const typename IO::elem* __restrict__ x,   // [B, T, W]
    const typename IO::elem* __restrict__ w,   // [cw, W]
    typename IO::elem* __restrict__ y,         // [B, T, W]
    int T, int W, int groups, int rows, int runs, int B) {
  constexpr int N = IO::N;
  constexpr int Q = CW > 1 ? CW - 1 : 1;       // queue slots (unused at cw = 1)
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= groups) return;
  const int64_t c0 = static_cast<int64_t>(g) * N;
  float wk[CW][N];
#pragma unroll
  for (int k = 0; k < CW; ++k) IO::unpack(IO::load(w + k * static_cast<int64_t>(W) + c0), wk[k]);

  for (int r = blockIdx.y; r < B * runs; r += gridDim.y) {
    const int b = r / runs;
    const int t0 = (r - b * runs) * rows;
    const int t1 = min(t0 + rows, T);
    const int64_t base = static_cast<int64_t>(b) * T * W + c0;
    const typename IO::elem* xb = x + base;
    typename IO::elem* yb = y + base;
    // q[j] holds x[t - (cw - 1) + j] for the next row t: the halo first
    float q[Q][N];
#pragma unroll
    for (int j = 0; j < CW - 1; ++j) {
      const int t = t0 - (CW - 1) + j;
      if (t >= 0) {
        IO::unpack(IO::load(xb + static_cast<int64_t>(t) * W), q[j]);
      } else {
#pragma unroll
        for (int n = 0; n < N; ++n) q[j][n] = 0.f;
      }
    }
    for (int t = t0; t < t1; t += kUnroll) {
      typename IO::raw in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (t + u < t1) in[u] = IO::load(xb + static_cast<int64_t>(t + u) * W);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (t + u < t1) {
          float cur[N], acc[N];
          IO::unpack(in[u], cur);
#pragma unroll
          for (int n = 0; n < N; ++n) acc[n] = 0.f;
#pragma unroll
          for (int k = 0; k < CW - 1; ++k)
#pragma unroll
            for (int n = 0; n < N; ++n)
              acc[n] = __fadd_rn(acc[n], __fmul_rn(wk[k][n], q[k][n]));
#pragma unroll
          for (int n = 0; n < N; ++n)
            acc[n] = __fadd_rn(acc[n], __fmul_rn(wk[CW - 1][n], cur[n]));
          IO::store(yb + static_cast<int64_t>(t + u) * W, acc);
#pragma unroll
          for (int j = 0; j + 1 < CW - 1; ++j)
#pragma unroll
            for (int n = 0; n < N; ++n) q[j][n] = q[j + 1][n];
          if constexpr (CW > 1) {
#pragma unroll
            for (int n = 0; n < N; ++n) q[Q - 1][n] = cur[n];
          }
        }
      }
    }
  }
}

template <typename IO, int CW>
cudaError_t launch(const void* x, const void* w, void* y, int B, int T, int W,
                   int rows, cudaStream_t s) {
  using E = typename IO::elem;
  const int groups = W / IO::N;
  const long long runs = (T + rows - 1) / rows;
  const long long blocks_y = static_cast<long long>(B) * runs;
  dim3 grid(static_cast<unsigned>((groups + kThreads - 1) / kThreads),
            static_cast<unsigned>(blocks_y < 65535 ? blocks_y : 65535));
  causal_conv1d_kernel<IO, CW><<<grid, kThreads, 0, s>>>(
      static_cast<const E*>(x), static_cast<const E*>(w), static_cast<E*>(y), T, W,
      groups, rows, static_cast<int>(runs), B);
  return cudaGetLastError();
}

template <typename IO>
cudaError_t by_width(int cw, const void* x, const void* w, void* y, int B, int T, int W,
                     int rows, cudaStream_t s) {
  switch (cw) {
    case 1: return launch<IO, 1>(x, w, y, B, T, W, rows, s);
    case 2: return launch<IO, 2>(x, w, y, B, T, W, rows, s);
    case 3: return launch<IO, 3>(x, w, y, B, T, W, rows, s);
    case 4: return launch<IO, 4>(x, w, y, B, T, W, rows, s);
    case 5: return launch<IO, 5>(x, w, y, B, T, W, rows, s);
    case 6: return launch<IO, 6>(x, w, y, B, T, W, rows, s);
    case 7: return launch<IO, 7>(x, w, y, B, T, W, rows, s);
    case 8: return launch<IO, 8>(x, w, y, B, T, W, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// x, w, y on the current device, contiguous, of one type (bf16 when
// `bf16`, else f32); 1 <= cw <= 8; B * T < 2^31; rows >= 1 time rows a
// run.  `vector` asks for the 16-byte build, which needs W a multiple of
// the vector (4 f32, 8 bf16) and the three bases 16-byte aligned; it is
// refused (cudaErrorInvalidValue) otherwise.  Returns cudaGetLastError()
// after the launch.
extern "C" int rt_causal_conv1d(const void* x, const void* w, void* y,
                                long long B, long long T, long long W, int cw,
                                int bf16, int vector, int rows, void* stream) {
  if (B * T == 0 || W == 0) return 0;
  if (B * T > 0x7fffffffLL || W > 0x7fffffffLL || rows < 1 || cw < 1 || cw > kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = bf16 ? VecBF16::N : VecF32::N;
  if (vector && (W % vec != 0 || !aligned16(x) || !aligned16(w) || !aligned16(y)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), t = static_cast<int>(T), wd = static_cast<int>(W);
  cudaError_t err;
  if (vector)
    err = bf16 ? by_width<VecBF16>(cw, x, w, y, b, t, wd, rows, s)
               : by_width<VecF32>(cw, x, w, y, b, t, wd, rows, s);
  else
    err = bf16 ? by_width<Lane<__nv_bfloat16>>(cw, x, w, y, b, t, wd, rows, s)
               : by_width<Lane<float>>(cw, x, w, y, b, t, wd, rows, s);
  return static_cast<int>(err);
}
