// K6: causal depthwise conv1d with zero history, for Hopper (sm_90a).
//
// Replaces the JAX package's kernels/conv1d/conv1d.py `_kernel` and
// `causal_conv1d_pallas` (the pl.pallas_call at conv1d.py:50):
//
//     y[b, t, c] = sum_{k < cw} w[k, c] * x[b, t - cw + 1 + k, c],  x = 0 below t = 0.
//
// The TPU kernel blocks the time axis and hands each block the previous
// one as its causal halo, because its grid runs in order through VMEM.
// Here one thread computes one output point: a block covers 256 channels
// of one (b, t) row, so a warp's loads of x and w and its store of y are
// contiguous, and the cw - 1 earlier rows it reads are the rows other
// blocks read as their own (from L1/L2).  Rows are walked with a
// grid-stride loop over b * T.
//
// Numerics: products and sums in f32, each rounded on its own (no FMA
// contraction), in tap order, then one rounding to the output type: the
// plain version (ref.causal_conv1d_ref) does the same operations, so the
// two agree bit for bit.
//
// Bound: device-memory bytes (x read once, w once, y written once).  On
// the serving path it runs at [B, 4, 4096] once per recurrent layer and
// decode step, where one launch takes longer than its bytes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename scalar_t> __device__ __forceinline__ scalar_t from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kThreads = 256;

template <typename scalar_t>
__global__ void __launch_bounds__(kThreads) causal_conv1d_kernel(
    const scalar_t* __restrict__ x,    // [B, T, W]
    const scalar_t* __restrict__ w,    // [cw, W]
    scalar_t* __restrict__ y,          // [B, T, W]
    int rows, int T, int W, int cw) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= W) return;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int t = r % T;
    const int64_t i = static_cast<int64_t>(r) * W + c;
    const scalar_t* xr = x + i;
    float acc = 0.f;
    for (int k = 0; k < cw; ++k) {
      const int back = cw - 1 - k;       // rows before t
      if (t >= back)
        acc = __fadd_rn(acc, __fmul_rn(to_f(w[static_cast<int64_t>(k) * W + c]),
                                       to_f(xr[-static_cast<int64_t>(back) * W])));
    }
    y[i] = from_f<scalar_t>(acc);
  }
}

}  // namespace

// x, w, y on the current device, contiguous, of one type (bf16 when
// `bf16`, else f32); B * T < 2^31.  Returns cudaGetLastError() after the
// launch.
extern "C" int rt_causal_conv1d(const void* x, const void* w, void* y,
                                long long B, long long T, long long W,
                                int cw, int bf16, void* stream) {
  const long long rows = B * T;
  if (rows == 0 || W == 0) return 0;
  if (rows > 0x7fffffffLL || W > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads),
            static_cast<unsigned>(rows < 65535 ? rows : 65535));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    causal_conv1d_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), static_cast<int>(rows), static_cast<int>(T),
        static_cast<int>(W), cw);
  else
    causal_conv1d_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), static_cast<int>(rows), static_cast<int>(T),
        static_cast<int>(W), cw);
  return static_cast<int>(cudaGetLastError());
}
