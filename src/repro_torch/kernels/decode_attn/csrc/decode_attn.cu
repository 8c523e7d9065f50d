// K7: flash decode attention, for Hopper (sm_90a).
//
// Replaces the JAX package's kernels/decode_attn/decode_attn.py `_kernel`
// and `decode_attention_pallas` (the pl.pallas_call at decode_attn.py:84):
// one query token per sequence against a KV cache, masked by `lengths`,
// with an online softmax whose running max m, normalizer l and
// accumulator acc stay in f32; GQA by reading q as [K, G, hd], so each KV
// head's cache is read once for its G query heads.
//
// The TPU kernel walks the cache in sequence blocks along an "arbitrary"
// grid axis, carrying m, l and acc in VMEM scratch from one grid step to
// the next.  Blocks here run in parallel with nothing carried between
// them, so one thread block owns one (batch row, KV head) and walks its
// cache in a loop, `bs` positions at a time, with m, l, acc and the G
// query rows in shared memory.  The block has 1024 threads: with one
// block a row on the card, its 32 warps are all that hides the latency
// of each step (256 threads ran 1.6x slower at RecurrentGemma's shape):
//   0. the block's `bs` key and value rows are copied into shared memory
//      by all threads at once (contiguous along hd), so the steps below
//      wait on one round of device-memory latency a block, not one a
//      position (reading V from global memory inside step 3 made the
//      first version 15x slower than its plain version);
//   1. logits: one warp per cache position; the lanes hold the key row
//      (hd <= 256: up to 8 values a lane) and take q . k for 4 query rows
//      at a time with independent warp-shuffle reductions over hd;
//   2. softmax update: one warp per query row; the block's max and sum
//      by warp reductions, the correction exp(m_prev - m_new);
//   3. acc[g, d] = acc * corr + sum_j p[g, j] v[j, d], one thread per
//      (g, d) element.
// Positions at or past lengths[b] are never read: the loop stops at the
// length (the mask), so a block is never fully masked; the guards for a
// non-finite running max keep length 0 well defined (output 0, as on the
// TPU).  The products are the kernel's own (no library call).
//
// Bound: device-memory bytes (K and V read once up to each row's length).
// With MQA (K = 1) the grid is only B blocks on 132 SMs, so it runs far
// from that bound; splitting the sequence over blocks with a combine pass
// is the redesign for later.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename scalar_t> __device__ __forceinline__ scalar_t from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 256;
constexpr int kPerLane = kMaxHd / 32;
constexpr int kRows = 4;             // query rows reduced together (step 1)

template <typename scalar_t>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(
    const scalar_t* __restrict__ q,      // [B, K, G, hd]
    const scalar_t* __restrict__ k,      // [B, S, K, hd]
    const scalar_t* __restrict__ v,      // [B, S, K, hd]
    const int* __restrict__ lengths,     // [B]
    scalar_t* __restrict__ o,            // [B, K, G, hd]
    int S, int K, int G, int hd, int bs, float scale) {
  extern __shared__ float smem[];
  const int Ghd = G * hd;
  float* q_s = smem;                 // [G, hd] query rows
  float* acc_s = q_s + Ghd;          // [G, hd] accumulator
  float* p_s = acc_s + Ghd;          // [G, bs] logits, then probabilities
  float* m_s = p_s + G * bs;         // [G] running max
  float* l_s = m_s + G;              // [G] normalizer
  float* c_s = l_s + G;              // [G] this block's correction
  scalar_t* k_t = reinterpret_cast<scalar_t*>(c_s + G);   // [bs, hd] keys
  scalar_t* v_t = k_t + bs * hd;                          // [bs, hd] values

  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t head = (static_cast<int64_t>(b) * K + kh) * Ghd;
  for (int e = tid; e < Ghd; e += kThreads) {
    q_s[e] = to_f(q[head + e]);
    acc_s[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int len = min(max(lengths[b], 0), S);
  const int64_t row = static_cast<int64_t>(K) * hd;       // one cache position
  const scalar_t* kb = k + static_cast<int64_t>(b) * S * row + static_cast<int64_t>(kh) * hd;
  const scalar_t* vb = v + static_cast<int64_t>(b) * S * row + static_cast<int64_t>(kh) * hd;

  for (int s0 = 0; s0 < len; s0 += bs) {
    const int n = min(bs, len - s0);
    // 0. stage the block's key and value rows
    for (int e = tid; e < n * hd; e += kThreads) {
      const int j = e / hd, d = e - j * hd;
      const int64_t off = (s0 + j) * row + d;
      k_t[e] = kb[off];
      v_t[e] = vb[off];
    }
    __syncthreads();
    // 1. logits of the G query rows against positions s0 .. s0 + n - 1
    for (int j = warp; j < n; j += kWarps) {
      const scalar_t* kr = k_t + j * hd;
      float kreg[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int d = lane + 32 * i;
        kreg[i] = d < hd ? to_f(kr[d]) : 0.f;
      }
      for (int g0 = 0; g0 < G; g0 += kRows) {
        float part[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          part[u] = 0.f;
          if (g0 + u < G) {
            const float* qg = q_s + (g0 + u) * hd;
#pragma unroll
            for (int i = 0; i < kPerLane; ++i) {
              const int d = lane + 32 * i;
              if (d < hd) part[u] += qg[d] * kreg[i];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) part[u] = warp_sum(part[u]);
        if (lane == 0) {
#pragma unroll
          for (int u = 0; u < kRows; ++u)
            if (g0 + u < G) p_s[(g0 + u) * bs + j] = part[u] * scale;
        }
      }
    }
    __syncthreads();
    // 2. online-softmax update, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * bs;
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, pg[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(pg[j] - m_safe);
        pg[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // 3. acc = acc * corr + p . v
    for (int e = tid; e < Ghd; e += kThreads) {
      const int g = e / hd, d = e - g * hd;
      const float* pg = p_s + g * bs;
      float a = acc_s[e] * c_s[g];
#pragma unroll 4
      for (int j = 0; j < n; ++j) a += pg[j] * to_f(v_t[j * hd + d]);
      acc_s[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < Ghd; e += kThreads)
    o[head + e] = from_f<scalar_t>(acc_s[e] / fmaxf(l_s[e / hd], 1e-30f));
}

// Bytes of dynamic shared memory one block needs: q rows, acc, the
// block's logits and m, l, corr in f32, the staged key and value rows in
// the input type.
template <typename scalar_t>
size_t smem_bytes(int G, int hd, int bs) {
  return static_cast<size_t>(2 * G * hd + G * bs + 3 * G) * sizeof(float) +
         static_cast<size_t>(2 * bs * hd) * sizeof(scalar_t);
}

template <typename scalar_t>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* o,
           int B, int S, int K, int G, int hd, int bs, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<scalar_t>(G, hd, bs);
  auto kern = decode_attn_kernel<scalar_t>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(K, B), kThreads, smem, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
      static_cast<const scalar_t*>(v), lengths, static_cast<scalar_t*>(o),
      S, K, G, hd, bs, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, K*G, hd], k and v [B, S, K, hd], o like q: on the current device,
// contiguous, of one type (bf16 when `bf16`, else f32); lengths [B] int32.
// hd <= 256.  Returns cudaGetLastError() after the launch.
extern "C" int rt_decode_attn(const void* q, const void* k, const void* v,
                              const void* lengths, void* o, int B, int S, int K,
                              int G, int hd, int bs, float scale, int bf16,
                              void* stream) {
  if (B == 0 || K == 0 || G == 0) return 0;
  if (hd > kMaxHd || hd < 1 || bs < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, len, o, B, S, K, G, hd, bs, scale, s)
              : launch<float>(q, k, v, len, o, B, S, K, G, hd, bs, scale, s);
}
