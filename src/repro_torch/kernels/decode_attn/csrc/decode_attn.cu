// K7: flash decode attention, for Hopper (sm_90a), split over the sequence.
//
// Replaces the JAX package's kernels/decode_attn/decode_attn.py `_kernel`
// and `decode_attention_pallas` (the pl.pallas_call at decode_attn.py:84):
// one query token per sequence against a KV cache, masked by `lengths`,
// with an online softmax whose running max m, normalizer l and
// accumulator acc stay in f32; GQA by reading q as [K, G, hd], so each KV
// head's cache is read once for its G query heads; output 0 for length 0.
//
// The TPU kernel walks the cache in sequence blocks along an "arbitrary"
// grid axis, carrying m, l and acc in VMEM scratch from one grid step to
// the next.  Blocks here run in parallel with nothing carried between
// them, and one block a whole (batch row, KV head) would be B blocks on
// 132 SMs with MQA (K = 1), every latency exposed.  So the sequence is
// split over blocks (flash-decoding), in two kernels:
//
//   split:   grid (splits, K, B).  Block (s, kh, b) takes positions
//            [s * chunk, min((s + 1) * chunk, len)) of row b, KV head kh,
//            `bs` at a time, and writes its partial (m, l, acc[G, hd]) in
//            f32; a block whose range starts at or past the row's length
//            returns at once (it contributes nothing).  The wrapper picks
//            chunk (a multiple of bs) so that the grid covers the card's
//            SMs about twice over (decode_attn.py split_plan).  Per tile:
//              0. the key and value rows of the next tile are copied into
//                 shared memory with cp.async, 16 bytes (8 bf16) a copy,
//                 double-buffered, so the copy overlaps this tile's work;
//              1. logits: a warp takes 2 positions at once, each lane
//                 holding 8 cells of each key row, so each query row (16
//                 KB of shared memory for G = 16, hd = 256) is read once
//                 for both (4 positions at once took 176 registers, one
//                 block an SM, and ran slower on the card); the 16
//                 partial dot products of a position (16 query rows at a
//                 time) are summed over the warp by a reduce-scatter (16
//                 shuffles, not 16 x 5), after which lane 2g holds row g's
//                 logit;
//              2. online-softmax update, one warp per query row;
//              3. acc = acc * corr + p . v in registers: warp w owns query
//                 rows w, w + 8, ... (G <= 32), lane l cells 8l .. 8l+7.
//   combine: grid (G, K, B), one thread per cell of hd: m = max m_i,
//            l = sum l_i e^{m_i - m}, o = sum acc_i e^{m_i - m} / l over
//            the splits i < ceil(len / chunk), the weights e^{m_i - m}
//            computed once a block in shared memory; no split (length 0)
//            gives 0.
//
// Bound: device-memory bytes (K and V read once up to each row's length;
// the partials, G * hd f32 a working block, stay in L2 between the two
// launches).  The products are the kernel's own (no library call).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                 // cells of a row a lane holds
constexpr int kMaxHd = 32 * kVec;       // 256
constexpr int kMaxGW = 4;               // query rows a warp accumulates
constexpr int kMaxG = kMaxGW * kWarps;  // 32
constexpr int kRed = 16;                // query rows reduced together (step 1)
constexpr int kPos = 2;                 // positions a warp takes together (step 1)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename scalar_t> __device__ __forceinline__ scalar_t from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 cells at p (16-byte aligned), as f32
__device__ __forceinline__ void load8(const float* p, float (&out)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&out)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One step of a warp reduce-scatter: v[0 .. 2N) becomes v[0 .. N), each
// value summed with lane ^ M's; the lane keeps the upper half when bit M
// of its index is set.
template <int N, int M>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[kRed], int lane) {
  const bool up = lane & M;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? v[i] : v[i + N];
    const float keep = up ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// The sums over the warp of the kRed = 16 values v of every lane: lanes
// 2g and 2g + 1 return the sum of v[g].
__device__ __forceinline__ float reduce_scatter16(float (&v)[kRed], int lane) {
  reduce_scatter_step<8, 16>(v, lane);
  reduce_scatter_step<4, 8>(v, lane);
  reduce_scatter_step<2, 4>(v, lane);
  reduce_scatter_step<1, 2>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename scalar_t>
__global__ void __launch_bounds__(kThreads) decode_attn_split_kernel(
    const scalar_t* __restrict__ q,      // [B, K, G, hd]
    const scalar_t* __restrict__ k,      // [B, S, K, hd]
    const scalar_t* __restrict__ v,      // [B, S, K, hd]
    const int* __restrict__ lengths,     // [B]
    float* __restrict__ part_acc,        // [B, K, splits, G, hd]
    float* __restrict__ part_ml,         // [B, K, splits, G, 2]: m, l
    int S, int K, int G, int hd, int bs, int chunk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* kv = reinterpret_cast<scalar_t*>(smem_raw);    // [2][k, v][bs, hd]
  // [G, hd] query rows, each row as two halves [2][hd / 8][4]: cell
  // 8l + 4h + i at h * hd / 2 + 4l + i, so that lane l's two float4s of
  // a row are conflict-free reads for the warp
  float* q_s = reinterpret_cast<float*>(kv + 4 * bs * hd);
  float* p_s = q_s + G * hd;         // [G, bs] logits, then probabilities
  float* m_s = p_s + G * bs;         // [G] running max
  float* l_s = m_s + G;              // [G] normalizer
  float* c_s = l_s + G;              // [G] this tile's correction

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lengths[b], 0), S);
  const int s0 = split * chunk;
  if (s0 >= len) return;             // past the row's length: no partial
  const int n = min(s0 + chunk, len) - s0;
  const int n_tiles = (n + bs - 1) / bs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool lane_on = lane * kVec < hd;
  const int64_t row = static_cast<int64_t>(K) * hd;       // one cache position
  const scalar_t* kb = k + static_cast<int64_t>(b) * S * row + static_cast<int64_t>(kh) * hd;
  const scalar_t* vb = v + static_cast<int64_t>(b) * S * row + static_cast<int64_t>(kh) * hd;
  constexpr int kGran = 16 / sizeof(scalar_t);            // cells of one copy
  const int gpr = hd / kGran;                             // copies a row

  // 0. tile t's key and value rows into stage t & 1, as one cp.async group
  auto issue = [&](int t) {
    const int p0 = s0 + t * bs, rows = min(bs, n - t * bs);
    scalar_t* ks = kv + (t & 1) * 2 * bs * hd;
    scalar_t* vs = ks + bs * hd;
    for (int e = tid; e < rows * gpr; e += kThreads) {
      const int j = e / gpr, c = (e - j * gpr) * kGran;
      const int64_t off = static_cast<int64_t>(p0 + j) * row + c;
      cp_async16(ks + j * hd + c, kb + off);
      cp_async16(vs + j * hd + c, vb + off);
    }
    cp_async_commit();
  };
  issue(0);

  const int64_t head = (static_cast<int64_t>(b) * K + kh) * G * hd;
  for (int e = tid * kVec; e < G * hd; e += kThreads * kVec) {   // 8 cells a load
    float qv[kVec];
    load8(q + head + e, qv);
    const int g = e / hd, l = (e - g * hd) / kVec;
    float* row = q_s + g * hd + 4 * l;
    *reinterpret_cast<float4*>(row) = make_float4(qv[0], qv[1], qv[2], qv[3]);
    *reinterpret_cast<float4*>(row + hd / 2) = make_float4(qv[4], qv[5], qv[6], qv[7]);
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  float acc[kMaxGW][kVec];
#pragma unroll
  for (int r = 0; r < kMaxGW; ++r)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      issue(t + 1);
      cp_async_wait<1>();            // tile t landed; t + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int rows = min(bs, n - t * bs);
    const scalar_t* ks = kv + (t & 1) * 2 * bs * hd;
    const scalar_t* vs = ks + bs * hd;
    // 1. logits of the G query rows against the tile's positions: warp w
    //    takes positions j0 + kWarps * p, p < kPos
    for (int j0 = warp; j0 < rows; j0 += kWarps * kPos) {
      float kr[kPos][kVec];
#pragma unroll
      for (int p = 0; p < kPos; ++p) {
        const int j = j0 + kWarps * p;
        if (lane_on && j < rows) {
          load8(ks + j * hd + lane * kVec, kr[p]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) kr[p][e] = 0.f;
        }
      }
      for (int g0 = 0; g0 < G; g0 += kRed) {
        float part[kPos][kRed];
#pragma unroll
        for (int u = 0; u < kRed; ++u) {
          float qv[kVec] = {};
          if (g0 + u < G && lane_on) {
            const float* row = q_s + (g0 + u) * hd + 4 * lane;
            const float4 a = *reinterpret_cast<const float4*>(row);
            const float4 c = *reinterpret_cast<const float4*>(row + hd / 2);
            qv[0] = a.x; qv[1] = a.y; qv[2] = a.z; qv[3] = a.w;
            qv[4] = c.x; qv[5] = c.y; qv[6] = c.z; qv[7] = c.w;
          }
#pragma unroll
          for (int p = 0; p < kPos; ++p) {
            part[p][u] = 0.f;
#pragma unroll
            for (int e = 0; e < kVec; ++e) part[p][u] += qv[e] * kr[p][e];
          }
        }
#pragma unroll
        for (int p = 0; p < kPos; ++p) {
          const float logit = reduce_scatter16(part[p], lane);
          const int j = j0 + kWarps * p, g = g0 + (lane >> 1);
          if (!(lane & 1) && g < G && j < rows) p_s[g * bs + j] = logit * scale;
        }
      }
    }
    __syncthreads();
    // 2. online-softmax update, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * bs;
      float mx = -INFINITY;
      for (int j = lane; j < rows; j += 32) mx = fmaxf(mx, pg[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
      for (int j = lane; j < rows; j += 32) {
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
#pragma unroll
    for (int r = 0; r < kMaxGW; ++r) {
      const int g = warp + kWarps * r;
      if (g < G) {
        const float c = c_s[g];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[r][e] *= c;
      }
    }
    if (lane_on) {
      for (int j = 0; j < rows; ++j) {
        float vv[kVec];
        load8(vs + j * hd + lane * kVec, vv);
#pragma unroll
        for (int r = 0; r < kMaxGW; ++r) {
          const int g = warp + kWarps * r;
          if (g < G) {
            const float p = p_s[g * bs + j];
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[r][e] += p * vv[e];
          }
        }
      }
    }
    __syncthreads();                 // stage t & 1 and p_s free for reuse
  }

  const int64_t part = ((static_cast<int64_t>(b) * K + kh) * gridDim.x + split) * G;
#pragma unroll
  for (int r = 0; r < kMaxGW; ++r) {
    const int g = warp + kWarps * r;
    if (g < G && lane_on) {
      float* dst = part_acc + (part + g) * hd + lane * kVec;
      *reinterpret_cast<float4*>(dst) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
  for (int g = tid; g < G; g += kThreads) {
    part_ml[2 * (part + g)] = m_s[g];
    part_ml[2 * (part + g) + 1] = l_s[g];
  }
}

template <typename scalar_t>
__global__ void __launch_bounds__(kMaxHd) decode_attn_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ lengths, scalar_t* __restrict__ o,   // o [B, K, G, hd]
    int S, int K, int G, int hd, int splits, int chunk) {
  extern __shared__ float w_s[];     // [splits]: e^{m_i - m}
  __shared__ float red[kMaxHd / 32];
  const int g = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), S);
  const int n = min(splits, (len + chunk - 1) / chunk);   // splits with a partial
  const int64_t part = (static_cast<int64_t>(b) * K + kh) * splits * G + g;
  // the largest m_i: each thread over its splits, then the block
  float m = -INFINITY;
  for (int i = tid; i < n; i += blockDim.x)
    m = fmaxf(m, part_ml[2 * (part + static_cast<int64_t>(i) * G)]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = -INFINITY;
  for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) m = fmaxf(m, red[w]);
  const float m_safe = isfinite(m) ? m : 0.f;
  float l_part = 0.f;
  for (int i = tid; i < n; i += blockDim.x) {
    const int64_t pi = part + static_cast<int64_t>(i) * G;
    const float mi = part_ml[2 * pi];
    const float w = isfinite(mi) ? expf(mi - m_safe) : 0.f;
    w_s[i] = w;
    l_part += part_ml[2 * pi + 1] * w;
  }
  l_part = warp_sum(l_part);
  __syncthreads();                   // red[] read above; w_s written
  if (lane == 0) red[warp] = l_part;
  __syncthreads();
  float l = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) l += red[w];
  for (int d = tid; d < hd; d += blockDim.x) {
    float a = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) a += part_acc[(part + static_cast<int64_t>(i) * G) * hd + d] * w_s[i];
    o[((static_cast<int64_t>(b) * K + kh) * G + g) * hd + d] = from_f<scalar_t>(a / fmaxf(l, 1e-30f));
  }
}

// Bytes of dynamic shared memory one split block needs: the query rows,
// the tile's logits and m, l, corr in f32, and two stages of the tile's
// key and value rows in the input type.
template <typename scalar_t>
size_t smem_bytes(int G, int hd, int bs) {
  return static_cast<size_t>(G * hd + G * bs + 3 * G) * sizeof(float) +
         static_cast<size_t>(4 * bs * hd) * sizeof(scalar_t);
}

template <typename scalar_t>
int launch_split(const void* q, const void* k, const void* v, const int* lengths,
                 float* part_acc, float* part_ml, int B, int S, int K, int G, int hd,
                 int bs, int splits, int chunk, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<scalar_t>(G, hd, bs);
  auto kern = decode_attn_split_kernel<scalar_t>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(splits, K, B), kThreads, smem, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
      static_cast<const scalar_t*>(v), lengths, part_acc, part_ml, S, K, G, hd, bs, chunk,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Split pass.  q [B, K*G, hd], k and v [B, S, K, hd]: on the current
// device, contiguous, 16-byte aligned, of one type (bf16 when `bf16`, else
// f32), hd a multiple of 8 and at most 256, G at most 32; lengths [B]
// int32; part_acc [B, K, splits, G, hd] and part_ml [B, K, splits, G, 2]
// f32.  Returns cudaGetLastError() after the launch.
extern "C" int rt_decode_attn_split(const void* q, const void* k, const void* v,
                                    const void* lengths, void* part_acc, void* part_ml,
                                    int B, int S, int K, int G, int hd, int bs, int splits,
                                    int chunk, float scale, int bf16, void* stream) {
  if (B == 0 || K == 0 || G == 0 || splits == 0) return 0;
  if (hd > kMaxHd || hd < 1 || hd % kVec || G > kMaxG || bs < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sc = scale;
  return bf16 ? launch_split<__nv_bfloat16>(q, k, v, len, pa, pm, B, S, K, G, hd, bs, splits,
                                            chunk, sc, s)
              : launch_split<float>(q, k, v, len, pa, pm, B, S, K, G, hd, bs, splits, chunk,
                                    sc, s);
}

// Combine pass: the split pass's partials into o [B, K*G, hd] (the input
// type).  Returns cudaGetLastError() after the launch.
extern "C" int rt_decode_attn_combine(const void* part_acc, const void* part_ml,
                                      const void* lengths, void* o, int B, int S, int K,
                                      int G, int hd, int splits, int chunk, int bf16,
                                      void* stream) {
  if (B == 0 || K == 0 || G == 0) return 0;
  if (hd > kMaxHd || hd < 1 || splits < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* pa = static_cast<const float*>(part_acc);
  const float* pm = static_cast<const float*>(part_ml);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(G, K, B), threads((hd + 31) / 32 * 32);
  const size_t smem = sizeof(float) * splits;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    decode_attn_combine_kernel<__nv_bfloat16><<<grid, threads, smem, s>>>(
        pa, pm, len, static_cast<__nv_bfloat16*>(o), S, K, G, hd, splits, chunk);
  else
    decode_attn_combine_kernel<float><<<grid, threads, smem, s>>>(
        pa, pm, len, static_cast<float*>(o), S, K, G, hd, splits, chunk);
  return static_cast<int>(cudaGetLastError());
}
