// K3 — in-kernel temporal blocking: RT_K leapfrog sub-steps per launch, as
// RT_K pipelined 2.5D stages along axis 0 (every template).
//
// Replaces the JAX package's kernels/stencil/codegen.py _make_body_temporal
// (PallasPlan._call_for with time_block > 1, destinations from
// PallasPlan.make_spares).  The TPU body keeps both swap frames of the
// whole block plus k·h per side resident; on this card that frame does not
// fit (24x24x48 floats per frame for star3d4r at k=2), so the sub-steps
// stream instead.
//
// Fields: F_{-2} and F_{-1} are the buffers named swap[0] (RT_GW, written)
// and swap[1] (RT_GO, read with taps of reach h = grid_h*(RT_GO)).
// Sub-step j computes F_j from F_{j-1}'s taps and F_{j-2}'s center (the
// written grid is tapped at the center only) plus the other grids, read at
// the point from device memory.  F_j stands for buffer RT_GW when j is
// even and RT_GO when odd: outside the interior it holds that buffer's
// halo, which is what the per-step loop leaves there (the TPU body's
// _valid_mask re-imposition).  Only cells within the tap reach
// [-h, R + h) are ever read for an interior point; cells beyond it are 0.
//
// A thread block covers an RT_TB1 x RT_TB2 tile and walks a chunk
// [x0, x1) of RT_TB0 planes.  Ring r (r = -1 .. RT_K-2) holds 2*h0+1
// planes of F_r over the tile widened by (RT_K-1-r)*h per side, in shared
// memory; ring -1 is loaded from RT_GO.  At tick t stage j computes plane
// t - j*h0 of F_j over the tile widened by (RT_K-1-j)*h (interior cells
// from the rings, the others from the buffer F_j stands for): stage j
// lags stage j-1 by h0 planes, so ring j-1 holds the planes j needs and
// ring j-2 still holds F_{j-2} at the center.  Plane p lives in slot
// (p - x0 + RT_K*h0) mod (2*h0+1) of every ring.  Stage RT_K-2 writes its
// tile's F_{RT_K-2} and stage RT_K-1 its F_{RT_K-1} into the spare buffer
// of the role they stand for (dst[j % 2]): K3 never writes a buffer it
// reads, since neighbouring blocks read k*h cells into this tile while
// it runs.
//
// Bound: device-memory bytes.  Per launch the kernel must read each input
// grid once and write both swap buffers once: star3d4r at k=2 moves 1.5
// grid passes per step where K1 moves 2.  The design pays for that with
// redundant work on the widened stages ((8+8)x(32+8) cells of F_0 per
// 8x32 tile at h=4, k=2) and with the widened ring -1 loads, which L2
// serves; the rings take 64.5 KB at 8x32, k=2, h=4.  The rings hold f32
// whatever the grids' type: a sub-step's values reach the next one
// unrounded, and only the spares' stores round.
#include "common.cuh"

constexpr int kH0 = grid_h0(RT_GO), kH1 = grid_h1(RT_GO), kH2 = grid_h2(RT_GO);
constexpr int kNR = 2 * kH0 + 1;
constexpr int kThreads = RT_TB1 * RT_TB2;

__host__ __device__ constexpr int ring_w1(int r) { return RT_TB1 + 2 * (RT_K - 1 - r) * kH1; }
__host__ __device__ constexpr int ring_w2(int r) { return RT_TB2 + 2 * (RT_K - 1 - r) * kH2; }
__host__ __device__ constexpr int ring_off(int r) {
  return r <= -1 ? 0 : ring_off(r - 1) + kNR * ring_w1(r - 1) * ring_w2(r - 1);
}
constexpr int kSmemFloats = ring_off(RT_K - 1);

struct TParams {
  Params p;
  elem_t* dst[2];         // spares standing for RT_GW (0) and RT_GO (1)
};

// meta as rt_params, followed by the two spare pointers
static inline TParams rt_tparams(const void* meta, const void* scal) {
  TParams t;
  t.p = rt_params(meta, scal);
  const long long* m = static_cast<const long long*>(meta);
  t.dst[0] = reinterpret_cast<elem_t*>(m[4 * RT_NG + 3]);
  t.dst[1] = reinterpret_cast<elem_t*>(m[4 * RT_NG + 4]);
  return t;
}

__device__ __forceinline__ long long index_of(const Params& p, int g, int x, int y, int z) {
  return p.org[g] + static_cast<long long>(x) * p.sx[g] + static_cast<long long>(y) * p.sy[g] + z;
}
__device__ __forceinline__ bool in_reach(const Params& p, int x, int y, int z) {
  return x >= -kH0 && x < p.R0 + kH0 && y >= -kH1 && y < p.R1 + kH1 && z >= -kH2 &&
         z < p.R2 + kH2;
}
__device__ __forceinline__ bool in_interior(const Params& p, int x, int y, int z) {
  return x >= 0 && x < p.R0 && y >= 0 && y < p.R1 && z >= 0 && z < p.R2;
}
__device__ __forceinline__ int slot_of(int x, int x0) { return (x - x0 + RT_K * kH0) % kNR; }

// Plane x of the read buffer RT_GO into ring -1.
__device__ __forceinline__ void load_input(const Params& p, float* smem, int x, int x0,
                                           int y0, int z0) {
  constexpr int W1 = ring_w1(-1), W2 = ring_w2(-1);
  float* dst = smem + ring_off(-1) + slot_of(x, x0) * (W1 * W2);
  for (int i = threadIdx.y * RT_TB2 + threadIdx.x; i < W1 * W2; i += kThreads) {
    const int y = y0 - RT_K * kH1 + i / W2, z = z0 - RT_K * kH2 + i % W2;
    dst[i] = in_reach(p, x, y, z) ? ld_elem(p.g[RT_GO] + index_of(p, RT_GO, x, y, z)) : 0.0f;
  }
}

// Tap reader of stage J at cell (cy, cz) of ring J's frame, point (x, y, z).
template <int J>
struct StageReader {
  const Params& p;
  const float* smem;
  int x, slot, cy, cz, y, z;   // slot: of plane x
  template <int G>
  __device__ __forceinline__ float at(int dx, int dy, int dz) const {
    if constexpr (G == RT_GO) {            // F_{J-1}, ring J-1
      constexpr int W1 = ring_w1(J - 1), W2 = ring_w2(J - 1);
      int s = slot + dx;                   // in [-h0, kNR + h0)
      s += s < 0 ? kNR : 0;
      s -= s >= kNR ? kNR : 0;
      return smem[ring_off(J - 1) + s * (W1 * W2) + (cy + kH1 + dy) * W2 + (cz + kH2 + dz)];
    } else if constexpr (G == RT_GW) {     // F_{J-2}, center only
      if constexpr (J == 0) {
        return ld_elem(p.g[G] + index_of(p, G, x, y, z));
      } else {
        constexpr int W1 = ring_w1(J - 2), W2 = ring_w2(J - 2);
        return smem[ring_off(J - 2) + slot * (W1 * W2) + (cy + 2 * kH1) * W2 + (cz + 2 * kH2)];
      }
    } else {                               // a grid the steps do not change
      return ld_elem(p.g[G] + index_of(p, G, x + dx, y + dy, z + dz));
    }
  }
};

// Stage J at tick t: plane t - J*h0 of F_J over the tile widened by
// (RT_K-1-J)*h, into ring J (J < RT_K-1) and, for the tile's own points,
// into the spare of the role F_J stands for (J >= RT_K-2).
template <int J>
__device__ __forceinline__ void stage(const TParams& t, float* smem, int tick, int x0,
                                      int x1, int y0, int z0) {
  const Params& p = t.p;
  constexpr int E0 = (RT_K - 1 - J) * kH0, E1 = (RT_K - 1 - J) * kH1,
                E2 = (RT_K - 1 - J) * kH2;
  constexpr int W1 = RT_TB1 + 2 * E1, W2 = RT_TB2 + 2 * E2;
  constexpr int role = J % 2 == 0 ? RT_GW : RT_GO;
  const int x = tick - J * kH0;
  if (x < x0 - E0 || x >= x1 + E0) return;     // the same for the whole block
  const int slot = slot_of(x, x0);
  for (int i = threadIdx.y * RT_TB2 + threadIdx.x; i < W1 * W2; i += kThreads) {
    const int cy = i / W2, cz = i % W2;
    const int y = y0 - E1 + cy, z = z0 - E2 + cz;
    float v = 0.0f;
    if (in_interior(p, x, y, z)) {
      const StageReader<J> rd{p, smem, x, slot, cy, cz, y, z};
      float out[RT_NO];
      stencil_point(rd, p.s, out);
      v = out[0];
      if constexpr (J >= RT_K - 2) {
        if (x >= x0 && x < x1 && cy >= E1 && cy < E1 + RT_TB1 && cz >= E2 &&
            cz < E2 + RT_TB2)
          st_elem(t.dst[J % 2] + index_of(p, role, x, y, z), v);
      }
    } else if (in_reach(p, x, y, z)) {
      v = ld_elem(p.g[role] + index_of(p, role, x, y, z));
    }
    if constexpr (J < RT_K - 1) smem[ring_off(J) + slot * (W1 * W2) + i] = v;
  }
}

template <int J>
__device__ __forceinline__ void stages(const TParams& t, float* smem, int tick, int x0,
                                       int x1, int y0, int z0) {
  if constexpr (J < RT_K) {
    stage<J>(t, smem, tick, x0, x1, y0, z0);
    __syncthreads();   // ring J complete before stage J+1 reads it
    stages<J + 1>(t, smem, tick, x0, x1, y0, z0);
  }
}

__global__ void __launch_bounds__(RT_TB1 * RT_TB2)
temporal_step_kernel(const TParams t) {
  extern __shared__ float smem[];
  const int z0 = blockIdx.x * RT_TB2, y0 = blockIdx.y * RT_TB1;
  const int x0 = blockIdx.z * RT_TB0;
  const int x1 = min(x0 + RT_TB0, t.p.R0);
  for (int q = 0; q < 2 * kH0; ++q)
    load_input(t.p, smem, x0 - RT_K * kH0 + q, x0, y0, z0);
  for (int tick = x0 - (RT_K - 1) * kH0; tick < x1 + (RT_K - 1) * kH0; ++tick) {
    load_input(t.p, smem, tick + kH0, x0, y0, z0);
    __syncthreads();
    stages<0>(t, smem, tick, x0, x1, y0, z0);
  }
}

extern "C" int rt_temporal_step(const void* meta, const void* scal, void* stream) {
  const TParams t = rt_tparams(meta, scal);
  const size_t smem_bytes = sizeof(float) * kSmemFloats;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        temporal_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 threads(RT_TB2, RT_TB1, 1);
  const dim3 blocks((t.p.R2 + RT_TB2 - 1) / RT_TB2, (t.p.R1 + RT_TB1 - 1) / RT_TB1,
                    (t.p.R0 + RT_TB0 - 1) / RT_TB0);
  temporal_step_kernel<<<blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
