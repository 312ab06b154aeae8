// K2: one-hot grouped masked sum, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel yugabyte_db_tpu/ops/pallas_scan.py
// `_grouped_kernel` (launched by `grouped_sum_pallas`), which computes
// per 4096-row block  one_hot(int32(gid))^T . (value * mask)  as an MXU
// matmul and emits one [G] partial row per block.
//
// Bound on an H100: bytes.  Three f32 inputs are read once (12 B/row);
// the [grid, G] partials are small.  One CTA per 4096-row block, 256
// threads, each loading 16 rows as four float4s per lane.  Two bodies,
// picked by G on the host side of the C entry point:
//
// - small G (<= kSmallG, the main path's G = 6): the one-hot product
//   itself.  Each thread keeps float acc[GB] in registers (GB, a power
//   of two >= G, is a template parameter) and adds v * (gid == g ? 1 : 0)
//   to every group: G multiply-adds a row, nothing next to 12 B of HBM
//   traffic, and no atomics.  The product gives the matmul's
//   inf * 0 = NaN in the other groups (in all of them for an
//   out-of-range gid) with no bookkeeping; the build has no
//   --use_fast_math, so x * 0.f is not folded.  Warp shuffles reduce
//   each group, then a [warps][GB] shared combine writes the row.
// - large G (up to 4096): a shared-memory [G] histogram fed by shared
//   atomics (a one-hot product would cost G operations a row).  The
//   NaN spread is kept by counting non-finite rows per group and in
//   total: a group's partial is NaN when some other group's row, or an
//   out-of-range row, was non-finite.
//
// The order of f32 additions differs from the reference's (and, with
// atomics, from run to run); the per-block error stays within the
// reference's rtol 2e-4.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 4096;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecPerThread = kBlockRows / (kThreads * 4);   // float4s
constexpr int kSmallG = 32;

template <int GB>
__global__ void __launch_bounds__(kThreads)
grouped_sum_onehot(const float4* __restrict__ gids,
                   const float4* __restrict__ values,
                   const float4* __restrict__ mask, int G,
                   float* __restrict__ partials) {
  float acc[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) acc[g] = 0.f;
  const int64_t base = (int64_t)blockIdx.x * (kBlockRows / 4);
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const int64_t j = base + (int64_t)i * kThreads + threadIdx.x;
    const float4 g4 = gids[j], v4 = values[j], m4 = mask[j];
    const float ga[4] = {g4.x, g4.y, g4.z, g4.w};
    const float va[4] = {v4.x, v4.y, v4.z, v4.w};
    const float ma[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v = va[k] * ma[k];        // the reference multiplies
      const int gi = (int)ga[k];            // truncation, as int32(gid)
#pragma unroll
      for (int g = 0; g < GB; ++g) acc[g] += v * (gi == g ? 1.f : 0.f);
    }
  }
  __shared__ float part[kWarps][GB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float s = acc[g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) part[warp][g] = s;
  }
  __syncthreads();
  if (threadIdx.x < G) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][threadIdx.x];
    partials[(int64_t)blockIdx.x * G + threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
grouped_sum_histogram(const float4* __restrict__ gids,
                      const float4* __restrict__ values,
                      const float4* __restrict__ mask, int G,
                      float* __restrict__ partials) {
  extern __shared__ unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);           // [G]
  int* bad = reinterpret_cast<int*>(acc + G);            // [G]
  __shared__ int bad_total;                              // every group's
  for (int g = threadIdx.x; g < G; g += kThreads) {
    acc[g] = 0.f;
    bad[g] = 0;
  }
  if (threadIdx.x == 0) bad_total = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * (kBlockRows / 4);
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const int64_t j = base + (int64_t)i * kThreads + threadIdx.x;
    const float4 g4 = gids[j], v4 = values[j], m4 = mask[j];
    const float ga[4] = {g4.x, g4.y, g4.z, g4.w};
    const float va[4] = {v4.x, v4.y, v4.z, v4.w};
    const float ma[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v = va[k] * ma[k];
      const int gi = (int)ga[k];
      const bool in_range = gi >= 0 && gi < G;
      if (in_range && v != 0.f) atomicAdd(&acc[gi], v);
      if (!isfinite(v)) {
        atomicAdd(&bad_total, 1);
        if (in_range) atomicAdd(&bad[gi], 1);
      }
    }
  }
  __syncthreads();
  const int total = bad_total;
  float* out = partials + (int64_t)blockIdx.x * G;
  for (int g = threadIdx.x; g < G; g += kThreads)
    out[g] = (total - bad[g] > 0) ? __int_as_float(0x7fc00000) : acc[g];
}

template <int GB>
void launch_onehot(const void* gids, const void* values, const void* mask,
                   int G, void* partials, int n_blocks, cudaStream_t s) {
  grouped_sum_onehot<GB><<<n_blocks, kThreads, 0, s>>>(
      (const float4*)gids, (const float4*)values, (const float4*)mask, G,
      (float*)partials);
}

}  // namespace

extern "C" int grouped_sum_max_groups() { return 4096; }

// Plain C entry point (bound with ctypes): n_blocks CTAs over
// n_blocks * 4096 rows; partials is [n_blocks, G] f32; every pointer is
// device memory, 16-byte aligned; returns the launch's cudaError_t.
extern "C" int grouped_sum_launch(const void* gids, const void* values,
                                  const void* mask, int G, void* partials,
                                  int n_blocks, void* stream) {
  if (n_blocks <= 0) return (int)cudaSuccess;
  if (G <= 0 || G > grouped_sum_max_groups())
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (G <= 1) launch_onehot<1>(gids, values, mask, G, partials, n_blocks, s);
  else if (G <= 2) launch_onehot<2>(gids, values, mask, G, partials, n_blocks, s);
  else if (G <= 4) launch_onehot<4>(gids, values, mask, G, partials, n_blocks, s);
  else if (G <= 8) launch_onehot<8>(gids, values, mask, G, partials, n_blocks, s);
  else if (G <= 16) launch_onehot<16>(gids, values, mask, G, partials, n_blocks, s);
  else if (G <= kSmallG) launch_onehot<kSmallG>(gids, values, mask, G, partials, n_blocks, s);
  else {
    const size_t smem = (size_t)G * (sizeof(float) + sizeof(int));
    grouped_sum_histogram<<<n_blocks, kThreads, smem, s>>>(
        (const float4*)gids, (const float4*)values, (const float4*)mask, G,
        (float*)partials);
  }
  return (int)cudaGetLastError();
}
