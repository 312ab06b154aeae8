// K2: one-hot grouped masked sum, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel yugabyte_db_tpu/ops/pallas_scan.py
// `_grouped_kernel` (launched by `grouped_sum_pallas`), which computes
// per 4096-row block  one_hot(int32(gid))^T . (value * mask)  as an MXU
// matmul and emits one [G] partial row per block.
//
// Bound on an H100: bytes.  Three f32 inputs are read once (12 B/row);
// the [grid, G] partials are small.  A one-hot product would spend G
// multiply-adds per row for one useful add, so the design is a
// histogram instead: one CTA per block, a shared-memory [G] f32
// accumulator fed by shared atomics, one [G] row written per block.
// G is bounded by shared memory (the wrapper refuses G > 4096).
//
// The matmul's inf * 0 = NaN spread is reproduced exactly: a valid row
// whose value*mask is non-finite contributes NaN to every OTHER group
// of its block (and to all groups when its gid is out of range), as
// the one-hot product does.  A shared [G+1] counter of non-finite rows
// per group (slot G: out of range) decides it after the block is read.
// Shared atomics make the f32 order of additions run-dependent; the
// per-block error stays within the reference's rtol 2e-4.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 4096;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
grouped_sum_kernel(const float4* __restrict__ gids,
                   const float4* __restrict__ values,
                   const float4* __restrict__ mask, int G,
                   float* __restrict__ partials) {
  extern __shared__ unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  int* bad = reinterpret_cast<int*>(acc + G);          // [G + 1]
  for (int g = threadIdx.x; g < G; g += kThreads) acc[g] = 0.f;
  for (int g = threadIdx.x; g <= G; g += kThreads) bad[g] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * (kBlockRows / 4);
#pragma unroll
  for (int i = 0; i < kBlockRows / (kThreads * 4); ++i) {
    const int64_t j = base + (int64_t)i * kThreads + threadIdx.x;
    const float4 g4 = gids[j], v4 = values[j], m4 = mask[j];
    const float ga[4] = {g4.x, g4.y, g4.z, g4.w};
    const float va[4] = {v4.x, v4.y, v4.z, v4.w};
    const float ma[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v = va[k] * ma[k];        // the reference multiplies
      const int gi = (int)ga[k];            // truncation, as int32(gid)
      const bool in_range = gi >= 0 && gi < G;
      if (in_range && v != 0.f) atomicAdd(&acc[gi], v);
      if (!isfinite(v)) atomicAdd(&bad[in_range ? gi : G], 1);
    }
  }
  __syncthreads();
  int total_bad = 0;
  for (int g = 0; g <= G; ++g) total_bad += bad[g];
  float* out = partials + (int64_t)blockIdx.x * G;
  for (int g = threadIdx.x; g < G; g += kThreads)
    out[g] = (total_bad - bad[g] > 0) ? __int_as_float(0x7fc00000) : acc[g];
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
  const size_t smem = (size_t)G * sizeof(float) + (size_t)(G + 1) * sizeof(int);
  grouped_sum_kernel<<<n_blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)gids, (const float4*)values, (const float4*)mask, G,
      (float*)partials);
  return (int)cudaGetLastError();
}
