// K1: fused TPC-H Q6 scan, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel yugabyte_db_tpu/ops/pallas_scan.py
// `_q6_kernel` (launched by `q6_scan_pallas`).  Per 4096-row block it
// evaluates
//     mask = ship in [lo, hi) & disc in [lo, hi] & qty < max & valid > 0
// and writes one f32 partial SUM(price * disc * mask) and one f32
// partial COUNT(mask) — the Pallas kernel's per-block tiles, without
// the (8, 128) broadcast.
//
// Bound on an H100: bytes.  Five f32 inputs are read once (20 B/row)
// and two f32 partials are written per block; the arithmetic is a few
// operations per row, far below the card's ~20 flop/byte ridge.
// Design: one CTA per block, 256 threads, each thread loading 16 rows
// as four 16-byte float4 loads per lane (coalesced), then a warp
// shuffle reduction and a shared-memory reduction across the 8 warps.
// The multiply by the 0/1 mask (not a select) is kept on purpose: the
// reference multiplies, so a non-finite value on a masked row poisons
// its block partial in both.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 4096;
constexpr int kThreads = 256;
constexpr int kVecPerThread = kBlockRows / (kThreads * 4);   // float4s

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
q6_scan_kernel(const float4* __restrict__ qty, const float4* __restrict__ price,
               const float4* __restrict__ disc, const float4* __restrict__ ship,
               const float4* __restrict__ valid,
               const float* __restrict__ scalars,
               float* __restrict__ sums, float* __restrict__ cnts) {
  const float ship_lo = scalars[0], ship_hi = scalars[1];
  const float disc_lo = scalars[2], disc_hi = scalars[3];
  const float qty_max = scalars[4];
  const int64_t base = (int64_t)blockIdx.x * (kBlockRows / 4);
  float acc = 0.f, cnt = 0.f;
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const int64_t j = base + (int64_t)i * kThreads + threadIdx.x;
    const float4 q = qty[j], p = price[j], d = disc[j], s = ship[j],
                 v = valid[j];
    const float qa[4] = {q.x, q.y, q.z, q.w};
    const float pa[4] = {p.x, p.y, p.z, p.w};
    const float da[4] = {d.x, d.y, d.z, d.w};
    const float sa[4] = {s.x, s.y, s.z, s.w};
    const float va[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool m = (sa[k] >= ship_lo) && (sa[k] < ship_hi) &&
                     (da[k] >= disc_lo) && (da[k] <= disc_hi) &&
                     (qa[k] < qty_max) && (va[k] > 0.f);
      const float mf = m ? 1.f : 0.f;
      const float pd = pa[k] * da[k];
      acc += pd * mf;
      cnt += mf;
    }
  }
  __shared__ float s_acc[kThreads / 32], s_cnt[kThreads / 32];
  acc = warp_sum(acc);
  cnt = warp_sum(cnt);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_acc[warp] = acc;
    s_cnt[warp] = cnt;
  }
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? s_acc[lane] : 0.f;
    cnt = lane < kThreads / 32 ? s_cnt[lane] : 0.f;
    acc = warp_sum(acc);
    cnt = warp_sum(cnt);
    if (lane == 0) {
      sums[blockIdx.x] = acc;
      cnts[blockIdx.x] = cnt;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  n_blocks CTAs over
// n_blocks * 4096 rows; every pointer is device memory, 16-byte
// aligned; returns the cudaError_t of the launch.
extern "C" int q6_scan_launch(const void* qty, const void* price,
                              const void* disc, const void* ship,
                              const void* valid, const void* scalars,
                              void* sums, void* cnts, int n_blocks,
                              void* stream) {
  if (n_blocks <= 0) return (int)cudaSuccess;
  q6_scan_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)qty, (const float4*)price, (const float4*)disc,
      (const float4*)ship, (const float4*)valid, (const float*)scalars,
      (float*)sums, (float*)cnts);
  return (int)cudaGetLastError();
}
