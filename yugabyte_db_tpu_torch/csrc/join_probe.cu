// join_probe: the hash-join probe of the fused plan, written by hand for
// Hopper (sm_90a).
//
// Replaces `probe_table` (yugabyte_db_tpu/ops/join_scan.py:406), the
// device lax.while_loop that the reference traces into its fused plan
// program (ops/plan_fusion.py `FusedPlanKernel._build`, jitted at :145).
// That loop steps the WHOLE batch one slot at a time until every row has
// hit its key or an empty slot; in PyTorch each step would be a full pass
// over the batch plus a host sync.  Here one thread owns one probe row and
// walks its own chain in registers:
//
//   row masked (mask_in false, or its key NULL)  -> midx -1, mask_out 0
//   else slot = (uint64(key) * 0x9E3779B97F4A7C15) >> (64 - bits)
//        until used[slot] is 0 (miss) or table_key[slot] == key (hit):
//            slot = (slot + 1) & (num_slots - 1)
//        midx = table_val[slot] on a hit, else -1; mask_out = midx >= 0
//
// Skipping masked rows is exact: the fused plan ANDs the match into the
// row mask, and every later use of a masked row's lanes is masked too.
// The table's load factor is <= 0.5 (the host builder's contract), so
// every walk ends.
//
// Bound on an H100: bytes.  Each padded probe row reads its mask byte and
// writes midx (4 bytes) and its mask byte; a row whose mask is set also
// reads its null byte, where given, and a live row its key (4 or 8
// bytes); the table (num_slots * 13 bytes: used, key, value) is read
// once.  Q3's stage-0 probe at SF1 (8,388,608 rows, 3,255,966 live, a
// table of 2,097,152 slots, 27 MB) moves about 104 MB: ~0.031 ms at
// 3.35 TB/s.
// The table fits in the 50 MB L2, so the chain's scattered reads after
// the first cold pass hit L2.  Design: simple first — one thread per row,
// grid-stride, 256 threads; a warp per chain or keys staged in shared
// memory are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kHashMult = 0x9E3779B97F4A7C15ull;

template <typename K>
__global__ void __launch_bounds__(kThreads)
join_probe_kernel(const K* __restrict__ keys,
                  const uint8_t* __restrict__ key_nulls,
                  const uint8_t* __restrict__ mask_in,
                  const uint8_t* __restrict__ used,
                  const int64_t* __restrict__ table_key,
                  const int32_t* __restrict__ table_val,
                  int bits, int64_t n,
                  int32_t* __restrict__ midx,
                  uint8_t* __restrict__ mask_out) {
  const unsigned long long slot_mask = (1ull << bits) - 1ull;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int32_t hit = -1;
    const bool live = mask_in[i] && !(key_nulls && key_nulls[i]);
    if (live) {
      const int64_t k = (int64_t)keys[i];
      unsigned long long s =
          ((unsigned long long)k * kHashMult) >> (64 - bits);
      while (used[s]) {
        if (table_key[s] == k) {
          hit = table_val[s];
          break;
        }
        s = (s + 1ull) & slot_mask;
      }
    }
    midx[i] = hit;
    mask_out[i] = hit >= 0 ? 1 : 0;
  }
}

template <typename K>
int launch(const void* keys, const void* key_nulls, const void* mask_in,
           const void* used, const void* table_key, const void* table_val,
           int bits, int64_t n, void* midx, void* mask_out,
           cudaStream_t stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;   // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  join_probe_kernel<K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const K*>(keys), static_cast<const uint8_t*>(key_nulls),
      static_cast<const uint8_t*>(mask_in),
      static_cast<const uint8_t*>(used),
      static_cast<const int64_t*>(table_key),
      static_cast<const int32_t*>(table_val), bits, n,
      static_cast<int32_t*>(midx), static_cast<uint8_t*>(mask_out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// key_bytes: 4 (int32 keys) or 8 (int64 keys).  key_nulls may be null.
// bits: log2(num_slots), 3..24.  Returns a cudaError_t (0 = launched).
int join_probe_launch(const void* keys, int key_bytes, const void* key_nulls,
                      const void* mask_in, const void* used,
                      const void* table_key, const void* table_val,
                      int bits, long long n, void* midx, void* mask_out,
                      void* stream) {
  if (bits < 1 || bits > 62 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 8)
    return launch<int64_t>(keys, key_nulls, mask_in, used, table_key,
                           table_val, bits, (int64_t)n, midx, mask_out, s);
  if (key_bytes == 4)
    return launch<int32_t>(keys, key_nulls, mask_in, used, table_key,
                           table_val, bits, (int64_t)n, midx, mask_out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
