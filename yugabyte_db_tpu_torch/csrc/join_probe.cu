// join_probe: the hash-join probe of the fused plan, written by hand for
// Hopper (sm_90a).
//
// Replaces `probe_table` (yugabyte_db_tpu/ops/join_scan.py:406), the
// device lax.while_loop that the reference traces into its fused plan
// program (ops/plan_fusion.py `FusedPlanKernel._build`, jitted at :145).
// That loop steps the WHOLE batch one slot at a time until every row has
// hit its key or an empty slot; in PyTorch each step would be a full pass
// over the batch plus a host sync.  Here each thread walks the chains of
// kRows = 4 consecutive probe rows in registers, in the same order of
// slots:
//
//   row masked (mask_in false, or its key NULL)  -> midx -1, mask_out 0
//   else slot = (uint64(key) * 0x9E3779B97F4A7C15) >> (64 - bits)
//        until val(slot) < 0 (empty: a miss) or key(slot) == key (hit):
//            slot = (slot + 1) & (num_slots - 1)
//        midx = val(slot) on a hit, else -1; mask_out = midx >= 0
//
// Skipping masked rows is exact: the fused plan ANDs the match into the
// row mask, and every later use of a masked row's lanes is masked too.
// The table's load factor is <= 0.5 (the host builder's contract), so
// every walk ends.
//
// Table layout (ops/join_scan.py `pack_table`): one aligned load per
// step of a walk, one 32-byte sector, where three lanes took three:
//    8-byte slot {int32 key; int32 val}              keys that fit int32
//   16-byte slot {int64 key; int32 val; int32 pad}   any int64 keys
// An empty slot has val = -1 (a used slot's val is a build-row index).
// On a narrow table a probe key outside int32 is a miss before any load:
// it is never truncated into a match.  The runtime takes the narrow
// slots whenever its keys fit (every TPC-H join here): half the bytes,
// so more of the table stays in L2.
//
// Design: the walk is bound by latency, not bytes.  Each thread takes 4
// consecutive rows: it loads their mask bytes as one word, then the keys
// and NULL bytes of masked-in rows (a 16-byte key vector only where one
// of its rows is masked in), then issues the home-slot loads of all live
// rows before it consumes any; rows that miss their home slot walk on,
// those still walking issuing their next loads together.  midx leaves as
// one int4 store and mask_out as one word.  Probe lanes are read and
// written with streaming hints (ld/st.global.cs, evict first), so they
// pass through L2 without pushing the table out; slots are read through
// the read-only path (ld.global.nc).  On narrow slots the kernel fits in
// 32 registers, so an SM holds 2,048 threads, 8,192 rows in flight.  8
// and 16 rows a thread were measured too (PERF.md §6): they need 72 and
// 124 registers and lose more to the resident threads they cost than
// they gain per thread.  Lanes whose pointers are not 16-byte aligned
// (views at a storage offset) and the tail group of a batch whose length
// is not a multiple of 4 take scalar loads and stores.
//
// Bound on an H100: bytes.  Each padded probe row reads its mask byte
// and writes midx (4 bytes) and its mask byte; a row whose mask is set
// also reads its null byte, where given, and a live row its key (4 or 8
// bytes); the table is read once at the bytes a slot needs: 8 where
// every build key fits in int32 (the narrow slot), else 13 (used, key,
// value).  Q3's stage-0 probe at SF1 (8,388,608 rows, 3,255,966 live,
// 2,097,152 narrow slots) moves 93.1 MB: 0.0278 ms at 3.35 TB/s.  The
// kernel reads keys and NULL bytes by 32-byte sector, so sparse masks
// cost it more than the bound counts.  Times on an NVIDIA H100 80GB HBM3
// at 700 W, against this bound, are in PERF.md (chip_smoke.py's
// join_probe lines; `probe_bytes` there is the formula).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;          // probe rows per thread
constexpr unsigned long long kHashMult = 0x9E3779B97F4A7C15ull;

// A slot layout: what one step of a walk loads (`Unit`), and `step`,
// which checks the loaded slot and returns the row's midx (-1 at an
// empty slot) or kGoOn with `s` moved to the next slot.  `Key` is the
// width the keys compare at; `key_of` narrows a probe key to it and says
// whether it fits (a key that does not can match no slot).
// kMinBlocks: the blocks of kThreads each SM must hold
// (__launch_bounds__): the narrow layout fits in 32 registers, so the SM
// is filled with 2,048 threads; the wide one takes what it needs.
constexpr int kGoOn = -2;

struct WideSlot {                 // {int64 key; int32 val; int32 pad}
  using Key = long long;
  using Unit = longlong2;
  static constexpr int kMinBlocks = 1;   // 54 registers
  static __device__ __forceinline__ Unit load(const void* t, uint32_t s) {
    return __ldg(static_cast<const longlong2*>(t) + s);
  }
  static __device__ __forceinline__ int step(const Unit& u, Key k,
                                             uint32_t& s, uint32_t mask) {
    const int val = (int)(u.y & 0xffffffffll);
    if (val < 0) return -1;
    if (u.x == k) return val;
    s = (s + 1u) & mask;
    return kGoOn;
  }
  static __device__ __forceinline__ bool key_of(long long k, Key& out) {
    out = k;
    return true;
  }
};

struct NarrowSlot {               // {int32 key; int32 val}
  using Key = int;
  using Unit = int2;
  static constexpr int kMinBlocks = 16;  // 32 registers, no spills
  static __device__ __forceinline__ Unit load(const void* t, uint32_t s) {
    return __ldg(static_cast<const int2*>(t) + s);
  }
  static __device__ __forceinline__ int step(const Unit& u, Key k,
                                             uint32_t& s, uint32_t mask) {
    if (u.y < 0) return -1;
    if (u.x == k) return u.y;
    s = (s + 1u) & mask;
    return kGoOn;
  }
  static __device__ __forceinline__ bool key_of(long long k, Key& out) {
    out = (int)k;
    return (long long)out == k;
  }
};

// bit j set where byte j of the word is non-zero
__device__ __forceinline__ uint32_t nonzero_bits(uint32_t w) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    bits |= (((w >> (8 * j)) & 0xffu) != 0u ? 1u : 0u) << j;
  return bits;
}

// The 4 bytes of the group at row i0 as one word: one streaming load on
// the vector path, left in flight (consumed later by nonzero_bits).
template <bool kVec>
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ p,
                                              long long i0, long long n) {
  if (kVec && i0 + kRows <= n)
    return __ldcs(reinterpret_cast<const unsigned int*>(p + i0));
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    if (i0 + j < n) w |= (uint32_t)__ldcs(p + i0 + j) << (8 * j);
  return w;
}

// The keys and NULL bytes of the group's masked-in rows: a 16-byte key
// vector where one of its rows has its mask set, the NULL word where any
// has.  Rows whose mask is clear get key 0.
template <typename K, bool kVec>
__device__ __forceinline__ void load_keys(const K* __restrict__ keys,
                                          const uint8_t* __restrict__ nulls,
                                          uint32_t mbits, long long i0,
                                          long long n,
                                          long long (&key)[kRows],
                                          uint32_t& nw) {
  constexpr int E = 16 / (int)sizeof(K);       // keys per 16-byte vector
  const bool vec = kVec && i0 + kRows <= n;
  nw = 0u;
  if (vec && nulls != nullptr && mbits != 0u)
    nw = __ldcs(reinterpret_cast<const unsigned int*>(nulls + i0));
#pragma unroll
  for (int c = 0; c < kRows / E; ++c) {
    const bool any = ((mbits >> (c * E)) & ((1u << E) - 1u)) != 0u;
    if (vec) {
      if constexpr (E == 2) {
        longlong2 v = make_longlong2(0, 0);
        if (any)
          v = __ldcs(reinterpret_cast<const longlong2*>(keys + i0) + c);
        key[c * 2] = v.x;
        key[c * 2 + 1] = v.y;
      } else {
        int4 v = make_int4(0, 0, 0, 0);
        if (any) v = __ldcs(reinterpret_cast<const int4*>(keys + i0));
        key[0] = v.x;
        key[1] = v.y;
        key[2] = v.z;
        key[3] = v.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = c * E + e;
        const bool in = (mbits >> j) & 1u;
        key[j] = in ? (long long)__ldcs(keys + i0 + j) : 0ll;
        if (in && nulls != nullptr)
          nw |= (uint32_t)__ldcs(nulls + i0 + j) << (8 * j);
      }
    }
  }
}

// The walks of the live rows whose home-slot loads `u` were issued:
// every row still walking issues its next load before any is consumed.
template <typename Slot>
__device__ __forceinline__ void walk(const void* __restrict__ t,
                                     uint32_t pend, uint32_t slot_mask,
                                     const typename Slot::Key (&key)[kRows],
                                     uint32_t (&slot)[kRows],
                                     typename Slot::Unit (&u)[kRows],
                                     int (&hit)[kRows]) {
  for (;;) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if ((pend >> j) & 1u) {
        const int r = Slot::step(u[j], key[j], slot[j], slot_mask);
        if (r != kGoOn) {
          hit[j] = r;
          pend &= ~(1u << j);
        }
      }
    }
    if (pend == 0u) return;
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if ((pend >> j) & 1u) u[j] = Slot::load(t, slot[j]);
  }
}

template <bool kVec>
__device__ __forceinline__ void store_group(int32_t* __restrict__ midx,
                                            uint8_t* __restrict__ mask_out,
                                            long long i0, long long n,
                                            const int (&hit)[kRows]) {
  if (kVec && i0 + kRows <= n) {
    __stcs(reinterpret_cast<int4*>(midx + i0),
           make_int4(hit[0], hit[1], hit[2], hit[3]));
    uint32_t w = 0u;
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      w |= (hit[j] >= 0 ? 1u : 0u) << (8 * j);
    __stcs(reinterpret_cast<unsigned int*>(mask_out + i0), w);
    return;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (i0 + j < n) {
      __stcs(midx + i0 + j, hit[j]);
      __stcs(mask_out + i0 + j, (unsigned char)(hit[j] >= 0 ? 1 : 0));
    }
  }
}

// K: int (4-byte keys) or long long (8-byte keys).  kVec: the lanes are
// 16-byte aligned, so full groups take vector accesses.
template <typename K, typename Slot, bool kVec>
__global__ void __launch_bounds__(kThreads, Slot::kMinBlocks)
join_probe_kernel(const K* __restrict__ keys,
                  const uint8_t* __restrict__ key_nulls,
                  const uint8_t* __restrict__ mask_in,
                  const void* __restrict__ table, int bits, long long n,
                  int32_t* __restrict__ midx,
                  uint8_t* __restrict__ mask_out) {
  const uint32_t slot_mask = (1u << bits) - 1u;
  const long long groups = (n + kRows - 1) / kRows;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long i0 = g * kRows;
    // 1. the mask bytes, then the keys and NULL bytes of masked-in rows
    const uint32_t mbits = nonzero_bits(load_word<kVec>(mask_in, i0, n));
    long long key64[kRows];
    uint32_t nw;
    load_keys<K, kVec>(keys, key_nulls, mbits, i0, n, key64, nw);
    uint32_t live = mbits & ~nonzero_bits(nw);
    // 2. every live row's home-slot load, issued before any is consumed
    typename Slot::Key key[kRows];
    uint32_t slot[kRows];
    int hit[kRows];
    typename Slot::Unit u[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      hit[j] = -1;
      slot[j] = (uint32_t)(((unsigned long long)key64[j] * kHashMult) >>
                           (64 - bits));
      if (!Slot::key_of(key64[j], key[j])) live &= ~(1u << j);
      if ((live >> j) & 1u) u[j] = Slot::load(table, slot[j]);
    }
    // 3. the walks on, then midx and mask_out
    walk<Slot>(table, live, slot_mask, key, slot, u, hit);
    store_group<kVec>(midx, mask_out, i0, n, hit);
  }
}

// The run-time choices to template arguments, one level at a time.
struct Args {
  const void* keys;
  const void* key_nulls;
  const void* mask_in;
  const void* table;
  int bits;
  long long n;
  void* midx;
  void* mask_out;
  cudaStream_t stream;
};

template <typename K, typename Slot, bool kVec>
int launch(const Args& a) {
  long long blocks = ((a.n + kRows - 1) / kRows + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;   // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  join_probe_kernel<K, Slot, kVec>
      <<<(unsigned)blocks, kThreads, 0, a.stream>>>(
          static_cast<const K*>(a.keys),
          static_cast<const uint8_t*>(a.key_nulls),
          static_cast<const uint8_t*>(a.mask_in), a.table, a.bits, a.n,
          static_cast<int32_t*>(a.midx), static_cast<uint8_t*>(a.mask_out));
  return (int)cudaGetLastError();
}

template <typename K, typename Slot>
int by_vec(int vec, const Args& a) {
  return vec ? launch<K, Slot, true>(a) : launch<K, Slot, false>(a);
}

template <typename K>
int by_slot(int slot_bytes, int vec, const Args& a) {
  if (slot_bytes == 16) return by_vec<K, WideSlot>(vec, a);
  if (slot_bytes == 8) return by_vec<K, NarrowSlot>(vec, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// key_bytes: 4 (int32 keys) or 8 (int64 keys).  key_nulls may be null.
// table: the packed slots, slot_bytes 16 or 8, 2^bits of them (bits
// 3..31).  vec: 1 if keys, key_nulls, mask_in, midx and mask_out are all
// 16-byte aligned, else 0 (scalar accesses).  Returns a cudaError_t
// (0 = launched).
int join_probe_launch(const void* keys, int key_bytes, const void* key_nulls,
                      const void* mask_in, const void* table, int slot_bytes,
                      int bits, long long n, int vec, void* midx,
                      void* mask_out, void* stream) {
  if (bits < 3 || bits > 31 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Args a{keys, key_nulls, mask_in, table, bits, n, midx, mask_out,
               static_cast<cudaStream_t>(stream)};
  if (key_bytes == 8) return by_slot<long long>(slot_bytes, vec, a);
  if (key_bytes == 4) return by_slot<int>(slot_bytes, vec, a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
