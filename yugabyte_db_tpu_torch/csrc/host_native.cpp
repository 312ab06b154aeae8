// Host-side library of the compaction and bypass paths (CPU code, not a
// kernel).
//
// The port's own copy of the host functions of native/ybtpu_native.cpp
// that the SST writer, the compaction engine and the bypass reader call:
// bloom filter build, the k-way merge of sorted runs (the baseline
// backend's whole-input merge), the row / multi-column / heap gathers
// that move emitted rows from their source blocks into output blocks,
// and the near-data prefilter's range pass over encoded lanes.  Each function keeps
// the reference's semantics and C ABI, so the bytes it produces match.
// Bound with ctypes (storage/native_lib.py), which releases the GIL for
// the duration of every call, so the pipeline's host stages overlap.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (storage/native_lib.py, at
// first use, into build/host_native/).

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// --------------------------------------------------------------------------
// Bloom filter (double hashing, matches storage/sst.py::BloomFilter)
// --------------------------------------------------------------------------
void bloom_build(const uint64_t* hashes, int64_t n, uint8_t* bits,
                 int64_t nbits, int32_t k) {
    for (int64_t i = 0; i < n; ++i) {
        uint64_t h1 = hashes[i];
        uint64_t h2 = (h1 >> 33) | 1ULL;
        for (int32_t j = 0; j < k; ++j) {
            uint64_t idx = (h1 + (uint64_t)j * h2) % (uint64_t)nbits;
            bits[idx >> 3] |= (uint8_t)(1u << (idx & 7));
        }
    }
}

// --------------------------------------------------------------------------
// K-way merge of sorted runs of byte keys. Runs are concatenated: run r
// covers rows [run_starts[r], run_starts[r+1]); key i is
// keys[offsets[i]:offsets[i+1]]. Emits the global row indices in merged
// order with exact-duplicate flags (a key equal to the one before it);
// key ties prefer the lower run index (pass runs newest-first). Returns
// the count emitted.
// --------------------------------------------------------------------------
struct HeapItem {
    const uint8_t* key;
    uint64_t klen;
    int32_t run;
    int64_t row;     // global row index
};

static int key_cmp(const uint8_t* a, uint64_t alen, const uint8_t* b,
                   uint64_t blen) {
    size_t lim = alen < blen ? alen : blen;
    int c = memcmp(a, b, lim);
    if (c) return c;
    return alen < blen ? -1 : (alen > blen ? 1 : 0);
}

struct HeapCmp {
    bool operator()(const HeapItem& a, const HeapItem& b) const {
        int c = key_cmp(a.key, a.klen, b.key, b.klen);
        if (c) return c > 0;          // min-heap by key
        return a.run > b.run;         // tie: lower run index first (newest)
    }
};

int64_t kway_merge(const uint8_t* keys, const uint64_t* offsets,
                   const int64_t* run_starts, int32_t num_runs,
                   int64_t* out_indices, uint8_t* out_dup) {
    std::priority_queue<HeapItem, std::vector<HeapItem>, HeapCmp> heap;
    std::vector<int64_t> cursor(num_runs);
    for (int32_t r = 0; r < num_runs; ++r) {
        cursor[r] = run_starts[r];
        if (cursor[r] < run_starts[r + 1]) {
            heap.push({keys + offsets[cursor[r]],
                       offsets[cursor[r] + 1] - offsets[cursor[r]], r,
                       cursor[r]});
        }
    }
    int64_t emitted = 0;
    const uint8_t* last_key = nullptr;
    uint64_t last_len = 0;
    while (!heap.empty()) {
        HeapItem it = heap.top();
        heap.pop();
        bool dup = last_key &&
                   key_cmp(it.key, it.klen, last_key, last_len) == 0;
        out_indices[emitted] = it.row;
        out_dup[emitted] = dup ? 1 : 0;
        ++emitted;
        last_key = it.key;
        last_len = it.klen;
        int32_t r = it.run;
        if (++cursor[r] < run_starts[r + 1]) {
            heap.push({keys + offsets[cursor[r]],
                       offsets[cursor[r] + 1] - offsets[cursor[r]], r,
                       cursor[r]});
        }
    }
    return emitted;
}

// --------------------------------------------------------------------------
// Row gathers. Fixed-size element loops: a memcpy of a compile-time size
// lowers to one unaligned load/store (sources can be unaligned views over
// the SST mapping, so typed pointer casts would be undefined behaviour).
// All row offsets are int64: a byte offset row_bytes * idx past 2 GiB
// must never wrap through int32.
// --------------------------------------------------------------------------
#define YB_GATHER_W(W)                                                  \
    for (int64_t i = 0; i < n; ++i) {                                   \
        memcpy(dst + i * (W), src + idx[i] * (W), (W));                 \
    }                                                                   \
    return;

#define YB_GS_W(W)                                                      \
    for (int64_t i = 0; i < n; ++i) {                                   \
        memcpy(dst + dst_idx[i] * (W), src + src_idx[i] * (W), (W));    \
    }                                                                   \
    return;

// dst[i] = src[idx[i]], row-wise
void gather_rows(const uint8_t* src, int64_t row_bytes,
                 const int64_t* idx, int64_t n, uint8_t* dst) {
    switch (row_bytes) {
        case 1: YB_GATHER_W(1)
        case 2: YB_GATHER_W(2)
        case 4: YB_GATHER_W(4)
        case 8: YB_GATHER_W(8)
        case 16: YB_GATHER_W(16)
    }
    for (int64_t i = 0; i < n; ++i) {
        memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
               (size_t)row_bytes);
    }
}

// dst[dst_idx[i]] = src[src_idx[i]], row-wise
void gather_scatter_rows(const uint8_t* src, int64_t row_bytes,
                         const int64_t* src_idx, const int64_t* dst_idx,
                         int64_t n, uint8_t* dst) {
    switch (row_bytes) {
        case 1: YB_GS_W(1)
        case 2: YB_GS_W(2)
        case 4: YB_GS_W(4)
        case 8: YB_GS_W(8)
        case 16: YB_GS_W(16)
    }
    for (int64_t i = 0; i < n; ++i) {
        memcpy(dst + dst_idx[i] * row_bytes,
               src + src_idx[i] * row_bytes, (size_t)row_bytes);
    }
}

// --------------------------------------------------------------------------
// Fused multi-column gather / gather-scatter / copy: one call moves every
// output lane of a chunk (values, null masks, MVCC lanes, key matrix).
// Jobs are parallel arrays; per-job index pointers may alias.
//   src_idx[j] == NULL -> identity source rows 0..n-1
//   dst_idx[j] == NULL -> dense output rows 0..n-1
// --------------------------------------------------------------------------
static inline void gather_one(const uint8_t* src, uint8_t* dst,
                              int64_t row_bytes, const int64_t* src_idx,
                              const int64_t* dst_idx, int64_t n) {
    if (src_idx && dst_idx) {
        switch (row_bytes) {
            case 1: YB_GS_W(1)
            case 2: YB_GS_W(2)
            case 4: YB_GS_W(4)
            case 8: YB_GS_W(8)
            case 16: YB_GS_W(16)
        }
        for (int64_t i = 0; i < n; ++i) {
            memcpy(dst + dst_idx[i] * row_bytes,
                   src + src_idx[i] * row_bytes, (size_t)row_bytes);
        }
        return;
    }
    if (src_idx) {
        const int64_t* idx = src_idx;
        switch (row_bytes) {
            case 1: YB_GATHER_W(1)
            case 2: YB_GATHER_W(2)
            case 4: YB_GATHER_W(4)
            case 8: YB_GATHER_W(8)
            case 16: YB_GATHER_W(16)
        }
        for (int64_t i = 0; i < n; ++i) {
            memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                   (size_t)row_bytes);
        }
        return;
    }
    if (dst_idx) {      // pure scatter of a contiguous source range
        for (int64_t i = 0; i < n; ++i) {
            memcpy(dst + dst_idx[i] * row_bytes, src + i * row_bytes,
                   (size_t)row_bytes);
        }
        return;
    }
    memcpy(dst, src, (size_t)(n * row_bytes));
}

void gather_multi(const uint8_t* const* src, uint8_t* const* dst,
                  const int64_t* row_bytes,
                  const int64_t* const* src_idx,
                  const int64_t* const* dst_idx,
                  const int64_t* counts, int64_t njobs) {
    for (int64_t j = 0; j < njobs; ++j) {
        gather_one(src[j], dst[j], row_bytes[j], src_idx[j], dst_idx[j],
                   counts[j]);
    }
}

// Varlen heap gather: per output row i, copy lens[i] bytes from
// heap+src_start[i] to out+dst_start[i].
void gather_heap(const uint8_t* heap, const int64_t* src_start,
                 const int64_t* dst_start, const int64_t* lens,
                 int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        if (lens[i])
            memcpy(out + dst_start[i], heap + src_start[i],
                   (size_t)lens[i]);
    }
}

// --------------------------------------------------------------------------
// Near-data prefilter (bypass/prefilter.py): AND of inclusive range
// predicates over fixed-width lanes into a keep mask; a NULL row fails
// its predicate.  dtypes: 1 int32, 2 int64, 3 float32, 4 float64,
// 5 uint32 (integer bounds in lo_i/hi_i, float bounds in lo_f/hi_f).
// Lanes may be unaligned views over an SST mapping: values load through
// memcpy.
// --------------------------------------------------------------------------
#define YB_PF_LOOP(T, LO, HI)                                           \
    {                                                                   \
        const uint8_t* base = (const uint8_t*)cols[p];                  \
        for (int64_t i = 0; i < n; ++i) {                               \
            T v;                                                        \
            memcpy(&v, base + i * (int64_t)sizeof(T), sizeof(T));       \
            keep[i] &= (uint8_t)((!nu || !nu[i]) &&                     \
                                 v >= (LO) && v <= (HI));               \
        }                                                               \
    }                                                                   \
    break;

void prefilter_ranges(const void* const* cols, const int64_t* dtypes,
                      const uint8_t* const* nulls,
                      const double* lo_f, const double* hi_f,
                      const int64_t* lo_i, const int64_t* hi_i,
                      int64_t npreds, int64_t n, uint8_t* keep) {
    for (int64_t i = 0; i < n; ++i) keep[i] = 1;
    for (int64_t p = 0; p < npreds; ++p) {
        const uint8_t* nu = nulls[p];
        switch (dtypes[p]) {
            case 1: YB_PF_LOOP(int32_t, lo_i[p], hi_i[p])
            case 2: YB_PF_LOOP(int64_t, lo_i[p], hi_i[p])
            case 3: YB_PF_LOOP(float, lo_f[p], hi_f[p])
            case 4: YB_PF_LOOP(double, lo_f[p], hi_f[p])
            case 5: YB_PF_LOOP(uint32_t, lo_i[p], hi_i[p])
            default:
                // the binding sends no other code; keep every row
                break;
        }
    }
}

}  // extern "C"
