"""DocDB compaction over columnar SSTs: the pipelined device engine and
the monolithic host baseline.

Counterpart of ``yugabyte_db_tpu/docdb/compaction.py``.  The device
backend is a three-stage pipeline over the pre-sorted input runs
(reference analog: CompactionJob overlapping merge work with output IO,
rocksdb/db/compaction_job.cc:665):

  1. decode-ahead (host threads): columnar blocks of the planned inputs
     deserialize ahead of the merge cursor, bounded by the frontier
     budget — the whole input is never resident at once;
  2. run-aware merge (the card): per chunk, the unconsumed suffixes of
     the active blocks form a fixed-capacity frontier; the torch program
     ops/compaction.py chunk_merge_kernel sorts ONLY the frontier and
     emits the prefix strictly below the smallest key any unpulled block
     could contribute, with an MVCC carry so retention is exact across
     chunks;
  3. encode/write (host threads): emitted+kept rows gather straight from
     their source blocks into output ColumnarBlocks that stream to the
     SST file while the next chunk merges.

``backend="baseline"`` is the reference's monolithic whole-input merge
on the host (the host library's k-way merge, then the same vectorized
retention rule): the CPU comparison point a compaction speedup is
stated against.

Inputs outside the columnar engines — row blocks (a TTL'd value never
gets a columnar sidecar), mixed key widths, blocks that turn ineligible
mid-stream — take the reference's row routes: ``_compact_rows`` for the
device backend (every entry materialized, the whole-input merge + GC
program ops/compaction.py ``merge_gc_split_kernel`` on the card, with
the TTL-expiry retention term), the streaming CPU feed
(``DocDbCompactionFeed`` through ``LsmStore.compact``) for the
baseline, and the CPU feed for keys without the hybrid-time suffix.
The reference's ``native`` backend raises ``NotPortedError`` (ROADMAP.md
queue 1 item 9a).  Columnar inputs are TTL-free by construction, so the
columnar engines need no TTL term."""
from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..errors import NotPortedError
from ..ops.compaction import (KeySuffixError, _pad_rows, check_ht_suffix,
                              kernel_cache_stats, keys_to_words,
                              merge_frontier, split_ht_suffix)
from ..storage import native_lib
from ..dockv.value import ValueKind, unwrap_ttl
from ..ops.compaction import compact_runs
from ..storage.columnar import ColumnarBlock
from ..storage.lsm import CompactionFeed, LsmStore
from ..storage.sst import SstReader, SstWriter
from ..utils import flags
from ..utils.hybrid_time import ENCODED_SIZE, DocHybridTime
from .table_codec import TableCodec

_HT_SUFFIX = ENCODED_SIZE + 1

#: stage/shape counters of the most recent chunked compaction
LAST_COMPACTION_STATS: dict = {}


class DocDbCompactionFeed(CompactionFeed):
    """Streaming MVCC GC for the CPU compaction path (reference:
    docdb/docdb_compaction_context.cc:783 DocDBCompactionFeed): drop
    exact duplicates and overwritten versions at or below the history
    cutoff, a latest-at-cutoff tombstone, and a latest-at-cutoff row
    whose TTL expired at or before the cutoff."""

    def __init__(self, history_cutoff: int):
        self.cutoff = history_cutoff
        self._cur_prefix: Optional[bytes] = None
        self._seen_leq = False
        self._last_dht: Optional[tuple] = None

    def feed(self, key: bytes, value: bytes):
        prefix = key[:-_HT_SUFFIX]
        dht = DocHybridTime.decode_desc(key[-ENCODED_SIZE:])
        if prefix != self._cur_prefix:
            self._cur_prefix = prefix
            self._seen_leq = False
            self._last_dht = None
        ident = (dht.ht.value, dht.write_id)
        if self._last_dht == ident:
            return []                      # exact duplicate (replay)
        self._last_dht = ident
        if dht.ht.value > self.cutoff:
            return [(key, value)]          # within retention window
        if self._seen_leq:
            return []                      # overwritten history
        self._seen_leq = True
        if value and value[0] == ValueKind.kTombstone:
            return []                      # latest <= cutoff is a delete
        _, expire = unwrap_ttl(value)
        if expire is not None and expire <= self.cutoff:
            return []                      # TTL-expired beyond retention
        return [(key, value)]


def native_merge_gc(keys: np.ndarray, run_starts: np.ndarray,
                    ht: np.ndarray, tomb: np.ndarray, cutoff: int):
    """The baseline backend's whole-input merge + GC on the host
    library's k-way merge (reference analog: rocksdb MergingIterator +
    DocDBCompactionFeed): merge the per-SST sorted runs of full keys,
    then apply chunk_merge_kernel's retention rule over the merged
    order.  Returns (order, keep): `order` indexes the concatenated runs
    in merged order, `keep` is aligned to it.  The numpy twin of the
    merge is native_lib.kway_merge_fixed_plain."""
    order, dup = native_lib.kway_merge_fixed(keys, run_starts)
    dk_s = keys[order][:, :-_HT_SUFFIX]
    same_dockey = np.concatenate(
        [[False], (dk_s[1:] == dk_s[:-1]).all(axis=1)])
    ht_s = ht[order]
    tomb_s = tomb[order]
    leq = ht_s <= np.uint64(cutoff)
    prev_leq = np.concatenate([[False], leq[:-1]])
    # versions sort newest-first within a doc key, so its <=cutoff rows
    # are contiguous at the tail: "first leq" = leq with no leq right
    # before it in the same key (the device program's rule)
    first_leq = leq & (~same_dockey | ~prev_leq)
    keep = ~dup & ((ht_s > np.uint64(cutoff)) | (first_leq & ~tomb_s))
    return order, keep


def tpu_compact(store: LsmStore, codec: TableCodec, history_cutoff: int,
                inputs: Optional[Sequence[SstReader]] = None,
                block_rows: int = 65536, backend: str = "device",
                device: DeviceLike = "cuda") -> Optional[str]:
    """Major (or selected-input) compaction of columnar SSTs into one
    new SST that replaces them in `store`.

    backend="device": the pipelined chunked engine, the merge on
    `device` (CUDA by default; raises without it — the CPU runs it only
    when the caller passes device="cpu").
    backend="baseline": the monolithic whole-input host merge.

    Returns the new SST path, or None when there was nothing to do.
    Inputs outside the columnar engines fall back as the reference's
    do: the device backend to ``_compact_rows`` (row blocks, mixed key
    widths, a block the chunked engine refuses mid-stream), the baseline
    to the streaming CPU feed, keys without the hybrid-time suffix to
    the CPU feed.  backend="native" raises NotPortedError."""
    dev = resolve_device(device)
    if backend == "native":
        raise NotPortedError(
            "tpu_compact(backend='native') (the chunked engine with the "
            "host k-way merge per chunk)",
            "ROADMAP.md queue 1 item 9a (native compaction backend)")
    if backend not in ("device", "baseline"):
        raise ValueError(f"unknown compaction backend {backend!r}")
    if inputs is None:
        inputs = store.ssts
    inputs = list(inputs)
    if not inputs:
        return None
    try:
        if backend == "device" and _chunked_eligible(inputs):
            path = _compact_columnar_chunked(
                store, codec, inputs, history_cutoff, block_rows, dev)
            if path is not None:
                return path
        if backend == "baseline":
            got = _collect_monolithic(inputs)
            if got is not None:
                col_sources, run_starts = got
                return _compact_columnar(store, codec, col_sources, inputs,
                                         history_cutoff, block_rows,
                                         run_starts)
            # non-columnar inputs on the host backend: the streaming GC
            # feed, TTL expiry included
            return store.compact(inputs=inputs,
                                 feed=DocDbCompactionFeed(history_cutoff))
        return _compact_rows(store, codec, inputs, history_cutoff, dev)
    except KeySuffixError:
        # a corrupt or mixed key layout: the CPU feed (row at a time, no
        # fixed-suffix assumption)
        return store.compact(inputs=inputs,
                             feed=DocDbCompactionFeed(history_cutoff))


def _chunked_eligible(inputs: Sequence[SstReader]) -> bool:
    """Cheap index-only screen for the chunked engine: every block has a
    columnar sidecar and one key width is plausible (index first/last
    keys all one length). Deeper checks (keys matrix present, HT suffix
    markers) happen per block during streaming decode."""
    widths = set()
    any_blocks = False
    for r in inputs:
        for e in r.index:
            any_blocks = True
            if e.col_offset < 0:
                return False
            widths.add(len(e.first_key))
            widths.add(len(e.last_key))
            if len(widths) > 1:
                return False
    return any_blocks


def _collect_monolithic(inputs: Sequence[SstReader]):
    """Materialize every columnar block (the baseline path's whole-input
    shape). None when inputs aren't uniformly columnar."""
    col_sources: List[ColumnarBlock] = []
    run_starts = [0]
    for r in inputs:
        rows = 0
        for i in range(r.num_blocks()):
            cb = r.columnar_block(i)
            if cb is None or cb.keys is None:
                return None
            col_sources.append(cb)
            rows += cb.n
        run_starts.append(run_starts[-1] + rows)
    if not col_sources:
        return None
    widths = {cb.keys.shape[1] for cb in col_sources}
    if len(widths) != 1:
        return None
    return col_sources, np.asarray(run_starts, np.int64)


def _compact_columnar(store, codec, blocks: List[ColumnarBlock],
                      inputs, cutoff: int, block_rows: int,
                      run_starts: np.ndarray) -> str:
    """The baseline: merge + GC of the whole input at once on the host,
    then gather the kept rows into `block_rows`-row output blocks whose
    writes overlap the next block's gathers."""
    keys = np.concatenate([b.keys for b in blocks])
    tomb = np.concatenate([b.tombstone for b in blocks])
    dk, ht, wid = split_ht_suffix(keys)
    order, keep = native_merge_gc(keys, run_starts, ht, tomb, cutoff)
    sel = order[keep]                       # kept rows, in sorted key order
    # adjacent-distinct doc keys over ALL kept rows, computed once (the
    # per-output-block unique_keys flags are slices of this)
    if len(sel) > 1:
        dk_sel = dk[sel]
        distinct_adj = (dk_sel[1:] != dk_sel[:-1]).any(axis=1)
    else:
        distinct_adj = np.ones(0, bool)

    fixed_ids = list(blocks[0].fixed.keys())
    pk_ids = list(blocks[0].pk.keys())
    varlen_ids = list(blocks[0].varlen.keys())
    key_hash = np.concatenate([b.key_hash for b in blocks])
    sv = blocks[0].schema_version

    # varlen gather: per column, per-block heaps concatenate once into a
    # global byte array with rebased start/end offsets; the output heap
    # is one fancy-index gather (repeat-offsets trick)
    varlen_cat = {}

    def _cat_varlen(cid):
        if cid in varlen_cat:
            return varlen_cat[cid]
        starts_all, ends_all, null_all, heaps = [], [], [], []
        heap_base = 0
        for b in blocks:
            ends, heap, null = b.varlen[cid]
            ends = ends.astype(np.int64)
            starts = np.concatenate([[0], ends[:-1]])
            starts_all.append(starts + heap_base)
            ends_all.append(ends + heap_base)
            null_all.append(null)
            heaps.append(bytes(heap))
            heap_base += len(heaps[-1])
        cat = (np.concatenate(starts_all), np.concatenate(ends_all),
               np.concatenate(null_all),
               np.frombuffer(b"".join(heaps), np.uint8))
        varlen_cat[cid] = cat
        return cat

    def gather_varlen(cid, sel_idx):
        starts_c, ends_c, null_c, heap_c = _cat_varlen(cid)
        out_null = null_c[sel_idx]
        s = starts_c[sel_idx]
        lens = np.where(out_null, 0, ends_c[sel_idx] - s)
        out_ends = np.cumsum(lens, dtype=np.int64)
        total = int(out_ends[-1]) if len(out_ends) else 0
        if total == 0:
            return out_ends.astype(np.uint32), b"", out_null
        out_starts = out_ends - lens
        idx = (np.repeat(s, lens)
               + np.arange(total, dtype=np.int64)
               - np.repeat(out_starts, lens))
        return out_ends.astype(np.uint32), heap_c[idx].tobytes(), out_null

    # concatenate each column ONCE; blocks below only gather
    fixed_cat = {cid: (np.concatenate([b.fixed[cid][0] for b in blocks]),
                       np.concatenate([b.fixed[cid][1] for b in blocks]))
                 for cid in fixed_ids}
    pk_cat = {cid: np.concatenate([b.pk[cid] for b in blocks])
              for cid in pk_ids}
    path = store._new_sst_path()
    w = SstWriter(path, stream_columnar=True,
                  key_builder=codec.derive_keys,
                  shred_cols=codec.shred_cols)
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = None
        for s in range(0, len(sel), block_rows):
            chunk = sel[s:s + block_rows]
            fixed = {cid: (fixed_cat[cid][0][chunk],
                           fixed_cat[cid][1][chunk])
                     for cid in fixed_ids}
            pk = {cid: pk_cat[cid][chunk] for cid in pk_ids}
            varlen = {cid: gather_varlen(cid, chunk)
                      for cid in varlen_ids}
            out = ColumnarBlock.from_arrays(
                schema_version=sv,
                key_hash=key_hash[chunk],
                ht=ht[chunk], write_id=wid[chunk],
                pk=pk, fixed=fixed, varlen=varlen,
                tombstone=tomb[chunk],
                keys=keys[chunk],
                unique_keys=bool(
                    distinct_adj[s:s + len(chunk) - 1].all()))
            if pending is not None:
                pending.result()
            pending = pool.submit(w.add_columnar_block, out)
        if pending is not None:
            pending.result()
    w.set_frontier(**_merge_frontier(inputs))
    w.finish()
    store.replace_ssts(inputs, path)
    return path


# ---------------------------------------------------------------------------
# Pipelined chunked engine (the backend="device" path)
# ---------------------------------------------------------------------------
class _ChunkFallback(Exception):
    """An input block turned out ineligible mid-stream (no keys matrix,
    unexpected width/schema); the engine aborts and tpu_compact takes
    the row path, as the reference does."""


def _abort_pipeline(encode_pool, enc_q, cutter: "_BlockCutter",
                    w: SstWriter) -> None:
    """Tear down in-flight pipeline stages BEFORE aborting the file:
    encode jobs still running would hand new blocks to the writer after
    the abort, reopening (and leaking) the just-unlinked .tmp.  Their
    errors are dropped: the caller re-raises the one that aborted."""
    while enc_q:
        try:
            enc_q.popleft().result()
        except Exception:   # noqa: BLE001 — superseded by the abort cause
            pass
    if encode_pool is not None:
        encode_pool.shutdown(wait=True)
    while cutter._pending:
        try:
            cutter._pending.popleft().result()
        except Exception:   # noqa: BLE001 — superseded by the abort cause
            pass
    w.abort()


class _ActiveBlock:
    """One decoded input block being merged: source arrays + the cursor
    of the first row not yet emitted."""

    __slots__ = ("cb", "keys", "dk_words", "vstarts", "heaps", "cursor")

    def __init__(self, cb: ColumnarBlock):
        self.cb = cb
        self.keys = cb.keys
        self.cursor = 0
        self.dk_words = keys_to_words(cb.keys[:, :-_HT_SUFFIX])
        # varlen per-row start offsets + heap as an indexable array
        self.vstarts = {}
        self.heaps = {}
        for cid, (ends, heap, _null) in cb.varlen.items():
            e = ends.astype(np.int64)
            self.vstarts[cid] = (np.concatenate([[0], e[:-1]]), e)
            self.heaps[cid] = (heap if isinstance(heap, np.ndarray)
                               else np.frombuffer(heap, np.uint8))

    @property
    def n(self) -> int:
        return self.cb.n

    def key_at(self, i: int) -> bytes:
        return self.keys[i].tobytes()


def _decode_planned(reader: SstReader, idx: int, key_width: int,
                    schema_version: Optional[int]) -> _ActiveBlock:
    """Decode-ahead worker: deserialize one columnar block and validate
    the chunked engine's preconditions."""
    cb = reader.read_columnar(idx)
    if cb is None or cb.keys is None:
        raise _ChunkFallback(f"{reader.path}: block {idx} not columnar")
    if cb.keys.shape[1] != key_width:
        raise _ChunkFallback(f"{reader.path}: block {idx} key width "
                             f"{cb.keys.shape[1]} != {key_width}")
    if schema_version is not None and cb.schema_version != schema_version:
        raise _ChunkFallback(f"{reader.path}: block {idx} schema version "
                             f"{cb.schema_version} != {schema_version}")
    check_ht_suffix(cb.keys)        # raises KeySuffixError
    return _ActiveBlock(cb)


class _BlockCutter:
    """Output side of the pipeline: buffers gathered chunk pieces, cuts
    exact `block_rows`-sized ColumnarBlocks, and streams them to the
    writer thread (at most three writes in flight, so a slow disk cannot
    buffer the whole output in memory)."""

    def __init__(self, writer: SstWriter, pool: ThreadPoolExecutor,
                 block_rows: int):
        self.w = writer
        self.pool = pool
        self.block_rows = block_rows
        self.pieces: deque = deque()         # gathered chunk pieces
        self.adjs: deque = deque()           # per-row "differs from prev"
        self.buffered = 0
        self._last_dk: Optional[np.ndarray] = None
        self._pending: deque = deque()
        self.write_wait_s = 0.0

    def add(self, piece: ColumnarBlock) -> None:
        if piece.n == 0:
            return
        dk = piece.keys[:, :-_HT_SUFFIX]
        adj = np.empty(piece.n, bool)
        adj[0] = (self._last_dk is None) or bool((dk[0] != self._last_dk).any())
        if piece.n > 1:
            adj[1:] = (dk[1:] != dk[:-1]).any(axis=1)
        self._last_dk = dk[-1].copy()
        self.pieces.append(piece)
        self.adjs.append(adj)
        self.buffered += piece.n
        if self.buffered >= self.block_rows:
            self._cut(final=False)

    def _submit(self, blk: ColumnarBlock) -> None:
        while len(self._pending) >= 3:
            t0 = time.perf_counter()
            self._pending.popleft().result()
            self.write_wait_s += time.perf_counter() - t0
        self._pending.append(self.pool.submit(self.w.add_columnar_block, blk))

    def _cut(self, final: bool) -> None:
        """Pop exact block_rows-sized output blocks off the piece queue.
        A block wholly inside one piece is a zero-copy slice view; only
        blocks spanning a piece boundary concatenate."""
        while self.buffered >= self.block_rows or (final and self.buffered):
            need = min(self.block_rows, self.buffered)
            parts: List[ColumnarBlock] = []
            aparts: List[np.ndarray] = []
            while need:
                p0, a0 = self.pieces[0], self.adjs[0]
                take = min(need, p0.n)
                parts.append(p0 if take == p0.n else p0.slice(0, take))
                aparts.append(a0[:take])
                if take < p0.n:
                    self.pieces[0] = p0.slice(take, p0.n)
                    self.adjs[0] = a0[take:]
                else:
                    self.pieces.popleft()
                    self.adjs.popleft()
                need -= take
                self.buffered -= take
            blk = (parts[0] if len(parts) == 1
                   else ColumnarBlock.concat(parts))
            adj = (aparts[0] if len(aparts) == 1
                   else np.concatenate(aparts))
            # unique-keys contract matches the monolithic path: only
            # adjacent pairs INSIDE the block count
            blk.unique_keys = bool(adj[1:].all())
            self._submit(blk)

    def finish(self) -> None:
        self._cut(final=True)
        while self._pending:
            t0 = time.perf_counter()
            self._pending.popleft().result()
            self.write_wait_s += time.perf_counter() - t0


# --- host twins of the chunk merge (the reference's native backend) --------
# The reference's `native` backend (not ported: tpu_compact raises) merges
# each frontier on the host with these helpers; the tests use them as the
# host oracle of chunk_merge_kernel.
def _g(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Row gather `src[idx]` through the host library's GIL-free loop
    (numpy fancy indexing for inputs it does not take)."""
    out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    if not native_lib.gather_rows(src, idx, out):
        out[:] = src[idx]
    return out


def _gs(src: np.ndarray, src_idx: np.ndarray,
        dst: np.ndarray, dst_idx: np.ndarray) -> None:
    """Row gather-scatter `dst[dst_idx] = src[src_idx]` through the host
    library's GIL-free loop (numpy for inputs it does not take)."""
    if not native_lib.gather_scatter_rows(src, src_idx, dst, dst_idx):
        dst[dst_idx] = src[src_idx]


def _gather_seg_rows(key_segs, run_starts: np.ndarray,
                     positions: np.ndarray) -> np.ndarray:
    """Gather key rows at virtual-concatenation `positions` straight
    from the per-segment matrices into one [n, W] matrix, without ever
    building the concatenation; all segments move in one fused call."""
    n = len(positions)
    width = key_segs[0].shape[1]
    out = np.empty((n, width), np.uint8)
    seg_of = np.searchsorted(run_starts[1:], positions, side="right")
    local = positions - run_starts[seg_of]
    grp = np.argsort(seg_of, kind="stable")
    counts = np.bincount(seg_of, minlength=len(key_segs))
    bnd = np.concatenate([[0], np.cumsum(counts)])
    jobs = []
    for si, seg in enumerate(key_segs):
        dst = np.ascontiguousarray(grp[bnd[si]:bnd[si + 1]])
        if len(dst):
            jobs.append((seg, out, np.ascontiguousarray(local[dst]), dst))
    native_lib.gather_columns(jobs)
    return out


def _emit_count(seg_voids, bound_key: Optional[bytes], total_rows: int,
                vt: np.dtype) -> int:
    """Rows strictly below the bound, summed per sorted segment."""
    if bound_key is None:
        return total_rows
    bv = np.frombuffer(bound_key, vt)[0]
    return sum(int(np.searchsorted(v, bv, "left")) for v in seg_voids)


def _flag_carry_dup(dup: np.ndarray, first_key: bytes,
                    carry_key: Optional[bytes]) -> np.ndarray:
    """Mark the chunk's first sorted row as an exact duplicate when it
    equals the previous chunk's last emitted key."""
    if carry_key is not None and first_key == carry_key:
        dup = dup.copy()
        dup[0] = True
    return dup


def _retention_keep(dup: np.ndarray, ht_s: np.ndarray, leq: np.ndarray,
                    sorted_keys_fn, sorted_tomb_fn,
                    carry_key: Optional[bytes],
                    carry_leq: bool, cutoff: int) -> np.ndarray:
    """The MVCC keep mask over one sorted chunk on the host (the device
    twin lives in chunk_merge_kernel). `sorted_keys_fn()` /
    `sorted_tomb_fn()` lazily materialize the sorted key matrix /
    tombstone vector, only when something sits at or below the
    cutoff."""
    if not leq.any():
        return ~dup
    mat_s = sorted_keys_fn()
    rows = len(ht_s)
    dk_s = mat_s[:, :-_HT_SUFFIX]
    same_dockey = np.empty(rows, bool)
    if carry_key is not None:
        cdk = np.frombuffer(carry_key, np.uint8)[:-_HT_SUFFIX]
        same_dockey[0] = bool((dk_s[0] == cdk).all())
    else:
        same_dockey[0] = False
    same_dockey[1:] = (dk_s[1:] == dk_s[:-1]).all(axis=1)
    prev_leq = np.concatenate([[carry_leq], leq[:-1]])
    first_leq = leq & (~same_dockey | ~prev_leq)
    return ~dup & ((ht_s > np.uint64(cutoff))
                   | (first_leq & ~sorted_tomb_fn()))


def _compact_columnar_chunked(store, codec, inputs: Sequence[SstReader],
                              cutoff: int, block_rows: int,
                              device) -> str:
    """The pipelined chunked compaction driver (see module docstring).
    Returns the new SST path."""
    # --- plan: all input blocks, globally ordered by first key ----------
    plan: List[list] = []           # [first_key, rank, reader, idx, future]
    for rank, r in enumerate(inputs):
        for i, e in enumerate(r.index):
            plan.append([e.first_key, rank, r, i, None])
    plan.sort(key=lambda p: (p[0], p[1]))
    key_width = len(plan[0][0])
    dk_word_width = (key_width - _HT_SUFFIX + 7) // 8

    m_target = int(flags.get("compaction_chunk_rows"))
    m_cap = _pad_rows(max(m_target, block_rows))   # shared pow2 buckets

    stats = {"backend": "device", "device": str(device), "chunks": 0,
             "frontier_rows": 0, "emitted_rows": 0, "kept_rows": 0,
             "m_cap": m_cap, "m_growths": 0, "decode_wait_s": 0.0,
             "dispatch_s": 0.0, "merge_wait_s": 0.0, "gather_s": 0.0,
             "write_wait_s": 0.0,
             "fused_gather_calls": 0, "fused_gather_jobs": 0,
             "gather_fallback_calls": 0,
             "kernel_stats_before": kernel_cache_stats()}

    # pipeline width adapts to the machine: with 4+ cores the encode
    # stage gets its own worker (decode/merge/encode/write overlap); on
    # small hosts encode runs on the calling thread in the
    # dispatch->resolve gap and decode-ahead uses one worker.  The merge
    # stays on the calling thread and its current stream.
    path = store._new_sst_path()
    # incremental fsync from the write worker; key_builder lets the v2
    # writer drop derivable key matrices.  Made before any pool, so a
    # refusing writer leaves no thread behind.
    w = SstWriter(path, stream_columnar=True, sync_every_bytes=64 << 20,
                  key_builder=codec.derive_keys,
                  shred_cols=codec.shred_cols)
    ncpu = os.cpu_count() or 1
    encode_async = ncpu >= 4
    decode_pool = ThreadPoolExecutor(max_workers=2 if ncpu >= 4 else 1)
    write_pool = ThreadPoolExecutor(max_workers=1)
    encode_pool = (ThreadPoolExecutor(max_workers=1)
                   if encode_async else None)          # stage 3, ordered
    cutter = _BlockCutter(w, write_pool, block_rows)

    active: List[_ActiveBlock] = []
    plan_pos = 0
    prefetch_pos = 0
    prefetch_rows = 0               # decoded-ahead rows beyond plan_pos
    schema_version: Optional[int] = None
    carry = None                    # (dk words, ht, wid, leq) of last emit
    col_spec = None                 # (sv, fixed_ids, pk_ids, varlen_ids)

    def top_up_prefetch():
        # 8x the frontier budget: when every run overlaps one chunk
        # activates a block from EACH run at once, so a narrow window
        # would serialize those decodes onto the merge path
        nonlocal prefetch_pos, prefetch_rows
        while prefetch_pos < len(plan) and prefetch_rows < 8 * m_cap:
            p = plan[prefetch_pos]
            p[4] = decode_pool.submit(_decode_planned, p[2], p[3],
                                      key_width, schema_version)
            prefetch_rows += p[2].index[p[3]].num_rows
            prefetch_pos += 1

    def activate_next() -> _ActiveBlock:
        nonlocal plan_pos, prefetch_rows, schema_version, col_spec
        p = plan[plan_pos]
        if p[4] is None:
            p[4] = decode_pool.submit(_decode_planned, p[2], p[3],
                                      key_width, schema_version)
        t0 = time.perf_counter()
        ab = p[4].result()
        stats["decode_wait_s"] += time.perf_counter() - t0
        p[4] = None
        prefetch_rows -= p[2].index[p[3]].num_rows
        plan_pos += 1
        if col_spec is None:
            cb = ab.cb
            schema_version = cb.schema_version
            col_spec = (cb.schema_version, list(cb.fixed.keys()),
                        list(cb.pk.keys()), list(cb.varlen.keys()))
        elif ab.cb.schema_version != col_spec[0]:
            # blocks prefetched before the first activation skip the
            # in-worker schema check; re-validate here
            raise _ChunkFallback(
                f"mixed schema versions: {ab.cb.schema_version} "
                f"!= {col_spec[0]}")
        top_up_prefetch()
        return ab

    def _fair_alloc(m_cap_now: int) -> List[int]:
        """Water-fill the row budget across active blocks: every block
        gets an equal share, shares unused by short blocks redistribute
        (each run advances in step, so the bound cuts near the top of
        everyone's pull)."""
        rem = [ab.n - ab.cursor for ab in active]
        alloc = [0] * len(rem)
        budget = m_cap_now
        unsat = list(range(len(rem)))
        while budget > 0 and unsat:
            fair = max(1, budget // len(unsat))
            nxt = []
            for i in unsat:
                if budget <= 0:
                    break
                give = min(rem[i] - alloc[i], fair, budget)
                alloc[i] += give
                budget -= give
                if alloc[i] < rem[i]:
                    nxt.append(i)
            unsat = nxt
        return alloc

    def fill_frontier(m_cap_now: int):
        """Assemble one frontier. Returns (segs, rows, seg_starts,
        seg_lo, bound_key_bytes, buffers) — buffers are fresh arrays, so
        the device merge can read them while the next chunk fills.

        Activation rule: keep pulling planned blocks while the next
        block's first key is BELOW the bound the current active set
        would produce; blocks wholly above the bound stay unpulled and
        merely contribute the bound candidate."""
        while plan_pos < len(plan):
            if not active:
                active.append(activate_next())
                continue
            fair = max(1, m_cap_now // (len(active) + 1))
            cands = [ab.key_at(ab.cursor + fair)
                     for ab in active if ab.cursor + fair < ab.n]
            if cands and plan[plan_pos][0] >= min(cands):
                break
            active.append(activate_next())
        alloc = _fair_alloc(m_cap_now)
        segs: List[Tuple[_ActiveBlock, int, int]] = []
        rows = 0
        bound_cands: List[bytes] = []
        for ab, take in zip(active, alloc):
            if take <= 0:
                bound_cands.append(ab.key_at(ab.cursor))
                continue
            segs.append((ab, ab.cursor, ab.cursor + take))
            rows += take
            if ab.cursor + take < ab.n:
                bound_cands.append(ab.key_at(ab.cursor + take))
        if plan_pos < len(plan):
            bound_cands.append(plan[plan_pos][0])
        bound = min(bound_cands) if bound_cands else None
        seg_starts = np.zeros(len(segs) + 1, np.int64)
        for si, (_ab, lo, hi) in enumerate(segs):
            seg_starts[si + 1] = seg_starts[si] + (hi - lo)
        seg_lo = np.asarray([lo for _ab, lo, _hi in segs], np.int64)
        ht_b = np.zeros(m_cap_now, np.uint64)
        wid_b = np.zeros_like(ht_b, dtype=np.uint32)
        tomb_b = np.zeros_like(ht_b, dtype=bool)
        dk_b = np.zeros((m_cap_now, dk_word_width), np.uint64)
        valid_b = np.zeros(m_cap_now, bool)
        valid_b[:rows] = True
        for si, (ab, lo, hi) in enumerate(segs):
            a, b = int(seg_starts[si]), int(seg_starts[si + 1])
            ht_b[a:b] = ab.cb.ht[lo:hi]
            wid_b[a:b] = ab.cb.write_id[lo:hi]
            tomb_b[a:b] = ab.cb.tombstone[lo:hi]
            dk_b[a:b] = ab.dk_words[lo:hi]
        return (segs, rows, seg_starts, seg_lo, bound,
                (dk_b, ht_b, wid_b, tomb_b, valid_b))

    def dispatch(fr):
        t0 = time.perf_counter()
        _segs, _rows, _seg_starts, _seg_lo, bound, bufs = fr
        dk_b, ht_b, wid_b, tomb_b, valid_b = bufs
        bound_split = None
        if bound is not None:
            bk = np.frombuffer(bound, np.uint8)[None, :]
            bdk, bht, bwid = split_ht_suffix(bk)
            bound_split = (keys_to_words(bdk)[0], int(bht[0]),
                           int(bwid[0]))
        handle = merge_frontier(dk_b, ht_b, wid_b, tomb_b, valid_b,
                                bound_split, carry, cutoff, device)
        stats["dispatch_s"] += time.perf_counter() - t0
        return handle

    def resolve(handle):
        # the one place the merge's results come back to the host
        t0 = time.perf_counter()
        order_t, emit_t, keep_t = handle
        order = order_t.cpu().numpy().astype(np.int64)
        emit = emit_t.cpu().numpy()
        keep = keep_t.cpu().numpy()
        n_emit = int(np.count_nonzero(emit))
        stats["merge_wait_s"] += time.perf_counter() - t0
        return order, n_emit, keep

    def gather_chunk(fr, order, n_emit, keep, seg_of):
        """Stage 3 (encode worker): gather emitted+kept rows from their
        source blocks into one output piece, in merged order, and hand
        it to the block cutter."""
        t0 = time.perf_counter()
        segs, _rows, seg_starts, seg_lo, _bound, _bufs = fr
        ord_e = order[:n_emit]
        keep_e = keep[:n_emit]
        local = ord_e - seg_starts[seg_of] + seg_lo[seg_of]
        kept = np.nonzero(keep_e)[0]
        n_keep = len(kept)
        kseg = seg_of[kept]
        klocal = local[kept]
        sv, fixed_ids, pk_ids, varlen_ids = col_spec
        piece = None
        if n_keep:
            key_hash = np.empty(n_keep, np.uint64)
            ht_o = np.empty(n_keep, np.uint64)
            wid_o = np.empty(n_keep, np.uint32)
            tomb_o = np.empty(n_keep, bool)
            keys_o = np.empty((n_keep, key_width), np.uint8)
            pk_o = {}
            fixed_o = {}
            varlen_lens = {cid: np.zeros(n_keep, np.int64)
                           for cid in varlen_ids}
            varlen_null = {cid: np.empty(n_keep, bool)
                           for cid in varlen_ids}
            grp = np.argsort(kseg, kind="stable")
            counts = np.bincount(kseg, minlength=len(segs))
            bnd = np.concatenate([[0], np.cumsum(counts)])
            for cid in pk_ids:
                arr = segs[0][0].cb.pk[cid]
                pk_o[cid] = np.empty(n_keep, arr.dtype)
            for cid in fixed_ids:
                vals, _nulls = segs[0][0].cb.fixed[cid]
                fixed_o[cid] = (np.empty(n_keep, vals.dtype),
                                np.empty(n_keep, bool))
            # ONE fused GIL-free call moves every lane of every segment
            # (key_hash, MVCC lanes, keys matrix, pk + fixed columns)
            jobs = []
            seg_src: List[Optional[np.ndarray]] = []
            seg_dst: List[Optional[np.ndarray]] = []
            for si, (ab, _lo, _hi) in enumerate(segs):
                dst = np.ascontiguousarray(grp[bnd[si]:bnd[si + 1]])
                if not len(dst):
                    seg_src.append(None)
                    seg_dst.append(None)
                    continue
                src = np.ascontiguousarray(klocal[dst])
                seg_src.append(src)
                seg_dst.append(dst)
                cb = ab.cb
                jobs.append((cb.key_hash, key_hash, src, dst))
                jobs.append((cb.ht, ht_o, src, dst))
                jobs.append((cb.write_id, wid_o, src, dst))
                jobs.append((cb.tombstone, tomb_o, src, dst))
                jobs.append((ab.keys, keys_o, src, dst))
                for cid in pk_ids:
                    jobs.append((cb.pk[cid], pk_o[cid], src, dst))
                for cid in fixed_ids:
                    vals, nulls = cb.fixed[cid]
                    jobs.append((vals, fixed_o[cid][0], src, dst))
                    jobs.append((nulls, fixed_o[cid][1], src, dst))
            if native_lib.gather_multi(jobs):
                stats["fused_gather_calls"] += 1
                stats["fused_gather_jobs"] += len(jobs)
            else:
                stats["gather_fallback_calls"] += 1
                native_lib.gather_multi_fallback(jobs)
            for si, (ab, _lo, _hi) in enumerate(segs):
                src, dst = seg_src[si], seg_dst[si]
                if src is None:
                    continue
                cb = ab.cb
                for cid in varlen_ids:
                    _ends, _heap, null = cb.varlen[cid]
                    starts, ends = ab.vstarts[cid]
                    nl = null[src]
                    varlen_null[cid][dst] = nl
                    varlen_lens[cid][dst] = np.where(
                        nl, 0, ends[src] - starts[src])
            varlen_o = {}
            for cid in varlen_ids:
                lens = varlen_lens[cid]
                out_ends = np.cumsum(lens)
                out_starts = out_ends - lens
                total = int(out_ends[-1])
                heap_o = np.empty(total, np.uint8)
                for si, (ab, _lo, _hi) in enumerate(segs):
                    dst = seg_dst[si]
                    if dst is None:
                        continue
                    src = seg_src[si]
                    l_arr = np.ascontiguousarray(lens[dst])
                    if not int(l_arr.sum()):
                        continue
                    starts, _ends = ab.vstarts[cid]
                    ss = np.ascontiguousarray(starts[src])
                    ds_ = np.ascontiguousarray(out_starts[dst])
                    if not native_lib.gather_heap(ab.heaps[cid], ss, ds_,
                                                  l_arr, heap_o):
                        native_lib.gather_heap_fallback(
                            ab.heaps[cid], ss, ds_, l_arr, heap_o)
                varlen_o[cid] = (out_ends.astype(np.uint32),
                                 heap_o.tobytes(), varlen_null[cid])
            piece = ColumnarBlock.from_arrays(
                schema_version=sv, key_hash=key_hash, ht=ht_o,
                write_id=wid_o, pk=pk_o, fixed=fixed_o, varlen=varlen_o,
                tombstone=tomb_o, keys=keys_o, unique_keys=False)
            # derivability is row-wise, so a gather from all-proven
            # source blocks is itself proven
            piece.keys_proven = all(ab.cb.keys_proven
                                    for ab, _lo, _hi in segs)
        stats["gather_s"] += time.perf_counter() - t0
        stats["kept_rows"] += n_keep
        if piece is not None:
            cutter.add(piece)

    def advance(fr, ord_e, seg_of, counts):
        """Move block cursors past the emitted prefix, release finished
        blocks, and compute the next chunk's MVCC carry."""
        nonlocal carry
        segs, _rows, seg_starts, seg_lo, _bound, _bufs = fr
        if not len(ord_e):
            return
        for si, (ab, _lo, _hi) in enumerate(segs):
            ab.cursor += int(counts[si])
        active[:] = [ab for ab in active if ab.cursor < ab.n]
        last = int(ord_e[-1])
        si = int(seg_of[-1])
        ab = segs[si][0]
        li = last - int(seg_starts[si]) + int(seg_lo[si])
        ht_last = int(ab.cb.ht[li])
        carry = (ab.dk_words[li].copy(), ht_last,
                 int(ab.cb.write_id[li]), ht_last <= cutoff)

    enc_q: deque = deque()          # in-flight stage-3 gathers, FIFO
    try:
        top_up_prefetch()
        prev = None                 # pending gather args (sync mode)
        while active or plan_pos < len(plan):
            fr = fill_frontier(m_cap)
            handle = dispatch(fr)
            if prev is not None:
                # sync mode: gather chunk i-1 here, overlapping the
                # device merging chunk i
                gather_chunk(*prev)
                prev = None
            order, n_emit, keep = resolve(handle)
            while n_emit == 0:
                # pathological frontier: every pulled row sits at or
                # above the bound. Double the budget (a new shape
                # bucket) and retry — with no unpulled blocks left the
                # bound disappears and the chunk must emit.
                m_cap = m_cap * 2
                stats["m_growths"] += 1
                stats["m_cap"] = m_cap
                fr = fill_frontier(m_cap)
                order, n_emit, keep = resolve(dispatch(fr))
            stats["chunks"] += 1
            stats["frontier_rows"] += fr[1]
            stats["emitted_rows"] += n_emit
            # emit-prefix segmentation, computed ONCE per chunk and
            # shared by advance() and gather_chunk()
            ord_e = order[:n_emit]
            seg_of_e = np.searchsorted(fr[2][1:], ord_e, side="right")
            counts_e = np.bincount(seg_of_e, minlength=len(fr[0]))
            advance(fr, ord_e, seg_of_e, counts_e)
            if encode_async:
                while len(enc_q) >= 2:  # backpressure: <= 2 in flight
                    enc_q.popleft().result()
                enc_q.append(encode_pool.submit(
                    gather_chunk, fr, order, n_emit, keep, seg_of_e))
            else:
                prev = (fr, order, n_emit, keep, seg_of_e)
        if encode_async:
            while enc_q:
                enc_q.popleft().result()
            encode_pool.submit(cutter.finish).result()
        else:
            if prev is not None:
                gather_chunk(*prev)
            cutter.finish()
        w.set_frontier(**_merge_frontier(inputs))
        w.finish()
    except _ChunkFallback:
        _abort_pipeline(encode_pool, enc_q, cutter, w)
        return None       # tpu_compact takes the row path
    except BaseException:
        _abort_pipeline(encode_pool, enc_q, cutter, w)
        raise
    finally:
        decode_pool.shutdown(wait=True)
        if encode_pool is not None:
            encode_pool.shutdown(wait=True)
        write_pool.shutdown(wait=True)
        after = kernel_cache_stats()
        before = stats.pop("kernel_stats_before")
        stats["kernel_compiles"] = after["compiles"] - before["compiles"]
        stats["kernel_calls"] = after["calls"] - before["calls"]
        stats["kernel_cache_hits"] = (after["cache_hits"]
                                      - before["cache_hits"])
        stats["write_wait_s"] = cutter.write_wait_s
        stats["lanes"] = w.lane_stats.get("lanes", {})
        try:
            stats["output_bytes"] = os.path.getsize(path)
        except OSError:
            stats["output_bytes"] = 0
        LAST_COMPACTION_STATS.clear()
        LAST_COMPACTION_STATS.update(stats)
    store.replace_ssts(inputs, path)
    return path


def _merge_frontier(inputs) -> dict:
    frontier = {}
    for r in inputs:
        op = r.frontier.get("op_id")
        if op is not None and ("op_id" not in frontier
                               or op > frontier["op_id"]):
            frontier["op_id"] = op
    return frontier


def _compact_rows(store, codec, inputs, cutoff: int, device) -> str:
    """The row route: every entry materialized, merge + GC on `device`
    (ops/compaction.py merge_gc_split_kernel), the kept rows written
    through the codec's columnar builder.  TTL-wrapped values
    (kMergeFlags) never get a columnar sidecar, so every TTL'd row
    compacts here, and this path carries the CPU feed's TTL-expiry
    retention term: the surviving first-version-at-or-below-cutoff row
    is still dropped when its expiry is at or before the cutoff."""
    entries: List[Tuple[bytes, bytes]] = []
    for r in inputs:
        entries.extend(r.iterate())
    if not entries:
        path = store._new_sst_path()
        SstWriter(path, columnar_builder=codec.columnar_builder,
                  shred_cols=codec.shred_cols).finish()
        store.replace_ssts(inputs, path)
        return path
    lens = [len(k) for k, _ in entries]
    tomb = np.fromiter((v[0] == ValueKind.kTombstone for _, v in entries),
                       bool, len(entries))
    expire = np.fromiter(((unwrap_ttl(v)[1] or 0) for _, v in entries),
                         np.uint64, len(entries))
    if len(set(lens)) == 1:
        keys_mat = np.frombuffer(b"".join(k for k, _ in entries),
                                 np.uint8).reshape(len(entries), lens[0])
        runs = [(keys_mat, tomb)]
    else:
        runs = [(np.frombuffer(k, np.uint8)[None, :], tomb[i:i + 1])
                for i, (k, _) in enumerate(entries)]
    order, keep = compact_runs(runs, cutoff, device=device)
    sel = order[keep]
    if len(sel) and expire.any():
        # TTL-expiry retention term, decoding the hybrid time only of
        # kept rows whose envelope expired at or before the cutoff
        exp_sel = expire[sel]
        maybe = (exp_sel != 0) & (exp_sel <= np.uint64(cutoff))
        if maybe.any():
            ht_sel = np.fromiter(
                (DocHybridTime.decode_desc(
                    entries[int(i)][0][-ENCODED_SIZE:]).ht.value
                 if m else 0
                 for i, m in zip(sel, maybe)), np.uint64, len(sel))
            sel = sel[~(maybe & (ht_sel <= np.uint64(cutoff)))]
    path = store._new_sst_path()
    w = SstWriter(path, columnar_builder=codec.columnar_builder,
                  shred_cols=codec.shred_cols)
    for i in sel:
        w.add(*entries[int(i)])
    w.set_frontier(**_merge_frontier(inputs))
    w.finish()
    store.replace_ssts(inputs, path)
    return path
