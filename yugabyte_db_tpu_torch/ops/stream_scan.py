"""Streaming pow2-chunk scan — cold scans without one monolithic batch.

Counterpart of ``yugabyte_db_tpu/ops/stream_scan.py``.  The block list
is cut into chunks of consecutive whole blocks (~``streaming_chunk_rows``
rows, padded to ONE shared pow2 bucket, so every chunk hits one kernel
signature), and a :class:`storage.pipeline.StreamPipeline` forms chunk
k+1's batch on a worker thread while chunk k's kernels run.  Per-chunk
partials combine on the host (sum/count add, min/max take NaN-
propagating elementwise extremes, in the partials' own dtypes): each
chunk's fixed-point sums are rescaled before the combine, so chunk
boundaries never change the accumulation contract.

MVCC bounds what may stream: with a read point, a doc key's versions
must not span a chunk boundary.  ``chunk_safe_mvcc`` proves the
sufficient condition (every block unique-keyed with a key matrix, block
boundary doc keys strictly ascending) that holds for a bulk load or a
compacted run.

Zone-map pruning skips whole blocks whose v2 min/max maps prove the
WHERE cannot match, before any batch formation — sound exactly when
each doc key lives in one block (chunk-safe over the FULL list) or when
there is no read point.  A ``prefilter`` (the bypass reader's near-data
pass, bypass/prefilter.py) compacts each chunk's rows before its batch
forms; the batch still pads to the unfiltered bucket and takes its
static-scale bounds from the unfiltered chunk, so results keep their
bits.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike
from ..docdb.operations import Unrewritable, rewrite_where_and_aggs
from ..storage.columnar import KEY_REBUILD_STATS, ColumnarBlock
from ..storage.pipeline import StreamPipeline
from ..utils import flags
from ..utils.hybrid_time import ENCODED_SIZE
from .device_batch import bucket_rows, build_batch
from .grouped_scan import (LAST_GROUPED_STATS, DictGroupSpec,
                           dict_cols_needed, domain_product, make_dict_plan,
                           resolve_group)
from .scan import (AggSpec, HashGroupSpec, ScanKernel, _expand_avg,
                   default_kernel, zone_prune_blocks)

_HT_SUFFIX = ENCODED_SIZE + 1   # DocHybridTime suffix + kHybridTime marker

#: stats of the most recent streaming scan (informational)
LAST_STREAM_STATS: dict = {}


def plan_chunks(blocks: Sequence[ColumnarBlock],
                chunk_rows: int) -> List[List[ColumnarBlock]]:
    """Cut the block list into runs of consecutive WHOLE blocks of
    ~chunk_rows rows."""
    chunks: List[List[ColumnarBlock]] = []
    cur: List[ColumnarBlock] = []
    rows = 0
    for b in blocks:
        cur.append(b)
        rows += b.n
        if rows >= chunk_rows:
            chunks.append(cur)
            cur, rows = [], 0
    if cur:
        chunks.append(cur)
    return chunks


def chunk_safe_mvcc(blocks: Sequence[ColumnarBlock]) -> bool:
    """True when chunking at any block boundary preserves MVCC
    semantics: every block is internally unique-keyed and carries its
    boundary keys, and the boundary doc keys ascend strictly across the
    whole sequence (one globally sorted disjoint run: a second
    overlapping run or an overlay breaks it), so the newest visible
    version of a key never needs two chunks."""
    prev_last: Optional[bytes] = None
    for b in blocks:
        if not b.unique_keys or b.n == 0:
            return False
        first, last = b.boundary_keys(materialize=False)
        if first is None or last is None or len(first) <= _HT_SUFFIX:
            return False
        first_dk = first[:-_HT_SUFFIX]
        if prev_last is not None and prev_last >= first_dk:
            return False
        prev_last = last[:-_HT_SUFFIX]
    return True


def _combine(aggs: Tuple[AggSpec, ...], acc: Optional[list],
             new: Sequence) -> list:
    if acc is None:
        return [np.asarray(o) for o in new]
    for i, a in enumerate(aggs):
        if a.op in ("sum", "count"):
            acc[i] = acc[i] + np.asarray(new[i])
        elif a.op == "min":
            acc[i] = np.minimum(acc[i], np.asarray(new[i]))
        elif a.op == "max":
            acc[i] = np.maximum(acc[i], np.asarray(new[i]))
        else:   # pragma: no cover — _expand_avg leaves only these four
            raise ValueError(a.op)
    return acc


def group_domain_ok(group, dicts) -> bool:
    """Every dict-group column carries a scan-global dictionary and the
    slot-id arithmetic stays inside int32.  Other groups pass."""
    if not isinstance(group, DictGroupSpec):
        return True
    if any(c not in dicts for c in group.cols):
        return False
    return domain_product(group, dicts) < 2 ** 31


def _plan_dict_columns(blocks, columns, where, aggs, group):
    """Scan-global dictionary plan + string-predicate rewrite.  Returns
    ``(plan, where, aggs, ok)``: plan None when no column needs
    dictionary form; ok False when the scan can't stream (no columnar
    form, an over-wide group domain, or a string column outside a
    rewritable predicate)."""
    dcids = dict_cols_needed(blocks, columns)
    if dcids is None:
        return None, where, aggs, False
    if isinstance(group, DictGroupSpec):
        if not flags.get("grouped_pushdown_enabled"):
            return None, where, aggs, False
        for cid in group.cols:
            if not all(cid in b.varlen for b in blocks):
                return None, where, aggs, False
        dcids = sorted(set(dcids) | set(group.cols))
    if not dcids:
        return None, where, aggs, True
    plan = make_dict_plan(blocks, dcids)
    if plan is None:
        return None, where, aggs, False
    if not group_domain_ok(group, plan.dicts):
        return None, where, aggs, False
    try:
        where, aggs = rewrite_where_and_aggs(where, aggs, plan.dicts)
    except Unrewritable:
        return None, where, aggs, False
    return plan, where, aggs, True


def _chunk_builder(chunks, cols_sorted, bucket, plan, device, cache,
                   cache_key, chunk_rows, prune_sig=(), prefilter=None,
                   pf_stats=None):
    dict_sig = (("dict",) + plan.identity) if plan is not None else ()

    def build(ci):
        chunk = chunks[ci]
        if prefilter is not None:
            kept = prefilter(chunk)
            pf_stats["rows_in"] += sum(b.n for b in chunk)
            pf_stats["rows_kept"] += sum(b.n for b in kept)
            return build_batch(kept, cols_sorted, device=device,
                               pad_to=bucket, bounds_blocks=chunk)
        if cache is not None and cache_key is not None:
            # the chunk plan (target rows + bucket), the kept-block set
            # of a zone prune and the dictionary identity are part of
            # the key: batches cached under another plan, predicate or
            # dictionary must never serve this one
            return cache.get_or_build(
                cache_key + ("chunk", chunk_rows, bucket, ci) + prune_sig
                + dict_sig,
                lambda: build_batch(chunk, cols_sorted, device=device,
                                    pad_to=bucket, dict_plan=plan))
        return build_batch(chunk, cols_sorted, device=device,
                           pad_to=bucket, dict_plan=plan)
    return build


def _zone_prune(blocks, where, read_ht, chunk_safe):
    """(blocks, pruned count, prune signature) after zone-map pruning,
    when the flag is on and pruning is sound: no read point, or every
    doc key inside one block (chunk-safe over the full list)."""
    if where is None or not flags.get("zone_map_pruning") \
            or (read_ht is not None and not chunk_safe):
        return blocks, 0, ()
    kept, kept_idx = zone_prune_blocks(blocks, where)
    pruned = len(blocks) - len(kept)
    if not pruned:
        return blocks, 0, ()
    return kept, pruned, ("zp", kept_idx)


def streaming_scan_aggregate(
        blocks: Sequence[ColumnarBlock], columns: Sequence[int],
        where: Optional[tuple], aggs: Sequence[AggSpec],
        group=None, read_ht: Optional[int] = None,
        kernel: Optional[ScanKernel] = None,
        chunk_rows: Optional[int] = None,
        cache=None, cache_key: Optional[tuple] = None,
        min_chunks: int = 3, prefilter=None,
        grouped_out: Optional[dict] = None,
        dict_out: Optional[dict] = None,
        device: DeviceLike = "cuda"):
    """Chunked scan-aggregate over `blocks` on `kernel`'s device (else
    `device`).

    Returns ``(agg_values, counts)`` — the shapes of
    ``ScanKernel.run(...)[:2]`` — or None when the scan isn't streamable
    (the caller uses one monolithic batch):
      - a HashGroupSpec (per-chunk group sets can't combine densely),
      - a needed column with no columnar/dictionary form, or a string
        column outside a rewritable predicate,
      - a DictGroupSpec while ``grouped_pushdown_enabled`` is off,
      - a read point over blocks that aren't provably chunk-safe,
      - fewer than `min_chunks` chunks.

    String columns stream through one scan-global dictionary plan, so
    string predicates run as code compares and a DictGroupSpec
    aggregates into slot arrays shared by every chunk.  For a
    dict-grouped scan ``grouped_out`` receives ``{"spill", "dicts",
    "num_slots", "plan", "blocks"}``: nonzero spill means the slot
    budget overflowed and the result must be discarded.  ``dict_out``
    receives the dictionaries dict-code MIN/MAX results are coded in.

    Zone-map pruning (flag ``zone_map_pruning``) drops blocks first;
    ``min_chunks`` then guards only an unpruned scan.

    `cache`/`cache_key`: an optional DeviceBlockCache; chunk batches
    land under ``cache_key + ("chunk", ...)``.  `prefilter`: optional
    callable(chunk blocks) -> compacted blocks (bypass/prefilter.py);
    dropped when a dictionary plan exists (compacted blocks carry no
    remap entries), and exclusive with the cache.
    """
    if isinstance(group, HashGroupSpec):
        return None
    dict_group = isinstance(group, DictGroupSpec)
    plan, where, aggs, ok = _plan_dict_columns(blocks, columns, where,
                                               aggs, group)
    if not ok or (dict_group and plan is None):
        return None
    if plan is not None:
        prefilter = None    # compacted blocks have no remap entries
        if dict_out is not None:
            dict_out["dicts"] = plan.dicts
    chunk_safe = chunk_safe_mvcc(blocks)
    if read_ht is not None and not chunk_safe:
        return None
    blocks, pruned, prune_sig = _zone_prune(blocks, where, read_ht,
                                            chunk_safe)
    chunk_rows = chunk_rows or int(flags.get("streaming_chunk_rows"))
    chunks = plan_chunks(blocks, chunk_rows)
    if len(chunks) < min_chunks and not pruned:
        # once zone maps dropped blocks, streaming the remainder beats
        # the monolithic batch, which would rebuild it anyway
        return None
    kernel = kernel or default_kernel(device)
    aggs = tuple(_expand_avg(aggs))
    # one shared pow2 bucket: every chunk reuses one kernel signature
    bucket = bucket_rows(max(max(sum(b.n for b in c) for c in chunks), 1))
    pf_stats = {"rows_in": 0, "rows_kept": 0}
    build = _chunk_builder(chunks, sorted(columns), bucket, plan,
                           kernel.device, cache, cache_key, chunk_rows,
                           prune_sig, prefilter, pf_stats)
    pipe = StreamPipeline([build], depth=2, name="stream-scan")
    rebuilds0 = KEY_REBUILD_STATS["rebuilds"]
    acc = None
    counts_acc = None
    spill_acc = 0
    kernel_s = 0.0
    combine_s = 0.0
    for batch in pipe.run(range(len(chunks))):
        t0 = time.perf_counter()
        if dict_group:
            outs, counts, _, spill = kernel.run(batch, where, aggs, group,
                                                read_ht)
            spill_acc += int(spill)
        else:
            outs, counts, _ = kernel.run(batch, where, aggs, group,
                                         read_ht)
        kernel_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        acc = _combine(aggs, acc, outs)
        counts = np.asarray(counts.cpu() if hasattr(counts, "cpu")
                            else counts)
        counts_acc = counts if counts_acc is None else counts_acc + counts
        combine_s += time.perf_counter() - t0
    LAST_STREAM_STATS.clear()
    LAST_STREAM_STATS.update({
        "chunks": len(chunks), "bucket_rows": bucket,
        "zone_blocks_pruned": pruned,
        "zone_blocks_total": len(blocks) + pruned,
        # lazy key-matrix rebuilds paid during this scan: the keyless
        # v2 contract keeps this at 0
        "key_rebuilds": KEY_REBUILD_STATS["rebuilds"] - rebuilds0,
        "prefilter_rows_in": pf_stats["rows_in"],
        "prefilter_rows_kept": pf_stats["rows_kept"],
        "build_s": round(pipe.stage_s[0], 4),
        "kernel_s": round(kernel_s, 4),
        "combine_s": round(combine_s, 4),
        "consumer_wait_s": round(pipe.wait_s, 4)})
    if dict_group:
        resolved, _ = resolve_group(group, plan.dicts)
        occupied = int(np.count_nonzero(
            np.asarray(counts_acc)[:resolved.num_slots - 1]))
        LAST_GROUPED_STATS.clear()
        LAST_GROUPED_STATS.update({
            "path": "streaming", "num_slots": resolved.num_slots,
            "slots_occupied": occupied, "spilled_rows": spill_acc,
            "dict_merge_s": round(plan.merge_s, 4),
            "kernel_s": round(kernel_s, 4),
            "combine_s": round(combine_s, 4)})
        if grouped_out is not None:
            grouped_out.update(spill=spill_acc, dicts=plan.dicts,
                               num_slots=resolved.num_slots, plan=plan,
                               blocks=list(blocks))
    elif plan is not None:
        LAST_STREAM_STATS["dict_merge_s"] = round(plan.merge_s, 4)
    return tuple(acc), counts_acc


def streaming_scan_filter(
        blocks: Sequence[ColumnarBlock], columns: Sequence[int],
        where: Optional[tuple], read_ht: Optional[int],
        materialize, limit: Optional[int] = None,
        kernel: Optional[ScanKernel] = None,
        chunk_rows: Optional[int] = None,
        cache=None, cache_key: Optional[tuple] = None,
        min_chunks: int = 2, device: DeviceLike = "cuda"):
    """Streamed filter-pushdown row path: per-chunk WHERE masks on the
    device while the next chunk's batch forms; matching rows materialize
    on the host per chunk through ``materialize(chunk_blocks,
    local_indices) -> rows``.

    Returns the accumulated row list, or None when the scan can't stream
    (same eligibility as the aggregate path).  ``limit``: stop once this
    many rows matched — the pipeline closes early."""
    plan, where, _, ok = _plan_dict_columns(blocks, columns, where, (),
                                            None)
    if not ok:
        return None
    chunk_safe = chunk_safe_mvcc(blocks)
    if read_ht is not None and not chunk_safe:
        return None
    blocks, pruned, prune_sig = _zone_prune(blocks, where, read_ht,
                                            chunk_safe)
    chunk_rows = chunk_rows or int(flags.get("streaming_chunk_rows"))
    chunks = plan_chunks(blocks, chunk_rows)
    if len(chunks) < min_chunks and not pruned:
        return None
    kernel = kernel or default_kernel(device)
    bucket = bucket_rows(max(max(sum(b.n for b in c) for c in chunks), 1))
    build = _chunk_builder(chunks, sorted(columns), bucket, plan,
                           kernel.device, cache, cache_key, chunk_rows,
                           prune_sig)
    pipe = StreamPipeline([lambda ci: (build(ci), chunks[ci])], depth=2,
                          name="stream-rows")
    rows: list = []
    kernel_s = 0.0
    chunks_run = 0
    rebuilds0 = KEY_REBUILD_STATS["rebuilds"]
    run = pipe.run(range(len(chunks)))
    try:
        for batch, chunk in run:
            t0 = time.perf_counter()
            _, _, mask = kernel.run(batch, where, (), None, read_ht)
            sel = np.nonzero(mask.cpu().numpy())[0]
            kernel_s += time.perf_counter() - t0
            chunks_run += 1
            if limit is not None and len(rows) + len(sel) > limit:
                sel = sel[:limit - len(rows)]
            rows.extend(materialize(chunk, sel))
            if limit is not None and len(rows) >= limit:
                break
    finally:
        run.close()     # early exit: tear the pipeline down cleanly
    LAST_STREAM_STATS.clear()
    LAST_STREAM_STATS.update({
        "chunks": len(chunks), "chunks_run": chunks_run,
        "bucket_rows": bucket, "rows_out": len(rows),
        "zone_blocks_pruned": pruned,
        "zone_blocks_total": len(blocks) + pruned,
        "key_rebuilds": KEY_REBUILD_STATS["rebuilds"] - rebuilds0,
        "prefilter_rows_in": 0, "prefilter_rows_kept": 0,
        "build_s": round(pipe.stage_s[0], 4),
        "kernel_s": round(kernel_s, 4),
        "consumer_wait_s": round(pipe.wait_s, 4)})
    return rows
