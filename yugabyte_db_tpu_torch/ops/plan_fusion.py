"""Fused plans — filter -> hash-join probe -> gather -> group -> aggregate.

Counterpart of ``yugabyte_db_tpu/ops/plan_fusion.py``, which traces the
whole plan shape into ONE jitted program per canonical plan signature
(expression shapes, aggregate list, group spec, join shape, MVCC mode,
pow2 row and table buckets, column dtypes).  Here the program is a torch
closure per signature, kept in :class:`FusedPlanKernel`'s cache with the
reference's accounting (a "compile" is a new cache entry): everything
data-dependent — predicate constants, the build tables' contents,
dictionary sizes, static SUM scales — arrives as run-time arguments, so
growth inside a bucket never adds an entry.

The pieces are reused, not re-implemented: the MVCC mask and the
group/aggregate tail are the scan kernel's own (ops/scan.py
``visibility_mask`` / ``masked_aggregate``), the probe is ops/join_scan.py
``probe_rows`` (the hand kernel csrc/join_probe.cu on the card, its plain
version on the CPU), and the dict-group decode and the cross-shard
combine are the scan path's.

Routes: :func:`streaming_plan_aggregate` mirrors the streamed scan
(pow2-chunk pipeline, shared bucket, chunk-safety gate, zone pruning,
device chunk cache); :func:`monolithic_plan_aggregate` mirrors the
monolithic batch path; the bypass route wraps both (bypass/scan.py).
:func:`fused_plan_cpu` is the numpy twin replaying the device
accumulation contract (dict strides, join matches, int64 fixed-point SUM
quantization).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils import flags
from .device_batch import (DeviceBatch, bucket_rows, build_batch,
                           flipped_i64_scalar)
from .expr import collect_constants, compile_expr, const_count, \
    expr_signature
from .grouped_scan import (DictGroupSpec, dict_cols_needed, make_dict_plan,
                           resolve_group)
from .join_scan import (BUILD_COL_BASE, JoinIneligible, JoinRuntime,
                        REASON_KEY_TYPE, REASON_PROBE_SHAPE, hash_join_cpu,
                        make_join_runtimes, probe_rows)
from .scan import (_U64_MAX, AggSpec, HashGroupSpec, _expand_avg, _np,
                   _group_strategy, _rescale_outs, _static_scales,
                   _sum_prep, _sum_prep_static, masked_aggregate,
                   visibility_mask)

#: process-wide fused-plan accounting: compiles/launches from the plan
#: cache, fallbacks tallied by the routing layers
PLAN_STATS = {"compiles": 0, "launches": 0, "cache_hits": 0,
              "fallbacks": 0}

#: stage split of the most recent fused-plan scan
LAST_PLAN_STATS: dict = {}


class FusedPlanKernel:
    """Signature-keyed cache of fused-plan programs for one device.

    ``sig_compiles`` maps each canonical plan signature (stringified, in
    order of first build) to its build count: 1 per signature across data
    growth and repeated runs."""

    def __init__(self, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self._cache: Dict[tuple, object] = {}
        self.compiles = 0
        self.launches = 0
        self.cache_hits = 0
        self.sig_compiles: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def _build(self, where_node, agg_specs, group, mvcc_mode,
               join_shape, static_sums, strategy):
        # cumulative const offsets: WHERE first, then each aggregate (the
        # shared-consts-list discipline of ops/scan._build_kernel)
        off = const_count(where_node) if where_node is not None else 0
        where_fn = compile_expr(where_node) if where_node is not None \
            else None
        agg_fns = []
        for a in agg_specs:
            if a.expr is None:
                agg_fns.append((a.op, None))
            else:
                agg_fns.append((a.op, compile_expr(a.expr, offset=off)))
                off += const_count(a.expr)
        static = static_sums or (False,) * len(agg_fns)

        def _prep(i, v, m, n_total, sum_scales):
            if static[i]:
                q, s = _sum_prep_static(v, m, sum_scales[i])
                return q, s, None
            return _sum_prep(v, m, n_total)

        def fn(cols, nulls, consts, valid, key_hash, ht, write_id,
               tombstone, read_ht, sum_scales, group_domains, joins):
            mask = visibility_mask(mvcc_mode, valid, key_hash, ht,
                                   write_id, tombstone, read_ht)
            if where_fn is not None:
                wv, wn = where_fn(cols, nulls, consts)
                mask = mask & wv
                if wn is not None:
                    mask = mask & torch.logical_not(wn)
            # --- N probe stages under ONE shared mask (inner semantics
            # per stage: NULL FKs never match).  A chain stage probes an
            # earlier stage's payload lane: its unmatched rows are
            # already masked AND null-flagged, so the gathered lanes of a
            # masked row never reach an aggregate.
            cols2 = dict(cols)
            nulls2 = dict(nulls)
            for stage, (table, pvals, pnulls) in zip(join_shape, joins):
                probe_col, num_slots, rows_pad, payload_meta = stage
                midx, mask = probe_rows(cols2[probe_col],
                                        nulls2.get(probe_col), mask,
                                        table, num_slots)
                matched = midx >= 0
                gidx = torch.clamp(midx, 0, rows_pad - 1).to(torch.int64)
                unmatched = torch.logical_not(matched)
                for (bid, _dt), pv, pu in zip(payload_meta, pvals, pnulls):
                    cols2[bid] = pv[gidx]
                    nulls2[bid] = pu[gidx] | unmatched
            return masked_aggregate(group, agg_fns, _prep, cols2, nulls2,
                                    consts, mask, group_domains,
                                    sum_scales, mask.shape[0], strategy)

        return fn

    # ------------------------------------------------------------------
    def run(self, batch: DeviceBatch, where, aggs: Sequence[AggSpec],
            group, read_ht: Optional[int], join_rt):
        """Run the fused plan over one probe batch.  ``join_rt`` is one
        JoinRuntime or an ordered sequence of them (the probe stages, in
        probe order).  Returns ``(agg_results, counts, mask)`` for flat
        aggregates or ``(agg_results, counts, mask, spill)`` for a
        DictGroupSpec — the ScanKernel.run shapes, so every downstream
        combine and decode path is shared."""
        if batch.device != self.device:
            raise ValueError(f"batch on {batch.device}, plan kernel for "
                             f"{self.device}")
        aggs = tuple(_expand_avg(aggs))
        if isinstance(group, HashGroupSpec):
            raise JoinIneligible(REASON_PROBE_SHAPE,
                                 "hash groups don't fuse")
        join_rts = ((join_rt,) if isinstance(join_rt, JoinRuntime)
                    else tuple(join_rt))
        # per-stage probe-lane eligibility: stage 0 probes a batch lane,
        # stage k may also probe an earlier stage's payload lane
        avail = {cid: v.dtype for cid, v in batch.cols.items()}
        for si, rt in enumerate(join_rts):
            dt = avail.get(rt.probe_col)
            if dt is None or dt.is_floating_point or dt.is_complex \
                    or dt == torch.bool:
                raise JoinIneligible(
                    REASON_KEY_TYPE,
                    f"probe column {rt.probe_col} is not an integer "
                    f"lane on device", stage=si)
            for bid, lane in zip(rt.build_cols, rt.to_device(self.device)[1]):
                avail[bid] = lane.dtype
        if read_ht is None:
            mvcc_mode = "none"
        elif batch.unique_keys:
            mvcc_mode = "visible"
        else:
            mvcc_mode = "dedup"
        consts: List = []
        if where is not None:
            collect_constants(where, consts)
        for a in aggs:
            if a.expr is not None:
                collect_constants(a.expr, consts)
        merged_dicts = dict(batch.dicts)
        bounds = dict(batch.col_bounds)
        dtype_cols = dict(batch.cols)
        for rt in join_rts:
            merged_dicts.update(rt.payload_dicts)
            bounds.update(rt.payload_bounds)
            dtype_cols.update(zip(rt.build_cols,
                                  rt.to_device(self.device)[1]))
        domain_args: tuple = ()
        resolved = group
        if isinstance(group, DictGroupSpec):
            resolved, domain_args = resolve_group(group, merged_dicts)
        static_sums, scale_args = _static_scales(
            aggs, bounds, batch.padded_rows, dtype_cols, self.device)
        strategy = _group_strategy(self.device)
        col_sig = tuple(sorted(
            (cid, str(v.dtype)) for cid, v in batch.cols.items()))
        join_shape = tuple(
            (rt.probe_col, rt.num_slots, rt.build_rows_pad,
             tuple((bid, str(rt.payload_vals[bid].dtype))
                   for bid in rt.build_cols))
            for rt in join_rts)
        # per-stage key parts beyond the shape tuple: the pow2 build
        # buckets and WHICH payload lanes are dict-coded
        build_buckets = tuple((rt.num_slots, rt.build_rows_pad)
                              for rt in join_rts)
        dict_sig = tuple(tuple(sorted(rt.payload_dicts))
                         for rt in join_rts)
        sig = (
            "plan",
            expr_signature(where) if where is not None else None,
            tuple(a.signature() for a in aggs),
            (type(resolved).__name__, resolved.cols,
             getattr(resolved, "num_slots",
                     getattr(resolved, "num_groups", None)))
            if resolved is not None else None,
            mvcc_mode, batch.padded_rows, col_sig, static_sums,
            strategy, join_shape, build_buckets, dict_sig,
        )
        fn = self._cache.get(sig)
        if fn is None:
            fn = self._build(where, aggs, resolved, mvcc_mode,
                             join_shape, static_sums, strategy)
            self._cache[sig] = fn
            self.compiles += 1
            PLAN_STATS["compiles"] += 1
            self.sig_compiles[repr(sig)] = \
                self.sig_compiles.get(repr(sig), 0) + 1
        else:
            self.cache_hits += 1
            PLAN_STATS["cache_hits"] += 1
        self.launches += 1
        PLAN_STATS["launches"] += 1
        n = batch.padded_rows
        dev = batch.device
        zeros_i64 = torch.zeros(n, dtype=torch.int64, device=dev)
        raw = fn(
            batch.cols, batch.nulls, list(consts), batch.valid,
            batch.key_hash if batch.key_hash is not None else zeros_i64,
            batch.ht if batch.ht is not None else zeros_i64,
            batch.write_id if batch.write_id is not None else zeros_i64,
            batch.tombstone if batch.tombstone is not None
            else torch.zeros(n, dtype=torch.bool, device=dev),
            torch.tensor(flipped_i64_scalar(
                read_ht if read_ht is not None else _U64_MAX),
                dtype=torch.int64, device=dev),
            scale_args, domain_args,
            tuple(rt.to_device(self.device) for rt in join_rts))
        return (_rescale_outs(raw[0], raw[1]),) + tuple(raw[2:])


#: one plan kernel per device for the module-level entry points
_DEFAULT_PLAN_KERNELS: Dict[torch.device, FusedPlanKernel] = {}


def default_plan_kernel(device: DeviceLike = "cuda") -> FusedPlanKernel:
    dev = resolve_device(device)
    k = _DEFAULT_PLAN_KERNELS.get(dev)
    if k is None:
        k = _DEFAULT_PLAN_KERNELS[dev] = FusedPlanKernel(dev)
    return k


# ---------------------------------------------------------------------------
# Probe-side dictionary planning (string columns / string group keys)
# ---------------------------------------------------------------------------

def _plan_probe_dicts(blocks, columns, where, aggs, group):
    """Scan-global dictionary plan for the PROBE side of a fused plan.
    Build-side (payload) ids >= BUILD_COL_BASE are excluded: their
    dictionaries come from the JoinRuntime.  Returns (plan, where, aggs,
    ok) like stream_scan._plan_dict_columns."""
    from ..docdb.operations import Unrewritable, rewrite_where_and_aggs
    probe_cols = [c for c in columns if c < BUILD_COL_BASE]
    dcids = dict_cols_needed(blocks, probe_cols)
    if dcids is None:
        return None, where, aggs, False
    if isinstance(group, DictGroupSpec):
        for cid in group.cols:
            if cid >= BUILD_COL_BASE:
                continue
            if not all(cid in b.varlen for b in blocks):
                return None, where, aggs, False
            if cid not in dcids:
                dcids.append(cid)
    if not dcids:
        return None, where, aggs, True
    plan = make_dict_plan(blocks, sorted(set(dcids)))
    if plan is None:
        return None, where, aggs, False
    try:
        # no dict-code decode step exists on the fused-plan route: a bare
        # dict column's MIN/MAX keeps its typed refusal here
        where, aggs = rewrite_where_and_aggs(where, aggs, plan.dicts,
                                             allow_dict_minmax=False)
    except Unrewritable:
        return None, where, aggs, False
    return plan, where, aggs, True


def _group_domain_ok(group, merged_dicts) -> bool:
    # the streamed scan's wrap guard, checked against the MERGED
    # namespace: probe dictionaries plus every stage's payload ones
    from .stream_scan import group_domain_ok
    return group_domain_ok(group, merged_dicts)


# ---------------------------------------------------------------------------
# Streaming route — the pow2-chunk pipeline with the probe fused in
# ---------------------------------------------------------------------------

def streaming_plan_aggregate(
        blocks, columns: Sequence[int], where, aggs: Sequence[AggSpec],
        group, read_ht: Optional[int], join_wire,
        kernel: Optional[FusedPlanKernel] = None,
        chunk_rows: Optional[int] = None,
        cache=None, cache_key: Optional[tuple] = None,
        min_chunks: int = 3,
        grouped_out: Optional[dict] = None,
        device: DeviceLike = "cuda"):
    """Chunked fused-plan aggregate over `blocks` (the probe side) on
    `kernel`'s device (else `device`).

    `columns` holds the PROBE-side columns only (the FK columns included);
    build-side payload lanes ride in `join_wire`, one JoinWire or an
    ordered sequence of probe stages.  Returns ``(agg_values, counts)``,
    or None when the scan isn't streamable (the streamed scan's rules);
    raises JoinIneligible (typed, stage-tagged) when a build side can't
    be served.  Every chunk shares one pow2 bucket, hence one plan
    signature however many chunks growth adds."""
    if isinstance(group, HashGroupSpec):
        return None
    dict_group = isinstance(group, DictGroupSpec)
    plan, where, aggs, ok = _plan_probe_dicts(blocks, columns, where,
                                              aggs, group)
    if not ok:
        return None
    # every cheap decline runs BEFORE the build-table construction: a
    # scan that falls to the monolithic route must not build it twice
    from .stream_scan import (_chunk_builder, _combine, chunk_safe_mvcc,
                              plan_chunks)
    chunk_safe = chunk_safe_mvcc(blocks)
    if read_ht is not None and not chunk_safe:
        return None
    pruned = 0
    kept_idx = None
    if where is not None and flags.get("zone_map_pruning") \
            and (read_ht is None or chunk_safe):
        from .scan import zone_prune_blocks
        kept, kept_idx = zone_prune_blocks(blocks, where)
        pruned = len(blocks) - len(kept)
        if pruned:
            blocks = kept
    chunk_rows = chunk_rows or int(flags.get("streaming_chunk_rows"))
    chunks = plan_chunks(blocks, chunk_rows)
    if len(chunks) < min_chunks and not pruned:
        return None
    kernel = kernel or default_plan_kernel(device)
    t_build = time.perf_counter()
    join_rts = make_join_runtimes(
        join_wire, plan.dicts if plan is not None else {},
        device=kernel.device)
    build_table_s = time.perf_counter() - t_build
    merged_dicts = dict(plan.dicts) if plan is not None else {}
    for rt in join_rts:
        merged_dicts.update(rt.payload_dicts)
    if dict_group and not _group_domain_ok(group, merged_dicts):
        return None
    aggs = tuple(_expand_avg(aggs))
    cols_sorted = sorted(c for c in columns if c < BUILD_COL_BASE)
    bucket = bucket_rows(max(max(sum(b.n for b in c) for c in chunks), 1))
    # probe batches are join-independent (the tables and payloads are
    # run-time arguments), so chunk entries are SHARED with plain scans of
    # the same columns: the streamed scan's builder and key discipline
    build = _chunk_builder(chunks, cols_sorted, bucket, plan, kernel.device,
                           cache, cache_key, chunk_rows,
                           ("zp", kept_idx) if pruned else ())
    from ..storage.columnar import KEY_REBUILD_STATS
    from ..storage.pipeline import StreamPipeline
    pipe = StreamPipeline([build], depth=2, name="plan-scan")
    acc = None
    counts_acc = None
    spill_acc = 0
    kernel_s = 0.0
    combine_s = 0.0
    rebuilds0 = KEY_REBUILD_STATS["rebuilds"]
    for batch in pipe.run(range(len(chunks))):
        t0 = time.perf_counter()
        got = kernel.run(batch, where, aggs, group, read_ht, join_rts)
        if dict_group:
            outs, counts, _, spill = got
            spill_acc += int(spill)
        else:
            outs, counts, _ = got
        kernel_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        acc = _combine(aggs, acc, outs)
        counts = _np(counts)
        counts_acc = counts if counts_acc is None else counts_acc + counts
        combine_s += time.perf_counter() - t0
    LAST_PLAN_STATS.clear()
    LAST_PLAN_STATS.update({
        "path": "streaming", "chunks": len(chunks),
        "bucket_rows": bucket,
        "zone_blocks_pruned": pruned,
        "n_build": sum(rt.n_build for rt in join_rts),
        "num_slots": (join_rts[0].num_slots if len(join_rts) == 1
                      else [rt.num_slots for rt in join_rts]),
        "join_stages": len(join_rts),
        "build_table_s": round(build_table_s, 5),
        "batch_build_s": round(pipe.stage_s[0], 4),
        "kernel_s": round(kernel_s, 4),
        "combine_s": round(combine_s, 4),
        "consumer_wait_s": round(pipe.wait_s, 4),
        # the keyless-v2 contract holds on the fused route too
        "key_rebuilds": KEY_REBUILD_STATS["rebuilds"] - rebuilds0,
        "plan_compiles": kernel.compiles,
        "plan_cache_hits": kernel.cache_hits,
        "plan_launches": kernel.launches})
    if dict_group and grouped_out is not None:
        resolved, _ = resolve_group(group, merged_dicts)
        grouped_out.update(spill=spill_acc, dicts=merged_dicts,
                           num_slots=resolved.num_slots)
    return tuple(acc), counts_acc


# ---------------------------------------------------------------------------
# Monolithic route — one padded batch, the under-min_chunks twin
# ---------------------------------------------------------------------------

def monolithic_plan_aggregate(
        blocks, columns: Sequence[int], where, aggs: Sequence[AggSpec],
        group, read_ht: Optional[int], join_wire,
        kernel: Optional[FusedPlanKernel] = None,
        cache=None, cache_key: Optional[tuple] = None,
        grouped_out: Optional[dict] = None,
        device: DeviceLike = "cuda"):
    """One-batch fused plan on `kernel`'s device (else `device`),
    mirroring the monolithic aggregate path: the zone-prune gate, string
    predicates rewritten against the batch dictionaries, and — like the
    port's tablet route — MVCC mode ``visible`` kept for several blocks
    that are one chunk-safe run (the reference sorts in ``dedup`` mode
    there; the same rows pass).  Returns ``(outs, counts)`` plus
    grouped_out's spill and dicts; raises KeyError when a probe column
    lacks columnar form and JoinIneligible for typed build-side
    refusals."""
    from ..docdb.operations import rewrite_where_and_aggs
    from .stream_scan import chunk_safe_mvcc
    kernel = kernel or default_plan_kernel(device)
    dict_group = isinstance(group, DictGroupSpec)
    cols_sorted = sorted(c for c in columns if c < BUILD_COL_BASE)
    kept = list(blocks)
    prune_key: tuple = ()
    chunk_safe = chunk_safe_mvcc(blocks)
    if where is not None and flags.get("zone_map_pruning"):
        if read_ht is None or chunk_safe:
            from .scan import zone_prune_blocks
            kept, kept_idx = zone_prune_blocks(kept, where)
            if len(kept) != len(blocks):
                prune_key = ("zp", kept_idx)

    def build():
        return build_batch(kept, cols_sorted, device=kernel.device)
    if cache is not None and cache_key is not None:
        batch = cache.get_or_build(cache_key + prune_key, build)
    else:
        batch = build()
    if len(blocks) > 1 and not chunk_safe:
        batch.unique_keys = False
    if where is not None or any(a.expr is not None for a in aggs):
        where, aggs = rewrite_where_and_aggs(where, aggs, batch.dicts,
                                             allow_dict_minmax=False)
    t_build = time.perf_counter()
    join_rts = make_join_runtimes(join_wire, batch.dicts,
                                  device=kernel.device)
    build_table_s = time.perf_counter() - t_build
    merged_dicts = dict(batch.dicts)
    for rt in join_rts:
        merged_dicts.update(rt.payload_dicts)
    if dict_group and not _group_domain_ok(group, merged_dicts):
        raise JoinIneligible(REASON_PROBE_SHAPE,
                             "group domain unservable")
    t0 = time.perf_counter()
    got = kernel.run(batch, where, aggs, group, read_ht, join_rts)
    if dict_group:
        outs, counts, _, spill = got
        spill = int(spill)
        if grouped_out is not None:
            resolved, _ = resolve_group(group, merged_dicts)
            grouped_out.update(spill=spill, dicts=merged_dicts,
                               num_slots=resolved.num_slots)
    else:
        outs, counts, _ = got
    counts = _np(counts)
    kernel_s = time.perf_counter() - t0
    LAST_PLAN_STATS.clear()
    LAST_PLAN_STATS.update({
        "path": "monolithic", "chunks": 1,
        "bucket_rows": batch.padded_rows,
        "n_build": sum(rt.n_build for rt in join_rts),
        "num_slots": (join_rts[0].num_slots if len(join_rts) == 1
                      else [rt.num_slots for rt in join_rts]),
        "join_stages": len(join_rts),
        "build_table_s": round(build_table_s, 5),
        "kernel_s": round(kernel_s, 4),
        "plan_compiles": kernel.compiles,
        "plan_cache_hits": kernel.cache_hits,
        "plan_launches": kernel.launches})
    return outs, counts


# ---------------------------------------------------------------------------
# CPU twin — numpy replay of the fused program's exact contract
# ---------------------------------------------------------------------------

def fused_plan_cpu(blocks, columns: Sequence[int], where,
                   aggs: Sequence[AggSpec], group,
                   join_wire, read_ht: Optional[int] = None,
                   n_total: Optional[int] = None):
    """Numpy twin of the fused plan: the same scan-global dictionary plan,
    build-table key mapping and match indices (per probe stage, in probe
    order), dense slot encoding and static int64 fixed-point SUM
    quantization — bitwise equal to the MONOLITHIC route of a CPU plan
    kernel under ``device_float_dtype`` float64 when ``n_total`` is the
    batch's padded row bucket (f64 columns take the CPU's dtype policy).
    ``join_wire`` is one JoinWire or an ordered stage sequence.  Returns
    ``(outs, counts, spilled, merged_dicts)``: dense slot arrays for a
    DictGroupSpec (decode with decode_slot_groups against merged_dicts),
    scalars for flat aggregates."""
    from ..docdb.operations import rewrite_where_and_aggs
    from .cpu_scan import eval_expr_np
    from .device_batch import f64_conversion
    from .expr import expr_bound
    from .scan import _scale_for

    cpu = torch.device("cpu")
    aggs = tuple(_expand_avg(aggs))
    probe_cols = sorted(c for c in columns if c < BUILD_COL_BASE)
    dcids = dict_cols_needed(blocks, probe_cols)
    if dcids is None:
        raise ValueError("probe columns lack columnar form")
    extra_dicts = []
    if isinstance(group, DictGroupSpec):
        extra_dicts = [c for c in group.cols if c < BUILD_COL_BASE]
    plan = None
    want_dict = sorted(set(dcids) | set(extra_dicts))
    if want_dict:
        plan = make_dict_plan(blocks, want_dict)
        if plan is None:
            raise ValueError("not dictionary-encodable")
    if where is not None or any(a.expr is not None for a in aggs):
        where, aggs = rewrite_where_and_aggs(
            where, aggs, plan.dicts if plan is not None else {},
            allow_dict_minmax=False)
    join_rts = make_join_runtimes(
        join_wire, plan.dicts if plan is not None else {}, device=cpu)
    cols: Dict[int, np.ndarray] = {}
    nulls: Dict[int, np.ndarray] = {}
    bounds: Dict[int, Tuple[float, float]] = {}
    gather_cols = set(probe_cols)
    if isinstance(group, DictGroupSpec):
        gather_cols |= {c for c in group.cols if c < BUILD_COL_BASE}
    for cid in sorted(gather_cols):
        if plan is not None and cid in plan.dicts:
            cols[cid] = np.concatenate(
                [plan.block_codes(cid, b) for b in blocks])
            nulls[cid] = np.concatenate(
                [np.asarray(b.varlen[cid][2], bool) for b in blocks])
            continue
        parts, nparts = [], []
        for b in blocks:
            if cid in b.fixed:
                v, m = b.fixed[cid]
                parts.append(v)
                nparts.append(m)
            else:
                parts.append(b.pk[cid])
                nparts.append(np.zeros(b.n, bool))
        arr = np.concatenate(parts)
        conv = (f64_conversion(parts, cpu) if arr.dtype == np.float64
                else None)
        if conv is not None:
            arr = arr.astype(conv)
        cols[cid] = arr
        nulls[cid] = np.concatenate(nparts)
        if arr.dtype.kind in "fiu" and len(arr):
            bounds[cid] = (float(arr.min()), float(arr.max()))
    for rt in join_rts:
        bounds.update(rt.payload_bounds)
    n = len(next(iter(cols.values()))) if cols else 0
    mask = np.ones(n, bool)
    if read_ht is not None:
        ht = np.concatenate([b.ht for b in blocks])
        tomb = np.concatenate([b.tombstone for b in blocks])
        mask &= (ht <= np.uint64(read_ht)) & ~tomb
    if where is not None:
        wv, wn = eval_expr_np(where, cols, nulls)
        mask &= wv
        if wn is not None:
            mask &= ~wn
    # --- the probe stages (probe + gather, in the same probe order under
    # the same shared mask)
    for rt in join_rts:
        pk = cols[rt.probe_col]
        pkn = nulls.get(rt.probe_col)
        if pkn is not None:
            mask &= ~pkn
        midx = hash_join_cpu(pk.astype(np.int64), rt.keys_mapped)
        matched = midx >= 0
        mask &= matched
        gidx = np.clip(midx, 0, rt.build_rows_pad - 1)
        for bid in rt.build_cols:
            cols[bid] = rt.payload_vals[bid][gidx]
            nulls[bid] = rt.payload_nulls[bid][gidx] | ~matched
    merged_dicts = dict(plan.dicts) if plan is not None else {}
    for rt in join_rts:
        merged_dicts.update(rt.payload_dicts)
    if n_total is None:
        n_total = bucket_rows(max(n, 1))
    # --- group/aggregate tail (the masked_aggregate twin)
    if isinstance(group, DictGroupSpec):
        resolved, domains = resolve_group(group, merged_dicts)
        for cid in group.cols:
            mask &= ~nulls[cid]
        gid = np.zeros(n, np.int64)
        stride = 1
        for cid, dom in zip(group.cols, domains):
            gid += cols[cid].astype(np.int64) * stride
            stride *= dom
        S = resolved.num_slots
        spill_slot = S - 1
        in_range = gid < spill_slot
        spilled = int(np.sum(mask & ~in_range))
        gid_c = np.where(mask & in_range, gid,
                         spill_slot).astype(np.int64)
    else:
        S = 1
        spilled = 0
        gid_c = np.zeros(n, np.int64)
    grouped = isinstance(group, DictGroupSpec)

    def _exact_count(m):
        c = np.bincount(gid_c[m], minlength=S).astype(np.int64)
        return c if grouped else c.sum()

    def _exact_sum(q):
        if not grouped:
            return np.sum(q)
        qs = np.zeros(S, np.int64)
        np.add.at(qs, gid_c, q)
        return qs

    outs = []
    for a in aggs:
        if a.expr is None:
            outs.append(_exact_count(mask))
            continue
        v, vn = eval_expr_np(a.expr, cols, nulls)
        m = mask if vn is None else mask & ~vn
        if a.op == "count":
            outs.append(_exact_count(m))
        elif a.op == "sum":
            va = np.asarray(v)
            if np.issubdtype(va.dtype, np.integer) or \
                    va.dtype == np.bool_:
                outs.append(_exact_sum(
                    np.where(m, v, 0).astype(np.int64)))
                continue
            b = expr_bound(a.expr, bounds) if bounds else None
            s = (_scale_for(max(abs(b[0]), abs(b[1])), n_total)
                 if b is not None else None)
            if s is not None:
                q = np.rint(np.where(m, v, 0) * np.float64(s)
                            ).astype(np.int64)
                outs.append(np.asarray(_exact_sum(q),
                                       np.float64) / float(s))
            elif grouped:
                outs.append(np.bincount(gid_c,
                                        weights=np.where(m, v, 0),
                                        minlength=S))
            else:
                outs.append(np.sum(np.where(m, v, 0)))
        elif a.op in ("min", "max"):
            va = np.asarray(v)
            sent = (np.inf if a.op == "min" else -np.inf) \
                if va.dtype.kind == "f" else \
                (np.iinfo(va.dtype).max if a.op == "min"
                 else np.iinfo(va.dtype).min)
            if grouped:
                arr = np.full(S, sent, va.dtype)
                red = np.minimum if a.op == "min" else np.maximum
                red.at(arr, gid_c[m], va[m])
                outs.append(arr)
            else:
                sel = va[m]
                outs.append(np.asarray(
                    (sel.min() if a.op == "min" else sel.max())
                    if len(sel) else sent))
        else:
            raise ValueError(a.op)
    counts = _exact_count(mask)
    return tuple(outs), counts, spilled, merged_dicts
