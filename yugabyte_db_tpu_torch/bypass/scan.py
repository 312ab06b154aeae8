"""Keyless v2 SST-direct scan engine.

Counterpart of ``yugabyte_db_tpu/bypass/scan.py``.  Opens a pinned
snapshot's SST files directly (fresh readers over the leased paths,
with NO key_builder bound, so a key-matrix rebuild cannot happen) and
streams their columnar blocks through the shared pow2-bucket chunk
pipeline (ops/stream_scan.py).  Eligibility, zone-map pruning and
chunk-safety read only the stored boundary keys, so an all-v2 tablet
scans with zero key-matrix rebuilds.

``bypass_plan_aggregate`` serves FK-equijoin aggregates the same way,
through the fused plan (ops/plan_fusion.py) with the build side probed
inside it.

Anything the engine cannot serve exactly (hash groups, columns with no
columnar form, block sequences that are not chunk-safe, expressions
the device cannot compile, a build side the device join refuses)
raises BypassIneligible with a typed reason and the caller falls back
to ``Tablet.read``.  What it serves equals the tablet read path at the
same read point bit for bit: the same zone-prune gate, chunk plan and
bucket, kernel and combine, and the same monolithic twin under
``min_chunks``.  Document-path scans raise NotPortedError (ROADMAP.md
queue 1 item 9b).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..errors import NotPortedError
from ..ops.device_batch import bucket_rows, build_batch
from ..ops.grouped_scan import DictGroupSpec
from ..ops.scan import (AggSpec, HashGroupSpec, ScanKernel, _np,
                        expand_aggregates, needed_probe_columns)
from ..ops.stream_scan import (LAST_STREAM_STATS, chunk_safe_mvcc,
                               streaming_scan_aggregate)
from ..storage.columnar import KEY_REBUILD_STATS, ColumnarBlock
from ..storage.sst import SstReader
from ..utils import flags
from .errors import (REASON_COLUMN_NOT_FIXED, REASON_EXPR_SHAPE,
                     REASON_GROUPED_OFF, REASON_HASH_GROUP,
                     REASON_JOIN_OFF, REASON_JOIN_SHAPE,
                     REASON_NO_COLUMNAR, REASON_NOT_AGGREGATE,
                     REASON_NOT_CHUNK_SAFE, REASON_SLOT_OVERFLOW,
                     BypassIneligible)
from .prefilter import make_prefilter

_DOC_ITEM = "queue 1 item 9b (document shredding)"


def open_snapshot_readers(snap) -> List[SstReader]:
    """Fresh SstReaders over a snapshot's leased paths, deliberately
    with no key_builder: the keyless scanner has no rebuild to fall
    into."""
    return [SstReader(p, key_builder=None) for p in snap.sst_paths]


def collect_keyless_blocks(readers: Sequence[SstReader]
                           ) -> Tuple[List[ColumnarBlock], dict]:
    """All columnar blocks of the snapshot as ONE candidate sorted run:
    per-SST runs ordered by their first stored boundary key (the
    chunk-safety check downstream catches overlapping runs)."""
    runs: List[List[ColumnarBlock]] = []
    keyless = 0
    total = 0
    for r in readers:
        run: List[ColumnarBlock] = []
        for i in range(r.num_blocks()):
            cb = r.read_columnar(i)
            if cb is None:
                raise BypassIneligible(
                    REASON_NO_COLUMNAR,
                    f"{r.path}: block {i} has no columnar sidecar")
            total += 1
            if cb._keys is None:
                keyless += 1
            run.append(cb)
        if run:
            runs.append(run)

    def run_key(run: List[ColumnarBlock]) -> bytes:
        k0, _ = run[0].boundary_keys(materialize=False)
        return k0 if k0 is not None else b""

    runs.sort(key=run_key)
    blocks = [b for run in runs for b in run]
    return blocks, {"blocks": total, "keyless_blocks": keyless,
                    "ssts": len(readers)}


def _has_doc_nodes(where, aggs) -> bool:
    from ..docdb.operations import has_doc_nodes
    return (where is not None and has_doc_nodes(where)) or any(
        a.expr is not None and has_doc_nodes(a.expr) for a in aggs)


def bypass_scan_aggregate(
        blocks: Sequence[ColumnarBlock],
        where: Optional[tuple], aggs: Sequence[AggSpec],
        group, read_ht: int,
        kernel: Optional[ScanKernel] = None,
        chunk_rows: Optional[int] = None,
        prefilter_enabled: Optional[bool] = None,
        min_chunks: int = 3,
        grouped_out: Optional[dict] = None,
        device="cuda") -> Tuple[tuple, np.ndarray, dict]:
    """Aggregate `blocks` at `read_ht` on `kernel`'s device (else the
    shared kernel of `device`).  Returns (agg_values, counts, stats);
    raises BypassIneligible with a typed reason for every shape the
    engine cannot serve exactly.

    A DictGroupSpec serves keylessly too: string group columns ride as
    dictionary codes and the caller receives COMPACTED per-shard
    partials, with ``grouped_out['group_values']`` the decoded keys
    aligned with the returned counts."""
    if not aggs:
        raise BypassIneligible(REASON_NOT_AGGREGATE)
    if isinstance(group, HashGroupSpec):
        raise BypassIneligible(REASON_HASH_GROUP)
    dict_group = isinstance(group, DictGroupSpec)
    if dict_group and not flags.get("grouped_pushdown_enabled"):
        raise BypassIneligible(REASON_GROUPED_OFF)
    if _has_doc_nodes(where, aggs):
        raise NotPortedError("document-path bypass scans", _DOC_ITEM)
    from ..ops.expr import device_compatible
    if where is not None and not device_compatible(where):
        raise BypassIneligible(REASON_EXPR_SHAPE, "where")
    for a in aggs:
        if a.expr is not None and not device_compatible(a.expr):
            raise BypassIneligible(REASON_EXPR_SHAPE, "aggregate expr")
    needed = needed_probe_columns(where, aggs, group)
    for b in blocks:
        for cid in needed:
            # string columns ride as dictionary codes; a column with no
            # columnar form at all refuses
            if not (cid in b.fixed or cid in b.pk or cid in b.varlen):
                raise BypassIneligible(
                    REASON_COLUMN_NOT_FIXED, f"column {cid}")
    # the ONE structural gate: every doc key inside one block of one
    # sorted disjoint unique-key run, from stored boundary keys alone
    if not chunk_safe_mvcc(blocks):
        raise BypassIneligible(REASON_NOT_CHUNK_SAFE)
    if prefilter_enabled is None:
        prefilter_enabled = flags.get("bypass_prefilter_enabled")
    if kernel is None:
        from ..docdb.operations import shared_kernel
        kernel = shared_kernel(device)
    rebuilds0 = KEY_REBUILD_STATS["rebuilds"]
    cols_sorted = sorted(needed)
    expanded, minmax, aggs_run = expand_aggregates(aggs)
    # compacted blocks carry no varlen lanes: a scan whose columns ride
    # as dictionary codes runs unfiltered
    rides_codes = any(
        not all(cid in b.fixed or cid in b.pk for b in blocks)
        for cid in cols_sorted)
    pf = (make_prefilter(where, cols_sorted)
          if prefilter_enabled and not rides_codes else None)
    stats: dict = {}
    gout: Optional[dict] = {} if dict_group else None
    dict_out: dict = {}
    got = streaming_scan_aggregate(
        blocks, cols_sorted, where, aggs_run, group, read_ht,
        kernel=kernel, chunk_rows=chunk_rows, prefilter=pf,
        min_chunks=min_chunks, grouped_out=gout, dict_out=dict_out)
    group_dicts = None
    if got is None:
        got = _monolithic_twin(blocks, cols_sorted, where, aggs_run,
                               group, read_ht, kernel, pf,
                               dict_out=dict_out)
        if dict_group:
            got, group_dicts = got
        stats["path"] = "monolithic"
    else:
        if dict_group:
            if gout.get("spill"):
                raise BypassIneligible(
                    REASON_SLOT_OVERFLOW,
                    f"{gout['spill']} rows past "
                    f"{gout['num_slots']} slots")
            group_dicts = gout["dicts"]
        stats["path"] = "streaming"
        stats.update(LAST_STREAM_STATS)
    outs, counts = got
    from ..docdb.operations import _nullify_minmax, dict_minmax_decode
    outs = _nullify_minmax(expanded, minmax, outs)
    # dict-code MIN/MAX decode PER SHARD: codes never leave the shard
    outs = dict_minmax_decode(expanded, outs,
                              dict_out.get("dicts") or {})
    counts = _np(counts)
    if dict_group:
        from ..ops.grouped_scan import decode_slot_groups
        outs, counts, gvals = decode_slot_groups(
            group, group_dicts, outs, counts)
        if grouped_out is not None:
            grouped_out["group_values"] = gvals
    stats["key_rebuilds"] = KEY_REBUILD_STATS["rebuilds"] - rebuilds0
    if pf is not None:
        from .prefilter import LAST_PREFILTER_STATS
        stats.setdefault("prefilter_rows_in",
                         LAST_PREFILTER_STATS["rows_in"])
        stats.setdefault("prefilter_rows_kept",
                         LAST_PREFILTER_STATS["rows_kept"])
    return outs, np.asarray(counts), stats


def bypass_plan_aggregate(
        blocks: Sequence[ColumnarBlock],
        where: Optional[tuple], aggs: Sequence[AggSpec],
        group, read_ht: int, join_wire,
        chunk_rows: Optional[int] = None,
        min_chunks: int = 3,
        grouped_out: Optional[dict] = None,
        device="cuda") -> Tuple[tuple, np.ndarray, dict]:
    """Fused-plan (FK-equijoin) aggregate over a pinned snapshot on
    `device`: the bypass route of ops/plan_fusion.py.  The probe scan
    streams keylessly like bypass_scan_aggregate (the same chunk-safety
    gate and shared bucket); the build side is probed inside the fused
    plan.  Raises BypassIneligible with a typed reason for every shape
    the engine cannot serve exactly; ``REASON_JOIN_SHAPE`` carries the
    ops/join_scan typed reason in its detail."""
    from ..docdb.operations import (Unrewritable, _nullify_minmax)
    from ..ops.join_scan import JoinIneligible, normalize_join
    from ..ops.plan_fusion import (LAST_PLAN_STATS, default_plan_kernel,
                                   monolithic_plan_aggregate,
                                   streaming_plan_aggregate)
    if not aggs:
        raise BypassIneligible(REASON_NOT_AGGREGATE)
    if isinstance(group, HashGroupSpec):
        raise BypassIneligible(REASON_HASH_GROUP)
    if not flags.get("join_pushdown_enabled"):
        raise BypassIneligible(REASON_JOIN_OFF)
    dict_group = isinstance(group, DictGroupSpec)
    if dict_group and not flags.get("grouped_pushdown_enabled"):
        raise BypassIneligible(REASON_GROUPED_OFF)
    from ..ops.expr import device_compatible
    if where is not None and not device_compatible(where):
        raise BypassIneligible(REASON_EXPR_SHAPE, "where")
    for a in aggs:
        if a.expr is not None and not device_compatible(a.expr):
            raise BypassIneligible(REASON_EXPR_SHAPE, "aggregate expr")
    needed = needed_probe_columns(where, aggs, group,
                                  normalize_join(join_wire))
    for b in blocks:
        for cid in needed:
            if not (cid in b.fixed or cid in b.pk or cid in b.varlen):
                raise BypassIneligible(
                    REASON_COLUMN_NOT_FIXED, f"column {cid}")
    if not chunk_safe_mvcc(blocks):
        raise BypassIneligible(REASON_NOT_CHUNK_SAFE)
    kernel = default_plan_kernel(device)
    rebuilds0 = KEY_REBUILD_STATS["rebuilds"]
    cols_sorted = sorted(needed)
    expanded, minmax, aggs_run = expand_aggregates(aggs)
    stats: dict = {}
    gout: Optional[dict] = {} if dict_group else None
    try:
        got = streaming_plan_aggregate(
            blocks, cols_sorted, where, aggs_run, group, read_ht,
            join_wire, kernel=kernel, chunk_rows=chunk_rows,
            min_chunks=min_chunks, grouped_out=gout)
        if got is None:
            try:
                got = monolithic_plan_aggregate(
                    blocks, cols_sorted, where, aggs_run, group,
                    read_ht, join_wire, kernel=kernel,
                    grouped_out=gout)
            except KeyError as e:
                raise BypassIneligible(REASON_COLUMN_NOT_FIXED, str(e))
            stats["path"] = "monolithic"
        else:
            stats["path"] = "streaming"
    except JoinIneligible as e:
        raise BypassIneligible(REASON_JOIN_SHAPE, e.reason)
    except Unrewritable:
        raise BypassIneligible(
            REASON_EXPR_SHAPE,
            "string column outside a rewritable predicate shape")
    if dict_group and gout.get("spill"):
        raise BypassIneligible(
            REASON_SLOT_OVERFLOW,
            f"{gout['spill']} rows past {gout['num_slots']} slots")
    outs, counts = got
    outs = _nullify_minmax(expanded, minmax, outs)
    if dict_group:
        from ..ops.grouped_scan import decode_slot_groups
        outs, counts, gvals = decode_slot_groups(
            group, gout["dicts"], outs, counts)
        if grouped_out is not None:
            grouped_out["group_values"] = gvals
    stats["key_rebuilds"] = KEY_REBUILD_STATS["rebuilds"] - rebuilds0
    # the session-scoped key_rebuilds stays (it covers block collection
    # too, not just the chunk pipeline)
    stats.update({k: v for k, v in LAST_PLAN_STATS.items()
                  if k not in ("path", "key_rebuilds")})
    return outs, np.asarray(counts), stats


def _monolithic_twin(blocks, cols_sorted, where, aggs_run, group,
                     read_ht, kernel, pf, dict_out: dict = None):
    """The under-min_chunks shape, equal to the tablet's monolithic
    aggregate route bit for bit (zone-prune gate, one bucket over the
    kept rows, string predicates rewritten against the batch
    dictionaries).  Dict-grouped scans
    return ``((outs, counts), batch dictionaries)``."""
    from ..ops.scan import zone_prune_blocks
    kept = list(blocks)
    if where is not None and flags.get("zone_map_pruning"):
        # bypass blocks are chunk-safe (the caller checked): pruning is
        # sound
        kept, _ = zone_prune_blocks(kept, where)
    try:
        if pf is not None:
            batch = build_batch(
                pf(kept), cols_sorted, device=kernel.device,
                pad_to=bucket_rows(max(sum(b.n for b in kept), 1)),
                bounds_blocks=kept)
        else:
            batch = build_batch(kept, cols_sorted, device=kernel.device)
    except KeyError as e:
        # a varlen column that cannot dictionary-encode: typed, scoped
        # to the batch build alone
        raise BypassIneligible(REASON_COLUMN_NOT_FIXED, str(e))
    # the blocks are one chunk-safe run (the caller checked): the batch
    # keeps the visible mode, as the tablet's monolithic route does
    if dict_out is not None:
        dict_out["dicts"] = batch.dicts
    if batch.dicts and (where is not None
                        or any(a.expr is not None for a in aggs_run)):
        from ..docdb.operations import Unrewritable, rewrite_where_and_aggs
        try:
            where, aggs_run = rewrite_where_and_aggs(where, aggs_run,
                                                     batch.dicts)
        except Unrewritable:
            raise BypassIneligible(
                REASON_EXPR_SHAPE, "string column outside a "
                "rewritable predicate shape")
    if isinstance(group, DictGroupSpec):
        from ..ops.grouped_scan import domain_product
        if any(c not in batch.dicts for c in group.cols):
            raise BypassIneligible(
                REASON_COLUMN_NOT_FIXED,
                "group column has no dictionary form")
        if domain_product(group, batch.dicts) >= 2 ** 31:
            raise BypassIneligible(
                REASON_SLOT_OVERFLOW,
                "group domain product exceeds 2^31 (group id would "
                "wrap)")
        outs, counts, _, spill = kernel.run(batch, where, aggs_run,
                                            group, read_ht)
        if int(spill) > 0:
            raise BypassIneligible(
                REASON_SLOT_OVERFLOW, f"{int(spill)} rows spilled")
        return (outs, counts), batch.dicts
    outs, counts, _ = kernel.run(batch, where, aggs_run, group, read_ht)
    return outs, counts
