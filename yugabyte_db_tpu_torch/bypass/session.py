"""BypassSession: the user-facing face of the analytics bypass engine.

Counterpart of ``yugabyte_db_tpu/bypass/session.py``.  One session is
one frozen read point over a set of tablet shards, pinned against
compaction for the session's lifetime.  TPC-H Q1/Q6-shaped aggregates
run through :func:`bypass_scan_aggregate` per shard on the session's
device, and FK-equijoin aggregates (``join=``) through
:func:`bypass_plan_aggregate`; partials combine across shards on the
host, by the very function the multi-tablet fan-out uses, so the two
cannot drift — or, with ``combine="mesh"``, on a device mesh of one
slot per shard (parallel/distributed_scan.py).

The session never touches a tserver: pins come from the storage layer,
files are opened directly, kernels launch from the calling thread.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..ops.scan import AggSpec, _expand_avg, combine_agg_partials
from .errors import REASON_NO_SSTS, BypassIneligible
from .pinner import TabletSnapshot, pin_tablet
from .scan import (bypass_scan_aggregate, collect_keyless_blocks,
                   open_snapshot_readers)


def combine_partials(aggs: Sequence[AggSpec], parts: List[tuple],
                     counts_parts: List[np.ndarray]
                     ) -> Tuple[tuple, Optional[np.ndarray]]:
    """Host-side cross-shard combine: ``ops.scan.combine_agg_partials``
    in shard order."""
    return combine_agg_partials(tuple(_expand_avg(aggs)), parts,
                                counts_parts)


class BypassSession:
    """Snapshot-consistent SST-direct analytics session on `device`
    (CUDA unless the caller passes "cpu"; raises without a card).

    ``tablets``: the local tablet shards, in the order the RPC fan-out
    visits them (host-combined results then match bit for bit); objects
    with ``tablet`` and ``safe_read_ht`` (a consensus peer) make the
    pinner wait on the peer's MVCC safe time.  ``read_ht``: explicit
    read point; by default the newest tablet clock reading, ratcheted
    into every shard's clock by the pinner, and restarted (re-pinned)
    on the clock-uncertainty window like a server-assigned read.

    Context manager; ``close()`` releases every SST lease."""

    def __init__(self, tablets: Sequence, read_ht: Optional[int] = None,
                 table_id: Optional[str] = None,
                 chunk_rows: Optional[int] = None,
                 prefilter: Optional[bool] = None,
                 min_chunks: int = 3, device: DeviceLike = "cuda"):
        if not tablets:
            raise ValueError("BypassSession needs at least one tablet")
        self.device = resolve_device(device)
        shards = []                       # (tablet, safe_time_fn|None)
        for t in tablets:
            if hasattr(t, "safe_read_ht") and hasattr(t, "tablet"):
                shards.append((t.tablet, t.safe_read_ht))
            else:
                shards.append((t, None))
        auto_read_ht = read_ht is None
        if auto_read_ht:
            read_ht = max(t.clock.now().value for t, _ in shards)
        self.chunk_rows = chunk_rows
        self.prefilter = prefilter
        self.min_chunks = min_chunks
        self.snapshots: List[TabletSnapshot] = []
        self._readers = []          # keep the mappings alive
        self._blocks: List[list] = []
        self._closed = False
        try:
            # a session-chosen read point restarts like a server-assigned
            # one: rows in (read_ht, read_ht + skew] move the read point
            # there and re-pin; the third attempt accepts
            for attempt in range(3 if auto_read_ht else 1):
                self._open_shards(shards, read_ht, table_id)
                if not auto_read_ht or attempt == 2:
                    break
                amb = self._max_ambiguous_ht(read_ht)
                if amb is None:
                    break
                self._release_shards()
                read_ht = amb
            self.read_ht = read_ht
        except BaseException:
            self.close()
            raise

    def _open_shards(self, shards, read_ht: int, table_id) -> None:
        for t, safe_fn in shards:
            snap = pin_tablet(t, read_ht=read_ht, table_id=table_id,
                              allow_empty=True, safe_time_fn=safe_fn)
            self.snapshots.append(snap)
        for snap in self.snapshots:
            readers = open_snapshot_readers(snap)
            blocks, bstats = collect_keyless_blocks(readers)
            snap.stats.update(bstats)
            self._readers.append(readers)
            self._blocks.append(blocks)

    def _release_shards(self) -> None:
        for snap in self.snapshots:
            snap.close()
        self.snapshots = []
        self._readers = []
        self._blocks = []

    def _max_ambiguous_ht(self, read_ht: int):
        """Newest hybrid time inside the clock-uncertainty window over
        every pinned block, or None when the window is clean."""
        from ..docdb.operations import _skew_window_ht
        window_hi = np.uint64(read_ht + _skew_window_ht())
        lo = np.uint64(read_ht)
        amb = None
        for blocks in self._blocks:
            for b in blocks:
                a = b.ht[(b.ht > lo) & (b.ht <= window_hi)]
                if len(a):
                    m = int(a.max())
                    amb = m if amb is None else max(amb, m)
        return amb

    def scan_aggregate(self, where, aggs: Sequence[AggSpec],
                       group=None, combine: str = "host",
                       grouped_out: Optional[dict] = None,
                       join=None
                       ) -> Tuple[tuple, Optional[np.ndarray], dict]:
        """One aggregate scan at the session's read point across every
        pinned shard, combined on the host (``combine="host"``).
        Dict-grouped scans merge per-shard compacted partials by group
        key (``ops.scan.combine_grouped_partials``); ``grouped_out``
        receives ``{'group_values': ...}`` aligned with the counts.
        ``join`` (one JoinWire or an ordered stage sequence) runs the
        fused plan per shard.  ``combine="mesh"`` combines on a device
        mesh (:meth:`_scan_mesh`); it serves neither dict-grouped nor
        join scans (ValueError).  An ineligible shard raises
        BypassIneligible."""
        if self._closed:
            raise RuntimeError("BypassSession is closed")
        from ..ops.grouped_scan import DictGroupSpec
        dict_group = isinstance(group, DictGroupSpec)
        if combine == "mesh":
            if dict_group or join is not None:
                raise ValueError(
                    "mesh combine does not serve dict-grouped or "
                    "join scans; use combine='host'")
            return self._scan_mesh(where, aggs, group)
        if combine != "host":
            raise ValueError(f"unknown combine mode {combine!r}")
        from ..docdb.operations import shared_kernel
        kernel = shared_kernel(self.device)
        parts, counts_parts, grouped_parts = [], [], []
        stats = self.stats()
        stats.update(key_rebuilds=0, prefilter_rows_in=0,
                     prefilter_rows_kept=0, combine="host",
                     shards_scanned=0)
        for blocks in self._blocks:
            if not blocks:
                continue            # an empty shard: combine identity
            gout: dict = {}
            if join is not None:
                from .scan import bypass_plan_aggregate
                outs, counts, sstats = bypass_plan_aggregate(
                    blocks, where, aggs, group, self.read_ht, join,
                    chunk_rows=self.chunk_rows,
                    min_chunks=self.min_chunks,
                    grouped_out=gout if dict_group else None,
                    device=self.device)
            else:
                outs, counts, sstats = bypass_scan_aggregate(
                    blocks, where, aggs, group, self.read_ht,
                    kernel=kernel, chunk_rows=self.chunk_rows,
                    prefilter_enabled=self.prefilter,
                    min_chunks=self.min_chunks,
                    grouped_out=gout if dict_group else None)
            parts.append(outs)
            counts_parts.append(counts)
            if dict_group:
                grouped_parts.append((outs, counts, gout["group_values"]))
            stats["shards_scanned"] += 1
            stats["key_rebuilds"] += sstats.get("key_rebuilds", 0)
            stats["prefilter_rows_in"] += sstats.get(
                "prefilter_rows_in", 0)
            stats["prefilter_rows_kept"] += sstats.get(
                "prefilter_rows_kept", 0)
            stats.setdefault("paths", []).append(sstats.get("path"))
        if not parts:
            raise BypassIneligible(REASON_NO_SSTS, "every shard is empty")
        if dict_group:
            from ..ops.scan import combine_grouped_partials
            t0 = time.perf_counter()
            outs, counts, gvals = combine_grouped_partials(
                tuple(_expand_avg(aggs)), grouped_parts)
            stats["combine_s"] = round(time.perf_counter() - t0, 4)
            if grouped_out is not None:
                grouped_out["group_values"] = gvals
            return outs, counts, stats
        outs, counts = combine_partials(aggs, parts, counts_parts)
        return outs, counts, stats

    def _scan_mesh(self, where, aggs, group):
        """Combine across shards on a device mesh: one slot per
        non-empty shard, the partials combined on the lead device by
        parallel/distributed_scan.py at the session's read point (no
        chunking, no prefilter: the sharded batch is built whole).  On
        CUDA each shard takes a card of its own (ValueError when there
        are fewer cards than shards); on the CPU the slots are CPU
        slots.  Every shard must be chunk-safe (BypassIneligible)."""
        from ..ops.scan import needed_probe_columns
        from ..ops.stream_scan import chunk_safe_mvcc
        from ..parallel.distributed_scan import (
            build_sharded_batch, check_mesh_group,
            distributed_scan_aggregate)
        from ..parallel.mesh import tablet_mesh
        from .errors import REASON_NOT_CHUNK_SAFE
        shards = [b for b in self._blocks if b]
        if not shards:
            raise BypassIneligible(REASON_NO_SSTS, "every shard is empty")
        if self.device.type == "cuda":
            import torch
            have = torch.cuda.device_count()
            if have < len(shards):
                raise ValueError(f"mesh combine needs {len(shards)} "
                                 f"devices, backend has {have}")
            devices = [torch.device("cuda", i) for i in range(len(shards))]
        else:
            devices = [self.device] * len(shards)
        check_mesh_group(group)
        for blocks in shards:
            if not chunk_safe_mvcc(blocks):
                raise BypassIneligible(REASON_NOT_CHUNK_SAFE)
        tm = tablet_mesh(len(shards), 1, devices=devices)
        batch = build_sharded_batch(
            tm, shards, sorted(needed_probe_columns(where, aggs, group)))
        outs, counts = distributed_scan_aggregate(
            batch, where, tuple(aggs), group, self.read_ht)
        stats = self.stats()
        stats.update(combine="mesh", shards_scanned=len(shards))
        return tuple(np.asarray(o) for o in outs), np.asarray(counts), stats

    def stats(self) -> dict:
        return {"read_ht": self.read_ht,
                "shards": len(self.snapshots),
                "pinned_files": sum(len(s.sst_paths)
                                    for s in self.snapshots),
                "blocks": sum(s.stats.get("blocks", 0)
                              for s in self.snapshots),
                "keyless_blocks": sum(s.stats.get("keyless_blocks", 0)
                                      for s in self.snapshots)}

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for snap in self.snapshots:
            snap.close()

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "BypassSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
