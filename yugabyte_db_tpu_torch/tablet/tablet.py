"""Tablet: one shard of one table — its LSM store, codec, writes, reads
and compaction.

Counterpart of ``yugabyte_db_tpu/tablet/tablet.py`` (reference:
src/yb/tablet/tablet.h:151, tablet.cc:2303 HandlePgsqlReadRequest, :1938
ApplyRowOperations): ``apply_write`` through ``DocWriteOperation`` into
the memtable, with the flush on the apply path (async: the memtable
freezes on the apply thread and a two-worker flush pool writes the SST;
backpressure past ``max_frozen_memtables``); ``flush``; ``read`` and
``multi_read`` through ``DocReadOperation`` on the tablet's device;
``bulk_load`` into columnar SSTs; ``compact`` (major, or the oldest run
that ``pick_compaction`` picks) and the size accessors.  The flush
thread writes files on the host and makes no CUDA call: a read that
holds a device batch keeps its tensors alive by reference.  Colocation,
``alter_table``, truncate, snapshots, the WAL, metrics and trace spans
and vector indexes are not ported (ROADMAP.md queue 1 items 7 and 9)."""
from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from time import perf_counter as _perf_counter
from typing import Dict, Optional

import numpy as np

from ..device import DeviceLike, resolve_device
from ..docdb.compaction import tpu_compact
from ..docdb.operations import (DocReadOperation, DocWriteOperation,
                                ReadRequest, ReadResponse, ReadRestartError,
                                WriteRequest, WriteResponse)
from ..docdb.table_codec import TableCodec, TableInfo
from ..errors import NotPortedError
from ..ops.device_batch import DeviceBlockCache
from ..storage.lsm import LsmStore
from ..utils import flags
from ..utils.hybrid_time import HybridClock, HybridTime

log = logging.getLogger("ybtpu_torch.tablet")

_STORE_ITEM = "queue 1 item 9a (colocation and the native compaction backend)"

#: process-wide device block cache shared by all tablets (device memory
#: is global); keys carry the store, its SSTs, its write generation and
#: the device
_DEVICE_CACHE = DeviceBlockCache()

#: bounded background flush executor shared by all tablets: the async
#: flush freezes the memtable on the apply thread and runs the SST write
#: and fsync here (reference: the RocksDB flush thread pool).  Two
#: workers: a flush streaming to a stalled disk must not park every
#: other tablet's flush behind it.
_FLUSH_POOL = ThreadPoolExecutor(max_workers=2,
                                 thread_name_prefix="bg-flush")

#: process-wide flush-on-apply accounting: what the apply thread paid
#: (``handoff_s`` = freeze + submit, ``inline_s`` = backpressure or
#: flag-off inline drains) against what moved to the flush executor
#: (``background_flushes``)
FLUSH_APPLY_STATS = {"handoff_s": 0.0, "inline_s": 0.0, "handoffs": 0,
                     "inline_flushes": 0, "background_flushes": 0}


class Tablet:
    """One tablet on `device` (CUDA unless the caller passes "cpu";
    raises without a card)."""

    def __init__(self, tablet_id: str, info: TableInfo, directory: str,
                 clock: Optional[HybridClock] = None,
                 partition=None, colocated: bool = False,
                 device: DeviceLike = "cuda"):
        if colocated:
            raise NotPortedError("colocated tablets", _STORE_ITEM)
        self.device = resolve_device(device)
        self.tablet_id = tablet_id
        self.info = info
        self.partition = partition
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.codec = TableCodec(info)
        self.codecs: Dict[str, TableCodec] = {info.table_id: self.codec}
        self.clock = clock or HybridClock()
        self.regular = LsmStore(
            os.path.join(directory, "regular"), name="regular",
            columnar_builder=self.codec.columnar_builder,
            row_decoder=self.codec.row_decoder,
            key_builder=self.codec.derive_keys,
            shred_cols=self.codec.shred_cols)
        self._read_op = DocReadOperation(
            self.codec, self.regular, device_cache=_DEVICE_CACHE,
            device=self.device)

    def _codec_for(self, table_id: str) -> TableCodec:
        return self.codecs.get(table_id, self.codec)

    # --- writes -----------------------------------------------------------
    def apply_write(self, req: WriteRequest,
                    ht: Optional[HybridTime] = None,
                    op_id=None) -> WriteResponse:
        """Apply one write at `ht` (the tablet's clock by default) and
        trigger a flush when the memtable passes its threshold."""
        ht = ht or self.clock.now()
        batch, n = DocWriteOperation(self._codec_for(req.table_id),
                                     req).apply(ht, op_id=op_id)
        self.regular.apply(batch)
        if self.regular.should_flush():
            self._flush_on_apply()
        return WriteResponse(rows_affected=n)

    def _flush_on_apply(self) -> None:
        """Flush trigger on the apply path.  Async (the default): freeze
        the active memtable (a pointer swap) and hand the SST write to
        the flush executor, so the apply thread never waits on disk;
        past ``max_frozen_memtables`` frozen memtables the apply thread
        drains one inline instead (backpressure).  Flag off: the inline
        flush."""
        t0 = _perf_counter()
        if not flags.get("async_flush_enabled"):
            self.flush()
            FLUSH_APPLY_STATS["inline_flushes"] += 1
            FLUSH_APPLY_STATS["inline_s"] += _perf_counter() - t0
            return
        if self.regular.freeze_active():
            FLUSH_APPLY_STATS["handoffs"] += 1
            _FLUSH_POOL.submit(self._background_flush)
        while (self.regular.frozen_count()
               > flags.get("max_frozen_memtables")):
            # the executor fell behind: the apply thread drains one
            # frozen memtable, bounding frozen memory
            ti = _perf_counter()
            if self.regular.flush_frozen() is not None:
                _DEVICE_CACHE.invalidate_prefix((id(self.regular),))
            FLUSH_APPLY_STATS["inline_flushes"] += 1
            FLUSH_APPLY_STATS["inline_s"] += _perf_counter() - ti
        FLUSH_APPLY_STATS["handoff_s"] += _perf_counter() - t0

    def _background_flush(self) -> None:
        """Flush-executor job: drain frozen memtables (oldest first,
        serialized by the store's flush IO lock) until none is left,
        invalidating the device cache per install.  It does not wait on
        the IO lock: another flush that owns it drains everything
        queued.  A failed flush leaves the frozen memtable queued for
        the next trigger, an inline drain or ``flush()``."""
        try:
            while self.regular.flush_frozen(wait=False) is not None:
                _DEVICE_CACHE.invalidate_prefix((id(self.regular),))
                FLUSH_APPLY_STATS["background_flushes"] += 1
        except Exception:   # noqa: BLE001 — must not kill the pool
            log.exception("%s: background flush failed (frozen memtable "
                          "retained for retry)", self.tablet_id)

    # --- reads ------------------------------------------------------------
    def read(self, req: ReadRequest) -> ReadResponse:
        """Serve one read; with no read point the tablet's clock assigns
        one, and the read may restart on the clock-uncertainty window."""
        if req.read_ht is None:
            req.read_ht = self.clock.now().value
            req.server_assigned_read_ht = True
        return self._read_op.execute(req)

    def multi_read(self, table_id: str, pk_rows, read_ht=None,
                   allow_restart=None):
        """Batched point reads at one read point: a row dict (or None)
        per pk_row.  `allow_restart` defaults to "the read point was
        server-assigned"."""
        server_assigned = read_ht is None
        if allow_restart is None:
            allow_restart = server_assigned
        if server_assigned:
            read_ht = self.clock.now().value
        op = self._read_op
        for _attempt in range(3):
            try:
                return op.multi_get(pk_rows, read_ht,
                                    allow_restart=allow_restart)
            except ReadRestartError as e:
                read_ht = e.restart_ht
        return op.multi_get(pk_rows, read_ht, allow_restart=False)

    def safe_time(self) -> HybridTime:
        return self.clock.now()

    # --- maintenance ------------------------------------------------------
    def flush(self, wait: bool = True) -> Optional[str]:
        """Freeze the memtable and drain every frozen memtable to SSTs:
        the barrier behind which every applied write is on disk."""
        path = self.regular.flush(wait=wait)
        if path:
            _DEVICE_CACHE.invalidate_prefix((id(self.regular),))
        return path

    def history_cutoff(self) -> int:
        retention_us = flags.get("history_retention_interval_sec") \
            * 1_000_000
        now = self.clock.now()
        return max(0, now.value - (retention_us << 12))

    def compact(self, major: bool = True) -> Optional[str]:
        """Compaction with MVCC GC after a flush, of every SST (major) or
        of the oldest run ``pick_compaction`` picks: the pipelined
        chunked engine with the merge on the card when
        ``tpu_compaction_enabled`` is set (row blocks and TTL'd rows
        through ``_compact_rows``, its whole-input merge also on the
        card), the host baseline when it is off.  The reference's native
        per-chunk merge for a CPU backend is not ported."""
        self.flush()
        inputs = self.regular.ssts if major else \
            self.regular.pick_compaction()
        if not inputs:
            return None
        cutoff = self.history_cutoff()
        if not flags.get("tpu_compaction_enabled"):
            backend = "baseline"
        elif self.device.type == "cuda":
            backend = "device"
        else:
            raise NotPortedError(
                "the native compaction backend of a CPU tablet",
                _STORE_ITEM)
        path = tpu_compact(self.regular, self.codec, cutoff, inputs=inputs,
                           backend=backend, device=self.device)
        _DEVICE_CACHE.invalidate_prefix((id(self.regular),))
        return path

    def bulk_load(self, columns: Dict[str, np.ndarray],
                  ht: Optional[HybridTime] = None,
                  block_rows: int = 65536) -> int:
        """Ingest column arrays as one new SST (rows outside this
        tablet's partition are dropped, so the same arrays feed every
        tablet of a table); returns the rows written."""
        ht = ht or self.clock.now()
        return self.codec.bulk_ingest(self.regular, columns, ht,
                                      block_rows=block_rows,
                                      partition=self.partition)

    def approximate_size(self) -> int:
        return self.regular.approximate_size()

    def num_sst_files(self) -> int:
        return len(self.regular.ssts)
