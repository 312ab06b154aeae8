"""Tablet: one shard of one table — its LSM store, codec and reads.

Counterpart of ``yugabyte_db_tpu/tablet/tablet.py`` (reference:
src/yb/tablet/tablet.h:151, tablet.cc:2303 HandlePgsqlReadRequest) cut
to the read seam: ``bulk_load`` into columnar SSTs, ``read`` of
aggregate requests through ``DocReadOperation`` on the tablet's device,
``compact`` and the size accessors.  Writes (``apply_write``, the
memtable, WAL and flush), colocation, ``alter_table``, truncate,
snapshots and vector indexes come with the storage/SQL tier copies
(ROADMAP.md queue 1 items 7 and 9)."""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..device import DeviceLike, resolve_device
from ..docdb.compaction import tpu_compact
from ..docdb.operations import DocReadOperation, ReadRequest, ReadResponse
from ..docdb.table_codec import TableCodec, TableInfo
from ..errors import NotPortedError
from ..ops.device_batch import DeviceBlockCache
from ..storage.lsm import LsmStore
from ..utils import flags
from ..utils.hybrid_time import HybridClock, HybridTime

_STORE_ITEM = "queue 1 item 9 (storage and SQL tier copies)"

#: process-wide device block cache shared by all tablets (device memory
#: is global); keys carry the store, its SSTs and the device
_DEVICE_CACHE = DeviceBlockCache()


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
            key_builder=self.codec.derive_keys,
            shred_cols=self.codec.shred_cols)
        self._read_op = DocReadOperation(
            self.codec, self.regular, device_cache=_DEVICE_CACHE,
            device=self.device)

    def _codec_for(self, table_id: str) -> TableCodec:
        return self.codecs.get(table_id, self.codec)

    # --- reads ------------------------------------------------------------
    def read(self, req: ReadRequest) -> ReadResponse:
        """Serve one read; with no read point the tablet's clock assigns
        one, and the read may restart on the clock-uncertainty window."""
        if req.read_ht is None:
            req.read_ht = self.clock.now().value
            req.server_assigned_read_ht = True
        return self._read_op.execute(req)

    # --- maintenance ------------------------------------------------------
    def flush(self, wait: bool = True) -> Optional[str]:
        """Nothing to flush: the port's store has no memtable."""
        return None

    def history_cutoff(self) -> int:
        retention_us = flags.get("history_retention_interval_sec") \
            * 1_000_000
        now = self.clock.now()
        return max(0, now.value - (retention_us << 12))

    def compact(self, major: bool = True) -> Optional[str]:
        """Major compaction with MVCC GC: the pipelined chunked engine
        with the merge on the card when ``tpu_compaction_enabled`` is
        set, the host baseline when it is off.  The reference's native
        per-chunk merge for a CPU backend is not ported."""
        if not major:
            raise NotPortedError("minor compaction (pick_compaction)",
                                 _STORE_ITEM)
        inputs = self.regular.ssts
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
