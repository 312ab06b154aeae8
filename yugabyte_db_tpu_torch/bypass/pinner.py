"""Snapshot pinner: a frozen read point plus a leased SST file list that
survives a concurrent compaction.

Counterpart of ``yugabyte_db_tpu/bypass/pinner.py``.  The invariant a
pinned snapshot keeps: every row version with ``ht <= read_ht`` lives
in the pinned SST files, because

  1. ``read_ht`` is taken from the tablet clock first (or the clock is
     ratcheted past an explicit read point), so every later write gets
     a larger hybrid time and MVCC filtering hides it;
  2. the memtable is flushed until empty, and the pin itself
     (``LsmStore.pin_ssts(require_empty_memtable=True)``) checks that
     under the lock that installs flush output;
  3. the lease refcounts the files against the store's GC: a compaction
     replaces the live set, but the unlink of pinned inputs waits for
     the release.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..storage.lsm import SstLease
from ..utils.hybrid_time import HybridTime
from .errors import REASON_MEMTABLE_ACTIVE, REASON_NO_SSTS, BypassIneligible


@dataclass
class TabletSnapshot:
    """One tablet's frozen read point and leased SST file set; the codec
    rides along for schema access.  The scanner opens the files
    itself, never through the store."""

    tablet_id: str
    read_ht: int
    sst_paths: List[str]
    lease: SstLease
    codec: object                      # docdb TableCodec
    stats: dict = field(default_factory=dict)

    def close(self) -> None:
        self.lease.release()

    @property
    def closed(self) -> bool:
        return self.lease.released


def pin_tablet(tablet, read_ht: Optional[int] = None,
               table_id: Optional[str] = None,
               max_flush_attempts: int = 4,
               allow_empty: bool = False,
               safe_time_fn=None, safe_wait_s: float = 10.0
               ) -> TabletSnapshot:
    """Pin `tablet` at a frozen read point.  Raises BypassIneligible
    (memtable_active) when rows at or below the read point cannot be
    proven on disk after ``max_flush_attempts`` flushes, or when
    ``safe_time_fn`` (callable(now) -> the MVCC safe read time of a
    consensus-served tablet) does not pass the read point within
    ``safe_wait_s``; (no_ssts) when the tablet has no SST files, unless
    ``allow_empty``."""
    if read_ht is None:
        read_ht = tablet.clock.now().value
    else:
        # ratchet: later writes never get a hybrid time at or below the
        # chosen read point
        tablet.clock.update(HybridTime(read_ht))
    if safe_time_fn is not None:
        deadline = time.monotonic() + safe_wait_s
        # the first call unguarded: a mis-wired safe_time_fn surfaces as
        # its own error
        if safe_time_fn(tablet.clock.now().value) < read_ht:
            while True:
                try:
                    if safe_time_fn(tablet.clock.now().value) >= read_ht:
                        break
                except Exception:   # noqa: BLE001 — transient misread
                    pass
                if time.monotonic() > deadline:
                    raise BypassIneligible(
                        REASON_MEMTABLE_ACTIVE,
                        f"tablet {tablet.tablet_id}: in-flight writes "
                        "below the read point did not drain")
                time.sleep(0.002)
    store = tablet.regular
    lease = None
    for attempt in range(max_flush_attempts):
        if attempt:
            time.sleep(0.005 * attempt)
        if not store.memtable_empty():
            tablet.flush(wait=False)
        lease = store.pin_ssts(require_empty_memtable=True)
        if lease is not None:
            break
    if lease is None:
        raise BypassIneligible(
            REASON_MEMTABLE_ACTIVE,
            f"tablet {tablet.tablet_id}: memtable still holds rows "
            f"after {max_flush_attempts} flush attempts")
    if not lease.paths and not allow_empty:
        lease.release()
        raise BypassIneligible(
            REASON_NO_SSTS, f"tablet {tablet.tablet_id} has no SSTs")
    codec = tablet._codec_for(table_id) if table_id else tablet.codec
    return TabletSnapshot(
        tablet_id=tablet.tablet_id, read_ht=read_ht,
        sst_paths=list(lease.paths), lease=lease, codec=codec,
        stats={"flush_attempts": attempt + 1,
               "pinned_files": len(lease.paths)})
