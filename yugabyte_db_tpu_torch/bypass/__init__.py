"""Analytics bypass reader: snapshot-consistent SST-direct scans that
never touch the tserver hot path.

Counterpart of ``yugabyte_db_tpu/bypass/``: :func:`pin_tablet` freezes
a read point and leases the SST file set against file GC
(storage/lsm.py); :mod:`bypass.scan` opens the leased files directly
and streams their v2 columnar blocks through the shared pow2-bucket
kernel pipeline, with a near-data prefilter (:mod:`bypass.prefilter`,
the host library's range pass) compacting rows before batch formation;
:class:`BypassSession` fans that out across tablet shards and combines
the partials on the host.  Ineligible shapes raise
:class:`BypassIneligible` with a typed reason; callers fall back to
``Tablet.read``.
"""
from .errors import (ALL_REASONS, REASON_COLUMN_NOT_FIXED,
                     REASON_EXPR_SHAPE, REASON_FLAG_OFF,
                     REASON_GROUPED_OFF, REASON_HASH_GROUP,
                     REASON_MEMTABLE_ACTIVE, REASON_NO_COLUMNAR,
                     REASON_NO_SSTS, REASON_NOT_AGGREGATE,
                     REASON_NOT_CHUNK_SAFE, REASON_SLOT_OVERFLOW,
                     BypassIneligible)
from .pinner import TabletSnapshot, pin_tablet
from .scan import (bypass_scan_aggregate, collect_keyless_blocks,
                   open_snapshot_readers)
from .session import BypassSession, combine_partials

__all__ = [
    "ALL_REASONS", "BypassIneligible", "BypassSession",
    "REASON_COLUMN_NOT_FIXED", "REASON_EXPR_SHAPE", "REASON_FLAG_OFF",
    "REASON_GROUPED_OFF", "REASON_HASH_GROUP", "REASON_MEMTABLE_ACTIVE",
    "REASON_NO_COLUMNAR", "REASON_NO_SSTS", "REASON_NOT_AGGREGATE",
    "REASON_NOT_CHUNK_SAFE", "REASON_SLOT_OVERFLOW",
    "TabletSnapshot", "bypass_scan_aggregate", "collect_keyless_blocks",
    "combine_partials", "open_snapshot_readers", "pin_tablet",
]
