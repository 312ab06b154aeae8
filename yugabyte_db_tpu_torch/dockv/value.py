"""Value-side type bytes of KV pairs.

Counterpart of ``yugabyte_db_tpu/dockv/value.py`` cut to ``ValueKind``:
compaction reads tombstones from a block's ``tombstone`` lane, so no
value is decoded here.  The TTL envelopes (``wrap_ttl``/``unwrap_ttl``)
and primitive values come with the row paths (ROADMAP.md queue 1 item
9)."""
from __future__ import annotations


class ValueKind:
    kNull = 0x00
    kFalse = 0x01
    kTrue = 0x02
    kInt32 = 0x03
    kInt64 = 0x04
    kDouble = 0x05
    kFloat = 0x06
    kString = 0x07
    kBytes = 0x08
    kTimestamp = 0x09
    kDecimal = 0x0A
    kJson = 0x0B
    kTombstone = 0x10        # row/cell deletion marker
    kPackedRowV1 = 0x20      # row-as-single-KV, nested-values format
    kPackedRowV2 = 0x21      # row-as-single-KV, columnar-friendly format
    kMergeFlags = 0x30       # TTL etc. prefix
    kRowLock = 0x31          # lock-only intent value
