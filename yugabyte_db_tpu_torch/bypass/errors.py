"""Typed bypass-ineligibility: every reason a tablet falls back to the
RPC scan path is a named constant, carried on the exception, so callers
(and tests) can assert WHY a scan refused to bypass.

Counterpart of ``yugabyte_db_tpu/bypass/errors.py``, with the
reference's reason strings.  A bypass refusal is not an error to the
user: the caller routes the query back through ``Tablet.read``.
"""
from __future__ import annotations

#: master switch off (client-level routing refusal)
REASON_FLAG_OFF = "flag_off"
#: memtable (active or frozen) still holds rows after the flush
#: attempts — rows at or below the read point may not be on disk yet
REASON_MEMTABLE_ACTIVE = "memtable_active"
#: the tablet has no SST files (nothing to scan directly; the RPC path
#: answers from the memtable)
REASON_NO_SSTS = "no_ssts"
#: an SST block lacks a columnar sidecar (row-format-only data)
REASON_NO_COLUMNAR = "no_columnar_block"
#: block sequence is not provably one disjoint sorted unique-key run
#: (overlapping SSTs, duplicate doc keys, or missing boundary keys)
REASON_NOT_CHUNK_SAFE = "not_chunk_safe"
#: a referenced column exists only in varlen/dictionary form — the
#: keyless scanner serves fixed-width lanes only
REASON_COLUMN_NOT_FIXED = "column_not_fixed"
#: hash-grouped aggregates don't combine densely across shards
REASON_HASH_GROUP = "hash_group"
#: the expression shape can't compile to the device kernel
REASON_EXPR_SHAPE = "expr_shape"
#: no aggregates in the request (the bypass engine serves
#: scan-and-aggregate shapes only, not row streams)
REASON_NOT_AGGREGATE = "not_aggregate"
#: dict-grouped scan overflowed the device slot budget — the RPC path's
#: interpreted GROUP BY serves the over-cardinality group set
REASON_SLOT_OVERFLOW = "grouped_slot_overflow"
#: dict-grouped scan while grouped_pushdown_enabled is off — the RPC
#: path's interpreted GROUP BY is the flag-off contract
REASON_GROUPED_OFF = "grouped_pushdown_off"
#: join request while join_pushdown_enabled / plan fusion is off — the
#: RPC path's interpreted join is the flag-off contract
REASON_JOIN_OFF = "join_pushdown_off"
#: the shipped build side can't be served exactly by the device join
#: (duplicate keys, oversized table, unsupported key type) — carries
#: the ops/join_scan typed reason in `detail`
REASON_JOIN_SHAPE = "join_shape"
#: doc-path request while doc_shred_enabled is off — the RPC path's
#: interpreted extractor is the flag-off contract
REASON_DOC_OFF = "doc_shred_off"
#: a doc-path shape the shredded lanes can't serve bit-identically
#: (unshredded/heterogeneous path, text-order compare over a numeric
#: lane, ...) — carries the docstore typed reason in `detail`
REASON_DOC_SHAPE = "doc_shape"

ALL_REASONS = (
    REASON_FLAG_OFF, REASON_MEMTABLE_ACTIVE, REASON_NO_SSTS,
    REASON_NO_COLUMNAR, REASON_NOT_CHUNK_SAFE, REASON_COLUMN_NOT_FIXED,
    REASON_HASH_GROUP, REASON_EXPR_SHAPE, REASON_NOT_AGGREGATE,
    REASON_SLOT_OVERFLOW, REASON_GROUPED_OFF, REASON_JOIN_OFF,
    REASON_JOIN_SHAPE, REASON_DOC_OFF, REASON_DOC_SHAPE,
)


class BypassIneligible(Exception):
    """This tablet/query cannot be served by the bypass reader; the
    caller falls back to the RPC path.  `reason` is one of the
    REASON_* constants; `detail` is free-form context for logs."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        self.detail = detail
        super().__init__(f"bypass ineligible: {reason}"
                         + (f" ({detail})" if detail else ""))
