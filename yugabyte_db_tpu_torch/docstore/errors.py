"""Typed document-pushdown ineligibility.

Every reason a doc predicate/aggregate cannot run over shredded lanes
is a named constant carried on the exception, mirroring the bypass
reader's contract (bypass/errors.py): a refusal is never a user error —
the caller falls back to the interpreted row path, which serves every
shape byte-identically to the pre-shred system.
"""
from __future__ import annotations

#: doc_shred_enabled is off (pushdown never engages)
REASON_OFF = "doc_shred_off"
#: some block in the scan has no shredded lane for a referenced path
#: (v1 SSTs, pre-shred v2 SSTs, memtable-built blocks, or a block where
#: the path was heterogeneous / array-valued / under-covered)
REASON_UNSHREDDED_BLOCK = "unshredded_block"
#: the path's shredded kind differs across blocks (an int-typed block
#: next to a string-typed one cannot share a device lane)
REASON_KIND_MISMATCH = "kind_mismatch"
#: the expression uses a doc path in a shape the device cannot serve
#: bit-identically (ordering compares over numeric paths run in TEXT
#: order interpreted; array subscripts; unsupported casts)
REASON_DOC_SHAPE = "doc_shape"
#: the json chain does not bottom out at a JSON column reference
REASON_NOT_DOC_COLUMN = "not_doc_column"

ALL_REASONS = (REASON_OFF, REASON_UNSHREDDED_BLOCK,
               REASON_KIND_MISMATCH, REASON_DOC_SHAPE,
               REASON_NOT_DOC_COLUMN)


class DocIneligible(Exception):
    """This doc predicate/aggregate cannot run over shredded lanes; the
    caller falls back to the interpreted row path. `reason` is one of
    the REASON_* constants; `detail` is free-form context for logs."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        self.detail = detail
        super().__init__(f"doc pushdown ineligible: {reason}"
                         + (f" ({detail})" if detail else ""))
