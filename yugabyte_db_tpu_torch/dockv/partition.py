"""Hash partitioning of tables into tablets.

Counterpart of ``yugabyte_db_tpu/dockv/partition.py`` cut to what the
single-tablet bulk load reads: ``MAX_HASH``, ``Partition`` and the hash
``PartitionSchema``.  Range partitioning and multi-tablet splits stay in
ROADMAP.md (the tablet read seam)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

MAX_HASH = 0x10000  # 16-bit hash space, like the reference


@dataclass(frozen=True)
class Partition:
    """One tablet's key-space slice [start, end) over the 2-byte
    big-endian partition hash; empty bytes mean -inf / +inf."""

    start: bytes = b""
    end: bytes = b""


@dataclass(frozen=True)
class PartitionSchema:
    """kind 'hash': the leading ``num_hash_columns`` PK columns are
    hashed to 16 bits (dockv/bulk.fast_hash16_from_encoded)."""

    kind: str = "hash"
    num_hash_columns: int = 1

    def create_partitions(self, num_tablets: int) -> List[Partition]:
        """Even hash-space split (reference:
        PartitionSchema::CreateHashPartitions)."""
        if self.kind != "hash":
            raise NotImplementedError(
                "range partitioning is not ported (ROADMAP.md queue 1: "
                "tablet read seam and stream_scan)")
        step = MAX_HASH // num_tablets
        parts = []
        for i in range(num_tablets):
            start = (i * step).to_bytes(2, "big") if i else b""
            end = ((i + 1) * step).to_bytes(2, "big") \
                if i + 1 < num_tablets else b""
            parts.append(Partition(start, end))
        return parts
