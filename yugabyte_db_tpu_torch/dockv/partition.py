"""Hash and range partitioning of tables into tablets.

Counterpart of ``yugabyte_db_tpu/dockv/partition.py`` cut to what the
bulk load and the tablet read seam use: ``MAX_HASH``, ``Partition`` and
``PartitionSchema.create_partitions`` (even hash-space splits, or range
splits at explicit points).  Per-row partition keys and tablet
splitting come with the write path (ROADMAP.md queue 1 item 9)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

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
    hashed to 16 bits (dockv/bulk.fast_hash16_from_encoded); kind
    'range': tablets own ranges of the encoded range key."""

    kind: str = "hash"
    num_hash_columns: int = 1

    def create_partitions(self, num_tablets: int,
                          split_points: Optional[List[bytes]] = None
                          ) -> List[Partition]:
        """Even hash-space split (reference:
        PartitionSchema::CreateHashPartitions) or, for a range schema,
        one partition per gap between explicit split points."""
        if self.kind == "range":
            bounds = [b""] + list(split_points or []) + [b""]
            return [Partition(bounds[i], bounds[i + 1])
                    for i in range(len(bounds) - 1)]
        step = MAX_HASH // num_tablets
        parts = []
        for i in range(num_tablets):
            start = (i * step).to_bytes(2, "big") if i else b""
            end = ((i + 1) * step).to_bytes(2, "big") \
                if i + 1 < num_tablets else b""
            parts.append(Partition(start, end))
        return parts
