"""Hash and range partitioning of tables into tablets.

Counterpart of ``yugabyte_db_tpu/dockv/partition.py``: ``MAX_HASH``,
the per-row 16-bit hash (``hash_key_for``), ``Partition`` and
``PartitionSchema`` (per-row doc keys, even hash-space splits or range
splits at explicit points).  Tablet splitting
(``split_partition``) is not ported."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from .key_encoding import DocKey, KeyEntryValue, encode_key_entry

MAX_HASH = 0x10000  # 16-bit hash space, like the reference

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_M64 = (1 << 64) - 1


def hash_key_for(entries: Sequence[KeyEntryValue]) -> int:
    """Deterministic 16-bit hash of the hashed key components: FNV-1a
    over their order-preserving encoding, folded to 16 bits — the value
    dockv/bulk.py fast_hash16_from_encoded computes in bulk."""
    h = _FNV_OFFSET
    for e in entries:
        for b in encode_key_entry(e):
            h = ((h ^ b) * _FNV_PRIME) & _M64
    h ^= h >> 32
    return h & 0xFFFF


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

    def doc_key_for_row(self, pk_entries: Sequence[KeyEntryValue]
                        ) -> DocKey:
        if self.kind == "hash":
            n = self.num_hash_columns
            return DocKey.make(hash=hash_key_for(pk_entries[:n]),
                               hashed=pk_entries[:n], range=pk_entries[n:])
        return DocKey.make(range=pk_entries)

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
