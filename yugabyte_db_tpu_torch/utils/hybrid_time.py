"""Hybrid logical clock time values.

Counterpart of ``yugabyte_db_tpu/utils/hybrid_time.py`` cut to the
values the bulk load and compaction use: ``HybridTime`` (a 64-bit value,
physical microseconds in the high 52 bits and a 12-bit logical
component; reference: src/yb/common/hybrid_time.h:63) and
``DocHybridTime`` (hybrid time plus the intra-transaction write id, in
the descending 12-byte key encoding; reference:
src/yb/common/doc_hybrid_time.h).  The clocks stay with the tablet
(ROADMAP.md queue 1 item 9)."""
from __future__ import annotations

from dataclasses import dataclass
from functools import total_ordering

kBitsForLogicalComponent = 12


@total_ordering
@dataclass(frozen=True)
class HybridTime:
    """64-bit hybrid time: (physical_micros << 12) | logical."""

    value: int = 0

    @classmethod
    def from_micros(cls, micros: int, logical: int = 0) -> "HybridTime":
        return cls((micros << kBitsForLogicalComponent) | logical)

    def __lt__(self, other: "HybridTime") -> bool:
        return self.value < other.value


@total_ordering
@dataclass(frozen=True)
class DocHybridTime:
    """HybridTime plus intra-transaction write index; orders by hybrid
    time, then write id."""

    ht: HybridTime
    write_id: int = 0

    def __lt__(self, other: "DocHybridTime") -> bool:
        return (self.ht.value, self.write_id) < (other.ht.value,
                                                 other.write_id)

    # 96-bit packed form used in keys, encoded DESCENDING so that within
    # one doc key the newest version sorts first (reference:
    # src/yb/common/doc_hybrid_time.cc AppendEncodedInDocDbFormat)
    def encoded_desc(self) -> bytes:
        packed = (self.ht.value << 32) | self.write_id
        return (packed ^ ((1 << 96) - 1)).to_bytes(12, "big")

    @classmethod
    def decode_desc(cls, data: bytes) -> "DocHybridTime":
        packed = int.from_bytes(data[:12], "big") ^ ((1 << 96) - 1)
        return cls(HybridTime(packed >> 32), packed & 0xFFFFFFFF)


#: bytes of an encoded DocHybridTime (8-byte hybrid time + 4-byte write
#: id, dockv/bulk.append_hybrid_times)
ENCODED_SIZE = 12
