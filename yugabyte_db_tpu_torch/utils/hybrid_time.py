"""Hybrid logical clock time value.

Counterpart of ``yugabyte_db_tpu/utils/hybrid_time.py`` cut to
``HybridTime`` as the bulk load uses it: a 64-bit value, physical
microseconds in the high 52 bits and a 12-bit logical component
(reference: src/yb/common/hybrid_time.h:63)."""
from __future__ import annotations

from dataclasses import dataclass
from functools import total_ordering


@total_ordering
@dataclass(frozen=True)
class HybridTime:
    """64-bit hybrid time: (physical_micros << 12) | logical."""

    value: int = 0

    def __lt__(self, other: "HybridTime") -> bool:
        return self.value < other.value


#: bytes of an encoded DocHybridTime (8-byte hybrid time + 4-byte write
#: id, dockv/bulk.append_hybrid_times)
ENCODED_SIZE = 12
