"""Hybrid logical clock time values.

Counterpart of ``yugabyte_db_tpu/utils/hybrid_time.py``:
``HybridTime`` (a 64-bit value, physical microseconds in the high 52
bits and a 12-bit logical component; reference:
src/yb/common/hybrid_time.h:63), ``DocHybridTime`` (hybrid time plus the
intra-transaction write id, in the descending 12-byte key encoding;
reference: src/yb/common/doc_hybrid_time.h) and the tablet's clocks
(``PhysicalClock``, ``MockPhysicalClock``, ``HybridClock``; reference:
src/yb/server/hybrid_clock.h:89).  The reference's ``LogicalClock`` has
no caller in the port."""
from __future__ import annotations

import threading
import time
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

    def add_micros(self, micros: int) -> "HybridTime":
        return HybridTime(self.value + (micros << kBitsForLogicalComponent))

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


class PhysicalClock:
    """Wall-clock microseconds (reference: src/yb/server/hybrid_clock.h)."""

    def now_micros(self) -> int:
        return time.time_ns() // 1000


class MockPhysicalClock(PhysicalClock):
    """Manually advanced clock for tests (reference:
    server/skewed_clock.h, MockHybridClock): two tablets sharing one
    read the same points."""

    def __init__(self, start_micros: int = 1_000_000):
        self._now = start_micros

    def now_micros(self) -> int:
        return self._now

    def advance_micros(self, d: int) -> None:
        self._now += d


class HybridClock:
    """HLC: monotonic hybrid time from a (possibly non-monotonic)
    physical clock; ``update`` ratchets past an observed remote hybrid
    time."""

    def __init__(self, physical: PhysicalClock | None = None):
        self._physical = physical or PhysicalClock()
        self._last = 0
        self._lock = threading.Lock()

    def now(self) -> HybridTime:
        with self._lock:
            phys = self._physical.now_micros() << kBitsForLogicalComponent
            self._last = max(phys, self._last + 1)
            return HybridTime(self._last)

    def update(self, observed: HybridTime) -> None:
        """Ratchet the local clock past an observed hybrid time."""
        with self._lock:
            if observed.value > self._last:
                self._last = observed.value

    def max_global_now(self) -> HybridTime:
        # the uncertainty window's upper bound: a fixed 500 ms, the
        # reference's default max clock skew
        return self.now().add_micros(500_000)
