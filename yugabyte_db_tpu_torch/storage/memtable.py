"""In-memory sorted write buffer.

Counterpart of ``yugabyte_db_tpu/storage/memtable.py`` (analog of the
reference's RocksDB memtable, src/yb/rocksdb/memtable/). Keys are full encoded
SubDocKeys (doc key + HT suffix), so all versions of a row are adjacent
and newest sorts first; duplicate exact keys keep the latest insert.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

from ..dockv.key_encoding import ValueType
from ..utils.hybrid_time import ENCODED_SIZE
from ..utils.sortedcompat import SortedDict

#: row keys end with the kHybridTime marker + desc-encoded DocHybridTime
_HT_SUFFIX = ENCODED_SIZE + 1


class MemTable:
    def __init__(self):
        self._map: SortedDict = SortedDict()
        self._bytes = 0
        self.frozen = False
        # O(1) negative point-probe guard: the doc-key prefixes of all
        # ROW entries (key = prefix + kHybridTime + dht).  Point reads
        # probe the memtable for every key in a batch; on read-heavy
        # workloads almost all probes miss, and the sorted-seek miss
        # costs ~7us vs ~0.1us here.  Keys with any other layout set
        # _foreign_layout, which disables the guard (may_contain_row
        # then always answers True) — the intents store shares this
        # class with differently-shaped keys.
        self._row_prefixes: set = set()
        self._foreign_layout = False

    def put(self, key: bytes, value: bytes) -> None:
        assert not self.frozen
        old = self._map.get(key)
        if old is not None:
            self._bytes -= len(key) + len(old)
        self._map[key] = value
        self._bytes += len(key) + len(value)
        if not self._foreign_layout:
            if len(key) > _HT_SUFFIX and \
                    key[-_HT_SUFFIX] == ValueType.kHybridTime:
                p = key[:-_HT_SUFFIX]
                if p not in self._row_prefixes:
                    self._row_prefixes.add(p)
                    # the guard set is real memory: count it toward the
                    # flush trigger like keys/values
                    self._bytes += len(p)
            else:
                self._foreign_layout = True

    def may_contain_row(self, prefix: bytes) -> bool:
        """False only when NO row with this doc-key prefix is present
        (exact, not probabilistic, unless a foreign-layout key disabled
        the guard)."""
        return self._foreign_layout or prefix in self._row_prefixes

    def approximate_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._map)

    def empty(self) -> bool:
        return not self._map

    def freeze(self) -> None:
        self.frozen = True

    def iterate(self, lower: Optional[bytes] = None,
                upper: Optional[bytes] = None
                ) -> Iterator[Tuple[bytes, bytes]]:
        """Entries with lower <= key < upper, ascending."""
        for k in self._map.irange(lower, upper, inclusive=(True, False)):
            yield k, self._map[k]

    def seek(self, key: bytes) -> Iterator[Tuple[bytes, bytes]]:
        return self.iterate(lower=key)
