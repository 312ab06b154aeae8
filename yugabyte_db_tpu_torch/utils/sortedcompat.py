"""A sorted map for the memtable.

Counterpart of ``yugabyte_db_tpu/utils/sortedcompat.py``'s fallback
class: the memtable needs item get/set, ``get``, ``len``, truthiness and
``irange``.  Writes append to an unsorted pending list; the sorted key
list is re-established lazily on the first ordered read.  Timsort merges
the (sorted prefix + sorted pending) runs in about O(n), so a burst of
writes between reads costs one merge, not one insort per put.  One
implementation serves every machine: the package never looks for
``sortedcontainers``."""
from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Iterator


class SortedDict:
    def __init__(self):
        self._data: dict = {}
        self._keys: list = []       # sorted prefix of known keys
        self._pending: list = []    # unsorted new keys since last sort

    def __setitem__(self, key, value) -> None:
        if key not in self._data:
            self._pending.append(key)
        self._data[key] = value

    def __getitem__(self, key):
        return self._data[key]

    def get(self, key, default=None):
        return self._data.get(key, default)

    def __contains__(self, key) -> bool:
        return key in self._data

    def __len__(self) -> int:
        return len(self._data)

    def _sorted_keys(self) -> list:
        if self._pending:
            self._pending.sort()
            self._keys.extend(self._pending)
            self._keys.sort()       # timsort: merge of two sorted runs
            self._pending = []
        return self._keys

    def __iter__(self) -> Iterator:
        return iter(self._sorted_keys())

    def keys(self):
        return self._sorted_keys()

    def items(self):
        d = self._data
        return [(k, d[k]) for k in self._sorted_keys()]

    def irange(self, minimum=None, maximum=None,
               inclusive=(True, True)) -> Iterator:
        ks = self._sorted_keys()
        lo = 0
        if minimum is not None:
            lo = (bisect_left(ks, minimum) if inclusive[0]
                  else bisect_right(ks, minimum))
        hi = len(ks)
        if maximum is not None:
            hi = (bisect_right(ks, maximum) if inclusive[1]
                  else bisect_left(ks, maximum))
        return iter(ks[lo:hi])
