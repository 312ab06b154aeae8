"""K-way merge over sorted KV iterators.

Counterpart of ``yugabyte_db_tpu/storage/merge.py`` (analog of the
reference's MergingIterator, src/yb/rocksdb/table/merger.cc). Sources must be given
newest-first; on exact key ties only the newest source's entry is
yielded (possible after replay re-applies an operation).

The device compaction path (ops/compaction.py) replaces this heap loop
with a sort over whole blocks; this iterator serves reads and the CPU
compaction feed.
"""
from __future__ import annotations

import heapq
from typing import Iterable, Iterator, Tuple


def merging_iterator(sources: Iterable[Iterator[Tuple[bytes, bytes]]]
                     ) -> Iterator[Tuple[bytes, bytes]]:
    heap = []
    iters = []
    for si, it in enumerate(sources):
        iters.append(it)
        try:
            k, v = next(it)
            heap.append((k, si, v))
        except StopIteration:
            pass
    heapq.heapify(heap)
    last_key = None
    while heap:
        k, si, v = heapq.heappop(heap)
        if k != last_key:
            yield k, v
            last_key = k
        try:
            nk, nv = next(iters[si])
            heapq.heappush(heap, (nk, si, nv))
        except StopIteration:
            pass
