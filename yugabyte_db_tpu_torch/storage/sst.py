"""SSTable file format, columnar-only: serialized ColumnarBlocks + bloom +
index + footer.

Counterpart of ``yugabyte_db_tpu/storage/sst.py`` (reference analog:
src/yb/rocksdb/table/block_based_table_{builder,reader}.cc) cut to the
columnar-only files that bulk loads and compaction write.  The bytes
are the reference's: a file either package writes, the other reads.

File layout:
    [columnar block 0][columnar block 1]...
    [bloom filter]
    [index: MessagePack list of per-block entries]
    [footer: MessagePack meta][u32 footer_len]["YBTPUSST"]

The writer writes v2 blocks (the reference's default format); the
reader reads v1 and v2.  Row KV blocks (``add``, ``seek``/``iterate``,
the point readers), document shredding and encrypted files raise
``NotPortedError`` (ROADMAP.md queue 1 item 9).
"""
from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..errors import NotPortedError
from . import native_lib, wire_pack
from .columnar import SUPPORTED_FORMAT_VERSION, ColumnarBlock

MAGIC = b"YBTPUSST"

#: the reference's encrypted-file envelopes (utils/encryption.py)
_ENC_MAGICS = (b"YBTPUENC", b"YBTPUEN2")

_ROWS_ITEM = "ROADMAP.md queue 1 item 9 (row KV blocks and point reads)"
_ENC_ITEM = "ROADMAP.md queue 1 item 9 (encryption at rest)"


class BloomFilter:
    """Double-hashing bloom over 64-bit key hashes (reference:
    src/yb/rocksdb/util/bloom.cc; fixed-key bloom over doc keys)."""

    def __init__(self, bits: np.ndarray, k: int):
        self.bits = bits          # uint8 array
        self.k = k

    @classmethod
    def build(cls, key_hashes: np.ndarray,
              bits_per_key: int = 10) -> "BloomFilter":
        n = max(1, len(key_hashes))
        m = max(64, n * bits_per_key)
        m = (m + 7) // 8 * 8
        k = max(1, min(30, int(round(bits_per_key * 0.69))))
        return cls(native_lib.bloom_build(
            np.asarray(key_hashes, np.uint64), m, k), k)

    def may_contain(self, key_hash: int) -> bool:
        m = len(self.bits) * 8
        h1 = key_hash & 0xFFFFFFFFFFFFFFFF
        h2 = (h1 >> 33) | 1
        for i in range(self.k):
            idx = (h1 + i * h2) % m
            if not (self.bits[idx // 8] >> (idx % 8)) & 1:
                return False
        return True

    def serialize(self) -> bytes:
        return struct.pack("<I", self.k) + self.bits.tobytes()

    @classmethod
    def deserialize(cls, data: bytes) -> "BloomFilter":
        k = struct.unpack_from("<I", data)[0]
        return cls(np.frombuffer(data[4:], np.uint8).copy(), k)


@dataclass
class BlockIndexEntry:
    first_key: bytes
    last_key: bytes
    offset: int
    length: int
    num_rows: int
    col_offset: int = -1
    col_length: int = 0


class SstWriter:
    """Writes one columnar-only SST.  ``stream_columnar=True`` writes
    each block to the file as it is added (the write releases the GIL,
    so a pipelined producer overlaps its gathers with the IO) and, with
    ``sync_every_bytes``, fsyncs from the writer's thread as it goes;
    otherwise blocks are buffered and written by ``finish``.
    ``shred_cols`` (the codec's JSON value columns) must be empty: the
    reference's v2 writer shreds them, which is not ported."""

    def __init__(self, path: str, stream_columnar: bool = False,
                 sync_every_bytes: Optional[int] = None,
                 key_builder=None, shred_cols=None):
        if shred_cols:
            raise NotPortedError(
                f"an SST writer shredding JSON columns {list(shred_cols)}",
                "ROADMAP.md queue 1 item 9 (document shredding)")
        self.path = path
        # callable(cb) -> rebuilt keys matrix | None; when the rebuild
        # byte-matches, the block serializes WITHOUT its keys
        self.key_builder = key_builder
        #: per-lane encode accounting accumulated across this file's
        #: blocks ({"lanes": {lane: {pre_bytes, post_bytes, encodings}}})
        self.lane_stats: dict = {}
        self._stream = stream_columnar
        self._sync_every = sync_every_bytes
        self._synced_to = 0
        self._sf = None
        self._stream_index: List[BlockIndexEntry] = []
        self._blocks: List[ColumnarBlock] = []
        self._key_hashes: List[np.ndarray] = []
        self._num_entries = 0
        self._min_key: Optional[bytes] = None
        self._max_key: Optional[bytes] = None
        self._frontier: dict = {}
        self._last_key: Optional[bytes] = None

    def add(self, key: bytes, value: bytes) -> None:
        raise NotPortedError("row KV entries in an SST", _ROWS_ITEM)

    def _write_block(self, f, cb: ColumnarBlock, e: BlockIndexEntry) -> None:
        head, bufs = cb.serialize_parts(self.key_builder, self.lane_stats)
        e.col_offset = f.tell()
        e.col_length = len(head)
        f.write(head)
        for b in bufs:
            e.col_length += (len(b) if isinstance(b, bytes) else b.nbytes)
            f.write(b if isinstance(b, bytes) else memoryview(b).cast("B"))
        self._key_hashes.append(cb.key_hash)

    def add_columnar_block(self, cb: ColumnarBlock) -> None:
        """A sorted, keyed ColumnarBlock becomes a columnar-only block;
        in stream mode it is serialized to the file immediately."""
        if cb.n == 0:
            raise ValueError("columnar-only blocks need rows")
        # boundary keys from the helpers: a keyless v2 block indexes by
        # its stored boundary keys without materializing the matrix
        first = cb.first_full_key()
        last = cb.last_full_key()
        if first is None or last is None:
            raise ValueError("columnar-only blocks need a keys matrix "
                             "or derived key bounds")
        if self._last_key is not None and first < self._last_key:
            raise ValueError("keys must be added in sorted order")
        self._last_key = last
        if not self._stream:
            self._blocks.append(cb)
            return
        if self._sf is None:
            self._sf = open(self.path + ".tmp", "wb", buffering=1 << 20)
        e = BlockIndexEntry(first_key=first, last_key=last, offset=0,
                            length=0, num_rows=cb.n)
        self._write_block(self._sf, cb, e)
        self._stream_index.append(e)
        self._num_entries += cb.n
        if self._sync_every is not None and \
                self._sf.tell() - self._synced_to >= self._sync_every:
            self._sf.flush()
            os.fsync(self._sf.fileno())
            self._synced_to = self._sf.tell()

    def set_frontier(self, **kv) -> None:
        """Consensus frontier metadata stored in the file (reference:
        UserFrontier in rocksdb files): op_id, max_ht, history_cutoff."""
        self._frontier.update(kv)

    def _finish_tail(self, f, index: List[BlockIndexEntry]) -> None:
        """Bloom + index + footer, shared by the buffered and streaming
        paths."""
        hashes = (np.concatenate(self._key_hashes) if self._key_hashes
                  else np.zeros(0, np.uint64))
        bloom = BloomFilter.build(hashes)
        bloom_off = f.tell()
        braw = bloom.serialize()
        f.write(braw)
        idx_off = f.tell()
        iraw = wire_pack.packb([
            [e.first_key, e.last_key, e.offset, e.length, e.num_rows,
             e.col_offset, e.col_length] for e in index])
        f.write(iraw)
        meta = {
            "num_entries": self._num_entries,
            "min_key": self._min_key, "max_key": self._max_key,
            "bloom_offset": bloom_off, "bloom_length": len(braw),
            "index_offset": idx_off, "index_length": len(iraw),
            "frontier": self._frontier,
            "format_version": SUPPORTED_FORMAT_VERSION,
        }
        fraw = wire_pack.packb(meta)
        f.write(fraw)
        f.write(struct.pack("<I", len(fraw)))
        f.write(MAGIC)

    def abort(self) -> None:
        """Tear down a partially-written SST: close the streaming
        handle and unlink the .tmp (the final path was never created)."""
        if self._sf is not None:
            try:
                self._sf.close()
            except OSError:
                pass
            self._sf = None
        try:
            os.unlink(self.path + ".tmp")
        except OSError:
            pass
        self._blocks = []

    def finish(self) -> dict:
        if self._sf is not None:
            # streaming mode: blocks are already on disk; append the tail
            index = self._stream_index
            self._min_key = index[0].first_key
            self._max_key = index[-1].last_key
            with self._sf as f:
                self._finish_tail(f, index)
                f.flush()
                os.fsync(f.fileno())
            self._sf = None
            os.replace(self.path + ".tmp", self.path)
            return {"path": self.path, "num_entries": self._num_entries,
                    "min_key": self._min_key, "max_key": self._max_key}
        index: List[BlockIndexEntry] = []
        tmp = self.path + ".tmp"
        with open(tmp, "wb", buffering=1 << 20) as f:
            # an empty data region per columnar-only block, as the
            # reference's layout records it
            for cb in self._blocks:
                index.append(BlockIndexEntry(
                    first_key=cb.first_full_key(),
                    last_key=cb.last_full_key(),
                    offset=f.tell(), length=0, num_rows=cb.n))
                self._num_entries += cb.n
            if index:
                self._min_key = index[0].first_key
                self._max_key = index[-1].last_key
            for cb, e in zip(self._blocks, index):
                self._write_block(f, cb, e)
            self._finish_tail(f, index)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._blocks = []
        return {"path": self.path, "num_entries": self._num_entries,
                "min_key": self._min_key, "max_key": self._max_key}


class SstReader:
    """Opens one SST (columnar-only blocks).  key_builder: callable(cb)
    -> keys matrix | None that lazily rebuilds the key matrix of v2
    keyless blocks (the codec callable the writer verified against)."""

    def __init__(self, path: str, key_builder=None):
        self.path = path
        self.key_builder = key_builder
        # mmap: pages fault in as blocks are touched; arrays read with
        # read_columnar stay views that keep the mapping alive
        with open(path, "rb") as f:
            head = f.read(len(_ENC_MAGICS[0]))
            if head in _ENC_MAGICS:
                raise NotPortedError(f"reading the encrypted SST {path}",
                                     _ENC_ITEM)
            self._data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        d = self._data
        if d[-8:] != MAGIC:
            raise ValueError(f"{path}: bad SST magic")
        (flen,) = struct.unpack_from("<I", d, len(d) - 12)
        meta = wire_pack.unpackb(d[len(d) - 12 - flen:len(d) - 12])
        self.format_version = meta.get("format_version", 1)
        if self.format_version > SUPPORTED_FORMAT_VERSION:
            raise ValueError(
                f"{path}: SST format v{self.format_version} is newer "
                f"than this reader supports "
                f"(<= v{SUPPORTED_FORMAT_VERSION})")
        self.num_entries = meta["num_entries"]
        self.min_key: bytes = meta["min_key"] or b""
        self.max_key: bytes = meta["max_key"] or b""
        self.frontier: dict = meta.get("frontier") or {}
        self.bloom = BloomFilter.deserialize(
            d[meta["bloom_offset"]:meta["bloom_offset"]
              + meta["bloom_length"]])
        raw_index = wire_pack.unpackb(
            d[meta["index_offset"]:meta["index_offset"]
              + meta["index_length"]])
        self.index = [BlockIndexEntry(*row) for row in raw_index]
        self._col_cache: dict = {}

    @property
    def file_size(self) -> int:
        return len(self._data)

    def num_blocks(self) -> int:
        return len(self.index)

    # --- row access: not ported -------------------------------------------
    def seek(self, key: bytes):
        raise NotPortedError("SstReader.seek (row KV iteration)", _ROWS_ITEM)

    def iterate(self, lower: Optional[bytes] = None,
                upper: Optional[bytes] = None):
        raise NotPortedError("SstReader.iterate (row KV iteration)",
                             _ROWS_ITEM)

    def point_reader(self, codec):
        raise NotPortedError("SstReader.point_reader", _ROWS_ITEM)

    def point_find(self, prefix: bytes, read_ht: int,
                   restart_hi: Optional[int] = None):
        raise NotPortedError("SstReader.point_find", _ROWS_ITEM)

    # --- columnar access ----------------------------------------------------
    def columnar_block(self, i: int) -> Optional[ColumnarBlock]:
        """Block i, deserialized into owned arrays and cached (a bounded
        cache: cleared when it outgrows 32 blocks); None for a row
        block."""
        e = self.index[i]
        if e.col_offset < 0:
            return None
        cached = self._col_cache.get(i)
        if cached is not None:
            return cached
        cb = ColumnarBlock.deserialize(
            self._data[e.col_offset:e.col_offset + e.col_length])
        cb.bind_key_builder(self.key_builder)
        if len(self._col_cache) > 32:
            self._col_cache.clear()
        self._col_cache[i] = cb
        return cb

    def read_columnar(self, i: int) -> Optional[ColumnarBlock]:
        """Streaming (uncached) read for the compaction pipeline: raw
        lanes are zero-copy read-only views over the file mapping, which
        they keep alive even after the file is unlinked."""
        e = self.index[i]
        if e.col_offset < 0:
            return None
        cb = ColumnarBlock.deserialize(
            memoryview(self._data)[e.col_offset:e.col_offset
                                   + e.col_length], copy=False)
        cb.bind_key_builder(self.key_builder)
        return cb

    def columnar_blocks(self, lower: Optional[bytes] = None,
                        upper: Optional[bytes] = None
                        ) -> Iterator[Tuple[int, Optional[ColumnarBlock]]]:
        """(block index, ColumnarBlock|None) for blocks intersecting
        [lower, upper)."""
        for i, e in enumerate(self.index):
            if upper is not None and e.first_key >= upper:
                break
            if lower is not None and e.last_key < lower:
                continue
            yield i, self.columnar_block(i)
