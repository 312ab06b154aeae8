"""SSTable file format: sorted KV blocks + columnar sidecars + bloom +
index + footer.

Counterpart of ``yugabyte_db_tpu/storage/sst.py`` (reference analog:
src/yb/rocksdb/table/block_based_table_{builder,reader}.cc).  Every data
block can carry a serialized ColumnarBlock sidecar so scans read
struct-of-arrays pages directly instead of re-decoding row KVs; blocks
are cut by row count (default 4096).  The bytes are the reference's: a
file either package writes, the other reads.

File layout:
    [data block 0][data block 1]...
    [columnar block 0][columnar block 1]...   (optional per block)
    [bloom filter]
    [index: MessagePack list of per-block entries]
    [footer: MessagePack meta][u32 footer_len]["YBTPUSST"]

Row blocks are shared-prefix-compressed KV lists (``_encode_block``);
a row block's columnar sidecar comes from the writer's
``columnar_builder``, and a columnar-only block's rows come back through
the reader's ``row_decoder``.  The writer writes v2 blocks (the
reference's default format); the reader reads v1 and v2.  Point reads
walk one block in Python (``point_find``); the reference's native
whole-SST point reader, document shredding and encrypted files raise
``NotPortedError``.
"""
from __future__ import annotations

import bisect
import mmap
import os
import struct
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..errors import NotPortedError
from ..utils.hybrid_time import ENCODED_SIZE, DocHybridTime
from . import native_lib, wire_pack
from .columnar import SUPPORTED_FORMAT_VERSION, ColumnarBlock, fnv64_keys

MAGIC = b"YBTPUSST"
DEFAULT_BLOCK_ROWS = 4096

_HT_MARKER = 0x05          # dockv ValueType.kHybridTime
_HT_SUFFIX = ENCODED_SIZE + 1

#: the reference's encrypted-file envelopes (utils/encryption.py)
_ENC_MAGICS = (b"YBTPUENC", b"YBTPUEN2")

_NATIVE_ITEM = "ROADMAP.md queue 1 item 9a (the native point reader)"
_ENC_ITEM = "ROADMAP.md queue 1 item 9 (encryption at rest)"


def _doc_key_of(k: bytes) -> bytes:
    """Strip the hybrid-time suffix when present (doc-key bloom and
    point lookups go by key prefix)."""
    if len(k) > _HT_SUFFIX and k[-_HT_SUFFIX] == _HT_MARKER:
        return k[:-_HT_SUFFIX]
    return k


def _shared_prefixes(keys: Sequence[bytes]) -> List[int]:
    """Bytes each key shares with the one before it (0 for the first);
    keys of one width in one numpy pass."""
    n = len(keys)
    widths = set(map(len, keys))
    if n > 1 and len(widths) == 1 and (w := widths.pop()):
        km = np.frombuffer(b"".join(keys), np.uint8).reshape(n, w)
        diff = km[1:] != km[:-1]
        first = np.where(diff.any(axis=1), diff.argmax(axis=1), w)
        return [0] + first.tolist()
    return _shared_prefixes_loop(keys)


def _shared_prefixes_loop(keys: Sequence[bytes]) -> List[int]:
    """:func:`_shared_prefixes` one key at a time."""
    out, prev = [], b""
    for k in keys:
        out.append(len(os.path.commonprefix([prev, k])) if prev else 0)
        prev = k
    return out


def _encode_block(entries: Sequence[Tuple[bytes, bytes]]) -> bytes:
    """Shared-prefix-compressed KV block: u32 count, then per entry
    varints (shared, unshared, value length), the unshared key bytes and
    the value."""
    uv = _UVARINTS
    lim = len(uv)
    parts = [struct.pack("<I", len(entries))]
    shared = _shared_prefixes([k for k, _ in entries])
    for (k, v), s in zip(entries, shared):
        u, lv = len(k) - s, len(v)
        parts.append(uv[s] if s < lim else _uvarint(s))
        parts.append(uv[u] if u < lim else _uvarint(u))
        parts.append(uv[lv] if lv < lim else _uvarint(lv))
        parts.append(k[s:])
        parts.append(v)
    return b"".join(parts)


def _decode_block(data: bytes) -> List[Tuple[bytes, bytes]]:
    (n,) = struct.unpack_from("<I", data)
    pos = 4
    out: List[Tuple[bytes, bytes]] = []
    prev = b""
    for _ in range(n):
        shared, pos = _read_uvarint(data, pos)
        unshared, pos = _read_uvarint(data, pos)
        vlen, pos = _read_uvarint(data, pos)
        key = prev[:shared] + data[pos:pos + unshared]
        pos += unshared
        val = bytes(data[pos:pos + vlen])
        pos += vlen
        out.append((key, val))
        prev = key
    return out


def _uvarint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


#: the varint bytes of lengths below 2^14 (one or two bytes each)
_UVARINTS = [_uvarint(i) for i in range(1 << 14)]


def _read_uvarint(data: bytes, pos: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


#: (entries of one row block) -> ColumnarBlock | None; provided by the
#: docdb layer, which knows the packed-row schema
ColumnarBuilderFn = Callable[[Sequence[Tuple[bytes, bytes]]],
                             Optional[ColumnarBlock]]


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
    """Writes one SST of row blocks (``add``, cut every ``block_rows``
    entries; a block's columnar sidecar from ``columnar_builder``) and
    columnar-only blocks (``add_columnar_block``).  ``stream_columnar=
    True`` writes each columnar-only block to the file as it is added
    (the write releases the GIL, so a pipelined producer overlaps its
    gathers with the IO) and, with ``sync_every_bytes``, fsyncs from
    the writer's thread as it goes; otherwise blocks are buffered and
    written by ``finish``.  ``shred_cols`` (the codec's JSON value
    columns) must be empty: the reference's v2 writer shreds them,
    which is not ported."""

    def __init__(self, path: str, block_rows: int = DEFAULT_BLOCK_ROWS,
                 columnar_builder: Optional[ColumnarBuilderFn] = None,
                 stream_columnar: bool = False,
                 sync_every_bytes: Optional[int] = None,
                 key_builder=None, shred_cols=None):
        if shred_cols:
            raise NotPortedError(
                f"an SST writer shredding JSON columns {list(shred_cols)}",
                "ROADMAP.md queue 1 item 9 (document shredding)")
        self.path = path
        self.block_rows = block_rows
        self.columnar_builder = columnar_builder
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
        self._entries: List[Tuple[bytes, bytes]] = []
        # blocks: row lists, or [] where _col_only holds a ColumnarBlock
        self._blocks: List[Sequence[Tuple[bytes, bytes]]] = []
        self._col_only: List[Optional[ColumnarBlock]] = []
        self._key_hashes: List[np.ndarray] = []
        self._num_entries = 0
        self._min_key: Optional[bytes] = None
        self._max_key: Optional[bytes] = None
        self._frontier: dict = {}
        self._last_key: Optional[bytes] = None

    def add(self, key: bytes, value: bytes) -> None:
        if self._sf is not None:
            # a streaming finish() returns early and would drop buffered
            # row entries: refuse the mix up front
            raise ValueError("stream mode cannot mix row entries after "
                             "streamed columnar blocks")
        if self._last_key is not None and key < self._last_key:
            raise ValueError("keys must be added in sorted order")
        self._last_key = key
        self._entries.append((key, value))
        if len(self._entries) >= self.block_rows:
            self._blocks.append(self._entries)
            self._col_only.append(None)
            self._entries = []

    def _write_columnar(self, f, cb: ColumnarBlock,
                        e: BlockIndexEntry) -> None:
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
        if self._entries:
            self._blocks.append(self._entries)
            self._col_only.append(None)
            self._entries = []
        if self._last_key is not None and first < self._last_key:
            raise ValueError("keys must be added in sorted order")
        self._last_key = last
        if not self._stream:
            self._blocks.append([])
            self._col_only.append(cb)
            return
        if self._blocks:
            raise ValueError("stream mode cannot mix row blocks")
        if self._sf is None:
            self._sf = open(self.path + ".tmp", "wb", buffering=1 << 20)
        e = BlockIndexEntry(first_key=first, last_key=last, offset=0,
                            length=0, num_rows=cb.n)
        self._write_columnar(self._sf, cb, e)
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

    def _finish_tail(self, f, index: List[BlockIndexEntry],
                     row_hashes: List[bytes]) -> None:
        """Bloom + index + footer, shared by the buffered and streaming
        paths.  The bloom covers the columnar blocks' doc-key hashes and
        the plain row blocks' doc keys."""
        parts = list(self._key_hashes)
        if row_hashes:
            parts.append(fnv64_keys(row_hashes))
        hashes = (np.concatenate(parts) if parts
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
        self._entries = []
        self._blocks = []
        self._col_only = []

    def finish(self) -> dict:
        if self._sf is not None:
            # streaming mode: blocks are already on disk; append the tail
            index = self._stream_index
            self._min_key = index[0].first_key
            self._max_key = index[-1].last_key
            with self._sf as f:
                self._finish_tail(f, index, [])
                f.flush()
                os.fsync(f.fileno())
            self._sf = None
            os.replace(self.path + ".tmp", self.path)
            return {"path": self.path, "num_entries": self._num_entries,
                    "min_key": self._min_key, "max_key": self._max_key}
        if self._entries:
            self._blocks.append(self._entries)
            self._col_only.append(None)
            self._entries = []
        index: List[BlockIndexEntry] = []
        row_hashes: List[bytes] = []
        tmp = self.path + ".tmp"
        with open(tmp, "wb", buffering=1 << 20) as f:
            # data blocks (an empty region for a columnar-only block)
            for blk, cb in zip(self._blocks, self._col_only):
                if cb is not None:
                    index.append(BlockIndexEntry(
                        first_key=cb.first_full_key(),
                        last_key=cb.last_full_key(),
                        offset=f.tell(), length=0, num_rows=cb.n))
                    self._num_entries += cb.n
                else:
                    enc = _encode_block(blk)
                    index.append(BlockIndexEntry(
                        first_key=blk[0][0], last_key=blk[-1][0],
                        offset=f.tell(), length=len(enc),
                        num_rows=len(blk)))
                    f.write(enc)
                    self._num_entries += len(blk)
                    row_hashes.extend(_doc_key_of(k) for k, _ in blk)
            if index:
                self._min_key = index[0].first_key
                self._max_key = index[-1].last_key
            # columnar sections: the pre-built ones and the row blocks'
            # sidecars
            for e, blk, cb in zip(index, self._blocks, self._col_only):
                if cb is None and self.columnar_builder is not None and blk:
                    cb = self.columnar_builder(blk)
                if cb is not None:
                    self._write_columnar(f, cb, e)
            self._finish_tail(f, index, row_hashes)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._blocks = []
        self._col_only = []
        return {"path": self.path, "num_entries": self._num_entries,
                "min_key": self._min_key, "max_key": self._max_key}


class SstReader:
    """Opens one SST.  row_decoder: callable(ColumnarBlock) -> [(key,
    value)] that reconstructs the KV entries of columnar-only blocks
    (the docdb layer owns the packed-row schema); key_builder:
    callable(cb) -> keys matrix | None that lazily rebuilds the key
    matrix of v2 keyless blocks (the codec callable the writer verified
    against)."""

    def __init__(self, path: str, row_decoder=None, key_builder=None):
        self.path = path
        self.row_decoder = row_decoder
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
        self._first_keys = [e.first_key for e in self.index]
        self._col_cache: dict = {}
        self._row_cache: dict = {}   # block idx -> decoded entries

    @property
    def file_size(self) -> int:
        return len(self._data)

    def num_blocks(self) -> int:
        return len(self.index)

    # --- row access -------------------------------------------------------
    @staticmethod
    def _cache_put(cache: dict, i: int, value, cap: int):
        """Bounded block cache: point reads revisit hot blocks; full
        scans touch each block once, so eviction by clearing is fine."""
        if len(cache) > cap:
            cache.clear()
        cache[i] = value
        return value

    def _read_block(self, i: int) -> List[Tuple[bytes, bytes]]:
        cached = self._row_cache.get(i)
        if cached is not None:
            return cached
        e = self.index[i]
        if e.length == 0:   # columnar-only block
            cb = self.columnar_block(i)
            if self.row_decoder is None:
                raise ValueError(
                    f"{self.path}: block {i} is columnar-only and no "
                    "row_decoder is set")
            out = self.row_decoder(cb)
        else:
            out = _decode_block(self._data[e.offset:e.offset + e.length])
        return self._cache_put(self._row_cache, i, out, 16)

    def seek(self, key: bytes) -> Iterator[Tuple[bytes, bytes]]:
        """Entries with entry_key >= key, ascending."""
        bi = max(bisect.bisect_right(self._first_keys, key) - 1, 0)
        for i in range(bi, len(self.index)):
            for k, v in self._read_block(i):
                if k >= key:
                    yield k, v

    def iterate(self, lower: Optional[bytes] = None,
                upper: Optional[bytes] = None
                ) -> Iterator[Tuple[bytes, bytes]]:
        it = self.seek(lower) if lower else self._iter_all()
        for k, v in it:
            if upper is not None and k >= upper:
                return
            yield k, v

    def _iter_all(self) -> Iterator[Tuple[bytes, bytes]]:
        for i in range(len(self.index)):
            yield from self._read_block(i)

    def may_contain_hash(self, key_hash: int) -> bool:
        return self.bloom.may_contain(key_hash)

    def point_reader(self, codec):
        raise NotPortedError("SstReader.point_reader (the native "
                             "whole-SST point reader)", _NATIVE_ITEM)

    def point_find(self, prefix: bytes, read_ht: int,
                   restart_hi: Optional[int] = None):
        """Newest VISIBLE version of the doc key `prefix` in this SST
        (reference analog: BlockBasedTable::Get + DocDB visibility).
        Returns one of:
          ("row", ht, write_id, key, value, block, pos)  — found;
            columnar hits carry value=None and (block, pos) for a lazy
            single-row decode, row-path hits carry the raw value
          ("restart", ht)  — a version inside the clock-uncertainty
            window (read_ht, restart_hi] exists: the caller restarts
          None — no visible version here
        Columnar blocks read the MVCC lanes instead of decoding each
        key's DocHybridTime suffix."""
        bi = max(bisect.bisect_right(self._first_keys, prefix) - 1, 0)
        plen = len(prefix)
        for i in range(bi, len(self.index)):
            e = self.index[i]
            if e.first_key > prefix and not e.first_key.startswith(prefix):
                return None
            if e.last_key < prefix:
                continue
            cb = (self.columnar_block(i)
                  if self.row_decoder is not None else None)
            if cb is not None and cb.keys is None:
                cb = None
            if cb is not None:
                pos = cb.searchsorted_key(prefix)
                keys, hts, n = cb.keys, cb.ht, cb.n
                advanced = False
                while pos < n:
                    k = keys[pos].tobytes()
                    if k[:plen] != prefix:
                        break
                    advanced = True
                    ht = int(hts[pos])
                    if ht > read_ht:
                        if restart_hi is not None and ht <= restart_hi:
                            return ("restart", ht)
                        pos += 1
                        continue
                    return ("row", ht, int(cb.write_id[pos]), k, None,
                            cb, pos)
                if pos < n:
                    return None     # walked past the prefix in-block
                if not advanced and pos == 0:
                    return None
            else:
                for k, v in self._read_block(i):
                    if k >= prefix:
                        if k[:plen] != prefix:
                            return None
                        dht = DocHybridTime.decode_desc(k[-ENCODED_SIZE:])
                        ht = dht.ht.value
                        if ht > read_ht:
                            if restart_hi is not None and ht <= restart_hi:
                                return ("restart", ht)
                            continue
                        return ("row", ht, dht.write_id, k, v, None, None)
        return None

    # --- columnar access ----------------------------------------------------
    def columnar_block(self, i: int) -> Optional[ColumnarBlock]:
        """Block i's columnar form, deserialized into owned arrays and
        cached (a bounded cache: cleared when it outgrows 32 blocks);
        None for a row block without a sidecar."""
        e = self.index[i]
        if e.col_offset < 0:
            return None
        cached = self._col_cache.get(i)
        if cached is not None:
            return cached
        cb = ColumnarBlock.deserialize(
            self._data[e.col_offset:e.col_offset + e.col_length])
        cb.bind_key_builder(self.key_builder)
        return self._cache_put(self._col_cache, i, cb, 32)

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
        [lower, upper); None marks a row block without a sidecar."""
        for i, e in enumerate(self.index):
            if upper is not None and e.first_key >= upper:
                break
            if lower is not None and e.last_key < lower:
                continue
            yield i, self.columnar_block(i)
