"""Columnar block representation: one sorted run of rows in
struct-of-arrays form, and its on-disk serialization.

Counterpart of ``yugabyte_db_tpu/storage/columnar.py``: fixed-width and
PK columns, varlen (string) lanes with their block-local dictionaries,
the MVCC lanes, the encoded-key matrix (a lazy property on v2 keyless
blocks, rebuilt through a bound key builder), and the on-disk
formats, byte for byte the reference's:

  v1  every lane dumped raw, keys matrix always inline (read only);
  v2  the keys matrix DROPPED when provably derivable from the pk
      columns + ht/write_id lanes, every lane through lane_codec's
      "encode only if smaller" menu, per-block min/max zone maps
      (read and written).

Headers are MessagePack, written by the port's own codec
(storage/wire_pack.py).  Derived scan-lifetime lanes (column ids at or
above ``DERIVED_COL_BASE``) and shredded document lanes refuse to
serialize with ``NotPortedError``; the native point-read extension
(``native_hot``) is not ported."""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..errors import NotPortedError
from . import lane_codec, native_lib, wire_pack

#: newest block format this build can read, and the one it writes;
#: deserialize rejects anything newer with a clear error instead of
#: misparsing it
SUPPORTED_FORMAT_VERSION = 2

#: column ids at or above this are DERIVED scan-lifetime lanes (join
#: build columns, shredded document paths), never row data
DERIVED_COL_BASE = 1 << 20

#: lazy key-matrix rebuild tally: every time a v2 keyless block's
#: ``keys`` property fires its key_builder thunk, one rebuild (and the
#: block's row count) lands here
KEY_REBUILD_STATS = {"rebuilds": 0, "rows": 0}

_HASH_MULT = np.uint64(0x100000001B3)
_HASH_OFF = np.uint64(0xCBF29CE484222325)

_SHRED_ITEM = "ROADMAP.md queue 1 item 9 (document shredding)"


def fnv64_rows(mat: np.ndarray) -> np.ndarray:
    """Row-wise FNV-1a 64-bit over an [N, L] uint8 matrix (vectorized
    numpy, one pass per column of the short L axis)."""
    h = np.full(mat.shape[0], _HASH_OFF)
    for j in range(mat.shape[1]):
        h = (h ^ mat[:, j].astype(np.uint64)) * _HASH_MULT
    return h


def fnv64_bytes(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def fnv64_keys(keys: Sequence[bytes]) -> np.ndarray:
    """Vectorized fnv64_bytes over variable-length keys: column-wise
    masked updates, so the result is byte-exact with the scalar hash
    whatever the padding."""
    if not keys:
        return np.zeros(0, np.uint64)
    lens = np.array([len(k) for k in keys], np.int64)
    w = int(lens.max())
    mat = np.zeros((len(keys), w), np.uint8)
    if lens.min() == w:
        mat[:] = np.frombuffer(b"".join(keys), np.uint8).reshape(-1, w)
    else:
        for i, k in enumerate(keys):
            mat[i, :len(k)] = np.frombuffer(k, np.uint8)
    h = np.full(len(keys), _HASH_OFF)
    for j in range(w):
        upd = (h ^ mat[:, j].astype(np.uint64)) * _HASH_MULT
        h = np.where(j < lens, upd, h)
    return h


class ColumnarBlock:
    """Struct-of-arrays form of one sorted run of rows.

    Attributes:
      n            row count
      key_hash     uint64 — FNV of encoded DocKey (no HT)
      ht           uint64 — HybridTime.value
      write_id     uint32
      tombstone    bool
      pk           {col id: values} — fixed-width PK component values
      fixed        {col id: (values, null_mask)}
      varlen       {col id: (end_offsets uint32 [n], heap bytes,
                   null_mask)}
      unique_keys  True when every doc key appears once in the block
      keys         optional encoded SubDocKeys (with the hybrid-time
                   suffix) as an [N, L] uint8 matrix; a LAZY property on
                   v2 keyless blocks (rebuilt through the bound
                   key_builder on first access)
      zmap         {col id: (min, max)} per-block zone map over non-null
                   values of pk + fixed columns (v2 blocks only)
      keys_proven  True when every row's key is proven byte-derivable
                   from pk + ht/write_id (bulk-built blocks, v2 derived
                   blocks, and row-wise through slice/concat/gather):
                   the v2 writer then drops keys without re-verifying
    """

    __slots__ = ("n", "schema_version", "key_hash", "ht", "write_id",
                 "tombstone", "pk", "fixed", "varlen", "unique_keys",
                 "zmap", "keys_proven", "_keys", "_key_thunk",
                 "_first_key", "_last_key", "_void_keys", "_vdicts",
                 "_vdict_cache")

    def __init__(self, n: int, schema_version: int,
                 key_hash: np.ndarray, ht: np.ndarray,
                 write_id: np.ndarray, tombstone: np.ndarray,
                 pk: Optional[Dict[int, np.ndarray]] = None,
                 fixed: Optional[Dict[int, Tuple[np.ndarray,
                                                 np.ndarray]]] = None,
                 varlen: Optional[Dict[int, Tuple[np.ndarray, bytes,
                                                  np.ndarray]]] = None,
                 unique_keys: bool = True,
                 keys: Optional[np.ndarray] = None):
        self.n = n
        self.schema_version = schema_version
        self.key_hash = key_hash
        self.ht = ht
        self.write_id = write_id
        self.tombstone = tombstone
        self.pk = pk if pk is not None else {}
        self.fixed = fixed if fixed is not None else {}
        self.varlen = varlen if varlen is not None else {}
        self.unique_keys = unique_keys
        self.zmap: Optional[Dict[int, Tuple[object, object]]] = None
        self.keys_proven: bool = False
        self._keys: Optional[np.ndarray] = None
        self._key_thunk = None         # callable(cb) -> ndarray | None
        self._first_key: Optional[bytes] = None
        self._last_key: Optional[bytes] = None
        # void view of `keys` for binary search, built on first use
        self._void_keys: Optional[np.ndarray] = None
        # raw stored dict parts (uniq_lens, uniq_heap, codes) of v2
        # dict-coded varlen lanes, by column id
        self._vdicts: Dict[int, tuple] = {}
        # dict_varlen() memo: (cid, max_card) -> (uniq, codes) | False
        self._vdict_cache: Dict[tuple, object] = {}
        if keys is not None:
            self.keys = keys

    @classmethod
    def from_packed_entries(
            cls, packing,
            keys,                               # encoded DocKeys (no HT
                                                # suffix): bytes, or an
                                                # [N, L] uint8 matrix
            hts: np.ndarray, write_ids: np.ndarray,
            values: Sequence[bytes],            # KV values (kPackedRowV2 or
                                                # kTombstone)
            ) -> "ColumnarBlock":
        """Build from packed-row KV entries (flush/compaction path;
        `packing` is a dockv.packed_row.SchemaPacking).

        The fixed-stride prefix of the packed format means all rows'
        prefixes stack into one [N, stride] matrix whose column slices
        reinterpret as lanes; each varlen column's values gather from the
        rows' heaps segment by segment (the host library's memcpy loop).
        """
        from ..dockv.packed_row import ColumnType
        from ..dockv.value import ValueKind
        n = len(values)
        tomb = np.zeros(n, bool)
        hdr_len = _varint_len(packing.schema_version)
        plen = hdr_len + packing.prefix_size
        prefix_parts = []
        pad = b"\x00" * plen
        for i, v in enumerate(values):
            if v[0] == ValueKind.kTombstone:
                tomb[i] = True
                prefix_parts.append(pad)
            elif v[0] == ValueKind.kPackedRowV2:
                prefix_parts.append(v[1:1 + plen])
            else:
                raise ValueError("columnar block needs packed or tombstone values")
        mat = np.frombuffer(b"".join(prefix_parts), np.uint8).reshape(n, plen)
        body = mat[:, hdr_len:]
        blk = cls(
            n=n, schema_version=packing.schema_version,
            key_hash=(fnv64_rows(keys) if isinstance(keys, np.ndarray)
                      else fnv64_keys(keys)),
            ht=np.asarray(hts, np.uint64),
            write_id=np.asarray(write_ids, np.uint32),
            tombstone=tomb,
        )
        # null bitmap -> per-column masks
        bitmap = body[:, :packing.bitmap_size]
        for i, c in enumerate(packing.all_columns):
            byte, bit = i // 8, i % 8
            mask = (bitmap[:, byte] >> bit) & 1
            null = mask.astype(bool) | tomb
            if ColumnType.is_fixed(c.type):
                off = packing.bitmap_size + packing.fixed_offsets[c.id]
                w = ColumnType.FIXED_WIDTHS[c.type]
                dt = ColumnType.NUMPY_DTYPES[c.type]
                vals = np.ascontiguousarray(
                    body[:, off:off + w]).view(dt).reshape(n)
                blk.fixed[c.id] = (vals.copy(), null)
        # varlen columns: each row's heap follows its prefix
        if packing.varlen_columns:
            voff0 = packing.bitmap_size + packing.fixed_size
            nvar = len(packing.varlen_columns)
            ends_mat = np.ascontiguousarray(
                body[:, voff0:voff0 + 4 * nvar]
            ).view("<u4").reshape(n, nvar).astype(np.int64)
            heaps = [v[1 + plen:] if not tomb[i] else b""
                     for i, v in enumerate(values)]
            hlen = np.fromiter(map(len, heaps), np.int64, n)
            base = np.cumsum(hlen) - hlen
            allheap = np.frombuffer(b"".join(heaps), np.uint8)
            for vi, c in enumerate(packing.varlen_columns):
                i_ = len(packing.fixed_columns) + vi
                null = ((bitmap[:, i_ // 8] >> (i_ % 8)) & 1).astype(bool) | tomb
                starts = ends_mat[:, vi - 1] if vi else np.zeros(n, np.int64)
                # a Python slice heap[s:e] of each row, clamped alike
                lo = np.minimum(starts, hlen)
                ln = np.where(null, 0,
                              np.maximum(np.minimum(ends_mat[:, vi], hlen)
                                         - lo, 0))
                out_ends = np.cumsum(ln)
                heap = np.empty(int(out_ends[-1]) if n else 0, np.uint8)
                args = (allheap, np.ascontiguousarray(base + lo),
                        np.ascontiguousarray(out_ends - ln),
                        np.ascontiguousarray(ln), heap)
                if not native_lib.gather_heap(*args):
                    native_lib.gather_heap_fallback(*args)
                blk.varlen[c.id] = (out_ends.astype(np.uint32),
                                    heap.tobytes(), null)
        return blk

    @classmethod
    def from_arrays(cls, schema_version: int,
                    key_hash: np.ndarray, ht: np.ndarray,
                    write_id: Optional[np.ndarray] = None,
                    pk: Optional[Dict[int, np.ndarray]] = None,
                    fixed: Optional[Dict[int, Tuple[np.ndarray,
                                                    np.ndarray]]] = None,
                    varlen: Optional[Dict[int, Tuple[np.ndarray, bytes,
                                                     np.ndarray]]] = None,
                    tombstone: Optional[np.ndarray] = None,
                    unique_keys: bool = True,
                    keys: Optional[np.ndarray] = None) -> "ColumnarBlock":
        n = len(key_hash)
        return cls(
            n=n, schema_version=schema_version,
            key_hash=np.asarray(key_hash, np.uint64),
            ht=np.asarray(ht, np.uint64),
            write_id=(np.asarray(write_id, np.uint32)
                      if write_id is not None else np.zeros(n, np.uint32)),
            tombstone=(np.asarray(tombstone, bool) if tombstone is not None
                       else np.zeros(n, bool)),
            pk=dict(pk or {}), fixed=dict(fixed or {}),
            varlen=dict(varlen or {}), unique_keys=unique_keys, keys=keys)

    @classmethod
    def from_reference_arrays(cls, d: Dict[str, object]) -> "ColumnarBlock":
        """Block from a plain dict of numpy lanes — ``n``, ``key_hash``,
        ``ht``, ``write_id``, ``tombstone``, ``pk`` ({cid: values}),
        ``fixed`` ({cid: (values, nulls)}), ``unique_keys`` and
        optionally ``schema_version``, ``varlen`` ({cid: (ends, heap,
        nulls)}) and ``keys`` (the [N, L] key matrix) — so a block built
        elsewhere (the reference package, a file) scans the very same
        rows in the very same order here.  Lanes are copied."""
        n = int(d["n"])
        keys = d.get("keys")
        blk = cls.from_arrays(
            schema_version=int(d.get("schema_version", 0)),
            key_hash=np.array(d["key_hash"], np.uint64),
            ht=np.array(d["ht"], np.uint64),
            write_id=np.array(d["write_id"], np.uint32),
            tombstone=np.array(d["tombstone"], bool),
            pk={int(c): np.array(v) for c, v in d["pk"].items()},
            fixed={int(c): (np.array(v), np.array(m, bool))
                   for c, (v, m) in d["fixed"].items()},
            varlen={int(c): (np.array(e, np.uint32), bytes(h),
                             np.array(m, bool))
                    for c, (e, h, m) in (d.get("varlen") or {}).items()},
            unique_keys=bool(d["unique_keys"]),
            keys=np.array(keys, np.uint8) if keys is not None else None)
        lanes = [blk.ht, blk.write_id, blk.tombstone]
        lanes += [e for e, _, _ in blk.varlen.values()]
        if blk.keys is not None:
            lanes.append(blk.keys)
        if blk.n != n or any(len(a) != n for a in lanes):
            raise ValueError("lane lengths disagree with n")
        return blk

    # --- keys (lazy on v2 keyless blocks) --------------------------------
    @property
    def keys(self) -> Optional[np.ndarray]:
        """Full encoded SubDocKey matrix. For v2 keyless blocks the
        first access rebuilds it through the bound key_builder; None
        when the block has no keys and no way to derive them."""
        if self._keys is None and self._key_thunk is not None:
            thunk, self._key_thunk = self._key_thunk, None
            KEY_REBUILD_STATS["rebuilds"] += 1
            KEY_REBUILD_STATS["rows"] += self.n
            self._keys = thunk(self)
        return self._keys

    @keys.setter
    def keys(self, v: Optional[np.ndarray]) -> None:
        self._keys = v
        self._void_keys = None

    @property
    def keys_derivable(self) -> bool:
        """True when a keys matrix is available or can be rebuilt."""
        return self._keys is not None or self._key_thunk is not None

    def bind_key_builder(self, builder) -> None:
        """Attach the lazy rebuild callback of a v2 keyless block (set
        by SstReader from the codec's derive_keys)."""
        if self._keys is None and builder is not None:
            self._key_thunk = builder

    def boundary_keys(self, materialize: bool = True
                      ) -> Tuple[Optional[bytes], Optional[bytes]]:
        """(first, last) full encoded keys of the block, from the
        materialized matrix or the stored v2 boundary keys; with
        ``materialize=False`` (None, None) instead of firing the lazy
        key_builder."""
        if self._keys is not None:
            if not self.n:
                return None, None
            return self._keys[0].tobytes(), self._keys[-1].tobytes()
        if self._first_key is not None:
            return self._first_key, self._last_key
        if not materialize:
            return None, None
        k = self.keys                  # may invoke the rebuild thunk
        if k is None or not self.n:
            return None, None
        return k[0].tobytes(), k[-1].tobytes()

    def first_full_key(self) -> Optional[bytes]:
        """First row's full encoded key, from the stored boundary keys
        when present (no derived matrix is materialized)."""
        return self.boundary_keys()[0]

    def last_full_key(self) -> Optional[bytes]:
        return self.boundary_keys()[1]

    def searchsorted_key(self, key: bytes) -> int:
        """First row index with keys[i] >= key (needs the keys matrix).
        Pads/truncates `key` to the matrix width; doc-key prefix freedom
        makes zero padding order-correct."""
        keys = self.keys
        if keys is None:
            raise ValueError("searchsorted_key needs a keys matrix")
        if self._void_keys is None:
            self._void_keys = np.ascontiguousarray(keys).view(
                np.dtype((np.void, keys.shape[1]))).reshape(-1)
        vk = self._void_keys
        w = vk.dtype.itemsize
        probe = key[:w].ljust(w, b"\x00")
        t = np.frombuffer(probe, vk.dtype)[0]
        return int(np.searchsorted(vk, t, side="left"))

    # --- varlen dictionaries ---------------------------------------------
    def dict_varlen(self, cid: int, max_card: int = 1 << 16):
        """Block-local dictionary view of one varlen (string) column:
        ``(uniq, codes)`` with `uniq` a SORTED object array of str and
        `codes` int32 row codes into it (NULL rows code as "").  None
        when the column can't dictionary-encode (over-long rows, too
        many distinct values, non-UTF8 payloads).
        Sourced from the stored v2 dict-coded lane when present, else
        built once with the byte-level unique (rows are never decoded;
        only the uniques are); memoized per (column, max_card)."""
        got = self._vdict_cache.get((cid, max_card))
        if got is not None:
            return got if got is not False else None
        out = None
        try:
            stored = self._vdicts.get(cid)
            if stored is not None:
                ulens, uheap, codes = stored
                out = (lane_codec.decode_dict_strings(ulens, uheap),
                       np.asarray(codes, np.int32))
            elif cid in self.varlen:
                ends, heap, null = self.varlen[cid]
                coded = lane_codec.varlen_code_rows(
                    ends, heap, null, max_card=max_card,
                    sample_guard=False)
                if coded is not None:
                    ulens, uheap, codes = coded
                    out = (lane_codec.decode_dict_strings(ulens, uheap),
                           codes)
        except UnicodeDecodeError:
            out = None
        self._vdict_cache[(cid, max_card)] = out if out is not None \
            else False
        return out

    # --- serialization ---------------------------------------------------
    def _refuse_derived_lanes(self) -> None:
        derived = sorted(c for c in list(self.fixed) + list(self.varlen)
                         if c >= DERIVED_COL_BASE)
        if derived:
            raise NotPortedError(
                f"serializing derived lanes {derived}", _SHRED_ITEM)

    def serialize_parts(self, key_builder=None,
                        stats: Optional[dict] = None
                        ) -> Tuple[bytes, List[object]]:
        """(header bytes, payload buffers): buffer-protocol objects
        (contiguous ndarrays / bytes) a writer streams to its file.

        Writes the v2 format (the reference's default): the keys matrix
        is dropped when ``key_builder(self)`` rebuilds it byte-identically
        (or ``keys_proven``), every lane runs through lane_codec, and
        zone maps and the boundary keys are embedded.  `stats` (optional)
        accumulates per-lane encode accounting.  v1 blocks are read, not
        written."""
        self._refuse_derived_lanes()
        return self._serialize_v2(key_builder, stats)

    def _serialize_v2(self, key_builder, stats: Optional[dict]
                      ) -> Tuple[bytes, List[object]]:
        bufs: List[object] = []

        def lane(name: str, arr: np.ndarray) -> dict:
            m, parts, enc = lane_codec.encode_lane(arr)
            bufs.extend(parts)
            lane_codec.tally(stats, name, arr.nbytes,
                             sum(p.nbytes for p in parts), enc)
            return m

        keys = self.keys
        keys_meta = None
        if keys is not None:
            drop = False
            if key_builder is not None:
                if self.keys_proven:
                    drop = True
                else:
                    # derivation is an optimization: a builder that
                    # cannot rebuild this block keeps the keys inline
                    try:
                        derived = key_builder(self)
                    except (TypeError, ValueError):
                        derived = None
                    drop = (derived is not None
                            and derived.shape == keys.shape
                            and derived.dtype == keys.dtype
                            and np.array_equal(derived, keys))
            if drop:
                keys_meta = {"drv": 1}
                lane_codec.tally(stats, "keys", keys.nbytes, 0, "derived")
            else:
                keys_meta = lane("keys", keys)
        meta = {
            "v": 2,
            "n": self.n, "sv": self.schema_version, "uniq": self.unique_keys,
            "keys": keys_meta,
            "key_hash": lane("key_hash", self.key_hash),
            "ht": lane("ht", self.ht),
            "wid": lane("write_id", self.write_id),
            "tomb": lane("tombstone", self.tombstone),
            "pk": {str(k): lane("pk", v) for k, v in self.pk.items()},
            "fixed": {str(k): [lane("fixed_vals", v), lane("fixed_null", m)]
                      for k, (v, m) in self.fixed.items()},
            "varlen": {},
        }
        for k, (ends, heap, null) in self.varlen.items():
            dict_meta = self._dict_varlen_parts(ends, heap, null, bufs,
                                                stats)
            if dict_meta is not None:
                meta["varlen"][str(k)] = [dict_meta, {"len": 0},
                                          lane("varlen_null", null)]
                continue
            # heap rides FIRST in the payload stream (the v1 order, so
            # one deserializer walks both formats)
            hb = (heap if isinstance(heap, (bytes, bytearray))
                  else np.ascontiguousarray(heap))
            bufs.append(hb)
            lane_codec.tally(stats, "varlen_heap", len(heap), len(heap),
                             "raw")
            meta["varlen"][str(k)] = [lane("varlen_ends", ends),
                                      {"len": len(heap)},
                                      lane("varlen_null", null)]
        if keys is not None and self.n:
            meta["k0"] = keys[0].tobytes()
            meta["k1"] = keys[-1].tobytes()
        zmap = self._build_zone_map()
        if zmap:
            meta["zmap"] = {str(c): [lo, hi] for c, (lo, hi) in
                            zmap.items()}
        head = wire_pack.packb(meta)
        lane_codec.tally(stats, "header", len(head) + 4, len(head) + 4,
                         "raw")
        return struct.pack("<I", len(head)) + head, bufs

    def _dict_varlen_parts(self, ends, heap, null, bufs: List[object],
                           stats: Optional[dict]):
        """v2 dict coding of one varlen lane: uniques (lens + heap) +
        narrow codes replace the row heap + ends lane when STRICTLY
        smaller than their raw dump.  Only lanes whose NULL rows carry
        zero-length payloads qualify (codes -> payloads must round-trip
        the original bytes).  Returns the lane meta, or None for raw."""
        n = len(ends)
        if n < 2:
            return None
        ends64 = np.asarray(ends, np.int64)
        lens = np.diff(np.concatenate([[0], ends64]))
        if null is not None and np.asarray(null, bool).any() and \
                lens[np.asarray(null, bool)].any():
            return None               # lossy for non-empty NULL payloads
        coded = lane_codec.varlen_code_rows(ends, heap, null,
                                            max_card=0xFFFF)
        if coded is None:
            return None
        ulens, uheap, codes = coded
        k = len(ulens)
        cdt = np.dtype(np.uint8 if k <= 0x100 else np.uint16)
        raw_basis = len(heap) + np.asarray(ends).nbytes
        size = ulens.nbytes + uheap.nbytes + n * cdt.itemsize
        if size >= raw_basis:
            return None
        codes_n = np.ascontiguousarray(codes.astype(cdt))
        bufs.extend([np.ascontiguousarray(ulens),
                     np.ascontiguousarray(uheap), codes_n])
        lane_codec.tally(stats, "varlen_dict", raw_basis, size, "dict")
        return {"venc": "dict", "k": k, "cdt": str(cdt),
                "parts": [ulens.nbytes, uheap.nbytes, codes_n.nbytes]}

    @staticmethod
    def _decode_dict_varlen(vmeta: dict, fetch):
        """Inverse of _dict_varlen_parts: rebuild the exact (ends, heap)
        pair and return the raw dict parts for dict_varlen()."""
        ulens = np.frombuffer(fetch(vmeta["parts"][0]), np.uint8)
        uheap = bytes(fetch(vmeta["parts"][1]))
        codes = np.frombuffer(fetch(vmeta["parts"][2]),
                              np.dtype(vmeta["cdt"])).astype(np.int32)
        u_ends = np.cumsum(ulens.astype(np.int64))
        u_starts = u_ends - ulens
        row_lens = ulens[codes].astype(np.int64)
        ends = np.cumsum(row_lens).astype(np.uint32)
        total = int(row_lens.sum())
        if total:
            out = np.empty(total, np.uint8)
            args = (np.frombuffer(uheap, np.uint8),
                    np.ascontiguousarray(u_starts[codes]),
                    np.ascontiguousarray(ends.astype(np.int64) - row_lens),
                    np.ascontiguousarray(row_lens), out)
            if not native_lib.gather_heap(*args):
                native_lib.gather_heap_fallback(*args)
            heap = out.tobytes()
        else:
            heap = b""
        return ends, heap, (ulens, uheap, codes)

    def _build_zone_map(self) -> Dict[int, Tuple[object, object]]:
        """Per-column (min, max) over non-null values of pk + fixed
        value columns: exact Python ints for integer lanes; floats are
        skipped when a NaN or an infinity is present."""
        out: Dict[int, Tuple[object, object]] = {}
        if not self.n:
            return out

        def bounds(arr: np.ndarray, null: Optional[np.ndarray]):
            if arr.ndim != 1 or arr.dtype.kind not in "iuf":
                return None
            v = arr if null is None else arr[~null]
            if not len(v):
                return None
            lo, hi = v.min(), v.max()
            if arr.dtype.kind == "f":
                if not (np.isfinite(lo) and np.isfinite(hi)):
                    return None
                return (float(lo), float(hi))
            return (int(lo), int(hi))

        for cid, arr in self.pk.items():
            b = bounds(np.asarray(arr), None)
            if b is not None:
                out[cid] = b
        for cid, (vals, null) in self.fixed.items():
            b = bounds(np.asarray(vals), np.asarray(null))
            if b is not None:
                out[cid] = b
        return out

    def serialize(self, key_builder=None) -> bytes:
        head, bufs = self.serialize_parts(key_builder)
        return head + b"".join(
            b if isinstance(b, bytes) else memoryview(b).cast("B")
            for b in bufs)

    @classmethod
    def deserialize(cls, data, copy: bool = True,
                    max_version: int = SUPPORTED_FORMAT_VERSION
                    ) -> "ColumnarBlock":
        """Rebuild a block from its serialized form. With copy=False and
        a buffer-backed `data` (a memoryview over the SST mapping) raw
        lanes are zero-copy READ-ONLY views; encoded v2 lanes decode
        into small owned arrays either way.  Blocks newer than
        ``max_version`` raise ValueError; shredded lanes raise
        NotPortedError."""
        hlen = struct.unpack_from("<I", data)[0]
        meta = wire_pack.unpackb(data[4:4 + hlen])
        version = meta.get("v", 1)
        if version > max_version:
            raise ValueError(
                f"columnar block format v{version} is newer than this "
                f"reader supports (<= v{max_version}); upgrade before "
                "reading this SST")
        if meta.get("shred"):
            raise NotPortedError("reading shredded document lanes",
                                 _SHRED_ITEM)
        pos = 4 + hlen

        def fetch(n):
            nonlocal pos
            raw = data[pos:pos + n]
            pos += n
            return raw

        if version == 1:
            def take(ref) -> np.ndarray:
                raw = fetch(ref["len"])
                arr = np.frombuffer(raw, dtype=np.dtype(ref["dtype"])
                                    ).reshape(ref["shape"])
                return arr.copy() if copy else arr
        else:
            def take(ref) -> np.ndarray:
                arr = lane_codec.decode_lane(ref, fetch)
                if ref.get("enc") is None and copy:
                    return arr.copy()
                return arr

        keys_meta = meta.get("keys")
        keys = None
        derived = False
        if keys_meta is not None:
            if keys_meta.get("drv"):
                derived = True
            else:
                keys = take(keys_meta)
        blk = cls(
            n=meta["n"], schema_version=meta["sv"],
            key_hash=take(meta["key_hash"]), ht=take(meta["ht"]),
            write_id=take(meta["wid"]), tombstone=take(meta["tomb"]),
            unique_keys=meta["uniq"], keys=keys)
        for k, ref_ in meta["pk"].items():
            blk.pk[int(k)] = take(ref_)
        for k, (vref, mref) in meta["fixed"].items():
            v = take(vref)
            m = take(mref)
            blk.fixed[int(k)] = (v, m)
        for k, (eref, heapinfo, nref) in meta["varlen"].items():
            heap = fetch(heapinfo["len"])
            if eref.get("venc") == "dict":
                ends, heap, parts = cls._decode_dict_varlen(eref, fetch)
                blk._vdicts[int(k)] = parts
            else:
                ends = take(eref)
            null = take(nref)
            blk.varlen[int(k)] = (ends, heap, null)
        if version >= 2:
            if derived:
                blk.keys_proven = True     # write-time verify passed
            if meta.get("k0") is not None:
                blk._first_key = meta["k0"]
                blk._last_key = meta["k1"]
            z = meta.get("zmap")
            if z:
                blk.zmap = {int(c): (b[0], b[1]) for c, b in z.items()}
        return blk

    # --- row views -------------------------------------------------------
    def visible_mask(self, read_ht: int) -> np.ndarray:
        """MVCC visibility: rows written at or before read_ht."""
        return self.ht <= np.uint64(read_ht)

    def slice(self, lo: int, hi: int) -> "ColumnarBlock":
        """Row-range view [lo, hi)."""
        out = ColumnarBlock(
            n=hi - lo, schema_version=self.schema_version,
            key_hash=self.key_hash[lo:hi], ht=self.ht[lo:hi],
            write_id=self.write_id[lo:hi], tombstone=self.tombstone[lo:hi],
            unique_keys=self.unique_keys,
            keys=self.keys[lo:hi] if self.keys is not None else None)
        out.keys_proven = self.keys_proven   # row-wise property
        for cid, arr in self.pk.items():
            out.pk[cid] = arr[lo:hi]
        for cid, (v, m) in self.fixed.items():
            out.fixed[cid] = (v[lo:hi], m[lo:hi])
        for cid, (ends, heap, null) in self.varlen.items():
            starts = int(ends[lo - 1]) if lo else 0
            new_ends = (ends[lo:hi].astype(np.int64) - starts).astype(
                np.uint32)
            out.varlen[cid] = (new_ends,
                               heap[starts:int(ends[hi - 1]) if hi else 0],
                               null[lo:hi])
        return out

    @classmethod
    def concat(cls, blocks: Sequence["ColumnarBlock"]) -> "ColumnarBlock":
        """Row-wise concatenation of blocks with identical column sets.
        Varlen end offsets are rebased onto the joined heap;
        `unique_keys` is NOT derived (False), callers that know the
        adjacency set it."""
        if len(blocks) == 1:
            return blocks[0]
        first = blocks[0]
        out = cls(
            n=sum(b.n for b in blocks),
            schema_version=first.schema_version,
            key_hash=np.concatenate([b.key_hash for b in blocks]),
            ht=np.concatenate([b.ht for b in blocks]),
            write_id=np.concatenate([b.write_id for b in blocks]),
            tombstone=np.concatenate([b.tombstone for b in blocks]),
            unique_keys=False,
            keys=(np.concatenate([b.keys for b in blocks])
                  if first.keys is not None else None))
        out.keys_proven = all(b.keys_proven for b in blocks)
        for cid in first.pk:
            out.pk[cid] = np.concatenate([b.pk[cid] for b in blocks])
        for cid in first.fixed:
            out.fixed[cid] = (
                np.concatenate([b.fixed[cid][0] for b in blocks]),
                np.concatenate([b.fixed[cid][1] for b in blocks]))
        for cid in first.varlen:
            ends_all, nulls, heaps = [], [], []
            base = 0
            for b in blocks:
                ends, heap, null = b.varlen[cid]
                ends_all.append(ends.astype(np.int64) + base)
                nulls.append(null)
                heaps.append(bytes(heap))
                base += len(heaps[-1])
            out.varlen[cid] = (
                np.concatenate(ends_all).astype(np.uint32),
                b"".join(heaps), np.concatenate(nulls))
        return out


def _varint_len(v: int) -> int:
    n = 1
    while v >= 0x80:
        v >>= 7
        n += 1
    return n
