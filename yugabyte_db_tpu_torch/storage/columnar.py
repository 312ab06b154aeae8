"""Columnar block representation: one sorted run of rows in
struct-of-arrays form.

Counterpart of ``yugabyte_db_tpu/storage/columnar.py`` cut to the lanes
the scan path reads: fixed-width and PK columns, varlen (string) lanes
with their block-local dictionaries, the MVCC lanes and the optional
encoded-key matrix.  Serialization, zone maps and lazy key rebuilds stay
in ROADMAP.md (storage/LSM copy)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from . import lane_codec

_HASH_MULT = np.uint64(0x100000001B3)
_HASH_OFF = np.uint64(0xCBF29CE484222325)


def fnv64_rows(mat: np.ndarray) -> np.ndarray:
    """Row-wise FNV-1a 64-bit over an [N, L] uint8 matrix (vectorized
    numpy, one pass per column of the short L axis)."""
    h = np.full(mat.shape[0], _HASH_OFF)
    for j in range(mat.shape[1]):
        h = (h ^ mat[:, j].astype(np.uint64)) * _HASH_MULT
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
                   suffix) as an [N, L] uint8 matrix
    """

    __slots__ = ("n", "schema_version", "key_hash", "ht", "write_id",
                 "tombstone", "pk", "fixed", "varlen", "unique_keys",
                 "keys", "_vdict_cache")

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
        self.keys = keys
        # dict_varlen() memo: (cid, max_card) -> (uniq, codes) | False
        self._vdict_cache: Dict[tuple, object] = {}

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

    # --- keys ------------------------------------------------------------
    def boundary_keys(self) -> Tuple[Optional[bytes], Optional[bytes]]:
        """(first, last) full encoded keys of the block, or (None, None)
        when it carries no key matrix (or no rows)."""
        if self.keys is None or not self.n:
            return None, None
        return self.keys[0].tobytes(), self.keys[-1].tobytes()

    # --- varlen dictionaries ---------------------------------------------
    def dict_varlen(self, cid: int, max_card: int = 1 << 16):
        """Block-local dictionary view of one varlen (string) column:
        ``(uniq, codes)`` with `uniq` a SORTED object array of str and
        `codes` int32 row codes into it (NULL rows code as "").  None
        when the column can't dictionary-encode (over-long rows, too
        many distinct values, non-UTF8 payloads).  Built once with the
        byte-level unique (rows are never decoded; only the uniques
        are) and memoized per (column, max_card)."""
        got = self._vdict_cache.get((cid, max_card))
        if got is not None:
            return got if got is not False else None
        out = None
        if cid in self.varlen:
            ends, heap, null = self.varlen[cid]
            try:
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
