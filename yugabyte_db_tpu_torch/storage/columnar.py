"""Columnar block representation: one sorted run of rows in
struct-of-arrays form.

Counterpart of ``yugabyte_db_tpu/storage/columnar.py`` cut to the lanes
the scan path reads.  Serialization, varlen columns, dictionaries and
lazy key rebuilds stay in ROADMAP.md (storage/LSM copy)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

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
      unique_keys  True when every doc key appears once in the block
      keys         optional encoded SubDocKeys as an [N, L] uint8 matrix
    """

    __slots__ = ("n", "schema_version", "key_hash", "ht", "write_id",
                 "tombstone", "pk", "fixed", "unique_keys", "keys")

    def __init__(self, n: int, schema_version: int,
                 key_hash: np.ndarray, ht: np.ndarray,
                 write_id: np.ndarray, tombstone: np.ndarray,
                 pk: Optional[Dict[int, np.ndarray]] = None,
                 fixed: Optional[Dict[int, Tuple[np.ndarray,
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
        self.unique_keys = unique_keys
        self.keys = keys

    @classmethod
    def from_arrays(cls, schema_version: int,
                    key_hash: np.ndarray, ht: np.ndarray,
                    write_id: Optional[np.ndarray] = None,
                    pk: Optional[Dict[int, np.ndarray]] = None,
                    fixed: Optional[Dict[int, Tuple[np.ndarray,
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
            unique_keys=unique_keys, keys=keys)

    @classmethod
    def from_reference_arrays(cls, d: Dict[str, object]) -> "ColumnarBlock":
        """Block from a plain dict of numpy lanes — ``n``, ``key_hash``,
        ``ht``, ``write_id``, ``tombstone``, ``pk`` ({cid: values}),
        ``fixed`` ({cid: (values, nulls)}), ``unique_keys`` and
        optionally ``schema_version`` — so a block built elsewhere (the
        reference package, a file) scans the very same rows in the very
        same order here.  Lanes are copied."""
        n = int(d["n"])
        blk = cls.from_arrays(
            schema_version=int(d.get("schema_version", 0)),
            key_hash=np.array(d["key_hash"], np.uint64),
            ht=np.array(d["ht"], np.uint64),
            write_id=np.array(d["write_id"], np.uint32),
            tombstone=np.array(d["tombstone"], bool),
            pk={int(c): np.array(v) for c, v in d["pk"].items()},
            fixed={int(c): (np.array(v), np.array(m, bool))
                   for c, (v, m) in d["fixed"].items()},
            unique_keys=bool(d["unique_keys"]))
        if blk.n != n or any(len(a) != n for a in (
                blk.ht, blk.write_id, blk.tombstone)):
            raise ValueError("lane lengths disagree with n")
        return blk
