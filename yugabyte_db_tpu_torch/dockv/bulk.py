"""Vectorized (numpy) doc-key encoding for bulk ingest.

Counterpart of ``yugabyte_db_tpu/dockv/bulk.py``: the same column
encoders, partition hash, DocKey assembly, hybrid-time suffix and sort
order, byte for byte (tests/test_torch_slice.py holds the blocks built
from them against the reference's)."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .key_encoding import ValueType


def encode_int64_column(values: np.ndarray, desc: bool = False) -> np.ndarray:
    """[N] int64 -> [N, 9] uint8 of kInt64-typed order-preserving encoding."""
    v = values.astype(np.int64, copy=False)
    biased = (v.astype(np.uint64) + np.uint64(1 << 63)).astype(">u8")
    raw = biased.view(np.uint8).reshape(-1, 8)
    t = ValueType.kInt64
    if desc:
        raw = raw ^ np.uint8(0xFF)
        t = ValueType.kInt64Desc
    out = np.empty((len(v), 9), np.uint8)
    out[:, 0] = t
    out[:, 1:] = raw
    return out


def encode_int32_column(values: np.ndarray, desc: bool = False) -> np.ndarray:
    v = values.astype(np.int32, copy=False)
    biased = (v.astype(np.int64) + (1 << 31)).astype(">u4")
    raw = biased.view(np.uint8).reshape(-1, 4)
    t = ValueType.kInt32
    if desc:
        raw = raw ^ np.uint8(0xFF)
        t = ValueType.kInt32Desc
    out = np.empty((len(v), 5), np.uint8)
    out[:, 0] = t
    out[:, 1:] = raw
    return out


def encode_double_column(values: np.ndarray, desc: bool = False) -> np.ndarray:
    bits = values.astype(np.float64, copy=False).view(np.uint64)
    neg = (bits >> np.uint64(63)).astype(bool)
    flipped = np.where(neg, ~bits, bits | np.uint64(1 << 63)).astype(">u8")
    raw = flipped.view(np.uint8).reshape(-1, 8)
    t = ValueType.kDouble
    if desc:
        raw = raw ^ np.uint8(0xFF)
        t = ValueType.kDoubleDesc
    out = np.empty((len(values), 9), np.uint8)
    out[:, 0] = t
    out[:, 1:] = raw
    return out


def _retype(block: np.ndarray, t: int) -> np.ndarray:
    block[:, 0] = t
    return block


def fast_hash16_from_encoded(enc: np.ndarray) -> np.ndarray:
    """FNV-1a over encoded key component bytes, folded to 16 bits — the
    engine-wide partition hash."""
    h = np.full(enc.shape[0], np.uint64(0xCBF29CE484222325))
    prime = np.uint64(0x100000001B3)
    for j in range(enc.shape[1]):
        h = (h ^ enc[:, j].astype(np.uint64)) * prime
    h ^= h >> np.uint64(32)
    return (h & np.uint64(0xFFFF)).astype(np.uint32)


def encode_doc_keys(hash_values: Optional[np.ndarray],
                    component_blocks: Sequence[np.ndarray],
                    num_hash_components: int = 0) -> np.ndarray:
    """Build [N, L] uint8 encoded DocKeys from per-component encoded
    blocks (hash_values: uint16 partition hashes, or None for
    range-sharded keys)."""
    n = component_blocks[0].shape[0] if component_blocks else len(hash_values)
    parts: List[np.ndarray] = []
    if hash_values is not None:
        hdr = np.empty((n, 3), np.uint8)
        hdr[:, 0] = ValueType.kUInt16Hash
        hdr[:, 1:] = hash_values.astype(">u2").view(np.uint8).reshape(-1, 2)
        parts.append(hdr)
        parts.extend(component_blocks[:num_hash_components])
        parts.append(np.full((n, 1), ValueType.kGroupEnd, np.uint8))
    parts.extend(component_blocks[num_hash_components:])
    parts.append(np.full((n, 1), ValueType.kGroupEnd, np.uint8))
    return np.concatenate(parts, axis=1)


def append_hybrid_times(doc_keys: np.ndarray, ht_values: np.ndarray,
                        write_ids: np.ndarray) -> np.ndarray:
    """[N, L] keys + per-row DocHybridTime -> [N, L+13] encoded SubDocKeys
    (kHybridTime marker + 12-byte descending-encoded (ht, write_id))."""
    n = doc_keys.shape[0]
    marker = np.full((n, 1), ValueType.kHybridTime, np.uint8)
    ht_be = (~ht_values.astype(np.uint64)).astype(">u8").view(
        np.uint8).reshape(-1, 8)
    wid_be = (~write_ids.astype(np.uint32)).astype(">u4").view(
        np.uint8).reshape(-1, 4)
    return np.concatenate([doc_keys, marker, ht_be, wid_be], axis=1)


#: packable integer component types -> their STORAGE dtype (values wrap
#: through it before biasing, exactly like the byte encoders)
_PACKABLE_TYPES = {"int32": np.int32, "int64": np.int64,
                   "timestamp": np.int64}


def bulk_sort_order(hash_values: Optional[np.ndarray],
                    components: Sequence[tuple],
                    doc_keys: np.ndarray) -> np.ndarray:
    """Sort order of N rows by encoded-doc-key byte order, computed from
    the ORIGINAL numeric columns when every component is integer-typed
    (one packed uint64 radix argsort), else from the byte matrix.

    components: [(values, type_name, desc)] per PK component."""
    parts: List[np.ndarray] = []
    spans: List[int] = []
    if hash_values is not None:
        parts.append(hash_values.astype(np.uint64))
        spans.append(1 << 16)
    ok = len(doc_keys) > 0
    if ok:
        for values, tname, desc in components:
            dtype = _PACKABLE_TYPES.get(tname)
            if dtype is None:
                ok = False
                break
            u = (np.asarray(values).astype(dtype).astype(np.int64)
                 .astype(np.uint64) + np.uint64(1 << 63))
            if desc:
                u = ~u
            u = u - u.min()
            parts.append(u)
            spans.append(int(u.max()) + 1)
    if ok and parts:
        total_bits = sum(max(1, int(s - 1).bit_length()) for s in spans)
        if total_bits <= 63:
            packed = np.zeros(len(doc_keys), np.uint64)
            for u, s in zip(parts, spans):
                packed = (packed << np.uint64(
                    max(1, int(s - 1).bit_length()))) | u
            return np.argsort(packed, kind="stable")
        if len(parts) <= 3:
            return np.lexsort(tuple(reversed(parts)))
    v = np.ascontiguousarray(doc_keys).view(
        np.dtype((np.void, doc_keys.shape[1]))).reshape(-1)
    return np.argsort(v, kind="stable")
