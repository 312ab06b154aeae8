"""Varlen (string) dictionary coding and remap tables.

Counterpart of the dictionary half of ``yugabyte_db_tpu/storage/
lane_codec.py`` (``varlen_code_rows`` .. ``dict_identity``); the
on-disk lane encodings stay with the SST copy (ROADMAP.md queue 1 item
9).  Dictionary GROUP BY and string predicates (ops/grouped_scan.py)
run over dictionary CODES.  Everything stays at the byte level: uniques
come from a padded-matrix void view (UTF-8 byte order is code-point
order, and an explicit length column keeps "a" distinct from, and
ordered before, "a\\x00"), so chunk-local codes translate into a
scan-global dictionary through an integer remap table without decoding
row strings."""
from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

#: rows longer than this never dictionary-code (the padded unique
#: matrix is O(n * max_len); long payloads are unlikely to repeat)
_VARLEN_DICT_MAX_LEN = 255

#: prefix-sample guard: near-unique lanes are skipped cheaply
_VARLEN_DICT_SAMPLE = 2048
_VARLEN_DICT_SAMPLE_MAX = 384


def varlen_code_rows(ends: np.ndarray, heap,
                     null: Optional[np.ndarray] = None,
                     max_len: int = _VARLEN_DICT_MAX_LEN,
                     max_card: Optional[int] = None,
                     sample_guard: bool = True):
    """Dictionary-code one varlen lane without decoding strings.

    Returns ``(uniq_lens uint8[k], uniq_heap uint8[...], codes int32[n])``
    — uniques sorted in byte order (string order for UTF-8), codes
    indexing into them — or None when the lane doesn't qualify (a row
    longer than `max_len`, or more than `max_card` distinct values).
    NULL rows code as the empty string."""
    n = len(ends)
    if n == 0:
        return (np.zeros(0, np.uint8), np.zeros(0, np.uint8),
                np.zeros(0, np.int32))
    hb = np.frombuffer(heap, np.uint8) if not isinstance(heap, np.ndarray) \
        else heap.view(np.uint8)
    ends64 = np.asarray(ends, np.int64)
    starts = np.concatenate([[0], ends64[:-1]])
    lens = ends64 - starts
    if null is not None:
        lens = np.where(np.asarray(null, bool), 0, lens)
    w = int(lens.max())
    if w > max_len:
        return None
    # padded [n, w+1] matrix: row bytes then the length byte
    mat = np.zeros((n, w + 1), np.uint8)
    if w:
        idx = starts[:, None] + np.arange(w)[None, :]
        inb = np.arange(w)[None, :] < lens[:, None]
        np.clip(idx, 0, max(len(hb) - 1, 0), out=idx)
        mat[:, :w] = np.where(inb, hb[idx] if len(hb) else 0, 0)
    mat[:, w] = lens.astype(np.uint8)
    rows = np.ascontiguousarray(mat).view(np.dtype((np.void, w + 1))) \
        .reshape(-1)
    if sample_guard and max_card is not None and n > _VARLEN_DICT_SAMPLE:
        if len(np.unique(rows[:_VARLEN_DICT_SAMPLE])) > \
                _VARLEN_DICT_SAMPLE_MAX:
            return None
    uniq, codes = np.unique(rows, return_inverse=True)
    if max_card is not None and len(uniq) > max_card:
        return None
    umat = uniq.view(np.uint8).reshape(len(uniq), w + 1)
    ulens = umat[:, w]
    parts = [umat[i, :ulens[i]] for i in range(len(uniq))]
    uniq_heap = (np.concatenate(parts) if parts
                 else np.zeros(0, np.uint8))
    return (ulens.astype(np.uint8), np.ascontiguousarray(uniq_heap),
            codes.astype(np.int32).reshape(-1))


def decode_dict_strings(uniq_lens: np.ndarray, uniq_heap) -> np.ndarray:
    """Object array of str — the uniques only (k strings, not n rows).
    Raises UnicodeDecodeError on non-UTF8 payloads."""
    hb = bytes(uniq_heap) if not isinstance(uniq_heap, bytes) \
        else uniq_heap
    out = np.empty(len(uniq_lens), object)
    lo = 0
    for i, ln in enumerate(np.asarray(uniq_lens, np.int64)):
        out[i] = hb[lo:lo + ln].decode()
        lo += ln
    return out


def remap_table(local_uniq: np.ndarray,
                global_uniq: np.ndarray) -> np.ndarray:
    """int32 table translating codes over `local_uniq` into codes over
    `global_uniq` (both sorted; every local value is present globally)."""
    return np.searchsorted(global_uniq, local_uniq).astype(np.int32)


def merge_dicts(uniq_list):
    """Merge per-chunk sorted dictionaries into one scan-global sorted
    dictionary: ``(global_uniq, [remap_table per input])``."""
    if not uniq_list:
        return np.zeros(0, object), []
    global_uniq = np.unique(np.concatenate(uniq_list))
    return global_uniq, [remap_table(u, global_uniq) for u in uniq_list]


def dict_identity(uniq: np.ndarray) -> tuple:
    """Content identity of a dictionary for device-cache keys: (size,
    64-bit blake2b over the NUL-joined UTF-8 bytes)."""
    h = hashlib.blake2b(digest_size=8)
    for s in uniq:
        h.update(s.encode() if isinstance(s, str) else bytes(s))
        h.update(b"\x00")
    return (len(uniq), int.from_bytes(h.digest(), "little"))
