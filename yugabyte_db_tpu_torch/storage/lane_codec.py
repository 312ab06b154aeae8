"""Per-lane encodings of the v2 columnar block format, and varlen
(string) dictionary coding with remap tables.

Counterpart of ``yugabyte_db_tpu/storage/lane_codec.py``.

Lane encodings (``encode_lane``/``decode_lane``): each block lane is
encoded on its own with the cheapest scheme that strictly shrinks it,
raw otherwise — const, dconst (arithmetic progression), delta (zigzag
deltas in the narrowest unsigned dtype), rle and dict — over an
unsigned-integer VIEW of the lane, so float and bool lanes round-trip
bit for bit.  The writer's bytes equal the reference's.

Dictionary GROUP BY and string predicates (ops/grouped_scan.py) run
over dictionary CODES.  Everything stays at the byte level: uniques
come from a padded-matrix void view (UTF-8 byte order is code-point
order, and an explicit length column keeps "a" distinct from, and
ordered before, "a\\x00"), so chunk-local codes translate into a
scan-global dictionary through an integer remap table without decoding
row strings."""
from __future__ import annotations

import hashlib
from typing import Callable, List, Optional, Tuple

import numpy as np

#: unsigned view dtype per itemsize — encodings reinterpret, never
#: convert, so float/bool lanes round-trip bit-exactly
_UVIEW = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_NARROW = (np.uint8, np.uint16, np.uint32)

#: dict encoding is only attempted when a small prefix sample stays
#: under this many distinct values
_DICT_SAMPLE = 2048
_DICT_SAMPLE_MAX = 384


def _uview(arr: np.ndarray) -> Optional[np.ndarray]:
    """1-D same-width unsigned reinterpret of a lane (None when the
    dtype has no unsigned twin — such lanes stay raw)."""
    if arr.ndim != 1:
        return None
    u = _UVIEW.get(arr.dtype.itemsize)
    if u is None or arr.dtype.kind not in "iufb":
        return None
    return np.ascontiguousarray(arr).view(u)


def _narrowest(maxval: int) -> Optional[np.dtype]:
    for dt in _NARROW:
        if maxval <= np.iinfo(dt).max:
            return np.dtype(dt)
    return None


def encode_lane(arr: np.ndarray) -> Tuple[dict, List[np.ndarray], str]:
    """(meta, buffers, encoding_name) for one lane. The meta carries
    everything decode_lane needs; buffers are contiguous ndarrays the
    caller streams to the file in order."""
    raw = np.ascontiguousarray(arr)
    raw_meta = {"dtype": str(arr.dtype), "shape": list(arr.shape),
                "len": raw.nbytes}
    u = _uview(raw)
    n = 0 if u is None else len(u)
    if u is None or n < 2:
        return raw_meta, [raw], "raw"
    cands: List[Tuple[int, str, list, List[np.ndarray]]] = []

    diffs = u[1:] - u[:-1]            # wraparound delta in lane width
    if not diffs.any():
        cands.append((raw.dtype.itemsize, "const", [], [u[:1]]))
    elif n > 2 and not (diffs[1:] != diffs[0]).any():
        cands.append((2 * raw.dtype.itemsize, "dconst", [], [u[:2]]))
    else:
        # delta: zigzag the signed wraparound deltas into the narrowest
        # dtype that fits
        signed = diffs.view(np.dtype(f"i{raw.dtype.itemsize}"))
        neg = np.where(signed < 0, np.iinfo(u.dtype).max,
                       0).astype(u.dtype)       # all-ones for negatives
        zz = (diffs << np.uint8(1)) ^ neg
        ndt = _narrowest(int(zz.max()))
        if ndt is not None and ndt.itemsize < raw.dtype.itemsize:
            zzn = zz.astype(ndt)
            cands.append((raw.dtype.itemsize + zzn.nbytes, "delta",
                          [str(ndt)], [u[:1], zzn]))
        bnd = np.nonzero(diffs)[0]
        runs = len(bnd) + 1
        rle_bytes = runs * (raw.dtype.itemsize + 4)
        if rle_bytes < raw.nbytes:
            starts = np.concatenate([[0], bnd + 1])
            lens = np.diff(np.concatenate([starts, [n]])).astype(np.uint32)
            cands.append((rle_bytes, "rle", [], [u[starts], lens]))
        if len(np.unique(u[:_DICT_SAMPLE])) <= _DICT_SAMPLE_MAX:
            uniq, codes = np.unique(u, return_inverse=True)
            cdt = _narrowest(len(uniq) - 1)
            if cdt is not None and cdt.itemsize < raw.dtype.itemsize:
                size = uniq.nbytes + n * cdt.itemsize
                if size < raw.nbytes:
                    cands.append((size, "dict", [len(uniq), str(cdt)],
                                  [uniq, codes.reshape(-1).astype(cdt)]))
    if not cands:
        return raw_meta, [raw], "raw"
    size, enc, extra, bufs = min(cands, key=lambda c: c[0])
    if size >= raw.nbytes:            # encode ONLY if strictly smaller
        return raw_meta, [raw], "raw"
    bufs = [np.ascontiguousarray(b) for b in bufs]
    meta = {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "enc": enc, "x": extra,
            "parts": [b.nbytes for b in bufs]}
    return meta, bufs, enc


def decode_lane(meta: dict, fetch: Callable[[int], object]) -> np.ndarray:
    """Rebuild a lane from its meta + the file stream. ``fetch(nbytes)``
    returns the next raw byte region (bytes/memoryview; may be a
    zero-copy view of the SST mapping for raw lanes)."""
    dt = np.dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    enc = meta.get("enc")
    if enc is None:
        raw = fetch(meta["len"])
        return np.frombuffer(raw, dtype=dt).reshape(shape)
    n = shape[0]
    udt = np.dtype(_UVIEW[dt.itemsize])
    parts = [np.frombuffer(fetch(nb), np.uint8) for nb in meta["parts"]]
    if enc == "const":
        u = np.broadcast_to(parts[0].view(udt), (n,))
    elif enc == "dconst":
        fs = parts[0].view(udt)
        step = (fs[1:] - fs[:1])[0]              # wraparound-exact
        u = fs[0] + step * np.arange(n, dtype=udt)
    elif enc == "delta":
        zz = parts[1].view(np.dtype(meta["x"][0])).astype(udt)
        signed = ((zz >> np.uint8(1))
                  ^ (-(zz & np.uint8(1)).astype(
                      np.dtype(f"i{dt.itemsize}"))).view(udt))
        u = np.cumsum(np.concatenate([parts[0].view(udt), signed]),
                      dtype=udt)
    elif enc == "rle":
        vals = parts[0].view(udt)
        lens = parts[1].view(np.uint32)
        u = np.repeat(vals, lens.astype(np.int64))
    elif enc == "dict":
        _k, cdt = meta["x"]
        uniq = parts[0].view(udt)
        codes = parts[1].view(np.dtype(cdt))
        u = uniq[codes]
    else:
        raise ValueError(f"unknown lane encoding {enc!r}")
    return np.ascontiguousarray(u).view(dt).reshape(shape)


def tally(stats: Optional[dict], lane: str, pre: int, post: int,
          enc: str) -> None:
    """Accumulate per-lane encode accounting; no-op when the caller
    passed no stats dict."""
    if stats is None:
        return
    lanes = stats.setdefault("lanes", {})
    ent = lanes.setdefault(lane, {"pre_bytes": 0, "post_bytes": 0,
                                  "encodings": {}})
    ent["pre_bytes"] += pre
    ent["post_bytes"] += post
    ent["encodings"][enc] = ent["encodings"].get(enc, 0) + 1

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
