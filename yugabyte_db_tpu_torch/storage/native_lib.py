"""ctypes bindings of the port's host library (csrc/host_native.cpp).

Counterpart of the compaction and bypass half of ``yugabyte_db_tpu/
storage/native_lib.py``: bloom build, the k-way merge over a fixed-width
key matrix, the row, multi-column and heap gathers, and the bypass
reader's prefilter range pass (``prefilter_ranges``).  The library is
built with ``g++`` at first use into ``build/host_native/`` (keyed by
the source's hash) and a build failure raises ``NativeBuildError``:
nothing here quietly runs a Python loop instead.  A function returns
False only for an input it does not take (non-contiguous, mismatched
row widths, non-int64 indexes), as the reference's does; the numpy
twins (``gather_multi_fallback`` and friends) stay beside them as their
plain versions for the tests and for such inputs.  The prefilter pass
has a numpy twin for the tests only: ``prefilter_mask`` always runs the
library."""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "host_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_native"

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_vpp = ctypes.POINTER(ctypes.c_void_p)

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


class NativeBuildError(RuntimeError):
    """The host library failed to build or load."""


def library_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libhost_native_{digest}.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    # no -march=native: the checkout (build/ included) may move to a
    # machine with another CPU
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(_SRC),
           "-o", str(tmp)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"g++ could not run: {e!r}") from e
    if out.returncode != 0:
        raise NativeBuildError(f"g++ failed on {_SRC.name}:\n"
                               f"{out.stderr[-4000:]}")
    os.replace(tmp, path)      # atomic: concurrent builders race safely


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            _build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeBuildError(f"cannot load {path}: {e}") from e
        lib.bloom_build.argtypes = [_u64p, ctypes.c_int64, _u8p,
                                    ctypes.c_int64, ctypes.c_int32]
        lib.bloom_build.restype = None
        lib.kway_merge.argtypes = [_u8p, _u64p, _i64p, ctypes.c_int32,
                                   _i64p, _u8p]
        lib.kway_merge.restype = ctypes.c_int64
        lib.gather_rows.argtypes = [_u8p, ctypes.c_int64, _i64p,
                                    ctypes.c_int64, _u8p]
        lib.gather_rows.restype = None
        lib.gather_scatter_rows.argtypes = [_u8p, ctypes.c_int64, _i64p,
                                            _i64p, ctypes.c_int64, _u8p]
        lib.gather_scatter_rows.restype = None
        lib.gather_multi.argtypes = [_vpp, _vpp, _i64p, _vpp, _vpp, _i64p,
                                     ctypes.c_int64]
        lib.gather_multi.restype = None
        lib.gather_heap.argtypes = [_u8p, _i64p, _i64p, _i64p,
                                    ctypes.c_int64, _u8p]
        lib.gather_heap.restype = None
        lib.prefilter_ranges.argtypes = [
            _vpp, _i64p, _vpp, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), _i64p, _i64p, ctypes.c_int64,
            ctypes.c_int64, _u8p]
        lib.prefilter_ranges.restype = None
        _LIB = lib
        return lib


def _ptr(arr: np.ndarray, typ):
    return arr.ctypes.data_as(typ)


def bloom_build(hashes: np.ndarray, nbits: int, k: int) -> np.ndarray:
    """Bloom bits (uint8[nbits // 8]) over 64-bit key hashes, double
    hashing as storage/sst.py BloomFilter probes them."""
    lib = _load()
    hashes = np.ascontiguousarray(hashes, np.uint64)
    bits = np.zeros(nbits // 8, np.uint8)
    lib.bloom_build(_ptr(hashes, _u64p), len(hashes), _ptr(bits, _u8p),
                    nbits, k)
    return bits


def bloom_build_plain(hashes: np.ndarray, nbits: int, k: int) -> np.ndarray:
    """Numpy twin of bloom_build (the reference's fallback)."""
    bits = np.zeros(nbits // 8, np.uint8)
    h1 = np.asarray(hashes, np.uint64)
    h2 = (h1 >> np.uint64(33)) | np.uint64(1)
    for i in range(k):
        idx = (h1 + np.uint64(i) * h2) % np.uint64(nbits)
        np.bitwise_or.at(bits, (idx // 8).astype(np.int64),
                         (1 << (idx % 8)).astype(np.uint8))
    return bits


def kway_merge_fixed(mat: np.ndarray, run_starts: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """K-way merge over a fixed-width key matrix [N, W] (uint8 rows,
    lexicographically sorted within each run). run_starts: [R+1] row
    boundaries, runs newest-first. Returns (merged row order, exact-dup
    flags)."""
    lib = _load()
    n, w = mat.shape
    mat = np.ascontiguousarray(mat)
    off = np.arange(n + 1, dtype=np.uint64) * np.uint64(w)
    run_starts = np.ascontiguousarray(run_starts, np.int64)
    out_idx = np.empty(n, np.int64)
    out_dup = np.empty(n, np.uint8)
    cnt = lib.kway_merge(_ptr(mat.reshape(-1), _u8p), _ptr(off, _u64p),
                         _ptr(run_starts, _i64p), len(run_starts) - 1,
                         _ptr(out_idx, _i64p), _ptr(out_dup, _u8p))
    return out_idx[:cnt], out_dup[:cnt].astype(bool)


def kway_merge_fixed_plain(mat: np.ndarray, run_starts: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy twin of kway_merge_fixed: a stable sort over the full
    encoded keys (runs concatenated newest-first, so ties keep the
    lower run first, as the heap's tie rule does)."""
    v = np.ascontiguousarray(mat).view(
        np.dtype((np.void, mat.shape[1]))).reshape(-1)
    order = np.argsort(v, kind="stable").astype(np.int64)
    ks = v[order]
    return order, np.concatenate([[False], ks[1:] == ks[:-1]])


def _row_bytes(arr: np.ndarray) -> int:
    """Per-row byte count treating axis-0 as rows."""
    rb = arr.dtype.itemsize
    for d in arr.shape[1:]:
        rb *= d
    return rb


def gather_rows(src: np.ndarray, idx: np.ndarray, dst: np.ndarray) -> bool:
    """dst[i] = src[idx[i]] row-wise. False when src/dst are not
    C-contiguous or their row widths differ."""
    if not src.flags["C_CONTIGUOUS"] or not dst.flags["C_CONTIGUOUS"]:
        return False
    rb = _row_bytes(src)
    if rb != _row_bytes(dst):
        return False
    lib = _load()
    idx = np.ascontiguousarray(idx, np.int64)
    lib.gather_rows(ctypes.cast(src.ctypes.data, _u8p), rb,
                    _ptr(idx, _i64p), len(idx),
                    ctypes.cast(dst.ctypes.data, _u8p))
    return True


def gather_scatter_rows(src: np.ndarray, src_idx: np.ndarray,
                        dst: np.ndarray, dst_idx: np.ndarray) -> bool:
    """dst[dst_idx[i]] = src[src_idx[i]] row-wise. False when src/dst
    are not C-contiguous or their row widths differ."""
    if not src.flags["C_CONTIGUOUS"] or not dst.flags["C_CONTIGUOUS"]:
        return False
    rb = _row_bytes(src)
    if rb != _row_bytes(dst):
        return False
    lib = _load()
    src_idx = np.ascontiguousarray(src_idx, np.int64)
    dst_idx = np.ascontiguousarray(dst_idx, np.int64)
    lib.gather_scatter_rows(ctypes.cast(src.ctypes.data, _u8p), rb,
                            _ptr(src_idx, _i64p), _ptr(dst_idx, _i64p),
                            len(src_idx),
                            ctypes.cast(dst.ctypes.data, _u8p))
    return True


def gather_multi(jobs: Sequence[tuple]) -> bool:
    """The fused multi-column gather/scatter: one GIL-released call runs
    every ``(src, dst, src_idx, dst_idx)`` job (``src_idx`` None:
    identity source rows; ``dst_idx`` None: dense output rows).  Index
    arrays must already be int64 and C-contiguous.  False (the caller
    uses gather_multi_fallback) when there are no jobs or any job is
    ineligible: non-contiguous src/dst, mismatched row widths,
    non-int64 indexes, or a dense side shorter than the rows moved."""
    if not jobs:
        return False
    n_jobs = len(jobs)
    src_p = (ctypes.c_void_p * n_jobs)()
    dst_p = (ctypes.c_void_p * n_jobs)()
    sidx_p = (ctypes.c_void_p * n_jobs)()
    didx_p = (ctypes.c_void_p * n_jobs)()
    rb = np.empty(n_jobs, np.int64)
    cnt = np.empty(n_jobs, np.int64)
    for j, (src, dst, src_idx, dst_idx) in enumerate(jobs):
        if not src.flags["C_CONTIGUOUS"] or not dst.flags["C_CONTIGUOUS"]:
            return False
        r = _row_bytes(src)
        if r != _row_bytes(dst):
            return False
        n = None
        for idx in (src_idx, dst_idx):
            if idx is None:
                continue
            if idx.dtype != np.int64 or not idx.flags["C_CONTIGUOUS"]:
                return False
            if n is None:
                n = len(idx)
            elif len(idx) != n:
                return False
        if n is None:       # pure copy: row counts must agree
            n = len(src)
            if len(dst) < n:
                return False
        elif dst_idx is None and len(dst) < n:
            return False    # dense gather into an undersized dst
        elif src_idx is None and len(src) < n:
            return False    # scatter reading past a short source
        src_p[j] = src.ctypes.data
        dst_p[j] = dst.ctypes.data
        sidx_p[j] = src_idx.ctypes.data if src_idx is not None else None
        didx_p[j] = dst_idx.ctypes.data if dst_idx is not None else None
        rb[j] = r
        cnt[j] = n
    _load().gather_multi(src_p, dst_p, _ptr(rb, _i64p), sidx_p, didx_p,
                         _ptr(cnt, _i64p), n_jobs)
    return True


def gather_multi_fallback(jobs: Sequence[tuple]) -> None:
    """Numpy twin of gather_multi (also the parity oracle in tests)."""
    for src, dst, src_idx, dst_idx in jobs:
        if src_idx is None and dst_idx is None:
            dst[:len(src)] = src
        elif dst_idx is None:
            dst[:len(src_idx)] = src[src_idx]
        elif src_idx is None:
            dst[dst_idx] = src[:len(dst_idx)]
        else:
            dst[dst_idx] = src[src_idx]


def gather_columns(jobs: Sequence[tuple]) -> None:
    """gather_multi, with the numpy twin for jobs it does not take."""
    if not gather_multi(jobs):
        gather_multi_fallback(jobs)


def gather_heap(heap: np.ndarray, src_start: np.ndarray,
                dst_start: np.ndarray, lens: np.ndarray,
                out: np.ndarray) -> bool:
    """Varlen heap gather: out[dst_start[i]:+lens[i]] =
    heap[src_start[i]:+lens[i]] per row. False for inputs it does not
    take (the caller uses gather_heap_fallback)."""
    if heap.dtype != np.uint8 or not heap.flags["C_CONTIGUOUS"] \
            or not out.flags["C_CONTIGUOUS"]:
        return False
    n = len(lens)
    if len(src_start) != n or len(dst_start) != n:
        return False
    for a in (src_start, dst_start, lens):
        if a.dtype != np.int64 or not a.flags["C_CONTIGUOUS"]:
            return False
    _load().gather_heap(_ptr(heap, _u8p), _ptr(src_start, _i64p),
                        _ptr(dst_start, _i64p), _ptr(lens, _i64p), n,
                        _ptr(out, _u8p))
    return True


def gather_heap_fallback(heap: np.ndarray, src_start: np.ndarray,
                         dst_start: np.ndarray, lens: np.ndarray,
                         out: np.ndarray) -> None:
    """Numpy twin of gather_heap (the repeat-offsets trick)."""
    lens = np.asarray(lens, np.int64)
    tot = int(lens.sum())
    if not tot:
        return
    ramp = np.arange(tot, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens)
    out[np.repeat(dst_start, lens) + ramp] = \
        heap[np.repeat(src_start, lens) + ramp]


#: lane dtype -> prefilter_ranges code (the C switch)
PREFILTER_DTYPES = {
    np.dtype(np.int32): 1, np.dtype(np.int64): 2,
    np.dtype(np.float32): 3, np.dtype(np.float64): 4,
    np.dtype(np.uint32): 5,
}

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def prefilter_ranges(preds: Sequence[tuple], n: int) -> np.ndarray:
    """Near-data predicate pre-filter: one native call (GIL released)
    evaluates every (values, nulls, lo, hi) inclusive range predicate
    over the encoded lanes and ANDs them into a keep mask (uint8[n]; a
    NULL row fails its predicate).  Non-contiguous lanes are copied
    first; a lane dtype outside ``PREFILTER_DTYPES``, a length that is
    not `n` or integer bounds outside int64 raise ValueError."""
    np_ = len(preds)
    col_p = (ctypes.c_void_p * max(np_, 1))()
    null_p = (ctypes.c_void_p * max(np_, 1))()
    dt = np.empty(max(np_, 1), np.int64)
    lo_f = np.zeros(max(np_, 1), np.float64)
    hi_f = np.zeros(max(np_, 1), np.float64)
    lo_i = np.zeros(max(np_, 1), np.int64)
    hi_i = np.zeros(max(np_, 1), np.int64)
    held = []           # the lanes the call reads stay referenced here
    for j, (vals, nulls, lo, hi) in enumerate(preds):
        code = PREFILTER_DTYPES.get(vals.dtype)
        if code is None or vals.ndim != 1 or len(vals) != n:
            raise ValueError(f"prefilter lane {j}: dtype {vals.dtype}, "
                             f"shape {vals.shape}, rows {n}")
        vals = np.ascontiguousarray(vals)
        held.append(vals)
        if nulls is not None:
            nulls = np.ascontiguousarray(nulls, np.bool_)
            if len(nulls) != n:
                raise ValueError(f"prefilter lane {j}: null mask length")
            held.append(nulls)
            null_p[j] = nulls.ctypes.data
        if code in (1, 2, 5):
            if not (_I64_MIN <= lo <= _I64_MAX
                    and _I64_MIN <= hi <= _I64_MAX):
                raise ValueError(f"prefilter lane {j}: integer bounds "
                                 f"({lo}, {hi}) outside int64")
            lo_i[j], hi_i[j] = int(lo), int(hi)
        else:
            lo_f[j], hi_f[j] = float(lo), float(hi)
        col_p[j] = vals.ctypes.data
        dt[j] = code
    keep = np.empty(n, np.uint8)
    _load().prefilter_ranges(
        col_p, _ptr(dt, _i64p), null_p,
        lo_f.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        hi_f.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _ptr(lo_i, _i64p), _ptr(hi_i, _i64p), np_, n, _ptr(keep, _u8p))
    return keep


def prefilter_ranges_plain(preds: Sequence[tuple], n: int) -> np.ndarray:
    """Numpy twin of prefilter_ranges (the tests' plain version)."""
    keep = np.ones(n, bool)
    for vals, nulls, lo, hi in preds:
        if vals.dtype.kind == "f":
            m = (vals >= np.float64(lo)) & (vals <= np.float64(hi))
        else:
            m = (vals >= lo) & (vals <= hi)
        if nulls is not None:
            m = m & ~nulls
        keep &= m
    return keep.astype(np.uint8)


def prefilter_mask(preds: Sequence[tuple], n: int) -> np.ndarray:
    """The bypass reader's entry point: the native range pass, with no
    numpy fallback."""
    return prefilter_ranges(preds, n)
