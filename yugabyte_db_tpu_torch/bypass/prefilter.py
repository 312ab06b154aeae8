"""Near-data predicate pre-filter: drop provably-unmatched rows from a
chunk's encoded lanes before batch formation.

Counterpart of ``yugabyte_db_tpu/bypass/prefilter.py``.  The WHERE
tree's top-level AND conjuncts of shape ``col <op> const`` / BETWEEN
collapse into one conservative inclusive interval per column.  One
native pass (storage/native_lib.prefilter_mask, csrc/host_native.cpp)
evaluates the intervals over each block's fixed-width lanes, and the
surviving rows gather — through the host library's fused gather — into
a compacted block.  Everything dropped is a row the scan kernel could
never have matched:

  * integer lanes compare exactly (the kernel keeps integer dtypes);
  * float lanes widen every bound one f32 ulp outward and treat strict
    bounds as inclusive (the kernel may evaluate in float32);
  * NULL rows fail their conjunct, as the kernel's NULL comparisons do;
  * OR/IN/NOT/expression shapes contribute no interval.

Dropped rows add zero to every aggregate lane, and the batch keeps the
unfiltered chunk's bucket and static-scale bounds (``bounds_blocks``),
so the filtered scan answers with the unfiltered scan's bits.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..ops.scan import _f32_widen
from ..storage import native_lib
from ..storage.columnar import ColumnarBlock

#: (lo, lo_strict, hi, hi_strict) — open bounds as ±inf.  Bounds keep
#: their Python type: int constants stay exact ints (a float would round
#: above 2^53 and could drop rows the kernel matches); Python's
#: int-vs-float comparison is exact, so mixed intersections are safe.
_Interval = Tuple[object, bool, object, bool]

_INF = float("inf")

#: the most recent prefilter tally (informational)
LAST_PREFILTER_STATS = {"rows_in": 0, "rows_kept": 0, "blocks": 0,
                        "blocks_compacted": 0}


def _const_num(node):
    if (isinstance(node, (tuple, list)) and node
            and node[0] == "const"
            and isinstance(node[1], (int, float))
            and not isinstance(node[1], bool)
            # a NaN constant proves nothing: leave it to the kernel
            # (±inf stays: it clamps to an empty or an unbounded range)
            and not (isinstance(node[1], float) and np.isnan(node[1]))):
        return node[1]
    return None


def _col_id(node):
    if isinstance(node, (tuple, list)) and node and node[0] == "col":
        return node[1]
    return None


def _intersect(a: _Interval, b: _Interval) -> _Interval:
    lo, los, hi, his = a
    blo, blos, bhi, bhis = b
    if blo > lo or (blo == lo and blos):
        lo, los = blo, blos
    if bhi < hi or (bhi == hi and bhis):
        hi, his = bhi, bhis
    return (lo, los, hi, his)


_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq",
         "ne": "ne"}


def extract_intervals(where) -> Dict[int, _Interval]:
    """col id -> the interval the top-level AND conjuncts of `where`
    imply.  Only shapes that MUST hold for a row to match contribute;
    the kernel still applies the whole predicate."""
    out: Dict[int, _Interval] = {}
    if where is None:
        return out

    def add(cid, iv: _Interval):
        out[cid] = _intersect(out[cid], iv) if cid in out else iv

    def walk(node):
        if not isinstance(node, (tuple, list)) or not node:
            return
        kind = node[0]
        if kind == "and":
            for c in node[1:]:
                walk(c)
            return
        if kind == "between":
            cid = _col_id(node[1])
            lo, hi = _const_num(node[2]), _const_num(node[3])
            if cid is not None and lo is not None and hi is not None:
                add(cid, (lo, False, hi, False))
            return
        if kind != "cmp":
            return
        op, l, r = node[1], node[2], node[3]
        cid, v = _col_id(l), _const_num(r)
        if cid is None:
            cid, v = _col_id(r), _const_num(l)
            if cid is None or v is None:
                return
            op = _FLIP.get(op)
            if op is None:
                return
        if v is None:
            return
        if op == "eq":
            add(cid, (v, False, v, False))
        elif op == "lt":
            add(cid, (-_INF, False, v, True))
        elif op == "le":
            add(cid, (-_INF, False, v, False))
        elif op == "gt":
            add(cid, (v, True, _INF, False))
        elif op == "ge":
            add(cid, (v, False, _INF, False))
        # ne: no interval

    walk(where)
    return out


def _clamp_to_lane(iv: _Interval, dtype: np.dtype
                   ) -> Optional[Tuple[object, object]]:
    """Interval -> inclusive (lo, hi) in the lane's own domain, or None
    when the lane can't be range-tested.  Integer lanes resolve
    strictness exactly; float lanes widen to the f32 envelope and treat
    strict bounds as inclusive."""
    lo, los, hi, his = iv
    if dtype.kind in "iu":
        try:
            info = np.iinfo(dtype)
        except ValueError:
            return None
        if lo == _INF or hi == -_INF:
            # v >= +inf / v <= -inf: nothing matches; (1, 0) is an empty
            # range valid for every int dtype
            return (1, 0)
        if lo == -_INF:
            ilo = int(info.min)
        elif isinstance(lo, int):
            # exact-int bounds stay exact above 2^53
            ilo = lo + 1 if los else lo
        else:
            f = np.floor(lo)
            # v > 5.0 -> v >= 6; v > 4.5 and v >= 4.5 both -> v >= 5
            ilo = int(f) + 1 if (los and lo == f) else int(np.ceil(lo))
        if hi == _INF:
            ihi = int(info.max)
        elif isinstance(hi, int):
            ihi = hi - 1 if his else hi
        else:
            c = np.ceil(hi)
            ihi = int(c) - 1 if (his and hi == c) else int(np.floor(hi))
        if ilo > ihi:
            return (1, 0)
        return (max(ilo, int(info.min)), min(ihi, int(info.max)))
    if dtype.kind == "f":
        wlo = lo if lo == -_INF else _f32_widen(lo, lo)[0]
        whi = hi if hi == _INF else _f32_widen(hi, hi)[1]
        return (wlo, whi)
    return None


def block_predicates(block: ColumnarBlock,
                     intervals: Dict[int, _Interval]):
    """The per-column intervals resolved against one block's lanes: a
    list of (values, nulls, lo, hi) jobs for the native range pass.
    Columns the block lacks in fixed-width form contribute nothing."""
    preds = []
    for cid, iv in intervals.items():
        if cid in block.fixed:
            vals, nulls = block.fixed[cid]
        elif cid in block.pk:
            vals, nulls = block.pk[cid], None
        else:
            continue
        vals = np.asarray(vals)
        rng = _clamp_to_lane(iv, vals.dtype)
        if rng is None:
            continue
        preds.append((vals,
                      np.asarray(nulls) if nulls is not None else None,
                      rng[0], rng[1]))
    return preds


def compact_block(block: ColumnarBlock, keep_idx: np.ndarray,
                  columns: Sequence[int]) -> ColumnarBlock:
    """The kept rows of `block` (needed columns + MVCC lanes) gathered
    into a fresh owned block by one fused native gather
    (storage/native_lib.gather_columns)."""
    m = len(keep_idx)
    jobs = []

    def gather(src: np.ndarray) -> np.ndarray:
        src = np.ascontiguousarray(src)
        dst = np.empty((m,) + src.shape[1:], src.dtype)
        jobs.append((src, dst, keep_idx, None))
        return dst

    key_hash = gather(block.key_hash)
    ht = gather(block.ht)
    write_id = gather(block.write_id)
    tombstone = gather(block.tombstone)
    pk = {cid: gather(block.pk[cid]) for cid in block.pk
          if cid in columns}
    fixed = {cid: (gather(v), gather(nu))
             for cid, (v, nu) in block.fixed.items() if cid in columns}
    native_lib.gather_columns(jobs)
    return ColumnarBlock.from_arrays(
        schema_version=block.schema_version, key_hash=key_hash, ht=ht,
        write_id=write_id, pk=pk, fixed=fixed, tombstone=tombstone,
        unique_keys=block.unique_keys)


def make_prefilter(where, columns: Sequence[int]):
    """The per-chunk prefilter callable for streaming_scan_aggregate, or
    None when `where` yields no interval to filter on."""
    intervals = extract_intervals(where)
    if not intervals:
        return None
    cols = tuple(columns)
    LAST_PREFILTER_STATS.update(rows_in=0, rows_kept=0, blocks=0,
                                blocks_compacted=0)

    def prefilter(chunk):
        out = []
        for b in chunk:
            LAST_PREFILTER_STATS["blocks"] += 1
            LAST_PREFILTER_STATS["rows_in"] += b.n
            preds = block_predicates(b, intervals)
            if not preds or b.n == 0:
                LAST_PREFILTER_STATS["rows_kept"] += b.n
                out.append(b)
                continue
            keep = native_lib.prefilter_mask(preds, b.n)
            idx = np.flatnonzero(keep).astype(np.int64)
            if len(idx) == b.n:
                LAST_PREFILTER_STATS["rows_kept"] += b.n
                out.append(b)
                continue
            LAST_PREFILTER_STATS["rows_kept"] += len(idx)
            LAST_PREFILTER_STATS["blocks_compacted"] += 1
            out.append(compact_block(b, idx, cols))
        return out

    return prefilter
