"""Vectorized numpy CPU scan — the host baseline.

Counterpart of ``yugabyte_db_tpu/ops/cpu_scan.py``: whole-column numpy
evaluation over the same columnar blocks the device path reads (a stand-in
for the reference system's C++ scan loop,
src/yb/docdb/pgsql_operation.cc:2790), so a device-against-baseline ratio
measures execution, not Python overhead.  ``eval_expr_np`` is also what
the fused plan's CPU twin (ops/plan_fusion.py ``fused_plan_cpu``)
evaluates its expressions with.  Pure numpy: no torch, no device.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..storage.columnar import ColumnarBlock
from .scan import AggSpec, GroupSpec, _expand_avg

_CMP = {"lt": np.less, "le": np.less_equal, "gt": np.greater,
        "ge": np.greater_equal, "eq": np.equal, "ne": np.not_equal}
_ARITH = {"add": np.add, "sub": np.subtract, "mul": np.multiply,
          "div": np.divide}


def eval_expr_np(node: tuple, cols: Dict[int, np.ndarray],
                 nulls: Dict[int, np.ndarray]):
    """Returns (values ndarray, null_mask ndarray | None)."""
    kind = node[0]
    if kind == "col":
        return cols[node[1]], nulls.get(node[1])
    if kind == "const":
        return node[1], None
    if kind in ("cmp", "arith"):
        l, ln = eval_expr_np(node[2], cols, nulls)
        r, rn = eval_expr_np(node[3], cols, nulls)
        op = (_CMP if kind == "cmp" else _ARITH)[node[1]]
        return op(l, r), _or(ln, rn)
    if kind in ("and", "or"):
        l, ln = eval_expr_np(node[1], cols, nulls)
        r, rn = eval_expr_np(node[2], cols, nulls)
        op = np.logical_and if kind == "and" else np.logical_or
        return op(l, r), _or(ln, rn)
    if kind == "not":
        v, n = eval_expr_np(node[1], cols, nulls)
        return np.logical_not(v), n
    if kind == "between":
        x, xn = eval_expr_np(node[1], cols, nulls)
        lo, lon = eval_expr_np(node[2], cols, nulls)
        hi, hin = eval_expr_np(node[3], cols, nulls)
        return (x >= lo) & (x <= hi), _or(_or(xn, lon), hin)
    if kind == "in":
        x, xn = eval_expr_np(node[1], cols, nulls)
        acc = np.zeros(np.shape(x), bool)
        for v in node[2]:
            acc |= (x == v)
        return acc, xn
    if kind == "isnull":
        _, xn = eval_expr_np(node[1], cols, nulls)
        return (xn if xn is not None else np.zeros(1, bool)), None
    raise ValueError(kind)


def _or(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def cpu_scan_aggregate(blocks: Sequence[ColumnarBlock],
                       columns: Sequence[int],
                       where: Optional[tuple] = None,
                       aggs: Sequence[AggSpec] = (),
                       group: Optional[GroupSpec] = None,
                       read_ht: Optional[int] = None):
    """Numpy twin of ``ops.scan.scan_aggregate`` over raw columnar blocks
    (unique-key sources only, the baseline scenario).  Returns
    ``(agg values, count)``, or per-group arrays and counts for a
    GroupSpec."""
    aggs = tuple(_expand_avg(aggs))
    cols: Dict[int, np.ndarray] = {}
    nulls: Dict[int, np.ndarray] = {}
    for cid in columns:
        parts, nparts = [], []
        for b in blocks:
            if cid in b.fixed:
                v, m = b.fixed[cid]
                parts.append(v)
                nparts.append(m)
            else:
                parts.append(b.pk[cid])
                nparts.append(np.zeros(b.n, bool))
        cols[cid] = np.concatenate(parts)
        nulls[cid] = np.concatenate(nparts)
    mask = np.ones(len(next(iter(cols.values()))), bool)
    if read_ht is not None:
        ht = np.concatenate([b.ht for b in blocks])
        tomb = np.concatenate([b.tombstone for b in blocks])
        mask &= (ht <= read_ht) & ~tomb
    if where is not None:
        wv, wn = eval_expr_np(where, cols, nulls)
        mask &= wv
        if wn is not None:
            mask &= ~wn
    outs = []
    if group is None:
        for a in aggs:
            if a.expr is None:
                outs.append(np.int64(mask.sum()))
                continue
            v, vn = eval_expr_np(a.expr, cols, nulls)
            m = mask if vn is None else mask & ~vn
            if a.op == "count":
                outs.append(np.int64(m.sum()))
            elif a.op == "sum":
                outs.append(np.where(m, v, 0).sum())
            elif a.op == "min":
                outs.append(v[m].min() if m.any() else np.inf)
            elif a.op == "max":
                outs.append(v[m].max() if m.any() else -np.inf)
        return tuple(outs), np.int64(mask.sum())
    gid = None
    stride = 1
    for cid, domain, offset in group.cols:
        gn = nulls.get(cid)
        if gn is not None:
            mask &= ~gn
        c = np.clip(cols[cid].astype(np.int64) - offset, 0, domain - 1)
        gid = c * stride if gid is None else gid + c * stride
        stride *= domain
    G = group.num_groups
    for a in aggs:
        if a.expr is None:
            outs.append(np.bincount(gid, weights=mask, minlength=G
                                    ).astype(np.int64))
            continue
        v, vn = eval_expr_np(a.expr, cols, nulls)
        m = mask if vn is None else mask & ~vn
        if a.op == "count":
            outs.append(np.bincount(gid, weights=m, minlength=G
                                    ).astype(np.int64))
        elif a.op == "sum":
            outs.append(np.bincount(gid, weights=np.where(m, v, 0),
                                    minlength=G))
        elif a.op in ("min", "max"):
            arr = np.full(G, np.inf if a.op == "min" else -np.inf)
            red = np.minimum if a.op == "min" else np.maximum
            red.at(arr, gid[m], v[m])
            outs.append(arr)
    counts = np.bincount(gid, weights=mask, minlength=G).astype(np.int64)
    return tuple(outs), counts
