"""Device grouped aggregation over dictionary-encoded group keys.

Counterpart of ``yugabyte_db_tpu/ops/grouped_scan.py``.  TPC-H Q1 as the
spec types it groups by two STRING columns.  String columns ride on the
device as int32 dictionary CODES (ops/device_batch.py); this module
groups over them:

- :class:`DictGroupSpec` — GROUP BY over dictionary-coded columns.  The
  group id is a dense stride encoding of the scan-global codes; strides
  come from the dictionary sizes at run time, so dictionary growth
  inside one pow2 slot bucket keeps the kernel signature.
- :func:`grouped_reduce` — the segment sum/min/max ScanKernel runs for
  a resolved DictGroupSpec: one pass into a pow2 slot bucket with one
  reserved SPILL slot for rows whose id exceeds the budget; the spill
  count comes back for the host to act on (nonzero: discard).
- :func:`make_dict_plan` — per-block dictionaries merged into ONE
  scan-global dictionary per column (storage/lane_codec.merge_dicts),
  each block's codes remapped through an int32 table; row strings are
  never decoded.  The same plan turns string predicates into code
  compares (docdb/operations.py rewrite_where_and_aggs).
- :func:`grouped_aggregate_cpu` — the numpy twin of the dict-grouped
  scan, in dense slot form.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..storage import lane_codec
from ..storage.columnar import ColumnarBlock

#: stage split of the most recent streamed dict-grouped scan
#: (informational; written by ops/stream_scan.py)
LAST_GROUPED_STATS: dict = {}

#: dict-grouped scans run by ScanKernel.run; slot overflows that fell
#: to the interpreted GROUP BY (``spill_fallbacks``) and those the
#: partial-spill merge served (``spill_merges``) (process-wide)
GROUPED_STATS = {"launches": 0, "spill_fallbacks": 0, "spill_merges": 0}

#: slot budgets are powers of two in this band
_MIN_SLOTS = 4
_MAX_SLOTS_HARD = 1 << 20


@dataclass(frozen=True)
class DictGroupSpec:
    """GROUP BY over dictionary-encoded (string) columns.  ``cols``:
    column ids, each served as dictionary codes (DeviceBatch.dicts
    carries the scan-global dictionaries).  ``max_slots``: the slot
    budget (rounded up to a power of two, one slot reserved for spill);
    the result is exact when the spill count is zero."""
    cols: Tuple[int, ...]
    max_slots: int = 4096


@dataclass(frozen=True)
class ResolvedDictGroup:
    """Kernel-facing resolution of a DictGroupSpec: the pow2 slot count
    is part of the signature; the dictionary sizes are run-time values."""
    cols: Tuple[int, ...]
    num_slots: int


def slot_bucket(needed: int, max_slots: int) -> int:
    """Smallest pow2 slot count >= needed (incl. the spill slot),
    clamped to [_MIN_SLOTS, pow2(max_slots)]."""
    cap = _MIN_SLOTS
    limit = min(max(int(max_slots), _MIN_SLOTS), _MAX_SLOTS_HARD)
    while cap < limit:
        cap <<= 1
    s = _MIN_SLOTS
    while s < needed and s < cap:
        s <<= 1
    return s


def resolve_group(spec: DictGroupSpec, dicts: Dict[int, np.ndarray]
                  ) -> Tuple[ResolvedDictGroup, Tuple[int, ...]]:
    """(ResolvedDictGroup, domains) for a scan whose scan-global
    dictionaries are `dicts`.  KeyError when a group column has no
    dictionary."""
    domains = tuple(max(len(dicts[c]), 1) for c in spec.cols)
    prod = 1
    for d in domains:
        prod *= d
    return (ResolvedDictGroup(spec.cols,
                              slot_bucket(prod + 1, spec.max_slots)),
            domains)


def domain_product(spec: DictGroupSpec,
                   dicts: Dict[int, np.ndarray]) -> int:
    prod = 1
    for c in spec.cols:
        prod *= max(len(dicts[c]), 1)
    return prod


# ---------------------------------------------------------------------------
# The device reduction (called from ops/scan.py masked_aggregate)
# ---------------------------------------------------------------------------

def grouped_reduce(group: ResolvedDictGroup, agg_fns, prep, cols, nulls,
                   consts, mask, domains, sum_scales, strategy: str):
    """Segment sum/min/max over the dense dictionary-code group id
    ``sum(code_i * stride_i)``, strides the products of the preceding
    dictionary sizes (``domains``).  Rows whose id lands at or past the
    reserved spill slot scatter into it.  Returns (outs, scales, counts,
    mask, spilled), the GroupSpec path's shape plus the spill count."""
    from .scan import (_NOSCALE, _grouped_extreme, _grouped_sum)
    for cid in group.cols:
        gn = nulls.get(cid)
        if gn is not None:
            # NULL group values are excluded (same rule as GroupSpec)
            mask = mask & torch.logical_not(gn)
    gid = None
    stride = 1
    for cid, dom in zip(group.cols, domains):
        c = cols[cid].to(torch.int64)
        gid = c * stride if gid is None else gid + c * stride
        stride *= int(dom)
    S = group.num_slots
    spill_slot = S - 1
    in_range = gid < spill_slot
    spilled = (mask & torch.logical_not(in_range)).sum(dtype=torch.int64)
    gid_c = torch.where(mask & in_range, gid,
                        torch.full_like(gid, spill_slot)).to(torch.int32)
    n_total = mask.shape[0]
    out, scales = [], []
    for i, (op, f) in enumerate(agg_fns):
        if f is None:
            out.append(_grouped_sum(mask.to(torch.int64), gid_c, S,
                                    strategy))
            scales.append(_NOSCALE)
            continue
        v, vn = f(cols, nulls, consts)
        m = mask if vn is None else mask & torch.logical_not(vn)
        if op == "count":
            out.append(_grouped_sum(m.to(torch.int64), gid_c, S, strategy))
            scales.append(_NOSCALE)
        elif op == "sum":
            q, s, vm = prep(i, v, m, n_total, sum_scales)
            out.append(_grouped_sum(q, gid_c, S, strategy))
            scales.append(s if vm is None
                          else (s, _grouped_sum(vm, gid_c, S, strategy)))
        elif op == "min":
            out.append(_grouped_extreme(v, m, gid_c, S, True, strategy))
            scales.append(_NOSCALE)
        elif op == "max":
            out.append(_grouped_extreme(v, m, gid_c, S, False, strategy))
            scales.append(_NOSCALE)
        else:
            raise ValueError(op)
    counts = _grouped_sum(mask.to(torch.int64), gid_c, S, strategy)
    return tuple(out), tuple(scales), counts, mask, spilled


# ---------------------------------------------------------------------------
# Scan-global dictionary plan (the per-chunk dictionary merge)
# ---------------------------------------------------------------------------

@dataclass
class DictPlan:
    """Scan-global dictionaries + per-block remapped codes for a fixed
    block list.  ``identity`` is the content identity a device-cache key
    embeds, so two scans that merged different dictionaries never share
    a cached batch of codes."""
    dicts: Dict[int, np.ndarray]                 # cid -> sorted uniq (str)
    codes: Dict[int, Dict[int, np.ndarray]]      # cid -> {id(block): int32}
    identity: tuple = ()
    merge_s: float = 0.0

    def block_codes(self, cid: int, block) -> np.ndarray:
        return self.codes[cid][id(block)]


def make_dict_plan(blocks: Sequence[ColumnarBlock], cids: Sequence[int],
                   max_card: int = 1 << 16) -> Optional[DictPlan]:
    """Merge per-block dictionaries for `cids` into scan-global ones and
    remap every block's local codes.  None when any (block, column)
    can't dictionary-encode."""
    t0 = time.perf_counter()
    dicts: Dict[int, np.ndarray] = {}
    codes: Dict[int, Dict[int, np.ndarray]] = {}
    ident = []
    for cid in sorted(cids):
        per_block = []
        for b in blocks:
            got = b.dict_varlen(cid, max_card=max_card)
            if got is None:
                return None
            per_block.append(got)
        global_uniq, remaps = lane_codec.merge_dicts(
            [u for u, _ in per_block])
        if len(global_uniq) > max_card:
            return None
        dicts[cid] = global_uniq
        codes[cid] = {
            id(b): (remap[local] if len(remap) else
                    np.zeros(b.n, np.int32))
            for b, (_, local), remap in zip(blocks, per_block, remaps)}
        ident.append((cid,) + lane_codec.dict_identity(global_uniq))
    return DictPlan(dicts=dicts, codes=codes, identity=tuple(ident),
                    merge_s=time.perf_counter() - t0)


def dict_cols_needed(blocks: Sequence[ColumnarBlock],
                     columns: Sequence[int]) -> Optional[List[int]]:
    """Columns of `columns` that are varlen in every block (they ride as
    dictionary codes), or None when some column is neither fixed/pk nor
    varlen everywhere."""
    out: List[int] = []
    for cid in columns:
        if all(cid in b.fixed or cid in b.pk for b in blocks):
            continue
        if all(cid in b.varlen for b in blocks):
            out.append(cid)
        else:
            return None
    return out


# ---------------------------------------------------------------------------
# Host-side slot decode
# ---------------------------------------------------------------------------

def decode_slot_groups(spec: DictGroupSpec, dicts: Dict[int, np.ndarray],
                       outs: Sequence[np.ndarray], counts
                       ) -> Tuple[tuple, np.ndarray, tuple]:
    """Compact dense slot arrays to the PRESENT groups and decode each
    slot id back to its key strings: (agg_values, counts, group_values)
    in slot order.  The first group column has stride 1, so slot order
    sorts by the LAST column's dictionary order first; group order is
    not part of the contract (consumers key by group values)."""
    counts = np.asarray(counts)
    domains = [max(len(dicts[c]), 1) for c in spec.cols]
    prod = 1
    for d in domains:
        prod *= d
    present = np.nonzero(counts[:min(prod, len(counts))])[0]
    gvals = []
    rem = present.copy()
    for cid, dom in zip(spec.cols, domains):
        code = rem % dom
        rem = rem // dom
        gvals.append(np.asarray(dicts[cid], object)[code])
    outs_c = tuple(np.asarray(o)[present] for o in outs)
    return outs_c, counts[present], tuple(gvals)


# ---------------------------------------------------------------------------
# The numpy twin: a host replay of the kernel's accumulation contract
# ---------------------------------------------------------------------------

def grouped_aggregate_cpu(blocks: Sequence[ColumnarBlock],
                          columns: Sequence[int],
                          where: Optional[tuple],
                          aggs: Sequence,
                          spec: DictGroupSpec,
                          read_ht: Optional[int] = None,
                          plan: Optional[DictPlan] = None,
                          device: DeviceLike = "cuda"):
    """Numpy twin of the dict-grouped scan: the same scan-global
    dictionary plan, dense slot encoding and static int64 fixed-point
    SUM quantization (ops/scan.py's accumulation contract), with the
    f64 conversion policy of a batch on `device`, so on an f64 batch
    the twin equals the kernel bit for bit.  Returns (outs, counts,
    spilled) in dense slot form (decode with decode_slot_groups)."""
    from .cpu_scan import eval_expr_np
    from .device_batch import f64_conversion
    from .expr import expr_bound
    from .scan import _expand_avg, _scale_for
    dev = resolve_device(device)
    aggs = tuple(_expand_avg(aggs))
    dcids = dict_cols_needed(blocks, columns)
    if plan is None:
        if dcids is None:
            raise ValueError("columns lack columnar form")
        plan = make_dict_plan(blocks, set(dcids) | set(spec.cols))
        if plan is None:
            raise ValueError("not dictionary-encodable")
    cols: Dict[int, np.ndarray] = {}
    nulls: Dict[int, np.ndarray] = {}
    bounds: Dict[int, Tuple[float, float]] = {}
    for cid in set(columns) | set(spec.cols):
        if cid in plan.dicts:
            cols[cid] = np.concatenate(
                [plan.block_codes(cid, b) for b in blocks])
            nulls[cid] = np.concatenate(
                [np.asarray(b.varlen[cid][2], bool) for b in blocks])
            continue
        parts, nparts = [], []
        for b in blocks:
            if cid in b.fixed:
                v, m = b.fixed[cid]
                parts.append(v)
                nparts.append(m)
            else:
                parts.append(b.pk[cid])
                nparts.append(np.zeros(b.n, bool))
        arr = np.concatenate(parts)
        # the device batch's f64 conversion, so integer-valued f64
        # columns aggregate exactly, as on the device
        conv = f64_conversion(parts, dev) \
            if arr.dtype == np.float64 else None
        if conv is not None:
            arr = arr.astype(conv)
        cols[cid] = arr
        nulls[cid] = np.concatenate(nparts)
        if arr.dtype.kind in "fiu" and len(arr):
            bounds[cid] = (float(arr.min()), float(arr.max()))
    n = len(next(iter(cols.values())))
    mask = np.ones(n, bool)
    if read_ht is not None:
        ht = np.concatenate([b.ht for b in blocks])
        tomb = np.concatenate([b.tombstone for b in blocks])
        mask &= (ht <= np.uint64(read_ht)) & ~tomb
    if where is not None:
        wv, wn = eval_expr_np(where, cols, nulls)
        mask &= wv
        if wn is not None:
            mask &= ~wn
    resolved, domains = resolve_group(spec, plan.dicts)
    for cid in spec.cols:
        mask &= ~nulls[cid]
    gid = np.zeros(n, np.int64)
    stride = 1
    for cid, dom in zip(spec.cols, domains):
        gid += cols[cid].astype(np.int64) * stride
        stride *= dom
    S = resolved.num_slots
    spill_slot = S - 1
    in_range = gid < spill_slot
    spilled = int(np.sum(mask & ~in_range))
    gid_c = np.where(mask & in_range, gid, spill_slot).astype(np.int64)
    outs = []

    def _exact_count(m):
        return np.bincount(gid_c[m], minlength=S).astype(np.int64)

    def _exact_sum(q):
        qs = np.zeros(S, np.int64)
        np.add.at(qs, gid_c, q)
        return qs

    for a in aggs:
        if a.expr is None:
            outs.append(_exact_count(mask))
            continue
        v, vn = eval_expr_np(a.expr, cols, nulls)
        m = mask if vn is None else mask & ~vn
        if a.op == "count":
            outs.append(_exact_count(m))
        elif a.op == "sum":
            if np.issubdtype(np.asarray(v).dtype, np.integer) or \
                    np.asarray(v).dtype == np.bool_:
                outs.append(_exact_sum(
                    np.where(m, v, 0).astype(np.int64)))
                continue
            b = expr_bound(a.expr, bounds) if bounds else None
            s = (_scale_for(max(abs(b[0]), abs(b[1])), n)
                 if b is not None else None)
            if s is not None:
                # the kernel's static fixed-point lane, replayed
                q = np.rint(np.where(m, v, 0) * np.float64(s)
                            ).astype(np.int64)
                outs.append(_exact_sum(q).astype(np.float64) / float(s))
            else:
                outs.append(np.bincount(gid_c,
                                        weights=np.where(m, v, 0),
                                        minlength=S))
        elif a.op in ("min", "max"):
            sent = (np.inf if a.op == "min" else -np.inf) \
                if np.asarray(v).dtype.kind == "f" else \
                (np.iinfo(np.asarray(v).dtype).max if a.op == "min"
                 else np.iinfo(np.asarray(v).dtype).min)
            arr = np.full(S, sent, np.asarray(v).dtype)
            red = np.minimum if a.op == "min" else np.maximum
            red.at(arr, gid_c[m], np.asarray(v)[m])
            outs.append(arr)
        else:
            raise ValueError(a.op)
    counts = np.bincount(gid_c[mask], minlength=S).astype(np.int64)
    return tuple(outs), counts, spilled
