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
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..storage import lane_codec
from ..storage.columnar import ColumnarBlock

#: stage split of the most recent streamed dict-grouped scan
#: (informational; written by ops/stream_scan.py)
LAST_GROUPED_STATS: dict = {}

#: dict-grouped scans run by ScanKernel.run, and fused joins whose dict
#: group spilled its slot budget (process-wide)
GROUPED_STATS = {"launches": 0, "spill_fallbacks": 0}

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

