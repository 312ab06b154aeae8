"""The scan/filter/aggregate kernel — the hot path, in torch.

Counterpart of ``yugabyte_db_tpu/ops/scan.py``.  ``ScanKernel.run``
keeps the reference's signature key, compile accounting, return shapes
and typed hand-route gate; two routes serve it:

- the EXACT route (default): plain torch standing in for the
  reference's jitted XLA program ``_build_kernel``.  WHERE predicates
  compile through ops/expr.py; SUM/COUNT accumulate exactly in int64
  (float values quantize to int64 fixed point at a static scale 2^k
  from host column bounds, or a dynamic per-batch scale with a float
  fallback lane); MIN/MAX carry the value dtype.  It equals the
  reference bit for bit on the same batch under the same device dtype.
- the HAND route (flag ``hand_scan_enabled``): the generic hand kernel
  K3 of ops/hand_scan.py — f32 compute, per-block partials combined on
  the host.  Ineligible shapes are refused BY TYPE
  (HandScanIneligible), tallied in ``hand_scan_refusals`` and served by
  the exact route.  A build or launch failure raises: no fallback.

MVCC modes ``none`` and ``visible`` are ported; ``dedup``,
``HashGroupSpec`` and dictionary grouping raise NotPortedError naming
their ROADMAP.md item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .device_batch import DeviceBatch, flipped_i64_scalar
from .expr import (collect_constants, compile_expr, const_count,
                   expr_bound, expr_signature, referenced_columns)
from .hand_scan import GenericScan, HandScanIneligible

_U64_MAX = 0xFFFFFFFFFFFFFFFF


class NotPortedError(NotImplementedError):
    """A shape the port does not run yet; the message names the
    ROADMAP.md item that will port it."""

    def __init__(self, what: str, roadmap_item: str):
        super().__init__(f"{what} is not ported yet (ROADMAP.md: "
                         f"{roadmap_item})")
        self.roadmap_item = roadmap_item


_DEDUP_ITEM = "queue 1, dedup mode and hash group"
_DICT_ITEM = "queue 1, grouped_scan"


@dataclass(frozen=True)
class AggSpec:
    """One aggregate target: op in sum|count|min|max|avg; expr None means
    COUNT(*)."""
    op: str
    expr: Optional[tuple] = None

    def signature(self) -> tuple:
        return (self.op, expr_signature(self.expr) if self.expr else None)


@dataclass(frozen=True)
class GroupSpec:
    """GROUP BY over small-domain columns: cols = ((col_id, domain_size,
    offset), ...).  Group id = sum((col - offset) * stride)."""
    cols: Tuple[Tuple[int, int, int], ...]

    @property
    def num_groups(self) -> int:
        g = 1
        for _, d, _ in self.cols:
            g *= d
        return g


@dataclass(frozen=True)
class HashGroupSpec:
    """GROUP BY over arbitrary-domain columns (device sort + segment
    aggregation in the reference) — declared so callers can name it;
    ScanKernel.run raises NotPortedError for it."""
    cols: Tuple[int, ...]
    max_groups: int = 4096


# sums over <= this many groups MAY unroll into per-group masked
# reductions; larger group counts always use a scatter-add
_UNROLL_G = 16

# scale sentinel meaning "integer-exact result, do not rescale"
_NOSCALE = np.float32(0.0)


def _group_strategy(device: torch.device) -> str:
    """Reduction strategy for small-G grouped aggregates: scatter-add on
    the CPU, unrolled masked reductions on CUDA (the flag overrides)."""
    from ..utils import flags as _flags
    s = _flags.get("scan_group_strategy")
    if s == "auto":
        return "segment" if device.type == "cpu" else "unroll"
    return s


def _scale_for(bound: float, n_total: int):
    """Static fixed-point scale 2^k for a float SUM whose per-row values
    are bounded by `bound`: k = floor(61 - log2 n - log2 bound) makes
    n_total rows of |v|<=bound sum to < 2^61 in int64.  Returns an f32
    scale, or None when the magnitude regime can't quantize."""
    if not np.isfinite(bound):
        return None
    if bound <= 0.0:
        return np.float32(1.0)      # all values are exactly 0
    k = np.floor(61.0 - np.log2(max(n_total, 1)) - np.log2(bound))
    if k < -120.0 or k > 120.0:     # out of f32-exp / int64 range
        return None
    return np.float32(2.0 ** k)


def _is_exact_int(v: torch.Tensor) -> bool:
    return v.dtype == torch.bool or not (v.dtype.is_floating_point
                                         or v.dtype.is_complex)


def _sum_prep_static(v, m, scale):
    """Static-scale SUM prep: (q int64 [0 outside the mask], scale)."""
    if _is_exact_int(v):
        return torch.where(m, v.to(torch.int64), 0), _NOSCALE
    vm = torch.where(m, v, 0)
    s = torch.tensor(float(scale), dtype=vm.dtype, device=vm.device)
    q = torch.round(vm * s).to(torch.int64)
    return q, scale


def _sum_prep(v, m, n_total: int):
    """Dynamic-scale SUM prep -> (q int64 [0 outside mask], scale, vm).

    Integer/bool values pass through exactly (scale sentinel 0.0).
    Float values quantize at a per-batch scale s = 2^k, k = floor(62 -
    log2(n_total) - log2(max|v|)).  Degenerate inputs (non-finite, or
    magnitudes outside the dtype's exp2 range) give scale NaN and q 0;
    the masked values `vm` then feed a plain float fallback sum."""
    if _is_exact_int(v):
        return torch.where(m, v.to(torch.int64), 0), _NOSCALE, None
    dt = v.dtype
    vm = torch.where(m, v, 0)
    vmax = torch.max(torch.abs(vm))
    safe = torch.maximum(vmax, torch.tensor(1e-30, dtype=dt,
                                            device=vm.device))
    k = torch.floor((62.0 - float(np.log2(max(n_total, 1))))
                    - torch.log2(safe))
    lo, hi = (-120.0, 120.0) if dt == torch.float32 else (-1000.0, 1000.0)
    kc = torch.clamp(k, lo, hi)
    ok = torch.isfinite(vmax) & (k == kc)
    s = torch.exp2(kc).to(dt)
    q = torch.where(ok, torch.round(vm * s).to(torch.int64), 0)
    s = torch.where(ok, s, torch.tensor(float("nan"), dtype=dt,
                                        device=vm.device))
    return q, s, vm


def _grouped_sum(q, gid, G: int, strategy: str = "unroll"):
    """Per-group sums in q's dtype; q must already be 0 outside the row
    mask."""
    if strategy == "unroll" and G <= _UNROLL_G:
        zero = torch.zeros((), dtype=q.dtype, device=q.device)
        return torch.stack([torch.where(gid == g, q, zero).sum()
                            for g in range(G)])
    out = torch.zeros(G, dtype=q.dtype, device=q.device)
    return out.index_add_(0, gid.to(torch.int64), q)


def _type_max(v):
    if v.dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(v.dtype).max


def _type_min(v):
    if v.dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(v.dtype).min


def _fill_where(m, v, fill):
    return torch.where(m, v, torch.tensor(fill, dtype=v.dtype,
                                          device=v.device))


def _grouped_extreme(v, m, gid, G: int, is_min: bool,
                     strategy: str = "unroll"):
    sentinel = _type_max(v) if is_min else _type_min(v)
    masked = _fill_where(m, v.expand(m.shape), sentinel)
    if strategy == "unroll" and G <= _UNROLL_G:
        red = torch.amin if is_min else torch.amax
        return torch.stack([red(_fill_where(gid == g, masked, sentinel))
                            for g in range(G)])
    out = torch.full((G,), sentinel, dtype=v.dtype, device=v.device)
    return out.scatter_reduce_(0, gid.to(torch.int64), masked,
                               "amin" if is_min else "amax",
                               include_self=True)


def visibility_mask(mvcc_mode: str, valid, key_hash, ht, write_id,
                    tombstone, read_ht):
    """The MVCC row mask.  mvcc_mode: 'none' (valid only), 'visible' (ht
    filter, unique keys).  ht and read_ht are in the flipped int64
    encoding of device_batch (unsigned order under signed compares)."""
    if mvcc_mode == "none":
        return valid
    if mvcc_mode == "visible":
        return valid & (ht <= read_ht) & torch.logical_not(tombstone)
    raise NotPortedError(f"MVCC mode {mvcc_mode!r}", _DEDUP_ITEM)


def masked_aggregate(group, agg_fns, prep, cols, nulls, consts, mask,
                     sum_scales, n_total: int, strategy: str):
    """Aggregate the masked rows, ungrouped or over a dense GroupSpec.
    Returns (outs, scales, counts, mask), the reference's contract."""
    if group is None:
        out, scales = [], []
        for i, (op, f) in enumerate(agg_fns):
            if f is None:
                out.append(mask.sum(dtype=torch.int64))
                scales.append(_NOSCALE)
                continue
            v, vn = f(cols, nulls, consts)
            m = mask if vn is None else mask & torch.logical_not(vn)
            if op == "count":
                out.append(m.sum(dtype=torch.int64))
                scales.append(_NOSCALE)
            elif op == "sum":
                q, s, vm = prep(i, v, m, n_total, sum_scales)
                out.append(q.sum())
                scales.append(s if vm is None else (s, vm.sum()))
            elif op == "min":
                out.append(torch.amin(_fill_where(m, v.expand(m.shape),
                                                  _type_max(v))))
                scales.append(_NOSCALE)
            elif op == "max":
                out.append(torch.amax(_fill_where(m, v.expand(m.shape),
                                                  _type_min(v))))
                scales.append(_NOSCALE)
            else:
                raise ValueError(op)
        return (tuple(out), tuple(scales), mask.sum(dtype=torch.int64),
                mask)

    # grouped over declared domains: dense group id + exact int64
    # per-group reductions.  Rows with NULL in any group column are
    # excluded (the device group-id encoding has no NULL slot).
    gid = None
    stride = 1
    for cid, domain, offset in group.cols:
        gn = nulls.get(cid)
        if gn is not None:
            mask = mask & torch.logical_not(gn)
        c = cols[cid].to(torch.int32) - offset
        c = torch.clamp(c, 0, domain - 1)
        gid = c * stride if gid is None else gid + c * stride
        stride *= domain
    G = group.num_groups
    out, scales = [], []
    for i, (op, f) in enumerate(agg_fns):
        if f is None:
            out.append(_grouped_sum(mask.to(torch.int64), gid, G, strategy))
            scales.append(_NOSCALE)
            continue
        v, vn = f(cols, nulls, consts)
        m = mask if vn is None else mask & torch.logical_not(vn)
        if op == "count":
            out.append(_grouped_sum(m.to(torch.int64), gid, G, strategy))
            scales.append(_NOSCALE)
        elif op == "sum":
            q, s, vm = prep(i, v, m, n_total, sum_scales)
            out.append(_grouped_sum(q, gid, G, strategy))
            scales.append(s if vm is None
                          else (s, _grouped_sum(vm, gid, G, strategy)))
        elif op == "min":
            out.append(_grouped_extreme(v, m, gid, G, True, strategy))
            scales.append(_NOSCALE)
        elif op == "max":
            out.append(_grouped_extreme(v, m, gid, G, False, strategy))
            scales.append(_NOSCALE)
        else:
            raise ValueError(op)
    counts = _grouped_sum(mask.to(torch.int64), gid, G, strategy)
    return tuple(out), tuple(scales), counts, mask


def _build_kernel(where_node, agg_specs: Tuple[AggSpec, ...],
                  group: Optional[GroupSpec], mvcc_mode: str,
                  static_sums: Tuple[bool, ...] = (),
                  strategy: str = "unroll"):
    """The exact route's program for one signature (the reference's
    ``_build_kernel``).  Returns fn(...) -> (agg_outs, agg_scales,
    counts, mask); each float SUM out is an exact int64 accumulation to
    divide by its scale host-side (scale 0.0 = integer-exact)."""
    # WHERE constants first, then each aggregate's, in AggSpec order —
    # every compile lands at its cumulative offset so slots never collide
    off = const_count(where_node) if where_node is not None else 0
    where_fn = compile_expr(where_node) if where_node is not None else None
    agg_fns = []
    for a in agg_specs:
        if a.expr is None:
            agg_fns.append((a.op, None))
        else:
            agg_fns.append((a.op, compile_expr(a.expr, offset=off)))
            off += const_count(a.expr)
    static_sums = static_sums or (False,) * len(agg_fns)

    def _prep(i, v, m, n_total, sum_scales):
        if static_sums[i]:
            q, s = _sum_prep_static(v, m, sum_scales[i])
            return q, s, None
        return _sum_prep(v, m, n_total)

    def fn(cols, nulls, consts, valid, key_hash, ht, write_id, tombstone,
           read_ht, sum_scales):
        mask = visibility_mask(mvcc_mode, valid, key_hash, ht, write_id,
                               tombstone, read_ht)
        if where_fn is not None:
            wv, wn = where_fn(cols, nulls, consts)
            mask = mask & wv
            if wn is not None:
                mask = mask & torch.logical_not(wn)
        return masked_aggregate(group, agg_fns, _prep, cols, nulls, consts,
                                mask, sum_scales, mask.shape[0], strategy)

    return fn


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _rescale_outs(raw_outs, raw_scales):
    """Host-side: divide int64 fixed-point sums by their scale (f64).
    Scale entries: the 0.0 sentinel (integer-exact, stays int64); a bare
    nonzero scale (static: divide); or a (scale, float_fallback) pair
    from the dynamic path — NaN scale means quantization was impossible
    and the plain float sum is the answer."""
    final = []
    for q, s in zip(raw_outs, raw_scales):
        if isinstance(s, tuple):
            sv = float(_np(s[0]))
            fb32 = _np(s[1])
            fb = np.asarray(fb32, np.float64)
            if np.isnan(sv):
                final.append(fb)
                continue
            qv = _np(q)
            r = qv.astype(np.float64) / sv
            # per-(group) lane choice by worst-case error bound: the
            # quantized lane wins iff |q| >= 0.5/eps granules
            eps = 2.0 ** -24 if fb32.dtype == np.float32 else 2.0 ** -53
            use_q = np.abs(qv) >= 0.5 / eps
            final.append(np.where(use_q, r, fb) if r.ndim
                         else (r if use_q else fb))
        else:
            sv = float(_np(s))
            if sv == 0.0:
                final.append(_np(q))       # integer-exact
            else:
                final.append(_np(q).astype(np.float64) / sv)
    return tuple(final)


_HAND_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int16,
                torch.int8, torch.bool)


class ScanKernel:
    """Signature-keyed cache of scan programs for one device."""

    def __init__(self, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self._cache: Dict[tuple, object] = {}
        self.compiles = 0
        #: typed-refusal tally: HandScanIneligible reason -> count (why
        #: the hand route declined)
        self.hand_scan_refusals: Dict[str, int] = {}

    def _get(self, sig, where_node, aggs, group, mvcc_mode, static_sums,
             strategy):
        fn = self._cache.get(sig)
        if fn is None:
            fn = _build_kernel(where_node, aggs, group, mvcc_mode,
                               static_sums=static_sums, strategy=strategy)
            self._cache[sig] = fn
            self.compiles += 1
        return fn

    def _hand_eligible(self, batch, where, aggs, group, mvcc_mode, consts):
        """Typed eligibility gate for the hand route: returns the
        referenced-column set, or raises HandScanIneligible with the
        refusal reason (the reference's `_pallas_eligible`)."""
        if mvcc_mode != "none" or not aggs:
            raise HandScanIneligible("mvcc_or_no_aggs")
        if group is not None and (not isinstance(group, GroupSpec)
                                  or group.num_groups > 64):
            raise HandScanIneligible("group_shape")
        if any(a.op not in ("sum", "count", "min", "max") for a in aggs):
            raise HandScanIneligible("agg_op")
        if batch.padded_rows % 4096 != 0:
            raise HandScanIneligible("bucket_rows")
        needed = set(referenced_columns(where)) if where is not None \
            else set()
        for a in aggs:
            if a.expr is not None:
                # dict-code MIN/MAX: f32 would round code indices
                if any(cid in batch.dicts
                       for cid in referenced_columns(a.expr)):
                    raise HandScanIneligible("dict_code_agg")
                needed |= set(referenced_columns(a.expr))
        if group is not None:
            needed |= {cid for cid, _, _ in group.cols}
        for cid in needed:
            col = batch.cols.get(cid)
            if col is None or col.dtype not in _HAND_DTYPES:
                raise HandScanIneligible("column_dtype")
            if col.dtype == torch.int32:
                rng = batch.col_bounds.get(cid) or \
                    batch.int32_ranges.get(cid)
                if rng is None:
                    # a device reduction and a host sync: once per batch
                    rng = batch.int32_ranges[cid] = (int(col.min()),
                                                     int(col.max()))
                if max(abs(rng[0]), abs(rng[1])) >= 2 ** 24:
                    raise HandScanIneligible("int32_range")
        for c in consts:
            if np.ndim(c) != 0:
                raise HandScanIneligible("const_shape")
            if abs(float(c)) >= 2 ** 24:
                raise HandScanIneligible("const_range")
        return needed

    def _hand_plan(self, sig, batch, where, aggs, group, mvcc_mode,
                   consts):
        """(K3 entry, its call arguments) for an eligible query; raises
        HandScanIneligible with the refusal reason otherwise."""
        needed = self._hand_eligible(batch, where, aggs, group, mvcc_mode,
                                     consts)
        key = ("hand", sig)
        entry = self._cache.get(key)
        col_order = tuple(sorted(needed))
        null_order = tuple(cid for cid in col_order if cid in batch.nulls)
        if entry is None:
            entry = GenericScan(
                where, [(a.op, a.expr) for a in aggs],
                group.cols if group is not None else None,
                group.num_groups if group is not None else None,
                col_order, null_order, len(consts))
            self._cache[key] = entry
            self.compiles += 1
        f32 = torch.float32
        carr = torch.tensor([float(c) for c in consts] or [0.0], dtype=f32,
                            device=batch.device)
        col_arrs = [batch.cols[cid].to(f32) for cid in col_order]
        null_arrs = [batch.nulls[cid].to(f32) for cid in null_order]
        return entry, (carr, col_arrs, null_arrs, batch.valid.to(f32))

    def hand_scan_plan(self, batch: DeviceBatch, where=None, aggs=(),
                       group=None):
        """The K3 entry and arguments ``run`` would launch for this query
        with ``hand_scan_enabled`` on (read_ht None) — for checking the
        kernel against its plain version on the very same lanes."""
        p = self._prepare(batch, where, aggs, group, None)
        return self._hand_plan(p["sig"], batch, where, p["aggs"], group,
                               "none", p["consts"])

    def _try_hand(self, sig, batch, where, aggs, group, mvcc_mode, consts):
        """Route eligible aggregate scans through K3.  Returns the
        exact-route-shaped result, or None on a typed HandScanIneligible
        refusal (tallied in ``hand_scan_refusals``; the caller serves
        the exact route).  Any other failure propagates."""
        try:
            entry, args = self._hand_plan(sig, batch, where, aggs, group,
                                          mvcc_mode, consts)
        except HandScanIneligible as e:
            r = str(e)
            self.hand_scan_refusals[r] = self.hand_scan_refusals.get(r, 0) + 1
            return None
        outs = entry(*args)
        agg_parts, cnt_parts = outs[:-1], outs[-1]
        results = []
        for a, p in zip(aggs, agg_parts):
            p = np.asarray(_np(p), np.float64)
            if a.op == "count":
                # per-block partials are exact ints (block <= 4096 rows);
                # summing them in int64 on the host keeps totals exact
                results.append(p.sum(axis=0).astype(np.int64))
            elif a.op == "sum":
                # f64 combine of per-block f32 partials: the residual is
                # the block-local f32 accumulation (the flag's contract)
                results.append(p.sum(axis=0))
            elif a.op == "min":
                results.append(p.min(axis=0).astype(np.float32))
            else:
                results.append(p.max(axis=0).astype(np.float32))
        counts = np.asarray(_np(cnt_parts), np.float64).sum(axis=0).astype(
            np.int64)
        return tuple(results), counts, None

    def _prepare(self, batch, where, aggs, group, read_ht) -> dict:
        """Route-independent query preparation: AVG expansion, MVCC
        mode, the flat consts list, static SUM scales and the
        signature key."""
        if batch.device != self.device:
            raise ValueError(f"batch on {batch.device}, kernel for "
                             f"{self.device}")
        if group is not None and not isinstance(group, GroupSpec):
            item = _DEDUP_ITEM if isinstance(group, HashGroupSpec) \
                else _DICT_ITEM
            raise NotPortedError(type(group).__name__, item)
        aggs = tuple(_expand_avg(aggs))
        if read_ht is None:
            mvcc_mode = "none"
        elif batch.unique_keys:
            mvcc_mode = "visible"
        else:
            raise NotPortedError("MVCC mode 'dedup' (batch with "
                                 "non-unique keys at a read point)",
                                 _DEDUP_ITEM)
        consts: List = []
        if where is not None:
            collect_constants(where, consts)
        for a in aggs:
            if a.expr is not None:
                collect_constants(a.expr, consts)
        col_sig = tuple(sorted(
            (cid, str(v.dtype)) for cid, v in batch.cols.items()))
        static_sums, scale_args = _static_scales(
            aggs, batch.col_bounds, batch.padded_rows, batch.cols,
            batch.device)
        strategy = _group_strategy(batch.device)
        sig = (
            expr_signature(where) if where is not None else None,
            tuple(a.signature() for a in aggs),
            ("GroupSpec", group.cols, None) if group else None,
            mvcc_mode, batch.padded_rows, col_sig, static_sums, strategy,
        )
        return dict(aggs=aggs, mvcc_mode=mvcc_mode, consts=consts,
                    static_sums=static_sums, scale_args=scale_args,
                    strategy=strategy, sig=sig)

    def run(self, batch: DeviceBatch,
            where: Optional[tuple] = None,
            aggs: Sequence[AggSpec] = (),
            group: Optional[GroupSpec] = None,
            read_ht: Optional[int] = None):
        """Returns (agg_results tuple, count_or_group_counts, mask) —
        mask is None when the hand route served the query."""
        p = self._prepare(batch, where, aggs, group, read_ht)
        from ..utils import flags as _flags
        if _flags.get("hand_scan_enabled"):
            got = self._try_hand(p["sig"], batch, where, p["aggs"], group,
                                 p["mvcc_mode"], p["consts"])
            if got is not None:
                return got
        fn = self._get(p["sig"], where, p["aggs"], group, p["mvcc_mode"],
                       p["static_sums"], p["strategy"])
        n = batch.padded_rows
        dev = batch.device
        zeros_i64 = torch.zeros(n, dtype=torch.int64, device=dev)
        raw = fn(
            batch.cols, batch.nulls, list(p["consts"]), batch.valid,
            batch.key_hash if batch.key_hash is not None else zeros_i64,
            batch.ht if batch.ht is not None else zeros_i64,
            batch.write_id if batch.write_id is not None else zeros_i64,
            batch.tombstone if batch.tombstone is not None
            else torch.zeros(n, dtype=torch.bool, device=dev),
            torch.tensor(flipped_i64_scalar(
                read_ht if read_ht is not None else _U64_MAX),
                dtype=torch.int64, device=dev),
            p["scale_args"],
        )
        # (outs, scales, counts, mask) -> rescale the fixed-point sums
        # host-side; callers keep the shape (outs, counts, mask)
        return (_rescale_outs(raw[0], raw[1]),) + tuple(raw[2:])


def _static_scales(aggs: Sequence[AggSpec],
                   col_bounds: Dict[int, Tuple[float, float]],
                   n_total: int, cols, device: torch.device):
    """Per-agg static fixed-point scales from host column stats.
    Returns (static_flags, scales).  Expressions that the device may
    evaluate in f32 — any f32 column, or any non-CPU device (the port's
    CUDA policy ships fractional columns as f32) — cap every
    intermediate interval at the f32 finite range."""
    flags_, scales = [], []
    for a in aggs:
        s = None
        if a.op == "sum" and a.expr is not None and col_bounds:
            mag = 1.0e306
            if device.type != "cpu" or (
                    cols is not None and any(
                        getattr(cols.get(c), "dtype", None) == torch.float32
                        for c in referenced_columns(a.expr))):
                mag = 3.0e38
            b = expr_bound(a.expr, col_bounds, mag_limit=mag)
            if b is not None:
                s = _scale_for(max(abs(b[0]), abs(b[1])), n_total)
        flags_.append(s is not None)
        scales.append(np.float32(s if s is not None else 0.0))
    return tuple(flags_), tuple(scales)


def _expand_avg(aggs: Sequence[AggSpec]) -> List[AggSpec]:
    """AVG(e) -> SUM(e), COUNT(e); recombined by the caller."""
    out = []
    for a in aggs:
        if a.op == "avg":
            out.append(AggSpec("sum", a.expr))
            out.append(AggSpec("count", a.expr))
        else:
            out.append(a)
    return out
