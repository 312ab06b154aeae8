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
  Beyond the reference's gate, MVCC mode ``visible`` is served too (its
  row mask enters K3 as the valid lane), so tablet reads run K3.

Below the kernel: the cross-shard combine of per-tablet partials
(``combine_agg_partials``, ``combine_grouped_partials``) and zone-map
block pruning (``zone_maybe_match``, ``zone_prune_blocks``).

MVCC modes: ``none`` (no read point), ``visible`` (unique keys: ht
filter and tombstones) and ``dedup`` (several versions per key: the
newest visible version per key hash, by a stable multi-key sort).
Grouping: dense ``GroupSpec``, ``HashGroupSpec`` (sort + segment
aggregation over arbitrary columns) and ``DictGroupSpec`` (dictionary
codes, ops/grouped_scan.py).  The hand route refuses the last three
shapes by type, as the reference's Pallas gate does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..errors import NotPortedError  # noqa: F401 — re-exported
from .device_batch import DeviceBatch, flipped_i64_scalar
from .expr import (collect_constants, compile_expr, const_count,
                   expr_bound, expr_signature, referenced_columns)
from .grouped_scan import (GROUPED_STATS, DictGroupSpec, ResolvedDictGroup,
                           grouped_reduce, resolve_group)
from .hand_scan import HAND_DTYPES, GenericScan, HandScanIneligible
from .join_scan import BUILD_COL_BASE

_U64_MAX = 0xFFFFFFFFFFFFFFFF
_I64_MAX = 0x7FFFFFFFFFFFFFFF      # U64_MAX in the flipped encoding


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
    """GROUP BY over arbitrary-domain fixed-width columns: a device sort
    by the group-key tuple + segment aggregation, no declared domains.
    `max_groups` caps the per-batch group count; the kernel reports the
    true count, so overflow shows there.  NULL group values are
    excluded, as on GroupSpec's path."""
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
    # a 0-dim CPU tensor: a scalar argument on CUDA, with no copy
    s = torch.tensor(float(scale), dtype=vm.dtype)
    q = torch.round(vm * s).to(torch.int64)
    return q, scale


def _sum_prep(v, m, n_total: int, vmax=None):
    """Dynamic-scale SUM prep -> (q int64 [0 outside mask], scale, vm).

    Integer/bool values pass through exactly (scale sentinel 0.0).
    Float values quantize at a per-batch scale s = 2^k, k = floor(62 -
    log2(n_total) - log2(max|v|)).  Degenerate inputs (non-finite, or
    magnitudes outside the dtype's exp2 range) give scale NaN and q 0;
    the masked values `vm` then feed a plain float fallback sum.
    `vmax`: a precomputed max|v| (a 0-d tensor on v's device) in place
    of this batch's own — the distributed kernel's max over every
    shard, so that all shards quantize at one scale."""
    if _is_exact_int(v):
        return torch.where(m, v.to(torch.int64), 0), _NOSCALE, None
    dt = v.dtype
    vm = torch.where(m, v, 0)
    if vmax is None:
        vmax = torch.max(torch.abs(vm))
    safe = torch.clamp(vmax, min=1e-30)
    k = torch.floor((62.0 - float(np.log2(max(n_total, 1))))
                    - torch.log2(safe))
    lo, hi = (-120.0, 120.0) if dt == torch.float32 else (-1000.0, 1000.0)
    kc = torch.clamp(k, lo, hi)
    ok = torch.isfinite(vmax) & (k == kc)
    s = torch.exp2(kc).to(dt)
    q = torch.where(ok, torch.round(vm * s).to(torch.int64), 0)
    s = s.masked_fill(~ok, float("nan"))
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
    if v.dtype == torch.bool:
        return True
    return torch.iinfo(v.dtype).max


def _type_min(v):
    if v.dtype.is_floating_point:
        return float("-inf")
    if v.dtype == torch.bool:
        return False
    return torch.iinfo(v.dtype).min


def _fill_where(m, v, fill):
    # a Python scalar keeps v's dtype and needs no device copy
    return torch.where(m, v, fill)


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


def _sort_key(t: torch.Tensor) -> torch.Tensor:
    """An integer lane that sorts like `t` under the reference's
    ``lax.sort`` order: floats ordered with -0.0 == 0.0 and every NaN
    equal and last (the bits of the canonical value, negatives folded so
    integer order is float order), bools as uint8, integers as they are.
    Sorting these ints keeps the CPU and CUDA sorts in one order."""
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    if not t.dtype.is_floating_point:
        return t
    if t.element_size() == 2:
        t = t.to(torch.float32)       # exact for f16/bf16
    it, imax =((torch.int32, 0x7FFFFFFF) if t.element_size() == 4
                else (torch.int64, 0x7FFFFFFFFFFFFFFF))
    t = torch.where(t == 0, torch.zeros_like(t), t)
    t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
    bits = t.view(it)
    return torch.where(bits < 0, bits ^ imax, bits)


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting rows by `keys` (most significant first),
    stable: one stable argsort pass per key from the least significant
    to the most, each over the key gathered through the permutation so
    far.  Torch has no multi-key sort, and the 64-bit keys leave no bits
    to pack two into one word."""
    perm = None
    for k in reversed(keys):
        k = _sort_key(k)
        if perm is None:
            perm = torch.argsort(k, stable=True)
        else:
            perm = perm[torch.argsort(k[perm], stable=True)]
    return perm


def _first_of_run(*sorted_keys) -> torch.Tensor:
    """True where a row starts a new run of equal keys (row 0 always).
    NaN never equals NaN, so each NaN row starts its own run, as in the
    reference."""
    changed = None
    for k in sorted_keys:
        c = k[1:] != k[:-1]
        changed = c if changed is None else changed | c
    head = torch.ones(1, dtype=torch.bool, device=sorted_keys[0].device)
    return torch.cat([head, changed])


def _mvcc_visible_latest(key_hash, ht, write_id, tombstone, valid, read_ht):
    """Mask of rows that are the newest visible, non-tombstone version
    of their key at read_ht — the reference's 4-key sort over (key_hash
    with invalid rows at U64_MAX, not-visible, ~ht, ~write_id), first
    row per key, scattered back.  key_hash, ht and read_ht are flipped
    int64 (device_batch), where U64_MAX is INT64_MAX and U64_MAX - x is
    bitwise NOT.  The key is the 64-bit FNV key hash: two doc keys that
    collide share one newest version, as in the reference."""
    n = key_hash.shape[0]
    visible = valid & (ht <= read_ht)
    sort_kh = torch.where(valid, key_hash,
                          torch.full_like(key_hash, _I64_MAX))
    inv_vis = torch.logical_not(visible)
    inv_ht = torch.bitwise_not(ht)
    inv_wid = 0xFFFFFFFF - write_id
    perm = _lexsort((sort_kh, inv_vis, inv_ht, inv_wid))
    first = _first_of_run(sort_kh[perm])
    sel_sorted = first & visible[perm] & torch.logical_not(tombstone[perm])
    out = torch.zeros(n, dtype=torch.bool, device=key_hash.device)
    out[perm] = sel_sorted
    return out


def visibility_mask(mvcc_mode: str, valid, key_hash, ht, write_id,
                    tombstone, read_ht):
    """The MVCC row mask.  mvcc_mode: 'none' (valid only), 'visible' (ht
    filter, unique keys), 'dedup' (newest visible version per key).  ht
    and read_ht are in the flipped int64 encoding of device_batch
    (unsigned order under signed compares)."""
    if mvcc_mode == "none":
        return valid
    if mvcc_mode == "visible":
        return valid & (ht <= read_ht) & torch.logical_not(tombstone)
    return _mvcc_visible_latest(key_hash, ht, write_id, tombstone, valid,
                                read_ht)


def masked_aggregate(group, agg_fns, prep, cols, nulls, consts, mask,
                     domains, sum_scales, n_total: int, strategy: str):
    """Aggregate the masked rows: ungrouped, over a dense GroupSpec, or
    over a ResolvedDictGroup (ops/grouped_scan.grouped_reduce, which
    adds a trailing spill count).  Returns (outs, scales, counts, mask),
    the reference's contract."""
    if isinstance(group, ResolvedDictGroup):
        return grouped_reduce(group, agg_fns, prep, cols, nulls, consts,
                              mask, domains, sum_scales, strategy)
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


def _compile_aggs(where_node, agg_specs: Tuple[AggSpec, ...]):
    """(where_fn or None, [(op, fn or None)]): WHERE constants first,
    then each aggregate's, in AggSpec order — every compile lands at its
    cumulative offset so slots never collide."""
    off = const_count(where_node) if where_node is not None else 0
    where_fn = compile_expr(where_node) if where_node is not None else None
    agg_fns = []
    for a in agg_specs:
        if a.expr is None:
            agg_fns.append((a.op, None))
        else:
            agg_fns.append((a.op, compile_expr(a.expr, offset=off)))
            off += const_count(a.expr)
    return where_fn, agg_fns


def _row_mask(where_fn, mvcc_mode, cols, nulls, consts, valid, key_hash, ht,
              write_id, tombstone, read_ht):
    """The MVCC mask AND the WHERE (a NULL WHERE is false)."""
    mask = visibility_mask(mvcc_mode, valid, key_hash, ht, write_id,
                           tombstone, read_ht)
    if where_fn is not None:
        wv, wn = where_fn(cols, nulls, consts)
        mask = mask & wv
        if wn is not None:
            mask = mask & torch.logical_not(wn)
    return mask


def _build_kernel(where_node, agg_specs: Tuple[AggSpec, ...],
                  group: Optional[GroupSpec], mvcc_mode: str,
                  row_multiplier: int = 1,
                  static_sums: Tuple[bool, ...] = (),
                  strategy: str = "unroll"):
    """The exact route's program for one signature (the reference's
    ``_build_kernel``).  Returns fn(...) -> (agg_outs, agg_scales,
    counts, mask); each float SUM out is an exact int64 accumulation to
    divide by its scale host-side (scale 0.0 = integer-exact).

    `row_multiplier`: the distributed kernel runs this program on each
    of that many equal-size shards, and the dynamic scale must hold for
    all their rows together (n_total = padded rows x shards).  fn's
    `sum_vmax`, when given, holds per aggregate the max|v| over every
    shard (:func:`_build_vmax_pass`) for its dynamic-scale SUMs: the
    reference's in-kernel ``pmax``, which a single-controller mesh does
    as a pass of its own."""
    where_fn, agg_fns = _compile_aggs(where_node, agg_specs)
    static_sums = static_sums or (False,) * len(agg_fns)

    def fn(cols, nulls, consts, valid, key_hash, ht, write_id, tombstone,
           read_ht, sum_scales, group_domains=(), sum_vmax=None):
        def prep(i, v, m, n_total, sum_scales):
            if static_sums[i]:
                q, s = _sum_prep_static(v, m, sum_scales[i])
                return q, s, None
            return _sum_prep(v, m, n_total,
                             None if sum_vmax is None else sum_vmax[i])

        mask = _row_mask(where_fn, mvcc_mode, cols, nulls, consts, valid,
                         key_hash, ht, write_id, tombstone, read_ht)
        if isinstance(group, HashGroupSpec):
            return _hash_group(group, agg_fns, prep, cols, nulls, consts,
                               mask, sum_scales, row_multiplier)
        return masked_aggregate(group, agg_fns, prep, cols, nulls, consts,
                                mask, group_domains, sum_scales,
                                mask.shape[0] * row_multiplier, strategy)

    return fn


def _build_vmax_pass(where_node, agg_specs: Tuple[AggSpec, ...],
                     group: Optional[GroupSpec], mvcc_mode: str,
                     static_sums: Tuple[bool, ...]):
    """The first pass of the cross-shard scale agreement, for an
    ungrouped or dense-grouped program of :func:`_build_kernel`:
    fn(cols, nulls, consts, valid, key_hash, ht, write_id, tombstone,
    read_ht) -> per aggregate, the masked max|v| of a dynamic-scale
    float SUM (a 0-d tensor on the shard's device), else None.  The
    mask is the one the program's SUM sees: rows out of the MVCC mask,
    the WHERE, the group columns' NULLs or the value's NULL count 0."""
    where_fn, agg_fns = _compile_aggs(where_node, agg_specs)
    static_sums = static_sums or (False,) * len(agg_fns)

    def fn(cols, nulls, consts, valid, key_hash, ht, write_id, tombstone,
           read_ht):
        mask = _row_mask(where_fn, mvcc_mode, cols, nulls, consts, valid,
                         key_hash, ht, write_id, tombstone, read_ht)
        for cid, _, _ in (group.cols if group is not None else ()):
            gn = nulls.get(cid)
            if gn is not None:
                mask = mask & torch.logical_not(gn)
        out = []
        for i, (op, f) in enumerate(agg_fns):
            if op != "sum" or f is None or static_sums[i]:
                out.append(None)
                continue
            v, vn = f(cols, nulls, consts)
            if _is_exact_int(v):
                out.append(None)
                continue
            m = mask if vn is None else mask & torch.logical_not(vn)
            out.append(torch.max(torch.abs(torch.where(m, v, 0))))
        return tuple(out)

    return fn


def _segment_sum(x, seg, G: int):
    return torch.zeros(G, dtype=x.dtype, device=x.device).index_add_(
        0, seg, x)


def _segment_extreme(x, seg, G: int, is_min: bool):
    """jax.ops.segment_min/max: empty segments hold the dtype's
    identity (max for min, min for max)."""
    ident = _type_max(x) if is_min else _type_min(x)
    out = torch.full((G,), ident, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, seg, x, "amin" if is_min else "amax",
                               include_self=True)


def _hash_group(group: HashGroupSpec, agg_fns, prep, cols, nulls, consts,
                mask, sum_scales, row_multiplier: int = 1):
    """HashGroupSpec: sort by (not-in-mask, *group columns); segment ids
    are the cumsum of group starts, clipped to max_groups - 1;
    ``n_groups`` is the true count, so overflow shows there.  Returns
    (outs, scales, counts, mask, gvals, n_groups); group values come
    back by segment-min (constant within a segment)."""
    for cid in group.cols:
        gn = nulls.get(cid)
        if gn is not None:
            mask = mask & torch.logical_not(gn)
    n = mask.shape[0]
    G = group.max_groups
    gcols = [cols[cid] for cid in group.cols]
    perm = _lexsort([torch.logical_not(mask)] + gcols)
    g_s = [g[perm] for g in gcols]
    valid_s = mask[perm]
    first = valid_s & _first_of_run(*g_s)
    n_groups = first.sum(dtype=torch.int32)
    seg = torch.clamp(torch.cumsum(first, 0, dtype=torch.int64) - 1, 0,
                      G - 1)
    out, scales = [], []
    for i, (op, f) in enumerate(agg_fns):
        if f is None:
            out.append(_segment_sum(valid_s.to(torch.int64), seg, G))
            scales.append(_NOSCALE)
            continue
        v, vn = f(cols, nulls, consts)
        v_s = v.expand(mask.shape)[perm]
        m = valid_s if vn is None else \
            valid_s & torch.logical_not(vn)[perm]
        if op == "count":
            out.append(_segment_sum(m.to(torch.int64), seg, G))
            scales.append(_NOSCALE)
        elif op == "sum":
            q, s, vm = prep(i, v_s, m, n * row_multiplier, sum_scales)
            out.append(_segment_sum(q, seg, G))
            scales.append(s if vm is None
                          else (s, _segment_sum(vm, seg, G)))
        elif op in ("min", "max"):
            is_min = op == "min"
            fill = _type_max(v) if is_min else _type_min(v)
            out.append(_segment_extreme(_fill_where(m, v_s, fill), seg, G,
                                        is_min))
            scales.append(_NOSCALE)
        else:
            raise ValueError(op)
    counts = _segment_sum(valid_s.to(torch.int64), seg, G)
    gvals = tuple(_segment_extreme(_fill_where(valid_s, g, _type_max(g)),
                                   seg, G, True) for g in g_s)
    return tuple(out), tuple(scales), counts, mask, gvals, n_groups


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
        refusal reason (the reference's `_pallas_eligible`).  Unlike
        the reference's gate it takes MVCC mode ``visible`` too: that
        mode's row mask (valid, ht <= read_ht, not a tombstone) goes in
        as K3's valid lane, so a tablet read at a read point over
        unique keys runs K3; ``dedup`` stays refused."""
        if mvcc_mode == "dedup" or not aggs:
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
            if col is None or col.dtype not in HAND_DTYPES:
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
                   consts, read_ht=None):
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
        carr = torch.tensor([float(c) for c in consts] or [0.0],
                            dtype=torch.float32, device=batch.device)
        valid = batch.valid
        if mvcc_mode == "visible" and batch.ht is not None:
            valid = visibility_mask(
                "visible", valid, None, batch.ht, None, batch.tombstone,
                torch.tensor(flipped_i64_scalar(read_ht), dtype=torch.int64,
                             device=batch.device))
        # K3 loads every lane in its own dtype: the batch's tensors go
        # in as they are, with no per-query cast or copy
        return entry, (carr, [batch.cols[cid] for cid in col_order],
                       [batch.nulls[cid] for cid in null_order], valid)

    def hand_scan_plan(self, batch: DeviceBatch, where=None, aggs=(),
                       group=None, read_ht=None):
        """The K3 entry and arguments ``run`` would launch for this query
        with ``hand_scan_enabled`` on — for checking the kernel against
        its plain version on the very same lanes."""
        p = self._prepare(batch, where, aggs, group, read_ht)
        return self._hand_plan(p["sig"], batch, where, p["aggs"], group,
                               p["mvcc_mode"], p["consts"], read_ht)

    def _try_hand(self, sig, batch, where, aggs, group, mvcc_mode, consts,
                  read_ht=None):
        """Route eligible aggregate scans through K3.  Returns the
        exact-route-shaped result, or None on a typed HandScanIneligible
        refusal (tallied in ``hand_scan_refusals``; the caller serves
        the exact route).  Any other failure propagates."""
        try:
            entry, args = self._hand_plan(sig, batch, where, aggs, group,
                                          mvcc_mode, consts, read_ht)
        except HandScanIneligible as e:
            r = str(e)
            self.hand_scan_refusals[r] = self.hand_scan_refusals.get(r, 0) + 1
            return None
        # every output's partials come back in one copy
        parts = np.asarray(_np(entry.partials(*args)), np.float64)
        results = []
        for a, p in zip(aggs, parts[:-1]):
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
        counts = parts[-1].sum(axis=0).astype(np.int64)
        return tuple(results), counts, None

    def _prepare(self, batch, where, aggs, group, read_ht) -> dict:
        """Route-independent query preparation: AVG expansion, MVCC
        mode, the flat consts list, static SUM scales and the
        signature key."""
        if batch.device != self.device:
            raise ValueError(f"batch on {batch.device}, kernel for "
                             f"{self.device}")
        aggs = tuple(_expand_avg(aggs))
        if read_ht is None:
            mvcc_mode = "none"
        elif batch.unique_keys:
            mvcc_mode = "visible"
        else:
            mvcc_mode = "dedup"
        domains: tuple = ()
        if isinstance(group, DictGroupSpec):
            # resolve against the batch's scan-global dictionaries: the
            # pow2 slot bucket enters the signature, the dictionary
            # sizes are run-time values.  KeyError: a group column with
            # no dictionary
            group, domains = resolve_group(group, batch.dicts)
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
            (type(group).__name__, group.cols,
             getattr(group, "max_groups",
                     getattr(group, "num_slots", None))) if group
            else None,
            mvcc_mode, batch.padded_rows, col_sig, static_sums, strategy,
        )
        return dict(aggs=aggs, mvcc_mode=mvcc_mode, consts=consts,
                    static_sums=static_sums, scale_args=scale_args,
                    strategy=strategy, sig=sig, group=group,
                    domains=domains)

    def run(self, batch: DeviceBatch,
            where: Optional[tuple] = None,
            aggs: Sequence[AggSpec] = (),
            group=None,
            read_ht: Optional[int] = None):
        """Returns (agg_results tuple, count_or_group_counts, mask) —
        mask is None when the hand route served the query.
        HashGroupSpec adds (group_values, n_groups); DictGroupSpec adds
        a trailing spill count (nonzero: the slot budget overflowed and
        the caller must discard the result)."""
        p = self._prepare(batch, where, aggs, group, read_ht)
        group = p["group"]
        from ..utils import flags as _flags
        if _flags.get("hand_scan_enabled"):
            got = self._try_hand(p["sig"], batch, where, p["aggs"], group,
                                 p["mvcc_mode"], p["consts"], read_ht)
            if got is not None:
                return got
        fn = self._get(p["sig"], where, p["aggs"], group, p["mvcc_mode"],
                       p["static_sums"], p["strategy"])
        if isinstance(group, ResolvedDictGroup):
            GROUPED_STATS["launches"] += 1
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
            p["scale_args"], p["domains"],
        )
        # (outs, scales, counts, mask[, gvals, n_groups | spill]) ->
        # rescale the fixed-point sums host-side; callers keep the shape
        # (outs, counts, mask[, ...])
        return (_rescale_outs(raw[0], raw[1]),) + tuple(raw[2:])


def _static_scales(aggs: Sequence[AggSpec],
                   col_bounds: Dict[int, Tuple[float, float]],
                   n_total: int, cols, device: torch.device):
    """Per-agg static fixed-point scales from host column stats.
    Returns (static_flags, scales).  Expressions that the device may
    evaluate in f32 — any f32 column, or any non-CPU device (the port's
    CUDA policy ships fractional columns as f32) — cap every
    intermediate interval at the f32 finite range.  `cols` maps column
    ids to tensors or numpy arrays (a join's payload lanes), read only
    for their dtype."""
    flags_, scales = [], []
    for a in aggs:
        s = None
        if a.op == "sum" and a.expr is not None and col_bounds:
            mag = 1.0e306
            if device.type != "cpu" or (
                    cols is not None and any(
                        _is_f32(cols.get(c))
                        for c in referenced_columns(a.expr))):
                mag = 3.0e38
            b = expr_bound(a.expr, col_bounds, mag_limit=mag)
            if b is not None:
                s = _scale_for(max(abs(b[0]), abs(b[1])), n_total)
        flags_.append(s is not None)
        scales.append(np.float32(s if s is not None else 0.0))
    return tuple(flags_), tuple(scales)


def _is_f32(lane) -> bool:
    """True for a float32 torch tensor or numpy array."""
    dt = getattr(lane, "dtype", None)
    return dt == torch.float32 if isinstance(dt, torch.dtype) \
        else dt == np.float32


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


def expand_aggregates(aggs: Sequence[AggSpec]
                      ) -> Tuple[tuple, List[int], tuple]:
    """(expanded, minmax, aggs_run): AVG expanded to SUM and COUNT, the
    positions of MIN/MAX among the expanded aggregates, and what the
    kernel runs — the expanded aggregates plus one COUNT of each MIN/MAX
    expression, which tells an all-NULL group from a real extreme."""
    expanded = tuple(_expand_avg(aggs))
    minmax = [i for i, a in enumerate(expanded) if a.op in ("min", "max")]
    aggs_run = expanded + tuple(AggSpec("count", expanded[i].expr)
                                for i in minmax)
    return expanded, minmax, aggs_run


def needed_probe_columns(where, aggs: Sequence[AggSpec], group,
                         joins: Sequence = ()) -> set:
    """Column ids a scan reads from its blocks: those of WHERE, of the
    aggregate expressions and of the group.  With `joins` (normalized
    JoinWires) build-side payload ids (>= BUILD_COL_BASE) are dropped —
    the fused plan forms those lanes — and each stage's FK on the probe
    table is added; a chain stage whose probe lane is an earlier stage's
    payload adds nothing."""
    needed: set = set()
    if where is not None:
        referenced_columns(where, needed)
    for a in aggs:
        if a.expr is not None:
            referenced_columns(a.expr, needed)
    if isinstance(group, GroupSpec):
        needed.update(cid for cid, _, _ in group.cols)
    elif group is not None:
        needed.update(group.cols)
    if joins:
        needed = {c for c in needed if c < BUILD_COL_BASE}
        needed.update(w.probe_col for w in joins
                      if w.probe_col < BUILD_COL_BASE)
    return needed


# one kernel cache per device for the module-level entry points
_DEFAULT_KERNELS: Dict[torch.device, ScanKernel] = {}


def default_kernel(device: DeviceLike = "cuda") -> ScanKernel:
    dev = resolve_device(device)
    k = _DEFAULT_KERNELS.get(dev)
    if k is None:
        k = _DEFAULT_KERNELS[dev] = ScanKernel(dev)
    return k


def scan_aggregate(batch: DeviceBatch, where=None, aggs=(), group=None,
                   read_ht=None):
    return default_kernel(batch.device).run(batch, where, aggs, group,
                                            read_ht)



# --- cross-shard partial combine ---------------------------------------------
# The one implementation of "sum/count add, min/max take None-aware
# elementwise extremes", shared by the multi-tablet fan-out
# (models/tpch.LineitemTable.run) and the bypass session's host combine.

def _scalar_of(x):
    """Python scalar from a 0-d array / numpy scalar / plain value."""
    if isinstance(x, (np.ndarray, np.generic)):
        return x.item()
    return x


def _mm2(x, y, op):
    """None-aware scalar min/max (SQL: NULL is the identity)."""
    if x is None:
        return y
    if y is None:
        return x
    return min(x, y) if op == "min" else max(x, y)


def merge_minmax(a, b, op):
    """None-aware elementwise min/max over scalars or per-group arrays."""
    av, bv = np.asarray(a), np.asarray(b)
    if av.ndim == 0:
        return np.asarray(_mm2(av.item(), bv.item(), op))
    if av.dtype != object and bv.dtype != object:
        return np.minimum(av, bv) if op == "min" else np.maximum(av, bv)
    out = np.empty(av.shape, object)
    for i in range(av.shape[0]):
        out[i] = _mm2(_scalar_of(av[i]), _scalar_of(bv[i]), op)
    return out


def agg_is_none(x) -> bool:
    """A whole-shard NULL aggregate (an empty tablet's min/max)."""
    return x is None or (isinstance(x, np.ndarray) and x.dtype == object
                         and x.shape == () and x.item() is None)


def combine_agg_partials(expanded_aggs: Sequence[AggSpec],
                         parts: Sequence[Sequence],
                         counts_parts: Sequence):
    """Combine per-shard (agg_values, group_counts) partials in shard
    order: sum/count add, min/max merge via :func:`merge_minmax` with
    None as the identity.  `expanded_aggs` are avg-expanded.  Returns
    (tuple of combined values, combined counts or None)."""
    total = None
    counts = None
    for vals, cnts in zip(parts, counts_parts):
        vals = [np.asarray(v) for v in vals]
        if total is None:
            total = vals
            counts = np.asarray(cnts) if cnts is not None else None
            continue
        for i, a in enumerate(expanded_aggs):
            if a.op in ("sum", "count"):
                total[i] = total[i] + vals[i]
            elif agg_is_none(vals[i]):
                pass
            elif agg_is_none(total[i]):
                total[i] = vals[i]
            else:
                total[i] = merge_minmax(total[i], vals[i], a.op)
        if counts is not None:
            counts = counts + np.asarray(cnts)
    return (tuple(total) if total is not None else ()), counts


def _keyed_partials(part):
    """Keyed dict view of one (agg_values, counts, group_values)
    partial: group key tuple -> [agg scalars, count]."""
    vals, cnts, gvals = part
    out: Dict[tuple, list] = {}
    if cnts is None:
        return out
    counts = np.asarray(cnts)
    gv = [np.asarray(g) for g in (gvals or ())]
    vv = [np.asarray(v) for v in vals]
    for g in range(len(counts)):
        if counts[g] == 0:
            continue
        key = tuple(x[g].item() if isinstance(x[g], np.generic)
                    else x[g] for x in gv)
        out[key] = [[_scalar_of(v[g]) for v in vv], int(counts[g])]
    return out


def combine_grouped_partials(expanded_aggs: Sequence[AggSpec],
                             parts: Sequence[tuple]):
    """Group-KEYED partial merge for shards whose group slots do not
    align (each shard merges its own dictionary).  ``parts``: per-shard
    ``(agg_values, counts, group_values)`` over compacted present
    groups.  Returns ``(agg_values, counts, group_values)`` merged by
    key in first-seen shard order: sum/count add, min/max None-aware."""
    merged: Dict[tuple, list] = {}
    for vals, cnts, gvals in parts:
        if cnts is None:
            continue
        counts = np.asarray(cnts)
        gv = [np.asarray(g) for g in (gvals or ())]
        vv = [np.asarray(v) for v in vals]
        for g in range(len(counts)):
            if counts[g] == 0:
                continue
            # object (string) arrays index to plain str; numpy scalars
            # unwrap into hashable Python values
            key = tuple(x[g].item() if isinstance(x[g], np.generic)
                        else x[g] for x in gv)
            st = merged.get(key)
            if st is None:
                merged[key] = [[v[g] for v in vv], int(counts[g])]
                continue
            for i, a in enumerate(expanded_aggs):
                if a.op in ("sum", "count"):
                    st[0][i] = st[0][i] + vv[i][g]
                else:
                    st[0][i] = _mm2(_scalar_of(st[0][i]),
                                    _scalar_of(vv[i][g]), a.op)
            st[1] += int(counts[g])
    keys = list(merged)
    outs = tuple(np.asarray([merged[k][0][i] for k in keys])
                 for i in range(len(expanded_aggs)))
    counts = np.asarray([merged[k][1] for k in keys], np.int64)
    gvals = tuple(np.asarray([k[j] for k in keys])
                  for j in range(len(keys[0]) if keys else 0))
    return outs, counts, gvals


# --- zone-map block pruning (v2 blocks carry per-block min/max maps) ---------

def _f32_widen(lo, hi):
    """Widen a float interval one f32 ulp outward on each end: the
    device may evaluate the column and the constants in float32, where
    a value just below a boundary can round ONTO it (f64 0.0499999999
    becomes f32 0.05 and satisfies >= 0.05)."""
    lo_w = float(np.nextafter(np.float32(lo), np.float32(-np.inf)))
    hi_w = float(np.nextafter(np.float32(hi), np.float32(np.inf)))
    return (min(lo, lo_w), max(hi, hi_w))


def _zone_interval(node, zmap):
    """Conservative (lo, hi) of an expression over a block described by
    its zone map, or None when unboundable.  Integer bounds stay exact
    Python ints; float bounds widen to the f32 envelope."""
    kind = node[0]
    if kind == "col":
        b = zmap.get(node[1])
        if b is not None and (isinstance(b[0], float)
                              or isinstance(b[1], float)):
            return _f32_widen(b[0], b[1])
        return b
    if kind == "const":
        v = node[1]
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
        if isinstance(v, float):
            # the kernel may round the constant itself to f32
            return _f32_widen(v, v)
        return (v, v)
    if kind == "arith":
        lb = _zone_interval(node[2], zmap)
        rb = _zone_interval(node[3], zmap)
        if lb is None or rb is None:
            return None
        op = node[1]
        if op == "add":
            out = (lb[0] + rb[0], lb[1] + rb[1])
        elif op == "sub":
            out = (lb[0] - rb[1], lb[1] - rb[0])
        elif op == "mul":
            prods = (lb[0] * rb[0], lb[0] * rb[1],
                     lb[1] * rb[0], lb[1] * rb[1])
            out = (min(prods), max(prods))
        else:
            return None
        if isinstance(out[0], float) or isinstance(out[1], float):
            out = _f32_widen(out[0], out[1])   # per-op device rounding
        return out
    return None


def zone_maybe_match(where, zmap) -> bool:
    """False ONLY when the block's zone map proves no row can satisfy
    `where`; True on anything unprovable (missing entries, strings,
    NOT, other shapes).  Zone maps cover non-null values and a NULL
    comparison never matches, so a pruned block hides no NULL match."""
    if not zmap:
        return True
    kind = where[0]
    if kind == "and":
        return all(zone_maybe_match(c, zmap) for c in where[1:])
    if kind == "or":
        return any(zone_maybe_match(c, zmap) for c in where[1:])
    if kind == "between":
        return (zone_maybe_match(("cmp", "ge", where[1], where[2]), zmap)
                and zone_maybe_match(("cmp", "le", where[1], where[3]),
                                     zmap))
    if kind == "in":
        x, vals = where[1], where[2]
        b = _zone_interval(x, zmap)
        if b is None:
            return True
        return any(isinstance(v, (int, float)) and not isinstance(v, bool)
                   and b[0] <= v <= b[1] for v in vals) or not vals
    if kind == "cmp":
        op = where[1]
        lb = _zone_interval(where[2], zmap)
        rb = _zone_interval(where[3], zmap)
        if lb is None or rb is None:
            return True
        if op == "lt":
            return lb[0] < rb[1]
        if op == "le":
            return lb[0] <= rb[1]
        if op == "gt":
            return lb[1] > rb[0]
        if op == "ge":
            return lb[1] >= rb[0]
        if op == "eq":
            return lb[0] <= rb[1] and lb[1] >= rb[0]
        if op == "ne":
            return not (lb[0] == lb[1] == rb[0] == rb[1])
        return True
    return True


def zone_prune_blocks(blocks, where):
    """(kept_blocks, kept_indices) by the blocks' zone maps; the indices
    are positions in `blocks`, the prune identity device-cache keys
    carry.  Never empty: when every block proves unmatchable, the
    smallest survives so result shapes and NULL semantics hold."""
    if where is None:
        return list(blocks), tuple(range(len(blocks)))
    kept_idx = [i for i, b in enumerate(blocks)
                if getattr(b, "zmap", None) is None
                or zone_maybe_match(where, b.zmap)]
    if not kept_idx and blocks:
        kept_idx = [min(range(len(blocks)), key=lambda i: blocks[i].n)]
    return [blocks[i] for i in kept_idx], tuple(kept_idx)
