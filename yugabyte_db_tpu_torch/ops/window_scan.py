"""Window functions over the sorted scan: segment scans, no scatter.

Counterpart of ``yugabyte_db_tpu/ops/window_scan.py``.  Rows sort by
(partition, order) on the host; partition and peer boundaries become
boolean lanes, and every supported function is a vectorized segment
scan over the sorted axis:

- row_number / rank / dense_rank: cummax over boundary-stamped indices
  (rank = peer-group start relative to segment start);
- lag / lead: shifted gathers clamped to the segment (NULL outside);
- SUM / COUNT: global cumsum minus the segment-start base; the
  cumulative (ordered) frame shares the value across order-key peers
  like PG's default RANGE frame; the un-ordered frame broadcasts the
  segment total;
- rolling SUM (ROWS k-1 PRECEDING .. CURRENT ROW): two cumsum gathers,
  the window clamped at the segment start;
- MIN / MAX: segment totals via the same peer-end gather; cumulative
  frames via a boundary-respecting log-step scan.

The reference jits one XLA program per (op list, pow2 row bucket, value
dtypes); here :func:`window_program` is plain torch on the kernel's
device, run at the true row count (torch compiles nothing, so the pow2
bucket and its padding segment buy nothing and are gone).  Integer
value lanes accumulate exactly in int64; :func:`window_cpu` is the
numpy twin the parity tests hold the program against."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

#: process-wide window accounting: program launches, and typed refusals
#: tallied by the read seam (docdb/operations.py _serve_window)
WINDOW_STATS = {"launches": 0, "fallbacks": 0}

#: supported op heads (ops are tuples: ("lag", 2), ("sum", True) ...)
VALUE_OPS = {"lag", "lead", "sum", "count", "min", "max",
             "rolling_sum"}
NO_VALUE_OPS = {"row_number", "rank", "dense_rank", "count_star"}

# --- server-side pushdown (the sorted-scan request shape) ------------------

REASON_WINDOW_OFF = "window_server_off"
REASON_WINDOW_PAGED = "window_paged_scan"
REASON_WINDOW_NULL_KEY = "window_null_key"
REASON_WINDOW_KEY_KIND = "window_key_kind"
REASON_WINDOW_VALUE_KIND = "window_value_kind"
REASON_WINDOW_FUNC = "window_func"
REASON_WINDOW_SHAPE = "window_shape"


class WindowIneligible(Exception):
    """Typed refusal: the server-side window path cannot serve this
    request bit-identically; the tablet serves PLAIN rows with the
    reason on the response and the client tier recomputes."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason
        self.detail = detail


@dataclass
class WindowWire:
    """Window spec as it crosses the wire inside a ReadRequest (the
    reference's sorted-scan request shape).  All items share ONE
    (partition, order) spec.

    ``partition_by``: column NAMES partitioning the rows.
    ``order_by``: (column name, desc) pairs ordering within a partition.
    ``items``: (head, param, value_col, out_name) per window item:
    ``head`` a kernel op head, ``param`` its static int parameter
    (lag/lead offset; 1 for cumulative frames, 0 for whole-partition),
    ``value_col`` the value column name (None for arithmetic-free
    heads), ``out_name`` the key the value lands under in each row."""
    partition_by: Tuple[str, ...] = ()
    order_by: Tuple[Tuple[str, bool], ...] = ()
    items: Tuple[Tuple[str, int, Optional[str], str], ...] = ()

    def signature(self) -> tuple:
        return (self.partition_by, self.order_by,
                tuple((h, p, v) for h, p, v, _ in self.items))


def _key_codes(vals):
    """Sort codes for one partition/order key lane over row VALUES (the
    reference's codes_of contract).  Raises WindowIneligible (typed)
    for NULL keys and non-orderable kind mixes."""
    if any(v is None for v in vals):
        raise WindowIneligible(REASON_WINDOW_NULL_KEY)
    kinds = {type(v) for v in vals}
    if kinds <= {int, bool}:
        arr = np.asarray([int(v) for v in vals], np.int64)
    elif kinds <= {int, bool, float}:
        arr = np.asarray([float(v) for v in vals], np.float64)
        if np.isnan(arr).any():
            raise WindowIneligible(REASON_WINDOW_KEY_KIND, "NaN key")
    elif kinds == {str}:
        arr = np.asarray(vals)
    else:
        raise WindowIneligible(
            REASON_WINDOW_KEY_KIND,
            ",".join(sorted(k.__name__ for k in kinds)))
    uniq, codes = np.unique(arr, return_inverse=True)
    return codes.astype(np.int64), len(uniq)


def serve_window_rows(wire: WindowWire, rows: List[dict],
                      kernel: Optional["WindowKernel"] = None) -> None:
    """Compute the wire's window items over name-keyed `rows` IN PLACE:
    one np.lexsort by (partition, order) codes, the segment program over
    the sorted axis, values scattered back to each row under its item's
    out_name (rows keep their order).  Values land as the reference's
    int() or float() of each element.  Raises WindowIneligible (typed)
    for every shape the program cannot answer bit-identically to the
    Python window fold.  ``kernel`` defaults to the CUDA one."""
    if not rows:
        return
    lanes = window_lanes(wire, rows)
    kern = kernel or default_window_kernel()
    scatter_window(lanes, kern.run(*lanes[:5]), rows)


def window_lanes(wire: WindowWire, rows: List[dict]) -> tuple:
    """The host half before the program: (ops, seg_start, peer_start,
    sorted values, sorted nulls, perm, out names) for `rows` (at least
    one).  Raises WindowIneligible."""
    n = len(rows)
    pkeys = [
        _key_codes([r.get(c) for r in rows])[0]
        for c in wire.partition_by]
    okeys = []
    for cname, desc in wire.order_by:
        codes, nu = _key_codes([r.get(cname) for r in rows])
        okeys.append((nu - 1 - codes) if desc else codes)
    has_order = bool(wire.order_by)
    ops, values, nulls, names = [], [], [], []
    for head, param, value_col, out_name in wire.items:
        if head in ("row_number", "rank", "dense_rank"):
            ops.append((head,))
            values.append(None)
            nulls.append(None)
        elif head == "count_star":
            ops.append(("count_star", 1 if has_order else 0))
            values.append(None)
            nulls.append(None)
        elif head in ("lag", "lead"):
            if value_col is None or param < 0:
                raise WindowIneligible(REASON_WINDOW_SHAPE, head)
            vals = [r.get(value_col) for r in rows]
            kinds = {type(v) for v in vals if v is not None}
            if kinds <= {int}:
                arr = np.asarray(
                    [0 if v is None else int(v) for v in vals],
                    np.int64)
            elif kinds <= {int, float}:
                arr = np.asarray(
                    [0.0 if v is None else float(v) for v in vals],
                    np.float64)
            else:
                raise WindowIneligible(REASON_WINDOW_VALUE_KIND,
                                       value_col)
            ops.append((head, param))
            values.append(arr)
            nulls.append(np.asarray([v is None for v in vals], bool))
        elif head in ("sum", "count", "min", "max"):
            if value_col is None:
                raise WindowIneligible(REASON_WINDOW_SHAPE, head)
            cum = 1 if has_order else 0
            vals = [r.get(value_col) for r in rows]
            kinds = {type(v) for v in vals if v is not None}
            if head == "count":
                arr = np.zeros(n, np.int64)     # mask-only lane
            elif kinds <= {int, bool}:
                # exact int64 segment arithmetic: the only lanes whose
                # answer is bit-identical to the fold
                arr = np.asarray(
                    [0 if v is None else int(v) for v in vals],
                    np.int64)
            else:
                raise WindowIneligible(REASON_WINDOW_VALUE_KIND,
                                       value_col)
            ops.append((head, cum))
            values.append(arr)
            nulls.append(np.asarray([v is None for v in vals], bool))
        else:
            raise WindowIneligible(REASON_WINDOW_FUNC, head)
        names.append(out_name)
    keys = pkeys + okeys
    perm = np.lexsort(tuple(reversed(keys))) if keys else np.arange(n)
    seg = np.zeros(n, bool)
    seg[0] = True
    for kk in pkeys:
        ks = kk[perm]
        seg[1:] |= ks[1:] != ks[:-1]
    peer = np.zeros(n, bool)
    for kk in okeys:
        ks = kk[perm]
        peer[1:] |= ks[1:] != ks[:-1]
    svalues = [None if v is None else v[perm] for v in values]
    snulls = [None if m is None else m[perm] for m in nulls]
    return ops, seg, peer, svalues, snulls, perm, names


def scatter_window(lanes: tuple, outs, rows: List[dict]) -> None:
    """The host half after the program: each op's values back to its
    row under the item's out_name.  Int and float lanes list out as the
    same Python ints and floats as the reference's int()/float() of each
    element."""
    perm, names = lanes[5], lanes[6]
    prow = [rows[int(i)] for i in perm]
    for (ov, om), name in zip(outs, names):
        is_f = ov.dtype.kind == "f"
        vals = (ov.astype(np.float64) if is_f
                else ov.astype(np.int64)).tolist()
        for row, v, null in zip(prow, vals, om.tolist()):
            row[name] = None if null else v


# --- the segment program (the reference's jitted _build_window_kernel) -----

def _cummin_rev(a: torch.Tensor) -> torch.Tensor:
    """Suffix minimum (jax.lax.cummin(a[::-1])[::-1])."""
    return torch.flip(torch.cummin(torch.flip(a, (0,)), 0).values, (0,))


def _seg_bounds(seg_start, idx, n):
    """(start_idx, end_idx) per row: nearest segment boundary at-or-
    before / segment last row at-or-after."""
    start_idx = torch.cummax(torch.where(seg_start, idx, -1), 0).values
    seg_last = torch.cat([seg_start[1:],
                          torch.ones(1, dtype=torch.bool,
                                     device=seg_start.device)])
    end_idx = _cummin_rev(torch.where(seg_last, idx, n))
    return start_idx, end_idx


def _at_or_zero(c, pos):
    """c[pos] where pos >= 0, else 0 (the value just before a segment
    or window start)."""
    return torch.where(pos >= 0, c[pos.clamp(min=0)], 0)


def _seg_cum(q, start_idx):
    """Within-segment inclusive cumsum of q (q already 0 where null):
    global cumsum minus the value just before the segment start, exact
    for int64 lanes."""
    c = torch.cumsum(q, 0)
    return c - _at_or_zero(c, start_idx - 1)


def _seg_scan_extreme(v, seg_id, is_min: bool):
    """Cumulative within-segment min/max: a log-step (Hillis-Steele)
    scan, ceil(log2 n) passes of a compare and torch.minimum/maximum
    gated on equal segment ids.  Exact for every dtype; NaN propagates
    as jnp.minimum's does."""
    red = torch.minimum if is_min else torch.maximum
    out = v
    n = len(v)
    shift = 1
    while shift < n:
        prev = out[:-shift]
        same = seg_id[:-shift] == seg_id[shift:]
        tail = torch.where(same, red(prev, out[shift:]), out[shift:])
        out = torch.cat([out[:shift], tail])
        shift <<= 1
    return out


def window_program(op_sig: Sequence[tuple], seg_start: torch.Tensor,
                   peer_start: torch.Tensor,
                   vals: Sequence[torch.Tensor],
                   nulls: Sequence[torch.Tensor]
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The segment program on the lanes' device: ``op_sig`` entries are
    (head, param); ``vals``/``nulls`` hold one lane each per value op,
    in order.  Returns (values, null mask) per op.  Rank heads give
    int32 lanes, as the reference's do; every SUM and COUNT is int64."""
    n = len(seg_start)
    dev = seg_start.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    start_idx, end_idx = _seg_bounds(seg_start, idx, n)
    new_peer = seg_start | peer_start
    pstart_idx = torch.cummax(torch.where(new_peer, idx, -1), 0).values
    # peer-group LAST row: the next row opens a new peer group or the
    # segment ends here
    peer_last = torch.cat([new_peer[1:],
                           torch.ones(1, dtype=torch.bool, device=dev)]) \
        | (idx == end_idx)
    pend_idx = _cummin_rev(torch.where(peer_last, idx, n))
    seg_id = torch.cumsum(seg_start, 0)
    no_nulls = torch.zeros(n, dtype=torch.bool, device=dev)
    outs = []
    vi = 0
    for head, param in op_sig:
        if head in NO_VALUE_OPS:
            if head == "row_number":
                out = (idx - start_idx + 1).to(torch.int32)
            elif head == "rank":
                out = (pstart_idx - start_idx + 1).to(torch.int32)
            elif head == "dense_rank":
                d = torch.cumsum(new_peer, 0)
                out = (d - d[start_idx] + 1).to(torch.int32)
            else:   # count_star: every row counts
                c = idx - start_idx + 1
                out = c[pend_idx] if param else c[end_idx]
            outs.append((out, no_nulls))
            continue
        v = vals[vi]
        vn = nulls[vi]
        vi += 1
        if head in ("lag", "lead"):
            src = idx - param if head == "lag" else idx + param
            ok = (src >= start_idx) & (src <= end_idx)
            srcc = src.clamp(0, n - 1)
            outs.append((v[srcc], ~ok | vn[srcc]))
            continue
        nn = ~vn
        if head in ("sum", "count", "rolling_sum"):
            q = (torch.where(nn, v, 0).to(torch.int64)
                 if head != "count" else nn.to(torch.int64))
            c = _seg_cum(q, start_idx)
            cnt = _seg_cum(nn.to(torch.int64), start_idx)
            if head == "rolling_sum":
                # c is the WITHIN-segment cumsum, so the window base is
                # c at lo-1 when lo is past the segment start
                lo = torch.maximum(idx - (param - 1), start_idx)
                before = torch.where(lo > start_idx, lo - 1, -1)
                val_out = c - _at_or_zero(c, before)
                cnt_out = cnt - _at_or_zero(cnt, before)
            elif param:          # cumulative: peers share
                val_out = c[pend_idx]
                cnt_out = cnt[pend_idx]
            else:                # whole partition
                val_out = c[end_idx]
                cnt_out = cnt[end_idx]
            if head == "count":
                outs.append((cnt_out, no_nulls))
            else:
                outs.append((val_out, cnt_out == 0))
            continue
        if head in ("min", "max"):
            is_min = head == "min"
            if v.dtype.is_floating_point:
                sent = float("inf") if is_min else float("-inf")
            else:
                info = torch.iinfo(v.dtype)
                sent = info.max if is_min else info.min
            masked = v.masked_fill(vn, sent)
            cnt = _seg_cum(nn.to(torch.int64), start_idx)
            run = _seg_scan_extreme(masked, seg_id, is_min)
            at = pend_idx if param else end_idx
            outs.append((run[at], cnt[at] == 0))
            continue
        raise ValueError(head)
    return outs


class WindowKernel:
    """The segment program on one device (CUDA unless the caller passes
    "cpu"): host lanes in, host lanes out."""

    def __init__(self, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)

    def run(self, ops: Sequence[tuple], seg_start: np.ndarray,
            peer_start: np.ndarray,
            values: Sequence[Optional[np.ndarray]],
            value_nulls: Sequence[Optional[np.ndarray]]
            ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Run `ops` over ONE sorted row set.  ``ops``: (head, param)
        tuples aligned with `values` (None for arithmetic-free heads).
        Returns per-op (values, null_mask) numpy arrays."""
        n = len(seg_start)
        dev = self.device

        def lane(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        vals, nulls, op_sig = [], [], []
        for op, v, vn in zip(ops, values, value_nulls):
            head, param = op[0], (op[1] if len(op) > 1 else 0)
            op_sig.append((head, param))
            if head in NO_VALUE_OPS:
                continue
            vals.append(lane(v))
            nulls.append(lane(vn) if vn is not None
                         else torch.zeros(n, dtype=torch.bool, device=dev))
        WINDOW_STATS["launches"] += 1
        raw = window_program(op_sig, lane(np.asarray(seg_start, bool)),
                             lane(np.asarray(peer_start, bool)), vals,
                             nulls)
        return [(o.cpu().numpy(), m.cpu().numpy()) for o, m in raw]


_WINDOW_KERNELS: Dict[torch.device, WindowKernel] = {}


def default_window_kernel(device: DeviceLike = "cuda") -> WindowKernel:
    """One WindowKernel per device, shared by every caller."""
    dev = resolve_device(device)
    k = _WINDOW_KERNELS.get(dev)
    if k is None:
        k = _WINDOW_KERNELS[dev] = WindowKernel(dev)
    return k


# ---------------------------------------------------------------------------
# Numpy twin: parity oracle for the segment program
# ---------------------------------------------------------------------------

def _peer_ends(new_peer_seg: np.ndarray) -> np.ndarray:
    """Per row of one segment: the segment-local index of its peer
    group's last row."""
    m = len(new_peer_seg)
    pend = np.zeros(m, np.int64)
    last = m - 1
    for i in range(m - 1, -1, -1):
        pend[i] = last
        if new_peer_seg[i]:
            last = i - 1
    return pend


def window_cpu(ops: Sequence[tuple], seg_start: np.ndarray,
               peer_start: np.ndarray,
               values: Sequence[Optional[np.ndarray]],
               value_nulls: Sequence[Optional[np.ndarray]]
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Segment-by-segment numpy replay of the program's contract."""
    n = len(seg_start)
    bounds = list(np.flatnonzero(seg_start)) + [n]
    outs = []
    new_peer = seg_start | peer_start
    for op, v, vn in zip(ops, values, value_nulls):
        head, param = op[0], (op[1] if len(op) > 1 else 0)
        if head in NO_VALUE_OPS:
            v = vn = None
        else:
            vn = np.zeros(n, bool) if vn is None else vn
        out = np.zeros(n, np.int64 if v is None or
                       v.dtype.kind in "ib" else v.dtype)
        om = np.zeros(n, bool)
        for s, e in zip(bounds[:-1], bounds[1:]):
            idx = np.arange(s, e)
            peers = np.cumsum(new_peer[s:e]) - 1
            if head == "row_number":
                out[s:e] = idx - s + 1
            elif head == "rank":
                firsts = np.flatnonzero(new_peer[s:e])
                out[s:e] = firsts[peers] + 1
            elif head == "dense_rank":
                out[s:e] = peers + 1
            elif head == "count_star":
                if param:
                    out[s:e] = _peer_ends(new_peer[s:e]) + 1
                else:
                    out[s:e] = e - s
            elif head in ("lag", "lead"):
                src = idx + (param if head == "lead" else -param)
                ok = (src >= s) & (src < e)
                sc = np.clip(src, s, e - 1)
                out[s:e] = v[sc]
                om[s:e] = ~ok | vn[sc]
            elif head in ("sum", "count", "rolling_sum"):
                nn = ~vn[s:e]
                q = (np.where(nn, v[s:e], 0).astype(np.int64)
                     if head != "count" else nn.astype(np.int64))
                c = np.cumsum(q)
                cn = np.cumsum(nn.astype(np.int64))
                if head == "rolling_sum":
                    lo = np.maximum(idx - s - (param - 1), 0)
                    base = np.where(lo > 0, c[np.clip(lo - 1, 0, None)],
                                    0)
                    cb = np.where(lo > 0, cn[np.clip(lo - 1, 0, None)],
                                  0)
                    out[s:e] = c - base
                    om[s:e] = (cn - cb) == 0
                elif param:
                    # cumulative, peers share the peer-group-end value
                    pend = _peer_ends(new_peer[s:e])
                    vals_out = c[pend]
                    cnts = cn[pend]
                    out[s:e] = cnts if head == "count" else vals_out
                    om[s:e] = False if head == "count" else cnts == 0
                else:
                    out[s:e] = cn[-1] if head == "count" else c[-1]
                    om[s:e] = False if head == "count" else cn[-1] == 0
            elif head in ("min", "max"):
                nn = ~vn[s:e]
                sel = v[s:e]
                red = np.minimum if head == "min" else np.maximum
                sent = (np.iinfo(sel.dtype).max if head == "min"
                        else np.iinfo(sel.dtype).min) \
                    if sel.dtype.kind in "iu" else \
                    (np.inf if head == "min" else -np.inf)
                masked = np.where(nn, sel, sent)
                run = red.accumulate(masked)
                cn = np.cumsum(nn.astype(np.int64))
                if param:
                    pend = _peer_ends(new_peer[s:e])
                    out[s:e] = run[pend]
                    om[s:e] = cn[pend] == 0
                else:
                    out[s:e] = run[-1]
                    om[s:e] = cn[-1] == 0
            else:
                raise ValueError(head)
        outs.append((out, om))
    return outs
