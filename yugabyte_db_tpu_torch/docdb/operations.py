"""DocDB read operations: the tablet read seam.

Counterpart of ``yugabyte_db_tpu/docdb/operations.py`` (the analog of
the reference's PgsqlReadOperation, src/yb/docdb/pgsql_operation.cc)
cut to the device routes of a read:

- ``ReadRequest`` / ``ReadResponse`` with the reference's fields;
- the dictionary rewrite of string predicates (module functions:
  ``rewrite_where_and_aggs``, ``rewrite_strings``, ``Unrewritable``);
- ``extract_scan_options``, which decides (as the reference does)
  whether a row read on a single-integer-hash-PK table is an enumerated
  MultiGet;
- ``DocReadOperation`` with its restart loop (``execute``) and the
  aggregate pushdown: the streamed route (ops/stream_scan.py) or one
  monolithic batch through the device cache, zone-map pruning, the
  clock-uncertainty restart check over every block, and dense, hash
  and dictionary GROUP BY;
- the FK-equijoin pushdown (``ReadRequest.join``): the fused plan
  (ops/plan_fusion.py: filter, hash-join probe, payload gather, group,
  aggregate) on the streamed or the monolithic route;
- the filter route of row reads with a WHERE: the row mask on the
  device (streamed or monolithic, zone-pruned), the matching rows
  gathered on the host from the columnar blocks, and the server-side
  window pushdown (``ReadRequest.window``, ops/window_scan.py) over
  them, refusals typed on the response.

Where the reference answers on its interpreted CPU path (its response
says ``backend == "cpu"``) the port raises ``NotPortedError`` naming
the ROADMAP.md item that brings that path: the interpreted row path,
small scans and row reads with no WHERE or a paging state (item 9a),
point, prefix and enumerated reads (item 9a), the interpreted join —
every join the device refuses with a typed reason, the flag off, a
device-ineligible shape, a dictionary-group spill — (item 9a), document
shredding (item 9b).  On every other request it answers what the
reference answers.

String columns ride on the device as codes into SORTED scan-global
dictionaries, so ordering predicates map to code ranges, equality/IN to
exact codes, and LIKE to a boolean lookup table over the dictionary
(the ``dictlut`` expression node)."""
from __future__ import annotations

import bisect
import math
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..errors import NotPortedError
from ..ops.device_batch import build_batch
from ..ops.grouped_scan import DictGroupSpec
from ..ops.scan import (AggSpec, HashGroupSpec, ScanKernel, _np,
                        expand_aggregates, needed_probe_columns)
from ..storage.columnar import ColumnarBlock
from ..utils import flags

_ROW_ITEM = "queue 1 item 9a (the interpreted row path)"
_POINT_ITEM = "queue 1 item 9a (point, prefix and enumerated reads)"
_JOIN_ITEM = "queue 1 item 9a (the interpreted join)"
_DOC_ITEM = "queue 1 item 9b (document shredding)"

#: zone-map pruning tally of the most recent monolithic pushdown scan
#: (informational)
LAST_SCAN_PRUNE_STATS: dict = {}
#: the most recent filter-route row read: route, rows out, and its host
#: seconds split between the mask kernel and the row gather
#: (informational)
LAST_ROW_STATS: dict = {}


@dataclass
class ReadRequest:
    """The reference's ReadRequest (the PgsqlReadRequestPB analog).  The
    port serves aggregate requests, with or without a `join` (one
    ops.join_scan.JoinWire or an ordered sequence of them), and row
    requests with a WHERE on the filter route, with or without a
    `window` (ops.window_scan.WindowWire); `pk_eq`, `pk_prefix` and the
    row shapes the reference serves on its CPU path are accepted and
    refused with NotPortedError."""
    table_id: str
    columns: Tuple[str, ...] = ()            # projection (empty = all)
    where: Optional[tuple] = None            # expr AST over column IDS
    aggregates: Tuple[AggSpec, ...] = ()     # aggregate pushdown
    group_by: Optional[object] = None
    join: Optional[object] = None
    window: Optional[object] = None
    pk_eq: Optional[Dict[str, object]] = None
    pk_prefix: Optional[Dict[str, object]] = None
    limit: Optional[int] = None
    paging_state: Optional[bytes] = None
    read_ht: Optional[int] = None             # read point (HybridTime.value)
    # True when the SERVER picked read_ht from its clock: only such
    # reads restart on the clock-uncertainty window
    server_assigned_read_ht: bool = False
    consistency: str = "strong"


@dataclass
class ReadResponse:
    """The reference's ReadResponse: rows, or an aggregate answer."""
    rows: List[Dict[str, object]] = field(default_factory=list)
    agg_values: Optional[tuple] = None        # scalars or per-group arrays
    group_counts: Optional[object] = None
    # hash- and dict-grouped results: per-group key values, aligned
    # with group_counts / agg_values
    group_values: Optional[tuple] = None
    paging_state: Optional[bytes] = None      # the port never pages
    # "tpu": the reference's wire value for the device pushdown backend
    backend: str = "cpu"
    # window pushdown outcome: True when `rows` carry the request's
    # window values; on a typed refusal its reason rides back instead
    window_served: bool = False
    window_reason: Optional[str] = None


class Unrewritable(Exception):
    """A string column used outside a shape the rewrite handles."""


def rewrite_where_and_aggs(where, aggs, dicts,
                           allow_dict_minmax: bool = True):
    """:func:`rewrite_strings` over a WHERE node and every AggSpec expr:
    ``(where, aggs)`` in dictionary-code space.  Raises Unrewritable.

    ``allow_dict_minmax``: MIN/MAX/COUNT over a bare dictionary column
    pass through as they are — the kernel aggregates the CODES lane
    (code order is string order) and the caller decodes the winning
    code through the scan-global dictionary."""
    if where is not None:
        where = rewrite_strings(where, dicts)
    out = []
    for a in aggs:
        e = a.expr
        if e is None:
            out.append(a)
            continue
        if allow_dict_minmax and a.op in ("min", "max", "count") \
                and isinstance(e, (tuple, list)) and e \
                and e[0] == "col" and e[1] in dicts:
            out.append(a)          # the codes lane serves it directly
            continue
        out.append(AggSpec(a.op, rewrite_strings(e, dicts)))
    return where, tuple(out)


_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq",
         "ne": "ne"}


def rewrite_strings(node, dicts):
    """Translate string predicates over the dictionary columns `dicts`
    (cid -> sorted uniq) into code space.  Raises Unrewritable when a
    string column is used outside these shapes."""
    kind = node[0]

    def is_dict_col(x):
        return (isinstance(x, (tuple, list)) and x
                and x[0] == "col" and x[1] in dicts)

    def is_const_str(x):
        return (isinstance(x, (tuple, list)) and x
                and x[0] == "const" and isinstance(x[1], str))

    if kind == "cmp":
        op, l, r = node[1], node[2], node[3]
        if is_dict_col(l) and is_const_str(r):
            d = dicts[l[1]]
            v = r[1]
            if op in ("eq", "ne"):
                i = bisect.bisect_left(d, v)
                code = i if i < len(d) and d[i] == v else -1
                return ("cmp", op, l, ("const", code))
            if op == "lt":
                return ("cmp", "lt", l, ("const", bisect.bisect_left(d, v)))
            if op == "le":
                return ("cmp", "lt", l,
                        ("const", bisect.bisect_right(d, v)))
            if op == "gt":
                return ("cmp", "ge", l,
                        ("const", bisect.bisect_right(d, v)))
            if op == "ge":
                return ("cmp", "ge", l, ("const", bisect.bisect_left(d, v)))
        if is_dict_col(r) and is_const_str(l):
            return rewrite_strings(("cmp", _FLIP[op], r, l), dicts)
        if is_dict_col(l) or is_dict_col(r):
            raise Unrewritable(node)
        # neither side is directly a string column: a nested expr may
        # hold one, so fall through to the generic walk
    elif kind == "between":
        x, lo, hi = node[1], node[2], node[3]
        if is_dict_col(x):
            if not (is_const_str(lo) and is_const_str(hi)):
                raise Unrewritable(node)
            return ("and",
                    rewrite_strings(("cmp", "ge", x, lo), dicts),
                    rewrite_strings(("cmp", "le", x, hi), dicts))
    elif kind == "in":
        x, vals = node[1], node[2]
        if is_dict_col(x):
            d = dicts[x[1]]
            codes = []
            for v in vals:
                if not isinstance(v, str):
                    raise Unrewritable(node)
                i = bisect.bisect_left(d, v)
                codes.append(int(i) if i < len(d) and d[i] == v else -1)
            return ("in", x, codes)
        # the VALUES list is not a node
        return ("in", rewrite_strings(x, dicts), vals)
    if kind in ("like", "ilike"):
        x, pattern = node[1], node[2]
        if not is_dict_col(x):
            raise Unrewritable(node)
        pat = re.compile(
            "^" + re.escape(pattern).replace("%", ".*").replace("_", ".")
            + "$", re.IGNORECASE if kind == "ilike" else 0)
        lut = [1 if pat.match(s) else 0 for s in dicts[x[1]]]
        return ("dictlut", x, lut)
    if kind == "isnull" and is_dict_col(node[1]):
        return node          # a null-mask read: codes are never compared
    if kind == "col" and node[1] in dicts:
        raise Unrewritable(node)   # a bare string column
    if kind == "const":
        return node
    out = [kind]
    for c in node[1:]:
        if isinstance(c, (tuple, list)) and c and isinstance(c[0], str):
            out.append(rewrite_strings(c, dicts))
        else:
            out.append(c)
    return tuple(out)


# --- scan options (which row reads are enumerated point gets) ---------------

_POINT_TYPES = ("int32", "int64", "timestamp", "string")
_RANGE_TYPES = ("int32", "int64", "timestamp")


def extract_scan_options(where, range_cols):
    """Multi-column skip-scan options (the reference's; upstream:
    hybrid/ScanChoices, docdb/hybrid_scan_choices.cc): walk the
    conjuncts of `where` and, following range-PK column order, collect
    per-column target sets — point sets from =/IN on the leading
    columns, then one optional numeric interval on the next column.
    Returns (point_lists, interval, residual):
      point_lists: [(ColumnSchema, sorted values)] for leading columns
      interval:    (ColumnSchema, lo, hi) inclusive (either end None)
                   or None
      residual:    conjuncts NOT consumed by the bounds (re-checked
                   row-wise), or None
    Point lists enumerate in sorted order so the segment scan preserves
    encoded-pk order (ORDER BY stays pushdown-compatible)."""
    conjuncts = []

    def flatten(n):
        if n[0] == "and":
            flatten(n[1])
            flatten(n[2])
        else:
            conjuncts.append(n)

    if where is not None:
        flatten(where)

    def col_of(n):
        # (col, const) comparisons only, either operand order
        if n[0] == "cmp":
            if n[2][0] == "col" and n[3][0] == "const":
                return n[2][1], n[1], n[3][1]
            if n[3][0] == "col" and n[2][0] == "const":
                flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                        "eq": "eq", "ne": "ne"}
                return n[3][1], flip[n[1]], n[2][1]
        return None

    def norm_point(col, v):
        """A point value an =/IN target on `col` can actually hit, or
        None. Non-integral numerics can never equal an integer column
        (consumed as provably-false, NOT truncated); type mismatches
        are rejected so the conjunct stays residual."""
        if col.type == "string":
            return v if isinstance(v, str) else None
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
        if isinstance(v, float):
            return int(v) if float(v).is_integer() else None
        return v

    used = set()
    point_lists = []
    interval = None
    for col in range_cols:
        pts = None
        lo = hi = None
        for i, n in enumerate(conjuncts):
            if i in used:
                continue
            if n[0] == "in" and n[1] == ("col", col.id) \
                    and col.type in _POINT_TYPES:
                if not all(isinstance(v, (int, float, str))
                           and not isinstance(v, bool)
                           for v in n[2] if v is not None):
                    continue       # untypeable list: stays residual
                vals = {p for v in n[2] if v is not None
                        for p in [norm_point(col, v)] if p is not None}
                pts = vals if pts is None else pts & vals
                used.add(i)
                continue
            c = col_of(n)
            if c is None or c[0] != col.id:
                continue
            op, v = c[1], c[2]
            if op == "eq" and col.type in _POINT_TYPES:
                if col.type != "string" and not isinstance(
                        v, (int, float)) or isinstance(v, bool):
                    continue       # untypeable: stays residual
                if col.type == "string" and not isinstance(v, str):
                    continue
                p = norm_point(col, v)
                new = {p} if p is not None else set()
                pts = new if pts is None else pts & new
                used.add(i)
            elif col.type in _RANGE_TYPES and op in ("ge", "gt") \
                    and isinstance(v, (int, float)) \
                    and not isinstance(v, bool):
                # integer column: k >= 4.5 means k >= 5; k > 4.5 too
                b = math.ceil(v) if op == "ge" else math.floor(v) + 1
                lo = b if lo is None else max(lo, b)
                used.add(i)
            elif col.type in _RANGE_TYPES and op in ("le", "lt") \
                    and isinstance(v, (int, float)) \
                    and not isinstance(v, bool):
                b = math.floor(v) if op == "le" else math.ceil(v) - 1
                hi = b if hi is None else min(hi, b)
                used.add(i)
        if n_between := [i for i, n in enumerate(conjuncts)
                         if i not in used and n[0] == "between"
                         and n[1] == ("col", col.id)
                         and n[2][0] == "const" and n[3][0] == "const"
                         and col.type in _RANGE_TYPES
                         and all(isinstance(n[j][1], (int, float))
                                 and not isinstance(n[j][1], bool)
                                 for j in (2, 3))]:
            for i in n_between:
                n = conjuncts[i]
                blo, bhi = math.ceil(n[2][1]), math.floor(n[3][1])
                lo = blo if lo is None else max(lo, blo)
                hi = bhi if hi is None else min(hi, bhi)
                used.add(i)
        if pts is not None:
            if lo is not None or hi is not None:
                pts = {p for p in pts
                       if (lo is None or p >= lo)
                       and (hi is None or p <= hi)}
            point_lists.append((col, sorted(pts)))
            continue
        if lo is not None or hi is not None:
            interval = (col, lo, hi)
        break       # first non-point column ends the enumerable prefix
    residual = [n for i, n in enumerate(conjuncts) if i not in used]
    if not residual:
        res = None
    else:
        res = residual[0]
        for r in residual[1:]:
            res = ("and", res, r)
    return point_lists, interval, res


# --- the read executor --------------------------------------------------------

_MAX_HT = 0xFFFFFFFFFFFFFFFF - 1

#: one scan kernel per device, shared by every DocReadOperation that is
#: not handed its own (the reference's module-level _SHARED_KERNEL)
_SHARED_KERNELS: Dict[torch.device, ScanKernel] = {}

#: sentinel from _try_streaming_aggregate: the dict-grouped scan
#: overflowed its slot budget (the monolithic pass would spill alike)
_SPILLED = object()


def shared_kernel(device: DeviceLike = "cuda") -> ScanKernel:
    dev = resolve_device(device)
    k = _SHARED_KERNELS.get(dev)
    if k is None:
        k = _SHARED_KERNELS[dev] = ScanKernel(dev)
    return k


def _skew_window_ht() -> int:
    """The clock-uncertainty window in hybrid-time units."""
    return flags.get("max_clock_skew_ms") * 1000 << 12


def _nullify_minmax(expanded, minmax, outs):
    """SQL NULL semantics for MIN/MAX over zero qualifying inputs: each
    min/max ran with a hidden companion COUNT appended after
    `expanded`; zero-count results become None on the host."""
    outs = [np.asarray(o) for o in outs]
    base, extras = outs[:len(expanded)], outs[len(expanded):]
    for j, i in enumerate(minmax):
        cnt = extras[j]
        v = base[i]
        if v.ndim == 0:
            base[i] = (np.asarray(None, object)
                       if int(cnt) == 0 else v)
        else:
            obj = v.astype(object)
            obj[np.asarray(cnt) == 0] = None
            base[i] = obj
    return tuple(base)


def dict_minmax_decode(expanded, outs, dicts):
    """Decode dict-code MIN/MAX results (the kernel min/maxes a
    dictionary column's CODES lane; code order is string order) into
    strings through the scan-global dictionary, per shard, before any
    cross-shard combine.  Out-of-range codes and None map to None."""
    if not dicts:
        return tuple(outs)
    outs = list(outs)
    for i, a in enumerate(expanded):
        if i >= len(outs) or a.op not in ("min", "max"):
            continue
        e = a.expr
        if not (isinstance(e, (tuple, list)) and e and e[0] == "col"
                and e[1] in dicts):
            continue
        d = dicts[e[1]]

        def dec(x, _d=d):
            if x is None:
                return None
            c = int(x)
            return str(_d[c]) if 0 <= c < len(_d) else None

        v = np.asarray(outs[i])
        if v.ndim == 0:
            outs[i] = np.asarray(dec(v.item()), object)
        else:
            obj = v.astype(object)
            for g in range(len(obj)):
                obj[g] = dec(obj[g])
            outs[i] = obj
    return tuple(outs)


def has_doc_nodes(node) -> bool:
    """True when an expression reads a JSON document path."""
    if not isinstance(node, (tuple, list)) or not node:
        return False
    if node[0] == "json":
        return True
    return any(has_doc_nodes(c) for c in node[1:]
               if isinstance(c, (tuple, list)))


class ReadRestartError(Exception):
    """Internal: a record inside the clock-uncertainty window was seen;
    the read restarts at restart_ht (tserver/read_query.cc)."""

    def __init__(self, restart_ht: int):
        super().__init__(f"read restart at {restart_ht}")
        self.restart_ht = restart_ht


class DocReadOperation:
    """Executes a ReadRequest against one tablet's store on `device`
    (the kernel's device when one is given)."""

    def __init__(self, codec, store, scan_kernel: Optional[ScanKernel] = None,
                 device_cache=None, device: DeviceLike = "cuda"):
        self.codec = codec
        self.store = store
        self.kernel = scan_kernel or shared_kernel(device)
        self.device = self.kernel.device
        self.device_cache = device_cache
        # restarts engage only via execute() on server-assigned points
        self._allow_restart = False

    def execute(self, req: ReadRequest) -> ReadResponse:
        if req.server_assigned_read_ht:
            for _attempt in range(3):
                try:
                    return self._execute_once(req)
                except ReadRestartError as e:
                    req.read_ht = e.restart_ht
        # explicit read points never restart; after 3 bumps serve at the
        # last restart point without further bumps
        return self._execute_once(req, allow_restart=False)

    def _execute_once(self, req: ReadRequest,
                      allow_restart: bool = True) -> ReadResponse:
        """The reference's route order: point and prefix reads, joins,
        enumerated reads, the aggregate pushdown, the filter route."""
        self._allow_restart = allow_restart and req.server_assigned_read_ht
        if req.pk_eq is not None or req.pk_prefix is not None:
            raise NotPortedError("point and prefix reads", _POINT_ITEM)
        if req.join is not None and req.aggregates:
            return self._execute_join_aggregate(req)
        filter_shape = (not req.aggregates and req.where is not None
                        and req.paging_state is None)
        if filter_shape and self._hash_enumerable(req):
            # the reference answers by MultiGet in key-enumeration order:
            # the filter route's rows would be equal but ordered apart
            raise NotPortedError("an enumerated read (=, IN or a bounded "
                                 "interval on the hash key)", _POINT_ITEM)
        if req.aggregates:
            if not self._tpu_eligible(req):
                raise NotPortedError(
                    "an aggregate the reference serves on its interpreted "
                    "path (pushdown off, under tpu_min_rows_for_pushdown, "
                    "or an expression the device cannot compile)",
                    _ROW_ITEM)
            return self._execute_tpu_aggregate(req)
        if filter_shape and self._tpu_eligible(req):
            return self._serve_window(req, self._execute_tpu_filter(req))
        raise NotPortedError(
            "a row read the reference serves on its interpreted row path "
            "(no WHERE, a paging state, pushdown off, under "
            "tpu_min_rows_for_pushdown, or an expression the device "
            "cannot compile)", _ROW_ITEM)

    def _hash_enumerable(self, req: ReadRequest) -> bool:
        """True where the reference's _hash_enumerated_read serves the
        read: a single-INTEGER-hash-PK table whose WHERE yields =, IN or
        a bounded interval on the key of at most hash_scan_enumerate_max
        keys (its applicability test, without the MultiGet)."""
        info = self.codec.info
        kcs = info.schema.key_columns
        if (len(kcs) != 1 or kcs[0].type not in ("int32", "int64")
                or info.partition_schema.kind != "hash"):
            return False
        w = req.where
        if (w is not None and w[0] == "between" and w[1][0] == "col"
                and w[1][1] == kcs[0].id and w[2][0] == "const"
                and w[3][0] == "const"
                and type(w[2][1]) is int and type(w[3][1]) is int):
            point_lists, interval = None, (kcs[0], w[2][1], w[3][1])
        else:
            point_lists, interval, _ = extract_scan_options(w, kcs)
        # constants outside the column's width never match a stored key
        kmin, kmax = ((-2**31, 2**31 - 1) if kcs[0].type == "int32"
                      else (-2**63, 2**63 - 1))
        if point_lists:
            n_keys = sum(1 for k in point_lists[0][1] if kmin <= k <= kmax)
        elif interval is not None and interval[1] is not None \
                and interval[2] is not None:
            lo = max(int(interval[1]), kmin)
            hi = min(int(interval[2]), kmax)
            n_keys = max(hi - lo + 1, 0)
        else:
            return False
        return n_keys <= flags.get("hash_scan_enumerate_max")

    def _tpu_eligible(self, req: ReadRequest) -> bool:
        if not flags.get("tpu_pushdown_enabled"):
            return False
        from ..ops.expr import device_compatible
        if self.codec.shred_cols and (
                (req.where is not None and has_doc_nodes(req.where))
                or any(a.expr is not None and has_doc_nodes(a.expr)
                       for a in req.aggregates)):
            raise NotPortedError("document-path pushdown", _DOC_ITEM)
        if req.where is not None and not device_compatible(req.where):
            return False
        for a in req.aggregates:
            if a.expr is not None and not device_compatible(a.expr):
                return False
        approx_rows = sum(r.num_entries for r in self.store.ssts)
        return approx_rows >= flags.get("tpu_min_rows_for_pushdown")

    def _collect_blocks(self) -> List[ColumnarBlock]:
        """Every columnar block across the store's SSTs (the port has no
        memtable).  Several SSTs overlap in general, so their blocks
        lose ``unique_keys`` and the scan runs in dedup mode."""
        blocks: List[ColumnarBlock] = []
        for r in self.store.ssts:
            for i in range(r.num_blocks()):
                cb = r.columnar_block(i)
                if cb is None:
                    raise NotPortedError("row-format SST blocks",
                                         _ROW_ITEM)
                blocks.append(cb)
        if len(self.store.ssts) > 1:
            for b in blocks:
                b.unique_keys = b.unique_keys and len(blocks) == 1
        return blocks

    def _batch_cache_key(self, needed) -> tuple:
        """THE device-cache key for batches over this store's current
        contents: every input of batch formation is in it (the float
        dtype flag is baked into the batch's dtypes; the SST paths stand
        for the contents, the store having no memtable).  The streamed
        route appends its chunk plan."""
        return (id(self.store), tuple(sorted(needed)),
                tuple(r.path for r in self.store.ssts),
                flags.get("device_float_dtype"), str(self.device))

    def _cached_batch(self, blocks, needed, extra: tuple = ()):
        """The batch of `needed` columns, from the device cache when
        there is one; `extra` (the zone-prune signature) extends the
        key."""
        def build():
            return build_batch(blocks, sorted(needed), device=self.device)
        if self.device_cache is None:
            return build()
        return self.device_cache.get_or_build(
            self._batch_cache_key(needed) + extra, build)

    def _zone_prune(self, blocks, where, read_ht):
        """(kept_blocks, cache_key_extra) for the monolithic route:
        sound only when every doc key lives inside one block (chunk-safe
        over the FULL list), since a read point always reaches the
        kernel here.  Tallies LAST_SCAN_PRUNE_STATS either way."""
        LAST_SCAN_PRUNE_STATS.clear()
        LAST_SCAN_PRUNE_STATS.update(blocks_total=len(blocks),
                                     blocks_pruned=0)
        if where is None or not flags.get("zone_map_pruning"):
            return blocks, ()
        from ..ops.scan import zone_prune_blocks
        from ..ops.stream_scan import chunk_safe_mvcc
        if read_ht is not None and not chunk_safe_mvcc(blocks):
            return blocks, ()
        kept, kept_idx = zone_prune_blocks(blocks, where)
        if len(kept) == len(blocks):
            return blocks, ()
        LAST_SCAN_PRUNE_STATS["blocks_pruned"] = len(blocks) - len(kept)
        return kept, ("zp", kept_idx)

    def _try_streaming_aggregate(self, req: ReadRequest, blocks, needed,
                                 read_ht: int):
        """The chunked pipelined aggregate (ops/stream_scan.py) for
        scans it serves exactly; None falls through to the monolithic
        batch; ``_SPILLED`` when a dict-grouped scan overflowed its
        slot budget."""
        if not flags.get("streaming_scan_enabled"):
            return None
        from ..ops.stream_scan import streaming_scan_aggregate
        cache = self.device_cache
        key = self._batch_cache_key(needed) if cache is not None else None
        expanded, minmax, aggs_run = expand_aggregates(req.aggregates)
        dict_group = isinstance(req.group_by, DictGroupSpec)
        grouped_out: Optional[dict] = {} if dict_group else None
        dict_out: dict = {}
        got = streaming_scan_aggregate(
            blocks, sorted(needed), req.where, aggs_run, req.group_by,
            read_ht, kernel=self.kernel, cache=cache, cache_key=key,
            grouped_out=grouped_out, dict_out=dict_out)
        if got is None:
            return None
        if dict_group and grouped_out.get("spill"):
            return _SPILLED
        # the restart check over the FULL pre-prune block list, once this
        # route serves the read
        self._check_restart_window(blocks, read_ht)
        outs, counts = got
        outs = _nullify_minmax(expanded, minmax, outs)
        outs = dict_minmax_decode(expanded, outs,
                                  dict_out.get("dicts") or {})
        if dict_group:
            from ..ops.grouped_scan import decode_slot_groups
            outs_c, counts_c, gvals = decode_slot_groups(
                req.group_by, grouped_out["dicts"], outs, counts)
            return ReadResponse(agg_values=outs_c, group_counts=counts_c,
                                group_values=gvals, backend="tpu")
        return ReadResponse(agg_values=outs, group_counts=_np(counts),
                            backend="tpu")

    def _check_restart_window(self, blocks, read_ht: int) -> None:
        """Raise ReadRestartError when any block holds a record inside
        (read_ht, read_ht + skew] — the whole-block uncertainty check of
        both aggregate routes."""
        if not (self._allow_restart and read_ht != _MAX_HT):
            return
        window_hi = read_ht + _skew_window_ht()
        for b in blocks:
            amb = b.ht[(b.ht > np.uint64(read_ht))
                       & (b.ht <= np.uint64(window_hi))]
            if len(amb):
                raise ReadRestartError(int(amb.max()))

    def _execute_tpu_aggregate(self, req: ReadRequest) -> ReadResponse:
        blocks = self._collect_blocks()
        if not blocks:
            raise NotPortedError("an aggregate over a tablet with no "
                                 "blocks", _ROW_ITEM)
        needed = needed_probe_columns(req.where, req.aggregates,
                                      req.group_by)
        if isinstance(req.group_by, DictGroupSpec) \
                and not flags.get("grouped_pushdown_enabled"):
            raise NotPortedError("the interpreted GROUP BY "
                                 "(grouped_pushdown_enabled off)",
                                 _ROW_ITEM)
        read_ht = req.read_ht if req.read_ht is not None else _MAX_HT
        resp = self._try_streaming_aggregate(req, blocks, needed, read_ht)
        if resp is _SPILLED:
            raise NotPortedError("a dictionary GROUP BY past its slot "
                                 "budget (the spill tail)", _ROW_ITEM)
        if resp is not None:
            return resp
        # zone-map pruning ahead of the monolithic batch; the restart
        # check below still reads the FULL block list
        kept, prune_key = self._zone_prune(blocks, req.where, read_ht)
        try:
            batch = self._cached_batch(kept, needed, prune_key)
        except KeyError as e:
            raise NotPortedError(f"a column with no columnar form ({e})",
                                 _ROW_ITEM) from e
        self._check_restart_window(blocks, read_ht)
        # several blocks that may hold versions of one key: dedup mode.
        # Unlike the reference, which sorts whenever there are several
        # blocks, blocks proven to be one sorted run of unique keys
        # (chunk-safe, as the streamed route requires) keep the visible
        # mode: the same rows pass, so the answer is the same, without
        # the four sort passes, and the hand route can take the read
        from ..ops.stream_scan import chunk_safe_mvcc
        if len(blocks) > 1 and not chunk_safe_mvcc(blocks):
            batch.unique_keys = False
        where = req.where
        aggregates = req.aggregates
        if where is not None or any(a.expr is not None
                                    for a in aggregates):
            # runs with no dictionaries too: a leftover 'like' must
            # refuse, not reach the kernel
            try:
                where, aggregates = rewrite_where_and_aggs(
                    where, aggregates, batch.dicts)
            except Unrewritable as e:
                raise NotPortedError(
                    "a string column outside a rewritable predicate "
                    f"shape ({e})", _ROW_ITEM) from e
        expanded, minmax, aggs_run = expand_aggregates(aggregates)

        def _nullify(outs):
            return dict_minmax_decode(
                expanded, _nullify_minmax(expanded, minmax, outs),
                batch.dicts)

        if isinstance(req.group_by, HashGroupSpec):
            outs, counts, _, gvals, n_groups = self.kernel.run(
                batch, where, aggs_run, req.group_by, read_ht)
            if int(n_groups) > req.group_by.max_groups:
                raise NotPortedError(
                    f"a hash GROUP BY past max_groups ({int(n_groups)} > "
                    f"{req.group_by.max_groups})", _ROW_ITEM)
            return ReadResponse(
                agg_values=_nullify(outs), group_counts=_np(counts),
                group_values=tuple(_np(g) for g in gvals), backend="tpu")
        if isinstance(req.group_by, DictGroupSpec):
            from ..ops.grouped_scan import decode_slot_groups, domain_product
            gspec = req.group_by
            if any(c not in batch.dicts for c in gspec.cols) or \
                    domain_product(gspec, batch.dicts) >= 2 ** 31:
                raise NotPortedError("a dictionary GROUP BY without a "
                                     "dictionary or past 2^31 slots",
                                     _ROW_ITEM)
            outs, counts, mask, spill = self.kernel.run(
                batch, where, aggs_run, gspec, read_ht)
            if int(spill) > 0:
                raise NotPortedError("a dictionary GROUP BY past its slot "
                                     "budget (the spill tail)", _ROW_ITEM)
            outs_c, counts_c, gvals = decode_slot_groups(
                gspec, batch.dicts, _nullify(outs), _np(counts))
            return ReadResponse(agg_values=outs_c, group_counts=counts_c,
                                group_values=gvals, backend="tpu")
        outs, counts, _ = self.kernel.run(
            batch, where, aggs_run, req.group_by, read_ht)
        return ReadResponse(agg_values=_nullify(outs),
                            group_counts=_np(counts), backend="tpu")

    # ---- FK-equijoin pushdown (ReadRequest.join) -------------------------
    def _join_eligible(self, req: ReadRequest) -> bool:
        if not flags.get("tpu_pushdown_enabled"):
            return False
        from ..ops.expr import device_compatible
        if req.where is not None and not device_compatible(req.where):
            return False
        for a in req.aggregates:
            if a.expr is not None and not device_compatible(a.expr):
                return False
        approx_rows = sum(r.num_entries for r in self.store.ssts)
        return approx_rows >= flags.get("tpu_min_rows_for_pushdown")

    def _execute_join_aggregate(self, req: ReadRequest) -> ReadResponse:
        """Aggregate request with a shipped build side: the fused plan
        (filter -> probe -> gather -> group -> aggregate,
        ops/plan_fusion.py) when eligible.  Where the reference answers
        on its interpreted join instead (a typed JoinIneligible, the
        flag off, a device-ineligible shape, a dict-group spill), the
        port raises NotPortedError naming the reason and the stage."""
        from ..ops.join_scan import JOIN_STATS, JoinIneligible
        if not flags.get("join_pushdown_enabled"):
            why = "join_pushdown_enabled is off"
        elif not self._join_eligible(req):
            why = ("pushdown off, under tpu_min_rows_for_pushdown, or an "
                   "expression the device cannot compile")
        else:
            try:
                resp = self._execute_fused_join(req)
            except JoinIneligible as e:
                JOIN_STATS["fallbacks"] += 1
                raise NotPortedError(
                    f"the interpreted join (the device join refused: "
                    f"{e})", _JOIN_ITEM) from e
            if resp is not None:
                return resp
            why = ("a shape the fused plan does not serve (hash group, "
                   "grouped pushdown off, no columnar form, an "
                   "unrewritable string predicate, or a dictionary "
                   "group past its slot budget)")
        raise NotPortedError(f"the interpreted join ({why})", _JOIN_ITEM)

    def _execute_fused_join(self, req: ReadRequest
                            ) -> Optional[ReadResponse]:
        from ..ops.join_scan import normalize_join
        from ..ops.plan_fusion import (default_plan_kernel,
                                       monolithic_plan_aggregate,
                                       streaming_plan_aggregate)
        group = req.group_by
        if isinstance(group, HashGroupSpec):
            return None
        dict_group = isinstance(group, DictGroupSpec)
        if dict_group and not flags.get("grouped_pushdown_enabled"):
            return None
        blocks = self._collect_blocks()
        if not blocks:
            return None
        needed = needed_probe_columns(req.where, req.aggregates, group,
                                      normalize_join(req.join))
        read_ht = req.read_ht if req.read_ht is not None else _MAX_HT
        expanded, minmax, aggs_run = expand_aggregates(req.aggregates)
        kernel = default_plan_kernel(self.device)
        cache = self.device_cache
        key = (self._batch_cache_key(needed)
               if cache is not None else None)
        gout: Optional[dict] = {} if dict_group else None
        got = None
        if flags.get("streaming_scan_enabled"):
            got = streaming_plan_aggregate(
                blocks, sorted(needed), req.where, aggs_run, group,
                read_ht, req.join, kernel=kernel, cache=cache,
                cache_key=key, grouped_out=gout)
        if got is None:
            try:
                got = monolithic_plan_aggregate(
                    blocks, sorted(needed), req.where, aggs_run,
                    group, read_ht, req.join, kernel=kernel,
                    cache=cache, cache_key=key, grouped_out=gout)
            except KeyError:
                return None   # a probe column lacks columnar form
            except Unrewritable:
                return None   # a string predicate outside the rewrite
        if dict_group and gout.get("spill"):
            from ..ops.grouped_scan import GROUPED_STATS
            GROUPED_STATS["spill_fallbacks"] += 1
            return None       # slot overflow: the interpreted join
        self._check_restart_window(blocks, read_ht)
        outs, counts = got
        outs = _nullify_minmax(expanded, minmax, outs)
        if dict_group:
            from ..ops.grouped_scan import decode_slot_groups
            outs_c, counts_c, gvals = decode_slot_groups(
                group, gout["dicts"], outs, counts)
            return ReadResponse(agg_values=outs_c,
                                group_counts=counts_c,
                                group_values=gvals, backend="tpu")
        return ReadResponse(agg_values=outs,
                            group_counts=np.asarray(counts),
                            backend="tpu")

    # ---- the filter route of row reads ------------------------------------
    def _execute_tpu_filter(self, req: ReadRequest) -> ReadResponse:
        """Filter-pushdown row scan: the WHERE mask on the device
        (streamed, or one monolithic batch after zone pruning), the
        matching rows gathered on the host from the columnar blocks in
        block order.  Where the reference falls to its interpreted row
        loop the port raises NotPortedError."""
        blocks = self._collect_blocks()
        if not blocks:
            raise NotPortedError("a row read over a tablet with no blocks",
                                 _ROW_ITEM)
        from ..ops.expr import referenced_columns
        from ..ops.stream_scan import chunk_safe_mvcc
        needed = set(referenced_columns(req.where))
        by_name = {c.name: c for c in self.codec.schema.columns}
        proj_cols = ([by_name[n] for n in req.columns] if req.columns
                     else list(self.codec.schema.columns))
        read_ht = req.read_ht if req.read_ht is not None else _MAX_HT
        resp = self._try_streaming_filter(req, blocks, needed, proj_cols,
                                          read_ht)
        if resp is not None:
            return resp
        kept, prune_key = self._zone_prune(blocks, req.where, read_ht)
        t0 = time.perf_counter()
        try:
            batch = self._cached_batch(kept, needed, prune_key)
        except KeyError as e:
            raise NotPortedError(f"a column with no columnar form ({e})",
                                 _ROW_ITEM) from e
        # several blocks that may hold versions of one key: dedup mode.
        # The reference sorts whenever there are several blocks; a
        # chunk-safe run keeps the visible mode, as the aggregate route
        # does (the same rows pass, and the cached batch stays one)
        if len(blocks) > 1 and not chunk_safe_mvcc(blocks):
            batch.unique_keys = False
        try:
            where = rewrite_strings(req.where, batch.dicts)
        except Unrewritable as e:
            raise NotPortedError("a string column outside a rewritable "
                                 f"predicate shape ({e})", _ROW_ITEM) from e
        _, _, mask = self.kernel.run(batch, where, (), None, read_ht)
        sel = np.nonzero(mask.cpu().numpy())[0]
        if req.limit is not None and len(sel) > req.limit:
            sel = sel[:req.limit]
        t1 = time.perf_counter()
        rows = self._gather_rows(kept, sel, proj_cols)
        if rows is None:
            raise NotPortedError("a projected column with no columnar "
                                 "form", _ROW_ITEM)
        _note_rows("monolithic", rows, t1 - t0, time.perf_counter() - t1)
        return ReadResponse(rows=rows, backend="tpu")

    def _try_streaming_filter(self, req: ReadRequest, blocks, needed,
                              proj_cols, read_ht: int
                              ) -> Optional[ReadResponse]:
        """The streamed filter route (ops/stream_scan.py
        streaming_scan_filter): per-chunk WHERE masks on the device while
        the next chunk's batch forms, rows gathered per chunk.  None
        falls through to the monolithic batch."""
        if not flags.get("streaming_scan_enabled"):
            return None
        # every block must hold every projected column up front: rows
        # already emitted cannot be taken back
        for b in blocks:
            for c in proj_cols:
                if not (c.id in b.fixed or c.id in b.pk
                        or c.id in b.varlen):
                    return None
        from ..ops.stream_scan import LAST_STREAM_STATS, streaming_scan_filter
        cache = self.device_cache
        key = (self._batch_cache_key(needed) + ("rows",)
               if cache is not None else None)
        gather_s = [0.0]

        def materialize(chunk_blocks, sel):
            t = time.perf_counter()
            rows = self._gather_rows(chunk_blocks, sel, proj_cols) or []
            gather_s[0] += time.perf_counter() - t
            return rows

        rows = streaming_scan_filter(
            blocks, sorted(needed), req.where, read_ht, materialize,
            limit=req.limit, kernel=self.kernel, cache=cache,
            cache_key=key)
        if rows is None:
            return None
        _note_rows("streamed", rows, LAST_STREAM_STATS["kernel_s"],
                   gather_s[0])
        return ReadResponse(rows=rows, backend="tpu")

    @staticmethod
    def _gather_rows(blocks, sel, proj_cols
                     ) -> Optional[List[Dict[str, object]]]:
        """Selected row indices (positions in the concatenated block
        list) as projected row dicts, one pass per (column, block):
        Python scalars as ``.item()`` gives them, text decoded for
        STRING, JSON and DECIMAL, raw bytes otherwise, None for nulls.
        None when a projected column has no columnar form."""
        from ..dockv.packed_row import ColumnType
        rows: List[Dict[str, object]] = [dict() for _ in range(len(sel))]
        offsets = np.cumsum([0] + [b.n for b in blocks])
        blk_of = np.searchsorted(offsets, sel, side="right") - 1
        local = sel - offsets[blk_of]
        for c in proj_cols:
            name = c.name
            is_text = c.type in (ColumnType.STRING, ColumnType.JSON,
                                 ColumnType.DECIMAL)
            for bi, b in enumerate(blocks):
                which = np.nonzero(blk_of == bi)[0]
                if not len(which):
                    continue
                li = local[which]
                if c.id in b.fixed:
                    vals, nulls = b.fixed[c.id]
                    for j, v, null in zip(which.tolist(), vals[li].tolist(),
                                          nulls[li].tolist()):
                        rows[j][name] = None if null else v
                elif c.id in b.pk:
                    for j, v in zip(which.tolist(), b.pk[c.id][li].tolist()):
                        rows[j][name] = v
                elif c.id in b.varlen:
                    ends, heap, nulls = b.varlen[c.id]
                    for j, i_ in zip(which.tolist(), li.tolist()):
                        if nulls[i_]:
                            rows[j][name] = None
                            continue
                        lo = int(ends[i_ - 1]) if i_ else 0
                        raw = heap[lo:int(ends[i_])]
                        rows[j][name] = raw.decode() if is_text else raw
                else:
                    return None
        return rows

    def _serve_window(self, req: ReadRequest,
                      resp: ReadResponse) -> ReadResponse:
        """The server-side window pushdown boundary: a row response whose
        request carries a WindowWire gets its window values attached
        here, over the tablet's own post-WHERE rows
        (ops/window_scan.serve_window_rows).  Every refusal is typed on
        the response (window_reason) and the rows serve plain."""
        if req.window is None or req.aggregates:
            return resp
        from ..ops.window_scan import (REASON_WINDOW_OFF,
                                       REASON_WINDOW_PAGED, WINDOW_STATS,
                                       WindowIneligible,
                                       default_window_kernel,
                                       serve_window_rows)
        try:
            if not flags.get("window_server_pushdown_enabled"):
                raise WindowIneligible(REASON_WINDOW_OFF)
            if req.paging_state is not None or req.limit is not None \
                    or resp.paging_state is not None:
                # a paged or limited scan serves a row SUBSET: window
                # frames need every partition row
                raise WindowIneligible(REASON_WINDOW_PAGED)
            serve_window_rows(req.window, resp.rows,
                              default_window_kernel(self.device))
        except WindowIneligible as e:
            WINDOW_STATS["fallbacks"] += 1
            resp.window_reason = e.reason
            return resp
        resp.window_served = True
        return resp


def _note_rows(route: str, rows, kernel_s: float, gather_s: float) -> None:
    LAST_ROW_STATS.clear()
    LAST_ROW_STATS.update(route=route, rows=len(rows), kernel_s=kernel_s,
                          gather_s=gather_s)
