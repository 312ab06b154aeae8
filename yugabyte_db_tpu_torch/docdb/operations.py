"""DocDB read operations: the tablet read seam's aggregate routes.

Counterpart of ``yugabyte_db_tpu/docdb/operations.py`` (the analog of
the reference's PgsqlReadOperation, src/yb/docdb/pgsql_operation.cc)
cut to what an aggregate read needs:

- ``ReadRequest`` / ``ReadResponse`` with the reference's fields;
- the dictionary rewrite of string predicates (module functions:
  ``rewrite_where_and_aggs``, ``rewrite_strings``, ``Unrewritable``);
- ``DocReadOperation`` with its restart loop (``execute``) and the
  aggregate pushdown: the streamed route (ops/stream_scan.py) or one
  monolithic batch through the device cache, zone-map pruning, the
  clock-uncertainty restart check over every block, and dense, hash
  and dictionary GROUP BY;
- the FK-equijoin pushdown (``ReadRequest.join``): the fused plan
  (ops/plan_fusion.py: filter, hash-join probe, payload gather, group,
  aggregate) on the streamed or the monolithic route.

Where the reference answers on its interpreted CPU path (its response
says ``backend == "cpu"``) the port raises ``NotPortedError`` naming
the ROADMAP.md item that brings that path: the interpreted row path and
small scans (item 9a), point, prefix and enumerated reads (item 9a),
the interpreted join — every join the device refuses with a typed
reason, the flag off, a device-ineligible shape, a dictionary-group
spill — (item 9a), windows (item 6), document shredding (item 9b).  On
every other request it answers what the reference answers.

String columns ride on the device as codes into SORTED scan-global
dictionaries, so ordering predicates map to code ranges, equality/IN to
exact codes, and LIKE to a boolean lookup table over the dictionary
(the ``dictlut`` expression node)."""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass
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
_WINDOW_ITEM = "queue 1 item 6 (windows)"
_DOC_ITEM = "queue 1 item 9b (document shredding)"

#: zone-map pruning tally of the most recent monolithic pushdown scan
#: (informational)
LAST_SCAN_PRUNE_STATS: dict = {}


@dataclass
class ReadRequest:
    """The reference's ReadRequest (the PgsqlReadRequestPB analog).  The
    port serves aggregate requests, with or without a `join` (one
    ops.join_scan.JoinWire or an ordered sequence of them); `window`,
    `pk_eq`, `pk_prefix` and row requests are accepted and refused with
    NotPortedError."""
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
    """The reference's ReadResponse cut to an aggregate answer (the
    port serves no rows, pages or windows)."""
    agg_values: Optional[tuple] = None        # scalars or per-group arrays
    group_counts: Optional[object] = None
    # hash- and dict-grouped results: per-group key values, aligned
    # with group_counts / agg_values
    group_values: Optional[tuple] = None
    # "tpu": the reference's wire value for the device pushdown backend
    backend: str = "cpu"


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
        self._allow_restart = allow_restart and req.server_assigned_read_ht
        if req.pk_eq is not None or req.pk_prefix is not None:
            raise NotPortedError("point and prefix reads", _POINT_ITEM)
        if req.join is not None and req.aggregates:
            return self._execute_join_aggregate(req)
        if not req.aggregates:
            if req.window is not None:
                raise NotPortedError("window pushdown", _WINDOW_ITEM)
            raise NotPortedError("row reads (filter and projection)",
                                 _ROW_ITEM)
        if not self._tpu_eligible(req):
            raise NotPortedError(
                "an aggregate the reference serves on its interpreted "
                "path (pushdown off, under tpu_min_rows_for_pushdown, or "
                "an expression the device cannot compile)", _ROW_ITEM)
        return self._execute_tpu_aggregate(req)

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
