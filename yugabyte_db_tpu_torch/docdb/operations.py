"""DocDB read and write operations: the tablet-level request executors.

Counterpart of ``yugabyte_db_tpu/docdb/operations.py`` (analogs of the
reference's PgsqlReadOperation / PgsqlWriteOperation,
src/yb/docdb/pgsql_operation.cc):

- ``WriteRequest`` of ``RowOp`` upserts and deletes (optionally with a
  row TTL) and ``DocWriteOperation``, which turns them into one KV
  WriteBatch at the hybrid time the write is applied at;
- ``ReadRequest`` / ``ReadResponse`` with the reference's fields, and
  ``DocReadOperation`` with its restart loop (``execute``) and the
  reference's route order: point reads (``get_row``, ``multi_get``:
  the newest visible version across the memtables and the SSTs' blooms
  and blocks), prefix scans, joins, enumerated reads on a
  single-integer hash key (batched point gets), the aggregate pushdown,
  the device filter route of row reads, and the interpreted row path
  (``_execute_cpu``: the MVCC walk over the merged store with
  skip-scan segments on range tables, ``eval_expr_py``, aggregates,
  GROUP BY, ``limit`` and ``paging_state``);
- the aggregate pushdown: the streamed route (ops/stream_scan.py) or one
  monolithic batch through the device cache, over every SST block plus
  one block built from the memtables (``_collect_blocks``; overlapping
  sources read in MVCC mode ``dedup``), zone-map pruning, the
  clock-uncertainty restart check over every block, and dense, hash and
  dictionary GROUP BY;
- the FK-equijoin pushdown (``ReadRequest.join``): the fused plan
  (ops/plan_fusion.py) on the streamed or the monolithic route, and the
  interpreted row-at-a-time join (``_execute_join_cpu``) for every shape
  the device refuses;
- the filter route of row reads with a WHERE: the row mask on the
  device, the matching rows gathered on the host, and the server-side
  window pushdown (``ReadRequest.window``, ops/window_scan.py).

Where a shape the device cannot serve exactly falls to the interpreted
paths, as in the reference.  Still refused with ``NotPortedError``: a
dictionary GROUP BY past its slot budget (the reference's spill tail,
ROADMAP.md queue 1 item 9a) and document-path pushdown (item 9b).

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
from ..dockv.key_encoding import ValueType
from ..dockv.value import ValueKind, unwrap_ttl, wrap_ttl
from ..errors import NotPortedError
from ..ops.device_batch import build_batch
from ..ops.grouped_scan import DictGroupSpec
from ..ops.scan import (AggSpec, HashGroupSpec, ScanKernel, _np,
                        expand_aggregates, needed_probe_columns)
from ..storage.columnar import ColumnarBlock, fnv64_bytes
from ..storage.lsm import WriteBatch
from ..utils import flags
from ..utils.hybrid_time import ENCODED_SIZE, DocHybridTime, HybridTime

_SPILL_ITEM = "queue 1 item 9a (the grouped spill tail)"
_DOC_ITEM = "queue 1 item 9b (document shredding)"
_HT_SUFFIX = ENCODED_SIZE + 1

#: zone-map pruning tally of the most recent monolithic pushdown scan
#: (informational)
LAST_SCAN_PRUNE_STATS: dict = {}
#: the most recent filter-route row read: route, rows out, and its host
#: seconds split between the mask kernel and the row gather
#: (informational)
LAST_ROW_STATS: dict = {}


@dataclass
class RowOp:
    # 'upsert' | 'delete' | 'insert' — at apply an 'insert' writes like
    # an upsert (the reference rejects a duplicate key before
    # replication, which the port does not have)
    kind: str
    row: Dict[str, object]         # full row for upsert; PK columns for delete
    ttl_ms: Optional[int] = None   # row TTL (None = forever)


@dataclass
class WriteRequest:
    table_id: str
    ops: List[RowOp] = field(default_factory=list)


@dataclass
class WriteResponse:
    rows_affected: int = 0


@dataclass
class ReadRequest:
    """The reference's ReadRequest (the PgsqlReadRequestPB analog):
    aggregate requests, with or without a `join` (one
    ops.join_scan.JoinWire or an ordered sequence of them), row requests
    with or without a `window` (ops.window_scan.WindowWire), full-PK
    point reads (`pk_eq`) and hash-prefix scans (`pk_prefix`)."""
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
    paging_state: Optional[bytes] = None      # resume key (exclusive)
    # "tpu": the reference's wire value for the device pushdown backend
    backend: str = "cpu"
    # window pushdown outcome: True when `rows` carry the request's
    # window values; on a typed refusal its reason rides back instead
    window_served: bool = False
    window_reason: Optional[str] = None


# --------------------------------------------------------------------------
# The interpreted expression evaluator (the CPU row paths)
# --------------------------------------------------------------------------
_IN_SET_CACHE: Dict[int, tuple] = {}


def _pg_text(v) -> str:
    """Text form for string functions/||: SQL-style, not Python repr
    (True -> 'true', Decimal prints plainly)."""
    if isinstance(v, bool):
        return "true" if v else "false"
    return v if isinstance(v, str) else str(v)


def _pg_mod(l, r):
    """PG %/mod(): truncates toward zero (Python's % floors)."""
    if isinstance(l, int) and isinstance(r, int):
        m = abs(l) % abs(r)
        return -m if l < 0 else m
    from decimal import Decimal
    return Decimal(str(l)) % Decimal(str(r))


def _as_array(v):
    """Array value: a Python list, or the JSON-text form arrays/CQL
    collections are stored as. None for NULL / non-array."""
    if v is None or isinstance(v, list):
        return v
    if isinstance(v, (str, bytes)):
        import json as _json
        try:
            out = _json.loads(v)
        except (ValueError, TypeError):
            return None
        return out if isinstance(out, list) else None
    return None


_TRUNC_FIELDS = ("year", "month", "day", "hour", "minute", "second",
                 "week")


def _date_trunc(unit: str, micros):
    """date_trunc('<unit>', ts_micros) -> micros at the truncation."""
    if micros is None:
        return None
    from datetime import datetime, timedelta, timezone
    dt = datetime.fromtimestamp(micros / 1e6, tz=timezone.utc)
    unit = unit.lower()
    if unit not in _TRUNC_FIELDS:
        raise ValueError(f"date_trunc unit {unit!r}")
    if unit == "week":
        dt = (dt - timedelta(days=dt.weekday())).replace(
            hour=0, minute=0, second=0, microsecond=0)
    elif unit == "year":
        dt = dt.replace(month=1, day=1, hour=0, minute=0, second=0,
                        microsecond=0)
    elif unit == "month":
        dt = dt.replace(day=1, hour=0, minute=0, second=0,
                        microsecond=0)
    elif unit == "day":
        dt = dt.replace(hour=0, minute=0, second=0, microsecond=0)
    elif unit == "hour":
        dt = dt.replace(minute=0, second=0, microsecond=0)
    elif unit == "minute":
        dt = dt.replace(second=0, microsecond=0)
    else:                                  # second
        dt = dt.replace(microsecond=0)
    return int(dt.timestamp() * 1_000_000)


def _extract_field(field: str, micros):
    """EXTRACT(<field> FROM ts_micros) (reference: PG timestamp_part)."""
    if micros is None:
        return None
    from datetime import datetime, timezone
    dt = datetime.fromtimestamp(micros / 1e6, tz=timezone.utc)
    f = field.lower()
    if f == "epoch":
        return micros / 1e6
    if f == "year":
        return dt.year
    if f == "month":
        return dt.month
    if f == "day":
        return dt.day
    if f == "hour":
        return dt.hour
    if f == "minute":
        return dt.minute
    if f == "second":
        return dt.second + dt.microsecond / 1e6
    if f == "dow":
        return (dt.weekday() + 1) % 7      # PG: Sunday = 0
    if f == "doy":
        return dt.timetuple().tm_yday
    if f == "week":
        return dt.isocalendar()[1]
    raise ValueError(f"EXTRACT field {field!r}")


def eval_expr_py(node: tuple, row: Dict[int, object]):
    """Evaluate the pushdown AST over one row ({col_id: value}); returns
    value or None for SQL NULL."""
    kind = node[0]
    if kind == "col":
        return row.get(node[1])
    if kind == "case":
        n = node[1]
        for i in range(n):
            if eval_expr_py(node[2 + 2 * i], row) is True:
                return eval_expr_py(node[3 + 2 * i], row)
        return eval_expr_py(node[2 + 2 * n], row)
    if kind == "const":
        return node[1]
    if kind == "cmp":
        l = eval_expr_py(node[2], row)
        r = eval_expr_py(node[3], row)
        if l is None or r is None:
            return None
        return {"lt": l < r, "le": l <= r, "gt": l > r, "ge": l >= r,
                "eq": l == r, "ne": l != r}[node[1]]
    if kind == "arith":
        l = eval_expr_py(node[2], row)
        r = eval_expr_py(node[3], row)
        if l is None or r is None:
            return None
        if node[1] == "concat":
            # PG ||: text concat, array||array, array||elem, elem||array
            if isinstance(l, list) or isinstance(r, list):
                al, ar = _as_array(l), _as_array(r)
                if al is not None and ar is not None:
                    return al + ar
                if al is not None:
                    return al + [r]
                return [l] + ar
            return _pg_text(l) + _pg_text(r)
        # Decimal refuses mixed arithmetic with float: promote the
        # other operand (comparisons already allow the mix)
        from decimal import Decimal
        if isinstance(l, Decimal) != isinstance(r, Decimal):
            if isinstance(l, Decimal):
                r = Decimal(str(r))
            else:
                l = Decimal(str(l))
        # dispatch lazily: an eager dict literal would evaluate EVERY
        # op (div-by-zero on add, str-minus-str on concat, ...)
        op = node[1]
        if op == "add":
            return l + r
        if op == "sub":
            return l - r
        if op == "mul":
            return l * r
        if op == "div":
            return l / r
        if op == "mod":
            return _pg_mod(l, r)
        raise ValueError(op)
    if kind == "and":
        l = eval_expr_py(node[1], row)
        r = eval_expr_py(node[2], row)
        if l is False or r is False:
            return False
        if l is None or r is None:
            return None
        return l and r
    if kind == "or":
        l = eval_expr_py(node[1], row)
        r = eval_expr_py(node[2], row)
        if l is True or r is True:
            return True
        if l is None or r is None:
            return None
        return l or r
    if kind == "not":
        v = eval_expr_py(node[1], row)
        return None if v is None else not v
    if kind == "between":
        x = eval_expr_py(node[1], row)
        lo = eval_expr_py(node[2], row)
        hi = eval_expr_py(node[3], row)
        if x is None or lo is None or hi is None:
            return None
        return lo <= x <= hi
    if kind == "in":
        x = eval_expr_py(node[1], row)
        if x is None:
            return None
        vals = node[2]
        if len(vals) > 32:
            # large lists (IN-subquery results): one set build per node,
            # O(1) membership per row; the entry keeps a strong ref to
            # the node so its id stays valid for the cache's lifetime
            ent = _IN_SET_CACHE.get(id(node))
            if ent is None or ent[0] is not node:
                if len(_IN_SET_CACHE) > 128:
                    _IN_SET_CACHE.clear()
                ent = (node, set(vals))
                _IN_SET_CACHE[id(node)] = ent
            if x in ent[1]:
                return True
            # SQL 3VL: x IN (..., NULL) is UNKNOWN on a non-match —
            # which matters under NOT IN (PG returns zero rows)
            return None if None in ent[1] else False
        if x in vals:
            return True
        return None if any(v is None for v in vals) else False
    if kind == "isnull":
        return eval_expr_py(node[1], row) is None
    if kind == "isdistinct":
        a = eval_expr_py(node[1], row)
        b = eval_expr_py(node[2], row)
        # null-safe: NULL is not distinct from NULL (never returns NULL)
        if a is None or b is None:
            return (a is None) != (b is None)
        return a != b
    if kind in ("like", "ilike"):
        import re as _re
        v = eval_expr_py(node[1], row)
        if v is None:
            return None
        pat = "^" + _re.escape(node[2]).replace("%", ".*").replace(
            "_", ".") + "$"
        # note: escape() escaped % and _ as literals? re.escape leaves %
        # and _ unescaped in Python 3.7+, so the replace above is correct
        return _re.match(pat, str(v),
                         _re.IGNORECASE if kind == "ilike" else 0) \
            is not None
    if kind == "array":
        # ARRAY[...] with non-constant elements; NULL elements kept
        return [eval_expr_py(a, row) for a in node[1:]]
    if kind == "anyall":
        # ('anyall', 'any'|'all', cmpop, lhs, arr) — PG x <op> ANY/ALL
        # with SQL three-valued semantics over NULL elements
        lhs = eval_expr_py(node[3], row)
        arr = _as_array(eval_expr_py(node[4], row))
        if lhs is None or arr is None:
            return None
        import operator as _op
        cmp = {"lt": _op.lt, "le": _op.le, "gt": _op.gt, "ge": _op.ge,
               "eq": _op.eq, "ne": _op.ne}[node[2]]
        saw_null = False
        for e in arr:
            if e is None:
                saw_null = True
                continue
            hit = cmp(lhs, e)
            if node[1] == "any" and hit:
                return True
            if node[1] == "all" and not hit:
                return False
        if saw_null:
            return None
        return node[1] == "all"
    if kind == "fn":
        # scalar functions, row-wise on the CPU path (reference: the
        # ybgate-linked PG function library, docdb/docdb_pgapi.cc)
        name = node[1]
        if name == "now":
            # normally constant-folded at bind time; name-evaluated
            # contexts (CTE rows, join residuals) land here
            import time as _time
            return int(_time.time() * 1_000_000)
        args = [eval_expr_py(a, row) for a in node[2:]]
        if name == "coalesce":
            for a in args:
                if a is not None:
                    return a
            return None
        if name == "array_prepend":
            # PG prepends a NULL element rather than returning NULL
            arr = _as_array(args[1])
            return None if arr is None else [args[0]] + arr
        if name == "array_append":
            # the appended ELEMENT may be SQL NULL
            arr = _as_array(args[0])
            return None if arr is None else arr + [args[1]]
        if name == "concat":
            # PG concat() skips NULLs (unlike ||)
            return "".join(_pg_text(a) for a in args if a is not None)
        if name == "nullif":
            if args[0] is None:
                return None
            return None if args[0] == args[1] else args[0]
        if name in ("greatest", "least"):
            vals = [a for a in args if a is not None]
            if not vals:
                return None
            return max(vals) if name == "greatest" else min(vals)
        if any(a is None for a in args):
            return None          # strict functions: NULL in -> NULL out
        a0 = args[0] if args else None
        if name == "abs":
            return abs(a0)
        if name == "round":
            # PG rounds half AWAY from zero; Python round() is
            # half-to-even
            from decimal import ROUND_HALF_UP, Decimal
            nd = int(args[1]) if len(args) > 1 and args[1] is not None \
                else 0
            q = Decimal(1).scaleb(-nd)
            r = Decimal(str(a0)).quantize(q, ROUND_HALF_UP)
            if isinstance(a0, Decimal):
                return r
            return float(r) if isinstance(a0, float) and nd > 0 \
                else float(r) if isinstance(a0, float) else int(r)
        if name == "floor":
            import math
            return math.floor(a0)
        if name == "ceil":
            import math
            return math.ceil(a0)
        if name == "upper":
            return str(a0).upper()
        if name == "lower":
            return str(a0).lower()
        if name == "length":
            return len(a0)
        if name == "cast_numeric":
            from decimal import Decimal
            return a0 if isinstance(a0, Decimal) else Decimal(str(a0))
        if name in ("cast_bigint", "cast_int", "cast_integer",
                    "cast_int8", "cast_int4", "cast_smallint"):
            if isinstance(a0, int):
                return a0          # never round-trip int64 through f64
            from decimal import ROUND_HALF_UP, Decimal
            return int(Decimal(str(a0)).to_integral_value(ROUND_HALF_UP))
        if name in ("cast_double", "cast_float8", "cast_float",
                    "cast_real", "cast_float4"):
            return float(a0)
        if name in ("cast_text", "cast_varchar", "cast_string"):
            return str(a0)
        if name in ("substr", "substring"):
            st = int(args[1])
            ln = int(args[2]) if len(args) > 2 and args[2] is not None \
                else None
            sv = _pg_text(a0)
            # PG: 1-based; start may be <= 0 (consumes length)
            begin = st - 1
            end = None if ln is None else begin + ln
            begin = max(begin, 0)
            if end is not None and end < begin:
                end = begin
            return sv[begin:end]
        if name == "replace":
            return _pg_text(a0).replace(_pg_text(args[1]),
                                        _pg_text(args[2]))
        if name == "trim":
            return _pg_text(a0).strip(
                _pg_text(args[1]) if len(args) > 1 else None)
        if name == "ltrim":
            return _pg_text(a0).lstrip(
                _pg_text(args[1]) if len(args) > 1 else None)
        if name == "rtrim":
            return _pg_text(a0).rstrip(
                _pg_text(args[1]) if len(args) > 1 else None)
        if name == "strpos":
            return _pg_text(a0).find(_pg_text(args[1])) + 1
        if name == "left":
            n_ = int(args[1])
            sv = _pg_text(a0)
            return sv[:n_] if n_ >= 0 else sv[:len(sv) + n_]
        if name == "right":
            n_ = int(args[1])
            sv = _pg_text(a0)
            if n_ == 0:
                return ""
            # n < 0: all but the first |n| characters (PG semantics)
            return sv[-n_:] if n_ > 0 else sv[abs(n_):]
        if name == "lpad":
            sv, width = _pg_text(a0), int(args[1])
            fill = _pg_text(args[2]) if len(args) > 2 else " "
            if len(sv) >= width:
                return sv[:width]
            pad = (fill * width)[:width - len(sv)]
            return pad + sv
        if name == "rpad":
            sv, width = _pg_text(a0), int(args[1])
            fill = _pg_text(args[2]) if len(args) > 2 else " "
            if len(sv) >= width:
                return sv[:width]
            return sv + (fill * width)[:width - len(sv)]
        if name == "split_part":
            parts = _pg_text(a0).split(_pg_text(args[1]))
            i_ = int(args[2])
            return parts[i_ - 1] if 1 <= i_ <= len(parts) else ""
        if name == "starts_with":
            return _pg_text(a0).startswith(_pg_text(args[1]))
        if name == "initcap":
            import re as _re2
            return _re2.sub(r"[A-Za-z0-9]+",
                            lambda m: m.group(0).capitalize(),
                            _pg_text(a0))
        if name == "reverse":
            return _pg_text(a0)[::-1]
        if name == "subscript":
            # PG arrays are 1-based; out-of-bounds -> NULL
            arr = _as_array(a0)
            idx = args[1]
            if arr is None or idx is None:
                return None
            i = int(idx)
            return arr[i - 1] if 1 <= i <= len(arr) else None
        if name in ("array_length", "cardinality"):
            arr = _as_array(a0)
            if arr is None:
                return None
            if name == "array_length" and len(args) > 1 \
                    and args[1] not in (None, 1):
                return None     # 1-D arrays only
            return len(arr) if arr else (0 if name == "cardinality"
                                         else None)
        if name == "array_position":
            arr = _as_array(a0)
            if arr is None:
                return None
            try:
                return arr.index(args[1]) + 1
            except ValueError:
                return None
        if name == "trunc":
            from decimal import ROUND_DOWN, Decimal
            nd = int(args[1]) if len(args) > 1 and args[1] is not None \
                else 0
            q = Decimal(1).scaleb(-nd)
            r = Decimal(str(a0)).quantize(q, ROUND_DOWN)
            if isinstance(a0, Decimal):
                return r
            return float(r) if isinstance(a0, float) else int(r)
        if name == "sqrt":
            import math
            return math.sqrt(a0)
        if name == "power":
            from decimal import Decimal
            if isinstance(a0, Decimal) or isinstance(args[1], Decimal):
                return Decimal(str(a0)) ** Decimal(str(args[1]))
            return a0 ** args[1]
        if name == "mod":
            if args[1] is None:
                return None
            return _pg_mod(a0, args[1])
        if name == "date_trunc":
            return _date_trunc(str(a0), args[1])
        if name.startswith("extract_"):
            return _extract_field(name[len("extract_"):], a0)
        raise ValueError(f"unknown function {name}")
    if kind == "json":
        # ('json', 'text'|'value', expr, key) — PG ->> / -> semantics
        import json as _json
        v = eval_expr_py(node[2], row)
        if v is None:
            return None
        try:
            obj = _json.loads(v) if isinstance(v, (str, bytes)) else v
        except (ValueError, TypeError):
            return None
        key = node[3]
        if isinstance(obj, dict):
            out = obj.get(key)
        elif isinstance(obj, list) and isinstance(key, int):
            out = obj[key] if -len(obj) <= key < len(obj) else None
        else:
            return None
        if out is None:
            return None
        if node[1] == "text":
            return out if isinstance(out, str) else _json.dumps(out)
        return out if isinstance(out, (str, bytes)) else _json.dumps(out)
    raise ValueError(f"unknown node {kind}")


class DocWriteOperation:
    """Converts row ops into a KV WriteBatch at apply time (the hybrid
    time is assigned when the Raft operation is applied — reference:
    tablet/tablet.cc ApplyRowOperations)."""

    def __init__(self, codec, request: WriteRequest):
        self.codec = codec
        self.request = request

    def apply(self, ht: HybridTime, op_id=None) -> Tuple[WriteBatch, int]:
        batch = WriteBatch(op_id=op_id)
        wid = 0
        for op in self.request.ops:
            dht = DocHybridTime(ht, wid)
            if op.kind in ("upsert", "insert"):
                # 'insert' duplicates were rejected on the leader before
                # replication; at apply it writes like an upsert
                k, v = self.codec.encode_write(op.row, dht)
                if op.ttl_ms:
                    expire = ht.add_micros(op.ttl_ms * 1000).value
                    v = wrap_ttl(v, expire)
            elif op.kind == "delete":
                k, v = self.codec.encode_delete(op.row, dht)
            else:
                raise ValueError(op.kind)
            batch.put(k, v)
            wid += 1
        return batch, len(self.request.ops)



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
_MAX_SKIP_SEGMENTS = 4096


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


def classify_scan_options(schema, partition_kind: str, where):
    """Shared skip-scan eligibility + shape, used by BOTH execution
    (_scan_segments) and EXPLAIN so the reported plan can never drift
    from what runs. Returns (kind, point_lists, interval, residual,
    nseg) with kind in:
      "seq"   — plain scan, residual = the original where
      "empty" — provably-empty target set
      "skip"  — enumerable point segments (nseg of them)
      "range" — leading-interval bounds only
    """
    if partition_kind != "range" or where is None or \
            any(c.sort_desc for c in schema.key_columns):
        return ("seq", None, None, where, 0)
    point_lists, interval, residual = extract_scan_options(
        where, schema.key_columns)
    if not point_lists and interval is None:
        return ("seq", None, None, where, 0)
    total = 1
    for _c, vals in point_lists:
        total *= len(vals)
        if total > _MAX_SKIP_SEGMENTS:
            # too many combinations to enumerate: full scan +
            # row-wise filter (no silent cap on correctness)
            return ("seq", None, None, where, 0)
    if point_lists and total == 0:
        return ("empty", point_lists, interval, residual, 0)
    return ("skip" if point_lists else "range",
            point_lists, interval, residual, total)


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

    # ---- point lookup ----------------------------------------------------
    def _mem_best(self, prefix: bytes, read_ht: int, restart_hi, mems):
        """Newest visible memtable version of one doc key as a
        (ht, write_id, key, value, None, None) tuple, or None."""
        plen = len(prefix)
        kht = ValueType.kHybridTime
        best = None
        for m in mems:
            if not m.may_contain_row(prefix):
                continue    # O(1) negative guard: most probes on
                #             read-heavy workloads miss the memtable
            for k, v in m.seek(prefix):
                if not k.startswith(prefix) or k[plen] != kht:
                    break
                dht = DocHybridTime.decode_desc(k[-ENCODED_SIZE:])
                ht = dht.ht.value
                if ht > read_ht:
                    if restart_hi is not None and ht <= restart_hi:
                        # concurrent write inside the uncertainty
                        # window: the writer's clock may be ahead
                        raise ReadRestartError(ht)
                    continue
                if best is None or (ht, dht.write_id) > best[:2]:
                    best = (ht, dht.write_id, k, v, None, None)
                break
        return best

    def _find_best(self, prefix: bytes, read_ht: int, restart_hi,
                   mems, ssts):
        """Newest visible version tuple (ht, write_id, key, value,
        block, pos) of one doc key across the snapshot, or None."""
        best = self._mem_best(prefix, read_ht, restart_hi, mems)
        h = fnv64_bytes(prefix)
        for r in ssts:
            if not r.may_contain_hash(h):
                continue
            found = r.point_find(prefix, read_ht, restart_hi)
            if found is None:
                continue
            if found[0] == "restart":
                raise ReadRestartError(found[1])
            c = found[1:]
            if best is None or c[:2] > best[:2]:
                best = c
        return best

    def _decode_best(self, best, read_ht: int, want=None):
        """The row of a winning version (None for a tombstone or an
        expired TTL); `want` limits a columnar winner's decode to those
        columns (the caller projects onto them)."""
        _, _, k, v, cb, pos = best
        if cb is not None:
            # columnar winner: direct single-row decode (no TTL wrapper
            # possible — TTL'd blocks never get a columnar sidecar)
            return self.codec.decode_block_row(cb, pos, k, want)
        v, expire = unwrap_ttl(v)
        if expire is not None and expire <= read_ht:
            return None
        return self.codec.decode_row(k, v)

    def get_row(self, pk_row: Dict[str, object], read_ht: int
                ) -> Optional[Dict[str, object]]:
        """Newest visible version across the memtables and SSTs, through
        each SST's bloom filter and an in-block walk (reference:
        DocDBTableReader point-get over BlockBasedTable::Get)."""
        prefix = self.codec.doc_key_prefix(pk_row)
        restart_hi = (read_ht + _skew_window_ht()
                      if self._allow_restart else None)
        mems, ssts = self.store.read_snapshot()
        best = self._find_best(prefix, read_ht, restart_hi, mems, ssts)
        if best is None:
            return None
        return self._decode_best(best, read_ht)

    def multi_get(self, pk_rows: Sequence[Dict[str, object]],
                  read_ht: int, allow_restart: bool = False,
                  columns=None) -> List[Optional[Dict[str, object]]]:
        """Batched point lookups: one snapshot, one restart window, one
        result list (reference analog: operation buffering in pggate,
        src/yb/yql/pggate/pg_operation_buffer.cc, and MultiGet-style
        batched reads).  With `columns`, a row read from a columnar
        block holds at least those columns (the caller projects)."""
        restart_hi = (read_ht + _skew_window_ht()
                      if allow_restart else None)
        mems, ssts = self.store.read_snapshot()
        want = tuple(columns) if columns else None
        out: List[Optional[Dict[str, object]]] = []
        prefix_of = self.codec.doc_key_prefix
        for r in pk_rows:
            f = self._find_best(prefix_of(r), read_ht, restart_hi, mems,
                                ssts)
            out.append(None if f is None
                       else self._decode_best(f, read_ht, want))
        return out

    # ---- scans -----------------------------------------------------------
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
        if req.pk_eq is not None:
            read_ht = req.read_ht if req.read_ht is not None else _MAX_HT
            row = self.get_row(req.pk_eq, read_ht)
            rows = [self._project(row, req.columns)] if row is not None else []
            return ReadResponse(rows=rows, backend="cpu")
        if req.pk_prefix is not None:
            return self._prefix_scan(req)
        if req.join is not None and req.aggregates:
            return self._execute_join_aggregate(req)
        if (not req.aggregates and req.where is not None
                and req.paging_state is None):
            got = self._hash_enumerated_read(req)
            if got is not None:
                return self._serve_window(req, got)
        if req.aggregates and self._tpu_eligible(req):
            resp = self._execute_tpu_aggregate(req)
            if resp is not None:
                return resp
        if (not req.aggregates and req.where is not None
                and req.paging_state is None and self._tpu_eligible(req)):
            resp = self._execute_tpu_filter(req)
            if resp is not None:
                return self._serve_window(req, resp)
        return self._serve_window(req, self._execute_cpu(req))

    def _prefix_scan(self, req: ReadRequest) -> ReadResponse:
        """All visible rows whose doc key starts with the hash prefix
        (secondary-index lookup path)."""
        read_ht = req.read_ht if req.read_ht is not None else _MAX_HT
        prefix = self.codec.hash_prefix(req.pk_prefix)
        rows_out: List[Dict[str, object]] = []
        cur_prefix = None
        chosen = False
        for k, v in self.store.iterate(lower=prefix):
            if not k.startswith(prefix):
                break
            marker = len(k) - _HT_SUFFIX
            p = k[:marker]
            if p != cur_prefix:
                cur_prefix = p
                chosen = False
            if chosen:
                continue
            dht = DocHybridTime.decode_desc(k[-ENCODED_SIZE:])
            if dht.ht.value > read_ht:
                continue
            chosen = True
            v, expire = unwrap_ttl(v)
            if expire is not None and expire <= read_ht:
                continue
            if v[0] == ValueKind.kTombstone:
                continue
            row = self.codec.decode_row(k, v)
            if row is not None:
                rows_out.append(self._project(row, req.columns))
                if req.limit is not None and len(rows_out) >= req.limit:
                    break
        return ReadResponse(rows=rows_out, backend="cpu")

    def _hash_enumerated_read(self, req: ReadRequest):
        """Short-range scans on a single-INTEGER-hash-PK table become
        batched point gets: hash sharding cannot seek key ranges, but a
        small enumerable target set (BETWEEN span, IN list, =) IS a
        MultiGet — the YCSB-E shape (reference: point segments in
        docdb/hybrid_scan_choices.cc; rocksdb MultiGet). Returns a
        ReadResponse or None when the shape doesn't apply."""
        schema = self.codec.info.schema
        kcs = schema.key_columns
        if (len(kcs) != 1 or kcs[0].type not in ("int32", "int64")
                or self.codec.info.partition_schema.kind != "hash"):
            return None
        w = req.where
        if (w is not None and w[0] == "between" and w[1][0] == "col"
                and w[1][1] == kcs[0].id and w[2][0] == "const"
                and w[3][0] == "const"
                and type(w[2][1]) is int and type(w[3][1]) is int):
            # the hot shape (YCSB-E: BETWEEN k AND k+9 on the int PK)
            # skips the generic conjunct walk entirely
            point_lists, interval, residual = \
                None, (kcs[0], w[2][1], w[3][1]), None
        else:
            point_lists, interval, residual = extract_scan_options(
                req.where, kcs)
        # constants outside the column's width can never match a stored
        # key (and would overflow the key encoder) — clamp/drop them,
        # matching what the row-wise filter would return
        kmin, kmax = ((-2**31, 2**31 - 1) if kcs[0].type == "int32"
                      else (-2**63, 2**63 - 1))
        if point_lists:
            keys = [k for k in point_lists[0][1] if kmin <= k <= kmax]
        elif interval is not None and interval[1] is not None \
                and interval[2] is not None:
            lo = max(int(interval[1]), kmin)
            hi = min(int(interval[2]), kmax)
            if hi - lo + 1 > flags.get("hash_scan_enumerate_max"):
                return None
            keys = range(lo, hi + 1)
        else:
            return None
        if len(keys) > flags.get("hash_scan_enumerate_max"):
            return None
        name = kcs[0].name
        read_ht = req.read_ht if req.read_ht is not None else _MAX_HT
        # residual predicates read their own columns: decode only the
        # projection when the bounds consumed the whole WHERE
        want = tuple(req.columns) if (req.columns and residual is None) \
            else None
        rows = self.multi_get([{name: int(k)} for k in keys], read_ht,
                              allow_restart=self._allow_restart,
                              columns=want)
        by_id = {c.name: c.id for c in schema.columns}
        out = []
        for r in rows:
            if r is None:
                continue
            if residual is not None:
                idrow = {by_id[n]: v for n, v in r.items()}
                if eval_expr_py(residual, idrow) is not True:
                    continue
            out.append(self._project(r, req.columns))
            if req.limit is not None and len(out) >= req.limit:
                break
        return ReadResponse(rows=out, backend="cpu")

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

    def _collect_blocks(self) -> Optional[List[ColumnarBlock]]:
        """Every columnar block across the store's SSTs, plus one block
        built from the memtables' entries; None when a source has no
        columnar form (a row block without a sidecar, or a memtable
        holding a TTL'd value).  Overlapping sources lose
        ``unique_keys``, so the scan runs in dedup mode."""
        blocks: List[ColumnarBlock] = []
        ssts = self.store.ssts
        for r in ssts:
            for i in range(r.num_blocks()):
                cb = r.columnar_block(i)
                if cb is None:
                    return None
                blocks.append(cb)
        mem_entries = []
        for m in self.store.memtables():
            mem_entries += list(m.iterate())
        if mem_entries:
            mem_entries.sort()
            cb = self.codec.columnar_builder(mem_entries)
            if cb is None:
                return None
            cb.unique_keys = False  # overlaps the SSTs in general
            blocks.append(cb)
        if len(ssts) > 1 or (mem_entries and ssts):
            for b in blocks:
                b.unique_keys = b.unique_keys and len(blocks) == 1
        return blocks

    def _batch_cache_key(self, needed) -> tuple:
        """THE device-cache key for batches over this store's current
        contents: every input of batch formation is in it (the float
        dtype flag is baked into the batch's dtypes; the SST paths and
        the write generation stand for the contents, so a cached batch
        never hides a newer committed write).  The streamed route
        appends its chunk plan."""
        return (id(self.store), tuple(sorted(needed)),
                tuple(r.path for r in self.store.ssts),
                self.store.write_generation(),
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

    def _execute_tpu_aggregate(self, req: ReadRequest
                               ) -> Optional[ReadResponse]:
        """The aggregate pushdown; None where the reference falls to its
        interpreted path (no columnar form, grouped pushdown off, a
        string shape outside the rewrite, a hash GROUP BY past
        max_groups, a dictionary GROUP BY without a dictionary)."""
        blocks = self._collect_blocks()
        if not blocks:
            return None
        needed = needed_probe_columns(req.where, req.aggregates,
                                      req.group_by)
        if isinstance(req.group_by, DictGroupSpec) \
                and not flags.get("grouped_pushdown_enabled"):
            return None     # the interpreted GROUP BY
        read_ht = req.read_ht if req.read_ht is not None else _MAX_HT
        resp = self._try_streaming_aggregate(req, blocks, needed, read_ht)
        if resp is _SPILLED:
            raise NotPortedError("a dictionary GROUP BY past its slot "
                                 "budget (the spill tail)", _SPILL_ITEM)
        if resp is not None:
            return resp
        # zone-map pruning ahead of the monolithic batch; the restart
        # check below still reads the FULL block list
        kept, prune_key = self._zone_prune(blocks, req.where, read_ht)
        try:
            batch = self._cached_batch(kept, needed, prune_key)
        except KeyError:
            return None     # a column with no columnar form
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
            except Unrewritable:
                return None   # a string column outside the rewrite
        expanded, minmax, aggs_run = expand_aggregates(aggregates)

        def _nullify(outs):
            return dict_minmax_decode(
                expanded, _nullify_minmax(expanded, minmax, outs),
                batch.dicts)

        if isinstance(req.group_by, HashGroupSpec):
            outs, counts, _, gvals, n_groups = self.kernel.run(
                batch, where, aggs_run, req.group_by, read_ht)
            if int(n_groups) > req.group_by.max_groups:
                return None     # distinct-group overflow
            return ReadResponse(
                agg_values=_nullify(outs), group_counts=_np(counts),
                group_values=tuple(_np(g) for g in gvals), backend="tpu")
        if isinstance(req.group_by, DictGroupSpec):
            from ..ops.grouped_scan import decode_slot_groups, domain_product
            gspec = req.group_by
            if any(c not in batch.dicts for c in gspec.cols) or \
                    domain_product(gspec, batch.dicts) >= 2 ** 31:
                return None     # no dictionary, or the gid would wrap
            outs, counts, mask, spill = self.kernel.run(
                batch, where, aggs_run, gspec, read_ht)
            if int(spill) > 0:
                raise NotPortedError("a dictionary GROUP BY past its slot "
                                     "budget (the spill tail)",
                                     _SPILL_ITEM)
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
        ops/plan_fusion.py) when eligible, the interpreted row-at-a-time
        join otherwise: typed JoinIneligible refusals and every
        device-ineligible shape land on the same interpreted path, so
        the answer never depends on which path ran."""
        from ..ops.join_scan import JOIN_STATS, JoinIneligible
        if flags.get("join_pushdown_enabled") and \
                self._join_eligible(req):
            try:
                resp = self._execute_fused_join(req)
                if resp is not None:
                    return resp
            except JoinIneligible:
                JOIN_STATS["fallbacks"] += 1
        return self._execute_join_cpu(req)

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

    def _iter_visible_idrows(self, read_ht: int):
        """Newest visible version of every row as a {col_id: value}
        dict — the interpreted scan loop the CPU join path feeds on
        (same MVCC walk as _execute_cpu, minus segments/paging, which
        join requests never carry)."""
        table_prefix = self.codec.scan_prefix()
        name_to_id = {c.name: c.id for c in self.codec.schema.columns}
        cur_prefix = None
        chosen = False
        for k, v in self.store.iterate(lower=table_prefix or None):
            if table_prefix and not k.startswith(table_prefix):
                break
            marker = len(k) - _HT_SUFFIX
            prefix = k[:marker]
            if prefix != cur_prefix:
                cur_prefix = prefix
                chosen = False
            if chosen:
                continue
            dht = DocHybridTime.decode_desc(k[-ENCODED_SIZE:])
            if dht.ht.value > read_ht:
                if self._allow_restart and \
                        dht.ht.value <= read_ht + _skew_window_ht():
                    raise ReadRestartError(dht.ht.value)
                continue
            chosen = True
            v, expire = unwrap_ttl(v)
            if expire is not None and expire <= read_ht:
                continue
            if v[0] == ValueKind.kTombstone:
                continue
            row = self.codec.decode_row(k, v)
            if row is None:
                continue
            yield {name_to_id[n]: val for n, val in row.items()}

    def _execute_join_cpu(self, req: ReadRequest) -> ReadResponse:
        """Interpreted FK-equijoin aggregate: row-at-a-time probe scan,
        a Python dict over each stage's shipped build keys, payload
        values merged into the row under their build-column ids, stages
        folded LEFT TO RIGHT (a chain stage probes a payload column an
        earlier stage merged in) — the correctness reference the fused
        plan is tested against and the fallback for every ineligible
        shape, one wire or many."""
        from ..ops.join_scan import normalize_join
        wires = normalize_join(req.join)
        read_ht = req.read_ht if req.read_ht is not None else _MAX_HT
        stages = []
        for wire in wires:
            keys = np.asarray(wire.keys)
            # key -> ALL matching build rows: duplicate build keys (a
            # shape the device path refuses with a typed reason) keep
            # full SQL inner-join semantics here — one output row per
            # matching build row, never a silent last-wins overwrite
            lookup: Dict[object, list] = {}
            for i in range(len(keys)):
                k = keys[i]
                lookup.setdefault(
                    k.item() if isinstance(k, np.generic) else k,
                    []).append(i)
            payload = {}
            for bid, (vals, nls) in wire.payload.items():
                vals = np.asarray(vals)
                nls = (np.asarray(nls, bool) if nls is not None
                       else np.zeros(len(keys), bool))
                payload[bid] = (vals, nls)
            stages.append((wire.probe_col, lookup, payload))
        aggs = list(_expand_avg_cpu(req.aggregates))
        agg_state = [_agg_init(a) for a in aggs]
        group_state: Dict[object, list] = {}

        def fold(idrow, si):
            if si == len(stages):
                _agg_accumulate(aggs, agg_state, group_state,
                                req.group_by, idrow)
                return
            probe_col, lookup, payload = stages[si]
            fk = idrow.get(probe_col)
            if fk is None:
                return                   # NULL FK never matches
            matches = lookup.get(fk)
            if matches is None:
                return                   # dangling FK: inner join drops
            for bi in matches:
                r2 = dict(idrow) if len(matches) > 1 else idrow
                for bid, (vals, nls) in payload.items():
                    bv = vals[bi]
                    r2[bid] = None if nls[bi] else (
                        bv.item() if isinstance(bv, np.generic) else bv)
                fold(r2, si + 1)

        for idrow in self._iter_visible_idrows(read_ht):
            if req.where is not None and \
                    eval_expr_py(req.where, idrow) is not True:
                continue
            fold(idrow, 0)
        if req.group_by is not None:
            return _grouped_cpu_response(aggs, group_state,
                                         req.group_by)
        vals = tuple(_agg_final(a, s) for a, s in zip(aggs, agg_state))
        return ReadResponse(agg_values=vals, backend="cpu",
                            group_counts=None)

    # ---- the filter route of row reads ------------------------------------
    def _execute_tpu_filter(self, req: ReadRequest
                            ) -> Optional[ReadResponse]:
        """Filter-pushdown row scan: the WHERE mask on the device
        (streamed, or one monolithic batch after zone pruning), the
        matching rows gathered on the host from the columnar blocks in
        block order.  None where the reference falls to its interpreted
        row loop."""
        blocks = self._collect_blocks()
        if not blocks:
            return None
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
        except KeyError:
            return None     # a column with no columnar form
        # several blocks that may hold versions of one key: dedup mode.
        # The reference sorts whenever there are several blocks; a
        # chunk-safe run keeps the visible mode, as the aggregate route
        # does (the same rows pass, and the cached batch stays one)
        if len(blocks) > 1 and not chunk_safe_mvcc(blocks):
            batch.unique_keys = False
        try:
            where = rewrite_strings(req.where, batch.dicts)
        except Unrewritable:
            return None     # a string column outside the rewrite
        _, _, mask = self.kernel.run(batch, where, (), None, read_ht)
        sel = np.nonzero(mask.cpu().numpy())[0]
        if req.limit is not None and len(sel) > req.limit:
            sel = sel[:req.limit]
        t1 = time.perf_counter()
        rows = self._gather_rows(kept, sel, proj_cols)
        if rows is None:
            return None     # a projected column with no columnar form
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

    def _scan_segments(self, req: ReadRequest):
        """Skip-scan segments for range-sharded tables (reference:
        docdb/scan_choices.cc + hybrid_scan_choices.cc): =/IN target
        sets on the leading range-PK columns enumerate into seek
        segments, an interval on the following column bounds each
        segment. Returns ([(lower, upper_exclusive, prefix)], residual)
        in encoded-key order, or (None, where) when nothing usable —
        the caller then runs one unbounded segment. Each segment's
        `prefix` (may be b"") is required of every key (break past it)."""
        schema = self.codec.schema
        ps = self.codec.info.partition_schema
        kind, point_lists, interval, residual, _n = \
            classify_scan_options(schema, ps.kind, req.where)
        if kind == "seq":
            return None, residual
        if kind == "empty":
            return [], residual
        from itertools import product

        from ..dockv.key_encoding import encode_key_entry
        from .table_codec import _KEV_MAKER
        base = self.codec.scan_prefix()
        segments = []
        combos = product(*[[(c, v) for v in vals]
                           for c, vals in point_lists]) \
            if point_lists else [()]
        for combo in combos:
            prefix = base + b"".join(
                encode_key_entry(_KEV_MAKER[c.type](
                    int(v) if c.type != "string" else v))
                for c, v in combo)
            lower, upper = prefix, prefix + b"\xff"
            if interval is not None:
                c, lo, hi = interval
                maker = _KEV_MAKER[c.type]
                if lo is not None:
                    lower = prefix + encode_key_entry(maker(int(lo)))
                if hi is not None:
                    upper = prefix + encode_key_entry(maker(int(hi) + 1))
            segments.append((lower, upper, prefix))
        segments.sort(key=lambda s: s[0])
        return segments, residual

    def _execute_cpu(self, req: ReadRequest) -> ReadResponse:
        read_ht = req.read_ht if req.read_ht is not None else _MAX_HT
        table_prefix = self.codec.scan_prefix()
        segments, scan_where = self._scan_segments(req)
        if segments is None:
            segments = [(table_prefix or None, None, b"")]
        if req.paging_state:
            # resume: drop segments the cursor already passed, clamp
            # the containing one
            resume = req.paging_state
            segments = [
                (max(lo or b"", resume), up, seg_pre)
                for lo, up, seg_pre in segments
                if up is None or up > resume]
        rows_out: List[Dict[str, object]] = []
        aggs = list(_expand_avg_cpu(req.aggregates))
        agg_state = [_agg_init(a) for a in aggs]
        group_state: Dict[int, list] = {}
        count = 0
        cur_prefix = None
        chosen = False
        name_to_id = {c.name: c.id for c in self.codec.schema.columns}
        for seg_lower, seg_upper, seg_prefix in segments:
            for k, v in self.store.iterate(lower=seg_lower,
                                           upper=seg_upper):
                if table_prefix and not k.startswith(table_prefix):
                    break                  # left this cotable's key space
                if seg_prefix and not k.startswith(seg_prefix):
                    break                  # left this skip-scan segment
                marker = len(k) - _HT_SUFFIX
                prefix = k[:marker]
                if prefix != cur_prefix:
                    cur_prefix = prefix
                    chosen = False
                if chosen:
                    continue
                dht = DocHybridTime.decode_desc(k[-ENCODED_SIZE:])
                if dht.ht.value > read_ht:
                    if self._allow_restart and \
                            dht.ht.value <= read_ht + _skew_window_ht():
                        raise ReadRestartError(dht.ht.value)
                    continue
                chosen = True   # newest visible version of this doc key
                v, expire = unwrap_ttl(v)
                if expire is not None and expire <= read_ht:
                    continue    # expired
                if v[0] == ValueKind.kTombstone:
                    continue
                row = self.codec.decode_row(k, v)
                if row is None:
                    continue
                idrow = {name_to_id[n]: val for n, val in row.items()}
                if scan_where is not None:
                    if eval_expr_py(scan_where, idrow) is not True:
                        continue
                if aggs:
                    _agg_accumulate(aggs, agg_state, group_state,
                                    req.group_by, idrow)
                else:
                    rows_out.append(self._project(row, req.columns))
                    count += 1
                    if req.limit is not None and count >= req.limit:
                        return ReadResponse(
                            rows=rows_out, paging_state=prefix + b"\xff",
                            backend="cpu")
        if aggs:
            if req.group_by is not None:
                return _grouped_cpu_response(aggs, group_state, req.group_by)
            vals = tuple(_agg_final(a, s) for a, s in zip(aggs, agg_state))
            return ReadResponse(agg_values=vals, backend="cpu",
                                group_counts=None)
        return ReadResponse(rows=rows_out, backend="cpu")

    def _project(self, row: Dict[str, object], columns: Tuple[str, ...]
                 ) -> Dict[str, object]:
        if not columns:
            return row
        return {c: row.get(c) for c in columns}

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


def _expand_avg_cpu(aggs):
    for a in aggs:
        if a.op == "avg":
            yield AggSpec("sum", a.expr)
            yield AggSpec("count", a.expr)
        else:
            yield a


def _agg_init(a: AggSpec):
    if a.op in ("sum", "count"):
        return 0
    return None


def _agg_step(a: AggSpec, state, idrow):
    if a.expr is None:
        return (state or 0) + 1
    v = eval_expr_py(a.expr, idrow)
    if v is None:
        return state
    if a.op == "count":
        return (state or 0) + 1
    if a.op == "sum":
        return (state or 0) + v
    if a.op == "min":
        return v if state is None else min(state, v)
    if a.op == "max":
        return v if state is None else max(state, v)
    raise ValueError(a.op)


def _agg_accumulate(aggs, agg_state, group_state, group, idrow):
    if group is None:
        for i, a in enumerate(aggs):
            agg_state[i] = _agg_step(a, agg_state[i], idrow)
        return
    if isinstance(group, (HashGroupSpec, DictGroupSpec)):
        # interpreted GROUP BY keys by value tuple — the slot-overflow
        # and flag-off fallback for DictGroupSpec lands here
        key = tuple(idrow.get(cid) for cid in group.cols)
        if any(v is None for v in key):
            return       # NULL group values are excluded (matches device)
        st = group_state.setdefault(key,
                                    [_agg_init(a) for a in aggs] + [0])
        for i, a in enumerate(aggs):
            st[i] = _agg_step(a, st[i], idrow)
        st[-1] += 1
        return
    gid = 0
    stride = 1
    for cid, domain, offset in group.cols:
        c = idrow.get(cid)
        if c is None:
            return       # NULL group values are excluded (matches device)
        c = int(c) - offset
        gid += max(0, min(c, domain - 1)) * stride
        stride *= domain
    st = group_state.setdefault(gid, [_agg_init(a) for a in aggs] + [0])
    for i, a in enumerate(aggs):
        st[i] = _agg_step(a, st[i], idrow)
    st[-1] += 1


def _agg_final(a: AggSpec, state):
    if a.op in ("sum", "count"):
        return state or 0
    return state


def _grouped_cpu_response(aggs, group_state, group) -> ReadResponse:
    if isinstance(group, (HashGroupSpec, DictGroupSpec)):
        keys = list(group_state)
        G = len(keys)
        outs = []
        for i, a in enumerate(aggs):
            if a.op in ("min", "max"):
                # SQL NULL for a group with zero qualifying inputs
                arr = np.array(
                    [_agg_final(a, group_state[k][i]) for k in keys],
                    object)
            else:
                arr = np.zeros(G,
                               np.float64 if a.op != "count" else np.int64)
                for g, key in enumerate(keys):
                    arr[g] = _agg_final(a, group_state[key][i]) or 0
            outs.append(arr)
        counts = np.asarray([group_state[k][-1] for k in keys], np.int64)
        gvals = tuple(np.asarray([k[j] for k in keys])
                      for j in range(len(group.cols)))
        return ReadResponse(agg_values=tuple(outs), group_counts=counts,
                            group_values=gvals, backend="cpu")
    G = group.num_groups
    outs = []
    for i, a in enumerate(aggs):
        if a.op in ("min", "max"):
            arr = np.full(G, None, object)
            for gid, st in group_state.items():
                arr[gid] = _agg_final(a, st[i])
        else:
            arr = np.zeros(G, np.float64 if a.op != "count" else np.int64)
            for gid, st in group_state.items():
                arr[gid] = _agg_final(a, st[i]) or 0
        outs.append(arr)
    counts = np.zeros(G, np.int64)
    for gid, st in group_state.items():
        counts[gid] = st[-1]
    return ReadResponse(agg_values=tuple(outs), group_counts=counts,
                        backend="cpu")


def _note_rows(route: str, rows, kernel_s: float, gather_s: float) -> None:
    LAST_ROW_STATS.clear()
    LAST_ROW_STATS.update(route=route, rows=len(rows), kernel_s=kernel_s,
                          gather_s=gather_s)
