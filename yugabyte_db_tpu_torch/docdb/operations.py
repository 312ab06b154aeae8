"""String predicates on the device: the dictionary rewrite.

Counterpart of the dictionary-rewrite part of
``yugabyte_db_tpu/docdb/operations.py`` (``DocReadOperation.
_Unrewritable``, ``rewrite_where_and_aggs``, ``_rewrite_strings``), here
as module functions.  The rest of ``DocReadOperation`` (the tablet read
seam) is ROADMAP.md queue 1 item 3.

String columns ride on the device as codes into SORTED scan-global
dictionaries, so ordering predicates map to code ranges, equality/IN to
exact codes, and LIKE to a boolean lookup table over the dictionary
(the ``dictlut`` expression node)."""
from __future__ import annotations

import bisect
import re

from ..ops.scan import AggSpec


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
