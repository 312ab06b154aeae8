"""Pushdown expression ASTs compiled to torch — and, from the same walk,
to Triton source.

Counterpart of ``yugabyte_db_tpu/ops/expr.py``.  The AST is the
reference's (tuples, so it crosses the wire unchanged).  ``_lower`` is
the ONE walk over it; it calls an operator backend for every node:

- ``_TorchOps`` evaluates on tensors (``compile_expr``), for the exact
  scan route and the hand kernels' plain versions;
- ``TritonOps`` (used by ops/hand_scan.py) emits Triton statements, so
  the generic hand scan kernel specialises per query exactly as the
  Pallas kernel traced ``compile_expr`` into its body.

Null semantics are SQL three-valued logic: every node evaluates to
(value, is_null); comparisons/arithmetic propagate null, and a WHERE
keeps rows only when value AND NOT is_null.

Type promotion follows the reference's JAX rules under x64 explicitly,
cast by cast, because torch's own rules differ: a Python literal is
*weakly* typed (``Weak``) and takes the other operand's dtype when that
is of the same or a higher kind (f32 column vs 0.05 compares in f32);
against a lower kind it widens to the 64-bit default of its own kind
(int32 column vs 24.0 compares in f64), and the result stays weak.
Integer add/sub/mul widen to int64 first (PG int ops widen)."""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch

ExprNode = Union[tuple, list]


# --- AST constructors (tuples so they're trivially wire-serializable) -----
def col(col_id: int) -> tuple:
    return ("col", col_id)


def const(v) -> tuple:
    return ("const", v)


class Expr:
    """Fluent wrapper for building AST tuples in Python code."""

    def __init__(self, node: ExprNode):
        self.node = node

    @staticmethod
    def col(cid: int) -> "Expr":
        return Expr(col(cid))

    @staticmethod
    def const(v) -> "Expr":
        return Expr(const(v))

    def _wrap(self, other) -> ExprNode:
        return other.node if isinstance(other, Expr) else const(other)

    def __lt__(self, o): return Expr(("cmp", "lt", self.node, self._wrap(o)))
    def __le__(self, o): return Expr(("cmp", "le", self.node, self._wrap(o)))
    def __gt__(self, o): return Expr(("cmp", "gt", self.node, self._wrap(o)))
    def __ge__(self, o): return Expr(("cmp", "ge", self.node, self._wrap(o)))
    def eq(self, o): return Expr(("cmp", "eq", self.node, self._wrap(o)))
    def ne(self, o): return Expr(("cmp", "ne", self.node, self._wrap(o)))
    def __add__(self, o): return Expr(("arith", "add", self.node, self._wrap(o)))
    def __sub__(self, o): return Expr(("arith", "sub", self.node, self._wrap(o)))
    def __mul__(self, o): return Expr(("arith", "mul", self.node, self._wrap(o)))
    def __truediv__(self, o): return Expr(("arith", "div", self.node, self._wrap(o)))
    def __and__(self, o): return Expr(("and", self.node, self._wrap(o)))
    def __or__(self, o): return Expr(("or", self.node, self._wrap(o)))
    def __invert__(self): return Expr(("not", self.node))
    def between(self, lo, hi):
        return Expr(("between", self.node, self._wrap(lo), self._wrap(hi)))
    def isin(self, vals: Sequence):
        return Expr(("in", self.node, list(vals)))
    def is_null(self): return Expr(("isnull", self.node))


def expr_signature(node: ExprNode) -> tuple:
    """Hashable structural signature: scalar constants are runtime
    arguments, so only the IN-list length (which changes kernel shape)
    enters the signature."""
    kind = node[0]
    if kind == "const":
        return ("const",)
    if kind == "col":
        return ("col", node[1])
    if kind == "in":
        return ("in", expr_signature(node[1]), len(node[2]))
    if kind == "dictlut":
        return ("dictlut", expr_signature(node[1]), len(node[2]))
    return (kind,) + tuple(
        expr_signature(c) if isinstance(c, (tuple, list)) else c
        for c in node[1:])


def collect_constants(node: ExprNode, out: list) -> None:
    kind = node[0]
    if kind == "const":
        out.append(node[1])
        return
    if kind == "in":
        collect_constants(node[1], out)
        out.extend(node[2])
        return
    if kind == "dictlut":
        collect_constants(node[1], out)
        out.append(np.asarray(node[2], np.bool_))
        return
    for c in node[1:]:
        if isinstance(c, (tuple, list)) and c and isinstance(c[0], str):
            collect_constants(c, out)


def const_count(node: ExprNode) -> int:
    """How many runtime-constant slots `node` consumes — the offset
    stride for compiling several expressions against ONE shared consts
    list (a kernel's where + aggregate expressions)."""
    out: list = []
    collect_constants(node, out)
    return len(out)


_ARITH_OPS = ("add", "sub", "mul", "div", "mod")


# --- the one walk ---------------------------------------------------------
def _lower(node: ExprNode, ops, offset: int) -> Callable:
    """Build fn(cols, nulls, consts) -> (value, null|None) calling
    ``ops`` for every node.  Constant slots are numbered from
    ``offset`` in collect_constants order."""
    counter = [offset]

    def build(n: ExprNode) -> Callable:
        kind = n[0]
        if kind == "col":
            cid = n[1]
            return lambda cols, nulls, consts: (cols[cid], nulls.get(cid))
        if kind == "const":
            idx = counter[0]
            counter[0] += 1
            return lambda cols, nulls, consts: (ops.const(consts[idx]), None)
        if kind == "cmp":
            op = n[1]
            lf, rf = build(n[2]), build(n[3])

            def f(cols, nulls, consts):
                lv, ln = lf(cols, nulls, consts)
                rv, rn = rf(cols, nulls, consts)
                return ops.cmp(op, lv, rv), _or_null(ops, ln, rn)
            return f
        if kind == "arith":
            op = n[1]
            if op not in _ARITH_OPS:
                raise ValueError(f"unknown arith op {op}")
            lf, rf = build(n[2]), build(n[3])

            def f(cols, nulls, consts):
                lv, ln = lf(cols, nulls, consts)
                rv, rn = rf(cols, nulls, consts)
                return ops.arith(op, lv, rv), _or_null(ops, ln, rn)
            return f
        if kind == "and":
            lf, rf = build(n[1]), build(n[2])

            def f(cols, nulls, consts):
                lv, ln = lf(cols, nulls, consts)
                rv, rn = rf(cols, nulls, consts)
                # SQL: FALSE AND NULL = FALSE; TRUE AND NULL = NULL
                return (ops.logical_and(lv, rv),
                        _and3_null(ops, lv, ln, rv, rn))
            return f
        if kind == "or":
            lf, rf = build(n[1]), build(n[2])

            def f(cols, nulls, consts):
                lv, ln = lf(cols, nulls, consts)
                rv, rn = rf(cols, nulls, consts)
                return (ops.logical_or(lv, rv),
                        _or3_null(ops, lv, ln, rv, rn))
            return f
        if kind == "not":
            xf = build(n[1])

            def f(cols, nulls, consts):
                v, nn = xf(cols, nulls, consts)
                return ops.logical_not(v), nn
            return f
        if kind == "between":
            xf, lof, hif = build(n[1]), build(n[2]), build(n[3])

            def f(cols, nulls, consts):
                xv, xn = xf(cols, nulls, consts)
                lov, lon = lof(cols, nulls, consts)
                hiv, hin = hif(cols, nulls, consts)
                v = ops.logical_and(ops.cmp("ge", xv, lov),
                                    ops.cmp("le", xv, hiv))
                return v, _or_null(ops, _or_null(ops, xn, lon), hin)
            return f
        if kind == "in":
            xf = build(n[1])
            k = len(n[2])
            idx0 = counter[0]
            counter[0] += k

            def f(cols, nulls, consts):
                xv, xn = xf(cols, nulls, consts)
                acc = ops.false_like(xv)
                for i in range(k):
                    acc = ops.logical_or(
                        acc, ops.cmp("eq", xv, ops.const(consts[idx0 + i])))
                return acc, xn
            return f
        if kind == "isnull":
            xf = build(n[1])

            def f(cols, nulls, consts):
                xv, xn = xf(cols, nulls, consts)
                return (xn if xn is not None else ops.false_like(xv)), None
            return f
        if kind == "dictlut":
            raise NotImplementedError(
                "dictionary-code LUT predicates are not ported (ROADMAP.md "
                "queue 1: grouped_scan and dictionary columns)")
        raise ValueError(f"unknown expr node {kind}")

    return build(node)


def _or_null(ops, a, b):
    if a is None:
        return b
    if b is None:
        return a
    return ops.logical_or(a, b)


def _definitely(ops, v, n, truth: bool):
    """v is definitively TRUE (truth) / FALSE (not truth): known and
    of that value."""
    x = v if truth else ops.logical_not(v)
    return x if n is None else ops.logical_and(x, ops.logical_not(n))


def _and3_null(ops, lv, ln, rv, rn):
    # NULL unless one side is definitively FALSE
    any_null = _or_null(ops, ln, rn)
    if any_null is None:
        return None
    decided = ops.logical_or(_definitely(ops, lv, ln, False),
                             _definitely(ops, rv, rn, False))
    return ops.logical_and(any_null, ops.logical_not(decided))


def _or3_null(ops, lv, ln, rv, rn):
    # NULL unless one side is definitively TRUE
    any_null = _or_null(ops, ln, rn)
    if any_null is None:
        return None
    decided = ops.logical_or(_definitely(ops, lv, ln, True),
                             _definitely(ops, rv, rn, True))
    return ops.logical_and(any_null, ops.logical_not(decided))


# --- torch backend --------------------------------------------------------
class Weak:
    """A weakly typed value (JAX's weak_type): a Python literal, or a
    tensor whose dtype came from one.  Its dtype yields to a strong
    operand of the same or a higher kind."""
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v


def _kind(dt: torch.dtype) -> int:
    if dt == torch.bool:
        return 0
    return 2 if dt.is_floating_point else 1


_DEFAULT_OF_KIND = {0: torch.bool, 1: torch.int64, 2: torch.float64}


def _dtype_of(x) -> Tuple[torch.dtype, bool]:
    """(dtype, weak) of a torch-backend value."""
    if isinstance(x, Weak):
        v = x.v
        if isinstance(v, torch.Tensor):
            return v.dtype, True
        if isinstance(v, (bool, np.bool_)):
            return torch.bool, True
        if isinstance(v, (int, np.integer)):
            return torch.int64, True
        return torch.float64, True
    return x.dtype, False


def _join(a, b) -> Tuple[torch.dtype, bool]:
    """JAX (x64) result dtype and weakness of a binary op."""
    da, wa = _dtype_of(a)
    db, wb = _dtype_of(b)
    if wa == wb:
        return torch.promote_types(da, db), wa
    (dw, ds) = (da, db) if wa else (db, da)
    if _kind(dw) <= _kind(ds):
        return ds, False
    return _DEFAULT_OF_KIND[_kind(dw)], True


def _as(x, dt: torch.dtype, like) -> torch.Tensor:
    """x as a tensor of dtype dt (a literal becomes a 0-dim tensor on
    the device of ``like``)."""
    v = x.v if isinstance(x, Weak) else x
    if isinstance(v, torch.Tensor):
        return v if v.dtype == dt else v.to(dt)
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.tensor(v, dtype=dt, device=dev)


def _tensor_of(x):
    if isinstance(x, Weak):
        return x.v if isinstance(x.v, torch.Tensor) else None
    return x


def _operands(a, b):
    dt, weak = _join(a, b)
    like = _tensor_of(a) if _tensor_of(a) is not None else _tensor_of(b)
    return _as(a, dt, like), _as(b, dt, like), weak


_TORCH_CMP = {
    "lt": torch.lt, "le": torch.le, "gt": torch.gt,
    "ge": torch.ge, "eq": torch.eq, "ne": torch.ne,
}


class _TorchOps:
    @staticmethod
    def const(c):
        # Python literals are weak; tensors and numpy scalars are strong
        if isinstance(c, (bool, int, float)):
            return Weak(c)
        if isinstance(c, np.generic):
            return torch.tensor(c.item(),
                                dtype=torch.from_numpy(np.asarray(c)).dtype)
        return c

    @staticmethod
    def cmp(op, a, b):
        x, y, _ = _operands(a, b)
        return _TORCH_CMP[op](x, y)

    @staticmethod
    def arith(op, a, b):
        if op in ("add", "sub", "mul"):
            # int-int arithmetic runs in int64: an int32 product/sum past
            # 2^31 would silently wrap (PG semantics: int ops widen)
            if _kind(_dtype_of(a)[0]) == 1 and _kind(_dtype_of(b)[0]) == 1:
                a = _as(a, torch.int64, _tensor_of(b))
        x, y, weak = _operands(a, b)
        if op == "add":
            r = x + y
        elif op == "sub":
            r = x - y
        elif op == "mul":
            r = x * y
        elif op == "div":
            if not x.dtype.is_floating_point:
                # true divide of integers: JAX's inexact twin of the
                # promoted type — f64 for int64 or a weak result, f32
                # for narrower integers
                ft = torch.float64 if weak or x.dtype == torch.int64 \
                    else torch.float32
                x, y = x.to(ft), y.to(ft)
            r = x / y
        else:
            # mod matches PG truncate-toward-zero semantics
            r = torch.fmod(x, y)
        return Weak(r) if weak else r

    @staticmethod
    def logical_and(a, b):
        return torch.logical_and(_tensor_of(a), _tensor_of(b))

    @staticmethod
    def logical_or(a, b):
        return torch.logical_or(_tensor_of(a), _tensor_of(b))

    @staticmethod
    def logical_not(a):
        return torch.logical_not(_tensor_of(a))

    @staticmethod
    def false_like(x):
        t = _tensor_of(x)
        if t is None:
            return torch.zeros((), dtype=torch.bool)
        return torch.zeros_like(t, dtype=torch.bool)


def _strong(x):
    if isinstance(x, Weak):
        v = x.v
        return v if isinstance(v, torch.Tensor) else torch.tensor(v)
    return x


def compile_expr(node: ExprNode, offset: int = 0) -> Callable:
    """Compile an AST into fn(cols, nulls, consts) -> (values, is_null).

    cols/nulls: dict col_id -> [N] tensors.  consts: flat list in
    collect_constants order — Python literals (weakly typed, as the
    reference's jnp.asarray literals are) or tensors (strong).
    ``offset`` is this expression's starting index in the SHARED consts
    list: a kernel that concatenates several expressions' constants
    (WHERE first, then each aggregate) must compile each at its
    cumulative offset or their const slots collide."""
    fn = _lower(node, _TorchOps, offset)

    def run(cols: Dict[int, torch.Tensor], nulls: Dict[int, torch.Tensor],
            consts):
        v, n = fn(cols, nulls, consts)
        return _strong(v), n
    return run


# --- host-side analysis ---------------------------------------------------
def expr_bound(node: ExprNode, col_bounds: Dict[int, Tuple[float, float]],
               mag_limit: float = np.inf) -> Tuple[float, float] | None:
    """Interval-arithmetic bound (lo, hi) of an arithmetic expression
    from host-cached per-column value ranges, or None when unboundable
    (missing column stats, non-finite data, unsupported node, or ANY
    intermediate interval exceeding `mag_limit`, the device float
    dtype's finite range).  Powers the scan kernel's static fixed-point
    SUM scales."""
    def clip(b):
        if b is None or max(abs(b[0]), abs(b[1])) > mag_limit:
            return None
        return b

    kind = node[0]
    if kind == "col":
        b = col_bounds.get(node[1])
        if b is None or not (np.isfinite(b[0]) and np.isfinite(b[1])):
            return None
        return clip((float(b[0]), float(b[1])))
    if kind == "const":
        v = node[1]
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
        v = float(v)
        return clip((v, v)) if np.isfinite(v) else None
    if kind == "arith":
        lb = expr_bound(node[2], col_bounds, mag_limit)
        rb = expr_bound(node[3], col_bounds, mag_limit)
        if lb is None or rb is None:
            return None
        op = node[1]
        if op == "add":
            return clip((lb[0] + rb[0], lb[1] + rb[1]))
        if op == "sub":
            return clip((lb[0] - rb[1], lb[1] - rb[0]))
        if op == "mul":
            ps = (lb[0] * rb[0], lb[0] * rb[1],
                  lb[1] * rb[0], lb[1] * rb[1])
            return clip((min(ps), max(ps)))
        if op == "div":
            # only safe when the divisor interval excludes 0
            if rb[0] > 0 or rb[1] < 0:
                ps = (lb[0] / rb[0], lb[0] / rb[1],
                      lb[1] / rb[0], lb[1] / rb[1])
                return clip((min(ps), max(ps)))
        return None
    return None


def referenced_columns(node: ExprNode, out: set | None = None) -> set:
    out = out if out is not None else set()
    if node[0] == "col":
        out.add(node[1])
    elif node[0] in ("in", "like", "ilike", "dictlut"):
        referenced_columns(node[1], out)
    elif node[0] == "json":
        referenced_columns(node[2], out)
    else:
        for c in node[1:]:
            if isinstance(c, (tuple, list)) and c and isinstance(c[0], str):
                referenced_columns(c, out)
    return out
