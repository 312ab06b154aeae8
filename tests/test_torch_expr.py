"""The port's expression compiler (yugabyte_db_tpu_torch/ops/expr.py)
against the JAX reference's (yugabyte_db_tpu/ops/expr.py): the same
ASTs over the same seeded columns must give the same values, the same
dtypes and the same NULL masks, bit for bit — three-valued AND/OR/NOT,
BETWEEN, IN, IS NULL, shared constant offsets and the JAX (x64) type
promotion of literals, spelled out cast by cast in the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yugabyte_db_tpu.ops import expr as jexpr
from yugabyte_db_tpu_torch.ops import expr as pexpr
from tests.torch_parity import assert_bitwise

N = 257


def _columns():
    """col 0 f32, 1 f64, 2 int32 (with NULLs), 3 bool-ish int32 flags,
    4 f32 with NULLs, 5 int32 large (products past 2^31)."""
    rng = np.random.default_rng(11)
    cols = {
        0: (rng.integers(0, 11, N) / 100.0).astype(np.float32),
        1: rng.uniform(-50, 50, N),
        2: rng.integers(-5, 6, N).astype(np.int32),
        3: rng.integers(0, 2, N).astype(np.int32),
        4: rng.uniform(0, 1, N).astype(np.float32),
        5: rng.integers(40000, 60000, N).astype(np.int32),
    }
    nulls = {cid: np.zeros(N, bool) for cid in cols}
    nulls[2] = rng.random(N) < 0.3
    nulls[4] = rng.random(N) < 0.4
    return cols, nulls


C = pexpr.Expr.col
K = pexpr.Expr.const

CASES = {
    # comparisons: f32 column vs a fractional literal compares in f32
    "f32_lt": (C(0) < 0.05).node,
    "f32_le": (C(0) <= 0.05).node,
    "f32_gt": (C(0) > 0.07).node,
    "f32_ge": (C(0) >= 0.05).node,
    "f32_eq": C(0).eq(0.06).node,
    "f32_ne": C(0).ne(0.06).node,
    # int32 column vs fractional literal compares in f64
    "int32_lt_frac": (C(2) < 2.5).node,
    "int32_eq_frac": C(2).eq(2.5).node,
    "int32_ge_int": (C(2) >= 2).node,
    "f64_between": C(1).between(-10.0, 10.5).node,
    "f32_between": C(0).between(0.05, 0.07).node,
    "int32_in": C(2).isin([1, 3, -4]).node,
    "f32_in": C(0).isin([0.05, 0.1]).node,
    "isnull": C(2).is_null().node,
    "isnull_nonnull_col": C(0).is_null().node,
    # three-valued logic over nullable operands
    "and3": ((C(2) > 0) & (C(4) < 0.5)).node,
    "or3": ((C(2) > 0) | (C(4) < 0.5)).node,
    "not3": (~(C(2) > 0)).node,
    "and_or_not": ((~(C(2) > 0) | (C(4) >= 0.2)) & (C(1) < 0.0)).node,
    "nested_3vl": (((C(2) < 0) & (C(4) < 0.9)) | ~(C(4) > 0.1)).node,
    # arithmetic: int-int widening, weak literal promotion
    "int_mul_widen": (C(5) * C(5)).node,
    "int_add_lit": (C(2) + 7).node,
    "int_sub_col": (C(2) - C(3)).node,
    "int_times_frac": (C(2) * 0.5).node,
    "weak_f64_times_f32": ((C(2) * 0.5) * C(0)).node,
    "f32_revenue": (C(4) * (K(1.0) - C(0))).node,
    "f32_charge": ((C(4) * (K(1.0) - C(0))) * (K(1.0) + C(0))).node,
    "f64_div": (C(1) / 3.0).node,
    "int_div": (C(2) / C(5)).node,
    "f64_plus_f32": (C(1) + C(0)).node,
    "mod_int": ("arith", "mod", ("col", 5), ("const", 7)),
    "cmp_of_arith": ((C(2) * 3) < C(5)).node,
}


def _run_both(node, offset=0, prefix=()):
    cols, nulls = _columns()
    consts = list(prefix)
    jexpr.collect_constants(node, consts)
    jv, jn = jexpr.compile_expr(node, offset=offset)(
        {c: jnp.asarray(v) for c, v in cols.items()},
        {c: jnp.asarray(v) for c, v in nulls.items()},
        [jnp.asarray(c) for c in consts])
    pv, pn = pexpr.compile_expr(node, offset=offset)(
        {c: torch.from_numpy(v) for c, v in cols.items()},
        {c: torch.from_numpy(v) for c, v in nulls.items()},
        list(consts))
    return (jv, jn), (pv, pn)


@pytest.mark.parametrize("name", sorted(CASES))
def test_compile_expr_matches_reference(name):
    (jv, jn), (pv, pn) = _run_both(CASES[name])
    jv = np.broadcast_to(np.asarray(jv), (N,))
    pv = np.broadcast_to(pv.numpy(), (N,))
    assert_bitwise(pv, jv, f"{name} value")
    assert (jn is None) == (pn is None), name
    if jn is not None:
        assert_bitwise(pn, jn, f"{name} null")


@pytest.mark.parametrize("name", ["f32_between", "int32_in", "f32_charge"])
def test_shared_constant_offsets(name):
    # a kernel concatenates the WHERE's constants before an aggregate's:
    # compiled at its offset, the expression must read ITS slots, not
    # the leading ones (the slot collision ops/scan.py:384 records)
    prefix = [123.0, -7, 0.5]
    (jv, _), (pv, _) = _run_both(CASES[name], offset=len(prefix),
                                 prefix=prefix)
    (jv0, _), (pv0, _) = _run_both(CASES[name])
    assert_bitwise(np.broadcast_to(pv.numpy(), (N,)),
                   np.broadcast_to(np.asarray(jv), (N,)), name)
    assert_bitwise(pv, pv0, f"{name} vs unshifted")


def test_three_valued_truth_table():
    # SQL: FALSE AND NULL = FALSE, TRUE AND NULL = NULL,
    #      TRUE OR NULL = TRUE, FALSE OR NULL = NULL, NOT NULL = NULL
    v = torch.tensor([True, False, True, False])
    n = torch.tensor([False, False, True, True])
    t = torch.tensor([True, True, True, True])
    cols = {0: v, 1: t, 2: ~t}
    nulls = {0: n, 1: torch.zeros(4, dtype=torch.bool),
             2: torch.zeros(4, dtype=torch.bool)}
    and_f = pexpr.compile_expr(("and", ("col", 0), ("col", 2)))
    val, null = and_f(cols, nulls, [])
    assert (val & ~null).tolist() == [False] * 4
    assert null.tolist() == [False] * 4          # FALSE AND x = FALSE
    and_t = pexpr.compile_expr(("and", ("col", 0), ("col", 1)))
    val, null = and_t(cols, nulls, [])
    assert null.tolist() == [False, False, True, True]
    or_t = pexpr.compile_expr(("or", ("col", 0), ("col", 1)))
    val, null = or_t(cols, nulls, [])
    assert null.tolist() == [False] * 4 and val.tolist() == [True] * 4
    or_f = pexpr.compile_expr(("or", ("col", 0), ("col", 2)))
    val, null = or_f(cols, nulls, [])
    assert null.tolist() == [False, False, True, True]
    val, null = pexpr.compile_expr(("not", ("col", 0)))(cols, nulls, [])
    assert null.tolist() == n.tolist()


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_analysis_matches_reference(name):
    node = CASES[name]
    assert pexpr.expr_signature(node) == jexpr.expr_signature(node)
    assert pexpr.const_count(node) == jexpr.const_count(node)
    assert pexpr.referenced_columns(node) == jexpr.referenced_columns(node)
    bounds = {0: (0.0, 0.1), 1: (-50.0, 50.0), 2: (-5.0, 5.0),
              3: (0.0, 1.0), 4: (0.0, 1.0), 5: (40000.0, 60000.0)}
    for mag in (np.inf, 3.0e38, 100.0):
        assert pexpr.expr_bound(node, bounds, mag) == \
            jexpr.expr_bound(node, bounds, mag)


def test_fluent_builders_match_reference():
    J, P = jexpr.Expr, pexpr.Expr
    pairs = [
        ((J.col(1) >= 3) & (J.col(2) < 4.5), (P.col(1) >= 3) & (P.col(2) < 4.5)),
        (J.col(1).between(1, 2) | ~J.col(3).is_null(),
         P.col(1).between(1, 2) | ~P.col(3).is_null()),
        (J.col(1).isin([1, 2]) & J.col(2).ne(0), P.col(1).isin([1, 2]) & P.col(2).ne(0)),
        ((J.col(1) - 1) / J.col(2) * 3 + 1, (P.col(1) - 1) / P.col(2) * 3 + 1),
    ]
    for j, p in pairs:
        assert j.node == p.node
