"""The port's host baseline scan (yugabyte_db_tpu_torch/ops/cpu_scan.py)
against the JAX reference's on the same seeded rows: ``eval_expr_np``
over every node kind it handles, values and NULL masks bit for bit, and
``cpu_scan_aggregate`` on Q6, Q1 and a dense group with MIN/MAX/AVG,
bit for bit under f32 and f64 inputs, with and without a read point.
Tolerance: none — both sides run the same numpy operations in the same
order, so every result must have the same dtype and bits."""
import numpy as np
import pytest

from yugabyte_db_tpu.ops import cpu_scan as jcs
from yugabyte_db_tpu.ops.scan import GroupSpec as JGroup
from yugabyte_db_tpu_torch.models import tpch
from yugabyte_db_tpu_torch.ops import cpu_scan as pcs
from yugabyte_db_tpu_torch.ops.expr import Expr
from yugabyte_db_tpu_torch.ops.scan import AggSpec, GroupSpec
from tests.torch_parity import (assert_bitwise, jax_blocks, lineitem_data,
                                port_blocks_from, to_jax_aggs)

C = Expr.col
Q, P, D, T, S, R, L = (tpch.QTY, tpch.EXTPRICE, tpch.DISCOUNT, tpch.TAX,
                       tpch.SHIPDATE, tpch.RETFLAG, tpch.LINESTATUS)

# every node kind eval_expr_np handles (reference ops/cpu_scan.py:24-66)
NODES = {
    "col": C(P).node,
    "const": ("const", 2.5),
    "cmp_lt": (C(Q) < 24.0).node,
    "cmp_le": (C(S) <= 9000).node,
    "cmp_gt": (C(D) > 0.05).node,
    "cmp_ge": (C(S) >= 8766).node,
    "cmp_eq": C(R).eq(1).node,
    "cmp_ne": C(L).ne(0).node,
    "arith_add": (C(P) + C(T)).node,
    "arith_sub": (Expr.const(1.0) - C(D)).node,
    "arith_mul": (C(P) * C(D)).node,
    "arith_div": (C(P) / C(Q)).node,
    "and": ((C(Q) < 24.0) & (C(S) >= 8766)).node,
    "or": ((C(Q) < 5.0) | C(R).eq(2)).node,
    "not": (~(C(Q) < 24.0)).node,
    "between": C(D).between(0.05, 0.07).node,
    "in": C(S).isin([8766, 8767, 9000]).node,
    "isnull_with_nulls": C(Q).is_null().node,
    "isnull_no_nulls": C(S).is_null().node,
    "nested_nulls": (((C(P) * (Expr.const(1.0) - C(D))) > 5000.0)
                     & ~C(T).is_null()).node,
}


def _cols(data, mode):
    """Column arrays as a scan gathers them, with NULLs on QTY and TAX;
    fractional columns cast to f32 in mode float32."""
    rng = np.random.default_rng(9)
    n = len(data["rowid"])
    ids = {Q: "l_quantity", P: "l_extendedprice", D: "l_discount",
           T: "l_tax", S: "l_shipdate", R: "l_returnflag",
           L: "l_linestatus"}
    cols = {}
    for cid, name in ids.items():
        v = data[name]
        if mode == "float32" and v.dtype == np.float64:
            v = v.astype(np.float32)
        cols[cid] = v
    nulls = {cid: np.zeros(n, bool) for cid in cols}
    nulls[Q] = rng.random(n) < 0.1
    nulls[T] = rng.random(n) < 0.05
    return cols, nulls


@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("name", list(NODES))
def test_eval_expr_np_matches_reference(name, mode):
    cols, nulls = _cols(lineitem_data(3000, seed=4), mode)
    node = NODES[name]
    if name == "isnull_no_nulls":
        nulls = {c: m for c, m in nulls.items() if c != S}
    pv, pn = pcs.eval_expr_np(node, cols, nulls)
    jv, jn = jcs.eval_expr_np(node, cols, nulls)
    assert_bitwise(np.asarray(pv), np.asarray(jv), f"{name} values")
    assert (pn is None) == (jn is None), name
    if jn is not None:
        assert_bitwise(pn, jn, f"{name} nulls")


def test_eval_expr_np_refuses_unknown_nodes_like_reference():
    node = ("like", C(R).node, "A%")
    with pytest.raises(ValueError):
        jcs.eval_expr_np(node, {R: np.zeros(3)}, {})
    with pytest.raises(ValueError):
        pcs.eval_expr_np(node, {R: np.zeros(3)}, {})


def _f32_blocks(jblocks):
    """The blocks with every fractional f64 lane cast to f32 (a table
    stored as REAL)."""
    for b in jblocks:
        for cid, (v, m) in list(b.fixed.items()):
            if v.dtype == np.float64 and not np.all(v == np.rint(v)):
                b.fixed[cid] = (v.astype(np.float32), m)
    return jblocks


SCANS = {
    "q6": (tpch.TPCH_Q6.columns, tpch.TPCH_Q6.where, tpch.TPCH_Q6.aggs,
           None),
    "q1": (tpch.TPCH_Q1.columns, tpch.TPCH_Q1.where, tpch.TPCH_Q1.aggs,
           tpch.TPCH_Q1.group),
    "dense_minmax_avg": (
        (Q, P, D, S, R), (C(S) < 9500).node,
        (AggSpec("min", C(P).node), AggSpec("max", (C(P) * C(D)).node),
         AggSpec("avg", C(Q).node), AggSpec("count", C(D).node),
         AggSpec("count")),
        GroupSpec(cols=((R, 3, 0),))),
    "flat_minmax_empty": (
        (P, S), (C(S) < 0).node,
        (AggSpec("min", C(P).node), AggSpec("max", C(P).node),
         AggSpec("sum", C(P).node)), None),
}


@pytest.mark.parametrize("read_ht", [None, 1000, 999])
@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("scan", list(SCANS))
def test_cpu_scan_aggregate_matches_reference(scan, mode, read_ht):
    data = lineitem_data(2 * 4096 + 333, seed=12)
    jblocks = jax_blocks(data)
    if mode == "float32":
        jblocks = _f32_blocks(jblocks)
    pblocks = port_blocks_from(jblocks)
    cols, where, aggs, group = SCANS[scan]
    jgroup = JGroup(cols=group.cols) if group is not None else None
    po, pc = pcs.cpu_scan_aggregate(pblocks, cols, where, aggs, group,
                                    read_ht)
    jo, jc = jcs.cpu_scan_aggregate(jblocks, cols, where,
                                    to_jax_aggs(aggs), jgroup, read_ht)
    assert len(po) == len(jo)
    for i, (a, b) in enumerate(zip(po, jo)):
        assert_bitwise(np.asarray(a), np.asarray(b), f"{scan} agg {i}")
    assert_bitwise(np.asarray(pc), np.asarray(jc), f"{scan} counts")
    if read_ht == 999:             # below the load: nothing visible
        assert int(np.sum(pc)) == 0


def test_cpu_scan_answers_q6_and_q1_like_numpy():
    data = lineitem_data(3 * 4096 + 777, seed=5)
    blocks = port_blocks_from(jax_blocks(data))
    (rev,), _ = pcs.cpu_scan_aggregate(blocks, tpch.TPCH_Q6.columns,
                                       tpch.TPCH_Q6.where,
                                       tpch.TPCH_Q6.aggs)
    np.testing.assert_allclose(rev, tpch.numpy_reference(tpch.TPCH_Q6,
                                                         data), rtol=1e-9)
    outs, counts = pcs.cpu_scan_aggregate(
        blocks, tpch.TPCH_Q1.columns, tpch.TPCH_Q1.where,
        tpch.TPCH_Q1.aggs, tpch.TPCH_Q1.group)
    ref = tpch.numpy_reference(tpch.TPCH_Q1, data)
    for g in range(6):
        assert int(counts[g]) == ref[g][2]
        assert outs[0][g] == ref[g][0]
        np.testing.assert_allclose(outs[1][g], ref[g][1], rtol=1e-9)
