"""TPC-H lineitem, Q6 and Q1 — the scan path's two query shapes.

Counterpart of ``yugabyte_db_tpu/models/tpch.py`` (lineitem schema,
generator, Q6/Q1 specs and their direct numpy answers).  The generator
draws the same numbers from the same seed as the reference, so both
packages load identical tables."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..docdb.table_codec import TableInfo
from ..dockv.packed_row import ColumnSchema, ColumnType, TableSchema
from ..dockv.partition import PartitionSchema
from ..ops.expr import Expr
from ..ops.scan import AggSpec, GroupSpec

C = Expr.col

# column ids
ROWID, QTY, EXTPRICE, DISCOUNT, TAX, SHIPDATE, RETFLAG, LINESTATUS = range(8)

ROWS_PER_SF = 6_000_000


def lineitem_schema() -> TableSchema:
    return TableSchema(columns=(
        ColumnSchema(ROWID, "rowid", ColumnType.INT64, is_hash_key=True),
        ColumnSchema(QTY, "l_quantity", ColumnType.FLOAT64),
        ColumnSchema(EXTPRICE, "l_extendedprice", ColumnType.FLOAT64),
        ColumnSchema(DISCOUNT, "l_discount", ColumnType.FLOAT64),
        ColumnSchema(TAX, "l_tax", ColumnType.FLOAT64),
        ColumnSchema(SHIPDATE, "l_shipdate", ColumnType.INT32),   # days
        ColumnSchema(RETFLAG, "l_returnflag", ColumnType.INT32),  # 0..2
        ColumnSchema(LINESTATUS, "l_linestatus", ColumnType.INT32),  # 0..1
    ), version=1)


def lineitem_info() -> TableInfo:
    return TableInfo("lineitem", "lineitem", lineitem_schema(),
                     PartitionSchema("hash", 1))


def generate_lineitem(sf: float, seed: int = 0) -> Dict[str, np.ndarray]:
    """Synthetic lineitem with TPC-H-like distributions (uniforms per the
    spec's value ranges)."""
    n = int(ROWS_PER_SF * sf)
    rng = np.random.default_rng(seed)
    return {
        "rowid": np.arange(n, dtype=np.int64),
        "l_quantity": rng.integers(1, 51, n).astype(np.float64),
        "l_extendedprice": rng.uniform(900, 105000, n),
        "l_discount": rng.integers(0, 11, n).astype(np.float64) / 100.0,
        "l_tax": rng.integers(0, 9, n).astype(np.float64) / 100.0,
        "l_shipdate": rng.integers(8036, 10592, n).astype(np.int32),
        "l_returnflag": rng.integers(0, 3, n).astype(np.int32),
        "l_linestatus": rng.integers(0, 2, n).astype(np.int32),
    }


# TPC-H Q6: SELECT sum(l_extendedprice * l_discount) FROM lineitem WHERE
#   l_shipdate >= date '1994-01-01' AND l_shipdate < date '1995-01-01'
#   AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24
_D1994 = 8766       # days since epoch for 1994-01-01
_D1995 = 9131


@dataclass(frozen=True)
class QuerySpec:
    name: str
    where: Optional[tuple]
    aggs: Tuple[AggSpec, ...]
    group: Optional[GroupSpec]
    columns: Tuple[int, ...]


TPCH_Q6 = QuerySpec(
    name="q6",
    where=((C(SHIPDATE) >= _D1994) & (C(SHIPDATE) < _D1995)
           & C(DISCOUNT).between(0.05, 0.07) & (C(QTY) < 24.0)).node,
    aggs=(AggSpec("sum", (C(EXTPRICE) * C(DISCOUNT)).node),),
    group=None,
    columns=(QTY, EXTPRICE, DISCOUNT, SHIPDATE),
)

# TPC-H Q1: grouped sums over (returnflag, linestatus), shipdate <= cutoff
_Q1_CUT = 10471     # 1998-09-02

TPCH_Q1 = QuerySpec(
    name="q1",
    where=(C(SHIPDATE) <= _Q1_CUT).node,
    aggs=(
        AggSpec("sum", C(QTY).node),
        AggSpec("sum", C(EXTPRICE).node),
        AggSpec("sum", (C(EXTPRICE) * (Expr.const(1.0) - C(DISCOUNT))).node),
        AggSpec("sum", ((C(EXTPRICE) * (Expr.const(1.0) - C(DISCOUNT)))
                        * (Expr.const(1.0) + C(TAX))).node),
        AggSpec("count"),
    ),
    group=GroupSpec(cols=((RETFLAG, 3, 0), (LINESTATUS, 2, 0))),
    columns=(QTY, EXTPRICE, DISCOUNT, TAX, SHIPDATE, RETFLAG, LINESTATUS),
)


def numpy_reference(query: QuerySpec, data: Dict[str, np.ndarray]):
    """Direct numpy answer for verification: Q6 -> revenue float; Q1 ->
    {gid: (qty_sum, price_sum, count)} with gid = retflag + 3*linestatus."""
    qty, price, disc = (data["l_quantity"], data["l_extendedprice"],
                        data["l_discount"])
    if query.name == "q6":
        m = ((data["l_shipdate"] >= _D1994) & (data["l_shipdate"] < _D1995)
             & (disc >= 0.05) & (disc <= 0.07) & (qty < 24.0))
        return (price[m] * disc[m]).sum()
    if query.name == "q1":
        m = data["l_shipdate"] <= _Q1_CUT
        gid = data["l_returnflag"] + 3 * data["l_linestatus"]
        out = {}
        for g in range(6):
            mg = m & (gid == g)
            out[g] = (qty[mg].sum(), price[mg].sum(), int(mg.sum()))
        return out
    raise ValueError(query.name)
