"""TPC-H lineitem, Q6 and Q1 — the scan path's two query shapes.

Counterpart of ``yugabyte_db_tpu/models/tpch.py`` (lineitem schema, its
range-sharded and string-keyed variants, generator, Q6/Q1 specs, Q1
grouped by the flag strings, their direct numpy answers, and
``LineitemTable``, the set of tablets covering lineitem).  The
generator draws the same numbers from the same seed as the reference,
so both packages load identical tables."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..device import DeviceLike
from ..docdb.table_codec import TableInfo
from ..dockv.packed_row import ColumnSchema, ColumnType, TableSchema
from ..dockv.partition import PartitionSchema
from ..ops.expr import Expr
from ..ops.grouped_scan import DictGroupSpec
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


def lineitem_range_info() -> TableInfo:
    """Range-sharded lineitem: rowid is the range PK, so bulk loads land
    key-clustered by rowid and per-block zone maps prune rowid ranges
    (the hash-sharded layout scrambles rowid across blocks)."""
    cols = lineitem_schema().columns
    range_cols = (ColumnSchema(cols[0].id, cols[0].name, cols[0].type,
                               is_range_key=True),) + cols[1:]
    return TableInfo("lineitem_r", "lineitem_r",
                     TableSchema(columns=range_cols, version=1),
                     PartitionSchema("range", 0))


#: TPC-H's flag domains — the string-keyed lineitem maps the synthetic
#: int codes onto them so Q1 groups over dictionary-coded strings
RETFLAG_STRINGS = np.array(["A", "N", "R"], object)
LINESTATUS_STRINGS = np.array(["F", "O"], object)


def lineitem_str_info() -> TableInfo:
    """Range-sharded lineitem with STRING l_returnflag / l_linestatus
    (the TPC-H spec's types): Q1 over it is the dictionary GROUP BY."""
    cols = lineitem_schema().columns
    str_cols = (ColumnSchema(cols[0].id, cols[0].name, cols[0].type,
                             is_range_key=True),) + cols[1:RETFLAG] + (
        ColumnSchema(RETFLAG, "l_returnflag", ColumnType.STRING),
        ColumnSchema(LINESTATUS, "l_linestatus", ColumnType.STRING),
    )
    return TableInfo("lineitem_s", "lineitem_s",
                     TableSchema(columns=str_cols, version=1),
                     PartitionSchema("range", 0))


def lineitem_str_data(data: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
    """The same rows as `data` (generate_lineitem output) with the flag
    columns mapped onto their TPC-H string domains."""
    out = dict(data)
    out["l_returnflag"] = RETFLAG_STRINGS[data["l_returnflag"]]
    out["l_linestatus"] = LINESTATUS_STRINGS[data["l_linestatus"]]
    return out


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


# Q1 over the string-keyed lineitem: the same WHERE and aggregates,
# GROUP BY the two STRING flag columns (6 groups + spill: 8 slots)
def tpch_q1_str() -> QuerySpec:
    return QuerySpec(
        name="q1_str", where=TPCH_Q1.where, aggs=TPCH_Q1.aggs,
        group=DictGroupSpec(cols=(RETFLAG, LINESTATUS)),
        columns=TPCH_Q1.columns)


def numpy_reference(query: QuerySpec, data: Dict[str, np.ndarray]):
    """Direct numpy answer for verification: Q6 -> revenue float; Q1 ->
    {gid: (qty_sum, price_sum, count)} with gid = retflag + 3*linestatus;
    q1_str -> {(returnflag, linestatus) strings: (qty_sum, price_sum,
    count)}, from int-coded or string flag columns."""
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
    if query.name == "q1_str":
        rf, ls = data["l_returnflag"], data["l_linestatus"]
        if rf.dtype != object:
            rf, ls = RETFLAG_STRINGS[rf], LINESTATUS_STRINGS[ls]
        m = data["l_shipdate"] <= _Q1_CUT
        out = {}
        for rv in RETFLAG_STRINGS:
            for lv in LINESTATUS_STRINGS:
                mg = m & (rf == rv) & (ls == lv)
                out[(rv, lv)] = (qty[mg].sum(), price[mg].sum(),
                                 int(mg.sum()))
        return out
    raise ValueError(query.name)


class LineitemTable:
    """The tablets covering the lineitem table, each on `device`."""

    def __init__(self, base_dir: str, num_tablets: int = 1, clock=None,
                 device: DeviceLike = "cuda"):
        from ..tablet import Tablet
        self.info = lineitem_info()
        parts = self.info.partition_schema.create_partitions(num_tablets)
        self.tablets = [
            Tablet(f"lineitem-{i}", self.info, f"{base_dir}/tablet-{i}",
                   clock=clock, partition=p, device=device)
            for i, p in enumerate(parts)]

    def load(self, data: Dict[str, np.ndarray], block_rows: int = 262144
             ) -> int:
        return sum(t.bulk_load(data, block_rows=block_rows)
                   for t in self.tablets)

    def read_request(self, query: QuerySpec, read_ht=None):
        from ..docdb.operations import ReadRequest
        return ReadRequest(
            "lineitem", where=query.where, aggregates=query.aggs,
            group_by=query.group, read_ht=read_ht)

    def run(self, query: QuerySpec, read_ht=None):
        """Execute on every tablet and combine the partials on the host
        in tablet order (the single-process analog of the client's
        combine)."""
        from ..ops.scan import _expand_avg
        total = None
        counts = None
        for t in self.tablets:
            resp = t.read(self.read_request(query, read_ht))
            vals = [np.asarray(v) for v in resp.agg_values]
            if total is None:
                total = vals
                counts = np.asarray(resp.group_counts) \
                    if resp.group_counts is not None else None
            else:
                for i, a in enumerate(_expand_avg(query.aggs)):
                    if a.op in ("sum", "count"):
                        total[i] = total[i] + vals[i]
                    elif a.op == "min":
                        total[i] = np.minimum(total[i], vals[i])
                    else:
                        total[i] = np.maximum(total[i], vals[i])
                if counts is not None:
                    counts = counts + np.asarray(resp.group_counts)
        return total, counts
