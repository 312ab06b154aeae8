"""TPC-H: lineitem with Q6 and Q1, and the join tables with Q3/Q5/Q10.

Counterpart of ``yugabyte_db_tpu/models/tpch.py``: the lineitem schema,
its range-sharded and string-keyed variants, generator, Q6/Q1 specs, Q1
grouped by the flag strings, their direct numpy answers and
``LineitemTable`` (the set of tablets covering lineitem); the orders and
customer tables with the l_orderkey-carrying lineitem clone, the Q3-ish
single join, the chained Q3/Q5/Q10 (lineitem -> orders -> customer) with
their shipped build sides and numpy answers, and the 22-query registry
(``tpch_queries``) with a runnable spec or a typed reason per query.
The generators draw the same numbers from the same seeds as the
reference, so both packages load identical tables."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

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


def refresh_inserts(sf: float, first_rowid: int, seed: int = 0
                    ) -> List[Dict[str, np.ndarray]]:
    """TPC-H RF1 (spec v3.0.1 §2.26.2) on this lineitem: SF x 1500 new
    orders, each of 1-7 lineitems drawn like :func:`generate_lineitem`'s
    rows, with rowids from `first_rowid` up.  One column dict per order
    (one write request each)."""
    rng = np.random.default_rng(seed)
    n_orders = max(1, int(round(1500 * sf)))
    sizes = rng.integers(1, 8, n_orders)
    rows = generate_lineitem(int(sizes.sum()) / ROWS_PER_SF, seed=seed + 1)
    rows["rowid"] = rows["rowid"] + np.int64(first_rowid)
    ends = np.cumsum(sizes)
    return [{k: v[e - n:e] for k, v in rows.items()}
            for n, e in zip(sizes, ends)]


def refresh_deletes(sf: float, n_rows: int, seed: int = 0
                    ) -> List[np.ndarray]:
    """TPC-H RF2 (spec v3.0.1 §2.26.3) on this lineitem, whose orders
    are runs of consecutive rowids: the lineitems of SF x 1500 existing
    orders, each a run of 1-7 rowids at a seeded start below `n_rows`.
    One int64 rowid array per order (one delete request each)."""
    rng = np.random.default_rng(seed)
    n_orders = max(1, int(round(1500 * sf)))
    starts = rng.integers(0, max(1, n_rows - 7), n_orders)
    sizes = rng.integers(1, 8, n_orders)
    return [np.arange(s, s + n, dtype=np.int64)
            for s, n in zip(starts, sizes)]


def column_rows(cols: Dict[str, np.ndarray]) -> List[Dict[str, object]]:
    """Column arrays -> row dicts of Python scalars (write requests)."""
    names = list(cols)
    return [dict(zip(names, vals))
            for vals in zip(*(cols[n].tolist() for n in names))]


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


# ---------------------------------------------------------------------------
# Joins: orders, the l_orderkey FK, and the Q3-ish fused join
# ---------------------------------------------------------------------------

L_ORDERKEY = 8

O_ORDERKEY, O_ORDERDATE, O_PRIO = 0, 1, 2

#: TPC-H o_orderpriority domain: the string dimension attribute the fused
#: join + group plan groups by (a dict-coded build payload)
PRIO_STRINGS = np.array(["1-URGENT", "2-HIGH", "3-MEDIUM",
                         "4-NOT SPECIFIED", "5-LOW"], object)

#: lineitems per order (the TPC-H fanout is 1..7, avg 4)
LINES_PER_ORDER = 4


def orders_schema() -> TableSchema:
    return TableSchema(columns=(
        ColumnSchema(O_ORDERKEY, "o_orderkey", ColumnType.INT64,
                     is_range_key=True),
        ColumnSchema(O_ORDERDATE, "o_orderdate", ColumnType.INT32),
        ColumnSchema(O_PRIO, "o_orderpriority", ColumnType.STRING),
    ), version=1)


def orders_info() -> TableInfo:
    return TableInfo("orders", "orders", orders_schema(),
                     PartitionSchema("range", 0))


def lineitem_join_info() -> TableInfo:
    """Range-sharded lineitem clone carrying the l_orderkey FK: the probe
    side of the fused join plans."""
    cols = lineitem_schema().columns
    jcols = (ColumnSchema(cols[0].id, cols[0].name, cols[0].type,
                          is_range_key=True),) + cols[1:] + (
        ColumnSchema(L_ORDERKEY, "l_orderkey", ColumnType.INT64),)
    return TableInfo("lineitem_j", "lineitem_j",
                     TableSchema(columns=jcols, version=1),
                     PartitionSchema("range", 0))


def generate_orders(n_orders: int, seed: int = 1
                    ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "o_orderkey": np.arange(n_orders, dtype=np.int64),
        "o_orderdate": rng.integers(8036, 10592, n_orders
                                    ).astype(np.int32),
        "o_orderpriority": PRIO_STRINGS[rng.integers(0, 5, n_orders)],
    }


def lineitem_join_data(data: Dict[str, np.ndarray],
                       n_orders: int) -> Dict[str, np.ndarray]:
    """`data` rows plus an l_orderkey FK: LINES_PER_ORDER consecutive
    lineitems share one order (clipped into the key domain)."""
    out = dict(data)
    out["l_orderkey"] = np.minimum(
        data["rowid"] // LINES_PER_ORDER,
        max(n_orders - 1, 0)).astype(np.int64)
    return out


@dataclass(frozen=True)
class JoinQuerySpec:
    """A fused filter -> join -> group -> aggregate plan shape: a
    probe-side WHERE over lineitem_j ids, a build-side orders filter
    (applied by the SENDER before shipping: inner-join semantics make it
    equal to a post-join predicate), aggregates and group over probe ids
    and build payload ids (>= BUILD_COL_BASE)."""
    name: str
    probe_where: Optional[tuple]
    build_date_lo: int
    build_date_hi: int
    aggs: Tuple[AggSpec, ...]
    group: object
    probe_columns: Tuple[int, ...]


def prio_build_col() -> int:
    from ..ops.join_scan import BUILD_COL_BASE
    return BUILD_COL_BASE


#: one quarter of o_orderdate: keeps the shipped build side small (the
#: dimension-side contract of the join pushdown)
_Q3_LO, _Q3_HI = _D1994, _D1994 + 91


def tpch_q3ish() -> JoinQuerySpec:
    """Q3/Q5-shaped: revenue by o_orderpriority over one order quarter.
    SELECT o_orderpriority, sum(l_extendedprice * (1 - l_discount)),
    count(*) FROM lineitem JOIN orders ON l_orderkey = o_orderkey WHERE
    l_shipdate >= 1994-01-01 AND o_orderdate in the quarter GROUP BY
    o_orderpriority."""
    return JoinQuerySpec(
        name="q3ish",
        probe_where=(C(SHIPDATE) >= _D1994).node,
        build_date_lo=_Q3_LO, build_date_hi=_Q3_HI,
        aggs=(AggSpec("sum", (C(EXTPRICE)
                              * (Expr.const(1.0) - C(DISCOUNT))).node),
              AggSpec("count")),
        group=DictGroupSpec(cols=(prio_build_col(),)),
        probe_columns=(EXTPRICE, DISCOUNT, SHIPDATE, L_ORDERKEY),
    )


def orders_build_wire(q: JoinQuerySpec, odata: Dict[str, np.ndarray]):
    """The shipped build side for `q`: the orders keys inside the date
    window plus the o_orderpriority payload column."""
    from ..ops.join_scan import JoinWire
    m = ((odata["o_orderdate"] >= q.build_date_lo)
         & (odata["o_orderdate"] < q.build_date_hi))
    return JoinWire(
        probe_col=L_ORDERKEY,
        keys=odata["o_orderkey"][m],
        payload={prio_build_col(): (odata["o_orderpriority"][m],
                                    None)})


def numpy_reference_join(q: JoinQuerySpec,
                         ldata: Dict[str, np.ndarray],
                         odata: Dict[str, np.ndarray]):
    """{o_orderpriority: (count, revenue)} straight from numpy."""
    ok = ldata["l_orderkey"]
    od = odata["o_orderdate"][ok]
    m = ((ldata["l_shipdate"] >= _D1994)
         & (od >= q.build_date_lo) & (od < q.build_date_hi))
    prio = odata["o_orderpriority"][ok]
    rev = ldata["l_extendedprice"] * (1.0 - ldata["l_discount"])
    out = {}
    for p in PRIO_STRINGS:
        mg = m & (prio == p)
        out[p] = (int(mg.sum()), float(rev[mg].sum()))
    return out


# ---------------------------------------------------------------------------
# Whole queries: the customer dimension, multi-join chains and the 22-query
# registry (a runnable adapted spec or a TYPED reason per query)
# ---------------------------------------------------------------------------

C_CUSTKEY, C_MKTSEGMENT, C_NATION = 0, 1, 2

#: appended column id on the orders_c clone (the chain FK to customer)
O_CUSTKEY = 3

#: TPC-H spec cardinalities per scale factor
ORDERS_PER_SF = 1_500_000
CUSTOMERS_PER_SF = 150_000

MKTSEG_STRINGS = np.array(
    ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"],
    object)

NATION_STRINGS = np.array(
    ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "CHINA", "EGYPT",
     "ETHIOPIA", "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN",
     "IRAQ", "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE",
     "PERU", "ROMANIA", "RUSSIA", "SAUDI ARABIA", "UNITED KINGDOM",
     "UNITED STATES", "VIETNAM"], object)


def customer_schema() -> TableSchema:
    return TableSchema(columns=(
        ColumnSchema(C_CUSTKEY, "c_custkey", ColumnType.INT64,
                     is_range_key=True),
        ColumnSchema(C_MKTSEGMENT, "c_mktsegment", ColumnType.STRING),
        ColumnSchema(C_NATION, "c_nation", ColumnType.STRING),
    ), version=1)


def customer_info() -> TableInfo:
    return TableInfo("customer", "customer", customer_schema(),
                     PartitionSchema("range", 0))


def orders_cust_schema() -> TableSchema:
    """orders + the o_custkey FK: the middle table of the 3-table chain
    (lineitem -> orders_c -> customer), a separate clone so the 2-table
    shapes keep their schema."""
    return TableSchema(columns=orders_schema().columns + (
        ColumnSchema(O_CUSTKEY, "o_custkey", ColumnType.INT64),),
        version=1)


def orders_cust_info() -> TableInfo:
    return TableInfo("orders_c", "orders_c", orders_cust_schema(),
                     PartitionSchema("range", 0))


def generate_customer(n_customers: int, seed: int = 2
                      ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "c_custkey": np.arange(n_customers, dtype=np.int64),
        "c_mktsegment": MKTSEG_STRINGS[rng.integers(0, len(MKTSEG_STRINGS),
                                                    n_customers)],
        "c_nation": NATION_STRINGS[rng.integers(0, len(NATION_STRINGS),
                                                n_customers)],
    }


def generate_orders_cust(n_orders: int, n_customers: int, seed: int = 1
                         ) -> Dict[str, np.ndarray]:
    out = generate_orders(n_orders, seed)
    rng = np.random.default_rng(seed + 7)
    out["o_custkey"] = rng.integers(0, max(n_customers, 1),
                                    n_orders).astype(np.int64)
    return out


def chain_bids() -> Dict[str, int]:
    """Fixed payload-lane ids of the lineitem -> orders_c -> customer
    chain (one shared BUILD_COL_BASE counter)."""
    from ..ops.join_scan import BUILD_COL_BASE
    return {"o_custkey": BUILD_COL_BASE,
            "o_orderpriority": BUILD_COL_BASE + 1,
            "c_mktsegment": BUILD_COL_BASE + 2,
            "c_nation": BUILD_COL_BASE + 3}


@dataclass(frozen=True)
class ChainQuerySpec:
    """A 3-table fused chain: lineitem_j probes orders_c (stage 0, by
    l_orderkey), then the o_custkey payload LANE probes customer (stage
    1), in one fused plan under one shared row mask.  The build-side
    filters (order date window, customer segment) are applied by the
    sender; inner-join semantics make that equal to a post-join
    predicate."""
    name: str
    probe_where: Optional[tuple]
    order_date_lo: Optional[int]
    order_date_hi: Optional[int]
    cust_seg: Optional[str]
    order_payload: Tuple[str, ...]      # extra stage-0 payload names
    cust_payload: Tuple[str, ...]       # stage-1 payload names
    group_col: str                      # payload name the group rides on
    aggs: Tuple[AggSpec, ...]
    probe_columns: Tuple[int, ...]


#: Q3's cutoff date (1995-03-15)
_Q3_CUT = 9204


def _chain_group(group_col: str):
    return DictGroupSpec(cols=(chain_bids()[group_col],))


_REV = AggSpec("sum", (C(EXTPRICE) * (Expr.const(1.0)
                                      - C(DISCOUNT))).node)


def tpch_q3_chain() -> ChainQuerySpec:
    """Q3 adapted: revenue by o_orderpriority for BUILDING-segment
    customers, o_orderdate < 1995-03-15 < l_shipdate.  The spec's GROUP BY
    l_orderkey (a 1.5M/SF domain) is lowered to the dict-coded priority
    dimension; group_domain is the typed reason the literal shape
    refuses."""
    return ChainQuerySpec(
        name="q3", probe_where=(C(SHIPDATE) > _Q3_CUT).node,
        order_date_lo=None, order_date_hi=_Q3_CUT,
        cust_seg="BUILDING",
        order_payload=("o_orderpriority",), cust_payload=(),
        group_col="o_orderpriority",
        aggs=(_REV, AggSpec("count")),
        probe_columns=(EXTPRICE, DISCOUNT, SHIPDATE, L_ORDERKEY))


def tpch_q5_chain() -> ChainQuerySpec:
    """Q5 adapted: 1994 revenue by customer nation.  The supplier, nation
    and region legs are dropped (table_coverage): nation rides as a
    denormalized customer attribute."""
    return ChainQuerySpec(
        name="q5", probe_where=None,
        order_date_lo=_D1994, order_date_hi=_D1995,
        cust_seg=None,
        order_payload=(), cust_payload=("c_nation",),
        group_col="c_nation",
        aggs=(_REV, AggSpec("count")),
        probe_columns=(EXTPRICE, DISCOUNT, L_ORDERKEY))


def tpch_q10_chain() -> ChainQuerySpec:
    """Q10 adapted: returned-item (l_returnflag = 'R') revenue by customer
    nation over one order quarter.  GROUP BY c_custkey (150k/SF, top-20)
    is lowered to c_nation; group_domain is the typed reason the literal
    shape refuses."""
    return ChainQuerySpec(
        name="q10",
        probe_where=C(RETFLAG).eq(
            int(np.flatnonzero(RETFLAG_STRINGS == "R")[0])).node,
        order_date_lo=_D1994, order_date_hi=_D1994 + 91,
        cust_seg=None,
        order_payload=(), cust_payload=("c_nation",),
        group_col="c_nation",
        aggs=(_REV, AggSpec("count")),
        probe_columns=(EXTPRICE, DISCOUNT, RETFLAG, L_ORDERKEY))


def chain_build_wires(q: ChainQuerySpec,
                      odata: Dict[str, np.ndarray],
                      cdata: Dict[str, np.ndarray]):
    """The ordered 2-stage JoinWire list for `q` (the probe order is the
    list order): filtered orders_c keyed by o_orderkey shipping the
    o_custkey lane, then filtered customer keyed by c_custkey, probed
    THROUGH that lane."""
    from ..ops.join_scan import JoinWire
    bids = chain_bids()
    mo = np.ones(len(odata["o_orderkey"]), bool)
    if q.order_date_lo is not None:
        mo &= odata["o_orderdate"] >= q.order_date_lo
    if q.order_date_hi is not None:
        mo &= odata["o_orderdate"] < q.order_date_hi
    opay = {bids["o_custkey"]: (odata["o_custkey"][mo], None)}
    for nm in q.order_payload:
        opay[bids[nm]] = (odata[nm][mo], None)
    mc = np.ones(len(cdata["c_custkey"]), bool)
    if q.cust_seg is not None:
        mc &= cdata["c_mktsegment"] == q.cust_seg
    cpay = {bids[nm]: (cdata[nm][mc], None) for nm in q.cust_payload}
    return (JoinWire(probe_col=L_ORDERKEY,
                     keys=odata["o_orderkey"][mo], payload=opay),
            JoinWire(probe_col=bids["o_custkey"],
                     keys=cdata["c_custkey"][mc], payload=cpay))


def numpy_reference_chain(q: ChainQuerySpec,
                          ldata: Dict[str, np.ndarray],
                          odata: Dict[str, np.ndarray],
                          cdata: Dict[str, np.ndarray]):
    """{group string: (count, revenue)} straight from numpy."""
    ok = ldata["l_orderkey"]
    ck = odata["o_custkey"][ok]
    m = np.ones(len(ok), bool)
    if q.name == "q3":
        m &= ldata["l_shipdate"] > _Q3_CUT
    elif q.name == "q10":
        m &= (ldata["l_returnflag"]
              == int(np.flatnonzero(RETFLAG_STRINGS == "R")[0]))
    od = odata["o_orderdate"][ok]
    if q.order_date_lo is not None:
        m &= od >= q.order_date_lo
    if q.order_date_hi is not None:
        m &= od < q.order_date_hi
    if q.cust_seg is not None:
        m &= cdata["c_mktsegment"][ck] == q.cust_seg
    gvals = (odata[q.group_col][ok] if q.group_col.startswith("o_")
             else cdata[q.group_col][ck])
    rev = ldata["l_extendedprice"] * (1.0 - ldata["l_discount"])
    domain = (PRIO_STRINGS if q.group_col == "o_orderpriority"
              else NATION_STRINGS if q.group_col == "c_nation"
              else MKTSEG_STRINGS)
    out = {}
    for g in domain:
        mg = m & (gvals == g)
        out[g] = (int(mg.sum()), float(rev[mg].sum()))
    return out


# --- the 22-query registry -------------------------------------------------

#: typed reasons a TPC-H query is inexpressible on this engine: the
#: registry names each, never a silent skip
REASON_TABLE_COVERAGE = "table_coverage"    # part/supplier/partsupp/
                                            # nation/region not modeled
REASON_SUBQUERY = "subquery_shape"          # correlated/scalar subquery
REASON_SEMI_JOIN = "semi_join"              # EXISTS / NOT EXISTS
REASON_OUTER_JOIN = "outer_join"            # LEFT OUTER JOIN
REASON_GROUP_DOMAIN = "group_domain"        # group key domain too wide
REASON_EXPR_SHAPE = "expr_shape"            # CASE/LIKE/substring aggs


@dataclass(frozen=True)
class TpchEntry:
    """One TPC-H query: `kind` is scan/join/chain with a runnable
    (possibly adapted) spec, or "inexpressible" with a typed `reason`.
    `note` records the adaptation or the refusal's detail."""
    name: str
    kind: str                   # "scan" | "join" | "chain" | "inexpressible"
    note: str
    spec: object = None
    reason: Optional[str] = None


def tpch_queries() -> Dict[str, TpchEntry]:
    """All 22 TPC-H queries, in order.  Runnable entries carry a spec for
    the device path; the rest carry a typed refusal reason."""
    E = TpchEntry
    return {e.name: e for e in (
        E("q1", "scan", "pricing summary — dict-key GROUP BY over the "
          "STRING flag columns", tpch_q1_str()),
        E("q2", "inexpressible", "min-cost supplier: part/supplier/"
          "partsupp/nation/region + correlated MIN subquery",
          reason=REASON_TABLE_COVERAGE),
        E("q3", "chain", "shipping priority — GROUP BY l_orderkey "
          "(1.5M/SF domain) lowered to o_orderpriority",
          tpch_q3_chain()),
        E("q4", "inexpressible", "order priority checking: EXISTS "
          "semi-join counting ORDERS, not lineitems",
          reason=REASON_SEMI_JOIN),
        E("q5", "chain", "local supplier volume — supplier/nation/"
          "region legs dropped; nation rides on customer",
          tpch_q5_chain()),
        E("q6", "scan", "forecasting revenue change — literal",
          TPCH_Q6),
        E("q7", "inexpressible", "volume shipping: supplier + nation "
          "pair (supp_nation, cust_nation) not modeled",
          reason=REASON_TABLE_COVERAGE),
        E("q8", "inexpressible", "national market share: 8-table join "
          "over part/supplier/nation/region",
          reason=REASON_TABLE_COVERAGE),
        E("q9", "inexpressible", "product type profit: part/supplier/"
          "partsupp not modeled", reason=REASON_TABLE_COVERAGE),
        E("q10", "chain", "returned items — GROUP BY c_custkey "
          "(150k/SF, top-20) lowered to c_nation", tpch_q10_chain()),
        E("q11", "inexpressible", "important stock: partsupp/supplier/"
          "nation + HAVING scalar subquery",
          reason=REASON_TABLE_COVERAGE),
        E("q12", "inexpressible", "shipping modes: CASE conditional "
          "aggregates; l_shipmode/commitdate/receiptdate not modeled",
          reason=REASON_EXPR_SHAPE),
        E("q13", "inexpressible", "customer distribution: LEFT OUTER "
          "JOIN + group-over-count", reason=REASON_OUTER_JOIN),
        E("q14", "inexpressible", "promotion effect: part + LIKE-"
          "guarded conditional aggregate", reason=REASON_EXPR_SHAPE),
        E("q15", "inexpressible", "top supplier: supplier + view with "
          "scalar MAX subquery", reason=REASON_SUBQUERY),
        E("q16", "inexpressible", "parts/supplier relationship: part/"
          "partsupp + COUNT DISTINCT", reason=REASON_TABLE_COVERAGE),
        E("q17", "inexpressible", "small-quantity-order revenue: "
          "correlated AVG subquery per part", reason=REASON_SUBQUERY),
        E("q18", "inexpressible", "large volume customer: HAVING "
          "SUM(qty) subquery over the 1.5M/SF orderkey domain",
          reason=REASON_SUBQUERY),
        E("q19", "inexpressible", "discounted revenue: part table not "
          "modeled (the OR-of-triples predicate itself is "
          "expressible)", reason=REASON_TABLE_COVERAGE),
        E("q20", "inexpressible", "potential part promotion: nested "
          "IN subqueries over part/partsupp/supplier",
          reason=REASON_SUBQUERY),
        E("q21", "inexpressible", "suppliers who kept orders waiting: "
          "supplier + EXISTS/NOT EXISTS self-joins",
          reason=REASON_SEMI_JOIN),
        E("q22", "inexpressible", "global sales opportunity: "
          "substring() + NOT EXISTS + scalar AVG subquery",
          reason=REASON_SUBQUERY),
    )}


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
