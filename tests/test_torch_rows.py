"""Row reads through the port's read seam (yugabyte_db_tpu_torch/docdb/
operations.py: the filter route, ``_gather_rows`` and the server-side
window pushdown) against the JAX reference on the same seeded rows:
Tablet.read and DocReadOperation on the streamed, monolithic, zone-pruned,
dedup, ``limit`` and string-predicate routes give equal responses — the
rows in order with their values and Python types, ``backend``,
``window_served`` and ``window_reason``.  Every row shape the reference
answers on its CPU path (``backend == "cpu"``: enumerated MultiGets on
the hash key, no WHERE, a paging state, pushdown off, small scans, a
predicate the device cannot run) the port answers alike on its
interpreted path."""
import numpy as np
import pytest

from yugabyte_db_tpu.docdb.operations import ReadRequest as JReq
from yugabyte_db_tpu.ops import stream_scan as jss
from yugabyte_db_tpu.ops import window_scan as jws
from yugabyte_db_tpu.utils import hybrid_time as jht
from yugabyte_db_tpu_torch.docdb import operations as pops
from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
from yugabyte_db_tpu_torch.models import tpch
from yugabyte_db_tpu_torch.ops import stream_scan as pss
from yugabyte_db_tpu_torch.ops import window_scan as pws
from yugabyte_db_tpu_torch.ops.expr import Expr
from yugabyte_db_tpu_torch.utils import hybrid_time as pht
from tests.torch_parity import (TABLET_BASE_US, assert_same_cpu_response,
                                flags_set, lineitem_data, tablet_pair)

C = Expr.col
Q, P, D, S, R, L = (tpch.QTY, tpch.EXTPRICE, tpch.DISCOUNT, tpch.SHIPDATE,
                    tpch.RETFLAG, tpch.LINESTATUS)
ROWID = 0
CHUNK = 32768          # streaming_chunk_rows: 4 blocks of 8192 rows
ROWS = 120_000         # SF 0.02
READ_HT = (TABLET_BASE_US + 1000) << 12     # above every load
OVERLAY_US = 500       # the dedup tablet's second load, µs after the first
Q6_COLS = ("rowid", "l_extendedprice", "l_discount", "l_shipdate")


def _flags(streamed=True, **extra):
    both = {"streaming_chunk_rows": CHUNK, "streaming_scan_enabled": streamed}
    both.update(extra)
    return flags_set(both, both)


def _overlay(data):
    """Every 10th rowid with a new l_extendedprice."""
    sel = np.nonzero(data["rowid"] % 10 == 0)[0]
    out = {k: v[sel] for k, v in data.items()}
    out["l_extendedprice"] = out["l_extendedprice"] * 1.5 + 1.0
    return out


@pytest.fixture(scope="module")
def data():
    return lineitem_data(ROWS, seed=11)


@pytest.fixture(scope="module")
def tablets(tmp_path_factory, data):
    root = tmp_path_factory.mktemp("row_tablets")
    out = {kind: tablet_pair(str(root / kind), kind, data)
           for kind in ("hash", "str", "range")}
    (jt,), (pt,) = out["dedup"] = tablet_pair(str(root / "dedup"), "hash",
                                              data)
    over = _overlay(data)
    jt.bulk_load(over, ht=jht.HybridTime.from_micros(
        TABLET_BASE_US + OVERLAY_US), block_rows=8192)
    pt.bulk_load(over, ht=pht.HybridTime.from_micros(
        TABLET_BASE_US + OVERLAY_US), block_rows=8192)
    return out


def _requests(table_id, **kw):
    kw.setdefault("read_ht", READ_HT)
    jw = kw.pop("window", None)
    jreq, preq = JReq(table_id, **kw), ReadRequest(table_id, **kw)
    if jw is not None:
        jreq.window = jws.WindowWire(jw.partition_by, jw.order_by, jw.items)
        preq.window = jw
    return jreq, preq


def _typed(rows):
    return [[(k, type(v)) for k, v in r.items()] for r in rows]


def assert_same_rows(presp, jresp, what=""):
    assert jresp.backend == "tpu" and presp.backend == "tpu", \
        (what, jresp.backend)
    assert presp.rows == jresp.rows, what
    assert _typed(presp.rows) == _typed(jresp.rows), what
    assert presp.paging_state == jresp.paging_state is None, what
    assert presp.window_served == jresp.window_served, what
    assert presp.window_reason == jresp.window_reason, what


def _read(tablets, kind, route="streamed", fl=None, **kw):
    (jt,), (pt,) = tablets[kind]
    table = {"str": "lineitem_s"}.get(kind, "lineitem")
    jreq, preq = _requests(table, **kw)
    with _flags(streamed=route == "streamed", **(fl or {})):
        jss.LAST_STREAM_STATS.clear()
        pss.LAST_STREAM_STATS.clear()
        jresp = jt.read(jreq)
        presp = pt.read(preq)
    return presp, jresp


_RANGE_WHERE = (C(ROWID) < ROWS // 8).node
_SHAPES = {
    # (table kind, request fields)
    "q6_projection": ("hash", dict(columns=Q6_COLS,
                                   where=tpch.TPCH_Q6.where)),
    "q6_all_columns": ("hash", dict(where=tpch.TPCH_Q6.where)),
    "q6_limit": ("hash", dict(columns=Q6_COLS, where=tpch.TPCH_Q6.where,
                              limit=100)),
    "string_predicate": ("str", dict(
        columns=("rowid", "l_returnflag", "l_linestatus", "l_quantity"),
        where=("and", ("cmp", "eq", ("col", R), ("const", "R")),
               ("cmp", "lt", ("col", Q), ("const", 3.0))))),
    "string_in_projection": ("str", dict(
        where=("in", ("col", L), ["O"]), limit=5000)),
    "range_pruned": ("range", dict(
        columns=Q6_COLS, where=("and", _RANGE_WHERE, tpch.TPCH_Q6.where))),
}


@pytest.mark.parametrize("route", ["streamed", "monolithic"])
@pytest.mark.parametrize("shape", sorted(_SHAPES))
def test_row_read_matches_reference(tablets, shape, route):
    kind, kw = _SHAPES[shape]
    presp, jresp = _read(tablets, kind, route, **kw)
    assert_same_rows(presp, jresp, f"{shape} {route}")
    assert len(presp.rows) > 0
    # the same route served both: chunked exactly where the reference
    # chunked
    assert pss.LAST_STREAM_STATS.get("chunks") == \
        jss.LAST_STREAM_STATS.get("chunks")
    assert pops.LAST_ROW_STATS["route"] == (
        "streamed" if jss.LAST_STREAM_STATS else "monolithic")
    assert pops.LAST_ROW_STATS["rows"] == len(presp.rows)


@pytest.mark.parametrize("pruning", [True, False])
@pytest.mark.parametrize("route", ["streamed", "monolithic"])
def test_range_rows_pruned_and_not(tablets, route, pruning):
    kind, kw = _SHAPES["range_pruned"]
    presp, jresp = _read(tablets, kind, route,
                         fl={"zone_map_pruning": pruning}, **kw)
    assert_same_rows(presp, jresp, f"{route} pruning {pruning}")
    if route == "monolithic":
        assert (pops.LAST_SCAN_PRUNE_STATS["blocks_pruned"] > 0) == pruning


def test_row_answers_match_numpy(tablets, data):
    presp, _ = _read(tablets, "hash", **_SHAPES["q6_projection"][1])
    d = data
    m = ((d["l_shipdate"] >= tpch._D1994) & (d["l_shipdate"] < tpch._D1995)
         & (d["l_discount"] >= 0.05) & (d["l_discount"] <= 0.07)
         & (d["l_quantity"] < 24))
    want = {int(r): (float(p), float(s), int(t)) for r, p, s, t in zip(
        d["rowid"][m], d["l_extendedprice"][m], d["l_discount"][m],
        d["l_shipdate"][m])}
    got = {r["rowid"]: (r["l_extendedprice"], r["l_discount"],
                        r["l_shipdate"]) for r in presp.rows}
    assert got == want


@pytest.mark.parametrize("read_us", [250, 1000])
def test_dedup_rows_match_reference(tablets, data, read_us):
    """Two overlapping SSTs (an overlay of every 10th rowid's price at
    +500 µs): below it the first versions, above it the overlay's."""
    kw = dict(_SHAPES["q6_projection"][1],
              read_ht=(TABLET_BASE_US + read_us) << 12)
    presp, jresp = _read(tablets, "dedup", "streamed", **kw)
    assert not pss.LAST_STREAM_STATS          # not chunk-safe: monolithic
    assert_same_rows(presp, jresp, f"dedup at +{read_us}")
    over = {int(r): float(p) for r, p in zip(
        data["rowid"], data["l_extendedprice"] * 1.5 + 1.0)}
    base = {int(r): float(p) for r, p in zip(data["rowid"],
                                             data["l_extendedprice"])}
    for r in presp.rows:
        src = over if read_us > OVERLAY_US and r["rowid"] % 10 == 0 \
            else base
        assert r["l_extendedprice"] == src[r["rowid"]]


# --- server-side windows through the read seam --------------------------------
_WINDOW = pws.WindowWire(
    ("l_returnflag", "l_linestatus"), (("l_shipdate", False),),
    (("row_number", 0, None, "rn"), ("rank", 0, None, "rk"),
     ("dense_rank", 0, None, "dr"), ("count_star", 0, None, "cs"),
     ("sum", 1, "l_shipdate", "cum_ship"),
     ("sum", 0, "l_shipdate", "tot_ship"),
     ("min", 1, "l_shipdate", "min_ship"),
     ("max", 1, "l_shipdate", "max_ship"),
     ("lag", 1, "l_extendedprice", "prev_price"),
     ("lead", 1, "l_extendedprice", "next_price"),
     ("count", 1, "l_discount", "n_disc")))
_WCOLS = Q6_COLS + ("l_returnflag", "l_linestatus", "l_quantity")


@pytest.mark.parametrize("route", ["streamed", "monolithic"])
@pytest.mark.parametrize("kind", ["hash", "str"])
def test_window_rows_match_reference(tablets, kind, route):
    presp, jresp = _read(tablets, kind, route, columns=_WCOLS,
                         where=tpch.TPCH_Q6.where, window=_WINDOW)
    assert presp.window_served and presp.window_reason is None
    assert_same_rows(presp, jresp, f"{kind} {route}")
    assert "next_price" in presp.rows[0]


def _window_refusal(case):
    items = _WINDOW.items
    fl, kw = {}, {}
    if case == "value_kind":
        items = items + (("sum", 1, "l_quantity", "cum_qty"),)
    elif case == "paged":
        kw = {"limit": 1000}
    elif case == "server_off":
        fl = {"window_server_pushdown_enabled": False}
    wire = pws.WindowWire(_WINDOW.partition_by, _WINDOW.order_by, items)
    return wire, fl, kw


@pytest.mark.parametrize("case,reason", [
    ("value_kind", "window_value_kind"), ("paged", "window_paged_scan"),
    ("server_off", "window_server_off")])
def test_window_refusals_match_reference(tablets, case, reason):
    wire, fl, kw = _window_refusal(case)
    before = pws.WINDOW_STATS["fallbacks"]
    presp, jresp = _read(tablets, "hash", "streamed", fl=fl, columns=_WCOLS,
                         where=tpch.TPCH_Q6.where, window=wire, **kw)
    assert presp.window_reason == reason and not presp.window_served
    assert pws.WINDOW_STATS["fallbacks"] == before + 1
    assert_same_rows(presp, jresp, case)
    assert "rn" not in presp.rows[0]          # the rows serve plain


def test_docread_operation_serves_rows_directly(tablets):
    """DocReadOperation.execute on the tablet's store: the same response
    as Tablet.read at an explicit read point."""
    (jt,), (pt,) = tablets["hash"]
    kw = dict(columns=Q6_COLS, where=tpch.TPCH_Q6.where, read_ht=READ_HT)
    with _flags():
        jresp = jt.read(JReq("lineitem", **kw))
        op = pops.DocReadOperation(pt.codec, pt.regular, device="cpu")
        presp = op.execute(ReadRequest("lineitem", **kw))
    assert_same_rows(presp, jresp)


# --- typed refusals: every shape the reference serves on its CPU path ---------
_ENUM = {
    "eq": ("cmp", "eq", ("col", ROWID), ("const", 77)),
    "in": ("in", ("col", ROWID), [5, 9, 11, 10 ** 12]),
    "between": ("between", ("col", ROWID), ("const", 100), ("const", 190)),
    "interval": ("and", ("cmp", "ge", ("col", ROWID), ("const", 10.5)),
                 ("cmp", "lt", ("col", ROWID), ("const", 900))),
    "empty_interval": ("and", ("cmp", "gt", ("col", ROWID), ("const", 50)),
                       ("cmp", "lt", ("col", ROWID), ("const", 40))),
    "eq_and_residual": ("and", ("cmp", "eq", ("col", ROWID), ("const", 6)),
                        tpch.TPCH_Q6.where),
    "max_keys": ("between", ("col", ROWID), ("const", 0), ("const", 1023)),
}


@pytest.mark.parametrize("shape", sorted(_ENUM))
@pytest.mark.parametrize("windowed", [False, True])
def test_enumerated_reads_are_refused(tablets, shape, windowed):
    kw = dict(columns=Q6_COLS, where=_ENUM[shape])
    if windowed:
        kw["window"] = _WINDOW
    (jt,), (pt,) = tablets["hash"]
    jreq, preq = _requests("lineitem", **kw)
    with _flags():
        jresp, presp = jt.read(jreq), pt.read(preq)
    assert_same_cpu_response(presp, jresp, shape)


def test_past_the_enumeration_cap_takes_the_filter_route(tablets):
    """1025 keys: over hash_scan_enumerate_max, so both packages serve
    the interval on the device filter route, in block order."""
    where = ("between", ("col", ROWID), ("const", 0), ("const", 1024))
    presp, jresp = _read(tablets, "hash", columns=Q6_COLS, where=where)
    assert_same_rows(presp, jresp)
    assert len(presp.rows) == 1025


def test_range_table_rowid_reads_take_the_filter_route(tablets):
    """No enumeration on a range table: the same = read is a filter
    read there."""
    presp, jresp = _read(tablets, "range", columns=Q6_COLS,
                         where=_ENUM["eq"])
    assert_same_rows(presp, jresp)
    assert [r["rowid"] for r in presp.rows] == [77]


_CPU_SHAPES = {
    # (request fields, flags)
    "no_where": (dict(columns=Q6_COLS), {}),
    "paged": (dict(columns=Q6_COLS, where=tpch.TPCH_Q6.where,
                   paging_state=b"\x00"), {}),
    "pushdown_off": (dict(where=tpch.TPCH_Q6.where),
                     {"tpu_pushdown_enabled": False}),
    "min_rows": (dict(where=tpch.TPCH_Q6.where),
                 {"tpu_min_rows_for_pushdown": 10 ** 9}),
    "not_device_expr": (dict(where=("in", ("col", Q), [1.0, None])), {}),
}


@pytest.mark.parametrize("shape", sorted(_CPU_SHAPES))
def test_cpu_row_shapes_are_refused(tablets, shape):
    kw, fl = _CPU_SHAPES[shape]
    (jt,), (pt,) = tablets["hash"]
    jreq, preq = _requests("lineitem", **kw)
    with _flags(**fl):
        jresp, presp = jt.read(jreq), pt.read(preq)
    assert_same_cpu_response(presp, jresp, shape)
    assert presp.rows


@pytest.mark.parametrize("route", ["streamed", "monolithic"])
def test_unrewritable_string_predicate_is_refused(tablets, route):
    """Two dictionary columns compared: the filter route of both
    packages falls to the interpreted row loop, with the same rows."""
    kw = dict(where=("cmp", "eq", ("col", R), ("col", L)))
    (jt,), (pt,) = tablets["str"]
    jreq, preq = _requests("lineitem_s", **kw)
    with _flags(streamed=route == "streamed"):
        jresp, presp = jt.read(jreq), pt.read(preq)
    assert_same_cpu_response(presp, jresp, route)
