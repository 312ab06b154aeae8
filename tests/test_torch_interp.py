"""The port's interpreted read paths (yugabyte_db_tpu_torch/docdb/
operations.py: eval_expr_py, classify_scan_options and _scan_segments,
_execute_cpu with its aggregates and GROUP BY, _iter_visible_idrows and
_execute_join_cpu) against the JAX reference on the CPU: the evaluator
on the reference's expression shapes (SQL three-valued logic, string,
array, numeric, date and JSON functions) and on hypothesis-drawn
expression trees with NULLs, equal values and Python types, or the same
exception class; interpreted aggregates, dense/hash/dictionary GROUP
BY, row reads with ``limit`` and ``paging_state`` and skip-scan segments
on a range-sharded tablet; and the interpreted join on the join tests'
shapes (string FKs, chains, duplicate build keys, NULL payloads,
dangling keys).  Tolerance: none."""
import datetime
import decimal

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from yugabyte_db_tpu.docdb import operations as jops
from yugabyte_db_tpu.docdb.operations import ReadRequest as JReq
from yugabyte_db_tpu_torch.docdb import operations as pops
from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
from yugabyte_db_tpu_torch.ops.grouped_scan import DictGroupSpec
from yugabyte_db_tpu_torch.ops.scan import AggSpec, GroupSpec, HashGroupSpec
from tests.torch_parity import (BID, JOIN_READ_HT, assert_same_cpu_response,
                                flags_set, join_requests, kv_infos, kv_row,
                                kv_tablet_pair, probe_data, probe_pair,
                                to_jax_aggs, to_jax_group, wire_pair,
                                write_both)


# --- eval_expr_py ---------------------------------------------------------------
def _canon(x):
    """Value with its Python type, recursively (floats by their bits)."""
    if isinstance(x, list):
        return ("list", [_canon(v) for v in x])
    if isinstance(x, float):
        return ("float", x.hex())
    if isinstance(x, decimal.Decimal):
        return ("Decimal", str(x))
    return (type(x).__name__, x)


def _eval_both(node, row):
    """(kind, value) of each package's evaluation: the value, or the
    exception class name."""
    out = []
    for f in (jops.eval_expr_py, pops.eval_expr_py):
        try:
            out.append(("ok", _canon(f(node, row))))
        except Exception as e:          # noqa: BLE001 — compared below
            out.append(("raise", type(e).__name__))
    return out


_TS = int(datetime.datetime(2024, 2, 29, 13, 45, 7, 250000,
                            tzinfo=datetime.timezone.utc).timestamp()
          * 1_000_000)
ROWS = [
    {0: 7, 1: 2.5, 2: "Hello_World", 3: None, 4: _TS, 5: "[1, 2, null]",
     6: '{"a": {"b": 2}, "c": [1, "x"]}', 7: decimal.Decimal("3.25")},
    {0: -7, 1: -0.5, 2: "", 3: 3, 4: 0, 5: None, 6: None, 7: None},
    {0: 0, 1: 0.0, 2: "a%b", 3: 0, 4: -86_400_000_001, 5: "[]",
     6: "not json", 7: decimal.Decimal("-1.5")},
]


def c(i):
    return ("col", i)


def k(v):
    return ("const", v)


def fn(name, *args):
    return ("fn", name) + args


SHAPES = [
    ("cmp", "lt", c(0), c(1)), ("cmp", "eq", c(2), k("")),
    ("cmp", "ne", c(3), k(0)), ("cmp", "ge", c(7), c(1)),
    ("arith", "add", c(0), c(1)), ("arith", "sub", c(0), c(3)),
    ("arith", "mul", c(1), c(7)), ("arith", "div", c(0), c(1)),
    ("arith", "div", c(0), k(2)), ("arith", "mod", c(0), k(3)),
    ("arith", "mod", c(1), k(0.75)), ("arith", "concat", c(2), c(0)),
    ("arith", "concat", ("array", c(0), c(3)), c(2)),
    ("arith", "concat", c(2), ("array", c(0))), ("arith", "pow", c(0), c(1)),
    ("and", ("cmp", "gt", c(0), k(0)), ("isnull", c(3))),
    ("or", ("cmp", "gt", c(3), k(1)), ("cmp", "lt", c(0), k(0))),
    ("not", ("cmp", "eq", c(3), k(3))),
    ("between", c(0), k(-10), c(3)), ("between", c(1), k(-1), k(3)),
    ("in", c(0), [1, 7, -7]), ("in", c(3), [1, None]),
    ("not", ("in", c(0), [1, None])),
    ("in", c(0), list(range(40)) + [None]), ("in", c(0), list(range(-40, 0))),
    ("isnull", c(3)), ("isdistinct", c(3), k(None)),
    ("isdistinct", c(0), c(3)), ("like", c(2), "H%o_W%"),
    ("ilike", c(2), "hello%"), ("like", c(2), "a\\%b"),
    ("case", 2, ("cmp", "gt", c(0), k(0)), k("pos"),
     ("cmp", "lt", c(0), k(0)), k("neg"), k("zero")),
    ("anyall", "any", "eq", c(0), c(5)), ("anyall", "all", "gt", c(0), c(5)),
    ("anyall", "any", "gt", k(0), ("array", c(0), c(3))),
    ("json", "text", c(6), "a"), ("json", "value", c(6), "c"),
    ("json", "text", ("json", "value", c(6), "a"), "b"),
    ("json", "value", c(6), "zz"), ("unknown_node", c(0)),
    fn("coalesce", c(3), c(0)), fn("nullif", c(0), k(7)),
    fn("greatest", c(0), c(3), c(1)), fn("least", c(3), k(None)),
    fn("abs", c(0)), fn("round", c(1)), fn("round", c(1), k(1)),
    fn("round", c(7), k(1)), fn("floor", c(1)), fn("ceil", c(1)),
    fn("upper", c(2)), fn("lower", c(2)), fn("length", c(2)),
    fn("cast_numeric", c(1)), fn("cast_bigint", c(1)),
    fn("cast_int", c(7)), fn("cast_double", c(0)), fn("cast_text", c(1)),
    fn("substr", c(2), k(2), k(3)), fn("substring", c(2), k(0)),
    fn("substr", c(2), k(-1), k(3)), fn("replace", c(2), k("l"), k("L")),
    fn("trim", k("  x "),), fn("ltrim", c(2), k("H")),
    fn("rtrim", c(2), k("d")), fn("strpos", c(2), k("o")),
    fn("left", c(2), k(3)), fn("left", c(2), k(-3)),
    fn("right", c(2), k(2)), fn("right", c(2), k(-2)),
    fn("right", c(2), k(0)), fn("lpad", c(2), k(14), k("ab")),
    fn("rpad", c(2), k(3)), fn("split_part", c(2), k("_"), k(2)),
    fn("split_part", c(2), k("_"), k(5)), fn("starts_with", c(2), k("He")),
    fn("initcap", k("hello wORLD 9x")), fn("reverse", c(2)),
    fn("subscript", c(5), k(2)), fn("subscript", c(5), k(9)),
    fn("array_length", c(5), k(1)), fn("array_length", c(5), k(2)),
    fn("cardinality", c(5)), fn("array_position", c(5), k(2)),
    fn("array_prepend", k(0), c(5)), fn("array_append", c(5), c(3)),
    fn("trunc", c(1)), fn("trunc", c(7), k(1)), fn("sqrt", c(1)),
    fn("power", c(0), k(2)), fn("power", c(7), k(2)), fn("mod", c(0), c(3)),
    fn("concat", c(2), c(3), c(0)), fn("date_trunc", k("month"), c(4)),
    fn("date_trunc", k("week"), c(4)), fn("date_trunc", k("year"), c(4)),
    fn("date_trunc", k("hour"), c(4)), fn("date_trunc", k("minute"), c(4)),
    fn("date_trunc", k("second"), c(4)), fn("date_trunc", k("day"), c(4)),
    fn("date_trunc", k("fortnight"), c(4)), fn("extract_epoch", c(4)),
    fn("extract_year", c(4)), fn("extract_month", c(4)),
    fn("extract_day", c(4)), fn("extract_hour", c(4)),
    fn("extract_minute", c(4)), fn("extract_second", c(4)),
    fn("extract_dow", c(4)), fn("extract_doy", c(4)),
    fn("extract_week", c(4)), fn("extract_century", c(4)),
    fn("no_such_fn", c(0)),
]


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_eval_expr_py_matches_reference_on_shapes(i):
    node = SHAPES[i]
    for row in ROWS:
        got, want = _eval_both(node, row)
        assert got == want, (node, row, got, want)


_CMP = st.sampled_from(["lt", "le", "gt", "ge", "eq", "ne"])
_NUM_LEAF = st.one_of(
    st.sampled_from([c(0), c(1), c(3)]),
    st.builds(k, st.one_of(st.none(), st.integers(-5, 5),
                           st.floats(-4, 4, allow_nan=False,
                                     allow_infinity=False))))


def _num_tree(children):
    return st.one_of(
        st.tuples(st.just("arith"),
                  st.sampled_from(["add", "sub", "mul", "div", "mod"]),
                  children, children),
        st.builds(lambda a, b: fn("coalesce", a, b), children, children),
        st.builds(lambda a: fn("abs", a), children),
        st.builds(lambda a, b: fn("greatest", a, b), children, children))


_NUM = st.recursive(_NUM_LEAF, _num_tree, max_leaves=6)


def _bool_tree(children):
    return st.one_of(
        st.tuples(st.sampled_from(["and", "or"]), children, children),
        st.tuples(st.just("not"), children))


_BOOL = st.recursive(
    st.one_of(st.tuples(st.just("cmp"), _CMP, _NUM, _NUM),
              st.tuples(st.just("between"), _NUM, _NUM, _NUM),
              st.tuples(st.just("in"), _NUM,
                        st.lists(st.one_of(st.none(), st.integers(-3, 3)),
                                 max_size=4)),
              st.tuples(st.just("isnull"), _NUM),
              st.tuples(st.just("isdistinct"), _NUM, _NUM),
              st.tuples(st.just("like"), st.just(c(2)),
                        st.sampled_from(["%", "a%", "_b%", "%c"]))),
    _bool_tree, max_leaves=5)
_ROW = st.fixed_dictionaries({
    0: st.one_of(st.none(), st.integers(-9, 9)),
    1: st.one_of(st.none(), st.floats(-9, 9, allow_nan=False,
                                      allow_infinity=False)),
    2: st.one_of(st.none(), st.text("abc", max_size=4)),
    3: st.one_of(st.none(), st.integers(-2, 2))})


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(node=st.one_of(_BOOL, _NUM), row=_ROW)
def test_eval_expr_py_matches_reference_on_random_trees(node, row):
    got, want = _eval_both(node, row)
    assert got == want, (node, row)


# --- the interpreted scan: aggregates, groups, pages, skip-scan segments ---------
@pytest.fixture(scope="module")
def range_tablets(tmp_path_factory):
    """Range-sharded (k int64, r int32) tablets after seeded writes, two
    flushes and a memtable tail."""
    jt, pt, jphys, pphys = kv_tablet_pair(
        str(tmp_path_factory.mktemp("interp")), "rangepk")
    rng = np.random.default_rng(12)
    for step in range(240):
        for phys in (jphys, pphys):
            phys.advance_micros(7)
        ops = [("upsert", kv_row(rng, int(rng.integers(0, 60)), "rangepk"))
               for _ in range(int(rng.integers(1, 4)))]
        if rng.random() < 0.15:
            ops.append(("delete", {"k": int(rng.integers(0, 60)),
                                   "r": int(rng.integers(-3, 4))}))
        write_both(jt, pt, ops, 3 if rng.random() < 0.1 else None)
        if step in (80, 170):
            jt.flush()
            pt.flush()
    return jt, pt, (jphys.now_micros() << 12) + 1


def _cpu_both(jt, pt, **kw):
    aggs = kw.pop("aggregates", ())
    group = kw.pop("group_by", None)
    jreq = JReq("t1", aggregates=to_jax_aggs(aggs),
                group_by=to_jax_group(group), **kw)
    preq = ReadRequest("t1", aggregates=tuple(aggs), group_by=group, **kw)
    return pt.read(preq), jt.read(jreq)


V, S, N = 1, 2, 3
_AGGS = (AggSpec("sum", ("col", V)), AggSpec("count"),
         AggSpec("count", ("col", S)), AggSpec("min", ("col", N)),
         AggSpec("max", ("col", S)), AggSpec("avg", ("col", V)),
         AggSpec("sum", ("arith", "mul", ("col", N), ("const", 2))))
_GROUPS = {
    "none": None,
    "dense": GroupSpec(cols=((N, 20, -9),)),
    "hash": HashGroupSpec(cols=(N, 4)),
    "dict": DictGroupSpec(cols=(S,)),
}
_WHERES = {
    "all": None,
    "v_pos": ("cmp", "gt", ("col", V), ("const", 0)),
    "skip": ("and", ("in", ("col", 0), [3, 9, 17, 40]),
             ("between", ("col", 4), ("const", -1), ("const", 2))),
    "range": ("and", ("cmp", "ge", ("col", 0), ("const", 10)),
              ("cmp", "lt", ("col", 0), ("const", 30.5))),
    "empty": ("in", ("col", 0), []),
    "leading_residual": ("and", ("cmp", "eq", ("col", 0), ("const", 5)),
                         ("isnull", ("col", S))),
}


@pytest.mark.parametrize("group", sorted(_GROUPS))
@pytest.mark.parametrize("where", sorted(_WHERES))
def test_interpreted_aggregates_match_reference(range_tablets, group, where):
    jt, pt, read_ht = range_tablets
    presp, jresp = _cpu_both(jt, pt, where=_WHERES[where],
                             aggregates=_AGGS, group_by=_GROUPS[group],
                             read_ht=read_ht)
    assert_same_cpu_response(presp, jresp, f"{where}/{group}")


@pytest.mark.parametrize("where", sorted(_WHERES))
def test_scan_segments_match_reference(range_tablets, where):
    jt, pt, _ = range_tablets
    w = _WHERES[where]
    jinfo, pinfo = kv_infos("rangepk")
    jk = jops.classify_scan_options(jinfo.schema, "range", w)
    pk = pops.classify_scan_options(pinfo.schema, "range", w)
    assert (pk[0], pk[3], pk[4]) == (jk[0], jk[3], jk[4])
    jreq, preq = JReq("t1", where=w), ReadRequest("t1", where=w)
    assert pt._read_op._scan_segments(preq) == \
        jt._read_op._scan_segments(jreq)


@pytest.mark.parametrize("where", ["all", "v_pos", "skip", "range"])
def test_paged_row_reads_match_reference(range_tablets, where):
    """Pages of 7 rows, each resumed from the previous page's paging
    state, to the end: the same rows and states page by page."""
    jt, pt, read_ht = range_tablets
    state, pages = None, 0
    seen = []
    while True:
        presp, jresp = _cpu_both(jt, pt, where=_WHERES[where], limit=7,
                                 paging_state=state, read_ht=read_ht,
                                 columns=("k", "r", "s"))
        assert_same_cpu_response(presp, jresp, f"{where} page {pages}")
        seen += presp.rows
        pages += 1
        if presp.paging_state is None:
            break
        state = presp.paging_state
    assert pages >= 2 and len(seen) == len(
        _cpu_both(jt, pt, where=_WHERES[where], read_ht=read_ht)[1].rows)


def test_interpreted_read_of_older_points_and_ttl(range_tablets):
    jt, pt, read_ht = range_tablets
    for back_us in (0, 300, 900, 1600):
        rh = read_ht - (back_us << 12)
        presp, jresp = _cpu_both(jt, pt, read_ht=rh)
        assert_same_cpu_response(presp, jresp, f"-{back_us}us")


# --- the interpreted join ------------------------------------------------------------
@pytest.fixture(scope="module")
def probe_tablets(tmp_path_factory):
    out = {}
    for str_fk in (False, True):
        data = probe_data(3000, n_keys=60, seed=5)
        if str_fk:
            data["fk"] = np.array([f"F{v:03d}" for v in data["fk"]], object)
        out[str_fk] = probe_pair(str(tmp_path_factory.mktemp(
            f"probe{int(str_fk)}")), data, block_rows=1024, str_fk=str_fk)
    return out


def _join_case(case):
    rng = np.random.default_rng(2)
    keys = np.arange(40, dtype=np.int64)
    prio = np.array([f"P{i % 4}" for i in range(40)], object)
    w = rng.integers(1, 9, 40).astype(np.int64)
    if case == "basic":
        return False, wire_pair(1, keys, {BID: (prio, None),
                                          BID + 1: (w, None)})
    if case == "null_payload":
        return False, wire_pair(1, keys, {BID: (prio, None),
                                          BID + 1: (w, np.arange(40) % 3 == 0)})
    if case == "duplicate_keys":
        return False, wire_pair(1, keys % 20, {BID: (prio, None),
                                               BID + 1: (w, None)})
    if case == "string_fk":
        skeys = np.array([f"F{v:03d}" for v in keys], object)
        return True, wire_pair(1, skeys, {BID: (prio, None),
                                          BID + 1: (w, None)})
    assert case == "chain"
    s1 = wire_pair(1, keys, {BID: (keys % 7, None), BID + 1: (w, None)})
    s2 = wire_pair(BID, np.arange(5, dtype=np.int64),
                   {BID + 2: (np.array(list("abcde"), object), None)})
    return False, (tuple([s1[0], s2[0]]), tuple([s1[1], s2[1]]))


@pytest.mark.parametrize("group", ["none", "dict", "hash", "dense"])
@pytest.mark.parametrize("case", ["basic", "null_payload", "duplicate_keys",
                                  "string_fk", "chain"])
def test_interpreted_join_matches_reference(probe_tablets, case, group):
    str_fk, joins = _join_case(case)
    jt, pt = probe_tablets[str_fk]
    gcol = BID + 2 if case == "chain" else BID
    groups = {"none": None, "dict": DictGroupSpec(cols=(gcol,)),
              "hash": HashGroupSpec(cols=(3,)),
              "dense": GroupSpec(cols=((3, 10, 0),))}
    aggs = (AggSpec("sum", ("col", 2)), AggSpec("count"),
            AggSpec("sum", ("col", BID + 1)), AggSpec("min", ("col", 2)),
            AggSpec("avg", ("col", BID + 1)))
    where = ("cmp", "lt", ("col", 3), ("const", 50))
    jreq, preq = join_requests("probe", where, aggs, groups[group], joins)
    fl = {"join_pushdown_enabled": False}
    with flags_set(fl, fl):
        presp, jresp = pt.read(preq), jt.read(jreq)
    assert_same_cpu_response(presp, jresp, f"{case}/{group}")
    assert int(np.sum(presp.group_counts)) > 0 if group != "none" \
        else presp.agg_values[1] > 0
