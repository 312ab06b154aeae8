"""Whole queries through the port's fused plans: two- and three-stage join
chains through Tablet.read against the reference tablet's device answer
(dangling and NULL FKs dropping at their own stage, dict-coded string
payloads), the TPC-H chains (Q3, Q5, Q10) and the Q3-ish join against
their numpy answers and the reference, the per-stage typed refusals (the
device refuses the whole query, naming the stage, and both packages
answer it on their interpreted join), growth that never adds a plan
cache entry, and the 22-query registry against the reference's, name by
name.  The reference's own tests pass each request through
docdb/wire.py, which the port does not have yet (ROADMAP.md queue 1 item
9d); these call Tablet.read directly.  Tolerance: bit for bit against the
reference; counts exact and revenue within relative error 1e-6 against
numpy (numpy sums in another order)."""
import numpy as np
import pytest

from yugabyte_db_tpu.models import tpch as jtpch
from yugabyte_db_tpu.ops import join_scan as jjs
from yugabyte_db_tpu_torch.models import tpch
from yugabyte_db_tpu_torch.ops import join_scan as pjs
from yugabyte_db_tpu_torch.ops import plan_fusion as ppf
from yugabyte_db_tpu_torch.ops.expr import Expr
from yugabyte_db_tpu_torch.ops.grouped_scan import DictGroupSpec
from yugabyte_db_tpu_torch.ops.scan import AggSpec
from tests.torch_parity import (BID, assert_bitwise,
                                assert_same_cpu_response,
                                assert_same_response,
                                by_key, flags_set,
                                isolate_reference_plan_kernel,
                                join_requests, lineitem_data, probe_data,
                                probe_pair, stages, tablets_of, wire_pair)

C = Expr.col
CK, MNAME, WT, SEG, RG, RNAME = (BID + i for i in range(6))
WHERE = (C(3) < 50).node
AGGS = (AggSpec("sum", C(2).node), AggSpec("count"),
        AggSpec("sum", C(WT).node))


@pytest.fixture(autouse=True)
def _own_reference_plan_kernel(monkeypatch):
    isolate_reference_plan_kernel(monkeypatch)


def _both(**flags):
    return flags_set(flags, flags)


def _mid_tables(n_mid=400, n_cust=60, n_reg=7, seed=23):
    """The chain's build rows: mid (keyed 0..n_mid-1, ships the ck lane
    with NULLs and values dangling past n_cust), cust (ships segment
    strings and region codes), region."""
    rng = np.random.default_rng(seed)
    mid = {"mk": np.arange(n_mid, dtype=np.int64),
           "ck": rng.integers(0, int(n_cust * 1.1), n_mid).astype(np.int64),
           "ckn": np.arange(n_mid) % 13 == 0,
           "name": np.array([f"m{i % 7}" for i in range(n_mid)], object),
           "wt": rng.integers(1, 50, n_mid).astype(np.int64)}
    cust = {"ck": np.arange(n_cust, dtype=np.int64),
            "seg": np.array([f"S{i % 4}" for i in range(n_cust)], object),
            "rg": rng.integers(0, n_reg, n_cust).astype(np.int64)}
    reg = {"rk": np.arange(n_reg, dtype=np.int64),
           "name": np.array([f"R{i}" for i in range(n_reg)], object)}
    return mid, cust, reg


def _chain(mid, cust, reg=None):
    pairs = [wire_pair(1, mid["mk"], {CK: (mid["ck"], mid["ckn"]),
                                      MNAME: (mid["name"], None),
                                      WT: (mid["wt"], None)}),
             wire_pair(CK, cust["ck"], {SEG: (cust["seg"], None),
                                        RG: (cust["rg"], None)})]
    if reg is not None:
        pairs.append(wire_pair(RG, reg["rk"], {RNAME: (reg["name"], None)}))
    return stages(pairs)


def _np_chain_ref(data, mid, cust, reg, group):
    """Independent numpy fold of the chain (inner semantics: the WHERE,
    dangling and NULL FKs drop at their own stage)."""
    fk = data["fk"]
    m = (data["ship"] < 50) & (fk < len(mid["mk"]))
    fkc = np.clip(fk, 0, len(mid["mk"]) - 1)
    ck, ckn = mid["ck"][fkc], mid["ckn"][fkc]
    m &= ~ckn & (ck < len(cust["ck"]))
    ckc = np.clip(ck, 0, len(cust["ck"]) - 1)
    gvals = (cust["seg"][ckc] if group == "seg"
             else reg["name"][cust["rg"][ckc]])
    wt = mid["wt"][fkc]
    out = {}
    for g in sorted(set(gvals[m])):
        mg = m & (gvals == g)
        out[(str(g),)] = (int(mg.sum()), float(data["val"][mg].sum()),
                          float(mg.sum()), float(wt[mg].sum()))
    return out


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    rng = np.random.default_rng(11)
    n = 6000
    data = probe_data(n, n_keys=450, seed=11)
    data["fk"] = rng.integers(0, 450, n).astype(np.int64)
    return data, probe_pair(str(tmp_path_factory.mktemp("probe")), data,
                            block_rows=2048)


def _plain(key):
    """by_key's value bits as plain floats (counts stay ints)."""
    return {k: (v[0],) + tuple(float.fromhex(x[1]) if x[0] == "f" else
                               float(x[1]) for x in v[1:])
            for k, v in key.items()}


@pytest.mark.parametrize("streamed", [True, False])
@pytest.mark.parametrize("n_stages", [2, 3])
def test_chain_matches_reference_and_numpy(probe, n_stages, streamed):
    data, (jt, pt) = probe
    mid, cust, reg = _mid_tables()
    joins = _chain(mid, cust, reg if n_stages == 3 else None)
    group = DictGroupSpec(cols=(SEG if n_stages == 2 else RNAME,))
    with _both(tpu_min_rows_for_pushdown=0, streaming_chunk_rows=2048,
               streaming_scan_enabled=streamed, device_float_dtype="float64"):
        jreq, preq = join_requests("probe", WHERE, AGGS, group, joins)
        presp, jresp = pt.read(preq), jt.read(jreq)
        assert ppf.LAST_PLAN_STATS["join_stages"] == n_stages
        assert ppf.LAST_PLAN_STATS["path"] == \
            ("streaming" if streamed else "monolithic")
    assert_same_response(presp, jresp, f"{n_stages} stages")
    got = _plain(by_key(presp.agg_values, presp.group_counts,
                        presp.group_values))
    assert got == _np_chain_ref(data, mid, cust, reg,
                                "seg" if n_stages == 2 else "reg")


def _lineitem_join_tablets(root, n_rows=12_000, n_orders=3000, n_cust=300):
    data = lineitem_data(n_rows, seed=21)
    odata = tpch.generate_orders_cust(n_orders, n_cust)
    cdata = tpch.generate_customer(n_cust)
    ldata = tpch.lineitem_join_data(data, n_orders)
    (jt,), (pt,) = tablets_of(root, jtpch.lineitem_join_info(),
                              tpch.lineitem_join_info(), ldata,
                              block_rows=4096)
    return ldata, odata, cdata, jt, pt


@pytest.fixture(scope="module")
def lineitem_j(tmp_path_factory):
    return _lineitem_join_tablets(str(tmp_path_factory.mktemp("li")))


def _check_numpy(resp, ref):
    got = by_key(resp.agg_values, resp.group_counts, resp.group_values)
    for g, (cnt, rev) in ref.items():
        have = got.get((str(g),))
        if cnt == 0:
            assert have is None, g
            continue
        assert have[0] == cnt, g
        assert abs(float.fromhex(have[1][1]) - rev) <= \
            1e-6 * max(abs(rev), 1.0), g


@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("name", ["q3", "q5", "q10"])
def test_tpch_chain_matches_reference_and_numpy(lineitem_j, name, mode):
    ldata, odata, cdata, jt, pt = lineitem_j
    q = {"q3": tpch.tpch_q3_chain, "q5": tpch.tpch_q5_chain,
         "q10": tpch.tpch_q10_chain}[name]()
    jq = getattr(jtpch, f"tpch_{name}_chain")()
    joins = (jtpch.chain_build_wires(jq, odata, cdata),
             tpch.chain_build_wires(q, odata, cdata))
    with _both(tpu_min_rows_for_pushdown=0, device_float_dtype=mode,
               streaming_chunk_rows=4096):
        jreq, preq = join_requests("lineitem_j", q.probe_where, q.aggs,
                                   tpch._chain_group(q.group_col), joins)
        presp, jresp = pt.read(preq), jt.read(jreq)
        assert ppf.LAST_PLAN_STATS["join_stages"] == 2
    assert_same_response(presp, jresp, name)
    ref = tpch.numpy_reference_chain(q, ldata, odata, cdata)
    assert ref == jtpch.numpy_reference_chain(jq, ldata, odata, cdata)
    _check_numpy(presp, ref)


def test_q3ish_join_matches_reference_and_numpy(lineitem_j):
    ldata, odata, _, jt, pt = lineitem_j
    q, jq = tpch.tpch_q3ish(), jtpch.tpch_q3ish()
    joins = (jtpch.orders_build_wire(jq, odata),
             tpch.orders_build_wire(q, odata))
    with _both(tpu_min_rows_for_pushdown=0, device_float_dtype="float64"):
        jreq, preq = join_requests("lineitem_j", q.probe_where, q.aggs,
                                   q.group, joins)
        presp, jresp = pt.read(preq), jt.read(jreq)
    assert_same_response(presp, jresp, "q3ish")
    ref = tpch.numpy_reference_join(q, ldata, odata)
    assert ref == jtpch.numpy_reference_join(jq, ldata, odata)
    _check_numpy(presp, ref)


def test_join_tables_and_wires_match_reference():
    for a, b in ((tpch.generate_orders_cust(500, 50),
                  jtpch.generate_orders_cust(500, 50)),
                 (tpch.generate_customer(50), jtpch.generate_customer(50)),
                 (tpch.lineitem_join_data(lineitem_data(900), 200),
                  jtpch.lineitem_join_data(lineitem_data(900), 200))):
        assert a.keys() == b.keys()
        for k in a:
            if a[k].dtype == object:
                assert list(a[k]) == list(b[k]), k
            else:
                assert_bitwise(a[k], b[k], k)
    odata = tpch.generate_orders_cust(500, 50)
    cdata = tpch.generate_customer(50)
    for name in ("q3", "q5", "q10"):
        pw = tpch.chain_build_wires(getattr(tpch, f"tpch_{name}_chain")(),
                                    odata, cdata)
        jw = jtpch.chain_build_wires(
            getattr(jtpch, f"tpch_{name}_chain")(), odata, cdata)
        for p, j in zip(pw, jw):
            assert p.probe_col == j.probe_col
            assert_bitwise(p.keys, j.keys)
            assert p.signature() == j.signature()
    for info in ("orders_info", "orders_cust_info", "customer_info",
                 "lineitem_join_info"):
        p, j = getattr(tpch, info)(), getattr(jtpch, info)()
        assert p.table_id == j.table_id
        assert [(c.id, c.name, c.type, c.is_hash_key, c.is_range_key)
                for c in p.schema.columns] == \
            [(c.id, c.name, c.type, c.is_hash_key, c.is_range_key)
             for c in j.schema.columns]
    assert (tpch.ORDERS_PER_SF, tpch.CUSTOMERS_PER_SF) == \
        (jtpch.ORDERS_PER_SF, jtpch.CUSTOMERS_PER_SF)
    assert tpch.chain_bids() == jtpch.chain_bids()


def _spec_view(spec):
    """A comparable view of a registry spec (scan, join or chain)."""
    if spec is None:
        return None
    out = {}
    for k, v in vars(spec).items():
        if k == "aggs":
            v = [(a.op, a.expr) for a in v]
        elif k == "group" and v is not None:
            v = (type(v).__name__, v.cols)
        out[k] = v
    return out


def test_registry_matches_reference_name_by_name():
    got, want = tpch.tpch_queries(), jtpch.tpch_queries()
    assert list(got) == list(want) == [f"q{i}" for i in range(1, 23)]
    for name in want:
        p, j = got[name], want[name]
        assert (p.name, p.kind, p.note, p.reason) == \
            (j.name, j.kind, j.note, j.reason), name
        assert _spec_view(p.spec) == _spec_view(j.spec), name
    runnable = {n for n, e in got.items() if e.kind != "inexpressible"}
    assert runnable == {"q1", "q3", "q5", "q6", "q10"}


# --- per-stage typed refusals: the WHOLE query is refused --------------------
def test_duplicate_key_names_its_stage():
    mid, cust, _ = _mid_tables()
    cust["ck"] = cust["ck"].copy()
    cust["ck"][5] = cust["ck"][4]
    jw, pw = _chain(mid, cust)
    with pytest.raises(jjs.JoinIneligible) as je:
        jjs.make_join_runtimes(jw, {})
    with pytest.raises(pjs.JoinIneligible) as pe:
        pjs.make_join_runtimes(pw, {}, device="cpu")
    assert pe.value.reason == je.value.reason == pjs.REASON_DUPLICATE_KEY
    assert pe.value.stage == je.value.stage == 1


def test_stage1_refusal_refuses_the_whole_query(probe):
    _, (jt, pt) = probe
    mid, cust, _ = _mid_tables()
    cust["ck"] = cust["ck"].copy()
    cust["ck"][5] = cust["ck"][4]
    joins = _chain(mid, cust)
    f0 = pjs.JOIN_STATS["fallbacks"]
    with pytest.raises(pjs.JoinIneligible) as e:
        pjs.make_join_runtimes(joins[1], {}, device="cpu")
    assert e.value.stage == 1
    with _both(tpu_min_rows_for_pushdown=0):
        jreq, preq = join_requests("probe", WHERE, AGGS,
                                   DictGroupSpec(cols=(SEG,)), joins)
        presp = pt.read(preq)
        assert pjs.JOIN_STATS["fallbacks"] == f0 + 1
        assert_same_cpu_response(presp, jt.read(jreq), "stage 1 refused")


def test_stage_budget_typed_then_whole_query_intact(probe):
    _, (jt, pt) = probe
    mid, cust, _ = _mid_tables()
    joins = _chain(mid, cust)
    with pytest.raises(pjs.JoinIneligible) as e:
        pjs.make_join_runtimes(joins[1], {}, max_stages=1, device="cpu")
    assert e.value.reason == pjs.REASON_STAGE_COUNT and e.value.stage == 1
    group = DictGroupSpec(cols=(SEG,))
    with _both(tpu_min_rows_for_pushdown=0):
        with _both(multi_join_max_stages=1):
            jreq, preq = join_requests("probe", WHERE, AGGS, group, joins)
            assert_same_cpu_response(pt.read(preq), jt.read(jreq),
                                     "stage budget")
        jreq, preq = join_requests("probe", WHERE, AGGS, group, joins)
        presp, jresp = pt.read(preq), jt.read(jreq)
    assert_same_response(presp, jresp)


# --- one plan entry across launches and growth -------------------------------
def test_chain_one_entry_across_launches_and_growth(tmp_path):
    # every chunk of the streamed scan shares one pow2 bucket, so the
    # 3-table chain keeps ONE plan signature across 20 launches, 2x probe
    # growth and build growth inside the buckets
    _, ta = probe_pair(str(tmp_path / "a"), probe_data(8192, 450),
                       block_rows=2048)
    _, tb = probe_pair(str(tmp_path / "b"), probe_data(16384, 450),
                       block_rows=2048)
    mid, cust, reg = _mid_tables()
    _, wires = _chain(mid, cust, reg)
    group = DictGroupSpec(cols=(RNAME,))
    # a WHERE shape no other test of the module plans, so the shared
    # kernel's first entry for it is made here
    where = ((C(3) >= 7) & (C(3) < 60)).node
    kern = ppf.default_plan_kernel("cpu")
    with _both(tpu_min_rows_for_pushdown=0, streaming_chunk_rows=2048):
        c0, l0 = kern.compiles, kern.launches
        for _ in range(20):
            _, preq = join_requests("probe", where, AGGS, group,
                                    (None, wires))
            assert ta.read(preq).backend == "tpu"
        assert kern.compiles - c0 == 1, "launches must share one entry"
        _, preq = join_requests("probe", where, AGGS, group, (None, wires))
        assert tb.read(preq).backend == "tpu"
        assert kern.compiles - c0 == 1, "2x growth added an entry"
        mid2, _, _ = _mid_tables(n_mid=500)
        _, grown = _chain(mid2, cust, reg)
        _, preq = join_requests("probe", where, AGGS, group, (None, grown))
        assert ta.read(preq).backend == "tpu"
        assert kern.compiles - c0 == 1, "in-bucket build growth added one"
    assert kern.launches - l0 >= 20
    assert all(v == 1 for v in kern.sig_compiles.values())
