"""The port's tablet read seam (yugabyte_db_tpu_torch/tablet/tablet.py,
docdb/operations.py DocReadOperation, models/tpch.LineitemTable)
against the JAX reference on the same seeded rows: Tablet.read answers
bit for bit on the streamed and the monolithic route, under f32 and
f64, on one, two-SST and eight tablets; where the reference answers on
its interpreted CPU path the port does too, with the same answer; a
dictionary GROUP BY past its slot budget takes the same partial-spill
merge; and both restart reads alike under mock clocks."""
import numpy as np
import pytest

from yugabyte_db_tpu.models import tpch as jtpch
from yugabyte_db_tpu.ops import stream_scan as jss
from yugabyte_db_tpu_torch.device import DeviceUnavailable
from yugabyte_db_tpu_torch.docdb import operations as pops
from yugabyte_db_tpu_torch.models import tpch
from yugabyte_db_tpu_torch.ops import stream_scan as pss
from yugabyte_db_tpu_torch.ops.expr import Expr
from yugabyte_db_tpu_torch.ops.grouped_scan import DictGroupSpec
from yugabyte_db_tpu_torch.ops.scan import AggSpec, HashGroupSpec
from tests.torch_parity import (TABLET_BASE_US, assert_same_answer,
                                assert_same_cpu_response,
                                assert_same_response, flags_set,
                                lineitem_data, requests, tablet_pair)

C = Expr.col
Q, P, D, S, R, L = (tpch.QTY, tpch.EXTPRICE, tpch.DISCOUNT, tpch.SHIPDATE,
                    tpch.RETFLAG, tpch.LINESTATUS)
CHUNK = 32768          # streaming_chunk_rows: 4 blocks of 8192 rows
ROWS = 120_000         # SF 0.02
READ_HT = (TABLET_BASE_US + 1000) << 12     # above every load


def _flags(mode, streamed=True, **extra):
    both = {"device_float_dtype": mode, "streaming_chunk_rows": CHUNK,
            "streaming_scan_enabled": streamed}
    both.update(extra)
    return flags_set(both, both)


# the read shapes: (table kind, where, aggregates, group)
SHAPES = {
    "q6": ("hash", tpch.TPCH_Q6.where, tpch.TPCH_Q6.aggs, None),
    "q1": ("hash", tpch.TPCH_Q1.where, tpch.TPCH_Q1.aggs,
           tpch.TPCH_Q1.group),
    "q1_str": ("str", tpch.TPCH_Q1.where, tpch.TPCH_Q1.aggs,
               tpch.tpch_q1_str().group),
    "hash_by_shipdate": ("hash", tpch.TPCH_Q1.where,
                         (AggSpec("sum", C(Q).node), AggSpec("count")),
                         HashGroupSpec(cols=(S,), max_groups=4096)),
    "minmax_empty": ("hash", (C(S) < 0).node,
                     (AggSpec("min", C(P).node), AggSpec("max", C(Q).node),
                      AggSpec("count")), None),
    "minmax_avg": ("hash", (C(S) < 9000).node,
                   (AggSpec("min", C(P).node), AggSpec("max", C(S).node),
                    AggSpec("avg", C(D).node)), None),
}


@pytest.fixture(scope="module")
def data():
    return lineitem_data(ROWS, seed=11)


@pytest.fixture(scope="module")
def tablets(tmp_path_factory, data):
    """One tablet per layout, plus the eight-tablet hash table, built
    once for the module."""
    root = tmp_path_factory.mktemp("tablets")
    out = {kind: tablet_pair(str(root / kind), kind, data)
           for kind in ("hash", "str")}
    out["hash8"] = tablet_pair(str(root / "hash8"), "hash", data,
                               n_tablets=8)
    return out


def _read_both(jt, pt, where, aggs, group, read_ht=READ_HT):
    jreq, preq = requests("lineitem", where, aggs, group, read_ht)
    return pt.read(preq), jt.read(jreq)


@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("route", ["streamed", "monolithic"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tablet_read_matches_reference(tablets, shape, route, mode):
    kind, where, aggs, group = SHAPES[shape]
    (jt,), (pt,) = tablets[kind]
    with _flags(mode, streamed=route == "streamed"):
        jss.LAST_STREAM_STATS.clear()
        pss.LAST_STREAM_STATS.clear()
        presp, jresp = _read_both(jt, pt, where, aggs, group)
    assert_same_response(presp, jresp, f"{shape} {route} {mode}")
    # the same route served both: chunked exactly where the reference
    # chunked (hash groups never stream)
    assert pss.LAST_STREAM_STATS.get("chunks") == \
        jss.LAST_STREAM_STATS.get("chunks")
    streams = route == "streamed" and not isinstance(group, HashGroupSpec)
    assert bool(pss.LAST_STREAM_STATS) == streams


def test_tablet_answers_match_numpy(tablets, data):
    (_,), (pt,) = tablets["hash"]
    with _flags("float64"):
        q6 = pt.read(requests("lineitem", tpch.TPCH_Q6.where,
                              tpch.TPCH_Q6.aggs, None, READ_HT)[1])
        q1 = pt.read(requests("lineitem", tpch.TPCH_Q1.where,
                              tpch.TPCH_Q1.aggs, tpch.TPCH_Q1.group,
                              READ_HT)[1])
    ref6 = tpch.numpy_reference(tpch.TPCH_Q6, data)
    assert abs(float(q6.agg_values[0]) - ref6) <= 1e-9 * abs(ref6)
    for g, (qsum, psum, cnt) in tpch.numpy_reference(tpch.TPCH_Q1,
                                                     data).items():
        assert int(q1.group_counts[g]) == cnt
        assert float(q1.agg_values[0][g]) == qsum


@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("query", ["q6", "q1"])
def test_lineitem_table_eight_tablets(tablets, query, mode):
    jts, pts = tablets["hash8"]
    jtab = jtpch.LineitemTable.__new__(jtpch.LineitemTable)
    jtab.tablets = jts
    ptab = tpch.LineitemTable.__new__(tpch.LineitemTable)
    ptab.tablets, ptab.info = pts, tpch.lineitem_info()
    jq = {"q6": jtpch.TPCH_Q6, "q1": jtpch.TPCH_Q1}[query]
    pq = {"q6": tpch.TPCH_Q6, "q1": tpch.TPCH_Q1}[query]
    assert sum(t.num_sst_files() for t in pts) == 8
    with _flags(mode):
        pvals, pcounts = ptab.run(pq, read_ht=READ_HT)
        jvals, jcounts = jtab.run(jq, read_ht=READ_HT)
    assert_same_answer(pvals, pcounts, jvals, jcounts, what=query)


def test_lineitem_table_builds_and_loads(tmp_path):
    d = lineitem_data(20_000, seed=3)
    pt = tpch.LineitemTable(str(tmp_path / "p"), num_tablets=4,
                            device="cpu")
    jt = jtpch.LineitemTable(str(tmp_path / "j"), num_tablets=4)
    assert pt.load(d, block_rows=4096) == jt.load(d, block_rows=4096) \
        == 20_000
    assert [(t.partition.start, t.partition.end) for t in pt.tablets] == \
        [(t.partition.start, t.partition.end) for t in jt.tablets]
    with _flags("float64"):
        pv, pc = pt.run(tpch.TPCH_Q6, read_ht=1 << 62)
        jv, jc = jt.run(jtpch.TPCH_Q6, read_ht=1 << 62)
    assert_same_answer(pv, pc, jv, jc)


@pytest.mark.parametrize("query", ["q6", "q1"])
def test_two_sst_tablet_reads_in_dedup_mode(tmp_path, data, query):
    """A second load rewrites every 3rd row at a later hybrid time: two
    SSTs, so the blocks lose unique_keys, the streamed route refuses
    and the monolithic batch runs in dedup mode, at read points before,
    between and after the loads."""
    upd = {k: v.copy() for k, v in data.items()}
    upd["l_quantity"] = upd["l_quantity"] + 1.0
    upd["l_shipdate"] = upd["l_shipdate"] - 100
    sel = np.zeros(ROWS, bool)
    sel[::3] = True
    jt, pt = tablet_pair(str(tmp_path), "hash", data, loads=())
    from yugabyte_db_tpu.utils import hybrid_time as jht
    from yugabyte_db_tpu_torch.utils import hybrid_time as pht
    for off, rows in ((0, data), (500, {k: v[sel] for k, v in upd.items()})):
        jt[0].bulk_load(rows, ht=jht.HybridTime.from_micros(
            TABLET_BASE_US + off), block_rows=8192)
        pt[0].bulk_load(rows, ht=pht.HybridTime.from_micros(
            TABLET_BASE_US + off), block_rows=8192)
    assert pt[0].num_sst_files() == 2
    q = {"q6": tpch.TPCH_Q6, "q1": tpch.TPCH_Q1}[query]
    for read_us in (250, 1000):
        with _flags("float64"):
            pss.LAST_STREAM_STATS.clear()
            presp, jresp = _read_both(jt[0], pt[0], q.where, q.aggs,
                                      q.group,
                                      (TABLET_BASE_US + read_us) << 12)
        assert not pss.LAST_STREAM_STATS         # not chunk-safe
        assert_same_response(presp, jresp, f"{query} at +{read_us}")
    blocks = pt[0]._read_op._collect_blocks()
    assert not any(b.unique_keys for b in blocks)


# --- the interpreted path and the remaining refusals ------------------------------
def _refusal_case(case):
    """(where, aggs, group, request overrides, flags) of a read the
    reference serves on its CPU path."""
    q6 = tpch.TPCH_Q6
    return {
        "pushdown_off": (q6.where, q6.aggs, None, {},
                         {"tpu_pushdown_enabled": False}),
        "min_rows": (q6.where, q6.aggs, None, {},
                     {"tpu_min_rows_for_pushdown": 10 ** 9}),
        # monolithic: the streamed route of both packages rewrites
        # strings only when a dictionary column is present
        "like_shape": (("like", ("col", Q), "1%"), (AggSpec("count"),),
                       None, {}, {"streaming_scan_enabled": False}),
        "hash_overflow": (q6.where, (AggSpec("count"),),
                          HashGroupSpec(cols=(S,), max_groups=16), {}, {}),
        "row_read": (None, (), None, {}, {}),
        "point_read": (None, (), None, {"pk_eq": {"rowid": 5}}, {}),
        "not_device_expr": (("in", ("col", Q), [1.0, None]),
                            (AggSpec("count"),), None, {}, {}),
    }[case]


@pytest.mark.parametrize("case", ["pushdown_off", "min_rows", "like_shape",
                                  "hash_overflow", "row_read", "point_read",
                                  "not_device_expr"])
def test_refuses_where_the_reference_serves_on_the_cpu(tablets, case):
    (jt,), (pt,) = tablets["hash"]
    where, aggs, group, over, fl = _refusal_case(case)
    jreq, preq = requests("lineitem", where, aggs, group, READ_HT)
    for k, v in over.items():
        setattr(jreq, k, v)
        setattr(preq, k, v)
    with _flags("float64", **fl):
        jresp = jt.read(jreq)
        presp = pt.read(preq)
    assert_same_cpu_response(presp, jresp, case)
    assert presp.rows or presp.agg_values is not None


def test_filter_reads_are_refused(tablets):
    """Row reads with a WHERE that the reference answers on its CPU path
    (an enumerable WHERE on the hash key: its MultiGet) are answered
    alike; those it serves on its device filter route the port serves
    too (tests/test_torch_rows.py)."""
    (jt,), (pt,) = tablets["hash"]
    jreq, preq = requests("lineitem", ("in", ("col", 0), [3, 5, 8]), (),
                          None, READ_HT)
    with _flags("float64"):
        jresp, presp = jt.read(jreq), pt.read(preq)
    assert_same_cpu_response(presp, jresp, "enumerated")
    assert [r["rowid"] for r in presp.rows] == [3, 5, 8]
    jreq, preq = requests("lineitem", tpch.TPCH_Q6.where, (), None,
                          READ_HT)
    with _flags("float64"):
        jresp, presp = jt.read(jreq), pt.read(preq)
    assert jresp.backend == presp.backend == "tpu"
    assert presp.rows == jresp.rows and presp.rows


@pytest.mark.parametrize("route", ["streamed", "monolithic"])
def test_dict_group_spill_is_refused(tablets, route):
    """A dictionary GROUP BY past its slot budget (6 groups, 4 slots):
    the partial-spill merge answers as the reference's, bit for bit on
    the same route; with ``grouped_spill_merge_enabled`` off both fall
    to the interpreted GROUP BY with the same answer.  (Before the spill
    tail was ported the port refused this read; the name stays.)"""
    from yugabyte_db_tpu.ops.grouped_scan import GROUPED_STATS as JSTATS
    from yugabyte_db_tpu_torch.ops.grouped_scan import GROUPED_STATS
    (jt,), (pt,) = tablets["str"]
    group = DictGroupSpec(cols=(R, L), max_slots=4)
    jreq, preq = requests("lineitem_s", tpch.TPCH_Q1.where,
                          tpch.TPCH_Q1.aggs, group, READ_HT)
    merges = GROUPED_STATS["spill_merges"], JSTATS["spill_merges"]
    with _flags("float64", streamed=route == "streamed"):
        presp, jresp = pt.read(preq), jt.read(jreq)
    assert presp.backend == jresp.backend == "tpu"
    assert_same_response(presp, jresp, f"spill merge {route}")
    assert len(presp.group_counts) == 6
    assert (GROUPED_STATS["spill_merges"], JSTATS["spill_merges"]) == \
        (merges[0] + 1, merges[1] + 1)
    jreq, preq = requests("lineitem_s", tpch.TPCH_Q1.where,
                          tpch.TPCH_Q1.aggs, group, READ_HT)
    with _flags("float64", streamed=route == "streamed",
                grouped_spill_merge_enabled=False):
        presp, jresp = pt.read(preq), jt.read(jreq)
    assert presp.backend == jresp.backend == "cpu"
    assert_same_cpu_response(presp, jresp, f"spill merge off {route}")


# --- restarts --------------------------------------------------------------------
@pytest.mark.parametrize("route", ["streamed", "monolithic"])
def test_restart_points_match_reference(tmp_path, data, route):
    """Rows loaded 100 ms ahead of the clock lie in the uncertainty
    window of a server-assigned read: both packages restart at their
    hybrid time and see them; an explicit read point never restarts."""
    jt, pt = tablet_pair(str(tmp_path), "hash", data,
                         loads=((100_000, None),))
    q = tpch.TPCH_Q6
    with _flags("float64", streamed=route == "streamed"):
        jreq, preq = requests("lineitem", q.where, q.aggs, None, None)
        presp, jresp = pt[0].read(preq), jt[0].read(jreq)
        assert preq.read_ht == jreq.read_ht == \
            (TABLET_BASE_US + 100_000) << 12
        assert preq.server_assigned_read_ht and jreq.server_assigned_read_ht
        assert_same_response(presp, jresp, "restarted")
        assert int(presp.group_counts) > 0
        # an explicit read point below the load: no restart, no rows
        presp, jresp = _read_both(jt[0], pt[0], q.where, q.aggs, None,
                                  TABLET_BASE_US << 12)
        assert_same_response(presp, jresp, "explicit")
        assert int(presp.group_counts) == 0


def test_device_defaults_to_cuda(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yugabyte_db_tpu_torch.tablet import Tablet
    with pytest.raises(DeviceUnavailable):
        Tablet("t", tpch.lineitem_info(), str(tmp_path))
    with pytest.raises(DeviceUnavailable):
        tpch.LineitemTable(str(tmp_path / "x"), num_tablets=2)
    with pytest.raises(DeviceUnavailable):
        pops.shared_kernel()


def test_compact_backends(tmp_path, data):
    """Tablet.compact: the host baseline with the offload flag off, then
    the native backend of a CPU tablet with it on; each output equals
    the reference's and reads alike."""
    jt, pt = tablet_pair(str(tmp_path), "hash", data,
                         loads=((0, None), (500, None)))
    with _flags("float64"):          # a cached batch of the two SSTs
        _read_both(jt[0], pt[0], tpch.TPCH_Q1.where, tpch.TPCH_Q1.aggs,
                   tpch.TPCH_Q1.group)
    with flags_set({"tpu_compaction_enabled": False},
                   {"tpu_compaction_enabled": False}):
        jpath, ppath = jt[0].compact(), pt[0].compact()
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    assert pt[0].num_sst_files() == 1
    assert pt[0].approximate_size() == jt[0].approximate_size()
    from yugabyte_db_tpu_torch.docdb import compaction as pcomp
    jpath, ppath = jt[0].compact(), pt[0].compact()
    assert pcomp.LAST_COMPACTION_STATS["backend"] == "native"
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    with _flags("float64"):
        presp, jresp = _read_both(jt[0], pt[0], tpch.TPCH_Q1.where,
                                  tpch.TPCH_Q1.aggs, tpch.TPCH_Q1.group)
    assert_same_response(presp, jresp, "after compaction")


def test_chunk_safe_monolithic_read_keeps_visible_mode(tablets):
    """One SST of several blocks proven to be one sorted run of unique
    keys: the monolithic route reads in visible mode (no dedup sort),
    so the hand route serves it (K3's plain version on the CPU) and the
    exact answer equals the reference's dedup-mode answer."""
    (jt,), (pt,) = tablets["hash"]
    q = tpch.TPCH_Q1
    kern = pt._read_op.kernel
    refusals = dict(kern.hand_scan_refusals)
    with _flags("float32", streamed=False):
        presp, jresp = _read_both(jt, pt, q.where, q.aggs, q.group)
        assert_same_response(presp, jresp, "exact, visible mode")
        sigs = [key for key in kern._cache if key[0] != "hand"]
        assert any(sig[3] == "visible" for sig in sigs)
        with flags_set({}, {"hand_scan_enabled": True}):
            hand = pt.read(requests("lineitem", q.where, q.aggs, q.group,
                                    READ_HT)[1])
    assert kern.hand_scan_refusals == refusals
    assert np.array_equal(hand.group_counts, presp.group_counts)
    np.testing.assert_allclose(hand.agg_values[1], presp.agg_values[1],
                               rtol=2e-4)
