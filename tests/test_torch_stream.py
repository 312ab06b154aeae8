"""The port's chunked streaming scan (yugabyte_db_tpu_torch/ops/
stream_scan.py), its stage pipeline (storage/pipeline.py), its
per-chunk combine and the device block cache against the
JAX reference on the same blocks: streamed results bit for bit under f32
and f64, equal chunk counts, and None in exactly the reference's cases."""
import time

import numpy as np
import pytest

from yugabyte_db_tpu.docdb.table_codec import TableCodec as JCodec
from yugabyte_db_tpu.models import tpch as jtpch
from yugabyte_db_tpu.ops import stream_scan as jss
from yugabyte_db_tpu.ops.scan import ScanKernel as JKernel
from yugabyte_db_tpu.utils.hybrid_time import HybridTime as JHT
from yugabyte_db_tpu_torch.models import tpch
from yugabyte_db_tpu_torch.ops import stream_scan as pss
from yugabyte_db_tpu_torch.ops.device_batch import (DeviceBlockCache,
                                                    _batch_bytes,
                                                    build_batch)
from yugabyte_db_tpu_torch.ops.expr import Expr
from yugabyte_db_tpu_torch.ops.grouped_scan import (LAST_GROUPED_STATS,
                                                    DictGroupSpec)
from yugabyte_db_tpu_torch.ops.scan import (AggSpec, HashGroupSpec,
                                            ScanKernel)
from yugabyte_db_tpu_torch.storage.pipeline import StreamPipeline
from yugabyte_db_tpu_torch.utils import flags
from tests.torch_parity import (assert_bitwise, assert_partials, block_pair,
                                flags_set, float_dtype, jax_blocks,
                                lineitem_data, port_blocks_from,
                                to_jax_aggs, to_jax_group)

C = Expr.col
Q, P, D, S, R, L = (tpch.QTY, tpch.EXTPRICE, tpch.DISCOUNT, tpch.SHIPDATE,
                    tpch.RETFLAG, tpch.LINESTATUS)
CHUNK = 8192


# --- the stage pipeline --------------------------------------------------------
def test_pipeline_order_and_results():
    p = StreamPipeline([lambda x: x + 1, lambda x: x * 2])
    assert list(p.run(range(32))) == [(i + 1) * 2 for i in range(32)]
    assert p.items == 32 and p.stats()["items"] == 32


def test_pipeline_error_propagates_and_tears_down():
    def boom(x):
        if x == 5:
            raise ValueError("x5")
        return x
    with pytest.raises(ValueError, match="x5"):
        list(StreamPipeline([boom, lambda x: x]).run(range(64)))


def test_pipeline_early_close_does_not_deadlock():
    g = StreamPipeline([lambda x: x, lambda x: x], depth=2).run(
        range(10_000))
    assert next(g) == 0
    g.close()


def test_pipeline_stages_overlap():
    # two 30 ms stages over 6 items: serial ~0.36 s, overlapped ~0.21 s
    def slow(x):
        time.sleep(0.03)
        return x
    t0 = time.perf_counter()
    assert list(StreamPipeline([slow, slow]).run(range(6))) == \
        list(range(6))
    assert time.perf_counter() - t0 < 0.31


def test_pipeline_empty_and_feeder_error():
    assert list(StreamPipeline([lambda x: x]).run([])) == []

    def bad_iter():
        yield 1
        raise RuntimeError("feeder died")
    with pytest.raises(RuntimeError, match="feeder died"):
        list(StreamPipeline([lambda x: x]).run(bad_iter()))
    with pytest.raises(ValueError):
        StreamPipeline([])


# --- streamed scans against the reference's ----------------------------------
@pytest.fixture(scope="module")
def li():
    data = lineitem_data(40000, seed=6)
    jb = jax_blocks(data, block_rows=4096)
    return data, jb, port_blocks_from(jb)


@pytest.fixture(scope="module")
def li_str():
    data = tpch.lineitem_str_data(lineitem_data(30000, seed=7))
    jb = JCodec(jtpch.lineitem_str_info()).bulk_blocks(
        data, JHT(1000), block_rows=4096)
    return data, jb, port_blocks_from(jb)


def _stream_both(jb, pb, columns, where, aggs, group=None, read_ht=None,
                 chunk_rows=CHUNK, mode="float64", **kw):
    with float_dtype(mode):
        jss.LAST_STREAM_STATS.clear()
        pss.LAST_STREAM_STATS.clear()
        jg = jss.streaming_scan_aggregate(
            jb, columns, where, to_jax_aggs(aggs), to_jax_group(group),
            read_ht, kernel=JKernel(), chunk_rows=chunk_rows, **kw)
        pg = pss.streaming_scan_aggregate(
            pb, columns, where, aggs, group, read_ht,
            kernel=ScanKernel(device="cpu"), chunk_rows=chunk_rows, **kw)
    return jg, pg


def _assert_same_stream(jg, pg, what=""):
    assert (jg is None) == (pg is None), what
    if jg is None:
        return
    (jo, jc), (po, pc) = jg, pg
    assert len(jo) == len(po)
    for i, (a, b) in enumerate(zip(po, jo)):
        assert_bitwise(a, b, f"{what} agg {i}")
    assert_bitwise(pc, jc, f"{what} counts")
    assert pss.LAST_STREAM_STATS["chunks"] == jss.LAST_STREAM_STATS["chunks"]
    assert pss.LAST_STREAM_STATS["bucket_rows"] == \
        jss.LAST_STREAM_STATS["bucket_rows"]


STREAM_QUERIES = {
    "q6": (tpch.TPCH_Q6.where, tpch.TPCH_Q6.aggs, None),
    "q1": (tpch.TPCH_Q1.where, tpch.TPCH_Q1.aggs, tpch.TPCH_Q1.group),
    "minmax": ((C(S) >= 9000).node,
               (AggSpec("min", C(P).node), AggSpec("max", C(Q).node),
                AggSpec("avg", C(D).node), AggSpec("count", C(Q).node)),
               None),
    "empty_match": ((C(S) < -10).node,
                    (AggSpec("min", C(P).node), AggSpec("count")), None),
}


@pytest.mark.parametrize("read_ht", [None, 1000, 999])
@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("query", sorted(STREAM_QUERIES))
def test_streamed_results_bitwise(li, query, mode, read_ht):
    _, jb, pb = li
    where, aggs, group = STREAM_QUERIES[query]
    jg, pg = _stream_both(jb, pb, tpch.TPCH_Q1.columns, where, aggs, group,
                          read_ht, mode=mode)
    assert pg is not None
    assert pss.LAST_STREAM_STATS["chunks"] == 5
    _assert_same_stream(jg, pg, f"{query}/{mode}/{read_ht}")


@pytest.mark.parametrize("chunk_rows", [4096, 12000, 20000])
def test_chunk_plans_and_counts_match(li, chunk_rows):
    _, jb, pb = li
    q = tpch.TPCH_Q1
    jg, pg = _stream_both(jb, pb, q.columns, q.where, q.aggs, q.group,
                          chunk_rows=chunk_rows)
    _assert_same_stream(jg, pg, str(chunk_rows))
    assert [len(c) for c in pss.plan_chunks(pb, chunk_rows)] == \
        [len(c) for c in jss.plan_chunks(jb, chunk_rows)]


def test_streamed_answer_equals_monolithic_and_numpy(li):
    data, _, pb = li
    q = tpch.TPCH_Q1
    k = ScanKernel(device="cpu")
    souts, scnt = pss.streaming_scan_aggregate(
        pb, q.columns, q.where, q.aggs, q.group, kernel=k,
        chunk_rows=CHUNK)
    mono = k.run(build_batch(pb, q.columns, device="cpu"), q.where, q.aggs,
                 q.group)
    assert np.array_equal(scnt, np.asarray(mono[1]))
    assert np.array_equal(souts[0], np.asarray(mono[0][0]))    # int qty
    ref = tpch.numpy_reference(q, data)
    for g in range(6):
        assert int(scnt[g]) == ref[g][2] and souts[0][g] == ref[g][0]
        np.testing.assert_allclose(souts[1][g], ref[g][1], rtol=1e-12)


def test_streamed_hand_route_matches_reference(li):
    # K3's plain version per chunk on the CPU against the reference's
    # Pallas kernel per chunk: counts exact, sums within the hand
    # route's rtol 2e-4
    _, jb, pb = li
    q = tpch.TPCH_Q1
    k = ScanKernel(device="cpu")
    with float_dtype("float32"), \
            flags_set({"tpu_pallas_scan": True}, {"hand_scan_enabled": True}):
        jo, jc = jss.streaming_scan_aggregate(
            jb, q.columns, q.where, q.aggs, q.group, kernel=JKernel(),
            chunk_rows=CHUNK)
        po, pc = pss.streaming_scan_aggregate(
            pb, q.columns, q.where, q.aggs, q.group, kernel=k,
            chunk_rows=CHUNK)
    assert k.hand_scan_refusals == {}
    assert [key[0] for key in k._cache] == ["hand"]
    assert_bitwise(pc, jc)
    for a, b, spec in zip(po, jo, q.aggs):
        assert_partials(a, b, spec.op)


@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("where", [None, C(R).isin(["A", "N"]).node,
                                   ("like", ("col", L), "O")])
def test_streamed_dict_group_bitwise(li_str, where, mode):
    _, jb, pb = li_str
    q = tpch.tpch_q1_str()
    if where is not None:
        where = ("and", q.where, where)
    pout = {}
    jg, pg = _stream_both(jb, pb, q.columns, where or q.where, q.aggs,
                          q.group, mode=mode, grouped_out=pout,
                          dict_out={})
    _assert_same_stream(jg, pg, str(where))
    assert pout["spill"] == 0 and pout["num_slots"] == 8
    assert LAST_GROUPED_STATS["path"] == "streaming"
    assert LAST_GROUPED_STATS["slots_occupied"] == \
        int(np.count_nonzero(pg[1][:7]))


def test_streamed_dict_group_spill_is_reported(li_str):
    _, jb, pb = li_str
    q = tpch.tpch_q1_str()
    group = DictGroupSpec(cols=(R, L), max_slots=4)
    jout, pout = {}, {}
    with float_dtype("float64"):
        jg = jss.streaming_scan_aggregate(
            jb, q.columns, q.where, to_jax_aggs(q.aggs),
            to_jax_group(group), kernel=JKernel(), chunk_rows=CHUNK,
            grouped_out=jout)
        pg = pss.streaming_scan_aggregate(
            pb, q.columns, q.where, q.aggs, group,
            kernel=ScanKernel(device="cpu"), chunk_rows=CHUNK,
            grouped_out=pout)
    _assert_same_stream(jg, pg)
    assert pout["spill"] == jout["spill"] > 0


def test_streamed_string_predicate_without_group(li_str):
    _, jb, pb = li_str
    where = (C(R).eq("R") & (C(S) > 9000)).node
    aggs = (AggSpec("sum", C(Q).node), AggSpec("count"),
            AggSpec("max", C(L).node))
    dout = {}
    jg, pg = _stream_both(jb, pb, [Q, S, R, L], where, aggs, dict_out=dout)
    _assert_same_stream(jg, pg)
    assert list(dout["dicts"][L]) == ["F", "O"]


def _none_cases(li, li_str):
    _, jb, pb = li
    _, sjb, spb = li_str
    q1, q6 = tpch.TPCH_Q1, tpch.TPCH_Q6
    return {
        "hash_group": (jb, pb, q1.columns, q1.where, q1.aggs,
                       HashGroupSpec(cols=(R,)), None, {}),
        "one_chunk": (jb, pb, q6.columns, q6.where, q6.aggs, None, None,
                      {"chunk_rows": 1 << 20}),
        "two_chunks": (jb, pb, q6.columns, q6.where, q6.aggs, None, None,
                       {"chunk_rows": 30000}),
        "no_column": (jb, pb, [99], None, (AggSpec("count"),), None, None,
                      {}),
        "unrewritable": (sjb, spb, [R, L], ("cmp", "eq", ("col", R),
                                            ("col", L)),
                         (AggSpec("count"),), None, None, {}),
        "bare_string_sum": (sjb, spb, [R], None,
                            (AggSpec("sum", C(R).node),), None, None, {}),
        "dict_group_off": (sjb, spb, [Q, R, L], None, (AggSpec("count"),),
                           DictGroupSpec(cols=(R, L)), None,
                           {"flag_off": True}),
    }


@pytest.mark.parametrize("case", ["hash_group", "one_chunk", "two_chunks",
                                  "no_column", "unrewritable",
                                  "bare_string_sum", "dict_group_off"])
def test_declines_exactly_where_the_reference_does(li, li_str, case):
    jb, pb, cols, where, aggs, group, read_ht, kw = \
        _none_cases(li, li_str)[case]
    off = kw.pop("flag_off", False)
    fl = {"grouped_pushdown_enabled": False} if off else {}
    with flags_set(fl, fl):
        jg, pg = _stream_both(jb, pb, cols, where, aggs, group, read_ht,
                              **kw)
    assert jg is None and pg is None


def test_read_point_needs_chunk_safe_blocks(li):
    _, jb, pb = li
    q = tpch.TPCH_Q6
    jb2 = list(jb)
    pb2 = list(pb)
    saved = jb2[2].unique_keys, pb2[2].unique_keys
    jb2[2].unique_keys = pb2[2].unique_keys = False
    try:
        for read_ht, served in ((None, True), (1000, False)):
            jg, pg = _stream_both(jb2, pb2, q.columns, q.where, q.aggs,
                                  read_ht=read_ht)
            assert (pg is not None) == served == (jg is not None)
    finally:
        jb2[2].unique_keys, pb2[2].unique_keys = saved


def _chunk_safety_cases(li):
    data, jb, pb = li
    # a second load of the same keys: boundary keys restart
    twice = (list(jb) + list(jax_blocks(data, ht=2000, block_rows=4096)))
    nokeys = [block_pair(dict(
        key_hash=b.key_hash, ht=b.ht, write_id=b.write_id,
        tombstone=b.tombstone, fixed=dict(b.fixed), pk=dict(b.pk),
        unique_keys=True)) for b in jb[:3]]
    return {"sorted_run": list(jb), "overlapping_runs": twice,
            "no_key_matrix": [j for j, _ in nokeys],
            "empty_block": [block_pair(dict(
                key_hash=np.zeros(0, np.uint64), ht=np.zeros(0, np.uint64),
                write_id=np.zeros(0, np.uint32),
                tombstone=np.zeros(0, bool), unique_keys=True))[0]]}


@pytest.mark.parametrize("case", ["sorted_run", "overlapping_runs",
                                  "no_key_matrix", "empty_block"])
def test_chunk_safe_mvcc_matches_reference(li, case):
    jblocks = _chunk_safety_cases(li)[case]
    pblocks = port_blocks_from(jblocks)
    want = jss.chunk_safe_mvcc(jblocks)
    assert pss.chunk_safe_mvcc(pblocks) == want
    assert want == (case == "sorted_run")


def test_prefilter_is_not_ported(li):
    # the prefilter is ported now (the name is kept): a prefilter that
    # drops rows no predicate can match: the batch pads
    # to the unfiltered bucket with the unfiltered scales, so the answer
    # keeps its bits; the stats count the rows in and kept
    from yugabyte_db_tpu_torch.bypass.prefilter import make_prefilter
    _, _, pb = li
    q = tpch.TPCH_Q6
    cols = sorted(q.columns)
    k = ScanKernel(device="cpu")
    with float_dtype("float64"):
        plain = pss.streaming_scan_aggregate(pb, cols, q.where, q.aggs,
                                             kernel=k, chunk_rows=CHUNK)
        got = pss.streaming_scan_aggregate(
            pb, cols, q.where, q.aggs, kernel=k, chunk_rows=CHUNK,
            prefilter=make_prefilter(q.where, cols))
    for a, b in zip(got[0], plain[0]):
        assert_bitwise(a, b)
    assert_bitwise(got[1], plain[1])
    st = pss.LAST_STREAM_STATS
    assert st["prefilter_rows_in"] == sum(b.n for b in pb)
    assert 0 < st["prefilter_rows_kept"] < st["prefilter_rows_in"]


def test_group_domain_guard_matches_reference():
    dicts = {1: np.array(["a"] * 3, object),
             2: np.array(["b"] * 70000, object)}
    from yugabyte_db_tpu.ops.grouped_scan import DictGroupSpec as JDict
    for cols in ((1,), (1, 2), (2, 2), (3,)):
        assert pss.group_domain_ok(DictGroupSpec(cols=cols), dicts) == \
            jss.group_domain_ok(JDict(cols=cols), dicts)
    assert pss.group_domain_ok(None, {})


# --- the streamed row path -------------------------------------------------------
def _materialize(chunk, sel):
    rowid = np.concatenate([b.pk[tpch.ROWID] for b in chunk])
    return [int(r) for r in rowid[sel]]


@pytest.mark.parametrize("limit", [None, 5, 2500])
@pytest.mark.parametrize("read_ht", [None, 1000])
def test_streaming_filter_matches_reference(li, read_ht, limit):
    _, jb, pb = li
    where = (C(D).between(0.02, 0.04) & (C(Q) < 20.0)).node
    jrows = jss.streaming_scan_filter(jb, [Q, D], where, read_ht,
                                      _materialize, limit=limit,
                                      kernel=JKernel(), chunk_rows=CHUNK)
    jchunks = jss.LAST_STREAM_STATS["chunks_run"]
    prows = pss.streaming_scan_filter(pb, [Q, D], where, read_ht,
                                      _materialize, limit=limit,
                                      kernel=ScanKernel(device="cpu"),
                                      chunk_rows=CHUNK)
    assert prows == jrows
    assert pss.LAST_STREAM_STATS["chunks_run"] == jchunks
    assert pss.LAST_STREAM_STATS["rows_out"] == len(prows)


def test_streaming_filter_declines_like_the_reference(li):
    _, jb, pb = li
    for kw in ({"chunk_rows": 1 << 20}, {"columns": [99]}):
        cols = kw.pop("columns", [Q])
        assert jss.streaming_scan_filter(
            jb, cols, None, None, _materialize, kernel=JKernel(),
            chunk_rows=kw.get("chunk_rows", CHUNK)) is None
        assert pss.streaming_scan_filter(
            pb, cols, None, None, _materialize,
            kernel=ScanKernel(device="cpu"),
            chunk_rows=kw.get("chunk_rows", CHUNK)) is None


# --- the device block cache ------------------------------------------------------
def test_device_cache_serves_a_warm_rescan(li):
    _, _, pb = li
    q = tpch.TPCH_Q6
    cache = DeviceBlockCache()
    k = ScanKernel(device="cpu")
    runs = [pss.streaming_scan_aggregate(
        pb, q.columns, q.where, q.aggs, kernel=k, chunk_rows=CHUNK,
        cache=cache, cache_key=("li",)) for _ in range(2)]
    assert cache.misses == 5 and cache.hits == 5
    assert_bitwise(runs[0][0][0], runs[1][0][0])
    cache.invalidate_prefix(("li",))
    assert cache._bytes == 0 and not cache._map


def test_device_cache_evicts_by_batch_bytes(li):
    _, _, pb = li
    batches = [build_batch(pb[i:i + 1], [Q, D], device="cpu")
               for i in range(3)]
    size = _batch_bytes(batches[0])
    # 4096 rows: valid, 2 columns (int32 + f64), 2 null lanes, key_hash,
    # ht, write_id (int64) and tombstone
    assert size == 4096 * (1 + 4 + 8 + 1 + 1 + 8 * 3 + 1)
    cache = DeviceBlockCache(capacity_bytes=2 * size)
    for i, b in enumerate(batches):
        assert cache.get_or_build(("b", i), lambda b=b: b) is b
    assert list(cache._map) == [("b", 1), ("b", 2)]
    assert cache.get_or_build(("b", 2), lambda: None) is batches[2]
    cache.clear()
    assert cache._bytes == 0


# --- the per-chunk combine ----------------------------------------------------
@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("nan_rows", ["first_chunk", "last_chunk"])
def test_streamed_minmax_propagates_nan_like_the_reference(li, nan_rows,
                                                          mode):
    # a chunk whose MIN/MAX is NaN makes the combined MIN/MAX NaN, in
    # whichever chunk it sits (np.minimum/np.maximum, not a Python min
    # whose answer depends on the argument order), in the partial's dtype
    data = dict(li[0])
    price = data["l_extendedprice"].copy()
    price[[100, 101] if nan_rows == "first_chunk" else [-5]] = np.nan
    data["l_extendedprice"] = price
    jb = jax_blocks(data, block_rows=4096)
    aggs = (AggSpec("min", C(P).node), AggSpec("max", C(P).node),
            AggSpec("count", C(P).node), AggSpec("sum", C(Q).node))
    jg, pg = _stream_both(jb, port_blocks_from(jb), [Q, P, S], None, aggs,
                          mode=mode)
    _assert_same_stream(jg, pg, f"{nan_rows}/{mode}")
    assert np.isnan(pg[0][0]) and np.isnan(pg[0][1])


def test_flag_defaults_match_reference():
    from yugabyte_db_tpu.utils import flags as jflags
    for name in ("streaming_chunk_rows", "grouped_pushdown_enabled"):
        assert flags.get(name) == jflags.get(name), name
    flags.set_flag("streaming_chunk_rows", 7)
    flags.REGISTRY.reset("streaming_chunk_rows")
    assert flags.get("streaming_chunk_rows") == 1 << 20
