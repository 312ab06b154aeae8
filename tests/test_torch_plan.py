"""The port's fused plans (yugabyte_db_tpu_torch/ops/plan_fusion.py) and
their seams (docdb/operations.py join dispatch, bypass/scan.py
``bypass_plan_aggregate``) against the JAX reference on the same seeded
rows: the monolithic and streamed plan routes and the CPU twin bit for
bit, Tablet.read of join requests on both routes under f32 and f64, the
bypass route, dangling and NULL FKs, an empty build side, NULL payloads,
dictionary-coded string keys, float build keys, WHERE and aggregate
constants that must not collide, chunk-straddling probes and growth
inside a bucket that adds no cache entry.  Where the reference answers
on its interpreted join (``backend == "cpu"``) the port does too, with
the same answer.  Tolerance: none — every answer compares bit for bit
(the same dtype and bits)."""
import numpy as np
import pytest

from yugabyte_db_tpu.bypass import BypassIneligible as JBypassIneligible
from yugabyte_db_tpu.bypass import BypassSession as JSession
from yugabyte_db_tpu.ops import plan_fusion as jpf
from yugabyte_db_tpu.ops.device_batch import bucket_rows as jbucket
from yugabyte_db_tpu_torch.bypass import BypassIneligible, BypassSession
from yugabyte_db_tpu_torch.ops import join_scan as pjs
from yugabyte_db_tpu_torch.ops import plan_fusion as ppf
from yugabyte_db_tpu_torch.ops.expr import Expr
from yugabyte_db_tpu_torch.ops.grouped_scan import DictGroupSpec
from yugabyte_db_tpu_torch.ops.scan import AggSpec, HashGroupSpec
from tests.torch_parity import (BID, JOIN_READ_HT, assert_bitwise,
                                assert_same_answer, assert_same_cpu_response,
                                assert_same_response,
                                build_side, by_key, flags_set,
                                isolate_reference_plan_kernel,
                                join_requests, port_blocks_from,
                                probe_data, probe_pair, tablet_blocks,
                                to_jax_aggs, to_jax_group, wire_pair)

C = Expr.col
N = 24_000
WHERE = (C(3) < 50).node
AGGS = (AggSpec("sum", C(2).node), AggSpec("count"),
        AggSpec("sum", C(BID + 1).node))
MINMAX = AGGS + (AggSpec("min", C(2).node), AggSpec("max", C(BID + 1).node),
                 AggSpec("avg", C(BID + 1).node))
GROUP = DictGroupSpec(cols=(BID,))
COLS = [1, 2, 3]


@pytest.fixture(autouse=True)
def _own_reference_plan_kernel(monkeypatch):
    isolate_reference_plan_kernel(monkeypatch)


def _both(**flags):
    return flags_set(flags, flags)


@pytest.fixture(scope="module")
def frac_tablets(tmp_path_factory):
    """Fractional val: the fixed-point SUM lane quantizes."""
    data = probe_data(N, frac=True)
    return data, probe_pair(str(tmp_path_factory.mktemp("frac")), data)


@pytest.fixture(scope="module")
def int_tablets(tmp_path_factory):
    data = probe_data(N)
    return data, probe_pair(str(tmp_path_factory.mktemp("int")), data)


def _same_plan(pgot, jgot, pgout=None, jgout=None, what=""):
    po, pc = pgot
    jo, jc = jgot
    assert_same_answer(po, pc, jo, jc, what=what)
    if jgout is not None:
        assert pgout["spill"] == jgout["spill"]
        assert pgout["num_slots"] == jgout["num_slots"]
        assert pgout["dicts"].keys() == jgout["dicts"].keys()
        for k in jgout["dicts"]:
            assert list(pgout["dicts"][k]) == list(jgout["dicts"][k])


# --- the plan routes on blocks -----------------------------------------------
@pytest.mark.parametrize("read_ht", [None, JOIN_READ_HT])
@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("route", ["monolithic", "streaming"])
def test_plan_route_matches_reference(frac_tablets, route, mode, read_ht):
    _, (jt, pt) = frac_tablets
    jw, pw = build_side(null_payload=True)
    jg, pg = {}, {}
    kw = {"chunk_rows": 4096} if route == "streaming" else {}
    with _both(device_float_dtype=mode):
        jgot = getattr(jpf, f"{route}_plan_aggregate")(
            tablet_blocks(jt), COLS, WHERE, to_jax_aggs(MINMAX),
            to_jax_group(GROUP), read_ht, jw, kernel=jpf.FusedPlanKernel(),
            grouped_out=jg, **kw)
        pgot = getattr(ppf, f"{route}_plan_aggregate")(
            tablet_blocks(pt), COLS, WHERE, MINMAX, GROUP, read_ht, pw,
            kernel=ppf.FusedPlanKernel("cpu"), grouped_out=pg, **kw)
    assert jgot is not None and pgot is not None
    _same_plan(pgot, jgot, pg, jg, f"{route} {mode}")
    assert ppf.LAST_PLAN_STATS["path"] == route
    assert ppf.LAST_PLAN_STATS["chunks"] == (6 if route == "streaming"
                                             else 1)


@pytest.mark.parametrize("mode", ["float32", "float64"])
def test_fused_plan_cpu_matches_reference(frac_tablets, mode):
    _, (jt, pt) = frac_tablets
    jw, pw = build_side(null_payload=True)
    with _both(device_float_dtype=mode):
        jo, jc, js, jd = jpf.fused_plan_cpu(
            tablet_blocks(jt), COLS, WHERE, to_jax_aggs(MINMAX),
            to_jax_group(GROUP), jw, None, n_total=jbucket(N))
        po, pc, ps, pd = ppf.fused_plan_cpu(
            tablet_blocks(pt), COLS, WHERE, MINMAX, GROUP, pw, None,
            n_total=jbucket(N))
    assert ps == js == 0
    assert_same_answer(po, pc, jo, jc, what="twin")
    assert {k: list(v) for k, v in pd.items()} == \
        {k: list(v) for k, v in jd.items()}


def test_twin_equals_monolithic_route_bitwise(frac_tablets):
    # the twin's contract: bitwise equal to the monolithic route of a CPU
    # plan kernel at f64 when n_total is the batch bucket
    _, (_, pt) = frac_tablets
    _, pw = build_side(null_payload=True)
    aggs = AGGS + (AggSpec("min", C(2).node), AggSpec("max", C(BID + 1).node))
    with _both(device_float_dtype="float64"):
        gout = {}
        mo, mc = ppf.monolithic_plan_aggregate(
            tablet_blocks(pt), COLS, WHERE, aggs, GROUP, None, pw,
            kernel=ppf.FusedPlanKernel("cpu"), grouped_out=gout)
        to, tc, tspill, _ = ppf.fused_plan_cpu(
            tablet_blocks(pt), COLS, WHERE, aggs, GROUP, pw, None,
            n_total=jbucket(N))
    assert tspill == gout["spill"] == 0
    assert_bitwise(mc, tc, "counts")
    occ = np.asarray(tc) > 0
    for a, b in zip(mo, to):
        assert np.array_equal(np.asarray(a)[occ].astype(np.float64),
                              np.asarray(b)[occ].astype(np.float64))


def _null_blocks(n=8192 + 999):
    """Probe blocks whose FK lane (every 5th row) and val lane (every 9th
    row) hold NULLs, in both packages."""
    from yugabyte_db_tpu.docdb.table_codec import TableCodec as JCodec
    from yugabyte_db_tpu.utils.hybrid_time import HybridTime
    from tests.torch_parity import probe_infos
    data = probe_data(n, n_keys=30, seed=4)
    jinfo, _ = probe_infos()
    jb = JCodec(jinfo).bulk_blocks(data, HybridTime(1000), block_rows=4096)
    for b in jb:
        k = b.pk[0]
        v, _ = b.fixed[1]
        b.fixed[1] = (v, k % 5 == 0)
        v, _ = b.fixed[2]
        b.fixed[2] = (v, k % 9 == 0)
    return data, jb, port_blocks_from(jb)


@pytest.mark.parametrize("mode", ["float32", "float64"])
def test_null_fk_and_null_payload(mode):
    data, jb, pb = _null_blocks()
    jw, pw = build_side(n_build=20, null_payload=True)
    with _both(device_float_dtype=mode):
        jg, pg = {}, {}
        jgot = jpf.monolithic_plan_aggregate(
            jb, COLS, WHERE, to_jax_aggs(MINMAX), to_jax_group(GROUP), 1000,
            jw, kernel=jpf.FusedPlanKernel(), grouped_out=jg)
        pgot = ppf.monolithic_plan_aggregate(
            pb, COLS, WHERE, MINMAX, GROUP, 1000, pw,
            kernel=ppf.FusedPlanKernel("cpu"), grouped_out=pg)
        _same_plan(pgot, jgot, pg, jg, "nulls")
        jt = jpf.fused_plan_cpu(jb, COLS, WHERE, to_jax_aggs(MINMAX),
                                to_jax_group(GROUP), jw, 1000)
        pt = ppf.fused_plan_cpu(pb, COLS, WHERE, MINMAX, GROUP, pw, 1000)
        assert_same_answer(pt[0], pt[1], jt[0], jt[1], what="nulls twin")
    # NULL FKs never match: the joined rows are exactly the non-NULL FKs
    m = (data["ship"] < 50) & (data["fk"] < 20) & (data["k"] % 5 != 0)
    assert int(np.sum(pgot[1])) == int(m.sum())


# --- Tablet.read -------------------------------------------------------------
def _read(jt, pt, joins, where=WHERE, aggs=AGGS, group=GROUP,
          table_id="probe"):
    jreq, preq = join_requests(table_id, where, aggs, group, joins)
    return pt.read(preq), jt.read(jreq)


@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("streamed", [True, False])
def test_join_read_matches_reference(frac_tablets, streamed, mode):
    _, (jt, pt) = frac_tablets
    with _both(device_float_dtype=mode, streaming_chunk_rows=8192,
               streaming_scan_enabled=streamed):
        presp, jresp = _read(jt, pt, build_side(null_payload=True),
                             aggs=MINMAX)
        assert ppf.LAST_PLAN_STATS["path"] == \
            ("streaming" if streamed else "monolithic")
    assert_same_response(presp, jresp, f"streamed={streamed} {mode}")


def test_flat_join_aggregate_matches_reference(int_tablets):
    _, (jt, pt) = int_tablets
    with _both(device_float_dtype="float64"):
        presp, jresp = _read(jt, pt, build_side(), group=None,
                             aggs=MINMAX)
    assert_same_response(presp, jresp, "flat")


def test_dangling_fks_drop(int_tablets):
    data, (jt, pt) = int_tablets
    with _both(device_float_dtype="float64"):
        presp, jresp = _read(jt, pt, build_side(n_build=500))
    assert_same_response(presp, jresp)
    m = (data["ship"] < 50) & (data["fk"] < 500)
    assert int(np.sum(presp.group_counts)) == int(m.sum())


def test_empty_build_side(int_tablets):
    _, (jt, pt) = int_tablets
    joins = wire_pair(1, np.zeros(0, np.int64),
                      {BID: (np.zeros(0, object), None),
                       BID + 1: (np.zeros(0, np.int64), None)})
    presp, jresp = _read(jt, pt, joins)
    assert_same_response(presp, jresp)
    assert int(np.sum(presp.group_counts)) == 0


@pytest.mark.parametrize("streamed", [True, False])
def test_string_join_keys_dict_coded(tmp_path, streamed):
    rng = np.random.default_rng(5)
    n = 12_000
    fkv = rng.integers(0, 40, n)
    data = {"k": np.arange(n, dtype=np.int64),
            "fk": np.array([f"K{v:02d}" for v in fkv], object),
            "val": rng.integers(1, 50, n).astype(np.float64),
            "ship": rng.integers(0, 100, n).astype(np.int32)}
    jt, pt = probe_pair(str(tmp_path), data, str_fk=True)
    keys = np.array([f"K{v:02d}" for v in range(30)] + ["ZZ-never"], object)
    prio = np.array([f"P{i % 3}" for i in range(31)], object)
    with _both(streaming_chunk_rows=4096, streaming_scan_enabled=streamed):
        presp, jresp = _read(jt, pt, wire_pair(1, keys, {BID: (prio, None)}),
                             where=None,
                             aggs=(AggSpec("sum", C(2).node),
                                   AggSpec("count")))
    assert_same_response(presp, jresp)
    assert int(np.sum(presp.group_counts)) == int((fkv < 30).sum())


def test_duplicate_build_keys_are_refused_where_the_reference_interprets(
        int_tablets):
    _, (jt, pt) = int_tablets
    joins = wire_pair(1, np.zeros(3, np.int64),
                      {BID: (np.array(["A", "B", "A"], object), None)})
    f0 = pjs.JOIN_STATS["fallbacks"]
    jreq, preq = join_requests("probe", WHERE, AGGS, GROUP, joins)
    presp = pt.read(preq)
    assert pjs.JOIN_STATS["fallbacks"] == f0 + 1
    assert_same_cpu_response(presp, jt.read(jreq), "duplicate keys")
    # both build rows of key 0 match: groups A (twice) and B
    assert sorted(presp.group_values[0]) == ["A", "B"]


def test_float_build_keys_never_truncate(int_tablets):
    _, (jt, pt) = int_tablets
    frac = wire_pair(1, np.array([2.0, 3.5]),
                     {BID: (np.array(["X", "Y"], object), None)})
    jreq, preq = join_requests("probe", WHERE, AGGS, GROUP, frac)
    f0 = pjs.JOIN_STATS["fallbacks"]
    assert_same_cpu_response(pt.read(preq), jt.read(jreq), "float keys")
    assert pjs.JOIN_STATS["fallbacks"] == f0 + 1
    # integer-VALUED float keys are exact and served on the device
    whole = wire_pair(1, np.arange(500).astype(np.float64),
                      {BID: (np.array([f"P{i % 5}" for i in range(500)],
                                      object), None),
                       BID + 1: (np.ones(500, np.int64), None)})
    presp, jresp = _read(jt, pt, whole)
    assert_same_response(presp, jresp)


@pytest.mark.parametrize("case", ["flag_off", "hash_group", "small_scan",
                                  "not_device_expr"])
def test_interpreted_join_shapes_are_refused(int_tablets, case):
    _, (jt, pt) = int_tablets
    group, where, flags = GROUP, WHERE, {}
    if case == "flag_off":
        flags = {"join_pushdown_enabled": False}
    elif case == "hash_group":
        group = HashGroupSpec(cols=(3,))
    elif case == "small_scan":
        flags = {"tpu_min_rows_for_pushdown": 10 * N}
    else:
        where = ("like", ("col", 3), "x%")
    l0 = ppf.PLAN_STATS["launches"]
    jreq, preq = join_requests("probe", where, AGGS, group, build_side())
    with _both(**flags):
        jresp, presp = jt.read(jreq), pt.read(preq)
    assert_same_cpu_response(presp, jresp, case)
    assert ppf.PLAN_STATS["launches"] == l0


def test_chunk_straddling_probes_stream_exactly(tmp_path):
    data = probe_data(N)
    jt, pt = probe_pair(str(tmp_path), data, block_rows=2048)
    with _both(streaming_chunk_rows=2048):
        streamed, jstreamed = _read(jt, pt, build_side())
        assert ppf.LAST_PLAN_STATS["path"] == "streaming"
        assert ppf.LAST_PLAN_STATS["chunks"] >= 3
        with _both(streaming_scan_enabled=False):
            mono, jmono = _read(jt, pt, build_side())
            assert ppf.LAST_PLAN_STATS["path"] == "monolithic"
    assert_same_response(streamed, jstreamed, "streamed")
    assert_same_response(mono, jmono, "monolithic")
    # integer lanes: the two routes agree bit for bit
    assert by_key(streamed.agg_values, streamed.group_counts,
                  streamed.group_values) == \
        by_key(mono.agg_values, mono.group_counts, mono.group_values)


def test_where_and_agg_constants_do_not_collide(frac_tablets):
    _, (jt, pt) = frac_tablets
    where = ((C(3) < 50) & (C(2) > 3.5)).node
    aggs = (AggSpec("sum", (C(2) * Expr.const(2.0)).node),
            AggSpec("sum", (C(2) * (Expr.const(1.0) - C(BID + 1))).node),
            AggSpec("max", (C(BID + 1) + Expr.const(7)).node),
            AggSpec("count"))
    with _both(device_float_dtype="float64"):
        for streamed in (True, False):
            with _both(streaming_scan_enabled=streamed,
                       streaming_chunk_rows=8192):
                presp, jresp = _read(jt, pt, build_side(), where=where,
                                     aggs=aggs)
            assert_same_response(presp, jresp, f"streamed={streamed}")


# --- the bypass route --------------------------------------------------------
@pytest.mark.parametrize("chunk_rows", [4096, 1 << 20])
def test_bypass_route_equals_the_tablet_read(int_tablets, chunk_rows):
    _, (jt, pt) = int_tablets
    jw, pw = build_side()
    with _both(streaming_chunk_rows=chunk_rows):
        presp, jresp = _read(jt, pt, (jw, pw))
        pg, jg = {}, {}
        with BypassSession([pt], read_ht=JOIN_READ_HT, device="cpu") as s:
            po, pc, st = s.scan_aggregate(WHERE, AGGS, GROUP, grouped_out=pg,
                                          join=pw)
        with JSession([jt], read_ht=JOIN_READ_HT) as s:
            jo, jc, _ = s.scan_aggregate(WHERE, to_jax_aggs(AGGS),
                                         to_jax_group(GROUP),
                                         grouped_out=jg, join=jw)
    assert st["key_rebuilds"] == 0
    assert st["paths"] == (["streaming"] if chunk_rows == 4096
                           else ["monolithic"])
    assert_same_answer(po, pc, jo, jc, pg["group_values"],
                       jg["group_values"], "bypass vs reference")
    # the session's combine returns the group keys as a str array, the
    # read as an object array (both packages): compare keyed by group
    assert by_key(po, pc, pg["group_values"]) == by_key(
        presp.agg_values, presp.group_counts, presp.group_values)


def test_bypass_typed_reasons(int_tablets):
    _, (jt, pt) = int_tablets
    jw, pw = build_side()
    dup_j, dup_p = wire_pair(1, np.zeros(4, np.int64),
                             {BID: (np.array(["A"] * 4, object), None)})
    with BypassSession([pt], read_ht=JOIN_READ_HT, device="cpu") as ps, \
            JSession([jt], read_ht=JOIN_READ_HT) as js:
        for flags, (jwire, pwire), group, reason in (
                ({"join_pushdown_enabled": False}, (jw, pw), GROUP,
                 "join_pushdown_off"),
                ({}, (dup_j, dup_p), GROUP, "join_shape"),
                ({}, (jw, pw), HashGroupSpec(cols=(3,)), "hash_group"),
                ({"grouped_pushdown_enabled": False}, (jw, pw), GROUP,
                 "grouped_pushdown_off")):
            with _both(**flags):
                with pytest.raises(JBypassIneligible) as je:
                    js.scan_aggregate(WHERE, to_jax_aggs(AGGS),
                                      to_jax_group(group), join=jwire)
                with pytest.raises(BypassIneligible) as pe:
                    ps.scan_aggregate(WHERE, AGGS, group, join=pwire)
            assert pe.value.reason == je.value.reason == reason
            assert pe.value.detail == je.value.detail
        # the mesh combine serves no join, in either package
        with pytest.raises(ValueError, match="mesh combine does not serve"):
            js.scan_aggregate(WHERE, to_jax_aggs(AGGS), to_jax_group(GROUP),
                              combine="mesh", join=jw)
        with pytest.raises(ValueError, match="mesh combine does not serve"):
            ps.scan_aggregate(WHERE, AGGS, GROUP, combine="mesh", join=pw)


# --- the plan cache ----------------------------------------------------------
def test_growth_never_adds_a_cache_entry(tmp_path):
    kern = ppf.FusedPlanKernel("cpu")
    aggs = (AggSpec("sum", C(2).node), AggSpec("count"))
    small = probe_pair(str(tmp_path / "a"), probe_data(3 * 4096))[1]
    big = probe_pair(str(tmp_path / "b"), probe_data(9 * 4096))[1]
    wire_a = build_side(n_build=100)[1]
    wire_b = build_side(n_build=120)[1]        # the same 256-slot bucket
    got = ppf.streaming_plan_aggregate(
        tablet_blocks(small), COLS, WHERE, aggs, GROUP, None, wire_a,
        kernel=kern, chunk_rows=4096)
    assert got is not None and kern.compiles == 1
    for t, w in ((big, wire_a), (small, wire_b), (big, wire_b)):
        assert ppf.streaming_plan_aggregate(
            tablet_blocks(t), COLS, WHERE, aggs, GROUP, None, w,
            kernel=kern, chunk_rows=4096) is not None
    assert kern.compiles == 1, "a new entry at the same plan shape"
    assert len(kern.sig_compiles) == 1
    assert kern.launches == 3 + 9 + 3 + 9
    assert kern.cache_hits == kern.launches - 1


def test_plan_kernel_refuses_hash_groups_and_float_probe_lanes(
        frac_tablets):
    _, (_, pt) = frac_tablets
    from yugabyte_db_tpu_torch.ops.device_batch import build_batch
    batch = build_batch(tablet_blocks(pt), COLS, device="cpu")
    rt = pjs.make_join_runtime(build_side()[1], {}, device="cpu")
    kern = ppf.FusedPlanKernel("cpu")
    with pytest.raises(pjs.JoinIneligible, match="hash groups"):
        kern.run(batch, WHERE, AGGS, HashGroupSpec(cols=(3,)), None, rt)
    rt.probe_col = 2                       # val: a fractional f64 lane
    with pytest.raises(pjs.JoinIneligible) as e:
        kern.run(batch, WHERE, AGGS, GROUP, None, rt)
    assert e.value.reason == pjs.REASON_KEY_TYPE and e.value.stage == 0


# --- the repairs: shared scan pieces fed build-side payload lanes ------------
def test_static_scales_read_numpy_payload_lanes_like_reference():
    """A payload lane handed over as a numpy f32 array must cap the
    expression's intervals at the f32 range, as the reference's does
    (the port compared torch dtypes only, so a numpy f32 lane got the
    f64 cap and a static scale the reference refuses)."""
    import torch
    from yugabyte_db_tpu.ops.scan import _static_scales as jss
    from yugabyte_db_tpu_torch.ops.scan import _static_scales as pss
    aggs = (AggSpec("sum", (C(BID) * C(BID)).node),
            AggSpec("sum", (C(BID) * C(2)).node))
    bounds = {BID: (0.0, 1e20), 2: (0.0, 1.0)}
    for lane in (np.zeros(8, np.float32), np.zeros(8, np.float64)):
        cols = {BID: lane, 2: np.zeros(8)}
        jflags, jscales = jss(to_jax_aggs(aggs), bounds, 8192, cols)
        pflags, pscales = pss(aggs, bounds, 8192, cols,
                              torch.device("cpu"))
        tflags, _ = pss(aggs, bounds, 8192,
                        {k: torch.from_numpy(v) for k, v in cols.items()},
                        torch.device("cpu"))
        assert pflags == tflags == jflags
        assert [float(s) for s in pscales] == [float(s) for s in jscales]
    assert pflags == (True, True)          # the f64 lane
    assert jss(to_jax_aggs(aggs), bounds, 8192,
               {BID: np.zeros(8, np.float32)})[0] == (False, True)


def test_rewrite_keeps_payload_ids_like_reference():
    from yugabyte_db_tpu.docdb.operations import DocReadOperation as JOp
    from yugabyte_db_tpu_torch.docdb.operations import (
        Unrewritable, rewrite_where_and_aggs)
    dicts = {3: np.array(["a", "b"], object)}
    where = ("and", ("cmp", "eq", ("col", 3), ("const", "b")),
             ("cmp", "lt", ("col", BID + 1), ("const", 4)))
    aggs = (AggSpec("sum", C(BID + 1).node), AggSpec("min", C(BID).node),
            AggSpec("count"))
    jw, ja = JOp.rewrite_where_and_aggs(where, to_jax_aggs(aggs), dicts,
                                        allow_dict_minmax=False)
    pw, pa = rewrite_where_and_aggs(where, aggs, dicts,
                                    allow_dict_minmax=False)
    assert pw == jw and [(a.op, a.expr) for a in pa] == \
        [(a.op, a.expr) for a in ja]
    # a bare dictionary column under MIN is refused with the flag off
    with pytest.raises(JOp._Unrewritable):
        JOp.rewrite_where_and_aggs(None, to_jax_aggs(
            (AggSpec("min", C(3).node),)), dicts, allow_dict_minmax=False)
    with pytest.raises(Unrewritable):
        rewrite_where_and_aggs(None, (AggSpec("min", C(3).node),), dicts,
                               allow_dict_minmax=False)


@pytest.mark.parametrize("mode", ["auto", "float32", "float64"])
def test_payload_f64_policy_matches_reference_on_the_cpu(mode):
    import torch
    from yugabyte_db_tpu.ops.device_batch import f64_conversion as jconv
    from yugabyte_db_tpu_torch.ops.device_batch import f64_conversion
    frac = np.array([0.5, 1.25, 7.0])
    whole = np.array([1.0, -3.0, 2.0**30])
    with _both(device_float_dtype=mode):
        for v in (frac, whole):
            assert f64_conversion([v], torch.device("cpu")) == jconv([v])


def test_block_pair_helper_keeps_fk_nulls():
    # the NULL-FK blocks above go through port_blocks_from: the null
    # masks must cross unchanged
    _, jb, pb = _null_blocks(4096)
    for j, p in zip(jb, pb):
        assert_bitwise(p.fixed[1][1], j.fixed[1][1])
