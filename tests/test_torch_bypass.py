"""The port's analytics bypass reader (yugabyte_db_tpu_torch/bypass/),
its SST leases (storage/lsm.py), the host prefilter pass
(storage/native_lib.prefilter_ranges, csrc/host_native.cpp) and the
cross-shard combine (ops/scan.py) against the JAX reference: sessions
answer bit for bit like the reference's and like the port's own tablet
reads, with the prefilter on and off and no key rebuilds; the typed
refusal reasons, intervals and combines are the reference's; a
compaction under an open session keeps the pinned files until close."""
import os

import numpy as np
import pytest

from yugabyte_db_tpu import bypass as jbp
from yugabyte_db_tpu.bypass import prefilter as jpf
from yugabyte_db_tpu.ops import scan as jscan
from yugabyte_db_tpu.storage import native_lib as jnl
from yugabyte_db_tpu_torch import bypass as pbp
from yugabyte_db_tpu_torch.bypass import prefilter as ppf
from yugabyte_db_tpu_torch.device import DeviceUnavailable
from yugabyte_db_tpu_torch.errors import NotPortedError
from yugabyte_db_tpu_torch.models import tpch
from yugabyte_db_tpu_torch.ops import join_scan as pjs
from yugabyte_db_tpu_torch.ops import scan as pscan
from yugabyte_db_tpu_torch.ops.expr import Expr
from yugabyte_db_tpu_torch.ops.scan import AggSpec, HashGroupSpec
from yugabyte_db_tpu_torch.storage import native_lib as pnl
from tests.torch_parity import (TABLET_BASE_US, assert_same_answer,
                                assert_same_value, flags_set, lineitem_data,
                                requests, tablet_pair, to_jax_aggs,
                                to_jax_group)

C = Expr.col
ROWS = 120_000
CHUNK = 32768
READ_HT = (TABLET_BASE_US + 1000) << 12

QUERIES = {"q6": ("hash", tpch.TPCH_Q6), "q1": ("hash", tpch.TPCH_Q1),
           "q1_str": ("str", tpch.tpch_q1_str())}


def _flags(mode="float64", **extra):
    both = {"device_float_dtype": mode, "streaming_chunk_rows": CHUNK}
    both.update(extra)
    return flags_set(both, both)


# --- the cross-shard combine ----------------------------------------------------
def _rand_parts(rng, aggs, n_shards, groups):
    parts, counts = [], []
    for _ in range(n_shards):
        vals = []
        for a in aggs:
            shape = () if groups is None else (groups,)
            if a.op == "count":
                vals.append(rng.integers(0, 100, shape).astype(np.int64))
            elif a.op == "sum":
                vals.append(rng.normal(size=shape))
            elif rng.integers(3) == 0:
                # a NULL min/max: a whole-shard None or None groups
                if groups is None:
                    vals.append(np.asarray(None, object))
                else:
                    v = rng.normal(size=shape).astype(object)
                    v[rng.random(groups) < 0.5] = None
                    vals.append(v)
            else:
                vals.append(rng.normal(size=shape))
        parts.append(tuple(vals))
        counts.append(None if groups is None and rng.integers(4) == 0
                      else rng.integers(0, 50, () if groups is None
                                        else (groups,)).astype(np.int64))
    return parts, counts


@pytest.mark.parametrize("groups", [None, 5])
@pytest.mark.parametrize("seed", range(4))
def test_combine_agg_partials_matches_reference(seed, groups):
    rng = np.random.default_rng(seed)
    aggs = (AggSpec("sum", ("col", 1)), AggSpec("count"),
            AggSpec("min", ("col", 2)), AggSpec("max", ("col", 3)))
    parts, counts = _rand_parts(rng, aggs, 4, groups)
    if any(c is None for c in counts):
        counts = [None] * len(counts)
    pv, pc = pscan.combine_agg_partials(aggs, parts, counts)
    jv, jc = jscan.combine_agg_partials(to_jax_aggs(aggs), parts, counts)
    assert_same_answer(pv, pc, jv, jc)
    for a, b in ((np.asarray(1.0), np.asarray(None, object)),
                 (np.asarray(None, object), np.asarray(2))):
        assert pscan.agg_is_none(b) == jscan.agg_is_none(b)
        assert_same_value(pscan.merge_minmax(a, b, "min"),
                          jscan.merge_minmax(a, b, "min"))


@pytest.mark.parametrize("seed", range(4))
def test_combine_grouped_partials_matches_reference(seed):
    rng = np.random.default_rng(seed)
    aggs = (AggSpec("sum", ("col", 1)), AggSpec("count"),
            AggSpec("min", ("col", 2)), AggSpec("max", ("col", 3)))
    keys_a = np.array(["A", "N", "R", "X"], object)
    parts = []
    for _ in range(3):
        g = int(rng.integers(1, 6))
        gv = (keys_a[rng.integers(0, 4, g)], rng.integers(0, 3, g))
        vals = []
        for a in aggs:
            if a.op == "count":
                vals.append(rng.integers(0, 9, g).astype(np.int64))
            elif a.op == "sum":
                vals.append(rng.normal(size=g))
            else:
                v = rng.normal(size=g).astype(object)
                v[rng.random(g) < 0.3] = None
                vals.append(v)
        parts.append((tuple(vals), rng.integers(0, 4, g).astype(np.int64),
                      gv))
    parts.append(((), None, None))          # a shard with no groups
    pv, pc, pg = pscan.combine_grouped_partials(aggs, parts)
    jv, jc, jg = jscan.combine_grouped_partials(to_jax_aggs(aggs), parts)
    assert_same_answer(pv, pc, jv, jc, pg, jg)
    for part in parts[:3]:
        assert pscan._keyed_partials(part) == jscan._keyed_partials(part)


# --- the prefilter's intervals and its native range pass ------------------------
_BIG = (1 << 53) + 1
WHERES = [
    None,
    tpch.TPCH_Q6.where,
    ("and", ("cmp", "gt", ("col", 0), ("const", _BIG)),
     ("cmp", "le", ("const", 4.5), ("col", 1))),
    ("and", ("cmp", "lt", ("col", 0), ("const", float("inf"))),
     ("cmp", "ge", ("col", 1), ("const", float("nan")))),
    ("and", ("cmp", "gt", ("col", 0), ("const", 5.0)),
     ("between", ("col", 0), ("const", 1), ("const", 9)),
     ("cmp", "eq", ("col", 2), ("const", -3)),
     ("cmp", "ne", ("col", 3), ("const", 1))),
    ("or", ("cmp", "lt", ("col", 0), ("const", 1)),
     ("cmp", "gt", ("col", 0), ("const", 5))),
    ("and", ("cmp", "ge", ("col", 0), ("const", float("-inf"))),
     ("cmp", "lt", ("col", 1), ("const", True))),
]


@pytest.mark.parametrize("i", range(len(WHERES)))
def test_extract_intervals_and_clamp_match_reference(i):
    got = ppf.extract_intervals(WHERES[i])
    want = jpf.extract_intervals(WHERES[i])
    assert got == want
    for iv in got.values():
        for dt in ("int32", "int64", "uint32", "float32", "float64",
                   "bool"):
            a = ppf._clamp_to_lane(iv, np.dtype(dt))
            b = jpf._clamp_to_lane(iv, np.dtype(dt))
            assert a == b, (iv, dt)
            if a is not None:
                assert [type(x) for x in a] == [type(x) for x in b]


def _rand_preds(rng, n):
    preds = []
    for dt in ("int32", "int64", "float32", "float64", "uint32"):
        vals = (rng.normal(size=n) * 50).astype(dt) if dt[0] == "f" \
            else rng.integers(0 if dt[0] == "u" else -100, 100, n).astype(dt)
        if dt[0] == "f":
            vals[rng.random(n) < 0.02] = np.nan
            vals[rng.random(n) < 0.02] = np.inf
        nulls = rng.random(n) < 0.1 if rng.integers(2) else None
        iv = (float(rng.normal() * 40), bool(rng.integers(2)),
              float("inf") if rng.integers(4) == 0
              else float(rng.normal() * 40 + 60), False)
        if dt[0] != "f" and rng.integers(2):
            iv = (int(rng.integers(-60, 0)), False, int(rng.integers(0, 60)),
                  True)
        rng_ = ppf._clamp_to_lane(iv, vals.dtype)
        preds.append((vals, nulls, rng_[0], rng_[1]))
    return preds


@pytest.mark.parametrize("seed", range(4))
def test_prefilter_ranges_matches_plain_and_reference(seed):
    rng = np.random.default_rng(seed)
    n = 5000
    preds = _rand_preds(rng, n)
    got = pnl.prefilter_mask(preds, n)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, pnl.prefilter_ranges_plain(preds, n))
    np.testing.assert_array_equal(got, jnl.prefilter_mask(preds, n))
    # one lane at a time, and strided and unaligned lanes (views over a
    # file mapping need not be aligned)
    for p in preds:
        np.testing.assert_array_equal(pnl.prefilter_mask([p], n),
                                      pnl.prefilter_ranges_plain([p], n))
    raw = np.zeros(8 * n + 1, np.uint8)
    lane = raw[1:].view(np.int64)
    lane[:] = rng.integers(-9, 9, n)
    wide = np.arange(2 * n, dtype=np.int32)[::2]
    for p in ((lane, None, -3, 4), (wide, None, 10, 500)):
        np.testing.assert_array_equal(pnl.prefilter_mask([p], n),
                                      pnl.prefilter_ranges_plain([p], n))
    with pytest.raises(ValueError):
        pnl.prefilter_mask([(np.zeros(n, np.int16), None, 0, 1)], n)


# --- sessions over real tablets ---------------------------------------------------
@pytest.fixture(scope="module")
def data():
    return lineitem_data(ROWS, seed=23)


@pytest.fixture(scope="module")
def shards(tmp_path_factory, data):
    root = tmp_path_factory.mktemp("bypass")
    return {(kind, n): tablet_pair(str(root / f"{kind}{n}"), kind, data,
                                   n_tablets=n)
            for kind, n in (("hash", 1), ("hash", 8), ("str", 1))}


def _rpc_answer(tablets, q, table_id, read_ht):
    """The port's tablet reads at read_ht, combined in tablet order."""
    resps = [t.read(requests(table_id, q.where, q.aggs, q.group,
                             read_ht)[1]) for t in tablets]
    if len(resps) == 1:
        r = resps[0]
        return r.agg_values, r.group_counts, r.group_values
    vals, counts = pscan.combine_agg_partials(
        tuple(pscan._expand_avg(q.aggs)), [r.agg_values for r in resps],
        [r.group_counts for r in resps])
    return vals, counts, None


@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("prefilter", [True, False])
@pytest.mark.parametrize("query,n_tablets", [
    ("q6", 1), ("q6", 8), ("q1", 1), ("q1", 8), ("q1_str", 1)])
def test_session_matches_reference_and_tablet_reads(shards, query,
                                                    n_tablets, prefilter,
                                                    mode):
    kind, q = QUERIES[query]
    jts, pts = shards[(kind, n_tablets)]
    table_id = "lineitem_s" if kind == "str" else "lineitem"
    with _flags(mode):
        with pbp.BypassSession(pts, read_ht=READ_HT, prefilter=prefilter,
                               device="cpu") as ps, \
                jbp.BypassSession(jts, read_ht=READ_HT,
                                  prefilter=prefilter) as js:
            pgo, jgo = {}, {}
            pv, pc, pst = ps.scan_aggregate(q.where, q.aggs, q.group,
                                            grouped_out=pgo)
            jv, jc, jst = js.scan_aggregate(q.where, to_jax_aggs(q.aggs),
                                            to_jax_group(q.group),
                                            grouped_out=jgo)
        rv, rc, rg = _rpc_answer(pts, q, table_id, READ_HT)
    assert_same_answer(pv, pc, jv, jc, pgo.get("group_values"),
                       jgo.get("group_values"), "bypass vs reference")
    # the keyed combine rebuilds group keys as plain string arrays, the
    # tablet read keeps object arrays: the same keys in the same order
    assert_same_answer(pv, pc, rv, rc, what="bypass vs tablet reads")
    assert [list(g) for g in pgo.get("group_values") or ()] == \
        [list(g) for g in rg or ()]
    assert pst["key_rebuilds"] == 0 == jst["key_rebuilds"]
    assert pst["paths"] == jst["paths"]
    for k in ("prefilter_rows_in", "prefilter_rows_kept", "shards_scanned",
              "blocks", "keyless_blocks", "pinned_files"):
        assert pst[k] == jst[k], k
    if prefilter and query == "q6":
        assert 0 < pst["prefilter_rows_kept"] < pst["prefilter_rows_in"]
    else:
        assert pst["prefilter_rows_in"] == 0 or query == "q1"


def _reason_case(case):
    """(where, aggs, group) the engine refuses for `case`."""
    q6 = tpch.TPCH_Q6
    return {
        "hash_group": (q6.where, (AggSpec("count"),),
                       HashGroupSpec(cols=(tpch.SHIPDATE,))),
        "column_not_fixed": (("cmp", "gt", ("col", 99), ("const", 1)),
                             (AggSpec("count"),), None),
        "expr_shape": (("in", ("col", 1), [1.0, None]),
                       (AggSpec("count"),), None),
        "not_aggregate": (q6.where, (), None),
    }[case]


@pytest.mark.parametrize("case", ["hash_group", "column_not_fixed",
                                  "expr_shape", "not_aggregate",
                                  "not_chunk_safe"])
def test_refusal_reasons_match_reference(tmp_path, shards, data, case):
    if case == "not_chunk_safe":
        # two loads of the same keys: overlapping runs
        jts, pts = tablet_pair(str(tmp_path), "hash", data,
                               loads=((0, None), (10, None)))
        where, aggs, group = tpch.TPCH_Q6.where, tpch.TPCH_Q6.aggs, None
    else:
        jts, pts = shards[("hash", 1)]
        where, aggs, group = _reason_case(case)
    reasons = []
    with _flags():
        for bp, ts, conv in ((pbp, pts, False), (jbp, jts, True)):
            kw = {} if conv else {"device": "cpu"}
            with bp.BypassSession(ts, read_ht=READ_HT, **kw) as s:
                with pytest.raises(bp.BypassIneligible) as ei:
                    s.scan_aggregate(
                        where, to_jax_aggs(aggs) if conv else aggs,
                        to_jax_group(group) if conv else group)
            reasons.append(ei.value.reason)
    assert reasons[0] == reasons[1] == case
    assert pbp.ALL_REASONS == jbp.errors.ALL_REASONS


def test_session_restarts_on_the_uncertainty_window(tmp_path, data):
    """A session-chosen read point just below rows loaded 100 ms ahead
    re-pins at their hybrid time, as the reference does."""
    jts, pts = tablet_pair(str(tmp_path), "hash", data,
                           loads=((100_000, None),))
    q = tpch.TPCH_Q1
    with _flags():
        with pbp.BypassSession(pts, device="cpu") as ps, \
                jbp.BypassSession(jts) as js:
            assert ps.read_ht == js.read_ht == \
                (TABLET_BASE_US + 100_000) << 12
            pv, pc, _ = ps.scan_aggregate(q.where, q.aggs, q.group)
            jv, jc, _ = js.scan_aggregate(q.where, to_jax_aggs(q.aggs),
                                          to_jax_group(q.group))
    assert_same_answer(pv, pc, jv, jc)
    assert int(np.asarray(pc).sum()) == int(np.asarray(jc).sum()) > 0


def test_compaction_under_an_open_session_keeps_pinned_files(tmp_path, data):
    # both loads below the clock, no retention: the compaction keeps the
    # newest version of each key, one chunk-safe SST
    jts, pts = tablet_pair(str(tmp_path), "hash", data,
                           loads=((-2000, None),
                                  (-1000, data["rowid"] < 1000)))
    (pt,), (jt,) = pts, jts
    q = tpch.TPCH_Q6
    gc = {"tpu_compaction_enabled": False,
          "history_retention_interval_sec": 0}
    with _flags(), flags_set(gc, gc):
        ps = pbp.BypassSession([pt], read_ht=READ_HT, device="cpu",
                               min_chunks=99)
        before = [r.path for r in pt.regular.ssts]
        pt.compact()
        assert all(os.path.exists(p) for p in before)
        assert pt.regular.pin_stats() == {"pinned_files": 2,
                                          "deferred_deletes": 2}
        with pytest.raises(pbp.BypassIneligible, match="not_chunk_safe"):
            ps.scan_aggregate(q.where, q.aggs)        # two overlapping SSTs
        ps.close()
        assert not any(os.path.exists(p) for p in before)
        assert pt.regular.pin_stats() == {"pinned_files": 0,
                                          "deferred_deletes": 0}
        # after the compaction one SST: the session serves, like the
        # reference's over the same compaction
        jt.compact()
        with pbp.BypassSession([pt], read_ht=READ_HT, device="cpu") as ps, \
                jbp.BypassSession([jt], read_ht=READ_HT) as js:
            pv, pc, _ = ps.scan_aggregate(q.where, q.aggs)
            jv, jc, _ = js.scan_aggregate(q.where, to_jax_aggs(q.aggs))
    assert_same_answer(pv, pc, jv, jc)


def test_lease_defers_unlink_and_open_sweeps_strays(tmp_path, data):
    from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec
    from yugabyte_db_tpu_torch.storage.lsm import LsmStore
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    codec = TableCodec(tpch.lineitem_info())
    d = str(tmp_path / "s")
    store = LsmStore(d, name="regular", key_builder=codec.derive_keys)
    small = {k: v[:5000] for k, v in data.items()}
    codec.bulk_ingest(store, small, HybridTime(1000))
    codec.bulk_ingest(store, small, HybridTime(2000))
    old = store.ssts
    lease = store.pin_ssts(require_empty_memtable=True)
    assert sorted(lease.paths) == sorted(r.path for r in old)
    new_path = store._new_sst_path()
    codec.bulk_ingest(LsmStore(str(tmp_path / "x")), small, HybridTime(3))
    os.replace(next(p for p in (tmp_path / "x").iterdir()
                    if p.suffix == ".sst"), new_path)
    store.replace_ssts(old, new_path)
    assert all(os.path.exists(r.path) for r in old)
    assert store.pin_stats()["deferred_deletes"] == 2
    with lease:
        pass
    assert not any(os.path.exists(r.path) for r in old)
    lease.release()                                  # idempotent
    # a stray SST (a lease lost with its process) goes at the next open
    stray = os.path.join(d, "regular.000099.sst")
    open(stray, "wb").close()
    LsmStore(d, name="regular", key_builder=codec.derive_keys)
    assert not os.path.exists(stray)


def test_refusals_of_what_is_not_ported(shards):
    _, pts = shards[("hash", 1)]
    q = tpch.TPCH_Q6
    with pbp.BypassSession(pts, read_ht=READ_HT, device="cpu") as s:
        # the mesh combine serves no join, as in the reference
        join = pjs.JoinWire(probe_col=tpch.ROWID,
                            keys=np.arange(4, dtype=np.int64))
        with pytest.raises(ValueError, match="mesh combine does not serve"):
            s.scan_aggregate(q.where, q.aggs, combine="mesh", join=join)
        with pytest.raises(NotPortedError, match="item 9"):
            s.scan_aggregate(("cmp", "gt", ("json", "->", ("col", 1), "a"),
                              ("const", 1)), q.aggs)
    assert s.closed
    with pytest.raises(RuntimeError, match="closed"):
        s.scan_aggregate(q.where, q.aggs)


# --- the mesh combine -------------------------------------------------------------
@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("query,n_tablets", [("q6", 1), ("q6", 8), ("q1", 8)])
def test_mesh_combine_matches_reference(shards, data, query, n_tablets,
                                        mode):
    """combine="mesh" over CPU slots against the reference's mesh combine
    on its 8 virtual CPU devices: the same sharded batch and program,
    hence the same bits; and within 1e-6 of numpy, the reference test's
    bar (tests/test_bypass_reader.py::test_mesh_combine_psum)."""
    kind, q = QUERIES[query]
    jts, pts = shards[(kind, n_tablets)]
    with _flags(mode):
        with pbp.BypassSession(pts, read_ht=READ_HT, device="cpu") as ps, \
                jbp.BypassSession(jts, read_ht=READ_HT) as js:
            pv, pc, pst = ps.scan_aggregate(q.where, q.aggs, q.group,
                                            combine="mesh")
            jv, jc, jst = js.scan_aggregate(q.where, to_jax_aggs(q.aggs),
                                            to_jax_group(q.group),
                                            combine="mesh")
    assert_same_answer(pv, pc, jv, jc, what="mesh vs reference mesh")
    assert pst == jst
    assert pst["combine"] == "mesh" and pst["shards_scanned"] == n_tablets
    if query == "q6":
        ref = tpch.numpy_reference(q, data)
        assert abs(float(pv[0]) - ref) <= 1e-6 * abs(ref)
    else:
        for g, (qsum, psum, cnt) in tpch.numpy_reference(q, data).items():
            assert int(pc[g]) == cnt and float(pv[0][g]) == qsum
            assert abs(float(pv[1][g]) - psum) <= 1e-6 * abs(psum)


def test_mesh_combine_equals_the_host_combine(shards):
    """Mesh and host combines of one session agree: counts exact, sums
    within 1e-9 relative (one scale over all shards against one per
    shard)."""
    _, pts = shards[("hash", 8)]
    q = tpch.TPCH_Q1
    with _flags(), pbp.BypassSession(pts, read_ht=READ_HT,
                                     device="cpu") as s:
        mv, mc, _ = s.scan_aggregate(q.where, q.aggs, q.group,
                                     combine="mesh")
        hv, hc, _ = s.scan_aggregate(q.where, q.aggs, q.group)
    assert np.array_equal(np.asarray(mc), np.asarray(hc))
    for a, b in zip(mv, hv):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-9)


@pytest.mark.parametrize("shape", ["dict", "hash"])
def test_mesh_combine_refuses_unserved_group_shapes(shards, shape):
    """A dict-grouped scan: the reference's ValueError, in both packages.
    A hash group: the reference fails on unpacking its int column ids
    (TypeError); the port refuses with a ValueError naming the shape."""
    kind, n = ("str", 1) if shape == "dict" else ("hash", 8)
    jts, pts = shards[(kind, n)]
    if shape == "dict":
        q = QUERIES["q1_str"][1]
        where, aggs, group = q.where, q.aggs, q.group
        perr, jerr, match = ValueError, ValueError, "dict-grouped"
    else:
        where, aggs, group = _reason_case("hash_group")
        perr, jerr, match = ValueError, TypeError, "HashGroupSpec"
    with _flags():
        with pbp.BypassSession(pts, read_ht=READ_HT, device="cpu") as ps, \
                jbp.BypassSession(jts, read_ht=READ_HT) as js:
            with pytest.raises(jerr):
                js.scan_aggregate(where, to_jax_aggs(aggs),
                                  to_jax_group(group), combine="mesh")
            with pytest.raises(perr, match=match):
                ps.scan_aggregate(where, aggs, group, combine="mesh")


def test_mesh_combine_refuses_a_shard_that_is_not_chunk_safe(tmp_path, data):
    jts, pts = tablet_pair(str(tmp_path), "hash", data, n_tablets=2,
                           loads=((0, None), (10, None)))
    q = tpch.TPCH_Q6
    reasons = []
    with _flags():
        for bp, ts, kw, aggs in ((pbp, pts, {"device": "cpu"}, q.aggs),
                                 (jbp, jts, {}, to_jax_aggs(q.aggs))):
            with bp.BypassSession(ts, read_ht=READ_HT, **kw) as s:
                with pytest.raises(bp.BypassIneligible) as ei:
                    s.scan_aggregate(q.where, aggs, None, combine="mesh")
            reasons.append(ei.value.reason)
    assert reasons == ["not_chunk_safe"] * 2


def test_mesh_combine_on_cuda_needs_a_card_per_shard(shards, monkeypatch):
    """A CUDA session takes one card per shard and raises the
    reference's ValueError when the machine has fewer (here: a session
    that believes it is on a one-card machine; nothing runs)."""
    import torch
    _, pts = shards[("hash", 8)]
    q = tpch.TPCH_Q6
    with pbp.BypassSession(pts, read_ht=READ_HT, device="cpu") as s:
        s.device = torch.device("cuda", 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="mesh combine needs 8 "
                                             "devices, backend has 1"):
            s.scan_aggregate(q.where, q.aggs, None, combine="mesh")


def test_session_defaults_to_cuda(shards):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, pts = shards[("hash", 1)]
    with pytest.raises(DeviceUnavailable):
        pbp.BypassSession(pts, read_ht=READ_HT)
