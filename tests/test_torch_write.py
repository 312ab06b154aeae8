"""The port's write path (yugabyte_db_tpu_torch/docdb/operations.py
DocWriteOperation, storage/memtable.py, storage/lsm.py apply/flush,
storage/sst.py row blocks, docdb/table_codec.py columnar_builder and
row_decoder, tablet/tablet.py apply_write and the flush on the apply
path) against the JAX reference on the CPU: the same seeded write
sequence (upserts, deletes, NULLs, row TTLs, several ops per request)
under mock clocks gives the same memtable stream, byte-identical SST
files and manifests after each flush, and a store either package wrote
opens and reads alike in the other; the async flush on the apply path
with its backpressure and the inline flush install the same files; a
cached device batch never hides a newer write (the batch cache key
carries the store's write generation); and aggregates over freshly
written rows (SST + memtable, the dedup route) answer bit for bit with
the reference.  Tolerance: none (bytes, rows and answers compare
exactly)."""
import os

import numpy as np
import pytest

from yugabyte_db_tpu.storage.lsm import LsmStore as JStore
from yugabyte_db_tpu.storage.memtable import MemTable as JMem
from yugabyte_db_tpu.tablet import Tablet as JTablet
from yugabyte_db_tpu.utils import hybrid_time as jht
from yugabyte_db_tpu.utils import sortedcompat as jsc
from yugabyte_db_tpu_torch.docdb import operations as pops
from yugabyte_db_tpu_torch.dockv import value as pvalue
from yugabyte_db_tpu_torch.models import tpch
from yugabyte_db_tpu_torch.storage.lsm import LsmStore, WriteBatch
from yugabyte_db_tpu_torch.storage.memtable import MemTable
from yugabyte_db_tpu_torch.tablet import Tablet
from yugabyte_db_tpu_torch.tablet import tablet as ptablet
from yugabyte_db_tpu_torch.utils import hybrid_time as pht
from yugabyte_db_tpu_torch.utils.sortedcompat import SortedDict
from tests.torch_parity import (TABLET_BASE_US, assert_same_response,
                                flags_set, kv_infos, kv_row, kv_tablet_pair,
                                lineitem_data, requests, store_files,
                                tablet_pair, write_both)


def _advance(jphys, pphys, us):
    jphys.advance_micros(us)
    pphys.advance_micros(us)


def _write_sequence(jt, pt, jphys, pphys, seed, n_ops=150, keys=40,
                    ttl=True, flush_every=None):
    """Seeded upserts, deletes and multi-op requests (some with a TTL)
    applied alike to both tablets."""
    rng = np.random.default_rng(seed)
    for step in range(n_ops):
        _advance(jphys, pphys, int(rng.integers(1, 50)))
        k = int(rng.integers(0, keys))
        c = rng.random()
        if c < 0.6:
            ops = [("upsert", kv_row(rng, k))]
        elif c < 0.75:
            ops = [("delete", {"k": k})]
        else:
            ops = [("upsert", kv_row(rng, int(rng.integers(0, keys))))
                   for _ in range(int(rng.integers(2, 5)))]
            ops.append(("delete", {"k": int(rng.integers(0, keys))}))
        ttl_ms = (int(rng.integers(1, 4))
                  if ttl and rng.random() < 0.25 else None)
        jr, pr = write_both(jt, pt, ops, ttl_ms, op_id=(1, step + 1))
        assert jr.rows_affected == pr.rows_affected == len(ops)
        if flush_every and step % flush_every == flush_every - 1:
            jt.flush()
            pt.flush()


@pytest.mark.parametrize("seed", [3, 17])
def test_flushed_ssts_are_byte_identical(tmp_path, seed):
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
    _write_sequence(jt, pt, jphys, pphys, seed)
    jm, pm = jt.regular._mem, pt.regular._mem
    assert list(pm.iterate()) == list(jm.iterate())
    assert pm.approximate_bytes() == jm.approximate_bytes()
    assert pt.regular.write_generation() == jt.regular.write_generation()
    assert not pt.regular.should_flush()
    jp, pp = jt.flush(), pt.flush()
    assert os.path.basename(jp) == os.path.basename(pp)
    assert store_files(pt.regular) == store_files(jt.regular)
    assert pt.regular.flushed_frontier() == jt.regular.flushed_frontier()
    assert pt.regular.memtable_empty() and pt.flush() is None
    # a second round lands in a second SST; the merged stream matches
    _write_sequence(jt, pt, jphys, pphys, seed + 1, n_ops=60)
    assert list(pt.regular.iterate()) == list(jt.regular.iterate())
    jt.flush()
    pt.flush()
    assert store_files(pt.regular) == store_files(jt.regular)
    assert list(pt.regular.iterate()) == list(jt.regular.iterate())
    mid = list(jt.regular.iterate())[len(list(jt.regular.iterate())) // 2]
    assert list(pt.regular.seek(mid[0])) == list(jt.regular.seek(mid[0]))
    assert pt.regular.get(mid[0]) == jt.regular.get(mid[0]) == mid[1]
    assert pt.regular.get(mid[0] + b"\x00") is None


def test_write_operation_encodes_like_the_reference():
    """DocWriteOperation: one KV per op, write ids in request order, the
    TTL envelope on upserts, tombstones for deletes."""
    from yugabyte_db_tpu.docdb.operations import DocWriteOperation as JOp
    from yugabyte_db_tpu.docdb.operations import RowOp as JRow
    from yugabyte_db_tpu.docdb.operations import WriteRequest as JReq
    from yugabyte_db_tpu.docdb.table_codec import TableCodec as JCodec
    from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec
    jinfo, pinfo = kv_infos("range")
    rng = np.random.default_rng(1)
    rows = [kv_row(rng, k, "range") for k in range(6)]
    ht = 123456 << 12
    for ttl in (None, 7):
        jops = [JRow("upsert", r, ttl) for r in rows] + \
            [JRow("delete", {"k": 2, "r": rows[2]["r"]}),
             JRow("insert", rows[0])]
        pops_ = [pops.RowOp(o.kind, o.row, o.ttl_ms) for o in jops]
        jb, jn = JOp(JCodec(jinfo), JReq("t1", jops)).apply(
            jht.HybridTime(ht), op_id=(2, 9))
        pb, pn = pops.DocWriteOperation(TableCodec(pinfo),
                                        pops.WriteRequest("t1", pops_)
                                        ).apply(pht.HybridTime(ht),
                                                op_id=(2, 9))
        assert pn == jn == len(jops)
        assert pb.entries == jb.entries and pb.op_id == jb.op_id
        inner, exp = pvalue.unwrap_ttl(pb.entries[0][1])
        assert exp == (None if ttl is None
                       else pht.HybridTime(ht).add_micros(ttl * 1000).value)
    with pytest.raises(ValueError):
        pops.DocWriteOperation(TableCodec(pinfo), pops.WriteRequest(
            "t1", [pops.RowOp("merge", rows[0])])).apply(pht.HybridTime(ht))


def test_each_package_opens_the_others_store(tmp_path):
    """The state carried across: flushed SSTs (row blocks with their
    columnar sidecars) and manifests one package wrote, the other opens
    and reads — rows, point reads and the merged KV stream."""
    from yugabyte_db_tpu.utils.hybrid_time import HybridClock as JClock
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
    _write_sequence(jt, pt, jphys, pphys, 5, flush_every=50)
    jt.flush()
    pt.flush()
    jinfo, pinfo = kv_infos()
    # the port over the reference's directory and the other way round
    p_on_j = Tablet("x", pinfo, str(tmp_path / "j"),
                    clock=pht.HybridClock(pht.MockPhysicalClock(
                        jphys.now_micros())), device="cpu")
    j_on_p = JTablet("x", jinfo, str(tmp_path / "p"),
                     clock=JClock(jht.MockPhysicalClock(
                         pphys.now_micros())))
    assert len(p_on_j.regular.ssts) == len(jt.regular.ssts) >= 3
    for a, b in ((p_on_j, jt), (j_on_p, pt), (p_on_j, j_on_p)):
        assert list(a.regular.iterate()) == list(b.regular.iterate())
    read_ht = (jphys.now_micros() << 12) + 5
    keys = [{"k": k} for k in range(45)]
    want = jt.multi_read("t1", keys, read_ht=read_ht)
    assert p_on_j.multi_read("t1", keys, read_ht=read_ht) == want
    assert j_on_p.multi_read("t1", keys, read_ht=read_ht) == want
    assert any(r is None for r in want) and any(want)
    # the port writes on into the reference's store; the reference
    # reads it back after a flush
    rng = np.random.default_rng(9)
    from yugabyte_db_tpu_torch.docdb.operations import RowOp, WriteRequest
    new = kv_row(rng, 1000)
    p_on_j.apply_write(WriteRequest("t1", [RowOp("upsert", new)]))
    p_on_j.flush()
    again = JTablet("y", jinfo, str(tmp_path / "j"),
                    clock=JClock(jht.MockPhysicalClock(
                        pphys.now_micros() + 10)))
    got = again.multi_read("t1", [{"k": 1000}],
                           read_ht=(pphys.now_micros() + 10) << 12)[0]
    assert got == p_on_j.multi_read(
        "t1", [{"k": 1000}], read_ht=(pphys.now_micros() + 10) << 12)[0]
    assert got["s"] == new["s"]


@pytest.mark.parametrize("mode", ["async", "backpressure", "inline"])
def test_flush_on_apply_installs_the_same_files(tmp_path, mode):
    """A small flush threshold: writes trigger the flush on the apply
    path (the async handoff to the flush pool, its inline backpressure
    drain, or the inline flush with async off); after the flush()
    barrier both packages hold the same files."""
    fl = {"memstore_flush_threshold_bytes": 3000,
          "async_flush_enabled": mode != "inline",
          "max_frozen_memtables": 0 if mode == "backpressure" else 2}
    before = dict(ptablet.FLUSH_APPLY_STATS)
    with flags_set(fl, fl):
        jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
        _write_sequence(jt, pt, jphys, pphys, 11, n_ops=120, ttl=False)
        jt.flush()
        pt.flush()
    stats = ptablet.FLUSH_APPLY_STATS
    if mode == "inline":
        assert stats["inline_flushes"] > before["inline_flushes"]
        assert stats["handoffs"] == before["handoffs"]
    else:
        assert stats["handoffs"] > before["handoffs"]
        if mode == "backpressure":
            assert stats["inline_flushes"] > before["inline_flushes"]
    assert len(pt.regular.ssts) >= 3
    assert store_files(pt.regular) == store_files(jt.regular)
    assert pt.regular.memtable_empty() and pt.regular.frozen_count() == 0


def test_memtable_and_sorted_map_match_the_reference():
    """MemTable: the same ordered range iteration, byte accounting and
    the exact negative row-prefix guard (a foreign key layout turns it
    off); SortedDict against the reference's SortedDict."""
    rng = np.random.default_rng(4)
    pm, jm = MemTable(), JMem()
    keys = [bytes(rng.integers(0, 256, int(rng.integers(1, 30)),
                               dtype=np.uint8)) for _ in range(300)]
    for i, k in enumerate(keys):
        row_key = b"\x08" + k + b"\x05" + bytes(12)
        for m in (pm, jm):
            m.put(row_key, bytes([i % 7]) * (i % 5))
            m.put(row_key, b"v")                     # overwrite
    assert list(pm.iterate()) == list(jm.iterate())
    lo, hi = sorted(keys)[40], sorted(keys)[200]
    assert list(pm.iterate(b"\x08" + lo, b"\x08" + hi)) == \
        list(jm.iterate(b"\x08" + lo, b"\x08" + hi))
    assert pm.approximate_bytes() == jm.approximate_bytes()
    assert pm.may_contain_row(b"\x08" + keys[0])
    assert not pm.may_contain_row(b"\x08nope")
    pm.put(b"short", b"x")
    assert pm.may_contain_row(b"\x08nope")           # guard off
    pm.freeze()
    with pytest.raises(AssertionError):
        pm.put(b"k", b"v")
    sd, jd = SortedDict(), jsc.SortedDict()
    for k in keys[:100] + keys[:20]:
        sd[k] = jd[k] = len(k)
        assert list(sd.irange(keys[3], keys[7], (False, True))) == \
            list(jd.irange(keys[3], keys[7], (False, True)))
    assert list(sd.items()) == list(jd.items()) and len(sd) == len(jd)
    assert sd.get(b"?", 5) == 5 and keys[0] in sd


def test_store_snapshot_and_frozen_queue(tmp_path):
    """read_snapshot caches until a write or a structural change; a
    frozen memtable reads until its flush installs; pick_compaction
    takes the oldest run of at least four SSTs."""
    s = LsmStore(str(tmp_path / "s"))
    snap = s.read_snapshot()
    assert snap == ([], []) and s.read_snapshot() is snap
    s.apply(WriteBatch().put(b"a\x05" + bytes(12), b"1"))
    mems, ssts = s.read_snapshot()
    assert len(mems) == 1 and not ssts
    assert s.freeze_active() and not s.freeze_active()
    assert s.frozen_count() == 1 and not s.memtable_empty()
    assert s.get(b"a\x05" + bytes(12)) == b"1"
    assert s.flush_frozen() is not None and s.frozen_count() == 0
    assert s.pick_compaction() == []
    for i in range(4):
        s.apply(WriteBatch(op_id=(1, i)).put(bytes([98 + i]) + b"\x05"
                                             + bytes(12), b"x"))
        s.flush()
    assert s.flushed_frontier() == {"op_id": [1, 3]}
    assert s.pick_compaction(max_files=3) == s.ssts[-3:]
    path = s.compact(inputs=s.pick_compaction(max_files=3))
    assert s.ssts[-1].path == path and len(s.ssts) == 3
    assert [k for k, _ in s.iterate()] == sorted(k for k, _ in s.iterate())
    assert JStore(str(tmp_path / "s")).ssts[-1].frontier == \
        s.ssts[-1].frontier


# --- the batch cache key and aggregates over fresh writes -----------------------
READ_HT = (TABLET_BASE_US + 1000) << 12


def _q6_row(rowid: int):
    return {"rowid": rowid, "l_quantity": 10.0,
            "l_extendedprice": 1000.0 + rowid, "l_discount": 0.06,
            "l_tax": 0.01, "l_shipdate": 9000, "l_returnflag": 1,
            "l_linestatus": 0}


def _lineitem_write(jt, pt, ops, us):
    """One write request at TABLET_BASE_US + us in both packages."""
    from yugabyte_db_tpu.docdb.operations import RowOp as JRow
    from yugabyte_db_tpu.docdb.operations import WriteRequest as JReq
    jt[0].apply_write(JReq("lineitem", [JRow(k, dict(r)) for k, r in ops]),
                      ht=jht.HybridTime.from_micros(TABLET_BASE_US + us))
    pt[0].apply_write(pops.WriteRequest(
        "lineitem", [pops.RowOp(k, dict(r)) for k, r in ops]),
        ht=pht.HybridTime.from_micros(TABLET_BASE_US + us))


@pytest.mark.parametrize("streamed", [True, False])
def test_cached_batch_sees_a_new_write(tmp_path, streamed):
    """A cached Q6 batch, then one apply_write, then the same read: the
    write generation in the batch cache key forces a rebuild, so the
    new row counts (without it the cached batch would answer)."""
    jt, pt = tablet_pair(str(tmp_path), "hash", lineitem_data())
    q = tpch.TPCH_Q6
    fl = {"device_float_dtype": "float64",
          "streaming_scan_enabled": streamed}
    with flags_set(fl, fl):
        jreq, preq = requests("lineitem", q.where, q.aggs, None, READ_HT)
        first = pt[0].read(preq)
        assert_same_response(first, jt[0].read(jreq), "before")
        _lineitem_write(jt, pt, [("upsert", _q6_row(10 ** 7))], 2000)
        read_ht = (TABLET_BASE_US + 3000) << 12
        jreq, preq = requests("lineitem", q.where, q.aggs, None, read_ht)
        after = pt[0].read(preq)
        assert_same_response(after, jt[0].read(jreq), "after")
    assert int(after.group_counts) == int(first.group_counts) + 1
    assert float(after.agg_values[0]) > float(first.agg_values[0])


@pytest.mark.parametrize("mode", ["float64", "float32"])
@pytest.mark.parametrize("streamed", [True, False])
def test_aggregates_over_fresh_writes_match_reference(tmp_path, mode,
                                                      streamed):
    """RF1 inserts and RF2 deletes on a loaded lineitem tablet, then Q6
    and Q1 over SST + memtable (the dedup route), after a flush (two
    SSTs + memtable), and after a baseline compaction: bit for bit with
    the reference, at a read point before the deletes too."""
    data = lineitem_data()
    n = len(data["rowid"])
    jt, pt = tablet_pair(str(tmp_path), "hash", data)
    fl = {"device_float_dtype": mode, "streaming_scan_enabled": streamed,
          "streaming_chunk_rows": 8192, "tpu_compaction_enabled": False}
    us = 2000
    with flags_set(fl, fl):
        for rnd in range(2):
            for order in tpch.refresh_inserts(0.002, n + 100 * rnd,
                                              seed=rnd):
                _lineitem_write(jt, pt, [("upsert", r) for r in
                                         tpch.column_rows(order)], us)
                us += 1
            before_deletes = (TABLET_BASE_US + us) << 12
            for dels in tpch.refresh_deletes(0.002, n, seed=rnd):
                _lineitem_write(jt, pt, [("delete", {"rowid": int(r)})
                                         for r in dels], us + 1)
            us += 10
            for read_ht in ((TABLET_BASE_US + us) << 12, before_deletes):
                for q in (tpch.TPCH_Q6, tpch.TPCH_Q1):
                    jreq, preq = requests("lineitem", q.where, q.aggs,
                                          q.group, read_ht)
                    assert_same_response(pt[0].read(preq),
                                         jt[0].read(jreq),
                                         f"round {rnd} {q.name}")
            assert not all(b.unique_keys
                           for b in pt[0]._read_op._collect_blocks())
            jt[0].flush()
            pt[0].flush()
        jt[0].compact()
        pt[0].compact()
        assert store_files(pt[0].regular) == store_files(jt[0].regular)
        for q in (tpch.TPCH_Q6, tpch.TPCH_Q1):
            jreq, preq = requests("lineitem", q.where, q.aggs, q.group,
                                  (TABLET_BASE_US + us) << 12)
            assert_same_response(pt[0].read(preq), jt[0].read(jreq),
                                 f"compacted {q.name}")


@pytest.mark.parametrize("seed", [7, 23])
def test_randomized_sequence_matches_reference_and_model(tmp_path, seed):
    """Random upserts, deletes, flushes and compactions (the baseline
    backend, and the device backend on the CPU); point reads, row reads
    at historical read points and the aggregate pushdown over the
    written tablet equal the reference's and a versioned dict model's
    (in the style of tests/test_randomized_docdb.py)."""
    from yugabyte_db_tpu.docdb import compaction as jcomp
    from yugabyte_db_tpu.docdb.operations import ReadRequest as JReq
    from yugabyte_db_tpu_torch.docdb import compaction as pcomp
    from yugabyte_db_tpu_torch.ops.scan import AggSpec
    from tests.torch_parity import assert_same_cpu_response, to_jax_aggs
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
    rng = np.random.default_rng(seed)
    model = {}            # k -> [(ht, row or None)]
    checkpoints = []
    for step in range(220):
        _advance(jphys, pphys, int(rng.integers(1, 50)))
        k = int(rng.integers(0, 30))
        op = rng.random()
        if op < 0.6:
            row = kv_row(rng, k)
            write_both(jt, pt, [("upsert", row)])
            model.setdefault(k, []).append((pt.clock.now().value - 1, row))
        elif op < 0.75:
            write_both(jt, pt, [("delete", {"k": k})])
            model.setdefault(k, []).append((pt.clock.now().value - 1, None))
        elif op < 0.85:
            jt.flush()
            pt.flush()
        elif op < 0.9 and len(pt.regular.ssts) >= 2:
            cutoff = pt.history_cutoff()
            if rng.random() < 0.5:
                jcomp.tpu_compact(jt.regular, jt.codec, cutoff,
                                  backend="baseline")
                pcomp.tpu_compact(pt.regular, pt.codec, cutoff,
                                  backend="baseline", device="cpu")
            else:
                jcomp.tpu_compact(jt.regular, jt.codec, cutoff)
                pcomp.tpu_compact(pt.regular, pt.codec, cutoff,
                                  device="cpu")
            assert store_files(pt.regular) == store_files(jt.regular)
        if rng.random() < 0.1:
            checkpoints.append(pt.clock.now().value)

    def model_get(k, read_ht):
        best = None
        for ht, row in model.get(k, []):
            if ht <= read_ht and (best is None or ht > best[0]):
                best = (ht, row)
        return best[1] if best else None

    now = pt.clock.now().value
    for k in range(31):
        got = pt._read_op.get_row({"k": k}, now)
        assert got == jt._read_op.get_row({"k": k}, now)
        want = model_get(k, now)
        assert (got is None) == (want is None)
        if got is not None:
            assert {n: got[n] for n in want} == want
    for read_ht in checkpoints[:8]:
        kw = dict(columns=("k", "v", "s"), read_ht=read_ht)
        presp = pt.read(pops.ReadRequest("t1", **kw))
        assert_same_cpu_response(presp, jt.read(JReq("t1", **kw)))
        assert {r["k"] for r in presp.rows} == \
            {k for k in model if model_get(k, read_ht) is not None}
    aggs = (AggSpec("sum", ("col", 1)), AggSpec("count"),
            AggSpec("max", ("col", 3)))
    fl = {"tpu_min_rows_for_pushdown": 1, "device_float_dtype": "float64"}
    for read_ht in checkpoints[-3:]:
        with flags_set(fl, fl):
            presp = pt.read(pops.ReadRequest("t1", aggregates=aggs,
                                             read_ht=read_ht))
            jresp = jt.read(JReq("t1", aggregates=to_jax_aggs(aggs),
                                 read_ht=read_ht))
        if jresp.backend == "tpu":
            assert_same_response(presp, jresp, "aggregate")
        else:
            assert_same_cpu_response(presp, jresp, "aggregate")
        visible = [model_get(k, read_ht) for k in model]
        assert int(np.asarray(presp.agg_values[1])) == \
            sum(r is not None for r in visible)


def _sidecar_bytes(cb, version=None):
    head, bufs = (cb.serialize_parts() if version is None
                  else cb.serialize_parts(version))
    return head + b"".join(b if isinstance(b, bytes)
                           else memoryview(b).cast("B").tobytes()
                           for b in bufs)


@pytest.mark.parametrize("layout", ["hash", "range", "desc_float",
                                    "string_pk", "mixed_width"])
def test_columnar_builder_and_row_decoder_match_reference(layout):
    """The flush sidecar (columnar_builder: its one-width numpy path and
    the entry-at-a-time loop) and the columnar-only row decoder equal
    the reference's on entries with NULLs, tombstones, several versions
    of a key, descending and float key components and string keys."""
    from yugabyte_db_tpu.docdb.table_codec import TableCodec as JCodec
    from yugabyte_db_tpu.docdb.table_codec import TableInfo as JInfo
    from yugabyte_db_tpu.dockv import packed_row as jpr
    from yugabyte_db_tpu.dockv.partition import PartitionSchema as JPS
    from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec
    from yugabyte_db_tpu_torch.docdb.table_codec import TableInfo as PInfo
    from yugabyte_db_tpu_torch.dockv import packed_row as ppr
    from yugabyte_db_tpu_torch.dockv.partition import PartitionSchema

    def info(pr, ti, ps):
        C, T = pr.ColumnSchema, pr.ColumnType
        key = {"hash": (C(0, "k", T.INT64, is_hash_key=True),),
               "range": (C(0, "k", T.INT64, is_hash_key=True),
                         C(4, "r", T.INT32, is_range_key=True)),
               "desc_float": (C(0, "k", T.INT64, is_range_key=True),
                              C(4, "r", T.FLOAT64, is_range_key=True,
                                sort_desc=True)),
               "string_pk": (C(0, "k", T.STRING, is_hash_key=True),),
               "mixed_width": (C(0, "k", T.INT64, is_hash_key=True),
                               C(4, "r", T.STRING, is_range_key=True))
               }[layout]
        vals = (C(1, "v", T.FLOAT64), C(2, "s", T.STRING),
                C(3, "n", T.INT32), C(5, "b", T.BOOL),
                C(6, "t", T.TIMESTAMP), C(7, "y", T.BINARY))
        kind = "range" if layout == "desc_float" else "hash"
        return ti("t1", "kv", pr.TableSchema(key + vals, 1),
                  ps(kind, 0 if kind == "range" else 1))
    jc = JCodec(info(jpr, JInfo, JPS))
    pc = TableCodec(info(ppr, PInfo, PartitionSchema))
    rng = np.random.default_rng(8)
    entries = []
    for i in range(700):
        k = int(rng.integers(0, 200))
        row = {"k": f"key{k}" if layout == "string_pk" else k,
               "r": (float(rng.integers(-5, 5)) / 3 if layout == "desc_float"
                     else "x" * int(rng.integers(0, 4))
                     if layout == "mixed_width" else int(rng.integers(-9, 9))),
               "v": None if rng.random() < 0.2 else float(rng.normal()),
               "s": None if rng.random() < 0.2 else "é" * int(rng.integers(0, 5)),
               "n": None if rng.random() < 0.2 else int(rng.integers(-99, 99)),
               "b": None if rng.random() < 0.2 else bool(rng.random() < 0.5),
               "t": int(rng.integers(0, 10 ** 12)),
               "y": None if rng.random() < 0.3 else bytes(rng.integers(
                   0, 256, int(rng.integers(0, 6)), dtype=np.uint8))}
        dht = pht.DocHybridTime(pht.HybridTime((1000 + i) << 12), i % 3)
        jdht = jht.DocHybridTime(jht.HybridTime((1000 + i) << 12), i % 3)
        if rng.random() < 0.15:
            pe, je = pc.encode_delete(row, dht), jc.encode_delete(row, jdht)
        else:
            pe, je = pc.encode_write(row, dht), jc.encode_write(row, jdht)
        assert pe == je
        entries.append(pe)
    entries.sort()
    pb, jb = pc.columnar_builder(entries), jc.columnar_builder(entries)
    assert (pb is None) == (jb is None)
    if layout == "mixed_width":
        assert pc._columnar_uniform(entries) is NotImplemented
    if pb is None:
        return
    assert pb.unique_keys == jb.unique_keys is False
    assert sorted(pb.pk) == sorted(jb.pk)
    for cid in pb.pk:
        assert pb.pk[cid].dtype == jb.pk[cid].dtype
        assert np.array_equal(pb.pk[cid], jb.pk[cid])
    assert _sidecar_bytes(pb) == _sidecar_bytes(jb, 2)
    if pb.keys is None:         # several key widths: no keys matrix
        assert jb.keys is None
        with pytest.raises(ValueError):
            pc.row_decoder(pb)
    else:
        assert pc.row_decoder(pb) == jc.row_decoder(jb) == \
            pc._row_decoder_rows(pb, pc.info.packing)
    # a TTL'd value, a foreign value kind, mixed versions: no sidecar
    ttl = [(k, pvalue.wrap_ttl(v, 5)) if i == 3 else (k, v)
           for i, (k, v) in enumerate(entries)]
    assert pc.columnar_builder(ttl) is None is jc.columnar_builder(ttl)
    odd = [(k, b"\x07x") if i == 3 else (k, v)
           for i, (k, v) in enumerate(entries)]
    assert pc.columnar_builder(odd) is None is jc.columnar_builder(odd)


def test_bypass_session_flushes_the_memtable_first(tmp_path):
    """A BypassSession over a tablet whose memtable holds fresh writes:
    the pinner flushes until the memtable is empty; the flushed rows
    overlap the loaded SST, so both packages refuse the SST-direct scan
    with the same typed reason; after a compaction it answers as the
    reference's session and as Tablet.read do."""
    from yugabyte_db_tpu import bypass as jbp
    from yugabyte_db_tpu_torch import bypass as pbp
    from tests.torch_parity import assert_same_answer, to_jax_aggs
    data = lineitem_data()
    jt, pt = tablet_pair(str(tmp_path), "hash", data)
    n = len(data["rowid"])
    for i, order in enumerate(tpch.refresh_inserts(0.002, n, seed=4)):
        _lineitem_write(jt, pt, [("upsert", r) for r in
                                 tpch.column_rows(order)], 2000 + i)
    assert not pt[0].regular.memtable_empty()
    read_ht = (TABLET_BASE_US + 5000) << 12
    q = tpch.TPCH_Q6
    fl = {"device_float_dtype": "float64", "tpu_compaction_enabled": False}
    with flags_set(fl, fl):
        with pbp.BypassSession(pt, read_ht=read_ht, device="cpu") as ps, \
                jbp.BypassSession(jt, read_ht=read_ht) as js:
            with pytest.raises(pbp.BypassIneligible) as pe:
                ps.scan_aggregate(q.where, q.aggs)
            with pytest.raises(jbp.BypassIneligible) as je:
                js.scan_aggregate(q.where, to_jax_aggs(q.aggs))
        assert pe.value.reason == je.value.reason == "not_chunk_safe"
        assert pt[0].regular.memtable_empty()
        assert store_files(pt[0].regular) == store_files(jt[0].regular)
        assert len(pt[0].regular.ssts) == 2
        jt[0].compact()
        pt[0].compact()
        with pbp.BypassSession(pt, read_ht=read_ht, device="cpu") as ps, \
                jbp.BypassSession(jt, read_ht=read_ht) as js:
            pv, pc, pst = ps.scan_aggregate(q.where, q.aggs)
            jv, jc, jst = js.scan_aggregate(q.where, to_jax_aggs(q.aggs))
        jreq, preq = requests("lineitem", q.where, q.aggs, None, read_ht)
        presp = pt[0].read(preq)
    assert_same_answer(pv, pc, jv, jc, what="bypass vs reference")
    assert_same_answer(pv, pc, presp.agg_values, presp.group_counts,
                       what="bypass vs Tablet.read")
    assert pst["pinned_files"] == jst["pinned_files"] == 1
