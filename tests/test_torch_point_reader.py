"""The whole-SST point reader (csrc/host_hot.c PointReader through
storage/sst.py point_reader) and the fused range read (range_read) of
the port against the reference's and against the port's own per-key
path, on the CPU: the same seeded writes on paired tablets under mock
clocks — overwrites, tombstones, several SSTs, the memtable merge, TTL'd
blocks without a columnar sidecar, versions that run across blocks, the
row cap, read restarts — and BETWEEN ranges over edges, missing keys,
memtable-only rows, two memtables, and empty or inverted ranges.  The
route counters (docdb/hotpath.py POINT_READ_STATS) show which path
served.  Tolerance: none."""
import os

import pytest

from yugabyte_db_tpu.docdb.operations import ReadRequest as JReq
from yugabyte_db_tpu.docdb.operations import ReadRestartError as JRestart
from yugabyte_db_tpu.docdb.operations import RowOp as JOp
from yugabyte_db_tpu.docdb.operations import WriteRequest as JW
from yugabyte_db_tpu.docdb.table_codec import TableCodec as JCodec
from yugabyte_db_tpu.models import ycsb as jycsb
from yugabyte_db_tpu.storage import sst as jsst
from yugabyte_db_tpu.tablet import Tablet as JTablet
from yugabyte_db_tpu.utils import hybrid_time as jht
from yugabyte_db_tpu_torch.docdb import operations as pops
from yugabyte_db_tpu_torch.docdb.hotpath import POINT_READ_STATS, reset_stats
from yugabyte_db_tpu_torch.docdb.operations import (ReadRequest,
                                                    ReadRestartError, RowOp,
                                                    WriteRequest)
from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec
from yugabyte_db_tpu_torch.models import ycsb
from yugabyte_db_tpu_torch.storage import sst as psst
from yugabyte_db_tpu_torch.tablet import Tablet
from yugabyte_db_tpu_torch.utils import hybrid_time as pht
from tests.torch_parity import (WRITE_BASE_US, flags_set, kv_infos,
                                kv_tablet_pair, write_both)


def _python_results(tablet, pk_rows, read_ht):
    """The port's per-key path (_find_best) as ground truth."""
    op = tablet._read_op
    mems, ssts = op.store.read_snapshot()
    out = []
    for r in pk_rows:
        f = op._find_best(op.codec.doc_key_prefix(r), read_ht, None,
                          mems, ssts)
        out.append(None if f is None else op._decode_best(f, read_ht))
    return out


def _read_point(jphys):
    return (jphys.now_micros() << 12) + 1


def _both_multi_read(jt, pt, keys, read_ht):
    got = pt.multi_read("t1", keys, read_ht=read_ht)
    assert got == jt.multi_read("t1", keys, read_ht=read_ht)
    assert got == _python_results(pt, keys, read_ht)
    return got


def _upserts(rows):
    return [("upsert", r) for r in rows]


def test_parity_overwrites_tombstones_multi_sst(tmp_path):
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
    write_both(jt, pt, _upserts({"k": i, "v": float(i), "s": f"a{i}",
                                 "n": i % 5} for i in range(50)))
    jt.flush(), pt.flush()
    jphys.advance_micros(10), pphys.advance_micros(10)
    write_both(jt, pt, _upserts({"k": i, "v": i + 100.0, "s": f"b{i}",
                                 "n": None} for i in range(0, 50, 2)))
    write_both(jt, pt, [("delete", {"k": i}) for i in range(0, 50, 5)])
    jt.flush(), pt.flush()
    assert len(pt.regular.ssts) == 2
    reset_stats()
    keys = [{"k": i} for i in range(-3, 55)]       # misses on both ends
    got = _both_multi_read(jt, pt, keys, _read_point(jphys))
    assert POINT_READ_STATS["readers_built"] == 2
    assert POINT_READ_STATS["find_many_keys"] == len(keys)
    assert POINT_READ_STATS["per_key_keys"] == 0
    assert got[3 + 10] is None                     # deleted in SST 2
    assert got[3 + 2]["v"] == 102.0                # overwritten
    assert got[3 + 1]["v"] == 1.0                  # only SST 1
    assert got[3 + 51] is None and got[0] is None


def test_parity_memtable_merge(tmp_path):
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
    write_both(jt, pt, _upserts({"k": i, "v": float(i), "s": "x", "n": 1}
                                for i in range(20)))
    jt.flush(), pt.flush()
    jphys.advance_micros(10), pphys.advance_micros(10)
    write_both(jt, pt, [("upsert", {"k": 3, "v": 999.0, "s": "mem",
                                    "n": 2}),
                        ("delete", {"k": 4})])
    reset_stats()
    keys = [{"k": i} for i in range(6)]
    got = _both_multi_read(jt, pt, keys, _read_point(jphys))
    assert got[3]["v"] == 999.0 and got[4] is None
    assert POINT_READ_STATS["memtable_keys"] == 2
    assert POINT_READ_STATS["per_key_keys"] == 0
    # get_row (a single key) merges the memtable alike
    for k in range(6):
        req = ReadRequest("t1", pk_eq={"k": k}, read_ht=_read_point(jphys))
        jreq = JReq("t1", pk_eq={"k": k}, read_ht=_read_point(jphys))
        assert pt.read(req).rows == jt.read(jreq).rows


def test_parity_ttl_blocks_take_the_per_key_path(tmp_path):
    """TTL'd values never get columnar sidecars: their SST's blocks have
    no finder, find_many answers NotImplemented for their keys, and the
    per-key path honours the expiry."""
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
    write_both(jt, pt, [("upsert", {"k": 1, "v": 1.0, "s": "dies",
                                    "n": 1})], ttl_ms=1000)
    write_both(jt, pt, [("upsert", {"k": 2, "v": 2.0, "s": "lives",
                                    "n": 2})])
    jt.flush(), pt.flush()
    assert pt.regular.ssts[0].index[0].col_offset < 0    # no sidecar
    jphys.advance_micros(10_000_000), pphys.advance_micros(10_000_000)
    reset_stats()
    got = _both_multi_read(jt, pt, [{"k": 1}, {"k": 2}, {"k": 3}],
                           _read_point(jphys))
    assert got[0] is None and got[1]["v"] == 2.0 and got[2] is None
    assert POINT_READ_STATS["per_key_keys"] == 2       # bloom skips k=3
    assert POINT_READ_STATS["find_many_keys"] == 1


def _multi_block_ssts(tmp_path, block_rows):
    """One SST per package, written from the same KV entries in blocks
    of `block_rows` rows: 40 versions of k=7 among padding keys, so its
    versions run across block boundaries."""
    jinfo, pinfo = kv_infos("hash")
    jc, pc = JCodec(jinfo), TableCodec(pinfo)
    entries = []
    for i in range(40):
        ht = pht.DocHybridTime(pht.HybridTime.from_micros(1000 + i), 0)
        for k, v in ((7, float(i)), (7000 + i, 0.0)):
            entries.append(pc.encode_write({"k": k, "v": v, "s": f"v{i}",
                                            "n": None}, ht))
        if i % 9 == 4:
            entries.append(pc.encode_delete({"k": 7}, pht.DocHybridTime(
                pht.HybridTime.from_micros(1000 + i), 1)))
    entries.sort()
    readers = []
    for name, mod, codec in (("j", jsst, jc), ("p", psst, pc)):
        path = os.path.join(str(tmp_path), f"{name}.sst")
        w = mod.SstWriter(path, block_rows=block_rows,
                          columnar_builder=codec.columnar_builder)
        for k, v in entries:
            w.add(k, v)
        w.finish()
        readers.append(mod.SstReader(path, row_decoder=codec.row_decoder,
                                     key_builder=codec.derive_keys))
    assert open(readers[0].path, "rb").read() == \
        open(readers[1].path, "rb").read()
    return readers, (jc, pc), entries


@pytest.mark.parametrize("block_rows", [3, 7, 16])
def test_versions_run_across_blocks(tmp_path, block_rows):
    (jr, pr), (jc, pc), entries = _multi_block_ssts(tmp_path, block_rows)
    assert pr.num_blocks() > 3
    prefixes = sorted({k[:-13] for k, _ in entries}) + [b"\x00", b"\xff"]
    ppr, jpr_ = pr.point_reader(pc), jr.point_reader(jc)
    for us in (999, 1003, 1004, 1020, 1040, 1_000_000):
        read_ht = pht.HybridTime.from_micros(us).value
        for rh in (-1, read_ht + (5 << 12)):
            got = ppr.find_many(prefixes, read_ht, rh)
            assert got == jpr_.find_many(prefixes, read_ht, rh)
            # each hit is the per-key walk's winner
            for p, g in zip(prefixes, got):
                f = pr.point_find(p, read_ht, None if rh < 0 else rh)
                if isinstance(g, int) and not isinstance(g, bool):
                    assert f[0] == "restart" and f[1] == g
                elif g is None:
                    assert f is None
                else:
                    assert f[0] == "row" and f[1:3] == g[:2]


def test_row_cap_disables_the_eager_reader(tmp_path):
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
    write_both(jt, pt, _upserts({"k": i, "v": float(i), "s": "x", "n": i}
                                for i in range(30)))
    jt.flush(), pt.flush()
    with flags_set({"native_point_reader_max_rows": 10},
                   {"native_point_reader_max_rows": 10}):
        reset_stats()
        sst = pt.regular.ssts[0]
        sst._point_readers.clear()
        jt.regular.ssts[0]._point_readers.clear()
        assert sst.point_reader(pt._read_op.codec) is None
        keys = [{"k": 5}, {"k": 29}, {"k": 99}]
        got = _both_multi_read(jt, pt, keys, _read_point(jphys))
        assert got[0]["v"] == 5.0 and got[2] is None
        assert POINT_READ_STATS["readers_refused"] == 1
        assert POINT_READ_STATS["readers_built"] == 0
        assert POINT_READ_STATS["find_many_keys"] == 0
    sst._point_readers.clear()
    assert sst.point_reader(pt._read_op.codec) is not None


@pytest.mark.parametrize("where", ["sst", "memtable"])
def test_read_restart_matches_reference(tmp_path, where):
    """A version inside (read_ht, read_ht + skew] restarts the read at
    its hybrid time, from an SST (find_many's int answer) and from the
    memtable, in both packages; without restarts the read serves the
    older version."""
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
    write_both(jt, pt, _upserts({"k": i, "v": 1.0, "s": "old", "n": 0}
                                for i in range(10)))
    jt.flush(), pt.flush()
    jphys.advance_micros(100), pphys.advance_micros(100)
    before = _read_point(jphys)
    jphys.advance_micros(100), pphys.advance_micros(100)
    write_both(jt, pt, [("upsert", {"k": 4, "v": 2.0, "s": "new",
                                    "n": 1})])
    if where == "sst":
        jt.flush(), pt.flush()
    keys = [{"k": 3}, {"k": 4}]
    with pytest.raises(JRestart) as want:
        jt._read_op.multi_get(keys, before, allow_restart=True)
    with pytest.raises(ReadRestartError) as got:
        pt._read_op.multi_get(keys, before, allow_restart=True)
    assert got.value.restart_ht == want.value.restart_ht
    rows = pt._read_op.multi_get(keys, before, allow_restart=False)
    assert rows == jt._read_op.multi_get(keys, before, allow_restart=False)
    assert rows[1]["s"] == "old"
    # the tablet's own read point restarts past the write and serves it
    assert pt.multi_read("t1", keys)[1]["s"] == "new"


# --- the fused range read (YCSB-E's BETWEEN on the hash key) -------------
def _usertables(tmp_path):
    jphys = jht.MockPhysicalClock(WRITE_BASE_US)
    pphys = pht.MockPhysicalClock(WRITE_BASE_US)
    jt = JTablet("u", jycsb.usertable_info(), str(tmp_path / "j"),
                 clock=jht.HybridClock(jphys))
    pt = Tablet("u", ycsb.usertable_info(), str(tmp_path / "p"),
                clock=pht.HybridClock(pphys), device="cpu")
    return jt, pt, jphys, pphys


def _urow(k, tag):
    return {"ycsb_key": k, **{f"field{i}": f"{tag}{i}" for i in range(10)}}


def _uwrite(jt, pt, ops):
    jt.apply_write(JW("usertable", [JOp(k, dict(r)) for k, r in ops]))
    pt.apply_write(WriteRequest("usertable",
                                [RowOp(k, dict(r)) for k, r in ops]))


def _between(req_cls, lo, hi, columns=None, read_ht=None):
    return req_cls("usertable", where=("between", ("col", 0),
                                       ("const", lo), ("const", hi)),
                   columns=columns, read_ht=read_ht)


def _range_both(jt, pt, lo, hi, columns, read_ht, fused=True):
    """The port's BETWEEN read (fused), the same through the per-key
    MultiGet, and the reference's: equal rows in equal order."""
    got = pt.read(_between(ReadRequest, lo, hi, columns, read_ht)).rows
    orig = pops.DocReadOperation._range_read_fused
    pops.DocReadOperation._range_read_fused = \
        pops.DocReadOperation._enumerated_multi_get
    try:
        plain = pt.read(_between(ReadRequest, lo, hi, columns,
                                 read_ht)).rows
    finally:
        pops.DocReadOperation._range_read_fused = orig
    want = jt.read(_between(JReq, lo, hi, columns, read_ht)).rows
    assert got == want == plain
    return got


RANGE_CASES = ["versions_tombstones_memtable", "edges_and_missing",
               "memtable_only", "two_memtables", "empty_and_inverted",
               "row_cap"]


@pytest.mark.parametrize("case", RANGE_CASES)
@pytest.mark.parametrize("columns", [None, ("ycsb_key", "field0")])
def test_range_read(tmp_path, case, columns):
    jt, pt, jphys, pphys = _usertables(tmp_path)
    cap = {}
    if case == "versions_tombstones_memtable":
        _uwrite(jt, pt, [("upsert", _urow(k, "a")) for k in range(300)])
        jt.flush(), pt.flush()
        jphys.advance_micros(10), pphys.advance_micros(10)
        _uwrite(jt, pt, [("upsert", _urow(k, "b")) for k in range(0, 300, 2)])
        _uwrite(jt, pt, [("delete", {"ycsb_key": k})
                         for k in range(0, 300, 7)])
        jt.flush(), pt.flush()
        jphys.advance_micros(10), pphys.advance_micros(10)
        _uwrite(jt, pt, [("upsert", _urow(10, "mem")),
                         ("delete", {"ycsb_key": 11}),
                         ("upsert", _urow(14, "back"))])
        spans = [(8, 20), (0, 40), (290, 310)]
    elif case == "edges_and_missing":
        jt.bulk_load(jycsb.generate_rows(50),
                     ht=jht.HybridTime.from_micros(WRITE_BASE_US))
        pt.bulk_load(ycsb.generate_rows(50),
                     ht=pht.HybridTime.from_micros(WRITE_BASE_US))
        spans = [(45, 60), (1000, 1009), (-5, 3)]
    elif case == "memtable_only":
        _uwrite(jt, pt, [("upsert", _urow(k, "m")) for k in range(20)])
        spans = [(5, 14), (15, 30)]
    elif case == "two_memtables":
        _uwrite(jt, pt, [("upsert", _urow(k, "x")) for k in range(20)])
        jt.regular.freeze_active(), pt.regular.freeze_active()
        jphys.advance_micros(10), pphys.advance_micros(10)
        _uwrite(jt, pt, [("upsert", _urow(k, "y")) for k in range(5, 10)])
        assert len([m for m in pt.regular.memtables() if not m.empty()]) \
            == 2
        spans = [(0, 12)]
    elif case == "empty_and_inverted":
        jt.bulk_load(jycsb.generate_rows(100),
                     ht=jht.HybridTime.from_micros(WRITE_BASE_US))
        pt.bulk_load(ycsb.generate_rows(100),
                     ht=pht.HybridTime.from_micros(WRITE_BASE_US))
        spans = [(10, 5), (-5, -1), (99, 99)]
    else:                                   # row_cap: a reader-less SST
        _uwrite(jt, pt, [("upsert", _urow(k, "c")) for k in range(40)])
        jt.flush(), pt.flush()
        cap = {"native_point_reader_max_rows": 10}
        spans = [(3, 13)]
    read_ht = _read_point(jphys)
    with flags_set(cap, cap):
        reset_stats()
        for lo, hi in spans:
            _range_both(jt, pt, lo, hi, columns, read_ht)
        stats = dict(POINT_READ_STATS)
    if case in ("two_memtables", "row_cap"):
        # the fused read does not take this snapshot: the per-key
        # MultiGet serves it
        assert stats["range_read_calls"] == 0
    elif case == "empty_and_inverted":
        # an inverted span enumerates no key and makes no call
        assert stats["range_read_calls"] == 2
    else:
        assert stats["range_read_calls"] == len(spans)
    if case == "versions_tombstones_memtable":
        got = {r["ycsb_key"]: r["field0"] for r in _range_both(
            jt, pt, 8, 20, ("ycsb_key", "field0"), read_ht)}
        assert got == {8: "b0", 9: "a0", 10: "mem0", 12: "b0", 13: "a0",
                       15: "a0", 16: "b0", 17: "a0", 18: "b0", 19: "a0",
                       20: "b0", 14: "back0"}
