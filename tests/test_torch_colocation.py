"""Colocated tablets of the port (tablet/tablet.py colocated=True,
add_table, the cotable-prefixed doc keys of docdb/table_codec.py, and
ColocatedRepackingFeed) against the reference's on the CPU: one tablet
hosting two tables under a parent anchor, the same seeded writes on
both packages under mock clocks, point, range, filtered and aggregate
reads kept apart per table, ALTER of one table and the per-cotable
repacking compaction, TRUNCATE of one table (cotable tombstones) with
the other intact, a reopen, and byte-identical SSTs throughout.
Tolerance: none."""
import numpy as np
import pytest

from yugabyte_db_tpu.docdb.operations import ReadRequest as JReq
from yugabyte_db_tpu.docdb.operations import RowOp as JOp
from yugabyte_db_tpu.docdb.operations import WriteRequest as JW
from yugabyte_db_tpu.docdb.table_codec import TableInfo as JInfo
from yugabyte_db_tpu.dockv import packed_row as jpr
from yugabyte_db_tpu.dockv.partition import PartitionSchema as JPS
from yugabyte_db_tpu.ops.scan import AggSpec as JAgg
from yugabyte_db_tpu.tablet import Tablet as JTablet
from yugabyte_db_tpu.utils import hybrid_time as jht
from yugabyte_db_tpu_torch.docdb.operations import (ReadRequest, RowOp,
                                                    WriteRequest)
from yugabyte_db_tpu_torch.docdb.table_codec import TableInfo
from yugabyte_db_tpu_torch.dockv import packed_row as ppr
from yugabyte_db_tpu_torch.dockv.partition import PartitionSchema
from yugabyte_db_tpu_torch.dockv.value import ValueKind, unwrap_ttl
from yugabyte_db_tpu_torch.ops.scan import AggSpec
from yugabyte_db_tpu_torch.tablet import Tablet
from yugabyte_db_tpu_torch.utils import hybrid_time as pht
from tests.torch_parity import WRITE_BASE_US, store_files

TABLES = {"a": 1, "b": 2}          # table id -> cotable id


def _schema(pr, version=1):
    C, T = pr.ColumnSchema, pr.ColumnType
    cols = (C(0, "k", T.INT64, is_hash_key=True), C(1, "v", T.FLOAT64),
            C(2, "s", T.STRING))
    if version >= 2:
        cols += (C(3, "extra", T.INT32),)
    return pr.TableSchema(cols, version)


def _infos(tid, cotable, version=1):
    return (JInfo(tid, tid, _schema(jpr, version), JPS("hash", 1),
                  cotable_id=cotable),
            TableInfo(tid, tid, _schema(ppr, version),
                      PartitionSchema("hash", 1), cotable_id=cotable))


class Pair:
    """A reference and a port colocated tablet (the port's on the CPU)
    hosting tables a and b under the parent anchor, on two mock clocks:
    advance both alike."""

    def __init__(self, root):
        self.root = root
        self.jphys = jht.MockPhysicalClock(WRITE_BASE_US)
        self.pphys = pht.MockPhysicalClock(WRITE_BASE_US)
        self.open()

    def open(self):
        jp, pp = _infos("parent", None)
        self.jt = JTablet("c", jp, str(self.root / "j"),
                          clock=jht.HybridClock(self.jphys), colocated=True)
        self.pt = Tablet("c", pp, str(self.root / "p"),
                         clock=pht.HybridClock(self.pphys), colocated=True,
                         device="cpu")
        for tid, cot in TABLES.items():
            ji, pi = _infos(tid, cot)
            self.jt.add_table(ji)
            self.pt.add_table(pi)

    def advance(self, us):
        self.jphys.advance_micros(us)
        self.pphys.advance_micros(us)

    def write(self, tid, ops):
        self.advance(3)
        self.jt.apply_write(JW(tid, [JOp(k, dict(r)) for k, r in ops]))
        self.pt.apply_write(WriteRequest(tid, [RowOp(k, dict(r))
                                               for k, r in ops]))

    def flush(self):
        self.jt.flush()
        self.pt.flush()

    def read_point(self):
        return (self.jphys.now_micros() << 12) + 1

    def same(self, tid, **kw):
        read_ht = self.read_point()
        agg = kw.pop("aggs", None)
        jreq = JReq(tid, read_ht=read_ht, **kw,
                    **({"aggregates": tuple(JAgg(*a) for a in agg)}
                       if agg else {}))
        preq = ReadRequest(tid, read_ht=read_ht, **kw,
                           **({"aggregates": tuple(AggSpec(*a)
                                                   for a in agg)}
                              if agg else {}))
        got, want = self.pt.read(preq), self.jt.read(jreq)
        assert got.rows == want.rows
        assert (got.agg_values is None) == (want.agg_values is None)
        if got.agg_values is not None:
            assert list(got.agg_values) == list(want.agg_values)
        assert got.backend == want.backend
        return got


def _fill(pair, seed=0, n=40):
    rng = np.random.default_rng(seed)
    for tid, scale in (("a", 1.0), ("b", 100.0)):
        pair.write(tid, [("upsert", {"k": i, "v": i * scale,
                                     "s": f"{tid}{i}"}) for i in range(n)])
    for _ in range(30):
        tid = "a" if rng.random() < 0.5 else "b"
        k = int(rng.integers(0, n + 5))
        if rng.random() < 0.3:
            pair.write(tid, [("delete", {"k": k})])
        else:
            pair.write(tid, [("upsert", {"k": k, "v": float(rng.random()),
                                         "s": None})])


def _reads(pair, tid):
    pair.same(tid, pk_eq={"k": 3})
    pair.same(tid, pk_eq={"k": 999})
    pair.same(tid)
    pair.same(tid, columns=("k",), where=("cmp", "gt", ("col", 1),
                                          ("const", 0.5)))
    pair.same(tid, where=("between", ("col", 0), ("const", 5),
                          ("const", 15)))
    pair.same(tid, aggs=[("count",), ("sum", ("col", 1))])
    keys = [{"k": k} for k in range(-1, 50)]
    rp = pair.read_point()
    assert pair.pt.multi_read(tid, keys, read_ht=rp) == \
        pair.jt.multi_read(tid, keys, read_ht=rp)


@pytest.mark.parametrize("state", ["memtable", "sst"])
def test_two_tables_one_tablet(tmp_path, state):
    pair = Pair(tmp_path)
    assert pair.pt.tables() == pair.jt.tables() == ["parent", "a", "b"]
    _fill(pair)
    if state == "sst":
        pair.flush()
        assert store_files(pair.pt.regular) == store_files(pair.jt.regular)
        (sst,) = pair.pt.regular.ssts
        assert all(e.col_offset < 0 for e in sst.index)   # no sidecar
    for tid in TABLES:
        _reads(pair, tid)
    a = pair.pt.read(ReadRequest("a", pk_eq={"k": 3})).rows
    b = pair.pt.read(ReadRequest("b", pk_eq={"k": 3})).rows
    assert a != b                          # the cotables stay apart
    assert pair.pt.schema_version_of("b") == 1


def test_reopen_keeps_both_tables(tmp_path):
    pair = Pair(tmp_path)
    _fill(pair, seed=1)
    pair.flush()
    pair.open()
    for tid in TABLES:
        _reads(pair, tid)


@pytest.mark.parametrize("flushed", [False, True])
def test_truncate_one_colocated_table(tmp_path, flushed):
    """Colocated TRUNCATE tombstones only the target cotable's doc keys:
    the same count in both packages, the sibling keeps its rows, and a
    fresh write to the truncated table reads back."""
    pair = Pair(tmp_path)
    _fill(pair, seed=2)
    if flushed:
        pair.flush()
    pair.advance(10)
    n = pair.pt.truncate_table("a", ht=pht.HybridTime.from_micros(
        pair.pphys.now_micros()).value)
    assert n == pair.jt.truncate_table("a", ht=jht.HybridTime.from_micros(
        pair.jphys.now_micros()).value) > 0
    pair.advance(10)
    assert pair.same("a").rows == []
    assert len(pair.same("b").rows) > 30
    pair.write("a", [("upsert", {"k": 100, "v": 3.0, "s": "back"})])
    assert [(r["k"], r["v"]) for r in pair.same("a").rows] == [(100, 3.0)]
    pair.flush()
    assert store_files(pair.pt.regular) == store_files(pair.jt.regular)
    pair.advance(10)
    pair.jt.compact(), pair.pt.compact()
    assert store_files(pair.pt.regular) == store_files(pair.jt.regular)
    _reads(pair, "b")


def test_compaction_repacks_per_cotable_after_alter(tmp_path):
    """ALTER one colocated table, write rows at both versions, compact:
    ColocatedRepackingFeed repacks each cotable's survivors to its own
    latest packing, byte for byte the reference's output."""
    pair = Pair(tmp_path)
    _fill(pair, seed=3, n=20)
    pair.flush()
    ja, pa = _infos("a", TABLES["a"], version=2)
    pair.jt.alter_table(ja)
    pair.pt.alter_table(pa)
    assert pair.pt.schema_version_of("a") == 2
    assert pair.pt.schema_version_of("b") == 1
    pair.write("a", [("upsert", {"k": 100, "v": 1.0, "s": "n",
                                 "extra": 7})])
    pair.flush()
    pair.advance(10)
    jpath, ppath = pair.jt.compact(), pair.pt.compact()
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    codec = pair.pt.codecs["a"]
    seen = 0
    for k, v in pair.pt.regular.iterate():
        inner, _ = unwrap_ttl(v)
        if inner[0] == ValueKind.kPackedRowV2 and \
                k.startswith(codec.scan_prefix()):
            assert codec.info.packings.version_of(inner, 1) == 2
            seen += 1
    assert seen > 10
    rows = pair.same("a").rows
    assert {r["k"]: r["extra"] for r in rows}[100] == 7
    assert all(r["extra"] is None for r in rows if r["k"] != 100)
    _reads(pair, "b")
