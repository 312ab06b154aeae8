"""Tablet maintenance of the port (tablet/tablet.py alter_table,
truncate_table, create_snapshot / restore_snapshot / trim_above_ht;
storage/lsm.py truncate and checkpoint; docdb/compaction.py
RepackingCompactionFeed) against the reference on the CPU: the same
seeded writes on paired tablets under mock clocks, the same rows read
back, the same truncate and trim counts, byte-identical SSTs and
manifests, and snapshots that restore across the two packages both
ways.  Tolerance: none."""
import os

import numpy as np
import pytest
import torch

from yugabyte_db_tpu.docdb.operations import ReadRequest as JReq
from yugabyte_db_tpu.docdb.table_codec import TableInfo as JInfo
from yugabyte_db_tpu.dockv import packed_row as jpr
from yugabyte_db_tpu.dockv.partition import PartitionSchema as JPS
from yugabyte_db_tpu.storage.lsm import LsmStore as JStore
from yugabyte_db_tpu.tablet import Tablet as JTablet
from yugabyte_db_tpu.utils import hybrid_time as jht
from yugabyte_db_tpu_torch.device import DeviceUnavailable
from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
from yugabyte_db_tpu_torch.docdb.table_codec import TableInfo
from yugabyte_db_tpu_torch.dockv import packed_row as ppr
from yugabyte_db_tpu_torch.dockv.partition import PartitionSchema
from yugabyte_db_tpu_torch.dockv.value import ValueKind, unwrap_ttl
from yugabyte_db_tpu_torch.storage.lsm import LsmStore
from yugabyte_db_tpu_torch.tablet import Tablet
from yugabyte_db_tpu_torch.utils import hybrid_time as pht
from tests.torch_parity import (WRITE_BASE_US, flags_set, kv_infos,
                                kv_row, kv_tablet_pair, store_files,
                                write_both)

KEYS = 60


def _schemas(pr, version):
    """kv_infos("hash")'s table at version 1; version 2 adds a nullable
    FLOAT64 `extra`, version 3 also an INT64 `more`."""
    C, T = pr.ColumnSchema, pr.ColumnType
    cols = (C(0, "k", T.INT64, is_hash_key=True), C(1, "v", T.FLOAT64),
            C(2, "s", T.STRING), C(3, "n", T.INT32))
    if version >= 2:
        cols += (C(5, "extra", T.FLOAT64),)
    if version >= 3:
        cols += (C(6, "more", T.INT64),)
    return pr.TableSchema(cols, version)


def _info_pair(version, history=False):
    hist = tuple(range(1, version)) if history else ()
    return (JInfo("t1", "kv", _schemas(jpr, version), JPS("hash", 1),
                  schema_history=tuple(_schemas(jpr, v) for v in hist)),
            TableInfo("t1", "kv", _schemas(ppr, version),
                      PartitionSchema("hash", 1),
                      schema_history=tuple(_schemas(ppr, v) for v in hist)))


def _advance(jphys, pphys, us):
    jphys.advance_micros(us)
    pphys.advance_micros(us)


def _seeded_writes(jt, pt, jphys, pphys, seed, steps, extra=None):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        _advance(jphys, pphys, int(rng.integers(1, 20)))
        k = int(rng.integers(0, KEYS))
        if rng.random() < 0.15:
            write_both(jt, pt, [("delete", {"k": k})])
            continue
        row = kv_row(rng, k)
        if extra is not None and rng.random() < 0.7:
            row.update(extra(rng))
        write_both(jt, pt, [("upsert", row)])


def _read_point(jphys):
    return (jphys.now_micros() << 12) + 1


def _same_reads(jt, pt, read_ht, table="t1"):
    keys = [{"k": k} for k in range(-2, KEYS + 2)]
    got = pt.multi_read(table, keys, read_ht=read_ht)
    assert got == jt.multi_read(table, keys, read_ht=read_ht)
    scan = pt.read(ReadRequest(table, read_ht=read_ht)).rows
    assert scan == jt.read(JReq(table, read_ht=read_ht)).rows
    return got


def _alter_both(jt, pt, version):
    jinfo, pinfo = _info_pair(version)
    jt.alter_table(jinfo)
    pt.alter_table(pinfo)


@pytest.mark.parametrize("state", ["memtable", "sst"])
def test_alter_table_reads_old_and_new_rows(tmp_path, state):
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
    _seeded_writes(jt, pt, jphys, pphys, 1, 120)
    if state == "sst":
        jt.flush(), pt.flush()
    old_point = _read_point(jphys)
    _alter_both(jt, pt, 2)
    assert pt.schema_version_of("t1") == 2
    assert pt.codec.info.packings.versions() == [1, 2]
    assert pt.regular.columnar_builder == pt.codec.columnar_builder
    _seeded_writes(jt, pt, jphys, pphys, 2, 120,
                   extra=lambda rng: {"extra": float(rng.integers(0, 9))})
    if state == "sst":
        jt.flush(), pt.flush()
    rows = _same_reads(jt, pt, _read_point(jphys))
    assert any(r is not None and r["extra"] is not None for r in rows)
    assert any(r is not None and r["extra"] is None for r in rows)
    old = _same_reads(jt, pt, old_point)
    assert all(r is None or r["extra"] is None for r in old)
    if state == "sst":
        assert store_files(pt.regular) == store_files(jt.regular)


@pytest.mark.parametrize("versions", [2, 3])
def test_compaction_repacks_to_the_latest_version(tmp_path, versions):
    """More than one schema version: Tablet.compact takes the repacking
    feed in both packages; the output SST is byte for byte the
    reference's and every packed row is at the latest version."""
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
    _seeded_writes(jt, pt, jphys, pphys, 3, 100)
    jt.flush(), pt.flush()
    for v in range(2, versions + 1):
        _alter_both(jt, pt, v)
        _seeded_writes(jt, pt, jphys, pphys, 3 + v, 60,
                       extra=lambda rng: {"extra": float(rng.integers(9))})
        jt.flush(), pt.flush()
    _advance(jphys, pphys, 10)
    jpath, ppath = jt.compact(), pt.compact()
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    assert store_files(pt.regular) == store_files(jt.regular)
    n = 0
    for _k, v in pt.regular.iterate():
        inner, _ = unwrap_ttl(v)
        if inner[0] == ValueKind.kPackedRowV2:
            assert pt.codec.info.packings.version_of(inner, 1) == versions
            n += 1
    assert n > 20
    _same_reads(jt, pt, _read_point(jphys))


def test_repacking_feed_keeps_ttl_envelopes(tmp_path):
    """A TTL'd row packed under the old version keeps its envelope when
    the feed repacks it."""
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
    write_both(jt, pt, [("upsert", {"k": i, "v": 1.5, "s": "ttl", "n": i})
                        for i in range(10)], ttl_ms=10_000_000)
    jt.flush(), pt.flush()
    _alter_both(jt, pt, 2)
    write_both(jt, pt, [("upsert", {"k": 3, "v": 2.5, "s": "new", "n": 0,
                                    "extra": 4.0})])
    jpath, ppath = jt.compact(), pt.compact()
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    # every version is inside the retention window: all ten TTL'd rows
    # survive, repacked to version 2 inside their envelopes
    ttl = [unwrap_ttl(v)[0] for _k, v in pt.regular.iterate()
           if unwrap_ttl(v)[1] is not None]
    assert len(ttl) == 10
    assert all(pt.codec.info.packings.version_of(v, 1) == 2 for v in ttl)
    _same_reads(jt, pt, _read_point(jphys))


def test_truncate_dedicated_tablet(tmp_path):
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
    _seeded_writes(jt, pt, jphys, pphys, 4, 80)
    jt.flush(), pt.flush()
    _seeded_writes(jt, pt, jphys, pphys, 5, 80)
    jt.flush(), pt.flush()
    _seeded_writes(jt, pt, jphys, pphys, 6, 20)       # memtable rows too
    assert jt.truncate_table("t1", op_id=(1, 77)) == \
        pt.truncate_table("t1", op_id=(1, 77)) == 2
    assert pt.regular.ssts == [] and pt.regular.memtable_empty()
    assert all(r is None for r in _same_reads(jt, pt, _read_point(jphys)))
    assert open(pt.regular._manifest_path, "rb").read() == \
        open(jt.regular._manifest_path, "rb").read()
    _advance(jphys, pphys, 5)
    write_both(jt, pt, [("upsert", {"k": 1, "v": 3.0, "s": "back",
                                    "n": 1})])
    assert pt.multi_read("t1", [{"k": 1}])[0]["s"] == "back"
    jt.flush(), pt.flush()
    assert store_files(pt.regular) == store_files(jt.regular)
    # the store reopens empty but for the fresh write
    again = LsmStore(pt.regular.dir, name="regular")
    assert len(again.ssts) == 1 and \
        again.flushed_frontier()["op_id"] == [1, 77]


def test_lsm_truncate_and_checkpoint_match_reference(tmp_path):
    """Store level: a checkpoint's files and manifest, and the state a
    truncate leaves, byte for byte the reference's."""
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path / "t"))
    _seeded_writes(jt, pt, jphys, pphys, 7, 100)
    jt.flush(), pt.flush()
    jt.regular.checkpoint(str(tmp_path / "jc"))
    pt.regular.checkpoint(str(tmp_path / "pc"))
    assert sorted(os.listdir(tmp_path / "pc")) == \
        sorted(os.listdir(tmp_path / "jc"))
    for f in os.listdir(tmp_path / "jc"):
        assert open(tmp_path / "pc" / f, "rb").read() == \
            open(tmp_path / "jc" / f, "rb").read(), f
    opened = LsmStore.open_checkpoint(str(tmp_path / "jc"), "regular")
    jopened = JStore.open_checkpoint(str(tmp_path / "pc"), "regular")
    assert list(opened.iterate()) == list(jopened.iterate()) == \
        list(pt.regular.iterate())
    assert pt.regular.truncate() == jt.regular.truncate() == 1
    assert open(pt.regular._manifest_path, "rb").read() == \
        open(jt.regular._manifest_path, "rb").read()


def _snapshot_pair(tmp_path, altered):
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path / "t"))
    _seeded_writes(jt, pt, jphys, pphys, 8, 100)
    jt.flush(), pt.flush()
    if altered:
        _alter_both(jt, pt, 2)
    _seeded_writes(jt, pt, jphys, pphys, 9, 60,
                   extra=(lambda rng: {"extra": 1.0}) if altered else None)
    return jt, pt, jphys, pphys


@pytest.mark.parametrize("altered", [False, True])
def test_snapshot_layout_matches_reference(tmp_path, altered):
    jt, pt, jphys, pphys = _snapshot_pair(tmp_path, altered)
    jop = jt.create_snapshot(str(tmp_path / "js"))
    pop = pt.create_snapshot(str(tmp_path / "ps"))
    assert jop == pop
    for sub in ("regular", "intents"):
        a, b = tmp_path / "js" / sub, tmp_path / "ps" / sub
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for f in os.listdir(a):
            assert open(a / f, "rb").read() == open(b / f, "rb").read()


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
@pytest.mark.parametrize("altered", [False, True])
def test_snapshot_restores_across_packages(tmp_path, direction, altered):
    """A snapshot one package writes restores into the other's tablet
    (the schema history keeps the old packing readable) and reads the
    same rows as the tablet it came from."""
    jt, pt, jphys, pphys = _snapshot_pair(tmp_path, altered)
    snap = str(tmp_path / "snap")
    version = 2 if altered else 1
    jinfo, pinfo = _info_pair(version, history=True)
    read_ht = _read_point(jphys)
    if direction == "reference_to_port":
        jt.create_snapshot(snap)
        src = jt
        restored = Tablet.restore_snapshot(
            "r", pinfo, snap, str(tmp_path / "r"), device="cpu")
    else:
        pt.create_snapshot(snap)
        src = pt
        restored = JTablet.restore_snapshot(
            "r", jinfo, snap, str(tmp_path / "r"))
    keys = [{"k": k} for k in range(KEYS)]
    assert restored.multi_read("t1", keys, read_ht=read_ht) == \
        src.multi_read("t1", keys, read_ht=read_ht)
    assert any(r is not None for r in
               restored.multi_read("t1", keys, read_ht=read_ht))


@pytest.mark.parametrize("at", ["early", "middle", "late"])
def test_trim_above_ht(tmp_path, at):
    """trim_above_ht on restored tablets: the same versions dropped, the
    same output file, and the rows as of the cut."""
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path / "t"))
    cuts = []
    for seed in (10, 11, 12):
        _seeded_writes(jt, pt, jphys, pphys, seed, 60)
        cuts.append(_read_point(jphys) - 1)
        _advance(jphys, pphys, 50)
    cut = cuts[{"early": 0, "middle": 1, "late": 2}[at]]
    jt.create_snapshot(str(tmp_path / "js"))
    pt.create_snapshot(str(tmp_path / "ps"))
    jinfo, pinfo = kv_infos("hash")
    jr = JTablet.restore_snapshot("r", jinfo, str(tmp_path / "js"),
                                  str(tmp_path / "jr"))
    pr = Tablet.restore_snapshot("r", pinfo, str(tmp_path / "ps"),
                                 str(tmp_path / "pr"), device="cpu")
    dropped = pr.trim_above_ht(cut)
    assert dropped == jr.trim_above_ht(cut)
    assert (dropped > 0) == (at != "late")
    assert store_files(pr.regular) == store_files(jr.regular)
    keys = [{"k": k} for k in range(KEYS)]
    top = _read_point(jphys) + (1 << 30)
    assert pr.multi_read("t1", keys, read_ht=top) == \
        pt.multi_read("t1", keys, read_ht=cut)


def test_restore_snapshot_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path / "t"))
    pt.create_snapshot(str(tmp_path / "s"))
    with pytest.raises(DeviceUnavailable):
        Tablet.restore_snapshot("r", kv_infos("hash")[1],
                                str(tmp_path / "s"), str(tmp_path / "r"))


def test_cpu_tablet_compacts_on_the_native_backend(tmp_path):
    """A CPU tablet with tpu_compaction_enabled compacts through the
    native backend (the chunked engine, the host k-way merge) and writes
    the reference's file; off, the baseline."""
    from yugabyte_db_tpu.docdb import compaction as jcomp
    from yugabyte_db_tpu_torch.docdb import compaction as pcomp
    from yugabyte_db_tpu_torch.models import ycsb
    from yugabyte_db_tpu.models import ycsb as jycsb
    jphys = jht.MockPhysicalClock(WRITE_BASE_US)
    pphys = pht.MockPhysicalClock(WRITE_BASE_US)
    jt = JTablet("u", jycsb.usertable_info(), str(tmp_path / "j"),
                 clock=jht.HybridClock(jphys))
    pt = Tablet("u", ycsb.usertable_info(), str(tmp_path / "p"),
                clock=pht.HybridClock(pphys), device="cpu")
    for i in range(3):
        _advance(jphys, pphys, 100)
        rows = {k: v[i * 40:i * 40 + 300] for k, v in
                ycsb.generate_rows(1000).items()}
        jt.bulk_load(rows)
        pt.bulk_load(rows)
    for enabled, backend in ((True, "native"), (False, "baseline")):
        with flags_set({"tpu_compaction_enabled": enabled},
                       {"tpu_compaction_enabled": enabled}):
            _advance(jphys, pphys, 100)
            jpath, ppath = jt.compact(), pt.compact()
        assert open(jpath, "rb").read() == open(ppath, "rb").read()
        if enabled:
            assert pcomp.LAST_COMPACTION_STATS["backend"] == backend
            assert jcomp.LAST_COMPACTION_STATS["backend"] == backend


def _repack_schemas(shape):
    """(old, new, the numpy pass takes it) for one ALTER shape."""
    C, T = ppr.ColumnSchema, ppr.ColumnType
    base = [C(0, "k", T.INT64, is_hash_key=True), C(1, "i", T.INT32),
            C(2, "s", T.STRING), C(3, "d", T.FLOAT64), C(4, "y", T.BINARY),
            C(5, "b", T.BOOL), C(6, "t", T.TIMESTAMP)]
    old, new, bulk = list(base), list(base), True
    if shape == "add_fixed":
        new += [C(9, "extra", T.INT64)]
    elif shape == "add_varlen":
        new += [C(9, "extra", T.STRING)]
    elif shape == "add_both":
        new += [C(9, "e1", T.STRING), C(10, "e2", T.FLOAT64),
                C(11, "e3", T.BINARY)]
    elif shape == "drop_fixed":
        new = [c for c in base if c.id != 3]
    elif shape == "type_change":
        new = [c if c.id != 1 else C(1, "i", T.INT64) for c in base]
        bulk = False
    elif shape == "float32":
        old += [C(8, "f", T.FLOAT32)]
        new = old + [C(9, "extra", T.INT32)]
        bulk = False
    elif shape == "drop_varlen":
        new = [c for c in base if c.id != 2]
        bulk = False
    elif shape == "reorder_varlen":
        new = [c for c in base if c.id != 2] + [C(2, "s", T.STRING)]
        bulk = False
    return (ppr.TableSchema(tuple(old), 1), ppr.TableSchema(tuple(new), 2),
            bulk)


@pytest.mark.parametrize("shape", ["add_fixed", "add_varlen", "add_both",
                                   "drop_fixed", "type_change", "float32",
                                   "drop_varlen", "reorder_varlen"])
def test_bulk_repack_matches_the_per_row_route(shape):
    """dockv/packed_row.py repack_values against the per-row repack
    (unpack under the old packing, pack under the new) of the port and
    of the reference, on seeded rows with NULLs, odd BOOL bytes and
    empty strings; the shapes it refuses return None."""
    from yugabyte_db_tpu.dockv.packed_row import unpack_row as junpack
    old_s, new_s, bulk = _repack_schemas(shape)
    old = ppr.SchemaPacking.from_schema(old_s)
    new = ppr.SchemaPacking.from_schema(new_s)
    jold, jnew = (jpr.SchemaPacking.from_schema(jpr.TableSchema(tuple(
        jpr.ColumnSchema(c.id, c.name, c.type, is_hash_key=c.is_hash_key)
        for c in sch.columns), sch.version)) for sch in (old_s, new_s))
    rng = np.random.default_rng(5)
    gen = {ppr.ColumnType.INT32: lambda: int(rng.integers(-2**31, 2**31)),
           ppr.ColumnType.INT64: lambda: int(rng.integers(-2**62, 2**62)),
           ppr.ColumnType.TIMESTAMP: lambda: int(rng.integers(0, 2**50)),
           ppr.ColumnType.FLOAT64: lambda: float(rng.normal()),
           ppr.ColumnType.FLOAT32: lambda: float(np.float32(rng.normal())),
           ppr.ColumnType.BOOL: lambda: bool(rng.integers(0, 2)),
           ppr.ColumnType.STRING: lambda: "s" * int(rng.integers(0, 9)),
           ppr.ColumnType.BINARY: lambda: bytes(rng.integers(
               0, 256, int(rng.integers(0, 6)), dtype=np.uint8))}
    values = []
    for _ in range(300):
        row = {c.id: (None if rng.random() < 0.25 else gen[c.type]())
               for c in old.all_columns}
        v = ppr.RowPacker(old).pack_value(row)
        if rng.random() < 0.1 and row.get(5):
            # a BOOL byte other than 1 (the per-row route writes 1)
            at = 1 + 1 + old.bitmap_size + old.fixed_offsets[5]
            v = v[:at] + b"\x07" + v[at + 1:]
        values.append(v)
    packer = ppr.RowPacker(new)
    want = [packer.pack_value(ppr.unpack_row(old, v, 1)) for v in values]
    jpacker = jpr.RowPacker(jnew)
    assert want == [jpacker.pack_value(junpack(jold, v, 1)) for v in values]
    got = ppr.repack_values(old, new, values)
    assert got == (want if bulk else None)
