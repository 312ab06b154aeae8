"""The port's host hot-path extension (yugabyte_db_tpu_torch/csrc/host_hot.c
through docdb/hotpath.py) against its Python versions and the reference's
extension (native/ybtpu_hot.c), in one process: doc-key encoding (a
seeded fuzz over every key kind, NULL range parts), FNV-64 and the bloom
probe, the row Extractor, the BlockFinder's MVCC walk, and the Packer's
bytes and error classes.  Integers and strings exactly, floats bit for
bit.  Tolerance: none."""
import math
import random
import struct

import numpy as np
import pytest

from yugabyte_db_tpu.docdb import hotpath as jhot
from yugabyte_db_tpu.docdb.table_codec import TableCodec as JCodec
from yugabyte_db_tpu.docdb.table_codec import TableInfo as JInfo
from yugabyte_db_tpu.dockv import packed_row as jpr
from yugabyte_db_tpu.dockv.partition import PartitionSchema as JPS
from yugabyte_db_tpu.storage import columnar as jcol
from yugabyte_db_tpu.storage import sst as jsst
from yugabyte_db_tpu_torch.docdb import hotpath
from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec, TableInfo
from yugabyte_db_tpu_torch.dockv import packed_row as ppr
from yugabyte_db_tpu_torch.dockv.partition import PartitionSchema
from yugabyte_db_tpu_torch.storage import columnar as pcol
from yugabyte_db_tpu_torch.storage import native_lib
from yugabyte_db_tpu_torch.storage import sst as psst
from tests.torch_parity import kv_row, kv_tablet_pair, write_both

T = ppr.ColumnType

SHAPES = {
    "int64": ([("k", T.INT64, False)], "hash", 1),
    "int32": ([("k", T.INT32, False)], "hash", 1),
    "int64_string": ([("a", T.INT64, False), ("b", T.STRING, False)],
                     "hash", 1),
    "string_int64_desc": ([("a", T.STRING, False), ("b", T.INT64, True)],
                          "hash", 1),
    "float64": ([("a", T.FLOAT64, False)], "hash", 1),
    "range_int64_string": ([("a", T.INT64, False), ("b", T.STRING, False)],
                           "range", 0),
    "timestamp": ([("a", T.TIMESTAMP, False)], "hash", 1),
    "int64_binary_desc": ([("a", T.INT64, False), ("b", T.BINARY, True)],
                          "hash", 1),
}


def _infos(cols, kind, nh, cotable=None):
    def schema(pr):
        return pr.TableSchema(tuple(
            pr.ColumnSchema(i, n, t,
                            is_hash_key=(kind == "hash" and i < nh),
                            is_range_key=not (kind == "hash" and i < nh),
                            sort_desc=desc)
            for i, (n, t, desc) in enumerate(cols)), 1)
    return (JInfo("t", "t", schema(jpr), JPS(kind, nh), cotable_id=cotable),
            TableInfo("t", "t", schema(ppr), PartitionSchema(kind, nh),
                      cotable_id=cotable))


def _mkval(t, rng):
    if t == T.INT64:
        return rng.choice([0, -1, 1, -2**62, 2**62, -2**63, 2**63 - 1,
                           rng.randint(-10**12, 10**12)])
    if t == T.INT32:
        return rng.randint(-2**31, 2**31 - 1)
    if t == T.FLOAT64:
        return rng.choice([0.0, -0.0, -1.5, 3.14, -1e300, 1e-300,
                           math.inf, rng.random()])
    if t == T.TIMESTAMP:
        return rng.randint(0, 2**48)
    if t == T.STRING:
        return rng.choice(["", "abc", "a\x00b", "héllo", "x" * 300,
                           chr(1) + chr(0)])
    if t == T.BINARY:
        return rng.choice([b"", b"\x00", b"\xff\x00\x01", bytes(range(40))])
    raise AssertionError(t)


def test_loader_builds_from_the_port_sources():
    """The loader reads only the port's csrc/ and builds into build/;
    the module is `host_hot`, apart from the reference's `ybtpu_hot`."""
    port = hotpath._SRC.resolve().parents[1]
    assert hotpath._SRC.parent == port / "csrc"
    assert hotpath._SRC.name == "host_hot.c"
    assert port.name == "yugabyte_db_tpu_torch"
    path = hotpath.library_path()
    assert path.parent == port.parent / "build" / "host_hot"
    mod = hotpath.load()
    assert mod is hotpath.load() is pcol.native_hot()
    assert mod.__name__ == "host_hot" and mod.__file__ == str(path)
    ref = jhot.load()
    assert ref.__name__ == "ybtpu_hot"
    for name in ("Extractor", "BlockFinder", "Packer", "PointReader"):
        assert getattr(mod, name) is not getattr(ref, name)
        assert getattr(mod, name).__name__ == getattr(ref, name).__name__
    assert not hasattr(hotpath, "available")      # no "missing" route


def test_each_extension_takes_only_its_own_objects():
    """A port PointReader refuses the reference's BlockFinder and
    Extractor (and the other way round): the types never mix."""
    mod, ref = hotpath.load(), jhot.load()
    keys = np.zeros((1, 14), np.uint8)
    args = (keys, np.zeros(1, np.uint64), np.zeros(1, np.uint32),
            np.zeros(1, np.uint8), 1, 14)
    for mine, other in ((mod, ref), (ref, mod)):
        foreign = other.BlockFinder(*args)
        with pytest.raises(TypeError):
            mine.PointReader((b"",), (b"",), (foreign,), (None,), None, 0)
        own = mine.BlockFinder(*args)
        mine.PointReader((b"",), (b"",), (own,), (None,), None, 0)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A build that fails raises NativeBuildError; nothing falls back."""
    monkeypatch.setattr(hotpath, "_SRC", tmp_path / "host_hot.c")
    (tmp_path / "host_hot.c").write_text("this is not C\n")
    monkeypatch.setattr(hotpath, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(hotpath, "_MOD", None)
    with pytest.raises(native_lib.NativeBuildError, match="g\\+\\+ failed"):
        hotpath.load()


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("cotable", [None, 7])
def test_encode_doc_key_fuzz(shape, cotable):
    cols, kind, nh = SHAPES[shape]
    jinfo, pinfo = _infos(cols, kind, nh, cotable)
    jc, pc = JCodec(jinfo), TableCodec(pinfo)
    assert pc._key_spec == jc._key_spec is not None
    rng = random.Random(7)
    for i in range(200):
        row = {n: _mkval(t, rng) for n, t, _ in cols}
        if i % 5 == 0:                  # NULL range components
            for j, (n, _t, _d) in enumerate(cols):
                if j >= nh:
                    row[n] = None
        want = jc.doc_key_prefix(row)
        assert pc.doc_key_prefix(row) == want, row
        assert pc.doc_key_prefix_plain(row) == want, row
        if cotable is not None:
            assert want.startswith(pc.scan_prefix())


def test_null_hash_component_raises_in_both():
    jinfo, pinfo = _infos(*SHAPES["int64_string"])
    jc, pc = JCodec(jinfo), TableCodec(pinfo)
    k_null = pc.doc_key_prefix({"a": 5, "b": None})
    assert k_null == jc.doc_key_prefix({"a": 5, "b": None})
    assert k_null != pc.doc_key_prefix({"a": 5, "b": "x"})
    for codec in (jc, pc):
        with pytest.raises(Exception):
            codec.doc_key_prefix({"a": None, "b": "x"})


def test_pk_shape_without_key_spec_takes_python():
    """A FLOAT32 key column has no encoder kind: both packages take the
    Python encoder, which has no key type for it either, and both raise
    the same error."""
    cols = [("k", T.INT64, False), ("f", T.FLOAT32, False)]
    jinfo, pinfo = _infos(cols, "hash", 1)
    jc, pc = JCodec(jinfo), TableCodec(pinfo)
    assert pc._key_spec is None and jc._key_spec is None
    with pytest.raises(Exception) as want:
        jc.doc_key_prefix({"k": 3, "f": 1.5})
    with pytest.raises(Exception) as got:
        pc.doc_key_prefix({"k": 3, "f": 1.5})
    assert type(got.value) is type(want.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fnv64_and_bloom_probe_match(seed):
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, 256, int(rng.integers(0, 40)),
                         dtype=np.uint8).tobytes() for _ in range(300)]
    for k in keys:
        h = pcol.fnv64_bytes(k)
        assert h == pcol.fnv64_bytes_plain(k) == jcol.fnv64_bytes(k)
    hashes = np.asarray([pcol.fnv64_bytes(k) for k in keys[:150]],
                        np.uint64)
    pb = psst.BloomFilter.build(hashes)
    jb = jsst.BloomFilter.build(hashes)
    assert np.array_equal(pb.bits, jb.bits) and pb.k == jb.k
    for k in keys:
        h = pcol.fnv64_bytes(k)
        got = pb.may_contain(h)
        assert got == pb.may_contain_plain(h) == jb.may_contain(h)
    assert all(pb.may_contain(int(h)) for h in hashes)


def _kv_blocks(tmp_path, kind):
    """Paired tablets after seeded writes (versions, deletes, NULLs),
    flushed: the first SST's columnar blocks of each package."""
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path), kind)
    rng = np.random.default_rng(4)
    for step in range(120):
        jphys.advance_micros(7)
        pphys.advance_micros(7)
        k = int(rng.integers(0, 40))
        if rng.random() < 0.2:
            pk = {"k": k} if kind == "hash" else \
                {"k": k, "r": int(rng.integers(-3, 4))}
            write_both(jt, pt, [("delete", pk)])
        else:
            write_both(jt, pt, [("upsert", kv_row(rng, k, kind))])
    jt.flush()
    pt.flush()
    (jr,), (pr,) = jt.regular.ssts, pt.regular.ssts
    jbs = [jr.columnar_block(i) for i in range(jr.num_blocks())]
    pbs = [pr.columnar_block(i) for i in range(pr.num_blocks())]
    return jt, pt, jbs, pbs


def _bits(row):
    """A row with floats as their IEEE bytes: equal means bit for bit."""
    if row is None:
        return None
    return {k: (struct.pack("<d", v) if isinstance(v, float) else v)
            for k, v in row.items()}


@pytest.mark.parametrize("kind", ["hash", "range"])
def test_extractor_rows_match(tmp_path, kind):
    jt, pt, jbs, pbs = _kv_blocks(tmp_path, kind)
    n = 0
    for jb, pb in zip(jbs, pbs):
        assert pt.codec._native_extractor(pb) is not None
        assert pt.codec._native_extractor(pb) is \
            pt.codec._native_extractor(pb)          # cached per codec
        for pos in range(pb.n):
            key = pb.keys[pos].tobytes()
            got = pt.codec.decode_block_row(pb, pos, key)
            want = jt.codec.decode_block_row(jb, pos, key)
            plain = pt.codec.decode_block_row_plain(pb, pos, key)
            assert _bits(got) == _bits(want) == _bits(plain), pos
            if got is not None:
                assert list(got) == list(plain)     # column order too
                n += 1
            # the port's optional column subset stays on the Python route
            sub = pt.codec.decode_block_row(pb, pos, key, want=("s",))
            assert sub == (None if plain is None else
                           {c: plain[c] for c in plain if c in
                            {x.name for x in pt.codec._pk_cols} | {"s"}})
    assert n > 20


def test_extractor_takes_bulk_blocks_and_bool_lanes():
    """Bulk-loaded lineitem blocks: the Extractor's rows against the
    reference's; a BOOL lane stored as uint8 has no extractor code, so
    that block decodes in Python (None), as the reference's does."""
    from tests.torch_parity import jax_blocks, lineitem_data, port_blocks
    from yugabyte_db_tpu.models import tpch as jtpch
    from yugabyte_db_tpu_torch.models import tpch
    data = lineitem_data(3000, seed=2)
    jb, pb = jax_blocks(data)[0], port_blocks(data)[0]
    jc, pc = JCodec(jtpch.lineitem_info()), TableCodec(tpch.lineitem_info())
    assert pc._native_extractor(pb) is not None
    for pos in range(0, pb.n, 37):
        key = pb.keys[pos].tobytes()
        assert _bits(pc.decode_block_row(pb, pos, key)) == \
            _bits(jc.decode_block_row(jb, pos, key)) == \
            _bits(pc.decode_block_row_plain(pb, pos, key))
    cols = [("k", T.INT64, False)]
    jinfo, pinfo = _infos(cols, "hash", 1)
    for info in (jinfo, pinfo):
        pr = jpr if info is jinfo else ppr
        info.schema = pr.TableSchema(info.schema.columns + (
            pr.ColumnSchema(1, "b", pr.ColumnType.BOOL),), 1)
    blk = pcol.ColumnarBlock.from_arrays(
        schema_version=1, key_hash=np.zeros(2, np.uint64),
        ht=np.ones(2, np.uint64), write_id=np.zeros(2, np.uint32),
        pk={0: np.array([1, 2], np.int64)},
        fixed={1: (np.array([1, 0], np.uint8), np.zeros(2, bool))},
        varlen={}, keys=np.zeros((2, 14), np.uint8))
    pcodec = TableCodec(pinfo)
    assert pcodec._native_extractor(blk) is None
    assert pcodec.decode_block_row(blk, 0, b"") == {"k": 1, "b": True}


@pytest.mark.parametrize("kind", ["hash", "range"])
def test_block_finder_matches_python_walk(tmp_path, kind):
    """BlockFinder.find against the reference's BlockFinder and the
    port's Python walk: versions, deletes, read points below, between
    and above the writes, and the restart window."""
    jt, pt, jbs, pbs = _kv_blocks(tmp_path, kind)
    (pr,), (jr,) = pt.regular.ssts, jt.regular.ssts
    hts = np.unique(np.concatenate([b.ht for b in pbs]))
    points = [int(hts[0]) - 1, int(hts[len(hts) // 3]),
              int(hts[2 * len(hts) // 3]), int(hts[-1])]
    prefixes = sorted({b.keys[i, :-13].tobytes()
                       for b in pbs for i in range(b.n)})
    for jb, pb in zip(jbs, pbs):
        pf, jf = psst._native_finder(pb), jsst._native_finder(jb)
        assert pf is psst._native_finder(pb)
        for p in prefixes:
            for rh in (-1, int(hts[-1])):
                for read_ht in points:
                    assert pf.find(p, read_ht, rh) == jf.find(p, read_ht, rh)
    for p in prefixes:
        for read_ht in points:
            for rh in (None, int(hts[-1])):
                got = pr.point_find(p, read_ht, rh)
                want = jr.point_find(p, read_ht, rh)
                assert (got is None) == (want is None)
                if got is not None:
                    assert got[:4] == want[:4]


PACK_ROWS = [
    {1: True, 2: -5, 3: 2.5, 4: 1.5, 5: 123456789, 6: "héllo",
     7: b"\x00\xff"},
    {1: None, 2: None, 3: None, 4: None, 5: None, 6: None, 7: None},
    {1: False, 2: 2**31 - 1, 3: -0.0, 4: 0.0, 5: -1, 6: "", 7: b""},
    {2: 7, 6: "only-some"},
    {6: "x", 7: memoryview(b"view-backed")},
    {3: math.inf, 4: -math.inf, 5: -2**63},
]


def _pack_schema(pr, version=3):
    C, TT = pr.ColumnSchema, pr.ColumnType
    return pr.TableSchema(columns=(
        C(0, "k", TT.INT64, is_hash_key=True), C(1, "b", TT.BOOL),
        C(2, "i", TT.INT32), C(3, "d", TT.FLOAT64), C(4, "f", TT.FLOAT32),
        C(5, "ts", TT.TIMESTAMP), C(6, "s", TT.STRING),
        C(7, "y", TT.BINARY)), version=version)


@pytest.mark.parametrize("row", range(len(PACK_ROWS)))
def test_packer_bytes_match(row):
    values = PACK_ROWS[row]
    pp = ppr.RowPacker(ppr.SchemaPacking.from_schema(_pack_schema(ppr)))
    jp = jpr.RowPacker(jpr.SchemaPacking.from_schema(_pack_schema(jpr)))
    assert pp._native_packer() is not None
    got = pp.pack(values)
    assert got == pp.pack_plain(values) == jp.pack(values)
    assert pp.pack_value(values) == jp.pack_value(values)


@pytest.mark.parametrize("bad", ["str_for_int", "int32_overflow",
                                 "float32_overflow", "int_for_str"])
def test_packer_errors_match_reference(bad):
    """Invalid values fail in C with the reference's C error class, and
    in the Python version with its own."""
    values = {"str_for_int": {2: "not-an-int"},
              "int32_overflow": {2: 2**40},
              "float32_overflow": {4: 1e300},
              "int_for_str": {6: 5}}[bad]
    pp = ppr.RowPacker(ppr.SchemaPacking.from_schema(_pack_schema(ppr)))
    jp = jpr.RowPacker(jpr.SchemaPacking.from_schema(_pack_schema(jpr)))
    with pytest.raises(Exception) as want:
        jp.pack(values)
    with pytest.raises(Exception) as got:
        pp.pack(values)
    assert type(got.value) is type(want.value)
    jp._native = None
    assert _outcome(pp.pack_plain, values) == _outcome(jp.pack, values)


def _outcome(fn, values):
    """("ok", bytes) or ("error", its class): the Python packers accept
    some values the C packers refuse (bytes(5) of an int for a string)."""
    try:
        return ("ok", fn(values))
    except Exception as e:  # noqa: BLE001 — the class is what is compared
        return ("error", type(e))


@pytest.mark.parametrize("kind", ["json", "decimal", "vector", "wide"])
def test_exotic_schemas_keep_the_python_packer(kind):
    """JSON / DECIMAL / VECTOR columns and a bitmap over 64 bytes (more
    than 512 columns) pack in Python, byte for byte the reference's."""
    def schema(pr):
        C, TT = pr.ColumnSchema, pr.ColumnType
        key = (C(0, "k", TT.INT64, is_hash_key=True),)
        if kind == "wide":
            return pr.TableSchema(key + tuple(
                C(i, f"c{i}", TT.INT32) for i in range(1, 530)), 1)
        t = {"json": TT.JSON, "decimal": TT.DECIMAL,
             "vector": TT.VECTOR}[kind]
        return pr.TableSchema(key + (C(1, "x", t), C(2, "n", TT.INT64)), 1)
    pp = ppr.RowPacker(ppr.SchemaPacking.from_schema(schema(ppr)))
    jp = jpr.RowPacker(jpr.SchemaPacking.from_schema(schema(jpr)))
    assert pp._native_packer() is None
    if kind == "wide":
        values = {i: i * 3 if i % 4 else None for i in range(1, 530)}
    else:
        x = {"json": '{"a": 1}', "decimal": "12.50",
             "vector": np.arange(4, dtype=np.float32).tobytes()}[kind]
        values = {1: x, 2: 9}
    assert pp.pack(values) == jp.pack(values)
