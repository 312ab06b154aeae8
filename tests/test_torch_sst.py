"""The columnar SST tier of the port against the JAX reference on the CPU:
the header codec against msgpack, lane encodings, block serialization
(bulk and string-keyed lineitem, tombstones and NULLs: v2 written by
both packages, v1 written by the reference and read by both), SST files
from the streamed and buffered writers, each package reading the other's
bytes, row KV blocks with their columnar sidecars (written, iterated,
sought and point-read alike), the host library against its numpy twins,
the LSM store's manifest, and the typed refusals of what is not
ported."""
import os
import random
import struct

import msgpack
import numpy as np
import pytest

from yugabyte_db_tpu.docdb.table_codec import TableCodec as JCodec
from yugabyte_db_tpu.models import tpch as jtpch
from yugabyte_db_tpu.storage import columnar as jcol
from yugabyte_db_tpu.storage import lane_codec as jlane
from yugabyte_db_tpu.storage import sst as jsst
from yugabyte_db_tpu.storage.lsm import LsmStore as JStore
from yugabyte_db_tpu.utils.hybrid_time import HybridTime as JHT
from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec
from yugabyte_db_tpu_torch.models import tpch
from yugabyte_db_tpu_torch.storage import columnar as pcol
from yugabyte_db_tpu_torch.storage import lane_codec as plane
from yugabyte_db_tpu_torch.storage import native_lib
from yugabyte_db_tpu_torch.storage import sst as psst
from yugabyte_db_tpu_torch.storage import wire_pack
from yugabyte_db_tpu_torch.storage.lsm import LsmStore
from yugabyte_db_tpu_torch.utils.hybrid_time import DocHybridTime, HybridTime
from tests.torch_parity import flags_set, tombstoned_block

HT = 1_700_000_000_000_000 << 12


def _blocks(table: str, block_rows: int = 1000, tomb: bool = False):
    """(reference blocks, port blocks) of the same seeded rows: bulk
    lineitem or the string-keyed lineitem; with `tomb`, every block
    deleted (NULL value columns), and a NULL-bearing varlen lane."""
    data = tpch.generate_lineitem(0.0005, seed=3)
    if table == "lineitem_str":
        data = tpch.lineitem_str_data(data)
        jinfo, pinfo = jtpch.lineitem_str_info(), tpch.lineitem_str_info()
    else:
        jinfo, pinfo = jtpch.lineitem_info(), tpch.lineitem_info()
    jb = JCodec(jinfo).bulk_blocks(data, JHT(HT), block_rows=block_rows)
    pb = TableCodec(pinfo).bulk_blocks(data, HybridTime(HT),
                                       block_rows=block_rows)
    if tomb:
        jb = [tombstoned_block(b, jcol.ColumnarBlock) for b in jb]
        pb = [tombstoned_block(b, pcol.ColumnarBlock) for b in pb]
    return jb, pb, JCodec(jinfo), TableCodec(pinfo)


def _bytes(parts):
    head, bufs = parts
    return head + b"".join(b if isinstance(b, bytes)
                           else memoryview(b).cast("B").tobytes()
                           for b in bufs)


def _assert_same_block(a, b):
    assert a.n == b.n and a.schema_version == b.schema_version
    assert a.unique_keys == b.unique_keys
    for lane in ("key_hash", "ht", "write_id", "tombstone", "keys"):
        x, y = getattr(a, lane), getattr(b, lane)
        assert x.dtype == y.dtype and np.array_equal(x, y), lane
    assert a.pk.keys() == b.pk.keys() and a.fixed.keys() == b.fixed.keys()
    for c in a.pk:
        assert np.array_equal(a.pk[c], b.pk[c])
    for c in a.fixed:
        for x, y in zip(a.fixed[c], b.fixed[c]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert a.varlen.keys() == b.varlen.keys()
    for c in a.varlen:
        (ea, ha, na), (eb, hb, nb) = a.varlen[c], b.varlen[c]
        assert np.array_equal(ea, eb) and bytes(ha) == bytes(hb)
        assert np.array_equal(na, nb)
    assert a.zmap == b.zmap
    assert a.keys_proven == b.keys_proven


# --- the header codec ----------------------------------------------------------
def _rand_obj(rng: random.Random, depth: int = 0):
    t = rng.randrange(9 if depth < 3 else 6)
    if t == 0:
        return rng.choice([0, 1, 127, 128, 255, 256, 65535, 65536,
                           2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128,
                           -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
                           rng.randrange(-2**63, 2**64)])
    if t == 1:
        return rng.random() * 10.0 ** rng.randrange(-5, 20)
    if t == 2:
        return rng.choice([True, False, None, float("inf"), -0.0])
    if t == 3:
        return "".join(chr(rng.randrange(32, 0x3000)) for _ in range(
            rng.choice([0, 5, 31, 32, 255, 256, 70000])))
    if t == 4:
        return bytes(rng.randrange(256) for _ in range(
            rng.choice([0, 1, 255, 256, 65536])))
    if t == 5:
        return rng.choice([2**63, -2**63, 0.5, "k0"])
    if t == 6:
        return [_rand_obj(rng, depth + 1)
                for _ in range(rng.choice([0, 3, 15, 16, 17]))]
    if t == 7:
        return {f"{i}k": _rand_obj(rng, depth + 1)
                for i in range(rng.choice([0, 3, 15, 16, 17]))}
    return tuple(_rand_obj(rng, depth + 1) for _ in range(3))


@pytest.mark.parametrize("seed", range(4))
def test_wire_pack_matches_msgpack_on_seeded_values(seed):
    rng = random.Random(seed)
    for _ in range(60):
        obj = _rand_obj(rng)
        raw = wire_pack.packb(obj)
        assert raw == msgpack.packb(obj)
        assert repr(wire_pack.unpackb(raw)) == repr(
            msgpack.unpackb(raw, strict_map_key=False))


def test_wire_pack_refuses_what_msgpack_refuses():
    for bad in (np.int64(3), {1, 2}, 1 << 64, -(1 << 63) - 1):
        with pytest.raises((TypeError, OverflowError)):
            wire_pack.packb(bad)
        with pytest.raises((TypeError, OverflowError)):
            msgpack.packb(bad)
    with pytest.raises(ValueError):
        wire_pack.unpackb(b"\x92\x01")          # truncated array
    with pytest.raises(ValueError):
        wire_pack.unpackb(b"\x01\x02")          # trailing bytes
    with pytest.raises(ValueError):
        wire_pack.unpackb(b"\xc7\x01\x00\x00")  # ext types


@pytest.mark.parametrize("table", ["lineitem", "lineitem_str"])
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("tomb", [False, True])
def test_block_headers_match_msgpack(table, version, tomb):
    """Every block header the reference writes (v1, v2 with lane
    encodings, zone maps with float and int bounds, dict-coded varlen
    lanes, boundary keys) is msgpack's bytes, and unpacks alike."""
    jb, pb, jc, pc = _blocks(table, tomb=tomb)
    for j in jb:
        head, _ = j.serialize_parts(version, jc.derive_keys)
        (hlen,) = struct.unpack_from("<I", head)
        meta = msgpack.unpackb(head[4:4 + hlen], strict_map_key=False)
        assert wire_pack.packb(meta) == head[4:]
        assert wire_pack.unpackb(head[4:]) == meta
    if version == 2 and not tomb:
        assert isinstance(meta["zmap"]["1"][0], float)     # l_quantity
        assert isinstance(meta["zmap"]["0"][0], int)       # rowid


# --- lane encodings ----------------------------------------------------------------
def _lanes():
    rng = np.random.default_rng(1)
    n = 5000
    return {
        "const_u64": np.full(n, 7, np.uint64),
        "dconst_u32": np.arange(n, dtype=np.uint32) * 3,
        "delta_i64": np.cumsum(rng.integers(-100, 100, n)).astype(np.int64),
        "rle_bool": np.repeat(rng.random(50) < 0.5, 100),
        "dict_f64": rng.integers(0, 11, n).astype(np.float64) / 100,
        "raw_f64": rng.uniform(0, 1e6, n),
        "nan_f64": np.where(rng.random(n) < 0.1, np.nan, -0.0),
        "wrap_u64": np.array([2**64 - 1, 0, 5, 2**63] * (n // 4), np.uint64),
        "keys_2d": rng.integers(0, 256, (n, 27)).astype(np.uint8),
        "short": np.array([3], np.int32),
        "empty": np.zeros(0, np.float32),
    }


@pytest.mark.parametrize("name", sorted(_lanes()))
def test_encode_lane_matches_reference(name):
    arr = _lanes()[name]
    pm, pbufs, penc = plane.encode_lane(arr)
    jm, jbufs, jenc = jlane.encode_lane(arr)
    assert (pm, penc) == (jm, jenc)
    assert [b.tobytes() for b in pbufs] == [b.tobytes() for b in jbufs]
    blob = b"".join(b.tobytes() for b in pbufs)
    pos = 0

    def fetch(k):
        nonlocal pos
        pos += k
        return blob[pos - k:pos]
    out = plane.decode_lane(pm, fetch)
    assert out.dtype == arr.dtype and out.tobytes() == arr.tobytes()
    stats = {}
    plane.tally(stats, name, arr.nbytes, len(blob), penc)
    plane.tally(stats, name, arr.nbytes, len(blob), penc)
    assert stats["lanes"][name]["encodings"] == {penc: 2}


# --- block serialization -----------------------------------------------------------
@pytest.mark.parametrize("table", ["lineitem", "lineitem_str"])
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("tomb", [False, True])
def test_serialize_parts_byte_identical_and_cross_readable(table, version,
                                                           tomb):
    """v1 and v2: both packages write the same bytes and read each
    other's."""
    jb, pb, jc, pc = _blocks(table, tomb=tomb)
    for j, p in zip(jb, pb):
        for builder in ((jc.derive_keys, pc.derive_keys), (None, None)):
            jstats, pstats = {}, {}
            jraw = _bytes(j.serialize_parts(version, builder[0], jstats))
            praw = _bytes(p.serialize_parts(version, builder[1], pstats))
            assert jraw == praw
            assert jstats == pstats
            # each package reads the other's bytes
            for raw, copy in ((jraw, True), (memoryview(praw), False)):
                back_p = pcol.ColumnarBlock.deserialize(raw, copy=copy)
                back_j = jcol.ColumnarBlock.deserialize(raw, copy=copy)
                back_p.bind_key_builder(pc.derive_keys)
                back_j.bind_key_builder(jc.derive_keys)
                _assert_same_block(back_p, back_j)
                assert np.array_equal(back_p.keys, p.keys)
    assert p.serialize() == j.serialize(2)
    assert p.serialize(1) == j.serialize(1)


def test_zone_maps_and_boundary_keys_without_materializing():
    _, pb, _, pc = _blocks("lineitem")
    raw = _bytes(pb[0].serialize_parts(2, pc.derive_keys))
    back = pcol.ColumnarBlock.deserialize(raw)
    assert back.keys_proven and not back.keys_derivable
    back.bind_key_builder(pc.derive_keys)
    assert back.keys_derivable
    before = dict(pcol.KEY_REBUILD_STATS)
    assert back.boundary_keys(materialize=False) == (
        pb[0].keys[0].tobytes(), pb[0].keys[-1].tobytes())
    assert back.first_full_key() == pb[0].keys[0].tobytes()
    assert pcol.KEY_REBUILD_STATS == before          # no rebuild yet
    assert back.zmap[tpch.SHIPDATE] == (int(pb[0].fixed[tpch.SHIPDATE][0]
                                            .min()),
                                        int(pb[0].fixed[tpch.SHIPDATE][0]
                                            .max()))
    assert np.array_equal(back.keys, pb[0].keys)
    assert pcol.KEY_REBUILD_STATS["rebuilds"] == before["rebuilds"] + 1


def test_dict_coded_varlen_lane_serves_dict_varlen():
    jb, pb, jc, pc = _blocks("lineitem_str")
    raw = _bytes(pb[0].serialize_parts(2, pc.derive_keys))
    pback = pcol.ColumnarBlock.deserialize(raw)
    jback = jcol.ColumnarBlock.deserialize(raw)
    assert pback._vdicts and set(pback._vdicts) == set(jback._vdicts)
    for c in pback._vdicts:
        pu, pcodes = pback.dict_varlen(c)
        ju, jcodes = jback.dict_varlen(c)
        assert list(pu) == list(ju) and np.array_equal(pcodes, jcodes)


def test_searchsorted_key_and_fnv_match_reference():
    jb, pb, _, _ = _blocks("lineitem")
    j, p = jb[0], pb[0]
    for row in (0, 17, p.n - 1):
        key = p.keys[row].tobytes()
        for probe in (key, key[:5], key + b"\x00\x01", b"\xff" * 30):
            assert p.searchsorted_key(probe) == j.searchsorted_key(probe)
    keys = [p.keys[i].tobytes()[:w] for i, w in enumerate(
        [1, 5, 14, 27, 3, 0, 9])]
    assert np.array_equal(pcol.fnv64_keys(keys), jcol.fnv64_keys(keys))
    assert [pcol.fnv64_bytes(k) for k in keys] == \
        [jcol.fnv64_bytes(k) for k in keys]
    assert len(pcol.fnv64_keys([])) == 0


def test_derive_keys_matches_bulk_keys_and_reference():
    for table in ("lineitem", "lineitem_str"):
        jb, pb, jc, pc = _blocks(table)
        for j, p in zip(jb, pb):
            assert p.keys_proven == j.keys_proven
            assert np.array_equal(pc.derive_keys(p), p.keys)
            assert np.array_equal(pc.derive_keys(p), jc.derive_keys(j))
    p = pb[0]
    p.pk.clear()
    assert pc.derive_keys(p) is None


def test_derived_and_shredded_lanes_refuse_to_serialize(tmp_path):
    """A derived lane (a column id at or above DERIVED_COL_BASE) is never
    serialized: a block carrying one writes the reference's bytes, those
    of the same block without it, in both formats.  The writer shreds
    JSON columns only in v2 files with doc_shred_enabled on, as the
    reference's does."""
    jb, pb, jc, pc = _blocks("lineitem")
    j, p = jb[0], pb[0]
    plain = {v: _bytes(p.serialize_parts(v, pc.derive_keys)) for v in (1, 2)}
    for blk in (j, p):
        blk.fixed[pcol.DERIVED_COL_BASE + 1] = blk.fixed[tpch.QTY]
        blk.varlen[pcol.DERIVED_COL_BASE + 2] = (
            np.ones(blk.n, np.uint32), b"x", np.zeros(blk.n, bool))
    for v in (1, 2):
        raw = _bytes(p.serialize_parts(v, pc.derive_keys))
        assert raw == plain[v] == _bytes(j.serialize_parts(v, jc.derive_keys))
        assert pcol.DERIVED_COL_BASE + 1 not in \
            pcol.ColumnarBlock.deserialize(raw).fixed
    path = str(tmp_path / "s.sst")
    for on in (True, False):
        for version in (1, 2):
            with flags_set({"doc_shred_enabled": on,
                            "sst_format_version": version},
                           {"doc_shred_enabled": on,
                            "sst_format_version": version}):
                w = psst.SstWriter(path, shred_cols=(3,))
                jw = jsst.SstWriter(path, shred_cols=(3,))
            assert w.shred_cols == jw.shred_cols == \
                ((3,) if on and version == 2 else ())
            assert w._fmt == jw._fmt == version


# --- SST files ---------------------------------------------------------------------
def _write(mod, path, blocks, version, stream, key_builder, frontier):
    """One SST from `blocks` in format `version`."""
    w = mod.SstWriter(path, stream_columnar=stream, key_builder=key_builder,
                      format_version=version)
    for b in blocks:
        w.add_columnar_block(b)
    w.set_frontier(**frontier)
    return w.finish()


@pytest.mark.parametrize("table", ["lineitem", "lineitem_str"])
@pytest.mark.parametrize("version", [1, 2])
def test_sst_files_byte_identical_streamed_and_buffered(tmp_path, table,
                                                        version):
    """v1 and v2 files of both packages, streamed and buffered, are one
    byte string, and each package reads the other's."""
    jb, pb, jc, pc = _blocks(table)
    frontier = {"op_id": [3, 141], "history_cutoff": HT}
    writers = [("j", jsst, jb, jc.derive_keys),
               ("p", psst, pb, pc.derive_keys)]
    files = {}
    for stream in (False, True):
        for name, mod, blocks, kb in writers:
            path = str(tmp_path / f"{name}{int(stream)}.sst")
            info = _write(mod, path, blocks, version, stream, kb, frontier)
            files[(name, stream)] = open(path, "rb").read()
            assert info["num_entries"] == sum(b.n for b in blocks)
    assert len(set(files.values())) == 1
    # the footer and the index are msgpack's bytes too
    raw = files[("j", False)]
    (flen,) = struct.unpack_from("<I", raw, len(raw) - 12)
    footer = raw[len(raw) - 12 - flen:len(raw) - 12]
    meta = msgpack.unpackb(footer)
    assert wire_pack.packb(meta) == footer
    index = raw[meta["index_offset"]:meta["index_offset"]
                + meta["index_length"]]
    assert wire_pack.packb(msgpack.unpackb(index)) == index
    # each package's reader reads the other's file
    for name, _, _, _ in writers:
        path = str(tmp_path / f"{name}1.sst")
        pr = psst.SstReader(path, key_builder=pc.derive_keys)
        jr = jsst.SstReader(path, key_builder=jc.derive_keys)
        assert pr.format_version == jr.format_version == version
        assert pr.frontier == jr.frontier == frontier
        assert pr.index == [psst.BlockIndexEntry(*vars(e).values())
                            for e in jr.index]
        assert pr.num_blocks() == jr.num_blocks() == len(pb)
        assert pr.file_size == jr.file_size
        assert pr.min_key == jr.min_key and pr.max_key == jr.max_key
        assert pr.bloom.bits.tobytes() == jr.bloom.bits.tobytes()
        for i in range(pr.num_blocks()):
            _assert_same_block(pr.read_columnar(i), jr.read_columnar(i))
            _assert_same_block(pr.columnar_block(i), jr.columnar_block(i))
        got = [i for i, _ in pr.columnar_blocks(lower=pb[1].keys[3]
                                                .tobytes())]
        assert got == [i for i, _ in jr.columnar_blocks(
            lower=pb[1].keys[3].tobytes())]
        kh = int(pb[0].key_hash[0])
        assert pr.bloom.may_contain(kh) and jr.may_contain_hash(kh)


def test_sst_writer_checks_and_abort(tmp_path):
    _, pb, _, pc = _blocks("lineitem")
    path = str(tmp_path / "x.sst")
    w = psst.SstWriter(path, stream_columnar=True)
    w.add_columnar_block(pb[1])
    with pytest.raises(ValueError):
        w.add_columnar_block(pb[0])                  # out of order
    w.abort()
    assert not os.path.exists(path) and not os.path.exists(path + ".tmp")
    with pytest.raises(ValueError):
        psst.SstWriter(path).add_columnar_block(pb[0].slice(0, 0))
    info = psst.SstWriter(path).finish()              # an empty file
    r = psst.SstReader(path)
    assert info["num_entries"] == r.num_entries == 0 and not r.index
    assert r.format_version == 2                      # the port writes v2


def test_row_paths_and_encryption_are_refused(tmp_path):
    """Row KV blocks: both packages write one file from the same entries
    (a row region and a columnar sidecar per block), and read it alike —
    iterate, seek, point_find at several read points and the restart
    window, the whole-SST point reader's answers; the reference's
    encrypted file, in either envelope, reads as the plain one."""
    jb, pb, jc, pc = _blocks("lineitem")
    entries = pc.row_decoder(pb[0]) + pc.row_decoder(pb[1])
    assert entries == jc.row_decoder(jb[0]) + jc.row_decoder(jb[1])
    entries.sort()
    files = {}
    for name, mod, codec in (("j", jsst, jc), ("p", psst, pc)):
        path = str(tmp_path / f"{name}.sst")
        w = mod.SstWriter(path, block_rows=700,
                          columnar_builder=codec.columnar_builder)
        for k, v in entries:
            w.add(k, v)
        w.set_frontier(op_id=[1, 2])
        w.finish()
        files[name] = open(path, "rb").read()
    assert files["j"] == files["p"]
    r = psst.SstReader(str(tmp_path / "p.sst"), row_decoder=pc.row_decoder)
    jr = jsst.SstReader(str(tmp_path / "j.sst"), row_decoder=jc.row_decoder)
    assert r.index[0].length > 0 and r.index[0].col_offset > 0
    assert list(r.iterate()) == list(jr.iterate()) == entries
    mid = entries[len(entries) // 2][0]
    assert list(r.seek(mid)) == list(jr.seek(mid))
    assert list(r.iterate(lower=entries[5][0], upper=mid)) == \
        list(jr.iterate(lower=entries[5][0], upper=mid))
    for k, _ in entries[::97]:
        prefix = k[:-13]
        for read_ht, hi in ((HT, None), (HT - 1, None), (HT - 1, HT)):
            got = r.point_find(prefix, read_ht, hi)
            want = jr.point_find(prefix, read_ht, hi)
            assert (got is None) == (want is None), (prefix, read_ht)
            if got is not None:
                assert got[:4] == want[:4]
    # the whole-SST point reader: the same answers as the reference's,
    # key for key, at several read points and the restart window
    prefixes = [k[:-13] for k, _ in entries[::41]] + [b"\x00", b"\xff"]
    pr, jpr = r.point_reader(pc), jr.point_reader(jc)
    assert pr is r.point_reader(pc)                   # cached per codec
    for read_ht, hi in ((HT, -1), (HT - 1, -1), (HT - 1, HT)):
        assert pr.find_many(prefixes, read_ht, hi) == \
            jpr.find_many(prefixes, read_ht, hi)
    w = psst.SstWriter(str(tmp_path / "z.sst"))
    w.add(b"k", b"v")
    with pytest.raises(ValueError):
        w.add(b"a", b"v")                         # out of order
    from yugabyte_db_tpu.utils import encryption as jenc
    from yugabyte_db_tpu_torch.utils import encryption as penc
    key, nonce = bytes(range(32)), bytes(range(16))
    jenc.KEY_MANAGER.keys["row-test"] = penc.KEY_MANAGER.keys["row-test"] = \
        key
    try:
        plain = files["j"]
        envelopes = (   # the reference's v1 (BLAKE2b) and v2 envelopes
            jenc.MAGIC + bytes([8]) + b"row-test" + nonce
            + jenc.CipherStream(key, nonce).xor(plain),
            jenc.MAGIC_V2 + bytes([jenc.CIPHER_BLAKE2B, 8]) + b"row-test"
            + nonce + jenc.CipherStream(key, nonce).xor(plain))
        enc = str(tmp_path / "e.sst")
        for raw in envelopes:
            with open(enc, "wb") as f:
                f.write(raw)
            er = psst.SstReader(enc, row_decoder=pc.row_decoder)
            assert er.file_size == len(plain)
            assert list(er.iterate()) == entries
    finally:
        for m in (jenc.KEY_MANAGER, penc.KEY_MANAGER):
            del m.keys["row-test"]


# --- the host library against its numpy twins ------------------------------------
def test_host_library_matches_its_plain_versions():
    rng = np.random.default_rng(0)
    hashes = rng.integers(0, 2**63, 3000, dtype=np.uint64) * np.uint64(2)
    assert np.array_equal(native_lib.bloom_build(hashes, 30000, 7),
                          native_lib.bloom_build_plain(hashes, 30000, 7))
    bloom = psst.BloomFilter.build(hashes)
    jbloom = jsst.BloomFilter.build(hashes)
    assert bloom.serialize() == jbloom.serialize()
    assert all(bloom.may_contain(int(h)) for h in hashes[:50])
    # sorted runs with cross-run duplicates, newest run first
    keys = rng.integers(0, 4, (900, 6)).astype(np.uint8)
    runs = [np.unique(keys[i::3], axis=0) for i in range(3)]
    mat = np.concatenate(runs)
    starts = np.cumsum([0] + [len(r) for r in runs])
    got = native_lib.kway_merge_fixed(mat, starts)
    want = native_lib.kway_merge_fixed_plain(mat, starts)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[1].any()
    src = rng.integers(0, 2**31, (500, 3)).astype(np.int64)
    idx = rng.integers(0, 500, 200).astype(np.int64)
    for rb_src in (src, src[:, 0].copy(), src.astype(np.uint8)):
        out = np.empty((200,) + rb_src.shape[1:], rb_src.dtype)
        assert native_lib.gather_rows(rb_src, idx, out)
        assert np.array_equal(out, rb_src[idx])
        dst = np.zeros((600,) + rb_src.shape[1:], rb_src.dtype)
        didx = rng.permutation(600)[:200].astype(np.int64)
        assert native_lib.gather_scatter_rows(rb_src, idx, dst, didx)
        want = np.zeros_like(dst)
        want[didx] = rb_src[idx]
        assert np.array_equal(dst, want)
    assert not native_lib.gather_rows(src[:, :2], idx,
                                      np.empty((200, 2), np.int64))
    jobs_a, jobs_b = [], []
    for s_idx, d_idx in ((idx, None), (None, didx), (idx, didx),
                         (None, None)):
        for arr in (src, src[:, 1].copy()):
            n = len(s_idx if s_idx is not None else
                    d_idx if d_idx is not None else arr)
            shape = ((600 if d_idx is not None else max(n, len(arr))),) \
                + arr.shape[1:]
            a, b = np.zeros(shape, arr.dtype), np.zeros(shape, arr.dtype)
            jobs_a.append((arr if s_idx is not None or d_idx is None
                           else arr[:n], a, s_idx, d_idx))
            jobs_b.append((jobs_a[-1][0], b, s_idx, d_idx))
    assert native_lib.gather_multi(jobs_a)
    native_lib.gather_multi_fallback(jobs_b)
    for (_, a, _, _), (_, b, _, _) in zip(jobs_a, jobs_b):
        assert np.array_equal(a, b)
    assert not native_lib.gather_multi([])
    assert not native_lib.gather_multi([(src, src, idx.astype(np.int32),
                                         None)])
    heap = rng.integers(0, 256, 1000).astype(np.uint8)
    lens = rng.integers(0, 9, 60).astype(np.int64)
    ss = rng.integers(0, 990, 60).astype(np.int64)
    ds = np.cumsum(lens) - lens
    a, b = np.zeros(int(lens.sum()), np.uint8), np.zeros(
        int(lens.sum()), np.uint8)
    assert native_lib.gather_heap(heap, ss, ds, lens, a)
    native_lib.gather_heap_fallback(heap, ss, ds, lens, b)
    assert np.array_equal(a, b)
    assert native_lib.library_path().exists()


# --- the store ---------------------------------------------------------------------
def test_store_manifest_is_shared_with_the_reference(tmp_path):
    """A store either package wrote, the other opens; the open-time
    sweep removes unmanifested files; replace_ssts swaps atomically and
    discards its output when an input left the store."""
    _, pb, jc, pc = _blocks("lineitem")
    d = str(tmp_path / "s")
    ps = LsmStore(d, key_builder=pc.derive_keys)
    for i in range(3):
        ps.ingest_sst(lambda w, i=i: w.add_columnar_block(pb[i]),
                      frontier={"op_id": [1, i]}, stream=bool(i % 2))
    stray = os.path.join(d, "db.000099.sst")
    open(stray, "wb").write(b"partial")
    js = JStore(d, key_builder=jc.derive_keys)
    assert [os.path.basename(r.path) for r in js.ssts] == \
        [os.path.basename(r.path) for r in ps.ssts]
    assert not os.path.exists(stray)                    # swept at open
    again = LsmStore(d, key_builder=pc.derive_keys)
    assert again.approximate_size() == sum(
        os.path.getsize(r.path) for r in again.ssts)
    new = again._new_sst_path()
    _write(psst, new, pb[:1], 2, False, None, {})
    old = again.ssts[:2]
    again.replace_ssts(old, new)
    assert [r.path for r in again.ssts][-1] == new
    assert not any(os.path.exists(r.path) for r in old)
    other = again._new_sst_path()
    _write(psst, other, pb[:1], 2, False, None, {})
    again.replace_ssts(old, other)                      # inputs are gone
    assert not os.path.exists(other) and len(again.ssts) == 2
    assert "db.MANIFEST" in os.listdir(d)


def test_doc_hybrid_time_matches_reference():
    from yugabyte_db_tpu.utils.hybrid_time import DocHybridTime as JDHT
    for ht, wid in ((0, 0), (HT, 7), ((1 << 64) - 2, (1 << 32) - 1)):
        p = DocHybridTime(HybridTime(ht), wid)
        j = JDHT(JHT(ht), wid)
        assert p.encoded_desc() == j.encoded_desc()
        assert DocHybridTime.decode_desc(p.encoded_desc()) == p
    assert HybridTime.from_micros(5, 3).value == JHT.from_micros(5, 3).value
    a = DocHybridTime(HybridTime(5), 1)
    assert a < DocHybridTime(HybridTime(5), 2) < DocHybridTime(HybridTime(6))
