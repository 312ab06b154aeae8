"""The tablet's vector index in the port (yugabyte_db_tpu_torch/tablet/
tablet.py: ``build_vector_index``, the delta that ``apply_write``
maintains, ``vector_search``, ``maybe_rebuild_vector_indexes``, the
persistence and ``bootstrap_vector_indexes``) and the bulk load of
VECTOR, JSON and DECIMAL value columns, against the JAX reference.

Both packages' tablets take the same seeded writes on mock clocks (the
port's on the CPU).  Held equal: block and SST bytes; the index's pks,
frozen keys, delta keys and dead sets after every step; search hit ids
(distances within RTOL, the f32 tolerance of tests/test_torch_vector.py,
of the terms |q|^2 + |b|^2 - 2 q.b they cancel from);
``tablet_meta.msgpack`` byte for byte;
restarts, including a port tablet bootstrapping the reference's
directory and the other way round.  The vectors are well-separated
clusters, so neither k-means nor a top-k meets a near-tie."""
import json
import os
import shutil
import time

import msgpack
import numpy as np
import pytest

from yugabyte_db_tpu.docdb.operations import RowOp as JOp
from yugabyte_db_tpu.docdb.operations import WriteRequest as JW
from yugabyte_db_tpu.docdb.table_codec import TableCodec as JCodec
from yugabyte_db_tpu.tablet import Tablet as JTablet
from yugabyte_db_tpu.utils import hybrid_time as jht
from yugabyte_db_tpu_torch.docdb.operations import RowOp, WriteRequest
from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec
from yugabyte_db_tpu_torch.storage import wire_pack
from yugabyte_db_tpu_torch.tablet import Tablet
from yugabyte_db_tpu_torch.utils import hybrid_time as pht
from tests.torch_parity import WRITE_BASE_US, flags_set, store_files

RTOL = 1e-5
DIM = 8
N = 40
NLISTS = 4
METHODS = {"ivfflat": {"iters": 10},
           "hnsw": {"m": 8, "ef_construction": 40, "ef_search": 48}}


def vec_infos(extra=()):
    """(reference TableInfo, port TableInfo) of ``(id int64 hashed, emb
    vector)`` and the value columns named in `extra`: "doc" (JSON) and
    "amt" (DECIMAL)."""
    from yugabyte_db_tpu.docdb.table_codec import TableInfo as JInfo
    from yugabyte_db_tpu.dockv import packed_row as jpr
    from yugabyte_db_tpu.dockv.partition import PartitionSchema as JPS
    from yugabyte_db_tpu_torch.docdb.table_codec import TableInfo as PInfo
    from yugabyte_db_tpu_torch.dockv import packed_row as ppr
    from yugabyte_db_tpu_torch.dockv.partition import PartitionSchema as PPS

    def cols(pr):
        C, T = pr.ColumnSchema, pr.ColumnType
        out = (C(0, "id", T.INT64, is_hash_key=True),
               C(1, "emb", T.VECTOR))
        if "doc" in extra:
            out += (C(2, "doc", T.JSON),)
        if "amt" in extra:
            out += (C(3, "amt", T.DECIMAL),)
        return out

    return (JInfo("t1", "vt", jpr.TableSchema(cols(jpr), 1), JPS("hash", 1)),
            PInfo("t1", "vt", ppr.TableSchema(cols(ppr), 1), PPS("hash", 1)))


def _open(root, sub, infos, jphys, pphys, which="both"):
    jinfo, pinfo = infos
    jt = pt = None
    if which in ("both", "j"):
        jt = JTablet("v", jinfo, os.path.join(root, sub[0]),
                     clock=jht.HybridClock(jphys))
    if which in ("both", "p"):
        pt = Tablet("v", pinfo, os.path.join(root, sub[1]),
                    clock=pht.HybridClock(pphys), device="cpu")
    return jt, pt


class Pair:
    """A reference and a port tablet of :func:`vec_infos` on two mock
    clocks at WRITE_BASE_US, written alike."""

    def __init__(self, root):
        self.root = str(root)
        self.infos = vec_infos()
        self.jphys = jht.MockPhysicalClock(WRITE_BASE_US)
        self.pphys = pht.MockPhysicalClock(WRITE_BASE_US)
        self.j, self.p = _open(self.root, ("j", "p"), self.infos,
                               self.jphys, self.pphys)

    def tick(self, us=1000):
        self.jphys.advance_micros(us)
        self.pphys.advance_micros(us)

    def write(self, ops, ttl_ms=None):
        """[(kind, id, vector or None)] as one WriteRequest to both."""
        rows = [(k, {"id": int(i)} if v is None else
                 {"id": int(i), "emb": np.asarray(v, np.float32).tobytes()})
                for k, i, v in ops]
        self.tick()
        self.j.apply_write(JW("t1", [JOp(k, dict(r), ttl_ms)
                                     for k, r in rows]))
        self.p.apply_write(WriteRequest("t1", [RowOp(k, dict(r), ttl_ms)
                                               for k, r in rows]))

    def load(self, ids, vecs):
        self.tick()
        cols = {"id": np.asarray(ids, np.int64),
                "emb": np.asarray(vecs, np.float32)}
        return self.j.bulk_load(cols), self.p.bulk_load(cols)

    def build(self, method="ivfflat", nlists=NLISTS):
        opts = dict(METHODS[method])
        return (self.j.build_vector_index("emb", nlists, method, opts),
                self.p.build_vector_index("emb", nlists, method, opts))

    def search(self, q, k=5, nprobe=NLISTS):
        self.last_q = np.asarray(q, np.float32)
        return (self.j.vector_search("emb", q, k=k, nprobe=nprobe),
                self.p.vector_search("emb", q, k=k, nprobe=nprobe))

    def flush(self):
        self.j.flush()
        self.p.flush()

    def reopen(self):
        self.j, self.p = _open(self.root, ("j", "p"), self.infos,
                               self.jphys, self.pphys)


def clusters(n, dim=DIM, seed=0, k=NLISTS):
    """n vectors round k well-separated centers (spread 0.3)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, dim)).astype(np.float32) * 3
    return (centers[np.arange(n) % k]
            + rng.normal(size=(n, dim)).astype(np.float32) * 0.3)


def assert_same_hits(jh, ph, what="", q=None):
    """Hit pks equal in order; distances within RTOL of the terms they
    cancel from (2 |q|^2 plus the distance: |b|^2 <= (|q| + d)^2)."""
    assert [h[0] for h in ph] == [h[0] for h in jh], what
    jd = np.asarray([h[1] for h in jh], np.float64)
    pd = np.asarray([h[1] for h in ph], np.float64)
    if len(jd):
        qq = 0.0 if q is None else float(np.dot(q, q))
        np.testing.assert_allclose(pd, jd, rtol=RTOL,
                                   atol=RTOL * (4 * qq + 2 * jd.max() + 1),
                                   err_msg=what)


def _state(t):
    (st,) = t.vector_indexes.values()
    return st


def assert_same_state(pair, what=""):
    js, ps = _state(pair.j), _state(pair.p)
    assert ps.pks == js.pks, what
    assert ps.frozen_keys == js.frozen_keys, what
    assert ps.frozen_pos == js.frozen_pos, what
    assert set(ps.delta) == set(js.delta), what
    for key, (jpk, jv, jexp) in js.delta.items():
        ppk, pv, pexp = ps.delta[key]
        assert (ppk, pv) == (jpk, jv), (what, key)
        # a TTL'd entry's expiry: each package read the wall clock
        assert (pexp is None) == (jexp is None), (what, key)
        assert pexp is None or abs(pexp - jexp) < 5.0, (what, key)
    assert ps.dead == js.dead, what
    assert (ps.method, ps.options) == (js.method, js.options), what
    assert (ps.idx is None) == (js.idx is None), what
    if js.idx is not None:
        assert ps.idx.size == js.idx.size, what
    return ps


@pytest.fixture
def built(tmp_path, request):
    """A pair with N bulk-loaded clustered rows and an index of the
    parametrized method (ivfflat by default)."""
    method = getattr(request, "param", "ivfflat")
    pair = Pair(tmp_path)
    base = clusters(N)
    pair.load(np.arange(N), base)
    assert pair.build(method) == (N, N)
    return pair, base, method


# --- (1) the bulk load of VECTOR, JSON and DECIMAL value columns -------------
def _extra_columns(n, seed=3):
    rng = np.random.default_rng(seed)
    docs = np.asarray([json.dumps({"a": int(x), "s": "é" * int(x % 3)})
                       for x in rng.integers(0, 50, n)], object)
    amts = np.asarray([f"{x / 100:.2f}" for x in rng.integers(-999, 999, n)],
                      object)
    return {"id": np.arange(n, dtype=np.int64) * 7 - 40,
            "emb": rng.normal(size=(n, 4)).astype(np.float32),
            "doc": docs, "amt": amts}


@pytest.mark.parametrize("block_rows", [16, 5])
@pytest.mark.parametrize("emb_form", ["matrix", "bytes"])
def test_bulk_blocks_take_vector_json_decimal(block_rows, emb_form):
    """16 rows of 4-float vectors (the smallest input of the fault the
    bulk load had): the port's blocks serialize to the reference's
    bytes, a vector lane holding each row's float32 bytes."""
    jinfo, pinfo = vec_infos(extra=("doc", "amt"))
    cols = _extra_columns(16)
    if emb_form == "bytes":
        cols["emb"] = np.asarray([r.tobytes() for r in cols["emb"]], object)
    jb = JCodec(jinfo).bulk_blocks(cols, jht.HybridTime(1000),
                                   block_rows=block_rows)
    pb = TableCodec(pinfo).bulk_blocks(cols, pht.HybridTime(1000),
                                       block_rows=block_rows)
    assert len(pb) == len(jb) == -(-16 // block_rows)
    for j, p in zip(jb, pb):
        assert p.serialize() == j.serialize(2)
        for cid in (1, 2, 3):
            for a, b in zip(p.varlen[cid], j.varlen[cid]):
                assert bytes(np.asarray(a)) == bytes(np.asarray(b))
    heap = b"".join(bytes(p.varlen[1][1]) for p in pb)
    want = np.asarray(_extra_columns(16)["emb"], np.float32)
    got = np.frombuffer(heap, np.float32).reshape(16, 4)
    order = np.concatenate([p.pk[0] for p in pb])
    assert np.array_equal(got, want[(order + 40) // 7])


@pytest.mark.parametrize("column", ["emb", "amt", "doc"])
def test_bulk_load_writes_the_reference_sst(tmp_path, column):
    """Tablet.bulk_load of a VECTOR, DECIMAL or JSON value column writes
    the reference's SST and manifest byte for byte (JSON with document
    shredding off in both; test_json_bulk_load_refuses_shredding holds
    the shredding writer)."""
    jinfo, pinfo = vec_infos(extra=(column,))
    cols = {k: v for k, v in _extra_columns(300).items()
            if k in ("id", "emb", column)}
    jt, pt = _open(str(tmp_path), ("j", "p"), (jinfo, pinfo),
                   jht.MockPhysicalClock(WRITE_BASE_US),
                   pht.MockPhysicalClock(WRITE_BASE_US))
    off = {"doc_shred_enabled": False}
    with flags_set(off, off) if column == "doc" else flags_set({}, {}):
        assert jt.bulk_load(cols, block_rows=64) == \
            pt.bulk_load(cols, block_rows=64) == 300
    assert store_files(pt.regular) == store_files(jt.regular)
    # every row reads back alike through the interpreted row path
    from yugabyte_db_tpu.docdb.operations import ReadRequest as JReq
    from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
    jrows = jt.read(JReq("t1", columns=("id", column))).rows
    prows = pt.read(ReadRequest("t1", columns=("id", column))).rows
    assert prows == jrows and len(prows) == 300


def test_json_bulk_load_refuses_shredding(tmp_path):
    """With doc_shred_enabled on (the default) both writers shred the
    JSON column of a bulk load: the reference's SST and manifest byte
    for byte, with the shredded lanes in the block, and the rows read
    back alike."""
    jinfo, pinfo = vec_infos(extra=("doc",))
    cols = {k: v for k, v in _extra_columns(300).items() if k != "amt"}
    jt, pt = _open(str(tmp_path), ("j", "p"), (jinfo, pinfo),
                   jht.MockPhysicalClock(WRITE_BASE_US),
                   pht.MockPhysicalClock(WRITE_BASE_US))
    assert jt.bulk_load(cols, block_rows=64) == \
        pt.bulk_load(cols, block_rows=64) == 300
    assert store_files(pt.regular) == store_files(jt.regular)
    cid = pt.codec.shred_cols[0]
    assert pt.regular.ssts[0].columnar_block(0).shred[cid]
    from yugabyte_db_tpu.docdb.operations import ReadRequest as JReq
    from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
    assert pt.read(ReadRequest("t1", columns=("id", "doc"))).rows == \
        jt.read(JReq("t1", columns=("id", "doc"))).rows


def test_bulk_load_refuses_a_string_key():
    """A non-fixed key column stays refused (the reference's bulk key
    encoders are fixed-width only too)."""
    from yugabyte_db_tpu_torch.docdb.table_codec import TableInfo
    from yugabyte_db_tpu_torch.dockv import packed_row as ppr
    from yugabyte_db_tpu_torch.dockv.partition import PartitionSchema
    C, T = ppr.ColumnSchema, ppr.ColumnType
    info = TableInfo("t1", "s", ppr.TableSchema(
        (C(0, "k", T.STRING, is_hash_key=True), C(1, "emb", T.VECTOR)), 1),
        PartitionSchema("hash", 1))
    with pytest.raises(NotImplementedError, match="item 9"):
        TableCodec(info).bulk_blocks(
            {"k": np.asarray(["a", "b"], object),
             "emb": np.zeros((2, 4), np.float32)}, pht.HybridTime(1))


# --- (2) the build ------------------------------------------------------------
@pytest.mark.parametrize("built", sorted(METHODS), indirect=True)
def test_build_matches_reference(built):
    pair, base, method = built
    st = assert_same_state(pair, method)
    assert len(st.pks) == N and not st.delta and not st.dead
    assert sorted(p["id"] for p in st.pks) == list(range(N))
    assert st.idx.method == method
    for i in (0, 7, 13, 39):
        jh, ph = pair.search(base[i] + 0.001)
        assert_same_hits(jh, ph, q=pair.last_q, what=f"{method} q{i}")
        assert ph[0][0] == {"id": i}


def test_build_on_an_empty_table(tmp_path):
    pair = Pair(tmp_path)
    assert pair.build() == (0, 0)
    st = assert_same_state(pair)
    assert st.idx is None and not os.path.exists(
        os.path.join(pair.p.dir, "vecidx", "1"))
    assert pair.search(np.zeros(DIM)) == ([], [])


# --- (3) maintenance after the build (tests/test_vector_sql.py:55-123) ----------
@pytest.mark.parametrize("method", sorted(METHODS))
def test_maintenance_after_the_build(tmp_path, method):
    """Writes after the build are searchable without a rebuild (the
    delta), an upsert's new vector wins, a delete hides the frozen copy
    at once, and an outgrown delta folds back into the chunk."""
    pair = Pair(tmp_path)
    vecs = clusters(30, seed=1)
    for i in range(30):
        pair.write([("upsert", i, vecs[i])])
    pair.build(method)
    target = np.full(DIM, 9.0, np.float32)
    pair.write([("insert", 100, target)])
    jh, ph = pair.search(target, k=1)
    assert_same_hits(jh, ph, q=pair.last_q, what="insert")
    assert ph[0][0] == {"id": 100}
    pair.write([("upsert", 5, target)])
    jh, ph = pair.search(target, k=2)
    assert_same_hits(jh, ph, q=pair.last_q, what="upsert")
    assert {h[0]["id"] for h in ph} == {100, 5}
    assert_same_state(pair, "upsert")
    pair.write([("delete", 5, None)])
    jh, ph = pair.search(target, k=2)
    assert_same_hits(jh, ph, q=pair.last_q, what="delete")
    assert 5 not in {h[0]["id"] for h in ph}
    st = assert_same_state(pair, "delete")
    assert set(st.delta) == {(100,)} and st.dead == {(5,)}
    rng = np.random.default_rng(1)
    for i in range(200, 280):
        pair.write([("insert", i, rng.normal(size=DIM))])
    assert (pair.j.maybe_rebuild_vector_indexes(),
            pair.p.maybe_rebuild_vector_indexes()) == (1, 1)
    st = assert_same_state(pair, "fold")
    assert not st.delta and not st.dead
    assert len(st.pks) == 110          # 30 + id 100 + 80 - id 5
    jh, ph = pair.search(target, k=1)
    assert_same_hits(jh, ph, q=pair.last_q, what="fold")
    assert ph[0][0] == {"id": 100}
    # below the churn threshold nothing is rebuilt
    pair.write([("insert", 500, target)])
    assert (pair.j.maybe_rebuild_vector_indexes(),
            pair.p.maybe_rebuild_vector_indexes()) == (0, 0)


def test_a_write_to_another_table_is_not_indexed(built):
    pair, _, _ = built
    pair.p.apply_write(WriteRequest("other", [RowOp(
        "upsert", {"id": 1, "emb": np.ones(DIM, np.float32).tobytes()})]))
    assert not _state(pair.p).delta and not _state(pair.p).dead


def test_rows_without_a_vector(built):
    """A NULL vector is skipped by the scan and leaves no delta entry;
    a delete of a key that was never indexed leaves no trace."""
    pair, _, _ = built
    pair.write([("upsert", 300, None), ("upsert", 2, None),
                ("delete", 301, None)])
    st = assert_same_state(pair, "nulls")
    assert not st.delta and st.dead == {(2,)}
    jh, ph = pair.search(np.zeros(DIM), k=N)
    assert_same_hits(jh, ph, q=pair.last_q, what="nulls")
    assert {h[0]["id"] for h in ph} == set(range(N)) - {2}


# --- (4) WAL-replay idempotence ---------------------------------------------------
@pytest.mark.parametrize("built", sorted(METHODS), indirect=True)
def test_wal_replay_of_an_equal_vector_is_skipped(built):
    pair, base, _ = built
    pair.write([("upsert", i, base[i]) for i in range(10)])
    st = assert_same_state(pair, "replay")
    assert not st.delta and not st.dead
    # a changed vector, and an equal one with a TTL, are real writes
    pair.write([("upsert", 3, base[3] + 1)])
    pair.write([("upsert", 4, base[4])], ttl_ms=60_000)
    st = assert_same_state(pair, "changed")
    assert set(st.delta) == st.dead == {(3,), (4,)}
    # once shadowed by the delta, an equal re-write is not skipped
    pair.write([("upsert", 3, base[3])])
    st = assert_same_state(pair, "shadowed")
    assert (3,) in st.delta and (3,) in st.dead


# --- (5) TTL on the wall clock ---------------------------------------------------
def test_ttl_delta_expires_on_the_wall_clock(built, monkeypatch):
    """A TTL write's delta entry expires at wall time + ttl (time.time
    patched in both packages; no sleeps)."""
    pair, _, _ = built
    now = [5_000.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    target = np.full(DIM, 7.0, np.float32)
    pair.write([("upsert", 400, target), ("upsert", 1, target)],
               ttl_ms=1500)
    st = assert_same_state(pair, "ttl")
    assert st.delta[(400,)][2] == 5_000.0 + 1.5
    now[0] = 5_001.0
    jh, ph = pair.search(target, k=2)
    assert_same_hits(jh, ph, q=pair.last_q, what="before expiry")
    assert {h[0]["id"] for h in ph} == {400, 1}
    now[0] = 5_001.5
    jh, ph = pair.search(target, k=2)
    assert_same_hits(jh, ph, q=pair.last_q, what="at expiry")
    assert not {h[0]["id"] for h in ph} & {400, 1}
    st = assert_same_state(pair, "expired")
    assert not st.delta and st.dead == {(1,)}


# --- (6) a write that races a rebuild ------------------------------------------------
def test_a_write_racing_a_rebuild_is_carried_over(built, monkeypatch):
    """Delta entries recorded before the rebuild's scan fold into the
    chunk and go; a write applied during the build stays in the new
    delta (by identity, also for a key that was already in the delta),
    and hides its frozen copy."""
    pair, base, _ = built
    pair.write([("insert", 300, base[0] + 3), ("upsert", 3, base[3] + 3)])
    for t in (pair.j, pair.p):
        scan = t._scan_vectors

        def racing(col, _scan=scan, _t=t):
            got = _scan(col)
            req = ("upsert", {"id": 301, "emb": (base[1] + 5).tobytes()}), \
                ("upsert", {"id": 4, "emb": (base[4] + 5).tobytes()}), \
                ("upsert", {"id": 300, "emb": (base[0] + 5).tobytes()})
            if isinstance(_t, Tablet):
                _t.apply_write(WriteRequest("t1", [RowOp(k, r)
                                                   for k, r in req]))
            else:
                _t.apply_write(JW("t1", [JOp(k, r) for k, r in req]))
            return got

        monkeypatch.setattr(t, "_scan_vectors", racing)
    pair.tick()
    pair.build()
    st = assert_same_state(pair, "race")
    assert set(st.delta) == {(301,), (4,), (300,)}
    assert st.dead == {(4,), (300,)}
    assert (300,) in st.frozen_keys and (301,) not in st.frozen_keys
    monkeypatch.undo()
    jh, ph = pair.search(base[0] + 5, k=3)
    assert_same_hits(jh, ph, q=pair.last_q, what="race search")
    assert ph[0][0] == {"id": 300}


# --- (7) the persisted metadata --------------------------------------------------
@pytest.mark.parametrize("built", sorted(METHODS), indirect=True)
def test_tablet_meta_is_the_references_bytes(built):
    pair, _, method = built
    jdir, pdir = (os.path.join(t.dir, "vecidx", "1")
                  for t in (pair.j, pair.p))
    jraw, praw = (open(os.path.join(d, "tablet_meta.msgpack"), "rb").read()
                  for d in (jdir, pdir))
    assert praw == jraw
    meta = msgpack.unpackb(jraw, raw=False, strict_map_key=False)
    assert wire_pack.unpackb(jraw) == meta
    assert meta["method"] == method and len(meta["pks"]) == N
    jm, pm = (json.load(open(os.path.join(d, "meta.json")))
              for d in (jdir, pdir))
    assert pm["method"] == jm["method"] and pm["options"] == jm["options"]
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))


def test_wire_pack_reads_maps_as_the_reference_reads_them():
    """unpackb(raw=False, strict_map_key=False): str keys, int keys, bin
    values."""
    obj = {"col_name": "emb", 3: [1, -2], "pks": [{"id": -(1 << 40)}],
           "b": b"\x00\xff", "f": 1.5, "n": None}
    raw = msgpack.packb(obj, use_bin_type=True)
    assert wire_pack.unpackb(raw) == msgpack.unpackb(
        raw, raw=False, strict_map_key=False) == obj
    assert wire_pack.packb(obj) == raw


# --- (8) restart: flush, reopen, bootstrap ------------------------------------------
def _churn(pair, base):
    """Inserts, upserts of frozen ids and deletes of frozen ids."""
    target = np.full(DIM, 9.0, np.float32)
    pair.write([("insert", 100, target), ("insert", 101, base[2] + 2)])
    pair.write([("upsert", 5, base[5] + 4), ("upsert", 6, base[6])])
    pair.write([("delete", 7, None), ("delete", 8, None)])
    return target


def _expect_churned(st):
    assert set(st.delta) == {(100,), (101,), (5,)}
    assert st.dead == {(5,), (7,), (8,)}


@pytest.mark.parametrize("built", sorted(METHODS), indirect=True)
def test_index_survives_restart(built):
    """Build, write, flush, reopen, bootstrap: the persisted index
    LOADS (the frozen chunk intact, not rebuilt) and the post-build
    writes reconcile into the delta and dead sets."""
    pair, base, method = built
    target = _churn(pair, base)
    before = pair.search(target, k=3)
    pair.flush()
    pair.reopen()
    assert (pair.j.bootstrap_vector_indexes(),
            pair.p.bootstrap_vector_indexes()) == (1, 1)
    st = assert_same_state(pair, "restart")
    assert st.method == method and st.idx.size == N and len(st.pks) == N
    assert st.touched is None
    _expect_churned(st)
    after = pair.search(target, k=3)
    assert_same_hits(*after, q=pair.last_q, what="restart")
    assert [h[0] for h in after[1]] == [h[0] for h in before[1]]
    assert after[1][0][0] == {"id": 100}
    jh, ph = pair.search(base[17] + 0.001, k=3)
    assert_same_hits(jh, ph, q=pair.last_q, what="restart q17")
    assert ph[0][0] == {"id": 17}


def test_bootstrap_without_an_index(tmp_path):
    pair = Pair(tmp_path)
    pair.load(np.arange(N), clusters(N))
    assert (pair.j.bootstrap_vector_indexes(),
            pair.p.bootstrap_vector_indexes()) == (0, 0)
    assert not pair.p.vector_indexes


@pytest.mark.parametrize("method", sorted(METHODS))
def test_bootstrap_defers_to_writes_during_the_scan(tmp_path, monkeypatch,
                                                    method):
    """Writes applied while the bootstrap's scan-diff runs win over the
    scan's image: a delete of a non-frozen key is not resurrected."""
    pair = Pair(tmp_path)
    base = clusters(N)
    pair.load(np.arange(N), base)
    pair.build(method)
    pair.write([("insert", 100, base[1] + 1)])
    pair.flush()
    pair.reopen()
    for t in (pair.j, pair.p):
        scan = t._scan_vectors

        def racing(col, _scan=scan, _t=t):
            got = _scan(col)
            ops = (("delete", {"id": 100}), ("delete", {"id": 9}))
            if isinstance(_t, Tablet):
                _t.apply_write(WriteRequest("t1", [RowOp(k, r)
                                                   for k, r in ops]))
            else:
                _t.apply_write(JW("t1", [JOp(k, r) for k, r in ops]))
            return got

        monkeypatch.setattr(t, "_scan_vectors", racing)
    pair.tick()
    assert (pair.j.bootstrap_vector_indexes(),
            pair.p.bootstrap_vector_indexes()) == (1, 1)
    st = assert_same_state(pair, "deferred")
    assert not st.delta and st.dead == {(9,)}


# --- (9) across the packages ---------------------------------------------------
@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_bootstrap_across_packages(tmp_path, method, direction):
    """A tablet of one package opened on a copy of a directory the other
    package wrote (same manifest and SST format) restores that index and
    answers as the writer's own restart does."""
    pair = Pair(tmp_path / "w")
    base = clusters(N)
    pair.load(np.arange(N), base)
    pair.build(method)
    target = _churn(pair, base)
    pair.flush()
    pair.reopen()
    assert pair.j.bootstrap_vector_indexes() == 1
    assert pair.p.bootstrap_vector_indexes() == 1
    copy = str(tmp_path / "copy")
    if direction == "reference_to_port":
        shutil.copytree(pair.j.dir, copy)
        _, other = _open(str(tmp_path), (None, "copy"), pair.infos,
                         pair.jphys, pair.pphys, which="p")
        writer = pair.j
    else:
        shutil.copytree(pair.p.dir, copy)
        other, _ = _open(str(tmp_path), ("copy", None), pair.infos,
                         pair.jphys, pair.pphys, which="j")
        writer = pair.p
    assert other.bootstrap_vector_indexes() == 1
    ws, os_ = _state(writer), _state(other)
    assert os_.pks == ws.pks and os_.idx.size == ws.idx.size == N
    assert set(os_.delta) == set(ws.delta) and os_.dead == ws.dead
    _expect_churned(os_)
    for q in (target, base[17] + 0.001, base[30] + 0.001):
        wh = writer.vector_search("emb", q, k=4, nprobe=NLISTS)
        oh = other.vector_search("emb", q, k=4, nprobe=NLISTS)
        if direction == "reference_to_port":
            assert_same_hits(wh, oh, direction, q)
        else:
            assert_same_hits(oh, wh, direction, q)


# --- (10) a torn payload rebuilds ----------------------------------------------------
@pytest.mark.parametrize("torn", ["index.npz", "meta.json", "pks"])
def test_torn_payload_rebuilds(built, torn):
    """An unreadable index file, or a pk map that does not match the
    index, rebuilds from the store with the recorded method and options
    (a rebuild leaves the delta and dead sets empty)."""
    pair, base, _ = built
    _churn(pair, base)
    pair.flush()
    for t in (pair.j, pair.p):
        d = os.path.join(t.dir, "vecidx", "1")
        if torn == "pks":
            meta = msgpack.unpackb(
                open(os.path.join(d, "tablet_meta.msgpack"), "rb").read(),
                raw=False, strict_map_key=False)
            meta["pks"] = meta["pks"][:-1]
            with open(os.path.join(d, "tablet_meta.msgpack"), "wb") as f:
                f.write(msgpack.packb(meta, use_bin_type=True))
        else:
            with open(os.path.join(d, torn), "wb") as f:
                f.write(b"torn")
    pair.reopen()
    assert (pair.j.bootstrap_vector_indexes(),
            pair.p.bootstrap_vector_indexes()) == (1, 1)
    st = assert_same_state(pair, torn)
    assert not st.delta and not st.dead
    assert len(st.pks) == N + 2 - 2 and st.options == METHODS["ivfflat"] | {
        "lists": NLISTS}
    jh, ph = pair.search(np.full(DIM, 9.0, np.float32), k=2)
    assert_same_hits(jh, ph, q=pair.last_q, what=torn)
    assert ph[0][0] == {"id": 100}


def test_unreadable_metadata_is_ignored(built):
    pair, _, _ = built
    pair.flush()
    for t in (pair.j, pair.p):
        os.remove(os.path.join(t.dir, "vecidx", "1", "tablet_meta.msgpack"))
    pair.reopen()
    assert (pair.j.bootstrap_vector_indexes(),
            pair.p.bootstrap_vector_indexes()) == (0, 0)
    assert not pair.p.vector_indexes


# --- (11) no index: exact search over a fresh scan ------------------------------------
@pytest.mark.parametrize("k", [1, 5, 60])
def test_no_index_fallback(tmp_path, k):
    pair = Pair(tmp_path)
    base = clusters(N)
    pair.load(np.arange(N), base)
    pair.write([("upsert", 3, base[3] + 2), ("delete", 4, None),
                ("insert", 50, np.full(DIM, 9.0))])
    for q in (base[10] + 0.001, np.full(DIM, 9.0), base[3] + 2):
        jh, ph = pair.search(q, k=k)
        assert_same_hits(jh, ph, q=pair.last_q, what=f"k={k}")
        assert len(ph) == min(k, N)
        assert {"id": 4} not in [h[0] for h in ph]
    assert not pair.p.vector_indexes


def test_vector_search_of_an_empty_table(tmp_path):
    pair = Pair(tmp_path)
    assert pair.search(np.zeros(DIM)) == ([], [])
