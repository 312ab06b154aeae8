"""The port's multi-device tablet mesh (yugabyte_db_tpu_torch/parallel/)
against the JAX reference's on the CPU: the reference runs on the 8
virtual CPU devices tests/conftest.py sets, the port on meshes of CPU
slots (``devices=["cpu"] * S``), over the same seeded blocks.

Tolerances: integer, count, MIN/MAX and static-scale SUM lanes bit for
bit; dynamic-scale SUMs within 2 eps of the device dtype (XLA:CPU's
inexact ``exp2`` — see tests/test_torch_scan.py
``test_dynamic_scale_path_matches_reference``); float fallback lanes
within 1e-12 relative (the lanes add in another order)."""
import jax
import numpy as np
import pytest
import torch

from yugabyte_db_tpu.parallel import distributed_scan as jds
from yugabyte_db_tpu.parallel import mesh as jmesh
from yugabyte_db_tpu.parallel import vector as jpv
from yugabyte_db_tpu_torch.device import DeviceUnavailable
from yugabyte_db_tpu_torch.ops.expr import Expr
from yugabyte_db_tpu_torch.ops.grouped_scan import DictGroupSpec
from yugabyte_db_tpu_torch.ops.scan import (AggSpec, GroupSpec, HashGroupSpec,
                                            _expand_avg)
from yugabyte_db_tpu_torch.parallel import distributed_scan as pds
from yugabyte_db_tpu_torch.parallel import mesh as pmesh
from yugabyte_db_tpu_torch.parallel import vector as ppv
from tests.torch_parity import (assert_bitwise, block_pair, float_dtype,
                                ids_agree, to_jax_aggs, to_jax_group)

C = Expr.col
QTY, PRICE, FLAG, IVAL = 1, 2, 4, 5
COLS = [QTY, PRICE, FLAG, IVAL]
MESHES = [(8, 1), (4, 2), (1, 1)]
READ_HT = 1000

QUERIES = {
    "scalar": ((C(QTY) < 25.0).node,
               (AggSpec("sum", C(QTY).node),
                AggSpec("sum", (C(PRICE) * (C(QTY) + 1.0)).node),
                AggSpec("count"), AggSpec("count", C(QTY).node),
                AggSpec("min", C(PRICE).node), AggSpec("max", C(QTY).node),
                AggSpec("min", C(IVAL).node), AggSpec("avg", C(IVAL).node),
                AggSpec("sum", C(IVAL).node)), None),
    "grouped": ((C(PRICE) > 2000.0).node,
                (AggSpec("sum", C(QTY).node), AggSpec("count"),
                 AggSpec("min", C(PRICE).node), AggSpec("max", C(IVAL).node),
                 AggSpec("avg", C(PRICE).node)),
                GroupSpec(cols=((FLAG, 4, 0),))),
}


def _shard(n, seed, dedup=False, qty_scale=1.0):
    """One shard's block pair: fractional f64 quantity (5% NULL) and
    price, an int32 flag, an int64 value; hybrid times 900/1000/1100
    with 5% tombstones.  `dedup`: the second half re-writes keys of
    the first (newer and older versions inside this one shard).
    `qty_scale` multiplies the quantities."""
    rng = np.random.default_rng(seed)
    kh = rng.integers(0, 2 ** 63, n).astype(np.uint64)
    if dedup:
        kh[n // 2:] = kh[:n - n // 2]
    d = {"key_hash": kh,
         "ht": rng.choice(np.array([900, 1000, 1100], np.uint64), n),
         "write_id": rng.integers(0, 4, n).astype(np.uint32),
         "tombstone": rng.random(n) < 0.05,
         "unique_keys": not dedup,
         "fixed": {QTY: (rng.uniform(0, 50, n) * qty_scale,
                         rng.random(n) < 0.05),
                   PRICE: (rng.uniform(900, 100000, n), np.zeros(n, bool)),
                   FLAG: (rng.integers(0, 4, n).astype(np.int32),
                          np.zeros(n, bool)),
                   IVAL: (rng.integers(-1000, 1000, n), np.zeros(n, bool))}}
    return block_pair(d)


def _shards(S, seed, empty=None, dedup=False):
    """(reference block lists, port block lists) for S slots; slot
    `empty` has no block."""
    jb, pb = [], []
    for s in range(S):
        if s == empty:
            jb.append([])
            pb.append([])
            continue
        j, p = _shard(300 + 37 * s, seed * 100 + s, dedup)
        jb.append([j])
        pb.append([p])
    return jb, pb


def _meshes(T, B):
    return (jmesh.tablet_mesh(T, B),
            pmesh.tablet_mesh(T, B, devices=["cpu"] * (T * B)))


def _run_both(T, B, jb, pb, query, read_ht, dynamic=False):
    where, aggs, group = QUERIES[query]
    jm, pm = _meshes(T, B)
    jbat = jds.build_sharded_batch(jm, jb, COLS)
    pbat = pds.build_sharded_batch(pm, pb, COLS)
    assert pbat.col_bounds == jbat.col_bounds
    if dynamic:                # no column stats: the dynamic-scale path
        jbat.col_bounds.clear()
        pbat.col_bounds.clear()
    jo, jc = jds.DistributedScanKernel().run(
        jbat, where, to_jax_aggs(aggs), to_jax_group(group), read_ht)
    po, pc = pds.DistributedScanKernel().run(pbat, where, aggs, group,
                                             read_ht)
    return po, pc, jo, np.asarray(jc)


@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("mvcc", ["none", "visible", "dedup"])
@pytest.mark.parametrize("query", sorted(QUERIES))
@pytest.mark.parametrize("T,B", MESHES)
def test_static_scale_bitwise(T, B, query, mvcc, mode):
    jb, pb = _shards(T * B, seed=T, empty=1 if T * B > 1 else None,
                     dedup=mvcc == "dedup")
    with float_dtype(mode):
        po, pc, jo, jc = _run_both(T, B, jb, pb, query,
                                   None if mvcc == "none" else READ_HT)
    assert len(po) == len(jo)
    for i, (a, b) in enumerate(zip(po, jo)):
        assert_bitwise(a, b, f"agg {i}")
    assert_bitwise(pc, jc, "counts")


@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("query", sorted(QUERIES))
@pytest.mark.parametrize("T,B", MESHES)
def test_dynamic_scale_within_two_eps(T, B, query, mode):
    jb, pb = _shards(T * B, seed=10 + T)
    with float_dtype(mode):
        po, pc, jo, jc = _run_both(T, B, jb, pb, query, READ_HT,
                                   dynamic=True)
    assert_bitwise(pc, jc, "counts")
    eps = np.finfo(np.float32 if mode == "float32" else np.float64).eps
    ops = [a.op for a in _expand_avg(QUERIES[query][1])]
    for i, (a, b) in enumerate(zip(po, jo)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, i
        if a.dtype.kind in "iu" or ops[i] in ("min", "max"):
            assert_bitwise(a, b, f"agg {i}")
        else:
            np.testing.assert_allclose(a, b, rtol=2 * eps, atol=0,
                                       err_msg=f"agg {i}")


def test_dynamic_scale_is_one_scale_from_every_shard():
    """Shard 0's values are 1000x the others': with one scale from the
    max over all shards, the combined int64 sum divided by that scale
    is the answer; a per-shard scale would add granules of different
    sizes.  The first pass's maxima reach the program unchanged."""
    jb, pb = _shards(4, seed=3)
    jb[0], pb[0] = map(list, zip(_shard(300, 300, qty_scale=1000.0)))
    aggs = (AggSpec("sum", C(QTY).node), AggSpec("count"))
    tm = pmesh.tablet_mesh(4, devices=["cpu"] * 4)
    batch = pds.build_sharded_batch(tm, pb, COLS)
    batch.col_bounds.clear()
    kern = pds.DistributedScanKernel()
    got_aggs, raws = kern.shard_partials(batch, None, aggs)
    assert kern.vmax_passes == 1 and kern.launches == 4
    scales = {float(r[1][0][0]) for r in raws}
    assert len(scales) == 1
    vals = np.concatenate([b[0].fixed[QTY][0][~b[0].fixed[QTY][1]]
                           for b in pb])
    n_total = batch.padded_rows * 4
    k = np.floor(62.0 - np.log2(n_total) - np.log2(np.abs(vals).max()))
    assert scales == {2.0 ** k}
    (total, cnt), counts = kern.run(batch, None, aggs)
    np.testing.assert_allclose(float(total), vals.sum(), rtol=1e-12)
    jm = jmesh.tablet_mesh(4)
    jbat = jds.build_sharded_batch(jm, jb, COLS)
    jbat.col_bounds.clear()
    (jt, _), _ = jds.DistributedScanKernel().run(jbat, None,
                                                 to_jax_aggs(aggs))
    np.testing.assert_allclose(float(total), float(jt), rtol=2e-16 * 2)


@pytest.mark.parametrize("grouped", [False, True])
def test_degenerate_magnitudes_fall_back_to_float(grouped):
    """1e60 quantizes on the widened f64 dynamic path; an inf makes the
    scale NaN, and the float fallback lanes of both shards add (the
    reference's construction, tests/test_sum_precision.py:144)."""
    rows = {"qty": np.array([1e60, 2.5, 1.0, 3.0]),
            "price": np.array([1.0, 2.0, np.inf, 4.0]),
            "flag": np.array([0, 0, 1, 1], np.int32)}
    jb, pb = [], []
    for s in range(2):
        sl = slice(2 * s, 2 * s + 2)
        j, p = block_pair({
            "key_hash": np.arange(2 * s, 2 * s + 2, dtype=np.uint64),
            "ht": np.full(2, 10, np.uint64),
            "write_id": np.zeros(2, np.uint32),
            "tombstone": np.zeros(2, bool), "unique_keys": True,
            "fixed": {QTY: (rows["qty"][sl], np.zeros(2, bool)),
                      PRICE: (rows["price"][sl], np.zeros(2, bool)),
                      FLAG: (rows["flag"][sl], np.zeros(2, bool)),
                      IVAL: (np.arange(2), np.zeros(2, bool))}})
        jb.append([j])
        pb.append([p])
    aggs = (AggSpec("sum", C(QTY).node), AggSpec("sum", C(PRICE).node),
            AggSpec("count"))
    group = GroupSpec(cols=((FLAG, 2, 0),)) if grouped else None
    jm = jmesh.tablet_mesh(2)
    pm = pmesh.tablet_mesh(2, devices=["cpu"] * 2)
    jo, jc = jds.DistributedScanKernel().run(
        jds.build_sharded_batch(jm, jb, COLS), None, to_jax_aggs(aggs),
        to_jax_group(group))
    po, pc = pds.DistributedScanKernel().run(
        pds.build_sharded_batch(pm, pb, COLS), None, aggs, group)
    assert_bitwise(pc, np.asarray(jc), "counts")
    eps = np.finfo(np.float64).eps
    np.testing.assert_allclose(po[0], jo[0], rtol=2 * eps, atol=0)
    np.testing.assert_allclose(po[1], jo[1], rtol=1e-12, atol=0)
    assert np.isinf(np.asarray(po[1])).any()
    if grouped:
        assert float(po[1][0]) == 3.0 and np.isinf(po[1][1])
    else:
        assert abs(float(po[0]) - 1e60) <= 1e-12 * 1e60


def test_compiles_once_across_constants():
    """One program per signature: new constants (and new rows in the
    same bucket) reuse it; another bucket is another program."""
    pm = pmesh.tablet_mesh(8, devices=["cpu"] * 8)
    kern = pds.DistributedScanKernel()
    for trial in range(3):
        _, pb = _shards(8, seed=300 + trial)
        batch = pds.build_sharded_batch(pm, pb, COLS)
        kern.run(batch, (C(QTY) < float(trial)).node, (AggSpec("count"),))
    assert kern.compiles == 1
    assert kern.launches == 3 * 8
    big = [[_shard(5000, 7)[1]]] + [[] for _ in range(7)]
    kern.run(pds.build_sharded_batch(pm, big, COLS), None,
             (AggSpec("count"),))
    assert kern.compiles == 2


@pytest.mark.parametrize("shape", ["hash", "dict"])
def test_unserved_group_shapes_are_refused_by_type(shape):
    """The reference's distributed kernel fails on hash and dictionary
    groups: its shard step unpacks four outputs where a hash-group
    program returns six (ValueError), and its dense-group code unpacks
    a DictGroupSpec's int column ids (TypeError).  The port raises a
    ValueError naming the shape, before any work."""
    if shape == "hash":
        group = HashGroupSpec(cols=(FLAG,))
        jerr, jmatch = ValueError, "too many values to unpack"
    else:
        group = DictGroupSpec(cols=(FLAG,))
        jerr, jmatch = TypeError, "cannot unpack non-iterable int"
    jb, pb = _shards(2, seed=4)
    jm, pm = _meshes(2, 1)
    aggs = (AggSpec("sum", C(QTY).node), AggSpec("count"))
    with pytest.raises(jerr, match=jmatch):
        # a kernel of its own: the reference's cache keys a group by its
        # columns only, so a cached hash-group program would serve it
        jds.DistributedScanKernel().run(
            jds.build_sharded_batch(jm, jb, COLS), None, to_jax_aggs(aggs),
            to_jax_group(group))
    kern = pds.DistributedScanKernel()
    with pytest.raises(ValueError, match=type(group).__name__):
        kern.run(pds.build_sharded_batch(pm, pb, COLS), None, aggs, group)
    assert kern.compiles == 0 and kern.launches == 0


def test_sharded_batch_lanes_match_the_reference():
    """Padding, dtypes, bounds, valid rows and the MVCC lanes (flipped
    int64 key hash and hybrid time) of each slot, against the
    reference's [T, B, N] arrays."""
    jb, pb = _shards(8, seed=5, empty=3)
    jm, pm = _meshes(4, 2)
    jbat = jds.build_sharded_batch(jm, jb, COLS)
    pbat = pds.build_sharded_batch(pm, pb, COLS)
    assert pbat.padded_rows == jbat.padded_rows
    assert pbat.n_rows_per_shard == jbat.n_rows_per_shard
    assert pbat.unique_keys == jbat.unique_keys
    flip = np.uint64(1 << 63)
    for s in range(8):
        t, b = divmod(s, 2)
        for cid in COLS:
            assert_bitwise(pbat.cols[cid][s],
                           np.asarray(jbat.cols[cid])[t, b], f"col {cid}")
            assert_bitwise(pbat.nulls[cid][s],
                           np.asarray(jbat.nulls[cid])[t, b], f"null {cid}")
        assert_bitwise(pbat.valid[s], np.asarray(jbat.valid)[t, b])
        assert_bitwise(pbat.tombstone[s], np.asarray(jbat.tombstone)[t, b])
        for lane in ("key_hash", "ht"):
            got = (getattr(pbat, lane)[s].numpy().view(np.uint64) ^ flip)
            assert_bitwise(got, np.asarray(getattr(jbat, lane))[t, b], lane)
        assert np.array_equal(pbat.write_id[s].numpy(),
                              np.asarray(jbat.write_id)[t, b])


def test_one_device_mesh_copies_each_lane_once():
    _, pb = _shards(4, seed=6)
    pm = pmesh.tablet_mesh(4, devices=["cpu"] * 4)
    pbat = pds.build_sharded_batch(pm, pb, COLS)
    base = pbat.cols[QTY][0].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base
               for t in pbat.cols[QTY])
    assert pbat.bytes_by_device() == {"cpu": sum(
        t.numel() * t.element_size() for lane in
        [pbat.valid, pbat.key_hash, pbat.ht, pbat.write_id, pbat.tombstone]
        + list(pbat.cols.values()) + list(pbat.nulls.values())
        for t in lane)}


def test_single_device_exact_route_unchanged():
    """The exact route's program after row_multiplier and the vmax
    input: the one-device ScanKernel still equals the reference bit for
    bit (static and dynamic scales alike)."""
    from yugabyte_db_tpu.ops.device_batch import build_batch as jbuild
    from yugabyte_db_tpu.ops.scan import ScanKernel as JKernel
    from yugabyte_db_tpu_torch.ops.device_batch import build_batch as pbuild
    from yugabyte_db_tpu_torch.ops.scan import ScanKernel
    from tests.torch_parity import assert_same_run
    j, p = _shard(5000, 9)
    for query in QUERIES.values():
        where, aggs, group = query
        jbat, pbat = jbuild([j], COLS), pbuild([p], COLS, device="cpu")
        jout = JKernel().run(jbat, where, to_jax_aggs(aggs),
                             to_jax_group(group), read_ht=READ_HT)
        pout = ScanKernel(device="cpu").run(pbat, where, aggs, group,
                                            read_ht=READ_HT)
        assert_same_run(jout, pout)


# --- the mesh ------------------------------------------------------------------
def test_tablet_mesh_defaults_and_errors():
    tm = pmesh.tablet_mesh(devices=["cpu"] * 8)
    assert (tm.num_tablet_shards, tm.num_block_shards) == (8, 1)
    tm = pmesh.tablet_mesh(num_block_shards=2, devices=["cpu"] * 7)
    assert (tm.num_tablet_shards, tm.num_block_shards) == (3, 2)
    assert len(tm.devices) == tm.num_shards == 6
    assert tm.lead == torch.device("cpu")
    jm = jmesh.tablet_mesh(num_block_shards=2, devices=jax.devices()[:7])
    assert (jm.num_tablet_shards, jm.num_block_shards) == (3, 2)
    for T, B, n in ((3, 2, 4), (9, 1, 8)):
        with pytest.raises(ValueError) as pe:
            pmesh.tablet_mesh(T, B, devices=["cpu"] * n)
        with pytest.raises(ValueError) as je:
            jmesh.tablet_mesh(T, B, devices=jax.devices()[:n])
        assert str(pe.value) == str(je.value)


def test_tablet_mesh_defaults_to_every_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(DeviceUnavailable):
        pmesh.tablet_mesh()
    with pytest.raises(DeviceUnavailable):
        pmesh.tablet_mesh(2, devices=["cuda:0", "cuda:0"])


def test_build_sharded_batch_needs_one_list_per_slot():
    pm = pmesh.tablet_mesh(4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="need 4 shard block-lists, got 3"):
        pds.build_sharded_batch(pm, [[], [], []], COLS)


# --- sharded vector search -------------------------------------------------------
@pytest.mark.parametrize("T,B", MESHES)
def test_sharded_exact_search_matches_reference(T, B):
    S, n_shard, dim, k = T * B, 96, 24, 8
    rng = np.random.default_rng(11 + S)
    base = rng.normal(size=(S * n_shard, dim)).astype(np.float32)
    q = np.concatenate([base[::max(1, S * n_shard // 20)][:20] + 0.001,
                        rng.normal(size=(12, dim)).astype(np.float32)])
    sharded = base.reshape(S, n_shard, dim)
    jd, ji = jpv.sharded_exact_search(jmesh.tablet_mesh(T, B), q,
                                      jax.numpy.asarray(sharded), k + 1)
    before = ppv.LAUNCHES["sharded_exact_search"]
    pd_, pi = ppv.sharded_exact_search(
        pmesh.tablet_mesh(T, B, devices=["cpu"] * S), q, sharded, k)
    assert ppv.LAUNCHES["sharded_exact_search"] - before == S
    assert pd_.shape == pi.shape == (len(q), k)
    np.testing.assert_allclose(pd_, jd[:, :k], rtol=1e-5,
                               atol=1e-5 * float(jd.max()))
    assert ids_agree(pi, jd, ji, k) >= len(q) // 2
    own = np.arange(0, S * n_shard, max(1, S * n_shard // 20))[:20]
    assert np.array_equal(pi[:20, 0], own)


def test_sharded_exact_search_ties_go_as_in_the_reference():
    """Every slot holds the same rows, so each query ties across all
    slots: the reference's gather order (block shard major, then tablet
    shard) decides which slots' rows come first."""
    rng = np.random.default_rng(2)
    rows = rng.normal(size=(6, 8)).astype(np.float32)
    sharded = np.broadcast_to(rows, (8, 6, 8)).copy()
    q = rows[:3]
    for T, B in ((4, 2), (8, 1), (2, 4)):
        jd, ji = jpv.sharded_exact_search(jmesh.tablet_mesh(T, B), q,
                                          jax.numpy.asarray(sharded), 5)
        pd_, pi = ppv.sharded_exact_search(
            pmesh.tablet_mesh(T, B, devices=["cpu"] * 8), q, sharded, 5)
        assert np.array_equal(pi, np.asarray(ji)), (T, B)
        np.testing.assert_allclose(pd_, jd, rtol=1e-5, atol=1e-5)


def test_sharded_exact_search_takes_tensors_on_their_slots():
    rng = np.random.default_rng(3)
    base = rng.normal(size=(4, 50, 16)).astype(np.float32)
    tm = pmesh.tablet_mesh(4, devices=["cpu"] * 4)
    whole = torch.from_numpy(base.reshape(200, 16))
    views = [whole[50 * s:50 * (s + 1)] for s in range(4)]
    q = base[1, :5] + 0.001
    a = ppv.sharded_exact_search(tm, q, base, 4)
    b = ppv.sharded_exact_search(tm, q, views, 4)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert np.array_equal(b[1][:, 0], 50 + np.arange(5))
    with pytest.raises(ValueError, match="need 4 base slots"):
        ppv.sharded_exact_search(tm, q, views[:3], 4)


class _StubIndex:
    """Fixed per-shard results: what a shard's ANN index returned."""

    def __init__(self, size, d, i):
        self.size, self._d, self._i = size, d, i
        self.asked = []

    def search(self, q, k, **params):
        self.asked.append((k, params))
        return self._d[:, :k], self._i[:, :k]


def _stub_pair(seed):
    rng = np.random.default_rng(seed)
    out = []
    for size in (40, 0, 3, 25):
        kk = min(10, max(size, 1))
        d = np.sort(rng.integers(0, 50, (5, kk)).astype(np.float32), axis=1)
        i = rng.integers(0, max(size, 1), (5, kk)).astype(np.int64)
        i[rng.random((5, kk)) < 0.2] = -1
        if size == 0:
            d[:] = np.inf
            i[:] = -1
        out.append((size, d, i))
    return ([_StubIndex(*x) for x in out], [_StubIndex(*x) for x in out])


@pytest.mark.parametrize("seed", range(3))
def test_sharded_ann_merge_matches_reference(seed):
    q = np.zeros((5, 4), np.float32)
    jidx, pidx = _stub_pair(seed)
    jd, ji = jpv.sharded_ann_search(q, jidx, 10, nprobe=3)
    pd_, pi = ppv.sharded_ann_search(q, pidx, 10, nprobe=3)
    assert_bitwise(pd_, jd, "distances")
    assert_bitwise(pi, ji, "ids")
    assert [x.asked for x in pidx] == [x.asked for x in jidx]
    assert [x.asked[0][0] for x in pidx] == [10, 1, 3, 10]
    ed, ei = ppv.sharded_ann_search(q, [], 4)
    assert np.isinf(ed).all() and (ei == -1).all() and ed.shape == (5, 4)


def test_sharded_ann_search_over_port_indexes():
    """Per-shard two-stage IVF and HNSW indexes, every list probed: the
    merged top-10 recalls the exact answer as the reference's test asks
    (>= 0.9) with non-decreasing distances."""
    from yugabyte_db_tpu_torch.vector import HnswIndex, TwoStageIvfIndex
    rng = np.random.default_rng(7)
    base = rng.normal(size=(2000, 16)).astype(np.float32)
    q = base[:24] + 0.001
    d = ((q ** 2).sum(1)[:, None] + (base ** 2).sum(1)[None, :]
         - 2.0 * q @ base.T)
    ref = np.argsort(d, axis=1, kind="stable")[:, :10]
    parts = np.array_split(base, 4)
    indexes = [TwoStageIvfIndex.build(parts[0], nlists=8, iters=4,
                                      device="cpu"),
               HnswIndex.build(parts[1], m=8, ef_construction=60),
               TwoStageIvfIndex.build(parts[2], nlists=8, iters=4,
                                      device="cpu"),
               HnswIndex.build(parts[3], m=8, ef_construction=60)]
    dd, ii = ppv.sharded_ann_search(q, indexes, k=10, nprobe=8,
                                    ef_search=128)
    assert dd.shape == ii.shape == (len(q), 10)
    assert ((ii >= 0) & (ii < len(base))).all()
    recall = np.mean([len(set(ii[r]) & set(ref[r])) / 10
                      for r in range(len(q))])
    assert recall >= 0.9
    assert bool((np.diff(dd, axis=1) >= -1e-5).all())
