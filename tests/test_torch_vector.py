"""Vector search in the port (yugabyte_db_tpu_torch/ops/vector.py and
vector/) against the JAX reference on the same seeded data, on the CPU
(f32 products on both sides): distances and exact search within 1e-5
relative; k-means within 1e-5 on well-separated clusters; the two-stage
IVF device path (``device="cpu"``) against the reference's
``backend="device"``, ids equal wherever the reference's k-th and
(k+1)-th distances differ by more than 1e-4 relative; the numpy twins
(``_cpu_search``, ``_cpu_list_search``, ``merge_topk``) bit for bit;
the HNSW graph arrays equal; and indexes saved by either package load
in the other.  The data has no distance ties."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yugabyte_db_tpu.ops import vector as jv
from yugabyte_db_tpu.vector import AnnIndex as JAnn
from yugabyte_db_tpu.vector import HnswIndex as JHnsw
from yugabyte_db_tpu.vector import TwoStageIvfIndex as JIvf
from yugabyte_db_tpu.vector import registry as jreg
from yugabyte_db_tpu_torch.ops import vector as pv
from yugabyte_db_tpu_torch.vector import AnnIndex as PAnn
from yugabyte_db_tpu_torch.vector import HnswIndex as PHnsw
from yugabyte_db_tpu_torch.vector import TwoStageIvfIndex as PIvf
from yugabyte_db_tpu_torch.vector import ivf as pivf
from yugabyte_db_tpu_torch.vector import registry as preg
from tests.torch_parity import ids_agree

N, DIM, K = 6000, 32, 10
RTOL = 1e-5


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(N, DIM)).astype(np.float32)
    q = np.concatenate([base[:16] + 0.001,
                        rng.normal(size=(16, DIM)).astype(np.float32)])
    return base, q


@pytest.fixture(scope="module")
def ivf_pair(corpus, tmp_path_factory):
    """The reference's index and the port's copy of it (through the
    shared on-disk format), so searches start from equal arrays."""
    base, _ = corpus
    j = JIvf.build(base, nlists=32, iters=5, sample=3000, seed=1)
    path = str(tmp_path_factory.mktemp("ivf") / "idx")
    j.save(path)
    return j, PAnn.load(path, device="cpu")


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("fn", ["l2_distance2", "inner_product",
                                "cosine_distance"])
def test_distances_match_reference(corpus, fn):
    base, q = corpus
    want = np.asarray(getattr(jv, fn)(jnp.asarray(q), jnp.asarray(base)))
    got = getattr(pv, fn)(_t(q), _t(base)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_exact_search_matches_reference(corpus):
    base, q = corpus
    jd, ji = jv.exact_search(jnp.asarray(q), jnp.asarray(base), K + 1)
    pd, pi = pv.exact_search(q, base, K, device="cpu")
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(pd.numpy(), jd[:, :K], rtol=RTOL,
                               atol=RTOL * jd.max())
    assert ids_agree(pi.numpy(), jd, ji, K) >= len(q) // 2
    assert (pi[:16, 0].numpy() == np.arange(16)).all()   # own rows first


def test_kmeans_matches_reference():
    """The same initial rows from the seed; then Lloyd iterations from
    one seed point per cluster (a random start can put two centroids in
    one cluster, whose points then tie within rounding)."""
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(12, 16)).astype(np.float32) * 50
    label = rng.integers(0, 12, 4000)
    data = (centers[label]
            + rng.normal(size=(4000, 16)).astype(np.float32))
    assert np.array_equal(pv.kmeans(data, 12, iters=0, seed=2, device="cpu"),
                          jv.kmeans(data, 12, iters=0, seed=2))
    init = data[[int(np.nonzero(label == c)[0][0]) for c in range(12)]]
    want = np.asarray(jv._kmeans_iters(jnp.asarray(data), jnp.asarray(init),
                                       6))
    got = pv._kmeans_iters(_t(data), _t(init), 6).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


def test_assignment_and_build_match_reference(corpus):
    base, _ = corpus
    j = JIvf.build(base, nlists=32, iters=5, sample=3000, seed=1)
    p = PIvf.build(base, nlists=32, iters=5, sample=3000, seed=1,
                   device="cpu")
    np.testing.assert_allclose(p.cent, j.cent, rtol=RTOL, atol=RTOL)
    assert np.array_equal(p.ids, j.ids)
    assert np.array_equal(p.counts, j.counts)
    assert p.options == j.options


@pytest.mark.parametrize("nprobe,rerank_c,k", [
    (4, None, K), (8, 64, K), (32, None, K), (1, None, 70), (3, 16, 1)])
def test_two_stage_device_path_matches_reference(corpus, ivf_pair, nprobe,
                                                 rerank_c, k):
    base, q = corpus
    j, p = ivf_pair
    jd, ji = j.search(q, k=k + 1, nprobe=nprobe, rerank_c=rerank_c,
                      backend="device")
    pd, pi = p.search(q, k=k, nprobe=nprobe, rerank_c=rerank_c)
    jd_k, ji_k = j.search(q, k=k, nprobe=nprobe, rerank_c=rerank_c,
                          backend="device")
    assert pd.shape == jd_k.shape and pi.dtype == ji_k.dtype
    assert np.array_equal(np.isinf(pd), np.isinf(jd_k))
    assert np.array_equal(pi < 0, ji_k < 0)
    fin = np.isfinite(jd_k)
    np.testing.assert_allclose(pd[fin], jd_k[fin], rtol=RTOL,
                               atol=RTOL * jd_k[fin].max())
    assert ids_agree(pi, jd, ji, k) >= len(q) // 2
    assert p.last_pool_rows == j.last_pool_rows


@pytest.mark.parametrize("nprobe", [1, 5, 32])
def test_two_stage_numpy_twin_bit_for_bit(corpus, ivf_pair, nprobe):
    _, q = corpus
    j, p = ivf_pair
    jd, ji = j.search(q, k=K, nprobe=nprobe, backend="cpu")
    pd, pi = p.search(q, k=K, nprobe=nprobe, backend="cpu")
    assert np.array_equal(pd.view(np.uint32), jd.view(np.uint32))
    assert np.array_equal(pi, ji)
    assert p.last_pool_rows == j.last_pool_rows


def test_tail_merge_matches_reference(corpus, ivf_pair, tmp_path):
    base, q = corpus
    j, p = ivf_pair
    j.save(str(tmp_path / "t"))
    jt = JAnn.load(str(tmp_path / "t"))
    pt = PAnn.load(str(tmp_path / "t"), device="cpu")
    extra = q[:4] * 1.0001
    jt.add(extra)
    pt.add(extra)
    for backend in ("cpu", "device"):
        jd, ji = jt.search(q, k=K, nprobe=4, backend=backend)
        pd, pi = pt.search(q, k=K, nprobe=4, backend=backend)
        assert np.array_equal(pi[:4, 0], np.arange(N, N + 4))
        if backend == "cpu":
            assert np.array_equal(pd.view(np.uint32), jd.view(np.uint32))
            assert np.array_equal(pi, ji)
    assert pt.size == jt.size == N + 4
    assert np.array_equal(pt.vectors_in_id_order(), jt.vectors_in_id_order())
    assert np.array_equal(pt.vector_of(N + 2), jt.vector_of(N + 2))


def test_merge_topk_bit_for_bit():
    rng = np.random.default_rng(9)
    dd = rng.normal(size=(7, 40)).astype(np.float32)
    ii = rng.integers(-1, 500, (7, 40))
    for k in (1, 10, 45):
        pd, pi = preg.merge_topk(dd, ii, k)
        jd, ji = jreg.merge_topk(dd, ii, k)
        assert np.array_equal(pd.view(np.uint32), jd.view(np.uint32))
        assert np.array_equal(pi, ji)


# --- the flat IVF index and its device programs -----------------------------
@pytest.fixture(scope="module")
def flat_arrays(corpus):
    """The reference IvfFlatIndex's arrays, built on the JAX CPU."""
    base, _ = corpus
    j = jv.IvfFlatIndex.build(base, nlists=24, sample=3000, iters=5, seed=0)
    return j, (np.asarray(j.centroids), np.asarray(j.lists),
               np.asarray(j.list_lens))


def test_flat_numpy_twin_bit_for_bit(corpus, flat_arrays):
    base, q = corpus
    j, (cent, lists, lens) = flat_arrays
    p = pv.IvfFlatIndex(cent, lists, lens, base, device="cpu")
    for nprobe in (2, 7):
        jd, ji = j._cpu_list_search(q, K, nprobe)
        pd, pi = p._cpu_list_search(q, K, nprobe)
        assert np.array_equal(pd.view(np.uint32), jd.view(np.uint32))
        assert np.array_equal(pi, ji)


@pytest.mark.parametrize("route", ["probe", "full_scan"])
def test_flat_device_programs_match_reference(corpus, flat_arrays, route):
    base, q = corpus
    _, (cent, lists, lens) = flat_arrays
    p = pv.IvfFlatIndex(cent, lists, lens, base, device="cpu")
    vec, nrm = np.asarray(p._vec), np.asarray(p._nrm)
    if route == "probe":
        jd, ji = jv._ivf_probe_search(
            jnp.asarray(q), jnp.asarray(cent), jnp.asarray(lists),
            jnp.asarray(lens), jnp.asarray(vec.reshape(-1, DIM)),
            jnp.asarray(nrm.reshape(-1)), K + 1, 6)
        qs = q[:3]            # 3 * 6 < 24 lists: search() probes
        pd, pi = p.search(qs, K, nprobe=6)
    else:
        jd, ji = jv._full_scan_search(jnp.asarray(q), jnp.asarray(vec),
                                      jnp.asarray(nrm), K + 1)
        qs = q
        pd, pi = p.search(qs, K, nprobe=6)    # 32 * 6 >= 24: full scan
    jd, ji = np.asarray(jd)[:len(qs)], np.asarray(ji)[:len(qs)]
    np.testing.assert_allclose(pd, jd[:, :K], rtol=RTOL,
                               atol=RTOL * jd.max())
    assert ids_agree(pi, jd, ji, K) >= len(qs) // 2


def test_flat_build_matches_reference(corpus, flat_arrays):
    base, _ = corpus
    _, (cent, lists, lens) = flat_arrays
    p = pv.IvfFlatIndex.build(base, nlists=24, sample=3000, iters=5, seed=0,
                              device="cpu")
    np.testing.assert_allclose(p.centroids.numpy(), cent, rtol=RTOL,
                               atol=RTOL)
    assert np.array_equal(p.lists.numpy(), lists)
    assert np.array_equal(p.list_lens.numpy(), lens)


# --- HNSW and the registry across the two packages ----------------------------
@pytest.fixture(scope="module")
def hnsw_pair(corpus):
    base, _ = corpus
    kw = dict(m=8, ef_construction=40, ef_search=32, seed=5)
    return JHnsw.build(base[:1500], **kw), PHnsw.build(base[:1500], **kw)


def test_hnsw_graph_arrays_equal(hnsw_pair, corpus):
    j, p = hnsw_pair
    assert (p._ep, p._max_level, p._n) == (j._ep, j._max_level, j._n)
    assert np.array_equal(p.levels, j.levels)
    assert len(p._adj) == len(j._adj)
    for a, b in zip(p._adj, j._adj):
        assert np.array_equal(a, b)
    _, q = corpus
    jd, ji = j.search(q, k=K)
    pd, pi = p.search(q, k=K)
    assert np.array_equal(pd, jd) and np.array_equal(pi, ji)


def test_registry_methods_match_reference():
    assert preg.available_methods() == jreg.available_methods()
    for m in ("ivfflat", "ivf", "hnsw"):
        assert preg.get_index_cls(m).method == jreg.get_index_cls(m).method
    with pytest.raises(ValueError, match="unknown vector index method"):
        preg.get_index_cls("annoy")


@pytest.mark.parametrize("method", ["ivfflat", "hnsw"])
@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_save_load_across_packages(corpus, ivf_pair, hnsw_pair, tmp_path,
                                   method, direction):
    """An index saved by one package loads in both with the saved arrays
    and meta, and the two loaded copies search alike (HNSW recomputes
    its norms when it loads, so a loaded copy is compared with a loaded
    copy)."""
    _, q = corpus
    j, p = ivf_pair if method == "ivfflat" else hnsw_pair
    src = j if direction == "reference_to_port" else p
    path = str(tmp_path / "i")
    src.save(path)
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["method"] == method
    assert sorted(os.listdir(path)) == ["index.npz", "meta.json"]
    got, want = PAnn.load(path, device="cpu"), JAnn.load(path)
    for idx in (got, want):
        for name, arr in src._state_arrays().items():
            assert np.array_equal(idx._state_arrays()[name], arr), name
        assert idx._state_meta() == src._state_meta()
    kw = {"backend": "cpu"} if method == "ivfflat" else {}
    gd, gi = got.search(q, k=K, **kw)
    wd, wi = want.search(q, k=K, **kw)
    assert np.array_equal(gd.view(np.uint32), wd.view(np.uint32))
    assert np.array_equal(gi, wi)


def test_torn_index_loads_as_none(tmp_path):
    os.makedirs(tmp_path / "bad")
    (tmp_path / "bad" / "meta.json").write_text("{not json")
    assert preg.load_index(str(tmp_path / "bad"), device="cpu") is None
    assert preg.load_index(str(tmp_path / "absent"), device="cpu") is None


def test_device_searches_are_counted(corpus, ivf_pair):
    _, q = corpus
    _, p = ivf_pair
    pivf.reset_kernel_stats()
    p.search(q, k=K, nprobe=4)
    p.search(q, k=K, nprobe=4)
    p.search(q[:5], k=K, nprobe=4)
    p.search(q, k=K, nprobe=4, backend="cpu")      # the twin: not counted
    st = pivf.kernel_cache_stats()
    assert st["calls"] == 3 and st["signatures"] == 2


def test_vector_entry_points_default_to_cuda(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yugabyte_db_tpu_torch.device import DeviceUnavailable
    base, q = corpus
    with pytest.raises(DeviceUnavailable):
        PIvf.build(base[:500], nlists=4, iters=1)
    with pytest.raises(DeviceUnavailable):
        pv.exact_search(q, base, K)
    with pytest.raises(DeviceUnavailable):
        pv.kmeans(base[:500], 4)
    JIvf.build(base[:500], nlists=4, iters=1).save(str(tmp_path / "i"))
    with pytest.raises(DeviceUnavailable):
        PAnn.load(str(tmp_path / "i"))
