"""The port's row compaction (yugabyte_db_tpu_torch/ops/compaction.py
merge_gc_split_kernel, run_merge_gc, compact_runs, concat_runs,
pad_key_matrices, compact_entry_arrays; docdb/compaction.py
_compact_rows and DocDbCompactionFeed; storage/lsm.py compact and
pick_compaction; Tablet.compact(major=False)) against the JAX
reference on the CPU: the whole-input merge's order and keep bit for
bit with the jitted JAX program (mixed key widths, bucket padding, exact
duplicates, u64 extremes, every cutoff), and the row routes writing
byte-identical SSTs — TTL expiry at the history cutoff included — with
``_compact_rows`` and the CPU feed agreeing entry for entry.
Tolerance: none."""
import os

import numpy as np
import pytest

from yugabyte_db_tpu.docdb import compaction as jcomp
from yugabyte_db_tpu.ops import compaction as jops
from yugabyte_db_tpu.utils import hybrid_time as jht
from yugabyte_db_tpu_torch.docdb import compaction as pcomp
from yugabyte_db_tpu_torch.ops import compaction as pops
from yugabyte_db_tpu_torch.utils import hybrid_time as pht
from tests.torch_parity import (flags_set, kv_row, kv_tablet_pair,
                                store_files, write_both)

U64_MAX = (1 << 64) - 1


def _keys(rng, n, width, n_doc=50, ht_lo=1, ht_hi=60, wid_hi=3):
    """[n, width] SubDocKeys over n_doc doc keys (a hash prefix and
    random bytes), hybrid-time suffixes from the given ranges."""
    docs = rng.integers(0, 256, (n_doc, width - 13)).astype(np.uint8)
    docs[:, 0] = 0x08
    dk = docs[rng.integers(0, n_doc, n)]
    ht = (rng.integers(ht_lo, ht_hi, n).astype(np.uint64) << np.uint64(12))
    wid = rng.integers(0, wid_hi, n).astype(np.uint32)
    suf = np.concatenate([np.full((n, 1), 5, np.uint8),
                          (~ht).astype(">u8").view(np.uint8).reshape(n, 8),
                          (~wid).astype(">u4").view(np.uint8).reshape(n, 4)],
                         axis=1)
    return np.concatenate([dk, suf], axis=1)


def _runs(case, seed=0):
    rng = np.random.default_rng(seed)
    if case == "one_width":
        ks = _keys(rng, 5000, 24)
        return [(ks, rng.random(5000) < 0.2)]
    if case == "mixed_widths":
        return [(_keys(rng, n, w), rng.random(n) < 0.2)
                for n, w in ((3000, 21), (1500, 33), (700, 24))]
    if case == "exact_dups":
        ks = _keys(rng, 2000, 24, n_doc=20, wid_hi=1)
        return [(ks, rng.random(2000) < 0.3), (ks[::2].copy(),
                                               rng.random(1000) < 0.3)]
    if case == "bucket_edge":
        return [(_keys(rng, 4096, 27), rng.random(4096) < 0.1)]
    if case == "tiny":
        return [(_keys(rng, 3, 20), np.array([False, True, False]))]
    assert case == "u64_extremes"
    ks = _keys(rng, 600, 24)
    ks[:100, -12:-4] = 0                  # ht = U64_MAX
    ks[100:200, -12:-4] = 0xFF            # ht = 0
    ks[200:300, 0:8] = 0xFF               # a saturated first dockey word
    return [(ks, rng.random(600) < 0.5)]


CASES = ["one_width", "mixed_widths", "exact_dups", "bucket_edge", "tiny",
         "u64_extremes"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("cutoff", ["zero", "middle", "max"])
def test_compact_runs_match_the_jax_program(case, cutoff):
    runs = _runs(case)
    cut = {"zero": 0, "middle": 30 << 12, "max": U64_MAX}[cutoff]
    jo, jk = jops.compact_runs(runs, cut)
    po, pk = pops.compact_runs(runs, cut, device="cpu")
    assert po.dtype == jo.dtype and pk.dtype == jk.dtype
    assert np.array_equal(po, jo) and np.array_equal(pk, jk)
    if len(runs) == 1:
        eo, ek = pops.compact_entry_arrays(runs[0][0], runs[0][1], cut,
                                           device="cpu")
        assert np.array_equal(eo, jo) and np.array_equal(ek, jk)


@pytest.mark.parametrize("case", ["mixed_widths", "exact_dups"])
def test_split_kernel_on_padded_lanes_matches_jax(case):
    """The program itself on a padded bucket with a random valid mask:
    order and keep over every row, padding included."""
    import jax.numpy as jnp
    dk, ht, wid, tomb = jops.concat_runs(_runs(case, seed=4))
    pdk, pht_, pwid, ptomb = pops.concat_runs(_runs(case, seed=4))
    for a, b in ((dk, pdk), (ht, pht_), (wid, pwid), (tomb, ptomb)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    words = jops.keys_to_words(dk)
    assert np.array_equal(pops.keys_to_words(pdk), words)
    n = len(ht)
    valid = np.random.default_rng(1).random(n) < 0.9
    for cut in (0, 25 << 12, U64_MAX):
        jo, jk = jops.merge_gc_split_kernel(
            jnp.asarray(words), jnp.asarray(ht), jnp.asarray(wid),
            jnp.asarray(tomb), jnp.asarray(valid), jnp.uint64(cut),
            num_dk_words=words.shape[1])
        po, pk = pops.merge_gc_split_kernel(
            *pops.to_device_lanes(words, ht, wid, tomb, valid,
                                  pops.resolve_device("cpu")), cut)
        assert np.array_equal(po.numpy(), np.asarray(jo))
        assert np.array_equal(pk.numpy(), np.asarray(jk))


def test_pad_key_matrices_matches_reference():
    rng = np.random.default_rng(2)
    mats = [rng.integers(0, 256, (n, w)).astype(np.uint8)
            for n, w in ((3, 5), (4, 9), (1, 2))]
    assert np.array_equal(pops.pad_key_matrices(mats),
                          jops.pad_key_matrices(mats))


def _ttl_tablets(root, seed=6, n_ops=260):
    """kv tablets whose SSTs hold row blocks with TTL'd values (no
    columnar sidecar), tombstones and replays of one request at the same
    hybrid time in two SSTs (exact duplicates)."""
    jt, pt, jphys, pphys = kv_tablet_pair(root)
    rng = np.random.default_rng(seed)
    for step in range(n_ops):
        us = int(rng.integers(50, 400))
        for phys in (jphys, pphys):
            phys.advance_micros(us)
        k = int(rng.integers(0, 50))
        if rng.random() < 0.2:
            ops = [("delete", {"k": k})]
        else:
            ops = [("upsert", kv_row(rng, k))]
        ttl = int(rng.integers(1, 40)) if rng.random() < 0.4 else None
        write_both(jt, pt, ops, ttl)
        if step % 60 == 59:
            jt.flush()
            pt.flush()
    # a replayed request: the same keys at the same hybrid time, again
    from yugabyte_db_tpu.docdb.operations import RowOp as JOp
    from yugabyte_db_tpu.docdb.operations import WriteRequest as JW
    from yugabyte_db_tpu_torch.docdb.operations import RowOp, WriteRequest
    row = kv_row(rng, 3)
    t = jphys.now_micros()
    for _ in range(2):
        jt.apply_write(JW("t1", [JOp("upsert", dict(row))]),
                       ht=jht.HybridTime.from_micros(t))
        pt.apply_write(WriteRequest("t1", [RowOp("upsert", dict(row))]),
                       ht=pht.HybridTime.from_micros(t))
        jt.flush()
        pt.flush()
    return jt, pt, jphys.now_micros()


@pytest.mark.parametrize("cut_ms", [0, 25, 60, 10 ** 6])
def test_row_routes_write_identical_files(tmp_path, cut_ms):
    """_compact_rows (the device backend on the CPU) and the CPU feed
    (the baseline backend on row inputs): each byte for byte with the
    reference's route, and the two routes entry for entry with each
    other, TTL expiry at the cutoff included."""
    out = {}
    for route in ("device", "baseline"):
        jt, pt, end_us = _ttl_tablets(str(tmp_path / route))
        cutoff = (end_us - cut_ms * 1000) << 12 if cut_ms < 10 ** 6 else 0
        assert any(r.columnar_block(i) is None for r in pt.regular.ssts
                   for i in range(r.num_blocks()))
        jp = jcomp.tpu_compact(jt.regular, jt.codec, cutoff, backend=route)
        pp = pcomp.tpu_compact(pt.regular, pt.codec, cutoff, backend=route,
                               device="cpu")
        assert os.path.basename(jp) == os.path.basename(pp)
        assert store_files(pt.regular) == store_files(jt.regular)
        out[route] = list(pt.regular.iterate())
    assert out["device"] == out["baseline"]
    n_ttl = sum(1 for _, v in out["device"] if v[0] == 0x30)
    assert n_ttl > 0 or cut_ms == 0


def test_ttl_expiry_drops_only_expired_survivors(tmp_path):
    """A row whose TTL expired at or before the cutoff is dropped even as
    its key's newest version at the cutoff; a later-expiring one is
    kept; versions above the cutoff keep their envelope."""
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
    rng = np.random.default_rng(3)
    write_both(jt, pt, [("upsert", kv_row(rng, 1, null_frac=0))], 1)
    write_both(jt, pt, [("upsert", kv_row(rng, 2, null_frac=0))], 10 ** 6)
    for phys in (jphys, pphys):
        phys.advance_micros(50_000)
    write_both(jt, pt, [("upsert", kv_row(rng, 3, null_frac=0))], 1)
    jt.flush()
    pt.flush()
    cutoff = (jphys.now_micros() - 10_000) << 12
    pp = pcomp.tpu_compact(pt.regular, pt.codec, cutoff, device="cpu")
    jcomp.tpu_compact(jt.regular, jt.codec, cutoff)
    assert store_files(pt.regular) == store_files(jt.regular)
    keys = {pt.codec.decode_row(k, pops_inner(v))["k"]
            for k, v in pt.regular.iterate()}
    assert keys == {2, 3} and os.path.exists(pp)


def pops_inner(v):
    from yugabyte_db_tpu_torch.dockv.value import unwrap_ttl
    return unwrap_ttl(v)[0]


def test_minor_compaction_picks_the_oldest_run(tmp_path):
    """Tablet.compact(major=False): nothing under four SSTs, then the
    oldest run through the CPU feed (row inputs, the baseline backend) —
    the same files as the reference."""
    fl = {"tpu_compaction_enabled": False}
    with flags_set(fl, fl):
        jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
        rng = np.random.default_rng(5)
        for i in range(6):
            write_both(jt, pt, [("upsert", kv_row(rng, k))
                                for k in range(i, 40, 3)], 2 if i % 2 else
                       None)
            for phys in (jphys, pphys):
                phys.advance_micros(1000)
            jt.flush()
            pt.flush()
            if i < 2:
                assert pt.compact(major=False) is None
                assert jt.compact(major=False) is None
        jp, pp = jt.compact(major=False), pt.compact(major=False)
        assert os.path.basename(jp) == os.path.basename(pp)
        assert store_files(pt.regular) == store_files(jt.regular)
        assert list(pt.regular.iterate()) == list(jt.regular.iterate())
        assert pt.compact() and jt.compact()
        assert store_files(pt.regular) == store_files(jt.regular)
