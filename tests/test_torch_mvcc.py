"""The port's MVCC `dedup` mode (yugabyte_db_tpu_torch/ops/scan.py
_mvcc_visible_latest, chosen by ScanKernel.run for a batch without
unique keys at a read point) against the JAX reference on the same rows:
masks, results and counts bit for bit under both device float dtypes.

Inputs are built without rows tied on all four sort keys (key hash,
not-visible, ht, write id): every row gets its own write id.  The
reference's ``lax.sort`` does sort stably by default (``is_stable=True``)
and the port's argsort passes are stable too, so ties agree as well;
``test_rows_tied_on_every_sort_key`` holds that case separately."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yugabyte_db_tpu.ops.device_batch import build_batch as jbuild
from yugabyte_db_tpu.ops.scan import ScanKernel as JKernel
from yugabyte_db_tpu.ops.scan import _mvcc_visible_latest as j_latest
from yugabyte_db_tpu_torch.models import tpch
from yugabyte_db_tpu_torch.ops.device_batch import (build_batch as pbuild,
                                                    flipped_i64_scalar,
                                                    u64_to_flipped_i64)
from yugabyte_db_tpu_torch.ops.expr import Expr
from yugabyte_db_tpu_torch.ops.scan import (AggSpec, GroupSpec, ScanKernel,
                                            _mvcc_visible_latest,
                                            scan_aggregate)
from yugabyte_db_tpu_torch.storage.columnar import ColumnarBlock
from tests.torch_parity import (assert_bitwise, assert_same_run, block_pair,
                                float_dtype, jax_blocks, lineitem_data,
                                port_blocks_from, reference_arrays,
                                to_jax_aggs, to_jax_group)

C = Expr.col
U64_MAX = 2 ** 64 - 1


def _versions(n, n_keys, seed, tomb_frac=0.1, hts=(10, 20, 30, 40),
              kh_extra=()):
    """n rows over n_keys key hashes (a few at the u64 edges), several
    versions each, unique write ids (no four-key ties)."""
    rng = np.random.default_rng(seed)
    keys = np.concatenate([np.asarray(kh_extra, np.uint64),
                           rng.integers(0, 2 ** 63, n_keys, np.uint64)
                           * np.uint64(2)])
    kh = keys[rng.integers(0, len(keys), n)]
    ht = np.asarray(hts, np.uint64)[rng.integers(0, len(hts), n)]
    wid = rng.permutation(n).astype(np.uint32)
    tomb = rng.random(n) < tomb_frac
    fixed = {1: (rng.integers(1, 50, n).astype(np.float64),
                 rng.random(n) < 0.05),
             2: (rng.uniform(900, 105000, n), np.zeros(n, bool)),
             3: (rng.integers(0, 3, n).astype(np.int32), np.zeros(n, bool))}
    return dict(key_hash=kh, ht=ht, write_id=wid, tombstone=tomb,
                fixed=fixed, unique_keys=False)


def _split(d, parts):
    """The rows of `d` as `parts` consecutive blocks."""
    n = len(d["key_hash"])
    cuts = np.linspace(0, n, parts + 1).astype(int)
    out = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        out.append(dict(
            key_hash=d["key_hash"][lo:hi], ht=d["ht"][lo:hi],
            write_id=d["write_id"][lo:hi], tombstone=d["tombstone"][lo:hi],
            fixed={c: (v[lo:hi], m[lo:hi]) for c, (v, m) in
                   d["fixed"].items()}, unique_keys=False))
    return out


def _pair_blocks(d, parts=1):
    pairs = [block_pair(x) for x in _split(d, parts)]
    return [j for j, _ in pairs], [p for _, p in pairs]


QUERIES = {
    "sum_count": (None, (AggSpec("sum", C(1).node), AggSpec("count"),
                         AggSpec("sum", (C(2) * C(1)).node)), None),
    "filtered_minmax": ((C(1) < 30.0).node,
                        (AggSpec("min", C(2).node), AggSpec("max", C(2).node),
                         AggSpec("count", C(1).node)), None),
    "grouped": ((C(2) > 5000.0).node,
                (AggSpec("sum", C(2).node), AggSpec("avg", C(1).node)),
                GroupSpec(cols=((3, 3, 0),))),
}


def _run_both(jblocks, pblocks, where, aggs, group, read_ht, mode):
    cols = sorted(pblocks[0].fixed)
    with float_dtype(mode):
        jbat = jbuild(jblocks, cols)
        pbat = pbuild(pblocks, cols, device="cpu")
    assert not jbat.unique_keys and not pbat.unique_keys
    jout = JKernel().run(jbat, where, to_jax_aggs(aggs), to_jax_group(group),
                         read_ht=read_ht)
    pout = ScanKernel(device="cpu").run(pbat, where, aggs, group,
                                        read_ht=read_ht)
    return jout, pout


# --- the reference's own dedup cases (tests/test_ops_scan.py) ---------------
def test_dedup_newest_visible_wins():
    d = dict(key_hash=np.array([7, 7, 7, 9], np.uint64),
             ht=np.array([10, 20, 30, 15], np.uint64),
             write_id=np.zeros(4, np.uint32), tombstone=np.zeros(4, bool),
             fixed={1: (np.array([1.0, 2.0, 3.0, 50.0]), np.zeros(4, bool))},
             unique_keys=False)
    _, pb = block_pair(d)
    batch = pbuild([pb], [1], device="cpu")
    aggs = (AggSpec("sum", C(1).node), AggSpec("count"))
    (s, c), _, _ = scan_aggregate(batch, None, aggs, read_ht=25)
    assert int(c) == 2 and float(s) == 52.0
    (s2, _), _, _ = scan_aggregate(batch, None, aggs, read_ht=35)
    assert float(s2) == 53.0


def test_dedup_tombstone_hides_row():
    d = dict(key_hash=np.array([7, 7], np.uint64),
             ht=np.array([10, 20], np.uint64),
             write_id=np.zeros(2, np.uint32),
             tombstone=np.array([False, True]),
             fixed={1: (np.array([1.0, 0.0]), np.zeros(2, bool))},
             unique_keys=False)
    _, pb = block_pair(d)
    batch = pbuild([pb], [1], device="cpu")
    (c_after,), _, _ = scan_aggregate(batch, None, (AggSpec("count"),),
                                      read_ht=25)
    assert int(c_after) == 0
    (c_before,), _, _ = scan_aggregate(batch, None, (AggSpec("count"),),
                                       read_ht=15)
    assert int(c_before) == 1
    _, count, mask = ScanKernel(device="cpu").run(batch, None, (),
                                                  read_ht=15)
    assert int(count) == 1 and mask.tolist()[:2] == [True, False]


# --- the mask itself, bit for bit -------------------------------------------
@pytest.mark.parametrize("read_ht", [5, 10, 15, 20, 25, 40, 2 ** 63,
                                     U64_MAX])
@pytest.mark.parametrize("seed", [0, 1])
def test_mask_equals_reference_bit_for_bit(seed, read_ht):
    # key hashes at 0, 2^63 - 1, 2^63 and U64_MAX (an invalid row's sort
    # key) sit on the flipped encoding's edges; padding rows invalid
    d = _versions(3000, 400, seed, kh_extra=(0, 2 ** 63 - 1, 2 ** 63,
                                              U64_MAX))
    n = len(d["key_hash"])
    pad = 1096
    valid = np.zeros(n + pad, bool)
    valid[:n] = True
    rng = np.random.default_rng(seed + 10)

    def padded(a, fill):
        return np.concatenate([a, np.full(pad, fill, a.dtype)])
    kh = padded(d["key_hash"], 0)
    kh[n:] = rng.integers(0, 2 ** 63, pad, np.uint64)   # garbage keys
    ht = padded(d["ht"], 0)
    wid = padded(d["write_id"], 0)
    wid[n:] = np.arange(n, n + pad, dtype=np.uint32)
    tomb = padded(d["tombstone"], False)
    want = np.asarray(j_latest(jnp.asarray(kh), jnp.asarray(ht),
                               jnp.asarray(wid), jnp.asarray(tomb),
                               jnp.asarray(valid), jnp.uint64(read_ht)))
    got = _mvcc_visible_latest(
        torch.from_numpy(u64_to_flipped_i64(kh)),
        torch.from_numpy(u64_to_flipped_i64(ht)),
        torch.from_numpy(wid.astype(np.int64)), torch.from_numpy(tomb),
        torch.from_numpy(valid),
        torch.tensor(flipped_i64_scalar(read_ht)))
    assert_bitwise(got, want, f"mask at {read_ht}")


def test_rows_tied_on_every_sort_key():
    # duplicate (key, ht, write id) rows: both sorts are stable, so the
    # first of the tied rows in index order wins in each
    kh = np.array([5, 5, 5, 6, 6], np.uint64)
    ht = np.array([10, 10, 10, 10, 10], np.uint64)
    wid = np.zeros(5, np.uint32)
    tomb = np.array([False, True, False, True, False])
    valid = np.ones(5, bool)
    want = np.asarray(j_latest(*(jnp.asarray(a) for a in
                                 (kh, ht, wid, tomb, valid)),
                               jnp.uint64(10)))
    got = _mvcc_visible_latest(
        torch.from_numpy(u64_to_flipped_i64(kh)),
        torch.from_numpy(u64_to_flipped_i64(ht)),
        torch.from_numpy(wid.astype(np.int64)), torch.from_numpy(tomb),
        torch.from_numpy(valid), torch.tensor(flipped_i64_scalar(10)))
    assert_bitwise(got, want)


def test_key_hash_collisions_share_one_newest_version():
    # the key is the 64-bit hash, not the doc key: two doc keys hashing
    # alike keep one newest visible version between them
    d = dict(key_hash=np.array([3, 3, 4], np.uint64),
             ht=np.array([10, 12, 11], np.uint64),
             write_id=np.array([0, 1, 2], np.uint32),
             tombstone=np.zeros(3, bool),
             fixed={1: (np.array([1.0, 2.0, 4.0]), np.zeros(3, bool))},
             unique_keys=False)
    jb, pb = block_pair(d)
    aggs = (AggSpec("sum", C(1).node), AggSpec("count"))
    jout, pout = _run_both([jb], [pb], None, aggs, None, 20, "float64")
    assert_same_run(jout, pout)
    assert float(pout[0][0]) == 6.0 and int(pout[0][1]) == 2


# --- whole queries in dedup mode ---------------------------------------------
@pytest.mark.parametrize("read_ht", [5, 15, 25, 35, U64_MAX])
@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_dedup_queries_bitwise(query, mode, read_ht):
    # read points before every version, between versions and after all
    where, aggs, group = QUERIES[query]
    d = _versions(7000, 1500, seed=3)
    jb, pb = _pair_blocks(d, parts=3)
    jout, pout = _run_both(jb, pb, where, aggs, group, read_ht, mode)
    assert_same_run(jout, pout, f"{query}/{mode}/{read_ht}")


@pytest.mark.parametrize("tomb_frac", [0.0, 0.5, 1.0])
def test_tombstones_hide_rows(tomb_frac):
    d = _versions(5000, 900, seed=4, tomb_frac=tomb_frac)
    jb, pb = _pair_blocks(d, parts=2)
    aggs = (AggSpec("count"), AggSpec("sum", C(1).node))
    for read_ht in (15, 45):
        jout, pout = _run_both(jb, pb, None, aggs, None, read_ht, "float64")
        assert_same_run(jout, pout, f"{tomb_frac}/{read_ht}")
    if tomb_frac == 1.0:
        assert int(pout[0][0]) == 0


def test_overlay_and_tombstones_over_a_bulk_load():
    # the shape chip_smoke.py drives at SF1: a bulk load at ht1, an
    # update overlay at ht2 (every 10th rowid) and tombstones at ht3
    # (every 100th), overlay blocks marked unique_keys=False
    data = lineitem_data()
    base = jax_blocks(data, ht=100)
    rowid = np.concatenate([b.pk[tpch.ROWID] for b in base])
    kh = np.concatenate([b.key_hash for b in base])
    up = np.nonzero(rowid % 10 == 0)[0]
    dl = np.nonzero(rowid % 100 == 0)[0]
    rng = np.random.default_rng(2)
    nu = len(up)
    cols = tpch.TPCH_Q1.columns
    full = {c: np.concatenate([b.fixed[c][0] for b in base])
            for c in cols}
    over_fixed = {c: (full[c][up].copy(), np.zeros(nu, bool)) for c in cols}
    over_fixed[tpch.QTY][0][:] = rng.integers(1, 51, nu)
    over_fixed[tpch.EXTPRICE][0][:] = rng.uniform(900, 105000, nu)
    overlay = dict(key_hash=kh[up], ht=np.full(nu, 200, np.uint64),
                   write_id=np.arange(nu, dtype=np.uint32),
                   tombstone=np.zeros(nu, bool), fixed=over_fixed,
                   unique_keys=False)
    nd = len(dl)
    tombs = dict(key_hash=kh[dl], ht=np.full(nd, 300, np.uint64),
                 write_id=np.arange(nd, dtype=np.uint32),
                 tombstone=np.ones(nd, bool),
                 fixed={c: (np.zeros(nd, full[c].dtype), np.ones(nd, bool))
                        for c in cols}, unique_keys=False)
    jo, po = block_pair(overlay)
    jt, pt = block_pair(tombs)
    jb = list(base) + [jo, jt]
    pb = port_blocks_from(base) + [po, pt]
    for read_ht, expect in ((150, "base"), (250, "updated"),
                            (350, "deleted")):
        # the numpy answer at this read point
        eff = dict(data)
        if read_ht >= 200:
            for c, name in ((tpch.QTY, "l_quantity"),
                            (tpch.EXTPRICE, "l_extendedprice")):
                col = np.array(data[name])
                col[rowid[up]] = over_fixed[c][0]
                eff[name] = col
        keep = np.ones(len(rowid), bool)
        if read_ht >= 300:
            keep[rowid[dl]] = False
        eff = {k: v[keep] for k, v in eff.items()}
        ref6 = tpch.numpy_reference(tpch.TPCH_Q6, eff)
        ref1 = tpch.numpy_reference(tpch.TPCH_Q1, eff)
        for q in (tpch.TPCH_Q6, tpch.TPCH_Q1):
            jout, pout = _run_query(jb, pb, q, read_ht)
            assert_same_run(jout, pout, f"{q.name} {expect}")
            if q is tpch.TPCH_Q6:
                assert abs(float(pout[0][0]) - ref6) <= 1e-9 * abs(ref6)
            else:
                counts = np.asarray(pout[1])
                for g in range(6):
                    assert int(counts[g]) == ref1[g][2], (expect, g)
                    assert float(pout[0][0][g]) == ref1[g][0], (expect, g)


def _run_query(jb, pb, q, read_ht):
    with float_dtype("float64"):
        jbat = jbuild(jb, q.columns)
        pbat = pbuild(pb, q.columns, device="cpu")
    jout = JKernel().run(jbat, q.where, to_jax_aggs(q.aggs),
                         to_jax_group(q.group), read_ht=read_ht)
    pout = ScanKernel(device="cpu").run(pbat, q.where, q.aggs, q.group,
                                        read_ht=read_ht)
    return jout, pout


def test_dedup_is_refused_by_the_hand_route():
    from yugabyte_db_tpu_torch.utils import flags
    d = _versions(5000, 900, seed=6)
    _, pb = _pair_blocks(d)
    pbat = pbuild(pb, [1, 2, 3], device="cpu")
    k = ScanKernel(device="cpu")
    aggs = (AggSpec("sum", C(1).node),)
    with flags.overridden("hand_scan_enabled", True):
        out = k.run(pbat, None, aggs, read_ht=25)
    assert out[2] is not None                 # the exact route served it
    assert k.hand_scan_refusals == {"mvcc_or_no_aggs": 1}
    assert_bitwise(out[0][0], k.run(pbat, None, aggs, read_ht=25)[0][0])


def test_unique_blocks_keep_visible_mode():
    # a batch of unique-keyed blocks selects `visible`, not dedup: the
    # signature says so
    data = lineitem_data()
    pb = port_blocks_from(jax_blocks(data))
    pbat = pbuild(pb, tpch.TPCH_Q6.columns, device="cpu")
    k = ScanKernel(device="cpu")
    k.run(pbat, tpch.TPCH_Q6.where, tpch.TPCH_Q6.aggs, read_ht=1000)
    assert [sig[3] for sig in k._cache] == ["visible"]
    pbat.unique_keys = False
    k.run(pbat, tpch.TPCH_Q6.where, tpch.TPCH_Q6.aggs, read_ht=1000)
    assert sorted(sig[3] for sig in k._cache) == ["dedup", "visible"]


def test_reference_arrays_carry_keys_and_varlen():
    data = lineitem_data(5000)
    jb = jax_blocks(data)
    pb = port_blocks_from(jb)
    for j, p in zip(jb, pb):
        assert np.array_equal(j.keys, p.keys)
        assert p.boundary_keys() == (j.keys[0].tobytes(),
                                     j.keys[-1].tobytes())
    d = reference_arrays(jb[0])
    d["ht"] = d["ht"][:-1]
    with pytest.raises(ValueError):
        ColumnarBlock.from_reference_arrays(d)
