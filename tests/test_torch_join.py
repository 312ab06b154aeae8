"""The port's device hash join (yugabyte_db_tpu_torch/ops/join_scan.py)
against the JAX reference's on the same inputs: table buckets, the host
build table (arrays identical), the home-slot hash in numpy and torch
(keys that set the product's top bit, negative keys, the -2 - row
sentinels), join runtimes for int, exact-float and string keys
(dictionary mapping, sentinels, payload dictionaries and bounds), every
typed refusal with the same reason and stage, the plain torch probe
against the reference ``probe_table`` under ``jax.jit`` on the CPU
(identical match indices), and ``hash_join_cpu``.  Tolerance: none —
every array compares bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yugabyte_db_tpu.ops import join_scan as jjs
from yugabyte_db_tpu_torch.ops import join_scan as pjs
from tests.torch_parity import (BID, PROBE_EDGE_CASES, assert_bitwise,
                                flags_set, probe_edge_case, unpack_table,
                                wire_pair)


@pytest.mark.parametrize("n,cap", [(0, 1 << 16), (4, 1 << 16),
                                   (5, 1 << 16), (256, 1 << 16),
                                   (32768, 1 << 16), (3, 8),
                                   (685_446, 1 << 24)])
def test_table_bucket_matches_reference(n, cap):
    assert pjs.table_bucket(n, cap) == jjs.table_bucket(n, cap)


@pytest.mark.parametrize("n,cap", [(40_000, 1 << 16), (5, 8),
                                   (9_000_000, 1 << 30)])
def test_table_bucket_overflow_is_typed(n, cap):
    with pytest.raises(jjs.JoinIneligible) as je:
        jjs.table_bucket(n, cap)
    with pytest.raises(pjs.JoinIneligible) as pe:
        pjs.table_bucket(n, cap)
    assert pe.value.reason == je.value.reason == pjs.REASON_BUILD_OVERFLOW
    assert str(pe.value) == str(je.value)


def _keys(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "dense":
        return rng.permutation(n).astype(np.int64)
    if kind == "wide":
        return rng.choice(1 << 40, size=n, replace=False).astype(np.int64)
    if kind == "top_bit":
        # keys whose product with the multiplier sets bit 63, and keys
        # at the int64 extremes
        ks = rng.integers(-(1 << 62), 1 << 62, 4 * n, dtype=np.int64)
        top = (ks.astype(np.uint64) * jjs._HASH_MULT) >> np.uint64(63)
        ks = np.unique(ks[top == 1])[:n - 2]
        return np.concatenate([ks, [np.iinfo(np.int64).max,
                                    np.iinfo(np.int64).min]])
    assert kind == "negative"          # sentinels and negative FKs
    return np.concatenate([-2 - np.arange(n // 2, dtype=np.int64),
                           -rng.choice(1 << 30, n - n // 2,
                                       replace=False).astype(np.int64)])


KEY_KINDS = ["dense", "wide", "top_bit", "negative"]


@pytest.mark.parametrize("kind", KEY_KINDS)
@pytest.mark.parametrize("n", [1, 7, 300, 5000])
def test_build_hash_table_matches_reference(kind, n):
    keys = _keys(kind, n)
    S = pjs.table_bucket(len(keys), 1 << 20)
    got = pjs.build_hash_table(keys, S)
    want = jjs.build_hash_table(keys, S)
    for name, a, b in zip(("used", "table_key", "table_val"), got, want):
        assert_bitwise(a, b, name)


@pytest.mark.parametrize("kind", KEY_KINDS)
@pytest.mark.parametrize("slots", [8, 1024, 1 << 21])
def test_home_slots_numpy_and_torch_match_reference(kind, slots):
    keys = _keys(kind, 2000, seed=3)
    want = jjs._home_slots(keys, slots)
    assert_bitwise(pjs._home_slots(keys, slots), want, "numpy")
    got = pjs.home_slots(torch.from_numpy(keys), slots)
    assert_bitwise(got.numpy(), want, "torch")
    got32 = pjs.home_slots(torch.from_numpy(
        keys.astype(np.int32) if kind == "dense" else keys), slots)
    assert_bitwise(got32.numpy(), want, "torch from int32")


def test_linear_probe_invariant():
    # adversarial clustering: every key reachable from its home slot with
    # no empty slot in between (the probe walk's exactness condition)
    keys = _keys("wide", 300)
    S = pjs.table_bucket(len(keys), 1 << 16)
    used, tkey, tval = pjs.build_hash_table(keys, S)
    homes = pjs._home_slots(keys, S)
    for i, k in enumerate(keys):
        s, steps = int(homes[i]), 0
        while True:
            assert used[s], f"empty slot inside the chain of key {k}"
            if tkey[s] == k:
                assert tval[s] == i
                break
            s = (s + 1) & (S - 1)
            steps += 1
            assert steps < S


def _same_runtime(p, j):
    for f in ("probe_col", "num_slots", "build_rows_pad", "n_build",
              "build_cols"):
        assert getattr(p, f) == getattr(j, f), f
    for f in ("used", "table_key", "table_val", "keys_mapped"):
        assert_bitwise(getattr(p, f), getattr(j, f), f)
    for f in ("payload_vals", "payload_nulls"):
        pd, jd = getattr(p, f), getattr(j, f)
        assert pd.keys() == jd.keys(), f
        for b in jd:
            assert_bitwise(pd[b], jd[b], f"{f}[{b}]")
    assert p.payload_dicts.keys() == j.payload_dicts.keys()
    for b in j.payload_dicts:
        assert list(p.payload_dicts[b]) == list(j.payload_dicts[b])
    assert p.payload_bounds == j.payload_bounds
    assert p.shape_signature() == j.shape_signature()


def _runtime_case(case):
    rng = np.random.default_rng(11)
    n = 400
    prio = np.array([f"P{i % 5}" for i in range(n)], object)
    w = rng.integers(1, 10, n).astype(np.int64)
    frac = rng.uniform(-5.0, 5.0, n)
    whole = rng.integers(-50, 50, n).astype(np.float64)
    nulls = np.arange(n) % 7 == 0
    payload = {BID: (prio, None), BID + 1: (w, nulls),
               BID + 2: (frac, None), BID + 3: (whole, nulls)}
    dicts = {}
    if case == "int":
        keys = rng.permutation(1000)[:n].astype(np.int64)
    elif case == "uint32":
        keys = rng.permutation(1000)[:n].astype(np.uint32)
    elif case == "exact_float":
        keys = rng.permutation(1000)[:n].astype(np.float64)
    else:
        # string keys through the probe dictionary: C->1, B absent (a
        # distinct negative sentinel), A->0; payload strings with NULLs
        d = np.array(sorted(f"K{v:03d}" for v in range(0, 600, 2)), object)
        keys = np.array([f"K{v:03d}" for v in rng.permutation(800)[:n]],
                        object)
        payload[BID + 4] = (np.where(nulls, None, prio), nulls)
        dicts = {1: d}
    return keys, payload, dicts


@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("case", ["int", "uint32", "exact_float", "string"])
def test_make_join_runtime_matches_reference(case, mode):
    keys, payload, dicts = _runtime_case(case)
    jw, pw = wire_pair(1, keys, payload)
    with flags_set({"device_float_dtype": mode},
                   {"device_float_dtype": mode}):
        j = jjs.make_join_runtime(jw, dicts, max_slots=1 << 16)
        p = pjs.make_join_runtime(pw, dicts, max_slots=1 << 16,
                                  device="cpu")
    _same_runtime(p, j)
    if case == "string":
        assert (p.keys_mapped < 0).sum() > 0      # absent keys: sentinels
        neg = p.keys_mapped[p.keys_mapped < 0]
        assert len(set(neg.tolist())) == len(neg)
    # the device copies hold the very lanes (here on the CPU): the packed
    # table unpacks to the reference's three arrays
    table, pv, pn = p.device_lanes
    assert table.dtype == torch.int32        # every key fits: narrow
    for name, a, b in zip(("used", "table_key", "table_val"),
                          unpack_table(table), (j.used, j.table_key,
                                                    j.table_val)):
        assert_bitwise(a.numpy(), b, name)
    for b, v, m in zip(p.build_cols, pv, pn):
        assert_bitwise(v.numpy(), p.payload_vals[b])
        assert_bitwise(m.numpy(), p.payload_nulls[b])


def test_string_keys_map_through_probe_dict():
    d = np.array(["A", "C", "D"], object)
    _, pw = wire_pair(9, np.array(["C", "B", "A"], object))
    rt = pjs.make_join_runtime(pw, {9: d}, device="cpu")
    assert rt.keys_mapped[0] == 1 and rt.keys_mapped[2] == 0
    assert rt.keys_mapped[1] == -2 - 1


def test_make_join_runtimes_chain_matches_reference():
    rng = np.random.default_rng(2)
    mid = [wire_pair(1, np.arange(300, dtype=np.int64),
                     {BID: (np.array([f"c{i % 40}" for i in range(300)],
                                     object), None),
                      BID + 1: (rng.integers(1, 9, 300).astype(np.int64),
                                None)}),
           # stage 1 probes stage 0's dict-coded string lane BID
           wire_pair(BID, np.array([f"c{i}" for i in range(0, 60, 3)],
                                   object),
                     {BID + 2: (np.arange(20, dtype=np.int64), None)})]
    j = jjs.make_join_runtimes(tuple(w for w, _ in mid), {})
    p = pjs.make_join_runtimes(tuple(w for _, w in mid), {}, device="cpu")
    assert len(p) == len(j) == 2
    for a, b in zip(p, j):
        _same_runtime(a, b)
    assert pjs.LAST_JOIN_STATS["stages"] == 2
    assert pjs.normalize_join(None) == ()
    assert pjs.normalize_join(mid[0][1]) == (mid[0][1],)


def _refusal_cases():
    dup = np.array([3, 5, 3], np.int64)
    return {
        "duplicate_int": ((wire_pair(1, dup),), {}, {}),
        "duplicate_string": ((wire_pair(1, np.array(["a", "b", "a"],
                                                    object)),),
                             {1: np.array(["a", "b"], object)}, {}),
        "string_without_dict": ((wire_pair(1, np.array(["C"], object)),),
                                {}, {}),
        "fractional_float": ((wire_pair(1, np.array([2.0, 3.5])),), {}, {}),
        "bool_keys": ((wire_pair(1, np.array([True, False])),), {}, {}),
        "overflow": ((wire_pair(1, np.arange(40_000, dtype=np.int64)),),
                     {}, {}),
        "stage_count": ((wire_pair(1, np.arange(4, dtype=np.int64)),
                         wire_pair(2, np.arange(4, dtype=np.int64))),
                        {}, {"max_stages": 1}),
        "payload_collision": (
            (wire_pair(1, np.arange(4, dtype=np.int64),
                       {BID: (np.arange(4), None)}),
             wire_pair(2, np.arange(4, dtype=np.int64),
                       {BID: (np.arange(4), None)})), {}, {}),
        "stage1_duplicate": (
            (wire_pair(1, np.arange(4, dtype=np.int64),
                       {BID: (np.arange(4), None)}),
             wire_pair(BID, np.array([1, 1], np.int64))), {}, {}),
    }


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_typed_refusals_match_reference(case):
    pairs, dicts, kw = _refusal_cases()[case]
    with pytest.raises(jjs.JoinIneligible) as je:
        jjs.make_join_runtimes(tuple(j for j, _ in pairs), dicts, **kw)
    with pytest.raises(pjs.JoinIneligible) as pe:
        pjs.make_join_runtimes(tuple(p for _, p in pairs), dicts,
                               device="cpu", **kw)
    assert pe.value.reason == je.value.reason
    assert pe.value.stage == je.value.stage
    assert str(pe.value) == str(je.value)


def test_build_cap_follows_the_flag():
    _, pw = wire_pair(1, np.arange(53_404, dtype=np.int64))
    with pytest.raises(pjs.JoinIneligible) as e:
        pjs.make_join_runtime(pw, {}, device="cpu")
    assert e.value.reason == pjs.REASON_BUILD_OVERFLOW
    with flags_set({}, {"join_max_build_slots": 1 << 24}):
        rt = pjs.make_join_runtime(pw, {}, device="cpu")
    assert rt.num_slots == 131072


_JPROBE = jax.jit(jjs.probe_table, static_argnums=(4,))


def _packings(used, tkey, tval):
    """The packed tables of one host table: the 16-byte slots, and the
    8-byte ones where every build key fits in int32."""
    used, tkey, tval = (torch.from_numpy(np.asarray(a))
                        for a in (used, tkey, tval))
    out = [pjs.pack_table(used, tkey, tval, pjs.SLOT_WIDE)]
    if pjs.fits_narrow(tkey, used):
        out.append(pjs.pack_table(used, tkey, tval, pjs.SLOT_NARROW))
    return out


@pytest.mark.parametrize("key_dtype", ["int32", "int64"])
@pytest.mark.parametrize("load", [0.05, 0.3, 0.5])
@pytest.mark.parametrize("kind", ["dense", "wide", "negative"])
def test_plain_probe_matches_reference_probe(kind, load, key_dtype):
    rng = np.random.default_rng(5)
    S = 4096
    n_build = int(S * load)
    keys = _keys(kind, n_build, seed=8)
    if key_dtype == "int32":
        keys = np.clip(keys, -2**31, 2**31 - 1)
        keys = np.unique(keys)
    used, tkey, tval = jjs.build_hash_table(keys, S)
    # probe: hits, misses (keys absent from the build side) and repeats
    probe = np.concatenate([rng.choice(keys, 6000),
                            rng.integers(-(1 << 31), 1 << 31, 3000)])
    probe = probe.astype(key_dtype)
    want = np.asarray(_JPROBE(jnp.asarray(probe), jnp.asarray(used),
                              jnp.asarray(tkey), jnp.asarray(tval), S))
    for table in _packings(used, tkey, tval):
        got = pjs.probe_table(torch.from_numpy(probe), table, S)
        assert_bitwise(got.numpy(), want, f"midx ({table.dtype} slots)")
    assert (want >= 0).sum() >= 6000


def test_probe_rows_folds_nulls_and_matches_on_the_cpu():
    keys = np.arange(0, 200, 2, dtype=np.int64)
    S = pjs.table_bucket(len(keys), 1 << 16)
    table = pjs.pack_table(*(torch.from_numpy(a) for a in
                             pjs.build_hash_table(keys, S)))
    pk = torch.arange(100, dtype=torch.int64)
    nulls = pk % 5 == 0
    mask = pk < 90
    midx, out = pjs.probe_rows(pk, nulls, mask, table, S)
    assert torch.equal(midx, pjs.probe_table(pk, table, S))
    want = mask & ~nulls & (pk % 2 == 0)
    assert torch.equal(out, want)
    assert torch.equal(midx[pk % 2 == 0], (pk[pk % 2 == 0] // 2).int())
    from yugabyte_db_tpu_torch.ops.hand_scan import LAUNCHES
    before = LAUNCHES["join_probe"]
    pjs.probe_rows(pk, None, mask, table, S)
    assert LAUNCHES["join_probe"] == before       # the plain version


def test_hash_join_cpu_dangling_and_empty():
    probe = np.array([5, 0, 99, 2], np.int64)
    build = np.array([2, 5, 7], np.int64)
    got = pjs.hash_join_cpu(probe, build)
    assert list(got) == [1, -1, -1, 0]
    assert list(pjs.hash_join_cpu(probe, np.zeros(0, np.int64))) \
        == [-1, -1, -1, -1]


@pytest.mark.parametrize("kind", KEY_KINDS)
def test_hash_join_cpu_matches_reference_and_the_probe(kind):
    rng = np.random.default_rng(4)
    keys = _keys(kind, 500, seed=6)
    probe = np.concatenate([rng.choice(keys, 2000),
                            rng.integers(-1000, 1000, 500)])
    got = pjs.hash_join_cpu(probe, keys)
    assert_bitwise(got, jjs.hash_join_cpu(probe, keys))
    S = pjs.table_bucket(len(keys), 1 << 16)
    for table in _packings(*pjs.build_hash_table(keys, S)):
        walked = pjs.probe_table(torch.from_numpy(probe), table, S)
        assert_bitwise(walked.numpy(), got, f"probe vs twin ({table.dtype})")


def test_join_wire_signature_matches_reference():
    jw, pw = wire_pair(3, np.arange(4, dtype=np.int64),
                       {BID + 1: (np.arange(4), None),
                        BID: (np.array(list("abcd"), object), None)})
    assert pw.signature() == jw.signature()


# --- the packed device table (pack_table) and the plain probe over it ------

def _reference_probe(probe, used, tkey, tval, S):
    return np.asarray(_JPROBE(jnp.asarray(probe), jnp.asarray(used),
                              jnp.asarray(tkey), jnp.asarray(tval), S))


def _unpacks_to(table, used, tkey, tval):
    for name, a, b in zip(("used", "table_key", "table_val"),
                          unpack_table(table), (used, tkey, tval)):
        assert_bitwise(a.numpy(), b, f"{name} ({table.dtype} slots)")


@pytest.mark.parametrize("probe_dtype", ["int32", "int64"])
@pytest.mark.parametrize("load", [0.05, 0.25, 0.5])
def test_packed_probe_matches_reference(load, probe_dtype):
    """pack_table -> the plain probe_table on seeded tables up to the
    builder's 0.5 load factor, against the reference's probe_table on
    the host arrays: midx bit for bit on both slot layouts."""
    rng = np.random.default_rng(int(load * 100))
    S = 1 << 14
    keys = rng.choice(np.arange(-(1 << 31), (1 << 31) - 1, 7919),
                      int(S * load), replace=False).astype(np.int64)
    used, tkey, tval = jjs.build_hash_table(keys, S)
    probe = np.concatenate([rng.choice(keys, 5000),
                            rng.integers(-(1 << 31), 1 << 31, 3000)])
    if probe_dtype == "int64":
        # near misses: a build key moved by 2^32, or with bit 63 set
        probe = np.concatenate([probe, rng.choice(keys, 500) + (1 << 32),
                                rng.choice(keys, 500) ^ (-(1 << 63))])
    probe = probe.astype(probe_dtype)
    want = _reference_probe(probe, used, tkey, tval, S)
    tables = _packings(used, tkey, tval)
    assert [t.dtype for t in tables] == [torch.int64, torch.int32]
    for table in tables:
        _unpacks_to(table, used, tkey, tval)
        got = pjs.probe_table(torch.from_numpy(probe), table, S)
        assert_bitwise(got.numpy(), want, f"midx ({table.dtype} slots)")
    assert (want >= 0).sum() >= 5000


@pytest.mark.parametrize("case", PROBE_EDGE_CASES)
def test_packed_probe_edge_cases_match_reference(case):
    """Chains that wrap from slot S-1 to 0, keys with bit 63 set, the
    int64 extremes, an empty table (n_build 0), probe keys that differ
    from a build key only above bit 31 (misses, never truncated into a
    match by the narrow slots), an all-masked batch and NULL keys:
    probe_table and probe_rows on the packed table against the
    reference's probe_table, bit for bit."""
    keys, probe, mask, nulls = probe_edge_case(case)
    S = 64 if case == "wrap" else pjs.table_bucket(len(keys), 1 << 16)
    used, tkey, tval = jjs.build_hash_table(keys, S)
    if case == "wrap":
        # the chain really wraps: slot 0 holds a key whose home is S - 1
        assert used[S - 1] and used[0]
        assert pjs._home_slots(tkey[:1], S)[0] == S - 1
    want = _reference_probe(probe, used, tkey, tval, S)
    if case in ("empty", "high_bits"):
        assert (want == -1).all()
    else:
        assert (want >= 0).any() and (want == -1).any()
    pk = torch.from_numpy(probe)
    m = torch.from_numpy(mask)
    nl = torch.from_numpy(nulls) if nulls is not None else None
    live = mask & ~nulls if nulls is not None else mask
    for table in _packings(used, tkey, tval):
        _unpacks_to(table, used, tkey, tval)
        got = pjs.probe_table(pk, table, S)
        assert_bitwise(got.numpy(), want, f"midx ({table.dtype} slots)")
        midx, out = pjs.probe_rows(pk, nl, m, table, S)
        assert_bitwise(midx.numpy(), want, "probe_rows midx")
        assert_bitwise(out.numpy(), live & (want >= 0), "probe_rows mask")
        if case == "all_masked":
            assert not out.any()


def test_pack_table_layouts_and_refusals():
    keys = np.array([5, -7, (1 << 31) - 1, -(1 << 31)], np.int64)
    S = 8
    used, tkey, tval = (torch.from_numpy(a) for a in
                        pjs.build_hash_table(keys, S))
    wide = pjs.pack_table(used, tkey, tval, pjs.SLOT_WIDE)
    narrow = pjs.pack_table(used, tkey, tval, pjs.SLOT_NARROW)
    assert wide.shape == narrow.shape == (S, 2)
    assert wide.element_size() * 2 == 16 and narrow.element_size() * 2 == 8
    # an empty slot is val -1 (sign-extended in the wide slot's pad)
    assert bool((wide[~used, 1] == -1).all())
    assert bool((narrow[~used, 1] == -1).all())
    assert bool((narrow[used, 1] == tval[used]).all())
    assert pjs.slot_layout(tkey, used) == pjs.SLOT_NARROW
    big = torch.from_numpy(np.array([1 << 31], np.int64))
    bu, bk, bv = (torch.from_numpy(a) for a in
                  pjs.build_hash_table(big.numpy(), S))
    assert not pjs.fits_narrow(bk, bu)
    assert pjs.slot_layout(bk, bu) == pjs.SLOT_WIDE
    with pytest.raises(ValueError, match="int32"):
        pjs.pack_table(bu, bk, bv, pjs.SLOT_NARROW)
    with pytest.raises(ValueError, match="slot_bytes"):
        pjs.pack_table(used, tkey, tval, 12)


def test_probe_kernel_checks_its_lanes_before_launching():
    """The kernel wrapper's refusals (raised before any build or launch,
    so they show on CPU tensors too): a table that is not packed, a table
    view off 16-byte alignment, lanes of different lengths."""
    S = 16
    used, tkey, tval = (torch.from_numpy(a) for a in pjs.build_hash_table(
        np.arange(5, dtype=np.int64), S))
    table = pjs.pack_table(used, tkey, tval, pjs.SLOT_NARROW)
    pk = torch.arange(40, dtype=torch.int64)
    mask = torch.ones(40, dtype=torch.bool)
    with pytest.raises(ValueError, match="packed table"):
        pjs.probe_kernel(pk, None, mask, tkey, S)
    with pytest.raises(ValueError, match="num_slots"):
        pjs.probe_kernel(pk, None, mask, table, 2 * S)
    buf = torch.zeros(2 * S + 4, dtype=torch.int32)
    off = buf[1:1 + 2 * S].view(S, 2)
    with pytest.raises(ValueError, match="aligned"):
        pjs.probe_kernel(pk, None, mask, off, S)
    with pytest.raises(ValueError, match="length"):
        pjs.probe_kernel(pk, None, mask[:30], table, S)
