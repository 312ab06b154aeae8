"""GROUP BY in the port against the JAX reference on the same blocks:
HashGroupSpec (sort + segment aggregation, yugabyte_db_tpu_torch/ops/
scan.py) and DictGroupSpec over dictionary-coded string columns
(ops/grouped_scan.py, docdb/operations.py's string rewrite, the
`dictlut` expression node, storage/lane_codec.py).  Outputs, counts,
masks, group values, n_groups and spill counts are held bit for bit
under both device float dtypes; blocks cross over through
ColumnarBlock.from_reference_arrays, string lanes included."""
import numpy as np
import pytest
import torch

from yugabyte_db_tpu.docdb.operations import DocReadOperation
from yugabyte_db_tpu.docdb.table_codec import TableCodec as JCodec
from yugabyte_db_tpu.models import tpch as jtpch
from yugabyte_db_tpu.ops import grouped_scan as jgs
from yugabyte_db_tpu.ops.device_batch import build_batch as jbuild
from yugabyte_db_tpu.ops.expr import compile_expr as j_compile
from yugabyte_db_tpu.ops.scan import ScanKernel as JKernel
from yugabyte_db_tpu.storage import lane_codec as jlc
from yugabyte_db_tpu.utils.hybrid_time import HybridTime as JHT
from yugabyte_db_tpu_torch.docdb import operations as pops
from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec
from yugabyte_db_tpu_torch.models import tpch
from yugabyte_db_tpu_torch.ops import grouped_scan as pgs
from yugabyte_db_tpu_torch.ops import hand_scan as hs
from yugabyte_db_tpu_torch.ops.device_batch import build_batch as pbuild
from yugabyte_db_tpu_torch.ops.expr import Expr, compile_expr
from yugabyte_db_tpu_torch.ops.scan import (AggSpec, HashGroupSpec,
                                            ScanKernel)
from yugabyte_db_tpu_torch.storage import lane_codec as plc
from yugabyte_db_tpu_torch.utils import flags
from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
from tests.torch_parity import (assert_bitwise, assert_same_run, block_pair,
                                flags_set, float_dtype, jax_blocks,
                                lineitem_data, port_blocks_from,
                                to_jax_aggs, to_jax_group)

C = Expr.col
Q, P, D, T, S, R, L = (tpch.QTY, tpch.EXTPRICE, tpch.DISCOUNT, tpch.TAX,
                       tpch.SHIPDATE, tpch.RETFLAG, tpch.LINESTATUS)
Q1 = tpch.TPCH_Q1


@pytest.fixture(scope="module")
def li():
    data = lineitem_data()
    jb = jax_blocks(data)
    return data, jb, port_blocks_from(jb)


@pytest.fixture(scope="module")
def li_str():
    """The string-keyed lineitem, bulk-loaded by the reference, its
    blocks carried across (varlen lanes and key matrix included)."""
    data = tpch.lineitem_str_data(lineitem_data(9000, seed=8))
    jb = JCodec(jtpch.lineitem_str_info()).bulk_blocks(
        data, JHT(1000), block_rows=2048)
    return data, jb, port_blocks_from(jb)


def _both(jb, pb, cols, where, aggs, group, mode="float64", read_ht=None,
          jplan=None, pplan=None, strategy=None):
    sflags = {"scan_group_strategy": strategy} if strategy else {}
    with float_dtype(mode), flags_set(sflags, sflags):
        jbat = jbuild(jb, cols, dict_plan=jplan)
        pbat = pbuild(pb, cols, device="cpu", dict_plan=pplan)
        jout = JKernel().run(jbat, where, to_jax_aggs(aggs),
                             to_jax_group(group), read_ht=read_ht)
        pout = ScanKernel(device="cpu").run(pbat, where, aggs, group,
                                            read_ht=read_ht)
    return jout, pout


# --- HashGroupSpec -----------------------------------------------------------
HASH_CASES = {
    "q1_flags": (Q1.where, Q1.aggs, HashGroupSpec(cols=(R, L))),
    "shipdate": (Q1.where, Q1.aggs, HashGroupSpec(cols=(S,))),
    "shipdate_overflow": (None, (AggSpec("count"), AggSpec("sum", C(Q).node)),
                          HashGroupSpec(cols=(S,), max_groups=64)),
    "minmax_avg": ((C(D) > 0.03).node,
                   (AggSpec("min", C(P).node), AggSpec("max", C(P).node),
                    AggSpec("avg", C(T).node), AggSpec("count", C(Q).node)),
                   HashGroupSpec(cols=(L, R), max_groups=8)),
    "float_key": (None, (AggSpec("sum", C(P).node), AggSpec("count")),
                  HashGroupSpec(cols=(D,), max_groups=16)),
}


@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(HASH_CASES))
def test_hash_group_bitwise(li, case, mode):
    _, jb, pb = li
    where, aggs, group = HASH_CASES[case]
    jout, pout = _both(jb, pb, Q1.columns, where, aggs, group, mode)
    assert len(pout) == 5          # outs, counts, mask, gvals, n_groups
    assert_same_run(jout, pout, f"{case}/{mode}")


def test_hash_group_matches_numpy_and_reports_overflow(li):
    data, _, pb = li
    pbat = pbuild(pb, Q1.columns, device="cpu")
    outs, counts, _, gvals, n_groups = ScanKernel(device="cpu").run(
        pbat, Q1.where, Q1.aggs, HashGroupSpec(cols=(S,)))
    m = data["l_shipdate"] <= 10471
    days, want = np.unique(data["l_shipdate"][m], return_counts=True)
    assert int(n_groups) == len(days)
    live = np.asarray(counts) > 0
    assert np.array_equal(np.asarray(gvals[0])[live], days)
    assert np.array_equal(np.asarray(counts)[live], want)
    # past max_groups the true count still shows; the segments clip
    _, counts, _, _, n_groups = ScanKernel(device="cpu").run(
        pbat, None, (AggSpec("count"),),
        HashGroupSpec(cols=(S,), max_groups=64))
    assert int(n_groups) == len(np.unique(data["l_shipdate"])) > 64
    assert int(np.asarray(counts).sum()) == len(m)


@pytest.mark.parametrize("mode", ["float32", "float64"])
def test_hash_group_null_and_special_float_keys(mode):
    # group values NULL (excluded), -0.0 beside 0.0 (one group), NaN
    # (each row its own group, sorted last) and +-inf
    rng = np.random.default_rng(3)
    n = 4096 + 100
    key = rng.choice(np.array([-0.0, 0.0, 1.5, -2.5, np.inf, -np.inf,
                               np.nan]), n)
    d = dict(key_hash=np.arange(n, dtype=np.uint64),
             ht=np.full(n, 10, np.uint64), write_id=np.zeros(n, np.uint32),
             tombstone=np.zeros(n, bool),
             fixed={1: (key, rng.random(n) < 0.1),
                    2: (rng.integers(1, 50, n).astype(np.float64),
                        np.zeros(n, bool)),
                    3: (rng.uniform(0, 10, n), np.zeros(n, bool))},
             unique_keys=True)
    jb, pb = block_pair(d)
    aggs = (AggSpec("sum", C(2).node), AggSpec("min", C(3).node),
            AggSpec("count"))
    group = HashGroupSpec(cols=(1,), max_groups=2048)
    jout, pout = _both([jb], [pb], [1, 2, 3], None, aggs, group, mode)
    assert_same_run(jout, pout, mode)
    live = np.asarray(pout[1]) > 0
    keys = np.asarray(pout[3][0])[live]
    assert np.isnan(keys).sum() == np.isnan(key[~d["fixed"][1][1]]).sum()


def test_hash_group_in_dedup_mode():
    rng = np.random.default_rng(5)
    n = 6000
    d = dict(key_hash=rng.integers(0, 1500, n).astype(np.uint64),
             ht=rng.choice(np.array([10, 20, 30], np.uint64), n),
             write_id=rng.permutation(n).astype(np.uint32),
             tombstone=rng.random(n) < 0.1,
             fixed={1: (rng.integers(0, 40, n).astype(np.int32),
                        np.zeros(n, bool)),
                    2: (rng.uniform(0, 100, n), np.zeros(n, bool))},
             unique_keys=False)
    jb, pb = block_pair(d)
    for read_ht in (15, 25, 99):
        jout, pout = _both([jb], [pb], [1, 2], None,
                           (AggSpec("sum", C(2).node), AggSpec("count")),
                           HashGroupSpec(cols=(1,), max_groups=64),
                           read_ht=read_ht)
        assert_same_run(jout, pout, str(read_ht))


def test_hash_and_dict_groups_are_refused_by_the_hand_route(li, li_str):
    _, _, pb = li
    k = ScanKernel(device="cpu")
    pbat = pbuild(pb, Q1.columns, device="cpu")
    with flags.overridden("hand_scan_enabled", True):
        out = k.run(pbat, Q1.where, Q1.aggs, HashGroupSpec(cols=(R, L)))
        assert out[2] is not None and len(out) == 5
        _, _, spb = li_str
        sbat = pbuild(spb, Q1.columns, device="cpu")
        out = k.run(sbat, Q1.where, Q1.aggs, tpch.tpch_q1_str().group)
        assert out[2] is not None and len(out) == 4
    assert k.hand_scan_refusals == {"group_shape": 2}


# --- DictGroupSpec -----------------------------------------------------------
def test_port_bulk_load_builds_the_reference_string_blocks(li_str):
    data, jb, _ = li_str
    pb = TableCodec(tpch.lineitem_str_info()).bulk_blocks(
        data, HybridTime(1000), block_rows=2048)
    assert len(pb) == len(jb)
    for j, p in zip(jb, pb):
        for cid in (R, L):
            je, jh, jn = j.varlen[cid]
            pe, ph, pn = p.varlen[cid]
            assert np.array_equal(je, pe) and bytes(jh) == ph
            assert np.array_equal(jn, pn)
        assert np.array_equal(j.keys, p.keys)
        assert np.array_equal(j.key_hash, p.key_hash)
        assert j.unique_keys == p.unique_keys


@pytest.mark.parametrize("planned", [False, True])
@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("strategy", ["segment", "unroll"])
def test_dict_q1_bitwise(li_str, strategy, mode, planned):
    data, jb, pb = li_str
    q = tpch.tpch_q1_str()
    jplan = jgs.make_dict_plan(jb, [R, L]) if planned else None
    pplan = pgs.make_dict_plan(pb, [R, L]) if planned else None
    jout, pout = _both(jb, pb, q.columns, q.where, q.aggs, q.group, mode,
                       jplan=jplan, pplan=pplan, strategy=strategy)
    assert len(pout) == 4 and int(pout[3]) == 0     # no spill
    assert_same_run(jout, pout, f"{strategy}/{mode}/{planned}")
    # keyed by the flag strings, against numpy
    pbat = pbuild(pb, q.columns, device="cpu", dict_plan=pplan)
    outs, counts, spilled = pgs.decode_slot_groups(
        q.group, pbat.dicts, pout[0], pout[1])[:2] + (pout[3],)
    _, _, gv = pgs.decode_slot_groups(q.group, pbat.dicts, pout[0], pout[1])
    ref = tpch.numpy_reference(q, data)
    got = {(a, b): (outs[0][i], int(counts[i]))
           for i, (a, b) in enumerate(zip(*gv))}
    assert set(got) == set(ref)
    for key, (qty, cnt) in got.items():
        assert cnt == ref[key][2] and float(qty) == ref[key][0]


@pytest.mark.parametrize("max_slots", [4, 8])
def test_dict_group_spill(li_str, max_slots):
    # 6 groups + spill need 8 slots: a 4-slot budget spills 3 groups
    _, jb, pb = li_str
    q = tpch.tpch_q1_str()
    group = pgs.DictGroupSpec(cols=(R, L), max_slots=max_slots)
    jout, pout = _both(jb, pb, q.columns, q.where, q.aggs, group)
    assert_same_run(jout, pout, str(max_slots))
    assert (int(pout[3]) > 0) == (max_slots == 4)


def test_dict_group_slot_buckets_and_domains():
    for needed, cap in ((1, 4096), (5, 4096), (7, 8), (9, 8), (3000, 2048),
                        (1 << 21, 1 << 22)):
        assert pgs.slot_bucket(needed, cap) == jgs.slot_bucket(needed, cap)
    dicts = {1: np.array(["A", "N", "R"], object),
             2: np.array(["F", "O"], object), 3: np.array([], object)}
    for cols in ((1,), (1, 2), (2, 3), (3,)):
        spec = pgs.DictGroupSpec(cols=cols, max_slots=16)
        jspec = jgs.DictGroupSpec(cols=cols, max_slots=16)
        (pr, pd), (jr, jd) = (pgs.resolve_group(spec, dicts),
                              jgs.resolve_group(jspec, dicts))
        assert (pr.num_slots, pd) == (jr.num_slots, jd)
        assert pgs.domain_product(spec, dicts) == \
            jgs.domain_product(jspec, dicts)
    with pytest.raises(KeyError):
        pgs.resolve_group(pgs.DictGroupSpec(cols=(9,)), dicts)


# --- string predicates: the rewrite and the dictlut node ---------------------
STRING_WHERES = {
    "eq": C(R).eq("N").node,
    "ne": C(R).ne("R").node,
    "absent": C(R).eq("Z").node,
    "flip": ("cmp", "lt", ("const", "A"), ("col", R)),
    "range": ((C(R) >= "B") & (C(L) < "O")).node,
    "le_gt": ((C(R) <= "N") & (C(L) > "E")).node,
    "between": C(R).between("A", "M").node,
    "in": C(R).isin(["A", "R", "Q"]).node,
    "like": ("like", ("col", L), "%O"),
    "ilike": ("ilike", ("col", R), "n%"),
    "not_like": ("not", ("like", ("col", R), "_")),
    "isnull": ("not", ("isnull", ("col", R))),
    "mixed": ((C(S) <= 10000) & C(R).isin(["A", "N"])).node,
}


@pytest.mark.parametrize("case", sorted(STRING_WHERES))
def test_string_predicate_rewrite_matches_reference(li_str, case):
    data, jb, pb = li_str
    where = STRING_WHERES[case]
    aggs = (AggSpec("count"), AggSpec("sum", C(Q).node),
            AggSpec("min", C(R).node))
    plan = pgs.make_dict_plan(pb, [R, L])
    jplan = jgs.make_dict_plan(jb, [R, L])
    pw, pa = pops.rewrite_where_and_aggs(where, aggs, plan.dicts)
    jw, ja = DocReadOperation.rewrite_where_and_aggs(
        where, to_jax_aggs(aggs), jplan.dicts)
    assert pw == jw
    assert [(a.op, a.expr) for a in pa] == [(a.op, a.expr) for a in ja]
    jout, pout = _both(jb, pb, tpch.TPCH_Q1.columns, jw, pa, None,
                       jplan=jplan, pplan=plan)
    assert_same_run(jout, pout, case)


@pytest.mark.parametrize("where", [
    ("cmp", "eq", ("col", R), ("col", L)),
    ("arith", "add", ("col", R), ("const", 1)),
    ("like", ("col", Q), "1%"),
    ("between", ("col", R), ("const", "A"), ("col", L)),
    ("in", ("col", R), ["A", 1]),
])
def test_unrewritable_string_shapes_raise(where):
    dicts = {R: np.array(["A", "N", "R"], object),
             L: np.array(["F", "O"], object)}
    with pytest.raises(pops.Unrewritable):
        pops.rewrite_strings(where, dicts)
    with pytest.raises(DocReadOperation._Unrewritable):
        DocReadOperation._rewrite_strings(where, dicts)


@pytest.mark.parametrize("lut", [[1, 0, 1], [0], [1, 1, 0, 0, 1, 0, 1]])
def test_dictlut_node_matches_reference(lut):
    # codes outside the table clip to its edges, as jnp.take(clip) does
    import jax.numpy as jnp
    codes = np.array([-3, 0, 1, 2, 5, 1, 0, 9], np.int32)
    nulls = np.array([0, 0, 1, 0, 0, 0, 1, 0], bool)
    node = ("dictlut", ("col", 4), lut)
    const = np.asarray(lut, np.bool_)
    jv, jn = j_compile(node)({4: jnp.asarray(codes)},
                             {4: jnp.asarray(nulls)}, [jnp.asarray(const)])
    pv, pn = compile_expr(node)({4: torch.from_numpy(codes)},
                                {4: torch.from_numpy(nulls)}, [const])
    assert_bitwise(pv, jv)
    assert_bitwise(pn, jn)


def test_dictlut_is_a_typed_refusal_on_the_triton_backend(li_str):
    where = ("dictlut", ("col", R), [1, 0, 1])
    k3 = hs.GenericScan(where, [("count", None)], None, None, (R,), (R,), 1)
    with pytest.raises(hs.HandScanIneligible, match="const_shape"):
        k3.triton_source()
    # ScanKernel's gate refuses the LUT constant before any source is made
    _, _, pb = li_str
    pbat = pbuild(pb, tpch.TPCH_Q1.columns, device="cpu")
    k = ScanKernel(device="cpu")
    with flags.overridden("hand_scan_enabled", True):
        out = k.run(pbat, where, (AggSpec("count"),))
    assert k.hand_scan_refusals == {"const_shape": 1}
    assert int(out[0][0]) == int(out[1])


# --- dictionaries: lane_codec and the plan -------------------------------------
VARLEN_CASES = {
    "flags": ([b"A", b"N", b"R", b"N", b"A"], None),
    "trailing_nul": ([b"a", b"a\x00", b"a", b""], None),
    "nulls": ([b"x", b"", b"yy", b"x"], [False, True, False, False]),
    "utf8": (["é".encode(), b"e", "日本".encode(), b"e"], None),
    "empty": ([], None),
}


@pytest.mark.parametrize("case", sorted(VARLEN_CASES))
def test_varlen_code_rows_and_decode_match_reference(case):
    raws, null = VARLEN_CASES[case]
    ends = np.cumsum([len(r) for r in raws]).astype(np.uint32)
    heap = b"".join(raws)
    null = np.asarray(null, bool) if null is not None else None
    j = jlc.varlen_code_rows(ends, heap, null)
    p = plc.varlen_code_rows(ends, heap, null)
    for a, b in zip(p, j):
        assert_bitwise(a, b, case)
    assert list(plc.decode_dict_strings(p[0], p[1])) == \
        list(jlc.decode_dict_strings(j[0], j[1]))
    # too long, too many distinct values: both refuse alike
    for kw in ({"max_len": 0}, {"max_card": 1}):
        assert (plc.varlen_code_rows(ends, heap, null, **kw) is None) == \
            (jlc.varlen_code_rows(ends, heap, null, **kw) is None)


def test_merge_dicts_remap_and_identity_match_reference():
    a = np.array(["A", "N"], object)
    b = np.array(["N", "R", "Z"], object)
    pg, pr = plc.merge_dicts([a, b])
    jg, jr = jlc.merge_dicts([a, b])
    assert list(pg) == list(jg) == ["A", "N", "R", "Z"]
    for x, y in zip(pr, jr):
        assert_bitwise(x, y)
    assert plc.dict_identity(pg) == jlc.dict_identity(jg)
    assert plc.dict_identity(a) != plc.dict_identity(b)
    assert plc.merge_dicts([])[1] == []


def test_dict_plan_matches_reference(li_str):
    _, jb, pb = li_str
    jp = jgs.make_dict_plan(jb, [R, L])
    pp = pgs.make_dict_plan(pb, [R, L])
    assert pp.identity == jp.identity
    for cid in (R, L):
        assert list(pp.dicts[cid]) == list(jp.dicts[cid])
        for j, p in zip(jb, pb):
            assert_bitwise(pp.block_codes(cid, p), jp.block_codes(cid, j))
    assert pgs.dict_cols_needed(pb, [Q, R, L]) == [R, L]
    assert pgs.make_dict_plan(pb, [R], max_card=2) is None


def test_build_batch_string_columns_without_a_plan(li_str):
    # the per-block dictionary merge, and the row-decode fallback when a
    # block can't dictionary-encode: both give the reference's codes
    _, jb, pb = li_str
    jbat = jbuild(jb, [R, L, S])
    pbat = pbuild(pb, [R, L, S], device="cpu")
    for cid in (R, L):
        assert list(pbat.dicts[cid]) == list(jbat.dicts[cid])
        assert_bitwise(pbat.cols[cid], jbat.cols[cid])
        assert_bitwise(pbat.nulls[cid], jbat.nulls[cid])
    assert R not in pbat.col_bounds and S in pbat.col_bounds
    blk = pb[0]
    blk._vdict_cache[(R, 1 << 16)] = False      # "can't encode"
    try:
        pbat2 = pbuild(pb, [R], device="cpu")
    finally:
        blk._vdict_cache.clear()
    assert list(pbat2.dicts[R]) == list(jbat.dicts[R])
    assert_bitwise(pbat2.cols[R], jbat.cols[R])


# --- block row views and batch options ------------------------------------------
def _same_block(p, j):
    for lane in ("key_hash", "ht", "write_id", "tombstone"):
        assert_bitwise(getattr(p, lane), getattr(j, lane), lane)
    assert p.n == j.n and p.unique_keys == j.unique_keys
    for c in j.pk:
        assert_bitwise(p.pk[c], j.pk[c])
    for c in j.fixed:
        assert_bitwise(p.fixed[c][0], j.fixed[c][0])
        assert_bitwise(p.fixed[c][1], j.fixed[c][1])
    for c in j.varlen:
        assert_bitwise(p.varlen[c][0], j.varlen[c][0])
        assert bytes(p.varlen[c][1]) == bytes(j.varlen[c][1])
        assert_bitwise(p.varlen[c][2], j.varlen[c][2])
    assert (p.keys is None) == (j.keys is None)
    if j.keys is not None:
        assert_bitwise(p.keys, j.keys)


@pytest.mark.parametrize("lo,hi", [(0, 2048), (0, 1), (5, 700), (2047, 2048),
                                   (100, 100)])
def test_block_slice_matches_reference(li_str, lo, hi):
    _, jb, pb = li_str
    _same_block(pb[0].slice(lo, hi), jb[0].slice(lo, hi))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_block_concat_matches_reference(li_str, k):
    from yugabyte_db_tpu.storage.columnar import ColumnarBlock as JBlock
    from yugabyte_db_tpu_torch.storage.columnar import ColumnarBlock
    _, jb, pb = li_str
    _same_block(ColumnarBlock.concat(pb[:k]), JBlock.concat(jb[:k]))


@pytest.mark.parametrize("read_ht", [0, 999, 1000, 2 ** 64 - 1])
def test_visible_mask_matches_reference(li_str, read_ht):
    _, jb, pb = li_str
    assert_bitwise(pb[1].visible_mask(read_ht), jb[1].visible_mask(read_ht))


def test_build_batch_options_match_reference(li):
    # no MVCC lanes, an explicit bucket, and dtype/bounds taken from other
    # blocks (the whole table's) than the ones shipped
    _, jb, pb = li
    cols = list(Q1.columns)
    for mode in ("float32", "float64"):
        with float_dtype(mode):
            jbat = jbuild(jb[1:2], cols, with_mvcc=False, pad_to=8192,
                          bounds_blocks=jb)
            pbat = pbuild(pb[1:2], cols, device="cpu", with_mvcc=False,
                          pad_to=8192, bounds_blocks=pb)
        assert pbat.padded_rows == jbat.padded_rows == 8192
        assert pbat.key_hash is None and pbat.ht is None
        assert pbat.col_bounds == jbat.col_bounds
        for c in cols:
            assert_bitwise(pbat.cols[c], jbat.cols[c], f"{mode} col {c}")
        jout = JKernel().run(jbat, Q1.where, to_jax_aggs(Q1.aggs),
                             to_jax_group(Q1.group))
        pout = ScanKernel(device="cpu").run(pbat, Q1.where, Q1.aggs,
                                            Q1.group)
        assert_same_run(jout, pout, mode)


def test_grouped_stats_count_dict_group_runs(li_str):
    _, _, pb = li_str
    q = tpch.tpch_q1_str()
    pbat = pbuild(pb, q.columns, device="cpu")
    before = pgs.GROUPED_STATS["launches"]
    k = ScanKernel(device="cpu")
    for _ in range(3):
        k.run(pbat, q.where, q.aggs, q.group)
    assert pgs.GROUPED_STATS["launches"] - before == 3
    assert k.compiles == 1      # one signature: slot bucket 8
