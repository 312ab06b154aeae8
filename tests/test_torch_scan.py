"""The port's exact scan route (yugabyte_db_tpu_torch/ops/scan.py
ScanKernel.run, plain torch) against the JAX reference's ScanKernel.run
on the very same rows: results, counts and row masks must be equal bit
for bit — same dtype, same bits — under both device float dtypes
(float32, the card's policy, and float64) and in MVCC modes `none` and
`visible`."""
import numpy as np
import pytest
import torch

from yugabyte_db_tpu.ops.device_batch import build_batch as jbuild
from yugabyte_db_tpu.ops.scan import ScanKernel as JKernel
from yugabyte_db_tpu.storage.columnar import ColumnarBlock as JBlock
from yugabyte_db_tpu_torch.models import tpch
from yugabyte_db_tpu_torch.ops.device_batch import build_batch as pbuild
from yugabyte_db_tpu_torch.ops.scan import (AggSpec, GroupSpec,
                                            HashGroupSpec, ScanKernel)
from yugabyte_db_tpu_torch.storage.columnar import ColumnarBlock
from tests.torch_parity import (assert_bitwise, assert_same_run, flags_set,
                                float_dtype, jax_blocks, lineitem_data,
                                port_blocks_from, reference_arrays,
                                to_jax_aggs, to_jax_group)

C = tpch.C
Q, P, D, T, S, R, L = (tpch.QTY, tpch.EXTPRICE, tpch.DISCOUNT, tpch.TAX,
                       tpch.SHIPDATE, tpch.RETFLAG, tpch.LINESTATUS)
QUERIES = {
    "q6": (tpch.TPCH_Q6.where, tpch.TPCH_Q6.aggs, None),
    "q1": (tpch.TPCH_Q1.where, tpch.TPCH_Q1.aggs, tpch.TPCH_Q1.group),
    "minmax": ((C(S) >= 9000).node,
               (AggSpec("min", C(Q).node), AggSpec("max", C(P).node),
                AggSpec("min", C(D).node), AggSpec("max", C(S).node),
                AggSpec("count", C(T).node)), None),
    "minmax_grouped": (None,
                       (AggSpec("min", C(P).node), AggSpec("max", C(D).node),
                        AggSpec("avg", C(T).node)),
                       GroupSpec(cols=((R, 3, 0),))),
    "int_sum_avg": ((C(D).between(0.02, 0.09) & ~(C(Q) < 10.0)).node,
                    (AggSpec("sum", (C(Q) * C(S)).node),
                     AggSpec("avg", C(Q).node), AggSpec("count")), None),
    "in_list": (C(R).isin([0, 2]).node,
                (AggSpec("sum", (C(P) * (tpch.Expr.const(1.0) + C(T))).node),
                 AggSpec("count")), GroupSpec(cols=((L, 2, 0),))),
}


@pytest.fixture(scope="module")
def blocks():
    data = lineitem_data()
    jb = jax_blocks(data)
    return data, jb, port_blocks_from(jb)


def _batches(blocks, mode, bounds=True):
    _, jb, pb = blocks
    with float_dtype(mode):
        jbat = jbuild(jb, tpch.TPCH_Q1.columns)
        pbat = pbuild(pb, tpch.TPCH_Q1.columns, device="cpu")
    if not bounds:          # no column stats: the dynamic-scale SUM path
        jbat.col_bounds.clear()
        pbat.col_bounds.clear()
    return jbat, pbat


@pytest.mark.parametrize("read_ht", [None, 1000, 999])
@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_exact_route_bitwise(blocks, query, mode, read_ht):
    where, aggs, group = QUERIES[query]
    jbat, pbat = _batches(blocks, mode)
    jout = JKernel().run(jbat, where, to_jax_aggs(aggs), to_jax_group(group),
                         read_ht=read_ht)
    pout = ScanKernel(device="cpu").run(pbat, where, aggs, group,
                                        read_ht=read_ht)
    assert_same_run(jout, pout, f"{query}/{mode}/{read_ht}")


@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("query", ["q6", "q1", "int_sum_avg"])
def test_dynamic_scale_path_matches_reference(blocks, query, mode):
    # without column bounds every float SUM takes the dynamic per-batch
    # scale (device max-reduce) with its float fallback lane.  Counts,
    # masks and integer SUMs stay bit for bit.  Float SUMs differ in the
    # last bits: XLA:CPU's exp2 is inexact (exp2(34) in f32 gives
    # 17179888000, not 2**34), so the reference quantizes at a scale
    # that is not a power of two and rounds each row's product once
    # more; the port keeps the exact 2^k.  Each row then differs by at
    # most one rounding of its value, so the sums agree within 2 eps of
    # the device dtype (positive values: relative error <= eps).
    where, aggs, group = QUERIES[query]
    jbat, pbat = _batches(blocks, mode, bounds=False)
    jo, jc, jm = JKernel().run(jbat, where, to_jax_aggs(aggs), to_jax_group(group))
    po, pc, pm = ScanKernel(device="cpu").run(pbat, where, aggs, group)
    assert_bitwise(pc, jc, "counts")
    assert_bitwise(pm, jm, "mask")
    eps = np.finfo(np.float32 if mode == "float32" else np.float64).eps
    for i, (a, b) in enumerate(zip(po, jo)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, i
        if a.dtype.kind in "iu":
            assert_bitwise(a, b, f"agg {i}")
        else:
            np.testing.assert_allclose(a, b, rtol=2 * eps, atol=0,
                                       err_msg=f"agg {i}")


@pytest.mark.parametrize("strategy", ["segment", "unroll"])
def test_group_strategies_bitwise(blocks, strategy):
    where, aggs, group = QUERIES["q1"]
    jbat, pbat = _batches(blocks, "float32")
    with flags_set({"scan_group_strategy": strategy},
                   {"scan_group_strategy": strategy}):
        jout = JKernel().run(jbat, where, to_jax_aggs(aggs), to_jax_group(group))
        pout = ScanKernel(device="cpu").run(pbat, where, aggs, group)
    assert_same_run(jout, pout, strategy)


@pytest.mark.parametrize("mode", ["float32", "float64"])
def test_visible_mode_with_tombstones_and_versions(blocks, mode):
    # rows written at three hybrid times, some deleted: at read point
    # 1000 only rows with ht <= 1000 and no tombstone count (unique keys)
    _, jb, _ = blocks
    rng = np.random.default_rng(9)
    jmod, pmod = [], []
    for b in jb:
        d = reference_arrays(b)
        d["ht"] = rng.choice(np.array([900, 1000, 1100, 2 ** 63 + 5],
                                      np.uint64), b.n)
        d["tombstone"] = rng.random(b.n) < 0.2
        jmod.append(JBlock.from_arrays(
            d["schema_version"], d["key_hash"], d["ht"], d["write_id"],
            pk=d["pk"], fixed=d["fixed"], tombstone=d["tombstone"],
            unique_keys=True))
        pmod.append(ColumnarBlock.from_reference_arrays(d))
    with float_dtype(mode):
        jbat = jbuild(jmod, tpch.TPCH_Q1.columns)
        pbat = pbuild(pmod, tpch.TPCH_Q1.columns, device="cpu")
    for q in ("q6", "q1"):
        where, aggs, group = QUERIES[q]
        for read_ht in (1000, 2 ** 63 + 4, 2 ** 63 + 5, 2 ** 64 - 1):
            jout = JKernel().run(jbat, where, to_jax_aggs(aggs), to_jax_group(group),
                                 read_ht=read_ht)
            pout = ScanKernel(device="cpu").run(pbat, where, aggs, group,
                                                read_ht=read_ht)
            assert_same_run(jout, pout, f"tomb {q} {read_ht}")


def test_signature_cache_and_compiles(blocks):
    _, pbat = _batches(blocks, "float32")
    k = ScanKernel(device="cpu")
    where, aggs, _ = QUERIES["q6"]
    k.run(pbat, where, aggs)
    k.run(pbat, where, aggs)
    assert k.compiles == 1
    # a different literal is a runtime argument: same signature
    other = (C(S) >= 8000).node
    k.run(pbat, other, aggs)
    k.run(pbat, (C(S) >= 9000).node, aggs)
    assert k.compiles == 2


def test_unported_shapes_raise_naming_the_roadmap(blocks):
    # dedup mode, HashGroupSpec, the streamed scan's prefilter, the
    # bypass reader's fused join plan and its document-path scans are
    # served now (tests/test_torch_mvcc.py, tests/test_torch_grouped.py,
    # tests/test_torch_bypass.py, tests/test_torch_plan.py,
    # tests/test_torch_docstore.py): a doc path over blocks without
    # shredded lanes refuses typed, as the reference's bypass does
    from yugabyte_db_tpu_torch.bypass.scan import (bypass_plan_aggregate,
                                                   bypass_scan_aggregate)
    from yugabyte_db_tpu_torch.ops.join_scan import JoinWire
    from yugabyte_db_tpu_torch.ops.stream_scan import \
        streaming_scan_aggregate
    _, jb, pb = blocks
    _, pbat = _batches(blocks, "float32")
    k = ScanKernel(device="cpu")
    out = k.run(pbat, None, (AggSpec("count"),), HashGroupSpec(cols=(R,)))
    assert int(out[4]) == 3 and int(np.asarray(out[1]).sum()) == \
        pbat.n_rows
    pbat.unique_keys = False
    out = k.run(pbat, None, (AggSpec("count"),), read_ht=1000)
    assert int(out[0][0]) == pbat.n_rows      # one version per key
    got = streaming_scan_aggregate(pb, [S], None, (AggSpec("count"),),
                                   kernel=k, chunk_rows=4096,
                                   prefilter=lambda b: b)
    assert int(got[0][0]) == pbat.n_rows
    rowids = np.concatenate([b.pk[tpch.ROWID] for b in pb])
    join = JoinWire(probe_col=tpch.ROWID, keys=rowids[::2])
    _, counts, _ = bypass_plan_aggregate(pb, None, (AggSpec("count"),),
                                         None, 1000, join, device="cpu")
    assert int(counts) == len(rowids[::2])
    doc = ("cmp", "gt", ("json", "->", ("col", Q), "a"), ("const", 1))
    from yugabyte_db_tpu.bypass.scan import \
        bypass_scan_aggregate as jbypass
    from yugabyte_db_tpu.ops.scan import AggSpec as JAgg
    from yugabyte_db_tpu_torch.bypass.errors import BypassIneligible
    with pytest.raises(BypassIneligible) as e:
        bypass_scan_aggregate(pb, doc, (AggSpec("count"),), None, 1000,
                              device="cpu")
    with pytest.raises(Exception) as je:
        jbypass(jb, doc, (JAgg("count"),), None, 1000)
    assert e.value.reason == "doc_shape"
    assert (e.value.reason, e.value.detail) == \
        (je.value.reason, je.value.detail)
    # no read point: mode none, served
    out = k.run(pbat, None, (AggSpec("count"),))
    assert int(out[0][0]) == pbat.n_rows


def test_result_shapes(blocks):
    _, pbat = _batches(blocks, "float32")
    k = ScanKernel(device="cpu")
    where, aggs, group = QUERIES["q1"]
    outs, counts, mask = k.run(pbat, where, aggs, group)
    assert len(outs) == len(aggs)
    assert all(np.asarray(o).shape == (6,) for o in outs)
    assert counts.dtype == torch.int64 and counts.shape == (6,)
    assert mask.dtype == torch.bool and mask.shape == (pbat.padded_rows,)


def test_kernel_and_batch_device_must_match(blocks):
    _, pbat = _batches(blocks, "float32")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yugabyte_db_tpu_torch.device import DeviceUnavailable
    with pytest.raises(DeviceUnavailable):
        ScanKernel()
    k = ScanKernel(device="cpu")
    k.device = torch.device("meta")
    with pytest.raises(ValueError):
        k.run(pbat, None, (AggSpec("count"),))
