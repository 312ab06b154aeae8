"""The grouped spill tail in the port (yugabyte_db_tpu_torch/docdb/
operations.py ``_grouped_spill_merge``, ``_spill_merge_tail`` and
``_monolithic_spill_merge``; ops/grouped_scan.py
``grouped_aggregate_cpu``) against the JAX reference on the same rows: a
dictionary GROUP BY past its slot budget answers through Tablet.read as
the reference's does, bit for bit, on the streamed and the monolithic
route (one SST, and two overlapping SSTs read in MVCC mode ``dedup``),
under both device float dtypes; the numpy twin equals the reference's
bit for bit; with ``grouped_spill_merge_enabled`` off both fall to the
interpreted GROUP BY; and dictionary MIN/MAX cross the combine as
strings."""
import numpy as np
import pytest

from yugabyte_db_tpu.docdb.table_codec import TableCodec as JCodec
from yugabyte_db_tpu.models import tpch as jtpch
from yugabyte_db_tpu.ops import grouped_scan as jgs
from yugabyte_db_tpu.utils.hybrid_time import HybridTime as JHT
from yugabyte_db_tpu_torch.models import tpch
from yugabyte_db_tpu_torch.ops import grouped_scan as pgs
from yugabyte_db_tpu_torch.ops import stream_scan as pss
from yugabyte_db_tpu_torch.ops.expr import Expr
from yugabyte_db_tpu_torch.ops.scan import AggSpec
from tests.torch_parity import (TABLET_BASE_US, assert_bitwise,
                                assert_same_cpu_response,
                                assert_same_response, flags_set,
                                float_dtype, lineitem_data,
                                port_blocks_from, requests, tablet_pair,
                                to_jax_aggs, to_jax_group)

C = Expr.col
Q, P, D, S, R, L = (tpch.QTY, tpch.EXTPRICE, tpch.DISCOUNT, tpch.SHIPDATE,
                    tpch.RETFLAG, tpch.LINESTATUS)
Q1 = tpch.TPCH_Q1
CHUNK = 16384          # streaming_chunk_rows: 4 blocks of 4096 rows
ROWS = 40_000
READ_HT = (TABLET_BASE_US + 1000) << 12     # above every load

# the spilling shapes: (where, aggregates, group columns).  Six
# (returnflag, linestatus) groups need 8 slots, so a 4-slot budget
# keeps 3 groups on the device and spills 3.
SHAPES = {
    "q1": (Q1.where, Q1.aggs, (R, L)),
    "q1_swapped": (Q1.where, Q1.aggs, (L, R)),
    "no_where": (None, (AggSpec("count"), AggSpec("sum", C(Q).node),
                        AggSpec("avg", C(D).node)), (R, L)),
    "string_where": ((C(L).eq("F") | (C(S) < 9000)).node,
                     (AggSpec("sum", C(P).node), AggSpec("count")),
                     (R, L)),
    "dict_minmax": (Q1.where,
                    (AggSpec("min", C(L).node), AggSpec("max", C(R).node),
                     AggSpec("min", C(P).node), AggSpec("count")),
                    (R, L)),
}


def _flags(mode, streamed=True, **extra):
    both = {"device_float_dtype": mode, "streaming_chunk_rows": CHUNK,
            "streaming_scan_enabled": streamed}
    both.update(extra)
    return flags_set(both, both)


@pytest.fixture(scope="module")
def data():
    return lineitem_data(ROWS, seed=21)


@pytest.fixture(scope="module")
def tablets(tmp_path_factory, data):
    """The string-flag lineitem in both packages: one SST ('one'), and
    an overlay of a third of the rows re-written 500 µs later ('two')."""
    root = tmp_path_factory.mktemp("spill")
    overlay = np.arange(ROWS) % 3 == 0
    return {"one": tablet_pair(str(root / "one"), "str", data,
                               block_rows=4096),
            "two": tablet_pair(str(root / "two"), "str", data,
                               block_rows=4096,
                               loads=((0, None), (500, overlay)))}


def _stats():
    return (pgs.GROUPED_STATS["spill_merges"],
            pgs.GROUPED_STATS["spill_fallbacks"],
            jgs.GROUPED_STATS["spill_merges"],
            jgs.GROUPED_STATS["spill_fallbacks"])


def _read(tablets, layout, shape, max_slots=4):
    where, aggs, cols = SHAPES[shape]
    (jt,), (pt,) = tablets[layout]
    group = pgs.DictGroupSpec(cols=cols, max_slots=max_slots)
    jreq, preq = requests("lineitem_s", where, aggs, group, READ_HT)
    return pt.read(preq), jt.read(jreq)


@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("route", ["streamed", "monolithic"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_spill_merge_matches_reference(tablets, shape, route, mode):
    """One SST: the streamed route (chunk-safe blocks) and the monolithic
    route each merge, in both packages, to the same answer; counted as
    one spill merge each, no fallback."""
    before = _stats()
    pss.LAST_STREAM_STATS.clear()
    with _flags(mode, streamed=route == "streamed"):
        presp, jresp = _read(tablets, "one", shape)
    assert_same_response(presp, jresp, f"{shape} {route} {mode}")
    assert bool(pss.LAST_STREAM_STATS) == (route == "streamed")
    after = _stats()
    assert after == (before[0] + 1, before[1], before[2] + 1, before[3])


@pytest.mark.parametrize("shape", ["q1", "dict_minmax"])
def test_spill_merge_over_overlapping_ssts(tablets, shape):
    """Two overlapping SSTs are not chunk-safe: the streamed route
    declines and the monolithic route merges in MVCC mode dedup."""
    before = _stats()
    with _flags("float64"):
        presp, jresp = _read(tablets, "two", shape)
    assert_same_response(presp, jresp, f"{shape} dedup")
    assert _stats()[0] == before[0] + 1


def test_spill_merge_answers_match_numpy(tablets, data):
    """Q1 over 6 groups in a 4-slot budget equals a numpy group-by of
    the rows (counts exactly, sums within f64 rounding)."""
    ref = tpch.numpy_reference(tpch.tpch_q1_str(), tpch.lineitem_str_data(
        data))
    for route in ("streamed", "monolithic"):
        with _flags("float64", streamed=route == "streamed"):
            presp, _ = _read(tablets, "one", "q1")
        got = {(a, b): i for i, (a, b) in enumerate(zip(
            *presp.group_values))}
        assert set(got) == set(ref)
        for key, i in got.items():
            qsum, psum, cnt = ref[key]
            assert int(presp.group_counts[i]) == cnt
            assert float(presp.agg_values[0][i]) == qsum
            assert abs(float(presp.agg_values[1][i]) - psum) <= \
                1e-12 * abs(psum)


@pytest.mark.parametrize("route", ["streamed", "monolithic"])
@pytest.mark.parametrize("shape", ["q1", "string_where", "dict_minmax"])
def test_flag_off_is_the_interpreted_group_by(tablets, shape, route):
    """grouped_spill_merge_enabled off: the spill falls to the
    interpreted GROUP BY in both packages (counted as a fallback), and
    that answer equals the port's own interpreted route."""
    before = _stats()
    with _flags("float64", streamed=route == "streamed",
                grouped_spill_merge_enabled=False):
        presp, jresp = _read(tablets, "one", shape)
    assert_same_cpu_response(presp, jresp, f"{shape} {route} off")
    after = _stats()
    assert after == (before[0], before[1] + 1, before[2], before[3] + 1)
    with _flags("float64", grouped_pushdown_enabled=False):
        interp, _ = _read(tablets, "one", shape)
    assert_same_cpu_response(presp, interp, f"{shape} interpreted")


@pytest.mark.parametrize("route", ["streamed", "monolithic"])
def test_dict_minmax_cross_the_combine_as_strings(tablets, route):
    """MIN/MAX over a dictionary column: the device's code lanes decode
    to strings before the combine, so every group, hot or spilled,
    answers with the group's own strings."""
    with _flags("float64", streamed=route == "streamed"):
        presp, jresp = _read(tablets, "one", "dict_minmax")
    assert_same_response(presp, jresp, route)
    rf, ls = presp.group_values
    for i in range(len(presp.group_counts)):
        assert type(presp.agg_values[0][i]) is str
        assert presp.agg_values[0][i] == ls[i]
        assert presp.agg_values[1][i] == rf[i]


@pytest.mark.parametrize("max_slots", [4, 8])
def test_spill_merge_matches_a_budget_that_fits(tablets, max_slots):
    """The merged answer (4 slots) and the unspilled one (8 slots) hold
    the same groups with the same counts and integer sums."""
    with _flags("float64"):
        presp, _ = _read(tablets, "one", "q1", max_slots=max_slots)
        full, _ = _read(tablets, "one", "q1", max_slots=8)
    by = {k: i for i, k in enumerate(zip(*presp.group_values))}
    for j, k in enumerate(zip(*full.group_values)):
        i = by[k]
        assert int(presp.group_counts[i]) == int(full.group_counts[j])
        assert float(presp.agg_values[0][i]) == float(full.agg_values[0][j])


# --- the numpy twin ----------------------------------------------------------
@pytest.fixture(scope="module")
def li_str():
    data = tpch.lineitem_str_data(lineitem_data(9000, seed=8))
    jb = JCodec(jtpch.lineitem_str_info()).bulk_blocks(
        data, JHT(1000), block_rows=2048)
    return data, jb, port_blocks_from(jb)


TWIN_CASES = {
    "q1_spill": (Q1.where, Q1.aggs, (R, L), 4),
    "q1_fits": (Q1.where, Q1.aggs, (R, L), 16),
    "minmax": (None, (AggSpec("min", C(P).node), AggSpec("max", C(S).node),
                      AggSpec("min", C(L).node), AggSpec("count")),
               (L, R), 4),
    "filtered": (((C(S) < 9500) & (C(D) >= 0.02)).node,
                 (AggSpec("sum", C(Q).node), AggSpec("avg", C(D).node)),
                 (R,), 4),
}


@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("read_ht", [None, 1000, 999])
@pytest.mark.parametrize("case", sorted(TWIN_CASES))
def test_grouped_aggregate_cpu_bit_for_bit(li_str, case, read_ht, mode):
    _, jb, pb = li_str
    where, aggs, cols, slots = TWIN_CASES[case]
    spec = pgs.DictGroupSpec(cols=cols, max_slots=slots)
    columns = sorted(set(Q1.columns) | set(cols))
    with float_dtype(mode):
        jout = jgs.grouped_aggregate_cpu(
            jb, columns, where, to_jax_aggs(aggs), to_jax_group(spec),
            read_ht=read_ht)
        pout = pgs.grouped_aggregate_cpu(
            pb, columns, where, aggs, spec, read_ht=read_ht, device="cpu")
    assert len(pout[0]) == len(jout[0])
    for i, (p, j) in enumerate(zip(pout[0], jout[0])):
        assert_bitwise(p, j, f"{case} out {i}")
    assert_bitwise(pout[1], jout[1], f"{case} counts")
    assert pout[2] == jout[2]
    assert (pout[2] > 0) == (slots == 4 and len(cols) == 2
                             and read_ht != 999)


def test_grouped_aggregate_cpu_takes_a_plan(li_str):
    """With the scan's own dictionary plan the twin answers as without
    one, and a decode gives the numpy group-by."""
    data, _, pb = li_str
    q = tpch.tpch_q1_str()
    plan = pgs.make_dict_plan(pb, [R, L])
    with float_dtype("float64"):
        a = pgs.grouped_aggregate_cpu(pb, q.columns, q.where, q.aggs,
                                      q.group, device="cpu")
        b = pgs.grouped_aggregate_cpu(pb, q.columns, q.where, q.aggs,
                                      q.group, plan=plan, device="cpu")
    for x, y in zip(a[0], b[0]):
        assert_bitwise(x, y, "plan")
    outs, counts, gvals = pgs.decode_slot_groups(q.group, plan.dicts,
                                                 b[0], b[1])
    ref = tpch.numpy_reference(q, data)
    got = {(x, y): i for i, (x, y) in enumerate(zip(*gvals))}
    assert set(got) == set(ref)
    for key, i in got.items():
        assert int(counts[i]) == ref[key][2]
        assert float(outs[0][i]) == ref[key][0]


def test_grouped_aggregate_cpu_defaults_to_cuda(li_str):
    import torch
    from yugabyte_db_tpu_torch.device import DeviceUnavailable
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves")
    _, _, pb = li_str
    q = tpch.tpch_q1_str()
    with pytest.raises(DeviceUnavailable):
        pgs.grouped_aggregate_cpu(pb, q.columns, q.where, q.aggs, q.group)
