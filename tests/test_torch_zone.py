"""Zone-map pruning in the port (ops/scan.py zone_maybe_match /
zone_prune_blocks, the streamed scan's pruning branch and the tablet's
monolithic route) against the JAX reference: the same kept blocks on
seeded random zone maps and predicate trees, the same answers and
prune statistics on a range-sharded tablet, and the same restart point
when only a pruned block holds the ambiguous row."""
import numpy as np
import pytest

from yugabyte_db_tpu.docdb import operations as jops
from yugabyte_db_tpu.ops import scan as jscan
from yugabyte_db_tpu.ops import stream_scan as jss
from yugabyte_db_tpu_torch.docdb import operations as pops
from yugabyte_db_tpu_torch.models import tpch
from yugabyte_db_tpu_torch.ops import scan as pscan
from yugabyte_db_tpu_torch.ops import stream_scan as pss
from yugabyte_db_tpu_torch.ops.expr import Expr
from tests.torch_parity import (TABLET_BASE_US, assert_same_response,
                                flags_set, lineitem_data, requests,
                                tablet_pair)

C = Expr.col
ROWS = 120_000
CHUNK = 32768
READ_HT = (TABLET_BASE_US + 1000) << 12

_TIMINGS = ("build_s", "kernel_s", "combine_s", "consumer_wait_s",
            "dict_merge_s")


# --- the pure functions on random zone maps ------------------------------------
_F32_EDGES = [0.05, 0.07, 0.1, 1e-30, 3.4e38, 0.049999999999999996,
              float(np.float32(0.05)), 24.0, -0.0]


def _rand_value(rng, kind):
    if kind == "int":
        choice = rng.integers(4)
        if choice == 0:
            return int(rng.integers(-100, 100))
        if choice == 1:
            # above 2^53: float rounding would move the bound
            return (1 << 53) + int(rng.integers(-4, 5))
        if choice == 2:
            return (1 << 62) + int(rng.integers(-4, 5))
        return int(rng.integers(-(1 << 40), 1 << 40))
    if rng.integers(3) == 0:
        v = _F32_EDGES[rng.integers(len(_F32_EDGES))]
        return float(np.nextafter(v, np.inf)) if rng.integers(2) else v
    return float(rng.normal() * 10.0 ** int(rng.integers(-3, 4)))


def _rand_zmap(rng, cols):
    z = {}
    for cid, kind in cols.items():
        if rng.integers(6) == 0:
            continue                    # a column with no zone entry
        a, b = _rand_value(rng, kind), _rand_value(rng, kind)
        z[cid] = (min(a, b), max(a, b))
    return z


def _rand_expr(rng, cols, depth):
    cid = int(rng.integers(len(cols)))
    kind = cols[cid]
    if depth <= 0 or rng.integers(3) == 0:
        return ("col", cid) if rng.integers(4) else \
            ("const", _rand_value(rng, kind))
    op = ("add", "sub", "mul", "div")[rng.integers(4)]
    return ("arith", op, _rand_expr(rng, cols, depth - 1),
            _rand_expr(rng, cols, depth - 1))


def _rand_pred(rng, cols, depth=3):
    r = rng.integers(9)
    if depth > 0 and r < 2:
        return (("and", "or")[r], _rand_pred(rng, cols, depth - 1),
                _rand_pred(rng, cols, depth - 1))
    cid = int(rng.integers(len(cols)))
    kind = cols[cid]
    if r == 2:
        return ("between", ("col", cid), ("const", _rand_value(rng, kind)),
                ("const", _rand_value(rng, kind)))
    if r == 3:
        vals = [_rand_value(rng, kind) for _ in range(rng.integers(4))]
        return ("in", ("col", cid), vals)
    if r == 4:
        return ("not", ("cmp", "eq", ("col", cid), ("const", 1)))
    op = ("lt", "le", "gt", "ge", "eq", "ne")[rng.integers(6)]
    return ("cmp", op, _rand_expr(rng, cols, 1),
            ("const", _rand_value(rng, kind)))


class _Blk:
    def __init__(self, zmap, n):
        self.zmap, self.n = zmap, n


@pytest.mark.parametrize("seed", range(8))
def test_zone_functions_match_reference(seed):
    rng = np.random.default_rng(seed)
    cols = {0: "int", 1: "float", 2: "int", 3: "float"}
    blocks = [_Blk(_rand_zmap(rng, cols) if rng.integers(8) else None,
                   int(rng.integers(1, 100))) for _ in range(24)]
    for _ in range(60):
        where = _rand_pred(rng, cols)
        for b in blocks:
            if b.zmap is not None:
                assert pscan.zone_maybe_match(where, b.zmap) == \
                    jscan.zone_maybe_match(where, b.zmap), (where, b.zmap)
        pk, pidx = pscan.zone_prune_blocks(blocks, where)
        jk, jidx = jscan.zone_prune_blocks(blocks, where)
        assert pidx == jidx and [id(b) for b in pk] == [id(b) for b in jk]


@pytest.mark.parametrize("node", [
    ("col", 0), ("col", 1), ("const", 0.05), ("const", (1 << 53) + 1),
    ("arith", "mul", ("col", 1), ("const", 0.07)),
    ("arith", "sub", ("col", 0), ("const", 3)),
    ("arith", "div", ("col", 0), ("const", 3)), ("const", True),
    ("const", "x")])
def test_zone_interval_matches_reference(node):
    zmap = {0: ((1 << 53) - 2, (1 << 53) + 3), 1: (0.049999999, 0.07)}
    got = pscan._zone_interval(node, zmap)
    want = jscan._zone_interval(node, zmap)
    assert got == want
    if got is not None:
        assert [type(x) for x in got] == [type(x) for x in want]


def test_f32_widen_matches_reference():
    for lo, hi in ((0.05, 0.07), (-1.5, 2.5), (1e-45, 3.4e38)):
        assert pscan._f32_widen(lo, hi) == jscan._f32_widen(lo, hi)


# --- a range-sharded tablet ------------------------------------------------------
@pytest.fixture(scope="module")
def data():
    return lineitem_data(ROWS, seed=17)


@pytest.fixture(scope="module")
def range_tablet(tmp_path_factory, data):
    (jt,), (pt,) = tablet_pair(str(tmp_path_factory.mktemp("rng")),
                               "range", data, block_rows=4096)
    return jt, pt


def _zone_where(hi):
    return ("and", tpch.TPCH_Q6.where, (C(tpch.ROWID) < hi).node)


@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("route", ["streamed", "monolithic"])
def test_range_tablet_prunes_like_the_reference(range_tablet, data, route,
                                                prune, mode):
    jt, pt = range_tablet
    where = _zone_where(ROWS // 8)
    both = {"device_float_dtype": mode, "streaming_chunk_rows": CHUNK,
            "streaming_scan_enabled": route == "streamed",
            "zone_map_pruning": prune}
    with flags_set(both, both):
        for stats in (jss.LAST_STREAM_STATS, pss.LAST_STREAM_STATS,
                      jops.LAST_SCAN_PRUNE_STATS,
                      pops.LAST_SCAN_PRUNE_STATS):
            stats.clear()
        jreq, preq = requests("lineitem_r", where, tpch.TPCH_Q6.aggs, None,
                              READ_HT)
        presp, jresp = pt.read(preq), jt.read(jreq)
    assert_same_response(presp, jresp, f"{route} prune={prune}")
    strip = lambda d: {k: v for k, v in d.items() if k not in _TIMINGS}
    assert strip(pss.LAST_STREAM_STATS) == strip(jss.LAST_STREAM_STATS)
    assert pops.LAST_SCAN_PRUNE_STATS == jops.LAST_SCAN_PRUNE_STATS
    pruned = (pss.LAST_STREAM_STATS.get("zone_blocks_pruned")
              or pops.LAST_SCAN_PRUNE_STATS.get("blocks_pruned", 0))
    assert (pruned > 0) == prune
    m = ((data["l_shipdate"] >= 8766) & (data["l_shipdate"] < 9131)
         & (data["l_discount"] >= 0.05) & (data["l_discount"] <= 0.07)
         & (data["l_quantity"] < 24.0) & (data["rowid"] < ROWS // 8))
    ref = (data["l_extendedprice"][m] * data["l_discount"][m]).sum()
    # f32 lanes: the repo's Q6 tolerance against the f64 numpy answer
    rtol = 1e-5 if mode == "float32" else 1e-9
    assert abs(float(presp.agg_values[0]) - ref) <= rtol * abs(ref)


def test_pruned_batches_are_cached_per_predicate(range_tablet):
    """Two predicates pruning different block sets on one tablet (one
    device cache): neither may serve the other's batch."""
    jt, pt = range_tablet
    both = {"device_float_dtype": "float64", "streaming_chunk_rows": CHUNK,
            "streaming_scan_enabled": False}
    with flags_set(both, both):
        for hi in (ROWS // 8, ROWS // 2, ROWS // 8):
            jreq, preq = requests("lineitem_r", _zone_where(hi),
                                  tpch.TPCH_Q6.aggs, None, READ_HT)
            assert_same_response(pt.read(preq), jt.read(jreq), str(hi))


@pytest.mark.parametrize("route", ["streamed", "monolithic"])
def test_restart_checks_pruned_blocks(tmp_path, data, route):
    """The first 65,536 rowids (one compaction output block) load at
    the clock's start, the rest 100 ms ahead (inside the uncertainty
    window); a compaction makes one chunk-safe SST of both.  A read of
    rowid < n/8 prunes the block of the later rows and still restarts
    at their hybrid time, as the reference does: the check reads the
    full pre-prune block list."""
    lo = data["rowid"] < 65536
    jt, pt = tablet_pair(str(tmp_path), "range", data, block_rows=4096,
                         loads=((0, lo), (100_000, ~lo)))
    with flags_set({"tpu_compaction_enabled": False},
                   {"tpu_compaction_enabled": False}):
        jt[0].compact()
        pt[0].compact()
    both = {"device_float_dtype": "float64", "streaming_chunk_rows": 16384,
            "streaming_scan_enabled": route == "streamed"}
    with flags_set(both, both):
        pss.LAST_STREAM_STATS.clear()
        pops.LAST_SCAN_PRUNE_STATS.clear()
        jreq, preq = requests("lineitem_r", _zone_where(ROWS // 8),
                              tpch.TPCH_Q6.aggs, None, None)
        presp, jresp = pt[0].read(preq), jt[0].read(jreq)
    assert preq.read_ht == jreq.read_ht == \
        (TABLET_BASE_US + 100_000) << 12
    pruned = (pss.LAST_STREAM_STATS.get("zone_blocks_pruned")
              or pops.LAST_SCAN_PRUNE_STATS.get("blocks_pruned", 0))
    assert pruned > 0
    # every kept block holds only rows of the first load
    assert_same_response(presp, jresp, route)
