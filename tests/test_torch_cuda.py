"""The hand kernels themselves on the card (yugabyte_db_tpu_torch/ops/
hand_scan.py): K1 and K2 (CUDA C++) and K3 (Triton), each against its
plain PyTorch version on the same CUDA tensors — counts, MIN and MAX
exact, f32 SUMs rtol 2e-4; the exact route's shapes and the compaction
merge program on the card against the CPU, bit for bit, a small
device-backend compaction against the baseline backend, byte for byte,
a card tablet's reads and bypass session against the same tablet read
on the CPU; the join probe kernel (CUDA C++, csrc/join_probe.cu)
against its plain version, and fused join reads on the card against
the CPU, bit for bit; the window segment program, windowed row reads
and the vector searches (bf16 products on the card) against their CPU
runs; the distributed scan on a 2-slot mesh of the one card against the
same mesh on CPU slots, and the sharded exact search against
exact_search; on a machine with several cards, the mesh with its slots
spread over every card, and the bypass mesh combine with one card per
shard; a small vector tablet (IVF and HNSW: build, writes, restart) and
the grouped spill merge on the card against their CPU twins; a usertable
tablet after ALTER, the repacking compaction, a snapshot restore and
TRUNCATE against the same tablet on the CPU.
Every test here needs a GPU and skips without one; the file imports
nothing of JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from yugabyte_db_tpu_torch.ops import hand_scan as hs
# plain module name: the test directory is on sys.path (pytest's
# default import mode), and the card's machine may carry an unrelated
# top-level `tests` package
from torch_parity import (K3_CASES, K3_LANE_DTYPES,  # noqa: F401
                          MERGE_CASES, PROBE_EDGE_CASES, WINDOW_CASES,
                          WINDOW_ITEMS, assert_partials, window_case,
                          window_rows,
                          collect_consts, cuda_device, frontier_carries,
                          k3_typed_lanes,
                          merge_frontier_case, port_compaction_store,
                          probe_edge_case, q6_inputs, sorted_frontier_row)

B = hs.BLOCK_ROWS


@pytest.mark.cuda
def test_cuda_q6_kernel_matches_plain(cuda_device):
    n = 64 * B
    qty, price, disc, ship = q6_inputs(n, seed=9)
    lanes = [torch.tensor(a, dtype=torch.float32, device=cuda_device)
             for a in (qty, price, disc, ship)]
    valid = torch.ones(n, device=cuda_device)
    sc = torch.tensor([8766, 9131, 0.05, 0.07, 24.0], device=cuda_device)
    hs.reset_launches()
    got = hs.q6_scan_kernel(*lanes, valid, sc)
    assert hs.LAUNCHES["q6_scan"] == 1
    want = hs.q6_scan_plain(*lanes, valid, sc)
    assert_partials(got[1], want[1], "count")
    assert_partials(got[0], want[0], "sum")


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 6, 32, 33, 64, 4096])
def test_cuda_grouped_kernel_matches_plain(cuda_device, G):
    # 32 and 33 sit on both sides of K2's cut-off between the one-hot
    # register body and the shared histogram
    rng = np.random.default_rng(G)
    n = 16 * B
    gids, vals, mask = (torch.tensor(a, dtype=torch.float32,
                                     device=cuda_device)
                        for a in (rng.integers(-1, G + 1, n),
                                  rng.uniform(0, 10, n), rng.random(n) < .7))
    vals[7] = float("inf")
    got = hs.grouped_sum_kernel(gids, vals, mask, G)
    want = hs.grouped_sum_plain(gids, vals, mask, G)
    assert_partials(got, want, "sum")
    with pytest.raises(ValueError):
        hs.grouped_sum_kernel(gids, vals, mask, 4097)


_OTHER_FORM = {"unrolled": ("tile", 128, 8), "tile": ("unrolled", 256, 4)}
_K3_CARD_CASES = ([(name, lanes, "chosen") for name in sorted(K3_CASES)
                   for lanes in sorted(K3_LANE_DTYPES)]
                  + [(name, "native", "other") for name in sorted(K3_CASES)
                     if K3_CASES[name][2] is not None])


@pytest.mark.cuda
@pytest.mark.parametrize("name,lanes,form", _K3_CARD_CASES)
def test_cuda_generic_kernel_matches_plain(cuda_device, name, lanes, form):
    # every case on every lane dtype set in the form K3 picks, and the
    # grouped cases once more in the other grouped form
    where, aggs, group = K3_CASES[name]
    cols, nulls, valid, _ = k3_typed_lanes(8 * B, lanes, null_frac=0.1)
    order = tuple(sorted(cols))
    consts = collect_consts(where, aggs)
    G = int(np.prod([d for _, d, _ in group])) if group else None
    k3 = hs.GenericScan(where, aggs, group, G, order, order, len(consts))
    if form == "other":
        k3.config = _OTHER_FORM[k3.config[0]]
    dev = cuda_device
    call = (torch.tensor([float(c) for c in consts] or [0.0],
                         dtype=torch.float32, device=dev),
            [cols[c].to(dev) for c in order],
            [nulls[c].to(dev) for c in order], valid.to(dev))
    got = k3(*call)
    assert k3.launches == 1
    stats = k3.compiled_stats()
    assert stats["n_spills"] == 0 or form == "other", stats
    want = k3.plain(*call)
    for (op, _), g, w in zip(list(aggs) + [("count", None)], got, want):
        assert_partials(g, w, op, f"{name} {lanes} {form} {op}")


# --- the exact route's new shapes on the card against the CPU -------------------
def _run_on(device, blocks, cols, where, aggs, group=None, read_ht=None):
    from yugabyte_db_tpu_torch.ops.device_batch import build_batch
    from yugabyte_db_tpu_torch.ops.scan import ScanKernel
    from yugabyte_db_tpu_torch.utils import flags
    # both batches in f32 (the card's policy), so the two devices run
    # the same computation: int64 sums, sorts and masks are exact
    with flags.overridden("device_float_dtype", "float32"):
        batch = build_batch(blocks, cols, device=device)
    out = ScanKernel(device=device).run(batch, where, aggs, group, read_ht)
    return [[np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
             for x in o] if isinstance(o, tuple) else
            np.asarray(o.cpu() if isinstance(o, torch.Tensor) else o)
            for o in out]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, list):
            _same(g, w)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(np.atleast_1d(g).view(np.uint8),
                                  np.atleast_1d(w).view(np.uint8))


def _lineitem(str_keys=False, n=5 * B + 77):
    from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    data = tpch.generate_lineitem(n / tpch.ROWS_PER_SF, seed=3)
    info = tpch.lineitem_info()
    if str_keys:
        data, info = tpch.lineitem_str_data(data), tpch.lineitem_str_info()
    return TableCodec(info).bulk_blocks(data, HybridTime(1000),
                                        block_rows=B)


@pytest.mark.cuda
@pytest.mark.parametrize("read_ht", [999, 1000, 1500, 2500])
def test_cuda_dedup_matches_cpu(cuda_device, read_ht):
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.storage.columnar import ColumnarBlock
    blocks = _lineitem()
    kh = np.concatenate([b.key_hash for b in blocks])
    rng = np.random.default_rng(1)
    up = rng.choice(len(kh), len(kh) // 5, replace=False)
    cols = tpch.TPCH_Q1.columns
    fixed = {c: (np.concatenate([b.fixed[c][0] for b in blocks])[up],
                 np.zeros(len(up), bool)) for c in cols}
    blocks.append(ColumnarBlock.from_arrays(
        1, kh[up], np.full(len(up), 1200, np.uint64),
        write_id=np.arange(len(up)), fixed=fixed,
        tombstone=rng.random(len(up)) < 0.3, unique_keys=False))
    blocks.append(ColumnarBlock.from_arrays(
        1, kh[up[:500]], np.full(500, 2000, np.uint64),
        write_id=np.arange(500),
        fixed={c: (v[:500] * 2, m[:500]) for c, (v, m) in fixed.items()},
        unique_keys=False))
    for q in (tpch.TPCH_Q6, tpch.TPCH_Q1):
        _same(_run_on(cuda_device, blocks, cols, q.where, q.aggs, q.group,
                      read_ht),
              _run_on("cpu", blocks, cols, q.where, q.aggs, q.group,
                      read_ht))


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [(6,), (5,), (6, 7), (3,)])
def test_cuda_hash_group_matches_cpu(cuda_device, cols):
    # int32 keys (flags, shipdate) and a float key (discount)
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops.scan import HashGroupSpec
    blocks = _lineitem()
    q = tpch.TPCH_Q1
    aggs = q.aggs + (tpch.AggSpec("min", ("col", tpch.EXTPRICE)),
                     tpch.AggSpec("max", ("col", tpch.TAX)))
    group = HashGroupSpec(cols=cols)
    _same(_run_on(cuda_device, blocks, q.columns, q.where, aggs, group),
          _run_on("cpu", blocks, q.columns, q.where, aggs, group))


@pytest.mark.cuda
@pytest.mark.parametrize("max_slots", [4, 4096])
def test_cuda_dict_group_matches_cpu(cuda_device, max_slots):
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops.grouped_scan import DictGroupSpec
    blocks = _lineitem(str_keys=True)
    q = tpch.tpch_q1_str()
    group = DictGroupSpec(cols=q.group.cols, max_slots=max_slots)
    where = ("and", q.where, ("dictlut", ("col", tpch.LINESTATUS), [0, 1]))
    for w in (q.where, where):
        _same(_run_on(cuda_device, blocks, q.columns, w, q.aggs, group),
              _run_on("cpu", blocks, q.columns, w, q.aggs, group))


@pytest.mark.cuda
def test_cuda_streamed_q1_runs_k3_per_chunk(cuda_device):
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops import stream_scan as ss
    from yugabyte_db_tpu_torch.ops.scan import ScanKernel
    from yugabyte_db_tpu_torch.utils import flags
    blocks = _lineitem(n=12 * B + 5)
    q = tpch.TPCH_Q1
    with flags.overridden("hand_scan_enabled", True), \
            flags.overridden("device_float_dtype", "float32"):
        before = hs.LAUNCHES["generic_scan"]
        go, gc = ss.streaming_scan_aggregate(
            blocks, q.columns, q.where, q.aggs, q.group,
            kernel=ScanKernel(device=cuda_device), chunk_rows=4 * B)
        chunks = ss.LAST_STREAM_STATS["chunks"]
        assert chunks == 4
        assert hs.LAUNCHES["generic_scan"] - before == chunks
        wo, wc = ss.streaming_scan_aggregate(
            blocks, q.columns, q.where, q.aggs, q.group,
            kernel=ScanKernel(device="cpu"), chunk_rows=4 * B)
    assert np.array_equal(gc, wc)
    for (op, _), g, w in zip([(a.op, a.expr) for a in q.aggs], go, wo):
        assert_partials(g, w, op)


# --- compaction: the merge programs and the engine on the card -----------------
@pytest.mark.cuda
@pytest.mark.parametrize("case", MERGE_CASES)
def test_cuda_merge_programs_match_cpu(cuda_device, case):
    from yugabyte_db_tpu_torch.ops import compaction as oc
    dk, ht, wid, tomb, valid = merge_frontier_case(case, m=1 << 16, seed=1)
    b = sorted_frontier_row(dk, ht, wid, valid, int(valid.sum()) // 2)
    bound = (dk[b], int(ht[b]), int(wid[b]))
    cutoff = int(np.median(ht[valid]))
    for bd in (None, bound):
        for carry in [None] + frontier_carries(dk, ht, wid, valid):
            got = oc.merge_frontier(dk, ht, wid, tomb, valid, bd, carry,
                                    cutoff, device=cuda_device)
            want = oc.merge_frontier(dk, ht, wid, tomb, valid, bd, carry,
                                     cutoff, device="cpu")
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_cuda_compaction_equals_baseline(cuda_device, tmp_path):
    from yugabyte_db_tpu_torch.docdb import compaction as comp
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.utils import flags
    data = tpch.generate_lineitem(0.002, seed=7)
    outs = {}
    for backend in ("device", "baseline"):
        store, codec, hts = port_compaction_store(
            tmp_path / backend, tpch.lineitem_info(), data)
        with flags.overridden("compaction_chunk_rows", 4096):
            outs[backend] = comp.tpu_compact(
                store, codec, hts[len(hts) // 2], block_rows=700,
                backend=backend, device=cuda_device)
        if backend == "device":
            assert comp.LAST_COMPACTION_STATS["chunks"] >= 8
            assert comp.LAST_COMPACTION_STATS["device"].startswith("cuda")
    assert open(outs["device"], "rb").read() == \
        open(outs["baseline"], "rb").read()


# --- the tablet read seam on the card ------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("streamed", [True, False])
def test_cuda_tablet_read_matches_cpu(cuda_device, tmp_path, streamed):
    """One lineitem tablet on the card and its twin on the CPU over the
    same rows: the exact route equals bit for bit under one float dtype;
    the hand route (K3, MVCC mode visible) agrees within the hand
    route's tolerance and launches K3; the bypass session on the card
    equals the card's tablet read."""
    from yugabyte_db_tpu_torch.bypass import BypassSession
    from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils import flags
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    data = tpch.generate_lineitem(0.02, seed=5)
    tablets = {}
    for dev in (cuda_device, "cpu"):
        t = Tablet("t", tpch.lineitem_info(), str(tmp_path / str(dev)),
                   device=dev)
        t.bulk_load(data, ht=HybridTime(1 << 40), block_rows=8192)
        tablets[str(dev)] = t
    read_ht = 1 << 41

    def read(t, q):
        return t.read(ReadRequest("lineitem", where=q.where,
                                  aggregates=q.aggs, group_by=q.group,
                                  read_ht=read_ht))

    with flags.overridden("device_float_dtype", "float32"), \
            flags.overridden("streaming_chunk_rows", 32768), \
            flags.overridden("streaming_scan_enabled", streamed):
        for q in (tpch.TPCH_Q6, tpch.TPCH_Q1):
            got, want = read(tablets[str(cuda_device)], q), \
                read(tablets["cpu"], q)
            assert np.array_equal(got.group_counts, want.group_counts)
            for g, w in zip(got.agg_values, want.agg_values):
                assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
            with flags.overridden("hand_scan_enabled", True):
                before = hs.LAUNCHES["generic_scan"]
                hand = read(tablets[str(cuda_device)], q)
                assert hs.LAUNCHES["generic_scan"] > before
            assert np.array_equal(hand.group_counts, want.group_counts)
            for a, g, w in zip(q.aggs, hand.agg_values, want.agg_values):
                assert_partials(g, w, a.op)
            with BypassSession([tablets[str(cuda_device)]], read_ht=read_ht,
                               device=cuda_device) as s:
                bv, bc, st = s.scan_aggregate(q.where, q.aggs, q.group)
            assert st["key_rebuilds"] == 0
            assert np.array_equal(bc, got.group_counts)
            for b, g in zip(bv, got.agg_values):
                assert np.asarray(b).tobytes() == np.asarray(g).tobytes()


# --- the join probe kernel and fused joins on the card ----------------------------
def _packed_tables(keys, S, device):
    """The packed tables of one build side on `device`: 16-byte slots,
    and 8-byte ones where every key fits in int32."""
    from yugabyte_db_tpu_torch.ops import join_scan as js
    used, tkey, tval = (torch.from_numpy(a).to(device) for a in
                        js.build_hash_table(keys, S))
    out = [js.pack_table(used, tkey, tval, js.SLOT_WIDE)]
    if js.fits_narrow(tkey, used):
        out.append(js.pack_table(used, tkey, tval, js.SLOT_NARROW))
    return out


def _check_probe(js, pk, nulls, mask, table, S):
    """The kernel against the plain probe on the same tensors: midx
    equal on every live row and -1 elsewhere, the outgoing mask equal
    everywhere (exact: both are integers)."""
    midx, out = js.probe_kernel(pk, nulls, mask, table, S)
    torch.cuda.synchronize()
    plain = js.probe_table(pk, table, S)
    live = mask if nulls is None else mask & ~nulls
    assert torch.equal(out, live & (plain >= 0)), table.dtype
    assert torch.equal(midx[live], plain[live]), table.dtype
    assert bool((midx[~live] == -1).all())
    return plain


@pytest.mark.cuda
@pytest.mark.parametrize("with_nulls", [False, True])
@pytest.mark.parametrize("load", [0.05, 0.25, 0.5])
@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
def test_cuda_join_probe_matches_plain(cuda_device, key_dtype, load,
                                       with_nulls):
    """csrc/join_probe.cu against the plain probe on random packed tables
    up to the table builder's 0.5 load factor, on both slot layouts
    (masked rows may skip the walk)."""
    from yugabyte_db_tpu_torch.ops import join_scan as js
    rng = np.random.default_rng(3)
    S = 1 << 16
    lim = 2**31 - 1 if key_dtype == torch.int32 else 1 << 40
    keys = np.unique(rng.integers(-lim, lim, int(S * load)))
    keys = keys.astype(np.int64)
    n = 3 * B + 77
    probe = np.where(rng.random(n) < 0.6, rng.choice(keys, n),
                     rng.integers(-lim, lim, n))
    pk = torch.from_numpy(probe).to(key_dtype).to(cuda_device)
    mask = torch.from_numpy(rng.random(n) < 0.8).to(cuda_device)
    nulls = (torch.from_numpy(rng.random(n) < 0.1).to(cuda_device)
             if with_nulls else None)
    tables = _packed_tables(keys, S, cuda_device)
    assert len(tables) == (2 if key_dtype == torch.int32 else 1)
    for table in tables:
        before = hs.LAUNCHES["join_probe"]
        midx, out = js.probe_rows(pk, nulls, mask, table, S)
        torch.cuda.synchronize()
        assert hs.LAUNCHES["join_probe"] == before + 1
        plain = _check_probe(js, pk, nulls, mask, table, S)
        live = mask if nulls is None else mask & ~nulls
        assert torch.equal(midx[live], plain[live])
        assert int((live & (plain >= 0)).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", PROBE_EDGE_CASES)
def test_cuda_join_probe_edge_cases(cuda_device, case):
    """The CPU tests' probe edge cases on the card (chains that wrap from
    slot S-1 to 0, bit-63 keys, the int64 extremes, an empty table, probe
    keys equal to a build key in their low 32 bits only — misses on the
    narrow slots too — an all-masked batch, NULL keys), int64 and, where
    the keys fit, int32 probe lanes."""
    from yugabyte_db_tpu_torch.ops import join_scan as js
    keys, probe, mask, nulls = probe_edge_case(case)
    S = 64 if case == "wrap" else js.table_bucket(len(keys), 1 << 16)
    m = torch.from_numpy(mask).to(cuda_device)
    nl = (torch.from_numpy(nulls).to(cuda_device) if nulls is not None
          else None)
    lanes = [torch.from_numpy(probe).to(cuda_device)]
    if probe.min() >= -2**31 and probe.max() < 2**31:
        lanes.append(lanes[0].to(torch.int32))
    for table in _packed_tables(keys, S, cuda_device):
        for pk in lanes:
            plain = _check_probe(js, pk, nl, m, table, S)
            if case in ("empty", "high_bits"):
                assert bool((plain == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 5, 7, 13, 100, 255, 1023, 4099, 65_541])
def test_cuda_join_probe_odd_lengths(cuda_device, n):
    """Batches shorter than one thread's rows, lengths that are not a
    multiple of the rows per thread (the scalar tail), shorter than one
    block and a few blocks long."""
    from yugabyte_db_tpu_torch.ops import join_scan as js
    rng = np.random.default_rng(n)
    keys = rng.choice(1 << 20, 3000, replace=False).astype(np.int64)
    pk = torch.from_numpy(rng.choice(np.concatenate(
        [keys, np.arange(1 << 20, (1 << 20) + 500)]), n)).to(cuda_device)
    mask = torch.from_numpy(rng.random(n) < 0.9).to(cuda_device)
    nulls = torch.from_numpy(rng.random(n) < 0.1).to(cuda_device)
    for table in _packed_tables(keys, 1 << 13, cuda_device):
        _check_probe(js, pk, nulls, mask, table, 1 << 13)
        _check_probe(js, pk.to(torch.int32), None, mask, table, 1 << 13)


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
def test_cuda_join_probe_long_batch(cuda_device, key_dtype):
    """A batch of 3M rows (a grid of thousands of blocks, more than the
    card holds at once), with a ragged tail and NULL keys."""
    from yugabyte_db_tpu_torch.ops import join_scan as js
    rng = np.random.default_rng(29)
    n = (3 << 20) + 13
    keys = rng.choice(1 << 24, 200_000, replace=False).astype(np.int64)
    probe = np.where(rng.random(n) < 0.5, rng.choice(keys, n),
                     rng.integers(0, 1 << 24, n))
    pk = torch.from_numpy(probe).to(key_dtype).to(cuda_device)
    mask = torch.from_numpy(rng.random(n) < 0.6).to(cuda_device)
    nulls = torch.from_numpy(rng.random(n) < 0.05).to(cuda_device)
    for table in _packed_tables(keys, 1 << 19, cuda_device):
        _check_probe(js, pk, nulls, mask, table, 1 << 19)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", list(range(1, 16)))
@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
def test_cuda_join_probe_lanes_at_storage_offsets(cuda_device, key_dtype,
                                                   offset):
    """Probe lanes given as views at storage offsets 1-15 (pointers off
    16-byte alignment) take the kernel's scalar accesses: the same answer
    as the plain probe."""
    from yugabyte_db_tpu_torch.ops import join_scan as js
    rng = np.random.default_rng(offset)
    n = 2 * B + 9
    keys = rng.choice(1 << 20, 5000, replace=False).astype(np.int64)
    big = torch.from_numpy(rng.choice(keys, n + 16)).to(key_dtype)
    pk = big.to(cuda_device)[offset:offset + n]
    mask = torch.from_numpy(rng.random(n + 16) < 0.8).to(
        cuda_device)[offset:offset + n]
    nulls = torch.from_numpy(rng.random(n + 16) < 0.1).to(
        cuda_device)[offset:offset + n]
    assert pk.storage_offset() == offset and mask.data_ptr() % 16
    for table in _packed_tables(keys, 1 << 14, cuda_device):
        _check_probe(js, pk, nulls, mask, table, 1 << 14)


@pytest.mark.cuda
@pytest.mark.parametrize("streamed", [True, False])
def test_cuda_join_read_matches_cpu(cuda_device, tmp_path, streamed):
    """A TPC-H Q5 chain (two probe stages) on a card tablet and on its CPU
    twin over the same rows, bit for bit under one float dtype; the
    card's fused plan launches the probe kernel once per stage and
    chunk, and the card's bypass session equals its tablet read."""
    from yugabyte_db_tpu_torch.bypass import BypassSession
    from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops import plan_fusion as pf
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils import flags
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    data = tpch.generate_lineitem(0.02, seed=5)
    od = tpch.generate_orders_cust(30_000, 3000)
    cd = tpch.generate_customer(3000)
    ld = tpch.lineitem_join_data(data, 30_000)
    tablets = {}
    for dev in (cuda_device, "cpu"):
        t = Tablet("t", tpch.lineitem_join_info(), str(tmp_path / str(dev)),
                   device=dev)
        t.bulk_load(ld, ht=HybridTime(1 << 40), block_rows=8192)
        tablets[str(dev)] = t
    read_ht = 1 << 41
    with flags.overridden("device_float_dtype", "float32"), \
            flags.overridden("streaming_chunk_rows", 32768), \
            flags.overridden("streaming_scan_enabled", streamed):
        for q in (tpch.tpch_q5_chain(), tpch.tpch_q3_chain()):
            req = dict(where=q.probe_where, aggregates=q.aggs,
                       group_by=tpch._chain_group(q.group_col),
                       join=tpch.chain_build_wires(q, od, cd),
                       read_ht=read_ht)
            before = hs.LAUNCHES["join_probe"]
            got = tablets[str(cuda_device)].read(
                ReadRequest("lineitem_j", **req))
            chunks = pf.LAST_PLAN_STATS["chunks"]
            assert hs.LAUNCHES["join_probe"] - before == 2 * chunks
            want = tablets["cpu"].read(ReadRequest("lineitem_j", **req))
            assert got.backend == want.backend == "tpu"
            assert np.array_equal(got.group_counts, want.group_counts)
            assert list(got.group_values[0]) == list(want.group_values[0])
            for g, w in zip(got.agg_values, want.agg_values):
                assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
            with BypassSession([tablets[str(cuda_device)]], read_ht=read_ht,
                               device=cuda_device) as s:
                gout = {}
                bv, bc, _ = s.scan_aggregate(
                    q.probe_where, q.aggs, tpch._chain_group(q.group_col),
                    grouped_out=gout, join=req["join"])
            assert np.array_equal(bc, got.group_counts)
            for b, g in zip(bv, got.agg_values):
                assert np.asarray(b).tobytes() == np.asarray(g).tobytes()


# --- windows, row reads and vector search on the card ---------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("case", WINDOW_CASES)
def test_cuda_window_program_matches_cpu(cuda_device, case):
    """The segment program on the card against its CPU run: every lane
    equal (floats with NaN where the CPU has NaN)."""
    from yugabyte_db_tpu_torch.ops import window_scan as ws
    ops, seg, peer, values, nulls = window_case(case)
    before = ws.WINDOW_STATS["launches"]
    got = ws.WindowKernel(cuda_device).run(ops, seg, peer, values, nulls)
    assert ws.WINDOW_STATS["launches"] == before + 1
    want = ws.WindowKernel("cpu").run(ops, seg, peer, values, nulls)
    for op, (gv, gm), (wv, wm) in zip(ops, got, want):
        assert gv.dtype == wv.dtype and np.array_equal(gm, wm), (case, op)
        assert np.array_equal(gv, wv, equal_nan=gv.dtype.kind == "f"), \
            (case, op)


@pytest.mark.cuda
def test_cuda_window_rows_match_cpu(cuda_device):
    import copy
    from yugabyte_db_tpu_torch.ops import window_scan as ws
    wire = ws.WindowWire(("flag", "status"), (("day", False),),
                         WINDOW_ITEMS)
    rows = window_rows()
    got, want = copy.deepcopy(rows), copy.deepcopy(rows)
    ws.serve_window_rows(wire, got, ws.WindowKernel(cuda_device))
    ws.serve_window_rows(wire, want, ws.WindowKernel("cpu"))
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("streamed", [True, False])
def test_cuda_windowed_row_read_matches_cpu(cuda_device, tmp_path, streamed):
    """A Q6 row read with a window on a card tablet and on its CPU twin:
    the same rows in the same order, the same window values."""
    from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops import window_scan as ws
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils import flags
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    data = tpch.generate_lineitem(0.02, seed=5)
    wire = ws.WindowWire(
        ("l_returnflag", "l_linestatus"), (("l_shipdate", False),),
        (("rank", 0, None, "rk"), ("sum", 1, "l_shipdate", "cum"),
         ("lag", 1, "l_extendedprice", "prev")))
    resp = {}
    for dev in (cuda_device, "cpu"):
        t = Tablet("t", tpch.lineitem_info(), str(tmp_path / str(dev)),
                   device=dev)
        t.bulk_load(data, ht=HybridTime(1 << 40), block_rows=8192)
        with flags.overridden("device_float_dtype", "float64"), \
                flags.overridden("streaming_chunk_rows", 32768), \
                flags.overridden("streaming_scan_enabled", streamed):
            resp[str(dev)] = t.read(ReadRequest(
                "lineitem", columns=("rowid", "l_returnflag",
                                     "l_linestatus", "l_shipdate",
                                     "l_extendedprice"),
                where=tpch.TPCH_Q6.where, window=wire, read_ht=1 << 41))
    got, want = resp[str(cuda_device)], resp["cpu"]
    assert got.window_served and want.window_served
    assert got.rows == want.rows and len(got.rows) > 0


def _same_distances_by_id(gd, gi, wd, wi):
    """Each id both searches returned, past each query's own row: the
    card's distance within 1 % of the CPU's (bf16 rounding of the
    products; the two may pick different ids among near-ties)."""
    checked = 0
    for a_d, a_i, b_d, b_i in zip(gd, gi, wd, wi):
        want = dict(zip(b_i[1:].tolist(), b_d[1:].tolist()))
        for d, i in zip(a_d[1:].tolist(), a_i[1:].tolist()):
            if i in want:
                assert abs(d - want[i]) <= 1e-2 * want[i], (i, d, want[i])
                checked += 1
    assert checked >= gi.shape[0] * (gi.shape[1] - 1) // 2


def _vector_corpus(n=20_000, d=128, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, d)).astype(np.float32)
    return base, base[:64] + 0.001


@pytest.mark.cuda
def test_cuda_distances_match_cpu(cuda_device):
    """bf16 operands on the card: equal to the f32 product of the
    bf16-rounded operands on the CPU within f32 accumulation error
    (1e-5 of |q|^2 + |b|^2); inner products likewise."""
    from yugabyte_db_tpu_torch.ops import vector as pv
    base, q = _vector_corpus(4096)
    qb, bb = (torch.from_numpy(x).bfloat16().float() for x in (q, base))
    dots = (qb @ bb.t()).numpy()
    qn, bn = (q * q).sum(1), (base * base).sum(1)
    scale = qn[:, None] + bn[None, :]
    want = np.maximum(scale - 2.0 * dots, 0.0)
    got = pv.l2_distance2(torch.from_numpy(q).to(cuda_device),
                          torch.from_numpy(base).to(cuda_device))
    assert got.dtype == torch.float32
    assert np.all(np.abs(got.cpu().numpy() - want) <= 1e-5 * scale)
    ip = pv.inner_product(torch.from_numpy(q).to(cuda_device),
                          torch.from_numpy(base).to(cuda_device)).cpu()
    assert np.all(np.abs(ip.numpy() - dots) <= 1e-5 * scale)


@pytest.mark.cuda
def test_cuda_exact_search_matches_cpu(cuda_device):
    from yugabyte_db_tpu_torch.ops import vector as pv
    base, q = _vector_corpus()
    gd, gi = pv.exact_search(q, base, 10, device=cuda_device)
    wd, wi = pv.exact_search(q, base, 10, device="cpu")
    gi, wi = gi.cpu().numpy(), wi.numpy()
    assert np.array_equal(gi[:, 0], np.arange(64))       # own rows first
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(gi, wi)])
    assert overlap >= 0.9, overlap
    _same_distances_by_id(gd.cpu().numpy(), gi, wd.numpy(), wi)


@pytest.mark.cuda
def test_cuda_kmeans_matches_cpu(cuda_device):
    """Well-separated clusters from one seed point each: the bf16
    assignment on the card is the CPU's, so the f32 one-hot sums give
    the same centroids within f32 rounding."""
    from yugabyte_db_tpu_torch.ops import vector as pv
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(12, 16)).astype(np.float32) * 50
    label = rng.integers(0, 12, 4000)
    data = centers[label] + rng.normal(size=(4000, 16)).astype(np.float32)
    init = data[[int(np.nonzero(label == c)[0][0]) for c in range(12)]]
    got = pv._kmeans_iters(torch.from_numpy(data).to(cuda_device),
                           torch.from_numpy(init).to(cuda_device), 6)
    want = pv._kmeans_iters(torch.from_numpy(data), torch.from_numpy(init), 6)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
def test_cuda_two_stage_search_matches_cpu(cuda_device, tmp_path):
    """One index on both devices (saved, then loaded on each): the card's
    bf16 stage 1 and f32 re-rank against the CPU's f32 search."""
    from yugabyte_db_tpu_torch.vector import AnnIndex, TwoStageIvfIndex
    from yugabyte_db_tpu_torch.vector import ivf as pivf
    base, q = _vector_corpus()
    TwoStageIvfIndex.build(base, nlists=64, iters=5, sample=20_000,
                           device=cuda_device).save(str(tmp_path / "i"))
    card = AnnIndex.load(str(tmp_path / "i"), device=cuda_device)
    cpu = AnnIndex.load(str(tmp_path / "i"), device="cpu")
    pivf.reset_kernel_stats()
    gd, gi = card.search(q, k=10, nprobe=16)
    assert pivf.kernel_cache_stats()["calls"] == 1
    wd, wi = cpu.search(q, k=10, nprobe=16)
    assert np.array_equal(gi[:, 0], np.arange(64))
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(gi, wi)])
    assert overlap >= 0.95, overlap
    _same_distances_by_id(gd, gi, wd, wi)
    # the numpy twin from the card-built index: the same ids
    td, ti = card.search(q, k=10, nprobe=16, backend="cpu")
    assert np.array_equal(ti, cpu.search(q, k=10, nprobe=16,
                                         backend="cpu")[1])


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [3, 64])
def test_cuda_flat_index_matches_cpu(cuda_device, nq):
    """IvfFlatIndex on both devices from the same arrays: 3 queries take
    the probe route, 64 the shared full scan."""
    from yugabyte_db_tpu_torch.ops import vector as pv
    base, q = _vector_corpus()
    card = pv.IvfFlatIndex.build(base, nlists=64, iters=5,
                                 device=cuda_device)
    cpu = pv.IvfFlatIndex(card.centroids.cpu().numpy(),
                          card.lists.cpu().numpy(),
                          card.list_lens.cpu().numpy(), base, device="cpu")
    gd, gi = card.search(q[:nq], k=10, nprobe=16)
    wd, wi = cpu.search(q[:nq], k=10, nprobe=16)
    assert np.array_equal(gi[:, 0], np.arange(nq))
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(gi, wi)])
    assert overlap >= 0.9, overlap


def _mesh_batches(devices, q, dynamic):
    """A 2-slot sharded batch of SF-small lineitem blocks (even and odd
    blocks) on `devices`, lanes in f32 on both devices."""
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.parallel import tablet_mesh
    from yugabyte_db_tpu_torch.parallel.distributed_scan import \
        build_sharded_batch
    from yugabyte_db_tpu_torch.utils import flags
    from torch_parity import lineitem_data, port_blocks
    blocks = port_blocks(lineitem_data(20 * 4096 + 333, seed=3))
    with flags.overridden("device_float_dtype", "float32"):
        batch = build_sharded_batch(tablet_mesh(2, devices=devices),
                                    [blocks[::2], blocks[1::2]],
                                    sorted(q.columns))
    if dynamic:                # no column stats: the cross-shard max pass
        batch.col_bounds.clear()
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("read_ht", [None, 1000])
@pytest.mark.parametrize("query", ["q6", "q1"])
def test_cuda_mesh_scan_matches_cpu_mesh(cuda_device, query, read_ht,
                                         dynamic):
    """A 2-slot mesh on the one card against the same mesh on CPU slots:
    counts exact, SUMs within 1e-9 relative."""
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.parallel.distributed_scan import \
        DistributedScanKernel
    q = tpch.TPCH_Q6 if query == "q6" else tpch.TPCH_Q1
    kern = DistributedScanKernel()
    got = kern.run(_mesh_batches([cuda_device] * 2, q, dynamic), q.where,
                   q.aggs, q.group, read_ht)
    assert kern.launches == 2 and kern.vmax_passes == int(dynamic)
    want = DistributedScanKernel().run(
        _mesh_batches(["cpu"] * 2, q, dynamic), q.where, q.aggs, q.group,
        read_ht)
    assert np.array_equal(got[1], want[1])
    for a, b in zip(got[0], want[0]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        if a.dtype.kind in "iu":
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(2, 1), (2, 2)])
def test_cuda_sharded_exact_search_matches_exact_search(cuda_device, T, B):
    """Slots as views of one base on the card against exact_search over
    the whole base: own rows first, distances within 1e-5 of |q|^2 +
    |b|^2, the same ids wherever the distances are not tied."""
    from yugabyte_db_tpu_torch.ops import vector as pv
    from yugabyte_db_tpu_torch.parallel import (sharded_exact_search,
                                                tablet_mesh)
    base, q = _vector_corpus()
    S = T * B
    whole = torch.from_numpy(base).to(cuda_device)
    n_shard = len(base) // S
    views = [whole[s * n_shard:(s + 1) * n_shard] for s in range(S)]
    tm = tablet_mesh(T, B, devices=[cuda_device] * S)
    gd, gi = sharded_exact_search(tm, q, views, 10)
    wd, wi = pv.exact_search(q, whole, 11, device=cuda_device)
    wd, wi = wd.cpu().numpy(), wi.cpu().numpy()
    assert np.array_equal(gi[:, 0], np.arange(64))
    scale = (q * q).sum(1)[:, None] + 2.0 * (base * base).sum(1).max()
    assert np.all(np.abs(gd - wd[:, :10]) <= 1e-5 * scale)
    for g, d, w in zip(gi, wd, wi):
        if d[10] - d[9] > 1e-4 * d[10]:
            assert set(g.tolist()) == set(w[:10].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("query", ["q6", "q1"])
def test_cuda_mesh_across_cards_matches_cpu_mesh(cuda_device, query,
                                                 dynamic):
    """Slots on distinct cards (slot s on card s mod the card count, two
    slots a card): the partials and the cross-shard maxima cross cards
    by device-to-device copies; the answer equals the CPU mesh's."""
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.parallel.distributed_scan import \
        DistributedScanKernel
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    q = tpch.TPCH_Q6 if query == "q6" else tpch.TPCH_Q1
    devices = [torch.device("cuda", s % cards) for s in range(2 * cards)]
    got = DistributedScanKernel().run(
        _split_batch(devices, q, dynamic), q.where, q.aggs, q.group, 1000)
    want = DistributedScanKernel().run(
        _split_batch(["cpu"] * len(devices), q, dynamic), q.where, q.aggs,
        q.group, 1000)
    assert np.array_equal(got[1], want[1])
    for a, b in zip(got[0], want[0]):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-9,
                                   atol=0)


def _split_batch(devices, q, dynamic):
    """A sharded batch of small lineitem blocks, one block list a slot,
    lanes in f32 on every device."""
    from yugabyte_db_tpu_torch.parallel import tablet_mesh
    from yugabyte_db_tpu_torch.parallel.distributed_scan import \
        build_sharded_batch
    from yugabyte_db_tpu_torch.utils import flags
    from torch_parity import lineitem_data, port_blocks
    S = len(devices)
    blocks = port_blocks(lineitem_data(S * 4096 + 333, seed=4))
    with flags.overridden("device_float_dtype", "float32"):
        batch = build_sharded_batch(tablet_mesh(S, devices=devices),
                                    [blocks[s::S] for s in range(S)],
                                    sorted(q.columns))
    if dynamic:
        batch.col_bounds.clear()
    return batch


@pytest.mark.cuda
def test_cuda_sharded_exact_search_across_cards(cuda_device):
    """A numpy base in one slot per card: each slot's rows go to its
    card; the merge on card 0 equals exact_search on card 0."""
    from yugabyte_db_tpu_torch.ops import vector as pv
    from yugabyte_db_tpu_torch.parallel import (sharded_exact_search,
                                                tablet_mesh)
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    base, q = _vector_corpus(n=4096 * cards)
    tm = tablet_mesh(devices=[torch.device("cuda", c)
                              for c in range(cards)])
    gd, gi = sharded_exact_search(tm, q, base.reshape(cards, 4096, -1), 10)
    wd, wi = pv.exact_search(q, base, 11, device=cuda_device)
    wd, wi = wd.cpu().numpy(), wi.cpu().numpy()
    assert np.array_equal(gi[:, 0], np.arange(64))
    scale = (q * q).sum(1)[:, None] + 2.0 * (base * base).sum(1).max()
    assert np.all(np.abs(gd - wd[:, :10]) <= 1e-5 * scale)
    for g, d, w in zip(gi, wd, wi):
        if d[10] - d[9] > 1e-4 * d[10]:
            assert set(g.tolist()) == set(w[:10].tolist())


@pytest.mark.cuda
def test_cuda_bypass_mesh_one_card_per_shard(cuda_device, tmp_path):
    """A session over as many tablets as there are cards: the mesh
    combine puts shard i on card i and equals the host combine (counts
    exact, sums within 1e-9: one scale for all shards against one per
    shard)."""
    from yugabyte_db_tpu_torch.bypass import BypassSession
    from yugabyte_db_tpu_torch.models import tpch
    from torch_parity import lineitem_data
    cards = torch.cuda.device_count()
    table = tpch.LineitemTable(str(tmp_path), num_tablets=cards,
                               device=cuda_device)
    table.load(lineitem_data(cards * 3 * 4096, seed=6), block_rows=4096)
    read_ht = max(t.clock.now().value for t in table.tablets)
    for q in (tpch.TPCH_Q6, tpch.TPCH_Q1):
        with BypassSession(table.tablets, read_ht=read_ht,
                           device=cuda_device) as s:
            mv, mc, st = s.scan_aggregate(q.where, q.aggs, q.group,
                                          combine="mesh")
            hv, hc, _ = s.scan_aggregate(q.where, q.aggs, q.group)
        assert st["combine"] == "mesh" and st["shards_scanned"] == cards
        assert np.array_equal(np.asarray(mc), np.asarray(hc))
        for a, b in zip(mv, hv):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=1e-9, atol=0)


# --- the write path on the card ----------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(24,), (21, 33, 24)])
def test_cuda_merge_gc_split_matches_cpu(cuda_device, widths):
    """The whole-input merge + GC program (ops/compaction.py
    merge_gc_split_kernel through compact_runs) on the card: order and
    keep bit for bit with its CPU run, mixed key widths and bucket
    padding included."""
    from yugabyte_db_tpu_torch.ops import compaction as pops
    rng = np.random.default_rng(3)
    runs = []
    for w in widths:
        n = 5000
        dk = rng.integers(0, 4, (n, w - 13)).astype(np.uint8)
        dk[:, 0] = 8
        ht = rng.integers(1, 60, n).astype(np.uint64) << np.uint64(12)
        wid = rng.integers(0, 3, n).astype(np.uint32)
        suf = np.concatenate(
            [np.full((n, 1), 5, np.uint8),
             (~ht).astype(">u8").view(np.uint8).reshape(n, 8),
             (~wid).astype(">u4").view(np.uint8).reshape(n, 4)], axis=1)
        runs.append((np.concatenate([dk, suf], axis=1),
                     rng.random(n) < 0.2))
    for cut in (0, 30 << 12, (1 << 64) - 1):
        c0 = pops.MERGE_GC_STATS["calls"]
        go, gk = pops.compact_runs(runs, cut, device=cuda_device)
        assert pops.MERGE_GC_STATS["calls"] == c0 + 1
        wo, wk = pops.compact_runs(runs, cut, device="cpu")
        assert np.array_equal(go, wo) and np.array_equal(gk, wk)


def _written_tablets(tmp_path, cuda_device):
    """A lineitem tablet on the card and its twin on the CPU: one bulk
    load, then the same RF1 inserts and RF2 deletes through apply_write
    at fixed hybrid times (SST + memtable)."""
    from yugabyte_db_tpu_torch.docdb.operations import RowOp, WriteRequest
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    data = tpch.generate_lineitem(0.005, seed=5)
    n = len(data["rowid"])
    tablets = {}
    for dev in (cuda_device, "cpu"):
        t = Tablet("t", tpch.lineitem_info(), str(tmp_path / str(dev)),
                   device=dev)
        t.bulk_load(data, ht=HybridTime(1 << 40), block_rows=8192)
        ht = (1 << 40) + (1 << 20)
        for order in tpch.refresh_inserts(0.005, n, seed=1):
            t.apply_write(WriteRequest("lineitem", [
                RowOp("upsert", r) for r in tpch.column_rows(order)]),
                ht=HybridTime(ht))
            ht += 1 << 12
        t.apply_write(WriteRequest("lineitem", [
            RowOp("delete", {"rowid": int(r)})
            for r in np.concatenate(
                tpch.refresh_deletes(0.005, n, seed=1))]),
            ht=HybridTime(ht))
        tablets[str(dev)] = t
    return tablets, (1 << 41)


@pytest.mark.cuda
@pytest.mark.parametrize("streamed", [True, False])
def test_cuda_dedup_read_over_memtable_matches_cpu(cuda_device, tmp_path,
                                                   streamed):
    """Q6 and Q1 over SST + memtable (the memtable's columnar block, MVCC
    mode dedup) on the card equal the CPU run bit for bit, and a
    major compaction on the card leaves one SST that K3 then reads
    (MVCC mode visible) within its tolerance of the plain version."""
    from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.utils import flags
    tablets, read_ht = _written_tablets(tmp_path, cuda_device)
    gpu, cpu = tablets[str(cuda_device)], tablets["cpu"]
    assert not gpu.regular.memtable_empty()

    def read(t, q):
        return t.read(ReadRequest("lineitem", where=q.where,
                                  aggregates=q.aggs, group_by=q.group,
                                  read_ht=read_ht))

    with flags.overridden("device_float_dtype", "float32"), \
            flags.overridden("streaming_chunk_rows", 16384), \
            flags.overridden("streaming_scan_enabled", streamed):
        for q in (tpch.TPCH_Q6, tpch.TPCH_Q1):
            got, want = read(gpu, q), read(cpu, q)
            assert got.backend == want.backend == "tpu"
            assert np.array_equal(got.group_counts, want.group_counts)
            for g, w in zip(got.agg_values, want.agg_values):
                assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
        with flags.overridden("tpu_compaction_enabled", True):
            assert gpu.compact() is not None
        assert len(gpu.regular.ssts) == 1 and gpu.regular.memtable_empty()
        for q in (tpch.TPCH_Q6, tpch.TPCH_Q1):
            want = read(cpu, q)
            got = read(gpu, q)
            assert np.array_equal(got.group_counts, want.group_counts)
            for g, w in zip(got.agg_values, want.agg_values):
                assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
            with flags.overridden("hand_scan_enabled", True):
                before = hs.LAUNCHES["generic_scan"]
                hand = read(gpu, q)
                assert hs.LAUNCHES["generic_scan"] > before
            assert np.array_equal(hand.group_counts, want.group_counts)
            for a, g, w in zip(q.aggs, hand.agg_values, want.agg_values):
                assert_partials(g, w, a.op)


# --- the tablet's vector index and the grouped spill tail on the card ---------
def _vector_table():
    from yugabyte_db_tpu_torch.docdb.table_codec import TableInfo
    from yugabyte_db_tpu_torch.dockv import packed_row as pr
    from yugabyte_db_tpu_torch.dockv.partition import PartitionSchema
    C, T = pr.ColumnSchema, pr.ColumnType
    return TableInfo("vt", "vt", pr.TableSchema(
        (C(0, "id", T.INT64, is_hash_key=True), C(1, "emb", T.VECTOR)), 1),
        PartitionSchema("hash", 1))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["ivfflat", "hnsw"])
def test_cuda_vector_tablet_matches_cpu(cuda_device, tmp_path, method):
    """A small (id, emb vector(32)) tablet on the card and its twin on the
    CPU: the same bulk load, index build, writes and restart answer with
    equal ids.  Every list is probed; the card's IVF re-ranks its bf16
    copy of the base in f32, so a hit's id is held to the CPU's at every
    rank whose CPU distance stands apart from its neighbours' by more
    than that rounding can move it (2^-6 |q|^2), the top hit always; the
    written vectors lie far from the base (their delta search is bf16 on
    the card) and are queried for their top hit; the no-index fallback
    (bf16 on the card) likewise."""
    from yugabyte_db_tpu_torch.docdb.operations import RowOp, WriteRequest
    from yugabyte_db_tpu_torch.tablet import Tablet
    rng = np.random.default_rng(4)
    n, d, nl = 2000, 32, 16
    base = rng.normal(size=(n, d)).astype(np.float32)
    far = rng.normal(size=(30, d)).astype(np.float32) + 20.0
    info = _vector_table()
    qs = base[:16] + 0.001
    tablets = {}
    for dev in (cuda_device, "cpu"):
        t = Tablet("v", info, str(tmp_path / str(dev)), device=dev)
        t.bulk_load({"id": np.arange(n, dtype=np.int64), "emb": base})
        tablets[str(dev)] = t
    gpu, cpu = tablets[str(cuda_device)], tablets["cpu"]

    def ids(t, q, k):
        return [p["id"] for p, _ in t.vector_search("emb", q, k=k,
                                                    nprobe=nl)]

    def same_hits(q, what):
        got = ids(gpu, q, 5)
        want = cpu.vector_search("emb", q, k=6, nprobe=nl)
        d = [h[1] for h in want]
        tol = 2.0 ** -6 * float(q @ q)
        assert got[0] == want[0][0]["id"], what
        for r in range(1, 5):
            if d[r] - d[r - 1] > tol and d[r + 1] - d[r] > tol:
                assert got[r] == want[r][0]["id"], (what, r)
        return got

    for i, q in enumerate(qs[:4]):          # no index: exact over a scan
        assert ids(gpu, q, 1) == ids(cpu, q, 1) == [i]
    opts = {"iters": 5} if method == "ivfflat" else {"m": 16}
    for t in (gpu, cpu):
        assert t.build_vector_index("emb", nl, method, opts) == n
    if method == "ivfflat":
        (st,) = gpu.vector_indexes.values()
        assert st.idx.device.type == "cuda"
    for q in qs:
        same_hits(q, "after the build")
    ops = ([RowOp("insert", {"id": 5000 + i, "emb": v.tobytes()})
            for i, v in enumerate(far[:20])]
           + [RowOp("upsert", {"id": 100 + i, "emb": v.tobytes()})
              for i, v in enumerate(far[20:])]
           + [RowOp("delete", {"id": int(i)}) for i in range(16)])
    for t in (gpu, cpu):
        t.apply_write(WriteRequest("vt", ops))
    want = [5000 + i for i in range(20)] + [100 + i for i in range(10)]

    def check(what):
        (gs,), (cs,) = gpu.vector_indexes.values(), cpu.vector_indexes.values()
        assert set(gs.delta) == set(cs.delta) and gs.dead == cs.dead, what
        for q in qs:
            got = same_hits(q, what)
            assert not set(got) & set(range(16)), what
        for v, i in zip(far, want):
            assert ids(gpu, v, 1) == ids(cpu, v, 1) == [i], what

    check("after the writes")
    for t in (gpu, cpu):
        t.flush()
    gpu = Tablet("v", info, gpu.dir, device=cuda_device)
    cpu = Tablet("v", info, cpu.dir, device="cpu")
    assert gpu.bootstrap_vector_indexes() == cpu.bootstrap_vector_indexes() \
        == 1
    (gs,) = gpu.vector_indexes.values()
    assert gs.idx.size == n and len(gs.delta) == 30 and len(gs.dead) == 26
    if method == "ivfflat":
        assert gs.idx.device.type == "cuda"
    check("after the restart")


@pytest.mark.cuda
@pytest.mark.parametrize("streamed", [True, False])
def test_cuda_spill_merge_matches_cpu(cuda_device, tmp_path, streamed):
    """The string Q1 with 6 groups in a 4-slot budget, on a tablet on the
    card and its twin on the CPU: both take the partial-spill merge and
    answer bit for bit alike under one float dtype."""
    from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops.grouped_scan import (GROUPED_STATS,
                                                        DictGroupSpec)
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils import flags
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    data = tpch.lineitem_str_data(tpch.generate_lineitem(0.02, seed=5))
    q = tpch.tpch_q1_str()
    group = DictGroupSpec(cols=q.group.cols, max_slots=4)
    out = []
    with flags.overridden("device_float_dtype", "float32"), \
            flags.overridden("streaming_chunk_rows", 32768), \
            flags.overridden("streaming_scan_enabled", streamed):
        for dev in (cuda_device, "cpu"):
            t = Tablet("s", tpch.lineitem_str_info(),
                       str(tmp_path / str(dev)), device=dev)
            t.bulk_load(data, ht=HybridTime(1 << 40), block_rows=8192)
            merges = GROUPED_STATS["spill_merges"]
            out.append(t.read(ReadRequest(
                "lineitem_s", where=q.where, aggregates=q.aggs,
                group_by=group, read_ht=1 << 41)))
            assert GROUPED_STATS["spill_merges"] == merges + 1
    got, want = out
    assert got.backend == want.backend == "tpu"
    assert np.array_equal(got.group_counts, want.group_counts)
    for a, b in zip(got.group_values, want.group_values):
        assert list(a) == list(b)
    for g, w in zip(got.agg_values, want.agg_values):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


# --- the row half's maintenance and colocation on the card -----------------
def _usertable_pair(tmp_path, cuda_device, n=20000):
    """A usertable tablet on the card and one on the CPU, each bulk
    loaded with the same `n` rows at one hybrid time."""
    from yugabyte_db_tpu_torch.models import ycsb
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    out = []
    for name, dev in (("card", cuda_device), ("cpu", "cpu")):
        t = Tablet("u", ycsb.usertable_info(), str(tmp_path / name),
                   device=dev)
        t.bulk_load(ycsb.generate_rows(n), ht=HybridTime(1 << 40))
        out.append(t)
    return out


def _altered_usertable(history=False):
    """The usertable at version 2 with a nullable `field10` (and, with
    `history`, version 1 as its ALTER history)."""
    from yugabyte_db_tpu_torch.docdb.table_codec import TableInfo
    from yugabyte_db_tpu_torch.dockv import packed_row as pr
    from yugabyte_db_tpu_torch.models import ycsb
    info = ycsb.usertable_info()
    cols = info.schema.columns + (
        pr.ColumnSchema(11, "field10", pr.ColumnType.STRING),)
    return TableInfo(info.table_id, info.name, pr.TableSchema(cols, 2),
                     info.partition_schema,
                     schema_history=(info.schema,) if history else ())


@pytest.mark.cuda
@pytest.mark.parametrize("step", ["alter", "repack", "restore", "truncate"])
def test_cuda_tablet_maintenance_matches_cpu(cuda_device, tmp_path, step):
    """After ALTER, the repacking compaction, a snapshot restore and
    TRUNCATE, the card's tablet answers the count/min/max aggregate,
    point reads (the host extension's readers) and a BETWEEN range
    exactly as the same tablet on the CPU."""
    from yugabyte_db_tpu_torch.docdb.operations import (ReadRequest, RowOp,
                                                        WriteRequest)
    from yugabyte_db_tpu_torch.ops.scan import AggSpec
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    gpu, cpu = _usertable_pair(tmp_path, cuda_device)
    tablets = [gpu, cpu]
    for t in tablets:
        t.alter_table(_altered_usertable())
        ops = [RowOp("upsert", {"ycsb_key": 20000 + k,
                                **{f"field{j}": f"n{k}" for j in range(11)}})
               for k in range(500)]
        t.apply_write(WriteRequest("usertable", ops),
                      ht=HybridTime((1 << 40) + 4096))
        if step != "alter":
            t.flush()
    if step == "repack":
        for t in tablets:
            t.compact()
            assert len(t.regular.ssts) == 1
    if step == "restore":
        out = []
        for i, t in enumerate(tablets):
            t.create_snapshot(str(tmp_path / f"s{i}"))
            out.append(Tablet.restore_snapshot(
                "r", _altered_usertable(history=True),
                str(tmp_path / f"s{i}"), str(tmp_path / f"r{i}"),
                device=t.device))
        tablets = out
    if step == "truncate":
        for t in tablets:
            assert t.truncate_table("usertable") >= 1
            t.apply_write(WriteRequest("usertable", [RowOp(
                "upsert", {"ycsb_key": 7, "field10": "back"})]),
                ht=HybridTime((1 << 40) + 8192))
    read_ht = (1 << 40) + (1 << 20)
    aggs = (AggSpec("count"), AggSpec("min", ("col", 0)),
            AggSpec("max", ("col", 0)))
    got, want = (t.read(ReadRequest("usertable", aggregates=aggs,
                                    read_ht=read_ht)) for t in tablets)
    assert got.backend == want.backend
    assert [np.asarray(v).tolist() for v in got.agg_values] == \
        [np.asarray(v).tolist() for v in want.agg_values]
    keys = [{"ycsb_key": k} for k in (0, 7, 19999, 20003, 20499, 99999)]
    assert tablets[0].multi_read("usertable", keys, read_ht=read_ht) == \
        tablets[1].multi_read("usertable", keys, read_ht=read_ht)
    between = ReadRequest("usertable", columns=("ycsb_key", "field10"),
                          where=("between", ("col", 0), ("const", 19995),
                                 ("const", 20005)), read_ht=read_ht)
    assert tablets[0].read(between).rows == tablets[1].read(between).rows


@pytest.mark.cuda
def test_cuda_doc_queries_match_cpu(cuda_device, tmp_path):
    """A small shredded document tablet: the bench query, a string-path
    predicate, a presence shape and a row read on the card (the exact
    route over the virtual lanes, then the hand route) and the keyless
    bypass answer exactly as the same tablet read on the CPU."""
    from yugabyte_db_tpu_torch.bypass import BypassSession
    from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
    from yugabyte_db_tpu_torch.docstore import LAST_DOC_STATS
    from yugabyte_db_tpu_torch.models import docbench as db
    from yugabyte_db_tpu_torch.ops.scan import AggSpec
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils import flags
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    cpu = Tablet("d", db.docs_info(), str(tmp_path), device="cpu")
    cpu.bulk_load(db.generate_docs(40000, 3), ht=HybridTime(1 << 40),
                  block_rows=8192)
    gpu = Tablet("d", db.docs_info(), str(tmp_path), device=cuda_device)
    tag = ("json", "text", ("col", db.DOC_COL), "tag")
    region = ("json", "text", ("json", "text", ("col", db.DOC_COL), "meta"),
              "region")
    w, a = db.doc_qty_query()
    shapes = [dict(where=w, aggregates=a),
              dict(where=("cmp", "eq", tag, ("const", "beta")),
                   aggregates=(AggSpec("count"), AggSpec("sum", a[0].expr))),
              dict(where=("cmp", "eq", region, ("const", "eu")),
                   aggregates=(AggSpec("count"),)),
              dict(where=("isnull", ("json", "text", ("col", db.DOC_COL),
                                     "qty")),
                   aggregates=(AggSpec("count"),)),
              dict(where=w, columns=("id", "doc"))]
    read_ht = (1 << 40) + 4096
    for hand in (False, True):
        with flags.overridden("hand_scan_enabled", hand):
            for kw in shapes:
                got = gpu.read(ReadRequest("docs", read_ht=read_ht, **kw))
                assert got.backend == "tpu" and LAST_DOC_STATS["coverage"] > 0
                want = cpu.read(ReadRequest("docs", read_ht=read_ht, **kw))
                assert want.backend == "tpu"
                if got.agg_values is None:
                    assert got.rows == want.rows and got.rows
                else:
                    assert [np.asarray(v).tolist() for v in got.agg_values] \
                        == [np.asarray(v).tolist() for v in want.agg_values]
    with BypassSession([gpu], read_ht=read_ht, device=cuda_device) as s:
        outs, _, _ = s.scan_aggregate(w, a)
    want = cpu.read(ReadRequest("docs", read_ht=read_ht, where=w,
                                aggregates=a))
    assert [np.asarray(v).tolist() for v in outs] == \
        [np.asarray(v).tolist() for v in want.agg_values]
