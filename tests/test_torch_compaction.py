"""The compaction slice against the JAX reference on the CPU: the merge
program (ops/compaction.py chunk_merge_kernel) bit for bit with the
jitted JAX function on seeded frontiers and edge cases, the reference's
scalar GC cases through it (against the reference's whole-input
program), the
whole engine (docdb/compaction.py tpu_compact, device backend on the CPU
and the baseline backend) byte for byte against the reference's on equal
stores, the row routes both packages take where the columnar engines
refuse (row-format inputs, keys without the hybrid-time suffix, a block
that turns ineligible mid-stream, the store's own feed compaction) and
the typed refusals that remain."""
import os

import numpy as np
import pytest
import torch

from yugabyte_db_tpu.docdb import compaction as jcomp
from yugabyte_db_tpu.docdb.table_codec import TableCodec as JCodec
from yugabyte_db_tpu.dockv import DocKey, KeyEntryValue, SubDocKey
from yugabyte_db_tpu.models import tpch as jtpch
from yugabyte_db_tpu.ops import compaction as jops
from yugabyte_db_tpu.storage.lsm import LsmStore as JStore
from yugabyte_db_tpu.storage.pipeline import StreamPipeline as JPipe
from yugabyte_db_tpu.utils.hybrid_time import DocHybridTime as JDHT
from yugabyte_db_tpu.utils.hybrid_time import HybridTime as JHT
from yugabyte_db_tpu_torch.device import DeviceUnavailable
from yugabyte_db_tpu_torch.docdb import compaction as pcomp
from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec
from yugabyte_db_tpu_torch.errors import NotPortedError
from yugabyte_db_tpu_torch.models import tpch
from yugabyte_db_tpu_torch.ops import compaction as pops
from yugabyte_db_tpu_torch.storage import native_lib
from yugabyte_db_tpu_torch.storage.lsm import LsmStore
from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
from tests.torch_parity import (COMPACT_BASE_US, MERGE_CASES,
                                compaction_batches, flags_set,
                                frontier_carries, merge_frontier_case,
                                sorted_frontier_row, tombstoned_block)

U64_MAX = (1 << 64) - 1


# --- the merge programs ------------------------------------------------------
def _cutoffs(ht):
    """Below every write, in the middle, above every write."""
    s = np.sort(ht)
    return [int(s[0]) - 1 if s[0] else 0, int(s[len(s) // 2]),
            int(s[-1])]


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(got, want, what):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), what


@pytest.mark.parametrize("case", MERGE_CASES)
@pytest.mark.parametrize("with_bound", [False, True])
def test_chunk_merge_kernel_matches_jax(case, with_bound):
    dk, ht, wid, tomb, valid = merge_frontier_case(case, seed=3)
    m = len(ht)
    bound = None
    if with_bound:
        # the bound at a frontier row (a row equal to it stays pending)
        # and beyond the frontier's keys
        b = sorted_frontier_row(dk, ht, wid, valid, int(valid.sum()) // 2)
        bound = (dk[b], int(ht[b]), int(wid[b]))
    for carry in [None] + frontier_carries(dk, ht, wid, valid):
        for cutoff in _cutoffs(ht[valid]):
            jo, je, jk = jops.merge_frontier(dk, ht, wid, tomb, valid, bound,
                                             carry, cutoff)
            po, pe, pk = pops.merge_frontier(dk, ht, wid, tomb, valid,
                                             bound, carry, cutoff,
                                             device="cpu")
            what = f"{case} bound={with_bound} carry={carry is not None}"
            _same(po, jo, what + " order")
            _same(pe, je, what + " emit")
            _same(pk, jk, what + " keep")
            assert m == len(_np(po))


def test_chunk_merge_bound_beyond_and_below_every_key():
    dk, ht, wid, tomb, valid = merge_frontier_case("random", seed=5)
    for bound in ((np.full(2, U64_MAX, np.uint64), 0, 0),
                  (np.zeros(2, np.uint64), U64_MAX, U64_MAX >> 32)):
        jo, je, jk = jops.merge_frontier(dk, ht, wid, tomb, valid, bound,
                                         None, 1 << 41)
        po, pe, pk = pops.merge_frontier(dk, ht, wid, tomb, valid, bound,
                                         None, 1 << 41, device="cpu")
        for g, w in ((po, jo), (pe, je), (pk, jk)):
            _same(g, w, "bound")


def test_chunk_merge_matches_the_host_twin():
    """The device program against the reference's host twin of one
    chunk (k-way merge + _retention_keep with carry), on keys built as
    full SubDocKeys."""
    rng = np.random.default_rng(2)
    specs = [(int(rng.integers(0, 60)), int(rng.integers(1, 30)) * 10,
              int(rng.integers(0, 3))) for _ in range(700)]
    keys = _build_keys(specs)
    tomb = rng.random(len(specs)) < 0.25
    dk, ht, wid = pops.split_ht_suffix(keys)
    words = pops.keys_to_words(dk)
    cutoff = JHT.from_micros(150).value
    carry_key = keys[rng.integers(0, len(keys))].tobytes()
    _, c_ht, c_wid = pops.split_ht_suffix(
        np.frombuffer(carry_key, np.uint8)[None, :])
    carry = (pops.keys_to_words(np.frombuffer(
        carry_key, np.uint8)[None, :-pops._HT_SUFFIX])[0], int(c_ht[0]),
        int(c_wid[0]), True)
    order, emit, keep = pops.merge_frontier(
        words, ht, wid, tomb, np.ones(len(ht), bool), None, carry, cutoff,
        device="cpu")
    h_order, dup = native_lib.kway_merge_fixed_plain(
        keys, np.array([0, len(keys)]))
    assert np.array_equal(_np(order), h_order)
    dup = pcomp._flag_carry_dup(dup, keys[h_order[0]].tobytes(), carry_key)
    ht_s = ht[h_order]
    h_keep = pcomp._retention_keep(
        dup, ht_s, ht_s <= np.uint64(cutoff), lambda: keys[h_order],
        lambda: tomb[h_order], carry_key, True, cutoff)
    assert np.array_equal(_np(keep), h_keep)
    assert _np(emit).all()


# --- the reference's scalar GC cases (test_ops_compaction_vector.py) -----------
def _build_keys(specs):
    """specs: list of (pk, ht_micros, wid) -> [N, L] SubDocKey matrix."""
    mats = []
    for pk, ht, wid in specs:
        sdk = SubDocKey(DocKey.make(range=(KeyEntryValue.int64(pk),)), (),
                        JDHT(JHT.from_micros(ht), wid))
        mats.append(np.frombuffer(sdk.encode(), np.uint8))
    return np.stack(mats)


def _ht(micros):
    return JHT.from_micros(micros).value


def _gc(runs, cutoff):
    """(order, keep) of sorted runs [(keys [Ni, Li], tombstone [Ni])]
    merged as one frontier with no bound and no carry (the whole input
    in one chunk): each run's hybrid-time suffix split off, doc keys
    zero-padded to one width (prefix freedom keeps their order)."""
    parts = [pops.split_ht_suffix(keys) for keys, _ in runs]
    n = sum(len(ht) for _, ht, _ in parts)
    dk = np.zeros((n, max(d.shape[1] for d, _, _ in parts)), np.uint8)
    pos = 0
    for d, _, _ in parts:
        dk[pos:pos + len(d), :d.shape[1]] = d
        pos += len(d)
    order, emit, keep = pops.merge_frontier(
        pops.keys_to_words(dk), np.concatenate([h for _, h, _ in parts]),
        np.concatenate([w for _, _, w in parts]),
        np.concatenate([t for _, t in runs]), np.ones(n, bool), None, None,
        cutoff, device="cpu")
    assert _np(emit).all()
    return _np(order), _np(keep)


def _kept_hts(keys, order, keep):
    _, hts, _ = pops.split_ht_suffix(keys)
    return sorted(int(hts[i]) for i, k in zip(order, keep) if k)


@pytest.mark.parametrize("specs,tomb,cutoff,want", [
    # gc drops overwritten history: keep 300 (> cutoff) and 200
    ([(5, 100, 0), (5, 200, 0), (5, 300, 0)], [0, 0, 0], 250, [200, 300]),
    # every version above the cutoff stays
    ([(5, 100, 0), (5, 200, 0)], [0, 0], 50, [100, 200]),
    # a delete at 200 covers the write at 100; cutoff above both
    ([(5, 100, 0), (5, 200, 0)], [0, 1], 300, []),
    # a tombstone above the cutoff stays, 100 is the latest <= cutoff
    ([(5, 100, 0), (5, 200, 0)], [0, 1], 150, [100, 200]),
])
def test_gc_scalar_cases(specs, tomb, cutoff, want):
    keys = _build_keys(specs)
    order, keep = _gc([(keys, np.array(tomb, bool))], _ht(cutoff))
    assert _kept_hts(keys, order, keep) == [_ht(w) for w in want]
    jo, jk = jops.compact_entry_arrays(keys, np.array(tomb, bool),
                                       _ht(cutoff))
    assert np.array_equal(order, jo) and np.array_equal(keep, jk)


def test_merge_sorts_and_dedups():
    keys = _build_keys([(2, 100, 0), (1, 100, 0), (1, 100, 0)])
    order, keep = _gc([(keys, np.zeros(3, bool))], 0)
    kept = [keys[i].tobytes() for i, k in zip(order, keep) if k]
    assert len(kept) == 2 and kept == sorted(kept)


def test_compact_runs_mixed_widths():
    run1 = _build_keys([(1, 100, 0), (3, 100, 0)])
    mats = []
    for pk in (2, 4):
        sdk = SubDocKey(DocKey.make(range=(KeyEntryValue.int64(pk),
                                           KeyEntryValue.string("xx"))),
                        (), JDHT(JHT.from_micros(100), 0))
        mats.append(np.frombuffer(sdk.encode(), np.uint8))
    run2 = np.stack(mats)
    runs = [(run1, np.zeros(2, bool)), (run2, np.zeros(2, bool))]
    order, keep = _gc(runs, 0)
    jo, jk = jops.compact_runs(runs, 0)
    assert np.array_equal(order, jo) and np.array_equal(keep, jk)
    all_keys = [run1[0], run1[1], run2[0], run2[1]]
    pks = [DocKey.decode(all_keys[i].tobytes())[0].range[0].value
           for i, k in zip(order, keep) if k]
    assert pks == [1, 2, 3, 4]


def test_fuzz_against_scalar_gc():
    rng = np.random.default_rng(11)
    specs = list(dict.fromkeys(
        (int(rng.integers(0, 40)), int(rng.integers(1, 50)) * 10, 0)
        for _ in range(300)))
    keys = _build_keys(specs)
    tomb = rng.random(len(specs)) < 0.2
    cutoff = _ht(250)
    order, keep = _gc([(keys, tomb)], cutoff)
    by_pk = {}
    for i, (pk, ht, _wid) in enumerate(specs):
        by_pk.setdefault(pk, []).append((_ht(ht), tomb[i], i))
    expect = set()
    for versions in by_pk.values():
        versions.sort(reverse=True)
        latest_leq_done = False
        for htv, tb, i in versions:
            if htv > cutoff:
                expect.add(i)
            elif not latest_leq_done:
                latest_leq_done = True
                if not tb:
                    expect.add(i)
    assert {int(order[j]) for j in range(len(keep)) if keep[j]} == expect


def test_key_helpers_match_reference():
    rng = np.random.default_rng(4)
    keys = _build_keys([(int(p), int(h), int(w)) for p, h, w in zip(
        rng.integers(-10**6, 10**6, 50), rng.integers(1, 10**6, 50),
        rng.integers(0, 1 << 32, 50))])
    for a, b in zip(pops.split_ht_suffix(keys), jops.split_ht_suffix(keys)):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    assert np.array_equal(pops.keys_to_words(keys),
                          jops.keys_to_words(keys))
    with pytest.raises(pops.KeySuffixError):
        pops.split_ht_suffix(keys[20:, :-1])      # marker off its place
    with pytest.raises(pops.KeySuffixError):
        pops.check_ht_suffix(keys[:, :13])        # no room for a suffix
    pops.check_ht_suffix(keys)
    assert pops._pad_rows(4097) == jops._pad_rows(4097) == 8192


def test_kernel_call_accounting():
    dk, ht, wid, tomb, valid = merge_frontier_case("random", m=4096)
    pops.reset_kernel_stats()
    before = pops.kernel_cache_stats()
    pops.merge_frontier(dk, ht, wid, tomb, valid, None, None, 0,
                        device="cpu")
    pops.merge_frontier(dk, ht, wid, tomb, valid, None, None, 0,
                        device="cpu")
    after = pops.kernel_cache_stats()
    assert after["calls"] - before["calls"] == 2
    assert after["cache_hits"] - before["cache_hits"] >= 1


# --- the whole engine ----------------------------------------------------------
def _jbulk(store, codec, cols, ht, block_rows):
    """The reference's Tablet.bulk_load body into a bare store."""
    blocks = codec.bulk_blocks_iter(cols, ht, block_rows=block_rows)

    def build(w):
        pipe = JPipe([lambda blk: (w.add_columnar_block(blk), blk.n)[1]],
                     depth=2)
        for _ in pipe.run(blocks):
            pass
    store.ingest_sst(build, stream=True)


_TABLES = {"lineitem": (jtpch.lineitem_info, tpch.lineitem_info, False),
           "lineitem_str": (jtpch.lineitem_str_info, tpch.lineitem_str_info,
                            True)}


def _equal_stores(tmp_path, table: str, n_ssts: int = 8,
                  rows_per: int = 4500, block_rows: int = 512,
                  straddle: bool = False):
    """Equal stores in both packages: SST i rewrites a quarter of SST
    i-1's rows at a later hybrid time, plus a tombstone SST; with
    `straddle`, every SST rewrites the same few hundred rows (many
    versions per doc key, straddling chunks)."""
    jinfo, pinfo, strings = _TABLES[table]
    data = tpch.generate_lineitem(0.002, seed=7)
    if strings:
        data = tpch.lineitem_str_data(data)
    jc, pc = JCodec(jinfo()), TableCodec(pinfo())
    js = JStore(str(tmp_path / "j"), key_builder=jc.derive_keys,
                shred_cols=jc.shred_cols)
    ps = LsmStore(str(tmp_path / "p"), key_builder=pc.derive_keys,
                  shred_cols=pc.shred_cols)
    hts = []
    for sel, us in compaction_batches(data, n_ssts, rows_per, straddle):
        batch = {k: v[sel] for k, v in data.items()}
        hts.append(JHT.from_micros(us).value)
        _jbulk(js, jc, batch, JHT.from_micros(us), block_rows)
        assert pc.bulk_ingest(ps, batch, HybridTime.from_micros(us),
                              block_rows=block_rows) == len(sel)
    sel = np.nonzero(data["rowid"] % 10 == 0)[0]
    batch = {k: v[sel] for k, v in data.items()}
    us = COMPACT_BASE_US + (n_ssts // 2) * 1000 - 500
    from yugabyte_db_tpu.storage.columnar import ColumnarBlock as JB
    from yugabyte_db_tpu_torch.storage.columnar import ColumnarBlock as PB
    jt = [tombstoned_block(b, JB) for b in jc.bulk_blocks_iter(
        batch, JHT.from_micros(us), block_rows=block_rows)]
    pt = [tombstoned_block(b, PB) for b in pc.bulk_blocks_iter(
        batch, HybridTime.from_micros(us), block_rows=block_rows)]
    js.ingest_sst(lambda w: [w.add_columnar_block(b) for b in jt],
                  stream=True)
    ps.ingest_sst(lambda w: [w.add_columnar_block(b) for b in pt],
                  stream=True)
    return (js, jc), (ps, pc), sorted(hts)


def _with_row_codecs(js, jc, ps, pc):
    """Bind each codec's columnar builder and row decoder to its store
    and the store's readers, as a tablet's store has them (the row
    routes read columnar-only blocks back as KV entries)."""
    for store, codec in ((js, jc), (ps, pc)):
        store.columnar_builder = codec.columnar_builder
        store.row_decoder = codec.row_decoder
        for r in store.ssts:
            r.row_decoder = codec.row_decoder


def _same_store_files(js, ps):
    assert [os.path.basename(r.path) for r in js.ssts] == \
        [os.path.basename(r.path) for r in ps.ssts]
    for a, b in zip(js.ssts, ps.ssts):
        assert open(a.path, "rb").read() == open(b.path, "rb").read(), \
            (a.path, b.path)
    assert open(js._manifest_path, "rb").read() == \
        open(ps._manifest_path, "rb").read()


def _cutoff(hts, where):
    return {"below": hts[0] - 1, "middle": hts[len(hts) // 2],
            "above": hts[-1] + 1}[where]


@pytest.mark.parametrize("where", ["below", "middle", "above"])
@pytest.mark.parametrize("backend", ["device", "baseline"])
@pytest.mark.parametrize("table", ["lineitem", "lineitem_str"])
def test_engine_matches_reference_byte_for_byte(tmp_path, table, backend,
                                                where):
    (js, jc), (ps, pc), hts = _equal_stores(tmp_path, table)
    for a, b in zip(js.ssts, ps.ssts):
        assert open(a.path, "rb").read() == open(b.path, "rb").read()
    cutoff = _cutoff(hts, where)
    with flags_set({"compaction_chunk_rows": 1024},
                   {"compaction_chunk_rows": 1024}):
        jp = jcomp.tpu_compact(js, jc, cutoff, block_rows=700,
                               backend=backend)
        if backend == "device":
            jstats = dict(jcomp.LAST_COMPACTION_STATS)
        pp = pcomp.tpu_compact(ps, pc, cutoff, block_rows=700,
                               backend=backend, device="cpu")
    if backend == "device":
        st = pcomp.LAST_COMPACTION_STATS
        assert st["chunks"] >= 8
        for k in ("chunks", "frontier_rows", "emitted_rows", "kept_rows",
                  "m_cap", "m_growths", "output_bytes", "lanes"):
            assert st[k] == jstats[k], k
    assert os.path.basename(jp) == os.path.basename(pp)
    assert open(jp, "rb").read() == open(pp, "rb").read()
    assert [os.path.basename(r.path) for r in ps.ssts] == \
        [os.path.basename(r.path) for r in js.ssts]
    assert open(os.path.join(js.dir, "db.MANIFEST")).read() == \
        open(os.path.join(ps.dir, "db.MANIFEST")).read()


@pytest.mark.parametrize("backend", ["device", "baseline"])
def test_versions_straddling_chunks(tmp_path, backend):
    """Every SST rewrites the same 600 doc keys: each key's versions run
    across chunk boundaries, so the carry decides retention there (the
    reference's test_chunk_straddling_device_kernel, on bulk loads)."""
    (js, jc), (ps, pc), hts = _equal_stores(tmp_path, "lineitem",
                                            n_ssts=30, block_rows=128,
                                            straddle=True)
    cutoff = _cutoff(hts, "middle")
    with flags_set({"compaction_chunk_rows": 64},
                   {"compaction_chunk_rows": 64}):
        jp = jcomp.tpu_compact(js, jc, cutoff, block_rows=256,
                               backend=backend)
        pp = pcomp.tpu_compact(ps, pc, cutoff, block_rows=256,
                               backend=backend, device="cpu")
    if backend == "device":
        assert pcomp.LAST_COMPACTION_STATS["chunks"] > 4
    assert open(jp, "rb").read() == open(pp, "rb").read()


def test_device_and_baseline_outputs_agree(tmp_path):
    (_, _), (ps, pc), hts = _equal_stores(tmp_path / "a", "lineitem_str")
    (_, _), (ps2, _), _ = _equal_stores(tmp_path / "b", "lineitem_str")
    cutoff = _cutoff(hts, "middle")
    with flags_set({}, {"compaction_chunk_rows": 2048}):
        a = pcomp.tpu_compact(ps, pc, cutoff, backend="device",
                              device="cpu")
    b = pcomp.tpu_compact(ps2, pc, cutoff, backend="baseline", device="cpu")
    assert open(a, "rb").read() == open(b, "rb").read()
    assert len(ps.ssts) == 1 and len(ps2.ssts) == 1


def test_store_reopens_and_compacts_again(tmp_path):
    """The port's LsmStore opens the manifest a compaction left; a second
    compaction of the single output keeps every row."""
    (_, _), (ps, pc), hts = _equal_stores(tmp_path, "lineitem", n_ssts=3)
    pcomp.tpu_compact(ps, pc, _cutoff(hts, "above"), device="cpu")
    again = LsmStore(ps.dir, key_builder=pc.derive_keys)
    (only,) = again.ssts
    rows = only.num_entries
    pcomp.tpu_compact(again, pc, _cutoff(hts, "above"), device="cpu")
    assert again.ssts[0].num_entries == rows
    assert pcomp.tpu_compact(again, pc, 0, inputs=[], device="cpu") is None


# --- refusals and the device rule --------------------------------------------
def test_tpu_compact_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    (_, _), (ps, pc), hts = _equal_stores(tmp_path, "lineitem", n_ssts=2)
    for backend in ("device", "baseline"):
        with pytest.raises(DeviceUnavailable):
            pcomp.tpu_compact(ps, pc, hts[-1], backend=backend)
    assert len(ps.ssts) == 3          # nothing was touched


def _reason(excinfo):
    return str(excinfo.value)


def test_refuses_native_backend(tmp_path):
    (_, _), (ps, pc), hts = _equal_stores(tmp_path, "lineitem", n_ssts=2)
    with pytest.raises(NotPortedError) as e:
        pcomp.tpu_compact(ps, pc, hts[-1], backend="native", device="cpu")
    assert "native" in _reason(e) and "item 9" in _reason(e)
    with pytest.raises(ValueError):
        pcomp.tpu_compact(ps, pc, hts[-1], backend="tpu", device="cpu")


@pytest.mark.parametrize("backend", ["device", "baseline"])
def test_refuses_row_format_inputs(tmp_path, backend):
    """An SST of row KV blocks (no columnar sidecar: its one value does
    not unpack) in the store: both packages compact through their row
    route (``_compact_rows`` for the device backend, the CPU feed for
    the baseline) into the same file."""
    (js, jc), (ps, pc), hts = _equal_stores(tmp_path, "lineitem", n_ssts=2)
    _with_row_codecs(js, jc, ps, pc)
    kv = (b"\x08\x00\x01k\x04\x05" + b"\x00" * 12, b"\x21row")
    for store in (js, ps):
        store.ingest_sst(lambda w: w.add(*kv))
    _same_store_files(js, ps)
    assert ps.ssts[0].columnar_block(0) is None
    jp = jcomp.tpu_compact(js, jc, hts[-1], backend=backend)
    pp = pcomp.tpu_compact(ps, pc, hts[-1], backend=backend, device="cpu")
    assert os.path.basename(jp) == os.path.basename(pp)
    _same_store_files(js, ps)
    assert len(ps.ssts) == 1
    assert ps.get(kv[0]) == kv[1]


@pytest.mark.parametrize("backend", ["device", "baseline"])
def test_refuses_keys_without_hybrid_time_suffix(tmp_path, backend,
                                                 monkeypatch):
    """A corrupt key matrix: both packages degrade to the CPU feed and
    write the same file."""
    (js, jc), (ps, pc), hts = _equal_stores(tmp_path, "lineitem", n_ssts=2)
    _with_row_codecs(js, jc, ps, pc)
    from yugabyte_db_tpu.storage import sst as jsst
    from yugabyte_db_tpu_torch.storage import sst as psst
    for mod in (jsst, psst):
        for name in ("read_columnar", "columnar_block"):
            orig = getattr(mod.SstReader, name)

            def corrupt(self, i, _orig=orig):
                blk = _orig(self, i)
                k = blk.keys.copy()
                k[:, -13] = 0
                blk.keys = k
                return blk
            monkeypatch.setattr(mod.SstReader, name, corrupt)
    with pytest.raises(pops.KeySuffixError):
        pcomp._compact_columnar(ps, pc, [ps.ssts[0].read_columnar(0)],
                                ps.ssts, hts[-1], 700, np.zeros(1, np.int64))
    jp = jcomp.tpu_compact(js, jc, hts[-1], backend=backend)
    pp = pcomp.tpu_compact(ps, pc, hts[-1], backend=backend, device="cpu")
    assert os.path.basename(jp) == os.path.basename(pp)
    _same_store_files(js, ps)
    assert len(ps.ssts) == 1
    assert not [f for f in os.listdir(ps.dir) if f.endswith(".tmp")]


def test_refuses_mixed_schema_versions_mid_stream(tmp_path):
    """Blocks of a schema version the codec does not know: the chunked
    engine aborts mid-stream and both packages take the row route,
    which cannot decode them either — the same error, the store
    untouched and no partial file left."""
    (js, jc), (ps, pc), hts = _equal_stores(tmp_path, "lineitem", n_ssts=2)
    _with_row_codecs(js, jc, ps, pc)
    data = tpch.generate_lineitem(0.0005, seed=1)
    ht = COMPACT_BASE_US + 10_000
    jblocks = list(jc.bulk_blocks_iter(data, JHT.from_micros(ht),
                                       block_rows=512))
    pblocks = list(pc.bulk_blocks_iter(data, HybridTime.from_micros(ht),
                                       block_rows=512))
    for b in jblocks + pblocks:
        b.schema_version = 2
    js.ingest_sst(lambda w: [w.add_columnar_block(b) for b in jblocks])
    ps.ingest_sst(lambda w: [w.add_columnar_block(b) for b in pblocks])
    with pytest.raises(KeyError) as je:
        jcomp.tpu_compact(js, jc, hts[-1])
    with pytest.raises(KeyError) as pe:
        pcomp.tpu_compact(ps, pc, hts[-1], device="cpu")
    assert pe.value.args == je.value.args == (2,)
    assert len(ps.ssts) == 4
    _same_store_files(js, ps)
    assert not [f for f in os.listdir(ps.dir) if f.endswith(".tmp")]


def test_refuses_shredding_and_encryption(tmp_path):
    from yugabyte_db_tpu_torch.docdb.table_codec import TableInfo
    from yugabyte_db_tpu_torch.dockv.packed_row import (ColumnSchema,
                                                        ColumnType,
                                                        TableSchema)
    from yugabyte_db_tpu_torch.dockv.partition import PartitionSchema
    info = TableInfo("d", "d", TableSchema(columns=(
        ColumnSchema(0, "k", ColumnType.INT64, is_hash_key=True),
        ColumnSchema(1, "doc", ColumnType.JSON)), version=1),
        PartitionSchema("hash", 1))
    codec = TableCodec(info)
    assert codec.shred_cols == (1,)
    store = LsmStore(str(tmp_path / "d"), key_builder=codec.derive_keys,
                     shred_cols=codec.shred_cols)
    with pytest.raises(NotPortedError) as e:
        store.ingest_sst(lambda w: None)
    assert "shredding" in _reason(e)
    # the store's own feed compaction (no GC) is ported: the same file
    (js, jc), (ps, pc), hts = _equal_stores(tmp_path, "lineitem", n_ssts=2)
    _with_row_codecs(js, jc, ps, pc)
    assert os.path.basename(js.compact()) == os.path.basename(ps.compact())
    _same_store_files(js, ps)
    # a tablet holding an encrypted SST (the reference's envelope) does
    # not open, so it never reaches a compaction
    with open(ps.ssts[-1].path, "r+b") as f:
        f.write(b"YBTPUEN2")
    with pytest.raises(NotPortedError) as e:
        LsmStore(ps.dir, key_builder=pc.derive_keys)
    assert "encrypt" in _reason(e) and "item 9" in _reason(e)


def test_host_merge_helpers_match_numpy():
    """The host twins' gathers and emit count (the reference's native
    backend helpers) against plain numpy."""
    rng = np.random.default_rng(8)
    segs = [np.sort(rng.integers(0, 256, (n, 6)).astype(np.uint8), axis=0)
            for n in (40, 0, 25, 60)]
    segs = [np.ascontiguousarray(s) for s in segs]
    run_starts = np.cumsum([0] + [len(s) for s in segs])
    cat = np.concatenate(segs)
    pos = rng.permutation(len(cat)).astype(np.int64)
    assert np.array_equal(pcomp._gather_seg_rows(segs, run_starts, pos),
                          cat[pos])
    assert np.array_equal(pcomp._g(cat, pos[:30]), cat[pos[:30]])
    assert np.array_equal(pcomp._g(cat[:, ::2], pos[:30]),
                          cat[:, ::2][pos[:30]])   # numpy for a view
    dst = np.zeros_like(cat)
    pcomp._gs(cat, pos, dst, pos[::-1].copy())
    want = np.zeros_like(cat)
    want[pos[::-1]] = cat[pos]
    assert np.array_equal(dst, want)
    vt = np.dtype((np.void, 6))
    voids = [s.view(vt).reshape(-1) for s in segs]
    bound = cat[pos[7]].tobytes()
    want_n = sum(r.tobytes() < bound for s in segs for r in s)
    assert pcomp._emit_count(voids, bound, len(cat), vt) == want_n
    assert pcomp._emit_count(voids, None, len(cat), vt) == len(cat)
