"""The port's document store (yugabyte_db_tpu_torch/docstore/, the v2
writer's shredded lanes, the doc-path rewrite in docdb/operations.py and
bypass/scan.py) against the reference's on the CPU.

The reference's tests/test_docstore.py classes, with both packages run
on the same seeded documents on paired tablets under mock clocks (the
port's with ``device="cpu"``): SST files byte for byte with shredding
on and off, in formats v1 and v2 and after compaction on every backend;
every doc shape the reference pushes down gives its answer (ints
exactly, floats bit for bit at the same device dtype) and the same
``DOC_STATS``/``LAST_DOC_STATS``; every shape it refuses falls back
with the same typed reason.  Each pushed-down answer also equals the
interpreted answer over the same SSTs (``doc_shred_enabled`` off at
read time).  TestSqlDocPushdown waits for the SQL layer (ROADMAP.md
item 9f).  Tolerance: none."""
import copy
import json
import os

import numpy as np
import pytest

from yugabyte_db_tpu.docdb import compaction as jcomp
from yugabyte_db_tpu.docdb.operations import ReadRequest as JReq
from yugabyte_db_tpu.docdb.operations import RowOp as JOp
from yugabyte_db_tpu.docdb.operations import WriteRequest as JW
from yugabyte_db_tpu.docstore import pushdown as jpush
from yugabyte_db_tpu.docstore import shred as jshred
from yugabyte_db_tpu.models import docbench as jdocs
from yugabyte_db_tpu.ops.scan import AggSpec as JAgg
from yugabyte_db_tpu.storage import sst as jsst
from yugabyte_db_tpu.tablet import Tablet as JTablet
from yugabyte_db_tpu.utils import hybrid_time as jht
from yugabyte_db_tpu_torch.docdb import compaction as pcomp
from yugabyte_db_tpu_torch.docdb.operations import (ReadRequest, RowOp,
                                                    WriteRequest)
from yugabyte_db_tpu_torch.docstore import pushdown as ppush
from yugabyte_db_tpu_torch.docstore import shred as pshred
from yugabyte_db_tpu_torch.docstore.errors import (REASON_DOC_SHAPE,
                                                   REASON_UNSHREDDED_BLOCK)
from yugabyte_db_tpu_torch.models import docbench as pdocs
from yugabyte_db_tpu_torch.ops.scan import AggSpec
from yugabyte_db_tpu_torch.storage import sst as psst
from yugabyte_db_tpu_torch.storage.columnar import ColumnarBlock
from yugabyte_db_tpu_torch.tablet import Tablet
from yugabyte_db_tpu_torch.utils import hybrid_time as pht
from tests.torch_parity import (WRITE_BASE_US, assert_same_value,
                                flags_set, store_files)


def J(key, inner=("col", 1)):
    return ("json", "text", inner, key)


def CASTI(n):
    return ("fn", "cast_bigint", n)


def CASTF(n):
    return ("fn", "cast_double", n)


def make_doc(i):
    d = {"qty": int(i % 50), "price": float(i) * 1.5 + 0.25,
         "tag": ["alpha", "beta", "gamma"][i % 3],
         "meta": {"region": ["us", "eu"][i % 2]},
         "arr": [1, 2]}
    if i % 7 == 0:
        d.pop("qty")
    if i % 11 == 0:
        d["qty_null"] = None
    return d


def both(name, value):
    """The same flag value in both packages."""
    return flags_set({name: value}, {name: value})


class Pair:
    """A reference and a port tablet of docbench's table (the port's on
    the CPU), each on its own mock clock; every write advances both
    clocks alike."""

    def __init__(self, root, name="docs-t", infos=None):
        jinfo, pinfo = infos or (jdocs.docs_info(), pdocs.docs_info())
        self.table = jinfo.table_id
        self.jphys = jht.MockPhysicalClock(WRITE_BASE_US)
        self.pphys = pht.MockPhysicalClock(WRITE_BASE_US)
        self.jt = JTablet(name, jinfo, os.path.join(root, "j"),
                          clock=jht.HybridClock(self.jphys))
        self.pt = Tablet(name, pinfo, os.path.join(root, "p"),
                         clock=pht.HybridClock(self.pphys), device="cpu")

    def advance(self, us=10):
        self.jphys.advance_micros(us)
        self.pphys.advance_micros(us)

    def write(self, lo, hi, mutate=None, key="id"):
        self.advance()
        rows = []
        for i in range(lo, hi):
            d = make_doc(i)
            if mutate:
                mutate(i, d)
            rows.append({key: i, "doc": json.dumps(d)})
        self.jt.apply_write(JW(self.table, [JOp("upsert", dict(r))
                                            for r in rows]))
        self.pt.apply_write(WriteRequest(self.table, [
            RowOp("upsert", dict(r)) for r in rows]))

    def flush(self):
        self.advance()
        self.jt.regular.flush()
        self.pt.regular.flush()

    def compact(self):
        self.advance()
        return self.jt.compact(), self.pt.compact()

    def same_files(self):
        assert store_files(self.pt.regular) == store_files(self.jt.regular)


@pytest.fixture()
def low_pushdown():
    with both("tpu_min_rows_for_pushdown", 64):
        yield


@pytest.fixture()
def docs_pair(tmp_path, low_pushdown):
    p = Pair(str(tmp_path))
    p.write(0, 4000)
    p.flush()
    p.same_files()
    return p


def _stats(mod):
    return copy.deepcopy(mod.DOC_STATS)


def _delta(before, after):
    reasons = {k: v - before["reasons"].get(k, 0)
               for k, v in after["reasons"].items()
               if v != before["reasons"].get(k, 0)}
    return (after["shredded_scans"] - before["shredded_scans"],
            after["fallbacks"] - before["fallbacks"], reasons)


def _read(t, req_cls, table, shred_off=False, **kw):
    if not shred_off:
        return t.read(req_cls(table, **kw))
    with both("doc_shred_enabled", False):
        return t.read(req_cls(table, **kw))


def _agg_kw(kw, agg_cls):
    if "aggregates" not in kw:
        return kw
    return dict(kw, aggregates=tuple(agg_cls(a.op, a.expr)
                                     for a in kw["aggregates"]))


def _same(presp, jresp, what):
    assert presp.backend == jresp.backend, (what, presp.backend,
                                            jresp.backend)
    if jresp.agg_values is not None:
        assert len(presp.agg_values) == len(jresp.agg_values)
        for i, (a, b) in enumerate(zip(presp.agg_values,
                                       jresp.agg_values)):
            assert_same_value(a, b, f"{what} agg {i}")
    else:
        assert presp.rows == jresp.rows, what


def assert_parity(pair, pushdown=True, **kw):
    """The port's shredded read against the reference's (answer,
    backend, DOC_STATS delta, LAST_DOC_STATS), and against its own
    interpreted read over the same SSTs, as the reference's
    assert_parity holds the reference."""
    jkw, pkw = _agg_kw(kw, JAgg), _agg_kw(kw, AggSpec)
    j0, p0 = _stats(jpush), _stats(ppush)
    jr = _read(pair.jt, JReq, pair.table, **jkw)
    pr = _read(pair.pt, ReadRequest, pair.table, **pkw)
    assert _delta(p0, _stats(ppush)) == _delta(j0, _stats(jpush)), \
        (ppush.DOC_STATS, jpush.DOC_STATS)
    if pushdown:
        assert pr.backend == "tpu", f"fell back: {ppush.DOC_STATS}"
        assert ppush.LAST_DOC_STATS == jpush.LAST_DOC_STATS
    else:
        assert pr.backend == "cpu"
    _same(pr, jr, "shredded")
    pi = _read(pair.pt, ReadRequest, pair.table, shred_off=True, **pkw)
    ji = _read(pair.jt, JReq, pair.table, shred_off=True, **jkw)
    assert pi.backend == ji.backend == "cpu"
    _same(pi, ji, "interpreted")
    if pr.agg_values is not None:
        assert [np.asarray(v).tolist() for v in pr.agg_values] == \
            [np.asarray(v).tolist() for v in pi.agg_values]
    else:
        assert pr.rows == pi.rows
    return pr


# ---------------------------------------------------------------------------
# Write-side inference units
# ---------------------------------------------------------------------------

def _lane(docs):
    texts = [json.dumps(d).encode() if d is not None else b""
             for d in docs]
    ends = np.cumsum([len(x) for x in texts]).astype(np.uint32)
    return ends, b"".join(texts), np.array([d is None for d in docs])


def _same_lanes(got, want):
    assert list(got) == list(want)
    for p in want:
        (gk, gp, gpres, gb), (wk, wp, wpres, wb) = got[p], want[p]
        assert (gk, gb) == (wk, wb) and np.array_equal(gpres, wpres)
        gp = gp if isinstance(gp, tuple) else (gp,)
        wp = wp if isinstance(wp, tuple) else (wp,)
        for a, b in zip(gp, wp):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def shred_both(*args, **kw):
    """shred_lanes in both packages (and DOC_WRITE_STATS alike)."""
    j0 = dict(jshred.DOC_WRITE_STATS)
    p0 = dict(pshred.DOC_WRITE_STATS)
    want = jshred.shred_lanes(*args, **kw)
    got = pshred.shred_lanes(*args, **kw)
    _same_lanes(got, want)
    assert {k: v - p0[k] for k, v in pshred.DOC_WRITE_STATS.items()} == \
        {k: v - j0[k] for k, v in jshred.DOC_WRITE_STATS.items()}
    return got


class TestShredInference:
    def test_kinds_and_presence(self):
        docs = [{"i": 1, "f": 1.5, "s": "x", "b": True},
                {"i": 2, "f": 2.5, "s": "y", "b": False},
                {"f": 3.5, "s": "z", "b": True, "i": None}]
        out = shred_both(*_lane(docs))
        assert [out[(k,)][0] for k in "ifsb"] == ["i", "f", "s", "s"]
        from yugabyte_db_tpu_torch.storage.lane_codec import \
            decode_dict_strings
        ulens, uheap, _codes = out[("b",)][1]
        assert set(decode_dict_strings(ulens, uheap)) == {"true", "false"}
        assert out[("i",)][2].tolist() == [True, True, False]
        assert out[("i",)][3] == (1, 2)

    def test_heterogeneous_and_arrays_refused(self):
        out = shred_both(*_lane([{"m": 1, "a": [1], "fi": 1},
                                 {"m": "one", "a": [2], "fi": 2.0}]))
        assert not {("m",), ("a",), ("fi",)} & set(out)

    def test_ancestor_purity(self):
        out = shred_both(*_lane([{"p": {"x": 1}},
                                 {"p": json.dumps({"x": 2})}]))
        assert ("p", "x") not in out
        out = shred_both(*_lane([{"p": {"x": 1}}, {"p": {"x": 2}},
                                 {"p": None}]))
        assert out[("p", "x")][0] == "i"

    def test_coverage_and_max_paths(self):
        out = shred_both(*_lane([{"common": i} if i else
                                 {"common": i, "rare": 1}
                                 for i in range(100)]))
        assert ("common",) in out and ("rare",) not in out
        docs = [{f"k{j}": j for j in range(8)} for _ in range(10)]
        assert len(shred_both(*_lane(docs), max_paths=3)) == 3
        with both("doc_shred_max_paths", 5):
            assert len(shred_both(*_lane(docs))) == 5

    def test_int64_overflow_refused(self):
        out = shred_both(*_lane([{"big": 2 ** 70}, {"big": 1}]))
        assert ("big",) not in out

    def test_unparseable_docs_are_absent(self):
        texts = [b'{"k": 1}', b"not json", b'{"k": 2}']
        ends = np.cumsum([len(x) for x in texts]).astype(np.uint32)
        out = shred_both(ends, b"".join(texts), None)
        assert out[("k",)][2].tolist() == [True, False, True]

    def test_nonfinite_floats_refused(self):
        texts = [b'{"x": Infinity, "y": 1.5}', b'{"x": NaN, "y": 2.5}']
        ends = np.cumsum([len(t) for t in texts]).astype(np.uint32)
        out = shred_both(ends, b"".join(texts), None)
        assert ("x",) not in out and out[("y",)][0] == "f"

    def test_serialized_entries_match(self):
        """serialize_shred's header entries and buffers, and the
        deserialized lanes, against the reference's (bounds at int64's
        edges, None float bounds and "cdt" strings included)."""
        rng = np.random.default_rng(4)
        docs = [{"e": int(v), "f": float(rng.uniform(-1, 1)),
                 "s": f"v{i}", "c": f"c{i % 3}", "t": bool(i % 2)}
                for i, v in enumerate(
                    [-(2 ** 63), 2 ** 63 - 1] + list(range(400)))]
        args = _lane(docs)
        jbufs, pbufs, jst, pst = [], [], {}, {}
        want = jshred.serialize_shred(*args, jbufs, jst)
        got = pshred.serialize_shred(*args, pbufs, pst)
        assert got == want and pst == jst
        assert [bytes(memoryview(b).cast("B")) for b in pbufs] == \
            [bytes(memoryview(b).cast("B")) for b in jbufs]
        from yugabyte_db_tpu_torch.storage import wire_pack
        import msgpack
        assert wire_pack.packb(got) == msgpack.packb(want)
        assert {e[2].get("cdt") for e in got if e[1] == "s"} == \
            {"uint16", "uint8"}
        raw = b"".join(bytes(memoryview(b).cast("B")) for b in pbufs)
        pos = [0]

        def fetch(n):
            pos[0] += n
            return raw[pos[0] - n:pos[0]]
        back = pshred.deserialize_shred(got, fetch,
                                        ColumnarBlock._decode_dict_varlen)
        assert pos[0] == len(raw)
        assert back[("e",)][3] == (-(2 ** 63), 2 ** 63 - 1)
        assert back[("s",)][0] == "s" and back[("t",)][0] == "s"


# ---------------------------------------------------------------------------
# Golden parity: shredded vs interpreted vs the reference
# ---------------------------------------------------------------------------

class TestGoldenParity:
    @pytest.mark.parametrize("where", [
        ("cmp", "eq", J("tag"), ("const", "beta")),
        ("cmp", "gt", J("tag"), ("const", "alpha")),
        ("in", J("tag"), ["alpha", "gamma"]),
        ("between", J("tag"), ("const", "alpha"), ("const", "beta")),
        ("like", J("tag"), "%amm%")],
        ids=["eq", "gt", "in", "between", "like"])
    def test_string_predicates(self, docs_pair, where):
        assert_parity(docs_pair, where=where,
                      aggregates=(AggSpec("count"),))

    def test_nested_path(self, docs_pair):
        assert_parity(docs_pair,
                      where=("cmp", "eq", J("region", J("meta")),
                             ("const", "eu")),
                      aggregates=(AggSpec("count"),))

    def test_numeric_casts(self, docs_pair):
        r = assert_parity(
            docs_pair,
            where=("cmp", "lt", CASTI(J("qty")), ("const", 10)),
            aggregates=(AggSpec("sum", CASTI(J("qty"))), AggSpec("count"),
                        AggSpec("min", CASTI(J("qty"))),
                        AggSpec("max", CASTI(J("qty")))))
        assert int(np.asarray(r.agg_values[0])) > 0
        assert_parity(
            docs_pair,
            where=("between", CASTF(J("price")), ("const", 100.0),
                   ("const", 900.0)),
            aggregates=(AggSpec("sum", CASTF(J("price"))),
                        AggSpec("count")))

    @pytest.mark.parametrize("where", [
        ("cmp", "eq", J("qty"), ("const", "7")),
        ("cmp", "eq", J("qty"), ("const", str(2 ** 64 + 1))),
        ("cmp", "eq", J("price"), ("const", "inf")),
        ("cmp", "eq", J("qty"), ("const", "07")),
        ("cmp", "ne", J("qty"), ("const", "7.5")),
        ("in", J("qty"), ["7", "9", "x"])],
        ids=["canon", "beyond_int64", "inf", "noncanon", "ne_float",
             "in"])
    def test_text_eq_canonical(self, docs_pair, where):
        assert_parity(docs_pair, where=where,
                      aggregates=(AggSpec("count"),))

    def test_presence_shapes(self, docs_pair):
        assert_parity(docs_pair, where=("isnull", J("qty")),
                      aggregates=(AggSpec("count"),))
        assert_parity(docs_pair, where=("not", ("isnull", J("qty"))),
                      aggregates=(AggSpec("count"),))
        assert_parity(docs_pair, aggregates=(AggSpec("count", J("qty")),
                                             AggSpec("count", J("tag")),
                                             AggSpec("count")))

    def test_string_minmax_decode(self, docs_pair):
        r = assert_parity(docs_pair, aggregates=(AggSpec("min", J("tag")),
                                                 AggSpec("max", J("tag"))))
        assert np.asarray(r.agg_values[0]).item() == "alpha"
        assert np.asarray(r.agg_values[1]).item() == "gamma"

    def test_row_filter_path(self, docs_pair):
        r = assert_parity(docs_pair,
                          where=("cmp", "eq", J("tag"), ("const", "beta")),
                          columns=("id",))
        assert len(r.rows) > 0
        r = assert_parity(docs_pair,
                          where=("cmp", "eq", CASTI(J("qty")),
                                 ("const", 7)))
        assert r.rows and all(json.loads(x["doc"])["qty"] == 7
                              for x in r.rows)

    def test_combined_doc_and_scalar_predicate(self, docs_pair):
        assert_parity(docs_pair,
                      where=("and",
                             ("cmp", "lt", ("col", 0), ("const", 2000)),
                             ("cmp", "eq", J("tag"), ("const", "alpha"))),
                      aggregates=(AggSpec("count"),))

    def test_coverage_counter(self, docs_pair):
        assert_parity(docs_pair,
                      where=("cmp", "eq", J("tag"), ("const", "beta")),
                      aggregates=(AggSpec("count"),))
        assert ppush.LAST_DOC_STATS["coverage"] > 0
        assert ppush.LAST_DOC_STATS["paths"] == 1

    def test_vcid_stability(self, docs_pair):
        v1 = ppush.vcid_for(1, ("tag",))
        assert v1 >= ppush.DOC_COL_BASE == jpush.DOC_COL_BASE == 1 << 24
        assert_parity(docs_pair,
                      where=("cmp", "eq", J("tag"), ("const", "beta")),
                      aggregates=(AggSpec("count"),))
        assert ppush.vcid_for(1, ("tag",)) == v1
        assert ppush.vcid_for(1, ("qty",)) != v1

    def test_attach_never_mutates_cached_blocks(self, docs_pair):
        t = docs_pair.pt
        assert_parity(docs_pair,
                      where=("cmp", "eq", J("tag"), ("const", "beta")),
                      aggregates=(AggSpec("sum", CASTI(J("qty"))),
                                  AggSpec("count")))
        for r in t.regular.ssts:
            for i in range(r.num_blocks()):
                cb = r.columnar_block(i)
                assert all(c < ppush.DOC_COL_BASE for c in cb.fixed)
                assert all(c < ppush.DOC_COL_BASE for c in cb.varlen)
                assert all(c < ppush.DOC_COL_BASE for c in (cb.zmap or {}))
        docs_pair.write(4000, 4500)
        docs_pair.flush()
        docs_pair.compact()
        docs_pair.same_files()
        assert_parity(docs_pair,
                      where=("cmp", "eq", J("tag"), ("const", "beta")),
                      aggregates=(AggSpec("count"),))

    def test_docbench_query(self, docs_pair):
        """models/docbench.py's query and documents in both packages."""
        jw, ja = jdocs.doc_qty_query()
        pw, pa = pdocs.doc_qty_query()
        assert (pw, [(a.op, a.expr) for a in pa]) == \
            (jw, [(a.op, a.expr) for a in ja])
        jd, pd = jdocs.generate_docs(300, 3), pdocs.generate_docs(300, 3)
        assert np.array_equal(jd["id"], pd["id"])
        assert list(jd["doc"]) == list(pd["doc"])
        r = assert_parity(docs_pair, where=pw, aggregates=pa)
        assert int(np.asarray(r.agg_values[1])) > 0


# ---------------------------------------------------------------------------
# Typed fallbacks: every unservable shape answers interpreted
# ---------------------------------------------------------------------------

class TestFallbacks:
    def test_text_ordering_over_numeric_path(self, docs_pair):
        assert_parity(docs_pair, pushdown=False,
                      where=("cmp", "gt", J("qty"), ("const", "10")),
                      aggregates=(AggSpec("count"),))
        assert ppush.DOC_STATS["reasons"].get(REASON_DOC_SHAPE, 0) >= 1

    def test_array_path(self, docs_pair):
        assert_parity(docs_pair, pushdown=False,
                      where=("cmp", "eq", J("arr"), ("const", "[1, 2]")),
                      aggregates=(AggSpec("count"),))

    def test_minmax_over_numeric_path_text(self, docs_pair):
        assert_parity(docs_pair, pushdown=False,
                      aggregates=(AggSpec("min", J("qty")),))

    def test_memtable_rows_fall_back(self, docs_pair):
        docs_pair.write(4000, 4100)          # unflushed: no shred lanes
        before = _stats(ppush)
        assert_parity(docs_pair, pushdown=False,
                      where=("cmp", "eq", J("tag"), ("const", "beta")),
                      aggregates=(AggSpec("count"),))
        assert _delta(before, _stats(ppush))[2].get(
            REASON_UNSHREDDED_BLOCK, 0) >= 1
        docs_pair.flush()
        docs_pair.same_files()
        assert_parity(docs_pair,
                      where=("cmp", "eq", J("tag"), ("const", "beta")),
                      aggregates=(AggSpec("count"),))

    def test_heterogeneous_path_falls_back(self, tmp_path, low_pushdown):
        p = Pair(str(tmp_path), "docs-h")
        p.write(0, 1000, mutate=lambda i, d: d.__setitem__(
            "qty", "many" if i % 5 == 0 else d.get("qty", 0)))
        p.flush()
        p.same_files()
        before = _stats(ppush)
        assert_parity(p, pushdown=False,
                      where=("cmp", "eq", J("qty"), ("const", "3")),
                      aggregates=(AggSpec("count"),))
        assert _delta(before, _stats(ppush))[2].get(
            REASON_UNSHREDDED_BLOCK, 0) >= 1

    def test_mixed_v1_v2_ssts(self, tmp_path, low_pushdown):
        p = Pair(str(tmp_path), "docs-m")
        with both("sst_format_version", 1):
            p.write(0, 1000)
            p.flush()                        # v1 SST: no shredded lanes
        p.write(1000, 2000)
        p.flush()                            # v2 shredded SST
        p.same_files()
        assert sorted(r.format_version for r in p.pt.regular.ssts) == [1, 2]
        before = _stats(ppush)
        assert_parity(p, pushdown=False,
                      where=("cmp", "eq", J("tag"), ("const", "beta")),
                      aggregates=(AggSpec("count"),))
        assert _delta(before, _stats(ppush))[2].get(
            REASON_UNSHREDDED_BLOCK, 0) >= 1

    def test_flag_off_no_pushdown(self, docs_pair):
        with both("doc_shred_enabled", False):
            for t, req, agg in ((docs_pair.pt, ReadRequest, AggSpec),
                                (docs_pair.jt, JReq, JAgg)):
                r = t.read(req("docs", where=("cmp", "eq", J("tag"),
                                              ("const", "beta")),
                               aggregates=(agg("count"),)))
                assert r.backend == "cpu"


# ---------------------------------------------------------------------------
# Format discipline
# ---------------------------------------------------------------------------

class TestFormatGate:
    def _entries(self, t):
        return [(k, v) for k, v in t.regular._mem.iterate()]

    @pytest.mark.parametrize("version", [1, 2])
    @pytest.mark.parametrize("shred", [True, False])
    def test_sst_bytes_match_reference(self, tmp_path, low_pushdown,
                                       version, shred):
        """One writer per package over the same memtable entries, with
        shredding on and off, in v1 and v2: the same file."""
        p = Pair(str(tmp_path), "docs-o")
        p.write(0, 1000)
        entries = self._entries(p.pt)
        assert entries == self._entries(p.jt)
        files = {}
        with both("doc_shred_enabled", shred), \
                both("sst_format_version", version):
            for name, mod, t in (("j", jsst, p.jt), ("p", psst, p.pt)):
                path = str(tmp_path / f"{name}.sst")
                w = mod.SstWriter(path, block_rows=300,
                                  columnar_builder=t.codec.columnar_builder,
                                  key_builder=t.codec.derive_keys,
                                  shred_cols=t.codec.shred_cols)
                assert w.shred_cols == ((1,) if shred and version == 2
                                        else ())
                for k, v in entries:
                    w.add(k, v)
                w.finish()
                files[name] = open(path, "rb").read()
        assert files["p"] == files["j"]
        assert (b"shred" in files["p"]) == (shred and version == 2)
        r = psst.SstReader(str(tmp_path / "p.sst"),
                           row_decoder=p.pt.codec.row_decoder,
                           key_builder=p.pt.codec.derive_keys)
        assert r.format_version == version
        assert bool(r.columnar_block(0).shred) == (shred and version == 2)
        assert list(r.iterate()) == entries

    def test_flag_off_byte_identity_oracle(self, tmp_path, low_pushdown):
        p = Pair(str(tmp_path), "docs-o")
        p.write(0, 1000)
        entries = self._entries(p.pt)
        codec = p.pt.codec

        def write(path, **kw):
            w = psst.SstWriter(str(path),
                               columnar_builder=codec.columnar_builder,
                               key_builder=codec.derive_keys, **kw)
            for k, v in entries:
                w.add(k, v)
            w.finish()
            return open(path, "rb").read()

        with both("doc_shred_enabled", False):
            off_bytes = write(tmp_path / "off.sst",
                              shred_cols=codec.shred_cols)
        oracle_bytes = write(tmp_path / "oracle.sst")
        assert off_bytes == oracle_bytes
        on_bytes = write(tmp_path / "on.sst", shred_cols=codec.shred_cols)
        assert on_bytes != oracle_bytes
        assert b"shred" in on_bytes and b"shred" not in off_bytes

    def test_v1_never_shreds(self, tmp_path, low_pushdown):
        p = Pair(str(tmp_path), "docs-v1")
        for mod, t in ((jsst, p.jt), (psst, p.pt)):
            w = mod.SstWriter(str(tmp_path / "f1.sst"),
                              columnar_builder=t.codec.columnar_builder,
                              format_version=1,
                              key_builder=t.codec.derive_keys,
                              shred_cols=t.codec.shred_cols)
            assert w.shred_cols == () and w.key_builder is None

    def test_old_reader_shape_unaffected(self, docs_pair):
        t = docs_pair.pt
        cb = t.regular.ssts[0].columnar_block(0)
        assert cb.shred
        plain = cb.serialize(2, t.codec.derive_keys)
        jcb = docs_pair.jt.regular.ssts[0].columnar_block(0)
        assert plain == jcb.serialize(2, docs_pair.jt.codec.derive_keys)
        twin = ColumnarBlock.deserialize(plain)
        assert not twin.shred
        for cid in cb.varlen:
            e1, h1, n1 = cb.varlen[cid]
            e2, h2, n2 = twin.varlen[cid]
            assert bytes(h1) == bytes(h2)
            assert np.array_equal(np.asarray(e1), np.asarray(e2))
            assert np.array_equal(np.asarray(n1), np.asarray(n2))
        assert np.array_equal(cb.ht, twin.ht)


# ---------------------------------------------------------------------------
# Compaction re-shreds, on every backend
# ---------------------------------------------------------------------------

class TestCompactionReshred:
    def test_compaction_output_is_shredded(self, tmp_path, low_pushdown):
        p = Pair(str(tmp_path), "docs-c")
        p.write(0, 1500)
        p.flush()
        p.write(1500, 3000)
        p.flush()
        assert len(p.pt.regular.ssts) == 2
        p.compact()
        p.same_files()
        assert len(p.pt.regular.ssts) == 1
        r = p.pt.regular.ssts[0]
        for i in range(r.num_blocks()):
            assert r.columnar_block(i).shred.get(1), f"block {i}"
        assert_parity(p, where=("cmp", "eq", J("tag"), ("const", "gamma")),
                      aggregates=(AggSpec("sum", CASTI(J("qty"))),
                                  AggSpec("count")))

    @pytest.mark.parametrize("backend", ["device", "native", "baseline"])
    def test_backend_writes_the_reference_sst(self, tmp_path, low_pushdown,
                                              backend):
        """tpu_compact on each backend (the port's device backend on the
        CPU) over overwritten documents: the reference's compacted file
        with shredded lanes in every block."""
        p = Pair(str(tmp_path), "docs-c")
        p.write(0, 1500)
        p.flush()
        p.write(700, 2200, mutate=lambda i, d: d.__setitem__("qty", i))
        p.flush()
        p.advance(1000)
        cutoff = p.pt.history_cutoff()
        assert cutoff == p.jt.history_cutoff()
        jpath = jcomp.tpu_compact(p.jt.regular, p.jt.codec, cutoff,
                                  backend=backend, block_rows=512)
        ppath = pcomp.tpu_compact(p.pt.regular, p.pt.codec, cutoff,
                                  backend=backend, block_rows=512,
                                  device="cpu")
        assert open(ppath, "rb").read() == open(jpath, "rb").read()
        assert pcomp.LAST_COMPACTION_STATS.get("backend") == \
            jcomp.LAST_COMPACTION_STATS.get("backend")
        r = p.pt.regular.ssts[0]
        assert r.num_blocks() > 1
        for i in range(r.num_blocks()):
            assert set(r.columnar_block(i).shred[1]) >= {("qty",), ("tag",)}


# ---------------------------------------------------------------------------
# Zone pruning over shredded lanes
# ---------------------------------------------------------------------------

class TestZonePrune:
    def test_shredded_lane_prunes_blocks(self, tmp_path, low_pushdown):
        p = Pair(str(tmp_path), "docs-z")
        p.write(0, 8192, mutate=lambda i, d: d.__setitem__("qty", i // 500))
        p.flush()
        p.same_files()
        from yugabyte_db_tpu.ops.stream_scan import LAST_STREAM_STATS as js
        from yugabyte_db_tpu_torch.ops.stream_scan import \
            LAST_STREAM_STATS as ps
        with both("streaming_chunk_rows", 4096):
            r = assert_parity(
                p, where=("cmp", "eq", CASTI(J("qty")), ("const", 3)),
                aggregates=(AggSpec("count"),))
            assert r.backend == "tpu"
            # the interpreted read in assert_parity ran last: read again
            for t, req, agg in ((p.pt, ReadRequest, AggSpec),
                                (p.jt, JReq, JAgg)):
                t.read(req("docs", where=("cmp", "eq", CASTI(J("qty")),
                                          ("const", 3)),
                           aggregates=(agg("count"),)))
        assert ps.get("zone_blocks_pruned", 0) > 0
        assert ps.get("zone_blocks_pruned") == js.get("zone_blocks_pruned")


# ---------------------------------------------------------------------------
# Bypass route
# ---------------------------------------------------------------------------

class TestBypassDoc:
    def _pair(self, tmp_path):
        p = Pair(str(tmp_path), "docs-b")
        p.write(0, 6000)
        p.flush()
        return p

    def test_keyless_doc_scan_parity(self, tmp_path, low_pushdown):
        from yugabyte_db_tpu.bypass.session import BypassSession as JS
        from yugabyte_db_tpu_torch.bypass.session import BypassSession
        p = self._pair(tmp_path)
        where = ("cmp", "eq", J("tag"), ("const", "alpha"))
        aggs = (AggSpec("sum", CASTI(J("qty"))), AggSpec("count"),
                AggSpec("max", J("tag")))
        jaggs = tuple(JAgg(a.op, a.expr) for a in aggs)
        with BypassSession([p.pt], device="cpu") as s, JS([p.jt]) as js:
            assert s.read_ht == js.read_ht
            outs, counts, stats = s.scan_aggregate(where, aggs)
            jouts, jcounts, jstats = js.scan_aggregate(where, jaggs)
            assert stats["key_rebuilds"] == jstats["key_rebuilds"] == 0
            rpc = p.pt.read(ReadRequest("docs", where=where, aggregates=aggs,
                                        read_ht=s.read_ht))
        for a, b in zip(outs, jouts):
            assert_same_value(a, b, "bypass")
        assert_same_value(counts, jcounts, "counts")
        assert [np.asarray(v).tolist() for v in outs] == \
            [np.asarray(v).tolist() for v in rpc.agg_values]

    @pytest.mark.parametrize("case", ["flag_off", "doc_shape"])
    def test_typed_reasons(self, tmp_path, low_pushdown, case):
        from yugabyte_db_tpu.bypass.errors import \
            BypassIneligible as JIneligible
        from yugabyte_db_tpu.bypass.session import BypassSession as JS
        from yugabyte_db_tpu_torch.bypass.errors import (REASON_DOC_OFF,
                                                         REASON_DOC_SHAPE,
                                                         BypassIneligible)
        from yugabyte_db_tpu_torch.bypass.session import BypassSession
        p = self._pair(tmp_path)
        where = (("cmp", "eq", J("tag"), ("const", "alpha"))
                 if case == "flag_off"
                 else ("cmp", "gt", J("qty"), ("const", "10")))
        with both("doc_shred_enabled", case != "flag_off"):
            with BypassSession([p.pt], device="cpu") as s, JS([p.jt]) as js:
                with pytest.raises(BypassIneligible) as e:
                    s.scan_aggregate(where, (AggSpec("count"),))
                with pytest.raises(JIneligible) as je:
                    js.scan_aggregate(where, (JAgg("count"),))
        assert e.value.reason == (REASON_DOC_OFF if case == "flag_off"
                                  else REASON_DOC_SHAPE)
        assert (e.value.reason, e.value.detail) == \
            (je.value.reason, je.value.detail)


# ---------------------------------------------------------------------------
# Aggregates over string payloads (plain string columns)
# ---------------------------------------------------------------------------

class TestDictMinMaxSatellite:
    @pytest.fixture()
    def str_pair(self, tmp_path, low_pushdown):
        from yugabyte_db_tpu.models import tpch as jtpch
        from yugabyte_db_tpu_torch.models import tpch as ptpch
        base = {k: v[:40_000]
                for k, v in jtpch.generate_lineitem(0.01).items()}
        p = Pair(str(tmp_path), "ls", (jtpch.lineitem_str_info(),
                                       ptpch.lineitem_str_info()))
        p.jt.bulk_load(jtpch.lineitem_str_data(base), block_rows=8192)
        p.pt.bulk_load(ptpch.lineitem_str_data(base), block_rows=8192)
        p.same_files()
        return p

    def _both(self, p, kw, **flag_off):
        out = []
        for t, req, agg in ((p.pt, ReadRequest, AggSpec),
                            (p.jt, JReq, JAgg)):
            with flags_set(flag_off, flag_off):
                out.append(t.read(req("lineitem_s",
                                      **_agg_kw(kw, agg))))
        return out

    def _check(self, p, kw, off_flag="tpu_pushdown_enabled"):
        pr, jr = self._both(p, kw)
        assert pr.backend == jr.backend == "tpu"
        _same(pr, jr, "device")
        pi, ji = self._both(p, kw, **{off_flag: False})
        _same(pi, ji, "interpreted")
        return pr, pi

    def test_scalar_minmax_decodes(self, str_pair):
        pr, pi = self._check(str_pair, dict(aggregates=(
            AggSpec("min", ("col", 6)), AggSpec("max", ("col", 6)),
            AggSpec("count", ("col", 6)))))
        assert [np.asarray(v).tolist() for v in pr.agg_values] == \
            [np.asarray(v).tolist() for v in pi.agg_values]
        assert np.asarray(pr.agg_values[0]).item() == "A"

    def test_minmax_with_predicate_streams(self, str_pair):
        from yugabyte_db_tpu_torch.ops.stream_scan import LAST_STREAM_STATS
        with both("streaming_chunk_rows", 8192):
            kw = dict(where=("cmp", "gt", ("col", 1), ("const", 25.0)),
                      aggregates=(AggSpec("max", ("col", 6)),
                                  AggSpec("min", ("col", 7)),
                                  AggSpec("count")))
            pr, jr = self._both(str_pair, kw)
            assert pr.backend == jr.backend == "tpu"
            assert LAST_STREAM_STATS.get("chunks", 0) >= 3
            _same(pr, jr, "streamed")
            pi, _ = self._both(str_pair, kw, tpu_pushdown_enabled=False)
        assert [np.asarray(v).tolist() for v in pr.agg_values] == \
            [np.asarray(v).tolist() for v in pi.agg_values]

    def test_grouped_minmax_payload(self, str_pair):
        from yugabyte_db_tpu.ops.grouped_scan import DictGroupSpec as JG
        from yugabyte_db_tpu_torch.ops.grouped_scan import DictGroupSpec
        out = {}
        for t, req, agg, grp in ((str_pair.pt, ReadRequest, AggSpec,
                                  DictGroupSpec),
                                 (str_pair.jt, JReq, JAgg, JG)):
            kw = dict(aggregates=(agg("max", ("col", 6)),
                                  agg("sum", ("col", 1))),
                      group_by=grp((7,)))
            r = t.read(req("lineitem_s", **kw))
            assert r.backend == "tpu"
            with both("grouped_pushdown_enabled", False):
                ref = t.read(req("lineitem_s", **kw))
            out[t is str_pair.pt] = (r, ref)
        (pr, pref), (jr, jref) = out[True], out[False]
        _same(pr, jr, "grouped")
        for i, (a, b) in enumerate(zip(pr.group_values, jr.group_values)):
            assert_same_value(a, b, f"group values {i}")
        assert_same_value(pr.group_counts, jr.group_counts, "counts")

        def by_key(resp):
            res = {}
            counts = np.asarray(resp.group_counts)
            for g in range(len(counts)):
                key = tuple(str(np.asarray(v)[g])
                            for v in resp.group_values)
                res[key] = (int(counts[g]),) + tuple(
                    np.asarray(v)[g] for v in resp.agg_values)
            return res

        assert by_key(pr).keys() == by_key(pref).keys()
        for k, (c1, mx1, s1) in by_key(pr).items():
            c2, mx2, s2 = by_key(pref)[k]
            assert (c1, str(mx1)) == (c2, str(mx2))
            assert float(s1) == pytest.approx(float(s2))

    def test_min_empty_input_is_null(self, str_pair):
        pr, jr = self._both(str_pair, dict(
            where=("cmp", "lt", ("col", 1), ("const", -1.0)),
            aggregates=(AggSpec("min", ("col", 6)), AggSpec("count"))))
        assert pr.backend == jr.backend == "tpu"
        _same(pr, jr, "empty")
        assert np.asarray(pr.agg_values[0]).item() is None
        assert int(np.asarray(pr.agg_values[1])) == 0

    def test_sum_over_string_still_refused(self, str_pair):
        got = []
        for t, req, agg in ((str_pair.pt, ReadRequest, AggSpec),
                            (str_pair.jt, JReq, JAgg)):
            try:
                got.append(t.read(req("lineitem_s", aggregates=(
                    agg("sum", ("col", 6)),))).backend)
            except TypeError:
                got.append(TypeError)
        assert got[0] == got[1] and got[0] in ("cpu", TypeError)


# ---------------------------------------------------------------------------
# Point reads over shredded SSTs (the native hot path)
# ---------------------------------------------------------------------------

def _hash_doc_infos():
    """(reference, port) TableInfo of (k int64 hash key, doc JSON): the
    shape the fused range read serves."""
    from yugabyte_db_tpu.docdb.table_codec import TableInfo as JInfo
    from yugabyte_db_tpu.dockv import packed_row as jpr
    from yugabyte_db_tpu.dockv.partition import PartitionSchema as JPS
    from yugabyte_db_tpu_torch.docdb.table_codec import TableInfo
    from yugabyte_db_tpu_torch.dockv import packed_row as ppr
    from yugabyte_db_tpu_torch.dockv.partition import PartitionSchema

    def cols(pr):
        C, T = pr.ColumnSchema, pr.ColumnType
        return pr.TableSchema((C(0, "k", T.INT64, is_hash_key=True),
                               C(1, "doc", T.JSON)), 1)
    return (JInfo("hd", "hd", cols(jpr), JPS("hash", 1)),
            TableInfo("hd", "hd", cols(ppr), PartitionSchema("hash", 1)))


def test_point_reads_over_shredded_ssts(tmp_path):
    """get_row, multi_get and the fused range read over shredded SSTs
    (two flushes, the second overwriting) return the reference's rows,
    each JSON payload byte for byte the written one: shredded lanes sit
    in ``blk.shred`` and at the end of the payload, past every lane the
    native reader walks."""
    from yugabyte_db_tpu_torch.docdb.hotpath import (POINT_READ_STATS,
                                                     reset_stats)
    p = Pair(str(tmp_path), "hd", _hash_doc_infos())
    p.write(0, 600, key="k")
    p.flush()
    p.write(300, 900, key="k", mutate=lambda i, d: d.update(qty=-i))
    p.flush()
    p.same_files()
    assert all(r.columnar_block(0).shred for r in p.pt.regular.ssts)
    p.advance()
    read_ht = (p.pphys.now_micros() << 12) + 1
    written = {i: json.dumps(make_doc(i) if i < 300 else
                             dict(make_doc(i), qty=-i)) for i in range(900)}
    keys = [{"k": k} for k in range(-3, 905, 7)]
    reset_stats()
    got = p.pt._read_op.multi_get(keys, read_ht)
    assert got == p.jt._read_op.multi_get(keys, read_ht)
    assert POINT_READ_STATS["readers_built"] == 2
    for row in got:
        if row is not None:
            assert row["doc"] == written[row["k"]]
    for k in (0, 299, 300, 899, 901):
        pr = p.pt._read_op.get_row({"k": k}, read_ht)
        assert pr == p.jt._read_op.get_row({"k": k}, read_ht)
        assert (pr is None) == (k not in written)
        if pr is not None:
            assert pr["doc"] == written[k]
    reset_stats()
    for lo, hi in ((280, 330), (0, 40), (880, 910)):
        req = dict(where=("between", ("col", 0), ("const", lo),
                          ("const", hi)), read_ht=read_ht)
        rows = p.pt.read(ReadRequest("hd", **req)).rows
        assert rows == p.jt.read(JReq("hd", **req)).rows
        assert sorted(r["k"] for r in rows) == \
            [k for k in range(lo, hi + 1) if k in written]
        assert all(r["doc"] == written[r["k"]] for r in rows)
    assert POINT_READ_STATS["range_read_calls"] == 3


def _alter_infos(version):
    """(reference, port) TableInfo of an id-keyed table that gains the
    JSON column `doc` (id 1) at version 2."""
    from yugabyte_db_tpu.docdb.table_codec import TableInfo as JInfo
    from yugabyte_db_tpu.dockv import packed_row as jpr
    from yugabyte_db_tpu.dockv.partition import PartitionSchema as JPS
    from yugabyte_db_tpu_torch.docdb.table_codec import TableInfo
    from yugabyte_db_tpu_torch.dockv import packed_row as ppr
    from yugabyte_db_tpu_torch.dockv.partition import PartitionSchema

    def schema(pr):
        C, T = pr.ColumnSchema, pr.ColumnType
        cols = (C(0, "id", T.INT64, is_range_key=True),
                C(2, "n", T.INT64))
        if version >= 2:
            cols += (C(1, "doc", T.JSON),)
        return pr.TableSchema(cols, version)
    return (JInfo("docs", "docs", schema(jpr), JPS("range", 0)),
            TableInfo("docs", "docs", schema(ppr),
                      PartitionSchema("range", 0)))


def test_alter_add_json_column_shreds_at_next_flush(tmp_path, low_pushdown):
    """ALTER TABLE ADD COLUMN doc JSON: the next flush shreds the new
    column, as the reference's does, and the doc path pushes down once
    every block has the lanes (the compaction repacks the old rows)."""
    p = Pair(str(tmp_path), "docs-a", _alter_infos(1))
    p.advance()
    rows = [{"id": i, "n": i} for i in range(600)]
    p.jt.apply_write(JW("docs", [JOp("upsert", dict(r)) for r in rows]))
    p.pt.apply_write(WriteRequest("docs", [RowOp("upsert", dict(r))
                                           for r in rows]))
    p.flush()
    assert p.pt.codec.shred_cols == ()
    jinfo, pinfo = _alter_infos(2)
    p.jt.alter_table(jinfo)
    p.pt.alter_table(pinfo)
    assert p.pt.regular.shred_cols == p.jt.regular.shred_cols == (1,)
    p.write(600, 1800)
    p.flush()
    p.same_files()
    newest = max(p.pt.regular.ssts, key=lambda r: r.path)
    assert newest.columnar_block(0).shred[1]
    before = _stats(ppush)
    assert_parity(p, pushdown=False,
                  where=("cmp", "eq", J("tag"), ("const", "beta")),
                  aggregates=(AggSpec("count"),))
    assert _delta(before, _stats(ppush))[2] == {REASON_UNSHREDDED_BLOCK: 1}
    p.compact()
    p.same_files()
    assert_parity(p, where=("cmp", "eq", J("tag"), ("const", "beta")),
                  aggregates=(AggSpec("count"), AggSpec("max", J("tag"))))
