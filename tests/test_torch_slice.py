"""The ported slice end to end on a small lineitem table (3 * 4096 + 777
rows): generate -> TableCodec.bulk_blocks -> build_batch -> ScanKernel.run
in both packages, on both routes — plus the port's independence from
JAX (an AST scan of every module) and its device rule."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from yugabyte_db_tpu.models import tpch as jtpch
from yugabyte_db_tpu.ops.device_batch import build_batch as jbuild
from yugabyte_db_tpu.ops.scan import ScanKernel as JKernel
from yugabyte_db_tpu_torch.models import tpch
from yugabyte_db_tpu_torch.ops.device_batch import (bucket_rows,
                                                    build_batch)
from yugabyte_db_tpu_torch.ops.scan import ScanKernel
from tests.torch_parity import (SMALL_ROWS, assert_bitwise,
                                assert_partials, flags_set, float_dtype,
                                jax_blocks, lineitem_data, port_blocks,
                                port_blocks_from)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "yugabyte_db_tpu_torch"


@pytest.fixture(scope="module")
def table():
    data = lineitem_data()
    return data, jax_blocks(data), port_blocks(data)


def test_key_type_bytes_match_reference():
    from yugabyte_db_tpu.dockv.key_encoding import ValueType as J
    from yugabyte_db_tpu_torch.dockv.key_encoding import ValueType as P
    names = [k for k in vars(P) if k.startswith("k")]
    assert names and all(getattr(P, k) == getattr(J, k) for k in names)


def test_generator_matches_reference():
    a = tpch.generate_lineitem(0.001, seed=4)
    b = jtpch.generate_lineitem(0.001, seed=4)
    assert a.keys() == b.keys()
    for k in a:
        assert_bitwise(a[k], b[k], k)


@pytest.mark.parametrize("block_rows", [4096, 5000])
def test_bulk_blocks_match_reference_lane_for_lane(block_rows):
    data = lineitem_data()
    jb = jax_blocks(data, block_rows=block_rows)
    pb = port_blocks(data, block_rows=block_rows)
    assert [b.n for b in jb] == [b.n for b in pb]
    for j, p in zip(jb, pb):
        for lane in ("key_hash", "ht", "write_id", "tombstone", "keys"):
            assert_bitwise(getattr(p, lane), getattr(j, lane), lane)
        assert p.unique_keys == j.unique_keys
        assert p.pk.keys() == j.pk.keys()
        for c in j.pk:
            assert_bitwise(p.pk[c], j.pk[c], f"pk {c}")
        assert p.fixed.keys() == j.fixed.keys()
        for c in j.fixed:
            assert_bitwise(p.fixed[c][0], j.fixed[c][0], f"fixed {c}")
            assert_bitwise(p.fixed[c][1], j.fixed[c][1], f"null {c}")


def test_single_hash_tablet_partition_keeps_every_row(table):
    from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    data, _, pb = table
    (part,) = tpch.lineitem_info().partition_schema.create_partitions(1)
    got = TableCodec(tpch.lineitem_info()).bulk_blocks(
        data, HybridTime(1000), block_rows=4096, partition=part)
    assert sum(b.n for b in got) == SMALL_ROWS
    halves = tpch.lineitem_info().partition_schema.create_partitions(2)
    n = sum(b.n for p in halves for b in TableCodec(
        tpch.lineitem_info()).bulk_blocks(data, HybridTime(1000),
                                          block_rows=4096, partition=p))
    assert n == SMALL_ROWS


@pytest.mark.parametrize("source", ["native", "reference_arrays"])
@pytest.mark.parametrize("mode", ["float32", "float64"])
@pytest.mark.parametrize("query", ["q6", "q1"])
def test_slice_exact_route_matches_reference(table, query, mode, source):
    data, jb, pb = table
    pb = pb if source == "native" else port_blocks_from(jb)
    jq = {"q6": jtpch.TPCH_Q6, "q1": jtpch.TPCH_Q1}[query]
    pq = {"q6": tpch.TPCH_Q6, "q1": tpch.TPCH_Q1}[query]
    with float_dtype(mode):
        jbat = jbuild(jb, jq.columns)
        pbat = build_batch(pb, pq.columns, device="cpu")
    assert pbat.padded_rows == jbat.padded_rows == bucket_rows(SMALL_ROWS)
    assert pbat.col_bounds == jbat.col_bounds
    jo, jc, jm = JKernel().run(jbat, jq.where, jq.aggs, jq.group)
    po, pc, pm = ScanKernel(device="cpu").run(pbat, pq.where, pq.aggs,
                                              pq.group)
    for i, (a, b) in enumerate(zip(po, jo)):
        assert_bitwise(a, b, f"agg {i}")
    assert_bitwise(pc, jc, "counts")
    assert_bitwise(pm, jm, "mask")
    _check_against_numpy(query, po, pc, data, exact=True)


@pytest.mark.parametrize("query", ["q6", "q1"])
def test_slice_hand_route_matches_reference(table, query):
    data, jb, pb = table
    jq = {"q6": jtpch.TPCH_Q6, "q1": jtpch.TPCH_Q1}[query]
    pq = {"q6": tpch.TPCH_Q6, "q1": tpch.TPCH_Q1}[query]
    with float_dtype("float32"):
        jbat = jbuild(jb, jq.columns)
        pbat = build_batch(pb, pq.columns, device="cpu")
    k = ScanKernel(device="cpu")
    with flags_set({"tpu_pallas_scan": True}, {"hand_scan_enabled": True}):
        jo, jc, jm = JKernel().run(jbat, jq.where, jq.aggs, jq.group)
        po, pc, pm = k.run(pbat, pq.where, pq.aggs, pq.group)
    assert jm is None and pm is None, "hand/pallas route not taken"
    assert k.hand_scan_refusals == {}
    assert_bitwise(pc, jc, "counts")
    for a, b, spec in zip(po, jo, pq.aggs):
        assert_partials(a, b, spec.op, spec.op)
    _check_against_numpy(query, po, pc, data, exact=False)


def _check_against_numpy(query, outs, counts, data, exact):
    q = {"q6": tpch.TPCH_Q6, "q1": tpch.TPCH_Q1}[query]
    ref = tpch.numpy_reference(q, data)
    if query == "q6":
        np.testing.assert_allclose(float(np.asarray(outs[0])), ref,
                                   rtol=1e-5)
        return
    counts = np.asarray(counts)
    for g in range(6):
        qty, price, cnt = ref[g]
        assert int(counts[g]) == cnt == int(np.asarray(outs[4])[g])
        # integer quantities sum exactly on both routes (f32 block
        # partials of <= 4096 values <= 50 are exact)
        assert float(np.asarray(outs[0])[g]) == qty
        np.testing.assert_allclose(np.asarray(outs[1])[g], price,
                                   rtol=1e-5 if not exact else 1e-6)


def test_q6_and_grouped_wrappers_on_the_slice(table):
    from yugabyte_db_tpu_torch.ops import hand_scan as hs
    data, _, _ = table
    rev, cnt = hs.q6_scan(data["l_quantity"], data["l_extendedprice"],
                          data["l_discount"], data["l_shipdate"],
                          tpch._D1994, tpch._D1995, 0.05, 0.07, 24.0,
                          device="cpu")
    np.testing.assert_allclose(rev, tpch.numpy_reference(tpch.TPCH_Q6,
                                                         data), rtol=1e-5)
    sums = hs.grouped_sum(data["l_returnflag"] + 3 * data["l_linestatus"],
                          data["l_quantity"],
                          data["l_shipdate"] <= tpch._Q1_CUT, 6,
                          device="cpu")
    ref = tpch.numpy_reference(tpch.TPCH_Q1, data)
    assert [float(s) for s in sums] == [ref[g][0] for g in range(6)]


def test_numpy_reference_matches_reference_package(table):
    data, _, _ = table
    assert tpch.numpy_reference(tpch.TPCH_Q6, data) == \
        jtpch.numpy_reference(jtpch.TPCH_Q6, data)
    assert tpch.numpy_reference(tpch.TPCH_Q1, data) == \
        jtpch.numpy_reference(jtpch.TPCH_Q1, data)
    assert tpch.TPCH_Q6.where == jtpch.TPCH_Q6.where
    assert tpch.TPCH_Q1.group.cols == jtpch.TPCH_Q1.group.cols
    assert [(a.op, a.expr) for a in tpch.TPCH_Q1.aggs] == \
        [(a.op, a.expr) for a in jtpch.TPCH_Q1.aggs]


# --- independence from JAX ---------------------------------------------------
def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
            elif node.level:
                # a relative import must stay inside the port
                base = path.parent
                for _ in range(node.level - 1):
                    base = base.parent
                assert PORT in (base / "x").parents or base == PORT, path


def test_import_check_covers_the_tablet_seam():
    names = {str(p.relative_to(PORT)) for p in _port_sources()
             if PORT in p.parents}
    assert {"tablet/tablet.py", "tablet/__init__.py", "bypass/__init__.py",
            "bypass/errors.py", "bypass/pinner.py", "bypass/prefilter.py",
            "bypass/scan.py", "bypass/session.py",
            "docdb/operations.py"} <= names


def test_import_check_covers_the_join_slice():
    names = {str(p.relative_to(PORT)) for p in _port_sources()
             if PORT in p.parents}
    assert {"ops/cpu_scan.py", "ops/join_scan.py",
            "ops/plan_fusion.py"} <= names
    assert (PORT / "csrc" / "join_probe.cu").is_file()


def test_import_check_covers_rows_windows_and_vectors():
    names = {str(p.relative_to(PORT)) for p in _port_sources()
             if PORT in p.parents}
    assert {"ops/window_scan.py", "ops/vector.py", "vector/__init__.py",
            "vector/registry.py", "vector/ivf.py",
            "vector/hnsw.py"} <= names


def test_import_check_covers_the_mesh():
    names = {str(p.relative_to(PORT)) for p in _port_sources()
             if PORT in p.parents}
    assert {"parallel/__init__.py", "parallel/mesh.py",
            "parallel/distributed_scan.py", "parallel/vector.py"} <= names


def test_import_check_covers_the_row_half():
    names = {str(p.relative_to(PORT)) for p in _port_sources()
             if PORT in p.parents}
    assert {"docdb/hotpath.py", "docdb/table_codec.py",
            "docdb/operations.py", "docdb/compaction.py",
            "dockv/packed_row.py", "storage/columnar.py", "storage/sst.py",
            "storage/lsm.py", "tablet/tablet.py", "utils/flags.py",
            "models/ycsb.py"} <= names
    assert (PORT / "csrc" / "host_hot.c").is_file()


def test_import_check_covers_the_document_store():
    names = {str(p.relative_to(PORT)) for p in _port_sources()
             if PORT in p.parents}
    assert {"docstore/__init__.py", "docstore/errors.py",
            "docstore/shred.py", "docstore/pushdown.py",
            "utils/encryption.py", "models/docbench.py"} <= names


def test_documents_and_encryption_run_without_jax_and_msgpack(tmp_path):
    """A shredded document tablet in encrypted SSTs (a bulk load and the
    bypass against the tablet read, then a flush of upserts and a
    compaction), the doc-path query on the device route (the CPU)
    against the interpreted one, in an interpreter where jax, msgpack
    and the `cryptography` package cannot be imported: the files are
    then BLAKE2b, the cipher where no AES provider imports."""
    code = (_BLOCKED +
            "sys.modules['cryptography'] = None\n"
            "import json\n"
            "import numpy as np\n"
            "from yugabyte_db_tpu_torch.bypass import BypassSession\n"
            "from yugabyte_db_tpu_torch.docdb.operations import (\n"
            "    ReadRequest, RowOp, WriteRequest)\n"
            "from yugabyte_db_tpu_torch.docstore import (DOC_WRITE_STATS,\n"
            "    LAST_DOC_STATS)\n"
            "from yugabyte_db_tpu_torch.models import docbench as db\n"
            "from yugabyte_db_tpu_torch.tablet import Tablet\n"
            "from yugabyte_db_tpu_torch.utils import encryption as enc\n"
            "from yugabyte_db_tpu_torch.utils import flags\n"
            "flags.set_flag('tpu_min_rows_for_pushdown', 64)\n"
            "flags.set_flag('encrypt_data_at_rest', True)\n"
            "enc.KEY_MANAGER.generate_key()\n"
            f"t = Tablet('d', db.docs_info(), {str(tmp_path)!r},"
            " device='cpu')\n"
            "t.bulk_load(db.generate_docs(3000, 1), block_rows=1024)\n"
            "w, a = db.doc_qty_query()\n"
            "r = t.read(ReadRequest('docs', where=w, aggregates=a))\n"
            "with BypassSession([t], device='cpu') as s:\n"
            "    outs, _, _ = s.scan_aggregate(w, a)\n"
            "assert [np.asarray(v).tolist() for v in outs] == \\\n"
            "    [np.asarray(v).tolist() for v in r.agg_values]\n"
            "t.apply_write(WriteRequest('docs', [RowOp('upsert', {'id': i,\n"
            "    'doc': json.dumps({'qty': 7, 'tag': 'beta'})})\n"
            "    for i in range(0, 3000, 10)]))\n"
            "t.flush()\n"
            "t.compact()\n"
            "heads = {open(r.path, 'rb').read(9) for r in t.regular.ssts}\n"
            "assert heads == {enc.MAGIC_V2 + bytes([enc.CIPHER_BLAKE2B])}\n"
            "r = t.read(ReadRequest('docs', where=w, aggregates=a))\n"
            "assert r.backend == 'tpu' and LAST_DOC_STATS['coverage'] > 0\n"
            "flags.set_flag('doc_shred_enabled', False)\n"
            "i = t.read(ReadRequest('docs', where=w, aggregates=a))\n"
            "flags.set_flag('doc_shred_enabled', True)\n"
            "got = [np.asarray(v).tolist() for v in r.agg_values]\n"
            "assert i.backend == 'cpu'\n"
            "assert got == [np.asarray(v).tolist() for v in i.agg_values]\n"
            "assert DOC_WRITE_STATS['blocks_shredded'] >= 3\n"
            "print(got[1])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 300


def test_hot_path_loader_reads_only_the_port_csrc():
    """The extension builds from the port's csrc/host_hot.c into build/;
    the loader names no file of the reference's native/ directory."""
    from yugabyte_db_tpu_torch.docdb import hotpath
    assert hotpath._SRC == PORT / "csrc" / "host_hot.c"
    assert hotpath.library_path().parent == REPO / "build" / "host_hot"
    src = (PORT / "docdb" / "hotpath.py").read_text()
    assert "ybtpu_hot" not in src and '"native"' not in src
    assert "PyInit_host_hot" in (PORT / "csrc" / "host_hot.c").read_text()


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        # msgpack: the card's machine lacks it (storage/wire_pack.py is
        # the port's own codec); native/: the reference's host library
        assert top not in ("jax", "jaxlib", "yugabyte_db_tpu", "msgpack",
                           "native"), \
            f"{path.relative_to(REPO)} imports {mod}"


_BLOCKED = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'yugabyte_db_tpu', 'msgpack'):\n"
            "    sys.modules[m] = None\n")


def test_port_package_imports_without_jax():
    # a fresh interpreter where importing jax (or msgpack) fails outright
    code = (_BLOCKED +
            "import importlib, pkgutil, yugabyte_db_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "from yugabyte_db_tpu_torch.docdb.compaction import tpu_compact\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_compaction_runs_without_jax_and_msgpack(tmp_path):
    """Bulk ingest, SST files and a device-backend compaction (on the
    CPU) in an interpreter where jax and msgpack cannot be imported."""
    code = (_BLOCKED +
            "import numpy as np\n"
            "from yugabyte_db_tpu_torch.docdb.compaction import tpu_compact\n"
            "from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec\n"
            "from yugabyte_db_tpu_torch.models import tpch\n"
            "from yugabyte_db_tpu_torch.storage.lsm import LsmStore\n"
            "from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime\n"
            "data = tpch.generate_lineitem(0.0005, seed=1)\n"
            "codec = TableCodec(tpch.lineitem_info())\n"
            f"store = LsmStore({str(tmp_path)!r},"
            " key_builder=codec.derive_keys)\n"
            "for i in range(3):\n"
            "    codec.bulk_ingest(store, data, HybridTime(1000 + i))\n"
            "tpu_compact(store, codec, 1001, device='cpu')\n"
            "(out,) = store.ssts\n"
            "print(out.num_entries)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # cutoff at the second load: the newest version <= the cutoff and
    # the one above it survive, the oldest goes
    assert int(out.stdout.strip()) == 2 * 3000


def test_row_half_runs_without_jax_and_msgpack(tmp_path):
    """A CPU usertable tablet through the host extension (point reads,
    the fused range read), ALTER + the repacking compaction, a snapshot
    restored, and TRUNCATE, in an interpreter where jax and msgpack
    cannot be imported."""
    code = (_BLOCKED +
            "from yugabyte_db_tpu_torch.docdb.hotpath import "
            "POINT_READ_STATS as S\n"
            "from yugabyte_db_tpu_torch.docdb.operations import (\n"
            "    ReadRequest, RowOp, WriteRequest)\n"
            "from yugabyte_db_tpu_torch.dockv import packed_row as pr\n"
            "from yugabyte_db_tpu_torch.models import ycsb\n"
            "from yugabyte_db_tpu_torch.tablet import Tablet\n"
            f"root = {str(tmp_path)!r}\n"
            "info = ycsb.usertable_info()\n"
            "t = Tablet('u', info, root + '/t', device='cpu')\n"
            "t.bulk_load(ycsb.generate_rows(2000))\n"
            "rows = t.multi_read('usertable', [{'ycsb_key': k}\n"
            "                                  for k in range(10)])\n"
            "assert all(r is not None for r in rows)\n"
            "got = t.read(ReadRequest('usertable', columns=('ycsb_key',),\n"
            "    where=('between', ('col', 0), ('const', 5),\n"
            "           ('const', 15)))).rows\n"
            "assert len(got) == 11 and S['range_read_calls'] == 1\n"
            "cols = info.schema.columns + (pr.ColumnSchema(\n"
            "    99, 'extra', pr.ColumnType.INT64),)\n"
            "new = type(info)(info.table_id, info.name,\n"
            "    pr.TableSchema(cols, 2), info.partition_schema)\n"
            "t.alter_table(new)\n"
            "t.apply_write(WriteRequest('usertable', [RowOp('upsert',\n"
            "    {'ycsb_key': 1, 'extra': 5})]))\n"
            "t.compact()\n"
            "t.create_snapshot(root + '/s')\n"
            "r = Tablet.restore_snapshot('r', new, root + '/s',\n"
            "    root + '/r', device='cpu')\n"
            "one = r.multi_read('usertable', [{'ycsb_key': 1}])[0]\n"
            "assert one['extra'] == 5 and one['field0'] is None\n"
            "assert r.truncate_table('usertable') == 1\n"
            "assert r.multi_read('usertable', [{'ycsb_key': 2}]) == [None]\n"
            "print(S['find_many_keys'], S['readers_built'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 10


def test_join_read_runs_without_jax_and_msgpack(tmp_path):
    """A TPC-H Q5 chain through Tablet.read (CPU tablet, fused plan, plain
    probe) and the host baseline scan, in an interpreter where jax and
    msgpack cannot be imported."""
    code = (_BLOCKED +
            "import numpy as np\n"
            "from yugabyte_db_tpu_torch.docdb.operations import ReadRequest\n"
            "from yugabyte_db_tpu_torch.models import tpch\n"
            "from yugabyte_db_tpu_torch.ops.cpu_scan import "
            "cpu_scan_aggregate\n"
            "from yugabyte_db_tpu_torch.tablet import Tablet\n"
            "data = tpch.generate_lineitem(0.002, seed=1)\n"
            "od = tpch.generate_orders_cust(3000, 300)\n"
            "cd = tpch.generate_customer(300)\n"
            "ld = tpch.lineitem_join_data(data, 3000)\n"
            f"t = Tablet('li', tpch.lineitem_join_info(), {str(tmp_path)!r},"
            " device='cpu')\n"
            "t.bulk_load(ld, block_rows=4096)\n"
            "q = tpch.tpch_q5_chain()\n"
            "r = t.read(ReadRequest('lineitem_j', where=q.probe_where,"
            " aggregates=q.aggs, group_by=tpch._chain_group(q.group_col),"
            " join=tpch.chain_build_wires(q, od, cd)))\n"
            "ref = tpch.numpy_reference_chain(q, ld, od, cd)\n"
            "got = dict(zip(r.group_values[0], r.group_counts))\n"
            "assert all(got.get(g, 0) == c for g, (c, _) in ref.items())\n"
            "blocks = [s.columnar_block(i) for s in t.regular.ssts"
            " for i in range(s.num_blocks())]\n"
            "(rev,), _ = cpu_scan_aggregate(blocks, tpch.TPCH_Q6.columns,"
            " tpch.TPCH_Q6.where, tpch.TPCH_Q6.aggs)\n"
            "assert abs(rev - tpch.numpy_reference(tpch.TPCH_Q6, ld))"
            " <= 1e-9 * abs(rev)\n"
            "print(r.backend, sum(r.group_counts))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    backend, n = out.stdout.split()
    assert backend == "tpu" and int(n) > 0


def test_rows_windows_and_vectors_run_without_jax(tmp_path):
    """A windowed row read through Tablet.read (CPU tablet, filter route)
    and a two-stage IVF search, in an interpreter where jax and msgpack
    cannot be imported."""
    code = (_BLOCKED +
            "import numpy as np\n"
            "from yugabyte_db_tpu_torch.docdb.operations import ReadRequest\n"
            "from yugabyte_db_tpu_torch.models import tpch\n"
            "from yugabyte_db_tpu_torch.ops.window_scan import WindowWire\n"
            "from yugabyte_db_tpu_torch.tablet import Tablet\n"
            "from yugabyte_db_tpu_torch.vector import TwoStageIvfIndex\n"
            "data = tpch.generate_lineitem(0.002, seed=1)\n"
            f"t = Tablet('li', tpch.lineitem_info(), {str(tmp_path)!r},"
            " device='cpu')\n"
            "t.bulk_load(data, block_rows=4096)\n"
            "w = WindowWire(('l_returnflag',), (('l_shipdate', False),),"
            " (('row_number', 0, None, 'rn'),))\n"
            "r = t.read(ReadRequest('lineitem', columns=('rowid',"
            " 'l_returnflag', 'l_shipdate'), where=tpch.TPCH_Q6.where,"
            " window=w))\n"
            "assert r.backend == 'tpu' and r.window_served and r.rows\n"
            "base = np.random.default_rng(0).normal(size=(2000, 16))"
            ".astype(np.float32)\n"
            "idx = TwoStageIvfIndex.build(base, nlists=16, iters=3,"
            " device='cpu')\n"
            "_, ids = idx.search(base[:8] + 0.001, k=5, nprobe=4)\n"
            "assert (ids[:, 0] == np.arange(8)).all()\n"
            "print(len(r.rows), max(x['rn'] for x in r.rows))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_rows, top_rank = map(int, out.stdout.split())
    assert 0 < top_rank <= n_rows


def test_mesh_runs_without_jax():
    """A Q6 through build_sharded_batch and distributed_scan_aggregate
    on a 2-slot CPU mesh, and a sharded exact search, in an interpreter
    where jax and msgpack cannot be imported."""
    code = (_BLOCKED +
            "import numpy as np\n"
            "from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec\n"
            "from yugabyte_db_tpu_torch.models import tpch\n"
            "from yugabyte_db_tpu_torch.parallel import (tablet_mesh,"
            " sharded_exact_search)\n"
            "from yugabyte_db_tpu_torch.parallel.distributed_scan import ("
            "build_sharded_batch, distributed_scan_aggregate)\n"
            "from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime\n"
            "data = tpch.generate_lineitem(0.002, seed=1)\n"
            "blocks = TableCodec(tpch.lineitem_info()).bulk_blocks("
            "data, HybridTime(1000), block_rows=4096)\n"
            "tm = tablet_mesh(2, devices=['cpu', 'cpu'])\n"
            "b = build_sharded_batch(tm, [blocks[::2], blocks[1::2]],"
            " sorted(tpch.TPCH_Q6.columns))\n"
            "(rev,), cnt = distributed_scan_aggregate(b, tpch.TPCH_Q6.where,"
            " tpch.TPCH_Q6.aggs, read_ht=1000)\n"
            "ref = tpch.numpy_reference(tpch.TPCH_Q6, data)\n"
            "assert abs(float(rev) - ref) <= 1e-9 * abs(ref)\n"
            "base = np.random.default_rng(0).normal(size=(2, 100, 8))"
            ".astype(np.float32)\n"
            "_, ids = sharded_exact_search(tm, base[1, :4] + 0.001, base, 3)\n"
            "assert (ids[:, 0] == 100 + np.arange(4)).all()\n"
            "print(int(cnt))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 0


def test_flag_override_restores_on_exit():
    from yugabyte_db_tpu_torch.utils import flags
    assert flags.get("hand_scan_enabled") is False
    with pytest.raises(RuntimeError):
        with flags.overridden("hand_scan_enabled", True):
            assert flags.get("hand_scan_enabled") is True
            raise RuntimeError("boom")
    assert flags.get("hand_scan_enabled") is False
    with pytest.raises(KeyError):
        flags.get("tpu_pallas_scan")      # the port defines its own names


# --- device rule -------------------------------------------------------------
def test_build_batch_defaults_to_cuda_and_raises_without_it(table):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yugabyte_db_tpu_torch.device import DeviceUnavailable
    _, _, pb = table
    with pytest.raises(DeviceUnavailable):
        build_batch(pb, tpch.TPCH_Q6.columns)
    with pytest.raises(DeviceUnavailable):
        build_batch(pb, tpch.TPCH_Q6.columns, device="cuda")
    with pytest.raises(ValueError):
        build_batch(pb, tpch.TPCH_Q6.columns, device="meta")


def test_float_policy_follows_the_batch_device(table):
    from yugabyte_db_tpu_torch.ops.device_batch import f64_conversion
    _, _, pb = table
    frac = [b.fixed[tpch.EXTPRICE][0] for b in pb]
    whole = [b.fixed[tpch.QTY][0] for b in pb]
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert f64_conversion(frac, cpu) is None            # f64 kept
    assert f64_conversion(frac, cuda) == np.float32
    assert f64_conversion(whole, cpu) == np.int32
    with float_dtype("float32"):
        assert f64_conversion(frac, cpu) == np.float32


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory: fails too, printing no result
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
