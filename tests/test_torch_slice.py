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


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "yugabyte_db_tpu"), \
            f"{path.relative_to(REPO)} imports {mod}"


def test_port_package_imports_without_jax():
    # a fresh interpreter where importing jax fails outright
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['jaxlib'] = None; "
            "sys.modules['yugabyte_db_tpu'] = None\n"
            "import importlib, pkgutil, yugabyte_db_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


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
