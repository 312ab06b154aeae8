"""Shared fixtures of the port's parity tests (tests/test_torch_*.py):
the same seeded rows go through the JAX reference package and the
PyTorch port, handed across as numpy arrays."""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

#: rows of the small lineitem table: three full 4096-row blocks plus a
#: ragged tail, so padding and block edges are exercised
SMALL_ROWS = 3 * 4096 + 777


@pytest.fixture
def cuda_device():
    """The CUDA device; skips the test where there is none (decided
    here, at run time, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (runs on the card)")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def flags_set(jax_flags: dict, port_flags: dict):
    """Set flags in both packages for the duration of the block."""
    from yugabyte_db_tpu.utils import flags as jf
    from yugabyte_db_tpu_torch.utils import flags as pf
    old_j = {k: jf.get(k) for k in jax_flags}
    old_p = {k: pf.get(k) for k in port_flags}
    try:
        for k, v in jax_flags.items():
            jf.set_flag(k, v)
        for k, v in port_flags.items():
            pf.set_flag(k, v)
        yield
    finally:
        for k, v in old_j.items():
            jf.set_flag(k, v)
        for k, v in old_p.items():
            pf.set_flag(k, v)


def float_dtype(mode: str):
    """device_float_dtype set to `mode` in both packages."""
    return flags_set({"device_float_dtype": mode},
                     {"device_float_dtype": mode})


def lineitem_data(n: int = SMALL_ROWS, seed: int = 5):
    from yugabyte_db_tpu_torch.models import tpch
    return tpch.generate_lineitem(n / tpch.ROWS_PER_SF, seed=seed)


def jax_blocks(data, ht: int = 1000, block_rows: int = 4096):
    from yugabyte_db_tpu.docdb.table_codec import TableCodec
    from yugabyte_db_tpu.models import tpch
    from yugabyte_db_tpu.utils.hybrid_time import HybridTime
    return TableCodec(tpch.lineitem_info()).bulk_blocks(
        data, HybridTime(ht), block_rows=block_rows)


def port_blocks(data, ht: int = 1000, block_rows: int = 4096):
    from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    return TableCodec(tpch.lineitem_info()).bulk_blocks(
        data, HybridTime(ht), block_rows=block_rows)


def reference_arrays(block) -> dict:
    """The lanes of a JAX ColumnarBlock as the plain dict that
    ColumnarBlock.from_reference_arrays takes."""
    return {"n": block.n, "schema_version": block.schema_version,
            "key_hash": block.key_hash, "ht": block.ht,
            "write_id": block.write_id, "tombstone": block.tombstone,
            "pk": dict(block.pk), "fixed": dict(block.fixed),
            "unique_keys": block.unique_keys}


def port_blocks_from(jblocks):
    from yugabyte_db_tpu_torch.storage.columnar import ColumnarBlock
    return [ColumnarBlock.from_reference_arrays(reference_arrays(b))
            for b in jblocks]


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_bitwise(a, b, what=""):
    """Same dtype and the same bits (NaNs included)."""
    a = np.atleast_1d(host(a))
    b = np.atleast_1d(host(b))
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (what, a, b)


def assert_partials(got, want, op: str, what=""):
    """Hand-kernel partials: counts, MIN and MAX exact; f32 sums within
    rtol 2e-4 — f32 accumulation over <= 4096 rows in another order
    (error up to ~4096 * 2^-24 of sum|v|), the reference's own
    tolerance (tests/test_pallas.py)."""
    got = np.asarray(host(got), np.float64)
    want = np.asarray(host(want), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want)), (what, got, want)
    if op == "sum":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def q6_inputs(n, seed=1):
    """Seeded Q6 columns (qty, price, disc, ship) as f64 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(1, 50, n), rng.uniform(900, 105000, n),
            rng.integers(0, 11, n) / 100.0,
            rng.integers(8036, 10592, n).astype(float))


def k3_lanes(n, seed=7, null_frac=0.0):
    rng = np.random.default_rng(seed)
    cols = {
        0: rng.uniform(1, 50, n),
        1: rng.uniform(900, 105000, n),
        2: rng.integers(0, 11, n) / 100.0,
        3: rng.integers(8036, 10592, n).astype(float),
        4: rng.integers(0, 3, n).astype(float),
        5: rng.integers(0, 2, n).astype(float),
    }
    nulls = {cid: (rng.random(n) < null_frac) for cid in cols}
    valid = np.zeros(n, bool)
    valid[:n - 333] = True            # padding tail
    return ({c: v.astype(np.float32) for c, v in cols.items()},
            {c: v.astype(np.float32) for c, v in nulls.items()},
            valid.astype(np.float32))


Q6_WHERE = ("and", ("and", ("and", ("cmp", "ge", ("col", 3), ("const", 8766)),
                             ("cmp", "lt", ("col", 3), ("const", 9131))),
                    ("between", ("col", 2), ("const", 0.05), ("const", 0.07))),
            ("cmp", "lt", ("col", 0), ("const", 24.0)))
REVENUE = ("arith", "mul", ("col", 1), ("col", 2))
K3_CASES = {
    "q6_sum_count": (Q6_WHERE, [("sum", REVENUE), ("count", None)], None),
    "q6_minmax": (Q6_WHERE, [("sum", REVENUE), ("min", ("col", 1)),
                             ("max", ("col", 1)), ("count", ("col", 0))],
                  None),
    "no_where": (None, [("sum", ("col", 0)), ("max", ("col", 3))], None),
    "grouped_q1": (("cmp", "le", ("col", 3), ("const", 10000)),
                   [("sum", ("col", 0)), ("sum", ("col", 1)),
                    ("sum", ("arith", "mul", ("col", 1),
                             ("arith", "sub", ("const", 1.0), ("col", 2)))),
                    ("count", None)],
                   ((4, 3, 0), (5, 2, 0))),
    "grouped_minmax": (("cmp", "gt", ("col", 2), ("const", 0.02)),
                       [("min", ("col", 1)), ("max", ("col", 1)),
                        ("count", ("col", 2))],
                       ((4, 3, 0),)),
    "in_or_not": (("or", ("in", ("col", 4), [0, 2]),
                   ("not", ("cmp", "lt", ("col", 0), ("const", 10.0)))),
                  [("sum", ("col", 0)), ("min", ("col", 2))], None),
    # every other operator of the Triton backend: mod (negative operands
    # and quotients near 3e5, where a - b*trunc(a/b) in f32 drifts from
    # fmod), div and IS NULL
    "mod_div_isnull": (("or", ("cmp", "lt", ("arith", "mod", (
        "arith", "sub", ("const", 50000.0), ("col", 1)), ("const", 7.0)),
        ("const", 1.5)), ("isnull", ("col", 2))),
        [("sum", ("arith", "mod", ("col", 1), ("const", 0.37))),
         ("min", ("arith", "mod", ("col", 1), ("const", 0.37))),
         ("max", ("arith", "div", ("col", 0), ("col", 1))),
         ("count", ("arith", "div", ("col", 2), ("col", 0)))], None),
}


def collect_consts(where, aggs):
    from yugabyte_db_tpu_torch.ops.expr import collect_constants
    consts = []
    if where is not None:
        collect_constants(where, consts)
    for _, e in aggs:
        if e is not None:
            collect_constants(e, consts)
    return consts
