"""The port's hand scan kernels (yugabyte_db_tpu_torch/ops/hand_scan.py)
against the JAX reference's Pallas kernels (yugabyte_db_tpu/ops/
pallas_scan.py, run with interpret=True as tests/test_pallas.py runs
them).  On the CPU each wrapper runs its kernel's plain version.

Tolerance: counts, MIN and MAX exact; f32 SUMs rtol 2e-4 (f32
accumulation over <= 4096 rows in another order).  The kernels
themselves are held against these plain versions on the card by
tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yugabyte_db_tpu.ops import pallas_scan as jps
from yugabyte_db_tpu.ops.expr import compile_expr as jcompile
from yugabyte_db_tpu.ops.expr import const_count
from yugabyte_db_tpu_torch.ops import hand_scan as hs
from tests.torch_parity import (K3_CASES, K3_LANE_DTYPES, assert_partials,
                                collect_consts, flags_set, float_dtype,
                                interpret_triton, k3_lanes, k3_typed_lanes,
                                lineitem_data, port_blocks, q6_inputs)

B = hs.BLOCK_ROWS


# --- K1 ---------------------------------------------------------------------
@pytest.mark.parametrize("n", [B, 3 * B + 777])
def test_q6_plain_matches_pallas(n):
    qty, price, disc, ship = q6_inputs(n)
    args = (8766, 9131, 0.05, 0.07, 24.0)
    js, jc = jps.q6_scan(qty, price, disc, ship, *args, interpret=True)
    ps, pc = hs.q6_scan(qty, price, disc, ship, *args, device="cpu")
    assert pc == jc
    assert abs(ps - js) <= max(1e-6, 2e-4 * abs(js))
    m = ((ship >= 8766) & (ship < 9131) & (disc >= 0.05) & (disc <= 0.07)
         & (qty < 24))
    assert pc == int(m.sum())


def test_q6_empty_match():
    z = np.zeros(B)
    assert hs.q6_scan(z, z, z, z, 10.0, 20.0, 0.5, 0.6, -1.0,
                      device="cpu") == (0.0, 0)


def test_q6_block_partials_match_pallas_blocks():
    n = 3 * B
    qty, price, disc, ship = q6_inputs(n, seed=4)
    lanes = [a.astype(np.float32) for a in (qty, price, disc, ship)]
    valid = np.ones(n, np.float32)
    sc = np.array([8766, 9131, 0.05, 0.07, 24.0], np.float32)
    sums, cnts = hs.q6_scan_kernel(*[torch.from_numpy(a) for a in lanes],
                                   torch.from_numpy(valid),
                                   torch.from_numpy(sc))
    for b in range(3):
        sl = slice(b * B, (b + 1) * B)
        js, jc = jps.q6_scan_pallas(
            *[jnp.asarray(a[sl]) for a in lanes], jnp.asarray(valid[sl]),
            jnp.asarray(sc), interpret=True)
        assert_partials(cnts[b], np.float32(jc), "count", f"block {b}")
        assert_partials(sums[b], np.float32(js), "sum", f"block {b}")


# --- K2 ---------------------------------------------------------------------
@pytest.mark.parametrize("G", [1, 6, 37])
def test_grouped_plain_matches_pallas(G):
    rng = np.random.default_rng(2)
    n = 2 * B + 123
    gids = rng.integers(0, G, n).astype(np.float64)
    vals = rng.uniform(0, 10, n)
    mask = rng.random(n) < 0.7
    want = jps.grouped_sum(gids, vals, mask, num_groups=G, interpret=True)
    got = hs.grouped_sum(gids, vals, mask, G, device="cpu")
    assert_partials(got, want, "sum")
    for g in range(G):
        m = (gids == g) & mask
        np.testing.assert_allclose(got[g], vals[m].sum(), rtol=2e-4)


def test_grouped_out_of_range_gids_contribute_nothing():
    rng = np.random.default_rng(3)
    n = B
    gids = rng.integers(-3, 9, n).astype(np.float64)
    vals = rng.uniform(0, 10, n)
    mask = np.ones(n, bool)
    want = jps.grouped_sum(gids, vals, mask, num_groups=6, interpret=True)
    got = hs.grouped_sum(gids, vals, mask, 6, device="cpu")
    assert_partials(got, want, "sum")


def test_grouped_nonfinite_spreads_nan_like_the_matmul():
    # the reference's one-hot matmul turns a non-finite value into
    # inf*0 = NaN in every OTHER group of its block; the port reproduces
    # it (K2 counts non-finite rows per group in shared memory)
    n = 2 * B
    gids = np.zeros(n)
    gids[:B] = np.arange(B) % 3
    gids[B:] = np.arange(B) % 3
    vals = np.ones(n)
    vals[5] = np.inf           # block 0, group 2
    mask = np.ones(n, bool)
    want = jps.grouped_sum_pallas(
        *[jnp.asarray(a.astype(np.float32)) for a in (gids, vals, mask)],
        3, interpret=True)
    got = hs.grouped_sum_device(
        *[torch.from_numpy(a.astype(np.float32)) for a in (gids, vals,
                                                           mask)], 3)
    assert np.isnan(np.asarray(want)[:2]).all()
    assert_partials(got, want, "sum")
    part = hs.grouped_sum_kernel(
        *[torch.from_numpy(a.astype(np.float32)) for a in (gids, vals,
                                                           mask)], 3)
    assert torch.isnan(part[0, :2]).all() and torch.isinf(part[0, 2])
    assert torch.isfinite(part[1]).all()


# --- K3 ---------------------------------------------------------------------
def _jax_k3(name, carr, cols, nulls, valid):
    """The reference's build_generic_scan (interpret mode) on f32 numpy
    lanes; col_order = null_order = the sorted column ids."""
    where, aggs, group = K3_CASES[name]
    order = tuple(sorted(cols))
    G = int(np.prod([d for _, d, _ in group])) if group else None
    off = const_count(where) if where is not None else 0
    jfns = []
    for op, e in aggs:
        jfns.append((op, jcompile(e, offset=off) if e is not None else None))
        if e is not None:
            off += const_count(e)
    jrun = jps.build_generic_scan(where, jfns, group, G, order, order,
                                  len(collect_consts(where, aggs)),
                                  interpret=True)
    return jrun(jnp.asarray(carr), [jnp.asarray(cols[c]) for c in order],
                [jnp.asarray(nulls[c]) for c in order], jnp.asarray(valid))


def _run_k3(name, n, null_frac):
    where, aggs, group = K3_CASES[name]
    cols, nulls, valid = k3_lanes(n, null_frac=null_frac)
    col_order = tuple(sorted(cols))
    null_order = col_order
    consts = collect_consts(where, aggs)
    G = int(np.prod([d for _, d, _ in group])) if group else None
    carr = np.asarray([float(c) for c in consts] or [0.0], np.float32)
    jout = _jax_k3(name, carr, cols, nulls, valid)
    k3 = hs.GenericScan(where, aggs, group, G, col_order, null_order,
                               len(consts))
    pout = k3(torch.from_numpy(carr),
              [torch.from_numpy(cols[c]) for c in col_order],
              [torch.from_numpy(nulls[c]) for c in null_order],
              torch.from_numpy(valid))
    return aggs, jout, pout, k3


@pytest.mark.parametrize("null_frac", [0.0, 0.2])
@pytest.mark.parametrize("name", sorted(K3_CASES))
def test_generic_plain_matches_pallas(name, null_frac):
    aggs, jout, pout, _ = _run_k3(name, 2 * B, null_frac)
    assert len(jout) == len(pout) == len(aggs) + 1
    for (op, _), j, p in zip(list(aggs) + [("count", None)], jout, pout):
        assert_partials(p, j, op, f"{name} {op}")


def test_generic_grouped_nonfinite_spreads_nan():
    # a valid row whose SUM value is +inf: the reference's one-hot
    # matmul gives NaN in the other groups of that block; the port's
    # plain version and K3 (one-hot product in registers) reproduce it
    where, aggs, group = None, [("sum", ("col", 0))], ((4, 3, 0),)
    cols, nulls, valid = k3_lanes(B)
    cols[0][10] = np.inf
    cols[4][10] = 1.0
    col_order = tuple(sorted(cols))
    jrun = jps.build_generic_scan(None, [("sum", jcompile(("col", 0)))],
                                  group, 3, col_order, col_order, 0,
                                  interpret=True)
    jout = jrun(jnp.zeros(1, jnp.float32),
                [jnp.asarray(cols[c]) for c in col_order],
                [jnp.asarray(nulls[c]) for c in col_order],
                jnp.asarray(valid))
    k3 = hs.GenericScan(where, aggs, group, 3, col_order, col_order,
                               0)
    pout = k3(torch.zeros(1), [torch.from_numpy(cols[c]) for c in col_order],
              [torch.from_numpy(nulls[c]) for c in col_order],
              torch.from_numpy(valid))
    got, want = pout[0].numpy(), np.asarray(jout[0])
    assert np.isnan(want[0, [0, 2]]).all() and np.isinf(want[0, 1])
    assert_partials(got, want, "sum")


@pytest.mark.parametrize("name", sorted(K3_CASES))
def test_generic_triton_source_is_python(name):
    where, aggs, group = K3_CASES[name]
    G = int(np.prod([d for _, d, _ in group])) if group else None
    k3 = hs.GenericScan(where, aggs, group, G, tuple(range(6)),
                               tuple(range(6)), len(collect_consts(where, aggs)))
    src = k3.triton_source()
    compile(src, "<generic_scan>", "exec")
    assert "@triton.jit" in src and "def generic_scan(" in src


# --- K3 on native-dtype lanes ----------------------------------------------
def _k3_typed(name, lanes, n=2 * B, null_frac=0.2):
    """A K3 for case `name` and its call on one K3_LANE_DTYPES set of
    lanes, plus those lanes cast to f32 in numpy."""
    where, aggs, group = K3_CASES[name]
    cols, nulls, valid, cols_f32 = k3_typed_lanes(n, lanes,
                                                  null_frac=null_frac)
    order = tuple(sorted(cols))
    consts = collect_consts(where, aggs)
    G = int(np.prod([d for _, d, _ in group])) if group else None
    k3 = hs.GenericScan(where, aggs, group, G, order, order, len(consts))
    carr = torch.tensor([float(c) for c in consts] or [0.0],
                        dtype=torch.float32)
    call = (carr, [cols[c] for c in order], [nulls[c] for c in order],
            valid)
    return k3, call, cols_f32


@pytest.mark.parametrize("lanes", ["native", "narrow"])
@pytest.mark.parametrize("name", sorted(K3_CASES))
def test_generic_plain_on_native_lanes_matches_pallas(name, lanes):
    # the reference's caller casts every lane to f32 before its kernel;
    # the port's plain version takes the lanes as they are and casts
    # them itself
    k3, (carr, cols, nulls, valid), cols_f32 = _k3_typed(name, lanes)
    f32 = torch.float32
    jout = _jax_k3(name, carr.numpy(), cols_f32,
                   {c: t.to(f32).numpy() for c, t in zip(k3.null_order,
                                                         nulls)},
                   valid.to(f32).numpy())
    pout = k3(carr, cols, nulls, valid)
    assert {t.dtype for t in cols + nulls + [valid]} != {f32}
    assert len(jout) == len(pout)
    for (op, _), j, p in zip(list(k3.aggs) + [("count", None)], jout, pout):
        assert_partials(p, j, op, f"{name} {lanes} {op}")


@pytest.mark.parametrize("lanes", sorted(K3_LANE_DTYPES))
@pytest.mark.parametrize("name", sorted(K3_CASES))
def test_generic_triton_source_parses_for_lane_dtypes(name, lanes):
    import ast
    k3, call, _ = _k3_typed(name, lanes)
    dtypes = [t.dtype for t in call[1] + call[2] + [call[3]]]
    tree = ast.parse(k3.triton_source(dtypes))
    kernel = [f for f in tree.body if isinstance(f, ast.FunctionDef)
              and f.name == "generic_scan"]
    assert len(kernel) == 1


_FORMS = {"unrolled": ("unrolled", 256, 4), "tile": ("tile", 128, 8)}
_SOURCE_CASES = [(name, lanes, form) for name in sorted(K3_CASES)
                 for lanes in sorted(K3_LANE_DTYPES)
                 for form in (("flat",) if K3_CASES[name][2] is None
                              else ("unrolled", "tile"))]


def _interpreted(k3, form):
    """Run K3's own launch() with its generated source executed by the
    CPU interpreter of tests/torch_parity.py in place of Triton."""
    if form != "flat":
        k3.config = _FORMS[form]
    k3._load_kernel = lambda dtypes: interpret_triton(
        k3.triton_source(dtypes), hs._TRITON_PRELUDE)
    return k3


@pytest.mark.parametrize("name,lanes,form", _SOURCE_CASES)
def test_generic_source_matches_plain(name, lanes, form):
    # the generated program's logic, in every form and on every lane
    # dtype set, against the plain version (the card checks that Triton
    # compiles it, tests/test_torch_cuda.py)
    k3, call, _ = _k3_typed(name, lanes)
    if form == "flat":
        assert k3.config[0] == "flat"
    want = k3.plain(*call)
    got = _interpreted(k3, form).launch(*call)
    hs.reset_launches()
    assert got.shape == (len(want),) + tuple(want[0].shape)
    for (op, _), g, w in zip(list(k3.aggs) + [("count", None)], got, want):
        assert_partials(g, w, op, f"{name} {lanes} {form} {op}")


@pytest.mark.parametrize("form", ["unrolled", "tile"])
def test_generic_source_spreads_nan_like_plain(form):
    # a valid +inf SUM value gives NaN in the other groups of its block;
    # a NaN MIN value gives NaN in its own group only
    aggs = [("sum", ("col", 0)), ("min", ("col", 1)), ("count", None)]
    cols, nulls, valid, _ = k3_typed_lanes(B, "native")
    cols[0][10] = float("inf")
    cols[4][10] = 1
    cols[1][20] = float("nan")
    cols[4][20] = 2
    order = tuple(sorted(cols))
    k3 = hs.GenericScan(None, aggs, ((4, 3, 0),), 3, order, order, 0)
    call = (torch.zeros(1), [cols[c] for c in order],
            [nulls[c] for c in order], valid)
    want = k3.plain(*call)
    got = _interpreted(k3, form).launch(*call)
    hs.reset_launches()
    assert torch.isnan(want[0][0, [0, 2]]).all()
    assert torch.isinf(want[0][0, 1])
    assert torch.isnan(want[1][0]).tolist() == [False, False, True]
    for (op, _), g, w in zip(aggs + [("count", None)], got, want):
        assert_partials(g, w, op, f"{form} {op}")


def test_k3_config_forms():
    # grouped_q1 (4 distinct accumulators x 6 groups) takes the unrolled
    # form; G = 64 with min/max flags takes the register tile; ungrouped
    # scans keep the flat body
    cfg = {name: _k3_typed(name, "f32")[0].config for name in K3_CASES}
    assert cfg["grouped_q1"] == ("unrolled", 256, 4)
    assert cfg["grouped_g64"][0] == "tile"
    assert cfg["q6_sum_count"] == ("flat", 1024, 4)
    for form, sub, warps in cfg.values():
        assert B % sub == 0 and sub & (sub - 1) == 0 and warps in (4, 8)


def test_partials_is_one_buffer_and_call_its_views():
    k3, call, _ = _k3_typed("grouped_q1", "native")
    buf = k3.partials(*call)
    outs = k3(*call)
    assert buf.shape == (5, 2, 6) and buf.dtype == torch.float32
    assert all(torch.equal(o, b) for o, b in zip(outs, buf))


def test_k3_rejects_lanes_outside_the_hand_set():
    k3, (carr, cols, nulls, valid), _ = _k3_typed("no_where", "native")
    for bad in (cols[0].to(torch.int64), torch.zeros(4 * B)[::2],
                cols[0][:B], torch.zeros(2 * B, dtype=torch.uint8)):
        with pytest.raises(ValueError):
            k3(carr, [bad] + cols[1:], nulls, valid)


def test_plain_versions_never_count_launches():
    hs.reset_launches()
    test_q6_empty_match()
    _run_k3("q6_sum_count", B, 0.0)
    hs.grouped_sum(np.zeros(B), np.ones(B), np.ones(B, bool), 2,
                   device="cpu")
    assert hs.LAUNCHES == {"q6_scan": 0, "grouped_sum": 0,
                           "generic_scan": 0, "join_probe": 0}


def test_wrappers_reject_badk3_lanes():
    t = torch.zeros(B + 1)
    with pytest.raises(ValueError):
        hs.q6_scan_kernel(t, t, t, t, t, torch.zeros(5))
    with pytest.raises(ValueError):
        hs.grouped_sum_kernel(torch.zeros(B, dtype=torch.float64),
                              torch.zeros(B), torch.zeros(B), 3)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    z = np.zeros(B)
    from yugabyte_db_tpu_torch.device import DeviceUnavailable
    with pytest.raises(DeviceUnavailable):
        hs.q6_scan(z, z, z, z, 0, 1, 0, 1, 1)
    with pytest.raises(DeviceUnavailable):
        hs.grouped_sum(z, z, z.astype(bool), 2)


def test_failed_build_raises(tmp_path, monkeypatch):
    # a compiler that fails must surface as KernelBuildError with its
    # output — never as a quiet fallback to the plain version
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: deliberately broken' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(hs, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(hs, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(hs.KernelBuildError, match="deliberately broken"):
        hs.build_cuda_kernels()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(hs.shutil, "which", lambda name: None)
    real_exists = hs.os.path.exists
    monkeypatch.setattr(hs.os.path, "exists",
                        lambda p: False if str(p).endswith("nvcc")
                        else real_exists(p))
    monkeypatch.setattr(hs, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(hs.KernelBuildError, match="nvcc not found"):
        hs.build_cuda_kernels()


# --- routed path (mirrors tests/test_pallas.py TestPallasRoutedPath) -------
class TestHandRoutedPath:
    def _batches(self, n=3 * B):
        """The same padded batch for both packages."""
        from yugabyte_db_tpu.ops.device_batch import DeviceBatch as JB
        from yugabyte_db_tpu_torch.ops.device_batch import DeviceBatch as PB
        rng = np.random.default_rng(7)
        padded = ((n + B - 1) // B) * B
        raw = {
            0: rng.uniform(1, 50, n).astype(np.float32),
            1: rng.uniform(900, 105000, n).astype(np.float64),
            2: (rng.integers(0, 11, n) / 100.0),
            3: rng.integers(8036, 10592, n).astype(np.int32),
            4: rng.integers(0, 3, n).astype(np.int32),
        }

        def pad(a):
            out = np.zeros(padded, a.dtype)
            out[:n] = a
            return out
        valid = np.zeros(padded, bool)
        valid[:n] = True
        jb = JB(cols={c: jnp.asarray(pad(v)) for c, v in raw.items()},
                nulls={c: jnp.zeros(padded, bool) for c in raw},
                valid=jnp.asarray(valid), n_rows=n)
        pb = PB(cols={c: torch.from_numpy(pad(v)) for c, v in raw.items()},
                nulls={c: torch.zeros(padded, dtype=torch.bool)
                       for c in raw},
                valid=torch.from_numpy(valid), n_rows=n)
        return jb, pb

    @staticmethod
    def _q6(pkg):
        from importlib import import_module
        ops = import_module(f"{pkg}.ops.expr")
        scan = import_module(f"{pkg}.ops.scan")
        C = ops.Expr.col
        where = ((C(3) >= 8766) & (C(3) < 9131) & (C(2) >= 0.05)
                 & (C(2) <= 0.07) & (C(0) < 24.0)).node
        aggs = (scan.AggSpec("sum", (C(1) * C(2)).node),
                scan.AggSpec("count"), scan.AggSpec("min", C(1).node),
                scan.AggSpec("max", C(1).node))
        return where, aggs

    def test_routed_matches_reference_ungrouped(self):
        from yugabyte_db_tpu.ops.scan import ScanKernel as JK
        from yugabyte_db_tpu_torch.ops.scan import ScanKernel as PK
        jb, pb = self._batches()
        jw, ja = self._q6("yugabyte_db_tpu")
        pw, pa = self._q6("yugabyte_db_tpu_torch")
        with flags_set({"tpu_pallas_scan": True},
                       {"hand_scan_enabled": True}):
            jo, jc, jm = JK().run(jb, jw, ja)
            k = PK(device="cpu")
            po, pc, pm = k.run(pb, pw, pa)
        assert jm is None and pm is None, "hand/pallas route not taken"
        assert int(pc) == int(jc)
        for op, a, b in zip(("sum", "count", "min", "max"), po, jo):
            assert_partials(a, b, op, op)
        # and against the port's own exact route (whose MIN/MAX carry the
        # f64 column's value; the hand route's are its f32 rounding)
        eo, ec, _ = PK(device="cpu").run(pb, pw, pa)
        assert int(ec) == int(pc)
        for op, a, b in zip(("sum", "count", "min", "max"), po, eo):
            assert_partials(a, np.float32(b) if op in ("min", "max")
                            else b, op, op)

    def test_routed_matches_reference_grouped(self):
        from yugabyte_db_tpu.ops import Expr as JE
        from yugabyte_db_tpu.ops.scan import AggSpec as JA
        from yugabyte_db_tpu.ops.scan import GroupSpec as JG
        from yugabyte_db_tpu.ops.scan import ScanKernel as JK
        from yugabyte_db_tpu_torch.ops.expr import Expr as PE
        from yugabyte_db_tpu_torch.ops.scan import AggSpec as PA
        from yugabyte_db_tpu_torch.ops.scan import GroupSpec as PG
        from yugabyte_db_tpu_torch.ops.scan import ScanKernel as PK
        jb, pb = self._batches()
        with flags_set({"tpu_pallas_scan": True},
                       {"hand_scan_enabled": True}):
            jo, jc, jm = JK().run(
                jb, (JE.col(3) <= 10000).node,
                (JA("sum", JE.col(1).node), JA("count")),
                JG(cols=((4, 3, 0),)))
            po, pc, pm = PK(device="cpu").run(
                pb, (PE.col(3) <= 10000).node,
                (PA("sum", PE.col(1).node), PA("count")),
                PG(cols=((4, 3, 0),)))
        assert jm is None and pm is None
        assert np.asarray(pc).tolist() == np.asarray(jc).tolist()
        assert_partials(po[0], jo[0], "sum")
        assert_partials(po[1], jo[1], "count")

    @pytest.mark.parametrize("reason", [
        "mvcc_or_no_aggs", "group_shape", "agg_op", "bucket_rows",
        "column_dtype", "int32_range", "const_shape", "const_range"])
    def test_refusal_reasons_match_reference(self, reason):
        from importlib import import_module
        jb, pb = self._batches()
        outs = []
        for pkg, batch in (("yugabyte_db_tpu", jb),
                           ("yugabyte_db_tpu_torch", pb)):
            scan = import_module(f"{pkg}.ops.scan")
            err = import_module(f"{pkg}.ops.pallas_scan").PallasIneligible \
                if pkg == "yugabyte_db_tpu" else \
                import_module(f"{pkg}.ops.hand_scan").HandScanIneligible
            k = scan.ScanKernel() if pkg == "yugabyte_db_tpu" \
                else scan.ScanKernel(device="cpu")
            gate = k._pallas_eligible if pkg == "yugabyte_db_tpu" \
                else k._hand_eligible
            A, G = scan.AggSpec, scan.GroupSpec
            cnt = (A("count"),)
            args = {
                "mvcc_or_no_aggs": (None, (), None, "visible", ()),
                "group_shape": (None, cnt, G(cols=((4, 9, 0), (3, 9, 0))),
                                "none", ()),
                "agg_op": (None, (A("avg", ("col", 0)),), None, "none",
                           ()),
                "bucket_rows": None,
                "column_dtype": (("cmp", "ge", ("col", 9), ("const", 1)),
                                 cnt, None, "none", (1,)),
                "int32_range": (("cmp", "ge", ("col", 8), ("const", 1)),
                                cnt, None, "none", (1,)),
                "const_shape": (None, cnt, None, "none",
                                (np.zeros(2, bool),)),
                "const_range": (None, cnt, None, "none", (2.0 ** 25,)),
            }[reason]
            if reason == "bucket_rows":
                rows = 4096 + 8
                if pkg == "yugabyte_db_tpu":
                    batch.valid = jnp.zeros(rows, bool)
                else:
                    batch.valid = torch.zeros(rows, dtype=torch.bool)
                args = (None, cnt, None, "none", ())
            wide = np.arange(batch.padded_rows, dtype=np.int64)
            big = (wide * 4096).astype(np.int32)
            if pkg == "yugabyte_db_tpu":
                batch.cols[9] = jnp.asarray(wide)
                batch.cols[8] = jnp.asarray(big)
            else:
                batch.cols[9] = torch.from_numpy(wide)
                batch.cols[8] = torch.from_numpy(big)
            with pytest.raises(err) as ei:
                gate(batch, *args)
            outs.append(str(ei.value))
        assert outs == [reason, reason]

    def test_int32_range_guard_reads_once_per_batch(self, monkeypatch):
        # the guard's min/max is a device reduction plus a host sync:
        # the batch's int32_ranges memo must stop the second one
        from yugabyte_db_tpu_torch.ops.scan import AggSpec, ScanKernel
        _, batch = self._batches()
        col = batch.cols[3]
        calls = []
        for name in ("min", "max"):
            real = getattr(torch.Tensor, name)

            def counted(t, *a, _real=real, _name=name, **kw):
                if t is col:
                    calls.append(_name)
                return _real(t, *a, **kw)
            monkeypatch.setattr(torch.Tensor, name, counted)
        k = ScanKernel(device="cpu")
        with flags_set({}, {"hand_scan_enabled": True}):
            for _ in range(2):
                _, _, mask = k.run(batch, ("cmp", "ge", ("col", 3),
                                           ("const", 9000)),
                                   (AggSpec("count"),))
                assert mask is None          # served by the hand route
        assert sorted(calls) == ["max", "min"]
        c = col.numpy()
        assert batch.int32_ranges == {3: (int(c.min()), int(c.max()))}

    def test_refusals_are_typed_and_tallied(self):
        from yugabyte_db_tpu_torch.ops.expr import Expr
        from yugabyte_db_tpu_torch.ops.scan import AggSpec, ScanKernel
        _, batch = self._batches()
        batch.cols[5] = torch.arange(batch.padded_rows, dtype=torch.int64)
        batch.nulls[5] = torch.zeros(batch.padded_rows, dtype=torch.bool)
        k = ScanKernel(device="cpu")
        with flags_set({}, {"hand_scan_enabled": True}):
            out, cnt, mask = k.run(batch, (Expr.col(5) >= 10).node,
                                   (AggSpec("count"),))
            assert mask is not None          # served by the exact route
            assert k.hand_scan_refusals == {"column_dtype": 1}
            k.run(batch, (Expr.col(5) >= 10).node, (AggSpec("count"),))
            assert k.hand_scan_refusals == {"column_dtype": 2}
        assert int(out[0]) == batch.padded_rows - 10 - int(
            (~batch.valid).sum())


# --- the hand route hands K3 the batch's own lanes --------------------------
@pytest.fixture(scope="module")
def q1_batches():
    """A small lineitem batch on the CPU, under the CPU's own float
    policy (fractional columns f64) and under the card's (f32)."""
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops.device_batch import build_batch
    blocks = port_blocks(lineitem_data())
    out = {"auto": build_batch(blocks, tpch.TPCH_Q1.columns, device="cpu")}
    with float_dtype("float32"):
        out["float32"] = build_batch(blocks, tpch.TPCH_Q1.columns,
                                     device="cpu")
    return out


@pytest.mark.parametrize("mode", ["auto", "float32"])
def test_hand_plan_passes_the_batch_tensors(q1_batches, mode):
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops.scan import ScanKernel
    batch = q1_batches[mode]
    q = tpch.TPCH_Q1
    k = ScanKernel(device="cpu")
    entry, (carr, cols, nulls, valid) = k.hand_scan_plan(
        batch, q.where, q.aggs, q.group)
    for t, cid in zip(cols, entry.col_order):
        assert t.data_ptr() == batch.cols[cid].data_ptr()
        assert t.dtype == batch.cols[cid].dtype
    for t, cid in zip(nulls, entry.null_order):
        assert t.data_ptr() == batch.nulls[cid].data_ptr()
        assert t.dtype == torch.bool
    assert valid.data_ptr() == batch.valid.data_ptr()
    assert valid.dtype == torch.bool
    frac = torch.float64 if mode == "auto" else torch.float32
    assert {t.dtype for t in cols} == {torch.int32, frac}
    # 36 bytes a row on the card's policy: 3 f32 + 4 int32 columns, 7
    # bool null lanes and valid (60 with every lane cast to f32)
    if mode == "float32":
        assert sum(t.element_size() for t in cols + nulls + [valid]) == 36
    assert carr.dtype == torch.float32


@pytest.mark.parametrize("second", ["sum", "avg"])
@pytest.mark.parametrize("grouped", [False, True])
def test_cached_entry_keeps_each_querys_constants(q1_batches, grouped,
                                                  second):
    # one cached K3 entry serves every query of its signature, and the
    # signature leaves constant values out: two aggregates alike but for
    # their constants must each read their own (here through the
    # generated source, run by the CPU stand-in for Triton).  AVG
    # expands to a SUM of the same shape beside the first
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops.scan import AggSpec, ScanKernel
    batch = q1_batches["float32"]
    q = tpch.TPCH_Q1
    qty = q.aggs[0].expr

    def aggs(c):
        return [AggSpec("sum", ("arith", "mul", qty, ("const", 2.0))),
                AggSpec(second, ("arith", "mul", qty, ("const", c)))]
    group = q.group if grouped else None
    k = ScanKernel(device="cpu")
    first, _ = k.hand_scan_plan(batch, q.where, aggs(2.0), group)
    entry, call = k.hand_scan_plan(batch, q.where, aggs(3.0), group)
    assert entry is first                    # served from the cache
    want = entry.plain(*call)
    entry._load_kernel = lambda dtypes: interpret_triton(
        entry.triton_source(dtypes), hs._TRITON_PRELUDE)
    got = entry.launch(*call)
    hs.reset_launches()
    for (op, _), g, w in zip(list(entry.aggs) + [("count", None)], got,
                             want):
        assert_partials(g, w, op, f"{second} {op}")
    assert_partials(got[1], got[0] * 1.5, "sum")


def test_try_hand_copies_all_partials_at_once(q1_batches, monkeypatch):
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops import scan as pscan
    batch = q1_batches["float32"]
    q = tpch.TPCH_Q1
    copies = []
    real_np = pscan._np
    monkeypatch.setattr(pscan, "_np", lambda x: copies.append(
        tuple(x.shape)) or real_np(x))

    def no_views(*a):
        raise AssertionError("the hand route reads GenericScan.partials")
    monkeypatch.setattr(hs.GenericScan, "__call__", no_views)
    k = pscan.ScanKernel(device="cpu")
    with flags_set({}, {"hand_scan_enabled": True}):
        out, counts, mask = k.run(batch, q.where, q.aggs, q.group)
    assert mask is None and k.hand_scan_refusals == {}
    grid = batch.padded_rows // B
    assert copies == [(len(q.aggs) + 1, grid, 6)]
    ref = tpch.numpy_reference(q, lineitem_data())
    for g in range(6):
        assert int(counts[g]) == ref[g][2] == int(out[4][g])
        assert float(out[0][g]) == ref[g][0]
