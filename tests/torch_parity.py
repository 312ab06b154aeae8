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
            "varlen": dict(block.varlen), "keys": block.keys,
            "unique_keys": block.unique_keys}


def block_pair(d: dict):
    """One JAX ColumnarBlock and its port twin from the same lanes (the
    reference_arrays dict shape)."""
    from yugabyte_db_tpu.storage.columnar import ColumnarBlock as JBlock
    from yugabyte_db_tpu_torch.storage.columnar import ColumnarBlock
    jb = JBlock.from_arrays(
        d.get("schema_version", 1), d["key_hash"], d["ht"], d["write_id"],
        pk=d.get("pk"), fixed=d.get("fixed"), varlen=d.get("varlen"),
        tombstone=d["tombstone"], unique_keys=d["unique_keys"],
        keys=d.get("keys"))
    return jb, ColumnarBlock.from_reference_arrays(
        dict(d, n=len(d["key_hash"]), pk=d.get("pk") or {},
             fixed=d.get("fixed") or {}))


def to_jax_aggs(aggs):
    from yugabyte_db_tpu.ops.scan import AggSpec as JAgg
    return tuple(JAgg(a.op, a.expr) for a in aggs)


def to_jax_group(group):
    """A port group spec as the reference's class."""
    from yugabyte_db_tpu.ops.grouped_scan import DictGroupSpec as JDict
    from yugabyte_db_tpu.ops.scan import GroupSpec as JGroup
    from yugabyte_db_tpu.ops.scan import HashGroupSpec as JHash
    from yugabyte_db_tpu_torch.ops.grouped_scan import DictGroupSpec
    from yugabyte_db_tpu_torch.ops.scan import GroupSpec, HashGroupSpec
    if group is None:
        return None
    if isinstance(group, GroupSpec):
        return JGroup(cols=group.cols)
    if isinstance(group, HashGroupSpec):
        return JHash(cols=group.cols, max_groups=group.max_groups)
    assert isinstance(group, DictGroupSpec)
    return JDict(cols=group.cols, max_slots=group.max_slots)


def assert_same_run(jout, pout, what=""):
    """Two ScanKernel.run results equal bit for bit, whatever trailing
    outputs the group shape adds (group values, n_groups, spill)."""
    assert len(jout) == len(pout), (what, len(jout), len(pout))
    jo, po = jout[0], pout[0]
    assert len(jo) == len(po), what
    for i, (a, b) in enumerate(zip(po, jo)):
        assert_bitwise(a, b, f"{what} agg {i}")
    for i, (a, b) in enumerate(zip(pout[1:], jout[1:])):
        if isinstance(b, tuple):
            assert len(a) == len(b), what
            for j, (x, y) in enumerate(zip(a, b)):
                assert_bitwise(x, y, f"{what} out {i + 1}.{j}")
        else:
            assert_bitwise(a, b, f"{what} out {i + 1}")


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


#: lane dtype sets K3 is held to: the reference's f32-cast lanes, a
#: batch's native lanes (integer-valued columns as int32, a fractional
#: column in f64 as under device_float_dtype=float64, bool null lanes
#: and valid), and narrow integers, a bool column and non-bool flags,
#: so that every dtype of HAND_DTYPES is loaded by the kernel
K3_LANE_DTYPES = {
    "f32": ({c: torch.float32 for c in range(6)}, torch.float32,
            torch.float32),
    "native": ({0: torch.float32, 1: torch.float64, 2: torch.float32,
                3: torch.int32, 4: torch.int32, 5: torch.int32},
               torch.bool, torch.bool),
    "narrow": ({0: torch.float32, 1: torch.float64, 2: torch.float32,
                3: torch.int16, 4: torch.int8, 5: torch.bool},
               torch.int8, torch.float64),
}


def k3_typed_lanes(n, dtypes: str, seed=7, null_frac=0.0):
    """k3_lanes' rows as torch lanes of one K3_LANE_DTYPES set ->
    (cols, nulls, valid) dicts/tensor, plus the same values cast to f32
    in numpy (what the reference's caller hands its kernel)."""
    cols, nulls, valid = k3_lanes(n, seed=seed, null_frac=null_frac)
    if dtypes != "f32":
        # an f64 lane of values f32 does not hold exactly, so that the
        # rounding to f32 happens in the port, as it does on a batch
        cols[1] = np.random.default_rng(seed).uniform(900, 105000, n)
    col_t, null_t, valid_t = K3_LANE_DTYPES[dtypes]
    tc = {c: torch.from_numpy(np.asarray(v)).to(col_t[c])
          for c, v in cols.items()}
    tn = {c: torch.from_numpy(v).to(null_t) for c, v in nulls.items()}
    tv = torch.from_numpy(valid).to(valid_t)
    f32 = {c: t.to(torch.float32).numpy() for c, t in tc.items()}
    return tc, tn, tv, f32


# --- a CPU interpreter for K3's generated Triton source --------------------
class _Ptr:
    """A pointer argument: a flat tensor and an element offset."""

    def __init__(self, t, off=0):
        self.t, self.off = t.reshape(-1), off

    def __add__(self, o):
        return _Ptr(self.t, self.off + o)

    __radd__ = __add__


def _as_t(x, like=None):
    if isinstance(x, torch.Tensor):
        return x
    dt = like.dtype if isinstance(like, torch.Tensor) else torch.float32
    return torch.tensor(x, dtype=dt)


class _FakeTL:
    """The slice of triton.language that K3's source uses, on CPU
    tensors: enough to run the generated program's logic (not its
    compilation, which only the card can check)."""
    float32, int32, int64, int1 = (torch.float32, torch.int32, torch.int64,
                                   torch.bool)
    constexpr = object
    pid = 0

    @classmethod
    def program_id(cls, axis):
        return torch.tensor(cls.pid, dtype=torch.int32)

    @staticmethod
    def arange(lo, hi):
        return torch.arange(lo, hi, dtype=torch.int32)

    @staticmethod
    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype)

    @staticmethod
    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype)

    @staticmethod
    def load(p):
        return p.t[p.off]

    @staticmethod
    def store(p, v, mask=None):
        idx, v = p.off, _as_t(v, p.t).to(p.t.dtype)
        if mask is not None:
            idx, v = idx[mask], v.expand(mask.shape)[mask]
        p.t[idx] = v

    @staticmethod
    def where(c, a, b):
        like = a if isinstance(a, torch.Tensor) else b
        return torch.where(c, _as_t(a, like), _as_t(b, like))

    # Triton's minimum/maximum drop a NaN operand (fmin/fmax)
    @staticmethod
    def minimum(a, b):
        like = a if isinstance(a, torch.Tensor) else b
        return torch.fmin(_as_t(a, like), _as_t(b, like))

    @staticmethod
    def maximum(a, b):
        like = a if isinstance(a, torch.Tensor) else b
        return torch.fmax(_as_t(a, like), _as_t(b, like))

    @staticmethod
    def sum(x, axis):
        return x.sum(axis)

    @staticmethod
    def min(x, axis):
        return x.amin(axis)

    @staticmethod
    def max(x, axis):
        return x.amax(axis)

    @staticmethod
    def broadcast_to(x, shape):
        return torch.broadcast_to(_as_t(x), shape)

    @staticmethod
    def reduce(xs, axis, fn):
        """Tree reduction of one or several [N] tensors (N a power of
        two) with the combine function, as a CTA does it."""
        single = isinstance(xs, torch.Tensor)
        xs = [xs] if single else list(xs)
        assert axis == 0 and all(x.dim() == 1 for x in xs)
        while xs[0].shape[0] > 1:
            h = xs[0].shape[0] // 2
            out = fn(*[x[:h] for x in xs], *[x[h:] for x in xs])
            xs = [out] if isinstance(out, torch.Tensor) else list(out)
        return xs[0][0] if single else tuple(x[0] for x in xs)


class _FakeJit:
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)

    def __getitem__(self, grid):
        def run(*args, num_warps=None, **constexprs):
            args = [_Ptr(a) if isinstance(a, torch.Tensor) else a
                    for a in args]
            for pid in range(grid[0]):
                _FakeTL.pid = pid
                self.fn(*args, **constexprs)
        return run


class _FakeLibdevice:
    fmod = staticmethod(torch.fmod)


def interpret_triton(src: str, prelude: str, name: str = "generic_scan"):
    """The kernel ``name`` of generated Triton source, runnable on CPU
    tensors through _FakeTL (the source's import prelude is replaced
    by the fake modules)."""
    assert src.startswith(prelude)
    ns = {"triton": type("triton", (), {"jit": staticmethod(_FakeJit)}),
          "tl": _FakeTL, "libdevice": _FakeLibdevice}
    exec(compile(src[len(prelude):], f"<{name}>", "exec"), ns)
    return ns[name]


Q6_WHERE = ("and",("and", ("and", ("cmp", "ge", ("col", 3), ("const", 8766)),
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
    # one group and one accumulator: the epilogue's reduction has a
    # single operand
    "grouped_g1": (None, [("count", None)], ((5, 1, 0),)),
    # the largest G the hand route takes (64): three group columns
    # (4 x 4 x 4; columns 4 and 5 fill two of each domain, the WHERE's
    # shipdate column the other), with offsets and out-of-domain values
    # clamped into the edge groups
    "grouped_g64": (("cmp", "ge", ("col", 0), ("const", 5.0)),
                    [("sum", ("col", 1)), ("min", ("col", 0)),
                     ("max", ("arith", "mul", ("col", 2), ("col", 1))),
                     ("count", ("col", 2))],
                    ((4, 4, 0), (5, 4, -1), (3, 4, 9000))),
}


def ids_agree(got_ids, want_d_k1, want_ids, k):
    """Per query: the id sets are equal where the reference's k-th and
    (k+1)-th distances differ by more than 1e-4 relative (else a tie
    within rounding may order them either way).  Returns the number of
    queries checked."""
    checked = 0
    for g, wd, wi in zip(got_ids, want_d_k1, want_ids):
        if len(wd) > k and wd[k] - wd[k - 1] <= 1e-4 * abs(wd[k]):
            continue
        assert set(g[:k].tolist()) == set(wi[:k].tolist())
        checked += 1
    return checked


def collect_consts(where, aggs):
    from yugabyte_db_tpu_torch.ops.expr import collect_constants
    consts = []
    if where is not None:
        collect_constants(where, consts)
    for _, e in aggs:
        if e is not None:
            collect_constants(e, consts)
    return consts


# --- compaction (tests/test_torch_compaction.py, tests/test_torch_cuda.py) ---
U64_MAX = (1 << 64) - 1
#: first hybrid time (us) of the seeded compaction stores
COMPACT_BASE_US = 1_700_000_000_000_000
MERGE_CASES = ["heavy", "replays", "padding", "u64max_first", "high_ht",
               "random"]


def merge_frontier_case(case: str, m: int = 4096, wd: int = 2,
                        seed: int = 0):
    """Seeded frontier lanes (dk u64 [m, wd], ht u64, wid u32, tomb,
    valid) for one edge case of the merge program: heavy duplicates,
    exact replays, padding rows, real first words equal to U64_MAX
    (tied with padding), hybrid times above 2**63, or plain random."""
    rng = np.random.default_rng(seed)
    n_keys = {"heavy": 12, "replays": 300, "padding": 200,
              "u64max_first": 50, "high_ht": 100, "random": 2000}[case]
    key_tab = rng.integers(0, 1 << 62, (n_keys, wd), dtype=np.uint64) \
        * np.uint64(3)
    dk = key_tab[rng.integers(0, n_keys, m)]
    ht_base = (1 << 63) + 12345 if case == "high_ht" else 1 << 40
    ht = (np.uint64(ht_base)
          + rng.integers(0, 64, m, dtype=np.uint64) * np.uint64(4096))
    wid = rng.integers(0, 4, m).astype(np.uint32)
    tomb = rng.random(m) < 0.2
    valid = np.ones(m, bool)
    if case == "heavy":
        ht = np.uint64(ht_base) + rng.integers(0, 3, m, dtype=np.uint64)
        wid = rng.integers(0, 2, m).astype(np.uint32)
    if case == "replays":
        src = rng.integers(0, m, m // 3)
        dst = rng.integers(0, m, m // 3)
        dk[dst], ht[dst], wid[dst] = dk[src], ht[src], wid[src]
    if case == "padding":
        valid[m - 1000:] = False
        dk[m - 1000:] = 0
        ht[m - 1000:] = 0
        wid[m - 1000:] = 0
        tomb[m - 1000:] = False
    if case == "u64max_first":
        dk[: m // 4, 0] = np.uint64(U64_MAX)
        dk[m // 4: m // 4 + 16, 1] = 0
        dk[m // 4: m // 4 + 16, 0] = np.uint64(U64_MAX)
        ht[m // 4: m // 4 + 8] = 0
        wid[m // 4: m // 4 + 8] = 0
        valid[m - 500:] = False
        dk[m - 500:] = 0
        ht[m - 500:] = 0
        wid[m - 500:] = 0
    if case == "high_ht":
        ht[::7] = np.uint64(U64_MAX - 1)
    return dk, ht, wid, tomb, valid


def sorted_frontier_row(dk, ht, wid, valid, pos):
    """The frontier row at sorted position `pos` in the merge's order
    (dk words ascending with padding last, then ht and wid descending)."""
    first = np.where(valid, dk[:, 0], np.uint64(U64_MAX))
    keys = [~wid, ~ht] + [dk[:, i] for i in range(dk.shape[1] - 1, 0, -1)]
    return np.lexsort(keys + [first])[pos]


def frontier_carries(dk, ht, wid, valid):
    """Carries that exercise each field against the first sorted row:
    all equal (an exact duplicate across the boundary), another ht,
    another write id, another doc key; each with leq True and False."""
    r = sorted_frontier_row(dk, ht, wid, valid, 0)
    out = []
    for leq in (True, False):
        out += [(dk[r], int(ht[r]), int(wid[r]), leq),
                (dk[r], int(ht[r]) + 1, int(wid[r]), leq),
                (dk[r], int(ht[r]), int(wid[r]) + 1, leq),
                (dk[r] ^ np.uint64(1), int(ht[r]), int(wid[r]), leq)]
    return out


def compaction_batches(data, n_ssts: int, rows_per: int,
                       straddle: bool = False):
    """(row selection, micros) of each SST of a seeded compaction store:
    SST i rewrites a quarter of SST i-1's rows at a later hybrid time;
    with `straddle` every SST rewrites the same 600 rows (many versions
    per doc key)."""
    n = len(data["rowid"])
    out = []
    for i in range(n_ssts):
        if straddle:
            sel = np.arange(600) * 3
        else:
            fresh = (i * rows_per) % (n - rows_per)
            sel = np.arange(fresh, fresh + rows_per) % n
            if i:
                sel[: rows_per // 4] = ((sel - rows_per // 4) % n)[
                    : rows_per // 4]
        out.append((sel, COMPACT_BASE_US + i * 1000))
    return out


def tombstoned_block(cb, block_cls):
    """A delete of every row of bulk-built block `cb` at its own ht and
    write ids (tombstone lane set, value columns NULL with zero values),
    as a `block_cls` block."""
    n = cb.n
    out = block_cls.from_arrays(
        cb.schema_version, cb.key_hash, cb.ht, write_id=cb.write_id,
        pk=cb.pk, tombstone=np.ones(n, bool), unique_keys=cb.unique_keys,
        keys=cb.keys,
        fixed={c: (np.zeros(n, v.dtype), np.ones(n, bool))
               for c, (v, _) in cb.fixed.items()},
        varlen={c: (np.zeros(n, np.uint32), b"", np.ones(n, bool))
                for c in cb.varlen})
    out.keys_proven = cb.keys_proven
    return out


def port_compaction_store(root, table_info, data, n_ssts: int = 8,
                          rows_per: int = 4500, block_rows: int = 512):
    """A port LsmStore of `compaction_batches` SSTs plus a tombstone SST
    (every 10th rowid, between the middle SSTs); returns (store, codec,
    sorted hybrid times)."""
    from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec
    from yugabyte_db_tpu_torch.storage.columnar import ColumnarBlock
    from yugabyte_db_tpu_torch.storage.lsm import LsmStore
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    codec = TableCodec(table_info)
    store = LsmStore(str(root), key_builder=codec.derive_keys,
                     shred_cols=codec.shred_cols)
    hts = []
    for sel, us in compaction_batches(data, n_ssts, rows_per):
        codec.bulk_ingest(store, {k: v[sel] for k, v in data.items()},
                          HybridTime.from_micros(us), block_rows=block_rows)
        hts.append(HybridTime.from_micros(us).value)
    sel = np.nonzero(data["rowid"] % 10 == 0)[0]
    us = COMPACT_BASE_US + (n_ssts // 2) * 1000 - 500
    blocks = [tombstoned_block(b, ColumnarBlock) for b in
              codec.bulk_blocks_iter({k: v[sel] for k, v in data.items()},
                                     HybridTime.from_micros(us),
                                     block_rows=block_rows)]
    store.ingest_sst(lambda w: [w.add_columnar_block(b) for b in blocks],
                     stream=True)
    return store, codec, sorted(hts)


# --- the tablet read seam: paired tablets and responses ----------------------
TABLET_BASE_US = 1_700_000_000_000_000       # mock clocks start here


def tablet_infos(kind: str):
    """(reference TableInfo, port TableInfo) of a lineitem layout:
    'hash' (rowid hashed), 'range' (rowid the range key) or 'str'
    (range-keyed, string flag columns)."""
    from yugabyte_db_tpu.models import tpch as jtpch
    from yugabyte_db_tpu_torch.models import tpch
    fn = {"hash": "lineitem_info", "range": "lineitem_range_info",
          "str": "lineitem_str_info"}[kind]
    return getattr(jtpch, fn)(), getattr(tpch, fn)()


def tablet_pair(root, kind: str, data, n_tablets: int = 1,
                block_rows: int = 8192, loads=((0, None),)):
    """Reference and port tablets (the port's on the CPU) over the same
    rows, each package's tablets sharing one mock clock at
    TABLET_BASE_US.  `loads`: (ht offset in µs from the clock's start,
    row mask or None) per bulk load, each one SST per tablet.  Returns
    (reference tablets, port tablets)."""
    from yugabyte_db_tpu_torch.models import tpch
    jinfo, pinfo = tablet_infos(kind)
    if kind == "str":
        data = tpch.lineitem_str_data(data)
    return tablets_of(root, jinfo, pinfo, data, n_tablets, block_rows,
                      loads)


def tablets_of(root, jinfo, pinfo, data, n_tablets: int = 1,
               block_rows: int = 8192, loads=((0, None),)):
    """:func:`tablet_pair` for any (reference, port) TableInfo pair."""
    import os

    from yugabyte_db_tpu.tablet import Tablet as JTablet
    from yugabyte_db_tpu.utils import hybrid_time as jht
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils import hybrid_time as pht
    jclock = jht.HybridClock(jht.MockPhysicalClock(TABLET_BASE_US))
    pclock = pht.HybridClock(pht.MockPhysicalClock(TABLET_BASE_US))
    jparts = jinfo.partition_schema.create_partitions(n_tablets)
    pparts = pinfo.partition_schema.create_partitions(n_tablets)
    jt, pt = [], []
    for i, (jp, pp) in enumerate(zip(jparts, pparts)):
        jt.append(JTablet(f"t{i}", jinfo, os.path.join(root, f"j{i}"),
                          clock=jclock, partition=jp))
        pt.append(Tablet(f"t{i}", pinfo, os.path.join(root, f"p{i}"),
                         clock=pclock, partition=pp, device="cpu"))
    for off, mask in loads:
        rows = data if mask is None else {k: v[mask]
                                          for k, v in data.items()}
        for j, p in zip(jt, pt):
            j.bulk_load(rows, ht=jht.HybridTime.from_micros(
                TABLET_BASE_US + off), block_rows=block_rows)
            p.bulk_load(rows, ht=pht.HybridTime.from_micros(
                TABLET_BASE_US + off), block_rows=block_rows)
    return jt, pt


def requests(table_id, where, aggs, group, read_ht=None):
    """The same ReadRequest in both packages."""
    from yugabyte_db_tpu.docdb.operations import ReadRequest as JReq
    from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
    return (JReq(table_id, where=where, aggregates=to_jax_aggs(aggs),
                 group_by=to_jax_group(group), read_ht=read_ht),
            ReadRequest(table_id, where=where, aggregates=tuple(aggs),
                        group_by=group, read_ht=read_ht))


def _canon(x):
    if isinstance(x, np.generic):
        x = x.item()
    if isinstance(x, float):
        return ("f", x.hex())
    return (type(x).__name__, x)


def assert_same_value(a, b, what=""):
    """Bitwise for numeric arrays; element by element (None, strings,
    floats by their bits) for object arrays."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == object or b.dtype == object:
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a, b)
        assert [_canon(x) for x in a.ravel()] == \
            [_canon(x) for x in b.ravel()], (what, a, b)
    else:
        assert_bitwise(a, b, what)


def assert_same_answer(pvals, pcounts, jvals, jcounts, pgv=None, jgv=None,
                       what=""):
    assert len(pvals) == len(jvals), what
    for i, (a, b) in enumerate(zip(pvals, jvals)):
        assert_same_value(a, b, f"{what} agg {i}")
    assert (pcounts is None) == (jcounts is None), what
    if jcounts is not None:
        assert_same_value(pcounts, jcounts, f"{what} counts")
    assert (pgv is None) == (jgv is None), what
    for i, (a, b) in enumerate(zip(pgv or (), jgv or ())):
        assert_same_value(a, b, f"{what} group values {i}")


def assert_same_rows_exact(prows, jrows, what=""):
    """Row dicts equal in order, column order, values and Python types
    (floats by their bits)."""
    assert len(prows) == len(jrows), (what, len(prows), len(jrows))
    for i, (p, j) in enumerate(zip(prows, jrows)):
        assert list(p) == list(j), (what, i, p, j)
        assert [_canon(v) for v in p.values()] == \
            [_canon(v) for v in j.values()], (what, i, p, j)


def assert_same_cpu_response(presp, jresp, what=""):
    """Both answered on the interpreted path: rows, paging state,
    aggregate values, counts and group values equal."""
    assert presp.backend == jresp.backend == "cpu", \
        (what, presp.backend, jresp.backend)
    assert_same_rows_exact(presp.rows, jresp.rows, what)
    assert presp.paging_state == jresp.paging_state, what
    assert (presp.agg_values is None) == (jresp.agg_values is None), what
    if jresp.agg_values is not None:
        assert_same_answer(presp.agg_values, presp.group_counts,
                           jresp.agg_values, jresp.group_counts,
                           presp.group_values, jresp.group_values, what)
    assert (presp.window_served, presp.window_reason) == \
        (jresp.window_served, jresp.window_reason), what


def assert_same_response(presp, jresp, what=""):
    assert jresp.backend == "tpu" and presp.backend == "tpu", \
        (what, jresp.backend)
    assert_same_answer(presp.agg_values, presp.group_counts,
                       jresp.agg_values, jresp.group_counts,
                       presp.group_values, jresp.group_values, what)


# --- joins: probe tables, build sides and requests in both packages ----------
BID = 1 << 20                  # BUILD_COL_BASE: the first payload lane id
JOIN_READ_HT = (TABLET_BASE_US + 1000) << 12    # above every load


def probe_infos(str_fk: bool = False):
    """(reference, port) TableInfo of the join tests' probe (fact) table:
    k int64 (hash key), fk int64 or STRING (the FK), val f64, ship
    int32."""
    from yugabyte_db_tpu.docdb import table_codec as jtc
    from yugabyte_db_tpu.dockv import packed_row as jpr
    from yugabyte_db_tpu.dockv.partition import PartitionSchema as JPS
    from yugabyte_db_tpu_torch.docdb import table_codec as ptc
    from yugabyte_db_tpu_torch.dockv import packed_row as ppr
    from yugabyte_db_tpu_torch.dockv.partition import PartitionSchema

    def info(pr, tc, ps):
        T = pr.ColumnType
        schema = pr.TableSchema((
            pr.ColumnSchema(0, "k", T.INT64, is_hash_key=True),
            pr.ColumnSchema(1, "fk", T.STRING if str_fk else T.INT64),
            pr.ColumnSchema(2, "val", T.FLOAT64),
            pr.ColumnSchema(3, "ship", T.INT32),
        ), 1)
        return tc.TableInfo("probe", "probe", schema, ps("hash", 1))
    return info(jpr, jtc, JPS), info(ppr, ptc, PartitionSchema)


def probe_data(n: int, n_keys: int = 600, seed: int = 3,
               frac: bool = False):
    """Probe rows: fk uniform over [0, n_keys) (keys past the build side
    dangle), val integer-valued (exact sums) or fractional, ship
    0..99."""
    rng = np.random.default_rng(seed)
    return {
        "k": np.arange(n, dtype=np.int64),
        "fk": rng.integers(0, n_keys, n).astype(np.int64),
        "val": (rng.uniform(1.0, 100.0, n) if frac
                else rng.integers(1, 100, n).astype(np.float64)),
        "ship": rng.integers(0, 100, n).astype(np.int32),
    }


def probe_pair(root, data, block_rows: int = 4096, str_fk: bool = False):
    """One reference and one port (CPU) probe tablet over `data`."""
    jinfo, pinfo = probe_infos(str_fk)
    (jt,), (pt,) = tablets_of(root, jinfo, pinfo, data,
                              block_rows=block_rows)
    return jt, pt


def tablet_blocks(t):
    """Every columnar block of a tablet's SSTs, in either package."""
    return [r.columnar_block(i) for r in t.regular.ssts
            for i in range(r.num_blocks())]


def wire_pair(probe_col, keys, payload=None):
    """The same JoinWire in both packages (numpy arrays shared)."""
    from yugabyte_db_tpu.ops.join_scan import JoinWire as JWire
    from yugabyte_db_tpu_torch.ops.join_scan import JoinWire
    payload = payload or {}
    return (JWire(probe_col=probe_col, keys=keys, payload=dict(payload)),
            JoinWire(probe_col=probe_col, keys=keys, payload=dict(payload)))


def build_side(n_build: int = 500, probe_col: int = 1,
               null_payload: bool = False, seed: int = 7):
    """The join tests' build side as a wire pair: keys 0..n_build-1, a
    string priority payload at BID and an int64 weight payload at BID + 1
    (every 7th weight NULL on request)."""
    rng = np.random.default_rng(seed)
    prio = np.array([f"P{i % 5}" for i in range(n_build)], object)
    w = rng.integers(1, 10, n_build).astype(np.int64)
    wn = (np.arange(n_build) % 7 == 0) if null_payload else None
    return wire_pair(probe_col, np.arange(n_build, dtype=np.int64),
                     {BID: (prio, None), BID + 1: (w, wn)})


def stages(pairs):
    """A chain's stage pairs as (reference stages, port stages)."""
    return tuple(j for j, _ in pairs), tuple(p for _, p in pairs)


def isolate_reference_plan_kernel(monkeypatch):
    """Put a fresh reference FusedPlanKernel behind its
    default_plan_kernel() for one test.  The reference's own tests count
    compiles on that process-wide kernel; a plan a parity test compiled
    there first would read as theirs when both run in one process."""
    from yugabyte_db_tpu.ops import plan_fusion as jpf
    monkeypatch.setattr(jpf, "_DEFAULT_PLAN_KERNEL", jpf.FusedPlanKernel())


def join_requests(table_id, where, aggs, group, joins, read_ht=JOIN_READ_HT):
    """The same join ReadRequest in both packages; `joins` is a wire pair
    or a (reference stages, port stages) pair."""
    jreq, preq = requests(table_id, where, aggs, group, read_ht)
    jreq.join, preq.join = joins
    return jreq, preq


def by_key(vals, counts, gvals):
    """{group key strings: (count, value bits...)} of a grouped answer."""
    counts = np.asarray(counts)
    out = {}
    for g in np.nonzero(counts)[0]:
        key = tuple(str(v[g]) for v in gvals)
        out[key] = (int(counts[g]),) + tuple(
            _canon(np.asarray(v)[g]) for v in vals)
    return out


# --- edge cases of the join probe (the plain packed probe and the kernel) --

def unpack_table(table: torch.Tensor):
    """The host's three arrays back from a packed probe table
    (join_scan.pack_table): (used bool, table_key int64, table_val
    int32), an empty slot's key and val 0 as the host builder leaves
    them."""
    val = table[:, 1].to(torch.int32)
    used = val >= 0
    return (used, torch.where(used, table[:, 0].to(torch.int64), 0),
            torch.where(used, val, 0).to(torch.int32))


PROBE_EDGE_CASES = ["wrap", "top_bit", "extremes", "empty", "high_bits",
                    "all_masked", "null_keys"]


def probe_wrap_keys(S: int, n: int) -> np.ndarray:
    """`n` keys whose home slot is a table's last: their chain wraps
    from slot S - 1 to slot 0."""
    from yugabyte_db_tpu_torch.ops import join_scan as pjs
    cand = np.arange(1, 200_000, dtype=np.int64)
    return cand[pjs._home_slots(cand, S) == S - 1][:n]


def probe_edge_case(case: str):
    """(build keys, probe keys int64, mask, nulls or None) of one probe
    edge case: a chain that wraps from slot S-1 to 0 (build it at 64
    slots), keys whose hash product sets bit 63, the int64 extremes, an
    empty build side, probe keys equal to a build key in their low 32
    bits only (all misses), an all-masked batch, NULL keys."""
    from yugabyte_db_tpu_torch.ops import join_scan as pjs
    rng = np.random.default_rng(17)
    i64 = np.iinfo(np.int64)
    if case == "wrap":
        ring = probe_wrap_keys(64, 5)
        keys = np.concatenate([ring[:4], rng.choice(
            np.arange(10_000, 20_000), 8, replace=False)])
        probe = np.concatenate([ring, keys, [7, 9]])
    elif case == "top_bit":
        ks = rng.integers(-(1 << 62), 1 << 62, 1200, dtype=np.int64)
        top = (ks.astype(np.uint64) * pjs._HASH_MULT) >> np.uint64(63)
        keys = np.concatenate([np.unique(ks[top == 1])[:298],
                               [i64.max, i64.min]])
        probe = np.concatenate([keys, keys + 1, keys ^ (1 << 40)])
    elif case == "extremes":
        keys = np.array([i64.min, i64.max, -1, 0, 1], np.int64)
        probe = np.array([i64.min, i64.max, i64.min + 1, i64.max - 1, -1,
                          0, 1, 2, -2, 1 << 32, -(1 << 32)], np.int64)
    elif case == "empty":
        keys = np.zeros(0, np.int64)
        probe = rng.integers(-1000, 1000, 300)
    elif case == "high_bits":
        keys = rng.choice(np.arange(-(1 << 31), 1 << 31, 65_537), 200,
                          replace=False).astype(np.int64)
        probe = np.concatenate([keys + (1 << 32), keys - (1 << 32),
                                keys ^ (-(1 << 63)), keys ^ (1 << 47)])
    else:
        assert case in ("all_masked", "null_keys"), case
        keys = rng.choice(5000, 700, replace=False).astype(np.int64)
        probe = rng.integers(0, 6000, 2000)
    probe = np.asarray(probe, np.int64)
    n = len(probe)
    mask = np.zeros(n, bool) if case == "all_masked" else rng.random(n) < .8
    nulls = rng.random(n) < .3 if case == "null_keys" else None
    return keys, probe, mask, nulls


# --- windows: sorted segment lanes -------------------------------------------
#: every op head, with the params the read seam sends (cumulative 1,
#: whole-partition 0) and a few offsets/widths
WINDOW_OPS = [("row_number",), ("rank",), ("dense_rank",), ("count_star", 1),
              ("count_star", 0), ("lag", 1), ("lead", 2), ("lag", 0),
              ("sum", 1), ("sum", 0), ("count", 1), ("count", 0),
              ("min", 1), ("min", 0), ("max", 1), ("max", 0),
              ("rolling_sum", 3), ("rolling_sum", 1)]
WINDOW_CASES = ["one_row", "one_segment", "own_segments", "random",
                "int64_extremes", "float_nan"]


def window_case(case: str):
    """(ops, seg_start, peer_start, values, nulls) of one sorted row set:
    a single row, one segment, every row its own segment, random
    segments and peers with nulls, int64 values near both extremes (the
    sums wrap alike everywhere), and float64 lanes with NaNs (lag, lead,
    min and max only: a SUM truncates to int64, undefined for NaN)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    n = {"one_row": 1, "one_segment": 300, "own_segments": 200}.get(case,
                                                                    2000)
    seg = rng.random(n) < .05
    peer = rng.random(n) < .5
    if case == "one_segment":
        seg[:] = False
    elif case == "own_segments":
        seg[:] = True
    seg[0] = True
    ops = list(WINDOW_OPS)
    if case == "float_nan":
        ops = [o for o in ops if o[0] in ("row_number", "lag", "lead", "min",
                                          "max")]
    values, nulls = [], []
    for op in ops:
        if op[0] in ("row_number", "rank", "dense_rank", "count_star"):
            values.append(None)
            nulls.append(None)
            continue
        if case == "int64_extremes":
            i64 = np.iinfo(np.int64)
            v = np.where(rng.random(n) < .5,
                         rng.integers(i64.max - 1000, i64.max, n,
                                      endpoint=True),
                         rng.integers(i64.min, i64.min + 1000, n))
        elif case == "float_nan":
            v = rng.normal(size=n) * 1e3
            v[rng.random(n) < .05] = np.nan
        else:
            v = rng.integers(-10 ** 6, 10 ** 6, n)
        values.append(np.asarray(v, np.float64 if case == "float_nan"
                                 else np.int64))
        nulls.append(rng.random(n) < (0.0 if case == "one_row" else .2))
    return ops, seg, peer, values, nulls


def window_rows(n: int = 3000, seed: int = 2):
    """Name-keyed rows for serve_window_rows: string and int partition
    keys, an int order key with peers, int, float and nullable lanes."""
    rng = np.random.default_rng(seed)
    return [{"flag": "ANR"[int(f)], "status": int(s), "day": int(d),
             "qty": int(q), "price": float(p),
             "disc": None if m else int(di)}
            for f, s, d, q, p, m, di in zip(
                rng.integers(0, 3, n), rng.integers(0, 2, n),
                rng.integers(0, 400, n), rng.integers(1, 51, n),
                rng.uniform(900, 100_000, n), rng.random(n) < .1,
                rng.integers(0, 11, n))]


#: every item head of a WindowWire over window_rows
WINDOW_ITEMS = (("row_number", 0, None, "rn"), ("rank", 0, None, "rk"),
                ("dense_rank", 0, None, "dr"), ("count_star", 0, None, "cs"),
                ("sum", 1, "qty", "sum_qty"), ("sum", 0, "qty", "tot_qty"),
                ("min", 1, "day", "min_day"), ("max", 1, "qty", "max_qty"),
                ("count", 1, "disc", "n_disc"), ("sum", 1, "disc", "s_disc"),
                ("lag", 1, "price", "prev_price"),
                ("lead", 1, "price", "next_price"),
                ("lead", 2, "disc", "next_disc"))


# --- the write path: small tables, writes in both packages ---------------------
WRITE_BASE_US = 1_000_000      # mock clocks of the write-path tests


def kv_infos(kind: str = "hash"):
    """(reference TableInfo, port TableInfo) of a small table: 'hash'
    (k int64 hashed; v float64, s string, n int32 value columns) or
    'range' (h int64 hashed, r int32 range, then the same values:
    prefix scans) or 'rangepk' (a range-sharded (a int64, b int32)
    key: skip-scan segments)."""
    from yugabyte_db_tpu.docdb.table_codec import TableInfo as JInfo
    from yugabyte_db_tpu.dockv import packed_row as jpr
    from yugabyte_db_tpu.dockv.partition import PartitionSchema as JPS
    from yugabyte_db_tpu_torch.docdb.table_codec import TableInfo as PInfo
    from yugabyte_db_tpu_torch.dockv import packed_row as ppr
    from yugabyte_db_tpu_torch.dockv.partition import PartitionSchema as PPS

    def cols(pr):
        C, T = pr.ColumnSchema, pr.ColumnType
        if kind == "hash":
            key = (C(0, "k", T.INT64, is_hash_key=True),)
        elif kind == "range":
            key = (C(0, "k", T.INT64, is_hash_key=True),
                   C(4, "r", T.INT32, is_range_key=True))
        else:
            key = (C(0, "k", T.INT64, is_range_key=True),
                   C(4, "r", T.INT32, is_range_key=True))
        return key + (C(1, "v", T.FLOAT64), C(2, "s", T.STRING),
                      C(3, "n", T.INT32))

    part = "range" if kind == "rangepk" else "hash"
    nh = 0 if kind == "rangepk" else 1
    return (JInfo("t1", "kv", jpr.TableSchema(cols(jpr), 1), JPS(part, nh)),
            PInfo("t1", "kv", ppr.TableSchema(cols(ppr), 1), PPS(part, nh)))


def kv_tablet_pair(root, kind: str = "hash"):
    """Reference and port tablets (the port's on the CPU) of
    :func:`kv_infos`, each on its own mock clock at WRITE_BASE_US;
    returns (jt, pt, jclock, pclock) — advance both clocks alike."""
    import os

    from yugabyte_db_tpu.tablet import Tablet as JTablet
    from yugabyte_db_tpu.utils import hybrid_time as jht
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils import hybrid_time as pht
    jinfo, pinfo = kv_infos(kind)
    jphys = jht.MockPhysicalClock(WRITE_BASE_US)
    pphys = pht.MockPhysicalClock(WRITE_BASE_US)
    jt = JTablet("w", jinfo, os.path.join(root, "j"),
                 clock=jht.HybridClock(jphys))
    pt = Tablet("w", pinfo, os.path.join(root, "p"),
                clock=pht.HybridClock(pphys), device="cpu")
    return jt, pt, jphys, pphys


def kv_row(rng, k: int, kind: str = "hash", null_frac: float = 0.2):
    """One seeded row of :func:`kv_infos`; value columns NULL with
    probability `null_frac`."""
    row = {"k": int(k)}
    if kind != "hash":
        row["r"] = int(rng.integers(-3, 4))
    row["v"] = None if rng.random() < null_frac else \
        float(rng.integers(-500, 500)) / 4
    row["s"] = None if rng.random() < null_frac else \
        "s" + "x" * int(rng.integers(0, 12)) + str(int(rng.integers(0, 99)))
    row["n"] = None if rng.random() < null_frac else int(rng.integers(-9, 9))
    return row


def write_both(jt, pt, ops, ttl_ms=None, op_id=None):
    """Apply the same row ops [(kind, row)] as ONE WriteRequest to both
    tablets (each at its own clock's time); returns the two
    WriteResponses."""
    from yugabyte_db_tpu.docdb.operations import RowOp as JOp
    from yugabyte_db_tpu.docdb.operations import WriteRequest as JW
    from yugabyte_db_tpu_torch.docdb.operations import RowOp, WriteRequest
    jr = jt.apply_write(JW("t1", [JOp(k, dict(r), ttl_ms)
                                  for k, r in ops]), op_id=op_id)
    pr = pt.apply_write(WriteRequest("t1", [RowOp(k, dict(r), ttl_ms)
                                            for k, r in ops]), op_id=op_id)
    return jr, pr


def store_files(store) -> dict:
    """{file name: bytes} of a store's live SSTs and manifest."""
    import os
    out = {os.path.basename(r.path): open(r.path, "rb").read()
           for r in store.ssts}
    out["MANIFEST"] = open(store._manifest_path, "rb").read()
    return out
