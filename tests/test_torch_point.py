"""Point, prefix and enumerated reads of the port (yugabyte_db_tpu_torch/
docdb/operations.py get_row, multi_get, _prefix_scan and the enumerated
MultiGet of _hash_enumerated_read; storage/sst.py point_find and the
blooms; the memtables' row-prefix guard) against the JAX reference on
the CPU: the same seeded writes (upserts, deletes, NULLs, row TTLs)
under mock clocks, read over a memtable-only, an SST-only and a mixed
store, at several read points — equal rows, equal misses, and the same
read restart inside the clock-uncertainty window.  Tolerance: none."""
import numpy as np
import pytest

from yugabyte_db_tpu.docdb.operations import ReadRequest as JReq
from yugabyte_db_tpu.docdb.operations import \
    ReadRestartError as JRestart
from yugabyte_db_tpu_torch.docdb.operations import (ReadRequest,
                                                    ReadRestartError)
from tests.torch_parity import (assert_same_cpu_response, flags_set,
                                kv_row, kv_tablet_pair, write_both)

KEYS = 30
STATES = ["memtable", "sst", "mixed"]


def _build(root, kind, state, seed=2):
    """Tablets after a seeded write sequence; returns (jt, pt, read
    points taken along the way, the clocks)."""
    jt, pt, jphys, pphys = kv_tablet_pair(root, kind)
    rng = np.random.default_rng(seed)
    points = []
    for step in range(160):
        us = int(rng.integers(1, 40))
        jphys.advance_micros(us)
        pphys.advance_micros(us)
        k = int(rng.integers(0, KEYS))
        row = kv_row(rng, k, kind)
        c = rng.random()
        if c < 0.65:
            ops = [("upsert", row)]
        elif c < 0.8:
            pk = {"k": k} if kind == "hash" else {"k": k, "r": row["r"]}
            ops = [("delete", pk)]
        else:
            ops = [("upsert", kv_row(rng, int(rng.integers(0, KEYS)), kind))
                   for _ in range(3)]
        ttl = int(rng.integers(1, 3)) if rng.random() < 0.2 else None
        write_both(jt, pt, ops, ttl)
        if state == "mixed" and step % 60 == 59:
            jt.flush()
            pt.flush()
        if step % 25 == 0:
            points.append((jphys.now_micros() << 12) + 1)
    if state == "sst":
        jt.flush()
        pt.flush()
    assert (len(pt.regular.ssts) > 0) == (state != "memtable")
    assert pt.regular.memtable_empty() == (state == "sst")
    points.append((jphys.now_micros() << 12) + 1)
    return jt, pt, points, (jphys, pphys)


def _pk_rows(kind):
    if kind == "hash":
        return [{"k": k} for k in range(KEYS + 3)]
    return [{"k": k, "r": r} for k in range(0, KEYS, 3) for r in (-3, 0, 2)]


@pytest.mark.parametrize("kind", ["hash", "range"])
@pytest.mark.parametrize("state", STATES)
def test_point_reads_match_reference(tmp_path, kind, state):
    jt, pt, points, _ = _build(str(tmp_path), kind, state)
    pks = _pk_rows(kind)
    for read_ht in points:
        want = [jt._read_op.get_row(r, read_ht) for r in pks]
        assert [pt._read_op.get_row(r, read_ht) for r in pks] == want
        assert pt._read_op.multi_get(pks, read_ht) == want
        assert pt.multi_read("t1", pks, read_ht=read_ht) == \
            jt.multi_read("t1", pks, read_ht=read_ht)
        assert any(w is not None for w in want) or read_ht == points[0]
    # pk_eq through Tablet.read, with a projection
    for r in pks[:6]:
        kw = dict(pk_eq=r, read_ht=points[-1], columns=("s", "k"))
        assert_same_cpu_response(pt.read(ReadRequest("t1", **kw)),
                                 jt.read(JReq("t1", **kw)), str(r))


@pytest.mark.parametrize("state", STATES)
def test_prefix_scans_match_reference(tmp_path, state):
    jt, pt, points, _ = _build(str(tmp_path), "range", state)
    for read_ht in points[::2]:
        for pref, limit in (({"k": 4}, None), ({"k": 7, "r": 0}, None),
                            ({"k": 11}, 2), ({"k": 999}, None)):
            kw = dict(pk_prefix=pref, read_ht=read_ht, limit=limit)
            assert_same_cpu_response(pt.read(ReadRequest("t1", **kw)),
                                     jt.read(JReq("t1", **kw)), str(pref))


_ENUM = {
    "eq": ("cmp", "eq", ("col", 0), ("const", 7)),
    "in": ("in", ("col", 0), [1, 3, 3, 28, 10 ** 15, -5]),
    "between": ("between", ("col", 0), ("const", 4), ("const", 19)),
    "interval_residual": ("and", ("and", ("cmp", "ge", ("col", 0),
                                          ("const", 2.5)),
                                  ("cmp", "le", ("col", 0), ("const", 25))),
                          ("cmp", "gt", ("col", 3), ("const", 0))),
}


@pytest.mark.parametrize("shape", sorted(_ENUM))
@pytest.mark.parametrize("state", STATES)
def test_enumerated_reads_match_reference(tmp_path, shape, state):
    jt, pt, points, _ = _build(str(tmp_path), "hash", state)
    for read_ht in points[1::3]:
        for limit in (None, 3):
            kw = dict(where=_ENUM[shape], read_ht=read_ht, limit=limit,
                      columns=("k", "v", "n"))
            assert_same_cpu_response(pt.read(ReadRequest("t1", **kw)),
                                     jt.read(JReq("t1", **kw)), shape)


@pytest.mark.parametrize("state", STATES)
def test_read_restarts_inside_the_uncertainty_window(tmp_path, state):
    """Writes 100 ms ahead of a read point lie inside its skew window:
    both packages restart at the same hybrid time (get_row, multi_get,
    a prefix-free interpreted scan), and an explicit read point or
    allow_restart=False never restarts."""
    jt, pt, points, (jphys, pphys) = _build(str(tmp_path), "hash", state)
    read_ht = points[-1]
    for phys in (jphys, pphys):
        phys.advance_micros(100_000)
    rng = np.random.default_rng(8)
    write_both(jt, pt, [("upsert", kv_row(rng, 5)),
                        ("upsert", kv_row(rng, 6))])
    if state != "memtable":
        jt.flush()
        pt.flush()
    pks = [{"k": k} for k in (4, 5, 6)]
    jop, pop = jt._read_op, pt._read_op
    with pytest.raises(JRestart) as je:
        jop.multi_get(pks, read_ht, allow_restart=True)
    with pytest.raises(ReadRestartError) as pe:
        pop.multi_get(pks, read_ht, allow_restart=True)
    assert pe.value.restart_ht == je.value.restart_ht > read_ht
    assert pop.multi_get(pks, read_ht) == jop.multi_get(pks, read_ht)
    for op in (jop, pop):
        op._allow_restart = True
    try:
        with pytest.raises(JRestart) as je:
            jop.get_row({"k": 5}, read_ht)
        with pytest.raises(ReadRestartError) as pe:
            pop.get_row({"k": 5}, read_ht)
        assert pe.value.restart_ht == je.value.restart_ht
        assert pop.get_row({"k": 4}, read_ht) == jop.get_row({"k": 4},
                                                             read_ht)
        with pytest.raises(ReadRestartError) as pe:
            pop._execute_cpu(ReadRequest("t1", read_ht=read_ht))
        assert pe.value.restart_ht == je.value.restart_ht
    finally:
        for op in (jop, pop):
            op._allow_restart = False
    # a server-assigned point restarts and sees the new rows
    now = (jphys.now_micros() - 50_000) << 12
    for allow in (None, True):
        got = pt.multi_read("t1", pks, read_ht=now, allow_restart=allow)
        assert got == jt.multi_read("t1", pks, read_ht=now,
                                    allow_restart=allow)
    with flags_set({"max_clock_skew_ms": 10}, {"max_clock_skew_ms": 10}):
        # narrowed window: the new rows are past it, nothing restarts
        assert pop.multi_get(pks, read_ht, allow_restart=True) == \
            jop.multi_get(pks, read_ht, allow_restart=True)


def test_expired_ttl_rows_read_as_absent(tmp_path):
    """A row TTL expires at its write time + ttl: visible before, None
    from the expiry on (memtable and SST alike)."""
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
    rng = np.random.default_rng(1)
    write_both(jt, pt, [("upsert", kv_row(rng, 1, null_frac=0))], 5)
    t0 = jphys.now_micros()
    for flush in (False, True):
        if flush:
            jt.flush()
            pt.flush()
        for dt in (0, 4_999, 5_000, 9_000):
            read_ht = (t0 + dt) << 12
            got = pt._read_op.get_row({"k": 1}, read_ht)
            assert got == jt._read_op.get_row({"k": 1}, read_ht)
            assert (got is None) == (dt >= 5_000)
