"""The port's window functions (yugabyte_db_tpu_torch/ops/window_scan.py)
against the JAX reference on the same seeded lanes: the segment program
(WindowKernel.run, on the CPU) against the reference's jitted kernel and
against the numpy twin window_cpu, every op head, nulls, one row, one
segment, every row its own segment, random segments and peers, int64
near its extremes and float min/max with NaN; integer lanes bit for bit
wherever the value is not NULL.  serve_window_rows gives the reference's
row dicts and its typed refusal reasons."""
import copy

import numpy as np
import pytest
import torch

from yugabyte_db_tpu.ops import window_scan as jws
from yugabyte_db_tpu_torch.ops import window_scan as pws
from tests.torch_parity import (WINDOW_CASES, WINDOW_ITEMS, window_case,
                                window_rows)


def _same_lane(got, want, what, live=None):
    """Bit for bit (floats: equal with NaN where the reference has NaN)
    over the rows in `live`."""
    got, want = np.asarray(got), np.asarray(want)
    if live is not None:
        got, want = got[live], want[live]
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, want.dtype)
    if got.dtype.kind == "f":
        # floats: equal values, NaN where the reference has NaN
        assert np.array_equal(got, want, equal_nan=True), what
    else:
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), what


def _port_run(case):
    ops, seg, peer, values, nulls = window_case(case)
    return pws.WindowKernel(device="cpu").run(ops, seg, peer, values, nulls)


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_window_program_matches_reference(case):
    ops, seg, peer, values, nulls = window_case(case)
    want = jws.WindowKernel().run(ops, seg, peer, values, nulls)
    got = _port_run(case)
    assert len(got) == len(want) == len(ops)
    for op, (gv, gm), (wv, wm) in zip(ops, got, want):
        _same_lane(gm, wm, f"{case} {op} nulls")
        # a value under a null mask is no part of the answer: the
        # reference reads its pow2 padding there (a lead past the last
        # row), the port, which does not pad, the last row
        _same_lane(gv, wv, f"{case} {op} values", live=~wm)


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_window_program_matches_numpy_twin(case):
    ops, seg, peer, values, nulls = window_case(case)
    twin = pws.window_cpu(ops, seg, peer, values, nulls)
    for op, (gv, gm), (tv, tm) in zip(ops, _port_run(case), twin):
        assert np.array_equal(gm, tm), (case, op)
        # the twin keeps rank heads in int64, the program in int32 (as
        # the reference's); the values are equal where not NULL
        assert np.array_equal(gv.astype(tv.dtype)[~tm], tv[~tm],
                              equal_nan=True), (case, op)


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_numpy_twin_matches_reference_twin(case):
    ops, seg, peer, values, nulls = window_case(case)
    for op, (pv, pm), (jv, jm) in zip(
            ops, pws.window_cpu(ops, seg, peer, values, nulls),
            jws.window_cpu(ops, seg, peer, values, nulls)):
        _same_lane(pm, jm, f"{case} {op} nulls")
        _same_lane(pv, jv, f"{case} {op} values")


def test_window_program_counts_launches():
    before = pws.WINDOW_STATS["launches"]
    _port_run("random")
    assert pws.WINDOW_STATS["launches"] == before + 1


def test_seg_scan_extreme_is_the_segmented_prefix_extreme():
    rng = np.random.default_rng(4)
    for n in (1, 2, 3, 7, 64, 1000):
        v = rng.integers(-50, 50, n)
        seg_id = np.cumsum(rng.random(n) < .2)
        got = pws._seg_scan_extreme(torch.from_numpy(v),
                                    torch.from_numpy(seg_id), True).numpy()
        want = np.array([v[(seg_id == seg_id[i]) & (np.arange(n) <= i)].min()
                         for i in range(n)])
        assert np.array_equal(got, want), n


def _wires():
    W = pws.WindowWire
    return {
        "partitioned_ordered": W(("flag", "status"), (("day", False),),
                                 WINDOW_ITEMS),
        "descending": W(("flag",), (("day", True), ("qty", False)),
                        WINDOW_ITEMS),
        "whole_partition": W(("status",), (), WINDOW_ITEMS),
        "no_partition": W((), (("price", False),), WINDOW_ITEMS),
    }


@pytest.mark.parametrize("shape", sorted(_wires()))
def test_serve_window_rows_matches_reference(shape):
    pwire = _wires()[shape]
    jwire = jws.WindowWire(pwire.partition_by, pwire.order_by, pwire.items)
    rows = window_rows()
    got, want = copy.deepcopy(rows), copy.deepcopy(rows)
    pws.serve_window_rows(pwire, got, pws.WindowKernel(device="cpu"))
    jws.serve_window_rows(jwire, want)
    assert got == want
    assert [[type(v) for v in r.values()] for r in got] == \
        [[type(v) for v in r.values()] for r in want]
    assert list(got[0]) == list(want[0])          # key order too


def _refusal(case):
    rows = window_rows(200)
    items = (("row_number", 0, None, "rn"),)
    part = ("flag",)
    if case == "null_key":
        rows[5]["flag"] = None
    elif case == "nan_key":
        for r in rows:
            r["flag"] = float(r["qty"])
        rows[3]["flag"] = float("nan")
    elif case == "mixed_key":
        rows[7]["flag"] = 3
    elif case == "float_sum":
        items = (("sum", 1, "price", "s"),)
    elif case == "string_lag":
        items = (("lag", 1, "flag", "prev"),)
    elif case == "unknown_func":
        items = (("ntile", 4, None, "t"),)
    elif case == "lag_without_value":
        items = (("lag", 1, None, "prev"),)
    elif case == "negative_offset":
        items = (("lead", -1, "qty", "nxt"),)
    elif case == "sum_without_value":
        items = (("sum", 1, None, "s"),)
    return rows, part, items


@pytest.mark.parametrize("case", [
    "null_key", "nan_key", "mixed_key", "float_sum", "string_lag",
    "unknown_func", "lag_without_value", "negative_offset",
    "sum_without_value"])
def test_serve_window_refusals_match_reference(case):
    rows, part, items = _refusal(case)
    order = (("day", False),)
    with pytest.raises(jws.WindowIneligible) as je:
        jws.serve_window_rows(jws.WindowWire(part, order, items),
                              copy.deepcopy(rows))
    with pytest.raises(pws.WindowIneligible) as pe:
        pws.serve_window_rows(pws.WindowWire(part, order, items),
                              copy.deepcopy(rows),
                              pws.WindowKernel(device="cpu"))
    assert pe.value.reason == je.value.reason
    assert pe.value.detail == je.value.detail


def test_serve_window_rows_of_no_rows_is_a_no_op():
    rows = []
    pws.serve_window_rows(pws.WindowWire(("a",), (), WINDOW_ITEMS), rows,
                          pws.WindowKernel(device="cpu"))
    assert rows == []


def test_window_kernel_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yugabyte_db_tpu_torch.device import DeviceUnavailable
    with pytest.raises(DeviceUnavailable):
        pws.WindowKernel()
    with pytest.raises(DeviceUnavailable):
        pws.serve_window_rows(pws.WindowWire((), (), WINDOW_ITEMS[:1]),
                              window_rows(10))
