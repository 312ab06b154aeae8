#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (yugabyte_db_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs its main
path on the card.

    python3 chip_smoke.py [--seed 0]

Phases (any failed check raises and the script exits non-zero):
  1. build the hand kernels from the sources in this checkout (K1, K2:
     nvcc for sm_90a, all sources at once; K3: Triton at first launch)
     and print the card's name and power limit;
  2. hold every kernel against its plain PyTorch version on the card, on
     the main path's own inputs: K1/K2 on the SF1 columns padded to the
     4096-row grid, K3 on the Q6 and Q1 lanes of the 8,388,608-row
     bucket, in the batch's own dtypes — and time kernel, plain version
     and (where one exists) the one-call PyTorch equivalent with CUDA
     events; print K3's form, registers and spills per signature (K1's
     and K2's come from ptxas in phase 1), and time the grouped K3 on
     Q1's lanes in each of its (form, SUB, warps) choices, rounds
     interleaved (one k3_config line each);
  3. drive the main path at TPC-H SF1 (6,000,000 lineitem rows, one
     tablet): generate_lineitem -> TableCodec.bulk_blocks(262144-row
     blocks) -> build_batch(device="cuda") -> ScanKernel.run for Q6 and
     Q1 on the exact route (MVCC modes none and visible) and the hand
     route, plus q6_scan and grouped_sum; every answer is held against
     numpy_reference, and every kernel's launch count must rise;
  4. profile each route of ScanKernel.run (exact and hand, Q6 and Q1):
     wall time per query on the host clock (profiler off), device-busy
     time per query from torch.profiler, the device's idle share and the
     kernels that take most device time — one JSON line per route;
  5. print the kernels line, then the device line last.

It imports nothing of JAX: the port stands alone.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

SF = 1.0                         # TPC-H scale: 6,000,000 lineitem rows
PROFILE_ITERS = 10               # queries per timed and profiled window
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
SWEEP_ROUNDS = 5                 # interleaved timing rounds per K3 config
#: K3 grouped (form, SUB, num_warps) configs timed beside the chosen one
K3_GROUPED_CONFIGS = [("unrolled", 256, 4), ("unrolled", 128, 4),
                      ("tile", 128, 4), ("tile", 128, 8), ("tile", 256, 4),
                      ("tile", 256, 8), ("tile", 512, 8)]


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0].strip()


def cuda_ms(torch, fn, reps: int, warmup: int = 3, rounds: int = 5) -> float:
    """Milliseconds per call of fn() on the card: CUDA events around
    `reps` back-to-back calls (so the host's enqueue overlaps the
    device's work), divided by `reps`; the median of `rounds` such
    windows."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(bytes_moved: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and f32
    operations over the f32 peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(torch, a, b) -> float:
    a = torch.nan_to_num(a.double(), nan=0.0)
    b = torch.nan_to_num(b.double(), nan=0.0)
    return float((a - b).abs().max()) if a.numel() else 0.0


def same_partials(torch, got, want, what: str, exact: bool) -> float:
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != "
          f"{tuple(want.shape)}")
    check(bool(torch.equal(torch.isnan(got), torch.isnan(want))),
          f"{what}: NaN pattern differs")
    if exact:
        check(bool(torch.equal(torch.nan_to_num(got),
                               torch.nan_to_num(want))),
              f"{what}: not exact")
    else:
        # f32 sums over <= 4096 rows in another order: rtol 2e-4 (the
        # reference's tolerance), with an absolute floor for ~0 partials
        tol = 2e-4 * want.abs() + 1e-3
        check(bool(((got - want).abs() <= tol).all()),
              f"{what}: outside rtol 2e-4 (max abs err "
              f"{max_abs(torch, got, want)})")
    return max_abs(torch, got, want)


def expr_nodes(node) -> int:
    if node is None:
        return 0
    if node[0] in ("col", "const"):
        return 0
    if node[0] == "in":
        return 1 + expr_nodes(node[1]) + len(node[2])
    return 1 + sum(expr_nodes(c) for c in node[1:]
                   if isinstance(c, (tuple, list)) and c
                   and isinstance(c[0], str))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np

    from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops import hand_scan as hs
    from yugabyte_db_tpu_torch.ops.device_batch import build_batch
    from yugabyte_db_tpu_torch.ops.scan import ScanKernel
    from yugabyte_db_tpu_torch.utils import flags
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    reps = 20                 # launches per timing window

    # --- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    hs.build_cuda_kernels(verbose=True)
    print(f"[build] nvcc K1+K2 {time.perf_counter() - t0:.3f} s")
    card = card_line()
    print(card)

    # --- main-path data (made before phase 2: its inputs are the path's)
    t0 = time.perf_counter()
    data = tpch.generate_lineitem(SF, seed=args.seed)
    n = len(data["rowid"])
    t1 = time.perf_counter()
    blocks = TableCodec(tpch.lineitem_info()).bulk_blocks(
        data, HybridTime(1 << 40), block_rows=262144)
    t2 = time.perf_counter()
    batch = build_batch(blocks, tpch.TPCH_Q1.columns, device="cuda")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(json.dumps({"load": {
        "rows": n, "blocks": len(blocks), "bucket": batch.padded_rows,
        "generate_s": t1 - t0, "bulk_blocks_s": t2 - t1,
        "build_batch_s": t3 - t2}}))

    padded = ((n + hs.BLOCK_ROWS - 1) // hs.BLOCK_ROWS) * hs.BLOCK_ROWS
    grid = padded // hs.BLOCK_ROWS

    def lane(a):
        out = np.zeros(padded, np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(dev)

    qty, price, disc, ship = (lane(data[c]) for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_shipdate"))
    valid = lane(np.ones(n, np.float32))
    scalars = torch.tensor([tpch._D1994, tpch._D1995, 0.05, 0.07, 24.0],
                           dtype=torch.float32, device=dev)
    gids = lane(data["l_returnflag"] + 3 * data["l_linestatus"])
    q1mask = lane((data["l_shipdate"] <= tpch._Q1_CUT).astype(np.float32))
    kernels = []

    # --- phase 2: every kernel against its plain version ----------------
    k1_args = (qty, price, disc, ship, valid, scalars)
    got = hs.q6_scan_kernel(*k1_args)
    want = hs.q6_scan_plain(*k1_args)
    torch.cuda.synchronize()
    err = same_partials(torch, got[0], want[0], "K1 sums", exact=False)
    same_partials(torch, got[1], want[1], "K1 counts", exact=True)
    bms, bby = bound(5 * 4 * padded + 2 * 4 * grid + 20, 10 * padded)
    kernels.append(dict(
        name="q6_scan", route="cuda",
        source="yugabyte_db_tpu_torch/csrc/q6_scan.cu",
        replaces="yugabyte_db_tpu/ops/pallas_scan.py:54",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: hs.q6_scan_kernel(*k1_args), reps),
        plain_ms=cuda_ms(torch, lambda: hs.q6_scan_plain(*k1_args), reps),
        bound_ms=bms, bound_by=bby, library_ms=None))

    G = 6
    k2_args = (gids, qty, q1mask, G)
    got = hs.grouped_sum_kernel(*k2_args)
    want = hs.grouped_sum_plain(*k2_args)
    torch.cuda.synchronize()
    err = same_partials(torch, got, want, "K2 partials", exact=False)
    gid_i64 = gids.to(torch.int64)
    vm = qty * q1mask
    bms, bby = bound(3 * 4 * padded + 4 * grid * G, 2 * padded)
    kernels.append(dict(
        name="grouped_sum", route="cuda",
        source="yugabyte_db_tpu_torch/csrc/grouped_sum.cu",
        replaces="yugabyte_db_tpu/ops/pallas_scan.py:137",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: hs.grouped_sum_kernel(*k2_args), reps),
        plain_ms=cuda_ms(torch, lambda: hs.grouped_sum_plain(*k2_args),
                         reps),
        bound_ms=bms, bound_by=bby,
        # one PyTorch call for the same grouped sum (over the whole
        # column, on the pre-masked values): index_add_
        library_ms=cuda_ms(torch, lambda: torch.zeros(
            G, dtype=torch.float32, device=dev).index_add_(0, gid_i64, vm),
            reps)))

    probe = ScanKernel(device="cuda")

    def k3_check(entry, call, what):
        got = entry(*call)
        want = entry.plain(*call)
        torch.cuda.synchronize()
        err = 0.0
        for i, ((op, _), g_, w_) in enumerate(zip(
                list(entry.aggs) + [("count", None)], got, want)):
            err = max(err, same_partials(
                torch, g_, w_, f"K3 {what} output {i} ({op})",
                exact=op != "sum"))
        return err

    def k3_config_sweep(entry, call):
        """K3's grouped (form, SUB, warps) choices on the main path's
        lanes, each checked against the plain version, then timed in
        interleaved rounds so that every config sees the same card
        state: one k3_config line each, with the ms of every round."""
        runs = []
        for cfg in [entry.config] + [c for c in K3_GROUPED_CONFIGS
                                     if c != entry.config]:
            k = hs.GenericScan(entry.where, entry.aggs, entry.group_cols,
                               entry.G, entry.col_order, entry.null_order,
                               entry.n_consts)
            k.config = cfg
            k3_check(k, call, f"{cfg}")
            runs.append((k, []))
        for _ in range(SWEEP_ROUNDS):
            for k, ms in runs:
                ms.append(cuda_ms(torch, lambda k=k: k.launch(*call), reps))
        for k, ms in runs:
            print(json.dumps({"k3_config": k.config,
                              "chosen": k.config == entry.config,
                              **k.compiled_stats(), "ms_rounds": ms,
                              "ms_median": statistics.median(ms)}))

    for q in (tpch.TPCH_Q6, tpch.TPCH_Q1):
        entry, call = probe.hand_scan_plan(batch, q.where, q.aggs, q.group)
        err = k3_check(entry, call, q.name)
        print(json.dumps({"k3": q.name, **entry.compiled_stats()}))
        # K3 reads every lane once in its own dtype (the batch's: int32,
        # f32, bool), so the bound counts each at its element size
        row_bytes = sum(t.element_size()
                        for t in list(call[1]) + list(call[2]) + [call[3]])
        n_out = len(entry.aggs) + 1
        gw = q.group.num_groups if q.group else 1
        bucket = batch.padded_rows
        ops_row = (expr_nodes(q.where) + sum(expr_nodes(a.expr) + 2 * gw
                                             for a in q.aggs) + 2 * gw)
        bms, bby = bound(row_bytes * bucket + 4 * n_out * gw
                         * (bucket // hs.BLOCK_ROWS), ops_row * bucket)
        kernels.append(dict(
            name=f"generic_scan[{q.name}]", route="triton",
            source="yugabyte_db_tpu_torch/ops/hand_scan.py",
            replaces="yugabyte_db_tpu/ops/pallas_scan.py:222",
            max_abs_err=err,
            ms=cuda_ms(torch, lambda: entry.launch(*call), reps),
            plain_ms=cuda_ms(torch, lambda: entry.plain(*call), reps),
            bound_ms=bms, bound_by=bby, library_ms=None))
        if q.group is not None:
            k3_config_sweep(entry, call)
    print("[phase 2] every kernel agrees with its plain version")

    # --- phase 3: the main path -----------------------------------------
    ref_q6 = tpch.numpy_reference(tpch.TPCH_Q6, data)
    ref_q1 = tpch.numpy_reference(tpch.TPCH_Q1, data)
    ht_read = int(blocks[0].ht[0])

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    def rel(a, b):
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)

    def check_q6(out, what):
        r = rel(host(out[0][0]), ref_q6)
        check(r < 1e-5, f"{what}: Q6 relative error {r}")
        return r

    def check_q1(out, what, exact_qty):
        counts = host(out[1])
        for g in range(6):
            qsum, psum, cnt = ref_q1[g]
            check(int(counts[g]) == cnt, f"{what}: Q1 count g{g}")
            check(int(host(out[0][4])[g]) == cnt,
                  f"{what}: Q1 count(*) g{g}")
            got_q = float(host(out[0][0])[g])
            if exact_qty:
                check(got_q == qsum, f"{what}: Q1 qty sum g{g} not exact")
            else:
                check(rel(got_q, qsum) < 1e-5, f"{what}: Q1 qty sum g{g}")
            check(rel(host(out[0][1])[g], psum) < 1e-5,
                  f"{what}: Q1 price sum g{g}")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    hs.reset_launches()
    kern = ScanKernel(device="cuda")
    rates = {}
    Q6, Q1 = tpch.TPCH_Q6, tpch.TPCH_Q1
    for rnd in range(2):       # second round: warm timings
        out, t = timed(lambda: kern.run(batch, Q6.where, Q6.aggs))
        check_q6(out, "exact Q6")
        rates["exact_q6"] = n / t
        out, t = timed(lambda: kern.run(batch, Q6.where, Q6.aggs,
                                        read_ht=ht_read))
        check_q6(out, "exact Q6 (visible)")
        rates["exact_q6_visible"] = n / t
        out, t = timed(lambda: kern.run(batch, Q1.where, Q1.aggs, Q1.group))
        check_q1(out, "exact Q1", exact_qty=True)
        rates["exact_q1"] = n / t
    with flags.overridden("hand_scan_enabled", True):
        for rnd in range(2):
            out, t = timed(lambda: kern.run(batch, Q6.where, Q6.aggs))
            check(out[2] is None, "hand route did not serve Q6")
            check_q6(out, "hand Q6")
            rates["hand_q6"] = n / t
            out, t = timed(lambda: kern.run(batch, Q1.where, Q1.aggs,
                                            Q1.group))
            check(out[2] is None, "hand route did not serve Q1")
            check_q1(out, "hand Q1", exact_qty=True)
            rates["hand_q1"] = n / t
    for rnd in range(2):
        (rev, cnt), t = timed(lambda: hs.q6_scan(
            data["l_quantity"], data["l_extendedprice"], data["l_discount"],
            data["l_shipdate"], tpch._D1994, tpch._D1995, 0.05, 0.07, 24.0,
            device="cuda"))
        check(rel(rev, ref_q6) < 1e-5, f"q6_scan revenue {rev} vs {ref_q6}")
        rates["q6_scan_host_wrapper"] = n / t
        sums, t = timed(lambda: hs.grouped_sum(
            data["l_returnflag"] + 3 * data["l_linestatus"],
            data["l_quantity"], data["l_shipdate"] <= tpch._Q1_CUT, 6,
            device="cuda"))
        for g in range(6):
            check(rel(sums[g], ref_q1[g][0]) < 1e-5, f"grouped_sum g{g}")
        rates["grouped_sum_host_wrapper"] = n / t
    launches = dict(hs.LAUNCHES)
    per_query = {}
    for key, e in kern._cache.items():
        if key[0] == "hand":
            per_query[f"generic_scan[{'q6' if e.G is None else 'q1'}]"] = \
                e.launches
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the main path: {launches}")
    check(not kern.hand_scan_refusals,
          f"hand route refused: {kern.hand_scan_refusals}")
    print(f"[phase 3] main path OK; launches {launches}")
    for r, v in rates.items():
        print(f"[rate] {r}: {v:.1f} rows/s ({card})")

    # --- phase 4: where the time goes, per route --------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for route in ("exact", "hand"):
        with flags.overridden("hand_scan_enabled", route == "hand"):
            for q in (Q6, Q1):
                def run():
                    return kern.run(batch, q.where, q.aggs, q.group)
                run()                           # warm (built above)
                torch.cuda.synchronize()
                t = time.perf_counter()         # wall: profiler off
                for _ in range(PROFILE_ITERS):
                    run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) / PROFILE_ITERS
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(PROFILE_ITERS):
                        run()
                    torch.cuda.synchronize()
                rows, busy_us = [], 0.0
                for e in prof.key_averages():
                    # device-side activities only (kernels, copies): an
                    # aten op's row repeats its kernels' time
                    if e.device_type != DeviceType.CUDA:
                        continue
                    us = getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
                    if us > 0:
                        busy_us += us
                        rows.append((us / PROFILE_ITERS, e.key,
                                     e.count // PROFILE_ITERS))
                rows.sort(reverse=True)
                busy = busy_us / PROFILE_ITERS / 1e6
                print(json.dumps({"profile": f"{route}_{q.name}",
                                  "card": card,
                                  "wall_ms": wall * 1e3,
                                  "device_busy_ms": busy * 1e3 if busy
                                  else None,
                                  "idle_share": 1.0 - busy / wall if busy
                                  else None,
                                  "rows_per_s": n / wall,
                                  "top_kernels": [
                                      {"name": k[:80], "us_per_query": us,
                                       "launches_per_query": c}
                                      for us, k, c in rows[:6]]}))
    check(not kern.hand_scan_refusals,
          f"hand route refused: {kern.hand_scan_refusals}")

    # --- phase 5: report -------------------------------------------------
    for k in kernels:
        k["launches"] = launches.get(k["name"], per_query.get(k["name"], 0))
        check(k["launches"] > 0, f"{k['name']} launched 0 times")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
