#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (yugabyte_db_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs its main
path on the card.

    python3 chip_smoke.py [--seed 0]

Phases (any failed check raises and the script exits non-zero):
  1. build the hand kernels from the sources in this checkout (K1, K2
     and the join probe: nvcc for sm_90a, all sources at once; K3:
     Triton at first launch) and print the card's name and power limit;
  2. hold every kernel against its plain PyTorch version on the card, on
     the main path's own inputs: K1/K2 on the SF1 columns padded to the
     4096-row grid, K3 on the Q6 and Q1 lanes of the 8,388,608-row
     bucket and of the streamed scan's last chunk in its 1,048,576-row
     bucket, in the batch's own dtypes — and time kernel, plain version
     and (where one exists) the one-call PyTorch equivalent with CUDA
     events; print K3's form, registers and spills per signature (K1's
     and K2's come from ptxas in phase 1), and time the grouped K3 on
     Q1's lanes in each of its (form, SUB, warps) choices, rounds
     interleaved (one k3_config line each); the join probe kernel
     against the plain probe over the packed table at Q3's and Q5's SF1
     shapes (Q3 stage 0: l_orderkey of the 8,388,608-row bucket against
     the 685,446 orders Q3 ships, 2^21 slots; Q3 stage 1: the gathered
     o_custkey lane against Q3's customers, 2^16 slots; Q5 stage 0:
     every row's l_orderkey against the 214,256 orders of 1994, 2^19
     slots), in each slot layout, midx equal on every live row (one
     join_probe line per stage: walk lengths, the layout's bytes, warm
     ms of each layout, the runtime's layout cold, with no live row and
     on an empty table, plain and yardstick ms, the bound at the bytes a
     slot needs and at the three-lane table's 13 bytes a slot);
  3. drive the main path at TPC-H SF1 (6,000,000 lineitem rows, one
     tablet): generate_lineitem -> TableCodec.bulk_blocks(262144-row
     blocks) -> build_batch(device="cuda") -> ScanKernel.run for Q6 and
     Q1 on the exact route (MVCC modes none and visible) and the hand
     route, plus q6_scan and grouped_sum; then the tablet's other read
     shapes at the same scale:
       dedup   an update overlay (every 10th rowid's quantity and price,
               at ht2) and tombstones (every 100th rowid, at ht3) over
               the bulk load; Q6 and Q1 at read points below ht2,
               between ht2 and ht3, and above ht3;
       hash    Q1's aggregates GROUP BY l_shipdate (HashGroupSpec);
       dict    Q1 over the string-keyed lineitem (flag columns as
               STRING), monolithic and through streaming_scan_aggregate;
       stream  Q6 and Q1 through streaming_scan_aggregate: on the hand
               route with no read point (K3 per chunk; its launch count
               must rise) and on the exact route at a read point;
     every answer is held against its numpy reference (and each streamed
     answer against the monolithic one), and every scan kernel's launch
     count must rise; a `baseline` line per query times the host
     baseline (ops/cpu_scan.py cpu_scan_aggregate over the SF1 blocks)
     beside the exact device route, paired round by round;
  4. profile each route (exact and hand, Q6 and Q1, then dedup, hash,
     dict and the streamed routes): wall time per query on the host
     clock (profiler off), device-busy time per query from
     torch.profiler, the device's idle share and the activities that
     take most device time — one JSON line per route, counted between
     two marker kernels with an uncounted query on each side; a span
     that lost device activity (none at all, fewer hand-kernel
     activities than launches, a count that is not a whole multiple of
     the queries) fails the run;
  5. compact a 100-SST TPC-H SF1 lineitem tablet (SSTs of
     60,000 rows, each rewriting a quarter of its predecessor's rows,
     plus a tombstone SST; history cutoff at SST 50's hybrid time; the
     reference's default flags) with the device backend on the card and
     the baseline backend on the host, each on a copy of the one store:
     both outputs, read back, must be equal row for row and equal a
     numpy oracle of the retention rule (doc keys encoded here from the
     rowid, apart from the port's codec); chunk_merge_kernel on a real
     524,288-row frontier must equal its CPU run; one `compaction` line
     per backend (MB/s, stage split), a `compaction_profile` line from
     torch.profiler over a third compaction, and a `compaction_program`
     line for chunk_merge_kernel (ms per call against its bound);
  6. the tablet read seam at SF1, SSTs under build/tablet_smoke/
     (removed at the end): LineitemTable(num_tablets=8) (hash,
     262,144-row blocks) and a one-tablet LineitemTable loaded through
     Tablet.bulk_load; Q6 and Q1 through Tablet.read on every tablet
     (combined by combine_agg_partials) and on the one tablet (streamed,
     at least 3 chunks), on the exact and the hand route (K3 in MVCC
     mode visible; its launches must rise); a BypassSession over the
     eight tablets at the reads' read point, prefilter on and off, bit
     for bit equal to the reads with no key rebuilds; a range-sharded
     tablet's Q6 AND rowid < n/8 with zone_map_pruning on (blocks
     pruned) and off, equal answers; every answer against numpy; one
     `tablet_load` line, one `tablet` line (rows/s, wall, path, chunks,
     blocks pruned, prefilter rows in/kept) and one `profile` line per
     route;
  7. FK-equijoins and fused plans at SF1, SSTs under build/join_smoke/
     (removed at the end): a Tablet over lineitem_join_info() bulk-loads
     lineitem with l_orderkey (92 blocks of 65,536 rows) beside the
     orders (1,500,000) and customer (150,000) tables; the default build
     cap's typed refusal is printed once, then with join_max_build_slots
     2^24 q3ish, q3, q5 and q10 run through Tablet.read on the streamed
     route (6 chunks) and the monolithic route (one 8,388,608-row
     bucket) and through a BypassSession: counts exact and revenue
     within 1e-5 against numpy, streamed = monolithic within 1e-9, the
     bypass bit for bit equal to the tablet read, the probe kernel
     launched once per stage and chunk; the TPC-H registry walked (scan
     entries served on the exact and hand routes, inexpressible ones
     printed with their reasons); one `join` and one `profile` line per
     query and route;
  8. row reads and server-side windows at SF1, SSTs under
     build/rows_smoke/ (removed at the end): a hash tablet and a range
     tablet through Tablet.bulk_load; Q6's predicate as a row read
     (rowid, l_extendedprice, l_discount, l_shipdate) streamed (>= 3
     chunks) and monolithic, `limit` 1000 (the pipeline closes early),
     the range tablet's rowid < n/8 AND Q6 with zone_map_pruning on and
     off, an enumerable rowid read (batched point gets on the host), a
     WindowWire over the Q6 rows (PARTITION BY l_returnflag,
     l_linestatus ORDER BY l_shipdate: ranks, cumulative and
     whole-partition sums, min/max, lag/lead, count) equal to the numpy
     twin window_cpu, its three typed refusals, and an overlay load at
     ht2 read below and above it (the dedup route); every row set
     against numpy; one `rows` line per route (rows out, wall, kernel
     and gather s, chunks, blocks pruned), a `window` line (host sort,
     the segment program's device ms by CUDA events against its byte
     bound, host scatter) and one `profile` line per route;
  9. vector search at bench.py's configurations (200,000 x 128: 256
     lists, 5 iterations, nprobe 64; 1,000,000 x 768: 1024 lists, 2
     iterations, nprobe 256; k-means sample 50,000; base made on the
     card from the seed; queries base[:64] + 0.001; k 10): the two-stage
     IVF built on the card, exact_search on the card (each query's top-1
     its own row), the IVF search (qps, recall@10 against an f32 exact
     search on 16 queries, no more than 0.02 below the same search's in
     f32 on the CPU, the numpy twin's beside it; device ms per batch
     against its bound, peak device memory), at the
     first configuration IvfFlatIndex's probe and full-scan routes and a
     registry save/load that searches to the same ids; `vector_program`
     lines (the two-stage search, exact_search, a k-means iteration);
     HNSW at 20,000 x 128 through the registry on the host, built in a
     process of its own beside phases 8 and 9 (`hnsw` line);
  10. the multi-device tablet mesh (BASELINE.json config 3 at SF1):
     phase 6's eight hash tablets, their SST blocks in a sharded batch
     on an 8 x 1 and a 4 x 2 mesh (slot s on card s mod the card count:
     all on one card here), Q6 and Q1 through distributed_scan_aggregate
     with no read point and at the tablets' read point, against numpy
     and against the host combine of Tablet.read (1e-9), the meshes bit
     for bit, a dynamic-scale Q6 (the cross-shard max pass); the bypass
     mesh combine over one tablet, and over eight (the reference's
     ValueError on fewer than eight cards); sharded_exact_search over
     phase 9's 1M x 768 base in 8 slots against exact_search, and
     sharded_ann_search over 4 two-stage IVF shards of 50,000 x 128
     (every list probed, recall@10 >= 0.9); one `mesh` line per query
     and mesh (wall, rows/s, batch build, slot programs and device
     activities per query, the combine's ms, host syncs before the
     rescale, bytes per card), a `profile` line per query, `mesh_vector`
     and `mesh_ann` lines;
  11. the write path (htap_phase and ycsb_job, the latter in a process of
     its own beside the former): (a) TPC-H SF1 lineitem in one tablet
     (262,144-row blocks) takes the refresh functions (TPC-H v3.0.1
     §2.26: RF1 inserts SF x 1500 orders of 1-7 lineitems, one write
     request each; RF2 deletes SF x 1500 orders' lineitems) through
     Tablet.apply_write; Q6 and Q1 on the card over SST + memtable
     (MVCC mode dedup), after flush() and a second RF1/RF2 over 2 SSTs +
     memtable, and after flush() and Tablet.compact() on the card on the
     exact route and through K3; every answer against numpy over the
     live rows (counts and l_quantity sums exact, revenue 1e-5, K3 2e-4)
     and after each step get_row of 1,000 inserted, 1,000 deleted and
     1,000 untouched rowids, and the deleted rows read back at a read
     point before RF2; `htap_load`, `htap_refresh`, one `htap` line per
     query and step (first read after the writes, warm wall, device
     busy and idle share from a `profile` window), `flush` and
     `htap_compaction` lines; (b) BASELINE.json config 1: YCSB
     workloads A, B, C (1 and 32 clients) and E, 50,000 operations each,
     on a 1,000,000-row usertable (10 fields x 100 bytes) with an 8 MiB
     memtable (the async flush on the apply path), every updated key
     read back; 100,000 upserts with a row TTL (half expiring before the
     history cutoff), flush(), Tablet.compact() through _compact_rows
     (merge_gc_split on the card), its output equal entry for entry to
     the baseline backend's CPU feed on a copy and merge_gc_split's
     order and keep equal to its CPU run; `ycsb_load`, `point` (ops/s,
     p50 and p99 µs), `flush_apply` and `row_compaction` lines;
  12. the tablet's vector index and the grouped spill tail
     (vector_tablet_phase, spill_phase): (a) BASELINE.json config 5
     (1,000,000 x 768, ivfflat, 1024 lists, 2 k-means iterations,
     bench.py:2990-2992) in one hash tablet through Tablet.bulk_load,
     build_vector_index, 64 single-query vector_search calls (k 10,
     nprobe 256; each the index's own search, recall@10 against
     exact_search on the card), 2,000 inserts, 1,000 upserts and 500
     deletes through apply_write (each written vector its own top hit,
     no deleted id returned, recall within 0.02, no rebuild due),
     flush, a new Tablet and bootstrap_vector_indexes (the index
     loaded, not rebuilt: full size, the writes in delta and dead;
     every answer as before the restart); a 5,000 x 128 tablet: the
     no-index fallback, HNSW (m 16, ef_construction 100), and a rebuild
     that folds 600 upserts; one `vector_tablet` line per tablet; (b)
     the string Q1 over the string-flag lineitem (SF 0.2: the
     interpreted tail's rows are cut) in one tablet with a 4-slot
     DictGroupSpec (6 groups: 3 spill) on the streamed and the
     monolithic route, against numpy, one spill merge each (one `spill`
     line per route: wall, rows on the interpreted tail);
  13. the document store and encryption at rest (docs_phase):
     bench.py doc_scan_bench's 1,000,000 documents (models/docbench.py,
     65,536-row blocks) bulk-loaded into one tablet with shredding on;
     the bench query (WHERE CAST(doc->>'qty' AS bigint) = 7; SUM, COUNT,
     MAX(doc->>'tag')) on the exact route, warm and timed (median of 5)
     with a `profile` window, its warm read served from the cached
     batch; the tag, nested region, IS NULL and row-read shapes; K3's
     attempt on two shapes (launches or typed refusals); the keyless
     bypass bit for bit with the tablet; 20,000 upserts, Tablet.compact()
     on the card (shredded output) and 2,000 get_rows byte for byte; a
     second tablet bulk-loaded under a generated universe key with
     encrypt_data_at_rest on (its cipher printed), answering like the
     first, also after a cold open.  Every card answer is held to the
     interpreted path's over the same SSTs (doc_shred_enabled off),
     computed in spawned CPU processes on hard-linked checkpoints; one
     `docs` line per step;
  14. print the kernels line (launches per path: phase 3's scan, phase
     6's tablet reads, phase 7's joins, phases 8, 9, 11, 12 and 13; and
     the new paths' plain programs: window program launches, device
     searches, the mesh's slot programs, merge_gc_split, the vector
     tablet's searches, the spill tail's dict-grouped programs and the
     doc scans' exact-route programs), then the device line last.

It imports nothing of JAX: the port stands alone.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SF = 1.0                         # TPC-H scale: 6,000,000 lineitem rows
PROFILE_ITERS = 5                # queries per timed and profiled window
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
SWEEP_ROUNDS = 3                 # interleaved timing rounds per K3 config
STREAM_ITERS = 2                 # streamed queries per timed window (each
                                 # forms every chunk's batch on the host)
PROFILE_MARGIN_S = 0.05          # host time between a profiling window's
                                 # edges and the route's first/last launch
MARKER_KERNEL = "spin_kernel"    # torch.cuda._sleep's kernel: bounds the
MARKER_CYCLES = 1000             # counted span of a profiling window
PROFILE_TRIES = 3                # windows a route may take: a window
#                                  whose record lost a marker or an
#                                  activity is taken again
QUEUE_AHEAD_CYCLES_PER_CALL = 400_000   # the least spin per timed call
                                        # (cuda_ms): the host enqueues ahead
SPIN_CYCLES_PER_S = 1.98e9       # H100 SXM's top SM clock: a spin of c
                                 # cycles lasts at least c / this seconds
#: the device names of each hand kernel's launches (hs.LAUNCHES keys)
HAND_KERNEL_NAMES = {"q6_scan": ("q6_scan_kernel",),
                     "grouped_sum": ("grouped_sum_onehot",
                                     "grouped_sum_histogram"),
                     "generic_scan": ("generic_scan",),
                     "join_probe": ("join_probe_kernel",)}
#: phase 5: profile_compact.py's 100-SST tablet at SF1's full volume
COMPACT_SSTS = 100
COMPACT_ROWS_PER = 60_000        # rows per SST: 100 x 60,000 = SF1
COMPACT_BLOCK_ROWS = 65_536
COMPACT_BASE_US = 1_700_000_000_000_000   # SST i written at +i * 1000 us
COMPACT_FRONTIER = 524_288       # compaction_chunk_rows' default (m_cap)
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


def queued_behind_spin(torch, spin_cycles: int, enqueue, tries: int = 4):
    """Queue enqueue()'s calls behind a spin kernel (torch.cuda._sleep)
    of `spin_cycles`, so that the device runs them without waiting on the
    host, and return what enqueue() returned, (first event, result), once
    the device is done.  The run fails unless, on one of `tries` tries,
    the first event was still pending when enqueue() returned: the spin
    outlasted the host's enqueue.  A host stalled past the spin on a
    shared machine spoils one try, not the run: each retry doubles the
    spin (the first event is recorded behind it, so the window it opens
    does not depend on the spin's length)."""
    spin = spin_cycles
    for _ in range(tries):
        torch.cuda._sleep(spin)
        first, out = enqueue()
        ahead = not first.query()
        torch.cuda.synchronize()
        if ahead:
            return out
        spin *= 2
    check(False, f"the host's enqueue outlasted a {spin_cycles}-cycle "
          f"spin, doubled {tries - 1} times: raise "
          "QUEUE_AHEAD_CYCLES_PER_CALL")


def cuda_ms(torch, fn, reps: int, warmup: int = 3, rounds: int = 5,
            queued: bool = True) -> float:
    """Milliseconds per call of fn() on the card: CUDA events around
    `reps` back-to-back calls, divided by `reps`; the median of `rounds`
    such windows.  With `queued`, each window's calls are queued behind a
    spin (:func:`queued_behind_spin`) of twice the host's least time per
    call in the warm-up, and no less than QUEUE_AHEAD_CYCLES_PER_CALL per
    call, and the spin is checked to outlast the enqueue: the time is the
    device's, not the host's.  A fn that waits on the device inside (the
    plain probe's loop, a host-to-device copy) passes queued=False: its
    windows include the host's time."""
    host_s = []
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    spin = reps * max(QUEUE_AHEAD_CYCLES_PER_CALL,
                      int(2 * min(host_s) * SPIN_CYCLES_PER_S))

    def window():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        return start, (start, end)
    times = []
    for _ in range(rounds):
        if queued:
            start, end = queued_behind_spin(torch, spin, window)
        else:
            _, (start, end) = window()
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


def profile_route(torch, hs, name, card, rows, run, iters,
                  wall=None, stats=None) -> list:
    """One `profile` JSON line for a route: wall ms per query on the
    host clock (profiler off), device-busy ms per query from
    torch.profiler (device activities only: kernels and copies, from
    every thread; host ops are not recorded, which keeps the profiler's
    own host cost out of the window), the idle share and the top device
    activities.  `wall` (s per query) is the caller's own timing of the
    same warm route, taken just before; without it the route is warmed
    and timed here over `iters` queries.

    The profiler keeps only device activities whose timestamps fall
    inside its capture window, and on the card's torch 2.11 it also
    dropped the first device activities of a window opened late in a
    long process (the same ones on every try, so a second window does
    not help).  So the window holds one uncounted query on each side of
    the counted ones, PROFILE_MARGIN_S of host time from each edge, and
    only device activities between two marker kernels (MARKER_KERNEL,
    launched after the leading query and before the trailing one) are
    counted.  Returns what the counted span failed to record, for the
    caller to fail on: a marker missing, no device activity, a hand
    kernel recorded fewer or more times than its launch count rose, or
    a device activity recorded a number of times that is not a whole
    multiple of the queries run (each query launches the same work).  A
    window with such a problem is taken again, up to PROFILE_TRIES
    windows; the earlier windows' problems are printed as
    `retried_window_problems`.  `stats`, when given, receives the device
    activities and busy ms per query."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t_call = time.perf_counter()
    if wall is None:
        run()                               # warm (built above)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / iters

    def window():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            run()                       # leading query: not counted
            torch.cuda.synchronize()
            torch.cuda._sleep(MARKER_CYCLES)
            before = dict(hs.LAUNCHES)
            for _ in range(iters):
                run()
                # one query at a time: a streamed query's worker copies
                # while the previous one drains otherwise
                torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in hs.LAUNCHES.items()}
            torch.cuda._sleep(MARKER_CYCLES)
            run()                       # trailing query: not counted
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        device = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        marks = sorted((e for e in device if MARKER_KERNEL in e.name),
                       key=lambda e: e.time_range.start)
        problems = []
        if len(marks) != 2:
            problems.append(f"{len(marks)} marker kernels recorded, not 2")
            lo, hi = float("-inf"), float("inf")
        else:
            lo, hi = marks[0].time_range.end, marks[1].time_range.start
        per_name: dict = {}
        for e in device:
            if MARKER_KERNEL in e.name or not lo <= e.time_range.start < hi:
                continue
            us_count = per_name.setdefault(e.name, [0.0, 0])
            us_count[0] += e.time_range.elapsed_us()
            us_count[1] += 1
        recorded = {k: 0 for k in launched}
        top, busy_us = [], 0.0
        for key, (us, count) in per_name.items():
            busy_us += us
            top.append((us / iters, key, count / iters))
            if count % iters:
                problems.append(f"{key[:60]} recorded {count} times "
                                f"over {iters} queries")
            for k, device_names in HAND_KERNEL_NAMES.items():
                # CUDA C++ kernels show as (de)mangled signatures, e.g.
                # "void (anonymous namespace)::join_probe_kernel<long>(..)"
                if any(d in key for d in device_names):
                    recorded[k] += count
        if busy_us <= 0:
            problems.append("no device activity recorded")
        if recorded != launched:
            problems.append(f"hand kernels recorded {recorded}, launched "
                            f"{launched}")
        return problems, per_name, top, busy_us

    retried = []
    for attempt in range(PROFILE_TRIES):
        if attempt:
            retried += problems
        problems, per_name, top, busy_us = window()
        if not problems:
            break
    top.sort(reverse=True)
    busy = busy_us / iters / 1e6
    if stats is not None:
        stats["activities_per_query"] = sum(c for _, c in
                                            per_name.values()) / iters
        stats["device_busy_ms"] = busy * 1e3
    print(json.dumps({"profile": name, "card": card, "wall_ms": wall * 1e3,
                      "device_busy_ms": busy * 1e3,
                      "idle_share": 1.0 - busy / wall,
                      "rows_per_s": rows / wall,
                      "top_kernels": [
                          {"name": k[:80], "us_per_query": us,
                           "launches_per_query": c}
                          for us, k, c in top[:6]],
                      "window_problems": problems,
                      "retried_window_problems": retried,
                      "profile_s": time.perf_counter() - t_call}))
    return [f"profile {name}: {p}" for p in problems]


def tablet_read_shapes(torch, np, seed, data, blocks, batch, kern, timed,
                       host, rel, check_q6, check_q1) -> tuple:
    """Phase 3's second half: dedup, hash group, dictionary group and
    the streamed scan at SF1, each held against numpy.  Returns the
    routes phase 4 profiles, name -> (hand flag, run(), iterations), and
    the server of the TPC-H registry's q1 entry."""
    from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops import hand_scan as hs
    from yugabyte_db_tpu_torch.ops import stream_scan as ss
    from yugabyte_db_tpu_torch.ops.device_batch import build_batch
    from yugabyte_db_tpu_torch.ops.grouped_scan import decode_slot_groups
    from yugabyte_db_tpu_torch.ops.scan import HashGroupSpec
    from yugabyte_db_tpu_torch.storage.columnar import ColumnarBlock
    from yugabyte_db_tpu_torch.utils import flags
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    Q6, Q1 = tpch.TPCH_Q6, tpch.TPCH_Q1
    n = len(data["rowid"])
    routes = {}

    # --- dedup: overlay at ht2, tombstones at ht3 -------------------------
    t0 = time.perf_counter()
    ht1 = int(blocks[0].ht[0])
    ht2, ht3 = ht1 + (1 << 12), ht1 + (2 << 12)
    rowid = np.concatenate([b.pk[tpch.ROWID] for b in blocks])
    kh = np.concatenate([b.key_hash for b in blocks])
    up = np.nonzero(rowid % 10 == 0)[0]
    dl = np.nonzero(rowid % 100 == 0)[0]
    rng = np.random.default_rng(seed + 1)
    new_qty = rng.integers(1, 51, len(up)).astype(np.float64)
    new_price = rng.uniform(900, 105000, len(up))
    fixed = {}
    for c in Q1.columns:
        full = np.concatenate([b.fixed[c][0] for b in blocks])
        fixed[c] = (full[up], np.zeros(len(up), bool))
    fixed[tpch.QTY] = (new_qty, fixed[tpch.QTY][1])
    fixed[tpch.EXTPRICE] = (new_price, fixed[tpch.EXTPRICE][1])
    overlay = ColumnarBlock.from_arrays(
        1, kh[up], np.full(len(up), ht2, np.uint64),
        write_id=np.arange(len(up)), fixed=fixed, unique_keys=False)
    tombs = ColumnarBlock.from_arrays(
        1, kh[dl], np.full(len(dl), ht3, np.uint64),
        write_id=np.arange(len(dl)),
        fixed={c: (np.zeros(len(dl), v.dtype), np.ones(len(dl), bool))
               for c, (v, _) in fixed.items()},
        tombstone=np.ones(len(dl), bool), unique_keys=False)
    dbatch = build_batch(list(blocks) + [overlay, tombs], Q1.columns,
                         device="cuda")
    torch.cuda.synchronize()
    check(not dbatch.unique_keys, "dedup batch claims unique keys")
    print(json.dumps({"dedup_load": {
        "rows": dbatch.n_rows, "bucket": dbatch.padded_rows,
        "overlay_rows": len(up), "tombstones": len(dl),
        "build_s": time.perf_counter() - t0}}))
    # the table at each read point: rowid r is row r of `data`
    after_up = dict(data)
    after_up["l_quantity"] = data["l_quantity"].copy()
    after_up["l_extendedprice"] = data["l_extendedprice"].copy()
    after_up["l_quantity"][rowid[up]] = new_qty
    after_up["l_extendedprice"][rowid[up]] = new_price
    keep = np.ones(n, bool)
    keep[rowid[dl]] = False
    views = {"below_ht2": (ht1, data), "between": (ht2, after_up),
             "above_ht3": (ht3 + 1, {k: v[keep]
                                     for k, v in after_up.items()})}
    for label, (read_ht, view) in views.items():
        refs = (tpch.numpy_reference(Q6, view),
                tpch.numpy_reference(Q1, view))
        out, _ = timed(lambda: kern.run(dbatch, Q6.where, Q6.aggs,
                                        read_ht=read_ht))
        check_q6(out, f"dedup Q6 {label}", refs[0])
        out, _ = timed(lambda: kern.run(dbatch, Q1.where, Q1.aggs,
                                        Q1.group, read_ht=read_ht))
        check_q1(out, f"dedup Q1 {label}", True, refs[1])
    check(any(sig[0] != "hand" and sig[3] == "dedup"
              for sig in kern._cache),
          "dedup mode was not selected")
    for q in (Q6, Q1):
        routes[f"dedup_{q.name}"] = (False, lambda q=q: kern.run(
            dbatch, q.where, q.aggs, q.group, read_ht=ht2),
            PROFILE_ITERS)
    print("[phase 3] dedup OK at three read points")

    # --- hash group: Q1's aggregates by l_shipdate -------------------------
    hg = HashGroupSpec(cols=(tpch.SHIPDATE,))
    (outs, counts, _, gvals, n_groups), _ = timed(
        lambda: kern.run(batch, Q1.where, Q1.aggs, hg))
    m = data["l_shipdate"] <= tpch._Q1_CUT
    day = data["l_shipdate"][m]
    days = np.unique(day)
    check(int(host(n_groups)) == len(days),
          f"hash group n_groups {int(host(n_groups))} != {len(days)}")
    counts = host(counts)
    live = counts > 0
    check(np.array_equal(host(gvals[0])[live], days),
          "hash group values differ from numpy's distinct days")
    idx = np.searchsorted(days, day)
    want_cnt = np.bincount(idx, minlength=len(days))
    want_qty = np.bincount(idx, weights=data["l_quantity"][m],
                           minlength=len(days))
    want_price = np.bincount(idx, weights=data["l_extendedprice"][m],
                             minlength=len(days))
    check(np.array_equal(counts[live], want_cnt), "hash group counts")
    check(np.array_equal(np.asarray(outs[0])[live], want_qty),
          "hash group quantity sums not exact")
    err = np.max(np.abs(np.asarray(outs[1])[live] - want_price)
                 / want_price)
    check(err < 1e-5, f"hash group price sums: relative error {err}")
    routes["hash_q1_by_shipdate"] = (False, lambda: kern.run(
        batch, Q1.where, Q1.aggs, hg), PROFILE_ITERS)
    print(f"[phase 3] hash group OK: {len(days)} groups")

    # --- dictionary group: Q1 over the string-keyed lineitem ---------------
    t0 = time.perf_counter()
    sq = tpch.tpch_q1_str()
    sblocks = TableCodec(tpch.lineitem_str_info()).bulk_blocks(
        tpch.lineitem_str_data(data), HybridTime(ht1), block_rows=262144)
    t1 = time.perf_counter()
    sbatch = build_batch(sblocks, sq.columns, device="cuda")
    torch.cuda.synchronize()
    print(json.dumps({"dict_load": {
        "rows": sbatch.n_rows, "blocks": len(sblocks),
        "bulk_blocks_s": t1 - t0,
        "build_batch_s": time.perf_counter() - t1}}))
    ref = tpch.numpy_reference(sq, data)

    def check_dict(outs, counts, spill, dicts, what):
        check(int(host(spill)) == 0, f"{what}: spill {int(host(spill))}")
        vals, cnts, gv = decode_slot_groups(sq.group, dicts, outs,
                                            host(counts))
        got = {k: i for i, k in enumerate(zip(*gv))}
        check(set(got) == set(ref), f"{what}: groups {sorted(got)}")
        for key, i in got.items():
            qsum, psum, cnt = ref[key]
            check(int(cnts[i]) == cnt, f"{what}: count {key}")
            check(float(vals[0][i]) == qsum, f"{what}: qty sum {key}")
            check(rel(vals[1][i], psum) < 1e-5, f"{what}: price {key}")
        return {k: (float(vals[0][i]), float(vals[1][i]), int(cnts[i]))
                for k, i in got.items()}
    (outs, counts, _, spill), _ = timed(
        lambda: kern.run(sbatch, sq.where, sq.aggs, sq.group))
    mono = check_dict(outs, counts, spill, sbatch.dicts, "dict Q1")
    grouped = {}
    (souts, scounts), _ = timed(lambda: ss.streaming_scan_aggregate(
        sblocks, sq.columns, sq.where, sq.aggs, sq.group, kernel=kern,
        grouped_out=grouped))
    check(ss.LAST_STREAM_STATS["chunks"] >= 3, "dict Q1 did not stream")
    streamed = check_dict(souts, scounts, grouped["spill"],
                          grouped["dicts"], "streamed dict Q1")
    for key, (qsum, psum, cnt) in mono.items():
        s_q, s_p, s_c = streamed[key]
        check(s_c == cnt and s_q == qsum and rel(s_p, psum) < 1e-9,
              f"streamed dict Q1 differs from monolithic at {key}")
    routes["dict_q1_str"] = (False, lambda: kern.run(
        sbatch, sq.where, sq.aggs, sq.group), PROFILE_ITERS)

    def serve_q1_str(tablet, read_ht, hand):
        """The registry's q1 (tpch_q1_str) on this batch; the hand route
        refuses dictionary groups by type and the exact route serves."""
        refused = dict(kern.hand_scan_refusals)
        outs, counts, mask, spill = kern.run(sbatch, sq.where, sq.aggs,
                                             sq.group)
        check_dict(outs, counts, spill, sbatch.dicts, "registry q1")
        if hand:
            check(kern.hand_scan_refusals.get("group_shape", 0)
                  == refused.get("group_shape", 0) + 1,
                  "registry q1: the hand route did not refuse by type")
            return "hand flag: refused (group_shape), served exact"
        return "exact, string batch"
    routes["stream_dict_q1_str"] = (False, lambda: ss.streaming_scan_aggregate(
        sblocks, sq.columns, sq.where, sq.aggs, sq.group, kernel=kern),
        STREAM_ITERS)
    print(f"[phase 3] dict Q1 OK, monolithic and streamed "
          f"({ss.LAST_STREAM_STATS['chunks']} chunks)")

    # --- streaming: hand route (K3 per chunk), exact route at a read point
    cols = Q1.columns
    for hand, read_ht in ((True, None), (False, ht1)):
        with flags.overridden("hand_scan_enabled", hand):
            for q in (Q6, Q1):
                what = (f"streamed {'hand' if hand else 'exact'} {q.name}"
                        f"{'' if read_ht is None else ' at ht1'}")
                k3_before = hs.LAUNCHES["generic_scan"]
                (souts, scounts), _ = timed(
                    lambda: ss.streaming_scan_aggregate(
                        blocks, cols, q.where, q.aggs, q.group, read_ht,
                        kernel=kern))
                chunks = ss.LAST_STREAM_STATS["chunks"]
                check(chunks >= 3, f"{what}: {chunks} chunks")
                k3 = hs.LAUNCHES["generic_scan"] - k3_before
                check(k3 == (chunks if hand else 0),
                      f"{what}: K3 launched {k3} times over {chunks} chunks")
                mono = kern.run(batch, q.where, q.aggs, q.group, read_ht)
                if q is Q6:
                    check_q6((souts,), what)
                    check(rel(souts[0], host(mono[0][0])) < 1e-9,
                          f"{what}: differs from monolithic")
                else:
                    check_q1((souts, scounts), what, True)
                    check(np.array_equal(scounts, host(mono[1]))
                          and np.array_equal(souts[0], host(mono[0][0])),
                          f"{what}: counts/qty differ from monolithic")
                    check(max(rel(a, b) for a, b in zip(
                        souts[1], host(mono[0][1]))) < 1e-9,
                          f"{what}: price differs from monolithic")
                routes[f"stream_{'hand' if hand else 'exact_read'}_"
                       f"{q.name}"] = (hand, lambda q=q, r=read_ht:
                                       ss.streaming_scan_aggregate(
                                           blocks, cols, q.where, q.aggs,
                                           q.group, r, kernel=kern),
                                       STREAM_ITERS)
                print(json.dumps({"stream": what, **ss.LAST_STREAM_STATS}))
    return routes, {"q1": serve_q1_str}


def tombstone_block(cb):
    """A delete of every row of bulk-built block `cb` at its own ht and
    write ids: keys, pk and key hashes kept, tombstone lane set, value
    columns NULL with zeroed values (the reference's columnar form of a
    tombstone)."""
    import numpy as np
    from yugabyte_db_tpu_torch.storage.columnar import ColumnarBlock
    n = cb.n
    out = ColumnarBlock.from_arrays(
        cb.schema_version, cb.key_hash, cb.ht, write_id=cb.write_id,
        pk=cb.pk, tombstone=np.ones(n, bool), unique_keys=cb.unique_keys,
        keys=cb.keys,
        fixed={c: (np.zeros(n, v.dtype), np.ones(n, bool))
               for c, (v, _) in cb.fixed.items()},
        varlen={c: (np.zeros(n, np.uint32), b"", np.ones(n, bool))
                for c in cb.varlen})
    out.keys_proven = cb.keys_proven
    return out


def build_compaction_tablet(np, data, root, n_ssts, rows_per, block_rows):
    """The 100-SST lineitem tablet of profile_compact.py at SF1: SST i
    holds rows (i * rows_per) mod (n - rows_per) onward, its first
    quarter rewriting rows of SST i-1, written at BASE + i * 1000 us;
    plus one tombstone SST (every 100th rowid) at BASE + 49,500 us.
    Returns (store dir, versions): versions lists each SST's (rowids,
    hybrid time, tombstone flag) — write ids are positions in the batch."""
    from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.storage.lsm import LsmStore
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    n = len(data["rowid"])
    codec = TableCodec(tpch.lineitem_info())
    store = LsmStore(root, key_builder=codec.derive_keys,
                     shred_cols=codec.shred_cols)
    versions = []
    for i in range(n_ssts):
        fresh = (i * rows_per) % max(n - rows_per, 1)
        sel = np.arange(fresh, fresh + rows_per) % n
        if i > 0:
            prev = (sel - rows_per // 4) % n
            sel[: rows_per // 4] = prev[: rows_per // 4]
        ht = HybridTime.from_micros(COMPACT_BASE_US + i * 1000)
        codec.bulk_ingest(store, {k: v[sel] for k, v in data.items()}, ht,
                          block_rows=block_rows)
        versions.append((data["rowid"][sel], ht.value, False))
    sel = np.nonzero(data["rowid"] % 100 == 0)[0]
    ht = HybridTime.from_micros(COMPACT_BASE_US + 49_500)
    blocks = [tombstone_block(b) for b in codec.bulk_blocks_iter(
        {k: v[sel] for k, v in data.items()}, ht, block_rows=block_rows)]

    def build(w):
        for b in blocks:
            w.add_columnar_block(b)
    store.ingest_sst(build, stream=True)
    versions.append((data["rowid"][sel], ht.value, True))
    return codec, versions


def lineitem_doc_keys(np, rowid):
    """[n, 14] encoded doc keys of lineitem rows, written here from the
    one hash pk column (rowid) and the key format, apart from the port's
    TableCodec: kUInt16Hash (0x08), the 16-bit partition hash
    big-endian, kInt64 (0x26), rowid + 2**63 big-endian, then kGroupEnd
    (0x03) closing the hash group and the (empty) range group.  The
    hash is FNV-1a 64 over the 9 encoded column bytes, folded h ^ h>>32,
    low 16 bits (dockv/key_encoding.py's byte values, bulk.py's hash)."""
    n = len(rowid)
    col = np.empty((n, 9), np.uint8)
    col[:, 0] = 0x26
    col[:, 1:] = (np.asarray(rowid, np.int64).view(np.uint64)
                  ^ np.uint64(1 << 63)).astype(">u8").view(
                      np.uint8).reshape(n, 8)
    h = np.full(n, np.uint64(0xCBF29CE484222325))
    for j in range(col.shape[1]):
        h = (h ^ col[:, j].astype(np.uint64)) * np.uint64(0x100000001B3)
    h ^= h >> np.uint64(32)
    out = np.empty((n, 14), np.uint8)
    out[:, 0] = 0x08
    out[:, 1:3] = (h & np.uint64(0xFFFF)).astype(">u2").view(
        np.uint8).reshape(n, 2)
    out[:, 3:12] = col
    out[:, 12:14] = 0x03
    return out


def compaction_oracle(np, data, versions, dk_words_of_rowid, cutoff):
    """The compacted table straight from the generated inputs and the
    retention rule (ops/compaction.py:12-17), in full-encoded-key order:
    (rowid, ht, write id, tombstone) of every kept version.  Sorted by
    np.lexsort on (doc key words, ~ht, ~write id); `dk_words_of_rowid`
    maps a rowid to its encoded doc key's two big-endian u64 words."""
    rowid = np.concatenate([r for r, _, _ in versions])
    ht = np.concatenate([np.full(len(r), h, np.uint64)
                         for r, h, _ in versions])
    wid = np.concatenate([np.arange(len(r), dtype=np.uint32)
                          for r, _, _ in versions])
    tomb = np.concatenate([np.full(len(r), t) for r, _, t in versions])
    w0, w1 = dk_words_of_rowid[:, 0][rowid], dk_words_of_rowid[:, 1][rowid]
    order = np.lexsort((~wid, ~ht, w1, w0))
    rowid, ht, wid, tomb = rowid[order], ht[order], wid[order], tomb[order]
    same = np.concatenate([[False], rowid[1:] == rowid[:-1]])
    dup = same & np.concatenate([[False], (ht[1:] == ht[:-1])
                                 & (wid[1:] == wid[:-1])])
    leq = ht <= np.uint64(cutoff)
    prev_leq = np.concatenate([[False], leq[:-1]])
    first_leq = leq & (~same | ~prev_leq)
    keep = ~dup & ((ht > np.uint64(cutoff)) | (first_leq & ~tomb))
    return rowid[keep], ht[keep], wid[keep], tomb[keep]


def read_sst_rows(np, path, codec):
    """Every lane of every block of one SST through the port's reader,
    concatenated: {lane: array} with pk/fixed/varlen flattened."""
    from yugabyte_db_tpu_torch.storage.sst import SstReader
    r = SstReader(path, key_builder=codec.derive_keys)
    blocks = [r.columnar_block(i) for i in range(r.num_blocks())]
    out = {"keys": np.concatenate([b.keys for b in blocks]),
           "ht": np.concatenate([b.ht for b in blocks]),
           "write_id": np.concatenate([b.write_id for b in blocks]),
           "tombstone": np.concatenate([b.tombstone for b in blocks]),
           "key_hash": np.concatenate([b.key_hash for b in blocks])}
    for c in blocks[0].pk:
        out[f"pk{c}"] = np.concatenate([b.pk[c] for b in blocks])
    for c in blocks[0].fixed:
        out[f"fixed{c}"] = np.concatenate([b.fixed[c][0] for b in blocks])
        out[f"null{c}"] = np.concatenate([b.fixed[c][1] for b in blocks])
    for c in blocks[0].varlen:
        out[f"varlen{c}"] = [bytes(b.varlen[c][1]) for b in blocks]
        out[f"vends{c}"] = np.concatenate([b.varlen[c][0] for b in blocks])
        out[f"vnull{c}"] = np.concatenate([b.varlen[c][2] for b in blocks])
    return out


def compaction_profile(torch, card, run) -> dict:
    """Device busy time, idle share and top device activities of one
    compaction under torch.profiler (device rows only, every thread)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        time.sleep(PROFILE_MARGIN_S)
    top, busy_us, h2d_us = [], 0.0, 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us <= 0:
            continue
        busy_us += us
        if "HtoD" in e.key:
            h2d_us += us
        top.append((us, e.key, e.count))
    top.sort(reverse=True)
    check(busy_us > 0, "compaction profile recorded no device activity")
    return {"card": card, "wall_s": wall, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e6 / wall,
            "h2d_ms": h2d_us / 1e3, "h2d_share_of_busy": h2d_us / busy_us,
            "top_device_ops": [{"name": k[:80], "ms": us / 1e3,
                                "count": c} for us, k, c in top[:8]]}


def compaction_phase(torch, np, data, card, root) -> None:
    """Phase 5: LSM compaction of a 100-SST SF1 lineitem tablet, device
    backend on the card against the native backend (the same chunked
    engine with the host k-way merge per chunk) and the baseline backend
    on the host and a numpy oracle; chunk_merge_kernel on a real
    frontier against its CPU run."""
    import shutil
    from yugabyte_db_tpu_torch.docdb import compaction as comp
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops import compaction as oc
    from yugabyte_db_tpu_torch.storage.lsm import LsmStore
    from yugabyte_db_tpu_torch.utils import flags
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    n = len(data["rowid"])
    t0 = time.perf_counter()
    src = f"{root}/src"
    codec, versions = build_compaction_tablet(
        np, data, src, COMPACT_SSTS, COMPACT_ROWS_PER, COMPACT_BLOCK_ROWS)
    build_s = time.perf_counter() - t0
    cutoff = HybridTime.from_micros(COMPACT_BASE_US + 50 * 1000).value
    check(flags.get("compaction_chunk_rows") == 524288,
          "compaction runs at the reference's default flags")
    # the doc key of every rowid, encoded apart from the port's codec
    check(np.array_equal(np.sort(data["rowid"]), np.arange(n)),
          "lineitem rowids are 0..n-1")
    dk_bytes = lineitem_doc_keys(np, np.arange(n))
    dk_of_rowid = np.zeros((n, 16), np.uint8)
    dk_of_rowid[:, :14] = dk_bytes
    dk_of_rowid = dk_of_rowid.view(">u8").astype(np.uint64)
    store = LsmStore(src, key_builder=codec.derive_keys)
    frontier_rows = []
    for r in reversed(store.ssts):          # oldest (SST 0) first
        for i in range(r.num_blocks()):
            if sum(len(f[0]) for f in frontier_rows) < COMPACT_FRONTIER:
                cb = r.columnar_block(i)
                frontier_rows.append((oc.keys_to_words(
                    cb.keys[:, :-oc._HT_SUFFIX]), cb.ht.copy(),
                    cb.write_id.copy(), cb.tombstone.copy()))
    input_mb = store.approximate_size() / 1e6
    n_in = sum(r.num_entries for r in store.ssts)
    del store
    print(json.dumps({"compaction_load": {
        "ssts": len(versions), "rows": n_in, "input_mb": input_mb,
        "build_s": build_s, "card": card}}))

    # --- chunk_merge_kernel on a real frontier: card against CPU ------------
    dk, ht, wid, tomb = (np.concatenate(x)[:COMPACT_FRONTIER]
                         for x in zip(*frontier_rows))
    m = len(ht)
    valid = np.ones(m, bool)
    srt = np.lexsort((~wid, ~ht, dk[:, 1], dk[:, 0]))
    b = srt[m // 2]
    c = srt[m // 3]
    fr_bound = (dk[b], int(ht[b]), int(wid[b]))
    fr_carry = (dk[c], int(ht[c]), int(wid[c]), True)
    for bd, cy in ((None, None), (fr_bound, fr_carry)):
        got = oc.merge_frontier(dk, ht, wid, tomb, valid, bd, cy, cutoff,
                                device="cuda")
        want = oc.merge_frontier(dk, ht, wid, tomb, valid, bd, cy, cutoff,
                                 device="cpu")
        torch.cuda.synchronize()
        for name, g, w_ in zip(("order", "emit", "keep"), got, want):
            check(torch.equal(g.cpu(), w_),
                  f"chunk_merge {name} on the card differs from the CPU "
                  f"({'with' if bd else 'without'} bound and carry)")
    lanes = oc.to_device_lanes(dk, ht, wid, tomb, valid,
                               torch.device("cuda", 0))
    reps = 5
    row_in = 8 * dk.shape[1] + 8 + 8 + 1 + 1   # dk words, ht, wid, tomb, valid
    row_out = 8 + 1 + 1                        # order, emit, keep
    bms, bby = bound(m * (row_in + row_out), 0)
    prog = {"program": "chunk_merge_kernel",
            "replaces": "yugabyte_db_tpu/ops/compaction.py:263", "rows": m,
            "ms": cuda_ms(torch, lambda: oc.chunk_merge_kernel(
                *lanes, fr_bound, fr_carry, cutoff), reps, queued=False),
            "bound_ms": bms, "bound_by": bby,
            "h2d_ms": cuda_ms(torch, lambda: oc.to_device_lanes(
                dk, ht, wid, tomb, valid, torch.device("cuda", 0)), reps,
                queued=False),
            "card": card}
    print("[phase 5] chunk_merge on the card equals its CPU run, with and "
          "without bound and carry")

    # --- the three backends on copies of one store -------------------------
    results = {}
    for backend in ("device", "native", "baseline"):
        d = f"{root}/{backend}"
        shutil.copytree(src, d)
        store = LsmStore(d, key_builder=codec.derive_keys)
        inputs = list(store.ssts)
        oc.reset_kernel_stats()
        comp.LAST_COMPACTION_STATS.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        path = comp.tpu_compact(store, codec, cutoff,
                                block_rows=COMPACT_BLOCK_ROWS,
                                backend=backend, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check(len(store.ssts) == 1 and store.ssts[0].path == path,
              f"{backend}: store holds {len(store.ssts)} SSTs after")
        check(not any(os.path.exists(r.path) for r in inputs),
              f"{backend}: input SST files remain")
        st = dict(comp.LAST_COMPACTION_STATS)
        calls = oc.kernel_cache_stats()["calls"]
        if backend == "device":
            check(calls == st["chunks"] + st["m_growths"] and calls > 0,
                  f"device: {calls} merge calls over {st} ")
        elif backend == "native":
            check(calls == 0 and st.get("backend") == "native"
                  and st["chunks"] > 0,
                  f"native: {calls} device merge calls, stats {st}")
        else:
            check(calls == 0 and not st, "baseline ran the device merge")
        out = store.ssts[0]
        results[backend] = (path, read_sst_rows(np, path, codec))
        rows = results[backend][1]
        line = {"compaction": backend, "card": card, "input_mb": input_mb,
                "input_rows": n_in, "wall_s": wall,
                "mb_per_s": input_mb / wall, "input_rows_per_s": n_in / wall,
                "output_bytes": out.file_size,
                "kept_rows": int(len(rows["ht"])),
                "chunks": st.get("chunks"), "merge_calls": calls,
                "stages_s": ({k: st[k] for k in (
                    "decode_wait_s", "dispatch_s", "merge_wait_s",
                    "gather_s", "write_wait_s")} if st else None)}
        if backend != "baseline":
            for k in ("m_cap", "m_growths", "frontier_rows", "emitted_rows",
                      "fused_gather_calls", "gather_fallback_calls"):
                line[k] = st[k]
        print(json.dumps(line))
        # the stage split times the fused host gather, never its numpy
        # twin
        check(backend == "baseline" or st["gather_fallback_calls"] == 0,
              f"{backend}: {st.get('gather_fallback_calls')} gathers fell "
              "back to numpy")
    dev_rows = results["device"][1]
    for other in ("native", "baseline"):
        rows_o = results[other][1]
        check(dev_rows.keys() == rows_o.keys(), f"lane sets differ "
              f"(device, {other})")
        for k in dev_rows:
            same = (dev_rows[k] == rows_o[k]
                    if isinstance(dev_rows[k], list)
                    else np.array_equal(dev_rows[k], rows_o[k]))
            check(same, f"device and {other} outputs differ in {k}")
    dev_bytes = open(results["device"][0], "rb").read()
    same_bytes = all(open(results[b][0], "rb").read() == dev_bytes
                     for b in ("native", "baseline"))

    # --- both against the numpy oracle --------------------------------------
    rid = tpch.ROWID
    o_rowid, o_ht, o_wid, o_tomb = compaction_oracle(
        np, data, versions, dk_of_rowid, cutoff)
    got = dev_rows
    check(np.array_equal(got[f"pk{rid}"], o_rowid), "oracle: rowid order")
    check(np.array_equal(got["ht"], o_ht), "oracle: ht")
    check(np.array_equal(got["write_id"], o_wid), "oracle: write ids")
    check(np.array_equal(got["tombstone"], o_tomb), "oracle: tombstones")
    keys = got["keys"]
    check(keys.shape[1] == 14 + 13
          and np.array_equal(keys[:, :14], dk_bytes[o_rowid])
          and np.all(keys[:, 14] == 0x05),          # kHybridTime
          "oracle: doc keys")
    check(np.array_equal(
        keys[:, -12:-4].copy().view(">u8").reshape(-1), ~o_ht)
        and np.array_equal(keys[:, -4:].copy().view(">u4").reshape(-1),
                           ~o_wid), "oracle: hybrid-time suffixes")
    for name, col in (("l_quantity", 1), ("l_extendedprice", 2),
                      ("l_discount", 3), ("l_tax", 4), ("l_shipdate", 5),
                      ("l_returnflag", 6), ("l_linestatus", 7)):
        want = np.where(o_tomb, 0, data[name][o_rowid]).astype(
            data[name].dtype)
        check(np.array_equal(got[f"fixed{col}"], want)
              and np.array_equal(got[f"null{col}"], o_tomb),
              f"oracle: column {name}")
    print(f"[phase 5] compaction OK: device == native == baseline row for "
          f"row (files {'byte-identical' if same_bytes else 'differ in '
          'bytes'}), all == the numpy oracle ({len(o_rowid)} rows kept "
          f"of {n_in})")

    # --- a second device compaction of a fresh copy, under the profiler -----
    d = f"{root}/profiled"
    shutil.copytree(src, d)
    store = LsmStore(d, key_builder=codec.derive_keys)
    prof = compaction_profile(torch, card, lambda: comp.tpu_compact(
        store, codec, cutoff, block_rows=COMPACT_BLOCK_ROWS,
        backend="device", device="cuda"))
    print(json.dumps({"compaction_profile": "device", **prof}))
    prog["launches_per_compaction"] = \
        comp.LAST_COMPACTION_STATS["kernel_calls"]
    print(json.dumps({"compaction_program": prog}))
    shutil.rmtree(root)


TABLET_BLOCK_ROWS = 262_144     # LineitemTable.load's default (bench.py)
TABLET_ITERS = 5                # warm monolithic reads per timed window
TABLET_STREAM_ITERS = 2         # warm streamed reads per timed window


def k3_launches_by_query(kern) -> dict:
    """K3 launches of a ScanKernel's hand entries, by query signature
    (one entry per signature and bucket; Q1's is the grouped one)."""
    out: dict = {}
    for key, e in kern._cache.items():
        if key[0] == "hand":
            name = f"generic_scan[{'q6' if e.G is None else 'q1'}]"
            out[name] = out.get(name, 0) + e.launches
    return out


def tablet_seam_phase(torch, np, hs, data, card, root,
                      device="cuda", block_rows=TABLET_BLOCK_ROWS,
                      profile=True, keep=None) -> dict:
    """Phase 6: the tablet read seam — Tablet.bulk_load into SSTs, then
    Tablet.read on eight hash tablets (combined by combine_agg_partials)
    and on one streamed tablet, exact and hand routes; a BypassSession
    over the eight tablets with the prefilter on and off against the
    tablet reads at one read point; a range-sharded tablet's zone-pruned
    Q6 with pruning on and off.  Every answer against numpy.  Returns
    the K3 launches of the phase's reads by query signature.  `keep`: a
    dict that receives the eight hash tablets and their read point;
    their SSTs then stay under root/hash8 for the caller to remove."""
    import shutil
    from yugabyte_db_tpu_torch.bypass import BypassSession
    from yugabyte_db_tpu_torch.docdb import operations as ops
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops import stream_scan as ss
    from yugabyte_db_tpu_torch.ops.expr import Expr
    from yugabyte_db_tpu_torch.ops.scan import (_expand_avg,
                                                combine_agg_partials)
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils import flags
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    n = len(data["rowid"])
    Q6, Q1 = tpch.TPCH_Q6, tpch.TPCH_Q1
    ref_q6 = tpch.numpy_reference(Q6, data)
    ref_q1 = tpch.numpy_reference(Q1, data)
    zone_hi = n // 8
    zone_where = ("and", Q6.where, (Expr.col(tpch.ROWID) < zone_hi).node)
    m = ((data["l_shipdate"] >= 8766) & (data["l_shipdate"] < 9131)
         & (data["l_discount"] >= 0.05) & (data["l_discount"] <= 0.07)
         & (data["l_quantity"] < 24.0) & (data["rowid"] < zone_hi))
    ref_zone = (data["l_extendedprice"][m] * data["l_discount"][m]).sum()

    def rel(a, b):
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)

    def check_answer(q, vals, counts, what, ref=None):
        if q is Q1:
            for g in range(6):
                qsum, psum, cnt = ref_q1[g]
                check(int(counts[g]) == cnt, f"{what}: Q1 count g{g}")
                check(float(vals[0][g]) == qsum,
                      f"{what}: Q1 qty sum g{g} not exact")
                check(rel(vals[1][g], psum) < 1e-5,
                      f"{what}: Q1 price sum g{g}")
            return
        r = rel(vals[0], ref_q6 if ref is None else ref)
        check(r < 1e-5, f"{what}: Q6 relative error {r}")

    def fanout(tablets, q, table_id="lineitem", where=None, read_ht=None):
        resps = [t.read(ops.ReadRequest(
            table_id, where=q.where if where is None else where,
            aggregates=q.aggs, group_by=q.group, read_ht=read_ht))
            for t in tablets]
        check(all(r.backend == "tpu" for r in resps), "a read left the card")
        return combine_agg_partials(
            tuple(_expand_avg(q.aggs)), [r.agg_values for r in resps],
            [r.group_counts for r in resps])

    def timed(fn, iters):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        cold = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(iters):
            out = fn()
        sync()
        return out, cold, (time.perf_counter() - t) / iters

    routes = {}                  # profile name -> (hand, run, iters)

    def report(name, n_tablets, cold, wall, hand=False, run=None, iters=0,
               **extra):
        """One `tablet` line (extra keys override the stream stats'),
        and the route registered for profiling when `run` is given."""
        st = dict(ss.LAST_STREAM_STATS)
        print(json.dumps({
            "tablet": name, "card": card, "tablets": n_tablets, "rows": n,
            "path": "streamed" if st else "monolithic",
            "chunks": st.get("chunks", 0), "cold_ms": cold * 1e3,
            "wall_ms": wall * 1e3, "rows_per_s": n / wall,
            "blocks_pruned": st.get("zone_blocks_pruned",
                                    ops.LAST_SCAN_PRUNE_STATS.get(
                                        "blocks_pruned", 0)),
            "blocks_total": st.get("zone_blocks_total",
                                   ops.LAST_SCAN_PRUNE_STATS.get(
                                       "blocks_total", 0)),
            "prefilter_rows_in": st.get("prefilter_rows_in", 0),
            "prefilter_rows_kept": st.get("prefilter_rows_kept", 0),
            **extra}))
        if run is not None:
            routes[name] = (hand, run, iters, wall)
        return st

    if os.path.exists(root):
        shutil.rmtree(root)
    kern = ops.shared_kernel(device)
    before = k3_launches_by_query(kern)
    try:
        # --- load: eight hash tablets, one hash tablet, one range tablet
        t0 = time.perf_counter()
        table8 = tpch.LineitemTable(f"{root}/hash8", num_tablets=8,
                                    device=device)
        check(table8.load(data, block_rows=block_rows) == n,
              "8-tablet load lost rows")
        t1 = time.perf_counter()
        table1 = tpch.LineitemTable(f"{root}/hash1", num_tablets=1,
                                    device=device)
        check(table1.load(data, block_rows=block_rows) == n,
              "1-tablet load lost rows")
        t2 = time.perf_counter()
        rtab = Tablet("lineitem-range", tpch.lineitem_range_info(),
                      f"{root}/range", device=device)
        check(rtab.bulk_load(data) == n, "range load lost rows")
        t3 = time.perf_counter()
        print(json.dumps({"tablet_load": {
            "rows": n, "hash8_s": t1 - t0, "hash1_s": t2 - t1,
            "range_s": t3 - t2, "block_rows": block_rows,
            "hash8_blocks": sum(r.num_blocks() for t in table8.tablets
                                for r in t.regular.ssts),
            "hash1_blocks": sum(r.num_blocks()
                                for r in table1.tablets[0].regular.ssts),
            "range_blocks": sum(r.num_blocks() for r in rtab.regular.ssts),
            "sst_bytes": sum(t.approximate_size() for t in
                             table8.tablets + table1.tablets + [rtab])}}))

        # --- Tablet.read: 8 tablets (monolithic), 1 tablet (streamed) ---
        for route in ("exact", "hand"):
            hand = route == "hand"
            with flags.overridden("hand_scan_enabled", hand):
                for q in (Q6, Q1):
                    ss.LAST_STREAM_STATS.clear()
                    run = lambda q=q: fanout(table8.tablets, q)
                    out, cold, wall = timed(run, TABLET_ITERS)
                    check_answer(q, out[0], out[1], f"8-tablet {route} "
                                 f"{q.name}")
                    st = report(f"tablet8_{route}_{q.name}", 8, cold, wall,
                                hand, run, PROFILE_ITERS)
                    check(not st, "8 tablets of 3 blocks streamed")
                    ss.LAST_STREAM_STATS.clear()
                    run = lambda q=q: fanout(table1.tablets, q)
                    out, cold, wall = timed(run, TABLET_STREAM_ITERS)
                    check_answer(q, out[0], out[1], f"1-tablet {route} "
                                 f"{q.name}")
                    st = report(f"tablet1_stream_{route}_{q.name}", 1, cold,
                                wall, hand, run, STREAM_ITERS)
                    check(st.get("chunks", 0) >= 3,
                          f"1-tablet {q.name} streamed {st.get('chunks')} "
                          "chunks")
        check(not kern.hand_scan_refusals,
              f"hand route refused: {kern.hand_scan_refusals}")

        # --- bypass over the eight tablets at the tablet reads' point ----
        read_ht = max(t.clock.now().value for t in table8.tablets)
        for q in (Q6, Q1):
            rpc = fanout(table8.tablets, q, read_ht=read_ht)
            for pf in (True, False):
                sess = BypassSession(table8.tablets, read_ht=read_ht,
                                     prefilter=pf, device=device)
                try:
                    ss.LAST_STREAM_STATS.clear()
                    run = lambda q=q, s=sess: s.scan_aggregate(
                        q.where, q.aggs, q.group)
                    (vals, counts, st), cold, wall = timed(
                        run, TABLET_STREAM_ITERS)
                finally:
                    sess.close()
                check(st["key_rebuilds"] == 0, "bypass rebuilt keys")
                check(np.array_equal(np.asarray(counts),
                                     np.asarray(rpc[1])),
                      f"bypass {q.name} counts differ from the reads")
                for a, b in zip(vals, rpc[0]):
                    check(np.asarray(a).tobytes() == np.asarray(b).tobytes(),
                          f"bypass {q.name} (prefilter {pf}) is not "
                          "bit-identical to the tablet reads")
                check_answer(q, vals, counts, f"bypass {q.name}")
                if pf and q is Q6:
                    check(0 < st["prefilter_rows_kept"]
                          < st["prefilter_rows_in"],
                          "the prefilter dropped no rows")
                report(f"bypass_{q.name}{'' if pf else '_noprefilter'}",
                       8, cold, wall, path=sorted(set(st["paths"])),
                       prefilter_rows_in=st["prefilter_rows_in"],
                       prefilter_rows_kept=st["prefilter_rows_kept"],
                       key_rebuilds=st["key_rebuilds"])

        # --- the range tablet: Q6 AND rowid < n/8, pruning on and off ----
        answers = {}
        for prune in (True, False):
            with flags.overridden("zone_map_pruning", prune):
                ss.LAST_STREAM_STATS.clear()
                ops.LAST_SCAN_PRUNE_STATS.clear()
                run = lambda: fanout([rtab], Q6, "lineitem_r", zone_where)
                out, cold, wall = timed(run, TABLET_STREAM_ITERS)
                check_answer(Q6, out[0], out[1],
                             f"range Q6 pruning {prune}", ref_zone)
                st = report(f"range_q6_{'pruned' if prune else 'unpruned'}",
                            1, cold, wall, False, run, STREAM_ITERS)
                pruned = st.get("zone_blocks_pruned",
                                ops.LAST_SCAN_PRUNE_STATS.get(
                                    "blocks_pruned", 0))
                check((pruned > 0) == prune,
                      f"range Q6 pruning {prune}: {pruned} blocks pruned")
                answers[prune] = float(out[0][0])
        check(answers[True] == answers[False],
              f"range Q6 pruned {answers[True]} != unpruned "
              f"{answers[False]}")
        after = k3_launches_by_query(kern)
        launches = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        check(all(launches.get(k, 0) > 0 for k in
                  ("generic_scan[q6]", "generic_scan[q1]")) or not cuda,
              f"K3 did not run on the tablet path: {launches}")
        print(f"[phase 6] tablet read seam OK; K3 launches {launches}")

        # --- where the time goes, per route --------------------------------
        problems = []
        if profile:
            for name, (hand, run, iters, wall) in routes.items():
                prune = not name.endswith("_unpruned")
                with flags.overridden("hand_scan_enabled", hand), \
                        flags.overridden("zone_map_pruning", prune):
                    problems += profile_route(torch, hs, name, card, n,
                                               run, iters, wall)
            for pf in (True, False):
                with BypassSession(table8.tablets, read_ht=read_ht,
                                   prefilter=pf, device=device) as sess:
                    for q in (Q6, Q1):
                        problems += profile_route(
                            torch, hs,
                            f"bypass_{q.name}{'' if pf else '_noprefilter'}",
                            card, n, lambda q=q, s=sess: s.scan_aggregate(
                                q.where, q.aggs, q.group), STREAM_ITERS)
        check(not problems, "; ".join(problems))
        if keep is not None:
            keep.update(tablets=table8.tablets, read_ht=read_ht)
        return launches
    finally:
        if keep is None:
            shutil.rmtree(root, ignore_errors=True)
        else:
            for sub in ("hash1", "range"):
                shutil.rmtree(os.path.join(root, sub), ignore_errors=True)


JOIN_BLOCK_ROWS = 65_536        # Tablet.bulk_load's default (bench.py:1897)
JOIN_ITERS = 2                  # warm join reads per timed window
JOIN_BUILD_CAP = 1 << 24        # join_max_build_slots, as bench.py:1924


PROBE_FLUSH_BYTES = 128 << 20    # written between cold probe launches
PROBE_COLD_REPS = 10            # cold launches per stage (median)


def probe_walks(torch, js, pk, live, table, num_slots):
    """Slots each live probe row visits before its hit or its empty slot
    (the walk the probe kernel takes) in the packed table, counted by a
    plain torch loop."""
    slot = js.home_slots(pk, num_slots)
    k = pk.to(torch.int64)
    steps = torch.zeros(pk.shape, dtype=torch.int32, device=pk.device)
    done = torch.logical_not(live)
    while not bool(done.all()):
        steps += torch.logical_not(done).to(torch.int32)
        s = table[slot]
        tu = s[:, 1] >= 0
        done = done | torch.logical_not(tu) | (tu & (s[:, 0].to(torch.int64)
                                                     == k))
        slot = torch.where(done, slot, (slot + 1) & (num_slots - 1))
    return steps[live]


def cuda_ms_cold(torch, fn, reps: int, flush_bytes: int) -> float:
    """Milliseconds of one call of fn() with the L2 cache cold: a
    `flush_bytes` scratch tensor is written before each call, outside the
    CUDA events around the call; the median of `reps` calls, queued
    behind a checked spin as in :func:`cuda_ms`."""
    scratch = torch.empty(flush_bytes // 4, dtype=torch.float32,
                          device="cuda")
    fn()
    torch.cuda.synchronize()

    def window():
        pairs = []
        for i in range(reps):
            scratch.fill_(float(i))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        return pairs[0][0], pairs
    pairs = queued_behind_spin(
        torch, 2 * QUEUE_AHEAD_CYCLES_PER_CALL * reps, window)
    del scratch
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def probe_bytes(padded: int, mask_rows: int, has_nulls: bool,
                live_rows: int, key_bytes: int, slots: int,
                slot_bytes: int) -> int:
    """Bytes the probe function must move: every padded row's mask byte
    in, midx (4 bytes) and mask byte out; the null byte only of rows whose
    mask is set, the key only of live rows (the kernel reads no more); the
    table once at `slot_bytes` a slot.  The bound takes the bytes a slot
    needs: 8 where every build key fits in int32 (the narrow slot {int32
    key; int32 val}), else 13 (used, int64 key, int32 value, as the
    host's arrays)."""
    return (padded * (1 + 4 + 1) + mask_rows * has_nulls
            + live_rows * key_bytes + slots * slot_bytes)


def probe_stages(torch, np, ldata, odata, cdata, dev):
    """The probe stages of phase 2 at SF1, each (label, runtime, probe
    keys, key NULL flags or None, incoming mask): Q3's stage 0
    (l_orderkey of the 8,388,608-row bucket, masked by l_shipdate, against
    the 685,446 orders Q3 ships, 2^21 slots), Q3's stage 1 (stage 0's
    gathered o_custkey lane against Q3's customers, 2^16 slots, under
    stage 0's outgoing mask) and Q5's stage 0 (every row's l_orderkey
    against the 214,256 orders of 1994, 2^19 slots).  Stage 1's inputs
    come from the probe kernel at its defaults."""
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops import join_scan as js
    from yugabyte_db_tpu_torch.ops.device_batch import bucket_rows
    from yugabyte_db_tpu_torch.utils import flags
    n = len(ldata["rowid"])
    padded = bucket_rows(n)
    pk = np.zeros(padded, np.int64)
    pk[:n] = ldata["l_orderkey"]
    pk = torch.from_numpy(pk).to(dev)
    q3 = np.zeros(padded, bool)
    q3[:n] = ldata["l_shipdate"] > tpch._Q3_CUT
    every = np.zeros(padded, bool)
    every[:n] = True
    out = []
    with flags.overridden("join_max_build_slots", JOIN_BUILD_CAP):
        q3_rts = js.make_join_runtimes(tpch.chain_build_wires(
            tpch.tpch_q3_chain(), odata, cdata), {}, device=dev)
        q5_rts = js.make_join_runtimes(tpch.chain_build_wires(
            tpch.tpch_q5_chain(), odata, cdata), {}, device=dev)
    mask = torch.from_numpy(q3).to(dev)
    out.append(("q3 stage 0", q3_rts[0], pk, None, mask))
    rt = q3_rts[0]
    table, pvals, pnulls = rt.to_device(dev)
    midx, m1 = js.probe_kernel(pk, None, mask, table, rt.num_slots)
    gidx = torch.clamp(midx, 0, rt.build_rows_pad - 1).to(torch.int64)
    col = rt.build_cols.index(tpch.chain_bids()["o_custkey"])
    out.append(("q3 stage 1", q3_rts[1], pvals[col][gidx],
                pnulls[col][gidx] | (midx < 0), m1))
    out.append(("q5 stage 0", q5_rts[0], pk, None,
                torch.from_numpy(every).to(dev)))
    return out


def join_probe_check(torch, np, hs, ldata, odata, cdata, card, reps):
    """Phase 2's probe check at the shapes of :func:`probe_stages`.  At
    every stage the kernel, in each slot layout the stage's keys allow
    (16 bytes; 8 where they fit in int32), must give the plain probe's
    midx on every row whose incoming mask is set and its outgoing mask
    everywhere; each layout is timed warm (back to back).  The runtime's
    own layout is also timed unqueued (back to back with no spin ahead),
    cold (a 128 MB write between launches), with no live row (the lanes alone), and with every live row ending at its
    home slot (an empty table of the same layout and size); beside it the
    plain probe and the card's copy of hash_join_cpu (searchsorted over
    the sorted build keys, a gather, a compare: three calls).  Prints one
    `join_probe` line per stage, with the bound at the bytes a slot
    needs (:func:`probe_bytes`) and, labelled, at the three-lane table's
    13 bytes a slot, and returns the kernels-line entry (Q3 stage 0)."""
    from yugabyte_db_tpu_torch.ops import join_scan as js
    dev = torch.device("cuda", 0)
    entry = None
    for label, rt, pk, nulls, mask in probe_stages(torch, np, ldata, odata,
                                                   cdata, dev):
        table = rt.to_device(dev)[0]
        S = rt.num_slots
        padded = pk.shape[0]
        host = [torch.from_numpy(a).to(dev)
                for a in (rt.used, rt.table_key, rt.table_val)]
        narrow = js.fits_narrow(host[1], host[0])
        layouts = [js.SLOT_WIDE] + ([js.SLOT_NARROW] if narrow else [])
        live = mask if nulls is None else mask & ~nulls
        plain = js.probe_table(pk, table, S)
        want = live & (plain >= 0)
        sweep, err = {}, 0.0
        for sb in layouts:
            t = js.pack_table(*host, sb)
            midx, out = js.probe_kernel(pk, nulls, mask, t, S)
            torch.cuda.synchronize()
            what = f"join_probe {label} ({sb}-byte slots)"
            check(bool(torch.equal(out, want)),
                  f"{what}: masks differ from the plain probe")
            check(bool(torch.equal(midx[live], plain[live])),
                  f"{what}: midx differs from the plain probe")
            if bool(live.any()):
                err = max(err, float((midx[live].to(torch.int64)
                                      - plain[live].to(torch.int64))
                                     .abs().max()))
            sweep[f"{sb}B"] = cuda_ms(
                torch, lambda t=t: js.probe_kernel(pk, nulls, mask, t, S),
                reps)
        slot_bytes = 2 * table.element_size()
        ms = sweep[f"{slot_bytes}B"]
        # the same launches timed back to back without the spin (the
        # method of earlier runs, so their times compare with this one)
        unqueued_ms = cuda_ms(torch, lambda: js.probe_kernel(
            pk, nulls, mask, table, S), reps, queued=False)
        cold_ms = cuda_ms_cold(torch, lambda: js.probe_kernel(
            pk, nulls, mask, table, S), PROBE_COLD_REPS, PROBE_FLUSH_BYTES)
        # where the time goes: the lanes alone (no live row), every live
        # row ending at its home slot (an empty table), the real walks (ms)
        empty = js.pack_table(torch.zeros_like(host[0]), host[1], host[2],
                              slot_bytes)
        no_live = torch.zeros_like(mask)
        no_live_ms = cuda_ms(torch, lambda: js.probe_kernel(
            pk, nulls, no_live, table, S), reps)
        home_only_ms = cuda_ms(torch, lambda: js.probe_kernel(
            pk, nulls, mask, empty, S), reps)
        walks = probe_walks(torch, js, pk, live, table, S).double()
        n_in, n_live = int(mask.sum()), int(live.sum())
        need = [padded, n_in, nulls is not None, n_live, pk.element_size(),
                S]
        bms, bby = bound(probe_bytes(*need, 8 if narrow else 13), 0)
        pr6_bms = bound(probe_bytes(*need, 13), 0)[0]
        plain_ms = cuda_ms(torch, lambda: js.probe_table(pk, table, S),
                           2, warmup=1, rounds=3, queued=False)
        # the yardstick: hash_join_cpu on the card, behind a sentinel
        # past the largest key so every searchsorted position is in range
        skeys = torch.sort(torch.from_numpy(rt.keys_mapped).to(dev))[0]
        skeys = torch.cat([skeys, torch.full(
            (1,), torch.iinfo(torch.int64).max, dtype=torch.int64,
            device=dev)])
        pk64 = pk.to(torch.int64)

        def yardstick():
            return skeys[torch.searchsorted(skeys, pk64)] == pk64
        check(bool(torch.equal(yardstick()[live], want[live])),
              f"join_probe {label}: the yardstick's matches differ")
        yard_ms = cuda_ms(torch, yardstick, reps)
        print(json.dumps({"join_probe": label, "card": card,
                          "rows": padded, "mask_rows": n_in,
                          "live_rows": n_live,
                          "build_keys": rt.n_build, "slots": S,
                          "key_dtype": str(pk.dtype),
                          "slot_bytes": slot_bytes,
                          "layout_bytes": S * slot_bytes,
                          "matched": int(want.sum()),
                          "walk_mean": float(walks.mean()),
                          "walk_max": int(walks.max()),
                          "ms": ms, "cold_ms": cold_ms,
                          "unqueued_ms": unqueued_ms,
                          "no_live_ms": no_live_ms,
                          "home_slot_only_ms": home_only_ms,
                          "plain_ms": plain_ms,
                          "bound_ms": bms, "bound_by": bby,
                          "share_of_bound": bms / ms,
                          "cold_share_of_bound": bms / cold_ms,
                          "bound_ms_13B_slots": pr6_bms,
                          "sweep_ms": sweep,
                          "yardstick_3calls_ms": yard_ms,
                          "max_abs_err": err}))
        if entry is None:
            entry = dict(
                name="join_probe", route="cuda",
                source="yugabyte_db_tpu_torch/csrc/join_probe.cu",
                replaces="yugabyte_db_tpu/ops/join_scan.py:406",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=bby, library_ms=None)
    return entry


def baseline_line(torch, np, tpch, blocks, batch, kern, card, rounds=3):
    """The host baseline beside the device route, as bench.py's paired
    cpu_run (bench.py:2488-2510): cpu_scan_aggregate over the SF1 blocks
    and ScanKernel.run over their batch on the card, back to back in each
    round; one `baseline` line per query (best of the rounds and the
    per-round ratios).  The baseline's answers are checked too."""
    from yugabyte_db_tpu_torch.ops.cpu_scan import cpu_scan_aggregate
    n = batch.n_rows
    for q in (tpch.TPCH_Q6, tpch.TPCH_Q1):
        def cpu_run(q=q):
            return cpu_scan_aggregate(blocks, q.columns, q.where, q.aggs,
                                      q.group)

        def dev_run(q=q):
            out = kern.run(batch, q.where, q.aggs, q.group)
            torch.cuda.synchronize()
            return out
        dev_run()
        cpu_out = cpu_run()
        pairs = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            dev_out = dev_run()
            t1 = time.perf_counter()
            cpu_run()
            pairs.append((t1 - t0, time.perf_counter() - t1))
        cnt_cpu = np.asarray(cpu_out[1])
        cnt_dev = dev_out[1].cpu().numpy() if hasattr(dev_out[1], "cpu") \
            else np.asarray(dev_out[1])
        check(np.array_equal(cnt_cpu, cnt_dev),
              f"baseline {q.name}: counts differ from the device route")
        for a, b in zip(cpu_out[0], dev_out[0]):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            check(bool(np.all(np.abs(a - b) <= 1e-6 * np.abs(b) + 1e-6)),
                  f"baseline {q.name}: sums differ from the device route")
        print(json.dumps({"baseline": q.name, "card": card, "rows": n,
                          "device_s": min(t for t, _ in pairs),
                          "cpu_s": min(c for _, c in pairs),
                          "ratios": [c / t for t, c in pairs],
                          "device_rows_per_s": n / min(t for t, _ in pairs),
                          "cpu_rows_per_s": n / min(c for _, c in pairs)}))


def join_phase(torch, np, hs, ldata, odata, cdata, card, root,
               scan_registry, device="cuda", block_rows=JOIN_BLOCK_ROWS,
               profile=True) -> dict:
    """Phase 7: FK-equijoins and fused plans at SF1 — a Tablet over
    lineitem_join_info() bulk-loads lineitem with its l_orderkey FK (92
    blocks of 65,536 rows); q3ish, q3, q5 and q10 through Tablet.read on
    the streamed route (6 chunks of 1,048,576 rows) and the monolithic
    route (one 8,388,608-row bucket) and through a BypassSession; every
    answer against numpy (counts exact, revenue within 1e-5), streamed
    against monolithic (1e-9), the bypass against the tablet read (bit
    for bit); the TPC-H registry walked; one `join` and one `profile`
    line per query and route.  Returns the launches of the phase's reads
    by kernel name."""
    import shutil
    from yugabyte_db_tpu_torch.bypass import BypassSession
    from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops import join_scan as js
    from yugabyte_db_tpu_torch.ops import plan_fusion as pf
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils import flags
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def rel(a, b):
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)

    def timed(fn, iters):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        cold = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(iters):
            out = fn()
        sync()
        return out, cold, (time.perf_counter() - t) / iters

    def by_key(vals, counts, gvals):
        counts = np.asarray(counts)
        return {str(gvals[0][g]): (int(counts[g]),
                                   float(np.asarray(vals[0])[g]))
                for g in np.nonzero(counts)[0]}

    n = len(ldata["rowid"])
    if os.path.exists(root):
        shutil.rmtree(root)
    try:
        t0 = time.perf_counter()
        tablet = Tablet("lineitem-join", tpch.lineitem_join_info(),
                        f"{root}/join", device=device)
        check(tablet.bulk_load(ldata, block_rows=block_rows) == n,
              "join tablet load lost rows")
        blocks = sum(r.num_blocks() for r in tablet.regular.ssts)
        print(json.dumps({"join_load": {
            "rows": n, "blocks": blocks, "block_rows": block_rows,
            "orders": len(odata["o_orderkey"]),
            "customers": len(cdata["c_custkey"]),
            "load_s": time.perf_counter() - t0,
            "sst_bytes": tablet.approximate_size()}}))
        read_ht = tablet.clock.now().value
        queries = {}
        q3ish = tpch.tpch_q3ish()
        queries["q3ish"] = (q3ish.probe_where, q3ish.aggs, q3ish.group,
                            tpch.orders_build_wire(q3ish, odata),
                            tpch.numpy_reference_join(q3ish, ldata, odata))
        for q in (tpch.tpch_q3_chain(), tpch.tpch_q5_chain(),
                  tpch.tpch_q10_chain()):
            queries[q.name] = (q.probe_where, q.aggs,
                               tpch._chain_group(q.group_col),
                               tpch.chain_build_wires(q, odata, cdata),
                               tpch.numpy_reference_chain(q, ldata, odata,
                                                          cdata))

        def request(name):
            where, aggs, group, wires, _ = queries[name]
            return ReadRequest("lineitem_j", where=where, aggregates=aggs,
                               group_by=group, join=wires, read_ht=read_ht)

        # the reference's default build cap refuses even q3ish at SF1
        # (53,404 keys need 131,072 slots): the device join's typed
        # refusal (Tablet.read then answers on the interpreted join)
        cap = flags.get("join_max_build_slots")
        if 2 * len(queries["q3ish"][3].keys) > cap:
            try:
                js.make_join_runtimes(queries["q3ish"][3], {},
                                      device=device)
                check(False, "q3ish built under the default build cap")
            except js.JoinIneligible as e:
                check(e.reason == js.REASON_BUILD_OVERFLOW,
                      f"q3ish refused for another reason: {e}")
                print(f"[phase 7] at join_max_build_slots={cap}: {e}")

        hs.reset_launches()
        routes = {}
        with flags.overridden("join_max_build_slots", JOIN_BUILD_CAP):
            for name, (where, aggs, group, wires, ref) in queries.items():
                stages = len(js.normalize_join(wires))
                answers = {}
                for route in ("streamed", "monolithic"):
                    with flags.overridden("streaming_scan_enabled",
                                          route == "streamed"):
                        before = hs.LAUNCHES["join_probe"]
                        run = lambda name=name: tablet.read(request(name))
                        resp, cold, wall = timed(run, JOIN_ITERS)
                        probes = hs.LAUNCHES["join_probe"] - before
                        st = dict(pf.LAST_PLAN_STATS)
                    check(resp.backend == "tpu", f"{name} left the card")
                    want_path = ("streaming" if route == "streamed"
                                 else "monolithic")
                    check(st["path"] == want_path,
                          f"{name} {route}: path {st['path']}")
                    check(probes == (1 + JOIN_ITERS) * stages * st["chunks"]
                          or not cuda,
                          f"{name} {route}: {probes} probe launches for "
                          f"{stages} stages x {st['chunks']} chunks")
                    got = by_key(resp.agg_values, resp.group_counts,
                                 resp.group_values)
                    for g, (cnt, rev) in ref.items():
                        have = got.get(str(g), (0, 0.0))
                        check(have[0] == cnt,
                              f"{name} {route}: count of {g} {have[0]} "
                              f"!= {cnt}")
                        if cnt:
                            check(rel(have[1], rev) < 1e-5,
                                  f"{name} {route}: revenue of {g} "
                                  f"relative error {rel(have[1], rev)}")
                    answers[route] = (resp, got)
                    print(json.dumps({
                        "join": name, "route": route, "card": card,
                        "rows": n, "stages": stages,
                        "build_keys": ([len(w.keys) for w in
                                        js.normalize_join(wires)]),
                        "slots": st["num_slots"], "chunks": st["chunks"],
                        "bucket_rows": st["bucket_rows"],
                        "build_table_s": st["build_table_s"],
                        "batch_build_s": st.get("batch_build_s"),
                        "kernel_s": st["kernel_s"],
                        "combine_s": st.get("combine_s"),
                        "cold_ms": cold * 1e3, "wall_ms": wall * 1e3,
                        "rows_per_s": n / wall,
                        "probe_launches_per_query": probes
                        / (1 + JOIN_ITERS),
                        "groups": len(got)}))
                    routes[f"join_{name}_{route}"] = (route, run, wall)
                s_got, m_got = answers["streamed"][1], answers["monolithic"][1]
                check(set(s_got) == set(m_got),
                      f"{name}: streamed groups differ from monolithic")
                for g, (cnt, rev) in s_got.items():
                    check(cnt == m_got[g][0] and rel(rev, m_got[g][1]) < 1e-9,
                          f"{name}: streamed differs from monolithic at {g}")
                with BypassSession([tablet], read_ht=read_ht,
                                   device=device) as sess:
                    gout = {}
                    bv, bc, bst = sess.scan_aggregate(
                        where, aggs, group, grouped_out=gout, join=wires)
                check(bst["key_rebuilds"] == 0, f"bypass {name} rebuilt keys")
                resp = answers["streamed"][0]
                check(np.array_equal(np.asarray(bc),
                                     np.asarray(resp.group_counts)),
                      f"bypass {name}: counts differ from the tablet read")
                check([str(x) for x in gout["group_values"][0]]
                      == [str(x) for x in resp.group_values[0]],
                      f"bypass {name}: groups differ from the tablet read")
                for a, b in zip(bv, resp.agg_values):
                    check(np.asarray(a).tobytes() == np.asarray(b).tobytes(),
                          f"bypass {name} is not bit-identical to the "
                          "tablet read")
                print(f"[phase 7] {name} OK on both routes and the bypass "
                      f"({bst['paths']})")

            # --- the TPC-H registry: serve every runnable entry ----------
            registry = {}
            for qname, e in tpch.tpch_queries().items():
                if e.kind == "inexpressible":
                    registry[qname] = {"kind": e.kind, "reason": e.reason}
                    continue
                if e.kind == "chain":
                    registry[qname] = {"kind": e.kind,
                                       "served": ["streamed", "monolithic",
                                                  "bypass"]}
                    continue
                served = []
                for hand in (False, True):
                    with flags.overridden("hand_scan_enabled", hand):
                        served.append(scan_registry[qname](
                            tablet, read_ht, hand))
                registry[qname] = {"kind": e.kind, "served": served}
            print(json.dumps({"registry": registry}))
        launches = dict(hs.LAUNCHES)
        check(launches["join_probe"] > 0 or not cuda,
              "the probe kernel did not run on the join path")
        print(f"[phase 7] joins OK; launches {launches}")

        # --- where the time goes, per join query and route ---------------
        problems = []
        if profile:
            with flags.overridden("join_max_build_slots", JOIN_BUILD_CAP):
                for pname, (route, run, wall) in routes.items():
                    with flags.overridden("streaming_scan_enabled",
                                          route == "streamed"):
                        problems += profile_route(torch, hs, pname, card, n,
                                                  run, JOIN_ITERS, wall)
        check(not problems, "; ".join(problems))
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


ROWS_BASE_US = 1_700_000_000_000_000   # the rows phase's first load (µs)
ROWS_OVERLAY_US = 1_000          # its overlay, µs after the first load
ROWS_ITERS = 2                   # warm row reads per timed window
ROWS_COLS = ("rowid", "l_extendedprice", "l_discount", "l_shipdate")
ROWS_LIMIT = 1000
#: the rows phase's window: PARTITION BY l_returnflag, l_linestatus
#: ORDER BY l_shipdate, every head over the Q6 rows
ROWS_WINDOW_ITEMS = (
    ("row_number", 0, None, "rn"), ("rank", 0, None, "rk"),
    ("dense_rank", 0, None, "dr"), ("count_star", 0, None, "cum_rows"),
    ("sum", 1, "l_shipdate", "cum_ship"), ("sum", 0, "l_shipdate",
                                           "part_ship"),
    ("min", 1, "l_shipdate", "min_ship"), ("max", 1, "l_shipdate",
                                           "max_ship"),
    ("lag", 1, "l_extendedprice", "prev_price"),
    ("lead", 1, "l_extendedprice", "next_price"),
    ("count", 1, "l_discount", "n_disc"))


def rows_windows_phase(torch, np, hs, data, card, root, device="cuda",
                       block_rows=TABLET_BLOCK_ROWS, profile=True) -> dict:
    """Phase 8: row reads on the device filter route and server-side
    windows at SF1, tablets under `root` (removed at the end): a hash
    tablet (262,144-row blocks) and a range tablet (65,536-row blocks)
    loaded through Tablet.bulk_load.  Q6's predicate as a row read
    projecting rowid, l_extendedprice, l_discount, l_shipdate, streamed
    (at least 3 chunks) and monolithic; the range tablet's rowid < n/8
    AND Q6 with zone_map_pruning on and off; `limit` 1000; an
    enumerable WHERE on rowid (batched point gets); a WindowWire
    over the Q6 rows held against the numpy twin window_cpu, and its
    three typed refusals; then an overlay load at ht2 rewriting every
    10th rowid's l_extendedprice, read below and above ht2 (the dedup
    route).  Every row set against numpy.  One `rows` line per route, a
    `window` line (sort, program, scatter) and one `profile` line per
    route.  Returns the window program's launches and the hand kernels'
    launches of the phase."""
    import copy
    import shutil
    from yugabyte_db_tpu_torch.docdb import operations as ops
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops import stream_scan as ss
    from yugabyte_db_tpu_torch.ops import window_scan as ws
    from yugabyte_db_tpu_torch.ops.expr import Expr
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils import flags
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
    cuda = torch.device(device).type == "cuda"
    n = len(data["rowid"])
    check(np.array_equal(data["rowid"], np.arange(n)), "rowid != position")
    read_ht = (ROWS_BASE_US + 2 * ROWS_OVERLAY_US) << 12   # above both
    below_ht = (ROWS_BASE_US + ROWS_OVERLAY_US // 2) << 12
    q6 = ((data["l_shipdate"] >= tpch._D1994)
          & (data["l_shipdate"] < tpch._D1995)
          & (data["l_discount"] >= 0.05) & (data["l_discount"] <= 0.07)
          & (data["l_quantity"] < 24.0))
    zone_hi = n // 8
    zone_where = ("and", (Expr.col(tpch.ROWID) < zone_hi).node,
                  tpch.TPCH_Q6.where)
    price2 = data["l_extendedprice"] * 1.5 + 1.0
    over_sel = data["rowid"] % 10 == 0

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def check_rows(rows, mask, what, price=None):
        """`rows` hold exactly the rows of `mask`, each with its values
        (`price`: the visible l_extendedprice lane)."""
        ids = np.fromiter((r["rowid"] for r in rows), np.int64, len(rows))
        want = np.nonzero(mask)[0]
        check(len(ids) == len(want)
              and np.array_equal(np.sort(ids), want),
              f"{what}: {len(ids)} rows, numpy has {len(want)}")
        lanes = {"l_extendedprice": (data["l_extendedprice"] if price is None
                                     else price),
                 "l_discount": data["l_discount"],
                 "l_shipdate": data["l_shipdate"]}
        for col, lane in lanes.items():
            got = np.fromiter((r[col] for r in rows), lane.dtype, len(rows))
            check(np.array_equal(got, lane[ids]), f"{what}: {col} differs")
        check(all(type(r["rowid"]) is int and type(r["l_shipdate"]) is int
                  and type(r["l_extendedprice"]) is float for r in rows[:8]),
              f"{what}: row value types")

    def read(tablet, table_id, where, columns=ROWS_COLS, **kw):
        kw.setdefault("read_ht", read_ht)
        return tablet.read(ops.ReadRequest(table_id, columns=columns,
                                           where=where, **kw))

    def timed(fn, iters=ROWS_ITERS):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        cold = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(iters):
            out = fn()
        sync()
        return out, cold, (time.perf_counter() - t) / iters

    routes = {}

    def report(name, resp, cold, wall, run=None, **extra):
        st = dict(ss.LAST_STREAM_STATS) if \
            ops.LAST_ROW_STATS.get("route") == "streamed" else {}
        rs = dict(ops.LAST_ROW_STATS)
        check(resp.backend == "tpu", f"{name}: served by {resp.backend}")
        print(json.dumps({
            "rows": name, "card": card, "rows_scanned": n,
            "rows_out": len(resp.rows), "route": rs.get("route"),
            "cold_ms": cold * 1e3, "wall_ms": wall * 1e3,
            "kernel_s": rs.get("kernel_s"), "gather_s": rs.get("gather_s"),
            "chunks": st.get("chunks", 0),
            "chunks_run": st.get("chunks_run", 0),
            "blocks_pruned": st.get("zone_blocks_pruned",
                                    ops.LAST_SCAN_PRUNE_STATS.get(
                                        "blocks_pruned", 0)),
            "blocks_total": st.get("zone_blocks_total",
                                   ops.LAST_SCAN_PRUNE_STATS.get(
                                       "blocks_total", 0)),
            "window_served": resp.window_served,
            "window_reason": resp.window_reason, **extra}))
        if run is not None:
            routes[name] = (run, wall, dict(extra.get("flags", {})))
        return st

    def profile_routes():
        """One `profile` line per route registered since the last call."""
        problems = []
        for name, (run, wall, fl) in routes.items():
            with _overrides(flags, fl):
                problems += profile_route(torch, hs, f"rows_{name}", card,
                                          n, run, ROWS_ITERS, wall)
        routes.clear()
        return problems

    if os.path.exists(root):
        shutil.rmtree(root)
    hand_before = dict(hs.LAUNCHES)
    win_before = ws.WINDOW_STATS["launches"]
    try:
        t0 = time.perf_counter()
        tab = Tablet("lineitem-rows", tpch.lineitem_info(), f"{root}/hash",
                     device=device)
        ht1 = HybridTime.from_micros(ROWS_BASE_US)
        check(tab.bulk_load(data, ht=ht1, block_rows=block_rows) == n,
              "rows tablet load lost rows")
        t1 = time.perf_counter()
        rtab = Tablet("lineitem-rows-range", tpch.lineitem_range_info(),
                      f"{root}/range", device=device)
        check(rtab.bulk_load(data, ht=ht1) == n, "range load lost rows")
        t2 = time.perf_counter()
        print(json.dumps({"rows_load": {
            "rows": n, "hash_s": t1 - t0, "range_s": t2 - t1,
            "hash_blocks": sum(r.num_blocks() for r in tab.regular.ssts),
            "range_blocks": sum(r.num_blocks() for r in rtab.regular.ssts)}}))

        # --- Q6 rows: streamed and monolithic -------------------------------
        full = {}
        for route in ("streamed", "monolithic"):
            with flags.overridden("streaming_scan_enabled",
                                  route == "streamed"):
                run = lambda: read(tab, "lineitem", tpch.TPCH_Q6.where)
                resp, cold, wall = timed(run)
                st = report(f"q6_{route}", resp, cold, wall, run,
                            flags={"streaming_scan_enabled":
                                   route == "streamed"})
            check_rows(resp.rows, q6, f"q6 {route}")
            check(ops.LAST_ROW_STATS["route"] == route,
                  f"q6 {route} took the {ops.LAST_ROW_STATS['route']} route")
            if route == "streamed":
                check(st["chunks"] >= 3, f"q6 streamed {st['chunks']} chunks")
            full[route] = resp.rows
        print(f"[phase 8] Q6 row read: {len(full['streamed'])} of {n} rows "
              f"({len(full['streamed']) / n:.4%})")

        # --- limit 1000: the streamed pipeline closes early ---------------
        resp, cold, wall = timed(lambda: read(tab, "lineitem",
                                              tpch.TPCH_Q6.where,
                                              limit=ROWS_LIMIT))
        st = report("q6_limit", resp, cold, wall)
        check(resp.rows == full["streamed"][:ROWS_LIMIT], "limit rows differ")
        check(st["chunks_run"] < st["chunks"], "limit ran every chunk")

        # --- the range tablet: rowid < n/8 AND Q6, pruning on and off -----
        zone = q6 & (data["rowid"] < zone_hi)
        got = {}
        for prune in (True, False):
            with flags.overridden("zone_map_pruning", prune):
                ss.LAST_STREAM_STATS.clear()
                ops.LAST_SCAN_PRUNE_STATS.clear()
                run = lambda: read(rtab, "lineitem_r", zone_where)
                resp, cold, wall = timed(run)
                st = report(f"range_{'pruned' if prune else 'unpruned'}",
                            resp, cold, wall, run,
                            flags={"zone_map_pruning": prune})
            pruned = st.get("zone_blocks_pruned",
                            ops.LAST_SCAN_PRUNE_STATS.get("blocks_pruned", 0))
            check((pruned > 0) == prune, f"range rows pruning {prune}: "
                  f"{pruned} blocks pruned")
            check_rows(resp.rows, zone, f"range pruning {prune}")
            got[prune] = resp.rows
        check(got[True] == got[False], "pruned rows != unpruned rows")

        # --- an enumerable WHERE on the hash key: batched point gets -----
        ids = [3, 77, 1024]
        t = time.perf_counter()
        resp = read(tab, "lineitem", ("in", ("col", tpch.ROWID), ids))
        enum_s = time.perf_counter() - t
        check(resp.backend == "cpu", "the enumerated read left the host")
        mask = np.zeros(len(data["rowid"]), bool)
        mask[ids] = True
        check_rows(resp.rows, mask, "enumerated rowid IN")
        check([r["rowid"] for r in resp.rows] == ids,
              "enumerated rows out of key order")
        print(json.dumps({"rows_enumerated": "rowid IN", "rows":
                          len(resp.rows), "s": enum_s, "card": card}))

        # --- the window over the Q6 rows ----------------------------------
        wire = ws.WindowWire(("l_returnflag", "l_linestatus"),
                             (("l_shipdate", False),), ROWS_WINDOW_ITEMS)
        wcols = ROWS_COLS + ("l_returnflag", "l_linestatus", "l_quantity")
        run = lambda: read(tab, "lineitem", tpch.TPCH_Q6.where, wcols,
                           window=wire)
        resp, cold, wall = timed(run)
        check(resp.window_served and resp.window_reason is None,
              f"window not served: {resp.window_reason}")
        plain = read(tab, "lineitem", tpch.TPCH_Q6.where, wcols)

        class NumpyTwin:
            run = staticmethod(ws.window_cpu)

        twin = copy.deepcopy(plain.rows)
        ws.serve_window_rows(wire, twin, NumpyTwin())
        check(resp.rows == twin, "windowed rows differ from window_cpu's")
        check_rows(resp.rows, q6, "windowed q6")
        report("q6_window", resp, cold, wall, run)
        # the window's launches on the path (the timed split below and
        # the profiles do not count)
        window_launches = ws.WINDOW_STATS["launches"] - win_before
        # the window's split: host sort, the program on the card (CUDA
        # events over device lanes), host scatter
        rows = copy.deepcopy(plain.rows)
        t = time.perf_counter()
        lanes = ws.window_lanes(wire, rows)
        sort_s = time.perf_counter() - t
        kern = ws.default_window_kernel(device)
        t = time.perf_counter()
        outs = kern.run(*lanes[:5])
        run_s = time.perf_counter() - t
        t = time.perf_counter()
        ws.scatter_window(lanes, outs, rows)
        scatter_s = time.perf_counter() - t
        check(rows == twin, "window split differs")
        ops_sig = [(o[0], o[1] if len(o) > 1 else 0) for o in lanes[0]]
        dev = kern.device

        def lane(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        d_seg, d_peer = lane(lanes[1]), lane(lanes[2])
        d_vals = [lane(v) for v in lanes[3] if v is not None]
        d_nulls = [lane(m) for m in lanes[4] if m is not None]
        n_w = len(rows)
        out_bytes = sum((4 if o[0] in ("row_number", "rank", "dense_rank")
                         else 8) * n_w + n_w for o in ops_sig)
        in_bytes = 2 * n_w + sum(v.nbytes + n_w for v in lanes[3]
                                 if v is not None)
        bms, bby = bound(in_bytes + out_bytes, 0)
        # unqueued: one call is some 300 small launches, so a queued
        # window fills the card's launch queue and the host blocks
        # behind the spin; the events then time launch-bound calls
        prog_ms = cuda_ms(torch, lambda: ws.window_program(
            ops_sig, d_seg, d_peer, d_vals, d_nulls), 5, rounds=3,
            queued=False) if cuda else None
        window_line = {
            "window": "q6 rows", "card": card, "rows": n_w,
            "partitions": int(lanes[1].sum()), "items": len(ops_sig),
            "sort_s": sort_s, "program_run_s": run_s,
            "program_ms": prog_ms, "bound_ms": bms, "bound_by": bby,
            "bytes": in_bytes + out_bytes, "scatter_s": scatter_s,
            "wall_ms": wall * 1e3}
        print(json.dumps(window_line))

        # --- the window's typed refusals -----------------------------------
        refusals = {}
        for case, items, kw, fl in (
                ("float_sum", ROWS_WINDOW_ITEMS
                 + (("sum", 1, "l_quantity", "cum_qty"),), {}, {}),
                ("limit", ROWS_WINDOW_ITEMS, {"limit": ROWS_LIMIT}, {}),
                ("flag_off", ROWS_WINDOW_ITEMS, {},
                 {"window_server_pushdown_enabled": False})):
            with _overrides(flags, fl):
                r = read(tab, "lineitem", tpch.TPCH_Q6.where, wcols,
                         window=ws.WindowWire(wire.partition_by,
                                              wire.order_by, items), **kw)
            check(not r.window_served and "rn" not in r.rows[0],
                  f"window refusal {case}: served")
            refusals[case] = r.window_reason
        check(refusals == {"float_sum": "window_value_kind",
                           "limit": "window_paged_scan",
                           "flag_off": "window_server_off"},
              f"window refusals {refusals}")
        print(json.dumps({"window_refusals": refusals}))

        # the routes so far are profiled before the overlay turns every
        # read of this tablet into a dedup read
        problems = profile_routes() if profile else []

        # --- the overlay: the dedup route below and above ht2 -------------
        over = {k: v[over_sel] for k, v in data.items()}
        over["l_extendedprice"] = price2[over_sel]
        tab.bulk_load(over, ht=HybridTime.from_micros(
            ROWS_BASE_US + ROWS_OVERLAY_US), block_rows=block_rows)
        visible = np.where(over_sel, price2, data["l_extendedprice"])
        for name, ht, price in (("dedup_below", below_ht, None),
                                ("dedup_above", read_ht, visible)):
            run = lambda ht=ht: read(tab, "lineitem", tpch.TPCH_Q6.where,
                                     read_ht=ht)
            ss.LAST_STREAM_STATS.clear()
            resp, cold, wall = timed(run)
            check(ops.LAST_ROW_STATS["route"] == "monolithic",
                  f"{name}: two overlapping SSTs streamed")
            check_rows(resp.rows, q6, name, price=price)
            report(name, resp, cold, wall, run)
        check(not np.array_equal(visible[q6], data["l_extendedprice"][q6]),
              "the overlay changed no Q6 row")

        check(window_launches > 0 or not cuda, "the window program never ran")
        hand = {k: v - hand_before.get(k, 0) for k, v in hs.LAUNCHES.items()}
        print(f"[phase 8] rows and windows OK; window launches "
              f"{window_launches}, hand kernels {hand}")

        if profile:
            problems += profile_routes()
        check(not problems, "; ".join(problems))
        return {"window_program": window_launches, "hand": hand}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _overrides(flags, values: dict):
    """flags.overridden for every (name, value) of `values` at once."""
    import contextlib
    stack = contextlib.ExitStack()
    for k, v in values.items():
        stack.enter_context(flags.overridden(k, v))
    return stack


#: phase 9: bench.py's vector configurations (bench.py:2953-2992): the
#: reduced one and BASELINE.json's 1,000,000 x 768 pgvector one
VECTOR_CONFIGS = (
    {"name": "200k_x_128", "n": 200_000, "dim": 128, "nlists": 256,
     "iters": 5, "nprobe": 64, "repeats": 5, "flat": True},
    {"name": "1m_x_768", "n": 1_000_000, "dim": 768, "nlists": 1024,
     "iters": 2, "nprobe": 256, "repeats": 2, "flat": False},
)
VECTOR_SAMPLE = 50_000           # k-means sample (bench.py)
VECTOR_QUERIES = 64              # queries: base[:64] + 0.001
VECTOR_RECALL_QUERIES = 16       # recall@10 over the first 16
VECTOR_K = 10
HNSW_N = 20_000                  # profile_vec.py's HNSW size, m=16,
HNSW_EF_CONSTRUCTION = 80        # ef_construction=80
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 (NVIDIA data sheet)


def hnsw_job(seed: int, path: str) -> None:
    """The HNSW build on the host, in a process of its own (pure Python,
    so it overlaps the card's phases): 20,000 x 128 through the port's
    registry, 64 queries searched, recall@10 against a numpy exact
    search, the index saved to `path` and the numbers to path/run.json."""
    import numpy as np
    from yugabyte_db_tpu_torch.vector import get_index_cls
    base = np.random.default_rng(seed).normal(
        size=(HNSW_N, 128)).astype(np.float32)
    q = base[:VECTOR_QUERIES] + 0.001
    t0 = time.perf_counter()
    idx = get_index_cls("hnsw").build(
        base, m=16, ef_construction=HNSW_EF_CONSTRUCTION)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, ids = idx.search(q, k=VECTOR_K)
    search_s = time.perf_counter() - t0
    r = VECTOR_RECALL_QUERIES
    d = ((q[:r] ** 2).sum(1)[:, None] + (base ** 2).sum(1)[None, :]
         - 2.0 * q[:r] @ base.T)
    ref = np.argsort(d, axis=1)[:, :VECTOR_K]
    recall = float(np.mean([len(set(ids[i]) & set(ref[i])) / VECTOR_K
                            for i in range(r)]))
    idx.save(path)
    with open(os.path.join(path, "run.json"), "w") as f:
        json.dump({"build_s": build_s, "qps": VECTOR_QUERIES / search_s,
                   "recall_at_10": recall, "ids": ids.tolist()}, f)


def vectors_phase(torch, np, card, seed, root, device="cuda",
                  configs=VECTOR_CONFIGS, hnsw=None, profile=True) -> dict:
    """Phase 9: vector search on the card at bench.py's configurations.
    Per configuration: the base made on the device from `seed`; the
    two-stage IVF built (k-means and the assignment on the card);
    exact_search on the card (every query's top-1 its own row); the IVF
    search timed (qps on the host clock, device ms per batch by CUDA
    events beside its bound, peak device memory); recall@10 against an
    f32 exact search on 16 queries, no more than 0.02 below the same
    device search's in f32 on the CPU (the numpy twin's, _cpu_search,
    printed beside: it re-ranks the batch's probed-list union, another
    candidate set); at the first configuration the flat
    IvfFlatIndex's probe and full-scan routes and a save/load through
    the registry that searches to the same ids.  `hnsw`: the running
    hnsw_job (process, path), joined here.  One `vector` line per
    configuration, `vector_program` lines (exact search, the two-stage
    search, a k-means iteration: ms against bound) and an `hnsw` line.
    Returns the device searches by kind."""
    import shutil
    from yugabyte_db_tpu_torch.ops import vector as pv
    from yugabyte_db_tpu_torch.vector import AnnIndex, TwoStageIvfIndex
    from yugabyte_db_tpu_torch.vector import ivf as pivf
    cuda = torch.device(device).type == "cuda"
    dev = torch.device(device)
    k = VECTOR_K
    r = VECTOR_RECALL_QUERIES

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def recall(ids, ref):
        return float(np.mean([len(set(ids[i]) & set(ref[i])) / k
                              for i in range(r)]))

    def program_line(name, cfg, fn, bytes_moved, ops_by_rate):
        """One `vector_program` line: ms per call (CUDA events) against
        the bound: bytes over HBM, or the operations over each type's
        peak, whichever is longer."""
        t_ops = sum(o / rate for o, rate in ops_by_rate) * 1e3
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        bms, bby = ((t_bytes, "bytes") if t_bytes >= t_ops
                    else (t_ops, "operations"))
        ms = cuda_ms(torch, fn, 3, warmup=2, rounds=3) if cuda else None
        print(json.dumps({"vector_program": name, "config": cfg,
                          "card": card, "ms": ms, "bound_ms": bms,
                          "bound_by": bby,
                          "share_of_bound": bms / ms if ms else None}))
        return ms

    if os.path.exists(root):
        shutil.rmtree(root)
    os.makedirs(root)
    pivf.reset_kernel_stats()
    exact_calls = 0
    try:
        for cfg in configs:
            name, n, d = cfg["name"], cfg["n"], cfg["dim"]
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(seed)
            base_d = torch.randn(n, d, generator=gen, device=dev)
            base = base_d.cpu().numpy()
            q = base[:VECTOR_QUERIES] + 0.001
            q_d = torch.from_numpy(q).to(dev)
            gen_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            idx = TwoStageIvfIndex.build(base, nlists=cfg["nlists"],
                                         iters=cfg["iters"],
                                         sample=VECTOR_SAMPLE, seed=seed,
                                         device=dev)
            sync()
            build_s = time.perf_counter() - t0
            # exact search on the card (bf16 products)
            _, ei = pv.exact_search(q_d, base_d, k)
            exact_calls += 1
            ei = ei.cpu().numpy()
            check(np.array_equal(ei[:, 0], np.arange(VECTOR_QUERIES)),
                  f"{name}: an exact search's top-1 is not its own row")
            # the f32 exact answer the recalls are held against
            qr = q_d[:r]
            dist = ((qr * qr).sum(1)[:, None] + pv.sq_norms(base_d)[None, :]
                    - 2.0 * pv.mm_f32(qr, base_d))
            ref = torch.topk(-dist, k, dim=1).indices.cpu().numpy()
            del dist
            # the two-stage IVF: warm, then timed as bench.py times it
            nprobe = cfg["nprobe"]
            idx.search(q, k=k, nprobe=nprobe)
            sync()
            t0 = time.perf_counter()
            for _ in range(cfg["repeats"]):
                _, ids = idx.search(q, k=k, nprobe=nprobe)
            search_s = (time.perf_counter() - t0) / cfg["repeats"]
            card_recall = recall(ids, ref)
            check(np.array_equal(ids[:, 0], np.arange(VECTOR_QUERIES)),
                  f"{name}: an IVF search's top-1 is not its own row")
            # the same device search on the CPU in f32 (the reference's
            # backend="device" semantics, which the CPU tests hold the
            # port to): the card's bf16 stage 1 keeps its recall
            cpu_idx = TwoStageIvfIndex(idx.cent, idx.sorted, idx.ids,
                                       idx.starts, idx.counts, idx.options,
                                       device="cpu")
            _, cids = cpu_idx.search(q[:r], k=k, nprobe=nprobe)
            del cpu_idx
            cpu_recall = recall(cids, ref)
            check(card_recall >= cpu_recall - 0.02,
                  f"{name}: card recall {card_recall} vs the same search "
                  f"in f32 on the CPU {cpu_recall}")
            # the numpy twin re-ranks the batch's probed-list UNION (with
            # gap merging): another candidate set, printed beside
            t0 = time.perf_counter()
            _, tids = idx.search(q[:r], k=k, nprobe=nprobe, backend="cpu")
            twin_s = time.perf_counter() - t0
            twin_pool = idx.last_pool_rows
            twin_recall = recall(tids, ref)
            # device ms per batch: the two-stage search on device tensors
            dv = idx._device_arrays()
            k_eff, pool = idx.device_plan(k, nprobe)
            prog = program_line(
                "two_stage_search", name,
                lambda: pivf.two_stage_search(
                    q_d, dv["cent"], dv["row_list"], dv["vecs"],
                    dv["norms"], k_eff, nprobe, pool),
                dv["vecs"].numel() * dv["vecs"].element_size()
                + 8 * n + q_d.numel() * 4,
                [(2 * VECTOR_QUERIES * n * d, BF16_OPS_PER_S)])
            peak = torch.cuda.max_memory_allocated() if cuda else None
            print(json.dumps({
                "vector": name, "card": card, "n": n, "dim": d,
                "nlists": cfg["nlists"], "nprobe": nprobe, "k": k,
                "generate_s": gen_s, "build_s": build_s,
                "qps": VECTOR_QUERIES / search_s,
                "recall_at_10": card_recall,
                "cpu_f32_recall_at_10": cpu_recall,
                "twin_recall_at_10": twin_recall,
                "twin_s": twin_s, "twin_pool_rows": twin_pool,
                "pool_rows": pool, "device_ms_per_batch": prog,
                "bound_ms": (dv["vecs"].numel() * 2 + 8 * n)
                / HBM_BYTES_PER_S * 1e3,
                "peak_device_bytes": peak}))
            # the other programs against their bounds
            program_line("exact_search", name,
                         lambda: pv.exact_search(q_d, base_d, k),
                         base_d.numel() * 4 + q_d.numel() * 4,
                         [(2 * VECTOR_QUERIES * n * d, BF16_OPS_PER_S)])
            samp = base_d[:VECTOR_SAMPLE]
            cent = torch.from_numpy(idx.cent).to(dev)
            program_line("kmeans_iteration", name,
                         lambda: pv._kmeans_iters(samp, cent, 1),
                         samp.numel() * 4 + 2 * cent.numel() * 4,
                         [(2 * VECTOR_SAMPLE * cfg["nlists"] * d,
                           BF16_OPS_PER_S),
                          (VECTOR_SAMPLE * d, FP32_OPS_PER_S)])
            if cfg["flat"]:
                flat = pv.IvfFlatIndex.build(base, nlists=cfg["nlists"],
                                             sample=VECTOR_SAMPLE,
                                             iters=cfg["iters"], seed=seed,
                                             device=dev)
                few = 3                  # 3 * nprobe < nlists: the probe
                for route, qs in (("probe", q[:few]), ("full_scan", q)):
                    flat.search(qs, k=k, nprobe=nprobe)
                    sync()
                    t0 = time.perf_counter()
                    _, fi = flat.search(qs, k=k, nprobe=nprobe)
                    ms = (time.perf_counter() - t0) * 1e3
                    check(np.array_equal(fi[:, 0], np.arange(len(qs))),
                          f"{name} IvfFlatIndex {route}: top-1")
                    print(json.dumps({"vector_flat": route, "config": name,
                                      "card": card, "queries": len(qs),
                                      "wall_ms": ms}))
                del flat
                path = os.path.join(root, name)
                idx.save(path)
                loaded = AnnIndex.load(path, device=dev)
                _, li = loaded.search(q, k=k, nprobe=nprobe)
                check(np.array_equal(li, ids),
                      f"{name}: the saved and loaded index searches apart")
                del loaded
            del idx, base_d, base, samp, cent, dv, q_d, qr
            if cuda:
                torch.cuda.empty_cache()
        searches = pivf.kernel_cache_stats()["calls"]
        if hnsw is not None:
            proc, path = hnsw
            proc.join(timeout=600)
            check(proc.exitcode == 0, f"the HNSW job failed: {proc.exitcode}")
            with open(os.path.join(path, "run.json")) as f:
                run = json.load(f)
            loaded = AnnIndex.load(path, device=dev)
            base = np.random.default_rng(seed).normal(
                size=(HNSW_N, 128)).astype(np.float32)
            _, hi = loaded.search(base[:VECTOR_QUERIES] + 0.001, k=k)
            check(hi.tolist() == run["ids"],
                  "the HNSW index searches apart after save and load")
            print(json.dumps({"hnsw": f"{HNSW_N}_x_128", "m": 16,
                              "ef_construction": HNSW_EF_CONSTRUCTION,
                              "build_s": run["build_s"], "qps": run["qps"],
                              "recall_at_10": run["recall_at_10"],
                              "host": True}))
        print(f"[phase 9] vectors OK; two-stage searches {searches}, "
              f"exact searches {exact_calls}")
        return {"two_stage_search": searches, "exact_search": exact_calls}
    finally:
        shutil.rmtree(root, ignore_errors=True)


#: phase 10: BASELINE.json config 3 ("TPC-H SF=10 Q1 sharded across 8
#: tablets -> psum", bench.py:2730-2770) at SF1, the sharded vector search
MESH_SHAPES = ((8, 1), (4, 2))   # tablet x block shards over 8 tablets
MESH_ITERS = 5                   # warm queries per timed window
MESH_VECTOR = (1_000_000, 768)   # phase 9's 1M x 768 base, 8 slots
MESH_ANN = (4, 50_000, 128, 64)  # shards, rows each, dim, lists (all probed)


def mesh_phase(torch, np, hs, data, card, tablets, read_ht, seed,
               device="cuda", vector=MESH_VECTOR, ann=MESH_ANN,
               profile=True) -> dict:
    """Phase 10: the multi-device tablet mesh.  Config 3 at SF1: the
    eight hash tablets' SST blocks (gathered as bench.py:2742-2748
    does) in a sharded batch on an 8 x 1 and a 4 x 2 mesh (slot s on
    card s mod the card count), Q6 and Q1 through
    distributed_scan_aggregate with no read point and at the tablets'
    read point, each against numpy and against the host combine of
    Tablet.read over the same tablets, the two meshes bit for bit, and a
    dynamic-scale Q6 (column stats dropped: the cross-shard max pass).
    The bypass mesh combine over one tablet, and over the eight (the
    reference's ValueError on fewer than eight cards).
    sharded_exact_search on a 1M x 768 base in 8 slots (views of one
    base) against exact_search; sharded_ann_search over 4 two-stage IVF
    shards, every list probed.  One `mesh` line per query and mesh, one
    `profile` line per query, a `mesh_vector` and a `mesh_ann` line.
    Returns the launches of the two programs on the phase's path."""
    import dataclasses
    import warnings
    from yugabyte_db_tpu_torch.bypass import BypassSession
    from yugabyte_db_tpu_torch.docdb import operations as ops
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops import vector as pv
    from yugabyte_db_tpu_torch.ops.scan import (_expand_avg,
                                                combine_agg_partials,
                                                needed_probe_columns)
    from yugabyte_db_tpu_torch.parallel import distributed_scan as pds
    from yugabyte_db_tpu_torch.parallel import vector as ppv
    from yugabyte_db_tpu_torch.parallel.mesh import tablet_mesh
    from yugabyte_db_tpu_torch.vector import TwoStageIvfIndex
    cuda = torch.device(device).type == "cuda"
    n = len(data["rowid"])
    Q6, Q1 = tpch.TPCH_Q6, tpch.TPCH_Q1
    ref = {"q6": tpch.numpy_reference(Q6, data),
           "q1": tpch.numpy_reference(Q1, data)}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def rel(a, b):
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)

    def check_answer(q, vals, counts, what, ref_q=None, exact=None):
        """Against numpy (revenue 1e-5, Q1 counts and quantity sums
        exact), or with `exact` (a host combine) within 1e-9, counts
        exact."""
        if exact is not None:
            check(np.array_equal(np.asarray(counts, np.int64),
                                 np.asarray(exact[1], np.int64)),
                  f"{what}: counts differ from the host combine")
            for i, (a, b) in enumerate(zip(vals, exact[0])):
                a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
                check(bool(np.all(np.abs(a - b) <= 1e-9 * np.abs(b))),
                      f"{what}: agg {i} off the host combine by more than "
                      "1e-9")
            return
        r_q = ref[q.name] if ref_q is None else ref_q
        if q is Q1:
            for g in range(6):
                qsum, psum, cnt = r_q[g]
                check(int(counts[g]) == cnt, f"{what}: Q1 count g{g}")
                check(float(vals[0][g]) == qsum,
                      f"{what}: Q1 qty sum g{g} not exact")
                check(rel(vals[1][g], psum) < 1e-5,
                      f"{what}: Q1 price sum g{g}")
            return
        r = rel(vals[0], r_q)
        check(r < 1e-5, f"{what}: Q6 relative error {r}")

    def host_combine(q):
        resps = [t.read(ops.ReadRequest(
            "lineitem", where=q.where, aggregates=q.aggs, group_by=q.group,
            read_ht=read_ht)) for t in tablets]
        return combine_agg_partials(
            tuple(_expand_avg(q.aggs)), [r.agg_values for r in resps],
            [r.group_counts for r in resps])

    def blocks_of(t):
        return [r.columnar_block(i) for r in t.regular.ssts
                for i in range(r.num_blocks())]

    n_cards = torch.cuda.device_count() if cuda else 1
    devices = [torch.device("cuda", s % n_cards) if cuda
               else torch.device("cpu") for s in range(8)]
    kern = pds._DEFAULT
    kern.launches = 0
    ppv.LAUNCHES["sharded_exact_search"] = 0
    hosts = {q.name: host_combine(q) for q in (Q6, Q1)}
    for q in (Q6, Q1):
        check_answer(q, hosts[q.name][0], hosts[q.name][1],
                     f"host combine {q.name}")
    t0 = time.perf_counter()
    shard_blocks = [blocks_of(t) for t in tablets]
    collect_s = time.perf_counter() - t0
    check(sum(b.n for bl in shard_blocks for b in bl) == n,
          "the tablets' blocks lost rows")
    answers = {}
    problems = []
    for T, B in MESH_SHAPES:
        tm = tablet_mesh(T, B, devices=devices)
        t0 = time.perf_counter()
        batch = pds.build_sharded_batch(tm, shard_blocks,
                                        sorted(Q1.columns))
        sync()
        build_s = time.perf_counter() - t0
        mesh = f"{T}x{B}"
        for q in (Q6, Q1):
            for mode, rh in (("none", None), ("visible", read_ht)):
                vals, counts = pds.distributed_scan_aggregate(
                    batch, q.where, q.aggs, q.group, rh)
                what = f"mesh {mesh} {q.name} {mode}"
                check_answer(q, vals, counts, what)
                check_answer(q, vals, counts, what, exact=hosts[q.name])
                answers[(mesh, q.name, mode)] = (vals, counts)
            # timed and profiled with no read point, like phase 4's
            # monolithic exact route
            run = lambda q=q: pds.distributed_scan_aggregate(  # noqa: E731
                batch, q.where, q.aggs, q.group)
            before = kern.launches
            run()
            launches = kern.launches - before
            sync()
            t0 = time.perf_counter()
            for _ in range(MESH_ITERS):
                run()
            sync()
            wall = (time.perf_counter() - t0) / MESH_ITERS
            # the combine alone, and the host syncs before the rescale
            aggs, raws = kern.shard_partials(batch, q.where, q.aggs,
                                             q.group)
            combine_ms = (cuda_ms(torch, lambda: kern.combine(tm, aggs, raws),
                                  20) if cuda else None)
            syncs = None
            if cuda:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        aggs, raws = kern.shard_partials(
                            batch, q.where, q.aggs, q.group)
                        kern.combine(tm, aggs, raws)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                # one warning per synchronizing call (the mode's own
                # notice that it is a prototype is not one)
                found = [f"{w.filename}:{w.lineno}: {w.message}"
                         for w in caught
                         if "synchroniz" in str(w.message)
                         and "prototype" not in str(w.message)]
                syncs = len(found)
                check(syncs == 0, f"mesh {mesh} {q.name}: {syncs} host "
                      f"syncs before the rescale: {found[:4]}")
            stats: dict = {}
            if profile and mesh == "8x1":
                problems += profile_route(torch, hs, f"mesh8_{q.name}", card,
                                          n, run, PROFILE_ITERS, wall,
                                          stats=stats)
            # the least time for the work: each lane the query reads
            # (its columns, their NULL lanes, valid) once, every slot
            row_bytes = 1 + sum(
                batch.cols[c][0].element_size() + 1
                for c in needed_probe_columns(q.where, q.aggs, q.group))
            bms = (row_bytes * batch.padded_rows * batch.num_shards
                   / HBM_BYTES_PER_S * 1e3)
            print(json.dumps({
                "mesh": mesh, "query": q.name, "card": card, "cards": n_cards,
                "rows": n, "padded_rows_per_slot": batch.padded_rows,
                "wall_ms": wall * 1e3, "rows_per_s": n / wall,
                "collect_blocks_s": collect_s,
                "build_sharded_batch_s": build_s,
                "slot_programs_per_query": launches,
                "device_activities_per_query": stats.get(
                    "activities_per_query"),
                "device_busy_ms": stats.get("device_busy_ms"),
                "bound_ms": bms, "bound_by": "bytes",
                "combine_ms": combine_ms,
                "host_syncs_before_rescale": syncs,
                "bytes_per_card": batch.bytes_by_device()}))
        if mesh == "8x1":
            # one SUM on the dynamic scale: no column stats, so the
            # cross-shard max pass runs on the card before quantizing
            passes = kern.vmax_passes
            bare = dataclasses.replace(batch, col_bounds={})
            vals, counts = pds.distributed_scan_aggregate(bare, Q6.where,
                                                          Q6.aggs)
            check(kern.vmax_passes == passes + 1,
                  "the dynamic-scale Q6 ran no cross-shard max pass")
            check_answer(Q6, vals, counts, "mesh 8x1 q6 dynamic scale")
            print(json.dumps({"mesh_dynamic_scale": "q6", "card": card,
                              "revenue": float(vals[0]),
                              "rel_err": rel(vals[0], ref["q6"])}))
        del batch
    for key in answers:
        if key[0] == "4x2":
            a, b = answers[key], answers[("8x1",) + key[1:]]
            check(np.asarray(a[1]).tobytes() == np.asarray(b[1]).tobytes()
                  and all(np.asarray(x).tobytes() == np.asarray(y).tobytes()
                          for x, y in zip(a[0], b[0])),
                  f"meshes 4x2 and 8x1 differ on {key[1:]}")
    check(not problems, "; ".join(problems))
    scan_launches = kern.launches

    # --- the bypass mesh combine ------------------------------------------
    one = shard_blocks[0]
    cols = {name: np.concatenate([b.fixed[cid][0] for b in one])
            for cid, name in ((tpch.QTY, "l_quantity"),
                              (tpch.EXTPRICE, "l_extendedprice"),
                              (tpch.DISCOUNT, "l_discount"),
                              (tpch.SHIPDATE, "l_shipdate"))}
    with BypassSession(tablets[:1], read_ht=read_ht, device=device) as sess:
        vals, counts, st = sess.scan_aggregate(Q6.where, Q6.aggs,
                                               combine="mesh")
    check(st["combine"] == "mesh" and st["shards_scanned"] == 1,
          f"bypass mesh stats {st}")
    check_answer(Q6, vals, counts, "bypass mesh, one tablet",
                 ref_q=tpch.numpy_reference(Q6, cols))
    with BypassSession(tablets, read_ht=read_ht, device=device) as sess:
        if cuda and n_cards < len(tablets):
            try:
                sess.scan_aggregate(Q6.where, Q6.aggs, combine="mesh")
                check(False, "an 8-tablet mesh combine ran on "
                      f"{n_cards} card(s)")
            except ValueError as e:
                print(json.dumps({"bypass_mesh": 8, "cards": n_cards,
                                  "refused": str(e)}))
        else:
            vals, counts, st = sess.scan_aggregate(Q6.where, Q6.aggs,
                                                   combine="mesh")
            check_answer(Q6, vals, counts, "bypass mesh, eight tablets")
            print(json.dumps({"bypass_mesh": 8, "cards": n_cards,
                              "revenue": float(vals[0])}))

    # --- sharded vector search ---------------------------------------------
    vn, vd = vector
    k, S = VECTOR_K, 8
    gen = torch.Generator(device=devices[0]).manual_seed(seed)
    base = torch.randn(vn, vd, generator=gen, device=devices[0])
    q = base[:VECTOR_QUERIES].cpu().numpy() + 0.001
    n_shard = vn // S
    views = [base[s * n_shard:(s + 1) * n_shard] for s in range(S)]
    tm = tablet_mesh(S, 1, devices=[devices[0]] * S)
    before = ppv.LAUNCHES["sharded_exact_search"]
    sd, si = ppv.sharded_exact_search(tm, q, views, k)
    search_launches = ppv.LAUNCHES["sharded_exact_search"] - before
    check(np.array_equal(si[:, 0], np.arange(VECTOR_QUERIES)),
          "sharded exact search: a top-1 is not its own row")
    wd, wi = pv.exact_search(torch.from_numpy(q).to(devices[0]),
                             base[:n_shard * S], k + 1)
    wd, wi = wd.cpu().numpy(), wi.cpu().numpy()
    untied = [r for r in range(len(q))
              if wd[r, k] - wd[r, k - 1] > 1e-4 * wd[r, k]]
    check(all(set(si[r].tolist()) == set(wi[r, :k].tolist())
              for r in untied),
          "sharded exact search: ids differ from exact_search")
    dist_err = float(np.max(np.abs(sd - wd[:, :k])
                            / np.maximum(np.abs(wd[:, :k]), 1e-30)))
    check(dist_err <= 1e-3, f"sharded exact search: distances off by "
          f"{dist_err} relative")
    ms = (cuda_ms(torch, lambda: ppv.sharded_exact_search(tm, q, views, k),
                  3, warmup=1, rounds=3, queued=False) if cuda else None)
    bms = vn * vd * 4 / HBM_BYTES_PER_S * 1e3
    print(json.dumps({"mesh_vector": f"{vn}_x_{vd}", "card": card,
                      "slots": S, "queries": len(q), "k": k,
                      "untied_queries": len(untied),
                      "max_rel_dist_err": dist_err, "ms_per_batch": ms,
                      "bound_ms": bms, "bound_by": "bytes",
                      "share_of_bound": bms / ms if ms else None}))
    del base, views
    n_ann, an, ad, nlists = ann
    gen = torch.Generator(device=devices[0]).manual_seed(seed + 1)
    abase = torch.randn(n_ann * an, ad, generator=gen,
                        device=devices[0]).cpu().numpy()
    aq = abase[::(n_ann * an) // VECTOR_QUERIES][:VECTOR_QUERIES] + 0.001
    t0 = time.perf_counter()
    indexes = [TwoStageIvfIndex.build(abase[i * an:(i + 1) * an],
                                      nlists=nlists, iters=5,
                                      sample=VECTOR_SAMPLE, seed=seed,
                                      device=devices[0])
               for i in range(n_ann)]
    sync()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ad_, ai = ppv.sharded_ann_search(aq, indexes, k, nprobe=nlists)
    search_s = time.perf_counter() - t0
    check(bool(((ai >= 0) & (ai < n_ann * an)).all()),
          "sharded ANN search: an invalid id")
    check(bool((np.diff(ad_, axis=1) >= -1e-5).all()),
          "sharded ANN search: distances decrease")
    ab = torch.from_numpy(abase).to(devices[0])
    aqd = torch.from_numpy(aq).to(devices[0])
    dist = ((aqd * aqd).sum(1)[:, None] + pv.sq_norms(ab)[None, :]
            - 2.0 * pv.mm_f32(aqd, ab))
    aref = torch.topk(-dist, k, dim=1).indices.cpu().numpy()
    recall = float(np.mean([len(set(ai[r]) & set(aref[r])) / k
                            for r in range(len(aq))]))
    check(recall >= 0.9, f"sharded ANN search recall@10 {recall} < 0.9")
    print(json.dumps({"mesh_ann": f"{n_ann}_x_{an}_x_{ad}", "card": card,
                      "nlists": nlists, "nprobe": nlists,
                      "build_s": build_s, "search_ms": search_s * 1e3,
                      "recall_at_10": recall}))
    print(f"[phase 10] mesh OK; distributed_scan slot programs "
          f"{scan_launches}, sharded_exact_search slot programs "
          f"{search_launches}")
    return {"distributed_scan": scan_launches,
            "sharded_exact_search": search_launches}


# --- phase 11: the write path -------------------------------------------------------
WRITE_BASE_US = 1_700_000_000_000_000   # the write path's mock clocks start here
HTAP_CHECK_KEYS = 1000                 # rowids per get_row check set
HTAP_ITERS = 5                         # warm queries per htap timing window
YCSB_ROWS = 1_000_000                  # BASELINE.json config 1's usertable
YCSB_OPS = 50_000                      # operations per workload
YCSB_TTL_UPSERTS = 100_000             # YCQL USING TTL upserts
YCSB_E_REPACKED_OPS = 10_000          # the E pass over the repacked tablet
MAINT_UPSERTS = 10_000                 # phase 11c: upserts after the ALTER
MAINT_SAMPLE = 2_000                   # keys each maintenance check reads
MAINT_FRESH = 5_000                    # rows written after the TRUNCATE
COLO_ROWS = 100_000                    # the colocated usertable (cut: colocation
#                                        is for many small tables)
COLO_SMALL = 10_000                    # the colocated 2-column table
YCSB_FLUSH_BYTES = 8 << 20             # memstore_flush_threshold_bytes (cut:
#                                        the reference's default is 64 MiB)


def _live_lineitem(np, data, alive, inserted):
    """The live rows as column arrays: the loaded rows not deleted, then
    every inserted row."""
    out = {k: v[alive] for k, v in data.items()}
    if inserted:
        rows = list(inserted.values())
        for k in out:
            out[k] = np.concatenate([out[k], np.asarray(
                [r[k] for r in rows], dtype=data[k].dtype)])
    return out


def htap_phase(torch, np, hs, data, card, root, seed=0, device="cuda",
               block_rows=TABLET_BLOCK_ROWS, profile=True) -> dict:
    """Phase 11 (a): TPC-H SF1 lineitem in ONE tablet taking the refresh
    functions (RF1 inserts of SF x 1500 orders, one write request each;
    RF2 deletes of SF x 1500 orders' lineitems) through Tablet.apply_write
    while Q6 and Q1 run on the card over SST + memtable (MVCC mode
    dedup), then after a flush and a second RF1/RF2 pair (2 SSTs +
    memtable), then after flush() and a major compaction on the card, on
    the exact route and through K3.  Every answer against numpy over the
    live rows; after each step get_row of inserted, deleted and untouched
    rowids, and at a read point before RF2 the deleted rows read back.
    The refresh rows and the check sets are drawn from `seed`.  Returns
    the K3 launches of the phase by query signature."""
    import shutil
    from yugabyte_db_tpu_torch.docdb.operations import (ReadRequest, RowOp,
                                                        WriteRequest,
                                                        shared_kernel)
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils import flags
    from yugabyte_db_tpu_torch.utils.hybrid_time import (HybridClock,
                                                         HybridTime,
                                                         MockPhysicalClock)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    shutil.rmtree(root, ignore_errors=True)
    n = len(data["rowid"])
    phys = MockPhysicalClock(WRITE_BASE_US)
    t0 = time.perf_counter()
    tablet = Tablet("htap", tpch.lineitem_info(), os.path.join(root, "t"),
                    clock=HybridClock(phys), device=device)
    tablet.bulk_load(data, ht=HybridTime.from_micros(WRITE_BASE_US),
                     block_rows=block_rows)
    print(json.dumps({"htap_load": {"rows": n, "s": time.perf_counter() - t0,
                                    "card": card}}))
    alive = np.ones(n, bool)
    inserted: dict = {}
    deleted: set = set()
    rng = np.random.default_rng(seed + 11)
    k3_before = k3_launches_by_query(shared_kernel(device))
    Q6, Q1 = tpch.TPCH_Q6, tpch.TPCH_Q1

    def rel(a, b):
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)

    def check_answer(q, resp, live, what, hand=False):
        check(resp.backend == "tpu", f"{what}: the read left the card")
        if q is Q6:
            r = rel(resp.agg_values[0], tpch.numpy_reference(Q6, live))
            check(r < (2e-4 if hand else 1e-5),
                  f"{what}: Q6 relative error {r}")
            return
        ref = tpch.numpy_reference(Q1, live)
        for g in range(6):
            qsum, psum, cnt = ref[g]
            check(int(resp.group_counts[g]) == cnt, f"{what}: Q1 count g{g}")
            if hand:
                check(rel(resp.agg_values[0][g], qsum) < 2e-4,
                      f"{what}: Q1 qty sum g{g}")
            else:
                check(float(resp.agg_values[0][g]) == qsum,
                      f"{what}: Q1 qty sum g{g} not exact")
            check(rel(resp.agg_values[1][g], psum) < (2e-4 if hand
                                                       else 1e-5),
                  f"{what}: Q1 price sum g{g}")

    def read(q):
        return tablet.read(ReadRequest("lineitem", where=q.where,
                                       aggregates=q.aggs, group_by=q.group))

    def queries(step, hand=False):
        live = _live_lineitem(np, data, alive, inserted)
        for q in (Q6, Q1):
            sync()
            t = time.perf_counter()
            resp = read(q)           # the first read after a write
            sync()
            first_s = time.perf_counter() - t
            check_answer(q, resp, live, f"htap {step} {q.name}", hand)
            t = time.perf_counter()
            for _ in range(HTAP_ITERS):
                resp = read(q)
            sync()
            wall = (time.perf_counter() - t) / HTAP_ITERS
            check_answer(q, resp, live, f"htap {step} {q.name} warm", hand)
            stats: dict = {}
            if profile:
                problems = profile_route(
                    torch, hs, f"htap_{step}_{q.name}", card,
                    len(live["rowid"]), lambda q=q: read(q), HTAP_ITERS,
                    wall=wall, stats=stats)
                check(not problems, "; ".join(problems))
            busy = stats.get("device_busy_ms")
            print(json.dumps({
                "htap": step, "query": q.name,
                "route": "hand (K3)" if hand else "exact",
                "live_rows": len(live["rowid"]),
                "ssts": len(tablet.regular.ssts),
                "memtable_rows": sum(len(m) for m in
                                     tablet.regular.memtables()),
                "first_read_s": first_s, "wall_ms": wall * 1e3,
                "batch_rebuild_s": max(first_s - wall, 0.0),
                "device_busy_ms": busy,
                "idle_share": (None if busy is None
                               else 1.0 - busy / (wall * 1e3)),
                "card": card}))

    def point_checks(step, before_ht=None, before_deleted=()):
        """get_row of inserted, deleted and untouched rowids at explicit
        read points (which never restart); one `htap_checks` line with
        the reads' count and seconds."""
        op = tablet._read_op
        op._allow_restart = False
        read_ht = tablet.clock.now().value
        t = time.perf_counter()
        ins = list(inserted)
        for r in rng.choice(ins, min(HTAP_CHECK_KEYS, len(ins)),
                            replace=False):
            got = op.get_row({"rowid": int(r)}, read_ht)
            check(got == inserted[int(r)],
                  f"htap {step}: inserted rowid {r} reads {got}")
        dels = sorted(deleted)
        for r in rng.choice(dels, min(HTAP_CHECK_KEYS, len(dels)),
                            replace=False):
            got = op.get_row({"rowid": int(r)}, read_ht)
            check(got is None, f"htap {step}: deleted rowid {r} reads {got}")
        untouched = rng.integers(0, n, 3 * HTAP_CHECK_KEYS)
        untouched = [int(r) for r in untouched if alive[r]][:HTAP_CHECK_KEYS]
        for r in untouched:
            got = op.get_row({"rowid": r}, read_ht)
            check(got == {k: data[k][r].item() for k in data},
                  f"htap {step}: loaded rowid {r} reads {got}")
        for r in list(before_deleted)[:HTAP_CHECK_KEYS]:
            got = op.get_row({"rowid": int(r)}, before_ht)
            check(got == {k: data[k][r].item() for k in data},
                  f"htap {step}: rowid {r} before RF2 reads {got}")
        reads = (min(HTAP_CHECK_KEYS, len(ins))
                 + min(HTAP_CHECK_KEYS, len(dels)) + len(untouched)
                 + len(list(before_deleted)[:HTAP_CHECK_KEYS]))
        print(json.dumps({"htap_checks": step, "get_rows": reads,
                          "s": time.perf_counter() - t, "card": card}))

    def refresh(rnd):
        """One RF1/RF2 pair through apply_write; returns the read point
        taken before RF2 and the rowids RF2 deleted."""
        t = time.perf_counter()
        rows = 0
        for order in tpch.refresh_inserts(SF, n + 1_000_000 * rnd,
                                          seed=seed + 100 + rnd):
            phys.advance_micros(10)
            batch = tpch.column_rows(order)
            tablet.apply_write(WriteRequest("lineitem", [
                RowOp("upsert", r) for r in batch]))
            for r in batch:
                inserted[r["rowid"]] = r
            rows += len(batch)
        rf1_s = time.perf_counter() - t
        phys.advance_micros(10)
        before_ht = tablet.clock.now().value
        t = time.perf_counter()
        gone = []
        for ids in tpch.refresh_deletes(SF, n, seed=seed + 200 + rnd):
            phys.advance_micros(10)
            tablet.apply_write(WriteRequest("lineitem", [
                RowOp("delete", {"rowid": int(r)}) for r in ids]))
            gone += [int(r) for r in ids if alive[r]]
            alive[ids] = False
            deleted.update(int(r) for r in ids)
        print(json.dumps({"htap_refresh": rnd, "rf1_rows": rows,
                          "rf1_s": rf1_s, "rf2_rows": len(gone),
                          "rf2_s": time.perf_counter() - t, "card": card}))
        phys.advance_micros(10)
        return before_ht, gone

    def flush(label):
        rows = sum(len(m) for m in tablet.regular.memtables())
        t = time.perf_counter()
        path = tablet.flush()
        s = time.perf_counter() - t
        check(path is not None and tablet.regular.memtable_empty(),
              f"flush {label} left a memtable")
        print(json.dumps({"flush": label, "rows": rows,
                          "bytes": os.path.getsize(path), "s": s,
                          "card": card}))

    with flags.overridden("device_float_dtype", "auto"), \
            flags.overridden("hand_scan_enabled", False):
        before_ht, gone = refresh(1)
        point_checks("rf1", before_ht, gone)
        queries("sst+memtable")
        flush("round 1")
        point_checks("flush 1", before_ht, gone)
        before_ht, gone = refresh(2)
        point_checks("rf2", before_ht, gone)
        queries("2ssts+memtable")
        flush("round 2")
        point_checks("flush 2", before_ht, gone)
        # the history cutoff past every write: the compaction drops the
        # deleted rows' tombstones and versions
        phys.advance_micros(
            (flags.get("history_retention_interval_sec") + 60) * 1_000_000)
        t = time.perf_counter()
        inputs = len(tablet.regular.ssts)
        path = tablet.compact()
        sync()
        check(len(tablet.regular.ssts) == 1 and path is not None,
              "htap compaction left several SSTs")
        print(json.dumps({"htap_compaction": {
            "inputs": inputs, "s": time.perf_counter() - t,
            "output_bytes": os.path.getsize(path), "card": card}}))
        point_checks("compacted")
        queries("compacted")
        with flags.overridden("hand_scan_enabled", True):
            k3 = hs.LAUNCHES["generic_scan"]
            queries("compacted", hand=True)
            check(not cuda or hs.LAUNCHES["generic_scan"] > k3,
                  "htap: K3 did not serve the compacted tablet")
    k3_after = k3_launches_by_query(shared_kernel(device))
    shutil.rmtree(root, ignore_errors=True)
    return {k: v - k3_before.get(k, 0) for k, v in k3_after.items()}


def ycsb_job(seed: int, root: str, card: str, device: str = "cuda",
             rows: int = YCSB_ROWS, ops: int = YCSB_OPS,
             ttl_upserts: int = YCSB_TTL_UPSERTS,
             maint: tuple = (MAINT_UPSERTS, MAINT_SAMPLE, MAINT_FRESH,
                             YCSB_E_REPACKED_OPS),
             colo: tuple = (COLO_ROWS, COLO_SMALL)) -> None:
    """Phase 11 (b), in a process of its own after (a): BASELINE.json
    config 1 — YCSB core workloads A, B, C (1 and 32 clients) and E on
    one usertable tablet of `rows` x 10 fields x 100 bytes, the flush on
    the apply path at an 8 MiB memtable, the point reads through the
    host extension's whole-SST readers (route counters on each `point`
    line), and C once more on the per-key path; every updated key reads
    back its update; then `ttl_upserts` upserts with a row TTL (half
    expire before the history cutoff), flush(), and Tablet.compact()
    through _compact_rows with merge_gc_split on `device`, its output
    against the CPU feed (the baseline backend on a copy) entry for
    entry.  Then phase 11 (c), the maintenance steps on the same tablet
    (maintenance_steps), and the colocated tablet (colocation_steps).
    Prints `point`, `point_reader`, `flush_apply`, `row_compaction`,
    `maintenance` and `colocation` lines and writes its numbers to
    root/run.json."""
    import shutil

    import numpy as np
    import torch
    from yugabyte_db_tpu_torch.docdb import compaction as pcomp
    from yugabyte_db_tpu_torch.docdb.hotpath import POINT_READ_STATS
    from yugabyte_db_tpu_torch.docdb.operations import RowOp, WriteRequest
    from yugabyte_db_tpu_torch.models import ycsb
    from yugabyte_db_tpu_torch.ops import compaction as pops
    from yugabyte_db_tpu_torch.storage.lsm import LsmStore
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.tablet import tablet as ptablet
    from yugabyte_db_tpu_torch.utils import flags
    from yugabyte_db_tpu_torch.utils.hybrid_time import (HybridClock,
                                                         MockPhysicalClock)
    cuda = torch.device(device).type == "cuda"
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    flags.set_flag("memstore_flush_threshold_bytes", YCSB_FLUSH_BYTES)
    phys = MockPhysicalClock(WRITE_BASE_US)
    tablet = Tablet("ycsb", ycsb.usertable_info(), os.path.join(root, "t"),
                    clock=HybridClock(phys), device=device)
    work = ycsb.YcsbTabletWorkload(tablet, rows, seed=seed + 1)
    out: dict = {"points": []}
    t = time.perf_counter()
    work.load()
    out["load_s"] = time.perf_counter() - t
    print(json.dumps({"ycsb_load": {"rows": rows, "s": out["load_s"],
                                    "card": card}}))
    # the loaded SST's whole-SST reader, built before the runs time it
    t = time.perf_counter()
    tablet.multi_read("usertable", [{"ycsb_key": 0}])
    out["reader_warm_s"] = time.perf_counter() - t
    runs = [("a", 1, "native"), ("b", 1, "native"), ("c", 1, "native"),
            ("c", 32, "native"), ("e", 1, "native"), ("c", 1, "per_key")]
    for wl, clients, reader in runs:
        phys.advance_micros(1000)
        mems = len(tablet.regular.read_snapshot()[0])
        if reader == "per_key":
            for r_ in tablet.regular.ssts:
                r_._point_readers.clear()
        before = dict(POINT_READ_STATS)
        with flags.overridden("native_point_reader_max_rows",
                              0 if reader == "per_key" else
                              flags.get("native_point_reader_max_rows")):
            r = work.run(wl, ops, clients=clients)
        routes = {k: v - before[k] for k, v in POINT_READ_STATS.items()}
        if reader == "per_key":
            for r_ in tablet.regular.ssts:
                r_._point_readers.clear()        # rebuilt on next use
        line = {"point": wl, "clients": clients, "reader": reader,
                "ops": r.ops, "ops_per_s": r.ops_per_sec,
                "p50_us": float(np.percentile(r.lat_us, 50)),
                "p99_us": float(np.percentile(r.lat_us, 99)),
                "ssts": len(tablet.regular.ssts), "memtables": mems,
                "routes": routes, "card": card}
        out["points"].append(line)
        print(json.dumps(line))
        if reader == "per_key":
            check(routes["find_many_keys"] == 0
                  and routes["per_key_keys"] == r.ops,
                  f"ycsb {wl} per-key run took another route: {routes}")
        elif wl == "c":
            # every key's SST part through find_many; the memtable guard
            # merges unflushed updates (counted), nothing goes per key
            check(routes["per_key_keys"] == 0
                  and routes["find_many_keys"] == r.ops,
                  f"ycsb {wl}/{clients}: not every read was served by "
                  f"find_many: {routes}")
        elif wl == "e":
            # each scan's 11 keys through one range_read call, or through
            # find_many where the snapshot holds more than one memtable
            # (a frozen one waiting for its flush)
            keys = routes["range_read_keys"] + routes["find_many_keys"]
            check(routes["per_key_keys"] == 0 and keys > 0
                  and keys % 11 == 0,
                  f"ycsb e: scans not served by range_read / find_many: "
                  f"{routes}")
    out["point_reader"] = {k: POINT_READ_STATS[k] for k in (
        "readers_built", "reader_build_s", "reader_rows",
        "reader_heap_bytes", "readers_refused")}
    out["point_reader"]["warm_s"] = out["reader_warm_s"]
    print(json.dumps({"point_reader": out["point_reader"], "card": card}))
    steps: dict = {}            # host seconds of the checks between runs
    t_step = [time.perf_counter()]

    def step(label):
        now = time.perf_counter()
        steps[label] = now - t_step[0]
        t_step[0] = now
    tablet.flush()
    upd = sorted(work.updated_keys)
    got = tablet.multi_read("usertable", [{"ycsb_key": k} for k in upd])
    bad = [k for k, g in zip(upd, got)
           if g is None or any(g[f"field{i}"] != "u" * 100
                               for i in range(10))]
    check(not bad, f"ycsb: {len(bad)} updated keys lost their update, "
          f"e.g. {bad[:5]}")
    check(len(upd) > 0, "ycsb: no update ran")
    step("flush_and_read_back_updates")
    print(json.dumps({"flush_apply": dict(ptablet.FLUSH_APPLY_STATS),
                      "card": card}))
    # YCQL USING TTL: half the upserts expire before the history cutoff
    rng = np.random.default_rng(seed + 2)
    keys = rng.integers(0, rows, ttl_upserts)
    short = rng.random(ttl_upserts) < 0.5
    last: dict = {}
    t = time.perf_counter()
    for i, (k, s) in enumerate(zip(keys.tolist(), short.tolist())):
        if i % 1000 == 0:
            phys.advance_micros(1000)
        ttl_ms = 1_000 if s else 10_000_000
        val = f"{i:09d}" + "t" * 91
        tablet.apply_write(WriteRequest("usertable", [RowOp(
            "upsert", {"ycsb_key": k,
                       **{f"field{j}": val for j in range(10)}},
            ttl_ms=ttl_ms)]))
        last[k] = (val, tablet.clock.now().value, ttl_ms)
    ttl_s = time.perf_counter() - t
    step("ttl_upserts")
    tablet.flush()
    # the cutoff: past every short TTL, before every long one
    phys.advance_micros(
        (flags.get("history_retention_interval_sec") + 3_600) * 1_000_000)
    cutoff = tablet.history_cutoff()
    copy = os.path.join(root, "baseline")
    shutil.copytree(tablet.regular.dir, copy)
    inputs = sum(r.num_entries for r in tablet.regular.ssts)
    step("flush_and_copy")
    captured: dict = {}
    orig_runs = pcomp.compact_runs

    def capture(runs, cut, device):
        captured["runs"], captured["cutoff"] = runs, cut
        return orig_runs(runs, cut, device=device)
    calls = pops.MERGE_GC_STATS["calls"]
    pcomp.compact_runs = capture
    try:
        t = time.perf_counter()
        tablet.compact()
        if cuda:
            torch.cuda.synchronize()
        compact_s = time.perf_counter() - t
    finally:
        pcomp.compact_runs = orig_runs
    step("compact")
    launches = pops.MERGE_GC_STATS["calls"] - calls
    check(launches == 1 and "runs" in captured,
          f"ycsb: Tablet.compact ran merge_gc_split {launches} times")
    codec = tablet.codec
    base = LsmStore(copy, name="regular",
                    columnar_builder=codec.columnar_builder,
                    row_decoder=codec.row_decoder,
                    key_builder=codec.derive_keys)
    t = time.perf_counter()
    pcomp.tpu_compact(base, codec, cutoff, backend="baseline",
                      device="cpu")
    baseline_s = time.perf_counter() - t
    step("cpu_feed")
    got = list(tablet.regular.iterate())
    want = list(base.iterate())
    check(got == want, "ycsb: _compact_rows and the CPU feed disagree "
          f"({len(got)} against {len(want)} entries)")
    step("compare_entries")
    # every key's last TTL'd write: the long ones read back, the short
    # ones are gone unless an older version is still visible
    now = tablet.clock.now().value
    sample = sorted(last)[:2000]
    rows_back = tablet.multi_read("usertable",
                                  [{"ycsb_key": k} for k in sample],
                                  read_ht=now)
    for k, r in zip(sample, rows_back):
        val, _, ttl_ms = last[k]
        if ttl_ms > 1_000:
            check(r is not None and r["field0"] == val,
                  f"ycsb: TTL'd key {k} lost its write")
        else:
            check(r is None, f"ycsb: key {k} outlived its TTL: {r}")
    step("read_back_ttl")
    # merge_gc_split on the card at this compaction's shape, against its
    # CPU run and its byte bound
    dk, ht, wid, tomb = pops.concat_runs(captured["runs"])
    words = pops.keys_to_words(dk)
    n = len(ht)
    order_c, keep_c = pops.run_merge_gc(words, ht, wid, tomb,
                                        captured["cutoff"], device="cpu")
    order_g, keep_g = pops.run_merge_gc(words, ht, wid, tomb,
                                        captured["cutoff"], device=device)
    check(np.array_equal(order_g, order_c) and np.array_equal(keep_g, keep_c),
          "ycsb: merge_gc_split on the card disagrees with its CPU run")
    step("merge_gc_split_against_cpu")
    line = {"row_compaction": "ycsb", "entries_in": inputs,
            "entries_out": len(got), "ttl_upserts": ttl_upserts,
            "ttl_upserts_s": ttl_s, "compact_s": compact_s,
            "baseline_s": baseline_s, "dk_words": int(words.shape[1]),
            "order_keep_equal_cpu": True, "launches": launches,
            "card": card}
    if cuda:
        pad = pops._pad_rows(n)
        valid = np.zeros(pad, bool)
        valid[:n] = True

        def padded(a, dt):
            o = np.zeros((pad,) + a.shape[1:], dt)
            o[:n] = a
            return o
        lanes = pops.to_device_lanes(padded(words, np.uint64),
                                     padded(ht, np.uint64),
                                     padded(wid, np.uint32),
                                     padded(tomb, bool), valid,
                                     torch.device(device))
        cut = captured["cutoff"]
        line["ms"] = cuda_ms(torch, lambda: pops.merge_gc_split_kernel(
            *lanes, cut), 5)
        # what the function needs for this run's n entries (the padding
        # rows are not its work): each key word and ht read once as 8
        # bytes, the u32 write id, the tombstone byte; order (int32, as
        # run_merge_gc returns it) and keep written once
        moved = n * (8 * words.shape[1] + 8 + 4 + 1 + 4 + 1)
        line["bound_ms"], line["bound_by"] = bound(moved, 0)
        line["rows"], line["rows_padded"] = n, pad
        step("merge_gc_split_timing")
    line["steps_s"] = steps
    out["row_compaction"] = line
    print(json.dumps(line))
    out["flush_apply"] = dict(ptablet.FLUSH_APPLY_STATS)
    # --- phase 11 (c): maintenance on this tablet, then colocation --------
    t = time.perf_counter()
    dead = np.zeros(rows, bool)
    dead[list(last)] = True           # every TTL'd key expires below
    out["maintenance"] = maintenance_steps(
        np, tablet, phys, work, dead, root, card, device, *maint)
    out["maintenance_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["colocation"] = colocation_steps(np, root, card, device, seed,
                                         *colo)
    out["colocation_s"] = time.perf_counter() - t
    with open(os.path.join(root, "run.json"), "w") as f:
        json.dump(out, f)


def _card_aggregate(np, tablet, alive, what: str, base: int = 0) -> dict:
    """count(*), min and max of ycsb_key through Tablet.read: served on
    the card (backend "tpu") and equal to numpy over the live keys
    (`alive[i]`: key base + i is live)."""
    from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
    from yugabyte_db_tpu_torch.ops.scan import AggSpec
    t = time.perf_counter()
    r = tablet.read(ReadRequest("usertable", aggregates=(
        AggSpec("count"), AggSpec("min", ("col", 0)),
        AggSpec("max", ("col", 0)))))
    s = time.perf_counter() - t
    got = [int(np.asarray(v).reshape(-1)[0]) for v in r.agg_values]
    live = np.nonzero(alive)[0] + base
    want = [len(live), int(live[0]), int(live[-1])]
    check(r.backend == "tpu", f"{what}: the aggregate ran on "
          f"{r.backend}, not the card")
    check(got == want, f"{what}: count/min/max {got} != numpy {want}")
    return {"agg": got, "agg_backend": r.backend, "agg_s": s}


def _usertable_v2(history: bool):
    """The usertable after ALTER TABLE ADD COLUMN field10 (nullable),
    version 2; with `history`, version 1 as its schema history."""
    from yugabyte_db_tpu_torch.docdb.table_codec import TableInfo
    from yugabyte_db_tpu_torch.dockv import packed_row as pr
    from yugabyte_db_tpu_torch.models import ycsb
    info = ycsb.usertable_info()
    cols = info.schema.columns + (
        pr.ColumnSchema(11, "field10", pr.ColumnType.STRING),)
    return TableInfo(info.table_id, info.name, pr.TableSchema(cols, 2),
                     info.partition_schema,
                     schema_history=(info.schema,) if history else ())


def maintenance_steps(np, tablet, phys, work, dead, root, card, device,
                      n_upserts, n_sample, n_fresh, e_ops) -> list:
    """Phase 11 (c) on config 1's tablet after its row compaction, each
    step timed and followed by a count/min/max aggregate on the card
    against numpy: (0) the clock passes every TTL and Tablet.compact()
    drops the expired rows (so every block has its columnar sidecar);
    (1) ALTER TABLE adds a nullable field10, `n_upserts` upserts at
    version 2, old rows read field10 None and new rows their value;
    (2) Tablet.compact() repacks through RepackingCompactionFeed (every
    block at version 2), then an E pass of `e_ops`; (3) create_snapshot
    and restore_snapshot into a fresh card tablet, `n_sample` keys read
    alike; (4) trim_above_ht on the restored tablet below step 1's
    upserts: those keys read their earlier values; (5) TRUNCATE: the
    sampled keys read None, `n_fresh` fresh rows read back."""
    from yugabyte_db_tpu_torch.docdb.hotpath import POINT_READ_STATS
    from yugabyte_db_tpu_torch.docdb.operations import RowOp, WriteRequest
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils import flags
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridClock
    rng = np.random.default_rng(7)
    rows = len(dead)
    lines = []

    def done(step, t0, **kw):
        line = {"maintenance": step, "s": time.perf_counter() - t0, **kw,
                "card": card}
        lines.append(line)
        print(json.dumps(line))

    updated_before = set(work.updated_keys)   # A/B/E's updates

    def expect_old(k):
        return "u" * 100 if k in updated_before else "x" * 100

    # (0) every TTL expires and the compaction drops the TTL'd rows
    t0 = time.perf_counter()
    phys.advance_micros(
        (10_000 + flags.get("history_retention_interval_sec") + 60)
        * 1_000_000)
    tablet.compact()
    alive = ~dead
    check(all(r.columnar_block(i) is not None for r in tablet.regular.ssts
              for i in range(r.num_blocks())),
          "maintenance: a block kept no columnar sidecar after the TTLs")
    done("settle_ttl", t0, **_card_aggregate(np, tablet, alive, "settle"),
         ssts=len(tablet.regular.ssts))
    # (1) ALTER TABLE ADD COLUMN field10, upserts at version 2
    t0 = time.perf_counter()
    before_ht = tablet.clock.now().value
    alive_before = alive.copy()
    tablet.alter_table(_usertable_v2(history=False))
    keys = np.sort(rng.choice(rows, n_upserts, replace=False))
    for i in range(0, n_upserts, 100):
        tablet.apply_write(WriteRequest("usertable", [RowOp("upsert", {
            "ycsb_key": int(k), **{f"field{j}": f"m{int(k):09d}" + "m" * 90
                                   for j in range(10)},
            "field10": f"f{int(k)}"}) for k in keys[i:i + 100]]))
    alive[keys] = True
    new_s = keys[rng.choice(len(keys), n_sample // 2, replace=False)]
    old_pool = np.nonzero(alive_before)[0]
    old_s = np.setdiff1d(old_pool[rng.choice(len(old_pool), n_sample // 2,
                                             replace=False)], keys)
    got = tablet.multi_read("usertable",
                            [{"ycsb_key": int(k)} for k in new_s])
    check(all(g is not None and g["field10"] == f"f{int(k)}"
              and g["field0"][:10] == f"m{int(k):09d}"
              for k, g in zip(new_s, got)),
          "maintenance: an upsert at version 2 did not read back")
    got = tablet.multi_read("usertable",
                            [{"ycsb_key": int(k)} for k in old_s])
    check(all(g is not None and g["field10"] is None
              and g["field0"] == expect_old(int(k))
              for k, g in zip(old_s, got)),
          "maintenance: a version-1 row read back wrong after the ALTER")
    done("alter_add_column", t0, upserts=n_upserts,
         **_card_aggregate(np, tablet, alive, "alter"))
    # (2) the repacking compaction, then an E pass
    t0 = time.perf_counter()
    check(tablet.codec.info.packings.versions() == [1, 2],
          "maintenance: the ALTER dropped the old packing")
    tablet.compact()
    versions = {r.columnar_block(i).schema_version
                for r in tablet.regular.ssts for i in range(r.num_blocks())}
    check(versions == {2}, f"maintenance: blocks at versions {versions} "
          "after the repacking compaction")
    repack_s = time.perf_counter() - t0
    work.updated_keys = set()         # the keys this pass updates
    before = dict(POINT_READ_STATS)
    r = work.run("e", e_ops)
    routes = {k: v - before[k] for k, v in POINT_READ_STATS.items()}
    # compact() flushed: one memtable at most, so the scans take the
    # fused range read
    check(routes["range_read_calls"] > 0 and routes["per_key_keys"] == 0,
          f"maintenance: the E pass was not served by range_read: {routes}")
    alive[sorted(work.updated_keys)] = True
    done("repack", t0, repack_s=repack_s, block_versions=sorted(versions),
         e_routes=routes, e_ops=r.ops, e_ops_per_s=r.ops_per_sec,
         e_p50_us=float(np.percentile(r.lat_us, 50)),
         e_p99_us=float(np.percentile(r.lat_us, 99)),
         **_card_aggregate(np, tablet, alive, "repack"))
    # (3) snapshot, restore into a fresh card tablet
    t0 = time.perf_counter()
    snap = os.path.join(root, "snapshot")
    tablet.create_snapshot(snap)
    restored = Tablet.restore_snapshot(
        "ycsb_restored", _usertable_v2(history=True), snap,
        os.path.join(root, "restored"), clock=HybridClock(phys),
        device=device)
    sample = rng.choice(rows, n_sample, replace=False)
    probe = [{"ycsb_key": int(k)} for k in sample]
    now = tablet.clock.now().value
    check(restored.multi_read("usertable", probe, read_ht=now)
          == tablet.multi_read("usertable", probe, read_ht=now),
          "maintenance: the restored tablet reads differently")
    done("snapshot_restore", t0,
         **_card_aggregate(np, restored, alive, "restore"))
    # (4) trim the restored tablet below step 1's upserts
    t0 = time.perf_counter()
    dropped = restored.trim_above_ht(before_ht)
    check(dropped >= n_upserts, f"maintenance: trim dropped {dropped}")
    got = restored.multi_read("usertable",
                              [{"ycsb_key": int(k)} for k in new_s])
    check(all((g is None) if not alive_before[k] else
              (g is not None and g["field10"] is None
               and g["field0"] == expect_old(int(k)))
              for k, g in zip(new_s, got)),
          "maintenance: a trimmed key did not read its earlier value")
    done("trim_above_ht", t0, dropped=dropped,
         **_card_aggregate(np, restored, alive_before, "trim"))
    # (5) TRUNCATE, then fresh rows
    t0 = time.perf_counter()
    removed = tablet.truncate_table("usertable")
    check(all(g is None for g in tablet.multi_read("usertable", probe)),
          "maintenance: a key survived the TRUNCATE")
    fresh = np.arange(rows, rows + n_fresh)
    for i in range(0, n_fresh, 500):
        tablet.apply_write(WriteRequest("usertable", [RowOp("upsert", {
            "ycsb_key": int(k), "field0": f"n{int(k)}"})
            for k in fresh[i:i + 500]]))
    tablet.flush()
    got = tablet.multi_read("usertable", [{"ycsb_key": int(k)}
                                          for k in fresh[::97]])
    check(all(g is not None and g["field0"] == f"n{int(k)}"
              for k, g in zip(fresh[::97], got)),
          "maintenance: a write after the TRUNCATE did not read back")
    done("truncate", t0, ssts_removed=removed, fresh_rows=n_fresh,
         **_card_aggregate(np, tablet, np.ones(n_fresh, bool), "truncate",
                           base=rows))
    return lines


def colocation_steps(np, root, card, device, seed, n_user, n_small) -> list:
    """Phase 11 (c), colocation: one colocated card tablet holding the
    usertable (cut to `n_user` rows: colocation is for many small
    tables, and colocated SSTs carry no columnar sidecar, so reads take
    the row path) and a 2-column table of `n_small` rows.  Point and
    range reads on both; ALTER of the small table, then
    Tablet.compact() through ColocatedRepackingFeed; TRUNCATE of the
    small table with the usertable intact."""
    from yugabyte_db_tpu_torch.docdb.operations import (ReadRequest, RowOp,
                                                        WriteRequest)
    from yugabyte_db_tpu_torch.docdb.table_codec import TableInfo
    from yugabyte_db_tpu_torch.dockv import packed_row as pr
    from yugabyte_db_tpu_torch.dockv.partition import PartitionSchema
    from yugabyte_db_tpu_torch.models import ycsb
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils.hybrid_time import (HybridClock,
                                                         MockPhysicalClock)
    C, T = pr.ColumnSchema, pr.ColumnType
    rng = np.random.default_rng(seed + 11)
    lines = []

    def done(step, t0, **kw):
        line = {"colocation": step, "s": time.perf_counter() - t0, **kw,
                "card": card}
        lines.append(line)
        print(json.dumps(line))

    def small_info(version):
        cols = (C(0, "id", T.INT64, is_hash_key=True), C(1, "val", T.INT64))
        if version > 1:
            cols += (C(2, "note", T.STRING),)
        return TableInfo("small", "small", pr.TableSchema(cols, version),
                         PartitionSchema("hash", 1), cotable_id=2)

    t0 = time.perf_counter()
    user = ycsb.usertable_info()
    user = TableInfo(user.table_id, user.name, user.schema,
                     user.partition_schema, cotable_id=1)
    parent = TableInfo("parent", "parent", pr.TableSchema(
        (C(0, "k", T.INT64, is_hash_key=True),), 1),
        PartitionSchema("hash", 1))
    phys = MockPhysicalClock(WRITE_BASE_US)
    t = Tablet("colocated", parent, os.path.join(root, "colocated"),
               clock=HybridClock(phys), colocated=True, device=device)
    t.add_table(user)
    t.add_table(small_info(1))
    for i in range(0, n_user, 1000):
        phys.advance_micros(10)
        t.apply_write(WriteRequest("usertable", [RowOp("upsert", {
            "ycsb_key": k, **{f"field{j}": f"{k:010d}" + "c" * 90
                              for j in range(10)}})
            for k in range(i, min(i + 1000, n_user))]))
    for i in range(0, n_small, 1000):
        t.apply_write(WriteRequest("small", [RowOp("upsert", {
            "id": k, "val": 3 * k}) for k in range(i, min(i + 1000,
                                                          n_small))]))
    t.flush()
    check(all(e.col_offset < 0 for r in t.regular.ssts for e in r.index),
          "colocation: a colocated SST carries a columnar sidecar")
    done("load", t0, usertable_rows=n_user, small_rows=n_small,
         ssts=len(t.regular.ssts), tables=t.tables())

    def reads(step):
        t0 = time.perf_counter()
        ks = rng.integers(0, n_user, 500)
        got = t.multi_read("usertable", [{"ycsb_key": int(k)} for k in ks])
        check(all(g is not None and g["field3"][:10] == f"{int(k):010d}"
                  for k, g in zip(ks, got)),
              f"colocation ({step}): a usertable point read is wrong")
        lo = int(rng.integers(0, n_user - 20))
        rng_rows = t.read(ReadRequest("usertable", columns=("ycsb_key",),
                                      where=("between", ("col", 0),
                                             ("const", lo),
                                             ("const", lo + 10)))).rows
        check(sorted(r["ycsb_key"] for r in rng_rows)
              == list(range(lo, lo + 11)),
              f"colocation ({step}): the usertable range read is wrong")
        ks = rng.integers(0, n_small, 500)
        got = t.multi_read("small", [{"id": int(k)} for k in ks])
        small_ok = all(g is not None and g["val"] == 3 * int(k)
                       for k, g in zip(ks, got))
        lo = int(rng.integers(0, n_small - 20))
        small_range = t.read(ReadRequest("small", where=(
            "between", ("col", 0), ("const", lo), ("const", lo + 10)))).rows
        return (time.perf_counter() - t0, small_ok,
                sorted(r["id"] for r in small_range) == list(
                    range(lo, lo + 11)))

    s, small_ok, small_range_ok = reads("load")
    check(small_ok and small_range_ok, "colocation: a small-table read "
          "is wrong")
    done("reads", time.perf_counter() - s)
    t0 = time.perf_counter()
    t.alter_table(small_info(2))
    for i in range(0, 1000, 500):
        t.apply_write(WriteRequest("small", [RowOp("upsert", {
            "id": n_small + k, "val": k, "note": f"n{k}"})
            for k in range(i, i + 500)]))
    phys.advance_micros(10)
    t.compact()
    codec = t.codecs["small"]
    prefix = codec.scan_prefix()
    versions = set()
    for k, v in t.regular.iterate(lower=prefix):
        if not k.startswith(prefix):
            break
        versions.add(codec.info.packings.version_of(v, 1))
    check(versions == {2}, f"colocation: the small table's rows are at "
          f"versions {versions} after the repacking compaction")
    got = t.multi_read("small", [{"id": 5}, {"id": n_small + 5}])
    check(got[0]["note"] is None and got[1]["note"] == "n5",
          "colocation: a row of the altered table read back wrong")
    s, small_ok, small_range_ok = reads("alter")
    check(small_ok and small_range_ok, "colocation: a small-table read "
          "is wrong after the repacking compaction")
    done("alter_and_repack", t0, ssts=len(t.regular.ssts))
    t0 = time.perf_counter()
    phys.advance_micros(10)
    n = t.truncate_table("small")
    check(n == n_small + 1000, f"colocation: TRUNCATE tombstoned {n} rows")
    check(t.read(ReadRequest("small")).rows == [],
          "colocation: the truncated table still has rows")
    reads_after = reads("truncate")
    check(not reads_after[1], "colocation: a small-table key survived")
    done("truncate_one_table", t0, tombstoned=n)
    return lines


#: phase 12: BASELINE.json config 5 ("YSQL pgvector: ivfflat build +
#: L2-distance scan over 1M x 768 embeddings"; bench.py:2990-2992: 1024
#: lists, 2 k-means iterations) in one tablet, and a small tablet
VT_CONFIG5 = {"name": "config5", "n": 1_000_000, "dim": 768,
              "nlists": 1024, "iters": 2, "nprobe": 256}
VT_SMALL = {"name": "small", "n": 5_000, "dim": 128, "nlists": 64,
            "iters": 10, "nprobe": 64}
VT_WRITES = (2_000, 1_000, 500)  # inserts, upserts, deletes (frozen ids)
VT_QUERIES = 64                  # single-query searches: base[:64] + 0.001
VT_WRITE_BATCH = 100             # row ops per write request
VT_SMALL_CHURN = 600             # upserts: churn 1,200 >= 5,000 // 5
SPILL_SF = 0.2                   # the string lineitem of dict_q1_str, cut
#                                  from SF1: the interpreted tail takes
#                                  about 12 µs a spilled row, 36 s a route
#                                  at SF1 (3M rows), past phase 12's budget
SPILL_SLOTS = 4                  # 6 (returnflag, linestatus) groups
SPILL_CHUNK_ROWS = 262_144       # streaming_chunk_rows of the streamed
#                                  route: a chunk a block, so SF 0.2's
#                                  five blocks stream (it needs 3 chunks)


def vector_table_info():
    """`(id int64 hashed, emb vector)`: the pgvector table of config 5."""
    from yugabyte_db_tpu_torch.docdb.table_codec import TableInfo
    from yugabyte_db_tpu_torch.dockv import packed_row as pr
    from yugabyte_db_tpu_torch.dockv.partition import PartitionSchema
    C, T = pr.ColumnSchema, pr.ColumnType
    return TableInfo("vt", "vt", pr.TableSchema(
        (C(0, "id", T.INT64, is_hash_key=True), C(1, "emb", T.VECTOR)), 1),
        PartitionSchema("hash", 1))


def _timed_methods(obj, names):
    """Wrap `obj`'s bound methods `names` to add up their host seconds
    (and note when each was first entered); returns (seconds, entered)."""
    spent = {n: 0.0 for n in names}
    entered: dict = {}
    for name in names:
        fn = getattr(obj, name)

        def wrapper(*a, _fn=fn, _name=name, **k):
            t0 = time.perf_counter()
            entered.setdefault(_name, t0)
            try:
                return _fn(*a, **k)
            finally:
                spent[_name] += time.perf_counter() - t0
        setattr(obj, name, wrapper)
    return spent, entered


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def vector_tablet_phase(torch, np, card, seed, root, device="cuda",
                        config=VT_CONFIG5, writes=VT_WRITES,
                        small=VT_SMALL) -> dict:
    """Phase 12a: config 5 in one tablet through the user's entry points
    on `device`: Tablet.bulk_load of the seeded base; build_vector_index
    (ivfflat; the scan, the ANN build on the card and the persist,
    timed apart); VT_QUERIES single-query vector_search calls, each equal
    to the index's own search mapped through pks, recall@10 against
    exact_search over the base on the card; writes through apply_write
    (inserts, upserts and deletes of frozen ids), each written vector
    its own top hit, no deleted id returned, recall against an exact
    search over the live set no more than 0.02 lower, no rebuild due;
    flush, a new Tablet on the directory and bootstrap_vector_indexes:
    the index LOADED (full size, the writes in delta and dead), every
    query answering as before.  Then the small tablet: the no-index
    fallback, HNSW, and a rebuild that folds an outgrown delta.  One
    `vector_tablet` line per tablet; returns the device programs run."""
    import gc
    import shutil
    from yugabyte_db_tpu_torch.docdb.operations import RowOp, WriteRequest
    from yugabyte_db_tpu_torch.ops import vector as pv
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.vector import ivf as pivf
    cuda = torch.device(device).type == "cuda"
    dev = torch.device(device)
    info = vector_table_info()
    k = VECTOR_K
    exact_calls = [0]
    plain_exact = pv.exact_search

    def counted_exact(*a, **kw):
        exact_calls[0] += 1
        return plain_exact(*a, **kw)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def ids_of(hits):
        return [p["id"] for p, _ in hits]

    def recall(got, ref):
        return float(np.mean([len(set(g) & set(r)) / k
                              for g, r in zip(got, ref)]))

    def base_of(cfg):
        gen = torch.Generator(device=dev).manual_seed(seed)
        base_d = torch.randn(cfg["n"], cfg["dim"], generator=gen,
                             device=dev)
        return base_d, base_d.cpu().numpy()

    def load(path, base):
        t = Tablet("vt", info, path, device=dev)
        t0 = time.perf_counter()
        n = t.bulk_load({"id": np.arange(len(base), dtype=np.int64),
                         "emb": base})
        check(n == len(base), f"bulk_load wrote {n} of {len(base)} rows")
        return t, time.perf_counter() - t0

    def search_all(t, qs, nprobe):
        """(ids per query, host ms per call)."""
        out, ms = [], []
        for q in qs:
            t0 = time.perf_counter()
            h = t.vector_search("emb", q, k=k, nprobe=nprobe)
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(ids_of(h))
        return out, ms

    if os.path.exists(root):
        shutil.rmtree(root)
    os.makedirs(root)
    pivf.reset_kernel_stats()
    pv.exact_search = counted_exact
    try:
        # ---- config 5 --------------------------------------------------
        cfg = config
        n, d, nprobe = cfg["n"], cfg["dim"], cfg["nprobe"]
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t_phase = time.perf_counter()
        base_d, base = base_of(cfg)
        path = os.path.join(root, cfg["name"])
        t, load_s = load(path, base)
        sst_mb = t.approximate_size() / 2 ** 20
        cid = info.schema.column_by_name("emb").id
        spent, _ = _timed_methods(t, ("_scan_vectors", "_build_ann",
                                      "_persist_vector_index"))
        t0 = time.perf_counter()
        rows = t.build_vector_index("emb", nlists=cfg["nlists"],
                                    method="ivfflat",
                                    options={"iters": cfg["iters"]})
        sync()
        build_s = time.perf_counter() - t0
        check(rows == n, f"{cfg['name']}: indexed {rows} of {n} rows")
        vdir = t._vecidx_dir(cid)
        for f in ("index.npz", "meta.json", "tablet_meta.msgpack"):
            check(os.path.isfile(os.path.join(vdir, f)),
                  f"{cfg['name']}: the persisted index lacks {f}")
        persist_bytes = _dir_bytes(vdir)
        st = t.vector_indexes[cid]
        idx = st.idx
        pk_ids = np.asarray([p["id"] for p in st.pks], np.int64)
        # (c) single-query searches, each the index's own answer; the
        # first search makes the index's device twin (the bf16 base)
        qs = base[:VT_QUERIES] + 0.001
        t0 = time.perf_counter()
        t.vector_search("emb", qs[0], k=k, nprobe=nprobe)
        first_ms = (time.perf_counter() - t0) * 1e3
        before, lat = search_all(t, qs, nprobe)
        for i, q in enumerate(qs):
            _, own = idx.search(q, k=k, nprobe=nprobe)
            check(before[i] == [int(pk_ids[j]) for j in own[0] if j >= 0],
                  f"{cfg['name']}: vector_search {i} is not the index's "
                  f"own search")
        search_s = sum(lat) / 1e3
        q_d = torch.from_numpy(qs).to(dev)
        _, ref = plain_exact(q_d, base_d, k)
        recall_before = recall(before, ref.cpu().numpy())
        # beside it, against the f32 answer (phase 9's reference)
        dist = ((q_d * q_d).sum(1)[:, None] + pv.sq_norms(base_d)[None, :]
                - 2.0 * pv.mm_f32(q_d, base_d))
        recall_f32 = recall(before, torch.topk(-dist, k, dim=1)
                            .indices.cpu().numpy())
        del dist
        dv = idx._device_arrays()
        k_eff, pool = idx.device_plan(k, nprobe)
        q1 = q_d[:1]
        dev_ms = cuda_ms(torch, lambda: pivf.two_stage_search(
            q1, dv["cent"], dv["row_list"], dv["vecs"], dv["norms"], k_eff,
            nprobe, pool), 5, warmup=2, rounds=3) if cuda else None
        search_bound_ms = (dv["vecs"].numel() * dv["vecs"].element_size()
                           + 8 * n + 4 * d) / HBM_BYTES_PER_S * 1e3
        # (d) writes through apply_write
        n_ins, n_up, n_del = writes
        rng = np.random.default_rng(seed + 12)
        ins_ids = np.arange(n, n + n_ins, dtype=np.int64)
        ins_vecs = rng.normal(size=(n_ins, d)).astype(np.float32)
        touched = rng.permutation(np.arange(VT_QUERIES, n))[:n_up + n_del]
        up_ids, del_ids = touched[:n_up], touched[n_up:]
        up_vecs = rng.normal(size=(n_up, d)).astype(np.float32)
        ops = ([RowOp("insert", {"id": int(i), "emb": v.tobytes()})
                for i, v in zip(ins_ids, ins_vecs)]
               + [RowOp("upsert", {"id": int(i), "emb": v.tobytes()})
                  for i, v in zip(up_ids, up_vecs)]
               + [RowOp("delete", {"id": int(i)}) for i in del_ids])
        t0 = time.perf_counter()
        for b in range(0, len(ops), VT_WRITE_BATCH):
            t.apply_write(WriteRequest("vt", ops[b:b + VT_WRITE_BATCH]))
        apply_s = time.perf_counter() - t0
        want_delta = {(int(i),) for i in np.concatenate([ins_ids, up_ids])}
        want_dead = {(int(i),) for i in np.concatenate([up_ids, del_ids])}
        check(set(st.delta) == want_delta and st.dead == want_dead,
              f"{cfg['name']}: delta/dead after the writes "
              f"{len(st.delta)}/{len(st.dead)}")
        deleted = set(int(i) for i in del_ids)
        self_q = np.concatenate([ins_vecs, up_vecs])
        self_ids = np.concatenate([ins_ids, up_ids])
        t0 = time.perf_counter()
        self_hits, self_lat = search_all(t, self_q, nprobe)
        self_s = time.perf_counter() - t0
        for i, h in zip(self_ids, self_hits):
            check(h[0] == int(i), f"{cfg['name']}: written id {i} is not "
                  f"its own top hit ({h[:3]})")
            check(not deleted & set(h), f"{cfg['name']}: a deleted id "
                  f"was returned")
        after, _ = search_all(t, qs, nprobe)
        check(not any(deleted & set(h) for h in after),
              f"{cfg['name']}: a deleted id was returned")
        live = base_d.clone()
        live[torch.from_numpy(up_ids).to(dev)] = \
            torch.from_numpy(up_vecs).to(dev)
        keep = np.ones(n, bool)
        keep[del_ids] = False
        live = torch.cat([live[torch.from_numpy(keep).to(dev)],
                          torch.from_numpy(ins_vecs).to(dev)])
        live_ids = np.concatenate([np.nonzero(keep)[0], ins_ids])
        _, ref2 = plain_exact(q_d, live, k)
        del live
        recall_after = recall(after, live_ids[ref2.cpu().numpy()])
        check(recall_after >= recall_before - 0.02,
              f"{cfg['name']}: recall after the writes {recall_after} vs "
              f"{recall_before}")
        check(t.maybe_rebuild_vector_indexes() == 0,
              f"{cfg['name']}: a rebuild ran below the churn threshold")
        # (e) restart: flush, a new Tablet on the directory, bootstrap
        t0 = time.perf_counter()
        t.flush()
        flush_s = time.perf_counter() - t0
        del t, st, idx, dv, q1
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t = Tablet("vt", info, path, device=dev)
        spent2, entered2 = _timed_methods(t, ("_scan_vectors",))
        t0 = time.perf_counter()
        restored = t.bootstrap_vector_indexes()
        boot_s = time.perf_counter() - t0
        boot_load_s = entered2.get("_scan_vectors", t0 + boot_s) - t0
        check(restored == 1, f"{cfg['name']}: bootstrap restored "
              f"{restored}")
        st = t.vector_indexes[cid]
        check(st.idx.size == n and len(st.pks) == n,
              f"{cfg['name']}: the index was rebuilt, not loaded "
              f"(size {st.idx.size})")
        check(set(st.delta) == want_delta and st.dead == want_dead,
              f"{cfg['name']}: delta/dead after the restart "
              f"{len(st.delta)}/{len(st.dead)}")
        again, _ = search_all(t, qs, nprobe)
        check(again == after, f"{cfg['name']}: answers moved across the "
              f"restart")
        self_again, _ = search_all(t, self_q, nprobe)
        check(self_again == self_hits, f"{cfg['name']}: the written "
              f"vectors' answers moved across the restart")
        peak = torch.cuda.max_memory_allocated() if cuda else None
        lat_all = np.asarray(lat)
        print(json.dumps({
            "vector_tablet": cfg["name"], "card": card, "rows": n,
            "dim": d, "method": "ivfflat", "nlists": cfg["nlists"],
            "iters": cfg["iters"], "nprobe": nprobe, "k": k,
            "load_s": load_s, "sst_mb": sst_mb,
            "build_s": build_s, "scan_s": spent["_scan_vectors"],
            "ann_build_s": spent["_build_ann"],
            "persist_s": spent["_persist_vector_index"],
            "persist_bytes": persist_bytes,
            "first_search_ms": first_ms,
            "search_p50_ms": float(np.percentile(lat_all, 50)),
            "search_p99_ms": float(np.percentile(lat_all, 99)),
            "search_qps": len(lat) / search_s,
            "device_ms_per_search": dev_ms,
            "device_bound_ms": search_bound_ms,
            "recall_at_10_before": recall_before,
            "recall_at_10_f32_before": recall_f32,
            "recall_at_10_after": recall_after,
            "writes": len(ops), "apply_s": apply_s,
            "self_queries": len(self_q), "self_queries_s": self_s,
            "self_p50_ms": float(np.percentile(self_lat, 50)),
            "flush_s": flush_s, "bootstrap_s": boot_s,
            "bootstrap_load_s": boot_load_s,
            "bootstrap_scan_diff_s": boot_s - boot_load_s,
            "bootstrap_scan_s": spent2["_scan_vectors"],
            "delta": len(st.delta), "dead": len(st.dead),
            "peak_device_bytes": peak,
            "wall_s": time.perf_counter() - t_phase}))
        del t, st, base_d, base, q_d, ref, ref2
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        shutil.rmtree(path)

        # ---- the small tablet -------------------------------------------
        cfg = small
        n, nprobe = cfg["n"], cfg["nprobe"]
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t_phase = time.perf_counter()
        base_d, base = base_of(cfg)
        t, load_s = load(os.path.join(root, cfg["name"]), base)
        qs = base[:VT_QUERIES] + 0.001
        dist = ((qs * qs).sum(1)[:, None] + (base * base).sum(1)[None, :]
                - 2.0 * qs @ base.T)
        ref = np.argsort(dist, axis=1)[:, :k]
        # no index: an exact search over a fresh scan, on the card
        t0 = time.perf_counter()
        fallback, _ = search_all(t, qs[:8], nprobe)
        fallback_ms = (time.perf_counter() - t0) / 8 * 1e3
        check([h[0] for h in fallback] == list(range(8)),
              "small: the no-index fallback's top hits")
        fallback_recall = float(np.mean([len(set(g) & set(r)) / k for g, r
                                         in zip(fallback, ref[:8])]))
        # HNSW (m 16, ef_construction 100), on the host
        t0 = time.perf_counter()
        t.build_vector_index("emb", method="hnsw",
                             options={"m": 16, "ef_construction": 100})
        hnsw_build_s = time.perf_counter() - t0
        cid = info.schema.column_by_name("emb").id
        with open(os.path.join(t._vecidx_dir(cid), "meta.json")) as f:
            hnsw_opts = json.load(f)["options"]
        check(t.vector_indexes[cid].options == {
            "m": 16, "ef_construction": 100, "lists": 100}
              and hnsw_opts == {"m": 16, "ef_construction": 100,
                                "ef_search": 64},
              f"small: the HNSW index's persisted options {hnsw_opts}")
        hnsw, hnsw_lat = search_all(t, qs, nprobe)
        st = t.vector_indexes[cid]
        pk_ids = np.asarray([p["id"] for p in st.pks], np.int64)
        for i, q in enumerate(qs):
            _, own = st.idx.search(q, k=k)
            check(hnsw[i] == [int(pk_ids[j]) for j in own[0] if j >= 0],
                  f"small: HNSW vector_search {i} is not the index's own "
                  f"search")
        hnsw_recall = recall(hnsw, ref)
        # ivfflat, then a rebuild that folds an outgrown delta
        t0 = time.perf_counter()
        t.build_vector_index("emb", nlists=cfg["nlists"], method="ivfflat",
                             options={"iters": cfg["iters"]})
        sync()
        ivf_build_s = time.perf_counter() - t0
        rng = np.random.default_rng(seed + 13)
        churn = rng.permutation(np.arange(VT_QUERIES, n))[:VT_SMALL_CHURN]
        churn_vecs = rng.normal(size=(len(churn), cfg["dim"])).astype(
            np.float32)
        t.apply_write(WriteRequest("vt", [
            RowOp("upsert", {"id": int(i), "emb": v.tobytes()})
            for i, v in zip(churn, churn_vecs)]))
        probe_q = np.concatenate([qs, churn_vecs])
        pre, _ = search_all(t, probe_q, nprobe)
        t0 = time.perf_counter()
        check(t.maybe_rebuild_vector_indexes() == 1,
              "small: the outgrown delta was not folded")
        fold_s = time.perf_counter() - t0
        st = t.vector_indexes[cid]
        check(not st.delta and not st.dead and len(st.pks) == n,
              f"small: after the fold delta {len(st.delta)}, dead "
              f"{len(st.dead)}, pks {len(st.pks)}")
        post, post_lat = search_all(t, probe_q, nprobe)
        # every top hit (a query's own row) stays; below it the answers
        # may move: before the fold the search over-fetched past 600
        # dead rows (a 4,096-row pool), after it the pool is 64 rows
        # picked by bf16 products, and the delta's distances were bf16
        check([a[0] for a in pre] == [b[0] for b in post],
              "small: the fold moved a top hit")
        fold_overlap = float(np.mean([len(set(a) & set(b)) / k
                                      for a, b in zip(pre, post)]))
        check([h[0] for h in post[VT_QUERIES:]] == [int(i) for i in churn],
              "small: an upserted vector is not its own top hit")
        peak = torch.cuda.max_memory_allocated() if cuda else None
        print(json.dumps({
            "vector_tablet": cfg["name"], "card": card, "rows": n,
            "dim": cfg["dim"], "method": "hnsw, ivfflat",
            "nlists": cfg["nlists"], "nprobe": nprobe, "k": k,
            "load_s": load_s, "sst_mb": t.approximate_size() / 2 ** 20,
            "fallback_ms": fallback_ms,
            "fallback_recall_at_10": fallback_recall,
            "hnsw_build_s": hnsw_build_s,
            "hnsw_p50_ms": float(np.percentile(hnsw_lat, 50)),
            "hnsw_recall_at_10": hnsw_recall,
            "ivf_build_s": ivf_build_s, "churn": len(churn),
            "fold_s": fold_s, "fold_top10_overlap": fold_overlap,
            "ivf_p50_ms": float(np.percentile(post_lat, 50)),
            "ivf_recall_at_10": recall(post[:VT_QUERIES], ref),
            "delta": len(st.delta), "dead": len(st.dead),
            "peak_device_bytes": peak,
            "wall_s": time.perf_counter() - t_phase}))
        del t, st, base_d
        searches = pivf.kernel_cache_stats()["calls"]
        print(f"[phase 12] vector tablets OK; two-stage searches "
              f"{searches}, exact searches {exact_calls[0]}")
        return {"two_stage_search": searches,
                "exact_search": exact_calls[0]}
    finally:
        pv.exact_search = plain_exact
        shutil.rmtree(root, ignore_errors=True)


def spill_phase(torch, np, data, card, root, device="cuda",
                block_rows=TABLET_BLOCK_ROWS) -> dict:
    """Phase 12b: the grouped spill tail.  The string-flag lineitem of
    dict_q1_str in one tablet on `device`; the string Q1 through
    Tablet.read with a DictGroupSpec of SPILL_SLOTS slots (6 groups need
    8: 3 spill) on the streamed and the monolithic route, each answer
    against a numpy group-by of the rows, GROUPED_STATS' spill merges
    up by one a route and no fallback.  One `spill` line per route;
    returns the dict-grouped programs run."""
    import shutil
    from yugabyte_db_tpu_torch.docdb.operations import (DocReadOperation,
                                                        ReadRequest)
    from yugabyte_db_tpu_torch.models import tpch
    from yugabyte_db_tpu_torch.ops import stream_scan as ss
    from yugabyte_db_tpu_torch.ops.grouped_scan import (GROUPED_STATS,
                                                        DictGroupSpec)
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils import flags
    cuda = torch.device(device).type == "cuda"
    if os.path.exists(root):
        shutil.rmtree(root)
    sdata = tpch.lineitem_str_data(data)
    q = tpch.tpch_q1_str()
    ref = tpch.numpy_reference(q, sdata)
    group = DictGroupSpec(cols=q.group.cols, max_slots=SPILL_SLOTS)
    tail_rows = []
    plain_tail = DocReadOperation._spill_merge_tail

    def counted_tail(self, req, blocks, sel, *a):
        tail_rows.append(len(sel))
        return plain_tail(self, req, blocks, sel, *a)

    launches0 = GROUPED_STATS["launches"]
    out = {}
    try:
        t = Tablet("s", tpch.lineitem_str_info(), root, device=device)
        t0 = time.perf_counter()
        t.bulk_load(sdata, block_rows=block_rows)
        load_s = time.perf_counter() - t0
        DocReadOperation._spill_merge_tail = counted_tail
        for route in ("streamed", "monolithic"):
            merges, fallbacks = (GROUPED_STATS["spill_merges"],
                                 GROUPED_STATS["spill_fallbacks"])
            ss.LAST_STREAM_STATS.clear()
            with flags.overridden("streaming_scan_enabled",
                                  route == "streamed"), \
                    flags.overridden("streaming_chunk_rows",
                                     SPILL_CHUNK_ROWS):
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                resp = t.read(ReadRequest(
                    "lineitem_s", where=q.where, aggregates=q.aggs,
                    group_by=group, read_ht=t.clock.now().value))
                if cuda:
                    torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            check(resp.backend == "tpu", f"spill {route}: served on "
                  f"{resp.backend}")
            chunks = ss.LAST_STREAM_STATS.get("chunks", 0)
            check((chunks >= 3) == (route == "streamed"),
                  f"spill {route}: {chunks} streamed chunks")
            check((GROUPED_STATS["spill_merges"],
                   GROUPED_STATS["spill_fallbacks"]) ==
                  (merges + 1, fallbacks),
                  f"spill {route}: merges/fallbacks "
                  f"{GROUPED_STATS['spill_merges'] - merges}/"
                  f"{GROUPED_STATS['spill_fallbacks'] - fallbacks}")
            got = {(a, b): i for i, (a, b) in
                   enumerate(zip(*resp.group_values))}
            check(set(got) == set(ref), f"spill {route}: groups "
                  f"{sorted(got)}")
            for key, i in got.items():
                qsum, psum, cnt = ref[key]
                check(int(resp.group_counts[i]) == cnt,
                      f"spill {route}: count of {key}")
                check(float(resp.agg_values[0][i]) == qsum,
                      f"spill {route}: l_quantity sum of {key}")
                check(abs(float(resp.agg_values[1][i]) - psum)
                      <= 1e-9 * abs(psum),
                      f"spill {route}: l_extendedprice sum of {key}")
            out[route] = wall_ms
            print(json.dumps({
                "spill": route, "card": card,
                "rows": len(sdata["rowid"]), "groups": len(got),
                "slots": SPILL_SLOTS, "chunks": chunks, "wall_ms": wall_ms,
                "tail_rows": tail_rows[-1], "load_s": load_s}))
    finally:
        DocReadOperation._spill_merge_tail = plain_tail
        shutil.rmtree(root, ignore_errors=True)
    print("[phase 12] spill tail OK on both routes")
    return {"dict_group_program": GROUPED_STATS["launches"] - launches0}


#: phase 13: bench.py doc_scan_bench's documents (models/docbench.py)
DOC_ROWS = 1_000_000             # BENCH_DOC_ROWS
DOC_BLOCK_ROWS = 65_536          # 16 blocks
DOC_ITERS = 5                    # timed warm bench queries (median)
DOC_UPSERTS = 20_000             # documents rewritten before compaction
DOC_WRITE_BATCH = 1_000          # row ops per write request
DOC_SAMPLES = 2_000              # get_row checks after compaction
DOC_ORACLES = 6                  # interpreted-path processes at once
CIPHER_NAMES = {1: "blake2b", 2: "aes_ctr"}


def _doc_shapes(db, AggSpec):
    """{name: read request kwargs} of phase 13's doc shapes."""
    def j(*path):
        node = ("col", db.DOC_COL)
        for key in path:
            node = ("json", "text", node, key)
        return node
    w, aggs = db.doc_qty_query()
    qty = ("fn", "cast_bigint", j("qty"))
    return {
        "bench": dict(where=w, aggregates=aggs),
        "tag": dict(where=("cmp", "eq", j("tag"), ("const", "beta")),
                    aggregates=(AggSpec("count"), AggSpec("sum", qty))),
        "region": dict(where=("cmp", "eq", j("meta", "region"),
                              ("const", "eu")),
                       aggregates=(AggSpec("count"),
                                   AggSpec("max", j("tag")))),
        "qty_is_null": dict(where=("isnull", j("qty")),
                            aggregates=(AggSpec("count"),)),
        "rows": dict(where=w, columns=("id", "doc")),
    }


def _answer(np, resp) -> dict:
    """A response as plain lists (agg values) or rows, for equality."""
    if resp.agg_values is not None:
        return {"agg": [np.asarray(v).tolist() for v in resp.agg_values]}
    return {"rows": resp.rows}


def doc_oracle_job(directory: str, name: str) -> dict:
    """One phase-13 shape through the interpreted row path: a CPU tablet
    over `directory` (a hard-linked checkpoint) with doc_shred_enabled
    off at read time.  Runs in a process of its own, beside the card's
    reads; returns the answer and the read's seconds."""
    import numpy as np

    from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
    from yugabyte_db_tpu_torch.models import docbench as db
    from yugabyte_db_tpu_torch.ops.scan import AggSpec
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils import flags
    flags.set_flag("doc_shred_enabled", False)
    t = Tablet("docs", db.docs_info(), directory, device="cpu")
    t0 = time.perf_counter()
    resp = t.read(ReadRequest("docs", **_doc_shapes(db, AggSpec)[name]))
    return {"backend": resp.backend, "s": time.perf_counter() - t0,
            **_answer(np, resp)}


def docs_phase(torch, np, hs, card, root, seed=0, device="cuda",
               rows=DOC_ROWS, block_rows=DOC_BLOCK_ROWS,
               upserts=DOC_UPSERTS, samples=DOC_SAMPLES) -> dict:
    """Phase 13: the document store and encryption at rest.  bench.py
    doc_scan_bench's documents (models/docbench.py generate_docs: `rows`
    documents in `block_rows`-row blocks) in one tablet on `device`:
    the shredding bulk load, the bench query on the exact route (warm,
    timed) and its cached batch, more doc shapes (each on the hand route
    too), the keyless bypass, 20,000 upserts + Tablet.compact() and
    sampled get_rows, and an encrypted second tablet.  Every card answer
    is held to the interpreted path's over the same SSTs, run in
    processes of their own on hard-linked checkpoints.  One `docs` line
    per step; returns the hand kernels' launches and the exact route's
    program launches over the phase."""
    import concurrent.futures as cf
    import multiprocessing
    import shutil

    from yugabyte_db_tpu_torch.bypass import BypassIneligible, BypassSession
    from yugabyte_db_tpu_torch.docdb.operations import (ReadRequest, RowOp,
                                                        WriteRequest,
                                                        shared_kernel)
    from yugabyte_db_tpu_torch.docstore import (DOC_STATS, DOC_WRITE_STATS,
                                                LAST_DOC_STATS)
    from yugabyte_db_tpu_torch.models import docbench as db
    from yugabyte_db_tpu_torch.ops.scan import AggSpec, ScanKernel
    from yugabyte_db_tpu_torch.storage import sst as psst
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.tablet import tablet as tablet_mod
    from yugabyte_db_tpu_torch.utils import encryption, flags
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed_read(t, **kw):
        sync()
        t0 = time.perf_counter()
        resp = t.read(ReadRequest("docs", **kw))
        sync()
        return resp, time.perf_counter() - t0

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    shapes = _doc_shapes(db, AggSpec)
    hand0 = dict(hs.LAUNCHES)
    # the exact route's program calls: ScanKernel._get hands out the
    # compiled program; count each call of it over the phase
    programs = [0]
    plain_get = ScanKernel._get

    def counted_get(self, *a, **k):
        fn = plain_get(self, *a, **k)

        def run(*x, **y):
            programs[0] += 1
            return fn(*x, **y)
        return run
    # per-path shredded bytes: each SST writer's lane stats at finish
    path_bytes: dict = {}
    plain_finish = psst.SstWriter.finish

    def counted_finish(self):
        for p, e in self.lane_stats.get("shred_paths", {}).items():
            acc = path_bytes.setdefault(p, {"kind": e["kind"], "bytes": 0,
                                            "present": 0})
            acc["bytes"] += e["bytes"]
            acc["present"] += e["present"]
        return plain_finish(self)
    key_state = (dict(encryption.KEY_MANAGER.keys),
                 encryption.KEY_MANAGER.active)
    pool = cf.ProcessPoolExecutor(
        max_workers=DOC_ORACLES,
        mp_context=multiprocessing.get_context("spawn"))
    out = {}
    done = False
    try:
        ScanKernel._get = counted_get
        psst.SstWriter.finish = counted_finish

        # --- 1. the shredding bulk load ---------------------------------
        t0 = time.perf_counter()
        docs = db.generate_docs(rows, seed)
        gen_s = time.perf_counter() - t0
        raw_json = int(sum(len(d) for d in docs["doc"]))
        t = Tablet("docs", db.docs_info(), os.path.join(root, "plain"),
                   device=device)
        w0 = dict(DOC_WRITE_STATS)
        t0 = time.perf_counter()
        check(t.bulk_load(docs, block_rows=block_rows) == rows,
              "docs: bulk load row count")
        load_s = time.perf_counter() - t0
        wstats = {k: v - w0[k] for k, v in DOC_WRITE_STATS.items()}
        n_blocks = -(-rows // block_rows)
        check(wstats["blocks_shredded"] == n_blocks,
              f"docs: {wstats} shredded blocks of {n_blocks}")
        print(json.dumps({"docs": "load", "card": card, "rows": rows,
                          "blocks": n_blocks, "generate_s": gen_s,
                          "load_s": load_s, "rows_per_s": rows / load_s,
                          "doc_write_stats": wstats,
                          "raw_json_bytes": raw_json,
                          "sst_bytes": t.approximate_size(),
                          "shredded_paths": path_bytes}))
        # the interpreted answers, in processes of their own over a
        # hard-linked checkpoint, beside the card's reads
        t.create_snapshot(os.path.join(root, "oracle0"))
        oracle = {name: pool.submit(doc_oracle_job,
                                    os.path.join(root, "oracle0"), name)
                  for name in shapes}

        # --- 2. the bench query on the exact route ----------------------
        kern = shared_kernel(device)
        misses0, hits0 = tablet_mod._DEVICE_CACHE.misses, \
            tablet_mod._DEVICE_CACHE.hits
        first, first_s = timed_read(t, **shapes["bench"])
        check(first.backend == "tpu", f"docs: bench on {first.backend}")
        check(LAST_DOC_STATS.get("coverage", 0) > 0,
              f"docs: coverage {LAST_DOC_STATS}")
        coverage = dict(LAST_DOC_STATS)
        walls = []
        for _ in range(DOC_ITERS):
            resp, s = timed_read(t, **shapes["bench"])
            check(_answer(np, resp) == _answer(np, first),
                  "docs: warm bench answer changed")
            walls.append(s)
        bench_s = statistics.median(walls)
        if cuda:       # device busy and idle share of the warm query
            problems = profile_route(
                torch, hs, "docs_bench_exact", card, rows,
                lambda: t.read(ReadRequest("docs", **shapes["bench"])),
                DOC_ITERS, wall=bench_s)
            check(not problems, "; ".join(problems))

        # --- 3. the batch cache: the warm read reuses the device batch ---
        m1, h1 = tablet_mod._DEVICE_CACHE.misses, tablet_mod._DEVICE_CACHE.hits
        again, _ = timed_read(t, **shapes["bench"])
        m2, h2 = tablet_mod._DEVICE_CACHE.misses, tablet_mod._DEVICE_CACHE.hits
        check(m2 == m1 and h2 == h1 + 1,
              f"docs: warm read built a batch (misses {m1}->{m2}, hits "
              f"{h1}->{h2})")
        print(json.dumps({"docs": "batch_cache", "card": card,
                          "builds_first_read": m1 - misses0,
                          "builds_warm_reads": m2 - m1,
                          "hits_warm_reads": h2 - hits0}))

        # --- 4. more shapes, and the hand route's attempt ----------------
        served = {}
        for name in shapes:
            if name == "bench":
                continue
            resp, s = timed_read(t, **shapes[name])
            check(resp.backend == "tpu", f"docs {name}: on {resp.backend}")
            served[name] = (_answer(np, resp), s)
            resp2, s2 = timed_read(t, **shapes[name])
            check(_answer(np, resp2) == served[name][0],
                  f"docs {name}: warm answer changed")
            served[name] = (served[name][0], s2)
        refusals0 = dict(kern.hand_scan_refusals)
        k3_0 = hs.LAUNCHES["generic_scan"]
        hand = {}
        with flags.overridden("hand_scan_enabled", True):
            for name in ("bench", "tag"):
                resp, s = timed_read(t, **shapes[name])
                got = _answer(np, resp)
                want = _answer(np, first) if name == "bench" \
                    else served[name][0]
                check(got == want, f"docs hand {name}: {got} != {want}")
                hand[name] = s
        k3 = hs.LAUNCHES["generic_scan"] - k3_0
        refused = {r: v - refusals0.get(r, 0)
                   for r, v in kern.hand_scan_refusals.items()
                   if v != refusals0.get(r, 0)}
        print(json.dumps({"docs": "hand_route", "card": card,
                          "shapes": sorted(hand), "k3_launches": k3,
                          "refusals": refused, "wall_s": hand}))

        # --- 5. the keyless bypass --------------------------------------
        with BypassSession([t], device=device) as s:
            sync()
            t0 = time.perf_counter()
            outs, _, bstats = s.scan_aggregate(
                shapes["bench"]["where"], shapes["bench"]["aggregates"])
            sync()
            bypass_s = time.perf_counter() - t0
            tab = t.read(ReadRequest("docs", read_ht=s.read_ht,
                                     **shapes["bench"]))
            # a shape the lanes cannot serve exactly (text order over
            # the int path) refuses typed, before any scan
            try:
                s.scan_aggregate(("cmp", "gt", ("json", "text", (
                    "col", db.DOC_COL), "qty"), ("const", "10")),
                    (AggSpec("count"),))
                refusal = None
            except BypassIneligible as e:
                refusal = {"reason": e.reason, "detail": e.detail}
        check(refusal is not None and refusal["reason"] == "doc_shape",
              f"docs: bypass served a text compare over $.qty: {refusal}")
        check([np.asarray(v).tolist() for v in outs] ==
              _answer(np, tab)["agg"], "docs: bypass != tablet read")
        check(bstats.get("key_rebuilds", 0) == 0,
              f"docs: bypass rebuilt keys {bstats}")
        print(json.dumps({"docs": "bypass", "card": card, "wall_s": bypass_s,
                          "rows_per_s": rows / bypass_s,
                          "path": bstats.get("path"),
                          "key_rebuilds": bstats.get("key_rebuilds"),
                          "typed_refusal": refusal}))

        # the interpreted answers of steps 2 and 4
        interp = {name: f.result() for name, f in oracle.items()}
        for name, got in interp.items():
            check(got["backend"] == "cpu",
                  f"docs oracle {name}: on {got['backend']}")
        want = {k: v for k, v in interp["bench"].items()
                if k in ("agg", "rows")}
        check(_answer(np, first) == want,
              f"docs: bench {_answer(np, first)} != interpreted {want}")
        print(json.dumps({
            "docs": "bench_exact", "card": card, "rows": rows,
            "answer": want["agg"], "first_s": first_s, "warm_s": walls,
            "warm_median_s": bench_s, "rows_per_s": rows / bench_s,
            "interpreted_s": interp["bench"]["s"],
            "interpreted_rows_per_s": rows / interp["bench"]["s"],
            "speedup": interp["bench"]["s"] / bench_s,
            "coverage": coverage}))
        for name, (ans, s) in served.items():
            ref = {k: v for k, v in interp[name].items()
                   if k in ("agg", "rows")}
            check(ans == ref, f"docs {name}: card != interpreted")
            print(json.dumps({
                "docs": "shape", "shape": name, "card": card,
                "warm_s": s, "interpreted_s": interp[name]["s"],
                "answer": ans.get("agg", len(ans.get("rows", ())))}))

        # --- 6. upserts and the compaction on the card --------------------
        rng = np.random.default_rng(seed + 13)
        ids = np.sort(rng.choice(rows, upserts, replace=False))
        written = {}
        for i in ids:
            d = json.loads(docs["doc"][i])
            d["qty"] = int(rng.integers(0, 100))
            written[int(i)] = json.dumps(d)
        t0 = time.perf_counter()
        for lo in range(0, upserts, DOC_WRITE_BATCH):
            t.apply_write(WriteRequest("docs", [
                RowOp("upsert", {"id": int(i), "doc": written[int(i)]})
                for i in ids[lo:lo + DOC_WRITE_BATCH]]))
        write_s = time.perf_counter() - t0
        w0 = dict(DOC_WRITE_STATS)
        t0 = time.perf_counter()
        t.compact()
        sync()
        compact_s = time.perf_counter() - t0
        wstats = {k: v - w0[k] for k, v in DOC_WRITE_STATS.items()}
        (sst,) = t.regular.ssts
        check(all(sst.columnar_block(i).shred.get(db.DOC_COL)
                  for i in range(sst.num_blocks())),
              "docs: a compacted block lost its shredded lanes")
        check(wstats["blocks_shredded"] >= sst.num_blocks(),
              f"docs: compaction shredded {wstats}")
        t.create_snapshot(os.path.join(root, "oracle1"))
        after = pool.submit(doc_oracle_job, os.path.join(root, "oracle1"),
                            "bench")
        compacted, compacted_s = timed_read(t, **shapes["bench"])
        check(compacted.backend == "tpu",
              f"docs: bench after compaction on {compacted.backend}")
        read_ht = t.clock.now().value
        t._read_op._allow_restart = False    # an explicit read point
        sample = rng.choice(rows, samples, replace=False)
        check_ids = list(ids[:samples // 2]) + list(sample[:samples // 2])
        t0 = time.perf_counter()
        for i in check_ids:
            row = t._read_op.get_row({"id": int(i)}, read_ht)
            want_doc = written.get(int(i), docs["doc"][int(i)])
            check(row is not None and row["doc"] == want_doc,
                  f"docs: get_row({int(i)}) != the written JSON")
        get_s = time.perf_counter() - t0

        # --- 7. encryption at rest ----------------------------------------
        version = encryption.KEY_MANAGER.generate_key("docs-smoke")
        with flags.overridden("encrypt_data_at_rest", True):
            te = Tablet("docs", db.docs_info(), os.path.join(root, "enc"),
                        device=device)
            t0 = time.perf_counter()
            te.bulk_load(docs, block_rows=block_rows)
            enc_load_s = time.perf_counter() - t0
        heads = {open(r.path, "rb").read(len(encryption.MAGIC_V2) + 1)
                 for r in te.regular.ssts}
        check(all(h.startswith(encryption.MAGIC_V2) for h in heads),
              f"docs: unencrypted SST {heads}")
        ciphers = sorted(CIPHER_NAMES[h[-1]] for h in heads)
        enc_resp, enc_s = timed_read(te, **shapes["bench"])
        check(_answer(np, enc_resp) == _answer(np, first),
              "docs: encrypted tablet != plain tablet")
        t0 = time.perf_counter()
        cold = Tablet("docs", db.docs_info(), os.path.join(root, "enc"),
                      device=device)
        open_s = time.perf_counter() - t0
        cold_resp, cold_s = timed_read(cold, **shapes["bench"])
        check(_answer(np, cold_resp) == _answer(np, first),
              "docs: cold-opened encrypted tablet != plain tablet")
        print(json.dumps({
            "docs": "encryption", "card": card, "key": version,
            "ciphers": ciphers, "aes_available": encryption.aes_available(),
            "ssts": len(heads), "load_s": enc_load_s,
            "plain_load_s": load_s, "first_read_s": enc_s,
            "cold_open_s": open_s, "cold_first_read_s": cold_s}))

        interp_after = after.result()
        check(interp_after["backend"] == "cpu", "docs oracle after compaction")
        check(_answer(np, compacted)["agg"] == interp_after["agg"],
              f"docs: bench after compaction {_answer(np, compacted)} != "
              f"interpreted {interp_after['agg']}")
        print(json.dumps({
            "docs": "compaction", "card": card, "upserts": upserts,
            "write_s": write_s, "compact_s": compact_s,
            "blocks": sst.num_blocks(), "doc_write_stats": wstats,
            "answer": interp_after["agg"], "first_read_s": compacted_s,
            "interpreted_s": interp_after["s"],
            "get_row_checked": len(check_ids), "get_row_s": get_s}))
        print(json.dumps({"docs": "reasons", "card": card,
                          "doc_stats": DOC_STATS}))
        done = True
    finally:
        ScanKernel._get = plain_get
        psst.SstWriter.finish = plain_finish
        encryption.KEY_MANAGER.keys, encryption.KEY_MANAGER.active = \
            key_state
        if not done:      # a failed check: stop the running oracles
            for p in list((getattr(pool, "_processes", None) or {})
                          .values()):
                if p.is_alive():
                    p.terminate()
        pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(root, ignore_errors=True)
    print("[phase 13] documents and encryption OK")
    out["hand"] = {k: v - hand0.get(k, 0) for k, v in hs.LAUNCHES.items()}
    out["doc_scan"] = programs[0]
    return out


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
    from yugabyte_db_tpu_torch.ops import stream_scan as ss
    from yugabyte_db_tpu_torch.ops.device_batch import (bucket_rows,
                                                        build_batch)
    from yugabyte_db_tpu_torch.ops.scan import ScanKernel
    from yugabyte_db_tpu_torch.utils import flags
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    reps = 20                 # launches per timing window
    t_start = time.perf_counter()
    t_phase = [t_start]

    def phase_time(label):
        """One `phase_s` line: this phase's and the run's seconds so far
        on the host clock (the run is held to a time budget)."""
        now = time.perf_counter()
        print(json.dumps({"phase_s": label, "s": now - t_phase[0],
                          "total_s": now - t_start}))
        t_phase[0] = now

    # --- phase 1: build --------------------------------------------------
    # the point-read path's host extension (g++, Python's headers)
    # builds beside the kernels' nvcc runs
    from concurrent.futures import ThreadPoolExecutor

    from yugabyte_db_tpu_torch.docdb import hotpath

    def build_host_hot():
        t = time.perf_counter()
        hotpath.load()
        return time.perf_counter() - t
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        host_hot = pool.submit(build_host_hot)
        hs.build_cuda_kernels(verbose=True)
        host_hot_s = host_hot.result()
    print(f"[build] nvcc K1+K2+join_probe {time.perf_counter() - t0:.3f} s; "
          f"host_hot (g++) {host_hot_s:.3f} s, {hotpath.library_path()}")
    card = card_line()
    print(card)
    phase_time("1 build")

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
    # the join tables of TPC-H SF1: lineitem's l_orderkey, orders (with
    # o_custkey) and customer
    n_orders = int(tpch.ORDERS_PER_SF * SF)
    ldata = tpch.lineitem_join_data(data, n_orders)
    odata = tpch.generate_orders_cust(n_orders,
                                      int(tpch.CUSTOMERS_PER_SF * SF))
    cdata = tpch.generate_customer(int(tpch.CUSTOMERS_PER_SF * SF))

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

    # the streamed path's chunk bucket: its last chunk (the one padded
    # most), formed as streaming_scan_aggregate forms every chunk
    chunks = ss.plan_chunks(blocks, int(flags.get("streaming_chunk_rows")))
    chunk_bucket = bucket_rows(max(sum(b.n for b in c) for c in chunks))
    chunk_batch = build_batch(chunks[-1], sorted(tpch.TPCH_Q1.columns),
                              device="cuda", pad_to=chunk_bucket)
    for q in (tpch.TPCH_Q6, tpch.TPCH_Q1):
        entry, call = probe.hand_scan_plan(batch, q.where, q.aggs, q.group)
        err = k3_check(entry, call, q.name)
        print(json.dumps({"k3": q.name, **entry.compiled_stats()}))
        c_entry, c_call = probe.hand_scan_plan(chunk_batch, q.where, q.aggs,
                                               q.group)
        c_err = k3_check(c_entry, c_call, f"{q.name} chunk bucket")
        print(json.dumps({"k3_chunk": q.name, "bucket": chunk_bucket,
                          "rows": chunk_batch.n_rows, "max_abs_err": c_err}))
        err = max(err, c_err)
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
            plain_ms=cuda_ms(torch, lambda: entry.plain(*call), reps,
                             queued=False),
            bound_ms=bms, bound_by=bby, library_ms=None))
        if q.group is not None:
            k3_config_sweep(entry, call)
    kernels.append(join_probe_check(torch, np, hs, ldata, odata, cdata,
                                    card, reps))
    print("[phase 2] every kernel agrees with its plain version")
    phase_time("2 kernels (with the main-path data)")

    # --- phase 3: the main path -----------------------------------------
    ref_q6 = tpch.numpy_reference(tpch.TPCH_Q6, data)
    ref_q1 = tpch.numpy_reference(tpch.TPCH_Q1, data)
    ht_read = int(blocks[0].ht[0])

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    def rel(a, b):
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)

    def check_q6(out, what, ref=None):
        r = rel(host(out[0][0]), ref_q6 if ref is None else ref)
        check(r < 1e-5, f"{what}: Q6 relative error {r}")
        return r

    def check_q1(out, what, exact_qty, ref=None):
        counts = host(out[1])
        for g in range(6):
            qsum, psum, cnt = (ref_q1 if ref is None else ref)[g]
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
    routes, scan_registry = tablet_read_shapes(
        torch, np, args.seed, data, blocks, batch, kern, timed, host, rel,
        check_q6, check_q1)
    launches = {k: v for k, v in hs.LAUNCHES.items() if k != "join_probe"}
    per_query = {}
    for key, e in kern._cache.items():
        if key[0] == "hand":
            # one entry per signature: the monolithic bucket and the
            # streamed chunks' bucket count under one kernel name
            name = f"generic_scan[{'q6' if e.G is None else 'q1'}]"
            per_query[name] = per_query.get(name, 0) + e.launches
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the main path: {launches}")
    check(not kern.hand_scan_refusals,
          f"hand route refused: {kern.hand_scan_refusals}")
    print(f"[phase 3] main path OK; launches {launches}")
    for r, v in rates.items():
        print(f"[rate] {r}: {v:.1f} rows/s ({card})")
    phase_time("3 main path")
    baseline_line(torch, np, tpch, blocks, batch, kern, card)
    phase_time("3 baseline")

    # --- phase 4: where the time goes, per route --------------------------
    problems = []
    for route in ("exact", "hand"):
        with flags.overridden("hand_scan_enabled", route == "hand"):
            for q in (Q6, Q1):
                problems += profile_route(
                    torch, hs, f"{route}_{q.name}", card, n,
                    lambda q=q: kern.run(batch, q.where, q.aggs, q.group),
                    PROFILE_ITERS)
    for name, (hand, run, iters) in routes.items():
        with flags.overridden("hand_scan_enabled", hand):
            problems += profile_route(torch, hs, name, card, n, run,
                                       iters)
    check(not problems, "; ".join(problems))
    check(not kern.hand_scan_refusals,
          f"hand route refused: {kern.hand_scan_refusals}")

    phase_time("4 profiles")

    # --- phase 5: LSM compaction on the card ------------------------------
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "compaction_smoke")
    if os.path.exists(root):
        import shutil
        shutil.rmtree(root)
    compaction_phase(torch, np, data, card, root)
    phase_time("5 compaction")

    # --- phase 6: the tablet read seam -----------------------------------
    # (its eight hash tablets stay for phase 10's mesh)
    tablet_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "tablet_smoke")
    kept: dict = {}
    seam = tablet_seam_phase(torch, np, hs, data, card, tablet_root,
                             keep=kept)

    phase_time("6 tablet seam")

    # --- phase 7: joins and fused plans -----------------------------------
    from yugabyte_db_tpu_torch.docdb.operations import (ReadRequest,
                                                        shared_kernel)
    ref_q6 = tpch.numpy_reference(tpch.TPCH_Q6, data)

    def serve_q6(tablet, read_ht, hand):
        """The registry's q6 through Tablet.read on the join tablet."""
        before = hs.LAUNCHES["generic_scan"]
        resp = tablet.read(ReadRequest(
            "lineitem_j", where=tpch.TPCH_Q6.where,
            aggregates=tpch.TPCH_Q6.aggs, read_ht=read_ht))
        check(rel(resp.agg_values[0], ref_q6) < 1e-5,
              f"registry q6 (hand {hand}): {resp.agg_values[0]}")
        k3 = hs.LAUNCHES["generic_scan"] - before
        check((k3 > 0) == hand, f"registry q6 (hand {hand}): K3 ran {k3}")
        return f"{'hand (K3)' if hand else 'exact'}, Tablet.read"
    scan_registry["q6"] = serve_q6
    k3_before = k3_launches_by_query(shared_kernel("cuda"))
    joined = join_phase(
        torch, np, hs, ldata, odata, cdata, card,
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "join_smoke"), scan_registry)
    k3_after = k3_launches_by_query(shared_kernel("cuda"))
    joined.update({k: v - k3_before.get(k, 0) for k, v in k3_after.items()})

    phase_time("7 joins")

    # --- phases 8 and 9: row reads and windows, vectors -------------------
    # the HNSW build is host Python: it runs in a process of its own
    # beside the two phases and is joined in phase 9
    import multiprocessing
    import shutil
    here = os.path.dirname(os.path.abspath(__file__))
    hnsw_root = os.path.join(here, "build", "hnsw_smoke")
    shutil.rmtree(hnsw_root, ignore_errors=True)
    os.makedirs(hnsw_root)
    hnsw_path = os.path.join(hnsw_root, "index")
    hnsw_proc = multiprocessing.get_context("spawn").Process(
        target=hnsw_job, args=(args.seed, hnsw_path), daemon=True)
    hnsw_proc.start()
    try:
        rowed = rows_windows_phase(torch, np, hs, data, card,
                                   os.path.join(here, "build", "rows_smoke"))
        phase_time("8 rows and windows")
        hand_before = dict(hs.LAUNCHES)
        vectored = vectors_phase(torch, np, card, args.seed,
                                 os.path.join(here, "build", "vector_smoke"),
                                 hnsw=(hnsw_proc, hnsw_path))
        vector_hand = {k: v - hand_before.get(k, 0)
                       for k, v in hs.LAUNCHES.items()}
        phase_time("9 vectors")

        # --- phase 10: the multi-device tablet mesh -----------------------
        meshed = mesh_phase(torch, np, hs, data, card, kept["tablets"],
                            kept["read_ht"], args.seed)
        phase_time("10 mesh")
    finally:
        if hnsw_proc.is_alive():
            hnsw_proc.terminate()
        hnsw_proc.join(timeout=30)
        shutil.rmtree(hnsw_root, ignore_errors=True)
        shutil.rmtree(tablet_root, ignore_errors=True)

    # --- phase 11: the write path -----------------------------------------
    # (a) HTAP, then (b) YCSB in a process of its own (its flags stay
    # there): one after the other, so that neither half's host work is
    # timed under the other's
    written = htap_phase(torch, np, hs, data, card,
                         os.path.join(here, "build", "htap_smoke"),
                         seed=args.seed)
    phase_time("11a htap")
    ycsb_root = os.path.join(here, "build", "ycsb_smoke")
    ycsb_proc = multiprocessing.get_context("spawn").Process(
        target=ycsb_job, args=(args.seed, ycsb_root, card), daemon=True)
    ycsb_proc.start()
    try:
        ycsb_proc.join(timeout=900)
        check(ycsb_proc.exitcode == 0,
              f"the YCSB process failed (exit code {ycsb_proc.exitcode})")
        with open(os.path.join(ycsb_root, "run.json")) as f:
            ycsb_run = json.load(f)
    finally:
        if ycsb_proc.is_alive():
            ycsb_proc.terminate()
        ycsb_proc.join(timeout=30)
        shutil.rmtree(ycsb_root, ignore_errors=True)
    # the process ran (b), then (c) maintenance, then the colocated
    # tablet, one after the other: one phase_s line each
    now = time.perf_counter()
    maint_s, colo_s = ycsb_run["maintenance_s"], ycsb_run["colocation_s"]
    for label, sec in (("11b ycsb", now - t_phase[0] - maint_s - colo_s),
                       ("11c maintenance", maint_s),
                       ("11d colocation", colo_s)):
        print(json.dumps({"phase_s": label, "s": sec,
                          "total_s": now - t_start}))
    t_phase[0] = now

    # --- phase 12: the tablet's vector index, and the grouped spill tail --
    hand_before = dict(hs.LAUNCHES)
    vector_tablet = vector_tablet_phase(
        torch, np, card, args.seed,
        os.path.join(here, "build", "vector_tablet_smoke"))
    phase_time("12a vector tablet")
    spilled = spill_phase(torch, np,
                          tpch.generate_lineitem(SPILL_SF, seed=args.seed),
                          card, os.path.join(here, "build", "spill_smoke"))
    vector_tablet_hand = {k: v - hand_before.get(k, 0)
                          for k, v in hs.LAUNCHES.items()}
    phase_time("12b spill tail")

    # --- phase 13: the document store and encryption at rest -------------
    documents = docs_phase(torch, np, hs, card,
                           os.path.join(here, "build", "docs_smoke"),
                           seed=args.seed)
    phase_time("13 documents")

    # --- report ----------------------------------------------------------
    for k in kernels:
        scan_path = launches.get(k["name"], per_query.get(k["name"], 0))
        k["launches_by_path"] = {"scan": scan_path,
                                 "tablet_seam": seam.get(k["name"], 0),
                                 "join": joined.get(k["name"], 0),
                                 "rows_windows": rowed["hand"].get(
                                     k["name"], 0),
                                 "vectors": vector_hand.get(k["name"], 0),
                                 "write_path": written.get(k["name"], 0),
                                 "vector_tablet": vector_tablet_hand.get(
                                     k["name"], 0),
                                 "docs": documents["hand"].get(k["name"],
                                                               0)}
        k["launches"] = sum(k["launches_by_path"].values())
        check(k["launches"] > 0, f"{k['name']} launched 0 times")
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    # the new paths' plain torch programs (no hand kernel): the window
    # program's launches on phase 8's reads, phase 9's device searches
    # and phase 10's slot programs
    programs = [{"name": "window_program", "path": "rows_windows",
                 "source": "yugabyte_db_tpu_torch/ops/window_scan.py",
                 "launches": rowed["window_program"]},
                {"name": "two_stage_search", "path": "vectors",
                 "source": "yugabyte_db_tpu_torch/vector/ivf.py",
                 "launches": vectored["two_stage_search"]},
                {"name": "exact_search", "path": "vectors",
                 "source": "yugabyte_db_tpu_torch/ops/vector.py",
                 "launches": vectored["exact_search"]},
                {"name": "distributed_scan", "path": "mesh",
                 "source": "yugabyte_db_tpu_torch/parallel/"
                           "distributed_scan.py",
                 "launches": meshed["distributed_scan"]},
                {"name": "sharded_exact_search", "path": "mesh",
                 "source": "yugabyte_db_tpu_torch/parallel/vector.py",
                 "launches": meshed["sharded_exact_search"]},
                {"name": "merge_gc_split", "path": "write_path",
                 "source": "yugabyte_db_tpu_torch/ops/compaction.py",
                 "launches": ycsb_run["row_compaction"]["launches"]},
                {"name": "two_stage_search", "path": "vector_tablet",
                 "source": "yugabyte_db_tpu_torch/vector/ivf.py",
                 "launches": vector_tablet["two_stage_search"]},
                {"name": "exact_search", "path": "vector_tablet",
                 "source": "yugabyte_db_tpu_torch/ops/vector.py",
                 "launches": vector_tablet["exact_search"]},
                {"name": "dict_group_program", "path": "vector_tablet",
                 "source": "yugabyte_db_tpu_torch/ops/grouped_scan.py",
                 "launches": spilled["dict_group_program"]},
                {"name": "doc_scan", "path": "docs",
                 "source": "yugabyte_db_tpu_torch/ops/scan.py",
                 "launches": documents["doc_scan"]}]
    check(all(p["launches"] > 0 for p in programs),
          f"a program of the new paths never ran: {programs}")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in kernels],
                      "programs": programs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
