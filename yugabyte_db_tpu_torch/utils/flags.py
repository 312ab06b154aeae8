"""Runtime flags read by the ported paths.

Counterpart of ``yugabyte_db_tpu/utils/flags.py``, cut to the flags the
ported scan, tablet read and write, bypass, join and compaction paths
read, with the reference's defaults.
The registry keeps the reference's get/set_flag surface so call sites
read the same; unknown names raise KeyError."""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Dict


@dataclass
class Flag:
    name: str
    default: Any
    help: str
    value: Any = None


class FlagRegistry:
    def __init__(self):
        self._flags: Dict[str, Flag] = {}
        self._lock = threading.Lock()

    def define(self, name: str, default: Any, help: str = "") -> Flag:
        with self._lock:
            if name not in self._flags:
                self._flags[name] = Flag(name, default, help, default)
            return self._flags[name]

    def get(self, name: str) -> Any:
        return self._flags[name].value

    def set(self, name: str, value: Any) -> None:
        self._flags[name].value = value

    def reset(self, name: str) -> None:
        """Back to the flag's default."""
        f = self._flags[name]
        f.value = f.default


REGISTRY = FlagRegistry()


def get(name: str) -> Any:
    return REGISTRY.get(name)


def set_flag(name: str, value: Any) -> None:
    REGISTRY.set(name, value)


@contextlib.contextmanager
def overridden(name: str, value: Any):
    """Flag `name` set to `value` for the duration of a with-block; the
    previous value comes back on exit, exception or not."""
    old = REGISTRY.get(name)
    REGISTRY.set(name, value)
    try:
        yield
    finally:
        REGISTRY.set(name, old)


REGISTRY.define(
    "hand_scan_enabled", False,
    "Route eligible aggregate scans through the hand-written generic "
    "scan kernel (ops/hand_scan.py, Triton on CUDA) instead of the exact "
    "int64 fixed-point route; f32 compute, so int64 columns stay on the "
    "exact route.  Counterpart of the reference's `tpu_pallas_scan`.")
REGISTRY.define(
    "device_float_dtype", "auto",
    "Device representation of fractional f64 columns: 'auto' keeps f64 "
    "on the CPU and ships f32 on CUDA (SUMs stay exact via the scan "
    "kernel's int64 fixed-point accumulation); 'float32'/'float64' "
    "force one.")
REGISTRY.define(
    "scan_group_strategy", "auto",
    "Grouped-aggregate reduction strategy: 'segment' (scatter-add), "
    "'unroll' (per-group masked reductions), or 'auto' (segment on the "
    "CPU, unroll on CUDA).")
REGISTRY.define(
    "streaming_chunk_rows", 1 << 20,
    "Target rows per streamed scan chunk; the chunk bucket is the pow2 "
    "ceiling, so every chunk of a scan shares one kernel signature.")
REGISTRY.define(
    "grouped_pushdown_enabled", True,
    "Serve GROUP BY over dictionary-encoded (string) columns on the "
    "device (ops/grouped_scan.py); off, streamed dict-grouped scans "
    "decline (streaming_scan_aggregate returns None).")
REGISTRY.define(
    "compaction_chunk_rows", 524288,
    "Frontier capacity (rows) of the pipelined chunked compaction "
    "engine; rounded up to a power of two so every chunk of a bucket "
    "shares one merge shape.")
REGISTRY.define(
    "tpu_pushdown_enabled", True,
    "Route scan/filter/aggregate pushdown to the device execution "
    "backend (the yb_enable_tpu_pushdown analog).  Off, a tablet read "
    "takes the interpreted row path on the host.")
REGISTRY.define(
    "tpu_min_rows_for_pushdown", 4096,
    "Scans smaller than this stay on the interpreted row path: point "
    "reads must never pay a device round-trip.")
REGISTRY.define(
    "streaming_scan_enabled", True,
    "Stream cold aggregate scans as pow2-bucket chunks through the "
    "overlapped batch-formation pipeline (ops/stream_scan.py) instead "
    "of one monolithic padded batch.  Off = the monolithic batch path.")
REGISTRY.define(
    "zone_map_pruning", True,
    "Consult v2 per-block min/max zone maps in the scan pushdown paths "
    "to skip whole blocks whose value ranges cannot satisfy the WHERE "
    "predicate (gated on MVCC chunk-safety so a pruned block can never "
    "hide a newer row version).  Off = every block reaches batch "
    "formation.")
REGISTRY.define(
    "bypass_prefilter_enabled", True,
    "Near-data predicate pre-filter inside the bypass reader: "
    "fixed-width comparison conjuncts evaluate against the encoded "
    "lanes in one native pass (csrc/host_native.cpp prefilter_ranges) "
    "and provably-unmatched rows are dropped before batch formation.  "
    "Result bits are unchanged (the batch keeps the unfiltered bucket "
    "and static-scale bounds).")
REGISTRY.define(
    "max_clock_skew_ms", 500,
    "Clock uncertainty window: reads at a server-assigned read point "
    "restart when they meet records within (read_ht, read_ht + skew].")
REGISTRY.define(
    "history_retention_interval_sec", 900,
    "MVCC history retention before compaction GC "
    "(timestamp_history_retention_interval_sec analog).")
REGISTRY.define(
    "tpu_compaction_enabled", True,
    "Tablet.compact runs the pipelined chunked engine with the merge + "
    "MVCC GC on the card (docdb/compaction.py backend 'device'); off = "
    "the monolithic host baseline.")
REGISTRY.define(
    "join_pushdown_enabled", True,
    "Serve FK-equijoin aggregate requests (ReadRequest.join) on the "
    "device hash join (ops/join_scan.py): the shipped build side becomes "
    "a pow2-bucket open-addressed table, the probe runs inside the fused "
    "plan (ops/plan_fusion.py), and build-side payload columns gather by "
    "match index.  Off, or any shape the device join cannot serve "
    "exactly, is the interpreted row-at-a-time join on the host.")
REGISTRY.define(
    "join_max_build_slots", 65536,
    "Pow2 cap on the device hash-join build table (slots = smallest pow2 "
    ">= 2x build rows, so load factor stays <= 0.5).  Build sides needing "
    "more slots are refused with a typed reason (build_overflow).")
REGISTRY.define(
    "multi_join_max_stages", 4,
    "Max probe stages a multi-join fused plan may carry (an ordered "
    "JoinWire list on one ReadRequest: chains like lineitem JOIN orders "
    "JOIN customer, or stars with several fact-table FKs).  Each stage is "
    "one host-built pow2 hash table probed in turn inside one fused plan "
    "under one shared row mask.  More stages are refused with a typed "
    "reason (join_stage_count).")
REGISTRY.define(
    "window_server_pushdown_enabled", True,
    "Serve window functions server-side over a sorted-scan request shape "
    "(ReadRequest.window through ops/window_scan.py): the tablet sorts its "
    "visible post-WHERE rows by (partition, order) and attaches the window "
    "values.  Ineligible shapes serve plain rows with a typed reason on "
    "the response; off refuses the request shape entirely.")
REGISTRY.define(
    "hash_scan_enumerate_max", 1024,
    "Max enumerable key-target count for answering a short range/IN scan "
    "over a single-integer-hash-PK table by batched point gets (hash "
    "sharding cannot seek key ranges; a small target set is a MultiGet).")
REGISTRY.define(
    "memstore_flush_threshold_bytes", 64 * 1024 * 1024,
    "Memtable size that triggers a flush.")
REGISTRY.define(
    "async_flush_enabled", True,
    "Memtable flushes run on a background flush executor: the apply "
    "thread freezes the active memtable (an in-memory pointer swap) and "
    "returns at once, so an apply never stalls behind an SST write + "
    "fsync.  Off reverts to the inline flush on the apply path "
    "(byte-identical on-disk state either way).")
REGISTRY.define(
    "max_frozen_memtables", 2,
    "Backpressure bound for async flush: once this many frozen "
    "memtables await the background flush executor, the apply thread "
    "drains one inline instead of freezing another (bounded memory).")
