"""YCSB-style workload driver (BASELINE.json config 1: YCSB core
workloads on a 1M-row usertable of 10 fields x 100 bytes).

Counterpart of ``yugabyte_db_tpu/models/ycsb.py``: workloads run against
one Tablet directly (engine level, no RPC).  Mixes:
  A: 50% read / 50% update      C: 100% point reads
  B: 95% read / 5% update       E: short range scans
Each run also records every operation's latency and the keys it
updated, so a caller can report percentiles and read the updates back.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..docdb.operations import ReadRequest, RowOp, WriteRequest
from ..docdb.table_codec import TableInfo
from ..dockv.packed_row import ColumnSchema, ColumnType, TableSchema
from ..dockv.partition import PartitionSchema


def usertable_info() -> TableInfo:
    cols = [ColumnSchema(0, "ycsb_key", ColumnType.INT64, is_hash_key=True)]
    cols += [ColumnSchema(i + 1, f"field{i}", ColumnType.STRING)
             for i in range(10)]
    return TableInfo("usertable", "usertable", TableSchema(tuple(cols), 1),
                     PartitionSchema("hash", 1))


def generate_rows(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    payload = "x" * 100
    return {
        "ycsb_key": np.arange(n, dtype=np.int64),
        **{f"field{i}": np.array([payload] * n, object) for i in range(10)},
    }


@dataclass
class WorkloadResult:
    ops: int
    seconds: float
    #: per-operation latency in microseconds (for workload C with
    #: clients > 1: per batch)
    lat_us: Optional[np.ndarray] = None

    @property
    def ops_per_sec(self) -> float:
        return self.ops / self.seconds if self.seconds else 0.0


class YcsbTabletWorkload:
    """Engine-level workload against one Tablet (no RPC)."""

    def __init__(self, tablet, n_rows: int, seed: int = 1):
        self.tablet = tablet
        self.n = n_rows
        self.rng = np.random.default_rng(seed)
        #: every key an update of this workload wrote
        self.updated_keys: set = set()

    def load(self) -> int:
        return self.tablet.bulk_load(generate_rows(self.n))

    def _read(self, key: int):
        return self.tablet.read(ReadRequest(
            "usertable", pk_eq={"ycsb_key": int(key)}))

    def _update(self, key: int):
        row = {"ycsb_key": int(key),
               **{f"field{i}": "u" * 100 for i in range(10)}}
        self.tablet.apply_write(WriteRequest(
            "usertable", [RowOp("upsert", row)]))
        self.updated_keys.add(int(key))

    def run(self, workload: str, ops: int = 1000,
            clients: int = 1) -> WorkloadResult:
        """clients > 1 models that many concurrent sessions whose point
        reads arrive together and batch at the server seam
        (Tablet.multi_read) — the single-process analog of the
        reference's multi-threaded YCSB drivers hitting pggate's
        operation buffering. Only workload C (pure reads) batches."""
        read_frac = {"a": 0.5, "b": 0.95, "c": 1.0, "e": 0.95}[workload]
        keys = self.rng.integers(0, self.n, ops)
        clock = time.perf_counter
        if workload == "c" and clients > 1:
            lat = []
            t0 = clock()
            for i in range(0, ops, clients):
                batch = [{"ycsb_key": int(k)} for k in keys[i:i + clients]]
                t = clock()
                self.tablet.multi_read("usertable", batch)
                lat.append(clock() - t)
            return WorkloadResult(ops, clock() - t0,
                                  np.asarray(lat) * 1e6)
        coins = self.rng.random(ops)
        lat = np.empty(ops)
        t0 = clock()
        for j, (k, c) in enumerate(zip(keys, coins)):
            t = clock()
            if workload == "e" and c < read_frac:
                # short range scan: the keys k..k+10 (batched point
                # gets on the hash-sharded key)
                self.tablet.read(ReadRequest(
                    "usertable", columns=("ycsb_key",),
                    where=("between", ("col", 0), ("const", int(k)),
                           ("const", int(k) + 10)), limit=10))
            elif c < read_frac:
                self._read(k)
            else:
                self._update(k)
            lat[j] = clock() - t
        return WorkloadResult(ops, clock() - t0, lat * 1e6)
