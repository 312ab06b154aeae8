#!/usr/bin/env python3
"""Time the PyTorch port's vectorized host passes on the write path next
to the row-at-a-time loops they stand in for, at chip_smoke.py phase
11's shapes, and check that both give the same result.

    python3 profile_torch_host.py [--seed 0] [--ycsb-rows 1000000]

Cases (one JSON line each; seconds per call, the median of `reps`
calls):
  memtable_block  TableCodec.columnar_builder over the HTAP memtable
                  (TPC-H SF1's RF1 + RF2 entries, as phase 11 (a)
                  writes them): built on every read that finds a
                  memtable, and by every flush
  memtable_pk     the same block with its fixed-width pk lanes decoded
                  key by key (DocKey.decode) instead of from the key
                  matrix
  row_decode      TableCodec.row_decoder over YCSB's bulk-loaded
                  usertable (--ycsb-rows x 10 fields x 100 B in
                  65,536-row blocks): once per SST reader in workload
                  E's scans, in _compact_rows and in the CPU feed
  encode_block    storage/sst.py _encode_block over those rows in
                  4,096-entry blocks (compaction output, flushes)
  dict_varlen     ColumnarBlock.deserialize of those blocks (ten
                  dictionary-coded fields each): the host library's
                  memcpy loop against its numpy twin
  repack          the repacking compaction's repack of those rows after
                  ALTER TABLE ADD COLUMN field10 (phase 11 (c)): one
                  numpy pass per 4,096-entry block (docdb/compaction.py
                  _repack_block, dockv/packed_row.py repack_values)
                  against the per-row unpack + pack (_repack_entry)
Host work only: it runs with or without a card.  Every line names the
card (nvidia-smi) where there is one, and the host's core count.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

BASE_US = 1_700_000_000_000_000   # chip_smoke.py's WRITE_BASE_US
YCSB_BLOCK_ROWS = 65_536          # Tablet.bulk_load's default
ENCODE_BLOCK_ROWS = 4_096         # storage/sst.py DEFAULT_BLOCK_ROWS


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0].strip() if out else "no card"


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def timed(fn, reps: int):
    """(median seconds of `reps` calls, the last call's result)."""
    times, out = [], None
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times), out


def same_block(a, b) -> bool:
    """Two ColumnarBlocks hold the same lanes, keys and flags."""
    if a is None or b is None:
        return a is b
    eq = np.array_equal
    if (a.n != b.n or a.unique_keys != b.unique_keys
            or a.schema_version != b.schema_version
            or not all(eq(getattr(a, f), getattr(b, f))
                       for f in ("key_hash", "ht", "write_id", "tombstone",
                                 "keys"))
            or a.fixed.keys() != b.fixed.keys()
            or a.varlen.keys() != b.varlen.keys()
            or a.pk.keys() != b.pk.keys()):
        return False
    return (all(eq(a.fixed[c][0], b.fixed[c][0])
                and eq(a.fixed[c][1], b.fixed[c][1]) for c in a.fixed)
            and all(eq(a.pk[c], b.pk[c]) for c in a.pk)
            and all(eq(a.varlen[c][0], b.varlen[c][0])
                    and bytes(a.varlen[c][1]) == bytes(b.varlen[c][1])
                    and eq(a.varlen[c][2], b.varlen[c][2])
                    for c in a.varlen))


def memtable_entries(codec, tpch, seed: int):
    """Phase 11 (a)'s first memtable (chip_smoke.py htap_phase's first
    refresh, drawn from the same seeds): RF1's upserts (one write id per
    lineitem of an order) and RF2's deletes, in key order."""
    from yugabyte_db_tpu_torch.utils.hybrid_time import (DocHybridTime,
                                                         HybridTime)
    n = tpch.ROWS_PER_SF
    us = BASE_US
    out = []
    for order in tpch.refresh_inserts(1.0, n + 1_000_000, seed=seed + 101):
        us += 10
        for wid, r in enumerate(tpch.column_rows(order)):
            out.append(codec.encode_write(
                r, DocHybridTime(HybridTime.from_micros(us), wid)))
    for ids in tpch.refresh_deletes(1.0, n, seed=seed + 201):
        us += 10
        for wid, r in enumerate(ids.tolist()):
            out.append(codec.encode_delete(
                {"rowid": r}, DocHybridTime(HybridTime.from_micros(us),
                                            wid)))
    out.sort()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ycsb-rows", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    from yugabyte_db_tpu_torch.docdb import table_codec
    from yugabyte_db_tpu_torch.docdb.table_codec import TableCodec
    from yugabyte_db_tpu_torch.models import tpch, ycsb
    from yugabyte_db_tpu_torch.storage import native_lib, sst
    from yugabyte_db_tpu_torch.storage.columnar import ColumnarBlock
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime

    card = card_line()
    cpus = os.cpu_count()
    ok = True

    def report(case, shape, fast_s, loop_s, equal, **extra):
        nonlocal ok
        ok = ok and equal
        print(json.dumps({"host_path": case, "shape": shape,
                          "vectorized_s": fast_s, "row_loop_s": loop_s,
                          "loop_over_vectorized": loop_s / fast_s,
                          "equal": equal, **extra, "card": card,
                          "host_cores": cpus}), flush=True)

    # memtable_block: the HTAP memtable's columnar block
    codec = TableCodec(tpch.lineitem_info())
    entries = memtable_entries(codec, tpch, args.seed)
    fast_s, fast = timed(lambda: codec.columnar_builder(entries), args.reps)
    with patched(codec, "_columnar_uniform", lambda e: NotImplemented):
        loop_s, loop = timed(lambda: codec.columnar_builder(entries),
                             args.reps)
    report("memtable_block", f"{len(entries)} lineitem entries (RF1 + RF2)",
           fast_s, loop_s, fast is not None and same_block(fast, loop))
    with patched(codec, "_pk_columns_uniform", lambda dk: None):
        loop_s, loop = timed(lambda: codec.columnar_builder(entries),
                             args.reps)
    report("memtable_pk", f"{len(entries)} lineitem entries (RF1 + RF2)",
           fast_s, loop_s, same_block(fast, loop))
    del entries, fast, loop

    # the YCSB usertable's bulk-loaded blocks, as an SST reader sees them
    ycodec = TableCodec(ycsb.usertable_info())
    blocks = ycodec.bulk_blocks(ycsb.generate_rows(args.ycsb_rows),
                                HybridTime.from_micros(BASE_US),
                                block_rows=YCSB_BLOCK_ROWS)
    sers = [b.serialize(key_builder=ycodec.derive_keys) for b in blocks]
    del blocks

    def load():
        out = []
        for s in sers:
            cb = ColumnarBlock.deserialize(s)
            cb.bind_key_builder(ycodec.derive_keys)
            out.append(cb)
        return out
    fast_s, cbs = timed(load, args.reps)
    with patched(native_lib, "gather_heap", lambda *a: False):
        loop_s, twin = timed(load, args.reps)
    dict_lanes = sum(len(cb._vdicts) for cb in cbs)
    report("dict_varlen", f"{len(sers)} blocks x {YCSB_BLOCK_ROWS} rows, "
           f"{dict_lanes} dictionary-coded lanes", fast_s, loop_s,
           dict_lanes > 0 and all(same_block(a, b)
                                  for a, b in zip(cbs, twin)),
           twin="numpy (native_lib.gather_heap_fallback)")
    del twin

    fast_s, fast = timed(lambda: [ycodec.row_decoder(cb) for cb in cbs], 1)
    with patched(table_codec, "_pack_block_values", lambda *a, **k: None):
        loop_s, loop = timed(lambda: [ycodec.row_decoder(cb) for cb in cbs],
                             1)
    report("row_decode", f"{args.ycsb_rows} usertable rows x 10 fields x "
           f"100 B in {len(cbs)} blocks", fast_s, loop_s, fast == loop)
    rows = [e for blk in fast for e in blk]
    del fast, loop, cbs

    def encode():
        return [sst._encode_block(rows[i:i + ENCODE_BLOCK_ROWS])
                for i in range(0, len(rows), ENCODE_BLOCK_ROWS)]
    fast_s, fast = timed(encode, args.reps)
    with patched(sst, "_shared_prefixes", sst._shared_prefixes_loop):
        loop_s, loop = timed(encode, args.reps)
    report("encode_block", f"{len(rows)} usertable entries in "
           f"{ENCODE_BLOCK_ROWS}-entry blocks", fast_s, loop_s, fast == loop)
    del fast, loop

    # repack: the usertable at version 2 (field10 added, version 1 kept)
    from yugabyte_db_tpu_torch.docdb import compaction
    from yugabyte_db_tpu_torch.docdb.table_codec import TableInfo
    from yugabyte_db_tpu_torch.dockv import packed_row
    info = ycsb.usertable_info()
    v2 = TableCodec(TableInfo(
        info.table_id, info.name, packed_row.TableSchema(
            info.schema.columns + (packed_row.ColumnSchema(
                11, "field10", packed_row.ColumnType.STRING),), 2),
        info.partition_schema, schema_history=(info.schema,)))
    target = (v2, 2, packed_row.RowPacker(v2.info.packings.get(2)))
    blocks_in = [rows[i:i + ENCODE_BLOCK_ROWS]
                 for i in range(0, len(rows), ENCODE_BLOCK_ROWS)]
    fast_s, fast = timed(lambda: [compaction._repack_block(
        b, lambda k: target) for b in blocks_in], 1)
    loop_s, loop = timed(lambda: [[compaction._repack_entry(*target, k, v)
                                   for k, v in b] for b in blocks_in], 1)
    report("repack", f"{len(rows)} usertable entries, version 1 to 2, in "
           f"{ENCODE_BLOCK_ROWS}-entry blocks", fast_s, loop_s, fast == loop)
    print(json.dumps({"host_paths_ok": ok, "card": card}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
