"""yugabyte_db_tpu_torch — the PyTorch/CUDA port of yugabyte_db_tpu.

The JAX package ``yugabyte_db_tpu`` is the reference; this package
mirrors its layout module for module, so each port module sits at the
same relative path as its counterpart.  It imports ``torch`` and numpy
only — never ``jax`` and nothing of the JAX package.

Ported so far (ROADMAP.md queue 1): the TPC-H Q6/Q1 scan-aggregate
path as a tablet serves it — bulk-loaded lineitem blocks (string
columns included) -> one padded device batch, or pow2 chunks through
``ops.stream_scan`` -> ``ops.scan.ScanKernel.run`` (exact int64
fixed-point route, MVCC modes ``none``, ``visible`` and ``dedup``;
dense, hash and dictionary GROUP BY) or the hand-written Hopper kernels
of ``ops.hand_scan`` -> host-combined partials; the tablet read seam
(``tablet.Tablet``: ``bulk_load`` into columnar SSTs, ``read`` of
aggregate requests through ``docdb.operations.DocReadOperation`` with
zone-map pruning and read restarts; ``models.tpch.LineitemTable``
over several tablets; the analytics bypass reader ``bypass.
BypassSession`` over pinned SSTs); the LSM compaction merge over
columnar SSTs (``docdb.compaction.tpu_compact``: the pipelined chunked
engine with the merge + MVCC GC on the card, or the monolithic host
baseline) with the SST tier it runs on; and the write path
(``Tablet.apply_write`` through ``DocWriteOperation`` into the
memtable, the flush on the apply path to row SSTs with columnar
sidecars, point, prefix and enumerated reads, the interpreted row path
and join, row-path compaction with the merge + GC on the card, and
aggregates on the card over SST + memtable); the point-read hot path in
the host extension (``docdb.hotpath``, ``csrc/host_hot.c``: whole-SST
point readers, the fused range read, the row extractor and packer);
the native compaction backend; ALTER TABLE with the repacking
compactions, TRUNCATE, snapshots and trim; colocated tablets; the
document store (JSON paths shredded at write into v2 lanes, doc-path
predicates and aggregates on the card's existing scan machinery, the
bypass and compaction over shredded lanes); the v1 SST writer; and
encryption at rest.

Device rule: every entry point takes ``device=`` and defaults to
``"cuda"``; asking for CUDA where there is none raises
(``device.resolve_device``).  The CPU is used only when the caller
passes ``device="cpu"``.  Shapes not ported yet raise
``errors.NotPortedError`` naming their ROADMAP.md item.

Package layout:
  device.py   device resolution and validation
  errors.py   the typed NotPortedError refusal
  utils/      flags (only those the ported paths read), hybrid times,
              the memtable's sorted map, encryption at rest
  dockv/      column schemas and packed rows, doc key encoding, values
              and TTL envelopes, partitioning, bulk encoders
  storage/    ColumnarBlock (struct-of-arrays rows, string lanes, v1/v2
              serialization, zone maps), lane and dictionary coding
              (lane_codec), the MessagePack header codec (wire_pack),
              SST files of row and columnar blocks (sst), the memtable,
              the k-way merge, the LSM store (lsm: writes, flush,
              manifest, reader leases, feed compaction), the host library
              (native_lib, csrc/host_native.cpp), the stage pipeline
  docdb/      TableInfo + TableCodec (row encode/decode, flush
              sidecars, bulk blocks and ingest, key derivation), write
              and read requests with DocWriteOperation and
              DocReadOperation (operations), compaction engines and the
              CPU feeds (compaction), the host hot-path extension's
              loader (hotpath, csrc/host_hot.c)
  tablet/     Tablet: one shard's (or a colocated group's) stores,
              codecs, writes, reads, flush, compaction, ALTER, TRUNCATE,
              snapshots
  docstore/   JSON path shredding (shred) and the doc-path rewrite
              onto virtual shredded columns (pushdown)
  bypass/     snapshot pinner, SST-direct scan with the near-data
              prefilter, BypassSession
  models/     TPC-H lineitem generator and refresh functions, Q6/Q1 and
              their numpy answers; the YCSB usertable workload; the
              document workload (docbench)
  ops/        expression compiler, device batches and cache, scan
              kernel with the shard combine and zone pruning, dictionary
              GROUP BY (grouped_scan), streaming scan (stream_scan),
              compaction merge programs (compaction),
              hand kernels (hand_scan.py; CUDA sources under csrc/)
"""

__version__ = "0.1.0"
