"""Tablet: one shard of one table — its LSM store, codec, writes, reads,
compaction and vector indexes.

Counterpart of ``yugabyte_db_tpu/tablet/tablet.py`` (reference:
src/yb/tablet/tablet.h:151, tablet.cc:2303 HandlePgsqlReadRequest, :1938
ApplyRowOperations): the RegularDB and IntentsDB LSM stores (reference:
tablet/tablet.h:1287-1288); ``apply_write`` through
``DocWriteOperation`` into the memtable, with the flush on the apply
path (async: the memtable freezes on the apply thread and a two-worker
flush pool writes the SST; backpressure past ``max_frozen_memtables``);
``flush``; ``read`` and ``multi_read`` through ``DocReadOperation`` on
the tablet's device; ``bulk_load`` into columnar SSTs; ``compact``
(major, or the oldest run that ``pick_compaction`` picks) and the size
accessors.  The flush thread writes files on the host and makes no CUDA
call: a read that holds a device batch keeps its tensors alive by
reference.

Maintenance and DDL: ``alter_table`` (old packings retained, the
store's builders and decoders rebound; compaction repacks),
``truncate_table`` (the whole store at once on a dedicated tablet,
cotable tombstones on a colocated one), ``create_snapshot`` (a
hard-link checkpoint of both stores), ``trim_above_ht`` and
``restore_snapshot``.  A colocated tablet hosts several tables
(``add_table``), each keyed under its cotable prefix; its SSTs carry no
columnar sidecar, so its reads take the row paths.

Vector indexes (the reference's vector-LSM shape): a frozen ANN chunk
from the index registry (the two-stage IVF on the tablet's device, or
HNSW on the host) plus a delta of the writes applied since it was
built, which ``apply_write`` maintains and ``vector_search`` merges by
an exact search on the tablet's device; ``maybe_rebuild_vector_indexes``
folds an outgrown delta back in.  Each build persists the chunk under
``vecidx/<column id>/`` and ``bootstrap_vector_indexes`` loads it on
restart and reconciles it with the store by a scan-diff.

The WAL, metrics and trace spans are not ported (ROADMAP.md queue 1
item 9)."""
from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from time import perf_counter as _perf_counter
from typing import Dict, Optional

import numpy as np

from ..device import DeviceLike, resolve_device
from ..docdb.compaction import (ColocatedRepackingFeed,
                                RepackingCompactionFeed, tpu_compact)
from ..docdb.operations import (DocReadOperation, DocWriteOperation,
                                ReadRequest, ReadResponse, ReadRestartError,
                                WriteRequest, WriteResponse)
from ..docdb.table_codec import TableCodec, TableInfo
from ..dockv.key_encoding import ValueType
from ..dockv.value import PrimitiveValue
from ..ops.device_batch import DeviceBlockCache
from ..storage import wire_pack
from ..storage.lsm import CompactionFeed, LsmStore, WriteBatch
from ..utils import flags
from ..utils.hybrid_time import (ENCODED_SIZE, DocHybridTime, HybridClock,
                                 HybridTime)

log = logging.getLogger("ybtpu_torch.tablet")

#: process-wide device block cache shared by all tablets (device memory
#: is global); keys carry the store, its SSTs, its write generation and
#: the device
_DEVICE_CACHE = DeviceBlockCache()

#: bounded background flush executor shared by all tablets: the async
#: flush freezes the memtable on the apply thread and runs the SST write
#: and fsync here (reference: the RocksDB flush thread pool).  Two
#: workers: a flush streaming to a stalled disk must not park every
#: other tablet's flush behind it.
_FLUSH_POOL = ThreadPoolExecutor(max_workers=2,
                                 thread_name_prefix="bg-flush")

#: process-wide flush-on-apply accounting: what the apply thread paid
#: (``handoff_s`` = freeze + submit, ``inline_s`` = backpressure or
#: flag-off inline drains) against what moved to the flush executor
#: (``background_flushes``)
FLUSH_APPLY_STATS = {"handoff_s": 0.0, "inline_s": 0.0, "handoffs": 0,
                     "inline_flushes": 0, "background_flushes": 0}


class _VectorIndexState:
    """One ANN index: a frozen chunk (any registry method) plus a
    mutable delta, the vector-LSM shape (reference:
    vector_index/vector_lsm.cc)."""

    def __init__(self, col_name: str, method: str = "ivfflat",
                 options: Optional[dict] = None):
        self.col_name = col_name
        self.method = method
        self.options = dict(options or {})
        self.idx = None               # frozen AnnIndex (or None)
        self.pks: list = []           # row ids aligned with idx vectors
        self.frozen_keys: set = set()  # pk_keys present in the chunk
        self.frozen_pos: Dict[tuple, int] = {}   # pk_key -> index id
        # pk_key -> (pk_row, vector_bytes, expire_at_wall or None)
        self.delta: Dict[tuple, tuple] = {}
        self.dead: set = set()        # frozen pk_keys hidden by del/upsert
        # pk_keys any write touched while a bootstrap scan-diff is in
        # flight (None otherwise): the merge must not overwrite them —
        # a DELETE of a non-frozen key leaves no delta/dead trace, and
        # the scan's pre-delete image would otherwise resurrect the row
        self.touched: Optional[set] = None

    @property
    def nlists(self) -> int:
        return int(self.options.get("lists", 100))


class _TrimFeed(CompactionFeed):
    """trim_above_ht's feed: drops every version above the cutoff."""

    def __init__(self, cutoff: int):
        self.cutoff = cutoff
        self.dropped = 0

    def feed(self, key: bytes, value: bytes):
        if len(key) > ENCODED_SIZE and \
                key[-(ENCODED_SIZE + 1)] == ValueType.kHybridTime and \
                DocHybridTime.decode_desc(
                    key[-ENCODED_SIZE:]).ht.value > self.cutoff:
            self.dropped += 1
            return []
        return [(key, value)]


class Tablet:
    """One tablet on `device` (CUDA unless the caller passes "cpu";
    raises without a card)."""

    def __init__(self, tablet_id: str, info: TableInfo, directory: str,
                 clock: Optional[HybridClock] = None,
                 partition=None, colocated: bool = False,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.tablet_id = tablet_id
        self.info = info
        self.partition = partition
        self.dir = directory
        self.colocated = colocated
        os.makedirs(directory, exist_ok=True)
        self.codec = TableCodec(info)
        # a colocated tablet hosts several tables (reference: the
        # ysql-colocated-tables design; cotable-prefixed doc keys), and
        # its SSTs carry no columnar sidecar
        self.codecs: Dict[str, TableCodec] = {info.table_id: self.codec}
        self.clock = clock or HybridClock()
        self.regular = LsmStore(
            os.path.join(directory, "regular"), name="regular",
            columnar_builder=(None if colocated
                              else self.codec.columnar_builder),
            row_decoder=None if colocated else self.codec.row_decoder,
            key_builder=None if colocated else self.codec.derive_keys,
            shred_cols=None if colocated else self.codec.shred_cols)
        self.intents = LsmStore(
            os.path.join(directory, "intents"), name="intents")
        self._read_op = DocReadOperation(
            self.codec, self.regular, device_cache=_DEVICE_CACHE,
            device=self.device)
        self._read_ops: Dict[str, DocReadOperation] = {
            info.table_id: self._read_op}
        # vector ANN indexes: col_id -> _VectorIndexState
        self.vector_indexes: Dict[int, _VectorIndexState] = {}
        self._lock = threading.Lock()
        self._vector_build_lock = threading.Lock()   # serializes rebuilds

    # --- colocation and DDL -----------------------------------------------
    def add_table(self, info: TableInfo) -> None:
        """Host one more table (a colocated tablet's cotable)."""
        codec = TableCodec(info)
        self.codecs[info.table_id] = codec
        self._read_ops[info.table_id] = DocReadOperation(
            codec, self.regular, device_cache=None, device=self.device)

    def _codec_for(self, table_id: str) -> TableCodec:
        return self.codecs.get(table_id, self.codec)

    def schema_version_of(self, table_id: str) -> Optional[int]:
        """The table's current schema version (the catalog-version
        write fence)."""
        return self._codec_for(table_id).info.schema.version

    def tables(self):
        return list(self.codecs)

    def alter_table(self, new_info: TableInfo) -> None:
        """Online schema change (reference: ChangeMetadataOperation,
        tablet/operations/change_metadata_operation.cc): adopt the new
        schema version while RETAINING the old packings, so existing
        rows keep decoding; compaction repacks them over time."""
        old = self.codecs.get(new_info.table_id, self.codec)
        merged = TableCodec(new_info)
        merged.info.packings._packings.update(
            {v: p for v, p in old.info.packings._packings.items()
             if v not in merged.info.packings._packings})
        self.codecs[new_info.table_id] = merged
        primary = new_info.table_id == self.info.table_id
        if primary:
            self.info = new_info
            self.codec = merged
            if not self.colocated:
                self.regular.columnar_builder = merged.columnar_builder
                self.regular.row_decoder = merged.row_decoder
                # key derivation depends only on the pk and partition
                # shape, which an ALTER cannot change; rebinding keeps
                # the codec object current all the same
                self.regular.key_builder = merged.derive_keys
                self.regular.shred_cols = merged.shred_cols
                for r in self.regular.ssts:
                    r.row_decoder = merged.row_decoder
                    r.key_builder = merged.derive_keys
            self._read_op = DocReadOperation(
                merged, self.regular, device_cache=_DEVICE_CACHE,
                device=self.device)
        self._read_ops[new_info.table_id] = (
            self._read_op if primary else DocReadOperation(
                merged, self.regular, device_cache=None,
                device=self.device))

    # --- writes -----------------------------------------------------------
    def apply_write(self, req: WriteRequest,
                    ht: Optional[HybridTime] = None,
                    op_id=None) -> WriteResponse:
        """Apply one write at `ht` (the tablet's clock by default) and
        trigger a flush when the memtable passes its threshold."""
        ht = ht or self.clock.now()
        batch, n = DocWriteOperation(self._codec_for(req.table_id),
                                     req).apply(ht, op_id=op_id)
        self.regular.apply(batch)
        self._maintain_vector_indexes(req)
        if self.regular.should_flush():
            self._flush_on_apply()
        return WriteResponse(rows_affected=n)

    def _flush_on_apply(self) -> None:
        """Flush trigger on the apply path.  Async (the default): freeze
        the active memtable (a pointer swap) and hand the SST write to
        the flush executor, so the apply thread never waits on disk;
        past ``max_frozen_memtables`` frozen memtables the apply thread
        drains one inline instead (backpressure).  Flag off: the inline
        flush."""
        t0 = _perf_counter()
        if not flags.get("async_flush_enabled"):
            self.flush()
            FLUSH_APPLY_STATS["inline_flushes"] += 1
            FLUSH_APPLY_STATS["inline_s"] += _perf_counter() - t0
            return
        if self.regular.freeze_active():
            FLUSH_APPLY_STATS["handoffs"] += 1
            _FLUSH_POOL.submit(self._background_flush)
        while (self.regular.frozen_count()
               > flags.get("max_frozen_memtables")):
            # the executor fell behind: the apply thread drains one
            # frozen memtable, bounding frozen memory
            ti = _perf_counter()
            if self.regular.flush_frozen() is not None:
                _DEVICE_CACHE.invalidate_prefix((id(self.regular),))
            FLUSH_APPLY_STATS["inline_flushes"] += 1
            FLUSH_APPLY_STATS["inline_s"] += _perf_counter() - ti
        FLUSH_APPLY_STATS["handoff_s"] += _perf_counter() - t0

    def _background_flush(self) -> None:
        """Flush-executor job: drain frozen memtables (oldest first,
        serialized by the store's flush IO lock) until none is left,
        invalidating the device cache per install.  It does not wait on
        the IO lock: another flush that owns it drains everything
        queued.  A failed flush leaves the frozen memtable queued for
        the next trigger, an inline drain or ``flush()``."""
        try:
            while self.regular.flush_frozen(wait=False) is not None:
                _DEVICE_CACHE.invalidate_prefix((id(self.regular),))
                FLUSH_APPLY_STATS["background_flushes"] += 1
        except Exception:   # noqa: BLE001 — must not kill the pool
            log.exception("%s: background flush failed (frozen memtable "
                          "retained for retry)", self.tablet_id)

    # --- reads ------------------------------------------------------------
    def read(self, req: ReadRequest) -> ReadResponse:
        """Serve one read; with no read point the tablet's clock assigns
        one, and the read may restart on the clock-uncertainty window."""
        if req.read_ht is None:
            req.read_ht = self.clock.now().value
            req.server_assigned_read_ht = True
        return self._read_ops.get(req.table_id, self._read_op).execute(req)

    def multi_read(self, table_id: str, pk_rows, read_ht=None,
                   allow_restart=None):
        """Batched point reads at one read point: a row dict (or None)
        per pk_row.  `allow_restart` defaults to "the read point was
        server-assigned"."""
        server_assigned = read_ht is None
        if allow_restart is None:
            allow_restart = server_assigned
        if server_assigned:
            read_ht = self.clock.now().value
        op = self._read_ops.get(table_id, self._read_op)
        for _attempt in range(3):
            try:
                return op.multi_get(pk_rows, read_ht,
                                    allow_restart=allow_restart)
            except ReadRestartError as e:
                read_ht = e.restart_ht
        return op.multi_get(pk_rows, read_ht, allow_restart=False)

    def safe_time(self) -> HybridTime:
        return self.clock.now()

    # --- maintenance ------------------------------------------------------
    def truncate_table(self, table_id: str, op_id=None, ht=None) -> int:
        """TRUNCATE (reference: tablet/tablet.cc Truncate, which
        replaces the stores rather than writing tombstones).  A
        dedicated tablet drops its whole regular store at once; a
        colocated one tombstones the cotable's doc keys at a fresh
        hybrid time (MVCC-correct; compaction reclaims them).  Vector
        indexes over the table reset with it.  Returns the SSTs removed
        (dedicated) or the rows tombstoned (colocated)."""
        codec = self._codec_for(table_id)
        if table_id == self.info.table_id:
            # vector indexes only ever cover the tablet's primary table
            with self._vector_build_lock:
                self.vector_indexes.clear()
                shutil.rmtree(os.path.join(self.dir, "vecidx"),
                              ignore_errors=True)
        if not self.colocated:
            n = self.regular.truncate(op_id=op_id)
            _DEVICE_CACHE.invalidate_prefix((id(self.regular),))
            return n
        prefix = codec.scan_prefix()
        mems, ssts = self.regular.read_snapshot()
        seen = set()
        ht = HybridTime(ht) if ht is not None else self.clock.now()
        batch = WriteBatch(op_id=op_id)
        for src in list(mems) + list(ssts):
            for k, _v in src.iterate():
                if not k.startswith(prefix):
                    continue
                dk = k[:-(ENCODED_SIZE + 1)]
                if dk in seen:
                    continue
                seen.add(dk)
                batch.put(dk + bytes([ValueType.kHybridTime])
                          + DocHybridTime(ht, len(seen) - 1).encoded_desc(),
                          PrimitiveValue.tombstone().encode())
        if batch.entries:
            self.regular.apply(batch)
        return len(seen)

    def flush(self, wait: bool = True) -> Optional[str]:
        """Freeze the memtable and drain every frozen memtable to SSTs:
        the barrier behind which every applied write is on disk."""
        path = self.regular.flush(wait=wait)
        if path:
            _DEVICE_CACHE.invalidate_prefix((id(self.regular),))
        return path

    def history_cutoff(self) -> int:
        retention_us = flags.get("history_retention_interval_sec") \
            * 1_000_000
        now = self.clock.now()
        return max(0, now.value - (retention_us << 12))

    def compact(self, major: bool = True) -> Optional[str]:
        """Compaction with MVCC GC after a flush, of every SST (major) or
        of the oldest run ``pick_compaction`` picks (reference analog:
        full_compaction_manager.cc driving CompactionJob with the DocDB
        feed), routed as the reference routes it:

          colocated tablet              the CPU feed, repacking per
                                        cotable (ColocatedRepackingFeed)
          more than one schema version  the CPU feed, repacking to the
                                        latest (RepackingCompactionFeed)
          tpu_compaction_enabled, card  the pipelined chunked engine,
                                        the merge on the card (row
                                        blocks and TTL'd rows through
                                        _compact_rows, also on the card)
          tpu_compaction_enabled, CPU   the same engine with the host
                                        k-way merge per chunk (native)
          tpu_compaction_enabled off    the monolithic host baseline"""
        self.flush()
        inputs = self.regular.ssts if major else \
            self.regular.pick_compaction()
        if not inputs:
            return None
        cutoff = self.history_cutoff()
        if self.colocated:
            path = self.regular.compact(
                inputs=inputs,
                feed=ColocatedRepackingFeed(cutoff, self.codecs.values()))
        elif len(self.codec.info.packings.versions()) > 1:
            path = self.regular.compact(
                inputs=inputs,
                feed=RepackingCompactionFeed(cutoff, self.codec))
        else:
            if not flags.get("tpu_compaction_enabled"):
                backend = "baseline"
            elif self.device.type == "cuda":
                backend = "device"
            else:
                backend = "native"
            path = tpu_compact(self.regular, self.codec, cutoff,
                               inputs=inputs, backend=backend,
                               device=self.device)
        _DEVICE_CACHE.invalidate_prefix((id(self.regular),))
        return path

    def bulk_load(self, columns: Dict[str, np.ndarray],
                  ht: Optional[HybridTime] = None,
                  block_rows: int = 65536) -> int:
        """Ingest column arrays as one new SST (rows outside this
        tablet's partition are dropped, so the same arrays feed every
        tablet of a table); returns the rows written."""
        ht = ht or self.clock.now()
        return self.codec.bulk_ingest(self.regular, columns, ht,
                                      block_rows=block_rows,
                                      partition=self.partition)

    # --- snapshots --------------------------------------------------------
    def create_snapshot(self, out_dir: str):
        """Consistent tablet snapshot: flush and hard-link checkpoint of
        the regular and the intents store (reference:
        tablet/tablet_snapshots.cc:186,273; a bootstrapped replica keeps
        the provisional records).  Call it from the apply thread, so
        that both checkpoints form one cut.  Returns the regular store's
        flushed op index (the snapshot's replication frontier)."""
        self.flush()
        self.regular.checkpoint(os.path.join(out_dir, "regular"))
        self.intents.flush()
        self.intents.checkpoint(os.path.join(out_dir, "intents"))
        op = self.regular.flushed_frontier().get("op_id")
        return int(op[1]) if op else None

    def trim_above_ht(self, cutoff: int) -> int:
        """Enforce a single-hybrid-time cut: drop every version whose
        DocHybridTime exceeds `cutoff` (reference: tablet_snapshots.cc,
        a restore with a history cutoff), so a snapshot reads alike
        across tablets whose clocks were skewed at checkpoint time.  Run
        on a freshly restored tablet.  Returns the versions dropped."""
        self.flush()
        inputs = self.regular.ssts
        if not inputs:
            return 0
        feed = _TrimFeed(cutoff)
        self.regular.compact(inputs, feed)
        _DEVICE_CACHE.invalidate_prefix((id(self.regular),))
        return feed.dropped

    @classmethod
    def restore_snapshot(cls, tablet_id: str, info: TableInfo,
                         snapshot_dir: str, directory: str, clock=None,
                         device: DeviceLike = "cuda") -> "Tablet":
        """A tablet in `directory` opened on a copy of the snapshot's
        regular store, on `device` (CUDA unless the caller passes
        "cpu")."""
        dev = resolve_device(device)
        os.makedirs(directory, exist_ok=True)
        dst = os.path.join(directory, "regular")
        if os.path.exists(dst):
            shutil.rmtree(dst)
        shutil.copytree(os.path.join(snapshot_dir, "regular"), dst)
        return cls(tablet_id, info, directory, clock=clock, device=dev)

    def approximate_size(self) -> int:
        return self.regular.approximate_size()

    def num_sst_files(self) -> int:
        return len(self.regular.ssts)

    # --- vector indexes (reference: vector_index/vector_lsm.cc,
    # docdb/doc_vector_index.cc) -------------------------------------------
    def _pk_names(self) -> tuple:
        return tuple(c.name for c in self.info.schema.key_columns)

    def _scan_vectors(self, col_name: str):
        """(pk rows, [N, D] float32 vectors) of every live row at the
        clock's now, through a WHERE-less row read; rows whose vector is
        NULL are skipped."""
        pk_names = self._pk_names()
        resp = self._read_op.execute(ReadRequest(
            self.info.table_id, columns=pk_names + (col_name,),
            read_ht=self.clock.now().value))
        pks, vecs = [], []
        for r in resp.rows:
            v = r.get(col_name)
            if v is None:
                continue
            pks.append({n: r[n] for n in pk_names})
            vecs.append(np.frombuffer(v, np.float32))
        return pks, (np.stack(vecs) if vecs
                     else np.zeros((0, 1), np.float32))

    def build_vector_index(self, col_name: str, nlists: int = 100,
                           method: str = "ivfflat",
                           options: Optional[dict] = None) -> int:
        """(Re)build the frozen ANN chunk through the index registry
        (``method`` is the DDL's USING clause); returns the rows
        indexed.  Safe against writes racing a rebuild: delta entries
        recorded before the scan fold into the chunk and are dropped;
        entries that arrive during the build carry over into the new
        state."""
        cid = self.info.schema.column_by_name(col_name).id
        options = dict(options or {})
        options.setdefault("lists", nlists)
        with self._vector_build_lock:
            return self._build_vector_index_locked(
                cid, col_name, method, options)

    def _build_ann(self, method: str, options: dict, vecs):
        """Registry dispatch with the per-method option mapping (the
        DDL's WITH options are method-namespaced, like pgvector's).  The
        IVF alone takes the tablet's device: HNSW keeps its build
        arguments as its persisted options."""
        from ..vector import get_index_cls
        cls = get_index_cls(method)
        if method in ("ivfflat", "ivf"):
            # build() itself clamps nlists to the row count
            return cls.build(
                vecs, nlists=int(options.get("lists", 100)),
                iters=int(options.get("iters", 10)), device=self.device)
        if method == "hnsw":
            return cls.build(
                vecs, m=int(options.get("m", 16)),
                ef_construction=int(options.get("ef_construction", 100)),
                ef_search=int(options.get("ef_search", 64)))
        return cls.build(vecs, **options)

    def _build_vector_index_locked(self, cid, col_name, method,
                                   options) -> int:
        old = self.vector_indexes.get(cid)
        with self._lock:
            pending = dict(old.delta) if old else {}
            deadsnap = set(old.dead) if old else set()
        pks, vecs = self._scan_vectors(col_name)
        pk_names = self._pk_names()
        state = _VectorIndexState(col_name, method, options)
        if len(vecs):
            state.idx = self._build_ann(method, options, vecs)
            state.pks = pks
            state.frozen_pos = {tuple(p[n_] for n_ in pk_names): i
                                for i, p in enumerate(pks)}
            state.frozen_keys = set(state.frozen_pos)
        with self._lock:
            if old is not None:
                # identity check: keep only the entries written AFTER
                # the snapshot (a key re-written during the build stays)
                state.delta = {kk: v for kk, v in old.delta.items()
                               if pending.get(kk) is not v}
                state.dead = (old.dead - deadsnap) & state.frozen_keys
                # rows rewritten DURING the build are in both places;
                # the delta copy is newer, so the frozen one is hidden
                state.dead |= set(state.delta) & state.frozen_keys
            self.vector_indexes[cid] = state
        self._persist_vector_index(cid, state)
        return len(pks)

    def _maintain_vector_indexes(self, req: WriteRequest) -> None:
        """Incremental maintenance (reference: vector_lsm.cc's mutable
        chunk): writes land in a delta merged at search time; once the
        delta outgrows the frozen index, a rebuild folds it in."""
        if not self.vector_indexes or req.table_id != self.info.table_id:
            return
        pk_names = self._pk_names()
        with self._lock:
            for state in self.vector_indexes.values():
                for op in req.ops:
                    try:
                        pk_key = tuple(op.row[n] for n in pk_names)
                    except KeyError:
                        continue
                    if state.touched is not None:
                        state.touched.add(pk_key)
                    if op.kind != "delete" and op.ttl_ms is None:
                        # WAL-replay idempotence: a re-applied write whose
                        # vector EQUALS the frozen copy (and that nothing
                        # newer shadows) must not turn the frozen chunk
                        # into delta churn on every restart
                        i = state.frozen_pos.get(pk_key)
                        v = op.row.get(state.col_name)
                        if (i is not None and v is not None
                                and pk_key not in state.dead
                                and pk_key not in state.delta):
                            fv = state.idx.vector_of(i)
                            nv = np.frombuffer(bytes(v), np.float32)
                            if (nv.shape == fv.shape
                                    and np.array_equal(nv, fv)):
                                continue
                    state.delta.pop(pk_key, None)
                    # dead hides FROZEN copies only; fresh inserts never
                    # grow it (it bounds the search's over-fetch)
                    if pk_key in state.frozen_keys:
                        state.dead.add(pk_key)
                    if op.kind != "delete":
                        v = op.row.get(state.col_name)
                        if v is None:
                            continue
                        # a TTL'd row expires on the wall clock
                        expire = (None if op.ttl_ms is None else
                                  time.time() + op.ttl_ms / 1000.0)
                        state.delta[pk_key] = (
                            {n: op.row[n] for n in pk_names}, bytes(v),
                            expire)

    def maybe_rebuild_vector_indexes(self) -> int:
        """Fold an outgrown delta back into the frozen ANN index (the
        background-compaction analog); returns the indexes rebuilt."""
        n = 0
        for state in list(self.vector_indexes.values()):
            churn = len(state.delta) + len(state.dead)
            if churn and churn >= max(64, len(state.pks) // 5):
                self.build_vector_index(state.col_name, state.nlists,
                                        state.method, state.options)
                n += 1
        return n

    def _exact_hits(self, q: np.ndarray, pks: list, vecs: np.ndarray,
                    k: int) -> list:
        """(pk row, distance) of the k nearest of `vecs` by an exact
        search on the tablet's device, moved to the host once."""
        from ..ops.vector import exact_search
        d, ids = exact_search(q, vecs, k=min(k, len(pks)),
                              device=self.device)
        d, ids = d[0].cpu().numpy(), ids[0].cpu().numpy()
        return [(pks[int(i)], float(dist)) for dist, i in zip(d, ids)]

    def vector_search(self, col_name: str, query, k: int = 10,
                      nprobe: int = 8, ef_search=None):
        """Top-k (pk row, distance) of this tablet: the frozen ANN index
        (any registry method) and an exact search over the live delta on
        the tablet's device, merged; with no index built, an exact
        search over a fresh scan.  ``nprobe`` drives IVF probing,
        ``ef_search`` the HNSW beam (the index's build-time option when
        None)."""
        cid = self.info.schema.column_by_name(col_name).id
        pk_names = self._pk_names()
        q = np.asarray(query, np.float32)[None, :]
        state = self.vector_indexes.get(cid)
        if state is None:
            pks, vecs = self._scan_vectors(col_name)
            if not pks:
                return []
            return self._exact_hits(q, pks, vecs, k)
        with self._lock:
            dead = set(state.dead)
            now = time.time()
            expired = [kk for kk, (_, _, exp) in state.delta.items()
                       if exp is not None and exp <= now]
            for kk in expired:
                del state.delta[kk]
            delta = list(state.delta.values())
        hits = []
        if state.idx is not None and state.pks:
            idx, pks = state.idx, state.pks
            # over-fetch so that dropping dead rows still fills k
            k_ = min(k + len(dead), len(pks))
            params = {"nprobe": nprobe,
                      "ef_search": ef_search
                      or state.options.get("ef_search")}
            d, ids = idx.search(q, k=k_, **params)
            for dist, i in zip(d[0], ids[0]):
                if int(i) < 0 or not np.isfinite(float(dist)):
                    continue          # top-k padding, not a real hit
                pk = pks[int(i)]
                if tuple(pk[n] for n in pk_names) not in dead:
                    hits.append((pk, float(dist)))
        if delta:
            dvecs = np.stack([np.frombuffer(v, np.float32)
                              for _, v, _ in delta])
            hits += self._exact_hits(q, [p for p, _, _ in delta], dvecs, k)
        hits.sort(key=lambda h: h[1])
        return hits[:k]

    # --- vector-index persistence: vecidx/<col_id>/ under the tablet
    # directory (reference: vector_lsm.cc chunk files next to the tablet
    # data), loaded and scan-diffed on bootstrap -----------------------------
    def _vecidx_dir(self, cid: int) -> str:
        return os.path.join(self.dir, "vecidx", str(cid))

    def _persist_vector_index(self, cid: int,
                              state: _VectorIndexState) -> None:
        """Best-effort durable copy of the frozen chunk and its pk map:
        the registry's files and ``tablet_meta.msgpack``.  A failure
        degrades to a rebuild on bootstrap and never fails the build."""
        try:
            if state.idx is None:
                shutil.rmtree(self._vecidx_dir(cid), ignore_errors=True)
                return
            path = self._vecidx_dir(cid)
            state.idx.save(path)
            tmp = os.path.join(path, ".tablet_meta.tmp")
            with open(tmp, "wb") as f:
                f.write(wire_pack.packb(
                    {"col_name": state.col_name,
                     "method": state.method,
                     "options": state.options,
                     "pks": state.pks}))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(path, "tablet_meta.msgpack"))
        except Exception:   # noqa: BLE001 — persistence is an optimization
            log.exception("vector index persist failed for %s/%s",
                          self.tablet_id, cid)

    def bootstrap_vector_indexes(self) -> int:
        """Load the persisted ANN indexes (IVF onto the tablet's device)
        and reconcile each with the CURRENT store by a scan-diff: rows
        written after the last save land in the delta, frozen rows that
        vanished or changed are hidden.  The state installs BEFORE the
        scan, so concurrent applies maintain it through the write path,
        and the merge defers to every key they touched.  A torn payload
        rebuilds with the recorded method and options; a directory with
        no readable metadata is ignored.  Returns the indexes restored."""
        from ..vector.registry import load_index
        root = os.path.join(self.dir, "vecidx")
        if not os.path.isdir(root):
            return 0
        pk_names = self._pk_names()
        restored = 0
        for ent in sorted(os.listdir(root)):
            path = os.path.join(root, ent)
            try:
                with open(os.path.join(path, "tablet_meta.msgpack"),
                          "rb") as f:
                    tmeta = wire_pack.unpackb(f.read())
                cid = self.info.schema.column_by_name(
                    tmeta["col_name"]).id
                if str(cid) != ent:
                    continue        # the schema changed under the index
            except Exception:   # noqa: BLE001 — no metadata: ignore dir
                continue
            idx = load_index(path, self.device)
            # pks are positional: pks[i] owns index id i
            pks = [dict(p) for p in tmeta.get("pks", [])]
            if idx is None or idx.size != len(pks):
                # torn payload: rebuild from the store with the recorded
                # shape (the "rebuild" half of the contract)
                self.build_vector_index(
                    tmeta["col_name"],
                    int(tmeta.get("options", {}).get("lists", 100)),
                    tmeta.get("method", "ivfflat"),
                    tmeta.get("options"))
                restored += 1
                continue
            state = _VectorIndexState(tmeta["col_name"],
                                      tmeta.get("method", "ivfflat"),
                                      tmeta.get("options"))
            state.idx = idx
            state.pks = pks
            state.frozen_pos = {tuple(p[n] for n in pk_names): i
                                for i, p in enumerate(pks)}
            state.frozen_keys = set(state.frozen_pos)
            # install FIRST: concurrent applies maintain the delta from
            # here on and record every key they touch, so the merge
            # below defers to them
            state.touched = set()
            with self._lock:
                self.vector_indexes[cid] = state
            # scan-diff against the live store
            cur_pks, cur_vecs = self._scan_vectors(state.col_name)
            frozen = idx.vectors_in_id_order()
            pos = state.frozen_pos
            cur_keys = set()
            diff = []
            for j, pk in enumerate(cur_pks):
                key = tuple(pk[n] for n in pk_names)
                cur_keys.add(key)
                i = pos.get(key)
                if i is not None and np.array_equal(cur_vecs[j],
                                                    frozen[i]):
                    continue
                diff.append((key, (pk, cur_vecs[j].tobytes(), None),
                             i is not None))
            with self._lock:
                for key, entry, was_frozen in diff:
                    if key in state.touched or key in state.delta \
                            or key in state.dead:
                        continue    # maintenance got there first
                    state.delta[key] = entry
                    if was_frozen:
                        state.dead.add(key)
                state.dead |= state.frozen_keys - cur_keys \
                    - set(state.delta) - state.touched
                state.touched = None
            restored += 1
        return restored
