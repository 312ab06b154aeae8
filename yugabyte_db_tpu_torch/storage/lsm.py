"""Per-tablet LSM store: memtable + SSTs + flush + compaction.

Counterpart of ``yugabyte_db_tpu/storage/lsm.py`` (reference analog:
the forked RocksDB DB instance per tablet, src/yb/rocksdb/db/db_impl.cc)
with the YB traits kept: no WAL of its own (the Raft log is the WAL),
consensus frontiers persisted in SST files and the manifest, and the
streaming ``CompactionFeed`` seam (reference:
src/yb/rocksdb/compaction_filter.h).  Writes land in the active
memtable; a flush freezes it (a pointer swap) and writes the oldest
frozen memtable to an SST under the flush IO lock, so installs stay
oldest-first.  Reads merge the memtables and SSTs newest-first.  The
out-of-band reader leases (``SstLease``, ``pin_ssts``) let the bypass
reader scan a tablet's files while a compaction replaces them.  The
manifest is the reference's JSON, so either package opens a directory
the other wrote.  Truncate and checkpoints are not ported (ROADMAP.md
queue 1 item 9a)."""
from __future__ import annotations

import json
import os
import re
import threading
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

from ..utils import flags
from .memtable import MemTable
from .merge import merging_iterator
from .sst import SstReader, SstWriter


@dataclass
class WriteBatch:
    """Ordered KV puts applied atomically to the memtable.  Deletes are
    tombstone values written by the docdb layer; storage does not
    interpret values."""
    entries: List[Tuple[bytes, bytes]] = field(default_factory=list)
    # Raft op id (term, index) that produced this batch; becomes the
    # flushed frontier when the memtable holding it is flushed
    op_id: Optional[Tuple[int, int]] = None

    def put(self, key: bytes, value: bytes) -> "WriteBatch":
        self.entries.append((key, value))
        return self

    def __len__(self):
        return len(self.entries)


class CompactionFeed:
    """Streaming compaction hook (reference: rocksdb/compaction_filter.h
    CompactionFeed).  Subclasses see the merged, sorted entry stream and
    decide what survives into the output SST: ``feed`` returns entries
    to emit now, ``flush`` emits any held-back tail, ``feed_block``
    takes whole sorted runs at once (by default per-row ``feed``)."""

    def feed(self, key: bytes, value: bytes) -> List[Tuple[bytes, bytes]]:
        return [(key, value)]

    def feed_block(self, entries: Sequence[Tuple[bytes, bytes]]
                   ) -> List[Tuple[bytes, bytes]]:
        out: List[Tuple[bytes, bytes]] = []
        for k, v in entries:
            out.extend(self.feed(k, v))
        return out

    def flush(self) -> List[Tuple[bytes, bytes]]:
        return []


class SstLease:
    """Refcount lease over an LsmStore's live SST FILES: while held, a
    compaction may drop the files from the store, but their physical
    deletion waits for the last lease (rocksdb's version refcounting,
    which keeps obsolete files alive for open iterators).  Out-of-band
    readers (the bypass reader) open the leased paths directly.
    Release once via :meth:`release` or the context manager; a lease
    lost with its process leaves unmanifested files that the store's
    open-time sweep reclaims."""

    def __init__(self, store: "LsmStore", paths: List[str],
                 frontier: dict):
        self.store = store
        self.paths = paths
        self.frontier = frontier
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self.store._release_pins(self.paths)

    @property
    def released(self) -> bool:
        return self._released

    def __enter__(self) -> "SstLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class LsmStore:
    def __init__(self, directory: str, name: str = "db",
                 columnar_builder=None, row_decoder=None,
                 key_builder=None, shred_cols=None):
        self.dir = directory
        self.name = name
        # a flushed row block's columnar sidecar, and a columnar-only
        # block's KV entries (the codec's callables)
        self.columnar_builder = columnar_builder
        self.row_decoder = row_decoder
        # v2 keyless-block support: rebuilds a block's key matrix from
        # its pk + MVCC lanes (the codec's derive_keys); writers verify
        # key drops against it, readers re-derive lazily through it
        self.key_builder = key_builder
        # JSON column ids to document-shred; SstWriter refuses them
        self.shred_cols = tuple(shred_cols or ())
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.RLock()
        # serializes the file-writing half of flushes (the background
        # executor against an inline drain): frozen memtables must reach
        # disk oldest-first or the newest-first SST order and the
        # flushed frontier would both break
        self._flush_io_lock = threading.Lock()
        self._mem = MemTable()
        self._frozen: List[MemTable] = []
        # id(frozen memtable) -> the _mem_frontier captured at freeze
        self._frozen_frontiers: Dict[int, dict] = {}
        self._ssts: List[SstReader] = []       # newest first
        self._next_file = 0
        self._flushed_frontier: dict = {}
        self._write_gen = 0
        self._struct_gen = 0           # bumps on flush/compact/replace
        self._snap = None              # cached (gen key, (mems, ssts))
        self._mem_frontier: dict = {}
        # reader leases: path -> refcount; paths dropped while pinned
        # wait in _deferred until the last lease goes
        self._pins: Dict[str, int] = {}
        self._deferred: set = set()
        self._load_manifest()
        self._sweep_unmanifested()

    # --- manifest ---------------------------------------------------------
    @property
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, f"{self.name}.MANIFEST")

    def _reader(self, path: str) -> SstReader:
        return SstReader(path, row_decoder=self.row_decoder,
                         key_builder=self.key_builder)

    def _load_manifest(self) -> None:
        if not os.path.exists(self._manifest_path):
            return
        with open(self._manifest_path) as f:
            m = json.load(f)
        self._next_file = m["next_file"]
        self._flushed_frontier = m.get("flushed_frontier", {})
        for fname in m["ssts"]:
            self._ssts.append(self._reader(os.path.join(self.dir, fname)))

    def _write_manifest(self) -> None:
        m = {
            "next_file": self._next_file,
            "flushed_frontier": self._flushed_frontier,
            "ssts": [os.path.basename(r.path) for r in self._ssts],
        }
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(m, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path)

    def _sweep_unmanifested(self) -> None:
        """The manifest is the single source of truth for live SSTs: any
        ``<name>.NNNNNN.sst`` (or its ``.tmp``) it does not reference is
        the leftover of an ingest or compaction that crashed before its
        manifest install, and is removed at open."""
        live = {os.path.basename(r.path) for r in self._ssts}
        pat = re.compile(re.escape(self.name) + r"\.\d{6,}\.sst(\.tmp)?$")
        for fn in os.listdir(self.dir):
            if pat.fullmatch(fn) and fn not in live:
                try:
                    os.unlink(os.path.join(self.dir, fn))
                except FileNotFoundError:
                    pass

    # --- out-of-band reader leases ----------------------------------------
    def pin_ssts(self, require_empty_memtable: bool = False
                 ) -> Optional[SstLease]:
        """Lease the current live SST set against file GC.  With
        ``require_empty_memtable`` the pin succeeds only while no
        memtable (active or frozen) holds rows — checked under the lock
        that installs flush output, so the leased files are a complete
        image of everything applied before the pin; None otherwise, for
        the caller to retry after a flush."""
        with self._lock:
            if require_empty_memtable and not self.memtable_empty():
                return None
            paths = [r.path for r in self._ssts]
            for p in paths:
                self._pins[p] = self._pins.get(p, 0) + 1
            frontier = dict(self._flushed_frontier)
        return SstLease(self, paths, frontier)

    def _release_pins(self, paths: Sequence[str]) -> None:
        drop: List[str] = []
        with self._lock:
            for p in paths:
                c = self._pins.get(p, 0) - 1
                if c > 0:
                    self._pins[p] = c
                else:
                    self._pins.pop(p, None)
                    if p in self._deferred:
                        self._deferred.discard(p)
                        drop.append(p)
        for p in drop:
            try:
                os.unlink(p)
            except OSError:
                pass

    def _gc_file(self, path: str) -> None:
        """Remove a file the store no longer owns, or defer it while a
        lease pins it (the last release unlinks it)."""
        with self._lock:
            if self._pins.get(path, 0) > 0:
                self._deferred.add(path)
                return
        try:
            os.remove(path)
        except OSError:
            pass

    def pin_stats(self) -> dict:
        with self._lock:
            return {"pinned_files": sum(1 for c in self._pins.values()
                                        if c > 0),
                    "deferred_deletes": len(self._deferred)}

    # --- writes -----------------------------------------------------------
    def apply(self, batch: WriteBatch) -> None:
        with self._lock:
            for k, v in batch.entries:
                self._mem.put(k, v)
            self._write_gen += 1
            if batch.op_id is not None:
                self._mem_frontier["op_id"] = list(batch.op_id)

    def write_generation(self) -> int:
        """Monotone counter bumped on every memtable write: device batch
        cache keys include it, so a cached batch can never hide a newer
        committed write."""
        return self._write_gen

    def read_snapshot(self):
        """Cached ([non-empty memtables], [ssts]) for point reads.  The
        key covers data writes (_write_gen) and structural changes
        (_struct_gen), so a snapshot is never served after a write,
        flush or compaction it does not contain."""
        key = (self._write_gen, self._struct_gen)
        snap = self._snap
        if snap is not None and snap[0] == key:
            return snap[1]
        with self._lock:
            mems = [m for m in [self._mem] + list(self._frozen)
                    if not m.empty()]
            val = (mems, list(self._ssts))
            self._snap = ((self._write_gen, self._struct_gen), val)
        return val

    def should_flush(self) -> bool:
        return (self._mem.approximate_bytes()
                >= flags.get("memstore_flush_threshold_bytes"))

    def freeze_active(self) -> bool:
        """Freeze the active memtable into the frozen queue — an
        in-memory pointer swap (the fast half of a flush).  True when a
        new frozen memtable was produced."""
        with self._lock:
            if self._mem.empty():
                return False
            mem = self._mem
            mem.freeze()
            self._frozen.append(mem)
            self._frozen_frontiers[id(mem)] = dict(self._mem_frontier)
            self._mem = MemTable()
            self._struct_gen += 1
            self._mem_frontier = {}
        return True

    def frozen_count(self) -> int:
        with self._lock:
            return len(self._frozen)

    def flush_frozen(self, wait: bool = True) -> Optional[str]:
        """Write the OLDEST frozen memtable to an SST and install it (the
        slow half of a flush: file write, fsync, manifest), serialized
        under the flush IO lock so a background flush and an inline
        drain never install out of order.  ``wait=False`` gives up at
        once when another flush owns the IO lock.  Returns the new SST
        path, or None when there was nothing to do or the lock was
        busy."""
        if not self._flush_io_lock.acquire(blocking=wait):
            return None
        try:
            with self._lock:
                if not self._frozen:
                    return None
                mem = self._frozen[0]
                frontier = dict(self._frozen_frontiers.get(id(mem), {}))
            path = self._new_sst_path()
            w = SstWriter(path, columnar_builder=self.columnar_builder,
                          key_builder=self.key_builder,
                          shred_cols=self.shred_cols)
            for k, v in mem.iterate():
                w.add(k, v)
            w.set_frontier(**frontier)
            w.finish()
            with self._lock:
                self._ssts.insert(0, self._reader(path))
                self._frozen.remove(mem)
                self._frozen_frontiers.pop(id(mem), None)
                self._struct_gen += 1
                if "op_id" in frontier:
                    cur = self._flushed_frontier.get("op_id")
                    if cur is None or frontier["op_id"] > cur:
                        self._flushed_frontier["op_id"] = frontier["op_id"]
                self._write_manifest()
            return path
        finally:
            self._flush_io_lock.release()

    def flush(self, wait: bool = True) -> Optional[str]:
        """Freeze the memtable and drain EVERY frozen memtable to SSTs
        (helping any in-flight background flush along: the IO lock
        serializes installs).  ``wait=False`` never blocks behind a
        foreign flush that owns the IO lock.  Returns the last SST path
        written (None if nothing flushed)."""
        self.freeze_active()
        last = None
        while True:
            with self._lock:
                if not self._frozen:
                    return last
            p = self.flush_frozen(wait=wait)
            if p is not None:
                last = p
            elif not wait:
                return last     # a foreign flush owns the IO lock

    def ingest_sst(self, build: Callable[[SstWriter], None],
                   frontier: Optional[dict] = None,
                   stream: bool = False) -> str:
        """Bulk load: the caller fills a writer (rows or columnar blocks).
        ``stream=True`` opens the writer in stream-columnar mode: each
        add_columnar_block hits the file immediately, so a pipelined
        builder overlaps its gathers with the IO."""
        path = self._new_sst_path()
        w = SstWriter(path, columnar_builder=self.columnar_builder,
                      stream_columnar=stream,
                      sync_every_bytes=(64 << 20) if stream else None,
                      key_builder=self.key_builder,
                      shred_cols=self.shred_cols)
        try:
            build(w)
        except BaseException:
            w.abort()
            raise
        if frontier:
            w.set_frontier(**frontier)
        w.finish()
        with self._lock:
            self._ssts.insert(0, self._reader(path))
            self._struct_gen += 1
            self._write_manifest()
        return path

    def _new_sst_path(self) -> str:
        with self._lock:
            n = self._next_file
            self._next_file += 1
        return os.path.join(self.dir, f"{self.name}.{n:06d}.sst")

    # --- reads ------------------------------------------------------------
    def iterate(self, lower: Optional[bytes] = None,
                upper: Optional[bytes] = None
                ) -> Iterator[Tuple[bytes, bytes]]:
        """Merged view, ascending; the newest source wins on exact-key
        ties."""
        with self._lock:
            sources = [self._mem.iterate(lower, upper)]
            sources += [m.iterate(lower, upper)
                        for m in reversed(self._frozen)]
            sources += [r.iterate(lower, upper) for r in self._ssts]
        return merging_iterator(sources)

    def seek(self, key: bytes) -> Iterator[Tuple[bytes, bytes]]:
        return self.iterate(lower=key)

    def get(self, key: bytes) -> Optional[bytes]:
        """Exact-key point get."""
        for k, v in self.iterate(lower=key):
            return v if k == key else None
        return None

    @property
    def ssts(self) -> List[SstReader]:
        with self._lock:
            return list(self._ssts)

    def memtable_empty(self) -> bool:
        return self._mem.empty() and not self._frozen

    def memtables(self) -> List[MemTable]:
        """The active memtable, then the frozen ones oldest first."""
        with self._lock:
            return [self._mem] + list(self._frozen)

    def flushed_frontier(self) -> dict:
        return dict(self._flushed_frontier)

    def approximate_size(self) -> int:
        with self._lock:
            return (sum(r.file_size for r in self._ssts)
                    + self._mem.approximate_bytes())

    # --- compaction -------------------------------------------------------
    def pick_compaction(self, max_files: int = 8) -> List[SstReader]:
        """The OLDEST contiguous run (universal compaction picks
        age-adjacent runs): contiguity in age lets the output go after
        every kept (newer) SST without breaking the newest-source-wins
        merge."""
        with self._lock:
            if len(self._ssts) < 4:
                return []
            return list(self._ssts[-max_files:])   # newest-first list tail

    def compact(self, inputs: Optional[Sequence[SstReader]] = None,
                feed: Optional[CompactionFeed] = None,
                is_major: bool = False) -> Optional[str]:
        """Merge `inputs` (default: every SST, a major compaction)
        through the feed into one output SST, in chunks of 4096 merged
        entries (``feed_block``)."""
        with self._lock:
            if inputs is None:
                inputs = list(self._ssts)
                is_major = True
            inputs = list(inputs)
        if not inputs:
            return None
        feed = feed or CompactionFeed()
        path = self._new_sst_path()
        w = SstWriter(path, columnar_builder=self.columnar_builder,
                      key_builder=self.key_builder,
                      shred_cols=self.shred_cols)
        merged = merging_iterator([r.iterate() for r in inputs])
        batch: List[Tuple[bytes, bytes]] = []
        for kv in merged:
            batch.append(kv)
            if len(batch) >= 4096:
                for ok, ov in feed.feed_block(batch):
                    w.add(ok, ov)
                batch = []
        if batch:
            for ok, ov in feed.feed_block(batch):
                w.add(ok, ov)
        for ok, ov in feed.flush():
            w.add(ok, ov)
        frontier = {}
        for r in inputs:
            if "op_id" in r.frontier:
                op = r.frontier["op_id"]
                if "op_id" not in frontier or op > frontier["op_id"]:
                    frontier["op_id"] = op
        w.set_frontier(**frontier)
        w.finish()
        self.replace_ssts(inputs, path)
        return path

    def replace_ssts(self, old: Sequence[SstReader], new_path: str) -> None:
        """Install a compaction's output in place of its inputs: the
        output is older than anything not among the inputs, so it goes
        last; the manifest swaps atomically, then the inputs' files are
        removed (or, while a lease pins one, left for its last release).
        If an input left the store while the merge ran, the output is
        discarded instead."""
        with self._lock:
            old_set = {id(r) for r in old}
            live = {id(r) for r in self._ssts}
            if not old_set <= live:
                try:
                    os.remove(new_path)
                except FileNotFoundError:
                    pass
                return
            new_reader = self._reader(new_path)
            kept = [r for r in self._ssts if id(r) not in old_set]
            self._ssts = kept + [new_reader]
            self._struct_gen += 1
            self._write_manifest()
        for r in old:
            self._gc_file(r.path)
