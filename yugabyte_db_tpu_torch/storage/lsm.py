"""Per-tablet LSM store, the part compaction runs on: the manifest, the
live SST set, bulk ingest and the atomic swap of compaction inputs for
their output.

Counterpart of ``yugabyte_db_tpu/storage/lsm.py`` (reference analog:
the forked RocksDB DB instance per tablet, src/yb/rocksdb/db/db_impl.cc)
cut to ``__init__``, the manifest (load, write, the open-time sweep of
unmanifested files), ``ingest_sst``, ``_new_sst_path``, ``ssts``,
``approximate_size``, ``replace_ssts`` and the out-of-band reader
leases (``SstLease``, ``pin_ssts``) that let the bypass reader scan a
tablet's files while a compaction replaces them.  The manifest is the
reference's JSON, so either package opens a directory the other wrote.
The memtable, flush, checkpoints and the row-feed ``compact`` come with
the row paths (ROADMAP.md queue 1 item 9): the port's store has no
memtable, so it is always empty."""
from __future__ import annotations

import json
import os
import re
import threading
from typing import Callable, Dict, List, Optional, Sequence

from ..errors import NotPortedError
from .sst import SstReader, SstWriter


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
    def __init__(self, directory: str, name: str = "db", key_builder=None,
                 shred_cols=None):
        self.dir = directory
        self.name = name
        # v2 keyless-block support: rebuilds a block's key matrix from
        # its pk + MVCC lanes (the codec's derive_keys); writers verify
        # key drops against it, readers re-derive lazily through it
        self.key_builder = key_builder
        # JSON column ids to document-shred; SstWriter refuses them
        self.shred_cols = tuple(shred_cols or ())
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.RLock()
        self._ssts: List[SstReader] = []       # newest first
        self._next_file = 0
        self._flushed_frontier: dict = {}
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
        return SstReader(path, key_builder=self.key_builder)

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
        memtable holds rows (None otherwise, for the caller to retry
        after a flush); the port's store has none, so it always does."""
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

    def memtable_empty(self) -> bool:
        """True: the port's store has no memtable (ROADMAP.md queue 1
        item 9)."""
        return True

    # --- writes -----------------------------------------------------------
    def ingest_sst(self, build: Callable[[SstWriter], None],
                   frontier: Optional[dict] = None,
                   stream: bool = False) -> str:
        """Bulk load: the caller fills a writer with columnar blocks.
        ``stream=True`` opens the writer in stream-columnar mode: each
        add_columnar_block hits the file immediately, so a pipelined
        builder overlaps its gathers with the IO."""
        path = self._new_sst_path()
        w = SstWriter(path, stream_columnar=stream,
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
            self._write_manifest()
        return path

    def _new_sst_path(self) -> str:
        with self._lock:
            n = self._next_file
            self._next_file += 1
        return os.path.join(self.dir, f"{self.name}.{n:06d}.sst")

    # --- reads ------------------------------------------------------------
    @property
    def ssts(self) -> List[SstReader]:
        with self._lock:
            return list(self._ssts)

    def approximate_size(self) -> int:
        """Bytes of the live SST files (the port has no memtable)."""
        with self._lock:
            return sum(r.file_size for r in self._ssts)

    # --- compaction -------------------------------------------------------
    def compact(self, inputs=None, feed=None, is_major: bool = False):
        raise NotPortedError(
            "LsmStore.compact (the streaming row-feed compaction)",
            "ROADMAP.md queue 1 item 9 (row KV blocks and feeds)")

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
            self._write_manifest()
        for r in old:
            self._gc_file(r.path)
