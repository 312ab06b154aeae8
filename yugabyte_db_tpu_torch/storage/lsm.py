"""Per-tablet LSM store, the part compaction runs on: the manifest, the
live SST set, bulk ingest and the atomic swap of compaction inputs for
their output.

Counterpart of ``yugabyte_db_tpu/storage/lsm.py`` (reference analog:
the forked RocksDB DB instance per tablet, src/yb/rocksdb/db/db_impl.cc)
cut to ``__init__``, the manifest (load, write, the open-time sweep of
unmanifested files), ``ingest_sst``, ``_new_sst_path``, ``ssts``,
``approximate_size`` and ``replace_ssts``.  The manifest is the
reference's JSON, so either package opens a directory the other wrote.
The memtable, flush, reader leases, checkpoints and the row-feed
``compact`` come with the row paths (ROADMAP.md queue 1 item 9)."""
from __future__ import annotations

import json
import os
import re
import threading
from typing import Callable, List, Optional, Sequence

from ..errors import NotPortedError
from .sst import SstReader, SstWriter


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
        removed.  If an input left the store while the merge ran, the
        output is discarded instead."""
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
            try:
                os.remove(r.path)
            except FileNotFoundError:
                pass
