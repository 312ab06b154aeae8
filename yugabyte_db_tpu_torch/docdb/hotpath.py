"""Loader of the port's host hot-path extension (csrc/host_hot.c).

Counterpart of ``yugabyte_db_tpu/docdb/hotpath.py``: the CPython
extension ``host_hot`` that does the point-read path's per-key work in C
(``PointReader``: bloom, block bisect, MVCC walk and row materialization
for a whole key list in one call per SST; ``range_read``; the row
``Extractor``, ``BlockFinder``, ``Packer``, ``encode_doc_key``,
``fnv64`` and ``bloom_may_contain``).  It is built with ``g++`` and the
Python headers at first use into ``build/host_hot/`` (keyed by the
source's hash and the interpreter's extension suffix) and a failed build
or load raises ``NativeBuildError``: ``load()`` never returns None, and
no caller swaps in a Python loop when the extension is missing.

``POINT_READ_STATS`` counts which route served each point read, so a run
can show that the compiled path did the work."""
from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

from ..storage.native_lib import NativeBuildError

MODULE = "host_hot"
_SRC = Path(__file__).resolve().parents[1] / "csrc" / "host_hot.c"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_hot"

_MOD = None
_LOCK = threading.Lock()

#: route counters of the point-read path (process-wide, cumulative):
#: ``readers_built`` / ``reader_build_s`` / ``reader_rows`` /
#: ``reader_heap_bytes`` — whole-SST PointReaders made, the seconds and
#: the rows and bytes of block arrays they pin; ``readers_refused`` —
#: SSTs over ``native_point_reader_max_rows``; ``find_many_keys`` — keys
#: answered by PointReader.find_many; ``range_read_calls`` /
#: ``range_read_keys`` — fused range reads and their keys;
#: ``per_key_keys`` — keys served one at a time in Python (a block
#: without a columnar sidecar, an SST without a reader, a snapshot shape
#: the fused range read does not take); ``memtable_keys`` — keys whose
#: memtable guard hit and merged the memtable's version
POINT_READ_STATS = {"readers_built": 0, "reader_build_s": 0.0,
                    "reader_rows": 0, "reader_heap_bytes": 0,
                    "readers_refused": 0, "find_many_keys": 0,
                    "range_read_calls": 0, "range_read_keys": 0,
                    "per_key_keys": 0, "memtable_keys": 0}


def reset_stats() -> None:
    """Zero every route counter."""
    for k, v in POINT_READ_STATS.items():
        POINT_READ_STATS[k] = type(v)()


def library_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:16]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return _BUILD_DIR / f"{MODULE}_{digest}{suffix}"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}."
                         f"{threading.get_ident()}.tmp")
    inc = sysconfig.get_paths()["include"]
    # no -march=native: the checkout (build/ included) may move to a
    # machine with another CPU
    cmd = ["g++", "-O3", "-shared", "-fPIC", f"-I{inc}", str(_SRC),
           "-o", str(tmp)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"g++ could not run: {e!r}") from e
    if out.returncode != 0:
        raise NativeBuildError(f"g++ failed on {_SRC.name}:\n"
                               f"{out.stderr[-4000:]}")
    os.replace(tmp, path)      # atomic: concurrent builds race safely


def load():
    """The ``host_hot`` extension module, built on first use."""
    global _MOD
    if _MOD is not None:
        return _MOD
    with _LOCK:
        if _MOD is not None:
            return _MOD
        path = library_path()
        if not path.exists():
            _build(path)
        try:
            spec = importlib.util.spec_from_file_location(MODULE, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except (ImportError, OSError) as e:
            raise NativeBuildError(f"cannot load {path}: {e}") from e
        _MOD = mod
        return mod
