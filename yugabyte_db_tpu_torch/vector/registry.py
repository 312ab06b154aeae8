"""ANN index registry: one common interface, pluggable methods.

Counterpart of ``yugabyte_db_tpu/vector/registry.py`` (upstream: the
ANNMethodKind dispatch of src/yb/ann_methods/ann_methods.h): python
classes keyed by the DDL method name (``USING ivfflat``, ``USING
hnsw``), each with the same five verbs — build / add / search / save /
load.  ``save`` writes the reference's on-disk format (``index.npz`` +
``meta.json``), so an index saved by either package loads in the other.
"""
from __future__ import annotations

import abc
import json
import os
from typing import Dict, Optional, Tuple, Type

import numpy as np

from ..device import DeviceLike

_REGISTRY: Dict[str, Type["AnnIndex"]] = {}


def register_index(name: str, *aliases: str):
    """Class decorator: register an AnnIndex under its DDL method name."""
    def deco(cls):
        cls.method = name
        for n in (name,) + aliases:
            _REGISTRY[n] = cls
        return cls
    return deco


def get_index_cls(method: str) -> Type["AnnIndex"]:
    try:
        return _REGISTRY[method]
    except KeyError:
        raise ValueError(
            f"unknown vector index method {method!r} "
            f"(available: {sorted(set(_REGISTRY))})") from None


def available_methods():
    return sorted({c.method for c in _REGISTRY.values()})


class AnnIndex(abc.ABC):
    """Common ANN index contract.

    Row identity is positional: vector ``i`` of the build matrix (and
    each subsequently added vector, in add order) owns id ``i``; the
    caller keeps the id -> primary-key mapping (the tablet's ``pks``
    list).  ``search`` returns (distances [Q, k], ids [Q, k]) with
    squared-L2 distances; unfilled slots carry ``inf`` / id ``-1``.
    """

    method: str = "?"

    # ---- construction ----------------------------------------------------
    @classmethod
    @abc.abstractmethod
    def build(cls, data: np.ndarray, **options) -> "AnnIndex":
        """Build from an [N, D] float32 matrix."""

    @abc.abstractmethod
    def add(self, vectors: np.ndarray) -> None:
        """Append vectors; they get the next positional ids."""

    # ---- search ----------------------------------------------------------
    @abc.abstractmethod
    def search(self, queries: np.ndarray, k: int = 10, **params
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(distances [Q, k] float32, ids [Q, k] int64)."""

    # ---- size ------------------------------------------------------------
    @property
    @abc.abstractmethod
    def size(self) -> int:
        """Number of indexed vectors (== next positional id)."""

    @property
    @abc.abstractmethod
    def dim(self) -> int:
        """Vector dimensionality."""

    @abc.abstractmethod
    def vectors_in_id_order(self) -> np.ndarray:
        """[size, dim] float32 matrix with row i = the vector owning
        positional id i (the tablet's bootstrap scan-diff compares
        this against a fresh store scan)."""

    def vector_of(self, id_: int) -> np.ndarray:
        """Single indexed vector by positional id (O(1) view where the
        layout allows; the WAL-replay idempotence check in the tablet's
        index maintenance reads one row per re-applied write)."""
        return self.vectors_in_id_order()[id_]

    # ---- persistence -----------------------------------------------------
    @abc.abstractmethod
    def _state_arrays(self) -> Dict[str, np.ndarray]:
        """Index payload as plain numpy arrays (savez fodder)."""

    @abc.abstractmethod
    def _state_meta(self) -> dict:
        """JSON-safe scalar state (knobs, counters)."""

    @classmethod
    @abc.abstractmethod
    def _from_state(cls, arrays: Dict[str, np.ndarray], meta: dict,
                    device: DeviceLike = "cuda") -> "AnnIndex":
        """Rebuild from _state_arrays + _state_meta output; a device
        index lands on `device`."""

    def save(self, path: str) -> None:
        """Persist to ``path`` (a directory): index.npz + meta.json,
        written atomically (tmp + rename) so a crash mid-save leaves
        either the old index or the new one, never a torn file."""
        os.makedirs(path, exist_ok=True)
        tmp_npz = os.path.join(path, ".index.npz.tmp")
        with open(tmp_npz, "wb") as f:
            np.savez(f, **self._state_arrays())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_npz, os.path.join(path, "index.npz"))
        tmp_meta = os.path.join(path, ".meta.json.tmp")
        with open(tmp_meta, "w") as f:
            json.dump({"method": self.method, **self._state_meta()}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_meta, os.path.join(path, "meta.json"))

    @classmethod
    def load(cls, path: str, device: DeviceLike = "cuda") -> "AnnIndex":
        """Load an index saved by :meth:`save` (by either package).
        Called on the base class, dispatches to the method recorded in
        meta.json; a device index lands on `device`."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        target = get_index_cls(meta["method"])
        if cls is not AnnIndex and not issubclass(target, cls):
            raise ValueError(
                f"index at {path} is {meta['method']!r}, not "
                f"{cls.method!r}")
        with np.load(os.path.join(path, "index.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        return target._from_state(arrays, meta, device)


def merge_topk(dd: np.ndarray, ii: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Final k-merge over candidate (distances [Q, C], ids [Q, C])
    pairs: invalid slots (id < 0) mask to inf, partial-select then
    stable sort, pad to k with inf/-1.  The ONE implementation behind
    the CPU re-rank merge, the add()-tail merge and the sharded-shard
    merge — keep tie-breaking/masking rules here only."""
    dd = np.where(ii >= 0, dd, np.inf).astype(np.float32, copy=False)
    nq = dd.shape[0]
    kk = min(k, dd.shape[1])
    if kk > 0:
        sel = np.argpartition(dd, kk - 1, axis=1)[:, :kk]
        dd = np.take_along_axis(dd, sel, axis=1)
        ii = np.take_along_axis(ii, sel, axis=1)
        o = np.argsort(dd, axis=1, kind="stable")
        dd = np.take_along_axis(dd, o, axis=1)
        ii = np.take_along_axis(ii, o, axis=1)
    D = np.full((nq, k), np.inf, np.float32)
    I = np.full((nq, k), -1, np.int64)
    D[:, :kk] = dd
    I[:, :kk] = np.where(np.isfinite(dd), ii, -1)
    return D, I


def load_index(path: str, device: DeviceLike = "cuda"
               ) -> Optional[AnnIndex]:
    """Best-effort load: None when absent or unreadable (a torn or
    stale on-disk index must degrade to a rebuild, never fail the
    tablet bootstrap)."""
    try:
        return AnnIndex.load(path, device)
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return None
