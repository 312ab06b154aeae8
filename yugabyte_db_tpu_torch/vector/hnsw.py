"""HNSW graph index: the recall-frontier host-path twin of the IVF.

Counterpart of ``yugabyte_db_tpu/vector/hnsw.py``, a copy: the graph
walk runs on the host in both packages.  Pure numpy (adjacency
rectangles): per level an [capacity, width] int32 neighbor table (-1
padded), greedy layered descent from the top entry point, and a classic
best-first beam at the base layer bounded by ``ef_search`` (upstream:
src/yb/hnsw/hnsw.cc and the usearch wrapper in
src/yb/ann_methods/usearch_wrapper.cc; algorithm per Malkov & Yashunin).
A graph walk is a chain of dependent gathers, a poor fit for a GEMM
engine: this index owns the high-recall/low-qps end of the frontier,
the two-stage IVF the GEMM-shaped end.

Build is incremental: ``add`` inserts with a beam of
``ef_construction`` candidates per layer.  Neighbor selection is
closest-M with reverse-link pruning to the level width.
"""
from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike
from .registry import AnnIndex, register_index


@register_index("hnsw")
class HnswIndex(AnnIndex):
    #: adjacency width: base layer gets 2*m (hnswlib's M_max0)
    def __init__(self, dim: int, m: int = 16, ef_construction: int = 100,
                 ef_search: int = 64, seed: int = 0,
                 options: Optional[dict] = None):
        self._dim = int(dim)
        self.m = int(m)
        self.m0 = 2 * self.m
        self.ef_construction = int(ef_construction)
        self.ef_search = int(ef_search)
        self._ml = 1.0 / math.log(max(2, self.m))
        self._rng = np.random.default_rng(seed)
        self.options = dict(options or {},
                            m=self.m, ef_construction=self.ef_construction,
                            ef_search=self.ef_search)
        cap = 1024
        self.vecs = np.zeros((cap, self._dim), np.float32)
        self.norms = np.zeros(cap, np.float32)
        self.levels = np.full(cap, -1, np.int8)
        self._adj: List[np.ndarray] = [np.full((cap, self.m0), -1,
                                               np.int32)]
        self._n = 0
        self._ep = -1            # entry point node id
        self._max_level = 0

    # ---- construction ----------------------------------------------------
    @classmethod
    def build(cls, data: np.ndarray, m: int = 16,
              ef_construction: int = 100, ef_search: int = 64,
              seed: int = 0, **extra) -> "HnswIndex":
        data = np.asarray(data, np.float32)
        d = data.shape[1] if data.ndim == 2 and data.shape[1] else 1
        idx = cls(d, m=m, ef_construction=ef_construction,
                  ef_search=ef_search, seed=seed, options=extra)
        if len(data):
            idx.add(data)
        return idx

    def _grow(self, need: int) -> None:
        cap = len(self.vecs)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        for name in ("vecs", "norms", "levels"):
            old = getattr(self, name)
            shape = (cap,) + old.shape[1:]
            new = (np.full(shape, -1, old.dtype) if name == "levels"
                   else np.zeros(shape, old.dtype))
            new[:len(old)] = old
            setattr(self, name, new)
        for l, adj in enumerate(self._adj):
            new = np.full((cap, adj.shape[1]), -1, np.int32)
            new[:len(adj)] = adj
            self._adj[l] = new

    def _level_adj(self, level: int) -> np.ndarray:
        while level >= len(self._adj):
            self._adj.append(np.full((len(self.vecs), self.m), -1,
                                     np.int32))
        return self._adj[level]

    def add(self, vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        self._grow(self._n + len(vectors))
        for v in vectors:
            self._insert(v)

    def _insert(self, v: np.ndarray) -> None:
        nid = self._n
        self.vecs[nid] = v
        self.norms[nid] = float(v @ v)
        lvl = int(-math.log(max(self._rng.random(), 1e-12)) * self._ml)
        self.levels[nid] = lvl
        self._n += 1
        if self._ep < 0:
            self._ep = nid
            self._max_level = lvl
            self._level_adj(lvl)     # materialize levels up front
            return
        ep = [self._ep]
        # zoom down through levels above the new node's level
        for l in range(self._max_level, lvl, -1):
            ep = self._greedy_step(v, ep[0], l)
        for l in range(min(self._max_level, lvl), -1, -1):
            cand = self._search_layer(v, ep, self.ef_construction, l)
            width = self.m0 if l == 0 else self.m
            sel = [i for _, i in cand[:self.m]]
            adj = self._level_adj(l)
            adj[nid, :len(sel)] = sel
            for s in sel:
                self._link(adj, s, nid, width)
            ep = [i for _, i in cand]
        if lvl > self._max_level:
            self._max_level = lvl
            self._ep = nid

    def _link(self, adj: np.ndarray, src: int, dst: int,
              width: int) -> None:
        """Add dst to src's neighbor row, pruning to `width` closest."""
        row = adj[src]
        free = np.nonzero(row < 0)[0]
        if len(free):
            row[free[0]] = dst
            return
        cand = np.concatenate([row, [dst]]).astype(np.int64)
        d = (self.norms[cand] - 2.0 * (self.vecs[cand] @ self.vecs[src])
             + self.norms[src])
        keep = cand[np.argpartition(d, width - 1)[:width]]
        adj[src, :] = keep.astype(np.int32)

    # ---- search ----------------------------------------------------------
    def _dists(self, q: np.ndarray, qn: float, ids: np.ndarray
               ) -> np.ndarray:
        return np.maximum(
            qn + self.norms[ids] - 2.0 * (self.vecs[ids] @ q), 0.0)

    def _greedy_step(self, q: np.ndarray, ep: int, level: int
                     ) -> List[int]:
        """ef=1 greedy descent within one level: walk to the closest
        neighbor until no improvement."""
        qn = float(q @ q)
        adj = self._adj[level] if level < len(self._adj) else None
        if adj is None:
            return [ep]
        cur = ep
        cur_d = float(self._dists(q, qn, np.asarray([cur]))[0])
        while True:
            nb = adj[cur]
            nb = nb[nb >= 0]
            if not len(nb):
                return [cur]
            d = self._dists(q, qn, nb.astype(np.int64))
            j = int(np.argmin(d))
            if d[j] >= cur_d:
                return [cur]
            cur, cur_d = int(nb[j]), float(d[j])

    def _search_layer(self, q: np.ndarray, eps: List[int], ef: int,
                      level: int) -> List[Tuple[float, int]]:
        """Best-first beam bounded by ef; returns [(dist, id)] sorted
        ascending.  Distance evaluations batch per expansion (one
        gather + GEMV over the node's whole neighbor row)."""
        qn = float(q @ q)
        adj = self._adj[level] if level < len(self._adj) else None
        visited = np.zeros(self._n, bool)
        eps = [e for e in eps if 0 <= e < self._n]
        visited[eps] = True
        d0 = self._dists(q, qn, np.asarray(eps, np.int64))
        cand = [(float(d), e) for d, e in zip(d0, eps)]   # min-heap
        heapq.heapify(cand)
        best = [(-float(d), e) for d, e in zip(d0, eps)]  # max-heap
        heapq.heapify(best)
        while len(best) > ef:
            heapq.heappop(best)
        while cand:
            d, c = heapq.heappop(cand)
            if best and d > -best[0][0] and len(best) >= ef:
                break
            if adj is None:
                break
            nb = adj[c]
            nb = nb[(nb >= 0)]
            nb = nb[~visited[nb]]
            if not len(nb):
                continue
            visited[nb] = True
            dn = self._dists(q, qn, nb.astype(np.int64))
            worst = -best[0][0] if best else np.inf
            for dd, ii in zip(dn, nb):
                dd = float(dd)
                if len(best) < ef or dd < worst:
                    heapq.heappush(cand, (dd, int(ii)))
                    heapq.heappush(best, (-dd, int(ii)))
                    if len(best) > ef:
                        heapq.heappop(best)
                    worst = -best[0][0]
        return sorted((-nd, i) for nd, i in best)

    def search(self, queries: np.ndarray, k: int = 10,
               ef_search: Optional[int] = None, **_ignored
               ) -> Tuple[np.ndarray, np.ndarray]:
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        nq = len(q)
        D = np.full((nq, k), np.inf, np.float32)
        I = np.full((nq, k), -1, np.int64)
        if self._n == 0:
            return D, I
        ef = max(k, ef_search or self.ef_search)
        for qi in range(nq):
            ep = [self._ep]
            for l in range(self._max_level, 0, -1):
                ep = self._greedy_step(q[qi], ep[0], l)
            out = self._search_layer(q[qi], ep, ef, 0)[:k]
            for j, (d, i) in enumerate(out):
                D[qi, j] = d
                I[qi, j] = i
        return D, I

    # ---- size ------------------------------------------------------------
    @property
    def size(self) -> int:
        return self._n

    @property
    def dim(self) -> int:
        return self._dim

    def vectors_in_id_order(self) -> np.ndarray:
        return self.vecs[:self._n]

    def vector_of(self, id_: int) -> np.ndarray:
        return self.vecs[id_]

    # ---- persistence -----------------------------------------------------
    def _state_arrays(self) -> Dict[str, np.ndarray]:
        n = self._n
        out = {"vecs": self.vecs[:n], "levels": self.levels[:n]}
        for l, adj in enumerate(self._adj):
            out[f"adj{l}"] = adj[:n]
        return out

    def _state_meta(self) -> dict:
        return {"options": {k: v for k, v in self.options.items()},
                "m": self.m, "ef_construction": self.ef_construction,
                "ef_search": self.ef_search, "ep": self._ep,
                "max_level": self._max_level, "n": self._n,
                "dim": self._dim}

    @classmethod
    def _from_state(cls, arrays: Dict[str, np.ndarray], meta: dict,
                    device: DeviceLike = "cuda") -> "HnswIndex":
        """The graph lives on the host: `device` is not read."""
        idx = cls(meta["dim"], m=meta["m"],
                  ef_construction=meta["ef_construction"],
                  ef_search=meta["ef_search"],
                  options=meta.get("options"))
        n = int(meta["n"])
        idx._grow(max(n, 1))
        idx.vecs[:n] = arrays["vecs"]
        idx.norms[:n] = np.einsum("nd,nd->n", arrays["vecs"],
                                  arrays["vecs"])
        idx.levels[:n] = arrays["levels"]
        nlevels = 1 + max((int(k[3:]) for k in arrays
                           if k.startswith("adj")), default=0)
        idx._adj = []
        for l in range(nlevels):
            width = idx.m0 if l == 0 else idx.m
            adj = np.full((len(idx.vecs), width), -1, np.int32)
            a = arrays.get(f"adj{l}")
            if a is not None and len(a):
                adj[:len(a), :a.shape[1]] = a
            idx._adj.append(adj)
        idx._n = n
        idx._ep = int(meta["ep"])
        idx._max_level = int(meta["max_level"])
        return idx
