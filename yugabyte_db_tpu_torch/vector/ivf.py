"""Two-stage IVF: multi-probe candidate generation + exact GEMM re-rank.

Counterpart of ``yugabyte_db_tpu/vector/ivf.py``.  Search is two
GEMM-shaped stages:

  stage 1, candidate generation: one [Q, D] x [D, K] centroid-distance
  product, per-query top-``nprobe`` lists, and the probed lists' rows
  scored in the matmul dtype (bf16 on the card) into a top-C pool;

  stage 2, re-rank: the pool's rows scored again in f32 and a top-k.

The reference gathers every probed list's rows as one [Q, nprobe * M,
D] tensor, which XLA fuses into its product.  Eager torch would
materialize it (25.8 GB in bf16 at 1,000,000 x 768 with 1024 lists,
nprobe 256 and 64 queries), so the device search here never builds it:
the base is list-major already, so stage 1 is ONE [Q, D] x [D, N]
product over the sorted base, with the rows of every list a query did
not probe masked to +inf before the top-C.  Its products are the
reference's products, so the pool is the reference's up to the
accumulation order; the bound is the bf16 base read once per batch.
``_cpu_search`` is the reference's numpy twin (blocked shared GEMMs
over the batch's probed-list union), run on the host with
``backend="cpu"``."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.vector import (BLOCK_ELEMS, _ieee_f32, _mm_dtype,
                          assign_nearest, kmeans, l2_distance2, mm_f32)
from .registry import AnnIndex, merge_topk, register_index

#: device searches per signature (queries, lists, list width, k,
#: nprobe, pool): torch compiles nothing, so this is call accounting
_KERNEL_CALLS: Dict[tuple, int] = {}


def kernel_cache_stats() -> dict:
    """Device searches so far: the total and the count per signature."""
    return {"calls": sum(_KERNEL_CALLS.values()),
            "signatures": len(_KERNEL_CALLS),
            "by_signature": dict(_KERNEL_CALLS)}


def reset_kernel_stats() -> None:
    _KERNEL_CALLS.clear()


def _pow2(n: int, floor: int = 1) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def two_stage_search(queries: torch.Tensor, cent: torch.Tensor,
                     row_list: torch.Tensor, vecs: torch.Tensor,
                     norms: torch.Tensor, k: int, nprobe: int,
                     pool: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-stage search on the inputs' device: (distances [Q, k],
    sorted-row positions [Q, k], -1 where no candidate).  ``row_list``
    is each sorted row's list id, ``vecs`` the list-major base in the
    matmul dtype, ``pool`` the top-C width (at most N).  Queries go in
    blocks so that no [block, N] intermediate passes BLOCK_ELEMS."""
    n_q = queries.shape[0]
    n = vecs.shape[0]
    mm = vecs.dtype
    probe = torch.topk(-l2_distance2(queries, cent), nprobe, dim=1).indices
    qn = (queries * queries).sum(1)
    step = max(1, BLOCK_ELEMS // max(n, 1))
    out_d, out_i = [], []
    for q0 in range(0, n_q, step):
        q = queries[q0:q0 + step]
        qn_b = qn[q0:q0 + step, None]
        # ---- stage 1: the probed lists' rows, scored in the mm dtype ----
        probed = torch.zeros(q.shape[0], cent.shape[0], dtype=torch.bool,
                             device=q.device)
        probed.scatter_(1, probe[q0:q0 + step], True)
        valid = probed.index_select(1, row_list)           # [b, N]
        d1 = torch.sub(qn_b + norms[None, :], mm_f32(q.to(mm), vecs),
                       alpha=2.0)
        d1.masked_fill_(~valid, float("inf"))
        _, sel = torch.topk(-d1, pool, dim=1)               # [b, C]
        del d1
        pool_valid = torch.gather(valid, 1, sel)
        # ---- stage 2: the pool re-ranked in f32 ----
        pv = vecs[sel].float()                              # [b, C, D]
        with _ieee_f32():
            dots2 = torch.bmm(pv, q[:, :, None])[..., 0]
        d2 = torch.sub(qn_b + norms[sel], dots2, alpha=2.0)
        d2 = torch.where(pool_valid, torch.clamp(d2, min=0.0),
                         float("inf"))
        neg, pos = torch.topk(-d2, k, dim=1)
        ids = torch.gather(sel, 1, pos)
        out_d.append(-neg)
        out_i.append(torch.where(torch.isfinite(neg), ids, -1))
    return torch.cat(out_d), torch.cat(out_i)


@register_index("ivfflat", "ivf")
class TwoStageIvfIndex(AnnIndex):
    """IVF with two-stage search behind the AnnIndex contract, on one
    device (CUDA unless the caller passes "cpu").

    Layout is list-major: vectors sorted by IVF list so each list is a
    contiguous slice (``starts``/``counts``), with the positional id of
    every sorted row in ``ids``.  The host keeps the f32 layout (the
    numpy twin and persistence read it); the device search reads a
    lazily made device twin.

    ``add`` appends to an exact-searched tail (the index's own delta);
    folding the tail back into the lists is a rebuild."""

    #: rows per CPU re-rank block (the reference's measured choice)
    CPU_BLOCK = 1 << 14

    def __init__(self, centroids: np.ndarray, sorted_vecs: np.ndarray,
                 ids: np.ndarray, starts: np.ndarray, counts: np.ndarray,
                 options: Optional[dict] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.cent = np.ascontiguousarray(centroids, dtype=np.float32)
        self.cent_norms = np.einsum("kd,kd->k", self.cent, self.cent)
        self.sorted = np.ascontiguousarray(sorted_vecs, dtype=np.float32)
        self.sorted_norms = np.einsum("nd,nd->n", self.sorted,
                                      self.sorted)
        self.ids = np.asarray(ids, np.int64)
        self.starts = np.asarray(starts, np.int64)
        self.counts = np.asarray(counts, np.int64)
        self.options = dict(options or {})
        self._tail_vecs: list = []        # added after build (add())
        self._tail_ids: list = []
        self._next_id = (int(self.ids.max()) + 1) if len(self.ids) else 0
        self._device = None               # lazy device twin
        #: candidate-pool rows of the LAST search (CPU: probed-union
        #: rows scanned; device: the pool width C)
        self.last_pool_rows = 0

    # ---- construction ----------------------------------------------------
    @classmethod
    def build(cls, data: np.ndarray, nlists: int = 100, iters: int = 10,
              sample: int = 100_000, seed: int = 0,
              device: DeviceLike = "cuda", **extra) -> "TwoStageIvfIndex":
        """k-means and the assignment on `device`; the list-major sort on
        the host."""
        data = np.asarray(data, np.float32)
        n = len(data)
        nlists = max(1, min(nlists, max(1, n // 2 or 1)))
        if n == 0:
            d = data.shape[1] if data.ndim == 2 else 1
            z = np.zeros((0,), np.int64)
            return cls(np.zeros((1, d), np.float32),
                       np.zeros((0, d), np.float32), z,
                       np.zeros(1, np.int64), np.zeros(1, np.int64),
                       {"nlists": 1, "iters": iters, "seed": seed},
                       device=device)
        rng = np.random.default_rng(seed)
        samp = (data if n <= sample
                else data[rng.choice(n, sample, replace=False)])
        cent = kmeans(samp, nlists, iters, seed, device=device)
        assign = assign_nearest(data, cent, device=device)
        order = np.argsort(assign, kind="stable")
        counts = np.bincount(assign, minlength=nlists).astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        return cls(cent, data[order], order.astype(np.int64), starts,
                   counts, {"nlists": nlists, "iters": iters,
                            "seed": seed, **extra}, device=device)

    def add(self, vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        for v in vectors:
            self._tail_vecs.append(v)
            self._tail_ids.append(self._next_id)
            self._next_id += 1

    # ---- size ------------------------------------------------------------
    @property
    def size(self) -> int:
        return len(self.ids) + len(self._tail_ids)

    @property
    def dim(self) -> int:
        return self.sorted.shape[1] if self.sorted.ndim == 2 else 1

    @property
    def nlists(self) -> int:
        return len(self.counts)

    # ---- search ----------------------------------------------------------
    def default_nprobe(self) -> int:
        """Recall-biased default: a quarter of the lists."""
        return max(1, self.nlists // 4)

    def search(self, queries: np.ndarray, k: int = 10,
               nprobe: Optional[int] = None,
               rerank_c: Optional[int] = None,
               backend: Optional[str] = None, **_ignored
               ) -> Tuple[np.ndarray, np.ndarray]:
        """``backend``: "device" (the default: the index's device) or
        "cpu" (the numpy twin on the host)."""
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        nprobe = min(nprobe or self.default_nprobe(), self.nlists)
        nprobe = max(1, nprobe)
        backend = backend or "device"
        if len(self.ids) == 0:
            D = np.full((len(q), k), np.inf, np.float32)
            I = np.full((len(q), k), -1, np.int64)
        elif backend == "device":
            D, I = self._device_search(q, k, nprobe, rerank_c)
        elif backend == "cpu":
            D, I = self._cpu_search(q, k, nprobe)
        else:
            raise ValueError(f"backend {backend!r} (device or cpu)")
        if self._tail_ids:
            D, I = self._merge_tail(q, k, D, I)
        return D, I

    # ---- the numpy twin: blocked shared GEMM over the probed union -------
    def _cpu_search(self, q: np.ndarray, k: int, nprobe: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Stage 1 picks per-query probe lists; stage 2 re-ranks the
        batch's probed-list UNION with blocked [Q, D] x [D, block] GEMMs
        and a per-block partial top-k (each query's candidates are a
        superset of its own probed lists).  Probed runs separated by
        fewer than CPU_BLOCK // 4 unprobed rows merge into one segment;
        last_pool_rows counts the rows scanned, gaps included."""
        nq = len(q)
        cd = (np.einsum("qd,qd->q", q, q)[:, None] + self.cent_norms[None]
              - 2.0 * q @ self.cent.T)                     # [Q, K]
        if nprobe < self.nlists:
            probe = np.argpartition(cd, nprobe - 1, axis=1)[:, :nprobe]
            union = np.unique(probe)
        else:
            union = np.arange(self.nlists)
        union = union[self.counts[union] > 0]
        if len(union) == 0:
            self.last_pool_rows = 0
            return (np.full((nq, k), np.inf, np.float32),
                    np.full((nq, k), -1, np.int64))
        seg_start = self.starts[union]
        seg_end = seg_start + self.counts[union]
        gap = self.CPU_BLOCK // 4
        keep = np.ones(len(union), bool)
        keep[1:] = seg_start[1:] > seg_end[:-1] + gap
        heads = np.nonzero(keep)[0]
        seg_lo = seg_start[heads]
        seg_hi = np.concatenate([seg_end[heads[1:] - 1], seg_end[-1:]])
        self.last_pool_rows = int((seg_hi - seg_lo).sum())
        qn = np.einsum("qd,qd->q", q, q)
        win_d: list = []
        win_i: list = []
        for lo, hi in zip(seg_lo, seg_hi):
            lo, hi = int(lo), int(hi)
            for b0 in range(lo, hi, self.CPU_BLOCK):
                b1 = min(b0 + self.CPU_BLOCK, hi)
                dots = q @ self.sorted[b0:b1].T             # [Q, b]
                dist = (qn[:, None] - 2.0 * dots
                        + self.sorted_norms[None, b0:b1])
                kk = min(k, b1 - b0)
                sel = np.argpartition(dist, kk - 1, axis=1)[:, :kk]
                win_d.append(np.take_along_axis(dist, sel, axis=1))
                win_i.append(self.ids[b0 + sel])
        D, I = merge_topk(np.concatenate(win_d, axis=1),
                          np.concatenate(win_i, axis=1), k)
        return np.maximum(D, 0.0), I

    # ---- the device path ------------------------------------------------
    def _device_arrays(self) -> dict:
        """Lazy device twin: centroids, the list-major base in the matmul
        dtype, its f32 norms (the host's), each sorted row's list id, and
        the reference's pow2 list width (it caps the pool and k)."""
        if self._device is None:
            dev = self.device
            m = _pow2(max(1, int(self.counts.max()) if len(self.counts)
                          else 1), floor=8)
            row_list = np.repeat(np.arange(self.nlists, dtype=np.int32),
                                 self.counts)
            self._device = {
                "cent": torch.as_tensor(self.cent, device=dev),
                "vecs": torch.as_tensor(self.sorted, device=dev).to(
                    _mm_dtype(dev)),
                "norms": torch.as_tensor(
                    self.sorted_norms.astype(np.float32), device=dev),
                "row_list": torch.as_tensor(row_list, device=dev),
                "list_width": m,
            }
        return self._device

    def device_plan(self, k: int, nprobe: int,
                    rerank_c: Optional[int] = None) -> Tuple[int, int]:
        """(k_eff, pool) of a device search, as the reference sizes
        them: its pool is at most nprobe * the pow2 list width wide
        (and here at most N), and k is clamped to what it can fill."""
        n = len(self.ids)
        m_pad = self._device_arrays()["list_width"]
        k_eff = min(k, n, nprobe * m_pad)
        c = rerank_c or self.options.get("rerank_c") or 4 * k
        c = _pow2(max(min(c, n), k_eff))
        self.last_pool_rows = c
        return k_eff, min(c, nprobe * m_pad, n)

    def _device_search(self, q: np.ndarray, k: int, nprobe: int,
                       rerank_c: Optional[int]
                       ) -> Tuple[np.ndarray, np.ndarray]:
        dv = self._device_arrays()
        n = len(self.ids)
        # missing slots pad with inf/-1 like every other search path
        k_eff, pool = self.device_plan(k, nprobe, rerank_c)
        sig = (len(q), self.nlists, dv["list_width"], k_eff, nprobe, pool)
        _KERNEL_CALLS[sig] = _KERNEL_CALLS.get(sig, 0) + 1
        d, i = two_stage_search(
            torch.as_tensor(q, device=self.device), dv["cent"],
            dv["row_list"], dv["vecs"], dv["norms"], k_eff, nprobe, pool)
        d = d.cpu().numpy()
        i = i.cpu().numpy().astype(np.int64)
        # sorted-row positions -> positional ids; -1 stays -1
        i = np.where(i >= 0, self.ids[np.clip(i, 0, max(n - 1, 0))], -1)
        if k_eff < k:
            d = np.pad(d, ((0, 0), (0, k - k_eff)),
                       constant_values=np.inf)
            i = np.pad(i, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return d, i

    # ---- tail (add()-ed vectors): exact merge ---------------------------
    def _merge_tail(self, q: np.ndarray, k: int, D: np.ndarray,
                    I: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        tv = np.stack(self._tail_vecs)
        ti = np.asarray(self._tail_ids, np.int64)
        dist = (np.einsum("qd,qd->q", q, q)[:, None]
                + np.einsum("td,td->t", tv, tv)[None, :]
                - 2.0 * q @ tv.T)
        dist = np.maximum(dist, 0.0)
        return merge_topk(
            np.concatenate([D, dist], axis=1),
            np.concatenate(
                [I, np.broadcast_to(ti, (len(q), len(ti)))], axis=1),
            k)

    def _inv_ids(self) -> np.ndarray:
        """positional id -> sorted-row position (built once)."""
        if getattr(self, "_inv", None) is None:
            n = len(self.ids)
            self._inv = np.empty(n, np.int64)
            self._inv[self.ids] = np.arange(n)
        return self._inv

    def vectors_in_id_order(self) -> np.ndarray:
        out = self.sorted[self._inv_ids()]
        if self._tail_vecs:
            out = np.concatenate([out, np.stack(self._tail_vecs)])
        return out

    def vector_of(self, id_: int) -> np.ndarray:
        n = len(self.ids)
        if id_ >= n:
            return self._tail_vecs[id_ - n]
        return self.sorted[self._inv_ids()[id_]]

    # ---- persistence (the reference's arrays and meta) ------------------
    def _state_arrays(self) -> Dict[str, np.ndarray]:
        tail_v = (np.stack(self._tail_vecs) if self._tail_vecs
                  else np.zeros((0, self.dim), np.float32))
        return {"cent": self.cent, "sorted": self.sorted,
                "ids": self.ids, "starts": self.starts,
                "counts": self.counts, "tail_vecs": tail_v,
                "tail_ids": np.asarray(self._tail_ids, np.int64)}

    def _state_meta(self) -> dict:
        return {"options": self.options}

    @classmethod
    def _from_state(cls, arrays: Dict[str, np.ndarray], meta: dict,
                    device: DeviceLike = "cuda") -> "TwoStageIvfIndex":
        idx = cls(arrays["cent"], arrays["sorted"], arrays["ids"],
                  arrays["starts"], arrays["counts"],
                  meta.get("options"), device=device)
        if len(arrays.get("tail_ids", ())):
            idx._tail_vecs = list(arrays["tail_vecs"])
            idx._tail_ids = [int(x) for x in arrays["tail_ids"]]
            idx._next_id = max(idx._next_id,
                               max(idx._tail_ids) + 1)
        return idx
