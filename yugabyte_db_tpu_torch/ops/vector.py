"""Vector index kernels: distance products, top-k, k-means, IVF-flat.

Counterpart of ``yugabyte_db_tpu/ops/vector.py``, the KERNEL layer of
vector search: the distance products, exact search, Lloyd's k-means,
the IVF probe and full-scan searches, and the flat ``IvfFlatIndex``.
The index subsystem (the ANN registry, the two-stage IVF, HNSW) lives
in ``yugabyte_db_tpu_torch/vector/``.

The reference jits each of these into one XLA program; here they are
plain torch on the inputs' device.  Distance products take their
operands in ``_mm_dtype(device)`` (bf16 on the card, the reference's
accelerator choice, with f32 accumulation and an f32 result; f32 on the
CPU) and every f32 product runs with TF32 off, so the f32 paths stay
f32 as the reference's are.  Large products are ``torch.mm``; no step
materializes a [Q, candidates, D] gather of the whole candidate set."""
from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

#: elements of the largest [queries, candidates] (or [queries,
#: candidates, D]) intermediate a search forms at once; longer inputs
#: go in blocks
BLOCK_ELEMS = 1 << 26


def _mm_dtype(device: torch.device) -> torch.dtype:
    """Distance-product operand dtype: bf16 on the card (halves the
    bytes read; f32 accumulation), f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


@contextlib.contextmanager
def _ieee_f32():
    """f32 products in full f32 for the duration (TF32 off)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T as f32: bf16 operands accumulate and come out in f32
    (the reference's preferred_element_type), f32 operands multiply in
    full f32."""
    if a.dtype == torch.bfloat16:
        return torch.mm(a, b.t(), out_dtype=torch.float32)
    with _ieee_f32():
        return a @ b.t()


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row squared norms in f32."""
    x = x.float()
    return (x * x).sum(1)


def _as_f32(x, device: DeviceLike) -> torch.Tensor:
    """A tensor stays where it is (as f32); numpy goes to `device`."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=resolve_device(device))


def l2_distance2(queries: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [Q, N] = |q|^2 + |b|^2 - 2 q.b, clamped at
    0 (bf16 rounding can push tiny distances below zero)."""
    mm = _mm_dtype(queries.device)
    dots = mm_f32(queries.to(mm), base.to(mm))
    qn = sq_norms(queries)[:, None]
    bn = sq_norms(base)
    return torch.clamp(qn + bn[None, :] - 2.0 * dots, min=0.0)


def inner_product(queries: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    mm = _mm_dtype(queries.device)
    return mm_f32(queries.to(mm), base.to(mm))


def cosine_distance(queries: torch.Tensor, base: torch.Tensor
                    ) -> torch.Tensor:
    qn = queries / (torch.linalg.vector_norm(queries, dim=1, keepdim=True)
                    + 1e-12)
    bn = base / (torch.linalg.vector_norm(base, dim=1, keepdim=True)
                 + 1e-12)
    return 1.0 - inner_product(qn, bn)


def exact_search(queries, base, k: int, device: DeviceLike = "cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force k-NN: (distances [Q,k], indices [Q,k]) on the inputs'
    device (numpy inputs go to `device`)."""
    q = _as_f32(queries, device)
    b = _as_f32(base, q.device)
    neg, idx = torch.topk(-l2_distance2(q, b), k, dim=1)
    return -neg, idx


def _kmeans_iters(data: torch.Tensor, centroids: torch.Tensor,
                  iters: int) -> torch.Tensor:
    """Lloyd iterations: assignment by the distance product, sums by a
    one-hot product (deterministic, unlike float atomics; built by a
    compare, so nothing waits on the device)."""
    cent = centroids
    ids = torch.arange(cent.shape[0], device=cent.device)
    for _ in range(iters):
        assign = torch.argmin(l2_distance2(data, cent), dim=1)
        onehot = (assign[:, None] == ids[None, :]).float()
        with _ieee_f32():
            sums = onehot.t() @ data                 # [K, D]
        counts = onehot.sum(0)[:, None]
        cent = torch.where(counts > 0, sums / torch.clamp(counts, min=1),
                           cent)
    return cent


def kmeans(data: np.ndarray, k: int, iters: int = 10, seed: int = 0,
           device: DeviceLike = "cuda") -> np.ndarray:
    """Lloyd's k-means on `device`; returns [k, D] centroids."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    init = data[rng.choice(len(data), size=k, replace=False)]
    out = _kmeans_iters(
        torch.as_tensor(np.asarray(data, np.float32), device=dev),
        torch.as_tensor(np.asarray(init, np.float32), device=dev), iters)
    return out.cpu().numpy()


def assign_nearest(data: np.ndarray, cent: np.ndarray,
                   device: DeviceLike = "cuda") -> np.ndarray:
    """Nearest-centroid id per row (the first minimum, as jnp.argmin
    takes), in 2^18-row chunks so peak memory stays bounded."""
    dev = resolve_device(device)
    n = len(data)
    assign = np.empty(n, np.int32)
    step = 1 << 18
    centd = torch.as_tensor(np.asarray(cent, np.float32), device=dev)
    for i in range(0, n, step):
        d = l2_distance2(torch.as_tensor(
            np.asarray(data[i:i + step], np.float32), device=dev), centd)
        assign[i:i + step] = torch.argmin(d, dim=1).cpu().numpy()
    return assign


def _ivf_probe_search(queries, centroids, lists, list_lens, vec_flat,
                      norms_flat, k: int, nprobe: int):
    """Per-query IVF gather search: each query's probed lists scored in
    the matmul dtype, in candidate blocks (a [Q, block, D] gather at a
    time, never the whole [Q, nprobe * M, D])."""
    dc = l2_distance2(queries, centroids)                 # [Q, K]
    probe = torch.topk(-dc, nprobe, dim=1).indices        # [Q, nprobe]
    cand = lists[probe].long()                            # [Q, np, M]
    q_, p_, m_ = cand.shape
    cand = cand.reshape(q_, p_ * m_)
    arange = torch.arange(m_, device=cand.device)
    cand_valid = (arange[None, None, :]
                  < list_lens[probe][:, :, None]).reshape(q_, p_ * m_)
    qf = queries.to(vec_flat.dtype).float()
    dots = torch.empty(q_, p_ * m_, dtype=torch.float32,
                       device=cand.device)
    step = max(1, BLOCK_ELEMS // max(1, q_ * vec_flat.shape[1]))
    with _ieee_f32():
        for c0 in range(0, p_ * m_, step):
            vecs = vec_flat[cand[:, c0:c0 + step]].float()   # [Q, b, D]
            dots[:, c0:c0 + step] = torch.bmm(vecs, qf[:, :, None])[..., 0]
    d = (sq_norms(queries)[:, None] + norms_flat[cand] - 2.0 * dots)
    d = torch.where(cand_valid, torch.clamp(d, min=0.0), float("inf"))
    neg, pos = torch.topk(-d, k, dim=1)
    return -neg, torch.gather(cand, 1, pos)


def _full_scan_search(queries, vec_chunks, nrm_chunks, k: int):
    """Batched full-scan k-NN over a pre-chunked [C, chunk, D] matrix:
    per chunk a distance product and a top-k, then a top-k over the
    chunks' winners.  Exact; one read of the matrix for the whole batch.
    Padded rows carry inf norms, so they never win a slot."""
    nchunks, chunk, _ = vec_chunks.shape
    qn = sq_norms(queries)[:, None]
    qmm = queries.to(vec_chunks.dtype)
    negs, poss = [], []
    for c in range(nchunks):
        dist = qn + nrm_chunks[c][None, :] - 2.0 * mm_f32(qmm,
                                                           vec_chunks[c])
        neg, pos = torch.topk(-dist, k, dim=1)
        negs.append(neg)
        poss.append(pos + c * chunk)
    neg, sel = torch.topk(torch.cat(negs, 1), k, dim=1)
    return (torch.clamp(-neg, min=0.0),
            torch.gather(torch.cat(poss, 1), 1, sel))


class IvfFlatIndex:
    """IVF-flat ANN index (pgvector `ivfflat` analog) on one device.

    Build: k-means over a sample -> assign every vector to its nearest
    centroid -> per-list row-id buckets padded to a rectangle.  Search:
    the `nprobe` nearest centroids per query, those lists scored, top-k;
    a batch whose probed lists would cover the index takes the shared
    full scan instead.  The vector matrix is stored once, in the chunked
    [C, chunk, D] layout the full scan streams (padded tail rows have
    inf norms); the probe path reads it through a flat reshape.
    ``_cpu_list_search`` is the reference's host twin."""

    #: rows per full-scan chunk
    CHUNK = 1 << 17

    def __init__(self, centroids: np.ndarray, lists: np.ndarray,
                 list_lens: np.ndarray, vectors: np.ndarray,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        dev = self.device
        self.centroids = torch.tensor(
            np.asarray(centroids, np.float32), device=dev)      # [K, D]
        self.lists = torch.tensor(np.asarray(lists), device=dev)
        self.list_lens = torch.tensor(np.asarray(list_lens), device=dev)
        self._src = np.ascontiguousarray(np.asarray(vectors, np.float32))
        self.n = int(self._src.shape[0])
        self.dim = int(self._src.shape[1])
        self._np = None               # the host twin's list-major layout
        v32 = torch.as_tensor(self._src, device=dev)
        norms = sq_norms(v32)
        chunk = max(1, min(self.CHUNK, self.n))
        pad = (-self.n) % chunk
        vec = torch.nn.functional.pad(v32.to(_mm_dtype(dev)),
                                      (0, 0, 0, pad))
        nrm = torch.nn.functional.pad(norms, (0, pad), value=float("inf"))
        self._vec = vec.reshape(-1, chunk, self.dim)
        self._nrm = nrm.reshape(-1, chunk)

    @property
    def vectors(self) -> torch.Tensor:
        """[N, D] flat view (a reshape over contiguous dims is free)."""
        return self._vec.reshape(-1, self.dim)[: self.n]

    @property
    def norms(self) -> torch.Tensor:
        return self._nrm.reshape(-1)[: self.n]

    @classmethod
    def build(cls, data: np.ndarray, nlists: int = 100,
              sample: int = 100_000, iters: int = 10, seed: int = 0,
              device: DeviceLike = "cuda") -> "IvfFlatIndex":
        n = len(data)
        rng = np.random.default_rng(seed)
        samp = data if n <= sample else data[rng.choice(n, sample, False)]
        cent = kmeans(samp, nlists, iters, seed, device=device)
        assign = assign_nearest(data, cent, device=device)
        order = np.argsort(assign, kind="stable")
        counts = np.bincount(assign[order], minlength=nlists)
        maxlen = int(counts.max()) if n else 1
        lists = np.zeros((nlists, maxlen), np.int32)
        lens = counts.astype(np.int32)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        for li in range(nlists):
            seg = order[starts[li]:starts[li] + counts[li]]
            lists[li, :len(seg)] = seg
        return cls(cent, lists, lens, data, device=device)

    def _host_layout(self) -> dict:
        """The host twin's list-major layout (vectors sorted by list,
        each list a contiguous slice), built at first use."""
        if self._np is None:
            v_np = self._src
            norms_np = np.einsum("nd,nd->n", v_np, v_np)
            lists_np = self.lists.cpu().numpy()
            lens_np = self.list_lens.cpu().numpy().astype(np.int64)
            mask = np.arange(lists_np.shape[1])[None, :] < lens_np[:, None]
            ids = lists_np[mask].astype(np.int64)
            starts = np.concatenate(
                [[0], np.cumsum(lens_np)[:-1]]).astype(np.int64)
            cent = self.centroids.cpu().numpy()
            self._np = {
                "ids": ids, "starts": starts, "counts": lens_np,
                "sorted": np.ascontiguousarray(v_np[ids]),
                "sorted_norms": norms_np[ids],
                "cent": cent,
                "cent_norms": (cent ** 2).sum(1),
            }
        return self._np

    def _cpu_list_search(self, q: np.ndarray, k: int, nprobe: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """List-major IVF search on the host (the reference's twin of
        the device search): per probed list one contiguous GEMM, then
        one partial sort per query."""
        s = self._host_layout()
        nq = len(q)
        cd = ((q ** 2).sum(1)[:, None] + s["cent_norms"][None, :]
              - 2.0 * q @ s["cent"].T)                     # [Q, K]
        npb = min(nprobe, cd.shape[1])
        probe = np.argpartition(cd, npb - 1, axis=1)[:, :npb]
        qn = (q ** 2).sum(1)
        cand_d = [[] for _ in range(nq)]
        cand_i = [[] for _ in range(nq)]
        for li in np.unique(probe):
            qs = np.nonzero((probe == li).any(axis=1))[0]
            st, c = s["starts"][li], s["counts"][li]
            if c == 0:
                continue
            seg = s["sorted"][st:st + c]                   # [c, D]
            dots = seg @ q[qs].T                           # [c, q_l]
            dist = (qn[qs][None, :]
                    + s["sorted_norms"][st:st + c, None] - 2.0 * dots)
            ids = s["ids"][st:st + c]
            for j, qi in enumerate(qs):
                cand_d[qi].append(dist[:, j])
                cand_i[qi].append(ids)
        D = np.full((nq, k), np.inf, np.float32)
        I = np.zeros((nq, k), np.int64)
        for qi in range(nq):
            if not cand_d[qi]:
                continue
            dd = np.concatenate(cand_d[qi])
            ii = np.concatenate(cand_i[qi])
            kk = min(k, len(dd))
            sel = np.argpartition(dd, kk - 1)[:kk]
            o = np.argsort(dd[sel])
            D[qi, :kk] = dd[sel][o]
            I[qi, :kk] = ii[sel][o]
        return np.maximum(D, 0.0), I

    def search(self, queries: np.ndarray, k: int = 10, nprobe: int = 8
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Routes by batch size as the reference does on an accelerator:
        when the batch's probed lists would cover the index, one shared
        full scan (exact, one read of the matrix); small batches take
        the per-query probe search."""
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        nlists = int(self.centroids.shape[0])
        if len(queries) * nprobe >= nlists:
            d, i = _full_scan_search(q, self._vec, self._nrm, k)
        else:
            d, i = _ivf_probe_search(
                q, self.centroids, self.lists, self.list_lens,
                self._vec.reshape(-1, self.dim), self._nrm.reshape(-1),
                k, nprobe)
        return d.cpu().numpy(), i.cpu().numpy()
