"""Sharded vector search: the base split across the mesh's slots, a
top-k per slot, then one gather and re-rank on the lead device.

Counterpart of ``yugabyte_db_tpu/parallel/vector.py`` (model-parallel
ANN over ICI there: a ``shard_map`` with an ``all_gather`` of every
shard's candidates).  Here each slot's program is enqueued on its
device and the candidates move to the lead device with asynchronous
device-to-device copies."""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.vector import _ieee_f32, mm_f32, sq_norms
from .mesh import TabletMesh, place

#: slot programs run by sharded_exact_search (one per slot and search)
LAUNCHES = {"sharded_exact_search": 0}


def _shard_distances(q: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 [Q, N] as the reference's shard step computes it: f32
    norms, the product of bf16 operands accumulated in f32 (on every
    backend: on the CPU the operands are rounded to bf16 and multiplied
    in IEEE f32, where each product is exact), clamped at 0."""
    if q.device.type == "cuda":
        dots = mm_f32(q.to(torch.bfloat16), b.to(torch.bfloat16))
    else:
        with _ieee_f32():
            dots = (q.to(torch.bfloat16).float()
                    @ b.to(torch.bfloat16).float().t())
    d = (q * q).sum(1, keepdim=True) + sq_norms(b)[None, :] - 2.0 * dots
    return torch.clamp(d, min=0.0)   # bf16 rounding can go below 0


def sharded_exact_search(tm: TabletMesh, queries: np.ndarray,
                         base_sharded: Union[np.ndarray,
                                             Sequence[torch.Tensor]],
                         k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN over a base split in S = T x B equal slots.

    ``base_sharded``: a numpy [S, N_shard, D] (each slot's rows go to
    its device), or S tensors [N_shard, D] already on their slots'
    devices.  Returns (distances [Q, k] f32, global row ids [Q, k]
    int64, id = slot * N_shard + local row) as numpy.  Ties go as in
    the reference: its gathered candidates lie block shard major, then
    tablet shard (slot order when B = 1), each slot's own top-k in
    order, and the first of equal distances wins."""
    S, T, B = tm.num_shards, tm.num_tablet_shards, tm.num_block_shards
    if isinstance(base_sharded, np.ndarray):
        if base_sharded.shape[0] != S:
            raise ValueError(f"need {S} base slots, got "
                             f"{base_sharded.shape[0]}")
        slots = place(tm, np.asarray(base_sharded, np.float32))
    else:
        slots = list(base_sharded)
        if len(slots) != S:
            raise ValueError(f"need {S} base slots, got {len(slots)}")
        for s, t in enumerate(slots):
            if t.device != tm.devices[s]:
                raise ValueError(f"base slot {s} is on {t.device}, its "
                                 f"mesh device is {tm.devices[s]}")
    n_shard = int(slots[0].shape[0])
    q_host = np.asarray(queries, np.float32)
    qs = {dev: torch.from_numpy(q_host).to(dev)
          for dev in dict.fromkeys(tm.devices)}
    dists, ids = [], []
    for s in range(S):
        d = _shard_distances(qs[tm.devices[s]], slots[s].float())
        neg, idx = torch.topk(-d, k, dim=1)
        LAUNCHES["sharded_exact_search"] += 1
        dists.append((-neg).to(tm.lead, non_blocking=True))
        ids.append((idx + s * n_shard).to(tm.lead, non_blocking=True))
    order = [t * B + b for b in range(B) for t in range(T)]
    alld = torch.cat([dists[s] for s in order], dim=1)
    alli = torch.cat([ids[s] for s in order], dim=1)
    d_top, pos = torch.sort(alld, dim=1, stable=True)
    pos = pos[:, :k]
    return (d_top[:, :k].cpu().numpy(),
            torch.take_along_dim(alli, pos, dim=1).cpu().numpy())


def sharded_ann_search(queries: np.ndarray, indexes, k: int,
                       **params) -> Tuple[np.ndarray, np.ndarray]:
    """Search per-shard ANN indexes (any registry method, mixed freely)
    and merge on the host: each index's top-k (k capped at its size),
    ids offset into the global row space (shard s owns ids
    [sum(sizes[:s]), sum(sizes[:s+1]))), -1 kept, then one
    ``merge_topk``.  No index: inf distances and -1 ids."""
    q = np.asarray(queries, np.float32)
    if q.ndim == 1:
        q = q[None, :]
    all_d = []
    all_i = []
    offset = 0
    for idx in indexes:
        d, i = idx.search(q, k=min(k, max(idx.size, 1)), **params)
        gi = np.where(i >= 0, i + offset, -1)
        all_d.append(np.asarray(d, np.float32))
        all_i.append(gi.astype(np.int64))
        offset += idx.size
    if not all_d:
        return (np.full((len(q), k), np.inf, np.float32),
                np.full((len(q), k), -1, np.int64))
    from ..vector.registry import merge_topk
    return merge_topk(np.concatenate(all_d, axis=1),
                      np.concatenate(all_i, axis=1), k)
