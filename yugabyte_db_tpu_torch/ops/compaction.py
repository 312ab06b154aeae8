"""Compaction merge + MVCC GC as torch programs on the card.

Counterpart of ``yugabyte_db_tpu/ops/compaction.py``'s
``chunk_merge_kernel``, a jitted XLA program (no Pallas kernel) that
stands in place of the reference's heap-based MergingIterator loop and
per-KV retention decisions (reference:
src/yb/rocksdb/db/compaction_job.cc:665 ProcessKeyValueCompaction,
src/yb/docdb/docdb_compaction_context.cc:783 DocDBCompactionFeed):

1. keys -> fixed-width big-endian u64 word columns; one stable
   multi-key sort merges a frontier's rows at once (dockey words
   ascending, then hybrid time and write id descending, so versions of
   a doc key come out newest-first);
2. the history-retention decision (reference: HistoryRetentionDirective,
   docdb_compaction_context.h:106) is a vector expression over
   (same-key-as-prev, ht, tombstone):
      keep = not-exact-duplicate AND
             (ht > history_cutoff  OR  (first version <= cutoff AND not
              tombstone))

Doc-key encodings are prefix-free, so zero-padding keys to a common
width preserves lexicographic order.

On the device, u64 lanes ride as int64 with the sign bit flipped
(``ops/device_batch.py``), which keeps the unsigned order under signed
compares: U64_MAX - x is ``~x`` there and U64_MAX is INT64_MAX.  Write
ids (u32) ride as int64 unflipped.  ``lax.sort(num_keys=Wd+2)`` is
stable, so the multi-key sort is Wd + 2 stable argsort passes, least
significant key first, each over the key gathered through the
permutation so far: rows tied on every key keep their frontier order,
as in the reference.  Nothing here reads a value back to the host: the
program enqueues on the current stream and returns device tensors.

The reference's whole-input program (``merge_gc_split_kernel``, also a
jitted XLA program) is the same sort and retention rule without the
emit bound and the carry; its drivers (``run_merge_gc``,
``compact_runs``, ``compact_entry_arrays``) serve the row compaction
path (docdb/compaction.py ``_compact_rows``), with the run concatenation
helpers (``concat_runs``, ``pad_key_matrices``) that split each run's
hybrid-time suffix before zero-padding its doc keys."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..dockv.key_encoding import ValueType
from ..utils.hybrid_time import ENCODED_SIZE
from .device_batch import flipped_i64_scalar, u64_to_flipped_i64

_HT_SUFFIX = ENCODED_SIZE + 1  # kHybridTime marker + 12 encoded bytes
_I64_MAX = (1 << 63) - 1       # U64_MAX in the flipped encoding
_U32_MAX = 0xFFFFFFFF


class KeySuffixError(ValueError):
    """A key matrix fed to the compaction path does not carry the
    fixed-size hybrid-time suffix (corrupt or mixed-layout SST)."""

    def __init__(self, n_bad: int, n_total: int):
        self.n_bad = n_bad
        self.n_total = n_total
        super().__init__(
            f"{n_bad}/{n_total} keys lack the kHybridTime suffix marker "
            "(corrupt or mixed-layout input)")


def keys_to_words(keys: np.ndarray) -> np.ndarray:
    """[N, L] uint8 -> [N, W] uint64 big-endian words (order-preserving)."""
    n, l = keys.shape
    w = (l + 7) // 8
    padded = np.zeros((n, w * 8), np.uint8)
    padded[:, :l] = keys
    return padded.reshape(n, w, 8).view(">u8").reshape(n, w).astype(np.uint64)


def split_ht_suffix(keys: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[N, L] full SubDocKeys -> (dockey part [N, L-13], ht u64, write_id
    u32) — vectorized split of the fixed-size hybrid-time suffix."""
    dk = keys[:, :-_HT_SUFFIX]
    check_ht_suffix(keys)
    ht_enc = keys[:, -ENCODED_SIZE:]
    ht = ~np.ascontiguousarray(ht_enc[:, :8]).view(">u8").reshape(-1).astype(
        np.uint64)
    wid = ~np.ascontiguousarray(ht_enc[:, 8:]).view(">u4").reshape(
        -1).astype(np.uint32)
    return dk, ht, wid


def check_ht_suffix(keys: np.ndarray) -> None:
    """Raise KeySuffixError unless every row of the [N, L] key matrix
    carries the kHybridTime marker at the fixed suffix position."""
    if keys.shape[1] <= _HT_SUFFIX:
        raise KeySuffixError(keys.shape[0], keys.shape[0])
    ok = keys[:, -_HT_SUFFIX] == ValueType.kHybridTime
    if not ok.all():
        raise KeySuffixError(int((~ok).sum()), keys.shape[0])


def compact_entry_arrays(keys: np.ndarray, tombstone: np.ndarray,
                         history_cutoff: int, device: DeviceLike = "cuda"
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Full SubDocKey matrix [N, L] -> (sorted order, keep mask in
    sorted order): one run through :func:`compact_runs`."""
    return compact_runs([(keys, tombstone)], history_cutoff, device=device)


def pad_key_matrices(mats: Sequence[np.ndarray]) -> np.ndarray:
    """Stack [Ni, Li] key matrices into one [sum Ni, max Li] matrix,
    right-padded with zeros (order-safe: doc-key encodings are
    prefix-free).  Split hybrid-time suffixes BEFORE padding
    (:func:`concat_runs`)."""
    w = max(m.shape[1] for m in mats)
    total = sum(m.shape[0] for m in mats)
    out = np.zeros((total, w), np.uint8)
    pos = 0
    for m in mats:
        out[pos:pos + m.shape[0], :m.shape[1]] = m
        pos += m.shape[0]
    return out


def concat_runs(runs: Sequence[Tuple[np.ndarray, np.ndarray]]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """runs: [(keys [Ni, Li], tombstone [Ni])] -> (dockey_padded, ht,
    wid, tombstone), each run's hybrid-time suffix split before the
    padding."""
    dks, hts, wids, tombs = [], [], [], []
    for keys, tomb in runs:
        dk, ht, wid = split_ht_suffix(keys)
        dks.append(dk)
        hts.append(ht)
        wids.append(wid)
        tombs.append(tomb)
    return (pad_key_matrices(dks), np.concatenate(hts),
            np.concatenate(wids), np.concatenate(tombs))


# ---------------------------------------------------------------------------
# The merge program (torch, on the tensors' device)
# ---------------------------------------------------------------------------
def _stable_multikey_order(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting rows lexicographically by `keys` (most
    significant first), ties kept in row order — ``lax.sort`` with
    ``num_keys=len(keys)`` and an iota payload.  Stable argsort passes,
    least significant key first."""
    perm = None
    for k in reversed(keys):
        kk = k if perm is None else k[perm]
        p = torch.sort(kk, stable=True).indices
        perm = p if perm is None else perm[p]
    return perm


def _sorted_lanes(dk: torch.Tensor, ht: torch.Tensor, wid: torch.Tensor,
                  valid: torch.Tensor):
    """The merge's sort: (order, inv_ht sorted, inv_wid sorted).  Padding
    rows (valid False) get a saturated first key word and sort last."""
    wd = dk.shape[1]
    first = torch.where(valid, dk[:, 0], torch.full_like(dk[:, 0],
                                                         _I64_MAX))
    inv_ht = torch.bitwise_not(ht)          # U64_MAX - ht, flipped
    inv_wid = _U32_MAX - wid
    order = _stable_multikey_order(
        [first] + [dk[:, i] for i in range(1, wd)] + [inv_ht, inv_wid])
    return order, inv_ht[order], inv_wid[order]


def _retention(dk_s, ht_s, wid_s, tomb_s, valid_s, cutoff_f: int,
               carry=None):
    """keep over the sorted rows; `carry` = (carry_dk words (flipped
    ints), carry_ht (flipped), carry_wid, carry_leq) of the previous
    chunk's last emitted row, or None."""
    same_next = torch.all(dk_s[1:] == dk_s[:-1], dim=1)
    dup_next = same_next & (ht_s[1:] == ht_s[:-1]) & (wid_s[1:] ==
                                                     wid_s[:-1])
    leq = ht_s <= cutoff_f
    if carry is None:
        first_same = torch.zeros(1, dtype=torch.bool, device=dk_s.device)
        first_dup = first_same
        first_prev_leq = first_same
    else:
        c_dk, c_ht, c_wid, c_leq = carry
        first_same = dk_s[0, 0] == c_dk[0]
        for i in range(1, dk_s.shape[1]):
            first_same = first_same & (dk_s[0, i] == c_dk[i])
        first_same = first_same.reshape(1)
        first_dup = first_same & ((ht_s[0] == c_ht) & (wid_s[0] == c_wid))
        first_prev_leq = torch.full((1,), bool(c_leq), dtype=torch.bool,
                                    device=dk_s.device)
    same_dockey = torch.cat([first_same, same_next])
    exact_dup = torch.cat([first_dup.reshape(1), dup_next])
    prev_leq = torch.cat([first_prev_leq, leq[:-1]])
    first_leq = leq & (~same_dockey | ~prev_leq)
    return valid_s & ~exact_dup & ((ht_s > cutoff_f) | (first_leq & ~tomb_s))


def _lex_lt(cols, bounds):
    """Vectorized lexicographic (cols...) < (bounds...) over parallel
    column tensors vs scalar bound components."""
    less = None
    eq = None
    for c, b in zip(cols, bounds):
        c_lt, c_eq = c < b, c == b
        if less is None:
            less, eq = c_lt, c_eq
        else:
            less = less | (eq & c_lt)
            eq = eq & c_eq
    return less


def chunk_merge_kernel(dk_words: torch.Tensor, ht: torch.Tensor,
                       wid: torch.Tensor, tombstone: torch.Tensor,
                       valid: torch.Tensor,
                       bound: Optional[Tuple[Sequence[int], int, int]],
                       carry: Optional[Tuple[Sequence[int], int, int,
                                             bool]],
                       history_cutoff: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One frontier merge step over [M] rows: dk_words [M, Wd] and ht
    [M] flipped int64, wid [M] int64, tombstone/valid [M] bool,
    history_cutoff a u64 Python int.  Returns (order, emit, keep), all [M] and
    aligned to the sorted frontier: `order` maps sorted position ->
    frontier position, `emit` marks the sorted prefix strictly below
    the bound (every valid row when there is no bound), `keep` the MVCC
    retention mask (meaningful on emitted rows).

    bound = (dk words, ht, write id) of the smallest key any unpulled
    block could contribute; carry = (dk words, ht, write id, leq) of the
    previous chunk's last emitted row; both as u64 Python ints, or None.
    The emit comparison is strict: a frontier row equal to the bound
    stays pending, because an exact duplicate of it may still arrive."""
    wd = dk_words.shape[1]
    order, inv_ht_s, inv_wid_s = _sorted_lanes(dk_words, ht, wid, valid)
    dk_s = dk_words[order]
    ht_s = ht[order]
    wid_s = wid[order]
    valid_s = valid[order]
    if bound is None:
        emit = valid_s
    else:
        b_dk, b_ht, b_wid = bound
        cols = [dk_s[:, i] for i in range(wd)] + [inv_ht_s, inv_wid_s]
        bounds = ([flipped_i64_scalar(w) for w in b_dk]
                  + [~flipped_i64_scalar(b_ht), _U32_MAX - int(b_wid)])
        emit = valid_s & _lex_lt(cols, bounds)
    c = None
    if carry is not None:
        c_dk, c_ht, c_wid, c_leq = carry
        c = ([flipped_i64_scalar(w) for w in c_dk],
             flipped_i64_scalar(c_ht), int(c_wid), bool(c_leq))
    keep = _retention(dk_s, ht_s, wid_s, tombstone[order], valid_s,
                      flipped_i64_scalar(history_cutoff), c)
    return order, emit, keep


def merge_gc_split_kernel(dk_words: torch.Tensor, ht: torch.Tensor,
                          wid: torch.Tensor, tombstone: torch.Tensor,
                          valid: torch.Tensor, history_cutoff: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole-input merge + MVCC GC: sort by (dockey words asc, ht
    desc, write id desc, row), then the retention rule over the sorted
    rows.  Lanes as chunk_merge_kernel takes them (flipped int64 words
    and ht, int64 write ids, bools); returns (order, keep), both [N],
    aligned to the sorted rows.  Invalid (padding) rows sort last and
    are never kept."""
    order, _, _ = _sorted_lanes(dk_words, ht, wid, valid)
    return order, _retention(dk_words[order], ht[order], wid[order],
                             tombstone[order], valid[order],
                             flipped_i64_scalar(history_cutoff))


# ---------------------------------------------------------------------------
# Host drivers
# ---------------------------------------------------------------------------
def _pad_rows(n: int) -> int:
    """Row-count bucket (pow2, at least 4096) so every frontier of a
    bucket shares one shape."""
    b = 1 << 12
    while b < n:
        b <<= 1
    return b


def to_device_lanes(dk_words: np.ndarray, ht: np.ndarray, wid: np.ndarray,
                    tomb: np.ndarray, valid: np.ndarray,
                    device: torch.device):
    """Host lanes (u64 words, u64 ht, u32 write ids, bools) -> the
    program's device lanes (flipped int64, int64, bool)."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (put(u64_to_flipped_i64(dk_words)), put(u64_to_flipped_i64(ht)),
            put(np.asarray(wid, np.uint32).astype(np.int64)),
            put(np.asarray(tomb, bool)), put(np.asarray(valid, bool)))


#: calls of the whole-input program (run_merge_gc), by device type
MERGE_GC_STATS = {"calls": 0, "rows": 0}


def run_merge_gc(dk_words: np.ndarray, ht: np.ndarray, wid: np.ndarray,
                 tomb: np.ndarray, history_cutoff: int,
                 device: DeviceLike = "cuda"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Bucket-padded driver of merge_gc_split_kernel on `device`:
    padding rows carry valid=False, sort last and are never kept; the
    returned host (order, keep) are cut back to the true row count."""
    dev = resolve_device(device)
    n = dk_words.shape[0]
    padded = _pad_rows(n)
    if padded != n:
        dk_words = np.concatenate(
            [dk_words, np.zeros((padded - n, dk_words.shape[1]), np.uint64)])
        ht = np.concatenate([ht, np.zeros(padded - n, np.uint64)])
        wid = np.concatenate([wid, np.zeros(padded - n, np.uint32)])
        tomb = np.concatenate([tomb, np.zeros(padded - n, bool)])
    valid = np.zeros(padded, bool)
    valid[:n] = True
    MERGE_GC_STATS["calls"] += 1
    MERGE_GC_STATS["rows"] += n
    order, keep = merge_gc_split_kernel(
        *to_device_lanes(dk_words, ht, wid, tomb, valid, dev),
        history_cutoff)
    return (order[:n].to(torch.int32).cpu().numpy(),
            keep[:n].cpu().numpy())


def compact_runs(runs: Sequence[Tuple[np.ndarray, np.ndarray]],
                 history_cutoff: int, device: DeviceLike = "cuda"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge + GC across sorted runs of differing key widths: (order,
    keep), `order` indexing the concatenation of the runs in the given
    order."""
    dk_padded, ht, wid, tomb = concat_runs(runs)
    return run_merge_gc(keys_to_words(dk_padded), ht, wid, tomb,
                        history_cutoff, device=device)


# ---------------------------------------------------------------------------
# Chunked run-aware merge: the device half of the pipelined compaction
# engine (docdb/compaction.py owns the host-side driver).
#
#: process-lifetime merge-call accounting (the reference's compile
#: accounting).  A signature is one (frontier_rows, num_dk_words) shape;
#: torch compiles nothing, so "compiles" counts first sightings of a
#: shape (the caching allocator's and the sort's buffers are per shape)
#: and a repeat compaction of the same shape reports none.
_KERNEL_SIGS: set = set()
KERNEL_STATS = {"compiles": 0, "calls": 0, "cache_hits": 0}


def kernel_cache_stats() -> dict:
    return dict(KERNEL_STATS)


def reset_kernel_stats() -> None:
    KERNEL_STATS.update(compiles=0, calls=0, cache_hits=0)


def _note_kernel_call(sig: tuple) -> None:
    KERNEL_STATS["calls"] += 1
    if sig in _KERNEL_SIGS:
        KERNEL_STATS["cache_hits"] += 1
    else:
        _KERNEL_SIGS.add(sig)
        KERNEL_STATS["compiles"] += 1


def merge_frontier(dk_words: np.ndarray, ht: np.ndarray, wid: np.ndarray,
                   tomb: np.ndarray, valid: np.ndarray,
                   bound: Optional[Tuple[np.ndarray, int, int]],
                   carry: Optional[Tuple[np.ndarray, int, int, bool]],
                   history_cutoff: int, device: DeviceLike = "cuda"):
    """Host wrapper of chunk_merge_kernel: ships the frontier's lanes to
    `device` (one copy each; the optional bound and carry go as Python
    scalars, so no value is read back) and records the call accounting.
    Returns DEVICE tensors (order, emit, keep) so the caller overlaps
    host work with the sort before materializing them."""
    dev = resolve_device(device)
    m, wd = dk_words.shape
    _note_kernel_call((m, wd))
    b = None if bound is None else (
        [int(x) for x in bound[0]], int(bound[1]), int(bound[2]))
    c = None if carry is None else (
        [int(x) for x in carry[0]], int(carry[1]), int(carry[2]),
        bool(carry[3]))
    return chunk_merge_kernel(
        *to_device_lanes(dk_words, ht, wid, tomb, valid, dev), b, c,
        history_cutoff)
