"""Host -> device batch formation.

Counterpart of ``yugabyte_db_tpu/ops/device_batch.py``: columnar blocks
concatenate into one batch of torch tensors on an explicit device,
padded to a power-of-two row bucket.  Unsigned 64-bit lanes (key hash,
hybrid time) ride as int64 with the sign bit flipped (``x ^ (1<<63)``):
that keeps the unsigned order under signed compares, which this torch
build's ``uint64`` (no ``<``, ``-`` or ``max``) cannot do itself.
String columns ride as int32 dictionary codes.  ``DeviceBlockCache``
keeps built batches on the device."""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..storage.columnar import ColumnarBlock
from ..storage.lane_codec import merge_dicts

_BUCKETS = [1 << b for b in range(12, 24)]  # 4096 .. 8M rows

#: XOR with this maps uint64 onto int64 preserving order
U64_FLIP = np.uint64(1 << 63)


def bucket_rows(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    b = _BUCKETS[-1]
    while b < n:          # beyond the table: keep doubling
        b <<= 1
    return b


def u64_to_flipped_i64(a: np.ndarray) -> np.ndarray:
    """uint64 lane -> order-preserving int64 lane."""
    return (np.asarray(a, np.uint64) ^ U64_FLIP).view(np.int64)


def flipped_i64_scalar(v: int) -> int:
    """A uint64 scalar in the flipped int64 encoding."""
    x = int(v) ^ (1 << 63)
    return x - (1 << 64) if x >= 1 << 63 else x


@dataclass
class DeviceBatch:
    """Padded columnar batch on one device.

    cols / nulls: col_id -> [N] tensors (nulls True where SQL NULL).
    valid: [N] bool — False on padding rows.
    key_hash / ht: flipped int64 (see module doc); write_id int64.
    """

    n_rows: int                      # true (unpadded) row count
    cols: Dict[int, torch.Tensor]
    nulls: Dict[int, torch.Tensor]
    valid: torch.Tensor
    key_hash: Optional[torch.Tensor] = None
    ht: Optional[torch.Tensor] = None
    write_id: Optional[torch.Tensor] = None
    tombstone: Optional[torch.Tensor] = None
    unique_keys: bool = True
    # string columns ride as int32 dictionary CODES in `cols`; their
    # sorted dictionaries stay on the host here
    dicts: Dict[int, np.ndarray] = field(default_factory=dict)
    # per-column (min, max) memo for int32 columns — the hand-scan gate
    # checks f32-exactness once per batch (a device sync), not per query
    int32_ranges: Dict[int, tuple] = field(default_factory=dict)
    # host-side per-column value bounds in f64, computed at batch build
    # — expr_bound turns them into STATIC fixed-point SUM scales
    col_bounds: Dict[int, Tuple[float, float]] = field(default_factory=dict)

    @property
    def padded_rows(self) -> int:
        return int(self.valid.shape[0])

    @property
    def device(self) -> torch.device:
        return self.valid.device


def _float64_device_dtype(device: torch.device) -> np.dtype:
    """Device dtype for genuinely fractional f64 columns: f64 on the CPU
    (full double-precision per-row eval), f32 on CUDA — the scan
    kernel's exact int64 fixed-point accumulation keeps SUMs from
    drifting, the residual is the per-row f32 representation.  The
    `device_float_dtype` flag (auto|float32|float64) overrides."""
    from ..utils import flags
    mode = flags.get("device_float_dtype")
    if mode == "float64":
        return np.dtype(np.float64)
    if mode == "float32":
        return np.dtype(np.float32)
    if mode != "auto":
        raise ValueError(
            f"device_float_dtype must be auto|float32|float64, got "
            f"{mode!r}")
    return np.dtype(np.float64 if device.type == "cpu" else np.float32)


def _integral_int32(arr: np.ndarray) -> bool:
    """True when every value is an exact integer within int32 range (a
    cheap prefix sample rejects typical fractional columns first)."""
    if arr.size == 0:
        return True
    head = arr[:1024]
    if not (np.all(np.isfinite(head)) and np.all(head == np.rint(head))):
        return False
    if not (np.all(np.isfinite(arr)) and np.all(arr == np.rint(arr))):
        return False
    lo, hi = arr.min(), arr.max()
    return -2**31 <= lo and hi < 2**31


def f64_conversion(parts, device: torch.device) -> Optional[np.dtype]:
    """THE conversion policy for f64 columns: int32 when integer-valued
    in every given array (exact end-to-end aggregation), else the
    device/flag float dtype.  Returns the dtype to convert to, or None
    to keep f64."""
    if not parts or any(p.dtype != np.float64 for p in parts):
        return None
    if all(_integral_int32(p) for p in parts):
        return np.dtype(np.int32)
    dd = _float64_device_dtype(device)
    return None if dd == np.float64 else dd


def _fill(parts: List[np.ndarray], padded: int,
          out_dtype: Optional[np.dtype] = None) -> np.ndarray:
    dt = out_dtype or parts[0].dtype
    out = np.zeros((padded,) + parts[0].shape[1:], dt)
    pos = 0
    for p in parts:
        out[pos:pos + len(p)] = p
        pos += len(p)
    return out


def build_batch(blocks: Sequence[ColumnarBlock],
                columns: Sequence[int],
                device: DeviceLike = "cuda",
                with_mvcc: bool = True,
                pad_to: Optional[int] = None,
                bounds_blocks: Optional[Sequence[ColumnarBlock]] = None,
                dict_plan=None) -> DeviceBatch:
    """Concatenate columnar blocks and ship the requested columns, their
    null masks and (``with_mvcc``) the MVCC lanes to ``device``, padded
    to a row bucket (``pad_to`` when given: the streaming scan pads
    every chunk to one shared bucket, hence one signature).

    Where the reference fills the padded host buffers with one fused
    GIL-released native copy (``storage/native_lib.copy_multi``), the
    port fills them with numpy assignments.

    ``bounds_blocks``: when given, the f64 conversion policy and the
    per-column bounds (the inputs of the static SUM scales) come from
    THESE blocks instead of `blocks`.

    String (varlen) columns ride as int32 codes into sorted dictionaries
    (``batch.dicts``).  With ``dict_plan`` (an ops/grouped_scan.DictPlan
    covering them) the codes are the plan's scan-global remapped codes,
    shared by every chunk of a streamed scan; without one the blocks'
    own dictionaries are merged (``_dict_merge_column``), decoding rows
    only when a block can't dictionary-encode."""
    dev = resolve_device(device)
    n = sum(b.n for b in blocks)
    padded = pad_to or bucket_rows(max(n, 1))

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    def lane_parts(src_blocks, cid, with_nulls=True):
        ps, nps = [], []
        for b in src_blocks:
            if cid in b.fixed:
                v, m = b.fixed[cid]
                ps.append(v)
                if with_nulls:
                    nps.append(m)
            elif cid in b.pk:
                ps.append(b.pk[cid])
                if with_nulls:
                    nps.append(np.zeros(b.n, bool))
            else:
                raise KeyError(
                    f"column {cid} not available in columnar form")
        return ps, nps

    cols: Dict[int, torch.Tensor] = {}
    nulls: Dict[int, torch.Tensor] = {}
    dicts: Dict[int, np.ndarray] = {}
    col_bounds: Dict[int, Tuple[float, float]] = {}
    for cid in columns:
        if dict_plan is not None and cid in dict_plan.dicts:
            # scan-global plan: per-block codes are already remapped
            dicts[cid] = dict_plan.dicts[cid]
            arr = _fill([dict_plan.block_codes(cid, b) for b in blocks]
                        or [np.zeros(0, np.int32)], padded)
            null = _fill([np.asarray(b.varlen[cid][2], bool)
                          for b in blocks] or [np.zeros(0, bool)], padded)
        elif blocks and all(cid in b.varlen for b in blocks):
            got = _dict_merge_column(blocks, cid)
            null = _fill([np.asarray(b.varlen[cid][2], bool)
                          for b in blocks], padded)
            if got is not None:
                dicts[cid], code_parts = got
                arr = _fill(code_parts, padded)
            else:
                vparts = []
                for b in blocks:
                    try:
                        vparts.append(varlen_strings(b, cid))
                    except UnicodeDecodeError:
                        # BINARY payloads don't dictionary-encode: like
                        # any other non-columnar column, the caller
                        # falls back
                        raise KeyError(
                            f"column {cid} not dictionary-encodable")
                values = np.where(null[:n], "", np.concatenate(vparts))
                dicts[cid], codes = np.unique(values, return_inverse=True)
                arr = _fill([codes.astype(np.int32).reshape(-1)], padded)
        else:
            parts, nparts = lane_parts(blocks, cid)
            stat_parts = (parts if bounds_blocks is None else
                          lane_parts(bounds_blocks, cid, False)[0])
            conv = (f64_conversion(stat_parts, dev)
                    if stat_parts and stat_parts[0].dtype == np.float64
                    else None)
            arr = _fill(parts, padded, conv)
            if sum(len(p) for p in stat_parts) and arr.dtype.kind in "fiu":
                # bounds from the parts (the padded tail is zeros and
                # must not contaminate the static SUM scales' stats)
                col_bounds[cid] = (
                    float(min(p.min() for p in stat_parts if p.size)),
                    float(max(p.max() for p in stat_parts if p.size)))
            null = _fill(nparts, padded)
        cols[cid] = to_dev(arr)
        nulls[cid] = to_dev(null)
    valid = np.zeros(padded, bool)
    valid[:n] = True
    batch = DeviceBatch(
        n_rows=n, cols=cols, nulls=nulls, valid=to_dev(valid),
        unique_keys=all(b.unique_keys for b in blocks), dicts=dicts,
        col_bounds=col_bounds)
    if with_mvcc:
        batch.key_hash = to_dev(u64_to_flipped_i64(
            _fill([b.key_hash for b in blocks], padded)))
        batch.ht = to_dev(u64_to_flipped_i64(
            _fill([b.ht for b in blocks], padded)))
        batch.write_id = to_dev(
            _fill([b.write_id for b in blocks], padded).astype(np.int64))
        batch.tombstone = to_dev(_fill([b.tombstone for b in blocks],
                                       padded))
    return batch


def _dict_merge_column(blocks: Sequence[ColumnarBlock], cid: int):
    """(global uniq, per-block global-code arrays) through the per-block
    dictionary merge — only each block's (few) uniques are decoded.
    None when any block can't dictionary-encode."""
    per = []
    for b in blocks:
        got = b.dict_varlen(cid)
        if got is None:
            return None
        per.append(got)
    uniq, remaps = merge_dicts([u for u, _ in per])
    parts = [np.ascontiguousarray(remap[codes])
             for (_, codes), remap in zip(per, remaps)]
    return uniq, parts


def varlen_strings(b: ColumnarBlock, cid: int) -> np.ndarray:
    """Decode one varlen column of a block into an object array of str
    (raises on non-UTF8 payloads)."""
    ends, heap, _nulls = b.varlen[cid]
    out = np.empty(b.n, object)
    lo = 0
    for i in range(b.n):
        hi = int(ends[i])
        out[i] = heap[lo:hi].decode()
        lo = hi
    return out


class DeviceBlockCache:
    """LRU cache of device-resident DeviceBatches keyed by the caller
    (e.g. store, column set, chunk plan).  Eviction by batch bytes."""

    def __init__(self, capacity_bytes: int = 2 << 30):
        self.capacity = capacity_bytes
        self._map: "OrderedDict[tuple, Tuple[DeviceBatch, int]]" = \
            OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        # invalidations may come from other threads than lookups
        self._lock = threading.Lock()

    def get_or_build(self, key: tuple, builder) -> DeviceBatch:
        with self._lock:
            if key in self._map:
                self.hits += 1
                self._map.move_to_end(key)
                return self._map[key][0]
            self.misses += 1
        batch = builder()
        size = _batch_bytes(batch)
        with self._lock:
            if key in self._map:
                # a racing builder landed the same key while we built
                # off-lock: keep the resident entry
                self._map.move_to_end(key)
                return self._map[key][0]
            self._map[key] = (batch, size)
            self._bytes += size
            while self._bytes > self.capacity and len(self._map) > 1:
                _, (old, osize) = self._map.popitem(last=False)
                self._bytes -= osize
                del old
        return batch

    def invalidate_prefix(self, prefix: tuple) -> None:
        """Drop entries whose key starts with `prefix`."""
        with self._lock:
            drop = [k for k in self._map if k[:len(prefix)] == prefix]
            for k in drop:
                _, size = self._map.pop(k)
                self._bytes -= size

    def clear(self):
        with self._lock:
            self._map.clear()
            self._bytes = 0


def _batch_bytes(b: DeviceBatch) -> int:
    total = 0
    for a in [b.valid] + list(b.cols.values()) + list(b.nulls.values()) + \
            [b.key_hash, b.ht, b.write_id, b.tombstone]:
        if a is not None:
            total += a.numel() * a.element_size()
    return total
