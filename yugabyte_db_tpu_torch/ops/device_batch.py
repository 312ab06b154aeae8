"""Host -> device batch formation.

Counterpart of ``yugabyte_db_tpu/ops/device_batch.py``: columnar blocks
concatenate into one batch of torch tensors on an explicit device,
padded to a power-of-two row bucket.  Unsigned 64-bit lanes (key hash,
hybrid time) ride as int64 with the sign bit flipped (``x ^ (1<<63)``):
that keeps the unsigned order under signed compares, which this torch
build's ``uint64`` (no ``<``, ``-`` or ``max``) cannot do itself.

``DeviceBlockCache`` and dictionary-coded string columns stay in
ROADMAP.md (queue 1: tablet read seam, grouped_scan)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..storage.columnar import ColumnarBlock

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
    # string columns' host dictionaries; always empty until dictionary
    # columns are ported (the hand-scan gate still reads it)
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
                device: DeviceLike = "cuda") -> DeviceBatch:
    """Concatenate columnar blocks and ship the requested columns, their
    null masks and the MVCC lanes to ``device``, padded to a row
    bucket."""
    dev = resolve_device(device)
    n = sum(b.n for b in blocks)
    padded = bucket_rows(max(n, 1))

    def lane_parts(cid):
        ps, nps = [], []
        for b in blocks:
            if cid in b.fixed:
                v, m = b.fixed[cid]
                ps.append(v)
                nps.append(m)
            elif cid in b.pk:
                ps.append(b.pk[cid])
                nps.append(np.zeros(b.n, bool))
            else:
                raise KeyError(
                    f"column {cid} not available in columnar form")
        return ps, nps

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    cols: Dict[int, torch.Tensor] = {}
    nulls: Dict[int, torch.Tensor] = {}
    col_bounds: Dict[int, Tuple[float, float]] = {}
    for cid in columns:
        parts, nparts = lane_parts(cid)
        conv = (f64_conversion(parts, dev)
                if parts and parts[0].dtype == np.float64 else None)
        arr = _fill(parts, padded, conv)
        if n and arr.dtype.kind in "fiu":
            # bounds from the parts (the padded tail is zeros and must
            # not contaminate the stats the static SUM scales use)
            col_bounds[cid] = (
                float(min(p.min() for p in parts if p.size)),
                float(max(p.max() for p in parts if p.size)))
        cols[cid] = to_dev(arr)
        nulls[cid] = to_dev(_fill(nparts, padded))
    valid = np.zeros(padded, bool)
    valid[:n] = True
    batch = DeviceBatch(
        n_rows=n, cols=cols, nulls=nulls, valid=to_dev(valid),
        unique_keys=all(b.unique_keys for b in blocks),
        col_bounds=col_bounds)
    batch.key_hash = to_dev(u64_to_flipped_i64(
        _fill([b.key_hash for b in blocks], padded)))
    batch.ht = to_dev(u64_to_flipped_i64(
        _fill([b.ht for b in blocks], padded)))
    batch.write_id = to_dev(
        _fill([b.write_id for b in blocks], padded).astype(np.int64))
    batch.tombstone = to_dev(_fill([b.tombstone for b in blocks], padded))
    return batch
