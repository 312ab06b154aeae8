"""Device hash join — the FK-equijoin probe inside the fused plan.

Counterpart of ``yugabyte_db_tpu/ops/join_scan.py``.  TPC-H's
multi-operator queries (Q3/Q5/Q10-shaped) are an FK equijoin from the big
fact table (lineitem) into a small, already-filtered dimension side
(orders, customer), followed by GROUP BY and aggregates:

- The BUILD side ships with the read request (:class:`JoinWire`): unique
  join keys plus the payload columns the group/aggregate step needs.
  :func:`make_join_runtime` turns it into an open-addressed pow2 hash
  table (linear probing, load factor <= 0.5) on the HOST, bit for bit the
  reference's, and pads keys and payload to pow2 buckets so build-side
  growth inside a bucket never changes a plan signature.  The runtime
  also holds device copies of the table and the payload lanes, made once
  per :func:`make_join_runtimes`, so a streamed plan ships them once, not
  once per chunk.
- On the device the table is ONE packed lane (:func:`pack_table`): a
  16-byte slot ``{int64 key; int32 val; int32 pad}`` per slot, or an
  8-byte ``{int32 key; int32 val}`` one where every build key fits in
  int32; ``val = -1`` marks an empty slot.  A step of the walk then reads
  one slot, one sector, where the host's three arrays would take three.
- The PROBE runs inside the fused plan (ops/plan_fusion.py) through
  :func:`probe_rows`: on CUDA tensors the hand kernel
  ``csrc/join_probe.cu`` (each thread walks the chains of several
  consecutive probe rows at once); on CPU tensors its plain version
  :func:`probe_table`, the reference's ``lax.while_loop`` written as a
  Python loop of whole-batch steps over the same packed table.
- String join keys ride as dictionary codes: build keys map through the
  probe column's scan-global dictionary on the host; a build key absent
  from the dictionary can never match and keeps a distinct negative
  sentinel (-2 - row), so the table stays collision-correct.
- Build-side payload columns gather by match index after the probe;
  string payloads dictionary-encode on the host, so group keys stay
  integer strides on the device.

Ineligible shapes raise :class:`JoinIneligible` with a typed reason (the
reference then answers on its interpreted join, which the port refuses).
:func:`hash_join_cpu` is the numpy twin of the probe, used by the plan's
CPU twin.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .hand_scan import LAUNCHES, _lib, _raise_on, _stream

#: build-side payload columns live at ids >= this in plan expressions,
#: group specs and aggregate ASTs, so they never collide with a probe
#: table's real column ids
BUILD_COL_BASE = 1 << 20

#: process-wide join accounting (builds and typed refusals)
JOIN_STATS = {"builds": 0, "fallbacks": 0}

#: stats of the most recent build-table construction
LAST_JOIN_STATS: dict = {}

#: bytes per slot of the packed device table (pack_table): 16 holds any
#: int64 key, 8 only keys that fit in int32
SLOT_WIDE, SLOT_NARROW = 16, 8

_MIN_TABLE_SLOTS = 8
_MAX_TABLE_SLOTS_HARD = 1 << 24
_HASH_MULT = np.uint64(0x9E3779B97F4A7C15)
#: the same multiplier as a two's-complement int64: torch's int64 product
#: wraps to the bits of the uint64 one
_HASH_MULT_I64 = int(_HASH_MULT) - (1 << 64)

REASON_JOIN_OFF = "join_pushdown_off"
REASON_DUPLICATE_KEY = "duplicate_build_key"
REASON_BUILD_OVERFLOW = "build_overflow"
REASON_KEY_TYPE = "join_key_type"
REASON_PROBE_SHAPE = "probe_shape"
REASON_STAGE_COUNT = "join_stage_count"


class JoinIneligible(Exception):
    """Typed refusal: the device join cannot serve this shape exactly.
    ``stage`` is the 0-based probe stage that refused (None when the
    refusal is not stage-specific): a multi-join chain is refused WHOLE,
    and the reason names the stage that refused it."""

    def __init__(self, reason: str, detail: str = "",
                 stage: Optional[int] = None):
        if stage is not None:
            detail = (f"stage {stage}: {detail}" if detail
                      else f"stage {stage}")
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason
        self.detail = detail
        self.stage = stage


@dataclass
class JoinWire:
    """The build side as it crosses the wire inside a ReadRequest.

    ``probe_col``: probe-table column id holding the FK (or, for a chain
    stage, an earlier stage's payload id).  ``keys``: UNIQUE build-side
    join keys — an int64 array, or an object array of strings when the
    probe column is dictionary-coded.  ``payload``: build-column id
    (>= BUILD_COL_BASE) -> (values, nulls) arrays aligned with ``keys``;
    values are numeric or object (string) arrays."""
    probe_col: int
    keys: np.ndarray
    payload: Dict[int, Tuple[np.ndarray, np.ndarray]] = \
        field(default_factory=dict)

    def signature(self) -> tuple:
        """The SHAPE identity of this build side (not its contents):
        probe column, payload ids and payload kinds."""
        kinds = tuple(
            (bid, "str" if self.payload[bid][0].dtype == object
             else "num")
            for bid in sorted(self.payload))
        return (self.probe_col, kinds)


def table_bucket(n_build: int, max_slots: int) -> int:
    """Smallest pow2 slot count >= 2 * n_build (load factor <= 0.5, which
    bounds probe chains and guarantees every walk meets an empty slot),
    floored at _MIN_TABLE_SLOTS.  Raises JoinIneligible
    (REASON_BUILD_OVERFLOW) past the pow2 cap of `max_slots`."""
    cap = _MIN_TABLE_SLOTS
    limit = min(max(int(max_slots), _MIN_TABLE_SLOTS),
                _MAX_TABLE_SLOTS_HARD)
    while cap < limit:
        cap <<= 1
    s = _MIN_TABLE_SLOTS
    while s < 2 * n_build:
        if s >= cap:
            raise JoinIneligible(
                REASON_BUILD_OVERFLOW,
                f"{n_build} build rows need > {cap} slots")
        s <<= 1
    return s


def _home_slots(keys: np.ndarray, num_slots: int) -> np.ndarray:
    """Multiplicative-hash home slot per key (the high bits: the low bits
    of a Fibonacci hash are the weak ones)."""
    bits = num_slots.bit_length() - 1
    h = keys.astype(np.uint64) * _HASH_MULT
    return (h >> np.uint64(64 - bits)).astype(np.int64)


def build_hash_table(keys: np.ndarray, num_slots: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Open-addressed linear-probe table over UNIQUE int64 keys: (used
    bool[S], table_key int64[S], table_val int32[S] = build-row index).
    Batch insertion: each round every unplaced key bids for its current
    slot, the first in input order wins, losers (and keys whose slot was
    already taken) advance one slot.  A key only advances past an
    occupied slot and slots never free, so no empty slot lies between a
    key's home and its resting place, and the probe's hit-or-empty walk
    is exact."""
    n = len(keys)
    if n and len(np.unique(keys)) != n:
        raise JoinIneligible(REASON_DUPLICATE_KEY,
                             "build keys are not unique")
    used = np.zeros(num_slots, bool)
    tkey = np.zeros(num_slots, np.int64)
    tval = np.zeros(num_slots, np.int32)
    if not n:
        return used, tkey, tval
    mask = num_slots - 1
    slots = _home_slots(keys, num_slots)
    pending = np.arange(n)
    while len(pending):
        s = slots[pending]
        order = np.argsort(s, kind="stable")
        s_sorted = s[order]
        first = np.ones(len(order), bool)
        first[1:] = s_sorted[1:] != s_sorted[:-1]
        winners = pending[order[first]]
        ws = slots[winners]
        free = ~used[ws]
        claim = winners[free]
        cs = slots[claim]
        used[cs] = True
        tkey[cs] = keys[claim]
        tval[cs] = claim
        placed = np.zeros(n, bool)
        placed[claim] = True
        pending = pending[~placed[pending]]
        slots[pending] = (slots[pending] + 1) & mask
    return used, tkey, tval


@dataclass
class JoinRuntime:
    """Host-resolved build side, ready for the fused plan.

    Signature parts: ``probe_col``, ``num_slots``, ``build_rows_pad``,
    ``build_cols`` (sorted payload ids) and each payload lane's dtype.
    Run-time parts: the table arrays, the true build-row count and the
    padded payload lanes, so growth inside one pow2 bucket keeps the
    signature.  ``device_lanes`` holds the table and payload lanes on the
    plan's device: (packed table, payload values tuple, payload nulls
    tuple), the table as :func:`pack_table` lays it out, the payloads in
    ``build_cols`` order."""
    probe_col: int
    num_slots: int                    # pow2 table bucket
    build_rows_pad: int               # pow2 payload bucket
    n_build: int                      # true build rows
    used: np.ndarray
    table_key: np.ndarray
    table_val: np.ndarray
    #: build keys AFTER dictionary mapping, aligned with the wire's build
    #: rows — the CPU twin probes these (hash_join_cpu), so its match
    #: indices equal the table's
    keys_mapped: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    build_cols: Tuple[int, ...] = ()
    payload_vals: Dict[int, np.ndarray] = field(default_factory=dict)
    payload_nulls: Dict[int, np.ndarray] = field(default_factory=dict)
    payload_dicts: Dict[int, np.ndarray] = field(default_factory=dict)
    payload_bounds: Dict[int, Tuple[float, float]] = \
        field(default_factory=dict)
    build_s: float = 0.0
    device_lanes: Optional[tuple] = None

    def shape_signature(self) -> tuple:
        return (self.probe_col, self.num_slots, self.build_rows_pad,
                tuple((bid, str(self.payload_vals[bid].dtype))
                      for bid in self.build_cols))

    def to_device(self, device: torch.device) -> tuple:
        """``device_lanes`` on `device`, copied there on the first call
        (one copy per runtime, whatever the number of chunks)."""
        lanes = self.device_lanes
        if lanes is None or lanes[0].device != device:
            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)
            layout = slot_layout(torch.from_numpy(self.table_key),
                                 torch.from_numpy(self.used))
            lanes = (pack_table(t(self.used), t(self.table_key),
                                t(self.table_val), layout),
                     tuple(t(self.payload_vals[b]) for b in self.build_cols),
                     tuple(t(self.payload_nulls[b])
                           for b in self.build_cols))
            self.device_lanes = lanes
        return lanes


def _pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    if len(arr) == n:
        return arr
    out = np.zeros((n,) + arr.shape[1:], arr.dtype)
    out[:len(arr)] = arr
    return out


def make_join_runtime(wire: JoinWire,
                      probe_dicts: Dict[int, np.ndarray],
                      max_slots: Optional[int] = None,
                      device: DeviceLike = "cuda") -> JoinRuntime:
    """Resolve a JoinWire against the probe scan's dictionaries, with the
    table and payload lanes copied to `device`.

    String build keys map into the probe column's sorted dictionary
    (codes); keys absent from it can never match a probe row and keep a
    DISTINCT negative sentinel (-2 - row), so the table stays
    collision-correct and the payload gather indexes stay aligned with
    the wire's build rows.  Float64 payloads take the batch builder's
    policy for `device` (int32 when integer-valued, else the device
    float dtype).  Raises JoinIneligible with a typed reason for every
    shape the device join cannot serve."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if max_slots is None:
        from ..utils import flags
        max_slots = flags.get("join_max_build_slots")
    keys = np.asarray(wire.keys)
    n = len(keys)
    if keys.dtype == object or keys.dtype.kind in ("U", "S"):
        d = probe_dicts.get(wire.probe_col)
        if d is None:
            raise JoinIneligible(
                REASON_KEY_TYPE,
                "string build keys need a dictionary-coded probe "
                "column")
        svals = np.asarray(keys, object)
        if n and len(set(map(str, svals))) != n:
            raise JoinIneligible(REASON_DUPLICATE_KEY,
                                 "build keys are not unique")
        pos = np.searchsorted(d, svals) if len(d) else \
            np.zeros(n, np.int64)
        pos = np.clip(pos, 0, max(len(d) - 1, 0))
        hit = (np.asarray(d, object)[pos] == svals) if len(d) else \
            np.zeros(n, bool)
        keys = np.where(hit, pos, -2 - np.arange(n)).astype(np.int64)
    elif keys.dtype.kind in "iu":
        keys = keys.astype(np.int64)
    elif keys.dtype.kind == "f" and (not n or np.all(
            keys == np.rint(keys))):
        keys = keys.astype(np.int64)
    else:
        raise JoinIneligible(REASON_KEY_TYPE,
                             f"unsupported key dtype {keys.dtype}")
    num_slots = table_bucket(n, max_slots)
    used, tkey, tval = build_hash_table(keys, num_slots)
    rows_pad = max(num_slots // 2, 1)
    rt = JoinRuntime(
        probe_col=wire.probe_col, num_slots=num_slots,
        build_rows_pad=rows_pad, n_build=n,
        used=used, table_key=tkey, table_val=tval,
        keys_mapped=keys, build_cols=tuple(sorted(wire.payload)))
    from .device_batch import f64_conversion
    for bid in rt.build_cols:
        vals, nulls = wire.payload[bid]
        vals = np.asarray(vals)
        nulls = (np.asarray(nulls, bool) if nulls is not None
                 else np.zeros(n, bool))
        if vals.dtype == object or vals.dtype.kind in ("U", "S"):
            sv = np.asarray(vals, object)
            filled = np.where(nulls, "", sv)
            uniq, codes = np.unique(filled.astype(str),
                                    return_inverse=True)
            rt.payload_dicts[bid] = uniq.astype(object)
            vals = codes.astype(np.int32)
        else:
            conv = (f64_conversion([vals], dev)
                    if vals.dtype == np.float64 else None)
            if conv is not None:
                vals = vals.astype(conv)
            if n and vals.dtype.kind in "fiu":
                nz = vals[~nulls] if nulls.any() else vals
                if len(nz):
                    rt.payload_bounds[bid] = (float(nz.min()),
                                              float(nz.max()))
        rt.payload_vals[bid] = _pad_to(vals, rows_pad)
        rt.payload_nulls[bid] = _pad_to(nulls, rows_pad)
    rt.to_device(dev)
    rt.build_s = time.perf_counter() - t0
    JOIN_STATS["builds"] += 1
    LAST_JOIN_STATS.clear()
    LAST_JOIN_STATS.update({
        "n_build": n, "num_slots": num_slots,
        "build_s": round(rt.build_s, 5),
        "payload_cols": len(rt.build_cols)})
    return rt


def normalize_join(join) -> Tuple[JoinWire, ...]:
    """Canonical multi-stage form of a ReadRequest's join field: None, one
    JoinWire, or an ordered sequence of JoinWires, as a tuple of stages
    (empty for None).  The order IS the probe order: stage k may probe a
    payload column shipped by an earlier stage (a chain: lineitem ->
    orders -> customer) or another probe-table column (a star)."""
    if join is None:
        return ()
    if isinstance(join, JoinWire):
        return (join,)
    return tuple(join)


def make_join_runtimes(wires, probe_dicts: Dict[int, np.ndarray],
                       max_slots: Optional[int] = None,
                       max_stages: Optional[int] = None,
                       device: DeviceLike = "cuda"
                       ) -> Tuple[JoinRuntime, ...]:
    """Resolve an ordered multi-stage build list into JoinRuntimes on
    `device`.

    Later stages may probe an earlier stage's dict-coded payload column
    (string FKs ride as codes): the dictionary namespace ACCUMULATES stage
    by stage, so stage k's string build keys map through the payload
    dictionary a stage j < k shipped for that column.  Payload ids must be
    unique across stages; a collision or too many stages raises a typed
    JoinIneligible naming the stage."""
    wires = normalize_join(wires)
    if max_stages is None:
        from ..utils import flags
        max_stages = int(flags.get("multi_join_max_stages"))
    if len(wires) > max_stages:
        raise JoinIneligible(
            REASON_STAGE_COUNT,
            f"{len(wires)} probe stages > multi_join_max_stages="
            f"{max_stages}", stage=max_stages)
    dicts = dict(probe_dicts)
    seen_bids: set = set()
    rts = []
    for si, wire in enumerate(wires):
        overlap = seen_bids & set(wire.payload)
        if overlap:
            raise JoinIneligible(
                REASON_PROBE_SHAPE,
                f"payload id {sorted(overlap)[0]} shipped by two "
                "stages", stage=si)
        try:
            rt = make_join_runtime(wire, dicts, max_slots, device)
        except JoinIneligible as e:
            if e.stage is None:
                raise JoinIneligible(e.reason, e.detail,
                                     stage=si) from e
            raise
        rts.append(rt)
        seen_bids |= set(wire.payload)
        dicts.update(rt.payload_dicts)
    if len(rts) > 1:
        # chain-level build accounting (make_join_runtime wrote the last
        # stage's alone)
        LAST_JOIN_STATS.clear()
        LAST_JOIN_STATS.update({
            "stages": len(rts),
            "n_build": sum(rt.n_build for rt in rts),
            "num_slots": [rt.num_slots for rt in rts],
            "build_s": round(sum(rt.build_s for rt in rts), 5),
            "payload_cols": sum(len(rt.build_cols) for rt in rts)})
    return tuple(rts)


# ---------------------------------------------------------------------------
# The probe: plain version and the hand kernel
# ---------------------------------------------------------------------------

def home_slots(pk: torch.Tensor, num_slots: int) -> torch.Tensor:
    """``_home_slots`` in torch (int64): the int64 product wraps to the
    uint64 one's bits; an arithmetic shift then a mask with
    ``num_slots - 1`` keeps the top `bits` bits unsigned."""
    bits = num_slots.bit_length() - 1
    h = pk.to(torch.int64) * _HASH_MULT_I64
    return (h >> (64 - bits)) & (num_slots - 1)


def fits_narrow(table_key: torch.Tensor, used: torch.Tensor) -> bool:
    """Whether every used key of a table fits in int32 (a narrow slot)."""
    k = table_key[used]
    return not k.numel() or (int(k.min()) >= -(1 << 31)
                             and int(k.max()) < (1 << 31))


def slot_layout(table_key: torch.Tensor, used: torch.Tensor) -> int:
    """The slot width a runtime's table takes on the device: the narrow
    8-byte slot where its keys fit in int32 (the faster on the card at
    every measured stage), else the 16-byte slot."""
    return SLOT_NARROW if fits_narrow(table_key, used) else SLOT_WIDE


def pack_table(used: torch.Tensor, table_key: torch.Tensor,
               table_val: torch.Tensor,
               slot_bytes: int = SLOT_WIDE) -> torch.Tensor:
    """The device layout of a host table (used bool[S], table_key
    int64[S], table_val int32[S]): one row per slot, little-endian.

    ``SLOT_WIDE``: int64 [S, 2] = ``{int64 key; int32 val; int32 pad}``
    (the val sign-extended, so the pad is its sign).  ``SLOT_NARROW``:
    int32 [S, 2] = ``{int32 key; int32 val}``; raises ValueError if a
    used key does not fit in int32.  An empty slot has ``val = -1`` (a
    used slot's val is a build-row index >= 0) and the host's key (0).
    Plain torch on the tables' device."""
    val = torch.where(used, table_val, torch.full_like(table_val, -1))
    if slot_bytes == SLOT_WIDE:
        return torch.stack((table_key.to(torch.int64),
                            val.to(torch.int64)), 1).contiguous()
    if slot_bytes != SLOT_NARROW:
        raise ValueError(f"slot_bytes must be {SLOT_WIDE} or "
                         f"{SLOT_NARROW}, not {slot_bytes}")
    if not fits_narrow(table_key, used):
        raise ValueError("narrow slots take int32 build keys only")
    return torch.stack((table_key.to(torch.int32), val), 1).contiguous()


def _check_table(table: torch.Tensor, num_slots: int) -> None:
    if table.dim() != 2 or table.shape[1] != 2 \
            or table.dtype not in (torch.int64, torch.int32) \
            or not table.is_contiguous():
        raise ValueError("join_probe takes a packed table: contiguous "
                         "int64 or int32 [num_slots, 2] (pack_table)")
    if num_slots & (num_slots - 1) or num_slots < _MIN_TABLE_SLOTS \
            or table.shape[0] != num_slots:
        raise ValueError(f"join_probe: the table must hold num_slots "
                         f"({num_slots}, a power of 2) slots")


def probe_table(pk, table, num_slots: int):
    """Plain version of the probe (the reference's ``probe_table``) over
    the packed table: for every probe key, follow its collision chain
    until a key hit or an empty slot (``val < 0``), one whole-batch step
    at a time (``while not done.all()``, a host sync per step), each
    step one gather of whole slots.  ``num_slots`` is a power of 2; the
    builder's <= 0.5 load factor ends every walk.  A probe key compares
    as int64 against the slot's key widened to int64, so a key outside
    int32 never matches a narrow slot.  Returns match_idx int32 [N]
    (-1 = no match), the build-row gather index."""
    _check_table(table, num_slots)
    mask = num_slots - 1
    k64 = pk.to(torch.int64)
    slot = home_slots(k64, num_slots)
    midx = torch.full(k64.shape, -1, dtype=torch.int32, device=k64.device)
    done = torch.zeros(k64.shape, dtype=torch.bool, device=k64.device)
    while not bool(done.all()):
        s = table[slot]
        tk, tv = s[:, 0].to(torch.int64), s[:, 1].to(torch.int32)
        tu = tv >= 0
        hit = tu & (tk == k64) & torch.logical_not(done)
        stop = torch.logical_not(tu) & torch.logical_not(done)
        midx = torch.where(hit, tv, midx)
        done = done | hit | stop
        slot = torch.where(done, slot, (slot + 1) & mask)
    return midx


def probe_rows(pk: torch.Tensor, pk_nulls: Optional[torch.Tensor],
               mask: torch.Tensor, table: torch.Tensor, num_slots: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One probe stage of the fused plan over a packed table: ``(midx,
    mask & ~pk_nulls & matched)``.  On CPU tensors the plain version
    (:func:`probe_table`, every row walked, as the reference); on CUDA
    tensors the hand kernel csrc/join_probe.cu, which writes midx -1 for
    rows already masked out (their lanes never reach an aggregate) — or
    raises."""
    if pk.device.type == "cpu":
        if pk_nulls is not None:
            mask = mask & torch.logical_not(pk_nulls)
        midx = probe_table(pk, table, num_slots)
        return midx, mask & (midx >= 0)
    return probe_kernel(pk, pk_nulls, mask, table, num_slots)


def probe_kernel(pk, pk_nulls, mask, table, num_slots: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hand probe kernel on CUDA tensors: (midx int32, mask bool).
    Probe lanes that are not 16-byte aligned (views at a storage offset)
    take the kernel's scalar loads; a misaligned table raises."""
    n = pk.shape[0]
    if pk.dtype not in (torch.int32, torch.int64):
        pk = pk.to(torch.int64)
    dev = pk.device
    _check_table(table, num_slots)
    lanes = [pk, mask] + ([pk_nulls] if pk_nulls is not None else [])
    if table.device != dev or any(
            t.device != dev or t.dim() != 1 or not t.is_contiguous()
            for t in lanes):
        raise ValueError("join_probe takes contiguous [N] lanes on one "
                         "device")
    if mask.dtype != torch.bool \
            or (pk_nulls is not None and pk_nulls.dtype != torch.bool):
        raise ValueError("join_probe takes bool masks and null flags")
    if mask.shape[0] != n or (pk_nulls is not None
                              and pk_nulls.shape[0] != n):
        raise ValueError("join_probe: probe lanes differ in length")
    if table.data_ptr() % 16:
        raise ValueError("join_probe: the packed table must be 16-byte "
                         "aligned")
    vec = all(t.data_ptr() % 16 == 0 for t in lanes)
    midx = torch.empty(n, dtype=torch.int32, device=dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    lib = _lib("join_probe")
    LAUNCHES["join_probe"] += 1
    _raise_on(lib.join_probe_launch(
        pk.data_ptr(), pk.element_size(),
        pk_nulls.data_ptr() if pk_nulls is not None else None,
        mask.data_ptr(), table.data_ptr(), 2 * table.element_size(),
        num_slots.bit_length() - 1, n, int(vec),
        midx.data_ptr(), out.data_ptr(), _stream()),
        "join_probe")
    return midx, out


# ---------------------------------------------------------------------------
# Numpy twin of the probe — the plan twin's join step
# ---------------------------------------------------------------------------

def hash_join_cpu(probe_keys: np.ndarray, build_keys: np.ndarray
                  ) -> np.ndarray:
    """match_idx int32 per probe key (-1 dangling), equal to the device
    probe's answer for unique build keys (HOW the match is found cannot
    change WHICH unique key matches)."""
    n_b = len(build_keys)
    if n_b == 0:
        return np.full(len(probe_keys), -1, np.int32)
    order = np.argsort(build_keys, kind="stable")
    skeys = build_keys[order]
    pos = np.searchsorted(skeys, probe_keys)
    pos_c = np.clip(pos, 0, n_b - 1)
    hit = skeys[pos_c] == probe_keys
    return np.where(hit, order[pos_c], -1).astype(np.int32)
