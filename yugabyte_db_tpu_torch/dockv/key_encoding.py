"""Order-preserving doc key encoding.

Counterpart of ``yugabyte_db_tpu/dockv/key_encoding.py``, byte for byte:
a doc key is

    [hash prefix: type byte + 16-bit hash] [hashed components...] GroupEnd
    [range components...] GroupEnd

and a SubDocKey appends subkeys plus a DESCENDING-encoded DocHybridTime
so that newer versions of the same document sort first (reference
design: src/yb/dockv/doc_key.h:40-60,95, src/yb/dockv/key_bytes.h).
Every component carries a leading type byte chosen so that raw ``memcmp``
of encoded keys equals typed comparison of the decoded tuples — the one
invariant the whole LSM depends on.  The vectorized bulk encoders
(bulk.py) write the same bytes."""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

from ..utils.hybrid_time import DocHybridTime, ENCODED_SIZE


class ValueType:
    """Type bytes for key components, ordered so encodings sort
    correctly (analog of reference dockv::KeyEntryType)."""
    # Structure markers sort BELOW all value types so that a prefix key
    # (fewer components) sorts before any extension of it — same property
    # as the reference's kGroupEnd='!' sitting below its letter-valued
    # types (src/yb/dockv/value_type.h).
    kLowest = 0x01
    kGroupEnd = 0x03
    kHybridTime = 0x05
    kUInt16Hash = 0x08   # 2-byte big-endian hash prefix (key start only)
    kCoTableId = 0x0A    # 4-byte BE colocated-table id (key start only)
    # value types
    kNull = 0x20
    kFalse = 0x22
    kTrue = 0x23
    kInt32 = 0x24
    kInt64 = 0x26
    kDouble = 0x28
    kString = 0x2A
    kTimestamp = 0x2C
    kBytes = 0x2E
    kUuid = 0x32
    # descending variants (= kX + 0x20): payload bytes complemented
    kInt32Desc = 0x44
    kInt64Desc = 0x46
    kDoubleDesc = 0x48
    kStringDesc = 0x4A
    kTimestampDesc = 0x4C
    kBytesDesc = 0x4E
    kNullDesc = 0x5E
    kColumnId = 0x6B
    kSystemColumnId = 0x6C
    kIntentPrefix = 0x70  # intents-db key space marker
    kTransactionId = 0x71
    kHighest = 0x7F

_DESC_OFFSET = 0x20  # kXDesc = kX + 0x20 for orderable types


def _encode_int_key(v: int, width: int) -> bytes:
    """Sign-flipped big-endian: memcmp order == numeric order."""
    bias = 1 << (width * 8 - 1)
    return (v + bias).to_bytes(width, "big")


def _decode_int_key(data: bytes, width: int) -> int:
    bias = 1 << (width * 8 - 1)
    return int.from_bytes(data[:width], "big") - bias


def _encode_double_key(v: float) -> bytes:
    bits = struct.unpack(">Q", struct.pack(">d", v))[0]
    if bits & (1 << 63):
        bits ^= (1 << 64) - 1      # negative: flip all bits
    else:
        bits |= 1 << 63            # positive: flip sign bit
    return bits.to_bytes(8, "big")


def _decode_double_key(data: bytes) -> float:
    bits = int.from_bytes(data[:8], "big")
    if bits & (1 << 63):
        bits &= (1 << 63) - 1
    else:
        bits ^= (1 << 64) - 1
    return struct.unpack(">d", struct.pack(">Q", bits))[0]


def _escape_zeros(data: bytes) -> bytes:
    """'\\x00' -> '\\x00\\x01'; terminator '\\x00\\x00' sorts before any
    continuation, making prefix-freedom hold (reference scheme:
    src/yb/dockv/key_bytes.h AppendString)."""
    return data.replace(b"\x00", b"\x00\x01") + b"\x00\x00"


def _unescape_zeros(data: bytes) -> Tuple[bytes, int]:
    out = bytearray()
    i = 0
    while i < len(data):
        b = data[i]
        if b == 0:
            nxt = data[i + 1]
            if nxt == 0:
                return bytes(out), i + 2
            if nxt == 1:
                out.append(0)
                i += 2
                continue
            raise ValueError("bad zero escape in key")
        out.append(b)
        i += 1
    raise ValueError("unterminated string in key")


def _complement(data: bytes) -> bytes:
    return bytes(b ^ 0xFF for b in data)


@dataclass(frozen=True)
class KeyEntryValue:
    """One typed key component. kind is 'null'|'bool'|'int32'|'int64'|
    'double'|'string'|'bytes'|'timestamp'|'column_id'; desc flips sort order.
    """
    kind: str
    value: object = None
    desc: bool = False

    # convenience constructors
    @staticmethod
    def null(desc: bool = False): return KeyEntryValue("null", None, desc)
    @staticmethod
    def int32(v: int, desc: bool = False): return KeyEntryValue("int32", v, desc)
    @staticmethod
    def int64(v: int, desc: bool = False): return KeyEntryValue("int64", v, desc)
    @staticmethod
    def double(v: float, desc: bool = False): return KeyEntryValue("double", v, desc)
    @staticmethod
    def string(v: str, desc: bool = False): return KeyEntryValue("string", v, desc)
    @staticmethod
    def raw_bytes(v: bytes, desc: bool = False): return KeyEntryValue("bytes", v, desc)
    @staticmethod
    def bool_(v: bool): return KeyEntryValue("bool", v)
    @staticmethod
    def timestamp(micros: int, desc: bool = False):
        return KeyEntryValue("timestamp", micros, desc)
    @staticmethod
    def column_id(cid: int): return KeyEntryValue("column_id", cid)


def encode_key_entry(e: KeyEntryValue) -> bytes:
    d = e.desc
    if e.kind == "null":
        return bytes([ValueType.kNullDesc if d else ValueType.kNull])
    if e.kind == "bool":
        return bytes([ValueType.kTrue if e.value else ValueType.kFalse])
    if e.kind == "int32":
        p = _encode_int_key(e.value, 4)
        return bytes([ValueType.kInt32Desc if d else ValueType.kInt32]) + (
            _complement(p) if d else p)
    if e.kind == "int64":
        p = _encode_int_key(e.value, 8)
        return bytes([ValueType.kInt64Desc if d else ValueType.kInt64]) + (
            _complement(p) if d else p)
    if e.kind == "double":
        p = _encode_double_key(e.value)
        return bytes([ValueType.kDoubleDesc if d else ValueType.kDouble]) + (
            _complement(p) if d else p)
    if e.kind == "timestamp":
        p = _encode_int_key(e.value, 8)
        return bytes([ValueType.kTimestampDesc if d else ValueType.kTimestamp]) + (
            _complement(p) if d else p)
    if e.kind in ("string", "bytes"):
        raw = e.value.encode() if e.kind == "string" else e.value
        p = _escape_zeros(raw)
        t = ValueType.kString if e.kind == "string" else ValueType.kBytes
        if d:
            return bytes([t + _DESC_OFFSET]) + _complement(p)
        return bytes([t]) + p
    if e.kind == "column_id":
        return bytes([ValueType.kColumnId]) + _encode_varint_unsigned(e.value)
    raise ValueError(f"unknown key entry kind {e.kind}")


def decode_key_entry(data: bytes, pos: int) -> Tuple[KeyEntryValue, int]:
    t = data[pos]
    pos += 1
    V = ValueType
    if t == V.kNull:
        return KeyEntryValue.null(), pos
    if t == V.kNullDesc:
        return KeyEntryValue.null(desc=True), pos
    if t == V.kFalse:
        return KeyEntryValue.bool_(False), pos
    if t == V.kTrue:
        return KeyEntryValue.bool_(True), pos
    if t in (V.kInt32, V.kInt32Desc):
        desc = t == V.kInt32Desc
        raw = data[pos:pos + 4]
        if desc:
            raw = _complement(raw)
        return KeyEntryValue.int32(_decode_int_key(raw, 4), desc), pos + 4
    if t in (V.kInt64, V.kInt64Desc, V.kTimestamp, V.kTimestampDesc):
        desc = t in (V.kInt64Desc, V.kTimestampDesc)
        raw = data[pos:pos + 8]
        if desc:
            raw = _complement(raw)
        v = _decode_int_key(raw, 8)
        if t in (V.kTimestamp, V.kTimestampDesc):
            return KeyEntryValue.timestamp(v, desc), pos + 8
        return KeyEntryValue.int64(v, desc), pos + 8
    if t in (V.kDouble, V.kDoubleDesc):
        desc = t == V.kDoubleDesc
        raw = data[pos:pos + 8]
        if desc:
            raw = _complement(raw)
        return KeyEntryValue.double(_decode_double_key(raw), desc), pos + 8
    if t in (V.kString, V.kBytes):
        raw, consumed = _unescape_zeros(data[pos:])
        kind = "string" if t == V.kString else "bytes"
        v = raw.decode() if kind == "string" else raw
        return KeyEntryValue(kind, v), pos + consumed
    if t in (V.kString + _DESC_OFFSET, V.kBytes + _DESC_OFFSET):
        # find complemented terminator 0xFF 0xFF with escapes 0xFF 0xFE
        sub = data[pos:]
        comp = _complement(sub)  # cheap: keys are short
        raw, consumed = _unescape_zeros(comp)
        kind = "string" if t == V.kString + _DESC_OFFSET else "bytes"
        v = raw.decode() if kind == "string" else raw
        return KeyEntryValue(kind, v, desc=True), pos + consumed
    if t == V.kColumnId:
        v, pos = _decode_varint_unsigned(data, pos)
        return KeyEntryValue.column_id(v), pos
    raise ValueError(f"unknown key entry type byte {t:#x} at {pos - 1}")


def _encode_varint_unsigned(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _decode_varint_unsigned(data: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    v = 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


class KeyBytes:
    """Mutable encoded-key builder (reference: src/yb/dockv/key_bytes.h)."""

    def __init__(self, data: bytes = b""):
        self._buf = bytearray(data)

    def append_entry(self, e: KeyEntryValue) -> "KeyBytes":
        self._buf += encode_key_entry(e)
        return self

    def append_group_end(self) -> "KeyBytes":
        self._buf.append(ValueType.kGroupEnd)
        return self

    def append_hash(self, h: int) -> "KeyBytes":
        self._buf.append(ValueType.kUInt16Hash)
        self._buf += h.to_bytes(2, "big")
        return self

    def append_hybrid_time(self, dht: DocHybridTime) -> "KeyBytes":
        self._buf.append(ValueType.kHybridTime)
        self._buf += dht.encoded_desc()
        return self

    def append_raw(self, data: bytes) -> "KeyBytes":
        self._buf += data
        return self

    def data(self) -> bytes:
        return bytes(self._buf)

    def __len__(self):
        return len(self._buf)


@dataclass(frozen=True)
class DocKey:
    """Primary-key portion of a row key (reference: dockv/doc_key.h:95;
    colocated tables carry a cotable prefix, doc_key.h:40-60)."""

    hash: Optional[int] = None                 # 16-bit partition hash
    hashed: Tuple[KeyEntryValue, ...] = ()
    range: Tuple[KeyEntryValue, ...] = ()
    cotable_id: Optional[int] = None           # colocated table id

    @classmethod
    def make(cls, hash: Optional[int] = None,
             hashed: Iterable[KeyEntryValue] = (),
             range: Iterable[KeyEntryValue] = (),
             cotable_id: Optional[int] = None) -> "DocKey":
        return cls(hash, tuple(hashed), tuple(range), cotable_id)

    def encode(self) -> bytes:
        kb = KeyBytes()
        if self.cotable_id is not None:
            kb.append_raw(bytes([ValueType.kCoTableId])
                          + self.cotable_id.to_bytes(4, "big"))
        if self.hash is not None:
            kb.append_hash(self.hash)
            for e in self.hashed:
                kb.append_entry(e)
            kb.append_group_end()
        for e in self.range:
            kb.append_entry(e)
        kb.append_group_end()
        return kb.data()

    @classmethod
    def decode(cls, data: bytes, pos: int = 0) -> Tuple["DocKey", int]:
        hash_ = None
        hashed: List[KeyEntryValue] = []
        range_: List[KeyEntryValue] = []
        cotable = None
        if pos < len(data) and data[pos] == ValueType.kCoTableId:
            cotable = int.from_bytes(data[pos + 1:pos + 5], "big")
            pos += 5
        if pos < len(data) and data[pos] == ValueType.kUInt16Hash:
            hash_ = int.from_bytes(data[pos + 1:pos + 3], "big")
            pos += 3
            while data[pos] != ValueType.kGroupEnd:
                e, pos = decode_key_entry(data, pos)
                hashed.append(e)
            pos += 1
        while pos < len(data) and data[pos] != ValueType.kGroupEnd:
            e, pos = decode_key_entry(data, pos)
            range_.append(e)
        if pos >= len(data) or data[pos] != ValueType.kGroupEnd:
            raise ValueError("doc key missing range group end")
        return cls(hash_, tuple(hashed), tuple(range_), cotable), pos + 1


@dataclass(frozen=True)
class SubDocKey:
    """DocKey + subkeys (e.g. a column id) + DocHybridTime.

    Reference: src/yb/dockv/doc_key.h SubDocKey. The encoded form is what
    actually lands in the LSM: `doc_key subkeys kHybridTime ht_desc`.
    """

    doc_key: DocKey
    subkeys: Tuple[KeyEntryValue, ...] = ()
    doc_ht: Optional[DocHybridTime] = None

    def encode(self, include_ht: bool = True) -> bytes:
        kb = KeyBytes(self.doc_key.encode())
        for s in self.subkeys:
            kb.append_entry(s)
        if include_ht and self.doc_ht is not None:
            kb.append_hybrid_time(self.doc_ht)
        return kb.data()

    @classmethod
    def decode(cls, data: bytes) -> "SubDocKey":
        dk, pos = DocKey.decode(data)
        subkeys: List[KeyEntryValue] = []
        dht = None
        while pos < len(data):
            if data[pos] == ValueType.kHybridTime:
                dht = DocHybridTime.decode_desc(data[pos + 1:pos + 1 + ENCODED_SIZE])
                pos += 1 + ENCODED_SIZE
                break
            e, pos = decode_key_entry(data, pos)
            subkeys.append(e)
        return cls(dk, tuple(subkeys), dht)


def split_key_ht(encoded: bytes) -> Tuple[bytes, DocHybridTime]:
    """Split an encoded SubDocKey into (key prefix without HT, DocHybridTime).

    The HT suffix has fixed size, so this is O(1) — the hot path for MVCC
    visibility checks and compaction GC.
    """
    marker_pos = len(encoded) - ENCODED_SIZE - 1
    if marker_pos < 0 or encoded[marker_pos] != ValueType.kHybridTime:
        raise ValueError("key has no hybrid time suffix")
    return encoded[:marker_pos], DocHybridTime.decode_desc(encoded[marker_pos + 1:])
