"""Value-side encoding of KV pairs.

Counterpart of ``yugabyte_db_tpu/dockv/value.py`` (analog of the
reference's PrimitiveValue, src/yb/dockv/primitive_value.cc, minus the
key half, which lives in key_encoding.py): the value type bytes, the TTL
envelope (``wrap_ttl``/``unwrap_ttl``: a kMergeFlags marker and the
little-endian u64 expiry hybrid time ahead of the value) and
``PrimitiveValue``.  Values need no order preservation, so encodings are
compact little-endian; the bytes are the reference's."""
from __future__ import annotations

import struct
from dataclasses import dataclass


class ValueKind:
    kNull = 0x00
    kFalse = 0x01
    kTrue = 0x02
    kInt32 = 0x03
    kInt64 = 0x04
    kDouble = 0x05
    kFloat = 0x06
    kString = 0x07
    kBytes = 0x08
    kTimestamp = 0x09
    kDecimal = 0x0A
    kJson = 0x0B
    kTombstone = 0x10        # row/cell deletion marker
    kPackedRowV1 = 0x20      # row-as-single-KV, nested-values format
    kPackedRowV2 = 0x21      # row-as-single-KV, columnar-friendly format
    kMergeFlags = 0x30       # TTL etc. prefix
    kRowLock = 0x31          # lock-only intent value


TTL_HDR_LEN = 9   # kMergeFlags marker + u64 expire hybrid time


def wrap_ttl(value: bytes, expire_ht: int) -> bytes:
    """Prefix a KV value with an expiration hybrid time (reference: TTL
    merge flags in dockv value encoding)."""
    return bytes([ValueKind.kMergeFlags]) + struct.pack("<Q", expire_ht) + value


def unwrap_ttl(value: bytes):
    """Returns (inner_value, expire_ht or None)."""
    if value and value[0] == ValueKind.kMergeFlags:
        (exp,) = struct.unpack_from("<Q", value, 1)
        return value[TTL_HDR_LEN:], exp
    return value, None


@dataclass(frozen=True)
class PrimitiveValue:
    kind: int
    value: object = None

    @staticmethod
    def null(): return PrimitiveValue(ValueKind.kNull)
    @staticmethod
    def tombstone(): return PrimitiveValue(ValueKind.kTombstone)
    @staticmethod
    def int32(v): return PrimitiveValue(ValueKind.kInt32, int(v))
    @staticmethod
    def int64(v): return PrimitiveValue(ValueKind.kInt64, int(v))
    @staticmethod
    def double(v): return PrimitiveValue(ValueKind.kDouble, float(v))
    @staticmethod
    def string(v): return PrimitiveValue(ValueKind.kString, str(v))
    @staticmethod
    def raw_bytes(v): return PrimitiveValue(ValueKind.kBytes, bytes(v))
    @staticmethod
    def bool_(v): return PrimitiveValue(ValueKind.kTrue if v else ValueKind.kFalse)
    @staticmethod
    def timestamp(us): return PrimitiveValue(ValueKind.kTimestamp, int(us))

    def is_tombstone(self) -> bool:
        return self.kind == ValueKind.kTombstone

    def to_python(self):
        if self.kind == ValueKind.kTrue:
            return True
        if self.kind == ValueKind.kFalse:
            return False
        if self.kind in (ValueKind.kNull, ValueKind.kTombstone):
            return None
        return self.value

    def encode(self) -> bytes:
        k = self.kind
        if k in (ValueKind.kNull, ValueKind.kTombstone, ValueKind.kTrue,
                 ValueKind.kFalse, ValueKind.kRowLock):
            return bytes([k])
        if k == ValueKind.kInt32:
            return bytes([k]) + struct.pack("<i", self.value)
        if k in (ValueKind.kInt64, ValueKind.kTimestamp):
            return bytes([k]) + struct.pack("<q", self.value)
        if k == ValueKind.kDouble:
            return bytes([k]) + struct.pack("<d", self.value)
        if k == ValueKind.kFloat:
            return bytes([k]) + struct.pack("<f", self.value)
        if k == ValueKind.kString:
            return bytes([k]) + self.value.encode()
        if k in (ValueKind.kBytes, ValueKind.kJson,
                 ValueKind.kPackedRowV1, ValueKind.kPackedRowV2):
            return bytes([k]) + self.value
        raise ValueError(f"cannot encode value kind {k:#x}")

    @classmethod
    def decode(cls, data: bytes) -> "PrimitiveValue":
        k = data[0]
        body = data[1:]
        if k in (ValueKind.kNull, ValueKind.kTombstone, ValueKind.kTrue,
                 ValueKind.kFalse, ValueKind.kRowLock):
            return cls(k)
        if k == ValueKind.kInt32:
            return cls(k, struct.unpack("<i", body[:4])[0])
        if k in (ValueKind.kInt64, ValueKind.kTimestamp):
            return cls(k, struct.unpack("<q", body[:8])[0])
        if k == ValueKind.kDouble:
            return cls(k, struct.unpack("<d", body[:8])[0])
        if k == ValueKind.kFloat:
            return cls(k, struct.unpack("<f", body[:4])[0])
        if k == ValueKind.kString:
            return cls(k, body.decode())
        if k in (ValueKind.kBytes, ValueKind.kJson,
                 ValueKind.kPackedRowV1, ValueKind.kPackedRowV2):
            return cls(k, bytes(body))
        raise ValueError(f"cannot decode value kind {k:#x}")
