"""Column and table schemas, and packed rows: a whole row as one KV
value, columnar-decode friendly.

Counterpart of ``yugabyte_db_tpu/dockv/packed_row.py`` (reference:
src/yb/dockv/packed_row.h RowPackerV1/V2, src/yb/dockv/schema_packing.h:77
SchemaPacking), byte for byte:

    [varint schema_version]
    [null bitmap  ceil(n/8) bytes]
    [fixed region: one always-present slot per fixed-width column]
    [varlen offsets: u32 LE *end* offset per varlen column]
    [varlen heap]

Everything before the heap has a fixed per-schema stride, so decoding N
rows is: stack prefixes into an [N, stride] uint8 matrix and reinterpret
column slices (storage/columnar.py ``from_packed_entries``).  The packer
is the Python one; the reference's native packer writes the same bytes.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .key_encoding import _decode_varint_unsigned, _encode_varint_unsigned
from .value import PrimitiveValue, ValueKind


class ColumnType:
    BOOL = "bool"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    TIMESTAMP = "timestamp"   # int64 micros
    STRING = "string"
    BINARY = "binary"
    JSON = "json"
    DECIMAL = "decimal"       # stored as string for now
    VECTOR = "vector"         # float32 array (pgvector analog)

    FIXED_WIDTHS = {
        BOOL: 1, INT32: 4, INT64: 8, FLOAT32: 4, FLOAT64: 8, TIMESTAMP: 8,
    }
    NUMPY_DTYPES = {
        BOOL: np.uint8, INT32: np.dtype("<i4"), INT64: np.dtype("<i8"),
        FLOAT32: np.dtype("<f4"), FLOAT64: np.dtype("<f8"),
        TIMESTAMP: np.dtype("<i8"),
    }

    @staticmethod
    def is_fixed(t: str) -> bool:
        return t in ColumnType.FIXED_WIDTHS


_PACK_FMT = {
    ColumnType.BOOL: "<B", ColumnType.INT32: "<i", ColumnType.INT64: "<q",
    ColumnType.FLOAT32: "<f", ColumnType.FLOAT64: "<d",
    ColumnType.TIMESTAMP: "<q",
}


@dataclass(frozen=True)
class ColumnSchema:
    id: int                   # stable column id (never reused)
    name: str
    type: str
    nullable: bool = True
    is_hash_key: bool = False
    is_range_key: bool = False
    sort_desc: bool = False   # range column sort order
    # original query-layer type when richer than the storage type —
    # e.g. a CQL collection ("list<text>") stored as JSON. Persisted in
    # the catalog so wire servers recover element typing after restart
    # (reference: QLTypePB params in common/ql_type.proto)
    ql_type: "str | None" = None
    # serial/bigserial: the owned sequence feeding this column's
    # INSERT default (reference: PG pg_attrdef nextval defaults)
    default_seq: "str | None" = None
    # literal DEFAULT applied when INSERT omits the column
    # (reference: PG pg_attrdef)
    default_value: object = None

    @property
    def is_key(self) -> bool:
        return self.is_hash_key or self.is_range_key


@dataclass(frozen=True)
class TableSchema:
    """Table schema (reference: src/yb/common/schema.h). Column order:
    hash key columns, then range key columns, then value columns."""

    columns: Tuple[ColumnSchema, ...]
    version: int = 0

    def __post_init__(self):
        ids = [c.id for c in self.columns]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate column ids")

    @property
    def key_columns(self) -> List[ColumnSchema]:
        return [c for c in self.columns if c.is_key]

    @property
    def hash_columns(self) -> List[ColumnSchema]:
        return [c for c in self.columns if c.is_hash_key]

    @property
    def range_columns(self) -> List[ColumnSchema]:
        return [c for c in self.columns if c.is_range_key]

    @property
    def value_columns(self) -> List[ColumnSchema]:
        return [c for c in self.columns if not c.is_key]

    def column_by_name(self, name: str) -> ColumnSchema:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    def column_by_id(self, cid: int) -> ColumnSchema:
        for c in self.columns:
            if c.id == cid:
                return c
        raise KeyError(cid)


@dataclass
class SchemaPacking:
    """Layout of the packed form of one schema version's value columns
    (reference: dockv/schema_packing.h:77)."""

    schema_version: int
    fixed_columns: List[ColumnSchema] = field(default_factory=list)
    varlen_columns: List[ColumnSchema] = field(default_factory=list)
    # derived:
    fixed_offsets: Dict[int, int] = field(default_factory=dict)  # col id -> offset
    fixed_size: int = 0
    bitmap_size: int = 0
    prefix_size: int = 0      # varint(header) excluded; bitmap+fixed+offsets

    @classmethod
    def from_schema(cls, schema: TableSchema) -> "SchemaPacking":
        sp = cls(schema_version=schema.version)
        for c in schema.value_columns:
            (sp.fixed_columns if ColumnType.is_fixed(c.type)
             else sp.varlen_columns).append(c)
        off = 0
        for c in sp.fixed_columns:
            sp.fixed_offsets[c.id] = off
            off += ColumnType.FIXED_WIDTHS[c.type]
        sp.fixed_size = off
        n = len(sp.fixed_columns) + len(sp.varlen_columns)
        sp.bitmap_size = (n + 7) // 8
        sp.prefix_size = sp.bitmap_size + sp.fixed_size + 4 * len(sp.varlen_columns)
        return sp

    @property
    def all_columns(self) -> List[ColumnSchema]:
        return self.fixed_columns + self.varlen_columns

    def null_bit_index(self, cid: int) -> int:
        for i, c in enumerate(self.all_columns):
            if c.id == cid:
                return i
        raise KeyError(cid)


class RowPacker:
    """Packs value columns into a single packed-row value (reference:
    dockv/packed_row.h:285,311 RowPackerV1/V2); invalid values fail
    loudly (struct.error)."""

    def __init__(self, packing: SchemaPacking):
        self.packing = packing
        self._header = _encode_varint_unsigned(packing.schema_version)

    def pack(self, values: Dict[int, object]) -> bytes:
        """values: column id -> python value (None for NULL)."""
        p = self.packing
        bitmap = bytearray(p.bitmap_size)
        fixed = bytearray(p.fixed_size)
        offsets = bytearray()
        heap = bytearray()
        for i, c in enumerate(p.all_columns):
            v = values.get(c.id)
            if v is None:
                bitmap[i // 8] |= 1 << (i % 8)
        for c in p.fixed_columns:
            v = values.get(c.id)
            off = p.fixed_offsets[c.id]
            w = ColumnType.FIXED_WIDTHS[c.type]
            if v is not None:
                if c.type == ColumnType.BOOL:
                    v = int(bool(v))
                struct.pack_into(_PACK_FMT[c.type], fixed, off, v)
        for c in p.varlen_columns:
            v = values.get(c.id)
            if v is not None:
                raw = v.encode() if isinstance(v, str) else bytes(v)
                heap += raw
            offsets += struct.pack("<I", len(heap))
        return bytes(self._header + bitmap + fixed + offsets + heap)

    def pack_value(self, values: Dict[int, object]) -> bytes:
        """Full KV value: kPackedRowV2 marker + packed bytes."""
        return bytes([ValueKind.kPackedRowV2]) + self.pack(values)


def unpack_row(packing: SchemaPacking, data: bytes,
               start: int = 0) -> Dict[int, object]:
    """Row-at-a-time unpack (CPU path). The columnar batch decode lives in
    storage/columnar.py and ops/."""
    p = packing
    ver, pos = _decode_varint_unsigned(data, start)
    if ver != p.schema_version:
        raise ValueError(f"schema version mismatch: {ver} != {p.schema_version}")
    bitmap = data[pos:pos + p.bitmap_size]
    pos += p.bitmap_size
    fixed = data[pos:pos + p.fixed_size]
    pos += p.fixed_size
    nvar = len(p.varlen_columns)
    ends = struct.unpack_from(f"<{nvar}I", data, pos) if nvar else ()
    pos += 4 * nvar
    heap = data[pos:]
    out: Dict[int, object] = {}
    for i, c in enumerate(p.all_columns):
        if bitmap[i // 8] & (1 << (i % 8)):
            out[c.id] = None
            continue
        if ColumnType.is_fixed(c.type):
            v = struct.unpack_from(_PACK_FMT[c.type], fixed,
                                   p.fixed_offsets[c.id])[0]
            if c.type == ColumnType.BOOL:
                v = bool(v)
            out[c.id] = v
        else:
            vi = i - len(p.fixed_columns)
            lo = ends[vi - 1] if vi else 0
            raw = bytes(heap[lo:ends[vi]])
            out[c.id] = raw.decode() if c.type in (
                ColumnType.STRING, ColumnType.JSON, ColumnType.DECIMAL) else raw
    return out


class SchemaPackingStorage:
    """schema_version -> SchemaPacking registry, kept per table
    (reference: dockv/schema_packing.h SchemaPackingStorage). Old versions
    are retained until compaction repacks all rows to the latest."""

    def __init__(self):
        self._packings: Dict[int, SchemaPacking] = {}

    def add_schema(self, schema: TableSchema) -> SchemaPacking:
        sp = SchemaPacking.from_schema(schema)
        self._packings[schema.version] = sp
        return sp

    def get(self, version: int) -> SchemaPacking:
        return self._packings[version]

    def version_of(self, packed: bytes, start: int = 0) -> int:
        ver, _ = _decode_varint_unsigned(packed, start)
        return ver

    def versions(self) -> List[int]:
        return sorted(self._packings)
