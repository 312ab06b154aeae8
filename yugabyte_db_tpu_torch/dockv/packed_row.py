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
runs in the host extension (csrc/host_hot.c ``Packer``) for the common
column types, in Python for the rest; both write the same bytes.
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
    dockv/packed_row.h:285,311 RowPackerV1/V2).  The packing runs in the
    host extension's ``Packer`` (csrc/host_hot.c) when every column type
    is in its set and the null bitmap fits its 64-byte scratch; a schema
    with another type (json, decimal, vector: pre-encoded values with
    looser typing) or more than 512 columns packs in Python
    (:meth:`pack_plain`), as in the reference.  Both write the same
    bytes; invalid values fail loudly on both, with the reference's
    error classes (TypeError / OverflowError in C, struct.error in
    Python)."""

    _NATIVE_FIXED = {ColumnType.BOOL: "?", ColumnType.INT32: "i",
                     ColumnType.INT64: "q", ColumnType.TIMESTAMP: "q",
                     ColumnType.FLOAT32: "f", ColumnType.FLOAT64: "d"}
    _NATIVE_VARLEN = {ColumnType.STRING: 1, ColumnType.BINARY: 2}

    def __init__(self, packing: SchemaPacking):
        self.packing = packing
        self._header = _encode_varint_unsigned(packing.schema_version)
        self._native = False            # built on the first pack

    def _native_packer(self):
        """The extension's Packer for this packing, or None when the
        schema's shape keeps the Python packer."""
        if self._native is False:
            p = self.packing
            plan = []
            for c in p.all_columns:
                if c.type in self._NATIVE_FIXED:
                    plan.append((c.id, 0, self._NATIVE_FIXED[c.type],
                                 p.fixed_offsets[c.id]))
                elif c.type in self._NATIVE_VARLEN:
                    plan.append((c.id, self._NATIVE_VARLEN[c.type], "s", 0))
                else:
                    plan = None
                    break
            if plan is None or p.bitmap_size > 64:
                self._native = None
            else:
                from ..storage.columnar import native_hot
                self._native = native_hot().Packer(
                    bytes(self._header), plan, p.bitmap_size,
                    p.fixed_size, len(p.varlen_columns))
        return self._native

    def pack(self, values: Dict[int, object]) -> bytes:
        """values: column id -> python value (None for NULL)."""
        nat = self._native_packer()
        if nat is not None:
            return nat.pack(values)
        return self.pack_plain(values)

    def pack_plain(self, values: Dict[int, object]) -> bytes:
        """:meth:`pack` in Python."""
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


def repack_values(old: SchemaPacking, new: SchemaPacking,
                  values: Sequence[bytes]) -> Optional[List[bytes]]:
    """Full KV values (the kPackedRowV2 marker, then a row packed under
    `old`) re-encoded under `new`, all at once in numpy: byte for byte
    what ``RowPacker(new).pack_value(unpack_row(old, v, 1))`` writes for
    each (the compaction's repack after an ALTER TABLE).  None when the
    two packings need that per-row route: a kept column whose type
    changed, a kept FLOAT32 column (its round trip through a Python
    float decides NaN bits), or old varlen columns that do not lead the
    new ones in order (a dropped or moved string)."""
    old_idx = {c.id: i for i, c in enumerate(old.all_columns)}
    old_cols = {c.id: c for c in old.all_columns}
    nvar_old = len(old.varlen_columns)
    if [c.id for c in new.varlen_columns[:nvar_old]] != \
            [c.id for c in old.varlen_columns]:
        return None
    for c in new.all_columns:
        oc = old_cols.get(c.id)
        if oc is not None and (oc.type != c.type
                               or c.type == ColumnType.FLOAT32):
            return None
    n = len(values)
    if not n:
        return []
    ohdr = len(_encode_varint_unsigned(old.schema_version))
    plen = 1 + ohdr + old.prefix_size          # marker, version, prefix
    body = np.frombuffer(b"".join([v[1 + ohdr:plen] for v in values]),
                         np.uint8).reshape(n, old.prefix_size)
    bitmap = body[:, :old.bitmap_size]

    def old_null(cid):
        i = old_idx[cid]
        return ((bitmap[:, i // 8] >> (i % 8)) & 1).astype(bool)

    header = _encode_varint_unsigned(new.schema_version)
    npre = 1 + len(header) + new.prefix_size
    pre = np.zeros((n, npre), np.uint8)
    pre[:, 0] = ValueKind.kPackedRowV2
    pre[:, 1:1 + len(header)] = np.frombuffer(header, np.uint8)
    nbody = pre[:, 1 + len(header):]
    for j, c in enumerate(new.all_columns):
        null = old_null(c.id) if c.id in old_idx else np.ones(n, bool)
        nbody[:, j // 8] |= (null.astype(np.uint8) << (j % 8))
        if not ColumnType.is_fixed(c.type) or c.id not in old_idx:
            continue
        w = ColumnType.FIXED_WIDTHS[c.type]
        at = old.bitmap_size + old.fixed_offsets[c.id]
        vals = body[:, at:at + w]
        if c.type == ColumnType.BOOL:
            vals = (vals != 0).astype(np.uint8)
        to = new.bitmap_size + new.fixed_offsets[c.id]
        nbody[:, to:to + w] = np.where(null[:, None], 0, vals)
    at = old.bitmap_size + old.fixed_size
    ends = np.ascontiguousarray(body[:, at:at + 4 * nvar_old]).view(
        "<u4").reshape(n, nvar_old)
    new_ends = np.empty((n, len(new.varlen_columns)), "<u4")
    new_ends[:, :nvar_old] = ends
    # the added varlen columns are NULL: they end where the heap ends
    new_ends[:, nvar_old:] = ends[:, -1:] if nvar_old else 0
    to = new.bitmap_size + new.fixed_size
    nbody[:, to:] = new_ends.view(np.uint8).reshape(n, -1)
    # heaps move unchanged: the old varlen columns lead in order and the
    # added ones hold no bytes
    raw = pre.tobytes()
    return [raw[i * npre:(i + 1) * npre] + v[plen:]
            for i, v in enumerate(values)]


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
