"""Column and table schemas.

Counterpart of ``yugabyte_db_tpu/dockv/packed_row.py`` cut to
``ColumnType``, ``ColumnSchema`` and ``TableSchema`` — the row packer
and its byte format are not on the ported bulk-load path."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


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
    DECIMAL = "decimal"
    VECTOR = "vector"

    FIXED_WIDTHS = {
        BOOL: 1, INT32: 4, INT64: 8, FLOAT32: 4, FLOAT64: 8, TIMESTAMP: 8,
    }

    @staticmethod
    def is_fixed(t: str) -> bool:
        return t in ColumnType.FIXED_WIDTHS


@dataclass(frozen=True)
class ColumnSchema:
    id: int                   # stable column id (never reused)
    name: str
    type: str
    nullable: bool = True
    is_hash_key: bool = False
    is_range_key: bool = False
    sort_desc: bool = False   # range column sort order

    @property
    def is_key(self) -> bool:
        return self.is_hash_key or self.is_range_key


@dataclass(frozen=True)
class TableSchema:
    """Column order: hash key columns, then range key columns, then
    value columns."""

    columns: Tuple[ColumnSchema, ...]
    version: int = 0

    def __post_init__(self):
        ids = [c.id for c in self.columns]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate column ids")

    @property
    def key_columns(self) -> List[ColumnSchema]:
        return [c for c in self.columns if c.is_key]
