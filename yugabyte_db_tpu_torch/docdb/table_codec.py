"""Per-table codec: user column arrays -> sorted columnar blocks.

Counterpart of ``yugabyte_db_tpu/docdb/table_codec.py`` cut to
``TableInfo`` and the vectorized bulk load
(``TableCodec.bulk_blocks``/``bulk_blocks_iter``).  Where the reference
gathers through its native library (``native_lib.gather_columns``) this
port gathers with numpy; the blocks are the same lane for lane.  Scalar
row encode/decode, packed rows and varlen columns stay in ROADMAP.md."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..dockv import bulk
from ..dockv.key_encoding import ValueType
from ..dockv.packed_row import ColumnType, TableSchema
from ..dockv.partition import PartitionSchema
from ..storage.columnar import ColumnarBlock, fnv64_rows
from ..utils.hybrid_time import HybridTime


@dataclass
class TableInfo:
    """Table metadata as known by tablets."""

    table_id: str
    name: str
    schema: TableSchema
    partition_schema: PartitionSchema
    cotable_id: Optional[int] = None


_BULK_ENC = {
    ColumnType.INT32: bulk.encode_int32_column,
    ColumnType.INT64: bulk.encode_int64_column,
    ColumnType.FLOAT64: bulk.encode_double_column,
    ColumnType.TIMESTAMP: lambda v, desc=False: bulk._retype(
        bulk.encode_int64_column(v, desc),
        ValueType.kTimestampDesc if desc else ValueType.kTimestamp),
}


class TableCodec:
    def __init__(self, info: TableInfo):
        if info.cotable_id is not None:
            raise NotImplementedError(
                "colocated tables are not ported (ROADMAP.md queue 1: "
                "storage/LSM and SQL tier copies)")
        self.info = info
        self.schema = info.schema
        self._pk_cols = self.schema.key_columns

    def bulk_blocks(self, columns: Dict[str, np.ndarray],
                    ht: HybridTime, block_rows: int = 65536,
                    partition=None) -> List[ColumnarBlock]:
        """Materialized form of :meth:`bulk_blocks_iter`."""
        return list(self.bulk_blocks_iter(columns, ht,
                                          block_rows=block_rows,
                                          partition=partition))

    def bulk_blocks_iter(self, columns: Dict[str, np.ndarray],
                         ht: HybridTime, block_rows: int = 65536,
                         partition=None):
        """Turn user column arrays into sorted columnar-only blocks,
        yielded one at a time.

        Every PK component must be fixed-width numeric and every value
        column fixed-width.  partition: optional dockv.partition.Partition
        — rows outside it are dropped."""
        for c in self.schema.columns:
            if not ColumnType.is_fixed(c.type):
                raise NotImplementedError(
                    f"varlen column {c.name!r} is not ported (ROADMAP.md "
                    f"queue 1: storage/LSM copy)")
        n = len(next(iter(columns.values())))
        ps = self.info.partition_schema
        pk_blocks = [_BULK_ENC[c.type](np.asarray(columns[c.name]),
                                       c.sort_desc)
                     for c in self._pk_cols]
        if ps.kind == "hash":
            nh = ps.num_hash_columns
            hash_input = (pk_blocks[0] if nh == 1
                          else np.concatenate(pk_blocks[:nh], axis=1))
            hashes = bulk.fast_hash16_from_encoded(hash_input)
            doc_keys = bulk.encode_doc_keys(hashes, pk_blocks, nh)
            part_keys = hashes.astype(">u2").view(np.uint8).reshape(-1, 2)
        else:
            doc_keys = bulk.encode_doc_keys(None, pk_blocks, 0)
            part_keys = doc_keys
        keep = np.ones(n, bool)
        if partition is not None:
            if partition.start:
                lo = np.frombuffer(partition.start.ljust(
                    part_keys.shape[1], b"\x00"), np.uint8)
                keep &= _rows_ge(part_keys, lo)
            if partition.end:
                hi = np.frombuffer(partition.end.ljust(
                    part_keys.shape[1], b"\x00"), np.uint8)
                keep &= ~_rows_ge(part_keys, hi)
        identity = bool(keep.all())
        if identity:
            idx = np.arange(n, dtype=np.int64)
        else:
            idx = np.nonzero(keep)[0]
            doc_keys = doc_keys[idx]
            if ps.kind == "hash":
                hashes = hashes[idx]
        if not len(idx):
            return
        full = bulk.append_hybrid_times(
            doc_keys,
            np.full(len(idx), ht.value, np.uint64),
            np.arange(len(idx), dtype=np.uint32))
        comps = [(np.asarray(columns[c.name])[idx]
                  if not identity else np.asarray(columns[c.name]),
                  c.type, c.sort_desc) for c in self._pk_cols]
        order = np.ascontiguousarray(
            bulk.bulk_sort_order(hashes if ps.kind == "hash" else None,
                                 comps, doc_keys), np.int64)
        # row hashes over the UNSORTED doc keys; each block gathers the
        # u64 lane through the permutation
        key_hash_all = fnv64_rows(doc_keys)
        arrs = {c.id: np.asarray(columns[c.name])
                for c in self.schema.columns}
        dk_w = doc_keys.shape[1]
        prev_last_dk = None
        for s in range(0, len(order), block_rows):
            ord_b = order[s:s + block_rows]
            bn = len(ord_b)
            sel = ord_b if identity else idx[ord_b]
            keys_b = full[ord_b]
            fixed, pk = {}, {}
            for c in self.schema.columns:
                out = arrs[c.id][sel]
                if c.is_key:
                    pk[c.id] = out
                else:
                    fixed[c.id] = (out, np.zeros(bn, bool))
            # unique keys: adjacent-distinct doc keys inside the block,
            # plus the boundary row against the previous block
            dk_b = keys_b[:, :dk_w]
            uniq = bool((dk_b[1:] != dk_b[:-1]).any(axis=1).all()) \
                if bn > 1 else True
            if prev_last_dk is not None and \
                    prev_last_dk == dk_b[0].tobytes():
                uniq = False
            prev_last_dk = dk_b[-1].tobytes()
            yield ColumnarBlock.from_arrays(
                schema_version=self.schema.version,
                key_hash=key_hash_all[ord_b],
                ht=np.full(bn, ht.value, np.uint64),
                write_id=ord_b.astype(np.uint32),
                pk=pk, fixed=fixed, keys=keys_b, unique_keys=uniq)


def _rows_ge(mat: np.ndarray, bound: np.ndarray) -> np.ndarray:
    """Row-wise lexicographic mat[i] >= bound (byte-column sweep)."""
    n, w = mat.shape
    result = np.zeros(n, bool)
    decided = np.zeros(n, bool)
    for j in range(w):
        gt = ~decided & (mat[:, j] > bound[j])
        lt = ~decided & (mat[:, j] < bound[j])
        result |= gt
        decided |= gt | lt
    return result | ~decided   # fully-equal rows are >=
