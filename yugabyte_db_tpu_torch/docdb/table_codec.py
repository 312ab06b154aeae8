"""Per-table codec: rows <-> doc KV entries <-> columnar blocks.

Counterpart of ``yugabyte_db_tpu/docdb/table_codec.py`` (the layer the
reference spreads across dockv's PgTableRow materialization,
src/yb/dockv/pg_row.cc, DocRowwiseIterator decode and the packed-row
build, src/yb/dockv/packed_row.h): ``TableInfo`` with its schema
packings; the scalar row paths (``encode_write``/``encode_delete`` of
one packed KV per row, doc keys and prefixes, ``decode_row`` and the
single-row ``decode_block_row``); the ColumnarBlock builder plugged into
SST flush (``columnar_builder``) and the ``row_decoder`` that rebuilds
KV entries from columnar-only blocks; the vectorized bulk load
(``bulk_blocks``/``bulk_blocks_iter`` and ``bulk_ingest``, the body of
the reference's ``Tablet.bulk_load``) and ``derive_keys`` (the v2
keyless-block contract, bound as the SST key builder).  Doc-key
prefixes and single-row decodes run in the host extension
(csrc/host_hot.c ``encode_doc_key`` and ``Extractor``) where the
reference's do, with their Python versions beside them
(``doc_key_prefix_plain``, ``decode_block_row_plain``).  Where the
reference gathers through its native library the bulk load gathers
with numpy; the bytes and rows are the same.  A colocated table
(``cotable_id``) prefixes its doc keys and bounds its scans with its
cotable id."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..dockv import bulk
from ..dockv.key_encoding import (DocKey, KeyBytes, KeyEntryValue,
                                  SubDocKey, ValueType)
from ..dockv.packed_row import (ColumnType, RowPacker, SchemaPacking,
                                SchemaPackingStorage, TableSchema,
                                unpack_row)
from ..dockv.partition import PartitionSchema, hash_key_for
from ..dockv.value import PrimitiveValue, ValueKind
from ..storage import native_lib
from ..storage.columnar import (DERIVED_COL_BASE, ColumnarBlock,
                                fnv64_rows, native_hot)
from ..storage.pipeline import StreamPipeline
from ..utils.hybrid_time import ENCODED_SIZE, DocHybridTime, HybridTime

_HT_SUFFIX = ENCODED_SIZE + 1


@dataclass
class TableInfo:
    """Table metadata as known by tablets, with the schema packings rows
    are packed under."""

    table_id: str
    name: str
    schema: TableSchema
    partition_schema: PartitionSchema
    packings: SchemaPackingStorage = field(
        default_factory=SchemaPackingStorage)
    cotable_id: Optional[int] = None    # set for colocated tables
    # prior schema versions (the ALTER history): rows packed under them
    # keep decoding in a tablet opened, restored or cloned from disk
    schema_history: Tuple[TableSchema, ...] = ()

    def __post_init__(self):
        for old in self.schema_history:
            if old.version not in self.packings.versions():
                self.packings.add_schema(old)
        if self.schema.version not in self.packings.versions():
            self.packings.add_schema(self.schema)

    @property
    def packing(self) -> SchemaPacking:
        return self.packings.get(self.schema.version)


_KEV_MAKER = {
    ColumnType.INT32: KeyEntryValue.int32,
    ColumnType.INT64: KeyEntryValue.int64,
    ColumnType.FLOAT64: KeyEntryValue.double,
    ColumnType.STRING: KeyEntryValue.string,
    ColumnType.TIMESTAMP: KeyEntryValue.timestamp,
    ColumnType.BINARY: KeyEntryValue.raw_bytes,
}


#: pk column types the extension's encode_doc_key takes, by its kind code
_KEY_KIND = {ColumnType.INT64: 0, ColumnType.INT32: 1,
             ColumnType.FLOAT64: 2, ColumnType.STRING: 3,
             ColumnType.TIMESTAMP: 4, ColumnType.BINARY: 5}


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
        self.info = info
        self.schema = info.schema
        self.packer = RowPacker(info.packing)
        self._pk_cols = self.schema.key_columns
        # single-row decode plan, computed once per codec
        self._pk_ids = tuple(c.id for c in self._pk_cols)
        self._val_plan = tuple(
            (c.name, c.id,
             c.type == ColumnType.BOOL,
             c.type in (ColumnType.STRING, ColumnType.JSON,
                        ColumnType.DECIMAL))
            for c in self.schema.value_columns)
        # JSON value columns: candidates for document shredding, threaded
        # as `shred_cols` through LsmStore / SstWriter (docstore/shred.py)
        self.shred_cols = tuple(
            c.id for c in self.schema.value_columns
            if c.type == ColumnType.JSON)
        # the extension's DocKey-prefix encoder spec: (cotable id or -1,
        # hash column count, kind per pk column, desc flag per pk
        # column); None for a pk with a type the encoder does not take
        self._key_spec = None
        if all(c.type in _KEY_KIND for c in self._pk_cols):
            ps = info.partition_schema
            self._key_spec = (
                -1 if info.cotable_id is None else info.cotable_id,
                ps.num_hash_columns if ps.kind == "hash" else 0,
                bytes(_KEY_KIND[c.type] for c in self._pk_cols),
                bytes(1 if c.sort_desc else 0 for c in self._pk_cols))

    # --- scalar paths -----------------------------------------------------
    def pk_entries(self, row: Dict[str, object]) -> List[KeyEntryValue]:
        out = []
        nh = self.info.partition_schema.num_hash_columns
        for i, c in enumerate(self._pk_cols):
            v = row[c.name]
            if v is None and i >= nh:
                # NULL range components encode as kNull (PG indexes
                # rows with NULL key parts; hash components still
                # require a value — they route the tablet)
                e = KeyEntryValue.null(desc=c.sort_desc)
                out.append(e)
                continue
            maker = _KEV_MAKER[c.type]
            e = maker(v)
            if c.sort_desc:
                e = KeyEntryValue(e.kind, e.value, desc=True)
            out.append(e)
        return out

    def doc_key(self, row: Dict[str, object]) -> DocKey:
        dk = self.info.partition_schema.doc_key_for_row(self.pk_entries(row))
        if self.info.cotable_id is not None:
            dk = DocKey(dk.hash, dk.hashed, dk.range, self.info.cotable_id)
        return dk

    def encode_write(self, row: Dict[str, object], dht: DocHybridTime
                     ) -> Tuple[bytes, bytes]:
        """Full-row upsert as one packed KV (packed-row V2 path)."""
        key = SubDocKey(self.doc_key(row), (), dht).encode()
        values = {c.id: row.get(c.name) for c in self.schema.value_columns}
        return key, self.packer.pack_value(values)

    def encode_delete(self, pk_row: Dict[str, object], dht: DocHybridTime
                      ) -> Tuple[bytes, bytes]:
        key = SubDocKey(self.doc_key(pk_row), (), dht).encode()
        return key, PrimitiveValue.tombstone().encode()

    def doc_key_prefix(self, pk_row: Dict[str, object]) -> bytes:
        """The encoded DocKey (no hybrid time) of a row's primary key,
        through the extension's ``encode_doc_key``.  A pk shape without
        a key spec, and a value the encoder does not take (a NULL range
        component, a value of another type), take the Python encoder,
        which encodes it or raises: the reference's route by input."""
        if self._key_spec is not None:
            try:
                return native_hot().encode_doc_key(
                    self._key_spec,
                    tuple(pk_row[c.name] for c in self._pk_cols))
            except (TypeError, OverflowError, ValueError):
                pass
        return self.doc_key_prefix_plain(pk_row)

    def doc_key_prefix_plain(self, pk_row: Dict[str, object]) -> bytes:
        """:meth:`doc_key_prefix` through the Python key encoder."""
        return self.doc_key(pk_row).encode()

    def scan_prefix(self) -> bytes:
        """Key-space prefix owned by this table within its tablet —
        empty for dedicated tablets, the cotable prefix for colocated
        tables (bounds every scan)."""
        if self.info.cotable_id is None:
            return b""
        return bytes([ValueType.kCoTableId]) + \
            self.info.cotable_id.to_bytes(4, "big")

    def hash_prefix(self, row: Dict[str, object]) -> bytes:
        """Encoded prefix covering the hash components plus any
        CONTIGUOUS leading range components present in `row` — used for
        prefix scans (secondary-index lookups by indexed value; a
        composite index narrows by every provided column, not just the
        hashed first one)."""
        ps = self.info.partition_schema
        entries = []
        for c in self._pk_cols[:ps.num_hash_columns]:
            maker = _KEV_MAKER[c.type]
            entries.append(maker(row[c.name]))
        kb = KeyBytes(self.scan_prefix())
        kb.append_hash(hash_key_for(entries))
        for e in entries:
            kb.append_entry(e)
        range_cols = [c for c in self._pk_cols[ps.num_hash_columns:]]
        provided = []
        for c in range_cols:
            if c.name not in row or row[c.name] is None:
                break       # prefix must stay contiguous in pk order
            provided.append(c)
        if provided:
            # the hash group closes with kGroupEnd before range
            # components (DocKey layout) — without it the prefix can
            # never match a stored key
            kb.append_group_end()
            for c in provided:
                kb.append_entry(_KEV_MAKER[c.type](row[c.name]))
        return kb.data()

    def decode_row(self, key: bytes, value: bytes) -> Optional[Dict[str, object]]:
        """KV entry -> {col name: value} (None for a tombstone)."""
        if value[0] == ValueKind.kTombstone:
            return None
        sdk = SubDocKey.decode(key)
        out: Dict[str, object] = {}
        entries = list(sdk.doc_key.hashed) + list(sdk.doc_key.range)
        for c, e in zip(self._pk_cols, entries):
            out[c.name] = e.value
        if value[0] != ValueKind.kPackedRowV2:
            raise ValueError("row values must be packed (V2) or tombstones")
        ver = self.info.packings.version_of(value, 1)
        packing = self.info.packings.get(ver)
        unpacked = unpack_row(packing, value, 1)
        for c in self.schema.value_columns:
            if c.id in unpacked:
                out[c.name] = unpacked[c.id]
            else:
                out[c.name] = None   # column added after this row's version
        return out

    _DTYPE_CHAR = {("i", 8): "q", ("i", 4): "i", ("i", 2): "h",
                   ("i", 1): "b", ("u", 8): "Q", ("u", 4): "I",
                   ("f", 8): "d", ("f", 4): "f", ("b", 1): "?"}

    def _native_extractor(self, cb: ColumnarBlock):
        """The extension's row Extractor for this codec over block `cb`
        (csrc/host_hot.c; reference: dockv/pg_row.cc runs this loop in
        C++ too), built once and cached on the block by codec object (an
        ALTER makes a new codec).  None when the block's shape keeps the
        Python decode: a pk column without its lane, or a lane dtype the
        extractor has no code for (a BOOL column stored as uint8)."""
        cache = getattr(cb, "_extractors", None)
        if cache is None:
            cache = {}
            object.__setattr__(cb, "_extractors", cache)
        ext = cache.get(self, False)
        if ext is not False:
            return ext
        plan = self._extractor_plan(cb)
        ext = None if plan is None else native_hot().Extractor(plan, cb.n)
        cache[self] = ext
        return ext

    def _extractor_plan(self, cb: ColumnarBlock):
        """The Extractor's column plan over `cb` (the reference's), or
        None when the block's shape keeps the Python decode."""
        if not all(cid in cb.pk for cid in self._pk_ids):
            return None
        plan = []
        for c in self._pk_cols:
            arr = np.ascontiguousarray(cb.pk[c.id])
            ch = self._DTYPE_CHAR.get((arr.dtype.kind, arr.dtype.itemsize))
            if ch is None:
                return None
            plan.append((c.name, 3, ch, arr, None, None))
        for name, cid, _is_bool, is_str in self._val_plan:
            f = cb.fixed.get(cid)
            if f is not None:
                vals = np.ascontiguousarray(f[0])
                nulls = np.ascontiguousarray(f[1])
                ch = self._DTYPE_CHAR.get((vals.dtype.kind,
                                           vals.dtype.itemsize))
                if ch is None:
                    return None
                plan.append((name, 0, ch, vals, nulls, None))
                continue
            vl = cb.varlen.get(cid)
            if vl is not None:
                ends = np.ascontiguousarray(
                    vl[0].astype(np.uint32, copy=False))
                nulls = np.ascontiguousarray(vl[2])
                plan.append((name, 1 if is_str else 2, "q", ends, nulls,
                             vl[1]))
            else:
                plan.append((name, 4, "q", None, None, None))
        return plan

    def decode_block_row(self, cb: ColumnarBlock, pos: int, key: bytes,
                         want=None) -> Optional[Dict[str, object]]:
        """Single-row decode straight from a columnar block's arrays:
        exactly what decode_row() yields for the same row, without the
        pack/unpack round trip (the point-read path; reference analog:
        PgTableRow materialization from a packed row, dockv/pg_row.cc).
        The whole row comes from the extension's Extractor where the
        block's shape takes one; `want` (column names) limits the value
        columns decoded, in Python (:meth:`decode_block_row_plain`)."""
        if cb.tombstone[pos]:
            return None
        if want is None:
            ext = self._native_extractor(cb)
            if ext is not None:
                return ext.extract(pos)
        return self.decode_block_row_plain(cb, pos, key, want)

    def decode_block_row_plain(self, cb: ColumnarBlock, pos: int,
                               key: bytes, want=None
                               ) -> Optional[Dict[str, object]]:
        """:meth:`decode_block_row` in Python."""
        if cb.tombstone[pos]:
            return None
        out: Dict[str, object] = {}
        pk = cb.pk
        if all(cid in pk for cid in self._pk_ids):
            for c in self._pk_cols:
                out[c.name] = pk[c.id][pos].item()
        else:
            sdk = SubDocKey.decode(key)
            entries = list(sdk.doc_key.hashed) + list(sdk.doc_key.range)
            for c, e in zip(self._pk_cols, entries):
                out[c.name] = e.value
        fixed, varlen = cb.fixed, cb.varlen
        plan = self._val_plan if want is None else \
            [p for p in self._val_plan if p[0] in want]
        for name, cid, is_bool, is_str in plan:
            f = fixed.get(cid)
            if f is not None:
                vals, nulls = f
                if nulls[pos]:
                    out[name] = None
                else:
                    v = vals[pos].item()
                    out[name] = bool(v) if is_bool else v
                continue
            vl = varlen.get(cid)
            if vl is not None:
                ends, heap, nulls = vl
                if nulls[pos]:
                    out[name] = None
                else:
                    lo = int(ends[pos - 1]) if pos else 0
                    raw = bytes(heap[lo:int(ends[pos])])
                    out[name] = raw.decode() if is_str else raw
            else:
                out[name] = None   # column added after this version
        return out

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

        Every PK component must be fixed-width numeric; every other
        value column is a varlen lane of raw bytes on one heap: a ``str``
        as UTF-8, anything else as ``bytes(x)`` (a row of a 2-D float32
        array gives its vector's bytes).  partition: optional
        dockv.partition.Partition — rows outside it are dropped."""
        for c in self._pk_cols:
            if not ColumnType.is_fixed(c.type):
                # the reference's bulk key encoders (_BULK_ENC) are
                # fixed-width only as well
                raise NotImplementedError(
                    f"a bulk load keyed by the {c.type} column {c.name!r} "
                    f"is not ported (ROADMAP.md queue 1 item 9: "
                    f"storage/LSM copy)")
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
            fixed, varlen, pk = {}, {}, {}
            for c in self.schema.columns:
                out = arrs[c.id][sel]
                if c.is_key:
                    pk[c.id] = out
                elif ColumnType.is_fixed(c.type):
                    fixed[c.id] = (out, np.zeros(bn, bool))
                else:
                    raws = [x.encode() if isinstance(x, str) else bytes(x)
                            for x in out]
                    ends = np.cumsum([len(r) for r in raws]).astype(
                        np.uint32)
                    varlen[c.id] = (ends, b"".join(raws),
                                    np.zeros(bn, bool))
            # unique keys: adjacent-distinct doc keys inside the block,
            # plus the boundary row against the previous block
            dk_b = keys_b[:, :dk_w]
            uniq = bool((dk_b[1:] != dk_b[:-1]).any(axis=1).all()) \
                if bn > 1 else True
            if prev_last_dk is not None and \
                    prev_last_dk == dk_b[0].tobytes():
                uniq = False
            prev_last_dk = dk_b[-1].tobytes()
            blk = ColumnarBlock.from_arrays(
                schema_version=self.schema.version,
                key_hash=key_hash_all[ord_b],
                ht=np.full(bn, ht.value, np.uint64),
                write_id=ord_b.astype(np.uint32),
                pk=pk, fixed=fixed, varlen=varlen, keys=keys_b,
                unique_keys=uniq)
            # keys were built by the very pipeline derive_keys replays,
            # so derivability is proven without a write-time verify
            blk.keys_proven = self.info.cotable_id is None
            yield blk

    def bulk_ingest(self, store, columns: Dict[str, np.ndarray],
                    ht: HybridTime, block_rows: int = 65536,
                    partition=None) -> int:
        """Bulk-load column arrays into `store` as one new SST (the body
        of the reference's ``Tablet.bulk_load``): the blocks stream
        through a one-stage pipeline whose worker serializes and writes
        block k while this thread gathers block k+1.  Returns the rows
        written (0, and no SST, when the partition drops every row)."""
        blocks = self.bulk_blocks_iter(columns, ht, block_rows=block_rows,
                                       partition=partition)
        try:
            first = next(blocks)
        except StopIteration:
            return 0
        n = 0

        def build(w):
            nonlocal n
            pipe = StreamPipeline(
                [lambda blk: (w.add_columnar_block(blk), blk.n)[1]],
                depth=2, name="bulk-load")
            for bn in pipe.run(itertools.chain([first], blocks)):
                n += bn
        store.ingest_sst(build, stream=True)
        return n

    # --- columnar builder / row decoder (plugged into LsmStore) -----------
    def columnar_builder(self, entries: Sequence[Tuple[bytes, bytes]]
                         ) -> Optional[ColumnarBlock]:
        """Build a columnar sidecar from one SST block's KV entries; None
        when the block isn't packable (a TTL'd value, mixed schema
        versions, a value that is neither a packed row nor a tombstone,
        a key without the hybrid-time suffix).  Keys of one width take
        the vectorized path (:meth:`_columnar_uniform`); the decision
        and the block are the same either way."""
        try:
            got = self._columnar_uniform(entries)
            if got is not NotImplemented:
                return got
            n = len(entries)
            keys_noht, hts, wids = [], np.empty(n, np.uint64), np.empty(n, np.uint32)
            values = []
            ver: Optional[int] = None
            for i, (k, v) in enumerate(entries):
                if k[-_HT_SUFFIX] != ValueType.kHybridTime:
                    return None
                dht = DocHybridTime.decode_desc(k[-ENCODED_SIZE:])
                hts[i] = dht.ht.value
                wids[i] = dht.write_id
                keys_noht.append(k[:-_HT_SUFFIX])
                if v[0] == ValueKind.kMergeFlags:
                    # TTL'd rows stay on the row path (CPU TTL checks);
                    # the block simply doesn't get a columnar sidecar
                    return None
                if v[0] == ValueKind.kPackedRowV2:
                    v_ver = self.info.packings.version_of(v, 1)
                    if ver is None:
                        ver = v_ver
                    elif ver != v_ver:
                        return None
                elif v[0] != ValueKind.kTombstone:
                    return None
                values.append(v)
            if ver is None:
                ver = self.schema.version
            packing = self.info.packings.get(ver)
            blk = ColumnarBlock.from_packed_entries(
                packing, keys_noht, hts, wids, values)
            # decode fixed-width PK components for device-side key predicates
            self._attach_pk_columns(blk, keys_noht)
            # a block may contain several versions of a key
            blk.unique_keys = len(set(keys_noht)) == n
            # keep full keys for columnar-only reconstruction & merges
            lens = {len(k) for k in keys_noht}
            if len(lens) == 1:
                w = lens.pop() + _HT_SUFFIX
                km = np.frombuffer(
                    b"".join(entries[i][0] for i in range(n)),
                    np.uint8).reshape(n, w)
                blk.keys = km.copy()
            return blk
        except Exception:
            return None

    def _columnar_uniform(self, entries: Sequence[Tuple[bytes, bytes]]):
        """:meth:`columnar_builder` for keys of one width, in numpy
        passes over the key matrix; NotImplemented for the shapes the
        entry-at-a-time loop decides (several key widths, keys too short
        for the suffix, multi-byte schema versions)."""
        n = len(entries)
        keys = [k for k, _ in entries]
        values = [v for _, v in entries]
        widths = set(map(len, keys))
        if n == 0 or len(widths) != 1:
            return NotImplemented
        w = widths.pop()
        if w <= _HT_SUFFIX:
            return NotImplemented
        km = np.frombuffer(b"".join(keys), np.uint8).reshape(n, w)
        if not (km[:, w - _HT_SUFFIX] == ValueType.kHybridTime).all():
            return None
        first = np.frombuffer(bytes(v[0] for v in values), np.uint8)
        if (first == ValueKind.kMergeFlags).any():
            return None         # TTL'd rows stay on the row path
        packed = first == ValueKind.kPackedRowV2
        if not (packed | (first == ValueKind.kTombstone)).all():
            return None
        if packed.any():
            vbytes = np.frombuffer(bytes(values[i][1] for i in
                                         np.flatnonzero(packed).tolist()),
                                   np.uint8)
            if (vbytes >= 0x80).any():
                return NotImplemented
            if (vbytes != vbytes[0]).any():
                return None     # mixed schema versions
            ver = int(vbytes[0])
        else:
            ver = self.schema.version
        packing = self.info.packings.get(ver)
        suffix = np.ascontiguousarray(km[:, w - ENCODED_SIZE:])
        hts = ~suffix[:, :8].view(">u8").reshape(-1).astype(np.uint64)
        wids = ~suffix[:, 8:].view(">u4").reshape(-1).astype(np.uint32)
        dk = np.ascontiguousarray(km[:, :w - _HT_SUFFIX])
        blk = ColumnarBlock.from_packed_entries(packing, dk, hts, wids,
                                                values)
        pk = self._pk_columns_uniform(dk)
        if pk is None:
            self._attach_pk_columns(
                blk, [k[:-_HT_SUFFIX] for k in keys])
        else:
            blk.pk.update(pk)
        # a block may hold several versions of a key
        dv = dk.view(np.dtype((np.void, dk.shape[1]))).reshape(-1)
        blk.unique_keys = len(np.unique(dv)) == n
        blk.keys = km.copy()
        return blk

    def _pk_columns_uniform(self, dk: np.ndarray
                            ) -> Optional[Dict[int, np.ndarray]]:
        """The fixed-width pk columns decoded from an [N, L] matrix of
        doc keys, or None unless every row has the one layout the schema
        gives (fixed-width components only, each with its expected type
        byte): then the values equal DocKey.decode's, row for row."""
        V = ValueType
        layout = {ColumnType.INT32: (V.kInt32, V.kInt32Desc, 4),
                  ColumnType.INT64: (V.kInt64, V.kInt64Desc, 8),
                  ColumnType.TIMESTAMP: (V.kTimestamp, V.kTimestampDesc,
                                         8),
                  ColumnType.FLOAT64: (V.kDouble, V.kDoubleDesc, 8)}
        ps = self.info.partition_schema
        n, width = dk.shape
        nh = ps.num_hash_columns if ps.kind == "hash" else 0
        checks = []             # (position, expected byte)
        spans = []              # (column, offset, payload width, desc)
        pos = 0
        if nh:
            checks.append((0, V.kUInt16Hash))
            pos = 3
        for i, c in enumerate(self._pk_cols):
            if c.type not in layout:
                return None
            asc, desc_t, pw = layout[c.type]
            checks.append((pos, desc_t if c.sort_desc else asc))
            spans.append((c, pos + 1, pw, c.sort_desc))
            pos += 1 + pw
            if nh and i == nh - 1:
                checks.append((pos, V.kGroupEnd))
                pos += 1
        checks.append((pos, V.kGroupEnd))
        if pos + 1 != width:
            return None
        for at, byte in checks:
            if not (dk[:, at] == byte).all():
                return None
        out = {}
        for c, off, pw, desc in spans:
            raw = np.ascontiguousarray(dk[:, off:off + pw])
            if desc:
                raw = ~raw
            u = raw.view(">u8" if pw == 8 else ">u4").reshape(-1).astype(
                np.uint64 if pw == 8 else np.uint32)
            if c.type == ColumnType.FLOAT64:
                sign = np.uint64(1 << 63)
                bits = np.where(u & sign, u & ~sign, ~u)
                out[c.id] = bits.astype(np.uint64).view("<f8")
            elif pw == 8:
                out[c.id] = (u ^ np.uint64(1 << 63)).view("<i8")
            else:
                out[c.id] = (u ^ np.uint32(1 << 31)).view("<i4")
        return out

    def _attach_pk_columns(self, blk: ColumnarBlock,
                           keys_noht: Sequence[bytes]) -> None:
        cols: Dict[int, list] = {c.id: [] for c in self._pk_cols
                                 if ColumnType.is_fixed(c.type)
                                 or c.type in (ColumnType.INT32,
                                               ColumnType.INT64,
                                               ColumnType.FLOAT64)}
        if not cols:
            return
        try:
            for k in keys_noht:
                dk, _ = DocKey.decode(k)
                entries = list(dk.hashed) + list(dk.range)
                for c, e in zip(self._pk_cols, entries):
                    if c.id in cols:
                        cols[c.id].append(e.value)
            for c in self._pk_cols:
                if c.id in cols:
                    dt = ColumnType.NUMPY_DTYPES.get(c.type, np.float64)
                    blk.pk[c.id] = np.asarray(cols[c.id], dt)
        except Exception:
            pass

    def row_decoder(self, blk: ColumnarBlock) -> List[Tuple[bytes, bytes]]:
        """Reconstruct KV entries from a columnar-only block (CPU merges
        and point reads over bulk-loaded SSTs): each row's key from the
        keys matrix and its value packed as ``RowPacker.pack_value``
        packs it.  The whole block packs in numpy passes
        (:func:`_pack_block_values`); shapes that pass does not take
        (or that the row-at-a-time packer would refuse) go row by row."""
        if blk.keys is None:   # property: rebuilds v2 keyless blocks
            raise ValueError(
                "columnar-only block has no keys matrix and no bound "
                "key_builder — a v2 keyless block must be read through "
                "its table codec")
        packing = self.info.packings.get(blk.schema_version)
        vals = _pack_block_values(packing, blk, self.schema)
        if vals is None:
            return self._row_decoder_rows(blk, packing)
        keys = np.ascontiguousarray(blk.keys)
        w = keys.shape[1]
        kb = keys.tobytes()
        return [(kb[i * w:(i + 1) * w], v) for i, v in enumerate(vals)]

    def _row_decoder_rows(self, blk: ColumnarBlock,
                          packing: SchemaPacking
                          ) -> List[Tuple[bytes, bytes]]:
        """:meth:`row_decoder` one row at a time through RowPacker."""
        packer = RowPacker(packing)
        # derived lanes (shredded doc paths, join build columns) are
        # scan-lifetime acceleration structures, not row data:
        # reconstruction reads schema columns only
        out = []
        for i in range(blk.n):
            key = blk.keys[i].tobytes()
            if blk.tombstone[i]:
                out.append((key, PrimitiveValue.tombstone().encode()))
                continue
            values: Dict[int, object] = {}
            for cid, (vals, nulls) in blk.fixed.items():
                if cid >= DERIVED_COL_BASE:
                    continue
                values[cid] = None if nulls[i] else vals[i].item()
            for cid, (ends, heap, nulls) in blk.varlen.items():
                if cid >= DERIVED_COL_BASE:
                    continue
                if nulls[i]:
                    values[cid] = None
                else:
                    lo = int(ends[i - 1]) if i else 0
                    raw = heap[lo:int(ends[i])]
                    c = self.schema.column_by_id(cid)
                    values[cid] = (raw.decode()
                                   if c.type in (ColumnType.STRING,
                                                 ColumnType.JSON,
                                                 ColumnType.DECIMAL)
                                   else raw)
            out.append((key, packer.pack_value(values)))
        return out

    # --- v2 keyless blocks: key matrix derivation -------------------------
    def derive_keys(self, cb: ColumnarBlock) -> Optional[np.ndarray]:
        """Rebuild a block's full encoded SubDocKey matrix from its pk
        columns + ht/write_id lanes — THE v2 keyless-block contract.

        Writers call this to VERIFY that a block's keys matrix is
        byte-derivable before dropping it from the serialized form;
        readers call the same function (bound as the SST key_builder) to
        rebuild it lazily, so write-time verification proves read-time
        exactness.  None when the pk shape is underivable (unsupported
        component types, missing pk arrays, cotable prefixes)."""
        if self.info.cotable_id is not None:
            return None
        ps = self.info.partition_schema
        pk_blocks = []
        for c in self._pk_cols:
            enc = _BULK_ENC.get(c.type)
            arr = cb.pk.get(c.id)
            if enc is None or arr is None or len(arr) != cb.n:
                return None
            try:
                pk_blocks.append(enc(np.asarray(arr), c.sort_desc))
            except (TypeError, ValueError):
                return None
        if not pk_blocks:
            return None
        n = cb.n
        hashes = None
        nh = 0
        if ps.kind == "hash":
            nh = ps.num_hash_columns
            hash_input = (pk_blocks[0] if nh == 1
                          else np.concatenate(pk_blocks[:nh], axis=1))
            hashes = bulk.fast_hash16_from_encoded(hash_input)
        # one preallocated fill; byte layout identical to the bulk
        # pipeline (encode_doc_keys + append_hybrid_times)
        width = (sum(b.shape[1] for b in pk_blocks) + 1
                 + (4 if hashes is not None else 0) + 13)
        out = np.empty((n, width), np.uint8)
        pos = 0
        if hashes is not None:
            out[:, 0] = ValueType.kUInt16Hash
            out[:, 1:3] = hashes.astype(">u2").view(np.uint8).reshape(-1, 2)
            pos = 3
            for b in pk_blocks[:nh]:
                out[:, pos:pos + b.shape[1]] = b
                pos += b.shape[1]
            out[:, pos] = ValueType.kGroupEnd
            pos += 1
        for b in pk_blocks[nh:]:
            out[:, pos:pos + b.shape[1]] = b
            pos += b.shape[1]
        out[:, pos] = ValueType.kGroupEnd
        out[:, pos + 1] = ValueType.kHybridTime
        out[:, pos + 2:pos + 10] = (~np.asarray(cb.ht, np.uint64)).astype(
            ">u8").view(np.uint8).reshape(-1, 8)
        out[:, pos + 10:pos + 14] = (~np.asarray(
            cb.write_id, np.uint32)).astype(">u4").view(
                np.uint8).reshape(-1, 4)
        return out


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


#: little-endian storage dtype of each fixed-width packed column
_PACK_DTYPES = {ColumnType.BOOL: np.dtype("u1"),
                ColumnType.INT32: np.dtype("<i4"),
                ColumnType.INT64: np.dtype("<i8"),
                ColumnType.FLOAT32: np.dtype("<f4"),
                ColumnType.FLOAT64: np.dtype("<f8"),
                ColumnType.TIMESTAMP: np.dtype("<i8")}
_TEXT_TYPES = (ColumnType.STRING, ColumnType.JSON, ColumnType.DECIMAL)


def copy_segments(src: np.ndarray, src_start: np.ndarray,
                  dst_start: np.ndarray, lens: np.ndarray,
                  out: np.ndarray) -> None:
    """out[dst_start[i]:+lens[i]] = src[src_start[i]:+lens[i]] for every
    i (the host library's memcpy loop, or its numpy twin)."""
    args = (np.ascontiguousarray(src, np.uint8),
            np.ascontiguousarray(src_start, np.int64),
            np.ascontiguousarray(dst_start, np.int64),
            np.ascontiguousarray(lens, np.int64), out)
    if not native_lib.gather_heap(*args):
        native_lib.gather_heap_fallback(*args)


def _fixed_lane(col, vals: np.ndarray, nulls: np.ndarray
                ) -> Optional[np.ndarray]:
    """A fixed column's packed little-endian bytes ([n, width], zeros
    under NULL), or None where RowPacker's struct.pack would refuse a
    value or convert it in a way a cast does not."""
    dt = _PACK_DTYPES[col.type]
    vals = np.asarray(vals)
    if col.type == ColumnType.BOOL:
        arr = (vals != 0).astype(dt)
    else:
        if dt.kind == "i":
            if vals.dtype.kind not in "iub":
                return None          # a float into '<i'/'<q': refused
            live = vals[~nulls]
            if vals.dtype.kind in "iu" and len(live):
                info = np.iinfo(dt)
                if int(live.min()) < info.min or int(live.max()) > info.max:
                    return None      # out of range: struct.error
        elif vals.dtype.kind not in "iubf":
            return None
        if dt == np.dtype("<f4") and vals.dtype != dt:
            return None              # a double narrowed by struct.pack
        arr = vals.astype(dt)
    arr = np.where(nulls, np.zeros((), dt), arr)
    return np.ascontiguousarray(arr).view(np.uint8).reshape(
        len(arr), dt.itemsize)


def _pack_block_values(packing: SchemaPacking, blk: ColumnarBlock,
                       schema: TableSchema,
                       chunk_rows: int = 8192) -> Optional[List[bytes]]:
    """Every row's KV value of a columnar block, byte for byte what
    RowPacker.pack_value packs from the row's schema columns (tombstone
    rows b"\x10"), built in numpy passes: the fixed prefix (varint
    version, null bitmap, fixed region, u32 varlen end offsets) as one
    matrix, the heaps gathered segment-wise.  None for a shape the
    row-at-a-time path must decide (a value struct.pack would refuse or
    narrow, text that does not decode, a varlen column outside the
    schema)."""
    from ..dockv.key_encoding import _encode_varint_unsigned
    n = blk.n
    ids = {c.id for c in schema.columns}
    if any(cid < DERIVED_COL_BASE and cid not in ids for cid in blk.varlen):
        return None
    header = _encode_varint_unsigned(packing.schema_version)
    h, bm = len(header), packing.bitmap_size
    P = h + packing.prefix_size
    cols = packing.all_columns
    nfix = len(packing.fixed_columns)
    nvar = len(packing.varlen_columns)
    pre = np.zeros((n, P), np.uint8)
    pre[:, :h] = np.frombuffer(header, np.uint8)
    nullmat = np.ones((n, len(cols)), bool)    # absent columns are NULL
    fx0 = h + bm
    for ci, c in enumerate(packing.fixed_columns):
        f = blk.fixed.get(c.id)
        if f is None:
            continue
        nulls = np.asarray(f[1], bool)
        lane = _fixed_lane(c, f[0], nulls)
        if lane is None:
            return None
        nullmat[:, ci] = nulls
        off = fx0 + packing.fixed_offsets[c.id]
        pre[:, off:off + lane.shape[1]] = lane
    lens = np.zeros((n, nvar), np.int64)
    heaps = []
    for vi, c in enumerate(packing.varlen_columns):
        vl = blk.varlen.get(c.id)
        if vl is None:
            heaps.append(None)
            continue
        ends, heap, nulls = vl
        ends = np.asarray(ends, np.int64)
        nulls = np.asarray(nulls, bool)
        starts = np.concatenate([np.zeros(1, np.int64), ends[:-1]])
        src = np.frombuffer(heap, np.uint8)
        if c.type in _TEXT_TYPES:
            try:
                bytes(src).decode()
            except UnicodeDecodeError:
                return None
        lens[:, vi] = np.where(nulls, 0, ends - starts)
        nullmat[:, nfix + vi] = nulls
        heaps.append((src, starts))
    cum = np.cumsum(lens, axis=1)
    if nvar:
        if int(cum[:, -1].max(initial=0)) >= 1 << 32:
            return None
        vo0 = fx0 + packing.fixed_size
        pre[:, vo0:vo0 + 4 * nvar] = np.ascontiguousarray(
            cum.astype("<u4")).view(np.uint8).reshape(n, 4 * nvar)
    if bm:
        pre[:, h:h + bm] = np.packbits(nullmat, axis=1, bitorder="little")
    heap_len = cum[:, -1] if nvar else np.zeros(n, np.int64)
    tomb = np.asarray(blk.tombstone, bool)
    out: List[bytes] = []
    for lo in range(0, n, chunk_rows):
        hi = min(n, lo + chunk_rows)
        rl = 1 + P + heap_len[lo:hi]
        pos = np.concatenate([np.zeros(1, np.int64), np.cumsum(rl)])
        buf = np.empty(int(pos[-1]), np.uint8)
        buf[pos[:-1]] = ValueKind.kPackedRowV2
        copy_segments(pre[lo:hi].reshape(-1),
                      np.arange(hi - lo, dtype=np.int64) * P, pos[:-1] + 1,
                      np.full(hi - lo, P, np.int64), buf)
        for vi, hs in enumerate(heaps):
            if hs is None:
                continue
            src, starts = hs
            ln = lens[lo:hi, vi]
            copy_segments(src, starts[lo:hi],
                          pos[:-1] + 1 + P + cum[lo:hi, vi] - ln, ln, buf)
        raw = buf.tobytes()
        p = pos.tolist()
        out.extend(raw[p[i]:p[i + 1]] for i in range(hi - lo))
    tomb_v = PrimitiveValue.tombstone().encode()
    for i in np.flatnonzero(tomb).tolist():
        out[i] = tomb_v
    return out
