"""Document-workload benchmark model — the docstore's flagship shape.

Counterpart of ``yugabyte_db_tpu/models/docbench.py`` (the same
documents from the same seed).

A range-sharded table with an int PK and one schemaless JSON column
whose documents carry the mixed path schema real document stores see
("Columnar Formats for Schemaless LSM-based Document Stores"): a
high-coverage int path ($.qty), a float path ($.price), a
low-cardinality string path ($.tag), a nested string path
($.meta.region), an occasionally-missing path, and an array the
shredder must refuse.  The doc_scan bench measures a selective path
predicate over it in both worlds: shredded v2 lanes on the device path
vs the interpreted row-at-a-time JSON extractor (chip_smoke.py's
documents phase).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..docdb.table_codec import TableInfo
from ..dockv.packed_row import ColumnSchema, ColumnType, TableSchema
from ..dockv.partition import PartitionSchema

DOC_ID, DOC_COL = 0, 1

TAGS = ("alpha", "beta", "gamma", "delta")
REGIONS = ("us", "eu", "ap")


def docs_schema() -> TableSchema:
    return TableSchema(columns=(
        ColumnSchema(DOC_ID, "id", ColumnType.INT64, is_range_key=True),
        ColumnSchema(DOC_COL, "doc", ColumnType.JSON),
    ), version=1)


def docs_info(name: str = "docs") -> TableInfo:
    return TableInfo(name, name, docs_schema(),
                     PartitionSchema("range", 0))


def generate_docs(n: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """`n` synthetic documents as bulk-load columns.  ~1/7 of rows omit
    $.qty (presence-bitmap coverage < 1), every row carries an array
    lane the shredder must leave raw, and the scalar paths are
    type-homogeneous — the shape the write-side inference targets."""
    rng = np.random.default_rng(seed)
    qty = rng.integers(0, 100, n)
    price = np.round(rng.uniform(1.0, 1000.0, n), 2)
    tag = rng.integers(0, len(TAGS), n)
    region = rng.integers(0, len(REGIONS), n)
    docs = np.empty(n, object)
    for i in range(n):
        parts = ['{']
        if i % 7 != 0:
            parts.append(f'"qty": {int(qty[i])}, ')
        parts.append(f'"price": {repr(float(price[i]))}, ')
        parts.append(f'"tag": "{TAGS[tag[i]]}", ')
        parts.append(f'"meta": {{"region": "{REGIONS[region[i]]}"}}, ')
        parts.append(f'"hits": [{int(qty[i])}, {int(i % 3)}]}}')
        docs[i] = "".join(parts)
    return {"id": np.arange(n, dtype=np.int64), "doc": docs}


def doc_qty_query():
    """The bench's selective path predicate + aggregate shapes:
    ``WHERE CAST(doc->>'qty' AS bigint) = 7`` with
    SUM(CAST(doc->>'qty' AS bigint)), COUNT(*), MAX(doc->>'tag') —
    int-path compare, exact int64 SUM over the shredded lane, and the
    dict-code MIN/MAX decode satellite in one request."""
    j = lambda key: ("json", "text", ("col", DOC_COL), key)  # noqa: E731
    cast_i = ("fn", "cast_bigint", j("qty"))
    where = ("cmp", "eq", cast_i, ("const", 7))
    from ..ops.scan import AggSpec
    aggs = (AggSpec("sum", cast_i), AggSpec("count"),
            AggSpec("max", j("tag")))
    return where, aggs
