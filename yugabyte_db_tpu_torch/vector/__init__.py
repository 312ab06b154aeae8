"""Vector-index subsystem: a pluggable ANN registry with two engines.

Counterpart of ``yugabyte_db_tpu/vector/``: the registry
(:mod:`registry`, the reference's on-disk format), the two-stage IVF
(:mod:`ivf`: multi-probe candidates scored by one product over the
list-major base on the card, then an f32 re-rank) and the HNSW graph
index on the host (:mod:`hnsw`).  The tablet's vector index (its delta,
search merge, persistence and bootstrap) is in
``yugabyte_db_tpu_torch/tablet/tablet.py``.
"""
from .registry import (  # noqa: F401
    AnnIndex, available_methods, get_index_cls, register_index,
)
from .ivf import TwoStageIvfIndex  # noqa: F401
from .hnsw import HnswIndex  # noqa: F401
