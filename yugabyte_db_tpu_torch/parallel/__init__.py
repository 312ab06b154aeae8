"""The multi-device tablet mesh: a single-controller mesh of shard
slots (:mod:`mesh`), the distributed scan with its cross-shard combine
(:mod:`distributed_scan`) and sharded vector search (:mod:`vector`).
Counterpart of ``yugabyte_db_tpu/parallel/``."""
from .mesh import tablet_mesh, TabletMesh  # noqa: F401
from .distributed_scan import DistributedScanKernel, distributed_scan_aggregate  # noqa: F401
from .vector import sharded_ann_search, sharded_exact_search  # noqa: F401
