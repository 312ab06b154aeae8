"""yugabyte_db_tpu_torch — the PyTorch/CUDA port of yugabyte_db_tpu.

The JAX package ``yugabyte_db_tpu`` is the reference; this package
mirrors its layout module for module, so each port module sits at the
same relative path as its counterpart.  It imports ``torch`` and numpy
only — never ``jax`` and nothing of the JAX package.

Ported so far (ROADMAP.md queue 1): the TPC-H Q6/Q1 scan-aggregate
path — bulk-loaded lineitem blocks -> one padded device batch ->
``ops.scan.ScanKernel.run`` (exact int64 fixed-point route, MVCC modes
``none`` and ``visible``) or the hand-written Hopper kernels of
``ops.hand_scan`` -> host-combined partials.

Device rule: every entry point takes ``device=`` and defaults to
``"cuda"``; asking for CUDA where there is none raises
(``device.resolve_device``).  The CPU is used only when the caller
passes ``device="cpu"``.

Package layout:
  device.py   device resolution and validation
  utils/      flags (only those this slice reads), hybrid time
  dockv/      column schemas, key type bytes, partitioning, bulk encoders
  storage/    ColumnarBlock (struct-of-arrays rows)
  docdb/      TableInfo + TableCodec bulk block builder
  models/     TPC-H lineitem generator, Q6/Q1 and their numpy answers
  ops/        expression compiler, device batches, scan kernel, hand
              kernels (hand_scan.py; CUDA sources under csrc/)
"""

__version__ = "0.1.0"
