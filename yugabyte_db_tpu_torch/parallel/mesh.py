"""Device meshes mirroring tablet sharding.

Counterpart of ``yugabyte_db_tpu/parallel/mesh.py``.  The reference
maps tablet shards onto a mesh axis ("tablets") and adds a second axis
("blocks") for splitting one large tablet's rows across devices; its
combine is a ``lax.psum`` inside one ``shard_map`` program.  The port
is a single-controller mesh: one process holds every shard slot's
device, enqueues each slot's program on that device, and combines the
partials on the lead device (parallel/distributed_scan.py).

Slot ``s = t * B + b`` is the reference's mesh position ``(t, b)`` for
T tablet shards by B block shards.  Placement is the slot's device, so
the reference's ``NamedSharding``/``PartitionSpec`` and its
``shard_map_compat`` have no counterpart here.

The one deliberate difference from a JAX ``Mesh``: an explicit device
list may name one device more than once.  Torch has a single CPU
device, and one card can hold several shards, so ``["cpu"] * 8`` (the
tests) and ``["cuda:0"] * 8`` (a one-card machine) are 8-slot meshes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

TABLETS_AXIS = "tablets"
BLOCKS_AXIS = "blocks"


@dataclass(frozen=True)
class TabletMesh:
    """T tablet shards by B block shards; ``devices[t * B + b]`` holds
    slot (t, b)."""
    num_tablet_shards: int
    num_block_shards: int
    devices: Tuple[torch.device, ...]

    @property
    def num_shards(self) -> int:
        return self.num_tablet_shards * self.num_block_shards

    @property
    def lead(self) -> torch.device:
        """Where combined results land."""
        return self.devices[0]


def _all_cards() -> list:
    """Every visible card; raises DeviceUnavailable without one."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def tablet_mesh(num_tablet_shards: Optional[int] = None,
                num_block_shards: int = 1,
                devices: Optional[Sequence] = None) -> TabletMesh:
    """A T x B mesh over `devices` (default: every visible card), T
    defaulting to ``len(devices) // B``; raises ValueError when the
    mesh needs more devices than there are."""
    devices = (_all_cards() if devices is None
               else [resolve_device(d) for d in devices])
    if num_tablet_shards is None:
        num_tablet_shards = len(devices) // num_block_shards
    need = num_tablet_shards * num_block_shards
    if need > len(devices):
        raise ValueError(
            f"mesh {num_tablet_shards}x{num_block_shards} needs {need} "
            f"devices, have {len(devices)}")
    return TabletMesh(num_tablet_shards, num_block_shards,
                      tuple(devices[:need]))


def place(tm: TabletMesh, stacked: np.ndarray) -> List[torch.Tensor]:
    """One [S, ...] host array as per-slot tensors on the slots'
    devices: one copy per distinct device, whose rows are the slots'
    views (no slot is copied twice; on a one-device mesh the whole
    array moves in one copy)."""
    out: List[Optional[torch.Tensor]] = [None] * tm.num_shards
    for dev in dict.fromkeys(tm.devices):
        idx = [s for s, d in enumerate(tm.devices) if d == dev]
        part = stacked if len(idx) == tm.num_shards else stacked[idx]
        on_dev = torch.from_numpy(np.ascontiguousarray(part)).to(dev)
        for j, s in enumerate(idx):
            out[s] = on_dev[j]
    return out
