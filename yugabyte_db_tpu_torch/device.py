"""Device resolution: the one place that turns a ``device=`` argument
into a ``torch.device`` and refuses what cannot run.

Every entry point of the port defaults to ``device="cuda"``.  Asking for
CUDA on a machine without it raises — nothing quietly carries on on the
CPU.  The CPU is used only when the caller says ``device="cpu"`` (the
tests do)."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


class DeviceUnavailable(RuntimeError):
    """The requested device does not exist on this machine."""


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a validated ``torch.device``; raises
    DeviceUnavailable for CUDA without a card and ValueError for a
    device type the port does not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain CPU path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
