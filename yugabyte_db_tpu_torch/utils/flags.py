"""Runtime flags read by the ported scan path.

Counterpart of ``yugabyte_db_tpu/utils/flags.py``, cut to the flags this
slice reads.  The registry keeps the reference's get/set_flag surface
so call sites read the same; unknown names raise KeyError."""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Dict


@dataclass
class Flag:
    name: str
    default: Any
    help: str
    value: Any = None


class FlagRegistry:
    def __init__(self):
        self._flags: Dict[str, Flag] = {}
        self._lock = threading.Lock()

    def define(self, name: str, default: Any, help: str = "") -> Flag:
        with self._lock:
            if name not in self._flags:
                self._flags[name] = Flag(name, default, help, default)
            return self._flags[name]

    def get(self, name: str) -> Any:
        return self._flags[name].value

    def set(self, name: str, value: Any) -> None:
        self._flags[name].value = value


REGISTRY = FlagRegistry()


def get(name: str) -> Any:
    return REGISTRY.get(name)


def set_flag(name: str, value: Any) -> None:
    REGISTRY.set(name, value)


@contextlib.contextmanager
def overridden(name: str, value: Any):
    """Flag `name` set to `value` for the duration of a with-block; the
    previous value comes back on exit, exception or not."""
    old = REGISTRY.get(name)
    REGISTRY.set(name, value)
    try:
        yield
    finally:
        REGISTRY.set(name, old)


REGISTRY.define(
    "hand_scan_enabled", False,
    "Route eligible aggregate scans through the hand-written generic "
    "scan kernel (ops/hand_scan.py, Triton on CUDA) instead of the exact "
    "int64 fixed-point route; f32 compute, so int64 columns stay on the "
    "exact route.  Counterpart of the reference's `tpu_pallas_scan`.")
REGISTRY.define(
    "device_float_dtype", "auto",
    "Device representation of fractional f64 columns: 'auto' keeps f64 "
    "on the CPU and ships f32 on CUDA (SUMs stay exact via the scan "
    "kernel's int64 fixed-point accumulation); 'float32'/'float64' "
    "force one.")
REGISTRY.define(
    "scan_group_strategy", "auto",
    "Grouped-aggregate reduction strategy: 'segment' (scatter-add), "
    "'unroll' (per-group masked reductions), or 'auto' (segment on the "
    "CPU, unroll on CUDA).")
