"""Hand-written Hopper kernels for the scan path, each beside its plain
PyTorch version.

Counterpart of ``yugabyte_db_tpu/ops/pallas_scan.py``, whose three
``pl.pallas_call`` kernels this module replaces:

K1 ``q6_scan_kernel``      <- ``_q6_kernel`` (pallas_scan.py:54), CUDA C++
                              csrc/q6_scan.cu
K2 ``grouped_sum_kernel``  <- ``_grouped_kernel`` (pallas_scan.py:137),
                              CUDA C++ csrc/grouped_sum.cu
K3 ``GenericScan``         <- ``build_generic_scan``'s kernel
                              (pallas_scan.py:222), Triton source generated
                              per query from the expression AST

These three kernels emit per-4096-row-block partials, as the Pallas
kernels did; the callers combine them.  Each wrapper dispatches on the device
of the tensors it is given: on CPU tensors it runs the plain version
(the tests' route); on CUDA tensors it launches the kernel or raises —
there is no fallback.  ``LAUNCHES`` counts kernel launches, and only
those.

All three are bound by memory traffic on an H100 (see each source's
note): the design goal is one read of every input lane.  K1 and K2 take
f32 lanes, as their Pallas kernels did; K3 takes a batch's lanes in
their own dtypes (int32, f32, bool, ...) and converts them in
registers, so the hand route reads each column once, at its width.

The CUDA build and the launch counts here also serve the join probe
kernel (csrc/join_probe.cu, wrapped by ops/join_scan.py ``probe_rows``),
which stands in for the reference's jitted probe loop, not for a Pallas
kernel.

Building: the CUDA sources compile with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into one plain-C shared library each
(loaded with ctypes), in parallel, at first use, under ``build/`` at the
repository root.  Triton and nvcc are only touched inside the functions
that launch, never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .expr import _lower, compile_expr, const_count

BLOCK_ROWS = 8 * 128 * 4          # 4096 rows per block, as the reference

#: kernel launches by kernel name — incremented where a kernel is
#: launched and nowhere else (plain versions never count)
LAUNCHES: Dict[str, int] = {"q6_scan": 0, "grouped_sum": 0,
                            "generic_scan": 0, "join_probe": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class HandScanIneligible(Exception):
    """Typed refusal of the hand scan route; the reason string is one of
    the reference's PallasIneligible reasons (mvcc_or_no_aggs,
    group_shape, agg_op, bucket_rows, dict_code_agg, column_dtype,
    int32_range, const_shape, const_range)."""


class KernelBuildError(RuntimeError):
    """A hand kernel failed to build or launch."""


_REPO_ROOT = Path(__file__).resolve().parents[2]
_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = _REPO_ROOT / "build"
_CUDA_SOURCES = ("q6_scan", "grouped_sum", "join_probe")


# --------------------------------------------------------------------------
# CUDA build (route: nvcc -> plain-C shared library -> ctypes)
# --------------------------------------------------------------------------
_libs: Dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise KernelBuildError("nvcc not found (CUDA toolkit required)")
    return exe


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src).hexdigest()[:16]
    return BUILD_DIR / "hand_kernels" / f"{name}_{digest}.so"


def build_cuda_kernels(names: Sequence[str] = _CUDA_SOURCES,
                       verbose: bool = False) -> Dict[str, Path]:
    """Compile the CUDA sources that are not built yet, one nvcc per
    source, all started together; raises KernelBuildError with the
    compiler's output on failure.  Returns name -> library path."""
    out = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(tmp), str(_CSRC / f"{n}.cu")]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{n}.cu:\n{log}")
            continue
        if verbose and log.strip():
            print(f"[nvcc {n}.cu]\n{log.rstrip()}")
        os.replace(tmp, todo[n])
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return out


def _lib(name: str) -> ctypes.CDLL:
    with _libs_lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_cuda_kernels((name,))[name]
            lib = ctypes.CDLL(str(path))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            if name == "q6_scan":
                lib.q6_scan_launch.argtypes = [vp] * 8 + [ci, vp]
                lib.q6_scan_launch.restype = ci
            elif name == "join_probe":
                lib.join_probe_launch.argtypes = [
                    vp, ci, vp, vp, vp, ci, ci, ctypes.c_longlong, ci, vp,
                    vp, vp]
                lib.join_probe_launch.restype = ci
            else:
                lib.grouped_sum_launch.argtypes = [vp, vp, vp, ci, vp,
                                                   ci, vp]
                lib.grouped_sum_launch.restype = ci
                lib.grouped_sum_max_groups.argtypes = []
                lib.grouped_sum_max_groups.restype = ci
            _libs[name] = lib
        return lib


#: lane dtypes K3 loads natively and converts to f32 in registers (the
#: hand-route gate refuses columns of any other dtype); K1 and K2 take f32
HAND_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int16,
               torch.int8, torch.bool)


def _check_lanes(lanes: Sequence[torch.Tensor], n: int,
                 dtypes: Sequence[torch.dtype] = (torch.float32,)) -> None:
    for t in lanes:
        if t.dtype not in dtypes or t.dim() != 1 or t.shape[0] != n \
                or not t.is_contiguous() or t.device != lanes[0].device \
                or (t.device.type == "cuda" and t.data_ptr() % 16):
            raise ValueError(
                "hand kernels take contiguous, 16-byte aligned [N] lanes "
                f"on one device, each of {[str(d) for d in dtypes]}, N a "
                "multiple of 4096")
    if n % BLOCK_ROWS:
        raise ValueError(f"rows ({n}) must be a multiple of {BLOCK_ROWS}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise KernelBuildError(f"{what} launch failed: cudaError {err}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _device_of(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _pad_np(a, padded: int) -> np.ndarray:
    out = np.zeros(padded, np.float32)
    out[:len(a)] = a
    return out


# --------------------------------------------------------------------------
# K1: fused Q6 scan
# --------------------------------------------------------------------------
def q6_scan_plain(qty, price, disc, ship, valid, scalars):
    """Plain version of K1: per-block (SUM(price*disc*mask), COUNT) f32
    partials, [grid] each."""
    lo_s, hi_s, lo_d, hi_d, qmax = (scalars[i] for i in range(5))
    mask = ((ship >= lo_s) & (ship < hi_s) & (disc >= lo_d)
            & (disc <= hi_d) & (qty < qmax) & (valid > 0))
    maskf = mask.to(torch.float32)
    grid = qty.shape[0] // BLOCK_ROWS
    return ((price * disc * maskf).view(grid, BLOCK_ROWS).sum(1),
            maskf.view(grid, BLOCK_ROWS).sum(1))


def q6_scan_kernel(qty, price, disc, ship, valid, scalars):
    """K1: per-block Q6 partials.  Inputs: f32 [N] lanes (N a multiple
    of 4096, valid=0 on padding) and f32 scalars [ship_lo, ship_hi,
    disc_lo, disc_hi, qty_max]; returns (sums [grid], counts [grid])."""
    n = qty.shape[0]
    _check_lanes((qty, price, disc, ship, valid), n)
    if _device_of(qty) == "cpu":
        return q6_scan_plain(qty, price, disc, ship, valid, scalars)
    scalars = scalars.to(device=qty.device, dtype=torch.float32)
    grid = n // BLOCK_ROWS
    sums = torch.empty(grid, dtype=torch.float32, device=qty.device)
    cnts = torch.empty(grid, dtype=torch.float32, device=qty.device)
    lib = _lib("q6_scan")
    LAUNCHES["q6_scan"] += 1
    _raise_on(lib.q6_scan_launch(
        qty.data_ptr(), price.data_ptr(), disc.data_ptr(), ship.data_ptr(),
        valid.data_ptr(), scalars.contiguous().data_ptr(), sums.data_ptr(),
        cnts.data_ptr(), grid, _stream()), "q6_scan")
    return sums, cnts


def q6_scan_device(qty, price, disc, ship, valid, scalars):
    """Counterpart of ``q6_scan_pallas``: the partials summed on the
    device in f32 -> (revenue, count) 0-dim f32 tensors."""
    sums, cnts = q6_scan_kernel(qty, price, disc, ship, valid, scalars)
    return sums.sum(), cnts.sum()


def q6_scan(qty: np.ndarray, price: np.ndarray, disc: np.ndarray,
            shipdate: np.ndarray, ship_lo: float, ship_hi: float,
            disc_lo: float, disc_hi: float, qty_max: float,
            device="cuda") -> Tuple[float, int]:
    """Host wrapper: pads to the block grid, ships to ``device`` and
    runs K1 (the plain version when device is the CPU)."""
    dev = resolve_device(device)
    n = len(qty)
    padded = ((n + BLOCK_ROWS - 1) // BLOCK_ROWS) * BLOCK_ROWS
    valid = np.zeros(padded, np.float32)
    valid[:n] = 1.0
    lanes = [torch.from_numpy(_pad_np(a, padded)).to(dev)
             for a in (qty, price, disc, shipdate)]
    scalars = torch.tensor([ship_lo, ship_hi, disc_lo, disc_hi, qty_max],
                           dtype=torch.float32, device=dev)
    s, c = q6_scan_device(*lanes, torch.from_numpy(valid).to(dev), scalars)
    return float(s), int(c)


# --------------------------------------------------------------------------
# K2: one-hot grouped sum
# --------------------------------------------------------------------------
def grouped_sum_plain(gids, values, mask, num_groups: int):
    """Plain version of K2: per-block one_hot(int32(gid))^T . (value *
    mask) partials, [grid, G] f32 (the product spreads inf*0 = NaN to
    the other groups of a block exactly as the reference's matmul)."""
    grid = gids.shape[0] // BLOCK_ROWS
    val = (values * mask).view(grid, BLOCK_ROWS, 1)
    groups = torch.arange(num_groups, dtype=torch.int32,
                          device=gids.device)
    onehot = (gids.to(torch.int32).view(grid, BLOCK_ROWS, 1) == groups
              ).to(torch.float32)
    return (val * onehot).sum(1)


def grouped_sum_kernel(gids, values, mask, num_groups: int):
    """K2: per-block grouped masked sums [grid, G] f32 from f32 [N]
    lanes (N a multiple of 4096, mask 0 on padding)."""
    n = gids.shape[0]
    _check_lanes((gids, values, mask), n)
    if _device_of(gids) == "cpu":
        return grouped_sum_plain(gids, values, mask, num_groups)
    lib = _lib("grouped_sum")
    max_g = lib.grouped_sum_max_groups()
    if not 0 < num_groups <= max_g:
        raise ValueError(
            f"grouped_sum kernel takes 1..{max_g} groups, got "
            f"{num_groups}")
    grid = n // BLOCK_ROWS
    partials = torch.empty((grid, num_groups), dtype=torch.float32,
                           device=gids.device)
    LAUNCHES["grouped_sum"] += 1
    _raise_on(lib.grouped_sum_launch(
        gids.data_ptr(), values.data_ptr(), mask.data_ptr(), num_groups,
        partials.data_ptr(), grid, _stream()), "grouped_sum")
    return partials


def grouped_sum_device(gids, values, mask, num_groups: int):
    """Counterpart of ``grouped_sum_pallas``: [G] sums, the per-block
    partials summed on the device in f32."""
    return grouped_sum_kernel(gids, values, mask, num_groups).sum(0)


def grouped_sum(gids: np.ndarray, values: np.ndarray, mask: np.ndarray,
                num_groups: int, device="cuda") -> np.ndarray:
    dev = resolve_device(device)
    n = len(gids)
    padded = ((n + BLOCK_ROWS - 1) // BLOCK_ROWS) * BLOCK_ROWS
    lanes = [torch.from_numpy(_pad_np(a, padded)).to(dev)
             for a in (gids, values, np.asarray(mask, np.float32))]
    return grouped_sum_device(*lanes, num_groups).cpu().numpy()


# --------------------------------------------------------------------------
# K3: generic scan — any compiled WHERE + f32 SUM/COUNT/MIN/MAX
# --------------------------------------------------------------------------
def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def _pow2_floor(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p <<= 1
    return p


#: accumulator registers per thread that K3's grouped forms aim for,
#: well under the 255-register cap: the lanes, the expression
#: temporaries and the one-hot flags need the rest
_K3_ACC_REGS = 64


def k3_config(num_groups, n_acc: int) -> Tuple[str, int, int]:
    """(form, SUB, num_warps) of K3 for ``num_groups`` groups (None:
    ungrouped) and ``n_acc`` accumulators per group (distinct
    aggregates plus the NaN flags of MIN/MAX).

    flat      ungrouped: [SUB] accumulators, reduced once per block;
    unrolled  one [SUB] accumulator per (aggregate, group), emitted
              unrolled, for n_acc * G <= 96 (Q1: 5 * 6);
    tile      one [GP, SUB] register tile per aggregate, for the
              larger G up to the gate's 64, where the unrolled form
              would spill.
    Both grouped forms reduce across the CTA once per 4096-row block;
    SUB is sized so the accumulators hold about _K3_ACC_REGS registers
    a thread.  On Q1's lanes the unrolled form takes 15 % less time
    than the best tile config (chip_smoke.py's k3_config lines)."""
    if num_groups is None:
        return "flat", 1024, 4
    per_row = n_acc * num_groups
    if per_row <= 96:
        r = _pow2_floor(max(1, min(4, _K3_ACC_REGS // per_row)))
        return "unrolled", 32 * 4 * r, 4
    gp = max(2, _next_pow2(num_groups))
    sub = _pow2_floor(max(1, _K3_ACC_REGS * 32 * 8 // (n_acc * gp)))
    return "tile", max(16, min(1024, sub)), 8


def _load_lane(ptr: str, dtype: torch.dtype, flag: bool) -> str:
    """Triton expression that loads one lane at ``offs`` in its own
    dtype.  A value lane becomes f32 in registers (as ``.to(float32)``
    does: exact for int8/16/32 under the int32 range gate, round to
    nearest for f64).  A flag lane (a null lane or valid) becomes
    ``f32(x) > 0``, the plain version's test; a bool lane arrives as a
    uint8 view and is compared ``!= 0``."""
    raw = f"tl.load({ptr} + offs)"
    if not flag:
        return raw if dtype == torch.float32 else f"{raw}.to(tl.float32)"
    if dtype == torch.bool:
        return f"{raw} != 0"
    if dtype == torch.float64:
        return f"{raw}.to(tl.float32) > 0"
    return f"{raw} > 0"


class TritonOps:
    """Operator backend for expr._lower that emits Triton statements.
    Values are variable names; every column lane is f32 once loaded
    (see _load_lane), so no promotion is needed."""

    _CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
            "ne": "!="}
    _ARITH = {"add": "+", "sub": "-", "mul": "*", "div": "/"}

    def __init__(self, lines: List[str], indent: str):
        self.lines = lines
        self.indent = indent
        self._n = 0

    def _tmp(self, expr: str) -> str:
        name = f"t{self._n}"
        self._n += 1
        self.lines.append(f"{self.indent}{name} = {expr}")
        return name

    def const(self, c):
        return c

    def cmp(self, op, a, b):
        return self._tmp(f"{a} {self._CMP[op]} {b}")

    def arith(self, op, a, b):
        if op == "mod":
            # C fmod (libdevice), exact like the reference's jnp.fmod;
            # Triton's own float % floors
            return self._tmp(f"libdevice.fmod({a}, {b})")
        return self._tmp(f"{a} {self._ARITH[op]} {b}")

    def logical_and(self, a, b):
        return self._tmp(f"{a} & {b}")

    def logical_or(self, a, b):
        return self._tmp(f"{a} | {b}")

    def logical_not(self, a):
        return self._tmp(f"~{a}")

    def false_like(self, x):
        return self._tmp("tl.zeros([SUB], dtype=tl.int1)")

    def dictlut(self, codes, lut):
        # the reference's Pallas route never sees a LUT: its gate refuses
        # the array constant (const_shape) first, as ScanKernel's does
        raise HandScanIneligible("const_shape")


_TRITON_PRELUDE = '''\
import triton
import triton.language as tl
try:
    from triton.language.extra import libdevice
except ImportError:                  # Triton 3.0 keeps it under extra.cuda
    from triton.language.extra.cuda import libdevice

'''

_FILL = {"min": "float('inf')", "max": "-float('inf')"}
_PICK = {"min": "tl.minimum", "max": "tl.maximum"}
_REDUCE = {"sum": "tl.sum", "count": "tl.sum", "min": "tl.min",
           "max": "tl.max"}


class GenericScan:
    """K3 for one query signature — counterpart of the reference's
    ``build_generic_scan`` (which took compiled aggregate fns; K3 needs
    the ASTs to generate its source): fn(consts f32 [max(n_consts,1)],
    col lanes, null lanes, valid) -> per-aggregate partials ([grid] or
    [grid, G]) followed by the row-count partials, all f32.

    Lanes come in their own dtypes (any of HAND_DTYPES): the kernel
    loads each natively and converts it in registers; the plain version
    casts them to f32 first, as the reference's caller does.

    ``aggs``: [(op, expr node or None)] — op in sum|count|min|max, None
    meaning COUNT(*).  group_cols: GroupSpec cols ((cid, domain,
    offset), ...) or None; col_order/null_order fix the lane order.
    Grouped sums are one-hot products, so a valid row whose value is
    non-finite spreads NaN into the other groups of its block, exactly
    as the reference's matmul does."""

    def __init__(self, where, aggs, group_cols, num_groups,
                 col_order, null_order, n_consts: int):
        self.where = where
        self.aggs = tuple(aggs)
        self.group_cols = tuple(group_cols) if group_cols else None
        self.G = num_groups if self.group_cols else None
        self.col_order = tuple(col_order)
        self.null_order = tuple(null_order)
        self.n_consts = n_consts
        # the kernel's consts list holds WHERE constants first, then each
        # aggregate expression's, in order: compile at cumulative offsets
        self._offsets = []
        off = const_count(where) if where is not None else 0
        for _, e in self.aggs:
            self._offsets.append(off)
            if e is not None:
                off += const_count(e)
        self._where_fn = compile_expr(where) if where is not None else None
        self._agg_fns = [(op, compile_expr(e, offset=o) if e is not None
                          else None)
                         for (op, e), o in zip(self.aggs, self._offsets)]
        # the kernel keeps one accumulator per distinct output (Q1's
        # COUNT(*) aggregate and the row count share one).  Only outputs
        # free of constants merge: a cached entry serves every query of
        # its signature, and the signature leaves constant values out
        self._accs: List[tuple] = []       # (op, expr, const offset)
        self._acc_of: List[int] = []       # output -> accumulator
        seen: Dict[str, int] = {}
        for (op, e), o in zip(list(self.aggs) + [("count", None)],
                              self._offsets + [0]):
            key = repr((op, e)) if e is None or const_count(e) == 0 \
                else len(self._accs)
            if key not in seen:
                seen[key] = len(self._accs)
                self._accs.append((op, e, o))
            self._acc_of.append(seen[key])
        n_acc = len(self._accs) + sum(op in ("min", "max")
                                      for op, _, _ in self._accs)
        #: (form, SUB, num_warps), see k3_config
        self.config = k3_config(self.G, n_acc)
        self._kernels: Dict[tuple, object] = {}
        #: the last launch's compiled kernel (registers, spills)
        self.compiled = None
        #: this signature's own kernel launches (LAUNCHES has the total)
        self.launches = 0

    # --- plain version ---------------------------------------------------
    def plain(self, consts, col_arrs, null_arrs, valid):
        n = valid.shape[0]
        grid = n // BLOCK_ROWS
        shp = (grid, BLOCK_ROWS)
        f32 = torch.float32
        cols = {cid: col_arrs[i].to(f32).view(shp)
                for i, cid in enumerate(self.col_order)}
        nulls = {cid: null_arrs[i].to(f32).view(shp) > 0
                 for i, cid in enumerate(self.null_order)}
        cs = [consts[i] for i in range(self.n_consts)]
        mask = valid.to(f32).view(shp) > 0
        if self._where_fn is not None:
            wv, wn = self._where_fn(cols, nulls, cs)
            mask = mask & wv
            if wn is not None:
                mask = mask & torch.logical_not(wn)
        inf = torch.tensor(float("inf"), dtype=f32, device=valid.device)

        def value(f):
            v, vn = f(cols, nulls, cs)
            return v.to(f32).expand(shp), vn

        outs = []
        if self.G is None:
            maskf = mask.to(f32)
            for op, f in self._agg_fns:
                if f is None:
                    outs.append(maskf.sum(1))
                    continue
                v, vn = value(f)
                m = maskf if vn is None else \
                    maskf * torch.logical_not(vn).to(f32)
                if op == "count":
                    outs.append(m.sum(1))
                elif op == "sum":
                    outs.append(torch.where(m > 0, v, 0.0).sum(1))
                elif op == "min":
                    outs.append(torch.where(m > 0, v, inf).amin(1))
                else:
                    outs.append(torch.where(m > 0, v, -inf).amax(1))
            outs.append(maskf.sum(1))
            return tuple(outs)
        gid = None
        stride = 1
        for cid, domain, offset in self.group_cols:
            gn = nulls.get(cid)
            if gn is not None:
                mask = mask & torch.logical_not(gn)
            c = (cols[cid] - offset).clamp(0.0, float(domain - 1))
            gid = c * stride if gid is None else gid + c * stride
            stride *= domain
        maskf = mask.to(f32)
        groups = torch.arange(self.G, dtype=torch.int32, device=valid.device)
        onehot = (gid.to(torch.int32)[..., None] == groups).to(f32) \
            * maskf[..., None]
        for op, f in self._agg_fns:
            if f is None:
                outs.append(onehot.sum(1))
                continue
            v, vn = value(f)
            oh = onehot if vn is None else \
                onehot * torch.logical_not(vn).to(f32)[..., None]
            if op == "count":
                outs.append(oh.sum(1))
            elif op == "sum":
                row_m = oh.amax(2)
                vm = torch.where(row_m > 0, v, 0.0)
                outs.append((vm[..., None] * oh).sum(1))
            elif op == "min":
                outs.append(torch.where(oh > 0, v[..., None], inf).amin(1))
            else:
                outs.append(torch.where(oh > 0, v[..., None], -inf).amax(1))
        outs.append(onehot.sum(1))
        return tuple(outs)

    # --- Triton source -----------------------------------------------------
    def triton_source(self, dtypes: Sequence[torch.dtype] = None) -> str:
        """The kernel specialised to this signature and to its lanes'
        dtypes (columns, null lanes, valid, in order; all f32 when
        None), generated from the same expression walk as compile_expr
        (TritonOps backend)."""
        n_cols, n_nulls = len(self.col_order), len(self.null_order)
        n_lanes = n_cols + n_nulls + 1
        dtypes = tuple(dtypes) if dtypes is not None \
            else (torch.float32,) * n_lanes
        if len(dtypes) != n_lanes:
            raise ValueError(f"{n_lanes} lane dtypes expected, got "
                             f"{len(dtypes)}")
        form = self.config[0]
        args = (["consts_ptr"] + [f"x{i}_ptr" for i in range(n_cols)]
                + [f"n{i}_ptr" for i in range(n_nulls)]
                + ["valid_ptr", "out_ptr", "out_stride"])
        L = [_TRITON_PRELUDE]
        if form == "unrolled":
            L += self._combine_source()
        L += ["@triton.jit",
              "def generic_scan(" + ", ".join(args) + ",",
              "                 BLOCK_ROWS: tl.constexpr, SUB: tl.constexpr,"
              " GP: tl.constexpr, G: tl.constexpr):",
              "    pid = tl.program_id(0)",
              "    base = pid.to(tl.int64) * BLOCK_ROWS"]
        for i in range(self.n_consts):
            L.append(f"    c{i} = tl.load(consts_ptr + {i})")
        shape = "[GP, SUB]" if form == "tile" else "[SUB]"
        for j, (op, _, _) in enumerate(self._accs):
            for a, f in self._acc_names(j):
                if op in ("min", "max"):
                    L.append(f"    {a} = tl.full({shape}, {_FILL[op]}, "
                             "tl.float32)")
                    L.append(f"    {f} = tl.zeros({shape}, "
                             "dtype=tl.float32)")
                else:
                    L.append(f"    {a} = tl.zeros({shape}, "
                             "dtype=tl.float32)")
        L.append("    for s in range(0, BLOCK_ROWS, SUB):")
        ind = "        "
        L.append(ind + "offs = base + s + tl.arange(0, SUB)")
        cols, nulls = {}, {}
        for i, cid in enumerate(self.col_order):
            L.append(ind + f"x{i} = "
                     + _load_lane(f"x{i}_ptr", dtypes[i], False))
            cols[cid] = f"x{i}"
        for i, cid in enumerate(self.null_order):
            L.append(ind + f"n{i} = "
                     + _load_lane(f"n{i}_ptr", dtypes[n_cols + i], True))
            nulls[cid] = f"n{i}"
        L.append(ind + "mask = " + _load_lane("valid_ptr", dtypes[-1], True))
        consts = [f"c{i}" for i in range(self.n_consts)]
        ops = TritonOps(L, ind)
        if self.where is not None:
            wv, wn = _lower(self.where, ops, 0)(cols, nulls, consts)
            L.append(ind + f"mask = mask & {wv}")
            if wn is not None:
                L.append(ind + f"mask = mask & ~{wn}")
        if form == "flat":
            self._flat_body(L, ops, cols, nulls, consts)
            return "\n".join(L) + "\n"
        gid = None
        stride = 1
        for cid, domain, offset in self.group_cols:
            if cid in nulls:
                L.append(ind + f"mask = mask & ~{nulls[cid]}")
            c = ops._tmp(f"tl.minimum(tl.maximum({cols[cid]} - "
                         f"{float(offset)!r}, 0.0), "
                         f"{float(domain - 1)!r})")
            term = ops._tmp(f"{c} * {float(stride)!r}")
            gid = term if gid is None else ops._tmp(f"{gid} + {term}")
            stride *= domain
        L.append(ind + f"gi = {gid}.to(tl.int32)")
        # rows whose one-hot row is not all zero: the reference's
        # row max of the one-hot, without the [rows, G] reduction
        L.append(ind + "rin = mask & (gi >= 0) & (gi < G)")
        if form == "unrolled":
            self._unrolled_body(L, ops, cols, nulls, consts)
        else:
            self._tile_body(L, ops, cols, nulls, consts)
        return "\n".join(L) + "\n"

    def _acc_names(self, j: int) -> List[Tuple[str, str]]:
        """(accumulator, NaN flag) variable names of accumulator j: one
        pair, or one per group in the unrolled form."""
        if self.config[0] == "unrolled":
            return [(f"a{j}_{g}", f"f{j}_{g}") for g in range(self.G)]
        return [(f"a{j}", f"f{j}")]

    def _values(self, ops, cols, nulls, consts, e, off):
        v, vn = _lower(e, ops, off)(cols, nulls, consts)
        v = ops._tmp(f"tl.broadcast_to(({v}).to(tl.float32), (SUB,))")
        return v, vn

    def _flat_body(self, L, ops, cols, nulls, consts):
        ind = ops.indent
        L.append(ind + "maskf = mask.to(tl.float32)")
        for j, (op, e, off) in enumerate(self._accs):
            a, f = f"a{j}", f"f{j}"
            if e is None:
                L.append(ind + f"{a} += maskf")
                continue
            v, vn = self._values(ops, cols, nulls, consts, e, off)
            m = "maskf" if vn is None else ops._tmp(
                f"maskf * (~{vn}).to(tl.float32)")
            if op == "count":
                L.append(ind + f"{a} += {m}")
            elif op == "sum":
                L.append(ind + f"{a} += tl.where({m} > 0, {v}, 0.0)")
            else:
                vv = ops._tmp(f"tl.where({m} > 0, {v}, {_FILL[op]})")
                isn = ops._tmp(f"{vv} != {vv}")
                L.append(ind + f"{f} = tl.maximum({f}, "
                         f"{isn}.to(tl.float32))")
                L.append(ind + f"{a} = {_PICK[op]}({a}, tl.where({isn}, "
                         f"{_FILL[op]}, {vv}))")
        # epilogue: one partial per block and output
        for j, (op, _, _) in enumerate(self._accs):
            r = f"{_REDUCE[op]}(a{j}, axis=0)"
            if op in ("min", "max"):
                r = f"tl.where(tl.max(f{j}, axis=0) > 0, float('nan'), {r})"
            L.append(f"    r{j} = {r}")
        for k, j in enumerate(self._acc_of):
            L.append(f"    tl.store(out_ptr + {k} * out_stride + pid, r{j})")

    def _unrolled_body(self, L, ops, cols, nulls, consts):
        """One [SUB] accumulator per (aggregate, group), added to as
        accumulator += value * one_hot_g (the product, so inf * 0 = NaN
        reaches the other groups as in the reference's matmul)."""
        ind = ops.indent
        G = self.G
        for g in range(G):
            L.append(ind + f"h{g} = mask & (gi == {g})")
            L.append(ind + f"hf{g} = h{g}.to(tl.float32)")
        for j, (op, e, off) in enumerate(self._accs):
            if e is None:
                for g in range(G):
                    L.append(ind + f"a{j}_{g} += hf{g}")
                continue
            v, vn = self._values(ops, cols, nulls, consts, e, off)

            def hot(g, as_float):
                if vn is None:
                    return f"hf{g}" if as_float else f"h{g}"
                h = f"(h{g} & ~{vn})"
                return f"{h}.to(tl.float32)" if as_float else h
            if op == "count":
                for g in range(G):
                    L.append(ind + f"a{j}_{g} += {hot(g, True)}")
            elif op == "sum":
                # vm is +0.0 on null rows, so vm * hf_g is bitwise
                # vm * (h_g & ~null): one product a group
                rk = "rin" if vn is None else ops._tmp(f"rin & ~{vn}")
                vm = ops._tmp(f"tl.where({rk}, {v}, 0.0)")
                for g in range(G):
                    L.append(ind + f"a{j}_{g} += {vm} * hf{g}")
            else:
                for g in range(G):
                    a, f = f"a{j}_{g}", f"f{j}_{g}"
                    vv = ops._tmp(f"tl.where({hot(g, False)}, {v}, "
                                  f"{_FILL[op]})")
                    isn = ops._tmp(f"{vv} != {vv}")
                    L.append(ind + f"{f} = tl.maximum({f}, "
                             f"{isn}.to(tl.float32))")
                    L.append(ind + f"{a} = {_PICK[op]}({a}, tl.where("
                             f"{isn}, {_FILL[op]}, {vv}))")
        # epilogue: every accumulator of the block in ONE CTA-wide
        # reduction (one multi-operand tl.reduce), then G scalars an
        # output
        names = [n for j, _ in enumerate(self._accs)
                 for a, f in self._acc_names(j)
                 for n in ((a, f) if self._accs[j][0] in ("min", "max")
                           else (a,))]
        sums = [f"s_{n}" for n in names]
        L.append(f"    {', '.join(sums)}, = tl.reduce(("
                 f"{', '.join(names)},), 0, k3_combine)")
        for j, (op, _, _) in enumerate(self._accs):
            for g in range(G):
                r = f"s_a{j}_{g}"
                if op in ("min", "max"):
                    r = f"tl.where(s_f{j}_{g} > 0, float('nan'), {r})"
                L.append(f"    r{j}_{g} = {r}")
        for k, j in enumerate(self._acc_of):
            for g in range(G):
                L.append(f"    tl.store(out_ptr + {k} * out_stride + "
                         f"pid * G + {g}, r{j}_{g})")

    def _combine_source(self) -> List[str]:
        """The combine function of the unrolled epilogue's reduction:
        add for SUM/COUNT, min/max for MIN/MAX, max for NaN flags; the
        operands in the order _unrolled_body lists them."""
        kinds = []
        for op, _, _ in self._accs:
            if op in ("min", "max"):
                kinds += [_PICK[op], "tl.maximum"] * self.G
            else:
                kinds += ["+"] * self.G
        n = len(kinds)
        lhs = [f"l{i}" for i in range(n)]
        rhs = [f"r{i}" for i in range(n)]
        terms = [f"{a} + {b}" if k == "+" else f"{k}({a}, {b})"
                 for k, a, b in zip(kinds, lhs, rhs)]
        return ["@triton.jit",
                f"def k3_combine({', '.join(lhs + rhs)}):",
                f"    return {', '.join(terms)}", "", ""]

    def _tile_body(self, L, ops, cols, nulls, consts):
        """One [GP, SUB] accumulator tile per aggregate, added to
        elementwise (the one-hot product) and summed over rows once."""
        ind = ops.indent
        L.append(ind + "garange = tl.arange(0, GP)")
        L.append(ind + "h = (garange[:, None] == gi[None, :]) & "
                 "mask[None, :]")
        L.append(ind + "hf = h.to(tl.float32)")
        for j, (op, e, off) in enumerate(self._accs):
            a, f = f"a{j}", f"f{j}"
            if e is None:
                L.append(ind + f"{a} += hf")
                continue
            v, vn = self._values(ops, cols, nulls, consts, e, off)
            hk = "h" if vn is None or op == "sum" else \
                ops._tmp(f"h & ~{vn}[None, :]")
            if op == "count":
                L.append(ind + f"{a} += " + (
                    "hf" if vn is None else f"{hk}.to(tl.float32)"))
            elif op == "sum":
                # vm is +0.0 on null rows, so vm * hf is bitwise
                # vm * (h & ~null)
                rk = "rin" if vn is None else ops._tmp(f"rin & ~{vn}")
                vm = ops._tmp(f"tl.where({rk}, {v}, 0.0)")
                L.append(ind + f"{a} += {vm}[None, :] * hf")
            else:
                vv = ops._tmp(f"tl.where({hk}, {v}[None, :], {_FILL[op]})")
                isn = ops._tmp(f"{vv} != {vv}")
                L.append(ind + f"{f} = tl.maximum({f}, "
                         f"{isn}.to(tl.float32))")
                L.append(ind + f"{a} = {_PICK[op]}({a}, tl.where({isn}, "
                         f"{_FILL[op]}, {vv}))")
        L.append("    garange = tl.arange(0, GP)")
        for j, (op, _, _) in enumerate(self._accs):
            r = f"{_REDUCE[op]}(a{j}, axis=1)"
            if op in ("min", "max"):
                r = f"tl.where(tl.max(f{j}, axis=1) > 0, float('nan'), {r})"
            L.append(f"    r{j} = {r}")
        for k, j in enumerate(self._acc_of):
            L.append(f"    tl.store(out_ptr + {k} * out_stride + pid * G + "
                     f"garange, r{j}, mask=garange < G)")

    # --- launch -------------------------------------------------------------
    def _load_kernel(self, dtypes: tuple):
        kernel = self._kernels.get(dtypes)
        if kernel is None:
            src = self.triton_source(dtypes)
            digest = hashlib.sha1(src.encode()).hexdigest()[:16]
            path = BUILD_DIR / "triton_scan" / f"generic_scan_{digest}.py"
            if not path.exists():
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                tmp.write_text(src)
                os.replace(tmp, path)
            spec = importlib.util.spec_from_file_location(
                f"_generic_scan_{digest}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)     # imports triton
            kernel = self._kernels[dtypes] = mod.generic_scan
        return kernel

    def launch(self, consts, col_arrs, null_arrs, valid) -> torch.Tensor:
        lanes = list(col_arrs) + list(null_arrs) + [valid]
        kernel = self._load_kernel(tuple(t.dtype for t in lanes))
        grid = valid.shape[0] // BLOCK_ROWS
        width = 1 if self.G is None else self.G
        out = torch.empty((len(self.aggs) + 1, grid)
                          + (() if self.G is None else (self.G,)),
                          dtype=torch.float32, device=valid.device)
        _, sub, warps = self.config
        gp = 1 if self.G is None else max(2, _next_pow2(self.G))
        LAUNCHES["generic_scan"] += 1
        self.launches += 1
        # bool lanes go in as uint8 views (no copy)
        self.compiled = kernel[(grid,)](
            consts, *[t.view(torch.uint8) if t.dtype == torch.bool else t
                      for t in lanes],
            out, grid * width, BLOCK_ROWS=BLOCK_ROWS, SUB=sub, GP=gp,
            G=width, num_warps=warps)
        return out

    def compiled_stats(self) -> dict:
        """Form, SUB, warps, and the registers and spills a thread of
        the last launched kernel uses."""
        form, sub, warps = self.config
        ck = self.compiled
        return {"form": form, "SUB": sub, "num_warps": warps,
                "n_regs": getattr(ck, "n_regs", None),
                "n_spills": getattr(ck, "n_spills", None)}

    def partials(self, consts, col_arrs, null_arrs, valid) -> torch.Tensor:
        """Every output in one f32 buffer [n_aggs + 1, grid(, G)]: the
        aggregates' partials in order, then the row counts."""
        n = valid.shape[0]
        _check_lanes(list(col_arrs) + list(null_arrs) + [valid], n,
                     HAND_DTYPES)
        if consts.dtype != torch.float32 or consts.device != valid.device \
                or consts.shape[0] < max(self.n_consts, 1):
            raise ValueError("consts must be f32 [max(n_consts, 1)] on the "
                             "lanes' device")
        if len(col_arrs) != len(self.col_order) or \
                len(null_arrs) != len(self.null_order):
            raise ValueError("lane count does not match the signature")
        if _device_of(valid) == "cpu":
            return torch.stack(self.plain(consts, col_arrs, null_arrs,
                                          valid))
        return self.launch(consts, col_arrs, null_arrs, valid)

    def __call__(self, consts, col_arrs, null_arrs, valid):
        return tuple(self.partials(consts, col_arrs, null_arrs,
                                   valid).unbind(0))
