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

Every kernel emits per-4096-row-block partials, as the Pallas kernels
did; the callers combine them.  Each wrapper dispatches on the device
of the tensors it is given: on CPU tensors it runs the plain version
(the tests' route); on CUDA tensors it launches the kernel or raises —
there is no fallback.  ``LAUNCHES`` counts kernel launches, and only
those.

All three are bound by memory traffic on an H100 (see each source's
note): the design goal is one read of every input lane.

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
                            "generic_scan": 0}


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
_CUDA_SOURCES = ("q6_scan", "grouped_sum")


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
            else:
                lib.grouped_sum_launch.argtypes = [vp, vp, vp, ci, vp,
                                                   ci, vp]
                lib.grouped_sum_launch.restype = ci
                lib.grouped_sum_max_groups.argtypes = []
                lib.grouped_sum_max_groups.restype = ci
            _libs[name] = lib
        return lib


def _check_lanes(lanes: Sequence[torch.Tensor], n: int) -> None:
    for t in lanes:
        if t.dtype != torch.float32 or t.dim() != 1 or t.shape[0] != n \
                or not t.is_contiguous() or t.device != lanes[0].device \
                or (t.device.type == "cuda" and t.data_ptr() % 16):
            raise ValueError(
                "hand kernels take contiguous, 16-byte aligned f32 [N] "
                "lanes on one device, N a multiple of 4096")
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
            f"grouped_sum kernel takes 1..{max_g} groups (shared-memory "
            f"accumulator), got {num_groups}")
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


class TritonOps:
    """Operator backend for expr._lower that emits Triton statements.
    Values are variable names; every lane is f32 (the kernel's
    contract), so no promotion is needed."""

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


_TRITON_PRELUDE = '''\
import triton
import triton.language as tl
try:
    from triton.language.extra import libdevice
except ImportError:                  # Triton 3.0 keeps it under extra.cuda
    from triton.language.extra.cuda import libdevice

'''


class GenericScan:
    """K3 for one query signature — counterpart of the reference's
    ``build_generic_scan`` (which took compiled aggregate fns; K3 needs
    the ASTs to generate its source): fn(consts f32 [max(n_consts,1)],
    col lanes, null lanes, valid) -> per-aggregate partials ([grid] or
    [grid, G]) followed by the row-count partials, all f32.

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
        self._kernel = None
        #: this signature's own kernel launches (LAUNCHES has the total)
        self.launches = 0

    # --- plain version ---------------------------------------------------
    def plain(self, consts, col_arrs, null_arrs, valid):
        n = valid.shape[0]
        grid = n // BLOCK_ROWS
        shp = (grid, BLOCK_ROWS)
        f32 = torch.float32
        cols = {cid: col_arrs[i].view(shp)
                for i, cid in enumerate(self.col_order)}
        nulls = {cid: null_arrs[i].view(shp) > 0
                 for i, cid in enumerate(self.null_order)}
        cs = [consts[i] for i in range(self.n_consts)]
        mask = valid.view(shp) > 0
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
            c = (cols[cid].to(f32) - offset).clamp(0.0, float(domain - 1))
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
    def triton_source(self) -> str:
        """The kernel specialised to this signature, generated from the
        same expression walk as compile_expr (TritonOps backend)."""
        grouped = self.G is not None
        n_out = len(self.aggs) + 1
        args = (["consts_ptr"]
                + [f"x{i}_ptr" for i in range(len(self.col_order))]
                + [f"n{i}_ptr" for i in range(len(self.null_order))]
                + ["valid_ptr"] + [f"o{k}_ptr" for k in range(n_out)])
        L = [_TRITON_PRELUDE, "@triton.jit",
             "def generic_scan(" + ", ".join(args) + ",",
             "                 BLOCK_ROWS: tl.constexpr, SUB: tl.constexpr,"
             " GP: tl.constexpr, G: tl.constexpr):",
             "    pid = tl.program_id(0)",
             "    base = pid.to(tl.int64) * BLOCK_ROWS"]
        for i in range(self.n_consts):
            L.append(f"    c{i} = tl.load(consts_ptr + {i})")
        width = "GP" if grouped else "SUB"
        # accumulators: per agg (and NaN flags for min/max)
        ops_all = [op for op, _ in self.aggs] + ["count"]
        for k, op in enumerate(ops_all):
            if op in ("min", "max"):
                init = "float('inf')" if op == "min" else "-float('inf')"
                L.append(f"    a{k} = tl.full([{width}], {init}, "
                         f"tl.float32)")
                L.append(f"    nan{k} = tl.zeros([{width}], "
                         f"dtype=tl.float32)")
            else:
                L.append(f"    a{k} = tl.zeros([{width}], dtype=tl.float32)")
        L.append("    for s in range(0, BLOCK_ROWS, SUB):")
        ind = "        "
        L.append(ind + "offs = base + s + tl.arange(0, SUB)")
        cols = {}
        for i, cid in enumerate(self.col_order):
            L.append(ind + f"x{i} = tl.load(x{i}_ptr + offs)")
            cols[cid] = f"x{i}"
        nulls = {}
        for i, cid in enumerate(self.null_order):
            L.append(ind + f"n{i} = tl.load(n{i}_ptr + offs) > 0")
            nulls[cid] = f"n{i}"
        L.append(ind + "mask = tl.load(valid_ptr + offs) > 0")
        consts = [f"c{i}" for i in range(self.n_consts)]
        ops = TritonOps(L, ind)
        if self.where is not None:
            wv, wn = _lower(self.where, ops, 0)(cols, nulls, consts)
            L.append(ind + f"mask = mask & {wv}")
            if wn is not None:
                L.append(ind + f"mask = mask & ~{wn}")
        if grouped:
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
            L.append(ind + "maskf = mask.to(tl.float32)")
            L.append(ind + "garange = tl.arange(0, GP)")
            L.append(ind + f"onehot = ({gid}.to(tl.int32)[:, None] == "
                     "garange[None, :]).to(tl.float32) * maskf[:, None]")
        else:
            L.append(ind + "maskf = mask.to(tl.float32)")
        for k, (op, e) in enumerate(list(self.aggs) + [("count", None)]):
            a = f"a{k}"
            if e is None:
                if grouped:
                    L.append(ind + f"{a} += tl.sum(onehot, axis=0)")
                else:
                    L.append(ind + f"{a} += maskf")
                continue
            v, vn = _lower(e, ops, self._offsets[k])(cols, nulls, consts)
            v = ops._tmp(f"tl.broadcast_to(({v}).to(tl.float32), (SUB,))")
            if grouped:
                oh = "onehot" if vn is None else ops._tmp(
                    f"onehot * (~{vn}).to(tl.float32)[:, None]")
                if op == "count":
                    L.append(ind + f"{a} += tl.sum({oh}, axis=0)")
                elif op == "sum":
                    rm = ops._tmp(f"tl.max({oh}, axis=1)")
                    vm = ops._tmp(f"tl.where({rm} > 0, {v}, 0.0)")
                    L.append(ind + f"{a} += tl.sum({vm}[:, None] * {oh}, "
                             "axis=0)")
                else:
                    fill = "float('inf')" if op == "min" else \
                        "-float('inf')"
                    red = "tl.min" if op == "min" else "tl.max"
                    pick = "tl.minimum" if op == "min" else "tl.maximum"
                    vv = ops._tmp(f"tl.where({oh} > 0, {v}[:, None], "
                                  f"{fill})")
                    isn = ops._tmp(f"{vv} != {vv}")
                    L.append(ind + f"nan{k} = tl.maximum(nan{k}, tl.max("
                             f"{isn}.to(tl.float32), axis=0))")
                    L.append(ind + f"{a} = {pick}({a}, {red}(tl.where("
                             f"{isn}, {fill}, {vv}), axis=0))")
                continue
            m = "maskf" if vn is None else ops._tmp(
                f"maskf * (~{vn}).to(tl.float32)")
            if op == "count":
                L.append(ind + f"{a} += {m}")
            elif op == "sum":
                L.append(ind + f"{a} += tl.where({m} > 0, {v}, 0.0)")
            else:
                fill = "float('inf')" if op == "min" else "-float('inf')"
                pick = "tl.minimum" if op == "min" else "tl.maximum"
                vv = ops._tmp(f"tl.where({m} > 0, {v}, {fill})")
                isn = ops._tmp(f"{vv} != {vv}")
                L.append(ind + f"nan{k} = tl.maximum(nan{k}, "
                         f"{isn}.to(tl.float32))")
                L.append(ind + f"{a} = {pick}({a}, tl.where({isn}, {fill},"
                         f" {vv}))")
        # epilogue: one partial (or one [G] row) per block
        for k, op in enumerate(ops_all):
            a = f"a{k}"
            if grouped:
                r = a
            elif op in ("min", "max"):
                red = "tl.min" if op == "min" else "tl.max"
                r = f"{red}({a}, axis=0)"
            else:
                r = f"tl.sum({a}, axis=0)"
            if op in ("min", "max"):
                flag = f"nan{k}" if grouped else f"tl.max(nan{k}, axis=0)"
                L.append(f"    r{k} = tl.where({flag} > 0, float('nan'), "
                         f"{r})")
            else:
                L.append(f"    r{k} = {r}")
            if grouped:
                L.append(f"    tl.store(o{k}_ptr + pid * G + "
                         f"tl.arange(0, GP), r{k}, "
                         f"mask=tl.arange(0, GP) < G)")
            else:
                L.append(f"    tl.store(o{k}_ptr + pid, r{k})")
        return "\n".join(L) + "\n"

    def _load_kernel(self):
        if self._kernel is None:
            src = self.triton_source()
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
            self._kernel = mod.generic_scan
        return self._kernel

    def launch(self, consts, col_arrs, null_arrs, valid):
        kernel = self._load_kernel()
        n = valid.shape[0]
        grid = n // BLOCK_ROWS
        dev = valid.device
        if self.G is None:
            gp, sub, g = 1, 1024, 1
            shapes = [(grid,)] * (len(self.aggs) + 1)
        else:
            gp = max(2, _next_pow2(self.G))
            sub, g = max(16, min(1024, 8192 // gp)), self.G
            shapes = [(grid, self.G)] * (len(self.aggs) + 1)
        outs = [torch.empty(s, dtype=torch.float32, device=dev)
                for s in shapes]
        LAUNCHES["generic_scan"] += 1
        self.launches += 1
        kernel[(grid,)](consts, *col_arrs, *null_arrs, valid, *outs,
                        BLOCK_ROWS=BLOCK_ROWS, SUB=sub, GP=gp, G=g,
                        num_warps=8 if self.G is not None else 4)
        return tuple(outs)

    def __call__(self, consts, col_arrs, null_arrs, valid):
        n = valid.shape[0]
        lanes = list(col_arrs) + list(null_arrs) + [valid]
        _check_lanes(lanes, n)
        if consts.dtype != torch.float32 or consts.device != valid.device \
                or consts.shape[0] < max(self.n_consts, 1):
            raise ValueError("consts must be f32 [max(n_consts, 1)] on the "
                             "lanes' device")
        if len(col_arrs) != len(self.col_order) or \
                len(null_arrs) != len(self.null_order):
            raise ValueError("lane count does not match the signature")
        if _device_of(valid) == "cpu":
            return self.plain(consts, col_arrs, null_arrs, valid)
        return self.launch(consts, col_arrs, null_arrs, valid)

