"""MessagePack codec for the SST file's headers.

The reference writes its columnar block headers, SST index and footer
with ``msgpack.packb`` (``yugabyte_db_tpu/storage/columnar.py:458,556``,
``storage/sst.py:365,380``).  The port must not depend on the
``msgpack`` package, so it keeps this codec of its own, for exactly the
types those headers hold: dict, list/tuple, str, bytes (bytearray,
memoryview), int from -2**63 to 2**64-1, float (float64), bool and None.

``packb`` produces the bytes ``msgpack.packb`` produces for the same
value with its defaults (``use_bin_type=True``, the smallest encoding of
each integer, float64 for every float), so port files and reference
files are interchangeable.  ``unpackb`` reads every standard MessagePack
format but ext types, as ``msgpack.unpackb(raw=False, use_list=True)``
does: arrays come back as lists, str as str, bin as bytes.  Anything
else raises ``TypeError`` (pack) or ``ValueError`` (unpack)."""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _pack_int(v: int, out: List[bytes]) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(_B.pack(v))
        elif v <= 0xFF:
            out.append(b"\xcc" + _B.pack(v))
        elif v <= 0xFFFF:
            out.append(b"\xcd" + _H.pack(v))
        elif v <= 0xFFFFFFFF:
            out.append(b"\xce" + _I.pack(v))
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + _Q.pack(v))
        else:
            raise OverflowError(f"int {v} is too large for MessagePack")
    elif v >= -32:
        out.append(_b.pack(v))
    elif v >= -0x80:
        out.append(b"\xd0" + _b.pack(v))
    elif v >= -0x8000:
        out.append(b"\xd1" + _h.pack(v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + _i.pack(v))
    elif v >= -0x8000000000000000:
        out.append(b"\xd3" + _q.pack(v))
    else:
        raise OverflowError(f"int {v} is too small for MessagePack")


def _pack_len(n: int, fix_base: int, fix_max: int, codes: Tuple[int, ...],
              out: List[bytes]) -> None:
    """Header of a str/bin/array/map of `n` items: the fix form when
    `fix_base` is set and n <= fix_max, else the 8/16/32-bit length form
    (codes holds the 8-, 16- and 32-bit marker; 0 where absent)."""
    if fix_base is not None and n <= fix_max:
        out.append(_B.pack(fix_base | n))
    elif codes[0] and n <= 0xFF:
        out.append(_B.pack(codes[0]) + _B.pack(n))
    elif n <= 0xFFFF:
        out.append(_B.pack(codes[1]) + _H.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(_B.pack(codes[2]) + _I.pack(n))
    else:
        raise ValueError(f"{n} items is too many for MessagePack")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(b"\xcb" + _d.pack(obj))
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (0, 0xDC, 0xDD), out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (0, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        # msgpack.packb refuses numpy scalars and other types alike
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def unpackb(data) -> Any:
    buf = bytes(data)
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} extra bytes after the object")
    return obj


def _take(buf: bytes, pos: int, n: int) -> Tuple[bytes, int]:
    end = pos + n
    if end > len(buf):
        raise ValueError("truncated MessagePack data")
    return buf[pos:end], end


def _unpack(buf: bytes, pos: int) -> Tuple[Any, int]:
    if pos >= len(buf):
        raise ValueError("truncated MessagePack data")
    c = buf[pos]
    pos += 1
    if c < 0x80:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if c & 0xF0 == 0x80:
        return _unpack_map(buf, pos, c & 0x0F)
    if c & 0xF0 == 0x90:
        return _unpack_array(buf, pos, c & 0x0F)
    if c & 0xE0 == 0xA0:
        raw, pos = _take(buf, pos, c & 0x1F)
        return raw.decode("utf-8"), pos
    if c == 0xC0:
        return None, pos
    if c == 0xC2:
        return False, pos
    if c == 0xC3:
        return True, pos
    fixed = {0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q, 0xD0: _b, 0xD1: _h,
             0xD2: _i, 0xD3: _q, 0xCA: _f, 0xCB: _d}.get(c)
    if fixed is not None:
        raw, pos = _take(buf, pos, fixed.size)
        return fixed.unpack(raw)[0], pos
    sized = {0xD9: (_B, "str"), 0xDA: (_H, "str"), 0xDB: (_I, "str"),
             0xC4: (_B, "bin"), 0xC5: (_H, "bin"), 0xC6: (_I, "bin"),
             0xDC: (_H, "array"), 0xDD: (_I, "array"),
             0xDE: (_H, "map"), 0xDF: (_I, "map")}.get(c)
    if sized is None:
        raise ValueError(f"unsupported MessagePack type byte 0x{c:02x}")
    st, kind = sized
    raw, pos = _take(buf, pos, st.size)
    n = st.unpack(raw)[0]
    if kind == "array":
        return _unpack_array(buf, pos, n)
    if kind == "map":
        return _unpack_map(buf, pos, n)
    raw, pos = _take(buf, pos, n)
    return (raw.decode("utf-8") if kind == "str" else raw), pos


def _unpack_array(buf: bytes, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        x, pos = _unpack(buf, pos)
        out.append(x)
    return out, pos


def _unpack_map(buf: bytes, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        if isinstance(k, list):
            raise ValueError("unhashable map key")
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos
