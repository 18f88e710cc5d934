"""A small msgpack codec for the subset the state blob uses.

The state blob's payload is msgpack. The port carries its own codec so
it needs no msgpack package: :func:`packb` writes the bytes that
``msgpack.packb(obj, use_bin_type=True)`` writes for maps, arrays, str,
bin (bytes / bytearray / memoryview), int, float (as float64), nil and
bool, and :func:`unpackb` reads them back as
``msgpack.unpackb(data, raw=False)`` does (bin -> bytes, array -> list).
Anything else raises ``TypeError`` / ``ValueError``.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def pack_into(obj: Any, out) -> None:
    """``packb(obj)``'s bytes handed piece by piece to ``out.append``,
    never joined: a digest of a large payload without a second copy."""
    _pack(obj, out)


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(bytes([0xA0 | n]))
        elif n < 1 << 8:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xda" + struct.pack(">H", n))
        elif n < 1 << 32:
            out.append(b"\xdb" + struct.pack(">I", n))
        else:
            raise ValueError("str too long for msgpack")
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = obj.cast("B") if isinstance(obj, memoryview) else obj
        n = len(raw)
        if n < 1 << 8:
            out.append(b"\xc4" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xc5" + struct.pack(">H", n))
        elif n < 1 << 32:
            out.append(b"\xc6" + struct.pack(">I", n))
        else:
            raise ValueError("bin too long for msgpack")
        out.append(bytes(raw))
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x90 | n]))
        elif n < 1 << 16:
            out.append(b"\xdc" + struct.pack(">H", n))
        else:
            out.append(b"\xdd" + struct.pack(">I", n))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x80 | n]))
        elif n < 1 << 16:
            out.append(b"\xde" + struct.pack(">H", n))
        else:
            out.append(b"\xdf" + struct.pack(">I", n))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        if v < 1 << 8:
            return b"\xcc" + struct.pack(">B", v)
        if v < 1 << 16:
            return b"\xcd" + struct.pack(">H", v)
        if v < 1 << 32:
            return b"\xce" + struct.pack(">I", v)
        if v < 1 << 64:
            return b"\xcf" + struct.pack(">Q", v)
        raise ValueError("int too large for msgpack")
    if v >= -(1 << 7):
        return b"\xd0" + struct.pack(">b", v)
    if v >= -(1 << 15):
        return b"\xd1" + struct.pack(">h", v)
    if v >= -(1 << 31):
        return b"\xd2" + struct.pack(">i", v)
    if v >= -(1 << 63):
        return b"\xd3" + struct.pack(">q", v)
    raise ValueError("int too small for msgpack")


# fixed-width formats: tag -> (struct format, byte count)
_FIXED = {
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
    0xCA: (">f", 4), 0xCB: (">d", 8),
}
_LEN = {0xD9: (">B", 1), 0xDA: (">H", 2), 0xDB: (">I", 4),     # str
        0xC4: (">B", 1), 0xC5: (">H", 2), 0xC6: (">I", 4),     # bin
        0xDC: (">H", 2), 0xDD: (">I", 4),                      # array
        0xDE: (">H", 2), 0xDF: (">I", 4)}                      # map


def unpackb(data) -> Any:
    buf = memoryview(data).cast("B")
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"msgpack: {len(buf) - pos} trailing bytes")
    return obj


def _take(buf: memoryview, pos: int, n: int) -> Tuple[memoryview, int]:
    if pos + n > len(buf):
        raise ValueError("msgpack: truncated input")
    return buf[pos:pos + n], pos + n


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    if pos >= len(buf):
        raise ValueError("msgpack: truncated input")
    tag = buf[pos]
    pos += 1
    if tag <= 0x7F:
        return tag, pos
    if tag >= 0xE0:
        return tag - 0x100, pos
    if 0x80 <= tag <= 0x8F:
        return _unpack_map(buf, pos, tag & 0x0F)
    if 0x90 <= tag <= 0x9F:
        return _unpack_array(buf, pos, tag & 0x0F)
    if 0xA0 <= tag <= 0xBF:
        raw, pos = _take(buf, pos, tag & 0x1F)
        return str(raw, "utf-8"), pos
    if tag == 0xC0:
        return None, pos
    if tag == 0xC2:
        return False, pos
    if tag == 0xC3:
        return True, pos
    if tag in _FIXED:
        fmt, n = _FIXED[tag]
        raw, pos = _take(buf, pos, n)
        return struct.unpack(fmt, raw)[0], pos
    if tag in _LEN:
        fmt, n = _LEN[tag]
        raw, pos = _take(buf, pos, n)
        length = struct.unpack(fmt, raw)[0]
        if tag in (0xD9, 0xDA, 0xDB):
            raw, pos = _take(buf, pos, length)
            return str(raw, "utf-8"), pos
        if tag in (0xC4, 0xC5, 0xC6):
            raw, pos = _take(buf, pos, length)
            return bytes(raw), pos
        if tag in (0xDC, 0xDD):
            return _unpack_array(buf, pos, length)
        return _unpack_map(buf, pos, length)
    raise ValueError(f"msgpack: unsupported type tag 0x{tag:02x}")


def _unpack_array(buf: memoryview, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        item, pos = _unpack(buf, pos)
        out.append(item)
    return out, pos


def _unpack_map(buf: memoryview, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos
