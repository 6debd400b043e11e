"""The subset of MessagePack that checkpoint metadata uses: maps, strings,
integers, arrays (tuples pack as arrays) and nil. It packs to the same
bytes as ``msgpack.packb`` with its defaults (strings as str8/16/32,
integers in their shortest form) and unpacks that subset, so the port
reads and writes the reference's ``meta.msgpack`` without the ``msgpack``
package."""
from __future__ import annotations

import struct


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, int) and not isinstance(obj, bool):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack_lite cannot pack {type(obj).__name__}")


def _pack_len(n: int, out: bytearray, fix: int, fix_limit: int, wide: tuple) -> None:
    """A length header: the fix form below ``fix_limit``, else the 8-, 16-
    or 32-bit form (``wide``; None where the type has no 8-bit form)."""
    if n < fix_limit:
        out.append(fix | n)
    elif wide[0] is not None and n <= 0xFF:
        out += bytes((wide[0], n))
    elif n <= 0xFFFF:
        out.append(wide[1])
        out += struct.pack(">H", n)
    else:
        out.append(wide[2])
        out += struct.pack(">I", n)


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt, hi in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if v <= hi:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                              (0xD2, ">i", -0x80000000), (0xD3, ">q", -2 ** 63)):
            if v >= lo:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(v)


_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
         0xD2: ">i", 0xD3: ">q"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


def unpackb(data: bytes):
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"msgpack_lite: {len(data) - end} trailing bytes")
    return obj


def _unpack(b: memoryview, i: int):
    c = b[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if c == 0xC0:
        return None, i
    if c in _INTS:
        fmt = _INTS[c]
        n = struct.calcsize(fmt)
        return struct.unpack(fmt, b[i:i + n])[0], i + n
    if 0xA0 <= c < 0xC0 or c in (0xD9, 0xDA, 0xDB):
        n, i = _length(b, i, c, 0xA0)
        return bytes(b[i:i + n]).decode("utf-8"), i + n
    if 0x90 <= c < 0xA0 or c in (0xDC, 0xDD):
        n, i = _length(b, i, c, 0x90)
        out = []
        for _ in range(n):
            v, i = _unpack(b, i)
            out.append(v)
        return out, i
    if 0x80 <= c < 0x90 or c in (0xDE, 0xDF):
        n, i = _length(b, i, c, 0x80)
        out = {}
        for _ in range(n):
            k, i = _unpack(b, i)
            out[k], i = _unpack(b, i)
        return out, i
    raise ValueError(f"msgpack_lite: unsupported type byte 0x{c:02x}")


def _length(b: memoryview, i: int, c: int, fix: int):
    if c in _LEN:
        fmt = _LEN[c]
        n = struct.calcsize(fmt)
        return struct.unpack(fmt, b[i:i + n])[0], i + n
    return c - fix, i
