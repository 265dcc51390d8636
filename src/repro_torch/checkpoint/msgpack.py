"""The subset of MessagePack a checkpoint's ``.meta`` file uses, packed
and unpacked by hand (the port depends on no ``msgpack`` package).

``packb`` writes the bytes ``msgpack.packb`` writes for the same object —
each value in its smallest encoding, strings as UTF-8 ``str`` (the
``use_bin_type=True`` format family) — so the two packages' ``.meta``
files are byte-equal; ``unpackb`` reads them back as ``msgpack.unpackb``
does (maps to dicts, arrays to lists, strings to ``str``). Types: nil,
int (-2**63 .. 2**64 - 1), str, list / tuple, dict; anything else raises.
"""
from __future__ import annotations

import struct


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16- or
    32-bit form (``codes`` lists their type bytes; None where absent)."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, lim in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < lim:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} is beyond MessagePack's 32-bit lengths")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit MessagePack's uint64")
    else:
        for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                               (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit MessagePack's int64")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, int) and not isinstance(obj, bool):
        _int(out, obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for x in obj:
            _pack(out, x)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} (the checkpoint "
                        "metadata holds nil, int, str, lists and maps)")


def packb(obj) -> bytes:
    """``msgpack.packb(obj)``'s bytes."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if c == 0xC0:
            return None
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in ints:
            return self.num(ints[c])
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in lens:
            return self.take(self.num(lens[c])).decode("utf-8")
        if c in (0xDC, 0xDD):
            n = self.num(">H" if c == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if c in (0xDE, 0xDF):
            return self.map(self.num(">H" if c == 0xDE else ">I"))
        raise ValueError(f"MessagePack type byte 0x{c:02x} is outside the "
                         "checkpoint metadata's subset")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a string")
            out[k] = self.value()
        return out


def unpackb(data: bytes):
    """``msgpack.unpackb(data)`` for the subset above."""
    r = _Reader(bytes(data))
    obj = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} extra bytes after the "
                         "MessagePack object")
    return obj
