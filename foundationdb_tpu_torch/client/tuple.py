"""The tuple layer — order-preserving typed key encoding.

Reference: REF:bindings/python/fdb/tuple.py (+ the cross-binding tuple
spec in REF:design/tuple.md) — every FDB binding ships the same tuple
encoding so keys packed in one language sort and decode identically in
every other.  The byte comparison of ``pack(a)`` and ``pack(b)`` matches
the elementwise comparison of ``a`` and ``b``.

Typecodes (the stable cross-binding surface):

  0x00        null               (escaped as 00 FF inside nested tuples)
  0x01        byte string        (terminated 00; embedded 00 -> 00 FF)
  0x02        unicode string     (utf-8, same escaping)
  0x05        nested tuple       (terminated 00)
  0x0C..0x13  negative int, 8..1 bytes (big-endian of v + 2^(8n) - 1)
  0x14        integer zero
  0x15..0x1C  positive int, 1..8 bytes (big-endian)
  0x20        float  (IEEE754 big-endian, sign-transformed)
  0x21        double (IEEE754 big-endian, sign-transformed)
  0x26        false
  0x27        true
  0x30        UUID (16 raw bytes)
  0x33        versionstamp (12 bytes: 10 txn + 2 user)
"""

from __future__ import annotations

import struct
import uuid as _uuid
from typing import Any

NULL = 0x00
BYTES = 0x01
STRING = 0x02
NESTED = 0x05
INT_ZERO = 0x14
FLOAT = 0x20
DOUBLE = 0x21
FALSE = 0x26
TRUE = 0x27
UUID = 0x30
VERSIONSTAMP = 0x33


class Versionstamp:
    """An 80-bit transaction versionstamp + 16-bit user order."""

    __slots__ = ("bytes",)

    def __init__(self, raw: bytes = b"\xff" * 10, user: int = 0) -> None:
        if len(raw) == 12:
            self.bytes = raw
        elif len(raw) == 10:
            self.bytes = raw + struct.pack(">H", user)
        else:
            raise ValueError("versionstamp needs 10 or 12 bytes")

    def __eq__(self, other) -> bool:
        return isinstance(other, Versionstamp) and self.bytes == other.bytes

    def __hash__(self) -> int:
        return hash(self.bytes)

    def __repr__(self) -> str:
        return f"Versionstamp({self.bytes!r})"


def _escape_nul(data: bytes) -> bytes:
    return data.replace(b"\x00", b"\x00\xff")


def _float_transform(raw: bytes) -> bytes:
    """Sign-transform so byte order == numeric order: negative numbers
    flip every bit, non-negative flip only the sign bit."""
    if raw[0] & 0x80:
        return bytes(b ^ 0xFF for b in raw)
    return bytes([raw[0] ^ 0x80]) + raw[1:]


def _float_untransform(raw: bytes) -> bytes:
    if raw[0] & 0x80:
        return bytes([raw[0] ^ 0x80]) + raw[1:]
    return bytes(b ^ 0xFF for b in raw)


def _encode_one(item: Any, nested: bool, out: bytearray) -> None:
    if item is None:
        out.append(NULL)
        if nested:
            out.append(0xFF)
    elif item is True:
        out.append(TRUE)
    elif item is False:
        out.append(FALSE)
    elif isinstance(item, (bytes, bytearray)):
        out.append(BYTES)
        out += _escape_nul(bytes(item))
        out.append(0x00)
    elif isinstance(item, str):
        out.append(STRING)
        out += _escape_nul(item.encode("utf-8"))
        out.append(0x00)
    elif isinstance(item, int):
        if item == 0:
            out.append(INT_ZERO)
        elif item > 0:
            n = (item.bit_length() + 7) // 8
            if n > 8:
                raise ValueError("tuple ints limited to 8 bytes")
            out.append(INT_ZERO + n)
            out += item.to_bytes(n, "big")
        else:
            n = ((-item).bit_length() + 7) // 8
            if n > 8:
                raise ValueError("tuple ints limited to 8 bytes")
            out.append(INT_ZERO - n)
            out += (item + (1 << (8 * n)) - 1).to_bytes(n, "big")
    elif isinstance(item, float):
        out.append(DOUBLE)
        out += _float_transform(struct.pack(">d", item))
    elif isinstance(item, _uuid.UUID):
        out.append(UUID)
        out += item.bytes
    elif isinstance(item, Versionstamp):
        out.append(VERSIONSTAMP)
        out += item.bytes
    elif isinstance(item, (tuple, list)):
        out.append(NESTED)
        for x in item:
            _encode_one(x, True, out)
        out.append(0x00)
    else:
        raise TypeError(f"cannot pack {type(item).__name__} into a tuple key")


def pack(t: tuple | list) -> bytes:
    """Pack a tuple into an order-preserving byte string."""
    out = bytearray()
    for item in t:
        _encode_one(item, False, out)
    return bytes(out)


def _find_terminator(data: bytes, pos: int) -> int:
    """Index of the unescaped 0x00 terminating a string at ``pos``."""
    while True:
        i = data.index(b"\x00", pos)
        if i + 1 < len(data) and data[i + 1] == 0xFF:
            pos = i + 2
            continue
        return i


def _decode_one(data: bytes, pos: int, nested: bool) -> tuple[Any, int]:
    code = data[pos]
    if code == NULL:
        if nested and pos + 1 < len(data) and data[pos + 1] == 0xFF:
            return None, pos + 2
        return None, pos + 1
    if code == BYTES or code == STRING:
        end = _find_terminator(data, pos + 1)
        raw = data[pos + 1:end].replace(b"\x00\xff", b"\x00")
        return (raw if code == BYTES else raw.decode("utf-8")), end + 1
    if code == NESTED:
        items: list[Any] = []
        p = pos + 1
        while True:
            if data[p] == 0x00:
                if p + 1 < len(data) and data[p + 1] == 0xFF:
                    items.append(None)
                    p += 2
                    continue
                return tuple(items), p + 1
            item, p = _decode_one(data, p, True)
            items.append(item)
    if INT_ZERO - 8 <= code <= INT_ZERO + 8:
        n = code - INT_ZERO
        if n == 0:
            return 0, pos + 1
        if n > 0:
            return int.from_bytes(data[pos + 1:pos + 1 + n], "big"), pos + 1 + n
        n = -n
        v = int.from_bytes(data[pos + 1:pos + 1 + n], "big")
        return v - (1 << (8 * n)) + 1, pos + 1 + n
    if code == DOUBLE:
        raw = _float_untransform(data[pos + 1:pos + 9])
        return struct.unpack(">d", raw)[0], pos + 9
    if code == FLOAT:
        raw = _float_untransform(data[pos + 1:pos + 5])
        return struct.unpack(">f", raw)[0], pos + 5
    if code == TRUE:
        return True, pos + 1
    if code == FALSE:
        return False, pos + 1
    if code == UUID:
        return _uuid.UUID(bytes=data[pos + 1:pos + 17]), pos + 17
    if code == VERSIONSTAMP:
        return Versionstamp(data[pos + 1:pos + 13]), pos + 13
    raise ValueError(f"unknown tuple typecode 0x{code:02x} at {pos}")


def unpack(data: bytes) -> tuple:
    """Inverse of pack."""
    items: list[Any] = []
    pos = 0
    while pos < len(data):
        item, pos = _decode_one(data, pos, False)
        items.append(item)
    return tuple(items)


def range_of(t: tuple | list) -> tuple[bytes, bytes]:
    """The key range containing exactly the tuples extending ``t``
    (fdb.tuple.range): [pack(t)+\\x00, pack(t)+\\xff)."""
    p = pack(t)
    return p + b"\x00", p + b"\xff"
