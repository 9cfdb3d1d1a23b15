"""Tuple layer: order-preserving encoding of typed tuples into keys.

The port's own copy of the reference package's ``layers/tuple.py``.

Ref: bindings/python/fdb/tuple.py and the tuple-layer spec
(design/tuple.md in later reference versions; the 6.0 Python binding
implements the same codes).  The defining property: unpack(pack(t)) == t
and pack(t1) < pack(t2) iff t1 sorts before t2 element-wise — so tuples
index correctly as keys.

Type codes (the spec's):
  0x00 null            0x01 bytes          0x02 unicode
  0x05 nested tuple    0x0c-0x1c ints      0x20 float  0x21 double
  0x26 false 0x27 true 0x30 uuid           0x33 versionstamp

This is a from-scratch implementation of the documented format (value
layouts reconstructed from the spec, not the binding's code).
"""

from __future__ import annotations

import struct
import uuid as _uuid
from typing import Any, Iterable, Tuple

NULL = 0x00
BYTES = 0x01
STRING = 0x02
NESTED = 0x05
INT_ZERO = 0x14  # 0x14-n .. 0x14+n for n-byte negative/positive ints
FLOAT = 0x20
DOUBLE = 0x21
FALSE = 0x26
TRUE = 0x27
UUID = 0x30
VERSIONSTAMP = 0x33


class Versionstamp:
    """An 80-bit commit version + 16-bit batch order + 16-bit user order
    (ref: fdb.tuple.Versionstamp)."""

    __slots__ = ("tr_version", "user_version")

    def __init__(self, tr_version: bytes = b"\xff" * 10, user_version: int = 0):
        assert len(tr_version) == 10
        self.tr_version = tr_version
        self.user_version = user_version

    def is_complete(self) -> bool:
        return self.tr_version != b"\xff" * 10

    def to_bytes(self) -> bytes:
        return self.tr_version + struct.pack(">H", self.user_version)

    def __eq__(self, other):
        return (
            isinstance(other, Versionstamp)
            and self.tr_version == other.tr_version
            and self.user_version == other.user_version
        )

    def __hash__(self):
        return hash((self.tr_version, self.user_version))

    def __repr__(self):
        return f"Versionstamp({self.tr_version!r}, {self.user_version})"


def _encode_bytes_escaped(out: bytearray, b: bytes):
    out.extend(b.replace(b"\x00", b"\x00\xff"))
    out.append(0x00)


def _float_tr(b: bytes) -> bytes:
    """Order-preserving IEEE transform: negative numbers flip every bit,
    non-negative flip only the sign bit (spec's float encoding)."""
    if b[0] & 0x80:
        return bytes(x ^ 0xFF for x in b)
    return bytes([b[0] ^ 0x80]) + b[1:]


def _float_untr(b: bytes) -> bytes:
    if b[0] & 0x80:  # transformed non-negative
        return bytes([b[0] ^ 0x80]) + b[1:]
    return bytes(x ^ 0xFF for x in b)


def _encode_one(out: bytearray, v: Any, nested: bool):
    if v is None:
        out.append(NULL)
        if nested:
            # Inside a nested tuple, null escapes so the terminator stays
            # unambiguous (spec: 0x00 0xff).
            out.append(0xFF)
    elif v is True:
        out.append(TRUE)
    elif v is False:
        out.append(FALSE)
    elif isinstance(v, bytes):
        out.append(BYTES)
        _encode_bytes_escaped(out, v)
    elif isinstance(v, str):
        out.append(STRING)
        _encode_bytes_escaped(out, v.encode("utf-8"))
    elif isinstance(v, int):
        if v == 0:
            out.append(INT_ZERO)
        elif v > 0:
            n = (v.bit_length() + 7) // 8
            if n > 8:
                raise ValueError("int too large for tuple encoding")
            out.append(INT_ZERO + n)
            out.extend(v.to_bytes(n, "big"))
        else:
            n = ((-v).bit_length() + 7) // 8
            if n > 8:
                raise ValueError("int too large for tuple encoding")
            out.append(INT_ZERO - n)
            # Offset encoding: v + (2^(8n) - 1), big-endian — preserves
            # order among negatives and below all positives.
            out.extend((v + (1 << (8 * n)) - 1).to_bytes(n, "big"))
    elif isinstance(v, float):
        out.append(DOUBLE)
        out.extend(_float_tr(struct.pack(">d", v)))
    elif isinstance(v, _uuid.UUID):
        out.append(UUID)
        out.extend(v.bytes)
    elif isinstance(v, Versionstamp):
        out.append(VERSIONSTAMP)
        out.extend(v.to_bytes())
    elif isinstance(v, (tuple, list)):
        out.append(NESTED)
        for x in v:
            _encode_one(out, x, nested=True)
        out.append(0x00)
    else:
        raise TypeError(f"unpackable tuple element: {type(v)}")


def pack(t: Iterable[Any]) -> bytes:
    out = bytearray()
    for v in t:
        _encode_one(out, v, nested=False)
    return bytes(out)


def _decode_escaped(b: bytes, pos: int) -> Tuple[bytes, int]:
    out = bytearray()
    while True:
        i = b.index(b"\x00", pos)
        out.extend(b[pos:i])
        if i + 1 < len(b) and b[i + 1] == 0xFF:
            out.append(0x00)
            pos = i + 2
        else:
            return bytes(out), i + 1


def _decode_one(b: bytes, pos: int, nested: bool) -> Tuple[Any, int]:
    code = b[pos]
    pos += 1
    if code == NULL:
        if nested:
            assert b[pos] == 0xFF
            return None, pos + 1
        return None, pos
    if code == TRUE:
        return True, pos
    if code == FALSE:
        return False, pos
    if code == BYTES:
        return _decode_escaped(b, pos)
    if code == STRING:
        s, pos = _decode_escaped(b, pos)
        return s.decode("utf-8"), pos
    if INT_ZERO - 8 <= code <= INT_ZERO + 8:
        n = code - INT_ZERO
        if n == 0:
            return 0, pos
        if n > 0:
            return int.from_bytes(b[pos : pos + n], "big"), pos + n
        n = -n
        return (
            int.from_bytes(b[pos : pos + n], "big") - (1 << (8 * n)) + 1,
            pos + n,
        )
    if code == DOUBLE:
        return struct.unpack(">d", _float_untr(b[pos : pos + 8]))[0], pos + 8
    if code == FLOAT:
        return struct.unpack(">f", _float_untr(b[pos : pos + 4]))[0], pos + 4
    if code == UUID:
        return _uuid.UUID(bytes=b[pos : pos + 16]), pos + 16
    if code == VERSIONSTAMP:
        vs = Versionstamp(
            b[pos : pos + 10], struct.unpack(">H", b[pos + 10 : pos + 12])[0]
        )
        return vs, pos + 12
    if code == NESTED:
        items = []
        while True:
            if b[pos] == 0x00 and not (
                pos + 1 < len(b) and b[pos + 1] == 0xFF
            ):
                return tuple(items), pos + 1
            v, pos = _decode_one(b, pos, nested=True)
            items.append(v)
    raise ValueError(f"unknown tuple type code {code:#x} at {pos - 1}")


def unpack(b: bytes) -> tuple:
    items = []
    pos = 0
    while pos < len(b):
        v, pos = _decode_one(b, pos, nested=False)
        items.append(v)
    return tuple(items)


def range_of(t: Iterable[Any]) -> Tuple[bytes, bytes]:
    """(begin, end) covering every key that extends tuple t (ref:
    fdb.tuple.range)."""
    p = pack(t)
    return p + b"\x00", p + b"\xff"
