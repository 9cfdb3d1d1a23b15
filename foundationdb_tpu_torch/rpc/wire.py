"""Versioned tagged binary wire serialization.

The port's own copy of the reference package's ``rpc/wire.py``, its
pure-Python codec (modelled on flow/serialize.h:80-188, where every struct
is versioned and unknown data is rejected loudly).  The frames are byte for
byte the reference's; the reference's optional C accelerator is not part of
the port, so ``encode_frame``/``decode_frame`` are the Python codec.

Properties:
  - Tagged binary values: None/bool/int/float/bytes/str/list/tuple/dict
    plus a STRUCT tag for the registered dataclasses that define the RPC
    protocol (interfaces.py et al) and an ENUM tag for IntEnums.
  - One format-version byte per frame; mismatches error loudly.
  - Struct schema evolution: fields are written positionally in declared
    order with an explicit count.  A decoder seeing FEWER fields than it
    knows fills the rest from dataclass defaults (old peer, new field); a
    decoder seeing MORE fields than it knows rejects the frame (new peer
    talking to old code — reject-unknown, loudly, like the reference's
    protocol-version gate).
  - Decoding constructs data only — no code execution, no attribute
    lookup driven by wire bytes beyond the fixed registry.  Every length
    is bounds-checked against the frame; depth is capped.  Malformed
    input raises WireDecodeError, never anything else.

The struct registry is keyed by crc32(class name) & 0xFFFF, derived — not
assigned — so both peers compute identical ids from identical protocol
definitions; a name collision fails registration loudly at import time.
The registry holds the port's protocol modules; a role's module joins it
when that role is ported.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from enum import IntEnum
from typing import Any, Dict, List, Tuple

WIRE_VERSION = 1
MAX_DEPTH = 64
MAX_VARINT_BYTES = 16  # > 2**112: nothing on this wire is that large

T_NONE = 0
T_TRUE = 1
T_FALSE = 2
T_INT = 3
T_FLOAT = 4
T_BYTES = 5
T_STR = 6
T_LIST = 7
T_TUPLE = 8
T_DICT = 9
T_STRUCT = 10
T_ENUM = 11

_F64 = struct.Struct(">d")
_U16 = struct.Struct(">H")


class WireDecodeError(Exception):
    """Malformed or unknown wire bytes.  The ONLY error decode raises."""


class WireEncodeError(Exception):
    """Value outside the protocol vocabulary (e.g. an unregistered class)."""


# --- registry -------------------------------------------------------------

_struct_ids: Dict[type, int] = {}
_structs_by_id: Dict[int, Tuple[type, tuple]] = {}  # id -> (cls, fields)
_enum_ids: Dict[type, int] = {}
_enums_by_id: Dict[int, type] = {}
_built = False


def _class_id(name: str) -> int:
    return zlib.crc32(name.encode()) & 0xFFFF


def register_struct(cls: type) -> type:
    """Admit a dataclass to the wire vocabulary."""
    assert dataclasses.is_dataclass(cls), cls
    cid = _class_id(cls.__name__)
    prev = _structs_by_id.get(cid)
    if prev is not None and prev[0] is not cls:
        raise AssertionError(
            f"wire id collision: {cls.__name__} vs {prev[0].__name__}"
        )
    _struct_ids[cls] = cid
    _structs_by_id[cid] = (cls, tuple(dataclasses.fields(cls)))
    return cls


def register_enum(cls: type) -> type:
    assert issubclass(cls, IntEnum), cls
    cid = _class_id(cls.__name__)
    prev = _enums_by_id.get(cid)
    if prev is not None and prev is not cls:
        raise AssertionError(
            f"wire enum id collision: {cls.__name__} vs {prev.__name__}"
        )
    _enum_ids[cls] = cid
    _enums_by_id[cid] = cls
    return cls


def _build_registry():
    """Collect the protocol vocabulary: every dataclass/IntEnum in the
    modules that define what crosses the real transport.  Lazy (first
    encode/decode) to avoid import cycles with the server modules."""
    global _built
    if _built:
        return
    from ..client import types as client_types
    from ..conflict import types as conflict_types
    from ..server import interfaces as server_interfaces
    from ..server import resolver
    from . import network as rpc_network
    from . import stream as rpc_stream

    modules = (
        server_interfaces,
        client_types,
        conflict_types,
        rpc_stream,
        rpc_network,
        resolver,
    )
    for mod in modules:
        for obj in vars(mod).values():
            if isinstance(obj, type) and obj.__module__ == mod.__name__:
                if dataclasses.is_dataclass(obj):
                    register_struct(obj)
                elif issubclass(obj, IntEnum):
                    register_enum(obj)
    # Marked ONLY after full success: a failed first build (import cycle,
    # broken module) must surface its real error on every call, not decay
    # into "unregistered struct" against a half-empty registry.
    _built = True


# --- encoding -------------------------------------------------------------


def _enc_varint(out: List[bytes], n: int):
    """Unsigned LEB128."""
    if n < 0:
        raise WireEncodeError("negative varint")
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(bytes((b | 0x80,)))
        else:
            out.append(bytes((b,)))
            return


def _zigzag(n: int) -> int:
    return (n << 1) if n >= 0 else ((-n) << 1) - 1


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _encode(out: List[bytes], v: Any, depth: int):
    if depth > MAX_DEPTH:
        raise WireEncodeError("nesting too deep")
    if v is None:
        out.append(bytes((T_NONE,)))
    elif v is True:
        out.append(bytes((T_TRUE,)))
    elif v is False:
        out.append(bytes((T_FALSE,)))
    elif isinstance(v, IntEnum):
        cid = _enum_ids.get(type(v))
        if cid is None:
            raise WireEncodeError(f"unregistered enum {type(v).__name__}")
        out.append(bytes((T_ENUM,)))
        out.append(_U16.pack(cid))
        _enc_varint(out, _zigzag(int(v)))
    elif isinstance(v, int):
        out.append(bytes((T_INT,)))
        _enc_varint(out, _zigzag(v))
    elif isinstance(v, float):
        out.append(bytes((T_FLOAT,)))
        out.append(_F64.pack(v))
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        out.append(bytes((T_BYTES,)))
        _enc_varint(out, len(b))
        out.append(b)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out.append(bytes((T_STR,)))
        _enc_varint(out, len(b))
        out.append(b)
    elif isinstance(v, list):
        out.append(bytes((T_LIST,)))
        _enc_varint(out, len(v))
        for item in v:
            _encode(out, item, depth + 1)
    elif isinstance(v, tuple):
        out.append(bytes((T_TUPLE,)))
        _enc_varint(out, len(v))
        for item in v:
            _encode(out, item, depth + 1)
    elif isinstance(v, dict):
        out.append(bytes((T_DICT,)))
        _enc_varint(out, len(v))
        for k, val in v.items():
            _encode(out, k, depth + 1)
            _encode(out, val, depth + 1)
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        cid = _struct_ids.get(type(v))
        if cid is None:
            raise WireEncodeError(f"unregistered struct {type(v).__name__}")
        _cls, flds = _structs_by_id[cid]
        out.append(bytes((T_STRUCT,)))
        out.append(_U16.pack(cid))
        _enc_varint(out, len(flds))
        for f in flds:
            _encode(out, getattr(v, f.name), depth + 1)
    else:
        raise WireEncodeError(
            f"type {type(v).__name__} is not in the wire vocabulary"
        )


def encode_frame_py(value: Any) -> bytes:
    """Pure-Python encode."""
    _build_registry()
    out: List[bytes] = [bytes((WIRE_VERSION,))]
    _encode(out, value, 0)
    return b"".join(out)


# value -> one wire frame body (the caller adds the length prefix).
encode_frame = encode_frame_py


# --- decoding -------------------------------------------------------------


class _Reader:
    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.end = len(buf)

    def take(self, n: int) -> bytes:
        if n < 0 or self.end - self.pos < n:
            raise WireDecodeError("truncated frame")
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def byte(self) -> int:
        if self.pos >= self.end:
            raise WireDecodeError("truncated frame")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        shift = 0
        n = 0
        for i in range(MAX_VARINT_BYTES):
            b = self.byte()
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7
        raise WireDecodeError("varint too long")


def _decode(r: _Reader, depth: int) -> Any:
    if depth > MAX_DEPTH:
        raise WireDecodeError("nesting too deep")
    tag = r.byte()
    if tag == T_NONE:
        return None
    if tag == T_TRUE:
        return True
    if tag == T_FALSE:
        return False
    if tag == T_INT:
        return _unzigzag(r.varint())
    if tag == T_FLOAT:
        return _F64.unpack(r.take(8))[0]
    if tag == T_BYTES:
        return r.take(r.varint())
    if tag == T_STR:
        try:
            return r.take(r.varint()).decode("utf-8")
        except UnicodeDecodeError as e:
            raise WireDecodeError(f"bad utf-8: {e}") from None
    if tag in (T_LIST, T_TUPLE):
        n = r.varint()
        if n > r.end - r.pos:  # each element needs >= 1 byte
            raise WireDecodeError("length exceeds frame")
        items = [_decode(r, depth + 1) for _ in range(n)]
        return items if tag == T_LIST else tuple(items)
    if tag == T_DICT:
        n = r.varint()
        if n * 2 > r.end - r.pos:
            raise WireDecodeError("length exceeds frame")
        out = {}
        for _ in range(n):
            k = _decode(r, depth + 1)
            try:
                out[k] = _decode(r, depth + 1)
            except TypeError as e:  # unhashable key
                raise WireDecodeError(f"bad dict key: {e}") from None
        return out
    if tag == T_ENUM:
        cid = _U16.unpack(r.take(2))[0]
        cls = _enums_by_id.get(cid)
        if cls is None:
            raise WireDecodeError(f"unknown enum id {cid:#06x}")
        try:
            return cls(_unzigzag(r.varint()))
        except ValueError as e:
            raise WireDecodeError(str(e)) from None
    if tag == T_STRUCT:
        cid = _U16.unpack(r.take(2))[0]
        entry = _structs_by_id.get(cid)
        if entry is None:
            raise WireDecodeError(f"unknown struct id {cid:#06x}")
        cls, flds = entry
        n = r.varint()
        if n > len(flds):
            raise WireDecodeError(
                f"{cls.__name__}: peer sent {n} fields, we know {len(flds)}"
            )
        kwargs = {}
        for i in range(n):
            kwargs[flds[i].name] = _decode(r, depth + 1)
        # Old peer, new local field: defaults fill the tail.
        for f in flds[n:]:
            if (
                f.default is dataclasses.MISSING
                and f.default_factory is dataclasses.MISSING
            ):
                raise WireDecodeError(
                    f"{cls.__name__}.{f.name}: missing with no default"
                )
        try:
            return cls(**kwargs)
        except (TypeError, ValueError) as e:
            raise WireDecodeError(f"{cls.__name__}: {e}") from None
    raise WireDecodeError(f"unknown tag {tag}")


def decode_frame_py(frame: bytes) -> Any:
    """Pure-Python decode."""
    _build_registry()
    r = _Reader(frame)
    ver = r.byte()
    if ver != WIRE_VERSION:
        raise WireDecodeError(f"wire version {ver} != {WIRE_VERSION}")
    v = _decode(r, 0)
    if r.pos != r.end:
        raise WireDecodeError(f"{r.end - r.pos} trailing bytes")
    return v


# One frame body -> value.  Raises WireDecodeError and nothing else.
decode_frame = decode_frame_py
