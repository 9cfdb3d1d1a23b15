"""Atomic-op semantics shared by client RYW and storage apply.

The port's own copy of the reference package's ``client/atomic.py``.  The
reference's ``value_size_limit`` knob is ``append_if_fits``'
``value_size_limit`` argument, with its default.
Ref: fdbclient/Atomic.h (doLittleEndianAdd, doAnd/V2, doOr, doXor,
doAppendIfFits, doMax, doMin/V2, doByteMin, doByteMax).  Semantics are
matched exactly — including the quirks: results take the operand's length
(add/and/min/max truncate or zero-extend the existing value), and the
pre-V2 And/Min treat a *missing* key as empty rather than absent.  The byte
loops become Python int arithmetic on little-endian values.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from .types import MutationType

# Ref: CLIENT_KNOBS->VALUE_SIZE_LIMIT.
VALUE_SIZE_LIMIT = 100_000


def _le(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _le_bytes(v: int, length: int) -> bytes:
    return (v & ((1 << (8 * length)) - 1)).to_bytes(length, "little")


def add_value(existing: Optional[bytes], operand: bytes) -> bytes:
    ex = existing or b""
    if not ex or not operand:
        return operand
    return _le_bytes(_le(ex) + _le(operand), len(operand))


def and_(existing: Optional[bytes], operand: bytes) -> bytes:
    ex = existing or b""
    if not operand:
        return operand
    # AND over the overlap; bytes beyond the existing value are zero.
    return _le_bytes(_le(ex) & _le(operand), len(operand))


def and_v2(existing: Optional[bytes], operand: bytes) -> bytes:
    if existing is None:
        return operand
    return and_(existing, operand)


def or_(existing: Optional[bytes], operand: bytes) -> bytes:
    ex = existing or b""
    if not ex or not operand:
        return operand
    return _le_bytes(_le(ex[: len(operand)]) | _le(operand), len(operand))


def xor(existing: Optional[bytes], operand: bytes) -> bytes:
    ex = existing or b""
    if not ex or not operand:
        return operand
    return _le_bytes(_le(ex[: len(operand)]) ^ _le(operand), len(operand))


def append_if_fits(existing: Optional[bytes], operand: bytes,
                   value_size_limit: int = VALUE_SIZE_LIMIT) -> bytes:
    ex = existing or b""
    if not ex:
        return operand
    if not operand:
        return ex
    if len(ex) + len(operand) > value_size_limit:
        return ex
    return ex + operand


def max_(existing: Optional[bytes], operand: bytes) -> bytes:
    ex = existing or b""
    if not ex or not operand:
        return operand
    ex_t = _le(ex[: len(operand)])
    if _le(operand) >= ex_t:
        return operand
    return _le_bytes(ex_t, len(operand))


def min_(existing: Optional[bytes], operand: bytes) -> bytes:
    if not operand:
        return operand
    ex = existing or b""
    ex_t = _le(ex[: len(operand)])
    if _le(operand) < ex_t:
        return operand
    return _le_bytes(ex_t, len(operand))


def min_v2(existing: Optional[bytes], operand: bytes) -> bytes:
    if existing is None:
        return operand
    return min_(existing, operand)


def byte_min(existing: Optional[bytes], operand: bytes) -> bytes:
    if existing is None:
        return operand
    return min(existing, operand)


def byte_max(existing: Optional[bytes], operand: bytes) -> bytes:
    if existing is None:
        return operand
    return max(existing, operand)


APPLY: Dict[MutationType, Callable[[Optional[bytes], bytes], bytes]] = {
    MutationType.ADD_VALUE: add_value,
    MutationType.AND: and_,
    MutationType.AND_V2: and_v2,
    MutationType.OR: or_,
    MutationType.XOR: xor,
    MutationType.APPEND_IF_FITS: append_if_fits,
    MutationType.MAX: max_,
    MutationType.MIN: min_,
    MutationType.MIN_V2: min_v2,
    MutationType.BYTE_MIN: byte_min,
    MutationType.BYTE_MAX: byte_max,
}


def apply_atomic(
    op: MutationType, existing: Optional[bytes], operand: bytes
) -> bytes:
    return APPLY[op](existing, operand)


def transform_versionstamp(data: bytes, version: int, txn_number: int) -> bytes:
    """Substitute the 10-byte versionstamp into a SET_VERSIONSTAMPED_* param.

    Ref: Atomic.h transformVersionstampMutation :258 / placeVersionstamp
    :249 — the param's final 4 bytes are a little-endian offset (stripped);
    the stamp is 8-byte big-endian commit version + 2-byte big-endian
    transaction-number-in-batch.  An out-of-bounds offset is
    client_invalid_operation (ref: getVersionstampKeyRange :240), checked
    client-side at mutation time via validate_versionstamp_param.
    """
    validate_versionstamp_param(data)
    pos = int.from_bytes(data[-4:], "little", signed=True)
    body = bytearray(data[:-4])
    body[pos : pos + 8] = version.to_bytes(8, "big")
    body[pos + 8 : pos + 10] = txn_number.to_bytes(2, "big")
    return bytes(body)


def validate_versionstamp_param(data: bytes) -> None:
    from ..flow.error import FdbError

    if len(data) < 4:
        raise FdbError("client_invalid_operation")
    pos = int.from_bytes(data[-4:], "little", signed=True)
    if pos < 0 or pos + 10 > len(data) - 4:
        raise FdbError("client_invalid_operation")
