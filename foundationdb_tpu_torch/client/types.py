"""Core KV and transaction wire types.

The port's own copy of the reference package's ``client/types.py``
(fdbclient/CommitTransaction.h, fdbclient/FDBTypes.h): ``MutationType``
keeps the reference enum's values (CommitTransaction.h:31), so traces and
wire formats stay comparable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import List

from ..conflict.types import Range


class MutationType(IntEnum):
    # ref CommitTransaction.h:31 enum Type
    SET_VALUE = 0
    CLEAR_RANGE = 1
    ADD_VALUE = 2
    DEBUG_KEY_RANGE = 3
    DEBUG_KEY = 4
    NO_OP = 5
    AND = 6
    OR = 7
    XOR = 8
    APPEND_IF_FITS = 9
    AVAILABLE_FOR_REUSE = 10
    RESERVED_FOR_LOG_PROTOCOL_MESSAGE = 11
    MAX = 12
    MIN = 13
    SET_VERSIONSTAMPED_KEY = 14
    SET_VERSIONSTAMPED_VALUE = 15
    BYTE_MIN = 16
    BYTE_MAX = 17
    MIN_V2 = 18
    AND_V2 = 19


ATOMIC_TYPES = frozenset(
    {
        MutationType.ADD_VALUE,
        MutationType.AND,
        MutationType.OR,
        MutationType.XOR,
        MutationType.APPEND_IF_FITS,
        MutationType.MAX,
        MutationType.MIN,
        MutationType.SET_VERSIONSTAMPED_KEY,
        MutationType.SET_VERSIONSTAMPED_VALUE,
        MutationType.BYTE_MIN,
        MutationType.BYTE_MAX,
        MutationType.MIN_V2,
        MutationType.AND_V2,
    }
)


@dataclass
class Mutation:
    """Ref: MutationRef CommitTransaction.h:29 (type, param1, param2)."""

    type: MutationType
    param1: bytes  # key (or range begin for CLEAR_RANGE)
    param2: bytes  # value (or range end for CLEAR_RANGE)


@dataclass
class CommitTransactionRef:
    """THE wire unit of a commit (ref: CommitTransaction.h:89-104)."""

    read_snapshot: int = 0
    read_conflict_ranges: List[Range] = field(default_factory=list)
    write_conflict_ranges: List[Range] = field(default_factory=list)
    mutations: List[Mutation] = field(default_factory=list)


# Key-space constants (ref: fdbclient/FDBTypes.h allKeys / systemKeys)
ALL_KEYS: Range = (b"", b"\xff")
SYSTEM_KEY_BEGIN = b"\xff"
MAX_KEY = b"\xff\xff"


def strinc(key: bytes) -> bytes:
    """First key not prefixed by `key` (ref: strinc in fdbclient)."""
    k = key.rstrip(b"\xff")
    if not k:
        raise ValueError("key must contain a byte != 0xff")
    return k[:-1] + bytes([k[-1] + 1])


def key_after(key: bytes) -> bytes:
    """Immediate successor key (ref: keyAfter)."""
    return key + b"\x00"


@dataclass
class KeyValue:
    key: bytes
    value: bytes


@dataclass
class KeySelector:
    """Ref: KeySelectorRef FDBTypes.h — resolve relative to a key.

    Resolves to: the (offset)th key at-or-after `key` if or_equal else
    strictly-after/before per the standard fdb definition.
    """

    key: bytes
    or_equal: bool = False
    offset: int = 1

    @classmethod
    def last_less_than(cls, key: bytes) -> "KeySelector":
        return cls(key, False, 0)

    @classmethod
    def last_less_or_equal(cls, key: bytes) -> "KeySelector":
        return cls(key, True, 0)

    @classmethod
    def first_greater_than(cls, key: bytes) -> "KeySelector":
        return cls(key, True, 1)

    @classmethod
    def first_greater_or_equal(cls, key: bytes) -> "KeySelector":
        return cls(key, False, 1)
