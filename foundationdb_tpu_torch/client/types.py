"""Mutation wire types.

The part of the reference package's ``client/types.py`` the resolver's
state transactions carry (fdbclient/CommitTransaction.h's MutationRef):
``MutationType`` keeps the reference enum's values, so traces and wire
formats stay comparable.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


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


@dataclass
class Mutation:
    """Ref: MutationRef CommitTransaction.h:29 (type, param1, param2)."""

    type: MutationType
    param1: bytes  # key (or range begin for CLEAR_RANGE)
    param2: bytes  # value (or range end for CLEAR_RANGE)
