"""Shared conflict-engine types.

Result codes use the reference's enum values (fdbserver/ConflictSet.h:36-40:
TransactionConflict=0, TransactionTooOld=1, TransactionCommitted=2) so the
min()-combine across sharded resolvers (ref: MasterProxyServer.actor.cpp:492
combines verdicts with min) works unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

CONFLICT = 0
TOO_OLD = 1
COMMITTED = 2

_NAMES = {CONFLICT: "conflict", TOO_OLD: "too_old", COMMITTED: "committed"}


def result_name(code: int) -> str:
    return _NAMES[code]


Range = Tuple[bytes, bytes]  # half-open [begin, end)


@dataclass
class TransactionConflictInfo:
    """Conflict-relevant slice of a CommitTransactionRef.

    Ref: fdbclient/CommitTransaction.h:89-104 (read_conflict_ranges,
    write_conflict_ranges, read_snapshot).
    """

    read_snapshot: int
    read_ranges: List[Range] = field(default_factory=list)
    write_ranges: List[Range] = field(default_factory=list)

    def validate(self):
        for b, e in self.read_ranges + self.write_ranges:
            assert isinstance(b, bytes) and isinstance(e, bytes)
            assert b <= e, f"inverted range {b!r} > {e!r}"


def intersects(a: Range, b: Range) -> bool:
    """Half-open interval intersection, the engines' common predicate.

    Empty ranges intersect nothing (the reference's sorted-point encoding
    gives an empty range end-before-begin indices, so its MiniConflictSet
    scans are no-ops; engines here ignore empty ranges everywhere).
    """
    return a[0] < b[1] and b[0] < a[1] and a[0] < a[1] and b[0] < b[1]
