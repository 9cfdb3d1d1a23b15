"""Flat-array host conflict engine: the divergence fallback of the port.

A copy of the reference package's FlatCpuConflictSet (which is gated
state-identical to its chunked CpuConflictSet mirror).  TorchConflictSet
re-decides a batch here when the device fixpoint did not converge
(``_fallback_cpu``), against the unchanged device history.

Data model (shared by every engine): keys[i] starts the range
[keys[i], keys[i+1]) whose last-committed-write version is vers[i]; the
final entry extends to +infinity and keys[0] is always b"" (the floor).
Replaces the reference's versioned skip list (fdbserver/SkipList.cpp
SkipList::detectConflicts :524, addConflictRanges :511) with a flat
sorted boundary array.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import List

from .types import CONFLICT, COMMITTED, TOO_OLD, TransactionConflictInfo

FLOOR_VERSION = -(2**62)  # never conflicts with any snapshot


class _IntervalSet:
    """Merged, sorted, half-open intervals; the intra-batch committed-write
    accumulator (plays the reference's MiniConflictSet role,
    SkipList.cpp:1028-1131, but keyed on bytes instead of point indices)."""

    __slots__ = ("begins", "ends")

    def __init__(self):
        self.begins: list[bytes] = []
        self.ends: list[bytes] = []

    def intersects(self, b: bytes, e: bytes) -> bool:
        if b >= e:
            return False
        idx = bisect_right(self.begins, b) - 1
        if idx >= 0 and self.ends[idx] > b:
            return True
        nxt = idx + 1
        return nxt < len(self.begins) and self.begins[nxt] < e

    def add(self, b: bytes, e: bytes) -> None:
        if b >= e:
            return
        lo = bisect_right(self.begins, b) - 1
        if lo >= 0 and self.ends[lo] >= b:
            b = self.begins[lo]
        else:
            lo += 1
        hi = bisect_right(self.begins, e)
        if hi > lo:
            e = max(e, self.ends[hi - 1])
        self.begins[lo:hi] = [b]
        self.ends[lo:hi] = [e]


class FlatCpuConflictSet:
    """Exact reference-semantics engine over a flat sorted step function."""

    def __init__(self, oldest_version: int = 0):
        self.oldest_version = oldest_version
        self.keys: list[bytes] = [b""]
        self.vers: list[int] = [FLOOR_VERSION]
        # Per-txn abort witness of the most recent detect().
        self.last_witness: list = []

    # -- history step function --
    def _range_max(self, b: bytes, e: bytes) -> int:
        """Max version over [b, e); requires b < e."""
        i = bisect_right(self.keys, b) - 1
        j = bisect_left(self.keys, e) - 1
        return max(self.vers[i : j + 1])

    def _value_at(self, k: bytes) -> int:
        return self.vers[bisect_right(self.keys, k) - 1]

    def _overwrite(self, b: bytes, e: bytes, version: int) -> None:
        """Set the step function to `version` on [b, e)."""
        end_val = self._value_at(e)
        i0 = bisect_left(self.keys, b)
        i1 = bisect_left(self.keys, e)
        new_keys = [b]
        new_vers = [version]
        if not (i1 < len(self.keys) and self.keys[i1] == e):
            new_keys.append(e)
            new_vers.append(end_val)
        self.keys[i0:i1] = new_keys
        self.vers[i0:i1] = new_vers

    # -- ConflictSet ABI (ref fdbserver/ConflictSet.h) --
    def detect(
        self,
        transactions: List[TransactionConflictInfo],
        now: int,
        new_oldest_version: int,
    ) -> List[int]:
        statuses: list[int] = [COMMITTED] * len(transactions)
        # Abort witness: (version, read-range index) per
        # CONFLICT txn, None otherwise — identical rule to CpuConflictSet
        # so the two mirrors stay differential-gate-identical.
        witness: list = [None] * len(transactions)

        # Phase 1: too-old + history conflicts (ref checkReadConflictRanges)
        for t, tr in enumerate(transactions):
            if tr.read_snapshot < self.oldest_version and tr.read_ranges:
                statuses[t] = TOO_OLD
                continue
            for i, (rb, re_) in enumerate(tr.read_ranges):
                if rb < re_:
                    m = self._range_max(rb, re_)
                    if m > tr.read_snapshot:
                        statuses[t] = CONFLICT
                        witness[t] = (m, i)
                        break

        # Phase 2: intra-batch, in order (ref checkIntraBatchConflicts)
        active = _IntervalSet()
        for t, tr in enumerate(transactions):
            if statuses[t] != COMMITTED:
                continue
            hit = next(
                (
                    i
                    for i, (rb, re_) in enumerate(tr.read_ranges)
                    if active.intersects(rb, re_)
                ),
                None,
            )
            if hit is not None:
                statuses[t] = CONFLICT
                witness[t] = (now, hit)
                continue
            for (wb, we) in tr.write_ranges:
                active.add(wb, we)

        self.last_witness = witness
        self._commit_writes(active, now, new_oldest_version)
        return statuses

    def _commit_writes(
        self, active: _IntervalSet, now: int, new_oldest_version: int
    ) -> None:
        """Phases 3-4 on an already-decided batch: merge the committed
        write union into history at `now`, then evict below the window."""
        # Phase 3: merge committed writes at `now` (ref mergeWriteConflictRanges)
        # `active` is exactly the union of committed writes, already merged.
        for b, e in zip(active.begins, active.ends):
            self._overwrite(b, e, now)

        # Phase 4: window eviction (ref SkipList::removeBefore — drop a
        # boundary iff it and its original predecessor are both below window)
        if new_oldest_version > self.oldest_version:
            self.oldest_version = new_oldest_version
            old = self.oldest_version
            keys, vers = self.keys, self.vers
            keep = [
                i == 0 or vers[i] >= old or vers[i - 1] >= old
                for i in range(len(keys))
            ]
            if not all(keep):
                self.keys = [k for k, kp in zip(keys, keep) if kp]
                self.vers = [v for v, kp in zip(vers, keep) if kp]

    def apply_batch(
        self,
        transactions: List[TransactionConflictInfo],
        statuses: List[int],
        now: int,
        new_oldest_version: int,
    ) -> None:
        """Adopt an externally-decided batch (the device engine's verdicts)
        into this engine's history: the committed transactions' writes are
        merged and the window advanced EXACTLY as detect() would have —
        since the device decides bit-identically, the mirrored state is
        indistinguishable from having run the batch here."""
        active = _IntervalSet()
        for t, tr in enumerate(transactions):
            if statuses[t] != COMMITTED:
                continue
            for (wb, we) in tr.write_ranges:
                active.add(wb, we)
        self._commit_writes(active, now, new_oldest_version)

    def clear(self, version: int):
        self.keys = [b""]
        self.vers = [FLOOR_VERSION]
        self.oldest_version = version

    @property
    def boundary_count(self) -> int:
        return len(self.keys)
