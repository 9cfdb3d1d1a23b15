"""The long-key side table: exact conflict history for keys past the
device's width, kept on the host beside the device's history.

The device encodes keys of at most ``width`` bytes (api.MAX_DEVICE_KEY_BYTES
or ``key_words * 4``, whichever is less).  A longer key k lies in the
region ``[T, U)`` of its ``width``-byte prefix ``T = k[:width]``, with
``U = strinc(T)``.  No key the device can encode lies strictly inside a
region, so the device's history is constant on each one.  A batch that
holds a long key goes to the device with every read widened to the regions
of its long ends (``[T(b), U(e))``) and every write narrowed to them
(``[U(b), T(e))``); the parts of a write that lie in the region of a long
end go to the side table, an exact host history of those parts alone.
Then, by induction over the batches:

- the device's history on a region is at most the true history anywhere in
  it, and equals the true history everywhere else;
- the true maximum over a read is the larger of the device's maximum over
  the widened read and the side table's maximum over the read itself;
- every overlap the device sees between a narrowed write and a widened
  read is a real one.

What the device cannot see, the plan settles on the host:

- a read whose side-table maximum passes its snapshot is a history
  conflict.  Its transaction goes to the device with its writes stripped,
  so that nothing of it reaches the batch's committed-write union, and its
  verdict and witness join both sides' afterwards (``settle``);
- a side-table write part that a later transaction of the same batch reads
  couples the two sides through the batch's greedy order.  Such a batch,
  and one whose long key lies in the region that reaches the end of the key
  space (``width`` bytes of 0xff), is served whole by the host against the
  mirror and the side table together (``host_detect``).

The mirror holds exactly the device's history, so rehydration, the synced
snapshots and ``mirror_check`` see nothing of the side table.  Every
verdict and witness is the reference engine's on the same batch.
"""

from __future__ import annotations

from typing import List, Optional

from .engine_cpu_flat import FLOOR_VERSION, FlatCpuConflictSet, _IntervalSet
from .types import COMMITTED, CONFLICT, TOO_OLD, TransactionConflictInfo


def strinc(k: bytes) -> Optional[bytes]:
    """The first key after every key that starts with ``k``; None when
    ``k`` is all 0xff bytes (nothing comes after those)."""
    k = k.rstrip(b"\xff")
    return k[:-1] + bytes([k[-1] + 1]) if k else None


class LongKeyPlan:
    """What one batch needs of the side table: the transactions as the
    device takes them (``dev_txns``), each read's side-table maximum
    (``s_max``), each transaction's first read range with a history
    conflict in the side table or None (``hist``), each transaction's
    side-table write parts (``parts``), the regions those parts lie in
    (``regions``), and whether the host must serve the batch
    (``host_only``)."""

    __slots__ = ("dev_txns", "s_max", "hist", "parts", "regions", "host_only")

    def __init__(self):
        self.dev_txns: List[TransactionConflictInfo] = []
        self.s_max: List[List[int]] = []
        self.hist: List[Optional[int]] = []
        self.parts: List[list] = []
        self.regions: List[list] = []
        self.host_only = False


class SideTable:
    """The side table of one ConflictSet (see the module docstring)."""

    def __init__(self, width: int, oldest_version: int = 0):
        self.width = width
        self._top = b"\xff" * width
        self._hist = FlatCpuConflictSet(oldest_version)
        # (lo, hi, version) of every region a committed part was written
        # into at a version the window may still hold; hi None reaches the
        # end of the key space.  A read that meets none of them cannot see
        # the side table.
        self._live: list = []

    def _region(self, k: bytes):
        t = k[: self.width]
        return t, strinc(t)

    def _meets_live(self, b: bytes, e: bytes) -> bool:
        return any(lo < e and (hi is None or b < hi) for lo, hi, _v in self._live)

    def plan(self, txns, oldest: int) -> Optional[LongKeyPlan]:
        """The batch's plan, or None when no key of it is long and no read
        meets a live region: the batch is then the device's alone."""
        w = self.width
        self._live = [r for r in self._live if r[2] >= oldest]
        if not self._live and self._hist.boundary_count > 1:
            self._hist = FlatCpuConflictSet(oldest)
        if not any(len(b) > w or len(e) > w
                   for tr in txns for b, e in tr.read_ranges + tr.write_ranges):
            if not self._live or not any(self._meets_live(b, e)
                                         for tr in txns for b, e in tr.read_ranges):
                return None
        plan = LongKeyPlan()
        hist = self._hist
        committed_parts = _IntervalSet()  # parts of earlier txns that may commit
        for tr in txns:
            reads, s_max = [], []
            for b, e in tr.read_ranges:
                if b < e:
                    reads.append((b[:w] if len(b) > w else b,
                                  self._region(e)[1] if len(e) > w else e))
                    if reads[-1][1] is None:
                        plan.host_only = True
                    s_max.append(hist._range_max(b, e))
                else:
                    reads.append((b[:w], b[:w]))  # empty stays empty
                    s_max.append(FLOOR_VERSION)
            first = next((i for i, m in enumerate(s_max) if m > tr.read_snapshot), None)
            writes, parts, regions = [], [], []
            for b, e in tr.write_ranges:
                long_b, long_e = len(b) > w, len(e) > w
                if not (long_b or long_e):
                    writes.append((b, e))
                    continue
                if b >= e:
                    continue  # an empty write merges nothing
                db = self._region(b)[1] if long_b else b
                de = e[:w] if long_e else e
                if db is not None and db < de:
                    writes.append((db, de))
                if long_b:
                    parts.append((b, e if db is None else min(e, db)))
                    regions.append(self._region(b))
                if long_e and not (long_b and b[:w] == e[:w]):
                    parts.append((max(b, e[:w]), e))
                    regions.append(self._region(e))
            if first is None:
                if any(committed_parts.intersects(b, e) for b, e in tr.read_ranges):
                    plan.host_only = True
                for b, e in parts:
                    committed_parts.add(b, e)
            else:
                writes = []  # a conflict whatever the device decides
            plan.dev_txns.append(TransactionConflictInfo(tr.read_snapshot, reads, writes))
            plan.s_max.append(s_max)
            plan.hist.append(first)
            plan.parts.append(parts)
            plan.regions.append(regions)
        return plan

    def settle(self, plan: LongKeyPlan, txns, statuses: list, witness: list,
               now: int, new_oldest_version: int) -> None:
        """Join the device's verdicts and witnesses (in place) with the
        side table's history conflicts, then record the batch's committed
        parts."""
        for t, first in enumerate(plan.hist):
            if first is None or statuses[t] == TOO_OLD:
                continue
            statuses[t] = CONFLICT
            if witness:
                s_max = plan.s_max[t]
                dev = witness[t]
                # The device's own history conflict, if it found one; an
                # intra-batch conflict carries `now`, and the history
                # conflict comes first in the reference's order.
                if dev is not None and dev[0] < now and dev[1] <= first:
                    i = dev[1]
                    witness[t] = (max(dev[0], s_max[i]), i)
                else:
                    witness[t] = (s_max[first], first)
        self._record(plan, statuses, now, new_oldest_version)

    def _record(self, plan, statuses, now, new_oldest_version) -> None:
        self._hist.apply_batch(
            [TransactionConflictInfo(0, [], parts) for parts in plan.parts],
            statuses, now, new_oldest_version,
        )
        for t, regions in enumerate(plan.regions):
            if statuses[t] == COMMITTED:
                self._live.extend((lo, hi, now) for lo, hi in regions)

    def host_detect(self, mirror, txns, plan: LongKeyPlan, now: int,
                    new_oldest_version: int):
        """Decide the batch on the host against the mirror (the device's
        history) and the side table together, exactly as the reference
        engine decides it against the whole history; apply it to both.
        Returns (statuses, witness)."""
        oldest = mirror.oldest_version
        statuses = [COMMITTED] * len(txns)
        witness: list = [None] * len(txns)
        for t, (tr, dv) in enumerate(zip(txns, plan.dev_txns)):
            if tr.read_snapshot < oldest and tr.read_ranges:
                statuses[t] = TOO_OLD
                continue
            for i, ((b, e), (db, de)) in enumerate(zip(tr.read_ranges, dv.read_ranges)):
                if b < e:
                    m = max(self._device_max(mirror, db, de), plan.s_max[t][i])
                    if m > tr.read_snapshot:
                        statuses[t] = CONFLICT
                        witness[t] = (m, i)
                        break
        active = _IntervalSet()
        for t, tr in enumerate(txns):
            if statuses[t] != COMMITTED:
                continue
            hit = next((i for i, (b, e) in enumerate(tr.read_ranges)
                        if active.intersects(b, e)), None)
            if hit is not None:
                statuses[t] = CONFLICT
                witness[t] = (now, hit)
                continue
            for b, e in tr.write_ranges:
                active.add(b, e)
        mirror.apply_batch(plan.dev_txns, statuses, now, new_oldest_version)
        self._record(plan, statuses, now, new_oldest_version)
        return statuses, witness

    def _device_max(self, mirror, b: bytes, e: Optional[bytes]) -> int:
        """The mirror's maximum over the widened read [b, e); e None
        reaches the end of the key space, whose last step starts at or
        below ``width`` bytes of 0xff."""
        if e is not None:
            return mirror._range_max(b, e)
        top = self._top
        head = mirror._range_max(b, top) if b < top else FLOOR_VERSION
        return max(head, mirror._value_at(top))

    def clear(self, version: int) -> None:
        self._hist = FlatCpuConflictSet(version)
        self._live = []
