"""ConsistencyCheck: cross-replica agreement, shard by shard.

The port's own copy of the reference package's ``workloads/consistency.py``.

Ref: fdbserver/workloads/ConsistencyCheck.actor.cpp:35, checkDataConsistency
:562 — for every shard, read the full range from EVERY replica in its team
at one version and compare; run after most simulation tests
(tester.actor.cpp:819).  Reads at a fresh read version double as the
QuietDatabase gate: waitForVersion blocks until each replica has applied
the log through that version (a replica that cannot catch up surfaces as
future_version, a loud failure).
"""

from __future__ import annotations

from ..flow.error import FdbError
from ..server.interfaces import GetKeyValuesRequest
from .base import TestWorkload


async def _read_range_from(db, iface, begin: bytes, end: bytes, version: int):
    """Page one replica's view of [begin, end) at `version`."""
    loop = db.process.network.loop
    rows = []
    lo = begin
    while lo < end:
        for attempt in range(200):
            try:
                rep = await iface.get_key_values.get_reply(
                    db.process,
                    GetKeyValuesRequest(
                        begin=lo, end=end, version=version, limit=1000
                    ),
                )
                break
            except FdbError as e:
                # future_version = the replica hasn't caught up yet (the
                # quiet-database wait); anything else is a real failure.
                if e.name not in ("future_version", "broken_promise"):
                    raise
                await loop.delay(0.05)
        else:
            raise FdbError("timed_out")
        rows.extend(rep.data)
        if not rep.more or not rep.data:
            break
        lo = rep.data[-1][0] + b"\x00"
    return rows


async def check_consistency(db, cluster=None) -> int:
    """Compare every multi-replica shard across its team; returns the
    number of (shard, replica-pair) comparisons that matched.  Raises
    AssertionError on divergence (ref: checkDataConsistency :562)."""
    tr = db.create_transaction()
    version = await tr.get_read_version()
    locs = await db.get_locations(b"", b"\xff")
    compared = 0
    for b, e, team in locs:
        if team is None or len(team) < 2:
            continue
        end = e if e is not None else b"\xff"
        baseline = None
        for iface in team:
            rows = await _read_range_from(db, iface, b, end, version)
            if baseline is None:
                baseline = (iface.storage_id, rows)
                continue
            bid, brows = baseline
            assert rows == brows, (
                f"replica divergence in [{b!r}, {end!r}) @ {version}: "
                f"{bid} has {len(brows)} rows, {iface.storage_id} has "
                f"{len(rows)}; first diff: "
                f"{next((x for x in zip(brows, rows) if x[0] != x[1]), None)}"
            )
            compared += 1
    return compared


class ConsistencyChecker(TestWorkload):
    """Workload wrapper: run check_consistency in the check phase."""

    name = "consistency_check"

    def __init__(self, require_comparisons: bool = False):
        self.require_comparisons = require_comparisons
        self.compared = 0

    async def check(self, db, cluster) -> bool:
        self.compared = await check_consistency(db, cluster)
        if self.require_comparisons and self.compared == 0:
            return False
        return True
