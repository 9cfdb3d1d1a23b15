"""FastTriggeredWatches: watches fire PROMPTLY, round after round.

The port's own copy of the reference package's ``workloads/fast_watches.py``.

Ref: fdbserver/workloads/FastTriggeredWatches.actor.cpp — arm a watch,
trigger it, measure the arm->fire latency; repeat.  A watch that fires
eventually-but-slowly (e.g. only on a durability fold or a poll cycle
instead of the mutation apply) passes WatchAndWait but fails here.
"""

from __future__ import annotations

from ..flow.error import FdbError
from .base import TestWorkload


class FastTriggeredWatchesWorkload(TestWorkload):
    name = "fast_watches"

    def __init__(self, rounds: int = 8, latency_bound: float = 1.0,
                 prefix: bytes = b"fw/"):
        self.rounds = rounds
        self.latency_bound = latency_bound
        self.prefix = prefix
        self.latencies = []

    async def start(self, db, cluster):
        loop = cluster.loop
        key = self.prefix + b"k"
        for r in range(self.rounds):
            async def put(tr, r=r):
                tr.set(key, b"base%d" % r)

            await db.run(put)
            tr = db.create_transaction()
            try:
                fut = await tr.watch(key)
                await tr.commit()
            except FdbError:
                continue
            t_armed = loop.now()

            async def trigger(tr2, r=r):
                tr2.set(key, b"trig%d" % r)

            await db.run(trigger)
            await fut
            self.latencies.append(loop.now() - t_armed)

    async def check(self, db, cluster) -> bool:
        assert len(self.latencies) >= self.rounds // 2
        worst = max(self.latencies)
        assert worst <= self.latency_bound, (
            f"watch fire latency {worst:.3f} > {self.latency_bound} "
            f"(all: {[round(x, 3) for x in self.latencies]})"
        )
        return True
