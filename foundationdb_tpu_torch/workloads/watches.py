"""Watches: change notifications fire exactly when values change.

The port's own copy of the reference package's ``workloads/watches.py``.

Ref: fdbserver/workloads/Watches.actor.cpp — chains of watchers: setter
writes key N's new value, the watcher on N wakes and propagates to key
N+1, around a ring; the workload measures that every watch FIRES on a
real change and does NOT fire spuriously (a fired watch must observe a
value different from the one it was set against).
"""

from __future__ import annotations

from .base import TestWorkload


class WatchesWorkload(TestWorkload):
    name = "watches"

    def __init__(self, chain: int = 4, rounds: int = 5,
                 prefix: bytes = b"watch/"):
        self.chain = chain
        self.rounds = rounds
        self.prefix = prefix
        self.fired = 0
        self.spurious = 0

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    async def setup(self, db, cluster):
        async def init(tr):
            for i in range(self.chain):
                tr.set(self._key(i), b"r-1")

        await db.run(init)

    async def start(self, db, cluster):
        from ..flow.eventloop import all_of

        async def propagator(i: int):
            """Watch key i; when it changes to round r, write key i+1."""
            nxt = (i + 1) % self.chain
            for r in range(self.rounds):
                want = b"r%d" % r
                while True:
                    tr = db.create_transaction()
                    cur = await tr.get(self._key(i))
                    if cur == want:
                        break
                    fut = await tr.watch(self._key(i))
                    await tr.commit()  # read-only: registers at read version
                    await fut
                    self.fired += 1
                    tr2 = db.create_transaction()
                    after = await tr2.get(self._key(i))
                    if after == cur:
                        self.spurious += 1
                if nxt != 0:

                    async def push(tr, nxt=nxt, want=want):
                        tr.set(self._key(nxt), want)

                    await db.run(push)

        async def driver():
            loop = cluster.loop
            for r in range(self.rounds):
                async def kick(tr, r=r):
                    tr.set(self._key(0), b"r%d" % r)

                await db.run(kick)
                # Wait until the chain's tail reflects this round.
                tail = self._key(self.chain - 1)
                while True:
                    out = {}

                    async def read(tr):
                        out["v"] = await tr.get(tail)

                    await db.run(read)
                    if out["v"] == b"r%d" % r:
                        break
                    await loop.delay(0.01)

        await all_of(
            [db.process.spawn(driver(), "watch_driver")]
            + [
                db.process.spawn(propagator(i), f"watch_prop{i}")
                for i in range(self.chain)
            ]
        )

    async def check(self, db, cluster) -> bool:
        return self.spurious == 0 and self.fired > 0
