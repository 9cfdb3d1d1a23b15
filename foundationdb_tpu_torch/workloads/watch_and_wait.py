"""WatchAndWait: mass watches all fire on change, none fire spuriously.

The port's own copy of the reference package's ``workloads/watch_and_wait.py``.

Ref: fdbserver/workloads/WatchAndWait.actor.cpp (a large watch
population all awaiting one trigger) + FastTriggeredWatches.actor.cpp
(watch latency on rapid triggers).  W watches are armed across a
keyspace; a writer then touches HALF the watched keys.  Every watch on a
touched key must fire, and no watch on an untouched key may fire — a
storage server dropping its watch map on a version fold, or waking
watchers on unrelated mutations, breaks one direction each.
"""

from __future__ import annotations

from ..flow.error import FdbError
from .base import TestWorkload


class WatchAndWaitWorkload(TestWorkload):
    name = "watch_and_wait"

    def __init__(self, watches: int = 16, prefix: bytes = b"waw/"):
        self.watches = watches
        self.prefix = prefix
        self.fired = set()

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    async def setup(self, db, cluster):
        async def init(tr):
            for i in range(self.watches):
                tr.set(self._key(i), b"init")

        await db.run(init)

    async def start(self, db, cluster):
        loop = cluster.loop

        async def watcher(i: int):
            while True:
                try:
                    tr = db.create_transaction()
                    fut = await tr.watch(self._key(i))
                    await tr.commit()
                    await fut
                    self.fired.add(i)
                    return
                except FdbError:
                    # Retryable (recovery, too-old): re-arm; an armed
                    # watch that already fired still counts via re-check.
                    got = {}

                    async def rd(t2, i=i):
                        got["v"] = await t2.get(self._key(i))

                    await db.run(rd)
                    if got["v"] != b"init":
                        self.fired.add(i)
                        return
                    await loop.delay(0.05)

        watchers = [
            db.process.spawn(watcher(i), f"waw{i}")
            for i in range(self.watches)
        ]
        await loop.delay(0.5)  # let the watch population arm

        async def touch(tr):
            for i in range(0, self.watches, 2):
                tr.set(self._key(i), b"changed")

        await db.run(touch)
        # Wait for every touched watch to fire (virtual time bounded by
        # the runner's timeout); untouched watchers stay parked.
        touched = set(range(0, self.watches, 2))
        while not touched <= self.fired:
            await loop.delay(0.1)
        for t in watchers:
            if not t.is_ready():
                t.cancel()

    async def check(self, db, cluster) -> bool:
        touched = set(range(0, self.watches, 2))
        untouched = set(range(1, self.watches, 2))
        assert touched <= self.fired, (
            f"watches never fired: {sorted(touched - self.fired)}"
        )
        spurious = self.fired & untouched
        assert not spurious, f"spurious watch fires: {sorted(spurious)}"
        return True
