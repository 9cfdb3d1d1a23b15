"""LockDatabase: lock/unlock cycles racing live traffic.

The port's own copy of the reference package's ``workloads/lock_database.py``.

Ref: fdbserver/workloads/LockDatabase.actor.cpp — lock the database
mid-run, verify non-lock-aware work fails database_locked while lock-aware
reads see consistent data, unlock, verify traffic resumes.  Composed with
other workloads, their db.run retry loops must ride through the locked
window transparently (database_locked is client-retryable).
"""

from __future__ import annotations

from .base import TestWorkload


class LockDatabaseWorkload(TestWorkload):
    name = "lock_database"

    def __init__(self, at: float = 0.5, hold: float = 0.8):
        self.at = at
        self.hold = hold
        self.checked_while_locked = False

    async def start(self, db, cluster):
        from ..client.management import lock_database, unlock_database
        from ..flow.error import FdbError

        loop = cluster.loop
        await loop.delay(self.at)
        uid = await lock_database(db)

        # Lock-aware snapshot read works while locked.
        tr = db.create_transaction()
        tr.options["lock_aware"] = True
        await tr.get_range(b"", b"\xff", limit=10)

        # Plain commits fail database_locked once the lock has reached
        # the proxy this transaction lands on.
        deadline = loop.now() + self.hold
        while loop.now() < deadline:
            tr2 = db.create_transaction()
            tr2.set(b"lockprobe", b"x")
            try:
                await tr2.commit()
            except FdbError as e:
                if e.name == "database_locked":
                    self.checked_while_locked = True
            await loop.delay(0.1)
        await unlock_database(db, uid)

    async def check(self, db, cluster) -> bool:
        if not self.checked_while_locked:
            return False

        # Unlocked: ordinary traffic flows again.
        async def probe(tr):
            tr.set(b"lock_done", b"1")

        await db.run(probe)
        return True
