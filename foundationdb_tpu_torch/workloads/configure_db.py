"""ConfigureDatabase: live configuration churn under load.

The port's own copy of the reference package's ``workloads/configure_db.py``.

Ref: fdbserver/workloads/ConfigureDatabase.actor.cpp — random `configure`
commands fired while other workloads run; every change lands as an
ordinary transaction on `\xff/conf`, the cluster controller reacts with a
new generation, and the database must stay correct throughout.  The check
asserts the final configuration matches the last change applied and the
database still commits.
"""

from __future__ import annotations

from .base import TestWorkload


class ConfigureDatabaseWorkload(TestWorkload):
    name = "configure_database"

    def __init__(self, changes: int = 4, delay_between: float = 0.8):
        self.changes = changes
        self.delay_between = delay_between
        self.final: dict = {}

    async def start(self, db, cluster):
        from ..client.management import configure

        loop = cluster.loop
        rng = loop.rng
        for _ in range(self.changes):
            params = {
                "proxies": 1 + int(rng.random_int(0, 3)),
                "resolvers": 1 + int(rng.random_int(0, 2)),
            }
            await configure(db, **params)
            self.final = params
            await loop.delay(self.delay_between * (0.5 + rng.random01()))

    async def check(self, db, cluster) -> bool:
        from ..client.management import get_configuration

        conf = await get_configuration(db)
        for k, v in self.final.items():
            if conf.get(k) != v:
                return False

        # The database must still commit and read through whatever
        # generations the churn caused.
        async def probe(tr):
            tr.set(b"conf_probe", b"alive")

        await db.run(probe)
        out = {}

        async def read(tr):
            out["v"] = await tr.get(b"conf_probe")

        await db.run(read)
        return out["v"] == b"alive"
