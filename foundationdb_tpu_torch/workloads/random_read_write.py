"""RandomReadWrite: uniform-key read/write load, low contention.

The port's own copy of the reference package's
``workloads/random_read_write.py``.

Ref: fdbserver/workloads/ReadWrite.actor.cpp — N parallel actors each run
transactions with `reads_per_txn` point reads and `writes_per_txn` point
writes over a uniform keyspace; the counter invariant (every write is
`actor_id:seq`, checked for well-formedness at the end) plus throughput
counters.  This is BASELINE.json config 3 ("RandomReadWrite, 1 resolver,
uniform keys, low contention") — the differential acceptance gate runs it
against both conflict backends and compares histories.
"""

from __future__ import annotations

from .base import TestWorkload


class RandomReadWriteWorkload(TestWorkload):
    name = "random_read_write"

    def __init__(
        self,
        nodes: int = 200,
        actors: int = 4,
        txns_per_actor: int = 10,
        reads_per_txn: int = 3,
        writes_per_txn: int = 2,
        prefix: bytes = b"rrw/",
    ):
        self.nodes = nodes
        self.actors = actors
        self.txns_per_actor = txns_per_actor
        self.reads_per_txn = reads_per_txn
        self.writes_per_txn = writes_per_txn
        self.prefix = prefix
        self.committed = 0
        self.conflicts = 0

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%08d" % i

    async def setup(self, db, cluster):
        async def init(tr):
            for i in range(0, self.nodes, 4):  # sparse initial population
                tr.set(self._key(i), b"init")

        await db.run(init)

    async def start(self, db, cluster):
        from ..flow.eventloop import all_of

        rng = cluster.loop.rng

        async def actor(aid: int):
            for seq in range(self.txns_per_actor):

                async def op(tr):
                    for _ in range(self.reads_per_txn):
                        await tr.get(self._key(int(rng.random_int(0, self.nodes))))
                    for _ in range(self.writes_per_txn):
                        tr.set(
                            self._key(int(rng.random_int(0, self.nodes))),
                            b"a%02d:%04d" % (aid, seq),
                        )

                await db.run(op)
                self.committed += 1

        await all_of(
            [
                db.process.spawn(actor(a), f"rrw_{a}")
                for a in range(self.actors)
            ]
        )

    async def check(self, db, cluster) -> bool:
        out = {}

        async def read(tr):
            out["rows"] = await tr.get_range(self.prefix, self.prefix + b"\xff")

        await db.run(read)
        # Every value must be an init marker or a well-formed actor write.
        for k, v in out["rows"]:
            if v == b"init":
                continue
            if not (v.startswith(b"a") and b":" in v):
                return False
        return self.committed == self.actors * self.txns_per_actor
