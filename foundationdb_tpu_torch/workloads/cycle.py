"""Cycle workload: transactional pointer-chasing ring.

The port's own copy of the reference package's ``workloads/cycle.py``.

Ref: fdbserver/workloads/Cycle.actor.cpp — N nodes form a permutation
cycle; each transaction rotates three pointers; serializability keeps the
ring a single cycle through any concurrency, kills, or clogging.
"""

from __future__ import annotations

from .base import TestWorkload


class CycleWorkload(TestWorkload):
    name = "cycle"

    def __init__(self, nodes: int = 8, ops: int = 40, actors: int = 3,
                 prefix: bytes = b"cycle/"):
        self.nodes = nodes
        self.ops = ops
        self.actors = actors
        self.prefix = prefix

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    async def setup(self, db, cluster):
        async def init(tr):
            for i in range(self.nodes):
                tr.set(self._key(i), b"%04d" % ((i + 1) % self.nodes))

        await db.run(init)

    async def start(self, db, cluster):
        from ..flow.eventloop import all_of

        rng = cluster.loop.rng

        async def actor():
            for _ in range(self.ops):

                async def op(tr):
                    a = int(rng.random_int(0, self.nodes))
                    ka = self._key(a)
                    b = int((await tr.get(ka)).decode())
                    kb = self._key(b)
                    c = int((await tr.get(kb)).decode())
                    kc = self._key(c)
                    d = int((await tr.get(kc)).decode())
                    tr.set(ka, b"%04d" % c)
                    tr.set(kc, b"%04d" % b)
                    tr.set(kb, b"%04d" % d)

                await db.run(op)

        await all_of(
            [db.process.spawn(actor(), "cycle_actor") for _ in range(self.actors)]
        )

    async def check(self, db, cluster) -> bool:
        out = {}

        async def read(tr):
            out["ring"] = await tr.get_range(
                self.prefix, self.prefix + b"\xff"
            )

        await db.run(read)
        ring = {k: int(v.decode()) for k, v in out["ring"]}
        if len(ring) != self.nodes:
            return False
        seen, cur = set(), 0
        for _ in range(self.nodes):
            if cur in seen:
                return False
            seen.add(cur)
            cur = ring[self._key(cur)]
        return cur == 0 and len(seen) == self.nodes
