"""Increment: concurrent read-modify-write counters sum exactly.

The port's own copy of the reference package's ``workloads/increment.py``.

Ref: fdbserver/workloads/Increment.actor.cpp — N actors each perform M
serializable increments of random counters; the grand total must equal
exactly N*M through any conflicts and retries (lost updates are the
failure serializability forbids).
"""

from __future__ import annotations

from .base import TestWorkload


class IncrementWorkload(TestWorkload):
    name = "increment"

    def __init__(self, counters: int = 3, actors: int = 3, ops: int = 10,
                 prefix: bytes = b"incr/"):
        self.counters = counters
        self.actors = actors
        self.ops = ops
        self.prefix = prefix

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%03d" % i

    async def start(self, db, cluster):
        from ..flow.eventloop import all_of

        rng = cluster.loop.rng

        async def actor(aid: int):
            for seq in range(self.ops):
                # Per-op idempotence marker: a retry after
                # commit_unknown_result whose original actually LANDED
                # must not increment twice (same discipline as
                # WriteDuringRead's marker probe) — db.run retries
                # unknown results blindly.
                marker = self.prefix + b"!op%02d_%04d" % (aid, seq)

                async def op(tr, marker=marker):
                    if await tr.get(marker) is not None:
                        return  # the earlier attempt committed
                    k = self._key(int(rng.random_int(0, self.counters)))
                    cur = await tr.get(k)
                    tr.set(k, b"%d" % (int(cur or b"0") + 1))
                    tr.set(marker, b"done")

                await db.run(op)

        await all_of(
            [
                db.process.spawn(actor(a), f"incr{a}")
                for a in range(self.actors)
            ]
        )

    async def check(self, db, cluster) -> bool:
        out = {}

        async def read(tr):
            out["rows"] = await tr.get_range(self.prefix, self.prefix + b"\xff")

        await db.run(read)
        total = sum(
            int(v)
            for k, v in out["rows"]
            if not k.startswith(self.prefix + b"!")  # skip op markers
        )
        return total == self.actors * self.ops
