"""Inventory: stock conservation through concurrent transactional moves.

The port's own copy of the reference package's ``workloads/inventory.py``.

Ref: fdbserver/workloads/Inventory.actor.cpp — clients transact against a
product inventory; the invariant is CONSERVATION: units are moved, never
created or destroyed, so the grand total after any amount of contention,
retries, and chaos equals the seeded total exactly.  (Same family as
Increment/Cycle but over a two-sided move, which a lost update or a
half-applied transaction breaks in either direction.)
"""

from __future__ import annotations

from .base import TestWorkload


class InventoryWorkload(TestWorkload):
    name = "inventory"

    def __init__(self, products: int = 6, actors: int = 3, moves: int = 12,
                 initial: int = 100, prefix: bytes = b"inv/"):
        self.products = products
        self.actors = actors
        self.moves = moves
        self.initial = initial
        self.prefix = prefix

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    async def setup(self, db, cluster):
        async def fill(tr):
            for i in range(self.products):
                tr.set(self._key(i), b"%d" % self.initial)

        await db.run(fill)

    async def start(self, db, cluster):
        from ..flow.eventloop import all_of

        rng = cluster.loop.rng

        async def actor(aid: int):
            for seq in range(self.moves):
                src = int(rng.random_int(0, self.products))
                dst = int(rng.random_int(0, self.products))
                amount = int(rng.random_int(1, 10))
                marker = self.prefix + b"!mv%02d_%04d" % (aid, seq)

                async def move(tr, src=src, dst=dst, amount=amount,
                               marker=marker):
                    # Idempotence marker: an unknown-result retry whose
                    # original landed must not move the stock twice.
                    if await tr.get(marker) is not None:
                        return
                    s = int(await tr.get(self._key(src)) or b"0")
                    take = min(s, amount)
                    d = int(await tr.get(self._key(dst)) or b"0")
                    if src != dst:
                        tr.set(self._key(src), b"%d" % (s - take))
                        tr.set(self._key(dst), b"%d" % (d + take))
                    tr.set(marker, b"done")

                await db.run(move)

        await all_of(
            [
                db.process.spawn(actor(a), f"inv{a}")
                for a in range(self.actors)
            ]
        )

    async def check(self, db, cluster) -> bool:
        out = {}

        async def read(tr):
            # [prefix+"0", prefix+":") covers the %04d product keys and
            # excludes the "!mv" idempotence markers ("!" < "0").
            rows = await tr.get_range(self.prefix + b"0", self.prefix + b":")
            out["total"] = sum(int(v) for _k, v in rows)
            out["negative"] = [
                (k, v) for k, v in rows if int(v) < 0
            ]

        await db.run(read)
        expected = self.products * self.initial
        assert out["total"] == expected, (
            f"stock not conserved: {out['total']} != {expected}"
        )
        assert not out["negative"], f"negative stock: {out['negative']}"
        return True
