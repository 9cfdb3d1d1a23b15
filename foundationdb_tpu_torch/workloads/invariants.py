"""Invariant workloads: atomic-op ledger accounting and write-skew prevention.

The port's own copy of the reference package's ``workloads/invariants.py``.

The full reference-shaped AtomicOps / Serializability workloads live in
atomic_ops.py / serializability.py; these two are their lightweight,
chaos-cheap cousins kept for the randomized sweeps.

Ref: fdbserver/workloads/AtomicOps.actor.cpp (per-actor ADD streams whose
ledger and sum tables must agree) and the Serializability family — two
transactions reading overlapping state and writing based on it must never
both commit (classic write-skew).
"""

from __future__ import annotations

from ..client.types import MutationType
from ..flow.error import FdbError
from .base import TestWorkload


class AtomicLedgerWorkload(TestWorkload):
    """Each actor streams ADDs into a per-actor log key AND a shared total;
    the check phase asserts the shared total equals the sum of the logs
    (ref: AtomicOps' log/ops table comparison)."""

    name = "atomic_ledger"

    def __init__(self, actors: int = 3, ops: int = 20, prefix: bytes = b"ao/"):
        self.actors = actors
        self.ops = ops
        self.prefix = prefix

    async def start(self, db, cluster):
        from ..flow.eventloop import all_of

        rng = cluster.loop.rng

        def actor(aid):
            async def go():
                for _ in range(self.ops):
                    amount = int(rng.random_int(1, 100))

                    async def op(tr, amount=amount):
                        enc = amount.to_bytes(8, "little")
                        tr.atomic_op(
                            MutationType.ADD_VALUE,
                            self.prefix + b"log/%02d" % aid,
                            enc,
                        )
                        tr.atomic_op(
                            MutationType.ADD_VALUE, self.prefix + b"total", enc
                        )

                    await db.run(op)

            return go()

        await all_of(
            [
                db.process.spawn(actor(a), f"ao_actor{a}")
                for a in range(self.actors)
            ]
        )

    async def check(self, db, cluster) -> bool:
        out = {}

        async def rd(tr):
            rows = await tr.get_range(
                self.prefix + b"log/", self.prefix + b"log0"
            )
            out["logs"] = sum(
                int.from_bytes(v, "little") for _k, v in rows
            )
            t = await tr.get(self.prefix + b"total")
            out["total"] = int.from_bytes(t or b"", "little")

        await db.run(rd)
        return out["total"] == out["logs"] and out["total"] > 0


class WriteSkewWorkload(TestWorkload):
    """Write-skew probes: pairs of transactions each read BOTH flag keys
    and set their own only if the other is unset; serializability admits at
    most one winner per round, and the check asserts no round ever ended
    with both flags set."""

    name = "write_skew"

    def __init__(self, rounds: int = 10, prefix: bytes = b"ser/"):
        self.rounds = rounds
        self.prefix = prefix

    async def start(self, db, cluster):
        from ..flow.eventloop import all_of

        for r in range(self.rounds):
            ka = self.prefix + b"%03d/a" % r
            kb = self.prefix + b"%03d/b" % r

            def contender(mine, other):
                async def go():
                    tr = db.create_transaction()
                    try:
                        his = await tr.get(other)
                        if his is None:
                            tr.set(mine, b"1")
                        await tr.commit()
                    except FdbError as e:
                        if not e.is_retryable_in_transaction():
                            raise
                        # Lost the race: do NOT retry (the probe is
                        # one-shot; a retry would legitimately see the
                        # winner's flag and back off).

                return go()

            await all_of(
                [
                    db.process.spawn(contender(ka, kb), "ser_a"),
                    db.process.spawn(contender(kb, ka), "ser_b"),
                ]
            )

    async def check(self, db, cluster) -> bool:
        out = {}

        async def rd(tr):
            out["rows"] = dict(
                await tr.get_range(self.prefix, self.prefix + b"\xff")
            )

        await db.run(rd)
        for r in range(self.rounds):
            a = out["rows"].get(self.prefix + b"%03d/a" % r)
            b = out["rows"].get(self.prefix + b"%03d/b" % r)
            if a is not None and b is not None:
                return False  # write skew: both contenders committed
        return True
