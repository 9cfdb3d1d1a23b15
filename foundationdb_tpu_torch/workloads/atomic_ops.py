"""AtomicOps: atomic ADDs under contention must never lose or double-count.

The port's own copy of the reference package's ``workloads/atomic_ops.py``.

Ref: fdbserver/workloads/AtomicOps.actor.cpp — every transaction both
atomic-adds into a contended per-group sum key AND writes a private log
entry recording the operand; the check re-derives each group's sum from
its log and compares exactly.  Because both writes ride one transaction,
any lost/duplicated atomic op (under retries, recoveries, kills) breaks
the equality.
"""

from __future__ import annotations

from ..client.types import MutationType
from .base import TestWorkload


def _le8(v: int) -> bytes:
    return (v & (1 << 64) - 1).to_bytes(8, "little")


class AtomicOpsWorkload(TestWorkload):
    name = "atomic_ops"

    def __init__(self, groups: int = 2, actors: int = 3, ops: int = 8,
                 prefix: bytes = b"ao/"):
        self.groups = groups
        self.actors = actors
        self.ops = ops
        self.prefix = prefix

    def _sum_key(self, g: int) -> bytes:
        return self.prefix + b"sum/%02d" % g

    def _log_key(self, g: int, aid: int, seq: int) -> bytes:
        return self.prefix + b"log/%02d/%02d_%04d" % (g, aid, seq)

    async def start(self, db, cluster):
        from ..flow.eventloop import all_of

        rng = cluster.loop.rng

        async def actor(aid: int):
            for seq in range(self.ops):
                g = int(rng.random_int(0, self.groups))
                x = 1 + int(rng.random_int(0, 100))

                async def op(tr, g=g, x=x, aid=aid, seq=seq):
                    # Unknown-result idempotence: the log entry doubles as
                    # the per-op marker — if it exists, the earlier attempt
                    # (sum add included, same txn) already landed.
                    lk = self._log_key(g, aid, seq)
                    if await tr.get(lk) is not None:
                        return
                    tr.atomic_op(MutationType.ADD_VALUE, self._sum_key(g), _le8(x))
                    tr.set(lk, _le8(x))

                await db.run(op)

        await all_of(
            [db.process.spawn(actor(a), f"ao{a}") for a in range(self.actors)]
        )

    async def check(self, db, cluster) -> bool:
        out = {}

        async def read(tr):
            out["sums"] = await tr.get_range(
                self.prefix + b"sum/", self.prefix + b"sum0"
            )
            out["logs"] = await tr.get_range(
                self.prefix + b"log/", self.prefix + b"log0"
            )

        await db.run(read)
        expected = {}
        for k, v in out["logs"]:
            g = k.split(b"/")[-2]
            expected[g] = expected.get(g, 0) + int.from_bytes(v, "little")
        actual = {
            k.split(b"/")[-1]: int.from_bytes(v, "little")
            for k, v in out["sums"]
        }
        total_ops = self.actors * self.ops
        return (
            len(out["logs"]) == total_ops
            and actual == expected
        )
