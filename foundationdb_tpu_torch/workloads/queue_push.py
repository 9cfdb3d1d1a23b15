"""QueuePush: a dense ordered queue built under append contention.

The port's own copy of the reference package's ``workloads/queue_push.py``.

Ref: fdbserver/workloads/QueuePush.actor.cpp — many clients append to one
queue by reading the current last key and writing last+1.  Every pair of
concurrent pushes conflicts on the tail read, so the workload hammers the
resolver's hottest pattern (all transactions conflicting on one range);
the invariant is that the final queue is DENSE and ORDERED: indices
0..N-1 each present exactly once, N = number of acknowledged pushes — a
lost update leaves a hole, a double-applied retry leaves a duplicate
value.  Unknown-result retries are disambiguated by writing the pusher's
identity into the value and deduping by marker, exactly the discipline
the reference's versionstamped queue recipes replace this with.
"""

from __future__ import annotations

from ..flow.error import FdbError
from .base import TestWorkload


class QueuePushWorkload(TestWorkload):
    name = "queue_push"

    def __init__(self, actors: int = 4, pushes: int = 8,
                 prefix: bytes = b"qp/"):
        self.actors = actors
        self.pushes = pushes
        self.prefix = prefix
        self.acked = 0

    def _key(self, i: int) -> bytes:
        return self.prefix + b"q%08d" % i

    async def start(self, db, cluster):
        from ..flow.eventloop import all_of

        async def actor(aid: int):
            for seq in range(self.pushes):
                ident = b"%02d:%04d" % (aid, seq)

                async def push(tr, ident=ident):
                    # Full-queue read: the tail registers the serializing
                    # conflict, and scanning all values makes the
                    # unknown-result retry correct even when OTHER pushes
                    # landed between our unacked commit and the retry.
                    rows = await tr.get_range(
                        self.prefix + b"q", self.prefix + b"r"
                    )
                    if any(v == ident for _k, v in rows):
                        return  # unknown-result retry: already landed
                    nxt = (
                        int(rows[-1][0][len(self.prefix) + 1:]) + 1
                        if rows else 0
                    )
                    tr.set(self._key(nxt), ident)

                try:
                    await db.run(push)
                except FdbError:
                    continue  # not acked: may or may not have landed
                self.acked += 1

        await all_of(
            [
                db.process.spawn(actor(a), f"qp{a}")
                for a in range(self.actors)
            ]
        )

    async def check(self, db, cluster) -> bool:
        out = {}

        async def read(tr):
            out["rows"] = await tr.get_range(
                self.prefix + b"q", self.prefix + b"r"
            )

        await db.run(read)
        rows = out["rows"]
        indices = [int(k[len(self.prefix) + 1:]) for k, _v in rows]
        assert indices == list(range(len(rows))), (
            f"queue not dense/ordered: {indices[:20]}"
        )
        values = [v for _k, v in rows]
        assert len(set(values)) == len(values), "duplicate push applied"
        assert len(rows) >= self.acked, (
            f"{self.acked} acked pushes but only {len(rows)} present"
        )
        return True
