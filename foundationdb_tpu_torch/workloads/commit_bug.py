"""CommitBugCheck: committed writes are exactly-once and immediately
visible to the committer.

The port's own copy of the reference package's ``workloads/commit_bug.py``.

Ref: fdbserver/workloads/CommitBugCheck.actor.cpp — regression probes for
two historical commit bugs: (bug2) a client that commits value i+1 and
then reads with a fresh transaction must see EXACTLY i+1 — a smaller
value is a causality violation (GRV behind own commit), a larger one a
double-applied retry; (bug1 flavor) set/clear cycles under
commit_unknown_result must converge to the final committed state, never
a resurrected value.
"""

from __future__ import annotations

from ..flow.error import FdbError
from .base import TestWorkload


class CommitBugWorkload(TestWorkload):
    name = "commit_bug"

    def __init__(self, iterations: int = 30, prefix: bytes = b"cb/"):
        self.iterations = iterations
        self.prefix = prefix

    async def start(self, db, cluster):
        key = self.prefix + b"counter"
        i = 0
        while i < self.iterations:
            tr = db.create_transaction()
            try:
                val = await tr.get(key)
                num = int(val) if val is not None else 0
                assert num == i, (
                    f"iteration {i}: read {num} — "
                    + ("causality violation (own commit invisible)"
                       if num < i else "double-applied commit")
                )
                tr.set(key, b"%d" % (i + 1))
                await tr.commit()
                i += 1
            except FdbError as e:
                if e.name == "commit_unknown_result":
                    # Disambiguate by reading back: the counter IS the
                    # marker (monotone, single writer).
                    out = {}

                    async def probe(t2):
                        out["v"] = await t2.get(key)

                    await db.run(probe)
                    if out["v"] is not None and int(out["v"]) == i + 1:
                        i += 1
                    continue
                if e.name in ("not_committed", "transaction_too_old",
                              "future_version", "broken_promise",
                              "process_behind"):
                    continue
                raise

        # bug1 flavor: set/clear churn converges to the cleared state.
        for r in range(6):
            k = self.prefix + b"sc%d" % (r % 2)

            async def set_it(tr, k=k, r=r):
                tr.set(k, b"v%d" % r)

            async def clear_it(tr, k=k):
                tr.clear(k)

            await db.run(set_it)
            await db.run(clear_it)
        out = {}

        async def final(tr):
            out["rows"] = await tr.get_range(
                self.prefix + b"sc", self.prefix + b"sd"
            )

        await db.run(final)
        assert out["rows"] == [], f"cleared keys resurrected: {out['rows']}"

    async def check(self, db, cluster) -> bool:
        out = {}

        async def read(tr):
            out["v"] = await tr.get(self.prefix + b"counter")

        await db.run(read)
        assert int(out["v"]) == self.iterations
        return True
