"""ConflictRange: conflicts happen EXACTLY when they should.

The port's own copy of the reference package's ``workloads/conflict_range.py``.

Ref: fdbserver/workloads/ConflictRange.actor.cpp — a transaction performs
a ranged read while another commits a mutation; the first must conflict
IFF the mutation intersects the range it actually observed.  Both
failure directions matter: a missed conflict is a serializability
violation, a spurious one means the resolver (the north-star engine) or
the client's conflict-range bookkeeping over-approximates — in
particular, a limit-truncated get_range must register only the extent it
returned (ref: RYW readThrough trimming on limited reads,
fdbclient/ReadYourWrites.actor.cpp).
"""

from __future__ import annotations

from ..client.types import key_after
from ..flow.error import FdbError
from .base import TestWorkload


class ConflictRangeWorkload(TestWorkload):
    name = "conflict_range"

    def __init__(self, keyspace: int = 60, iterations: int = 40,
                 prefix: bytes = b"cr/", seed_keys: int = 25):
        self.keyspace = keyspace
        self.iterations = iterations
        self.prefix = prefix
        self.seed_keys = seed_keys
        self.checked = 0
        self.conflicts = 0

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    async def setup(self, db, cluster):
        rng = cluster.loop.rng

        async def fill(tr):
            for _ in range(self.seed_keys):
                i = int(rng.random_int(0, self.keyspace))
                tr.set(self._key(i), b"v%d" % i)

        await db.run(fill)

    async def start(self, db, cluster):
        rng = cluster.loop.rng
        for it in range(self.iterations):
            lo = int(rng.random_int(0, self.keyspace - 1))
            hi = int(rng.random_int(lo + 1, self.keyspace))
            limit = int(rng.random_int(1, 6))
            begin, end = self._key(lo), self._key(hi)

            reader = db.create_transaction()
            try:
                rows = await reader.get_range(begin, end, limit=limit)
            except FdbError:
                continue  # e.g. recovery window; nothing asserted
            # The extent the reader OBSERVED (and must conflict over).
            if len(rows) >= limit and rows:
                obs_end = key_after(rows[-1][0])
            else:
                obs_end = end

            # A second client commits one mutation strictly after the
            # reader's snapshot.
            mk = int(rng.random_int(0, self.keyspace))
            do_clear = rng.random_int(0, 3) == 0
            ck_end = min(self.keyspace, mk + 1 + int(rng.random_int(0, 4)))

            async def mutate(tr, mk=mk, do_clear=do_clear, ck_end=ck_end):
                if do_clear:
                    tr.clear_range(self._key(mk), self._key(ck_end))
                else:
                    tr.set(self._key(mk), b"m%d" % mk)

            await db.run(mutate)
            if do_clear:
                w_begin, w_end = self._key(mk), self._key(ck_end)
            else:
                w_begin, w_end = self._key(mk), key_after(self._key(mk))

            expect_conflict = (w_begin < obs_end) and (begin < w_end)
            reader.set(self.prefix + b"!dummy", b"%d" % it)
            try:
                await reader.commit()
                got_conflict = False
            except FdbError as e:
                if e.name == "not_committed":
                    got_conflict = True
                elif e.name in ("commit_unknown_result", "future_version",
                                "transaction_too_old"):
                    continue  # outcome unknowable; nothing asserted
                else:
                    raise
            assert got_conflict == expect_conflict, (
                f"iteration {it}: read [{begin}..{end}) limit={limit} "
                f"observed-through {obs_end}; mutation [{w_begin}..{w_end}) "
                f"=> expected conflict={expect_conflict}, got {got_conflict}"
            )
            self.checked += 1
            self.conflicts += int(got_conflict)

    async def check(self, db, cluster) -> bool:
        # Both behaviors must have been exercised, or the seed was vacuous.
        return self.checked >= self.iterations // 2 and (
            0 < self.conflicts < self.checked
        )
