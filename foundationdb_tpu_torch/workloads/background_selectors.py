"""BackgroundSelectors: key-selector resolution stays snapshot-consistent
while the keyspace churns underneath.

The port's own copy of the reference package's
``workloads/background_selectors.py``.

Ref: fdbserver/workloads/BackgroundSelectors.actor.cpp — one actor
resolves randomized relative selectors while others insert and delete
around the probe points; each resolution is validated against a range
read IN THE SAME TRANSACTION (one snapshot), so any cross-shard /
cache-staleness drift in selector resolution shows as a mismatch even
though the global state never stops moving.
"""

from __future__ import annotations

from ..client.transaction import KeySelector
from ..flow.error import FdbError
from .base import TestWorkload


class BackgroundSelectorsWorkload(TestWorkload):
    name = "background_selectors"

    def __init__(self, keyspace: int = 40, probes: int = 25,
                 churners: int = 2, prefix: bytes = b"bsel/"):
        self.keyspace = keyspace
        self.probes = probes
        self.churners = churners
        self.prefix = prefix
        self.checked = 0
        self._stop = False

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    async def setup(self, db, cluster):
        async def fill(tr):
            for i in range(0, self.keyspace, 2):
                tr.set(self._key(i), b"v%d" % i)

        await db.run(fill)

    async def start(self, db, cluster):
        from ..flow.eventloop import all_of

        rng = cluster.loop.rng
        loop = cluster.loop

        async def churn(aid: int):
            while not self._stop:
                i = int(rng.random_int(0, self.keyspace))

                async def op(tr, i=i):
                    if rng.random_int(0, 2) == 0:
                        tr.set(self._key(i), b"c%d" % aid)
                    else:
                        tr.clear(self._key(i))

                try:
                    await db.run(op)
                except FdbError:
                    pass
                await loop.delay(0.01)

        churners = [
            db.process.spawn(churn(a), f"bsel_churn{a}")
            for a in range(self.churners)
        ]
        try:
            for _p in range(self.probes):
                anchor = self._key(int(rng.random_int(0, self.keyspace)))
                offset = int(rng.random_int(1, 4))
                or_equal = bool(rng.random_int(0, 2))

                async def probe(tr, anchor=anchor, offset=offset,
                                or_equal=or_equal):
                    from .write_during_read import (
                        clamp_to_prefix,
                        model_get_key,
                    )

                    sel = KeySelector(anchor, or_equal, offset)
                    resolved = await tr.get_key(sel)
                    rows = await tr.get_range(
                        self.prefix, self.prefix + b"\xff", snapshot=True
                    )
                    # CLAMPED comparison (the discipline
                    # selector_correctness already uses): get_key resolves
                    # over the WHOLE keyspace, so a probe walking past this
                    # workload's slice may land on a co-running workload's
                    # key — both sides clamp to the prefix so the model
                    # only asserts what this slice determines.
                    want = model_get_key(dict(rows), sel)
                    got_c = clamp_to_prefix(resolved, self.prefix)
                    want_c = clamp_to_prefix(want, self.prefix)
                    assert got_c == want_c, (
                        f"selector({anchor}, or_equal={or_equal}, "
                        f"+{offset}) -> {resolved} (clamped {got_c}), "
                        f"model {want} (clamped {want_c})"
                    )

                try:
                    await db.run(probe)
                    self.checked += 1
                except FdbError:
                    continue
                await loop.delay(0.02)
        finally:
            self._stop = True
            await all_of(churners)

    async def check(self, db, cluster) -> bool:
        return self.checked >= self.probes // 2
