"""BulkLoad: sequential batched loading lands every row byte-exact.

The port's own copy of the reference package's ``workloads/bulk_load.py``.

Ref: fdbserver/workloads/BulkLoad.actor.cpp (+ BulkSetup.actor.h, the
setup helper most reference workloads share) — load N rows in fixed-size
transaction batches, then verify presence, order, and byte-exact values
with ranged reads; a dropped batch, a partially applied batch, or a
shard-move race during loading each break it differently.
"""

from __future__ import annotations

from .base import TestWorkload


class BulkLoadWorkload(TestWorkload):
    name = "bulk_load"

    def __init__(self, rows: int = 400, batch: int = 50,
                 value_len: int = 64, prefix: bytes = b"bulk/"):
        self.rows = rows
        self.batch = batch
        self.value_len = value_len
        self.prefix = prefix

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%08d" % i

    def _val(self, i: int) -> bytes:
        seed = b"%d|" % (i * 2654435761 % (1 << 32))
        return (seed * (self.value_len // len(seed) + 1))[: self.value_len]

    async def start(self, db, cluster):
        for lo in range(0, self.rows, self.batch):
            hi = min(self.rows, lo + self.batch)

            async def load(tr, lo=lo, hi=hi):
                for i in range(lo, hi):
                    tr.set(self._key(i), self._val(i))

            await db.run(load)

    async def check(self, db, cluster) -> bool:
        got = []
        cursor = self.prefix

        async def page(tr):
            nonlocal cursor
            rows = await tr.get_range(
                cursor, self.prefix + b"\xff", limit=128
            )
            got.extend(rows)
            if rows:
                from ..client.types import key_after

                cursor = key_after(rows[-1][0])
            return len(rows)

        while await db.run(page) > 0:
            pass
        assert len(got) == self.rows, f"{len(got)} rows != {self.rows}"
        for i, (k, v) in enumerate(got):
            assert k == self._key(i) and v == self._val(i), (
                f"row {i} wrong: {k[:24]}"
            )
        return True
