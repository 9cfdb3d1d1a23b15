"""DDBalance: data distribution converges to balanced shard counts.

The port's own copy of the reference package's ``workloads/dd_balance.py``.

Ref: fdbserver/workloads/DDBalance.actor.cpp — load spread over many
shards; the check is that DD's placement ends BALANCED: per-storage
serving shard counts within a tolerance, no shard stuck mid-move.  Run
with sim-scaled split thresholds so enough shards exist to balance.

The CALLER starts the DD role with sim-scaled split thresholds
(``c.dd_role(shard_max_bytes=<low>, shard_min_bytes=0)``); the workload
itself moves nothing.
"""

from __future__ import annotations

from .base import TestWorkload


class DDBalanceWorkload(TestWorkload):
    name = "dd_balance"

    def __init__(self, rows: int = 240, value_len: int = 40,
                 tolerance: int = 2, prefix: bytes = b"ddb/"):
        self.rows = rows
        self.value_len = value_len
        self.tolerance = tolerance
        self.prefix = prefix
        self.final_counts = {}

    async def start(self, db, cluster):
        loop = cluster.loop
        for j in range(8):

            async def load(tr, j=j):
                for i in range(self.rows // 8):
                    tr.set(
                        self.prefix + b"%d%04d" % (j, i),
                        b"x" * self.value_len,
                    )

            await db.run(load)
        # Wait for split + rebalance to settle into tolerance.
        end = loop.now() + 40.0
        while loop.now() < end:
            counts = await self._shard_counts(db)
            self.final_counts = counts
            if (
                len(counts) >= 2
                and sum(counts.values()) >= 4
                and max(counts.values()) - min(counts.values())
                <= self.tolerance
            ):
                return
            await loop.delay(1.0)

    async def _shard_counts(self, db):
        from ..server import system_keys as sk

        async def txn(tr):
            tr.options["access_system_keys"] = True
            rows = await tr.get_range(
                sk.KEY_SERVERS_PREFIX, sk.KEY_SERVERS_END
            )
            counts: dict = {}
            for k, v in rows:
                src, dest, _end = sk.decode_key_servers(v)
                if dest:
                    continue  # mid-move; counted next poll
                for sid in src:
                    counts[sid] = counts.get(sid, 0) + 1
            return counts

        return await db.run(txn)

    async def check(self, db, cluster) -> bool:
        counts = self.final_counts
        assert len(counts) >= 2, f"no distribution happened: {counts}"
        spread = max(counts.values()) - min(counts.values())
        assert spread <= self.tolerance, (
            f"unbalanced placement: {counts} (spread {spread})"
        )
        return True
