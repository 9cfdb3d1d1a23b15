"""IndexScan: long paged scans stay byte-exact while shards move.

The port's own copy of the reference package's ``workloads/index_scan.py``.

Ref: fdbserver/workloads/IndexScan.actor.cpp — continuous ordered range
scans over a static dataset; composed with shard-moving chaos
(RandomMoveKeys) the scan must stay BYTE-EXACT and dense end to end:
every page boundary crosses whatever shard layout exists at that moment,
so stale location caches, wrong_shard_server reroutes, and mid-scan
handoffs all land inside one logical scan.
"""

from __future__ import annotations

from ..client.types import key_after
from ..flow.error import FdbError
from .base import TestWorkload


class IndexScanWorkload(TestWorkload):
    name = "index_scan"

    def __init__(self, rows: int = 120, scans: int = 12, page: int = 17,
                 prefix: bytes = b"ix/"):
        self.rows = rows
        self.scans = scans
        self.page = page  # deliberately not a divisor of rows
        self.prefix = prefix
        self.completed = 0

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%06d" % i

    def _val(self, i: int) -> bytes:
        return b"row-%d-%d" % (i, (i * 2654435761) % 997)

    async def setup(self, db, cluster):
        for lo in range(0, self.rows, 40):
            async def fill(tr, lo=lo):
                for i in range(lo, min(self.rows, lo + 40)):
                    tr.set(self._key(i), self._val(i))

            await db.run(fill)

    async def start(self, db, cluster):
        loop = cluster.loop
        want = [(self._key(i), self._val(i)) for i in range(self.rows)]
        for s in range(self.scans):
            got = []
            cursor = self.prefix
            ok = True
            while True:
                rows = None

                async def page_read(tr, cursor=cursor):
                    return await tr.get_range(
                        cursor, self.prefix + b"\xff", limit=self.page
                    )

                try:
                    rows = await db.run(page_read)
                except FdbError:
                    ok = False  # scan aborted (recovery); retry whole scan
                    break
                got.extend(rows)
                if len(rows) < self.page:
                    break
                cursor = key_after(rows[-1][0])
            if not ok:
                await loop.delay(0.1)
                continue
            assert got == want, (
                f"scan {s}: {len(got)} rows vs {len(want)}; first diff at "
                f"{next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), 'len')}"
            )
            self.completed += 1
            await loop.delay(0.05)

    async def check(self, db, cluster) -> bool:
        return self.completed >= self.scans // 2
