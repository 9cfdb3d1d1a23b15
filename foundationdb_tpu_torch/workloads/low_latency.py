"""LowLatency: single-op latency stays bounded while the cluster works.

The port's own copy of the reference package's ``workloads/low_latency.py``.

Ref: fdbserver/workloads/LowLatency.actor.cpp — a probe loop issues one
small read or commit at a time and asserts each completes within a
bound; sustained latency above it means the ratekeeper, batching, or
GRV path is starving interactive work even though throughput looks
fine.  Virtual-time flavor: p95 under `p95_bound` and no more than
`slow_fraction` of ops over `slow_bound` (recoveries mid-chaos are
allowed to blow the max, so the max itself is not asserted).
"""

from __future__ import annotations

from ..flow.error import FdbError
from .base import TestWorkload


class LowLatencyWorkload(TestWorkload):
    name = "low_latency"

    def __init__(self, ops: int = 40, p95_bound: float = 0.5,
                 slow_bound: float = 2.0, slow_fraction: float = 0.15,
                 prefix: bytes = b"ll/"):
        self.ops = ops
        self.p95_bound = p95_bound
        self.slow_bound = slow_bound
        self.slow_fraction = slow_fraction
        self.prefix = prefix
        self.latencies = []

    async def start(self, db, cluster):
        loop = cluster.loop
        for n in range(self.ops):
            t0 = loop.now()
            try:
                if n % 2 == 0:

                    async def w(tr, n=n):
                        tr.set(self.prefix + b"%04d" % (n % 8), b"%d" % n)

                    await db.run(w)
                else:

                    async def r(tr, n=n):
                        await tr.get(self.prefix + b"%04d" % (n % 8))

                    await db.run(r)
                self.latencies.append(loop.now() - t0)
            except FdbError:
                self.latencies.append(loop.now() - t0)
            await loop.delay(0.05)

    async def check(self, db, cluster) -> bool:
        lat = sorted(self.latencies)
        assert len(lat) >= self.ops // 2
        p95 = lat[int(len(lat) * 0.95) - 1]
        slow = sum(1 for x in lat if x > self.slow_bound)
        assert p95 <= self.p95_bound, (
            f"p95 latency {p95:.3f} > {self.p95_bound} "
            f"(worst {lat[-1]:.3f})"
        )
        assert slow <= len(lat) * self.slow_fraction, (
            f"{slow}/{len(lat)} ops slower than {self.slow_bound}"
        )
        return True
