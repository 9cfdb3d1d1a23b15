"""SlowTaskWorkload: the slow-task profiler catches reactor hogs.

The port's own copy of the reference package's ``workloads/slow_task.py``.

Ref: fdbserver/workloads/SlowTaskWorkload.actor.cpp — deliberately burn
the event loop inside one task and assert the runtime's slow-task
profiler surfaced it (a SlowTask trace event with the wall cost).  The
profiler is the production tool for "one actor stalls the whole
process"; this workload is its liveness check.
"""

from __future__ import annotations

import time

from .base import TestWorkload


class SlowTaskWorkload(TestWorkload):
    name = "slow_task"

    def __init__(self, burn_wall_s: float = 0.01):
        self.burn_wall_s = burn_wall_s

    async def start(self, db, cluster):
        from ..flow.trace import global_collector

        loop = cluster.loop
        self._collector = global_collector()
        # Baseline on the COMPLETE per-type tally, not an index into
        # find(): on a file-backed collector find() answers from the
        # bounded recent ring, so index slicing would mis-slice once the
        # ring rotates (flow/trace.py).
        self._before = self._collector.counts.get("SlowTask", 0)
        old = loop.slow_task_threshold
        loop.slow_task_threshold = self.burn_wall_s / 4
        try:
            # One loop step that burns real wall clock: exactly what the
            # profiler exists to catch.
            async def hog():
                t0 = time.perf_counter()  # fdblint: ignore[DET001]: the workload's PURPOSE is burning real cpu to trip the slow-task profiler; no virtual-time decision depends on it
                while time.perf_counter() - t0 < self.burn_wall_s:  # fdblint: ignore[DET001]: the same deliberate burn, its loop test; no virtual-time decision depends on it
                    sum(range(500))

            await db.process.spawn(hog(), "deliberate_hog")
            await loop.delay(0.01)
        finally:
            loop.slow_task_threshold = old

    async def check(self, db, cluster) -> bool:
        n_new = self._collector.counts.get("SlowTask", 0) - self._before
        assert n_new > 0, "slow-task profiler missed a deliberate reactor hog"
        # The still-retained tail of the new events (all of them for an
        # in-memory collector; the recent-ring remainder for file-backed).
        events = self._collector.find("SlowTask")
        fresh = events[max(0, len(events) - n_new):]
        assert fresh, "slow-task profiler missed a deliberate reactor hog"
        assert any(
            e.get("wall_seconds", 0) >= self.burn_wall_s / 4
            for e in fresh
        ), f"SlowTask events lack the wall cost: {fresh[:2]}"
        return True
