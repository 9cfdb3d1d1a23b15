"""TimeKeeperCorrectness: the CC's wall-clock -> version map is sane.

Ref: fdbserver/workloads/TimeKeeperCorrectness.actor.cpp — the workload
records (time, read version) pairs itself while running, then checks the
timeKeeper map against them: samples must be monotone in BOTH time and
version, and mapping any recorded time through the map must return a
version between the versions the workload observed just before and just
after that time (the map is how `fdbbackup restore --timestamp` picks a
restore version, so an off sample silently restores the wrong state).

The port's own copy of the reference package's ``workloads/time_keeper.py``.
"""

from __future__ import annotations

from .base import TestWorkload


class TimeKeeperWorkload(TestWorkload):
    name = "time_keeper"

    def __init__(self, duration: float = 12.0):
        self.duration = duration
        self.observed = []  # (time, read_version) pairs seen by US

    async def start(self, db, cluster):
        loop = cluster.loop
        end = loop.now() + self.duration
        while loop.now() < end:

            async def grv(tr):
                return await tr.get_read_version()

            v = await db.run(grv)
            self.observed.append((loop.now(), v))
            await loop.delay(0.5)

    async def check(self, db, cluster) -> bool:
        from ..client.management import version_from_timestamp
        from ..server.system_keys import (
            TIME_KEEPER_END,
            TIME_KEEPER_PREFIX,
            time_keeper_time,
        )

        out = {}

        async def read(tr):
            tr.options["access_system_keys"] = True
            out["rows"] = await tr.get_range(
                TIME_KEEPER_PREFIX, TIME_KEEPER_END
            )

        await db.run(read)
        samples = [
            (time_keeper_time(k), int(v)) for k, v in out["rows"]
        ]
        assert len(samples) >= 2, f"too few timekeeper samples: {samples}"
        times = [t for t, _v in samples]
        vers = [v for _t, v in samples]
        assert times == sorted(times) and len(set(times)) == len(times)
        assert vers == sorted(vers), "versions not monotone over time"

        # Mapping consistency against our own observations.  Sample keys
        # have ONE-SECOND granularity (int(now), like the reference's
        # epoch-second map keys), so a sample keyed at second ⌊T⌋ may have
        # been taken anywhere inside that second: the tight bound is that
        # mapping time T must not exceed any version we observed after
        # the NEXT second boundary.
        # Snapshot: the observation actor appends while the mapping reads
        # below suspend this check — iterating the live list would chase a
        # moving tail (appends during iteration don't raise, they extend
        # the walk).  The inner `later` comprehension re-reads on purpose.
        for t_obs, _v in list(self.observed):
            if t_obs < times[0]:
                continue
            later = [
                v for t, v in self.observed if t >= int(t_obs) + 1.0
            ]
            if not later:
                continue
            mapped = await version_from_timestamp(db, t_obs)
            assert mapped <= later[0], (
                f"map points past the future: time {t_obs} -> {mapped} "
                f"but we read {later[0]} after second {int(t_obs) + 1}"
            )
        return True
