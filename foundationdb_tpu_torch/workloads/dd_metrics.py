"""DDMetrics: data-distribution activity is observable through status.

Ref: fdbserver/workloads/DDMetrics.actor.cpp — drive enough skewed load
that data distribution must act, then read the DD metrics through the
status document (not by poking the role) and assert they moved.  The
observable surface is what operators and tools depend on; counters that
only live inside the role are invisible regressions waiting to happen.

The port's own copy of the reference package's ``workloads/dd_metrics.py``.
Where the reference sets its global ``dd_shard_max_bytes`` and
``dd_shard_min_bytes`` knobs, this sets them in every controller's
``dd_settings`` (each later generation's DD role) and on each recruited
DD role (``shard_max_bytes``, ``shard_min_bytes``), and restores them.
"""

from __future__ import annotations

import inspect

from .base import TestWorkload

# The sim-scaled thresholds the reference sets its knobs to.
_SETTINGS = {"shard_max_bytes": 4000, "shard_min_bytes": 0}


class DDMetricsWorkload(TestWorkload):
    name = "dd_metrics"

    def __init__(self, rows: int = 200, value_len: int = 48,
                 prefix: bytes = b"ddm/"):
        self.rows = rows
        self.value_len = value_len
        self.prefix = prefix
        self._old = None  # [(controller, its dd_settings before setup)]

    async def setup(self, db, cluster):
        # Sim-scaled threshold so the hot range below actually trips the
        # tracker's split cadence during the run.
        self._old = []
        for cc in getattr(cluster, "controllers", ()):
            self._old.append((cc, dict(cc.dd_settings)))
            cc.dd_settings.update(_SETTINGS)
            role = getattr(cc, "dd_role", None)
            if role is not None:
                for k, v in _SETTINGS.items():
                    setattr(role, k, v)

    def _restore_knobs(self):
        if self._old is None:
            return
        from ..server.dd_role import DataDistributionRole

        params = inspect.signature(DataDistributionRole).parameters
        for cc, old in self._old:
            cc.dd_settings.clear()
            cc.dd_settings.update(old)
            # Every recruited role, as every role reads the reference's
            # restored knobs.
            role = getattr(cc, "dd_role", None)
            if role is not None:
                for k in _SETTINGS:
                    setattr(role, k, old.get(k, params[k].default))
        self._old = None

    async def start(self, db, cluster):
        from ..server.status import cluster_status

        loop = cluster.loop
        self.final = {}
        try:
            for j in range(6):

                async def hot(tr, j=j):
                    for i in range(40):
                        tr.set(
                            self.prefix + b"%d%04d" % (j, i),
                            b"x" * self.value_len,
                        )

                await db.run(hot)
            # Wait for the tracker cadence to observe and split.
            end = loop.now() + 30.0
            while loop.now() < end:
                doc = cluster_status(cluster)
                dd = doc["cluster"].get("data_distribution")
                if dd and (dd["splits"] >= 1 or dd["moves"] >= 1):
                    self.final = dd
                    return
                await loop.delay(0.5)
        finally:
            # The settings must not leak past this workload even when
            # start() fails or times out (check() may never run).
            self._restore_knobs()

    async def check(self, db, cluster) -> bool:
        self._restore_knobs()
        assert self.final, (
            "data_distribution status never showed split/move activity"
        )
        for f in ("moves", "heals", "splits", "merges", "queued"):
            assert isinstance(self.final.get(f), int)
        return True
