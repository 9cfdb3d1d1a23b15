"""StatusWorkload: the status document keeps its schema under load.

Ref: fdbserver/workloads/StatusWorkload.actor.cpp — poll status
continuously during the run and validate every document against the
schema; a field that vanishes or changes type during a recovery or
chaos window is exactly the regression a one-shot test misses.

The port's own copy of the reference package's ``workloads/status_workload.py``.
"""

from __future__ import annotations

from .base import TestWorkload

# section -> required field -> type(s)
_SCHEMA = {
    "client": {
        "database_status": dict,
        "coordinators": dict,
    },
    "cluster": {},
}


class StatusWorkload(TestWorkload):
    name = "status"

    def __init__(self, duration: float = 8.0, interval: float = 0.5):
        self.duration = duration
        self.interval = interval
        self.polls = 0

    def _validate(self, doc: dict):
        for section, fields in _SCHEMA.items():
            assert section in doc and isinstance(doc[section], dict), (
                f"status missing section {section}: {sorted(doc)}"
            )
            for f, ty in fields.items():
                assert f in doc[section] and isinstance(
                    doc[section][f], ty
                ), f"status {section}.{f} missing or wrong type"
        av = doc["client"]["database_status"].get("available")
        assert isinstance(av, bool)
        cl = doc["cluster"]
        if "recovery_state" in cl:
            assert isinstance(cl["recovery_state"].get("name"), str)
            assert isinstance(cl["recovery_state"].get("generation"), int)
        if "qos" in cl:
            assert isinstance(cl["qos"], dict)
        if "processes" in cl:
            assert isinstance(cl["processes"], dict)
        if "resolver" in cl:
            r = cl["resolver"]
            assert isinstance(r.get("count"), int) and r["count"] >= 1
            assert isinstance(r.get("total_resolved"), int)
            assert isinstance(r.get("backends"), list)
            assert isinstance(r.get("resolvers"), dict)
            for snap in r["resolvers"].values():
                assert isinstance(snap.get("counters"), dict)

    async def start(self, db, cluster):
        from ..server.status import cluster_status

        loop = cluster.loop
        end = loop.now() + self.duration
        while loop.now() < end:
            doc = cluster_status(cluster)
            self._validate(doc)
            self.polls += 1
            await loop.delay(self.interval)

    async def check(self, db, cluster) -> bool:
        return self.polls >= 3
