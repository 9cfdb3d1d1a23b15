"""TestWorkload base + the compound runner.

The port's own copy of the reference package's ``workloads/base.py``.

Ref: workloads.h:55 — each workload implements setup (populate), start
(run until done), check (verify invariants); tester.actor.cpp:239 runs the
spec's workloads CONCURRENTLY (chaos injectors overlap the invariant
workloads), then checks each.
"""

from __future__ import annotations

from typing import List


class TestWorkload:
    """One workload; subclasses override any subset of the phases."""

    name = "workload"

    async def setup(self, db, cluster) -> None:  # populate initial data
        return None

    async def start(self, db, cluster) -> None:  # run the workload
        return None

    async def check(self, db, cluster) -> bool:  # verify invariants
        return True


def run_workloads(
    cluster,
    workloads: List[TestWorkload],
    timeout_vt: float = 10000.0,
    quiet: bool = False,
):
    """Drive the phases like runTest (tester.actor.cpp:778): setups
    sequentially, starts concurrently (chaos overlaps load), checks
    sequentially; every check must return True.

    quiet=True, waiting for quiescence between start and check (ref:
    waitForQuietDatabase before the trailing consistency check,
    tester.actor.cpp:819 / QuietDatabase.actor.cpp:371), raises
    NotImplementedError until the port has server/status.py."""
    from ..flow.eventloop import all_of

    if quiet:
        raise NotImplementedError(
            "run_workloads(quiet=True) waits for a quiet database through "
            "server/status.py, which the port has not yet"
        )
    db = cluster.database("tester")
    for wl in workloads:
        cluster.run_until(
            db.process.spawn(wl.setup(db, cluster), f"setup:{wl.name}"),
            timeout_vt=timeout_vt,
        )
    tasks = [
        db.process.spawn(wl.start(db, cluster), f"start:{wl.name}")
        for wl in workloads
    ]
    cluster.run_until(all_of(tasks), timeout_vt=timeout_vt)
    for wl in workloads:
        ok = cluster.run_until(
            db.process.spawn(wl.check(db, cluster), f"check:{wl.name}"),
            timeout_vt=timeout_vt,
        )
        assert ok, f"workload {wl.name} check failed"
    # Sim-end fault-site coverage (ref: the reference prints BUGGIFY
    # coverage per run): which chaos sites this seed actually exercised,
    # as registry gauges on the cluster + one trace event.
    from ..flow.buggify import publish_coverage
    from ..metrics import MetricsRegistry
    from ..flow.trace import TraceEvent

    reg = MetricsRegistry("BuggifyCoverage")
    cov = publish_coverage(reg)
    cluster.buggify_coverage = reg
    TraceEvent("BuggifyCoverage").detail(
        "sites_seen", cov["sites_seen"]
    ).detail("sites_activated", cov["sites_activated"]).detail(
        "sites_fired", cov["sites_fired"]
    ).log()
