"""The port's client-only correctness workloads, held to the reference's.

Each workload of ``foundationdb_tpu_torch/workloads/`` (Cycle,
AtomicLedger, WriteSkew, AtomicOps, Serializability, VersionStamp,
LockDatabase, Increment, ConflictRange, RyowCorrectness) runs through the
port's ``run_workloads`` on the port's SimCluster and through the
reference's on the reference's, at one seed: every check passes, and the
records are equal: every read, commit and retry (chip_smoke's ClientLog),
each client's state, each workload's own record (its attributes after
the run), the buggify coverage the runner publishes, the roles'
registries and the loop's end time and rng.  The arms are
tests/test_torch_client.py's: each package's host engine ("cpu"), or
every resolver over a port ConflictSet(device="cpu") at key_words=4
("set").  Then chip_smoke's phase 6n script (a ResolverBalancer beside
Cycle, AtomicLedger, WriteSkew and LockDatabase) through both packages
at pipeline depths 1 and 2.
"""

from __future__ import annotations

import importlib
import importlib.util
import pathlib

import pytest

import foundationdb_tpu.flow.eventloop as ref_el
from foundationdb_tpu_torch.flow import eventloop as port_el

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_client_twins", _here / "test_torch_client.py")
TWINS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TWINS)
SMOKE = TWINS.SMOKE
_restore_globals = TWINS._restore_globals


def run(pkg, arm, make, seed, timeout_vt=None, prefixes=(), depth=None, conflict_set=None,
        **cluster_kw):
    """run_workloads(make(wl)) through `pkg`'s cluster in `arm`; returns
    the record.  `depth` gives the "set" arm's sets that pipeline depth;
    `conflict_set` (a factory) puts resolver 0 over that set beside the
    host engine; after the run a fresh client reads each of `prefixes`
    in one transaction (the final state)."""
    m = TWINS.mods(pkg)
    TWINS._install_hubs(pkg)
    kw = dict(cluster_kw)
    if conflict_set is not None:
        if pkg == "port":
            kw["device"] = "cpu"
        c = m.cluster.SimCluster(seed=seed, conflict_backend="cpu", conflict_set=conflict_set(),
                                 **kw)
    else:
        c = TWINS.cluster(m, arm, seed, depth=depth, **kw)
    dbs = SMOKE.tracked_databases(c)
    log = SMOKE.ClientLog(m.tx)
    loads = make(m.wl)
    try:
        m.wl.run_workloads(c, loads, **({} if timeout_vt is None else {"timeout_vt": timeout_vt}))
        state = [SMOKE.final_state(c, prefix) for prefix in prefixes]
    finally:
        log.remove()
        m.el.set_event_loop(None)
    return dict(
        events=log.events,
        clients=SMOKE.client_state(dbs),
        workloads=[(w.name, SMOKE.norm(dict(vars(w)))) for w in loads],
        state=state,
        coverage=c.buggify_coverage.snapshot_json(),
        proxies=[p.metrics.snapshot_json() for p in c.proxies],
        resolvers=[r.metrics.snapshot_json() for r in c.resolvers],
        end=(c.loop.now(), c.loop.rng.random_int(0, 1 << 30)),
    ), loads, c


def pair(arm, make, seed, **kw):
    """The reference's record and the port's, asserted equal; returns the
    port's record, its workloads and its cluster."""
    ref = run("ref", arm, make, seed, **kw)[0]
    port, loads, c = run("port", arm, make, seed, **kw)
    assert port["events"] == ref["events"]
    for key in ref:
        assert port[key] == ref[key], key
    return port, loads, c


CASES = [
    # (id, workloads, seed, arms, cluster kwargs)
    ("cycle", lambda wl: [wl.CycleWorkload(nodes=8, ops=20, actors=3)], 201, ("cpu", "set"),
     dict(n_proxies=2)),
    ("atomic_ledger", lambda wl: [wl.AtomicLedgerWorkload(actors=3, ops=10)], 202,
     ("cpu", "set"), {}),
    ("write_skew", lambda wl: [wl.WriteSkewWorkload(rounds=8)], 203, ("cpu",), {}),
    ("atomic_ops", lambda wl: [wl.AtomicOpsWorkload()], 204, ("cpu",), dict(n_proxies=2)),
    ("serializability", lambda wl: [wl.SerializabilityWorkload()], 205, ("cpu", "set"),
     dict(n_proxies=2, n_resolvers=2)),
    ("versionstamp", lambda wl: [wl.VersionStampWorkload()], 206, ("cpu",), {}),
    ("lock_database", lambda wl: [wl.LockDatabaseWorkload(),
                                  wl.CycleWorkload(nodes=6, ops=10, actors=2)], 207,
     ("cpu",), dict(n_proxies=2)),
    ("increment", lambda wl: [wl.IncrementWorkload()], 208, ("cpu",), {}),
    ("conflict_range", lambda wl: [wl.ConflictRangeWorkload()], 209, ("cpu", "set"), {}),
    ("ryow", lambda wl: [wl.RyowCorrectnessWorkload()], 210, ("cpu",), {}),
    ("all_at_once", lambda wl: [wl.CycleWorkload(nodes=8, ops=8, actors=2),
                                wl.AtomicLedgerWorkload(ops=6), wl.WriteSkewWorkload(rounds=3),
                                wl.IncrementWorkload(ops=4), wl.VersionStampWorkload(ops=3)],
     211, ("cpu",), dict(n_proxies=2, n_resolvers=2)),
]


@pytest.mark.parametrize(
    "make,seed,arm,kw",
    [pytest.param(make, seed, arm, kw, id=f"{name}-{arm}")
     for name, make, seed, arms, kw in CASES for arm in arms])
def test_workloads_match_the_reference(make, seed, arm, kw):
    port = pair(arm, make, seed, **kw)[0]
    assert port["events"] and any(e[0] == "commit" for e in port["events"])


def test_workload_checks_see_what_they_claim():
    """Each workload's own record after its run: the ring one cycle, the
    conflict-range probes saw both outcomes, RYW read something, the lock
    was seen while held."""
    port = pair("cpu", lambda wl: [wl.ConflictRangeWorkload(), wl.RyowCorrectnessWorkload()],
                212)[0]
    cr, ryow = (dict(w[1]) for w in port["workloads"])
    assert 0 < cr["conflicts"] < cr["checked"] and ryow["reads_checked"] > 0
    port = pair("cpu", lambda wl: [wl.LockDatabaseWorkload()], 213, n_proxies=2)[0]
    assert dict(port["workloads"][0][1])["checked_while_locked"]


def test_quiet_database_waits_for_status():
    m = TWINS.mods("port")
    c = TWINS.cluster(m, "cpu", 1)
    try:
        with pytest.raises(NotImplementedError, match="status"):
            m.wl.run_workloads(c, [m.wl.CycleWorkload()], quiet=True)
    finally:
        port_el.set_event_loop(None)


def test_port_exports_only_the_client_workloads():
    port = TWINS.mods("port").wl
    assert sorted(port.__all__) == sorted([
        "TestWorkload", "run_workloads", "CycleWorkload", "AtomicLedgerWorkload",
        "WriteSkewWorkload", "AtomicOpsWorkload", "SerializabilityWorkload",
        "VersionStampWorkload", "LockDatabaseWorkload", "IncrementWorkload",
        "ConflictRangeWorkload", "RyowCorrectnessWorkload", "WriteDuringReadWorkload",
        "RandomReadWriteWorkload", "FuzzApiWorkload", "SelectorCorrectnessWorkload",
        "ConsistencyChecker", "check_consistency", "BulkLoadWorkload", "IndexScanWorkload",
        "InventoryWorkload", "QueuePushWorkload", "StorefrontWorkload", "LowLatencyWorkload",
        "UnreadableWorkload", "SidebandWorkload", "WatchesWorkload", "WatchAndWaitWorkload",
        "FastTriggeredWatchesWorkload", "BackgroundSelectorsWorkload", "CommitBugWorkload",
        "ConfigureDatabaseWorkload", "SlowTaskWorkload", "RandomMoveKeysWorkload",
        "DDBalanceWorkload", "RemoveServersSafelyWorkload"])
    ref = TWINS.mods("ref").wl
    assert set(port.__all__) < set(ref.__all__)


@pytest.mark.parametrize("depth", [1, 2])
def test_client_script_matches_the_reference(depth):
    """chip_smoke's phase 6n script through the reference's SimCluster and
    the port's, every resolver over a port ConflictSet(device="cpu") of
    phase 6n's shape at `depth`.  On the port's side the device engine
    serves every resolve batch, the balancer's 20-byte key going through
    the long-key side table."""
    recs, sets = {}, {"ref": [], "port": []}
    for pkg in ("ref", "port"):
        m = TWINS.mods(pkg)
        TWINS._install_hubs(pkg)

        def make_set(mine=sets[pkg]):
            mine.append(TWINS._set(depth))
            return mine[-1]

        with SMOKE.resolver_sets(m.cluster, make_set):
            c = m.cluster.SimCluster(seed=43, n_proxies=2, n_resolvers=2, buggify=True,
                                     **({"device": "cpu"} if pkg == "port" else {}))
        try:
            recs[pkg] = SMOKE.client_record(c, m.wl, m.tx)
        finally:
            ref_el.set_event_loop(None)
            port_el.set_event_loop(None)
    assert recs["port"]["events"] == recs["ref"]["events"]
    for key in recs["ref"]:
        assert recs["port"][key] == recs["ref"][key], key
    assert SMOKE.ring_ok(recs["port"]["ring"]) and recs["port"]["balancer"][1] >= 1
    batches = sum(r.metrics.counter("batches").value for r in c.resolvers)
    served = sum(s.device_metrics()["counters"]["batches"] for s in sets["port"])
    longs = [SMOKE.long_key_counts(s) for s in sets["port"]]
    assert served == batches > 0
    assert sum(lk["side"] for lk in longs) > 0 and not any(lk["host"] for lk in longs)
