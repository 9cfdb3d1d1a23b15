"""The port's workloads beyond the acceptance matrix, held to the
reference's.

Twins of the plain cases of tests/test_new_workloads.py whose workloads
are all ported (Storefront, Unreadable and LockDatabase beside Cycle;
Inventory and QueuePush; RyowCorrectness, WatchAndWait and BulkLoad;
CommitBug, FastTriggeredWatches and BackgroundSelectors), its
ConfigureDatabase case without the chaos (on a SimCluster: the
DynamicCluster and RandomClogging are the control plane's), its IndexScan
case without the shard moves and the quiet wait (the consistency check
still runs), its SlowTask case without MetricLogging; and of
tests/test_workloads.py's Sideband, Watches and SelectorCorrectness
cases and its consistency checker, whose replicated team the client's
own system-key transactions make here (the reference's test asks the
control plane).  LowLatency, which no plain reference case runs, runs
beside Cycle.  Each case runs at the reference test's seed and shape
through the port's ``run_workloads`` on the port's SimCluster and through
the reference's on the reference's; the records are
tests/test_torch_workloads.py's (every read, commit and retry, each
client's state, each workload's attributes after the run, the buggify
coverage, the roles' registries, the loop's end), in the host-engine arm
("cpu") and, for some, over a port ConflictSet(device="cpu") at
key_words=4 ("set").  SlowTask's record holds wall time, so there the
check's outcome and the SlowTask events are compared.
"""

from __future__ import annotations

import importlib
import importlib.util
import pathlib

import pytest

import foundationdb_tpu.flow.trace as ref_trace
from foundationdb_tpu_torch.flow import trace as port_trace

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_workload_twins", _here / "test_torch_workloads.py")
WL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(WL)
TWINS = WL.TWINS
_restore_globals = WL._restore_globals


def storefront_unreadable_lock(wl):
    return [wl.StorefrontWorkload(items=4, actors=3, purchases=8), wl.UnreadableWorkload(rounds=6),
            wl.CycleWorkload(nodes=5, ops=12, actors=2), wl.LockDatabaseWorkload(at=0.6, hold=0.8)]


CASES = [
    # (id, workloads, seed, arms, run kwargs, what the reference test
    # asserts of the workloads after the run)
    ("storefront_unreadable_lock", storefront_unreadable_lock, 570, ("cpu", "set"),
     dict(timeout_vt=30000.0, n_proxies=2, n_storages=2),
     lambda w: w[3].checked_while_locked and w[1].checked == 18),
    ("inventory_queue_push",
     lambda wl: [wl.InventoryWorkload(products=6, actors=3, moves=10),
                 wl.QueuePushWorkload(actors=4, pushes=6)], 541, ("cpu", "set"),
     dict(timeout_vt=30000.0, n_proxies=2, n_storages=2), lambda w: w[1].acked > 0),
    ("ryow_watchandwait_bulkload",
     lambda wl: [wl.RyowCorrectnessWorkload(txns=8, ops_per_txn=20),
                 wl.WatchAndWaitWorkload(watches=12), wl.BulkLoadWorkload(rows=200, batch=40)],
     560, ("cpu",), dict(timeout_vt=60000.0, n_proxies=2, n_storages=2),
     lambda w: w[1].fired == set(range(0, 12, 2))),
    ("commitbug_fastwatches_backgroundselectors",
     lambda wl: [wl.CommitBugWorkload(iterations=20), wl.FastTriggeredWatchesWorkload(rounds=6),
                 wl.BackgroundSelectorsWorkload(probes=15)], 590, ("cpu", "set"),
     dict(timeout_vt=60000.0, n_proxies=2, n_storages=2), lambda w: w[2].checked >= 7),
    ("configure_database",
     lambda wl: [wl.ConfigureDatabaseWorkload(changes=3, delay_between=0.6),
                 wl.CycleWorkload(nodes=5, ops=12, actors=2)], 540, ("cpu",),
     dict(timeout_vt=30000.0), lambda w: bool(w[0].final)),
    ("index_scan_615",
     lambda wl: [wl.IndexScanWorkload(rows=100, scans=8), wl.ConsistencyChecker()], 615, ("cpu",),
     dict(timeout_vt=90000.0, n_proxies=2, n_storages=3), lambda w: w[0].completed >= 4),
    ("index_scan_616",
     lambda wl: [wl.IndexScanWorkload(rows=100, scans=8), wl.ConsistencyChecker()], 616, ("cpu",),
     dict(timeout_vt=90000.0, n_proxies=2, n_storages=3), lambda w: w[0].completed >= 4),
    ("sideband_9501", lambda wl: [wl.SidebandWorkload(messages=15)], 9501, ("cpu", "set"),
     dict(timeout_vt=20000.0, n_proxies=2), lambda w: (w[0].checked, w[0].violations) == (15, 0)),
    ("sideband_9502", lambda wl: [wl.SidebandWorkload(messages=15)], 9502, ("cpu",),
     dict(timeout_vt=20000.0, n_proxies=2), lambda w: (w[0].checked, w[0].violations) == (15, 0)),
    ("watches_chain", lambda wl: [wl.WatchesWorkload(chain=3, rounds=4)], 9510, ("cpu",),
     dict(timeout_vt=30000.0), lambda w: w[0].fired > 0 and w[0].spurious == 0),
    ("selector_correctness", lambda wl: [wl.SelectorCorrectnessWorkload(nodes=8, max_offset=4)],
     9520, ("cpu", "set"), dict(timeout_vt=30000.0),
     lambda w: w[0].checked >= 8 * 2 * 9 and not w[0].failures),
    ("low_latency",
     lambda wl: [wl.LowLatencyWorkload(ops=20), wl.CycleWorkload(nodes=5, ops=8, actors=2)], 600,
     ("cpu",), dict(timeout_vt=30000.0, n_proxies=2), lambda w: len(w[0].latencies) == 20),
]


@pytest.mark.parametrize(
    "make,seed,arm,kw,holds",
    [pytest.param(make, seed, arm, kw, holds, id=f"{name}-{arm}")
     for name, make, seed, arms, kw, holds in CASES for arm in arms])
def test_workloads_match_the_reference(make, seed, arm, kw, holds):
    """Every check passes on both packages, the records are equal, and
    the port's workloads hold what the reference test asserts of them."""
    port, loads, _c = WL.pair(arm, make, seed, **kw)
    assert any(e[0] == "commit" for e in port["events"])
    assert holds(loads)


def slow_task_run(pkg):
    """SlowTaskWorkload through `pkg`'s SimCluster: the SlowTask events
    the slow-task profiler logged (the workload's check asserts there
    are some, with their wall cost)."""
    m = TWINS.mods(pkg)
    TWINS._install_hubs(pkg)
    col = (ref_trace if pkg == "ref" else port_trace).global_collector()
    c = TWINS.cluster(m, "cpu", 580, n_proxies=2, n_storages=2)
    try:
        m.wl.run_workloads(c, [m.wl.SlowTaskWorkload()], timeout_vt=60000.0)
    finally:
        m.el.set_event_loop(None)
    return col.counts.get("SlowTask", 0)


def test_slow_task_profiler_catches_a_deliberate_hog():
    """Its check passes on both packages (it asserts new SlowTask events
    carrying at least a quarter of the burned wall time)."""
    assert slow_task_run("ref") > 0
    assert slow_task_run("port") > 0


def s_consistency_divergence(c, m):
    """tests/test_workloads.py's consistency-checker case without the
    control plane: the client's own system-key transactions put ten
    rows on a team of ss0 and ss1 (serverList rows, then a keyServers
    move whose destination fetches them); the healthy replicas agree;
    then one row is changed inside ss0's window behind the log's back,
    and the check reports the divergence."""
    sk = importlib.import_module(f"{TWINS.BASES[m.pkg]}.server.system_keys")
    end = importlib.import_module(f"{TWINS.BASES[m.pkg]}.server.storage").KEYSPACE_END
    cons = importlib.import_module(f"{TWINS.BASES[m.pkg]}.workloads.consistency")
    db = c.database()
    ss = [s.interface() for s in c.storages]
    out = {}

    def system(*rows):
        async def txn(tr):
            tr.options["access_system_keys"] = True
            for k, v in rows:
                tr.set(k, v)
        return txn

    async def flow():
        await db.run(system(*[(b"d%02d" % i, b"v%d" % i) for i in range(10)]))
        await db.run(system(*[(sk.server_list_key(f"ss{i}"), sk.encode_server_entry(s))
                              for i, s in enumerate(ss)]))
        await db.run(system((sk.key_servers_key(b""),
                             sk.encode_key_servers(["ss0"], ["ss0", "ss1"], end))))
        for _ in range(200):
            st = await ss[1].get_shard_state.get_reply(
                db.process, m.itf.GetShardStateRequest(begin=b"", end=end))
            if st in ("fetched", "readable"):
                break
            await c.loop.delay(0.05)
        await db.run(system((sk.key_servers_key(b""),
                             sk.encode_key_servers(["ss0", "ss1"], [], end))))
        db.invalidate_location(b"", end)
        out["healthy"] = await cons.check_consistency(db)
        s0 = c.storages[0]
        s0.store.set(b"d05", b"EVIL", s0.version.get(), 1)
        try:
            await cons.check_consistency(db)
            out["sabotaged"] = "no divergence"
        except AssertionError as e:
            out["sabotaged"] = str(e).split(";")[0]

    c.run_until(db.process.spawn(flow()), timeout_vt=1000.0)
    return out


def test_consistency_checker_detects_divergence():
    out = TWINS.pair("cpu", s_consistency_divergence, 91, n_storages=2)
    assert out["healthy"] >= 1
    assert out["sabotaged"].startswith("replica divergence"), out
