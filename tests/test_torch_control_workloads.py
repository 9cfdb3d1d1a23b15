"""The port's control-plane workloads, held to the reference's on the CPU.

``workloads/chaos.py`` (RandomClogging, Attrition, ``revive_worker``,
DeviceChaos), ``targeted_kill.py``, ``rollback.py``, ``dd_metrics.py``,
``config.py`` (SimulationConfig), ``status_workload.py`` and
``time_keeper.py``, and the compositions of the earlier workloads with
chaos on the DynamicCluster.  Each twin runs one reference test function
for each package (tests/test_torch_dynamic_cluster.py's ``assert_twins``)
and holds the records equal: every read, commit and retry with its virtual
time, every worker request, every trace event, each cluster's
controllers, disks and status document, and each loop's end and next
draw.  Twinned, at one seed each where the reference sweeps several:
tests/test_new_workloads.py's targeted kills (3), time keeper, DD metrics
through status, DDBalance on its own DynamicCluster (the reference's
``dd_*`` knobs are the controllers' ``dd_settings`` on the port's side),
and the compositions with RandomClogging and Attrition of AtomicOps,
VersionStamp and Serializability, ConfigureDatabase, Storefront,
Inventory and QueuePush, Status and LowLatency, RYW, CommitBug and
IndexScan under RandomMoveKeys; test_rollback_movekeys.py's rollback;
test_workloads.py's randomized chaos sweep over SimulationConfig
topologies.  Every cluster runs each package's host engine, but the
rollback and the sweep also run over the port's set ("set").

DeviceChaos finds a device set by its ``_dev`` engine (the reference's by
``_jax``).  Its run on
a DynamicCluster over the port's set (a resolver killed under the
outage) is held to itself across two runs, with at least one injector
installed and faults injected.
"""

from __future__ import annotations

import importlib
import importlib.util
import pathlib

import pytest

from foundationdb_tpu.flow.knobs import g_knobs
from foundationdb_tpu_torch.conflict.api import ConflictSet

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_dc_twins_wl",
                                               _here / "test_torch_dynamic_cluster.py")
DC = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(DC)
_restore_globals = DC._restore_globals
assert_twins = DC.assert_twins

NW = "test_new_workloads"


@pytest.mark.parametrize("role", ["storage0", "tlog0", "proxy0"])
def test_targeted_kill_each_role(role):
    assert_twins(NW, "test_targeted_kill_each_role", (role,))


def test_time_keeper_correctness():
    assert_twins(NW, "test_time_keeper_correctness")


def test_dd_metrics_through_status():
    rec = assert_twins(NW, "test_dd_metrics_through_status")
    dd = rec["clusters"][0]["status"]["cluster"]["data_distribution"]
    assert dd["splits"] + dd["moves"] >= 1


@pytest.mark.parametrize("test,seed", [
    ("test_atomic_ops_versionstamp_serializability_chaos", 520),
    ("test_configure_database_under_chaos", 540),
    ("test_storefront_under_chaos", 575),
    ("test_inventory_queue_push_chaos", 545),
    ("test_status_lowlatency_under_chaos", 565),
    ("test_ryow_under_chaos", 570),
    ("test_commit_bug_under_chaos", 595),
    ("test_index_scan_through_shard_moves", 615),
])
def test_compositions_with_chaos(test, seed):
    assert_twins(NW, test, (seed,))


def _dd_balance(pkg):
    """test_dd_balance_converges on `pkg`'s own DynamicCluster(seed=598):
    the reference's dd_shard_max_bytes/dd_shard_min_bytes knobs at 2,500
    and 0, the port's controllers' dd_settings."""
    base = DC.BASES[pkg]
    imp = importlib.import_module
    wl = imp(f"{base}.workloads")
    Cluster = imp(f"{base}.server.dynamic_cluster").DynamicCluster
    settings = dict(shard_max_bytes=2500, shard_min_bytes=0)
    if pkg == "ref":
        old = (g_knobs.server.dd_shard_max_bytes, g_knobs.server.dd_shard_min_bytes)
        g_knobs.server.dd_shard_max_bytes, g_knobs.server.dd_shard_min_bytes = 2500, 0
        try:
            c = Cluster(seed=598, n_workers=8, n_proxies=2, n_storages=3)
            wl.run_workloads(c, [wl.DDBalanceWorkload()], timeout_vt=90000.0)
        finally:
            g_knobs.server.dd_shard_max_bytes, g_knobs.server.dd_shard_min_bytes = old
    else:
        c = Cluster(seed=598, n_workers=8, n_proxies=2, n_storages=3,
                    controller_settings=dict(dd_settings=settings))
        wl.run_workloads(c, [wl.DDBalanceWorkload()], timeout_vt=90000.0)


def test_dd_balance_converges():
    recs = {}
    for pkg in ("ref", "port"):
        with DC.twin_run(pkg, "cpu") as rec:
            _dd_balance(pkg)
        recs[pkg] = rec
    for key in recs["ref"]:
        assert recs["port"][key] == recs["ref"][key], DC.first_difference(
            recs["port"][key], recs["ref"][key], key)
    dd = recs["port"]["clusters"][0]["status"]["cluster"]["data_distribution"]
    assert dd["splits"] >= 1


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_rollback_partition_recovers(arm):
    assert_twins("test_rollback_movekeys", "test_rollback_partition_recovers", (8101,), arm=arm)


@pytest.mark.parametrize("seed,arm", [(1000, "cpu"), (1001, "set")])
def test_randomized_chaos_sweep(seed, arm):
    assert_twins("test_workloads", "test_randomized_chaos_sweep", (seed,), arm=arm)


def test_dd_metrics_restores_the_settings():
    """DDMetrics sets every controller's DD settings (and the recruited
    role's) to the reference's sim-scaled thresholds for its run and
    restores them, as the reference restores its knobs."""
    m = DC.mods("port")
    wl = importlib.import_module("foundationdb_tpu_torch.workloads")
    with DC.twin_run("port", "cpu"):
        c = m.dc.DynamicCluster(seed=585, n_workers=7, n_proxies=2, n_storages=2,
                                controller_settings=dict(dd_settings={"shard_min_bytes": 7}))
        load = wl.DDMetricsWorkload()
        wl.run_workloads(c, [load], timeout_vt=60000.0)
        for cc in c.controllers:
            assert cc.dd_settings == {"shard_min_bytes": 7}
        role = c.acting_controller().dd_role
        assert (role.shard_max_bytes, role.shard_min_bytes) == (1 << 20, 7)


def _device_chaos(seed):
    """Cycle beside DeviceChaos on the port's DynamicCluster over the port's
    set (depth 2), the resolver's process killed in the middle of the
    outage and revived: the record."""
    m = DC.mods("port")
    wl = importlib.import_module("foundationdb_tpu_torch.workloads")
    chaos = wl.DeviceChaosWorkload(duration=3.0, fire_probability=0.5)

    class KillResolver(wl.TestWorkload):
        name = "kill_resolver"

        async def start(self, db, cluster):
            await cluster.loop.delay(1.5)  # inside the outage's third
            proc = cluster.kill_role_process("resolver")
            cluster.fs.crash_machine(proc.machine.machine_id)
            importlib.import_module("foundationdb_tpu_torch.workloads.chaos").revive_worker(
                cluster, proc)

    with DC.twin_run("port", "set", depth=2) as rec:
        c = m.dc.DynamicCluster(seed=seed, n_workers=6, buggify=False)
        ring = wl.CycleWorkload(nodes=6, ops=12, actors=2)
        wl.run_workloads(c, [ring, chaos, KillResolver()], timeout_vt=20000.0, quiet=True)
        rec["chaos"] = [(inj.injected, cs._breaker.transitions) for cs, inj in chaos.installed]
    return rec


def test_device_chaos_under_a_resolver_kill():
    a = _device_chaos(424242)
    b = _device_chaos(424242)
    for key in a:
        assert a[key] == b[key], DC.first_difference(a[key], b[key], key)
    assert len(a["chaos"]) >= 1, "no device set found to inject into"
    assert any(injected for injected, _walk in a["chaos"])
    gens = {g for _t, _addr, kind, g, _b in a["recruits"] if kind == "InitResolver"}
    assert len(gens) >= 2, a["recruits"]


def test_device_chaos_finds_the_device_sets():
    """The port's DeviceChaos finds a set with a device engine by `_dev`
    (the reference's looks for `_jax`, which the port's set keeps as an
    alias, so both find it), and no host-only set."""
    ref_chaos = importlib.import_module("foundationdb_tpu.workloads.chaos")
    port_chaos = importlib.import_module("foundationdb_tpu_torch.workloads.chaos")

    class R:
        conflicts = DC.port_set()

    class H:
        conflicts = ConflictSet(backend="cpu")

    cluster = type("C", (), {"resolvers": [R(), H()]})()
    assert port_chaos.DeviceChaosWorkload()._conflict_sets(cluster) == [R.conflicts]
    assert ref_chaos.DeviceChaosWorkload()._conflict_sets(cluster) == [R.conflicts]
