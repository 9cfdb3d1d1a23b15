"""The port's status document and quiet-database wait, held to the
reference's on the CPU.

The port's ``server/status.py`` (``cluster_status``, ``role_objects``,
the resolver section with its ``"tpu"`` block of the sets'
``device_metrics()``, ``latency_probe``, ``quiet_database``) and
``run_workloads(quiet=True)`` run the same scripts as the reference's,
through each package's own cluster.  Twins of the status half of
tests/test_cli_status.py (its status-document shapes on a SimCluster and
a DynamicCluster, the qos, data and logs sections under a ratekeeper, and
the quiet wait; the CLI's own rendering waits for the port's CLI to gain
the cluster commands), and of test_ratekeeper.py's
``test_resolver_signals_feed_ratekeeper``'s status ``qos`` block.  The
status documents are compared whole (a process's ``live_actors`` is
recounted on the reference's side as tests/test_torch_dynamic_cluster.py
says), with tests/test_torch_dynamic_cluster.py's records: every read,
commit and retry, every worker request, every trace event, each cluster's
controllers and disks, and each loop's end and next draw.
"""

from __future__ import annotations

import importlib
import importlib.util
import pathlib

import pytest

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_dc_twins_status",
                                               _here / "test_torch_dynamic_cluster.py")
DC = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(DC)
_restore_globals = DC._restore_globals
assert_twins = DC.assert_twins
_rk_spec = importlib.util.spec_from_file_location("_rk_twins_status",
                                                  _here / "test_torch_ratekeeper.py")
RK = importlib.util.module_from_spec(_rk_spec)
_rk_spec.loader.exec_module(RK)


@pytest.mark.parametrize("test,arm", [
    ("test_status_json_shapes", "cpu"),
    ("test_status_json_shapes", "set"),
    ("test_status_dynamic_cluster", "cpu"),
    ("test_status_dynamic_cluster", "set"),
    ("test_quiet_database_waits_for_drain", "cpu"),
])
def test_cli_status(test, arm):
    rec = assert_twins("test_cli_status", test, arm=arm)
    doc = rec["clusters"][0]["status"]
    if arm == "set":
        tpu = doc["cluster"]["resolver"]["tpu"]
        assert tpu and all(v["name"] for v in tpu.values())
        assert doc["cluster"]["resolver"]["backends"] == ["torch"]


def _qos_script(pkg):
    """test_status_qos_and_logs_sections's status half on `pkg`'s
    SimCluster(seed=71) with a Ratekeeper on its proxy."""
    base = DC.BASES[pkg]
    imp = importlib.import_module
    c = imp(f"{base}.server.cluster").SimCluster(seed=71)
    rk = imp(f"{base}.server.ratekeeper").Ratekeeper(c.master_proc, [c.tlog], [c.storage])
    c.proxy.ratekeeper = rk.interface()
    db = c.database()

    async def drive():
        for i in range(5):
            tr = db.create_transaction()
            tr.set(b"s%d" % i, b"v")
            await tr.commit()
        await c.loop.delay(0.3)  # rk sample + proxy rate fetch

    c.run_all([(db, drive())], timeout_vt=100.0)
    cl = DC.status_doc(DC.mods(pkg), c)["cluster"]
    assert "storage_queue_bytes" in cl["data"]
    assert cl["data"]["partitions_count"] >= 1
    assert cl["logs"]["queue_bytes"] >= 0
    assert cl["qos"]["ratekeeper_enabled"]
    assert cl["qos"]["transactions_per_second_limit"] > 0
    assert "performance_limited_by" in cl["qos"]
    probe = c.run_until(db.process.spawn(
        imp(f"{base}.server.status").latency_probe(db), "probe"), timeout_vt=100.0)
    return cl, probe


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_status_qos_and_logs_sections(arm):
    recs = {}
    for pkg in ("ref", "port"):
        with DC.twin_run(pkg, arm) as rec:
            rec["out"] = _qos_script(pkg)
        recs[pkg] = rec
    for key in recs["ref"]:
        assert recs["port"][key] == recs["ref"][key], DC.first_difference(
            recs["port"][key], recs["ref"][key], key)
    _cl, probe = recs["port"]["out"]
    assert set(probe) == {"transaction_start_seconds", "read_seconds", "commit_seconds"}


def s_resolver_signals_qos(c, rk, m, k):
    """test_resolver_signals_feed_ratekeeper's script with its status qos
    block."""
    out = RK.s_resolver_signals(c, rk, m, k)
    doc = importlib.import_module(f"{DC.BASES[m.pkg]}.server.status").cluster_status(c)
    qos = doc["cluster"]["qos"]
    for key in ("worst_resolver_queue_depth", "resolve_latency_p99_seconds",
                "commit_latency_p99_seconds", "conflict_backend_state",
                "worst_grv_queue_depth"):
        assert key in qos, sorted(qos)
    assert qos["conflict_backend_state"] == "ok"
    assert qos["conflict_mirror_divergence"] == 0
    out["qos"] = qos
    return out


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_resolver_signals_feed_ratekeeper_qos(arm):
    port = RK.pair(73, s_resolver_signals_qos, dict(max_tps=100000.0), arm=arm)
    assert port["out"]["qos"]["ratekeeper_enabled"]


def _quiet_dynamic(pkg):
    """Cycle through run_workloads(quiet=True) on `pkg`'s DynamicCluster,
    and the status document once quiet."""
    base = DC.BASES[pkg]
    imp = importlib.import_module
    wl = imp(f"{base}.workloads")
    c = imp(f"{base}.server.dynamic_cluster").DynamicCluster(seed=75, n_workers=6,
                                                             n_storages=2, buggify=False)
    loads = [wl.CycleWorkload(nodes=8, ops=10, actors=2)]
    wl.run_workloads(c, loads, timeout_vt=3000.0, quiet=True)
    return c.loop.now()


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_quiet_database_on_a_dynamic_cluster(arm):
    recs = {}
    for pkg in ("ref", "port"):
        with DC.twin_run(pkg, arm) as rec:
            rec["end"] = _quiet_dynamic(pkg)
        recs[pkg] = rec
    for key in recs["ref"]:
        assert recs["port"][key] == recs["ref"][key], DC.first_difference(
            recs["port"][key], recs["ref"][key], key)
    cl = recs["port"]["clusters"][0]["status"]["cluster"]
    assert cl["recovery_state"]["name"] == "fully_recovered"
    assert cl["data"]["moving_shards"] == 0
