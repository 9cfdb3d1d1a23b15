"""chip_smoke.py's phase 4x on the CPU: the control plane's recovery
script (``recovery_script``) at the reference rig's shape.

The port's DynamicCluster (3 coordinators, 2 controllers, 2 proxies, 2
tlogs, 3 storages, 10 workers) recruits every resolver over a port
``ConflictSet(device="cpu")`` (key_words=3, h_cap=1,024, the kernels'
plain twins); a 64-node Cycle ring is loaded through
``Database(info_var=)``, then rounds of ring ops run while the resolver's
process is killed, then the acting controller's, then a tlog's.  The
script's own checks hold (each generation rises, a transaction reading
before a recovery fails with a retryable error, the ring one cycle and
equal to the acknowledged writes, every acknowledged write served by each
storage of its team), and so do chip_smoke's ``recovery_checks`` (every
batch of every generation replayed equal on a host CpuConflictSet from
that set's start, each set built at its generation's begin version and
its first batch served by its device engine, no degraded batch) at
depths 1-3.  The same script through the reference's DynamicCluster
(tests/test_torch_dynamic_cluster.py's ``twin_run``, its resolvers over
the port's set) gives the same record.  Without the port's F9 fix the
reference's run of the script at seed 56, its ring ops back to back and
one tlog killed, breaks the ring: a storage applied an orphan version that
the epoch-end cut truncated (PERF.md §7); the port's holds.
"""

from __future__ import annotations

import importlib
import importlib.util
import pathlib

import pytest

from foundationdb_tpu_torch.conflict import engine_cpu as ecpu

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_dc_twins_recovery",
                                               _here / "test_torch_dynamic_cluster.py")
DC = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(DC)
_restore_globals = DC._restore_globals
SMOKE = DC.SMOKE
TK = importlib.import_module("foundationdb_tpu_torch.conflict.kernels")


# A run in which the reference's F9 fault shows: rounds of ring ops back
# to back on each package's host engine, one tlog killed, at seed 56.
F9_SHAPE = dict(SMOKE.RECOVER_VS_CPU_SHAPE, actors=8, ops=8, pause=0.0, gap=40)
F9_SEED = 56


def _run(pkg, depth, f9=True, shape=SMOKE.RECOVER_VS_CPU_SHAPE, arm="set",
         seed=SMOKE.RECOVER_SEED, events=SMOKE.RECOVER_EVENTS, dc_kw=None, made=None):
    """recovery_script at `shape` with `events` through `pkg`'s
    DynamicCluster at `seed` (with `dc_kw`) in twin_run's `arm` (every
    resolver over the port's set at `depth`, or the host engine): (the
    record, the RecoveryLog), inside twin_run's record; the script's host
    seconds (wall time) left out.  The cluster is appended to `made`."""
    m = DC.mods(pkg)
    wl = importlib.import_module(f"{m.base}.workloads")
    rlog = SMOKE.RecoveryLog(m.worker, TK)
    try:
        with DC.twin_run(pkg, arm, depth=depth, f9=f9, dc_kw=dc_kw) as rec:
            c = m.dc.DynamicCluster(seed=seed, **SMOKE.RECOVER_CLUSTER)
            if made is not None:
                made.append(c)
            c.net.deep_copy = False
            rec["script"] = SMOKE.recovery_script(c, wl, m.tx, shape, rlog, events=events)
    finally:
        rlog.remove()
    for e in rec["script"]["events"]:
        e.pop("recover_host_s")
    return rec, rlog


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_recovery_script_on_the_cpu(depth):
    rec, rlog = _run("port", depth)
    out = rec["script"]
    assert [e["what"] for e in out["events"]] == list(SMOKE.RECOVER_EVENTS)
    for e in out["events"]:
        assert e["generation_after"] > e["generation_before"]
        assert e["stale"] in SMOKE.RECOVER_STALE_ERRORS
        assert e["first_commit"] >= e["begin"]
    SMOKE.recovery_checks(
        "recovery", rlog, out, TK,
        lambda g: ecpu.CpuConflictSet(g["begin"], key_words=DC.SET_KW["key_words"]),
        card=False)


def test_recovery_script_matches_the_reference():
    """The script through both packages' DynamicClusters at depth 2: every
    read, commit and retry, every worker request, every trace event, the
    controllers, disks and status documents, the script's record and the
    loops' ends equal."""
    ref = _run("ref", 2)[0]
    port = _run("port", 2)[0]
    for key in ref:
        assert port[key] == ref[key], DC.first_difference(port[key], ref[key], key)


def test_reference_without_the_f9_fix_breaks_the_ring():
    """F9_SHAPE at F9_SEED, one tlog killed, on the host engines: the
    reference's own recovery lets a storage apply an orphan above the
    epoch-end cut (a log fast-forwarded before another truncated confirms
    the jumped version), and the ring read back is no longer one cycle.
    The port's run holds it, to the record of the reference's with the
    port's fix."""
    kw = dict(shape=F9_SHAPE, arm="cpu", seed=F9_SEED, events=("tlog",))
    with pytest.raises(AssertionError, match="no longer one cycle"):
        _run("ref", 2, f9=False, **kw)
    ref = _run("ref", 2, **kw)[0]
    port = _run("port", 2, **kw)[0]
    for key in ref:
        assert port[key] == ref[key], DC.first_difference(port[key], ref[key], key)
