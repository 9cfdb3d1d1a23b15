"""The port's coordinators, failure monitor, peek cursor, log router and
quorum change, held to the reference's on the CPU.

Each twin runs one test function of a reference test module for each
package (tests/test_torch_dynamic_cluster.py's ``assert_twins``: the
module's source loaded once as it is and once pointed at the port) and
holds the two runs' records equal: every client read, commit and retry
with its virtual time, every request a worker served, every trace event
less its wall time, each cluster's controllers, disks (the coordinators'
registers) and status document, and each event loop's end time and its
rng's next draw.  Twinned: all 5 of tests/test_coordination.py, all 5 of
test_failure_monitor.py, all 4 of test_peek_cursor.py, all 8 of
test_coordinators_change.py, and 2 of test_multiregion.py's 3; its third
(the DR agent) is twinned in tests/test_torch_dr.py, and here also as the
merge cursor tailing the same two-log source.  Every cluster runs
each package's host engine.
"""

from __future__ import annotations

import importlib
import importlib.util
import pathlib

import pytest

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_dc_twins_coord",
                                               _here / "test_torch_dynamic_cluster.py")
DC = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(DC)
_restore_globals = DC._restore_globals
assert_twins = DC.assert_twins


@pytest.mark.parametrize("test", [
    "test_coordinated_state_read_write",
    "test_coordinated_state_conflict",
    "test_coordinated_state_tolerates_minority_failure",
    "test_leader_election_and_failover",
    "test_election_determinism",
])
def test_coordination(test):
    rec = assert_twins("test_coordination", test)
    assert rec["loops"]


@pytest.mark.parametrize("test", [
    "test_delta_protocol_and_snapshot_fallback",
    "test_long_poll_wakes_on_state_bump",
    "test_heartbeat_answers_empty_when_nothing_changes",
    "test_client_survives_monitor_death_mid_wait",
    "test_read_routes_around_suspect_replica_without_timeout",
])
def test_failure_monitor(test):
    assert_twins("test_failure_monitor", test)


@pytest.mark.parametrize("test", [
    "test_fresh_replacement_log_served_by_survivor",
    "test_uncovered_range_raises_not_skips",
    "test_mid_stream_floor_jump_raises",
    "test_tag_slot_hole_not_masked_by_unrelated_log",
])
def test_peek_cursor(test):
    assert_twins("test_peek_cursor", test)


@pytest.mark.parametrize("test", [
    "test_log_router_reserves_stream_to_remote_storage",
    "test_two_dc_failover_zero_acked_loss",
])
def test_multiregion(test):
    assert_twins("test_multiregion", test)


def _tail_two_logs(pkg):
    """test_dr_multi_log_source's source (SimCluster(seed=9402, n_tlogs=2,
    n_storages=2), the same fills) tailed through `pkg`'s MergePeekCursor
    over both logs, flattened to commit order, its tag holding the logs'
    floors as a log router's does."""
    base = DC.BASES[pkg]
    imp = importlib.import_module
    SimCluster = imp(f"{base}.server.cluster").SimCluster
    Cursor = imp(f"{base}.rpc.peek_cursor").MergePeekCursor
    Pop = imp(f"{base}.server.interfaces").TLogPopRequest
    kw = {"conflict_backend": "cpu"}
    src = SimCluster(seed=9402, n_tlogs=2, n_storages=2, **kw)
    sdb = src.database("src_client")
    proc = src.net.process("tailer")
    cursor = Cursor(proc, [t.interface() for t in src.tlogs])
    out = []

    async def scenario():
        # Hold both logs' floors for the tailer first, as a log router
        # registers its tag.
        for t in src.tlogs:
            await t.interface().pop.get_reply(proc, Pop(version=0, tag="_tail"))

        async def fill(tr):
            for i in range(20):
                tr.set(b"dr%03d" % i, b"v%03d" % i)

        async def more(tr):
            for i in range(20, 40):
                tr.set(b"dr%03d" % i, b"v%03d" % i)
            tr.clear_range(b"dr000", b"dr005")

        await sdb.run(fill)
        await sdb.run(more)
        for _ in range(8):
            entries, end = await cursor.next_batch()
            for version, bundle in entries:
                out.append((version, [(int(m.type), m.param1, m.param2)
                                      for m in cursor.flatten(bundle)]))
            out.append(("end", end))
            await src.loop.delay(0.01)

    src.run_until(sdb.process.spawn(scenario(), "sc"), timeout_vt=5000.0)
    return out, src.loop.now(), src.loop.rng.random_int(0, 1 << 30)


def test_merge_cursor_tails_a_two_log_source():
    recs = {}
    for pkg in ("ref", "port"):
        with DC.twin_run(pkg, "cpu") as rec:
            rec["tail"] = _tail_two_logs(pkg)
        recs[pkg] = rec
    assert recs["port"] == recs["ref"]
    muts = [m for v, ms in recs["port"]["tail"][0] if v != "end" for m in ms]
    assert any(p1 == b"dr039" for _t, p1, _p2 in muts)


@pytest.mark.parametrize("test", [
    "test_change_coordinators_during_load",
    "test_reelection_on_new_quorum_after_swap",
    "test_stale_cstate_writer_fenced_after_move",
    "test_crash_recover_after_quorum_move",
    "test_unsatisfiable_coordinator_request_is_rejected",
    "test_overlapping_quorum_change_keeps_elections_alive",
    "test_reused_retired_address_serves_again",
    "test_setclass_prefers_stateless_workers",
])
def test_coordinators_change(test):
    assert_twins("test_coordinators_change", test)


def test_peek_cursor_replication_factor_is_an_argument():
    """The reference's log_replication_factor knob is the cursor's argument,
    at the reference's default."""
    from foundationdb_tpu.flow.knobs import g_knobs
    from foundationdb_tpu_torch.rpc.peek_cursor import MergePeekCursor

    assert MergePeekCursor(None, []).log_replication_factor == (
        g_knobs.server.log_replication_factor)
