"""The port's metrics pipeline and latency chains, held to the reference's
on the CPU.

The port's ``flow/latency_chain.py`` (``COMMIT_CHAIN``, ``GRV_CHAIN``,
``summarize_stages``, ``latency_summary``, ``percentile``), its
``metrics.py`` registry, the client's sampled debug ids
(``Database(latency_sample_rate=)``, the reference's
client.latency_sample_rate knob), the status document's latency
sections and probe, and the CLI's ``status``, ``metrics`` and ``latency
[--chains]``.  Each twin runs one test function of the reference's module
for each package with tests/test_torch_cli.py's runner and holds the two
runs' records equal (reads, commits and retries with their virtual
times, trace events less wall time, status documents, loops' ends, and
every CLI line).  The reference's modules sample every transaction from
an autouse fixture; the twins set the same knob for both runs.

Twinned: the 16 tests of tests/test_metrics_pipeline.py that are not
slow-marked (its two slow ones count the JAX engine's retraces and grows)
and the 4 of tests/test_latency_probes.py.  The port's copy of
``test_device_metrics_through_conflict_set_api`` builds its hybrid set on
the CPU; ``test_status_tpu_section_with_hybrid_backend`` runs both
clusters' resolvers over port hybrid sets ("ported" arm); the file-backed
collector's recent ring is the port's ``TraceCollector(recent=4)`` where
the reference reads FDB_TPU_TRACE_RECENT=4.
"""

from __future__ import annotations

import importlib.util
import pathlib

import pytest

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_cli_twins_metrics", _here / "test_torch_cli.py")
CLI = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CLI)
_restore_globals = CLI._restore_globals
_one_thread = CLI._one_thread

SAMPLED = {("client", "latency_sample_rate"): 1.0}

# The port's copies' substitutions, by test.
PORT_SUBS = {
    "test_device_metrics_through_conflict_set_api": [
        (r'ConflictSet\(backend="hybrid"\)', 'ConflictSet(backend="hybrid", device="cpu")')],
    "test_file_backed_collector_find_uses_bounded_recent_ring": [
        (r"TraceCollector\(path=str\(p\)\)", "TraceCollector(path=str(p), recent=4)"),
        (r"mem = TraceCollector\(\)", "mem = TraceCollector(recent=4)")],
}

METRICS_TESTS = [
    "test_same_seed_snapshots_byte_identical",
    "test_registry_snapshot_shape_and_wall_exclusion",
    "test_histogram_percentiles_with_rng",
    "test_emit_metrics_actor_traces_registry",
    "test_device_metrics_through_conflict_set_api",
    "test_latency_chain_unit_math",
    "test_latency_chain_multi_role_uses_slowest_replica",
    "test_percentile_rule_matches_continuous_sample",
    "test_live_cluster_chain_reassembles_every_stage",
    "test_status_json_has_resolver_section_and_cli_commands",
    "test_status_tpu_section_with_hybrid_backend",
    "test_durable_cluster_status_has_resolver_section",
    "test_dynamic_cluster_metrics_cmd_finds_worker_roles",
    "test_lock_rejected_txn_not_counted_committed",
    "test_counter_rate_first_call_has_no_time_zero_skew",
    "test_file_backed_collector_find_uses_bounded_recent_ring",
]


@pytest.mark.parametrize("test", METRICS_TESTS)
def test_metrics_pipeline(test, tmp_path, monkeypatch):
    arm = "ported" if test == "test_status_tpu_section_with_hybrid_backend" else "cpu"
    rec = CLI.assert_cli_twins("test_metrics_pipeline", test, arm=arm,
                               subs={"port": PORT_SUBS.get(test, [])}, knobs=SAMPLED,
                               tmp_path=tmp_path, monkeypatch=monkeypatch)
    if test == "test_status_json_has_resolver_section_and_cli_commands":
        lines = dict(rec["cli"])
        assert lines["latency"][-1].startswith("host_fraction: ")
        assert lines["latency --chains"][0] == "commit pipeline (seconds):"


@pytest.mark.parametrize("test", [
    "test_commit_debug_chain_spans_every_stage",
    "test_grv_debug_chain",
    "test_status_latency_sections_and_probe",
    "test_status_schema_gate",
])
def test_latency_probes(test):
    rec = CLI.assert_cli_twins("test_latency_probes", test, knobs=SAMPLED)
    assert any(e.get("Type") == "CommitDebug" for e in rec["trace"]) or test == "test_grv_debug_chain"
