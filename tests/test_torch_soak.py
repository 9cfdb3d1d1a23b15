"""The reference's chaos soak served through the port's conflict sets.

``run_soak`` (foundationdb_tpu/workloads/soak.py) is the reference's,
unchanged; the test replaces only its cluster builder, ``_build_cluster``,
with one that hands the port's set to ``SimCluster(conflict_set=...)``
with the soak's Ratekeeper wiring:

- ``backend="jax"``: the port's ``ConflictSet(device="cpu")`` with the
  settings the reference's Resolver gives ``ConflictSet(backend="jax")``
  (the key-words knob, ``h_cap`` 1<<16, ``bucket_mins`` (8, 8, 8),
  pipeline depth 2);
- ``backend="sharded"``: the port's ``ShardedTorchConflictSet(device=
  "cpu")`` with the soak's ``key_words=8``, ``h_cap=1<<12``,
  ``bucket_mins=(64, 128, 128)`` and ``max_shards``, split as the soak
  splits.

The soak's device arms import the reference's ``DeviceFaultInjector`` by
name when a fault starts; the port's sets absorb only the port's faults,
so the port's class stands in for that name (``monkeypatch``).

The builder also installs the run's own span hub, trace collector and
flight recorder (the reference's, which ``run_soak`` swaps in before it
builds the cluster) into the port's globals, with the event loop's clock
for the port's trace events, and the run restores the port's afterwards:
the port's spans, events and captures then land where the reference's
would.  Each report equals the reference's same-seed report, ``json.dumps(
sort_keys=True)``, whole: spans, trace events, captures and the engine
registry's time series included (EXCLUDED is empty).  Twins of
tests/test_soak.py:133 (device outage), :192 (shard kill, 4 shards) and
:243 (same seed, same report), and one soak with a ``shard_move`` fault.
"""

import copy
import json

import pytest

import foundationdb_tpu.flow.flight_recorder as ref_fr
import foundationdb_tpu.flow.spans as ref_spans
import foundationdb_tpu.flow.trace as ref_trace
import foundationdb_tpu.workloads.soak as soak
import foundationdb_tpu_torch.flow.flight_recorder as port_fr
import foundationdb_tpu_torch.flow.spans as port_spans
import foundationdb_tpu_torch.flow.trace as port_trace
from foundationdb_tpu.conflict import device_faults as ref_faults
from foundationdb_tpu.flow import set_event_loop
from foundationdb_tpu.flow.knobs import g_knobs
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector
from foundationdb_tpu_torch.parallel.sharded_resolver import ShardedTorchConflictSet

from test_soak import _limiting_within


@pytest.fixture(autouse=True)
def _clean_loop():
    yield
    set_event_loop(None)


# Report parts the port cannot produce, each with its reason: none.  The
# port's span layer, trace events and flight-recorder hooks fill every part
# of the report the reference's do.
EXCLUDED: dict = {}


def comparable(report: dict) -> dict:
    """The report less EXCLUDED: the whole report."""
    assert not EXCLUDED
    return copy.deepcopy(report)


def first_difference(want, got, path="report"):
    """The first path at which two JSON-like values differ, or None."""
    if type(want) is not type(got):
        return f"{path}: {type(want).__name__} against {type(got).__name__}"
    if isinstance(want, dict):
        for key in sorted(set(want) | set(got), key=str):
            if key not in want or key not in got:
                return f"{path}.{key}: only in the {'reference' if key in want else 'port'}"
            d = first_difference(want[key], got[key], f"{path}.{key}")
            if d:
                return d
        return None
    if isinstance(want, list):
        for i, (w, g) in enumerate(zip(want, got)):
            d = first_difference(w, g, f"{path}[{i}]")
            if d:
                return d
        if len(want) != len(got):
            return f"{path}: {len(want)} items against {len(got)}"
        return None
    return None if want == got else f"{path}: {want!r} against {got!r}"


def _port_cluster(config):
    """soak._build_cluster's sim arm with the port's conflict set."""
    from foundationdb_tpu.server import SimCluster
    from foundationdb_tpu.server.ratekeeper import Ratekeeper

    assert config.cluster == "sim"
    if config.backend == "sharded":
        n = max(2, config.sharded_shards)
        split = [b"soak/%06d" % (config.keys * s // n) for s in range(1, n)]
        cs = ShardedTorchConflictSet(split, key_words=8, h_cap=1 << 12, device="cpu",
                                     bucket_mins=(64, 128, 128),
                                     max_shards=config.sharded_max_shards)
    else:
        assert config.backend == "jax"
        cs = ConflictSet(device="cpu", key_words=g_knobs.server.conflict_device_key_words,
                         h_cap=1 << 16, bucket_mins=(8, 8, 8), pipeline_depth=2)
    cluster = SimCluster(seed=config.seed, conflict_backend="cpu",
                         n_resolvers=config.n_resolvers, buggify=config.buggify,
                         conflict_set=cs)
    rk = Ratekeeper(cluster.master_proc, cluster.tlogs, cluster.storages,
                    sample_interval=config.rk_sample_interval,
                    resolvers=cluster.resolvers, proxies=cluster.proxies)
    for p in cluster.proxies:
        p.ratekeeper = rk.interface()
    cluster._soak_ratekeeper = rk
    cluster.port_conflict_set = cs
    return cluster, [cluster.database(f"soak{i}") for i in range(max(1, config.clients))]


def run_port_soak(config):
    """run_soak with the port's conflict set; returns (report, set).  The
    builder installs the run's span hub, trace collector and flight
    recorder into the port's globals (trace events on the loop's clock);
    the port's own are restored after the run."""
    built = []
    saved = (port_spans.global_span_hub(), port_trace.global_collector(),
             port_trace._global_clock, port_fr.global_flight_recorder())

    def build(cfg):
        out = _port_cluster(cfg)
        port_spans.set_global_span_hub(ref_spans.global_span_hub())
        port_trace.set_global_collector(ref_trace.global_collector(), clock=out[0].loop.now)
        port_fr.set_global_flight_recorder(ref_fr.global_flight_recorder())
        built.append(out[0].port_conflict_set)
        return out

    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(soak, "_build_cluster", build)
            mp.setattr(ref_faults, "DeviceFaultInjector", DeviceFaultInjector)
            report = soak.run_soak(copy.deepcopy(config))
    finally:
        port_spans.set_global_span_hub(saved[0])
        port_trace.set_global_collector(saved[1], clock=saved[2])
        port_fr.set_global_flight_recorder(saved[3])
    (cs,) = built
    return report, cs


def _device_outage_cfg():
    return soak.SoakConfig(
        seed=9, cluster="sim", backend="jax", mode="open", keys=64,
        phases=[soak.SoakPhase("peak", 3.0, 60.0)],
        faults=[soak.FaultEvent(at=1.0, kind="device_outage", duration=1.0)],
        drain_timeout=5.0, degraded_tps_fraction=0.1,
    )


def _shard_kill_cfg():
    """tests/test_soak.py:192's shard kill, cut from 0.15 to 0.1 minutes at
    40 txn/s (the port's set runs its CPU twins a shard at a time)."""
    cfg = soak.shard_outage_config(minutes=0.1, peak_tps=40.0, seed=17, shard=1, n_shards=4)
    cfg.keys = 64
    cfg.drain_timeout = 5.0
    cfg.max_tps = 40.0
    cfg.degraded_tps_fraction = 0.0
    return cfg


def _shard_move_cfg():
    """Four shards with room for eight under the shard-outage load: a live
    rebalance at the same count, then a scale-up to six."""
    cfg = soak.shard_outage_config(minutes=0.06, peak_tps=40.0, seed=29, shard=2, n_shards=4)
    cfg.keys = 64
    cfg.drain_timeout = 5.0
    cfg.sharded_max_shards = 8
    cfg.faults = [soak.FaultEvent(at=0.8, kind="shard_move", shard=0),
                  soak.FaultEvent(at=1.6, kind="shard_move", shard=6)]
    return cfg


CONFIGS = {"device_outage": _device_outage_cfg, "shard_kill": _shard_kill_cfg,
           "shard_move": _shard_move_cfg}


@pytest.fixture(scope="module")
def reference_reports():
    """The reference's report of each config, made once and shared."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = soak.run_soak(CONFIGS[name]())
        return cache[name]

    return get


@pytest.fixture(scope="module")
def port_runs():
    """The port's (report, set) of each config, made once and shared."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_port_soak(CONFIGS[name]())
        return cache[name]

    return get


def _legal_walk(transitions):
    legal = {("ok", "degraded"), ("degraded", "probing"), ("probing", "ok"),
             ("probing", "degraded")}
    prev = "ok"
    for _seq, frm, to, _reason in transitions:
        assert frm == prev and (frm, to) in legal, transitions
        prev = to
    return prev


def _assert_equal_less_excluded(got, want):
    g, w = comparable(got), comparable(want)
    diff = first_difference(w, g)
    assert diff is None, diff
    assert json.dumps(g, sort_keys=True) == json.dumps(w, sort_keys=True)


def test_soak_device_outage_through_the_port(reference_reports, port_runs):
    """Twin of tests/test_soak.py:133: the breaker walks ok -> degraded ->
    probing -> ok, the ratekeeper contracts to the degraded cap while it is
    open and releases after; the report equals the reference's."""
    want = reference_reports("device_outage")
    rep, cs = port_runs("device_outage")
    _assert_equal_less_excluded(rep, want)
    assert rep["slo"]["ok"], rep["slo"]
    (t0, kind, _detail, t1), = rep["faults"]
    assert kind == "device_outage"
    log = rep["ratekeeper"]["admission_log"]
    assert any(e[1] == "backend_degraded" for e in _limiting_within(log, t0, t1 + 0.5)), log
    assert log[-1][1] == "none", log
    (transitions,) = rep["breakers"].values()
    assert transitions and _legal_walk(transitions) == "ok"
    assert rep["totals"]["committed"] > 0
    assert rep["totals"]["failed"] == 0 and rep["totals"]["exhausted"] == 0
    # The outage went through the port's injector into the port's breaker.
    assert type(cs._dev.fault_injector) is DeviceFaultInjector
    counters = cs.device_metrics()["counters"]
    assert counters["device_faults"] == len(cs._dev.fault_injector.injected) > 0
    assert counters["rehydrates"] >= 2 and counters["pipeline_dispatches"] > 0
    triggers = [c["trigger"] for c in rep["flight_recorder"]["captures"]]
    assert "fault_window:device_outage" in triggers


def test_soak_shard_kill_through_the_port(reference_reports, port_runs):
    """Twin of tests/test_soak.py:192: only shard 1's breaker walks and
    recovers, the survivors hold every phase's goodput floor, admission
    contracts in proportion; the report equals the reference's."""
    cfg = _shard_kill_cfg()
    want = reference_reports("shard_kill")
    rep, cs = port_runs("shard_kill")
    _assert_equal_less_excluded(rep, want)
    assert rep["slo"]["ok"], rep["slo"]
    (t0, kind, detail, t1), = rep["faults"]
    assert kind == "shard_kill" and detail.endswith(":shard1"), rep["faults"]
    rname = detail.split(":")[0]
    for key, transitions in rep["breakers"].items():
        if key == f"{rname}.shard1":
            assert transitions[0][1:3] == ["ok", "degraded"]
            assert _legal_walk(transitions) == "ok"
        else:
            assert transitions == [], (key, transitions)
    shards = rep["shards"][rname]
    assert shards["total"] == 4 and shards["states"] == ["ok"] * 4
    assert shards["degraded_shard_serves"] > 0
    window = _limiting_within(rep["ratekeeper"]["admission_log"], t0, t1 + 0.5)
    deg = [e for e in window if e[1] == "backend_degraded"]
    assert deg and all(e[2] >= 0.5 * cfg.max_tps for e in deg), deg
    assert {site for _q, site, _k in cs.fault_injector.injected} == {"dispatch#s1"}
    assert cs.metrics.counter("shard1_rehydrates").value >= 1


def test_soak_same_seed_same_report_through_the_port(reference_reports, port_runs):
    """Twin of tests/test_soak.py:243 on the shard-kill soak: two same-seed
    port soaks give byte-identical reports (everything, the excluded keys
    too) and transition logs, both equal to the reference's less
    EXCLUDED."""
    a, _ = port_runs("shard_kill")
    b, _ = run_port_soak(_shard_kill_cfg())
    diff = first_difference(a, b)
    assert diff is None, diff
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert soak.transition_logs_json(a) == soak.transition_logs_json(b)
    want = reference_reports("shard_kill")
    assert soak.transition_logs_json(a) == soak.transition_logs_json(want)
    _assert_equal_less_excluded(a, want)


def test_soak_shard_move_through_the_port(reference_reports, port_runs):
    """Two scripted live reshards mid-soak (a same-count rebalance, then
    4 -> 6 shards): the move logs, occupancy, split points and the whole
    report equal the reference's less EXCLUDED."""
    want = reference_reports("shard_move")
    rep, cs = port_runs("shard_move")
    _assert_equal_less_excluded(rep, want)
    moves = [f for f in rep["faults"] if f[1] == "shard_move"]
    assert len(moves) == 2 and not any("rejected" in f[2] for f in moves), moves
    (block,) = rep["resharding"]["resolvers"].values()
    assert block["shards"] == 6 == cs.n_shards
    assert [e["action"] for e in block["move_log"]] == ["live", "live"]
    assert block["reshards"] == 2
    assert rep["slo"]["ok"], rep["slo"]
