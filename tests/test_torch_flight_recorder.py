"""The port's trace events and flight recorder (foundationdb_tpu_torch/flow/
trace.py, flight_recorder.py) and their hooks, against the reference's.

Twins of tests/test_flight_recorder.py on the port's own objects: a
capture holds its window's events and transitions (:135); the cooldown and
the capture ring (:154) and the cooldown's clock edges (:186), through the
recorder's ``clock=`` where the reference reads its event loop; the
disabled recorder (:206, ``FlightRecorder(enabled=False)`` for the
reference's FDB_TPU_FLIGHTREC=0); a breaker open captures with its
transition (:244); byte-identical artifacts across runs (:283).

Then differentials: the reference's and the port's sets, each on a fresh
reference SpanHub, TraceCollector and FlightRecorder installed into both
packages' globals, give the same trace events (less ``Time``, wall time
without an event loop) with the same details, and the same captures, on
the planted divergences of tests/test_torch_api.py:286 (a fixpoint
divergence with a parked tail: here a real one, the residual-overflow
batch of tests/test_torch_witness_free.py, at depths 1 and 2) and :346 (a
device edit that mirror_check finds), of tests/test_torch_shard_faults.py:
233 (one shard's fixpoint) and a sharded mirror_check; and on
tests/test_torch_reshard.py's move and 4 -> 6 shards, with a deferring
``reshard`` fault (ShardReshardDeferred).  All integers; the tolerance is
zero.
"""

import json

import numpy as np
import pytest

import foundationdb_tpu.parallel.sharded_resolver as jsr
import foundationdb_tpu_torch.flow.spans as port_spans
from foundationdb_tpu.conflict.api import ConflictSet as RefConflictSet
from foundationdb_tpu.conflict.device_faults import DeviceFaultInjector as RefInjector
from foundationdb_tpu.conflict.engine_jax import JaxConflictSet
from foundationdb_tpu_torch.conflict import engine_torch as et
from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector
from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as TT
from foundationdb_tpu_torch.flow.flight_recorder import (
    FlightRecorder,
    artifact_json,
    global_flight_recorder,
    maybe_trigger,
    set_global_flight_recorder,
)
from foundationdb_tpu_torch.flow.spans import SpanHub, set_global_span_hub
from foundationdb_tpu_torch.flow.trace import TraceCollector, TraceEvent, set_global_collector
from foundationdb_tpu_torch.metrics import MetricsRegistry
from foundationdb_tpu_torch.parallel.sharded_resolver import uniform_int_split_keys

from test_reshard import KEY_BYTES, N_KEYS
from test_torch_api import _random_stream
from test_torch_reshard import MOVED, _shared_reference_steps  # noqa: F401 (module fixture)
from test_torch_reshard import make_port as reshard_port
from test_torch_reshard import make_ref as reshard_ref
from test_torch_reshard import reference_env
from test_torch_reshard import stream as reshard_stream
from test_torch_shard_faults import _patch_divergence
from test_torch_sharded import make_port, make_ref, port_txns, random_stream
from test_torch_spans import (
    _drive,
    _port_set,
    _restore_globals,  # noqa: F401 (autouse fixture)
    capture_less_time,
    events_less_time,
    install_reference_hubs,
)
from test_torch_witness_free import witness_free_stream


@pytest.fixture(autouse=True)
def _fresh_port_objects(_restore_globals):
    """Each test starts on the port's own fresh recorder, collector and hub."""
    set_global_flight_recorder(FlightRecorder())
    set_global_collector(TraceCollector())
    set_global_span_hub(SpanHub())
    yield


def _write_txns(i, n=1):
    return [TT(read_snapshot=0,
               write_ranges=[(b"%06d" % (100 * i + 2 * j), b"%06d" % (100 * i + 2 * j + 1))])
            for j in range(n)]


class Samples:
    """A time-series source for the port's recorder: a registry snapshot
    appended per call of record(), the last `window` returned."""

    def __init__(self, window=64):
        self.series: dict = {}
        self.window = window

    def record(self, name, registry, now):
        self.series.setdefault(name, []).append(registry.snapshot(now=now))

    def __call__(self):
        return {k: v[-self.window:] for k, v in sorted(self.series.items())}


# ---------------------------------------------------------------------------
# the recorder: capture shape, cooldown, ring, switch
# ---------------------------------------------------------------------------


def test_capture_contains_window_events_and_transitions():
    """tests/test_flight_recorder.py:135."""
    samples = Samples()
    set_global_flight_recorder(FlightRecorder(timeseries=samples))
    reg = MetricsRegistry("A")
    reg.counter("n").add(1)
    samples.record("A", reg, now=1.0)
    TraceEvent("Incident").detail("k", 1).log(now=1.5)
    art = global_flight_recorder().capture(
        "unit", detail={"why": "test"}, transitions=[[1, "ok", "degraded", "r"]], now=2.0)
    assert art["trigger"] == "unit" and art["time"] == 2.0
    assert art["timeseries"]["A"][0]["counters"]["n"] == 1
    assert art["recent_events"][-1] == {"Type": "Incident", "Severity": 10, "Time": 1.5, "k": 1}
    assert art["transitions"] == [[1, "ok", "degraded", "r"]]
    assert json.loads(artifact_json(art)) == art
    assert sorted(art) == ["capture_seq", "detail", "recent_events", "spans", "time",
                           "timeseries", "transitions", "trigger"]
    # Without a source the time-series section reads {}.
    assert FlightRecorder().capture("unit")["timeseries"] == {}


def test_trigger_cooldown_and_capture_ring_bound():
    """tests/test_flight_recorder.py:154, the cooldown on `clock`."""
    rec = FlightRecorder(max_captures=2, window=4, cooldown=5.0, clock=lambda: 0.0)
    set_global_flight_recorder(rec)
    assert maybe_trigger("kind_a") is not None
    assert maybe_trigger("kind_a") is None  # inside the cooldown
    assert maybe_trigger("kind_b") is not None  # per-kind cooldowns
    assert rec.trigger_counts == {"kind_a": 2, "kind_b": 1}
    for i in range(5):
        rec.capture(f"c{i}")
    assert len(rec.captures) == 2
    assert [c["trigger"] for c in rec.captures] == ["c3", "c4"]
    assert rec.capture_seq == 7
    sec = rec.status_section()
    assert sec["captures"] == 2 and sec["last_capture"]["trigger"] == "c4"
    resolved = []
    art = rec.trigger("kind_c", transitions=lambda: resolved.append(1) or [[1]])
    assert art["transitions"] == [[1]] and resolved == [1]
    assert rec.trigger("kind_c", transitions=lambda: resolved.append(1)) is None
    assert resolved == [1]
    assert rec.trigger("kind_d", source=1) is not None
    assert rec.trigger("kind_d", source=2) is not None
    assert rec.trigger("kind_d", source=1) is None


def test_trigger_cooldown_clock_edges():
    """tests/test_flight_recorder.py:186: no clock, no cooldown; a stamp
    that went backwards (a new run) captures; the same run's cooldown
    holds."""
    rec = FlightRecorder(max_captures=8, window=4, cooldown=5.0)
    set_global_flight_recorder(rec)
    assert maybe_trigger("k") is not None
    assert maybe_trigger("k") is not None
    now = [300.0]
    rec.clock = lambda: now[0]
    assert maybe_trigger("k") is not None
    now[0] = 0.0
    assert maybe_trigger("k") is not None
    assert maybe_trigger("k") is None
    now[0] = 5.0
    assert maybe_trigger("k") is not None


def test_disabled_recorder():
    """tests/test_flight_recorder.py:206 with FlightRecorder(enabled=False)
    for FDB_TPU_FLIGHTREC=0: triggers capture and count nothing; an
    explicit capture still works.  The defaults are the reference knobs'."""
    rec = FlightRecorder(enabled=False)
    set_global_flight_recorder(rec)
    assert maybe_trigger("anything") is None
    assert rec.captures.maxlen == 16 and len(rec.captures) == 0
    assert rec.trigger_counts == {}
    assert (rec.window, rec.cooldown) == (64, 5.0)
    assert rec.capture("explicit")["capture_seq"] == 1
    assert TraceCollector().recent_maxlen == 512


def test_breaker_open_triggers_capture_with_transition():
    """tests/test_flight_recorder.py:244 on the port's set: the capture
    holds the triggering transition, the surrounding samples and the
    recent events with the state change itself; a probe failure
    re-opening the circuit is no new open."""
    samples = Samples()
    set_global_flight_recorder(FlightRecorder(timeseries=samples))
    inj = DeviceFaultInjector()
    cs = _port_set(1, fault_injector=inj, key_words=4, h_cap=1 << 16)
    now = 100
    for i in range(3):
        cs._detect(_write_txns(i), now, 0)
        samples.record("TorchConflict.unit", cs._dev.metrics, now=float(now))
        now += 10
    inj.begin_outage("dispatch")
    for i in range(3, 7):
        cs._detect(_write_txns(i), now, 0)
        now += 10
    inj.end_outage("dispatch")
    rec = global_flight_recorder()
    (cap,) = [c for c in rec.captures if c["trigger"] == "breaker_open"]
    assert cap["transitions"][-1][1:3] == ["ok", "degraded"]
    assert cap["detail"]["reason"].startswith("threshold:")
    assert cap["timeseries"]["TorchConflict.unit"][0]["counters"]["batches"] >= 1
    assert any(e["Type"] == "DeviceBackendStateChange" for e in cap["recent_events"])
    assert any(s["name"] == "breaker.degraded" for s in cap["spans"]["DeviceBreaker"])
    assert rec.trigger_counts.get("breaker_open", 0) == 1
    faulted = [s for s in port_spans.global_span_hub().spans(name="device")
               if s.attrs.get("fault")]
    assert faulted


def test_breaker_open_artifacts_byte_identical_across_runs():
    """tests/test_flight_recorder.py:283: two runs of a scripted outage
    give byte-identical artifacts (events on a virtual clock)."""

    def run():
        t = [0.0]
        samples = Samples()
        set_global_flight_recorder(FlightRecorder(timeseries=samples, clock=lambda: t[0]))
        set_global_collector(TraceCollector(clock=lambda: t[0]))
        set_global_span_hub(SpanHub(clock=lambda: t[0]))
        inj = DeviceFaultInjector()
        inj.script("dispatch", at=4, persist=4)
        cs = _port_set(1, fault_injector=inj, key_words=4, h_cap=1 << 16)
        now = 100
        for i in range(8):
            t[0] = float(now)
            cs._detect(_write_txns(i), now, 0)
            samples.record("TorchConflict.unit", cs._dev.metrics, now=float(now))
            now += 10
        return [artifact_json(c) for c in global_flight_recorder().captures]

    a, b = run(), run()
    assert a and a == b


# ---------------------------------------------------------------------------
# differentials: the same events and captures as the reference
# ---------------------------------------------------------------------------


def _recorded(run):
    """Run `run(port)` on each side on fresh reference hubs installed into
    both packages; returns (reference, port) of (result, events less Time,
    captures less Time, spans_json)."""
    out = []
    for port in (False, True):
        hub, col, rec = install_reference_hubs()
        result = run(port)
        out.append((result, events_less_time(col.events),
                    [capture_less_time(a) for a in rec.captures], hub.spans_json()))
    return out


@pytest.mark.parametrize("depth", [1, 2])
def test_fixpoint_divergence_events_match_the_reference(monkeypatch, depth):
    """A real fixpoint divergence (the residual-overflow batch): at depth 1
    the engine's CPU fallback, at depth 2 the pipelined sync; the same
    ConflictFixpointDiverged event (``pipelined`` on the ticket path)."""
    monkeypatch.setenv("FDB_TPU_PIPELINE_DEPTH", str(depth))
    stream = witness_free_stream(5)

    def run(port):
        if port:
            cs = _port_set(depth)
        else:
            cs = RefConflictSet(backend="jax", key_words=3, bucket_mins=(32, 128, 64),
                                h_cap=1 << 10)
        return _drive(cs, stream, depth, port)

    want, got = _recorded(run)
    assert got == want
    (ev,) = [e for e in got[1] if e["Type"] == "ConflictFixpointDiverged"]
    assert ev["Severity"] == 30 and ev["n_txn"] == 32
    assert ("pipelined" in ev) == (depth > 1)


def test_parked_tail_divergence_spans_match_the_reference(monkeypatch):
    """tests/test_torch_api.py:286 planted on both sides at the ticket's
    undecided count, with two batches parked behind it: the same event, the
    diverged and replayed device spans."""
    import jax.numpy as jnp

    monkeypatch.setenv("FDB_TPU_PIPELINE_DEPTH", "3")
    stream = _random_stream(31, 60, 16, 8)
    ref_sync = JaxConflictSet.sync_ticket
    port_readback = et.TorchConflictSet._readback

    def run(port):
        cs = _port_set(3) if port else RefConflictSet(
            backend="jax", key_words=3, bucket_mins=(32, 128, 64), h_cap=1 << 10)
        fired = {"n": 0}

        def due():
            if fired["n"] == 0 and len(cs._pipe) >= 2:
                fired["n"] += 1
                return True
            return False

        def fake_sync(self, ticket):
            if due():
                ticket.undecided = jnp.asarray(1, jnp.int32)
            return ref_sync(self, ticket)

        def fake_readback(self, ticket, pipelined):
            if pipelined and due():
                ticket.out[0] = 1
            return port_readback(self, ticket, pipelined)

        with monkeypatch.context() as mp:
            if port:
                mp.setattr(et.TorchConflictSet, "_readback", fake_readback)
            else:
                mp.setattr(JaxConflictSet, "sync_ticket", fake_sync)
            out = _drive(cs, stream, 3, port)
        assert fired["n"] == 1
        return out

    want, got = _recorded(run)
    assert got == want
    assert [e["Type"] for e in got[1]] == ["ConflictFixpointDiverged"]
    marks = [s["attrs"] for s in json.loads(got[3])["spans"]["span"] if s["name"] == "device"]
    assert sum("diverged" in a for a in marks) == 1
    assert sum("replayed" in a for a in marks) >= 2


def test_mirror_divergence_events_and_captures_match_the_reference(monkeypatch):
    """tests/test_torch_api.py:346: one live boundary's version edited on
    the device; mirror_check's MirrorDivergence, the breaker's state change
    and both captures (breaker_open, then mirror_divergence holding the
    open) equal the reference's."""
    monkeypatch.setenv("FDB_TPU_PIPELINE_DEPTH", "2")
    stream = _random_stream(3, 60, 10, 8)

    def run(port):
        cs = _port_set(2) if port else RefConflictSet(
            backend="jax", key_words=3, bucket_mins=(32, 128, 64), h_cap=1 << 10)
        _drive(cs, stream, 2, port)
        if port:
            cs._dev._hvers[1] += 1
        else:
            cs._jax._hvers = cs._jax._hvers.at[1].add(1)
        return cs.mirror_check()

    want, got = _recorded(run)
    assert got == want
    assert got[0]["status"] == "diverged"
    assert [e["Type"] for e in got[1]] == ["MirrorDivergence", "DeviceBackendStateChange"]
    (div,) = [e for e in got[1] if e["Type"] == "MirrorDivergence"]
    assert div["Severity"] == 40 and div["mismatch_keys"] == 1
    assert [c["trigger"] for c in got[2]] == ["breaker_open", "mirror_divergence"]
    assert got[2][1]["transitions"][-1][3] == "mirror_divergence:mismatch_keys=1"


@pytest.mark.parametrize("mode", ["flat", "tiered"])
def test_one_shard_divergence_event_matches_the_reference(monkeypatch, mode):
    """tests/test_torch_shard_faults.py:233's planted divergence of shard
    1 at batch 4 (the reference's whole step patched to report it, as
    tests/test_sharded_resolver.py:162 does): the same sharded
    ConflictFixpointDiverged event and span record."""
    import jax.numpy as jnp

    tiered = mode == "tiered"
    stream = random_stream(23, 8)
    real_step_for = jsr.ShardedJaxConflictSet._step_for

    def run(port):
        with monkeypatch.context() as mp:
            if port:
                cs = make_port(2, tiered=tiered)
                _patch_divergence(mp, mode, shard=1, n_shards=2, batch=4)
            else:
                if tiered:
                    from test_torch_sharded import TIERED_ENV

                    for k, v in TIERED_ENV.items():
                        mp.setenv(k, v)
                    mp.setattr(jsr, "_SHARD_MAP_KW", {"check_vma": False})
                cs = make_ref(2, tiered=tiered)
                calls = {"n": 0}

                def step_for(self, pb):
                    step = real_step_for(self, pb)

                    def patched(*args):
                        out = list(step(*args))
                        k = 9 if self.tiered else 5
                        if calls["n"] == 4:
                            out[k] = jnp.ones_like(out[k])
                        calls["n"] += 1
                        return tuple(out)

                    return patched

                mp.setattr(jsr.ShardedJaxConflictSet, "_step_for", step_for)
            return [cs.detect(port_txns(t) if port else t, now, nov)
                    for t, now, nov in stream]

    want, got = _recorded(run)
    assert got[0] == want[0]
    assert got[1] == want[1]
    (ev,) = got[1]
    assert ev == {"Type": "ConflictFixpointDiverged", "Severity": 30,
                  "n_txn": ev["n_txn"], "sharded": True}
    assert got[3] == want[3]


def test_sharded_mirror_divergence_matches_the_reference():
    """A sharded mirror_check finding shard 1's slice edited: the same
    MirrorDivergence (with the shard), the shard breaker's open and both
    captures."""
    import jax
    import jax.numpy as jnp

    stream = random_stream(7, 6)

    def run(port):
        cs = make_port(2) if port else make_ref(2)
        for txns, now, nov in stream:
            cs.detect(port_txns(txns) if port else txns, now, nov)
        if port:
            cs._hvers[1, 1] += 1
        else:
            hv = np.asarray(cs._hvers).copy()
            hv[1, 1] += 1
            cs._hvers = jax.device_put(jnp.asarray(hv), cs._shardspec)
        return cs.mirror_check()

    want, got = _recorded(run)
    assert got == want
    assert got[0]["shards"]["shard1"]["status"] == "diverged"
    (div,) = [e for e in got[1] if e["Type"] == "MirrorDivergence"]
    assert div["shard"] == 1
    assert [c["trigger"] for c in got[2]] == ["breaker_open", "mirror_divergence"]
    assert got[2][0]["detail"]["domain"] == "shard1"


def test_reshard_events_and_captures_match_the_reference():
    """tests/test_torch_reshard.py's move and 4 -> 6 shards, after a move
    deferred by a reshard fault on shard 1: ShardReshardDeferred, then one
    ShardReshard event, reshard marker span and reshard capture a committed
    step, equal to the reference's."""
    split = uniform_int_split_keys(4, N_KEYS, KEY_BYTES)
    six = uniform_int_split_keys(6, N_KEYS, KEY_BYTES)
    schedule = {2: (MOVED, "race"), 3: (MOVED, "retry"), 5: (six, "scale")}

    def run(port):
        with pytest.MonkeyPatch.context() as mp:
            if not port:
                reference_env(mp, False)
            cs = reshard_port(split) if port else reshard_ref(split)
            inj = DeviceFaultInjector() if port else RefInjector()
            inj.script("reshard", at=1, shard=1)
            cs.install_fault_injector(inj)
            entries = []
            for b, (txns, now, nov) in enumerate(reshard_stream(5, 8, n_max=30)):
                cs.detect(port_txns(txns) if port else txns, now, nov)
                if b in schedule:
                    keys, reason = schedule[b]
                    entries.append(cs.reshard(keys, reason=reason))
        return json.loads(json.dumps(entries))

    want, got = _recorded(run)
    assert got == want
    assert [e["action"] for e in got[0]] == ["deferred", "live", "live"]
    types = [e["Type"] for e in got[1]]
    assert types.count("ShardReshardDeferred") == 1 and types.count("ShardReshard") == 2
    assert [c["trigger"] for c in got[2] if c["trigger"] == "reshard"] == ["reshard", "reshard"]
    marks = json.loads(got[3])["spans"]["ShardedConflict"]
    assert [s["attrs"]["shards"] for s in marks] == [4, 6]
