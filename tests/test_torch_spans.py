"""The port's span layer (foundationdb_tpu_torch/flow/spans.py) and its
hooks, against the reference's.

Twins of tests/test_spans.py, each run on the port's hub with the port's
set: parenting, the stack and the rings (:95); the disabled hub (:118,
where the reference uses its FDB_TPU_SPANS switch, the port's
``SpanHub(enabled=False)``); the interval overlap math (:128); byte-
identical ``spans_json()`` for a seed and a different one for another
(:172); device spans that overlap at depth 2 and not at depth 1 (:188);
the reference's Resolver over the port's ConflictSet (:316): the stage
tree, the parent links, the overlap gauge and a live ``host_fraction``;
faulted and replayed device spans kept out of the gauge (:360); a capture
that embeds the span window (:392); and ``attribute_phases(record=True)``
(:432).

The core is the differential.  One stream goes through the reference's
``ConflictSet(backend="jax")`` and the port's ``ConflictSet(device=
"cpu")``, each on a fresh reference SpanHub, TraceCollector and
FlightRecorder installed into BOTH packages' globals (the port's module
functions use only methods the reference's objects have, so the port's
spans land in the same hub as the reference's Resolver's would).  After
every batch ``spans_json()`` is byte-identical and ``host_phase_seq``
equal, at depths 1-3, flat and tiered, under a scripted fault, and with
the witness off; the same for ``ShardedTorchConflictSet`` against
``ShardedJaxConflictSet`` with 2 shards.  The trace events (less ``Time``,
wall time without an event loop) and the captures are equal too.

Shapes: key_words=3, bucket_mins=(32, 128, 64), h_cap=1<<10, the static
shapes the reference's pipeline tests already compile.  All integers;
the tolerance is zero.
"""

import json

import pytest

import foundationdb_tpu.flow.flight_recorder as ref_fr
import foundationdb_tpu.flow.spans as ref_spans
import foundationdb_tpu.flow.trace as ref_trace
import foundationdb_tpu.parallel.sharded_resolver as jsr
import foundationdb_tpu_torch.flow.flight_recorder as port_fr
import foundationdb_tpu_torch.flow.spans as port_spans
import foundationdb_tpu_torch.flow.trace as port_trace
from foundationdb_tpu.conflict.api import ConflictSet as RefConflictSet
from foundationdb_tpu.conflict.device_faults import DeviceFaultInjector as RefInjector
from foundationdb_tpu.flow import set_event_loop
from foundationdb_tpu_torch.conflict import phase_attribution as pa
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector
from foundationdb_tpu_torch.flow.spans import (
    NULL_SPAN,
    SpanHub,
    begin_span,
    global_span_hub,
    instant,
    interval_overlap,
    overlap_efficiency,
    set_global_span_hub,
    span_latency_summary,
    use_span,
)

from test_torch_api import _port_txns, _random_stream
from test_torch_sharded import (
    TIERED_ENV as SHARD_TIERED_ENV,
    make_port,
    make_ref,
    port_txns,
    random_stream,
)

BUCKETS = (32, 128, 64)
D_CAP = 512
TIERED_ENV = {"FDB_TPU_HISTORY": "tiered", "FDB_TPU_DELTA_CAP": str(D_CAP)}


@pytest.fixture(autouse=True)
def _restore_globals():
    """Every test leaves both packages' span hubs, trace collectors and
    flight recorders as it found them; each port test starts on a fresh
    port hub."""
    saved = [(m, m.global_span_hub()) for m in (ref_spans, port_spans)]
    cols = (ref_trace.global_collector(), port_trace.global_collector(),
            port_trace._global_clock)
    recs = (ref_fr.global_flight_recorder(), port_fr.global_flight_recorder())
    port_spans.set_global_span_hub(SpanHub())
    yield
    for m, hub in saved:
        m.set_global_span_hub(hub)
    ref_trace.set_global_collector(cols[0])
    port_trace.set_global_collector(cols[1], clock=cols[2])
    ref_fr.set_global_flight_recorder(recs[0])
    port_fr.set_global_flight_recorder(recs[1])
    set_event_loop(None)


def install_reference_hubs(clock=None):
    """A fresh reference SpanHub, TraceCollector and FlightRecorder,
    installed into both packages' globals; returns them."""
    hub, col, rec = ref_spans.SpanHub(), ref_trace.TraceCollector(), ref_fr.FlightRecorder()
    ref_spans.set_global_span_hub(hub)
    port_spans.set_global_span_hub(hub)
    ref_trace.set_global_collector(col)
    port_trace.set_global_collector(col, clock=clock)
    ref_fr.set_global_flight_recorder(rec)
    port_fr.set_global_flight_recorder(rec)
    return hub, col, rec


def events_less_time(events):
    """Trace events without ``Time`` (wall time when no event loop is set)."""
    return [{k: v for k, v in e.items() if k != "Time"} for e in events]


def capture_less_time(artifact: dict) -> dict:
    """One capture with its recent events' ``Time`` dropped."""
    out = json.loads(ref_fr.artifact_json(artifact))
    out["recent_events"] = events_less_time(out["recent_events"])
    return out


def _drive(cs, stream, depth, port, observe=None):
    """The resolver's discipline (submit, complete the oldest beyond depth
    - 1, drain at the end), calling observe() after every batch and after
    the drain.  Returns each entry's (statuses, witness, degraded)."""
    entries = []
    for txns, now, nov in stream:
        entries.append(cs.pipeline_submit(_port_txns(txns) if port else txns, now, nov))
        while cs.pipeline_inflight > depth - 1:
            cs.pipeline_complete_oldest()
        if observe is not None:
            observe()
    cs.pipeline_drain()
    if observe is not None:
        observe()
    assert all(e.done for e in entries)
    return [(list(e.statuses), list(e.witness), e.degraded) for e in entries]


def _port_set(depth, **kw):
    kw.setdefault("key_words", 3)
    kw.setdefault("h_cap", 1 << 10)
    return ConflictSet(bucket_mins=BUCKETS, device="cpu", pipeline_depth=depth, **kw)


def _sync_detect(cs, stream, port):
    out = []
    for txns, now, nov in stream:
        b = cs.new_batch()
        for t in (_port_txns(txns) if port else txns):
            b.add_transaction(t)
        out.append(b.detect_conflicts(now, nov))
    return out


# ---------------------------------------------------------------------------
# unit: span core, overlap math, the disabled hub
# ---------------------------------------------------------------------------


def test_span_parenting_stack_and_rings():
    """tests/test_spans.py:95."""
    hub = global_span_hub()
    with begin_span("outer", role="R") as outer:
        with begin_span("inner") as inner:
            assert inner.parent_id == outer.span_id
            assert inner.role == "R"  # inherited from the stack parent
        detached = begin_span("held", parent=outer)
    detached.end({"k": 1})
    ring = hub.spans(role="R")
    assert [s.name for s in ring] == ["inner", "outer", "held"]
    assert ring[-1].attrs == {"k": 1}
    stamps = sorted(x for s in ring for x in (s.seq, s.end_seq))
    assert stamps == sorted(set(stamps))
    assert all(s.seq < s.end_seq for s in ring)
    small = SpanHub(per_role=16)
    set_global_span_hub(small)
    for _ in range(50):
        begin_span("x", role="A").end()
    assert len(small.rings["A"]) == 16 and small.begun == 50
    # The same calls on the reference's hub give the same bytes.
    ref_spans.set_global_span_hub(ref_spans.SpanHub())
    port_spans.set_global_span_hub(SpanHub())
    for mod in (ref_spans, port_spans):
        with mod.begin_span("outer", role="R") as outer:
            with mod.begin_span("inner", attrs={"n": 1}):
                mod.instant("mark", role="M", attrs={"seq": 3})
            mod.begin_span("held", parent=outer).end({"k": 1})
    assert port_spans.global_span_hub().spans_json() == ref_spans.global_span_hub().spans_json()


def test_disabled_hub_records_nothing():
    """tests/test_spans.py:118, with SpanHub(enabled=False) for the
    reference's FDB_TPU_SPANS=0: begin_span gives NULL_SPAN, a stream
    through the port's set records nothing, host_phase_seq stays 0 and the
    verdicts are the enabled hub's."""
    set_global_span_hub(SpanHub(enabled=False))
    sp = begin_span("x", role="A")
    assert sp is NULL_SPAN
    with sp:
        with use_span(sp):
            sp.annotate("k", 1).end()
    instant("y", role="B")
    assert global_span_hub().rings == {} and global_span_hub().begun == 0
    stream = _random_stream(3, 60, 8, 8)
    off = _port_set(2)
    got = _drive(off, stream, 2, port=True)
    assert global_span_hub().rings == {} and off.host_phase_seq == 0
    assert off._dev.last_dispatch_span is NULL_SPAN
    set_global_span_hub(SpanHub())
    on = _port_set(2)
    assert _drive(on, stream, 2, port=True) == got
    assert on.host_phase_seq > 0


def test_interval_overlap_math():
    """tests/test_spans.py:128."""
    assert interval_overlap([(0, 2), (2, 4)]) == (4.0, 4.0)
    assert interval_overlap([(0, 2), (0, 2)]) == (4.0, 2.0)
    assert interval_overlap([(3, 7), (0, 4)]) == (8.0, 7.0)
    assert interval_overlap([]) == (0.0, 0.0)


def test_hub_clock_and_seed():
    """The port's hub has no event loop: `clock` stamps start/stop (0.0
    without one), `seed` goes into the header and survives clear()."""
    t = [5.0]
    hub = SpanHub(clock=lambda: t[0], seed=42)
    set_global_span_hub(hub)
    sp = begin_span("a", role="R")
    t[0] = 7.5
    sp.end()
    (d,) = hub.window_dict()["R"]
    assert (d["start"], d["end"]) == (5.0, 7.5)
    assert json.loads(hub.spans_json())["seed"] == 42
    hub.clear()
    assert hub.seed == 42 and hub.begun == 0
    set_global_span_hub(SpanHub())
    begin_span("a", role="R").end()
    d = global_span_hub().window_dict()["R"][0]
    assert (d["start"], d["end"]) == (0.0, 0.0)
    assert json.loads(global_span_hub().spans_json())["seed"] is None
    assert span_latency_summary(global_span_hub())["R"]["a"]["count"] == 1


# ---------------------------------------------------------------------------
# the port's ConflictSet on the port's hub
# ---------------------------------------------------------------------------


def test_pipeline_spans_json_byte_identical_per_seed():
    """tests/test_spans.py:172: same seed, same bytes; another seed,
    other bytes."""

    def run(seed):
        set_global_span_hub(SpanHub())
        _drive(_port_set(2), _random_stream(seed, 60, 10, 8), 2, port=True)
        return global_span_hub().spans_json()

    a, b, c = run(3), run(3), run(5)
    assert a == b and c != a


def test_device_spans_overlap_at_depth2_and_not_at_depth1():
    """tests/test_spans.py:188."""
    stream = _random_stream(3, 60, 10, 8)
    _drive(_port_set(2), stream, 2, port=True)
    dev = global_span_hub().spans(name="device")
    assert len(dev) == 10
    assert overlap_efficiency(dev, axis="seq") > 0.0
    assert overlap_efficiency(dev, axis="wall") > 0.0
    assert all(not d.attrs.keys() - {"version"} for d in dev)
    set_global_span_hub(SpanHub())
    _sync_detect(_port_set(1), stream, port=True)
    dev1 = global_span_hub().spans(name="device")
    assert len(dev1) == 10 and overlap_efficiency(dev1, axis="seq") == 0.0
    # Each depth-1 batch: one encode, dispatch, readback inside its device
    # span, then apply with its mirror_apply; the first also rehydrates.
    names = [s.name for s in global_span_hub().spans(role="span")]
    assert names.count("rehydrate") == 1
    for name in ("encode", "dispatch", "readback", "apply", "mirror_apply"):
        assert names.count(name) == 10, name


def test_flight_recorder_capture_embeds_span_window():
    """tests/test_spans.py:392, on the port's recorder."""
    rec = port_fr.FlightRecorder()
    port_fr.set_global_flight_recorder(rec)
    _drive(_port_set(2), _random_stream(3, 60, 6, 8), 2, port=True)
    art = port_fr.global_flight_recorder().capture("unit", now=1.0)
    spans = [s for role in art["spans"].values() for s in role]
    assert any(s["name"] == "device" for s in spans)
    assert "wall_start" not in json.dumps(art)
    assert art["timeseries"] == {}


def test_phase_attribution_recorded_under_the_dispatch_span():
    """tests/test_spans.py:432: attribute_phases(record=True) leaves one
    phase.<name> span a phase, each a child of the engine's last dispatch
    span, with deterministic attributes; record=False records none and the
    report's deterministic block is the same."""
    cs = _port_set(1)
    stream = _random_stream(3, 60, 3, 8)
    _sync_detect(cs, stream, port=True)
    eng = cs._dev
    rep1 = pa.attribute_phases(eng, _port_txns(stream[-1][0]))
    hub = global_span_hub()
    phase_spans = [s for s in hub.spans() if s.name.startswith("phase.")]
    assert [s.name for s in phase_spans] == [
        "phase.search", "phase.fixpoint", "phase.merge", "phase.evict"]
    assert all(s.parent_id == eng.last_dispatch_span.span_id for s in phase_spans)
    for s, p in zip(phase_spans, rep1["phases"]):
        assert s.attrs == {"ablate": p["ablate"], "launches": p["launches"],
                           "host_checks": p["host_checks"]}
    rep2 = pa.attribute_phases(eng, _port_txns(stream[-1][0]), record=False)
    assert len([s for s in hub.spans() if s.name.startswith("phase.")]) == 4
    assert json.dumps({k: rep1[k] for k in ("full", "phases")}, sort_keys=True) == \
        json.dumps({k: rep2[k] for k in ("full", "phases")}, sort_keys=True)


# ---------------------------------------------------------------------------
# the reference's Resolver over the port's ConflictSet
# ---------------------------------------------------------------------------


def _resolver_run(monkeypatch, seed, depth, port, stream, injector=None):
    """The reference's Resolver rig (tests/test_spans.py:279) over the
    port's or the reference's ConflictSet, on fresh reference hubs
    installed into both packages; returns (resolver, hub, verdicts)."""
    from foundationdb_tpu.flow.eventloop import EventLoop
    from foundationdb_tpu.rpc.network import SimNetwork
    from foundationdb_tpu.server.resolver import Resolver

    from test_torch_serving import _drive_resolver

    monkeypatch.setenv("FDB_TPU_PIPELINE_DEPTH", str(depth))
    loop = EventLoop(seed)
    set_event_loop(loop)
    hub, _col, _rec = install_reference_hubs(clock=loop.now)
    net = SimNetwork(loop)
    if port:
        cs = _port_set(depth, fault_injector=injector)
    else:
        cs = RefConflictSet(backend="jax", key_words=3, bucket_mins=BUCKETS, h_cap=1 << 10,
                            fault_injector=injector)
    r = Resolver(net.process("resolver"), conflict_set=cs)
    verdicts = _drive_resolver(loop, r, net.process("driver"), stream)
    set_event_loop(None)
    return r, hub, verdicts


def test_resolver_stage_tree_overlap_gauge_and_host_fraction(monkeypatch):
    """tests/test_spans.py:316 over the port's ConflictSet: every stage
    span of a batch is a child of its resolve_batch span, the overlap gauge
    is > 0 at depth 2, host_fraction is live, and the Resolver's whole
    span record and gauges equal the reference's over its own set."""
    stream = _random_stream(7, 60, 12, 8)
    r, hub, got = _resolver_run(monkeypatch, 7, 2, True, stream)
    role = r.metrics.name
    names = {s.name for s in hub.spans(role=role)}
    assert {"resolve_batch", "encode", "dispatch", "device", "sync", "apply",
            "mirror_apply", "rehydrate", "reply"} <= names
    batches = {s.span_id: s for s in hub.spans(role=role, name="resolve_batch")}
    for name in ("encode", "dispatch", "device", "sync", "apply", "reply"):
        staged = hub.spans(role=role, name=name)
        assert staged and all(s.parent_id in batches for s in staged), name
    gauges = r.metrics.snapshot()["gauges"]
    assert gauges["pipeline_overlap_efficiency"] > 0.0
    assert 0.0 < gauges["host_fraction"] < 1.0
    devs = hub.spans(role=role, name="device")
    applies = hub.spans(role=role, name="apply")
    assert any(d.attrs["version"] != a.attrs["version"] and d.seq < a.seq < d.end_seq
               for d in devs for a in applies)
    ref_r, ref_hub, want = _resolver_run(monkeypatch, 7, 2, False, stream)
    assert got == want
    assert hub.spans_json() == ref_hub.spans_json()
    assert gauges == ref_r.metrics.snapshot()["gauges"]
    assert r.conflicts.host_phase_seq == ref_r.conflicts.host_phase_seq


def test_overlap_gauge_excludes_faulted_and_replayed_spans(monkeypatch):
    """tests/test_spans.py:360: every dispatch from the second on faults,
    so no device span completes a verified sync and the gauge stays 0;
    the faulted and replayed device spans carry their marks."""
    inj = DeviceFaultInjector()
    for at in range(2, 40):
        inj.script("dispatch", at=at, persist=1)
    r, hub, _v = _resolver_run(monkeypatch, 11, 3, True, _random_stream(11, 60, 10, 8),
                               injector=inj)
    snap = r.metrics.snapshot()
    assert snap["counters"]["degraded_batches"] > 0
    assert snap["gauges"]["pipeline_overlap_efficiency"] == 0.0
    marks = [s.attrs for s in hub.spans(name="device")]
    assert any("replayed" in a or "fault" in a for a in marks)


# ---------------------------------------------------------------------------
# the differential: the port against the reference, span for span
# ---------------------------------------------------------------------------


def _observed_run(monkeypatch, port, depth, stream, *, history="flat", witness=True,
                  plans=(), coalesce=1):
    """One stream through one side, on fresh reference hubs installed into
    both packages; returns (per-batch (spans_json, host_phase_seq),
    verdicts, events less Time, captures less Time)."""
    monkeypatch.setenv("FDB_TPU_PIPELINE_DEPTH", str(depth))
    hub, col, rec = install_reference_hubs()
    inj = DeviceFaultInjector() if port else RefInjector()
    for site, at, persist in plans:
        inj.script(site, at=at, persist=persist)
    if port:
        kw = dict(history="tiered", delta_cap=D_CAP) if history == "tiered" else {}
        cs = _port_set(depth, fault_injector=inj, witness=witness, mirror_coalesce=coalesce,
                       **kw)
    else:
        with monkeypatch.context() as mp:
            if history == "tiered":
                for name, value in TIERED_ENV.items():
                    mp.setenv(name, value)
            if not witness:
                mp.setenv("FDB_TPU_WITNESS", "0")
            mp.setenv("FDB_TPU_MIRROR_COALESCE", str(coalesce))
            cs = RefConflictSet(backend="jax", key_words=3, bucket_mins=BUCKETS,
                                h_cap=1 << 10, fault_injector=inj)
        assert cs._jax.tiered == (history == "tiered")
    per = []
    verdicts = _drive(cs, stream, depth, port,
                      observe=lambda: per.append((hub.spans_json(), cs.host_phase_seq)))
    return (per, verdicts, events_less_time(col.events),
            [capture_less_time(a) for a in rec.captures])


def _assert_runs_equal(got, want):
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert g[1] == w[1], (i, g[1], w[1])
        assert g[0] == w[0], f"batch {i}: spans_json differs"
    assert len(got[0]) == len(want[0])
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]


FAULT = (("dispatch", 4, 4),)  # the breaker opens, probes and closes


@pytest.mark.parametrize("history", ["flat", "tiered"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_spans_equal_the_reference_after_every_batch(monkeypatch, depth, history):
    stream = _random_stream(5, 60, 14, 8)
    want = _observed_run(monkeypatch, False, depth, stream, history=history, plans=FAULT)
    got = _observed_run(monkeypatch, True, depth, stream, history=history, plans=FAULT)
    _assert_runs_equal(got, want)
    walk = [s["name"] for s in json.loads(got[0][-1][0])["spans"]["DeviceBreaker"]]
    assert walk[0] == "breaker.degraded" and walk[-1] == "breaker.ok"
    assert [e["Type"] for e in got[2]].count("DeviceBackendStateChange") == len(walk)
    (cap,) = got[3]
    assert cap["trigger"] == "breaker_open" and cap["spans"]
    assert got[0][-1][1] > 0


@pytest.mark.parametrize("history,depth", [("flat", 2), ("tiered", 1)])
def test_spans_equal_the_reference_with_the_witness_off(monkeypatch, history, depth):
    stream = _random_stream(9, 60, 12, 8)
    want = _observed_run(monkeypatch, False, depth, stream, history=history, witness=False,
                         plans=FAULT)
    got = _observed_run(monkeypatch, True, depth, stream, history=history, witness=False,
                        plans=FAULT)
    _assert_runs_equal(got, want)


def test_spans_equal_the_reference_with_the_coalesced_apply(monkeypatch):
    """mirror_coalesce="auto" at depth 2: the apply spans where the
    reference's fold puts them."""
    stream = _random_stream(13, 60, 12, 8)
    want = _observed_run(monkeypatch, False, 2, stream, plans=FAULT, coalesce="auto")
    got = _observed_run(monkeypatch, True, 2, stream, plans=FAULT, coalesce="auto")
    _assert_runs_equal(got, want)


def _sharded_run(monkeypatch, port, stream, tiered, plans):
    hub, col, rec = install_reference_hubs()
    with monkeypatch.context() as mp:
        if port:
            cs = make_port(2, tiered=tiered)
        else:
            if tiered:
                for name, value in SHARD_TIERED_ENV.items():
                    mp.setenv(name, value)
                mp.setattr(jsr, "_SHARD_MAP_KW", {"check_vma": False})
            cs = make_ref(2, tiered=tiered)
        inj = DeviceFaultInjector() if port else RefInjector()
        for site, at, persist, shard in plans:
            inj.script(site, at=at, persist=persist, shard=shard)
        cs.install_fault_injector(inj)
        per = []
        verdicts = []
        for txns, now, nov in stream:
            verdicts.append(cs.detect(port_txns(txns) if port else txns, now, nov))
            per.append((hub.spans_json(), getattr(cs, "host_phase_seq", 0)))
    return per, verdicts, events_less_time(col.events), [capture_less_time(a) for a in rec.captures]


@pytest.mark.parametrize("tiered", [False, True])
def test_sharded_spans_equal_the_reference(monkeypatch, tiered):
    """2 shards, shard 1's dispatch down three times (its breaker opens)
    and its probe's rehydration faulted once."""
    stream = random_stream(7, 12)
    plans = [("dispatch", 3, 3, 1), ("grow", 1, 1, 1)]
    want = _sharded_run(monkeypatch, False, stream, tiered, plans)
    got = _sharded_run(monkeypatch, True, stream, tiered, plans)
    _assert_runs_equal(got, want)
    spans = json.loads(got[0][-1][0])["spans"]
    names = [s["name"] for s in spans["span"]]
    for name in ("device", "apply", "rehydrate"):
        assert name in names, name
    assert all(s["attrs"].get("domain") == "shard1" for s in spans["DeviceBreaker"])
    assert [c["trigger"] for c in got[3]] == ["breaker_open"]
