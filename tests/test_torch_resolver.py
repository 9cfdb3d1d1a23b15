"""The port's Resolver role, held to the reference's on the CPU.

The reference's ``server/resolver.py`` Resolver (on the reference's event
loop and network) and the port's (on the port's) serve the same request
script from a seed, each over its own port ``ConflictSet(device="cpu")``
(or ``ShardedTorchConflictSet(device="cpu")``) built alike, so no XLA
program is compiled.  The reference reads its knobs and environment; the
port takes the same settings as constructor arguments.  Each run installs
fresh observability hubs of its own package into both packages' globals,
so one span hub sees the role's and the set's spans as in the other run.
Held equal: every reply (verdicts, witnesses, degraded, state mutations,
or its error) and its virtual time, the role's ``metrics.snapshot()``,
``signal_snapshot()`` less the wall-derived ``cpu_mirror_tps``,
``conflict_witness()``, ``_split_key``, the flight recorder's captures,
``spans_json()`` and the exported conflict-set state.

Cases: depths 1-3 with two proxies, reordered pairs, a retry while parked
and state transactions; a scripted dispatch fault mid-pipeline; the idle
flush and the ``pipeline_stall`` capture; a contention spike capture; a
2-shard set under the shard balancer; the raw-set takeover
(``_retry_on_cpu``) after a fault surfaces from the sharded set; witness
off.  Then twins of tests/test_resolver_pipeline.py's section 3 on the
port alone, one case against the reference's Resolver over its own
``ConflictSet(backend="jax")``, and the default conflict set: on the card,
raising where there is none.

Shapes are the reference rig's: key_words=3, h_cap=1<<10,
bucket_mins=(32, 128, 64).
"""

from __future__ import annotations

import json
from dataclasses import asdict

import pytest
import torch

import foundationdb_tpu.flow.eventloop as ref_el
import foundationdb_tpu.flow.flight_recorder as ref_fr
import foundationdb_tpu.flow.spans as ref_spans
import foundationdb_tpu.flow.trace as ref_trace
import foundationdb_tpu.rpc.network as ref_net
import foundationdb_tpu.server.interfaces as ref_if
import foundationdb_tpu.server.resolver as ref_res
from foundationdb_tpu.conflict.device_faults import DeviceUnavailable as RefDeviceUnavailable
from foundationdb_tpu.flow import DeterministicRandom
from foundationdb_tpu.flow.knobs import g_knobs
from foundationdb_tpu_torch.client.types import Mutation, MutationType
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector
from foundationdb_tpu_torch.conflict.device_faults import DeviceUnavailable
from foundationdb_tpu_torch.conflict.engine_cpu import CpuConflictSet
from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as T
from foundationdb_tpu_torch.flow import eventloop as port_el
from foundationdb_tpu_torch.flow import flight_recorder as port_fr
from foundationdb_tpu_torch.flow import spans as port_spans
from foundationdb_tpu_torch.flow import timeseries as port_ts
from foundationdb_tpu_torch.flow import trace as port_trace
from foundationdb_tpu_torch.parallel.sharded_resolver import ShardedTorchConflictSet
from foundationdb_tpu_torch.rpc import network as port_net
from foundationdb_tpu_torch.server import interfaces as port_if
from foundationdb_tpu_torch.server import resolver as port_res

WINDOW = 40

# The reference's knob (or environment variable) behind each of the port
# Resolver's settings.
KNOBS = {
    "max_write_transaction_life_versions": "max_write_transaction_life_versions",
    "pipeline_flush_seconds": "resolver_pipeline_flush_seconds",
    "pipeline_stall_batches": "resolver_pipeline_stall_batches",
    "witness_decay_batches": "resolver_witness_decay_batches",
    "contention_ring": "resolver_contention_ring",
    "contention_spike_ratio": "resolver_contention_spike_ratio",
    "contention_spike_batches": "resolver_contention_spike_batches",
}
ENVS = {
    "witness": ("FDB_TPU_WITNESS", lambda v: "1" if v else "0"),
    "mirror_check_seconds": ("FDB_TPU_MIRROR_CHECK_SECONDS", str),
    "shard_balance_seconds": ("FDB_TPU_SHARD_BALANCE_SECONDS", str),
}


@pytest.fixture(autouse=True)
def _restore_globals():
    saved = (ref_spans.global_span_hub(), ref_trace.global_collector(),
             ref_fr.global_flight_recorder(), port_spans.global_span_hub(),
             port_trace.global_collector(), port_trace._global_clock,
             port_fr.global_flight_recorder(), port_ts.global_timeseries())
    _install_hubs("port")  # what a test's actors record stays in the test
    yield
    ref_el.set_event_loop(None)
    port_el.set_event_loop(None)
    ref_spans.set_global_span_hub(saved[0])
    ref_trace.set_global_collector(saved[1])
    ref_fr.set_global_flight_recorder(saved[2])
    port_spans.set_global_span_hub(saved[3])
    port_trace.set_global_collector(saved[4], clock=saved[5])
    port_fr.set_global_flight_recorder(saved[6])
    port_ts.set_global_timeseries(saved[7])


def k(i: int) -> bytes:
    return b"%06d" % i


def _random_stream(seed, keyspace, batches, txns_per_batch, snap_lag=25):
    """(txns, version) batches from a seeded rng, the reference rig's
    stream (tests/test_resolver_pipeline.py)."""
    rng = DeterministicRandom(seed)
    version = 10
    out = []
    for _ in range(batches):
        txns = []
        for _ in range(rng.random_int(1, txns_per_batch + 1)):
            tr = T(read_snapshot=max(0, version - rng.random_int(0, snap_lag)))
            for _ in range(rng.random_int(0, 4)):
                a = rng.random_int(0, keyspace)
                b = a + 1 + rng.random_int(0, max(1, keyspace // 8))
                tr.read_ranges.append((k(a), k(b)))
            for _ in range(rng.random_int(0, 3)):
                a = rng.random_int(0, keyspace)
                b = a + 1 + rng.random_int(0, max(1, keyspace // 8))
                tr.write_ranges.append((k(a), k(b)))
            txns.append(tr)
        version += rng.random_int(1, 10)
        out.append((txns, version))
    return out


def _port_set(depth, **kw):
    kw.setdefault("key_words", 3)
    kw.setdefault("bucket_mins", (32, 128, 64))
    kw.setdefault("h_cap", 1 << 10)
    return ConflictSet(device="cpu", pipeline_depth=depth, **kw)


def _script(stream, proxies=2, swap_pairs=True, retry_at=None, state_at=(), epoch=0,
            stale_at=None):
    """The request script: (batch index, request fields) in send order.
    Batch j comes from proxy p{j % proxies}; with swap_pairs the later
    batch of each pair is sent first (the prevVersion chain parks it);
    retry_at's request is sent again right after the original; the
    batches of state_at carry one state transaction; stale_at's request
    carries a wrong epoch (answered operation_failed, and sent again with
    the right one)."""
    reqs, prev = [], 0
    for j, (txns, version) in enumerate(stream):
        fields = dict(prev_version=prev, version=version, last_received_version=0,
                      transactions=txns, proxy_id=f"p{j % proxies}", epoch=epoch,
                      state_txns=([(0, [Mutation(MutationType.SET_VALUE, b"\xff/s%d" % j,
                                                 b"v%d" % j)])] if j in state_at else []))
        reqs.append(fields)
        prev = version
    order = list(range(len(reqs)))
    if swap_pairs:
        order = []
        for j in range(0, len(reqs) - 1, 2):
            order += [j + 1, j]
        if len(reqs) % 2:
            order.append(len(reqs) - 1)
    out = []
    for j in order:
        if j == stale_at:
            out.append((("stale", j), dict(reqs[j], epoch=epoch + 1)))
        out.append((j, reqs[j]))
        if j == retry_at:
            out.append((("retry", j), reqs[j]))
    return out


def _install_hubs(pkg):
    """Fresh span hub, trace collector and flight recorder of `pkg`'s
    package, installed into both packages' globals."""
    if pkg == "ref":
        hub, col, rec = ref_spans.SpanHub(), ref_trace.TraceCollector(), ref_fr.FlightRecorder()
    else:
        hub, col, rec = port_spans.SpanHub(), port_trace.TraceCollector(), port_fr.FlightRecorder()
    ref_spans.set_global_span_hub(hub)
    port_spans.set_global_span_hub(hub)
    ref_trace.set_global_collector(col)
    port_trace.set_global_collector(col)
    ref_fr.set_global_flight_recorder(rec)
    port_fr.set_global_flight_recorder(rec)
    port_ts.set_global_timeseries(port_ts.TimeSeriesHub())
    return hub, col, rec


def _serve(pkg, monkeypatch, cs, script, seed=3, cadence=0.002, n_proxies=2, settle=0.0,
           **role_kw):
    """One run of `script` through `pkg`'s Resolver over `cs`; returns the
    run's record (see the module docstring) and the role."""
    hub, _col, rec = _install_hubs(pkg)
    if pkg == "ref":
        el, net, res, itf = ref_el, ref_net, ref_res, ref_if
        for name, value in role_kw.items():
            if name in KNOBS:
                monkeypatch.setattr(g_knobs.server, KNOBS[name], value)
            else:
                env, fmt = ENVS[name]
                monkeypatch.setenv(env, fmt(value))
        kw = {}
    else:
        el, net, res, itf = port_el, port_net, port_res, port_if
        kw = role_kw
    loop = el.EventLoop(seed)
    el.set_event_loop(loop)
    n = net.SimNetwork(loop)
    role = res.Resolver(n.process("resolver"), conflict_set=cs, n_proxies=n_proxies, **kw)
    driver = n.process("driver")
    iface = role.interface()
    futs, vt = [], {}

    async def drive():
        for key, fields in script:
            f = iface.resolve.get_reply(driver, itf.ResolveTransactionBatchRequest(**fields))
            f.add_callback(lambda _f, key=key: vt.setdefault(str(key), loop.now()))
            futs.append((key, f))
            await loop.delay(cadence)
        out = []
        for key, f in futs:
            try:
                r = await f
                out.append((str(key), "reply", list(map(int, r.committed)), list(r.witnesses),
                            r.degraded, r.state_mutations))
            except Exception as e:  # noqa: BLE001 - either package's FdbError
                out.append((str(key), "error", e.name))
        if settle:
            await loop.delay(settle)
        return out

    replies = loop.run_until(driver.spawn(drive(), "drive"), timeout_vt=600.0)
    sig = asdict(role.signal_snapshot())
    sig.pop("cpu_mirror_tps")
    record = dict(
        replies=replies,
        vt=vt,
        snapshot=role.metrics.snapshot_json(),
        signals=sig,
        witness=role.conflict_witness(),
        split=[role._split_key(itf.ResolutionSplitRequest(fraction=f)) for f in (0.25, 0.5)],
        captures=[(c["trigger"], c["time"], c["detail"]) for c in rec.captures],
        spans=hub.spans_json(),
        state=_exported_state(cs),
        queue_depth=role.queue_depth,
        takeover=role._cpu_takeover is not None,
        balancer=(role.shard_balancer.decisions_json()
                  if role.shard_balancer is not None else None),
    )
    el.set_event_loop(None)
    return record, role


def _exported_state(cs):
    out = CpuConflictSet()
    if hasattr(cs, "_cpu"):  # the port's ConflictSet, or the reference's
        mirror = (list(cs._cpu.keys), list(cs._cpu.vers), cs._cpu.oldest_version)
        dev = cs._dev if isinstance(cs, ConflictSet) else cs._jax
        if dev is None:
            return mirror
        dev.store_to(out)
        return mirror, (list(out.keys), list(out.vers), out.oldest_version)
    cs.store_to(out)
    return list(out.keys), list(out.vers), out.oldest_version


def _pair(monkeypatch, make_set, script, **kw):
    """The reference's run and the port's of one script, each over a
    fresh set from make_set(); asserts every record equal."""
    ref, _ = _serve("ref", monkeypatch, make_set(), script, **kw)
    port, role = _serve("port", monkeypatch, make_set(), script, **kw)
    for key in ref:
        assert port[key] == ref[key], key
    return port, role


# ---------------------------------------------------------------------------
# the differential
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 9])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_two_proxies_reordered_with_retry_and_state(monkeypatch, depth, seed):
    stream = _random_stream(seed, 60, 14, 8)
    script = _script(stream, retry_at=3, state_at=(2, 7), stale_at=5)
    rec, role = _pair(monkeypatch, lambda: _port_set(depth), script, seed=seed,
                      max_write_transaction_life_versions=WINDOW)
    snap = json.loads(rec["snapshot"])["counters"]
    assert snap["cache_hits"] == 1 and snap["stale_epoch"] == 1 and snap["batches"] == 14
    replies = {key: r for key, *r in rec["replies"]}
    assert replies["('stale', 5)"] == ["error", "operation_failed"]
    assert replies["('retry', 3)"] == replies["3"]
    assert [v for v, _m in replies["3"][4]] == [stream[2][1]]  # p1 learns p0's state txn
    assert [v for v, _m in replies["8"][4]] == [stream[7][1]]  # p0 learns p1's
    assert rec["queue_depth"] == 0
    if depth > 1:
        assert role.metrics.counter("pipeline_device_stalls").value > 0


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_dispatch_fault_mid_pipeline(monkeypatch, depth):
    stream = _random_stream(7, 60, 16, 8)
    injectors = []

    def make_set():
        inj = DeviceFaultInjector()
        for at in (5, 6):
            inj.script("dispatch", at=at)
        injectors.append(inj)
        return _port_set(depth, fault_injector=inj)

    rec, role = _pair(monkeypatch, make_set, _script(stream), seed=7,
                      max_write_transaction_life_versions=WINDOW)
    ref_inj, port_inj = injectors
    assert port_inj.injected == ref_inj.injected and port_inj.injected
    assert json.loads(rec["snapshot"])["counters"]["degraded_batches"] > 0
    assert role.conflicts.device_metrics()["counters"]["device_faults"] == 2


@pytest.mark.parametrize("depth", [2, 3])
def test_idle_flush_and_stall_capture(monkeypatch, depth):
    """Arrivals 50 ms apart (above the 5 ms flush): every batch parks and
    the idle flush drains it; after pipeline_stall_batches in a row the
    flight recorder captures pipeline_stall, on the loop's cooldown."""
    stream = _random_stream(19, 60, 10, 6)
    rec, _role = _pair(monkeypatch, lambda: _port_set(depth), _script(stream, swap_pairs=False),
                       seed=19, cadence=0.05, pipeline_stall_batches=3,
                       max_write_transaction_life_versions=WINDOW)
    assert [c[0] for c in rec["captures"]] == ["pipeline_stall"]
    assert json.loads(rec["snapshot"])["counters"]["pipeline_host_stalls"] == 10


def _hot_stream(seed, batches, per):
    """Every transaction reads and writes one of 3 keys at a lagging
    snapshot: most of each batch conflicts."""
    rng = DeterministicRandom(seed)
    out, version = [], 10
    for _ in range(batches):
        txns = []
        for _ in range(per):
            a = rng.random_int(0, 3)
            txns.append(T(read_snapshot=version - 5, read_ranges=[(k(a), k(a + 1))],
                          write_ranges=[(k(a), k(a + 1))]))
        version += 6
        out.append((txns, version))
    return out


@pytest.mark.parametrize("depth", [1, 2])
def test_contention_spike_capture(monkeypatch, depth):
    stream = _hot_stream(23, 12, 10)
    rec, _role = _pair(monkeypatch, lambda: _port_set(depth), _script(stream), seed=23,
                       contention_spike_ratio=0.3, contention_spike_batches=2,
                       witness_decay_batches=4, contention_ring=5,
                       max_write_transaction_life_versions=WINDOW)
    kinds = [c[0] for c in rec["captures"]]
    assert "contention_spike" in kinds
    assert json.loads(rec["snapshot"])["counters"]["contention_spikes"] == kinds.count(
        "contention_spike")
    assert len(rec["witness"]["contention"]["timeline"]) == 5


def test_witness_off(monkeypatch):
    stream = _random_stream(5, 60, 10, 8)
    rec, _role = _pair(monkeypatch, lambda: _port_set(2, witness=False), _script(stream),
                       seed=5, witness=False, max_write_transaction_life_versions=WINDOW)
    assert all(r[3] == [] for r in rec["replies"])


def _sharded_set(**kw):
    return ShardedTorchConflictSet([b"\xf0"], key_words=3, h_cap=1 << 10, device="cpu",
                                   bucket_mins=(32, 128, 64), max_shards=4, **kw)


def test_shard_balancer_on_two_shards(monkeypatch):
    """Every key below the split: the balancer's ticks move it, and its
    decision log, the move log and the replies equal the reference's."""
    stream = _random_stream(29, 5000, 24, 10)
    sets = []

    def make_set():
        sets.append(_sharded_set())
        return sets[-1]

    rec, role = _pair(monkeypatch, make_set, _script(stream), seed=29, cadence=0.004,
                      settle=0.05, shard_balance_seconds=0.01,
                      max_write_transaction_life_versions=WINDOW)
    decisions = json.loads(rec["balancer"])
    assert len(decisions) >= 3
    assert any(d["action"] in ("move", "scale") for d in decisions), decisions
    assert sets[1].move_log == sets[0].move_log and sets[1].move_log
    assert role.shard_balancer.moves >= 1


class _BothUnavailable(RefDeviceUnavailable, DeviceUnavailable):
    """A lost device as both packages' resolvers catch it."""


def test_raw_set_takeover_after_a_sharded_fault(monkeypatch):
    """A DeviceFault surfacing from the sharded set's detect at its 4th
    batch: the role re-runs the batch on a host engine built through
    store_to, which serves the rest of the run (degraded)."""
    stream = _random_stream(31, 60, 10, 8)

    def make_set():
        cs = _sharded_set()
        real, calls = cs.detect, [0]

        def faulty(txns, now, nov):
            calls[0] += 1
            if calls[0] == 4:
                raise _BothUnavailable("shard lost its device", site="dispatch")
            return real(txns, now, nov)

        cs.detect = faulty
        return cs

    rec, role = _pair(monkeypatch, make_set, _script(stream), seed=31,
                      max_write_transaction_life_versions=WINDOW)
    assert rec["takeover"] and rec["signals"]["backend_state"] == "degraded"
    degraded = {int(r[0]): r[4] for r in rec["replies"]}
    assert [degraded[j] for j in range(10)] == [False] * 3 + [True] * 7
    assert isinstance(role._cpu_takeover, CpuConflictSet)


# ---------------------------------------------------------------------------
# tests/test_resolver_pipeline.py section 3, on the port alone
# ---------------------------------------------------------------------------


def _port_rig(seed, depth, fault_script=(), **role_kw):
    loop = port_el.EventLoop(seed)
    port_el.set_event_loop(loop)
    n = port_net.SimNetwork(loop)
    inj = DeviceFaultInjector()
    for site, at in fault_script:
        inj.script(site, at=at)
    cs = _port_set(depth, fault_injector=inj)
    role_kw.setdefault("max_write_transaction_life_versions", WINDOW)
    r = port_res.Resolver(n.process("resolver"), conflict_set=cs, **role_kw)
    return loop, r, n.process("driver"), inj


def _drive_resolver(loop, resolver, dproc, stream, cadence=0.002):
    iface = resolver.interface()

    async def drive():
        prev = 0
        futs = []
        for txns, now in stream:
            futs.append(iface.resolve.get_reply(dproc, port_if.ResolveTransactionBatchRequest(
                prev_version=prev, version=now, last_received_version=prev,
                transactions=txns, proxy_id="p0")))
            prev = now
            await loop.delay(cadence)
        return [(await f).committed for f in futs]

    return loop.run_until(dproc.spawn(drive(), "drive"), timeout_vt=600.0)


@pytest.mark.parametrize("seed", [3, 5, 9])
def test_resolver_verdict_stream_identical_across_depths(seed):
    stream = _random_stream(seed, 60, 14, 8)
    results, states = {}, {}
    for depth in (1, 2, 3):
        loop, r, dproc, _ = _port_rig(seed, depth)
        results[depth] = _drive_resolver(loop, r, dproc, stream)
        states[depth] = _exported_state(r.conflicts)
        port_el.set_event_loop(None)
    assert results[2] == results[1] and results[3] == results[1]
    assert states[2] == states[1] and states[3] == states[1]


def test_resolver_pipelined_fault_matches_sync():
    stream = _random_stream(7, 60, 16, 8)
    script = (("dispatch", 5), ("dispatch", 6))

    def run(depth):
        loop, r, dproc, inj = _port_rig(7, depth, fault_script=script)
        verdicts = _drive_resolver(loop, r, dproc, stream)
        dm = r.conflicts.device_metrics()
        port_el.set_event_loop(None)
        return verdicts, dm, inj.injected

    v1, _dm1, log1 = run(1)
    v2, dm2, log2 = run(2)
    assert v2 == v1
    assert log2 == log1 and log1
    v2b, dm2b, _ = run(2)
    assert v2b == v2
    assert json.dumps(dm2b["breaker"]) == json.dumps(dm2["breaker"])


def test_queue_depth_counts_pipelined_parked_batches():
    stream = _random_stream(13, 60, 2, 6)
    loop, r, dproc, _ = _port_rig(13, 3, pipeline_flush_seconds=5.0)
    iface = r.interface()
    seen = {}

    async def drive():
        prev = 0
        futs = []
        for txns, now in stream:
            futs.append(iface.resolve.get_reply(dproc, port_if.ResolveTransactionBatchRequest(
                prev_version=prev, version=now, last_received_version=prev,
                transactions=txns, proxy_id="p0")))
            prev = now
            await loop.delay(0.002)
        await loop.delay(0.05)  # well under the 5 s flush
        seen["parked"] = r.conflicts.pipeline_inflight
        seen["queue_depth"] = r.queue_depth
        seen["signals"] = r.signal_snapshot().queue_depth
        seen["gauge"] = r.metrics.gauge("pipeline_occupancy").value
        seen["replied"] = sum(1 for f in futs if f.is_ready())
        return [await f for f in futs]

    replies = loop.run_until(dproc.spawn(drive(), "drive"), timeout_vt=600.0)
    assert seen == {"parked": 2, "queue_depth": 2, "signals": 2, "gauge": 2, "replied": 0}
    assert len(replies) == 2  # the idle flush drained the tail
    assert r.queue_depth == 0
    snap = r.metrics.snapshot()
    assert snap["counters"]["pipeline_host_stalls"] >= 1
    assert snap["histograms"]["pipeline_inflight_depth"]["max"] == 2


def test_state_txn_retention_survives_parked_gc():
    loop = port_el.EventLoop(21)
    port_el.set_event_loop(loop)
    n = port_net.SimNetwork(loop)
    r = port_res.Resolver(n.process("resolver"), conflict_set=_port_set(2), n_proxies=2,
                          pipeline_flush_seconds=0.05)
    dproc = n.process("driver")
    iface = r.interface()
    wtxn = T(read_snapshot=0, write_ranges=[(k(1), k(2))])
    req = port_if.ResolveTransactionBatchRequest

    async def drive():
        f1 = iface.resolve.get_reply(dproc, req(prev_version=0, version=3, transactions=[wtxn],
                                                proxy_id="pA"))
        f2 = iface.resolve.get_reply(dproc, req(
            prev_version=3, version=5, transactions=[wtxn],
            state_txns=[(0, [Mutation(MutationType.SET_VALUE, b"\xffk", b"v")])],
            proxy_id="pB"))
        f3 = iface.resolve.get_reply(dproc, req(prev_version=5, version=9, transactions=[wtxn],
                                                proxy_id="pA"))
        return await f1, await f2, await f3

    _r1, _r2, r3 = loop.run_until(dproc.spawn(drive(), "drive"), timeout_vt=600.0)
    assert [v for v, _m in r3.state_mutations] == [5], (
        "v9's reply lost v5's state transactions to the parked GC")


def test_duplicate_request_while_parked_waits_for_cache():
    stream = _random_stream(17, 60, 1, 6)
    txns, now = stream[0]
    loop, r, dproc, _ = _port_rig(17, 2, pipeline_flush_seconds=0.05)
    iface = r.interface()

    async def drive():
        req = port_if.ResolveTransactionBatchRequest(
            prev_version=0, version=now, last_received_version=0, transactions=txns,
            proxy_id="p0")
        f1 = iface.resolve.get_reply(dproc, req)
        await loop.delay(0.002)  # the original is parked (flush at 50 ms)
        assert not f1.is_ready()
        f2 = iface.resolve.get_reply(dproc, req)  # the retry
        return (await f1), (await f2)

    r1, r2 = loop.run_until(dproc.spawn(drive(), "drive"), timeout_vt=600.0)
    assert r1.committed == r2.committed
    assert r.metrics.counter("cache_hits").value == 1


def test_sustained_stall_freezes_flight_recorder_artifact():
    port_fr.set_global_flight_recorder(port_fr.FlightRecorder())
    stream = _random_stream(19, 60, 6, 6)
    loop, r, dproc, _ = _port_rig(19, 2, pipeline_stall_batches=3)
    _drive_resolver(loop, r, dproc, stream, cadence=0.05)
    rec = port_fr.global_flight_recorder()
    assert any(c["trigger"] == "pipeline_stall" for c in rec.captures), rec.status_section()
    assert r.metrics.snapshot()["counters"]["pipeline_host_stalls"] >= 3


# ---------------------------------------------------------------------------
# against the reference's own conflict set, and the default set
# ---------------------------------------------------------------------------


def test_replies_equal_the_reference_over_its_jax_set(monkeypatch):
    """The reference's Resolver over ConflictSet(backend="jax"), built as
    its pipelined rig builds it, and the port's over the port's set: the
    same replies, at the same virtual times, and the same exported
    state."""
    from foundationdb_tpu.conflict.api import ConflictSet as RefConflictSet

    monkeypatch.setenv("FDB_TPU_PIPELINE_DEPTH", "2")
    stream = _random_stream(3, 60, 14, 8)
    script = _script(stream, retry_at=1, state_at=(2,))
    jset = RefConflictSet(backend="jax", key_words=3, bucket_mins=(32, 128, 64), h_cap=1 << 10)
    ref, _ = _serve("ref", monkeypatch, jset, script, seed=3,
                    max_write_transaction_life_versions=WINDOW)
    port, _ = _serve("port", monkeypatch, _port_set(2), script, seed=3,
                     max_write_transaction_life_versions=WINDOW)
    for key in ("replies", "vt", "witness", "split", "queue_depth", "state"):
        assert port[key] == ref[key], key
    assert ref["state"][0] == ref["state"][1]  # the device export is the mirror


def test_default_conflict_set_is_on_the_card():
    """Resolver(process) builds ConflictSet(backend="torch") on the GPU:
    without one it raises and nothing runs on the CPU; device="cpu" and
    backend="cpu" are the CPU's by name."""
    loop = port_el.EventLoop(1)
    port_el.set_event_loop(loop)
    n = port_net.SimNetwork(loop)
    if torch.cuda.is_available():
        r = port_res.Resolver(n.process("on_card"))
        assert r.conflicts._dev.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_res.Resolver(n.process("on_card"))
    r = port_res.Resolver(n.process("cpu_named"), device="cpu", witness=False)
    assert r.conflicts._dev.device.type == "cpu" and r.conflicts._witness is False
    assert r._pipeline_on
    host = port_res.Resolver(n.process("host"), backend="cpu")
    assert host.conflicts._dev is None and not host._pipeline_on
    loop.run(max_events=100)  # the roles' actors start and park


def test_the_role_runs_without_loading_jax_or_the_reference():
    """A port Resolver serving two requests on its own loop, in a fresh
    interpreter: no module of jax or of the reference is loaded."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "from foundationdb_tpu_torch import Resolver\n"
        "from foundationdb_tpu_torch.flow import EventLoop, set_event_loop\n"
        "from foundationdb_tpu_torch.rpc import SimNetwork\n"
        "from foundationdb_tpu_torch.server.interfaces import ResolveTransactionBatchRequest as R\n"
        "from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as T\n"
        "loop = EventLoop(3); set_event_loop(loop); net = SimNetwork(loop)\n"
        "role = Resolver(net.process('r'), device='cpu')\n"
        "p = net.process('p'); i = role.interface()\n"
        "f2 = i.resolve.get_reply(p, R(prev_version=5, version=9,\n"
        "                              transactions=[T(4, [(b'a', b'b')], [])]))\n"
        "f1 = i.resolve.get_reply(p, R(prev_version=0, version=5,\n"
        "                              transactions=[T(0, [], [(b'a', b'b')])]))\n"
        "assert loop.run_until(f2).committed == [0] and f1.get().committed == [2]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'foundationdb_tpu')]\n"
        "print(sorted(bad))\n"
    )
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
