"""The port's ConflictSet against the reference package's ConflictSet.

The same seeded streams go through the port's ``ConflictSet(backend=
"torch", device="cpu")`` and the reference's ``ConflictSet(backend="jax")``
(or its CPU-only run): verdicts, witnesses, the mirror's keys / vers /
oldest, the device export, the shared counters, the breaker's transitions
and the injector's log must be equal — at pipeline depths 1, 2 and 3,
under hybrid routing, under scripted and sync-time faults, a planted
fixpoint divergence, a rehydration after a grow fault, mirror_check, the
long-key pin, and which real errors reach the breaker (out of memory) and
which escape (CUDA launch and readback errors, a failed build, a bug).

Shapes follow tests/test_resolver_pipeline.py (key_words=3, bucket_mins=
(32, 128, 64), h_cap=1<<10), so the reference compiles few programs.  All
integers; the tolerance is zero.
"""

import json

import pytest
import torch

from foundationdb_tpu.conflict.api import ConflictSet as RefConflictSet
from foundationdb_tpu.conflict.device_faults import DeviceFaultInjector as RefInjector
from foundationdb_tpu.conflict.engine_cpu import CpuConflictSet as RefCpu
from foundationdb_tpu.conflict.types import TransactionConflictInfo as JT
from foundationdb_tpu.flow import DeterministicRandom, set_event_loop
from foundationdb_tpu.flow.knobs import g_knobs
from foundationdb_tpu_torch.conflict import _build
from foundationdb_tpu_torch.conflict import engine_torch as et
from foundationdb_tpu_torch.conflict import kernels
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.device_faults import (
    DeviceFaultInjector,
    DeviceOOM,
    DeviceUnavailable,
)
from foundationdb_tpu_torch.conflict.engine_cpu_flat import FlatCpuConflictSet
from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as TT

WINDOW = 40
SHARED_COUNTERS = (
    "device_faults", "breaker_opens", "breaker_probes", "breaker_closes",
    "degraded_batches", "rehydrates", "pipeline_dispatches",
    "pipeline_replayed_batches", "cpu_fallback_txns", "rehydrate_keys_total",
    "rehydrate_keys_encoded", "mirror_checks", "mirror_divergence",
)


@pytest.fixture(autouse=True)
def _clean_loop():
    yield
    set_event_loop(None)


def k(i: int) -> bytes:
    return b"%08d" % i


def _random_stream(seed, keyspace, batches, txns_per_batch, snap_lag=25):
    """(txns, now, new_oldest) batches in the reference's types (the
    stream of tests/test_resolver_pipeline.py)."""
    rng = DeterministicRandom(seed)
    version = 10
    out = []
    for _ in range(batches):
        txns = []
        for _ in range(rng.random_int(1, txns_per_batch + 1)):
            tr = JT(read_snapshot=max(0, version - rng.random_int(0, snap_lag)))
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
        out.append((txns, version, max(0, version - WINDOW)))
    return out


def _port_txns(txns):
    return [TT(t.read_snapshot, list(t.read_ranges), list(t.write_ranges)) for t in txns]


def _ref_set(monkeypatch, depth, **kw):
    monkeypatch.setenv("FDB_TPU_PIPELINE_DEPTH", str(depth))
    kw.setdefault("backend", "jax")
    kw.setdefault("key_words", 3)
    return RefConflictSet(bucket_mins=(32, 128, 64), h_cap=kw.pop("h_cap", 1 << 10), **kw)


def _port_set(depth, **kw):
    kw.setdefault("backend", "torch")
    kw.setdefault("h_cap", 1 << 10)
    kw.setdefault("key_words", 3)
    return ConflictSet(bucket_mins=(32, 128, 64), device="cpu",
                       pipeline_depth=depth, **kw)


def _drive(cs, stream, depth, port, drain_every=0):
    """The resolver's discipline: submit, complete the oldest while more
    than depth - 1 are in flight, drain at the end.  Returns the entries'
    (statuses, witness, degraded)."""
    entries = []
    for i, (txns, now, nov) in enumerate(stream):
        entries.append(cs.pipeline_submit(_port_txns(txns) if port else txns, now, nov))
        while cs.pipeline_inflight > depth - 1:
            cs.pipeline_complete_oldest()
        if drain_every and i % drain_every == drain_every - 1:
            cs.pipeline_drain()
    cs.pipeline_drain()
    assert all(e.done for e in entries)
    return [(list(e.statuses), list(e.witness), e.degraded) for e in entries]


def _cpu_only(stream):
    cpu = RefCpu()
    out = []
    for txns, now, nov in stream:
        out.append((cpu.detect(txns, now, nov), list(cpu.last_witness)))
    return out


def _mirror_state(cs):
    return list(cs._cpu.keys), list(cs._cpu.vers), cs._cpu.oldest_version


def _device_export(cs, port):
    out = FlatCpuConflictSet() if port else RefCpu()
    (cs._dev if port else cs._jax).store_to(out)
    return list(out.keys), list(out.vers), out.oldest_version


def _counters(cs):
    c = cs.device_metrics()["counters"]
    return {name: c.get(name, 0) for name in SHARED_COUNTERS}


def _assert_same(port_cs, ref_cs, got, want):
    assert got == want
    assert _mirror_state(port_cs) == _mirror_state(ref_cs)
    assert _device_export(port_cs, True) == _device_export(ref_cs, False)
    assert _counters(port_cs) == _counters(ref_cs)
    pm, rm = port_cs.device_metrics(), ref_cs.device_metrics()
    assert json.dumps(pm["breaker"]) == json.dumps(rm["breaker"])
    assert pm["backend_state"] == rm["backend_state"]
    assert pm["pipeline"] == rm["pipeline"]
    assert pm["h_cap"] == rm["h_cap"]
    assert pm["histograms"] == rm["histograms"]
    assert pm["gauges"] == rm["gauges"]


# ---------------------------------------------------------------------------
# pipeline depths and routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_depths_match_the_reference(monkeypatch, depth):
    stream = _random_stream(5, 60, 16, 8)
    ref = _ref_set(monkeypatch, depth)
    want = _drive(ref, stream, depth, port=False, drain_every=5)
    cs = _port_set(depth)
    got = _drive(cs, stream, depth, port=True, drain_every=5)
    _assert_same(cs, ref, got, want)
    assert [(s, w) for s, w, _d in got] == _cpu_only(stream)
    counters = cs.device_metrics()["counters"]
    assert counters["pipeline_dispatches"] == (len(stream) if depth > 1 else 0)
    assert counters["batches"] == len(stream)
    hist = cs.device_metrics()["histograms"]
    assert sorted(hist) == ["fixpoint_rounds_per_batch", "read_occupancy",
                            "txn_occupancy", "write_occupancy"]
    assert all(h["count"] == len(stream) for h in hist.values())
    assert counters["rehydrates"] == 1
    # mirror_apply and note_synced time every device-served batch.
    wall = cs._dev.metrics.snapshot(include_wall=True)["wall"]
    assert wall["mirror_apply_seconds"]["count"] == len(stream)


@pytest.mark.parametrize("depth", [1, 2])
def test_hybrid_routing_matches_the_reference(monkeypatch, depth):
    """Batch sizes straddle device_min_batch: small ones go to the mirror
    (draining the pipeline first), with the authority hysteresis."""
    old_min = g_knobs.server.conflict_device_min_batch
    g_knobs.server.conflict_device_min_batch = 8
    try:
        stream = _random_stream(23, 60, 30, 8)
        ref = _ref_set(monkeypatch, depth, backend="hybrid")
        want = _drive(ref, stream, depth, port=False)
        cs = _port_set(depth, backend="hybrid", device_min_batch=8)
        got = _drive(cs, stream, depth, port=True)
    finally:
        g_knobs.server.conflict_device_min_batch = old_min
    assert got == want
    assert _mirror_state(cs) == _mirror_state(ref)
    assert _counters(cs) == _counters(ref)
    assert cs._authority == {"jax": "torch", "cpu": "cpu"}[ref._authority]
    assert cs._dev.batches > 0 and cs._dev.batches < len(stream)


def test_sync_detect_path_matches_the_reference(monkeypatch):
    """The synchronous ConflictBatch API (depth 1) and clear()."""
    stream = _random_stream(9, 60, 10, 8)
    ref = _ref_set(monkeypatch, 1)
    cs = _port_set(1)
    for i, (txns, now, nov) in enumerate(stream):
        if i == 6:
            ref.clear(now - 1)
            cs.clear(now - 1)
        rb, pb = ref.new_batch(), cs.new_batch()
        for t, p in zip(txns, _port_txns(txns)):
            rb.add_transaction(t)
            pb.add_transaction(p)
        assert pb.transaction_count == rb.transaction_count
        assert pb.detect_conflicts(now, nov) == rb.detect_conflicts(now, nov)
        assert cs.last_witness == ref.last_witness
        assert cs.consume_degraded() == ref.consume_degraded()
    assert _mirror_state(cs) == _mirror_state(ref)
    assert _device_export(cs, True) == _device_export(ref, False)
    assert cs.oldest_version == ref.oldest_version
    assert cs.backend_signal()["backend_state"] == "ok"


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------


def test_mid_pipeline_dispatch_fault_matches_the_reference(monkeypatch):
    """Dispatch checks 6-9 fault at depth 3 (tests/test_resolver_pipeline.py
    :183-211): two parked batches replay on the mirror, the breaker opens
    and recovers; the injected log and the transitions equal the
    reference's."""
    stream = _random_stream(11, 60, 24, 8)

    def script(inj):
        for at in (6, 7, 8, 9):
            inj.script("dispatch", at=at)
        return inj

    rinj = script(RefInjector())
    ref = _ref_set(monkeypatch, 3, fault_injector=rinj)
    want = _drive(ref, stream, 3, port=False)
    inj = script(DeviceFaultInjector())
    cs = _port_set(3, fault_injector=inj)
    got = _drive(cs, stream, 3, port=True)
    _assert_same(cs, ref, got, want)
    assert inj.injected == rinj.injected and inj.injected
    assert [(s, w) for s, w, _d in got] == _cpu_only(stream)
    counters = cs.device_metrics()["counters"]
    assert counters["pipeline_replayed_batches"] == 2
    assert counters["breaker_opens"] == 1
    assert cs.backend_signal()["backend_state"] == "ok"
    assert any(d for _s, _w, d in got)


@pytest.mark.parametrize("site", ["dispatch", "sync"])
def test_sync_surfacing_faults_open_the_breaker(monkeypatch, site):
    """Three consecutive device faults at the readback (a DeviceUnavailable
    of either site) open the breaker: success is credited at the sync,
    never at dispatch.  Verdicts never change."""
    stream = _random_stream(37, 60, 20, 6)
    cs = _port_set(2)
    real_sync = et.TorchConflictSet.sync_ticket
    calls = {"n": 0}

    def flaky_sync(self, ticket):
        calls["n"] += 1
        if 4 <= calls["n"] <= 6:
            raise DeviceUnavailable("injected sync fault", site=site)
        return real_sync(self, ticket)

    monkeypatch.setattr(et.TorchConflictSet, "sync_ticket", flaky_sync)
    got = _drive(cs, stream, 2, port=True)
    assert [(s, w) for s, w, _d in got] == _cpu_only(stream)
    dm = cs.device_metrics()
    assert dm["counters"]["breaker_opens"] == 1, dm["breaker"]
    assert dm["backend_state"] == "ok", dm["breaker"]
    assert dm["counters"][f"faults_{site}"] == 3
    assert dm["breaker"]["transitions"][0][3] == f"threshold:DeviceUnavailable:{site}"


def test_planted_fixpoint_divergence_replays_the_parked_tail(monkeypatch):
    stream = _random_stream(31, 60, 16, 8)
    cs = _port_set(3)
    real_sync = et.TorchConflictSet.sync_ticket
    fired = {"n": 0}

    def fake_sync(self, ticket):
        statuses, diverged = real_sync(self, ticket)
        if fired["n"] == 0 and len(cs._pipe) >= 2:
            fired["n"] += 1
            return None, True  # a divergence with a parked tail
        return statuses, diverged

    monkeypatch.setattr(et.TorchConflictSet, "sync_ticket", fake_sync)
    got = _drive(cs, stream, 3, port=True)
    assert fired["n"] == 1
    assert [(s, w) for s, w, _d in got] == _cpu_only(stream)
    assert not any(d for _s, _w, d in got)  # a divergence is not degraded
    counters = cs.device_metrics()["counters"]
    assert counters["pipeline_replayed_batches"] >= 2
    assert counters["rehydrates"] >= 2  # the next submit reloaded
    assert counters["device_faults"] == 0
    assert cs.mirror_check()["status"] == "ok"


def test_rehydration_from_a_snapshot_after_a_grow_fault(monkeypatch):
    """Dispatch checks 1-3 fault and open the breaker before the device
    ever grows; the first probe must grow the 64-row history and takes a
    scripted grow fault; the second probe rehydrates from a MirrorSnapshot
    (its chunks already encoded: rehydrate_keys_encoded <
    rehydrate_keys_total), grows, and the device serves again.  Equal to
    the reference."""
    stream = _random_stream(13, 400, 16, 8)

    def script(inj):
        for at in (1, 2, 3):
            inj.script("dispatch", at=at)
        inj.script("grow", at=1)
        return inj

    rinj = script(RefInjector())
    ref = _ref_set(monkeypatch, 2, fault_injector=rinj, h_cap=64)
    want = _drive(ref, stream, 2, port=False)
    inj = script(DeviceFaultInjector())
    cs = _port_set(2, fault_injector=inj, h_cap=64)
    got = _drive(cs, stream, 2, port=True)
    _assert_same(cs, ref, got, want)
    assert inj.injected == rinj.injected
    assert [site for _s, site, _k in inj.injected] == ["dispatch"] * 3 + ["grow"]
    walk = [(f, t) for _s, f, t, _r in cs.device_metrics()["breaker"]["transitions"]]
    assert walk == [("ok", "degraded"), ("degraded", "probing"),
                    ("probing", "degraded"), ("degraded", "probing"),
                    ("probing", "ok")]
    c = cs.device_metrics()["counters"]
    assert c["faults_grow"] == 1 and c["grows"] >= 1
    assert 0 <= c["rehydrate_keys_encoded"] < c["rehydrate_keys_total"]
    assert cs._dev.h_cap > 64
    assert cs.mirror_check()["status"] == "ok"


def test_mirror_check_ok_then_a_planted_divergence_opens_the_breaker(monkeypatch):
    stream = _random_stream(3, 60, 10, 8)
    ref = _ref_set(monkeypatch, 2)
    _drive(ref, stream, 2, port=False)
    cs = _port_set(2)
    _drive(cs, stream, 2, port=True)
    got, want = cs.mirror_check(), ref.mirror_check()
    assert got == want and got["status"] == "ok"
    # Plant a device-side edit: one live boundary's version.
    cs._dev._hvers[1] += 1
    report = cs.mirror_check()
    assert report["status"] == "diverged" and report["mismatch_keys"] == 1
    dm = cs.device_metrics()
    assert dm["backend_state"] == "degraded"
    assert dm["counters"]["mirror_divergence"] == 1
    assert dm["breaker"]["transitions"][-1][3] == "mirror_divergence:mismatch_keys=1"
    assert cs.mirror_check()["status"] == "skipped"
    assert cs.consume_degraded()
    # The mirror stays authoritative: later batches match the CPU-only run.
    more = _random_stream(4, 60, 8, 8)
    more = [(t, n + stream[-1][1], v + stream[-1][1]) for t, n, v in more]
    got = _drive(cs, more, 2, port=True)
    cpu = RefCpu()
    for txns, now, nov in stream:
        cpu.detect(txns, now, nov)
    assert [s for s, _w, _d in got] == [cpu.detect(t, n, v) for t, n, v in more]
    assert cs.device_metrics()["backend_state"] == "ok"
    assert cs.mirror_check()["status"] == "ok"


def test_long_key_pin_and_its_lift_match_the_reference(monkeypatch):
    """A write with a key past the device width.  The reference pins its
    history to the mirror until the window passes the key; the port's
    device serves every batch, with the key's part of history in the
    long-key side table, and decides every batch as the reference does."""
    stream = _random_stream(17, 60, 14, 6)
    long_key = b"L" * 20
    txns, now, nov = stream[2]
    txns.append(JT(read_snapshot=now - 1, write_ranges=[(long_key, long_key + b"\x00")]))
    ref = _ref_set(monkeypatch, 2)
    want = _drive(ref, stream, 2, port=False)
    cs = _port_set(2)
    got = _drive(cs, stream, 2, port=True)
    assert got == want
    assert [(s, w) for s, w, _d in got] == _cpu_only(stream)
    assert 0 < ref._jax.metrics.snapshot()["counters"]["batches"] < len(stream)  # its pin
    assert cs._dev.batches == len(stream)
    assert _mirror_state(cs) == _device_export(cs, True)
    counters = cs.device_metrics()["counters"]
    assert counters["long_key_batches"] == 1
    assert "long_key_host_batches" not in counters
    assert cs._long._live == []  # the window passed the key


def test_device_key_cap_matches_the_reference_at_five_key_words(monkeypatch):
    """At key_words=5 the device takes keys of at most 16 bytes (the
    reference's conflict_max_device_key_bytes default), not 20.  The
    reference serves a batch with a 20-byte read key from its mirror and
    pins history on a 20-byte write; the port's device serves both, with
    the 20-byte keys rounded to their 16-byte regions, and every verdict
    and witness is the reference's."""
    stream = _random_stream(17, 60, 30, 6)
    txns, now, _nov = stream[2]
    txns.append(JT(read_snapshot=now - 1, read_ranges=[(b"R" * 20, b"S" * 20)]))
    txns, now, _nov = stream[5]
    txns.append(JT(read_snapshot=now - 1, write_ranges=[(b"W" * 20, b"X" * 20)]))
    ref = _ref_set(monkeypatch, 2, key_words=5)
    cs = _port_set(2, key_words=5)

    def walk(cs, dev, port):
        seen, keys = [], []
        for txns, now, nov in stream:
            e = cs.pipeline_submit(_port_txns(txns) if port else txns, now, nov)
            cs.pipeline_drain()
            c = dev.metrics.snapshot()["counters"]
            seen.append((list(e.statuses), list(e.witness), c["batches"]))
            keys.append(_device_export(cs, port)[0])
        return seen, keys

    want, _ = walk(ref, ref._jax, port=False)
    got, dev_keys = walk(cs, cs._dev, port=True)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert want[2][2] == want[1][2]  # the reference's mirror took the read
    assert [g[2] for g in got] == list(range(1, len(stream) + 1))
    assert all(len(key) <= 16 for keys in dev_keys for key in keys)
    assert b"X" * 16 in dev_keys[5] and b"W" * 20 not in dev_keys[5]
    assert _mirror_state(cs) == _device_export(cs, True)


def _long_key_stream(seed, batches, width):
    """Batches whose keys crowd a few regions of the device width: keys
    shorter than, equal to and longer than `width` under shared prefixes,
    the region at the end of the key space (all 0xff) among them, and
    ranges that start, end or lie in a region or cross several."""
    rng = DeterministicRandom(seed)
    heads = [b"ab" * (width // 2), b"ac" * (width // 2), b"\xff" * width]
    tails = [b"", b"\x00", b"a", b"b", b"\xff", b"a\x00", b"ab", b"\xff\xff\x00"]

    def key():
        head = heads[rng.random_int(0, len(heads))]
        cut = rng.random_int(0, 4)
        if cut == 0:
            return head[: rng.random_int(1, width)]
        return head + tails[rng.random_int(0, len(tails))]

    def rng_range():
        a, b = sorted((key(), key()))
        return a, b

    version = 10
    out = []
    for _ in range(batches):
        txns = []
        for _ in range(rng.random_int(1, 9)):
            tr = JT(read_snapshot=max(0, version - rng.random_int(0, 25)))
            tr.read_ranges = [rng_range() for _ in range(rng.random_int(0, 3))]
            tr.write_ranges = [rng_range() for _ in range(rng.random_int(0, 3))]
            txns.append(tr)
        version += rng.random_int(1, 10)
        out.append((txns, version, max(0, version - WINDOW)))
    # A last batch without long keys, which the device always takes.
    out.append(([JT(read_snapshot=version, read_ranges=[(b"a", b"b")])] * 8,
                version + 1, max(0, version + 1 - WINDOW)))
    return out


@pytest.mark.parametrize("depth,backend", [(1, "torch"), (2, "torch"), (3, "torch"),
                                           (2, "hybrid")])
def test_long_key_side_table_matches_the_reference_engine(depth, backend):
    """Long keys everywhere: every verdict and witness is the reference
    engine's; the mirror holds the device's history; the device serves
    every batch but those whose long keys couple it to the side table."""
    stream = _long_key_stream(31 + depth, 80, 12)
    cs = _port_set(depth, backend=backend, device_min_batch=4)
    got = _drive(cs, stream, depth, port=True, drain_every=7)
    assert [(s, w) for s, w, _d in got] == _cpu_only(stream)
    assert _mirror_state(cs) == _device_export(cs, True)
    c = cs.device_metrics()["counters"]
    host = c.get("long_key_host_batches", 0)
    assert c["long_key_batches"] > host > 0
    if backend == "torch":
        assert c["batches"] == len(stream) - host


def _big_batch(base, ranges=40):
    """tests/test_perf_smoke.py's side-heavy one-transaction batch."""
    t = TT(read_snapshot=0)
    for j in range(ranges):
        t.read_ranges.append((k(base + 4 * j), k(base + 4 * j + 1)))
        t.write_ranges.append((k(base + 4 * j + 2), k(base + 4 * j + 3)))
    return [t]


def test_pipelined_batch_host_sync_and_alloc_budget():
    """tests/test_perf_smoke.py's host budget, on the port: a healthy batch
    at depth 2 costs at most 3 blocking reads (its one readback, the
    fixpoint's check, an occasional bound refresh), and once the staging
    ring is populated the batches allocate no host buffer."""
    cs = _port_set(2)
    eng = cs._dev

    def drive(i0, n):
        v = 5 * i0
        for i in range(i0, i0 + n):
            v += 5
            e = cs.pipeline_submit(_big_batch(10_000 * i), v, 0)
            while cs.pipeline_inflight > 1:
                cs.pipeline_complete_oldest()
            assert e is not None
        cs.pipeline_drain()

    drive(0, 2)  # populates the staging ring
    syncs0, allocs0 = eng.host_syncs, eng.host_allocs
    batches = 8
    drive(2, batches)
    syncs = eng.host_syncs - syncs0
    assert syncs <= 3 * batches, f"{syncs} host syncs over {batches} batches"
    assert eng.host_allocs - allocs0 == 0
    assert allocs0 == 3  # the ring: depth + 1 buffers of the one blob length
    assert syncs >= 2 * batches  # one readback and one fixpoint check each


# ---------------------------------------------------------------------------
# real device errors: which reach the breaker, which escape
# ---------------------------------------------------------------------------


def test_out_of_memory_in_grow_is_device_oom(monkeypatch):
    cs = _port_set(1)
    dev = cs._dev
    h_cap = dev.h_cap

    def oom(*args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(torch, "cat", oom)
    with pytest.raises(DeviceOOM) as e:
        dev._grow(2 * h_cap)
    assert e.value.site == "grow"
    assert dev.h_cap == h_cap


def _detect_stream(cs, stream):
    out = []
    for txns, now, nov in stream:
        b = cs.new_batch()
        for t in _port_txns(txns):
            b.add_transaction(t)
        out.append(b.detect_conflicts(now, nov))
    return out


def test_out_of_memory_at_dispatch_reaches_the_breaker(monkeypatch):
    """An out-of-memory error inside the step is a DeviceOOM at site
    "dispatch": the mirror serves those batches with identical verdicts."""
    stream = _random_stream(21, 60, 8, 6)
    cs = _port_set(1)
    real = et.phase1_search
    calls = {"n": 0}

    def failing(*args):
        calls["n"] += 1
        if calls["n"] in (2, 3):
            raise torch.OutOfMemoryError("CUDA out of memory")
        return real(*args)

    monkeypatch.setattr(et, "phase1_search", failing)
    assert _detect_stream(cs, stream) == [s for s, _w in _cpu_only(stream)]
    c = cs.device_metrics()["counters"]
    assert c["faults_dispatch"] == 2 and c["device_faults"] == 2
    assert c["breaker_opens"] == 0 and c["rehydrates"] == 3
    assert cs.device_metrics()["breaker"]["transitions"] == []


@pytest.mark.parametrize(
    "failure", ["python_error", "build_failure", "launch_error", "readback_error"])
def test_other_errors_escape_the_conflict_set(monkeypatch, failure):
    """A plain RuntimeError (a bug), a failed kernel build, a kernel launch
    error and a CUDA error at a pipelined readback are not device faults
    the breaker may absorb: each propagates, and the breaker never sees
    it, so no kernel fault is ever served quietly from the mirror."""
    stream = _random_stream(21, 60, 3, 6)
    cs = _port_set(2)
    message = {
        "python_error": "a bug in the step",
        "build_failure": "nvcc not found",
        "launch_error": "phase1_ranks: CUDA error 209 at launch",
        "readback_error": "CUDA error: an illegal memory access",
    }[failure]

    def nvcc_missing():
        raise RuntimeError("nvcc not found (looked on PATH and /usr/local/cuda/bin)")

    def failing(*args):
        if failure == "python_error":
            raise RuntimeError(message)
        if failure == "launch_error":
            kernels._raise_on(209, "phase1_ranks")  # no kernel image for the card
        monkeypatch.setattr(_build, "nvcc", nvcc_missing)
        monkeypatch.setattr(_build, "_lib_path", lambda name: _build.BUILD_DIR / "absent.so")
        _build.load("phase1_search")

    def failing_sync(self, ticket):
        raise torch.AcceleratorError(message)

    if failure == "readback_error":
        monkeypatch.setattr(et.TorchConflictSet, "sync_ticket", failing_sync)
    else:
        monkeypatch.setattr(et, "phase1_search", failing)
    with pytest.raises(RuntimeError, match=message) as e:
        _drive(cs, stream, 2, port=True)
    assert not isinstance(e.value, (DeviceOOM, DeviceUnavailable))
    assert cs.device_metrics()["counters"]["device_faults"] == 0
    assert cs.device_metrics()["backend_state"] == "ok"


def test_cpu_backend_and_arguments(monkeypatch):
    stream = _random_stream(7, 60, 6, 6)
    cs = ConflictSet(backend="cpu", key_words=3)
    assert cs.device_metrics() is None and cs.mirror_check() is None
    assert cs._jax is None
    got = _drive(cs, stream, 2, port=True)
    assert [(s, w) for s, w, _d in got] == _cpu_only(stream)
    quiet = _port_set(1, witness=False)
    assert all(w == [] for _s, w, _d in _drive(quiet, stream, 1, port=True))
    with pytest.raises(ValueError):
        ConflictSet(backend="jax")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ConflictSet()
    assert ConflictSet(backend="cpu").backend == "cpu"
