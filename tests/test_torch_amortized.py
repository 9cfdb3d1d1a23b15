"""Amortized flat eviction (``evict_every`` > 1) against the reference.

The reference's amortized eviction is its ``FDB_TPU_EVICT_EVERY`` flag in
flat mode; the port's is the ``evict_every`` argument.  On the stream of
tests/test_engine_experiments.py (key_words=2, bucket_mins=(64, 128,
128)), from a history small enough that the must-fit guard grows it:

- the engine: ``TorchConflictSet(evict_every=3)`` against
  ``JaxConflictSet`` under ``FDB_TPU_EVICT_EVERY=3``, batch by batch —
  verdicts, witnesses, exported state, h_cap, grows, retraces, batches,
  and the host syncs: past the port's fixpoint checks and its one
  readback (the reference reads the witness in a second one) they are
  bound refreshes, made where the reference makes them or, the port's
  bound being tightened at each readback, less often — and both equal to
  the CPU engine;
- the set: ``ConflictSet(evict_every=3)`` against the reference's
  ``ConflictSet(backend="jax")`` under the flag: verdicts and witnesses;
  then ``mirror_check``: the port reads "ok" with keys differing only
  below the window (``below_window_keys`` > 0), where the reference's
  exact diff reports the same history "diverged" (Queue 3's F4, flat);
- a scripted dispatch fault on an evicting batch: the breaker's walk, the
  injector's log, the rehydration and the counters equal the reference's.

All on the CPU; the tolerance is zero (integers only).
"""

import numpy as np
import pytest

from foundationdb_tpu.conflict.api import ConflictSet as RefConflictSet
from foundationdb_tpu.conflict.device_faults import DeviceFaultInjector as RefInjector
from foundationdb_tpu.conflict.engine_cpu import CpuConflictSet
from foundationdb_tpu.conflict.engine_jax import JaxConflictSet
from foundationdb_tpu.conflict.types import TransactionConflictInfo as JT
from foundationdb_tpu.flow import set_event_loop
from foundationdb_tpu_torch.conflict import engine_torch as et
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector
from foundationdb_tpu_torch.conflict.engine_torch import TorchConflictSet
from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as TT

EVERY = 3
KEY_WORDS = 2
BUCKETS = (64, 128, 128)
H_CAP = 384  # the stream outgrows it mid-way: the must-fit guard syncs and grows
SHARED_COUNTERS = (
    "device_faults", "breaker_opens", "breaker_probes", "breaker_closes",
    "degraded_batches", "rehydrates", "pipeline_dispatches",
    "pipeline_replayed_batches", "cpu_fallback_txns", "rehydrate_keys_total",
    "rehydrate_keys_encoded", "grows", "retraces", "batches",
)


@pytest.fixture(autouse=True)
def _clean_loop():
    yield
    set_event_loop(None)


def _stream(batches=10):
    """tests/test_engine_experiments.py's stream, draw for draw."""
    rng = np.random.default_rng(17)

    def txn(now):
        def rr():
            a = int(rng.integers(0, 3000))
            b = a + 1 + int(rng.integers(0, 25))
            return (a.to_bytes(4, "big"), b.to_bytes(4, "big"))
        return JT(
            read_snapshot=now - int(rng.integers(0, 40)),
            read_ranges=[rr() for _ in range(int(rng.integers(0, 3)))],
            write_ranges=[rr() for _ in range(int(rng.integers(0, 3)))],
        )

    now, out = 100, []
    for _ in range(batches):
        txns = [txn(now) for _ in range(int(rng.integers(5, 40)))]
        now += int(rng.integers(1, 25))
        out.append((txns, now, max(0, now - 90)))
    return out


def _port_txns(txns):
    return [TT(t.read_snapshot, list(t.read_ranges), list(t.write_ranges)) for t in txns]


def _checks(iters):
    """The port's fixpoint host checks for a batch of `iters` iterations."""
    rounds = iters - 2
    first = et.FIXPOINT_FIRST_CHUNK
    return 1 + max(0, -(-(rounds - first) // et.FIXPOINT_CHUNK))


def test_engine_matches_reference_and_cpu(monkeypatch):
    monkeypatch.setenv("FDB_TPU_EVICT_EVERY", str(EVERY))
    jcs = JaxConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, bucket_mins=BUCKETS)
    assert jcs.evict_every == EVERY
    tcs = TorchConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, bucket_mins=BUCKETS,
                           device="cpu", evict_every=EVERY)
    cpu = CpuConflictSet()
    evicted_rows = 0
    for i, (txns, now, nov) in enumerate(_stream()):
        j0 = jcs.metrics.snapshot()["counters"]["host_syncs"]
        t0 = tcs.host_syncs
        want = jcs.detect(txns, now, nov)
        got = tcs.detect(_port_txns(txns), now, nov)
        assert got == want == cpu.detect(txns, now, nov), i
        assert tcs.last_witness == jcs.last_witness == cpu.last_witness, i
        jc = jcs.metrics.snapshot()["counters"]
        # Syncs past the readback (and the reference's witness readback)
        # are bound refreshes; the port's bound tightens at each readback,
        # so it refreshes where the reference does or less often.
        port_refreshes = (tcs.host_syncs - t0) - _checks(tcs.last_iters) - 1
        ref_refreshes = (jc["host_syncs"] - j0) - 2
        assert 0 <= port_refreshes <= ref_refreshes, i
        assert tcs._batches_since_evict == jcs._batches_since_evict, i
        hk, hv, n, oldest, base = tcs.export_state()
        assert (hk == np.asarray(jcs._hkeys)).all() and (hv == np.asarray(jcs._hvers)).all(), i
        assert (n, oldest, base) == (int(jcs._hcount), int(jcs._oldest), jcs._base), i
        assert tcs.h_cap == jcs.h_cap, i
        for name in ("grows", "retraces", "batches"):
            assert tcs.metrics.counter(name).value == jc[name], (i, name)
        # Between evictions the device keeps rows the CPU engine dropped.
        evicted_rows = max(evicted_rows, n - len(cpu.keys))
    assert tcs.grows >= 1 and tcs.h_cap > H_CAP
    assert evicted_rows > 0
    assert tcs.metrics.counter("retraces").value == len(tcs._bucket_dispatches)
    assert all(key[-1] is True for key in tcs._bucket_dispatches)  # amortized in the key


def test_amortized_is_flat_only_cadence():
    """Flat evict_every sets the eviction cadence and no compaction; the
    default engine's blob flag is 1 on every batch."""
    flat = TorchConflictSet(device="cpu", key_words=KEY_WORDS, h_cap=H_CAP, evict_every=4)
    assert flat.evict_every == 4 and flat.compact_every == 0 and not flat.tiered
    flags = []
    real = et.fill_blob

    def spy(blob, pb, base, now, nov, flag):
        flags.append(flag)
        return real(blob, pb, base, now, nov, flag)

    et.fill_blob = spy
    try:
        for txns, now, nov in _stream(9):
            flat.detect(_port_txns(txns), now, nov)
        default = TorchConflictSet(device="cpu", key_words=KEY_WORDS, h_cap=H_CAP)
        for txns, now, nov in _stream(3):
            default.detect(_port_txns(txns), now, nov)
    finally:
        et.fill_blob = real
    assert flags == [0, 0, 0, 1, 0, 0, 0, 1, 0] + [1, 1, 1]


def _set_pair(monkeypatch, **kw):
    monkeypatch.setenv("FDB_TPU_EVICT_EVERY", str(EVERY))
    monkeypatch.setenv("FDB_TPU_PIPELINE_DEPTH", "1")
    ref_inj = kw.pop("ref_injector", None)
    ref = RefConflictSet(backend="jax", key_words=KEY_WORDS, h_cap=H_CAP,
                         bucket_mins=BUCKETS, fault_injector=ref_inj)
    port = ConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, bucket_mins=BUCKETS, device="cpu",
                       pipeline_depth=1, evict_every=EVERY, **kw)
    return ref, port


def _serve(cs, stream, port):
    out = []
    for txns, now, nov in stream:
        b = cs.new_batch()
        for t in (_port_txns(txns) if port else txns):
            b.add_transaction(t)
        out.append((b.detect_conflicts(now, nov), list(cs.last_witness)))
    return out


def _counters(cs):
    c = cs.device_metrics()["counters"]
    return {name: c.get(name, 0) for name in SHARED_COUNTERS}


def test_conflict_set_matches_reference_and_mirror_check(monkeypatch):
    stream = _stream()
    ref, port = _set_pair(monkeypatch)
    assert _serve(port, stream, True) == _serve(ref, stream, False)
    assert _counters(port) == _counters(ref)
    # Batch 10 of a 3-batch cadence did not evict: the device holds rows
    # below the window that the mirror dropped.
    assert port._dev._batches_since_evict == len(stream) % EVERY == 1
    got = port.mirror_check()
    assert got["status"] == "ok" and got["mismatch_keys"] == 0
    assert got["below_window_keys"] > 0
    # The reference's exact diff calls the same history a divergence.
    want = ref.mirror_check()
    assert want["status"] == "diverged"
    assert want["mismatch_keys"] == got["below_window_keys"]
    assert port.device_metrics()["backend_state"] == "ok"


def test_dispatch_fault_on_an_evicting_batch_matches_reference(monkeypatch):
    """Dispatches 3-5 fault: the 3rd dispatch is the first evicting batch.
    The breaker opens, probes, rehydrates from the mirror, and the eviction
    cadence goes on where it stood, as in the reference."""
    stream = _stream()
    inj, rinj = DeviceFaultInjector(), RefInjector()
    for at in (3, 4, 5):
        inj.script("dispatch", at=at)
        rinj.script("dispatch", at=at)
    ref, port = _set_pair(monkeypatch, ref_injector=rinj, fault_injector=inj)
    assert _serve(port, stream, True) == _serve(ref, stream, False)
    assert inj.injected == rinj.injected and len(inj.injected) == 3
    pm, rm = port.device_metrics(), ref.device_metrics()
    assert pm["breaker"]["transitions"] == rm["breaker"]["transitions"]
    assert [tuple(t[1:3]) for t in pm["breaker"]["transitions"]] == [
        ("ok", "degraded"), ("degraded", "probing"), ("probing", "ok")]
    assert _counters(port) == _counters(ref)
    assert pm["counters"]["rehydrates"] >= 1
    assert port._dev._batches_since_evict == ref._jax._batches_since_evict
    assert port.mirror_check()["status"] == "ok"
