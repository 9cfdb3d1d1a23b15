"""The port's tiered history against the reference package's.

Twins of tests/test_tiered_history.py: the reference runs with
FDB_TPU_HISTORY=tiered, FDB_TPU_DELTA_CAP and FDB_TPU_EVICT_EVERY in its
environment; the port takes the same values as the constructor arguments
history="tiered", delta_cap and evict_every, on the CPU (the kernels' plain
twins).  After every batch each case compares, bit for bit: the raw tiers
(base keys, versions and count; delta keys, versions and count; the carried
max table), the window floor and base, the host's row-count bounds and
compaction cadence, iters, verdicts and witnesses — and the CPU engine and
the oracle agree on the verdicts.

Shapes are the reference module's: key_words=3, h_cap=1<<10, d_cap=512,
bucket_mins=(32, 128, 64).  Everything compared is an integer, or a float
computed by the same operations in the same order; the tolerance is zero.
"""

import json

import numpy as np
import pytest

from foundationdb_tpu.conflict import engine_jax as ej
from foundationdb_tpu.conflict.api import ConflictSet as RefConflictSet
from foundationdb_tpu.conflict.device_faults import DeviceFaultInjector as RefInjector
from foundationdb_tpu.conflict.engine_cpu import CpuConflictSet
from foundationdb_tpu.conflict.engine_jax import REBASE_THRESHOLD, JaxConflictSet
from foundationdb_tpu.conflict.oracle import OracleConflictSet
from foundationdb_tpu.conflict.types import TransactionConflictInfo as JT
from foundationdb_tpu.flow import DeterministicRandom, set_event_loop
from foundationdb_tpu_torch.conflict import engine_torch as et
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector
from foundationdb_tpu_torch.conflict.engine_cpu_flat import FlatCpuConflictSet
from foundationdb_tpu_torch.conflict.engine_torch import TorchConflictSet
from foundationdb_tpu_torch.conflict.keys import from_device_words
from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as TT

D_CAP = 512
BUCKETS = (32, 128, 64)


@pytest.fixture(autouse=True)
def _tiered_env(monkeypatch):
    monkeypatch.setenv("FDB_TPU_HISTORY", "tiered")
    monkeypatch.setenv("FDB_TPU_DELTA_CAP", str(D_CAP))
    yield
    set_event_loop(None)


def k(i: int) -> bytes:
    return b"%08d" % i


def _random_stream(seed, keyspace, batches, txns_per_batch, snap_lag=25):
    """tests/test_tiered_history.py's stream, in the reference's types."""
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
                b = a + 1 + rng.random_int(0, max(1, keyspace // 10))
                tr.write_ranges.append((k(a), k(b)))
            txns.append(tr)
        now = version + rng.random_int(1, 10)
        out.append((txns, now, max(0, version - snap_lag)))
        version = now
    return out


def _port_txns(txns):
    return [TT(t.read_snapshot, list(t.read_ranges), list(t.write_ranges)) for t in txns]


def _pair(monkeypatch, evict_every=1, delta_cap=D_CAP, **kw):
    """A reference JaxConflictSet and a port TorchConflictSet with the same
    tiered settings."""
    kw.setdefault("key_words", 3)
    kw.setdefault("h_cap", 1 << 10)
    kw.setdefault("bucket_mins", BUCKETS)
    monkeypatch.setenv("FDB_TPU_EVICT_EVERY", str(evict_every))
    monkeypatch.setenv("FDB_TPU_DELTA_CAP", str(delta_cap))
    jcs = JaxConflictSet(**kw)
    tcs = TorchConflictSet(device="cpu", history="tiered", delta_cap=delta_cap,
                           evict_every=evict_every, **kw)
    assert jcs.tiered and tcs.tiered and jcs.d_cap == tcs.d_cap
    assert jcs.compact_every == tcs.compact_every
    return jcs, tcs


def _ref_tiers(j):
    return dict(
        hkeys=np.asarray(j._hkeys), hvers=np.asarray(j._hvers), hcount=int(j._hcount),
        maxtab=np.asarray(j._maxtab), dkeys=np.asarray(j._dkeys),
        dvers=np.asarray(j._dvers), dcount=int(j._dcount), oldest=int(j._oldest),
        base=j._base, hcount_bound=j._hcount_bound, dcount_bound=j._dcount_bound,
        since_major=j._batches_since_major, h_cap=j.h_cap, d_cap=j.d_cap,
    )


def _port_tiers(t):
    return dict(
        hkeys=from_device_words(t._hkeys.numpy()), hvers=t._hvers.numpy(),
        hcount=int(t._hcount), maxtab=t._maxtab.numpy(),
        dkeys=from_device_words(t._dkeys.numpy()), dvers=t._dvers.numpy(),
        dcount=int(t._dcount), oldest=int(t._oldest), base=t._base,
        hcount_bound=t._hcount_bound, dcount_bound=t._dcount_bound,
        since_major=t._batches_since_major, h_cap=t.h_cap, d_cap=t.d_cap,
    )


def _assert_same_tiers(jcs, tcs, where=""):
    want, got = _ref_tiers(jcs), _port_tiers(tcs)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, np.ndarray):
            assert g.shape == w.shape and (g == w).all(), (name, where)
        else:
            assert g == w, (name, where, g, w)


SHARED_ENGINE_COUNTERS = (
    "batches", "transactions", "fixpoint_rounds", "grows", "rebases",
    "cpu_fallbacks", "retraces", "major_compactions", "rehydrate_keys_total",
    "rehydrate_keys_encoded",
)


def _assert_same_metrics(j_snap, t_snap):
    for name in SHARED_ENGINE_COUNTERS:
        assert t_snap["counters"][name] == j_snap["counters"][name], name
    assert t_snap["gauges"] == j_snap["gauges"]
    assert t_snap["histograms"] == j_snap["histograms"]


def _step_both(jcs, tcs, txns, now, nov, where=""):
    want = jcs.detect(txns, now, nov)
    got = tcs.detect(_port_txns(txns), now, nov)
    assert got == want, where
    assert tcs.last_witness == jcs.last_witness, where
    assert tcs.last_iters == jcs.last_iters, where
    _assert_same_tiers(jcs, tcs, where)
    return want


def _majors(cs) -> int:
    return cs.metrics.snapshot()["counters"]["major_compactions"]


# ---------------------------------------------------------------------------
# the engine: TorchConflictSet(history="tiered") against JaxConflictSet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,cadence", [(11, 2), (23, 3), (29, 4)],
                         ids=["cadence2", "cadence3", "cadence4"])
def test_tiered_differential_vs_reference_cpu_and_oracle(monkeypatch, seed, cadence):
    """The headline gate: the port's tiered engine equals the reference's
    batch by batch (raw tiers included) and both equal the CPU engine and
    the oracle, with major compactions from the cadence (the fill trigger
    is test_delta_exactly_full_triggers_compaction's)."""
    jcs, tcs = _pair(monkeypatch, evict_every=cadence)
    cpu, orc = CpuConflictSet(), OracleConflictSet()
    for bi, (txns, now, nov) in enumerate(
        _random_stream(seed, 40, batches=30, txns_per_batch=16)
    ):
        want = _step_both(jcs, tcs, txns, now, nov, f"batch {bi}")
        assert cpu.detect(txns, now, nov) == want == orc.detect(txns, now, nov)
        assert int(tcs._dcount) <= tcs.d_cap
    assert _majors(tcs) == _majors(jcs) >= 1
    _assert_same_metrics(jcs.metrics.snapshot(), tcs.metrics.snapshot())
    assert tcs.boundary_count == jcs.boundary_count == cpu.boundary_count
    assert tcs.boundary_count_bound == jcs.boundary_count_bound


@pytest.mark.parametrize("seed", [11, 47])
def test_tiered_engine_matches_reference_with_pallas_kernels(monkeypatch, seed):
    """tests/test_kernels.py's tiered kernel differential, against the
    port: the reference's tiered engine running both Pallas kernels in
    interpret mode (the two-tier search and the major compaction's merge
    included), batch by batch, raw tiers included."""
    monkeypatch.setenv("FDB_TPU_KERNELS", "1")
    jcs, tcs = _pair(monkeypatch, evict_every=3)
    assert jcs._use_kernels
    cpu = CpuConflictSet()
    for bi, (txns, now, nov) in enumerate(
        _random_stream(seed, 50, batches=12, txns_per_batch=10)
    ):
        want = _step_both(jcs, tcs, txns, now, nov, f"batch {bi}")
        assert want == cpu.detect(txns, now, nov)
    assert _majors(tcs) == _majors(jcs) >= 2


def test_delta_exactly_full_triggers_compaction(monkeypatch):
    """The fill edge: the compaction fires exactly when the next batch
    could overflow the delta, and the delta resets to its floor row."""
    jcs, tcs = _pair(monkeypatch)
    cpu = CpuConflictSet()
    add = 2 * BUCKETS[2]
    v = 0
    saw_reset = False
    for i in range(20):
        txns = [
            JT(read_snapshot=v,
               write_ranges=[(k(10_000 * i + 4 * j), k(10_000 * i + 4 * j + 1))
                             for j in range(16)])
        ] + [
            JT(read_snapshot=max(0, v - lag),
               read_ranges=[(k(10_000 * max(0, i - back)),
                             k(10_000 * max(0, i - back) + 70))])
            for lag, back in ((1, 1), (12, 3), (0, 0))
        ]
        expect_major = tcs._dcount_bound + 2 * add + 2 > tcs.d_cap
        v += 5
        assert _step_both(jcs, tcs, txns, v, 0, f"batch {i}") == cpu.detect(txns, v, 0)
        assert int(tcs._dcount) <= tcs.d_cap
        if expect_major:
            assert tcs._batches_since_major == 0 and int(tcs._dcount) == 1
            saw_reset = True
    assert saw_reset and _majors(tcs) >= 2
    assert tcs.boundary_count == cpu.boundary_count


def test_major_compaction_same_batch_as_grow(monkeypatch):
    """The base grows on a compaction batch (the only kind that can grow it
    in tiered mode); the carried table is rebuilt at the new width."""
    jcs, tcs = _pair(monkeypatch, h_cap=1 << 9)
    cpu = CpuConflictSet()
    v = 0
    for i in range(14):
        txns = [
            JT(read_snapshot=v,
               write_ranges=[(k(20_000 * i + 100 * t + 2 * j),
                              k(20_000 * i + 100 * t + 2 * j + 1))
                             for j in range(8)])
            for t in range(8)
        ]
        v += 5
        assert _step_both(jcs, tcs, txns, v, 0, f"batch {i}") == cpu.detect(txns, v, 0)
    assert tcs.grows == jcs.metrics.snapshot()["counters"]["grows"] >= 1
    assert _majors(tcs) >= 1 and tcs.h_cap == jcs.h_cap > (1 << 9)
    assert tcs.boundary_count == cpu.boundary_count


def test_rebase_keeps_tiers_consistent(monkeypatch):
    """A rebase shifts the base, the delta and the carried table by one
    constant."""
    jcs, tcs = _pair(monkeypatch)
    cpu = CpuConflictSet()
    step = REBASE_THRESHOLD // 3 + 7
    v = 0
    for i in range(6):
        txns = [
            JT(read_snapshot=v, write_ranges=[(k(100 * i + 2 * j), k(100 * i + 2 * j + 1))
                                              for j in range(4)]),
            JT(read_snapshot=v, read_ranges=[(k(100 * (i - 1)), k(100 * i + 10))]),
        ]
        v += step
        oldest = max(0, v - 2 * step)
        assert _step_both(jcs, tcs, txns, v, oldest, f"batch {i}") == cpu.detect(txns, v, oldest)
    assert tcs.rebases == jcs.metrics.snapshot()["counters"]["rebases"] >= 1


def test_store_load_roundtrip_mid_delta(monkeypatch):
    """store_to exports the merged view while the delta holds rows;
    load_from into a fresh tiered engine restarts the delta and continues
    identically."""
    stream = _random_stream(29, 40, batches=26, txns_per_batch=12)
    jcs, tcs = _pair(monkeypatch)
    cpu = CpuConflictSet()
    for txns, now, nov in stream[:14]:
        assert _step_both(jcs, tcs, txns, now, nov) == cpu.detect(txns, now, nov)
    assert int(tcs._dcount) > 1, "delta empty: the round trip would be trivial"
    jm, tm = CpuConflictSet(), FlatCpuConflictSet()
    jcs.store_to(jm)
    tcs.store_to(tm)
    assert (tm.keys, tm.vers, tm.oldest_version) == (jm.keys, jm.vers, jm.oldest_version)
    jcs2, tcs2 = _pair(monkeypatch)
    jcs2.load_from(jm)
    tcs2.load_from(tm)
    assert int(tcs2._dcount) == 1
    _assert_same_tiers(jcs2, tcs2, "after load_from")
    for bi, (txns, now, nov) in enumerate(stream[14:]):
        got = _step_both(jcs2, tcs2, txns, now, nov, f"post-roundtrip batch {bi}")
        assert got == cpu.detect(txns, now, nov)


def test_divergence_on_compaction_batch_keeps_bounds_truthful(monkeypatch):
    """A fixpoint-diverged batch on a compaction batch still compacts (the
    reverted delta), so the host's bound of 1 stays true; the CPU
    fallback then adopts the merged state, as the reference's does."""
    jcs, tcs = _pair(monkeypatch, evict_every=2)
    cpu = CpuConflictSet()
    txns1 = [JT(read_snapshot=0,
                write_ranges=[(k(4 * j), k(4 * j + 1)) for j in range(16)])]
    assert _step_both(jcs, tcs, txns1, 5, 0) == cpu.detect(txns1, 5, 0)
    assert int(tcs._dcount) > 1
    # The cadence-2 compaction batch: a read-tripled dependency chain whose
    # residual (29 undecided txns x 3 reads) overflows RCAP = 64.
    chain = [JT(read_snapshot=5, write_ranges=[(k(1000), k(1001))])]
    for i in range(1, 31):
        chain.append(JT(read_snapshot=5,
                        read_ranges=[(k(1000 + i - 1), k(1000 + i))] * 3,
                        write_ranges=[(k(1000 + i), k(1000 + i + 1))]))
    jpb = ej.PackedBatch.from_transactions(chain, 3, *BUCKETS)
    tpb = et.PackedBatch.from_transactions(_port_txns(chain), 3, *BUCKETS)
    _statuses, undecided = jcs.dispatch_packed(jpb, 10, 0)
    ticket = tcs.dispatch_packed(tpb, 10, 0)
    assert int(undecided) > 0 and int(ticket.out[0]) == int(undecided)
    _assert_same_tiers(jcs, tcs, "diverged compaction batch")
    assert int(tcs._dcount) == 1 and tcs._dcount_bound == 1
    assert int(tcs._hcount) > 2 * 16
    assert _majors(tcs) == _majors(jcs) == 1
    want = jcs._fallback_cpu(jpb, 10, 0)
    got = tcs._fallback_cpu(tpb, 10, 0)
    assert (got == np.asarray(want)).all()
    assert list(got[: len(chain)]) == cpu.detect(chain, 10, 0)
    assert tcs.last_witness == jcs.last_witness
    _assert_same_tiers(jcs, tcs, "after the fallback")
    probe = [JT(read_snapshot=9, read_ranges=[(k(1000), k(1031))])]
    assert _step_both(jcs, tcs, probe, 12, 0) == cpu.detect(probe, 12, 0)


def test_mixed_bucket_batch_grows_delta_instead_of_truncating(monkeypatch):
    """A batch of a larger bucket than the ones that filled the delta: the
    pre-merge guard syncs the true count and grows the delta."""
    jcs, tcs = _pair(monkeypatch, h_cap=1 << 11, bucket_mins=(8, 8, 8))
    cpu = CpuConflictSet()
    v = 0
    for i in range(12):
        txns = [JT(read_snapshot=v,
                   write_ranges=[(k(10_000 * i + 4 * j), k(10_000 * i + 4 * j + 1))
                                 for j in range(16)])]
        v += 5
        assert _step_both(jcs, tcs, txns, v, 0, f"fill {i}") == cpu.detect(txns, v, 0)
    assert int(tcs._dcount) > 300 and tcs.d_cap == 512
    big = [JT(read_snapshot=v,
              write_ranges=[(k(900_000 + 100 * t + 4 * j), k(900_000 + 100 * t + 4 * j + 1))
                            for j in range(20)])
           for t in range(2)]
    v += 5
    assert _step_both(jcs, tcs, big, v, 0, "big") == cpu.detect(big, v, 0)
    assert tcs.d_cap == jcs.d_cap == 1024
    probes = [JT(read_snapshot=0, read_ranges=[(k(10_000 * i), k(10_000 * i + 70))])
              for i in range(12)] + [
        JT(read_snapshot=0, read_ranges=[(k(900_000), k(900_300))])]
    v += 1
    assert _step_both(jcs, tcs, probes, v, 0, "probes") == cpu.detect(probes, v, 0)
    assert tcs.boundary_count == cpu.boundary_count


def test_tiered_blob_is_byte_identical_to_reference(monkeypatch):
    """The tiered blob carries the compaction flag in the flat layout's
    third scalar."""
    txns, now, nov = _random_stream(31, 60, 1, 30)[0]
    jcs, tcs = _pair(monkeypatch, evict_every=2)
    jpb = ej.PackedBatch.from_transactions(txns, 3, *BUCKETS)
    tpb = et.PackedBatch.from_transactions(_port_txns(txns), 3, *BUCKETS)
    for flag in (0, 1):
        want = np.array(jcs._pack_blob(jpb, now, nov, flag))
        assert (tcs._pack_blob(tpb, now, nov, flag) == want).all()


# ---------------------------------------------------------------------------
# ConflictSet(history="tiered") against the reference's ConflictSet
# ---------------------------------------------------------------------------


def _ref_set(monkeypatch, depth, evict_every=1, **kw):
    monkeypatch.setenv("FDB_TPU_PIPELINE_DEPTH", str(depth))
    monkeypatch.setenv("FDB_TPU_EVICT_EVERY", str(evict_every))
    cs = RefConflictSet(backend="jax", key_words=3, h_cap=1 << 10,
                        bucket_mins=BUCKETS, **kw)
    assert cs._jax.tiered
    return cs


def _port_set(depth, evict_every=1, **kw):
    return ConflictSet(key_words=3, h_cap=1 << 10, bucket_mins=BUCKETS, device="cpu",
                       pipeline_depth=depth, history="tiered", delta_cap=D_CAP,
                       evict_every=evict_every, **kw)


def _drive(cs, stream, depth, port):
    entries = []
    for txns, now, nov in stream:
        entries.append(cs.pipeline_submit(_port_txns(txns) if port else txns, now, nov))
        while cs.pipeline_inflight > depth - 1:
            cs.pipeline_complete_oldest()
    cs.pipeline_drain()
    return [(list(e.statuses), list(e.witness), e.degraded) for e in entries]


def _assert_same_sets(cs, ref):
    assert (list(cs._cpu.keys), list(cs._cpu.vers), cs._cpu.oldest_version) == (
        list(ref._cpu.keys), list(ref._cpu.vers), ref._cpu.oldest_version)
    tm, jm = FlatCpuConflictSet(), CpuConflictSet()
    cs._dev.store_to(tm)
    ref._jax.store_to(jm)
    assert (tm.keys, tm.vers, tm.oldest_version) == (jm.keys, jm.vers, jm.oldest_version)
    _assert_same_tiers(ref._jax, cs._dev)
    pm, rm = cs.device_metrics(), ref.device_metrics()
    _assert_same_metrics(rm, pm)
    assert pm["tiers"] == rm["tiers"]
    assert pm["last_occupancy"] == rm["last_occupancy"]
    assert json.dumps(pm["breaker"]) == json.dumps(rm["breaker"])


def _run_sync(cs, stream, port):
    """The synchronous ConflictBatch API: (verdicts, witness) per batch."""
    out = []
    for txns, now, nov in stream:
        b = cs.new_batch()
        for t in _port_txns(txns) if port else txns:
            b.add_transaction(t)
        out.append((b.detect_conflicts(now, nov), list(cs.last_witness)))
    return out


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_tiered_pipeline_depths_match_the_reference(monkeypatch, depth):
    """Depths 1-3 with compactions every 3 batches and on fill: verdicts,
    witnesses, the mirror, the merged device export, the raw tiers and the
    metrics (counters, gauges, histograms, the tiers block)."""
    stream = _random_stream(7, 60, 18, 10)
    ref = _ref_set(monkeypatch, depth, evict_every=3)
    want = _drive(ref, stream, depth, port=False)
    cs = _port_set(depth, evict_every=3)
    got = _drive(cs, stream, depth, port=True)
    assert got == want
    _assert_same_sets(cs, ref)
    assert cs.device_metrics()["counters"]["major_compactions"] >= 2
    got, want = cs.mirror_check(), ref.mirror_check()
    assert got.pop("below_window_keys") == 0
    assert got == want and got["status"] == "ok"


def test_fault_during_major_compaction_batch(monkeypatch):
    """Dispatch faults 4-7 (batch 4 is the cadence-4 compaction batch,
    held down through the first probe): the mirror serves identically, the
    breaker walks and recovers, the probe rehydrates (the delta restarts
    empty) and the engine compacts again — equal to the reference: the
    injected log, the transitions, the verdicts and the tiers."""
    stream = _random_stream(37, 50, batches=18, txns_per_batch=10)

    def script(inj):
        for at in (4, 5, 6, 7):
            inj.script("dispatch", at=at)
        return inj

    rinj = script(RefInjector())
    ref = _ref_set(monkeypatch, 2, evict_every=4, fault_injector=rinj)
    want = _run_sync(ref, stream, port=False)
    inj = script(DeviceFaultInjector())
    cs = _port_set(2, evict_every=4, fault_injector=inj)
    got = _run_sync(cs, stream, port=True)
    assert got == want
    cpu = CpuConflictSet()
    assert [v for v, _w in got] == [cpu.detect(t, n, o) for t, n, o in stream]
    assert inj.injected == rinj.injected
    dm = cs.device_metrics()
    pairs = [(f, t) for _s, f, t, _r in dm["breaker"]["transitions"]]
    assert pairs == [("ok", "degraded"), ("degraded", "probing"),
                     ("probing", "degraded"), ("degraded", "probing"),
                     ("probing", "ok")]
    assert dm["counters"]["major_compactions"] >= 1
    assert dm["tiers"]["mode"] == "tiered" and dm["tiers"]["d_cap"] == D_CAP
    _assert_same_sets(cs, ref)


def test_tiered_metrics_surface(monkeypatch):
    """device_metrics() carries the tier telemetry as the reference's does:
    the tiers block, the boundary gauges, the delta occupancy at dispatch
    and at sync, and the compaction counter."""
    stream = _random_stream(41, 40, batches=8, txns_per_batch=10)
    ref = _ref_set(monkeypatch, 2)
    cs = _port_set(2)
    cpu = CpuConflictSet()
    got = _run_sync(cs, stream, port=True)
    assert got == _run_sync(ref, stream, port=False)
    assert [v for v, _w in got] == [cpu.detect(t, n, o) for t, n, o in stream]
    dm = cs.device_metrics()
    assert dm["tiers"] == {
        "mode": "tiered", "d_cap": D_CAP, "compact_every": 0,
        "batches_since_major": cs._dev._batches_since_major,
        "delta_bound": cs._dev._dcount_bound,
    }
    assert dm["gauges"]["base_boundaries"] >= 1
    assert dm["gauges"]["delta_boundaries"] >= 1
    assert "delta" in dm["last_occupancy"]
    assert "major_compactions" in dm["counters"]
    assert dm["histograms"]["delta_occupancy_synced"]["count"] >= 1
    _assert_same_sets(cs, ref)


def test_flat_history_takes_no_compaction_cadence():
    """In flat mode evict_every is the amortized eviction cadence
    (tests/test_torch_amortized.py), never a compaction cadence; below 1
    it is refused, and so is an unknown history mode."""
    amortized = TorchConflictSet(device="cpu", evict_every=2)
    assert amortized.evict_every == 2 and amortized.compact_every == 0
    assert amortized.d_cap == 0
    with pytest.raises(ValueError, match="evict_every"):
        TorchConflictSet(device="cpu", evict_every=0)
    with pytest.raises(ValueError, match="history"):
        ConflictSet(device="cpu", history="layered")
    flat = TorchConflictSet(device="cpu", key_words=3, h_cap=1 << 10)
    assert not flat.tiered and flat.d_cap == 0
    assert "major_compactions" not in flat.metrics.snapshot()["counters"]
    tiered = TorchConflictSet(device="cpu", key_words=3, h_cap=1 << 10, history="tiered")
    assert tiered.d_cap == max(64, (1 << 10) // 8) and tiered.compact_every == 0


def _int_key_stream(seed, n_txn, batches, window, keyspace=20_000):
    """The bench's stream at a small size: 1 read + 1 write range of 4-byte
    keys per txn, detect at now=i+window evicting below i."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(batches):
        txns = []
        for _ in range(n_txn):
            a, b = (int(x) for x in rng.integers(0, keyspace, 2))
            ra, wb = (int(x) for x in 1 + rng.integers(0, 10, 2))
            txns.append(JT(i, [(a.to_bytes(4, "big"), (a + ra).to_bytes(4, "big"))],
                           [(b.to_bytes(4, "big"), (b + wb).to_bytes(4, "big"))]))
        out.append((txns, i + window, i))
    return out


def test_mirror_check_reads_tiered_history_as_the_window_sees_it(monkeypatch):
    """The tiered base is evicted only at compactions, the mirror every
    batch, so once the window moves some of their rows carry different
    versions below it.  No snapshot the window admits can tell them apart,
    but the reference's row-by-row mirror_check reports a divergence (and
    opens its breaker).  The port's reads "ok" with the same keys counted
    as below_window_keys; the export itself still equals the reference's
    row for row, and a version planted above the window still diverges."""
    monkeypatch.setenv("FDB_TPU_PIPELINE_DEPTH", "1")
    monkeypatch.setenv("FDB_TPU_EVICT_EVERY", "4")
    monkeypatch.setenv("FDB_TPU_DELTA_CAP", "2048")
    shape = dict(key_words=2, h_cap=1 << 14, bucket_mins=(8, 8, 8))
    ref = RefConflictSet(backend="jax", **shape)
    cs = ConflictSet(device="cpu", pipeline_depth=1, history="tiered", delta_cap=2048,
                     evict_every=4, **shape)
    stream = _int_key_stream(5, 256, 16, 10)
    assert _run_sync(cs, stream, port=True) == _run_sync(ref, stream, port=False)
    _assert_same_tiers(ref._jax, cs._dev)
    want, got = ref.mirror_check(), cs.mirror_check()
    assert want["status"] == "diverged" and want["mismatch_keys"] > 0
    assert got["status"] == "ok" and got["mismatch_keys"] == 0
    assert got["below_window_keys"] == want["mismatch_keys"]
    assert got["boundaries"] == want["boundaries"]
    tm, jm = FlatCpuConflictSet(), CpuConflictSet()
    cs._dev.store_to(tm)
    ref._jax.store_to(jm)
    assert (tm.keys, tm.vers) == (jm.keys, jm.vers)
    # The newest version in the base is above the window: edit it.
    row = int(cs._dev._hvers.argmax())
    cs._dev._hvers[row] += 1
    report = cs.mirror_check()
    assert report["status"] == "diverged"
    assert report["mismatch_keys"] == got["below_window_keys"] + 1
    assert cs.device_metrics()["backend_state"] == "degraded"
