"""Shard-granular fault domains of the port's ShardedTorchConflictSet, and
the risks particular to running the reference's one-program mesh step as a
loop over shards on one device.

Twins of tests/test_shard_fault_domains.py (the port against the
multi-resolver oracle, flat and tiered): a scripted fault on one shard
walks only that shard's breaker, ok -> degraded -> probing -> degraded
(a grow fault at the probe's rehydration) -> probing -> ok, with verdicts
equal to the fault-free oracle and byte-identical replays; the metrics
snapshot's shape does not depend on which shard faulted; backend_signal
counts the degraded shards; the injector's per-shard sites keep their own
counters; a long outage in tiered mode rehydrates only the sick shard.

Then each port-specific risk, with a test that fails without its fix:

- a divergence in ONE shard reverts every active shard (the sum over the
  active shards gates every commit);
- a masked shard still decides, so its iteration count reaches
  ``last_iters`` as in the reference;
- the ``compile`` site fires again after a grow, as the reference's
  retrace does;
- a tiered batch's compaction plan reads the true delta counts, as the
  reference's does, and not an upper bound that would compact early.

The last three are held against the reference's ShardedJaxConflictSet
(kernels off).  All integers; the tolerance is zero.
"""

import json

import numpy as np
import pytest

import foundationdb_tpu.parallel.sharded_resolver as jsr
from foundationdb_tpu.conflict.device_faults import DeviceFaultInjector as RefInjector
from foundationdb_tpu.conflict.types import TransactionConflictInfo as JT
from foundationdb_tpu.flow import set_event_loop
from foundationdb_tpu_torch.conflict import engine_torch as et
from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector, DeviceUnavailable
from foundationdb_tpu_torch.parallel.sharded_resolver import ShardedTorchConflictSet

from test_sharded_resolver import KEY_BYTES, N_SHARDS, MultiResolverCpuOracle
from test_shard_fault_domains import PLANS, SICK, _batches
from test_torch_sharded import (
    BUCKETS,
    H_CAP,
    KEY_WORDS,
    key,
    make_port,
    make_ref,
    port_slices,
    port_txns,
    split_for,
)


@pytest.fixture(autouse=True)
def _clean_loop():
    yield
    set_event_loop(None)


MODES = {"flat": {}, "tiered": dict(history="tiered", evict_every=3, delta_cap=2048)}


def make_set(mode="flat", plans=()):
    """The reference fault-domain suite's set: 4 shards over [0, 2000)."""
    cs = ShardedTorchConflictSet(
        split_for(N_SHARDS), key_words=3, h_cap=1 << 12, device="cpu",
        bucket_mins=(64, 128, 128), **MODES[mode])
    inj = DeviceFaultInjector()
    for site, at, persist, shard in plans:
        inj.script(site, at=at, persist=persist, shard=shard)
    cs.install_fault_injector(inj)
    return cs, inj


def run_plans(seed, plans, mode="flat"):
    cs, inj = make_set(mode, plans)
    verdicts = [cs.detect(port_txns(txns), now, oldest) for txns, now, oldest in _batches(seed)]
    return cs, inj, verdicts


# ---------------------------------------------------------------------------
# twins of tests/test_shard_fault_domains.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_shard_fault_differential_gate(mode, seed):
    """test_shard_fault_domains.py:100: shard SICK's third dispatch down
    for three checks (the breaker opens; in tiered mode batch 3 is a
    compaction batch) and its first probe's rehydration faulted."""
    oracle = MultiResolverCpuOracle(split_for(N_SHARDS))
    want = [oracle.detect(txns, now, oldest) for txns, now, oldest in _batches(seed)]
    cs, inj, got = run_plans(seed, PLANS, mode)
    assert got == want
    assert sorted(site for _seq, site, _kind in inj.injected) == [f"dispatch#s{SICK}"] * 3 + [
        f"grow#s{SICK}"]
    for s in range(N_SHARDS):
        if s != SICK:
            assert cs._breakers[s].state == "ok" and cs._breakers[s].transitions == [], s
    sick = cs._breakers[SICK]
    assert [(f, t) for _seq, f, t, _r in sick.transitions] == [
        ("ok", "degraded"), ("degraded", "probing"), ("probing", "degraded"),
        ("degraded", "probing"), ("probing", "ok")]
    assert sick.transitions[0][3].startswith("threshold:")
    assert sick.transitions[2][3].startswith("probe_failed:")
    assert cs.metrics.counter("degraded_shard_serves").value > 0
    assert cs.metrics.counter(f"shard{SICK}_rehydrates").value > 0
    assert cs.mirror_check()["status"] == "ok"
    cs2, inj2, got2 = run_plans(seed, PLANS, mode)
    assert got2 == got
    assert json.dumps(inj2.injected) == json.dumps(inj.injected)
    for s in range(N_SHARDS):
        assert json.dumps(cs2._breakers[s].transitions) == json.dumps(cs._breakers[s].transitions)


def test_metrics_snapshot_shape_is_fault_independent():
    """test_shard_fault_domains.py:151: every per-shard instrument exists
    from construction."""
    clean, _inj, _ = run_plans(5, ())
    faulty, inj, _ = run_plans(5, PLANS)
    assert inj.injected
    a, b = clean.device_metrics(), faulty.device_metrics()
    assert set(a["counters"]) == set(b["counters"])
    assert set(a["gauges"]) == set(b["gauges"])
    for s in range(N_SHARDS):
        assert f"shard{s}_breaker_opens" in a["counters"]
        assert f"shard{s}_backend_state" in a["gauges"]
    assert b["gauges"][f"shard{SICK}_backend_state"] == 0  # closed again


def test_backend_signal_carries_shard_counts():
    """test_shard_fault_domains.py:186: one shard down of four."""
    cs, inj = make_set()
    inj.begin_outage("dispatch", shard=SICK)
    for txns, now, oldest in _batches(21, n_batches=4):
        cs.detect(port_txns(txns), now, oldest)
    sig = cs.backend_signal()
    assert (sig["shards_total"], sig["shards_degraded"], sig["backend_state"]) == (
        N_SHARDS, 1, "degraded")
    assert sig["cpu_fallback_txns"] > 0 and sig["cpu_mirror_tps"] > 0.0
    dm = cs.device_metrics()
    assert dm["shards"]["states"][SICK] == "degraded" and dm["shards"]["degraded"] == 1
    assert dm["gauges"][f"shard{SICK}_backend_state"] == 1
    assert cs.consume_degraded() and not cs.consume_degraded()
    inj.end_outage("dispatch", shard=SICK)
    cs._breakers[0].count_degraded_batch()  # a shard's own counter, prefixed
    assert cs.metrics.counter("shard0_degraded_batches").value == 1
    assert cs._breakers[0].label == "shard0" and len({b.breaker_id for b in cs._breakers}) == 4


def test_injector_per_shard_sites_are_scoped_and_replayable():
    """test_shard_fault_domains.py:203, and the same mixed script of
    shard-scoped and un-scoped checks logs identically in both packages."""
    inj = DeviceFaultInjector()
    inj.script("dispatch", at=2, shard=1)
    inj.check("dispatch", shard=0)
    inj.check("dispatch", shard=1)
    inj.check("dispatch", shard=0)
    with pytest.raises(DeviceUnavailable):
        inj.check("dispatch", shard=1)
    inj.check("dispatch", shard=0)
    assert [e[1] for e in inj.injected] == ["dispatch#s1"]

    def drive(injector):
        injector.script("dispatch", at=2)
        injector.script("grow", at=1, persist=2, shard=3)
        injector.begin_outage("compile", shard=0)
        for i in range(4):
            for site, shard in (("dispatch", None), ("grow", 3), ("compile", 0),
                                ("compile", None), ("dispatch", 2)):
                if i == 3 and site == "compile":
                    injector.end_outage("compile", shard=0)
                try:
                    injector.check(site, shard=shard)
                except Exception as e:
                    assert e.site == site
        return injector.injected

    assert drive(DeviceFaultInjector()) == drive(RefInjector())


def test_mid_probe_fault_reopens_only_sick_shard_tiered():
    """test_shard_fault_domains.py:208: a dispatch outage over several
    compactions, lifted mid-run; recovery rehydrates only the sick shard
    and verdicts stay the oracle's."""
    oracle = MultiResolverCpuOracle(split_for(N_SHARDS))
    cs, inj = make_set("tiered")
    for i, (txns, now, oldest) in enumerate(_batches(31, n_batches=16)):
        if i == 2:
            inj.begin_outage("dispatch", shard=SICK)
        if i == 10:
            inj.end_outage("dispatch", shard=SICK)
        assert cs.detect(port_txns(txns), now, oldest) == oracle.detect(txns, now, oldest), i
    assert cs._breakers[SICK].state == "ok"
    assert cs.metrics.counter(f"shard{SICK}_rehydrates").value > 0
    for s in range(N_SHARDS):
        if s != SICK:
            assert cs._breakers[s].transitions == []
            assert cs.metrics.counter(f"shard{s}_rehydrates").value == 0
    assert cs.metrics.counter("major_compactions").value >= 4
    assert cs.mirror_check()["status"] == "ok"


# ---------------------------------------------------------------------------
# port-specific risks
# ---------------------------------------------------------------------------


def _patch_divergence(monkeypatch, mode, shard, n_shards, batch):
    """Make shard `shard`'s fixpoint report one undecided transaction at
    batch `batch` (the decide half runs once per shard per batch, in shard
    order)."""
    name = "decide_tiered" if mode == "tiered" else "decide_flat"
    real = getattr(et, name)
    calls = {"n": 0}

    def decide(*args, **kw):
        dec = real(*args, **kw)
        i = calls["n"]
        calls["n"] += 1
        if i == batch * n_shards + shard:
            return dec._replace(undecided=dec.undecided + 1)
        return dec

    monkeypatch.setattr(et, name, decide)


@pytest.mark.parametrize("mode", ["flat", "tiered"])
def test_one_shard_divergence_reverts_every_active_shard(monkeypatch, mode):
    """The reference psums the undecided counts over the active shards, so
    one shard's divergence reverts them all and the whole batch re-decides
    on the mirrors (test_sharded_resolver.py:162 patches the whole step;
    here only shard 1's count).  Every active slice keeps its pre-batch
    state (flat: key for key), all go stale and rehydrate, and verdicts
    equal the oracle before, at and after the batch."""
    n = 4
    oracle = MultiResolverCpuOracle(split_for(n))
    cs = make_port(n, mode == "tiered")
    stream = _batches(23, n_batches=8)
    _patch_divergence(monkeypatch, mode, shard=1, n_shards=n, batch=4)
    for i, (txns, now, oldest) in enumerate(stream):
        before = port_slices(cs)
        assert cs.detect(port_txns(txns), now, oldest) == oracle.detect(txns, now, oldest), i
        if i == 4:
            assert cs._stale == [True] * n
            assert cs.metrics.counter("cpu_fallbacks").value == 1
            if mode == "flat":
                assert port_slices(cs) == before
        else:
            assert not any(cs._stale), i
    assert cs.metrics.counter("degraded_shard_serves").value == 0
    assert all(cs.metrics.counter(f"shard{s}_rehydrates").value == 1 for s in range(n))
    assert all(b.transitions == [] for b in cs._breakers)
    assert cs.mirror_check()["status"] == "ok"


def _ref_and_port(n, plans=(), actions=None, *, stream, h_cap=H_CAP, tiered_env=None,
                  port_kw=None):
    """Run a stream through the reference's and the port's sharded sets
    under the same plans and injector actions; per batch (verdicts,
    witness, last_iters, counters, h_cap, d_cap, batches_since_major)."""
    out = []
    for port in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if port:
                cs = make_port(n, h_cap=h_cap, **(port_kw or {}))
            else:
                if tiered_env:
                    for k, v in tiered_env.items():
                        mp.setenv(k, v)
                    mp.setattr(jsr, "_SHARD_MAP_KW", {"check_vma": False})
                cs = make_ref(n, h_cap=h_cap)
            inj = DeviceFaultInjector() if port else RefInjector()
            for site, at, persist, shard in plans:
                inj.script(site, at=at, persist=persist, shard=shard)
            cs.install_fault_injector(inj)
            obs = []
            for i, (txns, now, nov) in enumerate(stream):
                for method, site, shard in (actions or {}).get(i, ()):
                    getattr(inj, method)(site, shard=shard)
                v = cs.detect(port_txns(txns) if port else txns, now, nov)
                obs.append((v, list(cs.last_witness), cs.last_iters,
                            cs.metrics.snapshot()["counters"], cs.h_cap, cs.d_cap,
                            cs._batches_since_major))
            out.append((obs, list(inj.injected), [list(b.transitions) for b in cs._breakers]))
    return out


def test_masked_shard_iterations_reach_last_iters():
    """shard_map runs every shard's body, a masked one included, and the
    reference takes last_iters as the maximum over ALL shards.  Here shard
    1 is held down while a 12-transaction dependency chain inside its key
    range arrives: only its (masked) decide iterates past the minimum, and
    last_iters equals the reference's."""
    now = 100

    def chain(base, snap):
        return [JT(read_snapshot=snap,
                   read_ranges=[] if i == 0 else [(key(base + i), key(base + i + 1))],
                   write_ranges=[(key(base + i + 1), key(base + i + 2))]) for i in range(12)]

    other = [JT(read_snapshot=now, read_ranges=[(key(10), key(20))],
                write_ranges=[(key(30), key(40))])]
    stream = [(other, now + 1, 0), (other, now + 2, 0), (chain(1100, now), now + 3, 0),
              (other + chain(1300, now + 3), now + 4, 0), (other, now + 5, 0)]
    (ref_obs, ref_inj, ref_tr), (obs, inj, tr) = _ref_and_port(
        2, actions={1: [("begin_outage", "dispatch", 1)], 4: [("end_outage", "dispatch", 1)]},
        stream=stream)
    assert obs == ref_obs
    assert (inj, tr) == (ref_inj, ref_tr)
    # Batches 2 and 3 ran shard 0 alone on the device; the iterations came
    # from shard 1's masked decide.
    assert [o[2] for o in obs][2:4] == [12, 12]
    assert obs[2][0] == [2 if i % 2 == 0 else 0 for i in range(12)]


def test_compile_site_fires_again_after_a_grow():
    """A grow invalidates every compiled step in the reference, so the
    next batch compiles again and checks the `compile` site once more on
    every active shard: shard 1's second compile check, scripted to fault,
    comes right after the grow."""
    rng = np.random.default_rng(4)
    stream = []
    now = 100
    for _ in range(5):
        def rng_range():
            a = int(rng.integers(0, 2000))
            return (key(a), key(a + 1 + int(rng.integers(0, 4))))

        txns = [JT(read_snapshot=now, read_ranges=[rng_range()],
                   write_ranges=[rng_range(), rng_range()]) for _ in range(32)]
        now += 10
        stream.append((txns, now, max(0, now - 400)))
    (ref_obs, ref_inj, ref_tr), (obs, inj, tr) = _ref_and_port(
        2, plans=[("compile", 2, 1, 1)], stream=stream, h_cap=256)
    assert obs == ref_obs
    assert (inj, tr) == (ref_inj, ref_tr)
    counters = obs[-1][3]
    assert counters["grows"] >= 1 and counters["retraces"] == counters["grows"] + 1
    assert inj == [[inj[0][0], "compile#s1", "transient"]]
    assert counters["shard1_faults_compile"] == 1


def test_tiered_plan_reads_true_delta_counts():
    """The shared compaction plan compacts when the largest TRUE delta
    count might not fit the next batch.  Here every batch writes the same
    few keys, so the true counts stay small while an upper bound (each
    batch adding 2 * wr_cap rows) would cross the fill trigger by the
    third batch: no compaction happens, as in the reference."""
    stream = []
    now = 100
    for i in range(10):
        txns = [JT(read_snapshot=now, read_ranges=[(key(100 + j), key(101 + j))],
                   write_ranges=[(key(j + 1), key(j + 2)), (key(1500 + j), key(1501 + j))])
                for j in range(i % 3, 32 + i % 3)]
        now += 10
        stream.append((txns, now, max(0, now - 100)))
    env = {"FDB_TPU_HISTORY": "tiered", "FDB_TPU_EVICT_EVERY": "1", "FDB_TPU_DELTA_CAP": "512"}
    (ref_obs, _ri, _rt), (obs, _i, _t) = _ref_and_port(
        2, stream=stream, tiered_env=env,
        port_kw=dict(history="tiered", evict_every=1, delta_cap=512))
    assert obs == ref_obs
    add = 2 * BUCKETS[2]  # rows a batch may add to a delta
    assert (1 + 2 * add) + 2 * add + 2 > 512  # a bound-driven plan compacts at batch 3
    assert obs[-1][3]["major_compactions"] == 0
    assert [o[6] for o in obs] == list(range(1, 11))
    assert KEY_WORDS == 3 and KEY_BYTES == 8
