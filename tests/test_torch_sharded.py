"""The port's ShardedTorchConflictSet against the reference's ShardedJaxConflictSet.

The same seeded streams, under the same per-shard fault scripts, go through
the reference's sharded set (kernels off, on the 8 virtual CPU devices
tests/conftest.py sets up) and the port's ``ShardedTorchConflictSet(device=
"cpu")`` at 1, 2 and 4 shards, flat and tiered.  After every batch:
verdicts, witnesses, ``last_iters``, each shard's device slice (the delta
folded over the base in tiered mode) and window, ``h_cap``, ``d_cap``,
every counter and gauge of the registry, which slices are stale, and
``backend_signal()`` (less its wall-clock ``cpu_mirror_tps``) are equal.
At the end: ``device_metrics()`` (its wall namespace is not in a
snapshot), ``store_to``'s global state, the injected-fault log and each
shard breaker's transitions.  ``mirror_check`` is equal in flat mode; in
tiered mode the reference reports keys that differ only below the window
as a divergence (ROADMAP F4) and the port as ``below_window_keys``.

Every batch packs to one shape (txn 32, reads 128, writes 64), so each
reference instance compiles once.  The reference's tiered sharded step
trips jax 0.9.0's varying-manual-axes type check on its compaction
``lax.cond`` (its minor branch returns the sharded inputs, its major branch
fresh arrays); the check types the program and computes nothing, so the
reference runs here with ``check_vma`` off.

Also: the multi-resolver oracle (the reference's test_sharded_resolver.py),
one shard against the port's flat TorchConflictSet, the store/load round
trip, the long-key pin, the sharded witness rule, the reference's
SimCluster serving through the port's set, and the argument checks.  All
integers; the tolerance is zero.
"""

import json

import numpy as np
import pytest

import foundationdb_tpu.parallel.sharded_resolver as jsr
from foundationdb_tpu.conflict.device_faults import DeviceFaultInjector as RefInjector
from foundationdb_tpu.conflict.engine_cpu import CpuConflictSet as RefCpu
from foundationdb_tpu.conflict.types import TransactionConflictInfo as JT
from foundationdb_tpu.flow import set_event_loop
from foundationdb_tpu_torch.conflict import keys as keylib
from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector
from foundationdb_tpu_torch.conflict.engine_cpu import CpuConflictSet
from foundationdb_tpu_torch.conflict.engine_cpu_flat import FlatCpuConflictSet
from foundationdb_tpu_torch.conflict.engine_torch import TorchConflictSet
from foundationdb_tpu_torch.conflict.types import (
    COMMITTED,
    CONFLICT,
    TransactionConflictInfo as TT,
)
from foundationdb_tpu_torch.parallel.sharded_resolver import (
    ShardedTorchConflictSet,
    _clip_batch,
    _combine_witness,
    _translate_witness,
    uniform_int_split_keys,
)

from test_sharded_resolver import MultiResolverCpuOracle

KEY_BYTES = 8
KEYSPACE = 2000
KEY_WORDS = 3
H_CAP = 1 << 10
BUCKETS = (32, 128, 64)
WINDOW = 120
TIERED = dict(history="tiered", evict_every=3, delta_cap=512)
TIERED_ENV = {"FDB_TPU_HISTORY": "tiered", "FDB_TPU_EVICT_EVERY": "3",
              "FDB_TPU_DELTA_CAP": "512"}


@pytest.fixture(autouse=True)
def _clean_loop():
    yield
    set_event_loop(None)


def key(i: int) -> bytes:
    return int(i).to_bytes(KEY_BYTES, "big")


def split_for(n_shards):
    return uniform_int_split_keys(n_shards, KEYSPACE, KEY_BYTES)


def random_stream(seed, batches, *, jump_at=None, keyspace=KEYSPACE, width=20):
    """(txns, now, new_oldest) batches in the reference's types, each
    packing to BUCKETS: 1-32 txns, 0-3 reads and 0-2 writes each, ranges
    [a, a + 1 + U[0, width)).  `jump_at` moves the versions up by 2**29 at
    that batch (a rebase)."""
    rng = np.random.default_rng(seed)
    now = 100
    out = []
    for i in range(batches):
        if i == jump_at:
            now += 2**29 + 200

        def rrange():
            a = int(rng.integers(0, keyspace))
            return (key(a), key(a + 1 + int(rng.integers(0, width))))

        txns = [
            JT(read_snapshot=now - int(rng.integers(0, 50)),
               read_ranges=[rrange() for _ in range(int(rng.integers(0, 4)))],
               write_ranges=[rrange() for _ in range(int(rng.integers(0, 3)))])
            for _ in range(int(rng.integers(1, 33)))
        ]
        now += int(rng.integers(1, 30))
        out.append((txns, now, max(0, now - WINDOW)))
    return out


def port_txns(txns):
    return [TT(t.read_snapshot, list(t.read_ranges), list(t.write_ranges)) for t in txns]


def make_ref(n_shards, tiered=False, h_cap=H_CAP):
    import jax

    return jsr.ShardedJaxConflictSet(
        split_for(n_shards), key_words=KEY_WORDS, h_cap=h_cap,
        devices=jax.devices()[:n_shards], bucket_mins=BUCKETS,
    )


def make_port(n_shards, tiered=False, h_cap=H_CAP, **kw):
    return ShardedTorchConflictSet(
        split_for(n_shards), key_words=KEY_WORDS, h_cap=h_cap, device="cpu",
        bucket_mins=BUCKETS, **(TIERED if tiered else {}), **kw,
    )


# ---------------------------------------------------------------------------
# observation of one batch, on either side
# ---------------------------------------------------------------------------


def ref_slices(cs):
    """Every shard's device slice (keys, absolute versions; folded in
    tiered mode) and absolute window, from the reference's state."""
    hk, hv = np.asarray(cs._hkeys), np.asarray(cs._hvers)
    counts, olds = np.asarray(cs._hcount), np.asarray(cs._oldest)
    dk = dv = dc = None
    if cs.tiered:
        dk, dv, dc = np.asarray(cs._dkeys), np.asarray(cs._dvers), np.asarray(cs._dcount)
    return [(cs._device_shard_state(s, hk, hv, counts, dk, dv, dc), int(olds[s]) + cs._base)
            for s in range(cs.n_shards)]


def port_slices(cs):
    host = cs._host_state()
    return [(cs._device_shard_state(s, *host), int(host[3][s]) + cs._base)
            for s in range(cs.n_shards)]


def observe(cs, port, verdicts):
    snap = cs.metrics.snapshot()
    sig = dict(cs.backend_signal())
    sig.pop("cpu_mirror_tps")
    return dict(
        verdicts=[int(v) for v in verdicts], witness=list(cs.last_witness),
        iters=cs.last_iters, h_cap=cs.h_cap, d_cap=cs.d_cap,
        counters=snap["counters"], gauges=snap["gauges"], signal=sig,
        stale=list(cs._stale), slices=port_slices(cs) if port else ref_slices(cs),
    )


def final_state(cs, port):
    """End of run: device_metrics, the global export, the injector's log."""
    dm = cs.device_metrics()
    flat = FlatCpuConflictSet() if port else RefCpu()
    cs.store_to(flat)
    return dict(metrics=dm, export=(list(flat.keys), list(flat.vers), flat.oldest_version),
                injected=list(cs.fault_injector.injected))


def run(cs, stream, *, port, plans=(), actions=None):
    """Drive a stream under scripted per-shard plans [(site, at, persist,
    shard)] and per-batch actions {batch: [(method, site, shard)]} on the
    injector; returns (per-batch observations, final state)."""
    inj = DeviceFaultInjector() if port else RefInjector()
    for site, at, persist, shard in plans:
        inj.script(site, at=at, persist=persist, shard=shard)
    cs.install_fault_injector(inj)
    obs = []
    for i, (txns, now, nov) in enumerate(stream):
        for method, site, shard in (actions or {}).get(i, ()):
            getattr(inj, method)(site, shard=shard)
        verdicts = cs.detect(port_txns(txns) if port else txns, now, nov)
        obs.append(observe(cs, port, verdicts))
    return obs, final_state(cs, port)


# The differential matrix: shards, history, fault plans, injector actions
# between batches, and the stream (seed, a version jump).  Plans: shard k's
# third dispatch down for three checks (the breaker opens), and its first
# probe's rehydration takes a grow fault; another shard fails its compile
# check at the first batch; with four shards an outage holds shard 0 down
# for three batches and a rebase fault hits shard 1 after a version jump.
CASES = {
    "flat-1": (1, False, [("dispatch", 3, 3, 0), ("grow", 1, 1, 0)], {}, (11, None)),
    "flat-2": (2, False, [("dispatch", 3, 3, 1), ("grow", 1, 1, 1), ("compile", 1, 1, 0)],
               {}, (12, None)),
    "flat-4": (4, False, [("dispatch", 3, 3, 2), ("grow", 1, 1, 2), ("compile", 1, 1, 3),
                          ("rebase", 1, 1, 1)],
               {8: [("begin_outage", "dispatch", 0)], 11: [("end_outage", "dispatch", 0)]},
               (13, 12)),
    "tiered-1": (1, True, [("dispatch", 4, 2, 0)], {}, (14, None)),
    "tiered-2": (2, True, [("dispatch", 3, 3, 1), ("grow", 1, 1, 1), ("compile", 1, 1, 0)],
                 {}, (15, None)),
    "tiered-4": (4, True, [("dispatch", 3, 3, 2), ("grow", 1, 1, 2), ("compile", 1, 1, 3)],
                 {8: [("begin_outage", "dispatch", 0)], 11: [("end_outage", "dispatch", 0)]},
                 (16, None)),
}
BATCHES = 16


def case_stream(name):
    seed, jump = CASES[name][4]
    return random_stream(seed, BATCHES, jump_at=jump)


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's run of each case, made once and shared."""
    cache = {}

    def get(name):
        if name not in cache:
            n, tiered, plans, actions, _ = CASES[name]
            with pytest.MonkeyPatch.context() as mp:
                if tiered:
                    for k, v in TIERED_ENV.items():
                        mp.setenv(k, v)
                    mp.setattr(jsr, "_SHARD_MAP_KW", {"check_vma": False})
                cs = make_ref(n, tiered)
                obs, final = run(cs, case_stream(name), port=False, plans=plans, actions=actions)
                final["transitions"] = [list(b.transitions) for b in cs._breakers]
                final["mirror_check"] = cs.mirror_check()
            cache[name] = (obs, final)
        return cache[name]

    return get


def _first_difference(want, got):
    for i, (w, g) in enumerate(zip(want, got)):
        for field in w:
            if w[field] != g[field]:
                return f"batch {i} {field}: reference {w[field]!r} port {g[field]!r}"
    return None


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_the_reference(reference_runs, name):
    n, tiered, plans, actions, _ = CASES[name]
    want_obs, want = reference_runs(name)
    cs = make_port(n, tiered)
    got_obs, got = run(cs, case_stream(name), port=True, plans=plans, actions=actions)
    assert len(got_obs) == len(want_obs) == BATCHES
    assert _first_difference(want_obs, got_obs) is None, _first_difference(want_obs, got_obs)
    assert got["metrics"] == want["metrics"]
    assert got["export"] == want["export"]
    assert got["injected"] == want["injected"] and want["injected"]
    assert [list(b.transitions) for b in cs._breakers] == want["transitions"]
    # The plans really ran: a breaker opened, a shard served degraded, and
    # the stream had conflicts.
    c = got["metrics"]["counters"]
    assert c["degraded_shard_serves"] > 0 and c["device_batches"] > 0
    assert any(v == CONFLICT for o in got_obs for v in o["verdicts"])
    if n > 1:
        assert any(t for t in want["transitions"])
    if tiered:
        assert c["major_compactions"] >= 3
    if name == "flat-4":
        assert c["rebases"] > 0 and c["shard1_faults_rebase"] == 1
    # mirror_check: equal in flat mode; tiered, the reference's below-window
    # "divergence" is the port's below_window_keys.
    report = cs.mirror_check()
    ref_report = want["mirror_check"]
    if not tiered:
        assert report == ref_report
        return
    assert report["status"] == "ok"
    for s, ref_shard in ref_report["shards"].items():
        shard = dict(report["shards"][s])
        if ref_shard["status"] == "skipped":
            assert shard == ref_shard
            continue
        assert shard.pop("below_window_keys") == ref_shard["mismatch_keys"]
        assert shard == dict(ref_shard, status="ok", mismatch_keys=0)


def test_tiered_mirror_check_reads_the_reference_false_divergence_as_below_window(
        reference_runs):
    """ROADMAP F4, sharded: the reference's tiered mirror_check reports keys
    that differ only below the window as a divergence and opens the shard's
    breaker; the port reads them as below_window_keys and stays ok."""
    _obs, want = reference_runs("tiered-2")
    assert want["mirror_check"]["status"] == "diverged"
    cs = make_port(2, True)
    run(cs, case_stream("tiered-2"), port=True, plans=CASES["tiered-2"][2])
    report = cs.mirror_check()
    assert report["status"] == "ok"
    assert sum(r.get("below_window_keys", 0) for r in report["shards"].values()) > 0
    assert cs.metrics.counter("mirror_divergence").value == 0


# ---------------------------------------------------------------------------
# twins of the reference's sharded tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
def test_differential_vs_multiresolver_oracle(tiered):
    """tests/test_sharded_resolver.py:98: four shards against independent
    per-resolver CPU engines, min-combined."""
    oracle = MultiResolverCpuOracle(split_for(4))
    cs = make_port(4, tiered)
    for i, (txns, now, nov) in enumerate(random_stream(7, 12)):
        assert cs.detect(port_txns(txns), now, nov) == oracle.detect(txns, now, nov), i


def test_single_shard_matches_unsharded():
    """tests/test_sharded_resolver.py:113: one shard is the port's flat
    TorchConflictSet — verdicts, witnesses, iterations and state."""
    one = ShardedTorchConflictSet([], key_words=KEY_WORDS, h_cap=H_CAP, device="cpu",
                                  bucket_mins=BUCKETS)
    flat = TorchConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, device="cpu",
                            bucket_mins=BUCKETS)
    for i, (txns, now, nov) in enumerate(random_stream(3, 10)):
        t = port_txns(txns)
        assert one.detect(t, now, nov) == flat.detect(t, now, nov), i
        assert one.last_witness == flat.last_witness
        assert one.last_iters == flat.last_iters
        (keys, vers), oldest = port_slices(one)[0]
        want = flat._host_state()
        assert (keys, vers, oldest) == want


def test_cross_shard_write_read_conflict():
    """A write spanning a split point conflicts a later read on the far
    side: the history is partitioned, not duplicated."""
    cs = make_port(4)
    boundary = KEYSPACE // 4
    w = TT(10, [], [(key(boundary - 5), key(boundary + 5))])
    assert cs.detect([w], 20, 0) == [COMMITTED]
    r = TT(15, [(key(boundary + 1), key(boundary + 3))], [])
    assert cs.detect([r], 30, 0) == [CONFLICT]
    assert cs.last_witness == [(20, 0)]
    r2 = TT(25, [(key(boundary - 2), key(boundary + 3))], [])
    assert cs.detect([r2], 40, 0) == [COMMITTED]


@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
def test_sharded_global_state_roundtrip(tiered):
    """tests/test_sharded_resolver.py:205: store_to flattens the per-shard
    step functions into one global engine and load_from scatters it back;
    decisions keep matching the oracle across two round trips, through a
    port CpuConflictSet and a FlatCpuConflictSet."""
    oracle = MultiResolverCpuOracle(split_for(4))
    cs = make_port(4, tiered)
    for i, (txns, now, nov) in enumerate(random_stream(31, 8)):
        assert cs.detect(port_txns(txns), now, nov) == oracle.detect(txns, now, nov), i
        if i in (2, 5):
            flat = CpuConflictSet(key_words=KEY_WORDS) if i == 2 else FlatCpuConflictSet()
            cs.store_to(flat)
            before = (list(flat.keys), list(flat.vers), flat.oldest_version)
            cs.load_from(flat)
            again = FlatCpuConflictSet()
            cs.store_to(again)
            assert (list(again.keys), list(again.vers), again.oldest_version) == before
            assert cs._stale == [True] * 4
    assert sum(cs.metrics.counter(f"shard{s}_rehydrates").value for s in range(4)) == 8
    assert cs.mirror_check()["status"] == "ok"


def test_long_key_pin_abi_consistency():
    """tests/test_sharded_resolver.py:305: a long-key write pins authority
    to the mirrors across the whole ABI (detect_packed resolves on them,
    store_to exports them, load_from of long keys re-pins); after the
    hysteresis streak of short batches the pin lifts once the window has
    flushed the long key, and each slice rehydrates from its mirror."""
    from foundationdb_tpu_torch.conflict.engine_torch import PackedBatch

    cs = ShardedTorchConflictSet([key(1000)], key_words=2, h_cap=1 << 10, device="cpu",
                                 bucket_mins=(16, 16, 16))
    LONG = b"L" * 20  # beyond key_words=2's 8 bytes
    now = 100
    [st] = cs.detect([TT(now, [], [(LONG, LONG + b"\x00")])], now, 0)
    assert st == COMMITTED and cs._cpu_engines is not None
    assert cs.metrics.counter("long_key_pins").value == 1
    pb = PackedBatch.from_transactions([TT(now + 1, [], [(key(5), key(6))])], 2,
                                       min_txn=16, min_rr=16, min_wr=16)
    assert int(cs.detect_packed(pb, now + 1, 0)[0]) == COMMITTED
    [st2] = cs.detect([TT(now, [(key(5), key(6))], [(key(7), key(8))])], now + 2, 0)
    assert st2 == CONFLICT, "a write through pinned detect_packed is invisible"
    flat = CpuConflictSet(key_words=5)
    cs.store_to(flat)
    assert flat._range_max(LONG, LONG + b"\x00") == now
    assert flat._range_max(key(5), key(6)) == now + 1

    cs2 = ShardedTorchConflictSet([key(1000)], key_words=2, h_cap=1 << 10, device="cpu",
                                  bucket_mins=(16, 16, 16))
    cs2.load_from(flat)
    assert cs2._cpu_engines is not None
    [st3] = cs2.detect([TT(now, [(key(5), key(6))], [(key(9), key(10))])], now + 3, 0)
    assert st3 == CONFLICT

    # Unpin: with the window past the long key, the pin lifts at the
    # eighth short batch since it was taken (two ran above).
    v = now + 10
    streak = 2
    while cs._pinned:
        cs.detect([TT(v, [], [(key(20 + streak), key(21 + streak))])], v, v - 1)
        streak += 1
        v += 1
    assert streak == cs.AUTHORITY_HYSTERESIS
    assert cs._stale == [True, True]
    [st4] = cs.detect([TT(v - 2, [(key(20), key(40))], [])], v, v - 2)
    assert st4 == CONFLICT
    assert cs._stale == [False, False]
    assert cs.metrics.counter("device_batches").value == 1
    assert cs.mirror_check()["status"] == "ok"

    cs2.clear(now + 10)
    assert cs2._cpu_engines is None
    [st5] = cs2.detect([TT(now + 11, [(key(5), key(6))], [(key(9), key(10))])],
                       now + 12, now + 10)
    assert st5 == COMMITTED


@pytest.mark.parametrize("seed", [5, 19])
def test_witness_sharded_differential(seed):
    """tests/test_witness.py:227: per-shard witnesses of clipped views,
    translated back to the transaction's own read-range ordinals and
    combined (minimum ordinal, maximum version among its holders), equal a
    per-shard oracle combined by the same rule."""
    from foundationdb_tpu.conflict.oracle import OracleConflictSet

    splits = [key(700), key(1400)]
    stream = random_stream(seed, 8, width=200)
    cs = ShardedTorchConflictSet(splits, key_words=KEY_WORDS, h_cap=1 << 9, device="cpu",
                                 bucket_mins=BUCKETS)
    bounds = list(zip([b""] + splits, splits + [None]))
    engines = [OracleConflictSet() for _ in bounds]
    multi_shard = 0
    for txns, now, nov in stream:
        parts, verdicts = [], []
        for (lo, hi), eng in zip(bounds, engines):
            local, rmap = [], []
            for tr in txns:
                rr, rm = [], []
                for i, (b, e) in enumerate(tr.read_ranges):
                    cb, ce = max(b, lo), e if hi is None else min(e, hi)
                    if cb < ce:
                        rr.append((cb, ce))
                        rm.append(i)
                wr = [(max(b, lo), e if hi is None else min(e, hi)) for b, e in tr.write_ranges]
                wr = [(b, e) for b, e in wr if b < e]
                local.append(JT(read_snapshot=tr.read_snapshot, read_ranges=rr,
                                write_ranges=wr))
                rmap.append(rm)
            verdicts.append(eng.detect(local, now, nov))
            parts.append(_translate_witness(eng.last_witness, rmap))
        statuses = [min(v) for v in zip(*verdicts)]
        want = _combine_witness(parts, statuses)
        assert cs.detect(port_txns(txns), now, nov) == statuses
        assert cs.last_witness == want
        multi_shard += sum(1 for t in range(len(txns))
                           if sum(p[t] is not None for p in parts) > 1)
    assert multi_shard > 0, "no transaction lost in two shards at once"


def test_witness_off():
    cs = make_port(2, witness=False)
    for txns, now, nov in random_stream(2, 3):
        cs.detect(port_txns(txns), now, nov)
        assert cs.last_witness == []


def test_sharded_set_serves_a_real_cluster():
    """tests/test_sharded_resolver.py:229: the reference's SimCluster with
    the port's sharded set as its resolvers' conflict set — a cycle
    workload on the device path, then a write beyond the device key width
    pins authority to the mirrors, then increments and the consistency
    checker pass."""
    from foundationdb_tpu.server import SimCluster
    from foundationdb_tpu.workloads import (
        ConsistencyChecker,
        CycleWorkload,
        IncrementWorkload,
        run_workloads,
    )

    cs = ShardedTorchConflictSet([b"d", b"j", b"q"], key_words=8, h_cap=1 << 12,
                                 device="cpu", bucket_mins=(64, 128, 128))
    calls = {"n": 0}
    orig = cs.detect_packed

    def counting(pb, now, new_oldest):
        calls["n"] += 1
        return orig(pb, now, new_oldest)

    cs.detect_packed = counting
    c = SimCluster(seed=777, n_proxies=2, n_storages=2, conflict_set=cs)
    run_workloads(c, [CycleWorkload(nodes=5, ops=10, actors=2)], timeout_vt=60000.0)
    assert calls["n"] > 0, "the device path never served"
    db = c.database("longkey")

    async def long_write(tr):
        tr.set(b"longkey/" + b"x" * 40, b"v")

    c.run_until(db.process.spawn(db.run(long_write), "lw"), timeout_vt=600.0)
    run_workloads(c, [IncrementWorkload(counters=3, actors=2, ops=8), ConsistencyChecker()],
                  timeout_vt=60000.0, quiet=True)
    assert cs.metrics.counter("long_key_pins").value > 0
    assert cs.metrics.counter("device_batches").value > 0


# ---------------------------------------------------------------------------
# pieces and arguments
# ---------------------------------------------------------------------------


def test_clip_batch_matches_the_host_clip():
    """The device clip of a shard's bounds equals the host clip the mirrors
    use (_clip_txns_for), range by range, and the TooOld read mask is set
    exactly where a read survives."""
    import torch

    from foundationdb_tpu_torch.conflict.engine_torch import PackedBatch

    cs = make_port(4)
    txns = port_txns(random_stream(9, 1, width=900)[0][0])
    pb = PackedBatch.from_transactions(txns, KEY_WORDS, 32, 128, 64)
    dev = lambda a: torch.from_numpy(keylib.to_device_words(np.ascontiguousarray(a.T)).copy())
    for s in range(4):
        rb, re_, wb, we, has_reads = _clip_batch(
            cs._lo[s], cs._hi[s], dev(pb.r_begin), dev(pb.r_end), torch.from_numpy(pb.r_txn),
            dev(pb.w_begin), dev(pb.w_end), 32)
        clipped = cs._clip_txns_for(txns, s)

        def decode(b, e, n):
            out = []
            for i in range(n):
                bk, ek = (keylib.decode_key(keylib.from_device_words(x[:, i].numpy()), KEY_WORDS)
                          for x in (b, e))
                out.append((bk, ek) if bk < ek else None)
            return out

        got_r = [r for r in decode(rb, re_, pb.n_r) if r is not None]
        got_w = [w for w in decode(wb, we, pb.n_w) if w is not None]
        assert got_r == [r for t in clipped for r in t.read_ranges]
        assert got_w == [w for t in clipped for w in t.write_ranges]
        assert has_reads[: len(txns)].tolist() == [bool(t.read_ranges) for t in clipped]


def test_split_keys_and_fits():
    assert uniform_int_split_keys(4, 2000, 8) == [key(500), key(1000), key(1500)]
    assert keylib.uniform_int_split_keys(8, 20_000_000, 4)[0] == (2_500_000).to_bytes(4, "big")
    assert keylib.fits([b"", b"x" * 12], 3) and not keylib.fits([b"x" * 13], 3)


def test_arguments(monkeypatch):
    import torch

    with pytest.raises(ValueError, match="history"):
        make_port(2, history="delta")
    with pytest.raises(ValueError, match="amortized"):
        make_port(2, evict_every=2)
    with pytest.raises(NotImplementedError, match="several devices"):
        ShardedTorchConflictSet([key(5)], devices=["cpu", "meta"])
    one = ShardedTorchConflictSet([key(5)], key_words=KEY_WORDS, h_cap=64, devices=["cpu", "cpu"])
    assert one.device.type == "cpu" and one.n_shards == 2
    assert make_port(2, max_shards=4).device_metrics()["shards"]["max"] == 4
    assert "shard3_breaker_opens" in make_port(2, max_shards=4).metrics.counters
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedTorchConflictSet([key(5)])


def test_replay_is_byte_identical():
    """Same stream and plans, two runs: byte-identical injected logs,
    transitions and metrics (wall seconds are not in a snapshot)."""
    n, tiered, plans, actions, _ = CASES["flat-4"]
    runs = []
    for _ in range(2):
        cs = make_port(n, tiered)
        _obs, final = run(cs, case_stream("flat-4")[:10], port=True, plans=plans,
                          actions=actions)
        runs.append(json.dumps(final, sort_keys=True, default=list))
    assert runs[0] == runs[1]
