"""Live resharding of the port's ShardedTorchConflictSet against the reference's.

The reference's ``ShardedJaxConflictSet.reshard`` runs as
tests/test_torch_sharded.py runs the reference's sharded set: kernels off,
on the 8 virtual CPU devices tests/conftest.py sets up, with ``check_vma``
off for tiered history.  The port runs with ``device="cpu"``.  The same
seeded streams and reshard schedules go through both, and after every
batch and every reshard: verdicts, witnesses, ``last_iters``, each shard's
slice and window, which slices are stale, every counter and gauge, the
``move_log``, ``shard_occupancy()``, ``balance_split_keys(n)`` and
``device_metrics()["shards"]`` are equal.  Verdicts and witnesses are also
held against test_reshard.py's independent ``ReshardingCpuOracle``, whose
reshard re-clips flat rows instead of handing chunks over.

Also: the mirror's handoff pieces against the reference's on the same
contents, a reshard racing a scripted ``reshard`` fault, the reference's
``ShardBalancer`` driving the port's set, the rejected partitions, and the
reference's ``SimCluster`` resharding the port's set through its
Resolver's balancer.  All integers; the tolerance is zero.
"""

import functools
import json

import numpy as np
import pytest

import foundationdb_tpu.parallel.sharded_resolver as jsr
from foundationdb_tpu.conflict import engine_cpu as ref_ec
from foundationdb_tpu.conflict.device_faults import DeviceFaultInjector as RefInjector
from foundationdb_tpu.conflict.types import TransactionConflictInfo as JT
from foundationdb_tpu.flow import set_event_loop
from foundationdb_tpu_torch.conflict import engine_cpu as ec
from foundationdb_tpu_torch.conflict.device_faults import SITES, DeviceFaultInjector
from foundationdb_tpu_torch.parallel.sharded_resolver import (
    ShardedTorchConflictSet,
    uniform_int_split_keys,
)

from test_reshard import KEY_BYTES, N_KEYS, ReshardingCpuOracle, make_key, random_txn
from test_torch_sharded import port_slices, port_txns, ref_slices

pytestmark = pytest.mark.reshard

KEY_WORDS = 3
H_CAP = 1 << 12
BUCKETS = (64, 128, 128)
TIERED = dict(history="tiered", evict_every=3, delta_cap=2048)
TIERED_ENV = {"FDB_TPU_HISTORY": "tiered", "FDB_TPU_EVICT_EVERY": "3",
              "FDB_TPU_DELTA_CAP": "2048"}
MOVED = [make_key(500), make_key(1100), make_key(1500)]
# test_reshard.py:226-231: a boundary move, then 4 -> 6 -> 8 shards.
SCHEDULE = {
    3: MOVED,
    6: uniform_int_split_keys(6, N_KEYS, KEY_BYTES),
    9: uniform_int_split_keys(8, N_KEYS, KEY_BYTES),
}


@pytest.fixture(scope="module", autouse=True)
def _shared_reference_steps():
    """A reference instance builds its shard_map step anew for every mesh
    it reaches (about 5 s of tracing on the virtual devices).
    ``_make_sharded_step`` is pure in its arguments, so this file's
    reference runs share one build per mesh, shape and mode; each
    instance still counts its own retraces."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsr, "_make_sharded_step",
                   functools.lru_cache(maxsize=None)(jsr._make_sharded_step))
        yield


@pytest.fixture(autouse=True)
def _clean_loop():
    yield
    set_event_loop(None)


def make_ref(split, tiered=False):
    import jax

    return jsr.ShardedJaxConflictSet(split, key_words=KEY_WORDS, h_cap=H_CAP,
                                     devices=jax.devices(), bucket_mins=BUCKETS,
                                     max_shards=8)


def make_port(split, tiered=False):
    return ShardedTorchConflictSet(split, key_words=KEY_WORDS, h_cap=H_CAP, device="cpu",
                                   bucket_mins=BUCKETS, max_shards=8,
                                   **(TIERED if tiered else {}))


def reference_env(mp, tiered):
    """The reference's settings for one run (its knobs are environment)."""
    mp.setenv("FDB_TPU_WITNESS", "1")
    if tiered:
        for k, v in TIERED_ENV.items():
            mp.setenv(k, v)
        mp.setattr(jsr, "_SHARD_MAP_KW", {"check_vma": False})


def stream(seed, batches, n_max=40):
    """test_reshard.py's stream: (txns, now, new_oldest) batches."""
    rng = np.random.default_rng(seed)
    now = 100
    out = []
    for _ in range(batches):
        txns = [random_txn(rng, now) for _ in range(int(rng.integers(1, n_max)))]
        now += int(rng.integers(1, 30))
        out.append((txns, now, max(0, now - 120)))
    return out


def observe(cs, port, verdicts=None):
    """Everything compared after a batch (verdicts given) or a reshard."""
    snap = cs.metrics.snapshot()
    dm = cs.device_metrics()
    if port:
        # The host copies the growth and compaction plans read have the
        # device counts' length and values at every step.
        assert cs._hcount_host.tolist() == cs._hcount.tolist()
        assert len(cs._oldest_host) == len(cs._dcount_host) == cs.n_shards
    out = dict(
        n_shards=cs.n_shards, split_keys=list(cs.split_keys), h_cap=cs.h_cap, d_cap=cs.d_cap,
        counters=snap["counters"], gauges=snap["gauges"], stale=[bool(x) for x in cs._stale],
        slices=port_slices(cs) if port else ref_slices(cs),
        move_log=json.loads(json.dumps(cs.move_log)), occupancy=cs.shard_occupancy(),
        balance={n: cs.balance_split_keys(n) for n in (2, 4, 8)},
        shards=dm["shards"], tiers=dm.get("tiers"),
        counts=[np.asarray(cs._hcount).tolist(),
                np.asarray(cs._dcount).tolist() if cs.tiered else None],
    )
    if verdicts is not None:
        out.update(verdicts=[int(v) for v in verdicts], witness=list(cs.last_witness),
                   iters=cs.last_iters)
    return out


def run_schedule(cs, batches, schedule, port, oracle=None):
    obs = []
    for b, (txns, now, nov) in enumerate(batches):
        got = cs.detect(port_txns(txns) if port else txns, now, nov)
        if oracle is not None:
            assert got == oracle.detect(txns, now, nov), f"batch {b}: verdicts"
            assert cs.last_witness == oracle.last_witness, f"batch {b}: witnesses"
        obs.append(observe(cs, port, got))
        new = schedule.get(b)
        if new is not None:
            entry = cs.reshard(new, reason=f"test_b{b}")
            if oracle is not None and entry["action"] != "deferred":
                oracle.reshard(new)
            obs.append(observe(cs, port))
    return obs


def first_difference(want, got):
    for i, (w, g) in enumerate(zip(want, got)):
        for field in w:
            if w[field] != g[field]:
                return f"step {i} {field}: reference {w[field]!r} port {g[field]!r}"
    return None


# ---------------------------------------------------------------------------
# the differential: a move, then 4 -> 6 -> 8 shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,seed", [("flat", 7), ("flat", 11), ("tiered", 23)])
def test_reshard_matches_the_reference(mode, seed):
    tiered = mode == "tiered"
    split = uniform_int_split_keys(4, N_KEYS, KEY_BYTES)
    batches = stream(seed, 12)
    with pytest.MonkeyPatch.context() as mp:
        reference_env(mp, tiered)
        want = run_schedule(make_ref(split, tiered), batches, SCHEDULE, port=False)
    cs = make_port(split, tiered)
    got = run_schedule(cs, batches, SCHEDULE, port=True, oracle=ReshardingCpuOracle(split))
    assert len(got) == len(want) == 15
    assert first_difference(want, got) is None, first_difference(want, got)
    assert [e["action"] for e in cs.move_log] == ["live"] * 3
    assert [e["moved"] for e in cs.move_log] == [[1, 2], list(range(6)), list(range(8))]
    assert [e["reused_mirrors"] for e in cs.move_log] == [2, 0, 0]
    assert cs.n_shards == 8 and len(cs._mirrors) == 8
    # One active-shard mask per pattern, each as long as its pattern.
    assert all(len(k) == v.numel() for k, v in cs._masks.items())
    assert {len(k) for k in cs._masks} == {4, 6, 8}
    # The move left shards 0 and 3 their slices and staled 1 and 2; the
    # next batch rehydrated exactly those two, from the handed-off chunks.
    after_move, next_batch = got[4], got[5]
    assert after_move["stale"] == [False, True, True, False]
    c = next_batch["counters"]
    assert [c[f"shard{s}_rehydrates"] for s in range(4)] == [0, 1, 1, 0]
    assert c["rehydrate_keys_encoded"] < c["rehydrate_keys_total"]
    # Scaling re-stacked the state at the new S and cleared the steps, so
    # the compile site and a retrace came back.
    assert got[-1]["counters"]["retraces"] == 3
    assert got[-1]["counters"]["reshard_moved_shards"] == 2 + 6 + 8
    if tiered:
        assert got[-1]["counters"]["major_compactions"] >= 2
        # The compaction cadence survives a move and restarts at a scale-up.
        since = [o["tiers"]["batches_since_major"] for o in got]
        assert since[4] == since[3] and since[8] == since[12] == 0 < since[7] + since[11]
    assert cs.mirror_check()["status"] == "ok"


def test_a_mirror_kept_at_a_new_index_leaves_its_slice():
    """An unchanged range that lands at another index keeps its mirror but
    not its device slice: the slice at its new index holds another range.
    [500, 1000, 1500] -> [250, 500, 1000] puts old shard 1's range at
    index 2, and the move back puts old shard 2's at index 1."""
    split = uniform_int_split_keys(4, N_KEYS, KEY_BYTES)
    shifted = [make_key(250), make_key(500), make_key(1000)]
    schedule = {2: shifted, 5: split}
    batches = stream(13, 8)
    with pytest.MonkeyPatch.context() as mp:
        reference_env(mp, False)
        want = run_schedule(make_ref(split), batches, schedule, port=False)
    cs = make_port(split)
    got = run_schedule(cs, batches, schedule, port=True, oracle=ReshardingCpuOracle(split))
    assert first_difference(want, got) is None, first_difference(want, got)
    assert [e["reused_mirrors"] for e in cs.move_log] == [1, 1]
    assert got[3]["stale"] == got[7]["stale"] == [True] * 4


@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
def test_a_scale_up_frees_the_old_state_first(tiered, monkeypatch):
    """A change of shard count drops the old stacked tensors before the new
    ones are allocated, so that the two states never hold the device at
    once, and the host copies of the counts take the new length."""
    import weakref

    import torch

    split = uniform_int_split_keys(4, N_KEYS, KEY_BYTES)
    cs = make_port(split, tiered)
    for txns, now, nov in stream(3, 3):
        cs.detect(port_txns(txns), now, nov)
    names = ["_hkeys", "_hvers"] + (["_maxtab", "_dkeys", "_dvers"] if tiered else [])
    old = [weakref.ref(getattr(cs, n)) for n in names]
    alive_at_first_alloc = []
    full = torch.full

    def watched(*a, **kw):
        if not alive_at_first_alloc:
            alive_at_first_alloc.append([r() is not None for r in old])
        return full(*a, **kw)

    monkeypatch.setattr(torch, "full", watched)
    cs.reshard(uniform_int_split_keys(8, N_KEYS, KEY_BYTES))
    monkeypatch.undo()
    assert alive_at_first_alloc == [[False] * len(names)]
    assert cs._hkeys.shape[0] == len(cs._hcount_host) == len(cs._oldest_host) == 8
    assert len(cs._dcount_host) == 8 and cs._stale == [True] * 8
    for txns, now, nov in stream(4, 2):
        cs.detect(port_txns(txns), now, nov)
    assert cs._stale == [False] * 8 and cs.mirror_check()["status"] == "ok"


def test_a_handoff_larger_than_its_slice_grows_every_slice():
    """Two half-full shards merged into one: the moved shard's handed-off
    mirror holds more boundaries than its slice's h_cap, so its rehydrate
    (before the batch's growth plan reads its count) grows every slice,
    as the reference's does."""
    keys = [make_key(i) for i in np.random.default_rng(9).permutation(40_000)[:2400]]
    split = [make_key(20_000)]
    batches, now = [], 100
    for b in range(20):
        ks = keys[b * 120 : (b + 1) * 120]
        txns = [JT(now, [], [(k, k + b"\x00") for k in ks[2 * t : 2 * t + 2]])
                for t in range(60)]
        now += 1
        batches.append((txns, now, 0))
    schedule = {18: [make_key(39_990)]}
    with pytest.MonkeyPatch.context() as mp:
        reference_env(mp, False)
        want = run_schedule(make_ref(split), batches, schedule, port=False)
    cs = make_port(split)
    got = run_schedule(cs, batches, schedule, port=True)
    assert first_difference(want, got) is None, first_difference(want, got)
    before, after = got[18], got[-1]
    assert before["h_cap"] == H_CAP and after["h_cap"] > H_CAP
    assert sum(before["occupancy"]) > H_CAP and after["counters"]["grows"] == 1
    assert after["counters"]["shard0_rehydrates"] == 1


# ---------------------------------------------------------------------------
# the mirror's handoff pieces
# ---------------------------------------------------------------------------


def _mirrors(chunk=4):
    """A port mirror and a reference mirror with the same contents, many
    small chunks."""
    port = ec.CpuConflictSet(0, chunk=chunk, key_words=KEY_WORDS)
    ref = ref_ec.CpuConflictSet(0, chunk=chunk, key_words=KEY_WORDS)
    rng = np.random.default_rng(3)
    for now in range(10, 130, 10):
        ranges = []
        for _ in range(12):
            a = int(rng.integers(0, N_KEYS))
            ranges.append((make_key(a), make_key(a + 1 + int(rng.integers(0, 9)))))
        port.apply_batch([ec.TransactionConflictInfo(0, [], ranges)], [ec.COMMITTED], now,
                         max(0, now - 60))
        ref.apply_batch([JT(0, [], ranges)], [ref_ec.COMMITTED], now, max(0, now - 60))
    assert (port.keys, port.vers) == (ref.keys, ref.vers) and port.chunk_count > 8
    return port, ref


def _flat(chunks):
    return [(k, v) for ch in chunks for k, v in zip(ch.keys, ch.vers)]


def test_boundary_views_match_the_reference():
    port, ref = _mirrors()
    assert port.boundary_count == ref.boundary_count
    assert [port.boundary_key_at(i) for i in range(port.boundary_count)] == port.keys
    assert [ref.boundary_key_at(i) for i in range(ref.boundary_count)] == port.keys
    probes = sorted(set(port.keys[::3]) | {make_key(i) for i in range(0, N_KEYS + 50, 37)})
    for side in ("left", "right"):
        assert ([port.boundary_locate(k, side) for k in probes]
                == [ref.boundary_locate(k, side) for k in probes]), side
    with pytest.raises(IndexError):
        port.boundary_key_at(port.boundary_count)


@pytest.mark.parametrize("lo,hi", [(b"", make_key(700)), (make_key(333), make_key(1444)),
                                   (make_key(1200), None), (make_key(5000), None)])
def test_slice_and_handoff_match_the_reference(lo, hi):
    port, ref = _mirrors()
    ps, rs = port.snapshot(), ref.snapshot()
    floor, chunks = ec.slice_snapshot_chunks(ps, lo, hi)
    rfloor, rchunks = ref_ec.slice_snapshot_chunks(rs, lo, hi)
    assert (floor, _flat(chunks)) == (rfloor, _flat(rchunks))
    # Interior chunks are adopted by reference; only the cut ones are new.
    src = {id(ch) for ch in ps.chunks}
    inner = [ch for ch in chunks if id(ch) in src]
    assert len(inner) >= len(chunks) - 2
    if hi is not None and lo < make_key(1000):
        assert inner
    # A new shard over [lo, hi) from two cuts split at a moved point.
    mid = make_key(900) if hi is None or hi > make_key(900) else hi
    parts = [(ps, lo, mid), (ps, mid, hi)] if lo < mid else [(ps, lo, hi)]
    rparts = [(rs, a, b) for _s, a, b in parts]
    eng = ec.engine_from_handoff(parts, 55, chunk=4, key_words=KEY_WORDS)
    reng = ref_ec.engine_from_handoff(rparts, 55, chunk=4, key_words=KEY_WORDS)
    assert (eng.keys, eng.vers, eng.oldest_version) == (reng.keys, reng.vers, 55)
    assert eng.boundary_count == reng.boundary_count
    assert {id(ch) for ch in eng.snapshot().chunks} & src == {
        id(ch) for ch in eng.snapshot().chunks[1:] if id(ch) in src}


# ---------------------------------------------------------------------------
# a reshard racing a scripted fault; the balancer; rejected partitions
# ---------------------------------------------------------------------------


def _fault_race(cs, port):
    """test_reshard.py:261: shard 1's first reshard check faults, the move
    at batch 3 defers, the retry at batch 5 completes."""
    inj = DeviceFaultInjector() if port else RefInjector()
    inj.script("reshard", at=1, shard=1)
    cs.install_fault_injector(inj)
    split = list(cs.split_keys)
    verdicts, entries = [], []
    for b, (txns, now, nov) in enumerate(stream(5, 8, n_max=30)):
        verdicts.append([int(v) for v in cs.detect(port_txns(txns) if port else txns, now, nov)])
        verdicts.append(list(cs.last_witness))
        if b in (3, 5):
            entries.append(cs.reshard(MOVED, reason="race" if b == 3 else "retry"))
            if b == 3:
                assert cs.split_keys == split
    return json.dumps({
        "move_log": cs.move_log, "entries": entries, "injected": inj.injected,
        "verdicts": verdicts, "walks": [list(b.transitions) for b in cs._breakers],
        "counters": cs.metrics.snapshot()["counters"],
    }, sort_keys=True, default=str)


def test_reshard_fault_defers_and_replays():
    assert "reshard" in SITES
    split = uniform_int_split_keys(4, N_KEYS, KEY_BYTES)
    with pytest.MonkeyPatch.context() as mp:
        reference_env(mp, False)
        want = _fault_race(make_ref(split), port=False)
    got = _fault_race(make_port(split), port=True)
    assert got == want
    assert _fault_race(make_port(split), port=True) == got, "not replayable"
    doc = json.loads(got)
    deferred, retry = doc["move_log"]
    assert deferred["action"] == "deferred" and deferred["fault_shard"] == 1
    assert retry["action"] in ("live", "degraded_on_mirror")
    assert [site for _q, site, _k in doc["injected"]] == ["reshard#s1"]
    c = doc["counters"]
    assert c["reshard_deferred"] == 1 and c["shard1_faults_reshard"] == 1
    assert c["reshards"] == 1


def _balanced(cs):
    """test_reshard.py:318: 30 skewed batches, the balancer ticked after
    each, pressure high over ticks 10-19."""
    import random

    from foundationdb_tpu.server.resolver_balancer import ShardBalancer

    bal = ShardBalancer(cs, ratio=1.5, hysteresis=2, cooldown=2, min_boundaries=16,
                        scale_up_pressure=0.8)
    rng = random.Random(7)
    port = isinstance(cs, ShardedTorchConflictSet)
    T = ec.TransactionConflictInfo if port else JT
    now = 100
    verdicts = []
    for b in range(30):
        txns = []
        for _ in range(24):
            lo = rng.randrange(0, 200 if rng.random() < 0.8 else N_KEYS)
            w = [(make_key(lo), make_key(lo + rng.randrange(1, 8)))]
            txns.append(T(read_snapshot=max(0, now - 5), read_ranges=list(w),
                          write_ranges=list(w)))
        now += 1
        verdicts.append(cs.detect(txns, now, max(0, now - 50)))
        bal.evaluate(pressure=0.9 if 10 <= b < 20 else 0.2)
    return bal, verdicts


def test_balancer_drives_the_port_as_the_reference():
    split = uniform_int_split_keys(2, N_KEYS, KEY_BYTES)
    with pytest.MonkeyPatch.context() as mp:
        reference_env(mp, False)
        ref = make_ref(split)
        want_bal, want_verdicts = _balanced(ref)
    cs = make_port(split)
    bal, verdicts = _balanced(cs)
    assert verdicts == want_verdicts
    assert bal.decisions_json() == want_bal.decisions_json()
    assert json.dumps(cs.move_log, sort_keys=True) == json.dumps(ref.move_log, sort_keys=True)
    actions = [d["action"] for d in bal.decisions]
    assert "scale" in actions and "cooldown" in actions, actions
    assert cs.n_shards == ref.n_shards > 2
    assert cs.mirror_check()["status"] == "ok"


@pytest.mark.parametrize("keys", [
    [make_key(500), b"x" * 13],                 # wider than key_words=3 holds
    [make_key(900), make_key(500)],             # not increasing
    [make_key(500), b""],                       # an empty key
    uniform_int_split_keys(9, N_KEYS, KEY_BYTES),  # 9 shards over max_shards=8
], ids=["too-wide", "not-increasing", "empty", "over-max-shards"])
def test_rejected_partitions_raise_as_the_reference(keys):
    split = uniform_int_split_keys(4, N_KEYS, KEY_BYTES)
    with pytest.raises((ValueError, AssertionError)) as want:
        make_ref(split).reshard(keys)
    cs = make_port(split)
    with pytest.raises(want.type) as got:
        cs.reshard(keys)
    assert str(got.value) == str(want.value)
    assert cs.split_keys == split and cs.move_log == []


# ---------------------------------------------------------------------------
# the reference's cluster, resharding the port's set
# ---------------------------------------------------------------------------


def test_cluster_balancer_reshards_the_port(monkeypatch):
    """The reference's Resolver starts its shard balancer when its conflict
    set has a callable ``reshard``: with every workload key in shard 0 the
    balancer moves the split points into that range while a cycle workload
    runs, and the consistency check passes."""
    from foundationdb_tpu.server import SimCluster
    from foundationdb_tpu.server.status import cluster_status
    from foundationdb_tpu.workloads import ConsistencyChecker, CycleWorkload, run_workloads

    monkeypatch.setenv("FDB_TPU_SHARD_BALANCE_SECONDS", "0.1")
    cs = ShardedTorchConflictSet([b"\xf0", b"\xf4", b"\xf8"], key_words=8, h_cap=1 << 12,
                                 device="cpu", bucket_mins=(64, 128, 128))
    c = SimCluster(seed=41, conflict_set=cs)
    run_workloads(c, [CycleWorkload(nodes=40, ops=20, actors=2), ConsistencyChecker()],
                  timeout_vt=60000.0, quiet=True)
    live = [e for e in cs.move_log if e["action"] == "live"]
    assert live, cs.move_log
    assert cs.split_keys[0] < b"\xf0"
    # Batches ran on the new partition: its moved slices were rebuilt.
    counters = cs.metrics.snapshot()["counters"]
    assert all(counters[f"shard{s}_rehydrates"] > 0 for s in live[0]["moved"]), counters
    shards = cluster_status(c)["cluster"]["qos"]["shards"]
    [block] = shards.values()
    assert block["last_move"] == cs.move_log[-1] and block["moves"] == len(cs.move_log)
    assert block["balancer_ticks"] > 0
