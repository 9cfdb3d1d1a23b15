"""The port's witness-free step against the reference's FDB_TPU_WITNESS=0.

With the witness off the reference runs another program: its step skips
the final stabbing that feeds the abort witness and the witness vectors,
its readbacks decode nothing, and every engine's ``last_witness`` stays
``[]``, after a CPU fallback too.  The same seeded streams go through the
port's ``witness=False`` (``TorchConflictSet``, ``ShardedTorchConflictSet``
and ``ConflictSet``, on the CPU) and the reference under
``monkeypatch.setenv("FDB_TPU_WITNESS", "0")`` (each reference engine reads
the knob when it is built, so it is built after the setenv), flat and
tiered: verdicts, exported state, counters and ``last_witness == []``.
Each stream holds one batch whose intra-batch fixpoint overflows its
residual domain, which forces the CPU fallback (in the sharded set, the
re-decide on the shard mirrors), and the sharded run has one shard served
by its mirror for a batch.

Also the repair itself (ROADMAP F5): with the witness off the port runs
one ``stabbing_min`` fewer a batch (one fewer a shard in the sharded set),
never calls ``decode_witness``, and reads back ``_HEAD + txn_cap`` words.

Shapes: key_words=3, bucket_mins=(32, 128, 64) (every batch packs to one
bucket, so each reference engine compiles once).  All integers; the
tolerance is zero.
"""

import numpy as np
import pytest

import foundationdb_tpu.parallel.sharded_resolver as jsr
from foundationdb_tpu.conflict.api import ConflictSet as RefConflictSet
from foundationdb_tpu.conflict.engine_cpu import CpuConflictSet as RefCpu
from foundationdb_tpu.conflict.engine_jax import JaxConflictSet
from foundationdb_tpu.conflict.types import TransactionConflictInfo as JT
from foundationdb_tpu.flow import set_event_loop
from foundationdb_tpu_torch.conflict import engine_torch as et
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.engine_cpu_flat import FlatCpuConflictSet
from foundationdb_tpu_torch.conflict.engine_torch import TorchConflictSet

from test_torch_sharded import (
    BUCKETS,
    TIERED,
    TIERED_ENV,
    _first_difference,
    key,
    make_port,
    make_ref,
    port_txns,
    random_stream,
    run,
)

KEY_WORDS = 3
H_CAP = 1 << 10
ENGINE_COUNTERS = ("batches", "transactions", "fixpoint_rounds", "grows", "rebases",
                   "cpu_fallbacks", "retraces", "major_compactions")


@pytest.fixture(autouse=True)
def _witness_off(monkeypatch):
    monkeypatch.setenv("FDB_TPU_WITNESS", "0")
    yield
    set_event_loop(None)


def overflow_batch(snapshot):
    """32 txns that overflow the fixpoint's residual domain (64 rows at
    this bucket): txn t reads key t and writes key t + 1, so after round 2
    txns 2-31 stay undecided, and each reads two more private ranges, 90
    residual reads in all.  The keys lie in [0, 200), shard 0 of every
    split here."""
    return [JT(read_snapshot=snapshot,
               read_ranges=[(key(t), key(t + 1)), (key(100 + 2 * t), key(101 + 2 * t)),
                            (key(101 + 2 * t), key(102 + 2 * t))],
               write_ranges=[(key(t + 1), key(t + 2))])
            for t in range(32)]


def witness_free_stream(seed, batches=10, at=5):
    """random_stream's batches (each packing to BUCKETS) with the overflow
    batch in place of batch `at`."""
    stream = random_stream(seed, batches)
    _txns, now, nov = stream[at]
    stream[at] = (overflow_batch(stream[at - 1][1]), now, nov)
    return stream


def _export(cs, port):
    out = FlatCpuConflictSet() if port else RefCpu()
    cs.store_to(out)
    return list(out.keys), list(out.vers), out.oldest_version


def _engine_counters(cs):
    c = cs.metrics.snapshot()["counters"]
    return {name: c.get(name, 0) for name in ENGINE_COUNTERS}


@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
def test_engine_matches_the_reference_with_the_witness_off(monkeypatch, tiered):
    kw = dict(key_words=KEY_WORDS, h_cap=H_CAP, bucket_mins=BUCKETS)
    if tiered:
        for name, value in TIERED_ENV.items():
            monkeypatch.setenv(name, value)
    jcs = JaxConflictSet(**kw)
    assert not jcs._witness and jcs.tiered == tiered
    tcs = TorchConflictSet(device="cpu", witness=False, **(TIERED if tiered else {}), **kw)
    for i, (txns, now, nov) in enumerate(witness_free_stream(3)):
        want = jcs.detect(txns, now, nov)
        assert tcs.detect(port_txns(txns), now, nov) == want, i
        assert jcs.last_witness == [] and tcs.last_witness == [], i
        assert tcs.last_iters == jcs.last_iters, i
        assert _export(tcs, True) == _export(jcs, False), i
        assert _engine_counters(tcs) == _engine_counters(jcs), i
    counters = _engine_counters(tcs)
    assert counters["cpu_fallbacks"] == 1
    if tiered:
        assert counters["major_compactions"] >= 3
    if not tiered:
        keys, vers, n, oldest, base = tcs.export_state()
        assert (keys == np.asarray(jcs._hkeys)).all() and (vers == np.asarray(jcs._hvers)).all()
        assert (n, oldest, base) == (int(jcs._hcount), int(jcs._oldest), jcs._base)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("history", ["flat", "tiered"])
def test_conflict_set_matches_the_reference_with_the_witness_off(monkeypatch, history,
                                                                 depth):
    """ConflictSet(witness=False) against the reference's ConflictSet(
    backend="jax") under FDB_TPU_WITNESS=0: the overflow batch is the
    engine's CPU fallback at depth 1 and the mirror's replay at depth 2."""
    monkeypatch.setenv("FDB_TPU_PIPELINE_DEPTH", str(depth))
    kw = dict(key_words=KEY_WORDS, h_cap=H_CAP, bucket_mins=BUCKETS)
    port_kw = {}
    if history == "tiered":
        for name, value in TIERED_ENV.items():
            monkeypatch.setenv(name, value)
        port_kw = TIERED
    ref = RefConflictSet(backend="jax", **kw)
    cs = ConflictSet(device="cpu", pipeline_depth=depth, witness=False, **port_kw, **kw)
    assert cs._dev.witness is False and cs._dev.tiered == ref._jax.tiered
    for i, (txns, now, nov) in enumerate(witness_free_stream(5)):
        want = ref.pipeline_submit(txns, now, nov)
        got = cs.pipeline_submit(port_txns(txns), now, nov)
        while ref.pipeline_inflight > depth - 1:
            ref.pipeline_complete_oldest()
        while cs.pipeline_inflight > depth - 1:
            cs.pipeline_complete_oldest()
        if i == 9:
            ref.pipeline_drain()
            cs.pipeline_drain()
        assert got.done == want.done, i
        if want.done:
            assert list(got.statuses) == list(want.statuses), i
            assert got.witness == want.witness == [], i
        assert cs.last_witness == ref.last_witness == [], i
        assert cs._dev.last_witness == [] and ref._jax.last_witness == [], i
    assert _export(cs._dev, True) == _export(ref._jax, False)
    assert (list(cs._cpu.keys), list(cs._cpu.vers)) == (list(ref._cpu.keys), list(ref._cpu.vers))
    pc, rc = cs.device_metrics()["counters"], ref.device_metrics()["counters"]
    for name in ENGINE_COUNTERS + ("pipeline_dispatches", "pipeline_replayed_batches",
                                   "rehydrates", "device_faults"):
        assert pc.get(name, 0) == rc.get(name, 0), name
    # The overflow batch was re-decided on the host: by the engine's own
    # fallback at depth 1, by the mirror's replay at depth 2.
    assert pc["cpu_fallbacks"] == 1
    assert cs.mirror_check()["status"] == "ok"


@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
def test_sharded_matches_the_reference_with_the_witness_off(monkeypatch, tiered):
    """ShardedTorchConflictSet(witness=False) against the reference's
    ShardedJaxConflictSet under FDB_TPU_WITNESS=0 at 2 shards: every
    batch's observation (verdicts, last_witness, iterations, each shard's
    slice, counters, gauges, backend signal) and the final metrics and
    export.  Shard 1's dispatch is down for two checks (a mixed batch and a
    mirror-served one) and the overflow batch re-decides on the mirrors."""
    if tiered:
        for name, value in TIERED_ENV.items():
            monkeypatch.setenv(name, value)
        monkeypatch.setattr(jsr, "_SHARD_MAP_KW", {"check_vma": False})
    plans = [("dispatch", 3, 2, 1)]
    stream = witness_free_stream(9, batches=12, at=7)
    ref = make_ref(2, tiered)
    assert not ref._witness
    want_obs, want = run(ref, stream, port=False, plans=plans)
    cs = make_port(2, tiered, witness=False)
    got_obs, got = run(cs, stream, port=True, plans=plans)
    assert _first_difference(want_obs, got_obs) is None, _first_difference(want_obs, got_obs)
    assert all(o["witness"] == [] for o in got_obs)
    assert got["metrics"] == want["metrics"]
    assert got["export"] == want["export"]
    assert got["injected"] == want["injected"] and want["injected"]
    c = got["metrics"]["counters"]
    assert c["cpu_fallbacks"] == 1 and c["degraded_shard_serves"] > 0
    assert cs._last_witness_dev is None


# ---------------------------------------------------------------------------
# F5: the witness-free program does no witness work
# ---------------------------------------------------------------------------


def _counting(monkeypatch):
    """Count the engine's calls of decode_witness and stabbing_min (the
    names engine_torch binds from ops.stabbing and its own module)."""
    calls = {"decode": 0, "stab": 0}
    real_decode, real_stab = et.decode_witness, et.stabbing_min

    def decode(*args):
        calls["decode"] += 1
        return real_decode(*args)

    def stab(*args):
        calls["stab"] += 1
        return real_stab(*args)

    monkeypatch.setattr(et, "decode_witness", decode)
    monkeypatch.setattr(et, "stabbing_min", stab)
    return calls


@pytest.mark.parametrize("history", ["flat", "tiered"])
def test_witness_free_step_skips_the_witness_work(monkeypatch, history):
    """ROADMAP F5: before the repair TorchConflictSet took no witness
    argument and always ran the witness's stabbing, vectors, readback and
    decode.  Off, a batch runs exactly one stabbing_min fewer, decodes
    nothing and reads back _HEAD + txn_cap words; on, the readback carries
    both vectors and every batch is decoded."""
    calls = _counting(monkeypatch)
    stream = random_stream(21, 8)
    runs = {}
    for witness in (True, False):
        tcs = TorchConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, device="cpu",
                               bucket_mins=BUCKETS, history=history, witness=witness)
        per_batch, verdicts = [], []
        for txns, now, nov in stream:
            calls.update(decode=0, stab=0)
            ticket = tcs.dispatch_txns(port_txns(txns), now, nov)
            tc = ticket.pb.txn_cap
            assert ticket.out.shape[0] == et._HEAD + (3 if witness else 1) * tc
            verdicts.append(list(tcs.readback_packed(ticket)))
            per_batch.append(dict(calls))
            assert (tcs.last_witness == []) != witness
        runs[witness] = per_batch, verdicts, tcs.fixpoint_rounds
    (on, v_on, rounds_on), (off, v_off, rounds_off) = runs[True], runs[False]
    assert v_on == v_off and rounds_on == rounds_off
    assert all(b["decode"] == 1 for b in on)
    assert all(b["decode"] == 0 for b in off)
    assert [b["stab"] - 1 for b in on] == [b["stab"] for b in off]


def test_witness_free_sets_skip_the_witness_work(monkeypatch):
    """ConflictSet(witness=False) builds a witness-free engine (before the
    repair it only dropped the list after a decode), and the sharded set
    runs one stabbing_min fewer a shard a batch, keeps no device witness
    and decodes nothing."""
    calls = _counting(monkeypatch)
    stream = random_stream(22, 6)
    cs = ConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, device="cpu", bucket_mins=BUCKETS,
                     witness=False)
    for txns, now, nov in stream:
        batch = cs.new_batch()
        for tr in port_txns(txns):
            batch.add_transaction(tr)
        batch.detect_conflicts(now, nov)
    assert calls["decode"] == 0 and cs.last_witness == []
    assert cs._dev.witness is False and cs._dev.batches == len(stream)
    stabs = {}
    for witness in (True, False):
        calls.update(decode=0, stab=0)
        s = make_port(2, witness=witness)
        for txns, now, nov in stream:
            s.detect(port_txns(txns), now, nov)
        stabs[witness] = calls["stab"]
        assert (calls["decode"] == 0) != witness
        assert (s._last_witness_dev is None) != witness
        assert s.metrics.counter("device_batches").value == len(stream)
    assert stabs[True] - stabs[False] == 2 * len(stream)
