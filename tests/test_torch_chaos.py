"""The port's random (buggify) fault mode against the reference's.

The port keeps its own ``flow.rng.DeterministicRandom`` and ``flow.buggify``
(it imports nothing of the reference), and its ``DeviceFaultInjector``
consults the port's buggify module.  Held equal, exactly, to the reference:

- the RNG draw for draw (``split`` chains included) and buggify's fires
  and coverage;
- the random-mode injector's log over a 60-check site sequence, with and
  without ``shard=`` (twin of tests/test_device_faults.py:141);
- the port's ``ConflictSet(device="cpu")`` under random faults against the
  reference's ``ConflictSet(backend="jax")`` at seeds 3, 5 and 9 (twin of
  :202), and ``ShardedTorchConflictSet`` against ``ShardedJaxConflictSet``
  at 4 shards: verdicts, witnesses, injected logs, breaker walks and
  counters, and both equal to the CPU-only run;
- the reference's ``DeviceChaosWorkload`` with RandomClogging, Cycle and
  Serializability served through the port's set (twin of :460).

Two buggify modules serve one simulation in the chaos run: the
reference's (its own sites, enabled by ``SimCluster`` on the loop's RNG)
and the port's (the device sites), enabled here on the same RNG object, so
every site draws from the stream where the reference's single module
draws.  The workload imports the reference's ``DeviceFaultInjector`` by
name when it starts; the port's engine absorbs only the port's faults, so
the test substitutes the port's class for that name with ``monkeypatch``.
"""

import importlib
import json

import pytest

from foundationdb_tpu.conflict import device_faults as ref_faults
from foundationdb_tpu.conflict.engine_cpu import CpuConflictSet as RefCpu
from foundationdb_tpu.flow import set_event_loop
from foundationdb_tpu.flow.knobs import g_knobs
from foundationdb_tpu.flow.metrics import MetricsRegistry as RefRegistry
from foundationdb_tpu.flow.rng import DeterministicRandom as RefRandom
from foundationdb_tpu_torch.conflict import device_faults as port_faults
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.device_faults import DeviceFault, DeviceFaultInjector
from foundationdb_tpu_torch.flow import buggify
from foundationdb_tpu_torch.flow.rng import DeterministicRandom
from foundationdb_tpu_torch.metrics import MetricsRegistry

from test_torch_api import _counters, _port_txns, _random_stream
from test_sharded_resolver import MultiResolverCpuOracle
from test_torch_sharded import make_port, make_ref, observe, port_txns, random_stream, split_for

# The reference's flow package exports a function named `buggify` that
# hides the module of that name from attribute imports.
ref_buggify = importlib.import_module("foundationdb_tpu.flow.buggify")
SITES = ("dispatch", "grow", "compile", "rebase")


@pytest.fixture(autouse=True)
def _clean_buggify_and_loop():
    yield
    ref_buggify.set_buggify_enabled(False)
    buggify.set_buggify_enabled(False)
    set_event_loop(None)


@pytest.fixture
def arm_every_site():
    """The reference reads its activation probability from a knob; the
    tests that need every site armed set it to 1.0 there and pass 1.0 to
    the port's set_buggify_enabled."""
    old = g_knobs.flow.buggify_activated_probability
    g_knobs.flow.buggify_activated_probability = 1.0
    yield 1.0
    g_knobs.flow.buggify_activated_probability = old


# ---------------------------------------------------------------------------
# the RNG and buggify
# ---------------------------------------------------------------------------


def _draws(rng, depth=3):
    """A run of every kept method, then the same of a split child, `depth`
    splits deep."""
    out = []
    for i in range(40):
        out.append(rng.random01())
        out.append(rng.random_int(-5, 7 + i))
        out.append(rng.random_int64(0, 1 << 62))
        out.append(rng.coinflip())
        out.append(rng.random_choice("abcdefgh"))
        seq = list(range(i % 9))
        rng.random_shuffle(seq)
        out.append(seq)
    if depth:
        out.append(_draws(rng.split(), depth - 1))
    out.append(rng.random01())
    return out


@pytest.mark.parametrize("seed", [0, 1, 424242, 2**40 + 3])
def test_rng_matches_the_reference_draw_for_draw(seed):
    assert _draws(DeterministicRandom(seed)) == _draws(RefRandom(seed))
    with pytest.raises(ValueError):
        DeterministicRandom(seed).random_int(3, 3)


@pytest.mark.parametrize("activated", [0.25, 0.7, 1.0])
def test_buggify_matches_the_reference(activated):
    """The same sites evaluated in the same order on same-seed streams fire
    alike, leave the streams at the same point and report the same
    coverage; publish_coverage writes the same gauges."""
    old = g_knobs.flow.buggify_activated_probability
    g_knobs.flow.buggify_activated_probability = activated
    try:
        ref_rng, rng = RefRandom(17), DeterministicRandom(17)
        ref_buggify.set_buggify_enabled(True, ref_rng)
        buggify.set_buggify_enabled(True, rng, activated_probability=activated)
        fires = []
        for i in range(300):
            site = f"site{i % 13}"
            if i % 3:
                fires.append((ref_buggify.buggify(site), buggify.buggify(site)))
            else:
                p = (i % 7) / 7
                fires.append((ref_buggify.buggify_with_prob(site, p),
                              buggify.buggify_with_prob(site, p)))
        assert all(a == b for a, b in fires) and any(a for a, _ in fires)
        assert rng.random01() == ref_rng.random01()
        assert buggify.coverage() == ref_buggify.coverage()
        reg, ref_reg = MetricsRegistry("BuggifyCoverage"), RefRegistry("BuggifyCoverage")
        assert buggify.publish_coverage(reg) == ref_buggify.publish_coverage(ref_reg)
        assert reg.snapshot()["gauges"] == ref_reg.snapshot()["gauges"]
    finally:
        g_knobs.flow.buggify_activated_probability = old
    buggify.set_buggify_enabled(False)
    assert not buggify.buggify("site0") and buggify.coverage()["sites_seen"] == 0


# ---------------------------------------------------------------------------
# the random-mode injector
# ---------------------------------------------------------------------------


def _checks(inj, faults, seq_len=60, shards=None):
    """tests/test_device_faults.py:141's site sequence, optionally spread
    over shards; returns each check's outcome."""
    out = []
    for i in range(seq_len):
        site = SITES[i % 4]
        shard = None if shards is None else (i // 4) % shards
        try:
            inj.check(site, shard=shard)
            out.append(None)
        except faults.DeviceFault as e:
            out.append((type(e).__name__, e.site))
    return out


@pytest.mark.parametrize("shards", [None, 3])
@pytest.mark.parametrize("seed", [3, 5, 7])
@pytest.mark.parametrize("port_rng", [True, False], ids=["port-rng", "reference-rng"])
def test_random_mode_log_matches_the_reference(seed, shards, port_rng, arm_every_site):
    """The injected log and each check's outcome equal the reference's;
    the injector's rng may be either package's DeterministicRandom."""
    ref_buggify.set_buggify_enabled(True, RefRandom(seed))
    ref = ref_faults.DeviceFaultInjector(rng=RefRandom(seed + 1), fire_probability=0.5)
    want = _checks(ref, ref_faults, shards=shards)
    buggify.set_buggify_enabled(True, DeterministicRandom(seed),
                                activated_probability=arm_every_site)
    rng = DeterministicRandom(seed + 1) if port_rng else RefRandom(seed + 1)
    inj = DeviceFaultInjector(rng=rng, fire_probability=0.5)
    got = _checks(inj, port_faults, shards=shards)
    assert got == want
    assert inj.injected == ref.injected and inj.injected
    assert inj.checks == ref.checks
    assert buggify.coverage() == ref_buggify.coverage()
    kinds = {kind for _seq, _site, kind in inj.injected}
    assert kinds == {"transient", "persistent"}
    # A shard's stream is forked at its first fire, as the reference forks.
    assert sorted(inj._shard_rngs) == sorted(ref._shard_rngs)
    assert bool(inj._shard_rngs) == bool(shards)


def test_default_injector_never_draws():
    """With the defaults random mode is off: an enabled buggify stream is
    left untouched and only plans fault."""
    rng = DeterministicRandom(1)
    buggify.set_buggify_enabled(True, rng, activated_probability=1.0)
    inj = DeviceFaultInjector()
    inj.script("dispatch", at=2)
    assert _checks(inj, port_faults, seq_len=12) == (
        [None] * 4 + [("DeviceUnavailable", "dispatch")] + [None] * 7)
    assert rng.random01() == DeterministicRandom(1).random01()
    assert buggify.coverage()["sites_seen"] == 0


def test_scripted_plans_take_precedence_over_random_mode():
    """A check a plan or an outage faults never consults its buggify site
    (the reference's order): under an outage the stream is untouched."""
    rng = DeterministicRandom(2)
    buggify.set_buggify_enabled(True, rng, activated_probability=1.0)
    inj = DeviceFaultInjector(rng=DeterministicRandom(3), fire_probability=1.0)
    inj.begin_outage("dispatch")
    for _ in range(5):
        with pytest.raises(DeviceFault):
            inj.check("dispatch")
    assert [k for _q, _s, k in inj.injected] == ["outage"] * 5
    assert rng.random01() == DeterministicRandom(2).random01()


# ---------------------------------------------------------------------------
# ConflictSet under random faults (twin of tests/test_device_faults.py:202)
# ---------------------------------------------------------------------------


def _drive_sync(cs, stream, port):
    out = []
    for txns, now, nov in stream:
        b = cs.new_batch()
        for t in (_port_txns(txns) if port else txns):
            b.add_transaction(t)
        out.append((b.detect_conflicts(now, nov), list(cs.last_witness)))
    return out


def _cpu_only(stream):
    cpu = RefCpu()
    return [(cpu.detect(txns, now, nov), list(cpu.last_witness)) for txns, now, nov in stream]


@pytest.mark.parametrize("seed", [3, 5, 9])
def test_random_faults_conflict_set_match_the_reference(seed, arm_every_site):
    from foundationdb_tpu.conflict.api import ConflictSet as RefConflictSet

    stream = _random_stream(seed, 60, 14, 8)
    ref_buggify.set_buggify_enabled(True, RefRandom(seed))
    rinj = ref_faults.DeviceFaultInjector(rng=RefRandom(seed * 7 + 1), fire_probability=0.3)
    ref = RefConflictSet(backend="jax", key_words=3, bucket_mins=(32, 128, 64), h_cap=1 << 10,
                         fault_injector=rinj)
    want = _drive_sync(ref, stream, port=False)

    def port_run():
        buggify.set_buggify_enabled(True, DeterministicRandom(seed),
                                    activated_probability=arm_every_site)
        inj = DeviceFaultInjector(rng=DeterministicRandom(seed * 7 + 1), fire_probability=0.3)
        cs = ConflictSet(device="cpu", key_words=3, bucket_mins=(32, 128, 64), h_cap=1 << 10,
                         fault_injector=inj)
        return cs, inj, _drive_sync(cs, stream, port=True)

    cs, inj, got = port_run()
    assert got == want == _cpu_only(stream)
    assert inj.injected == rinj.injected and inj.injected
    pm, rm = cs.device_metrics(), ref.device_metrics()
    assert json.dumps(pm["breaker"]) == json.dumps(rm["breaker"])
    assert _counters(cs) == _counters(ref)
    assert pm["counters"]["device_faults"] == len(inj.injected)
    assert buggify.coverage() == ref_buggify.coverage()
    # "skipped" while the breaker is open or the device stale, as there.
    status = cs.mirror_check()["status"]
    assert status == ref.mirror_check()["status"] and status in ("ok", "skipped")
    # A same-seed replay gives the same log, walk and verdicts.
    cs2, inj2, got2 = port_run()
    assert got2 == got and inj2.injected == inj.injected
    assert json.dumps(cs2.device_metrics()["breaker"]) == json.dumps(pm["breaker"])


# ---------------------------------------------------------------------------
# the sharded set under random faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 5, 9])
def test_random_faults_sharded_set_match_the_reference(seed, arm_every_site):
    """4 shards, flat: every shard's sites draw from the shared buggify
    stream and their persistence from a per-shard fork; per-shard logs,
    breaker walks, verdicts, witnesses and every batch's observation equal
    the reference's, and the verdicts equal independent per-shard CPU
    engines'."""
    n = 4
    stream = random_stream(seed, 16)

    def run(cs, port):
        if port:
            buggify.set_buggify_enabled(True, DeterministicRandom(seed),
                                        activated_probability=arm_every_site)
            inj = DeviceFaultInjector(rng=DeterministicRandom(seed + 11), fire_probability=0.25)
        else:
            ref_buggify.set_buggify_enabled(True, RefRandom(seed))
            inj = ref_faults.DeviceFaultInjector(rng=RefRandom(seed + 11), fire_probability=0.25)
        cs.install_fault_injector(inj)
        obs = [observe(cs, port, cs.detect(port_txns(t) if port else t, now, nov))
               for t, now, nov in stream]
        return obs, inj.injected, [list(b.transitions) for b in cs._breakers]

    ref = make_ref(n)
    want_obs, want_log, want_walks = run(ref, port=False)
    cs = make_port(n)
    got_obs, got_log, got_walks = run(cs, port=True)
    assert got_log == want_log
    assert {site.split("#")[1] for _q, site, _k in got_log} >= {"s0", "s1"}
    assert got_walks == want_walks and any(got_walks)
    for i, (w, g) in enumerate(zip(want_obs, got_obs)):
        assert g == w, f"batch {i}"
    oracle = MultiResolverCpuOracle(split_for(n))
    assert [o["verdicts"] for o in got_obs] == [oracle.detect(*b) for b in stream]
    assert buggify.coverage() == ref_buggify.coverage()
    statuses = {k: v["status"] for k, v in cs.mirror_check()["shards"].items()}
    assert statuses == {k: v["status"] for k, v in ref.mirror_check()["shards"].items()}
    assert "diverged" not in statuses.values()


# ---------------------------------------------------------------------------
# DeviceChaosWorkload served through the port (twin of :460)
# ---------------------------------------------------------------------------


def _chaos_run(monkeypatch, port):
    from foundationdb_tpu.server import SimCluster
    from foundationdb_tpu.workloads import (
        CycleWorkload,
        DeviceChaosWorkload,
        RandomCloggingWorkload,
        SerializabilityWorkload,
        run_workloads,
    )

    if port:
        # The soak's and the chaos workload's default engine: the
        # Resolver's ConflictSet(backend="jax") settings.
        cs = ConflictSet(device="cpu", key_words=g_knobs.server.conflict_device_key_words,
                         h_cap=1 << 16, bucket_mins=(8, 8, 8), pipeline_depth=2)
        c = SimCluster(seed=424242, conflict_set=cs, n_proxies=2)
        buggify.set_buggify_enabled(True, c.loop.rng, activated_probability=1.0)
        monkeypatch.setattr(ref_faults, "DeviceFaultInjector", DeviceFaultInjector)
    else:
        c = SimCluster(seed=424242, conflict_backend="jax", n_proxies=2)
    chaos = DeviceChaosWorkload(duration=3.0, fire_probability=0.5)
    run_workloads(
        c,
        [
            CycleWorkload(nodes=6, ops=12, actors=2),
            SerializabilityWorkload(registers=4, actors=2, ops=5),
            chaos,
            RandomCloggingWorkload(duration=2.0),
        ],
        timeout_vt=20000.0,
    )
    if port:
        monkeypatch.undo()
    ref_cov = ref_buggify.coverage()
    cov = buggify.coverage() if port else {"sites_seen": 0, "sites_activated": 0,
                                          "sites_fired": 0, "fired_counts": {}}
    union = {
        "sites_seen": ref_cov["sites_seen"] + cov["sites_seen"],
        "sites_activated": ref_cov["sites_activated"] + cov["sites_activated"],
        "sites_fired": ref_cov["sites_fired"] + cov["sites_fired"],
        "fired_counts": dict(sorted({**ref_cov["fired_counts"], **cov["fired_counts"]}.items())),
    }
    engines = [(inj.injected, cs._breaker.transitions,
                {k: cs.device_metrics()["counters"].get(k, 0)
                 for k in ("device_faults", "breaker_opens", "breaker_probes", "breaker_closes",
                           "degraded_batches", "rehydrates", "cpu_fallback_txns",
                           "pipeline_replayed_batches")})
               for cs, inj in chaos.installed]
    ref_sites = set(ref_cov["fired_counts"])
    return dict(engines=engines, coverage=union, now=c.loop.now(),
                next_draw=c.loop.rng.random01(), ref_sites=ref_sites,
                port_sites=set(cov["fired_counts"]),
                installed=[type(inj).__module__ for _cs, inj in chaos.installed])


def test_device_chaos_workload_through_the_port(monkeypatch, arm_every_site):
    """Cycle and Serializability hold through device faults and network
    chaos on the port's set (run_workloads asserts every workload's
    check); the injected logs, breaker walks, counters and the union of the
    two buggify modules' coverage equal the reference's same-seed run, and
    the simulation ends at the same virtual time with its RNG at the same
    point."""
    want = _chaos_run(monkeypatch, port=False)
    got = _chaos_run(monkeypatch, port=True)
    assert got["installed"] == ["foundationdb_tpu_torch.conflict.device_faults"]
    assert got["engines"] == want["engines"]
    (log, _walk, counters), = got["engines"]
    assert log and counters["device_faults"] == len(log)
    assert got["coverage"] == want["coverage"]
    assert any(s.startswith("device_fault_") for s in got["coverage"]["fired_counts"])
    # The device sites are the port module's alone; the rest the reference's.
    assert got["port_sites"] and all(s.startswith("device_fault_") for s in got["port_sites"])
    assert not any(s.startswith("device_fault_") for s in got["ref_sites"])
    assert (got["now"], got["next_draw"]) == (want["now"], want["next_draw"])
