"""WriteDuringRead, RandomReadWrite and FuzzApi through the port, held to
the reference's.

Twins of tests/test_write_during_read.py's six tests, at their seeds and
shapes: the WriteDuringRead memory model, the RandomReadWrite count, the
issue-time read-your-writes snapshot, used_during_commit, the FuzzApi
contracts, and reads inside a transaction with a large mutation log.
Each runs through the port's SimCluster and client and through the
reference's, in tests/test_torch_client.py's two arms (each package's
host engine, "cpu"; every resolver over a port ConflictSet(device="cpu")
at key_words=4, "set"), and the records are equal: every read, commit and
retry, each client's state, each workload's attributes after the run
(FuzzApi's size limits, constructor arguments of the port's where the
reference reads its knobs, aside), the roles' registries and the loop's
end time and rng.
"""

from __future__ import annotations

import importlib.util
import pathlib
import time

import pytest

from foundationdb_tpu_torch.flow import eventloop as port_el

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_workload_twins", _here / "test_torch_workloads.py")
WL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(WL)
TWINS = WL.TWINS
_restore_globals = WL._restore_globals

TIMEOUT = 30000.0


@pytest.mark.parametrize("arm", ["cpu", "set"])
@pytest.mark.parametrize("seed", [7001, 7002, 7003])
def test_write_during_read_memory_model(seed, arm):
    _rec, loads, _c = WL.pair(
        arm, lambda wl: [wl.WriteDuringReadWorkload(nodes=30, txns=10)], seed,
        timeout_vt=TIMEOUT, prefixes=(b"\x02wdr/",), n_proxies=2, n_storages=2)
    assert loads[0].committed_txns > 0
    assert not loads[0].mismatches


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_random_read_write_workload(arm):
    _rec, loads, _c = WL.pair(
        arm, lambda wl: [wl.RandomReadWriteWorkload(nodes=100, actors=3, txns_per_actor=6)],
        7010, timeout_vt=TIMEOUT, prefixes=(b"rrw/",), n_proxies=2)
    assert loads[0].committed == 18


def s_read_during_flight(c, m):
    """A set() issued while a get() awaits storage does not reach the
    get's result; a read issued after it sees it."""
    db = c.database("t")
    out = {}

    async def scenario():
        async def fill(tr):
            tr.set(b"k", b"old")

        await db.run(fill)
        tr = db.create_transaction()

        async def reader():
            out["inflight"] = await tr.get(b"k")

        task = db.process.spawn(reader(), "inflight_get")
        await c.loop.delay(0.0001)
        tr.set(b"k", b"new")
        await task
        out["after"] = await tr.get(b"k")

    c.run_until(db.process.spawn(scenario(), "scenario"), timeout_vt=1000.0)
    return out


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_read_does_not_see_write_issued_during_flight(arm):
    out = TWINS.pair(arm, s_read_during_flight, 7020)
    assert out == {"inflight": b"old", "after": b"new"}


def s_used_during_commit(c, m):
    """Ops racing an in-flight commit, and after it until reset, fail
    with used_during_commit; after reset the committed value reads."""
    db = c.database("t")
    out = []

    async def expect(thunk):
        try:
            r = thunk()
            if hasattr(r, "__await__"):
                await r
            out.append("ok")
        except m.error.FdbError as e:
            out.append(e.name)

    async def scenario():
        tr = db.create_transaction()
        tr.set(b"a", b"1")
        commit_task = db.process.spawn(tr.commit(), "commit")
        await c.loop.delay(0.0001)
        await expect(lambda: tr.get(b"a"))
        await expect(lambda: tr.set(b"b", b"2"))
        await expect(lambda: tr.clear(b"a"))
        await commit_task
        await expect(lambda: tr.get(b"a"))
        tr.reset()
        out.append(await tr.get(b"a"))

    c.run_until(db.process.spawn(scenario(), "scenario"), timeout_vt=1000.0)
    return out


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_used_during_commit(arm):
    out = TWINS.pair(arm, s_used_during_commit, 7021)
    assert out == ["used_during_commit"] * 4 + [b"1"]


@pytest.mark.parametrize("arm", ["cpu", "set"])
@pytest.mark.parametrize("seed", [7101, 7102, 7103, 7104])
def test_fuzz_api_workload(seed, arm):
    _rec, loads, _c = WL.pair(
        arm, lambda wl: [wl.FuzzApiWorkload(nodes=20, txns=15)], seed, timeout_vt=TIMEOUT,
        prefixes=(b"\x02fuzz/",), n_proxies=2)
    assert not loads[0].failures
    assert len(loads[0].errors_exercised) >= 3, loads[0].errors_exercised


def test_fuzz_api_oversized_ops_meet_the_clients_limits():
    """The oversized-key and -value ops exceed the client's own limits:
    over a longer sweep both raise their error and no contract fails."""
    _rec, loads, _c = WL.run(
        "port", "cpu", lambda wl: [wl.FuzzApiWorkload(nodes=20, txns=40)], 7105,
        timeout_vt=TIMEOUT, n_proxies=2)
    assert not loads[0].failures
    assert {"key_too_large", "value_too_large"} <= loads[0].errors_exercised


@pytest.mark.parametrize("seed", [29, 7106, 7107])
def test_side_shadow_names_the_side_tables_batches(seed):
    """FuzzApi over phase 4m's one-resolver cluster, its set a port
    ConflictSet(device="cpu") at key_words=4: chip_smoke's SideShadow,
    from the replayed requests and replies alone, names as many batches
    as the set's long-key side table took, more than those holding a key
    past 16 bytes (the rest read a live region)."""
    import dataclasses

    from foundationdb_tpu_torch import workloads as wl
    from foundationdb_tpu_torch.conflict import engine_cpu as ecpu
    from foundationdb_tpu_torch.conflict.api import ConflictSet
    from foundationdb_tpu_torch.server.cluster import SimCluster

    smoke = TWINS.SMOKE
    cs = ConflictSet(device="cpu", key_words=4, h_cap=1 << 12)
    c = SimCluster(seed=seed, device="cpu", conflict_set=cs, n_proxies=1, n_resolvers=1,
                   buggify=False)
    resolves = []
    for p in c.proxies:
        p.resolvers = [dataclasses.replace(r, resolve=smoke.Recorded(r.resolve, resolves))
                       for r in p.resolvers]
    try:
        wl.run_workloads(c, [wl.FuzzApiWorkload(nodes=20, txns=15)], timeout_vt=TIMEOUT)
    finally:
        port_el.set_event_loop(None)
    window = c.resolver.max_write_transaction_life_versions
    rp = smoke.Replay(ecpu.CpuConflictSet(key_words=4), window)
    rp.log = resolves
    served = rp.replay("fuzz")
    assert len(served) == len(resolves)
    long_, side = smoke.SideShadow(16, window).count(served)
    assert side == smoke.long_key_counts(cs)["side"]
    assert side > long_ > 0


def timed_reads(m, seed, n_muts):
    """Per-read wall of 300 overlay-hit gets in a transaction holding
    `n_muts` sets, on `m`'s SimCluster; and the values read."""
    c = m.cluster.SimCluster(seed=seed, **({"device": "cpu"} if m.pkg == "port" else {}),
                             conflict_backend="cpu")
    db = c.database()
    out = {}

    async def go():
        tr = db.create_transaction()
        for i in range(n_muts):
            tr.set(b"wm%06d" % i, b"v")
        for i in range(50):
            await tr.get(b"wm%06d" % (i % n_muts))
        t0 = time.perf_counter()
        vals = set()
        for i in range(300):
            vals.add(await tr.get(b"wm%06d" % ((i * 13) % n_muts)))
        out["dt"] = time.perf_counter() - t0
        out["vals"] = vals

    try:
        c.run_until(db.process.spawn(go()), timeout_vt=100000.0)
    finally:
        m.el.set_event_loop(None)
    return out


def test_writemap_reads_scale_with_key_ops_not_log_size():
    """A read inside a transaction holding a large mutation log does not
    scan it: 16x the log costs under 6x the read time, on the port's
    client as on the reference's, and both read what was set."""
    for pkg in ("ref", "port"):
        m = TWINS.mods(pkg)
        small = [timed_reads(m, 910, 500) for _ in range(2)]
        big = [timed_reads(m, 911, 8000) for _ in range(2)]
        assert all(r["vals"] == {b"v"} for r in small + big)
        t_small = min(r["dt"] for r in small)
        t_big = min(r["dt"] for r in big)
        assert t_big < 6 * t_small, (pkg, t_small, t_big)
    port_el.set_event_loop(None)
