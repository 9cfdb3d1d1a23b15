"""The runtime twins of fdblint's race and promise families in the port:
the state sanitizer (foundationdb_tpu_torch/flow/state_sanitizer.py),
the orphaned-wait check (flow/sim_validation.py's
``expect_no_orphaned_waits``) and the scheduler fuzz, held to the
reference's tests/test_racecheck_dynamic.py (all 10) and
tests/test_sim_validation.py's orphaned-wait tests, each run for both
packages.

The reference switches each twin on by environment (FDB_TPU_STATE_SANITIZER,
FDB_TPU_CHECK_ORPHANED_WAITS, FDB_TPU_SCHED_FUZZ); the port takes
``EventLoop(seed, sched_fuzz=, state_sanitizer=, check_orphaned_waits=)``,
which SimCluster and DynamicCluster pass on.  The reference's env-flag
tests become the same checks on the constructor arguments.  Every
SimCluster's resolvers, in both packages, serve through the port's
ConflictSet(device="cpu"), and the commit workload's fingerprint under
each fuzz is equal across the two; the DynamicClusters' through the
port's set and the reference's host engine.  Last, chip_smoke.py's phase 4x
script with both twins on: nothing the run records changes, no violation
and no orphan.
"""

from __future__ import annotations

import importlib
import importlib.util
import pathlib
import types as pytypes

import pytest

from foundationdb_tpu_torch.conflict.api import ConflictSet

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_dc_twins_racecheck",
                                               _here / "test_torch_dynamic_cluster.py")
DC = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(DC)
_restore_globals = DC._restore_globals
SMOKE = DC.SMOKE
_spec = importlib.util.spec_from_file_location("_recovery_racecheck",
                                               _here / "test_torch_recovery_phase.py")
RECOVERY = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(RECOVERY)

PKGS = ("ref", "port")
FLAGS = dict(state_sanitizer="FDB_TPU_STATE_SANITIZER",
             check_orphaned_waits="FDB_TPU_CHECK_ORPHANED_WAITS",
             sched_fuzz="FDB_TPU_SCHED_FUZZ")


def mods(pkg):
    base = DC.BASES[pkg]
    imp = importlib.import_module
    fileio = imp(f"{base}.fileio")
    return pytypes.SimpleNamespace(
        pkg=pkg, el=imp(f"{base}.flow.eventloop"), future=imp(f"{base}.flow.future"),
        san=imp(f"{base}.flow.state_sanitizer"), sv=imp(f"{base}.flow.sim_validation"),
        cluster=imp(f"{base}.server.cluster"), dc=imp(f"{base}.server.dynamic_cluster"),
        sk=imp(f"{base}.server.system_keys"), net=imp(f"{base}.rpc"),
        DiskQueue=fileio.DiskQueue, SimFileSystem=fileio.SimFileSystem,
        # The reference test module, run against this package.
        twin=DC.load_twin("test_racecheck_dynamic", pkg))


def settings(pkg, monkeypatch, **flags):
    """`flags` (FLAGS' names) as the reference's environment, or as the
    port's constructor arguments (returned)."""
    if pkg == "port":
        return flags
    for name, env in FLAGS.items():
        value = flags.get(name)
        if value:
            monkeypatch.setenv(env, str(int(value)))
        else:
            monkeypatch.delenv(env, raising=False)
    return {}


def make_loop(pkg, monkeypatch, seed, **flags):
    return mods(pkg).el.EventLoop(seed=seed, **settings(pkg, monkeypatch, **flags))


def port_set(device="cpu"):
    return ConflictSet(device=device, **SMOKE.CLIENT_SET_KW)


def sim_cluster(pkg, monkeypatch, seed, flags=None, device="cpu", **kw):
    """`pkg`'s SimCluster, every resolver over a port ConflictSet on
    `device` (the same set in both packages: their records then agree)."""
    m = mods(pkg)
    kw.update(settings(pkg, monkeypatch, **(flags or {})))
    if pkg == "port":
        kw["device"] = device
    with SMOKE.resolver_sets(m.cluster, lambda: port_set(device)):
        return m.cluster.SimCluster(seed=seed, **kw)


def dynamic_cluster(pkg, monkeypatch, seed, flags=None, **kw):
    m = mods(pkg)
    kw.update(settings(pkg, monkeypatch, **(flags or {})))
    if pkg == "port":
        kw.update(device="cpu", resolver_settings=DC.SET_KW)
    return m.dc.DynamicCluster(seed=seed, **kw)


def sanitizer(pkg, loop):
    return loop.state_sanitizer if pkg == "port" else getattr(loop, "_state_sanitizer", None)


# ---------------------------------------------------------------------------
# the state sanitizer
# ---------------------------------------------------------------------------


def _two_bumps(m, loop, shared, recheck):
    async def bump():
        val = shared["n"]  # read ...
        await loop.delay(0.01)  # ... suspension: the other bump runs ...
        shared["n"] = (shared["n"] if recheck else val) + 1

    done = m.el.all_of([loop.spawn(bump(), "bump_a"), loop.spawn(bump(), "bump_b")])
    loop.run_until(done, timeout_vt=10.0)


def _planted(pkg, monkeypatch):
    """Two actors read-modify-write one key across an await: the classic
    lost update, reported in the same run (and the data really is wrong:
    1, not 2).  Returns the violations."""
    m = mods(pkg)
    loop = make_loop(pkg, monkeypatch, 7, state_sanitizer=True)
    m.el.set_event_loop(loop)
    shared = m.san.audited_dict(loop, "planted.counter", {"n": 0})
    _two_bumps(m, loop, shared, recheck=False)
    assert shared["n"] == 1  # one increment was lost
    san = sanitizer(pkg, loop)
    assert len(san.violations) == 1, san.violations
    assert "planted.counter['n']" in san.violations[0]
    assert "lost update" in san.violations[0]
    with pytest.raises(AssertionError, match="stale-read→write"):
        m.san.expect_clean_shared_state(loop, "planted")
    return san.violations


@pytest.mark.parametrize("pkg", PKGS)
def test_sanitizer_catches_planted_lost_update(pkg, monkeypatch):
    got = _planted(pkg, monkeypatch)
    if pkg == "port":
        assert got == _planted("ref", monkeypatch)


@pytest.mark.parametrize("pkg", PKGS)
def test_sanitizer_ignores_recheck_discipline(pkg, monkeypatch):
    m = mods(pkg)
    loop = make_loop(pkg, monkeypatch, 8, state_sanitizer=True)
    m.el.set_event_loop(loop)
    shared = m.san.audited_dict(loop, "clean.counter", {"n": 0})
    _two_bumps(m, loop, shared, recheck=True)
    assert shared["n"] == 2
    m.san.expect_clean_shared_state(loop, "recheck")  # must not raise


@pytest.mark.parametrize("pkg", PKGS)
def test_sanitizer_blindness_check(pkg, monkeypatch):
    loop = make_loop(pkg, monkeypatch, 9, state_sanitizer=True)
    with pytest.raises(AssertionError, match="blind"):
        mods(pkg).san.expect_clean_shared_state(loop)


@pytest.mark.parametrize("pkg", PKGS)
def test_sanitizer_off_is_plain_dict(pkg, monkeypatch):
    """The reference's flag unset; the port's default argument."""
    m = mods(pkg)
    loop = make_loop(pkg, monkeypatch, 10)
    d = m.san.audited_dict(loop, "anything", {"k": 1})
    assert type(d) is dict
    assert sanitizer(pkg, loop) is None
    m.san.expect_clean_shared_state(loop)  # no-op with the sanitizer off


@pytest.mark.parametrize("pkg", PKGS)
def test_sanitizer_quiet_on_full_commit_workload(pkg, monkeypatch):
    """The production audited dicts (the controller's worker registry, the
    proxies' server lists) stay clean on the commit workload."""
    m = mods(pkg)
    c = dynamic_cluster(pkg, monkeypatch, 41, dict(state_sanitizer=True), n_workers=5)
    m.twin._commit_workload(c)
    san = sanitizer(pkg, c.loop)
    assert san is not None and "cluster_controller.workers" in san.names
    assert "proxy.server_list" in san.names
    m.san.expect_clean_shared_state(c.loop, "commit workload shutdown")
    if pkg == "port":
        assert san.n_reads > 0 and san.n_writes > 0 and san.violations == []


# ---------------------------------------------------------------------------
# the scheduler fuzz
# ---------------------------------------------------------------------------


def fuzzed_run(pkg, monkeypatch, seed, fuzz, **flags):
    m = mods(pkg)
    fl = dict(flags, sched_fuzz=fuzz or None)
    c = sim_cluster(pkg, monkeypatch, seed, fl, n_proxies=2)
    out = m.twin._commit_workload(c)
    fp = m.twin._fingerprint(c, out)
    m.el.set_event_loop(None)
    return fp, c


@pytest.mark.parametrize("fuzz", [1, 2, 3])
def test_commit_gate_green_and_replayable_under_sched_fuzz(monkeypatch, fuzz):
    """Each package replays the same (seed, fuzz) to one fingerprint, and
    the port's equals the reference's."""
    fps = {pkg: [fuzzed_run(pkg, monkeypatch, 113, fuzz)[0] for _ in range(2)]
           for pkg in PKGS}
    for pkg in PKGS:
        assert fps[pkg][0] == fps[pkg][1], f"{pkg}: same (seed, fuzz={fuzz}) must replay"
    assert fps["port"][0] == fps["ref"][0]


@pytest.mark.parametrize("pkg", PKGS)
def test_sched_fuzz_perturbs_the_interleaving(pkg, monkeypatch):
    fps = [fuzzed_run(pkg, monkeypatch, 113, fuzz)[0] for fuzz in (0, 1, 2, 3)]
    assert len({fp[2:] for fp in fps}) > 1, fps


def test_the_twins_only_observe(monkeypatch):
    """The port's commit workload with the sanitizer and the orphaned-wait
    check on (and promise tracking) ends where it ends with them off: the
    same fingerprint, so the same events, draws and end."""
    m = mods("port")
    off = fuzzed_run("port", monkeypatch, 113, 2)[0]
    m.future.track_promise_refs(True)
    try:
        on, c = fuzzed_run("port", monkeypatch, 113, 2, state_sanitizer=True,
                           check_orphaned_waits=True)
        m.san.expect_clean_shared_state(c.loop)
        m.sv.expect_no_orphaned_waits(c.loop)
    finally:
        m.future.track_promise_refs(False)
    assert on == off
    assert c.loop.state_sanitizer.names == {"proxy.server_list"}


# ---------------------------------------------------------------------------
# the regression pins of the structural fixes racecheck forced
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_balancer_drops_stale_plan_instead_of_stomping(pkg, monkeypatch):
    m = mods(pkg)
    c = sim_cluster(pkg, monkeypatch, 102, n_resolvers=2)
    assert c.split_keys == [b"\x80"]
    db = c.database()

    async def load():
        for i in range(60):
            async def op(tr, i=i):
                k = b"hot/%03d" % (i % 20)
                await tr.get(k)
                tr.set(k, b"x%d" % i)

            await db.run(op)

    c.run_all([(db, load())], timeout_vt=4000.0)
    bal = c.resolver_balancer(min_ops=20, ratio=1.5)
    competing = [b"\x40"]
    orig_run = bal.db.run

    async def hijack(txn):
        # A competing mover commits another partition inside the
        # balancer's await window, just before its own commit.
        async def other(tr):
            tr.options["access_system_keys"] = True
            tr.set(m.sk.RESOLVER_SPLIT_KEY, m.sk.encode_resolver_split(competing))

        await orig_run(other)
        bal.db.run = orig_run
        return await orig_run(txn)

    bal.db.run = hijack
    moved = c.run_until(db.process.spawn(bal.run_once()), timeout_vt=1000.0)
    assert moved is None and bal.moves == 0
    assert bal.split_keys == [b"\x80"]  # the stale plan was dropped

    async def read_durable(tr):
        tr.options["access_system_keys"] = True
        return await tr.get(m.sk.RESOLVER_SPLIT_KEY)

    durable = c.run_until(db.process.spawn(orig_run(read_durable)), timeout_vt=1000.0)
    assert m.sk.decode_resolver_split(durable) == competing


@pytest.mark.parametrize("pkg", PKGS)
def test_grv_concurrent_requests_one_snapshot(pkg, monkeypatch):
    m = mods(pkg)
    c = sim_cluster(pkg, monkeypatch, 43)
    db = c.database()
    out = {}

    async def go(tr):
        t1 = db.process.spawn(tr.get_read_version(), "grv1")
        t2 = db.process.spawn(tr.get_read_version(), "grv2")
        a, b = await m.el.all_of([t1, t2])
        out["versions"] = (a, b, tr._read_version)

    c.run_all([(db, db.run(go))], timeout_vt=1000.0)
    a, b, cached = out["versions"]
    assert a == b == cached


@pytest.mark.parametrize("pkg", PKGS)
def test_diskqueue_pop_during_header_write_not_lost(pkg, monkeypatch):
    m = mods(pkg)
    loop = make_loop(pkg, monkeypatch, 11)
    m.el.set_event_loop(loop)
    net = m.net.SimNetwork(loop)
    fs = m.SimFileSystem(net)
    proc = net.process("node")
    state = {}

    async def scenario():
        q, _rec = await m.DiskQueue.open(fs, proc, "hdr.dq")
        for s in range(1, 4):
            q.push(s, b"p%d" % s)
        await q.commit()
        q.pop(1)
        real_write = q._file.write

        async def write_hook(offset, data):
            if offset == 0 and "late_pop" not in state:
                state["late_pop"] = True
                q.pop(2)  # lands while the header write is in flight
            await real_write(offset, data)

        q._file.write = write_hook
        await q.commit()  # persists popped=1; pop(2) arrives mid-write
        q._file.write = real_write
        assert q._header_dirty  # the late pop re-dirtied the header
        await q.commit()  # must persist popped=2
        q2, rec2 = await m.DiskQueue.open(fs, proc, "hdr.dq")
        state["popped"] = q2.popped_seq
        state["recovered"] = [s for s, _p in rec2]

    loop.run_until(proc.spawn(scenario()), timeout_vt=100.0)
    assert state["popped"] == 2
    assert state["recovered"] == [3]


# ---------------------------------------------------------------------------
# the orphaned-wait check (tests/test_sim_validation.py's)
# ---------------------------------------------------------------------------


@pytest.fixture
def tracking():
    """Promise tracking on in both packages for the test."""
    for pkg in PKGS:
        mods(pkg).future.track_promise_refs(True)
    yield
    for pkg in PKGS:
        mods(pkg).future.track_promise_refs(False)


async def _waiter(f):
    await f


@pytest.mark.parametrize("pkg", PKGS)
def test_orphaned_wait_trips_at_teardown(pkg, monkeypatch, tracking):
    m = mods(pkg)
    loop = make_loop(pkg, monkeypatch, 1, check_orphaned_waits=True)
    p = m.future.Promise()
    t = loop.spawn(_waiter(p.future), "orphan_waiter")
    loop.run(max_events=10)
    del p  # the only sender is gone: the task can never wake
    with pytest.raises(AssertionError, match="orphan_waiter"):
        m.sv.expect_no_orphaned_waits(loop, "teardown")
    t.cancel()


@pytest.mark.parametrize("pkg", PKGS)
def test_live_and_timer_waits_are_clean(pkg, monkeypatch, tracking):
    m = mods(pkg)
    loop = make_loop(pkg, monkeypatch, 1, check_orphaned_waits=True)
    held = m.future.Promise()  # promise alive: a sender still exists
    t1 = loop.spawn(_waiter(held.future), "live_waiter")
    t2 = loop.spawn(_waiter(loop.delay(50.0)), "timer_waiter")
    loop.run(max_events=4)
    m.sv.expect_no_orphaned_waits(loop, "mid-run")
    held.send(1)
    loop.run()
    assert t1.is_ready() and t2.is_ready()


@pytest.mark.parametrize("pkg", PKGS)
def test_check_is_noop_without_flag(pkg, monkeypatch, tracking):
    """The reference's flag unset; the port's default argument."""
    m = mods(pkg)
    loop = make_loop(pkg, monkeypatch, 1)
    p = m.future.Promise()
    loop.spawn(_waiter(p.future), "orphan")
    loop.run(max_events=10)
    del p
    m.sv.expect_no_orphaned_waits(loop)  # off: silent by design


@pytest.mark.parametrize("pkg", PKGS)
def test_flag_without_tracking_is_loud(pkg, monkeypatch):
    loop = make_loop(pkg, monkeypatch, 1, check_orphaned_waits=True)
    with pytest.raises(AssertionError, match="track_promise_refs"):
        mods(pkg).sv.expect_no_orphaned_waits(loop)


@pytest.mark.parametrize("pkg", PKGS)
def test_cluster_workload_shutdown_has_no_orphans(pkg, monkeypatch, tracking):
    m = mods(pkg)
    cluster = sim_cluster(pkg, monkeypatch, 23, dict(check_orphaned_waits=True),
                          buggify=False)
    db = cluster.database()

    async def commits(db):
        for i in range(8):
            tr = db.create_transaction()
            tr.set(b"ow%d" % i, b"v")
            await tr.commit()

    cluster.run_until(db.process.spawn(commits(db), "committer"))
    m.sv.expect_no_orphaned_waits(cluster.loop, "cluster shutdown")


@pytest.mark.parametrize("pkg", PKGS)
def test_run_until_dry_loop_names_orphans(pkg, monkeypatch, tracking):
    m = mods(pkg)
    loop = make_loop(pkg, monkeypatch, 1, check_orphaned_waits=True)
    p = m.future.Promise()
    t = loop.spawn(_waiter(p.future), "doomed")
    out = m.future.Promise()
    fut = out.future
    loop.run(max_events=10)
    del p
    with pytest.raises(RuntimeError, match="doomed"):
        loop.run_until(fut)
    t.cancel()


@pytest.mark.parametrize("pkg", PKGS)
def test_dropped_handle_orphan_is_still_detected(pkg, monkeypatch, tracking):
    m = mods(pkg)
    loop = make_loop(pkg, monkeypatch, 1, check_orphaned_waits=True)
    p = m.future.Promise()
    loop.spawn(_waiter(p.future), "dropped_handle_orphan")  # handle dropped
    loop.run(max_events=10)
    del p
    with pytest.raises(AssertionError, match="dropped_handle_orphan"):
        m.sv.expect_no_orphaned_waits(loop, "teardown")


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 4x with both twins on
# ---------------------------------------------------------------------------


def test_recovery_script_under_the_twins_records_the_same():
    """Phase 4x's script at the rig's shape through the port's
    DynamicCluster, with the sanitizer, the orphaned-wait check and
    promise tracking on, against the same run with them off: every read,
    commit, trace event, recruited set and batch, and the loop's end,
    equal.  Both audited dicts saw keyed reads and writes, no
    stale-read→write pair and no orphaned wait."""
    m = mods("port")
    off, _ = RECOVERY._run("port", 2)
    made = []
    m.future.track_promise_refs(True)
    try:
        on, _ = RECOVERY._run("port", 2, dc_kw=SMOKE.RECOVER_TWINS, made=made)
        report = SMOKE.runtime_twins_report(made[0].loop)
    finally:
        m.future.track_promise_refs(False)
    for key in off:
        assert on[key] == off[key], DC.first_difference(on[key], off[key], key)
    assert report["audited"] == ["cluster_controller.workers", "proxy.server_list"]
    assert report["reads"] > 0 and report["writes"] > 0
    assert report["violations"] == 0 and report["orphans"] == 0
