"""The port's data distribution, held to the reference's on the CPU.

The port's ``server/data_distribution.py`` (DataDistributor),
``server/dd_role.py`` (DataDistributionRole), ``SimCluster.
data_distributor()`` and ``dd_role()``, and the workloads RandomMoveKeys,
DDBalance and RemoveServersSafely run the same scripts as the
reference's, each through its own package's SimCluster, at the reference
tests' seeds and shapes: twins of tests/test_dd_role.py (all but the
DynamicCluster case, which waits for the control plane), all eight of
tests/test_sharding.py, the three cases of tests/test_replication.py that
distribute data, test_rollback_movekeys.py's RandomMoveKeys under load,
test_management.py's exclusion healing, test_restarting.py's restart in
the middle of a shard move, test_new_workloads.py's RemoveServersSafely
and IndexScan through shard moves (without the quiet wait, which reads
the control plane's status), test_multi_proxy.py's metadata case and
test_locality_loadbalance.py's hedged read; and DDBalance on a SimCluster
with ``c.dd_role()`` in place of the reference test's DynamicCluster.

The reference reads its ``dd_*`` knobs (set in its arm and restored); the
port's role takes the same values as constructor arguments.  The
reference's ``fetch_shard_page_rows`` knob is the port storage's
``FETCH_SHARD_PAGE_ROWS``, patched in the port's arm.  Held equal: every
point read, range read, commit and retry with its virtual time
(chip_smoke's ClientLog); every DataDistributor move, split, auto_split
and auto_merge with its virtual start, end and outcome (chip_smoke's
DDLog, the relocation log); each storage's window and owned ranges, and
so the final ``\\xff/keyServers/`` rows (chip_smoke's dd_state); each
client's state; the proxies' and resolvers' registries; the script's own
results; and the loop's end time with its rng's next draw.  Arm "cpu" is
each package's host engine; some cases also run arm "set" (every
resolver over a port ConflictSet(device="cpu") at key_words=4).
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import inspect
import pathlib

import pytest

from foundationdb_tpu.flow.knobs import g_knobs

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_client_twins", _here / "test_torch_client.py")
TWINS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TWINS)
SMOKE = TWINS.SMOKE
_restore_globals = TWINS._restore_globals

FAST_DD = dict(tracker_interval=0.5)  # test_dd_role.py's fast_dd fixture


@contextlib.contextmanager
def knobs(pkg, settings, monkeypatch):
    """The reference's dd_* knobs (and fetch_shard_page_rows) at
    `settings` while open; the port's FETCH_SHARD_PAGE_ROWS patched."""
    if pkg == "ref":
        names = {k: k if k == "fetch_shard_page_rows" else "dd_" + k for k in settings}
        saved = {k: getattr(g_knobs.server, n) for k, n in names.items()}
        for k, n in names.items():
            setattr(g_knobs.server, n, settings[k])
        try:
            yield
        finally:
            for k, n in names.items():
                setattr(g_knobs.server, n, saved[k])
    else:
        if "fetch_shard_page_rows" in settings:
            storage = importlib.import_module("foundationdb_tpu_torch.server.storage")
            monkeypatch.setattr(storage, "FETCH_SHARD_PAGE_ROWS",
                                settings["fetch_shard_page_rows"])
        yield


def record(pkg, arm, script, seed, settings, monkeypatch, **cluster_kw):
    """`script(c, m, role)` through `pkg`'s cluster in `arm`; `role(dd)`
    starts the cluster's DD role over `dd` with `settings`.  Returns the
    record."""
    m = TWINS.mods(pkg)
    m.dd = importlib.import_module(f"{TWINS.BASES[pkg]}.server.data_distribution")
    m.sk = importlib.import_module(f"{TWINS.BASES[pkg]}.server.system_keys")
    m.probe = importlib.import_module(f"{TWINS.BASES[pkg]}.flow.testprobe")
    TWINS._install_hubs(pkg)
    role_kw = {k: v for k, v in settings.items() if k != "fetch_shard_page_rows"}

    def role(c, dd=None):
        return c.dd_role(dd) if pkg == "ref" else c.dd_role(dd, **role_kw)

    with knobs(pkg, settings, monkeypatch):
        c = TWINS.cluster(m, arm, seed, **cluster_kw)
        dbs = SMOKE.tracked_databases(c)
        log, ddlog = SMOKE.ClientLog(m.tx), SMOKE.DDLog(m.dd)
        try:
            out = script(c, m, lambda dd=None: role(c, dd))
            state = SMOKE.dd_state(c)
        finally:
            log.remove()
            ddlog.remove()
            m.el.set_event_loop(None)
    return dict(
        out=SMOKE.norm(out),
        events=log.events,
        moves=ddlog.events,
        state=state,
        clients=SMOKE.client_state(dbs),
        proxies=[p.metrics.snapshot_json() for p in c.proxies],
        resolvers=[r.metrics.snapshot_json() for r in c.resolvers],
        end=(c.loop.now(), c.loop.rng.random_int(0, 1 << 30)),
    )


def pair(script, seed, settings=(), arm="cpu", monkeypatch=None, **cluster_kw):
    """The reference's record and the port's, asserted equal; returns the
    port's."""
    settings = dict(settings)
    ref = record("ref", arm, script, seed, settings, monkeypatch, **cluster_kw)
    port = record("port", arm, script, seed, settings, monkeypatch, **cluster_kw)
    assert port["events"] == ref["events"]
    assert port["moves"] == ref["moves"]
    for key in ref:
        assert port[key] == ref[key], key
    return port


# ---------------------------------------------------------------------------
# helpers of the reference tests
# ---------------------------------------------------------------------------


def run(c, db, aw, timeout_vt=500.0):
    """Run the loop until `aw` (a coroutine, spawned on `db`'s process, or
    a future) is done; its value."""
    fut = db.process.spawn(aw) if inspect.iscoroutine(aw) else aw
    return c.run_until(fut, timeout_vt=timeout_vt)


def settle(c, db, t=0.1):
    run(c, db, c.loop.delay(t))


def fill(c, db, n=50, prefix=b"k"):
    async def txn(tr):
        for i in range(n):
            tr.set(prefix + b"%03d" % i, b"v%d" % i)

    c.run_all([(db, db.run(txn))])


def read_all(c, db, begin=b"k", end=None, **kw):
    out = {}

    async def txn(tr):
        out["rows"] = await tr.get_range(begin, end or begin + b"\xff", **kw)

    c.run_all([(db, db.run(txn))], timeout_vt=2000.0)
    return out["rows"]


def wait_until(c, db, cond, timeout_vt=300.0, interval=0.25):
    """test_dd_role.py's driver: advance virtual time until `cond()` holds."""
    result = {}

    async def poll():
        while True:
            if await cond():
                result["ok"] = True
                return
            await c.loop.delay(interval)

    c.run_until(db.process.spawn(poll()), timeout_vt=timeout_vt)
    return result.get("ok", False)


def place(dd, seed_team=("ss0",), splits=(), moves=()):
    async def go():
        await dd.register_storages(dd.storages)
        await dd.seed(list(seed_team))
        for k in splits:
            await dd.split(k)
        for b, team in moves:
            await dd.move(b, list(team))

    return go()


def replica_rows(c, m, db, sid, begin, end, version):
    """A direct range read from one storage, bypassing the client."""
    s = {x.storage_id: x for x in c.storages}[sid]
    return run(c, db, s.interface().get_key_values.get_reply(
        db.process, m.itf.GetKeyValuesRequest(begin=begin, end=end, version=version)),
        timeout_vt=200.0).data


def user_teams(c, db, dd):
    return [(b, set(t), set(d)) for b, _e, t, d in run(c, db, dd.read_shard_map())
            if b < b"\xff"]


def ring_of(rows, n, fmt=b"cycle/%03d"):
    ring = {k: int(v.decode()) for k, v in rows}
    seen, cur = set(), 0
    for _ in range(n):
        if cur in seen:
            return False
        seen.add(cur)
        cur = ring[fmt % cur]
    return cur == 0 and len(seen) == n == len(ring)


def cycle_worker(c, db, n, ops):
    """test_sharding.py's hand-written Cycle actor."""
    async def go():
        rng = c.loop.rng
        for _ in range(ops):
            async def op(tr):
                a = int(rng.random_int(0, n))
                ka = b"cycle/%03d" % a
                b = int((await tr.get(ka)).decode())
                kb = b"cycle/%03d" % b
                cc = int((await tr.get(kb)).decode())
                kc = b"cycle/%03d" % cc
                d = int((await tr.get(kc)).decode())
                tr.set(ka, b"%03d" % cc)
                tr.set(kc, b"%03d" % b)
                tr.set(kb, b"%03d" % d)

            await db.run(op)

    return go()


def init_ring(c, db, n):
    async def init(tr):
        for i in range(n):
            tr.set(b"cycle/%03d" % i, b"%03d" % ((i + 1) % n))

    c.run_all([(db, db.run(init))])


# ---------------------------------------------------------------------------
# tests/test_dd_role.py
# ---------------------------------------------------------------------------


def s_storage_kill_heals(c, m, role):
    db = c.database()
    fill(c, db)
    dd = c.data_distributor()
    run(c, db, place(dd, splits=(b"k025", b"\xff"),
                     moves=((b"", ["ss0", "ss1"]), (b"k025", ["ss1", "ss2"]))))
    r = role(dd)
    c.storages[1].process.kill()

    async def healed():
        user = [(b, set(t), set(d)) for b, _e, t, d in await dd.read_shard_map() if b < b"\xff"]
        return bool(user) and all(not d and "ss1" not in t and len(t) == 2 for _b, t, d in user)

    ok = wait_until(c, db, healed, timeout_vt=600.0)
    version = c.proxy.committed.get()
    replicas = []
    for b, e, team, _d in run(c, db, dd.read_shard_map()):
        lo, hi = max(b, b"k"), min(e or b"\xff", b"l")
        if b < b"\xff" and lo < hi:
            replicas.append([replica_rows(c, m, db, sid, lo, hi, version) for sid in team])
    rows = read_all(c, db, b"k", b"l")
    out = dict(healed=ok, moves=r.moves_done, heals=r.heals_done, replicas=replicas,
               rows=len(rows))
    r.stop()
    return out


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_storage_kill_heals_without_intervention(arm):
    out = pair(s_storage_kill_heals, 172, FAST_DD, arm, n_storages=4, n_tlogs=2)["out"]
    assert out["healed"] and out["moves"] >= 2 and out["heals"] >= 1
    assert out["replicas"] and all(r and all(x == r[0] for x in r) for r in out["replicas"])
    assert out["rows"] == 50


def s_hot_shard(c, m, role):
    db = c.database()
    dd = c.data_distributor()
    run(c, db, place(dd, splits=(b"\xff",)))
    r = role(dd)
    for j in range(4):
        async def txn(tr, j=j):
            for i in range(60):
                tr.set(b"h%d%03d" % (j, i), b"x" * 40)

        c.run_all([(db, db.run(txn))], timeout_vt=500.0)

    async def rebalanced():
        per = {}
        for b, _e, team, dest in await dd.read_shard_map():
            if b >= b"\xff" or dest:
                continue
            for sid in team:
                per[sid] = per.get(sid, 0) + 1
        return r.splits_done >= 1 and per.get("ss1", 0) >= 1

    ok = wait_until(c, db, rebalanced, timeout_vt=900.0)
    out = dict(ok=ok, rows=len(read_all(c, db, b"h", b"i")), splits=r.splits_done,
               moves=r.moves_done, merges=r.merges_done)
    r.stop()
    return out


HOT = dict(FAST_DD, shard_max_bytes=3000, shard_min_bytes=0)


def test_hot_shard_splits_and_rebalances():
    out = pair(s_hot_shard, 173, HOT, n_storages=2)["out"]
    assert out["ok"] and out["rows"] == 240 and out["splits"] >= 1


def s_exclusion_drains(c, m, role):
    db = c.database()
    fill(c, db)
    dd = c.data_distributor()
    run(c, db, place(dd, splits=(b"k025", b"\xff"),
                     moves=((b"", ["ss0", "ss1"]), (b"k025", ["ss1", "ss2"]))))
    r = role(dd)
    c.run_all([(db, m.mgmt.exclude_servers(db, ["ss1"]))], timeout_vt=200.0)

    async def drained():
        return all("ss1" not in set(t) | set(d) for _b, _e, t, d in await dd.read_shard_map())

    ok = wait_until(c, db, drained, timeout_vt=600.0)
    teams = run(c, db, dd.read_shard_map())
    r.stop()
    return dict(ok=ok, teams=teams)


def test_exclusion_drains_server():
    out = pair(s_exclusion_drains, 174, FAST_DD, n_storages=4, n_tlogs=2)["out"]
    assert out["ok"]
    assert all("ss1" not in set(t) | set(d) for _b, _e, t, d in out["teams"])


PROBES = ("dd_storage_declared_failed", "dd_heal_enqueued", "dd_auto_split_fired")


def s_probe_corpus(c, m, role):
    before = {n: m.probe.hit_sites.get(n, 0) for n in PROBES}
    db = c.database()
    dd = c.data_distributor()
    run(c, db, place(dd, seed_team=("ss0", "ss1"), splits=(b"\xff",)))
    role(dd)
    for j in range(4):
        async def txn(tr, j=j):
            for i in range(60):
                tr.set(b"p%d%03d" % (j, i), b"x" * 40)

        c.run_all([(db, db.run(txn))], timeout_vt=500.0)
    c.storage_procs[1].kill()

    def fired():
        return all(m.probe.hit_sites.get(n, 0) > b for n, b in before.items())

    async def wait():
        for _ in range(2000):
            if fired():
                return True
            await c.loop.delay(0.25)
        return False

    return run(c, db, wait(), timeout_vt=2000.0)


def test_dd_probe_corpus():
    assert pair(s_probe_corpus, 177, HOT, n_storages=3)["out"]


# ---------------------------------------------------------------------------
# tests/test_sharding.py
# ---------------------------------------------------------------------------


def s_seed_spread(c, m, role):
    db = c.database()
    fill(c, db, n=60)
    dd = c.data_distributor()

    async def go():
        await dd.register_storages(dd.storages)
        await dd.seed(["ss0"])
        await dd.spread_evenly(split_points=[b"k020", b"k040"])

    run(c, db, go())
    settle(c, db)
    owners = sum(any(v for _b, _e, v in s.owned.intersecting(b"k", b"l")) for s in c.storages)
    rows = read_all(c, db)
    rev = read_all(c, db, b"k", b"k\xff", reverse=True, limit=25)
    db2 = c.database()
    vals = {}

    async def points(tr):
        for k in (b"k005", b"k025", b"k045"):
            vals[k] = await tr.get(k)

    c.run_all([(db2, db2.run(points))])
    return dict(owners=owners, sys=bool(c.storages[0].owned[b"\xff/keyServers/"]), rows=rows,
                rev=[k for k, _ in rev], vals=vals)


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_seed_spread_and_cross_shard_reads(arm):
    out = pair(s_seed_spread, 31, arm=arm, n_storages=3)["out"]
    assert out["owners"] == 3 and out["sys"]
    assert [k for k, _ in out["rows"]] == [b"k%03d" % i for i in range(60)]
    assert out["rev"] == [b"k%03d" % i for i in range(59, 34, -1)]
    assert dict(out["vals"]) == {b"k005": b"v5", b"k025": b"v25", b"k045": b"v45"}


def s_stale_cache(c, m, role):
    db = c.database()
    fill(c, db, n=20)
    dd = c.data_distributor()
    run(c, db, place(dd, splits=(b"k010", b"\xff")))
    before = dict(read_all(c, db))[b"k015"]
    run(c, db, dd.move(b"k010", ["ss1"]))
    settle(c, db)
    owned = (any(v for _b, _e, v in c.storages[1].owned.intersecting(b"k010", b"l")),
             any(v for _b, _e, v in c.storages[0].owned.intersecting(b"k010", b"k\xff")))
    vals = {}

    async def rw(tr):
        vals["get"] = await tr.get(b"k015")
        tr.set(b"k015", b"v15b")

    c.run_all([(db, db.run(rw))])

    async def verify(tr):
        vals["after"] = await tr.get(b"k015")

    c.run_all([(db, db.run(verify))])
    return dict(before=before, owned=owned, vals=vals)


def test_stale_location_cache_rerouted_after_move():
    out = pair(s_stale_cache, 32, n_storages=2)["out"]
    assert out["before"] == b"v15" and list(out["owned"]) == [True, False]
    assert out["vals"]["get"] == b"v15" and out["vals"]["after"] == b"v15b"


def s_cycle_concurrent_moves(c, m, role):
    n = 8
    db0 = c.database()
    init_ring(c, db0, n)
    dd = c.data_distributor()
    run(c, db0, place(dd, splits=(b"cycle/004", b"\xff")))
    dbs = [c.database() for _ in range(3)]

    async def mover():
        for dest in (["ss1"], ["ss0"], ["ss1"]):
            await dd.move(b"cycle/004", dest)
            await c.loop.delay(0.2)

    tasks = [db.process.spawn(cycle_worker(c, db, n, 20)) for db in dbs]
    tasks.append(db0.process.spawn(mover()))
    c.run_until(m.el.all_of(tasks), timeout_vt=5000.0)
    settle(c, db0)
    rows = read_all(c, db0, b"cycle/", b"cycle0")
    return dict(ring=ring_of(rows, n), on_ss1=any(
        v for _b, _e, v in c.storages[1].owned.intersecting(b"cycle/004", b"d")))


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_cycle_invariant_under_concurrent_moves(arm):
    out = pair(s_cycle_concurrent_moves, 33, arm=arm, n_storages=2)["out"]
    assert out["ring"] and out["on_ss1"]


def s_map_authoritative(c, m, role):
    db = c.database()
    fill(c, db, n=10)
    dd = c.data_distributor()

    async def go():
        await place(dd, splits=(b"k005", b"\xff"), moves=((b"k005", ["ss1"]),))
        return await dd.read_shard_map()

    return run(c, db, go())


def test_shard_map_is_authoritative_in_db():
    shard_map = pair(s_map_authoritative, 34, n_storages=2)["out"]
    by_begin = {b: (e, t, d) for b, e, t, d in shard_map}
    assert list(by_begin[b"k005"][1]) == ["ss1"] and not by_begin[b"k005"][2]
    assert list(by_begin[b""][1]) == ["ss0"]


def s_auto_split(c, m, role):
    db = c.database()
    for base in range(0, 160, 40):
        async def big(tr, base=base):
            for i in range(base, base + 40):
                tr.set(b"big/%04d" % i, b"x" * 300)

        c.run_all([(db, db.run(big))])

    async def small(tr):
        for i in range(5):
            tr.set(b"tiny/%02d" % i, b"y")

    c.run_all([(db, db.run(small))])
    settle(c, db)
    dd = c.data_distributor()

    async def go():
        await dd.register_storages(dd.storages)
        await dd.seed(["ss0"])
        return await dd.auto_split(max_shard_bytes=20000)

    split_keys = run(c, db, go(), timeout_vt=5000.0)
    shard_map = run(c, db, dd.read_shard_map(), timeout_vt=1000.0)
    n = len(read_all(c, db, b"big/", b"big0", limit=1 << 20))
    return dict(split=split_keys, shards=len(shard_map), n=n)


def test_auto_split_on_byte_samples():
    out = pair(s_auto_split, 160, n_storages=2)["out"]
    assert out["split"] and all(k.startswith(b"big/") for k in out["split"])
    assert out["shards"] >= 2 and out["n"] == 160


def s_byte_sample_moves(c, m, role):
    db = c.database()

    async def txn(tr):
        for i in range(50):
            tr.set(b"mv/%03d" % i, b"z" * 200)

    c.run_all([(db, db.run(txn))])
    settle(c, db)
    dd = c.data_distributor()
    run(c, db, place(dd, splits=(b"mv/",), moves=((b"mv/", ["ss1"]),)), timeout_vt=5000.0)
    settle(c, db, 0.3)
    s0, s1 = c.storages
    out = [s1.byte_sample.bytes_in(b"mv/", b"mv0"), s0.byte_sample.bytes_in(b"mv/", b"mv0")]

    async def wipe(tr):
        tr.clear_range(b"mv/", b"mv0")

    c.run_all([(db, db.run(wipe))])
    settle(c, db, 0.3)
    return out + [s1.byte_sample.bytes_in(b"mv/", b"mv0")]


def test_byte_sample_follows_moves_and_clears():
    dest, src, wiped = pair(s_byte_sample_moves, 161, n_storages=2)["out"]
    assert dest > 5000 and src == 0 and wiped == 0


def s_auto_merge(c, m, role):
    db = c.database()
    fill(c, db, n=30)
    dd = c.data_distributor()
    run(c, db, place(dd, splits=(b"k010", b"k020", b"\xff")))

    async def merge_round():
        before = [(b, e) for b, e, _t, _d in await dd.read_shard_map() if b < b"\xff"]
        absorbed = await dd.auto_merge(min_shard_bytes=1 << 20)
        after = [(b, e, t) for b, e, t, _d in await dd.read_shard_map() if b < b"\xff"]
        return before, absorbed, after

    before, absorbed, after = run(c, db, merge_round())
    db.invalidate_location(b"")
    v = dict(read_all(c, db))[b"k015"]

    async def split_again():
        async def big(tr):
            for i in range(20):
                tr.set(b"k%03d" % i, b"x" * 5000)

        await db.run(big)
        await c.loop.delay(0.2)
        await dd.split(b"k010")
        return await dd.auto_merge(min_shard_bytes=1)

    return dict(before=before, absorbed=absorbed, after=after, v=v,
                absorbed2=run(c, db, split_again()))


def test_auto_merge_coalesces_small_adjacent_shards():
    out = pair(s_auto_merge, 41, n_storages=2)["out"]
    assert len(out["before"]) == 3 and list(out["absorbed"]) == [b"k010", b"k020"]
    assert len(out["after"]) == 1 and list(out["after"][0][:2]) == [b"", b"\xff"]
    assert out["v"] == b"v15" and list(out["absorbed2"]) == []


def s_superseded_fetch(c, m, role):
    sk = m.sk
    before = m.probe.hit_sites.get("fetch_superseded", 0)
    db = c.database()
    fill(c, db, n=40, prefix=b"m")
    dd = c.data_distributor()
    run(c, db, place(dd))
    settle(c, db)

    def rows(*recs):
        async def txn(tr):
            tr.options["access_system_keys"] = True
            for b, src, dest, e in recs:
                tr.set(sk.key_servers_key(b), sk.encode_key_servers(src, dest, e))
        return txn

    move = rows((b"m000", ["ss0"], ["ss1"], b"m040"))
    c.run_all([(db, db.run(move))])
    c.run_all([(db, db.run(rows((b"m000", ["ss0"], ["ss1"], b"m020"),
                                (b"m020", ["ss0"], [], b"m040"))))])
    c.run_all([(db, db.run(move))])
    settle(c, db, 1.0)
    c.run_all([(db, db.run(rows((b"m000", ["ss1"], [], b"m040"))))])
    settle(c, db, 0.5)
    return dict(rows=read_all(c, db, b"m"),
                fired=m.probe.hit_sites.get("fetch_superseded", 0) > before)


def test_superseded_fetch_stops_write_through(monkeypatch):
    out = pair(s_superseded_fetch, 39, dict(fetch_shard_page_rows=1), monkeypatch=monkeypatch,
               n_storages=2)["out"]
    assert [tuple(r) for r in out["rows"]] == [(b"m%03d" % i, b"v%d" % i) for i in range(40)]
    assert out["fired"]


# ---------------------------------------------------------------------------
# tests/test_replication.py (the cases that distribute data)
# ---------------------------------------------------------------------------


def replicas_agree(c, m, db):
    """test_replication.py's check_replicas_consistent: the replicated
    shards it checked, or None when two replicas differ."""
    version = c.proxy.committed.get()
    alive = {s.storage_id: s.process.alive for s in c.storages}
    checked = 0
    for b, e, v in list(c.proxy.key_servers.items()):
        if v is None or b >= b"\xff":
            continue
        live = [sid for sid in v[0] if alive.get(sid)]
        if len(live) < 2:
            continue
        hi = min(e if e is not None else b"\xff", b"\xff")
        got = [replica_rows(c, m, db, sid, b, hi, version) for sid in live]
        if any(g != got[0] for g in got[1:]):
            return None
        checked += 1
    return checked


def s_replicated_teams(c, m, role):
    db = c.database()
    fill(c, db)
    dd = c.data_distributor()

    async def go():
        await dd.register_storages(dd.storages)
        await dd.seed(["ss0"])
        await dd.spread_evenly(split_points=[b"k020", b"k040"], replication=2)

    run(c, db, go())
    settle(c, db, 0.2)
    owners = sum(any(v for _b, _e, v in s.owned.intersecting(b"k", b"l")) for s in c.storages)

    async def more(tr):
        for i in range(50):
            tr.set(b"k%03d" % i, b"w%d" % i)

    c.run_all([(db, db.run(more))])
    settle(c, db, 0.2)
    return dict(owners=owners, checked=replicas_agree(c, m, db),
                rows=read_all(c, db, b"k", b"k\xff"))


def test_replicated_teams_agree_under_load():
    out = pair(s_replicated_teams, 41, n_storages=3, n_tlogs=2)["out"]
    assert out["owners"] == 3 and out["checked"] >= 3
    assert len(out["rows"]) == 50 and out["rows"][7][1] == b"w7"


def s_kill_and_heal(c, m, role):
    db = c.database()
    fill(c, db)
    dd = c.data_distributor()
    run(c, db, place(dd, splits=(b"k025", b"\xff"),
                     moves=((b"", ["ss0", "ss1"]), (b"k025", ["ss1", "ss2"]))))
    settle(c, db, 0.2)
    c.storages[1].process.kill()
    n_before = len(read_all(c, db, b"k", b"k\xff"))
    run(c, db, dd.heal("ss1", "ss3"), timeout_vt=1000.0)
    settle(c, db, 0.2)
    teams = {b: sorted(t) for b, _e, t, _d in run(c, db, dd.read_shard_map(), timeout_vt=200.0)}
    spare = replica_rows(c, m, db, "ss3", b"k", b"k\xff", c.proxy.committed.get())
    return dict(n_before=n_before, teams=teams, spare=len(spare),
                checked=replicas_agree(c, m, db))


def test_storage_kill_no_data_loss_and_heal():
    out = pair(s_kill_and_heal, 42, n_storages=4, n_tlogs=2)["out"]
    assert out["n_before"] == 50
    assert list(out["teams"][b""]) == ["ss0", "ss3"]
    assert list(out["teams"][b"k025"]) == ["ss2", "ss3"]
    assert out["spare"] == 50 and out["checked"] >= 2


def s_cycle_replication_kill(c, m, role):
    n = 8
    db0 = c.database()
    init_ring(c, db0, n)
    dd = c.data_distributor()
    run(c, db0, place(dd, splits=(b"cycle/004", b"\xff"),
                      moves=((b"", ["ss0", "ss1"]), (b"cycle/004", ["ss1", "ss2"]))))
    settle(c, db0, 0.2)
    dbs = [c.database() for _ in range(3)]

    async def killer():
        await c.loop.delay(0.15)
        c.storages[1].process.kill()

    tasks = [db.process.spawn(cycle_worker(c, db, n, 15)) for db in dbs]
    tasks.append(db0.process.spawn(killer()))
    c.run_until(m.el.all_of(tasks), timeout_vt=5000.0)
    settle(c, db0, 0.2)
    return ring_of(read_all(c, db0, b"cycle/", b"cycle0"), n)


def test_cycle_invariant_with_replication_and_kill():
    assert pair(s_cycle_replication_kill, 44, n_storages=3, n_tlogs=2)["out"]


# ---------------------------------------------------------------------------
# the other reference tests that distribute data
# ---------------------------------------------------------------------------


def s_random_move_keys(c, m, role):
    rmk = m.wl.RandomMoveKeysWorkload(moves=4)
    m.wl.run_workloads(c, [m.wl.CycleWorkload(nodes=8, ops=20, actors=2), rmk],
                       timeout_vt=40000.0)
    return rmk.performed


@pytest.mark.parametrize("seed", [8201, 8202])
def test_random_move_keys_under_load(seed):
    assert pair(s_random_move_keys, seed, n_storages=3, n_proxies=2)["out"] >= 1


def s_exclusion_healing(c, m, role):
    db = c.database()

    async def txn(tr):
        for i in range(30):
            tr.set(b"x%03d" % i, b"v%d" % i)

    c.run_all([(db, db.run(txn))])
    dd = c.data_distributor()

    async def go():
        await dd.register_storages(dd.storages)
        await dd.seed(["ss0"])
        await dd.move(b"", ["ss0", "ss1"])
        await m.mgmt.exclude_servers(db, ["ss0"])
        c.storages[0].process.kill()
        return await dd.process_exclusions(tlogs=[t.interface() for t in c.tlogs])

    acted = run(c, db, go(), timeout_vt=5000.0)
    shard_map = run(c, db, dd.read_shard_map(), timeout_vt=1000.0)
    return dict(acted=acted, map=shard_map, rows=len(read_all(c, db, b"x", b"y")),
                popped=[sorted(t.popped_tags) for t in c.tlogs])


def test_exclusion_drives_dd_healing():
    out = pair(s_exclusion_healing, 123, n_storages=2)["out"]
    assert list(out["acted"]) == ["ss0"] and out["rows"] == 30
    assert all("ss0" not in set(t) | set(d) for _b, _e, t, d in out["map"])
    assert all("ss0" not in p for p in out["popped"])


def s_restart_mid_move(c, m, role):
    db = c.database()

    async def txn(tr):
        for i in range(40):
            tr.set(b"mv%04d" % i, b"val%04d" % i)

    run(c, db, db.run(txn), timeout_vt=600.0)
    dd = c.data_distributor()
    run(c, db, place(dd, splits=(b"mv0020", b"\xff")), timeout_vt=600.0)

    async def start_move(tr):
        tr.options["access_system_keys"] = True
        tr.set(m.sk.key_servers_key(b"mv0020"),
               m.sk.encode_key_servers(["ss0"], ["ss1"], b"\xff"))

    run(c, db, db.run(start_move), timeout_vt=600.0)
    run(c, db, c.loop.delay(0.02), timeout_vt=600.0)
    dst = c.storages[1].process
    dst.kill()
    dst.reboot()
    storage = importlib.import_module(f"{TWINS.BASES[m.pkg]}.server.storage")
    fresh = storage.StorageServer(dst, [t.interface() for t in c.tlogs], storage_id="ss1",
                                  owned_all=False,
                                  epoch_begin_version=c.tlogs[0].durable.get())
    c.storages[1] = fresh
    dd.storages["ss1"] = fresh.interface()
    run(c, db, dd.move(b"mv0020", ["ss1"]), timeout_vt=2000.0)
    return read_all(c, db, b"mv0020", b"mv\xff")


def test_restart_mid_shard_move():
    rows = pair(s_restart_mid_move, 9310, n_storages=2)["out"]
    assert len(rows) == 20 and tuple(rows[0]) == (b"mv0020", b"val0020")


def s_remove_servers(c, m, role):
    db = c.database()

    async def txn(tr):
        for i in range(40):
            tr.set(b"rs%03d" % i, b"v%d" % i)

    c.run_all([(db, db.run(txn))])
    dd = c.data_distributor()
    run(c, db, place(dd, splits=(b"rs020", b"\xff"),
                     moves=((b"", ["ss0", "ss1"]), (b"rs020", ["ss1", "ss2"]))))
    r = role(dd)
    victim = c.storages[1].process
    wl = m.wl.RemoveServersSafelyWorkload(victim="ss1", dd=dd, kill_process=victim)
    m.wl.run_workloads(c, [wl, m.wl.CycleWorkload(nodes=5, ops=10, actors=2)],
                       timeout_vt=30000.0)
    out = dict(drained=wl.drained, alive=victim.alive, rows=len(read_all(c, db, b"rs", b"rt")))
    r.stop()
    return out


def test_remove_servers_safely():
    out = pair(s_remove_servers, 550, FAST_DD, n_storages=4, n_tlogs=2)["out"]
    assert out["drained"] and not out["alive"] and out["rows"] == 40


def s_index_scan_moves(c, m, role):
    loads = [m.wl.IndexScanWorkload(rows=100, scans=8), m.wl.RandomMoveKeysWorkload(moves=6),
             m.wl.ConsistencyChecker()]
    m.wl.run_workloads(c, loads, timeout_vt=90000.0)
    return [loads[0].completed, loads[1].performed]


@pytest.mark.parametrize("seed", [615, 616])
def test_index_scan_through_shard_moves(seed):
    """Without the quiet wait (run_workloads(quiet=True) reads the control
    plane's status, which the port has not yet)."""
    completed, performed = pair(s_index_scan_moves, seed, n_proxies=2, n_storages=3)["out"]
    assert completed >= 1 and performed >= 1


def s_metadata_proxies(c, m, role):
    db = c.database()

    async def txn(tr):
        for i in range(40):
            tr.set(b"m%03d" % i, b"v%d" % i)

    c.run_all([(db, db.run(txn))])
    dd = c.data_distributor()

    async def go():
        await dd.register_storages(dd.storages)
        await dd.seed(["ss0"])
        await dd.split(b"m020")
        await dd.move(b"m020", ["ss1"])

    run(c, db, go(), timeout_vt=5000.0)
    dbs = [c.database() for _ in range(2)]
    dbs[1]._proxy_rr = {"grv": 1, "commit": 1}

    def writer(d, base):
        async def go():
            for i in range(base, base + 10):
                async def w(tr, i=i):
                    tr.set(b"m%03d" % (20 + i % 20), b"w%d" % i)

                await d.run(w)
        return go()

    c.run_all([(d, writer(d, i * 10)) for i, d in enumerate(dbs)], timeout_vt=5000.0)
    return dict(routes=[p.key_servers[b"m025"][0] for p in c.proxies],
                rows=len(read_all(c, db, b"m020", b"m040")))


def test_metadata_propagates_across_proxies():
    out = pair(s_metadata_proxies, 74, n_proxies=2, n_storages=2)["out"]
    assert [list(r) for r in out["routes"]] == [["ss1"], ["ss1"]] and out["rows"] == 20


def s_hedged_read(c, m, role):
    db = c.database()

    async def txn(tr):
        for i in range(10):
            tr.set(b"h%02d" % i, b"v%d" % i)

    c.run_all([(db, db.run(txn))])
    dd = c.data_distributor()
    run(c, db, place(dd, moves=((b"", ["ss0", "ss1"]),)), timeout_vt=5000.0)
    first = db.queue_model.order(["ss0", "ss1"])[0]
    proc = {s.storage_id: s.process for s in c.storages}[first]
    out = {}

    async def read():
        c.net.clog_pair(db.process.machine.machine_id, proc.machine.machine_id, 30.0)
        t0 = c.loop.now()
        tr = db.create_transaction()
        out["val"] = await tr.get(b"h03")
        out["dt"] = c.loop.now() - t0

    c.run_all([(db, read())], timeout_vt=1000.0)
    return out


def test_hedged_read_beats_clogged_replica():
    out = pair(s_hedged_read, 140, n_storages=2)["out"]
    assert out["val"] == b"v3" and out["dt"] < 5.0


def s_dd_balance(c, m, role):
    db = c.database()
    dd = c.data_distributor()
    run(c, db, place(dd, splits=(b"\xff",)))
    r = role(dd)
    wl = m.wl.DDBalanceWorkload()
    m.wl.run_workloads(c, [wl], timeout_vt=90000.0)
    out = dict(counts=sorted(wl.final_counts.items()), splits=r.splits_done, moves=r.moves_done)
    r.stop()
    return out


def test_dd_balance_converges_with_the_dd_role():
    """test_new_workloads.py's DDBalance case at its thresholds, on a
    SimCluster whose DD role the test starts (the reference test runs it
    on the control plane's DynamicCluster)."""
    out = pair(s_dd_balance, 598, dict(shard_max_bytes=2500, shard_min_bytes=0),
               n_proxies=2, n_storages=3)["out"]
    counts = dict(out["counts"])
    assert len(counts) >= 2 and max(counts.values()) - min(counts.values()) <= 2
    assert out["splits"] >= 1 and out["moves"] >= 1


def test_port_role_reads_no_knob_and_keeps_the_defaults():
    """Every dd_* knob the reference's role reads is a constructor
    argument of the port's, with the reference's default."""
    role = importlib.import_module("foundationdb_tpu_torch.server.dd_role")
    params = inspect.signature(role.DataDistributionRole).parameters
    names = [n for n in params if n not in ("self", "dd", "tlogs", "active_fn")]
    assert len(names) == 7
    for n in names:
        assert params[n].default == getattr(g_knobs.server, "dd_" + n), n
    for mod in ("dd_role", "data_distribution", "ratekeeper"):
        src = pathlib.Path(importlib.import_module(
            f"foundationdb_tpu_torch.server.{mod}").__file__).read_text()
        assert "g_knobs" not in src and "foundationdb_tpu." not in src
