"""The port's client, held to the reference's on the CPU.

The port's ``client/transaction.py`` (Database, Transaction,
transactional), ``rpc/loadbalance.py``, ``client/management.py``,
``SimCluster.database()``/``run_all``/``resolver_balancer()`` and
``server/resolver_balancer.py``'s ResolverBalancer run the same scripts as
the reference's, each through its own package's SimCluster, event loop,
network and roles.  The scripts are twins of the reference's
tests/test_e2e.py (its 13 tests; the backend differential on the cpu
backends only), test_grv_batching.py, test_multi_resolver.py,
test_resolver_split.py, test_lock_database.py's SimCluster case, the
SimCluster cases of test_multi_proxy.py that need no data distribution,
and test_locality_loadbalance.py's QueueModel and hedged-read tests (the
replicated team made by the client's own system-key transactions, where
the reference's test asks data distribution), at their seeds and sizes;
then the witness-guided retry (``Database(witness_retry=)`` against the
reference's FDB_TPU_WITNESS_RETRY), the commit-unknown fence (a proxy
killed under a commit), and the rest of the API with every management
transaction.

Two arms: ``cpu`` (each package's host engine, ``conflict_backend="cpu"``)
and ``set`` (every resolver of both clusters over a port
``ConflictSet(device="cpu")``, the kernels' plain twins, at key_words=4 so
the client's 14-byte self-conflict keys fit the device width, h_cap
1,024).  Held equal: every point read, range read, commit and retry with
its virtual time and client (chip_smoke's ClientLog: values, versions,
each error's name and detail, the retry count and the read version a
witness hint leaves), each script's own results, every client's
witness_hint_retries, latency samples, round-robin counters, GRV lanes,
location cache and queue model (chip_smoke's client_state), the proxies'
GRV counters, resolver bounds, lock and registries, the resolvers'
registries and witness blocks, and the loop's end time and rng.
"""

from __future__ import annotations

import importlib
import importlib.util
import pathlib
import types as pytypes

import pytest

import foundationdb_tpu.flow.eventloop as ref_el
import foundationdb_tpu.flow.flight_recorder as ref_fr
import foundationdb_tpu.flow.spans as ref_spans
import foundationdb_tpu.flow.trace as ref_trace
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.flow import eventloop as port_el
from foundationdb_tpu_torch.flow import flight_recorder as port_fr
from foundationdb_tpu_torch.flow import spans as port_spans
from foundationdb_tpu_torch.flow import timeseries as port_ts
from foundationdb_tpu_torch.flow import trace as port_trace

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)

BASES = {"ref": "foundationdb_tpu", "port": "foundationdb_tpu_torch"}
ref_buggify = importlib.import_module("foundationdb_tpu.flow.buggify")
port_buggify = importlib.import_module("foundationdb_tpu_torch.flow.buggify")


def mods(pkg):
    """The modules a script needs, from `pkg`'s package."""
    base = BASES[pkg]
    imp = importlib.import_module
    return pytypes.SimpleNamespace(
        pkg=pkg,
        cluster=imp(f"{base}.server.cluster"),
        tx=imp(f"{base}.client.transaction"),
        types=imp(f"{base}.client.types"),
        error=imp(f"{base}.flow.error"),
        el=imp(f"{base}.flow.eventloop"),
        mgmt=imp(f"{base}.client.management"),
        itf=imp(f"{base}.server.interfaces"),
        lb=imp(f"{base}.rpc.loadbalance"),
        wl=imp(f"{base}.workloads"),
    )


@pytest.fixture(autouse=True)
def _restore_globals():
    saved = (ref_spans.global_span_hub(), ref_trace.global_collector(),
             ref_fr.global_flight_recorder(), port_spans.global_span_hub(),
             port_trace.global_collector(), port_trace._global_clock,
             port_fr.global_flight_recorder(), port_ts.global_timeseries())
    yield
    ref_el.set_event_loop(None)
    port_el.set_event_loop(None)
    ref_buggify.set_buggify_enabled(False)
    port_buggify.set_buggify_enabled(False)
    ref_spans.set_global_span_hub(saved[0])
    ref_trace.set_global_collector(saved[1])
    ref_fr.set_global_flight_recorder(saved[2])
    port_spans.set_global_span_hub(saved[3])
    port_trace.set_global_collector(saved[4], clock=saved[5])
    port_fr.set_global_flight_recorder(saved[6])
    port_ts.set_global_timeseries(saved[7])


def _install_hubs(pkg):
    """Fresh span hub, trace collector and flight recorder of `pkg`'s
    package, installed into both packages' globals."""
    if pkg == "ref":
        hub, col, rec = ref_spans.SpanHub(), ref_trace.TraceCollector(), ref_fr.FlightRecorder()
    else:
        hub, col, rec = port_spans.SpanHub(), port_trace.TraceCollector(), port_fr.FlightRecorder()
    ref_spans.set_global_span_hub(hub)
    port_spans.set_global_span_hub(hub)
    ref_trace.set_global_collector(col)
    port_trace.set_global_collector(col)
    ref_fr.set_global_flight_recorder(rec)
    port_fr.set_global_flight_recorder(rec)
    port_ts.set_global_timeseries(port_ts.TimeSeriesHub())


def _set(depth=None):
    kw = {} if depth is None else {"pipeline_depth": depth}
    return ConflictSet(device="cpu", **kw, **SMOKE.CLIENT_SET_KW)


def cluster(m, arm, seed, depth=None, **kw):
    """`m`'s SimCluster for `arm`: its host engine ("cpu"), or every
    resolver over a port ConflictSet(device="cpu") ("set"), at pipeline
    depth `depth` when given."""
    if arm == "cpu":
        return m.cluster.SimCluster(seed=seed, conflict_backend="cpu", **kw)
    if m.pkg == "port":
        kw["device"] = "cpu"
    with SMOKE.resolver_sets(m.cluster, lambda: _set(depth)):
        return m.cluster.SimCluster(seed=seed, **kw)


def record(pkg, arm, script, seed, **cluster_kw):
    """`script(c, m)` through `pkg`'s cluster in `arm`; returns its record."""
    m = mods(pkg)
    _install_hubs(pkg)
    c = cluster(m, arm, seed, **cluster_kw)
    dbs = SMOKE.tracked_databases(c)
    log = SMOKE.ClientLog(m.tx)
    try:
        out = script(c, m)
    finally:
        log.remove()
        m.el.set_event_loop(None)
    return dict(
        out=SMOKE.norm(out),
        events=log.events,
        clients=SMOKE.client_state(dbs),
        proxies=[(p.stats.counter("grv_requests").value, p.resolver_bounds, p.locked_uid,
                  p.metrics.snapshot_json()) for p in c.proxies],
        resolvers=[(r.total_resolved, r.metrics.snapshot_json(), r.conflict_witness())
                   for r in c.resolvers],
        end=(c.loop.now(), c.loop.rng.random_int(0, 1 << 30)),
    )


def pair(arm, script, seed, **cluster_kw):
    """The reference's record and the port's; asserts them equal and
    returns the port's script output."""
    ref = record("ref", arm, script, seed, **cluster_kw)
    port = record("port", arm, script, seed, **cluster_kw)
    assert port["events"] == ref["events"]
    for key in ref:
        assert port[key] == ref[key], key
    return port["out"]


def caught(m, coro):
    """Await `coro`: ("ok", value) or ("error", name, detail)."""
    async def go():
        try:
            return ("ok", await coro)
        except m.error.FdbError as e:
            return ("error", e.name, e.detail)
    return go()


# ---------------------------------------------------------------------------
# tests/test_e2e.py's scripts
# ---------------------------------------------------------------------------


def s_set_get_commit(c, m):
    db = c.database()
    out = {}

    async def go(tr):
        tr.set(b"hello", b"world")
        out["pre"] = await tr.get(b"hello")

    c.run_all([(db, db.run(go))])

    async def check(tr):
        out["post"] = await tr.get(b"hello")
        out["missing"] = await tr.get(b"nope")

    c.run_all([(db, db.run(check))])
    return out


def s_clear_range_and_get_range(c, m):
    db = c.database()
    out = {}

    async def fill(tr):
        for i in range(10):
            tr.set(b"k%02d" % i, b"v%d" % i)

    async def clear(tr):
        tr.clear_range(b"k03", b"k07")
        out["ryw"] = await tr.get_range(b"k", b"l")

    async def check(tr):
        out["post"] = await tr.get_range(b"k", b"l")
        out["limited"] = await tr.get_range(b"k", b"l", limit=2)
        out["rev"] = await tr.get_range(b"k", b"l", limit=2, reverse=True)

    for fn in (fill, clear, check):
        c.run_all([(db, db.run(fn))])
    return out


def s_conflict_between_transactions(c, m):
    db1, db2 = c.database(), c.database()
    results = []

    def make(db, me):
        async def go():
            tr = db.create_transaction()
            try:
                v = await tr.get(b"counter")
                tr.set(b"counter", b"%d" % (int(v or b"0") + 1))
                await tr.commit()
                results.append((me, "committed"))
            except m.error.FdbError as e:
                results.append((me, e.name))

        return go()

    c.run_all([(db1, make(db1, 1)), (db2, make(db2, 2))])
    return results


def cycle_ring(c, m, key, n=8, ops=30, clients=4, timeout_vt=5000.0):
    """test_e2e's and test_multi_proxy's Cycle: a ring of `n` under
    `key(i)`, `clients` databases of `ops` rotations each; returns the
    ring read back as successor numbers."""
    db_init = c.database()

    async def init(tr):
        for i in range(n):
            tr.set(key(i), b"%03d" % ((i + 1) % n))

    c.run_all([(db_init, db_init.run(init))], timeout_vt=timeout_vt)
    dbs = [c.database() for _ in range(clients)]
    done = []

    def worker(db, wid):
        async def go():
            rng = c.loop.rng
            for _ in range(ops):
                async def op(tr):
                    a = int(rng.random_int(0, n))
                    b = int((await tr.get(key(a))).decode())
                    cc = int((await tr.get(key(b))).decode())
                    d = int((await tr.get(key(cc))).decode())
                    tr.set(key(a), b"%03d" % cc)
                    tr.set(key(cc), b"%03d" % b)
                    tr.set(key(b), b"%03d" % d)

                await db.run(op)
            done.append(wid)

        return go()

    c.run_all([(db, worker(db, i)) for i, db in enumerate(dbs)], timeout_vt=timeout_vt)
    assert len(done) == clients
    out = {}

    async def check(tr):
        out["ring"] = await tr.get_range(key(0)[:-3], key(0)[:-4] + bytes([key(0)[-4] + 1]))

    c.run_all([(db_init, db_init.run(check))], timeout_vt=timeout_vt)
    return [int(v.decode()) for _k, v in out["ring"]]


def s_cycle_workload_invariant(c, m):
    return cycle_ring(c, m, lambda i: b"cycle/%03d" % i)


def s_atomic_ops_end_to_end(c, m):
    db = c.database()
    out = {}
    MT = m.types.MutationType

    async def add(tr):
        tr.atomic_op(MT.ADD_VALUE, b"sum", (5).to_bytes(8, "little"))

    for _ in range(3):
        c.run_all([(db, db.run(add))])

    async def check(tr):
        out["sum"] = await tr.get(b"sum")
        tr.atomic_op(MT.ADD_VALUE, b"sum", (1).to_bytes(8, "little"))
        out["ryw"] = await tr.get(b"sum")
        tr.atomic_op(MT.BYTE_MAX, b"bm", b"abc")
        out["bm"] = await tr.get(b"bm")

    c.run_all([(db, db.run(check))])
    return out


def s_versionstamped_key(c, m):
    db = c.database()

    async def write(tr):
        key = b"log/" + b"\x00" * 10 + (4).to_bytes(4, "little")
        tr.atomic_op(m.types.MutationType.SET_VERSIONSTAMPED_KEY, key, b"payload")

    c.run_all([(db, db.run(write))])
    out = {}

    async def check(tr):
        out["rows"] = await tr.get_range(b"log/", b"log0")

    c.run_all([(db, db.run(check))])
    return out


def s_set_then_clear_same_transaction(c, m):
    db = c.database()

    async def w1(tr):
        tr.set(b"a", b"x")
        tr.clear(b"a")
        tr.clear(b"b")
        tr.set(b"b", b"y")

    c.run_all([(db, db.run(w1))])
    out = {}

    async def check(tr):
        out["a"] = await tr.get(b"a")
        out["b"] = await tr.get(b"b")

    c.run_all([(db, db.run(check))])
    return out


def s_versionstamp_invalid_offset_rejected(c, m):
    tr = c.database().create_transaction()
    try:
        tr.atomic_op(m.types.MutationType.SET_VERSIONSTAMPED_KEY,
                     b"xy" + (100).to_bytes(4, "little"), b"v")
    except m.error.FdbError as e:
        return e.name
    return "accepted"


def s_limited_range_read_trims_conflict_range(c, m):
    db1, db2 = c.database(), c.database()

    async def fill(tr):
        for i in range(6):
            tr.set(b"t%02d" % i, b"v")

    c.run_all([(db1, db1.run(fill))])
    results = []

    async def limited_reader():
        tr = db1.create_transaction()
        try:
            rows = await tr.get_range(b"t", b"u", limit=2)
            results.append([k for k, _ in rows])
            await c.loop.delay(0.05)
            tr.set(b"reader_done", b"1")
            await tr.commit()
            results.append("reader_committed")
        except m.error.FdbError as e:
            results.append(f"reader_{e.name}")

    async def far_writer():
        tr = db2.create_transaction()
        await tr.get_read_version()
        tr.set(b"t05", b"clobber")
        await tr.commit()
        results.append("writer_committed")

    c.run_all([(db1, limited_reader()), (db2, far_writer())])
    return results


def s_causal_consistency_across_clients(c, m):
    a, b = c.database(), c.database()
    out = {}

    async def writer(tr):
        tr.set(b"flag", b"1")

    c.run_all([(a, a.run(writer))])

    async def reader(tr):
        out["v"] = await tr.get(b"flag")

    c.run_all([(b, b.run(reader))])
    return out


def s_determinism(c, m):
    """test_determinism_same_seed_same_history's run(seed)."""
    dbs = [c.database() for _ in range(3)]
    log = []

    def w(db, i):
        async def go():
            for _j in range(5):
                async def op(tr):
                    v = await tr.get(b"x")
                    tr.set(b"x", (v or b"") + b"%d" % i)

                await db.run(op)
            log.append((i, round(c.loop.now(), 9)))

        return go()

    c.run_all([(db, w(db, i)) for i, db in enumerate(dbs)])
    final = {}

    async def check(tr):
        final["x"] = await tr.get(b"x")

    c.run_all([(dbs[0], dbs[0].run(check))])
    return log, final["x"]


def s_differential(c, m):
    """test_differential_cpu_vs_jax_backend's workload."""
    dbs = [c.database() for _ in range(3)]
    history = []

    def w(db, i):
        async def go():
            rng = c.loop.rng
            for j in range(6):
                tr = db.create_transaction()
                try:
                    k = b"d/%d" % int(rng.random_int(0, 5))
                    v = await tr.get(k)
                    tr.set(k, (v or b"") + b"%d" % i)
                    await tr.commit()
                    history.append((i, j, "ok"))
                except m.error.FdbError as e:
                    history.append((i, j, e.name))

        return go()

    c.run_all([(db, w(db, i)) for i, db in enumerate(dbs)], timeout_vt=5000.0)
    out = {}

    async def check(tr):
        out["all"] = await tr.get_range(b"d/", b"d0")

    c.run_all([(dbs[0], dbs[0].run(check))])
    return history, out["all"]


def s_limited_range_read_pages_past_local_clears(c, m):
    db = c.database()
    out = {}

    async def fill(tr):
        for i in range(1, 6):
            tr.set(b"p%d" % i, b"v%d" % i)

    async def read(tr):
        tr.clear_range(b"p1", b"p3")
        out["fwd"] = await tr.get_range(b"p", b"q", limit=3)
        out["rev"] = await tr.get_range(b"p", b"q", limit=5, reverse=True)

    c.run_all([(db, db.run(fill))])
    c.run_all([(db, db.run(read))])
    return out


def keys_of(rows):
    return [k for k, _v in rows]


E2E = [
    # (id, script, seed, arms, check of the port's output)
    ("set_get_commit", s_set_get_commit, 1, ("cpu", "set"),
     lambda o: o == {"pre": b"world", "post": b"world", "missing": None}),
    ("clear_range_and_get_range", s_clear_range_and_get_range, 2, ("cpu",),
     lambda o: keys_of(o["post"]) == [b"k00", b"k01", b"k02", b"k07", b"k08", b"k09"]
     and o["ryw"] == o["post"] and keys_of(o["limited"]) == [b"k00", b"k01"]
     and keys_of(o["rev"]) == [b"k09", b"k08"]),
    ("conflict_between_transactions", s_conflict_between_transactions, 3, ("cpu", "set"),
     lambda o: sorted(s for _, s in o) == ["committed", "not_committed"]),
    ("cycle_workload_invariant", s_cycle_workload_invariant, 4, ("cpu",),
     lambda o: SMOKE.ring_ok(o) and len(o) == 8),
    ("atomic_ops_end_to_end", s_atomic_ops_end_to_end, 5, ("cpu",),
     lambda o: int.from_bytes(o["sum"], "little") == 15
     and int.from_bytes(o["ryw"], "little") == 16 and o["bm"] == b"abc"),
    ("versionstamped_key", s_versionstamped_key, 6, ("cpu", "set"),
     lambda o: len(o["rows"]) == 1 and o["rows"][0][1] == b"payload"
     and len(o["rows"][0][0]) == 14 and int.from_bytes(o["rows"][0][0][4:12], "big") > 0),
    ("set_then_clear_same_transaction", s_set_then_clear_same_transaction, 13, ("cpu",),
     lambda o: o == {"a": None, "b": b"y"}),
    ("versionstamp_invalid_offset_rejected", s_versionstamp_invalid_offset_rejected, 14,
     ("cpu",), lambda o: o == "client_invalid_operation"),
    ("limited_range_read_trims_conflict_range", s_limited_range_read_trims_conflict_range, 15,
     ("cpu", "set"), lambda o: o[0] == [b"t00", b"t01"] and "reader_committed" in o
     and "writer_committed" in o),
    ("causal_consistency_across_clients", s_causal_consistency_across_clients, 7, ("cpu",),
     lambda o: o == {"v": b"1"}),
    ("limited_range_read_pages_past_local_clears", s_limited_range_read_pages_past_local_clears,
     21, ("cpu",), lambda o: keys_of(o["fwd"]) == [b"p3", b"p4", b"p5"]
     and keys_of(o["rev"]) == [b"p5", b"p4", b"p3"]),
]


@pytest.mark.parametrize(
    "script,seed,arm,check",
    [pytest.param(s, seed, arm, chk, id=f"{name}-{arm}")
     for name, s, seed, arms, chk in E2E for arm in arms])
def test_e2e_scripts_match_the_reference(script, seed, arm, check):
    assert check(pair(arm, script, seed))


def test_determinism_same_seed_same_history():
    runs = {seed: pair("cpu", s_determinism, seed) for seed in (11, 12)}
    assert runs[11] == pair("cpu", s_determinism, 11)
    assert runs[11] != runs[12]


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_differential_on_the_cpu_backends(arm):
    """test_differential_cpu_vs_jax_backend on the cpu backends: the
    reference's and the port's histories and states equal in each arm,
    and the two arms' histories equal each other."""
    history, state = pair(arm, s_differential, 99)
    assert len(history) == 18 and any(s == "ok" for _i, _j, s in history)
    assert sum(len(v) for _k, v in state) == sum(1 for h in history if h[2] == "ok")


# ---------------------------------------------------------------------------
# test_grv_batching.py's scripts
# ---------------------------------------------------------------------------


def _grv_requests(c):
    return sum(p.stats.counter("grv_requests").value for p in c.proxies)


def s_grv_coalesce(c, m):
    db = c.database("grv")
    versions = []

    async def one():
        tr = db.create_transaction()
        versions.append(await tr.get_read_version())

    async def burst():
        await m.el.all_of([db.process.spawn(one(), f"g{i}") for i in range(24)])

    before = _grv_requests(c)
    c.run_until(db.process.spawn(burst()), timeout_vt=1000.0)
    return versions, _grv_requests(c) - before


def s_grv_current(c, m):
    db = c.database("grv2")

    async def flow():
        tr = db.create_transaction()
        tr.set(b"gb", b"1")
        committed = await tr.commit()
        trs = [db.create_transaction() for _ in range(2)]
        vs = [await t.get_read_version() for t in trs]
        reads = [await t.get(b"gb") for t in trs]
        return committed, vs, reads

    return c.run_until(db.process.spawn(flow()), timeout_vt=1000.0)


def s_grv_error(c, m):
    db = c.database("grv3")
    results = []

    async def one(i):
        tr = db.create_transaction()
        try:
            results.append(await tr.get_read_version())
        except m.error.FdbError as e:
            results.append(e.name)

    async def burst_with_kill():
        tasks = [db.process.spawn(one(i), f"k{i}") for i in range(6)]
        c.proxy.process.kill()
        await m.el.all_of(tasks)

    c.run_until(db.process.spawn(burst_with_kill()), timeout_vt=1000.0)
    return results


def test_concurrent_grvs_coalesce_on_the_wire():
    versions, sent = pair("cpu", s_grv_coalesce, 710, n_proxies=1)
    assert len(versions) == 24 and all(v is not None for v in versions)
    assert sent <= 3


def test_batched_versions_are_current():
    committed, vs, reads = pair("cpu", s_grv_current, 711, n_proxies=1)
    assert all(v >= committed for v in vs) and reads == [b"1", b"1"]


def test_grv_error_propagates_to_all_waiters():
    results = pair("cpu", s_grv_error, 712, n_proxies=1)
    assert len(results) == 6
    assert all(isinstance(r, int) or r == "broken_promise" for r in results)


# ---------------------------------------------------------------------------
# test_multi_resolver.py's and test_resolver_split.py's scripts
# ---------------------------------------------------------------------------


def s_spread_appends(c, m):
    dbs = [c.database() for _ in range(3)]
    history = []

    def w(db, i):
        async def go():
            rng = c.loop.rng
            for j in range(8):
                tr = db.create_transaction()
                try:
                    k = bytes([int(rng.random_int(0, 250))]) + b"/k"
                    v = await tr.get(k)
                    tr.set(k, (v or b"") + b"%d" % i)
                    await tr.commit()
                    history.append((i, j, "ok"))
                except m.error.FdbError as e:
                    history.append((i, j, e.name))

        return go()

    c.run_all([(db, w(db, i)) for i, db in enumerate(dbs)], timeout_vt=2000.0)
    out = {}

    async def check(tr):
        out["state"] = await tr.get_range(b"", b"\xff")

    c.run_all([(dbs[0], dbs[0].run(check))])
    return history, out["state"], [r.total_resolved for r in c.resolvers]


@pytest.mark.parametrize("n_resolvers", [1, 4])
def test_no_lost_updates_across_resolvers(n_resolvers):
    history, state, resolved = pair("cpu", s_spread_appends, 55, n_resolvers=n_resolvers)
    committed = sum(1 for (_i, _j, s) in history if s == "ok")
    assert sum(len(v) for _k, v in state) == committed
    assert all(r == resolved[0] for r in resolved) and resolved[0] > 0


def s_cross_boundary(c, m):
    db1, db2 = c.database(), c.database()
    results = []

    def make(db, me, key):
        async def go():
            tr = db.create_transaction()
            try:
                await tr.get_range(b"\x10", b"\xf0", limit=5)
                tr.set(key, b"x")
                await tr.commit()
                results.append((me, "committed"))
            except m.error.FdbError as e:
                results.append((me, e.name))

        return go()

    c.run_all([(db1, make(db1, 1, b"\x20k")), (db2, make(db2, 2, b"\xe0k"))], timeout_vt=500.0)
    return results


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_cross_boundary_conflicts_detected(arm):
    results = pair(arm, s_cross_boundary, 56, n_resolvers=4)
    assert sorted(s for _, s in results) == ["committed", "not_committed"]


def s_metrics_and_split(c, m):
    db = c.database()

    async def load():
        for i in range(30):
            async def op(tr, i=i):
                await tr.get(b"hot/%03d" % (i % 5))
                tr.set(b"hot/%03d" % (i % 5), b"x")

            await db.run(op)

    c.run_all([(db, load())], timeout_vt=2000.0)
    out = {}

    async def query():
        iface = c.resolvers[0].interface()
        rep = await iface.metrics.get_reply(db.process, None)
        out["ops"] = rep.ops
        out["split"] = await iface.split.get_reply(
            db.process, m.itf.ResolutionSplitRequest(begin=b"", end=None, fraction=0.5))

    c.run_until(db.process.spawn(query()), timeout_vt=100.0)
    return out


def test_metrics_and_split_service():
    out = pair("cpu", s_metrics_and_split, 101, n_resolvers=1)
    assert out["ops"] > 0 and out["split"].startswith(b"hot/")


def s_skewed_load_moves_the_split(c, m):
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
    moved = c.run_until(db.process.spawn(bal.run_once()), timeout_vt=1000.0)
    settle = c.database()

    async def nudge(tr):
        tr.set(b"nudge", b"1")

    c.run_all([(settle, settle.run(nudge))], timeout_vt=1000.0)
    return moved, bal.split_keys, bal.moves, [p.resolver_bounds for p in c.proxies]


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_skewed_load_moves_the_split(arm):
    moved, splits, moves, bounds = pair(arm, s_skewed_load_moves_the_split, 102, n_resolvers=2)
    assert moved is not None and moved[0].startswith(b"hot/") and splits == moved
    assert moves == 1 and all(b[0][1].startswith(b"hot/") for b in bounds)


def s_balancer_poll_loop(c, m):
    """test_resolver_split's skewed load, then the balancer's own poll loop
    (ResolverBalancer.run) for three rounds: the first moves the split and
    waits out the proxies' overlap window (MVCC window + in-flight depth,
    in seconds) before resetting the resolvers' metrics; the next two find
    no skew and only wait their interval.  Returns the moves, the splits,
    and the virtual time each round began."""
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
    starts = []
    run_once = bal.run_once

    async def timed_round():
        starts.append(c.loop.now())
        return await run_once()

    bal.run_once = timed_round
    c.run_until(db.process.spawn(bal.run(interval=0.2, rounds=3)), timeout_vt=1000.0)
    return bal.moves, bal.split_keys, [t - starts[0] for t in starts]


def test_balancer_poll_loop_waits_out_the_overlap_window(monkeypatch):
    """The in-flight depth cut from 100,000,000 versions to 2,000,000 in
    both packages (the reference's knob; the port's proxy, storage and
    balancer constants), so that the overlap window is 7 s of virtual time
    instead of 105."""
    from foundationdb_tpu.flow.knobs import g_knobs

    monkeypatch.setattr(g_knobs.server, "max_versions_in_flight", 2_000_000)
    for mod in ("proxy", "storage", "resolver_balancer"):
        monkeypatch.setattr(importlib.import_module(f"foundationdb_tpu_torch.server.{mod}"),
                            "MAX_VERSIONS_IN_FLIGHT", 2_000_000)
    moves, splits, starts = pair("cpu", s_balancer_poll_loop, 104, n_resolvers=2)
    assert moves == 1 and splits[0].startswith(b"hot/")
    assert 7.2 <= starts[1] < 7.5 and 0.2 <= starts[2] - starts[1] < 0.5


def s_serializability_across_split_moves(c, m):
    db = c.database()
    bal = c.resolver_balancer(min_ops=10, ratio=1.2)
    stop = []

    async def balance_loop():
        while not stop:
            await bal.run_once()
            await c.loop.delay(0.15)

    task = db.process.spawn(balance_loop(), "balancer")
    ring = m.wl.CycleWorkload(nodes=8, ops=30, actors=4)
    m.wl.run_workloads(c, [ring])
    stop.append(True)
    c.run_until(task, timeout_vt=2000.0)
    return bal.moves, bal.split_keys


def test_serializability_across_split_moves():
    moves, splits = pair("cpu", s_serializability_across_split_moves, 103, n_resolvers=2,
                         n_proxies=2)
    assert moves >= 1 and len(splits) == 1


# ---------------------------------------------------------------------------
# test_lock_database.py's and test_multi_proxy.py's scripts
# ---------------------------------------------------------------------------


def s_lock(c, m):
    db = c.database("lk")
    out = {}

    async def flow():
        tr = db.create_transaction()
        tr.set(b"pre", b"1")
        await tr.commit()
        uid = await m.mgmt.lock_database(db)
        out["uid"] = uid
        for _ in range(200):
            if all(p.locked_uid == uid for p in c.proxies):
                break
            await c.loop.delay(0.05)
        out["all_locked"] = all(p.locked_uid == uid for p in c.proxies)
        tr2 = db.create_transaction()
        tr2.set(b"blocked", b"x")
        out["commit"] = await caught(m, tr2.commit())
        tr3 = db.create_transaction()
        out["grv"] = await caught(m, tr3.get_read_version())
        tr4 = db.create_transaction()
        tr4.options["lock_aware"] = True
        out["aware read"] = await tr4.get(b"pre")
        tr4.set(b"aware", b"ok")
        await tr4.commit()
        out["relock"] = await caught(m, m.mgmt.lock_database(db, uid=b"someone-else"))
        await m.mgmt.unlock_database(db, uid)

        async def post(tr):
            tr.set(b"post", b"2")

        await db.run(post)

        async def read(tr):
            out["post"] = await tr.get(b"post")

        await db.run(read)
        return True

    assert c.run_until(db.process.spawn(flow()), timeout_vt=5000.0)
    return out


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_lock_blocks_commits_and_grvs_until_unlock(arm):
    out = pair(arm, s_lock, 840, n_proxies=2)
    assert out["all_locked"] and out["aware read"] == b"1"
    assert out["commit"][:2] == ("error", "database_locked")
    assert out["grv"][:2] == ("error", "database_locked")
    assert out["relock"][:2] == ("error", "database_locked")
    assert out["post"] == b"2"


def s_cycle_multi(c, m):
    ring = cycle_ring(c, m, lambda i: b"cycle/%03d" % i, ops=25)
    return ring, [p.stats["batches"] for p in c.proxies]


@pytest.mark.parametrize("seed,kw", [(71, dict(n_proxies=2)),
                                     (72, dict(n_proxies=2, n_resolvers=2))],
                         ids=["two_proxies", "two_proxies_two_resolvers"])
def test_cycle_through_two_proxies(seed, kw):
    ring, batches = pair("cpu", s_cycle_multi, seed, **kw)
    assert SMOKE.ring_ok(ring) and len(ring) == 8
    assert all(b > 0 for b in batches)


def s_causal_across_proxies(c, m):
    writer, reader = c.database(), c.database()
    reader._proxy_rr = {"grv": 1, "commit": 1}
    failures = []

    async def go():
        for i in range(20):
            async def w(tr):
                tr.set(b"causal", b"%d" % i)

            await writer.run(w)

            async def r(tr):
                v = await tr.get(b"causal")
                if v is None or int(v.decode()) < i:
                    failures.append((i, v))

            await reader.run(r)

    c.run_all([(writer, go())], timeout_vt=5000.0)
    return failures


def test_causal_consistency_across_proxies():
    assert pair("cpu", s_causal_across_proxies, 73, n_proxies=2) == []


# ---------------------------------------------------------------------------
# QueueModel, the witness-guided retry and the commit-unknown fence
# ---------------------------------------------------------------------------


def queue_model_trace(lb):
    """test_queue_model_prefers_fast_and_penalizes_failures's steps; the
    order and the model's state after each."""
    m = lb.QueueModel()
    out = []

    def step():
        out.append((m.order(["slow", "fast"]), sorted(m._latency.items()),
                    sorted(m._penalty.items()), m.expected("fast")))

    m.update("fast", 0.001, False)
    m.update("slow", 0.1, False)
    step()
    for _ in range(3):
        m.update("fast", 0.001, True)
    step()
    for _ in range(3):
        m.update("fast", 0.001, False)
    step()
    return out


def test_queue_model_prefers_fast_and_penalizes_failures():
    port = queue_model_trace(mods("port").lb)
    assert port == queue_model_trace(mods("ref").lb)
    assert [o[0] for o in port] == [["fast", "slow"], ["slow", "fast"], ["fast", "slow"]]


def s_contended_ring(c, m):
    """A ring of 6 nodes under 6 clients of 8 rotations: most attempts
    conflict, and each retry reads where the abort witness points."""
    return cycle_ring(c, m, lambda i: b"w/%03d" % i, n=6, ops=8, clients=6)


@pytest.mark.parametrize("hint", [True, False], ids=["on", "off"])
def test_witness_retry_matches_the_reference(monkeypatch, hint):
    """Database(witness_retry=hint) against the reference under
    FDB_TPU_WITNESS_RETRY=1 / 0."""
    monkeypatch.setenv("FDB_TPU_WITNESS_RETRY", "1" if hint else "0")
    ref = record("ref", "cpu", s_contended_ring, 37, n_proxies=2)
    real_database = mods("port").cluster.SimCluster.database
    monkeypatch.setattr(mods("port").cluster.SimCluster, "database",
                        lambda self, name="", **kw: real_database(self, name, witness_retry=hint,
                                                                  **kw))
    port = record("port", "cpu", s_contended_ring, 37, n_proxies=2)
    assert port["events"] == ref["events"]
    for key in ref:
        assert port[key] == ref[key], key
    assert SMOKE.ring_ok(port["out"])
    hints = sum(cl[1] for cl in port["clients"])
    retries = sum(1 for e in port["events"] if e[0] == "on_error")
    assert retries > 0 and hints == (retries if hint else 0)


def s_fence(c, m):
    """A commit in flight to proxy 0 when proxy 0 dies: the client fences
    it with a dummy transaction through proxy 1 and surfaces
    commit_unknown_result; a read then finds the original never landed.
    (A static SimCluster keeps the dead proxy in every client's
    round-robin, so a retried write would keep meeting it.)"""
    db = c.database("fence")
    out = {}

    async def flow():
        async def setup(tr):
            await tr.get(b"f")
            tr.set(b"f", b"0")

        await db.run(setup)
        tr = db.create_transaction()
        await tr.get(b"f")
        tr.set(b"f", b"1")
        fut = db.process.spawn(caught(m, tr.commit()), "commit")
        c.proxies[0].process.kill()
        out["commit"] = await fut

        async def final(tr):
            out["f"] = await tr.get(b"f")

        await db.run(final)
        return True

    assert c.run_until(db.process.spawn(flow()), timeout_vt=5000.0)
    return out


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_commit_unknown_result_is_fenced(arm):
    out = pair(arm, s_fence, 61, n_proxies=2)
    assert out["commit"][:2] == ("error", "commit_unknown_result") and out["f"] == b"0"


def test_dynamic_database_waits_for_the_control_plane():
    m = mods("port")
    c = cluster(m, "cpu", 1)
    try:
        with pytest.raises(NotImplementedError, match="cluster controller"):
            m.tx.Database(c.net.process("x"), info_var=object())
    finally:
        m.el.set_event_loop(None)


def test_transactional_joins_or_retries():
    """@transactional: a Database argument gets a fresh transaction and the
    retry loop, a Transaction argument joins the caller's, on both."""
    def script(c, m):
        db = c.database()

        @m.tx.transactional
        async def bump(tr, by):
            v = int(await tr.get(b"n") or b"0")
            tr.set(b"n", b"%d" % (v + by))
            return v

        out = []

        async def both(tr):
            out.append(await bump(tr, 2))
            out.append(await bump(tr, 3))

        out.append(c.run_until(db.process.spawn(bump(db, 1))))
        c.run_all([(db, db.run(both))])
        out.append(c.run_until(db.process.spawn(bump(db, 0))))
        return out

    assert pair("cpu", script, 5) == [0, 1, 3, 6]


def s_api_surface(c, m):
    """The rest of the Transaction API and management.py: key selectors,
    a watch fired by a later commit, clear, the size and legality errors,
    used_during_commit, and every management transaction."""
    db = c.database("api")
    KS = m.types.KeySelector
    out = {}

    async def fill(tr):
        for i in range(6):
            tr.set(b"s%d" % i, b"%d" % i)

    c.run_all([(db, db.run(fill))])

    async def reads(tr):
        for name, sel in (("fge", KS.first_greater_or_equal(b"s2")),
                          ("fgt", KS.first_greater_than(b"s2")),
                          ("lle", KS.last_less_or_equal(b"s2")),
                          ("llt", KS.last_less_than(b"s0")),
                          ("past", KS.first_greater_than(b"s9"))):
            out[name] = await tr.get_key(sel)
        tr.clear(b"s3")
        out["cleared"] = await tr.get_range(b"s", b"t")

    c.run_all([(db, db.run(reads))])

    async def errors():
        tr = db.create_transaction()
        for name, fn in (("key_too_large", lambda: tr.set(b"k" * 10001, b"v")),
                         ("value_too_large", lambda: tr.set(b"k", b"v" * 100001)),
                         ("system_key", lambda: tr.set(b"\xff/x", b"v")),
                         ("inverted", lambda: tr.clear_range(b"b", b"a"))):
            try:
                fn()
                out[name] = "accepted"
            except m.error.FdbError as e:
                out[name] = e.name
        tr.set(b"u", b"1")
        fut = db.process.spawn(tr.commit(), "commit")
        await c.loop.delay(0)  # the commit has begun
        try:
            tr.set(b"u2", b"1")
            out["during_commit"] = "accepted"
        except m.error.FdbError as e:
            out["during_commit"] = e.name
        out["committed"] = await fut

        watcher = db.create_transaction()
        fired = await watcher.watch(b"s1")
        await watcher.commit()

        async def bump(tr):
            tr.set(b"s1", b"changed")

        await db.run(bump)
        out["watch"] = await fired

    c.run_until(db.process.spawn(errors()), timeout_vt=100.0)

    async def manage():
        await m.mgmt.configure(db, proxies=3, logs=2)
        out["conf"] = await m.mgmt.get_configuration(db)
        await m.mgmt.change_coordinators(db, ["a:1", "b:1", "c:1"])
        out["coordinators"] = await m.mgmt.get_requested_coordinators(db)
        await m.mgmt.set_process_class(db, "10.0.0.1:1", "storage")
        out["classes"] = await m.mgmt.get_process_classes(db)
        await m.mgmt.exclude_servers(db, ["ss9", "ss8"])
        out["excluded"] = await m.mgmt.get_excluded_servers(db)
        await m.mgmt.include_servers(db, ["ss9"])
        out["included"] = await m.mgmt.get_excluded_servers(db)
        out["timestamp"] = await caught(m, m.mgmt.version_from_timestamp(db, 5.0))

    c.run_until(db.process.spawn(manage()), timeout_vt=100.0)
    return out


def test_api_surface_and_management_match_the_reference():
    out = pair("cpu", s_api_surface, 19, n_proxies=2)
    assert (out["fge"], out["fgt"], out["lle"], out["llt"], out["past"]) == (
        b"s2", b"s3", b"s2", b"", b"\xff")
    assert [k for k, _v in out["cleared"]] == [b"s0", b"s1", b"s2", b"s4", b"s5"]
    assert (out["key_too_large"], out["value_too_large"], out["system_key"],
            out["inverted"], out["during_commit"]) == (
        "key_too_large", "value_too_large", "key_outside_legal_range", "inverted_range",
        "used_during_commit")
    assert out["watch"] > out["committed"] > 0
    assert out["conf"] == {"proxies": 3, "logs": 2}
    assert out["coordinators"] == ["a:1", "b:1", "c:1"]
    assert out["classes"] == {"10.0.0.1:1": "storage"}
    assert out["excluded"] == ["ss8", "ss9"] and out["included"] == ["ss8"]
    assert out["timestamp"][:2] == ("error", "restore_error")


def s_hedged_read(c, m):
    """test_hedged_read_beats_clogged_replica without data distribution:
    the client's own system-key transactions replicate every key on ss0
    and ss1 (serverList rows, then a keyServers move whose destination
    fetches the data); with the model's first replica clogged from the
    client for 30 s, a read is answered by the hedge to the runner-up."""
    sk = importlib.import_module(f"{BASES[m.pkg]}.server.system_keys")
    end = importlib.import_module(f"{BASES[m.pkg]}.server.storage").KEYSPACE_END
    db = c.database()
    ss = [s.interface() for s in c.storages]

    def system(*rows):
        async def txn(tr):
            tr.options["access_system_keys"] = True
            for k, v in rows:
                tr.set(k, v)
        return txn

    async def flow():
        await db.run(system(*[(b"h%02d" % i, b"v%d" % i) for i in range(10)]))
        await db.run(system(*[(sk.server_list_key(f"ss{i}"), sk.encode_server_entry(s))
                              for i, s in enumerate(ss)]))
        await db.run(system((sk.key_servers_key(b""), sk.encode_key_servers(["ss0"], [], end))))
        await db.run(system((sk.key_servers_key(b""),
                             sk.encode_key_servers(["ss0"], ["ss0", "ss1"], end))))
        for _ in range(200):
            st = await ss[1].get_shard_state.get_reply(
                db.process, m.itf.GetShardStateRequest(begin=b"", end=end))
            if st in ("fetched", "readable"):
                break
            await c.loop.delay(0.05)
        await db.run(system((sk.key_servers_key(b""),
                             sk.encode_key_servers(["ss0", "ss1"], [], end))))
        first = db.queue_model.order(["ss0", "ss1"])[0]
        proc = {s.storage_id: s.process for s in c.storages}[first]
        c.net.clog_pair(db.process.machine.machine_id, proc.machine.machine_id, 30.0)
        t0 = c.loop.now()
        tr = db.create_transaction()
        val = await tr.get(b"h03")
        return first, val, c.loop.now() - t0

    return c.run_until(db.process.spawn(flow()), timeout_vt=1000.0)


def test_hedged_read_beats_clogged_replica():
    first, val, dt = pair("cpu", s_hedged_read, 140, n_storages=2)
    assert val == b"v3" and dt < 5.0


def s_invalidation_during_paged_locations(c, m):
    """The client's own system-key transactions cut the key space into
    seven shards on ss0 and ss1 by turns; a location fetch over all of them
    takes four requests
    (two pieces a reply here), and while its second request is in flight
    another actor invalidates the first piece, which the fetch has already
    filled.  The fetch goes back for that piece, as the reference's does,
    and returns every piece with its team."""
    sk = importlib.import_module(f"{BASES[m.pkg]}.server.system_keys")
    end = importlib.import_module(f"{BASES[m.pkg]}.server.storage").KEYSPACE_END
    db = c.database()
    bounds = [b"", b"b", b"c", b"d", b"e", b"f", b"g", end]

    async def shards(tr):
        tr.options["access_system_keys"] = True
        for i, s in enumerate(c.storages):
            tr.set(sk.server_list_key(f"ss{i}"), sk.encode_server_entry(s.interface()))
        for i, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
            tr.set(sk.key_servers_key(lo), sk.encode_key_servers([f"ss{i % 2}"], [], hi))

    def first_piece():
        return next(iter(db._loc_cache.intersecting(b"", b"a")))[2]

    async def flow():
        await db.run(shards)
        db.invalidate_location(b"", end)
        fetch = db.process.spawn(db.get_locations(b"", b"h"))
        while first_piece() is None:
            await c.loop.delay(0.0001)
        db.invalidate_location(b"", b"b")
        locs = await fetch
        return [(b, e, None if v is None else len(v)) for b, e, v in locs]

    return c.run_until(db.process.spawn(flow()), timeout_vt=1000.0)


def test_invalidation_during_a_paged_location_fetch(monkeypatch):
    for base in BASES.values():
        req = importlib.import_module(f"{base}.server.interfaces").GetKeyServersLocationsRequest
        monkeypatch.setattr(req.__init__, "__defaults__", (b"", b"\xff", 2))
    locs = pair("cpu", s_invalidation_during_paged_locations, 150, n_storages=2)
    assert [b for b, _e, _t in locs] == [b"", b"b", b"c", b"d", b"e", b"f", b"g"]
    assert all(team == 1 for _b, _e, team in locs)
