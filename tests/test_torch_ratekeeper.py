"""The port's Ratekeeper, held to the reference's on the CPU.

Twins of every test of tests/test_ratekeeper.py (17), each at the
reference test's seed and shape: the reference's ``SimCluster`` and
``Ratekeeper`` (its knobs set in its arm and restored) and the port's
(the same values passed to the port's constructor) run one script.  The
port reads no knob: ``ratekeeper_grv_queue_max`` is the port proxy's
``RATEKEEPER_GRV_QUEUE_MAX``, patched in the port's arm.  Held equal:
every ``RateInfo`` the ratekeeper sets, with its virtual time; the
transitions log byte for byte (``transition_log_json``); every read
version a client asked for, with its virtual time and outcome; every
read, commit and retry (chip_smoke's ClientLog); the proxies' and the
ratekeeper's registries; the script's own results; and the loop's end
time with its rng's next draw.  The host-engine arm ("cpu") runs every
case; the resolver-signal case also runs over a port
``ConflictSet(device="cpu")`` ("set").  ``test_resolver_signals_feed_
ratekeeper``'s status ``qos`` block is not held here: ``server/status.py``
belongs to the control plane, which is not ported yet.

Then the device-coupled spring: a cluster whose resolver serves over a
port ``ConflictSet(device="cpu")`` with three scripted dispatch faults,
held to the reference's over its ``ConflictSet(backend="jax")`` under the
same fault script (the kernels as the reference's CPU tests run them):
the rate falls to the degraded cap while the breaker is open and returns
once it closes.  Its sharded twin: four shards, one of them faulted, the
rate contracting to ((4 - 1) + 1 x 0.25) / 4 = 0.8125 of max_tps.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import pathlib
from dataclasses import asdict

import pytest

from foundationdb_tpu.flow.knobs import g_knobs

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_client_twins", _here / "test_torch_client.py")
TWINS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TWINS)
SMOKE = TWINS.SMOKE
_restore_globals = TWINS._restore_globals


def rk_mod(pkg):
    return importlib.import_module(f"{TWINS.BASES[pkg]}.server.ratekeeper")


def ref_knob(name):
    """The reference's knob for a port constructor argument."""
    return name if name == "sim_disk_capacity_bytes" else "ratekeeper_" + name


@contextlib.contextmanager
def knobs(pkg, settings, monkeypatch=None):
    """In the reference's arm, its knobs set to `settings` (port names)
    while open; the port's arm takes them as constructor arguments.
    ``grv_queue_max`` is the port proxy's module constant."""
    if pkg == "ref":
        saved = {k: getattr(g_knobs.server, ref_knob(k)) for k in settings}
        for k, v in settings.items():
            setattr(g_knobs.server, ref_knob(k), v)
        try:
            yield
        finally:
            for k, v in saved.items():
                setattr(g_knobs.server, ref_knob(k), v)
    else:
        if "grv_queue_max" in settings:
            proxy = importlib.import_module("foundationdb_tpu_torch.server.proxy")
            monkeypatch.setattr(proxy, "RATEKEEPER_GRV_QUEUE_MAX", settings["grv_queue_max"])
        yield


class Knobs:
    """One arm's view of a setting: the reference's knob, or the port
    ratekeeper's attribute."""

    def __init__(self, pkg, rk):
        self.pkg, self.rk = pkg, rk

    def get(self, name):
        if self.pkg == "ref":
            return getattr(g_knobs.server, ref_knob(name))
        return getattr(self.rk, name)

    def set(self, name, value):
        if self.pkg == "ref":
            setattr(g_knobs.server, ref_knob(name), value)
        else:
            setattr(self.rk, name, value)


class GrvLog:
    """Every get_read_version of one package's Transaction: (virtual time,
    client process, "ok" and the version, or "error" and its name)."""

    def __init__(self, txmod):
        self.T = txmod.Transaction
        self.inner = self.T.__dict__["get_read_version"]
        self.events = []
        inner, events = self.inner, self.events

        async def get_read_version(tr, *a, **kw):
            proc = tr.db.process
            try:
                v = await inner(tr, *a, **kw)
            except Exception as e:  # noqa: BLE001 - the client's FdbError, re-raised
                events.append((proc.network.loop.now(), proc.name, "error", getattr(e, "name", "")))
                raise
            events.append((proc.network.loop.now(), proc.name, "ok", v))
            return v

        self.T.get_read_version = get_read_version

    def remove(self):
        self.T.get_read_version = self.inner


def rated(pkg, seed, script, settings=(), arm="cpu", monkeypatch=None):
    """`script(c, rk, m, knobs)` on `pkg`'s SimCluster with a Ratekeeper over
    its tlog and storage attached to its proxy (make_rated_cluster), with
    `settings` (port names) as the reference's knobs or the port's
    arguments; returns the record and the cluster."""
    settings = dict(settings)
    m = TWINS.mods(pkg)
    TWINS._install_hubs(pkg)
    Rk = SMOKE.recorded_ratekeeper(rk_mod(pkg))
    with knobs(pkg, settings, monkeypatch):
        c = TWINS.cluster(m, arm, seed)
        kw = {k: v for k, v in settings.items() if k != "grv_queue_max"} if pkg == "port" else {}
        rk = Rk(c.master_proc, [c.tlog], [c.storage], **kw)
        c.proxy.ratekeeper = rk.interface()
        log, grv = SMOKE.ClientLog(m.tx), GrvLog(m.tx)
        try:
            out = script(c, rk, m, Knobs(pkg, rk))
        finally:
            log.remove()
            grv.remove()
            m.el.set_event_loop(None)
    return dict(
        out=SMOKE.norm(out),
        series=rk.series,
        transitions=rk.transition_log_json(),
        rate=asdict(rk.rate),
        grvs=grv.events,
        events=log.events,
        proxies=[p.metrics.snapshot_json() for p in c.proxies],
        ratekeeper=rk.metrics.snapshot_json(),
        end=(c.loop.now(), c.loop.rng.random_int(0, 1 << 30)),
    ), c


def pair(seed, script, settings=(), arm="cpu", monkeypatch=None):
    """Both packages' records, asserted equal; returns the port's."""
    ref = rated("ref", seed, script, settings, arm, monkeypatch)[0]
    port = rated("port", seed, script, settings, arm, monkeypatch)[0]
    for key in ref:
        assert port[key] == ref[key], key
    return port


def stop(proc, name):
    """Cancel `proc`'s tasks whose name holds `name`."""
    for t in list(proc._tasks):
        if name in t.name:
            t.cancel()


# ---------------------------------------------------------------------------
# tests/test_ratekeeper.py's cases
# ---------------------------------------------------------------------------


def s_grv_rate_limited(c, rk, m, k):
    db = c.database()
    times = []

    async def go():
        for _ in range(30):
            tr = db.create_transaction()
            await tr.get_read_version()
            times.append(c.loop.now())

    c.run_all([(db, go())], timeout_vt=100.0)
    return times


def test_grv_rate_limited():
    times = pair(61, s_grv_rate_limited, dict(max_tps=100.0))["out"]
    # 30 GRVs at 100 tps with burst 10 take >= ~0.2 s of virtual time.
    assert times[-1] - times[0] >= 0.15


def s_storage_lags(c, rk, m, k):
    stop(c.storage_proc, "ss_update")
    db = c.database()

    async def writes():
        for i in range(5):
            tr = db.create_transaction()
            tr.set(b"k%d" % i, b"v")
            await tr.commit()
            await c.loop.delay(0.3)

    c.run_all([(db, writes())], timeout_vt=100.0)
    return asdict(rk.rate)


def test_rate_drops_when_storage_lags():
    rate = pair(62, s_storage_lags, dict(max_tps=100000.0))["rate"]
    assert rate["lag_versions"] > 0 and rate["tps"] < 100000.0


def s_queue_bytes(c, rk, m, k):
    db = c.database()

    async def writes():
        for i in range(6):
            tr = db.create_transaction()
            tr.set(b"big%02d" % i, b"x" * 400)
            await tr.commit()
        await c.loop.delay(0.1)
        stop(c.storage_proc, "ss_update")
        c.storage.input_bytes = c.storage.durable_bytes + 10_000
        await c.loop.delay(0.4)

    c.run_all([(db, writes())], timeout_vt=100.0)
    return asdict(rk.rate)


def test_queue_bytes_signal_throttles():
    rate = pair(63, s_queue_bytes, dict(max_tps=100000.0, target_ss_queue_bytes=2_000,
                                        spring_ss_queue_bytes=2_000))["rate"]
    assert rate["worst_ss_queue_bytes"] > 2_000 and rate["tps"] < 100000.0
    assert rate["limiting"] == "ss_queue" and rate["batch_tps"] <= rate["tps"]


def s_batch_lane(c, rk, m, k):
    Signals = rk_mod(m.pkg).Signals
    k.set("target_lag_versions", 1000)
    k.set("spring_lag_versions", 1000)
    return [rk._limit(Signals(lag=1400), 1.0), rk._limit(Signals(lag=1400), 0.5)]


def test_batch_priority_lane_throttles_first():
    (tps, limiting), (btps, _) = pair(64, s_batch_lane, dict(
        max_tps=1000.0, target_lag_versions=500_000, spring_lag_versions=2_000_000))["out"]
    assert tps > 0.5 * 1000.0 and btps < tps and limiting == "ss_lag"


def s_batch_deferred(c, rk, m, k):
    stop(c.master_proc, "rk_update")
    rk.rate = rk_mod(m.pkg).RateInfo(tps=100000.0, batch_tps=30.0)
    db = c.database()
    done = {"default": [], "batch": []}

    async def client(lane):
        for _ in range(10):
            tr = db.create_transaction()
            if lane == "batch":
                tr.options["priority_batch"] = True
            await tr.get_read_version()
            done[lane].append(c.loop.now())

    c.run_all([(db, client("default")), (db, client("batch"))], timeout_vt=200.0)
    return done


def test_batch_priority_grv_deferred_under_throttle():
    done = pair(65, s_batch_deferred, dict(max_tps=100000.0))["out"]
    assert len(done["default"]) == 10 and len(done["batch"]) == 10
    assert done["batch"][-1] - done["batch"][0] >= 0.15
    assert done["default"][-1] < done["batch"][-1]


def s_springs(c, rk, m, k):
    Signals = rk_mod(m.pkg).Signals
    cases = {
        "ss_lag": lambda v: Signals(lag=int(v * k.get("target_lag_versions"))),
        "ss_queue": lambda v: Signals(ss_queue=int(v * k.get("target_ss_queue_bytes"))),
        "tlog_queue": lambda v: Signals(tlog_queue=int(v * k.get("target_tlog_queue_bytes"))),
        "resolver_queue": lambda v: Signals(
            resolver_queue=int(v * k.get("target_resolver_queue"))),
        "resolve_latency": lambda v: Signals(resolve_p99=v * k.get("target_resolve_p99")),
        "commit_latency": lambda v: Signals(commit_p99=v * k.get("target_commit_p99")),
    }
    out = {}
    for name, mk in cases.items():
        out[name] = [rk._limit(mk(sev), 1.0)
                     for sev in (0.0, 0.5, 1.0, 1.5, 2.0, 4.0, 8.0, 100.0)]
    out["ok"] = rk._limit(Signals(), 1.0)
    out["degraded"] = rk._limit(Signals(backend_state="degraded"), 1.0)
    out["probing"] = rk._limit(Signals(backend_state="probing"), 1.0)
    out["free"] = [rk._limit(Signals(free=f), 1.0) for f in (
        1 << 62, k.get("target_free_bytes"), k.get("target_free_bytes") // 2,
        k.get("min_free_bytes"), 0)]
    out["recovering"] = rk._limit(Signals(unreachable=True), 1.0)
    out["knobs"] = [k.get(n) for n in ("max_tps", "degraded_tps_fraction", "min_tps")]
    return out


def test_spring_monotonicity_every_signal():
    out = pair(71, s_springs, dict(max_tps=10000.0))["out"]
    max_tps, frac, min_tps = out["knobs"]
    for name in ("ss_lag", "ss_queue", "tlog_queue", "resolver_queue", "resolve_latency",
                 "commit_latency"):
        tps = [t for t, _l in out[name]]
        assert all(b <= a for a, b in zip(tps, tps[1:])), name
        assert out[name][4][1] == name and out[name][4][0] < max_tps  # severity 2.0
    assert out["degraded"][0] <= out["ok"][0] and out["degraded"][1] == "backend_degraded"
    assert out["degraded"][0] <= max_tps * frac
    assert out["probing"] == out["degraded"]
    free = [t for t, _l in out["free"]]
    assert all(b <= a for a, b in zip(free, free[1:]))
    assert list(out["recovering"]) == [min_tps, "recovering"]


def s_measured_cpu_tps(c, rk, m, k):
    Signals = rk_mod(m.pkg).Signals
    k.set("use_measured_cpu_tps", True)
    out = [rk._limit(Signals(backend_state="degraded", cpu_mirror_tps=500.0), 1.0),
           rk._limit(Signals(backend_state="degraded", cpu_mirror_tps=1e9), 1.0)]
    k.set("use_measured_cpu_tps", False)
    out.append(rk._limit(Signals(backend_state="degraded", cpu_mirror_tps=500.0), 1.0))
    return out


def test_degraded_cap_tracks_measured_cpu_mirror_tps():
    out = pair(72, s_measured_cpu_tps, dict(max_tps=10000.0, use_measured_cpu_tps=False))["out"]
    assert out[0][1] == "backend_degraded" and out[0][0] == pytest.approx(0.8 * 500.0)
    assert out[1][0] == pytest.approx(10000.0 * 0.25)
    assert out[2][0] == pytest.approx(10000.0 * 0.25)  # the simulation's default


def s_proportional(c, rk, m, k):
    Signals = rk_mod(m.pkg).Signals
    return dict(
        whole=rk._limit(Signals(backend_state="degraded"), 1.0),
        by_deg=[rk._limit(Signals(backend_state="degraded", shards_total=8,
                                  shards_degraded=d), 1.0) for d in (1, 2, 4, 7, 8)])


def test_degraded_cap_contracts_proportionally_for_sharded_resolvers():
    out = pair(73, s_proportional, dict(max_tps=10000.0))["out"]
    whole, limiting = out["whole"]
    assert limiting == "backend_degraded" and whole == pytest.approx(10000.0 * 0.25)
    last = None
    for deg, (tps, limiting) in zip((1, 2, 4, 7, 8), out["by_deg"]):
        assert limiting == "backend_degraded"
        assert tps == pytest.approx(10000.0 * ((8 - deg) + deg * 0.25) / 8), deg
        assert last is None or tps < last
        last = tps
    assert out["by_deg"][0][0] > 0.8 * 10000.0 > whole
    assert out["by_deg"][-1][0] == pytest.approx(whole)


def test_binding_shard_fraction_ignores_healthy_sharded_resolvers():
    outs = {}
    for pkg in ("ref", "port"):
        reply = importlib.import_module(
            f"{TWINS.BASES[pkg]}.server.interfaces").ResolverSignalsReply
        f = rk_mod(pkg).Ratekeeper._binding_shard_fraction

        def r(state, tot=0, deg=0, reply=reply):
            return reply(backend_state=state, shards_total=tot, shards_degraded=deg)

        outs[pkg] = [f([r("ok", tot=8), r("degraded")]),
                     f([r("degraded", tot=8, deg=1), r("ok")]),
                     f([r("degraded", tot=8, deg=1), r("degraded")]),
                     f([r("degraded", tot=8, deg=1), r("probing", tot=4, deg=2)]),
                     f([r("ok", tot=8), r("ok")])]
    assert outs["port"] == outs["ref"] == [(0, 0), (1, 8), (0, 0), (2, 4), (0, 0)]


def s_resolver_signals(c, rk, m, k):
    rk.resolvers = list(c.resolvers)
    db = c.database()

    async def writes():
        for i in range(20):
            tr = db.create_transaction()
            tr.set(b"rs%02d" % i, b"v")
            await tr.commit()
        await c.loop.delay(0.6)

    c.run_all([(db, writes())], timeout_vt=100.0)
    snap = c.resolver.signal_snapshot()
    out = {}

    async def probe():
        out["sig"] = await c.resolver.interface().signals.get_reply(db.process, None)

    c.run_until(db.process.spawn(probe(), "probe"), timeout_vt=50.0)
    drop = ("cpu_mirror_tps",)  # wall-derived
    return dict(
        snap={k_: v for k_, v in asdict(snap).items() if k_ not in drop},
        sig={k_: v for k_, v in asdict(out["sig"]).items() if k_ not in drop},
        resolved=c.resolver.metrics.histogram("resolve_seconds").count,
        p99=c.resolver.resolve_p99_recent())


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_resolver_signals_feed_ratekeeper(arm):
    """The status qos block of the reference test waits for the control
    plane (server/status.py); the rest is held here."""
    port = pair(73, s_resolver_signals, dict(max_tps=100000.0), arm=arm)
    out = port["out"]
    assert out["snap"]["backend_state"] == "ok" and out["snap"]["queue_depth"] == 0
    assert out["resolved"] >= 1 and out["p99"] >= 0.0
    assert port["rate"]["backend_state"] == "ok"
    assert out["sig"]["backend_state"] == "ok"
    assert out["sig"]["resolve_p99"] == out["snap"]["resolve_p99"]


def s_grv_shed(c, rk, m, k):
    itf = m.itf
    stop(c.master_proc, "rk_update")
    rk.rate = rk_mod(m.pkg).RateInfo(tps=2.0, batch_tps=1.0)
    iface = c.proxy.interface()
    proc = c.net.process("grv_burst")
    results = {"ok": 0, "batch_throttled": 0, "default_shed": 0}

    async def one(flags):
        try:
            await iface.get_consistent_read_version.get_reply(
                proc, itf.GetReadVersionRequest(flags=flags))
            results["ok"] += 1
        except m.error.FdbError as e:
            if e.name == "batch_transaction_throttled":
                results["batch_throttled"] += 1
            elif e.name == "proxy_memory_limit_exceeded":
                results["default_shed"] += 1
            else:
                raise

    async def burst():
        tasks = []
        for i in range(15):
            tasks.append(proc.spawn(one(0), f"d{i}"))
            tasks.append(proc.spawn(one(itf.GRV_FLAG_PRIORITY_BATCH), f"b{i}"))
        await m.el.all_of(tasks)

    c.run_until(proc.spawn(burst(), "burst"), timeout_vt=400.0)
    counters = json.loads(c.proxy.metrics.snapshot_json())["counters"]
    return dict(results=results, shed=(counters["grv_shed_batch"], counters["grv_shed_default"]),
                retryable=[m.error.FdbError(n).is_retryable_in_transaction()
                           for n in ("batch_transaction_throttled",
                                     "proxy_memory_limit_exceeded")])


def test_grv_queue_shed_batch_lane_starves_first(monkeypatch):
    out = pair(74, s_grv_shed, dict(max_tps=100000.0, grv_queue_max=8),
               monkeypatch=monkeypatch)["out"]
    res = out["results"]
    assert res["batch_throttled"] > 0 and res["batch_throttled"] >= res["default_shed"]
    assert sum(res.values()) == 30
    assert list(out["shed"]) == [res["batch_throttled"], res["default_shed"]]
    assert list(out["retryable"]) == [True, True]


def s_saturation(c, rk, m, k):
    db = c.database()
    stats = {"committed": 0, "too_old": 0}

    async def writer(wid):
        for i in range(25):
            tr = db.create_transaction()
            try:
                await tr.get(b"sat%02d" % wid)
                tr.set(b"sat%02d" % wid, b"%d" % i)
                await tr.commit()
                stats["committed"] += 1
            except m.error.FdbError as e:
                if e.name == "transaction_too_old":
                    stats["too_old"] += 1
                else:
                    await tr.on_error(e)

    c.run_all([(db, writer(w)) for w in range(4)], timeout_vt=300.0)
    return stats


def test_saturation_stays_inside_mvcc_window():
    stats = pair(66, s_saturation, dict(max_tps=100000.0))["out"]
    assert stats["committed"] >= 90 and stats["too_old"] <= 5


# ---------------------------------------------------------------------------
# CommitChainSampler, against each package's own trace collector
# ---------------------------------------------------------------------------


def _commit_ev(loc, did, t):
    return {"Type": "CommitDebug", "Location": loc, "ID": did, "Time": t}


def chain_pair(scenario):
    """`scenario(col, sampler_class, trace_module)` with a fresh in-memory
    collector of each package installed as its global; both packages'
    results, asserted equal; returns the port's."""
    outs = {}
    for pkg in ("ref", "port"):
        trace = importlib.import_module(f"{TWINS.BASES[pkg]}.flow.trace")
        old = trace.global_collector()
        col = trace.TraceCollector()
        trace.set_global_collector(col)
        try:
            outs[pkg] = scenario(col, rk_mod(pkg).CommitChainSampler, trace)
        finally:
            trace.set_global_collector(old)
    assert outs["port"] == outs["ref"]
    return outs["port"]


def test_chain_sampler_incremental_window_and_err_close():
    def scenario(col, S, trace):
        s = S()
        col.events += [_commit_ev(s.FROM, "a", 10.0), _commit_ev(s.TO, "a", 11.0),
                       _commit_ev(s.FROM, "b", 10.0), _commit_ev(s.TO, "b", 13.0)]
        out = [s.sample()]
        col.events += [_commit_ev(s.FROM, "c", 20.0), _commit_ev(s.TO, "c", 25.0)]
        out += [s.sample(), s._cursor == len(col.events)]
        col.events += [_commit_ev(s.FROM, "fail", 30.0), _commit_ev(s.ERR, "fail", 30.5)]
        out += [s.sample(now=100.0, horizon=1000.0), "fail" in s._open]
        return out

    assert chain_pair(scenario) == [3.0, 5.0, True, 5.0, False]


def test_chain_sampler_open_chain_ages_signal():
    def scenario(col, S, trace):
        s = S()
        col.events += [_commit_ev(s.FROM, "x", 10.0), _commit_ev(s.TO, "x", 10.5),
                       _commit_ev(s.FROM, "wedged", 11.0)]
        out = [s.sample(now=20.0, horizon=100.0), s.sample(now=31.0, horizon=100.0), s.sample()]
        col.events.append(_commit_ev(s.TO, "wedged", 41.0))
        return out + [s.sample(now=42.0, horizon=100.0)]

    assert chain_pair(scenario) == [9.0, 20.0, 0.5, 30.0]


def test_chain_sampler_horizon_prunes_abandoned_opens():
    def scenario(col, S, trace):
        s = S()
        col.events += [_commit_ev(s.FROM, "x", 10.0), _commit_ev(s.TO, "x", 10.5),
                       _commit_ev(s.FROM, "abandoned", 10.0)]
        out = [s.sample(now=12.0, horizon=5.0), s.sample(now=16.0, horizon=5.0),
               "abandoned" in s._open]
        col.events.append(_commit_ev(s.TO, "abandoned", 40.0))
        return out + [s.sample(now=41.0, horizon=5.0)]

    assert chain_pair(scenario) == [2.0, 0.5, False, 0.5]


def test_chain_sampler_open_map_bounded_and_collector_reset():
    def scenario(col, S, trace):
        s = S()
        col.events += [_commit_ev(s.FROM, "d%04d" % i, float(i)) for i in range(1100)]
        s.sample()
        out = [len(s._open), "d0000" in s._open, "d1099" in s._open]
        col2 = trace.TraceCollector()
        trace.set_global_collector(col2)
        col2.events += [_commit_ev(s.FROM, "n", 1.0), _commit_ev(s.TO, "n", 3.0)]
        return out + [s.sample(), len(s._open)]

    assert chain_pair(scenario) == [512, False, True, 2.0, 0]


def test_chain_sampler_returns_none_for_file_backed_collector(tmp_path):
    outs = []
    for pkg in ("ref", "port"):
        trace = importlib.import_module(f"{TWINS.BASES[pkg]}.flow.trace")
        old = trace.global_collector()
        trace.set_global_collector(trace.TraceCollector(path=str(tmp_path / f"{pkg}.jsonl")))
        try:
            outs.append(rk_mod(pkg).CommitChainSampler().sample(now=1.0, horizon=1.0))
        finally:
            trace.global_collector().close()
            trace.set_global_collector(old)
    assert outs == [None, None]


def test_port_ratekeeper_reads_no_knob_and_keeps_the_defaults():
    """Every knob the reference's Ratekeeper reads is a constructor
    argument of the port's, with the reference's default."""
    import inspect

    params = inspect.signature(rk_mod("port").Ratekeeper).parameters
    names = [n for n in params if n not in (
        "self", "process", "tlogs", "storages", "sample_interval", "fs", "tlog_ifaces",
        "storage_ifaces", "resolvers", "resolver_ifaces", "proxies")]
    assert len(names) == 20
    for n in names:
        assert params[n].default == getattr(g_knobs.server, ref_knob(n)), n
    src = pathlib.Path(rk_mod("port").__file__).read_text()
    assert "g_knobs" not in src and "latency_chain" not in src


# ---------------------------------------------------------------------------
# The device-coupled spring: the breaker drives the rate
# ---------------------------------------------------------------------------

SPRING_MAX_TPS = 4000.0
SPRING_SPLITS = [b"\x40", b"\x80", b"\xc0"]


def spring_sets(sharded):
    """(reference set, port set) factories with their injectors: three
    dispatch faults from the 3rd device batch (of shard 1 when sharded)."""
    from foundationdb_tpu.conflict.device_faults import DeviceFaultInjector as RefInjector
    from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector

    shape = dict(SMOKE.CLIENT_SET_KW)  # 16 bytes: the client's self-conflict keys fit

    def ref():
        inj = RefInjector()
        inj.script("dispatch", at=3, persist=3, shard=1 if sharded else None)
        if sharded:
            import jax

            from foundationdb_tpu.parallel.sharded_resolver import ShardedJaxConflictSet

            cs = ShardedJaxConflictSet(SPRING_SPLITS, devices=jax.devices()[:4], **shape)
            cs.install_fault_injector(inj)
            return cs
        from foundationdb_tpu.conflict.api import ConflictSet as RefConflictSet

        return RefConflictSet(backend="jax", fault_injector=inj, **shape)

    def port():
        inj = DeviceFaultInjector()
        inj.script("dispatch", at=3, persist=3, shard=1 if sharded else None)
        if sharded:
            from foundationdb_tpu_torch.parallel.sharded_resolver import ShardedTorchConflictSet

            cs = ShardedTorchConflictSet(SPRING_SPLITS, device="cpu", **shape)
            cs.install_fault_injector(inj)
            return cs
        from foundationdb_tpu_torch.conflict.api import ConflictSet

        return ConflictSet(device="cpu", pipeline_depth=2, fault_injector=inj, **shape)

    return {"ref": ref, "port": port}


def spring_run(pkg, make_set):
    """A one-proxy cluster over `make_set()` with a Ratekeeper sampling the
    resolver every 0.05 s: one client commits a write a key every 0.1 s,
    40 of them across the key space; returns the record (the rate series,
    transitions, states the resolver reported, the client's log)."""
    m = TWINS.mods(pkg)
    TWINS._install_hubs(pkg)
    Rk = SMOKE.recorded_ratekeeper(rk_mod(pkg))
    settings = dict(max_tps=SPRING_MAX_TPS)
    with knobs(pkg, settings):
        kw = {"device": "cpu"} if pkg == "port" else {}
        c = m.cluster.SimCluster(seed=75, conflict_set=make_set(), buggify=False, **kw)
        rk = Rk(c.master_proc, c.tlogs, c.storages, sample_interval=0.05,
                resolvers=c.resolvers, proxies=c.proxies,
                **(settings if pkg == "port" else {}))
        for p in c.proxies:
            p.ratekeeper = rk.interface()
        db = c.database()
        log = SMOKE.ClientLog(m.tx)
        states = []

        async def writes():
            for i in range(40):
                tr = db.create_transaction()
                tr.set(bytes([(i * 53) % 256]) + b"/%02d" % i, b"v")
                await tr.commit()
                states.append(c.resolver.signal_snapshot().backend_state)
                await c.loop.delay(0.1)

        try:
            c.run_all([(db, writes())], timeout_vt=100.0)
        finally:
            log.remove()
            m.el.set_event_loop(None)
    return dict(series=rk.series, transitions=rk.transition_log_json(),
                states=states, events=log.events,
                end=(c.loop.now(), c.loop.rng.random_int(0, 1 << 30)))


def spring_pair(sharded, monkeypatch):
    monkeypatch.setenv("FDB_TPU_PIPELINE_DEPTH", "2")
    sets = spring_sets(sharded)
    ref = spring_run("ref", sets["ref"])
    port = spring_run("port", sets["port"])
    for key in ref:
        assert port[key] == ref[key], key
    return port


def test_breaker_drives_the_rate_to_the_degraded_cap_and_back(monkeypatch):
    port = spring_pair(False, monkeypatch)
    tps = [(r["backend_state"], r["tps"], r["limiting"]) for _t, r in port["series"]]
    degraded = [x for x in tps if x[0] != "ok"]
    assert degraded and all(t <= 0.25 * SPRING_MAX_TPS and lim == "backend_degraded"
                            for _s, t, lim in degraded)
    assert tps[0] == ("ok", SPRING_MAX_TPS, "none") and tps[-1] == tps[0]
    assert json.loads(port["transitions"])[:2] == [
        [json.loads(port["transitions"])[0][0], "none", "backend_degraded",
         0.25 * SPRING_MAX_TPS],
        [json.loads(port["transitions"])[1][0], "backend_degraded", "none", SPRING_MAX_TPS]]
    assert "degraded" in port["states"] and port["states"][-1] == "ok"


def test_one_sick_shard_contracts_the_rate_proportionally(monkeypatch):
    port = spring_pair(True, monkeypatch)
    sick = [r for _t, r in port["series"] if r["backend_state"] != "ok"]
    assert sick and all(r["shards_degraded"] == 1 and r["shards_total"] == 4 for r in sick)
    assert all(r["tps"] == pytest.approx(0.8125 * SPRING_MAX_TPS) for r in sick)
    assert port["series"][-1][1]["backend_state"] == "ok"
