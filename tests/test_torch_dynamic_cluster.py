"""The port's control plane, held to the reference's on the CPU.

The port's ``server/dynamic_cluster.py``, ``cluster_controller.py``,
``coordination.py``, ``worker.py`` and ``failure_monitor.py`` run the
reference's own scripts: each twin loads a reference test module's source
twice, once as it is and once with every import of the reference package
pointed at the port, and runs one test function of each copy with the
same fixtures.  This file twins all 13 functions (20 cases) of
tests/test_dynamic_cluster.py.

Two arms.  ``cpu``: each package's host engine (the reference's default,
``conflict_backend="cpu"`` on the port's side).  ``set``: every resolver
of both clusters over a port ``ConflictSet(device="cpu")`` at the
reference rig's shape (key_words=3, h_cap=1,024, bucket_mins=(32, 128,
64)), the kernels' plain twins: the port's cluster recruits it through
``resolver_settings``, the reference's through its resolver module's
``ConflictSet`` name, patched for the run (no file of the reference
changes).  Held equal, run against run: every point read, range read,
commit and retry with its virtual time (chip_smoke's ClientLog); every
request a worker served, with its virtual time, the worker and the
generation (the recruitment decisions); every trace event less its wall
time; for each cluster, each controller's generation, leadership,
published generation and role placement, every machine's file bytes and
pending writes (the coordinators' registers among them) and the whole
status document; and each event loop's end time and its rng's next draw.
The reference runs with the port's one departure patched in for the run
(``fix_f9``, no file of the reference changed): a log fast-forwarded at
epoch end confirms its true durable end, not the jumped version, until
it passes the jump (PERF.md §7, F9).  Each run holds cyclic garbage collection to fixed points (chip_smoke's
``fixed_gc``, and a collection before the first event at or past each
multiple of GC_EVERY virtual seconds): a killed role's unanswered Reply sends
broken_promise when it is collected, drawing from the loop's rng, in both
packages, and some recoveries wait for it.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import inspect
import pathlib
import re
import types as pytypes

import pytest

from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.flow import eventloop as port_el
from foundationdb_tpu_torch.flow import flight_recorder as port_fr
from foundationdb_tpu_torch.flow import spans as port_spans
from foundationdb_tpu_torch.flow import timeseries as port_ts
from foundationdb_tpu_torch.flow import trace as port_trace

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_client_twins_dc", _here / "test_torch_client.py")
TWINS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TWINS)
SMOKE = TWINS.SMOKE
BASES = TWINS.BASES
norm = SMOKE.norm
_restore_globals = TWINS._restore_globals

# Virtual seconds between the fixed collections of a twin's run.
GC_EVERY = 4.0

# The reference rig's set shape (tests/test_torch_recovery.py's).
SET_KW = dict(key_words=3, h_cap=1 << 10, bucket_mins=(32, 128, 64))

_LOADED: dict = {}


def load_twin(name: str, pkg: str):
    """The reference test module `name` (a file under tests/) for `pkg`:
    its source as it is, or with every import of the reference package
    pointed at the port, loaded as a fresh module (memoized)."""
    key = (name, pkg)
    if key not in _LOADED:
        path = _here / f"{name}.py"
        src = path.read_text()
        if pkg == "port":
            src = re.sub(r"\bfoundationdb_tpu\b", BASES["port"], src)
            # The port has no knobs: a module importing the reference's
            # gets None, and a twin of a test that sets them passes the
            # port's arguments instead.
            src = src.replace(f"from {BASES['port']}.flow.knobs import g_knobs",
                              "g_knobs = None")
        mod = pytypes.ModuleType(f"_twin_{name}_{pkg}")
        mod.__file__ = str(path)
        exec(compile(src, str(path), "exec"), mod.__dict__)
        _LOADED[key] = mod
    return _LOADED[key]


def mods(pkg):
    base = BASES[pkg]
    imp = importlib.import_module
    return pytypes.SimpleNamespace(
        pkg=pkg, base=base,
        dc=imp(f"{base}.server.dynamic_cluster"),
        cluster=imp(f"{base}.server.cluster"),
        server=imp(f"{base}.server"),
        worker=imp(f"{base}.server.worker"),
        resolver=imp(f"{base}.server.resolver"),
        status=imp(f"{base}.server.status"),
        tx=imp(f"{base}.client.transaction"),
        el=imp(f"{base}.flow.eventloop"),
        buggify=imp(f"{base}.flow.buggify"),
    )


def port_set(depth=None, **kw):
    """A port ConflictSet(device="cpu") at the rig's shape."""
    if depth is not None:
        kw["pipeline_depth"] = depth
    return ConflictSet(device="cpu", **dict(SET_KW, **kw))


class Patches:
    """Attributes set for a run and restored after."""

    def __init__(self):
        self.saved = []

    def set(self, obj, name, value):
        self.saved.append((obj, name, obj.__dict__.get(name, _MISSING)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, old in reversed(self.saved):
            if old is _MISSING:
                delattr(obj, name)
            else:
                setattr(obj, name, old)
        self.saved = []


_MISSING = object()


class RecruitLog:
    """Every request a worker of `worker_mod` serves: (virtual time, worker
    address, the request's type, its generation, its begin version)."""

    def __init__(self, worker_mod, patches):
        self.events = []
        inner = worker_mod.WorkerServer._init_one
        log = self.events

        async def _init_one(w, req, reply):
            log.append((w.process.network.loop.now(), w.process.address, type(req).__name__,
                        getattr(req, "epoch", None), getattr(req, "epoch_begin", None)))
            return await inner(w, req, reply)

        patches.set(worker_mod.WorkerServer, "_init_one", _init_one)


def fix_f9(m, patches):
    """The port's F9 fix (PERF.md §7) on the reference's classes, for a
    run: a log fast-forwarded at epoch end answers a storage's confirm
    with its true durable end until its durable passes the jump
    (TLog.confirmed_durable), where the reference answers the jumped
    version and a storage can then apply another log's orphan above the
    cut.  Records hold the port to the reference with this fix."""
    from foundationdb_tpu_torch.server.tlog import TLog as PortTLog

    tlog = importlib.import_module(f"{m.base}.server.tlog").TLog
    inner = m.worker.WorkerServer._init_one

    async def _serve_confirm(log):
        while True:
            _req, reply = await log._confirm_stream.pop()
            reply.send(log.confirmed_durable())

    async def _init_one(w, req, reply):
        if isinstance(req, m.worker.FastForwardTLog):
            role = w.roles.get("tlog")
            if role is not None and req.version > role.durable.get():
                end = role.durable.get()
                if req.truncate_above is not None:
                    end = min(end, req.truncate_above)
                role.fast_forward_gap = (end, req.version)
        return await inner(w, req, reply)

    patches.set(tlog, "fast_forward_gap", None)
    patches.set(tlog, "confirmed_durable", PortTLog.confirmed_durable)
    patches.set(tlog, "_serve_confirm", _serve_confirm)
    patches.set(m.worker.WorkerServer, "_init_one", _init_one)


def _install_port_hubs():
    """A fresh port span hub, trace collector and flight recorder, in both
    packages' globals, so both runs' status sections come from one kind of
    hub; returns the collector."""
    hub, col, rec = port_spans.SpanHub(), port_trace.TraceCollector(), port_fr.FlightRecorder()
    for pkg in ("ref", "port"):
        base = BASES[pkg]
        importlib.import_module(f"{base}.flow.spans").set_global_span_hub(hub)
        importlib.import_module(f"{base}.flow.trace").set_global_collector(col)
        importlib.import_module(f"{base}.flow.flight_recorder").set_global_flight_recorder(rec)
    port_ts.set_global_timeseries(port_ts.TimeSeriesHub())
    return col


def status_doc(m, c) -> dict:
    """`m`'s status document of `c`.  The port's counts a process's
    unfinished actors as `live_actors`; the reference's counts the actors
    unfinished at the process's last spawn, so on its side the key is
    recounted as the port counts it."""
    doc = norm(m.status.cluster_status(c))
    for addr, p in doc["cluster"].get("processes", {}).items():
        live = sum(1 for t in c.net._procs[addr]._tasks if not t.is_ready())
        if m.pkg == "port":
            assert p["live_actors"] == live, addr
        p["live_actors"] = live
    return doc


def cluster_state(m, c) -> dict:
    """A cluster's state after a run."""
    out = dict(status=status_doc(m, c))
    if hasattr(c, "controllers"):
        out["controllers"] = [
            (cc.process.address, cc.process.alive, cc.generation, cc.is_leader.get(),
             cc.client_info.get().generation, sorted(getattr(cc, "_role_addrs", {}).items()),
             sorted(cc.workers))
            for cc in c.controllers]
        out["disks"] = SMOKE.disk_state(c.fs)
        out["workers"] = [(w.process.address, sorted(w.roles)) for w in c.workers]
    return out


@contextlib.contextmanager
def twin_run(pkg, arm, depth=None, namespaces=(), dc_kw=None, f9=True):
    """While open, `pkg`'s clusters take `arm`'s defaults (also through the
    names in each module of `namespaces`), and its DynamicClusters also
    `dc_kw`; the reference's with the port's F9 fix unless `f9` is False
    (fix_f9); yields the run's record, filled in on close."""
    m = mods(pkg)
    patches = Patches()
    made, loops = [], []
    col = _install_port_hubs()
    rec = {}

    def arm_kw(kw, dynamic):
        if pkg == "port":
            if arm == "cpu":
                kw.setdefault("conflict_backend", "cpu")
            elif dynamic:
                kw.setdefault("device", "cpu")
                settings = dict(SET_KW)
                if depth is not None:
                    settings["pipeline_depth"] = depth
                kw.setdefault("resolver_settings", settings)
            else:
                kw.setdefault("device", "cpu")
        elif arm == "set":
            kw.setdefault("conflict_backend", "torch")
        return kw

    class DynamicCluster(m.dc.DynamicCluster):
        def __init__(self, *a, **kw):
            super().__init__(*a, **arm_kw(dict(dc_kw or {}, **kw), True))
            made.append(self)

    class SimCluster(m.cluster.SimCluster):
        def __init__(self, *a, **kw):
            super().__init__(*a, **arm_kw(kw, False))
            made.append(self)

    loop_init = m.el.EventLoop.__init__

    def tracked_init(loop, *a, **kw):
        loop_init(loop, *a, **kw)
        loops.append(loop)
        if pkg == "ref":
            # The port's hubs (and the port's set) stamp virtual time from
            # the port's current loop: under the reference's cluster, its.
            port_el.set_event_loop(loop)

    patches.set(m.el.EventLoop, "__init__", tracked_init)
    run_one = m.el.EventLoop.run_one

    def collecting_run_one(loop):
        # Cyclic garbage is collected at fixed virtual instants: before
        # the first event at or past each multiple of GC_EVERY.
        heap = loop._heap
        if heap and heap[0][0] >= getattr(loop, "_twin_gc_at", GC_EVERY):
            loop._twin_gc_at = (heap[0][0] // GC_EVERY + 1) * GC_EVERY
            gc.collect()
        return run_one(loop)

    patches.set(m.el.EventLoop, "run_one", collecting_run_one)
    for mod in (m.dc, m.server, *namespaces):
        if "DynamicCluster" in vars(mod):
            patches.set(mod, "DynamicCluster", DynamicCluster)
    for mod in (m.cluster, m.server, *namespaces):
        if "SimCluster" in vars(mod):
            patches.set(mod, "SimCluster", SimCluster)
    if arm == "set":
        # Every resolver a SimCluster builds, and every one the
        # reference's workers recruit, over the port's set; the port's
        # workers recruit theirs through resolver_settings.
        def make_set(backend="torch", oldest_version=0, **_kw):
            return port_set(depth, oldest_version=oldest_version)

        patches.set(m.resolver, "ConflictSet", make_set)
    if pkg == "ref" and f9:
        fix_f9(m, patches)
    log = SMOKE.ClientLog(m.tx)
    recruit = RecruitLog(m.worker, patches)
    try:
        with SMOKE.fixed_gc():
            yield rec
            rec.update(
                events=log.events,
                recruits=recruit.events,
                trace=[{k: v for k, v in e.items() if k != "Time"} for e in col.events],
                clusters=[cluster_state(m, c) for c in made],
                loops=[(lp.now(), lp.rng.random_int(0, 1 << 30)) for lp in loops],
            )
    finally:
        log.remove()
        patches.undo()
        m.el.set_event_loop(None)
        port_el.set_event_loop(None)
        m.buggify.set_buggify_enabled(False)


def fixtures_for(fn, n_params, pkg, tmp_path, monkeypatch):
    """The arguments `fn` asks for after its first `n_params`: tmp_path,
    monkeypatch, and the reference modules' `env` fixture."""
    args = {}
    for name in list(inspect.signature(fn).parameters)[n_params:]:
        if name == "tmp_path":
            args[name] = tmp_path / pkg
            args[name].mkdir(exist_ok=True)
        elif name == "monkeypatch":
            args[name] = monkeypatch
        elif name == "fast_dd":
            continue
        elif name == "env":
            el = importlib.import_module(f"{BASES[pkg]}.flow.eventloop")
            net = importlib.import_module(f"{BASES[pkg]}.rpc")
            loop = el.EventLoop(seed=1234)
            el.set_event_loop(loop)
            args[name] = (loop, net.SimNetwork(loop))
        else:
            raise LookupError(f"no twin fixture {name!r}")
    return args


# tests/test_dd_role.py's fast_dd: the reference's dd_tracker_interval knob,
# the port's controllers' DD role setting.
FAST_DD = {"tracker_interval": 0.5}


@contextlib.contextmanager
def fast_dd(pkg):
    """While open, the reference's DD tracker interval knob at FAST_DD's;
    yields the port's DynamicCluster arguments for the same."""
    if pkg == "port":
        yield {"controller_settings": {"dd_settings": dict(FAST_DD)}}
        return
    from foundationdb_tpu.flow.knobs import g_knobs

    old = g_knobs.server.dd_tracker_interval
    g_knobs.server.dd_tracker_interval = FAST_DD["tracker_interval"]
    try:
        yield {}
    finally:
        g_knobs.server.dd_tracker_interval = old


def run_twin(pkg, arm, name, test, params=(), depth=None, tmp_path=None, monkeypatch=None):
    """Run test function `test` of reference test module `name` for `pkg`
    in `arm`; returns its record.  A `fast_dd` argument is
    tests/test_dd_role.py's fixture (see fast_dd)."""
    mod = load_twin(name, pkg)
    fn = getattr(mod, test)
    wants_dd = "fast_dd" in inspect.signature(fn).parameters
    with contextlib.ExitStack() as stack:
        dc_kw = stack.enter_context(fast_dd(pkg)) if wants_dd else None
        with twin_run(pkg, arm, depth, namespaces=(mod,), dc_kw=dc_kw) as rec:
            args = fixtures_for(fn, len(params), pkg, tmp_path, monkeypatch)
            if wants_dd:
                args["fast_dd"] = None
            fn(*params, **args)
    return rec


def first_difference(a, b, path=""):
    """Where two records first differ (a path and the two values), or None."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in list(a) + [k for k in b if k not in a]:
            if k not in a or k not in b:
                return f"{path}/{k}", a.get(k, "<missing>"), b.get(k, "<missing>")
            d = first_difference(a[k], b[k], f"{path}/{k}")
            if d:
                return d
        return None
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            d = first_difference(x, y, f"{path}[{i}]")
            if d:
                return d
        return None if len(a) == len(b) else (f"{path} length", len(a), len(b))
    return None if a == b else (path, a, b)


def assert_twins(name, test, params=(), arm="cpu", depth=None, tmp_path=None,
                 monkeypatch=None):
    """The reference's run of `test` and the port's, each passing its own
    asserts, hold equal records; returns the port's."""
    ref = run_twin("ref", arm, name, test, params, depth, tmp_path, monkeypatch)
    port = run_twin("port", arm, name, test, params, depth, tmp_path, monkeypatch)
    assert port["events"] == ref["events"]
    assert port["recruits"] == ref["recruits"]
    for key in ref:
        assert port[key] == ref[key], first_difference(port[key], ref[key], key)
    return port


# ---------------------------------------------------------------------------
# tests/test_dynamic_cluster.py
# ---------------------------------------------------------------------------

DC = "test_dynamic_cluster"
ROLES = ["proxy", "resolver", "sequencer", "tlog", "storage"]


def test_cluster_bootstraps_and_serves():
    rec = assert_twins(DC, "test_cluster_bootstraps_and_serves")
    assert rec["recruits"] and rec["events"]


@pytest.mark.parametrize("role", ROLES)
def test_any_role_failure_recovers(role):
    rec = assert_twins(DC, "test_any_role_failure_recovers", (role,))
    gens = [g for _t, _a, kind, g, _b in rec["recruits"] if kind == "InitSequencer"]
    assert len(set(gens)) >= 2, gens


@pytest.mark.parametrize("role", ["resolver", "tlog"])
def test_any_role_failure_recovers_over_the_ports_set(role):
    """The set arm: every generation's resolver is a port ConflictSet on
    the CPU, recruited anew at each recovery."""
    rec = assert_twins(DC, "test_any_role_failure_recovers", (role,), arm="set")
    gens = [g for _t, _a, kind, g, _b in rec["recruits"] if kind == "InitResolver"]
    assert len(set(gens)) >= 2, gens


def test_recovery_waits_for_stateful_machine():
    assert_twins(DC, "test_recovery_waits_for_stateful_machine")


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_controller_failover(arm):
    assert_twins(DC, "test_controller_failover", arm=arm)


def test_dynamic_determinism():
    assert_twins(DC, "test_dynamic_determinism")


def test_whole_cluster_crash_recovers_from_coordinator_disks():
    rec = assert_twins(DC, "test_whole_cluster_crash_recovers_from_coordinator_disks")
    assert any(name == "coordination.dq" for (_mid, name) in rec["clusters"][0]["disks"])


def test_repeated_whole_cluster_crashes():
    assert_twins(DC, "test_repeated_whole_cluster_crashes")


@pytest.mark.parametrize("role", ["tlog0", "tlog1", "storage0", "storage1"])
def test_replicated_role_failure_recovers(role):
    assert_twins(DC, "test_replicated_role_failure_recovers", (role,))


def test_replicated_whole_cluster_crash():
    assert_twins(DC, "test_replicated_whole_cluster_crash")


def test_permanent_tlog_loss_recovers_from_survivors():
    assert_twins(DC, "test_permanent_tlog_loss_recovers_from_survivors")


def test_permanent_tlog_loss_storage_replays_from_survivor():
    assert_twins(DC, "test_permanent_tlog_loss_storage_replays_from_survivor")


def test_permanent_storage_loss_recovers_from_teammate():
    assert_twins(DC, "test_permanent_storage_loss_recovers_from_teammate")


def test_sequencer_fences_stale_epoch_grants():
    assert_twins(DC, "test_sequencer_fences_stale_epoch_grants")


# ---------------------------------------------------------------------------
# the port alone, against the reference's host engine
# ---------------------------------------------------------------------------


def test_dynamic_cluster_defaults_to_the_card():
    """Without a card, DynamicCluster() and a recruited resolver's request
    raise before anything spawns; the CPU needs device= or the host
    engine."""
    m = mods("port")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default builds there")
    m.el.set_event_loop(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.dc.DynamicCluster(seed=1)
    assert m.el._current_loop is None  # it raised before building anything
    with pytest.raises(RuntimeError, match="CUDA"):
        m.worker.resolver_set(m.worker.InitResolver())
    assert m.worker.InitResolver().backend == "torch"
    assert m.worker.InitResolver().device is None


@pytest.mark.parametrize("role", ["resolver", "proxy"])
def test_port_set_against_the_reference_host_engine(role):
    """The port's DynamicCluster(conflict_backend="torch", device="cpu") at
    pipeline depth 1 against the reference's on its "cpu" backend: the
    same reads, commits and retries at the same virtual times, the same
    recruitment, the same data."""
    recs = {}
    for pkg, arm in (("ref", "cpu"), ("port", "set")):
        recs[pkg] = run_twin(pkg, arm, DC, "test_any_role_failure_recovers", (role,), depth=1)
    assert recs["port"]["events"] == recs["ref"]["events"]
    assert recs["port"]["recruits"] == recs["ref"]["recruits"]
    for key in ("disks", "controllers"):
        assert recs["port"]["clusters"][0][key] == recs["ref"]["clusters"][0][key]
    assert recs["port"]["loops"] == recs["ref"]["loops"]


# ---------------------------------------------------------------------------
# the twins that waited for the DynamicCluster
# ---------------------------------------------------------------------------


def test_broken_proxy_pipeline_triggers_recovery():
    rec = assert_twins("test_recovery", "test_broken_proxy_pipeline_triggers_recovery")
    assert any(e["Type"] == "ProxyCommitPipelineBroken" for e in rec["trace"])


def test_btree_engine_cluster_crash_recovery():
    rec = assert_twins("test_btree", "test_btree_engine_cluster_crash_recovery")
    assert any(name == "storage.bt" for (_mid, name) in rec["clusters"][0]["disks"])


def test_dynamic_cluster_dd_drops_dead_storage():
    rec = assert_twins("test_dd_role", "test_dynamic_cluster_dd_drops_dead_storage")
    assert rec["clusters"][0]["status"]["cluster"]["data_distribution"]["heals"] >= 0


# ---------------------------------------------------------------------------
# state carried across packages
# ---------------------------------------------------------------------------


def _crash(c):
    """crash_and_recover's power loss, without the reboot: every server
    process killed and each machine's unsynced writes settled."""
    procs = c._coord_procs + c._cc_procs + c._worker_procs
    for p in procs:
        p.kill()
    for p in procs:
        c.fs.crash_machine(p.machine.machine_id)
    return procs


def _reboot(c, procs):
    for p in procs:
        p.reboot()
    c._build_server_side()


def _recovered(m, c, db):
    """After a whole-cluster crash: the data read back, a write after it,
    and the recovered controller's generation and manifest."""
    out = {}

    async def check(tr):
        out["durable"] = await tr.get(b"durable")
        out["rows"] = await tr.get_range(b"row/", b"row0")
        tr.set(b"post-crash", b"written")

    c.run_all([(db, db.run(check))], timeout_vt=900.0)

    async def check2(tr):
        out["post"] = await tr.get(b"post-crash")

    c.run_all([(db, db.run(check2))], timeout_vt=300.0)
    cc = c.acting_controller()
    wire = importlib.import_module(f"{m.base}.rpc.wire")
    coord = importlib.import_module(f"{m.base}.server.coordination")
    raw = c.run_until(db.process.spawn(
        coord.CoordinatedState(db.process, c.coord_set).read()), timeout_vt=100.0)
    out["generation"] = cc.generation
    out["manifest"] = wire.decode_frame(raw)
    out["roles"] = sorted(cc._role_addrs.items())
    return out


def _before_crash(m):
    """The scenario's cluster and client, with its data committed."""
    c = m.dc.DynamicCluster(seed=55, conflict_backend="cpu")
    db = c.database()

    async def w(tr):
        tr.set(b"durable", b"yes")
        for i in range(20):
            tr.set(b"row/%02d" % i, b"v%d" % i)

    c.run_all([(db, db.run(w))], timeout_vt=300.0)
    return c, db


def test_port_boots_from_coordinator_disks_the_reference_wrote():
    """test_whole_cluster_crash_recovers_from_coordinator_disks across the
    packages: the reference's DynamicCluster commits and loses power (every
    process, coordinators included); the port's, run to the same point
    (its own disks then equal the reference's byte for byte), has every
    file replaced by a copy of the reference's and reboots on it.  It
    reaches the reference's recovered generation, manifest, role placement
    and data, at the same virtual time and rng draw as the reference's own
    recovery on those disks."""
    from foundationdb_tpu_torch.fileio import simfile as port_simfile

    ref, port = mods("ref"), mods("port")
    with twin_run("ref", "cpu") as want:
        c, db = _before_crash(ref)
        gen_before = c.acting_controller().generation
        procs = _crash(c)
        disks = SMOKE.disk_state(c.fs)
        _reboot(c, procs)
        want["out"] = _recovered(ref, c, db)
    with twin_run("port", "cpu") as got:
        pc, pdb = _before_crash(port)
        procs = _crash(pc)
        assert SMOKE.disk_state(pc.fs) == disks
        pc.fs._files.clear()
        for key, (durable, pending) in disks.items():
            f = port_simfile._SimFile(key[1])
            f.durable = bytearray(durable)
            f.pending = list(pending)
            pc.fs._files[key] = f
        _reboot(pc, procs)
        got["out"] = _recovered(port, pc, pdb)
    for key in want:
        assert got[key] == want[key], first_difference(got[key], want[key], key)
    out = got["out"]
    assert out["generation"] > gen_before and out["durable"] == b"yes"
    assert len(out["rows"]) == 20 and out["post"] == b"written"


def test_controller_knob_arguments_default_to_the_reference():
    """The reference's server knobs the controller reads are its
    constructor arguments, at the reference's defaults; InitResolver's set
    settings are the port's ConflictSet defaults."""
    from foundationdb_tpu.flow.knobs import g_knobs
    from foundationdb_tpu_torch.server.cluster_controller import ClusterController
    from foundationdb_tpu_torch.server.worker import InitResolver

    params = inspect.signature(ClusterController).parameters
    for name in ("max_versions_in_flight", "time_keeper_delay", "time_keeper_max_entries",
                 "recovery_missing_machine_grace", "log_replication_factor",
                 "recruitment_stabilize_window", "storage_team_size"):
        assert params[name].default == getattr(g_knobs.server, name), name
    assert params["conflict_backend"].default == "torch"
    cs_params = inspect.signature(ConflictSet).parameters
    req = InitResolver()
    for name in ("key_words", "h_cap", "pipeline_depth", "witness", "mirror_coalesce",
                 "bucket_mins", "device"):
        assert getattr(req, name) == cs_params[name].default, name
