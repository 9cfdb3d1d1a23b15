"""The port's durable cluster (``SimCluster(durable=True)``,
``crash_and_recover``), held to the reference's.

Twins of the first three tests of tests/test_recovery.py (committed data
survives full-cluster crashes, the cluster keeps working after a recovery,
a snapshot from before the recovery fails with a retryable error; its
fourth needs the DynamicCluster), plus: ``TLog.fresh`` over a machine
holding a stale log; the crash test under ``KillMode.DROP_ONLY``; the
state carried across packages (the port's ``TLog.recover`` and
``StorageServer.recover`` read a disk the reference's cluster wrote and
crashed, and reach the reference's recovered state); and chip_smoke.py's
durable script (phase 6f's restarting test: a Cycle ring, two crashes)
at depths 1-3.  Both clusters run resolver 0 over a port
``ConflictSet(device="cpu")`` built alike, so no XLA program is compiled.
Held equal: every read, commit and retry with its virtual time, every
machine's file bytes and pending writes after each crash, the set's
in-flight batches at each kill and every batch it decided (the first
verdicts and witnesses after each recovery among them), the recovered
log's and storage's state, the set's exported state and the loop's time
and its rng's next draw at the end.  Each run holds cyclic garbage
collection to fixed points (chip_smoke.py's ``fixed_gc``): a killed role's
unanswered Reply sends broken_promise when it is collected, drawing from
the loop's rng, in both packages.

Shapes are the reference rig's: key_words=3, h_cap=1<<10,
bucket_mins=(32, 128, 64).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import pathlib
from types import SimpleNamespace

import pytest

import foundationdb_tpu.client.transaction as ref_tx
import foundationdb_tpu.client.types as ref_types
import foundationdb_tpu.fileio as ref_fileio
import foundationdb_tpu.flow.eventloop as ref_el
import foundationdb_tpu.flow.flight_recorder as ref_fr
import foundationdb_tpu.flow.spans as ref_spans
import foundationdb_tpu.flow.trace as ref_trace
import foundationdb_tpu.rpc as ref_rpc
import foundationdb_tpu.server.interfaces as ref_if
import foundationdb_tpu.server.storage as ref_storage
import foundationdb_tpu.server.tlog as ref_tlog
import foundationdb_tpu.workloads as ref_wl
from foundationdb_tpu.server.cluster import SimCluster as RefSimCluster
from foundationdb_tpu_torch import fileio as port_fileio
from foundationdb_tpu_torch import rpc as port_rpc
from foundationdb_tpu_torch import workloads as port_wl
from foundationdb_tpu_torch.client import transaction as port_tx
from foundationdb_tpu_torch.client import types as port_types
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.engine_cpu import CpuConflictSet
from foundationdb_tpu_torch.fileio import simfile as port_simfile
from foundationdb_tpu_torch.flow import eventloop as port_el
from foundationdb_tpu_torch.flow import flight_recorder as port_fr
from foundationdb_tpu_torch.flow import spans as port_spans
from foundationdb_tpu_torch.flow import timeseries as port_ts
from foundationdb_tpu_torch.flow import trace as port_trace
from foundationdb_tpu_torch.server import interfaces as port_if
from foundationdb_tpu_torch.server import storage as port_storage
from foundationdb_tpu_torch.server import tlog as port_tlog
from foundationdb_tpu_torch.server.cluster import SimCluster as PortSimCluster

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)
norm = SMOKE.norm

ref_buggify = importlib.import_module("foundationdb_tpu.flow.buggify")
port_buggify = importlib.import_module("foundationdb_tpu_torch.flow.buggify")

PKGS = {
    "ref": SimpleNamespace(Cluster=RefSimCluster, types=ref_types, tx=ref_tx, wl=ref_wl,
                           el=ref_el, rpc=ref_rpc, itf=ref_if, fileio=ref_fileio,
                           TLog=ref_tlog.TLog,
                           Storage=ref_storage.StorageServer, kw={}),
    "port": SimpleNamespace(Cluster=PortSimCluster, types=port_types, tx=port_tx, wl=port_wl,
                            el=port_el, rpc=port_rpc, itf=port_if, fileio=port_fileio,
                            TLog=port_tlog.TLog,
                            Storage=port_storage.StorageServer, kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _clean_globals():
    saved = (ref_spans.global_span_hub(), ref_trace.global_collector(),
             ref_fr.global_flight_recorder(), port_spans.global_span_hub(),
             port_trace.global_collector(), port_trace._global_clock,
             port_fr.global_flight_recorder(), port_ts.global_timeseries())
    ref_buggify.set_buggify_enabled(False)  # an earlier test may leave it on
    port_buggify.set_buggify_enabled(False)
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


def _install_hubs():
    """A fresh span hub, trace collector and flight recorder, installed into
    both packages' globals: the port's set records into the port's hub
    under either package's cluster, so each run starts from the same."""
    hub, col, rec = port_spans.SpanHub(), port_trace.TraceCollector(), port_fr.FlightRecorder()
    ref_spans.set_global_span_hub(hub)
    port_spans.set_global_span_hub(hub)
    ref_trace.set_global_collector(col)
    port_trace.set_global_collector(col)
    ref_fr.set_global_flight_recorder(rec)
    port_fr.set_global_flight_recorder(rec)
    port_ts.set_global_timeseries(port_ts.TimeSeriesHub())


def _port_set(depth=2):
    return ConflictSet(device="cpu", pipeline_depth=depth, key_words=3,
                       bucket_mins=(32, 128, 64), h_cap=1 << 10)


def _exported(cs):
    mirror = (list(cs._cpu.keys), list(cs._cpu.vers), cs._cpu.oldest_version)
    out = CpuConflictSet()
    cs._dev.store_to(out)
    return mirror, (list(out.keys), list(out.vers), out.oldest_version)


def tlog_state(log):
    return dict(versions=list(log.versions), entries=norm(log.entries),
                ver_bytes=list(log._ver_bytes), durable=log.durable.get(), popped=log.popped,
                popped_tags=dict(log.popped_tags), dead=sorted(log._dead_tags),
                spilled=log.spilled_through, epoch=log.epoch,
                spill=log.spill_store.read_range(b"", b"\xff\xff") if log.spill_store else None)


def storage_state(ss):
    st = ss.store
    return dict(kv=norm(st.kv), keys=list(st.sorted_keys), clears=list(st.clears),
                version=ss.version.get(), durable=ss.durable_version,
                owned=[(b, e, v) for b, e, v in ss.owned.items()],
                engine=ss.kvstore.read_range(b"", b"\xff\xff\xff", 1 << 30))


def cluster_state(c, setlog):
    return dict(tlog=tlog_state(c.tlog), storage=storage_state(c.storage),
                sequencer=(c.sequencer.version, c.sequencer.committed.get()),
                disk=SMOKE.disk_state(c.fs), batches=setlog.record(),
                set=_exported(setlog.cs), end=(c.loop.now(), c.loop.rng.random_int(0, 1 << 30)))


def twin(script, *args):
    """`script(P, *args)` through both packages: the records equal."""
    got = {}
    for pkg, P in PKGS.items():
        _install_hubs()
        with SMOKE.fixed_gc():
            got[pkg] = script(P, *args)
        P.el.set_event_loop(None)
    diff = [k for k in got["ref"] if got["ref"][k] != got["port"].get(k)]
    assert not diff and set(got["ref"]) == set(got["port"]), f"ref and port differ in {diff}"
    return got["port"]


def durable_cluster(P, seed, depth=2, **kw):
    cs = _port_set(depth)
    setlog = SMOKE.SetLog(cs)
    c = P.Cluster(seed=seed, durable=True, conflict_set=cs, **P.kw, **kw)
    return c, setlog


def crash(c, setlog, rec, label):
    """crash_and_recover with the set's in-flight batches noted before it
    and the disks after it."""
    rec[f"{label} inflight"] = setlog.cs.pipeline_inflight
    c.crash_and_recover()
    gc.collect()  # the old roles' garbage, at a fixed point (SMOKE.fixed_gc)
    rec[f"{label} disk"] = SMOKE.disk_state(c.fs)


# ---------------------------------------------------------------------------
# tests/test_recovery.py
# ---------------------------------------------------------------------------


def survives_crashes(P, seed, kill_mode=None):
    c, setlog = durable_cluster(P, seed)
    if kill_mode is not None:
        c.fs.kill_mode = getattr(P.fileio.KillMode, kill_mode)
    db = c.database()
    committed, rec = {}, {}
    log_ = SMOKE.ClientLog(P.tx)
    try:
        def writer_round(r):
            async def go():
                rng = c.loop.rng
                for i in range(int(rng.random_int(2, 6))):
                    tr = db.create_transaction()
                    k = b"key/%d" % int(rng.random_int(0, 12))
                    v = b"r%d-i%d" % (r, i)
                    tr.set(k, v)
                    await tr.commit()
                    committed[k] = v
            return go()

        for crash_round in range(3):
            c.run_all([(db, writer_round(crash_round))], timeout_vt=500.0)
            crash(c, setlog, rec, f"crash {crash_round}")
            out = {}

            async def check(tr):
                out["state"] = dict(await tr.get_range(b"key/", b"key0"))

            c.run_all([(db, db.run(check))], timeout_vt=500.0)
            assert out["state"] == committed, f"after crash {crash_round}"
            rec[f"state {crash_round}"] = out["state"]
    finally:
        log_.remove()
    rec.update(events=log_.events, **cluster_state(c, setlog))
    setlog.remove()
    return rec


@pytest.mark.parametrize("seed", range(6))
def test_committed_data_survives_cluster_crash(seed):
    twin(survives_crashes, seed)


def keeps_working(P):
    c, setlog = durable_cluster(P, 42)
    db = c.database()
    MT = P.types.MutationType
    rec = {}

    async def w1(tr):
        tr.set(b"a", b"1")
        tr.atomic_op(MT.ADD_VALUE, b"n", (7).to_bytes(4, "little"))

    c.run_all([(db, db.run(w1))])
    crash(c, setlog, rec, "crash")

    async def w2(tr):
        tr.set(b"b", b"2")
        tr.atomic_op(MT.ADD_VALUE, b"n", (5).to_bytes(4, "little"))

    c.run_all([(db, db.run(w2))])
    out = {}

    async def check(tr):
        out["a"] = await tr.get(b"a")
        out["b"] = await tr.get(b"b")
        out["n"] = int.from_bytes(await tr.get(b"n"), "little")

    c.run_all([(db, db.run(check))])
    assert out == {"a": b"1", "b": b"2", "n": 12}
    rec.update(out=out, **cluster_state(c, setlog))
    setlog.remove()
    return rec


def test_cluster_keeps_working_after_recovery():
    twin(keeps_working)


def stale_snapshot(P):
    c, setlog = durable_cluster(P, 9)
    db = c.database()
    rec = {}

    async def w(tr):
        tr.set(b"x", b"1")

    c.run_all([(db, db.run(w))])
    tr = db.create_transaction()

    async def grab_version():
        await tr.get_read_version()

    c.run_all([(db, grab_version())])
    crash(c, setlog, rec, "crash")
    result = {}

    async def stale_write():
        try:
            await tr.get(b"x")
            tr.set(b"x", b"2")
            await tr.commit()
            result["r"] = "committed"
        except Exception as e:  # noqa: BLE001 - each package's FdbError
            result["r"] = e.name

    c.run_all([(db, stale_write())], timeout_vt=500.0)
    assert result["r"] in ("transaction_too_old", "future_version")
    rec.update(result=result, **cluster_state(c, setlog))
    setlog.remove()
    return rec


def test_stale_snapshot_too_old_after_recovery():
    twin(stale_snapshot)


# ---------------------------------------------------------------------------
# Beyond the reference file: TLog.fresh, DROP_ONLY, the carried state
# ---------------------------------------------------------------------------


def fresh_over_stale(P):
    """A log recovered, written, crashed; then TLog.fresh on the same
    machine deletes the stale files, starts at the new epoch's begin,
    refuses peeks below it and takes commits above it."""
    loop = P.el.EventLoop(seed=17)
    P.el.set_event_loop(loop)
    net = P.rpc.SimNetwork(loop)
    fs = P.fileio.SimFileSystem(net)
    proc, client = net.process("tlog"), net.process("client")
    M, MT = P.types.Mutation, P.types.MutationType
    rec = {}

    def push(iface, v, prev, epoch=0):
        return iface.commit.get_reply(client, P.itf.TLogCommitRequest(
            version=v, prev_version=prev, tagged={"ss0": [(0, M(MT.SET_VALUE, b"k%d" % v, b"v"))]},
            epoch=epoch))

    async def old():
        log = await P.TLog.recover(proc, fs, "t.dq")
        iface = log.interface()
        for v in range(1, 21):
            await push(iface, v, v - 1)
        rec["old"] = tlog_state(log)

    loop.run_until(proc.spawn(old()), timeout_vt=100.0)
    proc.kill()
    fs.crash_machine("tlog")
    proc.reboot()
    rec["stale disk"] = SMOKE.disk_state(fs)

    async def fresh():
        log = await P.TLog.fresh(proc, fs, "t.dq", epoch_begin=1000, epoch=1)
        rec["fresh"] = tlog_state(log)
        rec["fresh disk"] = SMOKE.disk_state(fs)
        iface = log.interface()
        try:
            await iface.peek.get_reply(client, P.itf.TLogPeekRequest(begin_version=5,
                                                                     tags=["ss0"]))
            rec["below"] = "answered"
        except Exception as e:  # noqa: BLE001 - each package's FdbError
            rec["below"] = e.name
        for v in range(1001, 1006):
            await push(iface, v, v - 1, epoch=1)
        rep = await iface.peek.get_reply(client, P.itf.TLogPeekRequest(begin_version=1000,
                                                                       tags=["ss0"]))
        rec["peek"] = (loop.now(), norm(rep))
        rec["after"] = tlog_state(log)

    loop.run_until(proc.spawn(fresh()), timeout_vt=100.0)
    assert rec["below"] == "peek_below_begin"
    assert [v for v, _m in rec["peek"][1][1][0][1]] == list(range(1001, 1006))
    assert not rec["fresh"]["versions"] and rec["fresh"]["durable"] == 1000
    rec.update(disk=SMOKE.disk_state(fs), end=(loop.now(), loop.rng.random_int(0, 1 << 30)))
    return rec


def test_tlog_fresh_replaces_stale_log():
    twin(fresh_over_stale)


def test_committed_data_survives_drop_only_crashes():
    twin(survives_crashes, 3, "DROP_ONLY")


def _copy_disk(src_fs, dst_fs):
    """The reference's files, byte for byte, into the port's file system."""
    for key, f in src_fs._files.items():
        g = port_simfile._SimFile(f.name)
        g.durable = bytearray(f.durable)
        g.pending = [(o, bytes(d)) for o, d in f.pending]
        dst_fs._files[key] = g


def test_port_recovers_a_disk_the_reference_wrote():
    """The reference's durable cluster commits, loses power (every
    process killed, unsynced writes settled); then each package recovers
    the log and the storage from that disk: the port's TLog.recover and
    StorageServer.recover on a copy of the reference's files reach the
    reference's recovered state, and the storage catches up from the log
    to the same window."""
    cs = _port_set()
    c = RefSimCluster(seed=5, durable=True, conflict_set=cs)
    db = c.database()

    async def fill(tr):
        for i in range(40):
            tr.set(b"carry/%03d" % i, b"v%d" % i)

    async def more(tr):
        tr.clear_range(b"carry/010", b"carry/020")
        tr.atomic_op(ref_types.MutationType.ADD_VALUE, b"carry/n", (3).to_bytes(4, "little"))

    c.run_all([(db, db.run(fill))])
    c.run_all([(db, db.run(more))])
    procs = [c.master_proc, c.resolver_proc, c.tlog_proc, c.storage_proc, c.proxy_proc]
    for p in procs:
        p.kill()
    for p in procs:
        c.fs.crash_machine(p.machine.machine_id)
    for p in procs:
        p.reboot()
    epoch_begin = c.sequencer.version + 100_000_000
    ref_loop, ref_fs = c.loop, c.fs

    port_loop = port_el.EventLoop(seed=5)
    port_el.set_event_loop(port_loop)
    port_net = port_rpc.SimNetwork(port_loop)
    port_fs = port_fileio.SimFileSystem(port_net)
    port_procs = {n: port_net.process(n) for n in ("tlog", "storage")}
    _copy_disk(ref_fs, port_fs)
    assert SMOKE.disk_state(port_fs) == SMOKE.disk_state(ref_fs)

    got = {}
    for pkg, loop, fs, procs_ in (("ref", ref_loop, ref_fs, {"tlog": c.tlog_proc,
                                                             "storage": c.storage_proc}),
                                  ("port", port_loop, port_fs, port_procs)):
        P = PKGS[pkg]
        P.el.set_event_loop(loop)
        out = {}

        async def recover(P=P, fs=fs, procs_=procs_, out=out):
            log = await P.TLog.recover(procs_["tlog"], fs, "tlog.dq", fast_forward_to=epoch_begin)
            ss = await P.Storage.recover(procs_["storage"], log.interface(), fs, "storage.dq")
            out["log"], out["ss"] = log, ss
            out["recovered"] = (tlog_state(log), storage_state(ss))

        loop.run_until(procs_["tlog"].spawn(recover()), timeout_vt=loop.now() + 100.0)
        ss = out["ss"]
        loop.run_until(ss.version.when_at_least(epoch_begin), timeout_vt=loop.now() + 100.0)
        st = storage_state(ss)
        reads = {k: ss.store.get(k, ss.version.get()) if ss.store.get_stamped(
            k, ss.version.get())[0] else ss.kvstore.read_value(k)
            for k in (b"carry/005", b"carry/015", b"carry/n")}
        got[pkg] = dict(recovered=out["recovered"], caught_up=(st["kv"], st["keys"],
                                                              st["clears"], st["owned"]),
                        reads=reads, disk=SMOKE.disk_state(fs))
        P.el.set_event_loop(None)
    assert got["ref"] == got["port"]
    assert got["port"]["reads"] == {b"carry/005": b"v5", b"carry/015": None,
                                    b"carry/n": (3).to_bytes(4, "little")}


# ---------------------------------------------------------------------------
# chip_smoke.py's durable script (phase 6f's restarting test)
# ---------------------------------------------------------------------------


def restarting(P, depth):
    c, setlog = durable_cluster(P, 47, depth=depth, buggify=True)
    try:
        rec = SMOKE.durable_script(c, P.wl, P.tx, SMOKE.DURABLE_VS_CPU_SHAPE, setlog,
                                   export=_exported)
    finally:
        setlog.remove()
    return rec


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_restarting_cycle_script(depth):
    rec = twin(restarting, depth)
    assert len(rec["rings"]) == SMOKE.DURABLE_VS_CPU_SHAPE["crashes"]
    assert all(SMOKE.ring_ok([int(v) for _k, v in ring]) for ring in rec["rings"])
