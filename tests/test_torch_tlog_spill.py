"""The port's durable TLog (disk queue, spill store, recovery), held to the
reference's.

Twins of tests/test_tlog_spill.py: a spill that bounds memory under a
consumer that never pops while every version stays peekable, the spill
across a machine crash and ``TLog.recover``, pops that clear spilled rows,
``truncate_above`` purging spilled versions above the cut, and a dead
tag's spill GC across a restart.  Each runs the reference test's script
once on the reference package's TLog, event loop, network and files and
once on the port's, keeps the reference test's assertions on each run, and
holds equal: every peek reply, the log's state (versions, entries, bytes,
spill watermark, floors, dead tags) after each step, the spill store's
rows, every machine's file bytes and pending writes after each step and
each crash, the probes each run hit, and the loop's time and its rng's
next draw at the end.  Each run holds cyclic garbage collection to fixed
points (chip_smoke.py's ``fixed_gc``): a killed role's unanswered Reply
sends broken_promise when it is collected, drawing from the loop's rng.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import pathlib
from types import SimpleNamespace

import pytest

import foundationdb_tpu.client.types as ref_types
import foundationdb_tpu.fileio as ref_fileio
import foundationdb_tpu.flow.eventloop as ref_el
import foundationdb_tpu.rpc as ref_rpc
import foundationdb_tpu.server.interfaces as ref_if
import foundationdb_tpu.server.tlog as ref_tlog
import foundationdb_tpu_torch.client.types as port_types
import foundationdb_tpu_torch.fileio as port_fileio
import foundationdb_tpu_torch.flow.eventloop as port_el
import foundationdb_tpu_torch.rpc as port_rpc
import foundationdb_tpu_torch.server.interfaces as port_if
import foundationdb_tpu_torch.server.tlog as port_tlog

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)
norm = SMOKE.norm

PKGS = {
    "ref": SimpleNamespace(types=ref_types, fileio=ref_fileio, el=ref_el, rpc=ref_rpc,
                           itf=ref_if, TLog=ref_tlog.TLog,
                           probe=importlib.import_module("foundationdb_tpu.flow.testprobe")),
    "port": SimpleNamespace(types=port_types, fileio=port_fileio, el=port_el, rpc=port_rpc,
                            itf=port_if, TLog=port_tlog.TLog,
                            probe=importlib.import_module("foundationdb_tpu_torch.flow.testprobe")),
}
PROBES = ("tlog_spilled", "tlog_peek_spilled", "dead_tag_spill_gc", "epoch_orphans_truncated")


ref_buggify = importlib.import_module("foundationdb_tpu.flow.buggify")
port_buggify = importlib.import_module("foundationdb_tpu_torch.flow.buggify")


@pytest.fixture(autouse=True)
def _clean_globals():
    """Both packages' buggify off (an earlier test may leave it on) and
    no current loop, before and after each test."""
    for buggify in (ref_buggify, port_buggify):
        buggify.set_buggify_enabled(False)
    yield
    ref_el.set_event_loop(None)
    port_el.set_event_loop(None)
    for buggify in (ref_buggify, port_buggify):
        buggify.set_buggify_enabled(False)


def make_env(P, seed):
    loop = P.el.EventLoop(seed=seed)
    P.el.set_event_loop(loop)
    net = P.rpc.SimNetwork(loop)
    fs = P.fileio.SimFileSystem(net)
    return loop, net, fs


def disk(fs):
    return {k: (bytes(f.durable), [(o, bytes(d)) for o, d in f.pending])
            for k, f in sorted(fs._files.items())}


def log_state(log):
    """A TLog's state: its window, floors, spill watermark and dead tags,
    and every row of its spill store."""
    return dict(versions=list(log.versions), entries=norm(log.entries),
                ver_bytes=list(log._ver_bytes), mem=log._mem_bytes, durable=log.durable.get(),
                popped=log.popped, popped_tags=dict(log.popped_tags),
                dead=sorted(log._dead_tags), spilled=log.spilled_through,
                gc_floor=log._spill_gc_floor, known=log.known_committed,
                spill=log.spill_store.read_range(b"", b"\xff\xff") if log.spill_store else None)


def _mut(P, i):
    return P.types.Mutation(P.types.MutationType.SET_VALUE, b"k%06d" % i, b"v" * 100)


async def _push(P, iface, proc, version, prev, tagged):
    return await iface.commit.get_reply(proc, P.itf.TLogCommitRequest(
        version=version, prev_version=prev, tagged=tagged, epoch=0))


async def _settle(loop, log, mem_too=False):
    for _ in range(200):
        if not log._spilling and (not mem_too or log._mem_bytes <= log.spill_threshold_bytes):
            break
        await loop.delay(0.01)


def twin(script, *args):
    """`script(P, rec, *args)` through both packages: the records equal,
    and each run hit the same probes as many times."""
    got = {}
    for pkg, P in PKGS.items():
        before = {n: P.probe.hit_sites.get(n, 0) for n in PROBES}
        rec = {}
        with SMOKE.fixed_gc():
            script(P, rec, *args)
        rec["probes"] = {n: P.probe.hit_sites.get(n, 0) - before[n] for n in PROBES}
        got[pkg] = rec
    diff = [k for k in got["ref"] if got["ref"][k] != got["port"].get(k)]
    assert not diff and set(got["ref"]) == set(got["port"]), f"ref and port differ in {diff}"
    assert got["port"].get("ok")
    return got["port"]


def spill_bounds_memory(P, rec, seed):
    loop, net, fs = make_env(P, seed)
    proc, client = net.process("tlog"), net.process("client")

    async def run():
        log = await P.TLog.fresh(proc, fs, "t.dq")
        log.spill_threshold_bytes = 20_000
        log.spill_keep_versions = 8
        iface = log.interface()
        n = 300
        for v in range(1, n + 1):
            await _push(P, iface, client, v, v - 1, {"ss0": [(0, _mut(P, v))]})
        await _settle(loop, log, mem_too=True)
        rec["spilled"] = log_state(log)
        rec["disk spilled"] = disk(fs)
        assert log.spilled_through > 0, "spill never engaged"
        assert log._mem_bytes <= log.spill_threshold_bytes
        assert len(log.versions) < n // 2
        got, replies, begin = [], [], 0
        while True:
            rep = await iface.peek.get_reply(
                client, P.itf.TLogPeekRequest(begin_version=begin, tags=["ss0"]))
            replies.append((loop.now(), norm(rep)))
            got.extend(rep.entries)
            if rep.end_version <= begin and not rep.entries:
                break
            begin = max(rep.end_version, begin)
            if begin >= n and not rep.has_more:
                break
        assert [v for v, _m in got] == list(range(1, n + 1))
        assert all(m[0].param1 == b"k%06d" % v for v, m in got)
        rec["replies"] = replies
        rec["ok"] = True

    loop.run_until(proc.spawn(run()), timeout_vt=5000.0)
    rec["end"] = (loop.now(), loop.rng.random_int(0, 1 << 30))


@pytest.mark.parametrize("seed", [1, 2])
def test_spill_bounds_memory_and_serves_backlog(seed):
    twin(spill_bounds_memory, seed)


def spill_crash(P, rec):
    loop, net, fs = make_env(P, 11)
    proc, client = net.process("tlog"), net.process("client")
    state = {}

    async def writer():
        log = await P.TLog.fresh(proc, fs, "t.dq")
        log.spill_threshold_bytes = 10_000
        log.spill_keep_versions = 4
        iface = log.interface()
        for v in range(1, 121):
            await _push(P, iface, client, v, v - 1, {"ss0": [(0, _mut(P, v))]})
        await _settle(loop, log, mem_too=True)
        assert log.spilled_through > 0
        state["spilled_through"] = log.spilled_through
        rec["before crash"] = log_state(log)

    loop.run_until(proc.spawn(writer()), timeout_vt=5000.0)
    rec["disk before crash"] = disk(fs)
    proc.kill()
    fs.crash_machine("tlog")
    proc.reboot()
    gc.collect()  # the killed log's garbage, at a fixed point (SMOKE.fixed_gc)
    rec["disk after crash"] = disk(fs)

    async def recover():
        log = await P.TLog.recover(proc, fs, "t.dq")
        rec["recovered"] = log_state(log)
        assert log.spilled_through == state["spilled_through"]
        assert log.durable.get() == 120
        iface = log.interface()
        got, begin, replies = [], 0, []
        while begin < 120:
            rep = await iface.peek.get_reply(
                client, P.itf.TLogPeekRequest(begin_version=begin, tags=["ss0"]))
            replies.append((loop.now(), norm(rep)))
            got.extend(v for v, _m in rep.entries)
            begin = max(rep.end_version, begin + (0 if rep.entries else 1))
        assert got == list(range(1, 121))
        rec["replies"] = replies
        rec["ok"] = True

    loop.run_until(proc.spawn(recover()), timeout_vt=5000.0)
    rec["end"] = (loop.now(), loop.rng.random_int(0, 1 << 30))


def test_spill_survives_crash_recovery():
    twin(spill_crash)


def pop_clears(P, rec):
    loop, net, fs = make_env(P, 21)
    proc, client = net.process("tlog"), net.process("client")

    async def run():
        log = await P.TLog.fresh(proc, fs, "t.dq")
        log.spill_threshold_bytes = 10_000
        log.spill_keep_versions = 4
        iface = log.interface()
        for v in range(1, 101):
            await _push(P, iface, client, v, v - 1, {"ss0": [(0, _mut(P, v))]})
        await _settle(loop, log)
        assert log.spilled_through > 0
        rec["before pop"] = log_state(log)
        await iface.pop.get_reply(client, P.itf.TLogPopRequest(version=100, tag="ss0"))
        for _ in range(100):
            await loop.delay(0.01)
        left = log.spill_store.read_range(b"t/", b"t0", limit=10)
        assert left == [], f"spilled rows survived the pop: {left[:3]}"
        rec["after pop"] = log_state(log)
        rec["disk"] = disk(fs)
        rec["ok"] = True

    loop.run_until(proc.spawn(run()), timeout_vt=5000.0)
    rec["end"] = (loop.now(), loop.rng.random_int(0, 1 << 30))


def test_pop_clears_spilled_data():
    twin(pop_clears)


def truncate_purges(P, rec):
    loop, net, fs = make_env(P, 31)
    proc, client = net.process("tlog"), net.process("client")

    async def run():
        log = await P.TLog.fresh(proc, fs, "t.dq")
        log.spill_threshold_bytes = 10_000
        log.spill_keep_versions = 4
        iface = log.interface()
        for v in range(1, 101):
            await _push(P, iface, client, v, v - 1, {"ss0": [(0, _mut(P, v))]})
        await _settle(loop, log)
        assert log.spilled_through > 60, log.spilled_through
        cut = 60
        await log.truncate_above(cut)
        assert log.spilled_through == cut
        rec["truncated"] = log_state(log)
        rec["disk truncated"] = disk(fs)
        got, begin, replies = [], 0, []
        while begin < cut:
            rep = await iface.peek.get_reply(
                client, P.itf.TLogPeekRequest(begin_version=begin, tags=["ss0"]))
            replies.append((loop.now(), norm(rep)))
            got.extend(v for v, _m in rep.entries)
            begin = max(rep.end_version, begin + (0 if rep.entries else 1))
        assert got == list(range(1, cut + 1))
        rows = log.spill_store.read_range(b"t/", b"t0")
        assert all(int.from_bytes(k[-8:], "big") <= cut for k, _ in rows)
        rec["replies"] = replies
        rec["ok"] = True

    loop.run_until(proc.spawn(run()), timeout_vt=5000.0)
    rec["end"] = (loop.now(), loop.rng.random_int(0, 1 << 30))


def test_truncate_above_purges_spill():
    twin(truncate_purges)


def dead_tag_gc(P, rec):
    loop, net, fs = make_env(P, 31)
    proc, client = net.process("tlog"), net.process("client")

    def both(v):
        return {"ss0": [(0, _mut(P, v))], "dead1": [(1, _mut(P, v))]}

    async def phase1():
        log = await P.TLog.fresh(proc, fs, "t.dq")
        log.spill_threshold_bytes = 10_000
        log.spill_keep_versions = 4
        iface = log.interface()
        await iface.pop.get_reply(client, P.itf.TLogPopRequest(version=0, tag="ss0"))
        await iface.pop.get_reply(client, P.itf.TLogPopRequest(tag="dead1", unregister=True))
        for v in range(1, 101):
            await _push(P, iface, client, v, v - 1, both(v))
        await _settle(loop, log)
        assert log.spilled_through > 0
        assert "dead1" in log._dead_tags
        rec["phase1"] = log_state(log)

    loop.run_until(proc.spawn(phase1()), timeout_vt=5000.0)
    rec["disk before crash"] = disk(fs)
    proc.kill()
    fs.crash_machine("tlog")
    proc.reboot()
    gc.collect()  # the killed log's garbage, at a fixed point (SMOKE.fixed_gc)
    rec["disk after crash"] = disk(fs)

    async def phase2():
        log = await P.TLog.recover(proc, fs, "t.dq")
        rec["recovered"] = log_state(log)
        assert "dead1" in log._dead_tags, "dead tag forgotten on restart"
        iface = log.interface()
        prev = log.durable.get()
        for v in range(prev + 1, prev + 81):
            await _push(P, iface, client, v, v - 1, both(v))
        await _settle(loop, log)
        await iface.pop.get_reply(client, P.itf.TLogPopRequest(version=prev + 80, tag="ss0"))
        for _ in range(100):
            await loop.delay(0.01)
        left = log.spill_store.read_range(b"t/dead1/", b"t/dead10", limit=10)
        assert left == [], f"dead tag's spilled rows survived GC: {left[:3]}"
        rec["phase2"] = log_state(log)
        rec["ok"] = True

    loop.run_until(proc.spawn(phase2()), timeout_vt=5000.0)
    rec["end"] = (loop.now(), loop.rng.random_int(0, 1 << 30))


def test_unregistered_tag_spill_gc_survives_restart():
    rec = twin(dead_tag_gc)
    assert rec["probes"]["dead_tag_spill_gc"] > 0
