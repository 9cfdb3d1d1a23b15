"""The port's simulated file stack, disk queue and storage engines, held
to the reference's.

Twins of tests/test_fileio.py (the disk queue's prefix durability, the
memory engine's recovery and snapshot compaction, sync under full
corruption, concurrent commits), of tests/test_btree.py's engine cases
(the model differential, crash recovery, a dataset past the node cache,
oversized keys and values; its DynamicCluster case waits for the control
plane) and of tests/test_kvstore_differential.py's engine x seed matrix.
Beyond those files: a crash with unsynced writes of every size pending,
under each KillMode, and a crash in the middle of a disk queue's commit.
Each runs the reference test's seeded script once through the reference
package (its event loop, network and fileio) and once through the port's,
keeps the reference test's own assertions on each run, and holds equal:
every machine's file bytes and pending writes after each step and each
crash, the recovered store's contents, every read's answer and the
loop's time and its rng's next draw at the end.
"""

from __future__ import annotations

import zlib
from types import SimpleNamespace

import pytest

import foundationdb_tpu.fileio as ref_fileio
import foundationdb_tpu.fileio.btree as ref_btree
import foundationdb_tpu.fileio.kvstore as ref_kvstore
import foundationdb_tpu.flow.eventloop as ref_el
import foundationdb_tpu.rpc as ref_rpc
import foundationdb_tpu_torch.fileio as port_fileio
import foundationdb_tpu_torch.fileio.btree as port_btree
import foundationdb_tpu_torch.fileio.kvstore as port_kvstore
import foundationdb_tpu_torch.flow.eventloop as port_el
import foundationdb_tpu_torch.rpc as port_rpc

PKGS = {
    "ref": SimpleNamespace(fileio=ref_fileio, btree=ref_btree, kvstore=ref_kvstore, el=ref_el,
                           rpc=ref_rpc),
    "port": SimpleNamespace(fileio=port_fileio, btree=port_btree, kvstore=port_kvstore,
                            el=port_el, rpc=port_rpc),
}


@pytest.fixture(autouse=True)
def _clean_loops():
    yield
    ref_el.set_event_loop(None)
    port_el.set_event_loop(None)


def make_env(P, seed, kill_mode=None):
    loop = P.el.EventLoop(seed=seed)
    P.el.set_event_loop(loop)
    net = P.rpc.SimNetwork(loop)
    kill_mode = P.fileio.KillMode.FULL_CORRUPTION if kill_mode is None else kill_mode
    fs = P.fileio.SimFileSystem(net, kill_mode=kill_mode)
    return loop, net, fs


def drive(loop, proc, coro, timeout_vt=100.0):
    return loop.run_until(proc.spawn(coro), timeout_vt=timeout_vt)


def disk(fs):
    """Every machine's files: (machine, name) -> durable bytes and the
    pending (offset, bytes) writes."""
    return {k: (bytes(f.durable), [(o, bytes(d)) for o, d in f.pending])
            for k, f in sorted(fs._files.items())}


def crash(fs, proc, rec, label):
    """Kill `proc`'s machine as the reference tests do; the disks before
    and after the crash's rng draws go into `rec`."""
    rec[f"{label} before"] = disk(fs)
    proc.kill()
    fs.crash_machine(proc.machine.machine_id)
    proc.reboot()
    rec[f"{label} after"] = disk(fs)


def end(loop):
    return loop.now(), loop.rng.random_int(0, 1 << 30)


def twin(script, *args):
    """`script(P, *args)` through both packages: the records equal."""
    got = {pkg: script(P, *args) for pkg, P in PKGS.items()}
    diff = [k for k in got["ref"] if got["ref"][k] != got["port"].get(k)]
    assert not diff and set(got["ref"]) == set(got["port"]), f"ref and port differ in {diff}"
    return got["port"]


# ---------------------------------------------------------------------------
# tests/test_fileio.py
# ---------------------------------------------------------------------------


def diskqueue_prefix(P, seed):
    loop, net, fs = make_env(P, seed)
    proc = net.process("node")
    state, rec = {}, {}

    async def writer():
        q, got = await P.fileio.DiskQueue.open(fs, proc, "queue.dq")
        assert got == []
        committed = []
        seq = 0
        for _round in range(5):
            for _ in range(loop.rng.random_int(1, 4)):
                seq += 1
                q.push(seq, b"payload-%d" % seq * loop.rng.random_int(1, 9))
            await q.commit()
            committed.append(seq)
        for _ in range(loop.rng.random_int(0, 3)):
            seq += 1
            q.push(seq, b"uncommitted-%d" % seq)
        state["committed_through"] = committed[-1]
        state["pushed_through"] = seq

    drive(loop, proc, writer())
    crash(fs, proc, rec, "crash")

    async def recover():
        q, got = await P.fileio.DiskQueue.open(fs, proc, "queue.dq")
        state["recovered"] = got
        rec["popped"] = q.popped_seq

    drive(loop, proc, recover())
    got = state["recovered"]
    seqs = [s for s, _ in got]
    assert seqs == list(range(1, len(seqs) + 1))
    assert state["committed_through"] <= len(seqs) <= state["pushed_through"]
    for s, payload in got:
        if s <= state["committed_through"]:
            assert payload.startswith(b"payload-")
    rec.update(recovered=got, state=dict(state), disk=disk(fs), end=end(loop))
    return rec


@pytest.mark.parametrize("seed", range(8))
def test_diskqueue_prefix_durability(seed):
    twin(diskqueue_prefix, seed)


def kvstore_memory_recovers(P, seed):
    loop, net, fs = make_env(P, seed)
    proc = net.process("node")
    state, rec = {}, {}

    async def writer():
        kv = await P.fileio.KeyValueStoreMemory.open(fs, proc, "store.dq")
        committed = {}
        for round_ in range(6):
            for _ in range(loop.rng.random_int(1, 5)):
                k = b"k%d" % loop.rng.random_int(0, 20)
                if loop.rng.random01() < 0.25:
                    e = b"k%d" % loop.rng.random_int(0, 30)
                    b, e = min(k, e), max(k, e)
                    kv.clear_range(b, e)
                    for kk in [x for x in committed if b <= x < e]:
                        del committed[kk]
                else:
                    v = b"v%d-%d" % (round_, loop.rng.random_int(0, 1000))
                    kv.set(k, v)
                    committed[k] = v
            await kv.commit()
            rec[f"round {round_}"] = disk(fs)
        kv.set(b"uncommitted", b"x")
        state["committed"] = dict(committed)

    drive(loop, proc, writer())
    crash(fs, proc, rec, "crash")

    async def recover():
        kv = await P.fileio.KeyValueStoreMemory.open(fs, proc, "store.dq")
        state["recovered"] = dict(kv.read_range(b"", b"\xff"))
        rec["seq"] = kv._seq

    drive(loop, proc, recover())
    assert state["recovered"] == state["committed"]
    rec.update(state=state, end=end(loop))
    return rec


@pytest.mark.parametrize("seed", range(8))
def test_kvstore_memory_recovers_committed_state(seed):
    twin(kvstore_memory_recovers, seed)


def kvstore_snapshot(P):
    loop, net, fs = make_env(P, 3)
    proc = net.process("node")
    state = {}

    async def writer():
        kv = await P.fileio.KeyValueStoreMemory.open(fs, proc, "store.dq")
        kv.SNAPSHOT_EVERY_BYTES = 256
        for i in range(30):
            kv.set(b"key%02d" % (i % 7), b"val%d" % i)
            await kv.commit()
        state["popped"] = kv._q.popped_seq
        state["final"] = dict(kv.read_range(b"", b"\xff"))
        state["disk"] = disk(fs)

    drive(loop, proc, writer())
    assert state["popped"] > 0

    async def recover():
        kv = await P.fileio.KeyValueStoreMemory.open(fs, proc, "store.dq")
        state["recovered"] = dict(kv.read_range(b"", b"\xff"))

    drive(loop, proc, recover())
    assert state["recovered"] == state["final"]
    state["end"] = end(loop)
    return state


def test_kvstore_snapshot_compaction():
    twin(kvstore_snapshot)


def sync_survives(P):
    loop, net, fs = make_env(P, 5)
    proc = net.process("node")
    rec = {}

    async def writer():
        f = fs.open(proc, "raw.bin")
        await f.write(0, b"A" * 100)
        await f.sync()
        await f.write(100, b"B" * 100)

    drive(loop, proc, writer())
    crash(fs, proc, rec, "crash")

    async def reader():
        f = fs.open(proc, "raw.bin")
        return await f.read(0, 200)

    data = drive(loop, proc, reader())
    assert data[:100] == b"A" * 100
    rec.update(data=data, end=end(loop))
    return rec


def test_sync_makes_writes_survive_full_corruption():
    twin(sync_survives)


def concurrent_commits(P, seed):
    loop, net, fs = make_env(P, seed)
    proc = net.process("node")
    state, rec = {"acked": []}, {}

    async def run():
        q, got = await P.fileio.DiskQueue.open(fs, proc, "cq.dq")
        assert got == []

        async def committer(base):
            for i in range(6):
                seq = base + i
                q.push(seq, b"actor%d-%d" % (base, seq) * 3)
                await q.commit()
                state["acked"].append((seq, loop.now()))

        await P.el.all_of([proc.spawn(committer(b)) for b in (100, 200, 300)])

    drive(loop, proc, run())
    crash(fs, proc, rec, "crash")

    async def recover():
        _q, got = await P.fileio.DiskQueue.open(fs, proc, "cq.dq")
        state["recovered"] = got

    drive(loop, proc, recover())
    missing = {s for s, _t in state["acked"]} - {s for s, _ in state["recovered"]}
    assert not missing, f"acked records lost: {sorted(missing)}"
    rec.update(state=state, end=end(loop))
    return rec


@pytest.mark.parametrize("seed", range(4))
def test_diskqueue_concurrent_commits_serialize(seed):
    twin(concurrent_commits, seed)


KILL_MODES = ("NO_CORRUPTION", "DROP_ONLY", "FULL_CORRUPTION")


def unsynced_writes(P, mode, seed):
    """Writes of every size (zero-length among them) at scattered
    offsets, some synced, then the machine killed with the rest pending:
    the crash settles each by the kill mode's draws from the loop's rng."""
    loop, net, fs = make_env(P, seed, getattr(P.fileio.KillMode, mode))
    proc = net.process("node")
    rec = {}

    async def writer():
        f = fs.open(proc, "raw.bin")
        g = fs.open(proc, "other.bin")
        for i in range(24):
            n = loop.rng.random_int(0, 64)
            off = loop.rng.random_int(0, 512)
            await (f if i % 3 else g).write(off, bytes((i * 7 + j) % 256 for j in range(n)))
            if i in (5, 11):
                await f.sync()
        await f.truncate(400)
        await g.write(600, b"tail")

    drive(loop, proc, writer())
    crash(fs, proc, rec, "crash")

    async def reader():
        return [await fs.open(proc, name).read(0, 1 << 12) for name in ("raw.bin", "other.bin")]

    rec.update(read=drive(loop, proc, reader()), end=end(loop))
    return rec


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("mode", KILL_MODES)
def test_crash_settles_unsynced_writes(mode, seed):
    rec = twin(unsynced_writes, mode, seed)
    assert rec["crash before"][("node", "raw.bin")][1], "nothing was pending at the crash"


def crash_mid_commit(P, mode, seed):
    """Three actors commit a DiskQueue; the machine dies while a commit's
    frames are written but not synced; the recovered prefix, the disk
    and the loop's draws are compared."""
    loop, net, fs = make_env(P, seed, getattr(P.fileio.KillMode, mode))
    proc = net.process("node")
    state, rec = {"acked": []}, {}

    async def committer(q, base):
        for i in range(8):
            q.push(base + i, b"rec%d-" % (base + i) * (1 + i))
            await q.commit()
            state["acked"].append(base + i)

    async def start():
        q, _ = await P.fileio.DiskQueue.open(fs, proc, "mid.dq")
        return [proc.spawn(committer(q, b)) for b in (100, 200, 300)]

    drive(loop, proc, start())
    f = fs._files[("node", "mid.dq")]
    for _ in range(100_000):
        if len(f.pending) >= 3 or not loop.run_one():
            break
    crash(fs, proc, rec, "crash")

    async def recover():
        _q, got = await P.fileio.DiskQueue.open(fs, proc, "mid.dq")
        return got

    got = drive(loop, proc, recover())
    assert set(state["acked"]) <= {s for s, _ in got}
    rec.update(acked=state["acked"], recovered=got, end=end(loop))
    return rec


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("mode", ["DROP_ONLY", "FULL_CORRUPTION"])
def test_crash_mid_commit_keeps_the_acknowledged_prefix(mode, seed):
    rec = twin(crash_mid_commit, mode, seed)
    assert rec["crash before"][("node", "mid.dq")][1], "nothing was pending at the crash"


# ---------------------------------------------------------------------------
# tests/test_btree.py
# ---------------------------------------------------------------------------


def _rand_key(rng, space=400):
    return b"k%06d" % int(rng.random_int(0, space))


def btree_vs_model(P, seed):
    loop, net, fs = make_env(P, seed)
    proc = net.process("node")
    reads = []

    async def run():
        kv = await P.btree.BTreeKeyValueStore.open(fs, proc, "t.bt", page_size=1024,
                                                   cache_pages=8)
        model = {}
        rng = loop.rng
        for step in range(300):
            r = rng.random01()
            if r < 0.5:
                k, v = _rand_key(rng), b"v%d" % step * int(rng.random_int(1, 4))
                kv.set(k, v)
                model[k] = v
            elif r < 0.7:
                a = _rand_key(rng)
                b = a + b"\xff" if rng.random01() < 0.5 else _rand_key(rng)
                if a > b:
                    a, b = b, a
                kv.clear_range(a, b)
                for k in [k for k in model if a <= k < b]:
                    del model[k]
            elif r < 0.85:
                await kv.commit()
                reads.append(("commit", step, kv._gen, kv.file_pages(), disk(fs)))
            else:
                k = _rand_key(rng)
                assert kv.read_value(k) == model.get(k)
                a, b = sorted((_rand_key(rng), _rand_key(rng)))
                lim = int(rng.random_int(1, 20))
                want = sorted((k, v) for k, v in model.items() if a <= k < b)
                got = (kv.read_range(a, b), kv.read_range(a, b, limit=lim),
                       kv.read_range(a, b, limit=lim, reverse=True))
                assert got == (want, want[:lim], want[::-1][:lim])
                reads.append(("read", step, k, got))
        await kv.commit()
        assert kv.read_range(b"", b"\xff") == sorted(model.items())
        assert kv.count() == len(model)
        reads.append(("final", kv.count(), kv.leaked_pages, kv.file_pages(), sorted(kv._cache)))

    drive(loop, proc, run())
    return dict(reads=reads, disk=disk(fs), end=end(loop))


@pytest.mark.parametrize("seed", range(6))
def test_btree_differential_vs_model(seed):
    twin(btree_vs_model, seed)


def btree_crash(P, seed):
    loop, net, fs = make_env(P, seed)
    proc = net.process("node")
    state, rec = {}, {}

    async def writer():
        kv = await P.btree.BTreeKeyValueStore.open(fs, proc, "t.bt", page_size=1024)
        model, committed = {}, {}
        rng = loop.rng
        for round_ in range(int(rng.random_int(2, 6))):
            for _ in range(int(rng.random_int(1, 30))):
                if rng.random01() < 0.8:
                    k, v = _rand_key(rng, 100), b"r%d" % round_
                    kv.set(k, v)
                    model[k] = v
                else:
                    a, b = sorted((_rand_key(rng, 100), _rand_key(rng, 100)))
                    kv.clear_range(a, b)
                    for k in [k for k in model if a <= k < b]:
                        del model[k]
            await kv.commit()
            committed = dict(model)
            rec[f"round {round_}"] = disk(fs)
        kv.set(b"k999999", b"uncommitted")
        state["committed"] = committed

    drive(loop, proc, writer())
    crash(fs, proc, rec, "crash")

    async def recover():
        kv = await P.btree.BTreeKeyValueStore.open(fs, proc, "t.bt", page_size=1024)
        state["recovered"] = dict(kv.read_range(b"", b"\xff"))
        state["header"] = (kv._gen, kv._root, kv._npages, list(kv._free), kv._leaked,
                           kv._n_keys)

    drive(loop, proc, recover())
    assert state["recovered"] == state["committed"]
    rec.update(state=state, end=end(loop))
    return rec


@pytest.mark.parametrize("seed", range(8))
def test_btree_crash_recovery(seed):
    twin(btree_crash, seed)


def btree_big(P):
    loop, net, fs = make_env(P, 123)
    proc = net.process("node")
    rec = {}

    async def run():
        kv = await P.btree.BTreeKeyValueStore.open(fs, proc, "big.bt", page_size=1024,
                                                   cache_pages=4)
        n = 3000
        for i in range(0, n, 250):
            for j in range(i, min(n, i + 250)):
                kv.set(b"key%08d" % j, b"val%08d" % j)
            await kv.commit()
        assert len(kv._cache) <= 4
        assert kv.count() == n
        for j in range(0, n, 97):
            assert kv.read_value(b"key%08d" % j) == b"val%08d" % j
        assert kv.read_range(b"key00001000", b"key00001005") == [
            (b"key%08d" % j, b"val%08d" % j) for j in range(1000, 1005)]
        rec["filled"] = disk(fs)
        sizes = []
        for round_ in range(12):
            for j in range(0, 200):
                kv.set(b"key%08d" % j, b"upd%03d" % round_)
            await kv.commit()
            sizes.append(kv.file_pages())
        assert sizes[-1] == sizes[-4], f"file kept growing: {sizes}"
        rec["sizes"] = sizes
        rec["free"] = (list(kv._free), kv.leaked_pages, sorted(kv._cache))

    drive(loop, proc, run(), timeout_vt=5000.0)
    rec.update(disk=disk(fs), end=end(loop))
    return rec


def test_btree_exceeds_cache_and_reuses_pages():
    twin(btree_big)


def btree_oversized(P):
    loop, net, fs = make_env(P, 7)
    proc = net.process("node")
    rec = {}

    async def run():
        kv = await P.btree.BTreeKeyValueStore.open(fs, proc, "big2.bt", page_size=512,
                                                   cache_pages=4)
        big_key, big_val = b"K" * 3000, b"V" * 9000
        kv.set(big_key, big_val)
        kv.set(b"small", b"x")
        await kv.commit()
        assert kv.read_value(big_key) == big_val
        assert kv.read_value(b"small") == b"x"
        out = kv.read_range(b"", b"\xff")
        assert out == [(big_key, big_val), (b"small", b"x")]
        rec["pages"] = kv.file_pages()

    drive(loop, proc, run())
    rec.update(disk=disk(fs), end=end(loop))
    return rec


def test_btree_oversized_keys_and_values():
    twin(btree_oversized)


# ---------------------------------------------------------------------------
# tests/test_kvstore_differential.py
# ---------------------------------------------------------------------------


def _key(rng, space):
    return b"k%05d" % int(rng.random_int(0, space))


def engine_differential(P, engine, seed):
    loop = P.el.EventLoop(seed=seed * 100 + (zlib.crc32(engine.encode()) % 7))
    P.el.set_event_loop(loop)
    net = P.rpc.SimNetwork(loop)
    fs = P.fileio.SimFileSystem(net)
    proc = net.process("kvhost", machine_id="kvhost")
    driver = net.process("driver", machine_id="driver")
    rng = loop.rng
    space = 200
    rec = {"reads": []}

    async def run():
        model, committed = {}, {}
        kv = await P.kvstore.open_engine(engine, fs, proc, "store")
        for round_no in range(6):
            for _ in range(120):
                op = int(rng.random_int(0, 10))
                if op < 6:
                    k = _key(rng, space)
                    v = b"v%d" % int(rng.random_int(0, 1 << 20))
                    kv.set(k, v)
                    model[k] = v
                elif op < 8:
                    a = _key(rng, space)
                    b = a + b"\x00" * 2 + b"9"
                    a, b = min(a, b), max(a, b)
                    kv.clear_range(a, b)
                    for kk in [x for x in model if a <= x < b]:
                        del model[kk]
                else:
                    k = _key(rng, space)
                    got = kv.read_value(k)
                    assert got == model.get(k)
                    rec["reads"].append((k, got))
            await kv.commit()
            committed.clear()
            committed.update(model)
            for _ in range(5):
                a, b = sorted([_key(rng, space), _key(rng, space)])
                got = kv.read_range(a, b, limit=1 << 20)
                assert got == sorted((k, v) for k, v in committed.items() if a <= k < b)
                rec["reads"].append((a, b, got))
            rec[f"round {round_no}"] = disk(fs)
            if round_no % 2 == 1:
                for _ in range(20):
                    k = _key(rng, space)
                    kv.set(k, b"UNCOMMITTED")
                    model[k] = b"UNCOMMITTED"
                crash(fs, proc, rec, f"crash {round_no}")
                kv = await P.kvstore.open_engine(engine, fs, proc, "store")
                model.clear()
                model.update(committed)
                got = kv.read_range(b"", b"\xff", limit=1 << 20)
                assert got == sorted(committed.items()), f"diverged after crash {round_no}"
                rec[f"recovered {round_no}"] = got
        rec["done"] = True

    loop.run_until(driver.spawn(run(), "kvtest"), timeout_vt=50000.0)
    assert rec.get("done")
    rec["end"] = end(loop)
    return rec


@pytest.mark.parametrize("engine", ["memory", "btree", "memory+compress", "btree+compress"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_engine_random_differential_with_crashes(engine, seed):
    twin(engine_differential, engine, seed)
