"""The reference's server roles serving through the port's ConflictSet.

``Resolver`` and ``SimCluster`` are the reference package's, unchanged;
only the conflict set handed to them is the port's
``ConflictSet(device="cpu")``:

- the seeded three-client workload of tests/test_e2e.py:330 at pipeline
  depth 1 gives the same commit/abort history and final range as the CPU
  backend;
- the resolver rig of tests/test_resolver_pipeline.py:281-345 gives one
  reply verdict stream and one exported state at depths 1, 2 and 3 (the
  pipelined resolve path at depths 2 and 3);
- WriteDuringRead at the default depth commits with no mismatch.

Small shapes (h_cap 1<<10, key_words 3 or 4) keep each case short.
"""

import pytest

from foundationdb_tpu.conflict.engine_cpu import CpuConflictSet as RefCpu
from foundationdb_tpu.flow import set_event_loop
from foundationdb_tpu.flow.error import FdbError
from foundationdb_tpu.server import SimCluster
from foundationdb_tpu.workloads import WriteDuringReadWorkload, run_workloads
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.engine_cpu_flat import FlatCpuConflictSet

from test_torch_api import _random_stream


@pytest.fixture(autouse=True)
def _clean_loop():
    yield
    set_event_loop(None)


def _port_set(depth, **kw):
    kw.setdefault("key_words", 4)
    return ConflictSet(device="cpu", h_cap=1 << 10, pipeline_depth=depth, **kw)


def test_e2e_history_matches_the_cpu_backend():
    """tests/test_e2e.py:330's workload: the commit/abort history and the
    final range equal the reference CPU backend's, seed 99, depth 1."""

    def run(**cluster_kw):
        c = SimCluster(seed=99, **cluster_kw)
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
                    except FdbError as e:
                        history.append((i, j, e.name))

            return go()

        c.run_all([(db, w(db, i)) for i, db in enumerate(dbs)], timeout_vt=5000.0)
        out = {}

        async def check(tr):
            out["all"] = await tr.get_range(b"d/", b"d0")

        c.run_all([(dbs[0], dbs[0].run(check))])
        return history, out["all"], c

    h_cpu, s_cpu, _ = run(conflict_backend="cpu")
    port_cs = _port_set(1)
    h_port, s_port, c = run(conflict_set=port_cs)
    assert h_port == h_cpu
    assert s_port == s_cpu
    assert c.resolver.conflicts is port_cs
    assert port_cs._dev.batches > 0
    assert any(r != "ok" for _i, _j, r in h_port)  # contention happened


def _resolver_rig(seed, depth):
    """EventLoop + SimNetwork + the reference's Resolver around the port's
    ConflictSet + a client process."""
    from foundationdb_tpu.flow.eventloop import EventLoop
    from foundationdb_tpu.rpc.network import SimNetwork
    from foundationdb_tpu.server.resolver import Resolver

    loop = EventLoop(seed)
    set_event_loop(loop)
    net = SimNetwork(loop)
    cs = _port_set(depth, key_words=3, bucket_mins=(32, 128, 64))
    r = Resolver(net.process("resolver"), conflict_set=cs)
    return loop, r, net.process("client")


def _drive_resolver(loop, resolver, dproc, stream, cadence=0.002):
    """Send the batch stream at a fixed virtual cadence without awaiting
    each reply; returns the ordered reply verdict lists."""
    from foundationdb_tpu.server.interfaces import ResolveTransactionBatchRequest

    iface = resolver.interface()

    async def drive():
        prev = 0
        futs = []
        for txns, now, _nov in stream:
            futs.append(iface.resolve.get_reply(
                dproc,
                ResolveTransactionBatchRequest(
                    prev_version=prev, version=now, last_received_version=prev,
                    transactions=txns, proxy_id="p0",
                ),
            ))
            prev = now
            await loop.delay(cadence)
        return [(await f).committed for f in futs]

    return loop.run_until(dproc.spawn(drive(), "drive"), timeout_vt=600.0)


def _exported_state(cs):
    export = FlatCpuConflictSet()
    cs._dev.store_to(export)
    return ((list(cs._cpu.keys), list(cs._cpu.vers), cs._cpu.oldest_version),
            (export.keys, export.vers, export.oldest_version))


def test_resolver_verdict_streams_identical_across_depths():
    stream = _random_stream(5, 60, 14, 8)
    results, states = {}, {}
    for depth in (1, 2, 3):
        loop, r, dproc = _resolver_rig(5, depth)
        assert r._pipeline_on == (depth > 1)
        results[depth] = _drive_resolver(loop, r, dproc, stream)
        states[depth] = _exported_state(r.conflicts)
        dm = r.conflicts.device_metrics()
        assert dm["counters"]["pipeline_dispatches"] == (len(stream) if depth > 1 else 0)
        assert dm["pipeline"]["inflight"] == 0
        set_event_loop(None)
    assert results[2] == results[1] and results[3] == results[1]
    assert states[2] == states[1] and states[3] == states[1]
    mirror, device = states[1]
    assert mirror == device
    # The resolver's window is the server knob's, not the stream's; the
    # verdicts still equal a CPU engine fed the same versions.
    from foundationdb_tpu.flow.knobs import g_knobs

    window = g_knobs.server.max_write_transaction_life_versions
    cpu = RefCpu()
    assert results[1] == [cpu.detect(t, n, n - window) for t, n, _v in stream]


def test_write_during_read_commits_without_mismatch():
    port_cs = _port_set(2)
    c = SimCluster(seed=7001, n_proxies=2, n_storages=2, conflict_set=port_cs)
    wl = WriteDuringReadWorkload(nodes=30, txns=10)
    run_workloads(c, [wl], timeout_vt=30000.0)
    assert wl.committed_txns > 0
    assert not wl.mismatches
    dm = port_cs.device_metrics()
    assert dm["counters"]["device_faults"] == 0
    assert dm["counters"]["batches"] > 0
