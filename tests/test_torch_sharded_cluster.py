"""The port's sharded set serving a real cluster, and its long-key probe,
held to the reference's on the CPU.

Twin of tests/test_sharded_resolver.py:228-302
(``test_sharded_set_serves_a_real_cluster``), at that test's shape: a
``ShardedTorchConflictSet(device="cpu")`` split at ``[b"d", b"j", b"q"]``
(4 shards), ``key_words=8``, ``h_cap=1<<12``, ``bucket_mins=(64, 128,
128)`` as resolver 0 of the port's ``SimCluster(seed=777, n_proxies=2,
n_storages=2)``: a Cycle ring on short keys (the device path carries the
cluster), one write of a 48-byte key (past the 16-byte device width:
every batch holding it pins the shards' history to their mirrors), then
Increment and the consistency check.  Every batch the port's set decides
is recorded and replayed, in order, through the reference's
``ShardedJaxConflictSet`` on four of conftest.py's virtual CPU devices:
verdicts equal batch for batch, and the reference's testprobe counts
``sharded_long_key_fallback`` exactly as often as the port's (the fault
filed as F10: the port's set counted its pins and fired no probe).
"""

from __future__ import annotations

import pytest

from foundationdb_tpu_torch.flow import set_event_loop
from foundationdb_tpu_torch.flow import testprobe as port_probe
from foundationdb_tpu_torch.parallel.sharded_resolver import ShardedTorchConflictSet

SPLIT = [b"d", b"j", b"q"]
SHAPE = dict(key_words=8, h_cap=1 << 12, bucket_mins=(64, 128, 128))
PROBE = "sharded_long_key_fallback"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the simulated clusters' tensors are small, and
    a thread per core costs several times the CPU when test processes
    share the cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_cluster_batches():
    """The test's scenario through the port's cluster; returns the batches
    the set decided [(txns, now, new_oldest_version, verdicts)], the
    probe's hits and the device path's dispatches."""
    from foundationdb_tpu_torch.server import SimCluster
    from foundationdb_tpu_torch.workloads import (
        ConsistencyChecker,
        CycleWorkload,
        IncrementWorkload,
        run_workloads,
    )

    before = port_probe.hit_sites.get(PROBE, 0)
    cs = ShardedTorchConflictSet(SPLIT, device="cpu", **SHAPE)
    batches, calls = [], {"n": 0}
    detect, packed = cs.detect, cs.detect_packed

    def logged(txns, now, new_oldest_version):
        out = detect(txns, now, new_oldest_version)
        batches.append((txns, now, new_oldest_version, list(out)))
        return out

    def counting(pb, now, new_oldest_version):
        calls["n"] += 1
        return packed(pb, now, new_oldest_version)

    cs.detect, cs.detect_packed = logged, counting
    try:
        c = SimCluster(seed=777, n_proxies=2, n_storages=2, conflict_set=cs)
        run_workloads(c, [CycleWorkload(nodes=5, ops=10, actors=2)], timeout_vt=60000.0)
        assert calls["n"] > 0, "device path never dispatched"
        db = c.database("longkey")

        async def long_write(tr):
            tr.set(b"longkey/" + b"x" * 40, b"v")

        c.run_until(db.process.spawn(db.run(long_write), "lw"), timeout_vt=600.0)
        run_workloads(c, [IncrementWorkload(counters=3, actors=2, ops=8), ConsistencyChecker()],
                      timeout_vt=60000.0, quiet=True)
    finally:
        set_event_loop(None)
    return batches, port_probe.hit_sites.get(PROBE, 0) - before, calls["n"]


def test_sharded_set_serves_a_real_cluster_and_probes_its_long_keys():
    import jax

    from foundationdb_tpu.flow import testprobe as ref_probe
    from foundationdb_tpu.parallel.sharded_resolver import ShardedJaxConflictSet

    batches, port_hits, dispatches = _port_cluster_batches()
    assert port_hits > 0 and dispatches > 0
    ref = ShardedJaxConflictSet(SPLIT, devices=jax.devices()[:4], **SHAPE)
    before = ref_probe.hit_sites.get(PROBE, 0)
    for i, (txns, now, nov, verdicts) in enumerate(batches):
        assert [int(s) for s in ref.detect(txns, now, nov)] == verdicts, i
    assert ref_probe.hit_sites.get(PROBE, 0) - before == port_hits
    long_batches = sum(
        any(len(b) > 16 for t in txns for rng in (t.read_ranges, t.write_ranges)
            for pair in rng for b in pair)
        for txns, _n, _o, _v in batches)
    assert port_hits == long_batches > 0
