"""The acceptance matrix through the port, held to the reference's.

Twins of tests/test_acceptance_matrix.py's configs 2-4 (BASELINE.json):
WriteDuringRead at high contention (config 2), RandomReadWrite at low
contention (config 3) and Cycle over four resolvers (config 4), each at
the reference test's seed and shape, through the port's ``run_workloads``
on the port's SimCluster and through the reference's on the reference's.
The records are tests/test_torch_workloads.py's (every read, commit and
retry, each client's state, each workload's attributes after the run,
the roles' registries, the loop's end) plus the final state under the
workload's prefix, in two arms: each package's host engine ("cpu"), and
every resolver over a port ConflictSet(device="cpu") at key_words=4
pipelined at depth 1 ("set").  Then the reference's acceptance bar
itself on the port: the host engine and the port's set at depth 1 give
the same history, commits, conflicts and final state; and the sharded
set (ShardedTorchConflictSet, two shards split inside the workload's
keys) gives the host engine's history.
"""

from __future__ import annotations

import importlib.util
import pathlib

import pytest

from foundationdb_tpu_torch.parallel.sharded_resolver import ShardedTorchConflictSet

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_workload_twins", _here / "test_torch_workloads.py")
WL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(WL)
_restore_globals = WL._restore_globals

TIMEOUT = 30000.0  # the reference tests' run_workloads timeout (virtual s)
WDR_PREFIX = b"\x02wdr/"


def wdr(wl):
    # contention_actors: write-conflict-only contenders give the history
    # real abort decisions while the memory model stays byte-exact.
    return [wl.WriteDuringReadWorkload(nodes=25, txns=10, contention_actors=3)]


def rrw(wl):
    return [wl.RandomReadWriteWorkload(nodes=120, actors=3, txns_per_actor=6)]


def cycle(wl):
    return [wl.CycleWorkload(nodes=8, ops=12, actors=3)]


CONFIGS = {
    # config: (workloads, seed, prefix, cluster kwargs)
    "wdr": (wdr, 9001, WDR_PREFIX, dict(n_proxies=2)),
    "rrw": (rrw, 9002, b"rrw/", dict(n_proxies=2)),
    "cycle": (cycle, 9003, b"cycle/", dict(n_proxies=2, n_resolvers=4)),
}


def config_pair(config, arm):
    make, seed, prefix, kw = CONFIGS[config]
    return WL.pair(arm, make, seed, depth=1, timeout_vt=TIMEOUT, prefixes=(prefix,), **kw)


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_write_during_read_matches_the_reference(arm):
    """Config 2: every read, commit and conflict equal to the reference's;
    the memory model byte-exact, and the contention real."""
    rec, loads, _c = config_pair("wdr", arm)
    w = loads[0]
    assert not w.mismatches and w.success
    assert w.committed_txns > 0 and w.conflicts > 0, w.history
    assert rec["state"][0]


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_random_read_write_matches_the_reference(arm):
    """Config 3: uniform keys, low contention."""
    rec, loads, _c = config_pair("rrw", arm)
    assert loads[0].committed == 18
    assert rec["state"][0]


@pytest.mark.parametrize("arm", ["cpu", "set"])
def test_cycle_multi_resolver_matches_the_reference(arm):
    """Config 4: four resolvers, the ring one cycle."""
    rec, _loads, c = config_pair("cycle", arm)
    assert len(c.resolvers) == 4
    assert len(rec["state"][0]) == 8


def outcome(config, arm):
    make, seed, prefix, kw = CONFIGS[config]
    rec, loads, _c = WL.run("port", arm, make, seed, depth=1, timeout_vt=TIMEOUT,
                            prefixes=(prefix,), **kw)
    return rec, loads[0]


@pytest.mark.parametrize("config", ["wdr", "rrw", "cycle"])
def test_host_engine_and_set_agree_at_depth_1(config):
    """The reference's acceptance bar on the port: swapping only the
    conflict backend (the host engine for a ConflictSet(device="cpu") at
    depth 1) gives the same per-transaction history, commits, conflicts,
    mismatch-free model and final state, and the same client events."""
    cpu, w_cpu = outcome(config, "cpu")
    dev, w_dev = outcome(config, "set")
    assert dev["events"] == cpu["events"]
    assert dev["workloads"] == cpu["workloads"]
    assert dev["state"] == cpu["state"]
    if config == "wdr":
        assert not w_cpu.mismatches and not w_dev.mismatches
        assert w_cpu.history == w_dev.history
        assert w_cpu.committed_txns == w_dev.committed_txns > 0
        assert w_cpu.conflicts == w_dev.conflicts > 0, w_cpu.history


def test_write_during_read_differential_cpu_vs_sharded():
    """The sharded set reproduces the host engine's exact per-transaction
    history on config 2 at the reference test's seed: the min-combine of
    per-shard clipped verdicts is global detection.  Both shards hold
    history (the split sits in the middle of the workload's keys)."""
    make, _seed, prefix, kw = CONFIGS["wdr"]
    sets = []

    def sharded():
        sets.append(ShardedTorchConflictSet([prefix + b"000012"], key_words=4, h_cap=1 << 12,
                                            device="cpu"))
        return sets[-1]

    cpu, w_cpu = WL.run("port", "cpu", make, 9003, timeout_vt=TIMEOUT, prefixes=(prefix,),
                        **kw)[:2]
    sh, w_sh, _c = WL.pair("cpu", make, 9003, timeout_vt=TIMEOUT, prefixes=(prefix,),
                           conflict_set=sharded, **kw)
    w_cpu, w_sh = w_cpu[0], w_sh[0]
    assert not w_cpu.mismatches and not w_sh.mismatches
    assert w_cpu.history == w_sh.history
    assert w_cpu.committed_txns == w_sh.committed_txns > 0
    assert w_cpu.conflicts == w_sh.conflicts > 0
    assert cpu["state"] == sh["state"]
    cs = sets[-1]
    assert cs.boundary_count > 0
    per_shard = [int(n) for n in cs._hcount.tolist()]
    assert all(n > 1 for n in per_shard), f"a shard stayed empty: {per_shard}"
