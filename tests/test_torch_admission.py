"""chip_smoke's phase 4b on the CPU: admission control and data
distribution under commit traffic.

chip_smoke's ``admission_script`` at phase 4b's shape (4n's 4,096-node
ring, ADMIT_CLIENTS clients x ADMIT_OPS Cycle ops beside
RandomMoveKeysWorkload and a DD role, a held dispatch outage) through the
port's ``SimCluster(n_proxies=2, n_tlogs=2, n_storages=3, buggify=False)``,
resolver 0 over a ``ConflictSet(device="cpu")`` at phase 4's key width
(key_words=2) with a small history, and the Ratekeeper at ADMIT_MAX_TPS.
Phase 4b's checks hold (``admission_checks``: the ring, every
acknowledged write on every storage of its shard's team, the rate ok /
at most the degraded cap / ok, the transitions, the read versions within
each rate's budget and some at the degraded one, a move and a split; and
``admission_replay_checks``: every resolve request replayed equal on a
host CpuConflictSet, each submitted batch one request, the card
dispatches counted, the long-key side table's batches equal to the
replay's, the breaker's one open and close).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import pytest

from foundationdb_tpu_torch.client.types import CommitTransactionRef
from foundationdb_tpu_torch.conflict import kernels as tk
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector
from foundationdb_tpu_torch.conflict.engine_cpu import CpuConflictSet
from foundationdb_tpu_torch.flow import eventloop as el
from foundationdb_tpu_torch.flow import flight_recorder as fr
from foundationdb_tpu_torch.flow import spans
from foundationdb_tpu_torch.flow import trace
from foundationdb_tpu_torch.server import interfaces as itf
from foundationdb_tpu_torch.server.cluster import SimCluster

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)


@pytest.fixture(autouse=True)
def _clean_loop():
    yield
    el.set_event_loop(None)


def run_4b():
    """Phase 4b's script and checks on the CPU; returns the record, the
    replay checks' results and the ring's rows."""
    hubs = SMOKE.PortHubs(spans, trace, fr)
    inj = DeviceFaultInjector()
    cs = ConflictSet(device="cpu", key_words=SMOKE.KEY_WORDS, h_cap=1 << 14, pipeline_depth=2,
                     fault_injector=inj)
    shape = dict(nodes=SMOKE.CLIENT_NODES, load_txns=SMOKE.CLIENT_LOAD_TXNS,
                 clients=SMOKE.ADMIT_CLIENTS, ops=SMOKE.ADMIT_OPS, moves=SMOKE.ADMIT_MOVES,
                 outage=SMOKE.ADMIT_OUTAGE)
    sub = None
    try:
        c = SimCluster(seed=SMOKE.ADMIT_SEED, conflict_set=cs, n_proxies=2, n_tlogs=2,
                       n_storages=3, buggify=False, device="cpu")
        c.net.deep_copy = False
        resolves = []
        for p in c.proxies:
            p.resolvers = [dataclasses.replace(r, resolve=SMOKE.Recorded(r.resolve, resolves))
                           for r in p.resolvers]
        client = c.net.process("client")
        c.loop.run_until(c.loop.delay(0.001), timeout_vt=60.0)
        c.loop.run_until(c.proxy.interface().commit.get_reply(
            client, itf.CommitTransactionRequest(transaction=CommitTransactionRef())),
            timeout_vt=60.0)
        n_first = len(resolves)
        counters0 = dict(cs.device_metrics()["counters"])
        sub = SMOKE.SubmitLaunches(cs, tk)
        rec = SMOKE.admission_script(c, cs, inj, shape)
        cs.pipeline_drain()
    finally:
        if sub is not None:
            sub.remove()
        hubs.restore()
        el.set_event_loop(None)
    checked = SMOKE.admission_checks("4b on the cpu", rec, c, SMOKE.ADMIT_MAX_TPS,
                                     edge=SMOKE.ADMIT_CLIENTS)
    replayed = SMOKE.admission_replay_checks(
        "4b on the cpu", c, cs, CpuConflictSet(key_words=SMOKE.KEY_WORDS), resolves, n_first,
        counters0, sub.turns, inj)
    return rec, checked, replayed


def test_phase_4b_script_and_checks_hold_on_the_cpu():
    rec, checked, (served, long_, side, moved, device) = run_4b()
    # The breaker's one outage: served by the mirror while open, by the
    # set's device engine otherwise; the side table took the DD's batches.
    assert 0 < moved["degraded_batches"] and 0 < device < len(served)
    assert side >= long_ > 0 and moved["rehydrates"] >= 1
    counts = rec["counts"]
    assert counts[("commit", "ok")] >= SMOKE.ADMIT_CLIENTS * SMOKE.ADMIT_OPS
    # The degraded cap bound the arm: each proxy spent at it for longer
    # than its 0.1 s rate fetch and released nearly all the budget allowed
    # (admission_checks holds it to at most that budget).
    for sp in checked["spans"]:
        (open_tps, _a0, _b0, _k0), (tps, a1, b1, k1) = sp[:2]
        assert open_tps == SMOKE.ADMIT_MAX_TPS and tps == 0.25 * open_tps and b1 - a1 > 0.1
        assert k1 >= 0.8 * tps * (b1 - a1)
    assert rec["performed"] == SMOKE.ADMIT_MOVES
