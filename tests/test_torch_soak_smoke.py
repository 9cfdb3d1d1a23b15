"""chip_smoke's phase 4z on the CPU: the acceptance soak through the port.

chip_smoke's ``soak_path`` at phase 4z's config (tests/test_soak.py:336's
soak: ``default_config(minutes=SOAK_MINUTES, peak_tps=80, seed=1,
cluster="dynamic", keys=512, zipf_theta=0.9, faults=True)`` with its SLO,
the full fault matrix: tlog0 killed with its machine held down, a
one-directional tlog -> storage clog, a dispatch outage on the current
resolver's set) through the port's ``run_soak`` on the CPU: every
recruited resolver's set a ``ConflictSet(device="cpu", key_words=16,
max_device_key_bytes=64, h_cap=16,384)`` at depth 2, the first one's
mirror a small key_words=2 state re-encoded at 16 words (the card's is
phase 4's warm-up state), the kernels' plain twins counted as launches.
Phase 4z's checks hold (the test's SLO, floors, fault kinds, throttling
in every window and release after; every breaker walk legal and ending
ok; every resolve batch replayed equal on a host CpuConflictSet; every
batch outside the outage's window a card dispatch, every one inside it
served on the mirror; one launch of each kernel a card batch;
mirror_check ok; a second same-seed run's transition logs byte-identical;
``cli soak`` at the test's tiny shape), and the counts are the ones
PERF.md predicts for the card: the run is the same virtual history there.
"""

from __future__ import annotations

import functools
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch as real_torch

from foundationdb_tpu_torch.conflict import api
from foundationdb_tpu_torch.conflict import engine_torch as et
from foundationdb_tpu_torch.conflict import kernels as tk
from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as T
from foundationdb_tpu_torch.flow import eventloop as el
from foundationdb_tpu_torch.tools import cli
from foundationdb_tpu_torch.workloads import soak

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)

# PERF.md's prediction for phase 4z on the card: resolve batches a
# generation (epoch, card, mirror), each phase's (committed, arrivals), the
# totals and the fault timeline's kinds and targets.
PER_GEN = [(1, 212, 0), (2, 336, 64)]
PHASES = [("warm", 54, 54), ("ramp", 145, 145), ("peak", 598, 601), ("cooldown", 72, 72)]
TOTALS = dict(arrivals=872, client_shed=0, attempts=1148, committed=869, conflicted=160,
              too_old=0, throttled=0, other_errors=119, failed=0, exhausted=3)
FAULTS = [("kill", "tlog0"), ("clog", "worker0->worker4"), ("device_outage", "worker1")]


@pytest.fixture(autouse=True)
def _clean_loop():
    threads = real_torch.get_num_threads()
    real_torch.set_num_threads(1)
    yield
    real_torch.set_num_threads(threads)
    el.set_event_loop(None)


def warm_snapshot():
    """A small key_words=2 state standing for phase 4's warm-up state."""
    cs = api.ConflictSet(device="cpu", key_words=2, h_cap=1 << 12)
    rng = np.random.default_rng(1)
    for i in range(6):
        cs._detect(SMOKE.gen_txns(T, rng, 256, i, keyspace=100_000), i + 4, i)
    return cs._cpu.snapshot()


def test_phase_4z_soak_and_checks_hold_on_the_cpu(monkeypatch):
    def counted(name, fn):
        @functools.wraps(fn)
        def launch(*a, **kw):
            tk.LAUNCHES[name] += 1
            return fn(*a, **kw)
        return launch

    # The plain twins stand in for the kernels: each call counts as a
    # launch (the engine's own bindings).
    monkeypatch.setattr(et, "phase1_search", counted("phase1_ranks", et.phase1_search))
    monkeypatch.setattr(et, "fused_merge_evict", counted("fused_merge_evict",
                                                         et.fused_merge_evict))
    torch = types.SimpleNamespace(cuda=types.SimpleNamespace(get_device_name=lambda _i: "cpu"))
    saved = dict(tk.LAUNCHES)
    try:
        out = SMOKE.soak_path(torch, soak, cli, tk, {"warm_snapshot": warm_snapshot()}, {},
                              device="cpu", h_cap=1 << 14, replay=True)
    finally:
        tk.LAUNCHES.update(saved)
    assert out["per_gen"] == PER_GEN
    n = sum(c for _e, c, _m in PER_GEN)
    assert (out["batches"], out["mirror"]) == (n, 64) == (548, 64)
    assert out["launches"] == {"phase1_ranks": n, "fused_merge_evict": n}
    assert out["phases"] == PHASES
    assert {k: out["totals"][k] for k in TOTALS} == TOTALS
    assert [(k, d) for _t0, k, d, _t1 in out["faults"]] == FAULTS
    w0, w1, w_ok = out["window"]
    assert w0 < w1 < w_ok
    assert out["rehydrated"][0] > 0
    assert out["cli"]["committed"] == 90
