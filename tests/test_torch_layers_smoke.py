"""chip_smoke's phase 4y on the CPU: the layers through the client.

chip_smoke's ``layers_path`` at phase 4y's shape (LAYERS_SHAPE: a
directory tree and 64 HCA allocations, 256 actors x 2 pushes onto one
Queue popped in order, 4n's 4,096-node ring and 16,384 tuple-packed rows
under a continuous backup while 1,024 Cycle actors x 2 ops run, the
point-in-time restore and AtomicRestoreWorkload, the rows through a
localhost blob store, DR into a second cluster under 256 Cycle actors x 2
ops and the switchover) through the port's ``SimCluster(n_proxies=2,
n_tlogs=2, buggify=False)`` and its DR destination, each over a
``ConflictSet(device="cpu", key_words=4)`` with a small history, the
kernels' plain twins counted as launches.  Phase 4y's checks hold (every
resolve request of both sets replayed equal on a host CpuConflictSet, one
launch of each kernel a batch, the long-key side table exactly where the
replay says and never host-served, no pushes not committed, the restores
byte-equal, the destination equal to the source at the switchover,
mirror_check ok), and the counts are the ones PERF.md predicts for the
card: the run is the same virtual history there.
"""

from __future__ import annotations

import functools
import importlib.util
import pathlib
import types

import pytest
import torch as real_torch

from foundationdb_tpu_torch.conflict import api
from foundationdb_tpu_torch.conflict import engine_cpu as ecpu
from foundationdb_tpu_torch.conflict import engine_torch as et
from foundationdb_tpu_torch.conflict import kernels as tk
from foundationdb_tpu_torch.flow import eventloop as el
from foundationdb_tpu_torch.flow import flight_recorder as fr
from foundationdb_tpu_torch.flow import spans
from foundationdb_tpu_torch.flow import trace

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)

# PERF.md's prediction for phase 4y on the card: each step's
# commits, not_committed, retries, resolve batches by set and long-key
# side-table batches by set.
STEPS = {
    "1 directory": dict(commits=67, not_committed=22, retries=22, batches=[10], side=[0]),
    "1 queue push": dict(commits=512, not_committed=0, retries=0, batches=[6], side=[0]),
    "1 queue pop": dict(commits=33, not_committed=0, retries=0, batches=[32], side=[0]),
    "2 backup": dict(commits=2129, not_committed=1408, retries=1408, batches=[55], side=[0]),
    "2 restore": dict(commits=41, not_committed=0, retries=4, batches=[38], side=[0]),
    "3 blob": dict(commits=92, not_committed=0, retries=0, batches=[70], side=[35]),
    "4 dr": dict(commits=571, not_committed=100, retries=100, batches=[27, 49], side=[0, 0]),
}


@pytest.fixture(autouse=True)
def _clean_loop():
    # The script's tensors are small: one intra-op thread runs it in about
    # a quarter of the CPU time that a thread per core takes, and keeps it
    # well inside the per-test limit when other test processes share the
    # cores.
    threads = real_torch.get_num_threads()
    real_torch.set_num_threads(1)
    yield
    real_torch.set_num_threads(threads)
    el.set_event_loop(None)


def run_4y(monkeypatch):
    """Phase 4y's path on the CPU; returns its totals and record."""

    def counted(name, fn):
        @functools.wraps(fn)
        def launch(*a, **kw):
            tk.LAUNCHES[name] += 1
            return fn(*a, **kw)
        return launch

    # The plain twins stand in for the kernels: count each call as a launch
    # (the engine's own bindings).
    monkeypatch.setattr(et, "phase1_search", counted("phase1_ranks", et.phase1_search))
    monkeypatch.setattr(et, "fused_merge_evict", counted("fused_merge_evict",
                                                         et.fused_merge_evict))
    monkeypatch.setattr(SMOKE, "H_CAP", 1 << 14)
    cpu_api = types.SimpleNamespace(ConflictSet=functools.partial(api.ConflictSet, device="cpu"))
    torch = types.SimpleNamespace(cuda=types.SimpleNamespace(get_device_name=lambda _i: "cpu"))
    saved = dict(tk.LAUNCHES)
    hubs = SMOKE.PortHubs(spans, trace, fr)
    try:
        return SMOKE.layers_path(torch, cpu_api, ecpu, tk, spans, trace, fr, {"tps": 1.0},
                                 {"off": 1.0, "on": 1.0})
    finally:
        hubs.restore()
        tk.LAUNCHES.update(saved)


def test_phase_4y_script_and_checks_hold_on_the_cpu(monkeypatch):
    tot = run_4y(monkeypatch)
    assert tot["steps"] == STEPS
    n = sum(sum(s["batches"]) for s in STEPS.values())
    assert tot["batches"] == n == 287
    assert tot["launches"] == {"phase1_ranks": n, "fused_merge_evict": n}
    rec = tot["record"]
    assert rec["directory"]["lists"] == [["app", "archive", "logs"], ["users"], ["orders"]]
    assert len(rec["directory"]["hca"]) == 64 and rec["queue"]["popped"] == 512
    bk = rec["backup"]
    assert (bk["chunks"], bk["files"], bk["image"][0]) == (8, 10, 20514)
    assert bk["snapshot"] < bk["mark1"] < bk["target"] < bk["mark2"]
    assert (rec["restore"]["rows"], rec["restore"]["atomic_locked_seen"]) == (20514, 28)
    assert (rec["blob"]["pages"], rec["blob"]["rows"]) == (17, 16384)
    assert (rec["dr"]["rows"], rec["dr"]["samples"]) == (20575, 2)
    assert rec["dr"]["applied"] > rec["dr"]["snapshot"]
