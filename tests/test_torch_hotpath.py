"""The port's hot-path discipline (foundationdb_tpu_torch/flow/hotpath.py)
and its transfer guard, against the reference's.

Twins of tests/test_hotpath.py on the port: ``@hot_path`` registers and
checks its bound (:108); the port's registry covers every site of the
reference's ``conflict/`` and ``parallel/`` modules with the same bound,
through a name map, less the sites listed with their reasons (:122);
``GuardedDeviceValue`` raises on every implicit host read outside a
sanctioned scope (:151) and delegates inside one, reentrantly (:169), on
torch tensors, and never hands numpy a CUDA tensor; a planted read of a
parked ticket raises TransferGuardError while the sanctioned path still
completes the batch (:216); a guarded run equals the unguarded one (:236).

Then the differential: the port's ``ConflictSet(transfer_guard=True)``
against the reference under FDB_TPU_TRANSFER_GUARD=1 at depths 1-3
(verdicts, witnesses and exported state), a batch whose fixpoint runs more
rounds than FIXPOINT_FIRST_CHUNK under the guard, and the arming logic of
the CUDA sync debug mode, driven on the CPU with torch.cuda's mode
functions replaced by a recorder.

Shapes: key_words=3, bucket_mins=(32, 128, 64), h_cap=1<<10.  All
integers; the tolerance is zero.
"""

import inspect

import numpy as np
import pytest
import torch

import foundationdb_tpu.conflict.engine_jax  # noqa: F401  (registers the reference's sites)
import foundationdb_tpu.parallel.sharded_resolver  # noqa: F401
import foundationdb_tpu.server.resolver  # noqa: F401
import foundationdb_tpu_torch.conflict.api as port_api
import foundationdb_tpu_torch.parallel.sharded_resolver  # noqa: F401
from foundationdb_tpu.conflict.device_faults import DeviceFaultInjector as RefInjector
from foundationdb_tpu.conflict.engine_cpu import CpuConflictSet as RefCpu
from foundationdb_tpu.conflict.types import TransactionConflictInfo as JT
from foundationdb_tpu.flow.hotpath import hot_registry as ref_hot_registry
from foundationdb_tpu_torch.conflict import engine_torch as et
from foundationdb_tpu_torch.conflict.device_faults import DeviceFault, DeviceFaultInjector
from foundationdb_tpu_torch.conflict.engine_cpu_flat import FlatCpuConflictSet
from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as TT
from foundationdb_tpu_torch.flow import hotpath
from foundationdb_tpu_torch.flow.hotpath import (
    HOT_BOUNDS,
    GuardedDeviceValue,
    TransferGuardError,
    g_hostguard,
    hot_path,
    hot_registry,
)
from foundationdb_tpu_torch.parallel import ShardedTorchConflictSet

from test_torch_api import _drive, _port_set, _random_stream, _ref_set

# Reference module -> the port's module of the same code.
MODULES = {
    "foundationdb_tpu.conflict.keys": "foundationdb_tpu_torch.conflict.keys",
    "foundationdb_tpu.conflict.engine_cpu": "foundationdb_tpu_torch.conflict.engine_cpu",
    "foundationdb_tpu.conflict.engine_jax": "foundationdb_tpu_torch.conflict.engine_torch",
    "foundationdb_tpu.conflict.api": "foundationdb_tpu_torch.conflict.api",
    "foundationdb_tpu.parallel.sharded_resolver":
        "foundationdb_tpu_torch.parallel.sharded_resolver",
}
# Reference names the port spells differently.
NAMES = {
    "JaxConflictSet": "TorchConflictSet",
    "ShardedJaxConflictSet": "ShardedTorchConflictSet",
    # The port reads the ticket's one packed buffer back in _readback,
    # shared by sync_ticket and readback_packed.
    "TorchConflictSet._sync_ticket_body": "TorchConflictSet._readback",
}
# Reference sites outside conflict/ and parallel/, with no port counterpart.
EXCLUDED = {
    "foundationdb_tpu.server.resolver.Resolver._complete_resolve":
        "the reference's server (server/resolver.py:662) serves the port's sets and stays "
        "unported",
}


def _port_name(qual: str) -> str:
    for ref_mod, port_mod in MODULES.items():
        if qual.startswith(ref_mod + "."):
            rest = qual[len(ref_mod) + 1:]
            for a, b in NAMES.items():
                rest = rest.replace(a, b)
            return f"{port_mod}.{rest}"
    raise KeyError(qual)


# ---------------------------------------------------------------------------
# @hot_path declarations
# ---------------------------------------------------------------------------


def test_hot_path_registers_and_validates_bounds():
    """tests/test_hotpath.py:108."""
    @hot_path(bound="chunks")
    def _probe_fn():
        return 1

    assert _probe_fn() == 1
    assert _probe_fn.__hot_path_bound__ == "chunks"
    reg = hot_registry()
    assert reg[f"{_probe_fn.__module__}.{_probe_fn.__qualname__}"] == "chunks"
    assert set(reg.values()) <= set(HOT_BOUNDS) == {"batch", "chunks", "const"}
    with pytest.raises(ValueError):
        hot_path(bound="rows")


def test_hot_registry_covers_the_reference_sites():
    """tests/test_hotpath.py:122, whole: every @hot_path site of the
    reference's conflict/ and parallel/ modules has a port counterpart
    with the same bound, and the port declares no site the reference
    lacks; the exclusions name their reason."""
    ref = {q: b for q, b in ref_hot_registry().items()
           if q.startswith(("foundationdb_tpu.conflict.", "foundationdb_tpu.parallel.",
                            "foundationdb_tpu.server.resolver."))}
    port = {q: b for q, b in hot_registry().items() if q.startswith("foundationdb_tpu_torch.")}
    want = {}
    for qual, bound in ref.items():
        if qual in EXCLUDED:
            continue
        want[_port_name(qual)] = bound
    assert port == want
    assert len(want) == 17 and set(EXCLUDED) <= set(ref)
    assert all(reason for reason in EXCLUDED.values())


# ---------------------------------------------------------------------------
# GuardedDeviceValue
# ---------------------------------------------------------------------------


def _reads(g):
    return (lambda: int(g), lambda: float(g), lambda: bool(g), lambda: len(g),
            lambda: list(g), lambda: g[0], lambda: g.item(), lambda: g.tolist(),
            lambda: np.asarray(g), lambda: range(10)[g])


def test_guarded_value_raises_on_implicit_materialization():
    """tests/test_hotpath.py:151, on a torch tensor (a one-element one, so
    that every read is defined)."""
    g = GuardedDeviceValue(torch.tensor([3], dtype=torch.int32), "DispatchTicket.out")
    for op in _reads(g):
        with pytest.raises(TransferGuardError) as ei:
            op()
        assert "sanctioned sync point" in str(ei.value)
        assert "DispatchTicket.out" in str(ei.value)
    assert g.unwrap() is not None and "out" in repr(g)


def test_guarded_value_delegates_inside_sanctioned_scope():
    """tests/test_hotpath.py:169, on a CPU torch tensor."""
    g = GuardedDeviceValue(torch.arange(4, dtype=torch.int32), "DispatchTicket.host")
    with g_hostguard.allowed():
        assert not g_hostguard.blocking()
        a = np.asarray(g)
        assert a.dtype == np.int32 and a.sum() == 6
        assert np.asarray(g, dtype=np.int64).dtype == np.int64
        assert [int(x) for x in g] == [0, 1, 2, 3]
        assert len(g) == 4 and int(g[3]) == 3
        with g_hostguard.allowed():
            assert g.tolist() == [0, 1, 2, 3]
        assert not g_hostguard.blocking()
    assert g_hostguard.blocking()
    with pytest.raises(TransferGuardError):
        np.asarray(g)


class _DeviceTensor:
    """A stand-in for a CUDA tensor: numpy may not read it (a CUDA tensor's
    .numpy() raises TypeError), only its .cpu() copy."""

    class device:  # noqa: N801
        type = "cuda"

    def __init__(self, values):
        self.values = torch.tensor(values, dtype=torch.int32)
        self.copies = 0

    def cpu(self):
        self.copies += 1
        return self.values

    def __array__(self, dtype=None, copy=None):
        raise TypeError("can't convert cuda:0 device type tensor to numpy")


def test_guarded_value_never_hands_numpy_a_device_tensor():
    """Outside a scope the guard's own error is raised, not numpy's
    TypeError; inside one the device value is copied to the host first."""
    t = _DeviceTensor([5, 6])
    g = GuardedDeviceValue(t, "DispatchTicket.out")
    with pytest.raises(TransferGuardError):
        np.asarray(g)
    assert t.copies == 0
    with g_hostguard.allowed():
        assert np.asarray(g).tolist() == [5, 6]
        assert g.tolist() == [5, 6] and int(g[1]) == 6
    assert t.copies == 3


# ---------------------------------------------------------------------------
# the guard on the port's ConflictSet
# ---------------------------------------------------------------------------


def test_planted_read_of_a_parked_ticket_raises():
    """tests/test_hotpath.py:216: at depth 2 with the guard on, reading the
    parked batch's ticket raises; the sanctioned path completes it."""
    cs = _port_set(2, transfer_guard=True)
    assert cs._dev.transfer_guard
    txns, now, nov = _random_stream(7, 60, 4, 8)[0]
    entry = cs.pipeline_submit([JT_to_port(t) for t in txns], now, nov)
    assert cs.pipeline_inflight == 1 and not entry.done
    assert isinstance(entry.ticket.out, GuardedDeviceValue)
    assert entry.ticket.host is None  # on the CPU the step's buffer is read in place
    with pytest.raises(TransferGuardError) as ei:
        np.asarray(entry.ticket.out)
    assert "DispatchTicket.out" in str(ei.value)
    for op in (lambda: int(entry.ticket.out[0]), lambda: entry.ticket.out.tolist()):
        with pytest.raises(TransferGuardError):
            op()
    syncs = cs._dev.host_syncs
    cs.pipeline_drain()
    assert entry.done and cs.pipeline_inflight == 0
    assert cs._dev.host_syncs > syncs


def JT_to_port(t):
    return TT(t.read_snapshot, list(t.read_ranges), list(t.write_ranges))


def _export(cs):
    flat = FlatCpuConflictSet()
    cs._dev.store_to(flat)
    return (list(cs._cpu.keys), list(cs._cpu.vers), cs._cpu.oldest_version,
            list(flat.keys), list(flat.vers), flat.oldest_version)


def test_guard_on_run_equals_guard_off():
    """tests/test_hotpath.py:236: the guard only raises or does nothing,
    so verdicts and the exported mirror and device state are the same; it
    is off by default, and every batch entered its sanctioned scopes."""
    stream = _random_stream(11, 60, 12, 8)
    base = _port_set(2)
    assert base._dev.transfer_guard is False
    want = _drive(base, stream, 2, port=True)
    guarded = _port_set(2, transfer_guard=True)
    assert _drive(guarded, stream, 2, port=True) == want
    assert _export(guarded) == _export(base)
    c = guarded.device_metrics()["counters"]
    assert c["pipeline_dispatches"] == len(stream)
    assert c["host_syncs"] == base.device_metrics()["counters"]["host_syncs"] >= len(stream)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_guarded_port_matches_the_guarded_reference(monkeypatch, depth):
    """The port with transfer_guard=True against the reference built under
    FDB_TPU_TRANSFER_GUARD=1, through a scripted dispatch outage: verdicts,
    witnesses, degraded tags and the exported mirror and device state."""
    stream = _random_stream(21, 60, 12, 8)
    monkeypatch.setenv("FDB_TPU_TRANSFER_GUARD", "1")
    ref_inj, port_inj = RefInjector(), DeviceFaultInjector()
    for inj in (ref_inj, port_inj):
        inj.script("dispatch", at=3, persist=2)
    ref = _ref_set(monkeypatch, depth, fault_injector=ref_inj)
    assert ref._jax._transfer_guard
    port = _port_set(depth, transfer_guard=True, fault_injector=port_inj)
    assert _drive(port, stream, depth, port=True) == _drive(ref, stream, depth, port=False)
    ref_flat = RefCpu()
    ref._jax.store_to(ref_flat)
    got = _export(port)
    assert got[:3] == (list(ref._cpu.keys), list(ref._cpu.vers), ref._cpu.oldest_version)
    assert got[3:] == (list(ref_flat.keys), list(ref_flat.vers), ref_flat.oldest_version)
    assert port_inj.injected == ref_inj.injected


def _chain_batch(version, n=20):
    """n transactions, each reading the key the one before it writes: the
    fixpoint settles one link a round."""
    def k(i):
        return b"%08d" % i

    return [JT(read_snapshot=version, read_ranges=[(k(t), k(t) + b"\x00")],
               write_ranges=[(k(t + 1), k(t + 1) + b"\x00")]) for t in range(n)]


def test_long_fixpoint_passes_under_the_guard(monkeypatch):
    """A batch whose fixpoint runs more rounds than FIXPOINT_FIRST_CHUNK,
    so that it checks the device more than once, at depth 2 with the guard
    on: every check is sanctioned, and verdicts and iterations equal the
    unguarded run's and the reference's."""
    stream = _random_stream(5, 60, 3, 8)
    stream.append((_chain_batch(stream[-1][1]), stream[-1][1] + 1, 0))
    stream += _random_stream(6, 60, 2, 8)
    stream = [(t, now + (i >= 3) * 100, nov) for i, (t, now, nov) in enumerate(stream)]
    ref = _ref_set(monkeypatch, 2)
    want = _drive(ref, stream, 2, port=False)
    got = {}
    for guard in (False, True):
        cs = _port_set(2, transfer_guard=guard)
        iters, checks = [], [0]
        real = cs._dev._sanctioned_sync

        def counted(op, _real=real):
            if op == "fixpoint check":
                checks[0] += 1
            return _real(op)

        monkeypatch.setattr(cs._dev, "_sanctioned_sync", counted)
        entries = []
        for txns, now, nov in stream:
            entries.append(cs.pipeline_submit([JT_to_port(t) for t in txns], now, nov))
            while cs.pipeline_inflight > 1:
                cs.pipeline_complete_oldest()
                iters.append(cs._dev.last_iters)
        cs.pipeline_drain()
        iters.append(cs._dev.last_iters)
        got[guard] = ([(list(e.statuses), list(e.witness), e.degraded) for e in entries],
                      iters, checks[0])
    assert got[True] == got[False]
    assert got[True][0] == want
    assert max(got[True][1]) > et.FIXPOINT_FIRST_CHUNK + 2
    assert got[True][2] > len(stream)


def test_sharded_set_takes_no_guard():
    """As the reference's sharded set has none."""
    assert "transfer_guard" not in inspect.signature(ShardedTorchConflictSet).parameters
    assert "transfer_guard" in inspect.signature(port_api.ConflictSet).parameters


# ---------------------------------------------------------------------------
# the CUDA sync debug mode's arming, with torch.cuda's mode recorded
# ---------------------------------------------------------------------------


class _ModeRecorder:
    """torch.cuda.get/set_sync_debug_mode, recorded."""

    def __init__(self, monkeypatch):
        self.mode, self.log = 0, []
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: self.mode)
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", self.set)

    def set(self, mode):
        self.mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)
        self.log.append(self.mode)


def test_cuda_sync_debug_mode_restores_on_exit_and_error(monkeypatch):
    rec = _ModeRecorder(monkeypatch)
    with hotpath.cuda_sync_debug_mode("error"):
        assert rec.mode == 2
        with hotpath.cuda_sync_debug_mode(0):
            assert rec.mode == 0
        assert rec.mode == 2
    assert rec.mode == 0
    with pytest.raises(KeyError):
        with hotpath.cuda_sync_debug_mode("error"):
            raise KeyError("x")
    assert rec.mode == 0 and rec.log == [2, 0, 2, 0, 2, 0]


@pytest.fixture
def as_if_on_cuda(monkeypatch):
    """The engines' guard acting as on a CUDA device (their tensors stay on
    the CPU): arms_cuda_guard follows transfer_guard alone."""
    monkeypatch.setattr(et.TorchConflictSet, "arms_cuda_guard",
                        property(lambda self: self.transfer_guard))


@pytest.mark.parametrize("guard", [True, False])
def test_dispatch_is_armed_on_cuda_and_sanctioned_scopes_disarm(monkeypatch, as_if_on_cuda,
                                                               guard):
    """With the guard on a CUDA engine, the pipelined dispatch runs under
    mode "error", each sanctioned sync inside it (the fixpoint's checks
    included) under 0, and the mode is restored after the dispatch, a
    DeviceFault's included; off, nothing is armed.  Depth 1 is never
    armed."""
    rec = _ModeRecorder(monkeypatch)
    cs = _port_set(2, transfer_guard=guard)
    armed = 2 if guard else 0
    seen = []
    real_sync = cs._dev._sanctioned_sync

    def sanctioned(op):
        seen.append((op, rec.mode))
        return real_sync(op)

    monkeypatch.setattr(cs._dev, "_sanctioned_sync", sanctioned)
    real_dispatch = cs._dev.dispatch_txns

    def dispatch(*a):
        seen.append(("dispatch", rec.mode))
        ticket = real_dispatch(*a)
        seen.append(("dispatched", rec.mode))
        return ticket

    monkeypatch.setattr(cs._dev, "dispatch_txns", dispatch)
    stream = _random_stream(3, 60, 2, 8)
    txns, now, nov = stream[0]
    cs.pipeline_submit([JT_to_port(t) for t in txns], now, nov)
    assert rec.mode == 0
    assert seen[0] == ("dispatch", armed) and seen[-1] == ("dispatched", armed)
    inside = seen[1:-1]
    assert ("fixpoint check", armed) in inside  # the mode as the scope is asked for
    assert rec.log == ([2] + [0, 2] * len(inside) + [0] if guard else [])

    def faulting(*a):
        seen.append(("faulting", rec.mode))
        raise DeviceFault("injected", site="dispatch")

    monkeypatch.setattr(cs._dev, "dispatch_txns", faulting)
    entry = cs.pipeline_submit([JT_to_port(t) for t in stream[1][0]], stream[1][1], stream[1][2])
    assert entry.done and entry.degraded
    assert seen[-1] == ("faulting", armed) and rec.mode == 0
    one = _port_set(1, transfer_guard=guard)

    def detect(*a):
        seen.append(("depth 1", rec.mode))
        raise DeviceFault("injected", site="dispatch")

    monkeypatch.setattr(one._dev, "detect", detect)
    one.pipeline_submit([JT_to_port(t) for t in txns], now, nov)
    assert seen[-1] == ("depth 1", 0)
