"""The port's ConflictSet(mirror_coalesce=k) against the reference's
FDB_TPU_MIRROR_COALESCE=k.

The reference's ConflictSet sets its chunked mirror's fold window from the
knob ("auto" = the pipeline depth) and records the device's synced point
only when no fold is pending, since ``snapshot()`` is a settle barrier.
The same seeded stream goes through the port's ``ConflictSet(device="cpu",
mirror_coalesce=k)`` and the reference's ``ConflictSet(backend="jax")``
with the knobs set by setenv, at pipeline depths 1-3: after every batch
the verdicts, witnesses and the mirror's state as it stands (its folded
chunks, window, queued batches and stamp, read without settling), and at
the end the settled mirror, the device export, the counters and the count
of ``note_synced`` calls.  A ``mirror_check`` mid-window settles both
mirrors alike, and a scripted dispatch fault mid-window serves one batch
from the mirror, after which the device rehydrates from a settled
snapshot.

Shapes follow tests/test_torch_api.py (key_words=3, bucket_mins=(32, 128,
64), h_cap=1<<10).  All integers; the tolerance is zero.
"""

import pytest

from foundationdb_tpu.conflict.api import ConflictSet as RefConflictSet
from foundationdb_tpu.conflict.api import env_coalesce_window
from foundationdb_tpu.conflict.device_faults import DeviceFaultInjector as RefInjector
from foundationdb_tpu_torch.conflict.api import ConflictSet, coalesce_window
from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector

from test_torch_api import SHARED_COUNTERS, _device_export, _port_txns, _random_stream

KW = dict(key_words=3, bucket_mins=(32, 128, 64), h_cap=1 << 10)
WINDOWS = ["0", "1", "2", "4", "auto"]
CHECK_AT = 6  # the batch after which both sides drain and run mirror_check


def _pair(monkeypatch, window, depth, fault_at=None):
    """The reference's ConflictSet under the knobs and the port's with the
    same settings; with `fault_at`, both injectors fault that dispatch."""
    monkeypatch.setenv("FDB_TPU_MIRROR_COALESCE", window)
    monkeypatch.setenv("FDB_TPU_PIPELINE_DEPTH", str(depth))
    rinj, inj = RefInjector(), DeviceFaultInjector()
    if fault_at is not None:
        rinj.script("dispatch", at=fault_at)
        inj.script("dispatch", at=fault_at)
    ref = RefConflictSet(backend="jax", fault_injector=rinj, **KW)
    cs = ConflictSet(device="cpu", pipeline_depth=depth, mirror_coalesce=window,
                     fault_injector=inj, **KW)
    assert cs._cpu.coalesce_window == ref._cpu.coalesce_window
    return ref, cs


def _count_calls(obj, name):
    """Wrap obj.name (an instance attribute from now on); returns the list
    the wrapper appends to."""
    calls, real = [], getattr(obj, name)

    def wrapper(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    setattr(obj, name, wrapper)
    return calls


def _mirror_as_it_stands(cpu):
    """The mirror's folded state, window, queued batches and stamp, read
    WITHOUT settling it (a settle would change what is measured)."""
    keys, vers = [], []
    for ch in cpu._chunks:
        keys.extend(ch.keys)
        vers.extend(ch.vers)
    return (keys, vers, cpu._oldest, cpu.pending_batches,
            [(now, nov) for _active, now, nov in cpu._pending], cpu.stamp)


def _drive_both(ref, cs, stream, depth):
    """Both sets through the Resolver's discipline, batch by batch; after
    batch CHECK_AT both drain and run mirror_check.  Returns the
    per-batch observations of each side and the two mirror_check reports."""
    observed = {"ref": [], "port": []}
    entries = {"ref": [], "port": []}
    reports = {}
    for i, (txns, now, nov) in enumerate(stream):
        for side, s, t in (("ref", ref, txns), ("port", cs, _port_txns(txns))):
            entries[side].append(s.pipeline_submit(t, now, nov))
            while s.pipeline_inflight > depth - 1:
                s.pipeline_complete_oldest()
            if i == CHECK_AT:
                s.pipeline_drain()
                pending = s._cpu.pending_batches
                reports[side] = (pending, s.mirror_check())
            observed[side].append(_mirror_as_it_stands(s._cpu))
    for s in (ref, cs):
        s.pipeline_drain()
    for side in entries:
        observed[side].append([(list(e.statuses), list(e.witness), e.degraded)
                               for e in entries[side]])
    return observed, reports


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("window", WINDOWS)
def test_coalesced_mirror_matches_the_reference(monkeypatch, window, depth):
    stream = _random_stream(41, 60, 14, 8)
    ref, cs = _pair(monkeypatch, window, depth)
    synced = {"ref": _count_calls(ref._jax, "note_synced"),
              "port": _count_calls(cs._dev, "note_synced")}
    observed, reports = _drive_both(ref, cs, stream, depth)
    for i, (want, got) in enumerate(zip(observed["ref"], observed["port"])):
        assert got == want, f"after batch {i}"
    assert reports["port"] == reports["ref"]
    assert reports["port"][1]["status"] == "ok"
    assert len(synced["port"]) == len(synced["ref"])
    assert (list(cs._cpu.keys), list(cs._cpu.vers)) == (list(ref._cpu.keys),
                                                         list(ref._cpu.vers))
    assert _device_export(cs, True) == _device_export(ref, False)
    pc, rc = cs.device_metrics()["counters"], ref.device_metrics()["counters"]
    assert {n: pc.get(n, 0) for n in SHARED_COUNTERS} == {n: rc.get(n, 0)
                                                          for n in SHARED_COUNTERS}
    assert cs.mirror_check() == ref.mirror_check()
    k = cs._cpu.coalesce_window
    # The synced point moves once a fold: K batches apart, except where a
    # read settled the mirror early (the mirror_check, the final drain).
    assert len(synced["port"]) < len(stream) if k > 1 else len(synced["port"]) == len(stream)
    if k > 1:
        assert any(obs[3] > 0 for obs in observed["port"][:-1])
        assert max(obs[3] for obs in observed["port"][:-1]) == k - 1


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("window", ["2", "auto"])
def test_dispatch_fault_mid_window_rehydrates_a_settled_snapshot(monkeypatch, window, depth):
    """The 4th dispatch faults while a fold is pending (window 2 or the
    depth): the batch (and at depth > 1 the parked tail) is served by the
    mirror, which settles first, and the next device batch rehydrates from
    a snapshot with nothing queued.  Verdicts, witnesses, the injected log,
    the breaker's transitions and the counters equal the reference's."""
    stream = _random_stream(43, 60, 12, 8)
    ref, cs = _pair(monkeypatch, window, depth, fault_at=4)
    loads = []
    real_load = cs._dev.load_from

    def load_from(src):
        # The snapshot argument was taken before this call: it settled.
        loads.append((cs._cpu.pending_batches, src.stamp, cs._cpu.stamp))
        return real_load(src)

    cs._dev.load_from = load_from
    synced = {"ref": _count_calls(ref._jax, "note_synced"),
              "port": _count_calls(cs._dev, "note_synced")}
    observed, _reports = _drive_both(ref, cs, stream, depth)
    for i, (want, got) in enumerate(zip(observed["ref"], observed["port"])):
        assert got == want, f"after batch {i}"
    assert cs._dev.fault_injector.injected == ref._jax.fault_injector.injected
    assert cs._dev.fault_injector.injected
    pm, rm = cs.device_metrics(), ref.device_metrics()
    assert pm["breaker"]["transitions"] == rm["breaker"]["transitions"]
    assert {n: pm["counters"].get(n, 0) for n in SHARED_COUNTERS} == {
        n: rm["counters"].get(n, 0) for n in SHARED_COUNTERS}
    assert len(synced["port"]) == len(synced["ref"])
    assert pm["counters"]["device_faults"] == 1 and pm["counters"]["rehydrates"] == 2
    # The first load is the initial hydration; the second follows the fault.
    assert len(loads) == 2
    assert all(pending == 0 and snap == live for pending, snap, live in loads)
    assert any(d for d in (e[2] for e in observed["port"][-1]))
    assert cs.mirror_check()["status"] == "ok"


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("value", ["0", "1", "2", "4", "7", "auto", "-3", "x", "", "2.5"])
def test_window_setting_reads_as_the_knob(monkeypatch, value, depth):
    """coalesce_window(value, depth) is the reference's env_coalesce_window()
    under FDB_TPU_MIRROR_COALESCE=value at FDB_TPU_PIPELINE_DEPTH=depth."""
    monkeypatch.setenv("FDB_TPU_MIRROR_COALESCE", value)
    monkeypatch.setenv("FDB_TPU_PIPELINE_DEPTH", str(depth))
    want = env_coalesce_window()
    assert coalesce_window(value, depth) == want
    if value.lstrip("-").isdigit():
        assert coalesce_window(int(value), depth) == want
    assert ConflictSet(device="cpu", pipeline_depth=depth, mirror_coalesce=value,
                       **KW)._cpu.coalesce_window == want


def test_default_applies_every_batch_at_once():
    """mirror_coalesce defaults to 1, the knob's default: no batch is ever
    queued and every device-served batch records the synced point."""
    stream = _random_stream(47, 60, 6, 8)
    cs = ConflictSet(device="cpu", pipeline_depth=2, **KW)
    synced = _count_calls(cs._dev, "note_synced")
    for txns, now, nov in stream:
        cs.pipeline_submit(_port_txns(txns), now, nov)
        while cs.pipeline_inflight > 1:
            cs.pipeline_complete_oldest()
        assert cs._cpu.pending_batches == 0
    cs.pipeline_drain()
    assert cs._cpu.coalesce_window == 1 and len(synced) == len(stream)
    wall = cs._dev.metrics.snapshot(include_wall=True)["wall"]
    assert wall["note_synced_seconds"]["count"] == len(stream)
