"""A lost or reset card through the port's ConflictSet, held to the
reference's JaxRuntimeError at the same batch.

The reference maps a real device error at two sites: the engine's dispatch
(``engine_jax.py:2552-2564``: ``CompileFailed(site="compile")`` at a
shape's first dispatch, else ``DeviceUnavailable(site="dispatch")``) and
the pipelined sync (``api.py:686-701``: ``DeviceUnavailable(site="sync")``,
the parked batches replayed on the mirror).  The port maps, at the same
two sites, only the CUDA errors that mean the card went away
(``device.is_lost_device``: cudaErrorDevicesUnavailable 46,
cudaErrorNoDevice 100, cudaErrorECCUncorrectable 214,
cudaErrorLaunchTimeout 702).

The same seeded stream goes through the reference's
``ConflictSet(backend="jax")`` and the port's ``ConflictSet(device="cpu")``.
Where the reference's step callable (or ``sync_ticket``) raises a
constructed ``jax.errors.JaxRuntimeError``, the port's raises the error it
would see on the card: a ``torch.AcceleratorError`` carrying the code as
torch sets it (``error_code``), one carrying only the runtime's string, or
the kernel launcher's ``CudaError``.  Verdicts, witnesses, degraded flags,
the mirror, the device export after the breaker closes again, the shared
counters, the fault counters by site and the breaker walk must be equal.
A non-lost code (700, an illegal memory access) at the same sites still
propagates, with ``device_faults`` 0; so does a lost card at the depth-1
readback, in both packages.  Shapes are test_torch_api.py's; all integers,
the tolerance is zero.
"""

import jax
import pytest
import torch

from foundationdb_tpu.conflict import engine_jax as ej
from foundationdb_tpu_torch import device as pdev
from foundationdb_tpu_torch.conflict import engine_torch as et
from foundationdb_tpu_torch.conflict.device_faults import DeviceFault
from test_torch_api import _assert_same, _drive, _port_set, _random_stream, _ref_set

# cudaGetErrorString of CUDA 12's runtime for the codes these tests raise;
# the card tests hold the classifier to the card's own runtime.
CUDA_STRINGS = {
    46: "CUDA-capable device(s) is/are busy or unavailable",
    100: "no CUDA-capable device is detected",
    209: "no kernel image is available for execution on the device",
    214: "uncorrectable ECC error encountered",
    700: "an illegal memory access was encountered",
    702: "the launch timed out and was terminated",
    710: "device-side assert triggered",
}
FAULTS = ("device_faults", "faults_compile", "faults_dispatch", "faults_sync",
          "breaker_opens", "breaker_probes", "breaker_closes", "degraded_batches",
          "pipeline_replayed_batches", "rehydrates")
# The step or sync calls that fail: three in a row open the breaker.
AT = {"first_dispatch": (1, 2, 3), "later_dispatch": (5, 6, 7), "sync": (4, 5, 6)}


def _torch_message(code: int) -> str:
    """The message torch's CUDA check gives a cudaError_t."""
    return (f"CUDA error: {CUDA_STRINGS[code]}\n"
            "CUDA kernel errors might be asynchronously reported at some other API call, "
            "so the stacktrace below might be incorrect.\n"
            "For debugging consider passing CUDA_LAUNCH_BLOCKING=1\n")


def _port_error(form: str, code: int) -> RuntimeError:
    """The error the port sees from the card: torch's AcceleratorError with
    its code (``code``) or with its message alone (``string``), or the
    kernel launcher's CudaError (``launcher``)."""
    if form == "launcher":
        return pdev.CudaError(f"phase1_ranks: CUDA error {code} at launch", code)
    e = torch.AcceleratorError(_torch_message(code))
    if form == "code":
        e.error_code = code
    return e


@pytest.fixture
def runtime_strings(monkeypatch):
    """The card runtime's strings, for an AcceleratorError without a code
    (this torch has no CUDA runtime to ask)."""
    monkeypatch.setattr(pdev, "cuda_error_string", CUDA_STRINGS.get)


def _fail_calls(monkeypatch, owner, names, at, error):
    """Make the calls numbered ``at`` (1-based, across ``names``) of
    ``owner``'s callables raise ``error()``; returns the call count."""
    calls = {"n": 0}
    for name in names:
        real = getattr(owner, name)

        def failing(*args, _real=real, **kwargs):
            calls["n"] += 1
            if calls["n"] in at:
                raise error()
            return _real(*args, **kwargs)

        monkeypatch.setattr(owner, name, failing)
    return calls


def _plant(monkeypatch, site, at, ref_error, port_error):
    """The reference's and the port's step (dispatch sites) or sync_ticket
    (the sync) fail at the same calls."""
    if site == "sync":
        ref = _fail_calls(monkeypatch, ej.JaxConflictSet, ["sync_ticket"], at, ref_error)
        port = _fail_calls(monkeypatch, et.TorchConflictSet, ["sync_ticket"], at, port_error)
    else:
        ref = _fail_calls(monkeypatch, ej, ["_blob_step", "_blob_step_nodonate"], at,
                          ref_error)
        port = _fail_calls(monkeypatch, et, ["_blob_core"], at, port_error)
    return ref, port


def _faults(cs):
    c = cs.device_metrics()["counters"]
    return {name: c.get(name, 0) for name in FAULTS}


def _jax_error():
    return jax.errors.JaxRuntimeError("INTERNAL: the device was lost")


@pytest.mark.parametrize("site,depth,form,code", [
    ("first_dispatch", 1, "code", 46),
    ("first_dispatch", 2, "code", 100),
    ("first_dispatch", 2, "launcher", 46),
    ("later_dispatch", 1, "code", 214),
    ("later_dispatch", 2, "code", 702),
    ("later_dispatch", 3, "code", 46),
    ("later_dispatch", 2, "launcher", 702),
    ("later_dispatch", 2, "string", 214),
    ("sync", 2, "code", 46),
    ("sync", 3, "code", 702),
    ("sync", 2, "string", 100),
])
def test_lost_card_degrades_as_the_reference(monkeypatch, runtime_strings, site, depth,
                                             form, code):
    stream = _random_stream(41, 60, 24, 8)
    at = AT[site]
    ref_calls, port_calls = _plant(monkeypatch, site, at, _jax_error,
                                   lambda: _port_error(form, code))
    ref = _ref_set(monkeypatch, depth)
    want = _drive(ref, stream, depth, port=False)
    cs = _port_set(depth)
    got = _drive(cs, stream, depth, port=True)
    assert ref_calls["n"] == port_calls["n"] >= max(at)
    _assert_same(cs, ref, got, want)
    faults = _faults(cs)
    assert faults == _faults(ref)
    kind, where = {"first_dispatch": ("CompileFailed", "compile"),
                   "later_dispatch": ("DeviceUnavailable", "dispatch"),
                   "sync": ("DeviceUnavailable", "sync")}[site]
    assert faults["device_faults"] == faults[f"faults_{where}"] == len(at)
    breaker = cs.device_metrics()["breaker"]
    assert breaker["transitions"][0][3] == f"threshold:{kind}:{where}"
    assert breaker["state"] == "ok" and faults["breaker_closes"] == 1
    assert any(d for _s, _w, d in got)
    if site == "sync":
        assert faults["pipeline_replayed_batches"] > 0


def test_lost_card_at_the_depth_one_readback_propagates_as_the_reference(monkeypatch):
    """The depth-1 serve reads back outside the mapped sites: the
    reference's synchronous path catches only DeviceFault, so its
    JaxRuntimeError escapes, and the port's lost-card error does too, with
    the breaker untouched in both."""
    stream = _random_stream(43, 60, 6, 8)
    _fail_calls(monkeypatch, ej.JaxConflictSet, ["_readback_packed"], (3,), _jax_error)
    _fail_calls(monkeypatch, et.TorchConflictSet, ["readback_packed"], (3,),
                lambda: _port_error("code", 46))
    ref = _ref_set(monkeypatch, 1)
    cs = _port_set(1)
    with pytest.raises(jax.errors.JaxRuntimeError):
        _drive(ref, stream, 1, port=False)
    with pytest.raises(torch.AcceleratorError) as e:
        _drive(cs, stream, 1, port=True)
    assert pdev.is_lost_device(e.value)
    assert _faults(cs) == _faults(ref)
    assert _faults(cs)["device_faults"] == 0
    assert cs.device_metrics()["breaker"] == ref.device_metrics()["breaker"]


@pytest.mark.parametrize("site,form", [
    ("first_dispatch", "code"),
    ("later_dispatch", "code"),
    ("later_dispatch", "launcher"),
    ("sync", "code"),
    ("sync", "string"),
])
def test_other_cuda_errors_propagate(monkeypatch, runtime_strings, site, form):
    """An illegal memory access (700) at the same sites is a fault of the
    code: it leaves ConflictSet, and the breaker never sees it."""
    stream = _random_stream(41, 60, 10, 8)
    at = AT[site][:1]
    if site == "sync":
        _fail_calls(monkeypatch, et.TorchConflictSet, ["sync_ticket"], at,
                    lambda: _port_error(form, 700))
    else:
        _fail_calls(monkeypatch, et, ["_blob_core"], at, lambda: _port_error(form, 700))
    cs = _port_set(2)
    with pytest.raises(RuntimeError, match="illegal memory access|CUDA error 700") as e:
        _drive(cs, stream, 2, port=True)
    assert not isinstance(e.value, DeviceFault)
    assert pdev.cuda_error_code(e.value) in (700, None)
    assert _faults(cs)["device_faults"] == 0
    assert cs.device_metrics()["backend_state"] == "ok"


# ---------------------------------------------------------------------------
# the classifier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["code", "launcher"])
def test_exactly_four_codes_mean_a_lost_card(form):
    lost = [c for c in range(1000) if pdev.is_lost_device(
        pdev.CudaError("x", c) if form == "launcher" else _with_code(c))]
    assert lost == [46, 100, 214, 702] == sorted(pdev.LOST_DEVICE_CODES)


def _with_code(code):
    e = torch.AcceleratorError(f"CUDA error: code {code}")
    e.error_code = code
    return e


def test_runtime_strings_classify_an_error_without_a_code(runtime_strings):
    """Without a code, the ``CUDA error: ...`` line must equal one of the
    four codes' runtime strings exactly."""
    assert [c for c in sorted(CUDA_STRINGS)
            if pdev.is_lost_device(_port_error("string", c))] == [46, 100, 214, 702]
    for text in ("CUDA error: no CUDA-capable device", "no CUDA-capable device is detected",
                 "CUDA error: an illegal memory access"):
        assert not pdev.is_lost_device(torch.AcceleratorError(text)), text


def test_only_cuda_errors_are_classified(runtime_strings):
    """A plain RuntimeError with a lost card's text, a DeviceFault and a
    construction without a runtime to ask are never a lost card."""
    assert not pdev.is_lost_device(RuntimeError(_torch_message(46)))
    assert not pdev.is_lost_device(ValueError("x"))
    assert not pdev.is_lost_device(torch.OutOfMemoryError("CUDA out of memory"))
    assert pdev.is_lost_device(_port_error("string", 702))


def test_no_runtime_no_strings():
    """This torch has no CUDA runtime: it names no code, so an
    AcceleratorError without a code is not a lost card here."""
    assert pdev.cuda_error_string(46) is None and pdev.cuda_error_name(46) is None
    assert not pdev.is_lost_device(_port_error("string", 46))
    assert pdev.is_lost_device(_port_error("code", 46))


def test_launcher_error_keeps_its_message_and_carries_its_code():
    from foundationdb_tpu_torch.conflict import kernels

    with pytest.raises(pdev.CudaError, match=r"^phase1_ranks: CUDA error 209 at launch$") as e:
        kernels._raise_on(209, "phase1_ranks")
    assert e.value.code == 209 and isinstance(e.value, RuntimeError)
    assert not pdev.is_lost_device(e.value)
    with pytest.raises(pdev.CudaError) as e:
        kernels._raise_on(46, "fused_merge_evict")
    assert pdev.is_lost_device(e.value)
    kernels._raise_on(0, "fused_merge_evict")


def test_one_lost_card_dispatch_keeps_the_verdicts(monkeypatch):
    """One lost-card dispatch at depth 2: the parked batch before it and
    the faulted batch are served from the mirror with the verdicts and
    witnesses of a fault-free run, both replies tagged degraded; the
    breaker stays closed and the next submit rehydrates."""
    stream = _random_stream(47, 60, 8, 8)
    clean = _drive(_port_set(2), stream, 2, port=True)
    _fail_calls(monkeypatch, et, ["_blob_core"], (4,), lambda: _port_error("code", 46))
    cs = _port_set(2)
    got = _drive(cs, stream, 2, port=True)
    assert [(s, w) for s, w, _d in got] == [(s, w) for s, w, _d in clean]
    assert [d for _s, _w, d in got] == [False] * 2 + [True] * 2 + [False] * 4
    c = _faults(cs)
    assert c["device_faults"] == c["faults_dispatch"] == 1 and c["rehydrates"] == 2
    assert c["pipeline_replayed_batches"] == 1 and c["breaker_opens"] == 0
