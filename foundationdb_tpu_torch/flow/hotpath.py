"""Hot-path discipline: ``@hot_path`` declarations and the transfer guard.

The port's own copy of the reference package's ``flow/hotpath.py``.

``@hot_path(bound=...)``
    Declares a function part of the per-batch hot set with an explicit
    complexity bound: ``"batch"`` (O(rows of the batch)), ``"chunks"``
    (O(mirror chunks touched since the last sync)) or ``"const"`` (no
    data-dependent loops).  The decorator only tags the function and
    records it in the registry ``hot_registry()`` reads.

``GuardedDeviceValue`` / ``g_hostguard``
    With ``transfer_guard=True`` (the reference's FDB_TPU_TRANSFER_GUARD),
    the engine wraps a DispatchTicket's device buffer and its pinned host
    buffer in this proxy, which raises TransferGuardError on any implicit
    host read (``np.asarray``, ``int``, ``float``, ``bool``, ``len``,
    iteration, ``.item()``, ``.tolist()``, indexing) outside a sanctioned
    sync scope (``g_hostguard.allowed()``).  It acts on every device, the
    CPU included.  On CUDA the engine also arms
    ``torch.cuda.set_sync_debug_mode("error")`` over the dispatch, so a
    sync on a tensor the proxy does not wrap raises too.

A read inside a sanctioned scope delegates to the wrapped value, so the
declared sync points behave the same with the guard on or off.  The proxy
never calls ``.numpy()`` on a CUDA tensor (which raises TypeError, hiding
the guard's own error): outside a scope the guard raises first, inside one
a CUDA tensor is copied to the host before numpy sees it.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict

HOT_BOUNDS = ("batch", "chunks", "const")

# "module.qualname" -> declared bound.
_REGISTRY: Dict[str, str] = {}


def hot_path(bound: str = "batch"):
    """Declare a per-batch hot-path function with an explicit bound."""
    if bound not in HOT_BOUNDS:
        raise ValueError(f"hot_path bound must be one of {HOT_BOUNDS}, got {bound!r}")

    def mark(fn):
        fn.__hot_path_bound__ = bound
        _REGISTRY[f"{fn.__module__}.{fn.__qualname__}"] = bound
        return fn

    return mark


def hot_registry() -> Dict[str, str]:
    """Snapshot of the declared hot set ("module.qualname" -> bound)."""
    return dict(_REGISTRY)


class TransferGuardError(RuntimeError):
    """An implicit device->host read hit a guarded in-flight value."""


class HostSyncGuard:
    """Scope tracker for the sanctioned device->host sync points: guarded
    values may be read only inside ``allowed()``, which the engine enters
    at each declared sync.  Reentrant."""

    def __init__(self):
        self._allow_depth = 0

    def blocking(self) -> bool:
        return self._allow_depth == 0

    @contextmanager
    def allowed(self):
        self._allow_depth += 1
        try:
            yield
        finally:
            self._allow_depth -= 1


g_hostguard = HostSyncGuard()


@contextmanager
def cuda_sync_debug_mode(mode):
    """``torch.cuda.set_sync_debug_mode(mode)`` for the scope, the previous
    mode restored on exit (the mode is process-global): "error" (2) makes
    every synchronizing CUDA call raise, 0 allows them."""
    import torch

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _host(v):
    """The value as something numpy can read: a tensor off the device
    first."""
    device = getattr(v, "device", None)
    if device is not None and getattr(device, "type", "cpu") != "cpu":
        return v.cpu()
    return v


class GuardedDeviceValue:
    """Proxy around an in-flight value of a DispatchTicket (see the module
    docstring)."""

    __slots__ = ("_v", "_label")

    def __init__(self, v, label: str):
        self._v = v
        self._label = label

    def unwrap(self):
        """The wrapped value, without a guard check, for code that forwards
        it without reading it on the host."""
        return self._v

    def _read(self, op: str):
        if g_hostguard.blocking():
            raise TransferGuardError(
                f"implicit device->host sync: {op} on in-flight "
                f"{self._label} outside a sanctioned sync point "
                "(sync_ticket / readback_packed / export).  A hidden sync "
                "here blocks the host inside the pipelined dispatch->sync "
                "window and serializes the pipeline.")
        return _host(self._v)

    # -- implicit host reads --
    def __array__(self, dtype=None, copy=None):
        import numpy as np

        a = np.asarray(self._read(f"np.asarray({self._label})"))
        if dtype is not None:
            a = a.astype(dtype, copy=False)
        return a

    def __int__(self):
        return int(self._read(f"int({self._label})"))

    def __float__(self):
        return float(self._read(f"float({self._label})"))

    def __bool__(self):
        return bool(self._read(f"bool({self._label})"))

    def __index__(self):
        return int(self._read(f"index({self._label})"))

    def __len__(self):
        return len(self._read(f"len({self._label})"))

    def __iter__(self):
        return iter(self._read(f"iteration over {self._label}"))

    def __getitem__(self, idx):
        return self._read(f"indexing {self._label}")[idx]

    def item(self):
        return self._read(f"{self._label}.item()").item()

    def tolist(self):
        return self._read(f"{self._label}.tolist()").tolist()

    def __repr__(self):
        return f"GuardedDeviceValue({self._label})"
