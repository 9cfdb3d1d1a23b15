"""AsyncVar and NotifiedVersion: observable value cells.

The port's own copy of the reference package's ``flow/asyncvar.py``
(flow/genericactors.actor.h's AsyncVar<T>, and NotifiedVersion, whose
``when_at_least`` orders the resolver's batches by prevVersion).
"""

from __future__ import annotations

from typing import Any, Generic, TypeVar

from .future import Future, Promise

T = TypeVar("T")


class AsyncVar(Generic[T]):
    __slots__ = ("_value", "_change")

    def __init__(self, value: T = None):
        self._value = value
        self._change = Promise()

    def get(self) -> T:
        return self._value

    def on_change(self) -> Future:
        """Fires (with the new value) at the next set(); one-shot per call site."""
        return self._change.future

    def set(self, value: T):
        if value == self._value:
            return
        self._value = value
        prev, self._change = self._change, Promise()
        prev.send(value)

    def trigger(self):
        """Force waiters to wake even if the value is unchanged."""
        prev, self._change = self._change, Promise()
        prev.send(self._value)


class NotifiedVersion:
    """Monotone version with when_at_least() waits (ref: flow NotifiedVersion;
    the resolver's prevVersion ordering chain, Resolver.actor.cpp:104-115)."""

    __slots__ = ("_value", "_waiters")

    def __init__(self, value: int = 0):
        self._value = value
        self._waiters: list[tuple[int, Promise]] = []

    def get(self) -> int:
        return self._value

    def when_at_least(self, version: int) -> Future:
        if self._value >= version:
            from .future import ready_future

            return ready_future(self._value)
        p = Promise()
        self._waiters.append((version, p))
        return p.future

    def set(self, version: int):
        assert version >= self._value, "NotifiedVersion must be monotone"
        self._value = version
        still = []
        for v, p in self._waiters:
            if v <= version:
                p.send(version)
            else:
                still.append((v, p))
        self._waiters = still
