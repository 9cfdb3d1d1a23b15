"""Futures and promises: single-assignment values with callback chains.

The port's own copy of the reference package's ``flow/future.py`` (modelled
on flow/flow.h: SAV, Future, Promise, FutureStream, PromiseStream).  One
thread, no locks: ``set`` delivers synchronously to plain callbacks, while
an awaiting coroutine resumes through the event loop's ready queue at the
future's priority, as flow delivers to actors through task priorities.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Generator, Optional

from .error import ActorCancelled, FdbError

_PENDING = 0
_VALUE = 1
_ERROR = 2

# Test-only bookkeeping behind flow/sim_validation's orphaned-wait check
# (the dynamic twin of fdblint PRM001/PRM002): when on, every Future
# remembers its paired Promise by WEAK reference, so teardown checks can
# tell "parked on a promise somebody still holds" from "parked on a
# promise that was dropped — zero remaining senders".  Off by default:
# promises are hot-path objects and the weakref is pure diagnostics.
_TRACK_REFS = False


def track_promise_refs(on: bool):
    """Enable/disable Promise weakref bookkeeping.  Must be on BEFORE the
    scenario under test creates its promises (sim_validation's
    orphaned_waits finds nothing without it, and expect_no_orphaned_waits
    refuses to run blind)."""
    global _TRACK_REFS
    _TRACK_REFS = bool(on)


def promise_tracking_enabled() -> bool:
    return _TRACK_REFS


class Future:
    __slots__ = ("_state", "_result", "_callbacks", "priority", "timer_cell",
                 "promise_ref", "__weakref__")

    def __init__(self, priority: Optional[int] = None):
        self._state = _PENDING
        self._result: Any = None
        self._callbacks: list[Callable[["Future"], None]] = []
        # Priority at which awaiting coroutines resume; None = inherit.
        self.priority = priority
        # Set by EventLoop.delay so pending timers can be cancelled.
        self.timer_cell = None
        # weakref to the paired Promise (only under track_promise_refs).
        self.promise_ref = None

    # -- inspection --
    def is_ready(self) -> bool:
        return self._state != _PENDING

    def is_error(self) -> bool:
        return self._state == _ERROR

    def get(self):
        """Value if ready, raising if error; ref Future::get()."""
        if self._state == _VALUE:
            return self._result
        if self._state == _ERROR:
            raise self._result
        raise FdbError("future_version")  # get() on not-ready is a logic error

    def error(self) -> Optional[BaseException]:
        return self._result if self._state == _ERROR else None

    # -- assignment (normally via Promise) --
    def _set(self, value):
        assert self._state == _PENDING, "Future already set"
        self._state = _VALUE
        self._result = value
        self._fire()

    def _set_error(self, err: BaseException):
        assert self._state == _PENDING, "Future already set"
        self._state = _ERROR
        self._result = err
        self._fire()

    def _fire(self):
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def add_callback(self, cb: Callable[["Future"], None]):
        if self._state != _PENDING:
            cb(self)
        else:
            self._callbacks.append(cb)

    def remove_callback(self, cb):
        try:
            self._callbacks.remove(cb)
        except ValueError:
            pass

    # -- awaitable protocol --
    def __await__(self) -> Generator["Future", None, Any]:
        if self._state == _PENDING:
            yield self  # Task.step picks this up and subscribes
        return self.get()


class Promise:
    """Write side of a Future; ref flow/flow.h:705."""

    __slots__ = ("future", "__weakref__")

    def __init__(self, priority: Optional[int] = None):
        self.future = Future(priority)
        if _TRACK_REFS:
            self.future.promise_ref = weakref.ref(self)

    def send(self, value=None):
        self.future._set(value)

    def send_error(self, err: BaseException):
        self.future._set_error(err)

    def is_set(self) -> bool:
        return self.future.is_ready()

    def __repr__(self):
        return f"Promise(ready={self.future.is_ready()})"


def ready_future(value=None) -> Future:
    f = Future()
    f._set(value)
    return f


def error_future(err: BaseException) -> Future:
    f = Future()
    f._set_error(err)
    return f


class FutureStream:
    """Read side of a PromiseStream; ref flow/flow.h:756.

    pop() returns a Future for the next element.  Elements are queued; an
    error (e.g. end_of_stream) is delivered after all queued values.
    """

    __slots__ = ("_queue", "_waiters", "_error")

    def __init__(self):
        self._queue: list = []
        self._waiters: list[Promise] = []
        self._error: Optional[BaseException] = None

    def pop(self) -> Future:
        if self._queue:
            return ready_future(self._queue.pop(0))
        if self._error is not None:
            return error_future(self._error)
        p = Promise()
        self._waiters.append(p)
        return p.future

    def is_ready(self) -> bool:
        return bool(self._queue) or self._error is not None

    def _push(self, value):
        if self._waiters:
            self._waiters.pop(0).send(value)
        else:
            self._queue.append(value)

    def _push_error(self, err: BaseException):
        self._error = err
        waiters, self._waiters = self._waiters, []
        for w in waiters:
            w.send_error(err)


class PromiseStream:
    """Write side: send() any number of values; ref flow/flow.h:833."""

    __slots__ = ("_stream",)

    def __init__(self):
        self._stream = FutureStream()

    @property
    def future_stream(self) -> FutureStream:
        return self._stream

    def send(self, value=None):
        self._stream._push(value)

    def send_error(self, err: BaseException):
        self._stream._push_error(err)

    def pop(self) -> Future:
        return self._stream.pop()

    def is_ready(self) -> bool:
        return self._stream.is_ready()
