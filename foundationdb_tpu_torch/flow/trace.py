"""Structured trace events: the ``TraceEvent("Name").detail("K", v).log()``
builder and the collector it emits to.

The port's own copy of the reference package's ``flow/trace.py`` (itself
modelled on flow/Trace.h's TraceEvent), with the same event shape
(``{"Type", "Severity", "Time", **details}``) and module API
(``TraceEvent``, ``Severity``, ``TraceCollector``, ``global_collector`` /
``set_global_collector``).  An event goes to the global collector through
``collector.emit(event)`` only, so any object with that method may be
installed, the reference's included.

``Time`` comes from the collector's ``clock`` (a zero-argument callable)
when it has one, else from the clock installed beside it
(``set_global_collector(c, clock=)``, for a collector that has none), else
``time.time()``: the reference stamps its event loop's virtual time and
falls back to the wall clock without a loop, and the port has no loop.
The reference's FDB_TPU_TRACE_RECENT knob is the ``recent=512``
constructor argument.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Callable, Optional


class Severity:
    Debug = 5
    Info = 10
    Warn = 20
    WarnAlways = 30
    Error = 40


class TraceCollector:
    """Destination for trace events.

    In memory (``path=None``) every event is kept in ``events``; with a
    ``path`` events are appended to that file as JSON lines instead.  Both
    keep a bounded ring of the most recent ``recent`` events, which a
    flight-recorder capture dumps."""

    def __init__(self, path: Optional[str] = None, min_severity: int = Severity.Info,
                 recent: int = 512, clock: Optional[Callable[[], float]] = None):
        self.events: list[dict] = []
        self.path = path
        self.min_severity = min_severity
        self.clock = clock
        self._fh = open(path, "a") if path else None  # fdblint: ignore[IO001]: a file sink writes a real file by definition; simulated runs use the in-memory collector (path=None)
        self.counts: dict[str, int] = {}
        self.recent_maxlen = max(1, recent)
        self.recent: deque = deque(maxlen=self.recent_maxlen)

    def emit(self, event: dict):
        if event["Severity"] < self.min_severity:
            return
        self.counts[event["Type"]] = self.counts.get(event["Type"], 0) + 1
        self.recent.append(event)
        if self._fh:
            # Spool only, so long runs stay bounded in memory; the recent
            # ring is the only retention.
            self._fh.write(json.dumps(event) + "\n")
        else:
            self.events.append(event)

    def find(self, type_: str) -> list[dict]:
        """Events of one type: the full list in memory, the recent ring
        only for a file-backed collector (compare with ``counts[type_]``
        where completeness matters)."""
        if self.path is not None:
            return [e for e in self.recent if e["Type"] == type_]
        return [e for e in self.events if e["Type"] == type_]

    def recent_events(self) -> list[dict]:
        """The bounded most-recent window, oldest first."""
        return list(self.recent)

    def clear(self):
        """Reset the in-memory view (events, counts, the recent ring); a
        spool file is left intact."""
        self.events.clear()
        self.counts.clear()
        self.recent.clear()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


_global_collector = TraceCollector()
_global_clock: Optional[Callable[[], float]] = None


def set_global_collector(c, clock: Optional[Callable[[], float]] = None) -> None:
    """Install `c` as the collector every TraceEvent emits to; `clock`
    stamps the events of a collector without a ``clock`` of its own."""
    global _global_collector, _global_clock
    _global_collector = c
    _global_clock = clock


def global_collector():
    return _global_collector


class TraceEvent:
    """Builder: ``TraceEvent("Name").detail("Key", value).log()``, or used
    as a context manager (which logs on exit).  Nothing is emitted unless
    ``log()`` runs."""

    __slots__ = ("type", "severity", "fields", "_collector", "_emitted")

    def __init__(self, type_: str, severity: int = Severity.Info, collector=None):
        self.type = type_
        self.severity = severity
        self.fields: dict[str, Any] = {}
        self._collector = collector or _global_collector
        self._emitted = False

    def detail(self, key: str, value) -> "TraceEvent":
        self.fields[key] = value
        return self

    def error(self, err: BaseException) -> "TraceEvent":
        self.fields["Error"] = str(err)
        if self.severity < Severity.Error:
            self.severity = Severity.Error
        return self

    def log(self, now: Optional[float] = None):
        if self._emitted:
            return
        self._emitted = True
        if now is None:
            clock = getattr(self._collector, "clock", None) or _global_clock
            now = clock() if clock is not None else time.time()  # fdblint: ignore[DET001]: fallback with no clock installed; a simulated run installs its loop's clock on the collector or through set_global_collector(c, clock=loop.now)
        ev = {"Type": self.type, "Severity": self.severity, "Time": now}
        ev.update(self.fields)
        self._collector.emit(ev)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None and "Error" not in self.fields:
            self.fields["Error"] = str(exc)
            self.severity = max(self.severity, Severity.Error)
        self.log()
        return False
