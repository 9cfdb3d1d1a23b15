"""Flight recorder: a triggered black-box capture of the telemetry window
around an incident.

The port's own copy of the reference package's ``flow/flight_recorder.py``
with the same module API (``maybe_trigger``, ``artifact_json``,
``global_flight_recorder`` / ``set_global_flight_recorder``).  On a
trigger it freezes one deterministic artifact into a bounded ring:

    {capture_seq, trigger, time, detail, transitions,
     timeseries:    the recorder's time-series window,
     recent_events: the last ``window`` events of the global TraceCollector,
     spans:         the last ``window`` spans a role of the global SpanHub}

Every key of the reference's artifact is kept.  ``timeseries`` is the
last ``window`` samples of each series of the port's global time-series
hub (``flow/timeseries.py``, ``{}`` while no sampler has run), unless the
recorder is given a zero-argument ``timeseries=`` source returning that
section.

Trigger sites of the port: a breaker opening (ok -> degraded,
``breaker_open``), a confirmed mirror divergence (``mirror_divergence``),
a committed reshard (``reshard``), and the Resolver's sustained pipeline
stall (``pipeline_stall``) and contention spike (``contention_spike``).
Each calls ``maybe_trigger(kind,
detail=, transitions=, source=)``, which goes to the global recorder's
``trigger`` only, so any object with that method may be installed, the
reference's included.  A trigger is gated by a per-(kind, source) cooldown
on the recorder's ``clock`` (default: the current port event loop's
virtual time); without a clock or a loop there is none, as the reference
applies none without an event loop.  Explicit ``capture()`` calls bypass
the cooldown and the enable switch.

Settings the reference reads from environment knobs are constructor
arguments with its defaults: ``enabled=True`` (FDB_TPU_FLIGHTREC; a
disabled recorder's ``trigger`` returns None and counts nothing),
``max_captures=16``, ``window=64`` and ``cooldown=5.0``
(FDB_TPU_FLIGHTREC_CAPTURES, _WINDOW, _COOLDOWN).
"""

from __future__ import annotations

import json
from collections import deque
from typing import Callable, Dict, Optional


def artifact_json(artifact: dict) -> str:
    """Canonical byte form of one capture."""
    return json.dumps(artifact, sort_keys=True, separators=(",", ":"))


class FlightRecorder:
    """Bounded ring of incident captures plus per-(kind, source) trigger
    cooldowns."""

    def __init__(
        self,
        max_captures: int = 16,
        window: int = 64,
        cooldown: float = 5.0,
        enabled: bool = True,
        clock: Optional[Callable[[], float]] = None,
        timeseries: Optional[Callable[[], dict]] = None,
    ):
        self.window = max(1, window)
        self.cooldown = float(cooldown)
        self.enabled = enabled
        self.clock = clock
        self.timeseries = timeseries
        self.captures: deque = deque(maxlen=max(1, max_captures))
        self.capture_seq = 0  # lifetime count (the ring may have dropped some)
        self.trigger_counts: Dict[str, int] = {}
        self._last_trigger_time: Dict[tuple, float] = {}

    def _now(self) -> Optional[float]:
        if self.clock is not None:
            return self.clock()
        from .eventloop import _current_loop

        return _current_loop.now() if _current_loop is not None else None

    # -- capture --
    def capture(self, trigger: str, detail=None, transitions=None,
                now: Optional[float] = None) -> dict:
        """Freeze one artifact now (no cooldown, no enable switch): the
        time-series window, the recent trace events, the recent span window,
        the caller's transition-log snapshot and the trigger context."""
        from .spans import global_span_hub
        from .timeseries import global_timeseries
        from .trace import global_collector

        if now is None:
            now = self._now()
            if now is None:
                now = 0.0
        if callable(transitions):
            # A lazily built snapshot: resolved only for captures that happen.
            transitions = transitions()
        self.capture_seq += 1
        artifact = {
            "capture_seq": self.capture_seq,
            "trigger": trigger,
            "time": now,
            "detail": detail,
            "transitions": transitions,
            "timeseries": (self.timeseries() if self.timeseries is not None
                           else global_timeseries().window_dict(last_n=self.window)),
            "recent_events": global_collector().recent_events()[-self.window:],
            "spans": global_span_hub().window_dict(last_n=self.window),
        }
        self.captures.append(artifact)
        return artifact

    def trigger(self, kind: str, detail=None, transitions=None,
                source=None) -> Optional[dict]:
        """Cooldown-gated capture: at most one per (kind, source) per
        ``cooldown`` seconds of the recorder's clock (a flapping signal must
        not churn the ring; two sources are two incidents).  Suppressed
        triggers still count.  ``transitions`` may be a zero-argument
        callable, resolved only for an admitted capture.  The cooldown
        applies only with a clock and a non-decreasing stamp: a stamp that
        went backwards is a new run's."""
        if not self.enabled:
            return None
        self.trigger_counts[kind] = self.trigger_counts.get(kind, 0) + 1
        now = self._now()
        if now is not None:
            key = (kind, source)
            last = self._last_trigger_time.get(key)
            if last is not None and 0 <= now - last < self.cooldown:
                return None
            self._last_trigger_time[key] = now
        return self.capture(kind, detail=detail, transitions=transitions, now=now)

    # -- surfaces --
    def status_section(self) -> dict:
        """Capture inventory, never the artifacts themselves."""
        return {
            "captures": len(self.captures),
            "total_triggers": dict(sorted(self.trigger_counts.items())),
            "capture_seq": self.capture_seq,
            "window": self.window,
            "last_capture": (
                {
                    "trigger": self.captures[-1]["trigger"],
                    "time": self.captures[-1]["time"],
                    "capture_seq": self.captures[-1]["capture_seq"],
                }
                if self.captures
                else None
            ),
        }

    def clear(self):
        self.captures.clear()
        self.trigger_counts.clear()
        self._last_trigger_time.clear()
        self.capture_seq = 0


_global_recorder = FlightRecorder()


def set_global_flight_recorder(rec) -> None:
    global _global_recorder
    _global_recorder = rec


def global_flight_recorder():
    return _global_recorder


def maybe_trigger(kind: str, detail=None, transitions=None, source=None) -> Optional[dict]:
    """The trigger sites' entry point: a cooldown-gated capture on the
    current global recorder.  Call sites pass their transition log (or a
    thunk building it) and their own identity as ``source``."""
    return _global_recorder.trigger(kind, detail=detail, transitions=transitions,
                                    source=source)
