"""Structured spans: begin/end intervals over the resolver's batch path.

The port's own copy of the reference package's ``flow/spans.py``, with the
same module API (``begin_span``, ``current_span``, ``use_span``,
``instant``, ``global_span_hub`` / ``set_global_span_hub``) and the same
span and ring shapes, so ``spans_json()`` of the same stream is
byte-identical through either package.

A Span is (name, role, parent, start/end on the hub's clock, a pair of
monotonic event-sequence stamps, attributes).  Roles are tracks, one per
instrumented object; parent links make a batch's stage structure explicit:
a resolver batch span owns its encode / dispatch / device / sync / apply /
reply children, and two overlapping device spans are the pipeline overlap.

Two clocks:

* ``start``/``stop`` come from the hub's ``clock`` (a zero-argument
  callable; without one they read 0.0, as the reference's do with no event
  loop) and ``seq``/``end_seq`` from the hub's event counter.  Both are
  deterministic, so the same stream gives byte-identical ``spans_json()``.
  The seq pair is the interleaving clock: host phases take no virtual
  time, and the counter still shows batch N+1's encode inside batch N's
  device window.
* ``wall_start``/``wall_end`` are ``metrics.wall_now()`` reads for real-mode
  timing.  ``to_dict()`` / ``spans_json()`` leave them out by default.

Parenting uses an explicit argument or the hub's current-span stack.  The
stack is only valid across synchronous sections (``with`` a span, or
``use_span``); a span that outlives them (a parked pipeline batch, the
device in-flight window) is held by reference and ``.end()``ed explicitly.

Completed spans land in a bounded per-role ring on the global hub (swap it
with ``set_global_span_hub``).  Every call site of the port goes through
the module functions, and they use only ``hub.begin(name, role=, parent=,
attrs=)`` and ``hub.current()``: any hub with those two methods may be
installed, the reference's included.

Settings the reference reads from environment knobs are constructor
arguments with the reference's defaults: ``SpanHub(enabled=True)``
(FDB_TPU_SPANS; a disabled hub's ``begin`` returns ``NULL_SPAN``) and
``per_role=4096`` (FDB_TPU_SPANS_PER_ROLE).  The reference stamps the
event loop's seed into the json header; the port has no loop, so ``seed``
is None unless the hub is given one.
"""

from __future__ import annotations

import json
from collections import deque
from typing import Callable, Dict, List, Optional

from ..metrics import wall_now


class Span:
    """One interval.  Begin via ``begin_span`` / ``hub.begin``; end via
    ``.end()`` or by using the span as a context manager (which also pushes
    it on the hub's current-span stack for child parenting)."""

    __slots__ = ("span_id", "parent_id", "name", "role", "start", "stop",
                 "seq", "end_seq", "attrs", "wall_start", "wall_end",
                 "_hub")

    def __init__(self, hub, span_id, parent_id, name, role, start, seq, attrs):
        self._hub = hub
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.role = role
        self.start = start
        self.seq = seq
        self.stop = None
        self.end_seq = None
        self.attrs: dict = attrs if attrs is not None else {}
        self.wall_start = wall_now()
        self.wall_end = None

    @property
    def done(self) -> bool:
        return self.stop is not None

    def annotate(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    def end(self, attrs: Optional[dict] = None) -> None:
        """Close the span and commit it to the hub's per-role ring.  The
        first end wins (a fault path and its cleanup may both try)."""
        if self.stop is not None:
            return
        if attrs:
            self.attrs.update(attrs)
        self._hub._finish(self)

    def to_dict(self, include_wall: bool = False) -> dict:
        out = {
            "id": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "role": self.role,
            "start": self.start,
            "end": self.stop,
            "seq": self.seq,
            "end_seq": self.end_seq,
            "attrs": dict(self.attrs),
        }
        if include_wall:
            out["wall_start"] = self.wall_start
            out["wall_end"] = self.wall_end
        return out

    def __enter__(self) -> "Span":
        self._hub._push(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._hub._pop(self)
        if exc is not None and "error" not in self.attrs:
            self.attrs["error"] = type(exc).__name__
        self.end()
        return False


class _NullSpan:
    """Inert stand-in a disabled hub returns, so call sites need no
    branches.  Shared singleton; every operation is a no-op."""

    __slots__ = ()
    span_id = None
    parent_id = None
    name = role = ""
    start = stop = None
    seq = end_seq = None
    wall_start = wall_end = None
    attrs: dict = {}
    done = True

    def annotate(self, key, value):
        return self

    def end(self, attrs=None):
        pass

    def to_dict(self, include_wall: bool = False) -> dict:
        return {}

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


class SpanHub:
    """Per-role bounded rings of COMPLETED spans, the current-span stack and
    the monotonic event-sequence counter (the interleaving clock).

    ``clock`` is a zero-argument callable giving span timestamps (default:
    0.0, the reference's stamp without an event loop); ``seed`` goes into
    the ``spans_json()`` header."""

    def __init__(self, per_role: int = 4096, enabled: bool = True,
                 clock: Optional[Callable[[], float]] = None,
                 seed: Optional[int] = None):
        self.per_role = per_role
        self.enabled = enabled
        self.clock = clock
        self.rings: Dict[str, deque] = {}
        self._stack: List[Span] = []
        self._seq = 0
        self.begun = 0  # lifetime spans begun (rings may have dropped some)
        self._given_seed = seed
        self.seed: Optional[int] = seed

    def _now(self) -> float:
        return self.clock() if self.clock is not None else 0.0

    # -- lifecycle --
    def begin(self, name: str, role: Optional[str] = None,
              parent: Optional[Span] = None, attrs: Optional[dict] = None):
        if not self.enabled:
            return NULL_SPAN
        if parent is None and self._stack:
            parent = self._stack[-1]
        if isinstance(parent, _NullSpan):
            parent = None
        if role is None:
            role = parent.role if parent is not None else "span"
        self._seq += 1
        self.begun += 1
        return Span(
            self, self.begun,
            parent.span_id if parent is not None else None,
            name, role, self._now(), self._seq, attrs,
        )

    def _finish(self, span: Span) -> None:
        self._seq += 1
        span.end_seq = self._seq
        span.stop = self._now()
        span.wall_end = wall_now()
        ring = self.rings.get(span.role)
        if ring is None:
            ring = self.rings[span.role] = deque(maxlen=self.per_role)
        ring.append(span)

    # -- current-span stack (synchronous sections only) --
    def _push(self, span: Span) -> None:
        self._stack.append(span)

    def _pop(self, span: Span) -> None:
        if self._stack and self._stack[-1] is span:
            self._stack.pop()
        elif span in self._stack:  # tolerate mismatched exits
            self._stack.remove(span)

    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    # -- read surfaces --
    def spans(self, role: Optional[str] = None,
              name: Optional[str] = None) -> List[Span]:
        """Completed spans, oldest first: one role's ring, or every ring in
        sorted role order; optionally only those of one name."""
        if role is not None:
            out = list(self.rings.get(role, ()))
        else:
            out = [s for r in sorted(self.rings) for s in self.rings[r]]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def window_dict(self, last_n: Optional[int] = None,
                    include_wall: bool = False) -> dict:
        """role -> [span dict, ...] (oldest first), optionally the last N
        per role: the flight recorder's capture shape."""
        out: Dict[str, List[dict]] = {}
        for role in sorted(self.rings):
            spans = list(self.rings[role])
            if last_n is not None:
                spans = spans[-last_n:]
            out[role] = [s.to_dict(include_wall=include_wall) for s in spans]
        return out

    def spans_json(self, last_n: Optional[int] = None) -> str:
        """Canonical byte form (wall fields excluded)."""
        return json.dumps(
            {"seed": self.seed, "spans": self.window_dict(last_n=last_n)},
            sort_keys=True,
            separators=(",", ":"),
        )

    def status_section(self) -> dict:
        return {
            "roles": {r: len(ring) for r, ring in sorted(self.rings.items())},
            "begun": self.begun,
            "per_role": self.per_role,
        }

    def clear(self) -> None:
        self.rings.clear()
        self._stack.clear()
        self._seq = 0
        self.begun = 0
        self.seed = self._given_seed


_global_hub = SpanHub()


def set_global_span_hub(hub) -> None:
    global _global_hub
    _global_hub = hub


def global_span_hub():
    return _global_hub


def begin_span(name: str, role: Optional[str] = None,
               parent: Optional[Span] = None, attrs: Optional[dict] = None):
    """Begin one span on the CURRENT global hub (``NULL_SPAN`` when it is
    disabled).  The result must be context-managed, ``.end()``ed, or stored
    for a later end."""
    return _global_hub.begin(name, role=role, parent=parent, attrs=attrs)


def current_span() -> Optional[Span]:
    """The innermost span pushed by a ``with`` block on the current hub
    (None outside any).  Synchronous sections only."""
    return _global_hub.current()


class use_span:
    """Push an EXISTING (still open) span for a synchronous section so that
    nested ``begin_span`` calls parent to it, without ending it on exit.
    ``use_span(None)`` and ``use_span(NULL_SPAN)`` are no-ops."""

    __slots__ = ("_span",)

    def __init__(self, span):
        self._span = None if span is None or span.span_id is None else span

    def __enter__(self):
        if self._span is not None:
            self._span._hub._push(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        if self._span is not None:
            self._span._hub._pop(self._span)
        return False


def instant(name: str, role: Optional[str] = None,
            attrs: Optional[dict] = None) -> None:
    """Zero-width marker span (breaker transitions, reshards): begins and
    ends at once, landing in the ring like any completed span."""
    begin_span(name, role=role, attrs=attrs).end()


# -- derived metrics: pipeline overlap and span latency stages --


def interval_overlap(intervals: List[tuple]) -> tuple:
    """(total, union) measure of a list of (begin, end) intervals.  The
    overlap efficiency is (total - union) / total: the share of device time
    during which another device interval was also open (0.0 for a
    synchronous depth-1 stream, towards 0.5 for a double-buffered one)."""
    total = 0.0
    union = 0.0
    hwm = None
    for b, e in sorted(intervals):
        d = e - b
        if d <= 0:
            continue
        total += d
        if hwm is None or b >= hwm:
            union += d
            hwm = e
        elif e > hwm:
            union += e - hwm
            hwm = e
    return total, union


def overlap_efficiency(spans: List[Span], axis: str = "seq") -> float:
    """Overlapped time / total time over the given spans.  axis="seq" uses
    the deterministic event-sequence stamps, "wall" the perf_counter reads,
    "vt" the hub clock's."""
    keys = {
        "seq": lambda s: (s.seq, s.end_seq),
        "wall": lambda s: (s.wall_start, s.wall_end),
        "vt": lambda s: (s.start, s.stop),
    }[axis]
    intervals = [keys(s) for s in spans if s.done and keys(s)[0] is not None]
    total, union = interval_overlap(intervals)
    if total <= 0:
        return 0.0
    return (total - union) / total


def percentile(samples: List[float], p: float) -> Optional[float]:
    """Exact percentile by the reference's index rule."""
    if not samples:
        return None
    s = sorted(samples)
    return s[min(len(s) - 1, int(p * len(s)))]


def span_latency_summary(hub=None, axis: str = "vt") -> dict:
    """role -> span name -> {count, p50, p90, p99, max} over completed
    spans' durations on the hub clock ("vt") or the wall clock ("wall")."""
    hub = hub if hub is not None else _global_hub
    out: Dict[str, dict] = {}
    for role in sorted(hub.rings):
        by_name: Dict[str, List[float]] = {}
        for s in hub.rings[role]:
            if not s.done:
                continue
            if axis == "wall":
                d = s.wall_end - s.wall_start if s.wall_end is not None else None
            else:
                d = s.stop - s.start if s.stop is not None else None
            if d is None:
                continue
            by_name.setdefault(s.name, []).append(d)
        stages = {}
        for name in sorted(by_name):
            samples = by_name[name]
            stages[name] = {
                "count": len(samples),
                "p50": percentile(samples, 0.5),
                "p90": percentile(samples, 0.90),
                "p99": percentile(samples, 0.99),
                "max": max(samples),
            }
        out[role] = stages
    return out
