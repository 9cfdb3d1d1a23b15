"""Counters, gauges, histograms and a wall-clock namespace for one subsystem.

The deterministic part of the reference package's ``MetricsRegistry``
(``flow/metrics.py``): named counters, gauges and histograms, read back as
one ``snapshot()`` dict of the shape the reference's time-series sampler
and status surfaces read (``{"name", ["time"], "counters", "gauges",
"histograms"}``).  A histogram keeps the reference's exact aggregates
(count, sum, mean, min, max) and no sample reservoir, so it has no
percentiles.  There is no event loop here: a snapshot carries ``time``
only when the caller passes ``now``.

Wall-clock measurements (``record_wall``) live in a separate namespace
that ``snapshot()`` leaves out unless ``include_wall=True``, so two runs
of the same stream give equal snapshots.
"""

from __future__ import annotations

import time
from typing import Dict, Optional


def wall_now() -> float:
    """The port's one wall-clock read, for the wall namespace
    (``record_wall``), span wall stamps and timers that report seconds.

    One value derived from it does reach a decision: the mirror fallback
    timers (``_cpu_fallback_recent`` in ``conflict/api.py`` and
    ``parallel/sharded_resolver.py``) give ``backend_signal()``'s
    ``cpu_mirror_tps``, which the reference's ratekeeper clamps admission
    to in degraded mode when ``ratekeeper_use_measured_cpu_tps`` is set
    (off in simulation).  Nothing else read here feeds a verdict, a
    deterministic snapshot or a simulator's virtual time.  This funnel's
    pragma ends every DET101 chain through it, so a new caller that makes
    a decision on its value is not flagged: keep such callers out."""
    return time.perf_counter()  # fdblint: ignore[DET001]: wall namespace, span wall stamps and reported timings; the one decision input is backend_signal's cpu_mirror_tps, read by the ratekeeper only in degraded mode with ratekeeper_use_measured_cpu_tps set (off in simulation)


class Counter:
    """A monotone integer count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def add(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Exact aggregates of a stream of values: the reference's
    ``BoundedHistogram`` without an rng."""

    __slots__ = ("name", "count", "total", "_min", "_max")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self._min = None
        self._max = None

    def add(self, x) -> None:
        self.count += 1
        self.total += x
        self._min = x if self._min is None else min(self._min, x)
        self._max = x if self._max is None else max(self._max, x)

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count if self.count else None,
            "min": self._min,
            "max": self._max,
        }


class MetricsRegistry:
    """Named counters, gauges and histograms (get-or-create), plus wall
    seconds."""

    def __init__(self, name: str):
        self.name = name
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        # (count, total seconds) per name; never in a default snapshot.
        self.wall: Dict[str, list] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name)
        return h

    def record_wall(self, name: str, seconds: float) -> None:
        ent = self.wall.setdefault(name, [0, 0.0])
        ent[0] += 1
        ent[1] += seconds

    def snapshot(self, now: Optional[float] = None,
                 include_wall: bool = False) -> dict:
        out: dict = {"name": self.name}
        if now is not None:
            out["time"] = now
        out["counters"] = {k: c.value for k, c in sorted(self.counters.items())}
        out["gauges"] = {k: g.value for k, g in sorted(self.gauges.items())}
        out["histograms"] = {
            k: h.summary() for k, h in sorted(self.histograms.items())
        }
        if include_wall:
            out["wall"] = {
                k: {"count": v[0], "seconds": v[1]}
                for k, v in sorted(self.wall.items())
            }
        return out
