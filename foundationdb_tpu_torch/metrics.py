"""Counters, gauges, histograms and a wall-clock namespace for one subsystem.

The port's own copy of the reference package's ``flow/metrics.py`` (with
``ContinuousSample`` and ``CounterCollection`` from its ``flow/stats.py``,
whose counters a registry may ``adopt``): named counters, gauges and
histograms, read back as one ``snapshot()`` dict (``{"name", ["time"],
"counters", "gauges", "histograms"}``), and ``emit_metrics``, the actor
that traces a registry periodically.  A histogram keeps exact aggregates
(count, sum, mean, min, max); a registry built with an ``rng`` (an event
loop's DeterministicRandom) also gives each histogram a sample reservoir,
so its summary has percentiles.  A registry built without one, as the
conflict engines' are, keeps the aggregates only.  A snapshot carries
``time`` when the caller passes ``now`` or when a port event loop is set
(its virtual time), as the reference's does.

Wall-clock measurements (``record_wall``) live in a separate namespace
that ``snapshot()`` leaves out unless ``include_wall=True``, so two runs
of the same stream give equal snapshots.
"""

from __future__ import annotations

import json
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
    """A monotone integer count, with the rate since the last query."""

    __slots__ = ("name", "value", "_last", "_last_t")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._last = 0
        # The rate baseline is set at the first rate query, so a counter
        # made late in a run does not report a rate "since time zero".
        self._last_t = None

    def add(self, n: int = 1) -> None:
        self.value += n

    def rate_since_last(self, now: float) -> float:
        if self._last_t is None:
            self._last = self.value
            self._last_t = now
            return 0.0
        dt = now - self._last_t
        r = (self.value - self._last) / dt if dt > 0 else 0.0
        self._last = self.value
        self._last_t = now
        return r


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class ContinuousSample:
    """Bounded reservoir of a metric's recent values with percentile
    queries (fdbrpc/ContinuousSample.h).  Draws from the caller's
    DeterministicRandom once the reservoir is full, so sampling replays
    from the seed."""

    __slots__ = ("size", "rng", "samples", "n", "_min", "_max")

    def __init__(self, rng, size: int = 500):
        self.size = size
        self.rng = rng
        self.samples: list = []
        self.n = 0
        self._min = None
        self._max = None

    def add(self, x: float) -> None:
        self.n += 1
        self._min = x if self._min is None else min(self._min, x)
        self._max = x if self._max is None else max(self._max, x)
        if len(self.samples) < self.size:
            self.samples.append(x)
        elif self.rng.random01() < self.size / self.n:
            self.samples[int(self.rng.random_int(0, self.size))] = x

    def percentile(self, p: float):
        if not self.samples:
            return None
        s = sorted(self.samples)
        return s[min(len(s) - 1, int(p * len(s)))]

    def summary(self) -> dict:
        """The status document's latency shape."""
        return {
            "count": self.n,
            "min": self._min,
            "median": self.percentile(0.5),
            "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
            "max": self._max,
        }


class CounterCollection:
    """A role's named counters (flow/Stats.h's CounterCollection), which
    its registry adopts."""

    def __init__(self, name: str):
        self.name = name
        self.counters: Dict[str, Counter] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def add(self, name: str, n: int = 1) -> None:
        self.counter(name).add(n)

    def __getitem__(self, name: str) -> int:
        return self.counter(name).value

    def snapshot(self) -> Dict[str, int]:
        return {k: c.value for k, c in self.counters.items()}


class BoundedHistogram:
    """Exact aggregates of a stream of values and, with an ``rng``, a
    ContinuousSample of them whose percentiles the summary adds."""

    __slots__ = ("name", "count", "total", "_min", "_max", "_sample")

    def __init__(self, name: str, rng=None, size: int = 500):
        self.name = name
        self.count = 0
        self.total = 0.0
        self._min = None
        self._max = None
        self._sample = ContinuousSample(rng, size) if rng is not None else None

    def add(self, x) -> None:
        self.count += 1
        self.total += x
        self._min = x if self._min is None else min(self._min, x)
        self._max = x if self._max is None else max(self._max, x)
        if self._sample is not None:
            self._sample.add(x)

    def summary(self) -> dict:
        out = {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count if self.count else None,
            "min": self._min,
            "max": self._max,
        }
        if self._sample is not None:
            out["median"] = self._sample.percentile(0.5)
            out["p90"] = self._sample.percentile(0.90)
            out["p99"] = self._sample.percentile(0.99)
        return out


class MetricsRegistry:
    """Named counters, gauges and histograms (get-or-create), plus wall
    seconds.  ``rng`` (an event loop's DeterministicRandom, never a
    wall-seeded source) gives the histograms their reservoirs."""

    def __init__(self, name: str, rng=None):
        self.name = name
        self.rng = rng
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, BoundedHistogram] = {}
        # (count, total seconds) per name; never in a default snapshot.
        self.wall: Dict[str, list] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def adopt(self, counter: Counter) -> Counter:
        """Register an existing Counter (a role's CounterCollection's) under
        its own name, so both surfaces read one value.  The adopter must be
        the counter's only rate emitter (``rate_since_last`` resets a
        shared baseline)."""
        self.counters[counter.name] = counter
        return counter

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, size: int = 500) -> BoundedHistogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = BoundedHistogram(name, rng=self.rng, size=size)
        return h

    def record_wall(self, name: str, seconds: float) -> None:
        ent = self.wall.setdefault(name, [0, 0.0])
        ent[0] += 1
        ent[1] += seconds

    def snapshot(self, now: Optional[float] = None,
                 include_wall: bool = False) -> dict:
        """Point-in-time view; ``time`` is ``now``, else the current port
        event loop's virtual time, else absent (never the wall clock)."""
        if now is None:
            from .flow.eventloop import _current_loop

            now = _current_loop.now() if _current_loop is not None else None
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

    def snapshot_json(self, now: Optional[float] = None,
                      include_wall: bool = False) -> str:
        """Canonical byte form of ``snapshot()``."""
        return json.dumps(self.snapshot(now=now, include_wall=include_wall),
                          sort_keys=True, separators=(",", ":"))


async def emit_metrics(registry: MetricsRegistry, process, interval: float = 5.0):
    """Periodic emitter actor (flow/Stats.h's traceCounters): one
    ``<Name>Metrics`` TraceEvent per ``interval`` virtual seconds with
    every counter (and its rate), gauge and histogram summary.  Emits
    nothing wall-derived."""
    from .flow.trace import TraceEvent

    loop = process.network.loop
    while True:
        await loop.delay(interval)
        now = loop.now()
        ev = TraceEvent(f"{registry.name}Metrics")
        for name, c in sorted(registry.counters.items()):
            ev.detail(name, c.value)
            ev.detail(f"{name}Rate", round(c.rate_since_last(now), 3))
        for name, g in sorted(registry.gauges.items()):
            ev.detail(name, g.value)
        for name, h in sorted(registry.histograms.items()):
            s = h.summary()
            ev.detail(f"{name}Count", s["count"])
            ev.detail(f"{name}Mean", s["mean"])
            ev.detail(f"{name}Max", s["max"])
        ev.log(now=now)
