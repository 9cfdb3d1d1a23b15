"""Counters, gauges and a wall-clock namespace for one subsystem.

The deterministic part of the reference package's ``MetricsRegistry``
(``flow/metrics.py``): named counters and gauges, read back as one
``snapshot()`` dict of the shape the reference's time-series sampler and
status surfaces read (``{"name", ["time"], "counters", "gauges",
"histograms"}``).  The port keeps no histograms, so that key is always
empty.  There is no event loop here: a snapshot carries ``time`` only when
the caller passes ``now``.

Wall-clock measurements (``record_wall``) live in a separate namespace
that ``snapshot()`` leaves out unless ``include_wall=True``, so two runs
of the same stream give equal snapshots.
"""

from __future__ import annotations

from typing import Dict, Optional


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


class MetricsRegistry:
    """Named counters and gauges (get-or-create), plus wall seconds."""

    def __init__(self, name: str):
        self.name = name
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
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
        out["histograms"] = {}
        if include_wall:
            out["wall"] = {
                k: {"count": v[0], "seconds": v[1]}
                for k, v in sorted(self.wall.items())
            }
        return out
