"""Deterministic time series: a bounded ring of each role's registry deltas.

The port's own copy of the reference package's ``flow/timeseries.py``.
Each role's MetricsRegistry is sampled on a virtual-time cadence into a
fixed-size ring of deltas:

    sample = {time, counters: {name: delta since last sample},
              gauges: {name: value},
              histograms: {name: {count/sum deltas + current quantiles}}}

Samples read only virtual time and registry state, so two same-seed runs
give byte-identical ``window_json()``; wall-namespace measurements are
never sampled.  Roles spawn ``sample_loop`` actors (``spawn_sampler``) that
write into the process-global ``TimeSeriesHub`` (swap it per run with
``set_global_timeseries``); the flight recorder's captures read that hub.
A series resets when a different registry object starts reporting under
its name.

Settings the reference reads from environment knobs are arguments with its
defaults: ``TimeSeriesHub(window=240)`` (FDB_TPU_TIMESERIES_WINDOW),
``interval=1.0`` (FDB_TPU_TIMESERIES_INTERVAL) and ``spawn_sampler``'s
``enabled=True`` (FDB_TPU_TIMESERIES).
"""

from __future__ import annotations

import json
from collections import deque
from typing import Dict, List, Optional

# Histogram quantile keys carried per sample when the registry's
# histograms have an rng-backed reservoir (see BoundedHistogram.summary).
_QUANTILES = ("median", "p90", "p99")


def snapshot_delta(prev: Optional[dict], cur: dict) -> dict:
    """Delta between two MetricsRegistry.snapshot() dicts: counter value
    deltas, histogram count/sum deltas (+ the CURRENT quantiles — a
    reservoir has no subtractable form), gauges as-is.  `prev=None`
    means "no baseline": every delta is the current total.  Shared by
    the sampler and `cli metrics --diff` so the two can never disagree
    about what a delta is."""
    pc = prev.get("counters", {}) if prev else {}
    ph = prev.get("histograms", {}) if prev else {}
    out: dict = {
        "counters": {
            k: v - pc.get(k, 0) for k, v in cur.get("counters", {}).items()
        },
        "gauges": dict(cur.get("gauges", {})),
        "histograms": {},
    }
    for k, h in cur.get("histograms", {}).items():
        p = ph.get(k, {})
        d = {
            "count": h["count"] - p.get("count", 0),
            "sum": h["sum"] - p.get("sum", 0.0),
        }
        for q in _QUANTILES:
            if q in h:
                d[q] = h[q]
        out["histograms"][k] = d
    return out


class TimeSeries:
    """One role's bounded sample history + the previous-snapshot baseline
    the next delta is computed against."""

    __slots__ = ("name", "samples", "_prev", "_source", "resets")

    def __init__(self, name: str, window: int):
        self.name = name
        self.samples: deque = deque(maxlen=window)
        self._prev: Optional[dict] = None
        # The registry object the baseline belongs to — held as a STRONG
        # reference (one registry per series name, trivial memory): an
        # `id()` comparison would miss the reset when the predecessor is
        # garbage-collected and CPython reuses its address, producing
        # negative deltas against a dead generation's totals.
        self._source = None
        self.resets = 0  # source-object changes observed (diagnostic)

    def record(self, registry, now: Optional[float]) -> dict:
        if self._source is not None and self._source is not registry:
            # A different registry object took this name (re-recruit, or a
            # second cluster in one process): restart the delta baseline.
            self.samples.clear()
            self._prev = None
            self.resets += 1
        self._source = registry
        snap = registry.snapshot(now=now)
        sample = snapshot_delta(self._prev, snap)
        sample["time"] = snap.get("time")
        self._prev = snap
        self.samples.append(sample)
        return sample


class TimeSeriesHub:
    """name -> TimeSeries, the process-global collection point (swap per
    run like the global trace collector)."""

    def __init__(self, window: int = 240):
        self.window = max(2, window)
        self.series: Dict[str, TimeSeries] = {}

    def record(self, name: str, registry, now: Optional[float] = None) -> dict:
        ts = self.series.get(name)
        if ts is None:
            ts = self.series[name] = TimeSeries(name, self.window)
        return ts.record(registry, now)

    def window_dict(self, last_n: Optional[int] = None) -> dict:
        """name -> [sample, ...] (oldest first), optionally only the last
        N samples of each series — the flight recorder's capture shape."""
        out: Dict[str, List[dict]] = {}
        for name in sorted(self.series):
            samples = list(self.series[name].samples)
            if last_n is not None:
                samples = samples[-last_n:]
            out[name] = samples
        return out

    def window_json(self, last_n: Optional[int] = None) -> str:
        """Canonical byte form — what the same-seed determinism gate
        compares."""
        return json.dumps(
            self.window_dict(last_n=last_n),
            sort_keys=True,
            separators=(",", ":"),
        )

    def clear(self):
        self.series.clear()


_global_hub = TimeSeriesHub()


def set_global_timeseries(hub: TimeSeriesHub):
    global _global_hub
    _global_hub = hub


def global_timeseries() -> TimeSeriesHub:
    return _global_hub


async def sample_loop(name: str, registry, process, interval: float = 1.0):
    """Periodic sampler actor: one delta sample of `registry` into the
    CURRENT global hub every `interval` virtual seconds (at least 0.05).
    Read-only and rng-free, so spawning it perturbs no sim decision; it
    re-reads the global hub each tick, so a harness that swaps in a fresh
    hub starts collecting at once."""
    loop = process.network.loop
    interval = max(0.05, float(interval))
    while True:
        await loop.delay(interval)
        global_timeseries().record(name, registry, now=loop.now())


def spawn_sampler(process, name: str, registry, enabled: bool = True,
                  interval: float = 1.0):
    """Spawn the sampler actor for one role registry, unless disabled.
    Returns the task (or None when disabled)."""
    if not enabled:
        return None
    return process.spawn(sample_loop(name, registry, process, interval), f"ts:{name}")
