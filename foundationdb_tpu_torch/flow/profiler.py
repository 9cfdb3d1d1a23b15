"""Sampling CPU profiler with a runtime toggle.

Ref: flow/Profiler.actor.cpp:99 (SIGPROF-driven PC sampling into an
output file, enabled/disabled at runtime :175) and the CpuProfiler
workload (fdbserver/workloads/CpuProfiler.actor.cpp) that toggles it over
RPC.  The rebuild samples Python stacks from a timer thread (the portable
analog of SIGPROF — signal-based itimers cannot interrupt C-level waits
in CPython any more reliably than a thread can observe them), aggregating
frame counts; the complementary slow-task profiler lives in the event
loop (eventloop.py).

Wall-clock based by design: profiling measures REAL execution cost, so it
is a real-mode tool; under simulation it still works (samples whatever
the interpreter is doing) but is excluded from determinism checks.

The port's own copy of the reference package's ``flow/profiler.py``;
fdblint exempts it where the reference's exempts its own (its sampling
thread reads the interpreter from outside the simulator).
"""

from __future__ import annotations

import sys
import threading
from collections import Counter
from typing import Dict, List, Optional, Tuple


class SamplingProfiler:
    """Periodic whole-interpreter stack sampler.

    start()/stop() may be called repeatedly (the runtime toggle);
    report() aggregates by (function, file:line) like the reference's
    profile output keyed by PC."""

    def __init__(self, interval: float = 0.005, max_depth: int = 64):
        self.interval = interval
        self.max_depth = max_depth
        self.samples: Counter = Counter()  # leaf (func, file, line) -> hits
        self.stacks: Counter = Counter()  # full stack tuple -> hits
        self.total_samples = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self):
        if self.running:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="sampling_profiler", daemon=True
        )
        self._thread.start()

    def stop(self):
        if not self.running:
            return
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._thread = None

    def _run(self):
        main_id = threading.main_thread().ident
        own_id = threading.get_ident()
        while not self._stop.wait(self.interval):
            frames = sys._current_frames()
            frame = frames.get(main_id)
            if frame is None or own_id == main_id:
                continue
            stack: List[Tuple[str, str, int]] = []
            f = frame
            while f is not None and len(stack) < self.max_depth:
                code = f.f_code
                stack.append(
                    (code.co_name, code.co_filename, f.f_lineno)
                )
                f = f.f_back
            with self._lock:
                self.total_samples += 1
                if stack:
                    self.samples[stack[0]] += 1
                    self.stacks[tuple(stack)] += 1

    def clear(self):
        with self._lock:
            self.samples.clear()
            self.stacks.clear()
            self.total_samples = 0

    def report(self, top: int = 20) -> Dict:
        """Aggregated hot functions (leaf samples) + hottest stacks."""
        with self._lock:
            hot = [
                {
                    "function": fn,
                    "file": fi,
                    "line": ln,
                    "samples": n,
                    "fraction": n / max(1, self.total_samples),
                }
                for (fn, fi, ln), n in self.samples.most_common(top)
            ]
            return {
                "total_samples": self.total_samples,
                "interval": self.interval,
                "running": self.running,
                "hot_functions": hot,
            }


# Process-wide instance the runtime toggle drives (ref: the profiler
# being a per-process singleton enabled via ProfilerRequest).
_profiler: Optional[SamplingProfiler] = None


def get_profiler() -> SamplingProfiler:
    global _profiler
    if _profiler is None:
        _profiler = SamplingProfiler()
    return _profiler


def profiler_toggle(enabled: bool, interval: Optional[float] = None) -> dict:
    """The runtime toggle (ref: Profiler.actor.cpp:175 enableProfiler /
    ProfilerRequest handling in worker.actor.cpp)."""
    p = get_profiler()
    if interval is not None:
        p.interval = interval
    if enabled:
        p.start()
    else:
        p.stop()
    return {"running": p.running, "interval": p.interval}
