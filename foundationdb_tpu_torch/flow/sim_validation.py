"""Simulation-only invariant recorder and the orphaned-wait scan.

The port's copy of the reference package's ``flow/sim_validation.py``
(modelled on fdbrpc/sim_validation.{h,cpp}): roles record monotone
promises (``mark_at_least``: "commits through V were acknowledged") that
the simulation later checks (``expect_at_least``); the state hangs off the
event loop, so two simulated clusters in one process do not interfere.
``orphaned_waits`` names tasks parked on a promise nobody holds any more
(the event loop calls it when a loop runs dry awaiting a future).  It sees
promises only while ``future.track_promise_refs(True)`` is on; otherwise
it finds nothing.
"""

from __future__ import annotations

import gc
from typing import List, Tuple


def _state(loop) -> dict:
    st = getattr(loop, "_sim_validation", None)
    if st is None:
        st = loop._sim_validation = {}
    return st


def mark_at_least(loop, key: str, value: int):
    """Record a monotone promise, e.g. 'commits through V were acked'."""
    st = _state(loop)
    if value > st.get(key, -(1 << 62)):
        st[key] = value


def marked(loop, key: str) -> int:
    return _state(loop).get(key, -(1 << 62))


def expect_at_least(loop, key: str, value: int, context: str = ""):
    """The checking side: `value` must cover every marked promise (e.g. a
    recovery's epoch cut must not truncate below an acked commit)."""
    m = _state(loop).get(key, None)
    if m is not None and value < m:
        raise AssertionError(
            f"sim_validation: {key} promised {m} but observed {value}"
            + (f" ({context})" if context else "")
        )


def orphaned_waits(loop) -> List[Tuple[str, str]]:
    """[(task_name, description)] for live tasks parked on a future whose
    paired Promise was dropped.  Futures with a live pending timer are
    excluded (the loop would have fired them had it kept running); tasks
    awaiting futures with no recorded promise (timers, other Tasks) are
    skipped.  Empty when track_promise_refs is off."""
    # Strong references first: a fire-and-forget task parked on a dropped
    # promise is reachable only through the task<->future callback cycle,
    # and gc.collect() would reap it out of the WeakSet before the scan.
    tasks = list(getattr(loop, "_spawned", ()))
    gc.collect()
    out: List[Tuple[str, str]] = []
    for t in tasks:
        if t.is_ready():
            continue
        f = getattr(t, "_waiting_on", None)
        if f is None or f.is_ready():
            continue
        cell = getattr(f, "timer_cell", None)
        if cell is not None and cell[0] is not None:
            continue  # live timer: would fire
        ref = getattr(f, "promise_ref", None)
        if ref is not None and ref() is None:
            out.append((t.name, "promise dropped; zero remaining senders"))
    out.sort()
    return out
