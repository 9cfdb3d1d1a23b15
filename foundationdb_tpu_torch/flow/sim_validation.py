"""Orphaned-wait scan: tasks parked on a promise nobody holds any more.

The part of the reference package's ``flow/sim_validation.py`` the event
loop calls (``orphaned_waits``, which names such tasks when a loop runs
dry awaiting a future).  It sees promises only while
``future.track_promise_refs(True)`` is on; otherwise it finds nothing.
"""

from __future__ import annotations

import gc
from typing import List, Tuple


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
