"""Region marks for the structural check of the device programs.

The kernel wrappers (conflict/kernels.py) mark their region, the CUDA
launch or the plain twin alike, and the tiered step marks its major
compaction.  ``OBSERVER`` is None except while tools/lint/torchir.py
records a program: then ``region`` tells it where the program is and
``note_launch`` that a kernel launched.  Unobserved, a mark costs one
global read.
"""

from __future__ import annotations

from contextlib import contextmanager

OBSERVER = None


@contextmanager
def region(kind: str, name: str):
    """The scope of one region: ``kind`` "kernel" or "compaction"."""
    obs = OBSERVER
    if obs is None:
        yield
        return
    obs.enter(kind, name)
    try:
        yield
    finally:
        obs.exit(kind, name)


def note_launch(name: str) -> None:
    """Tell the observer, if any, that kernel ``name`` launched."""
    if OBSERVER is not None:
        OBSERVER.launch(name)
