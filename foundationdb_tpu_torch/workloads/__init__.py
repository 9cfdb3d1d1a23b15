"""Workload framework: composable test workloads with setup/start/check
phases, run concurrently against a simulated cluster.

The port's own copy of the part of the reference package's
``workloads/`` that needs nothing but the client: the runner and the
correctness workloads that check serializability, atomic operations,
versionstamps, read-your-writes, conflict ranges and the database lock.

Ref: fdbserver/workloads/workloads.h:55 (TestWorkload's setup/start/check/
getMetrics contract), tester.actor.cpp:239 (CompoundWorkload running the
spec's stacked workloads concurrently), :778 (runTest driving the phases).
"""

from .base import TestWorkload, run_workloads
from .cycle import CycleWorkload
from .invariants import AtomicLedgerWorkload, WriteSkewWorkload
from .atomic_ops import AtomicOpsWorkload
from .serializability import SerializabilityWorkload
from .versionstamp import VersionStampWorkload
from .lock_database import LockDatabaseWorkload
from .increment import IncrementWorkload
from .conflict_range import ConflictRangeWorkload
from .ryow import RyowCorrectnessWorkload

__all__ = [
    "TestWorkload",
    "run_workloads",
    "CycleWorkload",
    "AtomicLedgerWorkload",
    "WriteSkewWorkload",
    "AtomicOpsWorkload",
    "SerializabilityWorkload",
    "VersionStampWorkload",
    "LockDatabaseWorkload",
    "IncrementWorkload",
    "ConflictRangeWorkload",
    "RyowCorrectnessWorkload",
]
