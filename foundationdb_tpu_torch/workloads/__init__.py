"""Workload framework: composable test workloads with setup/start/check
phases, run concurrently against a simulated cluster.

The port's own copy of the part of the reference package's
``workloads/`` that needs nothing but the client and the cluster's loop:
the runner; the correctness workloads that check serializability, atomic
operations, versionstamps, read-your-writes, conflict ranges, key
selectors, unreadable ranges, watches, external consistency and the
database lock; the acceptance workloads WriteDuringRead and
RandomReadWrite and the API fuzzer; the replica consistency check; the
transactional load workloads; live configuration churn; the
slow-task probe; and the data distribution workloads (random shard moves
under load, DD's balance, the safe removal of a storage server).

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
from .write_during_read import WriteDuringReadWorkload
from .random_read_write import RandomReadWriteWorkload
from .fuzz_api import FuzzApiWorkload
from .selector_correctness import SelectorCorrectnessWorkload
from .consistency import ConsistencyChecker, check_consistency
from .bulk_load import BulkLoadWorkload
from .index_scan import IndexScanWorkload
from .inventory import InventoryWorkload
from .queue_push import QueuePushWorkload
from .storefront import StorefrontWorkload
from .low_latency import LowLatencyWorkload
from .unreadable import UnreadableWorkload
from .sideband import SidebandWorkload
from .watches import WatchesWorkload
from .watch_and_wait import WatchAndWaitWorkload
from .fast_watches import FastTriggeredWatchesWorkload
from .background_selectors import BackgroundSelectorsWorkload
from .commit_bug import CommitBugWorkload
from .configure_db import ConfigureDatabaseWorkload
from .slow_task import SlowTaskWorkload
from .random_move_keys import RandomMoveKeysWorkload
from .dd_balance import DDBalanceWorkload
from .remove_servers import RemoveServersSafelyWorkload

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
    "WriteDuringReadWorkload",
    "RandomReadWriteWorkload",
    "FuzzApiWorkload",
    "SelectorCorrectnessWorkload",
    "ConsistencyChecker",
    "check_consistency",
    "BulkLoadWorkload",
    "IndexScanWorkload",
    "InventoryWorkload",
    "QueuePushWorkload",
    "StorefrontWorkload",
    "LowLatencyWorkload",
    "UnreadableWorkload",
    "SidebandWorkload",
    "WatchesWorkload",
    "WatchAndWaitWorkload",
    "FastTriggeredWatchesWorkload",
    "BackgroundSelectorsWorkload",
    "CommitBugWorkload",
    "ConfigureDatabaseWorkload",
    "SlowTaskWorkload",
    "RandomMoveKeysWorkload",
    "DDBalanceWorkload",
    "RemoveServersSafelyWorkload",
]
