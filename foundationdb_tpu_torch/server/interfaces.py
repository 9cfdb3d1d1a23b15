"""The resolver's request/reply schema.

The part of the reference package's ``server/interfaces.py`` the Resolver
serves (fdbserver/ResolverInterface.h): its batch request and reply, the
split balancer's metrics and split messages, the ratekeeper's signal probe
and the interface struct of client-side RequestStreamRefs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..conflict.types import TransactionConflictInfo
from ..rpc.stream import RequestStreamRef


# --- resolver (ref fdbserver/ResolverInterface.h:83-98) ---


@dataclass
class ResolveTransactionBatchRequest:
    prev_version: int = 0
    version: int = 0
    # Version through which this proxy has already RECEIVED resolve replies
    # (lets the resolver GC its per-proxy reply cache; ref
    # ResolverInterface.h lastReceivedVersion, Resolver.actor.cpp:126).
    last_received_version: int = 0
    transactions: List[TransactionConflictInfo] = field(default_factory=list)
    # State transactions: (index-into-transactions, [Mutation]) for txns that
    # touch the \xff system keyspace.  The resolver retains the committed
    # ones so OTHER proxies learn metadata changes in version order (ref:
    # txnStateTransactions ResolverInterface.h:96, retention :170-190).
    state_txns: List[Tuple[int, list]] = field(default_factory=list)
    proxy_id: str = "proxy0"
    epoch: int = 0  # generation guard: stale-epoch requests are rejected
    # Batch-level CommitDebug id (ref: ResolveTransactionBatchRequest
    # debugID, Resolver.actor.cpp:84).
    debug_id: Optional[str] = None


@dataclass
class ResolveTransactionBatchReply:
    committed: List[int] = field(default_factory=list)  # conflict.types codes
    # [(version, [(committed, [Mutation])])] for every state transaction at
    # versions in (proxy's previous batch, this batch) — i.e. other proxies'
    # metadata commits this proxy has not seen (ref: stateMutations
    # ResolverInterface.h:74, filled at Resolver.actor.cpp:183-189).  Each
    # resolver computes `committed` from its own clipped key space; the
    # proxy applies a state txn only if EVERY resolver reports committed
    # (ref: the min-combine at MasterProxyServer.actor.cpp:455).
    state_mutations: List[Tuple[int, list]] = field(default_factory=list)
    # The batch was resolved on the CPU fallback because a device fault or
    # an open circuit degraded the device path (conflict/device_faults.py);
    # the proxy tags its commit latency sample with it.
    degraded: bool = False
    # Per-transaction abort witnesses, parallel to `committed`:
    # None for non-CONFLICT txns, else (conflicting_write_version,
    # losing_read_range_index) — the provenance phase 1 computes on device
    # and would otherwise throw away.  The proxy max/min-combines these
    # across resolvers into the structured not_committed cause the client's
    # retry hint reads.  Empty when witness emission is off
    # (Resolver(witness=False)); the proxy then falls back to the bare error.
    witnesses: List = field(default_factory=list)


@dataclass
class ResolutionMetricsReply:
    """Load signal for split balancing (ref: ResolutionMetricsRequest
    ResolverInterface.h:108; the master polls these to drive splits)."""

    ops: int = 0  # sampled conflict-range ops since the last poll


@dataclass
class ResolverSignalsReply:
    """Cheap admission-control probe — the resolver-side signals
    the ratekeeper springs on, all O(1) to produce (no conflict-set row
    walks; see ConflictSet.backend_signal): batches in flight or parked on
    the prevVersion chain, the recent-window resolve-latency p99 in virtual
    seconds, and the circuit breaker's backend state.  cpu_mirror_tps is the
    wall-clock-measured CPU-fallback throughput (0.0 = no measurement); sim
    ratekeepers ignore it unless ratekeeper_use_measured_cpu_tps."""

    queue_depth: int = 0
    resolve_p99: float = 0.0
    backend_state: str = "ok"  # ok | degraded | probing (worst shard)
    cpu_mirror_tps: float = 0.0
    degraded_batches: int = 0
    # Total confirmed mirror/device divergences this resolver's
    # consistency checker has caught.  Informational for
    # status/qos: each divergence already opened the breaker, so
    # backend_state carries the admission-control consequence.
    mirror_divergence: int = 0
    # Shard-granular fault domains: a sharded resolver
    # reports how many of its shards are degraded/probing, so the
    # ratekeeper can contract the lane PROPORTIONALLY (one sick chip out
    # of 8 is ~1/8 of capacity, not a global degraded clamp).  0/0 for
    # unsharded resolvers.
    shards_total: int = 0
    shards_degraded: int = 0


@dataclass
class ResolutionSplitRequest:
    """Find the key splitting this resolver's sampled load in [begin, end)
    at `fraction` of its mass (ref: ResolutionSplitRequest
    ResolverInterface.h:118-131, served from the iopsSample)."""

    begin: bytes = b""
    end: Optional[bytes] = None
    fraction: float = 0.5


@dataclass
class ResolverInterface:
    resolve: RequestStreamRef = None
    metrics: RequestStreamRef = None
    split: RequestStreamRef = None
    # Ratekeeper signal probe (ResolverSignalsReply) — separate from
    # `metrics` because that stream's ops counter is reset-on-read for the
    # split balancer; two consumers on one reset stream would starve each
    # other.
    signals: RequestStreamRef = None
