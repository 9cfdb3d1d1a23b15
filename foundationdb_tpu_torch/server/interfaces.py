"""Role interface structs: the request/reply schema between roles.

The port's own copy of the reference package's ``server/interfaces.py``
(modelled on fdbclient/MasterProxyInterface.h, fdbserver/ResolverInterface.h,
fdbserver/TLogInterface.h and fdbclient/StorageServerInterface.h).  Each
*Interface dataclass carries the client-side RequestStreamRefs, as the
reference's interface structs carry RequestStream<T> members.  The class
names and field orders are the reference's: the wire codec keys a struct by
its name and writes its fields in order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..client.types import Mutation
from ..conflict.types import TransactionConflictInfo
from ..rpc.stream import RequestStreamRef


# --- sequencer (master's version allocator; ref masterserver.actor.cpp:783) ---


@dataclass
class GetCommitVersionRequest:
    requesting_proxy: str = ""


@dataclass
class GetCommitVersionReply:
    version: int = 0
    prev_version: int = 0


@dataclass
class SequencerInterface:
    get_commit_version: RequestStreamRef = None
    report_committed: RequestStreamRef = None  # proxy -> master committed ver
    get_committed_version: RequestStreamRef = None


# --- proxy (ref fdbclient/MasterProxyInterface.h) ---


@dataclass
class CommitTransactionRequest:
    transaction: "object" = None  # client.types.CommitTransactionRef
    flags: int = 0
    # Sampled-transaction id for the CommitDebug latency chain (ref:
    # debugTransaction / g_traceBatch, NativeAPI.actor.cpp:2376).
    debug_id: Optional[str] = None


# GRV priority flags (ref: GetReadVersionRequest::FLAG_PRIORITY_* —
# batch-priority requests ride a tighter ratekeeper lane).
GRV_FLAG_PRIORITY_BATCH = 1
# Lock-awareness (ref: the LOCK_AWARE transaction option + databaseLockedKey
# checks in commitBatch / getLiveCommittedVersion).
GRV_FLAG_LOCK_AWARE = 2
COMMIT_FLAG_LOCK_AWARE = 1


@dataclass
class GetReadVersionRequest:
    transaction_count: int = 1
    flags: int = 0
    debug_id: Optional[str] = None  # TransactionDebug chain (ref :2698)


@dataclass
class GetRateInfoRequest:
    """The proxy's report riding its rate fetch (ref: GetRateInfoRequest
    carrying totalReleasedTransactions so the ratekeeper sees demand, not
    just supply).  `None` requests remain accepted (legacy probes)."""

    proxy_id: str = "proxy0"
    # Read-version requests queued at the proxy when it fetched (the bound
    # the shed policy enforces; surfaced through status qos).
    grv_queue_depth: int = 0
    # The proxy's passive commit-latency p99 sample (virtual seconds) —
    # the recruited-mode fallback when the ratekeeper has no in-memory
    # trace collector to reassemble latency chains from.
    commit_p99: float = 0.0


@dataclass
class GetKeyServersLocationsRequest:
    """Key -> storage-team lookup (ref: GetKeyServersLocationsRequest
    MasterProxyInterface.h:36; served from the proxy's interception of
    keyServers metadata — the txnStateStore analog)."""

    begin: bytes = b""
    end: bytes = b"\xff"
    limit: int = 1000


@dataclass
class GetKeyServersLocationsReply:
    # (range_begin, range_end_or_None, [StorageInterface]); an empty team
    # means the range is unsharded (client falls back to its default).
    results: List[Tuple[bytes, Optional[bytes], list]] = field(
        default_factory=list
    )


@dataclass
class ProxyInterface:
    commit: RequestStreamRef = None
    get_consistent_read_version: RequestStreamRef = None
    get_key_servers_locations: RequestStreamRef = None
    # Recovery-time injection of the shard map recovered from storage
    # ownership meta (the txnStateStore-recovery analog); request payload is
    # ([(begin, end, [ids])], {id: StorageInterface}).
    load_system_map: RequestStreamRef = None


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


# --- tlog (ref fdbserver/TLogInterface.h) ---


@dataclass
class TLogCommitRequest:
    """One version's mutations for THIS tlog, grouped by tag (ref:
    TagPartitionedLogSystem push building per-log, per-tag message bundles,
    TagPartitionedLogSystem.actor.cpp:63).  Each mutation carries its
    commit-order seq so consumers subscribing to several tags replay a
    version's mutations in the exact commit order.  Every tlog receives
    every version (possibly with no tags) to keep the prevVersion chain."""

    prev_version: int = 0
    version: int = 0
    # tag -> [(seq, Mutation)]
    tagged: Dict[str, List[Tuple[int, Mutation]]] = field(default_factory=dict)
    epoch: int = 0  # generation guard (ref: epoch locking at recovery)
    # Highest fully-acked version the proxy knows (ref:
    # knownCommittedVersion riding pushes): consumers may apply up to it
    # even when a log replica is unreachable.
    known_committed: int = 0
    debug_id: Optional[str] = None  # CommitDebug chain (TLog stages)


# Broadcast tags: metadata mutations go everywhere (the private-mutation
# analog, ref ApplyMetadataMutation tagging); un-sharded ranges (no
# keyServers entry yet) use the default tag, also on every tlog.
TAG_ALL = "_all"
TAG_DEFAULT = "_default"


@dataclass
class TLogPeekRequest:
    """Peek the union of `tags` (ref tLogPeekMessages :946; a storage
    subscribes to its own tag + the broadcast tags).

    tags=None subscribes to EVERY tag (a log router pulling the full
    stream).  raw_tagged=True returns entries as (version, {tag: [(seq,
    mutation)]}) instead of the merged (version, [mutations]) — the form a
    router needs to re-serve arbitrary tag subsets downstream; it also
    lets merge cursors dedupe across replicas by (tag, seq)."""

    begin_version: int = 0
    # Merge-cursor mode: instead of erroring peek_below_begin, serve from
    # this log's own floor and report it in `served_from` — a FRESH
    # replacement log (begin = recovery version) holds nothing below by
    # construction; surviving replicas cover that range, so a merge over
    # the set must not wedge on the one log that cannot answer (ref: the
    # best-effort member handling in MergedPeekCursor).
    allow_below_begin: bool = False
    tags: Optional[List[str]] = field(
        default_factory=lambda: [TAG_DEFAULT, TAG_ALL]
    )
    limit_versions: int = 1000
    raw_tagged: bool = False


@dataclass
class TLogPeekReply:
    entries: List[Tuple[int, List[Mutation]]] = field(default_factory=list)
    end_version: int = 0  # exclusive: peeked everything below this
    known_committed: int = 0  # fully-acked watermark (see TLogCommitRequest)
    has_more: bool = False
    # With allow_below_begin: the effective begin actually served (> the
    # request's begin_version when this log's floor is above it).
    served_from: int = 0


@dataclass
class TLogPopRequest:
    """Per-consumer durability mark (ref: tLogPop TLogServer.actor.cpp:894
    pops per TAG; the log discards only below the min across tags).  A
    consumer's first pop registers its tag; a storage registers at
    construction so entries it hasn't peeked are never discarded."""

    version: int = 0  # durable-on-this-consumer; tag's mark rises to it
    tag: str = ""  # consumer identity (storage id); "" = the default tag
    # True when a storage is removed from the cluster for good (DD exclude):
    # its tag stops holding the discard floor, so a dead consumer can't
    # freeze log trimming forever.
    unregister: bool = False


@dataclass
class TLogInterface:
    commit: RequestStreamRef = None
    peek: RequestStreamRef = None
    pop: RequestStreamRef = None
    # Durable-watermark probe (ref: confirmEpochLive / the known-committed
    # version exchange).  Storages bound application to the MIN watermark
    # across their tag's logs, so a version durable on only SOME logs (an
    # un-acked orphan that epoch-end recovery will truncate) is never
    # applied by anyone.
    confirm: RequestStreamRef = None
    # Ratekeeper probe (ref: TLogQueuingMetricsRequest) — durable version +
    # in-memory queue depth.
    metrics: RequestStreamRef = None


@dataclass
class TLogMetricsReply:
    durable_version: int = 0
    queue_bytes: int = 0


# --- storage (ref fdbclient/StorageServerInterface.h) ---


@dataclass
class GetValueRequest:
    key: bytes = b""
    version: int = 0


@dataclass
class GetValueReply:
    value: Optional[bytes] = None
    version: int = 0


@dataclass
class GetKeyValuesRequest:
    begin: bytes = b""
    end: bytes = b"\xff"
    version: int = 0
    limit: int = 1 << 30
    reverse: bool = False


@dataclass
class GetKeyValuesReply:
    data: List[Tuple[bytes, bytes]] = field(default_factory=list)
    more: bool = False
    version: int = 0


@dataclass
class WatchValueRequest:
    """Fire when key's value differs from `value` at or after `version`
    (ref: WatchValueRequest StorageServerInterface.h; watchValue_impl
    storageserver.actor.cpp:760)."""

    key: bytes = b""
    value: Optional[bytes] = None
    version: int = 0


@dataclass
class FetchShardRequest:
    """Page of shard data at a FIXED snapshot version, served during a data
    move (ref: fetchKeys' getRange reads at fetchVersion,
    storageserver.actor.cpp fetchKeys).  The destination pages by advancing
    `begin` past the last returned key, all pages at the same version."""

    begin: bytes = b""
    end: bytes = b"\xff"
    version: int = 0


@dataclass
class FetchShardReply:
    data: List[Tuple[bytes, bytes]] = field(default_factory=list)
    version: int = 0
    more: bool = False


@dataclass
class GetShardStateRequest:
    """Ref: GetShardStateRequest StorageServerInterface.h; DD polls the
    destination until the shard is FETCHED before finishing a move."""

    begin: bytes = b""
    end: bytes = b"\xff"


# GetShardStateReply is a plain string:
#   "readable"  - owned and serving reads over the whole range
#   "adding"    - a fetch is still streaming data in
#   "fetched"   - data complete; waiting for the ownership flip
#   "missing"   - not owned, not being added (e.g. lost across a crash)


@dataclass
class GetStorageMetricsRequest:
    """Byte estimate + split point for a range, from the byte sample (ref:
    WaitMetricsRequest / SplitMetricsRequest, StorageServerInterface.h;
    StorageMetrics.actor.h:404).  end=b"" means open-ended."""

    begin: bytes = b""
    end: bytes = b""
    # Ratekeeper probe: skip the O(n) byte-sample scan, return only the
    # version/queue signals (ref: StorageQueuingMetricsRequest being a
    # separate, cheap request in the reference).
    signals_only: bool = False


@dataclass
class GetStorageMetricsReply:
    bytes: int = 0
    split_key: Optional[bytes] = None  # ~half the sampled bytes below it
    # Ratekeeper signals (ref: StorageQueueInfo fields ride the same
    # metrics fetch in the reference's trackStorageServerQueueInfo).
    version: int = 0
    queue_bytes: int = 0


@dataclass
class GetOwnedMetaRequest:
    """Recovery-time ownership dump: replies (storage_id, [(b, e)] owned,
    server_list) once the storage has replayed the log through min_version,
    so the new proxy's routing map reflects every settled handoff (the
    txnStateStore-recovery analog)."""

    min_version: int = 0


@dataclass
class StorageInterface:
    storage_id: str = ""
    get_storage_metrics: RequestStreamRef = None
    get_value: RequestStreamRef = None
    get_key_values: RequestStreamRef = None
    get_version: RequestStreamRef = None
    watch_value: RequestStreamRef = None
    fetch_shard: RequestStreamRef = None
    get_shard_state: RequestStreamRef = None
    get_owned_meta: RequestStreamRef = None
