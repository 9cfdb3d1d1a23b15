"""Proxy role: commit batching pipeline + read-version service.

The port's own copy of the reference package's ``server/proxy.py``.  The
reference's knobs it reads are the module constants below, at the
reference's defaults.  ``ratekeeper`` stays an argument (None: no
admission control).

Ref: MasterProxyServer.actor.cpp — batcher collects CommitTransactionRequests
(fdbrpc/batcher.actor.h), commitBatch :318 runs the phased pipeline
(get version from master -> resolve -> apply -> log -> reply), GRV service
transactionStarter :934.  The pipeline here is structured the same way:
batches overlap because ordering is carried by the sequencer's prevVersion
chain, which the resolver and the log each enforce independently — batch N+1
can be resolving while batch N is logging (ref: latestLocalCommitBatch*
NotifiedVersions :362,414,424).
"""

from __future__ import annotations

from typing import List, Tuple

from ..client.atomic import transform_versionstamp
from ..client.types import Mutation, MutationType
from ..conflict.types import COMMITTED, CONFLICT, TOO_OLD, TransactionConflictInfo
from ..flow.asyncvar import NotifiedVersion
from ..flow.error import ActorCancelled
from ..flow.eventloop import first_of
from ..flow.state_sanitizer import audited_dict
from ..rpc.network import SimProcess
from ..rpc.stream import RequestStream
from ..utils import RangeMap
from .interfaces import (
    TAG_ALL,
    TAG_DEFAULT,
    GetCommitVersionReply,
    GetKeyServersLocationsReply,
    GetRateInfoRequest,
    ProxyInterface,
    ResolveTransactionBatchRequest,
    ResolverInterface,
    SequencerInterface,
    TLogCommitRequest,
    TLogInterface,
)
from .log_system import tlogs_for_tag

# The reference's server knobs (flow/knobs.py), at its defaults.
COMMIT_TRANSACTION_BATCH_INTERVAL = 0.002
COMMIT_TRANSACTION_BATCH_COUNT_MAX = 32768
COMMIT_BATCH_IDLE_INTERVAL = 0.25
MAX_WRITE_TRANSACTION_LIFE_VERSIONS = 5_000_000
MAX_VERSIONS_IN_FLIGHT = 100_000_000
RATEKEEPER_GRV_QUEUE_MAX = 2048


def split_ranges_for_resolver(
    tr: TransactionConflictInfo, lo: bytes, hi
) -> TransactionConflictInfo:
    """Clip a transaction's conflict ranges to one resolver's key range
    (ref: ResolutionRequestBuilder.addTransaction
    MasterProxyServer.actor.cpp:280-303 — every resolver gets a slot for
    every transaction so reply indices align; ranges outside its space are
    simply absent)."""

    def clip(rng):
        b, e = rng
        cb = max(b, lo)
        ce = e if hi is None else min(e, hi)
        return (cb, ce) if cb < ce else None

    return TransactionConflictInfo(
        read_snapshot=tr.read_snapshot,
        read_ranges=[c for r in tr.read_ranges if (c := clip(r)) is not None],
        write_ranges=[c for r in tr.write_ranges if (c := clip(r)) is not None],
    )


class Proxy:
    def __init__(
        self,
        process: SimProcess,
        sequencer: SequencerInterface,
        resolvers: List[ResolverInterface],
        tlogs: List[TLogInterface],
        epoch_begin_version: int = 0,
        epoch: int = 0,
        resolver_split_keys: List[bytes] = None,
        ratekeeper=None,  # RatekeeperInterface or None (no admission control)
        system_map=None,  # recovered ([(b, e, [ids])], {id: StorageInterface})
        proxy_id: str = "proxy0",
        n_proxies: int = 1,
        n_satellites: int = 0,  # trailing logs that receive EVERY tag (ref:
        # satellite TLogs in the primary region — synchronous, in the ack
        # set, carrying the full stream for remote-region recovery)
        grv_queue_max: int = RATEKEEPER_GRV_QUEUE_MAX,
    ):
        self.process = process
        # Bound of the GRV admission queue (the reference's
        # ratekeeper_grv_queue_max knob): beyond it the proxy sheds.
        self.grv_queue_max = grv_queue_max
        self.epoch = epoch
        self.proxy_id = proxy_id
        self.n_proxies = n_proxies
        self.sequencer = sequencer
        self.resolvers = resolvers
        self.tlogs = tlogs
        # Key-space partition across resolvers (ref: keyResolvers
        # KeyRangeMap :185).  n resolvers need n-1 split points.
        from .system_keys import bounds_from_split_keys

        split = resolver_split_keys or []
        assert len(split) == len(resolvers) - 1, "need n-1 split keys"
        # [(lo, hi_or_None)] per resolver
        self.resolver_bounds = bounds_from_split_keys(split)
        # Superseded partitions still receiving ranges: [(bounds, until)].
        # After a split moves at version V, batches through
        # V + MVCC-window + in-flight-depth clip with the OLD bounds TOO, so
        # the new owner of a boundary range builds history while the old
        # owner still detects conflicts against writes it alone has seen
        # (ref: keyResolvers keeping multiple (version, resolver) entries
        # per range until the window expires, MasterProxyServer :185,
        # ApplyMetadataMutation's keyResolvers handling).
        self._old_bounds: List[Tuple[list, int]] = []
        self.ratekeeper = ratekeeper
        self.n_satellites = n_satellites
        # Set when the commit pipeline is unrecoverably wedged (a batch
        # died mid-phase); role_check reports it so the CC recovers.
        self.broken = False
        self.last_rate_info = None  # latest RateInfo fetched by the GRV loop
        self.committed = NotifiedVersion(epoch_begin_version)
        # Authoritative key -> storage-team map, maintained by intercepting
        # keyServers/serverList metadata mutations in the commits this proxy
        # processes (single-proxy stand-in for the reference's txnStateStore
        # + ApplyMetadataMutation; ref MasterProxyServer.actor.cpp:185,457).
        # Values are (route_team, tag_team) id-tuples: reads route to the
        # data holders (src during a move), mutations are tagged to every
        # current AND incoming holder (src + dest, so an AddingShard's
        # buffer sees the stream).  None = unsharded (no DD yet).
        self.key_servers = RangeMap(None)
        # Non-None while `\xff/dbLocked` holds a UID (ref: databaseLockedKey;
        # learned via the mutation stream or recovery-time map injection).
        self.locked_uid = None
        # Audited under the loop's state sanitizer: written by the commit
        # path's metadata intercept and recovery-time injection, read by
        # the read-routing path — a cross-actor shared map.
        self.server_list: dict = audited_dict(process.network.loop, "proxy.server_list")
        if system_map is not None:
            entries, server_list = system_map
            for b, e, team in entries:
                self.key_servers.set_range(b, e, (tuple(team), tuple(team)))
            self.server_list = audited_dict(process.network.loop, "proxy.server_list",
                                            server_list)
        # Metadata applies in version order across THIS proxy's overlapped
        # batches (the own-version chain); versions granted to other proxies
        # in between are covered by the resolvers' state-mutation replies
        # (ref: resolution[0].stateMutations applied at
        # MasterProxyServer.actor.cpp:449-466 before own tag assignment).
        self._meta_version = NotifiedVersion(epoch_begin_version)
        self._last_own_version = epoch_begin_version
        # Local batch numbering serializes phase 1 so this proxy's versions
        # are granted in local batch order (ref: localBatchNumber and the
        # latestLocalCommitBatchResolving chain :362).
        self._local_batches = 0
        self._batch_resolving = NotifiedVersion(0)
        # Version through which resolve replies have been processed; rides
        # the next request so resolvers GC their reply caches (ref
        # lastReceivedVersion).
        self._last_received = epoch_begin_version
        self._commit_stream = RequestStream(process, "commit", well_known=True)
        self._grv_stream = RequestStream(process, "grv", well_known=True)
        self._loc_stream = RequestStream(
            process, "get_key_servers_locations", well_known=True
        )
        self._load_map_stream = RequestStream(
            process, "load_system_map", well_known=True
        )
        # Ref: ProxyStats MasterProxyServer.actor.cpp:45 + traceCounters.
        from ..metrics import (
            ContinuousSample,
            CounterCollection,
            MetricsRegistry,
            emit_metrics,
        )

        self.stats = CounterCollection(f"Proxy{proxy_id}")
        for _c in ("batches", "committed", "conflicted", "too_old",
                   "grv_requests", "rejected_locked",
                   "grv_shed_batch", "grv_shed_default"):
            self.stats.counter(_c)  # pre-create: snapshots list them all
        # Proxy-observed latency distributions (batch arrival -> reply),
        # surfaced as status qos percentiles (ref: the commit/GRV latency
        # bands Status.actor.cpp derives from proxy metrics).
        _rng = process.network.loop.rng
        self.latency_samples = {
            "commit": ContinuousSample(_rng),
            "grv": ContinuousSample(_rng),
        }
        # Registry half of the pipeline (metrics.py): ADOPTS the
        # stats counters above (one underlying Counter per verdict — call
        # sites increment once, the surfaces cannot drift) and adds the
        # batch-size/latency distributions.  One emitter actor replaces
        # trace_counters: emit_metrics emits the same per-counter
        # value+rate details under the same event name, plus gauges and
        # histogram summaries (two raters on one Counter would reset each
        # other's rate baseline).
        self.metrics = MetricsRegistry(f"Proxy{proxy_id}", rng=_rng)
        for _c in self.stats.counters.values():
            self.metrics.adopt(_c)
        process.spawn(
            emit_metrics(self.metrics, process), "proxy_metrics_emit"
        )
        # Time-series sampler: bounded delta history of this
        # proxy's registry into the global hub (flow/timeseries.py).
        from ..flow.timeseries import spawn_sampler

        spawn_sampler(process, self.metrics.name, self.metrics)
        self._last_batch_cut = process.network.loop.now()
        process.spawn_observed(self._commit_batcher(), "proxy_batcher")
        # Always tick (not just multi-proxy): empty batches advance the
        # committed version with virtual time, which TaskBucket leases and
        # MVCC-window expiry depend on (ref: the master's version clock
        # advancing with wall time, masterserver getVersion :800-809).
        process.spawn_observed(self._idle_batch_ticker(), "proxy_idle_tick")
        process.spawn(self._serve_grv(), "proxy_grv")
        process.spawn_observed(self._serve_locations(), "proxy_locations")
        process.spawn_observed(self._serve_load_map(), "proxy_load_map")

    def _spawn_owned(self, coro, name: str):
        from ..rpc.stream import spawn_owned

        return spawn_owned(self, coro, name)

    def interface(self) -> ProxyInterface:
        return ProxyInterface(
            commit=self._commit_stream.ref(),
            get_consistent_read_version=self._grv_stream.ref(),
            get_key_servers_locations=self._loc_stream.ref(),
            load_system_map=self._load_map_stream.ref(),
        )

    async def _serve_load_map(self):
        """Recovery-time map injection (see ProxyInterface.load_system_map).
        Safe only before DD resumes writing metadata — the controller loads
        the map before publishing the cluster to clients."""
        while True:
            payload, reply = await self._load_map_stream.pop()
            entries, server_list = payload[0], payload[1]
            for b, e, team in entries:
                self.key_servers.set_range(b, e, (tuple(team), tuple(team)))
            self.server_list.update(server_list)
            if len(payload) > 2:
                # Recovery-time lock state (a lock must survive the
                # generation change that recruited this proxy).
                self.locked_uid = payload[2] or None
            reply.send(None)

    # --- key-location service (ref readRequestServer :1045) ---
    async def _serve_locations(self):
        while True:
            req, reply = await self._loc_stream.pop()
            out = []
            for b, e, v in self.key_servers.intersecting(req.begin, req.end):
                route = v[0] if v else None
                ifaces = (
                    [self.server_list[s] for s in route if s in self.server_list]
                    if route
                    else []
                )
                out.append((b, e, ifaces))
                if len(out) >= req.limit:
                    break
            reply.send(GetKeyServersLocationsReply(results=out))

    def _tags_for_mutation(self, m: Mutation) -> set:
        """Storage tags a mutation must reach (ref: the keyInfo tag lookup
        in commitBatch :547-600).  System-keyspace mutations broadcast
        (TAG_ALL — the private-mutation analog); unsharded ranges use
        TAG_DEFAULT (also on every log)."""
        tags: set = set()

        def range_tags(b, e):
            for _b, _e, v in self.key_servers.intersecting(b, e):
                if v and v[1]:
                    tags.update(v[1])
                else:
                    tags.add(TAG_DEFAULT)

        if m.type == MutationType.CLEAR_RANGE:
            b, e = m.param1, m.param2
            if e > b"\xff":
                tags.add(TAG_ALL)
            if b < b"\xff":
                range_tags(b, min(e, b"\xff"))
        elif m.param1 >= b"\xff":
            tags.add(TAG_ALL)
        else:
            v = self.key_servers[m.param1]
            if v and v[1]:
                tags.update(v[1])
            else:
                tags.add(TAG_DEFAULT)
        return tags

    def _intercept_metadata(self, m: Mutation, version: int = 0):
        """ApplyMetadataMutation analog for the proxy's own map."""
        from .system_keys import parse_metadata_mutation

        parsed = parse_metadata_mutation(m)
        if parsed is None:
            return
        if parsed[0] == "server":
            _kind, sid, iface = parsed
            self.server_list[sid] = iface
        elif parsed[0] == "resolver_split":
            from .system_keys import bounds_from_split_keys

            _kind, split = parsed
            if len(split) != len(self.resolvers) - 1:
                return  # malformed for this topology; ignore
            until = (
                version
                + MAX_WRITE_TRANSACTION_LIFE_VERSIONS
                + MAX_VERSIONS_IN_FLIGHT
            )
            self._old_bounds.append((self.resolver_bounds, until))
            self.resolver_bounds = bounds_from_split_keys(split)
        elif parsed[0] == "lock":
            # Ref: applyMetadataMutations handling databaseLockedKey — the
            # proxy starts/stops rejecting non-lock-aware work.
            self.locked_uid = parsed[1] or None
        else:
            _kind, begin, src, dest, end = parsed
            # Reads route to the data holders: the sources while a move is
            # in flight (they serve until the settle), the team once settled.
            # A seed record (empty src) routes to dest — the shard is new.
            # Tags cover src AND dest so in-flight AddingShards see the
            # stream (ref: tag assignment from keyInfo incl. pending moves).
            route = tuple(src or dest)
            tags = tuple(sorted(set(src) | set(dest)))
            self.key_servers.set_range(begin, end, (route, tags))

    # --- GRV (ref transactionStarter :934) ---
    async def _serve_grv(self):
        """Batched read-version service: drain every queued request into one
        batch, spend the ratekeeper budget for the whole batch, answer all
        with one version (ref: transactionStarter draining its queue against
        the rate, MasterProxyServer.actor.cpp:934-1033)."""
        from ..flow.buggify import buggify
        from .interfaces import GRV_FLAG_PRIORITY_BATCH

        loop = self.process.network.loop
        budget = 1.0
        batch_budget = 1.0
        last_refill = loop.now()
        tps = None
        batch_tps = None
        last_fetch = -1e9
        deferred: list = []  # batch-priority replies awaiting lane budget
        from ..flow.trace import trace_batch

        # reply -> (debug_id, arrival time); survives lane deferral.
        grv_meta: dict = {}
        while True:
            if deferred and not self._grv_stream.is_ready():
                # Deferred batch-lane work but no new arrivals: tick the
                # budget forward instead of parking on the stream.
                await loop.delay(0.005)
                pairs = []
            else:
                req0, reply0 = await self._grv_stream.pop()
                pairs = [(req0, reply0)]
                while self._grv_stream.is_ready():
                    r, rep = await self._grv_stream.pop()
                    pairs.append((r, rep))
            self.stats.add("grv_requests", len(pairs))
            if pairs:
                self.metrics.histogram("grv_batch_size").add(len(pairs))
            if self.locked_uid is not None and pairs:
                # Ref: GRVs also fail database_locked unless lock-aware.
                from .interfaces import GRV_FLAG_LOCK_AWARE

                kept = []
                for r, rep in pairs:
                    if r is not None and not (r.flags & GRV_FLAG_LOCK_AWARE):
                        rep.send_error("database_locked")
                    else:
                        kept.append((r, rep))
                pairs = kept
            for r, rep in pairs:
                grv_meta[id(rep)] = (
                    getattr(r, "debug_id", None),
                    loop.now(),
                )
                trace_batch(
                    "TransactionDebug",
                    "MasterProxyServer.serveGrv.GotRequest",
                    getattr(r, "debug_id", None),
                )
            batch = [
                rep
                for r, rep in pairs
                if not (r is not None and r.flags & GRV_FLAG_PRIORITY_BATCH)
            ]
            lane = deferred + [
                rep
                for r, rep in pairs
                if r is not None and r.flags & GRV_FLAG_PRIORITY_BATCH
            ]
            deferred = []
            # Bounded admission queue: beyond the configured
            # depth the proxy SHEDS deterministically instead of queueing
            # without bound.  The batch-priority lane starves first (its
            # newest arrivals go first within the lane — FIFO for what
            # stays); only when the default lane alone overflows does it
            # shed too.  Both errors are retryable: clients re-enter with
            # exponential backoff + DeterministicRandom jitter (ref: the
            # proxy memory-limit rejection in transactionStarter).
            qmax = self.grv_queue_max
            if len(batch) + len(lane) > qmax:
                from ..flow.testprobe import test_probe

                test_probe("grv_shed")
                keep_lane = max(0, qmax - len(batch))
                shed_lane, lane = lane[keep_lane:], lane[:keep_lane]
                shed_batch: list = []
                if len(batch) > qmax:
                    shed_batch, batch = batch[qmax:], batch[:qmax]
                for rep in shed_lane:
                    self.stats.add("grv_shed_batch")
                    grv_meta.pop(id(rep), None)
                    rep.send_error("batch_transaction_throttled")
                for rep in shed_batch:
                    self.stats.add("grv_shed_default")
                    grv_meta.pop(id(rep), None)
                    rep.send_error("proxy_memory_limit_exceeded")
            if buggify("proxy_grv_delay"):
                # BUGGIFY: stale-but-causal read versions (the committed
                # floor only rises) — exercises waitForVersion fast paths.
                await loop.delay(loop.rng.random01() * 0.02)
            if self.ratekeeper is not None:
                if loop.now() - last_fetch > 0.1:
                    try:
                        # The fetch carries this proxy's demand report
                        # (GetRateInfoRequest): queue depth for the status
                        # qos surface, and the passive commit p99 as the
                        # ratekeeper's fallback when no in-memory trace
                        # collector exists to reassemble latency chains.
                        info = await self.ratekeeper.get_rate.get_reply(
                            self.process,
                            GetRateInfoRequest(
                                proxy_id=self.proxy_id,
                                grv_queue_depth=len(batch) + len(lane),
                                commit_p99=(
                                    self.latency_samples["commit"]
                                    .percentile(0.99)
                                    or 0.0
                                ),
                            ),
                        )
                        tps = info.tps
                        batch_tps = getattr(info, "batch_tps", info.tps)
                        self.last_rate_info = info  # surfaced by status/qos
                    except Exception:  # noqa: BLE001 - rk down: keep old rate  # fdblint: ignore[ERR001]: ratekeeper unreachable — keeping the stale rate IS the degraded mode (a throttle beats none)
                        pass
                    last_fetch = loop.now()
                if tps is not None:
                    now = loop.now()
                    cap = max(float(len(batch)), tps * 0.1)
                    bcap = max(1.0, batch_tps * 0.1)
                    budget = min(budget + (now - last_refill) * tps, cap)
                    batch_budget = min(
                        batch_budget + (now - last_refill) * batch_tps, bcap
                    )
                    last_refill = now
                    while budget < len(batch):
                        # Floor the wait: a sub-float-resolution delay would
                        # not advance virtual time and the loop would spin.
                        await loop.delay(
                            max(
                                (len(batch) - budget) / max(tps, 1e-6), 5e-4
                            )
                        )
                        now = loop.now()
                        budget = min(budget + (now - last_refill) * tps, cap)
                        batch_budget = min(
                            batch_budget + (now - last_refill) * batch_tps,
                            bcap,
                        )
                        last_refill = now
                    budget -= len(batch)
                    # Batch lane: answer only what its budget affords NOW;
                    # the rest stays deferred (ref: the batch-priority GRV
                    # queue released strictly behind the default lane).
                    afford = int(batch_budget)
                    if afford < len(lane):
                        from ..flow.testprobe import test_probe

                        test_probe("grv_batch_deferred")
                        deferred = lane[afford:]
                        lane = lane[:afford]
                    batch_budget -= len(lane)
            batch = batch + lane
            if not batch:
                continue
            # GRV reply span: the causal-floor read + replies
            # for this drained batch.  Detached (the sequencer read
            # awaits); ended on both exits.
            from ..flow.spans import begin_span

            gspan = begin_span(
                "grv_batch", role=self.metrics.name,
                attrs={"n": len(batch)},
            )
            version = self.committed.get()
            if self.n_proxies > 1:
                # Another proxy may have committed (and acked) beyond this
                # proxy's chain; the sequencer's committed watermark covers
                # every proxy because each reports before replying to
                # clients (ref: GRV asking all proxies + confirming logs,
                # :956-1001 — the sequencer read is this rebuild's
                # equivalent causal floor).
                try:
                    version = max(
                        version,
                        await self.sequencer.get_committed_version.get_reply(
                            self.process, None
                        ),
                    )
                except Exception:  # noqa: BLE001 - sequencer died: this
                    # generation is ending; clients will retry against the
                    # next one.
                    for rep in batch:
                        grv_meta.pop(id(rep), None)
                        rep.send_error("broken_promise")
                    gspan.end(attrs={"error": "broken_promise"})
                    continue
            for rep in batch:
                did, t_arr = grv_meta.pop(id(rep), (None, loop.now()))
                self.latency_samples["grv"].add(loop.now() - t_arr)
                trace_batch(
                    "TransactionDebug",
                    "MasterProxyServer.serveGrv.Replied",
                    did,
                )
                rep.send(version)
            gspan.end(attrs={"version": version})

    async def _idle_batch_ticker(self):
        """Cut an EMPTY commit batch when no real batch has gone out for a
        while: the resolve round-trip delivers other proxies' state
        transactions (keeping this proxy's shard/tag map current even with
        zero commit traffic) and advances the resolver's per-proxy
        lastVersion so its retention GC can run (ref: the empty-batch tick
        in commitBatcher, MasterProxyServer.actor.cpp; Resolver GC
        :196-218)."""
        loop = self.process.network.loop
        interval = COMMIT_BATCH_IDLE_INTERVAL
        while True:
            await loop.delay(interval)
            if loop.now() - self._last_batch_cut < interval:
                continue
            self._last_batch_cut = loop.now()
            self._local_batches += 1
            self._spawn_owned(
                self._commit_batch([], self._local_batches), "idle_batch"
            )

    # --- commit batching (ref batcher.actor.h + commitBatch :318) ---
    async def _commit_batcher(self):
        from ..flow.buggify import buggify

        loop = self.process.network.loop
        pending = None  # a pop() that lost the race to the window timer
        while True:
            first = await (pending or self._commit_stream.pop())
            pending = None
            batch = [first]
            # BUGGIFY: single-transaction batches maximize pipeline overlap
            # and per-batch edge cases (ref: buggified batch knobs).
            batch_max = (
                1
                if buggify("proxy_tiny_batch")
                else COMMIT_TRANSACTION_BATCH_COUNT_MAX
            )
            deadline = loop.now() + COMMIT_TRANSACTION_BATCH_INTERVAL
            while (
                len(batch) < batch_max
                and loop.now() < deadline
            ):
                nxt = self._commit_stream.pop()
                timer = loop.delay(deadline - loop.now())
                idx, val = await first_of(nxt, timer)
                if idx == 1:
                    # Window closed.  `nxt` is still registered with the
                    # stream; it MUST be the next batch's first element or
                    # the request it eventually receives would be lost.
                    pending = nxt
                    break
                loop.cancel_timer(timer)
                batch.append(val)
            self._last_batch_cut = loop.now()
            self._local_batches += 1
            self._spawn_owned(
                self._commit_batch(batch, self._local_batches), "commit_batch"
            )

    async def _commit_batch(self, batch: List[Tuple], local_batch: int):
        ctx: dict = {}
        try:
            await self._commit_batch_impl(batch, local_batch, ctx)
        except ActorCancelled:
            # Role teardown cancelling an in-flight batch is NOT a pipeline
            # break: re-raise so the task dies cleanly (Reply.__del__
            # breaks the clients' promises; the new generation serves
            # their retries).
            raise
        except Exception as e:  # noqa: BLE001
            # The failed batch's (prev, version) pair is now a PERMANENT
            # hole in the prevVersion chain: the logs wait for it forever,
            # wedging every later batch even when the failure was a
            # transient transport error on a live role.  The reference's
            # proxy actor dies here (recovery follows); mark this proxy
            # broken so the CC's role_check starts the recovery the ping
            # sweep cannot see (the process is alive and pinging fine).
            self.broken = True
            from ..flow.testprobe import test_probe

            test_probe("proxy_pipeline_broken")
            from ..flow.trace import TraceEvent

            TraceEvent("ProxyCommitPipelineBroken", severity=30).detail(
                "proxy", self.proxy_id
            ).detail("error", getattr(e, "name", repr(e))).log()
            # Unwedge the local chains so later batches don't deadlock
            # behind this one: they fail fast (the same dead role) and their
            # clients get commit_unknown_result instead of hanging until
            # failure detection replaces the generation.  Skipping this
            # batch's metadata application is safe: nothing after it can
            # durably commit in this generation (phase 4 requires ALL logs),
            # and recovery rebuilds the map from storage ownership.
            self._batch_resolving.set(
                max(self._batch_resolving.get(), local_batch)
            )
            if "version" in ctx:
                self._meta_version.set(
                    max(self._meta_version.get(), ctx["version"])
                )
            # A phase RPC failed (e.g. resolver/tlog died mid-batch).  The
            # outcome is genuinely unknown — the log may or may not have made
            # it durable — so every client gets commit_unknown_result (ref:
            # NativeAPI :2430-2449; generation recovery replaces this proxy).
            for _req, reply in batch:
                reply.send_error("commit_unknown_result")

    async def _commit_batch_impl(
        self, batch: List[Tuple], local_batch: int, ctx: dict = None
    ):
        from ..flow.eventloop import wait_for_all
        from ..flow.spans import NULL_SPAN, begin_span
        from ..flow.trace import trace_batch

        loop0 = self.process.network.loop
        t_start = loop0.now()
        # Batch-level debug id: the first sampled transaction's (ref:
        # commitBatch folding member debugIDs into one batch UID :340).
        batch_debug = next(
            (req.debug_id for req, _r in batch if req.debug_id is not None),
            None,
        )
        # Batch span: real batches only — the idle ticker cuts
        # an empty batch every COMMIT_BATCH_IDLE_INTERVAL, which would
        # bury the ring in no-payload spans.  Phase children are created
        # with EXPLICIT parents (each crosses awaits, where the hub's
        # current-span stack is not valid).
        bspan = (
            begin_span(
                "commit_batch", role=self.metrics.name,
                attrs={"n_txn": len(batch), "local_batch": local_batch},
            )
            if batch
            else NULL_SPAN
        )
        def _phase(name):
            # Phase child span — only under a real batch span (an empty
            # idle batch records nothing).
            if bspan is NULL_SPAN:
                return NULL_SPAN
            return begin_span(name, parent=bspan)

        trace_batch(
            "CommitDebug", "MasterProxyServer.commitBatch.Before", batch_debug
        )
        # Database lock (ref: commitBatch rejecting non-lock-aware txns
        # while databaseLockedKey is set).  Rejected BEFORE resolution so
        # their conflict ranges never enter history; the possibly-empty
        # remainder still runs the pipeline to keep the version chains
        # advancing.
        if self.locked_uid is not None:
            from .interfaces import COMMIT_FLAG_LOCK_AWARE

            kept = []
            for req, reply in batch:
                if req.flags & COMMIT_FLAG_LOCK_AWARE:
                    kept.append((req, reply))
                else:
                    self.stats.add("rejected_locked")
                    reply.send_error("database_locked")
            batch = kept
        self.stats.add("batches")
        if batch:
            # Real batches only: the idle ticker cuts empty batches every
            # COMMIT_BATCH_IDLE_INTERVAL, which would bury the size/latency
            # distributions under zeros (the GRV path guards identically).
            self.metrics.histogram("commit_batch_size").add(len(batch))
        # Phase 1: commit version from the sequencer, serialized in local
        # batch order so this proxy's versions are monotone in batch order
        # (ref: the localBatchNumber chain :362; GetCommitVersionRequest ->
        # masterserver getVersion :783).
        pspan = _phase("get_version")
        await self._batch_resolving.when_at_least(local_batch - 1)
        gv: GetCommitVersionReply = await self.sequencer.get_commit_version.get_reply(
            self.process, self.epoch  # fenced: only this generation is served
        )
        version, prev = gv.version, gv.prev_version
        pspan.end(attrs={"version": version})
        bspan.annotate("version", version)
        trace_batch(
            "CommitDebug",
            "MasterProxyServer.commitBatch.GotCommitVersion",
            batch_debug,
        )
        if ctx is not None:
            ctx["version"] = version
        own_prev, self._last_own_version = self._last_own_version, version
        self._batch_resolving.set(local_batch)
        from ..flow.buggify import buggify

        if buggify("proxy_resolve_delay"):
            # BUGGIFY: let a LATER batch reach the resolvers first —
            # exercises the prevVersion reorder wait (Resolver :104-115).
            loop = self.process.network.loop
            await loop.delay(loop.rng.random01() * 0.02)

        # Phase 2: resolution.  One ResolveTransactionBatchRequest per
        # resolver; each resolver sees the ranges in its key space (the
        # mesh-sharded ConflictSet clips on device) and verdicts are
        # min-combined (ref ResolutionRequestBuilder :237, combine :492-499).
        # Transactions touching \xff are state transactions: their mutations
        # ride the request so the resolvers can hand them to other proxies
        # (ref ResolutionRequestBuilder :307).
        infos = [
            TransactionConflictInfo(
                read_snapshot=req.transaction.read_snapshot,
                read_ranges=list(req.transaction.read_conflict_ranges),
                write_ranges=list(req.transaction.write_conflict_ranges),
            )
            for (req, _reply) in batch
        ]
        state_txns = [
            (t, list(req.transaction.mutations))
            for t, (req, _reply) in enumerate(batch)
            if any(
                m.param1 >= b"\xff"
                or (m.type == MutationType.CLEAR_RANGE and m.param2 > b"\xff")
                for m in req.transaction.mutations
            )
        ]
        # Clip per the current partition, UNIONed with any superseded
        # partitions whose overlap window still covers this version (see
        # _old_bounds).  Filter per batch WITHOUT mutating: a later-version
        # batch can reach this point before an earlier in-flight batch
        # clips, and pruning here would strip an overlay the earlier batch
        # still needs (its boundary ranges would reach only the new owner,
        # missing old-owner-only history).  Pruning happens in phase 3,
        # where the per-proxy version chain guarantees every earlier batch
        # has already clipped.
        bound_sets = [self.resolver_bounds] + [
            b for b, until in self._old_bounds if version <= until
        ]

        def clip_for(ri: int, tr: TransactionConflictInfo):
            lo, hi = bound_sets[0][ri]
            out = split_ranges_for_resolver(tr, lo, hi)
            for bounds in bound_sets[1:]:
                lo2, hi2 = bounds[ri]
                extra = split_ranges_for_resolver(tr, lo2, hi2)
                # Deterministic dedupe (dict preserves insertion order).
                out.read_ranges = list(
                    dict.fromkeys(out.read_ranges + extra.read_ranges)
                )
                out.write_ranges = list(
                    dict.fromkeys(out.write_ranges + extra.write_ranges)
                )
            return out

        # Clipped per-resolver transaction views, retained past the
        # resolve round-trip: an abort witness names a read-range ordinal
        # WITHIN the clipped txn the owning resolver saw, so decoding it
        # back to key bytes needs exactly this list.
        clipped = [
            [clip_for(ri, tr) for tr in infos]
            for ri in range(len(self.resolvers))
        ]
        pspan = _phase("resolution")
        replies = await wait_for_all(
            [
                r.resolve.get_reply(
                    self.process,
                    ResolveTransactionBatchRequest(
                        prev_version=prev,
                        version=version,
                        last_received_version=self._last_received,
                        transactions=clipped[ri],
                        state_txns=state_txns,
                        proxy_id=self.proxy_id,
                        epoch=self.epoch,
                        debug_id=batch_debug,
                    ),
                )
                for ri, r in enumerate(self.resolvers)
            ]
        )
        statuses = [
            min(rep.committed[t] for rep in replies) for t in range(len(batch))
        ]
        pspan.end(attrs={"n_resolvers": len(self.resolvers)})
        trace_batch(
            "CommitDebug",
            "MasterProxyServer.commitBatch.AfterResolution",
            batch_debug,
        )

        # Phase 3: post-resolution processing, strictly in this proxy's own
        # version order: first the OTHER proxies' state transactions for the
        # versions in between (from the resolvers' replies, committed on
        # every resolver — ref :449-466), then own versionstamp substitution
        # (ref :269-274), own metadata application, THEN per-tag assembly —
        # so a batch's tags are computed against every earlier batch's (and
        # its own) metadata, exactly like the reference's
        # applyMetadataMutations :457 before tag assignment :547-600.
        # Without the ordering, a write pipelined behind a startMove could
        # miss the destination's tag and silently diverge the new replica.
        await self._meta_version.when_at_least(own_prev)
        # Safe overlay prune: every own batch with a smaller version has
        # finished phase 2 by now (phase 3 is version-ordered and phase 2
        # precedes it), and future batches get larger versions.
        self._old_bounds = [
            (b, until) for b, until in self._old_bounds if until >= version
        ]
        for vi, (sv, txns) in enumerate(replies[0].state_mutations):
            for ti, (committed, muts) in enumerate(txns):
                if committed and all(
                    rep.state_mutations[vi][1][ti][0] for rep in replies[1:]
                ):
                    for m in muts:
                        self._intercept_metadata(m, version=sv)
        self._last_received = max(self._last_received, version)
        # Version-ordered lock fence: the state transactions just applied
        # include any lock committed at a version below this batch, so a
        # non-lock-aware transaction can never commit at a version above
        # the lock's (the upfront check at batch entry is only the cheap
        # fast path).  Rejected txns' conflict ranges already entered the
        # resolvers' history as committed — the safe direction: at worst a
        # later reader conflicts spuriously; their MUTATIONS never reach a
        # log.
        rejected_locked: set = set()
        if self.locked_uid is not None:
            from .interfaces import COMMIT_FLAG_LOCK_AWARE

            # State transactions are EXEMPT here: their metadata already
            # travelled to every proxy via the resolvers' state_mutations
            # with committed=True — rejecting only our local copy would
            # diverge the proxies' shard/lock maps.  They remain subject to
            # the batch-entry check; the residual same-window race admits a
            # rare system-keyspace commit above the lock version, applied
            # CONSISTENTLY everywhere (user-keyspace fencing is exact).
            state_idx = {t for t, _muts in state_txns}
            for t, ((req, _reply), status) in enumerate(zip(batch, statuses)):
                if (
                    status == COMMITTED
                    and t not in state_idx
                    and not (req.flags & COMMIT_FLAG_LOCK_AWARE)
                ):
                    rejected_locked.add(t)
        tagged: dict = {}
        seq = 0
        for t, ((req, _reply), status) in enumerate(zip(batch, statuses)):
            if status != COMMITTED or t in rejected_locked:
                continue
            for m in req.transaction.mutations:
                if m.type == MutationType.SET_VERSIONSTAMPED_KEY:
                    m = Mutation(
                        MutationType.SET_VALUE,
                        transform_versionstamp(m.param1, version, t),
                        m.param2,
                    )
                elif m.type == MutationType.SET_VERSIONSTAMPED_VALUE:
                    m = Mutation(
                        MutationType.SET_VALUE,
                        m.param1,
                        transform_versionstamp(m.param2, version, t),
                    )
                self._intercept_metadata(m, version=version)
                for tag in self._tags_for_mutation(m):
                    tagged.setdefault(tag, []).append((seq, m))
                seq += 1
        self._meta_version.set(version)

        # Phase 4: push each tag to its logs (ref logSystem->push with
        # policy-selected tlog subsets); every log gets every version so
        # the prevVersion chain holds.  Durable when ALL acked.
        n = len(self.tlogs)
        routing_n = n - self.n_satellites  # tag placement over regular logs
        per_log: List[dict] = [{} for _ in range(n)]
        for tag, muts in tagged.items():
            for li in tlogs_for_tag(tag, routing_n):
                per_log[li][tag] = muts
            # Satellites carry every tag (the full stream, synchronously
            # in the ack set — the remote region's recovery source).
            for li in range(routing_n, n):
                per_log[li][tag] = muts
        pspan = _phase("log_push")
        await wait_for_all(
            [
                tl.commit.get_reply(
                    self.process,
                    TLogCommitRequest(
                        prev_version=prev,
                        version=version,
                        tagged=per_log[li],
                        epoch=self.epoch,
                        known_committed=self.committed.get(),
                        debug_id=batch_debug,
                    ),
                )
                for li, tl in enumerate(self.tlogs)
            ]
        )
        pspan.end(attrs={"n_logs": len(self.tlogs)})
        trace_batch(
            "CommitDebug",
            "MasterProxyServer.commitBatch.AfterLogPush",
            batch_debug,
        )

        from ..flow import sim_validation

        sim_validation.mark_at_least(
            self.process.network.loop, "acked_commit", version
        )
        # Phase 5: report + reply (ref :636-677).  NOTE: metadata applied
        # pre-push (phase 3) — if the push then fails, the map may reflect a
        # handoff whose commit outcome is unknown; that batch also wedges
        # the log's version chain, so the generation is replaced and the
        # recovered proxy rebuilds its map from storage ownership
        # (get_owned_meta), which resolves either way.
        await self.sequencer.report_committed.get_reply(self.process, version)
        if version > self.committed.get():
            self.committed.set(version)
        if batch:
            # Real batches only (both latency surfaces): the idle ticker's
            # empty batches run the same pipeline and would dominate the
            # qos percentiles with no-payload floor samples.
            self.latency_samples["commit"].add(loop0.now() - t_start)
            self.metrics.histogram("commit_batch_seconds").add(
                loop0.now() - t_start
            )
            if any(getattr(rep, "degraded", False) for rep in replies):
                # A resolver absorbed a device fault (CPU retry) inside
                # this batch: tag its latency separately so degraded-mode
                # cost is visible next to the healthy distribution.
                self.metrics.histogram("commit_batch_seconds_degraded").add(
                    loop0.now() - t_start
                )
        # The stats counters below ARE the registry counters (adopted in
        # __init__): one increment per verdict, and both telemetry
        # surfaces read the same value — a lock-rejected txn that resolved
        # COMMITTED counts as rejected_locked, never committed.
        pspan = _phase("reply")
        n_committed = 0
        for t, ((req, reply), status) in enumerate(zip(batch, statuses)):
            trace_batch(
                "CommitDebug",
                "MasterProxyServer.commitBatch.AfterReply",
                req.debug_id,
            )
            if t in rejected_locked:
                self.stats.add("rejected_locked")
                reply.send_error("database_locked")
            elif status == COMMITTED:
                self.stats.add("committed")
                n_committed += 1
                reply.send(version)
            elif status == TOO_OLD:
                self.stats.add("too_old")
                reply.send_error("transaction_too_old")
            else:
                self.stats.add("conflicted")
                reply.send_error(
                    "not_committed",
                    detail=self._conflict_cause(t, replies, clipped, version),
                )
        pspan.end(attrs={"committed": n_committed})
        bspan.end(attrs={"committed": n_committed})

    def _conflict_cause(self, t, replies, clipped, batch_version):
        """Combine txn `t`'s abort witnesses across the resolvers into the
        structured not_committed cause: version = MAX
        conflicting write version over the resolvers that aborted it (the
        txn must re-read past ALL of them), range = the losing read range
        reported by the lowest-indexed conflicting resolver — the same
        deterministic tie-break the sharded set's in-core combine uses,
        decoded to key bytes via that resolver's clipped view.
        retry_version is the BATCH version: the newest version at which
        this conflict decision is complete (it includes the winning write
        and every commit before it, and is reported committed before the
        error reply is sent), so a retry reading there observes
        everything that aborted us without a fresh GRV round-trip.  None
        when no witness arrived (the resolvers' witness off): the client
        then sees the bare not_committed."""
        version = None
        first = None
        for ri, rep in enumerate(replies):
            wits = rep.witnesses or []
            wit = wits[t] if t < len(wits) else None
            if wit is None or rep.committed[t] != CONFLICT:
                continue
            version = wit[0] if version is None else max(version, wit[0])
            if first is None:
                first = (ri, wit[1])
        if first is None:
            return None
        ri, idx = first
        rr = clipped[ri][t].read_ranges
        rng = rr[idx] if idx < len(rr) else None
        return {
            "version": int(version),
            "retry_version": int(batch_version),
            "range": (rng[0], rng[1]) if rng is not None else None,
        }
