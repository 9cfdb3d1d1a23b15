"""Resolver role: the MVCC conflict decision for each version window.

The port's own copy of the reference package's ``server/resolver.py``
(modelled on Resolver.actor.cpp's resolveBatch): batches are ordered per
proxy by the sequencer's prevVersion chain (a NotifiedVersion), decided by
a ConflictSet, and the window is collected at version -
``max_write_transaction_life_versions``.  A per-proxy reply cache answers
a proxy's retry, and committed state transactions are retained until
every other proxy has seen them.  The conflict set is the port's
``ConflictSet`` (``backend`` "torch", "hybrid" or "cpu") or a
``ShardedTorchConflictSet``.

The entry point runs on the GPU: ``Resolver(process)`` builds
``ConflictSet(backend="torch")`` on the card and raises where no card is
visible (``device.resolve_device``); ``device="cpu"`` runs the same engine
with the kernels' plain twins, and ``backend="cpu"`` the host engine.

Pipelined resolve (a device conflict set with ``pipeline_depth`` > 1): a
batch's device dispatch advances the prevVersion chain at once and its
host-side completion (verdict sync, mirror apply, reply) is deferred into
a bounded double buffer, so while the device resolves batch N the host
applies batch N-1's verdicts and encodes batch N+1.  Replies are the same
as at depth 1: the device history advances in commit order either way.

Settings the reference reads from its knobs and environment are
constructor arguments with the reference's defaults:
``max_write_transaction_life_versions``, ``pipeline_flush_seconds`` (the
idle flush of a parked batch, virtual seconds), ``pipeline_stall_batches``,
``witness_decay_batches``, ``contention_ring``, ``contention_spike_ratio``,
``contention_spike_batches``, ``witness`` (FDB_TPU_WITNESS),
``mirror_check_seconds`` (FDB_TPU_MIRROR_CHECK_SECONDS),
and ``shard_balance_seconds`` (FDB_TPU_SHARD_BALANCE_SECONDS).  Its
samplers run at ``flow/timeseries.py``'s defaults.  ``set_settings`` are
further ``ConflictSet`` arguments of the set the role builds itself (the
reference's ``conflict_*`` knobs: ``key_words``, ``h_cap``,
``max_device_key_bytes``, ...).

Virtual time is the simulator's: host work takes none, so
``resolve_seconds`` and the idle flush are measured on the event loop's
clock, never the card's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from ..conflict.api import ConflictSet
from ..conflict.types import COMMITTED
from ..flow.asyncvar import NotifiedVersion
from ..flow.hotpath import hot_path
from ..rpc.network import SimProcess
from ..rpc.stream import RequestStream
from .interfaces import (
    ResolutionMetricsReply,
    ResolutionSplitRequest,
    ResolverSignalsReply,
    ResolveTransactionBatchReply,
    ResolveTransactionBatchRequest,
    ResolverInterface,
)

# Key-frequency sample bounds (ref: TransientStorageMetricSample iopsSample
# Resolver.actor.cpp:146-151 — a decaying sample of conflict-range begin
# keys, queried by the master's split balancing).
SAMPLE_MAX_KEYS = 2000


@dataclass
class _ProxyInfo:
    """Ref: ProxyRequestsInfo Resolver.actor.cpp — lastVersion + the
    outstanding reply cache keyed by version."""

    last_version: int = 0
    outstanding: Dict[int, ResolveTransactionBatchReply] = field(
        default_factory=dict
    )


class _ParkedResolve:
    """Resolver-side context of one batch parked in the double-buffered
    pipeline: everything the completion phase — verdict
    bookkeeping, state-txn retention, reply — needs, carried from the
    submit phase.  Completions run strictly in version order (the deque
    order), by whichever handler drives the pump."""

    __slots__ = ("entry", "req", "reply", "first_unseen", "t_enter",
                 "finished", "_promise", "span")

    def __init__(self, entry, req, reply, first_unseen: int, t_enter: float,
                 span=None):
        self.entry = entry
        self.req = req
        self.reply = reply
        self.first_unseen = first_unseen
        self.t_enter = t_enter
        self.finished = False
        self._promise = None
        self.span = span  # the batch's resolve_batch span

    @property
    def future(self):
        """Fires when this context's resolve is FINISHED (reply sent)."""
        if self._promise is None:
            from ..flow.future import Promise

            self._promise = Promise()
            if self.finished:
                self._promise.send(None)
        return self._promise.future

    def _mark_finished(self):
        self.finished = True
        if self._promise is not None and not self._promise.is_set():
            self._promise.send(None)


class Resolver:
    def __init__(
        self,
        process: SimProcess,
        backend: str = "torch",
        epoch_begin_version: int = 0,
        conflict_set: ConflictSet = None,
        epoch: int = 0,
        n_proxies: int = 1,
        device=None,
        max_write_transaction_life_versions: int = 5_000_000,
        pipeline_flush_seconds: float = 0.005,
        pipeline_stall_batches: int = 12,
        witness_decay_batches: int = 64,
        contention_ring: int = 128,
        contention_spike_ratio: float = 0.5,
        contention_spike_batches: int = 8,
        witness: bool = True,
        mirror_check_seconds: float = 10.0,
        shard_balance_seconds: float = 0.0,
        set_settings: Optional[dict] = None,
    ):
        self.process = process
        self.epoch = epoch
        self.n_proxies = n_proxies
        self.max_write_transaction_life_versions = max_write_transaction_life_versions
        self.pipeline_flush_seconds = pipeline_flush_seconds
        self.pipeline_stall_batches = pipeline_stall_batches
        self.witness_decay_batches = witness_decay_batches
        self.contention_spike_ratio = contention_spike_ratio
        self.contention_spike_batches = contention_spike_batches
        # The default set is on the card (raising without one) unless the
        # caller names the CPU or the host backend.
        self.conflicts = conflict_set or ConflictSet(
            backend=backend, oldest_version=epoch_begin_version,
            device=device, witness=witness, **(set_settings or {}),
        )
        self.version = NotifiedVersion(epoch_begin_version)
        self.total_resolved = 0
        # Committed state transactions by version, retained until every
        # proxy's lastVersion has passed them (ref :170-224).
        self._recent_state_txns: Dict[int, list] = {}
        self._proxy_info: Dict[str, _ProxyInfo] = {}
        self._epoch_begin = epoch_begin_version
        # Decaying first-key frequency sample + op counter for split
        # balancing (ref: iopsSample Resolver.actor.cpp:146-151,
        # ResolutionMetricsRequest/SplitRequest service :276-284).
        self._key_sample: Dict[bytes, int] = {}
        self._metric_ops = 0
        self._stream = RequestStream(process, "resolve", well_known=True)
        self._metrics_stream = RequestStream(
            process, "resolution_metrics", well_known=True
        )
        self._split_stream = RequestStream(
            process, "resolution_split", well_known=True
        )
        self._signals_stream = RequestStream(
            process, "resolver_signals", well_known=True
        )
        # Telemetry registry (ref: Resolver.actor.cpp's resolverCounters +
        # traceCounters): batch sizes, per-verdict counts, and the queue
        # wait the prevVersion reorder imposes.  The loop rng enables
        # histogram percentiles deterministically.
        from ..metrics import MetricsRegistry, emit_metrics

        loop = process.network.loop
        self.metrics = MetricsRegistry(
            f"Resolver.{process.name}", rng=loop.rng
        )
        for _c in ("batches", "transactions", "committed", "conflicted",
                   "too_old", "cache_hits", "stale_epoch",
                   "degraded_batches", "witness_aborts",
                   "contention_spikes"):
            self.metrics.counter(_c)  # pre-create: snapshots list them all
        # Conflict-witness telemetry: per-batch aborted-txn counts plus a
        # bounded top-K of the key ranges aborted transactions were
        # contending on.
        self._witness_ranges: Dict[tuple, int] = {}
        self.metrics.gauge("conflict_witness_topk").set("[]")
        # End-to-end provenance: with `witness` on, the conflict engines
        # report the precise (conflicting version, losing read range) per
        # abort, the reply carries it to the proxy, and the contended-range
        # sample above records the EXACT range each loser lost on instead
        # of the first-write-range approximation.
        self._witness_on = bool(witness)
        # Contended-range decay advances once per witness_decay_batches
        # CONFLICT-bearing batches — a batch counter, deliberately not a
        # timer, so idle virtual time never drains the top-K.
        self._witness_batches = 0
        # Per-batch abort timeline (the contention explorer's raw feed):
        # (version, n_txn, n_aborted, [[begin_hex, end_hex, count], ...]).
        from collections import deque as _deque

        self._contention_ring = _deque(maxlen=int(contention_ring))
        # Consecutive batches at/above the spike abort fraction.
        self._contention_streak = 0
        # Set once a raw device conflict set faulted and its state was
        # exported host-side: the CPU engine then serves every later batch
        # of this role's life (see _retry_on_cpu).
        self._cpu_takeover = None
        # Admission-control signals: batches in flight or parked
        # on the prevVersion chain, and a sliding window of recent resolve
        # durations (virtual seconds, entry -> reply).  A bounded window —
        # not the cumulative histogram — so the ratekeeper's spring sees a
        # latency SPIKE instead of a lifetime-diluted reservoir.
        self._inflight = 0
        from collections import deque

        self._recent_resolve = deque(maxlen=64)
        self.metrics.gauge("queue_depth").set(0)
        # Double-buffered pipeline: contexts of batches dispatched to the
        # device whose host-side completion (verdict sync, mirror apply,
        # reply) is deferred, oldest first.  Active only when the conflict
        # set has a device engine (`_dev`) and a pipeline_depth > 1;
        # depth 1 keeps the synchronous path.
        self._pipe_ctx = deque()
        self._flush_streak = 0  # consecutive idle-flush completions
        self._pipeline_on = (
            getattr(self.conflicts, "pipeline_depth", 1) > 1
            and callable(getattr(self.conflicts, "pipeline_submit", None))
            and getattr(self.conflicts, "_dev", None) is not None
        )
        self.metrics.gauge("pipeline_occupancy").set(0)
        for _c in ("pipeline_device_stalls", "pipeline_host_stalls"):
            self.metrics.counter(_c)  # pre-create: snapshots list them all
        self.metrics.histogram("pipeline_inflight_depth")
        # Pipeline overlap efficiency: overlapped device time
        # / total device time over completed device in-flight spans,
        # measured on the span hub's EVENT-SEQUENCE clock (deterministic:
        # virtual time does not advance during synchronous host work, so
        # seq is the clock that still shows batch N+1's dispatch running
        # inside batch N's device window).  Incremental union: device
        # spans complete in dispatch order, so one high-water mark
        # suffices.  The wall twin goes through record_wall only.
        self.metrics.gauge("pipeline_overlap_efficiency").set(0.0)
        self._dev_seq_total = 0
        self._dev_seq_union = 0
        self._dev_seq_hwm = None
        self._dev_wall_hwm = None
        # Host fraction: seq extent of the host phases
        # (encode + mirror_apply + readback, accumulated by the engine)
        # over host + device extent — the deterministic twin of the
        # wall-clock host-path share the hostpath bench arm measures.
        self.metrics.gauge("host_fraction").set(0.0)
        process.spawn_observed(self._serve(), "resolver")
        process.spawn_observed(self._serve_metrics(), "resolver_metrics")
        process.spawn_observed(self._serve_split(), "resolver_split")
        process.spawn_observed(self._serve_signals(), "resolver_signals")
        process.spawn(
            emit_metrics(self.metrics, process), "resolver_metrics_emit"
        )
        # Time-series sampler actors: bounded delta history of this role's
        # registry — and of the device engine's kernel telemetry when one
        # is live — into the global hub, the window the flight recorder
        # freezes on a trigger.
        from ..flow.timeseries import spawn_sampler

        spawn_sampler(process, self.metrics.name, self.metrics)
        dev = getattr(self.conflicts, "_dev", None)
        if dev is not None:
            spawn_sampler(
                process, f"{dev.metrics.name}.{process.name}", dev.metrics
            )
        elif getattr(self.conflicts, "metrics", None) is not None:
            # A raw conflict set with its own registry (the sharded set):
            # its per-shard breaker walk rides the same time-series rings
            # the flight recorder freezes on a shard-breaker open.
            spawn_sampler(
                process,
                f"{self.conflicts.metrics.name}.{process.name}",
                self.conflicts.metrics,
            )
        # Mirror consistency-check actor: periodically diff a live mirror
        # snapshot against the device's exported state; confirmed
        # divergence opens the breaker (ConflictSet.mirror_check
        # counts/traces and degrades).  Deterministic: virtual-time
        # cadence, synchronous check — same seed, same transition log.
        period = float(mirror_check_seconds)
        if period > 0 and callable(
            getattr(self.conflicts, "mirror_check", None)
        ):
            process.spawn_observed(
                self._mirror_check_loop(period), "resolver_mirror_check"
            )
        # Shard-balancer actor: periodically evaluate per-shard occupancy +
        # decayed contention skew and migrate split points live
        # (ShardedTorchConflictSet.reshard).  Deterministic: the tick is
        # virtual-time, the evaluation synchronous, the inputs (occupancy,
        # witness sample, queue-depth pressure) seed-stable — same seed,
        # byte-identical decision log.
        self.shard_balancer = None
        bal_period = float(shard_balance_seconds)
        if bal_period > 0 and callable(
            getattr(self.conflicts, "reshard", None)
        ):
            from .resolver_balancer import ShardBalancer

            self.shard_balancer = ShardBalancer(
                self.conflicts, load_fn=self._shard_load_sample
            )
            process.spawn_observed(
                self._shard_balance_loop(bal_period), "resolver_shard_balance"
            )

    def interface(self) -> ResolverInterface:
        return ResolverInterface(
            resolve=self._stream.ref(),
            metrics=self._metrics_stream.ref(),
            split=self._split_stream.ref(),
            signals=self._signals_stream.ref(),
        )

    @property
    def queue_depth(self) -> int:
        """Resolve batches in flight or parked on the prevVersion chain."""
        return self._inflight

    def resolve_p99_recent(self) -> float:
        """Exact p99 over the recent resolve-duration window (virtual
        seconds); 0.0 before any batch completed."""
        from ..flow.spans import percentile

        return percentile(list(self._recent_resolve), 0.99) or 0.0

    def signal_snapshot(self) -> ResolverSignalsReply:
        """The admission-control probe (served by the `signals` stream and
        read directly by in-process ratekeepers).  All O(1)/O(window) —
        never O(history rows)."""
        bs = getattr(self.conflicts, "backend_signal", None)
        sig = bs() if callable(bs) else {}
        state = sig.get("backend_state", "ok")
        mirror_tps = sig.get("cpu_mirror_tps", 0.0)
        if self._cpu_takeover is not None:
            state = "degraded"  # permanent host takeover (raw device set)
        return ResolverSignalsReply(
            queue_depth=self._inflight,
            resolve_p99=self.resolve_p99_recent(),
            backend_state=state,
            cpu_mirror_tps=mirror_tps,
            degraded_batches=int(
                self.metrics.counter("degraded_batches").value
            ),
            mirror_divergence=sig.get("mirror_divergence", 0),
            # Shard-granular detail: 0/0 unless the conflict set is
            # sharded with per-shard breakers.
            shards_total=sig.get("shards_total", 0),
            shards_degraded=sig.get("shards_degraded", 0),
        )

    async def _serve_signals(self):
        while True:
            _req, reply = await self._signals_stream.pop()
            reply.send(self.signal_snapshot())

    async def _mirror_check_loop(self, period: float):
        """Run ConflictSet.mirror_check() every `period` virtual seconds.
        The check itself is synchronous (no await inside), so it can
        never observe a half-applied batch; a host-only backend returns
        None on the first call and the actor retires.  Parked pipelined
        batches are completed first: under sustained traffic
        the double buffer holds an entry almost always, and the
        divergence checker must not starve behind it — the drain just
        finishes deferred host work (replies included) a little early,
        in order, so it is always safe."""
        loop = self.process.network.loop
        while True:
            await loop.delay(period)
            if self._pipe_ctx:
                self._pipeline_pump(0, "drain")
            if self.conflicts.mirror_check() is None:
                return  # no device engine behind this conflict set

    def _shard_load_sample(self):
        """Per-shard contention load from the decayed witness-range
        sample: each contended range is charged to the shard
        owning its begin key under the CURRENT partition.  Seed-stable —
        the sample itself is deterministic and the mapping is a pure
        function of it plus split_keys."""
        from bisect import bisect_right

        cs = self.conflicts
        ks = [bytes(k) for k in cs.split_keys]
        loads = [0] * cs.n_shards
        for (begin, _end), hits in self._witness_ranges.items():
            loads[bisect_right(ks, bytes(begin))] += int(hits)
        return loads

    async def _shard_balance_loop(self, period: float):
        """Tick the ShardBalancer every `period` virtual seconds.  The
        evaluation (and any reshard it commits) is synchronous, so a
        boundary can never move under a batch mid-resolve — batches see
        the old partition or the new one, never a torn one.  Pressure is
        the queue-depth fraction of the batch-concurrency target, the
        same signal the ratekeeper throttles on."""
        loop = self.process.network.loop
        while True:
            await loop.delay(period)
            if self._pipe_ctx:
                self._pipeline_pump(0, "drain")
            pressure = min(1.0, self._inflight / 16.0)
            self.shard_balancer.evaluate(pressure=pressure)

    async def _serve(self):
        while True:
            req, reply = await self._stream.pop()
            # Owned spawn: per-request handlers can park indefinitely (the
            # prevVersion ordering wait) and MUST die with the role —
            # teardown cancels owned tasks so their held replies break
            # instead of wedging callers of a dead generation forever.
            from ..rpc.stream import spawn_owned

            spawn_owned(self, self._resolve_one(req, reply), "resolve_batch")

    def _sample(self, tr):
        for rng in tr.read_ranges:
            self._bump(rng[0])
        for rng in tr.write_ranges:
            self._bump(rng[0])
        self._metric_ops += len(tr.read_ranges) + len(tr.write_ranges)

    def _bump(self, key: bytes):
        self._key_sample[key] = self._key_sample.get(key, 0) + 1
        if len(self._key_sample) > SAMPLE_MAX_KEYS:
            # Decay: halve every count, drop the zeros (the transient-sample
            # expiry analog; keeps hot keys, sheds one-offs).  Under wide
            # uniform load halving alone may not shrink the dict (all
            # counts >= 2) — evict the coldest entries down to 3/4 capacity
            # so the rebuild amortizes to once per cap/4 inserts instead of
            # running on every insert of the hot path.
            self._key_sample = {
                k: v // 2 for k, v in self._key_sample.items() if v >= 2
            }
            target = SAMPLE_MAX_KEYS * 3 // 4
            if len(self._key_sample) > target:
                import heapq

                for k, _v in heapq.nsmallest(
                    len(self._key_sample) - target,
                    self._key_sample.items(),
                    key=lambda kv: (kv[1], kv[0]),
                ):
                    del self._key_sample[k]

    def _retry_on_cpu(self, fault, req):
        """Re-run a device-faulted batch on a host engine built from the
        conflict set's pre-batch state (injected faults raise BEFORE any
        device state mutates, so store_to exports exactly the history the
        batch must be decided against — verdicts stay bit-identical; a
        REAL device fault may have left the device state unreadable, in
        which case store_to raises and the actor dies loudly — recovery
        then re-recruits, which beats deciding against corrupt history).
        The
        CPU engine takes over for the rest of this role's life: handing
        state back to a faulting device mid-epoch risks a second
        interruption with no authoritative copy."""
        from ..conflict.engine_cpu import CpuConflictSet
        from ..flow.trace import TraceEvent

        store = getattr(self.conflicts, "store_to", None)
        if store is None:
            raise fault  # nothing to retry against: let the actor die loudly
        TraceEvent("ResolverDeviceFaultRetry", severity=20).detail(
            "error", type(fault).__name__
        ).detail("site", getattr(fault, "site", "")).detail(
            "version", req.version
        ).log()
        cpu = CpuConflictSet()
        store(cpu)
        self._cpu_takeover = cpu
        window = self.max_write_transaction_life_versions
        return cpu.detect(
            req.transactions,
            now=req.version,
            new_oldest_version=req.version - window,
        )

    async def _serve_metrics(self):
        while True:
            _req, reply = await self._metrics_stream.pop()
            reply.send(ResolutionMetricsReply(ops=self._metric_ops))
            self._metric_ops = 0

    async def _serve_split(self):
        while True:
            req, reply = await self._split_stream.pop()
            reply.send(self._split_key(req))

    def _split_key(self, req: ResolutionSplitRequest):
        """The sampled key at `fraction` of this resolver's mass within
        [begin, end); None when the sample is too thin to split."""
        keys = sorted(
            k
            for k in self._key_sample
            if k >= req.begin and (req.end is None or k < req.end)
        )
        total = sum(self._key_sample[k] for k in keys)
        if total == 0 or len(keys) < 2:
            return None
        # A boundary at key k puts the mass of every key < k on the left;
        # pick the boundary whose LEFT mass is closest to fraction*total.
        # (Crossing-key-inclusive accumulation would dump the crossing
        # key's whole mass — possibly most of the range — on the donated
        # side and overshoot wildly for skewed samples.)
        target = total * req.fraction
        acc = 0
        best_key, best_err = None, None
        for idx, k in enumerate(keys):
            if idx > 0:  # boundary at keys[0] == empty left side: no-op
                err = abs(acc - target)
                if best_err is None or err < best_err:
                    best_key, best_err = k, err
            acc += self._key_sample[k]
        return best_key

    async def _resolve_one(self, req: ResolveTransactionBatchRequest, reply):
        if req.epoch != self.epoch:
            self.metrics.counter("stale_epoch").add()
            reply.send_error("operation_failed")  # stale generation's proxy
            return
        # Queue-depth accounting: a batch counts from arrival —
        # including time parked on the prevVersion chain, which is exactly
        # where an overloaded resolver's backlog lives — until its reply.
        loop = self.process.network.loop
        t_enter = loop.now()
        self._inflight += 1
        self.metrics.gauge("queue_depth").set(self._inflight)
        try:
            await self._resolve_one_impl(req, reply, t_enter)
        finally:
            self._inflight -= 1
            self.metrics.gauge("queue_depth").set(self._inflight)

    async def _resolve_one_impl(
        self, req: ResolveTransactionBatchRequest, reply, t_enter: float
    ):
        from ..flow.buggify import buggify
        from ..flow.trace import trace_batch

        trace_batch(
            "CommitDebug", "Resolver.resolveBatch.Before", req.debug_id
        )
        if buggify("resolver_delay"):
            # BUGGIFY: batches arrive out of order — exercises the
            # prevVersion chain wait below (ref :104-115).
            loop = self.process.network.loop
            await loop.delay(loop.rng.random01() * 0.02)
        # Order batches by the sequencer's prevVersion chain: a batch may
        # arrive before its predecessor (ref :104-115).
        await self.version.when_at_least(req.prev_version)
        if self.version.get() != req.prev_version:
            # Duplicate/replayed batch (proxy retry after timeout): answer
            # from the per-proxy reply cache (ref :240-256).  The chain
            # advances at DISPATCH in pipelined mode, so the original may
            # still be parked — wait out its completion, then the cache
            # has the reply.
            pinfo = self._proxy_info.get(req.proxy_id)
            cached = pinfo.outstanding.get(req.version) if pinfo else None
            if cached is None:
                parked = next(
                    (c for c in self._pipe_ctx
                     if c.req.proxy_id == req.proxy_id
                     and c.req.version == req.version),
                    None,
                )
                if parked is not None:
                    await parked.future
                    pinfo = self._proxy_info.get(req.proxy_id)
                    cached = (
                        pinfo.outstanding.get(req.version) if pinfo else None
                    )
            if cached is not None:
                self.metrics.counter("cache_hits").add()
                reply.send(cached)
            else:
                reply.send_error("operation_failed")
            return

        pinfo = self._proxy_info.setdefault(
            req.proxy_id, _ProxyInfo(last_version=self._epoch_begin)
        )
        # The proxy has received everything through last_received_version;
        # drop those cached replies (ref :126-128).
        for v in [
            v for v in pinfo.outstanding if v <= req.last_received_version
        ]:
            del pinfo.outstanding[v]
        first_unseen = pinfo.last_version + 1
        pinfo.last_version = req.version

        for tr in req.transactions:
            self._sample(tr)
        window = self.max_write_transaction_life_versions
        # Batch span: arrival-ordered root of this batch's
        # stage tree (encode/dispatch/device/sync/apply/reply children).
        # Detached — it outlives awaits on the pipelined path — and ended
        # by the shared completion (_complete_resolve).
        from ..flow.spans import begin_span, use_span

        bspan = begin_span(
            "resolve_batch", role=self.metrics.name,
            attrs={"version": req.version,
                   "n_txn": len(req.transactions),
                   "pipelined": int(
                       self._pipeline_on and self._cpu_takeover is None
                   )},
        )
        if self._pipeline_on and self._cpu_takeover is None:
            # The double-buffered async offload path (ref: the pipelined
            # yieldedFuture resolve loop of Resolver.actor.cpp).
            await self._resolve_pipelined(
                req, reply, first_unseen, t_enter, window, bspan
            )
            return
        conflicts = self._cpu_takeover or self.conflicts
        batch = conflicts.new_batch() if self._cpu_takeover is None else None
        if batch is not None:
            for tr in req.transactions:
                batch.add_transaction(tr)
        degraded = False
        if batch is not None:
            from ..conflict.device_faults import DeviceFault

            try:
                with use_span(bspan):  # stage spans parent to the batch
                    statuses = batch.detect_conflicts(
                        now=req.version,
                        new_oldest_version=req.version - window,
                    )
            except DeviceFault as e:
                # Last-resort host retry, same resolve call — no error may
                # escape to the proxy (ConflictSet's breaker normally
                # absorbs faults below this; raw device sets, e.g. the
                # sharded one, surface them here).
                statuses = self._retry_on_cpu(e, req)
                degraded = True
        else:
            statuses = self._cpu_takeover.detect(
                req.transactions,
                now=req.version,
                new_oldest_version=req.version - window,
            )
            degraded = True  # permanent host takeover: still degraded
        consume = getattr(conflicts, "consume_degraded", None)
        if consume is not None and consume():
            degraded = True
        # Provenance: whichever engine actually decided the batch holds
        # its witness — the CPU takeover after a device fault (set inside
        # _retry_on_cpu), else the serving conflict set.
        witness = self._batch_witness(
            self._cpu_takeover or conflicts, len(statuses)
        )
        # version.set before the shared completion (the pipelined path
        # sets it at dispatch): NotifiedVersion wakes waiters through the
        # loop's ready queue, never synchronously, so no actor can
        # interleave before this handler's reply either way.
        self.version.set(req.version)
        self._complete_resolve(
            req, reply, statuses, degraded, first_unseen, t_enter,
            span=bspan, witness=witness,
        )

    def _batch_witness(self, engine, n: int) -> list:
        """Per-txn abort witnesses for the batch `engine` just decided,
        or [] when provenance is off or the engine predates
        it.  Length is pinned to the batch so a stale list from an
        earlier batch can never be attributed to this one."""
        if not self._witness_on:
            return []
        wit = list(getattr(engine, "last_witness", []) or [])
        return wit if len(wit) == n else []

    @hot_path(bound="batch")
    def _complete_resolve(
        self, req, reply, statuses, degraded: bool, first_unseen: int,
        t_enter: float, span=None, witness=None,
    ):
        """Post-verdict completion shared by the synchronous path and the
        pipeline's _finish_resolve — verdict accounting, state-txn
        retention + reply-cache insert, GC, trace, the latency window,
        and the reply itself live in ONE place so the two paths can
        never drift.  `span` is the batch's resolve_batch span: the
        reply child span nests under it and it is ENDED here (the one
        place both paths funnel through)."""
        from ..conflict.types import CONFLICT, TOO_OLD
        from ..flow.trace import trace_batch

        m = self.metrics
        if degraded:
            m.counter("degraded_batches").add()
            m.histogram("degraded_batch_size").add(len(req.transactions))
            trace_batch(
                "CommitDebug",
                "Resolver.resolveBatch.DegradedRetry",
                req.debug_id,
            )
        self.total_resolved += len(statuses)
        # Feed the registry: batch size + per-verdict counts (the conflict
        # rate "The Transactional Conflict Problem" trades against
        # throughput).
        n_conflicted = sum(1 for s in statuses if s == CONFLICT)
        m.counter("batches").add()
        m.counter("transactions").add(len(statuses))
        m.histogram("batch_size").add(len(statuses))
        m.counter("committed").add(sum(1 for s in statuses if s == COMMITTED))
        m.counter("conflicted").add(n_conflicted)
        m.counter("too_old").add(sum(1 for s in statuses if s == TOO_OLD))
        # Conflict-witness counters: aborted-txn count per batch + the contended key ranges (see __init__).
        if n_conflicted:
            m.counter("witness_aborts").add(n_conflicted)
            m.histogram("aborted_per_batch").add(n_conflicted)
            self._witness_record(
                req.transactions, statuses, witness, req.version
            )
        # Sustained-contention black box: consecutive batches whose abort
        # fraction clears the spike ratio arm the flight recorder; one
        # sub-threshold batch disarms it.  Same cooldown/reset discipline
        # as the pipeline-stall trigger — only an ACTUAL capture resets
        # the streak, so a cooldown-suppressed attempt retries next batch.
        if statuses:
            if n_conflicted >= self.contention_spike_ratio * len(statuses):
                self._contention_streak += 1
                if self._contention_streak >= self.contention_spike_batches:
                    from ..flow.flight_recorder import maybe_trigger

                    captured = maybe_trigger(
                        "contention_spike",
                        detail={
                            "streak": self._contention_streak,
                            "version": req.version,
                            "aborted": n_conflicted,
                            "batch": len(statuses),
                            "topk": self.conflict_witness()["topk"],
                        },
                        source=self.metrics.name,
                    )
                    if captured is not None:
                        m.counter("contention_spikes").add()
                        self._contention_streak = 0
            else:
                self._contention_streak = 0

        # Retain this batch's state transactions with their verdicts so the
        # other proxies' next batches learn them (ref :170-181).
        if req.state_txns:
            self._recent_state_txns[req.version] = [
                (statuses[t] == COMMITTED, muts) for t, muts in req.state_txns
            ]
        out = ResolveTransactionBatchReply(
            committed=statuses,
            witnesses=list(witness) if witness else [],
            degraded=degraded,
            state_mutations=[
                (v, self._recent_state_txns[v])
                for v in sorted(self._recent_state_txns)
                if first_unseen <= v < req.version
            ],
        )
        pinfo = self._proxy_info[req.proxy_id]
        pinfo.outstanding[req.version] = out

        # GC retained state txns below every proxy's lastVersion — only once
        # all proxies have checked in, else an unseen proxy could miss state
        # (ref :196-218 requiring proxyInfoMap complete).
        if len(self._proxy_info) >= self.n_proxies:
            oldest = min(p.last_version for p in self._proxy_info.values())
            # last_version advances at SUBMIT in pipelined mode, so a
            # still-parked batch may have bumped its proxy past state txns
            # its own reply (built at completion) still needs: clamp the
            # GC below the oldest parked context's first_unseen.
            # Retaining longer is always safe; _pipe_ctx is empty on the
            # synchronous path, where bump, reply build, and GC run with
            # no await between them.
            if self._pipe_ctx:
                oldest = min(
                    oldest,
                    min(c.first_unseen for c in self._pipe_ctx) - 1,
                )
            for v in [v for v in self._recent_state_txns if v <= oldest]:
                del self._recent_state_txns[v]

        from ..flow.spans import begin_span, use_span

        with use_span(span):
            with begin_span("reply", attrs={"version": req.version}):
                trace_batch(
                    "CommitDebug", "Resolver.resolveBatch.After",
                    req.debug_id,
                )
                # Resolve latency (arrival -> reply, virtual seconds):
                # the sliding window the ratekeeper's resolve_latency
                # spring reads, plus the cumulative histogram for
                # status/metrics.  Real resolves only — cache-hit/stale
                # replies never reach here and never dilute it.
                dt = self.process.network.loop.now() - t_enter
                self._recent_resolve.append(dt)
                m.histogram("resolve_seconds").add(dt)
                reply.send(out)
        if span is not None:
            span.end(attrs={"degraded": int(degraded),
                            "aborted": n_conflicted})

    WITNESS_MAX_RANGES = 512  # bounded contended-range sample (decayed)
    WITNESS_TOP_K = 8

    def _witness_record(self, txns, statuses, witness=None, version=0):
        """Bump the contended-range sample with every aborted txn's losing
        range — the PRECISE read range its witness names when
        provenance is on, else the first-write-range approximation the
        pre-witness sample used (first-committer-wins means a loser's own
        write range is where it usually collided).  Decays like the
        split-balancer key sample so hot ranges survive and one-offs
        shed; the decay clock is REAL batches only — once per
        witness_decay_batches calls here, plus the overflow
        halving — never a timer, so a quiescent cluster's top-K holds
        byte-identical between soak phases.  Publishes the top-K as a
        canonical-JSON gauge and appends this batch's per-range abort
        counts to the contention timeline ring — both deterministic, so
        they ride snapshots/timeseries/soak reports without breaking
        byte identity."""
        from ..conflict.types import CONFLICT

        w = self._witness_ranges
        batch_ranges: Dict[tuple, int] = {}
        n_aborted = 0
        for t, (tr, s) in enumerate(zip(txns, statuses)):
            if s != CONFLICT:
                continue
            n_aborted += 1
            wtn = witness[t] if witness and t < len(witness) else None
            if wtn is not None and wtn[1] < len(tr.read_ranges):
                rng = tr.read_ranges[wtn[1]]
            else:
                ranges = tr.write_ranges or tr.read_ranges
                if not ranges:
                    continue
                rng = ranges[0]
            key = (rng[0], rng[1])
            w[key] = w.get(key, 0) + 1
            batch_ranges[key] = batch_ranges.get(key, 0) + 1
        self._witness_batches += 1
        decay_every = int(self.witness_decay_batches)
        if (decay_every > 0 and self._witness_batches % decay_every == 0) \
                or len(w) > self.WITNESS_MAX_RANGES:
            w = {k: v // 2 for k, v in w.items() if v >= 2}
            self._witness_ranges = w
        import json as _json

        top = sorted(w.items(), key=lambda kv: (-kv[1], kv[0]))
        top = top[: self.WITNESS_TOP_K]
        self.metrics.gauge("conflict_witness_topk").set(
            _json.dumps(
                [[b.hex(), e.hex(), n] for (b, e), n in top],
                separators=(",", ":"),
            )
        )
        self._contention_ring.append((
            int(version),
            len(statuses),
            n_aborted,
            sorted(
                [[b.hex(), e.hex(), n] for (b, e), n in batch_ranges.items()],
                key=lambda r: (-r[2], r[0], r[1]),
            ),
        ))

    def conflict_witness(self) -> dict:
        """Status/soak surface: aborted-txn total, decoded top-K contended
        ranges, and the contention block — the per-batch abort
        timeline ring plus spike-trigger state — everything `cli
        contention` joins against the span rings."""
        import json as _json

        return {
            "aborts": int(self.metrics.counter("witness_aborts").value),
            "topk": _json.loads(
                self.metrics.gauge("conflict_witness_topk").value or "[]"
            ),
            "contention": {
                "witness_batches": self._witness_batches,
                "streak": self._contention_streak,
                "spikes": int(
                    self.metrics.counter("contention_spikes").value
                ),
                "timeline": [
                    {
                        "version": v,
                        "batch": b,
                        "aborted": a,
                        "ranges": rngs,
                    }
                    for (v, b, a, rngs) in self._contention_ring
                ],
            },
        }

    # -- double-buffered pipeline -----------------------------------------
    async def _resolve_pipelined(
        self, req, reply, first_unseen: int, t_enter: float, window: int,
        bspan=None,
    ):
        """The async offload path: admit the batch into the conflict
        set's pipeline and advance the prevVersion chain at DISPATCH —
        the carried device history advances in commit order on device,
        so batch N+1's phase-1 searches already see batch N's committed
        writes while only N's host-side work (verdict sync, mirror
        apply, reply) is deferred.  Completions run strictly in version
        order: a successor's submit pushes the oldest out once the
        pipeline exceeds its depth bound (its sync overlaps OUR device
        compute, its mirror apply runs under it too), and the idle
        flush drains the tail when traffic pauses."""
        from ..flow.spans import use_span

        with use_span(bspan):
            # Synchronous section: the submit's encode/dispatch/device
            # spans (engine + ConflictSet) parent to this batch's span.
            entry = self.conflicts.pipeline_submit(
                req.transactions, req.version, req.version - window
            )
        ctx = _ParkedResolve(entry, req, reply, first_unseen, t_enter,
                             span=bspan)
        self._pipe_ctx.append(ctx)
        self.version.set(req.version)
        self.metrics.histogram("pipeline_inflight_depth").add(
            len(self._pipe_ctx)
        )
        self.metrics.gauge("pipeline_occupancy").set(len(self._pipe_ctx))
        # Submit-then-complete: the host packed/encoded THIS batch while
        # the device computed its predecessors; completing the oldest now
        # syncs it (overlapped) and applies its mirror writes under our
        # own device compute.
        self._pipeline_pump(self.conflicts.pipeline_depth - 1, "device")
        if ctx.finished:
            return
        loop = self.process.network.loop
        flush = self.pipeline_flush_seconds
        from ..flow.eventloop import first_of

        while not ctx.finished:
            timer = loop.delay(flush)
            await first_of(ctx.future, timer)
            loop.cancel_timer(timer)
            if not ctx.finished:
                # Idle flush: no successor pushed us out within the
                # deadline — drain (in order) through our own batch.
                self._pipeline_flush_through(ctx)

    def _pipeline_flush_through(self, ctx: _ParkedResolve):
        while not ctx.finished:
            self._pipeline_pump(len(self._pipe_ctx) - 1, "flush")

    def _pipeline_pump(self, bound: int, cause: str):
        """Finish parked resolves oldest-first until at most `bound`
        remain.  `cause` feeds the stall accounting: "device" = a
        submit's depth bound forced the completion (the host blocked on
        a device sync — the steady-state overlap), "flush" = the idle
        flush drained it (the device sat idle waiting for host/traffic)."""
        self._pipeline_sweep(cause)
        while len(self._pipe_ctx) > bound:
            # The conflict set completes its OLDEST in-flight batch (a
            # mid-pipeline fault replay may complete several at once);
            # the sweep then finishes every context whose verdicts
            # landed, preserving version order.
            self.conflicts.pipeline_complete_oldest()
            self._pipeline_sweep(cause)

    def _pipeline_sweep(self, cause: str):
        while self._pipe_ctx and self._pipe_ctx[0].entry.done:
            ctx = self._pipe_ctx.popleft()
            self._finish_resolve(ctx, cause)

    def _finish_resolve(self, ctx: _ParkedResolve, cause: str):
        """Completion phase of one pipelined resolve: the synchronous
        path's shared post-verdict bookkeeping (_complete_resolve — one
        implementation, no drift) plus the pipeline's stall accounting.
        Runs synchronously inside whichever handler drives the pump, so
        no other actor can interleave between verdict landing and reply."""
        self._complete_resolve(
            ctx.req, ctx.reply, ctx.entry.statuses, ctx.entry.degraded,
            ctx.first_unseen, ctx.t_enter, span=ctx.span,
            witness=(
                getattr(ctx.entry, "witness", None)
                if self._witness_on else None
            ),
        )
        self._note_device_span(ctx.entry)
        # Stall accounting + the wedged-pipeline black box: a pipeline
        # that is ON but only ever drains by the idle flush achieves zero
        # overlap — after a sustained streak, freeze a flight-recorder
        # artifact (cooldown-gated per resolver) so the state that led
        # here survives the incident.  Only batches that actually went
        # through the device pipeline count (ticket set): CPU-routed
        # pre-completed entries neither stalled on a device sync nor say
        # anything about overlap, so they must not inflate device_stalls
        # or break a flush streak.  "drain" completions (the mirror-check
        # barrier) are neither stall kind and leave the streak alone.
        m = self.metrics
        if ctx.entry.ticket is None:
            pass
        elif cause == "flush":
            m.counter("pipeline_host_stalls").add()
            self._flush_streak += 1
            if self._flush_streak >= self.pipeline_stall_batches:
                from ..flow.flight_recorder import maybe_trigger

                captured = maybe_trigger(
                    "pipeline_stall",
                    detail={
                        "streak": self._flush_streak,
                        "depth": getattr(self.conflicts, "pipeline_depth", 1),
                        "version": ctx.req.version,
                    },
                    source=self.metrics.name,
                )
                if captured is not None:
                    # Reset only on an ACTUAL capture: a cooldown-
                    # suppressed attempt must retry at the very next
                    # flush completion, not after another full streak.
                    self._flush_streak = 0
        elif cause == "device":
            m.counter("pipeline_device_stalls").add()
            self._flush_streak = 0
        m.gauge("pipeline_occupancy").set(len(self._pipe_ctx))
        ctx._mark_finished()

    def _note_device_span(self, entry) -> None:
        """Fold one completed device in-flight span into the pipeline
        overlap-efficiency gauge: overlapped device time /
        total device time, on the span hub's deterministic event-
        sequence clock.  Device spans complete in dispatch order, so the
        union is maintained with one high-water mark.  The wall-clock
        twin accumulates in the record_wall namespace only (real-mode
        tooling; never a sim-compared snapshot)."""
        sp = getattr(entry, "device_span", None)
        if sp is None or sp.seq is None or sp.end_seq is None:
            return
        if any(k in sp.attrs for k in ("fault", "replayed", "diverged")):
            # Fault/divergence paths end parked device spans at DRAIN
            # time — near-identical intervals whose mutual "overlap" is
            # mirror-replay bookkeeping, not overlapped device compute.
            # Folding them in would report high efficiency exactly when
            # the device did no useful work.
            return
        m = self.metrics
        b, e = sp.seq, sp.end_seq
        self._dev_seq_total += e - b
        hwm = self._dev_seq_hwm
        self._dev_seq_union += e - b if (hwm is None or b >= hwm) else max(
            0, e - hwm
        )
        self._dev_seq_hwm = e if hwm is None else max(hwm, e)
        if self._dev_seq_total > 0:
            m.gauge("pipeline_overlap_efficiency").set(
                round(
                    (self._dev_seq_total - self._dev_seq_union)
                    / self._dev_seq_total,
                    4,
                )
            )
        host = getattr(self.conflicts, "host_phase_seq", 0)
        if host + self._dev_seq_total > 0:
            m.gauge("host_fraction").set(
                round(host / (host + self._dev_seq_total), 4)
            )
        if sp.wall_end is not None:
            wb, we = sp.wall_start, sp.wall_end
            whwm = self._dev_wall_hwm
            covered = we - wb if (whwm is None or wb >= whwm) else max(
                0.0, we - whwm
            )
            self._dev_wall_hwm = we if whwm is None else max(whwm, we)
            m.record_wall("device_span_seconds", we - wb)
            m.record_wall("device_overlap_seconds", (we - wb) - covered)
