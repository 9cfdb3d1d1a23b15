"""Ratekeeper: cluster-wide admission control.

The port's own copy of the reference package's ``server/ratekeeper.py``.
The reference's server knobs it reads (``ratekeeper_*`` and
``sim_disk_capacity_bytes``) are constructor arguments here, with the
reference's defaults and without the ``ratekeeper_`` prefix.  The commit
chain sampler reads the port's global trace collector.

Ref: fdbserver/Ratekeeper.actor.cpp — trackStorageServerQueueInfo :138 /
trackTLogQueueInfo :179 sample every log and storage server; updateRate
:251-340 computes a global transactions-per-second limit from the worst
queues (a "spring" that compresses as the lag approaches the limit); proxies
fetch the limit with their GRV loop (rateKeeper :509) and release queued
read-version requests no faster than the budget.

The primary signal is version lag (log durable version minus storage
applied version): storage falling behind the log is exactly the condition
the reference's MVCC window protects (reads older than the window die with
transaction_too_old), so admission slows before the window is overrun.

Overload-aware springs extend the SS/TLog-only view to the stack's own
bottleneck, the resolver's conflict path on the card:

  resolver_queue   resolve batches in flight or parked on the prevVersion
                   chain (Resolver.queue_depth / the `signals` RPC)
  resolve_latency  recent-window resolve p99 in virtual seconds
  commit_latency   commit p99 reassembled INCREMENTALLY from the
                   CommitDebug trace events (CommitChainSampler); falls
                   back to the proxies' reported sample when the trace
                   collector is file-backed (real mode)
  backend_degraded the conflict set's circuit breaker: while verdicts fall
                   back to the CPU mirror the TPS limit contracts to
                   degraded_tps_fraction of max (optionally clamped to the
                   MEASURED CPU-mirror throughput from
                   ConflictSet.backend_signal() — real mode only, the
                   measurement is wall-clock derived); for a sharded
                   resolver in proportion to its degraded shards

`limiting` names whichever signal set the rate; every change of the
binding signal is appended to a replayable `transitions` log (same seed =>
byte-identical, transition_log_json).
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

from ..rpc.network import SimProcess
from ..rpc.stream import RequestStream, RequestStreamRef


@dataclass
class RateInfo:
    tps: float = 1e9
    batch_tps: float = 1e9  # the lower-priority lane's (tighter) limit
    lag_versions: int = 0
    worst_ss_queue_bytes: int = 0
    worst_tlog_queue_bytes: int = 0
    min_free_bytes: int = 1 << 62
    # Overload-aware signals: worst across resolvers/proxies.
    resolver_queue_depth: int = 0
    resolve_p99: float = 0.0
    commit_p99: float = 0.0
    backend_state: str = "ok"  # ok | degraded | probing (worst resolver)
    grv_queue_depth: int = 0  # worst proxy-reported GRV admission queue
    mirror_divergence: int = 0  # total confirmed mirror divergences
    # The BINDING degraded resolver's (degraded, total) shard counts; 0/0
    # when nothing is degraded OR the binding degraded resolver is
    # single-device (the whole-lane clamp then applies).
    shards_degraded: int = 0
    shards_total: int = 0
    limiting: str = "none"  # which signal set the rate


@dataclass
class RatekeeperInterface:
    get_rate: RequestStreamRef = None


@dataclass
class Signals:
    """One sample of every spring input (see _collect_signals)."""

    lag: int = 0
    ss_queue: int = 0
    tlog_queue: int = 0
    free: int = 1 << 62
    resolver_queue: int = 0
    resolve_p99: float = 0.0
    commit_p99: float = 0.0
    backend_state: str = "ok"
    cpu_mirror_tps: float = 0.0  # measured; 0.0 = unknown
    grv_queue_depth: int = 0
    # Summed confirmed mirror/device divergences across resolvers.
    # Informational — each one already opened that resolver's breaker, so
    # backend_state carries the spring.
    mirror_divergence: int = 0
    # The BINDING degraded resolver's shard counts
    # (_binding_shard_fraction); 0/0 = whole-lane clamp.
    shards_degraded: int = 0
    shards_total: int = 0
    # RPC mode only: a whole commit-critical role class (every tlog, or
    # every storage) is unreachable — the cluster is mid-recovery.
    unreachable: bool = False


class CommitChainSampler:
    """Incremental CommitDebug consumer: reassembles the commit total stage
    (client Before -> After) from the global IN-MEMORY trace collector,
    one pass over only the events that arrived since the last sample, into
    a sliding window whose exact p99 feeds the commit_latency spring.
    Deterministic by construction (virtual-time event stamps, no
    reservoir).  Returns None when the collector is file-backed (events
    spooled, not retained — real mode) or nothing observed yet.

    OPEN chains are a signal too: a commit whose Before has no After yet
    is IN the pipeline, and during a grey failure the completed-duration
    window goes quiet exactly when latency is worst.  With `now`, the age
    of the oldest open chain folds into the p99 (max-combine).  Failed
    attempts close their chain via NativeAPI.commit.Error, and opens older
    than `horizon` are pruned, so an abandoned chain cannot hold the
    signal up forever."""

    WINDOW = 128
    FROM = "NativeAPI.commit.Before"
    TO = "NativeAPI.commit.After"
    ERR = "NativeAPI.commit.Error"

    def __init__(self):
        self._col = None
        self._cursor = 0
        self._open: dict = {}  # debug id -> Before time
        self._window = deque(maxlen=self.WINDOW)

    def sample(
        self, now: Optional[float] = None, horizon: Optional[float] = None
    ) -> Optional[float]:
        from ..flow.spans import percentile
        from ..flow.trace import global_collector

        col = global_collector()
        if col.path is not None:
            return None
        if col is not self._col or len(col.events) < self._cursor:
            # New or cleared collector: restart the incremental scan.
            self._col, self._cursor = col, 0
            self._open.clear()
            self._window.clear()
        events = col.events
        for i in range(self._cursor, len(events)):
            e = events[i]
            if e.get("Type") != "CommitDebug":
                continue
            did, loc = e.get("ID"), e.get("Location")
            if did is None:
                continue
            if loc == self.FROM:
                self._open.setdefault(did, e["Time"])
            elif loc == self.TO:
                t0 = self._open.pop(did, None)
                if t0 is not None and e["Time"] >= t0:
                    self._window.append(e["Time"] - t0)
            elif loc == self.ERR:
                self._open.pop(did, None)  # attempt failed: not a wedge
        self._cursor = len(events)
        if now is not None and horizon is not None:
            for k in [
                k for k, t0 in self._open.items() if now - t0 > horizon
            ]:
                del self._open[k]
        if len(self._open) > 1024:
            # Commits that never resolved (client died mid-pipeline):
            # drop the oldest half, deterministically (insertion order).
            for k in list(self._open)[: len(self._open) - 512]:
                del self._open[k]
        p99 = percentile(list(self._window), 0.99)
        if now is not None and self._open:
            oldest_age = now - min(self._open.values())
            p99 = max(p99 or 0.0, oldest_age)
        return p99


# Construction-order ids (deterministic under the sim, unlike id()): the
# flight-recorder cooldown key for concurrent distinct generations.
_RK_SEQ = itertools.count()


class Ratekeeper:
    # Proxies fetch at most every 0.1s (the GRV loop's fetch throttle);
    # several missed intervals means the proxy is gone, not slow.
    _REPORT_TTL = 2.0

    def __init__(
        self,
        process: SimProcess,
        tlogs: List[object] = (),  # TLog role objects (direct metric access)
        storages: List[object] = (),
        sample_interval: float = 0.25,
        fs=None,  # SimFileSystem: enables the disk-free spring
        tlog_ifaces: List[object] = (),  # RPC mode (recruited ratekeeper):
        storage_ifaces: List[object] = (),  # polls metrics like the ref's
        # trackStorageServerQueueInfo / trackTLogQueueInfo actors.
        resolvers: List[object] = (),  # Resolver role objects (in-process)
        resolver_ifaces: List[object] = (),  # RPC mode: `signals` probes
        proxies: List[object] = (),  # Proxy role objects (in-process)
        max_tps: float = 100000.0,
        min_tps: float = 10.0,
        target_lag_versions: int = 500_000,
        spring_lag_versions: int = 2_000_000,
        target_ss_queue_bytes: int = 4 << 20,
        spring_ss_queue_bytes: int = 2 << 20,
        target_tlog_queue_bytes: int = 8 << 20,
        spring_tlog_queue_bytes: int = 4 << 20,
        min_free_bytes: int = 4 << 20,
        target_free_bytes: int = 16 << 20,
        sim_disk_capacity_bytes: int = 1 << 30,
        batch_target_fraction: float = 0.5,
        target_resolver_queue: int = 8,
        spring_resolver_queue: int = 16,
        target_resolve_p99: float = 0.25,
        spring_resolve_p99: float = 0.5,
        target_commit_p99: float = 0.5,
        spring_commit_p99: float = 1.0,
        degraded_tps_fraction: float = 0.25,
        # Wall-clock derived, so off in simulation, where rate decisions
        # must replay from the seed.
        use_measured_cpu_tps: bool = False,
    ):
        self.process = process
        self.rk_id = next(_RK_SEQ)
        self.tlogs = list(tlogs)
        self.storages = list(storages)
        self.tlog_ifaces = list(tlog_ifaces)
        self.storage_ifaces = list(storage_ifaces)
        self.resolvers = list(resolvers)
        self.resolver_ifaces = list(resolver_ifaces)
        self.proxies = list(proxies)
        self.fs = fs
        self.sample_interval = sample_interval
        self.max_tps = max_tps
        self.min_tps = min_tps
        self.target_lag_versions = target_lag_versions
        self.spring_lag_versions = spring_lag_versions
        self.target_ss_queue_bytes = target_ss_queue_bytes
        self.spring_ss_queue_bytes = spring_ss_queue_bytes
        self.target_tlog_queue_bytes = target_tlog_queue_bytes
        self.spring_tlog_queue_bytes = spring_tlog_queue_bytes
        self.min_free_bytes = min_free_bytes
        self.target_free_bytes = target_free_bytes
        self.sim_disk_capacity_bytes = sim_disk_capacity_bytes
        self.batch_target_fraction = batch_target_fraction
        self.target_resolver_queue = target_resolver_queue
        self.spring_resolver_queue = spring_resolver_queue
        self.target_resolve_p99 = target_resolve_p99
        self.spring_resolve_p99 = spring_resolve_p99
        self.target_commit_p99 = target_commit_p99
        self.spring_commit_p99 = spring_commit_p99
        self.degraded_tps_fraction = degraded_tps_fraction
        self.use_measured_cpu_tps = use_measured_cpu_tps
        self.rate = RateInfo(tps=max_tps)
        self._chain_sampler = CommitChainSampler()
        # Latest per-proxy report riding the rate fetch, stamped with its
        # arrival time: proxy_id -> (loop.now(), GetRateInfoRequest).  A
        # proxy that stops fetching must not leave a stale report driving
        # the commit_latency spring forever — reports expire after
        # _REPORT_TTL seconds.
        self._proxy_reports: dict = {}
        # Replayable admission log: [sample_seq, from_limiting, to_limiting,
        # tps rounded] appended whenever the binding signal changes.  Same
        # seed => byte-identical.  Bounded: the deque drops the oldest
        # entries, and same-seed runs cap identically.
        self.sample_seq = 0
        self.transitions = deque(maxlen=4096)
        # The rate decision and every spring input as gauges, sampled into
        # the time-series ring so a flight-recorder capture shows what
        # admission was doing in the window BEFORE a trigger.
        from ..flow.timeseries import spawn_sampler
        from ..metrics import MetricsRegistry

        self.metrics = MetricsRegistry("Ratekeeper", rng=process.network.loop.rng)
        self.metrics.counter("limiting_changes")
        for _g in ("tps", "batch_tps", "lag_versions", "ss_queue_bytes",
                   "tlog_queue_bytes", "resolver_queue_depth",
                   "grv_queue_depth", "commit_p99_ms", "resolve_p99_ms"):
            self.metrics.gauge(_g)
        self._stream = RequestStream(process, "rk_get_rate", well_known=True)
        process.spawn_observed(self._update_loop(), "rk_update")
        process.spawn_observed(self._serve(), "rk_serve")
        spawn_sampler(process, "Ratekeeper", self.metrics)

    def interface(self) -> RatekeeperInterface:
        return RatekeeperInterface(get_rate=self._stream.ref())

    def _live_reports(self, now: float) -> list:
        """Un-expired proxy reports; expired entries are dropped in place."""
        dead = [
            pid
            for pid, (t, _r) in self._proxy_reports.items()
            if now - t > self._REPORT_TTL
        ]
        for pid in dead:
            del self._proxy_reports[pid]
        return [r for _t, r in self._proxy_reports.values()]

    def transition_log_json(self) -> str:
        """Canonical byte form of the admission transition log (what a
        same-seed replay compares)."""
        import json

        return json.dumps(list(self.transitions), separators=(",", ":"))

    @staticmethod
    def _spring(x: float, target: float, spring: float) -> float:
        """The spring: full rate up to `target`, compressing linearly to
        zero over `spring` beyond it (ref updateRate's
        (targetBytes - queueBytes) / springBytes shaping, :251-340)."""
        if x <= target:
            return 1.0
        return max(0.0, 1.0 - (x - target) / spring)

    @staticmethod
    def _free_factor(free: float, target: float, minimum: float) -> float:
        """Full rate while free space >= target, zero at <= minimum,
        linear between (ref: the MIN_FREE_SPACE clamp in updateRate)."""
        if free >= target:
            return 1.0
        if free <= minimum:
            return 0.0
        return (free - minimum) / (target - minimum)

    async def _collect_signals(self) -> Signals:
        """Every spring input in one sample, from direct role objects
        (in-process mode) and/or RPC metric probes (recruited mode — ref
        trackStorageServerQueueInfo :138 / trackTLogQueueInfo :179; the
        resolver probes use the cheap `signals` stream)."""
        from ..flow.error import FdbError
        from .interfaces import GetStorageMetricsRequest

        sig = Signals()
        log_vs = [t.durable.get() for t in self.tlogs]
        ss_vs = [s.version.get() for s in self.storages]
        ss_qs = [s.queue_bytes for s in self.storages]
        tl_qs = [getattr(t, "_mem_bytes", 0) for t in self.tlogs]
        tl_ok = 0
        for tl in self.tlog_ifaces:
            try:
                m = await tl.metrics.get_reply(self.process, None)
                log_vs.append(m.durable_version)
                tl_qs.append(m.queue_bytes)
                tl_ok += 1
            except FdbError:
                continue  # unreachable log: recovery is the real handler
        ss_ok = 0
        for ss in self.storage_ifaces:
            try:
                m = await ss.get_storage_metrics.get_reply(
                    self.process,
                    GetStorageMetricsRequest(signals_only=True),
                )
                ss_vs.append(m.version)
                ss_qs.append(m.queue_bytes)
                ss_ok += 1
            except FdbError:
                continue
        # A WHOLE commit-critical role class unreachable (every log, or
        # every storage we poll) means the cluster is mid-recovery: floor
        # admission instead of keeping the last healthy rate.  RPC mode
        # only; in-process mode reads role objects directly.
        sig.unreachable = bool(
            (self.tlog_ifaces and tl_ok == 0)
            or (self.storage_ifaces and ss_ok == 0)
        )
        log_v = max(log_vs, default=0)
        ss_v = min(ss_vs, default=log_v)
        sig.lag = max(0, log_v - ss_v)
        sig.ss_queue = max(ss_qs, default=0)
        sig.tlog_queue = max(tl_qs, default=0)
        if self.fs is not None:
            used: dict = {}
            for (mid, _name), f in self.fs._files.items():
                used[mid] = used.get(mid, 0) + len(f.durable)
            # Direct-object mode knows which machines host roles; RPC mode
            # conservatively covers every machine with files.
            roles = {
                p.process.machine.machine_id
                for p in list(self.tlogs) + list(self.storages)
            } or set(used)
            cap = self.sim_disk_capacity_bytes
            for mid in roles:
                sig.free = min(sig.free, max(0, cap - used.get(mid, 0)))
        # Resolver signals: worst queue/latency, worst backend state,
        # SLOWEST measured CPU mirror (the binding one when degraded).
        states = {"ok": 0, "probing": 1, "degraded": 2}
        worst_state = "ok"
        mirror_tps = 0.0
        snaps = [r.signal_snapshot() for r in self.resolvers]
        for ri in self.resolver_ifaces:
            if getattr(ri, "signals", None) is None:
                continue
            try:
                snaps.append(await ri.signals.get_reply(self.process, None))
            except FdbError:
                continue  # dead resolver: recovery replaces it
        for s in snaps:
            sig.resolver_queue = max(sig.resolver_queue, s.queue_depth)
            sig.resolve_p99 = max(sig.resolve_p99, s.resolve_p99)
            sig.mirror_divergence += getattr(s, "mirror_divergence", 0)
            if states[s.backend_state] > states[worst_state]:
                worst_state = s.backend_state
            if s.backend_state != "ok" and s.cpu_mirror_tps > 0:
                mirror_tps = (
                    s.cpu_mirror_tps
                    if mirror_tps == 0.0
                    else min(mirror_tps, s.cpu_mirror_tps)
                )
        sig.backend_state = worst_state
        sig.cpu_mirror_tps = mirror_tps
        sig.shards_degraded, sig.shards_total = (
            self._binding_shard_fraction(snaps)
        )
        # Commit latency: the incremental CommitDebug reassembly when the
        # in-memory collector is live; else the proxies' passive samples
        # (direct role objects, or the reports riding their rate fetches).
        # The horizon bounds how long an open (wedged/abandoned) chain can
        # age the signal.
        loop = self.process.network.loop
        horizon = 2.0 * (self.target_commit_p99 + self.spring_commit_p99)
        p99 = self._chain_sampler.sample(now=loop.now(), horizon=horizon)
        reports = self._live_reports(loop.now())
        if p99 is None:
            candidates = [r.commit_p99 for r in reports if r.commit_p99 > 0]
            for p in self.proxies:
                sample = getattr(p, "latency_samples", {}).get("commit")
                v = sample.percentile(0.99) if sample is not None else None
                if v:
                    candidates.append(v)
            p99 = max(candidates, default=0.0)
        sig.commit_p99 = p99 or 0.0
        sig.grv_queue_depth = max(
            (r.grv_queue_depth for r in reports), default=0
        )
        return sig

    def _limit(self, sig: Signals, target_frac: float):
        """TPS limit for one priority lane: min over every signal's spring
        at `target_frac` of the configured targets (the batch lane runs the
        same springs at tighter targets — ref the separate batch limiter)."""
        factors = {
            "ss_lag": self._spring(
                sig.lag,
                self.target_lag_versions * target_frac,
                self.spring_lag_versions * target_frac,
            ),
            "ss_queue": self._spring(
                sig.ss_queue,
                self.target_ss_queue_bytes * target_frac,
                self.spring_ss_queue_bytes * target_frac,
            ),
            "tlog_queue": self._spring(
                sig.tlog_queue,
                self.target_tlog_queue_bytes * target_frac,
                self.spring_tlog_queue_bytes * target_frac,
            ),
            # Free space springs the other way: LOW free compresses.  The
            # batch lane throttles EARLIER (at a higher free watermark).
            "disk_free": self._free_factor(
                sig.free,
                self.target_free_bytes / target_frac,
                self.min_free_bytes,
            ),
            # Resolver-path springs: queue depth in batches and the
            # recent-window resolve p99 in virtual seconds.
            "resolver_queue": self._spring(
                sig.resolver_queue,
                self.target_resolver_queue * target_frac,
                self.spring_resolver_queue * target_frac,
            ),
            "resolve_latency": self._spring(
                sig.resolve_p99,
                self.target_resolve_p99 * target_frac,
                self.spring_resolve_p99 * target_frac,
            ),
            "commit_latency": self._spring(
                sig.commit_p99,
                self.target_commit_p99 * target_frac,
                self.spring_commit_p99 * target_frac,
            ),
            "backend_degraded": self._degraded_factor(sig, target_frac),
            # Mid-recovery floor (see _collect_signals.unreachable): 0.0
            # compresses the lane to min_tps until a healthy generation's
            # ratekeeper replaces this one.
            "recovering": 0.0 if sig.unreachable else 1.0,
        }
        limiting = min(factors, key=lambda k: factors[k])
        factor = factors[limiting]
        tps = max(self.min_tps, self.max_tps * factor)
        return tps, (limiting if factor < 1.0 else "none")

    @staticmethod
    def _binding_shard_fraction(snaps) -> tuple:
        """(shards_degraded, shards_total) of the BINDING degraded
        resolver — the one whose sick fraction is largest — considering
        only resolvers that are actually degraded/probing: a HEALTHY
        sharded resolver's 0/N detail must never dilute another
        resolver's clamp.  A degraded resolver WITHOUT shard detail
        (single-device) is the whole lane — returns (0, 0), which
        _degraded_factor treats as the plain whole-lane clamp, the most
        conservative, so it overrides any proportional detail."""
        best = None  # (deg, tot) of the worst sick fraction seen
        for s in snaps:
            if s.backend_state == "ok":
                continue
            tot = getattr(s, "shards_total", 0)
            deg = getattr(s, "shards_degraded", 0)
            if tot <= 0:
                return (0, 0)  # whole lane: nothing binds harder
            if best is None or deg * best[1] > best[0] * tot:
                best = (deg, tot)
        return best if best is not None else (0, 0)

    def _degraded_factor(self, sig: Signals, target_frac: float) -> float:
        """Not a spring but a cap: while the device circuit is open (or
        probing) and verdicts fall back to the CPU mirror, the lane's rate
        contracts to degraded_tps_fraction of max — the GRV lane must not
        pile requests onto a degraded resolver.  With use_measured_cpu_tps
        (real mode; the measurement is wall-clock derived and would break
        same-seed replay in sim) the cap additionally clamps to 80% of the
        measured CPU-mirror throughput.

        When the degraded resolver is sharded, only shards_degraded of
        shards_total key ranges fell back to their mirrors — the healthy
        shards keep full device throughput — so the cap contracts
        PROPORTIONALLY: ((total - degraded) + degraded * frac) / total.  A
        single-device resolver (shards_total == 0) keeps the whole-lane
        clamp."""
        if sig.backend_state == "ok":
            return 1.0
        frac = self.degraded_tps_fraction
        if self.use_measured_cpu_tps and sig.cpu_mirror_tps > 0:
            frac = min(frac, 0.8 * sig.cpu_mirror_tps / self.max_tps)
        if sig.shards_total > 0:
            deg = min(sig.shards_degraded, sig.shards_total)
            frac = (
                (sig.shards_total - deg) + deg * frac
            ) / sig.shards_total
        return max(0.0, frac * target_frac)

    async def _update_loop(self):
        """Ref updateRate :251-340: springs on worst storage queue, worst
        tlog queue, version lag, free disk, and the resolver/device path;
        a separate tighter batch lane."""
        loop = self.process.network.loop
        while True:
            await loop.delay(self.sample_interval)
            sig = await self._collect_signals()
            tps, limiting = self._limit(sig, 1.0)
            batch_tps, _ = self._limit(sig, self.batch_target_fraction)
            self.sample_seq += 1
            if limiting != self.rate.limiting:
                self.transitions.append(
                    [self.sample_seq, self.rate.limiting, limiting,
                     round(tps, 3)]
                )
                self.metrics.counter("limiting_changes").add()
                # Marker span: admission transitions on the same timeline
                # as the commit-path spans they throttle.
                from ..flow.spans import instant

                instant(
                    "ratekeeper.limiting", role="Ratekeeper",
                    attrs={"from": self.rate.limiting, "to": limiting,
                           "tps": round(tps, 3)},
                )
                # Flight-recorder trigger: the binding signal changed —
                # freeze the window that explains why.  The per-kind
                # cooldown keeps a flapping spring from churning the
                # capture ring; "-> none" (release) never triggers.
                if limiting != "none":
                    from ..flow.flight_recorder import maybe_trigger

                    maybe_trigger(
                        "ratekeeper_limiting",
                        detail={"from": self.rate.limiting, "to": limiting,
                                "tps": round(tps, 3)},
                        # Thunk: the (up to 4096-entry) log is copied only
                        # for captures the cooldown lets through.
                        transitions=lambda: [
                            list(t) for t in self.transitions
                        ],
                        source=self.rk_id,  # per-generation cooldown
                    )
            g = self.metrics.gauge
            g("tps").set(round(tps, 3))
            g("batch_tps").set(round(batch_tps, 3))
            g("lag_versions").set(sig.lag)
            g("ss_queue_bytes").set(sig.ss_queue)
            g("tlog_queue_bytes").set(sig.tlog_queue)
            g("resolver_queue_depth").set(sig.resolver_queue)
            g("grv_queue_depth").set(sig.grv_queue_depth)
            # Milliseconds rounded: a gauge sampled into the time series
            # should not carry float noise digits.
            g("commit_p99_ms").set(round(sig.commit_p99 * 1e3, 3))
            g("resolve_p99_ms").set(round(sig.resolve_p99 * 1e3, 3))
            self.rate = RateInfo(
                tps=tps,
                batch_tps=batch_tps,
                lag_versions=sig.lag,
                worst_ss_queue_bytes=sig.ss_queue,
                worst_tlog_queue_bytes=sig.tlog_queue,
                min_free_bytes=sig.free,
                resolver_queue_depth=sig.resolver_queue,
                resolve_p99=sig.resolve_p99,
                commit_p99=sig.commit_p99,
                backend_state=sig.backend_state,
                grv_queue_depth=sig.grv_queue_depth,
                mirror_divergence=sig.mirror_divergence,
                shards_degraded=sig.shards_degraded,
                shards_total=sig.shards_total,
                limiting=limiting,
            )

    async def _serve(self):
        loop = self.process.network.loop
        while True:
            req, reply = await self._stream.pop()
            if req is not None:
                # The proxy's demand report rides its fetch (ref:
                # GetRateInfoRequest.totalReleasedTransactions).
                self._proxy_reports[req.proxy_id] = (loop.now(), req)
            reply.send(self.rate)
