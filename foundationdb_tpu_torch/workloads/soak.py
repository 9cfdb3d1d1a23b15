"""Sustained chaos-soak harness: the millions-of-users rehearsal.

Every chaos and perf claim before this was a short sim run or a
single-process bench; this module proves the system *stays up* under
sustained load while faults fire.  It drives configurable open/closed-loop
load with Zipf hot-key skew, mixed transaction shapes, and ramping arrival
rates against a rated cluster (SimCluster + Ratekeeper, or a DynamicCluster
whose controller recruits one), layers a scripted fault matrix on top —
process kills, one-directional clogs, a mid-soak device outage via
DeviceFaultInjector, recovery — and reports per-phase **goodput**
(committed transactions, not attempts; the metric PAPERS.md's
contention-management line says matters under overload), latency-chain
p99s, throttle/shed counts, the fault timeline, and the ratekeeper +
breaker transition logs.

Everything is virtual-time + DeterministicRandom: two same-seed runs
produce byte-identical reports (the replay gate tests/test_soak.py pins).
This harness is the regression gate later perf PRs (Pallas kernels,
multi-chip) reuse: `cli soak --format=json` emits a BENCH-style artifact.

The port's own copy of the reference package's ``workloads/soak.py``.  The
reference's device backend "jax" is the port's "torch" ("cpu", "hybrid"
and "sharded" keep their names).  The knobs the reference writes for a run
and restores after are the arguments of what the run builds:
``Database(latency_sample_rate=1.0, witness_retry=)`` for every client
(and the dynamic cluster's controllers' own), ``Ratekeeper(max_tps=,
degraded_tps_fraction=)``, the proxies' ``grv_queue_max``, and the
resolvers' set settings ``key_words`` and ``max_device_key_bytes``
(``device_key_words``, ``device_key_bytes``).  Two fields are the port's
own: ``resolver_settings``, further arguments of every resolver's
``ConflictSet`` (the reference's other ``conflict_*`` knobs; None leaves
the Resolver's defaults), and ``device``, where the conflict sets run
(None: the card, raising without one; ``"cpu"``: the kernels' plain
twins).  The "sharded" backend's ``ShardedTorchConflictSet`` puts
``max(2, sharded_shards)`` shards on that one device.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field
from typing import List, Optional

from ..flow.error import FdbError
from ..flow.latency_chain import (
    COMMIT_CHAIN,
    GRV_CHAIN,
    percentile,
    summarize_stages,
)


@dataclass
class SoakPhase:
    """One load phase.  Open loop: transactions ARRIVE at `arrival_tps`
    regardless of completions (the overload-capable mode); closed loop:
    `actors` clients each keep one transaction in flight."""

    name: str = "phase"
    duration: float = 5.0  # sim seconds
    arrival_tps: float = 50.0
    actors: int = 8
    # Shape mix (remainder = blind writes): fractions of arrivals.
    read_fraction: float = 0.25
    rmw_fraction: float = 0.5


@dataclass
class FaultEvent:
    """One scripted fault.  kinds: "kill" (process kill + revive; dynamic
    clusters only), "clog" (ONE-directional network clog — the grey
    failure where requests land but replies stall), "device_outage"
    (persistent dispatch outage on one resolver's device engine via
    DeviceFaultInjector.begin_outage/end_outage), "shard_kill"
    (the device outage scoped to ONE shard of a mesh-sharded resolver —
    only that shard's breaker opens and serves degraded off its mirror
    while the surviving shards keep the goodput floor on device;
    backend="sharded"), "shard_move" (a scripted live reshard
    — split points recomputed from occupancy quantiles and migrated
    mid-stream; composes with shard_kill to exercise the
    reshard-during-fault legality rules, deferred/degraded per seed)."""

    at: float = 0.0  # sim seconds from soak start
    kind: str = "clog"
    duration: float = 1.5  # clog/outage hold; kills recover via recruitment
    target: str = ""  # kill: role name (default storage0)
    shard: int = 0  # shard_kill: which shard's chip dies; shard_move:
    # target shard count for the scripted reshard (0 = keep current)


@dataclass
class SoakConfig:
    seed: int = 1
    cluster: str = "sim"  # sim | dynamic (kills need dynamic)
    backend: str = "torch"  # conflict backend (device faults need torch/hybrid)
    mode: str = "open"  # open | closed
    keys: int = 512
    zipf_theta: float = 0.9  # 0 = uniform
    value_bytes: int = 32
    # Distinct client Database handles the load fans over.  One handle's
    # GRV batcher coalesces concurrent read-version fetches into a single
    # in-flight request, so proxy-side admission (queue depth, shed) only
    # sees real pressure when many CLIENTS contend — the thing a
    # millions-of-users rehearsal is about.
    clients: int = 4
    phases: List[SoakPhase] = field(default_factory=list)
    faults: List[FaultEvent] = field(default_factory=list)
    max_in_flight: int = 512  # open-loop client-side cap (memory bound)
    max_attempts: int = 8  # per-transaction retry budget
    drain_timeout: float = 15.0  # sim seconds to wait for stragglers
    rk_sample_interval: float = 0.1
    n_resolvers: int = 1
    buggify: bool = False  # scripted faults only, by default
    # SLO: commit-chain p99 bound (sim seconds) and per-phase goodput
    # floor as a fraction of that phase's arrival rate (open loop) or an
    # absolute committed/s floor (closed loop).
    slo_commit_p99: float = 2.0
    goodput_floor_frac: float = 0.3
    goodput_floor_tps: float = 1.0
    # Knob overrides applied for the run (None = leave as configured).
    max_tps: Optional[float] = None
    grv_queue_max: Optional[int] = None
    degraded_tps_fraction: Optional[float] = None
    # Device key budget: a DynamicCluster's system-keyspace metadata keys
    # (\xff/keyServers/..., \xff/serverList/...) exceed the default
    # 16-byte device width, which would route every mixed batch to the
    # CPU mirror; widen so the device path actually serves the soak.
    device_key_words: Optional[int] = None
    device_key_bytes: Optional[int] = None
    # backend="sharded": shard count for the mesh-sharded
    # resolver 0 conflict set (sim clusters only; capped to the visible
    # device count).
    sharded_shards: int = 4
    # Elastic resharding: ceiling for live shard-count
    # scaling (None = frozen at sharded_shards; >sharded_shards hands
    # the conflict set the full device list so the balancer can scale).
    sharded_max_shards: Optional[int] = None
    # Period of the soak's ShardBalancer driver (sim seconds; None/0
    # disables).  The driver feeds the balancer the ratekeeper's binding
    # signal as admission pressure and the resolver's decayed
    # witness-range sample as per-shard load.
    shard_balance_seconds: Optional[float] = None
    # Rotate the Zipf ranks through key space: hot rank r maps to key
    # index (r + hot_offset) % keys, so the hot set can be pinned to a
    # chosen shard's interior instead of always key 0 (default 0 keeps
    # every existing workload byte-identical).
    hot_offset: int = 0
    # Witness-guided retry arm: None leaves the clients'
    # default (on); True/False sets it for the run — the A/B seam
    # run_contention_ab drives.
    witness_retry: Optional[bool] = None
    # Further ConflictSet arguments of every resolver's set (history
    # capacity, pipeline depth, ...); None leaves the Resolver's defaults.
    resolver_settings: Optional[dict] = None
    # Where the conflict sets run: None is the card (raising without one),
    # "cpu" the kernels' plain twins.
    device: object = None


def default_phases(peak_tps: float, total_seconds: float) -> List[SoakPhase]:
    """The default ramp: warm -> ramp -> peak -> cooldown, with
    the peak phase taking half the budget (where the fault matrix fires)."""
    return [
        SoakPhase("warm", total_seconds * 0.15, peak_tps * 0.3),
        SoakPhase("ramp", total_seconds * 0.2, peak_tps * 0.6),
        SoakPhase("peak", total_seconds * 0.5, peak_tps),
        SoakPhase("cooldown", total_seconds * 0.15, peak_tps * 0.4),
    ]


def default_faults(
    total_seconds: float, kills: bool
) -> List[FaultEvent]:
    """The scripted matrix: a process kill early in the peak phase, a
    one-directional clog mid-peak, a device outage late-peak — each with
    recovery room before the next (the test asserts the ratekeeper
    throttles DURING each window and releases after)."""
    out = []
    if kills:
        out.append(FaultEvent(at=total_seconds * 0.40, kind="kill",
                              target="tlog0",
                              duration=min(2.5, total_seconds * 0.05)))
    out.append(FaultEvent(at=total_seconds * 0.55, kind="clog",
                          duration=min(2.0, total_seconds * 0.06)))
    out.append(FaultEvent(at=total_seconds * 0.75, kind="device_outage",
                          duration=min(2.0, total_seconds * 0.06)))
    return out


def shard_outage_phases(peak_tps: float, total_seconds: float) -> List[SoakPhase]:
    """The shard-outage phase family: steady load before,
    during, and after a one-shard chip loss — the during-phase goodput
    floor is the surviving-shards claim (one sick chip out of S costs
    ~1/S of capacity, NOT the lane)."""
    return [
        SoakPhase("pre_outage", total_seconds * 0.3, peak_tps),
        SoakPhase("shard_outage", total_seconds * 0.4, peak_tps),
        SoakPhase("recovery", total_seconds * 0.3, peak_tps),
    ]


def shard_outage_config(
    minutes: float = 0.5,
    peak_tps: float = 80.0,
    seed: int = 1,
    shard: int = 1,
    n_shards: int = 4,
) -> SoakConfig:
    """A soak whose only fault is a shard_kill covering the whole
    "shard_outage" phase (sim cluster, backend="sharded")."""
    total = minutes * 60.0
    cfg = default_config(
        minutes=minutes, peak_tps=peak_tps, seed=seed,
        cluster="sim", backend="sharded", faults=False,
    )
    cfg.phases = shard_outage_phases(peak_tps, total)
    cfg.faults = [
        FaultEvent(at=total * 0.3, kind="shard_kill",
                   duration=total * 0.4, shard=shard)
    ]
    cfg.sharded_shards = n_shards
    return cfg


def hot_key_rebalance_phases(
    peak_tps: float, total_seconds: float
) -> List[SoakPhase]:
    """The hot-key rebalance phase family: RMW-heavy Zipf
    load pins one shard, a scripted shard_kill degrades it, and the
    balancer's live reshard migrates the hot range onto healthy
    devices — the "recovered" phase is where the per-shard goodput
    claim is scored."""
    hot = dict(read_fraction=0.1, rmw_fraction=0.8)
    return [
        SoakPhase("warm", total_seconds * 0.15, peak_tps * 0.5, **hot),
        SoakPhase("hot_pin", total_seconds * 0.35, peak_tps, **hot),
        SoakPhase("rebalance", total_seconds * 0.3, peak_tps, **hot),
        SoakPhase("recovered", total_seconds * 0.2, peak_tps, **hot),
    ]


def hot_key_rebalance_config(
    minutes: float = 0.5,
    peak_tps: float = 80.0,
    seed: int = 1,
    n_shards: int = 4,
    max_shards: int = 8,
    zipf_theta: float = 1.2,
    balance_seconds: Optional[float] = 1.0,
    outage: bool = True,
) -> SoakConfig:
    """A soak where a Zipf hot-key set is pinned to ONE shard's interior
    (hot_offset lands the hot ranks mid-keyspace, inside shard
    n_shards//4's range... i.e. away from the keyspace floor, which
    shard 0 owns forever), that shard's chip dies for most of the run,
    and the ShardBalancer — fed ratekeeper pressure + the witness
    contention sample — reshards/scales the mesh so the hot range
    migrates onto healthy devices.  balance_seconds=None is the
    "pinned" A/B arm: same seed, same load, same fault, no balancer."""
    total = minutes * 60.0
    cfg = default_config(
        minutes=minutes, peak_tps=peak_tps, seed=seed,
        cluster="sim", backend="sharded", faults=False,
        zipf_theta=zipf_theta,
    )
    cfg.phases = hot_key_rebalance_phases(peak_tps, total)
    cfg.sharded_shards = n_shards
    cfg.sharded_max_shards = max_shards
    cfg.shard_balance_seconds = balance_seconds
    # Hot ranks sit in the interior of shard n_shards//4 + 1's range —
    # a shard whose DEVICE keeps its index across a scale-up, so the
    # scripted outage stays scoped to it while the hot RANGE is free to
    # migrate onto healthy devices.
    cfg.hot_offset = (cfg.keys // n_shards) * (n_shards // 4) + (
        cfg.keys // (2 * n_shards)
    )
    if outage:
        hot_shard = (cfg.hot_offset * n_shards) // cfg.keys
        cfg.faults = [
            FaultEvent(at=total * 0.2, kind="shard_kill",
                       duration=total * 0.7, shard=hot_shard),
        ]
    return cfg


def hot_zipf_weights(keys: int, theta: float, offset: int) -> List[float]:
    """Per-key-index Zipf traffic weight under the hot_offset rotation
    (index i carries rank (i - offset) % keys's mass).  The scorer's
    side of _plan_txn's draw — deterministic, sums to 1."""
    cdf = zipf_cdf(keys, theta)
    mass = [cdf[0]] + [cdf[r] - cdf[r - 1] for r in range(1, keys)]
    return [mass[(i - offset) % keys] for i in range(keys)]


def contention_config(
    minutes: float = 0.25,
    peak_tps: float = 120.0,
    seed: int = 1,
    keys: int = 8,
    zipf_theta: float = 1.2,
    backend: str = "torch",
    witness_retry: Optional[bool] = None,
) -> SoakConfig:
    """High-contention Zipf soak: a tiny hot key set and an
    RMW-heavy mix drive the abort fraction past the contention-spike
    threshold, so the run exercises the whole provenance chain — device
    witnesses, the structured not_committed cause, the client retry
    hint, the contention report block, and the contention_spike flight-
    recorder capture.  No faults: contention IS the incident here."""
    total = minutes * 60.0
    hot = dict(read_fraction=0.0, rmw_fraction=1.0)
    return SoakConfig(
        seed=seed,
        cluster="sim",
        backend=backend,
        mode="open",
        keys=keys,
        zipf_theta=zipf_theta,
        phases=[
            SoakPhase("warm", total * 0.2, peak_tps * 0.5, **hot),
            SoakPhase("hot", total * 0.6, peak_tps, **hot),
            SoakPhase("cooldown", total * 0.2, peak_tps * 0.4, **hot),
        ],
        faults=[],
        # Contention arms score RELATIVE goodput (guided vs blind); a
        # same-key RMW storm legitimately aborts most attempts, so the
        # absolute floor only guards against total collapse.
        goodput_floor_frac=0.02,
        witness_retry=witness_retry,
    )


def default_config(
    minutes: float = 2.0,
    peak_tps: float = 120.0,
    seed: int = 1,
    cluster: str = "sim",
    backend: str = "torch",
    mode: str = "open",
    keys: int = 512,
    zipf_theta: float = 0.9,
    faults: bool = True,
) -> SoakConfig:
    total = minutes * 60.0
    return SoakConfig(
        seed=seed,
        cluster=cluster,
        backend=backend,
        mode=mode,
        keys=keys,
        zipf_theta=zipf_theta,
        phases=default_phases(peak_tps, total),
        faults=default_faults(total, kills=(cluster == "dynamic"))
        if faults
        else [],
        # Dynamic clusters mix system-keyspace metadata into the same
        # resolver: widen the device key budget so those batches stay
        # device-eligible (see SoakConfig.device_key_words).
        device_key_words=16 if cluster == "dynamic" else None,
        device_key_bytes=64 if cluster == "dynamic" else None,
    )


def zipf_cdf(n: int, theta: float) -> List[float]:
    """Cumulative Zipf(theta) weights over ranks 1..n (theta=0 uniform).
    O(n) once per soak; sampling is a binary search per draw."""
    total = 0.0
    cdf = []
    for k in range(1, n + 1):
        total += k ** (-theta) if theta > 0 else 1.0
        cdf.append(total)
    return [c / total for c in cdf]


def zipf_pick(rng, cdf: List[float]) -> int:
    """Rank index in [0, len(cdf)) — low indexes are the hot keys."""
    return bisect.bisect_left(cdf, rng.random01())


class _PhaseStats:
    """Mutable per-phase tallies (attributed to the phase a transaction
    STARTED in, so cross-boundary completions aren't double-counted)."""

    FIELDS = ("arrivals", "client_shed", "attempts", "committed",
              "conflicted", "too_old", "throttled", "other_errors",
              "failed", "exhausted")

    def __init__(self, name: str):
        self.name = name
        self.counts = {f: 0 for f in self.FIELDS}
        self.latencies: List[float] = []  # client-observed commit seconds
        self.t_start = 0.0
        self.t_end = 0.0
        self.ev_start = 0  # trace-collector event cursor at phase start
        self.ev_end = 0


class SoakRun:
    """One soak execution against a prepared cluster.  Use run_soak()
    unless you are composing the harness into a larger test."""

    def __init__(self, config: SoakConfig, cluster, dbs):
        self.config = config
        self.cluster = cluster
        self.dbs = list(dbs)
        self.db = self.dbs[0]  # driver actors run on the first client
        self._next_client = 0
        self.loop = cluster.loop
        # The soak's own random stream: forked from the loop rng so fault
        # scheduling never perturbs role-level sim decisions mid-run.
        self.rng = self.loop.rng.split()
        self.cdf = zipf_cdf(config.keys, config.zipf_theta)
        self.stats = [_PhaseStats(p.name) for p in config.phases]
        self.in_flight = 0
        self.fault_timeline: List[list] = []  # [t, kind, detail, t_end]
        # Sampled admission log: [t, limiting, tps] whenever the CURRENT
        # ratekeeper's binding signal changes — generation-proof (a
        # DynamicCluster recruits a fresh Ratekeeper per recovery, whose
        # own transitions log resets; this one spans the whole soak).
        self.admission_log: List[list] = []
        # Per-phase conflict-witness snapshots:
        # phase name -> {resolver: {aborts, topk}} captured at phase
        # end, so the report shows WHERE contention lived per phase
        # (the Zipf hot-key phases are the interesting rows).
        self.phase_witness: dict = {}
        # Per-phase shard-mesh cuts: phase name -> partition +
        # breaker states + per-shard shed counters at phase end — the
        # hot_key_rebalance A/B scorer's input.
        self.phase_shards: dict = {}
        self.balancer = None  # ShardBalancer when _balance_driver runs
        self._stop = False

    # -- cluster accessors ------------------------------------------------
    def current_ratekeeper(self):
        cluster = self.cluster
        if hasattr(cluster, "controllers"):
            try:
                return getattr(
                    cluster.acting_controller(), "ratekeeper", None
                )
            except RuntimeError:
                return None
        return getattr(cluster, "_soak_ratekeeper", None)

    def _resolver_conflict_sets(self):
        from ..server.status import role_objects

        out = []
        for r in role_objects(self.cluster, "resolver"):
            cs = getattr(r, "conflicts", None)
            if cs is not None and getattr(cs, "_dev", None) is not None:
                out.append((r, cs))
        return out

    def _witness_snapshot(self) -> dict:
        """resolver -> conflict_witness() at this instant (cumulative
        counters; per-phase deltas are derivable from successive phase
        rows).  Deterministic: counts + canonical-JSON top-K only."""
        from ..server.status import role_objects

        out = {}
        for r in role_objects(self.cluster, "resolver"):
            cw = getattr(r, "conflict_witness", None)
            if callable(cw):
                out[r.process.name] = cw()
        return out

    # -- transaction plans ------------------------------------------------
    def _key(self, idx: int) -> bytes:
        return b"soak/%06d" % idx

    def _plan_txn(self, rng, phase: SoakPhase):
        """Decide shape + keys AT ARRIVAL (one deterministic draw order,
        independent of task interleaving)."""
        r = rng.random01()
        if r < phase.read_fraction:
            kind = "read"
        elif r < phase.read_fraction + phase.rmw_fraction:
            kind = "rmw"
        else:
            kind = "write"
        nkeys = 1 + int(rng.random_int(0, 3))
        off, nk = self.config.hot_offset, self.config.keys
        keys = sorted(
            {(zipf_pick(rng, self.cdf) + off) % nk for _ in range(nkeys)}
        )
        return kind, keys, int(rng.random_int(0, 1 << 30))

    async def _apply(self, tr, plan):
        kind, keys, salt = plan
        pad = max(1, self.config.value_bytes)
        if kind == "read":
            for ki in keys:
                await tr.get(self._key(ki))
        elif kind == "rmw":
            for ki in keys:
                v = await tr.get(self._key(ki))
                n = int(v.split(b":")[0]) if v else 0
                tr.set(
                    self._key(ki),
                    b"%d:%s" % (n + 1, b"x" * (pad - 1)),
                )
        else:
            for ki in keys:
                tr.set(self._key(ki), b"%d:%s" % (salt, b"w" * (pad - 1)))

    def _classify(self, st: _PhaseStats, e: FdbError):
        c = st.counts
        if e.name == "not_committed":
            c["conflicted"] += 1
        elif e.name == "transaction_too_old":
            c["too_old"] += 1
        elif e.name in (
            "batch_transaction_throttled",
            "proxy_memory_limit_exceeded",
        ):
            c["throttled"] += 1
        else:
            c["other_errors"] += 1

    async def _run_txn(self, db, plan, pi: int):
        st = self.stats[pi]
        loop = self.loop
        t0 = loop.now()
        tr = db.create_transaction()
        try:
            for _attempt in range(self.config.max_attempts):
                st.counts["attempts"] += 1
                try:
                    await self._apply(tr, plan)
                    await tr.commit()
                    st.counts["committed"] += 1
                    st.latencies.append(loop.now() - t0)
                    return
                except FdbError as e:
                    self._classify(st, e)
                    try:
                        # Exponential backoff + DeterministicRandom jitter
                        # (Transaction.on_error) — exactly how throttled
                        # clients are supposed to retreat.
                        await tr.on_error(e)
                    except FdbError:
                        st.counts["failed"] += 1
                        return
            st.counts["exhausted"] += 1
        finally:
            self.in_flight -= 1

    # -- drivers ----------------------------------------------------------
    async def _load_driver(self):
        from ..flow.eventloop import all_of
        from ..flow.trace import global_collector

        loop = self.loop
        col = global_collector()
        for pi, phase in enumerate(self.config.phases):
            st = self.stats[pi]
            st.t_start = loop.now()
            st.ev_start = len(col.events)
            end = loop.now() + phase.duration
            if self.config.mode == "open":
                rate = max(phase.arrival_tps, 1e-6)
                while loop.now() < end:
                    await loop.delay(1.0 / rate)
                    st.counts["arrivals"] += 1
                    if self.in_flight >= self.config.max_in_flight:
                        # Client-side cap: an overloaded open loop bounds
                        # its own memory; the drop is COUNTED, never
                        # silent (no-silent-caps discipline).
                        st.counts["client_shed"] += 1
                        continue
                    plan = self._plan_txn(self.rng, phase)
                    db = self.dbs[self._next_client]
                    self._next_client = (
                        self._next_client + 1
                    ) % len(self.dbs)
                    self.in_flight += 1
                    db.process.spawn(
                        self._run_txn(db, plan, pi), "soak_txn"
                    )
            else:
                tasks = [
                    self.db.process.spawn(
                        self._closed_actor(
                            self.dbs[ai % len(self.dbs)], pi, phase, end
                        ),
                        f"soak_actor{ai}",
                    )
                    for ai in range(phase.actors)
                ]
                await all_of(tasks)
            st.t_end = loop.now()
            st.ev_end = len(col.events)
            self.phase_witness[st.name] = self._witness_snapshot()
            self.phase_shards[st.name] = self._shard_snapshot()
        # Drain stragglers (bounded): goodput counts completions, and a
        # hung tail must fail the SLO rather than hang the harness.
        deadline = loop.now() + self.config.drain_timeout
        while self.in_flight > 0 and loop.now() < deadline:
            await loop.delay(0.05)
        self._stop = True

    async def _closed_actor(self, db, pi: int, phase: SoakPhase, end: float):
        loop = self.loop
        rng = self.rng.split()
        while loop.now() < end:
            st = self.stats[pi]
            st.counts["arrivals"] += 1
            plan = self._plan_txn(rng, phase)
            self.in_flight += 1
            await self._run_txn(db, plan, pi)

    async def _fault_driver(self):
        loop = self.loop
        t0 = loop.now()
        for ev in sorted(self.config.faults, key=lambda e: (e.at, e.kind)):
            dt = t0 + ev.at - loop.now()
            if dt > 0:
                await loop.delay(dt)
            if ev.kind == "kill":
                await self._fault_kill(ev)
            elif ev.kind == "clog":
                await self._fault_clog(ev)
            elif ev.kind == "device_outage":
                await self._fault_device_outage(ev)
            elif ev.kind == "shard_kill":
                await self._fault_shard_kill(ev)
            elif ev.kind == "shard_move":
                await self._fault_shard_move(ev)
            else:
                raise ValueError(f"unknown fault kind {ev.kind!r}")

    async def _capture_fault_window(self, delay: float, kind: str, detail):
        """Automatic per-fault-window flight-recorder capture:
        freeze the telemetry window once the fault's hold has elapsed, so
        the artifact contains the whole degraded window plus whatever
        trigger captures (breaker open, ratekeeper throttle) fired inside
        it.  Explicit capture — bypasses the trigger cooldown by design."""
        from ..flow.flight_recorder import global_flight_recorder

        if delay > 0:
            await self.loop.delay(delay)
        global_flight_recorder().capture(
            f"fault_window:{kind}", detail=detail, now=self.loop.now()
        )

    async def _fault_kill(self, ev: FaultEvent):
        """Process kill with the machine HELD DOWN for ev.duration, then
        revive: a sustained role outage, not a blink.  The CC's recovery
        must wait for the stateful machine (it cannot recruit an empty
        replacement without losing acked data), so the commit pipeline
        stalls for the window and the OLD generation's ratekeeper — whose
        role probes now all fail — floors admission (`recovering`) until
        the recovered generation's fresh ratekeeper takes over
        (DynamicCluster only)."""
        from .chaos import revive_worker

        cluster = self.cluster
        if not hasattr(cluster, "controllers"):
            raise ValueError("kill faults need cluster='dynamic'")
        role = ev.target or "tlog0"
        t = self.loop.now()
        try:
            proc = cluster.kill_role_process(role)
        except (KeyError, RuntimeError):
            self.fault_timeline.append([t, "kill", f"{role}:unrecruited", t])
            return
        cluster.fs.crash_machine(proc.machine.machine_id)
        if ev.duration > 0:
            await self.loop.delay(ev.duration)
        revive_worker(cluster, proc)
        self.fault_timeline.append([t, "kill", role, self.loop.now()])
        await self._capture_fault_window(0.0, "kill", {"target": role})

    def _clog_endpoints(self):
        """(src, dst) machine ids for the one-directional clog: tlog ->
        storage, so log-stream pulls stall, the storage falls behind, and
        the ss_lag spring visibly binds."""
        from ..server.status import role_objects

        tlogs = role_objects(self.cluster, "tlog")
        storages = role_objects(self.cluster, "storage")
        if tlogs and storages:
            return (
                tlogs[0].process.machine.machine_id,
                storages[0].process.machine.machine_id,
            )
        machines = sorted(self.cluster.net.machines)
        return machines[0], machines[-1]

    async def _fault_clog(self, ev: FaultEvent):
        src, dst = self._clog_endpoints()
        t = self.loop.now()
        self.cluster.net.clog_pair(src, dst, ev.duration)
        self.fault_timeline.append(
            [t, "clog", f"{src}->{dst}", t + ev.duration]
        )
        # The clog holds asynchronously; capture once its window closes
        # (without stalling the fault driver's schedule).
        self.db.process.spawn_observed(
            self._capture_fault_window(
                ev.duration, "clog", {"pair": f"{src}->{dst}"}
            ),
            "soak_fault_capture",
        )

    async def _fault_device_outage(self, ev: FaultEvent):
        """Persistent dispatch outage on ONE resolver's device engine: the
        PR-3 breaker opens, verdicts fall back to the CPU mirror, the
        ratekeeper contracts (backend_degraded), then the outage lifts and
        the half-open probe recovers."""
        from ..conflict.device_faults import DeviceFaultInjector

        sets = self._resolver_conflict_sets()
        t = self.loop.now()
        if not sets:
            self.fault_timeline.append([t, "device_outage", "no-device", t])
            return
        r, cs = sets[0]
        inj = cs._dev.fault_injector
        if inj is None:
            inj = DeviceFaultInjector(rng=self.rng.split())
            cs.install_fault_injector(inj)
        inj.begin_outage("dispatch")
        await self.loop.delay(ev.duration)
        inj.end_outage("dispatch")
        self.fault_timeline.append(
            [t, "device_outage", r.process.name, self.loop.now()]
        )
        await self._capture_fault_window(
            0.0, "device_outage", {"resolver": r.process.name}
        )

    def _sharded_sets(self):
        """(resolver, mesh-sharded conflict set) pairs — resolvers whose
        raw conflict set has per-shard fault domains."""
        from ..server.status import role_objects

        out = []
        for r in role_objects(self.cluster, "resolver"):
            cs = getattr(r, "conflicts", None)
            if cs is not None and getattr(cs, "n_shards", 0) > 1:
                out.append((r, cs))
        return out

    async def _fault_shard_kill(self, ev: FaultEvent):
        """Chip loss scoped to ONE shard of a mesh-sharded resolver:
        a persistent dispatch outage on shard ev.shard only —
        its breaker opens and its slice serves degraded off its mirror,
        the other shards keep serving on device, and when the outage
        lifts the half-open probe rehydrates only that shard."""
        from ..conflict.device_faults import DeviceFaultInjector

        sets = self._sharded_sets()
        t = self.loop.now()
        if not sets:
            self.fault_timeline.append([t, "shard_kill", "no-shards", t])
            return
        r, cs = sets[0]
        shard = ev.shard % cs.n_shards
        inj = cs.fault_injector
        if inj is None:
            inj = DeviceFaultInjector(rng=self.rng.split())
            cs.install_fault_injector(inj)
        inj.begin_outage("dispatch", shard=shard)
        await self.loop.delay(ev.duration)
        inj.end_outage("dispatch", shard=shard)
        detail = f"{r.process.name}:shard{shard}"
        self.fault_timeline.append([t, "shard_kill", detail, self.loop.now()])
        await self._capture_fault_window(
            0.0, "shard_kill",
            {"resolver": r.process.name, "shard": shard},
        )

    async def _fault_shard_move(self, ev: FaultEvent):
        """Scripted live reshard: recompute split points from
        the occupancy quantiles and migrate them mid-stream — the direct
        (balancer-less) way to land a reshard inside another fault's
        window, exercising the during-fault legality rules (an open
        breaker on a moved shard completes degraded-on-mirror; a
        scripted reshard-site fault defers the whole move)."""
        sets = self._sharded_sets()
        t = self.loop.now()
        if not sets:
            self.fault_timeline.append([t, "shard_move", "no-shards", t])
            return
        r, cs = sets[0]
        n_target = ev.shard if ev.shard > 1 else cs.n_shards
        n_target = min(n_target, cs.max_shards)
        try:
            entry = cs.reshard(
                cs.balance_split_keys(n_target), reason="fault_shard_move"
            )
            detail = f"{r.process.name}:{entry['action']}"
        except ValueError as e:
            detail = f"{r.process.name}:rejected:{e}"
        self.fault_timeline.append([t, "shard_move", detail, self.loop.now()])
        await self._capture_fault_window(
            0.0, "shard_move", {"resolver": r.process.name, "detail": detail}
        )

    async def _balance_driver(self):
        """Tick a ShardBalancer over the mesh-sharded conflict set.
        Pressure is the ratekeeper's binding signal — 1.0
        whenever admission is limited (the scale-up
        driver), else the client-side in-flight fraction; per-shard load
        is the resolver's decayed witness-range sample.  Every input is
        virtual-time deterministic, so two same-seed soaks produce
        byte-identical decision logs."""
        period = self.config.shard_balance_seconds
        if not period:
            return
        sets = self._sharded_sets()
        if not sets:
            return
        from ..server.resolver_balancer import ShardBalancer

        r, cs = sets[0]
        load_fn = getattr(r, "_shard_load_sample", None)
        self.balancer = ShardBalancer(
            cs, ratio=2.0, hysteresis=2, cooldown=2,
            min_boundaries=16, load_fn=load_fn,
        )
        while not self._stop:
            await self.loop.delay(period)
            rk = self.current_ratekeeper()
            limiting = getattr(
                getattr(rk, "rate", None), "limiting", "none"
            ) if rk else "none"
            if limiting not in (None, "", "none"):
                pressure = 1.0
            else:
                pressure = min(
                    1.0, self.in_flight / max(1, self.config.max_in_flight)
                )
            self.balancer.evaluate(pressure=pressure)

    def _shard_snapshot(self) -> dict:
        """Per-phase shard-mesh cut: partition + breaker
        states + per-shard degraded-serve (shed) counters, enough for
        the A/B scorer to attribute each phase's hot-range traffic to
        device-serving vs mirror-degraded shards."""
        out = {}
        for r, cs in self._sharded_sets():
            out[r.process.name] = {
                "shards": cs.n_shards,
                "split_keys": [k.hex() for k in cs.split_keys],
                "occupancy": cs.shard_occupancy(),
                "states": [
                    b.state for b in cs._breakers[: cs.n_shards]
                ],
                "degraded_batches": [
                    int(
                        cs.metrics.counter(
                            f"shard{s}_degraded_batches"
                        ).value
                    )
                    for s in range(cs.n_shards)
                ],
                "moves": len(cs.move_log),
            }
        return out

    async def _admission_monitor(self):
        """Sample the CURRENT ratekeeper's binding signal; log changes.
        Spans generations (see admission_log comment)."""
        loop = self.loop
        last = None
        while not self._stop:
            await loop.delay(self.config.rk_sample_interval)
            rk = self.current_ratekeeper()
            if rk is None:
                continue
            limiting = rk.rate.limiting
            if limiting != last:
                self.admission_log.append(
                    [round(loop.now(), 4), limiting, round(rk.rate.tps, 3)]
                )
                last = limiting

    async def main(self):
        from ..flow.eventloop import all_of

        mon = self.db.process.spawn(self._admission_monitor(), "soak_rkmon")
        faults = self.db.process.spawn(self._fault_driver(), "soak_faults")
        bal = self.db.process.spawn(self._balance_driver(), "soak_balance")
        await self._load_driver()
        await all_of([faults])
        await all_of([mon, bal])
        return self.report()

    # -- reporting --------------------------------------------------------
    def _contention_section(self, rec) -> dict:
        """The report's contention explorer block."""
        from ..server.status import role_objects

        resolvers = {}
        for r in role_objects(self.cluster, "resolver"):
            cw = getattr(r, "conflict_witness", None)
            if callable(cw):
                w = cw()
                resolvers[r.process.name] = {
                    "aborts": w["aborts"],
                    "topk": w["topk"],
                    **w["contention"],
                }
        return {
            "witness_retry": all(db.witness_retry for db in self.dbs),
            "hint_retries": sum(
                getattr(db, "witness_hint_retries", 0) for db in self.dbs
            ),
            "spike_captures": sum(
                1 for c in rec.captures if c["trigger"] == "contention_spike"
            ),
            "resolvers": resolvers,
        }

    def _resharding_section(self) -> dict:
        """The report's elastic-resharding block: the final
        partition + move log per mesh-sharded resolver, the balancer's
        full decision log, and the per-phase shard cuts.  Deterministic
        (counts, hex keys, virtual-time stamps only), so the
        byte-identical replay gate extends over it."""
        resolvers = {}
        for r, cs in self._sharded_sets():
            resolvers[r.process.name] = {
                "shards": cs.n_shards,
                "max_shards": cs.max_shards,
                "split_keys": [k.hex() for k in cs.split_keys],
                "occupancy": cs.shard_occupancy(),
                "move_log": [dict(e) for e in cs.move_log],
                "reshards": int(cs.metrics.counter("reshards").value),
                "deferred": int(
                    cs.metrics.counter("reshard_deferred").value
                ),
                "degraded": int(
                    cs.metrics.counter("reshard_degraded").value
                ),
            }
        bal = self.balancer
        return {
            "resolvers": resolvers,
            "balancer": None if bal is None else {
                "moves": bal.moves,
                "decisions": [dict(d) for d in bal.decisions],
            },
            "phase_shards": self.phase_shards,
        }

    def _spans_section(self) -> dict:
        from ..flow.spans import global_span_hub, span_latency_summary
        from ..server.status import role_objects

        hub = global_span_hub()
        overlap = 0.0
        host_fraction = 0.0
        for r in role_objects(self.cluster, "resolver"):
            m = getattr(r, "metrics", None)
            if m is not None and "pipeline_overlap_efficiency" in m.gauges:
                overlap = max(
                    overlap, m.gauges["pipeline_overlap_efficiency"].value
                )
            if m is not None and "host_fraction" in m.gauges:
                host_fraction = max(
                    host_fraction, m.gauges["host_fraction"].value
                )
        return {
            "status": hub.status_section(),
            "stage_latency": span_latency_summary(hub),
            "pipeline_overlap_efficiency": overlap,
            "host_fraction": host_fraction,
            "window": hub.window_dict(last_n=8),
        }

    def _phase_chain_p99(self, st: _PhaseStats, chain, type_):
        from ..flow.trace import global_collector

        events = global_collector().events[st.ev_start:st.ev_end]
        summary = summarize_stages(events, type_, chain)
        return summary.get("total", {}).get("p99")

    def report(self) -> dict:
        cfg = self.config
        phases = []
        worst_p99 = 0.0
        slo_ok = True
        for st, phase in zip(self.stats, cfg.phases):
            dur = max(st.t_end - st.t_start, 1e-9)
            goodput = st.counts["committed"] / dur
            chain_p99 = self._phase_chain_p99(st, COMMIT_CHAIN, "CommitDebug")
            grv_p99 = self._phase_chain_p99(st, GRV_CHAIN, "TransactionDebug")
            client_p99 = percentile(st.latencies, 0.99)
            floor = (
                phase.arrival_tps * cfg.goodput_floor_frac
                if cfg.mode == "open"
                else cfg.goodput_floor_tps
            )
            ok = goodput >= floor and (
                chain_p99 is None or chain_p99 <= cfg.slo_commit_p99
            )
            if not ok:
                # SLO breach trigger: the fourth transition-log
                # owner — a phase missing its goodput floor or p99 bound
                # freezes the window, admission log attached.
                from ..flow.flight_recorder import maybe_trigger

                maybe_trigger(
                    "slo_breach",
                    detail={"phase": st.name,
                            "goodput_tps": round(goodput, 3),
                            "goodput_floor_tps": round(floor, 3),
                            "commit_p99_chain": chain_p99,
                            "commit_p99_bound": cfg.slo_commit_p99},
                    # Thunk: copied only if the cooldown admits it.
                    transitions=lambda: [
                        list(e) for e in self.admission_log
                    ],
                    # report() evaluates every phase at ONE virtual
                    # instant; a per-phase source keeps a second
                    # breaching phase from being cooldown-swallowed by
                    # the first.
                    source=st.name,
                )
            slo_ok = slo_ok and ok
            if chain_p99 is not None:
                worst_p99 = max(worst_p99, chain_p99)
            phases.append(
                {
                    "name": st.name,
                    "duration": round(dur, 4),
                    **st.counts,
                    "goodput_tps": round(goodput, 3),
                    "goodput_floor_tps": round(floor, 3),
                    "commit_p99_chain": chain_p99,
                    "grv_p99_chain": grv_p99,
                    "commit_p99_client": client_p99,
                    "slo_ok": ok,
                    # Where contention lived this phase:
                    # aborted-txn totals + top-K contended ranges per
                    # resolver, snapshotted at phase end.
                    "conflict_witness": self.phase_witness.get(
                        st.name, {}
                    ),
                }
            )
        totals = {
            f: sum(st.counts[f] for st in self.stats)
            for f in _PhaseStats.FIELDS
        }
        wall_span = (
            self.stats[-1].t_end - self.stats[0].t_start
            if self.stats
            else 0.0
        )
        # Proxy-side shed counters (the enforcement half of throttling).
        from ..server.status import role_objects

        shed = {"grv_shed_batch": 0, "grv_shed_default": 0}
        for p in role_objects(self.cluster, "proxy"):
            stats = getattr(p, "stats", None)
            if stats is None:
                continue
            snap = stats.snapshot()
            for k in shed:
                shed[k] += snap.get(k, 0)
        rk = self.current_ratekeeper()
        from ..flow.flight_recorder import global_flight_recorder

        _rec = global_flight_recorder()
        breakers = {}
        pipeline = {}
        shards = {}
        # Shard-granular fault domains: per-shard breaker
        # transition logs (the replay gate covers them — byte-identical
        # across same-seed runs) plus the shard state summary.
        for r, cs in self._sharded_sets():
            for s in range(cs.n_shards):
                breakers[f"{r.process.name}.shard{s}"] = [
                    list(tr) for tr in cs._breakers[s].transitions
                ]
            shards[r.process.name] = {
                "total": cs.n_shards,
                "states": [b.state for b in cs._breakers],
                "degraded_shard_serves": int(
                    cs.metrics.counter("degraded_shard_serves").value
                ),
            }
        for r, cs in self._resolver_conflict_sets():
            if cs._breaker is not None:
                breakers[r.process.name] = [
                    list(tr) for tr in cs._breaker.transitions
                ]
            # Pipeline engagement per resolver: the soak's
            # goodput floors are now held WITH the double-buffered path
            # on by default — record the facts that prove it ran and how
            # it completed (bound-pushed vs idle-flushed).
            if getattr(r, "_pipeline_on", False) and cs._dev is not None:
                rsnap = r.metrics.snapshot()
                pipeline[r.process.name] = {
                    "depth": cs.pipeline_depth,
                    "dispatches": int(
                        cs._dev.metrics.counter("pipeline_dispatches").value
                    ),
                    "replayed_batches": int(
                        cs._dev.metrics.counter(
                            "pipeline_replayed_batches"
                        ).value
                    ),
                    "device_stalls": rsnap["counters"][
                        "pipeline_device_stalls"
                    ],
                    "host_stalls": rsnap["counters"]["pipeline_host_stalls"],
                }
        return {
            "config": {
                "seed": cfg.seed,
                "cluster": cfg.cluster,
                "backend": cfg.backend,
                "mode": cfg.mode,
                "keys": cfg.keys,
                "zipf_theta": cfg.zipf_theta,
                "phases": [
                    {"name": p.name, "duration": p.duration,
                     "arrival_tps": p.arrival_tps}
                    for p in cfg.phases
                ],
                "faults": [
                    {"at": f.at, "kind": f.kind, "duration": f.duration,
                     "target": f.target, "shard": f.shard}
                    for f in cfg.faults
                ],
            },
            "phases": phases,
            "totals": {
                **totals,
                "sim_seconds": round(wall_span, 4),
                "goodput_tps": round(
                    totals["committed"] / max(wall_span, 1e-9), 3
                ),
            },
            "throttle_shed": {
                **shed,
                "client_throttled": totals["throttled"],
            },
            "faults": [list(f) for f in self.fault_timeline],
            "ratekeeper": {
                "admission_log": [list(e) for e in self.admission_log],
                "transitions": (
                    [list(t) for t in rk.transitions] if rk else []
                ),
            },
            "breakers": breakers,
            "shards": shards,
            "pipeline": pipeline,
            # Contention explorer: per-resolver abort
            # timelines + spike state, the client-side witness-hint
            # retry count, and the contention_spike captures this run
            # froze.  Deterministic like everything above — the replay
            # gate extends over this block.
            "contention": self._contention_section(_rec),
            # Elastic resharding: final partition, move logs,
            # the balancer decision log, and per-phase shard cuts — the
            # hot_key_rebalance scorer and the replay gate read these.
            "resharding": self._resharding_section(),
            # Span layer: per-role ring inventory, the recent
            # window, per-stage latency percentiles off the spans, and
            # the worst pipeline overlap-efficiency gauge.  All
            # deterministic (wall fields excluded by construction), so
            # the byte-identical replay gate extends over this section.
            "spans": self._spans_section(),
            "slo": {
                "commit_p99_bound": cfg.slo_commit_p99,
                "worst_phase_commit_p99": worst_p99 or None,
                "ok": slo_ok,
            },
            # The run's flight-recorder captures: fault-window
            # artifacts + whatever triggers fired (breaker opens,
            # ratekeeper throttles, SLO breaches).  run_soak installed a
            # fresh recorder, so these are THIS run's only — and, like
            # everything above, byte-identical across same-seed runs.
            "flight_recorder": {
                "status": _rec.status_section(),
                "captures": [dict(c) for c in _rec.captures],
            },
        }


def transition_logs_json(report: dict) -> str:
    """Canonical byte form of the replay-gated logs: the admission log,
    the (current-generation) ratekeeper transitions, every breaker
    transition log, and the balancer decision + reshard move
    logs.  Same seed => byte-identical."""
    resharding = report.get("resharding", {})
    bal = resharding.get("balancer")
    return json.dumps(
        {
            "admission": report["ratekeeper"]["admission_log"],
            "ratekeeper": report["ratekeeper"]["transitions"],
            "breakers": report["breakers"],
            "faults": report["faults"],
            "balancer": [] if bal is None else bal["decisions"],
            "moves": {
                name: blk["move_log"]
                for name, blk in sorted(
                    resharding.get("resolvers", {}).items()
                )
            },
        },
        sort_keys=True,
        separators=(",", ":"),
    )


def run_soak(config: SoakConfig) -> dict:
    """Build a rated cluster per `config`, run the soak, return the
    report.  Owns the loop and the observability globals: installs a fresh
    in-memory trace collector (latency chains + determinism isolation),
    time-series hub, flight recorder and span hub for the run and restores
    the previous ones (and the current event loop) after it."""
    from ..flow import flight_recorder, spans, timeseries, trace
    from ..flow.eventloop import set_event_loop

    saved = (trace.global_collector(), trace._global_clock,
             timeseries.global_timeseries(),
             flight_recorder.global_flight_recorder(),
             spans.global_span_hub())
    trace.set_global_collector(trace.TraceCollector())
    # Fresh time-series hub + flight recorder: the soak's
    # samplers and triggers must write into rings THIS run owns — both
    # for the byte-identical replay gate and so the report's captures
    # aren't polluted by an earlier run in the same process.
    timeseries.set_global_timeseries(timeseries.TimeSeriesHub())
    flight_recorder.set_global_flight_recorder(flight_recorder.FlightRecorder())
    # Fresh span hub: the report's spans section and the
    # captures' span windows must belong to THIS run only.
    spans.set_global_span_hub(spans.SpanHub())
    try:
        cluster, dbs = _build_cluster(config)
        run = SoakRun(config, cluster, dbs)
        db = dbs[0]
        total = sum(p.duration for p in config.phases)
        task = db.process.spawn(run.main(), "soak_main")
        report = cluster.run_until(
            task, timeout_vt=total * 20 + config.drain_timeout + 600.0
        )
        return report
    finally:
        trace.set_global_collector(saved[0], clock=saved[1])
        timeseries.set_global_timeseries(saved[2])
        flight_recorder.set_global_flight_recorder(saved[3])
        spans.set_global_span_hub(saved[4])
        set_event_loop(None)


def run_contention_ab(
    minutes: float = 0.25,
    peak_tps: float = 120.0,
    seed: int = 1,
    keys: int = 8,
    zipf_theta: float = 1.2,
    backend: str = "torch",
    device=None,
) -> dict:
    """Witness-guided vs blind retry A/B on the high-contention Zipf arm
    (the contention arm's acceptance comparison).  Same seed, same load plan, same
    fault-free cluster build — the ONLY difference is the clients'
    witness_retry setting, so any goodput gap is the retry hint's.  Both
    arms' conflict sets run on `device` (SoakConfig.device).
    Scored on goodput (committed txn/s), retry counts, and commit p99;
    full per-arm reports ride along for the explorer."""
    arms = {}
    for arm, flag in (("guided", True), ("blind", False)):
        cfg = contention_config(
            minutes=minutes, peak_tps=peak_tps, seed=seed, keys=keys,
            zipf_theta=zipf_theta, backend=backend, witness_retry=flag,
        )
        cfg.device = device
        arms[arm] = run_soak(cfg)

    def score(rep: dict) -> dict:
        t = rep["totals"]
        started = t["arrivals"] - t["client_shed"]
        return {
            "goodput_tps": t["goodput_tps"],
            "committed": t["committed"],
            "conflicted": t["conflicted"],
            "attempts": t["attempts"],
            "retries": t["attempts"] - started,
            "hint_retries": rep["contention"]["hint_retries"],
            "commit_p99": rep["slo"]["worst_phase_commit_p99"],
        }

    g, b = score(arms["guided"]), score(arms["blind"])
    return {
        "guided": g,
        "blind": b,
        "goodput_ratio": round(
            g["goodput_tps"] / max(b["goodput_tps"], 1e-9), 4
        ),
        "reports": arms,
    }


def _hot_device_goodput(report: dict, cfg: SoakConfig) -> dict:
    """Per-phase hot-range DEVICE goodput: the phase's committed tps
    weighted by the Zipf traffic mass whose owning shard (under that
    phase's partition cut) was serving on device, not degraded on its
    mirror.  Virtual time charges mirror serves nothing, so the
    traffic-weighted device fraction is the honest per-shard goodput
    measure the virtual-mesh A/B compares: a pinned hot range on a sick
    chip scores ~0, the same range rebalanced onto healthy chips scores
    its full committed rate."""
    weights = hot_zipf_weights(cfg.keys, cfg.zipf_theta, cfg.hot_offset)
    out = {}
    shards_by_phase = report["resharding"]["phase_shards"]
    for ph in report["phases"]:
        snap = shards_by_phase.get(ph["name"], {})
        if not snap:
            out[ph["name"]] = None
            continue
        blk = next(iter(snap.values()))
        splits = [bytes.fromhex(h) for h in blk["split_keys"]]
        states = blk["states"]
        frac = 0.0
        for i, w in enumerate(weights):
            s = bisect.bisect_right(splits, b"soak/%06d" % i)
            if states[s] == "ok":
                frac += w
        out[ph["name"]] = {
            "goodput_tps": ph["goodput_tps"],
            "device_fraction": round(frac, 4),
            "hot_device_goodput_tps": round(ph["goodput_tps"] * frac, 3),
            "degraded_batches": blk["degraded_batches"],
            "moves": blk["moves"],
        }
    return out


def run_hot_key_rebalance_ab(
    minutes: float = 0.5,
    peak_tps: float = 80.0,
    seed: int = 1,
    n_shards: int = 4,
    max_shards: int = 8,
    zipf_theta: float = 1.2,
    balance_seconds: float = 1.0,
    device=None,
) -> dict:
    """Balancer-on vs balancer-off A/B on the hot-key-pinned soak
    (the rebalance arm's acceptance comparison).  Same seed, same Zipf load
    pinned to one shard's interior, same scripted chip loss on that
    shard — the ONLY difference is the ShardBalancer driver, so any
    hot-range device-goodput gap is the live reshard's.  The pinned
    arm's outage-window minimum is the pre-rebalance floor; recovery is
    the balanced arm's final ("recovered") phase.  Both arms' sharded
    sets run on `device` (SoakConfig.device)."""
    arms, cfgs = {}, {}
    for arm, bal in (("balanced", balance_seconds), ("pinned", None)):
        cfg = hot_key_rebalance_config(
            minutes=minutes, peak_tps=peak_tps, seed=seed,
            n_shards=n_shards, max_shards=max_shards,
            zipf_theta=zipf_theta, balance_seconds=bal,
        )
        cfg.device = device
        cfgs[arm] = cfg
        arms[arm] = run_soak(cfg)
    scores = {a: _hot_device_goodput(arms[a], cfgs[a]) for a in arms}
    floor = min(
        (
            s["hot_device_goodput_tps"]
            for name, s in scores["pinned"].items()
            if s is not None and name != "warm"
        ),
        default=0.0,
    )
    recovered = scores["balanced"].get("recovered") or {}
    rec = recovered.get("hot_device_goodput_tps", 0.0)
    bal_block = arms["balanced"]["resharding"]["balancer"] or {}
    return {
        "phases": scores,
        "pre_rebalance_floor_tps": round(floor, 3),
        "recovered_hot_goodput_tps": rec,
        "recovery_ratio": round(rec / max(floor, 1e-9), 3),
        "balancer_moves": bal_block.get("moves", 0),
        "slo_ok": arms["balanced"]["slo"]["ok"]
        and arms["pinned"]["slo"]["ok"],
        "reports": arms,
    }


def _set_settings(config: SoakConfig) -> dict:
    """Every resolver's ConflictSet arguments for the run: the device key
    budget (the reference's conflict_device_key_words and
    conflict_max_device_key_bytes knobs), then resolver_settings."""
    out = {}
    if config.device_key_words is not None:
        out["key_words"] = config.device_key_words
    if config.device_key_bytes is not None:
        out["max_device_key_bytes"] = config.device_key_bytes
    out.update(config.resolver_settings or {})
    return out


def _build_cluster(config: SoakConfig):
    """A rated cluster + primed client Database handles."""
    n_clients = max(1, config.clients)
    # Sample every transaction: the soak's SLO gate IS the latency chain,
    # and the harness owns its own (fresh) collector.
    client_kw = dict(latency_sample_rate=1.0)
    if config.witness_retry is not None:
        client_kw["witness_retry"] = config.witness_retry
    rk_kw = {}
    if config.max_tps is not None:
        rk_kw["max_tps"] = config.max_tps
    if config.degraded_tps_fraction is not None:
        rk_kw["degraded_tps_fraction"] = config.degraded_tps_fraction
    grv_kw = {}
    if config.grv_queue_max is not None:
        grv_kw["grv_queue_max"] = config.grv_queue_max
    settings = _set_settings(config)
    if config.cluster == "dynamic":
        assert config.backend != "sharded", (
            "backend='sharded' is a sim-cluster seam (SimCluster's "
            "conflict_set); DynamicCluster recruits resolvers by backend "
            "name only"
        )
        from ..server.dynamic_cluster import DynamicCluster

        controller_kw = dict(grv_kw, ratekeeper_settings=rk_kw)
        cluster = DynamicCluster(
            seed=config.seed,
            conflict_backend=config.backend,
            buggify=config.buggify,
            device=config.device,
            resolver_settings=settings,
            controller_settings=dict(controller_kw, **client_kw),
        )
        dbs = [cluster.database(f"soak{i}", **client_kw)
               for i in range(n_clients)]

        async def prime(tr):
            tr.set(b"soak/boot", b"1")

        cluster.run_all([(dbs[0], dbs[0].run(prime))], timeout_vt=600.0)
        return cluster, dbs
    from ..server import SimCluster
    from ..server.ratekeeper import Ratekeeper

    conflict_set = None
    backend = config.backend
    if backend == "sharded":
        # Sharded resolver 0: a ShardedTorchConflictSet, its
        # shards on one device, split evenly across the soak key space
        # so every shard sees load.  The resolver swaps it in via
        # SimCluster's conflict_set seam.
        from ..parallel.sharded_resolver import ShardedTorchConflictSet

        n = max(2, config.sharded_shards)
        split = [
            b"soak/%06d" % (config.keys * s // n) for s in range(1, n)
        ]
        conflict_set = ShardedTorchConflictSet(
            split,
            key_words=8,  # 16-byte effective width covers soak/ and the
            # sim cluster's \xff/SC/ self-conflict keys; anything longer
            # rides the exact-semantics mirror pin by design
            h_cap=1 << 12,
            device=config.device,
            bucket_mins=(64, 128, 128),
            # Scaling headroom: with a max_shards ceiling the
            # balancer can scale the set live.
            max_shards=config.sharded_max_shards,
            **{k: v for k, v in settings.items()
               if k == "max_device_key_bytes"},
        )
        backend = "cpu"  # the other resolvers (if any) stay host-only
    cluster = SimCluster(
        seed=config.seed,
        conflict_backend=backend,
        n_resolvers=config.n_resolvers,
        buggify=config.buggify,
        conflict_set=conflict_set,
        device=config.device,
        resolver_settings=settings,
        **grv_kw,
    )
    rk = Ratekeeper(
        cluster.master_proc,
        cluster.tlogs,
        cluster.storages,
        sample_interval=config.rk_sample_interval,
        resolvers=cluster.resolvers,
        proxies=cluster.proxies,
        **rk_kw,
    )
    for p in cluster.proxies:
        p.ratekeeper = rk.interface()
    cluster._soak_ratekeeper = rk
    return cluster, [cluster.database(f"soak{i}", **client_kw)
                     for i in range(n_clients)]
