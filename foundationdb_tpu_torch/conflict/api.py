"""ConflictSet: the resolver's conflict-engine entry point, on the GPU.

A copy of the reference package's ``conflict/api.py`` (itself modelled on
fdbserver/ConflictSet.h: newConflictSet / ConflictBatch::addTransaction /
detectConflicts) with the device engine ``TorchConflictSet`` behind it.

Backends:
  "cpu"    - engine_cpu.CpuConflictSet (host, exact, low latency)
  "torch"  - engine_torch.TorchConflictSet (device, whole-batch vectorized)
  "hybrid" - torch for batches of at least ``device_min_batch``
             transactions, cpu for smaller ones

Keys past the device's width: where the reference keeps a batch that
holds one on the mirror, and after a long-key write pins all history
there for an MVCC window, the port's device serves it, with the long
keys' parts of history in the long-key side table (long_keys.py); the
mirror then holds the device's history and the side table the rest.

Device resilience: whenever a device engine exists, the chunked CPU mirror
stays AUTHORITATIVE.  Every device-served batch's committed writes are
applied to it (``apply_batch``: merge and evict only, no detection), and a
DeviceCircuitBreaker gates every device attempt.  A batch interrupted by a
DeviceFault is re-run on the mirror inside the same call with identical
verdicts; consecutive faults open the circuit and route everything to the
host; a half-open probe with deterministic exponential backoff re-attempts
the device and, before it serves, rehydrates the device from an immutable
mirror snapshot.  No DeviceFault escapes.  ``mirror_check`` diffs the
mirror against the device's exported state and treats a divergence as a
device fault that opens the breaker.

Double-buffered pipeline (``pipeline_depth`` > 1): ``pipeline_submit``
dispatches a batch without reading it back; ``pipeline_complete_oldest``
reads the oldest one back, applies it to the mirror and records the synced
snapshot.  The breaker is credited at that sync, never at dispatch.

Observability, as the reference's: spans (``flow/spans.py``) for each
stage of a device-served batch — the engine's encode, dispatch and
readback; here the device in-flight window (``device``, open from dispatch
to sync and closed on every path, with ``fault``, ``diverged`` or
``replayed`` when the batch was not verified), ``sync``, ``apply`` with
its ``mirror_apply`` and ``rehydrate`` — parented to the caller's batch
span; the host phases' seq extent as ``host_phase_seq``; a
``MirrorDivergence`` trace event and a ``mirror_divergence`` flight-
recorder capture on a confirmed divergence.

Settings the reference reads from environment knobs are constructor
arguments here, with the reference's defaults (``history``, ``delta_cap``
and ``evict_every`` select and size the tiered history, or in flat mode
set the amortized eviction cadence, and ``witness``, ``search`` and
``search_stride`` are FDB_TPU_WITNESS, FDB_TPU_SEARCH and
FDB_TPU_SEARCH_STRIDE, see engine_torch.TorchConflictSet;
``program_costs`` is FDB_TPU_PROGRAM_COSTS).  ``mirror_coalesce`` is
FDB_TPU_MIRROR_COALESCE (coalesce_window): the mirror queues the committed
writes of up to that many device-served batches and folds them together,
at the window's end or at the next mirror read, whichever comes first; the
device's synced point is recorded only when no fold is pending.  The
device takes keys of at most ``min(max_device_key_bytes, key_words * 4)``
bytes (``max_device_key_bytes`` is the reference's
conflict_max_device_key_bytes knob, default ``MAX_DEVICE_KEY_BYTES``).

Which real errors reach the breaker, as in the reference: out-of-memory
errors (``DeviceOOM``), and a lost or reset card (``device.is_lost_device``:
cudaErrorDevicesUnavailable, cudaErrorNoDevice, cudaErrorECCUncorrectable,
cudaErrorLaunchTimeout) at the two sites where the reference maps a
JaxRuntimeError — the engine's dispatch (``CompileFailed`` at a shape's
first dispatch, else ``DeviceUnavailable``) and the pipelined sync
(``DeviceUnavailable(site="sync")``, the parked batches replayed on the
mirror).  Every other error propagates: any other CUDA error, a failed
build, a bug.  So do errors where the reference maps nothing: the depth-1
readback (the reference's synchronous serve catches only DeviceFault),
``load_from`` and the rehydration; the sharded set walks a shard's breaker
only on an injected fault.

The transfer guard (``transfer_guard=True``, the reference's
FDB_TPU_TRANSFER_GUARD, off by default): the engine's tickets carry their
buffers in GuardedDeviceValue proxies (flow/hotpath.py) that raise
TransferGuardError on a host read outside a sanctioned sync, and on CUDA
the pipelined dispatch runs under ``torch.cuda.set_sync_debug_mode(
"error")`` (``_dispatch_guard``), so an unsanctioned synchronizing call in
it raises torch's error.  Depth 1 is not armed, as in the reference.

Usage mirrors the reference ABI:
    cs = ConflictSet(backend="hybrid")
    batch = cs.new_batch()
    for tr in txns: batch.add_transaction(tr)
    statuses = batch.detect_conflicts(now, new_oldest_version)
"""

from __future__ import annotations

from collections import deque
from contextlib import nullcontext
from typing import List, Optional

from ..flow.flight_recorder import maybe_trigger
from ..flow.hotpath import cuda_sync_debug_mode, hot_path
from ..flow.spans import begin_span, current_span
from ..flow.trace import TraceEvent
from ..metrics import wall_now
from ..device import is_lost_device
from .device_faults import DeviceCircuitBreaker, DeviceFault, DeviceUnavailable
from .engine_cpu import CpuConflictSet
from .engine_cpu_flat import FLOOR_VERSION
from .long_keys import SideTable
from .types import TransactionConflictInfo

# Longest key the device takes (the reference's
# conflict_max_device_key_bytes default); the parts of history that longer
# keys bound live in the long-key side table (long_keys.py).
MAX_DEVICE_KEY_BYTES = 16


def coalesce_window(value, pipeline_depth: int) -> int:
    """A ``mirror_coalesce`` setting as the mirror's fold window K (1 =
    apply every batch at once), read as the reference reads its
    FDB_TPU_MIRROR_COALESCE knob: ``"auto"`` is one fold per pipeline turn
    (``max(1, pipeline_depth)``), an integer k is ``max(1, k)``, and
    anything else is 1."""
    raw = str(value)
    if raw == "auto":
        return max(1, pipeline_depth)
    try:
        return max(1, int(raw))
    except ValueError:
        return 1


def _above_window(keys, vers, oldest):
    """A history as every snapshot the window admits sees it: a version
    below ``oldest`` never conflicts, so it reads as the floor, and a row
    that repeats its predecessor's value is dropped."""
    out_k, out_v = [], []
    for k, v in zip(keys, vers):
        v = v if v >= oldest else FLOOR_VERSION
        if not out_v or out_v[-1] != v:
            out_k.append(k)
            out_v.append(v)
    return out_k, out_v


class ConflictBatch:
    """Ref: ConflictBatch in fdbserver/ConflictSet.h:32."""

    def __init__(self, cs: "ConflictSet"):
        self._cs = cs
        self._txns: list[TransactionConflictInfo] = []

    def add_transaction(self, tr: TransactionConflictInfo):
        self._txns.append(tr)

    @property
    def transaction_count(self) -> int:
        return len(self._txns)

    def detect_conflicts(self, now: int, new_oldest_version: int) -> List[int]:
        return self._cs._detect(self._txns, now, new_oldest_version)


class InflightBatch:
    """One batch in the double-buffered pipeline.

    Created by ConflictSet.pipeline_submit and completed, always in submit
    order, by pipeline_complete_oldest / pipeline_drain or by the breaker's
    mirror replay.  CPU-served batches come back already completed."""

    __slots__ = ("txns", "ticket", "now", "new_oldest_version", "plan",
                 "statuses", "degraded", "span", "device_span", "witness")

    def __init__(self, txns, ticket, now, new_oldest_version, plan=None):
        self.txns = txns
        self.ticket = ticket
        # The batch's long-key plan (long_keys.SideTable.plan), or None.
        self.plan = plan
        self.now = now
        self.new_oldest_version = new_oldest_version
        self.statuses: Optional[List[int]] = None
        self.degraded = False
        # Per-txn abort witness, (version, read-range ordinal) or None per
        # txn; [] when witness emission is off.
        self.witness: list = []
        # The owning batch span (the caller's, from the hub's stack at
        # dispatch) and the device in-flight span [dispatch done -> sync
        # returned], whose overlap with its siblings is the pipeline's.
        self.span = None
        self.device_span = None

    @classmethod
    def completed(cls, statuses: List[int], degraded: bool = False,
                  witness: Optional[list] = None):
        e = cls(None, None, 0, 0)
        e._resolve(statuses, degraded, witness)
        return e

    @property
    def done(self) -> bool:
        return self.statuses is not None

    @property
    def dev_txns(self):
        """The transactions as the device took them."""
        return self.txns if self.plan is None else self.plan.dev_txns

    def _resolve(self, statuses: List[int], degraded: bool,
                 witness: Optional[list] = None) -> None:
        self.statuses = statuses
        self.degraded = degraded
        self.witness = witness if witness is not None else []


class ConflictSet:
    """The resolver's conflict set (see the module docstring).

    ``backend="torch"`` with ``device=None`` runs on the GPU and raises
    without one; ``device="cpu"`` runs the same engine with the kernels'
    plain twins."""

    AUTHORITY_HYSTERESIS = 8

    def __init__(
        self,
        backend: str = "torch",
        oldest_version: int = 0,
        key_words: int = 4,
        device=None,
        bucket_mins: tuple = (8, 8, 8),
        fault_injector=None,
        h_cap: int = 1 << 16,
        pipeline_depth: int = 2,
        witness: bool = True,
        device_min_batch: int = 256,
        history: str = "flat",
        delta_cap: int = 0,
        evict_every: int = 1,
        program_costs: bool = False,
        mirror_coalesce=1,
        search: str = "",
        search_stride: int = 512,
        transfer_guard: bool = False,
        max_device_key_bytes: int = MAX_DEVICE_KEY_BYTES,
    ):
        if backend not in ("cpu", "torch", "hybrid"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self._key_words = key_words
        self.device_min_batch = device_min_batch
        # Every backend keeps the CPU engine: for a device backend it is
        # the authoritative mirror faulted batches fall back to.  Its key
        # width is the device's, so syncing re-encodes nothing.
        self._cpu = CpuConflictSet(oldest_version, key_words=key_words)
        self._dev = None
        self._breaker: Optional[DeviceCircuitBreaker] = None
        # Batches dispatched to the device and not yet synced, oldest
        # first.  Depth 1 keeps the synchronous path.
        self.pipeline_depth = max(1, pipeline_depth)
        self._cpu.coalesce_window = coalesce_window(mirror_coalesce, self.pipeline_depth)
        self._pipe: "deque[InflightBatch]" = deque()
        if backend in ("torch", "hybrid"):
            from .engine_torch import TorchConflictSet

            self._dev = TorchConflictSet(
                oldest_version=oldest_version,
                key_words=key_words,
                device=device,
                bucket_mins=bucket_mins,
                h_cap=h_cap,
                history=history,
                delta_cap=delta_cap,
                evict_every=evict_every,
                pipeline_depth=self.pipeline_depth,
                witness=witness,
                search=search,
                search_stride=search_stride,
                transfer_guard=transfer_guard,
            )
            for name in ("device_faults", "breaker_opens", "breaker_probes",
                         "breaker_closes", "degraded_batches", "rehydrates",
                         "cpu_fallback_txns", "mirror_checks",
                         "mirror_divergence", "mirror_mismatch_keys",
                         "pipeline_dispatches", "pipeline_replayed_batches"):
                self._dev.metrics.counter(name)  # pre-create: stable snapshots
            self._breaker = DeviceCircuitBreaker(metrics=self._dev.metrics)
            self._dev.fault_injector = fault_injector
        # hybrid: which side served the last device-eligible batch
        self._authority = "cpu" if backend == "hybrid" else backend
        # Keys past the device width: their parts of history, beside the
        # device's (long_keys.py); None for the host-only backend, whose
        # mirror holds every key itself.
        self._long: Optional[SideTable] = None
        if self._dev is not None:
            self._long = SideTable(min(max_device_key_bytes, key_words * 4), oldest_version)
        # The device is stale whenever the mirror absorbed a batch the
        # device did not run; the next device attempt rehydrates first.
        self._device_stale = True
        # The last batch was device-eligible but served by the CPU because
        # of a fault or an open circuit (consume_degraded).
        self._degraded_last = False
        # Consecutive sub-threshold batches while device authority is held.
        self._small_streak = 0
        # Transactions the mirror decided because the device path was
        # degraded, and a window of (txns, wall seconds) of those detects
        # for backend_signal's throughput estimate (wall-derived).
        self._cpu_fallback_txns = 0
        self._cpu_fallback_recent = deque(maxlen=32)
        self._last_mirror_check: Optional[dict] = None
        # Whichever engine serves a batch, its per-txn witness lands here.
        self._witness = witness
        self.last_witness: list = []
        # device_metrics computes the program cost table itself (True), or
        # shows it once some caller has (programs.cached_program_costs).
        self.program_costs = program_costs

    @property
    def _jax(self):
        """Read-only alias of the device engine under the reference's
        attribute name: the reference's Resolver turns its pipeline on, and
        samples the engine's registry, only when ``conflicts._jax`` exists
        (server/resolver.py:206-210, :247)."""
        return self._dev

    def install_fault_injector(self, injector) -> None:
        """Attach a DeviceFaultInjector to the device engine; no-op for the
        host-only backend."""
        if self._dev is not None:
            self._dev.fault_injector = injector

    def consume_degraded(self) -> bool:
        """True iff the most recent batch was served by the CPU because of
        a device fault or an open breaker; reading resets the flag."""
        was, self._degraded_last = self._degraded_last, False
        return was

    def new_batch(self) -> ConflictBatch:
        return ConflictBatch(self)

    @property
    def oldest_version(self) -> int:
        return self._cpu.oldest_version  # the authoritative mirror

    def _detect(self, txns, now, new_oldest_version) -> List[int]:
        if self._pipe:
            # A synchronous detect with batches still parked: the mirror
            # must be current before it can decide or absorb this batch.
            self.pipeline_drain()
        if self.backend == "hybrid":
            return self._detect_hybrid(txns, now, new_oldest_version)
        if self.backend == "torch":
            return self._detect_device(txns, now, new_oldest_version)
        statuses = self._cpu.detect(txns, now, new_oldest_version)
        self.last_witness = self._witness_of(self._cpu)
        return statuses

    def _witness_of(self, engine) -> list:
        """The serving engine's per-txn witness for the batch it just
        decided."""
        return list(engine.last_witness) if self._witness else []

    def _plan(self, txns):
        """The batch's long-key plan (long_keys.SideTable.plan): None when
        the device takes the batch as it is.  A parked batch with a plan
        has not yet recorded its side-table parts, so none may be parked
        when the next plan is made."""
        if self._long is None:
            return None
        if any(e.plan is not None for e in self._pipe):
            self.pipeline_drain()
        plan = self._long.plan(txns, self._cpu.oldest_version)
        if plan is not None:
            # Counted only when they happen, so that a registry without
            # long keys stays the reference's.
            self._dev.metrics.counter("long_key_batches").add()
            if plan.host_only:
                self._dev.metrics.counter("long_key_host_batches").add()
        return plan

    def _settle_plan(self, plan, txns, statuses, now, new_oldest_version) -> List[int]:
        """A device-decided batch's final verdicts: the device's, joined
        with the side table's history conflicts, whose parts are then
        recorded."""
        if plan is None:
            return statuses
        statuses = list(statuses)
        self._long.settle(plan, txns, statuses, self.last_witness, now, new_oldest_version)
        return statuses

    def _apply_to_mirror(self, txns, statuses, now, new_oldest_version, parent=None) -> None:
        """Apply a device-decided batch to the mirror, then, unless the
        mirror still holds queued (coalesced) batches, record the
        post-batch snapshot as the device's synced point (pre-encoding the
        chunks the batch created, so a later rehydration is a cheap diff).
        snapshot() is a settle barrier, so recording it with a fold pending
        would fold early: with a window of K the synced point moves once
        every K batches, as the reference's does.  Both steps' wall seconds
        go to the engine registry's wall namespace (note_synced_seconds
        only when it ran).  Both run under an "apply" span (a child of
        `parent`, else of the hub's current span), the mirror's apply under
        its "mirror_apply" (a host phase)."""
        m = self._dev.metrics
        with begin_span("apply", parent=parent, attrs={"version": now, "n_txn": len(txns)}):
            t0 = wall_now()
            with begin_span("mirror_apply", attrs={"n_txn": len(txns)}) as msp:
                self._cpu.apply_batch(txns, statuses, now, new_oldest_version)
            t1 = wall_now()
            m.record_wall("mirror_apply_seconds", t1 - t0)
            self._dev._note_host_span(msp)
            if self._cpu.pending_batches == 0:
                self._dev.note_synced(self._cpu.snapshot(), self._cpu.take_fresh_chunks())
                m.record_wall("note_synced_seconds", wall_now() - t1)

    def _device_serve(self, txns, now, new_oldest_version):
        """One device attempt under the breaker.  Returns the statuses, or
        None when the circuit is open or the attempt faulted — the caller
        then serves the batch from the mirror, which decides identically.
        A successful attempt is applied to the mirror and is the breaker's
        half-open probe when one is due."""
        if not self._breaker.allows_device():
            self._degraded_last = True
            return None
        # A device span on the synchronous path too (dispatch and sync in
        # one detect): depth 1 carries the pipelined path's span names,
        # with no overlap by construction.
        dspan = begin_span("device", attrs={"version": now})
        try:
            if self._device_stale:
                self._rehydrate_from_mirror()
            statuses = self._dev.detect(txns, now, new_oldest_version)
        except DeviceFault as e:
            dspan.end(attrs={"fault": 1})
            self._breaker.on_failure(e)
            self._device_stale = True
            self._degraded_last = True
            return None
        dspan.end()
        self._breaker.on_success()
        self._apply_to_mirror(txns, statuses, now, new_oldest_version)
        return statuses

    def _rehydrate_from_mirror(self) -> None:
        """Rebuild the device history from a mirror snapshot, for both
        serve paths.  load_from can itself fault (grow); the caller's
        except block then fails the attempt."""
        with begin_span("rehydrate"):
            self._dev.load_from(self._cpu.snapshot())
        # load_from encoded every live chunk: the fresh backlog is moot.
        self._cpu.take_fresh_chunks()
        self._breaker.note_rehydrate()
        self._device_stale = False

    def _host_detect(self, txns, now, new_oldest_version, plan=None) -> List[int]:
        """Decide a batch on the host: the mirror alone without a plan,
        else the mirror and the side table together.  Sets last_witness."""
        if plan is None:
            statuses = self._cpu.detect(txns, now, new_oldest_version)
            self.last_witness = self._witness_of(self._cpu)
            return statuses
        statuses, witness = self._long.host_detect(
            self._cpu, txns, plan, now, new_oldest_version)
        self.last_witness = witness if self._witness else []
        return statuses

    def _cpu_detect_fallback(self, txns, now, new_oldest_version, plan=None):
        """Host detect for a DEGRADED device-eligible batch, timed on the
        wall clock for backend_signal's throughput estimate."""
        t0 = wall_now()
        statuses = self._host_detect(txns, now, new_oldest_version, plan)
        self._cpu_fallback_txns += len(txns)
        self._cpu_fallback_recent.append((len(txns), wall_now() - t0))
        if self._dev is not None:
            self._dev.metrics.counter("cpu_fallback_txns").add(len(txns))
        return statuses

    def _detect_device(self, txns, now, new_oldest_version) -> List[int]:
        """backend="torch": every batch goes to the device but those whose
        long keys couple it to the side table (host_only); the mirror
        absorbs faults and open-circuit windows."""
        plan = self._plan(txns)
        if plan is None or not plan.host_only:
            statuses = self._device_serve(
                txns if plan is None else plan.dev_txns, now, new_oldest_version)
            if statuses is not None:
                self.last_witness = self._witness_of(self._dev)
                return self._settle_plan(plan, txns, statuses, now, new_oldest_version)
            self._device_stale = True
            return self._cpu_detect_fallback(txns, now, new_oldest_version, plan)
        self._device_stale = True
        return self._host_detect(txns, now, new_oldest_version, plan)

    def _hybrid_wants_device(self, txns, plan) -> bool:
        """Hybrid routing (and its hysteresis updates), shared by the
        synchronous and the pipelined path: True iff a device serve is due
        for this batch.  While device authority is held, small batches
        still run on the device; only a sustained small streak flips
        authority back."""
        big = len(txns) >= self.device_min_batch
        if plan is not None and plan.host_only:
            return False
        if self._authority == "torch":
            self._small_streak = 0 if big else self._small_streak + 1
            return self._small_streak < self.AUTHORITY_HYSTERESIS
        if big:
            self._authority = "torch"
            self._small_streak = 0
            return True
        return False

    def _detect_hybrid(self, txns, now, new_oldest_version) -> List[int]:
        plan = self._plan(txns)
        attempted = self._hybrid_wants_device(txns, plan)
        if attempted:
            statuses = self._device_serve(
                txns if plan is None else plan.dev_txns, now, new_oldest_version)
            if statuses is not None:
                self.last_witness = self._witness_of(self._dev)
                return self._settle_plan(plan, txns, statuses, now, new_oldest_version)
        if self._authority == "torch":
            # Flip back host-side: the mirror already holds the state.
            self._authority = "cpu"
            self._small_streak = 0
        self._device_stale = True
        if attempted:
            return self._cpu_detect_fallback(txns, now, new_oldest_version, plan)
        return self._host_detect(txns, now, new_oldest_version, plan)

    # -- double-buffered pipeline ------------------------------------------
    @property
    def pipeline_inflight(self) -> int:
        """Batches dispatched to the device and not yet synced."""
        return len(self._pipe)

    def pipeline_submit(self, txns, now, new_oldest_version) -> InflightBatch:
        """Admit one batch into the pipeline.

        Device-routed batches are packed and dispatched without a sync and
        come back parked; the caller completes oldest entries until
        pipeline_inflight is under its depth bound, and drains the tail.
        CPU-routed batches (host-only backend, hybrid small batches,
        long keys that couple the batch to the side table, open circuit, a
        dispatch fault) first drain the pipeline and come back completed.
        Routing is the synchronous path's, so verdict streams are identical
        across depths."""
        wants_device = False
        plan = None
        if self._dev is not None and self.pipeline_depth > 1:
            plan = self._plan(txns)
            if self.backend == "torch":
                wants_device = plan is None or not plan.host_only
            else:
                wants_device = self._hybrid_wants_device(txns, plan)
        if wants_device:
            entry = self._pipeline_dispatch(txns, now, new_oldest_version, plan)
            if entry is not None:
                return entry
            # A device serve was due but the circuit is open or the
            # dispatch faulted (the parked tail is already replayed):
            # the synchronous path's degraded fallback.
            if self.backend == "hybrid" and self._authority == "torch":
                self._authority = "cpu"
                self._small_streak = 0
            self._device_stale = True
            statuses = self._cpu_detect_fallback(txns, now, new_oldest_version, plan)
            self.consume_degraded()  # folded into the entry's flag
            return InflightBatch.completed(statuses, degraded=True, witness=self.last_witness)
        if self._dev is not None and self.pipeline_depth > 1:
            # Routing chose the CPU: the synchronous path's post-routing
            # bookkeeping, against a drained (current) mirror.
            self.pipeline_drain()
            if self.backend == "hybrid" and self._authority == "torch":
                self._authority = "cpu"
                self._small_streak = 0
            self._device_stale = True
            statuses = self._host_detect(txns, now, new_oldest_version, plan)
            return InflightBatch.completed(
                statuses, degraded=self.consume_degraded(), witness=self.last_witness,
            )
        # Depth 1 or host-only backend: the synchronous path decides.
        statuses = self._detect(txns, now, new_oldest_version)
        return InflightBatch.completed(
            statuses, degraded=self.consume_degraded(), witness=self.last_witness,
        )

    def _dispatch_guard(self):
        """The transfer guard's arming of the dispatch: on CUDA with
        ``transfer_guard`` on, ``torch.cuda.set_sync_debug_mode("error")``
        for the dispatch call, so a synchronizing call in it raises unless
        a sanctioned sync scope of the engine allows it, as the reference
        arms ``jax.transfer_guard_device_to_host("disallow")``.  The mode is
        process-global and is restored on every exit, a DeviceFault's
        included.  On the CPU only the ticket's proxies act."""
        if self._dev.arms_cuda_guard:
            return cuda_sync_debug_mode("error")
        return nullcontext()

    @hot_path(bound="batch")
    def _pipeline_dispatch(self, txns, now, new_oldest_version,
                           plan=None) -> Optional[InflightBatch]:
        """One device dispatch under the breaker without a sync — the
        pipelined twin of _device_serve.  Returns the parked entry, or None
        when the circuit is open or the dispatch faulted (the parked tail
        is then already replayed on the mirror).  Injected faults raise
        before any state changes, so the replay decides every parked batch
        against exactly its history."""
        if not self._breaker.allows_device():
            # An open circuit implies the opening fault drained the pipe.
            self._degraded_last = True
            return None
        try:
            if self._device_stale:
                # A stale device means the mirror served the preceding
                # batches, so nothing is parked.
                assert not self._pipe, "rehydrating around parked batches"
                self._rehydrate_from_mirror()
            with self._dispatch_guard():
                ticket = self._dev.dispatch_txns(
                    txns if plan is None else plan.dev_txns, now, new_oldest_version)
        except DeviceFault as e:
            self._breaker.on_failure(e)
            self._device_stale = True
            self._degraded_last = True
            self._pipeline_replay_on_mirror()
            return None
        # The breaker is credited at the sync (pipeline_complete_oldest):
        # a device failure surfaces at the readback, and a success credited
        # at dispatch would keep the circuit from ever opening.
        self._dev.metrics.counter("pipeline_dispatches").add()
        entry = InflightBatch(txns, ticket, now, new_oldest_version, plan)
        # The owning batch span (the caller pushed it for this synchronous
        # submit), so that the deferred completion's spans parent to it,
        # and the device in-flight span, closed at the sync.
        entry.span = current_span()
        entry.device_span = begin_span("device", attrs={"version": now})
        self._pipe.append(entry)
        return entry

    @hot_path(bound="batch")
    def pipeline_complete_oldest(self) -> None:
        """Sync and retire the OLDEST in-flight batch: read its verdicts
        back, apply its committed writes to the mirror, record the synced
        snapshot.  A fault at the sync or a fixpoint divergence drains the
        whole pipeline onto the mirror instead — identical verdicts either
        way, device marked stale for the next submit."""
        entry = self._pipe[0]
        # The sync span under the owning batch span; the device span closes
        # when the sync returns, on every path.
        sspan = begin_span("sync", parent=entry.span, attrs={"version": entry.now})
        try:
            statuses, diverged = self._dev.sync_ticket(entry.ticket)
        except (DeviceFault, RuntimeError) as e:
            if isinstance(e, DeviceFault):
                fault = e
            elif is_lost_device(e):
                # A lost or reset card at the readback, as the reference
                # maps a JaxRuntimeError here; site "sync" keeps it apart
                # from dispatch-time faults in the counters and reasons.
                fault = DeviceUnavailable(f"sync: {e}", site="sync")
            else:
                raise  # a fault of the code propagates
            sspan.end(attrs={"error": type(e).__name__})
            if entry.device_span is not None:
                entry.device_span.end(attrs={"fault": 1})
            self._breaker.on_failure(fault)
            self._device_stale = True
            self._degraded_last = True
            self._pipeline_replay_on_mirror()
            return
        sspan.end()
        if entry.device_span is not None:
            entry.device_span.end(attrs={"diverged": 1} if diverged else None)
        if diverged:
            # The fixpoint left this batch undecided and the device history
            # unchanged for it, so every later dispatch decided against
            # stale history.  The mirror re-decides this batch and the
            # parked tail; not a breaker event and not a degraded serve
            # (depth 1 serves the same batch as a normal success).
            self._device_stale = True
            self._pipeline_replay_on_mirror(degraded=False)
            return
        # The verdicts are real only now: credit the breaker here.
        self._breaker.on_success()
        self._pipe.popleft()
        statuses_list = [int(s) for s in statuses[: len(entry.txns)]]
        self._apply_to_mirror(entry.dev_txns, statuses_list, entry.now, entry.new_oldest_version,
                              parent=entry.span)
        self.last_witness = self._witness_of(self._dev)
        statuses_list = self._settle_plan(entry.plan, entry.txns, statuses_list, entry.now,
                                          entry.new_oldest_version)
        entry._resolve(statuses_list, degraded=False, witness=self.last_witness)

    def _pipeline_replay_on_mirror(self, degraded: bool = True) -> None:
        """Drain every in-flight batch onto the mirror, in order.  The
        mirror is current through the last completed batch and decides
        identically, so the replay is exact.  `degraded` tags the replies:
        True for fault-driven replays, False for a fixpoint divergence
        (whose reply tag must not depend on depth)."""
        while self._pipe:
            entry = self._pipe.popleft()
            if entry.device_span is not None:
                # The parked batch never reached its sync.
                entry.device_span.end(attrs={"replayed": 1})
            self._dev.metrics.counter("pipeline_replayed_batches").add()
            if degraded:
                statuses = self._cpu_detect_fallback(entry.txns, entry.now,
                                                     entry.new_oldest_version, entry.plan)
            else:
                # A by-design re-decide, kept out of the fallback window.
                statuses = self._host_detect(entry.txns, entry.now, entry.new_oldest_version,
                                             entry.plan)
            entry._resolve(statuses, degraded=degraded, witness=self.last_witness)
        self._degraded_last = False  # per-entry flags carry it instead

    def pipeline_drain(self) -> None:
        """Complete every in-flight batch (idle flush, the barrier before a
        CPU serve, teardown)."""
        while self._pipe:
            self.pipeline_complete_oldest()

    @property
    def host_phase_seq(self) -> int:
        """The seq extent of the host-phase spans (encode, mirror_apply,
        readback): hub sequence numbers, never wall time, so the Resolver's
        host_fraction gauge is deterministic.  0 for the host-only
        backend."""
        return self._dev.host_phase_seq if self._dev is not None else 0

    def backend_signal(self) -> dict:
        """O(1) admission-control probe: the breaker's state plus the
        mirror's measured fallback throughput (wall-derived; 0.0 = nothing
        measured yet)."""
        state = self._breaker.state if self._breaker is not None else "ok"
        tps = 0.0
        wall = sum(w for _n, w in self._cpu_fallback_recent)
        if wall > 0.0:
            tps = sum(n for n, _w in self._cpu_fallback_recent) / wall
        return {
            "backend_state": state,
            "cpu_mirror_tps": tps,
            "cpu_fallback_txns": self._cpu_fallback_txns,
            "mirror_divergence": (
                int(self._dev.metrics.counter("mirror_divergence").value)
                if self._dev is not None else 0
            ),
        }

    def mirror_check(self) -> Optional[dict]:
        """Diff a mirror snapshot against the device's exported state.
        Returns None for the host-only backend, else a report
        ({status: ok|diverged|skipped, ...}).  A confirmed divergence is a
        device fault: counted, traced (MirrorDivergence), the breaker opens
        (the mirror stays authoritative; the device is marked stale) and
        the flight recorder captures.  O(H) host decode, so
        callers run it on a period, never per batch.

        Tiered history evicts its base only at major compactions, and flat
        history with amortized eviction (``evict_every`` > 1) only every
        evict_every-th batch, so below the window their rows may carry
        other (equally inert) versions than the mirror's, which evicts
        every batch.  There a row-by-row mismatch is a divergence only if
        the two histories also differ as the window sees them
        (_above_window); the report's ``below_window_keys`` counts the keys
        that differ only below it."""
        if self._dev is None:
            return None
        m = self._dev.metrics
        if self._pipe:
            # The mirror is legitimately behind by the parked batches.
            report = {"status": "skipped", "reason": "pipeline_inflight"}
            self._last_mirror_check = report
            return report
        if self._device_stale or self._breaker.state != "ok":
            report = {
                "status": "skipped",
                "reason": (
                    "device_stale" if self._device_stale
                    else f"breaker_{self._breaker.state}"
                ),
            }
            self._last_mirror_check = report
            return report
        m.counter("mirror_checks").add()
        s = self._cpu.snapshot()
        mk, mv = s.to_flat()
        dk, dv = self._dev._merged_host_state()
        d_oldest = self._dev.oldest_version
        mismatch = 0
        if s.oldest_version != d_oldest:
            mismatch += 1
        if mk != dk or mv != dv:
            mirror = dict(zip(mk, mv))
            device = dict(zip(dk, dv))
            for key in mirror.keys() | device.keys():
                if mirror.get(key) != device.get(key):
                    mismatch += 1
        below_window = 0
        lazy = self._dev.tiered or self._dev.evict_every > 1
        if (mismatch and lazy and s.oldest_version == d_oldest
                and _above_window(mk, mv, d_oldest) == _above_window(dk, dv, d_oldest)):
            below_window, mismatch = mismatch, 0
        report = {
            "status": "ok" if mismatch == 0 else "diverged",
            "boundaries": len(mk),
            "device_boundaries": len(dk),
            "mismatch_keys": mismatch,
            "stamp": s.stamp,
        }
        if lazy:
            report["below_window_keys"] = below_window
        if mismatch:
            m.counter("mirror_divergence").add()
            m.counter("mirror_mismatch_keys").add(mismatch)
            TraceEvent("MirrorDivergence", severity=40).detail(
                "mismatch_keys", mismatch).detail("mirror_boundaries", len(mk)).detail(
                "device_boundaries", len(dk)).detail("mirror_oldest", s.oldest_version).detail(
                "device_oldest", d_oldest).log()
            breaker = self._breaker
            breaker.on_divergence(f"mismatch_keys={mismatch}")
            # After on_divergence, so the capture's transitions hold the
            # breaker open this divergence caused.
            maybe_trigger(
                "mirror_divergence",
                detail={"mismatch_keys": mismatch, "mirror_boundaries": len(mk),
                        "device_boundaries": len(dk)},
                transitions=lambda: [list(t) for t in breaker.transitions],
                source=breaker.breaker_id,
            )
            # The device state is suspect: rehydrate from a snapshot before
            # it serves again (after the breaker's backoff).
            self._device_stale = True
            self._degraded_last = True
        self._last_mirror_check = report
        return report

    def device_metrics(self, now=None) -> Optional[dict]:
        """The device engine's registry snapshot plus the breaker state
        (backend_state, transitions), the pipeline's depth and occupancy
        and the mirror's maintenance facts; None for the host-only
        backend."""
        if self._dev is None:
            return None
        snap = self._dev.metrics.snapshot(now=now)
        snap["last_occupancy"] = dict(self._dev.last_occupancy)
        snap["distinct_shapes"] = len(self._dev._bucket_dispatches)
        snap["h_cap"] = self._dev.h_cap
        if self._dev.tiered:
            # The host-side shape facts of the tiers (their sizes and fill
            # are in the counters, gauges and histograms above).
            snap["tiers"] = {
                "mode": "tiered",
                "d_cap": self._dev.d_cap,
                "compact_every": self._dev.compact_every,
                "batches_since_major": self._dev._batches_since_major,
                "delta_bound": self._dev._dcount_bound,
            }
        snap["backend_state"] = self._breaker.state
        snap["breaker"] = self._breaker.snapshot()
        snap["pipeline"] = {"depth": self.pipeline_depth, "inflight": len(self._pipe)}
        snap["mirror"] = {
            "engine": type(self._cpu).__name__,
            "last_check": self._last_mirror_check,
            "chunks": self._cpu.chunk_count,
            "boundary_count": self._cpu.boundary_count,
            "stamp": self._cpu.stamp,
            "chunks_rebuilt": self._cpu.chunks_rebuilt,
            "evict_scans": self._cpu.evict_scans,
            "evict_skips": self._cpu.evict_skips,
        }
        # The device program cost table (programs.py): computed here only
        # with program_costs (it runs every registered program once),
        # otherwise shown once some caller has computed it.
        from .programs import cached_program_costs, program_cost_table

        dev = self._dev.device
        if self.program_costs:
            snap["programs"] = program_cost_table(device=dev)
        else:
            progs = cached_program_costs(dev)
            if progs is not None:
                snap["programs"] = progs
        return snap

    def clear(self, version: int):
        self.pipeline_drain()  # parked verdicts must land before the wipe
        for eng in (self._cpu, self._dev, self._long):
            if eng is not None:
                eng.clear(version)
        if self.backend == "hybrid":
            self._authority = "cpu"
        # The breaker is not reset: clearing data says nothing about the
        # device's health.
        self._device_stale = True
