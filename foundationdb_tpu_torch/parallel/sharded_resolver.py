"""Range-sharded conflict resolution with shard-granular fault domains.

Port of the reference package's parallel/sharded_resolver.py
(``ShardedJaxConflictSet``).  The reference scales conflict resolution the
way FoundationDB does: the key space is cut into ranges, one resolver per
range; each transaction's conflict ranges are clipped to every resolver's
range (ResolutionRequestBuilder); each resolver decides its slice and
commits the writes it judged committed; the proxy combines the verdicts
with min (Conflict < TooOld < Committed), and TooOld comes only from a
resolver that received read ranges of the transaction.  The split is also
the fault boundary: one sick resolver degrades one key range.

Here the S shards share ONE device.  Each shard's history is a slice of
stacked state tensors — keys ``[S, kw1, H]``, versions ``[S, H]``, counts
and window ``[S]``, and in tiered mode the max table ``[S, levels, H]`` and
the delta tier ``[S, kw1, D]`` / ``[S, D]`` — so ``state[s]`` is a
contiguous view that both hand-written kernels take as it is.  One batch
is uploaded once; per shard, the batch is clipped to the shard's bounds on
the device and runs the single-device step (engine_torch), shard after
shard.  The reference runs every shard in one ``shard_map`` program, whose
two cross-shard reductions need the step split in two here:

  decide   phases 1-4 and the witness vectors of every shard, the masked
           (degraded) ones included — the reference's ``last_iters`` is the
           maximum over ALL shards, since shard_map runs every body;
  combine  the undecided counts summed over the ACTIVE shards (the
           convergence gate: if any active shard diverged, every active
           shard reverts) and the witness combined over the active shards
           (losing range = minimum, version = maximum among its holders);
           with the witness off, neither the vectors nor their combine
           run, as in the reference's step compiled without them;
  commit   phases 5-6 of every active shard against the combined count;
           a masked shard keeps its slice.

The three are ``sharded_step`` and ``sharded_step_tiered``, module
functions that update the stacked state in place; the device program
registry (conflict/programs.py) holds them as the reference's
``sharded_step_kernels`` and ``sharded_step_tiered``.

Around the device path, every shard has its own always-authoritative
chunked CPU mirror (updated with the shard's LOCAL verdicts each batch) and
its own circuit breaker, counters namespaced ``shard<k>_*`` in one registry
and all pre-created.  An injected DeviceFault on shard k — at dispatch,
compile, grow or rebase, checked per shard before anything mutates — serves
only shard k's slice from its mirror with identical verdicts and walks only
shard k's breaker; shard k's half-open probe rehydrates only its slice from
an immutable mirror snapshot.  Only injected faults reach a breaker: a real
CUDA error, out-of-memory included, propagates (the reference's sharded set
maps none).

The reference's environment knobs are constructor arguments with its
defaults: ``history`` (FDB_TPU_HISTORY), ``delta_cap`` (FDB_TPU_DELTA_CAP),
``evict_every`` (FDB_TPU_EVICT_EVERY), ``witness`` (FDB_TPU_WITNESS), and
``search`` and ``search_stride`` (FDB_TPU_SEARCH, FDB_TPU_SEARCH_STRIDE;
see engine_torch.TorchConflictSet).
The device takes keys of at most ``min(max_device_key_bytes, 4 *
key_words)`` bytes (the reference's conflict_max_device_key_bytes knob,
default ``MAX_DEVICE_KEY_BYTES``); a batch with a longer key runs on the
mirrors, and a long-key write pins authority there until the mirrors fit
again and a hysteresis streak of short batches passes.

Live resharding (``reshard``, with ``balance_split_keys`` for quantile
split points) re-partitions the shards between two batches: a shard whose
range is unchanged keeps its mirror by identity (and its slice where its
index and the shard count hold), a moved range gets a mirror built by
chunk handoff (engine_cpu.engine_from_handoff) and goes stale, and a
change of shard count re-stacks the device state at the new S; every
stale slice rehydrates from its mirror at its next device batch.  The
``reshard`` fault site is checked on every moved shard before anything
mutates, and a fault defers the whole move.  Not ported: shards on
several GPUs.

Observability, as the reference's: a ``device`` span around the step and
its readback, an ``apply`` span around the mirrors' applies, a
``rehydrate`` span a shard; ``ConflictFixpointDiverged`` (``sharded``),
``MirrorDivergence`` (with the shard) and its ``mirror_divergence``
capture; and at a reshard a ``reshard`` marker span on the ShardedConflict
track, ``ShardReshard`` (or ``ShardReshardDeferred``) and a ``reshard``
capture holding the move log.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from collections import deque
from functools import partial
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..conflict import engine_torch as et
from ..conflict import programs
from ..conflict import keys as keylib
from ..conflict.api import MAX_DEVICE_KEY_BYTES, ConflictBatch, _above_window
from ..conflict.device_faults import DeviceCircuitBreaker, DeviceFault
from ..conflict.engine_cpu import CpuConflictSet, chunk_encoding, engine_from_handoff
from ..conflict.engine_cpu_flat import FLOOR_VERSION
from ..conflict.keys import uniform_int_split_keys
from ..conflict.types import COMMITTED, CONFLICT, TransactionConflictInfo
from ..device import resolve_device
from ..flow.flight_recorder import maybe_trigger
from ..flow.hotpath import g_hostguard, hot_path
from ..flow.spans import begin_span, instant
from ..flow.trace import TraceEvent
from ..metrics import MetricsRegistry, wall_now
from ..ops.rangequery import build_max_table_np, check_search, lex_less

__all__ = ["ShardedTorchConflictSet", "uniform_int_split_keys"]

I32 = torch.int32
FLOOR_REL = et.FLOOR_REL


def _lex_max(a: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Column-wise max(a, bound); a [W, N] word-major, bound [W]."""
    b = bound[:, None].expand_as(a)
    return torch.where(lex_less(a, b)[None, :], b, a)


def _lex_min(a: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    b = bound[:, None].expand_as(a)
    return torch.where(lex_less(b, a)[None, :], b, a)


def _clip_batch(lo, hi, r_begin, r_end, r_txn, w_begin, w_end, txn_cap):
    """One shard's view of the batch on the device: every range clipped to
    [lo, hi), and the per-txn TooOld read-presence mask (a shard that
    received no non-empty read range of a txn never reports TooOld)."""
    rb = _lex_max(r_begin, lo)
    re_ = _lex_min(r_end, hi)
    wb = _lex_max(w_begin, lo)
    we = _lex_min(w_end, hi)
    r_ne = lex_less(rb, re_) & (r_txn < txn_cap)
    return rb, re_, wb, we, et._agg_txn(r_ne, r_txn, txn_cap)


def _sharded_step(lo, hi, active, state, batch, do_major, *, allowed, txn_cap,
                  rr_cap, wr_cap, h_cap, d_cap, on_sync, witness, search,
                  search_stride):
    """One batch over every shard: decide every shard (a masked one
    included: its iteration count enters iters, as the reference's
    shard_map runs every body), combine the undecided counts and, with
    `witness`, the witness over the ACTIVE shards (`active` on the device,
    `allowed` its host copy), commit each active shard against the
    combined count.  The stacked `state` tensors are updated IN PLACE,
    shard slice by slice, which keeps one copy of the history on the
    device.  Returns (undecided, iters, statuses [S, txn_cap]) + (w_ver,
    w_rng) with `witness`."""
    tiered = len(state) == 8
    (r_begin, r_end, r_txn, r_snap, w_begin, w_end, w_txn, t_snap, t_valid,
     now_rel, new_oldest_rel) = batch
    caps = dict(txn_cap=txn_cap, rr_cap=rr_cap, wr_cap=wr_cap, h_cap=h_cap)
    srch = dict(search=search, search_stride=search_stride)
    if tiered:
        hkeys, hvers, hcount, maxtab, dkeys, dvers, dcount, oldest = state
    else:
        hkeys, hvers, hcount, oldest = state
    decs = []
    for s in range(lo.shape[0]):
        rb, re_, wb, we, t_has_reads = _clip_batch(
            lo[s], hi[s], r_begin, r_end, r_txn, w_begin, w_end, txn_cap)
        shard_batch = (rb, re_, r_txn, r_snap, wb, we, w_txn, t_snap, t_has_reads,
                       t_valid, now_rel)
        if tiered:
            decs.append(et.decide_tiered(
                hkeys[s], maxtab[s], dkeys[s], dvers[s], oldest[s], *shard_batch,
                d_cap=d_cap, on_sync=on_sync, witness=witness, **caps))
        else:
            decs.append(et.decide_flat(
                hkeys[s], hvers[s], oldest[s], *shard_batch, on_sync=on_sync,
                witness=witness, **caps))
    undecided = torch.where(active, torch.stack([d.undecided for d in decs]), 0).sum().to(I32)
    iters = torch.stack([d.iters for d in decs]).max()
    wit = ()
    if witness:
        # Witness combine over the active shards.
        w_rng = torch.stack([d.w_rng for d in decs])
        w_ver = torch.stack([d.w_ver for d in decs])
        rng = torch.where(active[:, None], w_rng, et.WITNESS_NONE_RANGE).amin(0)
        ver = torch.where(active[:, None] & (w_rng == rng), w_ver, FLOOR_REL).amax(0)
        wit = (ver.to(I32), rng.to(I32))
    for s in range(lo.shape[0]):
        if not allowed[s]:
            continue  # a masked shard keeps its slice
        views = tuple(t[s] for t in state)
        if tiered:
            new = et.commit_tiered(*views, decs[s], now_rel, new_oldest_rel, undecided,
                                   do_major=bool(do_major), h_cap=h_cap,
                                   d_cap=d_cap, wr_cap=wr_cap, **srch)
        else:
            new = et.commit_flat(*views, decs[s], now_rel, new_oldest_rel, undecided,
                                 h_cap=h_cap, wr_cap=wr_cap, **srch)
        for view, t in zip(views, new):
            if t is not view:
                view.copy_(t)
    return (undecided, iters.to(I32), torch.stack([d.status for d in decs])) + wit


def sharded_step(lo, hi, active, hkeys, hvers, hcount, oldest,
                 r_begin, r_end, r_txn, r_snap, w_begin, w_end, w_txn,
                 t_snap, t_valid, now_rel, new_oldest_rel, *, allowed,
                 txn_cap, rr_cap, wr_cap, h_cap, on_sync=None, witness=True,
                 search="", search_stride=512):
    """The flat sharded step (the reference's sharded_step_kernels, one
    device): the batch's fields are unpacked on the device, every state
    tensor is stacked [S, ...] and updated in place.  See _sharded_step."""
    return _sharded_step(
        lo, hi, active, (hkeys, hvers, hcount, oldest),
        (r_begin, r_end, r_txn, r_snap, w_begin, w_end, w_txn, t_snap, t_valid,
         now_rel, new_oldest_rel), 0, allowed=allowed, txn_cap=txn_cap, rr_cap=rr_cap,
        wr_cap=wr_cap, h_cap=h_cap, d_cap=0, on_sync=on_sync, witness=witness,
        search=search, search_stride=search_stride)


def sharded_step_tiered(lo, hi, active, hkeys, hvers, hcount, maxtab, dkeys, dvers,
                        dcount, oldest, r_begin, r_end, r_txn, r_snap, w_begin,
                        w_end, w_txn, t_snap, t_valid, now_rel, new_oldest_rel,
                        do_major, *, allowed, txn_cap, rr_cap, wr_cap, h_cap, d_cap,
                        on_sync=None, witness=True, search="", search_stride=512):
    """The tiered sharded step (the reference's sharded_step_tiered):
    ``do_major`` is the host's compaction flag.  See _sharded_step."""
    return _sharded_step(
        lo, hi, active, (hkeys, hvers, hcount, maxtab, dkeys, dvers, dcount, oldest),
        (r_begin, r_end, r_txn, r_snap, w_begin, w_end, w_txn, t_snap, t_valid,
         now_rel, new_oldest_rel), do_major, allowed=allowed, txn_cap=txn_cap,
        rr_cap=rr_cap, wr_cap=wr_cap, h_cap=h_cap, d_cap=d_cap, on_sync=on_sync,
        witness=witness, search=search, search_stride=search_stride)


def _translate_witness(wit, rmap):
    """Per-shard mirror witness ordinals (indices into the CLIPPED read
    list — _clip_txns_for drops empty clips) back to ordinals into the
    transaction's original read_ranges."""
    return [None if w is None else (w[0], rmap[t][w[1]]) for t, w in enumerate(wit)]


def _combine_witness(parts, statuses):
    """The witness combine rule on the host (mirror-served and mixed
    batches): minimum losing ordinal over the conflicting shards'
    contributions, version = maximum among that ordinal's holders — the
    device combine's rule."""
    out: list = []
    for t, st in enumerate(statuses):
        cands = [p[t] for p in parts if p[t] is not None]
        if int(st) != CONFLICT or not cands:
            out.append(None)
            continue
        rng = min(c[1] for c in cands)
        out.append((max(c[0] for c in cands if c[1] == rng), rng))
    return out


# Per-shard breaker instruments, all pre-created at construction: which
# shards fault must never change a snapshot's key set.
_BREAKER_COUNTERS = (
    "device_faults", "faults_dispatch", "faults_compile", "faults_grow",
    "faults_rebase", "faults_mirror", "faults_reshard", "breaker_opens",
    "breaker_probes", "breaker_closes", "degraded_batches", "rehydrates",
)


class ShardedTorchConflictSet:
    """Conflict set whose history is range-sharded along ``split_keys``
    (``len(split_keys) + 1`` shards; split_keys[s-1] is shard s's inclusive
    lower bound), with per-shard breakers, mirrors, degraded serving and
    probe rehydration (see the module docstring).

    The ConflictSet ABI of the reference's sharded set: detect /
    detect_packed / new_batch / clear, and backend_signal, device_metrics,
    mirror_check, consume_degraded, install_fault_injector, store_to /
    load_from.  Synchronous: every batch is read back before detect
    returns.  ``device=None`` means the GPU (construction raises without
    one); ``device="cpu"`` runs the kernels' plain twins.

    Registry counters equal the reference's; the port's own measures stay
    out of it: ``host_syncs`` counts blocking device-to-host reads, and the
    registry's wall namespace holds the host seconds of detect_packed's
    unpacking of the batch for the mirrors (``unpack_seconds``), the
    committed-write clip (``clip_seconds``), the mirror applies
    (``mirror_apply_seconds``) and the witness decode
    (``witness_decode_seconds``)."""

    # Short batches that must pass after a long-key pin before the device
    # takes authority back.
    AUTHORITY_HYSTERESIS = 8

    def __init__(
        self,
        split_keys: Sequence[bytes],
        key_words: int = 4,
        h_cap: int = 1 << 16,
        oldest_version: int = 0,
        device=None,
        devices: Optional[Sequence] = None,
        bucket_mins: tuple = (8, 8, 8),
        fault_injector=None,
        max_shards: Optional[int] = None,
        history: str = "flat",
        delta_cap: int = 0,
        evict_every: int = 1,
        witness: bool = True,
        search: str = "",
        search_stride: int = 512,
        max_device_key_bytes: int = MAX_DEVICE_KEY_BYTES,
    ):
        if devices is not None:
            distinct = {str(resolve_device(d)) for d in devices}
            if len(distinct) > 1:
                raise NotImplementedError(
                    "shards on several devices are not ported; the shards share one device"
                )
            device = next(iter(devices))
        if history not in ("flat", "tiered"):
            raise ValueError(f"unknown history mode {history!r}")
        if evict_every < 1:
            raise ValueError(f"evict_every must be at least 1, got {evict_every}")
        if history == "flat" and evict_every > 1:
            raise ValueError("evict_every > 1 (amortized eviction) is supported "
                             "only with history='tiered'")
        check_search(search, search_stride)
        self.search, self.search_stride = search, search_stride
        self.device = resolve_device(device)
        self.n_shards = len(split_keys) + 1
        self.max_shards = max(self.n_shards, int(max_shards or self.n_shards))
        self.key_words = key_words
        self.max_device_key_bytes = max_device_key_bytes
        self.h_cap = h_cap
        self._base = oldest_version
        self.bucket_mins = bucket_mins
        self.split_keys = [bytes(k) for k in split_keys]
        self._lo, self._hi = self._partition_tensors(self.split_keys)
        # Step shape keys seen since the last grow: a key's first sight is
        # the reference's compile, and the `compile` fault site.
        self._steps: set = set()
        self.tiered = history == "tiered"
        self._witness = witness
        # Per-txn (absolute version, read-range ordinal) or None for the
        # most recent decided batch; [] when witness is off.
        self.last_witness: list = []
        self._last_witness_dev = None
        self.compact_every = evict_every if self.tiered and evict_every > 1 else 0
        self.d_cap = max(64, delta_cap if delta_cap > 0 else h_cap // 8) if self.tiered else 0
        self._batches_since_major = 0
        self.metrics = MetricsRegistry("ShardedConflict")
        for name in ("batches", "transactions", "device_batches", "retraces",
                     "grows", "rebases", "cpu_fallbacks", "cpu_fallback_txns",
                     "degraded_shard_serves", "long_key_pins",
                     "rehydrate_keys_total", "rehydrate_keys_encoded",
                     "mirror_sync_keys_encoded", "mirror_checks",
                     "mirror_divergence", "mirror_mismatch_keys",
                     "reshards", "reshard_moved_shards", "reshard_deferred",
                     "reshard_degraded"):
            self.metrics.counter(name)
        if self.tiered:
            self.metrics.counter("major_compactions")
        self._breakers: List[DeviceCircuitBreaker] = []
        for s in range(self.max_shards):
            prefix = f"shard{s}_"
            for name in _BREAKER_COUNTERS:
                self.metrics.counter(prefix + name)
            self._breakers.append(DeviceCircuitBreaker(
                metrics=self.metrics, label=f"shard{s}", counter_prefix=prefix))
        self._mirrors = [CpuConflictSet(oldest_version, key_words=key_words)
                         for _ in range(self.n_shards)]
        self._stale = [False] * self.n_shards
        self._synced_stamp: list = [m.stamp for m in self._mirrors]
        self._pinned = False
        self._short_streak = 0
        self._degraded_last = False
        self._cpu_fallback_txns = 0
        self._cpu_fallback_recent = deque(maxlen=32)  # (txns, wall seconds)
        self._last_mirror_check: Optional[dict] = None
        self.fault_injector = fault_injector
        # One entry per reshard call: committed, deferred or a no-op.
        self.move_log: list = []
        self.host_syncs = 0
        self._ring: dict = {}
        # Active-shard masks on the device, by pattern: made once, so a
        # batch uploads no mask (a pageable copy would wait for the device).
        self._masks: dict = {}
        self._init_state(oldest_rel=0)
        self.last_iters = 0

    def _partition_tensors(self, split_keys: list):
        """Per-shard [lo, hi) bounds [S, kw1] in the device word encoding;
        the last shard's hi is the INF key."""
        kw1 = self.key_words + 1
        S = len(split_keys) + 1
        lo = np.zeros((S, kw1), np.uint32)
        hi = np.full((S, kw1), keylib.INF_WORD, np.uint32)
        if split_keys:
            enc = keylib.encode_keys(list(split_keys), self.key_words)
            lo[1:] = enc
            hi[:-1] = enc
        return tuple(torch.from_numpy(keylib.to_device_words(x).copy()).to(self.device)
                     for x in (lo, hi))

    @property
    def _cpu_engines(self):
        """The per-shard mirrors while the long-key pin holds authority,
        else None."""
        return self._mirrors if self._pinned else None

    # -- state --
    def _init_state(self, oldest_rel: int):
        S, kw1, H, dev = self.n_shards, self.key_words + 1, self.h_cap, self.device
        # A reshard to a new shard count re-stacks the state: drop the old
        # tensors first, so that the two never hold the device at once.
        self._hkeys = self._hvers = self._maxtab = self._dkeys = self._dvers = None
        self._hkeys = torch.full((S, kw1, H), keylib.INF_DEV, dtype=I32, device=dev)
        self._hkeys[:, :, 0] = keylib.ZERO_DEV  # the b"" floor boundary
        self._hvers = torch.full((S, H), FLOOR_REL, dtype=I32, device=dev)
        self._hcount = torch.ones((S,), dtype=I32, device=dev)
        self._oldest = torch.full((S,), oldest_rel, dtype=I32, device=dev)
        # Host copies of the counts and windows: exact after every batch's
        # readback, so the growth and compaction plans read true counts
        # without a sync of their own.
        self._hcount_host = np.ones(S, np.int64)
        self._oldest_host = np.full(S, oldest_rel, np.int64)
        self._dcount_host = np.zeros(S, np.int64)
        if self.tiered:
            table = torch.from_numpy(build_max_table_np(np.full(H, FLOOR_REL, np.int32)))
            self._maxtab = table.to(dev)[None].repeat(S, 1, 1)
            self._dkeys = torch.full((S, kw1, self.d_cap), keylib.INF_DEV, dtype=I32,
                                     device=dev)
            self._dkeys[:, :, 0] = keylib.ZERO_DEV
            self._dvers = torch.full((S, self.d_cap), FLOOR_REL, dtype=I32, device=dev)
            self._dcount = torch.ones((S,), dtype=I32, device=dev)
            self._dcount_host = np.ones(S, np.int64)
        self._batches_since_major = 0

    @property
    def oldest_version(self) -> int:
        # The mirrors are always authoritative (stale slices lag).
        return max(m.oldest_version for m in self._mirrors)

    @property
    def boundary_count(self) -> int:
        return sum(m.boundary_count for m in self._mirrors)

    def clear(self, version: int):
        self._base = version
        self._pinned = False
        self._short_streak = 0
        self._mirrors = [CpuConflictSet(version, key_words=self.key_words)
                         for _ in range(self.n_shards)]
        self._init_state(oldest_rel=0)
        # Cleared device state equals the cleared mirrors.  The breakers
        # are not reset: clearing data says nothing about device health.
        self._stale = [False] * self.n_shards
        self._synced_stamp = [m.stamp for m in self._mirrors]

    def _sanctioned_sync(self, op: str):
        """The scope of one blocking device-to-host read (`op` names it):
        counted in ``host_syncs``, inside ``g_hostguard.allowed()``.  The
        sharded set takes no transfer guard, as the reference's has none."""
        self.host_syncs += 1
        return g_hostguard.allowed()

    # -- fault plumbing --
    def install_fault_injector(self, injector) -> None:
        self.fault_injector = injector

    def consume_degraded(self) -> bool:
        """True iff the most recent batch had a shard served by its mirror
        because of a fault or an open breaker; reading resets the flag."""
        was, self._degraded_last = self._degraded_last, False
        return was

    def _check_fault(self, site: str, shard: int) -> None:
        if self.fault_injector is not None:
            self.fault_injector.check(site, shard=shard)

    def _shard_fault(self, s: int, fault: DeviceFault) -> None:
        """A fault of shard s: only its breaker records it and only its
        slice goes stale."""
        self._breakers[s].on_failure(fault)
        self._stale[s] = True

    def _check_sites(self, site: str, allowed: list) -> list:
        out = list(allowed)
        for s in range(self.n_shards):
            if not out[s]:
                continue
            try:
                self._check_fault(site, s)
            except DeviceFault as e:
                self._shard_fault(s, e)
                out[s] = False
        return out

    # -- maintenance --
    def _maybe_grow_or_rebase(self, now: int, wr_cap: int, allowed: list):
        if now - self._base > et.REBASE_THRESHOLD:
            d = int(self._oldest_host.min())
            if d > 0:
                allowed = self._check_sites("rebase", allowed)
                if any(allowed):
                    self.metrics.counter("rebases").add()
                    # A stale shard's slice shifts too: its logical state
                    # lives in its mirror (absolute versions).
                    self._hvers = torch.clamp(self._hvers - d, min=FLOOR_REL)
                    if self.tiered:
                        self._dvers = torch.clamp(self._dvers - d, min=FLOOR_REL)
                        self._maxtab = torch.clamp(self._maxtab - d, min=FLOOR_REL)
                    self._oldest = self._oldest - d
                    self._oldest_host -= d
                    self._base += d
        if self.tiered or not any(allowed):
            return allowed
        need = int(self._hcount_host.max()) + 2 * wr_cap + 2
        if need > self.h_cap:
            allowed = self._check_sites("grow", allowed)
            if any(allowed):
                self._grow(max(self.h_cap * 2, self.h_cap + 4 * wr_cap))
        return allowed

    def _plan_tiered_batch(self, wr_cap: int, allowed: list):
        """Compaction and growth plan of one tiered batch, shared by every
        shard and decided from the true counts (maxima over the shards):
        each shard receives at most the whole batch's writes.  Returns
        (do_major, allowed)."""
        add = 2 * wr_cap
        if 2 * add + 8 > self.d_cap:
            allowed = self._check_sites("grow", allowed)
            if not any(allowed):
                return 0, allowed
            self._grow_delta(et._next_pow2(2 * add + 8, self.d_cap * 2))
        dmax = int(self._dcount_host.max())
        if dmax + add + 2 > self.d_cap:
            allowed = self._check_sites("grow", allowed)
            if not any(allowed):
                return 0, allowed
            self._grow_delta(et._next_pow2(dmax + add + 2, self.d_cap * 2))
        do_major = 0
        if self.compact_every and self._batches_since_major + 1 >= self.compact_every:
            do_major = 1
        # Fill trigger: compact now if the batch after this one might not
        # fit, so no shard's merge ever truncates.
        if dmax + 2 * add + 2 > self.d_cap:
            do_major = 1
        if do_major:
            need = int(self._hcount_host.max()) + dmax + add + 2
            if need > self.h_cap:
                allowed = self._check_sites("grow", allowed)
                if not any(allowed):
                    return 0, allowed
                self._grow(max(self.h_cap * 2, et._next_pow2(need, self.h_cap)))
        return do_major, allowed

    def _grow(self, new_cap: int):
        self.metrics.counter("grows").add()
        pad = new_cap - self.h_cap
        S, kw1, dev = self.n_shards, self.key_words + 1, self.device
        self._hkeys = torch.cat([
            self._hkeys, torch.full((S, kw1, pad), keylib.INF_DEV, dtype=I32, device=dev)
        ], dim=2)
        self._hvers = torch.cat([
            self._hvers, torch.full((S, pad), FLOOR_REL, dtype=I32, device=dev)
        ], dim=1)
        self.h_cap = new_cap
        if self.tiered:
            # The carried table's level count follows h_cap: rebuild each
            # shard's from its grown versions.
            with self._sanctioned_sync("max table rebuild"):
                hv = self._hvers.cpu().numpy()
                self._maxtab = torch.from_numpy(
                    np.stack([build_max_table_np(hv[s]) for s in range(S)])).to(dev)
        self._steps.clear()

    def _grow_delta(self, new_cap: int):
        self.metrics.counter("grows").add()
        pad = new_cap - self.d_cap
        S, kw1, dev = self.n_shards, self.key_words + 1, self.device
        self._dkeys = torch.cat([
            self._dkeys, torch.full((S, kw1, pad), keylib.INF_DEV, dtype=I32, device=dev)
        ], dim=2)
        self._dvers = torch.cat([
            self._dvers, torch.full((S, pad), FLOOR_REL, dtype=I32, device=dev)
        ], dim=1)
        self.d_cap = new_cap
        self._steps.clear()

    def _step_key(self, pb):
        """The step's shape key, the one definition shared by _step_for and
        _serve's compile-site check."""
        return (pb.txn_cap, pb.rr_cap, pb.wr_cap, self.h_cap,
                self.d_cap if self.tiered else 0)

    def _step_for(self, pb) -> None:
        """Record a step shape; its first sight (again after every grow)
        counts a retrace, as the reference's compile does."""
        key = self._step_key(pb)
        if key not in self._steps:
            self.metrics.counter("retraces").add()
            self._steps.add(key)

    # -- per-shard mirrors --
    def _shard_bounds(self):
        """[(lo, hi_or_None)] per shard — the one definition."""
        return list(zip([b""] + self.split_keys, self.split_keys + [None]))

    @hot_path(bound="batch")
    def _clip_txns_for(self, txns, s: int, with_read_map: bool = False):
        """Shard s's view of the batch on the host: every range clipped to
        [lo_s, hi_s), empty clips dropped (TooOld then applies only where
        reads survive, as the device's mask).  With `with_read_map`, also
        each surviving read range's ORIGINAL ordinal, per txn."""
        lo, hi = self._shard_bounds()[s]
        out = []
        rmap: list = []
        for tr in txns:
            rr, wr = [], []
            rmap_t: list = []
            for i, (b, e) in enumerate(tr.read_ranges):
                cb = b if b >= lo else lo
                ce = e if hi is None or e <= hi else hi
                if cb < ce:
                    rr.append((cb, ce))
                    rmap_t.append(i)
            for (b, e) in tr.write_ranges:
                cb = b if b >= lo else lo
                ce = e if hi is None or e <= hi else hi
                if cb < ce:
                    wr.append((cb, ce))
            rmap.append(rmap_t)
            out.append(TransactionConflictInfo(
                read_snapshot=tr.read_snapshot, read_ranges=rr, write_ranges=wr))
        if with_read_map:
            return out, rmap
        return out

    @hot_path(bound="batch")
    def _committed_writes_per_shard(self, txns, rows, shards):
        """Per-shard clipped COMMITTED write ranges, judged by each shard's
        LOCAL verdict row; ranges go to shards by a bisect over the split
        points, O(ranges x spanned shards)."""
        split = self.split_keys
        last = self.n_shards - 1
        bounds = self._shard_bounds()
        per = {s: [] for s in shards}
        for i, tr in enumerate(txns):
            for (b, e) in tr.write_ranges:
                if b >= e:
                    continue
                s0 = bisect_right(split, b)
                s1 = bisect_left(split, e)
                for s in range(s0, min(s1, last) + 1):  # perfcheck: ignore[HOT004]: iterates spanned SHARDS (bounded by the shard count, not rows); each reads one verdict scalar
                    lst = per.get(s)
                    if lst is None or int(rows[s][i]) != COMMITTED:
                        continue
                    lo, hi = bounds[s]
                    cb = b if b >= lo else lo
                    ce = e if hi is None or e <= hi else hi
                    if cb < ce:
                        lst.append((cb, ce))
        return per

    def _apply_shard_writes(self, s, ranges, now, new_oldest_version):
        """Adopt a device-decided batch into shard s's mirror: its committed
        write union merged and its window advanced, as its detect would."""
        txn = ([TransactionConflictInfo(read_snapshot=0, write_ranges=ranges)]
               if ranges else [])
        self._mirrors[s].apply_batch(txn, [COMMITTED] if ranges else [], now,
                                     new_oldest_version)

    @hot_path(bound="chunks")
    def _note_synced_shard(self, s: int) -> None:
        """Record that shard s's slice now equals its mirror, encoding the
        chunks created this batch so that a later rehydration pays only
        for chunks created after a fault."""
        mir = self._mirrors[s]
        fresh, complete = mir.take_fresh_chunks()
        if mir.stamp == self._synced_stamp[s]:
            return
        candidates = fresh if complete else mir.snapshot().chunks
        encoded = 0
        for ch in candidates:
            cache = ch.enc
            if cache is None or self.key_words not in cache:
                try:
                    _ent, k = chunk_encoding(ch, self.key_words)
                except ValueError:
                    continue  # a dead long-key chunk from the hint
                encoded += k
        if encoded:
            self.metrics.counter("mirror_sync_keys_encoded").add(encoded)
        self._synced_stamp[s] = mir.stamp

    def _rehydrate_shard(self, s: int) -> None:
        """Rebuild shard s's slice from its mirror SNAPSHOT (the probe's
        recovery).  The `grow` site is checked before anything mutates."""
        self._check_fault("grow", s)
        m = self.metrics
        mir = self._mirrors[s]
        with begin_span("rehydrate", attrs={"shard": s}):
            snap = mir.snapshot()
            n = snap.boundary_count
            if n + 8 > self.h_cap:
                self._grow(et._next_pow2(n + 8, self.h_cap * 2))
            ents = []
            encoded = 0
            for ch in snap.chunks:
                ent, k = chunk_encoding(ch, self.key_words)
                ents.append(ent)
                encoded += k
            m.counter("rehydrate_keys_total").add(n)
            m.counter("rehydrate_keys_encoded").add(encoded)
            kw1 = self.key_words + 1
            hk = np.full((kw1, self.h_cap), keylib.INF_WORD, np.uint32)
            hv = np.full((self.h_cap,), FLOOR_REL, np.int32)
            keys_enc = np.concatenate([e[0] for e in ents], axis=0)
            vers_abs = np.concatenate([e[1] for e in ents])
            hk[:, :n] = keys_enc.T
            rel = np.clip(vers_abs - self._base, FLOOR_REL, 2**31 - 2)
            rel[vers_abs == FLOOR_VERSION] = FLOOR_REL
            hv[:n] = rel.astype(np.int32)
            oldest_rel = int(np.clip(snap.oldest_version - self._base, 0, 2**31 - 2))
            self._write_shard_slice(s, hk, hv, n, oldest_rel)
        self._breakers[s].note_rehydrate()
        self._stale[s] = False
        self._synced_stamp[s] = snap.stamp
        mir.take_fresh_chunks()  # everything just encoded: the backlog is moot

    def _write_shard_slice(self, s, hk, hv, count, oldest_rel):
        """Replace shard s's slice in place (uint32 keys hk [kw1, h_cap],
        int32 versions hv); in tiered mode the adopted state becomes the
        shard's base and its delta restarts empty."""
        dev = self.device
        self._hkeys[s].copy_(torch.from_numpy(keylib.to_device_words(hk)).to(dev))
        self._hvers[s].copy_(torch.from_numpy(hv).to(dev))
        self._hcount[s] = count
        self._oldest[s] = oldest_rel
        self._hcount_host[s] = count
        self._oldest_host[s] = oldest_rel
        if self.tiered:
            self._maxtab[s].copy_(torch.from_numpy(build_max_table_np(hv)).to(dev))
            self._dkeys[s].fill_(keylib.INF_DEV)
            self._dkeys[s, :, 0] = keylib.ZERO_DEV
            self._dvers[s].fill_(FLOOR_REL)
            self._dcount[s] = 1
            self._dcount_host[s] = 1

    # -- the ConflictSet ABI --
    def new_batch(self):
        """The Resolver's swap point: a ConflictBatch over this set."""
        return ConflictBatch(self)

    def _detect(self, txns, now, new_oldest_version) -> List[int]:
        return self.detect(txns, now, new_oldest_version)

    def detect(self, transactions: List[TransactionConflictInfo], now: int,
               new_oldest_version: int) -> List[int]:
        width = min(self.max_device_key_bytes, self.key_words * 4)
        batch_long = any(
            len(b) > width
            for t in transactions
            for rng in (t.read_ranges, t.write_ranges)
            for pair in rng
            for b in pair
        )
        if batch_long or self._pinned:
            if batch_long:
                from ..flow.testprobe import test_probe

                test_probe("sharded_long_key_fallback")
                if not self._pinned:
                    self.metrics.counter("long_key_pins").add()
                self._pinned = True
                self._short_streak = 0
            else:
                self._short_streak += 1
            return self._serve_pinned(transactions, now, new_oldest_version)
        mt, mr, mw = self.bucket_mins
        pb = et.PackedBatch.from_transactions(
            transactions, self.key_words, min_txn=mt, min_rr=mr, min_wr=mw)
        statuses = self.detect_packed(pb, now, new_oldest_version)
        return [int(s) for s in statuses[: len(transactions)]]

    def detect_packed(self, pb, now: int, new_oldest_version: int):
        """One packed batch; returns numpy statuses [txn_cap]."""
        t0 = wall_now()
        txns = et._unpack_transactions(pb)  # the mirrors take byte keys
        self.metrics.record_wall("unpack_seconds", wall_now() - t0)
        if self._pinned:
            # The mirrors hold the authoritative history during the pin.
            self._short_streak += 1
            out = np.full((pb.txn_cap,), COMMITTED, np.int32)
            res = self._serve_pinned(txns, now, new_oldest_version)
            out[: len(res)] = res
            return out
        return self._serve(txns, pb, now, new_oldest_version)

    def _serve_pinned(self, txns, now: int, new_oldest_version: int):
        """All-mirror serve during the long-key pin (routing, never a
        degraded serve), then the unpin check."""
        statuses = self._mirror_detect_all(txns, now, new_oldest_version)
        if self._short_streak >= self.AUTHORITY_HYSTERESIS and all(
            keylib.fits(m.keys, self.key_words) for m in self._mirrors
        ):
            self._pinned = False
            self._short_streak = 0
            # Each slice rehydrates from its mirror at its next device batch.
            self._stale = [True] * self.n_shards
        return statuses

    def _mirror_detect_all(self, txns, now: int, new_oldest_version: int):
        """A whole batch on the per-shard mirrors with the multi-resolver
        semantics: ranges clipped per shard, each shard commits on its
        LOCAL verdict, verdicts min-combined, witnesses combined."""
        verdicts = []
        parts = []
        for s in range(self.n_shards):
            clipped, rmap = self._clip_txns_for(txns, s, with_read_map=True)
            verdicts.append(self._mirrors[s].detect(clipped, now, new_oldest_version))
            if self._witness:
                parts.append(_translate_witness(self._mirrors[s].last_witness, rmap))
        combined = [min(v) for v in zip(*verdicts)] if txns else []
        if self._witness:
            self.last_witness = _combine_witness(parts, combined)
        return combined

    def _serve(self, txns, pb, now: int, new_oldest_version: int):
        """One short-key batch: the device for every shard whose breaker
        allows it (stale slices rehydrated first), the mirror for the rest
        — identical verdicts either way, and only a faulting shard's
        breaker walks."""
        S = self.n_shards
        m = self.metrics
        m.counter("batches").add()
        m.counter("transactions").add(pb.n_txn)
        allowed = [br.allows_device() for br in self._breakers[:S]]
        for s in range(S):
            if not allowed[s]:
                continue
            try:
                if self._stale[s]:
                    self._rehydrate_shard(s)
                self._check_fault("dispatch", s)
            except DeviceFault as e:
                self._shard_fault(s, e)
                allowed[s] = False
        do_major = 0
        if any(allowed):
            allowed = self._maybe_grow_or_rebase(now, pb.wr_cap, allowed)
        if self.tiered and any(allowed):
            do_major, allowed = self._plan_tiered_batch(pb.wr_cap, allowed)
        if any(allowed) and self._step_key(pb) not in self._steps:
            # A new shape's first step: the compile site, per active shard.
            allowed = self._check_sites("compile", allowed)
        rows: list = [None] * S
        if any(allowed):
            if self._device_serve(pb, now, new_oldest_version, allowed, do_major, rows):
                # Every active shard kept its state (the combined gate);
                # the whole batch re-decides on the mirrors, a by-design
                # re-decide — but shards already sick this batch are still
                # degraded serves.
                m.counter("cpu_fallbacks").add()
                sick = [s for s in range(S) if not allowed[s]]
                if sick:
                    m.counter("degraded_shard_serves").add(len(sick))
                    self._degraded_last = True
                for s in range(S):
                    if allowed[s]:
                        self._stale[s] = True
                out = np.full((pb.txn_cap,), COMMITTED, np.int32)
                res = self._mirror_detect_all(txns, now, new_oldest_version)
                out[: len(res)] = res
                return out
        mirror_shards = [s for s in range(S) if not allowed[s]]
        mirror_wit: list = []
        if mirror_shards:
            # Degraded serving, scoped to the sick shards: each re-runs only
            # its slice of the batch on its mirror.
            t0 = wall_now()
            for s in mirror_shards:
                row = np.full((pb.txn_cap,), COMMITTED, np.int32)
                clipped, rmap = self._clip_txns_for(txns, s, with_read_map=True)
                local = self._mirrors[s].detect(clipped, now, new_oldest_version)
                row[: len(local)] = local
                rows[s] = row
                if self._witness:
                    mirror_wit.append(_translate_witness(self._mirrors[s].last_witness, rmap))
            self._cpu_fallback_txns += len(txns)
            self._cpu_fallback_recent.append((len(txns), wall_now() - t0))
            m.counter("cpu_fallback_txns").add(len(txns))
            m.counter("degraded_shard_serves").add(len(mirror_shards))
            self._degraded_last = True
        device_shards = [s for s in range(S) if allowed[s]]
        if device_shards:
            with begin_span("apply", attrs={"version": now, "n_txn": pb.n_txn}):
                t0 = wall_now()
                per = self._committed_writes_per_shard(txns, rows, device_shards)
                t1 = wall_now()
                for s in device_shards:
                    self._apply_shard_writes(s, per[s], now, new_oldest_version)
                    self._note_synced_shard(s)
                m.record_wall("clip_seconds", t1 - t0)
                m.record_wall("mirror_apply_seconds", wall_now() - t1)
        combined = np.min(np.stack(rows, axis=0), axis=0).astype(np.int32)
        if self._witness:
            # The device's combined witness (over the active shards) joined
            # with each mirror-served shard's under the one combine rule.
            t0 = wall_now()
            parts = list(mirror_wit)
            if device_shards:
                wv, wr = self._last_witness_dev
                parts.append(et.decode_witness(pb, combined, wv, wr, self._base))
            self.last_witness = _combine_witness(
                parts, [int(v) for v in combined[: pb.n_txn]])
            m.record_wall("witness_decode_seconds", wall_now() - t0)
        return combined

    def _upload(self, pb, now: int, new_oldest_version: int) -> torch.Tensor:
        """The batch as one int32 blob on the device: one copy, from a
        pinned staging buffer on CUDA."""
        nwords = et.blob_words(pb)
        ring = self._ring.get(nwords)
        cuda = self.device.type == "cuda"
        if ring is None:
            ring = self._ring[nwords] = et._StagingRing(nwords, 2, cuda)
        slot = ring.pos
        ring.pos = (slot + 1) % len(ring.views)
        if cuda and not ring.events[slot].query():
            with self._sanctioned_sync("staging buffer"):
                ring.events[slot].synchronize()
        blob = et.fill_blob(ring.views[slot], pb, self._base, now, new_oldest_version, 1)
        if not cuda:
            return torch.from_numpy(blob.view(np.int32))
        blob_dev = ring.pinned[slot].to(self.device, non_blocking=True)
        ring.events[slot].record()
        return blob_dev

    def _device_serve(self, pb, now, new_oldest_version, allowed, do_major, rows) -> bool:
        """One batch on the device with the active-shard mask: decide every
        shard, combine, commit the active ones, one readback.  Fills `rows`
        with each active shard's local verdicts.  Returns True when the
        combined fixpoint diverged (every active shard then kept its
        state)."""
        m = self.metrics
        S, kw1 = self.n_shards, self.key_words + 1
        TXN = pb.txn_cap
        self._step_for(pb)
        (r_begin, r_end, r_txn, r_snap, w_begin, w_end, w_txn, t_snap, _t_has_reads,
         t_valid, now_rel, new_oldest_rel) = et._unpack_blob(
            self._upload(pb, now, new_oldest_version), TXN, pb.rr_cap, pb.wr_cap, kw1)
        act = self._masks.get(tuple(allowed))
        if act is None:
            act = self._masks[tuple(allowed)] = torch.tensor(allowed, device=self.device)
        batch = (r_begin, r_end, r_txn, r_snap, w_begin, w_end, w_txn, t_snap, t_valid,
                 now_rel, new_oldest_rel)
        caps = dict(allowed=allowed, txn_cap=TXN, rr_cap=pb.rr_cap, wr_cap=pb.wr_cap,
                    h_cap=self.h_cap, witness=self._witness, search=self.search,
                    search_stride=self.search_stride,
                    on_sync=partial(self._sanctioned_sync, "fixpoint check"))
        # The device span: every shard's step and the one readback.
        with begin_span("device", attrs={"version": now}):
            if self.tiered:
                undecided, iters, status, *wit = sharded_step_tiered(
                    self._lo, self._hi, act, self._hkeys, self._hvers, self._hcount,
                    self._maxtab, self._dkeys, self._dvers, self._dcount, self._oldest,
                    *batch, do_major, d_cap=self.d_cap, **caps)
            else:
                undecided, iters, status, *wit = sharded_step(
                    self._lo, self._hi, act, self._hkeys, self._hvers, self._hcount,
                    self._oldest, *batch, **caps)
            dcount = self._dcount if self.tiered else torch.zeros_like(self._hcount)
            # The head, the statuses and, with the witness on, its combined
            # vectors (w_ver, w_rng), in one readback.
            out = torch.cat([
                torch.stack([undecided, iters]), self._hcount, dcount, self._oldest,
                status.reshape(-1), *wit,
            ])
            with self._sanctioned_sync("readback"):
                arr = out.cpu().numpy()
        head = 2 + 3 * S
        self._hcount_host = arr[2 : 2 + S].astype(np.int64)
        self._dcount_host = arr[2 + S : 2 + 2 * S].astype(np.int64)
        self._oldest_host = arr[2 + 2 * S : head].astype(np.int64)
        self.last_iters = int(arr[1])
        statuses = arr[head : head + S * TXN].reshape(S, TXN)
        if self._witness:
            self._last_witness_dev = (arr[head + S * TXN : head + (S + 1) * TXN],
                                      arr[head + (S + 1) * TXN :])
        m.counter("device_batches").add()
        if self.tiered:
            if do_major:
                m.counter("major_compactions").add()
                self._batches_since_major = 0
            else:
                self._batches_since_major += 1
        if int(arr[0]) != 0:
            TraceEvent("ConflictFixpointDiverged", severity=30).detail(
                "n_txn", pb.n_txn).detail("sharded", True).log()
            return True
        for s in range(S):
            if allowed[s]:
                rows[s] = statuses[s]
                # Real verdicts: credit the shard's breaker (a probing
                # shard closes here).
                self._breakers[s].on_success()
        return False

    # -- robustness surfaces --
    def backend_signal(self) -> dict:
        """O(1) admission-control probe: the worst shard breaker state and
        how many shards are degraded, so a ratekeeper can contract the lane
        in proportion.  cpu_mirror_tps is wall-clock-derived (0.0 = nothing
        measured)."""
        order = {"ok": 0, "probing": 1, "degraded": 2}
        worst = "ok"
        degraded = 0
        for b in self._breakers[: self.n_shards]:
            if b.state != "ok":
                degraded += 1
            if order[b.state] > order[worst]:
                worst = b.state
        tps = 0.0
        wall = sum(w for _n, w in self._cpu_fallback_recent)
        if wall > 0.0:
            tps = sum(n for n, _w in self._cpu_fallback_recent) / wall
        return {
            "backend_state": worst,
            "cpu_mirror_tps": tps,
            "cpu_fallback_txns": self._cpu_fallback_txns,
            "mirror_divergence": int(self.metrics.counter("mirror_divergence").value),
            "shards_total": self.n_shards,
            "shards_degraded": degraded,
        }

    def device_metrics(self, now=None) -> dict:
        """Registry snapshot plus the per-shard breaker walks (every
        per-shard key pre-created, so the shape never depends on which
        shards faulted); a ``kernels`` block when the state is on CUDA."""
        snap = self.metrics.snapshot(now=now)
        snap["h_cap"] = self.h_cap
        sig = self.backend_signal()
        snap["backend_state"] = sig["backend_state"]
        snap["shards"] = {
            "total": self.n_shards,
            "max": self.max_shards,
            "degraded": sig["shards_degraded"],
            "states": [b.state for b in self._breakers[: self.n_shards]],
            "stale": [bool(x) for x in self._stale],
            "pinned": self._pinned,
            "split_keys": [k.hex() for k in self.split_keys],
            "occupancy": self.shard_occupancy(),
            "moves": len(self.move_log),
            "last_move": self.last_move,
        }
        snap["shard_breakers"] = {
            f"shard{s}": self._breakers[s].snapshot() for s in range(self.max_shards)
        }
        if self.device.type == "cuda":
            snap["kernels"] = {"enabled": True, "interpret": False}
        if self.tiered:
            snap["tiers"] = {
                "mode": "tiered",
                "d_cap": self.d_cap,
                "compact_every": self.compact_every,
                "batches_since_major": self._batches_since_major,
            }
        snap["mirror"] = {
            "engine": type(self._mirrors[0]).__name__,
            "chunks": sum(m.chunk_count for m in self._mirrors),
            "boundary_count": sum(m.boundary_count for m in self._mirrors),
            "last_check": self._last_mirror_check,
        }
        return snap

    def mirror_check(self) -> dict:
        """Per-shard consistency check: each SERVING shard's slice against
        its mirror.  A confirmed divergence opens only that shard's breaker
        and marks only its slice stale; stale and non-ok shards are
        skipped.  Tiered slices evict their base only at compactions, so
        there a mismatch counts only if the two histories also differ as
        the window sees them; the keys that differ only below it are the
        shard's ``below_window_keys``."""
        m = self.metrics
        shards_report: dict = {}
        if self._pinned:
            report = {"status": "skipped", "reason": "long_key_pin"}
            self._last_mirror_check = report
            return report
        host = None
        checked = 0
        diverged = 0
        for s in range(self.n_shards):
            if self._stale[s] or self._breakers[s].state != "ok":
                shards_report[f"shard{s}"] = {
                    "status": "skipped",
                    "reason": ("stale" if self._stale[s]
                               else f"breaker_{self._breakers[s].state}"),
                }
                continue
            if host is None:  # one readback, only if a shard serves
                host = self._host_state()
            m.counter("mirror_checks").add()
            checked += 1
            dk, dv = self._device_shard_state(s, *host)
            d_oldest = int(host[3][s]) + self._base
            mk, mv = self._mirrors[s].snapshot().to_flat()
            mismatch = 0
            if self._mirrors[s].oldest_version != d_oldest:
                mismatch += 1
            if mk != dk or mv != dv:
                mirror = dict(zip(mk, mv))
                device = dict(zip(dk, dv))
                for key in mirror.keys() | device.keys():
                    if mirror.get(key) != device.get(key):
                        mismatch += 1
            below_window = 0
            if (mismatch and self.tiered and self._mirrors[s].oldest_version == d_oldest
                    and _above_window(mk, mv, d_oldest) == _above_window(dk, dv, d_oldest)):
                below_window, mismatch = mismatch, 0
            if mismatch:
                diverged += 1
                m.counter("mirror_divergence").add()
                m.counter("mirror_mismatch_keys").add(mismatch)
                TraceEvent("MirrorDivergence", severity=40).detail(
                    "mismatch_keys", mismatch).detail("shard", s).detail(
                    "mirror_boundaries", len(mk)).detail("device_boundaries", len(dk)).log()
                breaker = self._breakers[s]
                breaker.on_divergence(f"mismatch_keys={mismatch}")
                maybe_trigger(
                    "mirror_divergence",
                    detail={"shard": s, "mismatch_keys": mismatch,
                            "mirror_boundaries": len(mk), "device_boundaries": len(dk)},
                    transitions=lambda b=breaker: [list(t) for t in b.transitions],
                    source=breaker.breaker_id,
                )
                self._stale[s] = True
                self._degraded_last = True
            shards_report[f"shard{s}"] = {
                "status": "diverged" if mismatch else "ok",
                "boundaries": len(mk),
                "device_boundaries": len(dk),
                "mismatch_keys": mismatch,
            }
            if self.tiered:
                shards_report[f"shard{s}"]["below_window_keys"] = below_window
        report = {
            "status": "diverged" if diverged else ("ok" if checked else "skipped"),
            "shards": shards_report,
        }
        self._last_mirror_check = report
        return report

    def _host_state(self) -> tuple:
        """The stacked state on the host, from one readback: (keys uint32
        [S, kw1, H], vers, counts, oldest, delta keys, delta vers, delta
        counts) — the delta entries None in flat mode."""
        with self._sanctioned_sync("export"):
            out = [keylib.from_device_words(self._hkeys.cpu().numpy()),
                   self._hvers.cpu().numpy(), self._hcount.cpu().numpy(),
                   self._oldest.cpu().numpy()]
        if self.tiered:
            out += [keylib.from_device_words(self._dkeys.cpu().numpy()),
                    self._dvers.cpu().numpy(), self._dcount.cpu().numpy()]
        else:
            out += [None, None, None]
        return tuple(out)

    def _device_shard_state(self, s, hkeys, hvers, counts, _olds, dkeys, dvers, dcounts):
        """Shard s's slice decoded to host (keys, absolute versions) — the
        delta folded over the base in tiered mode."""
        def absv(rel):
            rel = int(rel)
            return FLOOR_VERSION if rel == FLOOR_REL else rel + self._base

        n = int(counts[s])
        bkeys = keylib.decode_keys(np.ascontiguousarray(hkeys[s, :, :n].T), self.key_words)
        bvers = [absv(v) for v in hvers[s, :n]]
        if not self.tiered:
            return bkeys, bvers
        nd = int(dcounts[s])
        dks = keylib.decode_keys(np.ascontiguousarray(dkeys[s, :, :nd].T), self.key_words)
        return et.fold_delta_over_base(bkeys, bvers, dks, dvers[s, :nd], self._base)

    # -- host state exchange --
    def _flatten_engines_to(self, engines: list, cpu) -> None:
        """Per-shard engines -> one global step function: shard 0 gives its
        boundaries below hi_0; each later shard re-anchors at lo_s with its
        value there, then gives its boundaries strictly inside
        (lo_s, hi_s)."""
        keys: list = []
        vers: list = []
        for (lo, hi), eng in zip(self._shard_bounds(), engines):
            if lo == b"":
                i0 = 0
            else:
                keys.append(lo)
                vers.append(eng._value_at(lo))
                i0 = bisect_right(eng.keys, lo)
            i1 = len(eng.keys) if hi is None else bisect_left(eng.keys, hi)
            keys.extend(eng.keys[i0:i1])
            vers.extend(eng.vers[i0:i1])
        cpu.keys = keys
        cpu.vers = vers
        cpu.oldest_version = min(e.oldest_version for e in engines)

    def _split_flat_to_engines(self, cpu) -> list:
        """One global step function -> per-shard engines (the inverse of
        _flatten_engines_to)."""
        engines = []
        for lo, hi in self._shard_bounds():
            eng = CpuConflictSet(cpu.oldest_version, key_words=self.key_words)
            i0 = bisect_right(cpu.keys, lo)
            i1 = len(cpu.keys) if hi is None else bisect_left(cpu.keys, hi)
            eng.keys = [b""] + cpu.keys[i0:i1]
            eng.vers = [cpu._value_at(lo)] + cpu.vers[i0:i1]
            engines.append(eng)
        return engines

    def store_to(self, cpu) -> None:
        """Write the global history into a CPU engine (anything with
        assignable keys / vers / oldest_version).  The mirrors are the
        authoritative per-shard state, so the export never reads the device
        and is exact even mid-outage."""
        self._flatten_engines_to(self._mirrors, cpu)

    def load_from(self, cpu) -> None:
        """Adopt a global CPU state, scattered into the per-shard mirrors;
        each slice rehydrates from its mirror at its next device batch.  A
        state holding long keys installs as a mirror pin."""
        self._base = cpu.oldest_version
        self._mirrors = self._split_flat_to_engines(cpu)
        self._synced_stamp = [None] * self.n_shards
        self._short_streak = 0
        self._pinned = not keylib.fits(cpu.keys, self.key_words)
        self._stale = [True] * self.n_shards

    def shard_occupancy(self) -> list:
        """Per-shard mirror boundary counts (O(1) each, exact mid-outage)."""
        return [m.boundary_count for m in self._mirrors]

    @property
    def last_move(self) -> Optional[dict]:
        return self.move_log[-1] if self.move_log else None

    def balance_split_keys(self, n_shards: Optional[int] = None) -> list:
        """Quantile split points that equalize the mirrors' boundary counts
        over `n_shards` (default: the current count).  The candidates are
        the actual boundary keys of the global step function (store_to's
        flattening), read through the mirrors' columnar views, so an
        unchanged quantile reproduces an existing split point exactly and
        reshard keeps that shard's mirror.  Returns the current split keys
        when the history is too small to cut n ways."""
        n = self.n_shards if n_shards is None else int(n_shards)
        segs: list = []  # (key, None, 0, 1) | (None, engine, i0, count)
        total = 0
        for (lo, hi), eng in zip(self._shard_bounds(), self._mirrors):
            if lo == b"":
                i0 = 1  # the b"" floor boundary is not a cuttable key
            else:
                segs.append((lo, None, 0, 1))
                total += 1
                i0 = eng.boundary_locate(lo, "right")
            i1 = eng.boundary_count if hi is None else eng.boundary_locate(hi, "left")
            if i1 > i0:
                segs.append((None, eng, i0, i1 - i0))
                total += i1 - i0
        if total < n:
            return list(self.split_keys)
        out: list = []
        for j in range(1, n):
            g = (total * j) // n
            k = b""
            for key, eng, i0, c in segs:
                if g < c:
                    k = key if eng is None else eng.boundary_key_at(i0 + g)
                    break
                g -= c
            if k != b"" and (not out or k > out[-1]):
                out.append(k)
        if len(out) != n - 1:
            return list(self.split_keys)
        return out

    def reshard(self, new_split_keys: Sequence[bytes], reason: str = "manual") -> dict:
        """Re-partition the shards along `new_split_keys` between two
        batches and return the move-log entry appended.

        Every batch resolves against one whole partition, the old one up
        to the commit and the new one after, and the min-combine does not
        depend on the partition, so verdicts and witnesses are those of a
        single set across the move.  One immutable snapshot cut is taken
        per old mirror.  A new shard whose range is unchanged keeps the
        old mirror by identity; its slice and sync stamp are kept only
        when its index is the same and the shard count holds.  A moved
        range gets a mirror built by chunk handoff.  Every other shard goes
        stale and rehydrates from its mirror at its next device batch.  A
        change of shard count (up to ``max_shards``) re-stacks the device
        state at the new S.

        The ``reshard`` fault site is checked on every moved shard that
        exists, before anything mutates: a fault defers the whole move
        (``action: "deferred"``).  A moved shard whose breaker is not ok
        completes the move on its mirror (``"degraded_on_mirror"``)."""
        new = [bytes(k) for k in new_split_keys]
        n_new = len(new) + 1
        if not (all(new[i] < new[i + 1] for i in range(len(new) - 1))
                and all(k != b"" for k in new)):
            raise AssertionError("split keys must be strictly increasing and non-empty")
        if n_new > self.max_shards:
            raise AssertionError(
                f"{n_new} shards exceed max_shards={self.max_shards} "
                "(per-shard fault domains are pre-created at construction)")
        if not keylib.fits(new, self.key_words):
            raise ValueError(
                f"split keys must fit the device key width ({self.key_words * 4} bytes)")
        old = list(self.split_keys)
        m = self.metrics
        entry: dict = {
            "seq": len(self.move_log),
            "reason": reason,
            "from": [k.hex() for k in old],
            "to": [k.hex() for k in new],
            "shards": [len(old) + 1, n_new],
        }
        if new == old:
            entry["action"] = "noop"
            entry["moved"] = []
            self.move_log.append(entry)
            return entry
        old_bounds = self._shard_bounds()
        new_bounds = list(zip([b""] + new, new + [None]))
        scaling = n_new != self.n_shards
        moved = (list(range(max(self.n_shards, n_new))) if scaling
                 else [s for s in range(n_new) if old_bounds[s] != new_bounds[s]])
        entry["moved"] = moved
        for s in moved:
            if s >= self.n_shards:
                continue  # not materialized yet: nothing on the device to fault
            try:
                self._check_fault("reshard", s)
            except DeviceFault as e:
                self._shard_fault(s, e)
                m.counter("reshard_deferred").add()
                entry["action"] = "deferred"
                entry["fault_shard"] = s
                self.move_log.append(entry)
                TraceEvent("ShardReshardDeferred", severity=20).detail(
                    "shard", s).detail("reason", reason).log()
                return entry
        degraded = [s for s in moved if s < self.n_shards and self._breakers[s].state != "ok"]
        entry["action"] = "degraded_on_mirror" if degraded else "live"
        if degraded:
            entry["degraded_shards"] = degraded
            m.counter("reshard_degraded").add()
        snaps = [mir.snapshot() for mir in self._mirrors]
        chunk = self._mirrors[0].chunk_size
        by_bounds = {old_bounds[s]: s for s in range(self.n_shards)}
        new_mirrors: list = []
        new_stale: list = []
        new_synced: list = []
        reused = 0
        for s, (lo, hi) in enumerate(new_bounds):
            t = by_bounds.get((lo, hi))
            if t is not None:
                keep_slice = not scaling and t == s
                new_mirrors.append(self._mirrors[t])
                new_stale.append(bool(self._stale[t]) or not keep_slice)
                new_synced.append(self._synced_stamp[t] if keep_slice else None)
                reused += 1
                continue
            parts = []
            for t2, (olo, ohi) in enumerate(old_bounds):
                if hi is not None and olo >= hi:
                    break
                if ohi is not None and ohi <= lo:
                    continue
                plo = olo if olo > lo else lo
                if ohi is None:
                    phi = hi
                elif hi is None:
                    phi = ohi
                else:
                    phi = ohi if ohi < hi else hi
                parts.append((snaps[t2], plo, phi))
            oldest = max(p[0].oldest_version for p in parts)
            new_mirrors.append(engine_from_handoff(parts, oldest, chunk=chunk,
                                                   key_words=self.key_words))
            new_stale.append(True)
            new_synced.append(None)
        # The commit: the partition flips between batches.
        self.split_keys = new
        self._mirrors = new_mirrors
        self._stale = new_stale
        self._synced_stamp = new_synced
        self._lo, self._hi = self._partition_tensors(new)
        if scaling:
            # Fresh state at the new S, whose first step is a new shape (the
            # compile site fires again); every shard rehydrates from its
            # repartitioned mirror at its next device batch.
            self.n_shards = n_new
            self._steps.clear()
            self._init_state(oldest_rel=0)
        m.counter("reshards").add()
        m.counter("reshard_moved_shards").add(len(moved))
        entry["reused_mirrors"] = reused
        self.move_log.append(entry)
        instant("reshard", role="ShardedConflict",
                attrs={"seq": entry["seq"], "reason": reason, "moved": len(moved),
                       "shards": n_new})
        TraceEvent("ShardReshard", severity=20).detail("seq", entry["seq"]).detail(
            "reason", reason).detail("action", entry["action"]).detail(
            "moved", len(moved)).detail("shards", n_new).log()
        # A committed move freezes the telemetry window with the move log
        # (a deferred one is a fault: the breaker's capture has it).
        maybe_trigger(
            "reshard",
            detail={"seq": entry["seq"], "reason": reason, "action": entry["action"],
                    "moved": moved, "shards": n_new},
            transitions=lambda: [dict(e) for e in self.move_log],
            source="resharder",
        )
        return entry


# ---------------------------------------------------------------------------
# The sharded steps in the device program registry (conflict/programs.py),
# at the reference's canonical sharded shapes.
# ---------------------------------------------------------------------------

EP_SHARDS, EP_SHARD_H, EP_SHARD_D = 2, 2048, 256


def _ep_sharded_args(dev, tiered: bool):
    S, kw1 = EP_SHARDS, programs.EP_KW1
    cs = ShardedTorchConflictSet(uniform_int_split_keys(S, 1 << 16, 4), key_words=kw1 - 1,
                                 h_cap=EP_SHARD_H, device=dev,
                                 history="tiered" if tiered else "flat",
                                 delta_cap=EP_SHARD_D)
    pb = programs.ep_batch(kw1)
    blob = np.empty((et.blob_words(pb),), np.uint32)
    et.fill_blob(blob, pb, 0, 8, 0, 1)
    (r_begin, r_end, r_txn, r_snap, w_begin, w_end, w_txn, t_snap, _t_has_reads, t_valid,
     now_rel, new_oldest_rel) = et._unpack_blob(
        torch.from_numpy(blob.view(np.int32).copy()).to(dev), pb.txn_cap, pb.rr_cap,
        pb.wr_cap, kw1)
    state = (cs._hkeys, cs._hvers, cs._hcount)
    if tiered:
        state += (cs._maxtab, cs._dkeys, cs._dvers, cs._dcount)
    args = (cs._lo, cs._hi, torch.ones((S,), dtype=torch.bool, device=dev), *state,
            cs._oldest, r_begin, r_end, r_txn, r_snap, w_begin, w_end, w_txn, t_snap,
            t_valid, now_rel, new_oldest_rel)
    statics = dict(allowed=[True] * S, txn_cap=pb.txn_cap, rr_cap=pb.rr_cap,
                   wr_cap=pb.wr_cap, h_cap=EP_SHARD_H)
    if tiered:
        # The host's compaction flag, a Python int as the live path passes
        # it: a compaction batch.
        args += (1,)
        statics["d_cap"] = EP_SHARD_D
    return args, statics


def _ep_sharded_step_kernels(dev):
    args, statics = _ep_sharded_args(dev, tiered=False)
    return sharded_step, args, statics


def _ep_sharded_step_tiered(dev):
    args, statics = _ep_sharded_args(dev, tiered=True)
    return sharded_step_tiered, args, statics


_SHARDED_BATCH_ARGS = ("r_begin", "r_end", "r_txn", "r_snap", "w_begin", "w_end", "w_txn",
                       "t_snap", "t_valid", "now_rel", "new_oldest_rel")

_TXN, _RR, _WR, _BMIN = (programs.EP_TXN, programs.EP_RR, programs.EP_WR,
                         programs.EP_BUCKET_MIN)
_SHARDED_BUCKETS = {"txn_cap": (_TXN, _BMIN), "rr_cap": (_RR, _BMIN), "wr_cap": (_WR, _BMIN),
                    "h_cap": (EP_SHARD_H, 64)}
_SHARDED_CLASSES = (("H", EP_SHARD_H), ("P", 2 * (_RR + _WR)), ("batch", _TXN))

# Per-shard width bounds: the flat step's full-width merge at ONE shard's
# h_cap; wider work would touch every shard's rows at once.
et.register_entry_point(
    "sharded_step_kernels", _ep_sharded_step_kernels,
    arg_names=("lo", "hi", "active", "hkeys", "hvers", "hcount", "oldest")
    + _SHARDED_BATCH_ARGS,
    carried=("hkeys", "hvers", "hcount", "oldest"), pinned=("lo", "hi"), kernel=True,
    size_classes=_SHARDED_CLASSES, h_threshold=EP_SHARD_H, work_bound=EP_SHARD_H + 4 * _WR,
    bucket_dims=_SHARDED_BUCKETS)
et.register_entry_point(
    "sharded_step_tiered", _ep_sharded_step_tiered,
    arg_names=("lo", "hi", "active", "hkeys", "hvers", "hcount", "maxtab", "dkeys",
               "dvers", "dcount", "oldest") + _SHARDED_BATCH_ARGS + ("do_major",),
    carried=("hkeys", "hvers", "hcount", "maxtab", "dkeys", "dvers", "dcount", "oldest"),
    pinned=("lo", "hi"), kernel=True,
    size_classes=_SHARDED_CLASSES[:2] + (("D", EP_SHARD_D), ("batch", _TXN)),
    h_threshold=EP_SHARD_H, compaction_gated=True,
    work_bound=EP_SHARD_H + EP_SHARD_D + 4 * _WR,
    bucket_dims=dict(_SHARDED_BUCKETS, d_cap=(EP_SHARD_D, 64)))
