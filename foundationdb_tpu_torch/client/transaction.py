"""Client transaction API: the NativeAPI + ReadYourWrites rebuild (v1).

The port's own copy of the reference package's ``client/transaction.py``.
The reference's client knobs are module constants at the reference's
defaults (``LATENCY_SAMPLE_RATE``, ``KEY_SIZE_LIMIT``,
``VALUE_SIZE_LIMIT``, ``INITIAL_RETRY_DELAY``, ``MAX_RETRY_DELAY``,
``DUMMY_COMMIT_MAX_RETRIES``), and its FDB_TPU_WITNESS_RETRY switch (on
by default) is ``Database(witness_retry=True)``; ``witness_retry=False``
is the blind retry.  The dynamic mode (``info_var``, fed by
the cluster controller and the failure monitor's client) waits for the
control plane and raises NotImplementedError; a static ``SimCluster``
never reaches it.

Ref: fdbclient/NativeAPI.actor.cpp (getReadVersion :2770, getValue :1164,
getRange :1603, tryCommit :2361, retry loop onError) and
fdbclient/ReadYourWrites.actor.cpp (uncommitted-write overlay on reads).

RYW model: the transaction keeps its ordered mutation log; a read replays
the mutations affecting that key over the storage snapshot value — simpler
than the reference's versioned WriteMap treap but the same observable
semantics (including atomic-op stacks and set/clear ordering).  Reads add
read conflict ranges unless snapshot=True; every mutation adds its write
conflict range (ref: commitMutations adding ranges per mutation).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..conflict.types import Range
from ..flow.error import FdbError
from ..flow.future import Future, Promise
from ..rpc.network import SimProcess
from ..server.interfaces import (
    CommitTransactionRequest,
    GetKeyServersLocationsRequest,
    GetKeyValuesRequest,
    GetReadVersionRequest,
    GetValueRequest,
    ProxyInterface,
    StorageInterface,
    WatchValueRequest,
)
from ..utils import RangeMap
from .atomic import VALUE_SIZE_LIMIT, apply_atomic
from .types import (
    ATOMIC_TYPES,
    CommitTransactionRef,
    KeySelector,
    Mutation,
    MutationType,
    key_after,
)


# Reroute policy shared by every routed read (point, range, watch): on
# wrong_shard_server / broken_promise, invalidate the cached location, wait,
# re-resolve, retry (ref: the backoff in getValue/getRange wrong-shard paths).
MAX_REROUTE_ATTEMPTS = 60
REROUTE_DELAY = 0.01

# The reference's client knobs, at their defaults.
LATENCY_SAMPLE_RATE = 0.01
KEY_SIZE_LIMIT = 10_000
INITIAL_RETRY_DELAY = 0.01
MAX_RETRY_DELAY = 1.0
DUMMY_COMMIT_MAX_RETRIES = 120


class Database:
    """A handle bound to a client process + cluster interfaces (ref:
    Database/Cluster in NativeAPI.h).

    Static mode: fixed proxy/storage interfaces (SimCluster).  The dynamic
    mode (`info_var`, a ClientDBInfo the cluster controller maintains)
    raises NotImplementedError until the port has the control plane.

    `witness_retry` (on by default): a retry after a structured
    not_committed that carries a `retry_version` seeds its read version
    there and skips the backoff (see Transaction.on_error); off, every
    retry backs off and takes a fresh read version.

    The location cache (ref: getKeyLocation_internal
    NativeAPI.actor.cpp:1027) maps key ranges to storage teams, filled from
    the proxy's key-location service and invalidated on wrong_shard_server /
    broken_promise so reads re-route after shard moves and storage deaths."""

    def __init__(
        self,
        process: SimProcess,
        proxy: ProxyInterface = None,
        storage: StorageInterface = None,
        info_var=None,
        proxies: Optional[List[ProxyInterface]] = None,
        witness_retry: bool = True,
    ):
        if info_var is not None:
            raise NotImplementedError(
                "Database(info_var=...) is fed by the cluster controller and "
                "the failure monitor's client, which the port has not yet"
            )
        self.process = process
        self.witness_retry = witness_retry
        self._proxy = proxy
        self._proxies = list(proxies) if proxies else ([proxy] if proxy else [])
        self._proxy_rr: dict = {}
        self._storage = storage
        # range -> tuple(StorageInterface) | () unsharded | None unknown
        self._loc_cache = RangeMap(None)
        # Invalidations so far: only they reopen a gap in the cache.
        self._loc_invalidations = 0
        # Per-replica latency/failure model for read routing (ref:
        # QueueModel fdbrpc/QueueModel.h, fed by loadBalance).
        from ..rpc.loadbalance import QueueModel

        self.queue_model = QueueModel()
        # Endpoint liveness (ref: FailureMonitorClient): addr -> failed.
        # loadBalance orders dead replicas last so reads avoid them
        # WITHOUT eating a timeout.  Nothing feeds it until the port has
        # the failure monitor's client.
        self.failure_states: dict = {}
        # Per-flags GRV coalescing lanes (ref: readVersionBatcher,
        # NativeAPI.actor.cpp:2698): {flags: (pending promises, inflight)}.
        self._grv_lanes: dict = {}
        # Client-observed latency distributions, surfaced by status (ref:
        # the latency sample buckets in ClientDBInfo/Status).
        from ..metrics import ContinuousSample

        rng = process.network.loop.rng
        self.latency_samples = {
            "grv": ContinuousSample(rng),
            "commit": ContinuousSample(rng),
        }
        # Retries that skipped the GRV round-trip because a structured
        # not_committed carried a witness retry hint (witness_retry).
        self.witness_hint_retries = 0

    def _note_hint_retry(self) -> None:
        self.witness_hint_retries += 1

    def _sample_debug_id(self) -> Optional[str]:
        """A fresh debug id for the latency trace chain, or None when the
        transaction is not sampled (ref: debugTransaction sampling)."""
        rng = self.process.network.loop.rng
        if rng.random01() >= LATENCY_SAMPLE_RATE:
            return None
        return f"{rng.random_int(0, 1 << 62):015x}"

    # --- client-side GRV batching (ref: readVersionBatcher :2698) ---
    async def batched_read_version(self, flags: int) -> int:
        """Coalesce concurrent get_read_version calls: while one GRV
        request is in flight, later callers queue and are all answered by
        the NEXT single request — natural batching under load, zero added
        latency when idle (the reference's batcher has the same shape:
        requests accumulate behind the in-flight one)."""
        lane = self._grv_lanes.setdefault(flags, {"pending": [], "busy": False})
        p = Promise()
        lane["pending"].append(p)
        if not lane["busy"]:
            # Marked busy HERE, not inside the drain: spawn() only schedules,
            # so two same-tick callers would otherwise both observe idle and
            # launch duplicate in-flight GRV requests.
            lane["busy"] = True
            self.process.spawn(self._grv_drain(flags), "grv_batcher")
        return await p.future

    async def _grv_drain(self, flags: int):
        from ..flow.error import ActorCancelled
        from ..flow.trace import trace_batch

        loop = self.process.network.loop
        lane = self._grv_lanes[flags]
        try:
            # The lane dicts are per-flag singletons (setdefault once,
            # never replaced): the loop test re-reads the live channel.
            while lane["pending"]:
                batch, lane["pending"] = lane["pending"], []
                debug_id = self._sample_debug_id()
                from ..flow.spans import NULL_SPAN, begin_span

                gspan = (
                    begin_span("grv", role="client",
                               attrs={"debug_id": str(debug_id)})
                    if debug_id is not None
                    else NULL_SPAN
                )
                trace_batch(
                    "TransactionDebug",
                    "NativeAPI.getConsistentReadVersion.Before",
                    debug_id,
                )
                t0 = loop.now()
                try:
                    version = await self.pick_proxy(
                        "grv"
                    ).get_consistent_read_version.get_reply(
                        self.process,
                        GetReadVersionRequest(flags=flags, debug_id=debug_id),
                    )
                    self.latency_samples["grv"].add(loop.now() - t0)
                    gspan.end(attrs={"version": version})
                    trace_batch(
                        "TransactionDebug",
                        "NativeAPI.getConsistentReadVersion.After",
                        debug_id,
                    )
                    for p in batch:
                        p.send(version)
                except ActorCancelled:
                    raise  # process dying: waiters die with it
                except FdbError as e:
                    # Each waiter retries through its own on_error loop.
                    gspan.end(attrs={"error": e.name})
                    for p in batch:
                        p.send_error(FdbError(e.name))
                except Exception:  # noqa: BLE001
                    # A non-FdbError (e.g. no proxy during a failover
                    # window) must NOT strand the coalesced waiters in a
                    # silent hang — before batching, each caller saw its
                    # own exception.  Fail them retryably and keep
                    # draining.
                    gspan.end(attrs={"error": "broken_promise"})
                    for p in batch:
                        p.send_error(FdbError("broken_promise"))
        finally:
            lane["busy"] = False

    def is_failed(self, iface) -> bool:
        """Is the process behind this interface marked failed?  Keyed by
        any stream ref's endpoint address."""
        for f in vars(iface).values():
            ep = getattr(f, "endpoint", None)
            if ep is not None:
                return bool(self.failure_states.get(ep.address))
        return False

    def invalidate_location(self, begin: bytes, end: Optional[bytes] = None):
        self._loc_cache.set_range(begin, end or key_after(begin), None)
        self._loc_invalidations += 1

    async def get_locations(self, begin: bytes, end: bytes):
        """(b, e, team) entries covering [begin, end); team () = unsharded
        (use the default storage interface).  Refetches until every gap is
        filled — the proxy truncates replies at its limit, so a huge range
        may take several round trips (ref: the paged getKeyServersLocations
        in getRange, NativeAPI.actor.cpp:1603).

        Each round trip fills the first gap, so everything before it is
        known: the next search starts there (`lo`), which keeps a range of
        n cached pieces at O(n) instead of O(n) a round trip.  An
        invalidation by another actor during a round trip may reopen a gap
        before `lo`; the search then starts again at `begin`, so the
        requests are the reference's, which searches from `begin` every
        time."""
        lo = begin
        for _ in range(100):
            gap = next(
                ((b, e) for b, e, v in self._loc_cache.intersecting(lo, end)
                 if v is None),
                None,
            )
            if gap is None:
                return list(self._loc_cache.intersecting(begin, end))
            gb, ge = gap
            invalidations = self._loc_invalidations
            rep = await self.pick_proxy("loc").get_key_servers_locations.get_reply(
                self.process,
                GetKeyServersLocationsRequest(
                    begin=gb, end=end if ge is None else min(ge, end)
                ),
            )
            lo = gb if self._loc_invalidations == invalidations else begin
            if not rep.results:
                # Proxy has no entry (shouldn't happen: RangeMap is total);
                # treat as unsharded rather than spin.
                self._loc_cache.set_range(gb, ge if ge is not None else end, ())
                continue
            for b, e, ifaces in rep.results:
                self._loc_cache.set_range(b, e, tuple(ifaces))
        return list(self._loc_cache.intersecting(begin, end))

    async def storage_for_key(self, key: bytes, attempt: int = 0) -> StorageInterface:
        """Replica for a read; successive attempts rotate through the team
        (the minimal loadBalance, ref fdbrpc/LoadBalance.actor.h:159)."""
        locs = await self.get_locations(key, key_after(key))
        _b, _e, team = locs[0]
        if team:
            return team[attempt % len(team)]
        return self.storage

    @property
    def proxy(self) -> ProxyInterface:
        return self._proxy

    def pick_proxy(self, kind: str = "") -> ProxyInterface:
        """Round-robin across the generation's proxies (ref: the proxy
        load-balancing in getConsistentReadVersion / tryCommit via
        loadBalance over ProxyInfo).  A separate counter per call site
        (`kind`): one shared counter phase-locks with the fixed GRV+commit
        call pattern (2 picks/txn), pinning every commit to one proxy."""
        proxies = self._proxies
        if not proxies:
            return self.proxy
        self._proxy_rr[kind] = self._proxy_rr.get(kind, 0) + 1
        return proxies[self._proxy_rr[kind] % len(proxies)]

    @property
    def storage(self) -> StorageInterface:
        return self._storage

    def create_transaction(self) -> "Transaction":
        return Transaction(self)

    async def run(self, fn):
        """Retry loop (ref: the @fdb.transactional decorator / onError)."""
        tr = self.create_transaction()
        while True:
            try:
                result = await fn(tr)
                await tr.commit()
                return result
            except FdbError as e:
                await tr.on_error(e)


class Transaction:
    def __init__(self, db: Database):
        self.db = db
        self._read_version: Optional[int] = None
        self.mutations: List[Mutation] = []
        self.read_conflict_ranges: List[Range] = []
        self.write_conflict_ranges: List[Range] = []
        self.committed_version: Optional[int] = None
        self.options: dict = {}
        self._retries = 0
        self._watches: List[tuple] = []  # (key, value, Promise), armed at commit
        self._committing = False  # set at commit() entry, cleared by reset()
        self._wm_init()

    def _wm_init(self):
        """The WriteMap: mutation-index-keyed structures so RYW reads cost
        O(ops on the key + log) instead of scanning the whole mutation log
        (ref: ReadYourWrites' WriteMap, fdbclient/WriteMap.h).  Issue-time
        snapshots become an `upto` index — the structures are append-only,
        so 'the write map as of mutation i' is answerable at any time."""
        from ..server.storage import VersionedClears
        from ..utils.indexed_set import IndexedSet

        self._wm_key_ops: dict = {}  # key -> [mutation index] (non-clear ops)
        # Ordered key index (O(log n) insert/range — insort's O(n) list
        # shifts would punish descending-key write patterns).
        self._wm_keys = IndexedSet(self.db.process.network.loop.rng)
        self._wm_clears = VersionedClears()  # version = mutation index
        self._wm_stamps: List[tuple] = []  # (index, lo, hi) of SVK ranges

    def _append_mutation(self, m: Mutation):
        idx = len(self.mutations)
        self.mutations.append(m)
        if m.type == MutationType.CLEAR_RANGE:
            self._wm_clears.add(m.param1, m.param2, idx, 0)
        elif m.type == MutationType.SET_VERSIONSTAMPED_KEY:
            (lo, hi), = _stamp_ranges([m])
            self._wm_stamps.append((idx, lo, hi))
        else:
            ops = self._wm_key_ops.get(m.param1)
            if ops is None:
                self._wm_key_ops[m.param1] = [idx]
                self._wm_keys.set(m.param1, 1)
            else:
                ops.append(idx)

    # --- versions ---
    async def get_read_version(self) -> int:
        if self._read_version is None:
            from ..server.interfaces import (
                GRV_FLAG_LOCK_AWARE,
                GRV_FLAG_PRIORITY_BATCH,
            )

            flags = (
                GRV_FLAG_PRIORITY_BATCH
                if self.options.get("priority_batch")
                else 0
            ) | (GRV_FLAG_LOCK_AWARE if self.options.get("lock_aware") else 0)
            version = await self.db.batched_read_version(flags)
            # Re-check after the await: a concurrent get_read_version (or a
            # set_read_version) resolved while this one was suspended, and
            # overwriting it would split the transaction's reads across two
            # snapshot versions.  First resolution wins; everyone returns it.
            if self._read_version is None:
                self._read_version = version
        return self._read_version

    def set_read_version(self, version: int):
        self._read_version = version

    # --- local overlay (RYW) ---
    def _replay(
        self, key: bytes, base: Optional[bytes], upto: int
    ) -> Optional[bytes]:
        """The write map's view of `key` as of mutation index `upto` (the
        snapshot at the read's issue: a write issued while the storage read was in
        flight must not leak into the result — ref: RYW's WriteMap
        consulted when the read is issued, ReadYourWrites.actor.cpp
        readThrough; the WriteDuringRead workload checks exactly this).

        Semantics are identical to an in-order scan of mutations[:upto]:
        a pending SVK whose stamp range covers the key — or a pending SVV
        on the key — is unreadable EVEN IF a later clear masks it (the
        scan raised at the earlier op's position)."""
        for idx, lo, hi in self._wm_stamps:
            if idx < upto and lo <= key <= hi:
                raise FdbError("accessed_unreadable")
        c, _s = (
            self._wm_clears.latest_over(key, upto - 1)
            if upto > 0
            else (-1, -1)
        )
        val = None if c >= 0 else base
        for idx in self._wm_key_ops.get(key, ()):
            if idx >= upto:
                break
            m = self.mutations[idx]
            if m.type == MutationType.SET_VERSIONSTAMPED_VALUE:
                raise FdbError("accessed_unreadable")
            if idx < c:
                continue  # masked by the later clear
            if m.type == MutationType.SET_VALUE:
                val = m.param2
            elif m.type in ATOMIC_TYPES:
                val = apply_atomic(m.type, val, m.param2)
        return val

    def _touched_keys(self, begin: bytes, end: bytes, upto: int) -> List[bytes]:
        """Keys in [begin, end) with any pending non-clear op below `upto`
        (clear masking is _replay's business)."""
        return [
            k
            for k in self._wm_keys.keys_in(begin, end)
            if self._wm_key_ops[k][0] < upto
        ]

    def _check_usable(self):
        """Reads and writes on a transaction whose commit has started (and
        until reset/on_error) fail with used_during_commit (ref:
        ReadYourWritesTransaction's checkUsedDuringCommit,
        ReadYourWrites.actor.cpp)."""
        if self._committing:
            raise FdbError("used_during_commit")

    # --- reads ---
    async def _get_from_storage(self, key: bytes, version: int):
        """Routed point read: the replica team is ordered by the queue
        model and slow replies hedge to the runner-up (ref: loadBalance
        fdbrpc/LoadBalance.actor.h:159); wrong_shard_server invalidates the
        location cache and re-resolves (ref: getValue's handling,
        NativeAPI.actor.cpp:1164)."""
        from ..rpc.loadbalance import load_balance

        loop = self.db.process.network.loop
        last = FdbError("broken_promise")
        for attempt in range(MAX_REROUTE_ATTEMPTS):
            locs = await self.db.get_locations(key, key_after(key))
            # Entry value None (unresolved after the gap-fill cap) or ()
            # (unsharded) both fall back to the default storage.
            team = list(locs[0][2] or ()) or [self.db.storage]
            try:
                return await load_balance(
                    self.db.process,
                    self.db.queue_model,
                    team,
                    lambda iface: iface.get_value.get_reply(
                        self.db.process,
                        GetValueRequest(key=key, version=version),
                    ),
                    key_of=lambda iface: getattr(iface, "storage_id", "")
                    or id(iface),
                    failed=self.db.is_failed,
                )
            except FdbError as e:
                if e.name not in (
                    "wrong_shard_server",
                    "broken_promise",
                    "future_version",
                    "all_alternatives_failed",
                ):
                    raise
                if e.name == "future_version":
                    # The team is just behind its log — retry without
                    # invalidating (a location refetch would return the
                    # identical team and only load the proxy).
                    last = e
                    await loop.delay(REROUTE_DELAY)
                    continue
                last = e
                # Invalidate on broken_promise too: if the WHOLE cached team
                # is dead (healed away), only a location refetch recovers
                # (ref: re-resolving on all_alternatives_failed).
                self.db.invalidate_location(key)
                await loop.delay(REROUTE_DELAY)
        raise last

    async def get(self, key: bytes, snapshot: bool = False) -> Optional[bytes]:
        self._check_usable()
        self._check_legal_key(key)  # reads of \xff.. need the option too
        upto = len(self.mutations)  # issue-time RYW snapshot
        version = await self.get_read_version()
        reply = await self._get_from_storage(key, version)
        if not snapshot:
            self.add_read_conflict_range(key, key_after(key))
        return self._replay(key, reply.value, upto)

    async def get_range(
        self,
        begin: bytes,
        end: bytes,
        limit: int = 1 << 30,
        reverse: bool = False,
        snapshot: bool = False,
    ) -> List[Tuple[bytes, bytes]]:
        self._check_usable()
        self._check_legal_key(begin)
        if end > b"\xff" and not self.options.get("access_system_keys"):
            raise FdbError("key_outside_legal_range")
        upto = len(self.mutations)  # issue-time RYW snapshot
        # A scan intersecting any pending versionstamped-key stamp range is
        # unreadable as a whole (computed once per call, not per row; ref:
        # RYW's unreadable ranges for range reads).
        for idx_s, lo_s, hi_s in self._wm_stamps:
            if idx_s < upto and begin <= hi_s and lo_s < end:
                raise FdbError("accessed_unreadable")
        version = await self.get_read_version()
        out: List[Tuple[bytes, bytes]] = []
        loop = self.db.process.network.loop
        # Page through storage until `limit` MERGED rows exist or the range
        # is exhausted: local clears can mask base rows, so a single fetch of
        # `limit` rows may under-fill even though more matching keys exist
        # beyond the fetched extent (ref: RYW readThrough continuation).
        # Each page is clipped to one shard (ref: getRange's per-shard
        # iteration, NativeAPI.actor.cpp:1603).
        lo, hi = begin, end  # remaining un-scanned extent
        misroutes = 0
        while len(out) < limit and lo < hi:
            locs = await self.db.get_locations(lo, hi)
            if reverse:
                b, _e, team = locs[-1]
                req_lo, req_hi = max(b, lo), hi
            else:
                _b, e, team = locs[0]
                req_lo = lo
                req_hi = hi if e is None else min(e, hi)
            if team:
                # Rotate on misroutes, but prefer replicas the failure
                # monitor considers alive (ref: IFailureMonitor-aware pick).
                cand = [
                    team[(misroutes + j) % len(team)]
                    for j in range(len(team))
                ]
                iface = next(
                    (x for x in cand if not self.db.is_failed(x)), cand[0]
                )
            else:
                iface = self.db.storage
            try:
                reply = await iface.get_key_values.get_reply(
                    self.db.process,
                    GetKeyValuesRequest(
                        begin=req_lo,
                        end=req_hi,
                        version=version,
                        limit=limit - len(out),
                        reverse=reverse,
                    ),
                )
            except FdbError as e:
                if e.name not in (
                    "wrong_shard_server",
                    "broken_promise",
                    "future_version",
                ):
                    raise
                misroutes += 1
                if misroutes > MAX_REROUTE_ATTEMPTS:
                    raise
                self.db.invalidate_location(req_lo, req_hi)
                await loop.delay(REROUTE_DELAY)
                continue
            base = dict(reply.data)
            if reply.more:
                # Covered extent ends at the last base row fetched; continue
                # from there next page.
                if reverse:
                    cov_lo, cov_hi = reply.data[-1][0], req_hi
                    hi = cov_lo
                else:
                    cov_lo, cov_hi = req_lo, key_after(reply.data[-1][0])
                    lo = cov_hi
            else:
                cov_lo, cov_hi = req_lo, req_hi
                if reverse:
                    hi = req_lo
                else:
                    lo = req_hi
            merged = set(base)
            merged.update(self._touched_keys(cov_lo, cov_hi, upto))
            for k in sorted(merged, reverse=reverse):
                v = self._replay(k, base.get(k), upto)
                if v is not None:
                    out.append((k, v))
                    if len(out) >= limit:
                        break
        if not snapshot:
            # Conflict range covers only what was actually observed: when the
            # limit truncated the scan, trim to the returned extent (ref: RYW
            # readThrough trimming on limited reads).
            if len(out) >= limit and out:
                if reverse:
                    self.add_read_conflict_range(out[-1][0], end)
                else:
                    self.add_read_conflict_range(begin, key_after(out[-1][0]))
            else:
                self.add_read_conflict_range(begin, end)
        return out

    async def get_key(self, selector: KeySelector, snapshot: bool = False) -> bytes:
        """Resolve a KeySelector to a key (ref: Transaction::getKey; storage
        getKeyQ).  Resolution: index into the sorted key list at
        (first key {>|>=} sel.key) + offset - 1; before-the-front resolves
        to b"" and past-the-end to b"\\xff" (allKeys end), like the ref."""
        start = key_after(selector.key) if selector.or_equal else selector.key
        if selector.offset >= 1:
            rows = await self.get_range(
                start, b"\xff", limit=selector.offset, snapshot=snapshot
            )
            if len(rows) >= selector.offset:
                return rows[selector.offset - 1][0]
            return b"\xff"
        back = 1 - selector.offset
        rows = await self.get_range(
            b"", start, limit=back, reverse=True, snapshot=snapshot
        )
        if len(rows) >= back:
            return rows[back - 1][0]
        return b""

    # --- writes ---
    def set(self, key: bytes, value: bytes):
        self._check_usable()
        self._check_size(key, value)
        self._append_mutation(Mutation(MutationType.SET_VALUE, key, value))
        self.add_write_conflict_range(key, key_after(key))

    def clear(self, key: bytes):
        self._check_usable()
        self._check_legal_key(key)
        self._append_mutation(
            Mutation(MutationType.CLEAR_RANGE, key, key_after(key))
        )
        self.add_write_conflict_range(key, key_after(key))

    def clear_range(self, begin: bytes, end: bytes):
        self._check_usable()
        if begin > end:
            raise FdbError("inverted_range")
        self._check_legal_key(begin)
        if end > b"\xff" and not self.options.get("access_system_keys"):
            raise FdbError("key_outside_legal_range")
        self._append_mutation(Mutation(MutationType.CLEAR_RANGE, begin, end))
        self.add_write_conflict_range(begin, end)

    def atomic_op(self, op: MutationType, key: bytes, operand: bytes):
        self._check_usable()
        assert op in ATOMIC_TYPES, op
        self._check_size(key, operand)
        if op == MutationType.SET_VERSIONSTAMPED_KEY:
            from .atomic import validate_versionstamp_param

            validate_versionstamp_param(key)
            # The stamped key is unknown until commit; conflict on the whole
            # possible stamp range (ref: getVersionstampKeyRange :226).
            # Same computation as the RYW-unreadable check, by construction.
            m = Mutation(op, key, operand)
            self._append_mutation(m)  # records the stamp range once
            _idx, lo, hi = self._wm_stamps[-1]
            self.add_write_conflict_range(lo, key_after(hi))
            return
        if op == MutationType.SET_VERSIONSTAMPED_VALUE:
            from .atomic import validate_versionstamp_param

            validate_versionstamp_param(operand)
        self._append_mutation(Mutation(op, key, operand))
        self.add_write_conflict_range(key, key_after(key))

    def _check_size(self, key: bytes, value: bytes):
        if len(key) > KEY_SIZE_LIMIT:
            raise FdbError("key_too_large")
        if len(value) > VALUE_SIZE_LIMIT:
            raise FdbError("value_too_large")
        self._check_legal_key(key)

    def _check_legal_key(self, key: bytes):
        """Clients may not touch the system keyspace (ref: keys >= \\xff are
        illegal without ACCESS_SYSTEM_KEYS; fdbclient key_outside_legal_range)."""
        if key >= b"\xff" and not self.options.get("access_system_keys"):
            raise FdbError("key_outside_legal_range")

    # --- watches (ref: Transaction::watch + commitAndWatch NativeAPI:2544) ---
    async def watch(self, key: bytes) -> Future:
        """Future that fires when `key`'s value changes from what this
        transaction observes.  Registered only after a successful commit
        (read-only transactions register at the read version); the watch
        re-arms itself across storage failures."""
        self._check_legal_key(key)
        value = await self.get(key, snapshot=True)
        p = Promise()
        self._watches.append((key, value, p))
        return p.future

    async def _arm_watch(self, key: bytes, value, promise: Promise, version: int):
        while True:
            try:
                iface = await self.db.storage_for_key(key)
                fired = await iface.watch_value.get_reply(
                    self.db.process, WatchValueRequest(key, value, version)
                )
                if not promise.is_set():
                    promise.send(fired)
                return
            except FdbError as e:
                if e.name == "wrong_shard_server":
                    # Shard moved: re-route and re-register.
                    self.db.invalidate_location(key)
                elif e.name not in ("broken_promise", "transaction_too_old"):
                    if not promise.is_set():
                        promise.send_error(e)
                    return
                # Storage moved/restarted: re-register against the current
                # value; if it changed while we were down, fire.
                await self.db.process.network.loop.delay(0.1)
                tr = self.db.create_transaction()
                try:
                    now_val = await tr.get(key, snapshot=True)
                except FdbError:
                    continue
                if now_val != value:
                    if not promise.is_set():
                        promise.send(tr._read_version)
                    return
                version = tr._read_version

    # --- conflict ranges ---
    def add_read_conflict_range(self, begin: bytes, end: bytes):
        if begin < end:
            self.read_conflict_ranges.append((begin, end))

    def add_write_conflict_range(self, begin: bytes, end: bytes):
        if begin < end:
            self.write_conflict_ranges.append((begin, end))

    # --- commit ---
    async def commit(self) -> Optional[int]:
        self._check_usable()
        self._committing = True
        if not self.mutations and not self.write_conflict_ranges:
            self.committed_version = self._read_version
            self._launch_watches(self._read_version or 0)
            return self.committed_version  # read-only: nothing to do
        read = _coalesce(self.read_conflict_ranges)
        write = _coalesce(self.write_conflict_ranges)
        # Self-conflict guarantee (ref: makeSelfConflicting NativeAPI:2052,
        # applied at :2505 unless causalWriteRisky): ensure read∩write is
        # non-empty so a commit_unknown_result can later be resolved by a
        # dummy transaction over a key in the intersection.
        if not self.options.get("causal_write_risky") and (
            _intersect_key(write, read) is None
        ):
            rng = self.db.process.network.loop.rng
            sc = b"\xff/SC/" + rng.random_int(0, 1 << 62).to_bytes(8, "big")
            r = (sc, key_after(sc))
            read = read + [r]
            write = write + [r]
        if read and self._read_version is None:
            # A blind write made self-conflicting still needs a snapshot to
            # resolve against (ref: the causal-read-risky getReadVersion for
            # commits without reads, NativeAPI:2497).
            await self.get_read_version()
        read_snapshot = (self._read_version if read else 0) or 0
        tref = CommitTransactionRef(
            read_snapshot=read_snapshot,
            read_conflict_ranges=read,
            write_conflict_ranges=write,
            mutations=list(self.mutations),
        )
        from ..flow.spans import NULL_SPAN, begin_span
        from ..flow.trace import trace_batch

        loop = self.db.process.network.loop
        debug_id = self.db._sample_debug_id()
        # Commit span: sampled transactions only — the same
        # volume bound as the trace_batch chain it sits beside.
        cspan = (
            begin_span("commit", role="client",
                       attrs={"debug_id": str(debug_id)})
            if debug_id is not None
            else NULL_SPAN
        )
        trace_batch("CommitDebug", "NativeAPI.commit.Before", debug_id)
        t0 = loop.now()
        from ..server.interfaces import COMMIT_FLAG_LOCK_AWARE

        commit_flags = (
            COMMIT_FLAG_LOCK_AWARE if self.options.get("lock_aware") else 0
        )
        try:
            version = await self.db.pick_proxy("commit").commit.get_reply(
                self.db.process,
                CommitTransactionRequest(
                    transaction=tref, flags=commit_flags, debug_id=debug_id
                ),
            )
        except FdbError as e:
            # Close the latency chain on the error path too: the
            # ratekeeper's CommitChainSampler ages OPEN chains as a
            # pipeline-stall signal, so a failed attempt must not
            # masquerade as a forever-wedged commit.
            cspan.end(attrs={"error": e.name})
            trace_batch("CommitDebug", "NativeAPI.commit.Error", debug_id)
            if e.name in ("commit_unknown_result", "broken_promise"):
                # The commit may still be in flight.  Before surfacing the
                # unknown result, commit a conflicting dummy transaction
                # over a key in the original's read∩write intersection: once
                # it commits, the original has either committed or will
                # forever conflict, so a retry observes definitive state
                # (ref: commitDummyTransaction NativeAPI:2315, invoked
                # :2430-2449).
                if not self.options.get("causal_write_risky"):
                    from ..flow.testprobe import test_probe

                    test_probe("commit_unknown_fence")
                    key = _intersect_key(write, read)
                    assert key is not None  # guaranteed by self-conflicting
                    await self._commit_dummy(key)
                raise FdbError("commit_unknown_result")
            raise
        self.db.latency_samples["commit"].add(loop.now() - t0)
        cspan.end(attrs={"version": version})
        trace_batch("CommitDebug", "NativeAPI.commit.After", debug_id)
        self.committed_version = version
        self._launch_watches(version)
        return version

    async def _commit_dummy(self, key: bytes):
        """Fence the in-flight original (ref commitDummyTransaction :2315).
        Retries ride the client's retry delays so the fence outlasts any
        recovery the adjacent on_error backoff would survive."""
        loop = self.db.process.network.loop
        for attempt in range(DUMMY_COMMIT_MAX_RETRIES):
            tr = Transaction(self.db)
            tr.options["causal_write_risky"] = True
            tr.options["access_system_keys"] = True
            # The fence must work under a database lock iff the original
            # could commit under it.
            if self.options.get("lock_aware"):
                tr.options["lock_aware"] = True
            tr.add_read_conflict_range(key, key_after(key))
            tr.add_write_conflict_range(key, key_after(key))
            try:
                # A conflict-ranges-only transaction must still traverse the
                # commit pipeline: give it a read snapshot so it can
                # conflict.  Inside the retry guard: the fence runs exactly
                # when the generation is dying, so the GRV itself may get
                # broken_promise.
                await tr.get_read_version()
                await tr.commit()
                return
            except FdbError as e:
                if not (
                    e.is_retryable_in_transaction()
                    or e.name == "broken_promise"
                ):
                    raise
                await loop.delay(
                    min(MAX_RETRY_DELAY, INITIAL_RETRY_DELAY * (2 ** min(attempt, 30)))
                )
        raise FdbError("commit_unknown_result")

    def _launch_watches(self, version: int):
        watches, self._watches = self._watches, []
        for key, value, promise in watches:
            self.db.process.spawn(
                self._arm_watch(key, value, promise, version), "watch"
            )

    async def on_error(self, e: FdbError):
        """Backoff + reset if retryable, else re-raise (ref: onError).

        Witness-guided retry: a structured not_committed
        carries the combined abort witness, including retry_version —
        the version the aborting batch resolved at, i.e. the newest
        snapshot at which the lost conflict is fully visible.  With
        Database(witness_retry=True), the next attempt seeds its read
        version there instead of paying a fresh GRV round-trip, and
        skips the blind backoff: the backoff exists because an
        UNINFORMED retry risks stampeding with the same stale view,
        but a hinted retry is guaranteed to observe the write that
        aborted us, so the livelock it guards against cannot recur
        (reference clients always back off and re-GRV; fdbserver
        returns only the bare error)."""
        if not (
            e.is_retryable_in_transaction() or e.name == "broken_promise"
        ):
            raise e
        hint = None
        if (
            e.name == "not_committed"
            and isinstance(e.detail, dict)
            and e.detail.get("retry_version") is not None
            and self.db.witness_retry
        ):
            hint = int(e.detail["retry_version"])
        delay = min(MAX_RETRY_DELAY, INITIAL_RETRY_DELAY * (2 ** min(self._retries, 30)))
        self._retries += 1
        if hint is None:
            await self.db.process.network.loop.delay(
                delay * self.db.process.network.loop.rng.random01()
            )
        self.reset()
        if hint is not None:
            self._read_version = hint
            self.db._note_hint_retry()

    def reset(self):
        self._read_version = None
        self._committing = False
        self.mutations = []
        self._wm_init()
        self.read_conflict_ranges = []
        self.write_conflict_ranges = []
        self.committed_version = None
        for _k, _v, promise in self._watches:
            if not promise.is_set():
                promise.send_error(FdbError("watch_cancelled"))
        self._watches = []


def _stamp_ranges(muts) -> List[Tuple[bytes, bytes]]:
    """[lo, hi] (inclusive) possible-key ranges of pending
    SET_VERSIONSTAMPED_KEY mutations (ref: getVersionstampKeyRange :226)."""
    out = []
    for m in muts:
        if m.type == MutationType.SET_VERSIONSTAMPED_KEY:
            pos = int.from_bytes(m.param1[-4:], "little", signed=True)
            body = m.param1[:-4]
            out.append(
                (
                    body[:pos] + b"\x00" * 10 + body[pos + 10 :],
                    body[:pos] + b"\xff" * 10 + body[pos + 10 :],
                )
            )
    return out


def _intersect_key(write: List[Range], read: List[Range]) -> Optional[bytes]:
    """A key inside some write∩read range overlap, or None (ref: the
    intersects() probe in tryCommit's commit_unknown_result handling,
    NativeAPI.actor.cpp:2440-2443)."""
    for wb, we in write:
        for rb, re_ in read:
            lo, hi = max(wb, rb), min(we, re_)
            if lo < hi:
                return lo
    return None


def _coalesce(ranges: List[Range]) -> List[Range]:
    """Merge overlapping/adjacent ranges (ref: the conflict-range coalescing
    in CommitTransactionRef construction)."""
    if len(ranges) <= 1:
        return list(ranges)
    s = sorted(ranges)
    out = [list(s[0])]
    for b, e in s[1:]:
        if b <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([b, e])
    return [(b, e) for b, e in out]


def transactional(fn):
    """`@transactional` (ref: the python binding's fdb.transactional,
    bindings/python/fdb/impl.py): the decorated coroutine's first
    argument may be a Database (a fresh transaction + the retry loop
    wraps the call) or a Transaction (the call joins the caller's
    transaction — no commit, no retry; composability is the point)."""
    import functools

    @functools.wraps(fn)
    async def wrapper(db_or_tr, *args, **kwargs):
        if isinstance(db_or_tr, Transaction):
            return await fn(db_or_tr, *args, **kwargs)
        return await db_or_tr.run(
            lambda tr: fn(tr, *args, **kwargs)
        )

    return wrapper
