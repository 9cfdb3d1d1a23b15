"""Storage server role: versioned MVCC reads over pulled log data.

The port's own copy of the reference package's ``server/storage.py``.
Without a base engine (``kvstore``) every version stays in the RAM window,
trimmed to the MVCC floor.  Over one (``recover`` opens it from the
machine's disk: "memory" or "btree"), applied mutations are folded into
the engine every STORAGE_DURABILITY_LAG seconds of virtual time, and the
window is trimmed and the log popped only behind that durable version.
The reference's knobs it reads are the module constants below, at the
reference's defaults.

Ref: storageserver.actor.cpp — VersionedData :236-260 (MVCC window),
getValueQ :684 / getKeyValues :1182 read path with waitForVersion :631;
update() pulls mutations from the log via peek and applies them in version
order; atomics are applied at the storage server exactly as the client
would (shared fdbclient/Atomic.h semantics -> client/atomic.py).

Sharding: `owned` maps the key ranges this server serves (ref: serverKeys).
Ownership changes ride the mutation stream itself — every storage intercepts
`\xff/keyServers/` mutations (the ApplyMetadataMutation analog,
fdbserver/ApplyMetadataMutation.h) so a shard handoff happens at an exact
commit version on every role that watches the stream.  A range being
fetched buffers its mutations until the snapshot arrives (ref: AddingShard,
storageserver.actor.cpp:85-133), then replays the tail and goes live when
the settling keyServers record lands.  Reads outside owned ranges fail with
wrong_shard_server (the client invalidates its location cache and retries);
reads below a fetched shard's snapshot version fail transaction_too_old
(ref: the shard's transferredVersion floor in fetchKeys).
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right, insort
from typing import Dict, List, Optional, Tuple

from ..client.atomic import apply_atomic
from ..client.types import Mutation, MutationType, key_after
from ..fileio.kvstore import open_engine
from ..flow.asyncvar import NotifiedVersion
from ..flow.error import FdbError
from ..rpc.network import SimProcess
from ..rpc.wire import decode_frame, encode_frame
from ..rpc.stream import RequestStream
from ..utils import RangeMap
from .interfaces import (
    TAG_ALL,
    TAG_DEFAULT,
    FetchShardReply,
    FetchShardRequest,
    GetKeyValuesReply,
    GetKeyValuesRequest,
    GetShardStateRequest,
    GetValueReply,
    GetValueRequest,
    StorageInterface,
    TLogInterface,
    TLogPeekRequest,
    TLogPopRequest,
    WatchValueRequest,
)

# User + system data lives in [b"", KEYSPACE_END); keys at or beyond it are
# per-engine metadata outside the replicated keyspace (ref: allKeys end
# \xff\xff, fdbclient/SystemData.cpp).
KEYSPACE_END = b"\xff\xff"

# The reference's server knobs (flow/knobs.py), at its defaults.
MAX_WATCHES = 10000
FETCH_SHARD_PAGE_ROWS = 5000
MAX_VERSIONS_IN_FLIGHT = 100_000_000
FUTURE_VERSION_DELAY = 1.0
MAX_WRITE_TRANSACTION_LIFE_VERSIONS = 5_000_000
STORAGE_DURABILITY_LAG = 0.05


class VersionedClears:
    """Versioned clear-range index: key-partitioned stamp lists.

    The key space is a partition (`bounds[i]` starts segment i); each
    segment carries the ascending (version, seq) stamps of every clear
    covering it.  A point query is two binary searches — segment by key,
    stamp by version — replacing the O(#clears) scan the flat list needed
    (the reference's PTree VersionedMap is versioned-ordered for the same
    reason, fdbclient/VersionedMap.h:43).  Inserting a clear splits at its
    endpoints and appends one stamp per covered segment; trim() drops
    expired stamps and coalesces equal neighbours, so the structure stays
    proportional to the LIVE window, not the clear history.
    """

    def __init__(self):
        self.bounds: List[bytes] = [b""]
        self.stamps: List[List[Tuple[int, int]]] = [[]]

    def _split_at(self, key: bytes) -> int:
        """Segment index beginning exactly at `key`, splitting if needed."""
        i = bisect_right(self.bounds, key) - 1
        if self.bounds[i] == key:
            return i
        self.bounds.insert(i + 1, key)
        self.stamps.insert(i + 1, list(self.stamps[i]))
        return i + 1

    def add(self, begin: bytes, end: bytes, version: int, seq: int):
        if begin >= end:
            return
        i = self._split_at(begin)
        j = self._split_at(end)
        for k in range(i, j):
            self.stamps[k].append((version, seq))

    def latest_over(self, key: bytes, version: int) -> Tuple[int, int]:
        i = bisect_right(self.bounds, key) - 1
        st = self.stamps[i]
        p = bisect_right(st, (version, 1 << 62)) - 1
        return st[p] if p >= 0 else (-1, -1)

    def trim(self, through_version: int):
        nb: List[bytes] = [b""]
        ns: List[List[Tuple[int, int]]] = [
            [t for t in self.stamps[0] if t[0] > through_version]
        ]
        for b, st in zip(self.bounds[1:], self.stamps[1:]):
            st2 = [t for t in st if t[0] > through_version]
            if st2 == ns[-1]:
                continue  # identical neighbour: coalesce
            nb.append(b)
            ns.append(st2)
        self.bounds, self.stamps = nb, ns

    def __iter__(self):
        """(version, seq, begin, end) fragments, coverage-equivalent to the
        inserted clears (endpoints may be split finer)."""
        for i, st in enumerate(self.stamps):
            if not st:
                continue
            b = self.bounds[i]
            e = self.bounds[i + 1] if i + 1 < len(self.bounds) else KEYSPACE_END
            for (v, s) in st:
                yield (v, s, b, e)

    def __len__(self):
        return sum(len(st) for st in self.stamps)


class VersionedStore:
    """Per-key version chains + versioned clear-range index (the python
    stand-in for the reference's PTree VersionedMap,
    fdbclient/VersionedMap.h:43).

    Entries are ordered by (version, seq) where seq is the mutation's index
    within its version, so set-then-clear vs clear-then-set of the same key
    inside one commit resolve exactly as the mutation order says.
    """

    _SEQ_INF = 1 << 62

    def __init__(self):
        # key -> [(version, seq, value-or-None)]
        self.kv: Dict[bytes, List[Tuple[int, int, Optional[bytes]]]] = {}
        self.sorted_keys: List[bytes] = []
        self.clears = VersionedClears()

    # -- reads --
    def _latest_clear_over(self, key: bytes, version: int) -> Tuple[int, int]:
        return self.clears.latest_over(key, version)

    def get_stamped(self, key: bytes, version: int):
        """(touched, value): touched=False means no window entry covers the
        key at this version (the caller may fall through to a base engine)."""
        chain = self.kv.get(key)
        stamp_e, val = (-1, -1), None
        if chain:
            i = bisect_right(chain, (version, self._SEQ_INF)) - 1
            if i >= 0:
                ver, seq, val = chain[i]
                stamp_e = (ver, seq)
        stamp_c = self._latest_clear_over(key, version)
        if stamp_c > stamp_e:
            return True, None
        if stamp_e == (-1, -1):
            return False, None
        return True, val

    def get(self, key: bytes, version: int) -> Optional[bytes]:
        _touched, val = self.get_stamped(key, version)
        return val

    def trim(self, through_version: int):
        """Drop window state at versions <= through_version (the base engine
        is durable through it; ref: the MVCC window following durability,
        storageserver updateStorage -> setOldestVersion)."""
        for key in list(self.kv):
            chain = [e for e in self.kv[key] if e[0] > through_version]
            if chain:
                self.kv[key] = chain
            else:
                del self.kv[key]
                i = bisect_left(self.sorted_keys, key)
                if i < len(self.sorted_keys) and self.sorted_keys[i] == key:
                    del self.sorted_keys[i]
        self.clears.trim(through_version)

    def get_range(
        self,
        begin: bytes,
        end: bytes,
        version: int,
        limit: int,
        reverse: bool = False,
    ) -> List[Tuple[bytes, bytes]]:
        i = bisect_left(self.sorted_keys, begin)
        j = bisect_left(self.sorted_keys, end)
        keys = self.sorted_keys[i:j]
        if reverse:
            keys = reversed(keys)
        out = []
        for k in keys:
            v = self.get(k, version)
            if v is not None:
                out.append((k, v))
                if len(out) >= limit:
                    break
        return out

    # -- writes (applied in (version, seq) order by the update loop) --
    def set(self, key: bytes, value: bytes, version: int, seq: int = 0):
        chain = self.kv.get(key)
        if chain is None:
            self.kv[key] = [(version, seq, value)]
            insort(self.sorted_keys, key)
        else:
            chain.append((version, seq, value))

    def clear_range(self, begin: bytes, end: bytes, version: int, seq: int = 0):
        self.clears.add(begin, end, version, seq)


class ByteSample:
    """Sampled per-key byte weights with range sums and weighted split
    points (ref: the byte sample fed by every mutation, StorageMetrics
    .actor.h:404) — backed by the order-statistic IndexedSet
    (utils/indexed_set.py, the flow/IndexedSet.h analog): update, erase,
    range-erase, and range-sum are all O(log n).

    A key of total size s is sampled with probability min(1, s/UNIT) and
    carries weight max(s, UNIT), so the expected weight equals the true
    bytes and small keys stay out of the sample."""

    UNIT = 100

    def __init__(self, rng):
        from ..utils.indexed_set import IndexedSet

        self.rng = rng
        self.idx = IndexedSet(rng)

    def update(self, key: bytes, size: int):
        # Every write RE-SAMPLES the key (ref: byteSample updates on each
        # mutation): keeping a prior admission would bias repeatedly-
        # overwritten small keys into the sample permanently.
        admit = size >= self.UNIT or self.rng.random01() < size / self.UNIT
        if admit:
            self.idx.set(key, max(size, self.UNIT))
        else:
            self.idx.erase(key)

    def remove_range(self, begin: bytes, end: Optional[bytes]):
        self.idx.erase_range(begin, end)

    def bytes_in(self, begin: bytes, end: Optional[bytes]) -> int:
        return self.idx.sum_range(begin, end)

    def split_point(self, begin: bytes, end: Optional[bytes]) -> Optional[bytes]:
        """The sampled key closest to half the range's weight (ref:
        splitMetrics picking the key where half the bytes fall).  Scans
        only the RANGE's sampled keys; key_at_metric offers the O(log n)
        form when closest-to-half precision is not required."""
        ks = self.idx.keys_in(begin, end)
        total = self.idx.sum_range(begin, end)
        if total == 0 or len(ks) < 2:
            return None
        acc = 0
        best, best_err = None, None
        for i, k in enumerate(ks):
            if i > 0:
                err = abs(acc - total / 2)
                if best_err is None or err < best_err:
                    best, best_err = k, err
            acc += self.idx.get(k)
        return best


VERSION_META_KEY = b"\xff\xffmeta/durable_version"
OWNED_META_KEY = b"\xff\xffmeta/owned_ranges"


class AddingShard:
    """A range this server is becoming responsible for (ref: AddingShard
    storageserver.actor.cpp:85-133).  While FETCHING, the stream's mutations
    for the range are buffered (applying them before the base snapshot lands
    would double-apply atomics and break chain ordering); once the snapshot
    at `fetch_version` is in, the buffered tail above it replays and the
    shard waits READY for the settling keyServers record."""

    FETCHING = 0
    READY = 1

    __slots__ = ("begin", "end", "src_ids", "phase", "buffer", "fetch_version",
                 "finalized")

    def __init__(self, begin: bytes, end: bytes, src_ids: List[str]):
        self.begin = begin
        self.end = end
        self.src_ids = src_ids
        self.phase = AddingShard.FETCHING
        self.buffer: List[Tuple[int, int, Mutation]] = []  # (version, seq, m)
        self.fetch_version = 0
        self.finalized = False  # settling record arrived while still fetching


class StorageServer:
    """In-memory MVCC window, optionally over a durable base engine.

    With `kvstore` set, applied mutations are mirrored into the engine and
    committed on a cadence; the window is trimmed to the durable floor and
    the TLog popped only after durability (ref: updateStorage ->
    IKeyValueStore::commit -> tLogPop).  Without it, applied == durable and
    the log is popped eagerly (the original in-memory slice).
    """

    def __init__(
        self,
        process: SimProcess,
        tlog,  # TLogInterface or List[TLogInterface]
        epoch_begin_version: int = 0,
        kvstore=None,
        storage_id: str = None,
        owned_all: bool = True,
        meta=None,
        n_route_logs: int = None,  # tag placement spans the first N logs
        # (the rest are satellites: in the ack/confirm set, not consumed)
    ):
        self.process = process
        self.tlogs: List[TLogInterface] = (
            list(tlog) if isinstance(tlog, (list, tuple)) else [tlog]
        )
        self.n_route_logs = (
            len(self.tlogs) if n_route_logs is None else n_route_logs
        )
        self.store = VersionedStore()
        self.kvstore = kvstore
        self.storage_id = storage_id or f"ss:{process.machine.machine_id}"
        self.owned = RangeMap(False)
        self.adding = RangeMap(False)  # range -> AddingShard while moving in
        self.avail = RangeMap(0)  # per-range read-version floor (fetch snap)
        # storage id -> StorageInterface, learned from \xff/serverList/
        # mutations in the stream (ref: the serverList system keys).
        self.server_list: Dict[str, StorageInterface] = {}
        self._meta_dirty = True
        if meta is not None:
            owned_entries, avail_entries, server_list, ready_shards = meta
            for b, e, v in owned_entries:
                self.owned.set_range(b, e, v)
            for b, e, v in avail_entries:
                self.avail.set_range(b, e, v)
            self.server_list = dict(server_list)
            # READY AddingShards persist with the same commit that made
            # their fetched data durable, so a crash between FETCHED and the
            # settle record doesn't lose the move (the settle replayed from
            # the log tail finds the shard and flips it).
            for b, e, fv in ready_shards:
                shard = AddingShard(b, e, [])
                shard.phase = AddingShard.READY
                shard.fetch_version = fv
                self.adding.set_range(b, e, shard)
        elif owned_all:
            self.owned.set_range(b"", None, True)
        self.version = NotifiedVersion(epoch_begin_version)
        self.durable_version = epoch_begin_version
        self.byte_sample = ByteSample(process.network.loop.rng)
        # Ratekeeper signals (ref: StorageQueueInfo — bytesInput /
        # bytesDurable; queue depth = input - durable).
        self.input_bytes = 0
        self.durable_bytes = 0
        if kvstore is not None:
            # Rebuild from the durable base after a restart (the reference
            # persists its byte sample for the same reason); paged so huge
            # stores don't need one giant materialization.
            lo = b""
            while True:
                page = kvstore.read_range(lo, KEYSPACE_END, limit=4096)
                for k, v in page:
                    self.byte_sample.update(k, len(k) + len(v))
                if len(page) < 4096:
                    break
                lo = page[-1][0] + b"\x00"
        self._metrics_stream = RequestStream(
            process, "get_storage_metrics", well_known=True
        )
        self._gv_stream = RequestStream(process, "get_value", well_known=True)
        self._gkv_stream = RequestStream(process, "get_key_values", well_known=True)
        self._ver_stream = RequestStream(process, "get_version", well_known=True)
        self._watch_stream = RequestStream(process, "watch_value", well_known=True)
        self._fetch_stream = RequestStream(process, "fetch_shard", well_known=True)
        self._shard_state_stream = RequestStream(
            process, "get_shard_state", well_known=True
        )
        self._owned_meta_stream = RequestStream(
            process, "get_owned_meta", well_known=True
        )
        # key -> [(watched_value, reply)] parked until the key changes
        self._watches: Dict[bytes, list] = {}
        # The logs holding this storage's tag (ref: peek-merge cursors over
        # the tag's tlog subset); broadcast tags live everywhere, so any of
        # these serves the full subscription.
        from .log_system import tlogs_for_tag

        self._my_logs = [
            self.tlogs[i]
            for i in tlogs_for_tag(self.storage_id, self.n_route_logs)
        ]
        self._tags = [self.storage_id, TAG_DEFAULT, TAG_ALL]
        self._kc_cache = epoch_begin_version  # last all-logs-confirmed min
        # Register our consumer floor before anything else runs: the logs
        # must not discard entries this storage hasn't peeked.  Logs we
        # never peek get a vacuous (infinite) floor so this consumer never
        # blocks their trimming.
        my = set(id(t) for t in self._my_logs)
        for tl in self.tlogs:
            tl.pop.send(
                process,
                TLogPopRequest(
                    version=(
                        epoch_begin_version if id(tl) in my else 1 << 60
                    ),
                    tag=self.storage_id,
                ),
            )
        process.spawn(self._update_loop(), "ss_update")
        process.spawn_observed(self._serve_get_value(), "ss_get_value")
        process.spawn_observed(self._serve_metrics(), "ss_metrics")
        process.spawn_observed(self._serve_get_key_values(), "ss_get_key_values")
        process.spawn_observed(self._serve_get_version(), "ss_get_version")
        process.spawn_observed(self._serve_watch_value(), "ss_watch")
        process.spawn_observed(self._serve_fetch_shard(), "ss_fetch")
        process.spawn_observed(self._serve_get_shard_state(), "ss_shard_state")
        process.spawn_observed(self._serve_get_owned_meta(), "ss_owned_meta")

    @classmethod
    async def recover(
        cls,
        process: SimProcess,
        tlog: TLogInterface,
        fs,
        filename: str,
        storage_id: str = None,
        owned_all: bool = True,
        engine: str = "memory",
    ):
        """Reopen the base engine and resume pulling from its durable
        version (ref: storageServer rollback/restart recovery).  Ownership
        is restored from the durable meta record; keyServers mutations in
        the replayed log tail re-apply any later changes.  A move still
        FETCHING at the crash is absent after recovery — DD observes
        "missing" shard state and restarts it.  A move that reached READY
        is durable (persisted with the fetched rows in one commit by
        _finish_fetch) and is restored as a READY AddingShard: the source
        may already have settled and dropped its copy, so re-fetching is
        not an option (hence the write-through).

        engine: "memory" (WAL+snapshot RAM map, KeyValueStoreMemory.
        actor.cpp analog) or "btree" (COW B+tree, the ssd-class engine —
        datasets exceed RAM; ref KeyValueStoreSQLite.actor.cpp's role)."""
        kv = await open_engine(engine, fs, process, filename)
        vmeta = kv.read_value(VERSION_META_KEY)
        durable = int(vmeta.decode()) if vmeta else 0
        owned_meta = kv.read_value(OWNED_META_KEY)
        meta = decode_frame(owned_meta) if owned_meta else None
        return cls(
            process,
            tlog,
            epoch_begin_version=durable,
            kvstore=kv,
            storage_id=storage_id,
            owned_all=owned_all if meta is None else False,
            meta=meta,
        )

    def interface(self) -> StorageInterface:
        return StorageInterface(
            storage_id=self.storage_id,
            get_storage_metrics=self._metrics_stream.ref(),
            get_value=self._gv_stream.ref(),
            get_key_values=self._gkv_stream.ref(),
            get_version=self._ver_stream.ref(),
            watch_value=self._watch_stream.ref(),
            fetch_shard=self._fetch_stream.ref(),
            get_shard_state=self._shard_state_stream.ref(),
            get_owned_meta=self._owned_meta_stream.ref(),
        )

    # -- watches (ref watchValue_impl storageserver.actor.cpp:760) --
    async def _serve_watch_value(self):
        while True:
            req, reply = await self._watch_stream.pop()
            self.process.spawn(self._watch_one(req, reply), "ss_watch_one")

    async def _watch_one(self, req: WatchValueRequest, reply):
        try:
            self._check_range_owned(req.key, key_after(req.key), req.version)
            await self._wait_for_version(req.version)
            # Ownership may have moved away during the wait; re-check so a
            # disowned (dropped) range re-routes instead of reading as empty.
            self._check_range_owned(req.key, key_after(req.key), req.version)
        except FdbError as e:
            reply.send_error(e.name)
            return
        current = self._get_current(req.key, self.version.get())
        if current != req.value:
            reply.send(self.version.get())  # changed already: fire now
            return
        n_parked = sum(len(v) for v in self._watches.values())
        if n_parked >= MAX_WATCHES:
            reply.send_error("too_many_watches")
            return
        self._watches.setdefault(req.key, []).append((req.value, reply))

    def _check_watches(self, version: int, touched_keys, cleared_ranges):
        """Called after applying a version's mutations: fire watches whose
        key changed value."""
        if not self._watches:
            return
        candidates = set()
        for k in self._watches:
            if k in touched_keys:
                candidates.add(k)
            else:
                for b, e in cleared_ranges:
                    if b <= k < e:
                        candidates.add(k)
                        break
        for k in candidates:
            still = []
            for watched_value, reply in self._watches.get(k, []):
                now_val = self._get_current(k, version)
                if now_val != watched_value:
                    reply.send(version)
                else:
                    still.append((watched_value, reply))
            if still:
                self._watches[k] = still
            else:
                self._watches.pop(k, None)

    def _pop_all(self, version: int):
        for tl in self._my_logs:
            tl.pop.send(
                self.process,
                TLogPopRequest(version=version, tag=self.storage_id),
            )

    async def _known_committed_bound(self, reply) -> int:
        """Highest version safe to APPLY (ref: knownCommittedVersion).
        Commits ack only after EVERY log fsyncs, and epoch-end recovery
        truncates above min(all durables) — so a version is safe once
        (a) the proxy has seen it fully acked (rides the pushes), or
        (b) ALL logs (not just our tag's subset: the recovery cut spans
        every log) confirm it durable.  The confirm fan-out is skipped
        while a previous round already covers the log's tail."""
        bound = reply.known_committed
        if len(self.tlogs) == 1:
            return max(bound, reply.end_version)
        best = max(bound, self._kc_cache)
        if reply.end_version <= best:
            return best  # nothing new to confirm
        from ..flow.eventloop import wait_for_all

        try:
            # One concurrent round — serial probes would multiply catch-up
            # latency by the log count.
            durables = await wait_for_all(
                [
                    tl.confirm.get_reply(self.process, None)
                    for tl in self.tlogs
                ]
            )
        except FdbError:
            return best  # a log is unreachable: only (a) is safe
        m = min(durables)
        if m > self._kc_cache:
            self._kc_cache = m
        return max(bound, self._kc_cache)

    # -- write path: pull from the log (ref: storageserver update() via a
    # peek cursor; failover across the tag's log replicas) --
    async def _update_loop(self):
        from ..flow.buggify import buggify

        loop = self.process.network.loop
        last_durable_commit = loop.now()
        log_i = 0
        while True:
            if buggify("storage_apply_lag"):
                # BUGGIFY: a lagging storage — exercises waitForVersion
                # waits, future_version timeouts, and ratekeeper lag paths.
                await loop.delay(loop.rng.random01() * 0.05)
            try:
                reply = await self._my_logs[
                    log_i % len(self._my_logs)
                ].peek.get_reply(
                    self.process,
                    TLogPeekRequest(
                        begin_version=self.version.get(), tags=self._tags
                    ),
                )
            except FdbError:
                # This replica is down: rotate to another log holding our
                # tag (ref: ServerPeekCursor bestServer failover).
                from ..flow.testprobe import test_probe

                test_probe("storage_peek_failover")
                log_i += 1
                await loop.delay(0.05)
                continue
            bound = await self._known_committed_bound(reply)
            for version, mutations in reply.entries:
                if version <= self.version.get():
                    continue
                if version > bound:
                    break  # not yet known-committed; re-peek later
                self._apply(version, mutations)
                self.version.set(version)
            # Advance through tag-empty versions, but never past what this
            # peek actually covered (a limit-truncated peek may end below
            # the known-committed watermark).
            floor = min(bound, reply.end_version)
            if floor > self.version.get():
                self.version.set(floor)
            if self.kvstore is None:
                # In-memory engine: every version stays in the RAM window,
                # so only the MVCC-window floor limits old reads (ref: the
                # 5s window, oldestVersion = version - MAX_WRITE_TRANSACTION
                # _LIFE_VERSIONS); the log still pops eagerly.
                self.durable_version = max(
                    self.durable_version,
                    self.version.get()
                    - MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
                )
                self.durable_bytes = self.input_bytes  # RAM window IS durable
                self._pop_all(self.version.get())
            elif (
                (
                    loop.now() - last_durable_commit
                    >= STORAGE_DURABILITY_LAG
                    # BUGGIFY: eager durability — trims the MVCC window as
                    # aggressively as possible (transaction_too_old paths).
                    or buggify("storage_eager_durable")
                )
                and self.version.get() > self.durable_version
            ):
                await self._make_durable()
                last_durable_commit = loop.now()
            if not reply.has_more:
                await loop.delay(0.001)  # poll; push-based peek comes later

    async def _make_durable(self):
        """Fold window mutations through the applied version into the base
        engine in (version, seq) order, commit, trim, pop the log (ref:
        updateStorage storageserver.actor.cpp).

        The durable floor is raised BEFORE the engine's RAM state is
        mutated: reads below the new floor error transaction_too_old instead
        of falling through the window to a base engine that is already ahead
        of their version (the fold + commit spans awaits).

        The fold stops an MVCC window short of the applied version (ref:
        storageserver keeping the newest ~5s in the versioned window;
        oldestVersion trails by MAX_WRITE_TRANSACTION_LIFE_VERSIONS) so
        reads at any version the resolver would still admit keep working —
        durability of the recent tail is the log's job until it is popped
        here."""
        new_durable = max(
            self.durable_version,
            self.version.get()
            - MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
        )
        if new_durable <= self.durable_version:
            # No fold progress, but OWNERSHIP changes must not wait for
            # the version window to advance: a crash after a shard
            # handoff (fetch WRITE-THROUGH already made the data durable)
            # would otherwise recover a server whose durable meta never
            # claimed the shard — unreachable data.
            if self._meta_dirty:
                self._persist_meta_locked()
                await self.kvstore.commit()
            return
        self.durable_version = new_durable
        ops = []
        for key, chain in self.store.kv.items():
            for ver, seq, val in chain:
                if ver <= new_durable:
                    ops.append((ver, seq, "set", key, val))
        for ver, seq, b, e in self.store.clears:
            if ver <= new_durable:
                ops.append((ver, seq, "clear", b, e))
        ops.sort(key=lambda o: (o[0], o[1]))
        for _v, _s, op, a, b in ops:
            self.durable_bytes += len(a) + len(b) + 16
            if op == "set":
                self.kvstore.set(a, b)
            else:
                self.kvstore.clear_range(a, b)
        self.kvstore.set(VERSION_META_KEY, b"%d" % new_durable)
        if self._meta_dirty:
            self._persist_meta_locked()
        await self.kvstore.commit()
        self.store.trim(new_durable)
        self._pop_all(new_durable)

    def _persist_meta_locked(self):
        """Serialize ownership/avail/serverList/READY-shard meta into the
        engine's write buffer (caller commits)."""
        self._meta_dirty = False
        ready = {
            id(a): a for _b, _e, a in self.adding.items()
            if a and a.phase == AddingShard.READY
        }
        meta = (
            [(b, e, v) for b, e, v in self.owned.items()],
            [(b, e, v) for b, e, v in self.avail.items()],
            dict(self.server_list),
            [(a.begin, a.end, a.fetch_version) for a in ready.values()],
        )
        self.kvstore.set(OWNED_META_KEY, encode_frame(meta))

    @property
    def queue_bytes(self) -> int:
        """Un-durable window depth (ref: StorageQueueInfo's
        bytesInput - bytesDurable, the ratekeeper's storage signal)."""
        return max(0, self.input_bytes - self.durable_bytes)

    def _get_current(self, key: bytes, version: int) -> Optional[bytes]:
        touched, val = self.store.get_stamped(key, version)
        if not touched and self.kvstore is not None:
            return self.kvstore.read_value(key)
        return val

    # -- mutation application + metadata interception --
    def _apply(self, version: int, mutations: List[Mutation]):
        touched, cleared = set(), []
        for seq, m in enumerate(mutations):
            # Metadata interception first (ref ApplyMetadataMutation.h):
            # every storage watches keyServers/serverList changes regardless
            # of ownership — that is how shard handoffs reach it, serialized
            # with the stream at this exact version.
            self._apply_metadata(m, version)
            self._route_mutation(m, version, seq, touched, cleared)
        self._check_watches(version, touched, cleared)

    def _route_mutation(self, m: Mutation, version: int, seq: int,
                        touched: set, cleared: list):
        """Apply to owned ranges; buffer into FETCHING AddingShards; apply
        directly into READY ones; drop the rest."""
        if m.type == MutationType.CLEAR_RANGE:
            for cb, ce, v in self.owned.intersecting(m.param1, m.param2):
                ce = m.param2 if ce is None else ce
                if v:
                    self.store.clear_range(cb, ce, version, seq)
                    self.input_bytes += len(cb) + len(ce) + 16
                    self.byte_sample.remove_range(cb, ce)
                    cleared.append((cb, ce))
                    continue
                for ab, ae, shard in self.adding.intersecting(cb, ce):
                    if not shard:
                        continue
                    ae = ce if ae is None else ae
                    clip = Mutation(MutationType.CLEAR_RANGE, ab, ae)
                    if shard.phase == AddingShard.FETCHING:
                        shard.buffer.append((version, seq, clip))
                    else:
                        self.store.clear_range(ab, ae, version, seq)
                        self.input_bytes += len(ab) + len(ae) + 16
                        self.byte_sample.remove_range(ab, ae)
            return
        if m.type in (MutationType.NO_OP, MutationType.DEBUG_KEY):
            return
        key = m.param1
        if self.owned[key]:
            self._apply_point(m, version, seq)
            touched.add(key)
            return
        shard = self.adding[key]
        if shard:
            if shard.phase == AddingShard.FETCHING:
                shard.buffer.append((version, seq, m))
            else:
                self._apply_point(m, version, seq)

    def _apply_point(self, m: Mutation, version: int, seq: int):
        if m.type == MutationType.SET_VALUE:
            self.store.set(m.param1, m.param2, version, seq)
            val = m.param2
        else:
            existing = self._get_current(m.param1, version)
            val = apply_atomic(m.type, existing, m.param2)
            self.store.set(m.param1, val, version, seq)
        # Ratekeeper input accounting: count exactly what enters the
        # window (what _make_durable later folds out), so queue_bytes =
        # input - durable measures the REAL un-durable depth.
        self.input_bytes += len(m.param1) + len(val or b"") + 16
        if m.param1 < KEYSPACE_END:
            self.byte_sample.update(m.param1, len(m.param1) + len(val or b""))

    def _apply_metadata(self, m: Mutation, version: int):
        from .system_keys import parse_metadata_mutation

        parsed = parse_metadata_mutation(m)
        if parsed is None:
            return
        if parsed[0] == "server":
            _kind, sid, iface = parsed
            self.server_list[sid] = iface
            self._meta_dirty = True
        elif parsed[0] == "resolver_split":
            pass  # proxy-side concern; storages don't partition resolution
        elif parsed[0] == "lock":
            pass  # lock enforcement lives at the proxies
        else:
            self._meta_dirty = True
            _kind, begin, src, dest, end = parsed
            if dest:
                self._start_adding(begin, end, src, dest, version)
            else:
                self._finish_shard(begin, end, src, version)

    def _start_adding(self, begin: bytes, end: bytes, src: List[str],
                      dest: List[str], version: int):
        """A move src -> dest began at `version`.  Sources keep serving
        reads until the settling record; a destination that lacks the data
        starts an AddingShard fetch (ref: startMoveKeys writing dest into
        keyServers, MoveKeys.actor.cpp)."""
        if end is None:
            # The CC seeds the tail keyServers record open-ended; every
            # byte-comparison downstream (clear_range, fetch paging, the
            # byte sample) needs a concrete bound or a move of the TAIL
            # shard dies in a TypeError and wedges FETCHING forever.
            end = KEYSPACE_END
        if self.storage_id not in dest or self.storage_id in src:
            return
        if all(v for _b, _e, v in self.owned.intersecting(begin, end)):
            return  # already fully own it
        overlapping = {
            id(a): a for _b, _e, a in self.adding.intersecting(begin, end) if a
        }
        if len(overlapping) == 1:
            a = next(iter(overlapping.values()))
            if a.begin == begin and a.end == end:
                return  # duplicate record (DD retry); fetch already running
        # A different overlapping move supersedes: cancel the old shards over
        # their FULL extents (their fetch actors notice and abort; any piece
        # outside [begin,end) becomes "missing" and DD restarts it).
        for a in overlapping.values():
            self.adding.set_range(a.begin, a.end, False)
            self.owned.set_range(a.begin, a.end, False)
        shard = AddingShard(begin, end, [s for s in src if s != self.storage_id])
        self.owned.set_range(begin, end, False)
        self.adding.set_range(begin, end, shard)
        if not shard.src_ids:
            # Brand-new (empty) shard: nothing to fetch.
            shard.fetch_version = version
            shard.phase = AddingShard.READY
        else:
            self.process.spawn(self._fetch_shard_data(shard), "ss_fetch_data")

    def _finish_shard(self, begin: bytes, end: bytes, team: List[str],
                      version: int):
        """A settling record: [begin, end) now belongs to `team` (ref:
        finishMoveKeys flipping serverKeys).  Non-members disown and drop;
        members flip their AddingShard live (or adopt an empty new shard)."""
        if self.storage_id not in team:
            self._disown(begin, end)
            return
        shards = {id(a): a for _b, _e, a in self.adding.intersecting(begin, end)
                  if a}
        for a in shards.values():
            if a.phase == AddingShard.READY:
                self._flip_to_owned(a)
            else:
                # Fetch still in flight (only possible if DD restarted and
                # re-settled blindly): flip when the data completes.
                a.finalized = True
        # NOTE: an unowned sub-range with no AddingShard here stays unowned
        # ("missing") — e.g. an in-flight move lost across a crash.  Adopting
        # it empty would turn data loss into a readable empty shard; instead
        # DD observes "missing" via get_shard_state and restarts the move.
        # Seeding a brand-new shard uses a (src=[], dest=team) record (which
        # creates an empty READY AddingShard) followed by a settle.

    def _flip_to_owned(self, shard: AddingShard):
        self.adding.set_range(shard.begin, shard.end, False)
        self.owned.set_range(shard.begin, shard.end, True)
        self.avail.set_range(shard.begin, shard.end, shard.fetch_version)
        self._meta_dirty = True

    def _disown(self, begin: bytes, end: bytes):
        had = any(v for _b, _e, v in self.owned.intersecting(begin, end))
        self.owned.set_range(begin, end, False)
        self.adding.set_range(begin, end, False)
        self._meta_dirty = True
        if had:
            self._drop_range(begin, end)

    def _drop_range(self, begin: bytes, end: bytes):
        """Evict data for a range this server no longer owns; parked watches
        in the range fire wrong_shard_server so clients re-route."""
        hi = min(end, KEYSPACE_END) if end is not None else KEYSPACE_END
        self.byte_sample.remove_range(begin, hi)
        if self.kvstore is not None:
            self.kvstore.clear_range(begin, hi)
        i = bisect_left(self.store.sorted_keys, begin)
        j = bisect_left(self.store.sorted_keys, hi)
        for k in self.store.sorted_keys[i:j]:
            self.store.kv.pop(k, None)
        del self.store.sorted_keys[i:j]
        for k in [k for k in self._watches if begin <= k < hi]:
            for _val, reply in self._watches.pop(k):
                reply.send_error("wrong_shard_server")

    # -- shard fetch: destination side (ref fetchKeys storageserver :85-133) --
    async def _fetch_shard_data(self, shard: AddingShard):
        loop = self.process.network.loop
        attempt = 0
        while True:
            if self.adding[shard.begin] is not shard:
                return  # move cancelled or superseded
            srcs = [self.server_list.get(s) for s in shard.src_ids]
            srcs = [s for s in srcs if s is not None]
            if not srcs:
                await loop.delay(0.05)  # serverList entry not yet seen
                continue
            src = srcs[attempt % len(srcs)]
            attempt += 1
            snap = self.version.get()
            try:
                await self._fetch_pages(shard, src, snap)
                break
            except FdbError:
                # Source dead / snapshot aged out of its window / it no
                # longer owns the range: back off and retry at a newer
                # snapshot (ref: fetchKeys' transaction_too_old retry).
                await loop.delay(0.05)
        if self.adding[shard.begin] is not shard:
            return
        # Replay the buffered tail the snapshot missed, in stream order.
        for ver, seq, m in shard.buffer:
            if ver <= shard.fetch_version:
                continue
            if m.type == MutationType.CLEAR_RANGE:
                self.store.clear_range(m.param1, m.param2, ver, seq)
                self.input_bytes += len(m.param1) + len(m.param2) + 16
                self.byte_sample.remove_range(m.param1, m.param2)
            else:
                self._apply_point(m, ver, seq)
        shard.buffer = []
        shard.phase = AddingShard.READY
        self._meta_dirty = True
        if self.kvstore is not None:
            # One commit covers the written-through rows AND the READY
            # claim: after this fsync a crashed destination recovers the
            # shard complete (the settle's flip persists via the next
            # meta-only durability pass).
            self._persist_meta_locked()
            await self.kvstore.commit()
        if shard.finalized:
            self._flip_to_owned(shard)

    async def _fetch_pages(self, shard: AddingShard, src: StorageInterface,
                           snap: int):
        """Stream the shard at one fixed snapshot version.  A clear at the
        snapshot resets any partial previous attempt (it sorts below the
        page's sets at the same version), so retries at newer snapshots
        converge."""
        self.store.clear_range(shard.begin, shard.end, snap, 0)
        self.input_bytes += len(shard.begin) + len(shard.end) + 16
        self.byte_sample.remove_range(shard.begin, shard.end)
        # WRITE-THROUGH: fetched rows go straight into the durable base
        # engine too, fsynced before the shard can report READY.  The
        # settle that follows READY makes the SOURCE durably drop its
        # copy, so a destination holding the snapshot only in its RAM
        # window would leave the data existing NOWHERE durable across a
        # crash (snapshots never ride the log) — silent loss (ref:
        # fetchKeys persisting fetched data before the shard turns
        # readable, storageserver.actor.cpp fetchKeys).  Base rows above
        # durable_version are benign: window entries shadow them until
        # trim, and recovery gates reads with the avail floor (= snap).
        if self.kvstore is not None:
            self.kvstore.clear_range(shard.begin, shard.end)
        begin = shard.begin
        while True:
            rep: FetchShardReply = await src.fetch_shard.get_reply(
                self.process,
                FetchShardRequest(begin=begin, end=shard.end, version=snap),
            )
            if self.adding[shard.begin] is not shard:
                from ..flow.testprobe import test_probe

                test_probe("fetch_superseded")
                # Superseded mid-page by an overlapping move: STOP writing
                # through — the new fetch's clear_range/sets share the
                # base-engine commit buffer, and a stale row written after
                # it would win last-writer-wins durably (served after a
                # crash even though the RAM window shadows it).  The
                # caller's top-of-loop check turns this into a return.
                raise FdbError("fetch_superseded")
            for k, v in rep.data:
                self.store.set(k, v, snap, 1)
                if self.kvstore is not None:
                    self.kvstore.set(k, v)
                self.input_bytes += len(k) + len(v) + 16
                self.byte_sample.update(k, len(k) + len(v))
            if not rep.more:
                break
            begin = key_after(rep.data[-1][0])
        shard.fetch_version = snap

    # -- shard fetch: source side --
    async def _serve_fetch_shard(self):
        while True:
            req, reply = await self._fetch_stream.pop()
            self.process.spawn(self._fetch_shard_one(req, reply), "ss_fetch_one")

    async def _fetch_shard_one(self, req: FetchShardRequest, reply):
        try:
            await self._wait_for_version(req.version)
        except FdbError as e:
            reply.send_error(e.name)
            return
        if not all(
            v for _b, _e, v in self.owned.intersecting(req.begin, req.end)
        ):
            reply.send_error("wrong_shard_server")
            return
        page = FETCH_SHARD_PAGE_ROWS
        data = self._range_at(req.begin, req.end, req.version, page + 1, False)
        reply.send(
            FetchShardReply(data=data[:page], version=req.version,
                            more=len(data) > page)
        )

    async def _serve_get_owned_meta(self):
        while True:
            req, reply = await self._owned_meta_stream.pop()
            self.process.spawn_observed(self._owned_meta_one(req, reply), "ss_om_one")

    async def _owned_meta_one(self, req, reply):
        # Answer only once the replayed log tail (with any settled handoffs)
        # is applied, so the recovered routing map is not stale.
        await self.version.when_at_least(req.min_version)
        reply.send(
            (
                self.storage_id,
                [(b, e) for b, e, v in self.owned.items() if v],
                dict(self.server_list),
            )
        )

    async def _serve_get_shard_state(self):
        while True:
            req, reply = await self._shard_state_stream.pop()
            reply.send(self._shard_state(req))

    def _shard_state(self, req: GetShardStateRequest) -> str:
        states = set()
        for b, e, v in self.owned.intersecting(req.begin, req.end):
            if v:
                states.add("readable")
                continue
            e2 = req.end if e is None else e
            adds = [a for _ab, _ae, a in self.adding.intersecting(b, e2) if a]
            if not adds:
                states.add("missing")
            else:
                states.update(
                    "fetched" if a.phase == AddingShard.READY else "adding"
                    for a in adds
                )
        for s in ("missing", "adding", "fetched"):
            if s in states:
                return s
        return "readable"

    # -- read path --
    def _check_range_owned(self, begin: bytes, end: bytes, version: int):
        """Reject reads this server can't answer: outside owned ranges ->
        wrong_shard_server (client re-routes); below a fetched shard's
        snapshot floor -> transaction_too_old (ref: getShardState /
        waitForVersion interplay in storageserver read paths)."""
        for _b, _e, v in self.owned.intersecting(begin, end):
            if not v:
                raise FdbError("wrong_shard_server")
        floor = 0
        for _b, _e, v in self.avail.intersecting(begin, end):
            floor = max(floor, v)
        if version < floor:
            raise FdbError("transaction_too_old")

    async def _wait_for_version(self, version: int):
        """Ref: waitForVersion storageserver.actor.cpp:631."""
        if version > self.version.get() + MAX_VERSIONS_IN_FLIGHT:
            raise FdbError("future_version")
        if version < self.durable_version:
            # The window below the durable floor is gone (ref: reads below
            # oldestVersion -> transaction_too_old, storageserver :640).
            raise FdbError("transaction_too_old")
        if self.version.get() < version:
            # Bounded wait: if this server's log stream has stalled (tlog
            # dead, generation ending), fail the read instead of parking
            # forever — the client retries with a fresh version against the
            # next generation (ref: the FUTURE_VERSION_DELAY timeout in
            # waitForVersion throwing future_version, storageserver :631).
            from ..flow.eventloop import timeout_after

            got = await timeout_after(
                self.process.network.loop,
                self.version.when_at_least(version),
                FUTURE_VERSION_DELAY,
                default=None,
            )
            if got is None and self.version.get() < version:
                raise FdbError("future_version")
        if version < self.durable_version:  # floor may have risen across the wait
            raise FdbError("transaction_too_old")

    async def _serve_get_value(self):
        while True:
            req, reply = await self._gv_stream.pop()
            self.process.spawn(self._get_value_one(req, reply), "ss_gv")

    async def _get_value_one(self, req: GetValueRequest, reply):
        try:
            self._check_range_owned(req.key, key_after(req.key), req.version)
            await self._wait_for_version(req.version)
            self._check_range_owned(req.key, key_after(req.key), req.version)
        except FdbError as e:
            reply.send_error(e.name)
            return
        reply.send(
            GetValueReply(
                value=self._get_current(req.key, req.version), version=req.version
            )
        )

    async def _serve_get_key_values(self):
        while True:
            req, reply = await self._gkv_stream.pop()
            self.process.spawn(self._get_key_values_one(req, reply), "ss_gkv")

    async def _get_key_values_one(self, req: GetKeyValuesRequest, reply):
        try:
            self._check_range_owned(req.begin, req.end, req.version)
            await self._wait_for_version(req.version)
            self._check_range_owned(req.begin, req.end, req.version)
        except FdbError as e:
            reply.send_error(e.name)
            return
        data = self._range_at(
            req.begin, req.end, req.version, req.limit + 1, req.reverse
        )
        more = len(data) > req.limit
        reply.send(
            GetKeyValuesReply(data=data[: req.limit], more=more, version=req.version)
        )

    def _range_at(self, begin, end, version, limit, reverse):
        """Window-over-base merged range read (window clears mask base keys).

        Two-pointer merge over the already-sorted base and window key lists
        with early exit, so a limited read costs O(limit + skipped-masked),
        not O(range size).
        """
        if self.kvstore is None:
            return self.store.get_range(begin, end, version, limit, reverse)
        # Base keys arrive in PAGES through the engine-neutral
        # read_keys_page (works for the Python memory engine and the
        # native C++ engine alike), merged against the window's sorted
        # keys; window clears mask base rows, so more pages are pulled
        # until `limit` merged rows exist or the base is exhausted.
        wkeys = self.store.sorted_keys
        wi = bisect_left(wkeys, begin)
        wj = bisect_left(wkeys, end)
        # Window keys are indexed in place (no range-sized slice/reverse):
        # a limited read stays O(limit + masked keys skipped).
        if reverse:
            iw, ew, wstep = wj - 1, wi - 1, -1
        else:
            iw, ew, wstep = wi, wj, 1
        before = (lambda x, y: x > y) if reverse else (lambda x, y: x < y)
        rows: list = []
        page_lo, page_hi = begin, end
        page: list = []
        ia = 0
        exhausted = False
        while len(rows) < limit:
            if ia >= len(page) and not exhausted:
                page = self.kvstore.read_keys_page(
                    page_lo, page_hi, max(limit, 256), reverse
                )
                ia = 0
                if len(page) < max(limit, 256):
                    exhausted = True
                elif reverse:
                    page_hi = page[-1]  # next page strictly below
                else:
                    page_lo = page[-1] + b"\x00"
            ka = page[ia] if ia < len(page) else None
            kb = wkeys[iw] if iw != ew else None
            if ka is None and kb is None:
                break
            if kb is None or (ka is not None and before(ka, kb)):
                k = ka
                ia += 1
            elif ka is None or before(kb, ka):
                k = kb
                iw += wstep
            else:  # same key in both
                k = ka
                ia += 1
                iw += wstep
            touched, wv = self.store.get_stamped(k, version)
            v = wv if touched else self.kvstore.read_value(k)
            if v is not None:
                rows.append((k, v))
        return rows

    async def _serve_metrics(self):
        """Byte estimates + split points for DD (ref: waitMetrics /
        splitMetrics served from the byte sample)."""
        from .interfaces import GetStorageMetricsReply

        while True:
            req, reply = await self._metrics_stream.pop()
            if getattr(req, "signals_only", False):
                reply.send(
                    GetStorageMetricsReply(
                        version=self.version.get(),
                        queue_bytes=self.queue_bytes,
                    )
                )
                continue
            end = req.end if req.end != b"" else None
            reply.send(
                GetStorageMetricsReply(
                    bytes=self.byte_sample.bytes_in(req.begin, end),
                    split_key=self.byte_sample.split_point(req.begin, end),
                    version=self.version.get(),
                    queue_bytes=self.queue_bytes,
                )
            )

    async def _serve_get_version(self):
        while True:
            _req, reply = await self._ver_stream.pop()
            reply.send(self.version.get())
