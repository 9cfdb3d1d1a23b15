"""TLog role: the durable, tag-partitioned mutation log.

The port's own copy of the reference package's ``server/tlog.py``
(modelled on TLogServer.actor.cpp): the commit path appends version ->
per-tag message bundles and fsyncs (TLogQueue/DiskQueue), tLogPeekMessages
:946 serves a tag's stream to storage servers, tLogPop :894 discards below
the consumer floors.  Each entry holds {tag: [(seq, Mutation)]}; a peek
returns the union of the requested tags per version, re-merged into commit
order by seq (a storage subscribes to its own tag plus the broadcast tags).
Without a ``disk_queue`` the log is in memory and a fixed delay stands in
for the fsync.

Spill (ref: updatePersistentData, TLogServer.actor.cpp:539): when the
in-memory window exceeds `spill_threshold_bytes`, the oldest durable
versions move into a per-tag btree keyspace (`t/<tag>/<version>` in a COW
B+tree file) and the DiskQueue is popped behind them — a lagging or
crashed-but-registered consumer bounds the log's MEMORY, not its
correctness: peeks below the in-memory floor are served from the spill
store.  Consumer pops clear the spilled ranges; the popped floor and the
spill watermark persist in the spill store's meta keys.  ``recover``
rebuilds a log from its machine's disk, and ``fresh`` starts a new one
there.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Dict, List, Tuple

from ..flow.asyncvar import NotifiedVersion
from ..rpc.network import SimProcess
from ..rpc.stream import RequestStream
from ..rpc.wire import decode_frame, encode_frame
from .interfaces import (
    TLogCommitRequest,
    TLogInterface,
    TLogPeekReply,
    TLogPeekRequest,
    TLogPopRequest,
)

# Simulated fsync time for the in-memory log (no disk queue).
COMMIT_DELAY = 0.0005


class TLog:
    SPILL_META_THROUGH = b"\x00meta/spilled_through"
    SPILL_META_POPPED = b"\x00meta/popped"
    # One marker key per unregistered (dead-consumer) tag.  Durable in
    # the SPILL store, not the disk queue: the __pop__ unregister record
    # is trimmed once the floor passes its seq, and forgetting a dead tag
    # re-opens the unbounded spill leak it exists to stop.
    SPILL_DEAD_TAG_PREFIX = b"\x00meta/dead_tag/"

    def __init__(
        self,
        process: SimProcess,
        epoch_begin_version: int = 0,
        disk_queue=None,
        epoch: int = 0,
        begin_version: int = 0,
        spill_store=None,
        spill_threshold_bytes: int = 1 << 20,
        spill_keep_versions: int = 16,
    ):
        self.process = process
        self.epoch = epoch
        # First version this log could possibly hold.  A FRESH log recruited
        # to replace a permanently lost replica starts at the recovery
        # version: peeks below it must ERROR (not silently advance past old
        # versions it never saw) so storages fail over to a surviving
        # replica of their tag for old-epoch data (ref: the old-log-system
        # epochs in LogSystemConfig; peek cursors route pre-recovery reads
        # to the previous generation's logs, TagPartitionedLogSystem
        # :568-581).
        self.begin_version = begin_version
        # Parallel sorted lists: versions[i] holds entries[i], a per-tag
        # mutation bundle {tag: [(seq, Mutation)]}.
        self.versions: List[int] = []
        self.entries: List[Dict[str, list]] = []
        self.durable = NotifiedVersion(epoch_begin_version)
        self.known_committed = epoch_begin_version
        self.popped = epoch_begin_version
        # tag -> highest pop seen; entries are discarded below min over tags
        # (ref: per-tag popping, TLogServer.actor.cpp:894).
        self.popped_tags: dict = {}
        # Tags unregistered as dead consumers: commits may still tag them
        # until DD heals keyServers, so spill GC must keep collecting their
        # rows (below the global floor) or the spill store grows forever.
        self._dead_tags: set = set()
        self.disk_queue = disk_queue  # None = in-memory (simulated fsync)
        # -- spill state (None spill_store = memory-only log, no spill) --
        self.spill_store = spill_store
        self.spill_threshold_bytes = spill_threshold_bytes
        self.spill_keep_versions = spill_keep_versions
        self.spilled_through = 0  # all versions <= this live in spill_store
        self._spill_gc_floor = 0  # spill rows below this are already deleted
        self._ver_bytes: List[int] = []  # parallel to versions
        self._mem_bytes = 0
        self._spilling = False
        # Epoch-end lock: a locked log rejects further commits (ref: the
        # TLogLockResult protocol during recovery's LOCKING_CSTATE).
        self.locked = False
        self._commit_stream = RequestStream(process, "tlog_commit", well_known=True)
        self._peek_stream = RequestStream(process, "tlog_peek", well_known=True)
        self._pop_stream = RequestStream(process, "tlog_pop", well_known=True)
        self._confirm_stream = RequestStream(
            process, "tlog_confirm", well_known=True
        )
        self._metrics_stream = RequestStream(
            process, "tlog_metrics", well_known=True
        )
        process.spawn_observed(self._serve_commit(), "tlog_commit")
        process.spawn_observed(self._serve_peek(), "tlog_peek")
        process.spawn_observed(self._serve_pop(), "tlog_pop")
        process.spawn_observed(self._serve_confirm(), "tlog_confirm")
        process.spawn_observed(self._serve_metrics(), "tlog_metrics")

    @classmethod
    async def recover(
        cls,
        process: SimProcess,
        fs,
        filename: str = "tlog.dq",
        fast_forward_to: int = 0,
        epoch: int = 0,
    ) -> "TLog":
        """Reopen the on-disk queue and rebuild the unpopped suffix (ref:
        TLogServer restorePersistentState).  `fast_forward_to` jumps the
        durable chain to the new epoch's begin version so post-recovery
        pushes (whose prevVersion is the recovery version) can land."""
        from ..fileio.btree import BTreeKeyValueStore
        from ..fileio.diskqueue import DiskQueue

        q, records = await DiskQueue.open(fs, process, filename)
        spill = await BTreeKeyValueStore.open(fs, process, filename + ".spill")
        log = cls(process, disk_queue=q, epoch=epoch, spill_store=spill)
        raw = spill.read_value(cls.SPILL_META_THROUGH)
        log.spilled_through = int(raw) if raw else 0
        for k, _v in spill.read_range(
            cls.SPILL_DEAD_TAG_PREFIX, cls.SPILL_DEAD_TAG_PREFIX + b"\xff"
        ):
            log._dead_tags.add(
                k[len(cls.SPILL_DEAD_TAG_PREFIX):].decode()
            )
        for _seq, payload in records:
            rec = decode_frame(payload)
            if rec[0] == "__truncate__":
                cut = rec[1]
                k = bisect_right(log.versions, cut)
                log._mem_bytes -= sum(log._ver_bytes[k:])
                del log.versions[k:]
                del log.entries[k:]
                del log._ver_bytes[k:]
                continue
            if rec[0] == "__pop__":
                # Restore per-tag consumer floors: without them, the first
                # pop after a recovery would trim entries a slower (or
                # crashed-and-recovering) consumer still needs (ref: the
                # persistTagPoppedKeys range in TLogServer's persistent
                # state, TLogServer.actor.cpp).
                _m, tag, ver, unregister = rec
                if unregister:
                    log.popped_tags.pop(tag, None)
                    log._dead_tags.add(tag)
                else:
                    log.popped_tags[tag] = max(
                        log.popped_tags.get(tag, -1), ver
                    )
                continue
            version, tagged = rec
            if version <= log.spilled_through:
                continue  # already persisted in the spill store
            log.versions.append(version)
            log.entries.append(tagged)
            log._ver_bytes.append(len(payload))
            log._mem_bytes += len(payload)
        if log.spilled_through > 0:
            # Spilled data survives below the queue's popped pointer; only
            # the spill-store floor marks what consumers really released.
            raw_p = spill.read_value(cls.SPILL_META_POPPED)
            log.popped = int(raw_p) if raw_p else 0
        else:
            log.popped = q.popped_seq
        last = log.versions[-1] if log.versions else max(
            q.popped_seq, log.spilled_through
        )
        log.durable.set(max(last, fast_forward_to))
        return log

    def interface(self) -> TLogInterface:
        return TLogInterface(
            commit=self._commit_stream.ref(),
            peek=self._peek_stream.ref(),
            pop=self._pop_stream.ref(),
            confirm=self._confirm_stream.ref(),
            metrics=self._metrics_stream.ref(),
        )

    async def _serve_confirm(self):
        while True:
            _req, reply = await self._confirm_stream.pop()
            reply.send(self.durable.get())

    async def _serve_metrics(self):
        from .interfaces import TLogMetricsReply

        while True:
            _req, reply = await self._metrics_stream.pop()
            reply.send(
                TLogMetricsReply(
                    durable_version=self.durable.get(),
                    queue_bytes=self._mem_bytes,
                )
            )

    async def truncate_above(self, cut: int):
        """Epoch-end cut: discard versions > cut (never acked — acks need
        every log durable).  Durable via a marker record so a later
        recovery does not resurrect the orphans from the disk queue.
        The SPILL store must be purged too: spilled versions above the cut
        would otherwise be resurrected by _peek_spilled and feed
        rolled-back mutations to the new generation."""
        # Exclude an in-flight spill: it could be parked at its store
        # commit holding versions above the cut; purging before it lands
        # would resurrect them the moment it resumes.  The log is locked at
        # epoch end (and _spill_task bails when locked), so no new spill
        # starts after this wait.
        loop = self.process.network.loop
        while self._spilling:
            await loop.delay(0.001)
        if self.spill_store is not None and self.spilled_through > cut:
            # Scan the whole tag keyspace for rows above the cut (the
            # orphan suffix is small; truncation only happens at epoch
            # end).  Deleting + lowering the watermark is one atomic
            # spill-store commit.
            lo = b"t/"
            while True:
                page = self.spill_store.read_range(lo, b"t0", limit=512)
                for key, _payload in page:
                    if int.from_bytes(key[-8:], "big") > cut:
                        self.spill_store.clear_range(key, key + b"\x00")
                if len(page) < 512:
                    break
                lo = page[-1][0] + b"\x00"
            self.spilled_through = min(self.spilled_through, cut)
            self.spill_store.set(
                self.SPILL_META_THROUGH, b"%d" % self.spilled_through
            )
            await self.spill_store.commit()
        k = bisect_right(self.versions, cut)
        if k < len(self.versions):
            from ..flow.testprobe import test_probe

            test_probe("epoch_orphans_truncated")
            self._mem_bytes -= sum(self._ver_bytes[k:])
            del self.versions[k:]
            del self.entries[k:]
            del self._ver_bytes[k:]
        if self.disk_queue is not None:
            # seq = cut+1 so the marker outlives the orphans it erases (the
            # disk queue's recovery drops records with seq <= popped_seq,
            # and consumer floors never exceed the known-committed bound,
            # which is <= cut, until after the new epoch begins).
            self.disk_queue.push(
                cut + 1, encode_frame(("__truncate__", cut))
            )
            await self.disk_queue.commit()

    async def _serve_commit(self):
        while True:
            req, reply = await self._commit_stream.pop()
            self.process.spawn(self._commit_one(req, reply), "tlog_commit_one")

    async def _commit_one(self, req: TLogCommitRequest, reply):
        if self.locked or req.epoch != self.epoch:
            # Locked (epoch ended) or a stale generation's proxy reaching a
            # newer log: never silently absorb (ref: epoch locking prevents
            # cross-generation pushes).
            reply.send_error("tlog_stopped")
            return
        from ..flow.buggify import buggify

        if buggify("tlog_slow_fsync"):
            # BUGGIFY: a slow disk — commits ack late, widening the window
            # where a kill strands un-acked data (the epoch-cut path).
            loop = self.process.network.loop
            await loop.delay(loop.rng.random01() * 0.02)
        from ..flow.spans import NULL_SPAN, begin_span
        from ..flow.trace import trace_batch

        trace_batch(
            "CommitDebug", "TLog.tLogCommit.BeforeWaitForVersion", req.debug_id
        )
        # Push span: prevVersion park + append + fsync for one
        # real push (idle batches carry no payload and record nothing).
        tspan = (
            begin_span(
                "tlog_push", role=f"TLog.{self.process.name}",
                attrs={"version": req.version},
            )
            if req.tagged
            else NULL_SPAN
        )
        # Versions are committed in the sequencer's order (ref: TLogServer
        # waits version ordering before appending).
        await self.durable.when_at_least(req.prev_version)
        if self.locked:
            tspan.end(attrs={"error": "tlog_stopped"})
            reply.send_error("tlog_stopped")
            return
        if req.version <= self.durable.get():
            tspan.end(attrs={"duplicate": 1})
            reply.send(self.durable.get())  # duplicate
            return
        self.versions.append(req.version)
        self.entries.append(req.tagged)
        if req.known_committed > self.known_committed:
            self.known_committed = req.known_committed
        if self.disk_queue is not None:
            payload = encode_frame((req.version, req.tagged))
            self._ver_bytes.append(len(payload))
            self._mem_bytes += len(payload)
            self.disk_queue.push(req.version, payload)
            await self.disk_queue.commit()  # real (simulated-file) fsync
        else:
            size = 64 + sum(
                len(m.param1) + len(m.param2) + 32
                for items in req.tagged.values()
                for _seq, m in items
            )
            self._ver_bytes.append(size)
            self._mem_bytes += size
            await self.process.network.loop.delay(COMMIT_DELAY)  # fsync stand-in
        self.durable.set(req.version)
        tspan.end()
        trace_batch(
            "CommitDebug", "TLog.tLogCommit.AfterTLogCommit", req.debug_id
        )
        self._trim()  # consumers with vacuous floors never pop again
        if (
            self.spill_store is not None
            and not self._spilling
            and self._mem_bytes > self.spill_threshold_bytes
        ):
            self.process.spawn_observed(self._spill_task(), "tlog_spill")
        reply.send(req.version)

    @staticmethod
    def _spill_key(tag: str, version: int) -> bytes:
        return b"t/" + tag.encode() + b"/" + version.to_bytes(8, "big")

    async def _spill_task(self):
        """Move the oldest durable versions into the spill store, then drop
        them from memory and pop the DiskQueue behind them (ref:
        updatePersistentData TLogServer.actor.cpp:539).  One instance runs
        at a time; consumer trims racing the awaits are re-checked by
        version value, never by index."""
        if self._spilling:
            return
        self._spilling = True
        try:
            while (
                not self.locked  # epoch ended: truncate may be purging
                and self._mem_bytes > self.spill_threshold_bytes // 2
                and len(self.versions) > self.spill_keep_versions
            ):
                durable = self.durable.get()
                n = 0
                while (
                    n < len(self.versions) - self.spill_keep_versions
                    and self.versions[n] <= durable
                    and n < 64
                ):
                    n += 1
                if n == 0:
                    return
                cut = self.versions[n - 1]
                for k in range(n):
                    for tag, items in self.entries[k].items():
                        self.spill_store.set(
                            self._spill_key(tag, self.versions[k]),
                            encode_frame(items),
                        )
                from ..flow.testprobe import test_probe

                test_probe("tlog_spilled")
                self.spill_store.set(self.SPILL_META_THROUGH, b"%d" % cut)
                await self.spill_store.commit()
                # Spilled data is durable: drop it from memory (recompute
                # the index — a consumer trim may have raced the commit)
                # and pop the WAL behind it.
                self.spilled_through = max(self.spilled_through, cut)
                k = bisect_right(self.versions, cut)
                # Trims racing the commit are re-checked by version value: k
                # is bisected after the await, never a stale index, and
                # entries stays index-aligned with versions (every writer
                # trims both; _spilling gates one spill at a time).
                self._mem_bytes -= sum(self._ver_bytes[:k])
                del self.versions[:k]
                del self.entries[:k]
                del self._ver_bytes[:k]
                if self.disk_queue is not None:
                    self.disk_queue.pop(cut)
                    await self.disk_queue.commit()
        finally:
            self._spilling = False

    def append_raw(self, version: int, tagged: Dict[str, list]):
        """Append a pulled entry directly (the LogRouter's fill path: the
        pull IS the commit).  Keeps the versions/entries/_ver_bytes
        parallel-array invariant and the byte accounting in ONE place."""
        assert not self.versions or version > self.versions[-1]
        size = 64 + sum(
            len(m.param1) + len(m.param2) + 32
            for items in tagged.values()
            for _s, m in items
        )
        self.versions.append(version)
        self.entries.append(tagged)
        self._ver_bytes.append(size)
        self._mem_bytes += size

    @classmethod
    async def fresh(
        cls,
        process: SimProcess,
        fs,
        filename: str = "tlog.dq",
        epoch_begin: int = 0,
        epoch: int = 0,
    ) -> "TLog":
        """A brand-new durable log replacing a permanently lost replica.
        Any stale file from an earlier generation on this machine is
        deleted first — recovering it would resurrect a log that MISSED the
        epochs between its death and now and silently skip mutations."""
        from ..fileio.btree import BTreeKeyValueStore
        from ..fileio.diskqueue import DiskQueue

        for stale in (filename, filename + ".spill"):
            if fs.exists(process, stale):
                fs.delete(process, stale)
        q, _records = await DiskQueue.open(fs, process, filename)
        spill = await BTreeKeyValueStore.open(fs, process, filename + ".spill")
        log = cls(
            process,
            epoch_begin_version=epoch_begin,
            disk_queue=q,
            epoch=epoch,
            begin_version=epoch_begin,
            spill_store=spill,
        )
        return log

    async def _serve_peek(self):
        from ..flow.buggify import buggify

        while True:
            req, reply = await self._peek_stream.pop()
            if req.begin_version < self.begin_version or (
                req.begin_version < self.popped
            ):
                if req.allow_below_begin:
                    # Merge-cursor mode: serve from our floor; the reply's
                    # served_from (= the adjusted begin_version) tells the
                    # merge which range this log did NOT cover, so it can
                    # verify some replica still holds it.
                    req.begin_version = max(self.begin_version, self.popped)
                else:
                    # This log cannot answer below its beginning or below
                    # its popped floor: silently returning only LATER
                    # versions would make the peeker skip data it never
                    # saw (loud failure; the consumer rotates to a replica
                    # that still has the range).
                    reply.send_error("peek_below_begin")
                    continue
            # BUGGIFY: tiny peek pages force the has_more continuation path
            # in every consumer (ref: buggified reply size limits).
            limit = 2 if buggify("tlog_peek_truncate") else req.limit_versions
            if (
                self.spill_store is not None
                and req.begin_version < self.spilled_through
            ):
                reply.send(self._peek_spilled(req, limit))
                continue
            i = bisect_right(self.versions, req.begin_version)
            j = min(i + limit, len(self.versions))
            # Only durable versions are visible to peeks.
            durable_end = bisect_right(self.versions, self.durable.get())
            j = min(j, durable_end)
            out = []
            for k in range(i, j):
                tags = (
                    list(self.entries[k])  # None = subscribe to everything
                    if req.tags is None
                    else req.tags
                )
                if getattr(req, "raw_tagged", False):
                    bundle = {
                        t: list(self.entries[k][t])
                        for t in tags
                        if t in self.entries[k]
                    }
                    if bundle:
                        out.append((self.versions[k], bundle))
                    continue
                by_seq: Dict[int, object] = {}
                for tag in tags:
                    for seq, m in self.entries[k].get(tag, ()):
                        by_seq[seq] = m  # dedupe: a mutation may ride 2 tags
                if by_seq:
                    out.append(
                        (self.versions[k],
                         [m for _s, m in sorted(by_seq.items())])
                    )
            reply.send(
                TLogPeekReply(
                    entries=out,
                    end_version=self.durable.get()
                    if j == durable_end
                    else self.versions[j - 1] if j > i else req.begin_version,
                    known_committed=self.known_committed,
                    has_more=j < durable_end,
                    served_from=req.begin_version,
                )
            )

    def _spill_tag_list(self) -> List[str]:
        """Tags present in the spill store, discovered by prefix hops."""
        tags = []
        lo = b"t/"
        while True:
            page = self.spill_store.read_range(lo, b"t0", limit=1)
            if not page:
                return tags
            key = page[0][0]
            tag = key[2:-9].decode()  # t/<tag>/<8-byte version>
            tags.append(tag)
            # Hop to the first key PAST every "t/<tag>/..." row: "0" is
            # "/"+1, so this also clears tags that EXTEND this one with a
            # "/" segment (e.g. "_lr/r1" after "_lr") — a 0xff-padded hop
            # would sort above those and skip them.
            lo = b"t/" + tag.encode() + b"0"

    def _peek_spilled(self, req: TLogPeekRequest, limit: int) -> TLogPeekReply:
        """Serve a peek whose begin is below the in-memory floor from the
        spill store (ref: the persistentData read path of
        tLogPeekMessages).  Per-tag scans each fetch their first `limit`
        versions; any version inside the merged first `limit` is therefore
        complete across tags."""
        from ..flow.testprobe import test_probe

        test_probe("tlog_peek_spilled")
        req_tags = (
            self._spill_tag_list() if req.tags is None else req.tags
        )
        raw = getattr(req, "raw_tagged", False)
        by_ver_tagged: Dict[int, Dict[str, list]] = {}
        by_ver: Dict[int, Dict[int, object]] = {}
        for tag in req_tags:
            lo = self._spill_key(tag, req.begin_version + 1)
            hi = self._spill_key(tag, self.spilled_through + 1)
            # limit+1: a tag returning exactly `limit` rows must still be
            # detected as possibly-incomplete (truncated ⇒ has_more).
            for k, payload in self.spill_store.read_range(
                lo, hi, limit=limit + 1
            ):
                v = int.from_bytes(k[-8:], "big")
                items = decode_frame(payload)
                if raw:
                    by_ver_tagged.setdefault(v, {})[tag] = items
                d = by_ver.setdefault(v, {})
                for seq, m in items:
                    d[seq] = m
        vers = sorted(by_ver)
        truncated = len(vers) > limit
        vers = vers[:limit]
        if raw:
            out = [(v, by_ver_tagged[v]) for v in vers if by_ver_tagged.get(v)]
        else:
            out = [
                (v, [m for _s, m in sorted(by_ver[v].items())]) for v in vers
            ]
        if truncated:
            end = vers[-1]
            more = True
        else:
            end = self.spilled_through
            more = bool(self.versions)
        return TLogPeekReply(
            entries=out,
            end_version=end,
            known_committed=self.known_committed,
            has_more=more,
            served_from=req.begin_version,
        )

    def _trim(self):
        """Discard below the min consumer floor (ref tLogPop :894).  Capped
        at the durable watermark: vacuous floors (1<<60, from storages that
        never peek this log) must not leak a bogus sequence into the disk
        queue's popped_seq — a recovered log's durable end derives from it."""
        if not self.popped_tags:
            return
        floor = min(min(self.popped_tags.values()), self.durable.get())
        if floor > self.popped:
            self.popped = floor
            k = bisect_right(self.versions, floor)
            self._mem_bytes -= sum(self._ver_bytes[:k])
            del self.versions[:k]
            del self.entries[:k]
            del self._ver_bytes[:k]
            if self.disk_queue is not None:
                # Persisted with the next commit (lazy, like the ref).
                self.disk_queue.pop(floor)
            # Only while spilled rows can still exist below the floor: the
            # no-spill case (and a fully-GC'd spill) must not pay a btree
            # commit per floor advance forever.
            if (
                self.spill_store is not None
                and self.spilled_through > 0
                and self._spill_gc_floor < self.spilled_through
            ):
                self.process.spawn_observed(self._spill_gc(floor), "tlog_spill_gc")

    async def _spill_gc(self, floor: int):
        """Delete spilled data below the global consumer floor and persist
        the floor (one atomic spill-store commit).  Lazily lagging is safe:
        a crash rolls the floor back, the log merely retains more.

        Broadcast tags (TAG_ALL/TAG_DEFAULT) have no registered consumer
        and never appear in popped_tags, yet EVERY commit spills rows for
        them — GC'ing only consumer tags grew the spill store without
        bound.  Below the global floor every consumer is past these rows
        too, so they are collected together.  Likewise UNREGISTERED (dead)
        tags: proxies keep tagging commits for a lost storage until DD
        heals keyServers, and nobody will ever pop those rows."""
        from .interfaces import TAG_ALL, TAG_DEFAULT

        if self._dead_tags:
            from ..flow.testprobe import test_probe

            test_probe("dead_tag_spill_gc")
        for tag in (
            set(self.popped_tags) | self._dead_tags | {TAG_ALL, TAG_DEFAULT}
        ):
            self.spill_store.clear_range(
                self._spill_key(tag, 0), self._spill_key(tag, floor + 1)
            )
        self.spill_store.set(self.SPILL_META_POPPED, b"%d" % floor)
        await self.spill_store.commit()
        self._spill_gc_floor = max(self._spill_gc_floor, floor)

    async def _serve_pop(self):
        while True:
            req, reply = await self._pop_stream.pop()
            tag = req.tag or "_default"
            changed = False
            if req.unregister:
                changed = self.popped_tags.pop(tag, None) is not None
                # Record the death even if this log never saw a pop for the
                # tag — it may still hold (and keep receiving) spilled rows.
                changed = changed or tag not in self._dead_tags
                self._dead_tags.add(tag)
                if changed and self.spill_store is not None:
                    # Durable marker (the __pop__ queue record is trimmed
                    # once the floor passes it); rides the next spill-store
                    # commit — losing an unsynced marker only delays GC one
                    # more unregister/restart cycle, never loses data.
                    self.spill_store.set(
                        self.SPILL_DEAD_TAG_PREFIX + tag.encode(), b"1"
                    )
            elif req.version > self.popped_tags.get(tag, -1):
                self.popped_tags[tag] = req.version
                changed = True
            if changed and self.disk_queue is not None:
                # Lazily persisted (rides the next commit).  Losing an
                # unsynced pop record only LOWERS a recovered floor — the
                # log retains more, never less.  seq = durable+1 so the
                # record outlives the pop floor (which never exceeds the
                # tag's own floor <= durable at pop time).
                self.disk_queue.push(
                    self.durable.get() + 1,
                    encode_frame(
                        ("__pop__", tag, req.version, req.unregister)
                    ),
                )
            self._trim()
            reply.send(None)
