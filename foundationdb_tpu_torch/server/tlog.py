"""TLog role: the tag-partitioned mutation log, in memory.

The port's own copy of the in-memory half of the reference package's
``server/tlog.py`` (modelled on TLogServer.actor.cpp): the commit path
appends version -> per-tag message bundles after a simulated fsync,
tLogPeekMessages :946 serves a tag's stream to storage servers, tLogPop
:894 discards below the consumer floors.  Each entry holds {tag: [(seq,
Mutation)]}; a peek returns the union of the requested tags per version,
re-merged into commit order by seq (a storage subscribes to its own tag
plus the broadcast tags).

The durable half (the disk queue, the spill store, ``recover`` and
``fresh``) needs the port's fileio layer, which is not ported yet: asking
the constructor for a ``disk_queue`` or a ``spill_store`` raises
NotImplementedError.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List

from ..flow.asyncvar import NotifiedVersion
from ..rpc.network import SimProcess
from ..rpc.stream import RequestStream
from .interfaces import (
    TLogCommitRequest,
    TLogInterface,
    TLogPeekReply,
)

# Simulated fsync time for the in-memory log.
COMMIT_DELAY = 0.0005


class TLog:
    def __init__(
        self,
        process: SimProcess,
        epoch_begin_version: int = 0,
        disk_queue=None,
        epoch: int = 0,
        begin_version: int = 0,
        spill_store=None,
    ):
        if disk_queue is not None or spill_store is not None:
            raise NotImplementedError(
                "the durable TLog (disk queue, spill store) needs the port's "
                "fileio layer, which is not ported yet"
            )
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
        # Tags unregistered as dead consumers (commits may still tag them
        # until DD heals keyServers).
        self._dead_tags: set = set()
        self._ver_bytes: List[int] = []  # parallel to versions
        self._mem_bytes = 0
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
        every log durable)."""
        k = bisect_right(self.versions, cut)
        if k < len(self.versions):
            from ..flow.testprobe import test_probe

            test_probe("epoch_orphans_truncated")
            self._mem_bytes -= sum(self._ver_bytes[k:])
            del self.versions[k:]
            del self.entries[k:]
            del self._ver_bytes[k:]

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
        reply.send(req.version)

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

    def _trim(self):
        """Discard below the min consumer floor (ref tLogPop :894).  Capped
        at the durable watermark: vacuous floors (1<<60, from storages that
        never peek this log) must not raise the popped floor past what the
        log holds."""
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

    async def _serve_pop(self):
        while True:
            req, reply = await self._pop_stream.pop()
            tag = req.tag or "_default"
            if req.unregister:
                self.popped_tags.pop(tag, None)
                self._dead_tags.add(tag)
            elif req.version > self.popped_tags.get(tag, -1):
                self.popped_tags[tag] = req.version
            self._trim()
            reply.send(None)
