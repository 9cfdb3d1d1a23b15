"""Sequencer: the master's commit-version allocator.

The port's own copy of the reference package's ``server/sequencer.py``;
the reference's ``versions_per_second`` knob is ``VERSIONS_PER_SECOND``,
at its default.
Ref: masterserver.actor.cpp getVersion :783 — hands out monotone commit
versions with prevVersion chaining so resolvers and logs can totally order
batches; provideVersions :850 serves the stream.  Version arithmetic follows
the reference: advance roughly versions_per_second * elapsed, never
backwards.
"""

from __future__ import annotations

from ..flow.asyncvar import NotifiedVersion
from ..rpc.network import SimProcess
from ..rpc.stream import RequestStream
from .interfaces import (
    GetCommitVersionReply,
    SequencerInterface,
)

VERSIONS_PER_SECOND = 1_000_000  # the reference's knob, at its default


class Sequencer:
    def __init__(
        self, process: SimProcess, epoch_begin_version: int = 0, epoch: int = 0
    ):
        self.process = process
        self.epoch = epoch
        self.version = epoch_begin_version  # last version handed out
        self.committed = NotifiedVersion(epoch_begin_version)
        self._last_grant_time = process.network.loop.now()
        self._commit_stream = RequestStream(process, "get_commit_version", well_known=True)
        self._report_stream = RequestStream(process, "report_committed", well_known=True)
        self._read_stream = RequestStream(process, "get_committed_version", well_known=True)
        process.spawn_observed(self._serve_commit_versions(), "sequencer_commit")
        process.spawn_observed(self._serve_reports(), "sequencer_report")
        process.spawn_observed(self._serve_reads(), "sequencer_read")

    def interface(self) -> SequencerInterface:
        return SequencerInterface(
            get_commit_version=self._commit_stream.ref(),
            report_committed=self._report_stream.ref(),
            get_committed_version=self._read_stream.ref(),
        )

    def _next_version(self) -> tuple:
        """(version, prev_version): versions track virtual time (ref:
        getVersion computes t1*VERSIONS_PER_SECOND skew :800-809)."""
        from ..flow.buggify import buggify

        loop = self.process.network.loop
        now = loop.now()
        vps = VERSIONS_PER_SECOND
        advance = max(1, int((now - self._last_grant_time) * vps))
        if buggify("sequencer_version_jump"):
            # BUGGIFY: a large version gap (clock skew analog) — exercises
            # MVCC window GC and too-old classification downstream.
            advance += int(loop.rng.random01() * vps * 0.5)
        self._last_grant_time = now
        prev = self.version
        self.version = prev + advance
        return self.version, prev

    async def _serve_commit_versions(self):
        while True:
            req_epoch, reply = await self._commit_stream.pop()
            # Epoch fencing: a previous generation's proxy can still reach
            # this stream (well-known token on a rebooted machine) — serving
            # it would consume a (prev, version) pair whose batch the
            # resolvers reject by THEIR epoch check, leaving a permanent
            # hole in the prevVersion chain that wedges every later batch.
            # The reference's master only serves proxies of its own
            # registration (getVersion, masterserver.actor.cpp:783).
            if req_epoch is not None and req_epoch != self.epoch:
                reply.send_error("operation_failed")
                continue
            version, prev = self._next_version()
            reply.send(GetCommitVersionReply(version=version, prev_version=prev))

    async def _serve_reports(self):
        while True:
            version, reply = await self._report_stream.pop()
            if version > self.committed.get():
                self.committed.set(version)
            reply.send(None)

    async def _serve_reads(self):
        while True:
            _req, reply = await self._read_stream.pop()
            reply.send(self.committed.get())
