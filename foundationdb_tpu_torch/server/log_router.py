"""LogRouter: pull the primary's mutation stream, re-serve it remotely.

Ref: fdbserver/LogRouter.actor.cpp — pullAsyncData (:172) tails the
primary log system through a peek cursor into an in-memory window, and
the router answers the same peek/pop protocol the TLogs speak, so remote
consumers (remote-DC storage servers, DR agents) read from their local
router instead of crossing the WAN per consumer.  Consumer pops fold into
the router's floor, which it forwards to the primary logs under its own
registered tag — the primary retains exactly what the slowest remote
consumer still needs (spill bounds the memory there).

The rebuild hosts an in-memory TLog object as the router's buffer: the
serving half (peek/pop/confirm, per-tag floors, trimming) is identical by
construction; only the fill path differs (pulled via MergePeekCursor
instead of pushed commits).

The port's own copy of the reference package's ``server/log_router.py``.
"""

from __future__ import annotations

from typing import List, Optional

from ..flow.error import FdbError
from ..rpc.network import SimProcess
from ..rpc.peek_cursor import MergePeekCursor
from .interfaces import TLogInterface, TLogPopRequest
from .tlog import TLog


class LogRouter:
    def __init__(
        self,
        process: SimProcess,
        primary_logs: List,
        router_id: str = "router0",
        begin_version: int = 0,
        tags: Optional[List[str]] = None,  # None = full stream
        poll: float = 0.01,
        buffer_bytes_limit: int = 16 << 20,  # backpressure bound (ref: the
        # router's buffer limit — it stops pulling, the primary spills)
    ):
        self.process = process
        self.primary_logs = list(primary_logs)
        self.router_tag = f"_lr/{router_id}"
        self.poll = poll
        # The buffer/serving half: an in-memory TLog on this process.
        self.log = TLog(process, epoch_begin_version=begin_version)
        self.cursor = MergePeekCursor(
            process, self.primary_logs, tags=tags, begin=begin_version
        )
        self._forwarded_floor = begin_version
        self.pulled = begin_version
        self.buffer_bytes_limit = buffer_bytes_limit
        # Set when the primary permanently cannot serve our begin (its
        # floor passed us): the operator/recovery must re-point or rebuild
        # this router — retrying would spin forever.
        self.broken: Optional[FdbError] = None
        process.spawn_observed(self._main(), "lr_main")
        process.spawn(self._floor_loop(), "lr_floor")

    async def _main(self):
        # Registration must COMPLETE before the first pull: a concurrent
        # storage pop could advance the primary's floor past our begin in
        # the window between them, breaking the router spuriously.
        await self._register()
        await self._pull_loop()

    def interface(self) -> TLogInterface:
        """Remote consumers treat the router exactly as a log."""
        return self.log.interface()

    async def _register(self):
        """Hold the primary retention floor BEFORE pulling (ref: the
        router tag registered with the log system at recruitment)."""
        for tl in self.primary_logs:
            await tl.pop.get_reply(
                self.process,
                TLogPopRequest(
                    version=self.cursor.begin, tag=self.router_tag
                ),
            )

    async def _pull_loop(self):
        from ..flow.trace import TraceEvent

        loop = self.process.network.loop
        while True:
            if self.log._mem_bytes > self.buffer_bytes_limit:
                # Backpressure: a stalled remote consumer must bound the
                # ROUTER's memory too — stop pulling; the primary retains
                # (and spills) behind our registered floor.
                await loop.delay(0.05)
                continue
            try:
                entries, end = await self.cursor.next_batch()
            except FdbError as e:
                if e.name == "peek_below_begin":
                    # Unrecoverable: the primary's floor passed our begin —
                    # this cursor can never serve the gap.  Surface loudly
                    # and stop (ref: cursor invalidation on epoch end).
                    self.broken = e
                    TraceEvent("LogRouterBroken", severity=30).detail(
                        "router", self.router_tag
                    ).detail("begin", self.cursor.begin).log()
                    return
                # A primary log is unreachable (epoch ending / partition):
                # back off; a recovery will re-point or replace us.
                await loop.delay(0.1)
                continue
            for version, bundle in entries:
                # Feed the buffer directly (the pull IS the commit path).
                self.log.append_raw(version, bundle)
            if end > self.pulled:
                self.pulled = end
                self.log.known_committed = max(
                    self.log.known_committed, self.cursor.known_committed
                )
                self.log.durable.set(end)
                self.log._trim()
            else:
                await loop.delay(self.poll)

    async def _floor_loop(self):
        """Forward the slowest remote consumer's floor to the primary
        (ref: the router popping the log system as its consumers pop)."""
        loop = self.process.network.loop
        while True:
            await loop.delay(0.1)
            floors = self.log.popped_tags
            if not floors:
                continue
            floor = min(min(floors.values()), self.log.durable.get())
            if floor <= self._forwarded_floor:
                continue
            try:
                for tl in self.primary_logs:
                    await tl.pop.get_reply(
                        self.process,
                        TLogPopRequest(version=floor, tag=self.router_tag),
                    )
                self._forwarded_floor = floor
            except FdbError:
                continue  # primary unreachable; retried next round
