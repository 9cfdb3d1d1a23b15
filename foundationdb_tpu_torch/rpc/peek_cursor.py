"""Merge peek cursors over the tag-partitioned log set.

Ref: fdbserver/LogSystemPeekCursor.actor.cpp — ServerPeekCursor reads one
tag from one log with failover; MergedPeekCursor combines the cursors of
every log holding the tag set, emitting versions in order only once every
contributing log has reported past them (the known-complete horizon).
Consumers: log routers pulling a full stream, DR agents tailing
multi-log sources, and any reader whose tags span several logs.

The rebuild merges RAW TAGGED bundles (version -> {tag: [(seq, m)]}),
deduping replicated bundles by tag, so the output can be re-served
per-tag (a router) or flattened to commit order (DR).

The port's own copy of the reference package's ``rpc/peek_cursor.py``.
The reference's ``log_replication_factor`` server knob is the cursor's
``log_replication_factor`` constructor argument, at the reference's
default.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..flow.error import FdbError
from ..server.interfaces import TLogPeekRequest


class MergePeekCursor:
    """Pull-merge over `logs` for `tags` (None = every tag).

    next_batch() returns (entries, end_version):
      entries: [(version, {tag: [(seq, mutation)]})] ascending, complete
               through end_version;
      end_version: the merged known-complete horizon (min over logs) —
               versions <= it carrying none of the tags simply don't
               appear.  A member whose floor is above the merge begin (a
               FRESH replacement log) serves from its floor
               (allow_below_begin) — the range below it comes from the
               replicas that still hold it, instead of the whole merge
               wedging on peek_below_begin forever.  A log that DIES makes
               the cursor raise; the caller re-resolves topology (ref:
               the cursor invalidation on epoch end)."""

    def __init__(
        self,
        process,
        logs: List,
        tags: Optional[List[str]] = None,
        begin: int = 0,
        limit_versions: int = 256,
        log_replication_factor: int = 2,
    ):
        self.process = process
        self.logs = list(logs)
        self.tags = None if tags is None else list(tags)
        self.begin = begin  # all versions <= begin already consumed
        self.limit = limit_versions
        self.log_replication_factor = log_replication_factor
        # Per-log buffered entries + per-log scanned horizon.
        self._buf: List[Dict[int, dict]] = [{} for _ in self.logs]
        self._horizon: List[int] = [begin for _ in self.logs]
        # Start of each log's CURRENT contiguous coverage segment (the
        # segment ends at _horizon[i]).  Each pull resumes from
        # _horizon[i], so segments normally chain; a pull whose
        # served_from jumps ABOVE the prior horizon (the log's floor
        # popped past what it had scanned) leaves a hole, and the segment
        # start resets to that served_from.  None until the first answer.
        self._covered_from: List[Optional[int]] = [None for _ in self.logs]
        self.known_committed = 0

    async def next_batch(self) -> Tuple[list, int]:
        from ..flow.eventloop import wait_for_all

        async def pull(i: int):
            log = self.logs[i]
            rep = await log.peek.get_reply(
                self.process,
                TLogPeekRequest(
                    # Each log resumes from ITS OWN scanned horizon — a fast
                    # log's buffered entries above the merge horizon are not
                    # re-transferred while a slow log catches up.
                    begin_version=max(self.begin, self._horizon[i]),
                    tags=self.tags,
                    limit_versions=self.limit,
                    raw_tagged=True,
                    allow_below_begin=True,
                ),
            )
            for version, bundle in rep.entries:
                if version > self.begin:
                    self._buf[i][version] = bundle
            if (
                self._covered_from[i] is None
                or rep.served_from > self._horizon[i]
            ):
                self._covered_from[i] = rep.served_from
            self._horizon[i] = max(self._horizon[i], rep.end_version)
            self.known_committed = max(
                self.known_committed, rep.known_committed
            )

        await wait_for_all(
            [self.process.spawn(pull(i), f"merge_pull{i}") for i in range(len(self.logs))]
        )
        if self.logs and not self._coverage_ok():
            from ..flow.testprobe import test_probe

            test_probe("merge_cursor_uncovered")
            # Some tag's ENTIRE replica slot has coverage starting above
            # the merge begin: a range at/above begin is held by nobody
            # who could have that tag's data — advancing would silently
            # skip mutations.  Raise like the single-log peek_below_begin
            # so the caller re-resolves topology (a replica elsewhere, or
            # a restore point) instead of emitting a gapped stream.
            # Long-lived consumers (backup/DR) prevent this case outright
            # by registering pop floors on every log; it remains reachable
            # when a recovery replaces logs (fresh begin_version) while a
            # cursor still needs the older range.
            raise FdbError("peek_below_begin")
        horizon = min(self._horizon)
        merged: Dict[int, Dict[str, list]] = {}
        for buf in self._buf:
            for version in [v for v in buf if v <= horizon]:
                bundle = buf.pop(version)
                out = merged.setdefault(version, {})
                for tag, items in bundle.items():
                    out.setdefault(tag, items)  # replica bundles identical
        entries = [(v, merged[v]) for v in sorted(merged)]
        if horizon > self.begin:
            self.begin = horizon
        return entries, self.begin

    def _coverage_ok(self) -> bool:
        """Is every tag's range from self.begin held by at least one
        member that could hold that tag?

        Coverage is TAG-AWARE: non-broadcast tags live on only `rf`
        consecutive ring members (log_system.tlogs_for_tag), so one log
        covering begin for unrelated tags must not mask a hole in another
        tag's whole replica slot.  With explicit tags the slots are
        computed exactly; with tags=None (full stream) the tag universe
        is unknown, so EVERY rf-window of the ring must contain a
        covering member (any tag lives in some window).  Conservative
        where the member list's ring order or satellite count is unknown
        — a spurious raise is loud, a missed gap is silent loss."""
        from ..server.log_system import tlogs_for_tag

        covers = [
            c is not None and c <= self.begin for c in self._covered_from
        ]
        if all(covers):
            return True
        n = len(self.logs)
        if self.tags is None:
            rf = min(self.log_replication_factor, n)
            windows = [
                [(s + r) % n for r in range(rf)] for s in range(n)
            ]
        else:
            windows = [tlogs_for_tag(t, n) for t in self.tags]
        return all(any(covers[i] for i in w) for w in windows)

    @staticmethod
    def flatten(bundle: Dict[str, list]) -> list:
        """One version's {tag: [(seq, m)]} -> commit-ordered [mutations]
        (dedupe across tags by seq, like a single log's merged peek)."""
        by_seq: Dict[int, object] = {}
        for items in bundle.values():
            for seq, m in items:
                by_seq[seq] = m
        return [m for _s, m in sorted(by_seq.items())]
