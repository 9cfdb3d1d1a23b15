"""Self-driving DataDistribution: the continuously-running control loop
over the transactional primitives in `data_distribution.py`.

The port's own copy of the reference package's ``server/dd_role.py``.
The reference's ``dd_*`` server knobs are ``DataDistributionRole``'s
constructor arguments here, with the reference's defaults and without the
``dd_`` prefix.

Ref: fdbserver/DataDistribution.actor.cpp:1237 (teamTracker reacting to
storage failures), fdbserver/DataDistributionTracker.actor.cpp (shard
split/merge on byte-sample cadence), fdbserver/DataDistributionQueue.actor.cpp
(RelocateShard queue with priorities and a parallelism limit).

The reference's DD is a live role: nothing outside it calls MoveKeys — the
teamTracker notices a degraded team and *enqueues* a relocation, the
tracker notices an oversized shard and splits it, and the queue executes a
bounded number of moves at once, highest priority first.  This module is
that control loop: `DataDistributionRole` owns a
`DataDistributor` (a client of the database, as in the reference) and runs

  - a storage liveness probe (consecutive-failure counting over cheap
    get_version RPCs — DD's local analog of the failure broadcast),
  - a team tracker that heals shards listing failed/excluded members back
    to full team width using the healthiest spares,
  - a shard tracker driving auto_split / auto_merge on a cadence and
    enqueueing count-rebalancing moves after splits,
  - an exclusion tracker polling `\xff/conf/excluded/...`,
  - N queue workers executing moves.

Every actor is convergence-based: failed moves are dropped and re-derived
from the authoritative shard map on the next tracker round, so crashes,
re-recruitments, and racing operators cannot wedge the loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set

from ..flow.asyncvar import AsyncVar
from ..flow.buggify import buggify
from ..flow.error import ActorCancelled, FdbError
from ..flow.eventloop import timeout_after
from ..flow.testprobe import test_probe
from ..flow.trace import TraceEvent
from . import system_keys as sk
from .data_distribution import DataDistributor

# Relocation priorities (ref: SERVER_KNOBS->PRIORITY_TEAM_UNHEALTHY et al,
# DataDistributionQueue.actor.cpp — higher runs first).
PRIORITY_TEAM_UNHEALTHY = 200
PRIORITY_EXCLUSION = 150
PRIORITY_REDRIVE = 100  # finish a move another actor started but abandoned
PRIORITY_REBALANCE = 50


@dataclass
class RelocateShard:
    """One queued move: shard at `begin` should end up on `dest_team`."""

    begin: bytes
    dest_team: List[str]
    priority: int
    reason: str = ""


class DataDistributionRole:
    """The live DD actor set.  Construct with a DataDistributor (which
    carries the Database handle and the id->interface map) and call
    `start()`; `stop()` cancels every actor (the CC does this when a new
    generation retires the old singleton)."""

    def __init__(
        self,
        dd: DataDistributor,
        tlogs: list = None,
        active_fn=None,
        ping_interval: float = 0.5,
        ping_timeout: float = 0.4,
        failure_detections: int = 4,  # consecutive misses
        tracker_interval: float = 2.0,
        move_parallelism: int = 2,
        shard_max_bytes: int = 1 << 20,
        shard_min_bytes: int = 16 << 10,
    ):
        self.dd = dd
        self.loop = dd.loop
        self.process = dd.db.process
        self.tlogs = list(tlogs or [])
        # Singleton fencing: the CC passes a generation/leadership check so
        # a superseded DD (old generation, or a CC that lost the election)
        # stops initiating moves (ref: the dataDistributor being re-recruited
        # per master generation).
        self.active = active_fn or (lambda: True)
        self.failed: Set[str] = set()
        self.excluded: Set[str] = set()
        self._fail_counts: Dict[str, int] = {}
        self._queue: Dict[bytes, RelocateShard] = {}
        self._queue_wake = AsyncVar(0)
        self._inflight: Set[bytes] = set()
        self._tasks: list = []
        self.moves_done = 0
        self.heals_done = 0
        self.splits_done = 0
        self.merges_done = 0
        self.ping_interval = ping_interval
        self.ping_timeout = ping_timeout
        self.failure_detections = failure_detections
        self.tracker_interval = tracker_interval
        self.move_parallelism = move_parallelism
        self.shard_max_bytes = shard_max_bytes
        self.shard_min_bytes = shard_min_bytes
        if buggify("dd_aggressive_tracker"):
            # Rare-path activation: a hyperactive tracker shakes out races
            # between healing, splitting, and user commits.
            self.tracker_interval = min(0.25, self.tracker_interval)

    # --- lifecycle ---
    def start(self) -> "DataDistributionRole":
        spawn = self.process.spawn
        self._tasks = [
            spawn(self._probe_loop(), "dd_probe"),
            spawn(self._team_tracker(), "dd_teams"),
            spawn(self._shard_tracker(), "dd_tracker"),
            spawn(self._exclusion_tracker(), "dd_exclusions"),
        ]
        for i in range(self.move_parallelism):
            self._tasks.append(spawn(self._queue_worker(), f"dd_queue{i}"))
        return self

    def stop(self):
        for t in self._tasks:
            t.cancel()
        self._tasks = []

    # --- storage liveness (ref: teamTracker's server failure inputs) ---
    async def _probe_loop(self):
        """Cheap get_version pings with consecutive-failure counting; a
        storage is `failed` after failure_detections misses in a row and
        healthy again on the first success (the sim fabric has latency
        noise and BUGGIFY delays, so one miss must not trigger a heal)."""
        detections = self.failure_detections
        while True:
            if not self.active():
                await self.loop.delay(self.ping_interval)
                continue
            for sid, iface in sorted(self.dd.storages.items()):
                ok = await self._ping(iface)
                if ok:
                    self._fail_counts[sid] = 0
                    self.failed.discard(sid)
                else:
                    n = self._fail_counts.get(sid, 0) + 1
                    self._fail_counts[sid] = n
                    if n >= detections and sid not in self.failed:
                        test_probe("dd_storage_declared_failed")
                        TraceEvent("DDStorageFailed").detail(
                            "id", sid
                        ).log()
                        self.failed.add(sid)
            await self.loop.delay(self.ping_interval)

    async def _ping(self, iface) -> bool:
        task = self.process.spawn(
            self._swallow(iface.get_version.get_reply(self.process, None))
        )
        try:
            v = await timeout_after(self.loop, task, self.ping_timeout)
            return isinstance(v, int)
        except ActorCancelled:
            raise
        except Exception:  # fdblint: ignore[ERR001]: liveness probe — ANY failure IS the negative verdict it reports
            return False
        finally:
            # A wedged-but-alive storage never replies: without this the
            # probe loop would strand one orphan task per ping interval.
            if not task.is_ready():
                task.cancel()

    async def _swallow(self, fut):
        try:
            return await fut
        except FdbError:
            return None

    # --- team tracker (ref: DataDistribution.actor.cpp:1237) ---
    async def _team_tracker(self):
        """Each round: any settled shard whose team lists a failed or
        excluded member (with at least one healthy survivor) is enqueued
        for relocation back to its original width, using the least-loaded
        healthy spares as replacements."""
        while True:
            try:
                if self.active():
                    await self._team_round()
            except ActorCancelled:
                raise
            except (FdbError, TimeoutError):
                pass  # mid-recovery; re-derive next round
            await self.loop.delay(self.tracker_interval)

    async def _team_round(self):
        bad = self.failed | self.excluded
        shard_map = await self.dd.read_shard_map()
        counts = self._shard_counts(shard_map)
        for b, _e, team, dest in shard_map:
            members = list(dest or team)
            sick = [s for s in members if s in bad]
            if b in self._inflight or b in self._queue:
                continue
            if not sick:
                if dest:
                    # Abandoned move (a previous DD singleton was stopped
                    # between startMove and finish): re-drive it to done —
                    # dd.move() recognizes the same in-flight destination
                    # and completes it rather than restarting.
                    test_probe("dd_move_redriven")
                    self._enqueue(
                        RelocateShard(
                            b, list(dest), PRIORITY_REDRIVE, reason="redrive"
                        )
                    )
                continue
            survivors = [s for s in members if s not in bad]
            if not survivors:
                TraceEvent("DDShardUnhealable", severity=30).detail(
                    "begin", b
                ).detail("team", members).log()
                continue
            spares = self._pick_spares(
                len(members) - len(survivors), exclude=set(members), counts=counts
            )
            # Account the picks so several heals in one round spread over
            # the spares instead of piling onto a single idlest storage.
            for sid in spares:
                counts[sid] = counts.get(sid, 0) + 1
            new_team = survivors + spares
            prio = (
                PRIORITY_TEAM_UNHEALTHY
                if any(s in self.failed for s in sick)
                else PRIORITY_EXCLUSION
            )
            test_probe("dd_heal_enqueued")
            self._enqueue(
                RelocateShard(b, new_team, prio, reason=f"unhealthy:{sick}")
            )

    def _healthy(self) -> List[str]:
        return [
            sid
            for sid in self.dd.storages
            if sid not in self.failed and sid not in self.excluded
        ]

    def _shard_counts(self, shard_map) -> Dict[str, int]:
        """Settled user-shard count per healthy storage (zero included, so
        empty spares attract load)."""
        counts = {sid: 0 for sid in self._healthy()}
        for b, _e, team, dest in shard_map:
            if dest or b >= b"\xff":
                continue
            for sid in team:
                if sid in counts:
                    counts[sid] += 1
        return counts

    def _pick_spares(self, n: int, exclude: Set[str], counts: Dict[str, int]):
        """Up to n healthy storages not in `exclude`, fewest shards first
        (ref: team selection preferring the least-utilized servers)."""
        pool = sorted(
            (sid for sid in self._healthy() if sid not in exclude),
            key=lambda s: (counts.get(s, 0), s),
        )
        return pool[:n]

    # --- shard tracker (ref: DataDistributionTracker.actor.cpp) ---
    async def _shard_tracker(self):
        """Cadenced split / merge / rebalance.  Split and merge are
        metadata-only transactions from data_distribution.py; rebalance
        enqueues real moves at the lowest priority."""
        while True:
            await self.loop.delay(self.tracker_interval)
            if not self.active():
                continue
            try:
                await self._refresh_storages()
                split = await self.dd.auto_split(self.shard_max_bytes)
                if split:
                    test_probe("dd_auto_split_fired")
                    self.splits_done += len(split)
                merged = await self.dd.auto_merge(self.shard_min_bytes)
                if merged:
                    test_probe("dd_auto_merge_fired")
                    self.merges_done += len(merged)
                await self._rebalance_round()
            except ActorCancelled:
                raise
            except (FdbError, TimeoutError, AssertionError):
                # Mid-recovery, or racing an operator move; next round
                # re-derives from the authoritative map.
                continue

    async def _refresh_storages(self):
        """Fold `\xff/serverList/` into the id->interface map so storages
        registered after this role started (re-recruitments, new spares)
        become heal targets (ref: DD reading serverListKeys)."""

        async def txn(tr):
            tr.options["access_system_keys"] = True
            tr.options["lock_aware"] = True
            return await tr.get_range(sk.SERVER_LIST_PREFIX, sk.SERVER_LIST_END)

        for k, v in await self.dd.db.run(txn):
            sid = sk.server_list_id(k)
            if sid not in self.dd.storages:
                self.dd.storages[sid] = sk.decode_server_entry(v)

    async def _rebalance_round(self):
        """Count-based load balance: when the busiest healthy storage has
        >= 2 more settled user shards than the idlest, move one shard off
        it, swapping busiest->idlest in that shard's team (ref: the
        BgDDMountainChopper/valley-filler rebalancers,
        DataDistributionQueue.actor.cpp)."""
        shard_map = await self.dd.read_shard_map()
        counts = self._shard_counts(shard_map)
        if len(counts) < 2:
            return
        busiest = max(counts, key=lambda s: (counts[s], s))
        idlest = min(counts, key=lambda s: (counts[s], s))
        if counts[busiest] - counts[idlest] < 2:
            return
        for b, _e, team, dest in shard_map:
            if dest or b >= b"\xff":
                continue
            if busiest not in team or idlest in team:
                continue
            if b in self._inflight or b in self._queue:
                continue
            new_team = [idlest if s == busiest else s for s in team]
            test_probe("dd_rebalance_enqueued")
            self._enqueue(
                RelocateShard(
                    b, new_team, PRIORITY_REBALANCE,
                    reason=f"rebalance:{busiest}->{idlest}",
                )
            )
            return  # one rebalancing move per round

    # --- exclusions (ref: DD watching excludedServersKeys) ---
    async def _exclusion_tracker(self):
        from ..client.management import get_excluded_servers
        from .interfaces import TLogPopRequest

        unregistered: Set[str] = set()  # acked tag unregisters
        while True:
            if not self.active():
                await self.loop.delay(self.tracker_interval)
                continue
            try:
                now_excluded = set(await get_excluded_servers(self.dd.db))
            except (FdbError, TimeoutError):
                await self.loop.delay(self.tracker_interval)
                continue
            for sid in sorted(now_excluded - self.excluded):
                test_probe("dd_exclusion_observed")
                TraceEvent("DDExclusionObserved").detail("id", sid).log()
            self.excluded = now_excluded
            # Targets: excluded servers AND probe-declared-dead ones.  The
            # CC unregisters dead tags once at recovery, but that send is
            # best-effort (a dropped reply would otherwise pin one tlog's
            # trim floor until an unrelated recovery); this loop is the
            # convergent owner.  A server dropped from both sets (healthy
            # again / re-included) leaves `unregistered` so a LATER death
            # re-unregisters it — re-sending is idempotent, and a revived
            # storage re-registers itself on its next pop.
            dead = {s for s in self.failed if s in self.dd.storages}
            targets = now_excluded | dead
            unregistered &= targets
            # Unregister a tag only AFTER the team tracker finished draining
            # the server out of the shard map (ref: removeStorageServer at
            # exclusion completion, not observation — unregistering a
            # still-serving member would let the logs trim entries it has
            # not applied).  Convergent: retried every round until every
            # tlog acked, so an unreachable tlog can't permanently pin its
            # discard floor on the excluded server's persisted pop floor.
            pending = sorted(targets - unregistered)
            if pending:
                try:
                    shard_map = await self.dd.read_shard_map()
                except (FdbError, TimeoutError):
                    await self.loop.delay(self.tracker_interval)
                    continue
                still_member = set()
                for _b, _e, team, dest in shard_map:
                    still_member |= set(team) | set(dest)
                for sid in pending:
                    if sid in still_member:
                        continue  # drain in progress
                    ok = True
                    for tl in self.tlogs:
                        try:
                            await tl.pop.get_reply(
                                self.process,
                                TLogPopRequest(tag=sid, unregister=True),
                            )
                        except FdbError:
                            ok = False
                    if ok:
                        unregistered.add(sid)
            await self.loop.delay(self.tracker_interval)

    # --- the relocation queue (ref: DataDistributionQueue.actor.cpp) ---
    def _enqueue(self, item: RelocateShard):
        cur = self._queue.get(item.begin)
        if cur is not None and cur.priority >= item.priority:
            return
        self._queue[item.begin] = item
        self._queue_wake.trigger()

    async def _queue_worker(self):
        while True:
            item = self._pop_best()
            if item is None:
                await self._queue_wake.on_change()
                continue
            if not self.active():
                # Superseded singleton: drain without executing.
                await self.loop.delay(self.tracker_interval)
                continue
            self._inflight.add(item.begin)
            try:
                await self.dd.move(item.begin, item.dest_team)
                self.moves_done += 1
                if item.priority >= PRIORITY_EXCLUSION:
                    self.heals_done += 1
                TraceEvent("DDMoveDone").detail("begin", item.begin).detail(
                    "team", item.dest_team
                ).detail("reason", item.reason).log()
            except ActorCancelled:
                raise
            except (FdbError, TimeoutError, ValueError, RuntimeError) as e:
                # Drop it: the tracker re-derives still-needed moves from
                # the authoritative map (convergence, not bookkeeping).
                TraceEvent("DDMoveFailed", severity=30).detail(
                    "begin", item.begin
                ).detail("error", repr(e)).log()
                await self.loop.delay(self.tracker_interval)
            finally:
                self._inflight.discard(item.begin)

    def _pop_best(self) -> Optional[RelocateShard]:
        best = None
        for b, item in self._queue.items():
            if b in self._inflight:
                continue
            if best is None or item.priority > best.priority:
                best = item
        if best is not None:
            del self._queue[best.begin]
        return best
