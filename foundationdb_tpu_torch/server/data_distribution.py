"""DataDistribution: shard placement driven by transactions on the
`\xff` system keyspace.

The port's own copy of the reference package's
``server/data_distribution.py``.  It reads no knob: the split and merge
thresholds are arguments of ``auto_split`` and ``auto_merge``.

Ref: fdbserver/DataDistribution.actor.cpp:493 (DDTeamCollection),
fdbserver/MoveKeys.actor.cpp (startMoveKeys/finishMoveKeys updating the
keyServers map transactionally), fdbserver/DataDistributionTracker.actor.cpp
(shard split).  Like the reference, DD is a CLIENT of the database it
manages: every placement change is an ordinary transaction on system keys,
so handoffs serialize with user commits at exact versions and survive
recoveries via the log.

Scope: seeding, explicit split/move, even spreading, shard-state polling,
byte-sample-driven split and merge, exclusions and healing a dead member
of a replicated team.  ``server/dd_role.py`` drives these on its own.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..flow.error import FdbError
from . import system_keys as sk
from .interfaces import GetShardStateRequest, StorageInterface
from .storage import KEYSPACE_END


class DataDistributor:
    """Runs MoveKeys-style protocols through a client Database handle."""

    def __init__(self, db, storages: Dict[str, StorageInterface] = None):
        self.db = db
        self.loop = db.process.network.loop
        # Known storages (also discoverable from \xff/serverList/).
        self.storages: Dict[str, StorageInterface] = dict(storages or {})

    # --- bootstrap ---
    async def register_storages(self, storages: Dict[str, StorageInterface]):
        """Publish \xff/serverList/ entries so every role can resolve ids to
        interfaces from the mutation stream (ref: serverListKeyFor)."""
        self.storages.update(storages)

        async def txn(tr):
            tr.options["access_system_keys"] = True
            tr.options["lock_aware"] = True
            for sid, iface in storages.items():
                tr.set(sk.server_list_key(sid), sk.encode_server_entry(iface))

        await self.db.run(txn)

    async def seed(self, team: List[str]):
        """Record initial ownership of the whole keyspace by `team` (which
        must already hold the data — at bootstrap the first storage owns
        everything).  No-op if a shard map already exists (ref: the seeding
        in the master's RECOVERY_TRANSACTION for new databases)."""
        existing = await self.read_shard_map()
        if existing:
            return

        async def txn(tr):
            tr.options["access_system_keys"] = True
            tr.options["lock_aware"] = True
            tr.set(
                sk.key_servers_key(b""),
                sk.encode_key_servers(team, [], KEYSPACE_END),
            )

        await self.db.run(txn)

    # --- introspection ---
    async def read_shard_map(self) -> List[Tuple[bytes, bytes, list, list]]:
        """[(begin, end, team, dest_or_empty)] from the authoritative
        keyspace (ref: krmGetRanges over keyServers)."""

        async def txn(tr):
            tr.options["access_system_keys"] = True
            tr.options["lock_aware"] = True
            return await tr.get_range(sk.KEY_SERVERS_PREFIX, sk.KEY_SERVERS_END)

        rows = await self.db.run(txn)
        out = []
        for k, v in rows:
            src, dest, end = sk.decode_key_servers(v)
            out.append((sk.key_servers_begin(k), end, src, dest))
        return out

    # --- operations ---
    async def split(self, at_key: bytes):
        """Split the shard containing at_key into two (metadata only; no
        data movement — both halves stay on the same team).  Ref:
        shardSplitter DataDistributionTracker.actor.cpp.

        The containing record is READ INSIDE the transaction (ref:
        startMoveKeys reading keyServers in-txn, MoveKeys.actor.cpp): a
        concurrent move/merge/split conflicts and retries this txn against
        the fresh map instead of being silently overwritten."""

        async def txn(tr):
            tr.options["access_system_keys"] = True
            tr.options["lock_aware"] = True
            # Only the CONTAINING record (greatest begin <= at_key) joins
            # the read set: a full-map scan would conflict this split with
            # every unrelated DD metadata write and rescan O(map) per retry.
            rows = await tr.get_range(
                sk.KEY_SERVERS_PREFIX,
                sk.key_servers_key(at_key) + b"\x00",
                limit=1,
                reverse=True,
            )
            for k, v in rows:
                b = sk.key_servers_begin(k)
                team, dest, e = sk.decode_key_servers(v)
                if b < at_key and (e is None or at_key < e):
                    assert not dest, "split during a move is not supported (v1)"
                    tr.set(
                        sk.key_servers_key(b),
                        sk.encode_key_servers(team, [], at_key),
                    )
                    tr.set(
                        sk.key_servers_key(at_key),
                        sk.encode_key_servers(team, [], e),
                    )
            # at_key already a boundary (or outside the map): nothing to do.

        await self.db.run(txn)

    async def move(self, begin: bytes, dest_team: List[str],
                   poll_interval: float = 0.05, max_polls: int = 2000):
        """Move the shard beginning at `begin` to `dest_team`: startMove
        record -> wait for every destination to report FETCHED -> settle
        (ref: startMoveKeys / waitForShardReady / finishMoveKeys,
        MoveKeys.actor.cpp).

        Both metadata transactions READ the record in-txn before writing,
        so a split/merge/other-move committing between this actor's steps
        conflicts (and retries against fresh state) or raises ValueError
        (shard gone / move superseded) instead of resurrecting a stale
        end-key into the map — the exact overwrite hazard the reference
        avoids the same way (MoveKeys.actor.cpp startMoveKeys reads
        keyServers inside the transaction)."""

        async def start(tr):
            tr.options["access_system_keys"] = True
            tr.options["lock_aware"] = True
            raw = await tr.get(sk.key_servers_key(begin))
            if raw is None:
                raise ValueError(f"no shard begins at {begin!r}")
            team, dest, e = sk.decode_key_servers(raw)
            if dest and set(dest) == set(dest_team):
                return ("drive", e)  # same move in flight; re-drive to done
            if not dest and set(team) == set(dest_team):
                return ("done", e)
            # Fresh move, or superseding an in-flight move whose destination
            # changed (e.g. heal() retargeting after a dest died): rewrite
            # the start record; destinations cancel stale AddingShards.
            tr.set(
                sk.key_servers_key(begin),
                sk.encode_key_servers(team, dest_team, e),
            )
            return ("drive", e)

        state, e = await self.db.run(start)
        if state == "done":
            return

        await self._wait_fetched(begin, e, dest_team, poll_interval, max_polls)

        async def finish(tr):
            tr.options["access_system_keys"] = True
            tr.options["lock_aware"] = True
            raw = await tr.get(sk.key_servers_key(begin))
            if raw is None:
                raise ValueError(f"shard {begin!r} vanished mid-move")
            _team, dest, e2 = sk.decode_key_servers(raw)
            if set(dest) != set(dest_team):
                raise ValueError(f"move of {begin!r} superseded")
            tr.set(
                sk.key_servers_key(begin),
                sk.encode_key_servers(dest_team, [], e2),
            )

        await self.db.run(finish)

    async def _wait_fetched(self, begin: bytes, end: bytes, dest_team: List[str],
                            poll_interval: float, max_polls: int):
        req = GetShardStateRequest(begin=begin, end=end)
        for _ in range(max_polls):
            states = []
            for sid in dest_team:
                iface = self.storages.get(sid)
                if iface is None:
                    states.append("unknown")
                    continue
                try:
                    states.append(
                        await iface.get_shard_state.get_reply(
                            self.db.process, req
                        )
                    )
                except FdbError:
                    states.append("unreachable")
            if all(s in ("fetched", "readable") for s in states):
                return
            if "missing" in states:
                # The destination lost the in-flight move (crash): restart
                # it by rewriting the startMove record — AND the serverList
                # entries, because a destination that rejoined fresh at the
                # current version never saw the original serverList writes
                # and cannot resolve its fetch sources without them (ref:
                # the serverListKeys rows re-read by fetchKeys).  Read
                # in-txn: a superseding move between poll and rewrite must
                # not be clobbered with this attempt's stale record.
                async def restart(tr):
                    tr.options["access_system_keys"] = True
                    tr.options["lock_aware"] = True
                    raw = await tr.get(sk.key_servers_key(begin))
                    if raw is None:
                        return
                    team, dest, e2 = sk.decode_key_servers(raw)
                    if not dest:
                        return
                    for sid in set(team) | set(dest):
                        iface = self.storages.get(sid)
                        if iface is not None:
                            tr.set(
                                sk.server_list_key(sid),
                                sk.encode_server_entry(iface),
                            )
                    tr.set(
                        sk.key_servers_key(begin),
                        sk.encode_key_servers(team, dest, e2),
                    )

                await self.db.run(restart)
            await self.loop.delay(poll_interval)
        raise TimeoutError(f"shard [{begin!r}, {end!r}) never became fetched")

    async def spread_evenly(self, split_points: Optional[List[bytes]] = None,
                            replication: int = 1):
        """Partition the USER keyspace across all registered storages: split
        at fixed byte boundaries (or given points) and round-robin TEAMS of
        `replication` consecutive storages (ref: DDTeamCollection building
        storage teams per policy, DataDistribution.actor.cpp:493).  The
        system keyspace (\xff...) stays on its current owner.  The dynamic,
        byte-sample-driven rebalancer replaces this once storage metrics
        exist (ref: DataDistributionTracker byte samples)."""
        ids = sorted(self.storages)
        if len(ids) < 2:
            return
        replication = min(replication, len(ids))
        if split_points is None:
            n = len(ids)
            split_points = [bytes([256 * i // n]) for i in range(1, n)]
        for p in split_points:
            await self.split(p)
        await self.split(b"\xff")  # keep the system keyspace its own shard
        shards = [
            (b, e, team) for b, e, team, dest in await self.read_shard_map()
            if not dest and b < b"\xff"
        ]
        for i, (b, _e, team) in enumerate(shards):
            target = [ids[(i + r) % len(ids)] for r in range(replication)]
            if set(team) != set(target):
                await self.move(b, target)

    async def process_exclusions(
        self, replacement_id: Optional[str] = None, tlogs: list = None
    ) -> list:
        """Apply operator exclusions (ref: DD reacting to
        excludedServersKeys — excluded servers are treated like failed
        ones): move every excluded server's shards to its teammates (or the
        replacement), and when `tlogs` interfaces are given, unregister the
        excluded server's log tag so its PERSISTED pop floor stops holding
        the logs' discard floor.  Returns the ids acted on."""
        from ..client.management import get_excluded_servers
        from .interfaces import TLogPopRequest

        excluded = await get_excluded_servers(self.db)
        acted = []
        # One authoritative map read serves every membership check; heal()
        # re-reads for itself, so refresh only after an actual heal.
        shard_map = await self.read_shard_map()
        for sid in excluded:
            in_map = any(
                sid in set(dest or team)
                for _b, _e, team, dest in shard_map
            )
            if not in_map:
                continue
            await self.heal(sid, replacement_id)
            shard_map = await self.read_shard_map()
            for tl in tlogs or []:
                await tl.pop.get_reply(
                    self.db.process,
                    TLogPopRequest(tag=sid, unregister=True),
                )
            acted.append(sid)
        return acted

    async def _team_metrics(self, begin, end, team):
        """One team member's byte-sample metrics for a range, or None when
        no member is reachable (shared by the split and merge trackers)."""
        from .interfaces import GetStorageMetricsRequest

        members = [sid for sid in team if sid in self.storages]
        if not members:
            return None
        try:
            return await self.storages[members[0]].get_storage_metrics.get_reply(
                self.db.process,
                GetStorageMetricsRequest(
                    begin=begin, end=end if end is not None else b""
                ),
            )
        except FdbError:
            return None

    async def auto_split(self, max_shard_bytes: int) -> list:
        """One split round driven by the storages' byte samples (ref:
        DataDistributionTracker shard-size tracking + splitting,
        DataDistributionTracker.actor.cpp): every shard whose sampled bytes
        exceed the threshold splits at the key holding ~half its weight.
        Returns the split keys applied."""
        applied = []
        for b, e, team, dest in await self.read_shard_map():
            if dest:
                continue  # mid-move; split() cannot rewrite a move record
            m = await self._team_metrics(b, e, team)
            if m is None:
                continue
            if m.bytes <= max_shard_bytes or m.split_key is None:
                continue
            if m.split_key <= b or (e is not None and m.split_key >= e):
                continue
            await self.split(m.split_key)
            applied.append(m.split_key)
        return applied

    async def auto_merge(self, min_shard_bytes: int) -> list:
        """One merge round: ADJACENT shards owned by the SAME settled team
        whose combined sampled bytes stay under the threshold coalesce into
        one keyServers record (ref: shard merging when sizes fall below
        SHARD_MIN_BYTES_PER_KSECOND territory —
        DataDistributionTracker.actor.cpp's brokenPromiseToNever merge
        path).  Never merges across the system-keyspace boundary or into
        in-flight moves.  Returns the begin keys of absorbed shards."""
        async def sampled(b, e, team):
            m = await self._team_metrics(b, e, team)
            return None if m is None else m.bytes

        absorbed = []
        shard_map = await self.read_shard_map()
        i = 0
        carry = None  # (index, bytes): the previous right shard's sample
        while i + 1 < len(shard_map):
            b1, e1, t1, d1 = shard_map[i]
            b2, e2, t2, d2 = shard_map[i + 1]
            if (
                d1
                or d2
                or e1 != b2
                or set(t1) != set(t2)
                or b2 >= b"\xff"  # never absorb across/into system space
                # end=None means "through the end of the keyspace" — past
                # the system boundary by definition.
                or ((e2 is None or e2 > b"\xff") and b1 < b"\xff")
            ):
                i += 1
                continue
            # Each shard is measured once per round: the right-hand sample
            # carries forward as the next iteration's left-hand one.
            if carry is not None and carry[0] == i:
                s1 = carry[1]
            else:
                s1 = await sampled(b1, e1, t1)
            s2 = await sampled(b2, e2, t2)
            carry = (i + 1, s2)
            if s1 is None or s2 is None or s1 + s2 > min_shard_bytes:
                i += 1
                continue

            async def merge_txn(tr, b1=b1, b2=b2):
                tr.options["access_system_keys"] = True
                tr.options["lock_aware"] = True
                # Re-validate in-txn (a concurrent move/split between the
                # sampling reads and this commit must abort the merge, not
                # be overwritten).
                raw1 = await tr.get(sk.key_servers_key(b1))
                raw2 = await tr.get(sk.key_servers_key(b2))
                if raw1 is None or raw2 is None:
                    return False
                t1x, d1x, e1x = sk.decode_key_servers(raw1)
                t2x, d2x, e2x = sk.decode_key_servers(raw2)
                if d1x or d2x or e1x != b2 or set(t1x) != set(t2x):
                    return False
                # One record covers the union; the boundary record clears.
                tr.set(
                    sk.key_servers_key(b1),
                    sk.encode_key_servers(list(t1x), [], e2x),
                )
                tr.clear(sk.key_servers_key(b2))
                return True

            if not await self.db.run(merge_txn):
                i += 1
                carry = None
                continue
            absorbed.append(b2)
            # The merged shard may merge again with its next neighbor.
            shard_map = await self.read_shard_map()
            carry = None  # indexes changed; stale samples must not carry
        return absorbed

    async def heal(self, dead_id: str, replacement_id: Optional[str] = None):
        """Re-replicate every shard that lists a dead storage: survivors
        stay the fetch sources, a replacement (or nothing, dropping to a
        smaller team) joins (ref: teamTracker reacting to failures,
        DataDistribution.actor.cpp:1237).  Requires replication >= 2 for
        shards whose only copy died."""
        for b, _e, team, dest in await self.read_shard_map():
            members = set(dest or team)
            if dead_id not in members:
                continue
            survivors = [s for s in (dest or team) if s != dead_id]
            if not survivors:
                raise RuntimeError(
                    f"shard at {b!r}: sole replica {dead_id} died; data lost"
                )
            new_team = list(survivors)
            if replacement_id and replacement_id not in new_team:
                new_team.append(replacement_id)
            await self.move(b, new_team)
