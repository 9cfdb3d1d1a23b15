"""Disaster recovery: continuous replication into a SECOND cluster.

The port's own copy of the reference package's ``layers/dr.py``.

Ref: fdbclient/DatabaseBackupAgent.actor.cpp — DR copies a source cluster
into a destination cluster by shipping the mutation stream; the
destination applies each source version atomically, so it is at every
moment a consistent (possibly older) snapshot of the source.  The agent
here plays the LogRouter/backup-worker part directly: it registers a
consumer tag on the source's logs (holding their discard floor, like a
storage), takes an initial range snapshot, then tails the log and applies
each version's user-keyspace mutations to the destination in one
transaction.

Multi-log sources ride a MergePeekCursor over the tag-partitioned log
set (ref: the merged peek cursors DatabaseBackupAgent's log workers use);
single-log sources are just the 1-wide case.
"""

from __future__ import annotations

from typing import List, Optional

from ..client.types import MutationType, key_after
from ..flow.error import FdbError
from ..server.interfaces import TLogPopRequest

DR_TAG = "_dr"
SNAPSHOT_PAGE = 1000
# Destination-side progress marker: every apply transaction reads it and
# writes the new version, making replay idempotent under blind retries
# after commit_unknown_result AND resumable across agent restarts (ref:
# the apply-version bookkeeping DatabaseBackupAgent keeps in the
# destination).
DR_APPLIED_KEY = b"\xff/dr/applied"
# b"syncing" while the initial snapshot is (re)building the destination —
# consumers must treat the data as invalid until it returns to b"tailing"
# (ref: the destination lock DatabaseBackupAgent holds during the initial
# range copy).
DR_STATE_KEY = b"\xff/dr/state"


class DRAgent:
    def __init__(self, src_db, dst_db, src_tlogs: List, tag: str = DR_TAG):
        self.src_db = src_db
        self.dst_db = dst_db
        self.tlogs = list(src_tlogs)
        self.tag = tag
        self.applied = 0  # source version the destination reflects
        self._storage_tags: List[str] = []
        self._cursor = None  # MergePeekCursor, (re)built on tag changes
        self.stopped = False

    async def start(self, skip_snapshot_from: Optional[int] = None) -> int:
        """Register the consumer floor, then copy the initial snapshot.
        Registration happens FIRST so nothing the snapshot misses can be
        discarded before tailing begins (ref: the backup range lock before
        the initial snapshot).

        skip_snapshot_from=V skips the copy entirely: the caller certifies
        the destination ALREADY equals the source as of source-version V
        (the atomic-switchover contract — both sides locked and drained;
        ref: atomicSwitchover avoiding a recopy)."""
        proc = self.src_db.process
        await self._pop_all(0)
        await self._refresh_tags()
        if skip_snapshot_from is not None:
            self.applied = skip_snapshot_from
            await self._mark_applied(skip_snapshot_from, state=b"tailing")
            await self._pop_all(skip_snapshot_from)
            return skip_snapshot_from
        # Resume: a previous incarnation that finished its snapshot left
        # applied/state markers, and its pop floor is PERSISTED on the
        # source logs, so the stream since then is still retained — tail
        # from the marker instead of re-copying everything.
        resume = await self._read_progress()
        if resume is not None:
            self.applied = resume
            await self._pop_all(resume)
            return resume
        # Snapshot at one source read version (pages share it; a too-old
        # snapshot restarts fresh, same discipline as the file backup).
        while True:
            tr = self.src_db.create_transaction()
            tr.options["lock_aware"] = True
            version = await tr.get_read_version()
            try:
                await self._copy_snapshot(tr, version)
                break
            except FdbError as e:
                if e.name != "transaction_too_old":
                    raise
        self.applied = version
        await self._mark_applied(version, state=b"tailing")
        await self._pop_all(version)
        return version

    async def _pop_all(self, version: int, unregister: bool = False):
        proc = self.src_db.process
        for tl in self.tlogs:
            await tl.pop.get_reply(
                proc,
                TLogPopRequest(
                    version=version, tag=self.tag, unregister=unregister
                ),
            )

    async def _read_progress(self) -> Optional[int]:
        async def txn(tr):
            tr.options["access_system_keys"] = True
            tr.options["lock_aware"] = True
            state = await tr.get(DR_STATE_KEY)
            raw = await tr.get(DR_APPLIED_KEY)
            if state == b"tailing" and raw is not None:
                return int(raw)
            return None

        return await self.dst_db.run(txn)

    async def _mark_applied(self, version: int, state: bytes = None):
        async def txn(tr):
            tr.options["access_system_keys"] = True
            tr.options["lock_aware"] = True
            tr.set(DR_APPLIED_KEY, b"%d" % version)
            if state is not None:
                tr.set(DR_STATE_KEY, state)

        await self.dst_db.run(txn)

    async def _refresh_tags(self):
        """Discover the source's per-storage tags from \xff/serverList/
        (sharded sources tag user mutations per storage, not with the
        default tag)."""
        from ..server import system_keys as sk

        async def txn(tr):
            tr.options["access_system_keys"] = True
            tr.options["lock_aware"] = True
            rows = await tr.get_range(
                sk.SERVER_LIST_PREFIX, sk.SERVER_LIST_END
            )
            return [sk.server_list_id(k) for k, _v in rows]

        fresh = await self.src_db.run(txn)
        if set(fresh) - set(self._storage_tags):
            self._cursor = None  # widened tag set: rebuild from `applied`
        self._storage_tags = sorted(set(self._storage_tags) | set(fresh))

    async def _copy_snapshot(self, tr, version: int):
        # Mark the destination INVALID for the whole multi-transaction
        # copy (cleared back to "tailing" only when it completes), then
        # wipe so the result IS the snapshot.
        async def wipe(d):
            d.options["access_system_keys"] = True
            d.set(DR_STATE_KEY, b"syncing")
            d.clear_range(b"", b"\xff")

        await self.dst_db.run(wipe)
        lo = b""
        while True:
            rows = await tr.get_range(
                lo, b"\xff", limit=SNAPSHOT_PAGE, snapshot=True
            )

            async def put(d, rows=rows):
                for k, v in rows:
                    d.set(k, v)

            if rows:
                await self.dst_db.run(put)
            if len(rows) < SNAPSHOT_PAGE:
                return
            lo = key_after(rows[-1][0])

    def _get_cursor(self):
        """The merge cursor over every source log for the current tag set;
        rebuilt (from `applied`) whenever the tag set widens — or whenever
        the cursor ran ahead of `applied` (a tail_once that raised or was
        cancelled mid-batch): reusing it would silently skip the versions
        in (applied, cursor.begin]."""
        from ..rpc.peek_cursor import MergePeekCursor

        if self._cursor is not None and self._cursor.begin != self.applied:
            self._cursor = None
        if self._cursor is None:
            self._cursor = MergePeekCursor(
                self.src_db.process,
                self.tlogs,
                tags=self._tags(),
                begin=self.applied,
                limit_versions=64,
            )
        return self._cursor

    async def tail_once(self) -> int:
        """Pull the merged source stream past `applied` and apply each
        version's user-keyspace mutations to the destination in ONE
        transaction (the prefix-consistency guarantee).  Returns versions
        applied."""
        before = self.applied
        cursor = self._get_cursor()
        entries, horizon = await cursor.next_batch()
        n = 0
        new_tag = False
        for version, bundle in entries:
            if version <= self.applied:
                continue
            mutations = cursor.flatten(bundle)
            from ..client.types import ATOMIC_TYPES
            from ..server import system_keys as sk

            # In-stream tag discovery: a storage registration rides the
            # broadcast tag, and any mutation tagged ONLY with the new
            # storage can exist at later versions only (routing to it
            # requires keyServers commits after the registration) — so
            # adding the tag before peeking past this version closes the
            # new-storage race without polling.
            for m in mutations:
                if (
                    m.type == MutationType.SET_VALUE
                    and m.param1.startswith(sk.SERVER_LIST_PREFIX)
                ):
                    sid = sk.server_list_id(m.param1)
                    if sid not in self._storage_tags:
                        self._storage_tags.append(sid)
                        new_tag = True
            user = [m for m in mutations if m.param1 < b"\xff"]

            async def apply(d, user=user, version=version):
                # Idempotence fence: a blind retry after a lost commit
                # reply (commit_unknown_result) re-reads the progress
                # marker and no-ops if this version already applied.
                d.options["access_system_keys"] = True
                d.options["lock_aware"] = True
                raw = await d.get(DR_APPLIED_KEY)
                if raw is not None and int(raw) >= version:
                    return
                for m in user:
                    if m.type == MutationType.SET_VALUE:
                        d.set(m.param1, m.param2)
                    elif m.type == MutationType.CLEAR_RANGE:
                        d.clear_range(m.param1, min(m.param2, b"\xff"))
                    elif m.type in ATOMIC_TYPES:
                        # Replaying the op against the (identical) prefix
                        # state yields the identical result (ref: mutation
                        # log application in applyMutations).
                        d.atomic_op(m.type, m.param1, m.param2)
                d.set(DR_APPLIED_KEY, b"%d" % version)

            if user:
                await self.dst_db.run(apply)
            self.applied = version  # fdblint: ignore[RACE004]: applied is owned by the single tail loop; start() writes it only before spawning the loop (phase-ordered, never concurrent)
            n += 1
            if new_tag:
                # Later versions in THIS batch may be missing the new
                # tag's bundles: rebuild the cursor from `applied` with
                # the widened tag set.
                self._cursor = None
                break
        # The merged horizon is known-complete — safe to adopt even
        # mid-backlog: versions below it carrying none of our tags would
        # otherwise wedge the window forever.
        if not new_tag and horizon > self.applied:
            self.applied = horizon
        if self.applied > before:
            await self._pop_all(self.applied)
        return n

    def _tags(self) -> List[str]:
        """Every tag carrying user mutations: the defaults plus the
        storage tags discovered from the source's serverList.  On a single
        log, the union of all tags is the full stream."""
        from ..server.interfaces import TAG_ALL, TAG_DEFAULT

        return [TAG_DEFAULT, TAG_ALL] + list(self._storage_tags)

    async def run(self, poll: float = 0.02, tag_refresh: float = 1.0):
        loop = self.src_db.process.network.loop
        last_refresh = -1e18
        self._running = True
        try:
            while not self.stopped:
                if loop.now() - last_refresh > tag_refresh:
                    await self._refresh_tags()
                    last_refresh = loop.now()
                n = await self.tail_once()
                if n == 0:
                    await loop.delay(poll)
        finally:
            self._running = False

    async def abort(self) -> None:
        """fdbdr abort (ref: DatabaseBackupAgent::abortBackup; the
        BackupToDBAbort workload asserts this contract): stop tailing,
        release the source-side consumer floor (unregister — the logs
        must not retain forever for a dead DR), and mark the destination
        state aborted.  The destination KEEPS its data — a consistent
        prefix of the source (every apply was one whole source version
        batch) — and is immediately usable for ordinary writes."""
        loop = self.src_db.process.network.loop
        self.stopped = True
        # Wait out an in-flight tail_once in the run() loop (same
        # discipline as switchover): aborting mid-apply is fine, aborting
        # mid-bookkeeping would race the state marker write below.
        while getattr(self, "_running", False):
            await loop.delay(0.01)
        await self._pop_all(self.applied, unregister=True)
        await self._mark_applied(self.applied, state=b"aborted")

    async def switchover(self, reverse_tlogs: List) -> "DRAgent":
        """fdbdr switch (ref: DatabaseBackupAgent::atomicSwitchover):

          1. lock the SOURCE (no new primary writes),
          2. lock the DESTINATION (freeze it while direction flips),
          3. drain the remaining stream — the two databases are now equal,
          4. start the REVERSE agent with NO recopy (skip_snapshot_from at
             the frozen destination's version),
          5. unlock the destination: it is the new primary; the old
             primary STAYS locked as the replica (the reference keeps DR
             destinations locked; every agent transaction is lock-aware).

        Returns the running-direction-reversed agent; this agent stops."""
        from ..client.management import lock_database, unlock_database

        loop = self.src_db.process.network.loop
        self.stopped = True
        # WAIT for the spawned run() loop to actually exit: a tail_once
        # in flight there shares this cursor — racing it could adopt a
        # horizon past a version whose mutations the other coroutine is
        # still holding, silently dropping them right before we certify
        # equality.
        while getattr(self, "_running", False):
            await loop.delay(0.01)

        src_uid = await lock_database(self.src_db)
        self.switch_lock_uid = src_uid
        dst_uid = None
        try:
            tr = self.src_db.create_transaction()
            tr.options["lock_aware"] = True
            final_v = await tr.get_read_version()
            dst_uid = await lock_database(self.dst_db)
            while self.applied < final_v:
                n = await self.tail_once()
                if n == 0:
                    await loop.delay(0.02)

            rev = DRAgent(
                self.dst_db, self.src_db, reverse_tlogs,
                tag=self.tag + "_rev",
            )
            tr2 = self.dst_db.create_transaction()
            tr2.options["lock_aware"] = True
            dest_v = await tr2.get_read_version()
            await rev.start(skip_snapshot_from=dest_v)
        except BaseException:
            # Unwind: the primary must not stay locked behind a failed
            # switch (the caller may restart run() and retry later).
            try:
                if dst_uid is not None:
                    await unlock_database(self.dst_db, dst_uid)
            finally:
                await unlock_database(self.src_db, src_uid)
                self.stopped = False
            raise
        # Release the forward consumer tag: its pop floor is frozen at the
        # drained version and would otherwise retain every post-switch
        # mutation on the old primary's logs forever.
        await self._pop_all(self.applied, unregister=True)
        await unlock_database(self.dst_db, dst_uid)
        return rev

    def set_storage_tags(self, tags: List[str]):
        """Manual override for tests; run() refreshes from serverList."""
        self._storage_tags = list(tags)
