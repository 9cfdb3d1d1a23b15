"""TaskBucket: a distributed, leased task queue stored IN the database.

The port's own copy of the reference package's ``layers/taskbucket.py``.

Ref: fdbclient/TaskBucket.{h,actor.cpp} — tasks live in a subspace; an
executor claims one by transactionally moving it from the available space
to the timeout space with a lease deadline (in versions); finishing clears
it; an expired lease makes the task claimable again, and the finisher's
transaction conflicts with any re-claim so exactly one completion wins.
This is the execution substrate for backup/DR agents.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..server.sequencer import VERSIONS_PER_SECOND
from .subspace import Subspace

AVAILABLE = 0  # (priority, uid) -> b""        priority 0 runs before 1
TIMEOUTS = 1  # (deadline_version, uid) -> priority
TASK = 2  # [uid][param] -> value


class Task:
    def __init__(self, uid: bytes, params: Dict[bytes, bytes], deadline: int):
        self.uid = uid
        self.params = params
        self.deadline = deadline

    def __repr__(self):
        return f"Task({self.uid.hex()}, {self.params.get(b'type')!r})"


class TaskBucket:
    def __init__(self, subspace: Subspace, lease_seconds: float = 5.0):
        self.ss = subspace
        self.available = subspace[AVAILABLE]
        self.timeouts = subspace[TIMEOUTS]
        self.tasks = subspace[TASK]
        self.lease_versions = int(
            lease_seconds * VERSIONS_PER_SECOND
        )

    # -- producer side --
    def add(self, tr, params: Dict[bytes, bytes], priority: int = 0) -> bytes:
        """Queue a task (inside the caller's transaction, so task creation
        is atomic with whatever work produced it — the TaskBucket
        property backup correctness leans on)."""
        rng = tr.db.process.network.loop.rng
        uid = rng.random_int(0, 1 << 62).to_bytes(8, "big")
        tr.set(self.available.pack((priority, uid)), b"")
        for k, v in params.items():
            tr.set(self.tasks[uid].pack((k,)), v)
        return uid

    # -- executor side --
    async def claim_one(self, tr) -> Optional[Task]:
        """Claim the best available task: move it to the timeout space with
        a lease deadline (ref: getOne TaskBucket.actor.cpp).  The RYW read
        of the available entry makes two claimants conflict."""
        rows = await tr.get_range(*self.available.range(), limit=1)
        if not rows:
            return await self._reclaim_expired(tr)
        key = rows[0][0]
        priority, uid = self.available.unpack(key)
        tr.clear(key)
        version = await tr.get_read_version()
        deadline = version + self.lease_versions
        tr.set(
            self.timeouts.pack((deadline, uid)), b"%d" % priority
        )
        params = await self._read_params(tr, uid)
        return Task(uid, params, deadline)

    async def _reclaim_expired(self, tr) -> Optional[Task]:
        """An expired lease returns the task to circulation (ref:
        checkTimeouts); claiming it here conflicts with the original
        executor's finish, so a *completed* task never reruns."""
        version = await tr.get_read_version()
        rows = await tr.get_range(
            self.timeouts.range()[0],
            self.timeouts.pack((version,)),
            limit=1,
        )
        if not rows:
            return None
        key, pr = rows[0]
        _old_deadline, uid = self.timeouts.unpack(key)
        tr.clear(key)
        deadline = version + self.lease_versions
        tr.set(self.timeouts.pack((deadline, uid)), pr)
        params = await self._read_params(tr, uid)
        if not params:
            return None  # finished concurrently; our claim will conflict
        return Task(uid, params, deadline)

    async def _read_params(self, tr, uid: bytes) -> Dict[bytes, bytes]:
        rows = await tr.get_range(*self.tasks[uid].range())
        return {self.tasks[uid].unpack(k)[0]: v for k, v in rows}

    def finish(self, tr, task: Task):
        """Complete: clear the task and its lease entry.  Conflicts with
        any reclaim of the same lease (both touch the timeout key)."""
        tr.clear(self.timeouts.pack((task.deadline, task.uid)))
        b, e = self.tasks[task.uid].range()
        tr.clear_range(b, e)

    def extend(self, tr, task: Task, version: int) -> int:
        """Renew the lease from `version` (ref: extendTimeout)."""
        tr.clear(self.timeouts.pack((task.deadline, task.uid)))
        task.deadline = version + self.lease_versions
        tr.set(self.timeouts.pack((task.deadline, task.uid)), b"0")
        return task.deadline

    async def is_empty(self, tr) -> bool:
        avail = await tr.get_range(*self.available.range(), limit=1)
        leased = await tr.get_range(*self.timeouts.range(), limit=1)
        return not avail and not leased


class TaskBucketExecutor:
    """Pull-execute loop: claim a task, run its handler, finish (ref: the
    backup agents' taskBucket->run loops).  `handlers` maps task type ->
    async fn(db, task) -> list of follow-on task param dicts;
    follow-ons are added in the SAME transaction that finishes the task, so
    a chain advances exactly once no matter how executors crash."""

    def __init__(self, db, bucket: TaskBucket, handlers: dict):
        self.db = db
        self.bucket = bucket
        self.handlers = handlers
        self.executed = 0

    async def run_one(self) -> bool:
        async def claim(tr):
            tr.options["access_system_keys"] = True
            return await self.bucket.claim_one(tr)

        task = await self.db.run(claim)
        if task is None:
            return False
        handler = self.handlers[task.params[b"type"].decode()]
        followons = await handler(self.db, task)

        async def fin(tr):
            tr.options["access_system_keys"] = True
            # Re-assert the lease is still ours: the timeout entry must
            # exist exactly as claimed (the read adds the conflict with any
            # reclaim).  Lease lost -> commit nothing; the work re-runs
            # under whoever retook it.
            held = await tr.get(
                self.bucket.timeouts.pack((task.deadline, task.uid))
            )
            if held is None:
                return False
            self.bucket.finish(tr, task)
            for params in followons or []:
                self.bucket.add(tr, params)
            return True

        if await self.db.run(fin):
            self.executed += 1
        return True

    async def run(self, idle_delay: float = 0.1, until_empty: bool = False):
        loop = self.db.process.network.loop
        while True:
            did = await self.run_one()
            if not did:
                if until_empty:
                    async def empty(tr):
                        tr.options["access_system_keys"] = True
                        return await self.bucket.is_empty(tr)

                    if await self.db.run(empty):
                        return
                await loop.delay(idle_delay)
