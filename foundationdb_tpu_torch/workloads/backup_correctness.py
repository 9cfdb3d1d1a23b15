"""BackupAndRestoreCorrectness: continuous backup under chaos, verified
by restore.

The port's own copy of the reference package's ``workloads/backup_correctness.py``.

Ref: fdbserver/workloads/BackupAndRestoreCorrectness.actor.cpp — a backup
runs WHILE other workloads mutate and chaos injectors clog/kill; at check
time the container is restored and the restored image must equal the live
database byte for byte (restoring at the fully-tailed version reproduces
the present state; intermediate targets are the PITR tests' business).
Composes with CycleWorkload et al: list this workload FIRST so its
restore completes before their own checks re-validate the (identical)
restored state.
"""

from __future__ import annotations

from .base import TestWorkload


class BackupCorrectnessWorkload(TestWorkload):
    name = "backup_correctness"

    def __init__(self, path: str = "bk_corr", duration: float = 2.0):
        self.path = path
        self.duration = duration
        self.agent = None
        self.restored_rows = -1

    async def setup(self, db, cluster):
        from ..fileio import SimFileSystem
        from ..layers.backup import ContinuousBackupAgent, open_container

        fs = getattr(cluster, "fs", None) or SimFileSystem(cluster.net)
        container = open_container(
            self.path, fs, cluster.net.process(f"bk:{self.path}")
        )
        self.agent = ContinuousBackupAgent(
            db,
            fs,
            [t.interface() for t in cluster.tlogs],
            container,
            tag=f"_backup/{self.path}",
        )
        await self.agent.start()

    async def start(self, db, cluster):
        loop = cluster.loop
        task = db.process.spawn(self.agent.run(), f"bkc:{self.path}")
        await loop.delay(self.duration)
        # Keep tailing until check() — chaos may still be running.
        self._task = task

    async def check(self, db, cluster) -> bool:
        loop = cluster.loop
        # Drain the tail to quiescence: two consecutive empty pulls.
        self.agent.stopped = True
        empties = 0
        for _ in range(400):
            n = await self.agent.tail_once()
            empties = empties + 1 if n == 0 else 0
            if empties >= 2:
                break
            await loop.delay(0.05)

        async def scan(tr):
            return await tr.get_range(b"", b"\xff", limit=1 << 20)

        before = await db.run(scan)
        await self.agent.restore()  # full restore at logged_through
        after = await db.run(scan)
        self.restored_rows = len(after)
        # Byte-exact: the restored image must reproduce the live state the
        # backup was tailing (ref: the workload's final data comparison).
        return before == after and len(after) > 0
