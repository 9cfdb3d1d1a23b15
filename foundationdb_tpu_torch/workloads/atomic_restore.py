"""AtomicRestore: a restore lands atomically on a LIVE cluster.

The port's own copy of the reference package's ``workloads/atomic_restore.py``.

Ref: fdbserver/workloads/AtomicRestore.actor.cpp — traffic runs, a
backup is taken, MORE traffic runs, then atomicRestore() rewinds the
range on the live cluster.  The checks: (1) every observer transaction
sees either entirely-pre-restore or entirely-post-restore state — the
database lock makes a torn observation impossible (non-lock-aware work
fails database_locked during the flip); (2) after the restore the range
is byte-exact the backup image; (3) traffic resumes normally afterwards.
"""

from __future__ import annotations

from ..flow.error import FdbError
from .base import TestWorkload


class AtomicRestoreWorkload(TestWorkload):
    name = "atomic_restore"

    def __init__(self, rows: int = 60, prefix: bytes = b"ar/"):
        self.rows = rows
        self.prefix = prefix
        self.torn = []
        self.locked_seen = 0

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    async def start(self, db, cluster):
        from ..fileio import SimFileSystem
        from ..layers.backup import ContinuousBackupAgent, BackupContainer

        loop = cluster.loop
        fs = getattr(cluster, "fs", None) or SimFileSystem(cluster.net)

        async def epoch1(tr):
            for i in range(self.rows):
                tr.set(self._key(i), b"epoch1-%d" % i)

        await db.run(epoch1)
        agent = ContinuousBackupAgent(
            db, fs, [t.interface() for t in cluster.tlogs],
            BackupContainer(fs, db.process, "ar_backup"),
        )
        await agent.start(self.prefix, self.prefix + b"\xff")
        await agent.tail_once()

        async def epoch2(tr):
            for i in range(self.rows):
                tr.set(self._key(i), b"epoch2-%d" % i)
            tr.set(self.prefix + b"extra", b"post-backup")

        await db.run(epoch2)

        # Observer: every successful read must be all-epoch1 or
        # all-epoch2 — a mix is a torn restore observation.
        stop = []

        async def observer():
            while not stop:
                tr = db.create_transaction()
                try:
                    # [prefix, prefix+":") covers the %04d keys (":" is
                    # the successor of "9") and excludes the ar/extra and
                    # ar/after sentinels.
                    rows = await tr.get_range(
                        self.prefix, self.prefix + b":"
                    )
                except FdbError as e:
                    if e.name == "database_locked":
                        self.locked_seen += 1
                    await loop.delay(0.005)
                    continue
                epochs = {v.split(b"-")[0] for _k, v in rows}
                if rows:
                    self.observed_scans = getattr(
                        self, "observed_scans", 0
                    ) + 1
                if len(epochs) > 1:
                    self.torn.append(sorted(epochs))
                await loop.delay(0.005)

        obs = db.process.spawn(observer(), "ar_obs")
        await loop.delay(0.2)
        # Tiny batches widen the locked window so the observer
        # demonstrably hits it (the atomicity property under test).
        restored_v = await agent.atomic_restore(batch_rows=5)
        assert restored_v > 0
        stop.append(True)
        # Unconditional await: a ready-but-errored observer must re-raise
        # here, not be silently dropped.
        await obs

        # Post-restore: byte-exact the backup image (epoch1, no extra).
        out = {}

        async def readback(tr):
            out["rows"] = await tr.get_range(self.prefix, self.prefix + b"\xff")

        await db.run(readback)
        want = [(self._key(i), b"epoch1-%d" % i) for i in range(self.rows)]
        assert out["rows"] == want, (
            f"restored range not byte-exact: {out['rows'][:3]} "
            f"({len(out['rows'])} rows vs {len(want)})"
        )

        # Traffic resumes.
        async def after(tr):
            tr.set(self.prefix + b"after", b"ok")

        await db.run(after)

    async def check(self, db, cluster) -> bool:
        assert not self.torn, f"torn restore observations: {self.torn[:3]}"
        out = {}

        async def read(tr):
            out["v"] = await tr.get(self.prefix + b"after")

        await db.run(read)
        return out["v"] == b"ok"
