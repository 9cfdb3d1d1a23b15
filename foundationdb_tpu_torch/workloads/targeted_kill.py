"""TargetedKill: destroy the machine hosting a SPECIFIC role, mid-load.

Ref: fdbserver/workloads/TargetedKill.actor.cpp — instead of random
attrition, kill the process serving a named role (proxy, tlog, storage,
the controller) at a chosen time; the cluster must recover a new
generation and every concurrent invariant workload must still check.
Targeting matters because each role exercises a different recovery path
(proxy: commit pipeline re-recruitment; tlog: epoch end + log recovery;
storage: team healing / replica routing; cc: re-election).

The port's own copy of the reference package's ``workloads/targeted_kill.py``.
"""

from __future__ import annotations

from .base import TestWorkload


class TargetedKillWorkload(TestWorkload):
    name = "targeted_kill"

    def __init__(self, role: str = "storage0", at: float = 0.5,
                 reboot: bool = True):
        self.role = role
        self.at = at
        self.reboot = reboot
        self.killed = False

    async def start(self, db, cluster):
        from .chaos import revive_worker

        loop = cluster.loop
        await loop.delay(self.at)
        try:
            proc = cluster.kill_role_process(self.role)
        except (KeyError, RuntimeError):
            # Role not recruited under this topology, or no controller is
            # leader at kill time (mid-election): nothing to target.
            return
        self.killed = True
        cluster.fs.crash_machine(proc.machine.machine_id)
        if self.reboot:
            revive_worker(cluster, proc)

    async def check(self, db, cluster) -> bool:
        # The cluster must serve a fresh write+read after the kill.
        async def probe(tr):
            tr.set(b"tk_probe/" + self.role.encode(), b"recovered")

        await db.run(probe)
        out = {}

        async def read(tr):
            out["v"] = await tr.get(b"tk_probe/" + self.role.encode())

        await db.run(read)
        return out["v"] == b"recovered"
