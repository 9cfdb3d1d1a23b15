"""Rollback: partial-durability partitions that force version rollback.

Ref: fdbserver/workloads/Rollback.actor.cpp — clog the network between a
commit proxy and all TLogs EXCEPT one for `clog_duration`, so in-flight
commits become durable on a non-quorum subset; a third of the way in, clog
the proxy and the one unclogged TLog entirely.  The cluster controller's
failure detector then drives a recovery whose epoch-end computes the
durable prefix WITHOUT the partitioned log — versions durable only on the
minority must roll back, and no acked commit may be lost (the invariant
workloads running alongside, plus sim_validation's durability promises,
check that).

Runs against DynamicCluster (recruited roles + recovery state machine).

The port's own copy of the reference package's ``workloads/rollback.py``.
"""

from __future__ import annotations

from .base import TestWorkload


class RollbackWorkload(TestWorkload):
    name = "rollback"

    def __init__(
        self,
        rounds: int = 1,
        clog_duration: float = 2.0,
        delay_between: float = 3.0,
    ):
        self.rounds = rounds
        self.clog_duration = clog_duration
        self.delay_between = delay_between
        self.triggered = 0

    def _role_machines(self, cluster, role: str):
        return [
            wk.process.machine.machine_id
            for wk in cluster.workers
            if role in wk.roles and wk.process.alive
        ]

    async def start(self, db, cluster):
        loop = cluster.loop
        rng = loop.rng
        for _ in range(self.rounds):
            await loop.delay(self.delay_between * (0.5 + rng.random01()))
            proxies = self._role_machines(cluster, "proxy")
            tlogs = self._role_machines(cluster, "tlog")
            if not proxies or len(tlogs) < 2:
                continue  # rollback needs a minority log to strand
            proxy_m = proxies[int(rng.random_int(0, len(proxies)))]
            ut = int(rng.random_int(0, len(tlogs)))
            unclogged = tlogs[ut]
            if proxy_m == unclogged or proxy_m in tlogs:
                # Shared machine would self-clog (the reference gives up
                # in this case too: "proxy-clogged tLog shared IPs").
                continue
            for i, t in enumerate(tlogs):
                if i != ut:
                    cluster.net.partition_pair(proxy_m, t, self.clog_duration)
            self.triggered += 1
            await loop.delay(self.clog_duration / 3)
            # While the partial partition holds, cut off the proxy and the
            # unclogged tlog from EVERYONE: the recovery that follows must
            # proceed without the only log that saw the stranded commits.
            everyone = sorted(cluster.net.machines)
            for m in everyone:
                if m != proxy_m:
                    cluster.net.partition_pair(proxy_m, m, self.clog_duration)
                if m != unclogged:
                    cluster.net.partition_pair(
                        unclogged, m, self.clog_duration
                    )
            await loop.delay(self.clog_duration * 1.5)
        # Let the cluster settle before checks.
        await loop.delay(2.0)
