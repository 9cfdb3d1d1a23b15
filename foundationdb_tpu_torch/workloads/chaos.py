"""Chaos injector workloads: swizzled clogging and machine attrition.

Ref: fdbserver/workloads/RandomClogging.actor.cpp (random pairwise clogs;
the "swizzled" variant clogs a changing subset then releases in reverse),
fdbserver/workloads/MachineAttrition.actor.cpp (kill/reboot machines on a
cadence while invariant workloads run).

The port's own copy of the reference package's ``workloads/chaos.py``.
A resolver's set counts as a device set when it has a device engine
(``ConflictSet._dev``, the reference's ``_jax``).
"""

from __future__ import annotations

from .base import TestWorkload


def revive_worker(cluster, proc):
    """Reboot a killed worker process and re-attach a fresh worker agent.

    Replaces the dead worker in the cluster's bookkeeping: stale
    WorkerServer objects hold FROZEN role instances (e.g. a storage whose
    version never advances again), which would poison any aggregate read
    off cluster.workers (status, quiet_database)."""
    from ..flow.asyncvar import AsyncVar
    from ..server.coordination import monitor_leader
    from ..server.worker import WorkerServer, run_worker_registration

    proc.reboot()
    w = WorkerServer(proc, cluster.fs)
    cluster.workers = [
        x for x in cluster.workers if x.process is not proc
    ] + [w]
    leader_var = AsyncVar(None)
    proc.spawn_observed(
        monitor_leader(proc, getattr(cluster, "coord_set", cluster.coord_ifaces), leader_var),
        "leader_mon",
    )
    proc.spawn(run_worker_registration(w, leader_var), "registration")
    return w


class RandomCloggingWorkload(TestWorkload):
    """Clog random machine pairs for random durations (swizzled: several
    overlapping clogs whose releases interleave).  Half the injections are
    full bidirectional partitions, half one-way clogs — the asymmetric
    grey failures (requests arrive, replies stall) a symmetric-only model
    never exercises."""

    name = "random_clogging"

    def __init__(self, duration: float = 3.0, max_clog: float = 0.4):
        self.duration = duration
        self.max_clog = max_clog

    async def start(self, db, cluster):
        loop = cluster.loop
        rng = loop.rng
        end = loop.now() + self.duration
        machines = sorted(cluster.net.machines)
        while loop.now() < end and len(machines) >= 2:
            i = int(rng.random_int(0, len(machines)))
            j = int(rng.random_int(0, len(machines) - 1))
            if j >= i:
                j += 1
            hold = rng.random01() * self.max_clog
            if rng.coinflip():
                cluster.net.partition_pair(machines[i], machines[j], hold)
            else:
                cluster.net.clog_pair(machines[i], machines[j], hold)
            await loop.delay(0.05 + rng.random01() * 0.2)
        cluster.net.unclog_all()


class DeviceChaosWorkload(TestWorkload):
    """Inject device faults into every resolver's conflict engine while
    the invariant workloads (Cycle, Serializability, ...) run — the
    device-path analog of RandomClogging + Attrition, and composable with
    both.  Random-mode faults fire from BUGGIFY sites
    (``device_fault_<site>``) so the sim-end coverage report names them;
    mid-run a scripted persistent dispatch outage on one victim forces
    the breaker through its full ok -> degraded -> probing -> ok cycle.

    check() validates the degraded-mode invariants, not data (the
    concurrent invariant workloads own that): every breaker transition
    log must be a legal walk of the state machine, and any engine whose
    injector fired must have counted the faults."""

    name = "device_chaos"

    def __init__(
        self,
        duration: float = 3.0,
        fire_probability: float = 0.25,
        outage: bool = True,
    ):
        self.duration = duration
        self.fire_probability = fire_probability
        self.outage = outage
        self.installed: list = []

    def _conflict_sets(self, cluster):
        from ..server.status import role_objects

        out = []
        for r in role_objects(cluster, "resolver"):
            cs = getattr(r, "conflicts", None)
            if cs is not None and getattr(cs, "_dev", None) is not None:
                out.append(cs)
        return out

    async def start(self, db, cluster):
        from ..conflict.device_faults import DeviceFaultInjector

        loop = cluster.loop
        for cs in self._conflict_sets(cluster):
            # Fork the loop rng per injector: the persistence draws replay
            # from the seed without perturbing other sim decisions.
            inj = DeviceFaultInjector(
                rng=loop.rng.split(),
                fire_probability=self.fire_probability,
            )
            cs.install_fault_injector(inj)
            self.installed.append((cs, inj))
        if not self.installed:
            return
        if self.outage:
            await loop.delay(self.duration / 3)
            cs, inj = self.installed[
                int(loop.rng.random_int(0, len(self.installed)))
            ]
            inj.begin_outage("dispatch")
            await loop.delay(self.duration / 3)
            inj.end_outage("dispatch")
            await loop.delay(self.duration / 3)
        else:
            await loop.delay(self.duration)

    async def check(self, db, cluster) -> bool:
        legal = {
            ("ok", "degraded"),
            ("degraded", "probing"),
            ("probing", "ok"),
            ("probing", "degraded"),
        }
        for cs, inj in self.installed:
            cs.install_fault_injector(None)  # stop injecting before checks
            breaker = cs._breaker
            prev = "ok"
            for _seq, frm, to, _reason in breaker.transitions:
                if frm != prev or (frm, to) not in legal:
                    return False
                prev = to
            if inj.injected and not cs._dev.metrics.counter(
                "device_faults"
            ).value:
                return False  # faults raised but never absorbed/counted
        return True


class AttritionWorkload(TestWorkload):
    """Kill a random worker machine (disks crash per the corruption model),
    reboot it, and re-attach its worker agent; repeat.  The cluster must
    recover a new generation each time with zero acked-data loss."""

    name = "attrition"

    def __init__(self, kills: int = 2, delay_between: float = 1.0):
        self.kills = kills
        self.delay_between = delay_between

    async def start(self, db, cluster):
        loop = cluster.loop
        rng = loop.rng
        for _ in range(self.kills):
            await loop.delay(self.delay_between * (0.5 + rng.random01()))
            procs = [p for p in cluster._worker_procs if p.alive]
            if not procs:
                continue
            proc = procs[int(rng.random_int(0, len(procs)))]
            proc.kill()
            cluster.fs.crash_machine(proc.machine.machine_id)
            revive_worker(cluster, proc)
