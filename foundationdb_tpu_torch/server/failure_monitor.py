"""Cluster-wide failure monitoring: CC-hosted detector, delta broadcast.

Ref: the cluster controller's failure detection
(ClusterController.actor.cpp:1257) pushes delta-compressed
SystemFailureStatus lists to every process, and
fdbclient/FailureMonitorClient.actor.cpp applies them into the local
IFailureMonitor — so clients and peers stop routing to a dead endpoint
WITHOUT first eating a per-request timeout on it.

Rebuild shape: the detector lives on the acting cluster controller (fed by
its worker ping loop); consumers long-poll `failure_monitor` with the last
version they saw and receive either the deltas since then or a full
snapshot (when the bounded history has been trimmed past them).  The
client side (`run_failure_monitor_client`) folds updates into a plain
dict consulted by loadBalance ordering.

The port's own copy of the reference package's ``server/failure_monitor.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from ..flow.asyncvar import AsyncVar
from ..flow.error import FdbError
from ..rpc.stream import RequestStream

HISTORY_LIMIT = 512
LONG_POLL_TIMEOUT = 1.0


@dataclass
class FailureMonitorReply:
    version: int = 0
    full: bool = False  # states is a complete snapshot, not a delta
    states: List[Tuple[str, bool]] = field(default_factory=list)


class FailureDetector:
    """CC-side state + the broadcast stream (delta-compressed)."""

    def __init__(self, process):
        self.process = process
        self.states: Dict[str, bool] = {}  # addr -> failed
        self.version = AsyncVar(0)
        self.history: List[Tuple[int, str, bool]] = []
        self._stream = RequestStream(
            process, "failure_monitor", well_known=True
        )
        process.spawn_observed(self._serve(), "failure_monitor_serve")

    def ref(self):
        return self._stream.ref()

    def set_state(self, addr: str, failed: bool):
        if self.states.get(addr, False) == failed:
            return
        v = self.version.get() + 1
        self.states[addr] = failed
        self.history.append((v, addr, failed))
        if len(self.history) > HISTORY_LIMIT:
            del self.history[: len(self.history) - HISTORY_LIMIT]
        self.version.set(v)

    async def _serve(self):
        from ..flow.eventloop import first_of

        loop = self.process.network.loop
        while True:
            known, reply = await self._stream.pop()
            known = known or 0
            if known >= self.version.get():
                # Long-poll: park until something changes (bounded so a
                # silent cluster still heartbeats liveness to consumers).
                waiter = self.process.spawn(
                    self._wait_change(known), "fm_wait"
                )
                await first_of(waiter, loop.delay(LONG_POLL_TIMEOUT))
                if not waiter.is_ready():
                    waiter.cancel()
            v = self.version.get()
            oldest = self.history[0][0] if self.history else v + 1
            if known + 1 >= oldest:
                deltas = [
                    (addr, failed)
                    for hv, addr, failed in self.history
                    if hv > known
                ]
                reply.send(FailureMonitorReply(version=v, states=deltas))
            else:
                # History trimmed past this consumer: full snapshot.
                reply.send(
                    FailureMonitorReply(
                        version=v,
                        full=True,
                        states=sorted(self.states.items()),
                    )
                )

    async def _wait_change(self, known: int):
        while self.version.get() <= known:
            await self.version.on_change()


async def run_failure_monitor_client(db):
    """Client/peer-side actor: keep `db.failure_states` current from the
    acting CC's detector (ref: failureMonitorClientLoop,
    FailureMonitorClient.actor.cpp).  Re-resolves the stream ref from
    ClientDBInfo each round so CC failover is transparent."""
    loop = db.process.network.loop
    known = 0
    while True:
        info = db.info_var.get() if db.info_var is not None else None
        fm = getattr(info, "failure_monitor", None) if info else None
        if fm is None:
            await loop.delay(0.25)
            continue
        try:
            rep = await fm.get_reply(db.process, known)
        except FdbError:
            # CC died: forget refs, wait for the next generation's info.
            known = 0
            await loop.delay(0.25)
            continue
        if rep.full:
            db.failure_states.clear()
        for addr, failed in rep.states:
            db.failure_states[addr] = failed
        known = rep.version
