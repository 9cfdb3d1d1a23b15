"""Deterministic in-process network fabric: the simulator's network.

The port's own copy of the reference package's ``rpc/network.py``
(modelled on fdbrpc/sim2.actor.cpp: ProcessInfo/MachineInfo, the kill
APIs, clogging and Sim2Conn's latency model).  Everything runs on one
EventLoop; "processes" are actor groups, and a send is a delivery
scheduled after a latency drawn from the loop's DeterministicRandom, so a
run replays from its seed.

  - No byte serialization: payloads are deep-copied at send time, which
    gives the isolation serializing gives (no shared mutable state across
    the process boundary).  ``SimNetwork(loop, deep_copy=False)`` hands the
    payload object itself to the receiver, for callers that never mutate
    what they sent.
  - Kills act at delivery: messages to a dead process vanish, and reply
    promises held against it break with broken_promise.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..flow.asyncvar import AsyncVar
from ..flow.error import ActorCancelled, FdbError
from ..flow.eventloop import EventLoop, Task, TaskPriority
from ..flow.trace import TraceEvent


def _trace_task_death(f):
    """Completion observer attached by spawn_observed: errors other than
    cancellation become a trace event instead of vanishing with the
    dropped Task."""
    err = f.error()
    if err is None or isinstance(err, ActorCancelled):
        return
    TraceEvent("SpawnedTaskDied", severity=20).detail(
        "task", getattr(f, "name", "?")
    ).detail("error", repr(err)).log()


@dataclass(frozen=True)
class Endpoint:
    """Addressable receiver: (process address, token). Ref: fdbrpc endpoint
    tokens — a UID keying the receiver map on the destination."""

    address: str
    token: int


class SimMachine:
    """A machine groups processes and shares a failure domain (ref:
    MachineInfo simulator.h:112; machineId in LocalityData)."""

    def __init__(self, network: "SimNetwork", machine_id: str, dc_id: str = "dc0"):
        self.network = network
        self.machine_id = machine_id
        self.dc_id = dc_id
        self.processes: List[SimProcess] = []

    def kill(self):
        for p in list(self.processes):
            p.kill()


class SimProcess:
    """An actor group with an address; the unit of kill/reboot (ref:
    ProcessInfo simulator.h:47)."""

    def __init__(self, network: "SimNetwork", name: str, machine: SimMachine):
        self.network = network
        self.name = name
        self.machine = machine
        self.address = f"{machine.machine_id}:{len(machine.processes)}"
        machine.processes.append(self)
        self.alive = True
        self.excluded = False
        self._endpoints: Dict[int, Callable] = {}
        self._next_token = 1
        self._tasks: List[Task] = []
        # Futures (reply promises) this process is waiting on, keyed by the
        # remote address expected to answer; broken on that process's death.
        self._pending_on: Dict[str, dict] = {}  # addr -> ordered {(<Promise>,<Endpoint>): None}
        network._register(self)

    # -- actor management --
    def spawn(self, coro, name: str = "") -> Task:
        assert self.alive, f"spawn on dead process {self.name}"
        t = self.network.loop.spawn(coro, name=f"{self.name}/{name}")
        self._tasks.append(t)
        self._tasks = [x for x in self._tasks if not x.is_ready()]
        return t

    def spawn_observed(self, coro, name: str = "") -> Task:
        """spawn + death observation, for fire-and-forget actors whose Task
        nobody holds (serve loops, tickers, per-request handlers): an
        FdbError killing such a task otherwise vanishes — the loop only
        surfaces non-FdbError crashes, so a role quietly stops serving
        (the grey-failure wedge fdblint TSK001 polices).  Only
        CANCELLATION is quiet; every other death — broken_promise from a
        closed generation's stream included — emits SpawnedTaskDied by
        design, because "which generation's actor died when" is exactly
        what a recovery post-mortem needs."""
        t = self.spawn(coro, name)
        t.add_callback(_trace_task_death)
        return t

    # -- endpoints --
    def make_endpoint(
        self,
        receiver: Callable,
        token: Optional[int] = None,
        replace: bool = False,
    ) -> Endpoint:
        if token is None:
            token = self._next_token
            self._next_token += 1
        assert replace or token not in self._endpoints, f"token {token} in use"
        self._endpoints[token] = receiver
        return Endpoint(self.address, token)

    def drop_endpoint(self, ep: Endpoint):
        self._endpoints.pop(ep.token, None)

    # -- lifecycle --
    def kill(self):
        """Kill: cancel actors, drop endpoints, break promises held against
        this process (ref: ISimulator::killProcess simulator.h:148)."""
        if not self.alive:
            return
        self.alive = False
        TraceEvent("ProcessKilled").detail("name", self.name).log()
        self._endpoints.clear()
        tasks, self._tasks = self._tasks, []
        for t in tasks:
            if not t.is_ready():
                t.cancel()
        self.network._on_process_death(self)

    def reboot(self):
        """Return to life with a fresh endpoint table; role actors must be
        respawned by the caller (the worker rebooter's job, ref:
        simulatedFDBDRebooter SimulatedCluster.actor.cpp:197)."""
        assert not self.alive
        self.alive = True
        self._endpoints.clear()
        self._pending_on.clear()
        self.network.mark_up(self.address)


class SimNetwork:
    """The fabric: routing, latency, clogs, partitions, kill notification."""

    def __init__(self, loop: EventLoop, *, deep_copy: bool = True):
        self.loop = loop
        self.deep_copy = deep_copy
        self.machines: Dict[str, SimMachine] = {}
        self._procs: Dict[str, SimProcess] = {}
        # (src_ip, dst_ip) -> virtual time until which sends are held
        self._clogged: Dict[Tuple[str, str], float] = {}
        self.failure: Dict[str, AsyncVar] = {}  # address -> AsyncVar[bool up]
        self.messages_sent = 0

    # -- topology --
    def machine(self, machine_id: str, dc_id: str = "dc0") -> SimMachine:
        m = self.machines.get(machine_id)
        if m is None:
            m = SimMachine(self, machine_id, dc_id)
            self.machines[machine_id] = m
        return m

    def process(self, name: str, machine_id: Optional[str] = None) -> SimProcess:
        m = self.machine(machine_id or name)
        return SimProcess(self, name, m)

    def _register(self, p: SimProcess):
        self._procs[p.address] = p
        self.failure.setdefault(p.address, AsyncVar(True))

    def get_process(self, address: str) -> Optional[SimProcess]:
        return self._procs.get(address)

    def is_unreachable(self, address: str) -> bool:
        """True when a send could never be answered: the process is known
        dead (simulation omniscience; the real fabric returns False and
        relies on connection failure)."""
        p = self._procs.get(address)
        return p is None or not p.alive

    # -- latency / fault models --
    def _latency(self) -> float:
        # ref Sim2Conn: a fraction of a millisecond, randomized per packet
        return 0.0001 + 0.0004 * self.loop.rng.random01()

    def clog_pair(self, ip_a: str, ip_b: str, seconds: float):
        """Hold traffic ONE way, ip_a -> ip_b (ref: ISimulator::clogPair
        simulator.h:264 clogs a single direction — asymmetric grey
        failures, where requests arrive but replies stall, are exactly
        the cases symmetric partitions can't reproduce).  Use
        partition_pair for a full bidirectional cut."""
        until = self.loop.now() + seconds
        pair = (ip_a, ip_b)
        self._clogged[pair] = max(self._clogged.get(pair, 0.0), until)

    def partition_pair(self, ip_a: str, ip_b: str, seconds: float):
        """Hold traffic BOTH ways between two machines (two directional
        clogs; the reference composes clogPair both ways for the same
        effect)."""
        self.clog_pair(ip_a, ip_b, seconds)
        self.clog_pair(ip_b, ip_a, seconds)

    def unclog_pair(self, ip_a: str, ip_b: str):
        """Release one pair early, both directions (ref:
        ISimulator::unclogPair)."""
        self._clogged.pop((ip_a, ip_b), None)
        self._clogged.pop((ip_b, ip_a), None)

    def unclog_all(self):
        self._clogged.clear()

    def _clog_release(self, src_ip: str, dst_ip: str) -> float:
        return self._clogged.get((src_ip, dst_ip), 0.0)

    # -- sending --
    def send(self, dst: Endpoint, payload, priority: int = TaskPriority.DefaultEndpoint):
        """Fire-and-forget message to an endpoint; vanishes if the target is
        dead or the endpoint is gone at delivery time (like an unreliable
        packet; reliability is built above via reply promises + retries)."""
        self.messages_sent += 1
        msg = copy.deepcopy(payload) if self.deep_copy else payload
        deliver_at = self.loop.now() + self._latency()
        self._schedule_delivery(dst, msg, deliver_at, priority)

    def send_from(
        self,
        src: SimProcess,
        dst: Endpoint,
        payload,
        priority: int = TaskPriority.DefaultEndpoint,
    ):
        if not src.alive:
            return
        self.messages_sent += 1
        msg = copy.deepcopy(payload) if self.deep_copy else payload
        src_ip = src.machine.machine_id
        dst_ip = dst.address.split(":")[0]
        release = self._clog_release(src_ip, dst_ip)
        deliver_at = max(self.loop.now(), release) + self._latency()
        self._schedule_delivery(dst, msg, deliver_at, priority)

    def _schedule_delivery(self, dst: Endpoint, msg, at: float, priority: int):
        def deliver():
            p = self._procs.get(dst.address)
            if p is None or not p.alive:
                return
            receiver = p._endpoints.get(dst.token)
            if receiver is None:
                # Live process, no such endpoint (e.g. the role died with a
                # reboot in between): answer a request's reply promise with
                # broken_promise, as the reference does for a request to an
                # unknown endpoint token (FlowTransport deliver :430).
                reply_to = getattr(msg, "reply_to", None)
                if reply_to is not None and hasattr(msg, "request"):
                    self._schedule_delivery(
                        reply_to,
                        (True, "broken_promise"),
                        self.loop.now() + self._latency(),
                        priority,
                    )
                return
            receiver(msg)

        self.loop._schedule(priority, deliver, at=at)

    # -- death notification --
    def _on_process_death(self, dead: SimProcess):
        self.failure[dead.address].set(False)
        for p in self._procs.values():
            pending = p._pending_on.pop(dead.address, None)
            if not pending:
                continue
            for promise, reply_ep in pending:
                p.drop_endpoint(reply_ep)  # one-shot endpoint, never answered
                if not promise.is_set():
                    # Deliver after a latency, as a closing connection would.
                    self.loop._schedule(
                        TaskPriority.DefaultEndpoint,
                        lambda pr=promise: (
                            None
                            if pr.is_set()
                            else pr.send_error(FdbError("broken_promise"))
                        ),
                        at=self.loop.now() + self._latency(),
                    )

    def mark_up(self, address: str):
        self.failure[address].set(True)
