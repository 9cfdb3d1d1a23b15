"""Coordinators: replicated generation register + leader election.

Ref: fdbserver/Coordination.actor.cpp — localGenerationReg :125 (per-key
(value, readGen, writeGen) with generation promises), leaderRegister :203
(candidacy/nominee/heartbeat), CoordinatedState.actor.cpp (quorum
read/write with coordinated_state_conflict), LeaderElection.actor.cpp
(tryBecomeLeader), fdbclient/MonitorLeader.actor.cpp (majority-nominee
polling).

The rebuild keeps the protocol essence on the deterministic fabric:

  - generation register: read(key, gen) promises not to accept older
    writes; write(key, value, gen) succeeds iff gen >= every promised gen
  - quorum client: read from a majority, take the value with the highest
    write generation; write to a majority at a higher generation or fail
    with coordinated_state_conflict
  - leader register: leases; nominee = lowest (priority, change_id) among
    live candidates; candidates poll and hold a majority to lead

All timing is virtual; elections are seed-reproducible.

The port's own copy of the reference package's ``server/coordination.py``.
The generation registers persist through the port's ``fileio`` simulated
files.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..flow.asyncvar import AsyncVar
from ..flow.error import FdbError
from ..flow.eventloop import all_of, first_of, timeout_after
from ..rpc.network import SimProcess
from ..rpc.stream import RequestStream, RequestStreamRef

CANDIDATE_TTL = 2.0
NOMINEE_TICK = 0.5
POLL_INTERVAL = 0.5


@dataclass(frozen=True, order=True)
class LeaderInfo:
    """Candidate identity; lower sorts first and wins nomination (ref:
    LeaderInfo operator< — priority then changeID)."""

    priority: int
    change_id: int
    address: str = field(compare=False, default="")
    payload: object = field(compare=False, default=None)


# A generation is (counter, salt): totally ordered, unique per session
# (ref: UniqueGeneration(generation, uid), CoordinationInterface.h).
ZERO_GEN = (0, 0)

# Registry key persisting a retired coordinator's forward pointer.
FORWARD_KEY = b"\xff/forward"


@dataclass
class GenReadRequest:
    key: bytes
    gen: tuple  # the reader's unique generation (plants the read promise)


@dataclass
class GenReadReply:
    value: Optional[bytes]
    write_gen: tuple
    read_gen: tuple


@dataclass
class GenWriteRequest:
    key: bytes
    value: bytes
    gen: tuple


@dataclass
class CandidacyRequest:
    key: bytes
    info: LeaderInfo
    known_nominee: Optional[int]  # change_id the candidate last saw


@dataclass
class CoordinatorInterface:
    gen_read: RequestStreamRef = None
    gen_write: RequestStreamRef = None
    candidacy: RequestStreamRef = None
    get_leader: RequestStreamRef = None
    set_forward: RequestStreamRef = None


def coordinator_interface_at(address: str) -> CoordinatorInterface:
    """Interface for the coordinator at `address` from its well-known
    tokens alone — how a process reaches coordinators it only knows from a
    cluster-file line (ref: the WLTOKEN_* constants,
    CoordinationInterface.h)."""
    from ..rpc.stream import well_known_token
    from ..rpc.network import Endpoint

    def ref(name: str) -> RequestStreamRef:
        return RequestStreamRef(Endpoint(address, well_known_token(name)), name)

    return CoordinatorInterface(
        gen_read=ref("coord_gen_read"),
        gen_write=ref("coord_gen_write"),
        candidacy=ref("coord_candidacy"),
        get_leader=ref("coord_get_leader"),
        set_forward=ref("coord_set_forward"),
    )


class CoordinatorSet:
    """The mutable "cluster file": the coordinator addresses a process
    currently believes in.  Election/monitor actors re-read it every round,
    so a quorum change retargets them without restarts (ref: the connection
    file rewrite in MonitorLeader.actor.cpp when coordinators forward)."""

    def __init__(self, addresses: List[str],
                 interfaces: Optional[List[CoordinatorInterface]] = None):
        self.addresses = list(addresses)
        self.interfaces = (
            list(interfaces)
            if interfaces is not None
            else [coordinator_interface_at(a) for a in addresses]
        )
        self.changes = 0

    def retarget(self, addresses: List[str]):
        if list(addresses) == self.addresses:
            return
        self.addresses = list(addresses)
        self.interfaces = [coordinator_interface_at(a) for a in addresses]
        self.changes += 1


def _resolve_coords(coordinators) -> List[CoordinatorInterface]:
    """Accept a plain interface list (legacy call sites) or a
    CoordinatorSet (retargetable)."""
    if isinstance(coordinators, CoordinatorSet):
        return coordinators.interfaces
    return coordinators


# A forwarded coordinator nominates this pseudo-leader: priority makes it
# win min() immediately, the shared change_id makes the majority count
# converge, and the payload carries the new addresses (ref: ForwardRequest,
# Coordination.actor.cpp — "the cluster key is now served elsewhere").
FORWARD_PRIORITY = -(1 << 40)


def _forward_info(addrs: List[str]) -> LeaderInfo:
    import zlib

    blob = b",".join(a.encode() for a in addrs)
    return LeaderInfo(
        priority=FORWARD_PRIORITY,
        change_id=zlib.crc32(blob),
        payload={"moved_to": list(addrs)},
    )


class Coordinator:
    """One coordinator process: generation register + leader register.

    With `fs`, the generation register (values AND promises) is persisted
    through the durable storage stack before any reply (ref: localGenerationReg
    commits its OnDemandStore before answering, Coordination.actor.cpp:125-160)
    — a restarted coordinator keeps its promises, so a stale CoordinatedState
    write can never reach quorum after a whole-cluster power loss.  The leader
    register stays ephemeral (leases, as in the reference)."""

    def __init__(
        self,
        process: SimProcess,
        fs=None,
        filename: str = "coordination.dq",
    ):
        self.process = process
        self.fs = fs
        self.filename = filename
        self._store = None
        # key -> (value, read_gen, write_gen)
        self.registry: Dict[bytes, Tuple[Optional[bytes], int, int]] = {}
        # leader register (single implicit key, like one leaderRegister actor)
        self.candidates: Dict[int, Tuple[LeaderInfo, float]] = {}
        self.nominee: Optional[LeaderInfo] = None
        self._waiters: List = []  # (known_change_id, reply)
        # Non-None after a quorum move: addresses this coordinator forwards
        # every election client to (ref: ForwardRequest handling).
        self.forward: Optional[List[str]] = None
        self._gr = RequestStream(process, "coord_gen_read", well_known=True)
        self._gw = RequestStream(process, "coord_gen_write", well_known=True)
        self._cd = RequestStream(process, "coord_candidacy", well_known=True)
        self._gl = RequestStream(process, "coord_get_leader", well_known=True)
        self._fw = RequestStream(process, "coord_set_forward", well_known=True)
        process.spawn_observed(self._boot(), "coord_boot")

    async def _boot(self):
        """Recover the generation register from disk, then serve.  Requests
        arriving before recovery park in the streams' queues."""
        if self.fs is not None:
            from ..fileio.kvstore import KeyValueStoreMemory
            from ..rpc.wire import decode_frame

            self._store = await KeyValueStoreMemory.open(
                self.fs, self.process, self.filename
            )
            for k, v in self._store.read_range(b"", b"\xff" * 16):
                self.registry[k] = decode_frame(v)
            fwd = self.registry.get(FORWARD_KEY)
            if getattr(self, "_forward_cleared", False):
                # clear_forward ran while this boot was still loading: the
                # clear wins over whatever the disk said.
                self.forward = None
                self.registry[FORWARD_KEY] = (b"", ZERO_GEN, ZERO_GEN)
                await self._persist(FORWARD_KEY)
            elif fwd is not None and fwd[0]:
                # A rebooted retired coordinator must keep forwarding, or a
                # client with a stale cluster file could re-elect on the
                # old quorum (ref: forward is durable in the reference too).
                self.forward = fwd[0].decode().split(",")
        p = self.process
        p.spawn_observed(self._serve_gen_read(), "coord_gr")
        p.spawn_observed(self._serve_gen_write(), "coord_gw")
        p.spawn_observed(self._serve_candidacy(), "coord_cd")
        p.spawn_observed(self._serve_get_leader(), "coord_gl")
        p.spawn_observed(self._serve_set_forward(), "coord_fw")
        p.spawn_observed(self._nominee_tick(), "coord_tick")

    async def _persist(self, key: bytes):
        if self._store is None:
            return
        from ..rpc.wire import encode_frame

        self._store.set(key, encode_frame(self.registry[key]))
        await self._store.commit()

    def interface(self) -> CoordinatorInterface:
        return CoordinatorInterface(
            gen_read=self._gr.ref(),
            gen_write=self._gw.ref(),
            candidacy=self._cd.ref(),
            get_leader=self._gl.ref(),
            set_forward=self._fw.ref(),
        )

    async def clear_forward(self):
        """Rejoin service: an address named in a NEW quorum must stop
        forwarding (the InitCoordinator path), or a reused retired member
        would answer every election with a stale pointer — two quorums
        pointing at each other can never elect anyone.

        Safe against the boot race: _boot checks the flag AFTER loading the
        registry from disk, so a clear issued while recovery is still in
        flight cannot be shadowed by the stale durable FORWARD_KEY."""
        self._forward_cleared = True
        self.forward = None
        self.registry[FORWARD_KEY] = (b"", ZERO_GEN, ZERO_GEN)
        await self._persist(FORWARD_KEY)
        self.nominee = None  # next tick renominates from live candidates

    async def _serve_set_forward(self):
        """Retire this coordinator: durably record the successor addresses
        and answer every future election request with the forward nominee
        (ref: ForwardRequest, Coordination.actor.cpp)."""
        while True:
            addrs, reply = await self._fw.pop()
            self.forward = list(addrs)  # fdblint: ignore[RACE004]: retirement is one-way — clear_forward and _boot order against it via _forward_cleared (see clear_forward docstring)
            self.registry[FORWARD_KEY] = (
                ",".join(addrs).encode(), ZERO_GEN, ZERO_GEN,
            )
            await self._persist(FORWARD_KEY)
            # Flush parked get_leader waiters with the forward nominee.
            self.nominee = _forward_info(self.forward)  # fdblint: ignore[RACE004]: nominee is a hint re-derived every election tick — a stale overwrite lasts one tick and renominates
            waiters, self._waiters = self._waiters, []
            for _known, w in waiters:
                w.send(self.nominee)
            reply.send(None)

    # --- generation register (ref localGenerationReg :125-160) ---
    async def _serve_gen_read(self):
        while True:
            req, reply = await self._gr.pop()
            value, rgen, wgen = self.registry.get(req.key, (None, ZERO_GEN, ZERO_GEN))
            if rgen < req.gen:
                rgen = req.gen
                self.registry[req.key] = (value, rgen, wgen)
                # The promise must survive a restart or a later stale write
                # could be accepted; durable BEFORE the reply.
                await self._persist(req.key)
            reply.send(GenReadReply(value=value, write_gen=wgen, read_gen=rgen))

    async def _serve_gen_write(self):
        while True:
            req, reply = await self._gw.pop()
            value, rgen, wgen = self.registry.get(req.key, (None, ZERO_GEN, ZERO_GEN))
            # Accept iff the writer's generation matches the newest promise
            # (ref: readGen <= gen && writeGen < gen, Coordination :148).
            if rgen <= req.gen and wgen < req.gen:
                self.registry[req.key] = (req.value, rgen, req.gen)
                await self._persist(req.key)  # durable before the ack
                reply.send(req.gen)  # accepted
            else:
                reply.send(max(rgen, wgen))  # conflict: newer gen promised

    # --- leader register (ref leaderRegister :203) ---
    def _recompute_nominee(self, now: float):
        if self.forward is not None:
            new = _forward_info(self.forward)
            if new != self.nominee:
                self.nominee = new
                waiters, self._waiters = self._waiters, []
                for _known, reply in waiters:
                    reply.send(self.nominee)
            return
        live = [info for info, exp in self.candidates.values() if exp > now]
        new = min(live) if live else None
        if new != self.nominee:
            self.nominee = new
            waiters, self._waiters = self._waiters, []
            for _known, reply in waiters:
                reply.send(self.nominee)

    async def _serve_candidacy(self):
        # Candidacy is lease refresh + immediate nomination report: parking
        # here would delay the candidate's own lease renewal past the TTL
        # and make nominations flap (observed; the reference separates the
        # heartbeat from the long-poll for the same reason).
        while True:
            req, reply = await self._cd.pop()
            now = self.process.network.loop.now()
            self.candidates[req.info.change_id] = (req.info, now + CANDIDATE_TTL)
            self._recompute_nominee(now)
            reply.send(self.nominee)

    async def _serve_get_leader(self):
        # Waiter list capped: abandoned long-polls (the poller timed out and
        # re-polled) would otherwise accumulate one entry per poll cycle for
        # as long as the nominee is stable.
        while True:
            req, reply = await self._gl.pop()
            known = req  # the change_id the client knows, or None
            if self.nominee is not None and self.nominee.change_id != known:
                reply.send(self.nominee)
            elif len(self._waiters) < 256:
                self._waiters.append((known, reply))
            else:
                reply.send(self.nominee)  # poller re-polls; stays bounded

    async def _nominee_tick(self):
        loop = self.process.network.loop
        while True:
            await loop.delay(NOMINEE_TICK)
            self._recompute_nominee(loop.now())


def quorum_state_key(addresses: List[str]) -> bytes:
    """The coordinated-state register key for ONE quorum membership.

    Derived from the member addresses, so OVERLAPPING old/new quorums in a
    coordinator change use DISTINCT keys on shared members — fencing the
    old set can never clobber the new set's manifest (the reference gets
    the same property by generating a new cluster id in the connection
    string on every changeQuorum, ManagementAPI.actor.cpp:684)."""
    import zlib

    blob = ",".join(addresses).encode()
    return b"cstate:%08x" % zlib.crc32(blob)


class CoordinatedState:
    """Quorum client over the coordinators' generation registers (ref:
    CoordinatedState.actor.cpp).  One instance per reader/writer session.

    With a CoordinatorSet (and no explicit key), the register key is
    derived from the membership via quorum_state_key — see its docstring
    for why overlapping quorums must not share a key."""

    def __init__(
        self,
        process: SimProcess,
        coordinators,
        key: Optional[bytes] = None,
    ):
        self.process = process
        # Pinned at construction: a session belongs to ONE quorum; a move
        # mid-session must surface as coordinated_state_conflict, not be
        # papered over by silently retargeting.
        self.coordinators = list(_resolve_coords(coordinators))
        if key is None:
            key = (
                quorum_state_key(coordinators.addresses)
                if isinstance(coordinators, CoordinatorSet)
                else b"cstate"
            )
        self.key = key
        self.gen = ZERO_GEN  # this session's generation, fixed at read()
        self._read_done = False

    @property
    def _quorum(self) -> int:
        return len(self.coordinators) // 2 + 1

    async def _quorum_replies(self, coros):
        """First `quorum` successful replies (tolerates a minority of
        failures)."""
        results = []
        pending = [self.process.spawn(c) for c in coros]
        while pending and len(results) < self._quorum:
            idx, val = await first_of(*pending)
            pending.pop(idx)
            if not isinstance(val, Exception):
                results.append(val)
        if len(results) < self._quorum:
            raise FdbError("coordinators_changed")
        return results

    async def _replicated_read(self, gen) -> GenReadReply:
        replies = await self._quorum_replies(
            _swallow(c.gen_read.get_reply(self.process, GenReadRequest(self.key, gen)))
            for c in self.coordinators
        )
        best = max(replies, key=lambda r: r.write_gen)
        max_rgen = max(r.read_gen for r in replies)
        return GenReadReply(
            value=best.value, write_gen=best.write_gen, read_gen=max_rgen
        )

    async def read(self) -> Optional[bytes]:
        """Two-phase (ref CoordinatedStateImpl::read): learn the newest
        generation, then plant our own (higher) read promise and read the
        authoritative value at it.  set() reuses that same generation, which
        is exactly what makes a later reader's promise doom our write."""
        probe = await self._replicated_read(ZERO_GEN)
        counter = max(probe.write_gen[0], probe.read_gen[0]) + 1
        salt = self.process.network.loop.rng.random_int(1, 1 << 30)
        self.gen = (counter, salt)
        rep = await self._replicated_read(self.gen)
        self._read_done = True
        return rep.value

    async def set(self, value: bytes):
        """Conditional write at the read-time generation (ref setExclusive:
        any register that promised a newer generation rejects ->
        coordinated_state_conflict)."""
        assert self._read_done, "CoordinatedState.set requires a prior read"
        replies = await self._quorum_replies(
            _swallow(
                c.gen_write.get_reply(
                    self.process, GenWriteRequest(self.key, value, self.gen)
                )
            )
            for c in self.coordinators
        )
        if any(r != self.gen for r in replies):
            raise FdbError("coordinated_state_conflict")


async def _swallow(fut):
    """Convert an RPC error into a returned exception (quorum logic counts
    failures instead of failing fast)."""
    try:
        return await fut
    except FdbError as e:
        return e



def _moved_to(info: LeaderInfo):
    """Forward addresses carried by a nominee, or None."""
    p = info.payload
    return p.get("moved_to") if isinstance(p, dict) else None

async def try_become_leader(
    process: SimProcess,
    coordinators,
    info: LeaderInfo,
    is_leader: AsyncVar,
):
    """Run candidacy forever: refresh leases, watch nominations; set
    `is_leader` True while this process holds a majority nomination (ref:
    tryBecomeLeaderInternal LeaderElection.actor.cpp:78).

    `coordinators` may be a CoordinatorSet: the set is re-read every round
    and forward replies retarget it, so candidacy survives a quorum change
    (ref: the ForwardRequest path in LeaderElection)."""
    loop = process.network.loop

    async def one_round(coords):
        # All coordinators in parallel: a refresh round must complete well
        # inside CANDIDATE_TTL or our own leases lapse and nominations flap.
        futs = [
            process.spawn(
                _swallow(
                    c.candidacy.get_reply(
                        process, CandidacyRequest(b"", info, info.change_id)
                    )
                )
            )
            for c in coords
        ]
        votes, forwards = 0, {}
        for f in futs:
            reply = await timeout_after(loop, f, POLL_INTERVAL, default=None)
            if reply is None or isinstance(reply, Exception):
                continue
            moved = _moved_to(reply)
            if moved is not None:
                key = tuple(moved)
                forwards[key] = forwards.get(key, 0) + 1
            elif reply.change_id == info.change_id:
                votes += 1
        return votes, forwards

    while True:
        coords = _resolve_coords(coordinators)
        quorum = len(coords) // 2 + 1
        votes, forwards = await one_round(coords)
        for addrs, n in forwards.items():
            if n >= quorum and isinstance(coordinators, CoordinatorSet):
                coordinators.retarget(list(addrs))
                votes = 0
                break
        is_leader.set(votes >= quorum)
        await loop.delay(POLL_INTERVAL)


async def monitor_leader(
    process: SimProcess,
    coordinators,
    leader_var: AsyncVar,
):
    """Poll coordinators; publish the majority nominee (ref:
    monitorLeaderInternal MonitorLeader.actor.cpp:427).

    `coordinators` may be a CoordinatorSet: a majority forward nominee
    retargets the set instead of being published — the client-side half of
    a coordinator quorum change (ref: MonitorLeader's connection-file
    rewrite on forward)."""
    loop = process.network.loop
    while True:
        coords = _resolve_coords(coordinators)
        counts: Dict[int, Tuple[int, LeaderInfo]] = {}
        for c in coords:
            known = leader_var.get().change_id if leader_var.get() else None
            fut = process.spawn(_swallow(c.get_leader.get_reply(process, known)))
            reply = await timeout_after(loop, fut, POLL_INTERVAL, default=None)
            if reply is None or isinstance(reply, Exception):
                continue
            n, _ = counts.get(reply.change_id, (0, reply))
            counts[reply.change_id] = (n + 1, reply)
        quorum = len(coords) // 2 + 1
        for change_id, (n, info) in counts.items():
            if n < quorum:
                continue
            moved = _moved_to(info)
            if moved is not None:
                if isinstance(coordinators, CoordinatorSet):
                    coordinators.retarget(list(moved))
                break
            if leader_var.get() is None or leader_var.get().change_id != change_id:
                leader_var.set(info)
            break
        await loop.delay(POLL_INTERVAL)
