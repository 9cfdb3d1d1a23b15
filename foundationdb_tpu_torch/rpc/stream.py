"""Typed request/reply endpoints over the network fabric.

The port's own copy of the reference package's ``rpc/stream.py``
(modelled on fdbrpc/fdbrpc.h: RequestStream, ReplyPromise, getReply).  A
server pops (request, Reply) pairs; a client's ``get_reply`` returns a
future that errors with broken_promise if the server dies first.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Optional

from ..flow.error import FdbError
from ..flow.eventloop import TaskPriority
from ..flow.future import Future, Promise, PromiseStream
from .network import Endpoint, SimNetwork, SimProcess


def BrokenPromise() -> FdbError:
    return FdbError("broken_promise")


def well_known_token(name: str) -> int:
    """Stable token derived from the stream name, so a client-side ref keeps
    working across the server process's reboot (ref: well-known endpoint
    tokens, e.g. the coordinators' WLTOKEN_* constants)."""
    return (1 << 40) | (zlib.crc32(name.encode()) & 0xFFFFFFFF)


@dataclass
class _Envelope:
    request: Any
    reply_to: Optional[Endpoint]


class Reply:
    """Server-side handle for answering one request; send() travels back to
    the caller's one-shot reply endpoint (ref: ReplyPromise fdbrpc.h:94).

    Dropping a Reply unanswered sends broken_promise to the requester —
    exactly the reference's NetSAV/ReplyPromise destructor semantics: a
    server actor that dies (e.g. its role was replaced by a new generation
    on the same live process) breaks the caller's promise instead of
    leaving it hanging forever (ref: ReplyPromise ~destructor sendError,
    fdbrpc.h:94-120)."""

    __slots__ = ("_net", "_src", "_reply_to", "_sent")

    def __init__(self, net: SimNetwork, src: SimProcess, reply_to: Optional[Endpoint]):
        self._net = net
        self._src = src
        self._reply_to = reply_to
        self._sent = False

    def send(self, value=None):
        self._send((False, value))

    def send_error(self, name: str, detail=None):
        # Only a detail-bearing error widens the wire to (True, (name,
        # detail)); a bare error keeps the (True, name) shape.
        self._send((True, (name, detail) if detail is not None else name))

    def _send(self, wire):
        if self._sent or self._reply_to is None:
            return
        self._sent = True
        self._net.send_from(
            self._src, self._reply_to, wire, priority=TaskPriority.DefaultPromiseEndpoint
        )

    def __del__(self):
        if not self._sent and self._reply_to is not None:
            try:
                self._send((True, "broken_promise"))
            except Exception:  # noqa: BLE001 - interpreter teardown  # fdblint: ignore[ERR001]: __del__ during interpreter teardown — the network may be half-collected, nothing can surface it
                pass


class RequestStream:
    """Server side: a well-known endpoint producing (request, Reply) pairs."""

    def __init__(
        self,
        process: SimProcess,
        name: str,
        token: Optional[int] = None,
        well_known: bool = False,
    ):
        self.process = process
        self.name = name
        replace = False
        if token is None and well_known:
            token = well_known_token(name)
            # Well-known streams are per-role singletons: a new generation's
            # role instance on the same process replaces the old receiver
            # (the reference's equivalent: a rebooted role re-registers its
            # well-known endpoints).
            replace = True
        self._stream = PromiseStream()
        self.endpoint = process.make_endpoint(
            self._deliver, token=token, replace=replace
        )

    def _deliver(self, env: _Envelope):
        reply = Reply(self.process.network, self.process, env.reply_to)
        if getattr(self, "_closed", None) is not None:
            # A retired role's endpoint: refuse instead of queueing into a
            # stream nobody will ever pop (the caller re-resolves topology).
            reply.send_error(self._closed)
            return
        self._stream.send((env.request, reply))

    def close(self, error_name: str = "broken_promise"):
        """Tear down the serving side: every PARKED request's reply breaks
        and every future delivery is refused — the reference's
        NetNotifiedQueue destruction breaking outstanding getReplys when a
        role actor dies (fdbrpc.h:192).  Without this, a request parked on
        a stale generation's role (alive process, role retired) hangs its
        caller forever."""
        self._closed = error_name
        q = self._stream.future_stream._queue
        pending, q[:] = list(q), []
        if pending:
            from ..flow.testprobe import test_probe

            test_probe("request_stream_closed_parked")
        for _req, rep in pending:
            rep.send_error(error_name)
        # The CONSUMER side must break too: a serve actor parked in
        # `await stream.pop()` when its generation retires would otherwise
        # stay parked forever — nothing can ever push (deliveries are
        # refused above), so the task and everything it closes over leak
        # silently until process death (the fdblint PRM001 orphaned-wait
        # class, observed dynamically by sim_validation's
        # expect_no_orphaned_waits).  Erroring the stream wakes it with
        # broken_promise and it exits with its generation.
        self._stream.send_error(FdbError(error_name))

    def pop(self) -> Future:
        """Future of the next (request, Reply)."""
        return self._stream.pop()

    def is_ready(self) -> bool:
        """A request is already queued (pop() would complete immediately) —
        lets servers drain a burst into one batch (ref: the queued-request
        draining in transactionStarter, MasterProxyServer.actor.cpp:948)."""
        return self._stream.is_ready()

    def ref(self) -> "RequestStreamRef":
        return RequestStreamRef(self.endpoint, self.name)


@dataclass(frozen=True)
class RequestStreamRef:
    """Client-side handle; what interface structs carry (ref: the
    RequestStream<T> members of e.g. MasterProxyInterface.h)."""

    endpoint: Endpoint
    name: str = ""

    def get_reply(self, src: SimProcess, request) -> Future:
        """Send and await the reply (ref: getReply fdbrpc.h:235).

        The future errors with broken_promise if the destination process
        dies before answering (detected via the fabric's death notification,
        standing in for a closed connection).
        """
        net = src.network
        out = Promise(priority=TaskPriority.DefaultPromiseEndpoint)
        if net.is_unreachable(self.endpoint.address):
            # Target known-down (the simulator can peek at remote liveness;
            # a real network only learns from a failed connect): fail after
            # a connection-attempt latency (ref: failed connect ->
            # broken_promise on the reply).
            net.loop._schedule(
                TaskPriority.DefaultPromiseEndpoint,
                lambda: out.send_error(BrokenPromise()),
                at=net.loop.now() + net._latency(),
            )
            return out.future
        reply_ep_holder = {}

        def on_reply(wire):
            src.drop_endpoint(reply_ep_holder["ep"])
            pending = src._pending_on.get(self.endpoint.address)
            if pending is not None:
                pending.pop((out, reply_ep_holder["ep"]), None)
            if out.is_set():
                return
            is_err, value = wire
            if is_err:
                if isinstance(value, tuple):  # (name, detail)
                    out.send_error(FdbError(value[0], detail=value[1]))
                else:
                    out.send_error(FdbError(value))
            else:
                out.send(value)

        reply_ep = src.make_endpoint(on_reply)
        reply_ep_holder["ep"] = reply_ep
        # Insertion-ordered dict-as-set, NOT a set: on process death these
        # promises are broken by iterating this container, and a set of
        # id-hashed tuples iterates in allocation-dependent order — which
        # made whole-cluster kills nondeterministic across interpreter runs
        # (found by the same-seed byte-identity check).
        src._pending_on.setdefault(self.endpoint.address, {})[
            (out, reply_ep)
        ] = None
        net.send_from(src, self.endpoint, _Envelope(request, reply_ep))
        return out.future

    def send(self, src: SimProcess, request):
        """One-way send, no reply expected (ref: RequestStream::send)."""
        src.network.send_from(src, self.endpoint, _Envelope(request, None))


async def retry_get_reply(
    ref: RequestStreamRef, src: SimProcess, request, *, delay: float = 0.1
):
    """getReply with broken_promise retry after a backoff — the minimal
    stand-in for the reference's loadBalance single-target path
    (fdbrpc/LoadBalance.actor.h:159) until replica sets exist."""
    loop = src.network.loop
    while True:
        try:
            return await ref.get_reply(src, request)
        except FdbError as e:
            if e.name != "broken_promise":
                raise
            await loop.delay(delay)


def spawn_owned(role, coro, name: str):
    """Spawn a per-request handler task OWNED by `role`: recorded in
    role._owned (pruned of finished tasks) so worker._teardown_role can
    cancel it with the role.  Handlers can park indefinitely (prevVersion
    ordering waits, log pushes into a chain hole) and must die with their
    generation, breaking the replies they hold.  Observed (spawn_observed
    semantics): ownership covers cancellation, not error observation — a
    handler dying on an FdbError mid-request must trace, not vanish."""
    t = role.process.spawn_observed(coro, name)
    role._owned = [x for x in getattr(role, "_owned", []) if not x.is_ready()]
    role._owned.append(t)
    return t
