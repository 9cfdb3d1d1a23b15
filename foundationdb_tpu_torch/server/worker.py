"""Worker: the generic process agent that hosts roles on request.

Ref: fdbserver/worker.actor.cpp — workerServer :481 registers with the
cluster controller and spawns role actors from Initialize*Requests
(:494-560); a role's state files live on the worker's machine, so the
controller recruits stateful roles back onto the machines that hold their
disks (the rebuild's stand-in for tag-aware recruitment until replication
lands).

The port's own copy of the reference package's ``server/worker.py``.
``InitResolver`` carries, beside ``backend``, the settings the reference's
recruited set reads from its environment and knobs (FDB_TPU_H_CAP,
FDB_TPU_PIPELINE_DEPTH, FDB_TPU_WITNESS, FDB_TPU_MIRROR_COALESCE,
``conflict_device_key_words``, ``conflict_max_device_key_bytes``) and
``device``, each at the port's ``ConflictSet`` default: the recruited
resolver's set is on the card unless the request names the CPU.
``InitProxy`` carries the reference's ratekeeper_grv_queue_max knob as
``grv_queue_max``.  ``ProfilerRequest`` toggles the process's sampling
profiler (flow/profiler.py); a worker answers an unknown request with
client_invalid_operation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..conflict.api import MAX_DEVICE_KEY_BYTES, ConflictSet
from ..rpc.network import SimProcess
from ..rpc.stream import RequestStream, RequestStreamRef
from .interfaces import ResolverInterface, SequencerInterface, TLogInterface
from .proxy import RATEKEEPER_GRV_QUEUE_MAX, Proxy
from .resolver import Resolver
from .sequencer import Sequencer
from .storage import StorageServer
from .tlog import TLog


@dataclass
class WorkerInterface:
    address: str = ""
    init_role: RequestStreamRef = None
    ping: RequestStreamRef = None
    role_check: RequestStreamRef = None
    has_tlog_file: bool = False
    has_storage_file: bool = False


@dataclass
class InitSequencer:
    epoch_begin: int = 0
    epoch: int = 0  # generation, for grant fencing


@dataclass
class InitResolver:
    backend: str = "torch"
    epoch_begin: int = 0
    epoch: int = 0
    n_proxies: int = 1
    # The recruited set's settings (the reference's env and knob reads).
    key_words: int = 4
    h_cap: int = 1 << 16
    pipeline_depth: int = 2
    witness: bool = True
    mirror_coalesce: object = 1
    bucket_mins: tuple = (8, 8, 8)
    max_device_key_bytes: int = MAX_DEVICE_KEY_BYTES
    device: object = None  # None: the card


@dataclass
class InitTLog:
    epoch_begin: int = 0
    recover_from_disk: bool = True
    epoch: int = 0
    # Replacement for a permanently lost replica: wipe any stale file and
    # start a new durable log that only serves >= epoch_begin.
    fresh: bool = False


@dataclass
class LockTLog:
    """Epoch end: stop the current tlog generation, report durable version
    (ref: TLogServer epoch end locking via TagPartitionedLogSystem)."""


@dataclass
class FastForwardTLog:
    """Jump the recovered tlog's durable chain to the new epoch's begin,
    once the recovery version is fixed (it must exceed the log's true
    durable end, which is only known after recovery from disk).

    `truncate_above`: epoch-end cut (ref: the epochEnd lock protocol,
    TagPartitionedLogSystem.actor.cpp).  Commits ack only after ALL logs
    fsync, so min(recovered durables) bounds every acked version; entries
    above it are un-acked orphans present on a strict subset of logs and
    are discarded (durably, via a truncate marker) before the log serves
    the new epoch."""

    version: int = 0
    truncate_above: Optional[int] = None


@dataclass
class InitStorage:
    tlog: object = None  # TLogInterface or List[TLogInterface]
    engine: str = "memory"  # "memory" | "btree" (ref: openKVStore dispatch)


@dataclass
class InitCoordinator:
    """Start a coordination server on this worker (ref: every fdbserver can
    serve coordination when named in the connection string; the quorum
    change recruits new members this way, ManagementAPI.actor.cpp:684)."""

    pass


@dataclass
class RetireRoles:
    """Tear down EPHEMERAL roles of generations older than `epoch`
    (proxy/resolver/sequencer — their state dies with the generation;
    tlogs stay locked-but-serving for recovery peeks, storages keep
    their data).  A stale role on a live worker otherwise keeps parking
    requests forever — e.g. a resolve waiting on a prevVersion hole —
    and its well-known endpoints shadow nothing (ref: the reference's
    role actors dying with the master they registered with, breaking
    outstanding getReplys via NetNotifiedQueue destruction)."""

    epoch: int = 0


@dataclass
class InitProxy:
    sequencer: SequencerInterface = None
    resolvers: List[ResolverInterface] = field(default_factory=list)
    tlogs: List[TLogInterface] = field(default_factory=list)
    epoch_begin: int = 0
    epoch: int = 0
    proxy_id: str = "proxy0"
    n_proxies: int = 1
    ratekeeper: object = None  # RatekeeperInterface
    grv_queue_max: int = RATEKEEPER_GRV_QUEUE_MAX


@dataclass
class ProfilerRequest:
    """Runtime CPU-profiler toggle (ref: ProfilerRequest in
    fdbclient/ClientWorkerInterface.h, handled by worker.actor.cpp; the
    CpuProfiler workload drives it)."""

    enabled: bool = True
    interval: float = 0.005


class WorkerServer:
    def __init__(self, process: SimProcess, fs):
        self.process = process
        self.fs = fs
        self.roles: dict = {}
        self.role_tasks: dict = {}  # role name -> actor tasks to cancel on replace
        self._init_stream = RequestStream(process, "worker_init", well_known=True)
        self._ping_stream = RequestStream(process, "worker_ping", well_known=True)
        self._role_check_stream = RequestStream(
            process, "worker_role_check", well_known=True
        )
        process.spawn_observed(self._serve_init(), "worker_init")
        process.spawn_observed(self._serve_ping(), "worker_ping")
        process.spawn_observed(self._serve_role_check(), "worker_role_check")
        if fs is not None and fs.exists(process, "coordination.dq"):
            # A worker that served coordination (post-quorum-change) must
            # resume it AT BOOT, before any controller exists — elections
            # need the registers up first (ref: coordination starting from
            # the command line/cluster file, not CC recruitment).
            from .coordination import Coordinator

            self.roles["coordinator"] = Coordinator(process, fs=fs)

    def _teardown_role(self, name: str):
        """Cancel a role's actors — construction-time AND owned per-request
        tasks — and break its parked/future requests, so nothing keeps
        waiting on a dead generation (ref: role actors dying with their
        registration, breaking outstanding getReplys)."""
        role = self.roles.get(name)
        for t in self.role_tasks.get(name, []):
            if not t.is_ready():
                t.cancel()
        if role is not None:
            for t in list(getattr(role, "_owned", [])):
                if not t.is_ready():
                    t.cancel()
            for v in vars(role).values():
                if isinstance(v, RequestStream):
                    v.close()

    def _replace_role(self, name: str, role, tasks):
        """Install a new generation's role instance, tearing the previous
        instance down so two generations never run side by side (e.g.
        two storage servers double-applying to one engine file).  NOTE:
        the new role has already re-registered the well-known endpoints
        (replace=True at stream construction), so closing the OLD streams
        here breaks only their parked requests, not new traffic."""
        self._teardown_role(name)
        self.roles[name] = role
        self.role_tasks[name] = tasks

    def interface(self) -> WorkerInterface:
        return WorkerInterface(
            address=self.process.address,
            init_role=self._init_stream.ref(),
            ping=self._ping_stream.ref(),
            role_check=self._role_check_stream.ref(),
            has_tlog_file=self.fs.exists(self.process, "tlog.dq"),
            has_storage_file=self.fs.exists(self.process, "storage.dq"),
        )

    async def _serve_ping(self):
        while True:
            _req, reply = await self._ping_stream.pop()
            reply.send("pong")

    async def _serve_role_check(self):
        """Is a role still installed AND healthy?  A rebooted worker
        answers pings but has an empty role table; a role that marked
        itself `broken` (e.g. a proxy whose commit batch died mid-phase,
        leaving a hole in the prevVersion chain that wedges every later
        batch) is equally unusable on a perfectly live process — the
        reference gets the same recovery because its proxy actor DIES on
        a batch error (ref: per-role waitFailureServer; commitBatch
        errors tearing down the proxy)."""
        while True:
            role_name, reply = await self._role_check_stream.pop()
            role = self.roles.get(role_name)
            reply.send(role is not None and not getattr(role, "broken", False))

    async def _serve_init(self):
        while True:
            req, reply = await self._init_stream.pop()
            self.process.spawn(self._init_one(req, reply), "worker_init_one")

    async def _init_one(self, req, reply):
        from ..flow.buggify import buggify

        if buggify("worker_slow_init"):
            # BUGGIFY: slow recruitment — stretches the recovery window so
            # client retries and stale-generation requests overlap it.
            loop = self.process.network.loop
            await loop.delay(loop.rng.random01() * 0.1)
        # Task capture: actors this process spawns while the role constructs
        # belong to the new role instance (recoveries are driven serially by
        # the CC, so concurrent unrelated spawns are not expected here).
        # Identity-based: spawn() prunes finished tasks, so indices shift.
        # The tasks are held while the role constructs, so no new task can
        # take the id of one pruned and freed meanwhile.
        held = list(self.process._tasks)
        before = {id(t) for t in held}

        def new_tasks():
            return [t for t in self.process._tasks if id(t) not in before]

        try:
            if isinstance(req, InitSequencer):
                role = Sequencer(
                    self.process,
                    epoch_begin_version=req.epoch_begin,
                    epoch=req.epoch,
                )
                self._replace_role("sequencer", role, new_tasks())
                reply.send(role.interface())
            elif isinstance(req, InitResolver):
                role = Resolver(
                    self.process,
                    backend=req.backend,
                    epoch_begin_version=req.epoch_begin,
                    conflict_set=resolver_set(req),
                    epoch=req.epoch,
                    n_proxies=req.n_proxies,
                    device=req.device,
                    witness=req.witness,
                )
                self._replace_role("resolver", role, new_tasks())
                reply.send(role.interface())
            elif isinstance(req, InitTLog):
                if req.fresh:
                    role = await TLog.fresh(
                        self.process,
                        self.fs,
                        "tlog.dq",
                        epoch_begin=req.epoch_begin,
                        epoch=req.epoch,
                    )
                elif req.recover_from_disk:
                    role = await TLog.recover(
                        self.process,
                        self.fs,
                        "tlog.dq",
                        fast_forward_to=req.epoch_begin,
                        epoch=req.epoch,
                    )
                else:
                    role = TLog(
                        self.process,
                        epoch_begin_version=req.epoch_begin,
                        epoch=req.epoch,
                    )
                self._replace_role("tlog", role, new_tasks())
                reply.send((role.interface(), role.durable.get()))
            elif isinstance(req, RetireRoles):
                retired = []
                for name in ("proxy", "resolver", "sequencer"):
                    role = self.roles.get(name)
                    ep = getattr(role, "epoch", None)
                    if role is None or ep is None or ep >= req.epoch:
                        continue
                    self._teardown_role(name)
                    del self.roles[name]
                    self.role_tasks.pop(name, None)
                    retired.append(name)
                    from ..flow.testprobe import test_probe

                    test_probe("stale_role_retired")
                reply.send(retired)
            elif isinstance(req, LockTLog):
                role: Optional[TLog] = self.roles.get("tlog")
                if role is None:
                    # Distinguishable from a TIMED-OUT lock (None at the
                    # caller): no live role means the disk is quiescent —
                    # safe for recovery to proceed and recover it from
                    # disk; a timeout is NOT safe (the old role may still
                    # be acking commits).
                    reply.send("no_tlog")
                else:
                    role.locked = True
                    reply.send(role.durable.get())
            elif isinstance(req, FastForwardTLog):
                role = self.roles.get("tlog")
                if role is None:
                    reply.send_error("recruitment_failed")
                else:
                    if req.truncate_above is not None:
                        # Epoch-end cut: drop un-acked orphans (durably).
                        await role.truncate_above(req.truncate_above)
                    if req.version > role.durable.get():
                        # The jump holds no version: confirms answer the
                        # true end until durable passes it (TLog.
                        # confirmed_durable).
                        end = role.durable.get()
                        if req.truncate_above is not None:
                            end = min(end, req.truncate_above)
                        role.fast_forward_gap = (end, req.version)
                        role.durable.set(req.version)
                    if req.version > role.known_committed:
                        role.known_committed = req.version
                    reply.send(role.durable.get())
            elif isinstance(req, InitStorage):
                role = await StorageServer.recover(
                    self.process,
                    req.tlog,
                    self.fs,
                    "storage.dq" if req.engine == "memory" else "storage.bt",
                    engine=req.engine,
                )
                self._replace_role("storage", role, new_tasks())
                reply.send(role.interface())
            elif isinstance(req, InitCoordinator):
                from .coordination import Coordinator

                if "coordinator" not in self.roles:
                    # Idempotent: re-recruiting an existing coordinator must
                    # not reset its registers (its promises are durable).
                    role = Coordinator(self.process, fs=self.fs)
                    self._replace_role("coordinator", role, new_tasks())
                # Joining a quorum un-retires the member: a durable forward
                # from an EARLIER retirement must not shadow the new role.
                await self.roles["coordinator"].clear_forward()
                reply.send("ok")
            elif isinstance(req, InitProxy):
                role = Proxy(
                    self.process,
                    req.sequencer,
                    req.resolvers,
                    req.tlogs,
                    epoch_begin_version=req.epoch_begin,
                    epoch=req.epoch,
                    proxy_id=req.proxy_id,
                    n_proxies=req.n_proxies,
                    ratekeeper=req.ratekeeper,
                    grv_queue_max=req.grv_queue_max,
                )
                self._replace_role("proxy", role, new_tasks())
                reply.send(role.interface())
            elif isinstance(req, ProfilerRequest):
                from ..flow.profiler import profiler_toggle

                reply.send(profiler_toggle(req.enabled, req.interval))
            else:
                reply.send_error("client_invalid_operation")
        except Exception:  # noqa: BLE001 - recruitment failed; CC retries
            reply.send_error("recruitment_failed")


def resolver_set(req: InitResolver) -> ConflictSet:
    """The recruited resolver's conflict set, starting at the new epoch's
    version, with the request's settings."""
    return ConflictSet(
        backend=req.backend,
        oldest_version=req.epoch_begin,
        key_words=req.key_words,
        device=req.device,
        bucket_mins=req.bucket_mins,
        h_cap=req.h_cap,
        pipeline_depth=req.pipeline_depth,
        witness=req.witness,
        mirror_coalesce=req.mirror_coalesce,
        max_device_key_bytes=req.max_device_key_bytes,
    )


async def run_worker_registration(
    worker: WorkerServer, cc_leader_var, interval: float = 1.0
):
    """Keep the cluster controller aware of this worker (ref:
    registrationClient worker.actor.cpp; re-registers on CC change)."""
    from ..flow.error import FdbError

    process = worker.process
    loop = process.network.loop
    while True:
        leader = cc_leader_var.get()
        if leader is not None and leader.payload is not None:
            register_ref = leader.payload.get("register_worker")
            if register_ref is not None:
                try:
                    await register_ref.get_reply(process, worker.interface())
                except FdbError:
                    pass
        await loop.delay(interval)
