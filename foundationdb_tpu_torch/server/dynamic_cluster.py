"""Dynamic simulated cluster: coordinators + workers + elected controller.

The full control-plane topology (ref: SimulatedCluster.actor.cpp
setupSimulatedSystem): coordinator processes run the generation/leader
registers; worker processes register with whichever cluster controller wins
the election; the CC recruits roles onto workers and re-runs the recovery
state machine whenever a role's process dies.  Clients discover proxies via
the CC's ClientDBInfo long-poll, so they follow recoveries automatically.

The port's own copy of the reference package's
``server/dynamic_cluster.py``.  Every recruited resolver's set is on the
card: ``DynamicCluster()`` raises before any role spawns where no card is
visible.  ``device="cpu"`` runs the same engine with the kernels' plain
twins, and ``conflict_backend="cpu"`` the host engine.
``resolver_settings`` (``key_words``, ``h_cap``, ``pipeline_depth``,
``witness``, ``mirror_coalesce``, ``bucket_mins``) reach every recruited
resolver's set through the controllers, and ``controller_settings`` are
the controllers' knob arguments.  ``sched_fuzz``, ``state_sanitizer`` and
``check_orphaned_waits`` are the settings of the EventLoop the cluster
builds where no ``loop`` is given, as SimCluster's.
"""

from __future__ import annotations

from typing import List, Optional

from ..flow.asyncvar import AsyncVar
from ..flow.error import FdbError
from ..flow.eventloop import EventLoop, set_event_loop
from ..fileio import SimFileSystem
from ..rpc.network import SimNetwork
from .cluster_controller import ClientDBInfo, ClusterController
from .coordination import Coordinator, monitor_leader
from .worker import WorkerServer, run_worker_registration


class DynamicCluster:
    def __init__(
        self,
        seed: int = 1,
        n_coordinators: int = 3,
        n_workers: int = 5,
        n_controllers: int = 2,
        conflict_backend: str = "torch",
        loop: Optional[EventLoop] = None,
        n_tlogs: int = 1,
        n_storages: int = 1,
        n_proxies: int = 1,
        buggify: bool = True,
        storage_engine: str = "memory",
        device=None,
        resolver_settings: Optional[dict] = None,
        controller_settings: Optional[dict] = None,
           sched_fuzz: Optional[int] = None,
        state_sanitizer: bool = False,
        check_orphaned_waits: bool = False,
    ):
        if conflict_backend != "cpu":
            # Every recruited resolver builds its set on `device`: fail
            # before any role spawns (None is the card, raising without one).
            from ..device import resolve_device

            resolve_device(device)
        self.resolver_settings = dict(resolver_settings or {}, device=device)
        self.controller_settings = dict(controller_settings or {})
        self.loop = loop or EventLoop(seed=seed, sched_fuzz=sched_fuzz,
                                      state_sanitizer=state_sanitizer,
                                      check_orphaned_waits=check_orphaned_waits)
        set_event_loop(self.loop)
        from ..flow.buggify import set_buggify_enabled

        set_buggify_enabled(buggify, self.loop.rng)
        self.net = SimNetwork(self.loop)
        self.fs = SimFileSystem(self.net)
        self.conflict_backend = conflict_backend
        self.storage_engine = storage_engine
        self.n_tlogs = n_tlogs
        self.n_storages = n_storages
        self.n_proxies = n_proxies

        self._coord_procs = [
            self.net.process(f"coord{i}") for i in range(n_coordinators)
        ]
        self._cc_procs = [self.net.process(f"cc{i}") for i in range(n_controllers)]
        self._worker_procs = [
            self.net.process(f"worker{i}") for i in range(n_workers)
        ]
        self._n_clients = 0
        self._build_server_side()

    def _build_server_side(self):
        """Construct coordinator/controller/worker role objects on their
        (live) processes.  Runs at first boot and after crash_and_recover;
        well-known stream tokens are name-derived, so refs held by clients
        stay valid across a rebuild on the same addresses."""
        from .coordination import CoordinatorSet

        self.coordinators = [
            Coordinator(p, fs=self.fs) for p in self._coord_procs
        ]
        # The test-visible "cluster file" (used for NEW clients); survives
        # crash_and_recover so late observers skip the forward hop.  Every
        # server PROCESS below gets its OWN CoordinatorSet — as in the
        # reference each process trusts its own connection file and learns
        # of a quorum change only through coordinator forwarding.
        if not hasattr(self, "coord_set"):
            self.coord_set = CoordinatorSet(
                [p.address for p in self._coord_procs],
                [c.interface() for c in self.coordinators],
            )
        # Server processes boot from the ORIGINAL file contents: after a
        # crash_and_recover that followed a quorum move, they must re-find
        # the cluster through the retired coordinators' durable forwards.
        boot_addrs = [p.address for p in self._coord_procs]

        # Controller candidates: whichever wins the election acts.
        self.controllers = [
            ClusterController(
                p,
                CoordinatorSet(boot_addrs),
                conflict_backend=self.conflict_backend,
                storage_engine=self.storage_engine,
                fs=self.fs,
                n_tlogs=self.n_tlogs,
                n_storages=self.n_storages,
                n_proxies=self.n_proxies,
                resolver_settings=self.resolver_settings,
                **self.controller_settings,
            )
            for p in self._cc_procs
        ]

        self.workers: List[WorkerServer] = []
        for proc in self._worker_procs:
            w = WorkerServer(proc, self.fs)
            self.workers.append(w)
            leader_var = AsyncVar(None)
            proc.spawn_observed(
                monitor_leader(proc, CoordinatorSet(boot_addrs), leader_var),
                "leader_mon",
            )
            proc.spawn(run_worker_registration(w, leader_var), "registration")

    @property
    def coord_ifaces(self):
        """Live coordinator interfaces (back-compat accessor; the
        retargetable truth is `coord_set`)."""
        return self.coord_set.interfaces

    def crash_and_recover(self):
        """Whole-cluster power loss: kill every server process (coordinators
        included), resolve unsynced disk writes per the corruption model,
        reboot, and rebuild everything from disk.  The cluster manifest must
        come back from the coordinators' files alone (ref:
        restartSimulatedSystem SimulatedCluster.actor.cpp:597 +
        Coordination.actor.cpp OnDemandStore persistence).  Clients survive
        and re-discover the new generation via their long-polls."""
        procs = self._coord_procs + self._cc_procs + self._worker_procs
        for p in procs:
            p.kill()
        for p in procs:
            self.fs.crash_machine(p.machine.machine_id)
        for p in procs:
            p.reboot()
        self._build_server_side()

    # --- clients ---
    def database(self, name: str = "", **kw):
        """A client Database following the elected controller; `kw` are
        the Database's settings."""
        from ..client.transaction import Database

        from .coordination import CoordinatorSet

        self._n_clients += 1
        proc = self.net.process(name or f"client{self._n_clients}")
        info_var = AsyncVar(ClientDBInfo())
        leader_var = AsyncVar(None)
        # Own connection-file view (snapshot of the cluster-level one);
        # coordinator forwards retarget it if the quorum moves later.
        proc.spawn_observed(
            monitor_leader(
                proc, CoordinatorSet(list(self.coord_set.addresses)), leader_var
            ),
            "leader_mon",
        )
        proc.spawn(
            self._monitor_client_info(proc, leader_var, info_var), "info_mon"
        )
        return Database(proc, info_var=info_var, **kw)

    async def _monitor_client_info(self, proc, leader_var, info_var):
        """Long-poll the elected CC for ClientDBInfo (ref: monitorProxies)."""
        loop = self.loop
        while True:
            leader = leader_var.get()
            if leader is None:
                await loop.delay(0.2)
                continue
            cc = next(
                (
                    c
                    for c in self.controllers
                    if c.process.address == leader.address
                ),
                None,
            )
            if cc is None:
                await loop.delay(0.2)
                continue
            try:
                from ..flow.eventloop import timeout_after

                # Bounded long-poll: if we guessed the leader wrong (or it
                # changes), re-check rather than park forever.
                info = await timeout_after(
                    loop,
                    cc.client_info_ref().get_reply(
                        proc, info_var.get().generation
                    ),
                    2.0,
                    default=None,
                )
                if info is not None:
                    info_var.set(info)
            except FdbError:
                await loop.delay(0.2)

    # --- drivers ---
    def run_until(self, future, timeout_vt: float = 1000.0):
        return self.loop.run_until(future, timeout_vt=timeout_vt)

    def run_all(self, coros_by_db, timeout_vt: float = 1000.0):
        from ..flow.eventloop import all_of

        tasks = [db.process.spawn(c) for db, c in coros_by_db]
        return self.run_until(all_of(tasks), timeout_vt=timeout_vt)

    def kill_role_process(self, role: str):
        """Kill the worker process currently hosting `role` (as recruited by
        the acting controller).  Unsuffixed stateful names alias the first
        instance ("tlog" -> "tlog0")."""
        cc = self.acting_controller()
        # Empty before the first recruitment finishes; KeyError then (the
        # caller treats it as "role not recruited yet").
        addrs = getattr(cc, "_role_addrs", {})
        addr = addrs.get(role) or addrs[role + "0"]
        proc = self.net.get_process(addr)
        proc.kill()
        return proc

    def acting_controller(self) -> ClusterController:
        for c in self.controllers:
            # A dead CC's is_leader var is frozen at its last value; only a
            # live process can act.
            if c.process.alive and c.is_leader.get():
                return c
        raise RuntimeError("no controller is leader")
