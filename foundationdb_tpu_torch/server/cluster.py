"""Single-generation simulated cluster: the commit path end to end.

The port's own copy of the reference package's ``server/cluster.py``
(the role wiring worker.actor.cpp does from Initialize*Requests after
master recovery): a sequencer, commit proxies, resolvers, tlogs and
storage servers on one SimNetwork.  ``SimCluster`` sets the port's
current event loop and the port's buggify switch, never the reference
package's.

The resolvers' conflict sets are on the card: ``SimCluster()`` builds
every resolver's set with ``ConflictSet(backend="torch")`` and raises
where no card is visible.  ``device="cpu"`` runs the same engine with the
kernels' plain twins, and ``conflict_backend="cpu"`` the host engine.
``conflict_set`` is resolver 0's set; the others build their own.

Clients come from ``database(name, **kw)`` (a ``client.transaction.
Database`` on its own process; ``kw`` are its settings, such as
``witness_retry``), and ``run_all`` runs one coroutine per client to the
end.  ``resolver_balancer(**kw)`` moves the resolvers' split points.

``durable=True`` puts the one tlog and the one storage server on the
simulated disks of ``fs`` (a SimFileSystem): the log's disk queue and
spill store, the storage's memory engine.  ``crash_and_recover()`` kills
every process, settles each unsynced write by the file system's KillMode,
reboots, rebuilds the roles from disk at a new epoch and commits the
recovery transaction.

``data_distributor()`` is a DataDistributor on its own client process,
knowing every storage by id, and ``dd_role(dd=None, **kw)`` a started
DataDistributionRole over it (``kw`` are the role's settings, the
reference's ``dd_*`` knobs).  The cluster builds no ratekeeper: a caller
builds ``Ratekeeper(c.master_proc, c.tlogs, c.storages,
resolvers=c.resolvers, proxies=c.proxies)`` and sets each proxy's
``ratekeeper`` to its ``interface()``.
"""

from __future__ import annotations

from typing import Optional

from ..flow.eventloop import EventLoop, set_event_loop
from ..rpc.network import SimNetwork
from .proxy import Proxy
from .resolver import Resolver
from .sequencer import Sequencer
from .storage import StorageServer
from .tlog import TLog


def even_split_keys(n_resolvers: int) -> list:
    """n-1 single-byte split points partitioning the key space evenly (ref:
    the initial keyResolvers split)."""
    return [bytes([256 * i // n_resolvers]) for i in range(1, n_resolvers)]


class SimCluster:
    def __init__(
        self,
        seed: int = 1,
        conflict_backend: str = "torch",
        conflict_set=None,
        loop: Optional[EventLoop] = None,
        durable: bool = False,
        n_resolvers: int = 1,
        n_storages: int = 1,
        n_tlogs: int = 1,
        n_proxies: int = 1,
        buggify: bool = True,
        n_satellite_tlogs: int = 0,  # extra logs carrying EVERY tag,
        # synchronously in the commit ack set (ref: satellite TLogs;
        # the remote region's zero-loss recovery source)
        device=None,
    ):
        if conflict_backend != "cpu" and (conflict_set is None or n_resolvers > 1):
            # A resolver will build its set on `device`: fail before any
            # role spawns an actor (None is the card, raising without one).
            from ..device import resolve_device

            resolve_device(device)
        self.loop = loop or EventLoop(seed=seed)
        set_event_loop(self.loop)
        # Simulation buggifies by default, like the reference (flow/flow.h
        # :60-67: BUGGIFY only fires under the simulator).
        from ..flow.buggify import set_buggify_enabled

        set_buggify_enabled(buggify, self.loop.rng)
        self.net = SimNetwork(self.loop)
        self.conflict_backend = conflict_backend
        self._conflict_set = conflict_set
        self.device = device
        self.durable = durable
        self.fs = None
        self.master_proc = self.net.process("master")
        self.resolver_procs = [
            self.net.process(f"resolver{i}" if i else "resolver")
            for i in range(n_resolvers)
        ]
        self.resolver_proc = self.resolver_procs[0]
        self.n_satellite_tlogs = n_satellite_tlogs
        self.tlog_procs = [
            self.net.process(f"tlog{i}" if i else "tlog")
            for i in range(n_tlogs)
        ] + [
            # Satellites on their own machines (a different DC in spirit;
            # the sim fabric treats machines uniformly).
            self.net.process(f"satlog{i}")
            for i in range(n_satellite_tlogs)
        ]
        self.tlog_proc = self.tlog_procs[0]
        self.storage_procs = [
            self.net.process(f"storage{i}" if i else "storage")
            for i in range(n_storages)
        ]
        self.storage_proc = self.storage_procs[0]
        self.proxy_procs = [
            self.net.process(f"proxy{i}" if i else "proxy")
            for i in range(n_proxies)
        ]
        self.proxy_proc = self.proxy_procs[0]
        self._n_clients = 0
        self.split_keys = even_split_keys(n_resolvers)

        if durable:
            from ..fileio import SimFileSystem

            assert n_resolvers == 1, "durable multi-resolver: use DynamicCluster"
            assert n_storages == 1, "durable multi-storage: use DynamicCluster"
            assert n_tlogs == 1, "durable multi-tlog: use DynamicCluster"
            assert n_satellite_tlogs == 0, "satellites: non-durable SimCluster"
            self.fs = SimFileSystem(self.net)
            self._start_roles_durable(epoch_begin=0)
        else:
            self.sequencer = Sequencer(self.master_proc)
            self.resolvers = [
                Resolver(
                    p,
                    backend=conflict_backend,
                    conflict_set=conflict_set if i == 0 else None,
                    n_proxies=n_proxies,
                    device=device,
                )
                for i, p in enumerate(self.resolver_procs)
            ]
            self.resolver = self.resolvers[0]
            self.tlogs = [TLog(p) for p in self.tlog_procs]
            self.tlog = self.tlogs[0]
            tlog_ifaces = [t.interface() for t in self.tlogs]
            # Storage 0 owns everything at bootstrap (including the \xff
            # system keyspace).
            self.storages = [
                StorageServer(
                    p,
                    tlog_ifaces,
                    storage_id=f"ss{i}",
                    owned_all=(i == 0),
                    n_route_logs=n_tlogs,  # satellites excluded from placement
                )
                for i, p in enumerate(self.storage_procs)
            ]
            self.storage = self.storages[0]
            self.proxies = [
                Proxy(
                    p,
                    self.sequencer.interface(),
                    [r.interface() for r in self.resolvers],
                    tlog_ifaces,
                    resolver_split_keys=self.split_keys,
                    proxy_id=f"proxy{i}",
                    n_proxies=n_proxies,
                    n_satellites=n_satellite_tlogs,
                )
                for i, p in enumerate(self.proxy_procs)
            ]
            self.proxy = self.proxies[0]

    def resolver_balancer(self, **kw):
        """A ResolverBalancer polling this cluster's resolvers (its own
        client process; ref: the master-hosted resolution balancing)."""
        from .resolver_balancer import ResolverBalancer

        return ResolverBalancer(
            self.database("balancer"),
            [r.interface() for r in self.resolvers],
            self.split_keys,
            **kw,
        )

    def data_distributor(self):
        """A DataDistributor driving this cluster (its own client process);
        pre-registered with every storage's id -> interface."""
        from .data_distribution import DataDistributor

        return DataDistributor(
            self.database("dd"),
            {s.storage_id: s.interface() for s in self.storages},
        )

    def dd_role(self, dd=None, **kw):
        """A started self-driving DataDistribution role over this cluster
        (ref: the DD singleton control loop, DataDistribution.actor.cpp);
        `kw` are the role's settings."""
        from .dd_role import DataDistributionRole

        return DataDistributionRole(
            dd or self.data_distributor(),
            tlogs=[t.interface() for t in self.tlogs],
            **kw,
        ).start()

    def _start_roles_durable(self, epoch_begin: int):
        """(Re)build all roles from the machines' disks at a new epoch (the
        static stand-in for master recovery's recruitment; the real recovery
        state machine arrives with the control plane)."""

        async def build():
            self.tlog = await TLog.recover(
                self.tlog_proc, self.fs, "tlog.dq", fast_forward_to=epoch_begin
            )
            self.tlogs = [self.tlog]
            self.storage = await StorageServer.recover(
                self.storage_proc, self.tlog.interface(), self.fs, "storage.dq"
            )
            self.storages = [self.storage]
            self.sequencer = Sequencer(
                self.master_proc, epoch_begin_version=epoch_begin
            )
            self.resolver = Resolver(
                self.resolver_proc,
                backend=self.conflict_backend,
                conflict_set=self._conflict_set,
                epoch_begin_version=epoch_begin,
                device=self.device,
            )
            self.proxy = Proxy(
                self.proxy_proc,
                self.sequencer.interface(),
                [self.resolver.interface()],
                [self.tlog.interface()],
                epoch_begin_version=epoch_begin,
            )
            self.proxies = [self.proxy]

        self.loop.run_until(self.master_proc.spawn(build(), "recovery"))

    def crash_and_recover(self):
        """Kill every server process, resolve unsynced disk writes per the
        corruption model, reboot, and rebuild roles from disk at a new epoch
        (ref: restartSimulatedSystem SimulatedCluster.actor.cpp:597)."""
        assert self.durable, "crash_and_recover requires durable=True"
        from .proxy import MAX_VERSIONS_IN_FLIGHT

        procs = [
            self.master_proc,
            self.resolver_proc,
            self.tlog_proc,
            self.storage_proc,
            self.proxy_proc,
        ]
        for p in procs:
            p.kill()
        for p in procs:
            self.fs.crash_machine(p.machine.machine_id)
        for p in procs:
            p.reboot()
        # New epoch begins beyond anything the old one may have handed out
        # (ref: recoverFrom picking recoveryTransactionVersion past the old
        # epoch's end, masterserver.actor.cpp:725).
        epoch_begin = self.sequencer.version + MAX_VERSIONS_IN_FLIGHT
        self._start_roles_durable(epoch_begin=epoch_begin)
        # The recovery transaction: an empty commit that advances the chain
        # through the new epoch so storage catches up to GRV-visible versions
        # (ref: the RECOVERY_TRANSACTION state, masterserver.actor.cpp:1158).
        from ..client.types import CommitTransactionRef
        from .interfaces import CommitTransactionRequest

        async def recovery_txn():
            await self.proxy.interface().commit.get_reply(
                self.master_proc,
                CommitTransactionRequest(transaction=CommitTransactionRef()),
            )

        self.loop.run_until(
            self.master_proc.spawn(recovery_txn(), "recovery_txn")
        )

    def database(self, name: str = "", **kw):
        """A client Database on a new process of this cluster's network;
        `kw` are the Database's settings."""
        # Imported here: client.transaction imports server.interfaces (the
        # interface structs live with the client, as in fdbclient/), so a
        # module-level import would be circular.
        from ..client.transaction import Database

        self._n_clients += 1
        proc = self.net.process(name or f"client{self._n_clients}")
        return Database(
            proc,
            self.proxy.interface(),
            self.storage.interface(),
            proxies=[p.interface() for p in self.proxies],
            **kw,
        )

    def run_until(self, future, timeout_vt: float = 1000.0):
        return self.loop.run_until(future, timeout_vt=timeout_vt)

    def run_all(self, coros_by_db, timeout_vt: float = 1000.0):
        """Spawn one coroutine per (db, coro) pair and run until all done."""
        from ..flow.eventloop import all_of

        tasks = [db.process.spawn(c) for db, c in coros_by_db]
        return self.run_until(all_of(tasks), timeout_vt=timeout_vt)
