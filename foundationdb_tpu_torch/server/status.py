"""Cluster status document (ref: Status.actor.cpp clusterGetStatus :1690 —
the giant JSON doc consumed by fdbcli `status` and the StatusWorkload).

The rebuild aggregates live role state into the same overall shape
(cluster/qos/data/workload sections, recovery state, process list); fields
grow as subsystems land.

The port's own copy of the reference package's ``server/status.py``.  The
document keeps the reference's key names, its ``"tpu"`` section (the
resolvers' ``device_metrics()``) included, so the two packages' documents
compare whole.
"""

from __future__ import annotations

from typing import Optional


_ROLE_PLURAL = {
    "proxy": "proxies",
    "resolver": "resolvers",
    "tlog": "tlogs",
    "storage": "storages",
}


def role_objects(cluster, name: str) -> list:
    """Live role objects of one kind across cluster flavors — the ONE
    discovery path status and the CLI share (so the two surfaces can
    never disagree about which roles exist): DynamicCluster
    current-generation worker roles on live processes, SimCluster plural
    lists, durable SimCluster singletons."""
    if hasattr(cluster, "controllers"):  # DynamicCluster
        try:
            cc = cluster.acting_controller()
        except RuntimeError:
            cc = None
        # Only THIS generation's recruited roles on live processes: a
        # spare worker can still hold a frozen role object from an
        # earlier generation (killed+rebooted, not re-recruited), which
        # would wedge min-version / queue aggregates forever.
        # _role_addrs only exists after the first recruitment completes.
        current = set(getattr(cc, "_role_addrs", {}).values() if cc else ())
        return [
            w.roles[name]
            for w in cluster.workers
            if name in w.roles
            and w.process.alive
            and (not current or w.process.address in current)
        ]
    out = list(getattr(cluster, _ROLE_PLURAL[name], None) or [])
    if not out and getattr(cluster, name, None) is not None:
        out = [getattr(cluster, name)]  # durable SimCluster singleton
    return out


def _resolver_section(resolver_roles) -> Optional[dict]:
    """The resolver/tpu status section: per-resolver registry
    snapshots plus, when a device engine is live, its kernel telemetry
    (retraces, padding occupancy, fixpoint rounds, grow/rebase).  Roles
    without the telemetry surface (older/foreign conflict sets) degrade
    to the counters they do have."""
    roles = [r for r in resolver_roles if r is not None]
    if not roles:
        return None
    sec: dict = {
        "count": len(roles),
        "total_resolved": sum(
            getattr(r, "total_resolved", 0) for r in roles
        ),
        "backends": sorted(
            {
                getattr(r.conflicts, "backend", type(r.conflicts).__name__)
                for r in roles
                if hasattr(r, "conflicts")
            }
        ),
        "resolvers": {},
    }
    tpu: dict = {}
    for r in roles:
        name = getattr(getattr(r, "process", None), "name", None) or (
            f"resolver{len(sec['resolvers'])}"
        )
        m = getattr(r, "metrics", None)
        if m is not None:
            sec["resolvers"][name] = m.snapshot()
        dm = getattr(getattr(r, "conflicts", None), "device_metrics", None)
        snap = dm() if callable(dm) else None
        if snap:
            tpu[name] = snap
    if tpu:
        sec["tpu"] = tpu
    return sec


def cluster_status(cluster) -> dict:
    """Status for a SimCluster or DynamicCluster."""
    doc: dict = {
        "client": {
            "database_status": {"available": True, "healthy": True},
            "coordinators": {},
        },
        "cluster": {},
    }
    cl = doc["cluster"]
    if hasattr(cluster, "controllers"):  # DynamicCluster
        try:
            cc = cluster.acting_controller()
        except RuntimeError:
            cc = None
        doc["client"]["database_status"]["available"] = cc is not None and (
            cc.client_info.get().proxy is not None
        )
        cl["recovery_state"] = {
            "name": "fully_recovered" if cc and cc.client_info.get().proxy else "recruiting",
            "generation": cc.generation if cc else 0,
        }
        cl["cluster_controller"] = cc.process.address if cc else None
        cl["workers"] = sorted(cc.workers) if cc else []
        cl["coordinators"] = [
            c.process.address for c in cluster.coordinators
        ]
        doc["client"]["coordinators"] = {
            "quorum_reachable": sum(
                1 for c in cluster.coordinators if c.process.alive
            )
            > len(cluster.coordinators) // 2,
        }
        roles = {}
        for w in cluster.workers:
            for name, role in w.roles.items():
                roles.setdefault(name, []).append(w.process.address)
        cl["roles"] = roles
        # Only THIS generation's recruited roles on live processes (see
        # role_objects — a spare worker can still hold a frozen role
        # object from an earlier generation, which would wedge the
        # min-version / queue aggregates forever).
        storages = role_objects(cluster, "storage")
        tlogs = role_objects(cluster, "tlog")
        storage = storages[0] if storages else None
        tlog = tlogs[0] if tlogs else None
        proxy = next(
            (w.roles["proxy"] for w in cluster.workers if "proxy" in w.roles), None
        )
        # Self-driving DD counters (ref: the data-distribution section of
        # Status.actor.cpp + the DDMetrics workload reading it).
        dd = getattr(cc, "dd_role", None) if cc else None
        if dd is not None:
            cl["data_distribution"] = {
                "moves": dd.moves_done,
                "heals": dd.heals_done,
                "splits": dd.splits_done,
                "merges": dd.merges_done,
                "queued": len(dd._queue),
                "in_flight": len(dd._inflight),
                "failed_servers": sorted(dd.failed),
            }
    else:  # SimCluster
        cl["recovery_state"] = {"name": "fully_recovered", "generation": 1}
        cl["roles"] = {
            "sequencer": [cluster.master_proc.address],
            "resolver": [p.address for p in cluster.resolver_procs],
            "tlog": [cluster.tlog_proc.address],
            "storage": [cluster.storage_proc.address],
            "proxy": [cluster.proxy_proc.address],
        }
        storages = list(getattr(cluster, "storages", []) or [cluster.storage])
        tlogs = list(getattr(cluster, "tlogs", []) or [cluster.tlog])
        storage, tlog, proxy = cluster.storage, cluster.tlog, cluster.proxy

    rsec = _resolver_section(role_objects(cluster, "resolver"))
    if rsec is not None:
        cl["resolver"] = rsec

    # Flight-recorder inventory: capture counts + the last
    # trigger, never the artifacts themselves (`cli flightrec` dumps
    # those).  Process-global, like the trace collector it spans.
    from ..flow.flight_recorder import global_flight_recorder

    cl["flight_recorder"] = global_flight_recorder().status_section()

    # Span-layer inventory: per-role ring sizes + lifetime
    # count, never the spans themselves (`cli trace-export` dumps those).
    from ..flow.spans import global_span_hub

    cl["spans"] = global_span_hub().status_section()

    if storage is not None:
        cl["data"] = {
            "storage_version": storage.version.get(),
            "durable_version": storage.durable_version,
            "total_keys_estimate": len(storage.store.sorted_keys)
            + (storage.kvstore.count() if storage.kvstore else 0),
            # Worst across replicas, like the reference's worst-queue rows.
            "storage_queue_bytes": max(
                (s.queue_bytes for s in storages), default=0
            ),
            # The LAGGING replica bounds the quiet gate, not the leader —
            # but only replicas in the SERVING set count: a spare that owns
            # no range (e.g. re-recruited after its epoch's logs were lost)
            # has nothing to catch up to and would wedge the gate forever.
            "storage_version_min": min(
                (
                    s.version.get()
                    for s in storages
                    if any(v for _b, _e, v in s.owned.items())
                    or any(a for _b, _e, a in s.adding.items())
                ),
                default=storage.version.get(),
            ),
            # Fetches in flight anywhere = data is moving (ref:
            # moving_data.in_flight_bytes).
            "moving_shards": sum(
                sum(1 for _b, _e, a in s.adding.items() if a)
                for s in storages
            ),
        }
    if proxy is not None:
        # Shard map depth (ref: data.partitions_count): the proxy's live
        # keyServers routing map.
        cl.setdefault("data", {})["partitions_count"] = len(
            list(proxy.key_servers.items())
        )
    if tlog is not None:
        cl["logs"] = {
            "log_version": max(t.durable.get() for t in tlogs),
            "queue_length": len(tlog.versions),
            "queue_bytes": max(
                (getattr(t, "_mem_bytes", 0) for t in tlogs), default=0
            ),
            "spilled_through_version": getattr(tlog, "spilled_through", 0),
            "popped_version": tlog.popped,
        }
    if proxy is not None:
        cl["workload"] = {
            "transactions": proxy.stats.snapshot(),
            "committed_version": proxy.committed.get(),
        }
        rk = getattr(proxy, "ratekeeper", None)
        qos = {"ratekeeper_enabled": rk is not None}
        info = getattr(proxy, "last_rate_info", None)
        if info is not None:
            # Ref: the qos section's transactions_per_second_limit /
            # performance_limited_by fields (Status.actor.cpp:1690).
            qos["transactions_per_second_limit"] = info.tps
            qos["batch_transactions_per_second_limit"] = getattr(
                info, "batch_tps", info.tps
            )
            qos["worst_queue_bytes_storage_server"] = getattr(
                info, "worst_ss_queue_bytes", 0
            )
            qos["worst_queue_bytes_log_server"] = getattr(
                info, "worst_tlog_queue_bytes", 0
            )
            qos["released_transactions_behind"] = info.lag_versions
            qos["performance_limited_by"] = getattr(info, "limiting", "none")
            # Overload-aware signals: the resolver/device-path
            # springs the reference's SS/TLog-only qos never carried.
            qos["worst_resolver_queue_depth"] = getattr(
                info, "resolver_queue_depth", 0
            )
            qos["resolve_latency_p99_seconds"] = getattr(
                info, "resolve_p99", 0.0
            )
            qos["commit_latency_p99_seconds"] = getattr(
                info, "commit_p99", 0.0
            )
            qos["conflict_backend_state"] = getattr(
                info, "backend_state", "ok"
            )
            qos["worst_grv_queue_depth"] = getattr(
                info, "grv_queue_depth", 0
            )
            # Mirror consistency: total confirmed mirror/device
            # divergences across resolvers.  Non-zero means a breaker
            # opened on corrupt device state at some point; the current
            # consequence (if any) shows in conflict_backend_state.
            qos["conflict_mirror_divergence"] = getattr(
                info, "mirror_divergence", 0
            )
            # Shard-granular fault domains: the BINDING
            # degraded resolver's (degraded, total) shard counts.  Keys
            # present only when that resolver is mesh-sharded, so
            # single-device clusters' status docs are unchanged (and a
            # whole-lane degrade shows in conflict_backend_state alone).
            if getattr(info, "shards_total", 0) > 0:
                qos["conflict_shards_total"] = info.shards_total
                qos["conflict_shards_degraded"] = info.shards_degraded
        # Conflict witnesses: total aborted txns + the merged top-K
        # contended key ranges across resolvers — the qos view of WHERE
        # hot-key contention is burning goodput right now.
        w_aborts = 0
        merged: dict = {}
        # Contention block: spike-trigger state + a bounded
        # tail of the per-batch abort timeline, merged across resolvers
        # in (version, resolver) order — deterministic, so same-seed
        # status docs stay byte-identical.
        contention = {"streak": 0, "spikes": 0, "timeline_batches": 0,
                      "recent": []}
        recent: list = []
        for r in role_objects(cluster, "resolver"):
            cw = getattr(r, "conflict_witness", None)
            if not callable(cw):
                continue
            w = cw()
            w_aborts += w["aborts"]
            for b, e, n in w["topk"]:
                merged[(b, e)] = merged.get((b, e), 0) + n
            block = w.get("contention")
            if block:
                contention["streak"] = max(
                    contention["streak"], block["streak"]
                )
                contention["spikes"] += block["spikes"]
                contention["timeline_batches"] += len(block["timeline"])
                recent.extend(block["timeline"])
        recent.sort(key=lambda t: t["version"])
        contention["recent"] = recent[-8:]
        # Host-phase share: worst resolver's deterministic
        # host_fraction gauge — encode + mirror_apply + readback seq
        # extent over host + device extent.  The number the columnar
        # mirror / coalesced apply work drives down.
        hf = 0.0
        for r in role_objects(cluster, "resolver"):
            m = getattr(r, "metrics", None)
            if m is not None and "host_fraction" in m.gauges:
                hf = max(hf, m.gauges["host_fraction"].value)
        qos["conflict_host_fraction"] = hf
        qos["conflict_witness_aborts"] = w_aborts
        qos["conflict_witness_topk"] = [
            [b, e, n]
            for (b, e), n in sorted(
                merged.items(), key=lambda kv: (-kv[1], kv[0])
            )[:8]
        ]
        qos["contention"] = contention
        # Shard-mesh block: split points + last reshard move
        # per mesh-sharded resolver, so an operator reads the current
        # partition (and who moved it last) straight from status.  Key
        # present only when a mesh-sharded conflict set is live.
        shards: dict = {}
        for r in role_objects(cluster, "resolver"):
            dm = getattr(getattr(r, "conflicts", None), "device_metrics",
                         None)
            if not callable(dm):
                continue
            block = (dm() or {}).get("shards")
            if block is None:
                continue
            name = getattr(getattr(r, "process", None), "name", None) or (
                f"resolver{len(shards)}"
            )
            bal = getattr(r, "shard_balancer", None)
            shards[name] = {
                "total": block["total"],
                "max": block["max"],
                "degraded": block["degraded"],
                "occupancy": block["occupancy"],
                "split_keys": block["split_keys"],
                "moves": block["moves"],
                "last_move": block.get("last_move"),
                "balancer_ticks": 0 if bal is None else len(bal.decisions),
            }
        if shards:
            qos["shards"] = shards
        cl["qos"] = qos
        # Passive latency distributions from the proxy's ContinuousSamples
        # (ref: the commit/GRV latency bands in Status.actor.cpp's qos; the
        # ACTIVE probe is the async latency_probe() below).
        samples = getattr(proxy, "latency_samples", None)
        if samples is not None:
            cl["latency"] = {
                "commit_seconds": samples["commit"].summary(),
                "grv_seconds": samples["grv"].summary(),
            }

    # Processes / machines sections (ref: the per-process and per-machine
    # maps in Status.actor.cpp:1690, fed by ProcessMetrics/MachineMetrics;
    # here read live off the fabric + each process's actor bookkeeping).
    net = getattr(cluster, "net", None)
    if net is not None and hasattr(net, "_procs"):
        role_by_addr: dict = {}
        for rname, addrs in cl.get("roles", {}).items():
            for a in addrs:
                role_by_addr.setdefault(a, []).append(rname)
        processes = {}
        machines: dict = {}
        for addr, p in sorted(net._procs.items()):
            mid = p.machine.machine_id
            processes[addr] = {
                "machine_id": mid,
                "alive": p.alive,
                "roles": sorted(role_by_addr.get(addr, [])),
                # Unfinished actors: the port's process drops finished
                # ones lazily (the reference's at every spawn).
                "live_actors": sum(1 for t in p._tasks if not t.is_ready()),
                "endpoints": len(p._endpoints),
            }
            m = machines.setdefault(
                mid,
                {
                    "datacenter_id": getattr(p.machine, "dc_id", "dc0"),
                    "processes": 0,
                    "alive_processes": 0,
                },
            )
            m["processes"] += 1
            m["alive_processes"] += 1 if p.alive else 0
        cl["processes"] = processes
        cl["machines"] = machines
    return doc


async def latency_probe(db) -> dict:
    """Active end-to-end probe (ref: Status.actor.cpp's latency_probe
    section — doLatencyProbe running a real transaction): one GRV, one
    read, one commit, each timed in virtual seconds."""
    loop = db.process.network.loop
    out = {}
    tr = db.create_transaction()
    tr.options["access_system_keys"] = True
    t0 = loop.now()
    await tr.get_read_version()
    out["transaction_start_seconds"] = loop.now() - t0
    t0 = loop.now()
    await tr.get(b"\xff/status/probe")
    out["read_seconds"] = loop.now() - t0
    t0 = loop.now()
    rng = loop.rng
    k = b"\xff/status/probe/%016x" % rng.random_int(0, 1 << 62)
    tr.set(k, b"probe")
    tr.clear(k)  # net no-op; the commit round-trip is what's measured
    await tr.commit()
    out["commit_seconds"] = loop.now() - t0
    return out


async def quiet_database(
    db,
    cluster,
    timeout_vt: float = 60.0,
    max_storage_queue_bytes: int = 64 << 10,
    max_lag_versions: int = 1_000_000,
) -> None:
    """Wait until the cluster is quiescent (ref: waitForQuietDatabase,
    QuietDatabase.actor.cpp:371): every storage's queue drained below the
    bound, version lag inside the bound, and no shard move in flight.
    Chaos teardowns gate their consistency checks on this instead of fixed
    virtual-time sleeps.  Raises TimeoutError if never quiet."""
    loop = db.process.network.loop
    deadline = loop.now() + timeout_vt
    while True:
        doc = cluster_status(cluster)
        cl = doc["cluster"]
        data = cl.get("data", {})
        logs = cl.get("logs", {})
        # Sections absent (e.g. mid-recovery, roles not yet live) is NOT
        # quiet — the gate must never pass vacuously.
        quiet = (
            "storage_version_min" in data
            and "log_version" in logs
            and data.get("storage_queue_bytes", 0) <= max_storage_queue_bytes
            and data.get("moving_shards", 0) == 0
            and logs["log_version"] - data["storage_version_min"]
            <= max_lag_versions
        )
        if quiet:
            return
        if loop.now() > deadline:
            raise TimeoutError(
                f"database never became quiet: queue="
                f"{data.get('storage_queue_bytes')} moving="
                f"{data.get('moving_shards')} lag="
                f"{logs.get('log_version', 0) - data.get('storage_version_min', 0)}"
                f" sections=({sorted(data)}, {sorted(logs)})"
            )
        await loop.delay(0.25)
