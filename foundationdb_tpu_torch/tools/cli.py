"""fdbcli-equivalent interactive shell (ref: fdbcli/fdbcli.actor.cpp — the
command table :423-464: get/set/clear/clearrange/getrange/status/writemode,
transaction begin/commit/rollback).

The command processor is decoupled from I/O so tests drive it directly; the
__main__ entry runs a REPL against a fresh simulated cluster (attaching to
a real deployment reuses the same Database handle).

The port's own copy of the reference package's ``tools/cli.py``:
``CliProcessor(cluster, db, dst_db=None, dst_cluster=None)`` with every
command, ``await run_command(line)`` returning the output lines.  The
commands that read only the process's globals (``trace-export``,
``flightrec``, ``latency``, ``profile``, ``help``) also serve a processor
built on no cluster (``CliProcessor(None, None)``).  ``cli soak``
(``soak_main``) runs the port's chaos soak (workloads/soak.py) on its own
cluster; its defaults are the reference's FDB_TPU_SOAK_* flags' as
argparse defaults (``SOAK_DEFAULTS``; the port reads no environment),
with ``--backend`` "torch" (the reference's "jax"), on the card unless
``--device`` names another.  ``python -m foundationdb_tpu_torch.tools.cli``
opens the shell on a fresh ``SimCluster`` (on the card), and
``python -m foundationdb_tpu_torch.tools.cli soak ...`` runs the soak.
"""

from __future__ import annotations

import json
import shlex
from typing import List, Optional

from ..flow.error import FdbError
from ..server.status import cluster_status


def _fmt_key(b: bytes) -> str:
    return repr(b)[1:]  # b'x' -> 'x' repr without the b prefix


class CliProcessor:
    """One command in, list of output lines out."""

    HELP = {
        "get": "get <key> — read a value",
        "set": "set <key> <value> — write a key (writemode must be on)",
        "clear": "clear <key> — delete a key",
        "clearrange": "clearrange <begin> <end> — delete a key range",
        "getrange": "getrange <begin> [end] [limit] — read a range",
        "getrangekeys": "getrangekeys <begin> [end] [limit] — keys only",
        "status": "status [json | --format=json] — cluster status "
        "(json form includes the resolver/tpu telemetry section)",
        "metrics": "metrics [--diff] [--format=json] — metrics-registry "
        "snapshots (proxy/resolver counters, device kernel telemetry); "
        "--diff prints counter/histogram deltas since the previous "
        "metrics command instead of lifetime totals",
        "flightrec": "flightrec [--format=json] — flight-recorder "
        "captures (triggered black-box windows: time-series deltas, "
        "recent trace events, transition logs); text form lists the "
        "capture inventory, json dumps the artifacts",
        "mirror-check": "mirror-check [--format=json] — on-demand live "
        "diff of each resolver's CPU mirror snapshot against its device "
        "export (the consistency check the periodic resolver actor runs; "
        "confirmed divergence opens the circuit breaker)",
        "contention": "contention [--format=json] [--limit=N] — conflict "
        "provenance explorer: joins the per-abort witness records "
        "(conflicting write version + losing read range) with the "
        "resolver span rings and the decayed top-K into per-range "
        "abort timelines; lists contention-spike flight-recorder "
        "captures",
        "shards": "shards [--format=json] — shard-mesh explorer: split "
        "points, per-shard occupancy/boundary counts, breaker states, "
        "the balancer decision log, and the reshard move log in one "
        "canonical sorted-keys doc (byte-identical per seed)",
        "latency": "latency [--chains] [--format=json] — per-stage "
        "latency percentiles from the span layer (default); --chains "
        "uses the legacy trace_batch debug-id chain reassembly "
        "(in-memory collectors only — the trace-file-only input path)",
        "trace-export": "trace-export [--out=PATH] [--include-wall] — "
        "export the span layer as a Chrome trace-event / Perfetto JSON "
        "artifact (one track per role, pipeline batches as nested "
        "slices); byte-identical across same-seed runs unless "
        "--include-wall adds real-clock durations",
        "consistencycheck": "consistencycheck — compare every "
        "multi-replica shard across its team (fdbserver -r "
        "consistencycheck analog)",
        "writemode": "writemode <on|off> — allow writes",
        "begin": "begin — start an explicit transaction",
        "commit": "commit — commit the explicit transaction",
        "rollback": "rollback — abandon the explicit transaction",
        "watch": "watch <key> — report when the key changes",
        "configure": "configure <name>=<value> ... — change configuration "
        "(proxies=N, storage_team_size=N, ...)",
        "exclude": "exclude <storage_id> ... — mark storages for removal",
        "include": "include [<storage_id> ...] — clear exclusions "
        "(no args: all)",
        "coordinators": "coordinators [<address> ...] — change the "
        "coordinator quorum (odd count; no args: show requested)",
        "profile": "profile <on|off|report> [interval] — sampling CPU "
        "profiler runtime toggle",
        "lock": "lock — lock the database (non-lock-aware work fails)",
        "unlock": "unlock [uid] — release the database lock",
        "setclass": "setclass <address> <class> — recruitment class "
        "(stateless|transaction|storage|unset)",
        "backup": "backup <start|status|restore|describe|expire> <path> "
        "[version | --timestamp=T] — continuous backup driver "
        "(fdbbackup analog)",
        "soak": "soak — the chaos-soak harness runs its OWN rated "
        "cluster: invoke as `python -m foundationdb_tpu_torch.tools.cli "
        "soak [--format=json] ...` (see --help for load/fault options)",
        "dr": "dr <start|status|switch> — replicate into the destination "
        "cluster; switch reverses the roles (fdbdr analog)",
        "help": "help — this text",
    }

    def __init__(self, cluster, db, dst_db=None, dst_cluster=None):
        self.cluster = cluster
        self.db = db
        # Destination database for `dr` commands (the fdbdr tool takes two
        # cluster files; the shell takes two database handles).  The
        # destination CLUSTER handle enables `dr switch` (the reverse
        # agent needs the destination's logs).
        self.dst_db = dst_db
        self.dst_cluster = dst_cluster
        self.write_mode = False
        self._tr = None  # explicit transaction, between begin/commit
        self._backups: dict = {}  # path -> ContinuousBackupAgent
        self._dr_agent = None

    async def run_command(self, line: str) -> List[str]:
        try:
            parts = shlex.split(line)
        except ValueError as e:
            return [f"ERROR: {e}"]
        if not parts:
            return []
        cmd, *args = parts
        # Hyphenated commands (mirror-check) map onto underscore handlers.
        handler = getattr(self, f"_cmd_{cmd.replace('-', '_')}", None)
        if handler is None:
            return [f"ERROR: unknown command `{cmd}'; type `help' for help"]
        try:
            return await handler(args)
        except FdbError as e:
            return [f"ERROR: {e.name} ({e.code})"]

    # -- transaction plumbing: implicit per-command or explicit begin/commit
    def _txn(self):
        return self._tr if self._tr is not None else self.db.create_transaction()

    async def _finish(self, tr) -> List[str]:
        if self._tr is None:
            await tr.commit()
        return []

    # -- commands --
    async def _cmd_help(self, args):
        return [self.HELP[k] for k in sorted(self.HELP)]

    async def _cmd_backup(self, args):
        """The fdbbackup driver (ref: fdbbackup's start/status/restore
        subcommands over FileBackupAgent), running the continuous agent."""
        if len(args) < 2:
            return ["ERROR: backup <start|status|restore> <path> [version]"]
        sub, path = args[0], args[1]
        from ..fileio import SimFileSystem
        from ..layers.backup import ContinuousBackupAgent, open_container

        if sub == "start":
            if path in self._backups:
                return [f"ERROR: backup to `{path}' already running"]
            fs = getattr(self.cluster, "fs", None) or SimFileSystem(
                self.cluster.net
            )
            try:
                # Scheme dispatch: blobstore:// targets the object store,
                # anything else the cluster filesystem.
                container = open_container(
                    path, fs, self.cluster.net.process(f"bk:{path}")
                )
            except ValueError as e:
                return [f"ERROR: {e}"]
            agent = ContinuousBackupAgent(
                self.db,
                fs,
                [t.interface() for t in self.cluster.tlogs],
                container,
                tag=f"_backup/{path}",
            )
            v = await agent.start()
            self.db.process.spawn(agent.run(), f"backup:{path}")
            self._backups[path] = agent
            return [f"Backup started to `{path}' at version {v}"]
        agent = self._backups.get(path)
        if sub == "status":
            if agent is None:
                return [f"No backup to `{path}'"]
            return [
                f"Backup `{path}': snapshot {agent.snapshot_version}, "
                f"logged through {agent.logged_through} "
                f"({agent._chunks} log chunks)"
            ]
        if sub == "restore":
            if agent is None:
                return [f"No backup to `{path}'"]
            return await self._backup_restore(agent, path, args)
        if sub == "describe":
            # Ref: fdbbackup describe.
            from ..layers.backup import describe_container

            container = (
                agent.container if agent is not None
                else open_container(
                    path,
                    getattr(self.cluster, "fs", None),
                    self.cluster.net.process(f"bk:{path}"),
                )
            )
            d = await describe_container(container)
            if not d.get("restorable"):
                return [f"`{path}': not restorable (no manifest)"]
            return [
                f"`{path}': restorable [{d['restorable_from']}, "
                f"{d['restorable_to']}], snapshot {d['version']} "
                f"({d['pages']} pages), log chunks "
                f"{d.get('first_log_chunk', 0)}..{d.get('log_chunks', 0)}"
            ]
        if sub == "expire":
            # Ref: fdbbackup expire — re-snapshot, then drop redundant
            # log chunks.
            if agent is None:
                return [f"No backup to `{path}'"]
            deleted = await agent.expire()
            return [
                f"Expired {deleted} log chunk(s); new snapshot at "
                f"{agent.snapshot_version}"
            ]
        return [f"ERROR: unknown backup subcommand `{sub}'"]

    async def _backup_restore(self, agent, path, args):
        # Resolve the target version FIRST — argument parsing and the
        # TimeKeeper mapping must not run with the agent paused (a
        # failure there would strand the backup stopped, and the resume
        # would race a tailer that never observed the pause).
        target = None
        if len(args) > 2:
            if args[2].startswith("--timestamp="):
                # Restore-to-timestamp via the TimeKeeper map (ref:
                # fdbbackup restore --timestamp,
                # timeKeeperVersionFromDatetime backup.actor.cpp:1828).
                from ..client.management import version_from_timestamp
                from ..flow.error import FdbError

                try:
                    ts = float(args[2].split("=", 1)[1])
                except ValueError:
                    return [f"ERROR: bad --timestamp value {args[2]!r}"]
                try:
                    target = await version_from_timestamp(self.db, ts)
                except FdbError as e:
                    if e.name != "restore_error":
                        raise  # unrelated failure: report truthfully
                    return ["ERROR: restore_error: no TimeKeeper sample "
                            "covers that time"]
            else:
                try:
                    target = int(args[2])
                except ValueError:
                    return [f"ERROR: bad version {args[2]!r}"]
        # Pause tailing for the restore, then RESUME it — the backup
        # stays live afterwards (the restore's own writes are logged
        # like any other mutations).
        agent.stopped = True
        try:
            v = await agent.restore(target_version=target)
        finally:
            agent.stopped = False
            self.db.process.spawn(agent.run(), f"backup:{path}")
        return [f"Restored `{path}' at version {v}; backup resumed"]

    async def _cmd_dr(self, args):
        """The fdbdr driver (ref: fdbbackup/fdbdr's start/status over
        DatabaseBackupAgent): continuous replication into the destination
        database this shell was constructed with."""
        if not args:
            return ["ERROR: dr <start|status>"]
        if self.dst_db is None:
            return ["ERROR: no destination cluster configured"]
        sub = args[0]
        if sub == "start":
            if self._dr_agent is not None:
                return ["ERROR: DR already running"]
            from ..layers.dr import DRAgent

            agent = DRAgent(
                self.db,
                self.dst_db,
                [t.interface() for t in self.cluster.tlogs],
            )
            v = await agent.start()
            self.db.process.spawn(agent.run(), "dr_agent")
            self._dr_agent = agent
            return [f"DR started; initial snapshot at version {v}"]
        if sub == "status":
            if self._dr_agent is None:
                return ["DR: not running"]
            return [
                f"DR: tailing, destination reflects source version "
                f"{self._dr_agent.applied}"
            ]
        if sub == "switch":
            # Ref: fdbdr switch -> atomicSwitchover.
            if self._dr_agent is None:
                return ["ERROR: no DR running to switch"]
            if self.dst_cluster is None:
                return ["ERROR: switch needs the destination cluster handle"]
            try:
                rev = await self._dr_agent.switchover(
                    [t.interface() for t in self.dst_cluster.tlogs]
                )
            except FdbError as e:
                # switchover unwound its locks; resume forward replication.
                self.db.process.spawn(self._dr_agent.run(), "dr_agent")
                return [f"ERROR: switch failed ({e.name}); DR resumed"]
            self.db.process.spawn(rev.run(), "dr_agent_rev")
            self._dr_agent = rev
            return [
                "Switched: destination is now primary; old primary locked "
                "as its replica"
            ]
        return [f"ERROR: unknown dr subcommand `{sub}'"]

    async def _cmd_get(self, args):
        (key,) = args
        tr = self._txn()
        v = await tr.get(key.encode())
        await self._finish(tr)
        if v is None:
            return [f"`{key}': not found"]
        return [f"`{key}' is `{v.decode(errors='replace')}'"]

    async def _cmd_set(self, args):
        if not self.write_mode:
            return ["ERROR: writemode must be enabled (writemode on)"]
        key, value = args
        tr = self._txn()
        tr.set(key.encode(), value.encode())
        await self._finish(tr)
        return ["Committed" if self._tr is None else "Staged"]

    async def _cmd_clear(self, args):
        if not self.write_mode:
            return ["ERROR: writemode must be enabled (writemode on)"]
        (key,) = args
        tr = self._txn()
        tr.clear(key.encode())
        await self._finish(tr)
        return ["Committed" if self._tr is None else "Staged"]

    async def _cmd_clearrange(self, args):
        if not self.write_mode:
            return ["ERROR: writemode must be enabled (writemode on)"]
        begin, end = args
        tr = self._txn()
        tr.clear_range(begin.encode(), end.encode())
        await self._finish(tr)
        return ["Committed" if self._tr is None else "Staged"]

    async def _cmd_getrange(self, args, keys_only=False):
        begin = args[0].encode()
        end = args[1].encode() if len(args) > 1 else b"\xff"
        limit = int(args[2]) if len(args) > 2 else 25
        tr = self._txn()
        rows = await tr.get_range(begin, end, limit=limit)
        await self._finish(tr)
        out = [f"Range limited to {limit} keys"] if len(rows) >= limit else []
        for k, v in rows:
            if keys_only:
                out.append(f"`{_fmt_key(k)}'")
            else:
                out.append(f"`{_fmt_key(k)}' is `{v.decode(errors='replace')}'")
        return out

    async def _cmd_getrangekeys(self, args):
        return await self._cmd_getrange(args, keys_only=True)

    async def _cmd_writemode(self, args):
        (mode,) = args
        self.write_mode = mode == "on"
        return []

    async def _cmd_consistencycheck(self, args):
        """On-demand cross-replica comparison (ref: the ConsistencyCheck
        role, fdbserver.actor.cpp role list + workloads/
        ConsistencyCheck.actor.cpp checkDataConsistency :562): every
        multi-replica shard read at one version from every team member
        and compared byte-exact."""
        from ..workloads.consistency import check_consistency

        try:
            compared = await check_consistency(self.db, self.cluster)
        except AssertionError as e:
            return [f"INCONSISTENT: {e}"]
        if compared == 0:
            return ["OK (no multi-replica shards to compare)"]
        return [f"OK: {compared} replica comparisons matched"]

    async def _cmd_status(self, args):
        doc = cluster_status(self.cluster)
        if args and args[0] in ("json", "--format=json"):
            from ..flow.eventloop import timeout_after

            # The json form runs the ACTIVE probe like the reference's
            # clusterGetStatus (Status.actor.cpp latency_probe section) —
            # under a timeout: a throttled/recovering cluster (exactly
            # what status diagnoses) must not hang the command.
            loop = self.db.process.network.loop
            task = self.db.process.spawn(
                self._probe_swallowing(), "status_probe"
            )
            probe = await timeout_after(loop, task, 5.0, default=None)
            if probe is None:
                task.cancel()
                probe = {"error": "probe timed out"}
            doc["cluster"]["latency_probe"] = probe
            return json.dumps(doc, indent=2, default=str).splitlines()
        cl = doc["cluster"]
        lines = [
            "Configuration:",
            f"  Recovery state   - {cl['recovery_state']['name']} "
            f"(generation {cl['recovery_state']['generation']})",
            f"  Roles            - "
            + ", ".join(f"{r}x{len(a)}" for r, a in sorted(cl["roles"].items())),
        ]
        if "data" in cl:
            d = cl["data"]
            if "storage_version" in d:  # absent while no storage role lives
                lines.append(
                    f"  Storage          - version {d['storage_version']}, "
                    f"~{d.get('total_keys_estimate', 0)} keys, "
                    f"queue {d.get('storage_queue_bytes', 0)}B"
                )
            lines.append(
                f"  Shards           - {d.get('partitions_count', 1)} "
                f"({d.get('moving_shards', 0)} moving)"
            )
        if "logs" in cl:
            lg = cl["logs"]
            lines.append(
                f"  Logs             - version {lg['log_version']}, "
                f"queue {lg['queue_bytes']}B"
                + (
                    f", spilled through {lg['spilled_through_version']}"
                    if lg.get("spilled_through_version")
                    else ""
                )
            )
        if "qos" in cl and "transactions_per_second_limit" in cl["qos"]:
            q = cl["qos"]
            lines.append(
                f"  Ratekeeper       - limit {q['transactions_per_second_limit']:.0f} tps"
                f" (batch {q['batch_transactions_per_second_limit']:.0f}), "
                f"limited by: {q['performance_limited_by']}"
            )
        if "workload" in cl:
            t = cl["workload"]["transactions"]
            lines.append(
                f"  Workload         - {t['committed']} committed, "
                f"{t['conflicted']} conflicted"
            )
        if "resolver" in cl:
            r = cl["resolver"]
            lines.append(
                f"  Resolver         - x{r['count']} "
                f"({', '.join(r['backends']) or 'unknown'}), "
                f"{r['total_resolved']} resolved"
                + (", device telemetry live" if "tpu" in r else "")
            )
        return lines

    async def _cmd_metrics(self, args):
        """Registry snapshots straight off the live roles (the `fdbcli
        status json` habit of reading counters, but for the
        metrics pipeline: proxy/resolver registries + kernel telemetry).
        `--diff` replaces the registry snapshots with counter/histogram
        DELTAS against the previous metrics command (same math as the
        time-series sampler, flow/timeseries.snapshot_delta) — lifetime
        totals hide what changed in the last thirty seconds."""
        from ..server.status import role_objects

        doc: dict = {}
        registries: dict = {}  # (section, name) -> registry snapshot
        for p in role_objects(self.cluster, "proxy"):
            m = getattr(p, "metrics", None)
            if m is not None:
                snap = m.snapshot()
                doc.setdefault("proxies", {})[p.proxy_id] = snap
                registries[("proxies", p.proxy_id)] = snap
            stats = getattr(p, "stats", None)
            if stats is not None:
                doc.setdefault("proxy_counters", {})[
                    p.proxy_id
                ] = stats.snapshot()
        for r in role_objects(self.cluster, "resolver"):
            m = getattr(r, "metrics", None)
            if m is not None:
                snap = m.snapshot()
                doc.setdefault("resolvers", {})[r.process.name] = snap
                registries[("resolvers", r.process.name)] = snap
            dm = getattr(getattr(r, "conflicts", None), "device_metrics", None)
            snap = dm() if callable(dm) else None
            if snap:
                doc.setdefault("tpu", {})[r.process.name] = snap
                registries[("tpu", r.process.name)] = snap
        diff = "--diff" in args
        no_baseline = False
        if diff:
            from ..flow.timeseries import snapshot_delta

            prev = getattr(self, "_metrics_prev", {})
            if not prev:
                # First invocation: there is nothing to diff against.
                # Say so clearly (and still show lifetime totals) instead
                # of presenting totals that LOOK like a window delta.
                no_baseline = True
            for (section, name), snap in registries.items():
                # Replace ONLY the registry keys (counters/gauges/
                # histograms) with deltas; instantaneous diagnostic
                # blocks (backend_state, breaker, mirror, tiers,
                # programs, ...) are not lifetime totals and pass
                # through unchanged — an operator diagnosing a degraded
                # device must not lose them in the diff view.
                delta = snapshot_delta(prev.get((section, name)), snap)
                doc[section][name] = {**snap, **delta}
        # Baseline for the NEXT --diff: every metrics command resets it,
        # so two successive `metrics --diff` calls show the in-between
        # window.
        self._metrics_prev = registries
        note = (
            "no prior snapshot — showing lifetime totals; run "
            "`metrics --diff` again for the in-between window"
        )
        if "--format=json" in args:
            if no_baseline:
                doc = {"note": note, **doc}
            return json.dumps(doc, indent=2, default=str).splitlines()
        if no_baseline:
            lines = [f"({note})"]
        elif diff:
            lines = ["(deltas since previous metrics command)"]
        else:
            lines = []
        for section in sorted(doc):
            lines.append(f"{section}:")
            for name, snap in sorted(doc[section].items()):
                lines.append(f"  {name}:")
                for k, v in sorted(snap.items()):
                    if isinstance(v, dict):
                        for kk, vv in sorted(v.items()):
                            lines.append(f"    {k}.{kk} = {vv}")
                    else:
                        lines.append(f"    {k} = {v}")
        return lines or ["(no metrics registries live)"]

    async def _cmd_flightrec(self, args):
        """Flight-recorder surface: list captures (text) or
        dump the full artifacts (--format=json) from the process-global
        recorder — the black-box record of breaker opens, mirror
        divergence, and admission throttling."""
        from ..flow.flight_recorder import global_flight_recorder

        rec = global_flight_recorder()
        if args and args[0] == "--format=json":
            doc = {
                "status": rec.status_section(),
                "captures": list(rec.captures),
            }
            return json.dumps(doc, indent=2, default=str).splitlines()
        if not rec.captures:
            counts = rec.trigger_counts
            return [
                "flight recorder: no captures"
                + (f" ({sum(counts.values())} triggers suppressed by "
                   "cooldown)" if counts else "")
            ]
        lines = [
            f"flight recorder: {len(rec.captures)} capture(s) retained "
            f"({rec.capture_seq} lifetime)"
        ]
        for cap in rec.captures:
            series = cap.get("timeseries", {})
            n_samples = sum(len(s) for s in series.values())
            lines.append(
                f"  #{cap['capture_seq']} t={cap['time']:.3f} "
                f"{cap['trigger']}: {len(series)} series / "
                f"{n_samples} samples, "
                f"{len(cap.get('recent_events', []))} trace events"
                + (f", detail={cap['detail']}" if cap.get("detail") else "")
            )
        return lines

    async def _cmd_mirror_check(self, args):
        """On-demand mirror consistency check: run
        ConflictSet.mirror_check() on every live resolver and report the
        verdicts.  Text form is one line per resolver; --format=json
        returns the raw report dicts (status ok|diverged|skipped)."""
        from ..server.status import role_objects

        doc: dict = {}
        for r in role_objects(self.cluster, "resolver"):
            mc = getattr(getattr(r, "conflicts", None), "mirror_check", None)
            if not callable(mc):
                continue
            rep = mc()
            name = getattr(getattr(r, "process", None), "name", None) or (
                f"resolver{len(doc)}"
            )
            doc[name] = (
                rep if rep is not None else {"status": "no_device_engine"}
            )
        if args and args[0] == "--format=json":
            return json.dumps(doc, indent=2, default=str).splitlines()
        if not doc:
            return ["(no resolvers live)"]
        lines = []
        for name, rep in sorted(doc.items()):
            status = rep.get("status", "?")
            if status == "ok":
                lines.append(
                    f"{name}: OK ({rep['boundaries']} boundaries match)"
                )
            elif status == "diverged":
                lines.append(
                    f"{name}: DIVERGED ({rep['mismatch_keys']} mismatched "
                    f"keys over {rep['boundaries']} mirror / "
                    f"{rep['device_boundaries']} device boundaries) — "
                    "breaker opened, device will rehydrate from snapshot"
                )
            elif status == "skipped":
                lines.append(f"{name}: skipped ({rep.get('reason', '?')})")
            else:
                lines.append(f"{name}: {status}")
        return lines

    async def _cmd_latency(self, args):
        """Per-stage latency percentiles.  Default source is the span
        layer: exact per-role stage durations straight off
        the resolver/proxy/client/tlog span rings — no chain
        reassembly, and it works on file-backed trace collectors too.
        `--chains` keeps the legacy g_traceBatch debug-id reassembly
        (flow/latency_chain.py) for trace-file-only inputs."""
        from ..flow.spans import global_span_hub, span_latency_summary

        use_chains = "--chains" in args
        hub = global_span_hub()
        if not use_chains and hub.rings:
            summary = span_latency_summary(hub)
            if "--format=json" in args:
                return json.dumps(
                    summary, indent=2, default=str
                ).splitlines()
            lines = ["per-stage span latency (virtual seconds):"]
            for role, stages in summary.items():
                if not stages:
                    continue
                lines.append(f"{role}:")
                for stage, s in stages.items():
                    lines.append(
                        f"  {stage:<16} n={s['count']:<5} "
                        f"p50={s['p50']:.6f} p90={s['p90']:.6f} "
                        f"p99={s['p99']:.6f} max={s['max']:.6f}"
                    )
            # Host-phase share: worst resolver's deterministic
            # encode+mirror_apply+readback fraction of host+device extent.
            from ..server.status import role_objects

            hf = None
            for r in role_objects(self.cluster, "resolver"):
                m = getattr(r, "metrics", None)
                if m is not None and "host_fraction" in m.gauges:
                    v = m.gauges["host_fraction"].value
                    hf = v if hf is None else max(hf, v)
            if hf is not None:
                lines.append(f"host_fraction: {hf:.4f}")
            return lines
        from ..flow.latency_chain import latency_summary
        from ..flow.trace import global_collector

        col = global_collector()
        if col.path is not None:
            return [
                "ERROR: trace collector is file-backed (events spooled "
                f"to {col.path}); chain reassembly needs the in-memory "
                "collector — the span layer (`latency` without "
                "--chains) works regardless"
            ]
        summary = latency_summary(col.events)
        if "--format=json" in args:
            return json.dumps(summary, indent=2, default=str).splitlines()
        lines = []
        for chain in ("commit", "grv"):
            lines.append(f"{chain} pipeline (seconds):")
            stages = summary[chain]
            any_sampled = any(s["count"] for s in stages.values())
            if not any_sampled:
                lines.append(
                    "  (no sampled chains; raise "
                    "client.latency_sample_rate)"
                )
                continue
            for stage, s in stages.items():
                if not s["count"]:
                    continue
                lines.append(
                    f"  {stage:<18} n={s['count']:<5} "
                    f"p50={s['p50']:.6f} p90={s['p90']:.6f} "
                    f"p99={s['p99']:.6f} max={s['max']:.6f}"
                )
        return lines

    async def _cmd_trace_export(self, args):
        """Perfetto / Chrome trace-event export of the span layer:
        one process per role, pipeline batches as nested
        slices, device phase-attribution children under their dispatch
        span.  Canonical compact JSON — byte-identical across same-seed
        runs unless --include-wall opts real-clock durations in."""
        from ..flow.spans import global_span_hub
        from ..flow.trace_export import perfetto_json

        include_wall = "--include-wall" in args
        out_path = next(
            (a.split("=", 1)[1] for a in args if a.startswith("--out=")),
            None,
        )
        blob = perfetto_json(include_wall=include_wall)
        if out_path:
            with open(out_path, "w", encoding="utf-8") as f:
                f.write(blob + "\n")
            hub = global_span_hub()
            return [
                f"wrote {out_path} "
                f"({sum(len(r) for r in hub.rings.values())} spans, "
                f"{len(hub.rings)} role tracks)"
            ]
        return [blob]

    async def _cmd_contention(self, args):
        """Conflict provenance explorer: joins each resolver's
        per-abort witness records — the per-batch contention timeline
        ring and the decayed top-K — into per-range abort timelines,
        alongside the resolver span-stage percentiles (the latency cost
        of the contention the witnesses attribute) and the
        contention_spike flight-recorder captures.  All inputs are
        virtual-time deterministic, so --format=json (canonical, sorted
        keys) is byte-identical across same-seed runs."""
        from ..flow.flight_recorder import global_flight_recorder
        from ..flow.spans import global_span_hub, span_latency_summary
        from ..server.status import role_objects

        limit = next(
            (int(a.split("=", 1)[1]) for a in args
             if a.startswith("--limit=")),
            8,
        )
        doc: dict = {"resolvers": {}}
        for r in role_objects(self.cluster, "resolver"):
            cw = getattr(r, "conflict_witness", None)
            if not callable(cw):
                continue
            rep = cw()
            name = getattr(getattr(r, "process", None), "name", None) or (
                f"resolver{len(doc['resolvers'])}"
            )
            # Fold the per-batch timeline into per-range abort series:
            # every batch that witnessed aborts against a range
            # contributes one [commit_version, aborts] point, so an
            # operator reads WHEN a range got hot, not just that it did.
            ranges: dict = {}
            for entry in rep["contention"]["timeline"]:
                for b, e, n in entry["ranges"]:
                    slot = ranges.setdefault(
                        f"{b}..{e}", {"aborts": 0, "timeline": []}
                    )
                    slot["aborts"] += n
                    slot["timeline"].append([entry["version"], n])
            top = sorted(
                ranges.items(), key=lambda kv: (-kv[1]["aborts"], kv[0])
            )[:limit]
            doc["resolvers"][name] = {
                "aborts": rep["aborts"],
                "topk": rep["topk"][:limit],
                "witness_batches": rep["contention"]["witness_batches"],
                "streak": rep["contention"]["streak"],
                "spikes": rep["contention"]["spikes"],
                "ranges": dict(top),
            }
        hub = global_span_hub()
        summary = span_latency_summary(hub) if hub.rings else {}
        # Ring keys are "Resolver.<name>" — strip the role prefix so the
        # span block keys line up with the witness block above.
        doc["spans"] = {
            role.split(".", 1)[1]: stages
            for role, stages in summary.items()
            if role.startswith("Resolver.")
        }
        rec = global_flight_recorder()
        doc["captures"] = [
            {
                "capture_seq": c["capture_seq"],
                "time": c["time"],
                "detail": c.get("detail"),
            }
            for c in rec.captures
            if c.get("trigger") == "contention_spike"
        ]
        if "--format=json" in args:
            return json.dumps(
                doc, indent=2, sort_keys=True, default=str
            ).splitlines()
        if not doc["resolvers"]:
            return ["(no resolvers live)"]
        lines = []
        for name, rr in sorted(doc["resolvers"].items()):
            lines.append(
                f"{name}: {rr['aborts']} witnessed aborts over "
                f"{rr['witness_batches']} batches "
                f"(streak {rr['streak']}, {rr['spikes']} spike(s))"
            )
            for key, slot in sorted(
                rr["ranges"].items(),
                key=lambda kv: (-kv[1]["aborts"], kv[0]),
            ):
                tl = slot["timeline"]
                lines.append(
                    f"  [{key}]  {slot['aborts']} aborts over "
                    f"{len(tl)} batches, last @v{tl[-1][0]}"
                )
            if not rr["ranges"]:
                lines.append("  (no witnessed aborts in the timeline ring)")
        for name, stages in sorted(doc["spans"].items()):
            if not stages:
                continue
            lines.append(f"{name} span stages (virtual seconds):")
            for stage, s in stages.items():
                lines.append(
                    f"  {stage:<16} n={s['count']:<5} "
                    f"p50={s['p50']:.6f} p99={s['p99']:.6f}"
                )
        if doc["captures"]:
            lines.append(
                f"contention spike captures: "
                f"{len(doc['captures'])} "
                f"(`flightrec --format=json` for the artifacts)"
            )
        return lines

    async def _cmd_shards(self, args):
        """Shard-mesh explorer: the elastic-resharding twin of
        `contention` — per-resolver split points, occupancy gauges,
        breaker states, the ShardBalancer decision log, and the conflict
        set's reshard move log, plus the reshard flight-recorder
        captures.  All inputs are virtual-time deterministic, so
        --format=json (canonical, sorted keys) is byte-identical across
        same-seed runs."""
        from ..flow.flight_recorder import global_flight_recorder
        from ..server.status import role_objects

        doc: dict = {"resolvers": {}}
        for r in role_objects(self.cluster, "resolver"):
            cs = getattr(r, "conflicts", None)
            dm = getattr(cs, "device_metrics", None)
            if not callable(dm):
                continue
            shards = (dm() or {}).get("shards")
            if shards is None:
                continue
            name = getattr(getattr(r, "process", None), "name", None) or (
                f"resolver{len(doc['resolvers'])}"
            )
            bal = getattr(r, "shard_balancer", None)
            doc["resolvers"][name] = {
                "shards": shards,
                "move_log": [dict(e) for e in getattr(cs, "move_log", [])],
                "balancer": None
                if bal is None
                else {
                    "moves": bal.moves,
                    "decisions": [dict(d) for d in bal.decisions],
                },
            }
        rec = global_flight_recorder()
        doc["captures"] = [
            {
                "capture_seq": c["capture_seq"],
                "time": c["time"],
                "detail": c.get("detail"),
            }
            for c in rec.captures
            if c.get("trigger") == "reshard"
        ]
        if "--format=json" in args:
            return json.dumps(
                doc, indent=2, sort_keys=True, default=str
            ).splitlines()
        if not doc["resolvers"]:
            return ["(no mesh-sharded resolvers live)"]
        lines = []
        for name, rr in sorted(doc["resolvers"].items()):
            sh = rr["shards"]
            lines.append(
                f"{name}: {sh['total']}/{sh['max']} shards "
                f"({sh['degraded']} degraded, {len(rr['move_log'])} "
                f"move(s))"
            )
            lines.append(f"  states:    {' '.join(sh['states'])}")
            lines.append(
                "  occupancy: "
                + " ".join(str(o) for o in sh["occupancy"])
            )
            lines.append(
                "  splits:    "
                + (" ".join(sh["split_keys"]) or "(none)")
            )
            lm = sh.get("last_move")
            if lm:
                lines.append(
                    f"  last move: seq={lm['seq']} action={lm['action']} "
                    f"reason={lm['reason']} shards={lm['shards']}"
                )
            bal = rr["balancer"]
            if bal is not None:
                acted = [
                    d for d in bal["decisions"]
                    if d["action"] in ("move", "scale")
                ]
                lines.append(
                    f"  balancer:  {len(bal['decisions'])} tick(s), "
                    f"{bal['moves']} committed move(s), "
                    f"{len(acted)} decision(s) to act"
                )
        if doc["captures"]:
            lines.append(
                f"reshard captures: {len(doc['captures'])} "
                f"(`flightrec --format=json` for the artifacts)"
            )
        return lines

    async def _probe_swallowing(self):
        from ..server.status import latency_probe

        try:
            return await latency_probe(self.db)
        except FdbError:
            return {"error": "probe failed"}

    async def _cmd_begin(self, args):
        if self._tr is not None:
            return ["ERROR: already in a transaction"]
        self._tr = self.db.create_transaction()
        return ["Transaction started"]

    async def _cmd_commit(self, args):
        if self._tr is None:
            return ["ERROR: no transaction in progress"]
        tr, self._tr = self._tr, None
        version = await tr.commit()
        return [f"Committed ({version})"]

    async def _cmd_rollback(self, args):
        if self._tr is None:
            return ["ERROR: no transaction in progress"]
        self._tr = None
        return ["Transaction rolled back"]

    async def _cmd_configure(self, args):
        """Ref: fdbcli `configure proxies=2 ...` -> changeConfig."""
        from ..client import management as mgmt

        params = {}
        for a in args:
            if "=" not in a:
                return [f"ERROR: expected name=value, got `{a}'"]
            name, value = a.split("=", 1)
            try:
                params[name] = int(value)
            except ValueError:
                return [f"ERROR: `{name}' needs an integer value, got `{value}'"]
        try:
            await mgmt.configure(self.db, **params)
        except ValueError as e:
            return [f"ERROR: {e}"]
        return ["Configuration changed"]

    async def _cmd_exclude(self, args):
        from ..client import management as mgmt

        if not args:
            excluded = await mgmt.get_excluded_servers(self.db)
            return [f"Excluded: {', '.join(excluded) or '(none)'}"]
        await mgmt.exclude_servers(self.db, list(args))
        return [f"Excluded {len(args)} server(s)"]

    async def _cmd_include(self, args):
        from ..client import management as mgmt

        await mgmt.include_servers(self.db, list(args) or None)
        return ["Included"]

    async def _cmd_coordinators(self, args):
        """Ref: fdbcli `coordinators <addr> ...` -> changeQuorum
        (ManagementAPI.actor.cpp:684).  No args: show the requested set."""
        from ..client import management as mgmt

        if not args:
            cur = await mgmt.get_requested_coordinators(self.db)
            return [f"Coordinators: {', '.join(cur) if cur else '(default)'}"]
        try:
            await mgmt.change_coordinators(self.db, list(args))
        except ValueError as e:
            return [f"ERROR: {e}"]
        return ["Coordination state changed"]

    async def _cmd_setclass(self, args):
        """Ref: fdbcli `setclass <address> <class>`."""
        from ..client import management as mgmt

        if len(args) != 2:
            return ["ERROR: usage: setclass <address> <class>"]
        addr, cls = args
        try:
            await mgmt.set_process_class(self.db, addr, cls)
        except ValueError as e:
            return [f"ERROR: {e}"]
        return [f"Process class for `{addr}' set to {cls}"]

    async def _cmd_lock(self, args):
        """Ref: fdbcli `lock` -> lockDatabase."""
        from ..client import management as mgmt

        uid = await mgmt.lock_database(self.db)
        self._lock_uid = uid
        return [f"Database locked with uid {uid.decode()}"]

    async def _cmd_unlock(self, args):
        from ..client import management as mgmt

        uid = args[0].encode() if args else getattr(self, "_lock_uid", None)
        if uid is None:
            return ["ERROR: unlock <uid> (no lock taken in this session)"]
        await mgmt.unlock_database(self.db, uid)
        return ["Database unlocked"]

    async def _cmd_profile(self, args):
        """Ref: fdbcli `profile` + the CpuProfiler workload's runtime
        toggle (Profiler.actor.cpp:175)."""
        from ..flow.profiler import get_profiler, profiler_toggle

        if not args or args[0] not in ("on", "off", "report"):
            return ["ERROR: usage: profile <on|off|report> [interval]"]
        if args[0] == "report":
            rep = get_profiler().report(top=10)
            lines = [
                f"Profiler: {'running' if rep['running'] else 'stopped'}, "
                f"{rep['total_samples']} samples @ {rep['interval']*1e3:.1f}ms"
            ]
            for h in rep["hot_functions"]:
                lines.append(
                    f"  {h['fraction']*100:5.1f}%  {h['function']} "
                    f"({h['file'].rsplit('/', 1)[-1]}:{h['line']})"
                )
            return lines
        interval = float(args[1]) if len(args) > 1 else None
        state = profiler_toggle(args[0] == "on", interval)
        return [
            f"Profiler {'running' if state['running'] else 'stopped'}"
        ]

    async def _cmd_watch(self, args):
        (key,) = args
        tr = self.db.create_transaction()
        fut = await tr.watch(key.encode())
        await tr.commit()
        version = await fut
        return [f"`{key}' changed at version {version}"]

    async def _cmd_soak(self, args):
        # The soak builds (and tears down) its own rated cluster + event
        # loop; running it from inside THIS cluster's loop would nest two
        # simulations.  Point the operator at the subcommand instead.
        return [
            "ERROR: soak runs its own rated cluster — invoke it as a "
            "subcommand: python -m foundationdb_tpu_torch.tools.cli soak "
            "[--format=json] (see --help)"
        ]


# The reference's FDB_TPU_SOAK_* flags' defaults (its flow/knobs.py), with
# its "jax" backend as the port's "torch".
SOAK_DEFAULTS = dict(minutes=1.0, seed=1, tps=80.0, keys=512, theta=0.9,
                     backend="torch")


def soak_main(argv=None) -> int:
    """`cli soak`: run the chaos-soak harness (workloads/soak.py) and emit
    a BENCH-style JSON artifact (goodput, p99s, throttle/shed counts,
    fault timeline) so future BENCH_r0*.json rounds get a soak arm.
    Defaults are SOAK_DEFAULTS; argv overrides them."""
    import argparse

    from ..workloads.soak import default_config, run_soak

    d = SOAK_DEFAULTS
    ap = argparse.ArgumentParser(
        prog="cli soak",
        description="sustained chaos-soak: ramped Zipf load + scripted "
        "fault matrix against a rated simulated cluster",
    )
    ap.add_argument("--minutes", type=float, default=d["minutes"],
                    help="soak length in SIM minutes (virtual time)")
    ap.add_argument("--seed", type=int, default=d["seed"])
    ap.add_argument("--tps", type=float, default=d["tps"],
                    help="peak-phase open-loop arrival rate (txn/s)")
    ap.add_argument("--keys", type=int, default=d["keys"])
    ap.add_argument("--theta", type=float, default=d["theta"],
                    help="Zipf skew exponent (0 = uniform)")
    ap.add_argument("--backend", default=None,
                    choices=("cpu", "torch", "hybrid", "sharded"),
                    help=f"conflict backend (default: {d['backend']})")
    ap.add_argument("--device", default=None,
                    help="where the conflict sets run (default: the card; "
                    "cpu: the kernels' plain twins)")
    ap.add_argument("--cluster", choices=("sim", "dynamic"), default="sim",
                    help="dynamic adds recovery-capable process kills")
    ap.add_argument("--mode", choices=("open", "closed"), default="open")
    ap.add_argument("--no-faults", action="store_true",
                    help="pure load run (baseline arm)")
    ap.add_argument("--shard-outage", action="store_true",
                    help="the shard-outage phase family on the "
                    "sharded backend — one shard's device dies for the "
                    "middle phase while the survivors hold the floor")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", default="",
                    help="also write the JSON artifact to this path")
    args = ap.parse_args(argv)

    if args.shard_outage:
        # The shard-outage family fixes backend/cluster/faults by
        # construction — reject flags it would silently contradict.
        if args.cluster != "sim":
            ap.error("--shard-outage runs on the sim cluster only "
                     "(the sharded backend is SimCluster's conflict_set "
                     "seam)")
        if args.no_faults:
            ap.error("--shard-outage IS the shard_kill fault; "
                     "--no-faults contradicts it")
        # None = not given explicitly (the default backend is
        # overridden by this purpose-built mode, never contradicted).
        if args.backend not in (None, "sharded"):
            ap.error("--shard-outage implies --backend sharded")
        from ..workloads.soak import shard_outage_config

        config = shard_outage_config(
            minutes=args.minutes, peak_tps=args.tps, seed=args.seed
        )
        config.keys = args.keys
        config.zipf_theta = args.theta
        config.mode = args.mode
    else:
        config = default_config(
            minutes=args.minutes,
            peak_tps=args.tps,
            seed=args.seed,
            cluster=args.cluster,
            backend=args.backend or d["backend"],
            mode=args.mode,
            keys=args.keys,
            zipf_theta=args.theta,
            faults=not args.no_faults,
        )
    config.device = args.device
    report = run_soak(config)
    artifact = soak_artifact(report)
    blob = json.dumps(artifact, indent=2, sort_keys=True)
    if args.format == "json":
        print(blob)
    else:
        t = report["totals"]
        print(
            f"soak: {t['committed']} committed / {t['attempts']} attempts "
            f"in {t['sim_seconds']}s sim ({t['goodput_tps']} txn/s goodput)"
        )
        for ph in report["phases"]:
            print(
                f"  {ph['name']:<9} goodput={ph['goodput_tps']:<8} "
                f"(floor {ph['goodput_floor_tps']}) "
                f"p99={ph['commit_p99_chain']} "
                f"throttled={ph['throttled']} "
                f"{'OK' if ph['slo_ok'] else 'SLO-MISS'}"
            )
        for t0, kind, detail, t1 in report["faults"]:
            print(f"  fault {kind} [{t0:.2f}s..{t1:.2f}s] {detail}")
        print(f"  slo: {'OK' if report['slo']['ok'] else 'MISSED'}")
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(blob + "\n")
    return 0 if report["slo"]["ok"] else 1


def soak_artifact(report: dict) -> dict:
    """BENCH-style artifact shape (one headline metric + the structured
    evidence), mirroring bench.py's {"metric", "value", "unit", ...}
    convention, so a collection of BENCH_r0*.json files can absorb it."""
    t = report["totals"]
    return {
        "metric": "soak_goodput_txn_per_sec",
        "value": t["goodput_tps"],
        "unit": "txn/s",
        "sim_seconds": t["sim_seconds"],
        "committed": t["committed"],
        "attempts": t["attempts"],
        "seed": report["config"]["seed"],
        "cluster": report["config"]["cluster"],
        "backend": report["config"]["backend"],
        "phases": report["phases"],
        "throttle_shed": report["throttle_shed"],
        "fault_timeline": report["faults"],
        "ratekeeper_transitions": report["ratekeeper"]["admission_log"],
        "breaker_transitions": report["breakers"],
        "slo": report["slo"],
        "flight_recorder": report.get("flight_recorder", {}).get(
            "status", {}
        ),
    }


def main(argv=None):  # pragma: no cover - interactive entry
    import sys

    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "soak":
        return soak_main(argv[1:])

    from ..server import SimCluster

    cluster = SimCluster(seed=0)
    db = cluster.database("cli")
    cli = CliProcessor(cluster, db)
    print("fdbcli (tpu-kv simulated cluster); type `help' for help")
    while True:
        try:
            line = input("fdb> ")
        except (EOFError, KeyboardInterrupt):
            break
        if line.strip() in ("exit", "quit"):
            break

        async def run():
            return await cli.run_command(line)

        task = db.process.spawn(run())
        out = cluster.loop.run_until(task, timeout_vt=60.0)
        for ln in out:
            print(ln)
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main() or 0)
