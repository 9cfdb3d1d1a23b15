"""The port's commit path, held to the reference's ``SimCluster`` on the CPU.

The reference's ``server/cluster.py`` SimCluster (on the reference's event
loop, network and roles) and the port's (on the port's) serve one seeded
script of raw requests from a client process: GRVs; commits with
``SET_VALUE``, ``CLEAR_RANGE``, an atomic add, a versionstamped key and
value, a read-write conflict and a too-old read after a 6 s virtual delay;
one state transaction on a ``\\xff/conf/`` key; ``get_value`` and
``get_key_values`` (forward, reverse, limited) at several versions, a read
at a future version, and a watch.  Resolver 0 of each cluster runs over
its own port ``ConflictSet(device="cpu")`` built alike (or each cluster
builds its own host engine with ``conflict_backend="cpu"``), so no XLA
program is compiled.

The script is chip_smoke.py's ``commit_script`` (phase 6k runs it on the
card), and the record its ``cluster_record``.  Held equal: every reply (its payload, or its error's name and detail) and
its virtual time; the sequencer's version and committed version; each
tlog's versions, tagged entries and pops; the storage's window (keys,
version chains, clears) and byte sample; every proxy's and resolver's
``metrics.snapshot()``; each resolver's ``conflict_witness()`` and its
exported conflict-set state; the loop's end time and its rng's next draw.

A second script drives the metadata half of the path through clusters
with two storages: ``\\xff/serverList/`` and ``\\xff/keyServers/``
commits that seed, split and move a shard from one storage to the other
(the destination fetches it while commits land in it), reads on both
sides of the move, the storages' shard state, metrics, version and
ownership dumps, the proxies' key locations, the ``\\xff/dbLocked`` lock
and unlock, a resolver split, a recovery-time system map, and, with a
scripted ratekeeper attached to every proxy, throttled and shed read
versions; then the same with the port's own Ratekeeper attached (its
rate, transitions log and registry held to the reference's).  Held
equal as above, plus each storage's ownership, adding and availability
maps and each proxy's key-server map, server list, lock and resolver
bounds.  The TLog's commit, peek, pop, metrics and confirm
streams, its lock, ``truncate_above`` and ``append_raw`` are held to the
reference's on one log.

Shapes are the reference rig's: key_words=3, h_cap=1<<10,
bucket_mins=(32, 128, 64).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import types as pytypes
from dataclasses import dataclass

import pytest

import foundationdb_tpu.client.types as ref_types
import foundationdb_tpu.flow.eventloop as ref_el
import foundationdb_tpu.flow.flight_recorder as ref_fr
import foundationdb_tpu.flow.spans as ref_spans
import foundationdb_tpu.flow.trace as ref_trace
import foundationdb_tpu.server.interfaces as ref_if
import foundationdb_tpu.server.system_keys as ref_sk
from foundationdb_tpu.server.cluster import SimCluster as RefSimCluster
from foundationdb_tpu_torch.client import types as port_types
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.engine_cpu import CpuConflictSet
from foundationdb_tpu_torch.flow import eventloop as port_el
from foundationdb_tpu_torch.flow import flight_recorder as port_fr
from foundationdb_tpu_torch.flow import sim_validation as port_sv
from foundationdb_tpu_torch.flow import spans as port_spans
from foundationdb_tpu_torch.flow import timeseries as port_ts
from foundationdb_tpu_torch.flow import trace as port_trace
from foundationdb_tpu_torch.server import interfaces as port_if
from foundationdb_tpu_torch.server import system_keys as port_sk
from foundationdb_tpu_torch.server.cluster import SimCluster as PortSimCluster

# The script and the record are chip_smoke.py's (phase 6k runs them on the
# card); the file is loaded as a module, as tests/test_torch_cuda.py does.
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)

# The packages' flow/__init__ may bind a function over the module's name.
ref_buggify = importlib.import_module("foundationdb_tpu.flow.buggify")
port_buggify = importlib.import_module("foundationdb_tpu_torch.flow.buggify")

PKGS = {
    "ref": (RefSimCluster, ref_types, ref_if, ref_el),
    "port": (PortSimCluster, port_types, port_if, port_el),
}
BASES = {"ref": "foundationdb_tpu", "port": "foundationdb_tpu_torch"}
SYSTEM_KEYS = {"ref": ref_sk, "port": port_sk}


@pytest.fixture(autouse=True)
def _restore_globals():
    saved = (ref_spans.global_span_hub(), ref_trace.global_collector(),
             ref_fr.global_flight_recorder(), port_spans.global_span_hub(),
             port_trace.global_collector(), port_trace._global_clock,
             port_fr.global_flight_recorder(), port_ts.global_timeseries())
    yield
    ref_el.set_event_loop(None)
    port_el.set_event_loop(None)
    ref_buggify.set_buggify_enabled(False)
    port_buggify.set_buggify_enabled(False)
    ref_spans.set_global_span_hub(saved[0])
    ref_trace.set_global_collector(saved[1])
    ref_fr.set_global_flight_recorder(saved[2])
    port_spans.set_global_span_hub(saved[3])
    port_trace.set_global_collector(saved[4], clock=saved[5])
    port_fr.set_global_flight_recorder(saved[6])
    port_ts.set_global_timeseries(saved[7])


def _install_hubs(pkg):
    """Fresh span hub, trace collector and flight recorder of `pkg`'s
    package, installed into both packages' globals."""
    if pkg == "ref":
        hub, col, rec = ref_spans.SpanHub(), ref_trace.TraceCollector(), ref_fr.FlightRecorder()
    else:
        hub, col, rec = port_spans.SpanHub(), port_trace.TraceCollector(), port_fr.FlightRecorder()
    ref_spans.set_global_span_hub(hub)
    port_spans.set_global_span_hub(hub)
    ref_trace.set_global_collector(col)
    port_trace.set_global_collector(col)
    ref_fr.set_global_flight_recorder(rec)
    port_fr.set_global_flight_recorder(rec)
    port_ts.set_global_timeseries(port_ts.TimeSeriesHub())


def _port_set(depth):
    return ConflictSet(device="cpu", pipeline_depth=depth, key_words=3,
                       bucket_mins=(32, 128, 64), h_cap=1 << 10)


def run_script(pkg, seed, conflict_set=None, **cluster_kw):
    """chip_smoke's commit_script through `pkg`'s SimCluster; returns its
    cluster_record and the cluster."""
    Cluster, types, itf, el = PKGS[pkg]
    _install_hubs(pkg)
    c = Cluster(seed=seed, conflict_set=conflict_set, **cluster_kw)
    record = SMOKE.cluster_record(c, types, itf, _exported_state)
    el.set_event_loop(None)
    return record, c


def _exported_state(cs):
    mirror = (list(cs._cpu.keys), list(cs._cpu.vers), cs._cpu.oldest_version)
    dev = cs._dev if isinstance(cs, ConflictSet) else cs._jax
    if dev is None:
        return mirror
    out = CpuConflictSet()
    dev.store_to(out)
    return mirror, (list(out.keys), list(out.vers), out.oldest_version)


def _pair(seed, depth=None, **cluster_kw):
    """The reference's run and the port's, resolver 0 over a fresh port
    set at `depth` each (or each cluster's own sets with depth None);
    asserts every record equal and returns the port's."""
    ref, _ = run_script("ref", seed, _port_set(depth) if depth else None, **cluster_kw)
    port, c = run_script("port", seed, _port_set(depth) if depth else None, **cluster_kw)
    assert port["replies"] == ref["replies"]
    for key in ref:
        assert port[key] == ref[key], key
    return port, c


def _by_label(rec):
    return {r[0]: r[2:] for r in rec["replies"]}


CASES = [
    # (id, seed, depth, cluster kwargs)
    ("depth1", 5, 1, dict(buggify=False, n_proxies=2, n_tlogs=2)),
    ("depth2", 5, 2, dict(buggify=False, n_proxies=2, n_tlogs=2)),
    ("depth3", 5, 3, dict(buggify=False, n_proxies=2, n_tlogs=2)),
    ("depth2-buggify", 11, 2, dict(buggify=True, n_proxies=2, n_tlogs=2)),
    ("cpu", 5, None, dict(conflict_backend="cpu", buggify=False)),
    ("cpu-buggify", 17, None, dict(conflict_backend="cpu", buggify=True, n_proxies=2)),
    ("one-proxy-one-log", 23, 2, dict(buggify=False, n_proxies=1, n_tlogs=1)),
    ("two-resolvers", 29, None, dict(conflict_backend="cpu", buggify=True, n_proxies=2,
                                     n_resolvers=2, n_tlogs=2)),
    ("satellite", 31, 1, dict(buggify=False, n_proxies=2, n_tlogs=2, n_satellite_tlogs=1)),
]


@pytest.mark.parametrize("seed,depth,kw", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_commit_path_matches_the_reference(seed, depth, kw):
    rec, c = _pair(seed, depth, **kw)
    got = _by_label(rec)
    if not kw.get("buggify"):
        # What the script is built to show, where no fault site fires.
        assert got["t1"][0] == "reply" and got["t2"][0] == "reply" and got["t4"][0] == "reply"
        assert got["t3"][:2] == ("error", "not_committed")
        assert got["t3"][2]["range"] == (b"a", b"a\x00")
        assert got["too old"][:2] == ("error", "transaction_too_old")
        assert got["get @v0 late"][:2] == ("error", "transaction_too_old")
        assert got["watch"][0] == "reply" and got["future"][0] == "reply"
        assert got["get b'c1' @v1"][1][1][0][1] is None  # cleared by t2
        final = dict(got["range @v2"][1][1][0][1])
        assert final[b"a"] == b"3" and b"z" not in final  # t3 lost
        # The acknowledged commits' version is what sim_validation marked.
        acked = max(v[1] for k, v in got.items() if k.startswith("t") and v[0] == "reply")
        assert port_sv.marked(c.loop, "acked_commit") >= acked
    # Every tlog holds every version the sequencer handed out.
    assert all(t[0] == rec["tlogs"][0][0] for t in rec["tlogs"])
    counters = [json.loads(s)["counters"] for s in rec["proxies"]]
    assert sum(x["committed"] for x in counters) >= 4


def test_port_cluster_defaults_to_the_card():
    """SimCluster() builds its resolvers' sets on the card: with no card it
    raises and never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortSimCluster(seed=1)
    port_el.set_event_loop(None)


# ---------------------------------------------------------------------------
# The metadata half: shard moves between two storages, the lock, the
# resolver split, the recovery-time map and the ratekeeper's GRV lane
# ---------------------------------------------------------------------------


@dataclass
class RateInfo:
    """The scripted ratekeeper's reply: the two fields the proxy reads."""

    tps: float
    batch_tps: float


def _attach_ratekeeper(c, pkg):
    """A ratekeeper process on `c`'s network answering every rate fetch,
    0.05 s after it arrives, with 5,000 tps (batch lane 50), attached to
    every proxy; returns the list of requests it served."""
    stream = importlib.import_module(f"{BASES[pkg]}.rpc.stream")
    proc = c.net.process("ratekeeper")
    rates = stream.RequestStream(proc, "get_rate", well_known=True)
    asked = []

    async def serve():
        while True:
            req, reply = await rates.pop()
            asked.append((c.loop.now(), SMOKE.norm(req)))
            await c.loop.delay(0.05)
            reply.send(RateInfo(tps=5000.0, batch_tps=50.0))

    proc.spawn(serve(), "ratekeeper")
    for p in c.proxies:
        p.ratekeeper = pytypes.SimpleNamespace(get_rate=rates.ref())
    return asked


# Rows in the moving shard: its fetch takes three pages of the storage's
# FETCH_SHARD_PAGE_ROWS.
BULK_ROWS = 12_000
# Commits into the moving shard, 0.4 ms apart: some land after the
# destination's fetch snapshot and before its last page.
DURING_MOVE = 16


def metadata_script(c, types, itf, sk, keyspace_end, ratekeeper=False):
    """Raw requests from one client process through a SimCluster `c` with
    two storages: data, then serverList and keyServers commits that seed
    the shard map, split it at k010 and \\xff and move [k010, \\xff) from
    ss0 to ss1 (commits land in it while ss1 fetches; ss1's shard state is
    polled until fetched, then the move settles); reads on both storages,
    below the fetched shard's floor and on the wrong side; each storage's
    shard state, metrics, version and ownership dump; each proxy's key
    locations; \\xff/dbLocked lock, a refused commit and GRV, a lock-aware
    GRV, unlock; with two resolvers a resolver split at k015 and a conflict
    across it; a recovery-time system map; with `ratekeeper`, bursts of
    default and batch-priority GRVs, the second past the proxy's queue
    bound.  Returns every reply as commit_script does."""
    loop = c.loop
    M, MT = types.Mutation, types.MutationType
    client = c.net.process("client")
    proxies = [p.interface() for p in c.proxies]
    ss = [s.interface() for s in c.storages]
    out = []

    def txn(snap, muts, reads=(), flags=0, writes=None):
        if writes is None:
            writes = [(m.param1, m.param2) if m.type == MT.CLEAR_RANGE
                      else (m.param1, m.param1 + b"\x00") for m in muts]
        return itf.CommitTransactionRequest(
            transaction=types.CommitTransactionRef(
                read_snapshot=snap, read_conflict_ranges=list(reads),
                write_conflict_ranges=writes, mutations=list(muts)),
            flags=flags)

    def put(key, value):
        return M(MT.SET_VALUE, key, value)

    def shard(begin, src, dest, end):
        return put(sk.key_servers_key(begin), sk.encode_key_servers(src, dest, end))

    async def call(label, stream, req):
        try:
            v = await stream.get_reply(client, req)
        except Exception as e:  # noqa: BLE001 - the roles' FdbError
            out.append((label, loop.now(), "error", e.name))
            return None
        out.append((label, loop.now(), "reply", SMOKE.norm(v)))
        return v

    async def grv(label, proxy=0, flags=0):
        return await call(label, proxies[proxy].get_consistent_read_version,
                          itf.GetReadVersionRequest(flags=flags))

    async def commit(label, muts, proxy=0, reads=(), snap=None, lock_aware=False):
        if snap is None:
            snap = await grv(f"grv {label}", proxy,
                             itf.GRV_FLAG_LOCK_AWARE if lock_aware else 0)
        flags = itf.COMMIT_FLAG_LOCK_AWARE if lock_aware else 0
        return await call(label, proxies[proxy].commit, txn(snap, muts, reads, flags))

    async def locations(label):
        for i, p in enumerate(proxies):
            await call(f"{label} via proxy {i}", p.get_key_servers_locations,
                       itf.GetKeyServersLocationsRequest(begin=b"", end=keyspace_end))

    async def storages(label, version):
        for i, s in enumerate(ss):
            await call(f"{label} shard state ss{i}", s.get_shard_state,
                       itf.GetShardStateRequest(begin=b"", end=b"\xff"))
            await call(f"{label} metrics ss{i}", s.get_storage_metrics,
                       itf.GetStorageMetricsRequest(begin=b"k", end=b"l"))
            await call(f"{label} signals ss{i}", s.get_storage_metrics,
                       itf.GetStorageMetricsRequest(signals_only=True))
            await call(f"{label} version ss{i}", s.get_version, None)
            await call(f"{label} owned ss{i}", s.get_owned_meta,
                       itf.GetOwnedMetaRequest(min_version=version))

    async def script():
        await loop.delay(0.01)
        await commit("fill", [put(b"k%03d" % i, b"v%d" % i) for i in range(20)])
        # Rows enough for the move's fetch to take several pages.
        await call("bulk", proxies[0].commit, txn(
            0, [put(b"m%05d" % i, b"%d" % i) for i in range(BULK_ROWS)], writes=[(b"m", b"n")]))
        await commit("servers", [put(sk.server_list_key(f"ss{i}"), sk.encode_server_entry(s))
                                 for i, s in enumerate(ss)], proxy=-1)
        await commit("seed", [shard(b"", ["ss0"], [], keyspace_end)])
        await commit("split", [shard(b"", ["ss0"], [], b"k010"),
                               shard(b"k010", ["ss0"], [], b"\xff"),
                               shard(b"\xff", ["ss0"], [], keyspace_end)], proxy=-1)
        before = await grv("grv before the move")
        await locations("split")
        # Commits into the shard follow the start record by a few
        # milliseconds each, while ss1 fetches it: ss1 buffers them and
        # replays the tail its snapshot missed.
        one = (1).to_bytes(8, "little")
        during = [client.spawn(commit("start move", [shard(b"k010", ["ss0"], ["ss1"], b"\xff")],
                                      snap=before))]
        for i in range(DURING_MOVE):
            muts = [put(b"k015", b"mid"), M(MT.CLEAR_RANGE, b"k011", b"k013"),
                    put(b"k025", b"new"), M(MT.ADD_VALUE, b"k030", one),
                    M(MT.CLEAR_RANGE, b"k017", b"k018"), put(b"k016", b"16-%d" % i)][i % 6:][:2]
            await loop.delay(0.0004)
            during.append(client.spawn(commit(f"during move {i}", muts, proxy=i % 2 - 1,
                                              snap=before)))
        for f in during:
            await f
        for i in range(100):
            st = await call(f"poll {i}", ss[1].get_shard_state,
                            itf.GetShardStateRequest(begin=b"k010", end=b"\xff"))
            if st in ("fetched", "readable"):
                break
            await loop.delay(0.05)
        await commit("finish move", [shard(b"k010", ["ss1"], [], b"\xff")])
        await loop.delay(0.1)
        after = await grv("grv after the move", -1)
        for i, s in enumerate(ss):
            for key in (b"k005", b"k012", b"k015", b"k025"):
                await call(f"get {key!r} ss{i}", s.get_value,
                           itf.GetValueRequest(key=key, version=after))
        await call("range ss0", ss[0].get_key_values,
                   itf.GetKeyValuesRequest(begin=b"k", end=b"k010", version=after))
        await call("range ss1", ss[1].get_key_values,
                   itf.GetKeyValuesRequest(begin=b"k010", end=b"k030", version=after))
        await call("range ss1 reverse", ss[1].get_key_values,
                   itf.GetKeyValuesRequest(begin=b"k010", end=b"k030", version=after,
                                           reverse=True, limit=3))
        await call("below the fetched floor", ss[1].get_value,
                   itf.GetValueRequest(key=b"k015", version=before))
        await storages("moved", after)
        await locations("moved")
        # The lock: only lock-aware work passes while \xff/dbLocked holds a
        # uid, on every proxy.
        await commit("lock", [put(sk.DB_LOCKED_KEY, b"uid1")], lock_aware=True)
        await commit("locked write", [put(b"k001", b"no")], proxy=-1, snap=after)
        await grv("locked grv", -1)
        await grv("lock-aware grv", -1, itf.GRV_FLAG_LOCK_AWARE)
        await commit("unlock", [put(sk.DB_LOCKED_KEY, b"")], proxy=-1, lock_aware=True)
        await commit("after unlock", [put(b"k001", b"yes")], proxy=-1)
        # Proxy 0 learns the unlock from the resolvers at its next batch.
        await commit("lock-aware write on proxy 0", [put(b"k003", b"la")], lock_aware=True)
        await commit("after unlock on proxy 0", [put(b"k004", b"ok")])
        if len(c.resolvers) > 1:
            await commit("resolver split", [put(sk.RESOLVER_SPLIT_KEY,
                                                sk.encode_resolver_split([b"k015"]))])
            snap = await grv("grv across the split", -1)
            await commit("write k012", [put(b"k012", b"w")], proxy=-1)
            await commit("read k012 and k020 at the old snapshot", [put(b"k020", b"r")],
                         reads=[(b"k012", b"k013"), (b"k020", b"k021")], snap=snap)
        await call("load the system map", proxies[0].load_system_map,
                   ([(b"", b"k010", ["ss0"]), (b"k010", b"\xff", ["ss1"])],
                    {"ss0": ss[0], "ss1": ss[1]}))
        await locations("loaded")
        if ratekeeper:
            burst = [client.spawn(grv(f"burst {i}", i % 2, itf.GRV_FLAG_PRIORITY_BATCH * (i % 3 == 0)))
                     for i in range(60)]
            for f in burst:
                await f
            # The flood piles up behind the proxy's next rate fetch.
            await loop.delay(0.2)
            flood = [client.spawn(grv(f"flood {i}", 0, itf.GRV_FLAG_PRIORITY_BATCH * (i < 40)))
                     for i in range(2100)]
            for f in flood:
                await f
        await commit("last", [put(b"k002", b"z")], proxy=-1)

    c.run_until(client.spawn(script(), "script"), timeout_vt=120.0)
    return out


def _rangemap(m, value=lambda v: v):
    return [(b, e, value(v)) for b, e, v in m.items()]


def metadata_record(c, types, itf, sk, keyspace_end, export, ratekeeper=False):
    """metadata_script's replies through `c` and the cluster after it: each
    storage's ownership, adding (each AddingShard's phase, extent, sources,
    fetch version and settle flag) and availability maps, server list,
    window, version and byte sample; each proxy's key-server map, server
    list, lock, resolver bounds, rate info and registry snapshot; the
    tlogs, the sequencer, each resolver's snapshot, witness block and set
    state; what the ratekeeper was asked; the loop's end and rng."""
    pkg = "ref" if type(c) is RefSimCluster else "port"
    rk = None
    if ratekeeper == "real":
        rk = importlib.import_module(f"{BASES[pkg]}.server.ratekeeper").Ratekeeper(
            c.master_proc, c.tlogs, c.storages, resolvers=c.resolvers, proxies=c.proxies)
        for p in c.proxies:
            p.ratekeeper = rk.interface()
        asked = []
    else:
        asked = _attach_ratekeeper(c, pkg) if ratekeeper else []
    replies = metadata_script(c, types, itf, sk, keyspace_end, ratekeeper)
    if rk is not None:
        asked = [rk.transition_log_json(), SMOKE.norm(rk.rate), rk.metrics.snapshot_json()]

    def adding(a):
        return a and (a.phase, a.begin, a.end, a.src_ids, a.fetch_version, a.finalized,
                      SMOKE.norm(a.buffer))

    return dict(
        replies=replies,
        storages=[(_rangemap(s.owned), _rangemap(s.adding, adding), _rangemap(s.avail),
                   sorted(s.server_list), SMOKE.norm(s.store.kv), s.store.sorted_keys,
                   list(s.store.clears), s.version.get(), s.durable_version, s.input_bytes,
                   s.byte_sample.idx.keys_in(b"", None), s.byte_sample.bytes_in(b"", None))
                  for s in c.storages],
        proxies=[(_rangemap(p.key_servers), sorted(p.server_list), p.locked_uid,
                  p.resolver_bounds, SMOKE.norm(p.last_rate_info), p.metrics.snapshot_json())
                 for p in c.proxies],
        tlogs=[(t.versions, SMOKE.norm(t.entries), t.popped_tags, t.popped, t.durable.get())
               for t in c.tlogs],
        sequencer=(c.sequencer.version, c.sequencer.committed.get()),
        resolvers=[r.metrics.snapshot_json() for r in c.resolvers],
        witness=[r.conflict_witness() for r in c.resolvers],
        sets=[export(r.conflicts) for r in c.resolvers],
        asked=asked,
        end=(c.loop.now(), c.loop.rng.random_int(0, 1 << 30)),
    )


def run_metadata(pkg, seed, conflict_set=None, ratekeeper=False, **cluster_kw):
    Cluster, types, itf, el = PKGS[pkg]
    storage = importlib.import_module(f"{BASES[pkg]}.server.storage")
    _install_hubs(pkg)
    c = Cluster(seed=seed, conflict_set=conflict_set, n_storages=2, **cluster_kw)
    # The bulk rows would be deep-copied at every hop; the network's own
    # option hands payloads over as they are (commit_script's cases keep
    # the copies).
    c.net.deep_copy = False
    record = metadata_record(c, types, itf, SYSTEM_KEYS[pkg], storage.KEYSPACE_END,
                             _exported_state, ratekeeper)
    el.set_event_loop(None)
    return record


META_CASES = [
    # (id, seed, depth, ratekeeper, cluster kwargs)
    ("cpu", 7, None, False, dict(conflict_backend="cpu", buggify=False, n_proxies=2, n_tlogs=2)),
    ("cpu-buggify", 8, None, False, dict(conflict_backend="cpu", buggify=True, n_proxies=2,
                                         n_tlogs=2)),
    ("depth2", 12, 2, False, dict(buggify=False, n_proxies=2, n_tlogs=2)),
    ("two-resolvers", 9, None, False, dict(conflict_backend="cpu", buggify=False, n_proxies=2,
                                           n_resolvers=2)),
    ("ratekeeper", 10, None, True, dict(conflict_backend="cpu", buggify=False, n_proxies=2)),
    # The port's Ratekeeper beside the scripted one, held to the reference's.
    ("real-ratekeeper", 10, None, "real", dict(conflict_backend="cpu", buggify=False,
                                               n_proxies=2)),
]


@pytest.mark.parametrize("seed,depth,ratekeeper,kw", [c[1:] for c in META_CASES],
                         ids=[c[0] for c in META_CASES])
def test_shard_moves_and_metadata_match_the_reference(seed, depth, ratekeeper, kw):
    ref = run_metadata("ref", seed, _port_set(depth) if depth else None, ratekeeper, **kw)
    port = run_metadata("port", seed, _port_set(depth) if depth else None, ratekeeper, **kw)
    assert port["replies"] == ref["replies"]
    for key in ref:
        assert port[key] == ref[key], key
    got = {r[0]: r[2:] for r in port["replies"]}
    if not kw.get("buggify"):
        # What the script is built to show, where no fault site fires.
        assert got["get b'k015' ss0"] == ("error", "wrong_shard_server")
        assert got["get b'k015' ss1"][1][1][0][1] == b"mid"
        assert got["get b'k012' ss1"][1][1][0][1] is None  # cleared during the fetch
        assert got["get b'k005' ss0"][1][1][0][1] == b"v5"
        assert got["get b'k005' ss1"] == ("error", "wrong_shard_server")
        assert got["below the fetched floor"] == ("error", "transaction_too_old")
        assert got["locked write"] == ("error", "database_locked")
        assert got["locked grv"] == ("error", "database_locked")
        assert got["lock-aware grv"][0] == "reply" and got["after unlock"][0] == "reply"
        owned = [[(b, e) for b, e, v in s[0] if v] for s in port["storages"]]
        assert owned == [[(b"", b"k010"), (b"\xff", None)], [(b"k010", b"\xff")]]
    if kw.get("n_resolvers") == 2:
        assert got["read k012 and k020 at the old snapshot"][:2] == ("error", "not_committed")
        assert all(p[3] == [(b"", b"k015"), (b"k015", None)] for p in port["proxies"])
    if ratekeeper:
        errors = [r[3] for r in port["replies"] if r[0].startswith("flood") and r[2] == "error"]
        assert errors and set(errors) <= {"batch_transaction_throttled",
                                          "proxy_memory_limit_exceeded"}
        assert port["asked"] and all(p[4] for p in port["proxies"])


# ---------------------------------------------------------------------------
# One TLog: its streams, lock, truncate_above and append_raw
# ---------------------------------------------------------------------------


def tlog_record(pkg):
    """A scripted TLog on `pkg`'s own loop and network: commits out of
    order (one parks on its prev_version), a duplicate, an empty version
    and a stale epoch; peeks by tag, of every tag, raw-tagged and limited;
    metrics and confirm; pops by two tags, a peek below the popped floor
    (refused, then served from the floor), an unregister; truncate_above,
    append_raw (invisible to peeks above the durable version); the lock.
    Returns every reply and the log's state after each step."""
    base = BASES[pkg]
    el = importlib.import_module(f"{base}.flow.eventloop")
    network = importlib.import_module(f"{base}.rpc.network")
    tlog = importlib.import_module(f"{base}.server.tlog")
    _cluster, types, itf, _el = PKGS[pkg]
    loop = el.EventLoop(seed=3)
    el.set_event_loop(loop)
    net = network.SimNetwork(loop)
    tl = tlog.TLog(net.process("tlog"))
    client = net.process("client")
    log_ = tl.interface()
    M, MT = types.Mutation, types.MutationType
    out = []

    def bundle(v):
        return {"ss0": [(0, M(MT.SET_VALUE, b"k%d" % v, b"v"))],
                "ss1": [(1, M(MT.ADD_VALUE, b"n", b"\x01"))],
                itf.TAG_ALL: [(2, M(MT.SET_VALUE, b"\xff/x", b"%d" % v))]}

    def push(prev, version, tagged, known=0, epoch=0):
        return itf.TLogCommitRequest(prev_version=prev, version=version, tagged=tagged,
                                     known_committed=known, epoch=epoch)

    def state(label):
        out.append((label, loop.now(), "state", list(tl.versions), SMOKE.norm(tl.entries),
                    tl.popped, dict(tl.popped_tags), sorted(tl._dead_tags), tl._mem_bytes,
                    list(tl._ver_bytes), tl.durable.get(), tl.known_committed, tl.locked))

    async def call(label, stream, req):
        try:
            v = await stream.get_reply(client, req)
        except Exception as e:  # noqa: BLE001 - the log's FdbError
            out.append((label, loop.now(), "error", e.name))
            return
        out.append((label, loop.now(), "reply", SMOKE.norm(v)))

    async def script():
        await call("commit 10", log_.commit, push(0, 10, bundle(10)))
        parked = client.spawn(call("commit 30", log_.commit, push(20, 30, bundle(30), 10)))
        await call("commit 20", log_.commit, push(10, 20, bundle(20), 10))
        await parked
        await call("commit 20 again", log_.commit, push(10, 20, bundle(20), 10))
        await call("commit 40", log_.commit, push(30, 40, {}, 30))
        await call("stale epoch", log_.commit, push(40, 50, bundle(50), 30, epoch=1))
        state("committed")
        for label, req in (
            ("peek ss0", itf.TLogPeekRequest(begin_version=0, tags=["ss0", itf.TAG_ALL])),
            ("peek all", itf.TLogPeekRequest(begin_version=10, tags=None)),
            ("peek raw", itf.TLogPeekRequest(begin_version=0, tags=["ss1"], raw_tagged=True)),
            ("peek limited", itf.TLogPeekRequest(begin_version=0, tags=None, limit_versions=1)),
        ):
            await call(label, log_.peek, req)
        await call("metrics", log_.metrics, None)
        await call("confirm", log_.confirm, None)
        await call("pop ss0", log_.pop, itf.TLogPopRequest(version=25, tag="ss0"))
        await call("pop ss1", log_.pop, itf.TLogPopRequest(version=15, tag="ss1"))
        state("popped")
        await call("peek below", log_.peek, itf.TLogPeekRequest(begin_version=5))
        await call("peek below allowed", log_.peek,
                   itf.TLogPeekRequest(begin_version=5, allow_below_begin=True, tags=None))
        await call("unregister ss1", log_.pop, itf.TLogPopRequest(tag="ss1", unregister=True))
        state("unregistered")
        await tl.truncate_above(35)
        state("truncated")
        tl.append_raw(45, bundle(45))
        state("appended")
        await call("peek appended", log_.peek, itf.TLogPeekRequest(begin_version=25, tags=None))
        tl.locked = True
        await call("commit locked", log_.commit, push(40, 60, bundle(60), 40))
        state("locked")

    loop.run_until(client.spawn(script(), "script"), timeout_vt=10.0)
    el.set_event_loop(None)
    return out


def test_tlog_lock_truncate_and_append_match_the_reference():
    port = tlog_record("port")
    assert port == tlog_record("ref")
    got = {r[0]: r[2:] for r in port}
    assert got["stale epoch"] == ("error", "tlog_stopped")
    assert got["commit locked"] == ("error", "tlog_stopped")
    assert got["peek below"] == ("error", "peek_below_begin")
    assert got["truncated"][1] == [30] and got["appended"][1] == [30, 45]
