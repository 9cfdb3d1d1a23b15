"""The runtime face of fdblint's DET family over the port: determinism of
what the port records, across interpreters and across runs.

The twin of tests/test_determinism.py:71-140.  The reference's
``SimCluster(seed=211, n_proxies=2)`` serves the same seeded workload
through the port's ``ConflictSet(device="cpu", h_cap=1 << 10)``, with the
port's ``SpanHub`` and ``TraceCollector`` installed on the loop's clock and
three scripted dispatch faults that open and close the port's breaker, in
two interpreters with PYTHONHASHSEED 1 and 2: the spans logs (the
reference's and the port's), the resolver's and proxy's snapshots, the
port set's snapshot and the port's trace events are byte-identical.  In one process, two runs of one seeded stream through
the port's ``ConflictSet`` and ``ShardedTorchConflictSet`` (with a scripted
dispatch fault, so the degraded path's timer runs) give equal snapshots
and spans less the wall clock, whose namespace still holds the names it
held before the reads went through ``metrics.wall_now()``.
"""

import itertools
import json
import os
import subprocess
import sys

from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector
from foundationdb_tpu_torch.flow import spans as port_spans
from foundationdb_tpu_torch.parallel.sharded_resolver import ShardedTorchConflictSet

from test_torch_api import _port_txns, _random_stream, k

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TELEMETRY_SCRIPT = r"""
import json
import sys
sys.path.insert(0, %r)
import jax
jax.config.update("jax_platforms", "cpu")
from foundationdb_tpu.flow.eventloop import all_of
from foundationdb_tpu.flow.spans import SpanHub, set_global_span_hub, global_span_hub
from foundationdb_tpu.server import SimCluster
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector
from foundationdb_tpu_torch.flow import spans as port_spans
from foundationdb_tpu_torch.flow import trace as port_trace

set_global_span_hub(SpanHub())
# Three dispatch faults open the port's breaker, so its trace events log.
inj = DeviceFaultInjector()
inj.script("dispatch", at=4, persist=3)
cs = ConflictSet(device="cpu", h_cap=1 << 10, fault_injector=inj)
c = SimCluster(seed=211, n_proxies=2, conflict_set=cs)
port_spans.set_global_span_hub(port_spans.SpanHub(clock=c.loop.now))
port_trace.set_global_collector(port_trace.TraceCollector(), clock=c.loop.now)
db = c.database()

async def actor(aid):
    for r in range(3):
        async def op(tr, aid=aid, r=r):
            cur = await tr.get(b"shared")
            tr.set(b"shared", (cur or b"") + b"%%d" %% aid)
            tr.set(b"t%%02d/%%02d" %% (aid, r), b"v")
        await db.run(op)

async def drive():
    await all_of([db.process.spawn(actor(i), "wl_%%d" %% i) for i in range(4)])

c.run_all([(db, drive())], timeout_vt=3000.0)
now = c.loop.now()
print("spans:", global_span_hub().spans_json())
print("port spans:", port_spans.global_span_hub().spans_json())
print("resolver:", c.resolver.metrics.snapshot_json(now=now))
print("proxy:", c.proxy.metrics.snapshot_json(now=now))
print("port set:", json.dumps(cs._dev.metrics.snapshot(now=now), sort_keys=True))
print("port events:", json.dumps(port_trace.global_collector().events, sort_keys=True))
""" % (REPO,)


def _run_telemetry(hashseed: str) -> str:
    env = dict(os.environ, PYTHONHASHSEED=hashseed, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", TELEMETRY_SCRIPT], capture_output=True,
                       text=True, timeout=180, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    return p.stdout


def test_telemetry_through_the_port_byte_identical_across_hash_seeds():
    a = _run_telemetry("1")
    b = _run_telemetry("2")
    lines = dict(ln.split(": ", 1) for ln in a.splitlines())
    assert sorted(lines) == ["port events", "port set", "port spans", "proxy", "resolver",
                             "spans"]
    # The port served the cluster: its set dispatched, its hooks recorded.
    port_set = json.loads(lines["port set"])
    assert port_set["counters"]["batches"] > 20
    assert port_set["counters"]["pipeline_dispatches"] == port_set["counters"]["batches"]
    assert '"name":"dispatch"' in lines["port spans"]
    # The breaker's events carry the loop's virtual time, not the wall's.
    events = json.loads(lines["port events"])
    assert [(e["from"], e["to"]) for e in events] == [
        ("ok", "degraded"), ("degraded", "probing"), ("probing", "ok")]
    assert all(0 < e["Time"] < 1.0 for e in events)
    assert a == b, f"nondeterminism across interpreters:\nA:\n{a[:2000]}\nB:\n{b[:2000]}"


def _counting_hub():
    """A SpanHub on a clock that counts its own reads."""
    ticks = itertools.count()
    return port_spans.SpanHub(clock=lambda: float(next(ticks)))


def _run_set(make, stream, sharded, **fault):
    """`stream` through a fresh set under a fresh counting-clock hub, with
    dispatch faults scripted from the 4th dispatch (`fault`: the script's
    persist and shard), so the degraded path's wall timer runs.  Returns
    verdicts and witnesses, the snapshot less the wall namespace, the
    spans, the wall namespace and the set."""
    saved = port_spans.global_span_hub()
    hub = _counting_hub()
    port_spans.set_global_span_hub(hub)
    inj = DeviceFaultInjector()
    inj.script("dispatch", at=4, **fault)
    try:
        cs = make(inj)
        out = []
        for txns, now, nov in stream:
            if sharded:
                out.append((cs.detect(_port_txns(txns), now, nov), list(cs.last_witness)))
            else:
                e = cs.pipeline_submit(_port_txns(txns), now, nov)
                cs.pipeline_drain()
                out.append((list(e.statuses), list(e.witness)))
    finally:
        port_spans.set_global_span_hub(saved)
    spans = [sp for ring in hub.rings.values() for sp in ring]
    return {
        "verdicts": out,
        "snapshot": cs.metrics.snapshot() if sharded else cs._dev.metrics.snapshot(),
        "spans_json": hub.spans_json(),
        "wall_stamps": [(sp.wall_start, sp.wall_end) for sp in spans],
        "wall": (cs.metrics if sharded else cs._dev.metrics).snapshot(include_wall=True)["wall"],
        "set": cs,
    }


def _assert_equal_runs(a, b):
    for key in ("verdicts", "snapshot", "spans_json"):
        assert a[key] == b[key], key
    assert "wall" not in a["snapshot"]
    assert a["spans_json"].count('"name"') == len(a["wall_stamps"]) > 0
    assert "wall_start" not in a["spans_json"]
    # Span wall stamps are still the wall clock's, ordered and real.
    assert all(isinstance(s, float) and isinstance(e, float) and e >= s > 0
               for s, e in a["wall_stamps"])


def test_conflict_set_runs_equal_less_the_wall_namespace():
    stream = _random_stream(5, 60, 16, 8)

    def make(inj):
        return ConflictSet(device="cpu", h_cap=1 << 10, key_words=3,
                           bucket_mins=(32, 128, 64), fault_injector=inj)

    a, b = (_run_set(make, stream, sharded=False) for _ in range(2))
    _assert_equal_runs(a, b)
    assert a["snapshot"]["counters"]["device_faults"] == 1
    # The wall namespace holds the names it held before the funnel, one
    # record a mirror apply; the degraded batch's timer fed the throughput
    # estimate backend_signal reads.
    assert sorted(a["wall"]) == ["mirror_apply_seconds", "note_synced_seconds"]
    applies = a["wall"]["mirror_apply_seconds"]
    assert applies["count"] == a["snapshot"]["counters"]["batches"] and applies["seconds"] > 0
    recent = list(a["set"]._cpu_fallback_recent)
    assert len(recent) == 1 and recent[0][1] > 0
    assert a["set"].backend_signal()["cpu_mirror_tps"] > 0


def test_sharded_set_runs_equal_less_the_wall_namespace():
    stream = _random_stream(9, 60, 12, 8)

    def make(inj):
        return ShardedTorchConflictSet([k(30)], key_words=3, h_cap=1 << 10, device="cpu",
                                       fault_injector=inj)

    # Three faults in a row open shard 1's breaker: its slice is served
    # from its mirror, timed for the throughput estimate.
    a, b = (_run_set(make, stream, sharded=True, persist=3, shard=1) for _ in range(2))
    _assert_equal_runs(a, b)
    assert sorted(a["wall"]) == ["clip_seconds", "mirror_apply_seconds", "unpack_seconds",
                                 "witness_decode_seconds"]
    assert a["wall"]["unpack_seconds"]["count"] == len(stream)
    assert all(v["seconds"] > 0 for v in a["wall"].values())
    assert a["snapshot"]["counters"]["degraded_shard_serves"] > 0
    recent = list(a["set"]._cpu_fallback_recent)
    assert recent and all(w > 0 for _n, w in recent)
