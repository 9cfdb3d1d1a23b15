"""The port's Perfetto export (foundationdb_tpu_torch/flow/trace_export.py)
and its CLI surfaces (foundationdb_tpu_torch/tools/cli.py), against the
reference's.

Twins of tests/test_spans.py on the port's set and hub: the export of a
pipelined run is byte-identical for a seed and differs for another (:172);
the device spans of a depth-2 run take two lanes and a depth-1 run's one
(:188, through the export); the schema gate and stable pids (:208); the
parent-aware lanes through the reference's Resolver rig over the port's set
(:232).  The reference's exporter accepts the port's SpanHub by duck
typing, so it is the oracle: the port's ``perfetto_json`` and
``perfetto_trace`` equal it on the same hub, with and without wall times
and a ``last_n``.

The CLI: ``await CliProcessor(cluster, db).run_command(line)`` of
``trace-export``, ``latency`` and ``flightrec`` prints the reference
``CliProcessor``'s lines on the same hubs and recorder (test_spans.py:522
and test_flight_recorder.py:365-380), with the reference's
``SimCluster(conflict_set=<the port's set>)`` behind both processors and
the hub, collector and recorder installed into both packages as
tests/test_torch_spans.py does: ``latency``'s host_fraction line too.  The
commands that read only the globals also serve a processor on no cluster
(``CliProcessor(None, None)``).

Shapes: key_words=3, bucket_mins=(32, 128, 64), h_cap=1<<10.  The
tolerance is zero: bytes are compared.
"""

import json

import pytest

import foundationdb_tpu.flow.flight_recorder as ref_fr
import foundationdb_tpu.flow.spans as ref_spans
import foundationdb_tpu.flow.trace as ref_trace
import foundationdb_tpu.flow.trace_export as ref_export
import foundationdb_tpu_torch.flow.flight_recorder as port_fr
import foundationdb_tpu_torch.flow.spans as port_spans
import foundationdb_tpu_torch.flow.trace as port_trace
from foundationdb_tpu.flow import set_event_loop
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.flow.spans import SpanHub, global_span_hub, set_global_span_hub
from foundationdb_tpu_torch.flow.trace_export import (
    perfetto_json,
    perfetto_trace,
    validate_perfetto,
)
from foundationdb_tpu_torch.tools.cli import CliProcessor

from test_torch_api import _random_stream
from test_torch_spans import (
    _drive,
    _port_set,
    _resolver_run,
    _restore_globals,  # noqa: F401 (autouse fixture)
    _sync_detect,
)


def _pipelined_hub(seed, depth=2, batches=10):
    set_global_span_hub(SpanHub())
    cs = _port_set(depth)
    stream = _random_stream(seed, 60, batches, 8)
    if depth == 1:
        _sync_detect(cs, stream, port=True)
    else:
        _drive(cs, stream, depth, port=True)
    return global_span_hub()


# ---------------------------------------------------------------------------
# twins of tests/test_spans.py's export tests
# ---------------------------------------------------------------------------


def test_pipeline_perfetto_byte_identical_per_seed():
    """tests/test_spans.py:172: same seed, same bytes; another seed, other
    bytes; and the reference exporter's bytes on the same hub."""
    a, b, c = (_pipelined_hub(s) for s in (3, 3, 5))
    assert perfetto_json(a) == perfetto_json(b)
    assert perfetto_json(c) != perfetto_json(a)
    for hub in (a, c):
        assert perfetto_json(hub) == ref_export.perfetto_json(hub)


def test_device_spans_take_two_lanes_at_depth2_and_one_at_depth1():
    """tests/test_spans.py:188, seen through the export: the pipeline's
    overlap puts the device spans on two lanes at depth 2; depth 1 keeps
    one."""
    def device_lanes(hub):
        doc = perfetto_trace(hub)
        assert validate_perfetto(doc) == []
        return {e["tid"] for e in doc["traceEvents"] if e["ph"] == "B" and e["name"] == "device"}

    assert len(device_lanes(_pipelined_hub(3, depth=2))) == 2
    assert len(device_lanes(_pipelined_hub(3, depth=1))) == 1


def test_perfetto_schema_and_stable_pids():
    """tests/test_spans.py:208."""
    doc = perfetto_trace(_pipelined_hub(7, batches=8))
    assert validate_perfetto(doc) == []
    events = doc["traceEvents"]
    assert sum(1 for e in events if e["ph"] == "B") == sum(
        1 for e in events if e["ph"] == "E") > 0
    role_pids = {}
    for e in events:
        if e["ph"] == "B":
            role_pids.setdefault(e["cat"], set()).add(e["pid"])
    assert all(len(p) == 1 for p in role_pids.values())
    bad = json.loads(json.dumps(doc))
    for e in bad["traceEvents"]:
        if e["ph"] == "E":
            bad["traceEvents"].remove(e)
            break
    assert validate_perfetto(bad) != []
    assert validate_perfetto(bad) == ref_export.validate_perfetto(bad)
    assert validate_perfetto({}) == ["traceEvents missing or not a list"]


def test_lane_assignment_is_parent_aware(monkeypatch):
    """tests/test_spans.py:232 through the reference's Resolver rig over
    the port's ConflictSet: a stage span that begins inside its batch's
    window renders on its batch's lane, and concurrent batch spans sit
    side by side; the port's export equals the reference exporter's."""
    stream = _random_stream(3, 60, 10, 8)
    r, hub, _v = _resolver_run(monkeypatch, 3, 2, True, stream)
    doc = perfetto_trace(hub)
    assert validate_perfetto(doc) == []
    assert perfetto_json(hub) == ref_export.perfetto_json(hub)
    lane = {e["args"]["span"]: e["tid"] for e in doc["traceEvents"] if e["ph"] == "B"}
    by_id = {s.span_id: s for s in hub.spans()}
    checked = 0
    for s in by_id.values():
        p = by_id.get(s.parent_id)
        if p is not None and s.seq < p.end_seq:
            assert lane[s.span_id] == lane[p.span_id], (s.name, p.name)
            checked += 1
    assert checked > 0
    roots = hub.spans(role=r.metrics.name, name="resolve_batch")
    overlapping = [(a, b) for a in roots for b in roots
                   if a.span_id < b.span_id and b.seq < a.end_seq]
    assert overlapping, "no concurrent batch spans: the rig is not pipelining"
    assert all(lane[a.span_id] != lane[b.span_id] for a, b in overlapping)


@pytest.mark.parametrize("include_wall,last_n", [(False, None), (True, None), (False, 5)])
def test_export_equals_the_reference_exporter(include_wall, last_n):
    """The port's exporter against the reference's on one hub of the port's
    spans: the same document and the same bytes."""
    hub = _pipelined_hub(11, depth=3, batches=12)
    kw = dict(include_wall=include_wall, last_n=last_n)
    assert perfetto_trace(hub, **kw) == ref_export.perfetto_trace(hub, **kw)
    assert perfetto_json(hub, **kw) == ref_export.perfetto_json(hub, **kw)
    # With no hub given, the port's global one.
    assert perfetto_json(**kw) == perfetto_json(hub, **kw)


# ---------------------------------------------------------------------------
# the CLI against the reference's CliProcessor
# ---------------------------------------------------------------------------


def _install(hub, col, rec):
    for mod in (ref_spans, port_spans):
        mod.set_global_span_hub(hub)
    ref_trace.set_global_collector(col)
    port_trace.set_global_collector(col)
    ref_fr.set_global_flight_recorder(rec)
    port_fr.set_global_flight_recorder(rec)


def _ref_lines(c, db, cli, line):
    return c.loop.run_until(db.process.spawn(cli.run_command(line)), timeout_vt=60.0)


def _at_once(coro):
    """The lines of a command that completes without waiting."""
    try:
        coro.send(None)
    except StopIteration as done:
        return done.value
    coro.close()
    raise AssertionError("the command waited on the event loop")


def _cluster_run(seed, n_commits=6):
    """The reference's SimCluster over the port's ConflictSet at depth 2 on
    fresh reference hubs installed into both packages: commits, then each
    CLI command through the reference's CliProcessor and the port's.
    Returns {command: (reference lines, port lines)}."""
    from foundationdb_tpu.server import SimCluster
    from foundationdb_tpu.tools.cli import CliProcessor as RefCli

    _install(ref_spans.SpanHub(), ref_trace.TraceCollector(), ref_fr.FlightRecorder())
    cs = ConflictSet(key_words=4, h_cap=1 << 10, device="cpu", pipeline_depth=2)
    c = SimCluster(seed=seed, conflict_set=cs)
    db = c.database("sp")
    ref_cli, port_cli = RefCli(c, db), CliProcessor(c, db)

    async def load():
        for i in range(n_commits):
            tr = db.create_transaction()
            tr.set(b"sp/%02d" % i, b"v")
            await tr.commit()
        await c.loop.delay(1.0)  # the idle flush drains the pipeline tail

    c.run_until(db.process.spawn(load(), "load"), timeout_vt=5000.0)
    out = {}
    for line in ("trace-export", "latency", "latency --format=json", "flightrec",
                 "flightrec --format=json"):
        out[line] = (_ref_lines(c, db, ref_cli, line), _ref_lines(c, db, port_cli, line))
    set_event_loop(None)
    return out


def test_cli_trace_export_and_latency_equal_the_reference():
    """tests/test_spans.py:522 with the port's set behind the cluster:
    trace-export is one line, valid, byte-identical to the reference CLI's
    and across runs of one seed, different for another; latency's lines
    are the reference's, the Resolver's host_fraction line with them."""
    run1, run2, run3 = _cluster_run(4242), _cluster_run(4242), _cluster_run(4243)
    for line, (want, got) in run1.items():
        assert got == want, line
    assert run1["latency"][1][-1].startswith("host_fraction: ")
    (blob,) = run1["trace-export"][1]
    assert blob == run2["trace-export"][1][0] != run3["trace-export"][1][0]
    doc = json.loads(blob)
    assert validate_perfetto(doc) == []
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "B"}
    for required in ("resolve_batch", "encode", "dispatch", "device", "sync", "apply",
                     "reply", "commit_batch", "resolution"):
        assert required in names, required
    assert run1["latency"][1][0].startswith("per-stage span latency")
    assert any("resolve_batch" in ln for ln in run1["latency"][1])


def test_cli_flightrec_equals_the_reference():
    """tests/test_flight_recorder.py:365-380 with the port's set behind the
    cluster at depth 1: no captures, then a manual capture in the text
    inventory and the JSON artifacts, the same lines from both CLIs, on the
    reference's recorder and on the port's."""
    from foundationdb_tpu.server import SimCluster
    from foundationdb_tpu.tools.cli import CliProcessor as RefCli

    for rec in (ref_fr.FlightRecorder(), port_fr.FlightRecorder()):
        _install(ref_spans.SpanHub(), ref_trace.TraceCollector(), rec)
        cs = ConflictSet(key_words=4, h_cap=1 << 10, device="cpu", pipeline_depth=1)
        c = SimCluster(seed=5150, conflict_set=cs)
        db = c.database("fr")
        ref_cli, port_cli = RefCli(c, db), CliProcessor(c, db)

        async def load():
            for i in range(4):
                tr = db.create_transaction()
                tr.set(b"fr%02d" % i, b"v")
                await tr.commit()
            await c.loop.delay(3.0)

        c.run_until(db.process.spawn(load(), "load"), timeout_vt=1000.0)

        def both(line):
            want, got = _ref_lines(c, db, ref_cli, line), _ref_lines(c, db, port_cli, line)
            assert got == want, line
            return got

        assert both("flightrec")[0].startswith("flight recorder: no captures")
        rec.capture("manual", detail={"via": "test"}, now=c.loop.now())
        text = "\n".join(both("flightrec"))
        assert "1 capture(s)" in text and "manual" in text
        doc = json.loads("\n".join(both("flightrec --format=json")))
        assert doc["status"]["captures"] == 1 and doc["captures"][0]["trigger"] == "manual"
        set_event_loop(None)


def test_cli_surface(tmp_path):
    """help lists the reference's commands; on no cluster, the commands of
    the globals print the reference CLI's lines (latency on an empty hub
    falls back to the chains, an explorer finds no resolver); --out writes
    the export and reports it; --include-wall adds wall times; an unknown
    command and a bad quote each give their line."""
    from foundationdb_tpu.tools.cli import CliProcessor as RefCli

    _install(port_spans.SpanHub(), port_trace.TraceCollector(), port_fr.FlightRecorder())
    cli, ref = CliProcessor(None, None), RefCli(None, None)
    assert [ln.split(" ")[0] for ln in _at_once(cli.run_command("help"))] == sorted(RefCli.HELP)
    for line in ("latency", "latency --chains", "latency --format=json", "flightrec",
                 "shards", "contention", "mirror-check", "frobnicate", "latency 'x", ""):
        assert _at_once(cli.run_command(line)) == _at_once(ref.run_command(line)), line
    assert _at_once(cli.run_command("latency"))[0] == "commit pipeline (seconds):"
    _pipelined_hub(3)
    (blob,) = _at_once(cli.run_command("trace-export"))
    assert blob == perfetto_json()
    (walled,) = _at_once(cli.run_command("trace-export --include-wall"))
    assert '"wall_ms"' in walled and '"wall_ms"' not in blob
    path = tmp_path / "trace.json"
    (line,) = _at_once(cli.run_command(f"trace-export --out={path}"))
    hub = global_span_hub()
    assert line == (f"wrote {path} ({sum(len(r) for r in hub.rings.values())} spans, "
                    f"{len(hub.rings)} role tracks)")
    assert path.read_text() == blob + "\n"
    assert _at_once(cli.run_command("soak"))[0].startswith(
        "ERROR: soak runs its own rated cluster")
    assert _at_once(cli.run_command("frobnicate")) == [
        "ERROR: unknown command `frobnicate'; type `help' for help"]
    assert _at_once(cli.run_command("latency 'x"))[0].startswith("ERROR: ")
