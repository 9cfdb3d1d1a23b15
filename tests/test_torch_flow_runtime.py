"""The port's flow runtime and simulated network, held to the reference's.

Twins of tests/test_flow.py's runtime tests and of tests/test_rpc.py on
the port's ``flow`` (error, future, eventloop, asyncvar) and ``rpc``
(network, stream) modules; the extended ``metrics.py`` (rng-fed histogram
reservoirs, ``emit_metrics``) and ``flow/timeseries.py``; the clock the
port's spans, trace events and flight recorder read from a port event
loop; and same-seed schedule tests: one scripted actor program (delays at
several priorities, cancellation, ``first_of`` with a timeout, a
PromiseStream, a request and its reply, a killed process breaking a
promise, a one-way clog) runs on the reference's loop and network and on
the port's, and the two give the same ordered log of (virtual time, task
name, event), also under the scheduler fuzz.

The two packages keep separate current-loop globals; each test sets the
one it drives and the fixture clears both.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

import foundationdb_tpu.flow.eventloop as ref_el
import foundationdb_tpu.flow.metrics as ref_metrics
import foundationdb_tpu.flow.timeseries as ref_ts
import foundationdb_tpu.rpc.network as ref_net
import foundationdb_tpu.rpc.stream as ref_stream
from foundationdb_tpu.flow.future import PromiseStream as RefPromiseStream
from foundationdb_tpu_torch import metrics as port_metrics
from foundationdb_tpu_torch.flow import (
    ActorCancelled,
    DeterministicRandom,
    EventLoop,
    FdbError,
    Promise,
    PromiseStream,
    TaskPriority,
    set_event_loop,
)
from foundationdb_tpu_torch.flow import eventloop as port_el
from foundationdb_tpu_torch.flow import flight_recorder as port_fr
from foundationdb_tpu_torch.flow import spans as port_spans
from foundationdb_tpu_torch.flow import testprobe
from foundationdb_tpu_torch.flow import timeseries as port_ts
from foundationdb_tpu_torch.flow import trace as port_trace
from foundationdb_tpu_torch.flow.asyncvar import AsyncVar, NotifiedVersion
from foundationdb_tpu_torch.flow.error import SimulationFailure
from foundationdb_tpu_torch.flow.eventloop import first_of, timeout_after, wait_for_all
from foundationdb_tpu_torch.flow.future import error_future, ready_future
from foundationdb_tpu_torch.rpc import RequestStream, SimNetwork
from foundationdb_tpu_torch.rpc import network as port_net
from foundationdb_tpu_torch.rpc import stream as port_stream
from foundationdb_tpu_torch.rpc.stream import retry_get_reply

PORT = Path(__file__).resolve().parent.parent / "foundationdb_tpu_torch"


@pytest.fixture(autouse=True)
def _clean_globals():
    """Both packages' current loop cleared, and the port's global
    collector, span hub, flight recorder and time-series hub restored."""
    saved = (port_trace.global_collector(), port_trace._global_clock,
             port_spans.global_span_hub(), port_fr.global_flight_recorder(),
             port_ts.global_timeseries())
    # What a test's actors record stays in the test.
    port_trace.set_global_collector(port_trace.TraceCollector())
    port_spans.set_global_span_hub(port_spans.SpanHub())
    port_fr.set_global_flight_recorder(port_fr.FlightRecorder())
    port_ts.set_global_timeseries(port_ts.TimeSeriesHub())
    yield
    set_event_loop(None)
    ref_el.set_event_loop(None)
    port_trace.set_global_collector(saved[0], clock=saved[1])
    port_spans.set_global_span_hub(saved[2])
    port_fr.set_global_flight_recorder(saved[3])
    port_ts.set_global_timeseries(saved[4])


@pytest.fixture
def net():
    loop = EventLoop(seed=42)
    set_event_loop(loop)
    yield SimNetwork(loop)
    set_event_loop(None)


# ---------------------------------------------------------------------------
# tests/test_flow.py's twins
# ---------------------------------------------------------------------------


def test_promise_future_basics():
    p = Promise()
    assert not p.future.is_ready()
    p.send(42)
    assert p.future.is_ready() and p.future.get() == 42

    e = Promise()
    e.send_error(FdbError("not_committed"))
    assert e.future.is_error()
    with pytest.raises(FdbError):
        e.future.get()


def test_actor_await_and_result():
    loop = EventLoop(seed=7)

    async def child(x):
        await loop.delay(0.5)
        return x * 2

    async def parent():
        a = loop.spawn(child(3))
        b = loop.spawn(child(4))
        return await a + await b

    t = loop.spawn(parent())
    assert loop.run_until(t) == 14
    assert loop.now() == pytest.approx(0.5)


def test_delay_ordering_by_time_then_priority():
    loop = EventLoop(seed=1)
    order = []

    async def waiter(tag, dt, prio):
        await loop.delay(dt, prio)
        order.append(tag)

    loop.spawn(waiter("late", 2.0, TaskPriority.Max))
    loop.spawn(waiter("early_low", 1.0, TaskPriority.Low))
    loop.spawn(waiter("early_high", 1.0, TaskPriority.Max))
    loop.run()
    assert order == ["early_high", "early_low", "late"]


def test_cancellation_propagates():
    loop = EventLoop(seed=1)
    cleaned = []

    async def forever():
        try:
            await loop.delay(1e9)
        except ActorCancelled:
            cleaned.append("cancelled")
            raise

    t = loop.spawn(forever())
    loop.run(max_events=1)
    t.cancel()
    assert cleaned == ["cancelled"]
    assert t.is_error()


def test_promise_stream_fifo_and_end():
    loop = EventLoop(seed=1)
    ps = PromiseStream()
    got = []

    async def consumer():
        while True:
            try:
                got.append(await ps.pop())
            except FdbError as e:
                assert e.name == "end_of_stream"
                return "done"

    t = loop.spawn(consumer())
    for i in range(3):
        ps.send(i)
    ps.send_error(FdbError("end_of_stream"))
    assert loop.run_until(t) == "done"
    assert got == [0, 1, 2]


def test_first_of_and_timeout():
    loop = EventLoop(seed=1)

    async def main():
        idx, val = await first_of(loop.delay(5.0), loop.delay(1.0))
        assert idx == 1
        v = await timeout_after(loop, loop.delay(100.0), 2.0, default="timed_out")
        assert v == "timed_out"
        v2 = await timeout_after(loop, ready_future("fast"), 2.0)
        assert v2 == "fast"
        return "ok"

    assert loop.run_until(loop.spawn(main())) == "ok"


def test_wait_for_all_error_propagates():
    loop = EventLoop(seed=1)

    async def main():
        with pytest.raises(FdbError):
            await wait_for_all([ready_future(1), error_future(FdbError("io_error"))])
        return True

    assert loop.run_until(loop.spawn(main()))


def _sim_trace(el, seed):
    """A small chaotic actor soup on `el`'s loop; its event interleaving."""
    loop = el.EventLoop(seed=seed)
    log = []

    async def actor(name):
        for _ in range(5):
            await loop.delay(loop.rng.random01(), priority=loop.rng.random_int(1, 10000))
            log.append((name, round(loop.now(), 9)))
            if loop.rng.coinflip():
                loop.spawn(subactor(name))

    async def subactor(parent):
        await loop.delay(loop.rng.random01() * 0.1)
        log.append((parent + "/sub", round(loop.now(), 9)))

    for i in range(4):
        loop.spawn(actor(f"a{i}"))
    loop.run()
    return log


def test_deterministic_reproducibility():
    assert _sim_trace(port_el, 12345) == _sim_trace(port_el, 12345)
    assert _sim_trace(port_el, 12345) != _sim_trace(port_el, 54321)
    # and the reference's loop gives the same interleaving
    assert _sim_trace(port_el, 12345) == _sim_trace(ref_el, 12345)


def test_deterministic_random_stability():
    r1 = DeterministicRandom(99)
    r2 = DeterministicRandom(99)
    seq1 = [r1.random_int(0, 1000) for _ in range(100)] + [r1.random01()]
    seq2 = [r2.random_int(0, 1000) for _ in range(100)] + [r2.random01()]
    assert seq1 == seq2


def test_unhandled_actor_exception_fails_simulation():
    loop = EventLoop(seed=1)

    async def broken_role():
        await loop.delay(0.1)
        raise AttributeError("no such method")

    loop.spawn(broken_role(), "broken_role")

    async def idle():
        await loop.delay(1000.0)

    t = loop.spawn(idle(), "idle")
    with pytest.raises(SimulationFailure, match="broken_role"):
        loop.run_until(t)


def test_awaited_task_error_raises_original():
    loop = EventLoop(seed=1)

    async def fails():
        await loop.delay(0.1)
        raise ValueError("observed")

    t = loop.spawn(fails(), "fails")
    with pytest.raises(ValueError, match="observed"):
        loop.run_until(t)

    async def fine():
        await loop.delay(0.1)
        return 42

    assert loop.run_until(loop.spawn(fine(), "fine")) == 42


def test_fdb_errors_do_not_fail_simulation():
    loop = EventLoop(seed=1)

    async def chaotic():
        await loop.delay(0.1)
        raise FdbError("broken_promise")

    loop.spawn(chaotic(), "chaotic")

    async def idle():
        await loop.delay(10.0)
        return "ok"

    assert loop.run_until(loop.spawn(idle(), "idle")) == "ok"


def test_every_raised_error_name_is_registered():
    """Every error name the port raises or sends exists in its table, and
    the table is the reference's."""
    from foundationdb_tpu.flow.error import _ERRORS as REF_ERRORS
    from foundationdb_tpu_torch.flow.error import _ERRORS

    names = set()
    for path in PORT.rglob("*.py"):
        src = path.read_text()
        names.update(re.findall(r'FdbError\(\s*"([a-z_0-9]+)"', src))
        names.update(re.findall(r'send_error\(\s*"([a-z_0-9]+)"', src))
    missing = sorted(n for n in names if n not in _ERRORS)
    assert not missing, f"raised but not in the error table: {missing}"
    assert {"broken_promise", "operation_failed"} <= names
    assert _ERRORS == REF_ERRORS


# ---------------------------------------------------------------------------
# tests/test_rpc.py's twins
# ---------------------------------------------------------------------------


def make_echo_server(net, name="server"):
    proc = net.process(name)
    rs = RequestStream(proc, "echo")

    async def server():
        while True:
            req, reply = await rs.pop()
            reply.send(("echo", req))

    proc.spawn(server(), "echo")
    return proc, rs.ref()


def test_request_reply(net):
    _, ref = make_echo_server(net)
    client = net.process("client")
    got = {}

    async def go():
        got["v"] = await ref.get_reply(client, 123)

    client.spawn(go())
    net.loop.run()
    assert got["v"] == ("echo", 123)
    assert net.loop.now() > 0  # latency actually elapsed


def _echo_order(el, network, stream, seed):
    loop = el.EventLoop(seed=seed)
    el.set_event_loop(loop)
    n = network.SimNetwork(loop)
    proc = n.process("server")
    rs = stream.RequestStream(proc, "echo")

    async def server():
        while True:
            req, reply = await rs.pop()
            reply.send(("echo", req))

    proc.spawn(server(), "echo")
    ref = rs.ref()
    client = n.process("client")
    order = []

    async def one(i):
        await ref.get_reply(client, i)
        order.append((i, loop.now()))

    for i in range(10):
        client.spawn(one(i))
    loop.run()
    el.set_event_loop(None)
    return order


def test_determinism_same_seed():
    run = lambda seed: _echo_order(port_el, port_net, port_stream, seed)  # noqa: E731
    assert run(7) == run(7)
    assert run(7) != run(8)  # different seed -> different latencies
    assert run(7) == _echo_order(ref_el, ref_net, ref_stream, 7)


def test_kill_breaks_promise(net):
    make_echo_server(net)
    slow = net.process("slow")
    rs = RequestStream(slow, "never")

    async def never():
        while True:
            await rs.pop()  # pop and drop

    slow.spawn(never(), "never")
    client = net.process("client")
    result = {}

    async def go():
        try:
            await rs.ref().get_reply(client, "hi")
            result["r"] = "replied"
        except FdbError as e:
            result["r"] = e.name

    client.spawn(go())

    async def killer():
        await net.loop.delay(0.01)
        slow.kill()

    client.spawn(killer())
    net.loop.run()
    assert result["r"] == "broken_promise"


def test_get_reply_to_already_dead_process(net):
    server, ref = make_echo_server(net)
    server.kill()
    client = net.process("client")
    result = {}

    async def go():
        try:
            await ref.get_reply(client, 1)
            result["r"] = "replied"
        except FdbError as e:
            result["r"] = e.name

    client.spawn(go())
    net.loop.run()
    assert result["r"] == "broken_promise"
    assert client._endpoints == {}


def test_no_endpoint_leak_on_kill(net):
    slow = net.process("slow")
    rs = RequestStream(slow, "never")

    async def never():
        while True:
            await rs.pop()

    slow.spawn(never(), "never")
    client = net.process("client")

    async def go():
        try:
            await rs.ref().get_reply(client, "x")
        except FdbError:
            pass

    client.spawn(go())

    async def killer():
        await net.loop.delay(0.01)
        slow.kill()

    client.spawn(killer())
    net.loop.run()
    assert client._endpoints == {}
    assert client._pending_on == {}


def test_retry_after_reboot(net):
    proc = net.process("server")
    token = 99

    def start_server():
        rs = RequestStream(proc, "echo", token=token)

        async def server():
            while True:
                req, reply = await rs.pop()
                reply.send(req * 2)

        proc.spawn(server(), "echo")
        return rs.ref()

    ref = start_server()
    client = net.process("client")
    result = {}

    async def go():
        result["v"] = await retry_get_reply(ref, client, 21, delay=0.05)

    client.spawn(go())

    async def chaos():
        await net.loop.delay(0.00001)  # kill before the request arrives
        proc.kill()
        await net.loop.delay(0.02)
        proc.reboot()
        start_server()

    net.process("chaos").spawn(chaos())
    net.loop.run()
    assert result["v"] == 42


def test_clog_delays_delivery(net):
    _server, ref = make_echo_server(net, "mserver")
    client = net.process("mclient")
    times = {}

    async def go(tag):
        await ref.get_reply(client, tag)
        times[tag] = net.loop.now()

    client.spawn(go("fast"))
    net.loop.run()
    baseline = times["fast"]
    net.clog_pair("mclient", "mserver", 5.0)
    client.spawn(go("slow"))
    net.loop.run()
    assert times["slow"] >= 5.0 > baseline


def test_clog_is_directional_reply_path_stays_clear(net):
    proc = net.process("dserver")
    rs = RequestStream(proc, "echo")
    hits = []

    async def server():
        while True:
            req, reply = await rs.pop()
            hits.append((req, net.loop.now()))
            reply.send(("echo", req))

    proc.spawn(server(), "echo")
    ref = rs.ref()
    client = net.process("dclient")
    times = {}

    async def go(tag):
        await ref.get_reply(client, tag)
        times[tag] = net.loop.now()

    net.clog_pair("dserver", "dclient", 5.0)
    client.spawn(go("r1"))
    net.loop.run()
    assert times["r1"] >= 5.0
    assert hits and hits[0][0] == "r1"
    assert hits[0][1] < 1.0


def test_partition_pair_and_unclog_pair(net):
    net.partition_pair("ma", "mb", 30.0)
    net.clog_pair("mc", "md", 30.0)
    assert net._clog_release("ma", "mb") > 0
    assert net._clog_release("mb", "ma") > 0
    net.unclog_pair("ma", "mb")
    assert net._clog_release("ma", "mb") == 0
    assert net._clog_release("mb", "ma") == 0
    assert net._clog_release("mc", "md") > 0
    assert net._clog_release("md", "mc") == 0


@pytest.mark.parametrize("deep_copy", [True, False])
def test_payload_isolation(deep_copy):
    """A payload mutated after its send: the receiver sees the sent value
    with the default deep copy, and the caller's object itself with
    deep_copy=False."""
    loop = EventLoop(seed=42)
    set_event_loop(loop)
    n = SimNetwork(loop, deep_copy=deep_copy)
    proc = n.process("server")
    rs = RequestStream(proc, "take")
    seen = {}

    async def server():
        req, reply = await rs.pop()
        seen["v"] = list(req)
        seen["obj"] = req
        reply.send(None)

    proc.spawn(server())
    client = n.process("client")
    payload = [1, 2, 3]

    async def go():
        f = rs.ref().get_reply(client, payload)
        payload.append(999)  # after-send mutation
        await f

    client.spawn(go())
    loop.run()
    assert seen["v"] == ([1, 2, 3] if deep_copy else [1, 2, 3, 999])
    assert (seen["obj"] is payload) is (not deep_copy)


def test_asyncvar_and_notified_version():
    loop = EventLoop(seed=1)
    set_event_loop(loop)
    av = AsyncVar(1)
    nv = NotifiedVersion(0)
    log = []

    async def watcher():
        while av.get() < 3:
            await av.on_change()
        log.append(("av", av.get()))

    async def waiter():
        await nv.when_at_least(10)
        log.append(("nv", nv.get()))

    loop.spawn(watcher())
    loop.spawn(waiter())

    async def driver():
        await loop.delay(0.01)
        av.set(2)
        av.set(3)
        nv.set(5)
        nv.set(12)

    loop.spawn(driver())
    loop.run()
    assert ("av", 3) in log and ("nv", 12) in log


def test_request_stream_close_breaks_parked_requests():
    probe_before = testprobe.hit_sites.get("request_stream_closed_parked", 0)
    loop = EventLoop(seed=44)
    set_event_loop(loop)
    n = SimNetwork(loop)
    server = n.process("srv")
    client = n.process("cli")
    stream = RequestStream(server, "busy_service", well_known=True)
    out = {}

    async def run():
        f1 = stream.ref().get_reply(client, "parked-1")
        f2 = stream.ref().get_reply(client, "parked-2")
        await loop.delay(0.1)  # both delivered, nobody pops
        stream.close()
        for name, f in (("one", f1), ("two", f2)):
            try:
                await f
                out[name] = "no error"
            except FdbError as e:
                out[name] = e.name
        try:
            await stream.ref().get_reply(client, "late")
            out["late"] = "no error"
        except FdbError as e:
            out["late"] = e.name

    loop.run_until(client.spawn(run(), "t"), timeout_vt=100.0)
    assert out == {"one": "broken_promise", "two": "broken_promise",
                   "late": "broken_promise"}, out
    assert testprobe.hit_sites.get("request_stream_closed_parked", 0) > probe_before


def test_close_wakes_parked_serve_actor(net):
    proc = net.process("server")
    rs = RequestStream(proc, "svc")
    state = {}

    async def server():
        try:
            while True:
                req, reply = await rs.pop()
                reply.send(req)
        except FdbError as e:
            state["died"] = e.name
            raise

    t = proc.spawn(server(), "svc_serve")
    net.loop.run()
    assert not t.is_ready()
    rs.close()
    net.loop.run()
    assert state["died"] == "broken_promise"
    assert t.is_ready() and t.is_error()


def test_close_still_breaks_queued_requests(net):
    proc = net.process("server")
    rs = RequestStream(proc, "svc2")
    client = net.process("client")
    got = {}

    async def call():
        try:
            await rs.ref().get_reply(client, 1)
        except FdbError as e:
            got["err"] = e.name

    client.spawn(call(), "caller")
    net.loop.run()
    rs.close()
    net.loop.run()
    assert got["err"] == "broken_promise"


def test_spawn_observed_traces_fdb_error_death(net):
    collector = port_trace.TraceCollector()
    port_trace.set_global_collector(collector)
    proc = net.process("p")

    async def doomed():
        raise FdbError("transaction_too_old")

    async def clean():
        return 1

    proc.spawn_observed(doomed(), "doomed")
    proc.spawn_observed(clean(), "clean")
    net.loop.run()
    died = collector.find("SpawnedTaskDied")
    assert len(died) == 1
    assert "transaction_too_old" in died[0]["error"]
    assert died[0]["task"].endswith("/doomed")


def test_spawn_observed_is_quiet_on_cancel(net):
    collector = port_trace.TraceCollector()
    port_trace.set_global_collector(collector)
    proc = net.process("p")

    async def forever(loop):
        while True:
            await loop.delay(1.0)

    t = proc.spawn_observed(forever(net.loop), "forever")
    net.loop.run(max_events=5)
    t.cancel()
    net.loop.run(max_events=5)
    assert collector.find("SpawnedTaskDied") == []


# ---------------------------------------------------------------------------
# one scripted program on both runtimes
# ---------------------------------------------------------------------------


def _scripted_program(el, network, stream, promise_stream, seed, fuzz=None):
    """The ordered (virtual time, task name, event) log of one actor
    program on a package's loop and network: delays at several priorities,
    a cancellation, first_of with a timeout, a PromiseStream, a request and
    its reply, a killed process breaking a promise, and a one-way clog."""
    loop = el.EventLoop(seed) if fuzz is None else el.EventLoop(seed, **fuzz)
    el.set_event_loop(loop)
    n = network.SimNetwork(loop)
    log = []

    def note(task, event):
        log.append((round(loop.now(), 12), task, event))

    async def sleeper(name, dt, prio):
        await loop.delay(dt, prio)
        note(name, f"woke p{prio}")

    for i, prio in enumerate((7010, 8000, 2000, 7010, 8560)):
        loop.spawn(sleeper(f"s{i}", 0.01 * (i % 3), prio), f"s{i}")

    async def doomed():
        try:
            await loop.delay(5.0)
        except el.FdbError as e:
            note("doomed", f"cancelled {e.name}")
            raise

    victim = loop.spawn(doomed(), "doomed")

    async def canceller():
        await loop.delay(0.02)
        victim.cancel()
        note("canceller", "cancel sent")

    loop.spawn(canceller(), "canceller")
    ps = promise_stream()

    async def consumer():
        for _ in range(3):
            v = await ps.pop()
            note("consumer", f"got {v}")

    async def producer():
        for i in range(3):
            await loop.delay(loop.rng.random01() * 0.01)
            ps.send(i)
            note("producer", f"sent {i}")

    loop.spawn(consumer(), "consumer")
    loop.spawn(producer(), "producer")

    async def racer():
        idx, _v = await el.first_of(loop.delay(0.5), loop.delay(0.03))
        note("racer", f"first {idx}")
        v = await el.timeout_after(loop, loop.delay(9.0), 0.04, default="timed out")
        note("racer", f"timeout {v}")

    loop.spawn(racer(), "racer")
    server = n.process("server")
    rs = stream.RequestStream(server, "echo")

    async def serve():
        while True:
            req, reply = await rs.pop()
            note("server", f"req {req}")
            if req != "never":
                reply.send(("echo", req))

    server.spawn(serve(), "serve")
    client = n.process("client")

    async def ask(tag):
        try:
            rep = await rs.ref().get_reply(client, tag)
            note("client", f"reply {rep}")
        except el.FdbError as e:
            note("client", f"error {e.name}")

    async def driver():
        await ask("a")
        n.clog_pair("server", "client", 0.2)  # replies stall, requests flow
        await ask("b")
        await loop.delay(0.01)
        client.spawn(ask("never"), "ask_never")
        await loop.delay(0.01)
        server.kill()
        note("driver", "killed server")
        await loop.delay(0.01)
        await ask("c")

    done = client.spawn(driver(), "driver")
    loop.run_until(done, timeout_vt=100.0)
    loop.run()
    log.append(("end", round(loop.now(), 12), loop.tasks_run, loop.rng.random01()))
    el.set_event_loop(None)
    return log


@pytest.mark.parametrize("seed", [1, 17, 4242])
def test_same_seed_schedule_equals_the_reference(seed):
    port = _scripted_program(port_el, port_net, port_stream, PromiseStream, seed)
    ref = _scripted_program(ref_el, ref_net, ref_stream, RefPromiseStream, seed)
    assert port == ref
    events = [e for _t, _n, e in port[:-1]]
    assert "cancelled actor_cancelled" in events and "error broken_promise" in events
    assert "timeout timed out" in events and "reply ('echo', 'b')" in events
    assert port != _scripted_program(port_el, port_net, port_stream, PromiseStream, seed + 1)


@pytest.mark.parametrize("fuzz", [0, 3])
def test_sched_fuzz_argument_equals_the_reference_knob(monkeypatch, fuzz):
    """EventLoop(seed, sched_fuzz=n) permutes ties as the reference's
    FDB_TPU_SCHED_FUZZ=n does, draw for draw."""
    port = _scripted_program(port_el, port_net, port_stream, PromiseStream, 5,
                             fuzz={"sched_fuzz": fuzz})
    monkeypatch.setenv("FDB_TPU_SCHED_FUZZ", str(fuzz))
    ref = _scripted_program(ref_el, ref_net, ref_stream, RefPromiseStream, 5, fuzz={})
    assert port == ref


# ---------------------------------------------------------------------------
# metrics, time series and the loop clock
# ---------------------------------------------------------------------------


def test_histogram_percentiles_with_rng():
    h = port_metrics.BoundedHistogram("h", rng=DeterministicRandom(7))
    for i in range(100):
        h.add(float(i))
    s = h.summary()
    assert s["count"] == 100 and s["min"] == 0.0 and s["max"] == 99.0
    assert 30 <= s["median"] <= 70
    assert s["p99"] >= s["p90"] >= s["median"]
    # beyond the reservoir the draws are the reference's, draw for draw
    from foundationdb_tpu.flow import DeterministicRandom as RefRandom

    a = port_metrics.BoundedHistogram("h", rng=DeterministicRandom(3), size=16)
    b = ref_metrics.BoundedHistogram("h", rng=RefRandom(3), size=16)
    for i in range(200):
        a.add(float(i * 7 % 101))
        b.add(float(i * 7 % 101))
    assert a.summary() == b.summary()


def test_registry_without_rng_keeps_its_snapshot():
    reg = port_metrics.MetricsRegistry("NoRng")
    reg.histogram("h").add(2.0)
    assert sorted(reg.snapshot()["histograms"]["h"]) == ["count", "max", "mean", "min", "sum"]
    assert "time" not in reg.snapshot()
    loop = EventLoop(seed=1)
    set_event_loop(loop)
    assert reg.snapshot()["time"] == 0.0


def test_emit_metrics_actor_traces_registry():
    collector = port_trace.TraceCollector()
    port_trace.set_global_collector(collector)
    loop = EventLoop(seed=4210)
    set_event_loop(loop)
    n = SimNetwork(loop)
    reg = port_metrics.MetricsRegistry("EmitTest", rng=loop.rng)
    reg.counter("ticks").add(5)
    reg.gauge("depth").set(2)
    reg.histogram("sz").add(4.0)
    proc = n.process("emit_test")
    proc.spawn(port_metrics.emit_metrics(reg, proc, interval=1.0), "emit")

    async def idle():
        await loop.delay(3.5)

    loop.run_until(proc.spawn(idle(), "idle"), timeout_vt=100.0)
    evs = collector.find("EmitTestMetrics")
    assert len(evs) >= 3
    ev = evs[0]
    assert ev["ticks"] == 5
    assert ev["ticksRate"] == 0.0  # the first emission has no rate span yet
    assert ev["depth"] == 2
    assert ev["szCount"] == 1 and ev["szMean"] == 4.0
    assert ev["Time"] == 1.0  # stamped with the loop's virtual time


def _sampled_window(el, network, metrics, ts, seed):
    loop = el.EventLoop(seed)
    el.set_event_loop(loop)
    hub = ts.TimeSeriesHub(window=5) if ts is port_ts else ts.TimeSeriesHub(5)
    ts.set_global_timeseries(hub)
    n = network.SimNetwork(loop)
    proc = n.process("p")
    reg = metrics.MetricsRegistry("Role.p", rng=loop.rng)
    ts.spawn_sampler(proc, reg.name, reg)

    async def work():
        for i in range(40):
            await loop.delay(loop.rng.random01() * 0.5)
            reg.counter("ops").add(i)
            reg.gauge("depth").set(i % 4)
            reg.histogram("lat").add(loop.rng.random01())

    loop.run_until(proc.spawn(work(), "work"), timeout_vt=100.0)
    el.set_event_loop(None)
    return hub.window_json()


def test_timeseries_sampler_equals_the_reference(monkeypatch):
    saved = ref_ts.global_timeseries()
    try:
        ref = _sampled_window(ref_el, ref_net, ref_metrics, ref_ts, 11)
    finally:
        ref_ts.set_global_timeseries(saved)
    port = _sampled_window(port_el, port_net, port_metrics, port_ts, 11)
    assert port == ref
    assert len(json.loads(port)["Role.p"]) == 5
    loop = EventLoop(1)
    set_event_loop(loop)
    proc = SimNetwork(loop).process("q")
    assert port_ts.spawn_sampler(proc, "x", port_metrics.MetricsRegistry("x"),
                                 enabled=False) is None


def test_spans_trace_and_recorder_read_the_port_loop():
    """Without a clock of their own, the port's span hub, trace events and
    flight recorder stamp the current port loop's virtual time (and the
    hub its seed); the reference's loop is not theirs."""
    hub, col = port_spans.SpanHub(), port_trace.TraceCollector()
    rec = port_fr.FlightRecorder(cooldown=1.0)
    port_spans.set_global_span_hub(hub)
    port_trace.set_global_collector(col)
    port_fr.set_global_flight_recorder(rec)
    ref_el.set_event_loop(ref_el.EventLoop(3))
    port_spans.begin_span("before", role="r").end()
    assert hub.spans(name="before")[0].start == 0.0 and hub.seed is None
    loop = EventLoop(seed=31)
    set_event_loop(loop)
    ts = port_ts.TimeSeriesHub()
    port_ts.set_global_timeseries(ts)

    async def go():
        await loop.delay(2.5)
        with port_spans.begin_span("s", role="r"):
            await loop.delay(0.0)
        port_trace.TraceEvent("Ev").log()
        first = port_fr.maybe_trigger("k", source="x")
        again = port_fr.maybe_trigger("k", source="x")
        await loop.delay(1.5)
        third = port_fr.maybe_trigger("k", source="x")
        return first, again, third

    first, again, third = loop.run_until(loop.spawn(go(), "go"))
    (s,) = hub.spans(name="s")
    assert s.start == 2.5 and hub.seed == 31
    assert col.find("Ev")[0]["Time"] == 2.5
    assert first["time"] == 2.5 and again is None and third["time"] == 4.0
    assert first["timeseries"] == {}  # the global time-series hub, still empty
    ts.record("R", port_metrics.MetricsRegistry("R"), now=4.0)
    assert list(rec.capture("manual")["timeseries"]) == ["R"]


def test_dry_loop_names_tasks_parked_on_dropped_promises():
    """run_until on a loop that runs dry names the tasks parked on a
    promise nobody holds (sim_validation.orphaned_waits), with the
    promise bookkeeping on; without it the scan finds nothing."""
    from foundationdb_tpu_torch.flow import future, sim_validation

    def park(name):
        loop = EventLoop(seed=1)
        p = Promise()

        async def waiter():
            await p.future

        t = loop.spawn(waiter(), name)
        loop.run()
        del p
        with pytest.raises(RuntimeError, match="ran dry") as err:
            loop.run_until(t)
        return str(err.value), sim_validation.orphaned_waits(loop)

    future.track_promise_refs(True)
    try:
        message, orphans = park("orphan")
    finally:
        future.track_promise_refs(False)
    assert "orphan" in message and orphans == [("orphan", "promise dropped; zero remaining senders")]
    message, orphans = park("blind")
    assert "blind" not in message and orphans == []
