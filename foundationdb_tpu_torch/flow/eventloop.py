"""Deterministic virtual-time event loop: the run loop every role runs on.

The port's own copy of the reference package's ``flow/eventloop.py``
(modelled on Net2's run loop, flow/Net2.actor.cpp, and its simulator
twin, fdbrpc/sim2.actor.cpp; task priority bands from flow/network.h).
Time is virtual and jumps to the next event; every random decision draws
from the loop's ``DeterministicRandom``, so one seed gives one run.

Coroutines ("actors") are driven by Task.  ``await future`` suspends until
the future is set; resumption goes through the loop's queue at a task
priority, never synchronously, so event order is fully determined by
(time, priority, insertion sequence).

Scheduler fuzz (``EventLoop(seed, sched_fuzz=n)``, the reference's
FDB_TPU_SCHED_FUZZ knob, off by default): a DeterministicRandom forked
from (seed, n) draws a tie-break between priority and insertion sequence,
permuting pick order among equal-(time, priority) entries, the orderings
the scheduling contract leaves open.  The same (seed, n) replays exactly.

The runtime twins of fdblint's race and promise families, off by default
as the reference's FDB_TPU_STATE_SANITIZER and FDB_TPU_CHECK_ORPHANED_WAITS
knobs are: ``state_sanitizer=True`` gives the loop a
``state_sanitizer.StateSanitizer`` (``loop.state_sanitizer``, else None),
which ``audited_dict`` binds shared dicts to and
``expect_clean_shared_state`` reads at shutdown;
``check_orphaned_waits=True`` arms ``sim_validation.
expect_no_orphaned_waits``.  Both only observe: a run's events, rng draws
and end are the same with them on.

The slow-task profiler (``slow_task_threshold``, off by default) times a
step with ``metrics.wall_now()``; that reading never feeds virtual time.
"""

from __future__ import annotations

import heapq
import weakref
from typing import Coroutine, Optional

from ..metrics import wall_now
from .error import ActorCancelled, FdbError, SimulationFailure
from .future import Future, Promise
from .rng import DeterministicRandom
from .state_sanitizer import StateSanitizer


class TaskPriority:
    """Numeric priority bands; higher runs first at equal time.

    Values mirror flow/network.h:31-64 (TaskMaxPriority = 1000000 ...
    TaskZeroPriority = 0); only the bands the rebuild uses are listed.
    """

    Max = 1000000
    RunCycleFunction = 20000
    FlushTrace = 10500
    WriteSocket = 10000
    PollEIO = 9900
    DiskIOComplete = 9150
    LoadBalancedEndpoint = 9000
    ReadSocket = 9000
    CoordinationReply = 8810
    Coordination = 8800
    FailureMonitor = 8700
    ResolutionMetrics = 8700
    ClusterController = 8650
    ProxyCommitDispatcher = 8640
    TLogQueuingMetrics = 8620
    TLogPop = 8610
    TLogPeekReply = 8600
    TLogPeek = 8590
    TLogCommitReply = 8580
    TLogCommit = 8570
    ProxyGetRawCommittedVersion = 8565
    ProxyResolverReply = 8560
    ProxyCommitBatcher = 8550
    ProxyCommit = 8540
    TLogConfirmRunningReply = 8530
    TLogConfirmRunning = 8520
    ProxyGetKeyServersLocations = 8515
    ProxyGRVTimer = 8510
    ProxyGetConsistentReadVersion = 8500
    DefaultPromiseEndpoint = 8000
    DefaultOnMainThread = 7500
    DefaultDelay = 7010
    DefaultYield = 7000
    DiskRead = 5010
    DefaultEndpoint = 5000
    UnknownEndpoint = 4000
    MoveKeys = 3550
    DataDistributionLaunch = 3530
    DataDistribution = 3500
    DiskWrite = 3010
    UpdateStorage = 3000
    BatchCopy = 2900
    Low = 2000
    Min = 1000
    Zero = 0


class Task(Future):
    """Drives a coroutine; the Task itself is a Future of the coroutine result.

    Ref: the actor compiler's generated Actor<T> classes (flow/flow.h:910);
    cancellation semantics follow flow: cancelling throws actor_cancelled
    inside the actor at its current wait point, synchronously.
    """

    __slots__ = ("_coro", "_loop", "name", "_waiting_on", "_cancelled",
                 "_started")

    def __init__(self, loop: "EventLoop", coro: Coroutine, name: str = ""):
        super().__init__()
        self._coro = coro
        self._loop = loop
        self.name = name or getattr(coro, "__name__", "actor")
        self._waiting_on: Optional[Future] = None
        self._cancelled = False
        self._started = False

    def __del__(self):
        # A task spawned but never driven (cluster built, loop never run)
        # holds a never-started coroutine; close it so collection doesn't
        # emit "coroutine was never awaited" — that warning must stay
        # meaningful for REAL dropped actors (the fdblint ACT001 class),
        # not fire for every lazily-constructed role.  close() on a
        # never-started coroutine just marks it closed (no GeneratorExit
        # runs), so no cleanup code executes at GC time.  Best-effort by
        # nature: when Task and coroutine die in one GC *cycle*, CPython
        # may order the coroutine's warning finalizer first (holding the
        # coroutine alive from a finalize registry instead would pin the
        # whole cycle — a leak, strictly worse); residual warnings stay
        # visible via pytest's warning summary rather than gating.
        if not self._started and not self._cancelled:
            try:
                self._coro.close()
            except RuntimeError:
                pass  # already running/closed — nothing to silence

    def _step(self, value=None, error: Optional[BaseException] = None):
        if self.is_ready():
            return
        self._started = True
        self._waiting_on = None
        loop = self._loop
        prev_task = loop.current_task
        loop.current_task = self
        try:
            try:
                if error is not None:
                    awaited = self._coro.throw(error)
                else:
                    awaited = self._coro.send(value)
            except StopIteration as stop:
                self._set(stop.value)
                return
            except BaseException as e:  # noqa: BLE001 - errors flow into the future
                self._set_error(e)
                loop._note_actor_failure(self.name, e)
                return
            # The coroutine yielded a Future it is waiting on.
            assert isinstance(awaited, Future), (
                f"actor {self.name} awaited a non-Future: {awaited!r}"
            )
            self._waiting_on = awaited
            awaited.add_callback(self._on_ready)
        finally:
            loop.current_task = prev_task

    def _on_ready(self, fut: Future):
        prio = fut.priority if fut.priority is not None else TaskPriority.DefaultOnMainThread
        if fut.is_error():
            err = fut.error()
            self._loop._schedule(prio, lambda: self._step(error=err))
        else:
            val = fut.get()
            self._loop._schedule(prio, lambda: self._step(value=val))

    def cancel(self):
        """Throw actor_cancelled into the coroutine now (ref: actor cancel).

        Cancellation is synchronous, as in flow (actor destruction runs the
        unwind immediately).  Waits during cancellation never complete: if
        cleanup code awaits (e.g. in a finally block), the await immediately
        re-raises actor_cancelled until the coroutine exits.  A real error
        raised during unwind propagates into the task's future.
        """
        if self.is_ready() or self._cancelled:
            return
        self._cancelled = True
        if self._waiting_on is not None:
            self._waiting_on.remove_callback(self._on_ready)
            self._waiting_on = None
        err: BaseException = ActorCancelled()
        try:
            for _ in range(1000):
                self._coro.throw(ActorCancelled())
            raise RuntimeError(f"actor {self.name} ignored cancellation")
        except StopIteration:
            pass
        except ActorCancelled:
            pass
        except BaseException as e:  # noqa: BLE001 - surfaced via the future
            err = e
        if not self.is_ready():
            self._set_error(err)
            self._loop._note_actor_failure(self.name, err)


class EventLoop:
    """Single-threaded deterministic event loop with virtual time."""

    def __init__(self, seed: int = 1, sched_fuzz: Optional[int] = None,
                 state_sanitizer: bool = False, check_orphaned_waits: bool = False):
        self.rng = DeterministicRandom(seed)
        self._now = 0.0
        self._seq = 0
        # Heap entries: (time, -priority, tie, seq, fn-cell).  `tie` is 0
        # unless sched_fuzz is given, in which case it is a draw from a
        # rng forked from (seed, sched_fuzz) — permuting pick order among
        # equal-(time, priority) entries, the orderings the scheduling
        # contract leaves unspecified (see module docstring).
        self._heap: list = []
        self._fuzz_rng = (
            DeterministicRandom(
                (seed * 1000003 + int(sched_fuzz)) & ((1 << 63) - 1)
            )
            if sched_fuzz is not None
            else None
        )
        # Bumps once per run_one step: the state sanitizer's interleaving
        # clock — two accesses at the same epoch cannot have had another
        # task run between them (see flow/state_sanitizer.py).
        self.await_epoch = 0
        # The Task currently being stepped (None between steps / for plain
        # callbacks): audit attribution for the state sanitizer.
        self.current_task: Optional[Task] = None
        self.state_sanitizer = StateSanitizer(self) if state_sanitizer else None
        self.check_orphaned_waits = check_orphaned_waits
        self._stopped = False
        self.tasks_run = 0
        # Slow-task profiler threshold in WALL seconds (None = off; the
        # simulator leaves it off — virtual time has no slow tasks; real
        # deployments enable it, ref: Net2 slow-task profiling).
        self.slow_task_threshold = None
        # (actor name, exception) for tasks that died with a non-FdbError
        # exception: genuine bugs, surfaced as SimulationFailure by run_until.
        self.failed_actors: list = []
        # Every task ever spawned, weakly: sim_validation's orphaned-wait
        # teardown check (and the ran-dry diagnostic below) scan it for
        # tasks parked on futures whose promise has been dropped.
        self._spawned: "weakref.WeakSet[Task]" = weakref.WeakSet()

    def _note_actor_failure(self, name: str, err: BaseException):
        """Record an actor crash that is a bug (Python error), not a
        simulated fault (FdbError / ActorCancelled flow through futures as
        expected distributed errors)."""
        if isinstance(err, FdbError):
            return
        if any(e is err for _n, e in self.failed_actors):
            return  # same exception propagating through an awaiter chain
        self.failed_actors.append((name, err))

    # --- time ---
    def now(self) -> float:
        return self._now

    # --- scheduling primitives ---
    def _schedule(self, priority: int, fn, at: Optional[float] = None) -> list:
        """Queue fn; returns a one-element cell usable to cancel the entry."""
        self._seq += 1
        t = self._now if at is None else at
        cell = [fn]
        tie = (
            self._fuzz_rng.random_int(0, 1 << 30)
            if self._fuzz_rng is not None
            else 0
        )
        heapq.heappush(self._heap, (t, -priority, tie, self._seq, cell))
        return cell

    def delay(self, seconds: float, priority: int = TaskPriority.DefaultDelay) -> Future:
        """Future that fires `seconds` of virtual time from now.

        Ref: INetwork::delay flow/network.h; ordering at equal deadlines is by
        priority then FIFO, matching Net2's timer/ready queues.
        """
        f = Future(priority)
        cell = self._schedule(priority, lambda: f._set(None), at=self._now + max(0.0, seconds))
        f.timer_cell = cell
        return f

    def cancel_timer(self, f: Future):
        """Drop a pending delay()'s heap entry (it never fires)."""
        cell = getattr(f, "timer_cell", None)
        if cell is not None:
            cell[0] = None

    def yield_(self, priority: int = TaskPriority.DefaultYield) -> Future:
        return self.delay(0.0, priority)

    def spawn(self, coro: Coroutine, name: str = "", priority: int = TaskPriority.DefaultOnMainThread) -> Task:
        task = Task(self, coro, name)
        self._spawned.add(task)
        self._schedule(priority, task._step)
        return task

    # --- run loop ---
    def run_one(self) -> bool:
        """Run the next event, advancing virtual time. False if none left."""
        while self._heap and not self._stopped:
            t, _negprio, _tie, _seq, cell = heapq.heappop(self._heap)
            fn = cell[0]
            if fn is None:  # cancelled timer
                continue
            if t > self._now:
                self._now = t
            self.tasks_run += 1
            self.await_epoch += 1
            # Captured BEFORE the step: the step itself may toggle the
            # profiler (a workload or the runtime-toggle RPC), and the
            # comparison below must use the threshold this step ran under.
            threshold = self.slow_task_threshold
            if threshold is None:
                fn()
                return True
            # Slow-task profiler (ref: Net2's slow task profiling): a
            # single step hogging the reactor is the #1 real-deployment
            # latency smell; surface it with its wall-clock cost.
            w0 = wall_now()
            fn()
            dt = wall_now() - w0
            if dt >= threshold:
                from .trace import TraceEvent

                TraceEvent("SlowTask", severity=20).detail(
                    "wall_seconds", round(dt, 6)
                ).detail(
                    "fn", getattr(fn, "__qualname__", repr(fn))[:120]
                ).log(now=self._now)
            return True
        return False

    def run_until(self, future: Future, timeout_vt: Optional[float] = None):
        """Drive the loop until `future` is ready; returns its value."""
        deadline = None if timeout_vt is None else self._now + timeout_vt
        while not future.is_ready():
            if self.failed_actors:
                name, err = self.failed_actors[0]
                self.failed_actors = []
                raise SimulationFailure(
                    f"unhandled exception in actor {name!r}: {err!r}"
                ) from err
            if deadline is not None and self._heap and self._heap[0][0] > deadline:
                raise TimeoutError(
                    f"virtual-time deadline {deadline} exceeded (now={self._now})"
                )
            if not self.run_one():
                # Name the tasks parked on dropped promises (needs
                # track_promise_refs; empty otherwise): a dry loop with a
                # pending future is almost always THIS hang class.
                from .sim_validation import orphaned_waits

                orphans = orphaned_waits(self)
                detail = (
                    "; tasks parked on dropped promises: "
                    + ", ".join(name for name, _w in orphans[:5])
                    if orphans else ""
                )
                raise RuntimeError(
                    "event loop ran dry awaiting future" + detail
                )
        if future.is_error():
            # The awaited future's own error is observed by the caller via
            # get(); don't re-raise it as a SimulationFailure later.
            err = future.error()
            self.failed_actors = [
                (n, e) for n, e in self.failed_actors if e is not err
            ]
        return future.get()

    def run(self, max_events: Optional[int] = None):
        n = 0
        while self.run_one():
            n += 1
            if max_events is not None and n >= max_events:
                break

    def stop(self):
        self._stopped = True


# --- global loop access (ref: g_network global) ---
_current_loop: Optional[EventLoop] = None


def set_event_loop(loop: Optional[EventLoop]):
    global _current_loop
    _current_loop = loop


def current_loop() -> EventLoop:
    assert _current_loop is not None, "no event loop set (call set_event_loop)"
    return _current_loop


# --- combinators (ref: genericactors.actor.h) ---
def all_of(futures) -> Future:
    """Future of all values; errors immediately on the first error, like the
    reference's waitForAll (it does not wait out the other futures)."""
    futures = list(futures)
    out = Promise()
    remaining = [len(futures)]
    results = [None] * len(futures)
    cbs = []

    def unsubscribe():
        for f, cb in zip(futures, cbs):
            f.remove_callback(cb)

    def make_cb(i):
        def cb(f: Future):
            if out.is_set():
                return
            if f.is_error():
                out.send_error(f.error())
                unsubscribe()
                return
            results[i] = f.get()
            remaining[0] -= 1
            if remaining[0] == 0:
                out.send(results)

        return cb

    if not futures:
        out.send([])
        return out.future
    for i, f in enumerate(futures):
        cb = make_cb(i)
        cbs.append(cb)
        f.add_callback(cb)
        if out.is_set():
            break
    return out.future


async def wait_for_all(futures):
    """Wait for every future; first error propagates (ref: waitForAll)."""
    return await all_of(futures)


def first_of(*futures: Future) -> Future:
    """Future of (index, value) for whichever input fires first (ref:
    choose/when).  Losing futures are unsubscribed (not cancelled — the
    caller may still hold them)."""
    out = Promise()
    cbs: list = []

    def settle():
        for f, cb in zip(futures, cbs):
            f.remove_callback(cb)

    def make_cb(i):
        def cb(f: Future):
            if out.is_set():
                return
            if f.is_error():
                out.send_error(f.error())
            else:
                out.send((i, f.get()))
            settle()

        return cb

    for i, f in enumerate(futures):
        cb = make_cb(i)
        cbs.append(cb)
        f.add_callback(cb)
        if out.is_set():
            break
    return out.future


async def timeout_after(loop: EventLoop, fut: Future, seconds: float, default=None):
    """Value of fut, or `default` if `seconds` of virtual time elapse first.

    The internal timer is always cancelled once fut settles (value or error),
    so repeated timeouts on long waits don't accumulate dead heap entries;
    `fut` itself is only unsubscribed on timeout (the caller may still hold
    it).
    """
    timer = loop.delay(seconds)
    try:
        idx, val = await first_of(fut, timer)
    finally:
        loop.cancel_timer(timer)
    if idx == 0:
        return val
    return default
