"""The port's flow layer: the deterministic actor runtime its roles run on
(``eventloop``, ``future``, ``asyncvar``, ``error``; the seeded
``rng.DeterministicRandom`` every simulated decision draws from, and the
BUGGIFY sites of ``buggify``) and observability (``spans``, ``trace``,
``flight_recorder`` and ``timeseries``, each reached through its module
globals)."""

from .error import ActorCancelled, FdbError, error_code
from .eventloop import EventLoop, Task, TaskPriority, current_loop, set_event_loop
from .future import Future, FutureStream, Promise, PromiseStream
from .rng import DeterministicRandom

__all__ = ["ActorCancelled", "DeterministicRandom", "EventLoop", "FdbError", "Future",
           "FutureStream", "Promise", "PromiseStream", "Task", "TaskPriority",
           "current_loop", "error_code", "set_event_loop"]
