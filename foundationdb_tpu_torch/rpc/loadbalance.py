"""Model-based request routing with hedged second requests.

The port's own copy of the reference package's ``rpc/loadbalance.py``.

Ref: fdbrpc/LoadBalance.actor.h:159 `loadBalance` — order an interface's
replicas by the per-endpoint latency model (QueueModel,
fdbrpc/QueueModel.h), send to the best, and if the reply is slow issue a
backup request to the second-best (`secondRequest` :168); first reply
wins.  Failed endpoints accrue a penalty so traffic shifts away from
them.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..flow.error import FdbError
from ..flow.eventloop import first_of


class QueueModel:
    """Per-endpoint smoothed latency + failure penalty (ref: QueueModel /
    the smoothed outstanding/latency bookkeeping in LoadBalance)."""

    ALPHA = 0.2
    # Strong enough that a few failures outweigh any latency advantage
    # (the reference gets this from the failure monitor marking the
    # endpoint down); successes decay it back quickly.
    FAIL_PENALTY = 8.0

    def __init__(self):
        self._latency: dict = {}
        self._penalty: dict = {}

    def expected(self, key) -> float:
        return self._latency.get(key, 0.001) * self._penalty.get(key, 1.0)

    def update(self, key, latency: float, failed: bool):
        if failed:
            self._penalty[key] = min(
                float(1 << 20), self._penalty.get(key, 1.0) * self.FAIL_PENALTY
            )
            return
        self._penalty[key] = max(1.0, self._penalty.get(key, 1.0) * 0.25)
        prev = self._latency.get(key, latency)
        self._latency[key] = prev + self.ALPHA * (latency - prev)

    def order(self, keys: List) -> List:
        """Replicas by expected latency, stable on ties (deterministic)."""
        return sorted(keys, key=lambda k: (self.expected(k), str(k)))


async def load_balance(
    process,
    model: Optional[QueueModel],
    alternatives: List,
    send: Callable,
    *,
    key_of: Callable = None,
    hedge_after: float = 0.01,
    reroute_errors=("broken_promise", "future_version"),
    failed: Callable = None,
):
    """Send via the model's best replica; hedge to the runner-up if the
    first reply is slower than `hedge_after` (ref: loadBalance's
    secondRequest path).  `send(alt)` returns the reply future;
    `reroute_errors` advance to the next alternative, anything else
    re-raises to the caller (e.g. wrong_shard_server -> cache invalidation
    upstream).  Raises the last error when every alternative failed."""
    loop = process.network.loop
    key_of = key_of or (lambda a: id(a))
    # Known-failed replicas sort LAST, not out: stale failure info must
    # never make data unreachable (ref: loadBalance consulting
    # IFailureMonitor before picking alternatives).
    dead = failed or (lambda a: False)
    order = (
        sorted(
            alternatives,
            key=lambda a: (
                bool(dead(a)),
                model.expected(key_of(a)),
                str(key_of(a)),
            ),
        )
        if model
        else sorted(alternatives, key=lambda a: bool(dead(a)))
    )
    last_err = FdbError("all_alternatives_failed")
    i = 0
    while i < len(order):
        alt = order[i]
        t0 = loop.now()
        fut = process.spawn(_guarded(send, alt), "lb_req")
        use_hedge = i + 1 < len(order)
        if use_hedge:
            timer = loop.delay(hedge_after)
            idx, _ = await first_of(fut, timer)
            if idx == 0:
                loop.cancel_timer(timer)
                ok, val = fut.get()
                if ok:
                    if model:
                        model.update(key_of(alt), loop.now() - t0, False)
                    return val
                if model:
                    model.update(key_of(alt), loop.now() - t0, True)
                if val.name not in reroute_errors:
                    raise val
                last_err = val
                i += 1
                continue
            # Slow: hedge to the runner-up; first reply wins (duplicate
            # delivery is safe — reads are idempotent).
            alt2 = order[i + 1]
            t1 = loop.now()
            fut2 = process.spawn(_guarded(send, alt2), "lb_hedge")
            idx2, _ = await first_of(fut, fut2)
            win, lose = (fut, fut2) if idx2 == 0 else (fut2, fut)
            wkey, lkey = (
                (key_of(alt), key_of(alt2))
                if idx2 == 0
                else (key_of(alt2), key_of(alt))
            )
            wt = t0 if idx2 == 0 else t1
            ok, val = win.get()
            if model:
                model.update(wkey, loop.now() - wt, not ok)
            if ok:
                return val
            if val.name not in reroute_errors:
                raise val
            # Winner failed; fall back to the loser's eventual answer.
            lt = t1 if idx2 == 0 else t0  # the loser's own start time
            ok2, val2 = await lose
            if model:
                model.update(lkey, loop.now() - lt, not ok2)
            if ok2:
                return val2
            if val2.name not in reroute_errors:
                raise val2
            last_err = val2
            i += 2
        else:
            ok, val = await fut
            if model:
                model.update(key_of(alt), loop.now() - t0, not ok)
            if ok:
                return val
            if val.name not in reroute_errors:
                raise val
            last_err = val
            i += 1
    raise last_err


async def _guarded(send, alt):
    try:
        return True, await send(alt)
    except FdbError as e:
        return False, e
