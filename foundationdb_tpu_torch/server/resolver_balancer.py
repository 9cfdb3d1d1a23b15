"""Resolution balancing: move resolver split points toward the load.

The port's own copy of the reference package's
``server/resolver_balancer.py``: ``ResolverBalancer``, the master's
resolution balancer over the resolvers' RPC streams, and
``ShardBalancer``, which the Resolver runs in-process to move the
sharded conflict set's split points.  The reference's server knobs the
balancer reads (``versions_per_second``,
``max_write_transaction_life_versions``, ``max_versions_in_flight``) are
the sequencer's and the proxy's constants, so the overlap window it waits
out is the one the proxies keep.

Ref: the master's resolution balancer — it polls every resolver's
ResolutionMetricsRequest, and when the load skews it asks the overloaded
resolver for a split key from its iopsSample (ResolutionSplitRequest,
ResolverInterface.h:108-131; Resolver.actor.cpp:276-284) and moves the
boundary.  Here the new partition is committed as a system-key transaction
(`\xff/conf/resolverSplit`), so every proxy applies it at an exact version
through the state-transaction channel and runs the both-owners overlap
window (proxy.py `_old_bounds`) before retiring the old partition.
"""

from __future__ import annotations

from typing import List, Optional

from . import system_keys as sk
from .interfaces import ResolutionSplitRequest, ResolverInterface
from .proxy import MAX_VERSIONS_IN_FLIGHT, MAX_WRITE_TRANSACTION_LIFE_VERSIONS
from .sequencer import VERSIONS_PER_SECOND


class ResolverBalancer:
    def __init__(
        self,
        db,
        resolvers: List[ResolverInterface],
        split_keys: List[bytes],
        min_ops: int = 50,
        ratio: float = 1.5,
    ):
        assert len(split_keys) == len(resolvers) - 1
        self.db = db
        self.resolvers = resolvers
        self.split_keys = list(split_keys)
        self.min_ops = min_ops
        self.ratio = ratio
        self.moves = 0

    async def run_once(self) -> Optional[List[bytes]]:
        """One balancing round; returns the new split list if a boundary
        moved, else None.

        The whole round is a read-modify-write of the partition spanning
        several awaits (metrics polls, the split RPC, the commit), so the
        plan is computed from one snapshot (`base`), the commit validates
        the durable partition against it with a conflict-checked read
        (a concurrent mover aborts exactly like any MVCC write-write
        conflict), and the in-memory view is only adopted if no one else
        repartitioned while we were suspended — a stale plan is dropped,
        never stomped over a newer one."""
        proc = self.db.process
        base = self.split_keys  # the snapshot this round's plan is built on
        ops = []
        for r in self.resolvers:
            rep = await r.metrics.get_reply(proc, None)
            ops.append(rep.ops)
        # The most imbalanced ADJACENT pair among those that PASS the
        # move gate (boundaries only move between neighbors, like the
        # reference's balancer).  Gating after selection would let one big
        # but-below-ratio gap starve a qualifying pair elsewhere forever.
        best, best_gap = None, 0
        for i in range(len(ops) - 1):
            oi, oj = ops[i], ops[i + 1]
            if max(oi, oj) < self.min_ops or max(oi, oj) <= self.ratio * max(
                1, min(oi, oj)
            ):
                continue
            gap = abs(oi - oj)
            if gap > best_gap:
                best, best_gap = i, gap
        if best is None:
            return None
        i = best
        oi, oj = ops[i], ops[i + 1]
        bounds = sk.bounds_from_split_keys(base)
        target = (oi + oj) / 2.0
        if oi > oj:
            # Donor on the left: keep its first `target/oi` of mass; the
            # boundary moves LEFT to the donated remainder's first key.
            lo, hi = bounds[i]
            new_key = await self.resolvers[i].split.get_reply(
                proc,
                ResolutionSplitRequest(
                    begin=lo, end=hi, fraction=target / max(oi, 1)
                ),
            )
        else:
            # Donor on the right: give away its first (oj-target)/oj of
            # mass; the boundary moves RIGHT to the key after the donation.
            lo, hi = bounds[i + 1]
            new_key = await self.resolvers[i + 1].split.get_reply(
                proc,
                ResolutionSplitRequest(
                    begin=lo,
                    end=hi,
                    fraction=(oj - target) / max(oj, 1),
                ),
            )
        if new_key is None or new_key in (b"",):
            return None
        # A deliberate snapshot: the commit re-validates the durable
        # partition against base and drops a stale plan (see docstring).
        old = base[i]
        if new_key == old:
            return None
        new_splits = list(base)
        new_splits[i] = new_key
        if sorted(set(new_splits)) != new_splits or b"" in new_splits:
            return None  # refuse a degenerate partition

        stale = []

        async def txn(tr):
            tr.options["access_system_keys"] = True
            # Conflict-checked read: if another mover committed while this
            # round was suspended, either we see its value here and abort
            # the plan, or the resolver aborts one of the two commits —
            # the durable partition is never built from a stale snapshot.
            cur = await tr.get(sk.RESOLVER_SPLIT_KEY)
            if cur is not None and sk.decode_resolver_split(cur) != list(base):
                stale.append(True)
                return
            tr.set(sk.RESOLVER_SPLIT_KEY, sk.encode_resolver_split(new_splits))

        await self.db.run(txn)
        if stale or self.split_keys is not base:
            return None  # someone repartitioned during our awaits
        self.split_keys = new_splits
        self.moves += 1
        return new_splits

    async def run(self, interval: float = 0.5, rounds: Optional[int] = None):
        """Poll loop.  After a move, wait out the proxies' overlap window
        (MVCC window + in-flight depth, in seconds) before moving again —
        overlapping transitions would stack overlays."""
        loop = self.db.process.network.loop
        overlap_s = (
            MAX_WRITE_TRANSACTION_LIFE_VERSIONS + MAX_VERSIONS_IN_FLIGHT
        ) / VERSIONS_PER_SECOND
        n = 0
        while rounds is None or n < rounds:
            n += 1
            moved = await self.run_once()
            await loop.delay(interval + (overlap_s if moved else 0.0))
            if moved:
                # Discard the overlap window's metrics: both owners counted
                # the donated range's traffic while proxies unioned old+new
                # bounds, so the counters read double until reset.
                for r in self.resolvers:
                    try:
                        await r.metrics.get_reply(self.db.process, None)
                    except Exception:  # noqa: BLE001 - resolver died:  # fdblint: ignore[ERR001]: best-effort counter reset on a dying generation — recovery replaces the role anyway
                        pass  # the generation is ending anyway


class ShardBalancer:
    """Self-balancing shards: the in-process twin of ResolverBalancer
    above, moving the SHARDED conflict set's split points
    from live signals — per-shard mirror occupancy gauges, the decayed
    contended-range sample (via ``load_fn``), and the admission-pressure
    scalar for 2→4→8 shard-count scaling.  This is
    the reference's dataDistribution/shard-mover role, scoped to the
    resolver's key partition.

    Every call to :meth:`evaluate` appends one decision record to
    ``decisions`` — a replayable transition log built only from
    deterministic inputs (occupancy counts, supplied loads/pressure,
    the tick counter), so same-seed runs dump byte-identical logs.
    Two anti-flap gates: ``hysteresis`` consecutive over-``ratio``
    evaluations must agree before a move, and every committed move
    starts a ``cooldown`` of idle ticks (the reference balancer's
    overlap-window wait, in ticks instead of versions)."""

    def __init__(
        self,
        conflict_set,
        ratio: float = 2.0,
        hysteresis: int = 2,
        cooldown: int = 4,
        min_boundaries: int = 32,
        scale_up_pressure: float = 0.85,
        load_fn=None,
    ):
        self.conflict_set = conflict_set
        self.ratio = ratio
        self.hysteresis = hysteresis
        self.cooldown = cooldown
        self.min_boundaries = min_boundaries
        self.scale_up_pressure = scale_up_pressure
        self.load_fn = load_fn
        self.decisions: List[dict] = []
        self.moves = 0
        self._ticks = 0
        self._streak = 0
        self._cooldown_left = 0

    def decisions_json(self) -> str:
        """Canonical dump of the decision log — the same-seed
        byte-identity artifact (cli shards / soak resharding section)."""
        import json

        return json.dumps(
            self.decisions, sort_keys=True, separators=(",", ":")
        )

    def evaluate(self, pressure: Optional[float] = None) -> dict:
        """One balancing tick; returns (and logs) the decision.

        ``pressure`` is the admission-pressure scalar in [0, 1] (e.g.
        released/limit from the ratekeeper, or a queue-depth fraction):
        sustained pressure at/above ``scale_up_pressure`` doubles the
        shard count (bounded by the set's ``max_shards``) instead of
        just moving boundaries.  Synchronous — no await — so it can
        never interleave with a batch mid-resolve."""
        cs = self.conflict_set
        self._ticks += 1
        occ = cs.shard_occupancy()
        n = cs.n_shards
        entry: dict = {
            "tick": self._ticks,
            "shards": n,
            "occupancy": [int(o) for o in occ],
            "action": "idle",
        }
        if pressure is not None:
            entry["pressure"] = round(float(pressure), 4)
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            entry["action"] = "cooldown"
            self.decisions.append(entry)
            return entry
        if getattr(cs, "_pinned", False):
            # Long-key pin: the mirrors hold keys the device cannot
            # encode, so new split points may not either — sit out.
            entry["action"] = "pinned"
            self._streak = 0
            self.decisions.append(entry)
            return entry
        total = sum(occ)
        mean = total / max(1, n)
        imb = (max(occ) / mean) if mean > 0 else 0.0
        loads = None
        if self.load_fn is not None:
            loads = [int(x) for x in self.load_fn()]
            if len(loads) == n and sum(loads) > 0:
                entry["load"] = loads
                lmean = sum(loads) / n
                imb = max(imb, max(loads) / lmean)
            else:
                loads = None
        entry["imbalance"] = round(imb, 3)
        want_scale = (
            pressure is not None
            and pressure >= self.scale_up_pressure
            and n < getattr(cs, "max_shards", n)
        )
        if imb >= self.ratio or want_scale:
            self._streak += 1
        else:
            self._streak = 0
        entry["streak"] = self._streak
        if self._streak < self.hysteresis or total < self.min_boundaries:
            self.decisions.append(entry)
            return entry
        target_n = min(getattr(cs, "max_shards", n), n * 2) if want_scale else n
        new_split = cs.balance_split_keys(target_n)
        if [bytes(k) for k in new_split] == list(cs.split_keys):
            entry["action"] = "no_candidate"
            self._streak = 0
            self.decisions.append(entry)
            return entry
        try:
            move = cs.reshard(
                new_split, reason=f"balancer_tick{self._ticks}"
            )
        except ValueError as e:
            # The set refused the partition (e.g. a candidate key the
            # device cannot encode): log and stand down — never let a
            # rejected plan kill the balancer actor.
            entry["action"] = "rejected"
            entry["error"] = str(e)
            self._streak = 0
            self.decisions.append(entry)
            return entry
        self._streak = 0
        self._cooldown_left = self.cooldown
        entry["action"] = "scale" if target_n != n else "move"
        entry["move"] = {"seq": move["seq"], "action": move["action"]}
        if move["action"] != "deferred":
            self.moves += 1
        self.decisions.append(entry)
        return entry
