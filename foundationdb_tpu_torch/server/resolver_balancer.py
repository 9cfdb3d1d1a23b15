"""Shard balancing: move the sharded conflict set's split points toward
the load.

The part of the reference package's ``server/resolver_balancer.py`` the
Resolver runs in-process: ``ShardBalancer``, which evaluates per-shard
mirror occupancy and the decayed contended-range sample and reshards the
``ShardedTorchConflictSet`` live.
"""

from __future__ import annotations

from typing import List, Optional


class ShardBalancer:
    """Self-balancing shards: the in-process twin of the reference's RPC
    resolution balancer, moving the SHARDED conflict set's split points
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
