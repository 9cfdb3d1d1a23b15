"""Locality data + replication policy algebra.

Ref: fdbrpc/Locality.h:117 (LocalityData: processId/zoneId/machineId/dcId
key-value sets) and fdbrpc/ReplicationPolicy.h — the policy combinators
`PolicyOne` (:33, any one replica), `PolicyAcross` (:99, k replicas across
distinct values of an attribute, each satisfying a sub-policy), and
`PolicyAnd` (:119, all sub-policies at once).  `select_replicas` picks a
satisfying subset from candidates; `validate` checks one.  Team building
(DD) and tlog recruitment use these to spread replicas across failure
domains.

The port's own copy of the reference package's ``rpc/locality.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


@dataclass(frozen=True)
class LocalityData:
    """Ref: LocalityData fdbrpc/Locality.h:117 — the standard keys."""

    process_id: str = ""
    zone_id: str = ""
    machine_id: str = ""
    dc_id: str = ""

    def get(self, attr: str) -> str:
        return {
            "processid": self.process_id,
            "zoneid": self.zone_id,
            "machineid": self.machine_id,
            "dcid": self.dc_id,
        }[attr.lower()]


class ReplicationPolicy:
    def validate(self, localities: Sequence[LocalityData]) -> bool:
        raise NotImplementedError

    def select_replicas(
        self, candidates: Dict[object, LocalityData]
    ) -> Optional[List[object]]:
        """A minimal-ish satisfying subset of candidate ids, or None.
        Deterministic: candidates are considered in sorted-id order (the
        reference randomizes; determinism keeps simulation reproducible)."""
        raise NotImplementedError


class PolicyOne(ReplicationPolicy):
    """Any single replica (ref: PolicyOne :33)."""

    def validate(self, localities):
        return len(localities) >= 1

    def select_replicas(self, candidates):
        for key in sorted(candidates, key=str):
            return [key]
        return None

    def __repr__(self):
        return "One()"


class PolicyAcross(ReplicationPolicy):
    """`count` replicas with distinct values of `attr`, each group
    satisfying `sub` (ref: PolicyAcross :99 — e.g.
    Across(2, "zoneid", One()) = two replicas in two distinct zones)."""

    def __init__(self, count: int, attr: str, sub: ReplicationPolicy = None):
        self.count = count
        self.attr = attr
        self.sub = sub or PolicyOne()

    def validate(self, localities):
        groups: Dict[str, list] = {}
        for loc in localities:
            groups.setdefault(loc.get(self.attr), []).append(loc)
        ok = sum(1 for g in groups.values() if self.sub.validate(g))
        return ok >= self.count

    def select_replicas(self, candidates):
        groups: Dict[str, Dict[object, LocalityData]] = {}
        for key in sorted(candidates, key=str):
            loc = candidates[key]
            groups.setdefault(loc.get(self.attr), {})[key] = loc
        chosen: List[object] = []
        used = 0
        for val in sorted(groups):
            if used >= self.count:
                break
            sel = self.sub.select_replicas(groups[val])
            if sel is not None:
                chosen.extend(sel)
                used += 1
        return chosen if used >= self.count else None

    def __repr__(self):
        return f"Across({self.count}, {self.attr}, {self.sub!r})"


class PolicyAnd(ReplicationPolicy):
    """All sub-policies simultaneously (ref: PolicyAnd :119).  Selection is
    greedy: the union of each sub-policy's picks, re-validated."""

    def __init__(self, subs: List[ReplicationPolicy]):
        self.subs = list(subs)

    def validate(self, localities):
        return all(p.validate(localities) for p in self.subs)

    def select_replicas(self, candidates):
        chosen: Dict[object, LocalityData] = {}
        for p in self.subs:
            sel = p.select_replicas(candidates)
            if sel is None:
                return None
            for k in sel:
                chosen[k] = candidates[k]
        locs = list(chosen.values())
        if not self.validate(locs):
            return None
        return sorted(chosen, key=str)

    def __repr__(self):
        return f"And({self.subs!r})"
