"""Chrome trace-event / Perfetto export of the span layer.

The port's own copy of the reference package's ``flow/trace_export.py``.
It turns a SpanHub's completed spans into one canonical trace-event JSON
document that ui.perfetto.dev and chrome://tracing load:

* one process (pid) per span role, named by a "M" (metadata) event; pids
  follow the sorted role names, so a role keeps its pid within a document
  and across runs of one seed;
* a B/E duration-event pair per span on the axis ``hub clock seconds *
  1e6 + seq * 1e-3`` microseconds: the hub's clock carries the order, and
  its event-sequence stamp breaks the ties the clock cannot (host work is
  instantaneous on a virtual clock), so every B precedes its E;
* tids are lanes, assigned per pid: a span goes to its parent's lane while
  it nests there, a root only to an empty lane, so two pipelined batches
  of one resolver sit side by side with their stages nested under each.

Only the spans' deterministic fields go in (clock time, seq, role, name,
attrs) unless ``include_wall=True`` adds each span's wall milliseconds, so
``perfetto_json()`` of two runs of one seed gives the same bytes.  On the
same spans its output is byte-identical to the reference exporter's.

With no hub given the functions read the port's ``global_span_hub()``.
``validate_perfetto`` is the schema check: every B has a matching E on its
(pid, tid), properly nested, each role keeps one pid, and every pid has
exactly one process_name event.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from .spans import global_span_hub


def _ts(vt: float, seq: int) -> float:
    """Trace timestamp in microseconds: clock seconds scaled, with the
    event-sequence stamp as a 1 ns tiebreak, so equal-clock events keep
    their order and B < E always holds."""
    return round(vt * 1e6 + seq * 1e-3, 6)


def _assign_lanes(spans: List) -> Dict[int, int]:
    """span_id -> lane (tid) for one role's spans.

    A span goes to its parent's lane whenever it still nests there (a
    geometric first fit would nest batch N+1's encode, which begins inside
    batch N's window, under the wrong batch).  A root takes only a lane
    that is empty at its begin, else opens a new one; a non-root whose
    parent is unknown (dropped from the ring) nests geometrically.  Every
    placement is checked against the lane's open stack, so the B/E
    nesting is valid by construction."""
    lanes: List[List[float]] = []  # per lane: the open spans' end ts
    out: Dict[int, int] = {}
    order = sorted(spans, key=lambda s: (_ts(s.start, s.seq), -_ts(s.stop, s.end_seq)))
    for sp in order:
        b, e = _ts(sp.start, sp.seq), _ts(sp.stop, sp.end_seq)
        for stack in lanes:
            while stack and stack[-1] <= b:
                stack.pop()

        def _fits(stack):
            return not stack or e <= stack[-1]

        placed = None
        parent_lane = out.get(sp.parent_id)
        if parent_lane is not None and _fits(lanes[parent_lane]):
            placed = parent_lane
        if placed is None:
            for li, stack in enumerate(lanes):
                if sp.parent_id is None:
                    if not stack:  # a root never nests under another span
                        placed = li
                        break
                elif _fits(stack):
                    placed = li
                    break
        if placed is None:
            lanes.append([])
            placed = len(lanes) - 1
        lanes[placed].append(e)
        out[sp.span_id] = placed
    return out


def perfetto_trace(hub=None, include_wall: bool = False,
                   last_n: Optional[int] = None) -> dict:
    """The trace-event document of the hub's completed spans (the last
    ``last_n`` a role when given)."""
    hub = hub if hub is not None else global_span_hub()
    events: List[dict] = []
    for pid, role in enumerate(sorted(hub.rings), start=1):
        spans = list(hub.rings[role])
        if last_n is not None:
            spans = spans[-last_n:]
        spans = [s for s in spans if s.done]
        if not spans:
            continue
        events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                       "args": {"name": role}})
        lanes = _assign_lanes(spans)
        for sp in spans:
            tid = lanes[sp.span_id] + 1
            args = {"span": sp.span_id, **sp.attrs}
            if sp.parent_id is not None:
                args["parent"] = sp.parent_id
            if include_wall and sp.wall_end is not None:
                args["wall_ms"] = round((sp.wall_end - sp.wall_start) * 1e3, 4)
            events.append({"ph": "B", "name": sp.name, "cat": role, "pid": pid,
                           "tid": tid, "ts": _ts(sp.start, sp.seq), "args": args})
            events.append({"ph": "E", "name": sp.name, "cat": role, "pid": pid,
                           "tid": tid, "ts": _ts(sp.stop, sp.end_seq)})
    # Metadata events lead their pid, then ts order.
    events.sort(key=lambda e: (e["pid"], e["ph"] != "M", e.get("ts", 0.0)))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            # The reference's source tag, so that the two exporters' bytes
            # are equal on the same spans.
            "source": "foundationdb_tpu spans (flow/spans.py)",
            "seed": hub.seed,
            "spans": sum(1 for e in events if e["ph"] == "B"),
        },
    }


def perfetto_json(hub=None, include_wall: bool = False,
                  last_n: Optional[int] = None) -> str:
    """The document's canonical bytes: dict keys sorted, the event array
    in its deterministic order, no whitespace."""
    return json.dumps(perfetto_trace(hub=hub, include_wall=include_wall, last_n=last_n),
                      sort_keys=True, separators=(",", ":"))


def validate_perfetto(doc: dict) -> List[str]:
    """The schema check: the list of violations (empty when valid)."""
    errors: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    stacks: Dict[tuple, List[dict]] = {}
    names_by_pid: Dict[int, List[str]] = {}
    role_pid: Dict[str, int] = {}
    last_ts: Dict[tuple, float] = {}
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph == "M":
            if e.get("name") == "process_name":
                names_by_pid.setdefault(e["pid"], []).append(e["args"]["name"])
            continue
        if ph not in ("B", "E"):
            errors.append(f"event {i}: unexpected ph {ph!r}")
            continue
        key = (e.get("pid"), e.get("tid"))
        ts = e.get("ts")
        if ts is None:
            errors.append(f"event {i}: missing ts")
            continue
        if last_ts.get(key, float("-inf")) > ts:
            errors.append(f"event {i}: ts not monotonic within {key}")
        last_ts[key] = ts
        if ph == "B":
            role = e.get("cat")
            if role is not None:
                prev = role_pid.setdefault(role, e["pid"])
                if prev != e["pid"]:
                    errors.append(f"role {role!r} spans pids {prev} and {e['pid']}")
            stacks.setdefault(key, []).append(e)
        else:
            stack = stacks.get(key)
            if not stack:
                errors.append(f"event {i}: E with empty stack on {key}")
                continue
            b = stack.pop()
            if b.get("name") != e.get("name"):
                errors.append(f"event {i}: E name {e.get('name')!r} closes B "
                              f"{b.get('name')!r} on {key}")
    for key, stack in stacks.items():
        if stack:
            errors.append(f"{len(stack)} unclosed B event(s) on {key}: "
                          f"{[b.get('name') for b in stack]}")
    for pid, names in names_by_pid.items():
        if len(names) != 1:
            errors.append(f"pid {pid} has {len(names)} process_name events")
    return errors
