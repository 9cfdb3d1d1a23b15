"""Latency-chain reassembly: g_traceBatch events -> per-stage durations.

Ref: the CommitDebug/TransactionDebug trace-batch chains
(NativeAPI.actor.cpp:2376, Resolver.actor.cpp:84) and the tooling habit of
joining them by debug id to see where a sampled transaction spent its
time.  `trace_batch()` (flow/trace.py) emits one event per pipeline stage
keyed by the sampled transaction's debug id; this module joins those
events back into client -> proxy -> resolver -> tlog -> reply stage
durations with percentile summaries, consumed by `tools/cli.py latency`
and the test gates.

Everything here is pure computation over already-collected events:
percentiles are exact (full sort, same index rule as ContinuousSample),
so summaries are byte-identical across same-seed runs by construction.

The port's own copy of the reference package's ``flow/latency_chain.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# (stage name, from location, to location) in pipeline order.  A stage's
# duration is last(to) - first(from) within one debug id's chain — `first`
# and `last` because multi-resolver/multi-log batches emit the same
# location once per role, and the slowest replica is what the client
# waited on.
COMMIT_CHAIN: List[Tuple[str, str, str]] = [
    ("client->proxy", "NativeAPI.commit.Before",
     "MasterProxyServer.commitBatch.Before"),
    ("proxy.getVersion", "MasterProxyServer.commitBatch.Before",
     "MasterProxyServer.commitBatch.GotCommitVersion"),
    ("resolver", "Resolver.resolveBatch.Before",
     "Resolver.resolveBatch.After"),
    ("proxy.resolution", "MasterProxyServer.commitBatch.GotCommitVersion",
     "MasterProxyServer.commitBatch.AfterResolution"),
    ("tlog", "MasterProxyServer.commitBatch.AfterResolution",
     "MasterProxyServer.commitBatch.AfterLogPush"),
    ("reply", "MasterProxyServer.commitBatch.AfterLogPush",
     "NativeAPI.commit.After"),
    ("total", "NativeAPI.commit.Before", "NativeAPI.commit.After"),
]

GRV_CHAIN: List[Tuple[str, str, str]] = [
    ("client->proxy", "NativeAPI.getConsistentReadVersion.Before",
     "MasterProxyServer.serveGrv.GotRequest"),
    ("proxy.grv", "MasterProxyServer.serveGrv.GotRequest",
     "MasterProxyServer.serveGrv.Replied"),
    ("reply", "MasterProxyServer.serveGrv.Replied",
     "NativeAPI.getConsistentReadVersion.After"),
    ("total", "NativeAPI.getConsistentReadVersion.Before",
     "NativeAPI.getConsistentReadVersion.After"),
]


def chains(events: List[dict], type_: str) -> Dict[str, List[Tuple[str, float]]]:
    """Join trace events of one batch type by debug id: id -> time-ordered
    [(location, time)].  Events without an ID (unsampled) are skipped."""
    out: Dict[str, List[Tuple[str, float]]] = {}
    for e in events:
        if e.get("Type") != type_:
            continue
        did = e.get("ID")
        loc = e.get("Location")
        if did is None or loc is None:
            continue
        out.setdefault(did, []).append((loc, e["Time"]))
    for seq in out.values():
        seq.sort(key=lambda lt: lt[1])
    return out


def stage_durations(
    events: List[dict], type_: str, spec: List[Tuple[str, str, str]]
) -> Dict[str, List[float]]:
    """Per-stage duration samples across every reassembled chain.  A chain
    missing either endpoint of a stage contributes nothing to that stage
    (e.g. a GRV-only debug id never reaches the commit stages)."""
    out: Dict[str, List[float]] = {name: [] for name, _f, _t in spec}
    for seq in chains(events, type_).values():
        first: Dict[str, float] = {}
        last: Dict[str, float] = {}
        for loc, t in seq:
            first.setdefault(loc, t)
            last[loc] = t
        for name, frm, to in spec:
            if frm in first and to in last and last[to] >= first[frm]:
                out[name].append(last[to] - first[frm])
    return out


def percentile(samples: List[float], p: float) -> Optional[float]:
    """Exact percentile, same index rule as ContinuousSample.percentile."""
    if not samples:
        return None
    s = sorted(samples)
    return s[min(len(s) - 1, int(p * len(s)))]


def summarize_stages(
    events: List[dict], type_: str, spec: List[Tuple[str, str, str]]
) -> Dict[str, dict]:
    """Stage -> {count, p50, p90, p99, max}; the shape `cli latency`
    prints and the status-adjacent tooling consumes."""
    out: Dict[str, dict] = {}
    for name, samples in stage_durations(events, type_, spec).items():
        out[name] = {
            "count": len(samples),
            "p50": percentile(samples, 0.5),
            "p90": percentile(samples, 0.90),
            "p99": percentile(samples, 0.99),
            "max": max(samples) if samples else None,
        }
    return out


def latency_summary(events: List[dict]) -> dict:
    """The full reassembly: commit + GRV chains, in pipeline stage order."""
    return {
        "commit": summarize_stages(events, "CommitDebug", COMMIT_CHAIN),
        "grv": summarize_stages(events, "TransactionDebug", GRV_CHAIN),
    }
