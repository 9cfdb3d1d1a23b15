"""DET101: interprocedural determinism taint over the port.

The port's own copy of the reference package's ``tools/lint/det101.py``.
It seeds the DET001/DET002 sources (each function's direct wall-clock and
entropy references, from graphs.py's summaries), propagates them backward
through the CallGraph, and flags every CALL SITE in a simulator-executed
function whose callee transitively reaches a source, naming the chain, so
a helper three frames below ``ConflictSet.pipeline_submit`` cannot hide a
``time.time()``.  Allowlisted modules (tools/) are never flagged but still
carry taint into any caller outside them.

Pragmas compose: a ``fdblint: ignore[DET001/DET002/DET101]`` pragma on a
source line SANCTIONS it (the reason asserts the site is fine, so its
callers are fine too: ``metrics.wall_now()``'s one pragma ends every chain
through it), and a DET101 pragma on a call site cuts that edge.  A cutting
pragma on an edge whose callee is clean did no work and goes stale
(PRG002)."""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from .base import Finding, Pragma, allows, pragma_sanctions
from .graphs import CallGraph, ModuleSummary

Node = Tuple[str, str]  # (relpath, qualname)

# A pragma for any of these on the source's statement sanctions it.
_SANCTION_RULES = ("DET001", "DET002", "DET101")


def run_det101(
    summaries: Dict[str, ModuleSummary],
    pragmas_by_file: Dict[str, Dict[int, Pragma]],
    graph: CallGraph,
    consumed_pragmas: Optional[Dict[str, Set[int]]] = None,
) -> List[Finding]:
    """`consumed_pragmas` (relpath -> line set), when given, collects the
    DET101 pragmas that did their work by CUTTING taint (sanctioning a
    source or a call edge): those never see a finding to suppress, so the
    caller must mark them used or PRG002 would call them stale."""

    def consume(relpath: str, line: int):
        if consumed_pragmas is not None:
            consumed_pragmas.setdefault(relpath, set()).add(line)

    # Each function's first unsanctioned direct source: node -> (dotted,
    # kind).  A sanctioning pragma counts on ANY physical line of the
    # reference's simple statement, the scope suppression uses.
    sources: Dict[Node, Tuple[str, str]] = {}
    for ms in summaries.values():
        pragmas = pragmas_by_file.get(ms.relpath, {})
        for qual, fs in ms.functions.items():
            for dotted, line, kind, span_end in fs.refs:
                span = range(line, span_end + 1)
                if any(pragma_sanctions(pragmas, ln, _SANCTION_RULES) for ln in span):
                    for ln in span:
                        p = pragmas.get(ln)
                        if p is not None and "DET101" in p.rules:
                            consume(ms.relpath, ln)
                    continue
                sources.setdefault((ms.relpath, qual), (dotted, kind))
                break

    # Forward edges, less the pragma-cut call sites.  A cut is consumed
    # only if its callee turns out tainted.
    fwd: Dict[Node, List[Tuple[Tuple[int, int], Node]]] = {}
    rev: Dict[Node, List[Node]] = {}
    cuts: List[Tuple[str, List[int], Node]] = []
    for caller, span, callee in graph.edges():
        pragmas = pragmas_by_file.get(caller[0], {})
        cut_lines = [ln for ln in range(span[0], span[1] + 1)
                     if pragma_sanctions(pragmas, ln, ("DET101",))]
        if cut_lines:
            cuts.append((caller[0], cut_lines, callee))
            continue
        fwd.setdefault(caller, []).append((span, callee))
        rev.setdefault(callee, []).append(caller)

    # Reverse BFS from the sources; `via` records each tainted node's next
    # hop toward a source, for the chain a finding prints.
    tainted: Set[Node] = set(sources)
    via: Dict[Node, Node] = {}
    frontier = sorted(sources)
    while frontier:
        nxt: List[Node] = []
        for node in frontier:
            for caller in rev.get(node, ()):
                if caller not in tainted:
                    tainted.add(caller)
                    via[caller] = node
                    nxt.append(caller)
        frontier = sorted(set(nxt))

    for relpath, cut_lines, callee in cuts:
        if callee in tainted:
            for ln in cut_lines:
                consume(relpath, ln)

    def chain_of(node: Node, limit: int = 6) -> Tuple[List[str], Tuple[str, str]]:
        names: List[str] = []
        cur = node
        while cur in via and len(names) < limit:
            names.append(cur[1])
            cur = via[cur]
        names.append(cur[1])
        return names, sources.get(cur, ("<source>", "wall"))

    findings: List[Finding] = []
    seen: Set[Tuple[str, int, Node]] = set()
    for ms in summaries.values():
        if allows("DET101", ms.relpath):
            continue  # allowlisted: a carrier, never a root
        for qual in ms.functions:
            node = (ms.relpath, qual)
            if node in sources:
                continue  # DET001/DET002 flag the direct site itself
            for (line, end_line), callee in fwd.get(node, ()):
                if callee not in tainted:
                    continue
                key = (ms.relpath, line, callee)
                if key in seen:
                    continue
                seen.add(key)
                names, (dotted, kind) = chain_of(callee)
                what = "wall-clock" if kind == "wall" else "entropy source"
                findings.append(Finding(
                    "DET101", ms.relpath, line, 0,
                    f"'{qual}' calls '{callee[1]}' which transitively "
                    f"reaches {what} '{dotted}' "
                    f"(chain: {' -> '.join([qual] + names)})",
                    end_line=end_line,
                ))
    return findings
