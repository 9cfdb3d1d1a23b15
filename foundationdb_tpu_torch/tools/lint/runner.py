"""The port's lint gate: fdblint and perfcheck, and torchcheck with ``--all``.

    python -m foundationdb_tpu_torch.tools.lint [root] [--all]
        [--format=text|json|sarif] [--show-suppressed] [--pragma-inventory]
        [--list-rules]

The twin of the reference package's ``tools/lint/runner.py``.  The two
source tools share one load of the tree (each ``.py`` under ``root``, the
port's package by default, parsed once) and one CallGraph: fdblint
(``local.py`` and ``det101.py``: DET001-003, DET101, IO001, TRC001,
SPN001, ERR001, ENV001) and perfcheck (``hotpath.py``, HOT001-HOT004),
each applying its own pragma namespace.  ``--all`` adds torchcheck
(``torchir.py``, the TGX rules over the registered device programs, run on
the CPU; its fingerprints stay with its own CLI), in jaxcheck's place.
The output is per-tool/per-rule counts on stderr (``[fdblint] 0
finding(s), 5 suppressed; per-rule (flagged+suppressed): DET001=0+2s
...``, every rule of the two source families shown even at zero), one
JSON doc, or ONE SARIF document with one run per tool.
``--pragma-inventory`` lists every suppression in the fdblint, perfcheck
and torchcheck namespaces as canonical sorted JSON (file, line, tool,
rules, reason) and exits 0; ``--list-rules`` prints every tool's rules.
Exit 1 on any unsuppressed finding.  ``tools/fdblint.py`` is the same
gate with fdblint alone.

There is no fact cache: a whole scan of the port takes seconds, and the
reference's cache lives outside its checkout as a pickle."""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from .base import (
    RULES,
    SKIP_MODULE_GLOBS,
    Finding,
    _match_any,
    allows,
    apply_pragmas,
    parse_pragmas,
)
from .det101 import run_det101
from .graphs import CallGraph, collect_summary
from .hotpath import HOT_RULES, collect_hotpath, run_hotpath_rules
from .local import ModuleLinter

# Every pragma namespace the port uses.
PRAGMA_TOOLS: Tuple[str, ...] = ("fdblint", "perfcheck", "torchcheck")

# The tools that read the source, from one load of the tree.
SOURCE_TOOLS: Tuple[str, ...] = ("fdblint", "perfcheck")

SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)

# Always shown in the counts line, zero or not: a count that silently
# vanished from the output is how a burned-down family quietly regrows.
_ALWAYS_COUNTED = {
    "fdblint": ("DET001", "DET002", "DET003", "DET101", "IO001", "TRC001",
                "SPN001", "ERR001", "ENV001"),
    "perfcheck": ("HOT001", "HOT002", "HOT003", "HOT004"),
}


def _default_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def iter_py_files(root: str):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _lint(sources: Dict[str, str], root_pkg: Optional[str],
          tools: Tuple[str, ...] = SOURCE_TOOLS) -> Dict[str, List[Finding]]:
    """The source tools over {relpath: source}: each file parsed once into
    its summary (and its per-file facts), the interprocedural rules over
    ONE CallGraph, then each tool's own pragmas, file by file."""
    trees = {rp: ast.parse(src, filename=rp) for rp, src in sources.items()}
    summaries = {rp: collect_summary(rp, t, root_pkg) for rp, t in trees.items()}
    graph = CallGraph(summaries)
    out: Dict[str, List[Finding]] = {}
    if "fdblint" in tools:
        pragmas = {rp: parse_pragmas(src, tool="fdblint") for rp, src in sources.items()}
        by_file: Dict[str, List[Finding]] = {
            rp: ModuleLinter(rp, t).run() for rp, t in trees.items()}
        consumed: Dict[str, set] = {}
        for f in run_det101(summaries, pragmas, graph, consumed_pragmas=consumed):
            by_file[f.path].append(f)
        found: List[Finding] = []
        for rp in sorted(sources):
            for ln in consumed.get(rp, ()):
                pragmas[rp][ln].used = True
            kept = [f for f in by_file[rp] if not allows(f.rule, rp)]
            found.extend(apply_pragmas(kept, pragmas[rp], rp, rules=RULES))
        out["fdblint"] = found
    if "perfcheck" in tools:
        hot = {rp: collect_hotpath(rp, t) for rp, t in trees.items()}
        by_file = {rp: [] for rp in sources}
        for f in run_hotpath_rules(summaries, hot, graph=graph):
            by_file[f.path].append(f)
        found = []
        for rp in sorted(sources):
            pragmas = parse_pragmas(sources[rp], tool="perfcheck")
            found.extend(apply_pragmas(by_file[rp], pragmas, rp, rules=HOT_RULES))
        out["perfcheck"] = found
    for found in out.values():
        found.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def lint_source(source: str, relpath: str,
                tools: Tuple[str, ...] = SOURCE_TOOLS) -> List[Finding]:
    """The source tools over one module's source, as its own whole
    project; every tool's findings in one sorted list."""
    by_tool = _lint({relpath: source}, None, tools)
    return sorted((f for fs in by_tool.values() for f in fs),
                  key=lambda f: (f.path, f.line, f.rule))


def run_source_tools(root: Optional[str] = None,
                     tools: Tuple[str, ...] = SOURCE_TOOLS) -> Dict[str, List[Finding]]:
    """{tool: findings} of the source tools over every module under
    `root` (the port's package by default), from one load of the tree;
    paths are relative to it."""
    root = root or _default_root()
    sources = {}
    for path in iter_py_files(root):
        relpath = os.path.relpath(path, root).replace(os.sep, "/")
        if _match_any(relpath, SKIP_MODULE_GLOBS):
            continue
        with open(path, "r", encoding="utf-8") as f:
            sources[relpath] = f.read()
    root_pkg = (os.path.basename(os.path.abspath(root))
                if os.path.exists(os.path.join(root, "__init__.py")) else None)
    return _lint(sources, root_pkg, tools)


def run_fdblint(root: Optional[str] = None) -> List[Finding]:
    return run_source_tools(root, ("fdblint",))["fdblint"]


def run_perfcheck(root: Optional[str] = None) -> List[Finding]:
    return run_source_tools(root, ("perfcheck",))["perfcheck"]


def pragma_inventory(root: str) -> List[dict]:
    """Every suppression in every namespace, canonically sorted (a pragma
    that suppresses nothing is ALSO a PRG002 finding, so the gate catches
    staleness; the inventory is the human-auditable registry)."""
    out: List[dict] = []
    for path in iter_py_files(root):
        relpath = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        for tool in PRAGMA_TOOLS:
            for line, p in parse_pragmas(source, tool=tool).items():
                out.append({"file": relpath, "line": line, "tool": tool,
                            "rules": sorted(p.rules), "reason": p.reason})
    out.sort(key=lambda d: (d["file"], d["line"], d["tool"]))
    return out


def rules_of(tool: str) -> Dict[str, str]:
    if tool == "torchcheck":
        from .torchir import TORCH_RULES

        return TORCH_RULES
    return {"fdblint": RULES, "perfcheck": HOT_RULES}[tool]


def count_by_rule(findings: List[Finding]) -> Dict[str, Dict[str, int]]:
    """{rule: {"flagged": n, "suppressed": m}} for every rule that fired."""
    out: Dict[str, Dict[str, int]] = {}
    for f in findings:
        slot = out.setdefault(f.rule, {"flagged": 0, "suppressed": 0})
        slot["suppressed" if f.suppressed else "flagged"] += 1
    return {r: out[r] for r in sorted(out)}


def format_counts(findings: List[Finding], always=()) -> str:
    counts = count_by_rule(findings)
    for rule in always:
        counts.setdefault(rule, {"flagged": 0, "suppressed": 0})
    if not counts:
        return "per-rule: (none)"
    return "per-rule (flagged+suppressed): " + " ".join(
        f"{rule}={c['flagged']}+{c['suppressed']}s" for rule, c in sorted(counts.items()))


def format_tool_counts(by_tool: Dict[str, List[Finding]]) -> List[str]:
    lines = []
    for tool in sorted(by_tool):
        findings = by_tool[tool]
        n_un = sum(1 for f in findings if not f.suppressed)
        lines.append(f"[{tool}] {n_un} finding(s), {len(findings) - n_un} suppressed; "
                     + format_counts(findings, _ALWAYS_COUNTED.get(tool, ())))
    return lines


def to_sarif(shown: List[Finding], rules: Dict[str, str], tool: str) -> dict:
    results = []
    for f in shown:
        res = {
            "ruleId": f.rule,
            "level": "note" if f.suppressed else "error",
            "message": {"text": f.message},
            "locations": [{"physicalLocation": {
                "artifactLocation": {"uri": f.path},
                "region": {"startLine": f.line, "startColumn": max(1, f.col + 1)},
            }}],
        }
        if f.suppressed:
            res["suppressions"] = [{"kind": "inSource", "justification": f.reason}]
        results.append(res)
    return {
        "$schema": SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": tool,
                "rules": [{"id": rule, "shortDescription": {"text": desc}}
                          for rule, desc in sorted(rules.items())],
            }},
            "results": results,
        }],
    }


def merged_sarif(by_tool: Dict[str, List[Finding]], show_suppressed: bool) -> dict:
    """ONE SARIF document, one run per tool."""
    runs = []
    for tool, findings in sorted(by_tool.items()):
        shown = findings if show_suppressed else [f for f in findings if not f.suppressed]
        runs.extend(to_sarif(shown, rules_of(tool), tool)["runs"])
    return {"$schema": SARIF_SCHEMA, "version": "2.1.0", "runs": runs}


def main(argv: Optional[List[str]] = None, tools: Tuple[str, ...] = SOURCE_TOOLS,
         prog: str = "python -m foundationdb_tpu_torch.tools.lint") -> int:
    """The gate's CLI over the source tools `tools` (torchcheck joins with
    ``--all``)."""
    ap = argparse.ArgumentParser(
        prog=prog,
        description="The port's lint gate: " + " and ".join(tools)
                    + " (+ torchcheck with --all), one merged report.")
    ap.add_argument("root", nargs="?", default=None,
                    help="package dir to lint (default: foundationdb_tpu_torch)")
    ap.add_argument("--all", action="store_true",
                    help="also run torchcheck's rules (runs the registered programs)")
    ap.add_argument("--format", choices=("text", "json", "sarif"), default="text")
    ap.add_argument("--show-suppressed", action="store_true")
    ap.add_argument("--pragma-inventory", action="store_true",
                    help="print every suppression in every namespace as canonical "
                         "sorted JSON and exit 0")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every tool's rules and exit 0")
    args = ap.parse_args(argv)

    if args.list_rules:
        for tool in (*SOURCE_TOOLS, "torchcheck"):
            for rule, desc in rules_of(tool).items():
                print(f"{tool:<10} {rule}  {desc}")
        return 0
    root = args.root or _default_root()
    if args.pragma_inventory:
        print(json.dumps(pragma_inventory(root), indent=2))
        return 0

    by_tool = run_source_tools(root, tools)
    if args.all:
        from .torchir import run_torchcheck

        by_tool["torchcheck"] = run_torchcheck()
    all_findings = [f for fs in by_tool.values() for f in fs]
    unsuppressed = [f for f in all_findings if not f.suppressed]

    if args.format == "json":
        print(json.dumps({
            "tools": {
                tool: {
                    "findings": [f.to_dict() for f in fs
                                 if args.show_suppressed or not f.suppressed],
                    "total": len(fs),
                    "unsuppressed": sum(1 for f in fs if not f.suppressed),
                    "counts": count_by_rule(fs),
                }
                for tool, fs in sorted(by_tool.items())
            },
            "total": len(all_findings),
            "unsuppressed": len(unsuppressed),
        }, indent=2))
    elif args.format == "sarif":
        print(json.dumps(merged_sarif(by_tool, args.show_suppressed), indent=2))
    else:
        for tool in sorted(by_tool):
            for f in by_tool[tool]:
                if f.suppressed and not args.show_suppressed:
                    continue
                tag = f" (suppressed: {f.reason})" if f.suppressed else ""
                print(f"[{tool}] " + f.format() + tag)
        for line in format_tool_counts(by_tool):
            print(line, file=sys.stderr)
        print(f"lint: {len(unsuppressed)} finding(s), "
              f"{len(all_findings) - len(unsuppressed)} suppressed across "
              f"{len(by_tool)} tool(s)", file=sys.stderr)
    return 1 if unsuppressed else 0


if __name__ == "__main__":  # pragma: no cover - run with -m
    sys.exit(main())
