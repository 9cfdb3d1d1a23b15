"""Shared lint infrastructure of the port's static checks: the fdblint
rule registry, findings, pragmas, the per-rule allowlist and name
resolution.

The port's own copy of the reference package's ``tools/lint/base.py``,
cut to what fdblint's families that apply to the port (``local.py``,
``det101.py``, ``waitrules.py``, ``rpy.py``, ``promises.py``,
``races.py``), perfcheck (``hotpath.py``) and their call graph
(``graphs.py``) read; torchcheck (``torchir.py``) reports its findings
and polices its pragmas with the same code.
"""

from __future__ import annotations

import ast
import fnmatch
import io
import re
import tokenize
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

# ---------------------------------------------------------------------------
# fdblint's rule registry
# ---------------------------------------------------------------------------

# The families of the reference's fdblint that apply to the port: all but
# JAX001, which polices traced code the port does not have, and ENV002,
# which polices a knob registry it does not have.
RULES: Dict[str, str] = {
    "DET001": "wall-clock read in simulator-executed code (take the caller's clock, or metrics.wall_now() for the wall namespace)",
    "DET002": "global entropy source (use a seeded DeterministicRandom, flow/rng.py)",
    "DET003": "threading/asyncio/multiprocessing primitive in simulator-executed code",
    "DET101": "function reachable from sim-executed code transitively hits wall clock/entropy",
    "ACT001": "actor coroutine called but neither awaited nor spawned (dropped future)",
    "IO001": "direct open()/socket outside the port's operational programs (tools/)",
    "TRC001": "TraceEvent constructed but never .log()ed nor used as a context manager (dropped event)",
    "SPN001": "begin_span() result neither context-managed, .end()ed, nor stored (leaked open span)",
    "ERR001": "broad except that neither re-raises, TraceEvents, nor propagates the error (silent swallow)",
    "WAIT001": "shared state captured before an await and dereferenced after it without re-read",
    "WAIT002": "iteration over shared mutable state whose loop body awaits (reference across wait)",
    "RPY001": "reply promise path that neither sends, errors, nor hands the reply off (broken-promise hang)",
    "PRM001": "future awaited where no reachable code can send to its paired promise (orphaned wait / static hang)",
    "PRM002": "promise abandoned on some path without send/send_error/close (dropped promise, interprocedural)",
    "PRM003": "wait-cycle in the actor wait-graph with no external sender (static deadlock)",
    "PRM004": "consumer loop over a stream whose producers can all terminate without closing it",
    "TSK001": "spawned Task dropped while its coroutine can raise with neither handler nor TraceEvent",
    "ENV001": "any FDB_TPU_* environment read: the port has no flags",
    "RACE001": "read-modify-write of shared state spanning an await (lost update)",
    "RACE002": "check-then-act: guard on shared state evaluated before an await that the guarded action outlives",
    "RACE003": "two attrs co-written atomically elsewhere split across an await (torn invariant)",
    "RACE004": "attr written by >=2 actor functions with >=1 write await-separated from its read (multi-writer race)",
    "PRG001": "fdblint ignore pragma carries no reason string",
    "PRG002": "fdblint ignore pragma suppresses nothing (stale)",
}

# Canonical dotted names that read the wall clock.  Referencing one as a
# value (``clock = time.monotonic``) is flagged like calling it: binding
# the function is how wall time gets smuggled past a call-site check.
WALL_CLOCK = {
    "time.time", "time.time_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.process_time", "time.process_time_ns",
    "time.sleep",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}

# Entropy: exact names plus whole-module prefixes.
ENTROPY_EXACT = {"os.urandom", "uuid.uuid1", "uuid.uuid4"}
ENTROPY_MODULES = {"random", "secrets"}


def classify_clock_ref(path: str) -> Optional[str]:
    """'wall' / 'entropy' / None for a canonical dotted path: the one
    classifier behind both DET001/DET002's direct sites (local.py) and
    DET101's taint sources (graphs.py), so the two cannot drift."""
    if path in WALL_CLOCK:
        return "wall"
    if path in ENTROPY_EXACT or path.split(".")[0] in ENTROPY_MODULES:
        return "entropy"
    return None


class ClockRefVisitorMixin:
    """visit_Attribute/visit_Name for wall-clock and entropy references
    whose chain is rooted at an import binding.  Subclasses provide
    ``self.aliases`` (an Aliases) and ``_on_clock_ref(node, path, kind)``;
    mix in BEFORE ast.NodeVisitor."""

    def visit_Attribute(self, node: ast.Attribute):
        path = self.aliases.resolve(node)
        if path is not None:
            # Pure Name/Attribute chain: check it once, don't recurse
            # (recursing would re-report each prefix of a.b.c).
            if self.aliases.root_bound(node):
                kind = classify_clock_ref(path)
                if kind is not None:
                    self._on_clock_ref(node, path, kind)
        else:
            # The chain holds calls or subscripts: keep walking to them.
            self.generic_visit(node)

    def visit_Name(self, node: ast.Name):
        # A bare name bound by `from time import monotonic` style imports.
        path = self.aliases.resolve(node)
        if path is not None and path != node.id and self.aliases.root_bound(node):
            kind = classify_clock_ref(path)
            if kind is not None:
                self._on_clock_ref(node, path, kind)


THREADING_MODULES = {
    "threading", "_thread", "asyncio", "multiprocessing", "concurrent.futures",
}

IO_CALLS = {"open", "os.open", "os.fdopen", "io.open"}
IO_MODULES = {"socket", "ssl"}

ENV_FLAG_PREFIX = "FDB_TPU_"

# Modules where RPY001 applies: the RequestStream-serving layers.
RPY_MODULE_GLOBS = ("server/*.py", "rpc/*.py")

# Per-rule allowlist: package-relative globs of modules where the rule does
# not apply.  tools/ holds the port's operational programs (the CLI, the
# linters), which never run under a simulator: exempt where the
# reference exempts its own tools/.  fileio/blobstore.py is the port's one
# real-mode backend (a threaded blocking-socket client and server on the
# wall clock): exempt where the reference exempts it, and nowhere else;
# so is flow/profiler.py, whose sampling thread is the reference's SIGPROF
# analog.  The reference's other real-mode modules are not ported.
_REAL_MODE_MODULES = ("fileio/blobstore.py", "flow/profiler.py", "tools/*.py")

DEFAULT_ALLOW: Dict[str, Tuple[str, ...]] = {
    "DET001": ("tools/*.py",),
    "DET003": _REAL_MODE_MODULES,
    # DET101 roots only in simulator-executed modules; the exempt modules
    # still CARRY taint into any caller outside them.
    "DET101": _REAL_MODE_MODULES,
    "ERR001": ("tools/*.py",),
    # tools/cli.py's trace-export writes a file; the blob store's sockets.
    "IO001": ("fileio/blobstore.py", "tools/*.py"),
    # The actor families police cooperative actors under the simulator;
    # the blob store's OS threads hand work across locks, not awaits.
    "WAIT001": ("tools/*.py",),
    "WAIT002": ("tools/*.py",),
    "PRM001": _REAL_MODE_MODULES,
    "PRM002": _REAL_MODE_MODULES,
    "PRM003": _REAL_MODE_MODULES,
    "PRM004": _REAL_MODE_MODULES,
    "TSK001": _REAL_MODE_MODULES,
    "RACE001": _REAL_MODE_MODULES,
    "RACE002": _REAL_MODE_MODULES,
    "RACE003": _REAL_MODE_MODULES,
    "RACE004": _REAL_MODE_MODULES,
}

# The linter's own modules are never on the hot path nor simulator-
# executed: the one module exemption, for every rule.
SKIP_MODULE_GLOBS = ("tools/fdblint.py", "tools/lint/*.py")


def _match_any(relpath: str, globs) -> bool:
    """Glob match against the relpath or any of its trailing sub-paths, so
    'conflict/keys.py' matches whether the scan root was the package dir or
    an ancestor of it."""
    parts = relpath.split("/")
    tails = ["/".join(parts[i:]) for i in range(len(parts))]
    return any(fnmatch.fnmatch(t, g) for t in tails for g in globs)


def allows(rule: str, relpath: str) -> bool:
    """Whether DEFAULT_ALLOW exempts `relpath` from fdblint's `rule`."""
    return _match_any(relpath, DEFAULT_ALLOW.get(rule, ()))


@dataclass
class Finding:
    rule: str
    path: str          # package-relative posix path
    line: int
    col: int
    message: str
    suppressed: bool = False
    reason: str = ""   # pragma reason when suppressed
    end_line: int = 0  # last physical line of the flagged node (pragma scope)
    entry: str = ""    # torchcheck: the registered program, which has no column

    def format(self) -> str:
        if self.entry:
            return f"{self.path}:{self.line}: {self.rule} [{self.entry}] {self.message}"
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        where = {"entry": self.entry} if self.entry else {"col": self.col}
        return {
            "rule": self.rule, "path": self.path, "line": self.line, **where,
            "message": self.message, "suppressed": self.suppressed,
            "reason": self.reason,
        }


# ---------------------------------------------------------------------------
# Pragmas
# ---------------------------------------------------------------------------

# One pragma grammar, one namespace a tool (`# fdblint: ignore[...]`,
# `# perfcheck: ignore[...]`, `# torchcheck: ignore[...]`), so that no tool
# polices another's pragmas.
_PRAGMA_RES: Dict[str, "re.Pattern"] = {}


def _pragma_re(tool: str) -> "re.Pattern":
    pat = _PRAGMA_RES.get(tool)
    if pat is None:
        pat = re.compile(
            r"#\s*" + re.escape(tool)
            + r":\s*ignore\[(?P<rules>[A-Z0-9,\s]+)\](?:\s*:\s*(?P<reason>.*\S))?"
        )
        _PRAGMA_RES[tool] = pat
    return pat


@dataclass
class Pragma:
    line: int
    rules: Set[str]
    reason: str
    used: bool = False


def parse_pragmas(source: str, tool: str) -> Dict[int, Pragma]:
    """Pragmas from REAL comment tokens only: a pragma example quoted in a
    docstring or string literal must not register (it would then be
    reported as stale PRG002 with no way to appease it)."""
    pat = _pragma_re(tool)
    pragmas: Dict[int, Pragma] = {}
    for tok in tokenize.generate_tokens(io.StringIO(source).readline):
        if tok.type != tokenize.COMMENT:
            continue
        m = pat.search(tok.string)
        if not m:
            continue
        line = tok.start[0]
        rules = {r.strip() for r in m.group("rules").split(",") if r.strip()}
        pragmas[line] = Pragma(line, rules, (m.group("reason") or "").strip())
    return pragmas


def pragma_sanctions(
    pragmas: Dict[int, Pragma], line: int, rules: Tuple[str, ...]
) -> bool:
    """True when `line` carries a pragma for any of `rules`: DET101 treats
    a reasoned suppression of a source as a sanctioned boundary (the
    reason asserts the site is fine, so its callers are fine too)."""
    p = pragmas.get(line)
    return p is not None and bool(p.rules & set(rules))


def apply_pragmas(
    findings: List[Finding], pragmas: Dict[int, Pragma], relpath: str,
    rules: Dict[str, str],
) -> List[Finding]:
    """Mark findings suppressed by same-line (or same-statement-span)
    pragmas, then police the pragmas themselves: PRG001 (no reason) and
    PRG002 (suppresses nothing / unknown rule) are never suppressible.
    Runs ONCE per file over all of its findings.  `rules` is the tool's
    rule universe, which the unknown-rule check validates against."""
    known = set(rules)
    out: List[Finding] = []
    for f in findings:
        # A pragma anywhere on the flagged statement's physical lines
        # suppresses it (a multi-line expression puts the node's lineno on
        # a different line than the trailing comment).
        for ln in range(f.line, max(f.end_line, f.line) + 1):
            p = pragmas.get(ln)
            if p is not None and f.rule in p.rules:
                p.used = True
                f.suppressed = True
                f.reason = p.reason
                break
        out.append(f)
    for p in pragmas.values():
        unknown = p.rules - known
        if unknown:
            out.append(Finding(
                "PRG002", relpath, p.line, 0,
                f"pragma names unknown rule(s) {sorted(unknown)}",
            ))
        if not p.reason:
            out.append(Finding(
                "PRG001", relpath, p.line, 0,
                "ignore pragma carries no reason (append ': why')",
            ))
        if not p.used and not unknown:
            out.append(Finding(
                "PRG002", relpath, p.line, 0,
                f"pragma for {sorted(p.rules)} suppresses nothing here",
            ))
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


# ---------------------------------------------------------------------------
# Symbol resolution: map names/attribute chains to canonical dotted paths
# ---------------------------------------------------------------------------


class Aliases:
    """Tracks import bindings so ``tc.synchronize`` resolves to
    ``torch.cuda.synchronize`` regardless of aliasing.  Function-local
    imports are folded into the same table."""

    def __init__(self):
        self.map: Dict[str, str] = {}

    def add_import(self, node: ast.Import):
        for a in node.names:
            self.map[a.asname or a.name.split(".")[0]] = (
                a.name if a.asname else a.name.split(".")[0]
            )

    def add_import_from(self, node: ast.ImportFrom):
        if node.module is None or node.level:
            return  # relative import: package-internal
        for a in node.names:
            if a.name == "*":
                continue
            self.map[a.asname or a.name] = f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted canonical path for a Name/Attribute chain, or None."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.map.get(node.id, node.id)
        return ".".join([root] + list(reversed(parts)))

    def root_bound(self, node: ast.AST) -> bool:
        """True iff the chain's root name is an import binding (a local
        that merely shares a module's name is not one)."""
        while isinstance(node, ast.Attribute):
            node = node.value
        return isinstance(node, ast.Name) and node.id in self.map


# Simple (non-compound) statements: the unit of pragma suppression scope —
# a pragma on any physical line of one covers it, and a def/if body must
# never become one giant suppression region.
SIMPLE_STMTS = (
    ast.Assign, ast.AnnAssign, ast.AugAssign, ast.Expr, ast.Return,
    ast.Import, ast.ImportFrom, ast.Raise, ast.Assert, ast.Delete,
    ast.Global, ast.Nonlocal,
)


def innermost_simple_stmt_end(
    node: ast.AST, stmt_spans: List[Tuple[int, int]]
) -> int:
    """End line of the innermost simple statement containing `node`, or
    the node's own span outside any (decorators, if/while tests)."""
    end = getattr(node, "end_lineno", None) or node.lineno
    best = None
    for s, e in stmt_spans:
        if s <= node.lineno <= e:
            if best is None or s > best[0] or (s == best[0] and e < best[1]):
                best = (s, e)
    return max(end, best[1]) if best is not None else end


def attr_chain(node: ast.AST) -> Optional[List[str]]:
    """['self', 'x', 'y'] for a pure Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    parts.reverse()
    return parts
