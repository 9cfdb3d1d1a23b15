"""RACE rule family: atomicity violations & lost updates across awaits —
the write-write half of the actor compiler's state-across-wait rejection
(WAIT001/002 cover the read half).  While an actor is suspended every
other actor runs: a value read from shared ``self.*`` state before an
await and written back after it silently overwrites concurrent updates
(the canonical MVCC lost-update, reintroduced inside our own runtime),
and a guard checked before an await may no longer hold when the guarded
action finally executes.

  RACE001  read-modify-write spanning an await: the read feeding
           ``self.x = f(...)`` / ``self.d[k] += ...`` is separated from
           the write by a suspension — including interprocedurally, when
           the read or the write happens inside a resolvable helper
           method (the call graph's may-await summary per callee)
  RACE002  check-then-act: a guard on shared state, an await, then an
           action whose soundness depended on the guard (creation /
           registration / singleton shapes); re-checking the guard after
           the await clears it
  RACE003  torn invariant: two attrs co-written atomically everywhere
           else get split across an await on some path — other actors
           observe the half-updated pair
  RACE004  multi-writer attr: >= 2 distinct actor (async) functions
           write the same resolved (class, attr) and at least one write
           is await-separated from its read — writer sets resolved
           through the MRO/base machinery, voided by dynamic-attribute
           escapes (three-valued, under-approximate like PRM)

The port's own copy of the reference package's ``tools/lint/races.py``,
less ENV002, which polices a knob registry the port does not have.

Facts are collected per file into ModuleRaceFacts; intra-procedural
findings (RACE001-intra/002/003) land in the per-file findings, and the
linking pass (run_race_rules) resolves interprocedural RACE001 and
RACE004 writer sets through the CallGraph the other passes share.
Unresolvable calls contribute nothing — the pass under-approximates,
never guesses.  The dynamic twin is the state sanitizer
(flow/state_sanitizer.py, ``EventLoop(state_sanitizer=True)``) plus
scheduler perturbation (``EventLoop(sched_fuzz=n)``)."""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .base import Finding
from .graphs import CallGraph, ModuleSummary, _name_chain
from .waitrules import (
    MUTATOR_METHODS,
    _falls_through,
    _pragma_span_end,
    _self_attr,
    mutable_attrs,
)

# Wrapping shared state in one of these still snapshots the VALUE: writing
# a merge of the snapshot back after an await is the same lost update.
_SNAPSHOT_FUNCS = {"dict", "list", "set", "tuple", "sorted", "frozenset"}


# ---------------------------------------------------------------------------
# Per-file facts
# ---------------------------------------------------------------------------


@dataclass
class RaceFuncFacts:
    qualname: str                 # "Class.method" (graph-compatible)
    line: int
    is_async: bool
    cls: str
    reads: Tuple[str, ...] = ()   # self attrs read anywhere
    writes: Tuple[str, ...] = ()  # self attrs written (assign/del/mutator)
    returns_attrs: Tuple[str, ...] = ()   # self attrs a return expr exposes
    writes_after_await: Tuple[str, ...] = ()  # written at epoch > 0
    # (attr, line, end_line): write await-separated from the latest read of
    # the same attr in this function (RACE004 anchor sites)
    gap_sites: Tuple[Tuple[str, int, int], ...] = ()
    # (call_desc, attr, line, end_line): `v = [await] self.helper()` feeds a
    # later await-separated write of self.<attr> — fires iff the resolved
    # callee returns that attr (interprocedural RMW, read side)
    ipc_reads: Tuple[tuple, ...] = ()
    # (call_desc, attr, cap_line, line, end_line, caller_separated):
    # `v = self.<attr>` later handed to a helper call — fires iff the
    # resolved callee writes that attr and either the caller awaited in
    # between or the callee itself writes it after an await of its own
    ipc_writes: Tuple[tuple, ...] = ()


@dataclass
class ModuleRaceFacts:
    relpath: str
    funcs: Dict[str, RaceFuncFacts] = field(default_factory=dict)
    # Classes using setattr(self, <dynamic>)/self.__dict__/vars(self):
    # writer sets are unknowable, RACE004 stands down (three-valued).
    escaped_classes: Tuple[str, ...] = ()


# ---------------------------------------------------------------------------
# The epoch walker
# ---------------------------------------------------------------------------


class _Cap:
    """A local holding a value captured from self.<attr>."""
    __slots__ = ("attr", "epoch", "line")

    def __init__(self, attr: str, epoch: int, line: int):
        self.attr = attr
        self.epoch = epoch
        self.line = line


class _CallCap:
    """A local holding the result of a resolvable self-rooted helper call."""
    __slots__ = ("desc", "epoch", "line")

    def __init__(self, desc: tuple, epoch: int, line: int):
        self.desc = desc
        self.epoch = epoch
        self.line = line


def _join(arms):
    """Pessimistic join of (env, calls, reads, epoch) states, rebasing each
    entry so it keeps the widest await gap it had in any arm (the same
    discipline as waitrules._join_states — the racy path exists, so the
    join must not let a clean sibling arm mask it)."""
    epoch = max(a[3] for a in arms)
    env: Dict[str, _Cap] = {}
    calls: Dict[str, _CallCap] = {}
    reads: Dict[str, Tuple[int, int]] = {}
    for aenv, acalls, areads, aep in arms:
        for n, c in aenv.items():
            gap = aep - c.epoch
            prev = env.get(n)
            if prev is None or epoch - prev.epoch < gap:
                env[n] = _Cap(c.attr, epoch - gap, c.line)
        for n, c in acalls.items():
            gap = aep - c.epoch
            prev = calls.get(n)
            if prev is None or epoch - prev.epoch < gap:
                calls[n] = _CallCap(c.desc, epoch - gap, c.line)
        for a, (rep, rline) in areads.items():
            gap = aep - rep
            prev = reads.get(a)
            if prev is None or epoch - prev[0] < gap:
                reads[a] = (epoch - gap, rline)
    return env, calls, reads, epoch


class _RaceScope:
    """Walks one async method body in source order tracking await epochs,
    shared-state captures, the latest read epoch per attr, and guard
    frames; flags RACE001-intra/RACE002 and accumulates the facts the
    link pass needs.  Nested function/lambda bodies are opaque; nested
    ClassDefs are scopes of their own."""

    def __init__(self, relpath: str, cls_mutable: Set[str],
                 findings: List[Finding], func: RaceFuncFacts):
        self.relpath = relpath
        self.mutable = cls_mutable
        self.findings = findings
        self.func = func
        self.epoch = 0
        self.env: Dict[str, _Cap] = {}
        self.calls: Dict[str, _CallCap] = {}
        self.reads: Dict[str, Tuple[int, int]] = {}  # attr -> (epoch, line)
        self.guards: List[Dict[str, Tuple[int, int]]] = []  # attr -> (epoch, line)
        self.stmt_end = 0
        self.flagged: Set[Tuple[int, str]] = set()
        self.race_lines: Set[int] = set()  # RACE001/002-anchored lines
        # fact accumulators (sets: the two-pass loop walk revisits sites)
        self.f_reads: Set[str] = set()
        self.f_writes: Set[str] = set()
        self.f_returns: Set[str] = set()
        self.f_waw: Set[str] = set()
        self.f_gaps: Set[Tuple[str, int, int]] = set()
        self.f_ipc_reads: Set[tuple] = set()
        self.f_ipc_writes: Set[tuple] = set()
        # per-rhs scratch (valid only between _rhs_begin/_rhs_end)
        self._rhs_names: Set[str] = set()
        self._rhs_self: Dict[str, Tuple[int, int]] = {}
        self._rhs_on = False

    # -- state snapshots ---------------------------------------------------
    def _snap(self):
        return dict(self.env), dict(self.calls), dict(self.reads), self.epoch

    def _restore(self, st):
        self.env, self.calls, self.reads, self.epoch = (
            dict(st[0]), dict(st[1]), dict(st[2]), st[3]
        )

    def _join_into(self, arms):
        self.env, self.calls, self.reads, self.epoch = _join(arms)

    # -- flagging ----------------------------------------------------------
    def _flag(self, rule: str, node: ast.AST, msg: str):
        key = (node.lineno, rule)
        if key in self.flagged:
            return
        self.flagged.add(key)
        self.race_lines.add(node.lineno)
        self.findings.append(Finding(
            rule, self.relpath, node.lineno, node.col_offset, msg,
            end_line=max(self.stmt_end, getattr(node, "end_lineno", 0) or 0),
        ))

    # -- shared-state classification ---------------------------------------
    def _mut_attr(self, node: ast.AST) -> Optional[str]:
        a = _self_attr(node)
        return a if a is not None and a in self.mutable else None

    def _capture_of(self, value: ast.AST) -> Optional[Tuple[str, bool]]:
        """(attr, is_plain) when `value` captures self.<attr> state: the
        attr itself, an element, or a value snapshot (dict()/.copy())."""
        a = self._mut_attr(value)
        if a is not None:
            return (a, True)
        if isinstance(value, ast.Subscript):
            a = self._mut_attr(value.value)
            if a is not None:
                return (a, True)
        if isinstance(value, ast.Call):
            f = value.func
            if (isinstance(f, ast.Name) and f.id in _SNAPSHOT_FUNCS
                    and len(value.args) == 1):
                a = self._mut_attr(value.args[0])
                if a is not None:
                    return (a, False)
            if isinstance(f, ast.Attribute) and f.attr == "copy":
                a = self._mut_attr(f.value)
                if a is not None:
                    return (a, False)
        return None

    def _helper_desc(self, value: ast.AST) -> Optional[tuple]:
        """Call descriptor for `[await] self...helper(...)`."""
        if isinstance(value, ast.Await):
            value = value.value
        if not isinstance(value, ast.Call):
            return None
        chain = _name_chain(value.func)
        if chain is not None and len(chain) >= 2 and chain[0] in ("self", "cls"):
            return ("chain", chain)
        return None

    # -- the write event (all RACE001/002/004 anchors funnel here) ---------
    def _on_write(self, attr: str, node: ast.AST, rhs_names: Set[str],
                  rhs_self: Dict[str, Tuple[int, int]], pre_epoch: int,
                  kind: str = "assign"):
        """A write to self.<attr> just executed at self.epoch.  rhs_names /
        rhs_self describe what the written value was computed FROM (empty
        for mutator calls); pre_epoch is the epoch when an AugAssign read
        its own target (== self.epoch for plain writes).  kind is
        "assign" | "aug" | "mutator" | "del"."""
        self.f_writes.add(attr)
        if self.epoch > 0:
            self.f_waw.add(attr)
        end = max(self.stmt_end, getattr(node, "end_lineno", 0) or 0)
        # RACE001-intra: the value written was computed from a read of the
        # SAME attr on the other side of a suspension.
        fed_stale = None
        if pre_epoch < self.epoch:
            fed_stale = (node.lineno, pre_epoch)  # aug target read pre-await
        got = self._rhs_stale_read(attr, rhs_names, rhs_self)
        if got is not None and (fed_stale is None or got[1] < fed_stale[1]):
            fed_stale = got
        if fed_stale is not None:
            self._flag(
                "RACE001", node,
                f"read-modify-write of self.{attr} spans an await: the value "
                f"read at line {fed_stale[0]} feeds this write after a "
                f"suspension — concurrent updates by other actors are "
                f"silently overwritten (lost update); re-read after the "
                f"await or make the update atomic",
            )
        elif self._guard_hit(attr, node):
            pass  # RACE002 flagged by _guard_hit
        elif kind in ("assign", "del"):
            # RACE004 anchor: a value-replacing write (or removal)
            # await-separated from the latest read.  An atomic AugAssign
            # or mutator call reads-and-updates at ONE epoch — no window —
            # so earlier unrelated reads never make those gap sites.
            r = self.reads.get(attr)
            if r is not None and r[0] < self.epoch:
                self.f_gaps.add((attr, node.lineno, end))
        # Interprocedural read side: a helper-call result from before the
        # suspension feeds this write.
        for v in rhs_names:
            cc = self.calls.get(v)
            if cc is not None and cc.epoch < self.epoch:
                self.f_ipc_reads.add((cc.desc, attr, node.lineno, end))
        # The write refreshes this function's knowledge of the attr.
        self.reads.pop(attr, None)

    def _rhs_stale_read(self, attr: str, rhs_names: Set[str],
                        rhs_self: Dict[str, Tuple[int, int]]):
        best = None
        for v in rhs_names:
            cap = self.env.get(v)
            if cap is not None and cap.attr == attr and cap.epoch < self.epoch:
                if best is None or cap.line < best[0]:
                    best = (cap.line, cap.epoch)
        got = rhs_self.get(attr)
        if got is not None and got[0] < self.epoch:
            # direct `self.x = await f(self.x)` shape
            if best is None or got[0] < best[1]:
                best = (got[1], got[0])
        return best

    def _guard_hit(self, attr: str, node: ast.AST) -> bool:
        for frame in reversed(self.guards):
            g = frame.get(attr)
            if g is not None:
                if g[0] < self.epoch:
                    self._flag(
                        "RACE002", node,
                        f"check-then-act on self.{attr}: the guard at line "
                        f"{g[1]} was evaluated before an await — other "
                        f"actors ran during the suspension and the guarded "
                        f"condition may no longer hold; re-check self."
                        f"{attr} after the await",
                    )
                    return True
                return False  # innermost guard is fresh: sanctioned
        return False

    # -- expression walk ---------------------------------------------------
    def expr(self, node: ast.AST):
        if node is None:
            return
        t = type(node)
        if t is ast.Name:
            if isinstance(node.ctx, ast.Load) and self._rhs_on:
                self._rhs_names.add(node.id)
            return
        if t is ast.Await:
            self.expr(node.value)
            self.epoch += 1
            return
        if t is ast.NamedExpr:
            self.expr(node.value)
            self._bind(node.target, node.value, node.lineno)
            return
        if t is ast.Attribute:
            a = self._mut_attr(node)
            if a is not None and isinstance(node.ctx, ast.Load):
                self.f_reads.add(a)
                self.reads[a] = (self.epoch, node.lineno)
                if self._rhs_on and a not in self._rhs_self:
                    self._rhs_self[a] = (self.epoch, node.lineno)
                return
            self.expr(node.value)
            return
        if t is ast.Call:
            f = node.func
            # Mutator method on shared state = a write event.
            if isinstance(f, ast.Attribute) and f.attr in MUTATOR_METHODS:
                a = self._mut_attr(f.value)
                if a is not None:
                    for arg in node.args:
                        self.expr(arg)
                    for kw in node.keywords:
                        self.expr(kw.value)
                    self._on_write(a, node, set(), {}, self.epoch,
                                   kind="mutator")
                    return
            self.expr(f)
            # Interprocedural write side: a pre-await capture handed to a
            # resolvable helper that may write the attr it came from.
            desc = self._helper_desc(node)
            for arg in node.args:
                if desc is not None and isinstance(arg, ast.Name):
                    cap = self.env.get(arg.id)
                    if cap is not None:
                        end = max(self.stmt_end,
                                  getattr(node, "end_lineno", 0) or 0)
                        self.f_ipc_writes.add((
                            desc, cap.attr, cap.line, node.lineno, end,
                            cap.epoch < self.epoch,
                        ))
                self.expr(arg)
            for kw in node.keywords:
                self.expr(kw.value)
            return
        if t in (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef):
            return  # opaque deferred scope
        for child in ast.iter_child_nodes(node):
            self.expr(child)

    def _walk_rhs(self, value: ast.AST) -> Tuple[Set[str], Dict[str, Tuple[int, int]]]:
        """Walk a value expression collecting the names and self-attr loads
        that feed it (awaits inside bump the epoch as usual)."""
        self._rhs_names, self._rhs_self, self._rhs_on = set(), {}, True
        self.expr(value)
        self._rhs_on = False
        return self._rhs_names, self._rhs_self

    # -- binding/kill ------------------------------------------------------
    def _kill(self, t: ast.AST):
        if isinstance(t, ast.Name):
            self.env.pop(t.id, None)
            self.calls.pop(t.id, None)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._kill(e)
        elif isinstance(t, ast.Starred):
            self._kill(t.value)

    def _bind(self, target: ast.AST, value: ast.AST, line: int):
        if isinstance(target, (ast.Tuple, ast.List)):
            if (isinstance(value, (ast.Tuple, ast.List))
                    and len(target.elts) == len(value.elts)
                    and not any(isinstance(e, ast.Starred)
                                for e in list(target.elts) + list(value.elts))):
                for te, ve in zip(target.elts, value.elts):
                    self._bind(te, ve, line)
                return
            self._kill(target)
            return
        if not isinstance(target, ast.Name):
            return
        self._kill(target)
        got = self._capture_of(value)
        if got is not None:
            self.env[target.id] = _Cap(got[0], self.epoch, line)
            return
        desc = self._helper_desc(value)
        if desc is not None:
            self.calls[target.id] = _CallCap(desc, self.epoch, line)

    # -- guard frames ------------------------------------------------------
    def _test_attrs(self, test: ast.AST) -> Dict[str, Tuple[int, int]]:
        out: Dict[str, Tuple[int, int]] = {}
        for n in ast.walk(test):
            if isinstance(n, (ast.Lambda, ast.FunctionDef,
                              ast.AsyncFunctionDef)):
                continue
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load):
                a = self._mut_attr(n)
                if a is not None:
                    out[a] = (self.epoch, test.lineno)
        return out

    def _refresh_guards(self, attrs: Dict[str, Tuple[int, int]]):
        """A nested re-check of a guarded attr refreshes the outer guard:
        the re-check's truth is what now sanctions the action."""
        for frame in self.guards:
            for a in attrs:
                if a in frame:
                    frame[a] = attrs[a]

    # -- statement walk ----------------------------------------------------
    def stmts(self, body: List[ast.stmt]):
        for s in body:
            self.stmt(s)

    def _write_targets(self, target: ast.AST) -> List[str]:
        out = []
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                out += self._write_targets(e)
            return out
        a = _self_attr(target)
        if a is not None and a in self.mutable:
            out.append(a)
        elif isinstance(target, ast.Subscript):
            a = self._mut_attr(target.value)
            if a is not None:
                out.append(a)
        return out

    def stmt(self, s: ast.stmt):
        self.stmt_end = _pragma_span_end(s)
        t = type(s)
        if t is ast.Assign:
            names, selfs = self._walk_rhs(s.value)
            for target in s.targets:
                for attr in self._write_targets(target):
                    self._on_write(attr, s, names, selfs, self.epoch)
                self._bind(target, s.value, s.lineno)
        elif t is ast.AnnAssign:
            if s.value is not None:
                names, selfs = self._walk_rhs(s.value)
                for attr in self._write_targets(s.target):
                    self._on_write(attr, s, names, selfs, self.epoch)
                self._bind(s.target, s.value, s.lineno)
        elif t is ast.AugAssign:
            pre = self.epoch
            attrs = self._write_targets(s.target)
            for a in attrs:
                self.f_reads.add(a)
            names, selfs = self._walk_rhs(s.value)
            for attr in attrs:
                self._on_write(attr, s, names, selfs, pre, kind="aug")
            if isinstance(s.target, ast.Name):
                self._kill(s.target)
        elif t is ast.Return:
            if s.value is not None:
                for n in ast.walk(s.value):
                    if isinstance(n, ast.Attribute) and isinstance(
                            n.ctx, ast.Load):
                        a = _self_attr(n)
                        if a is not None:
                            self.f_returns.add(a)
                self.expr(s.value)
        elif t is ast.Expr:
            self.expr(s.value)
        elif t is ast.Delete:
            for target in s.targets:
                for attr in self._write_targets(target):
                    self._on_write(attr, s, set(), {}, self.epoch, kind="del")
                self._kill(target)
        elif t is ast.If:
            guard = self._test_attrs(s.test)
            self.expr(s.test)
            self._refresh_guards(guard)
            self.guards.append(dict(guard))
            saved = self._snap()
            self.stmts(s.body)
            then_falls = _falls_through(s.body)
            after_then = self._snap()
            self._restore(saved)
            self.stmts(s.orelse)
            self.guards.pop()
            else_falls = _falls_through(s.orelse)
            if then_falls and else_falls:
                self._join_into([after_then, self._snap()])
            elif then_falls:
                self._restore(after_then)
        elif t in (ast.For, ast.AsyncFor):
            self.expr(s.iter)
            if t is ast.AsyncFor:
                self.epoch += 1
            pre = self._snap()
            self._kill(s.target)
            for _ in range(2):  # back-edge staleness needs a second pass
                self.stmts(s.body)
                self._kill(s.target)
            self._join_into([pre, self._snap()])
            self.stmts(s.orelse)
        elif t is ast.While:
            guard = self._test_attrs(s.test)
            self.expr(s.test)
            self._refresh_guards(guard)
            self.guards.append(dict(guard))
            infinite = isinstance(s.test, ast.Constant) and bool(s.test.value)
            pre = self._snap()
            for _ in range(2):
                self.stmts(s.body)
                self.stmt_end = _pragma_span_end(s)
                g2 = self._test_attrs(s.test)
                self.expr(s.test)
                self._refresh_guards(g2)
            self.guards.pop()
            if not infinite:
                self._join_into([pre, self._snap()])
            self.stmts(s.orelse)
        elif t is ast.Try:
            # The body may raise at ANY statement boundary — in particular
            # after an await — so handlers walk from the join of every
            # boundary state (same discipline as waitrules).
            states = [self._snap()]
            for st in s.body:
                self.stmt(st)
                states.append(self._snap())
            after = self._snap()
            joined = _join(states)
            exits = []
            for h in s.handlers:
                self._restore(joined)
                if h.name is not None:
                    self.env.pop(h.name, None)
                    self.calls.pop(h.name, None)
                self.stmts(h.body)
                if _falls_through(h.body):
                    exits.append(self._snap())
            self._restore(after)
            self.stmts(s.orelse)
            if _falls_through(s.body) and _falls_through(s.orelse):
                exits.append(self._snap())
            if exits:
                self._join_into(exits)
            self.stmts(s.finalbody)
        elif t in (ast.With, ast.AsyncWith):
            for item in s.items:
                self.expr(item.context_expr)
                if item.optional_vars is not None:
                    self._kill(item.optional_vars)
            if t is ast.AsyncWith:
                self.epoch += 1
            self.stmts(s.body)
        elif t is ast.Match:
            self.expr(s.subject)
            saved = self._snap()
            exits = []
            irrefutable = False
            for case in s.cases:
                self._restore(saved)
                for p in ast.walk(case.pattern):
                    nm = getattr(p, "name", None) or getattr(p, "rest", None)
                    if isinstance(nm, str):
                        self.env.pop(nm, None)
                        self.calls.pop(nm, None)
                if case.guard is not None:
                    self.expr(case.guard)
                if (case.guard is None
                        and isinstance(case.pattern, ast.MatchAs)
                        and case.pattern.pattern is None):
                    irrefutable = True
                self.stmts(case.body)
                if _falls_through(case.body):
                    exits.append(self._snap())
            if not irrefutable:
                exits.append(saved)
            if exits:
                self._join_into(exits)
        elif t in (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef):
            return  # nested scopes analyzed separately / opaque
        else:
            for child in ast.iter_child_nodes(s):
                if isinstance(child, ast.expr):
                    self.expr(child)
                elif isinstance(child, ast.stmt):
                    self.stmt(child)

    def finish(self):
        f = self.func
        f.reads = tuple(sorted(self.f_reads))
        f.writes = tuple(sorted(self.f_writes))
        f.returns_attrs = tuple(sorted(self.f_returns))
        f.writes_after_await = tuple(sorted(self.f_waw))
        f.gap_sites = tuple(sorted(
            g for g in self.f_gaps if g[1] not in self.race_lines
        ))
        f.ipc_reads = tuple(sorted(self.f_ipc_reads))
        f.ipc_writes = tuple(sorted(self.f_ipc_writes))


# ---------------------------------------------------------------------------
# Sync-method light facts (no findings: sync methods run atomically under
# the cooperative loop, but they serve as read/write helpers and RACE003
# co-write evidence)
# ---------------------------------------------------------------------------


def _sync_facts(node: ast.AST, func: RaceFuncFacts, mutable: Set[str]):
    reads: Set[str] = set()
    writes: Set[str] = set()
    returns: Set[str] = set()
    stack: List[ast.AST] = list(node.body)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                          ast.ClassDef)):
            continue
        if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for tgt in targets:
                a = _self_attr(tgt)
                if a is None and isinstance(tgt, ast.Subscript):
                    a = _self_attr(tgt.value)
                if a is not None:
                    writes.add(a)
        elif isinstance(n, ast.Delete):
            for tgt in n.targets:
                a = _self_attr(tgt)
                if a is None and isinstance(tgt, ast.Subscript):
                    a = _self_attr(tgt.value)
                if a is not None:
                    writes.add(a)
        elif isinstance(n, ast.Call):
            if (isinstance(n.func, ast.Attribute)
                    and n.func.attr in MUTATOR_METHODS):
                a = _self_attr(n.func.value)
                if a is not None:
                    writes.add(a)
        elif isinstance(n, ast.Return) and n.value is not None:
            for m in ast.walk(n.value):
                if isinstance(m, ast.Attribute) and isinstance(
                        m.ctx, ast.Load):
                    a = _self_attr(m)
                    if a is not None:
                        returns.add(a)
        elif isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load):
            a = _self_attr(n)
            if a is not None:
                reads.add(a)
        stack.extend(ast.iter_child_nodes(n))
    func.reads = tuple(sorted(reads))
    func.writes = tuple(sorted(writes))
    func.returns_attrs = tuple(sorted(returns))


def _class_escapes(cls: ast.ClassDef) -> bool:
    for n in ast.walk(cls):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
            if (n.func.id == "setattr" and n.args
                    and isinstance(n.args[0], ast.Name)
                    and n.args[0].id == "self"
                    and len(n.args) >= 2
                    and not isinstance(n.args[1], ast.Constant)):
                return True
            if (n.func.id == "vars" and n.args
                    and isinstance(n.args[0], ast.Name)
                    and n.args[0].id == "self"):
                return True
        if (isinstance(n, ast.Attribute) and n.attr == "__dict__"
                and isinstance(n.value, ast.Name)
                and n.value.id == "self"):
            return True
    return False


# ---------------------------------------------------------------------------
# RACE003: torn invariants, aggregated per class at collect time
# ---------------------------------------------------------------------------


def _race003(relpath: str, cls_name: str,
             sites_by_func: Dict[str, List[Tuple[str, int, int, int]]],
             findings: List[Finding]):
    """sites_by_func: func -> [(attr, epoch, line, end_line)] assign-level
    write sites.  For each attr pair, a function that splits the pair
    across an await is flagged only when it is the SOLE splitter and >= 2
    other functions co-write the pair atomically (the 'always co-written
    elsewhere' bar, strictly — under-approximate)."""
    pair_gap: Dict[str, Dict[Tuple[str, str], Tuple[int, int, int]]] = {}
    for fn, sites in sites_by_func.items():
        by_attr: Dict[str, List[Tuple[int, int, int]]] = {}
        for attr, epoch, line, end in sites:
            by_attr.setdefault(attr, []).append((epoch, line, end))
        attrs = sorted(by_attr)
        out: Dict[Tuple[str, str], Tuple[int, int, int]] = {}
        for i, a in enumerate(attrs):
            for b in attrs[i + 1:]:
                best = None
                for ea, la, ena in by_attr[a]:
                    for eb, lb, enb in by_attr[b]:
                        gap = abs(ea - eb)
                        # anchor at the LATER write (the second half of the
                        # torn pair — that's where the window closes)
                        anchor = (la, ena) if (ea, la) >= (eb, lb) else (lb, enb)
                        cand = (gap, anchor[0], anchor[1])
                        if best is None or cand[0] < best[0]:
                            best = cand
                out[(a, b)] = best
        pair_gap[fn] = out
    all_pairs: Set[Tuple[str, str]] = set()
    for out in pair_gap.values():
        all_pairs |= set(out)
    for pair in sorted(all_pairs):
        splitters = [(fn, pair_gap[fn][pair]) for fn in sorted(pair_gap)
                     if pair in pair_gap[fn] and pair_gap[fn][pair][0] > 0]
        cowriters = [fn for fn in sorted(pair_gap)
                     if pair in pair_gap[fn] and pair_gap[fn][pair][0] == 0]
        if len(splitters) == 1 and len(cowriters) >= 2:
            fn, (_gap, line, end) = splitters[0]
            findings.append(Finding(
                "RACE003", relpath, line, 0,
                f"torn invariant in {cls_name}.{fn}: self.{pair[0]} and "
                f"self.{pair[1]} are co-written atomically in "
                f"{len(cowriters)} other methods ({', '.join(cowriters)}) "
                f"but split across an await here — other actors observe "
                f"the half-updated pair during the suspension",
                end_line=end,
            ))


# ---------------------------------------------------------------------------
# Collect pass (per file)
# ---------------------------------------------------------------------------


def collect_race(relpath: str, tree: ast.Module):
    """(intra-procedural findings, ModuleRaceFacts) for one module."""
    findings: List[Finding] = []
    facts = ModuleRaceFacts(relpath=relpath)

    # -- per-class walks ---------------------------------------------------
    def own_defs(cls: ast.ClassDef):
        stack: List[ast.AST] = list(cls.body)
        while stack:
            n = stack.pop()
            if isinstance(n, ast.ClassDef):
                continue
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield n
            stack.extend(ast.iter_child_nodes(n))

    top_level = {n for n in tree.body if isinstance(n, ast.ClassDef)}
    escaped: List[str] = []
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        mut = mutable_attrs(cls)
        sites_by_func: Dict[str, List[Tuple[str, int, int, int]]] = {}
        for node in own_defs(cls):
            if node.name == "__init__":
                continue
            ff = RaceFuncFacts(
                qualname=f"{cls.name}.{node.name}", line=node.lineno,
                is_async=isinstance(node, ast.AsyncFunctionDef),
                cls=cls.name,
            )
            if ff.is_async:
                scope = _RaceScope(relpath, mut, findings, ff)
                scope.stmts(node.body)
                scope.finish()
                # assign-level write sites for RACE003 (with their epochs)
                sites: List[Tuple[str, int, int, int]] = []
                _collect_assign_sites(node, mut, sites)
                # re-anchor epochs from a dedicated cheap pass
                sites_by_func[node.name] = sites
            else:
                _sync_facts(node, ff, mut)
                sites = []
                _collect_assign_sites(node, mut, sites)
                sites_by_func[node.name] = sites
            if cls in top_level:
                facts.funcs[ff.qualname] = ff
        _race003(relpath, cls.name, sites_by_func, findings)
        if cls in top_level and _class_escapes(cls):
            escaped.append(cls.name)
    facts.escaped_classes = tuple(sorted(escaped))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, facts


def _collect_assign_sites(node: ast.AST, mutable: Set[str],
                          out: List[Tuple[str, int, int, int]]):
    """Linear await-epoch scan for RACE003: assign/augassign writes to
    mutable self attrs with the count of awaits textually before them.
    Source order approximates program order well enough for a gap=0 /
    gap>0 split (branches re-joining are handled by the strict sole-
    splitter bar in _race003)."""
    epoch = 0
    events: List[Tuple[int, str, int, int]] = []  # (lineno, attr, end, epoch)
    def walk(n: ast.AST):
        nonlocal epoch
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                          ast.ClassDef)):
            return
        if isinstance(n, ast.Await):
            walk(n.value)
            epoch += 1
            return
        if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for child in ast.iter_child_nodes(n):
                if child not in targets:
                    walk(child)
            for tgt in targets:
                a = _self_attr(tgt)
                if a is None and isinstance(tgt, ast.Subscript):
                    a = _self_attr(tgt.value)
                if a is not None and a in mutable:
                    end = getattr(n, "end_lineno", n.lineno) or n.lineno
                    events.append((n.lineno, a, end, epoch))
            return
        if isinstance(n, (ast.AsyncFor, ast.AsyncWith)):
            epoch += 1
        for child in ast.iter_child_nodes(n):
            walk(child)
    for child in ast.iter_child_nodes(node):
        walk(child)
    for lineno, attr, end, ep in events:
        out.append((attr, ep, lineno, end))


# ---------------------------------------------------------------------------
# Link pass: interprocedural RACE001, RACE004
# ---------------------------------------------------------------------------


class _Components:
    """Union-find over (relpath, class) linked by resolved base-class
    edges, so `(class, attr)` unifies across an inheritance chain."""

    def __init__(self):
        self.parent: Dict[Tuple[str, str], Tuple[str, str]] = {}

    def find(self, x):
        self.parent.setdefault(x, x)
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def run_race_rules(
    summaries: Dict[str, ModuleSummary],
    race_facts: Dict[str, ModuleRaceFacts],
    graph: Optional[CallGraph] = None,
) -> List[Finding]:
    """The linking half: resolves helper calls through the shared
    CallGraph for interprocedural RACE001, and aggregates writer sets
    across the MRO for RACE004."""
    graph = graph or CallGraph(summaries)
    findings: List[Finding] = []

    def callee_facts(node) -> Optional[RaceFuncFacts]:
        if node is None:
            return None
        mf = race_facts.get(node[0])
        return mf.funcs.get(node[1]) if mf is not None else None

    # -- interprocedural RACE001 ------------------------------------------
    for relpath in sorted(race_facts):
        ms = summaries.get(relpath)
        if ms is None:
            continue
        for qual, ff in sorted(race_facts[relpath].funcs.items()):
            for desc, attr, line, end in ff.ipc_reads:
                cf = callee_facts(graph.resolve_call(ms, qual, desc))
                if cf is not None and attr in cf.returns_attrs:
                    findings.append(Finding(
                        "RACE001", relpath, line, 0,
                        f"read-modify-write of self.{attr} spans an await "
                        f"(interprocedural): the value comes from "
                        f"{cf.cls}.{cf.qualname.split('.')[-1]}() — which "
                        f"reads self.{attr} — on the other side of a "
                        f"suspension; concurrent updates are overwritten "
                        f"(lost update)",
                        end_line=end,
                    ))
            for desc, attr, cap_line, line, end, sep in ff.ipc_writes:
                cf = callee_facts(graph.resolve_call(ms, qual, desc))
                if cf is None or attr not in cf.writes:
                    continue
                if sep or attr in cf.writes_after_await:
                    where = (
                        "the caller awaited between the read and this call"
                        if sep else
                        f"the helper writes self.{attr} after an await of "
                        f"its own"
                    )
                    findings.append(Finding(
                        "RACE001", relpath, line, 0,
                        f"read-modify-write of self.{attr} spans an await "
                        f"(interprocedural): the value captured at line "
                        f"{cap_line} is written back by "
                        f"{cf.cls}.{cf.qualname.split('.')[-1]}() and "
                        f"{where} — concurrent updates are overwritten "
                        f"(lost update)",
                        end_line=end,
                    ))

    # -- RACE004: multi-writer attrs --------------------------------------
    comp = _Components()
    for relpath, ms in summaries.items():
        for cname, cs in ms.classes.items():
            comp.find((relpath, cname))
            for base in cs.bases:
                got = graph._resolve_class_chain(ms, base)
                if got is not None:
                    comp.union((relpath, cname), (got[0].relpath, got[1]))
    escaped_roots = set()
    for relpath, mf in race_facts.items():
        for cname in mf.escaped_classes:
            escaped_roots.add(comp.find((relpath, cname)))
    # root -> attr -> writers: [(relpath, qualname)], gaps: [(relpath, attr, line, end)]
    writers: Dict[tuple, Dict[str, List[Tuple[str, str]]]] = {}
    gaps: Dict[tuple, Dict[str, List[Tuple[str, int, int]]]] = {}
    for relpath in sorted(race_facts):
        for qual, ff in sorted(race_facts[relpath].funcs.items()):
            if not ff.is_async:
                continue
            root = comp.find((relpath, ff.cls))
            for attr in ff.writes:
                writers.setdefault(root, {}).setdefault(attr, []).append(
                    (relpath, qual))
            for attr, line, end in ff.gap_sites:
                gaps.setdefault(root, {}).setdefault(attr, []).append(
                    (relpath, line, end))
    for root in sorted(writers):
        if root in escaped_roots:
            continue
        for attr in sorted(writers[root]):
            ws = writers[root][attr]
            if len(ws) < 2:
                continue
            sites = gaps.get(root, {}).get(attr)
            if not sites:
                continue
            relpath, line, end = min(sites, key=lambda s: (s[0], s[1]))
            others = sorted({q for rp, q in ws})
            findings.append(Finding(
                "RACE004", relpath, line, 0,
                f"multi-writer attr self.{attr} ({root[1]}): "
                f"{len(ws)} actor functions write it "
                f"({', '.join(others)}) and this write is await-separated "
                f"from its read — interleavings can interleave "
                f"read/write pairs (lost update window); funnel writes "
                f"through one owner or re-read after the await",
                end_line=end,
            ))

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
