"""WAIT001/WAIT002: state held across ``await`` — the Python form of the
actor compiler's "state variable holding a reference across wait()"
rejection (flow/actorcompiler/ActorCompiler.cs).

The port's own copy of the reference package's ``tools/lint/waitrules.py``.

While an actor is suspended at an ``await``, every other actor runs: a
local captured from ``self.*`` shared state before the suspension may be
stale (the attribute was reassigned) or silently mutating (the container
changed) when control returns, and a live iterator over shared state is
the exact analog of the invalidated-iterator class FoundationDB rejects
at compile time.

WAIT001  a local bound from mutable shared state (``self.X`` attribute
         chain, ``self.X[k]`` element, or a live view/iterator
         ``self.X.items()`` / ``iter(self.X)`` / ``enumerate(self.X)``)
         before an ``await`` and DEREFERENCED after it without a re-read.
         Live views flag on ANY post-await use; plain captures flag only
         on deref uses (attribute/subscript/call/iteration/membership) —
         using a captured value as a value is a legitimate snapshot.
WAIT002  ``for ... in <shared state>`` whose loop body awaits: the
         container is reachable by every actor that runs during the
         suspension, so the iteration can skip/double entries or raise
         "changed size during iteration" only under the exact interleaving
         a seed may never hit.

Both rules fire only on attributes with MUTATION EVIDENCE: some method of
the class (outside ``__init__``) reassigns, deletes, subscript-assigns, or
calls a known mutator on the attribute.  Config-immutable attributes
(assigned only at construction) are snapshots by definition and never
flag.  Re-reading after the await (rebinding the local) kills the capture;
wrapping in ``list()``/``sorted()``/``.copy()`` is a deliberate snapshot
and never flags."""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .base import Finding, SIMPLE_STMTS, attr_chain

VIEW_METHODS = {"items", "keys", "values"}
VIEW_FUNCS = {"iter", "enumerate", "reversed"}
SNAPSHOT_FUNCS = {"list", "tuple", "set", "dict", "sorted", "frozenset",
                  "sum", "len", "min", "max", "any", "all"}
MUTATOR_METHODS = {
    "append", "extend", "insert", "pop", "popitem", "remove", "discard",
    "add", "update", "clear", "setdefault",
}


def _pragma_span_end(s: ast.stmt) -> int:
    """End line of the statement's pragma-suppression scope: the full
    span for a simple statement (a pragma on any physical line of a
    multiline call covers it), but only the HEADER expression for a
    compound one — a pragma deep inside an if/while/for body must never
    suppress a finding on the header (base.SIMPLE_STMTS discipline)."""
    if isinstance(s, SIMPLE_STMTS):
        return getattr(s, "end_lineno", s.lineno) or s.lineno
    if isinstance(s, (ast.If, ast.While)):
        n: ast.AST = s.test
    elif isinstance(s, (ast.For, ast.AsyncFor)):
        n = s.iter
    elif isinstance(s, (ast.With, ast.AsyncWith)):
        n = s.items[-1].optional_vars or s.items[-1].context_expr
    elif isinstance(s, ast.Match):
        n = s.subject
    else:
        return s.lineno
    return getattr(n, "end_lineno", s.lineno) or s.lineno


def _self_attr(node: ast.AST) -> Optional[str]:
    """First attribute name of a pure self/cls-rooted chain, else None."""
    chain = attr_chain(node)
    if chain and len(chain) >= 2 and chain[0] in ("self", "cls"):
        return chain[1]
    return None


def mutable_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attrs with mutation evidence outside __init__."""
    out: Set[str] = set()
    for m in cls.body:
        if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if m.name == "__init__":
            continue
        for node in ast.walk(m):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    a = _self_attr(t)
                    if a is not None:
                        out.add(a)
                    elif isinstance(t, ast.Subscript):
                        a = _self_attr(t.value)
                        if a is not None:
                            out.add(a)
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    a = _self_attr(t)
                    if a is not None:
                        out.add(a)
                    elif isinstance(t, ast.Subscript):
                        a = _self_attr(t.value)
                        if a is not None:
                            out.add(a)
            elif isinstance(node, ast.Call):
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in MUTATOR_METHODS
                ):
                    a = _self_attr(node.func.value)
                    if a is not None:
                        out.add(a)
    return out


class _Capture:
    __slots__ = ("kind", "attr", "epoch", "line", "expr")

    def __init__(self, kind: str, attr: str, epoch: int, line: int, expr: str):
        self.kind = kind      # "view" | "attr"
        self.attr = attr      # the self.<attr> root
        self.epoch = epoch    # await count at binding
        self.line = line
        self.expr = expr      # source-ish description for the message


def _join_states(
    arms: List[Tuple[Dict[str, _Capture], int]],
) -> Tuple[Dict[str, _Capture], int]:
    """Pessimistic join of (env, epoch) control-flow states.  Staleness is
    the GAP epoch - capture.epoch, so a capture's gap must be judged
    against its OWN arm's epoch, never a sibling's: the joined epoch is
    the max over arms, and each surviving capture is rebased so it keeps
    exactly the widest gap it had in any arm that holds it."""
    epoch = max(e for _, e in arms)
    merged: Dict[str, _Capture] = {}
    for env, arm_epoch in arms:
        for name, cap in env.items():
            gap = arm_epoch - cap.epoch
            prev = merged.get(name)
            if prev is None or epoch - prev.epoch < gap:
                merged[name] = _Capture(
                    cap.kind, cap.attr, epoch - gap, cap.line, cap.expr
                )
    return merged, epoch


class _AsyncScope:
    """Walks one async function body in source order, tracking captures,
    await epochs, and flagging stale uses.  Nested function/lambda bodies
    are OPAQUE (a closure deliberately defers evaluation; flagging its
    uses would punish every callback), but nested async defs are analyzed
    as scopes of their own by the caller."""

    def __init__(self, relpath: str, cls_mutable: Set[str],
                 findings: List[Finding], func_name: str):
        self.relpath = relpath
        self.mutable = cls_mutable
        self.findings = findings
        self.func_name = func_name
        self.epoch = 0
        self.env: Dict[str, _Capture] = {}
        self.flagged: Set[Tuple[int, str]] = set()
        self.stmt_end = 0  # end line of current simple statement (pragma scope)

    # -- capture classification -------------------------------------------
    def _shared_chain_attr(self, node: ast.AST) -> Optional[str]:
        """self.X... chain (len>=2) whose X has mutation evidence."""
        a = _self_attr(node)
        if a is not None and a in self.mutable:
            return a
        return None

    def classify(self, value: ast.AST) -> Optional[Tuple[str, str, str]]:
        """(kind, attr, describe) when `value` captures shared state."""
        a = self._shared_chain_attr(value)
        if a is not None:
            return ("attr", a, f"self.{a}")
        if isinstance(value, ast.Subscript):
            a = self._shared_chain_attr(value.value)
            if a is not None:
                return ("attr", a, f"self.{a}[...]")
        if isinstance(value, ast.Call):
            f = value.func
            if isinstance(f, ast.Attribute) and f.attr in VIEW_METHODS:
                a = self._shared_chain_attr(f.value)
                if a is not None:
                    return ("view", a, f"self.{a}.{f.attr}()")
            if (
                isinstance(f, ast.Name)
                and f.id in VIEW_FUNCS
                and value.args
            ):
                inner = value.args[0]
                a = self._shared_chain_attr(inner)
                if a is None and isinstance(inner, ast.Call):
                    g = inner.func
                    if isinstance(g, ast.Attribute) and g.attr in VIEW_METHODS:
                        a = self._shared_chain_attr(g.value)
                if a is not None:
                    return ("view", a, f"{f.id}(self.{a}...)")
        if isinstance(value, ast.GeneratorExp):
            for gen in value.generators:
                a = self._shared_chain_attr(gen.iter)
                if a is not None:
                    return ("view", a, f"(... for ... in self.{a})")
        return None

    # -- flagging ----------------------------------------------------------
    def _flag(self, rule: str, node: ast.AST, msg: str):
        key = (node.lineno, msg)
        if key in self.flagged:
            return
        self.flagged.add(key)
        self.findings.append(Finding(
            rule, self.relpath, node.lineno, node.col_offset, msg,
            end_line=max(self.stmt_end, getattr(node, "end_lineno", 0) or 0),
        ))

    def _use(self, node: ast.Name, deref: bool):
        cap = self.env.get(node.id)
        if cap is None or self.epoch <= cap.epoch:
            return
        if cap.kind == "view" or deref:
            what = "live view" if cap.kind == "view" else "shared-state capture"
            self._flag(
                "WAIT001", node,
                f"'{node.id}' ({what} of {cap.expr}, bound at line "
                f"{cap.line}) used after an await without re-read — other "
                f"actors ran during the suspension (state-across-wait)",
            )

    # -- expression walk ---------------------------------------------------
    def expr(self, node: ast.AST, deref: bool = False):
        if node is None:
            return
        t = type(node)
        if t is ast.Name:
            if isinstance(node.ctx, ast.Load):
                self._use(node, deref)
            return
        if t is ast.Await:
            self.expr(node.value)
            self.epoch += 1
            return
        if t is ast.NamedExpr:
            # `(snap := self.d)` captures exactly like `snap = self.d`.
            self.expr(node.value)
            self._bind(node.target, node.value, node.lineno)
            return
        if t is ast.Attribute:
            self.expr(node.value, deref=isinstance(node.value, ast.Name))
            return
        if t is ast.Subscript:
            self.expr(node.value, deref=isinstance(node.value, ast.Name))
            self.expr(node.slice)
            return
        if t is ast.Call:
            self.expr(node.func, deref=isinstance(node.func, ast.Name))
            for a in node.args:
                self.expr(a, deref=isinstance(a, ast.Starred))
            for kw in node.keywords:
                self.expr(kw.value)
            return
        if t is ast.Compare:
            self.expr(node.left)
            for op, cmp in zip(node.ops, node.comparators):
                self.expr(cmp, deref=isinstance(op, (ast.In, ast.NotIn)))
            return
        if t in (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef):
            return  # opaque deferred scope
        if t in (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp):
            # Immediate iteration (genexps are captures, handled at
            # classification): the ITER expressions are deref uses.
            for gen in node.generators:
                self.expr(gen.iter, deref=isinstance(gen.iter, ast.Name))
                for cond in gen.ifs:
                    self.expr(cond)
            if t is ast.DictComp:
                self.expr(node.key)
                self.expr(node.value)
            elif t is not ast.GeneratorExp:
                self.expr(node.elt)
            return
        for child in ast.iter_child_nodes(node):
            self.expr(child)

    # -- binding/kill ------------------------------------------------------
    def _kill_target(self, t: ast.AST):
        if isinstance(t, ast.Name):
            self.env.pop(t.id, None)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._kill_target(e)
        elif isinstance(t, ast.Starred):
            self._kill_target(t.value)

    def _bind(self, target: ast.AST, value: ast.AST, line: int):
        if isinstance(target, (ast.Tuple, ast.List)):
            # `snap, other = self.d, 1` binds element-wise — each name
            # gets its own RHS, the same capture as the two-line
            # spelling.  Starred or length-mismatched unpacks fall back
            # to killing every target name.
            if (
                isinstance(value, (ast.Tuple, ast.List))
                and len(target.elts) == len(value.elts)
                and not any(isinstance(e, ast.Starred)
                            for e in list(target.elts) + list(value.elts))
            ):
                for te, ve in zip(target.elts, value.elts):
                    self._bind(te, ve, line)
                return
            self._kill_target(target)
            return
        if not isinstance(target, ast.Name):
            self._kill_target(target)
            return
        got = self.classify(value)
        if got is not None:
            kind, attr, desc = got
            self.env[target.id] = _Capture(kind, attr, self.epoch, line, desc)
        else:
            self.env.pop(target.id, None)

    # -- statement walk ----------------------------------------------------
    def stmts(self, body: List[ast.stmt]):
        for s in body:
            self.stmt(s)

    def stmt(self, s: ast.stmt):
        self.stmt_end = _pragma_span_end(s)
        t = type(s)
        if t is ast.Assign:
            self.expr(s.value)
            for target in s.targets:
                self._bind(target, s.value, s.lineno)
                # Deref via subscript/attribute STORE on a tracked name.
                if isinstance(target, (ast.Subscript, ast.Attribute)):
                    self.expr(target.value,
                              deref=isinstance(target.value, ast.Name))
        elif t is ast.AnnAssign:
            if s.value is not None:
                self.expr(s.value)
                self._bind(s.target, s.value, s.lineno)
        elif t is ast.AugAssign:
            self.expr(s.value)
            if isinstance(s.target, ast.Name):
                self._use(s.target, deref=False)
                self.env.pop(s.target.id, None)
            else:
                self.expr(s.target.value,
                          deref=isinstance(s.target.value, ast.Name))
        elif t in (ast.Expr, ast.Return):
            self.expr(s.value)
        elif t is ast.Delete:
            for target in s.targets:
                self._kill_target(target)
        elif t is ast.If:
            self.expr(s.test)
            saved = dict(self.env)
            epoch0 = self.epoch
            self.stmts(s.body)
            then_falls = _falls_through(s.body)
            after_then, epoch_then = self.env, self.epoch
            self.env = dict(saved)
            self.epoch = epoch0
            self.stmts(s.orelse)
            # Pessimistic join over the branches that can REACH the code
            # after the If: each branch walks with its own epoch (an
            # await-free path never inherits its sibling's suspension, and
            # a re-read inside the awaiting branch really clears it), and
            # a branch ending in return/raise/break/continue drops out of
            # the join entirely.
            else_falls = _falls_through(s.orelse)
            if then_falls and else_falls:
                self.env, self.epoch = _join_states(
                    [(after_then, epoch_then), (self.env, self.epoch)]
                )
            elif then_falls:
                self.env, self.epoch = after_then, epoch_then
            # else: only the else branch reaches past (or neither — then
            # the code after is unreachable and any state is fine).
        elif t in (ast.For, ast.AsyncFor):
            self.check_wait002(s)
            self.expr(s.iter, deref=isinstance(s.iter, ast.Name))
            if t is ast.AsyncFor:
                self.epoch += 1
            pre = (dict(self.env), self.epoch)  # zero-iteration path
            self._kill_target(s.target)
            # Two passes: the second sees captures made in iteration N used
            # in iteration N+1 after a loop-tail await (back-edge stale).
            for _ in range(2):
                self.stmts(s.body)
                self._kill_target(s.target)
            # The body may run ZERO times: a re-read inside it must not
            # clear a pre-loop capture on the loop-skipped path.
            self.env, self.epoch = _join_states([pre, (self.env, self.epoch)])
            self.stmts(s.orelse)
        elif t is ast.While:
            self.expr(s.test)
            infinite = isinstance(s.test, ast.Constant) and bool(s.test.value)
            pre = (dict(self.env), self.epoch)
            for _ in range(2):
                self.stmts(s.body)
                # The test re-evaluates after every iteration: a deref in
                # it sees any await the body just performed.  The body
                # walk moved stmt_end — restore the header's scope so the
                # finding's pragma span stays on the header.
                self.stmt_end = _pragma_span_end(s)
                self.expr(s.test)
            if not infinite:
                # Zero-iteration join, as for For; `while True:` always
                # enters, so only the body's exit state applies.
                self.env, self.epoch = _join_states(
                    [pre, (self.env, self.epoch)]
                )
            self.stmts(s.orelse)
        elif t is ast.Try:
            # Pessimistic handler entry: the body may raise at ANY of its
            # statement boundaries — in particular after an await but
            # before a later re-read — so each handler walks from the join
            # of every boundary state (a capture keeps the widest await
            # gap it had at any point the exception could have fired).
            states = [(dict(self.env), self.epoch)]
            for st in s.body:
                self.stmt(st)
                states.append((dict(self.env), self.epoch))
            after_env, after_epoch = self.env, self.epoch
            h_env, h_epoch = _join_states(states)
            exits: List[Tuple[Dict[str, _Capture], int]] = []
            for h in s.handlers:
                self.env = dict(h_env)
                self.epoch = h_epoch
                if h.name is not None:
                    # `except E as name:` rebinds name to the fresh
                    # exception — it is no longer the pre-await capture.
                    self.env.pop(h.name, None)
                self.stmts(h.body)
                if _falls_through(h.body):
                    exits.append((self.env, self.epoch))
            # orelse runs only when the body completed: walk it from the
            # body's end state.  Code AFTER the try is then reached from
            # that path (if it falls through) or any falling-through
            # handler — a handler that swallowed the raise-at-await
            # carries its possibly-stale captures past the try.
            self.env, self.epoch = after_env, after_epoch
            self.stmts(s.orelse)
            if _falls_through(s.body) and _falls_through(s.orelse):
                exits.append((self.env, self.epoch))
            if exits:
                self.env, self.epoch = _join_states(exits)
            self.stmts(s.finalbody)
        elif t in (ast.With, ast.AsyncWith):
            for item in s.items:
                self.expr(item.context_expr)
                if item.optional_vars is not None:
                    self._kill_target(item.optional_vars)
            if t is ast.AsyncWith:
                self.epoch += 1
            self.stmts(s.body)
        elif t is ast.Match:
            # N-way branch, same pessimistic join as If: each case walks
            # from the pre-match state, and the no-match fallthrough path
            # joins in unless some arm is irrefutable (a bare `case _:` /
            # capture-name case with no guard always matches).
            self.expr(s.subject, deref=isinstance(s.subject, ast.Name))
            saved = (dict(self.env), self.epoch)
            exits: List[Tuple[Dict[str, _Capture], int]] = []
            irrefutable = False
            for case in s.cases:
                self.env, self.epoch = dict(saved[0]), saved[1]
                for p in ast.walk(case.pattern):
                    if isinstance(p, ast.MatchValue):
                        self.expr(p.value)
                    nm = getattr(p, "name", None) or getattr(p, "rest", None)
                    if isinstance(nm, str):
                        self.env.pop(nm, None)  # pattern binds the name
                if case.guard is not None:
                    self.expr(case.guard)
                if (case.guard is None
                        and isinstance(case.pattern, ast.MatchAs)
                        and case.pattern.pattern is None):
                    irrefutable = True
                self.stmts(case.body)
                if _falls_through(case.body):
                    exits.append((self.env, self.epoch))
            if not irrefutable:
                exits.append(saved)
            if exits:
                self.env, self.epoch = _join_states(exits)
        elif t in (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef):
            return  # nested scopes analyzed separately / opaque
        else:
            for child in ast.iter_child_nodes(s):
                if isinstance(child, ast.expr):
                    self.expr(child)
                elif isinstance(child, ast.stmt):
                    self.stmt(child)

    # -- WAIT002 -----------------------------------------------------------
    def _iter_is_shared(self, it: ast.AST) -> Optional[str]:
        a = self._shared_chain_attr(it)
        if a is not None:
            return f"self.{a}"
        if isinstance(it, ast.Call):
            f = it.func
            if isinstance(f, ast.Name):
                if f.id in SNAPSHOT_FUNCS:
                    return None  # deliberate snapshot
                if f.id in VIEW_FUNCS and it.args:
                    inner = self._iter_is_shared(it.args[0])
                    return inner
                return None
            if isinstance(f, ast.Attribute):
                if f.attr == "copy":
                    return None
                if f.attr in VIEW_METHODS:
                    a = self._shared_chain_attr(f.value)
                    if a is not None:
                        return f"self.{a}.{f.attr}()"
                return None
        if isinstance(it, ast.Name):
            # A local ALIAS of shared state is still the live container —
            # one rebinding must not hide the invalidated-iterator class
            # (plain captures and views alike; snapshots never enter env).
            cap = self.env.get(it.id)
            if cap is not None:
                return cap.expr
        return None

    def check_wait002(self, s):
        desc = self._iter_is_shared(s.iter)
        if desc is None:
            return
        if isinstance(s, ast.AsyncFor):
            pass  # the header itself suspends at every __anext__
        elif not _body_awaits(s.body):
            return
        self._flag(
            "WAIT002", s,
            f"iterating {desc} while the loop body awaits — the container "
            f"is reachable by other actors during the suspension "
            f"(reference-across-wait); snapshot with list(...) first",
        )


def _falls_through(body: List[ast.stmt]) -> bool:
    """Can control run past these statements?  A trailing
    return/raise/break/continue means no (nested all-paths-return shapes
    are treated as falling through — conservative merge, never a miss)."""
    return not body or not isinstance(
        body[-1], (ast.Return, ast.Raise, ast.Break, ast.Continue)
    )


def _body_awaits(body: List[ast.stmt]) -> bool:
    """Await anywhere in these statements, excluding nested defs/lambdas."""
    stack: List[ast.AST] = list(body)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.Await, ast.AsyncFor, ast.AsyncWith)):
            return True
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))
    return False


def run_wait_rules(relpath: str, tree: ast.Module) -> List[Finding]:
    findings: List[Finding] = []

    def own_async_defs(cls: ast.ClassDef):
        """Async defs belonging to THIS class (methods and closures nested
        inside them), stopping at nested ClassDef boundaries — a nested
        class is its own shared-state scope with its own mutation
        evidence, scanned by the outer walk."""
        stack: List[ast.AST] = list(cls.body)
        while stack:
            n = stack.pop()
            if isinstance(n, ast.ClassDef):
                continue
            if isinstance(n, ast.AsyncFunctionDef):
                yield n
            stack.extend(ast.iter_child_nodes(n))

    def scan_class(cls: ast.ClassDef):
        mut = mutable_attrs(cls)
        for node in own_async_defs(cls):
            scope = _AsyncScope(relpath, mut, findings, node.name)
            scope.stmts(node.body)

    # EVERY class — module-level, factory-local, nested — is a scope.
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            scan_class(node)
    return findings
