"""RPY001: dropped reply promises — the broken-promise hang class.

The port's own copy of the reference package's ``tools/lint/rpy.py``.
FoundationDB's ReplyPromise destructor sends broken_promise when a
handler drops a reply (fdbrpc.h:94-120); the port mirrors that in
``rpc/stream.py``'s ``Reply.__del__``, but a destructor backstop depends
on prompt refcount collection (cycles, PyPy, a held closure all defeat
it) and FoundationDB treats the pattern as a STATIC defect regardless.
This pass flags any control-flow path through a handler on which a
received reply is neither ``send()``/``send_error()``ed, handed off
(passed to a call — e.g. a spawned per-request actor — stored, returned,
or yielded), nor abandoned by a RAISE (an escaping error is the visible
path: the owning task dies and teardown breaks the promise loudly, which
ERR001 polices separately).

Reply acquisition points:
  * a function parameter named ``reply`` (the handler-callee idiom),
  * the second target of ``a, b = await <stream>.pop()`` (any names),
  * a local bound from a ``Reply(...)`` constructor call.

Conservative three-valued path walk: branches fork, ``try`` handlers are
entered with the state at try ENTRY (the body may fail before its send),
loop bodies may run zero times, an acquisition inside a loop body is
scoped to one iteration (the back edge rebinds a fresh reply, so falling
off the loop body with the reply unresolved IS the leak).  Mentioning the
reply anywhere outside a bare branch test counts as resolution/handoff —
the hang class this rule hunts is the path that forgets the reply
entirely (early return, swallowed exception)."""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .base import Finding, RPY_MODULE_GLOBS, _match_any

U, R = "U", "R"  # unresolved / resolved-or-handed-off


def _mentions(node: ast.AST, var: str) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id == var:
            return True
    return False


class _PathScan:
    """Per-variable path walk.  States are sets over {U, R}; a leak is any
    scope exit reachable with U."""

    def __init__(self, var: str):
        self.var = var
        self.leaks: List[Tuple[int, str]] = []  # (line, how)

    # -- statements --------------------------------------------------------
    def block(self, body: List[ast.stmt], states: Set[str]) -> Dict[str, Set[str]]:
        """Returns {"fall": .., "brk": .., "cont": ..} state sets."""
        out = {"brk": set(), "cont": set()}
        cur = set(states)
        for s in body:
            if not cur:
                break  # unreachable
            res = self.stmt(s, cur)
            out["brk"] |= res["brk"]
            out["cont"] |= res["cont"]
            cur = res["fall"]
        out["fall"] = cur
        return out

    def _resolve_in(self, node: Optional[ast.AST], states: Set[str]) -> Set[str]:
        if node is not None and _mentions(node, self.var):
            return {R} if states else set()
        return set(states)

    def stmt(self, s: ast.stmt, states: Set[str]) -> Dict[str, Set[str]]:
        t = type(s)
        none = {"fall": set(), "brk": set(), "cont": set()}
        if t is ast.Return:
            if s.value is not None and _mentions(s.value, self.var):
                return none
            if U in states:
                self.leaks.append((s.lineno, "return"))
            return none
        if t is ast.Raise:
            return none  # error escapes: visible path, teardown breaks it
        if t in (ast.Break,):
            return {"fall": set(), "brk": set(states), "cont": set()}
        if t in (ast.Continue,):
            return {"fall": set(), "brk": set(), "cont": set(states)}
        if t is ast.If:
            then = self.block(s.body, states)
            els = self.block(s.orelse, states)
            return {k: then[k] | els[k] for k in ("fall", "brk", "cont")}
        if t is ast.Match:
            # N-way branch over the case arms; the no-match fallthrough
            # path joins in unless some arm is irrefutable (bare `case _:`
            # / capture-name with no guard).  A mention in a pattern or
            # guard resolves like any other use.
            states = self._resolve_in(s.subject, states)
            out = {"fall": set(), "brk": set(), "cont": set()}
            irrefutable = False
            for case in s.cases:
                st = self._resolve_in(case.pattern, states)
                st = self._resolve_in(case.guard, st)
                if (case.guard is None
                        and isinstance(case.pattern, ast.MatchAs)
                        and case.pattern.pattern is None):
                    irrefutable = True
                res = self.block(case.body, st)
                for k in ("fall", "brk", "cont"):
                    out[k] |= res[k]
            if not irrefutable:
                out["fall"] |= set(states)
            return out
        if t in (ast.For, ast.AsyncFor):
            states = self._resolve_in(s.iter, states)
            body = self.block(s.body, states)
            # 0..n iterations: fall-through may skip the body entirely.
            fall = set(states) | body["fall"] | body["brk"] | body["cont"]
            els = self.block(s.orelse, fall)
            return {"fall": els["fall"], "brk": els["brk"], "cont": els["cont"]}
        if t is ast.While:
            infinite = (
                isinstance(s.test, ast.Constant) and bool(s.test.value)
            )
            # The loop test is a bare branch test, same as If's: a
            # mention there (`while reply.pending():`) inspects the
            # reply without resolving it.
            states = set(states)
            body = self.block(s.body, states)
            if infinite:
                # Only break exits; the back edge re-runs the body, which
                # the single pass already covered.
                fall = body["brk"]
            else:
                fall = set(states) | body["fall"] | body["brk"] | body["cont"]
            els = self.block(s.orelse, fall)
            return {"fall": els["fall"], "brk": els["brk"], "cont": els["cont"]}
        if t is ast.Try:
            body = self.block(s.body, states)
            merged = {k: set(v) for k, v in body.items()}
            for h in s.handlers:
                # The body may raise BEFORE its sends: pessimistic entry.
                hres = self.block(h.body, states)
                for k in ("fall", "brk", "cont"):
                    merged[k] |= hres[k]
            els = self.block(s.orelse, merged["fall"])
            merged["fall"] = els["fall"]
            merged["brk"] |= els["brk"]
            merged["cont"] |= els["cont"]
            if s.finalbody:
                fin_states = merged["fall"] | merged["brk"] | merged["cont"]
                fin = self.block(s.finalbody, fin_states or set(states))
                if fin["fall"] == {R} and fin_states:
                    # finally resolves on every path it covers
                    merged = {k: ({R} if v else set()) for k, v in merged.items()}
            return merged
        if t in (ast.With, ast.AsyncWith):
            for item in s.items:
                states = self._resolve_in(item.context_expr, states)
            return self.block(s.body, states)
        if t in (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef):
            # A nested def CAPTURING the var is a handoff (deferred send).
            if any(_mentions(n, self.var) for n in ast.walk(s)):
                return {"fall": {R} if states else set(), "brk": set(), "cont": set()}
            return {"fall": set(states), "brk": set(), "cont": set()}
        # Simple statements: Expr/Assign/AugAssign/Assert/Delete/...
        # Any mention outside a bare test resolves (send or handoff).
        if _mentions(s, self.var):
            return {"fall": {R} if states else set(), "brk": set(), "cont": set()}
        return {"fall": set(states), "brk": set(), "cont": set()}

    # -- walking FROM an acquisition nested inside compound statements -----
    def block_from(self, body: List[ast.stmt], acq: ast.stmt) -> Dict[str, Set[str]]:
        """States leaving `body` given the reply is acquired at `acq`
        somewhere inside it.  Statements before the acquiring one carry no
        reply (the empty state set); the one containing it is entered via
        stmt_from; the suffix is the ordinary walk."""
        idx = next((i for i, s in enumerate(body) if _contains(s, acq)), None)
        if idx is None:
            return {"fall": set(), "brk": set(), "cont": set()}
        first = (
            {"fall": {U}, "brk": set(), "cont": set()}
            if body[idx] is acq
            else self.stmt_from(body[idx], acq)
        )
        rest = self.block(body[idx + 1:], first["fall"])
        return {
            "fall": rest["fall"],
            "brk": first["brk"] | rest["brk"],
            "cont": first["cont"] | rest["cont"],
        }

    def stmt_from(self, s: ast.stmt, acq: ast.stmt) -> Dict[str, Set[str]]:
        t = type(s)
        if t is ast.If:
            arm = s.body if any(_contains(x, acq) for x in s.body) else s.orelse
            return self.block_from(arm, acq)
        if t is ast.Try:
            if any(_contains(x, acq) for x in s.body):
                bi = next(i for i, x in enumerate(s.body) if _contains(x, acq))
                merged = {
                    k: set(v) for k, v in self.block_from(s.body, acq).items()
                }
                # A raise AFTER the acquisition (anything running past the
                # acquiring statement can throw — the swallowed-except
                # leak) enters handlers holding the unresolved reply; a
                # bare pop as the try's LAST statement cannot fail after
                # binding, so its handlers never see one.
                post_acq = s.body[bi] is not acq or bi + 1 < len(s.body)
                for h in s.handlers:
                    hres = self.block(h.body, {U} if post_acq else set())
                    for k in ("fall", "brk", "cont"):
                        merged[k] |= hres[k]
                els = self.block(s.orelse, merged["fall"])
                merged["fall"] = els["fall"]
                merged["brk"] |= els["brk"]
                merged["cont"] |= els["cont"]
                if s.finalbody:
                    fin_states = merged["fall"] | merged["brk"] | merged["cont"]
                    fin = self.block(s.finalbody, fin_states)
                    if fin["fall"] == {R} and fin_states:
                        merged = {
                            k: ({R} if v else set()) for k, v in merged.items()
                        }
                return merged
            for region in ([h.body for h in s.handlers]
                           + [s.orelse, s.finalbody]):
                if any(_contains(x, acq) for x in region):
                    return self.block_from(region, acq)
            return {"fall": set(), "brk": set(), "cont": set()}
        if t in (ast.With, ast.AsyncWith):
            return self.block_from(s.body, acq)
        if t is ast.Match:
            for case in s.cases:
                if any(_contains(x, acq) for x in case.body):
                    return self.block_from(case.body, acq)
            return {"fall": set(), "brk": set(), "cont": set()}
        if t in (ast.For, ast.AsyncFor, ast.While):
            # Only reachable for an acquisition in the loop's ELSE block —
            # straight-line code that runs once after the loop completes
            # (a body acquisition re-scoped to the loop body upstream).
            if any(_contains(x, acq) for x in s.orelse):
                return self.block_from(s.orelse, acq)
            return {"fall": set(), "brk": set(), "cont": set()}
        # Anything else is opaque — carry nothing.
        return {"fall": set(), "brk": set(), "cont": set()}


def _is_pop_unpack(s: ast.stmt) -> Optional[str]:
    """Var name of the reply half of `a, b = await <x>.pop()`."""
    if (
        isinstance(s, ast.Assign)
        and len(s.targets) == 1
        and isinstance(s.targets[0], ast.Tuple)
        and len(s.targets[0].elts) == 2
        and all(isinstance(e, ast.Name) for e in s.targets[0].elts)
        and isinstance(s.value, ast.Await)
        and isinstance(s.value.value, ast.Call)
        and isinstance(s.value.value.func, ast.Attribute)
        and s.value.value.func.attr == "pop"
    ):
        return s.targets[0].elts[1].id
    return None


def _is_reply_ctor(s: ast.stmt) -> Optional[str]:
    if (
        isinstance(s, ast.Assign)
        and len(s.targets) == 1
        and isinstance(s.targets[0], ast.Name)
        and isinstance(s.value, ast.Call)
    ):
        f = s.value.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None
        )
        if name == "Reply":
            return s.targets[0].id
    return None


def _scan_acquisition(
    func, acq_stmt: Optional[ast.stmt], var: str
) -> List[Tuple[int, str]]:
    """Leaks for one acquisition.  acq_stmt None = parameter (whole body).
    An acquisition inside a loop body is scoped to ONE iteration: falling
    off the loop body (or `continue`) with U is a leak; `break` paths are
    checked against the code after the loop by the enclosing walk
    approximation (treated as an iteration exit here)."""
    scan = _PathScan(var)
    if acq_stmt is None:
        res = scan.block(func.body, {U})
        _leak_exits(scan, res, func)
        return scan.leaks

    # Find the innermost loop body (or the function body) containing the
    # acquisition, then walk FROM the acquisition — through the remainder
    # of its containing statement (a try's except arms, an if's sibling
    # suffix) and on through the scope's statement suffix.
    loop_node, scope = _innermost_scope(func, acq_stmt)
    res = scan.block_from(scope, acq_stmt)
    if loop_node is not None and U in res["brk"]:
        # A break carries the reply OUT of the loop: check the code after
        # the loop before calling it a leak (break-then-send shutdown is
        # legitimate).  For a loop nested inside another loop the walk
        # below goes silent (∅ states) — conservative toward no finding.
        after = _PathScan(var)
        ares = after.block_from(func.body, loop_node)
        scan.leaks.extend(after.leaks)
        if U in ares["fall"]:
            scan.leaks.append(
                (getattr(func, "end_lineno", func.lineno),
                 "falls off the end after break")
            )
        res = {**res, "brk": set()}
    _leak_exits(scan, res, func, loop_scoped=loop_node is not None,
                anchor=acq_stmt)
    return scan.leaks


def _leak_exits(scan, res, func, loop_scoped: bool = False, anchor=None):
    end_line = getattr(func, "end_lineno", func.lineno)
    if U in res["fall"]:
        scan.leaks.append(
            (end_line if not loop_scoped else (anchor or func).lineno,
             "next iteration rebinds" if loop_scoped else "falls off the end")
        )
    if loop_scoped and U in res["cont"]:
        scan.leaks.append(((anchor or func).lineno, "continue"))
    if loop_scoped and U in res["brk"]:
        scan.leaks.append(((anchor or func).lineno, "break"))


def _contains(node: ast.AST, target: ast.stmt) -> bool:
    return any(n is target for n in ast.walk(node))


def _innermost_scope(func, acq_stmt: ast.stmt):
    """(loop node, its body) for the innermost loop whose BODY contains
    acq_stmt, else (None, the function body).  Innermost = the last loop
    found descending (ast.walk is breadth-first)."""
    best_node = None
    best: List[ast.stmt] = func.body
    for node in ast.walk(func):
        if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
            if any(_contains(s, acq_stmt) for s in node.body):
                best_node, best = node, node.body
    return best_node, best


def run_rpy001(relpath: str, tree: ast.Module) -> List[Finding]:
    if not _match_any(relpath, RPY_MODULE_GLOBS):
        return []
    findings: List[Finding] = []

    def own_stmts(func):
        """Statements of func excluding nested function/class bodies."""
        stack: List[ast.AST] = list(func.body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(n, ast.stmt):
                yield n
            stack.extend(ast.iter_child_nodes(n))

    def scan_func(func):
        # Parameter named `reply`.
        params = [
            a.arg
            for a in (func.args.posonlyargs + func.args.args + func.args.kwonlyargs)
        ]
        acquisitions: List[Tuple[Optional[ast.stmt], str, int, int]] = []
        if "reply" in params:
            acquisitions.append((None, "reply", func.lineno, func.lineno))
        for node in own_stmts(func):
            v = _is_pop_unpack(node)
            if v is None:
                v = _is_reply_ctor(node)
            if v is not None:
                acquisitions.append(
                    (node, v, node.lineno,
                     getattr(node, "end_lineno", node.lineno))
                )
        for acq_stmt, var, line, end_line in acquisitions:
            leaks = _scan_acquisition(func, acq_stmt, var)
            if leaks:
                where = "; ".join(
                    f"line {ln} ({how})" for ln, how in sorted(set(leaks))[:4]
                )
                findings.append(Finding(
                    "RPY001", relpath, line, 0,
                    f"reply '{var}' in '{func.name}' can exit without "
                    f"send/send_error/handoff on: {where} — the caller "
                    f"hangs until teardown (broken-promise class)",
                    end_line=end_line,
                ))

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan_func(node)
    return findings
