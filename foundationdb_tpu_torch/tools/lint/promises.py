"""PRM/TSK rule family: interprocedural promise-lifecycle & wait-graph
analysis — the static hang-check FoundationDB gets from Promise
destructor semantics (flow/flow.h: destroying a Promise sends
broken_promise to every waiter; flow/error.py reserves the code).

The port's own copy of the reference package's ``tools/lint/promises.py``.
The port's Promise (flow/future.py) has no destructor backstop, so an orphaned future
or a dropped promise is a SILENT park: the waiter never wakes, no error
flows, nothing times out in virtual time.  These rules make that a
static class, the way RPY001 did for reply params:

  PRM001  orphaned wait — a future awaited where no code anywhere in the
          project can send to its paired promise (the static hang)
  PRM002  dropped promise — a control-flow path that abandons a held
          promise without send/send_error/close (RPY001 generalized from
          reply params to all promises, incl. handoff into a callee that
          can drop it)
  PRM003  wait-cycle — SCCs in the actor wait-graph (A awaits a future
          whose only senders live in B, and conversely) with no external
          sender: the static deadlock class
  PRM004  producerless stream loop — a consumer loop over a PromiseStream
          every producer of which can terminate without closing it (the
          pipeline idle-flush/drain shape)
  TSK001  unobserved spawned task — a spawn whose Task is dropped and
          whose coroutine can raise with neither a handler nor a
          TraceEvent (ACT001's mirror at the Task layer: FdbErrors in a
          dropped Task vanish — EventLoop only surfaces non-FdbError
          crashes)

Facts are collected per file into ModulePromiseFacts; the linking pass
resolves cross-file sender/waiter sets through the call graph the other
passes share (runner.py), so a send added or removed in a PRODUCER file
clears or raises a consumer-side finding.

Everything is three-valued and deliberately conservative: an entity that
ESCAPES tracking (aliased, stored into a container, passed into an
unresolvable call, reached into past its public surface) is assumed to
have senders — the pass under-approximates, never guesses.  What it
cannot see statically is cross-validated by the dynamic loop-teardown
twin in flow/sim_validation.py (expect_no_orphaned_waits)."""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .base import Finding, innermost_simple_stmt_end
from .graphs import CallGraph, ModuleSummary, _name_chain, in_nodes
from .rpy import _scan_acquisition

# Constructor names that create a tracked write-side entity: the port's
# flow/future.py Promise and PromiseStream.
PROMISE_CTORS = {"Promise": "promise", "PromiseStream": "stream"}
# Ops on the write side: Promise/PromiseStream.send and send_error,
# rpc/stream.py's Reply.send/send_error and RequestStream.close; "pop" is
# the stream read side (PromiseStream.pop, RequestStream.pop).
SEND_OPS = ("send", "send_error", "close")
# Reads of an entity that can never conjure a sender (inspection and the
# read-side handles: Promise.future and is_set, PromiseStream.future_stream,
# is_ready and pop) — these do NOT void tracking.
HARMLESS_ATTRS = {"future", "future_stream", "is_set", "is_ready", "pop"}

Node = Tuple[str, str]    # (relpath, qualname)
Entity = Tuple[str, str, str]  # (relpath, class, attr)


# ---------------------------------------------------------------------------
# Per-file facts
# ---------------------------------------------------------------------------


@dataclass
class FuncFacts:
    qualname: str
    line: int
    is_async: bool
    params: Tuple[str, ...] = ()
    # var -> (kind, line, end_line) for `v = Promise()` / `v = PromiseStream()`
    local_creations: Dict[str, Tuple[str, int, int]] = field(default_factory=dict)
    # (attr, kind, line) for `self.attr = Promise()`
    attr_creations: List[Tuple[str, str, int]] = field(default_factory=list)
    # (chain, op, line, end_line, in_unbroken_infinite_loop)
    sends: List[Tuple[tuple, str, int, int, bool]] = field(default_factory=list)
    # (chain, wkind, line, end_line, in_loop) — wkind "future"|"pop"|"bare"
    waits: List[Tuple[tuple, str, int, int, bool]] = field(default_factory=list)
    # (var, call_desc, arg_index, line, end_line) — bare tracked local
    # passed positionally into a call
    arg_passes: List[Tuple[str, tuple, int, int, int]] = field(default_factory=list)
    # chains used in untracked contexts (alias, store, container, reach-in)
    escapes: List[Tuple[tuple, int]] = field(default_factory=list)
    # var -> count of bare-Name uses beyond the ctor target
    mentions: Dict[str, int] = field(default_factory=dict)
    # (var, kind, ctor_line, ctor_end, ((leak_line, how), ...)) — PRM002
    drop_leaks: List[Tuple[str, str, int, int, tuple]] = field(default_factory=list)
    # (arg_desc|None, line, end_line) for statement-level dropped spawns
    spawn_drops: List[Tuple[Optional[tuple], int, int]] = field(default_factory=list)
    has_handler: bool = False
    has_trace: bool = False
    can_raise: bool = False
    # The function's AST, for param_leaks.
    node: Optional[ast.AST] = field(default=None, repr=False, compare=False)
    _param_leaks: Dict[str, tuple] = field(default_factory=dict, repr=False, compare=False)

    def param_leaks(self, param: str) -> tuple:
        """((leak_line, how), ...) of the paths on which this function can
        DROP `param` without send/send_error/handoff — empty when it
        cannot.  Consulted only when a caller hands a tracked promise into
        the param, so it is walked then, once."""
        if param not in self._param_leaks:
            leaks = _scan_acquisition(self.node, None, param)
            self._param_leaks[param] = tuple(sorted(set(leaks))[:4])
        return self._param_leaks[param]


def _walk_with_parents(root: ast.AST):
    """ast.walk's node order (breadth first) and each node's parent, from
    one pass over the tree."""
    nodes, parents = [root], {}
    i = 0
    while i < len(nodes):
        n = nodes[i]
        i += 1
        for child in ast.iter_child_nodes(n):
            parents[id(child)] = n
            nodes.append(child)
    return nodes, parents


@dataclass
class ModulePromiseFacts:
    relpath: str
    funcs: Dict[str, FuncFacts] = field(default_factory=dict)


# The one shared chain extractor (base.attr_chain tuple-wrapped by
# graphs._name_chain) — the same descriptors the call graph links on.
_chain = _name_chain


def _call_desc(func: ast.AST) -> Optional[tuple]:
    if isinstance(func, ast.Name):
        return ("name", func.id)
    ch = _chain(func)
    return ("chain", ch) if ch is not None else None


def _has_own_break(loop: ast.AST) -> bool:
    """Whether `loop`'s body contains a break that exits LOOP itself —
    breaks inside nested loops/defs leave only the inner construct."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(loop))
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Break):
            return True
        if isinstance(n, (ast.For, ast.AsyncFor, ast.While,
                          ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))
    return False


def _ctor_kind(call: ast.Call) -> Optional[str]:
    """"promise"/"stream" when the call constructs a tracked entity.
    Name-based on the final segment: `Promise(...)`, `future.Promise(...)`
    both match regardless of import aliasing (an exotic alias costs a
    false negative; a false positive is impossible — nothing else in the
    port is named Promise/PromiseStream)."""
    ch = _chain(call.func)
    if ch is None:
        return None
    return PROMISE_CTORS.get(ch[-1])


class _FactCollector(ast.NodeVisitor):
    """One function's promise facts.  Nested defs/lambdas are opaque for
    CREATIONS and WAITS (walk_defs gives each nested def its own facts)
    but their SENDS are folded into the enclosing function — a deferred
    send registered from a closure is still a live sender for the
    enclosing frame's entities."""

    def __init__(self, facts: FuncFacts, stmt_spans):
        self.facts = facts
        self.stmt_spans = stmt_spans
        self._loop_depth = 0
        self._inf_loops: List[ast.While] = []
        self._nesting = 0  # >0 inside a nested def/lambda/class

    def _end(self, node) -> int:
        return innermost_simple_stmt_end(node, self.stmt_spans)

    # -- structure ---------------------------------------------------------
    def visit_FunctionDef(self, node):
        self._nesting += 1
        self.generic_visit(node)
        self._nesting -= 1

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def _visit_loop(self, node, infinite: bool):
        self._loop_depth += 1
        if infinite:
            self._inf_loops.append(node)
        self.generic_visit(node)
        if infinite:
            self._inf_loops.pop()
        self._loop_depth -= 1

    def visit_For(self, node):
        self._visit_loop(node, False)

    visit_AsyncFor = visit_For

    def visit_While(self, node):
        infinite = isinstance(node.test, ast.Constant) and bool(node.test.value)
        self._visit_loop(node, infinite)

    def _in_unbroken_infinite_loop(self) -> bool:
        """True at a site inside a `while True:` with no break that exits
        THAT loop — a producer here can never terminate normally.  A break
        belonging to a nested loop (or a nested def) does not count: it
        only leaves the inner construct."""
        return any(not _has_own_break(loop) for loop in self._inf_loops)

    # -- sites -------------------------------------------------------------
    def visit_Assign(self, node: ast.Assign):
        if (
            not self._nesting
            and len(node.targets) == 1
            and isinstance(node.value, ast.Call)
        ):
            kind = _ctor_kind(node.value)
            if kind is not None:
                t = node.targets[0]
                if isinstance(t, ast.Name):
                    self.facts.local_creations[t.id] = (
                        kind, node.lineno, self._end(node)
                    )
                elif (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    self.facts.attr_creations.append((t.attr, kind, node.lineno))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in SEND_OPS:
            ch = _chain(f.value)
            if ch is not None:
                self.facts.sends.append(
                    (ch, f.attr, node.lineno, self._end(node),
                     self._in_unbroken_infinite_loop())
                )
        self.generic_visit(node)

    def visit_Await(self, node: ast.Await):
        if self._nesting:
            self.generic_visit(node)
            return
        v = node.value
        rec = None
        if isinstance(v, ast.Attribute) and v.attr == "future":
            ch = _chain(v.value)
            if ch is not None:
                rec = (ch, "future")
        elif (
            isinstance(v, ast.Call)
            and isinstance(v.func, ast.Attribute)
            and v.func.attr == "pop"
        ):
            ch = _chain(v.func.value)
            if ch is not None:
                rec = (ch, "pop")
        elif isinstance(v, (ast.Name, ast.Attribute)):
            ch = _chain(v)
            if ch is not None:
                rec = (ch, "bare")
        if rec is not None:
            self.facts.waits.append(
                (rec[0], rec[1], node.lineno, self._end(node),
                 self._loop_depth > 0)
            )
        self.generic_visit(node)

    def visit_Expr(self, node: ast.Expr):
        # Statement-level spawn with the Task dropped on the floor.
        v = node.value
        if not self._nesting and isinstance(v, ast.Call):
            # Raw `.spawn` only: spawn_observed/spawn_owned attach a death
            # observer by construction, which is exactly the remedy this
            # rule demands.
            if isinstance(v.func, ast.Attribute) and v.func.attr == "spawn":
                arg = v.args[0] if v.args else None
                desc = _call_desc(arg.func) if isinstance(arg, ast.Call) else None
                self.facts.spawn_drops.append(
                    (desc, node.lineno, self._end(node))
                )
        self.generic_visit(node)


class _MentionClassifier:
    """Second pass over a function body: classify every pure Name/Attribute
    chain as harmless, an op already recorded, a bare arg pass, or an
    ESCAPE that voids tracking (for locals, of the var; for attr chains,
    of every non-harmless attribute segment — name-global)."""

    def __init__(self, nodes: List[ast.AST], parents: Dict[int, ast.AST],
                 facts: FuncFacts, stmt_spans):
        self.nodes = nodes  # the function's nodes, in ast.walk's order
        self.parents = parents
        self.facts = facts
        self.stmt_spans = stmt_spans

    def run(self):
        # Locals created here AND the function's own params: param uses
        # feed the may-send fixpoint (a param forwarded to a sending
        # callee carries "may send" back through the chain).
        tracked = set(self.facts.local_creations) | (
            set(self.facts.params) - {"self", "cls"}
        )
        for node in self.nodes:
            if isinstance(node, ast.Name) and node.id in tracked:
                self._classify_local(node)
            elif isinstance(node, ast.Attribute):
                parent = self.parents.get(id(node))
                if isinstance(parent, ast.Attribute) and parent.value is node:
                    continue  # not the topmost link of its chain
                ch = _chain(node)
                if ch is not None and len(ch) >= 2 and ch[0] not in tracked:
                    self._classify_chain(node, ch)

    def _escape_chain(self, ch: tuple, line: int):
        self.facts.escapes.append((ch, line))

    def _classify_chain(self, top: ast.Attribute, ch: tuple):
        """An attribute chain NOT rooted at a tracked local.  If its use is
        anything beyond the recorded ops and the harmless read surface,
        every non-harmless attr segment is marked escaped — someone we
        cannot see may send through (or reach into) the entity."""
        parent = self.parents.get(id(top))
        if isinstance(parent, ast.Await):
            return  # recorded as a wait
        if (
            isinstance(parent, ast.Call)
            and parent.func is top
            and ch[-1] in SEND_OPS + ("pop",)
        ):
            return  # recorded as a send op / harmless stream read
        if all(a in HARMLESS_ATTRS for a in ch[1:]):
            return
        if isinstance(parent, ast.Assign) and any(
            t is top for t in parent.targets
        ):
            return  # a (re)bind of the attribute, incl. the creation itself
        if isinstance(parent, (ast.Delete,)):
            return
        self._escape_chain(ch, top.lineno)

    def _classify_local(self, name: ast.Name):
        var = name.id
        parent = self.parents.get(id(name))
        if isinstance(parent, ast.Assign) and any(
            t is name for t in parent.targets
        ):
            return  # the creation itself, or a clean rebind ending tracking
        self.facts.mentions[var] = self.facts.mentions.get(var, 0) + 1
        # Walk up the pure attribute chain rooted at this Name.
        top: ast.AST = name
        p = parent
        while isinstance(p, ast.Attribute) and p.value is top:
            top = p
            p = self.parents.get(id(top))
        if top is not name:
            attrs = _chain(top)[1:]
            if (
                isinstance(p, ast.Call)
                and p.func is top
                and attrs[-1] in SEND_OPS + ("pop",)
            ):
                return  # recorded op
            if all(a in HARMLESS_ATTRS for a in attrs):
                return  # read side only: cannot conjure a sender
            self._escape_chain(_chain(top), name.lineno)
            return
        # Bare var.
        if isinstance(p, ast.Await):
            return  # recorded as a wait
        if isinstance(p, ast.Call) and p.func is not name and any(
            a is name for a in p.args
        ):
            desc = _call_desc(p.func)
            if desc is not None:
                self.facts.arg_passes.append(
                    (var, desc, next(
                        i for i, a in enumerate(p.args) if a is name
                    ), name.lineno,
                     innermost_simple_stmt_end(name, self.stmt_spans))
                )
                return
            self._escape_chain((var,), name.lineno)
            return
        if isinstance(p, (ast.If, ast.While)) and getattr(p, "test", None) is name:
            return  # bare truth test: inspection only
        # Return/yield/store/alias/subscript/kwarg/comprehension/...
        self._escape_chain((var,), name.lineno)


def collect_promise_facts(relpath: str, tree: ast.Module) -> ModulePromiseFacts:
    mf = ModulePromiseFacts(relpath=relpath)

    def collect_func(node, qualname: str) -> FuncFacts:
        nodes, parents = _walk_with_parents(node)
        spans = [
            (s.lineno, s.end_lineno or s.lineno)
            for s in nodes
            if isinstance(s, ast.stmt)
        ]
        ff = FuncFacts(
            qualname=qualname,
            line=node.lineno,
            is_async=isinstance(node, ast.AsyncFunctionDef),
            params=tuple(
                a.arg for a in (
                    node.args.posonlyargs + node.args.args
                    + node.args.kwonlyargs
                )
            ),
            node=node,
        )
        fc = _FactCollector(ff, spans)
        for stmt in node.body:
            fc.visit(stmt)
        _MentionClassifier(nodes, parents, ff, spans).run()
        # PRM002 locals: RPY001's conservative path walk, acquisition = the
        # constructor statement (a mention anywhere = resolve/handoff; a
        # ctor inside a nested def is that def's own acquisition and walks
        # silent here).
        for stmt in nodes:
            if (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Call)
            ):
                kind = _ctor_kind(stmt.value)
                if kind is None:
                    continue
                var = stmt.targets[0].id
                leaks = _scan_acquisition(node, stmt, var)
                if leaks:
                    ff.drop_leaks.append(
                        (var, kind, stmt.lineno,
                         stmt.end_lineno or stmt.lineno,
                         tuple(sorted(set(leaks))[:4]))
                    )
        for n in nodes:
            if isinstance(n, ast.ExceptHandler):
                ff.has_handler = True
            elif isinstance(n, (ast.Raise, ast.Await)):
                ff.can_raise = True
            elif isinstance(n, ast.Call):
                ch = _chain(n.func)
                if ch is not None and ch[-1] in ("TraceEvent", "trace_batch"):
                    ff.has_trace = True
        return ff

    def walk_defs(body, prefix: str):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{node.name}"
                mf.funcs[qn] = collect_func(node, qn)
                walk_defs(node.body, f"{qn}.")
            elif isinstance(node, ast.ClassDef):
                walk_defs(node.body, f"{prefix}{node.name}.")

    walk_defs(tree.body, "")
    return mf


# ---------------------------------------------------------------------------
# Linking
# ---------------------------------------------------------------------------


def _class_of(qual: str) -> Optional[str]:
    return qual.split(".")[0] if "." in qual else None


class _Linker:
    """Cross-file resolution shared by all five rules: name-global attr
    indexes (safe over-approximation of senders), class-resolved entity
    attribution through the call graph's MRO machinery (the precision
    PRM003/PRM004 need), and the param may-send fixpoint."""

    def __init__(
        self,
        summaries: Dict[str, ModuleSummary],
        facts: Dict[str, ModulePromiseFacts],
        graph: Optional[CallGraph] = None,
    ):
        self.summaries = summaries
        self.facts = facts
        self.graph = CallGraph(summaries) if graph is None else graph
        self._build_name_indexes()
        self._build_resolved_sites()
        self._fixpoint_param_senders()

    # -- name-global attr indexes (senders over-approximated) --------------
    def _build_name_indexes(self):
        self.attr_creations: Dict[str, List[Tuple[str, str, str, int]]] = {}
        self.attr_sends: Dict[str, List[Tuple[str, str, str, int]]] = {}
        self.attr_closers: Dict[str, List[Tuple[str, str, str, int]]] = {}
        self.attr_escapes: Dict[str, List[Tuple[str, int]]] = {}
        for rp, mf in self.facts.items():
            for qual, ff in mf.funcs.items():
                for attr, kind, line in ff.attr_creations:
                    self.attr_creations.setdefault(attr, []).append(
                        (rp, qual, kind, line)
                    )
                for ch, op, line, _e, _inf in ff.sends:
                    if len(ch) >= 2:
                        slot = (
                            self.attr_sends if op == "send"
                            else self.attr_closers
                        )
                        slot.setdefault(ch[-1], []).append((rp, qual, op, line))
                for ch, line in ff.escapes:
                    for seg in ch[1:]:
                        if seg not in HARMLESS_ATTRS and seg not in SEND_OPS:
                            self.attr_escapes.setdefault(seg, []).append(
                                (rp, line)
                            )

    # -- class-resolved sites (PRM003/PRM004 precision) --------------------
    def _build_resolved_sites(self):
        # Entity -> [(node, op, line, end, in_infinite_loop)]
        self.res_sends: Dict[Entity, List[Tuple[Node, str, int, int, bool]]] = {}
        # Entity -> [(node, wkind, line, end, in_loop)]
        self.res_waits: Dict[Entity, List[Tuple[Node, str, int, int, bool]]] = {}
        # Attr names where some send failed to resolve to an entity —
        # an unseen receiver may satisfy waits on same-named entities.
        self.dirty_attrs: Set[str] = set(self.attr_escapes)
        for rp, mf in self.facts.items():
            for qual, ff in mf.funcs.items():
                node = (rp, qual)
                for ch, op, line, end, inf in ff.sends:
                    if len(ch) < 2:
                        continue
                    ent = self.resolve_entity(rp, qual, ch)
                    if ent is None:
                        self.dirty_attrs.add(ch[-1])
                    else:
                        self.res_sends.setdefault(ent, []).append(
                            (node, op, line, end, inf)
                        )
                for ch, wkind, line, end, in_loop in ff.waits:
                    if len(ch) < 2 or wkind not in ("future", "pop"):
                        continue
                    ent = self.resolve_entity(rp, qual, ch)
                    if ent is not None:
                        self.res_waits.setdefault(ent, []).append(
                            (node, wkind, line, end, in_loop)
                        )

    def resolve_entity(self, rp: str, qual: str, chain: tuple) -> Optional[Entity]:
        """(relpath, class, attr) for the chain's receiver: `self.x` in a
        method (creation class found through the MRO), `var.x` with a
        known local ctor type, `self.field.x` through the class's attr
        ctor types.  All other shapes are unknown."""
        ms = self.summaries.get(rp)
        if ms is None or len(chain) < 2:
            return None
        cls = _class_of(qual)
        attr = chain[-1]
        if chain[0] == "self" and cls is not None:
            if len(chain) == 2:
                return self._creation_class(ms, cls, attr)
            if len(chain) == 3:
                ctor = self.graph._attr_ctor(ms, cls, chain[1])
                if ctor is not None:
                    got = self.graph._resolve_class_chain(ctor[0], ctor[1])
                    if got is not None:
                        return self._creation_class(got[0], got[1], attr)
            return None
        fs = ms.functions.get(qual)
        if fs is not None and chain[0] in fs.var_ctors and len(chain) == 2:
            got = self.graph._resolve_class_chain(ms, fs.var_ctors[chain[0]])
            if got is not None:
                return self._creation_class(got[0], got[1], attr)
        return None

    def _creation_class(self, ms: ModuleSummary, cls: str, attr: str,
                        depth: int = 0) -> Optional[Entity]:
        """Entity of the class (walking bases) whose methods create
        self.<attr> as a tracked promise/stream, or None."""
        if depth > 8:
            return None
        mf = self.facts.get(ms.relpath)
        if mf is not None:
            for qual, ff in mf.funcs.items():
                if _class_of(qual) == cls and any(
                    a == attr for a, _k, _l in ff.attr_creations
                ):
                    return (ms.relpath, cls, attr)
        cs = ms.classes.get(cls)
        if cs is None:
            return None
        for base in cs.bases:
            got = self.graph._resolve_class_chain(ms, base)
            if got is not None:
                found = self._creation_class(got[0], got[1], attr, depth + 1)
                if found is not None:
                    return found
        return None

    def entity_kinds(self, ent: Entity) -> Set[str]:
        kinds: Set[str] = set()
        for rp, qual, kind, _l in self.attr_creations.get(ent[2], ()):
            if rp == ent[0] and _class_of(qual) == ent[1]:
                kinds.add(kind)
        return kinds

    # -- param may-send fixpoint ------------------------------------------
    def _fixpoint_param_senders(self):
        self.may_send: Dict[Node, Dict[str, bool]] = {}
        passes: Dict[Node, List[Tuple[str, Node, str]]] = {}
        for rp, mf in self.facts.items():
            ms = self.summaries.get(rp)
            for qual, ff in mf.funcs.items():
                node = (rp, qual)
                slot = self.may_send.setdefault(node, {})
                pl = passes.setdefault(node, [])
                pset = set(ff.params)
                for ch, _op, _l, _e, _inf in ff.sends:
                    if ch[0] in pset:
                        slot[ch[0]] = True  # direct send on the param
                for ch, _line in ff.escapes:
                    if ch[0] in pset:
                        slot[ch[0]] = True  # untracked use: may send
                for var, desc, idx, _l, _e in ff.arg_passes:
                    if var not in pset:
                        continue
                    got = self._callee_param(ms, qual, desc, idx)
                    if got is None:
                        slot[var] = True  # unresolvable handoff: may send
                    else:
                        pl.append((var, got[0], got[1]))
        changed = True
        while changed:
            changed = False
            for node, pl in passes.items():
                for var, callee, pname in pl:
                    if self.may_send[node].get(var):
                        continue
                    if self.may_send.get(callee, {}).get(pname):
                        self.may_send[node][var] = True
                        changed = True

    def _callee_param(
        self, ms: Optional[ModuleSummary], qual: str, desc: tuple, idx: int
    ) -> Optional[Tuple[Node, str]]:
        """((relpath, qual), param_name) a positional arg lands on, or None
        when the callee/param cannot be pinned down."""
        if ms is None:
            return None
        callee = self.graph.resolve_call(ms, qual, desc)
        if callee is None or not in_nodes(self.summaries, callee):
            return None
        cff = self.facts.get(callee[0], ModulePromiseFacts("")).funcs.get(
            callee[1]
        )
        if cff is None:
            return None
        cparams = list(cff.params)
        if cparams and cparams[0] in ("self", "cls"):
            cparams = cparams[1:]
        if idx >= len(cparams):
            return None
        return (callee, cparams[idx])

    def callee_facts(self, callee: Node) -> Optional[FuncFacts]:
        mf = self.facts.get(callee[0])
        return mf.funcs.get(callee[1]) if mf is not None else None


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


def run_promise_rules(
    summaries: Dict[str, ModuleSummary],
    facts_by_file: Dict[str, ModulePromiseFacts],
    graph: Optional[CallGraph] = None,
) -> List[Finding]:
    """The five rules over the scan, which is the whole project: the
    attribute-entity rules reason over "no code in the project sends"
    (the port's gate has no single-file mode, where an unseen sibling
    file could send)."""
    lk = _Linker(summaries, facts_by_file, graph)
    findings: List[Finding] = []
    findings += _prm001(lk)
    findings += _prm002(lk)
    findings += _prm003(lk)
    findings += _prm004(lk)
    findings += _tsk001(lk)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def _attr_may_have_sender(lk: _Linker, attr: str) -> bool:
    """Three-valued name-global sender existence for self.<attr> entities:
    any send/send_error/close on a chain ending .attr anywhere, or ANY
    escape touching the attr (aliased, passed, stored, reached into —
    someone we cannot see may send), counts as a potential sender."""
    return bool(
        lk.attr_sends.get(attr)
        or lk.attr_closers.get(attr)
        or lk.attr_escapes.get(attr)
    )


def _local_may_have_sender(
    lk: _Linker, rp: str, qual: str, ff: FuncFacts, var: str
) -> bool:
    """Potential senders for a function-local entity: a direct send, any
    escape, or a handoff whose callee param may send (or could not be
    resolved)."""
    if any(c[0] == var for c, _o, _l, _e, _i in ff.sends):
        return True
    if any(c[0] == var for c, _l in ff.escapes):
        return True
    ms = lk.summaries.get(rp)
    for v, desc, idx, _l, _e in ff.arg_passes:
        if v != var:
            continue
        got = lk._callee_param(ms, qual, desc, idx)
        if got is None:
            return True  # unresolvable handoff: assume it may send
        if lk.may_send.get(got[0], {}).get(got[1]):
            return True
    return False


def _prm001(lk: _Linker) -> List[Finding]:
    out: List[Finding] = []
    for rp, mf in sorted(lk.facts.items()):
        for qual, ff in mf.funcs.items():
            for ch, wkind, line, end, _in_loop in ff.waits:
                if wkind not in ("future", "pop"):
                    continue
                if len(ch) >= 2:
                    attr = ch[-1]
                    creations = lk.attr_creations.get(attr)
                    if not creations or _attr_may_have_sender(lk, attr):
                        continue
                    kinds = {k for _r, _q, k, _l in creations}
                    what = "stream" if kinds == {"stream"} else "promise"
                    out.append(Finding(
                        "PRM001", rp, line, 0,
                        f"'{qual}' awaits '{'.'.join(ch)}"
                        f"{'.pop()' if wkind == 'pop' else '.future'}' but "
                        f"no code in the project sends/closes the paired "
                        f"{what} '{attr}' — the wait can never complete "
                        f"(static hang; FoundationDB would deliver "
                        f"broken_promise from the Promise destructor)",
                        end_line=end,
                    ))
                else:
                    var = ch[0]
                    created = ff.local_creations.get(var)
                    if created is None:
                        continue
                    if _local_may_have_sender(lk, rp, qual, ff, var):
                        continue
                    out.append(Finding(
                        "PRM001", rp, line, 0,
                        f"'{qual}' awaits local "
                        f"{'stream' if created[0] == 'stream' else 'promise'}"
                        f" '{var}' which nothing can ever send to (no "
                        f"send/send_error/close reachable — static hang)",
                        end_line=end,
                    ))
    return out


def _prm002(lk: _Linker) -> List[Finding]:
    out: List[Finding] = []
    for rp, mf in sorted(lk.facts.items()):
        ms = lk.summaries.get(rp)
        for qual, ff in mf.funcs.items():
            for var, kind, line, end, leaks in ff.drop_leaks:
                where = "; ".join(f"line {ln} ({how})" for ln, how in leaks)
                out.append(Finding(
                    "PRM002", rp, line, 0,
                    f"{'stream' if kind == 'stream' else 'promise'} '{var}' "
                    f"in '{qual}' can be dropped without send/send_error/"
                    f"close on: {where} — every waiter parks forever "
                    f"(broken-promise class; no destructor backstop)",
                    end_line=end,
                ))
            # Handoff tracking: the promise's ONLY use is handing it to a
            # callee that can itself drop it on some path.
            for var, desc, idx, pline, pend in ff.arg_passes:
                if var not in ff.local_creations:
                    continue
                if ff.mentions.get(var, 0) != 1:
                    continue  # other uses: ownership is shared, not handed
                got = lk._callee_param(ms, qual, desc, idx)
                if got is None:
                    continue
                callee, pname = got
                leaks = lk.callee_facts(callee).param_leaks(pname)
                if not leaks:
                    continue
                where = "; ".join(f"line {ln} ({how})" for ln, how in leaks)
                out.append(Finding(
                    "PRM002", rp, pline, 0,
                    f"promise '{var}' handed off to '{callee[1]}' "
                    f"({callee[0]}) which can drop param '{pname}' without "
                    f"send/send_error/close on: {where}",
                    end_line=pend,
                ))
    return out


def _prm003(lk: _Linker) -> List[Finding]:
    # Wait-graph edges: waiter function -> every function that can send
    # the (class-resolved) entity it waits on.  Entities with unresolved
    # same-named sends or escapes are dirty: an unseen sender may wake
    # the cycle, so they contribute no edges.
    edges: Dict[Node, Set[Node]] = {}
    nodes: Set[Node] = set()
    for ent, waits in lk.res_waits.items():
        if ent[2] in lk.dirty_attrs:
            continue
        senders = {s[0] for s in lk.res_sends.get(ent, ())}
        for (wnode, _wk, _l, _e, _il) in waits:
            nodes.add(wnode)
            for s in senders:
                nodes.add(s)
                edges.setdefault(wnode, set()).add(s)

    # Iterative Tarjan SCC.
    index: Dict[Node, int] = {}
    low: Dict[Node, int] = {}
    on_stack: Set[Node] = set()
    stack: List[Node] = []
    sccs: List[Set[Node]] = []
    counter = [0]

    def strongconnect(root: Node):
        work: List[Tuple[Node, iter]] = [(root, iter(sorted(edges.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(edges.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[node])
            if low[node] == index[node]:
                scc: Set[Node] = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.add(w)
                    if w == node:
                        break
                sccs.append(scc)

    for v in sorted(nodes):
        if v not in index:
            strongconnect(v)

    out: List[Finding] = []
    for scc in sccs:
        if len(scc) < 2:
            continue
        # "No external sender": every entity awaited inside the SCC must
        # have ALL its senders inside it — one outside sender can wake
        # the cycle, so the whole SCC is then live.
        blocking: List[Tuple[Entity, Node, int, int]] = []
        external = False
        for ent, waits in lk.res_waits.items():
            if ent[2] in lk.dirty_attrs:
                continue
            in_scc = [w for w in waits if w[0] in scc]
            if not in_scc:
                continue
            senders = {s[0] for s in lk.res_sends.get(ent, ())}
            if not senders:
                continue  # PRM001's case, not a cycle
            if senders - scc:
                external = True
                break
            for (wnode, _wk, line, end, _il) in in_scc:
                blocking.append((ent, wnode, line, end))
        if external or not blocking:
            continue
        names = " <-> ".join(sorted({n[1] for n in scc}))
        for ent, wnode, line, end in sorted(
            blocking, key=lambda b: (b[1][0], b[2])
        ):
            out.append(Finding(
                "PRM003", wnode[0], line, 0,
                f"wait-cycle: '{wnode[1]}' awaits '{ent[1]}.{ent[2]}' whose "
                f"only senders are inside the cycle [{names}] — no "
                f"external sender can break it (static deadlock)",
                end_line=end,
            ))
    return out


def _prm004(lk: _Linker) -> List[Finding]:
    out: List[Finding] = []
    for rp, mf in sorted(lk.facts.items()):
        for qual, ff in mf.funcs.items():
            for ch, wkind, line, end, in_loop in ff.waits:
                if wkind != "pop" or not in_loop:
                    continue
                if len(ch) >= 2:
                    ent = lk.resolve_entity(rp, qual, ch)
                    if ent is None or ent[2] in lk.dirty_attrs:
                        continue
                    if lk.entity_kinds(ent) != {"stream"}:
                        continue
                    sites = lk.res_sends.get(ent, ())
                    if any(s[1] in ("send_error", "close") for s in sites):
                        continue  # a closer exists somewhere
                    producers = [s for s in sites if s[1] == "send"]
                    if not producers:
                        continue  # zero senders at all is PRM001's case
                    # Every producer must be able to terminate; a send
                    # inside an unbroken `while True:` never returns.
                    if any(s[4] for s in producers):
                        continue
                    prods = ", ".join(sorted({
                        f"{n[1]} ({n[0]})" for n, _o, _l, _e, _i in producers
                    })[:3])
                    out.append(Finding(
                        "PRM004", rp, line, 0,
                        f"'{qual}' loops over stream '{ent[1]}.{ent[2]}' "
                        f"but every producer [{prods}] can terminate "
                        f"without send_error/close — the consumer parks "
                        f"forever once producers finish (idle-drain hang)",
                        end_line=end,
                    ))
                else:
                    var = ch[0]
                    created = ff.local_creations.get(var)
                    if created is None or created[0] != "stream":
                        continue
                    if any(c[0] == var for c, _l in ff.escapes):
                        continue
                    if any(p[0] == var for p in ff.arg_passes):
                        continue  # handed off: producers unknowable
                    own = [s for s in ff.sends if s[0][0] == var]
                    if any(s[1] in ("send_error", "close") for s in own):
                        continue
                    producers = [s for s in own if s[1] == "send"]
                    if not producers:
                        continue
                    # Same exemption as the attr branch: a producer inside
                    # an unbroken `while True:` never terminates, so the
                    # consumer can always expect more.
                    if any(s[4] for s in producers):
                        continue
                    out.append(Finding(
                        "PRM004", rp, line, 0,
                        f"'{qual}' loops over local stream '{var}' with no "
                        f"send_error/close on any path — the loop can "
                        f"never observe end-of-stream",
                        end_line=end,
                    ))
    return out


def _tsk001(lk: _Linker) -> List[Finding]:
    out: List[Finding] = []
    for rp, mf in sorted(lk.facts.items()):
        ms = lk.summaries.get(rp)
        if ms is None:
            continue
        for qual, ff in mf.funcs.items():
            for desc, line, end in ff.spawn_drops:
                if desc is None:
                    continue  # opaque coroutine expression: cannot judge
                callee = lk.graph.resolve_call(ms, qual, desc)
                if callee is None or not in_nodes(lk.summaries, callee):
                    continue
                if not lk.summaries[callee[0]].functions[callee[1]].is_async:
                    continue
                cff = lk.callee_facts(callee)
                if cff is None:
                    continue
                if not cff.can_raise or cff.has_handler or cff.has_trace:
                    continue
                out.append(Finding(
                    "TSK001", rp, line, 0,
                    f"spawned task '{callee[1]}' ({callee[0]}) is dropped "
                    f"and can raise with neither an except handler nor a "
                    f"TraceEvent — an FdbError in it vanishes silently "
                    f"(the loop only surfaces non-FdbError crashes); hold "
                    f"the Task, handle, or trace",
                    end_line=end,
                ))
    return out
