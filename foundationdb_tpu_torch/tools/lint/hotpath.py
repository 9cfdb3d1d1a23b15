"""perfcheck: the static half of the port's host-path discipline
(HOT001-HOT004).

The port's counterpart of the reference package's perfcheck
(``tools/lint/hotpath.py``), with the port's vocabulary: its dispatch
entry points and ticket fields, its sanctioned sync scopes and torch's
ways to sync.  Its dynamic twin is the transfer guard
(``flow/hotpath.py``: ``GuardedDeviceValue`` and, on CUDA, torch's sync
debug mode).  The hazards are host-side: an implicit device->host sync
inside the pipelined dispatch->sync window serializes the pipeline, a
per-row Python loop over history/mirror columns breaks the mirror's
O(touched-chunks) contract, and an unstaged per-batch allocation
bypasses the engine's staging ring (``engine_torch._StagingRing``).

Rules (pragma namespace ``# perfcheck: ignore[RULE]: reason``):

HOT001  implicit device->host transfer or blocking sync on values that
        taint-flow from a DEVICE_ENTRY_POINTS dispatch's return or a
        DispatchTicket's device fields (``out``, ``host``, ``ready``):
        ``np.asarray`` / ``.item()`` / ``.tolist()`` / ``int()`` /
        ``float()`` / ``bool()`` / ``len()`` / iteration, torch's
        ``.cpu()`` / ``.numpy()`` / ``.to("cpu")`` /
        ``.to(device="cpu")`` and ``.synchronize()`` (a ticket's
        ``ready`` event); ``dst.copy_(src)`` from a tainted ``src``,
        whatever ``dst`` is; and a truth test of a tainted tensor — the
        test of an ``if``, ``while``, ``assert``, conditional expression
        or comprehension ``if``, the operand of ``not`` and each operand
        of ``and``/``or`` that is tested — on the tensor itself or on a
        tensor computed from it (``t[0]``, ``t > 0``, ``(t > 0).any()``,
        ``torch.any(t)``); an identity test (``is``/``is not``) reads no
        value.  Device-wide, anywhere in the window, tainted or not:
        ``torch.cuda.synchronize()``, which waits for everything in
        flight, and ``.synchronize()`` on any stream or event
        (``torch.cuda.current_stream()``, ``default_stream()``, a
        ``Stream``, an ``Event``), which waits for the work queued before
        it.  Not syncs: ``Event.query()``, ``.to()`` a device other than
        the CPU, and ``Event.wait`` / ``Stream.wait_event`` /
        ``wait_stream``, which make a stream wait on the device and never
        block the host.  A ``non_blocking=True`` copy (``.to`` or
        ``copy_``) is taken as the pinned-memory copy that does not block
        (the engine's readback into its pinned pool is one): the static
        pass cannot see whether the host buffer is pinned, and a
        non-blocking copy into pageable memory is in neither half of the
        guard.  Outside the sanctioned
        points: the functions of SANCTIONED_FNS and any block under
        ``with self._sanctioned_sync(...)`` or ``with on_sync()`` (the
        scopes the runtime guard allows; a call from inside one does not
        extend the window).  The finding names the dispatch->sync call
        chain through the CallGraph.
HOT002  Python loop whose iteration space exceeds the function's
        declared ``@hot_path(bound=...)``: loops over history/mirror
        row columns (.keys/.vers/ek/va/pfx) under ANY bound; any
        data-dependent loop under bound="const".
HOT003  unstaged per-call allocation in a ``@hot_path`` function: numpy's
        np.empty/zeros/ones/full/concatenate/frombuffer and torch's
        torch.empty/zeros/ones/full/cat/stack/tensor.  Hot-path buffers
        ride the staging ring or carry a reasoned pragma.
HOT004  per-row Python scalarization in a ``@hot_path`` function:
        .tolist() round-trips and python-int indexing loops where a
        vectorized op exists.

Facts are per file; only the CallGraph linking and the rules look across
files."""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .base import SIMPLE_STMTS, Aliases, Finding, attr_chain
from .graphs import CallGraph, ModuleSummary

# ---------------------------------------------------------------------------
# Rule registry (perfcheck's own universe: pragma policing validates
# against THIS dict)
# ---------------------------------------------------------------------------

HOT_RULES: Dict[str, str] = {
    "HOT001": "implicit device->host sync on in-flight dispatch state outside a sanctioned sync point",
    "HOT002": "python loop exceeds the function's declared @hot_path bound",
    "HOT003": "unstaged per-batch numpy or torch allocation in a @hot_path function (ride the engine's staging ring, _StagingRing)",
    "HOT004": "per-row python scalarization (.tolist() / python-int indexing loop) in a @hot_path function",
    "PRG001": "perfcheck ignore pragma carries no reason string",
    "PRG002": "perfcheck ignore pragma suppresses nothing (stale)",
}

# Dispatch entry points whose return values are in-flight device state:
# the window opens at a call to one of these.
DEVICE_ENTRY_POINTS = ("dispatch_txns", "dispatch_packed")

# DispatchTicket's device fields (engine_torch.DispatchTicket): the step's
# packed output, its pinned host copy and that copy's event.  Reading
# `<...>.ticket.<field>` taints, reading the ticket itself only forwards.
TICKET_FIELDS = {"out", "host", "ready"}
# The ticket's host values: reading one of these off a tainted value does
# not taint.
TICKET_HOST_FIELDS = {"pb", "now", "new_oldest_version", "base", "d_cap",
                      "added", "epoch"}

# History/mirror row columns: iterating one of these is O(H) by
# definition (the chunk columns + the flat views).
O_ROWS = {"keys", "vers", "ek", "va", "pfx"}

ALLOC_FNS = {"empty", "zeros", "ones", "full", "concatenate", "frombuffer"}
NP_ROOTS = {"np", "numpy"}
TORCH_ALLOC_FNS = {"empty", "zeros", "ones", "full", "cat", "stack", "tensor"}
SCALAR_FNS = {"int", "float", "bool", "len"}
DEVICE_SYNC = "torch.cuda.synchronize"
# Tensor methods whose result is a host value, or a host copy HOT001
# already flags: a truth test of their result reads nothing more.
HOST_VALUED = {"item", "tolist", "cpu", "numpy", "synchronize", "query", "size", "dim",
               "numel", "nelement", "stride", "is_contiguous", "data_ptr", "element_size"}

# The declared sync points: functions whose job IS the blocking
# device->host readback (each enters the engine's _sanctioned_sync scope
# at runtime, HOT001's dynamic twin).  Matched on the qualname's last
# segment, mirroring how the runtime guard sanctions whole scopes.
SANCTIONED_FNS = {
    "sync_ticket", "_readback",
    "detect_packed", "detect",
    "store_to", "load_from",
    "_merged_host_state",
    "_fallback_cpu",
    "_pipeline_replay_on_mirror",
    "_sanctioned_sync",
}

_HOT_BOUNDS = ("batch", "chunks", "const")


# ---------------------------------------------------------------------------
# Per-file facts
# ---------------------------------------------------------------------------


@dataclass
class HotFuncFacts:
    qualname: str
    bound: Optional[str] = None   # @hot_path(bound=...) or None
    # (line, end_line) spans of dispatch-entry call sites (window roots)
    dispatches: List[Tuple[int, int]] = field(default_factory=list)
    # (line, end_line) body spans of sanctioned `with` blocks: no sync in
    # one is flagged, and no call from one extends the window
    scopes: List[Tuple[int, int]] = field(default_factory=list)
    # (line, end_line, op, target) unsanctioned tainted host syncs
    syncs: List[Tuple[int, int, str, str]] = field(default_factory=list)
    # (line, end_line, op) unsanctioned device-wide syncs:
    # torch.cuda.synchronize() and untainted stream/event .synchronize()
    device_syncs: List[Tuple[int, int, str]] = field(default_factory=list)
    # (line, end_line, kind, desc); kind in rows|chunks|const|other —
    # recorded only for decorated functions (HOT002 facts)
    loops: List[Tuple[int, int, str, str]] = field(default_factory=list)
    # (line, end_line, fn) allocation sites (HOT003 facts)
    allocs: List[Tuple[int, int, str]] = field(default_factory=list)
    # (line, end_line, desc) scalarization sites (HOT004 facts)
    scalars: List[Tuple[int, int, str]] = field(default_factory=list)

    def in_scope(self, line: int) -> bool:
        return any(s <= line <= e for s, e in self.scopes)


@dataclass
class ModuleHotFacts:
    relpath: str
    functions: Dict[str, HotFuncFacts] = field(default_factory=dict)


def _desc(node: ast.AST) -> str:
    ch = attr_chain(node)
    if ch is not None:
        return ".".join(ch)
    try:
        s = ast.unparse(node)
    except Exception:
        return "<expr>"
    return s if len(s) <= 48 else s[:45] + "..."


def _stmt_span(node: ast.AST, parents: Dict[int, ast.AST]) -> Tuple[int, int]:
    """(line, end_line) of the innermost SIMPLE statement containing
    `node` — the pragma suppression scope — else the node's own span."""
    cur = node
    while cur is not None:
        if isinstance(cur, SIMPLE_STMTS):
            return (cur.lineno, cur.end_lineno or cur.lineno)
        cur = parents.get(id(cur))
    return (node.lineno, getattr(node, "end_lineno", None) or node.lineno)


def _decorator_bound(node) -> Optional[str]:
    """The declared bound of a @hot_path decoration, or None.  Matched by
    NAME (hot_path / x.hot_path): the static pass must not import the
    runtime module, and corpus cases stub it."""
    for d in node.decorator_list:
        if isinstance(d, ast.Call):
            ch = attr_chain(d.func)
            if ch is None or ch[-1] != "hot_path":
                continue
            bound = "batch"
            for kw in d.keywords:
                if kw.arg == "bound" and isinstance(kw.value, ast.Constant):
                    bound = str(kw.value.value)
            if d.args and isinstance(d.args[0], ast.Constant):
                bound = str(d.args[0].value)
            return bound if bound in _HOT_BOUNDS else "batch"
        ch = attr_chain(d)
        if ch is not None and ch[-1] == "hot_path":
            return "batch"
    return None


def _sanctions(expr: ast.AST) -> bool:
    """True for a `with` item that opens a sanctioned sync scope:
    ``<...>._sanctioned_sync(...)`` or ``on_sync()``, or a conditional
    expression with one in an arm (``on_sync() if on_sync else ...``)."""
    if isinstance(expr, ast.IfExp):
        return _sanctions(expr.body) or _sanctions(expr.orelse)
    if isinstance(expr, ast.Call):
        ch = attr_chain(expr.func)
        return ch is not None and (ch[-1] == "_sanctioned_sync" or ch == ["on_sync"])
    return False


def _is_cpu(e: ast.AST) -> bool:
    """A device argument naming the CPU: "cpu" or torch.device("cpu")."""
    if isinstance(e, ast.Constant):
        return e.value == "cpu"
    if isinstance(e, ast.Call):
        ch = attr_chain(e.func)
        return bool(ch) and ch[-1] == "device" and bool(e.args) and _is_cpu(e.args[0])
    return False


def _non_blocking(call: ast.Call) -> bool:
    return any(kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords)


def _to_cpu(call: ast.Call) -> bool:
    """``.to("cpu")`` / ``.to(device="cpu")`` without non_blocking=True."""
    if _non_blocking(call):
        return False
    if call.args and _is_cpu(call.args[0]):
        return True
    return any(kw.arg == "device" and _is_cpu(kw.value) for kw in call.keywords)


def _classify_iter(it: ast.AST) -> Tuple[str, str]:
    """(kind, description) of a for-loop iterable.  rows = O(history
    rows) (always over-bound in hot code), chunks = O(touched chunks),
    const = provably O(1) literals, other = data-dependent but not a
    known row column (over-bound only under bound="const")."""
    if isinstance(it, (ast.Tuple, ast.List, ast.Set, ast.Dict)):
        return "const", "literal"
    if isinstance(it, ast.Call):
        ch = attr_chain(it.func)
        last = ch[-1] if ch else None
        if last in ("enumerate", "sorted", "reversed", "iter", "list",
                    "tuple") and it.args:
            return _classify_iter(it.args[0])
        if last == "zip":
            kinds = [_classify_iter(a) for a in it.args]
            for want in ("rows", "chunks", "other"):
                for k, d in kinds:
                    if k == want:
                        return k, d
            return "const", "zip(literals)"
        if last == "range":
            if all(isinstance(a, ast.Constant) for a in it.args):
                return "const", "range(<const>)"
            if len(it.args) >= 1 and isinstance(it.args[0], ast.Call):
                inner = it.args[0]
                ich = attr_chain(inner.func)
                if ich and ich[-1] == "len" and inner.args:
                    k, d = _classify_iter(inner.args[0])
                    return k, f"range(len({d}))"
            return "other", _desc(it)
        if last == "take_fresh_chunks":
            return "chunks", _desc(it.func) + "()"
        return "other", _desc(it)
    ch = attr_chain(it)
    if ch is not None:
        if ch[-1] in O_ROWS:
            return "rows", ".".join(ch)
        if ch[-1] == "chunks":
            return "chunks", ".".join(ch)
        return "other", ".".join(ch)
    if isinstance(it, ast.Subscript):
        return _classify_iter(it.value)
    return "other", _desc(it)


class _FuncAnalysis:
    """Single-function fact extraction: decorator bound, sanctioned
    scopes, local taint fixpoint for HOT001 sync sites, dispatch window
    roots, and (for decorated functions) loop/alloc/scalarization facts.
    Nested defs fold into the enclosing function, like
    graphs._FuncCollector."""

    def __init__(self, node, qualname: str, aliases: Aliases):
        self.node = node
        self.aliases = aliases
        self.facts = HotFuncFacts(qualname=qualname, bound=_decorator_bound(node))
        self.parents: Dict[int, ast.AST] = {}
        for parent in ast.walk(node):
            for child in ast.iter_child_nodes(parent):
                self.parents[id(child)] = parent
        self.taint: Set[str] = set()
        self._seed_params()
        self._taint_fixpoint()
        self._scan()

    # -- taint -------------------------------------------------------------
    def _seed_params(self):
        a = self.node.args
        for p in (a.posonlyargs + a.args + a.kwonlyargs):
            ann = p.annotation
            ann_name = None
            if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                ann_name = ann.value.split(".")[-1].strip("\"'")
            elif ann is not None:
                ch = attr_chain(ann)
                if ch:
                    ann_name = ch[-1]
            if p.arg == "ticket" or ann_name == "DispatchTicket":
                self.taint.add(p.arg)

    def _tainted(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.taint
        if isinstance(e, (ast.Subscript, ast.Starred, ast.Await)):
            return self._tainted(e.value)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self._tainted(x) for x in e.elts)
        if isinstance(e, ast.Call):
            ch = attr_chain(e.func)
            return bool(ch) and ch[-1] in DEVICE_ENTRY_POINTS
        if isinstance(e, ast.Attribute):
            if e.attr in TICKET_HOST_FIELDS:
                return False
            ch = attr_chain(e)
            if (ch and e.attr in TICKET_FIELDS and "ticket" in ch[:-1]):
                return True
            return self._tainted(e.value)
        if isinstance(e, ast.IfExp):
            return self._tainted(e.body) or self._tainted(e.orelse)
        if isinstance(e, ast.BinOp):
            return self._tainted(e.left) or self._tainted(e.right)
        return False

    @staticmethod
    def _target_names(t: ast.AST) -> List[str]:
        if isinstance(t, ast.Name):
            return [t.id]
        if isinstance(t, (ast.Tuple, ast.List)):
            out: List[str] = []
            for e in t.elts:
                out.extend(_FuncAnalysis._target_names(e))
            return out
        if isinstance(t, ast.Starred):
            return _FuncAnalysis._target_names(t.value)
        return []

    def _taint_fixpoint(self):
        for _ in range(8):
            changed = False
            for st in ast.walk(self.node):
                if isinstance(st, ast.Assign):
                    targets, value = st.targets, st.value
                elif isinstance(st, ast.AnnAssign) and st.value is not None:
                    targets, value = [st.target], st.value
                elif isinstance(st, ast.AugAssign):
                    targets, value = [st.target], st.value
                else:
                    continue
                if not self._tainted(value):
                    continue
                for t in targets:
                    for name in self._target_names(t):
                        if name not in self.taint:
                            self.taint.add(name)
                            changed = True
            if not changed:
                return

    # -- fact scan ---------------------------------------------------------
    def _sync(self, sub: ast.Call) -> Optional[Tuple[str, str]]:
        """(op, target) when the call is an implicit host sync on a
        tainted value, else None."""
        ch = attr_chain(sub.func)
        if ch is not None:
            last = ch[-1]
            if (len(ch) == 1 and last in SCALAR_FNS and sub.args
                    and self._tainted(sub.args[0])):
                return f"{last}()", _desc(sub.args[0])
            if (len(ch) == 2 and ch[0] in NP_ROOTS
                    and last in ("asarray", "array") and sub.args
                    and self._tainted(sub.args[0])):
                return f"np.{last}()", _desc(sub.args[0])
        fn = sub.func
        if isinstance(fn, ast.Attribute) and fn.attr == "copy_" and not _non_blocking(sub):
            src = sub.args[0] if sub.args else next(
                (kw.value for kw in sub.keywords if kw.arg == "src"), None)
            if src is not None and self._tainted(src):
                return ".copy_()", _desc(src)
        if not (isinstance(fn, ast.Attribute) and self._tainted(fn.value)):
            return None
        if fn.attr in ("item", "tolist", "cpu", "numpy", "synchronize"):
            return f".{fn.attr}()", _desc(fn.value)
        if fn.attr == "to" and _to_cpu(sub):
            return '.to("cpu")', _desc(fn.value)
        return None

    def _device_sync(self, sub: ast.Call) -> Optional[str]:
        """The operation when the call waits for device work whatever its
        operands: torch.cuda.synchronize(), or .synchronize() on an
        untainted stream or event (a tainted one is a _sync)."""
        if self.aliases.root_bound(sub.func) and self.aliases.resolve(sub.func) == DEVICE_SYNC:
            return "torch.cuda.synchronize()"
        fn = sub.func
        if (isinstance(fn, ast.Attribute) and fn.attr == "synchronize"
                and not self._tainted(fn.value)):
            return f"{_desc(fn.value)}.synchronize()"
        return None

    def _tensor_valued(self, e: ast.AST) -> bool:
        """True when ``e`` is a tainted tensor or one computed from it, so
        that its truth test reads device state back."""
        if isinstance(e, (ast.Name, ast.Attribute, ast.Subscript, ast.Starred)):
            return self._tainted(e)
        if isinstance(e, ast.NamedExpr):
            return self._tensor_valued(e.value)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
                return False
            return any(self._tensor_valued(x) for x in [e.left, *e.comparators])
        if isinstance(e, ast.BinOp):
            return self._tensor_valued(e.left) or self._tensor_valued(e.right)
        if isinstance(e, ast.UnaryOp) and not isinstance(e.op, ast.Not):
            return self._tensor_valued(e.operand)
        if isinstance(e, ast.Call):
            ch = attr_chain(e.func)
            if ch is not None and len(ch) == 2 and ch[0] == "torch":
                return any(self._tensor_valued(a) for a in e.args)
            fn = e.func
            return (isinstance(fn, ast.Attribute) and fn.attr not in HOST_VALUED
                    and self._tensor_valued(fn.value))
        return False

    def _truth_tests(self):
        """(construct, expression) of every truth test in the function: the
        tests of if/while/assert/conditional expressions/comprehensions,
        the operand of ``not`` and the operands of ``and``/``or`` before
        the last (all of them when the BoolOp is itself tested)."""
        tested = []
        for sub in ast.walk(self.node):
            if isinstance(sub, (ast.If, ast.While, ast.Assert)):
                tested.append((type(sub).__name__.lower(), sub.test))
            elif isinstance(sub, ast.IfExp):
                tested.append(("conditional expression", sub.test))
            elif isinstance(sub, ast.comprehension):
                tested.extend(("comprehension if", t) for t in sub.ifs)
            elif isinstance(sub, ast.UnaryOp) and isinstance(sub.op, ast.Not):
                tested.append(("not", sub.operand))
            elif isinstance(sub, ast.BoolOp):
                tested.extend(("and/or", v) for v in sub.values[:-1])
        seen = set()
        while tested:
            what, e = tested.pop(0)
            if id(e) in seen:
                continue
            seen.add(id(e))
            if isinstance(e, ast.BoolOp):
                tested.extend((what, v) for v in e.values)
            elif isinstance(e, ast.IfExp):
                tested.extend([(what, e.body), (what, e.orelse)])
            elif not (isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Not)):
                yield what, e

    def _scan(self):
        f = self.facts
        hot = f.bound is not None
        for sub in ast.walk(self.node):
            if isinstance(sub, (ast.With, ast.AsyncWith)) and sub.body and any(
                    _sanctions(item.context_expr) for item in sub.items):
                f.scopes.append((sub.body[0].lineno,
                                 sub.body[-1].end_lineno or sub.body[-1].lineno))
        for sub in ast.walk(self.node):
            if isinstance(sub, ast.Call):
                span = _stmt_span(sub, self.parents)
                ch = attr_chain(sub.func)
                if ch is not None and ch[-1] in DEVICE_ENTRY_POINTS:
                    f.dispatches.append(span)
                sanctioned = f.in_scope(sub.lineno)
                sync = None if sanctioned else self._sync(sub)
                if sync is not None:
                    f.syncs.append(span + sync)
                dsync = None if sanctioned else self._device_sync(sub)
                if dsync is not None:
                    f.device_syncs.append(span + (dsync,))
                if hot and ch is not None and len(ch) == 2:
                    if ch[0] in NP_ROOTS and ch[1] in ALLOC_FNS:
                        f.allocs.append(span + (f"np.{ch[1]}",))
                    elif ch[0] == "torch" and ch[1] in TORCH_ALLOC_FNS:
                        f.allocs.append(span + (f"torch.{ch[1]}",))
                fn = sub.func
                if hot and isinstance(fn, ast.Attribute) and fn.attr == "tolist":
                    f.scalars.append(span + (f"{_desc(fn.value)}.tolist()",))
            elif isinstance(sub, ast.For):
                span = (sub.lineno, sub.iter.end_lineno or sub.lineno)
                if self._tainted(sub.iter) and not f.in_scope(sub.lineno):
                    f.syncs.append(span + ("iteration", _desc(sub.iter)))
                if hot:
                    kind, desc = _classify_iter(sub.iter)
                    f.loops.append(span + (kind, desc))
                    self._scalar_index_loop(sub, span)
        for what, e in self._truth_tests():
            if not f.in_scope(e.lineno) and self._tensor_valued(e):
                f.syncs.append(_stmt_span(e, self.parents)
                               + (f"truth test ({what})", _desc(e)))

    def _scalar_index_loop(self, loop: ast.For, span):
        """for i in range(...): ... x[i] ... — a per-row python indexing
        sweep where a vectorized slice/gather exists (HOT004)."""
        if not (isinstance(loop.target, ast.Name)
                and isinstance(loop.iter, ast.Call)):
            return
        ch = attr_chain(loop.iter.func)
        if not ch or ch[-1] != "range":
            return
        ivar = loop.target.id
        for sub in ast.walk(loop):
            if (isinstance(sub, ast.Subscript)
                    and isinstance(sub.slice, ast.Name)
                    and sub.slice.id == ivar):
                self.facts.scalars.append(
                    span + (f"python-int indexing loop over '{ivar}'",))
                return


def collect_hotpath(relpath: str, tree: ast.Module) -> ModuleHotFacts:
    """Per-file perfcheck facts."""
    aliases = Aliases()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            aliases.add_import(node)
        elif isinstance(node, ast.ImportFrom):
            aliases.add_import_from(node)
    mh = ModuleHotFacts(relpath=relpath)

    def add(node, qualname: str):
        mh.functions[qualname] = _FuncAnalysis(node, qualname, aliases).facts

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            add(node, node.name)
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    add(m, f"{node.name}.{m.name}")
    return mh


# ---------------------------------------------------------------------------
# Rule evaluation (per lint, over the per-file facts + the CallGraph)
# ---------------------------------------------------------------------------


def _last(qual: str) -> str:
    return qual.rsplit(".", 1)[-1]


_SANCTIONED_POINTS = "sync_ticket / _readback / a _sanctioned_sync scope"


def run_hotpath_rules(
    summaries: Dict[str, ModuleSummary],
    hot_facts: Dict[str, ModuleHotFacts],
    graph: Optional[CallGraph] = None,
) -> List[Finding]:
    """HOT001-HOT004 over per-file facts.  HOT001 is interprocedural:
    forward reachability from dispatch call sites through the CallGraph
    (never descending into a sanctioned sync function, nor from a call
    inside a sanctioned scope) names the dispatch->sync window chain each
    flagged sync sits inside."""
    graph = CallGraph(summaries) if graph is None else graph

    def facts_of(node) -> Optional[HotFuncFacts]:
        mh = hot_facts.get(node[0])
        return mh.functions.get(node[1]) if mh is not None else None

    roots = []
    for mh in hot_facts.values():
        for qual, ff in mh.functions.items():
            if _last(qual) in SANCTIONED_FNS:
                continue
            if any(not ff.in_scope(line) for line, _end in ff.dispatches):
                roots.append((mh.relpath, qual))

    fwd: Dict[tuple, List[tuple]] = {}
    for caller, span, callee in graph.edges():
        ff = facts_of(caller)
        if ff is not None and ff.in_scope(span[0]):
            continue  # the sanctioned scope covers its callees
        fwd.setdefault(caller, []).append(callee)

    reach = set(roots)
    via: Dict[tuple, tuple] = {}
    frontier = sorted(roots)
    while frontier:
        nxt = []
        for node in frontier:
            for callee in fwd.get(node, ()):
                if _last(callee[1]) in SANCTIONED_FNS:
                    continue  # window closes at the sanctioned boundary
                if callee not in reach:
                    reach.add(callee)
                    via[callee] = node
                    nxt.append(callee)
        frontier = sorted(set(nxt))

    def chain_of(node, limit: int = 8) -> List[str]:
        names = [node[1]]
        cur = node
        while cur in via and len(names) < limit:
            cur = via[cur]
            names.append(cur[1])
        return list(reversed(names))

    findings: List[Finding] = []
    for rp, mh in sorted(hot_facts.items()):
        for qual, ff in sorted(mh.functions.items()):
            if _last(qual) in SANCTIONED_FNS:
                continue
            node = (rp, qual)
            window = ("inside the dispatch->sync window (chain: "
                      + " -> ".join(chain_of(node)) + ")")
            for line, end, op, target in ff.syncs:
                where = window if node in reach else "on in-flight dispatch state"
                findings.append(Finding(
                    "HOT001", rp, line, 0,
                    f"'{qual}': {op} on '{target}' blocks the host "
                    f"{where}; readbacks belong in a sanctioned sync "
                    f"point ({_SANCTIONED_POINTS})",
                    end_line=end,
                ))
            if node in reach:
                for line, end, op in ff.device_syncs:
                    waits = ("waits for all work in flight" if op == "torch.cuda.synchronize()"
                             else "waits for the work queued before it")
                    findings.append(Finding(
                        "HOT001", rp, line, 0,
                        f"'{qual}': {op} {waits} and blocks the host {window}; "
                        f"readbacks belong in a sanctioned sync point "
                        f"({_SANCTIONED_POINTS})",
                        end_line=end,
                    ))
            if ff.bound is None:
                continue
            for line, end, kind, desc in ff.loops:
                over = (kind == "rows"
                        or (ff.bound == "const" and kind != "const"))
                if not over:
                    continue
                cost = ("O(history rows)" if kind == "rows"
                        else "data-dependent")
                findings.append(Finding(
                    "HOT002", rp, line, 0,
                    f"'{qual}' declares @hot_path(bound=\"{ff.bound}\") "
                    f"but loops over '{desc}' ({cost}); vectorize it or "
                    f"widen the declared bound",
                    end_line=end,
                ))
            for line, end, fn in ff.allocs:
                findings.append(Finding(
                    "HOT003", rp, line, 0,
                    f"'{qual}' is @hot_path(bound=\"{ff.bound}\") but "
                    f"allocates per call via {fn}; ride the engine's "
                    f"staging ring (engine_torch._StagingRing) or justify "
                    f"with a pragma",
                    end_line=end,
                ))
            for line, end, desc in ff.scalars:
                findings.append(Finding(
                    "HOT004", rp, line, 0,
                    f"'{qual}' is @hot_path(bound=\"{ff.bound}\") but "
                    f"scalarizes per row ({desc}); use a vectorized "
                    f"numpy or torch op",
                    end_line=end,
                ))
    return findings
