"""Module graph + call graph over per-file summaries.

The port's own copy of the reference package's ``tools/lint/graphs.py``.
Each file is reduced to a ModuleSummary (functions, classes, import
table, per-function call sites and direct wall-clock/entropy references,
DET101's taint sources); the linker (CallGraph) resolves cross-module
edges over the whole scan, for DET101, perfcheck, and the promise and
race families alike.

Resolution is name-based and deliberately modest: module-level functions,
classes (instantiation edges go to __init__ through the MRO), self/cls
method calls through single-inheritance bases, `v = ClassName(...)` local
instance types, `self.attr = ClassName(...)` attribute types, and
re-export chains through package __init__ import tables.  Unresolvable
calls contribute no edge: the interprocedural pass under-approximates
rather than guessing."""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .base import (
    Aliases,
    ClockRefVisitorMixin,
    SIMPLE_STMTS,
    attr_chain,
    innermost_simple_stmt_end,
)


def _name_chain(node: ast.AST) -> Optional[tuple]:
    """('p0', 'p1', ...) for a pure Name/Attribute chain."""
    parts = attr_chain(node)
    return tuple(parts) if parts is not None else None

# Call-site descriptors:
#   ("name", n)          bare call  n(...)
#   ("chain", (p0, p1, ...))  pure attribute-chain call  p0.p1....(...)
#   ("super", meth)      super().meth(...)
# Import-table entries:
#   ("mod", dotted)      import x / import a.b  (dotted scan-root-relative
#                        when in-project, else the external absolute name)
#   ("sym", module, name)  from module import name


def module_name_of(relpath: str) -> str:
    parts = relpath[:-3].split("/") if relpath.endswith(".py") else relpath.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


@dataclass
class FuncSummary:
    qualname: str                      # "f" or "Class.m"
    is_async: bool = False             # TSK001 judges only coroutines
    # (dotted, line, kind, span_end) per wall-clock/entropy reference;
    # span_end is the enclosing simple statement's last line, so a
    # sanctioning pragma works on any physical line of it, as suppression.
    refs: List[Tuple[str, int, str, int]] = field(default_factory=list)
    # ((line, end_line), descriptor) per call site; end_line is the
    # enclosing simple statement's last line.
    calls: List[Tuple[Tuple[int, int], tuple]] = field(default_factory=list)
    var_ctors: Dict[str, tuple] = field(default_factory=dict)


@dataclass
class ClassSummary:
    name: str
    bases: List[tuple] = field(default_factory=list)   # chain parts per base
    methods: Set[str] = field(default_factory=set)
    attr_ctors: Dict[str, tuple] = field(default_factory=dict)


@dataclass
class ModuleSummary:
    relpath: str
    module: str
    imports: Dict[str, tuple] = field(default_factory=dict)
    functions: Dict[str, FuncSummary] = field(default_factory=dict)
    classes: Dict[str, ClassSummary] = field(default_factory=dict)


def _resolve_relative(relpath: str, level: int, module: Optional[str]) -> str:
    """Scan-root-relative dotted target of a relative import."""
    parts = relpath[:-3].split("/")
    # Dropping the last segment is right for BOTH shapes: a module's
    # containing package, and an __init__'s own package.
    pkg = parts[:-1]
    # level=1 is the containing package; each extra level climbs one more.
    base = pkg[: len(pkg) - (level - 1)] if level - 1 <= len(pkg) else []
    tail = module.split(".") if module else []
    return ".".join(base + tail)


class _FuncCollector(ClockRefVisitorMixin, ast.NodeVisitor):
    """Per-function facts: direct wall/entropy references, call sites and
    local instance types.  Nested defs and lambdas FOLD into the enclosing
    function: their bodies execute (or are scheduled) from its context, so
    their clock reads and calls are its own."""

    def __init__(self, aliases: Aliases, func: FuncSummary,
                 stmt_spans: List[Tuple[int, int]] = ()):
        self.aliases = aliases
        self.func = func
        self.stmt_spans = stmt_spans

    def _on_clock_ref(self, node: ast.AST, path: str, kind: str):
        # The same walk and classifier (base.classify_clock_ref) as
        # DET001/DET002's direct sites in local.py.
        end = innermost_simple_stmt_end(node, self.stmt_spans)
        self.func.refs.append((path, node.lineno, kind, end))

    def visit_Call(self, node: ast.Call):
        f = node.func
        # Span through the enclosing simple statement, matching the
        # suppression scope.
        span = (node.lineno, innermost_simple_stmt_end(node, self.stmt_spans))
        if isinstance(f, ast.Name):
            self.func.calls.append((span, ("name", f.id)))
        elif (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Call)
            and isinstance(f.value.func, ast.Name)
            and f.value.func.id == "super"
        ):
            self.func.calls.append((span, ("super", f.attr)))
        else:
            chain = _name_chain(f)
            if chain is not None:
                self.func.calls.append((span, ("chain", chain)))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        # v = ClassName(...) / v = mod.Class(...): local instance type.
        if (
            len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Call)
        ):
            chain = _name_chain(node.value.func)
            if chain is not None:
                self.func.var_ctors[node.targets[0].id] = chain
        self.generic_visit(node)


def collect_summary(relpath: str, tree: ast.Module, root_pkg: Optional[str]) -> ModuleSummary:
    ms = ModuleSummary(relpath=relpath, module=module_name_of(relpath))
    aliases = Aliases()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            aliases.add_import(node)
        elif isinstance(node, ast.ImportFrom):
            aliases.add_import_from(node)

    def norm(dotted: str) -> str:
        if root_pkg and (dotted == root_pkg or dotted.startswith(root_pkg + ".")):
            return dotted[len(root_pkg):].lstrip(".")
        return dotted

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                ms.imports[a.asname or a.name.split(".")[0]] = (
                    ("mod", norm(a.name)) if a.asname else ("mod", norm(a.name.split(".")[0]))
                )
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = _resolve_relative(relpath, node.level, node.module)
            else:
                base = norm(node.module) if node.module else ""
            for a in node.names:
                if a.name == "*":
                    continue
                ms.imports[a.asname or a.name] = ("sym", base, a.name)

    def collect_func(node, qualname: str) -> FuncSummary:
        fs = FuncSummary(qualname=qualname,
                         is_async=isinstance(node, ast.AsyncFunctionDef))
        spans = [
            (s.lineno, s.end_lineno or s.lineno)
            for s in ast.walk(node)
            if isinstance(s, SIMPLE_STMTS)
        ]
        fc = _FuncCollector(aliases, fs, spans)
        for stmt in node.body:
            fc.visit(stmt)
        return fs

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ms.functions[node.name] = collect_func(node, node.name)
        elif isinstance(node, ast.ClassDef):
            cs = ClassSummary(name=node.name)
            for b in node.bases:
                chain = _name_chain(b)
                if chain is not None:
                    cs.bases.append(chain)
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qn = f"{node.name}.{m.name}"
                    cs.methods.add(m.name)
                    ms.functions[qn] = collect_func(m, qn)
                    # self.attr = ClassName(...) attribute types.
                    for stmt in ast.walk(m):
                        if (
                            isinstance(stmt, ast.Assign)
                            and len(stmt.targets) == 1
                            and isinstance(stmt.targets[0], ast.Attribute)
                            and isinstance(stmt.targets[0].value, ast.Name)
                            and stmt.targets[0].value.id == "self"
                            and isinstance(stmt.value, ast.Call)
                        ):
                            chain = _name_chain(stmt.value.func)
                            if chain is not None:
                                cs.attr_ctors.setdefault(stmt.targets[0].attr, chain)
            ms.classes[node.name] = cs
    return ms


class CallGraph:
    """Links ModuleSummaries into (relpath, qualname) -> callee edges."""

    _MAX_DEPTH = 8

    def __init__(self, summaries: Dict[str, ModuleSummary]):
        # Keyed by module dotted name for import resolution.
        self.by_module: Dict[str, ModuleSummary] = {
            s.module: s for s in summaries.values()
        }
        self.summaries = summaries

    # -- symbol resolution -------------------------------------------------
    def _lookup_symbol(self, module: str, name: str, depth: int = 0):
        """Resolve `name` exported by `module` to ("func", ms, qualname) |
        ("class", ms, classname) | ("mod", ms, None) | None, chasing
        re-exports."""
        if depth > self._MAX_DEPTH:
            return None
        ms = self.by_module.get(module)
        if ms is None:
            return None
        if name in ms.classes:
            return ("class", ms, name)
        if name in ms.functions and "." not in name:
            return ("func", ms, name)
        imp = ms.imports.get(name)
        if imp is not None:
            if imp[0] == "sym":
                got = self._lookup_symbol(imp[1], imp[2], depth + 1)
                if got is not None:
                    return got
                if f"{imp[1]}.{imp[2]}" in self.by_module or (
                    not imp[1] and imp[2] in self.by_module
                ):
                    sub = f"{imp[1]}.{imp[2]}" if imp[1] else imp[2]
                    return ("mod", self.by_module[sub], None)
            elif imp[0] == "mod" and imp[1] in self.by_module:
                return ("mod", self.by_module[imp[1]], None)
        # `from pkg import submodule` styled as sym but naming a module.
        sub = f"{module}.{name}" if module else name
        if sub in self.by_module:
            return ("mod", self.by_module[sub], None)
        return None

    def _mro_method(self, ms: ModuleSummary, classname: str, meth: str,
                    depth: int = 0):
        """(ms, qualname) for `meth` on `classname` or its bases."""
        if depth > self._MAX_DEPTH:
            return None
        cs = ms.classes.get(classname)
        if cs is None:
            return None
        if meth in cs.methods:
            return (ms, f"{classname}.{meth}")
        for base in cs.bases:
            got = self._resolve_class_chain(ms, base)
            if got is not None:
                bms, bname = got
                found = self._mro_method(bms, bname, meth, depth + 1)
                if found is not None:
                    return found
        return None

    def _resolve_class_chain(self, ms: ModuleSummary, chain: tuple):
        """(ms, classname) for a chain like ("ClassName",) or
        ("alias", "ClassName") in module `ms`'s namespace."""
        if len(chain) == 1:
            if chain[0] in ms.classes:
                return (ms, chain[0])
            got = self._lookup_symbol(ms.module, chain[0])
            if got is not None and got[0] == "class":
                return (got[1], got[2])
            return None
        got = self._lookup_symbol(ms.module, chain[0])
        if got is None:
            return None
        kind, target, name = got
        if kind == "mod" and len(chain) == 2:
            inner = self._lookup_symbol(target.module, chain[1])
            if inner is not None and inner[0] == "class":
                return (inner[1], inner[2])
        return None

    def _class_node(self, ms: ModuleSummary, classname: str):
        """Instantiation edge target: __init__ through the MRO."""
        return self._mro_method(ms, classname, "__init__")

    # -- call-site resolution ---------------------------------------------
    def resolve_call(self, ms: ModuleSummary, caller_qual: str, desc: tuple):
        """(relpath, qualname) of the callee, or None."""
        cls = caller_qual.split(".")[0] if "." in caller_qual else None
        fs = ms.functions.get(caller_qual)
        kind = desc[0]
        if kind == "name":
            n = desc[1]
            if n in ms.functions and "." not in n:
                return (ms.relpath, n)
            got = self._lookup_symbol(ms.module, n)
            if got is None:
                return None
            if got[0] == "func":
                return (got[1].relpath, got[2])
            if got[0] == "class":
                init = self._class_node(got[1], got[2])
                if init is not None:
                    return (init[0].relpath, init[1])
            return None
        if kind == "super":
            if cls is None:
                return None
            cs = ms.classes.get(cls)
            if cs is None:
                return None
            for base in cs.bases:
                got = self._resolve_class_chain(ms, base)
                if got is not None:
                    found = self._mro_method(got[0], got[1], desc[1])
                    if found is not None:
                        return (found[0].relpath, found[1])
            return None
        chain = desc[1]
        root = chain[0]
        if root in ("self", "cls") and cls is not None:
            if len(chain) == 2:
                found = self._mro_method(ms, cls, chain[1])
                return (found[0].relpath, found[1]) if found else None
            if len(chain) == 3:
                # self.attr.m(): via the class's attribute ctor types.
                ctor = self._attr_ctor(ms, cls, chain[1])
                if ctor is not None:
                    got = self._resolve_class_chain(ctor[0], ctor[1])
                    if got is not None:
                        found = self._mro_method(got[0], got[1], chain[2])
                        if found is not None:
                            return (found[0].relpath, found[1])
            return None
        if fs is not None and root in fs.var_ctors and len(chain) == 2:
            got = self._resolve_class_chain(ms, fs.var_ctors[root])
            if got is not None:
                found = self._mro_method(got[0], got[1], chain[1])
                if found is not None:
                    return (found[0].relpath, found[1])
            return None
        if root in ms.classes and len(chain) == 2:
            found = self._mro_method(ms, root, chain[1])
            return (found[0].relpath, found[1]) if found else None
        got = self._lookup_symbol(ms.module, root)
        if got is None:
            return None
        kind2, target, name = got
        if kind2 == "mod":
            if len(chain) == 2:
                inner = self._lookup_symbol(target.module, chain[1])
                if inner is not None:
                    if inner[0] == "func":
                        return (inner[1].relpath, inner[2])
                    if inner[0] == "class":
                        init = self._class_node(inner[1], inner[2])
                        if init is not None:
                            return (init[0].relpath, init[1])
            elif len(chain) == 3:
                inner = self._lookup_symbol(target.module, chain[1])
                if inner is not None and inner[0] == "class":
                    found = self._mro_method(inner[1], inner[2], chain[2])
                    if found is not None:
                        return (found[0].relpath, found[1])
            return None
        if kind2 == "class" and len(chain) == 2:
            found = self._mro_method(target, name, chain[1])
            return (found[0].relpath, found[1]) if found else None
        return None

    def _attr_ctor(self, ms: ModuleSummary, classname: str, attr: str,
                   depth: int = 0):
        """(defining ModuleSummary, ctor chain) for self.<attr>, walking
        bases for attributes assigned by an inherited __init__."""
        if depth > self._MAX_DEPTH:
            return None
        cs = ms.classes.get(classname)
        if cs is None:
            return None
        if attr in cs.attr_ctors:
            return (ms, cs.attr_ctors[attr])
        for base in cs.bases:
            got = self._resolve_class_chain(ms, base)
            if got is not None:
                found = self._attr_ctor(got[0], got[1], attr, depth + 1)
                if found is not None:
                    return found
        return None

    def edges(self):
        """Yield ((caller_relpath, caller_qual), (line, end_line),
        (callee_relpath, callee_qual)) for every resolvable call site."""
        for ms in self.summaries.values():
            for qual, fs in ms.functions.items():
                for span, desc in fs.calls:
                    callee = self.resolve_call(ms, qual, desc)
                    if callee is not None and in_nodes(self.summaries, callee):
                        yield ((ms.relpath, qual), span, callee)


def in_nodes(summaries: Dict[str, ModuleSummary], node) -> bool:
    ms = summaries.get(node[0])
    return ms is not None and node[1] in ms.functions
