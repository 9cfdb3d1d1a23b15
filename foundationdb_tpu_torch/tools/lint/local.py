"""fdblint's per-module (intra-procedural) rules over the port.

The port's own copy of the reference package's ``tools/lint/local.py``
(``ModuleLinter``), cut to the families that apply to the port:
DET001/DET002/DET003, ACT001, IO001, TRC001, SPN001, ERR001 and ENV001.
JAX001 is gone (the port has no traced code), and ENV001 has no registry
exemption: the port has no knob registry, so any ``FDB_TPU_*`` read is a
finding.  Findings are produced UNFILTERED: the allowlist and pragmas are
applied by runner.py after every pass has run.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from .base import (
    Aliases,
    ClockRefVisitorMixin,
    ENTROPY_MODULES,
    ENV_FLAG_PREFIX,
    Finding,
    IO_CALLS,
    IO_MODULES,
    SIMPLE_STMTS,
    THREADING_MODULES,
    WALL_CLOCK,
    innermost_simple_stmt_end,
)


class ModuleLinter(ClockRefVisitorMixin, ast.NodeVisitor):
    def __init__(self, relpath: str, tree: ast.Module):
        self.relpath = relpath
        self.tree = tree
        self.aliases = Aliases()
        self.findings: List[Finding] = []
        # Simple-statement line spans: a pragma anywhere on the physical
        # lines of the statement holding a flagged expression counts.
        self.stmt_spans: List[Tuple[int, int]] = []
        # ACT001 name scoping: a bare `foo()` statement matches only
        # module-level async functions; `self.foo()` / `cls.foo()` only
        # async methods of the ENCLOSING class.  Matching any attribute
        # call by name alone would cross-fire on generic names (`set`,
        # `sync`) of unrelated objects and between classes.
        self.async_funcs: Set[str] = set()
        # (class start line, class end line, async method names) per class
        self.class_spans: List[Tuple[int, int, Set[str]]] = []

    # -- emit --
    def flag(self, rule: str, node: ast.AST, message: str,
             end_line: Optional[int] = None):
        if end_line is None:
            # Pragma scope: through the end of the innermost SIMPLE
            # statement holding the node.
            end_line = innermost_simple_stmt_end(node, self.stmt_spans)
        self.findings.append(
            Finding(rule, self.relpath, node.lineno, node.col_offset, message,
                    end_line=end_line)
        )

    def prepass(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                self.aliases.add_import(node)
            elif isinstance(node, ast.ImportFrom):
                self.aliases.add_import_from(node)
            if isinstance(node, SIMPLE_STMTS):
                self.stmt_spans.append((node.lineno, node.end_lineno or node.lineno))
        self._collect_async_defs(self.tree, in_class=False)

    def _collect_async_defs(self, node: ast.AST, in_class: bool):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.AsyncFunctionDef):
                if not in_class:
                    self.async_funcs.add(child.name)
                self._collect_async_defs(child, in_class=False)
            elif isinstance(child, ast.ClassDef):
                names = {m.name for m in child.body if isinstance(m, ast.AsyncFunctionDef)}
                self.class_spans.append((child.lineno, child.end_lineno or child.lineno, names))
                self._collect_async_defs(child, in_class=True)
            else:
                self._collect_async_defs(child, in_class=in_class)

    def _enclosing_class_async_methods(self, lineno: int) -> Set[str]:
        """Async method names of the innermost class holding `lineno`."""
        best = None
        for start, end, names in self.class_spans:
            if start <= lineno <= end and (best is None or start > best[0]):
                best = (start, names)
        return best[1] if best else set()

    # -- imports: DET002, DET003, IO001, DET001 --
    def visit_Import(self, node: ast.Import):
        for a in node.names:
            top = a.name.split(".")[0]
            if top in ENTROPY_MODULES:
                self.flag("DET002", node, f"import of entropy module '{a.name}'")
            if top in THREADING_MODULES or a.name in THREADING_MODULES:
                self.flag("DET003", node, f"import of '{a.name}'")
            if top in IO_MODULES:
                self.flag("IO001", node, f"import of '{a.name}'")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module is not None and not node.level:
            top = node.module.split(".")[0]
            if top in ENTROPY_MODULES:
                self.flag("DET002", node, f"import from entropy module '{node.module}'")
            if top in THREADING_MODULES or node.module in THREADING_MODULES:
                self.flag("DET003", node, f"import from '{node.module}'")
            if top in IO_MODULES:
                self.flag("IO001", node, f"import from '{node.module}'")
            for a in node.names:
                if f"{node.module}.{a.name}" in WALL_CLOCK:
                    self.flag("DET001", node,
                              f"import of wall-clock '{node.module}.{a.name}'")
        self.generic_visit(node)

    def _on_clock_ref(self, node: ast.AST, path: str, kind: str):
        # The same walk and classifier as DET101's taint sources
        # (graphs.py), so direct flags and sources cannot drift.
        if kind == "wall":
            self.flag("DET001", node, f"wall-clock '{path}'")
        else:
            self.flag("DET002", node, f"entropy source '{path}'")

    # -- ENV001: any FDB_TPU_* environment read --
    def visit_Subscript(self, node: ast.Subscript):
        if self.aliases.resolve(node.value) == "os.environ":
            self._check_env_key(node, node.slice)
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare):
        # `"FDB_TPU_X" in os.environ`: presence-gating is a read.
        for op, cmp in zip(node.ops, node.comparators):
            if isinstance(op, (ast.In, ast.NotIn)) and self.aliases.resolve(cmp) == "os.environ":
                self._check_env_key(node, node.left)
        self.generic_visit(node)

    def _check_env_key(self, node: ast.AST, key: ast.AST):
        if (isinstance(key, ast.Constant) and isinstance(key.value, str)
                and key.value.startswith(ENV_FLAG_PREFIX)):
            self.flag("ENV001", node,
                      f"'{key.value}' read: the port has no flags (take a "
                      f"constructor argument with the reference's default)")

    def visit_Call(self, node: ast.Call):
        path = self.aliases.resolve(node.func)
        if path is not None and path in IO_CALLS and (
            path == "open" or self.aliases.root_bound(node.func)
        ):
            self.flag("IO001", node, f"direct '{path}()' call")
        if path in ("os.getenv", "os.environ.get", "os.environ.setdefault",
                    "os.environ.pop") and node.args:
            self._check_env_key(node, node.args[0])
        self.generic_visit(node)

    # -- ERR001: silent broad excepts --
    _BROAD_EXC = {"Exception", "BaseException",
                  "builtins.Exception", "builtins.BaseException"}

    def _is_broad_except(self, t: Optional[ast.AST]) -> bool:
        if t is None:
            return True  # bare `except:`
        if isinstance(t, ast.Tuple):
            return any(self._is_broad_except(e) for e in t.elts)
        return self.aliases.resolve(t) in self._BROAD_EXC

    def _handler_surfaces_error(self, node: ast.ExceptHandler) -> bool:
        """True when the handler visibly deals with the error: re-raises
        (anywhere in its body), TraceEvents it, forwards it via
        send_error, or reads the bound exception name."""
        for stmt in node.body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Raise):
                    return True
                if node.name and isinstance(n, ast.Name) and n.id == node.name:
                    return True
                if isinstance(n, ast.Call):
                    if isinstance(n.func, ast.Attribute) and n.func.attr == "send_error":
                        return True
                    path = self.aliases.resolve(n.func)
                    if path is not None and path.split(".")[-1] == "TraceEvent":
                        return True
        return False

    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if self._is_broad_except(node.type) and not self._handler_surfaces_error(node):
            caught = "except:" if node.type is None else (
                f"except {self.aliases.resolve(node.type) or '...'}")
            # Pragma scope: the `except` line only; the handler body must
            # not become one suppression region.
            self.flag("ERR001", node,
                      f"'{caught}' swallows errors silently "
                      f"(re-raise, TraceEvent, or propagate the error)",
                      end_line=node.lineno)
        self.generic_visit(node)

    # -- ACT001, TRC001, SPN001: statement-level calls --
    def visit_Expr(self, node: ast.Expr):
        v = node.value
        if isinstance(v, ast.Call):
            # ACT001: a statement-level call of a local async def whose
            # coroutine object is dropped on the floor.
            dropped = None
            if isinstance(v.func, ast.Name) and v.func.id in self.async_funcs:
                dropped = v.func.id
            elif (isinstance(v.func, ast.Attribute) and isinstance(v.func.value, ast.Name)
                    and v.func.value.id in ("self", "cls")
                    and v.func.attr in self._enclosing_class_async_methods(node.lineno)):
                dropped = v.func.attr
            if dropped is not None:
                self.flag("ACT001", node,
                          f"coroutine '{dropped}()' is neither awaited nor spawned "
                          f"(dropped actor)")
            self._check_dropped_chain(
                node, node.value, "TraceEvent", "log", "TRC001",
                "TraceEvent built but never .log()ed nor used as a context "
                "manager (dropped event)")
            self._check_dropped_chain(
                node, node.value, "begin_span", "end", "SPN001",
                "begin_span(...) result neither context-managed, .end()ed, "
                "nor stored (leaked open span)")
        self.generic_visit(node)

    def _check_dropped_chain(self, stmt: ast.Expr, call: ast.Call, ctor: str,
                             closer: str, rule: str, message: str):
        """A statement-level `ctor(...).m1(...)...` builder chain whose
        methods never include `closer` is dropped on the floor.  Stored
        results and the `with` form never arrive here."""
        methods: List[str] = []
        c: ast.AST = call
        while isinstance(c, ast.Call):
            path = self.aliases.resolve(c.func)
            if path is not None and path.split(".")[-1] == ctor:
                if closer not in methods:
                    self.flag(rule, stmt, message)
                return
            if not isinstance(c.func, ast.Attribute):
                return
            methods.append(c.func.attr)
            c = c.func.value

    def run(self) -> List[Finding]:
        self.prepass()
        self.visit(self.tree)
        return self.findings
