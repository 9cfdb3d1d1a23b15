"""fdblint's actor families in the port (foundationdb_tpu_torch/tools/lint/:
local.py's ACT001, waitrules.py's WAIT001/002, rpy.py's RPY001,
promises.py's PRM001-004 and TSK001, races.py's RACE001-004), held to the
reference's fdblint (foundationdb_tpu/tools/lint/).

The differential: on the reference's own corpus, the port's gate gives the
reference's (rule, file, line, suppressed) findings.  The corpus is the
inline sources of tests/test_lint.py's ACT001, WAIT001/002 and RPY001
tests and of tests/test_promises_lint.py's tests (read from their source,
not imported), and the case packages tests/lint_cases/{wait_rules,
rpy_cases,prm_cases,race_cases} (read as data).  The stated exceptions
are in EXCEPTIONS: race_cases/flow/knobs.py's ENV002 (the port has no
knob registry, so no ENV002), and the reference tests that need its fact
cache, ``--changed-only`` or a single-file mode, which the port's gate
does not have.  Then pragma hygiene for the new rules, and one plant of
each new rule in a copy of the port (one scan of the copy), each giving
exactly its rule, as the reference's fdblint does too.
"""

import ast
import pathlib
import shutil
from collections import Counter

import pytest

from foundationdb_tpu.tools.lint.base import LintConfig as RefLintConfig
from foundationdb_tpu.tools.lint.project import lint_source as ref_lint_source
from foundationdb_tpu.tools.lint.runner import run_source_tools as ref_run_source_tools
from foundationdb_tpu_torch.tools.lint import base, runner

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "foundationdb_tpu_torch"
REF_CASES = REPO / "tests" / "lint_cases"

NEW_RULES = ("ACT001", "WAIT001", "WAIT002", "RPY001", "PRM001", "PRM002", "PRM003",
             "PRM004", "TSK001", "RACE001", "RACE002", "RACE003", "RACE004")
COMPARED = tuple(base.RULES)

# The reference tests the corpus leaves out, and why.
EXCEPTIONS = {
    ("test_lint.py", "test_changed_only_survives_missing_git"):
        "--changed-only: the port's gate has no git filter",
    ("test_promises_lint.py", "test_prm_rules_registered_and_documented"):
        "the registry, not a corpus case (test_registry_holds_the_new_rules)",
    ("test_promises_lint.py", "test_editing_producer_clears_and_raises_consumer_prm001"):
        "the reference's fact cache: the port's gate has none (every scan reads the tree)",
    ("test_promises_lint.py", "test_changed_only_reports_consumer_side_finding"):
        "--changed-only: the port's gate has no git filter",
    ("test_promises_lint.py", "test_single_file_mode_sees_cross_file_senders"):
        "a single-file mode over the reference's own package: the port's gate has none",
    ("test_promises_lint.py", "test_sarif_declares_prm_rules"):
        "prm_cases through the CLI: test_case_packages_give_the_reference_findings "
        "and test_sarif_over_prm_cases",
    ("test_promises_lint.py", "test_package_clean_and_prm_counts_printed"):
        "the reference's own package: the port's tree is test_torch_fdblint.py's",
    ("test_promises_lint.py", "test_pipeline_and_recovery_paths_lint_clean_single_file"):
        "a single-file mode over the reference's own modules: the port's gate has none",
    ("test_promises_lint.py", "test_standalone_file_mode_skips_project_global_attr_rules"):
        "a standalone-file mode (a module outside any package): the port's gate has none",
}
# race_cases' ENV002 finding, which the port does not give.
ENV002_EXCEPTION = ("ENV002", "flow/knobs.py", 12, False)


def _eval_str(node, env):
    """A string constant, a name bound to one, `a + b` of two, or
    `<str>.replace(a, b)`."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left, right = _eval_str(node.left, env), _eval_str(node.right, env)
        return None if None in (left, right) else left + right
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "replace" and len(node.args) == 2):
        base_s = _eval_str(node.func.value, env)
        a, b = (_eval_str(x, env) for x in node.args)
        if None not in (base_s, a, b):
            return base_s.replace(a, b)
    return None


def _inline_cases(fname, names):
    """(test, source, path) of every lint_source(src, path) call in the
    `names` functions of tests/`fname`."""
    tree = ast.parse((REPO / "tests" / fname).read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    out = []
    for name in names:
        env = {}
        for node in ast.walk(funcs[name]):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                val = _eval_str(node.value, env)
                if val is not None:
                    env[node.targets[0].id] = val
        for node in ast.walk(funcs[name]):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "lint_source" and len(node.args) == 2):
                src, path = (_eval_str(a, env) for a in node.args)
                assert src is not None and path is not None, name
                out.append((name, src, path))
    return out


def _test_names(fname):
    tree = ast.parse((REPO / "tests" / fname).read_text())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]


# test_lint.py's tests of the new families: ACT001, WAIT001/002, RPY001.
LINT_TESTS = [n for n in _test_names("test_lint.py")
              if n.split("_")[1] in ("act001", "wait001", "wait002", "wait", "rpy001")]
PROMISE_TESTS = [n for n in _test_names("test_promises_lint.py")
                 if ("test_promises_lint.py", n) not in EXCEPTIONS]
INLINE = (_inline_cases("test_lint.py", LINT_TESTS)
          + _inline_cases("test_promises_lint.py", PROMISE_TESTS))


def _rows(findings):
    return sorted((f.rule, f.path, f.line, f.suppressed) for f in findings
                  if f.rule in COMPARED)


def _expected(case_dir):
    out = set()
    for path in sorted(case_dir.rglob("*.py")):
        rel = path.relative_to(case_dir).as_posix()
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if "# EXPECT:" in line:
                for rule in line.split("# EXPECT:")[1].split(","):
                    out.add((rel, i, rule.strip()))
    return out


# ---------------------------------------------------------------------------
# the differential against the reference
# ---------------------------------------------------------------------------


def test_the_inline_corpus_is_read_whole():
    assert len(LINT_TESTS) == 25 and len(PROMISE_TESTS) == 16
    assert len(INLINE) == 50
    # Every test of the two files is in the corpus or a named exception.
    for fname, tests in (("test_lint.py", LINT_TESTS), ("test_promises_lint.py", PROMISE_TESTS)):
        read = {name for name, _s, _p in INLINE} & set(tests)
        assert read == set(tests), set(tests) - read
    assert all(name in _test_names(f) for f, name in EXCEPTIONS)
    # Every new rule is exercised by the corpus.
    fired = {f.rule for _n, src, path in INLINE for f in ref_lint_source(src, path)}
    assert set(NEW_RULES) - {"RACE001", "RACE002", "RACE003", "RACE004"} <= fired


@pytest.mark.parametrize("case", range(len(INLINE)),
                         ids=[f"{n}-{i}" for i, (n, _s, _p) in enumerate(INLINE)])
def test_inline_corpus_gives_the_reference_findings(case):
    name, src, path = INLINE[case]
    got = runner.lint_source(src, path, tools=("fdblint",))
    assert _rows(got) == _rows(ref_lint_source(src, path)), name
    assert {f.rule for f in got} <= set(COMPARED)


@pytest.mark.parametrize("case", ["wait_rules", "rpy_cases", "prm_cases", "race_cases"])
def test_case_packages_give_the_reference_findings(case):
    case_dir = REF_CASES / case
    got = runner.run_fdblint(str(case_dir))
    want = ref_run_source_tools(str(case_dir), RefLintConfig(), tools=("fdblint",),
                                use_cache=False)["fdblint"]
    missing = Counter(_rows(want)) - Counter(_rows(got))
    if case == "race_cases":
        # The stated exception: the reference's dead-flag rule over its
        # registry module, a rule the port does not have.
        assert [(f.rule, f.path, f.line, f.suppressed) for f in want
                if f.rule not in COMPARED] == [ENV002_EXCEPTION]
    assert not missing
    assert _rows(got) == _rows(want)
    unsuppressed = {(f.path, f.line, f.rule) for f in got if not f.suppressed}
    expected = _expected(case_dir)
    if case == "race_cases":
        expected.discard(("flow/knobs.py", 12, "ENV002"))
    assert unsuppressed == expected
    assert {f.rule for f in got} <= set(COMPARED)


def test_sarif_over_prm_cases(capsys):
    """The twin of test_promises_lint.py's SARIF test: the port's gate over
    prm_cases declares and flags every PRM/TSK rule, and carries each
    reasoned suppression as a justified SARIF suppression."""
    import json

    rc = runner.main([str(REF_CASES / "prm_cases"), "--format=sarif", "--show-suppressed"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    run = out["runs"][0]
    prm = {"PRM001", "PRM002", "PRM003", "PRM004", "TSK001"}
    assert prm <= {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert prm <= {r["ruleId"] for r in run["results"] if r["level"] == "error"}
    sup = [r for r in run["results"] if r.get("suppressions")]
    assert sup and all(s["suppressions"][0]["justification"] for s in sup)


def test_registry_holds_the_new_rules():
    from foundationdb_tpu.tools.lint.base import DEFAULT_ALLOW as REF_ALLOW
    from foundationdb_tpu.tools.lint.base import RPY_MODULE_GLOBS as REF_RPY
    from foundationdb_tpu.tools.lint.base import RULES as REF_RULES
    from foundationdb_tpu.tools.lint.promises import HARMLESS_ATTRS, PROMISE_CTORS, SEND_OPS
    from foundationdb_tpu_torch.tools.lint import promises

    for rule in NEW_RULES:
        assert base.RULES[rule] == REF_RULES[rule]
        # Exempt in tools/ and in the blob store exactly where the
        # reference exempts them.
        assert base.allows(rule, "tools/x.py") == ("tools/*.py" in REF_ALLOW[rule])
        assert base.allows(rule, "fileio/blobstore.py") == (
            "fileio/blobstore.py" in REF_ALLOW[rule])
        assert not base.allows(rule, "server/x.py")
    assert base.RPY_MODULE_GLOBS == REF_RPY
    assert set(REF_RULES) - set(base.RULES) == {"JAX001", "ENV002", "HOT001", "HOT002",
                                                 "HOT003", "HOT004"}
    # The port's own flow/future.py and rpc/stream.py types and ops.
    from foundationdb_tpu_torch.flow import future
    from foundationdb_tpu_torch.rpc import stream

    assert set(promises.PROMISE_CTORS) == {"Promise", "PromiseStream"}
    assert all(hasattr(future, name) for name in promises.PROMISE_CTORS)
    for op in promises.SEND_OPS:
        assert any(hasattr(t, op) for t in (future.Promise, future.PromiseStream,
                                            stream.Reply, stream.RequestStream))
    assert hasattr(future.Promise(), "future") and hasattr(future.PromiseStream, "pop")
    assert (promises.PROMISE_CTORS, promises.SEND_OPS, promises.HARMLESS_ATTRS) == (
        PROMISE_CTORS, SEND_OPS, HARMLESS_ATTRS)


# ---------------------------------------------------------------------------
# pragma hygiene
# ---------------------------------------------------------------------------


def test_pragma_without_reason_is_prg001_and_stale_is_prg002():
    """A reasonless pragma still suppresses but adds PRG001; a pragma of each
    new rule on a line with nothing to suppress is PRG002 (stale)."""
    src = ("class R:\n"
           "    def mut(self):\n"
           "        self.d['k'] = 1\n"
           "    async def bad(self, loop):\n"
           "        snap = self.d\n"
           "        await loop.delay(1)\n"
           "        return snap['k']  # fdblint: ignore[WAIT001]\n")
    stale = "".join(f"V{i} = {i}  # fdblint: ignore[{rule}]: nothing to suppress here\n"
                    for i, rule in enumerate(NEW_RULES))
    found = runner.lint_source(src + stale, "server/x.py", tools=("fdblint",))
    got = sorted((f.rule, f.line, f.suppressed) for f in found)
    assert got == sorted([("WAIT001", 7, True), ("PRG001", 7, False)]
                         + [("PRG002", 8 + i, False) for i in range(len(NEW_RULES))])
    assert _rows(found) == _rows(ref_lint_source(src + stale, "server/x.py"))


# ---------------------------------------------------------------------------
# one plant of each new rule in a copy of the port
# ---------------------------------------------------------------------------

PLANTS = {
    "ACT001": ("server/_planted_act001.py",
               "class PlantedRole:\n"
               "    async def _run(self):\n"
               "        return 1\n\n"
               "    def start(self):\n"
               "        self._run()\n"),
    "WAIT001": ("server/_planted_wait001.py",
                "class PlantedCapture:\n"
                "    def mut(self):\n"
                "        self.d['k'] = 1\n\n"
                "    async def bad(self, loop):\n"
                "        snap = self.d\n"
                "        await loop.delay(1)\n"
                "        return snap['k']\n"),
    "WAIT002": ("server/_planted_wait002.py",
                "class PlantedIteration:\n"
                "    def mut(self):\n"
                "        self.d.update({})\n\n"
                "    async def bad(self, loop):\n"
                "        for k in self.d:\n"
                "            await loop.delay(1)\n"),
    "RPY001": ("server/_planted_rpy001.py",
               "async def planted_handler(req, reply):\n"
               "    if req is None:\n"
               "        return\n"
               "    reply.send(req)\n"),
    "PRM001": ("flow/_planted_prm001.py",
               "from .future import Promise\n\n\n"
               "class PlantedGate:\n"
               "    def __init__(self):\n"
               "        self.planted_gate = Promise()\n\n"
               "    async def wait(self):\n"
               "        await self.planted_gate.future\n"),
    "PRM002": ("flow/_planted_prm002.py",
               "from .future import Promise\n\n\n"
               "def planted_drop(cond):\n"
               "    p = Promise()\n"
               "    if cond:\n"
               "        return None\n"
               "    p.send(1)\n"),
    "PRM003": ("server/_planted_prm003.py",
               "from ..flow.future import Promise\n\n\n"
               "class PlantedCycle:\n"
               "    def __init__(self):\n"
               "        self.planted_x = Promise()\n"
               "        self.planted_y = Promise()\n\n"
               "    async def a(self):\n"
               "        await self.planted_y.future\n"
               "        self.planted_x.send(1)\n\n"
               "    async def b(self):\n"
               "        await self.planted_x.future\n"
               "        self.planted_y.send(1)\n"),
    "PRM004": ("server/_planted_prm004.py",
               "from ..flow.future import PromiseStream\n\n\n"
               "class PlantedPipe:\n"
               "    def __init__(self):\n"
               "        self.planted_q = PromiseStream()\n\n"
               "    async def consume(self, out):\n"
               "        while True:\n"
               "            out.append(await self.planted_q.pop())\n\n"
               "    async def produce(self, items):\n"
               "        for it in items:\n"
               "            self.planted_q.send(it)\n"),
    "TSK001": ("server/_planted_tsk001.py",
               "async def _planted_fragile(loop):\n"
               "    await loop.delay(1)\n\n\n"
               "def planted_go(loop):\n"
               "    loop.spawn(_planted_fragile(loop), 'fragile')\n"),
    "RACE001": ("server/_planted_race001.py",
                "class PlantedCounter:\n"
                "    def __init__(self):\n"
                "        self.n = 0\n\n"
                "    async def bump(self, loop):\n"
                "        cached = self.n\n"
                "        await loop.delay(0.1)\n"
                "        self.n = cached + 1\n"),
    "RACE002": ("server/_planted_race002.py",
                "class PlantedRegistry:\n"
                "    def __init__(self):\n"
                "        self.leader = None\n\n"
                "    async def elect(self, loop, who):\n"
                "        if self.leader is None:\n"
                "            await loop.delay(0.1)\n"
                "            self.leader = who\n"),
    "RACE003": ("server/_planted_race003.py",
                "class PlantedLedger:\n"
                "    def __init__(self):\n"
                "        self.entries = []\n"
                "        self.total = 0\n\n"
                "    async def credit(self, loop, amount):\n"
                "        self.entries = self.entries + [amount]\n"
                "        self.total = self.total + amount\n\n"
                "    async def debit(self, loop, amount):\n"
                "        self.entries = self.entries + [-amount]\n"
                "        self.total = self.total - amount\n\n"
                "    async def torn(self, loop, amount):\n"
                "        self.entries = self.entries + [amount]\n"
                "        await loop.delay(0.1)\n"
                "        self.total = self.total + amount\n"),
    "RACE004": ("server/_planted_race004.py",
                "class PlantedShared:\n"
                "    def __init__(self):\n"
                "        self.table = ()\n\n"
                "    async def rebuild(self, loop):\n"
                "        size = len(self.table)\n"
                "        await loop.delay(0.1)\n"
                "        self.table = tuple(range(size))\n\n"
                "    async def install(self, loop, t):\n"
                "        self.table = t\n"),
}


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """One copy of the port with every plant, scanned once by the port's
    gate and once by the reference's fdblint."""
    copy = tmp_path_factory.mktemp("plants") / "foundationdb_tpu_torch"
    shutil.copytree(PORT, copy, ignore=shutil.ignore_patterns("__pycache__", "_build"))
    for rel, src in PLANTS.values():
        (copy / rel).write_text(src)
    port = runner.run_fdblint(str(copy))
    ref = ref_run_source_tools(str(copy), RefLintConfig(), tools=("fdblint",),
                               use_cache=False)["fdblint"]
    return port, ref


def test_plants_cover_every_new_rule():
    assert sorted(PLANTS) == sorted(NEW_RULES)


@pytest.mark.parametrize("rule", NEW_RULES)
def test_each_plant_gives_exactly_its_rule(rule, planted):
    port, ref = planted
    rel = PLANTS[rule][0]
    found = [f for f in port if f.path == rel]
    assert found and {f.rule for f in found} == {rule}, [f.format() for f in found]
    assert not any(f.suppressed for f in found)
    assert _rows(found) == _rows(f for f in ref if f.path == rel)


def test_the_plants_are_the_copy_s_only_findings(planted):
    port, ref = planted
    plants = {rel for rel, _src in PLANTS.values()}
    assert {f.path for f in port if not f.suppressed} == plants
    assert _rows(port) == _rows(ref)
    assert Counter(f.rule for f in port if f.suppressed) == Counter(
        {"DET001": 7, "DET002": 2, "ERR001": 4, "IO001": 1, "WAIT001": 4, "RACE001": 2,
         "RACE002": 2, "RACE004": 6})
