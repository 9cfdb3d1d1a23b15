"""fdblint's families that apply to the port (foundationdb_tpu_torch/
tools/lint/: base.py, local.py, det101.py, runner.py; tools/fdblint.py),
held to the reference's fdblint (foundationdb_tpu/tools/lint/).

The differential: on the reference's own cases, the inline sources of
tests/test_lint.py's DET001-003, TRC001, ERR001, IO001, SPN001, ENV001
and DET101 tests (read from its source, not imported) and the case
packages tests/lint_cases/{det101_pkg,env_cases,spn_cases} (read as
data), the port's fdblint gives the reference's (rule, file, line,
suppressed) findings and DET101 chains.  The stated exceptions are the
reference's exemptions by path of modules the port does not have: its
knob registry (flow/knobs.py, ENV001) and its real network backend
(rpc/real_network.py, IO001); there the port gives the reference's
findings at a path it does not exempt.  Then the port's own tree: no
unsuppressed finding, the 10 reasoned pragmas, and the reference's
fdblint over it finds nothing either.  Pragma hygiene, one plant of each
rule in a copy of the port, the gate's CLI, and chip_smoke.py's planted
window held to the reference.
"""

import ast
import json
import pathlib
import re
import shutil
from collections import Counter

import pytest

from foundationdb_tpu.tools.lint.base import LintConfig as RefLintConfig
from foundationdb_tpu.tools.lint.project import lint_source as ref_lint_source
from foundationdb_tpu.tools.lint.runner import run_source_tools as ref_run_source_tools
from foundationdb_tpu_torch.tools import fdblint
from foundationdb_tpu_torch.tools.lint import base, runner

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "foundationdb_tpu_torch"
REF_CASES = REPO / "tests" / "lint_cases"

# fdblint's families that apply to the port, and its pragma rules.
APPLICABLE = ("DET001", "DET002", "DET003", "DET101", "IO001", "TRC001", "SPN001",
              "ERR001", "ENV001")
COMPARED = APPLICABLE + ("PRG001", "PRG002")

# The reference's exemptions by path of modules the port does not have.
REF_ONLY_EXEMPT = {
    "flow/knobs.py": "ENV001",        # the reference's knob registry
    "rpc/real_network.py": "IO001",   # the reference's real network backend
}

# tests/test_lint.py's tests whose inline sources are the corpus.
REF_TESTS = (
    "test_det001_wall_clock_variants",
    "test_det002_entropy_variants",
    "test_det003_threading_and_asyncio",
    "test_trc001_dropped_trace_event",
    "test_trc001_respects_aliases_and_pragma",
    "test_err001_silent_broad_excepts",
    "test_err001_handled_broad_excepts_are_clean",
    "test_err001_pragma_on_except_line_only",
    "test_io001_open_and_socket",
    "test_det002_not_fooled_by_variable_named_random",
    "test_pragma_on_any_line_of_a_multiline_statement",
    "test_pragma_examples_in_docstrings_are_inert",
    "test_spn001_leaked_vs_handled_spans",
    "test_env001_presence_checks_and_mutating_reads",
    "test_det101_intramodule_chain_and_pragma_cut",
    "test_det101_source_sanction_spans_multiline_statement",
    "test_det101_pragma_on_clean_edge_goes_stale",
    "test_env001_variants_and_registry_exemption",
)


def _eval_str(node, env):
    """A string constant, a name bound to one, or `<str>.replace(a, b)`."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "replace" and len(node.args) == 2):
        base_s = _eval_str(node.func.value, env)
        a, b = (_eval_str(x, env) for x in node.args)
        if None not in (base_s, a, b):
            return base_s.replace(a, b)
    return None


def _ref_inline_cases():
    """(test, source, path) of every lint_source(src, path) call in the
    REF_TESTS functions of tests/test_lint.py."""
    tree = ast.parse((REPO / "tests" / "test_lint.py").read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    out = []
    for name in REF_TESTS:
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


INLINE = _ref_inline_cases()


def _chain(message):
    m = re.search(r"\(chain: ([^)]*)\)", message)
    return m.group(1) if m else None


def _rows(findings):
    """(rule, path, line, suppressed, DET101 chain) of the compared rules."""
    return sorted((f.rule, f.path, f.line, f.suppressed, _chain(f.message))
                  for f in findings if f.rule in COMPARED)


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
    assert len(INLINE) == 24
    assert {name for name, _s, _p in INLINE} == set(REF_TESTS)


@pytest.mark.parametrize("case", range(len(INLINE)),
                         ids=[f"{n}-{i}" for i, (n, _s, _p) in enumerate(INLINE)])
def test_inline_corpus_gives_the_reference_findings(case):
    name, src, path = INLINE[case]
    got = runner.lint_source(src, path, tools=("fdblint",))
    if path in REF_ONLY_EXEMPT:
        rule = REF_ONLY_EXEMPT[path]
        assert rule not in {f.rule for f in ref_lint_source(src, path)}
        want = [f for f in ref_lint_source(src, "server/x.py") if f.rule in COMPARED]
        for f in want:
            f.path = path
        assert rule in {f.rule for f in want}
    else:
        want = ref_lint_source(src, path)
    assert _rows(got) == _rows(want), name
    # Nothing outside the compared rules: the port has no other family.
    assert {f.rule for f in got} <= set(COMPARED)


@pytest.mark.parametrize("case", ["det101_pkg", "env_cases", "spn_cases"])
def test_case_packages_give_the_reference_findings(case):
    case_dir = REF_CASES / case
    got = runner.run_fdblint(str(case_dir))
    want = [f for f in ref_run_source_tools(str(case_dir), RefLintConfig(),
                                            tools=("fdblint",), use_cache=False)["fdblint"]
            if f.rule in COMPARED]
    extra = Counter((f.path, f.line, f.rule) for f in got) - Counter(
        (f.path, f.line, f.rule) for f in want)
    if case == "env_cases":
        # The stated exception: the reference's registry module, which
        # the port does not exempt, reads one FDB_TPU_* constant.
        assert extra == Counter({("flow/knobs.py", 12, "ENV001"): 1})
        got = [f for f in got if f.path != "flow/knobs.py"]
    else:
        assert not extra
    assert _rows(got) == _rows(want)
    unsuppressed = {(f.path, f.line, f.rule) for f in got if not f.suppressed}
    assert unsuppressed == _expected(case_dir)


def test_det101_names_the_reference_chains():
    found = runner.run_fdblint(str(REF_CASES / "det101_pkg"))
    det = [f for f in found if f.rule == "DET101" and not f.suppressed]
    (sim,) = [f for f in det if f.path == "server/sim_role.py"]
    assert "time.time" in sim.message and "prep -> shape -> clock_stamp" in sim.message
    assert {f.line for f in det if f.path == "server/roles.py"} == {9, 15}
    # tools/ carries taint but is never a root; wall_only is reached only
    # from tools/ and appears nowhere.
    assert not [f for f in found if f.path.startswith("tools/")]
    assert not any("wall_only" in f.message for f in found)


def test_det101_bottom_edge_pragma_clears_the_cascade(tmp_path):
    """The reference's compositional-pragma case: sanctioning the one
    offending edge un-taints every frame above it, and the upstream
    sanctioning pragma, now on a clean edge, goes stale (PRG002)."""
    dst = tmp_path / "pkg"
    shutil.copytree(REF_CASES / "det101_pkg", dst)
    helpers = dst / "flow" / "helpers.py"
    helpers.write_text(helpers.read_text().replace(
        "    return clock_stamp(x)  # EXPECT: DET101",
        "    return clock_stamp(x)  # fdblint: ignore[DET101]: the wall stamp is part of "
        "the exported record, not control flow"))
    found = runner.run_fdblint(str(dst))
    assert [f for f in found if f.rule == "DET101" and not f.suppressed] == []
    prg = [(f.path, f.line) for f in found if f.rule == "PRG002"]
    assert prg == [("server/sim_role.py", 17)]
    want = ref_run_source_tools(str(dst), RefLintConfig(), tools=("fdblint",),
                                use_cache=False)["fdblint"]
    assert _rows(found) == _rows(want)


def test_registry_is_the_reference_families():
    from foundationdb_tpu.tools.lint.base import DEFAULT_ALLOW as REF_ALLOW
    from foundationdb_tpu.tools.lint.base import RULES as REF_RULES
    from foundationdb_tpu.tools.lint.base import WALL_CLOCK as REF_WALL_CLOCK

    assert set(base.RULES) == set(COMPARED)
    assert set(base.RULES) < set(REF_RULES)
    assert base.RULES["ENV001"] == "any FDB_TPU_* environment read: the port has no flags"
    assert base.WALL_CLOCK == REF_WALL_CLOCK
    # tools/ is exempt exactly where the reference exempts its tools/.
    ref_tools = {r for r, globs in REF_ALLOW.items() if "tools/*.py" in globs and r in APPLICABLE}
    assert set(base.DEFAULT_ALLOW) == ref_tools == {"DET001", "DET003", "DET101", "ERR001",
                                                    "IO001"}
    assert all(globs == ("tools/*.py",) for globs in base.DEFAULT_ALLOW.values())


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------

PORT_PRAGMAS = [
    ("flow/rng.py", 11, ["DET002"]),
    ("flow/rng.py", 19, ["DET002"]),
    ("flow/trace.py", 51, ["IO001"]),
    ("flow/trace.py", 139, ["DET001"]),
    ("metrics.py", 41, ["DET001"]),
    ("rpc/stream.py", 77, ["ERR001"]),
    # DD's storage liveness probe: any failure is the negative verdict (the
    # reference's pragma and reason).
    ("server/dd_role.py", 172, ["ERR001"]),
    ("server/proxy.py", 458, ["ERR001"]),
    ("server/resolver_balancer.py", 163, ["ERR001"]),
    # SlowTask's deliberate burn of real time, which the slow-task
    # profiler must catch: the reference's two pragmas and reason.
    ("workloads/slow_task.py", 41, ["DET001"]),
    ("workloads/slow_task.py", 42, ["DET001"]),
]


@pytest.fixture(scope="module")
def port_findings():
    return runner.run_fdblint(str(PORT))


def test_port_tree_is_clean(port_findings):
    assert [f.format() for f in port_findings if not f.suppressed] == []
    assert Counter(f.rule for f in port_findings) == {"DET001": 4, "DET002": 2, "ERR001": 4, "IO001": 1}
    assert all(f.reason for f in port_findings)
    assert sorted((f.path, f.line) for f in port_findings) == [
        (p, ln) for p, ln, _r in PORT_PRAGMAS]


def test_pragma_inventory_is_the_five_reasoned_pragmas():
    inv = [d for d in runner.pragma_inventory(str(PORT)) if d["tool"] == "fdblint"]
    assert [(d["file"], d["line"], d["rules"]) for d in inv] == PORT_PRAGMAS
    assert all(len(d["reason"]) > 20 for d in inv)


def test_every_wall_read_goes_through_the_funnel():
    """Every module that timed with time.perf_counter now imports
    metrics.wall_now; test_port_tree_is_clean holds the only wall reads
    left to wall_now's, trace.py's fallback and SlowTask's deliberate
    burn."""
    users = sorted(p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")
                   if re.search(r"from \.+metrics import [^\n]*\bwall_now\b", p.read_text()))
    assert users == ["conflict/_build.py", "conflict/api.py", "conflict/phase_attribution.py",
                     "conflict/programs.py", "flow/eventloop.py", "flow/spans.py",
                     "parallel/sharded_resolver.py"]


def test_the_reference_finds_nothing_in_the_port(port_findings):
    ref = ref_run_source_tools(str(PORT), RefLintConfig(), tools=("fdblint",),
                               use_cache=False)["fdblint"]
    assert [f.format() for f in ref if f.rule in COMPARED and not f.suppressed] == []
    assert _rows(ref) == _rows(port_findings)


# ---------------------------------------------------------------------------
# pragma hygiene and planted findings
# ---------------------------------------------------------------------------


def test_pragma_without_reason_is_prg001_and_stale_is_prg002():
    src = ("import time\n"
           "def f():\n"
           "    return time.time()  # fdblint: ignore[DET001]\n"
           "def g():\n"
           "    return 1  # fdblint: ignore[DET002]: nothing to suppress here\n"
           "def h():\n"
           "    return 2  # fdblint: ignore[ACT001]: not a rule of the port\n")
    found = runner.lint_source(src, "conflict/x.py", tools=("fdblint",))
    got = sorted((f.rule, f.line, f.suppressed) for f in found)
    assert got == [("DET001", 3, True), ("PRG001", 3, False), ("PRG002", 5, False),
                   ("PRG002", 7, False)]
    assert "unknown rule(s) ['ACT001']" in [f for f in found if f.line == 7][0].message


def test_reasonless_pragma_in_the_port_fails_the_gate(tmp_path, capsys):
    copy = _copy_port(tmp_path)
    metrics = copy / "metrics.py"
    text = metrics.read_text()
    metrics.write_text(re.sub(r"(# fdblint: ignore\[DET001\]):[^\n]*", r"\1", text))
    assert fdblint.main([str(copy)]) == 1
    out = capsys.readouterr().out.splitlines()
    (line,) = [ln for p, ln, _r in PORT_PRAGMAS if p == "metrics.py"]
    assert out == [f"[fdblint] metrics.py:{line}:0: PRG001 ignore pragma carries no reason "
                   "(append ': why')"]


def _copy_port(tmp_path):
    copy = tmp_path / "foundationdb_tpu_torch"
    shutil.copytree(PORT, copy, ignore=shutil.ignore_patterns("__pycache__", "_build"))
    return copy


def _plant(copy, rel, old=None, new=None, append=""):
    path = copy / rel
    text = path.read_text()
    if old is not None:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    path.write_text(text + append)


PLANTS = {
    "clock": ("conflict/api.py",
              "            t0 = wall_now()\n            with begin_span(\"mirror_apply\"",
              "            t0 = _planted_clock()\n            with begin_span(\"mirror_apply\"",
              "\n\nimport time as _planted_time\n\n\ndef _planted_clock():\n"
              "    return _planted_time.time()\n",
              {"DET001", "DET101"}),
    "random": ("conflict/keys.py", None, None,
               "\n\nimport random\n\n\ndef _planted_jitter():\n    return random.random()\n",
               {"DET002"}),
    "env": ("conflict/keys.py", None, None,
            "\n\nimport os as _planted_os\n\n\ndef _planted_flag():\n"
            "    return _planted_os.environ.get(\"FDB_TPU_PLANTED\")\n",
            {"ENV001"}),
    "trace": ("conflict/api.py", None, None,
              "\n\ndef _planted_event(n):\n    TraceEvent(\"PlantedDropped\").detail(\"n\", n)\n",
              {"TRC001"}),
    "span": ("conflict/api.py", None, None,
             "\n\ndef _planted_span():\n    begin_span(\"planted\")\n",
             {"SPN001"}),
    "except": ("conflict/api.py", None, None,
               "\n\ndef _planted_swallow(fn):\n    try:\n        return fn()\n"
               "    except Exception:\n        return None\n",
               {"ERR001"}),
}


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_each_plant_gives_exactly_its_rule(plant, tmp_path):
    rel, old, new, append, rules = PLANTS[plant]
    copy = _copy_port(tmp_path)
    _plant(copy, rel, old, new, append)
    found = [f for f in runner.run_fdblint(str(copy)) if not f.suppressed]
    assert {f.rule for f in found} == rules, [f.format() for f in found]
    assert {f.path for f in found} == {rel}
    # The reference's fdblint agrees on every applicable finding.
    ref = [f for f in ref_run_source_tools(str(copy), RefLintConfig(), tools=("fdblint",),
                                           use_cache=False)["fdblint"]
           if f.rule in COMPARED and not f.suppressed]
    assert _rows(found) == _rows(ref)
    if plant == "clock":
        chains = {_chain(f.message) for f in found if f.rule == "DET101"}
        assert ("ConflictSet.pipeline_complete_oldest -> ConflictSet._apply_to_mirror"
                " -> _planted_clock") in chains
        assert all(c.endswith("_planted_clock") for c in chains)
        assert all("reaches wall-clock 'time.time'" in f.message
                   for f in found if f.rule == "DET101")


# ---------------------------------------------------------------------------
# the gate's CLI
# ---------------------------------------------------------------------------


def test_gate_counts_every_fdblint_rule(capsys):
    assert runner.main([]) == 0
    err = capsys.readouterr().err
    assert ("[fdblint] 0 finding(s), 11 suppressed; per-rule (flagged+suppressed): "
            "DET001=0+4s DET002=0+2s DET003=0+0s DET101=0+0s ENV001=0+0s ERR001=0+4s "
            "IO001=0+1s SPN001=0+0s TRC001=0+0s") in err
    assert "[perfcheck] 0 finding(s), 8 suppressed;" in err
    assert "lint: 0 finding(s), 19 suppressed across 2 tool(s)" in err


def test_gate_json_sarif_and_list_rules(capsys):
    assert runner.main(["--format=json", "--show-suppressed"]) == 0
    doc = json.loads(capsys.readouterr().out)
    fd = doc["tools"]["fdblint"]
    assert fd["unsuppressed"] == 0 and fd["total"] == 11
    assert fd["counts"] == {"DET001": {"flagged": 0, "suppressed": 4},
                            "DET002": {"flagged": 0, "suppressed": 2},
                            "ERR001": {"flagged": 0, "suppressed": 4},
                            "IO001": {"flagged": 0, "suppressed": 1}}
    assert runner.main(["--format=sarif", "--show-suppressed"]) == 0
    runs = json.loads(capsys.readouterr().out)["runs"]
    assert [r["tool"]["driver"]["name"] for r in runs] == ["fdblint", "perfcheck"]
    assert {r["id"] for r in runs[0]["tool"]["driver"]["rules"]} == set(COMPARED)
    assert len(runs[0]["results"]) == 11
    assert runner.main(["--list-rules"]) == 0
    lines = capsys.readouterr().out.splitlines()
    tools = Counter(ln.split()[0] for ln in lines)
    assert tools == {"fdblint": 11, "perfcheck": 6, "torchcheck": 6}
    assert any(ln.split()[1:3] == ["ENV001", "any"] for ln in lines)


def test_fdblint_shim_runs_fdblint_alone(capsys):
    assert fdblint.main([]) == 0
    err = capsys.readouterr().err
    assert "[fdblint] 0 finding(s), 11 suppressed" in err and "[perfcheck]" not in err
    assert fdblint.RULES is base.RULES and fdblint.lint_source is runner.lint_source


# ---------------------------------------------------------------------------
# chip_smoke.py's planted window, held to the reference
# ---------------------------------------------------------------------------


def _smoke_constants():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) in (
                    "PLANT_SOURCE", "PLANT_VARIANTS")):
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


def test_chip_smoke_plants_give_their_rules():
    c = _smoke_constants()
    assert sorted(c["PLANT_VARIANTS"]) == list("abcdefghij")
    for variant, (imports, body, rules, op, _guarded) in c["PLANT_VARIANTS"].items():
        src = c["PLANT_SOURCE"].format(imports=imports, body=body)
        found = [f for f in runner.lint_source(src, "window.py") if not f.suppressed]
        assert tuple(sorted(f.rule for f in found)) == rules, variant
        chained = [f for f in found if f.rule in ("HOT001", "DET101")]
        assert [_chain(f.message) for f in chained] == ["drive -> _peek"] * len(chained)
        assert op is None or all(op in f.message for f in chained), variant
        # (g)-(j) are torch's hidden syncs (a truth test, copy_, a stream's
        # synchronize), which the reference's perfcheck does not know.
        want = [] if variant in "ghij" else _rows(found)
        assert _rows(ref_lint_source(src, "window.py")) == want, variant
