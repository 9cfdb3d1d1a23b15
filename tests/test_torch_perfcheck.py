"""perfcheck of the port (foundationdb_tpu_torch/tools/lint/: base.py,
graphs.py, hotpath.py, runner.py) held to the reference's perfcheck
(foundationdb_tpu/tools/lint/hotpath.py).

The differential: on each file of the reference's HOT corpus
(tests/lint_cases/hot_cases/) and on test_hotpath.py's planted window
(``_PLANTED``, read from its source, not imported), the port's
``lint_source`` and the reference's ``lint_source(tools=("perfcheck",))``
give the same (rule, line, suppressed) findings with the same message up
to its advice (for HOT001 that holds the operation, its target and the
dispatch->sync chain).  Then torch's idioms, in
tests/torch_lint_cases/hot_cases/ with ``# EXPECT: RULE`` markers: each
new HOT001 sink fires with its chain and each non-sink stays silent, a
sanctioned scope sanctions its body, a torch constructor in a
``@hot_path`` function is HOT003; the hidden syncs perfcheck learned for
torch (truth tests of a tainted tensor, ``copy_`` from one, a stream's or
an event's ``.synchronize()``), planted in test_hotpath.py's window, fire
where the reference's perfcheck is silent: the differential's stated
exceptions.  The port's own tree reads no
unsuppressed finding; each suppression has a counterpart among the
reference's, less the listed ones; every ``@hot_path`` bound read
statically equals ``hot_registry()``'s.  The gate's CLI: exit codes, JSON
counts, SARIF, the pragma inventory, ``--all``, a planted HOT003 in a
copy of the package, and a run that loads neither jax nor the reference.
"""

import ast
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
from collections import Counter

import pytest

import foundationdb_tpu_torch.conflict.api  # noqa: F401  (registers the hot set)
import foundationdb_tpu_torch.conflict.engine_torch  # noqa: F401
import foundationdb_tpu_torch.parallel.sharded_resolver  # noqa: F401
import foundationdb_tpu_torch.server.resolver  # noqa: F401
from foundationdb_tpu.tools.lint.base import LintConfig as RefLintConfig
from foundationdb_tpu.tools.lint.project import lint_source as ref_lint_source
from foundationdb_tpu.tools.lint.runner import run_source_tools
from foundationdb_tpu_torch.flow.hotpath import hot_registry
from foundationdb_tpu_torch.tools.lint import hotpath, runner
from foundationdb_tpu_torch.tools.lint.runner import lint_source

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "foundationdb_tpu_torch"
REF_CASES = REPO / "tests" / "lint_cases" / "hot_cases"
PORT_CASES = REPO / "tests" / "torch_lint_cases" / "hot_cases"

# Reference paths and names the port spells differently.
PATHS = {"conflict/engine_jax.py": "conflict/engine_torch.py"}
# The reference's suppressed findings with no counterpart in the port:
# (path, function, rule, the flagged operation) -> why.
UNPORTED = {
    ("conflict/engine_jax.py", "JaxConflictSet._staging_blob", "HOT003", "np.empty"):
        "two: FDB_TPU_ENCODE_STAGING=0's fresh buffer and the ring's first population. "
        "The port has no opt-out of the ring, and its _staging_blob builds the ring "
        "through _StagingRing's constructor, which is not @hot_path",
    ("conflict/keys.py", "encode_keys", "HOT003", "np.frombuffer"):
        "one: the n < 64 per-key branch's view (keys.py:76); the port's encode_keys "
        "has no such branch, every batch takes the bulk pad",
}


def _planted_window() -> str:
    """test_hotpath.py's ``_PLANTED`` source, read without importing it."""
    tree = ast.parse((REPO / "tests" / "test_hotpath.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "_PLANTED"):
            return ast.literal_eval(node.value)
    raise AssertionError("test_hotpath.py has no _PLANTED")


def _rows(findings):
    """(rule, line, suppressed, message up to its advice) of each finding."""
    return sorted((f.rule, f.line, f.suppressed, f.message.split(";")[0]) for f in findings)


def _chain(message: str):
    m = re.search(r"\(chain: ([^)]*)\)", message)
    return m.group(1) if m else None


def _expected(path: pathlib.Path):
    out = set()
    for i, line in enumerate(path.read_text().splitlines(), 1):
        if "# EXPECT:" in line:
            for rule in line.split("# EXPECT:")[1].split(","):
                out.add((i, rule.strip()))
    return out


# ---------------------------------------------------------------------------
# the differential against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["hot.py", "pragmas.py", "window.py", "_PLANTED"])
def test_reference_corpus_gives_the_reference_findings(case):
    if case == "_PLANTED":
        src, relpath = _planted_window(), "window.py"
    else:
        src, relpath = (REF_CASES / case).read_text(), case
    want = ref_lint_source(src, relpath, tools=("perfcheck",))
    got = lint_source(src, relpath)
    assert want, case
    assert _rows(got) == _rows(want)
    assert ([_chain(f.message) for f in got if f.rule == "HOT001"]
            == [_chain(f.message) for f in want if f.rule == "HOT001"])
    if case == "_PLANTED":
        (f,) = got
        assert f.rule == "HOT001" and _chain(f.message) == "drive -> _peek"
        assert "np.asarray()" in f.message and "sanctioned sync point" in f.message


def test_rules_are_the_reference_family():
    from foundationdb_tpu.tools.lint.hotpath import HOT_RULES as REF_RULES

    assert set(hotpath.HOT_RULES) == set(REF_RULES)
    assert hotpath.DEVICE_ENTRY_POINTS == ("dispatch_txns", "dispatch_packed")
    assert "_StagingRing" in hotpath.HOT_RULES["HOT003"]


# ---------------------------------------------------------------------------
# torch's idioms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["sinks.py", "scopes.py", "alloc.py"])
def test_torch_corpus_fires_exactly_its_markers(case):
    path = PORT_CASES / case
    found = lint_source(path.read_text(), case)
    got = {(f.line, f.rule) for f in found if not f.suppressed}
    assert got == _expected(path)
    assert not [f for f in found if f.rule.startswith("PRG")]


def test_torch_sinks_name_their_operation_and_chain():
    found = {f.line: f.message for f in lint_source((PORT_CASES / "sinks.py").read_text(),
                                                    "sinks.py")}
    src = (PORT_CASES / "sinks.py").read_text().splitlines()

    def at(text):
        return found[next(i for i, ln in enumerate(src, 1) if text in ln and "EXPECT" in ln)]

    for text, op, callee in (
        ("ticket.out.cpu()", ".cpu() on 'ticket.out'", "_peek_cpu"),
        ("ticket.host.numpy()", ".numpy() on 'ticket.host'", "_peek_numpy"),
        ('ticket.out.to("cpu")', '.to("cpu") on \'ticket.out\'', "_peek_to"),
        ('to(device="cpu")', '.to("cpu") on \'ticket.out\'', "_peek_to"),
        ('torch.device("cpu")', '.to("cpu") on \'ticket.out\'', "_peek_to"),
        ("ticket.ready.synchronize()", ".synchronize() on 'ticket.ready'", "_wait"),
        ("np.asarray(ticket.host)", "np.asarray() on 'ticket.host'", "_peek_asarray"),
        ("    torch.cuda.synchronize()", "torch.cuda.synchronize() waits", "_drain"),
        ("tc.synchronize()", "torch.cuda.synchronize() waits", "_drain_aliased"),
        ("if ticket.out[0]:", "truth test (if) on 'ticket.out[0]'", "_truth_if"),
        ("while (ticket.out > 0)", "truth test (while) on '(ticket.out > 0).any()'",
         "_truth_while"),
        ("assert torch.all", "truth test (assert) on 'torch.all(ticket.out >= 0)'",
         "_truth_assert"),
        ("not ticket.out", "truth test (not) on 'ticket.out'", "_truth_operators"),
        ("ticket.out[1] and flag", "truth test (and/or) on 'ticket.out[1]'",
         "_truth_operators"),
        ("ticket.out.sum() else", "truth test (conditional expression) on 'ticket.out.sum()'",
         "_truth_operators"),
        ("if ticket.out[i] == 0", "truth test (comprehension if) on 'ticket.out[i] == 0'",
         "_truth_operators"),
        ("dst.copy_(ticket.out)", ".copy_() on 'ticket.out'", "_copy_back"),
        ("current_stream().synchronize()",
         "torch.cuda.current_stream().synchronize() waits for the work queued",
         "_stream_syncs"),
        ("default_stream().synchronize()",
         "torch.cuda.default_stream().synchronize() waits", "_stream_syncs"),
        ("    stream.synchronize()", "stream.synchronize() waits", "_stream_syncs"),
        ("ev.synchronize()", "ev.synchronize() waits", "_stream_syncs"),
    ):
        msg = at(text)
        assert op in msg, (text, msg)
        assert _chain(msg) == f"drive -> {callee}", (text, msg)


# The hidden syncs that neither perfcheck nor the reference's caught before
# HOT001 learned torch's truth tests, copy_ and stream syncs, planted in
# test_hotpath.py's window in place of _peek's np.asarray: {variant: (the
# body of _peek, what the finding names, or None for a non-sink)}.  These
# are the port's stated exceptions to the differential: torch-only sinks,
# which the reference's perfcheck (JAX's syncs) has no counterpart of.
HIDDEN_SYNCS = {
    "if": ("if ticket.statuses[0]:\n        return 1", "truth test (if) on 'ticket.statuses[0]'"),
    "while": ("while (ticket.statuses > 0).any():\n        break",
              "truth test (while) on '(ticket.statuses > 0).any()'"),
    "copy_": ("return torch.empty(3).copy_(ticket.statuses)", ".copy_() on 'ticket.statuses'"),
    "stream": ("return torch.cuda.current_stream().synchronize()",
               "torch.cuda.current_stream().synchronize() waits"),
    "copy_ non-blocking": ("return torch.empty(3).copy_(ticket.statuses, non_blocking=True)",
                           None),
    "identity test": ("if ticket.statuses is None:\n        return 1", None),
}


@pytest.mark.parametrize("variant", sorted(HIDDEN_SYNCS))
def test_hidden_syncs_fire_where_the_reference_is_silent(variant):
    body, op = HIDDEN_SYNCS[variant]
    planted = _planted_window()
    assert "    return np.asarray(ticket.statuses)\n" in planted
    src = planted.replace("    return np.asarray(ticket.statuses)\n", f"    {body}\n")
    assert ref_lint_source(src, "window.py", tools=("perfcheck",)) == []
    got = lint_source(src, "window.py")
    if op is None:
        assert got == []
        return
    (f,) = got
    assert f.rule == "HOT001" and not f.suppressed
    assert op in f.message and _chain(f.message) == "drive -> _peek", f.message


def test_sanctioned_scopes_cut_the_window():
    found = lint_source((PORT_CASES / "scopes.py").read_text(), "scopes.py")
    msgs = {f.message.split(":")[0] for f in found}
    # _flush is called only from inside the sanctioned block: no finding,
    # and so no window through it.
    assert "'Engine._flush'" not in msgs
    (flush,) = [f for f in found if "'Engine._flush_unsanctioned'" in f.message]
    assert _chain(flush.message) == "Engine.submit -> Engine._flush_unsanctioned"


def test_pragma_in_the_torch_corpus_suppresses_with_its_reason():
    found = lint_source((PORT_CASES / "alloc.py").read_text(), "alloc.py")
    (sup,) = [f for f in found if f.suppressed]
    assert sup.rule == "HOT003" and "torch.empty" in sup.message
    assert sup.reason == "the step's output, retained by the caller"


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_findings():
    return runner.run_perfcheck(str(PORT))


def test_port_tree_is_clean(port_findings):
    assert [f.format() for f in port_findings if not f.suppressed] == []
    assert not [f for f in port_findings if f.rule.startswith("PRG")]
    assert all(f.reason for f in port_findings)
    assert Counter(f.rule for f in port_findings) == {"HOT003": 7, "HOT004": 1}


def _site(f, path):
    """(path, function, rule, the flagged operation) of a finding."""
    qual = f.message.split("'")[1]
    op = re.search(r"via (\S+);", f.message)
    return (path, qual, f.rule, op.group(1) if op else None)


def test_port_suppressions_are_the_reference_counterparts(port_findings):
    ref = run_source_tools(str(REPO / "foundationdb_tpu"), RefLintConfig(),
                           tools=("perfcheck",), use_cache=False)["perfcheck"]
    assert not [f for f in ref if not f.suppressed]
    want = Counter()
    for f in ref:
        path = PATHS.get(f.path, f.path)
        site = _site(f, path)
        want[(path, site[1].replace("Jax", "Torch"), site[2], site[3])] += 1
    got = Counter(_site(f, f.path) for f in port_findings)
    assert not got - want, got - want
    missing = want - got
    unported = Counter()
    for (path, qual, rule, op), reason in UNPORTED.items():
        n = {"two": 2, "one": 1}[reason.split(":")[0]]
        unported[(PATHS.get(path, path), qual.replace("Jax", "Torch"), rule, op)] = n
    assert missing == unported


def test_ticket_fields_are_the_dispatch_tickets_slots():
    """HOT001's ticket vocabulary is DispatchTicket's: every slot is either
    a device field (taints) or a host field (does not), never both."""
    from foundationdb_tpu_torch.conflict.engine_torch import DispatchTicket

    assert not hotpath.TICKET_FIELDS & hotpath.TICKET_HOST_FIELDS
    assert hotpath.TICKET_FIELDS | hotpath.TICKET_HOST_FIELDS == set(DispatchTicket.__slots__)


def test_static_bounds_equal_the_hot_registry():
    static = {}
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT).as_posix()
        module = "foundationdb_tpu_torch." + rel[:-3].replace("/", ".")
        facts = hotpath.collect_hotpath(rel, ast.parse(path.read_text()))
        for qual, ff in facts.functions.items():
            if ff.bound is not None:
                static[f"{module}.{qual}"] = ff.bound
    reg = {k: v for k, v in hot_registry().items()
           if k.startswith("foundationdb_tpu_torch.")}
    assert len(reg) == 18
    assert static == reg


# ---------------------------------------------------------------------------
# the gate's CLI
# ---------------------------------------------------------------------------


def test_runner_json_counts_and_exit_code(capsys):
    assert runner.main(["--format=json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    pc = doc["tools"]["perfcheck"]
    assert doc["unsuppressed"] == pc["unsuppressed"] == 0
    assert pc["total"] == 8 and pc["findings"] == []
    # Every HOT rule, at zero too.
    assert pc["counts"] == {"HOT001": {"flagged": 0, "suppressed": 0},
                            "HOT002": {"flagged": 0, "suppressed": 0},
                            "HOT003": {"flagged": 0, "suppressed": 7},
                            "HOT004": {"flagged": 0, "suppressed": 1}}


def test_runner_text_counts_every_hot_rule(capsys):
    assert runner.main([]) == 0
    err = capsys.readouterr().err
    assert ("[perfcheck] 0 finding(s), 8 suppressed; per-rule (flagged+suppressed): "
            "HOT001=0+0s HOT002=0+0s HOT003=0+7s HOT004=0+1s") in err
    # The gate runs fdblint beside perfcheck: its 28 suppressions join the 8.
    assert "lint: 0 finding(s), 36 suppressed across 2 tool(s)" in err


def test_runner_sarif_and_pragma_inventory(capsys):
    assert runner.main(["--format=sarif", "--show-suppressed"]) == 0
    runs = json.loads(capsys.readouterr().out)["runs"]
    assert [r["tool"]["driver"]["name"] for r in runs] == ["fdblint", "perfcheck"]
    run = runs[1]
    assert len(run["results"]) == 8
    assert all(r["suppressions"][0]["justification"] for r in run["results"])
    assert runner.main(["--pragma-inventory"]) == 0
    inv = json.loads(capsys.readouterr().out)
    perf = [d for d in inv if d["tool"] == "perfcheck"]
    assert len(perf) == 8 and all(d["reason"] for d in perf)
    assert sorted({d["file"] for d in perf}) == [
        "conflict/engine_cpu.py", "conflict/keys.py", "parallel/sharded_resolver.py"]
    assert [d["file"] for d in inv if d["tool"] == "torchcheck"] == ["conflict/programs.py"]


def test_runner_all_adds_torchcheck(capsys):
    assert runner.main(["--all", "--format=json", "--show-suppressed"]) == 0
    doc = json.loads(capsys.readouterr().out)
    tc = doc["tools"]["torchcheck"]
    assert tc["unsuppressed"] == 0
    assert tc["counts"] == {"TGX004": {"flagged": 0, "suppressed": 2}}
    assert all(f["entry"] == "flat_step" for f in tc["findings"])


def test_planted_hot003_fails_the_gate(tmp_path, capsys):
    copy = tmp_path / "foundationdb_tpu_torch"
    shutil.copytree(PORT, copy, ignore=shutil.ignore_patterns("__pycache__", "_build"))
    with open(copy / "conflict" / "keys.py", "a", encoding="utf-8") as f:
        f.write("\n\n@hot_path(bound=\"batch\")\ndef planted_scratch(n):\n"
                "    return np.zeros(n, np.uint32)\n")
    assert runner.main([str(copy)]) == 1
    out = capsys.readouterr().out
    (line,) = out.splitlines()
    assert line.startswith("[perfcheck] conflict/keys.py:")
    assert "HOT003 'planted_scratch'" in line and "np.zeros" in line


def test_gate_loads_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "from foundationdb_tpu_torch.tools.lint.runner import main\n"
            "rc = main([])\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'foundationdb_tpu'))\n"
            "assert rc == 0 and not bad, (rc, bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
