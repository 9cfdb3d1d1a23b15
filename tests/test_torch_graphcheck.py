"""torchcheck: the structural check of the port's registered device programs
(foundationdb_tpu_torch/tools/lint/torchir.py, torchfingerprint.py), the
counterpart of the reference's jaxcheck (tests/test_jaxcheck.py).

A clean run on the registry: no unsuppressed finding, the two reasoned
TGX004 pragmas of the ``nokernel`` arm's sort, and every fingerprint equal
to its committed file under tests/torch_fingerprints/.  Each rule fires on
a planted program in a scratch registry (a module written to a temporary
directory, so that its def lines carry the pragmas under test) and a
reasoned pragma clears it; a pragma without a reason adds PRG001 and a
stale one PRG002.  A bumped baseline is reported as ``~ ops.<op>|<class>:
baseline N -> current M``, a missing or stale file is an error, and two
updates write the same bytes.  The port's registry names the reference's
entries less its XLA-only ``tiered_step`` and ``sharded_step``, with the
reference's structural metadata.

The registry's programs are recorded once for the module (about 10 s).
"""

import importlib.util
import json
import pathlib
import shutil
import textwrap

import pytest

import foundationdb_tpu.conflict.engine_jax as ej
import foundationdb_tpu.parallel.sharded_resolver  # noqa: F401  (the reference's sharded entries)
from foundationdb_tpu_torch.conflict import programs
from foundationdb_tpu_torch.tools.lint import torchfingerprint as tfp
from foundationdb_tpu_torch.tools.lint import torchir

NO_PORT_PROGRAM = {"tiered_step", "sharded_step"}


@pytest.fixture(scope="module")
def runs():
    reg = torchir.default_registry()
    return {name: torchir.walk_program(reg[name]) for name in sorted(reg)}


def test_rules_and_no_donation_rule():
    assert set(torchir.TORCH_RULES) == {"TGX001", "TGX002", "TGX004", "TGX005", "PRG001",
                                        "PRG002"}
    assert "JXP003" in torchir.__doc__ and "nothing to donate" in torchir.__doc__


def test_clean_run_on_the_registry(runs):
    found = torchir.run_torchcheck(runs=runs)
    assert [f for f in found if not f.suppressed] == []
    suppressed = [(f.entry, f.rule) for f in found]
    assert suppressed == [("flat_step", "TGX004"), ("flat_step", "TGX004")]
    assert all("torch.sort has no int32 indices" in f.reason for f in found)
    assert tfp.check_baselines(runs=runs) == []


def test_walker_marks_regions_and_sanctioned_syncs(runs):
    """The plain twins run inside the kernel regions of the kernel
    programs only; the tiered steps' compaction holds rows; the fixpoint's
    host checks are sanctioned; nothing launches on the CPU."""
    reg = torchir.default_registry()
    for name, run in runs.items():
        assert any(r.in_kernel for r in run.rows) == reg[name].kernel, name
        assert not any(r.op.startswith("launch:") for r in run.rows)
        syncs = [r for r in run.rows if r.sync is not None and not r.in_kernel]
        assert all(r.sanctioned and r.sync == "_local_scalar_dense" for r in syncs), name
    assert any(r.in_compaction for r in runs["tiered_step_kernels"].rows)
    assert any(r.in_compaction for r in runs["sharded_step_tiered"].rows)
    assert not any(r.in_compaction for r in runs["flat_step_kernels"].rows)
    assert sum(r.sanctioned for r in runs["sharded_step_kernels"].rows) == 2  # a shard each


# ---------------------------------------------------------------------------
# planted programs
# ---------------------------------------------------------------------------

H = 256

_PLANTED = '''
import torch

from foundationdb_tpu_torch.conflict.programs import register_entry_point
from foundationdb_tpu_torch.conflict.regions import region

H = {H}
REGISTRY = {{}}


def _arg(dev):
    return torch.arange(H, dtype=torch.int32, device=dev)


def _ep_sort(dev):{p001}
    def fn(x, *, h_cap):
        with region("compaction", "major"):
            torch.cumsum(x, 0, dtype=torch.int32)  # gated: allowed
        return torch.cumsum(x, 0, dtype=torch.int32)  # not gated: TGX001
    return fn, (_arg(dev),), dict(h_cap=H)


def _ep_wide(dev):{p001b}
    return (lambda x, *, h_cap: torch.cat([x, x, x])), (_arg(dev),), dict(h_cap=H)


def _ep_sync(dev):{p002}
    def fn(x, *, h_cap, on_sync=None):
        with on_sync():
            bool((x > 3).any())  # sanctioned
        with region("kernel", "twin"):
            x[x > 3]  # a kernel region's read: exempt
        return bool((x > 5).any())  # unsanctioned: TGX002
    return fn, (_arg(dev),), dict(h_cap=H)


def _ep_wide64(dev):{p004}
    return (lambda x, *, h_cap: torch.arange(H, device=x.device) + x), (_arg(dev),), dict(h_cap=H)


def _ep_buckets(dev):{p005}
    return (lambda x, *, txn_cap: x + 1), (_arg(dev),), dict(txn_cap=48)


common = dict(arg_names=("x",), size_classes=(("H", H),), h_threshold=H)
register_entry_point("sort", _ep_sort, registry=REGISTRY, compaction_gated=True,
                     work_bound=2 * H, bucket_dims={{"h_cap": (H, 64)}}, **common)
register_entry_point("wide", _ep_wide, registry=REGISTRY, work_bound=2 * H,
                     bucket_dims={{"h_cap": (H, 64)}}, **common)
register_entry_point("sync", _ep_sync, registry=REGISTRY, bucket_dims={{"h_cap": (H, 64)}},
                     **common)
register_entry_point("wide64", _ep_wide64, registry=REGISTRY, bucket_dims={{"h_cap": (H, 64)}},
                     **common)
register_entry_point("buckets", _ep_buckets, registry=REGISTRY,
                     bucket_dims={{"txn_cap": (48, 8), "h_cap": (512, 64)}}, **common)
'''


def _planted(tmp_path, name, **pragmas):
    """The planted module with the given def-line pragmas, imported from a
    file of its own; returns its scratch registry."""
    slots = {k: "" for k in ("p001", "p001b", "p002", "p004", "p005")}
    for k, v in pragmas.items():  # "RULE" or "RULE: reason"
        rule, _, reason = v.partition(":")
        slots[k] = f"  # torchcheck: ignore[{rule}]" + (f":{reason}" if reason else "")
    path = tmp_path / f"{name}.py"
    path.write_text(textwrap.dedent(_PLANTED.format(H=H, **slots)))
    spec = importlib.util.spec_from_file_location(f"planted_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.REGISTRY


def _unsuppressed(found):
    return sorted((f.entry, f.rule) for f in found if not f.suppressed)


def test_each_rule_fires_on_a_planted_program(tmp_path):
    found = torchir.run_torchcheck(_planted(tmp_path, "bare"))
    assert _unsuppressed(found) == [
        ("buckets", "TGX005"), ("buckets", "TGX005"), ("sort", "TGX001"),
        ("sync", "TGX002"), ("wide", "TGX001"), ("wide64", "TGX004"), ("wide64", "TGX004")]
    msg = {f.entry + f.rule: f.message for f in found}
    assert "outside the compaction region: cumsum over dim 256" in msg["sortTGX001"]
    assert "above the entry's work bound: cat over dim 768 (bound 512)" in msg["wideTGX001"]
    assert msg["syncTGX002"] == "host sync outside a sanctioned scope: _local_scalar_dense x1"
    assert sorted(f.message for f in found if f.rule == "TGX004") == [
        f"64-bit result on a history-wide buffer: {op} -> int64 over dim 256 (x1)"
        for op in ("add", "arange")]
    bucket = sorted(f.message for f in found if f.rule == "TGX005")
    assert "static dim txn_cap=48 is outside the shape-bucket table" in bucket[1]
    assert "registered bucket dim h_cap=512 appears nowhere" in bucket[0]
    assert all(f.path.endswith("bare.py") and f.line > 1 for f in found)


def test_reasoned_pragmas_clear_the_findings(tmp_path):
    reason = ": a reason"
    found = torchir.run_torchcheck(_planted(
        tmp_path, "reasoned", p001="TGX001" + reason, p001b="TGX001" + reason,
        p002="TGX002" + reason, p004="TGX004" + reason, p005="TGX005" + reason))
    assert _unsuppressed(found) == []
    assert len(found) == 7 and all(f.reason == "a reason" for f in found)


def test_pragma_without_reason_is_prg001_and_stale_is_prg002(tmp_path):
    found = torchir.run_torchcheck(_planted(
        tmp_path, "policed", p001="TGX001", p004="TGX002: nothing to suppress"))
    assert ("sort", "TGX001") not in _unsuppressed(found)
    assert ("sort", "PRG001") in _unsuppressed(found)
    assert ("wide64", "PRG002") in _unsuppressed(found)
    assert ("wide64", "TGX004") in _unsuppressed(found)
    (stale,) = [f for f in found if f.rule == "PRG002"]
    assert stale.message == "pragma for ['TGX002'] suppresses nothing here"


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------


def test_bumped_baseline_is_reported_and_update_heals(tmp_path, runs):
    d = tmp_path / "fp"
    shutil.copytree(tfp.baseline_dir(), d)
    path = d / "flat_step.json"
    fp = json.loads(path.read_text())
    key = "sort|>=H"
    n = fp["ops"][key]
    fp["ops"][key] = n + 1
    path.write_text(tfp.render(fp))
    (d / "retired_step.json").write_text("{}\n")
    (d / "grow_body.json").unlink()
    problems = tfp.check_baselines(dirpath=str(d), runs=runs)
    assert f"flat_step: ~ ops.{key}: baseline {n + 1} -> current {n}" in problems
    assert any(p.startswith("grow_body: MISSING baseline") for p in problems)
    assert "retired_step.json: STALE baseline (no registered entry: delete it or register the " \
           "entry)" in problems
    (d / "retired_step.json").unlink()
    first = tfp.write_baselines(dirpath=str(d), runs=runs)
    once = {p: open(p, "rb").read() for p in first}
    tfp.write_baselines(dirpath=str(d), runs=runs)
    assert {p: open(p, "rb").read() for p in first} == once
    committed = pathlib.Path(tfp.baseline_dir())
    assert all(data == (committed / pathlib.Path(p).name).read_bytes() for p, data in once.items())
    assert tfp.check_baselines(dirpath=str(d), runs=runs) == []


def test_cli(tmp_path, runs, monkeypatch, capsys):
    """The CLI over recorded runs: --list-rules; rc 0 on the tree; rc 1 with
    the diff line on a bumped baseline; --update-baselines heals it; json
    counts the suppressed findings."""
    monkeypatch.setattr(torchir, "walk_program", lambda ep, device="cpu": runs[ep.name])
    assert torchir.main(["--list-rules"]) == 0
    assert "TGX004" in capsys.readouterr().out
    assert torchir.main([]) == 0
    d = tmp_path / "fp"
    shutil.copytree(tfp.baseline_dir(), d)
    fp = json.loads((d / "rebase_body.json").read_text())
    fp["op_count"] += 1
    (d / "rebase_body.json").write_text(tfp.render(fp))
    capsys.readouterr()
    assert torchir.main([f"--baseline-dir={d}"]) == 1
    err = capsys.readouterr().err
    assert "rebase_body: ~ op_count: baseline" in err and "--update-baselines" in err
    assert torchir.main([f"--baseline-dir={d}", "--update-baselines"]) == 0
    capsys.readouterr()
    assert torchir.main([f"--baseline-dir={d}", "--format=json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["unsuppressed"] == 0 and doc["counts"] == {
        "TGX004": {"suppressed": 2, "unsuppressed": 0}}
    assert torchir.main(["--no-fingerprints", f"--baseline-dir={tmp_path / 'none'}"]) == 0


def test_registry_names_the_reference_entries_with_its_metadata():
    import foundationdb_tpu_torch.parallel  # noqa: F401  (the port's sharded entries)

    ref, port = ej.DEVICE_ENTRY_POINTS, programs.DEVICE_ENTRY_POINTS
    assert set(port) == set(ref) - NO_PORT_PROGRAM
    for name, ep in port.items():
        r = ref[name]
        assert ep.compaction_gated == r.compaction_gated, name
        assert (ep.size_classes, ep.h_threshold, ep.work_bound, ep.bucket_dims) == (
            tuple(r.size_classes), r.h_threshold, r.work_bound, dict(r.bucket_dims)), name
    assert {n for n, ep in port.items() if ep.compaction_gated} == {
        "tiered_step_kernels", "sharded_step_tiered"}
