"""The port's own chaos soak (``workloads/soak.py``) and ``cli soak``, held
to the reference's on the CPU.

Each twin runs a test function of tests/test_soak.py (or test_witness.py)
for each package (tests/test_torch_cli.py's loader: the module's source as
it is and pointed at the port, a knob write becoming the port argument
that stands for it) with every ``run_soak`` report of the run recorded,
and holds the reports equal, ``json.dumps(sort_keys=True)``, less the two
names of the reference's JAX engine (``NAME_MAP``: the report's
``config.backend`` "jax" is the port's "torch", and the resolver's device
registry, sampled into the flight recorder's captures as
"JaxConflict.<resolver>", is the port's "TorchConflict.<resolver>") and
that registry's counts of the host's own blocking reads and pinned
buffers (``EXCLUDED``, with the reason).  The
port's soaks run on the CPU (``SoakConfig.device`` "cpu", the kernels'
plain twins).  A reference test that points its ``FDB_TPU_*`` flags at
the run passes the port's ``SoakConfig`` arguments instead.

Twinned: tests/test_soak.py's ``test_zipf_skew_properties``, the clog
(:66), the same-seed replay (:91), the coalesced mirror (:104), the
overload's shedding (:253), ``cli soak``'s artifact (:282) and the flags'
defaults (:306).  The device-outage (:133), shard-kill (:192) and
shard-kill replay (:234) soaks, and tests/test_witness.py's contention
soak (:663), are tests/test_torch_soak.py's: the reference's JAX
programs they run are compiled once in that file's process.
"""

from __future__ import annotations

import ast
import contextlib
import importlib
import importlib.util
import json
import pathlib

import pytest

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_cli_twins_soak", _here / "test_torch_cli.py")
CLI = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CLI)
_restore_globals = CLI._restore_globals
_one_thread = CLI._one_thread
DC = CLI.DC

import foundationdb_tpu_torch.workloads.soak as port_soak  # noqa: E402


def _rename(value, old, new):
    if isinstance(value, dict):
        return {(new + k[len(old):] if isinstance(k, str) and k.startswith(old) else k):
                _rename(v, old, new) for k, v in value.items()}
    if isinstance(value, list):
        return [_rename(v, old, new) for v in value]
    return value


def as_reference(report: dict) -> dict:
    """A port report under the reference's names (NAME_MAP): its backend,
    and its device registry's time-series name in the captures."""
    out = _rename(json.loads(json.dumps(report)), "TorchConflict.", "JaxConflict.")
    if out["config"]["backend"] == "torch":
        out["config"]["backend"] = "jax"
    return out


# The fields of a port report that differ from the reference's, by name,
# each with its reason (as_reference maps them, nothing else differs).
NAME_MAP = {
    "config.backend": "the reference's device backend 'jax' is the port's 'torch'",
    "flight_recorder.captures[].timeseries.JaxConflict.<resolver>":
        "the device registry's name: the port's engine's is 'TorchConflict'",
}

# Fields of a report left out of the comparison, each with its reason.
EXCLUDED = {
    "the device registry's counters host_syncs and host_allocs, in every sample":
        "the host's own blocking reads and pinned buffers: the port takes a "
        "batch's fixpoint check at its dispatch where the reference reads its "
        "witness at the sync, so a sample taken between the two counts one "
        "more or fewer (a run's totals agree); pinned buffers exist only on "
        "the card",
}


def comparable(report: dict) -> dict:
    """A report less EXCLUDED (chip_smoke's without_device_host_counters)."""
    return DC.SMOKE.without_device_host_counters(report)


def assert_reports_equal(port: dict, ref: dict):
    got, want = comparable(as_reference(port)), comparable(ref)
    diff = DC.first_difference(got, want)
    assert diff is None, diff
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


@contextlib.contextmanager
def soak_log(mod, pkg):
    """While open, every run_soak of test module `mod` (of package `pkg`)
    is recorded; the port's soaks default to device="cpu"."""
    patches = DC.Patches()
    reports = []
    soak_mod = importlib.import_module(f"{DC.BASES[pkg]}.workloads.soak")
    inner = soak_mod.run_soak

    def run_soak(cfg):
        rep = inner(cfg)
        reports.append(rep)
        return rep

    # The module's own name, and the soak module's for a test that imports
    # run_soak where it runs.
    for owner in (mod, soak_mod):
        if "run_soak" in vars(owner):
            patches.set(owner, "run_soak", run_soak)
    if pkg == "port":
        old = CLI.set_default(port_soak.SoakConfig.__init__, "device", "cpu")
    try:
        with CLI.port_defaults():
            yield reports
    finally:
        patches.undo()
        if pkg == "port":
            CLI.set_default(port_soak.SoakConfig.__init__, "device", old)


def run_twins(name, test, subs=None, params=()):
    """Run `test` of reference module `name` for both packages; returns the
    (reference, port) lists of reports."""
    subs = subs or {}
    out = {}
    for pkg in ("ref", "port"):
        mod = CLI.load(name, pkg, subs.get(pkg, ()))
        with soak_log(mod, pkg) as reports:
            getattr(mod, test)(*params)
        out[pkg] = reports
    return out["ref"], out["port"]


def assert_soak_twins(name, test, subs=None):
    ref, port = run_twins(name, test, subs)
    assert len(port) == len(ref) > 0
    for got, want in zip(port, ref):
        assert_reports_equal(got, want)
    return port


def test_zipf_skew_properties():
    """tests/test_soak.py:49, and the port's cdf and picks equal the
    reference's."""
    run_twins("test_soak", "test_zipf_skew_properties")
    from foundationdb_tpu.flow.rng import DeterministicRandom as RefRng
    from foundationdb_tpu.workloads import soak as ref_soak
    from foundationdb_tpu_torch.flow.rng import DeterministicRandom

    for n, theta in ((100, 0.9), (100, 0.0), (8, 1.2)):
        assert port_soak.zipf_cdf(n, theta) == ref_soak.zipf_cdf(n, theta)
    cdf = port_soak.zipf_cdf(512, 0.9)
    a, b = DeterministicRandom(5), RefRng(5)
    assert [port_soak.zipf_pick(a, cdf) for _ in range(500)] == \
        [ref_soak.zipf_pick(b, cdf) for _ in range(500)]
    assert port_soak.hot_zipf_weights(64, 1.2, 24) == ref_soak.hot_zipf_weights(64, 1.2, 24)


@pytest.mark.parametrize("test", [
    "test_soak_clog_throttles_and_releases",
    "test_soak_same_seed_byte_identical",
    "test_soak_overload_sheds_and_clients_recover",
])
def test_soak(test):
    reports = assert_soak_twins("test_soak", test)
    assert all(r["config"]["backend"] == "cpu" for r in reports)


# The reference sets FDB_TPU_MIRROR_COALESCE=auto and FDB_TPU_PIPELINE_DEPTH=2
# for its first two soaks; the port's pass the same as resolver settings.
COALESCE_SUBS = [(r"a = run_soak\(_short_cfg\(7, faults=faults\)\)\n(\s+)b = run_soak\("
                  r"_short_cfg\(7, faults=faults\)\)",
                  'a = run_soak(_short_cfg(7, faults=faults, resolver_settings=COALESCE))\n'
                  '\\1b = run_soak(_short_cfg(7, faults=faults, resolver_settings=COALESCE))'),
                 (r"\ndef test_soak_coalesce_on_byte_identical_and_exact",
                  '\nCOALESCE = {"mirror_coalesce": "auto", "pipeline_depth": 2}\n\n\n'
                  'def test_soak_coalesce_on_byte_identical_and_exact')]


def test_soak_coalesce_on_byte_identical_and_exact():
    """tests/test_soak.py:104: coalesced mirror folds give the same report
    twice and the uncoalesced run's tallies."""
    reports = assert_soak_twins("test_soak", "test_soak_coalesce_on_byte_identical_and_exact",
                                subs={"port": COALESCE_SUBS})
    assert len(reports) == 3


def test_cli_soak_emits_bench_style_artifact(capsys):
    """tests/test_soak.py:282: `cli soak --format=json` (0.05 minutes at 40
    txn/s, seed 3, 32 keys, the host engine, no faults) prints the
    reference's artifact."""
    from foundationdb_tpu.tools.cli import soak_main as ref_main
    from foundationdb_tpu_torch.tools.cli import soak_main

    argv = ["--format=json", "--minutes=0.05", "--tps=40", "--seed=3", "--keys=32",
            "--backend=cpu", "--no-faults"]
    assert ref_main(argv) == 0
    want = capsys.readouterr().out
    assert soak_main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    artifact = json.loads(got)
    assert artifact["metric"] == "soak_goodput_txn_per_sec" and artifact["value"] > 0
    for key in ("phases", "throttle_shed", "fault_timeline", "ratekeeper_transitions",
                "breaker_transitions", "slo", "committed", "attempts", "sim_seconds", "seed"):
        assert key in artifact, sorted(artifact)


def test_soak_flag_defaults_equal_the_references():
    """tests/test_soak.py:306: `cli soak`'s defaults are the reference's
    FDB_TPU_SOAK_* flags' declared defaults (its "jax" backend the port's
    "torch"); the port declares and reads no environment variable."""
    from foundationdb_tpu.flow.knobs import g_env
    from foundationdb_tpu_torch.tools.cli import SOAK_DEFAULTS

    decl = g_env.declared()
    want = {"minutes": float(decl["FDB_TPU_SOAK_MINUTES"][0]),
            "seed": int(decl["FDB_TPU_SOAK_SEED"][0]),
            "tps": float(decl["FDB_TPU_SOAK_TPS"][0]),
            "keys": int(decl["FDB_TPU_SOAK_KEYS"][0]),
            "theta": float(decl["FDB_TPU_SOAK_THETA"][0]),
            "backend": {"jax": "torch"}.get(decl["FDB_TPU_SOAK_BACKEND"][0])}
    assert SOAK_DEFAULTS == want
    pkg = _here.parent / "foundationdb_tpu_torch"
    reads = []
    for path in sorted(pkg.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute) and node.attr in ("environ", "getenv", "putenv") \
                    and isinstance(node.value, ast.Name) and node.value.id == "os":
                reads.append(f"{path.relative_to(pkg)}:{node.lineno}")
    assert reads == []

