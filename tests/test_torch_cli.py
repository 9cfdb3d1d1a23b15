"""The port's fdbcli twin (``tools/cli.py``), held to the reference's on the
CPU.

Each twin runs one test function of a reference test module for each
package (tests/test_torch_dynamic_cluster.py's twin runner: the module's
source loaded once as it is and once pointed at the port) and holds the
two runs' records equal: every client read, commit and retry with its
virtual time, every worker request, every trace event less its wall time,
each cluster's status document, each event loop's end and its rng's next
draw, and here also every ``run_command`` line with the lines it printed
(``CliLog``).  Both packages' globals share one span hub, trace collector,
flight recorder and time-series hub.

The port has no knobs: where a reference test writes ``g_knobs``, the
port's copy writes ``KnobShim``, which sets the default of the port
argument that stands for the knob for the run (``KNOB_ARGS``).  The port's
clusters default to ``device="cpu"`` here.  A reference test that names
the reference's device backend ("jax") runs in the "set" arm, where both
clusters' resolvers are port ``ConflictSet(device="cpu")``s at the rig's
shape; its port copy names "torch".

Twinned here: the CLI tests of tests/test_cli_status.py (the crud, the
explicit transaction, configure/exclude/include, the status rendering
under a ratekeeper, backup start/status/restore, describe/expire,
restore to a timestamp, dr start/status and switch, consistencycheck),
tests/test_lock_database.py's lock/unlock,
tests/test_device_faults.py's status after an outage,
tests/test_flight_recorder.py's samplers, status and CLI (flightrec,
metrics --diff), tests/test_mirror_snapshot.py's mirror-check (healthy,
and a planted divergence caught by the periodic check), and
tests/test_witness.py's ``contention --format=json`` (:615).
test_cli_status.py's status-document tests are twinned in
tests/test_torch_status.py; ``test_cluster_connection_file_roundtrip``
tests ``client/cluster_file.py``, which the port has not.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import inspect
import json
import pathlib
import re
import sys
import types as pytypes

import pytest

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_dc_twins_cli",
                                               _here / "test_torch_dynamic_cluster.py")
DC = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(DC)
_restore_globals = DC._restore_globals
BASES = DC.BASES


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the simulated clusters' tensors are small, and
    a thread per core costs several times the CPU when test processes
    share the cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the twin runner
# ---------------------------------------------------------------------------


def set_default(func, name, value):
    """Set the default of parameter `name` of `func`; returns the old one."""
    params = [p for p in inspect.signature(func).parameters.values()
              if p.default is not inspect.Parameter.empty]
    if any(p.name == name and p.kind is p.KEYWORD_ONLY for p in params):
        old = func.__kwdefaults__[name]
        func.__kwdefaults__[name] = value
        return old
    positional = [p.name for p in params if p.kind is not p.KEYWORD_ONLY]
    i = positional.index(name)
    defaults = list(func.__defaults__)
    old, defaults[i] = defaults[i], value
    func.__defaults__ = tuple(defaults)
    return old


def get_default(func, name):
    return inspect.signature(func).parameters[name].default


def _port_class(path):
    mod, _, cls = path.rpartition(".")
    return getattr(importlib.import_module(f"foundationdb_tpu_torch.{mod}"), cls)


# The reference knob a twin writes -> the port arguments whose defaults
# stand for it for the run [(class path, parameter)]: the client's sample
# rate is every Database's, the dynamic cluster's controllers' own too.
KNOB_ARGS = {
    ("client", "latency_sample_rate"): [
        ("client.transaction.Database", "latency_sample_rate"),
        ("server.cluster_controller.ClusterController", "latency_sample_rate")],
    ("server", "resolver_contention_spike_batches"): [
        ("server.resolver.Resolver", "contention_spike_batches")],
}


class _KnobSection:
    def __init__(self, section):
        object.__setattr__(self, "_section", section)

    def _targets(self, name):
        try:
            targets = KNOB_ARGS[(self._section, name)]
        except KeyError:
            raise AttributeError(f"the port has no argument for knob {self._section}.{name}")
        return [(_port_class(path).__init__, arg) for path, arg in targets]

    def __getattr__(self, name):
        return get_default(*self._targets(name)[0])

    def __setattr__(self, name, value):
        for fn, arg in self._targets(name):
            set_default(fn, arg, value)


class KnobShim:
    """The reference's ``g_knobs`` in a port twin: a knob write sets the
    default of the port argument that stands for it (KNOB_ARGS)."""

    client = _KnobSection("client")
    server = _KnobSection("server")


@contextlib.contextmanager
def port_defaults():
    """While open, the port's clusters default to device="cpu", and every
    default a KnobShim write changes is put back on close."""
    saved = {}
    for path, arg in [("server.cluster.SimCluster", "device"),
                      ("server.dynamic_cluster.DynamicCluster", "device"),
                      *[t for targets in KNOB_ARGS.values() for t in targets]]:
        fn = _port_class(path).__init__
        saved[(fn, arg)] = get_default(fn, arg)
    set_default(_port_class("server.cluster.SimCluster").__init__, "device", "cpu")
    set_default(_port_class("server.dynamic_cluster.DynamicCluster").__init__, "device", "cpu")
    try:
        yield
    finally:
        for (fn, arg), value in saved.items():
            set_default(fn, arg, value)


_LOADED: dict = {}


def load(name: str, pkg: str, subs=()):
    """Reference test module `name` for `pkg` (memoized by its
    substitutions): as it is, or pointed at the port, where a knob import
    gives the reference's g_env (read for its declared defaults) and
    KnobShim, the reference's metrics modules are the port's ``metrics``,
    the oracle stays the reference's and the device backend "jax" is
    "torch".  `subs` are (pattern,
    replacement) pairs applied to this package's copy of the source."""
    key = (name, pkg, tuple(subs))
    if key not in _LOADED:
        path = _here / f"{name}.py"
        src = path.read_text()
        if pkg == "port":
            src = re.sub(r"\bfoundationdb_tpu\b", BASES["port"], src)
            src = re.sub(r"from foundationdb_tpu_torch\.flow\.knobs import ([\w, ]+)",
                         r"from _torch_twin_knobs import \1", src)
            src = re.sub(r"foundationdb_tpu_torch\.flow\.(metrics|stats)\b",
                         "foundationdb_tpu_torch.metrics", src)
            src = src.replace('conflict_backend="jax"', 'conflict_backend="torch"')
            # The tests use the reference's oracle (the port has none).
            src = src.replace("foundationdb_tpu_torch.conflict.oracle",
                              "foundationdb_tpu.conflict.oracle")
        for pattern, repl in subs:
            src, n = re.subn(pattern, repl, src)
            assert n, (name, pkg, pattern)
        mod = pytypes.ModuleType(f"_cli_twin_{name}_{pkg}_{len(_LOADED)}")
        mod.__file__ = str(path)
        from foundationdb_tpu.flow.knobs import g_env

        shim = pytypes.ModuleType("_torch_twin_knobs")
        shim.g_env, shim.g_knobs = g_env, KnobShim()
        sys.modules["_torch_twin_knobs"] = shim
        try:
            exec(compile(src, str(path), "exec"), mod.__dict__)
        finally:
            del sys.modules["_torch_twin_knobs"]
        _LOADED[key] = mod
    return _LOADED[key]


def recount_live_actors(cli, pkg, lines):
    """A `status json` document's lines with each process's `live_actors`
    recounted as tests/test_torch_dynamic_cluster.py's status_doc does
    (the port prunes finished tasks lazily; the reference counts the
    actors unfinished at a process's last spawn)."""
    doc = json.loads("\n".join(lines))
    for addr, p in doc["cluster"].get("processes", {}).items():
        live = sum(1 for t in cli.cluster.net._procs[addr]._tasks if not t.is_ready())
        if pkg == "port":
            assert p["live_actors"] == live, addr
        p["live_actors"] = live
    return json.dumps(doc, indent=2, default=str).splitlines()


class CliLog:
    """Every ``CliProcessor.run_command`` of `cli_mod` (`pkg`'s) while
    installed: (line, output lines); lines of `skip` commands are recorded
    as None, and a status document's live_actors are recounted."""

    def __init__(self, cli_mod, pkg, patches, skip=()):
        self.lines = []
        inner = cli_mod.CliProcessor.run_command
        log = self.lines

        async def run_command(cli, line):
            out = await inner(cli, line)
            rec = None if line.split(" ")[0] in skip else list(out)
            if line.split(" ")[0] == "status" and rec and rec[0] == "{":
                rec = recount_live_actors(cli, pkg, rec)
            log.append((line, rec))
            return out

        patches.set(cli_mod.CliProcessor, "run_command", run_command)


@contextlib.contextmanager
def knobs_set(pkg, knobs):
    """While open, the reference knobs `knobs` ({(section, name): value})
    hold their values: `pkg`'s g_knobs, or the port's KnobShim (whose
    defaults port_defaults puts back)."""
    if pkg == "port":
        shim = KnobShim()
        for (section, name), value in knobs.items():
            setattr(getattr(shim, section), name, value)
        yield
        return
    from foundationdb_tpu.flow.knobs import g_knobs

    saved = {k: getattr(getattr(g_knobs, k[0]), k[1]) for k in knobs}
    try:
        for (section, name), value in knobs.items():
            setattr(getattr(g_knobs, section), name, value)
        yield
    finally:
        for (section, name), value in saved.items():
            setattr(getattr(g_knobs, section), name, value)


def ported_sets(pkg, patches):
    """Both packages' resolvers build port ConflictSet(device="cpu")s of
    the backend they name (the reference's "jax" is "torch"), at the
    Resolver's default shape: a test of the hybrid backend then compares
    the same sets."""
    from foundationdb_tpu_torch.conflict.api import ConflictSet

    def make_set(backend="torch", oldest_version=0, **_kw):
        return ConflictSet(backend="torch" if backend == "jax" else backend,
                           oldest_version=oldest_version, device="cpu")

    patches.set(importlib.import_module(f"{BASES[pkg]}.server.resolver"), "ConflictSet",
                make_set)


def run_cli_twin(pkg, arm, name, test, params=(), subs=(), skip=(), tmp_path=None,
                 monkeypatch=None, knobs=None):
    """Run `test` of reference module `name` for `pkg` in `arm` ("cpu",
    "set", or "ported": the "cpu" arm with ported_sets) with `knobs` set;
    returns its record with the CLI's lines under "cli"."""
    mod = load(name, pkg, subs)
    fn = getattr(mod, test)
    patches = DC.Patches()
    base = BASES[pkg]
    cli = CliLog(importlib.import_module(f"{base}.tools.cli"), pkg, patches, skip)
    if arm == "ported":
        ported_sets(pkg, patches)
    ref_ts = importlib.import_module("foundationdb_tpu.flow.timeseries")
    port_ts = importlib.import_module("foundationdb_tpu_torch.flow.timeseries")
    ref_hub = ref_ts.global_timeseries()
    try:
        with port_defaults(), knobs_set(pkg, knobs or {}), \
                DC.twin_run(pkg, "set" if arm == "set" else "cpu", namespaces=(mod,)) as rec:
            ref_ts.set_global_timeseries(port_ts.global_timeseries())
            args = DC.fixtures_for(fn, len(params), pkg, tmp_path, monkeypatch)
            fn(*params, **args)
    finally:
        ref_ts.set_global_timeseries(ref_hub)
        patches.undo()
    rec["cli"] = cli.lines
    return rec


def assert_cli_twins(name, test, params=(), arm="cpu", subs=None, skip=(), tmp_path=None,
                     monkeypatch=None, knobs=None):
    """The reference's run of `test` and the port's, each passing its own
    asserts, hold equal records; `subs` maps a package to its copy's
    substitutions.  Returns the port's record."""
    subs = subs or {}
    recs = {pkg: run_cli_twin(pkg, arm, name, test, params, subs.get(pkg, ()), skip,
                              tmp_path, monkeypatch, knobs)
            for pkg in ("ref", "port")}
    ref, port = recs["ref"], recs["port"]
    assert set(port) == set(ref)
    for key in ref:
        assert port[key] == ref[key], DC.first_difference(port[key], ref[key], key)
    return port


# ---------------------------------------------------------------------------
# tests/test_cli_status.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("test", [
    "test_cli_crud_and_status",
    "test_cli_explicit_transaction",
    "test_cli_configure_exclude_include",
    "test_status_qos_and_logs_sections",
    "test_cli_backup_driver",
    "test_cli_dr_driver",
    "test_cli_backup_describe_and_expire_preserves_pitr",
    "test_cli_dr_switch",
    "test_cli_backup_restore_to_timestamp",
    "test_cli_consistencycheck",
])
def test_cli_status(test):
    rec = assert_cli_twins("test_cli_status", test)
    if test == "test_cli_crud_and_status":
        assert ("get k", ["`k' is `v'"]) in rec["cli"]


# ---------------------------------------------------------------------------
# the other modules' CLI tests
# ---------------------------------------------------------------------------

def test_cli_lock_unlock():
    """tests/test_lock_database.py's lock, locked read, unlock, write."""
    rec = assert_cli_twins("test_lock_database", "test_cli_lock_unlock")
    assert rec["cli"][0][1][0].startswith("Database locked with uid ")


def test_cluster_samplers_status_and_cli():
    """tests/test_flight_recorder.py's samplers into the time-series hub,
    the status section, flightrec's inventory and artifacts, and metrics
    --diff, with every transaction sampled (the latency_sample_rate knob:
    the port's Database argument)."""
    rec = assert_cli_twins("test_flight_recorder", "test_cluster_samplers_status_and_cli")
    assert [line for line, _out in rec["cli"]][-2:] == [
        "metrics --diff --format=json", "metrics --diff"]


# The reference's DeviceFaultInjector is the port's for both runs: both
# clusters' sets are the port's, which absorb only the port's faults.
PORT_INJECTOR = (r"inj = DeviceFaultInjector\(\)",
                 'inj = __import__("foundationdb_tpu_torch.conflict.device_faults", '
                 'fromlist=["x"]).DeviceFaultInjector()')


def test_cluster_resolver_absorbs_device_outage_and_status_surfaces():
    """tests/test_device_faults.py: a dispatch outage under commits, the
    breaker's walk in the status document and `status --format=json`."""
    rec = assert_cli_twins("test_device_faults",
                           "test_cluster_resolver_absorbs_device_outage_and_status_surfaces",
                           arm="set", subs={"ref": [PORT_INJECTOR]})
    (line, out), = rec["cli"]
    assert line == "status --format=json" and '"backend_state": "ok"' in "\n".join(out)


# The plant on the device's floor row, on a torch tensor in both runs.
PLANT_FLOOR = (r"cs\._jax\._hvers = cs\._jax\._hvers\.at\[0\]\.set\(12345\)",
               "cs._jax._hvers[0] = 12345")


@pytest.mark.parametrize("test", ["test_cluster_checker_catches_divergence_within_one_period",
                                  "test_cli_mirror_check_healthy_cluster"])
def test_mirror_check_cli(test):
    """tests/test_mirror_snapshot.py: mirror-check (text and json) on a
    healthy cluster, and after a planted divergence the periodic check
    caught, beside status --format=json's mirror block."""
    rec = assert_cli_twins("test_mirror_snapshot", test, arm="set",
                           subs={"ref": [PLANT_FLOOR], "port": [PLANT_FLOOR]})
    assert any(line == "mirror-check" for line, _out in rec["cli"])


def test_cli_contention_same_seed_byte_identical():
    """tests/test_witness.py:615: `contention --format=json` over a hot key
    on two resolvers, byte-identical for a seed, another seed's differs."""
    rec = assert_cli_twins("test_witness", "test_cli_contention_same_seed_byte_identical")
    assert len(rec["cli"]) == 3
