"""The port's sampling profiler (``flow/profiler.py``), its runtime toggle
over a worker's ``ProfilerRequest`` and the CLI's ``profile``, held to the
reference's on the CPU.

Twins of the 5 tests of tests/test_profiler.py.  The profiler samples the
interpreter on the wall clock, so its counts differ run to run: the first
four run the port's copy of each test (tests/test_torch_cli.py's loader)
with its own assertions, and the empty report and the toggle's state are
compared with the reference's.  The worker's toggle runs in both packages
through tests/test_torch_cli.py's twin runner: every worker request (the
ProfilerRequest among them), client event, trace event, status document
and loop end are equal, and so is every CLI line but ``profile report``'s
sample counts.
"""

from __future__ import annotations

import importlib.util
import pathlib

import pytest

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_cli_twins_profiler", _here / "test_torch_cli.py")
CLI = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CLI)
_restore_globals = CLI._restore_globals
_one_thread = CLI._one_thread


@pytest.fixture(autouse=True)
def _profilers_off():
    yield
    from foundationdb_tpu.flow.profiler import profiler_toggle as ref_toggle
    from foundationdb_tpu_torch.flow.profiler import profiler_toggle

    profiler_toggle(False)
    ref_toggle(False)


@pytest.mark.parametrize("test", [
    "test_sampler_catches_hot_function",
    "test_toggle_stops_sampling",
    "test_report_shape_and_clear",
    "test_global_toggle_helpers",
])
def test_profiler(test):
    getattr(CLI.load("test_profiler", "port"), test)()


def test_report_and_toggle_equal_the_references():
    from foundationdb_tpu.flow import profiler as ref
    from foundationdb_tpu_torch.flow import profiler as port

    assert port.SamplingProfiler(interval=0.002).report(top=3) == \
        ref.SamplingProfiler(interval=0.002).report(top=3)
    assert port.profiler_toggle(False, 0.004) == ref.profiler_toggle(False, 0.004)
    assert port.get_profiler() is port.get_profiler() is not ref.get_profiler()


def test_worker_rpc_toggle_and_cli():
    rec = CLI.assert_cli_twins("test_profiler", "test_worker_rpc_toggle_and_cli",
                               skip=("profile",))
    assert [kind for _t, _a, kind, _g, _b in rec["recruits"]].count("ProfilerRequest") == 2
    assert rec["cli"] == [("profile report", None)]
