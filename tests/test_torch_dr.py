"""The port's DR agent (``layers/dr.py``), held to the reference's on the
CPU.

Each twin runs one reference test function for each package
(tests/test_torch_layers.py's ``assert_layer_twins``) and holds the
records equal: both clusters' reads, commits and retries on their one
loop, and every source log's pop floors by tag (DR's popped versions: a
record that skipped them would hide a lost mutation).  Twinned: all 6 of
tests/test_dr.py and tests/test_multiregion.py's
``test_dr_multi_log_source``, on each package's host engine ("cpu"), and
some also with every resolver of both clusters over a port
ConflictSet(device="cpu", key_words=4) ("set").
tests/test_torch_coordination.py keeps its merge-cursor stand-in of the
multi-log source.
"""

from __future__ import annotations

import importlib.util
import pathlib

import pytest

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_layer_twins_dr", _here / "test_torch_layers.py")
LT = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(LT)
_restore_globals = LT._restore_globals
set_arm = LT.set_arm
assert_layer_twins = LT.assert_layer_twins

DR_TESTS = [
    "test_dr_snapshot_then_tail",
    "test_dr_destination_is_always_a_consistent_prefix",
    "test_dr_follows_sharded_source",
    "test_dr_atomic_switchover",
    "test_dr_switchover_unwinds_on_locked_destination",
    "test_dr_abort_leaves_usable_consistent_destination",
]


def dr_floors(rec, tag="_dr"):
    """The floor `tag` holds on each log the run built, where it holds one."""
    return [dict(p)[tag] for p in rec["pops"] if tag in dict(p)]


@pytest.mark.parametrize("test", DR_TESTS)
def test_dr(test):
    rec = assert_layer_twins("test_dr", test)
    floors = dr_floors(rec)
    if test == "test_dr_abort_leaves_usable_consistent_destination":
        assert floors == []  # unregistered on abort
    elif test == "test_dr_atomic_switchover":
        # The forward tag unregistered; the reverse tag holds the new
        # primary's log.
        assert floors == [] and dr_floors(rec, "_dr_rev")[0] > 0
    else:
        assert len(floors) == 1 and floors[0] > 0


@pytest.mark.parametrize("test", [
    "test_dr_destination_is_always_a_consistent_prefix",
    "test_dr_atomic_switchover",
])
def test_dr_over_the_ports_set(test, set_arm):
    assert_layer_twins("test_dr", test, arm="set")


def test_dr_multi_log_source():
    rec = assert_layer_twins("test_multiregion", "test_dr_multi_log_source")
    floors = dr_floors(rec)
    # Both source logs hold the DR tag's floor, at one version.
    assert len(floors) == 2 and floors[0] == floors[1] and floors[0] > 0


def test_dr_multi_log_source_over_the_ports_set(set_arm):
    assert_layer_twins("test_multiregion", "test_dr_multi_log_source", arm="set")
