"""The port's task bucket and backup (``layers/taskbucket.py``,
``layers/backup.py``) and its backup workloads
(``workloads/backup_correctness.py``, ``workloads/atomic_restore.py``),
held to the reference's on the CPU.

Each twin runs one reference test function for each package
(tests/test_torch_layers.py's ``assert_layer_twins``) and holds the
records equal, the backup containers' bytes in every SimFileSystem and the
logs' pop floors among them.  Twinned: all 6 of
tests/test_taskbucket_backup.py, and tests/test_new_workloads.py's
continuous backup under chaos (both seeds) and atomic restore on a live
cluster, each on each package's host engine ("cpu"); the continuous
backup and the workloads also with every resolver over a port
ConflictSet(device="cpu", key_words=4) ("set").  Then the container's
bytes against the reference's codec directly.
"""

from __future__ import annotations

import importlib
import importlib.util
import pathlib

import pytest

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_layer_twins_backup",
                                               _here / "test_torch_layers.py")
LT = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(LT)
_restore_globals = LT._restore_globals
set_arm = LT.set_arm
assert_layer_twins = LT.assert_layer_twins

TB = "test_taskbucket_backup"
NW = "test_new_workloads"


def backup_files(rec):
    """Every container file the run wrote: (machine, name) -> bytes."""
    return {k: v for fs in rec["files"] for k, v in fs.items()}


@pytest.mark.parametrize("test", [
    "test_taskbucket_chain_runs_exactly_once",
    "test_taskbucket_lease_expiry_reclaims",
    "test_backup_restore_roundtrip",
    "test_backup_is_point_in_time_under_writes",
    "test_continuous_backup_point_in_time_restore",
    "test_continuous_backup_subrange_clear_clamps_low_edge",
])
def test_taskbucket_backup(test):
    rec = assert_layer_twins(TB, test)
    if "backup" in test:
        files = backup_files(rec)
        assert any(name.endswith("manifest") for _m, name in files), sorted(files)


@pytest.mark.parametrize("test", [
    "test_backup_restore_roundtrip",
    "test_continuous_backup_point_in_time_restore",
])
def test_taskbucket_backup_over_the_ports_set(test, set_arm):
    rec = assert_layer_twins(TB, test, arm="set")
    assert backup_files(rec)


def test_continuous_backup_logs_hold_the_pop_floors():
    """The continuous backup's tag holds both logs' floors at what it
    logged (the reference's pops, version for version)."""
    rec = assert_layer_twins(TB, "test_continuous_backup_point_in_time_restore")
    floors = [dict(p).get("_backup") for p in rec["pops"]]
    assert len(floors) == 2 and floors[0] == floors[1] and floors[0] > 0
    assert any(name.startswith("bk1/log-") for _m, name in backup_files(rec))


@pytest.mark.parametrize("seed", [580, 581])
def test_backup_correctness_under_chaos(seed):
    rec = assert_layer_twins(NW, "test_backup_correctness_under_chaos", (seed,))
    assert any(name.startswith("bk_corr/") for _m, name in backup_files(rec))


def test_backup_correctness_over_the_ports_set(set_arm):
    assert_layer_twins(NW, "test_backup_correctness_under_chaos", (580,), arm="set")


def test_atomic_restore_on_live_cluster():
    rec = assert_layer_twins(NW, "test_atomic_restore_on_live_cluster")
    errs = [e for e in rec["events"] if "database_locked" in e]
    assert errs, "the observer never met the lock"


def test_atomic_restore_over_the_ports_set(set_arm):
    assert_layer_twins(NW, "test_atomic_restore_on_live_cluster", arm="set")


def test_container_blobs_are_the_reference_codec():
    """A container blob is the 8-byte length and the wire frame, both the
    reference's bytes, for pages, log chunks and manifests."""
    from foundationdb_tpu.rpc.wire import encode_frame as ref_encode
    from foundationdb_tpu_torch.client.types import Mutation, MutationType
    from foundationdb_tpu_torch.rpc.wire import decode_frame, encode_frame

    rows = [(b"k%03d" % i, b"v" * i) for i in range(5)]
    log = (7, 9, [(8, [Mutation(MutationType.SET_VALUE, b"a", b"b"),
                      Mutation(MutationType.CLEAR_RANGE, b"c", b"d")])])
    manifest = {"version": 7, "pages": 1, "begin": b"", "end": b"\xff", "log_chunks": 1,
                "first_log_chunk": 0, "logged_through": 9}
    for obj in ((b"k", rows), manifest):
        assert encode_frame(obj) == ref_encode(obj)
        assert decode_frame(encode_frame(obj)) == obj
    ref_types = importlib.import_module("foundationdb_tpu.client.types")
    ref_log = (7, 9, [(8, [ref_types.Mutation(ref_types.MutationType.SET_VALUE, b"a", b"b"),
                           ref_types.Mutation(ref_types.MutationType.CLEAR_RANGE, b"c", b"d")])])
    assert encode_frame(log) == ref_encode(ref_log)
