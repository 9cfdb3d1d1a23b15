"""The port's blob store (``fileio/blobstore.py``: the HTTP/1.1 codec, the
token bucket, BlobStoreEndpoint and the localhost BlobStoreServer) and its
``blobstore://`` backup container, held to the reference's on the CPU.

Each twin runs one of tests/test_blobstore.py's 9 test functions for each
package (tests/test_torch_layers.py's ``assert_layer_twins``; its
``server`` fixture is the package's own BlobStoreServer on a localhost
port) and holds the records equal: the bytes of every request an
endpoint built, in order, every server's stored objects, and the
cluster's reads and commits where the test drives one.  Then fdblint's
exemptions of the module, rule by rule, equal to the reference's, and
both linters' findings on its source equal.
"""

from __future__ import annotations

import importlib.util
import pathlib

import pytest

from foundationdb_tpu.tools.lint.base import DEFAULT_ALLOW as REF_ALLOW
from foundationdb_tpu.tools.lint.base import _match_any as ref_match_any
from foundationdb_tpu.tools.lint.project import lint_source as ref_lint_source
from foundationdb_tpu_torch.tools.lint import base, runner

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_layer_twins_blob", _here / "test_torch_layers.py")
LT = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(LT)
_restore_globals = LT._restore_globals
assert_layer_twins = LT.assert_layer_twins

PORT = _here.parent / "foundationdb_tpu_torch"
BLOB = "fileio/blobstore.py"


@pytest.mark.parametrize("test", [
    "test_http_codec_roundtrip",
    "test_endpoint_crud_and_listing",
    "test_endpoint_url_knobs",
    "test_token_bucket_paces_requests",
    "test_token_bucket_injectable_clock_is_deterministic",
    "test_retry_backoff_sleep_is_injectable",
    "test_endpoint_reconnects_after_connection_loss",
    "test_snapshot_backup_to_blobstore_and_restore",
    "test_http_codec_rejects_garbage_loudly",
])
def test_blobstore(test):
    rec = assert_layer_twins("test_blobstore", test)
    if test in ("test_endpoint_crud_and_listing", "test_snapshot_backup_to_blobstore_and_restore"):
        assert rec["objects"] and rec["objects"][0], "the server stored nothing"
        assert rec["requests"]


def test_blob_backup_objects_are_the_reference_frames():
    """The blob container's pages and manifest, stored on the server, are
    the reference's wire frames (no length prefix on the blob flavor)."""
    from foundationdb_tpu.rpc.wire import decode_frame as ref_decode

    rec = assert_layer_twins("test_blobstore", "test_snapshot_backup_to_blobstore_and_restore")
    objects = dict(rec["objects"][0])
    names = sorted(n for (_b, n) in objects)
    assert names[-1] == "snap1/range-000000" and "snap1/manifest" in names
    manifest = ref_decode(objects[("backup", "snap1/manifest")])
    assert (manifest["pages"], manifest["begin"], manifest["end"]) == (1, b"bs", b"bt")
    _begin, rows = ref_decode(objects[("backup", "snap1/range-000000")])
    assert len(rows) == 120 and rows[5] == (b"bs005", b"val5")


@pytest.mark.parametrize("rule", sorted(set(base.RULES) - {"PRG001", "PRG002"}))
def test_blobstore_exemptions_are_the_reference_s(rule):
    assert base.allows(rule, BLOB) == ref_match_any(BLOB, REF_ALLOW.get(rule, ()))


def test_blobstore_findings_are_the_reference_s():
    """Both linters on the port's module at its path: the three reasoned
    DET001 pragmas, suppressed, and nothing else."""
    src = (PORT / BLOB).read_text()
    got = runner.lint_source(src, BLOB, tools=("fdblint",))
    want = [f for f in ref_lint_source(src, BLOB) if f.rule in base.RULES]
    rows = sorted((f.rule, f.line, f.suppressed) for f in got)
    assert rows == sorted((f.rule, f.line, f.suppressed) for f in want)
    assert rows == [("DET001", 157, True), ("DET001", 158, True), ("DET001", 202, True)]
    # Off the exempt path, the threads and sockets are findings.
    elsewhere = {f.rule for f in runner.lint_source(src, "server/x.py", tools=("fdblint",))
                 if not f.suppressed}
    assert {"DET003", "IO001"} <= elsewhere
