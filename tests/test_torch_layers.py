"""The port's layers (``layers/tuple.py``, ``subspace.py``,
``directory.py``, ``queue.py``, ``pubsub.py``), held to the reference's on
the CPU.

Each twin runs one test function of a reference test module for each
package (tests/test_torch_dynamic_cluster.py's twin runner: the module's
source loaded once as it is and once pointed at the port) and holds the
two runs' records equal: every client read, commit and retry with its
virtual time, every trace event less its wall time, each cluster's status
document, each event loop's end time and its rng's next draw, and, from
``layer_run``, every file's bytes in each SimFileSystem, every log's pop
floors by tag and every blob store's objects and request bytes.  Twinned
here: all 5 of tests/test_layers.py and all 4 of
tests/test_layers_recipes.py, each package's host engine ("cpu"), and
some also with every resolver over a port ConflictSet(device="cpu",
key_words=4) ("set": the layers' long keys meet the long-key side table).
Then the tuple codec's bytes, held to the reference's value by value.
tests/test_torch_backup.py, test_torch_dr.py and test_torch_blobstore.py
use ``assert_layer_twins`` for the rest of the layers.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import inspect
import itertools
import pathlib
import socket
import uuid

import pytest

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_dc_twins_layers",
                                               _here / "test_torch_dynamic_cluster.py")
DC = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(DC)
_restore_globals = DC._restore_globals
SMOKE = DC.SMOKE
BASES = DC.BASES

# The "set" arm's shape: the Resolver's default key width, the rig's
# history (tests/test_torch_new_workloads.py's set arm).
LAYER_SET_KW = dict(key_words=4, h_cap=1 << 10, bucket_mins=(32, 128, 64))


@contextlib.contextmanager
def layer_run(pkg, arm, mod, depth=None):
    """DC.twin_run for `pkg` in `arm` over the names of test module `mod`,
    and on close also, in the yielded record: every SimFileSystem's files
    (durable bytes and pending writes, by machine and name), every TLog's
    pop floors (tag -> version), every BlobStoreServer's objects and the
    bytes of every request a blob store endpoint built, in order."""
    imp = importlib.import_module
    base = BASES[pkg]
    simfile = imp(f"{base}.fileio.simfile")
    tlog = imp(f"{base}.server.tlog")
    blob = imp(f"{base}.fileio.blobstore")
    patches = DC.Patches()
    made = {"fs": [], "logs": [], "servers": []}

    def tracking(cls, key):
        inner = cls.__init__

        def __init__(obj, *a, **kw):
            inner(obj, *a, **kw)
            made[key].append(obj)

        patches.set(cls, "__init__", __init__)

    tracking(simfile.SimFileSystem, "fs")
    tracking(tlog.TLog, "logs")
    tracking(blob.BlobStoreServer, "servers")
    requests = []
    build = blob.build_request

    def build_request(*a, **kw):
        raw = build(*a, **kw)
        requests.append(raw)
        return raw

    patches.set(blob, "build_request", build_request)
    try:
        with DC.twin_run(pkg, arm, depth, namespaces=(mod,)) as rec:
            yield rec
        rec.update(
            files=[SMOKE.disk_state(fs) for fs in made["fs"]],
            pops=[sorted(t.popped_tags.items()) for t in made["logs"]],
            objects=[sorted(s.objects.items()) for s in made["servers"]],
            requests=requests,
        )
    finally:
        patches.undo()
        for s in made["servers"]:
            # Frees the port for the other package's run.
            SMOKE.stop_blob_server(s)


def free_port() -> int:
    """A localhost port nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_layer_twin(pkg, arm, name, test, params=(), depth=None, port=0):
    """Run test function `test` of reference test module `name` for `pkg`
    in `arm`; returns its record.  A `server` argument is
    tests/test_blobstore.py's fixture: the package's BlobStoreServer, on
    localhost `port` (the URL lands in the database, so both runs use one
    port)."""
    mod = DC.load_twin(name, pkg)
    fn = getattr(mod, test)
    with layer_run(pkg, arm, mod, depth) as rec:
        args = {}
        for arg in list(inspect.signature(fn).parameters)[len(params):]:
            if arg != "server":
                raise LookupError(f"no twin fixture {arg!r}")
            args[arg] = importlib.import_module(
                f"{BASES[pkg]}.fileio.blobstore").BlobStoreServer(port=port)
        fn(*params, **args)
    return rec


def assert_layer_twins(name, test, params=(), arm="cpu", depth=None):
    """The reference's run of `test` and the port's, each passing its own
    asserts, hold equal records; returns the port's."""
    blob_port = free_port()
    ref = run_layer_twin("ref", arm, name, test, params, depth, blob_port)
    port = run_layer_twin("port", arm, name, test, params, depth, blob_port)
    assert set(port) == set(ref)
    for key in ref:
        assert port[key] == ref[key], DC.first_difference(port[key], ref[key], key)
    return port


@pytest.fixture
def set_arm(monkeypatch):
    """The "set" arm's resolvers at LAYER_SET_KW."""
    monkeypatch.setattr(DC, "SET_KW", LAYER_SET_KW)


def commits(rec) -> int:
    return sum(1 for e in rec["events"] if e[0] == "commit")


# ---------------------------------------------------------------------------
# tests/test_layers.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("test", [
    "test_tuple_roundtrip",
    "test_tuple_ordering_matches_bytes",
    "test_subspace",
    "test_directory_create_open_list_move_remove",
    "test_hca_concurrent_allocations_unique",
])
def test_layers(test):
    assert_layer_twins("test_layers", test)


@pytest.mark.parametrize("test", [
    "test_directory_create_open_list_move_remove",
    "test_hca_concurrent_allocations_unique",
])
def test_layers_over_the_ports_set(test, set_arm):
    rec = assert_layer_twins("test_layers", test, arm="set")
    assert commits(rec) > 0


# ---------------------------------------------------------------------------
# tests/test_layers_recipes.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("test", [
    "test_queue_versionstamped_push_is_contention_free",
    "test_vector_recipe",
    "test_pubsub_feeds_inboxes_watermarks",
    "test_transactional_decorator_composes",
])
def test_layers_recipes(test):
    assert_layer_twins("test_layers_recipes", test)


@pytest.mark.parametrize("test", [
    "test_queue_versionstamped_push_is_contention_free",
    "test_pubsub_feeds_inboxes_watermarks",
])
def test_layers_recipes_over_the_ports_set(test, set_arm):
    rec = assert_layer_twins("test_layers_recipes", test, arm="set")
    # The pushes never conflict: no commit of the queue's failed.
    if test.startswith("test_queue"):
        assert not [e for e in rec["events"] if e[0] == "commit" and "not_committed" in e]


# ---------------------------------------------------------------------------
# the tuple codec, value by value
# ---------------------------------------------------------------------------

def _values(pkg):
    tup = importlib.import_module(f"{BASES[pkg]}.layers.tuple")
    vs = tup.Versionstamp
    return tup, [
        (), (None,), (b"",), (b"\x00\xff\x00",), ("☃", "", "a\x00b"),
        (0, 1, -1, 255, 256, -255, -256, 2**63 - 1, -(2**63) + 1, 2**64 - 1, -(2**64) + 1),
        (1.5, -1.5, 0.0, -0.0, float("inf"), float("-inf"), 3.141592653589793, 1e-300),
        (True, False), (uuid.UUID(int=0x1234567890ABCDEF1234567890ABCDEF),),
        ((b"nested", (1, None), ()), 2, (None, (None,))),
        (vs(b"\x01" * 10, 7), vs()), ("x", 1, b"y", (2.5, False)),
    ]


def _norm_tuple(v):
    """A decoded tuple with each Versionstamp as its bytes (the packages'
    classes differ)."""
    if isinstance(v, tuple):
        return tuple(_norm_tuple(x) for x in v)
    if type(v).__name__ == "Versionstamp":
        return ("vs", v.to_bytes(), v.is_complete())
    return v


def test_tuple_codec_bytes_equal_the_reference():
    ref, ref_vals = _values("ref")
    port, port_vals = _values("port")
    for rv, pv in zip(ref_vals, port_vals):
        packed = port.pack(pv)
        assert packed == ref.pack(rv), pv
        assert _norm_tuple(port.unpack(packed)) == _norm_tuple(ref.unpack(packed))
        assert port.range_of(pv) == ref.range_of(rv)
    for bad in ((2**64,), (-(2**64),), (object(),)):
        for mod in (ref, port):
            with pytest.raises((ValueError, TypeError)):
                mod.pack(bad)


def test_tuple_order_is_the_reference_order():
    _ref, _ = _values("ref")
    port, vals = _values("port")
    ints = [(i,) for i in (-(2**40), -65536, -256, -255, -1, 0, 1, 255, 256, 2**40)]
    texts = [(s,) for s in ("", "a", "a\x00", "ab", "b", "☃")]
    floats = [(f,) for f in (float("-inf"), -2.5, -0.0, 0.0, 1e-300, 2.5, float("inf"))]
    for group in (ints, texts, floats):
        for a, b in itertools.combinations(group, 2):
            assert (port.pack(a) < port.pack(b)) == (a < b or (a == b and str(a) < str(b))), (a, b)


def test_subspace_and_directory_keys_equal_the_reference():
    ref_sub = importlib.import_module("foundationdb_tpu.layers.subspace")
    port_sub = importlib.import_module("foundationdb_tpu_torch.layers.subspace")
    ref_dir = importlib.import_module("foundationdb_tpu.layers.directory")
    port_dir = importlib.import_module("foundationdb_tpu_torch.layers.directory")
    for sub in (ref_sub, port_sub):
        s = sub.Subspace(("app", 1), raw_prefix=b"\x05")
        with pytest.raises(ValueError):
            s.unpack(b"elsewhere")
    r, p = ref_sub.Subspace(("app", 1)), port_sub.Subspace(("app", 1))
    assert (p.key(), p.pack((b"k", 2)), p.range(), p[b"sub"].raw_prefix) == (
        r.key(), r.pack((b"k", 2)), r.range(), r[b"sub"].raw_prefix)
    rd, pd = ref_dir.DirectoryLayer(), port_dir.DirectoryLayer()
    assert pd._child_key(pd._node(b"\x15\x05"), "users") == rd._child_key(
        rd._node(b"\x15\x05"), "users")
    assert (pd._allocator.counters.raw_prefix, pd._allocator.recent.raw_prefix) == (
        rd._allocator.counters.raw_prefix, rd._allocator.recent.raw_prefix)
    for start in (0, 254, 255, 65534, 65535):
        assert (port_dir.HighContentionAllocator._window_size(start)
                == ref_dir.HighContentionAllocator._window_size(start))
