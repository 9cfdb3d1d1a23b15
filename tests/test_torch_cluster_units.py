"""The commit path's building blocks in the port, held to the reference's.

Twins of tests/test_rangemap.py, tests/test_indexed_set.py,
tests/test_versioned_clears.py and the pure-Python half of
tests/test_wire.py, each run on the port's module and, on the same seeded
inputs, on the reference's, with every result equal; the port's wire
frames byte for byte the reference's ``encode_frame_py`` for every ported
struct and enum; ``apply_atomic`` for every atomic ``MutationType`` and
``transform_versionstamp``; the system keys' encodings; and the
simulation-validation marks.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from enum import IntEnum

import numpy as np
import pytest

import foundationdb_tpu.client.atomic as ref_atomic
import foundationdb_tpu.client.types as ref_types
import foundationdb_tpu.flow.sim_validation as ref_sv
import foundationdb_tpu.rpc.wire as ref_wire
import foundationdb_tpu.server.interfaces as ref_if
import foundationdb_tpu.server.storage as ref_storage
import foundationdb_tpu.server.system_keys as ref_sk
from foundationdb_tpu.flow.rng import DeterministicRandom as RefRandom
from foundationdb_tpu.utils import RangeMap as RefRangeMap
from foundationdb_tpu.utils.indexed_set import IndexedSet as RefIndexedSet
from foundationdb_tpu_torch.client import atomic as port_atomic
from foundationdb_tpu_torch.client import types as port_types
from foundationdb_tpu_torch.client.types import CommitTransactionRef, Mutation, MutationType
from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo
from foundationdb_tpu_torch.flow import sim_validation as port_sv
from foundationdb_tpu_torch.flow.eventloop import EventLoop
from foundationdb_tpu_torch.flow.rng import DeterministicRandom
from foundationdb_tpu_torch.rpc import wire
from foundationdb_tpu_torch.rpc.network import Endpoint
from foundationdb_tpu_torch.rpc.stream import RequestStreamRef, _Envelope
from foundationdb_tpu_torch.rpc.wire import (
    WIRE_VERSION,
    WireDecodeError,
    WireEncodeError,
    decode_frame,
    encode_frame,
)
from foundationdb_tpu_torch.server import interfaces as port_if
from foundationdb_tpu_torch.server import storage as port_storage
from foundationdb_tpu_torch.server import system_keys as port_sk
from foundationdb_tpu_torch.server.interfaces import (
    CommitTransactionRequest,
    GetKeyValuesRequest,
    GetStorageMetricsReply,
    ResolveTransactionBatchRequest,
    StorageInterface,
)
from foundationdb_tpu_torch.utils import RangeMap
from foundationdb_tpu_torch.utils.indexed_set import IndexedSet


def k(i):
    return b"%06d" % i


# ---------------------------------------------------------------------------
# RangeMap (tests/test_rangemap.py)
# ---------------------------------------------------------------------------


def _both_maps(default):
    return RangeMap(default), RefRangeMap(default)


def test_rangemap_basic_set_get():
    for m in _both_maps("s0"):
        assert m[b""] == "s0" and m[b"zzz"] == "s0"
        m.set_range(b"b", b"d", "s1")
        assert m[b"a"] == "s0" and m[b"b"] == "s1" and m[b"c\xff"] == "s1" and m[b"d"] == "s0"
        assert list(m.items()) == [(b"", b"b", "s0"), (b"b", b"d", "s1"), (b"d", None, "s0")]


def test_rangemap_coalescing():
    for m in _both_maps("a"):
        m.set_range(b"b", b"c", "b")
        m.set_range(b"c", b"d", "b")
        assert list(m.items()) == [(b"", b"b", "a"), (b"b", b"d", "b"), (b"d", None, "a")]
        m.set_range(b"b", b"d", "a")
        assert list(m.items()) == [(b"", None, "a")]


def test_rangemap_set_to_infinity():
    for m in _both_maps("x"):
        m.set_range(b"m", None, "y")
        assert m[b"z"] == "y" and m[b"a"] == "x"
        assert list(m.items()) == [(b"", b"m", "x"), (b"m", None, "y")]


def test_rangemap_intersecting_clips_and_boundaries():
    port, ref = _both_maps("a")
    for m in (port, ref):
        m.set_range(b"c", b"f", "b")
        assert list(m.intersecting(b"d", b"z")) == [(b"d", b"f", "b"), (b"f", b"z", "a")]
        assert list(m.intersecting(b"c", b"d")) == [(b"c", b"d", "b")]
        m.insert_boundary(b"e", "c")
        m.insert_boundary(b"c", "d")
    assert port.begins == ref.begins and port.values == ref.values
    assert port.range_containing(b"e1") == ref.range_containing(b"e1")


def test_rangemap_randomized_vs_reference_and_bruteforce():
    rng = np.random.default_rng(5)
    m, r = _both_maps(0)
    keys = [b"%03d" % i for i in range(100)]
    brute = {key: 0 for key in keys}
    for step in range(300):
        a, b = sorted(rng.integers(0, 100, 2))
        v = int(rng.integers(0, 5))
        if a == b:
            b = a + 1
        m.set_range(b"%03d" % a, b"%03d" % b, v)
        r.set_range(b"%03d" % a, b"%03d" % b, v)
        for i in range(a, b):
            brute[b"%03d" % i] = v
        for key in keys:
            assert m[key] == brute[key], (step, key)
        assert m.begins == r.begins and m.values == r.values, step
        assert m.begins == sorted(set(m.begins))
        assert all(m.values[i] != m.values[i - 1] for i in range(1, len(m.values)))


# ---------------------------------------------------------------------------
# IndexedSet and ByteSample (tests/test_indexed_set.py)
# ---------------------------------------------------------------------------


def _shape(n):
    """The treap's full shape: (key, weight, prio, sum, count) in order,
    with each node's children."""
    if n is None:
        return None
    return (n.key, n.weight, n.prio, n.sum, n.count, _shape(n.left), _shape(n.right))


def test_indexed_set_differential_vs_dict_model_and_reference():
    py = random.Random(7)
    s, r = IndexedSet(DeterministicRandom(7)), RefIndexedSet(RefRandom(7))
    model = {}
    for step in range(3000):
        op = py.random()
        key = k(py.randrange(0, 400))
        if op < 0.5:
            w = py.randrange(1, 1000)
            s.set(key, w)
            r.set(key, w)
            model[key] = w
        elif op < 0.7:
            s.erase(key)
            r.erase(key)
            model.pop(key, None)
        elif op < 0.8:
            a, b = sorted((k(py.randrange(0, 400)), k(py.randrange(0, 400))))
            s.erase_range(a, b)
            r.erase_range(a, b)
            for mk in [x for x in model if a <= x < b]:
                del model[mk]
        else:
            a, b = sorted((k(py.randrange(0, 400)), k(py.randrange(0, 400))))
            assert s.sum_range(a, b) == sum(w for mk, w in model.items() if a <= mk < b), step
            assert s.count_range(a, b) == sum(1 for mk in model if a <= mk < b), step
            assert s.key_at_metric(a, b, 500) == r.key_at_metric(a, b, 500), step
        if step % 500 == 0:
            assert len(s) == len(model)
            assert s.keys_in(b"", None) == sorted(model)
    assert s.sum_range(b"", None) == sum(model.values())
    # Same rng, same draws: the same tree, node for node.
    assert _shape(s.root) == _shape(r.root)


def test_indexed_set_key_at_metric():
    s = IndexedSet(DeterministicRandom(9))
    for i in range(10):
        s.set(k(i), 10)  # total 100
    assert s.key_at_metric(b"", None, 35) == k(3)
    assert s.key_at_metric(b"", None, 0) == k(0)
    assert s.key_at_metric(b"", None, 99) == k(9)
    assert s.key_at_metric(b"", None, 100) is None
    assert s.key_at_metric(k(5), None, 15) == k(6)
    assert s.key_at_metric(k(5), k(8), 25) == k(7)
    assert s.key_at_metric(k(5), k(8), 30) is None


def test_indexed_set_treap_scales_like_the_reference():
    """The port's treap at 4,096 keys: the same shape, depth and answers as
    the reference's, built from the same seed (the reference's scaling
    sweep is a slow test; the structure it times is this one)."""
    sets = []
    for S, R in ((IndexedSet, DeterministicRandom), (RefIndexedSet, RefRandom)):
        s = S(R(1))
        for i in range(1 << 12):
            s.set(k(i * 7 % (1 << 12)), 10 + i % 90)
        sets.append(s)

    def depth(n):
        return 0 if n is None else 1 + max(depth(n.left), depth(n.right))

    port, ref = sets
    assert _shape(port.root) == _shape(ref.root)
    assert depth(port.root) < 40  # ~3 log2(n): a treap, not a list
    assert port.sum_range(k(1024), k(3072)) == ref.sum_range(k(1024), k(3072))


def test_byte_sample_matches_the_reference():
    samples = [port_storage.ByteSample(DeterministicRandom(11)),
               ref_storage.ByteSample(RefRandom(11))]
    for bs in samples:
        for i in range(50):
            bs.update(k(i), 200)  # always admitted (>= UNIT)
        assert bs.bytes_in(b"", None) == 50 * 200
        assert bs.bytes_in(k(10), k(20)) == 10 * 200
        sp = bs.split_point(b"", None)
        assert sp is not None and k(20) <= sp <= k(30)
        bs.remove_range(k(0), k(25))
        assert bs.bytes_in(b"", None) == 25 * 200
        bs.update(k(30), 1000)
        assert bs.bytes_in(k(30), k(31)) == 1000
        assert bs.split_point(k(40), k(41)) is None
        for i in range(200):  # small keys: admitted at random, one draw each
            bs.update(k(100 + i), 1 + i % 90)
    port, ref = samples
    assert port.idx.keys_in(b"", None) == ref.idx.keys_in(b"", None)
    assert port.bytes_in(b"", None) == ref.bytes_in(b"", None)
    assert port.split_point(b"", None) == ref.split_point(b"", None)


# ---------------------------------------------------------------------------
# VersionedClears / VersionedStore (tests/test_versioned_clears.py)
# ---------------------------------------------------------------------------


class FlatOracle:
    """A flat list of clears, the differential oracle."""

    def __init__(self):
        self.clears = []

    def add(self, b, e, v, s):
        if b < e:
            self.clears.append((v, s, b, e))

    def latest_over(self, key, version):
        best = (-1, -1)
        for v, s, b, e in self.clears:
            if v <= version and b <= key < e and (v, s) > best:
                best = (v, s)
        return best

    def trim(self, through):
        self.clears = [c for c in self.clears if c[0] > through]


def kk(i):
    return b"%05d" % i


def test_versioned_clears_vs_flat_oracle_and_reference():
    rng = random.Random(77)
    vc, ref, oracle = port_storage.VersionedClears(), ref_storage.VersionedClears(), FlatOracle()
    version = 0
    for step in range(400):
        version += rng.randint(1, 3)
        op = rng.random()
        if op < 0.55:
            a = rng.randint(0, 500)
            b = a + rng.randint(1, 60)
            seq = rng.randint(0, 5)
            for x in (vc, ref, oracle):
                x.add(kk(a), kk(b), version, seq)
        elif op < 0.7 and step > 50:
            cut = version - rng.randint(5, 50)
            for x in (vc, ref, oracle):
                x.trim(cut)
        for _ in range(10):
            key = kk(rng.randint(0, 520))
            at = version - rng.randint(0, 40)
            assert vc.latest_over(key, at) == oracle.latest_over(key, at), step
        assert vc.bounds == ref.bounds and vc.stamps == ref.stamps, step


def test_versioned_clears_iteration_is_coverage_equivalent():
    vc = port_storage.VersionedClears()
    vc.add(kk(10), kk(40), 5, 0)
    vc.add(kk(30), kk(60), 7, 1)
    ref = ref_storage.VersionedClears()
    ref.add(kk(10), kk(40), 5, 0)
    ref.add(kk(30), kk(60), 7, 1)
    assert list(vc) == list(ref)
    oracle = FlatOracle()
    for v, s, b, e in vc:
        oracle.add(b, e, v, s)
    for i in range(0, 70):
        for at in (4, 5, 6, 7, 8):
            assert oracle.latest_over(kk(i), at) == vc.latest_over(kk(i), at)


def test_versioned_clears_trim_bounds_structure_to_live_window():
    vc = port_storage.VersionedClears()
    for v in range(1, 2001):
        a = (v * 37) % 900
        vc.add(kk(a), kk(a + 20), v, 0)
        if v % 50 == 0:
            vc.trim(v - 30)
    vc.trim(2000 - 30)
    assert len(vc) <= 60, len(vc)
    assert len(vc.bounds) <= 130, len(vc.bounds)


def test_versioned_clears_point_read_cost_scales_sublinearly():
    def build(n):
        vc = port_storage.VersionedClears()
        for v in range(1, n + 1):
            a = (v * 101) % (4 * n)
            vc.add(kk(a), kk(a + 3), v, 0)
        return vc

    def probe(vc, n, reps):
        t0 = time.perf_counter()
        acc = 0
        for i in range(reps):
            acc += vc.latest_over(kk((i * 17) % (4 * n)), n)[0]
        return time.perf_counter() - t0

    small, big = build(256), build(8192)
    probe(small, 256, 1000)  # warm
    t_small = min(probe(small, 256, 4000) for _ in range(3))
    t_big = min(probe(big, 8192, 4000) for _ in range(3))
    assert t_big < 8 * t_small, (t_small, t_big)


def test_versioned_store_clear_semantics_match_the_reference():
    stores = [port_storage.VersionedStore(), ref_storage.VersionedStore()]
    for st in stores:
        st.set(b"a", b"1", 10, 0)
        st.clear_range(b"a", b"b", 10, 1)  # clear AFTER set in the same commit
        assert st.get(b"a", 10) is None
        st.clear_range(b"c", b"d", 20, 0)
        st.set(b"c", b"2", 20, 1)  # set AFTER clear in the same commit
        assert st.get(b"c", 20) == b"2"
        assert st.get(b"c", 19) is None
        st.set(b"e", b"3", 5, 0)
        st.clear_range(b"e", b"f", 30, 0)
        assert st.get(b"e", 29) == b"3"
        assert st.get(b"e", 30) is None
        assert st.get_range(b"", b"z", 25, 10) == [(b"c", b"2"), (b"e", b"3")]
        assert st.get_range(b"", b"z", 25, 1, reverse=True) == [(b"e", b"3")]
        st.trim(10)
        assert st.get(b"e", 31) is None
        assert len(st.clears) == 2
        st.trim(20)
        assert len(st.clears) == 1
    port, ref = stores
    assert port.kv == ref.kv and port.sorted_keys == ref.sorted_keys
    assert list(port.clears) == list(ref.clears)


# ---------------------------------------------------------------------------
# The wire codec (tests/test_wire.py, less its two C-codec tests)
# ---------------------------------------------------------------------------


def roundtrip(v):
    out = decode_frame(encode_frame(v))
    assert out == v, (out, v)
    return out


def test_wire_primitives_roundtrip_and_match_the_reference():
    for v in (None, True, False, 0, 1, -1, 2**40, -(2**40), 2**100, 0.0, -1.5,
              float("inf"), b"", b"\x00\xff" * 100, "", "héllo ☃", [], [1, [2, [3, b"x"]]],
              (), (1, "two", b"three", None), {},
              {b"k": [1, 2], "s": {"nested": True}, 7: None}):
        roundtrip(v)
        assert encode_frame(v) == ref_wire.encode_frame_py(v)


def test_wire_nan_roundtrip():
    assert math.isnan(decode_frame(encode_frame(float("nan"))))
    assert encode_frame(float("nan")) == ref_wire.encode_frame_py(float("nan"))


def test_wire_structs_and_enums_roundtrip():
    ep = Endpoint(address="10.0.0.1:4500", token=(1 << 40) | 1234)
    ref = RequestStreamRef(endpoint=ep, name="commit")
    tr = CommitTransactionRef(
        read_snapshot=7, read_conflict_ranges=[(b"a", b"b")],
        write_conflict_ranges=[(b"a", b"a\x00")],
        mutations=[Mutation(type=MutationType.SET_VALUE, param1=b"a", param2=b"v")],
    )
    out = roundtrip(_Envelope(request=CommitTransactionRequest(transaction=tr), reply_to=ep))
    m = out.request.transaction.mutations[0]
    assert isinstance(m.type, MutationType) and m.type is MutationType.SET_VALUE
    roundtrip(ref)
    roundtrip(StorageInterface(storage_id="ss0", get_value=ref, get_version=ref))
    roundtrip(GetKeyValuesRequest(begin=b"a", end=b"z", version=12))
    roundtrip((False, GetStorageMetricsReply(bytes=10, split_key=None)))
    roundtrip((True, "broken_promise"))


def test_wire_unregistered_class_rejected_at_encode():
    @dataclasses.dataclass
    class NotOnTheWire:
        x: int = 1

    with pytest.raises(WireEncodeError):
        encode_frame(NotOnTheWire())
    with pytest.raises(WireEncodeError):
        encode_frame(object())


def test_wire_version_gate():
    frame = bytearray(encode_frame(42))
    frame[0] = WIRE_VERSION + 1
    with pytest.raises(WireDecodeError):
        decode_frame(bytes(frame))


def test_wire_schema_evolution_fewer_fields_fill_defaults():
    cid = wire._class_id("GetKeyValuesRequest")
    assert len(wire._structs_by_id[cid][1]) >= 3
    out = [bytes((wire.WIRE_VERSION, wire.T_STRUCT)), wire._U16.pack(cid)]
    wire._enc_varint(out, 2)
    wire._encode(out, b"a", 1)
    wire._encode(out, b"z", 1)
    got = decode_frame(b"".join(out))
    assert got.begin == b"a" and got.end == b"z"
    assert got.version == dataclasses.fields(GetKeyValuesRequest)[2].default


def test_wire_schema_evolution_more_fields_rejected():
    cid = wire._class_id("GetKeyValuesRequest")
    n = len(wire._structs_by_id[cid][1])
    out = [bytes((wire.WIRE_VERSION, wire.T_STRUCT)), wire._U16.pack(cid)]
    wire._enc_varint(out, n + 1)
    for _ in range(n + 1):
        wire._encode(out, None, 1)
    with pytest.raises(WireDecodeError):
        decode_frame(b"".join(out))


def test_wire_pickle_frames_rejected():
    import pickle

    with pytest.raises(WireDecodeError):
        decode_frame(pickle.dumps((123, "payload"), protocol=4))


def test_wire_decoder_fuzz_never_escapes_wiredecodeerror():
    """Mutation + truncation + random-soup fuzz: decode either succeeds or
    raises WireDecodeError, and the port's and the reference's decoders
    agree on every frame."""
    rng = np.random.default_rng(20260730)
    ep = Endpoint(address="h:1", token=99)
    seeds = [encode_frame(v) for v in (
        _Envelope(request=CommitTransactionRequest(transaction=CommitTransactionRef(
            mutations=[Mutation(MutationType.SET_VALUE, b"k" * 30, b"v" * 100)])), reply_to=ep),
        (7, [(b"k", b"v")] * 10),
        {b"a": 1, "b": [Endpoint("x:2", 3)]},
    )]
    for _ in range(4000):
        base = bytearray(seeds[int(rng.integers(len(seeds)))])
        mode = int(rng.integers(3))
        if mode == 0:
            for _ in range(int(rng.integers(1, 8))):
                base[int(rng.integers(len(base)))] = int(rng.integers(256))
            frame = bytes(base)
        elif mode == 1:
            cut = int(rng.integers(len(base) + 1))
            frame = bytes(base[:cut]) + bytes(
                rng.integers(0, 256, int(rng.integers(4)), dtype=np.uint8))
        else:
            frame = bytes(rng.integers(0, 256, int(rng.integers(1, 200)), dtype=np.uint8))
        try:
            got = ("ok", repr(decode_frame(frame)))
        except WireDecodeError as e:
            got = ("error", str(e))
        try:
            want = ("ok", repr(ref_wire.decode_frame_py(frame)))
        except ref_wire.WireDecodeError as e:
            want = ("error", str(e))
        assert got[0] == want[0], frame.hex()


def test_wire_huge_length_prefixes_bounded():
    for tag in (wire.T_LIST, wire.T_BYTES):
        out = [bytes((wire.WIRE_VERSION, tag))]
        wire._enc_varint(out, 1 << 60)
        with pytest.raises(WireDecodeError):
            decode_frame(b"".join(out))


def test_wire_depth_bounded():
    deep = None
    for _ in range(200):
        deep = [deep]
    with pytest.raises(WireEncodeError):
        encode_frame(deep)
    with pytest.raises(WireDecodeError):
        decode_frame(bytes((WIRE_VERSION,)) + bytes([7, 1]) * 200)


def test_wire_resolver_batch_roundtrip():
    roundtrip(ResolveTransactionBatchRequest(
        prev_version=10, version=20, proxy_id="proxy0",
        transactions=[TransactionConflictInfo(read_snapshot=5, read_ranges=[(b"a", b"b")],
                                              write_ranges=[(b"c", b"d")])]))


# ---------------------------------------------------------------------------
# Every ported struct and enum: the reference's bytes
# ---------------------------------------------------------------------------


def _sample(cls, seed):
    """An instance of dataclass `cls` with every field set from `seed`."""
    rng = random.Random(seed)
    kw = {}
    for f in dataclasses.fields(cls):
        choice = rng.randrange(4)
        kw[f.name] = [b"k%d" % rng.randrange(100), rng.randrange(-5, 1 << 40),
                      "s%d" % rng.randrange(9), None][choice]
    return cls(**kw)


def _port_wire_classes():
    wire.encode_frame(0)  # builds the registry
    return sorted(wire._struct_ids, key=lambda c: c.__name__), sorted(
        wire._enum_ids, key=lambda c: c.__name__)


def test_every_ported_struct_and_enum_encodes_to_the_reference_bytes():
    ref_wire.encode_frame_py(0)
    ref_structs = {c.__name__: c for c in ref_wire._struct_ids}
    ref_enums = {c.__name__: c for c in ref_wire._enum_ids}
    structs, enums = _port_wire_classes()
    assert {"CommitTransactionRequest", "TLogCommitRequest", "StorageInterface",
            "GetKeyValuesReply", "ResolveTransactionBatchReply"} <= {c.__name__ for c in structs}
    for cls in structs:
        rcls = ref_structs[cls.__name__]
        assert wire._struct_ids[cls] == ref_wire._struct_ids[rcls]
        assert [f.name for f in dataclasses.fields(cls)] == [f.name for f in dataclasses.fields(rcls)]
        for seed in range(3):
            p, r = _sample(cls, seed), _sample(rcls, seed)
            assert encode_frame(p) == ref_wire.encode_frame_py(r), cls.__name__
            assert decode_frame(ref_wire.encode_frame_py(r)) == p
    for cls in enums:
        rcls = ref_enums[cls.__name__]
        assert [(m.name, int(m)) for m in cls] == [(m.name, int(m)) for m in rcls]
        for m in cls:
            assert encode_frame([m, (m, b"x")]) == ref_wire.encode_frame_py([rcls(int(m)), (rcls(int(m)), b"x")])


def _to_ref(v):
    """The reference package's twin of a port value (by class name)."""
    if isinstance(v, IntEnum):
        return getattr(ref_types, type(v).__name__)(int(v))
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        for mod in (ref_if, ref_types):
            cls = getattr(mod, type(v).__name__, None)
            if cls is not None:
                return cls(**{f.name: _to_ref(getattr(v, f.name)) for f in dataclasses.fields(v)})
        from foundationdb_tpu.conflict import types as ref_ct
        from foundationdb_tpu.rpc import network as ref_net
        from foundationdb_tpu.rpc import stream as ref_stream

        for mod in (ref_ct, ref_net, ref_stream):
            cls = getattr(mod, type(v).__name__, None)
            if cls is not None:
                return cls(**{f.name: _to_ref(getattr(v, f.name)) for f in dataclasses.fields(v)})
        raise AssertionError(type(v))
    if isinstance(v, (list, tuple)):
        return type(v)(_to_ref(x) for x in v)
    if isinstance(v, dict):
        return {_to_ref(a): _to_ref(b) for a, b in v.items()}
    return v


def test_commit_path_messages_encode_to_the_reference_bytes():
    ep = Endpoint(address="proxy:1", token=7)
    msgs = [
        CommitTransactionRequest(transaction=CommitTransactionRef(
            read_snapshot=9, read_conflict_ranges=[(b"a", b"b")], write_conflict_ranges=[(b"c", b"d")],
            mutations=[Mutation(MutationType.ADD_VALUE, b"c", b"\x01"),
                       Mutation(MutationType.CLEAR_RANGE, b"c", b"d")]), flags=1, debug_id="d"),
        port_if.TLogCommitRequest(prev_version=3, version=4, tagged={
            "_default": [(0, Mutation(MutationType.SET_VALUE, b"k", b"v"))]}, known_committed=3),
        port_if.TLogPeekReply(entries=[(4, [Mutation(MutationType.SET_VALUE, b"k", b"v")])],
                              end_version=4, has_more=True),
        port_if.GetKeyValuesReply(data=[(b"a", b"1")], more=True, version=5),
        port_if.ProxyInterface(commit=RequestStreamRef(endpoint=ep, name="commit")),
        port_if.ResolveTransactionBatchReply(committed=[2, 0], witnesses=[None, (3, 0)],
                                             state_mutations=[(3, [(True, [Mutation(
                                                 MutationType.SET_VALUE, b"\xff/x", b"1")])])]),
        _Envelope(request=port_if.GetValueRequest(key=b"a", version=2), reply_to=ep),
    ]
    for m in msgs:
        assert encode_frame(m) == ref_wire.encode_frame_py(_to_ref(m)), type(m).__name__


# ---------------------------------------------------------------------------
# Atomic operations and versionstamps
# ---------------------------------------------------------------------------


def test_apply_atomic_every_type_matches_the_reference():
    rng = random.Random(41)
    atomic = sorted(port_types.ATOMIC_TYPES - {MutationType.SET_VERSIONSTAMPED_KEY,
                                               MutationType.SET_VERSIONSTAMPED_VALUE})
    assert {int(t) for t in port_types.ATOMIC_TYPES} == {int(t) for t in ref_types.ATOMIC_TYPES}
    values = [None, b"", b"\x00", b"\xff" * 3, b"\x01\x02", b"\x7f" * 9]
    values += [bytes(rng.randrange(256) for _ in range(rng.randrange(12))) for _ in range(20)]
    seen = 0
    for op in atomic:
        for ex in values:
            for operand in values[1:]:
                got = port_atomic.apply_atomic(op, ex, operand)
                want = ref_atomic.apply_atomic(ref_types.MutationType(int(op)), ex, operand)
                assert got == want, (op, ex, operand)
                seen += 1
    assert seen == len(atomic) * len(values) * (len(values) - 1)
    # APPEND_IF_FITS refuses past the value-size limit (the reference's
    # 100,000 by default; a smaller one through the argument).
    big = b"x" * 99_999
    assert port_atomic.apply_atomic(MutationType.APPEND_IF_FITS, big, b"yy") == big
    assert port_atomic.append_if_fits(b"ab", b"cd", value_size_limit=3) == b"ab"


def test_transform_versionstamp_matches_the_reference():
    rng = random.Random(43)
    for _ in range(200):
        prefix = bytes(rng.randrange(256) for _ in range(rng.randrange(6)))
        suffix = bytes(rng.randrange(256) for _ in range(rng.randrange(4)))
        data = prefix + b"\x00" * 10 + suffix + len(prefix).to_bytes(4, "little")
        version, txn = rng.randrange(1 << 50), rng.randrange(1 << 16)
        got = port_atomic.transform_versionstamp(data, version, txn)
        assert got == ref_atomic.transform_versionstamp(data, version, txn)
        assert got[len(prefix):len(prefix) + 10] == version.to_bytes(8, "big") + txn.to_bytes(2, "big")
    for bad in (b"", b"abc", b"\x00" * 4 + (3).to_bytes(4, "little")):
        with pytest.raises(Exception) as e:
            port_atomic.validate_versionstamp_param(bad)
        assert e.value.name == "client_invalid_operation"


# ---------------------------------------------------------------------------
# System keys and the simulation-validation marks
# ---------------------------------------------------------------------------


def test_system_keys_encode_to_the_reference_bytes():
    for name in ("SYSTEM_PREFIX", "KEY_SERVERS_PREFIX", "KEY_SERVERS_END", "SERVER_LIST_PREFIX",
                 "SERVER_LIST_END", "RESOLVER_SPLIT_KEY", "DB_LOCKED_KEY", "TIME_KEEPER_PREFIX",
                 "TIME_KEEPER_END", "TIME_KEEPER_DISABLE_KEY"):
        assert getattr(port_sk, name) == getattr(ref_sk, name), name
    assert port_sk.key_servers_key(b"m") == ref_sk.key_servers_key(b"m")
    assert port_sk.server_list_key("ss1") == ref_sk.server_list_key("ss1")
    assert port_sk.time_keeper_key(12345) == ref_sk.time_keeper_key(12345)
    assert port_sk.time_keeper_time(port_sk.time_keeper_key(12345)) == 12345
    ks = port_sk.encode_key_servers(["ss0"], ["ss1"], b"q")
    assert ks == ref_sk.encode_key_servers(["ss0"], ["ss1"], b"q")
    assert port_sk.decode_key_servers(ks) == (["ss0"], ["ss1"], b"q")
    split = port_sk.encode_resolver_split([b"\x40", b"\x80"])
    assert split == ref_sk.encode_resolver_split([b"\x40", b"\x80"])
    assert port_sk.decode_resolver_split(split) == [b"\x40", b"\x80"]
    assert port_sk.bounds_from_split_keys([b"\x80"]) == ref_sk.bounds_from_split_keys([b"\x80"])
    ep = Endpoint(address="storage:1", token=5)
    iface = StorageInterface(storage_id="ss1", get_value=RequestStreamRef(endpoint=ep, name="gv"))
    entry = port_sk.encode_server_entry(iface)
    assert entry == ref_sk.encode_server_entry(_to_ref(iface))
    assert port_sk.decode_server_entry(entry) == iface
    for m in (Mutation(MutationType.SET_VALUE, port_sk.key_servers_key(b"m"), ks),
              Mutation(MutationType.SET_VALUE, port_sk.server_list_key("ss1"), entry),
              Mutation(MutationType.SET_VALUE, port_sk.RESOLVER_SPLIT_KEY, split),
              Mutation(MutationType.SET_VALUE, port_sk.DB_LOCKED_KEY, b"uid"),
              Mutation(MutationType.CLEAR_RANGE, port_sk.KEY_SERVERS_PREFIX, port_sk.KEY_SERVERS_END),
              Mutation(MutationType.SET_VALUE, b"user", b"v")):
        got = port_sk.parse_metadata_mutation(m)
        want = ref_sk.parse_metadata_mutation(_to_ref(m))
        assert repr(got).replace("foundationdb_tpu_torch", "x") == repr(want).replace(
            "foundationdb_tpu", "x") or (got is None and want is None)


def test_sim_validation_marks_match_the_reference():
    port_loop, ref_loop = EventLoop(1), type("L", (), {})()
    for sv, loop in ((port_sv, port_loop), (ref_sv, ref_loop)):
        assert sv.marked(loop, "acked_commit") == -(1 << 62)
        sv.mark_at_least(loop, "acked_commit", 10)
        sv.mark_at_least(loop, "acked_commit", 7)  # monotone: stays 10
        assert sv.marked(loop, "acked_commit") == 10
        sv.expect_at_least(loop, "acked_commit", 10)
        sv.expect_at_least(loop, "unmarked", 0)
        with pytest.raises(AssertionError, match="promised 10 but observed 9"):
            sv.expect_at_least(loop, "acked_commit", 9, context="epoch cut")
    assert port_loop._sim_validation == ref_loop._sim_validation
