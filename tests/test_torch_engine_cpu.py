"""The port's chunked CPU mirror against the reference package's.

``foundationdb_tpu_torch.conflict.engine_cpu.CpuConflictSet`` and the
reference's ``CpuConflictSet`` take the same seeded streams: verdicts,
witnesses, the flat keys / vers / oldest_version views,
``snapshot().to_flat()``, ``boundary_count`` and the chunk structure must be
equal after every batch — with tiny chunks (many chunk splits and
rebuilds), with keys too long for the encoding (the per-boundary sweeps),
and with the coalesced apply (``coalesce_window=4``).  Exact equality.
"""

import numpy as np
import pytest

from foundationdb_tpu.conflict import engine_cpu as ref_cpu
from foundationdb_tpu.conflict.types import TransactionConflictInfo as JT
from foundationdb_tpu_torch.conflict import engine_cpu
from foundationdb_tpu_torch.conflict.engine_cpu_flat import FlatCpuConflictSet
from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as TT


def _stream(seed, batches, txns, keyspace, long_every=0):
    r = np.random.default_rng(seed)

    def key(i):
        if long_every and i % long_every == 0:
            return b"%030d" % i  # past 4 * key_words bytes
        return b"%08d" % i

    version = 10
    out = []
    for _ in range(batches):
        batch = []
        for _ in range(int(r.integers(1, txns + 1))):
            tr = JT(read_snapshot=max(0, version - int(r.integers(0, 30))))
            for _ in range(int(r.integers(0, 4))):
                a = int(r.integers(0, keyspace))
                tr.read_ranges.append((key(a), key(a + 1 + int(r.integers(0, keyspace // 8)))))
            for _ in range(int(r.integers(0, 3))):
                a = int(r.integers(0, keyspace))
                tr.write_ranges.append((key(a), key(a + 1 + int(r.integers(0, keyspace // 10)))))
            batch.append(tr)
        version += int(r.integers(1, 10))
        out.append((batch, version, max(0, version - 40)))
    return out


def _port(txns):
    return [TT(t.read_snapshot, list(t.read_ranges), list(t.write_ranges)) for t in txns]


def _assert_same_state(got, want):
    assert got.keys == want.keys
    assert got.vers == want.vers
    assert got.oldest_version == want.oldest_version
    assert got.boundary_count == want.boundary_count
    assert got.chunk_count == want.chunk_count
    assert got.snapshot().to_flat() == want.snapshot().to_flat()
    assert [len(c) for c in got.snapshot().chunks] == [len(c) for c in want.snapshot().chunks]
    assert (got.chunks_rebuilt, got.evict_scans, got.evict_skips) == (
        want.chunks_rebuilt, want.evict_scans, want.evict_skips)


@pytest.mark.parametrize("chunk,kw,long_every", [
    (4, 3, 0),    # many chunks, columnar sweeps
    (256, 4, 0),  # the default chunk size
    (4, 3, 7),    # long keys: the per-boundary sweeps
])
def test_detect_stream_matches_the_reference(chunk, kw, long_every):
    stream = _stream(3 + chunk + long_every, 14, 30, 300, long_every)
    got = engine_cpu.CpuConflictSet(chunk=chunk, key_words=kw)
    want = ref_cpu.CpuConflictSet(chunk=chunk, key_words=kw)
    flat = FlatCpuConflictSet()
    for txns, now, nov in stream:
        verdicts = got.detect(_port(txns), now, nov)
        assert verdicts == want.detect(txns, now, nov)
        assert verdicts == flat.detect(_port(txns), now, nov)
        assert got.last_witness == want.last_witness == flat.last_witness
        _assert_same_state(got, want)
        assert got.keys == flat.keys and got.vers == flat.vers
    assert got._any_long == bool(long_every)


@pytest.mark.parametrize("window", [1, 4])
def test_apply_batch_and_coalescing_match_the_reference(window):
    """apply_batch with verdicts decided elsewhere, folded per batch or
    queued four at a time; reads in between settle the queue."""
    stream = _stream(11, 16, 30, 300)
    got = engine_cpu.CpuConflictSet(chunk=8, key_words=3, coalesce_window=window)
    want = ref_cpu.CpuConflictSet(chunk=8, key_words=3)
    want.coalesce_window = window
    oracle = FlatCpuConflictSet()
    for i, (txns, now, nov) in enumerate(stream):
        verdicts = oracle.detect(_port(txns), now, nov)
        got.apply_batch(_port(txns), verdicts, now, nov)
        want.apply_batch(txns, verdicts, now, nov)
        assert got.pending_batches == want.pending_batches
        assert got.oldest_version == want.oldest_version  # passive
        if i % 5 == 4:
            _assert_same_state(got, want)
            assert got.keys == oracle.keys and got.vers == oracle.vers
    _assert_same_state(got, want)
    assert got.pending_batches == 0


def test_snapshots_fresh_chunks_and_encodings_match_the_reference():
    stream = _stream(5, 10, 30, 300)
    got = engine_cpu.CpuConflictSet(chunk=4, key_words=3)
    want = ref_cpu.CpuConflictSet(chunk=4, key_words=3)
    for txns, now, nov in stream:
        before = got.snapshot()
        flat_before = before.to_flat()
        got.detect(_port(txns), now, nov)
        want.detect(txns, now, nov)
        assert before.to_flat() == flat_before  # snapshots never change
        g_fresh, g_complete = got.take_fresh_chunks()
        w_fresh, w_complete = want.take_fresh_chunks()
        assert g_complete == w_complete
        assert [len(c) for c in g_fresh] == [len(c) for c in w_fresh]
        s_got, s_want = got.snapshot(), want.snapshot()
        assert (s_got.stamp, s_got.boundary_count, s_got.oldest_version) == (
            s_want.stamp, s_want.boundary_count, s_want.oldest_version)
        for cg, cw in zip(s_got.chunks, s_want.chunks):
            for kw in (3, 4):  # the mirror's own width, and another
                (eg, vg), ng = engine_cpu.chunk_encoding(cg, kw)
                (ew, vw), nw = ref_cpu.chunk_encoding(cw, kw)
                assert ng == nw and np.array_equal(eg, ew) and np.array_equal(vg, vw)
                assert engine_cpu.chunk_encoding(cg, kw)[1] == 0  # cached
    got.clear(500)
    want.clear(500)
    _assert_same_state(got, want)
