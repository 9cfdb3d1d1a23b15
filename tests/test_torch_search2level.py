"""The port's 2level search against the reference's FDB_TPU_SEARCH=2level.

- the search: the port's ``_searchsorted_words_2level`` against the
  reference's, called eagerly with the reference module's SAMPLE_STRIDE
  monkeypatched (the module reads its mode at import and jit-caches its
  steps, so it is never reloaded), and both against the flat search, at
  strides 8 to 1,024: both sides, duplicate keys and ties, queries before
  the first and after the last key, INF padding;
- ``searchsorted_words(mode=, stride=)``: the 2level branch only at widths
  of at least _2LEVEL_MIN, unknown modes and strides rejected;
- the engine: ``search="2level"`` at ``h_cap = 1 << 16`` exactly (so the
  branch is really taken, as tests/test_engine_experiments.py notes)
  against the reference's default engine, whose 2level search that test
  holds decision-identical to its flat one: TorchConflictSet flat and
  tiered, ConflictSet, and ShardedTorchConflictSet.  The kernels' plain
  twins keep the flat search: the flat step runs the 2level form twice a
  batch (the merge prep), the ``nokernel`` arm four times.

All integers; the tolerance is zero.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from foundationdb_tpu.conflict.api import ConflictSet as RefConflictSet
from foundationdb_tpu.conflict.engine_jax import JaxConflictSet
from foundationdb_tpu.flow import set_event_loop
from foundationdb_tpu.ops import rangequery as jrq
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.engine_torch import TorchConflictSet
from foundationdb_tpu_torch.ops import rangequery as trq

from test_torch_ops import INF, _queries, _sorted_history, _tw
from test_torch_sharded import (
    BUCKETS,
    TIERED,
    TIERED_ENV,
    make_port,
    make_ref,
    port_txns,
    random_stream,
)
from test_torch_witness_free import _engine_counters, _export

STRIDES = [8, 64, 512, 1024]
H2 = 1 << 16  # trq._2LEVEL_MIN: the smallest width the 2level form takes


@pytest.fixture(autouse=True)
def _clean_loop():
    yield
    set_event_loop(None)


def _search_inputs(seed, n, live, m, dup):
    r = np.random.default_rng(seed)
    hk = _sorted_history(r, n, live, 3, dup=dup)
    q = _queries(r, m, 3, hk)
    q[:, :2] = 0  # before (or at) the first key
    q[:, 2] = hk[:, live - 1]  # the last live key
    return hk, q


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("n,live,m,dup", [(5000, 4000, 600, False), (4096, 4096, 300, True),
                                          (3000, 1, 40, False)])
def test_two_level_matches_the_reference(monkeypatch, stride, side, n, live, m, dup):
    hk, q = _search_inputs(n + m + stride, n, live, m, dup)
    monkeypatch.setattr(jrq, "SAMPLE_STRIDE", stride)
    want = np.asarray(jrq._searchsorted_words_2level(jnp.asarray(hk), jnp.asarray(q), side))
    flat = np.asarray(jrq._searchsorted_words_flat(jnp.asarray(hk), jnp.asarray(q), side))
    got = trq._searchsorted_words_2level(_tw(hk), _tw(q), side, stride)
    assert got.dtype == torch.int32
    assert (got.numpy() == want).all()
    assert (want == flat).all()


@pytest.mark.parametrize("stride", [1, 8, 512, 1024])
@pytest.mark.parametrize("side", ["left", "right"])
def test_two_level_branch_at_full_width_equals_the_flat_search(monkeypatch, stride, side):
    """searchsorted_words(mode="2level") at _2LEVEL_MIN rows takes the
    coarse-then-fine branch and equals the flat search bit for bit; one
    row narrower it is the flat search itself."""
    hk, q = _search_inputs(stride, H2, H2 - 100, 2000, dup=False)
    calls = []
    real = trq._searchsorted_words_2level
    monkeypatch.setattr(trq, "_searchsorted_words_2level",
                        lambda *a: calls.append(a[3]) or real(*a))
    flat = trq.searchsorted_words(_tw(hk), _tw(q), side)
    got = trq.searchsorted_words(_tw(hk), _tw(q), side, mode="2level", stride=stride)
    assert calls == [stride]
    assert torch.equal(got, flat)
    narrow = hk[:, : H2 - 1].copy()
    trq.searchsorted_words(_tw(narrow), _tw(q), side, mode="2level", stride=stride)
    assert calls == [stride]


@pytest.mark.parametrize("mode,stride", [("3level", 512), ("2LEVEL", 512), ("2level", 0),
                                         ("", -1)])
def test_unknown_search_settings_raise(mode, stride):
    q = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        trq.searchsorted_words(q, q, "left", mode=mode, stride=stride)
    with pytest.raises(ValueError):
        TorchConflictSet(key_words=2, device="cpu", search=mode, search_stride=stride)
    with pytest.raises(ValueError):
        ConflictSet(key_words=2, device="cpu", search=mode, search_stride=stride)


# ---------------------------------------------------------------------------
# the engine at h_cap = 1 << 16
# ---------------------------------------------------------------------------


def _count_two_level(monkeypatch):
    calls = []
    real = trq._searchsorted_words_2level
    monkeypatch.setattr(trq, "_searchsorted_words_2level",
                        lambda *a: calls.append(a[3]) or real(*a))
    return calls


@pytest.mark.parametrize("stride", [64, 1024])
@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
def test_engine_matches_the_reference(monkeypatch, tiered, stride):
    """TorchConflictSet(search="2level") at h_cap 1 << 16 against the
    reference's JaxConflictSet (flat search) at the same capacity: verdicts,
    witnesses, iterations, the exported history and the counters after
    every batch.  Tiered, the compactions search the 1 << 16-row base."""
    if tiered:
        for name, value in TIERED_ENV.items():
            monkeypatch.setenv(name, value)
    calls = _count_two_level(monkeypatch)
    kw = dict(key_words=3, h_cap=H2, bucket_mins=BUCKETS)
    jcs = JaxConflictSet(**kw)
    tcs = TorchConflictSet(device="cpu", search="2level", search_stride=stride,
                           **(TIERED if tiered else {}), **kw)
    stream = random_stream(31, 9)
    for i, (txns, now, nov) in enumerate(stream):
        assert tcs.detect(port_txns(txns), now, nov) == jcs.detect(txns, now, nov), i
        assert tcs.last_witness == jcs.last_witness, i
        assert tcs.last_iters == jcs.last_iters, i
        assert _export(tcs, True) == _export(jcs, False), i
    assert _engine_counters(tcs) == _engine_counters(jcs)
    assert tcs.h_cap == jcs.h_cap == H2
    if tiered:
        # Only the compactions search the base (the delta is narrower).
        assert _engine_counters(tcs)["major_compactions"] >= 2
        assert len(calls) == 2 * _engine_counters(tcs)["major_compactions"]
    else:
        keys, vers, n, oldest, base = tcs.export_state()
        assert (keys == np.asarray(jcs._hkeys)).all() and (vers == np.asarray(jcs._hvers)).all()
        assert (n, oldest, base) == (int(jcs._hcount), int(jcs._oldest), jcs._base)
        assert len(calls) == 2 * len(stream)  # the merge prep's two searches
    assert set(calls) == {stride}


def test_plain_step_takes_the_two_level_phase_1(monkeypatch):
    """The nokernel arm's phase 1 (two plain searches) runs in the search
    mode too, and stays bit-identical to the kernel arm's; the kernels'
    plain twins never do."""
    calls = _count_two_level(monkeypatch)
    stream = random_stream(33, 5)
    kw = dict(key_words=3, h_cap=H2, bucket_mins=BUCKETS, device="cpu", search="2level")
    plain = TorchConflictSet(ablate={"nokernel"}, **kw)
    kern = TorchConflictSet(**kw)
    for txns, now, nov in stream:
        assert plain.detect(port_txns(txns), now, nov) == kern.detect(port_txns(txns), now, nov)
        assert plain.last_witness == kern.last_witness
    for a, b in zip(plain.export_state(), kern.export_state()):
        assert np.array_equal(a, b)
    assert len(calls) == (4 + 2) * len(stream)


def test_conflict_set_matches_the_reference(monkeypatch):
    """ConflictSet(search="2level", search_stride=256) at depth 2 against
    the reference's ConflictSet(backend="jax") at the same h_cap."""
    monkeypatch.setenv("FDB_TPU_PIPELINE_DEPTH", "2")
    calls = _count_two_level(monkeypatch)
    kw = dict(key_words=3, h_cap=H2, bucket_mins=BUCKETS)
    ref = RefConflictSet(backend="jax", **kw)
    cs = ConflictSet(device="cpu", pipeline_depth=2, search="2level", search_stride=256, **kw)
    want, got = [], []
    for txns, now, nov in random_stream(35, 8):
        want.append(ref.pipeline_submit(txns, now, nov))
        got.append(cs.pipeline_submit(port_txns(txns), now, nov))
        for s in (ref, cs):
            while s.pipeline_inflight > 1:
                s.pipeline_complete_oldest()
    ref.pipeline_drain()
    cs.pipeline_drain()
    assert [(list(e.statuses), e.witness) for e in got] == [
        (list(e.statuses), e.witness) for e in want]
    assert _export(cs._dev, True) == _export(ref._jax, False)
    assert cs.mirror_check()["status"] == "ok"
    assert len(calls) == 2 * len(want)


@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
def test_sharded_matches_the_reference(monkeypatch, tiered):
    """ShardedTorchConflictSet(search="2level") with 2 shards of 1 << 16
    rows against the reference's ShardedJaxConflictSet: verdicts,
    witnesses, iterations, counters and the global export."""
    import foundationdb_tpu.parallel.sharded_resolver as jsr

    if tiered:
        for name, value in TIERED_ENV.items():
            monkeypatch.setenv(name, value)
        monkeypatch.setattr(jsr, "_SHARD_MAP_KW", {"check_vma": False})
    calls = _count_two_level(monkeypatch)
    ref = make_ref(2, tiered, h_cap=H2)
    cs = make_port(2, tiered, h_cap=H2, search="2level", search_stride=128)
    stream = random_stream(37, 8)
    for i, (txns, now, nov) in enumerate(stream):
        assert cs.detect(port_txns(txns), now, nov) == ref.detect(txns, now, nov), i
        assert cs.last_witness == ref.last_witness, i
        assert cs.last_iters == ref.last_iters, i
    assert cs.metrics.snapshot()["counters"] == ref.metrics.snapshot()["counters"]
    assert _export(cs, True) == _export(ref, False)
    assert calls and set(calls) == {128}
