"""The port's ops/ against the reference package's, bit for bit.

Same inputs (made from a seed with numpy) through the JAX function and its
PyTorch counterpart on the CPU; every quantity is an integer, so the
tolerance is zero.  Key words go to the port in its device encoding
(sign bit flipped, conflict/keys.py) and to JAX as uint32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from foundationdb_tpu.ops import rangequery as jrq
from foundationdb_tpu.ops import stabbing as jst
from foundationdb_tpu_torch.conflict.keys import to_device_words
from foundationdb_tpu_torch.ops import rangequery as trq
from foundationdb_tpu_torch.ops import stabbing as tst

INF = 0xFFFFFFFF


def _tw(words_u32):
    return torch.from_numpy(to_device_words(words_u32).copy())


def _sorted_history(r, n, live, kw1, dup=False):
    """Word-major sorted keys: `live` rows (with duplicates if asked),
    INF-padded to n — the carried history's layout."""
    hk = np.full((kw1, n), INF, np.uint32)
    vals = np.sort(r.integers(0, 2**20, size=live)) if dup else np.sort(
        r.choice(2**20, size=live, replace=False))
    hk[0, :live] = vals >> 10
    hk[1, :live] = vals & 1023
    hk[2:, :live] = r.integers(0, 2**32, size=(kw1 - 2, 1), dtype=np.uint32)
    return hk


def _queries(r, m, kw1, hk):
    """Random queries plus exact copies of history rows and INF rows."""
    q = np.zeros((kw1, m), np.uint32)
    v = r.integers(0, 2**20, size=m)
    q[0], q[1] = v >> 10, v & 1023
    q[2:] = hk[2:, :1]
    n_copy = m // 4
    q[:, :n_copy] = hk[:, r.integers(0, hk.shape[1], size=n_copy)]
    q[:, -2:] = INF
    return q


def test_lex_less_and_leq():
    r = np.random.default_rng(1)
    a = r.integers(0, 4, size=(3, 500)).astype(np.uint32)
    b = r.integers(0, 4, size=(3, 500)).astype(np.uint32)
    a[:, :3] = [[0, INF, 2**31], [INF, 0, 2**31 - 1], [7, 7, 2**31]]
    b[:, :3] = [[INF, 0, 2**31 - 1], [0, INF, 2**31], [7, 7, 2**31]]
    for jf, tf in ((jrq.lex_less, trq.lex_less), (jrq.lex_leq, trq.lex_leq)):
        want = np.asarray(jf(jnp.asarray(a), jnp.asarray(b)))
        got = tf(_tw(a), _tw(b)).numpy()
        assert (got == want).all()


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize(
    "n,live,m,dup",
    [(1024, 700, 300, False), (1000, 1000, 257, True), (513, 1, 64, False),
     (4096, 3000, 1024, True), (7, 5, 33, True)],
)
def test_searchsorted_words(side, n, live, m, dup):
    r = np.random.default_rng(n + m)
    hk = _sorted_history(r, n, live, 3, dup=dup)
    q = _queries(r, m, 3, hk)
    want = np.asarray(jrq.searchsorted_words(jnp.asarray(hk), jnp.asarray(q), side))
    got = trq.searchsorted_words(_tw(hk), _tw(q), side)
    assert got.dtype == torch.int32
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("n", [1, 2, 100, 255, 256, 1000])
def test_searchsorted_1d(side, n):
    r = np.random.default_rng(n)
    keys = np.sort(r.integers(0, 50, size=n)).astype(np.int32)
    q = r.integers(-5, 60, size=200).astype(np.int32)
    q[:3] = [keys[0], keys[-1], 2**31 - 1]
    want = np.asarray(jrq.searchsorted_1d(jnp.asarray(keys), jnp.asarray(q), side))
    got = trq.searchsorted_1d(torch.from_numpy(keys), torch.from_numpy(q), side)
    assert (got.numpy() == want).all()


def test_floor_log2_exact():
    x = np.concatenate([
        np.arange(-3, 70), 2 ** np.arange(31) - 1, 2 ** np.arange(31),
        2 ** np.arange(30) + 1, [2**31 - 1],
    ]).astype(np.int64)
    x = np.clip(x, -(2**31), 2**31 - 1).astype(np.int32)
    want = np.asarray(jrq.floor_log2(jnp.asarray(x)))
    got = trq.floor_log2(torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("n", [1, 2, 3, 100, 1024, 1500])
def test_sparse_tables_and_range_queries(n):
    r = np.random.default_rng(n)
    vals = r.integers(-(2**30), 2**30, size=n).astype(np.int32)
    i = r.integers(0, n, size=400).astype(np.int32)
    j = np.maximum(i, r.integers(0, n, size=400)).astype(np.int32)
    for jb, tb, jq, tq in (
        (jrq.build_max_table, trq.build_max_table, jrq.range_max, trq.range_max),
        (jrq.build_min_table, trq.build_min_table, jrq.range_min, trq.range_min),
    ):
        jt = jb(jnp.asarray(vals))
        tt = tb(torch.from_numpy(vals))
        assert (tt.numpy() == np.asarray(jt)).all()
        want = np.asarray(jq(jt, jnp.asarray(i), jnp.asarray(j)))
        got = tq(tt, torch.from_numpy(i), torch.from_numpy(j))
        assert (got.numpy() == want).all()


def test_lex_argsort_matches_multikey_stable_sort():
    import jax

    r = np.random.default_rng(5)
    cols = [r.integers(0, 3, size=999).astype(np.int32) for _ in range(3)]
    iota = np.arange(999, dtype=np.int32)
    want = np.asarray(jax.lax.sort(
        tuple(jnp.asarray(c) for c in cols) + (jnp.asarray(iota),),
        num_keys=3, is_stable=True)[-1])
    got = trq.lex_argsort([torch.from_numpy(c) for c in cols])
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("n_log2,m", [(1, 5), (4, 40), (9, 300), (12, 2000)])
def test_stabbing_min(n_log2, m):
    n = 1 << n_log2
    r = np.random.default_rng(m)
    lo = r.integers(0, n + 1, size=m).astype(np.int32)
    hi = np.minimum(n, lo + r.integers(0, max(2, n // 4), size=m)).astype(np.int32)
    weight = r.integers(0, 10_000, size=m).astype(np.int32)
    valid = r.random(m) < 0.8
    want = np.asarray(jst.stabbing_min(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(weight),
        jnp.asarray(valid), n_log2))
    got = tst.stabbing_min(
        torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(weight),
        torch.from_numpy(valid), n_log2)
    assert (got.numpy() == want).all()


def test_host_and_device_max_tables_agree():
    """The tiered engine's carried base table is built on the host and
    queried by range_max in the device layout: the port's numpy twin equals
    its build_max_table and the reference's build_max_table_np bit for bit
    (tests/test_perf_smoke.py's parity test, for the port)."""
    r = np.random.default_rng(3)
    for n in (1, 2, 3, 7, 64, 1000, 4096):
        v = r.integers(-(2**30), 2**30, size=(n,)).astype(np.int32)
        host = trq.build_max_table_np(v)
        dev = trq.build_max_table(torch.from_numpy(v)).numpy()
        ref = np.asarray(jrq.build_max_table_np(v))
        assert host.dtype == np.int32 and host.shape == dev.shape == ref.shape, n
        assert (host == dev).all() and (host == ref).all(), n
