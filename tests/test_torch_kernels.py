"""The port's two kernel wrappers against the reference's Pallas kernels.

On the CPU a wrapper takes its kernel's plain PyTorch twin; these tests
hold that path bit for bit against the JAX kernels run in interpret mode
(as tests/test_kernels.py runs them) and against the reference's
searchsorted_words.  The compiled CUDA kernels are held against the same
plain twins on the card by tests/test_torch_cuda.py (skipped without a
GPU) and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from foundationdb_tpu.conflict import kernels as jk
from foundationdb_tpu.ops.rangequery import searchsorted_words as j_search
from foundationdb_tpu_torch.conflict import kernels as tk
from foundationdb_tpu_torch.conflict.keys import from_device_words, to_device_words

FLOOR = -(2**30)
INF = 0xFFFFFFFF


def _tw(words_u32):
    return torch.from_numpy(to_device_words(words_u32).copy())


def _history_and_queries(seed, N, live, R):
    r = np.random.default_rng(seed)
    hk = np.full((3, N), INF, np.uint32)
    vals = np.sort(r.choice(2**20, size=live, replace=False)).astype(np.uint32)
    hk[0, :live] = vals >> 10
    hk[1, :live] = vals & 1023
    hk[2, :live] = 7

    def enc(q):
        out = np.zeros((3, R), np.uint32)
        out[0], out[1], out[2] = q >> 10, q & 1023, 7
        return out

    rb = enc(r.choice(2**20, size=R).astype(np.uint32))
    re_ = enc(r.choice(2**20, size=R).astype(np.uint32))
    rb[:, : R // 4] = hk[:, r.integers(0, live, size=R // 4)]  # exact hits
    rb[:, -2:] = INF  # padding-row queries rank too
    re_[:, -1:] = INF
    return hk, rb, re_


SEARCH_CASES = [(1024, 700, 64), (512, 1, 16), (2048, 2048, 256), (4096, 3000, 512)]


@pytest.mark.parametrize("N,live,R", SEARCH_CASES)
def test_phase1_ranks_plain_vs_pallas_interpret(N, live, R):
    """Sorted queries in, ranks in sorted order out — the kernel contract,
    against the JAX phase1_ranks in interpret mode."""
    hk, rb, re_ = _history_and_queries(N + R, N, live, R)
    q = np.concatenate([re_, rb], axis=1)
    side = np.concatenate([np.zeros(R, np.int32), np.ones(R, np.int32)])
    order = np.lexsort((side, q[2], q[1], q[0]))
    q_s, side_s = np.ascontiguousarray(q[:, order]), side[order]
    want = np.asarray(jk.phase1_ranks(
        jnp.asarray(hk), jnp.asarray(q_s), jnp.asarray(side_s), interpret=True))
    got = tk.phase1_ranks(_tw(hk), _tw(q_s), torch.from_numpy(side_s))
    assert got.dtype == torch.int32
    assert (got.numpy() == want).all()
    # ... and against searchsorted_words per side over the full width.
    left = np.asarray(j_search(jnp.asarray(hk), jnp.asarray(q_s), "left"))
    right = np.asarray(j_search(jnp.asarray(hk), jnp.asarray(q_s), "right"))
    assert (got.numpy() == np.where(side_s != 0, right, left)).all()


@pytest.mark.parametrize("N,live,R", SEARCH_CASES)
def test_phase1_search_vs_pallas_interpret(N, live, R):
    hk, rb, re_ = _history_and_queries(N * 3 + R, N, live, R)
    wi0, wj1 = jk.phase1_search(jnp.asarray(hk), jnp.asarray(rb),
                                jnp.asarray(re_), interpret=True)
    i0, j1 = tk.phase1_search(_tw(hk), _tw(rb), _tw(re_))
    assert (i0.numpy() == np.asarray(wi0)).all()
    assert (j1.numpy() == np.asarray(wj1)).all()
    ((ti0, tj1),) = tk.phase1_search_tiers((_tw(hk),), _tw(rb), _tw(re_))
    assert (ti0 == i0).all() and (tj1 == j1).all()


def _merge_inputs(width, NA, NB, liveA, liveB, seed):
    r = np.random.default_rng(seed)
    keepA = np.zeros(NA, bool)
    keepA[r.choice(NA, size=liveA, replace=False)] = True
    keepB = np.zeros(NB, bool)
    keepB[r.choice(NB, size=liveB, replace=False)] = True
    mc = liveA + liveB
    assert mc <= width
    a_slots = np.sort(r.choice(mc, size=liveA, replace=False))
    b_slots = np.setdiff1d(np.arange(mc), a_slots)
    posA = np.full(NA, 123456789, np.int32)
    posA[np.where(keepA)[0]] = a_slots
    posB = np.full(NB, 987654321, np.int32)
    posB[np.where(keepB)[0]] = b_slots
    versA = r.integers(-100, 100, NA).astype(np.int32)
    versB = r.integers(-100, 100, NB).astype(np.int32)
    kA = r.integers(0, 2**32, (3, NA), dtype=np.uint32)
    kB = r.integers(0, 2**32, (3, NB), dtype=np.uint32)
    return (kA, versA, keepA, posA, kB, versB, keepB, posB, mc)


MERGE_CASES = [
    (512, 512, 64, 300, 40),
    (256, 256, 16, 100, 10),
    (1024, 1024, 128, 777, 100),
    (256, 256, 16, 0, 0),       # empty
    (256, 256, 16, 1, 16),      # singleton A, full B
    (2048, 2048, 256, 1792, 256),  # full width
]


@pytest.mark.parametrize("window", [0, 37, FLOOR], ids=["evict0", "evict37", "floor"])
@pytest.mark.parametrize("case", MERGE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_fused_merge_evict_plain_vs_pallas_interpret(case, window):
    width, NA, NB, la, lb = case
    kA, vA, keepA, pA, kB, vB, keepB, pB, mc = _merge_inputs(
        width, NA, NB, la, lb, seed=width + la)
    jok, jov, joc = jk.fused_merge_evict(
        jnp.asarray(kA), jnp.asarray(vA), jnp.asarray(keepA), jnp.asarray(pA),
        jnp.asarray(kB), jnp.asarray(vB), jnp.asarray(keepB), jnp.asarray(pB),
        jnp.asarray(mc, jnp.int32), jnp.asarray(window, jnp.int32),
        width=width, kw1=3, interpret=True,
    )
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    ok, ov, oc = tk.fused_merge_evict(
        _tw(kA), i32(vA), i32(keepA), i32(pA),
        _tw(kB), i32(vB), i32(keepB), i32(pB),
        torch.tensor(mc, dtype=torch.int32), torch.tensor(window, dtype=torch.int32),
        width=width,
    )
    n = int(joc)
    assert int(oc) == n
    # Rows at and past the count are undefined on both sides.
    assert (from_device_words(ok.numpy()[:, :n]) == np.asarray(jok)[:, :n]).all()
    assert (ov.numpy()[:n] == np.asarray(jov)[:n]).all()
    if window == FLOOR:
        assert n == mc


@pytest.mark.parametrize("case", [(512, 512, 64, 300, 0), (1024, 1024, 128, 777, 3),
                                  (2048, 2048, 256, 1792, 256)],
                         ids=lambda c: "x".join(map(str, c)))
def test_fused_merge_evict_all_dropped_plain_vs_pallas_interpret(case):
    """The first batch after a recovery's epoch jump: removeBefore passes
    every history row, so the merge keeps the first row and, of the rest,
    only the batch's new rows and the row after each."""
    width, NA, NB, la, lb = case
    kA, vA, keepA, pA, kB, vB, keepB, pB, mc = _merge_inputs(
        width, NA, NB, la, lb, seed=width + lb)
    window = 1 << 20  # above every version of A
    vB = np.full(NB, window + 5, np.int32)  # the batch's rows are newer
    jok, jov, joc = jk.fused_merge_evict(
        jnp.asarray(kA), jnp.asarray(vA), jnp.asarray(keepA), jnp.asarray(pA),
        jnp.asarray(kB), jnp.asarray(vB), jnp.asarray(keepB), jnp.asarray(pB),
        jnp.asarray(mc, jnp.int32), jnp.asarray(window, jnp.int32),
        width=width, kw1=3, interpret=True,
    )
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    ok, ov, oc = tk.fused_merge_evict(
        _tw(kA), i32(vA), i32(keepA), i32(pA),
        _tw(kB), i32(vB), i32(keepB), i32(pB),
        torch.tensor(mc, dtype=torch.int32), torch.tensor(window, dtype=torch.int32),
        width=width,
    )
    n = int(joc)
    assert int(oc) == n and 1 <= n <= 1 + 2 * lb
    assert (from_device_words(ok.numpy()[:, :n]) == np.asarray(jok)[:, :n]).all()
    assert (ov.numpy()[:n] == np.asarray(jov)[:n]).all()


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    hk, rb, re_ = _history_and_queries(3, 256, 100, 16)
    before = dict(tk.LAUNCHES)
    i0, j1 = tk.phase1_search(_tw(hk), _tw(rb), _tw(re_))
    kA, vA, keepA, pA, kB, vB, keepB, pB, mc = _merge_inputs(256, 256, 16, 50, 8, 1)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    tk.fused_merge_evict(
        _tw(kA), i32(vA), i32(keepA), i32(pA), _tw(kB), i32(vB), i32(keepB),
        i32(pB), torch.tensor(mc, dtype=torch.int32),
        torch.tensor(0, dtype=torch.int32), width=256)
    assert tk.LAUNCHES == before


def test_wrappers_check_their_arguments():
    hk, rb, re_ = _history_and_queries(4, 256, 100, 16)
    side = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(TypeError):
        tk.phase1_ranks(_tw(hk).to(torch.int64), _tw(rb), side)
    with pytest.raises(ValueError):
        tk.phase1_ranks(_tw(hk), _tw(rb)[:2].contiguous(), side)
    with pytest.raises(ValueError):
        tk.phase1_ranks(_tw(hk), _tw(rb).t().contiguous().t(), side)
    with pytest.raises(ValueError):
        tk.phase1_ranks(_tw(hk).to("meta"), _tw(rb).to("meta"), side.to("meta"))


# ---------------------------------------------------------------------------
# the tiered history's forms: two tiers, and the major compaction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("NB,live_b,ND,live_d,R", [
    (1024, 700, 256, 90, 64),
    (2048, 2048, 512, 1, 128),   # a full base, a delta of its floor row only
    (512, 300, 512, 512, 32),    # tiers of one width, a full delta
], ids=lambda v: str(v))
def test_phase1_search_tiers_two_tiers_vs_pallas_interpret(NB, live_b, ND, live_d, R):
    """The tiered step's phase 1: one query sort for a base and a delta of
    different widths, against the reference's phase1_search_tiers in
    interpret mode, tier by tier."""
    base, rb, re_ = _history_and_queries(NB + R, NB, live_b, R)
    delta, _rb, _re = _history_and_queries(ND + 7, ND, live_d, R)
    want = jk.phase1_search_tiers(
        (jnp.asarray(base), jnp.asarray(delta)), jnp.asarray(rb), jnp.asarray(re_),
        interpret=True)
    got = tk.phase1_search_tiers((_tw(base), _tw(delta)), _tw(rb), _tw(re_))
    assert len(got) == len(want) == 2
    for (i0, j1), (wi0, wj1) in zip(got, want):
        assert (i0.numpy() == np.asarray(wi0)).all()
        assert (j1.numpy() == np.asarray(wj1)).all()


def _major_compaction_inputs(monkeypatch):
    """fused_merge_evict's arguments at every major compaction of a seeded
    tiered stream (A = the base at width H, B = the delta, D < H rows,
    sparse keep flags), recorded from the port's engine."""
    from foundationdb_tpu_torch.conflict import engine_torch as et
    from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as T

    seen = []
    merge, compact = et.fused_merge_evict, et._major_compact
    in_compaction = []

    def recording(*args, width):
        if in_compaction:
            seen.append((tuple(a.clone() for a in args), width))
        return merge(*args, width=width)

    def compacting(*args, **kwargs):
        in_compaction.append(1)
        try:
            return compact(*args, **kwargs)
        finally:
            in_compaction.pop()

    monkeypatch.setattr(et, "fused_merge_evict", recording)
    monkeypatch.setattr(et, "_major_compact", compacting)
    r = np.random.default_rng(12)
    cs = et.TorchConflictSet(key_words=2, h_cap=1024, device="cpu", history="tiered",
                             delta_cap=256, evict_every=3, bucket_mins=(8, 8, 16))
    for i in range(12):
        txns = []
        for _ in range(12):
            a, b = sorted(int(x) for x in r.integers(0, 4000, 2))
            c = int(r.integers(0, 4000))
            txns.append(T(i, [(b"%06d" % a, b"%06d" % (b + 1))],
                          [(b"%06d" % c, b"%06d" % (c + 1 + int(r.integers(0, 30))))]))
        cs.detect(txns, i + 6, max(0, i - 3))
    return seen


def test_fused_merge_evict_major_compaction_vs_pallas_interpret(monkeypatch):
    """The major compaction's merge, on the inputs the tiered engine really
    hands it: the port's plain twin against the reference's Pallas kernel
    in interpret mode, bit for bit over the surviving rows, and the
    position order the CUDA kernel relies on holds."""
    seen = _major_compaction_inputs(monkeypatch)
    assert len(seen) >= 3
    sparse = 0
    for args, width in seen:
        a_keys, a_vers, a_keep, a_pos, b_keys, b_vers, b_keep, b_pos, mc, window = args
        assert a_keys.shape[1] == width > b_keys.shape[1]
        kept = np.flatnonzero(b_keep.numpy())
        sparse += int(len(kept) and kept[-1] + 1 != len(kept))
        pa, pb = a_pos[a_keep != 0].numpy(), b_pos[b_keep != 0].numpy()
        assert (np.diff(pa) > 0).all() and (np.diff(pb) > 0).all()
        assert np.array_equal(np.sort(np.concatenate([pa, pb])), np.arange(int(mc)))
        jok, jov, joc = jk.fused_merge_evict(
            *(jnp.asarray(from_device_words(t.numpy())) if i in (0, 4)
              else jnp.asarray(t.numpy()) for i, t in enumerate(args)),
            width=width, kw1=a_keys.shape[0], interpret=True,
        )
        ok, ov, oc = tk.fused_merge_evict(*args, width=width)
        n = int(joc)
        assert int(oc) == n
        assert (from_device_words(ok.numpy()[:, :n]) == np.asarray(jok)[:, :n]).all()
        assert (ov.numpy()[:n] == np.asarray(jov)[:n]).all()
    assert sparse, "no compaction had a delta with gaps in its kept rows"
