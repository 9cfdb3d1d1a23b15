"""The port's CUDA kernels and engine on the card (``cuda`` marker).

Each test needs an NVIDIA GPU and nvcc and skips without one.  This file
imports neither jax nor the reference package, so it also runs where only
PyTorch is installed; the repository's conftest imports jax, so there run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are chosen to hit the kernels' edges: widths that are not a
multiple of the merge tile, empty streams, one to eight key words, INF
queries, long runs of dropped rows.
"""

import json

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.conflict import engine_torch as et
from foundationdb_tpu_torch.conflict import kernels as tk
from foundationdb_tpu_torch.conflict.keys import to_device_words
from foundationdb_tpu_torch.conflict.state import state_from_jax
from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as TT

pytestmark = pytest.mark.cuda

INF = 0xFFFFFFFF


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _words(a, dev):
    return torch.from_numpy(to_device_words(a).copy()).to(dev)


def _p(kw1, N, live, M, mode="random"):
    name = f"{kw1}-{N}-{live}-{M}" + ("" if mode == "random" else f"-{mode}")
    return pytest.param(kw1, N, live, M, mode, id=name)


# The kernel cuts the merged sequence of rows and queries into diagonals of
# 6,656 items, streams a later word where a block's rows share a prefix, and
# settles ties on the spot only in blocks of at most 512 queries; these
# shapes put the partition, the streamed word and both tie paths at their
# edges.
@pytest.mark.parametrize("kw1,N,live,M,mode", [
    _p(3, 1000, 700, 300), _p(5, 4096, 4096, 1024), _p(1, 7, 3, 9), _p(3, 100_000, 90_000, 4099),
    _p(3, 1, 1, 50),                   # N = 1
    _p(3, 100_000, 99_000, 1),         # M = 1
    _p(3, 500, 400, 40_000),           # N << M: diagonals of queries only
    _p(1, 30_001, 30_001, 7_777),      # N + M not a multiple of the diagonal
    _p(3, 20_000, 15_000, 20_000, "equal"),  # every query one history key
    _p(2, 20_000, 15_000, 9000, "inf"),      # every query INF
    _p(3, 20_000, 15_000, 3000, "below"),    # every query below row 0
    _p(5, 20_000, 20_000, 1000, "tie"),      # word 0 constant: every compare ties
    _p(8, 20_000, 20_000, 3000, "tie"),      # ... in blocks of over 512 queries
    _p(3, 50_001, 40_000, 20_000, "hot"),    # 90% of queries on 10 keys
    _p(4, 40_000, 40_000, 6000, "prefix"),   # long runs of a two-word prefix
    _p(3, 30_001, 25_000, 5000, "unaligned"),  # history not 16-byte aligned
])
def test_phase1_ranks_kernel_matches_plain(dev, kw1, N, live, M, mode):
    r = np.random.default_rng(N + M)
    h = np.full((kw1, N), INF, np.uint32)
    rows = r.integers(0, 64, size=(live, kw1)).astype(np.uint32)
    if mode == "tie":
        rows[:, 0] = 7
    if mode == "below":
        rows[:, 0] += 1
    if mode == "prefix":
        rows[:, 0] = r.integers(0, 3, size=live)
        rows[:, 1] = 5
    rows = rows[np.lexsort(rows.T[::-1])]
    h[:, :live] = rows.T
    q = r.integers(0, 64, size=(kw1, M)).astype(np.uint32)
    if mode in ("random", "unaligned"):
        q[:, : M // 3] = h[:, r.integers(0, N, size=M // 3)]  # hits, INF rows too
    elif mode == "equal":
        q[:] = h[:, [live // 2]]
    elif mode == "inf":
        q[:] = INF
    elif mode == "below":
        q[0] = 0
    elif mode == "tie":
        q[0] = 7
    elif mode == "prefix":
        q[0] = r.integers(0, 3, size=M)
        q[1, r.random(M) < 0.9] = 5
    elif mode == "hot":
        hot = h[:, r.integers(0, live, size=10)]
        pick = r.random(M) < 0.9
        q[:, pick] = hot[:, r.integers(0, 10, size=int(pick.sum()))]
    side = r.integers(0, 2, size=M).astype(np.int32)
    order = np.lexsort((side,) + tuple(q[w] for w in range(kw1 - 1, -1, -1)))
    hq = _words(h, dev)
    if mode == "unaligned":  # a contiguous view 4 bytes past a 16-byte boundary
        buf = torch.empty(kw1 * N + 1, dtype=torch.int32, device=dev)
        buf[1:] = hq.flatten()
        hq = buf[1:].view(kw1, N)
    qq = _words(np.ascontiguousarray(q[:, order]), dev)
    ss = torch.from_numpy(side[order].copy()).to(dev)
    before = tk.LAUNCHES["phase1_ranks"]
    got = tk.phase1_ranks(hq, qq, ss)
    assert tk.LAUNCHES["phase1_ranks"] == before + 1
    want = tk.phase1_ranks_reference(hq, qq, ss)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _m(kw1, width, NA, NB, liveA, liveB, window, mode="random"):
    name = "-".join(str(x) for x in (kw1, width, NA, NB, liveA, liveB, window))
    name += "" if mode == "random" else f"-{mode}"
    return pytest.param(kw1, width, NA, NB, liveA, liveB, window, mode, id=name)


# The kernel gathers each tile of 2,048 merged rows from A's kept rows
# (found through a prefix count per 256 rows) and B's, and chains the
# tiles' output offsets by a decoupled look-back; these shapes put the
# tile, chunk and stream edges where they break.  "gap" breaks the order
# the kernel relies on: one kept A row loses its keep flag but
# merged_count still counts it, so one merged slot has no row.
@pytest.mark.parametrize("kw1,width,NA,NB,liveA,liveB,window,mode", [
    _m(3, 1000, 1000, 64, 600, 40, 0),
    _m(3, 257, 257, 16, 0, 0, 0),            # empty, ragged tile
    _m(5, 5000, 4000, 512, 3500, 500, -(2**30)),  # floor window keeps all
    _m(3, 300_000, 300_000, 8192, 250_000, 8000, 10),
    _m(1, 20_000, 20_000, 1000, 18_000, 900, 10),    # one key word
    _m(8, 20_000, 20_000, 1000, 18_000, 900, 10),    # kMaxWords
    _m(3, 20_000, 20_000, 0, 19_000, 0, 10),         # NB = 0
    _m(3, 1000, 1, 64, 1, 40, 10),                   # NA = 1
    _m(3, 50_000, 10_000, 1000, 9000, 900, 10),      # width > NA + NB
    _m(3, 10_000, 10_000, 2000, 9900, 1500, 10),     # merged_count > width
    _m(3, 20_000, 20_000, 1000, 18_000, 900, 50),    # window above every version
    _m(3, 30_000, 30_000, 8000, 25_000, 7000, 10, "b_first"),  # every B row first
    _m(3, 30_000, 30_000, 8000, 25_000, 7000, 10, "b_last"),   # every B row last
    _m(3, 60_000, 60_000, 2000, 55_000, 1800, 10, "run"),  # 10,000 dropped A rows in a row
    _m(3, 3_145_728, 3_145_728, 131_072, 3_000_000, 120_000, 10),  # 1,536 tiles
    _m(3, 40_000, 40_000, 8000, 25_000, 7000, 10, "gap"),  # A's positions miss a slot
])
def test_fused_merge_evict_kernel_matches_plain(dev, kw1, width, NA, NB, liveA, liveB,
                                                window, mode):
    r = np.random.default_rng(width + NB)
    keepA = np.zeros(NA, np.int32)
    keepA[r.choice(NA, size=liveA, replace=False)] = 1
    if mode == "run":
        keepA[NA // 3 : NA // 3 + 10_000] = 0
        liveA = int(keepA.sum())
    keepB = np.zeros(NB, np.int32)
    keepB[r.choice(NB, size=liveB, replace=False)] = 1
    mc = liveA + liveB
    if mode == "b_first":
        a_slots = np.arange(liveB, mc)
    elif mode == "b_last":
        a_slots = np.arange(liveA)
    else:
        a_slots = np.sort(r.choice(mc, size=liveA, replace=False))
    b_slots = np.setdiff1d(np.arange(mc), a_slots)
    posA = np.full(NA, 2**31 - 1, np.int32)
    posA[keepA != 0] = a_slots
    posB = np.full(NB, 2**31 - 1, np.int32)
    posB[keepB != 0] = b_slots
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    args = (
        t(r.integers(-(2**31), 2**31 - 1, (kw1, NA))), t(r.integers(0, 50, NA)),
        t(keepA), t(posA),
        t(r.integers(-(2**31), 2**31 - 1, (kw1, NB))), t(r.integers(0, 50, NB)),
        t(keepB), t(posB),
        torch.tensor(mc, dtype=torch.int32, device=dev),
        torch.tensor(window, dtype=torch.int32, device=dev),
    )
    if mode == "gap":
        args[2][int(np.flatnonzero(keepA)[liveA // 2])] = 0
    assert tk.merge_contract_faults(dev) == 0
    before = tk.LAUNCHES["fused_merge_evict"]
    ok, ov, oc = tk.fused_merge_evict(*args, width=width)
    assert tk.LAUNCHES["fused_merge_evict"] == before + 1
    faults = tk.merge_contract_faults(dev)
    if mode == "gap":  # output undefined, the reads stay in bounds, the one empty slot shows
        assert faults == 1 and 0 <= int(oc) <= width
        return
    assert faults == 0
    rk, rv, rc = tk.fused_merge_evict_reference(*args, width=width)
    n = int(rc)
    assert int(oc) == n
    if window >= 50:
        assert n == 1
    assert torch.equal(ok[:, :n], rk[:, :n]) and torch.equal(ov[:n], rv[:n])


@pytest.mark.parametrize("liveB", [0, 2])
def test_fused_merge_evict_drops_every_row_at_full_width(dev, liveB):
    """The first batch after a recovery's epoch jump: removeBefore passes
    every row of a full-width history (2,900,000 rows at width
    3,145,728), so the merge keeps only the first row, the batch's new
    rows and the row after each; the kernel equals its plain twin."""
    width, NA, NB, liveA = 3_145_728, 3_145_728, 1024, 2_900_000
    r = np.random.default_rng(liveB + 21)
    keepA = np.zeros(NA, np.int32)
    keepA[np.sort(r.choice(NA, size=liveA, replace=False))] = 1
    keepB = np.zeros(NB, np.int32)
    keepB[:liveB] = 1
    mc = liveA + liveB
    b_slots = np.sort(r.choice(mc, size=liveB, replace=False))
    a_slots = np.setdiff1d(np.arange(mc), b_slots)
    posA = np.full(NA, 2**31 - 1, np.int32)
    posA[keepA != 0] = a_slots
    posB = np.full(NB, 2**31 - 1, np.int32)
    posB[keepB != 0] = b_slots
    window = 100_000_000
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    args = (
        t(r.integers(-(2**31), 2**31 - 1, (3, NA))), t(r.integers(0, 5_000, NA)),
        t(keepA), t(posA),
        t(r.integers(-(2**31), 2**31 - 1, (3, NB))), t(np.full(NB, window + 7)),
        t(keepB), t(posB),
        torch.tensor(mc, dtype=torch.int32, device=dev),
        torch.tensor(window, dtype=torch.int32, device=dev),
    )
    assert tk.merge_contract_faults(dev) == 0
    before = tk.LAUNCHES["fused_merge_evict"]
    ok, ov, oc = tk.fused_merge_evict(*args, width=width)
    assert tk.LAUNCHES["fused_merge_evict"] == before + 1
    assert tk.merge_contract_faults(dev) == 0
    rk, rv, rc = tk.fused_merge_evict_reference(*args, width=width)
    n = int(rc)
    assert int(oc) == n and n <= 1 + 2 * liveB
    assert torch.equal(ok[:, :n], rk[:, :n]) and torch.equal(ov[:n], rv[:n])


def test_engine_on_the_card_matches_the_cpu(dev):
    """A reduced bench-shaped stream through TorchConflictSet on the GPU
    and on the CPU: identical verdicts, witnesses and exported state."""
    rng = np.random.default_rng(3)
    n = 2000
    gpu = et.TorchConflictSet(key_words=2, h_cap=1 << 13)
    cpu = et.TorchConflictSet(key_words=2, h_cap=1 << 13, device="cpu")
    for i in range(10):
        cap = et._next_pow2(n, 8)
        pb = et.PackedBatch(cap, cap, cap, 2)
        for begin, end, txn in ((pb.r_begin, pb.r_end, pb.r_txn),
                                (pb.w_begin, pb.w_end, pb.w_txn)):
            a = rng.integers(0, 100_000, n)
            begin[:n] = et.keylib.encode_int_keys(a, 2, 4)
            end[:n] = et.keylib.encode_int_keys(a + 1 + rng.integers(0, 10, n), 2, 4)
            txn[:n] = np.arange(n, dtype=np.int32)
        pb.r_snap[:n] = pb.t_snap[:n] = i
        pb.t_has_reads[:n] = pb.t_valid[:n] = True
        pb.n_txn = pb.n_r = pb.n_w = n
        g = gpu.detect_packed(pb, now=i + 3, new_oldest_version=i)
        c = cpu.detect_packed(pb, now=i + 3, new_oldest_version=i)
        assert (g == c).all()
        assert gpu.last_witness == cpu.last_witness
        assert gpu.last_iters == cpu.last_iters
        for x, y in zip(gpu.export_state(), cpu.export_state()):
            assert np.array_equal(x, y)
    assert gpu.grows >= 1 and gpu.cpu_fallbacks == 0
    assert tk.merge_contract_faults(dev) == 0


BUCKETS = (32, 128, 64)


def _k(i: int) -> bytes:
    return b"%08d" % i


def _stream(seed, keyspace, batches, txns_per_batch, snap_lag=25):
    r = np.random.default_rng(seed)
    version, out = 10, []
    for _ in range(batches):
        txns = []
        for _ in range(int(r.integers(1, txns_per_batch + 1))):
            t = TT(read_snapshot=max(0, version - int(r.integers(0, snap_lag))))
            for _ in range(int(r.integers(0, 4))):
                a = int(r.integers(0, keyspace))
                t.read_ranges.append((_k(a), _k(a + 1 + int(r.integers(0, keyspace // 8)))))
            for _ in range(int(r.integers(0, 3))):
                a = int(r.integers(0, keyspace))
                t.write_ranges.append((_k(a), _k(a + 1 + int(r.integers(0, keyspace // 10)))))
            txns.append(t)
        now = version + int(r.integers(1, 10))
        out.append((txns, now, max(0, version - snap_lag)))
        version = now
    return out


def _run_both(stream, gpu, cpu):
    for txns, now, nov in stream:
        assert gpu.detect(txns, now, nov) == cpu.detect(txns, now, nov)
        assert gpu.last_witness == cpu.last_witness
        assert gpu.last_iters == cpu.last_iters
        for x, y in zip(gpu.export_state(), cpu.export_state()):
            assert np.array_equal(x, y)


def test_divergence_on_the_card_matches_the_cpu(dev):
    """A dependency chain overflows the residual domain mid-stream: on the
    card the step leaves the history unchanged, the batch is re-decided on
    the flat CPU engine and adopted back (load_from), and the kernels go
    on from that state exactly as the CPU run's plain twins do."""
    stream = _stream(7, 50, batches=8, txns_per_batch=20)
    chain = [TT(read_snapshot=stream[2][1], read_ranges=[(_k(t), _k(t) + b"\x00")],
                write_ranges=[(_k(t + 1), _k(t + 1) + b"\x00")]) for t in range(70)]
    stream.insert(3, (chain, stream[2][1] + 1, 0))
    for i in range(4, len(stream)):
        txns, now, nov = stream[i]
        stream[i] = (txns, now + 1, nov)
    gpu = et.TorchConflictSet(key_words=3, h_cap=64, bucket_mins=BUCKETS)
    cpu = et.TorchConflictSet(key_words=3, h_cap=64, bucket_mins=BUCKETS, device="cpu")
    before = dict(tk.LAUNCHES)
    _run_both(stream, gpu, cpu)
    assert gpu.cpu_fallbacks == cpu.cpu_fallbacks == 1
    assert gpu.grows >= 1 and gpu.h_cap == cpu.h_cap
    for name in tk.LAUNCHES:
        assert tk.LAUNCHES[name] - before[name] == len(stream)


def test_carried_state_on_the_card_matches_the_cpu(dev):
    """A state exported mid-stream from one engine (an h_cap that is neither
    a power of two nor a multiple of the merge tile) is loaded into a GPU
    and a CPU engine; both continue identically."""
    stream = _stream(19, 60, batches=12, txns_per_batch=30)
    src = et.TorchConflictSet(key_words=3, h_cap=1000, bucket_mins=BUCKETS, device="cpu")
    for txns, now, nov in stream[:6]:
        src.detect(txns, now, nov)
    exported = src.export_state()
    gpu = et.TorchConflictSet(key_words=3, h_cap=64, bucket_mins=BUCKETS)
    cpu = et.TorchConflictSet(key_words=3, h_cap=64, bucket_mins=BUCKETS, device="cpu")
    gpu.load_state(state_from_jax(*exported))
    cpu.load_state(state_from_jax(*exported, device="cpu"))
    for x, y in zip(gpu.export_state(), exported):
        assert np.array_equal(x, y)
    before = dict(tk.LAUNCHES)
    _run_both(stream[6:], gpu, cpu)
    assert gpu.cpu_fallbacks == 0 and gpu.h_cap == cpu.h_cap
    for name in tk.LAUNCHES:
        assert tk.LAUNCHES[name] - before[name] == len(stream) - 6


def test_conflict_set_fault_script_on_the_card_matches_the_cpu(dev):
    """ConflictSet at pipeline depth 2 under a scripted injector (dispatch
    checks 1-3 open the breaker; the first probe must grow the 64-row
    history and takes a grow fault; the second rehydrates from a
    MirrorSnapshot) on the GPU and on the CPU: identical verdicts,
    witnesses, injected log, breaker transitions, mirror and device export,
    and both equal to the CPU-only backend."""
    from foundationdb_tpu_torch.conflict.api import ConflictSet
    from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector
    from foundationdb_tpu_torch.conflict.engine_cpu_flat import FlatCpuConflictSet

    stream = _stream(13, 400, batches=16, txns_per_batch=8)

    def run(device, backend="torch"):
        inj = DeviceFaultInjector()
        for at in (1, 2, 3):
            inj.script("dispatch", at=at)
        inj.script("grow", at=1)
        cs = ConflictSet(backend=backend, key_words=3, bucket_mins=BUCKETS, h_cap=64,
                         device=device, fault_injector=inj)
        out = []
        for txns, now, nov in stream:
            out.append(cs.pipeline_submit(txns, now, nov))
            while cs.pipeline_inflight > 1:
                cs.pipeline_complete_oldest()
        cs.pipeline_drain()
        return cs, inj, [(e.statuses, e.witness) for e in out]

    gpu, ginj, got = run(dev)
    cpu, cinj, want = run("cpu")
    assert got == want == run("cpu", backend="cpu")[2]
    assert ginj.injected == cinj.injected
    assert [site for _s, site, _k in ginj.injected] == ["dispatch"] * 3 + ["grow"]
    gm, cm = gpu.device_metrics(), cpu.device_metrics()
    assert gm["breaker"] == cm["breaker"] and gm["backend_state"] == "ok"
    assert gm["counters"]["rehydrates"] >= 1 and gm["counters"]["faults_grow"] == 1
    assert list(gpu._cpu.keys) == list(cpu._cpu.keys)
    exports = []
    for cs in (gpu, cpu):
        flat = FlatCpuConflictSet()
        cs._dev.store_to(flat)
        exports.append((flat.keys, flat.vers, flat.oldest_version))
        assert cs.mirror_check()["status"] == "ok"
    assert exports[0] == exports[1]
    assert tk.merge_contract_faults(dev) == 0


def _long_key_stream(seed, batches, width=12):
    """Batches whose keys crowd three regions of the device width (the one
    at the end of the key space among them): keys shorter than, equal to
    and longer than `width` under shared prefixes."""
    r = np.random.default_rng(seed)
    heads = [b"ab" * (width // 2), b"ac" * (width // 2), b"\xff" * width]
    tails = [b"", b"\x00", b"a", b"b", b"\xff", b"a\x00", b"ab", b"\xff\xff\x00"]

    def key():
        head = heads[int(r.integers(0, len(heads)))]
        if int(r.integers(0, 4)) == 0:
            return head[: int(r.integers(1, width))]
        return head + tails[int(r.integers(0, len(tails)))]

    version, out = 10, []
    for _ in range(batches):
        txns = []
        for _ in range(int(r.integers(1, 9))):
            t = TT(read_snapshot=max(0, version - int(r.integers(0, 25))))
            t.read_ranges = [tuple(sorted((key(), key()))) for _ in range(int(r.integers(0, 3)))]
            t.write_ranges = [tuple(sorted((key(), key()))) for _ in range(int(r.integers(0, 3)))]
            txns.append(t)
        version += int(r.integers(1, 10))
        out.append((txns, version, max(0, version - 40)))
    return out


def test_long_key_side_table_on_the_card_matches_the_cpu(dev):
    """Keys past the device width at pipeline depth 2, on the GPU and on
    the CPU: verdicts and witnesses equal to each other and to the host
    backend's (which holds every key itself), the same long-key batches
    counted, and one launch of each kernel in every batch the device
    served."""
    from foundationdb_tpu_torch.conflict.api import ConflictSet

    stream = _long_key_stream(5, 60)

    def run(device, backend="torch"):
        cs = ConflictSet(backend=backend, key_words=3, bucket_mins=BUCKETS, h_cap=1 << 10,
                         device=device)
        out = []
        for txns, now, nov in stream:
            out.append(cs.pipeline_submit(txns, now, nov))
            while cs.pipeline_inflight > 1:
                cs.pipeline_complete_oldest()
        cs.pipeline_drain()
        return cs, [(e.statuses, e.witness) for e in out]

    before = dict(tk.LAUNCHES)
    gpu, got = run(dev)
    launches = {n: tk.LAUNCHES[n] - before[n] for n in tk.LAUNCHES}
    cpu, want = run("cpu")
    assert got == want == run("cpu", backend="cpu")[1]
    gc, cc = gpu.device_metrics()["counters"], cpu.device_metrics()["counters"]
    for name in ("batches", "long_key_batches", "long_key_host_batches"):
        assert gc[name] == cc[name]
    assert gc["long_key_batches"] > gc["long_key_host_batches"] > 0
    assert gc["batches"] == len(stream) - gc["long_key_host_batches"]
    assert all(v == gc["batches"] for v in launches.values())


def _tiers(cs):
    """The tiered engine's raw state on the host: both tiers, the carried
    table, the counts and the host bounds."""
    return [cs._hkeys.cpu().numpy(), cs._hvers.cpu().numpy(), int(cs._hcount),
            cs._maxtab.cpu().numpy(), cs._dkeys.cpu().numpy(), cs._dvers.cpu().numpy(),
            int(cs._dcount), int(cs._oldest), cs._base, cs._hcount_bound,
            cs._dcount_bound, cs._batches_since_major, cs.h_cap, cs.d_cap]


def test_tiered_engine_on_the_card_matches_the_cpu(dev):
    """The tiered step on the card — the two-tier search, the delta merge
    and the major compaction's merge with a sparse delta — against the
    same engine on the CPU (plain twins), batch by batch, raw tiers
    included, with compactions by cadence, a delta grow and a base that
    grows on a compaction batch."""
    stream = _stream(29, 400, batches=16, txns_per_batch=30)
    kw = dict(key_words=3, h_cap=128, bucket_mins=BUCKETS, history="tiered",
              delta_cap=128, evict_every=3)
    gpu = et.TorchConflictSet(**kw)
    cpu = et.TorchConflictSet(device="cpu", **kw)
    before = dict(tk.LAUNCHES)
    for txns, now, nov in stream:
        assert gpu.detect(txns, now, nov) == cpu.detect(txns, now, nov)
        assert gpu.last_witness == cpu.last_witness
        assert gpu.last_iters == cpu.last_iters
        for x, y in zip(_tiers(gpu), _tiers(cpu)):
            assert np.array_equal(x, y)
    majors = gpu.metrics.counter("major_compactions").value
    assert majors >= 4 and gpu.h_cap > 128 and gpu.d_cap > 128
    assert tk.LAUNCHES["phase1_ranks"] - before["phase1_ranks"] == 2 * len(stream)
    assert (tk.LAUNCHES["fused_merge_evict"] - before["fused_merge_evict"]
            == len(stream) + majors)
    assert tk.merge_contract_faults(dev) == 0


def test_pipelined_host_budget_on_the_card(dev):
    """At depth 2 on the card a healthy batch costs at most 3 host syncs
    (its readback, the fixpoint's check, an occasional bound refresh) and,
    once the staging ring and the readback pool are populated, no host
    allocation; the verdicts equal the CPU run's."""
    from foundationdb_tpu_torch.conflict.api import ConflictSet

    def batch(i):
        t = TT(read_snapshot=0)
        for j in range(40):
            t.read_ranges.append((_k(10_000 * i + 4 * j), _k(10_000 * i + 4 * j + 1)))
            t.write_ranges.append((_k(10_000 * i + 4 * j + 2), _k(10_000 * i + 4 * j + 3)))
        return [t]

    def drive(cs, i0, n):
        out = []
        for i in range(i0, i0 + n):
            out.append(cs.pipeline_submit(batch(i), 5 * i + 5, 0))
            while cs.pipeline_inflight > 1:
                cs.pipeline_complete_oldest()
        cs.pipeline_drain()
        return [(e.statuses, e.witness) for e in out]

    gpu = ConflictSet(key_words=3, h_cap=1 << 10, bucket_mins=BUCKETS, pipeline_depth=2)
    cpu = ConflictSet(key_words=3, h_cap=1 << 10, bucket_mins=BUCKETS, pipeline_depth=2,
                      device="cpu")
    eng = gpu._dev
    assert drive(gpu, 0, 2) == drive(cpu, 0, 2)
    syncs0, allocs0 = eng.host_syncs, eng.host_allocs
    assert drive(gpu, 2, 8) == drive(cpu, 2, 8)
    assert eng.host_syncs - syncs0 <= 3 * 8
    assert eng.host_allocs == allocs0


@pytest.mark.parametrize("history", ["flat", "tiered"])
def test_sharded_set_on_the_card_matches_the_cpu(dev, history):
    """ShardedTorchConflictSet with 4 shards on the card against the same
    set on the CPU, batch by batch: verdicts, witnesses, iterations, every
    shard's slice and the counters, under a dispatch outage on shard 2 and
    with histories that grow; each active shard launches each kernel once a
    batch (tiered: the two-tier search twice, the merge once plus its
    compactions)."""
    from foundationdb_tpu_torch.parallel import sharded_resolver as sr

    stream = _stream(31, 400, batches=14, txns_per_batch=30)
    split = [_k(100), _k(200), _k(300)]
    kw = dict(key_words=3, h_cap=128, bucket_mins=BUCKETS)
    if history == "tiered":
        kw.update(history="tiered", delta_cap=128, evict_every=3)
    runs = []
    for device in (None, "cpu"):
        from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector

        inj = DeviceFaultInjector()
        cs = sr.ShardedTorchConflictSet(split, device=device, fault_injector=inj, **kw)
        before = dict(tk.LAUNCHES)
        out = []
        for i, (txns, now, nov) in enumerate(stream):
            if i == 3:
                inj.begin_outage("dispatch", shard=2)
            if i == 6:
                inj.end_outage("dispatch", shard=2)
            v = cs.detect(txns, now, nov)
            host = cs._host_state()
            out.append((v, cs.last_witness, cs.last_iters,
                        [cs._device_shard_state(s, *host) for s in range(4)]))
        launches = {k: tk.LAUNCHES[k] - before[k] for k in before}
        runs.append((out, inj.injected, [b.transitions for b in cs._breakers],
                     cs.metrics.snapshot()["counters"], launches))
    (gpu, g_inj, g_tr, g_c, g_l), (cpu, c_inj, c_tr, c_c, c_l) = runs
    assert gpu == cpu
    assert (g_inj, g_tr, g_c) == (c_inj, c_tr, c_c)
    assert g_c["grows"] >= 1 and g_c["degraded_shard_serves"] > 0 and g_tr[2]
    assert c_l == {"phase1_ranks": 0, "fused_merge_evict": 0}
    assert g_l["phase1_ranks"] > 0 and g_l["fused_merge_evict"] > 0
    assert tk.merge_contract_faults(dev) == 0


@pytest.mark.parametrize("history", ["flat", "tiered"])
def test_resharded_set_on_the_card_matches_the_cpu(dev, history):
    """A live boundary move and a scale-up from 4 to 8 shards on the card
    against the same schedule on the CPU: verdicts, witnesses, iterations,
    every shard's slice, which slices are stale, the counters and the move
    log are equal batch by batch; after the scale-up each kernel launches
    once a shard a batch on the re-stacked state."""
    from foundationdb_tpu_torch.parallel import sharded_resolver as sr

    stream = _stream(37, 400, batches=12, txns_per_batch=30)
    kw = dict(key_words=3, h_cap=256, bucket_mins=BUCKETS, max_shards=8)
    if history == "tiered":
        kw.update(history="tiered", delta_cap=128, evict_every=3)
    runs = []
    for device in (None, "cpu"):
        cs = sr.ShardedTorchConflictSet([_k(100), _k(200), _k(300)], device=device, **kw)
        out = []
        for i, (txns, now, nov) in enumerate(stream):
            if i == 3:
                assert cs.reshard([_k(100), _k(150), _k(300)])["moved"] == [1, 2]
            if i == 6:
                assert cs.reshard(cs.balance_split_keys(8))["shards"] == [4, 8]
            before = dict(tk.LAUNCHES)
            stale = list(cs._stale)
            v = cs.detect(txns, now, nov)
            host = cs._host_state()
            out.append((v, cs.last_witness, cs.last_iters, stale,
                        [cs._device_shard_state(s, *host) for s in range(cs.n_shards)],
                        {k: tk.LAUNCHES[k] - before[k] for k in before}))
        runs.append((out, cs.move_log, cs.metrics.snapshot()["counters"]))
    (gpu, g_log, g_c), (cpu, c_log, c_c) = runs
    strip = lambda o: [x[:5] for x in o]  # noqa: E731
    assert strip(gpu) == strip(cpu)
    assert (g_log, g_c) == (c_log, c_c)
    assert [e["action"] for e in g_log] == ["live", "live"]
    assert all(x[3] == [True] * 8 for x in gpu[6:7])
    if history == "flat":
        assert all(x[5] == {"phase1_ranks": 8, "fused_merge_evict": 8} for x in gpu[7:])
    assert all(x[5] == {"phase1_ranks": 0, "fused_merge_evict": 0} for x in cpu)
    assert tk.merge_contract_faults(dev) == 0


def _random_injector(seed):
    """The port's buggify armed on a seeded stream (every site activated)
    and a random-mode injector on another."""
    from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector
    from foundationdb_tpu_torch.flow import buggify
    from foundationdb_tpu_torch.flow.rng import DeterministicRandom

    buggify.set_buggify_enabled(True, DeterministicRandom(seed), activated_probability=1.0)
    return DeviceFaultInjector(rng=DeterministicRandom(seed + 100), fire_probability=0.3)


@pytest.fixture
def buggify_off():
    from foundationdb_tpu_torch.flow import buggify

    yield
    buggify.set_buggify_enabled(False)


@pytest.mark.parametrize("seed", [3, 4])
def test_random_faults_on_the_card_match_the_cpu(dev, buggify_off, seed):
    """ConflictSet at pipeline depth 2 under random-mode faults, the same
    seeds on the GPU and the CPU: identical verdicts, witnesses, injected
    log, breaker walk, counters and buggify coverage, and verdicts equal to
    the CPU-only backend's; each kernel launches once a dispatch."""
    from foundationdb_tpu_torch.conflict.api import ConflictSet
    from foundationdb_tpu_torch.flow import buggify

    stream = _stream(seed, 400, batches=20, txns_per_batch=8)

    def run(device, backend="torch"):
        inj = _random_injector(seed)
        cs = ConflictSet(backend=backend, key_words=3, bucket_mins=BUCKETS, h_cap=64,
                         device=device, fault_injector=inj)
        before = dict(tk.LAUNCHES)
        out = []
        for txns, now, nov in stream:
            out.append(cs.pipeline_submit(txns, now, nov))
            while cs.pipeline_inflight > 1:
                cs.pipeline_complete_oldest()
        cs.pipeline_drain()
        launches = {k: tk.LAUNCHES[k] - before[k] for k in before}
        return cs, inj, [(e.statuses, e.witness) for e in out], launches, buggify.coverage()

    gpu, ginj, got, g_l, g_cov = run(dev)
    cpu, cinj, want, c_l, c_cov = run("cpu")
    assert got == want == run("cpu", backend="cpu")[2]
    assert ginj.injected == cinj.injected and ginj.injected
    assert g_cov == c_cov
    gm, cm = gpu.device_metrics(), cpu.device_metrics()
    # host_allocs counts the pinned readback buffers, which only the GPU has.
    gc, cc = ({k: v for k, v in m["counters"].items() if k != "host_allocs"} for m in (gm, cm))
    assert gm["breaker"] == cm["breaker"] and gc == cc
    assert gm["counters"]["device_faults"] == len(ginj.injected)
    dispatches = gm["counters"]["pipeline_dispatches"]
    assert g_l == {"phase1_ranks": dispatches, "fused_merge_evict": dispatches}
    assert c_l == {"phase1_ranks": 0, "fused_merge_evict": 0}
    assert tk.merge_contract_faults(dev) == 0


def test_random_faults_on_the_card_match_the_cpu_sharded(dev, buggify_off):
    """ShardedTorchConflictSet with 4 shards under random-mode faults at
    per-shard sites, the same seeds on the GPU and the CPU: identical
    verdicts, witnesses, iterations, shard slices, injected log, every
    breaker walk and the counters."""
    from foundationdb_tpu_torch.parallel import sharded_resolver as sr

    stream = _stream(37, 400, batches=14, txns_per_batch=30)
    split = [_k(100), _k(200), _k(300)]
    runs = []
    for device in (None, "cpu"):
        inj = _random_injector(5)
        cs = sr.ShardedTorchConflictSet(split, device=device, fault_injector=inj, key_words=3,
                                        h_cap=128, bucket_mins=BUCKETS)
        out = []
        for txns, now, nov in stream:
            v = cs.detect(txns, now, nov)
            host = cs._host_state()
            out.append((v, cs.last_witness, cs.last_iters,
                        [cs._device_shard_state(s, *host) for s in range(4)]))
        runs.append((out, inj.injected, [b.transitions for b in cs._breakers],
                     cs.metrics.snapshot()["counters"]))
    assert runs[0] == runs[1]
    assert runs[0][1] and {site.split("#")[1] for _q, site, _k in runs[0][1]} >= {"s0", "s1"}
    assert tk.merge_contract_faults(dev) == 0


def _engines_at(dev, stream, **kw):
    """A TorchConflictSet on the GPU and one on the CPU, each after the
    stream."""
    out = []
    for device in (None, "cpu"):
        eng = et.TorchConflictSet(key_words=3, h_cap=512, bucket_mins=BUCKETS, device=device,
                                  **kw)
        for txns, now, nov in stream:
            eng.detect(txns, now, nov)
        out.append(eng)
    return out


def test_ablation_arms_on_the_card_match_the_cpu(dev):
    """Every attribution arm (each ablation, and each again on the plain
    non-kernel step) gives the same outputs on the GPU as on the CPU; the
    kernel arms launch the kernels they keep once a run, the plain arms
    none, and the plain full arm equals the kernel full arm."""
    from foundationdb_tpu_torch.conflict import phase_attribution as pa

    stream = _stream(43, 60, batches=8, txns_per_batch=30)
    gpu, cpu = _engines_at(dev, stream[:-1])
    reps = [pa.attribute_phases(eng, stream[-1][0]) for eng in (gpu, cpu)]

    def arms(rep):
        kab = rep["kernel_ab"]
        blocks = [rep["full"], *rep["phases"], kab["plain_full"], *kab["plain_phases"]]
        return [(b["ablate"], b["host_checks"], b["digest"]) for b in blocks], blocks

    (g, g_blocks), (c, _c_blocks) = arms(reps[0]), arms(reps[1])
    assert g == c
    assert reps[0]["kernel_ab"]["identical"]
    keeps = {"nosearch": (0, 1), "nomerge": (1, 0)}
    for b in g_blocks:
        toks = set(b["ablate"])
        want = (0, 0) if "nokernel" in toks else next(
            (keeps[t] for t in toks if t in keeps), (1, 1))
        assert (b["launches"]["phase1_ranks"], b["launches"]["fused_merge_evict"]) == want, b
    assert tk.merge_contract_faults(dev) == 0


def test_nokernel_engine_on_the_card_launches_nothing(dev):
    """An engine built with ablate={"nokernel"} serves a stream on the GPU
    without a kernel launch, bit for bit as the kernel engine does."""
    stream = _stream(47, 60, batches=6, txns_per_batch=30)
    kern = et.TorchConflictSet(key_words=3, h_cap=512, bucket_mins=BUCKETS)
    plain = et.TorchConflictSet(key_words=3, h_cap=512, bucket_mins=BUCKETS,
                                ablate={"nokernel"})
    for txns, now, nov in stream:
        want = kern.detect(txns, now, nov)
        before = dict(tk.LAUNCHES)
        assert plain.detect(txns, now, nov) == want
        assert tk.LAUNCHES == before
        assert plain.last_witness == kern.last_witness and plain.last_iters == kern.last_iters
        for x, y in zip(plain.export_state(), kern.export_state()):
            assert np.array_equal(x, y)


def test_amortized_eviction_on_the_card_matches_the_cpu(dev):
    """TorchConflictSet(evict_every=3) on the GPU and the CPU: identical
    verdicts, witnesses, iterations and exported state after every batch,
    through growth; and ConflictSet(evict_every=3): mirror_check ok."""
    from foundationdb_tpu_torch.conflict.api import ConflictSet

    stream = _stream(53, 300, batches=12, txns_per_batch=30)
    gpu = et.TorchConflictSet(key_words=3, h_cap=160, bucket_mins=BUCKETS, evict_every=3)
    cpu = et.TorchConflictSet(key_words=3, h_cap=160, bucket_mins=BUCKETS, evict_every=3,
                              device="cpu")
    _run_both(stream, gpu, cpu)
    assert gpu.grows >= 1 and gpu.h_cap == cpu.h_cap
    cs = ConflictSet(key_words=3, h_cap=160, bucket_mins=BUCKETS, evict_every=3)
    for txns, now, nov in stream[:-1]:
        b = cs.new_batch()
        for t in txns:
            b.add_transaction(t)
        b.detect_conflicts(now, nov)
    report = cs.mirror_check()
    assert report["status"] == "ok" and "below_window_keys" in report
    assert tk.merge_contract_faults(dev) == 0


def test_program_table_on_the_card(dev):
    """Every registered program runs on the GPU at its canonical shapes;
    each step entry allocates temporaries above its arguments and outputs."""
    import foundationdb_tpu_torch.parallel  # noqa: F401  registers the sharded steps
    from foundationdb_tpu_torch.conflict import programs

    table = programs.program_cost_table()
    assert set(table) == set(programs.DEVICE_ENTRY_POINTS)
    for name, blk in table.items():
        assert "error" not in blk, blk
        assert blk["memory"]["temp"] >= 0
    for name in ("flat_step_kernels", "flat_step", "tiered_step_kernels",
                 "sharded_step_kernels", "sharded_step_tiered"):
        assert table[name]["memory"]["temp"] > 0, name
    assert programs.cached_program_costs(dev) == table


@pytest.mark.parametrize("history", ["flat", "tiered"])
def test_witness_free_engine_on_the_card_matches_the_cpu(dev, history):
    """TorchConflictSet(witness=False) on the GPU and the CPU: identical
    verdicts, iterations and exported state, last_witness [] and a readback
    of _HEAD + txn_cap words, through growth and one residual overflow
    (the CPU fallback); both kernels launch once a batch (tiered: the
    two-tier search twice, the merge once plus its compactions)."""
    stream = _stream(61, 400, batches=10, txns_per_batch=30)
    now = stream[4][1]
    chain = [TT(read_snapshot=now, read_ranges=[(_k(t), _k(t) + b"\x00")],
                write_ranges=[(_k(t + 1), _k(t + 1) + b"\x00")]) for t in range(70)]
    stream.insert(5, (chain, now + 1, 0))
    for i in range(6, len(stream)):
        txns, n_, nov = stream[i]
        stream[i] = (txns, n_ + 1, nov)
    kw = dict(key_words=3, h_cap=160, bucket_mins=BUCKETS, witness=False)
    if history == "tiered":
        kw.update(history="tiered", delta_cap=128, evict_every=3)
    gpu = et.TorchConflictSet(**kw)
    cpu = et.TorchConflictSet(device="cpu", **kw)
    before = dict(tk.LAUNCHES)
    for txns, now, nov in stream:
        ticket = gpu.dispatch_txns(txns, now, nov)
        assert ticket.out.shape[0] == et._HEAD + ticket.pb.txn_cap
        g = gpu.readback_packed(ticket)
        assert list(g[: len(txns)]) == cpu.detect(txns, now, nov)
        assert gpu.last_witness == cpu.last_witness == []
        assert gpu.last_iters == cpu.last_iters
        for x, y in zip(gpu.export_state(), cpu.export_state()):
            assert np.array_equal(x, y)
    assert gpu.cpu_fallbacks == cpu.cpu_fallbacks == 1 and gpu.grows >= 1
    assert tk.LAUNCHES["phase1_ranks"] > before["phase1_ranks"]
    assert tk.LAUNCHES["fused_merge_evict"] > before["fused_merge_evict"]
    assert tk.merge_contract_faults(dev) == 0


@pytest.mark.parametrize("history", ["flat", "tiered"])
def test_two_level_engine_on_the_card_matches_the_cpu(dev, history):
    """TorchConflictSet(search="2level") at h_cap 1 << 16 (the 2level
    form's least width) on the GPU and the CPU, and the flat search on the
    GPU: identical verdicts, witnesses, iterations and exported state;
    and searchsorted_words' two forms bit for bit on the card."""
    from foundationdb_tpu_torch.ops import rangequery as rq

    stream = _stream(67, 3000, batches=8, txns_per_batch=30)
    kw = dict(key_words=3, h_cap=1 << 16, bucket_mins=BUCKETS)
    if history == "tiered":
        kw.update(history="tiered", delta_cap=256, evict_every=2)
    two = et.TorchConflictSet(search="2level", search_stride=64, **kw)
    cpu = et.TorchConflictSet(device="cpu", search="2level", search_stride=64, **kw)
    flat = et.TorchConflictSet(**kw)
    for txns, now, nov in stream:
        want = flat.detect(txns, now, nov)
        assert two.detect(txns, now, nov) == want == cpu.detect(txns, now, nov)
        assert two.last_witness == cpu.last_witness == flat.last_witness
        assert two.last_iters == cpu.last_iters
        for x, y, z in zip(two.export_state(), cpu.export_state(), flat.export_state()):
            assert np.array_equal(x, y) and np.array_equal(x, z)
    keys = two._hkeys
    q = torch.cat([keys[:, :: 3], torch.randint(-(2**31), 2**31 - 1, (4, 5000),
                                                dtype=torch.int32, device=dev)], 1)
    for side in ("left", "right"):
        for stride in (8, 512, 1024):
            assert torch.equal(rq.searchsorted_words(keys, q, side),
                               rq.searchsorted_words(keys, q, side, mode="2level",
                                                     stride=stride))
    assert tk.merge_contract_faults(dev) == 0


def _observed_on(device, config, stream):
    """One stream through a ConflictSet at depth 2 ("set") or 2 shards
    ("shards") on fresh port hubs whose clock is the batch index, under a
    dispatch outage that opens and closes the breaker and a device edit
    after batch 6 that mirror_check finds.  Returns (verdicts and
    witnesses, spans_json and host_phase_seq after every batch, the events,
    every capture's artifact_json)."""
    from foundationdb_tpu_torch.conflict.api import ConflictSet
    from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector
    from foundationdb_tpu_torch.flow import flight_recorder as fr
    from foundationdb_tpu_torch.flow import spans, trace
    from foundationdb_tpu_torch.parallel import sharded_resolver as sr

    t = [0.0]
    saved = (spans.global_span_hub(), trace.global_collector(), trace._global_clock,
             fr.global_flight_recorder())
    hub = spans.SpanHub(clock=lambda: t[0])
    col = trace.TraceCollector(clock=lambda: t[0])
    rec = fr.FlightRecorder(clock=lambda: t[0])
    spans.set_global_span_hub(hub)
    trace.set_global_collector(col)
    fr.set_global_flight_recorder(rec)
    try:
        inj = DeviceFaultInjector()
        if config == "shards":
            cs = sr.ShardedTorchConflictSet([_k(200)], key_words=3, h_cap=1 << 10,
                                            bucket_mins=BUCKETS, device=device,
                                            fault_injector=inj)
            inj.script("dispatch", at=2, persist=3, shard=1)
        else:
            cs = ConflictSet(key_words=3, bucket_mins=BUCKETS, h_cap=1 << 10, device=device,
                             fault_injector=inj)
            inj.script("dispatch", at=2, persist=3)
        out, per = [], []
        for i, (txns, now, nov) in enumerate(stream):
            t[0] = float(i)
            if config == "shards":
                out.append((list(cs.detect(txns, now, nov)), list(cs.last_witness)))
            else:
                out.append(cs.pipeline_submit(txns, now, nov))
                while cs.pipeline_inflight > 1:
                    cs.pipeline_complete_oldest()
            if i == 6:
                if config == "shards":
                    cs._hvers[0, 1] += 1
                else:
                    cs.pipeline_drain()
                    cs._dev._hvers[1] += 1
                assert cs.mirror_check()["status"] == "diverged"
            per.append((hub.spans_json(), getattr(cs, "host_phase_seq", 0)))
        if config != "shards":
            cs.pipeline_drain()
            out = [(list(e.statuses), list(e.witness)) for e in out]
        return out, per, list(col.events), [fr.artifact_json(a) for a in rec.captures]
    finally:
        spans.set_global_span_hub(saved[0])
        trace.set_global_collector(saved[1], clock=saved[2])
        fr.set_global_flight_recorder(saved[3])


@pytest.mark.parametrize("config", ["set", "shards"])
def test_spans_events_and_captures_on_the_card_match_the_cpu(dev, config):
    """The span record, host_phase_seq, trace events and flight-recorder
    captures of a faulted stream with a planted divergence are
    byte-identical on the card and on the CPU, for the single set at depth
    2 and for 2 shards."""
    stream = _stream(41, 400, batches=12, txns_per_batch=30)
    gpu = _observed_on(dev, config, stream)
    cpu = _observed_on("cpu", config, stream)
    assert gpu[0] == cpu[0]
    for i, (g, c) in enumerate(zip(gpu[1], cpu[1])):
        assert g == c, f"batch {i}"
    assert gpu[2] == cpu[2] and gpu[3] == cpu[3]
    types = [e["Type"] for e in gpu[2]]
    assert types.count("MirrorDivergence") == 1 and types.count("DeviceBackendStateChange") >= 4
    assert any('"trigger":"mirror_divergence"' in a for a in gpu[3])
    assert any('"trigger":"breaker_open"' in a for a in gpu[3])


def test_transfer_guard_on_the_card(dev, monkeypatch):
    """ConflictSet(transfer_guard=True) at depth 2 on the card: the stream's
    verdicts, witnesses and exported state equal the unguarded run's and
    the CPU's, so no sanctioned read raises; np.asarray of a parked
    ticket's out or host raises TransferGuardError; an .item() planted in
    the armed dispatch raises torch's sync error, and the sync debug mode
    is back at 0 after it; the default is off."""
    from foundationdb_tpu_torch.conflict.api import ConflictSet
    from foundationdb_tpu_torch.flow.hotpath import TransferGuardError

    stream = _stream(53, 400, batches=10, txns_per_batch=30)
    kw = dict(key_words=3, h_cap=1 << 10, bucket_mins=BUCKETS, pipeline_depth=2)
    assert ConflictSet(**kw)._dev.transfer_guard is False

    def run(device, guard):
        cs = ConflictSet(device=device, transfer_guard=guard, **kw)
        entries = []
        for txns, now, nov in stream:
            entries.append(cs.pipeline_submit(txns, now, nov))
            while cs.pipeline_inflight > 1:
                cs.pipeline_complete_oldest()
        cs.pipeline_drain()
        return cs, [(list(e.statuses), list(e.witness)) for e in entries]

    guarded, got = run(dev, True)
    assert got == run(dev, False)[1] == run("cpu", True)[1]
    assert guarded.mirror_check()["status"] == "ok"
    txns, now, nov = stream[-1]
    entry = guarded.pipeline_submit(txns, now + 1, nov + 1)
    assert not entry.done
    for field in ("out", "host"):
        with pytest.raises(TransferGuardError, match=f"DispatchTicket.{field}"):
            np.asarray(getattr(entry.ticket, field))
    guarded.pipeline_drain()
    real = et._blob_core

    def planted(*args, **kwargs):
        args[4][0].item()
        return real(*args, **kwargs)

    monkeypatch.setattr(et, "_blob_core", planted)
    with pytest.raises(RuntimeError, match="synchroniz"):
        guarded.pipeline_submit(txns, now + 2, nov + 2)
    assert torch.cuda.get_sync_debug_mode() == 0


def test_torchcheck_on_the_card_kernel_programs(dev):
    """The structural check's walker on the card: each kernel program's
    kernel regions hold a launch of each kernel it runs and otherwise only
    allocations (none of the plain twin's ops), every host read is in a
    sanctioned scope, and no TGX001, TGX002 or TGX005 finding is
    unsuppressed."""
    from foundationdb_tpu_torch.tools.lint import torchir

    reg = torchir.default_registry()
    allocs = {"empty", "empty_strided", "zeros", "zero_", "new_empty", "new_zeros", "fill_"}
    kernel_entries = [n for n in sorted(reg) if reg[n].kernel]
    assert kernel_entries
    runs = {}
    for name in kernel_entries:
        run = runs[name] = torchir.walk_program(reg[name], dev)
        in_kernel = [r.op for r in run.rows if r.in_kernel]
        launches = {op for op in in_kernel if op.startswith("launch:")}
        assert launches, name
        assert set(in_kernel) - launches <= allocs, (name, set(in_kernel) - launches)
        assert all(r.sanctioned for r in run.rows if r.sync is not None), name
    found = torchir.run_torchcheck({n: reg[n] for n in kernel_entries}, device=dev, runs=runs)
    assert not [f for f in found if not f.suppressed and f.rule in ("TGX001", "TGX002",
                                                                     "TGX005")]


def test_perfcheck_planted_window_on_the_card(dev):
    """chip_smoke's phase 2h plant on the card: between dispatch_txns
    (both kernels launch) and sync_ticket, under torch's sync debug mode,
    a callee runs (a) torch.cuda.synchronize(), (b) np.asarray(ticket.host)
    or (c) ticket.out.item().  perfcheck flags each with one HOT001 naming
    the chain drive -> _peek; the transfer guard raises TransferGuardError
    on (b) and (c); every batch's verdicts equal the CPU's (planted_window
    checks them)."""
    import importlib.util
    import pathlib

    from foundationdb_tpu_torch.tools.lint import runner

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    got = smoke.planted_window(torch, et, tk, TT, runner.lint_source, ["a", "b", "c"])
    assert sorted(got) == ["a", "b", "c"]
    for variant, r in got.items():
        assert smoke.plant_caught(variant, r["findings"]), (variant, r["findings"])
        assert min(r["launches"].values()) >= 1, (variant, r["launches"])
    for variant in ("b", "c"):
        assert got[variant]["guard"].startswith("TransferGuardError: "), got[variant]
    assert torch.cuda.get_sync_debug_mode() == 0


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_fdblint_planted_window_on_the_card(dev):
    """chip_smoke's phase 2h fdblint plants on the card: between
    dispatch_txns and sync_ticket a callee reads (d) time.time(), (e)
    random.random() or (f) os.environ.get("FDB_TPU_X"); fdblint gives
    each variant's rules, the DET101 finding naming drive -> _peek; each
    planted dispatch launches both kernels and its verdicts equal the
    CPU's (planted_window checks them)."""
    from foundationdb_tpu_torch.tools.lint import runner

    smoke = _chip_smoke()
    got = smoke.planted_window(torch, et, tk, TT, runner.lint_source, ["d", "e", "f"])
    assert sorted(got) == ["d", "e", "f"]
    for variant, r in got.items():
        assert smoke.plant_caught(variant, r["findings"]), (variant, r["findings"])
        assert r["guard"] is None
        assert min(r["launches"].values()) >= 1, (variant, r["launches"])


def test_two_runs_on_the_card_give_equal_records(dev):
    """chip_smoke's phase 6d at a small size: two fresh ConflictSets over
    one stream, each under fresh port hubs on a counting clock, give equal
    verdicts and witnesses, export, metrics snapshot (no wall namespace)
    and spans_json (no wall stamps), with one launch of each kernel a
    batch."""
    from foundationdb_tpu_torch.conflict import api
    from foundationdb_tpu_torch.flow import flight_recorder, spans, trace

    smoke = _chip_smoke()
    rng = np.random.default_rng(15)
    stream = [(smoke.gen_txns(TT, rng, 256, i, keyspace=50_000), i + smoke.WINDOW, i)
              for i in range(6)]
    settings = dict(key_words=2, h_cap=1 << 12)
    a, b = (smoke.determinism_run(torch, api, tk, spans, trace, flight_recorder, stream,
                                  settings) for _ in range(2))
    for key in ("batches", "export", "snapshot", "spans"):
        assert a[key] == b[key], key
    assert a["launches"] == {name: len(stream) for name in tk.LAUNCHES}
    assert "wall" not in a["snapshot"] and "wall_start" not in a["spans"]
    assert a["snapshot"]["counters"]["pipeline_dispatches"] == len(stream)


# ---------------------------------------------------------------------------
# a lost card (F6), and what CUDA's sync debug mode does with the hidden
# syncs perfcheck learned
# ---------------------------------------------------------------------------


def test_lost_card_classifier_on_the_card_runtime(dev):
    """chip_smoke's phase 6l: over every cudaError_t code 0-999 the card's
    runtime names, exactly the four lost-card codes classify, as the
    launcher's CudaError and as a torch.AcceleratorError with and without
    its error_code; the runtime's names of the four are the table's."""
    from foundationdb_tpu_torch import device as pdev

    rec = _chip_smoke().lost_card_codes(torch)
    assert sorted(rec["lost"]) == sorted(pdev.LOST_DEVICE_CODES)
    assert rec["named"] > 50
    for code, (name, text) in rec["lost"].items():
        assert name == pdev.LOST_DEVICE_CODES[code]
        assert text == pdev.cuda_error_string(code) and text


# A device-side assert (an out-of-range index on the step's stream, after
# the third batch's step) inside a pipelined window, in a child process: a
# sticky error poisons the process's CUDA context.
_STICKY = r'''
import json
import numpy as np
import torch
from foundationdb_tpu_torch import device as pdev
from foundationdb_tpu_torch.conflict import engine_torch as et
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.device_faults import DeviceFault
from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as TT

rng = np.random.default_rng(7)


def batch(v):
    out = []
    for _ in range(16):
        a = int(rng.integers(0, 400))
        b = a + 1 + int(rng.integers(0, 8))
        out.append(TT(v - 1, [(b"%08d" % a, b"%08d" % b)], [(b"%08d" % (a + 3), b"%08d" % (b + 3))]))
    return out


cs = ConflictSet(key_words=3, h_cap=1 << 10, bucket_mins=(32, 128, 64), pipeline_depth=2,
                 device="cuda")
real = et._blob_core
calls = [0]


def planted(*args, **kwargs):
    out = real(*args, **kwargs)
    calls[0] += 1
    if calls[0] == 3:
        h = args[0]
        h[0][torch.full((1,), 1 << 30, dtype=torch.long, device=h.device)]
    return out


et._blob_core = planted
rec = {"raised": None}
try:
    for i in range(8):
        v = 10 + i
        rec["where"] = "pipeline_submit"
        cs.pipeline_submit(batch(v), v, 0)
        while cs.pipeline_inflight > 1:
            rec["where"] = "pipeline_complete_oldest"
            cs.pipeline_complete_oldest()
    rec["where"] = "pipeline_drain"
    cs.pipeline_drain()
except Exception as e:
    rec.update(raised=type(e).__name__, mro=[c.__name__ for c in type(e).__mro__],
               device_fault=isinstance(e, DeviceFault), lost=pdev.is_lost_device(e),
               code=pdev.cuda_error_code(e), error_code=getattr(e, "error_code", "absent"),
               attributes=sorted(getattr(e, "__dict__", {})), first_line=str(e).splitlines()[0])
counters = cs._dev.metrics.snapshot()["counters"]
rec["device_faults"] = counters.get("device_faults", 0)
rec["transitions"] = cs._breaker.transitions
rec["torch"] = torch.__version__
print(json.dumps(rec, default=str), flush=True)
'''


def test_sticky_error_in_a_pipelined_window_propagates(dev):
    """A real sticky CUDA error (a device-side assert, code 710) produced
    inside a pipelined window is not a lost card: it propagates out of
    ConflictSet, with device_faults 0 and no breaker transition.  Prints
    what torch's AcceleratorError carries (its error_code, or none)."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo))
    p = subprocess.run([sys.executable, "-c", _STICKY], cwd=str(repo), env=env,
                       capture_output=True, text=True, timeout=300)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert lines, (p.returncode, p.stdout[-2000:], p.stderr[-2000:])
    rec = json.loads(lines[-1])
    print(f"sticky error record: {json.dumps(rec)}")
    assert rec["raised"] is not None and "RuntimeError" in rec["mro"], rec
    assert not rec["device_fault"] and not rec["lost"], rec
    assert rec["code"] in (None, 710), rec
    assert rec["device_faults"] == 0 and rec["transitions"] == [], rec


# What torch.cuda.set_sync_debug_mode("error") does with the four hidden
# syncs HOT001 learned (sync_debug_probe's names): True where it refuses,
# as read on an NVIDIA H100 with torch 2.11.
HIDDEN_SYNCS_REFUSED = {
    "truth test (if t[0]:)": True,
    "truth test (while (t > 0).any():)": True,
    "copy_ to pageable host memory (dst.copy_(t))": True,
    "torch.cuda.current_stream().synchronize()": True,
}
# chip_smoke's plant variant of each.
PLANT_OF = dict(zip("ghij", HIDDEN_SYNCS_REFUSED))


def test_sync_debug_mode_and_the_hidden_syncs_on_the_card(dev):
    """Which of the four hidden syncs CUDA's sync debug mode refuses, on
    plain device tensors (chip_smoke's sync_debug_probe) and planted
    between dispatch_txns and sync_ticket of an unguarded TorchConflictSet
    (chip_smoke's plant (g)-(j)); perfcheck names each with one HOT001 and
    the chain drive -> _peek, both kernels launch, every batch's verdicts
    equal the CPU's, and the mode is back at 0."""
    from foundationdb_tpu_torch.flow import hotpath
    from foundationdb_tpu_torch.tools.lint import runner

    smoke = _chip_smoke()
    seen = smoke.sync_debug_probe(torch, hotpath)
    print(f"sync debug mode refuses: {json.dumps(seen)}")
    assert {k: seen[k] for k in HIDDEN_SYNCS_REFUSED} == HIDDEN_SYNCS_REFUSED
    assert not seen["Event.wait (a stream waits on the device)"]
    assert not seen["copy_ on the device (other.copy_(t))"]
    got = smoke.planted_window(torch, et, tk, TT, runner.lint_source, list(PLANT_OF))
    for variant, r in got.items():
        assert smoke.plant_caught(variant, r["findings"]), (variant, r["findings"])
        assert min(r["launches"].values()) >= 1, (variant, r["launches"])
        assert (r["guard"] is not None) == HIDDEN_SYNCS_REFUSED[PLANT_OF[variant]], (variant, r)
    assert torch.cuda.get_sync_debug_mode() == 0


def _role_replies(device, depth):
    """The port's Resolver over ConflictSet(device=...) at the CPU tests'
    shape (key_words 3, h_cap 1 << 10): two proxies, reordered pairs, a
    retry while parked and a state transaction.  Every reply with its
    virtual time, and the role's deterministic snapshot."""
    from foundationdb_tpu_torch.client.types import Mutation, MutationType
    from foundationdb_tpu_torch.conflict.api import ConflictSet
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.rpc.network import SimNetwork
    from foundationdb_tpu_torch.server.interfaces import ResolveTransactionBatchRequest
    from foundationdb_tpu_torch.server.resolver import Resolver

    rng = np.random.default_rng(5)
    loop = el.EventLoop(5)
    el.set_event_loop(loop)
    try:
        net = SimNetwork(loop)
        cs = ConflictSet(key_words=3, bucket_mins=(32, 128, 64), h_cap=1 << 10,
                         pipeline_depth=depth, device=device)
        role = Resolver(net.process("resolver"), conflict_set=cs, n_proxies=2,
                        max_write_transaction_life_versions=40)
        proxies = net.process("proxies")
        iface = role.interface()
        reqs, prev, version = [], 0, 10
        for j in range(12):
            txns = []
            for _ in range(8):
                a, b = rng.integers(0, 60, 2)
                txns.append(TT(max(0, version - int(rng.integers(0, 25))),
                               [(b"%06d" % a, b"%06d" % (a + 3))], [(b"%06d" % b, b"%06d" % (b + 2))]))
            version += int(rng.integers(1, 10))
            state = [(0, [Mutation(MutationType.SET_VALUE, b"\xff/s", b"%d" % j)])] if j == 4 else []
            reqs.append(ResolveTransactionBatchRequest(
                prev_version=prev, version=version, transactions=txns, state_txns=state,
                proxy_id=f"p{j % 2}"))
            prev = version
        order = [j ^ 1 for j in range(12)]
        order.insert(1, 1)  # the retry of batch 1, sent while it is parked
        out = []

        async def go():
            futs = []
            for j in order:
                futs.append((j, iface.resolve.get_reply(proxies, reqs[j])))
                await loop.delay(0.001)
            for j, f in futs:
                r = await f
                out.append((j, [int(x) for x in r.committed], list(r.witnesses), r.degraded,
                            r.state_mutations, loop.now()))

        loop.run_until(proxies.spawn(go(), "go"), timeout_vt=60.0)
        return out, role.metrics.snapshot_json(), role.metrics.counter("cache_hits").value
    finally:
        el.set_event_loop(None)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_resolver_role_on_the_card_matches_the_cpu(dev, depth):
    """Resolver(process) builds its ConflictSet on the card, and the role
    gives the same replies, at the same virtual times, and the same
    registry snapshot on cuda as on cpu."""
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.rpc.network import SimNetwork
    from foundationdb_tpu_torch.server.resolver import Resolver

    loop = el.EventLoop(1)
    role = Resolver(SimNetwork(loop).process("r"))
    assert role.conflicts._dev.device.type == "cuda" and role._pipeline_on
    cuda = _role_replies("cuda", depth)
    assert cuda == _role_replies("cpu", depth)
    assert cuda[2] == 1 and any(r[4] for r in cuda[0])


def _cluster_record(device, depth):
    """chip_smoke's commit_script through the port's SimCluster at the CPU
    differential's shape (tests/test_torch_cluster.py), resolver 0 over a
    ConflictSet at `depth` on `device`."""
    from foundationdb_tpu_torch.client import types
    from foundationdb_tpu_torch.conflict import engine_cpu as ecpu
    from foundationdb_tpu_torch.conflict.api import ConflictSet
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.server import interfaces as itf
    from foundationdb_tpu_torch.server.cluster import SimCluster

    smoke = _chip_smoke()
    cs = ConflictSet(device=device, pipeline_depth=depth, key_words=3,
                     bucket_mins=(32, 128, 64), h_cap=1 << 10)
    try:
        c = SimCluster(seed=5, conflict_set=cs, n_proxies=2, n_tlogs=2, buggify=False,
                       device=device)
        return smoke.cluster_record(c, types, itf, lambda s: smoke.set_state(ecpu, s))
    finally:
        el.set_event_loop(None)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_commit_path_on_the_card_matches_the_cpu(dev, depth):
    """SimCluster() builds every resolver's set on the card, and the commit
    script gives the same replies, virtual times, logs, storage, registries
    and resolver state on cuda as on cpu."""
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.server.cluster import SimCluster

    try:
        c = SimCluster(seed=1, n_resolvers=2, buggify=False)
        assert all(r.conflicts._dev.device.type == "cuda" for r in c.resolvers)
    finally:
        el.set_event_loop(None)
    cuda = _cluster_record("cuda", depth)
    assert cuda == _cluster_record("cpu", depth)
    assert any(r[2] == "error" and r[3] == "not_committed" for r in cuda["replies"])


def _client_record(device, depth):
    """chip_smoke's phase 6n script through the port's SimCluster(
    n_resolvers=2, n_proxies=2, buggify=True), every resolver over a
    ConflictSet of the Resolver's default key width at `depth` on `device`;
    returns the record, the launches, the device-served batches and the
    resolve batches."""
    from foundationdb_tpu_torch import workloads as wl
    from foundationdb_tpu_torch.client import transaction as txmod
    from foundationdb_tpu_torch.conflict import kernels as tk
    from foundationdb_tpu_torch.conflict.api import ConflictSet
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.server import cluster as cm

    smoke = _chip_smoke()
    sets = []

    def make_set():
        sets.append(ConflictSet(device=device, pipeline_depth=depth, **smoke.CLIENT_SET_KW))
        return sets[-1]

    for name in tk.LAUNCHES:
        tk.LAUNCHES[name] = 0
    try:
        with smoke.resolver_sets(cm, make_set):
            c = cm.SimCluster(seed=43, n_proxies=2, n_resolvers=2, buggify=True, device=device)
        record = smoke.client_record(c, wl, txmod)
    finally:
        el.set_event_loop(None)
    served = sum(s.device_metrics()["counters"]["batches"] for s in sets)
    batches = sum(r.metrics.counter("batches").value for r in c.resolvers)
    return record, dict(tk.LAUNCHES), served, batches


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_client_on_the_card_matches_the_cpu(dev, depth):
    """The client's reads, commits, errors and retries, the rings, the
    balancer's moves and the roles' state are equal on cuda and cpu, and
    each kernel launched once in every resolve batch, the card serving
    every one (the balancer's long key goes through the side table)."""
    cuda, launches, served, batches = _client_record("cuda", depth)
    assert cuda == _client_record("cpu", depth)[0]
    smoke = _chip_smoke()
    assert smoke.ring_ok(cuda["ring"]) and cuda["balancer"][1] >= 1
    assert served == batches > 0 and all(v == batches for v in launches.values())


def _acceptance_record(device, depth, config="config 2"):
    """chip_smoke's phase 6m: one of its acceptance configs (the
    reference's exact shape and seed) through the port's SimCluster, every
    resolver over a ConflictSet of the Resolver's default key width at
    `depth` on `device`; returns the record, the launches, the
    device-served batches and the resolve batches."""
    from foundationdb_tpu_torch import workloads as wl
    from foundationdb_tpu_torch.client import transaction as txmod
    from foundationdb_tpu_torch.conflict import kernels as tk
    from foundationdb_tpu_torch.conflict.api import ConflictSet
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.server import cluster as cm

    smoke = _chip_smoke()
    cfg = smoke.ACCEPT_CONFIGS[config]
    sets = []

    def make_set():
        sets.append(ConflictSet(device=device, pipeline_depth=depth, **smoke.CLIENT_SET_KW))
        return sets[-1]

    for name in tk.LAUNCHES:
        tk.LAUNCHES[name] = 0
    try:
        with smoke.resolver_sets(cm, make_set):
            c = cm.SimCluster(seed=cfg["seed"], device=device, **cfg["cluster"])
        record = smoke.acceptance_record(c, wl, txmod, config)
    finally:
        el.set_event_loop(None)
    served = sum(s.device_metrics()["counters"]["batches"] for s in sets)
    batches = sum(r.metrics.counter("batches").value for r in c.resolvers)
    return record, dict(tk.LAUNCHES), served, batches


def test_write_during_read_on_the_card_matches_the_cpu(dev):
    """Config 2 (WriteDuringRead at high contention) at depth 2: every
    read, commit, conflict and retry, the workload's record and check and
    the final state equal on cuda and cpu, the memory model without a
    mismatch, and each kernel launched once in every resolve batch, the
    card serving every one."""
    cuda, launches, served, batches = _acceptance_record("cuda", 2)
    assert cuda == _acceptance_record("cpu", 2)[0]
    assert not cuda["workload"]["mismatches"] and cuda["workload"]["conflicts"] > 0
    assert served == batches > 0 and all(v == batches for v in launches.values())


def _spring_record(device):
    """chip_smoke's spring_record through the port's SimCluster(seed=75,
    buggify=False) whose resolver serves over a ConflictSet of the
    Resolver's key width at depth 2 on `device`, three dispatch faults from
    its 3rd batch; returns the record, the launches and the set's
    counters."""
    from foundationdb_tpu_torch.client import transaction as txmod
    from foundationdb_tpu_torch.conflict import kernels as tk
    from foundationdb_tpu_torch.conflict.api import ConflictSet
    from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.flow import flight_recorder as fr
    from foundationdb_tpu_torch.flow import spans, trace
    from foundationdb_tpu_torch.server import ratekeeper as rkmod
    from foundationdb_tpu_torch.server.cluster import SimCluster

    smoke = _chip_smoke()
    inj = DeviceFaultInjector()
    inj.script("dispatch", at=3, persist=3)
    cs = ConflictSet(device=device, pipeline_depth=2, fault_injector=inj, **smoke.CLIENT_SET_KW)
    for name in tk.LAUNCHES:
        tk.LAUNCHES[name] = 0
    # Fresh hubs: the ratekeeper's commit-latency spring reads the global
    # trace collector from its start.
    hubs = smoke.PortHubs(spans, trace, fr)
    try:
        c = SimCluster(seed=75, conflict_set=cs, buggify=False, device=device)
        record = smoke.spring_record(c, rkmod, txmod)
    finally:
        hubs.restore()
        el.set_event_loop(None)
    return record, dict(tk.LAUNCHES), cs.device_metrics()["counters"]


def test_ratekeeper_over_the_card_set_through_an_outage(dev):
    """The port's Ratekeeper over a cuda ConflictSet whose breaker opens on
    three dispatch faults: the rate falls to the degraded cap while it is
    open and returns once it closes, and the rate series, transitions and
    every commit equal the cpu run's; each kernel launched once in every
    batch the card served and never in one the mirror served."""
    smoke = _chip_smoke()
    cuda, launches, counters = _spring_record("cuda")
    assert cuda == _spring_record("cpu")[0]
    smoke.spring_checks("spring", cuda, smoke.SPRING_MAX_TPS, 0.25 * smoke.SPRING_MAX_TPS)
    assert counters["device_faults"] == 3 and counters["degraded_batches"] > 0
    assert all(v == counters["pipeline_dispatches"] > 0 for v in launches.values())


def _hot_shard_record(device):
    """chip_smoke's hot_shard_record through the port's SimCluster(seed=173,
    n_storages=2), every resolver over a ConflictSet of the Resolver's key
    width at depth 2 on `device`; returns the record, the launches and the
    sets' counters."""
    from foundationdb_tpu_torch.client import transaction as txmod
    from foundationdb_tpu_torch.conflict import kernels as tk
    from foundationdb_tpu_torch.conflict.api import ConflictSet
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.flow import flight_recorder as fr
    from foundationdb_tpu_torch.flow import spans, trace
    from foundationdb_tpu_torch.server import cluster as cm
    from foundationdb_tpu_torch.server import data_distribution as ddmod

    smoke = _chip_smoke()
    sets = []

    def make_set():
        sets.append(ConflictSet(device=device, pipeline_depth=2, **smoke.CLIENT_SET_KW))
        return sets[-1]

    for name in tk.LAUNCHES:
        tk.LAUNCHES[name] = 0
    hubs = smoke.PortHubs(spans, trace, fr)
    try:
        with smoke.resolver_sets(cm, make_set):
            c = cm.SimCluster(seed=173, n_storages=2, device=device)
        record = smoke.hot_shard_record(c, ddmod, txmod)
    finally:
        hubs.restore()
        el.set_event_loop(None)
    return record, dict(tk.LAUNCHES), [s.device_metrics()["counters"] for s in sets]


def test_dd_move_through_the_card_set_counts_its_side_table(dev):
    """DD splits and moves the hot shard, its metadata transactions
    committing through a cuda ConflictSet: DD's log, each storage's rows,
    every commit and the loop's end equal the cpu run's; the system keys
    went through the long-key side table (as many batches as on cpu, none
    host-served), and each kernel launched once in every resolve batch, the
    card serving every one."""
    cuda, launches, counters = _hot_shard_record("cuda")
    cpu, _l, cpu_counters = _hot_shard_record("cpu")
    assert cuda == cpu and cuda["ok"] and len(cuda["rows"]) == 240
    assert any(e[0] == "move" for e in cuda["moves"])
    side = [c.get("long_key_batches", 0) for c in counters]
    assert sum(side) > 0 and side == [c.get("long_key_batches", 0) for c in cpu_counters]
    assert not any(c.get("long_key_host_batches", 0) for c in counters)
    served = sum(c["batches"] for c in counters)
    assert served > 0 and all(v == served for v in launches.values())
