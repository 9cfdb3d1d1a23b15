"""The port's flat conflict step and engine against the reference package.

- the step: the port's detect_core against the JAX detect_core, with the
  Pallas kernels on (interpret mode) and off, every output compared —
  verdicts, iters, undecided count, the new history state and the witness
  vectors;
- the engine: TorchConflictSet(device="cpu") against JaxConflictSet and the
  brute-force oracle over random streams — verdicts, last_witness,
  last_iters and the exported state after every batch — including residual
  overflow (the divergence path), a long fixpoint, growth, rebase, the
  pipelined ticket API, and a state carried across from a JaxConflictSet;
- hygiene: the port imports neither jax nor the reference package, and its
  entry points default to the GPU.

All on the CPU at small sizes; the tolerance is zero (integers only).
"""

import ast
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from foundationdb_tpu.conflict import engine_jax as ej
from foundationdb_tpu.conflict.engine_jax import JaxConflictSet
from foundationdb_tpu.conflict.oracle import OracleConflictSet
from foundationdb_tpu.conflict.types import TransactionConflictInfo as JT
from foundationdb_tpu_torch.conflict import engine_torch as et
from foundationdb_tpu_torch.conflict.engine_torch import TorchConflictSet
from foundationdb_tpu_torch.conflict.keys import from_device_words, to_device_words
from foundationdb_tpu_torch.conflict.state import state_from_jax
from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as TT

REPO = Path(__file__).resolve().parent.parent
BUCKETS = (32, 128, 64)


def k(i: int) -> bytes:
    return b"%08d" % i


def _random_stream(seed, keyspace, batches, txns_per_batch, snap_lag=25):
    r = np.random.default_rng(seed)
    version = 10
    out = []
    for _ in range(batches):
        txns = []
        for _ in range(int(r.integers(1, txns_per_batch + 1))):
            tr = JT(read_snapshot=max(0, version - int(r.integers(0, snap_lag))))
            for _ in range(int(r.integers(0, 4))):
                a = int(r.integers(0, keyspace))
                b = a + 1 + int(r.integers(0, max(1, keyspace // 8)))
                tr.read_ranges.append((k(a), k(b)))
            for _ in range(int(r.integers(0, 3))):
                a = int(r.integers(0, keyspace))
                b = a + 1 + int(r.integers(0, max(1, keyspace // 10)))
                tr.write_ranges.append((k(a), k(b)))
            txns.append(tr)
        now = version + int(r.integers(1, 10))
        out.append((txns, now, max(0, version - snap_lag)))
        version = now
    return out


def _chain(n, snapshot=0):
    """Txn t reads key t and writes key t+1: every txn's fate hangs on its
    predecessor's, so the intra-batch fixpoint decides about one txn per
    round and every txn past the first two is residual."""
    return [
        JT(read_snapshot=snapshot,
           read_ranges=[(k(t), k(t) + b"\x00")],
           write_ranges=[(k(t + 1), k(t + 1) + b"\x00")])
        for t in range(n)
    ]


def _port_txns(txns):
    return [TT(t.read_snapshot, list(t.read_ranges), list(t.write_ranges)) for t in txns]


def _jax_state(cs):
    return (np.asarray(cs._hkeys), np.asarray(cs._hvers), int(cs._hcount),
            int(cs._oldest), cs._base)


def _assert_same_state(jcs, tcs):
    jk, jv, jn, jo, jb = _jax_state(jcs)
    tk_, tv, tn, to, tb = tcs.export_state()
    assert tk_.shape == jk.shape and (tk_ == jk).all()
    assert (tv == jv).all()
    assert (tn, to, tb) == (jn, jo, jb)


def _run_both(stream, jcs, tcs, oracle=None):
    for txns, now, nov in stream:
        want = jcs.detect(txns, now, nov)
        got = tcs.detect(_port_txns(txns), now, nov)
        assert got == want
        assert tcs.last_witness == jcs.last_witness
        assert tcs.last_iters == jcs.last_iters
        if oracle is not None:
            assert oracle.detect(txns, now, nov) == want
            assert oracle.last_witness == jcs.last_witness
        _assert_same_state(jcs, tcs)


# ---------------------------------------------------------------------------
# the step: detect_core against detect_core
# ---------------------------------------------------------------------------


def _step_args(jcs, pb, now, nov):
    """The reference step's inputs, in numpy, from its own blob."""
    kw1 = pb.key_words + 1
    blob = np.array(jcs._pack_blob(pb, now, nov))
    offs, _ = ej._blob_offsets(pb.txn_cap, pb.rr_cap, pb.wr_cap, kw1)
    f = lambda i, n: blob[offs[i] : offs[i] + n]
    keys = lambda i, cap: f(i, cap * kw1).reshape(kw1, cap)
    i32 = lambda a: a.view(np.int32)
    flags = f(8, pb.txn_cap)
    sc = i32(f(9, 3))
    hk, hv, hn, ho, _ = _jax_state(jcs)
    return dict(
        hkeys=hk, hvers=hv, hcount=np.int32(hn), oldest=np.int32(ho),
        r_begin=keys(0, pb.rr_cap), r_end=keys(1, pb.rr_cap),
        r_txn=i32(f(4, pb.rr_cap)), r_snap=i32(f(5, pb.rr_cap)),
        w_begin=keys(2, pb.wr_cap), w_end=keys(3, pb.wr_cap),
        w_txn=i32(f(6, pb.wr_cap)), t_snap=i32(f(7, pb.txn_cap)),
        t_has_reads=(flags & 1) > 0, t_valid=(flags & 2) > 0,
        now_rel=sc[0], new_oldest_rel=sc[1],
    )


KEY_ARGS = ("hkeys", "r_begin", "r_end", "w_begin", "w_end")


def _to_torch(args):
    out = {}
    for name, a in args.items():
        a = np.asarray(a)
        if name in KEY_ARGS:
            a = to_device_words(a)
        out[name] = torch.from_numpy(np.array(a))
    return out


@pytest.fixture(scope="module")
def jax_steps():
    """The reference detect_core jitted per arm (kernels on in interpret
    mode / kernels off), compiled once for the module's shapes."""
    cache = {}

    def get(kernels, caps):
        key = (kernels, caps)
        if key not in cache:
            txn, rr, wr, h = caps
            cache[key] = jax.jit(partial(
                ej.detect_core, txn_cap=txn, rr_cap=rr, wr_cap=wr, h_cap=h,
                kernels=kernels, kernel_interpret=kernels, witness=True,
            ))
        return cache[key]

    return get


NAMES = ("keys", "vers", "count", "oldest", "status", "undecided", "iters",
         "w_ver", "w_rng")


def _compare_step(jax_steps, jcs, txns, now, nov):
    pb = ej.PackedBatch.from_transactions(
        txns, jcs.key_words, min_txn=BUCKETS[0], min_rr=BUCKETS[1], min_wr=BUCKETS[2])
    args = _step_args(jcs, pb, now, nov)
    caps = (pb.txn_cap, pb.rr_cap, pb.wr_cap, jcs.h_cap)
    targs = _to_torch(args)
    got = et.detect_core(*targs.values(), txn_cap=caps[0], rr_cap=caps[1],
                         wr_cap=caps[2], h_cap=caps[3])
    got = [g.numpy() for g in got]
    got[0] = from_device_words(got[0])
    for kernels in (True, False):
        want = jax_steps(kernels, caps)(*(jnp.asarray(a) for a in args.values()))
        for name, g, w in zip(NAMES, got, want):
            w = np.asarray(w)
            assert g.shape == w.shape, (name, kernels)
            assert (g == w).all(), (name, kernels)
    return got


@pytest.mark.parametrize("seed", [11, 23])
def test_detect_core_matches_reference_both_arms(jax_steps, seed):
    stream = _random_stream(seed, 50, batches=8, txns_per_batch=25)
    jcs = JaxConflictSet(key_words=3, h_cap=512, bucket_mins=BUCKETS)
    for txns, now, nov in stream:
        _compare_step(jax_steps, jcs, txns, now, nov)
        jcs.detect(txns, now, nov)


def test_detect_core_residual_overflow_keeps_state(jax_steps):
    """More residual txns than the compact domain holds: undecided > 0 and
    the history comes back unchanged, in both packages."""
    jcs = JaxConflictSet(key_words=3, h_cap=512, bucket_mins=BUCKETS)
    jcs.detect(_random_stream(3, 50, 1, 20)[0][0], 40, 0)
    got = _compare_step(jax_steps, jcs, _chain(70, snapshot=40), 60, 10)
    assert int(got[5]) > 0
    hk, hv, hn, ho, _ = _jax_state(jcs)
    assert (got[0] == hk).all() and (got[1] == hv).all() and int(got[2]) == hn


# ---------------------------------------------------------------------------
# the engine: TorchConflictSet against JaxConflictSet and the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [5, 17, 29])
def test_engine_stream_matches_reference_and_oracle(seed):
    stream = _random_stream(seed, 60, batches=14, txns_per_batch=30)
    jcs = JaxConflictSet(key_words=3, h_cap=256, bucket_mins=BUCKETS)
    tcs = TorchConflictSet(key_words=3, h_cap=256, bucket_mins=BUCKETS, device="cpu")
    _run_both(stream, jcs, tcs, OracleConflictSet())
    assert tcs.batches == len(stream)
    assert tcs.cpu_fallbacks == 0
    assert tcs.fixpoint_rounds >= 2 * len(stream)


def test_engine_matches_reference_with_pallas_kernels(monkeypatch):
    """Against the reference engine running its Pallas kernels (interpret
    mode), the arm the port's kernels replace."""
    monkeypatch.setenv("FDB_TPU_KERNELS", "1")
    stream = _random_stream(41, 50, batches=8, txns_per_batch=20)
    jcs = JaxConflictSet(key_words=3, h_cap=256, bucket_mins=BUCKETS)
    assert jcs._use_kernels
    tcs = TorchConflictSet(key_words=3, h_cap=256, bucket_mins=BUCKETS, device="cpu")
    _run_both(stream, jcs, tcs)


def test_divergence_takes_the_cpu_fallback():
    """Residual overflow mid-stream: the device state stays unchanged, the
    batch is re-decided on the flat CPU engine (the reference uses its
    state-identical chunked mirror), and both engines continue alike."""
    stream = _random_stream(7, 50, batches=6, txns_per_batch=20)
    last = stream[-1][1]
    stream.insert(3, (_chain(70, snapshot=stream[2][1]), stream[2][1] + 1, 0))
    for i in range(4, len(stream)):
        txns, now, nov = stream[i]
        stream[i] = (txns, now + 1, nov)
    assert stream[-1][1] == last + 1
    jcs = JaxConflictSet(key_words=3, h_cap=256, bucket_mins=BUCKETS)
    tcs = TorchConflictSet(key_words=3, h_cap=256, bucket_mins=BUCKETS, device="cpu")
    _run_both(stream, jcs, tcs, OracleConflictSet())
    assert tcs.cpu_fallbacks == 1
    assert jcs.metrics.snapshot()["counters"]["cpu_fallbacks"] == 1


def test_long_fixpoint_counts_iterations_exactly(monkeypatch):
    """A 40-txn dependency chain needs ~40 fixpoint rounds — many chunks
    of masked rounds — and iters must equal the reference's count, for
    every first-chunk length; so must chains whose rounds end just before,
    at and just after the first check, which cost one check."""
    for first in (1, 2, et.FIXPOINT_CHUNK, et.FIXPOINT_FIRST_CHUNK):
        monkeypatch.setattr(et, "FIXPOINT_FIRST_CHUNK", first)
        jcs = JaxConflictSet(key_words=3, h_cap=256, bucket_mins=BUCKETS)
        tcs = TorchConflictSet(key_words=3, h_cap=256, bucket_mins=BUCKETS, device="cpu")
        _run_both([(_chain(40), 5, 0), (_chain(33, snapshot=5), 9, 2)], jcs, tcs,
                  OracleConflictSet())
        assert tcs.last_iters > 2 * et.FIXPOINT_CHUNK
        assert tcs.cpu_fallbacks == 0
        v = 9
        for n in (1, 2, 3, 4, 5, 6, 7):
            syncs = tcs.host_syncs
            v += 4
            _run_both([(_chain(n, snapshot=v - 1), v, v - 3)], jcs, tcs)
            rounds = tcs.last_iters - 2
            checks = 1 + max(0, -(-(rounds - first) // et.FIXPOINT_CHUNK))
            # the fixpoint's checks, the readback, the export's read
            assert tcs.host_syncs - syncs == checks + 2, (first, n, rounds)


def test_growth_and_rebase_match_reference():
    stream = _random_stream(13, 400, batches=10, txns_per_batch=30)
    big = 2**29
    # Jump the versions past the rebase threshold twice.
    for i in range(5, 10):
        txns, now, nov = stream[i]
        for t in txns:
            t.read_snapshot += big + 10 * i
        stream[i] = (txns, now + big + 10 * i, nov + big + 10 * i - 40)
    jcs = JaxConflictSet(key_words=3, h_cap=64, bucket_mins=BUCKETS)
    tcs = TorchConflictSet(key_words=3, h_cap=64, bucket_mins=BUCKETS, device="cpu")
    _run_both(stream, jcs, tcs, OracleConflictSet())
    counters = jcs.metrics.snapshot()["counters"]
    assert tcs.grows == counters["grows"] >= 1
    assert tcs.rebases == counters["rebases"] >= 1
    assert tcs.h_cap == jcs.h_cap


def test_state_carried_over_from_reference():
    stream = _random_stream(19, 60, batches=12, txns_per_batch=30)
    jcs = JaxConflictSet(key_words=3, h_cap=256, bucket_mins=BUCKETS)
    for txns, now, nov in stream[:6]:
        jcs.detect(txns, now, nov)
    tcs = TorchConflictSet(key_words=3, h_cap=1 << 10, bucket_mins=BUCKETS, device="cpu")
    tcs.load_state(state_from_jax(*_jax_state(jcs), device="cpu"))
    _assert_same_state(jcs, tcs)
    _run_both(stream[6:], jcs, tcs, None)


def test_ticket_api_matches_detect():
    stream = _random_stream(23, 60, batches=8, txns_per_batch=30)
    a = TorchConflictSet(key_words=3, h_cap=256, bucket_mins=BUCKETS, device="cpu")
    b = TorchConflictSet(key_words=3, h_cap=256, bucket_mins=BUCKETS, device="cpu")
    tickets = [b.dispatch_txns(_port_txns(t), now, nov) for t, now, nov in stream]
    for (txns, now, nov), ticket in zip(stream, tickets):
        want = a.detect(_port_txns(txns), now, nov)
        statuses, diverged = b.sync_ticket(ticket)
        assert not diverged
        assert list(statuses[: len(txns)]) == want
        assert b.last_witness == a.last_witness
    assert all(x == y if not isinstance(x, np.ndarray) else (x == y).all()
               for x, y in zip(a.export_state(), b.export_state()))
    b2 = TorchConflictSet(key_words=3, h_cap=256, bucket_mins=BUCKETS, device="cpu")
    ticket = b2.dispatch_txns(_port_txns(_chain(70)), 5, 0)
    assert b2.sync_ticket(ticket) == (None, True)
    assert b2.cpu_fallbacks == 1


def test_merge_inputs_hold_the_position_order(monkeypatch):
    """The merge kernel gathers each merged tile from a contiguous run of
    each stream's kept rows.  That holds only if, in each stream the engine
    hands to fused_merge_evict, the kept rows' positions strictly increase
    with the row index, and the two streams' kept positions together
    partition [0, merged_count).  Checked on every merge of a few seeded
    streams, with growth and eviction."""
    seen = []
    merge = et.fused_merge_evict

    def recording(*args, **kwargs):
        seen.append([args[i].numpy().copy() for i in (2, 3, 6, 7, 8)])
        return merge(*args, **kwargs)

    monkeypatch.setattr(et, "fused_merge_evict", recording)
    batches = 0
    for seed, h_cap in ((3, 64), (37, 256), (53, 256)):
        stream = _random_stream(seed, 60, batches=10, txns_per_batch=30)
        tcs = TorchConflictSet(key_words=3, h_cap=h_cap, bucket_mins=BUCKETS, device="cpu")
        for txns, now, nov in stream:
            tcs.detect(_port_txns(txns), now, nov)
        batches += len(stream)
    assert len(seen) >= batches
    for a_keep, a_pos, b_keep, b_pos, merged_count in seen:
        pa, pb = a_pos[a_keep != 0], b_pos[b_keep != 0]
        assert (np.diff(pa) > 0).all() and (np.diff(pb) > 0).all()
        both = np.sort(np.concatenate([pa, pb]))
        assert np.array_equal(both, np.arange(int(merged_count)))


def test_blob_is_byte_identical_to_reference():
    txns, now, nov = _random_stream(31, 60, 1, 30)[0]
    jcs = JaxConflictSet(key_words=3, h_cap=256, bucket_mins=BUCKETS, oldest_version=3)
    tcs = TorchConflictSet(key_words=3, h_cap=256, bucket_mins=BUCKETS,
                           oldest_version=3, device="cpu")
    jpb = ej.PackedBatch.from_transactions(txns, 3, *BUCKETS)
    tpb = et.PackedBatch.from_transactions(_port_txns(txns), 3, *BUCKETS)
    assert (jcs._pack_blob(jpb, now, nov) == tcs._pack_blob(tpb, now, nov)).all()


def test_bench_shaped_stream_matches_reference():
    """key_words=2, 4-byte int keys uniform in a keyspace, 1 read + 1 write
    range per txn, detect at now=i+W evicting below i — the bench's
    stream at a small size, through detect_packed."""
    r = np.random.default_rng(2)
    W, n = 4, 300

    def batch(mod, i):
        cap = et._next_pow2(n, 8)
        pb = mod.PackedBatch(cap, cap, cap, 2)
        for begin, end, txn in ((pb.r_begin, pb.r_end, pb.r_txn),
                                (pb.w_begin, pb.w_end, pb.w_txn)):
            a = rng.integers(0, 5000, n)
            b = a + 1 + rng.integers(0, 10, n)
            begin[:n] = et.keylib.encode_int_keys(a, 2, 4)
            end[:n] = et.keylib.encode_int_keys(b, 2, 4)
            txn[:n] = np.arange(n, dtype=np.int32)
        pb.r_snap[:n] = i
        pb.t_snap[:n] = i
        pb.t_has_reads[:n] = True
        pb.t_valid[:n] = True
        pb.n_txn = pb.n_r = pb.n_w = n
        return pb

    jcs = JaxConflictSet(key_words=2, h_cap=1 << 11)
    tcs = TorchConflictSet(key_words=2, h_cap=1 << 11, device="cpu")
    for i in range(10):
        seed = int(r.integers(0, 2**31))
        rng = np.random.default_rng(seed)
        jpb = batch(ej, i)
        rng = np.random.default_rng(seed)
        tpb = batch(et, i)
        want = np.asarray(jcs.detect_packed(jpb, now=i + W, new_oldest_version=i))
        got = tcs.detect_packed(tpb, now=i + W, new_oldest_version=i)
        assert (got == want).all()
        assert tcs.last_witness == jcs.last_witness
        _assert_same_state(jcs, tcs)
    assert (want[:n] == 0).any() and (want[:n] == 2).any()


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------


def _port_sources():
    return sorted((REPO / "foundationdb_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _source_id(path) -> str:
    """The file's name; a lint module named like a runtime module (the
    two hotpath.py) is told apart by its folder, so that every other id
    keeps its name (the __init__.py keep pytest's numbering)."""
    names = [p.name for p in _port_sources()]
    if path.parent.name == "lint" and path.name != "__init__.py" and names.count(path.name) > 1:
        return f"lint/{path.name}"
    return path.name


@pytest.mark.parametrize("path", _port_sources(), ids=_source_id)
def test_port_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "foundationdb_tpu"), (path, name)


def test_port_runs_without_loading_jax_or_the_reference():
    code = (
        "import sys\n"
        "from foundationdb_tpu_torch import TorchConflictSet\n"
        "from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as T\n"
        "cs = TorchConflictSet(key_words=2, h_cap=64, device='cpu')\n"
        "v = cs.detect([T(0, [(b'a', b'b')], [(b'a', b'c')]),\n"
        "               T(0, [(b'b', b'c')], [])], 5, 0)\n"
        "assert v == [2, 0], v\n"
        "from foundationdb_tpu_torch import ConflictSet\n"
        "from foundationdb_tpu_torch.conflict.device_faults import DeviceFaultInjector\n"
        "inj = DeviceFaultInjector()\n"
        "inj.script('dispatch', at=2)\n"
        "cs = ConflictSet(key_words=2, h_cap=64, device='cpu', fault_injector=inj)\n"
        "e = [cs.pipeline_submit([T(0, [(b'a', b'b')], [(b'a', b'c')]),\n"
        "                         T(0, [(b'b', b'c')], [])], 5 + i, 0)\n"
        "     for i in range(3)]\n"
        "cs.pipeline_drain()\n"
        "assert [x.statuses for x in e] == [[2, 0], [0, 0], [0, 0]], e\n"
        "assert cs.mirror_check()['status'] == 'ok'\n"
        "assert inj.injected == [[3, 'dispatch', 'transient']]\n"
        "from foundationdb_tpu_torch.parallel import ShardedTorchConflictSet\n"
        "inj = DeviceFaultInjector()\n"
        "inj.script('dispatch', at=1, shard=1)\n"
        "sh = ShardedTorchConflictSet([b'b'], key_words=2, h_cap=64, device='cpu',\n"
        "                             fault_injector=inj, max_shards=3)\n"
        "v = sh.detect([T(0, [(b'a', b'c')], [(b'a', b'c')]),\n"
        "               T(0, [(b'b', b'c')], [])], 5, 0)\n"
        "assert v == [2, 0] and inj.injected == [[2, 'dispatch#s1', 'transient']], v\n"
        "assert sh.mirror_check()['status'] == 'ok'\n"
        "e = sh.reshard([b'a', b'bb'], reason='t')\n"
        "assert e['action'] == 'live' and sh.n_shards == 3, e\n"
        "v = sh.detect([T(4, [(b'a', b'c')], []), T(6, [(b'a', b'c')], [])], 7, 0)\n"
        "assert v == [0, 2] and sh.mirror_check()['status'] == 'ok', v\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'foundationdb_tpu')]\n"
        "print(sorted(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_default_device_is_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchConflictSet()
    with pytest.raises(RuntimeError):
        state_from_jax(np.zeros((3, 8), np.uint32), np.zeros(8, np.int32), 1, 0, 0)
    cs = TorchConflictSet(key_words=2, h_cap=64, device="cpu")
    assert cs.device.type == "cpu"
