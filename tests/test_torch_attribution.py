"""The flat step's ablation arms, phase attribution and the program registry,
against the reference package.

- the arms: the port's ``_blob_core(ablate=...)`` against the reference's
  ``_blob_core`` (kernels off, witness on) run eagerly under
  ``FDB_TPU_ABLATE``, for each token and for ``nokernel`` with each phase
  token (the reference with its kernels off runs its non-kernel step in
  every arm, so one reference run serves a token and its ``nokernel``
  twin), on two seeded states and batches: the new history (keys,
  versions, count, window), statuses, undecided, iters and the witness
  vectors, bit for bit;
- attribution: the port's ``attribute_phases(measure=True, repeats=1)``
  on a CPU engine — the report's keys are the reference's less its
  XLA-only fields, the phases in its order, times at least 0,
  ``kernel_ab.identical``, the engine's state unchanged, and the
  rejections (tiered, an engine built with ``ablate``);
- the registry: every reference entry point has a port entry with the
  same carried bytes and carried/pinned names, or is one of the
  reference's XLA-only programs; ``device_metrics()["programs"]``.

The reference runs eagerly (``jax.disable_jit``): its own attribution and
cost table compile one XLA program per arm and are not called here.  All
on the CPU at small sizes; the tolerance is zero (integers only).
"""

import ast
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from foundationdb_tpu.conflict import engine_jax as ej
from foundationdb_tpu.conflict import phase_attribution as ref_pa
from foundationdb_tpu_torch.conflict import engine_torch as et
from foundationdb_tpu_torch.conflict import phase_attribution as pa
from foundationdb_tpu_torch.conflict import programs
from foundationdb_tpu_torch.conflict.api import ConflictSet
from foundationdb_tpu_torch.conflict.engine_torch import TorchConflictSet
from foundationdb_tpu_torch.conflict.keys import from_device_words, to_device_words
from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as TT

BUCKETS = (32, 128, 64)
KEY_WORDS = 3
H_CAP = 1 << 10
ARMS = ["nosearch", "nofix", "nomerge", "noevict", "nokernel",
        "nokernel,nosearch", "nokernel,nofix", "nokernel,nomerge", "nokernel,noevict"]


def k(i: int) -> bytes:
    return b"%08d" % i


def _stream(seed, batches, n_txn=24, keyspace=60, lag=20):
    """Random batches whose reads lag their writes, so that each batch has
    history conflicts, intra-batch rounds and rows to evict."""
    r = np.random.default_rng(seed)
    v, out = 10, []
    for _ in range(batches):
        txns = []
        for _ in range(n_txn):
            tr = TT(max(0, v - int(r.integers(0, lag))), [], [])
            for _ in range(int(r.integers(1, 3))):
                a = int(r.integers(0, keyspace))
                tr.read_ranges.append((k(a), k(a + 1 + int(r.integers(0, 6)))))
            for _ in range(int(r.integers(0, 3))):
                a = int(r.integers(0, keyspace))
                tr.write_ranges.append((k(a), k(a + 1 + int(r.integers(0, 4)))))
            txns.append(tr)
        now = v + int(r.integers(2, 8))
        out.append((txns, now, max(0, now - lag)))
        v = now
    return out


@pytest.fixture(scope="module")
def cases():
    """(state, blob, caps) for two seeded engine states, each with the
    batch that follows, whose window jumps."""
    out = []
    for seed in (1, 4):
        stream = _stream(seed, 6)
        tcs = TorchConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, bucket_mins=BUCKETS,
                               device="cpu")
        for txns, now, nov in stream[:-1]:
            tcs.detect(txns, now, nov)
        txns, now, _nov = stream[-1]
        nov = now - 8  # a jump of the window: this batch evicts rows
        pb = tcs._pack(txns)
        blob = np.empty((et.blob_words(pb),), np.uint32)
        et.fill_blob(blob, pb, tcs._base, now, nov, 1)
        hk, hv, hc, ho, _base = tcs.export_state()
        caps = dict(txn_cap=pb.txn_cap, rr_cap=pb.rr_cap, wr_cap=pb.wr_cap, h_cap=H_CAP,
                    kw1=KEY_WORDS + 1)
        out.append(((hk, hv, hc, ho), blob, caps))
    return out


def _port_arm(state, blob, caps, ablate):
    hk, hv, hc, ho = state
    got = et._blob_core(
        torch.from_numpy(to_device_words(hk).copy()), torch.from_numpy(hv.copy()),
        torch.tensor(hc, dtype=torch.int32), torch.tensor(ho, dtype=torch.int32),
        torch.from_numpy(blob.view(np.int32).copy()), ablate=ablate, **caps)
    got = [g.numpy() for g in got]
    got[0] = from_device_words(got[0])
    return got


@pytest.fixture(scope="module")
def ref_arms():
    """The reference's outputs by (case, token), computed once.  With its
    kernels off the reference runs its non-kernel step in every arm, so
    ``nokernel`` with a phase token gives that token's outputs."""
    memo = {}

    def get(i, case, token):
        key = (i, token)
        if key not in memo:
            (hk, hv, hc, ho), blob, caps = case
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("FDB_TPU_ABLATE", token)
                with jax.disable_jit():
                    want = ej._blob_core(jnp.asarray(hk), jnp.asarray(hv), jnp.int32(hc),
                                         jnp.int32(ho), jnp.asarray(blob), kernels=False,
                                         witness=True, **caps)
            memo[key] = [np.asarray(w) for w in want]
        return memo[key]

    return get


NAMES = ("keys", "vers", "count", "oldest", "status", "undecided", "iters", "w_ver", "w_rng")


@pytest.mark.parametrize("token", ARMS)
def test_ablation_arm_matches_reference(cases, ref_arms, token):
    ablate = frozenset(token.split(","))
    ref_token = ",".join(sorted(ablate - {"nokernel"}))
    for i, case in enumerate(cases):
        state, blob, caps = case
        got = _port_arm(state, blob, caps, ablate)
        want = ref_arms(i, case, ref_token)
        for name, g, w in zip(NAMES, got, want):
            assert g.shape == w.shape and (g == w).all(), (token, name)


def test_arms_do_work(cases):
    """The inputs exercise what each seam cuts: full differs from every
    phase arm, and the nokernel twins equal their kernel arms."""
    for state, blob, caps in cases:
        full = _port_arm(state, blob, caps, frozenset())
        assert int(full[6]) > 2 and (full[4] == 0).any()  # rounds, conflicts
        for token in ("nosearch", "nofix", "nomerge", "noevict"):
            arm = _port_arm(state, blob, caps, frozenset({token}))
            assert any(not np.array_equal(a, b) for a, b in zip(full, arm)), token
            twin = _port_arm(state, blob, caps, frozenset({token, "nokernel"}))
            assert all(np.array_equal(a, b) for a, b in zip(arm, twin)), token


# ---------------------------------------------------------------------------
# attribute_phases
# ---------------------------------------------------------------------------


def _reference_report_keys():
    """The top-level keys the reference's attribute_phases can write."""
    tree = ast.parse(inspect.getsource(ref_pa.attribute_phases))
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.AnnAssign) and getattr(node.target, "id", "") == "report"
                and isinstance(node.value, ast.Dict)):
            keys |= {kk.value for kk in node.value.keys}
        if (isinstance(node, ast.Subscript) and getattr(node.value, "id", "") == "report"
                and isinstance(node.slice, ast.Constant) and isinstance(node.ctx, ast.Store)):
            keys.add(node.slice.value)
    return keys


# The reference's fields from XLA's cost analysis, which the port has not.
XLA_ONLY = {"residual_flops", "cost_table"}


def _engine(**kw):
    tcs = TorchConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, bucket_mins=BUCKETS,
                           device="cpu", **kw)
    for txns, now, nov in _stream(5, 4):
        tcs.detect(txns, now, nov)
    return tcs


def test_attribute_phases_report_on_cpu():
    tcs = _engine()
    before = tcs.export_state()
    syncs = tcs.host_syncs
    txns = _stream(5, 5)[-1][0]
    rep = pa.attribute_phases(tcs, txns, measure=True, repeats=1)
    after = tcs.export_state()
    assert all(np.array_equal(a, b) for a, b in zip(before, after))
    assert tcs.batches == 4 and tcs.host_syncs - syncs == 2  # oldest_version, the export

    assert set(rep) == _reference_report_keys() - XLA_ONLY
    assert [p["phase"] for p in rep["phases"]] == [ph for ph, _t in ref_pa.PHASE_ABLATIONS]
    assert pa.PHASE_ABLATIONS == ref_pa.PHASE_ABLATIONS and pa.NOKERNEL == ref_pa.NOKERNEL
    assert [p["ablate"] for p in rep["phases"]] == [[t] for _ph, t in ref_pa.PHASE_ABLATIONS]
    kab = rep["kernel_ab"]
    assert kab["identical"] and kab["plain_full"]["digest"] == rep["full"]["digest"]
    # The window stays (now = oldest + 8, evicting below oldest), so only
    # the evict arm may equal the full one.
    assert all(p["digest"] != rep["full"]["digest"] for p in rep["phases"][:3])
    # On the CPU the wrappers take their plain twins: no launches anywhere.
    assert all(v == 0 for v in rep["full"]["launches"].values())
    assert rep["full"]["host_checks"] >= 1
    assert rep["phases"][1]["host_checks"] == 0  # nofix: no fixpoint checks
    m = rep["measured"]
    assert m["repeats"] == 1 and m["full_wall_seconds"] > 0
    assert list(m["phase_wall_seconds"]) == [ph for ph, _t in pa.PHASE_ABLATIONS]
    assert all(v >= 0 for v in m["phase_wall_seconds"].values())
    assert set(kab["measured_phase_wall_seconds"]) == set(m["phase_wall_seconds"])
    assert "full_device_ms" not in m  # a CPU engine has no device clock
    # The deterministic block repeats exactly.
    rep2 = pa.attribute_phases(tcs, txns)
    assert {k: rep[k] for k in ("shapes", "full", "phases")} == {
        k: rep2[k] for k in ("shapes", "full", "phases")}
    assert "measured" not in rep2


def test_attribute_phases_default_batch_and_rejections():
    rep = pa.attribute_phases(TorchConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, device="cpu"))
    assert rep["kernel_ab"]["identical"] and rep["shapes"]["txn_cap"] == 32
    ref_txns = ref_pa._synthetic_txns()
    assert [(t.read_snapshot, t.read_ranges, t.write_ranges) for t in pa._synthetic_txns()] == [
        (t.read_snapshot, t.read_ranges, t.write_ranges) for t in ref_txns]
    tiered = TorchConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, device="cpu", history="tiered")
    with pytest.raises(ValueError, match="flat"):
        pa.attribute_phases(tiered)
    with pytest.raises(ValueError, match="ablate"):
        pa.attribute_phases(TorchConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, device="cpu",
                                             ablate={"nofix"}))
    with pytest.raises(ValueError, match="tiered"):
        TorchConflictSet(device="cpu", history="tiered", ablate={"nokernel"})
    with pytest.raises(ValueError, match="unknown ablation"):
        TorchConflictSet(device="cpu", ablate={"nomerge", "nothing"})


def test_engine_nokernel_stream_equals_the_kernel_engine():
    """An engine built with ablate={"nokernel"} serves a stream bit for bit
    as the default one does (the reference's kernel A/B arm)."""
    a, b = _engine(), _engine(ablate={"nokernel"})
    for txns, now, nov in _stream(6, 3):
        assert a.detect(txns, now, nov) == b.detect(txns, now, nov)
        assert a.last_witness == b.last_witness and a.last_iters == b.last_iters
        assert all(np.array_equal(x, y) for x, y in zip(a.export_state(), b.export_state()))


# ---------------------------------------------------------------------------
# the program registry
# ---------------------------------------------------------------------------

# The reference's XLA programs without a port program: its non-kernel
# tiered and sharded steps.
NO_PORT_PROGRAM = {"tiered_step", "sharded_step"}


def test_registry_matches_the_reference():
    import foundationdb_tpu.parallel.sharded_resolver  # noqa: F401  registers the sharded steps
    import foundationdb_tpu_torch.parallel  # noqa: F401

    ref = ej.DEVICE_ENTRY_POINTS
    port = et.DEVICE_ENTRY_POINTS
    assert port is programs.DEVICE_ENTRY_POINTS
    assert set(port) == set(ref) - NO_PORT_PROGRAM
    assert (programs.EP_TXN, programs.EP_RR, programs.EP_WR, programs.EP_H, programs.EP_D,
            programs.EP_KW1) == (ej.EP_TXN, ej.EP_RR, ej.EP_WR, ej.EP_H, ej.EP_D, ej.EP_KW1)
    for name, ep in port.items():
        r = ref[name]
        assert (ep.arg_names, ep.carried, ep.pinned) == (r.arg_names, r.carried, r.pinned), name
        assert ep.carried_bytes() == r.carried_bytes(), name


def test_program_costs_in_device_metrics(monkeypatch):
    monkeypatch.setattr(programs, "_PROGRAM_COSTS", {})
    monkeypatch.setattr(programs, "_PROGRAM_RUN_WALL", {})
    assert programs.cached_program_costs() is None
    cs = ConflictSet(key_words=KEY_WORDS, device="cpu")
    assert "programs" not in cs.device_metrics()
    table = programs.program_cost_table(device="cpu")
    assert set(table) == set(programs.DEVICE_ENTRY_POINTS)
    assert cs.device_metrics()["programs"] == table == programs.cached_program_costs("cpu")
    for name, blk in table.items():
        assert "error" not in blk, blk
        ep = programs.DEVICE_ENTRY_POINTS[name]
        assert blk["carried_bytes"] == ep.carried_bytes()
        assert blk["memory"]["argument"] == blk["argument_bytes_total"] > 0
        assert "temp" not in blk["memory"]  # measured on CUDA only
        assert not any("wall" in key for key in blk)
    assert table["flat_step_kernels"].get("kernel") and "kernel" not in table["flat_step"]
    walled = programs.program_cost_table(device="cpu", include_wall=True)
    assert walled["_run_wall"]["count"] >= len(table)
    assert all(walled[n]["run_wall_seconds"] > 0 for n in table)
    eager = ConflictSet(key_words=KEY_WORDS, device="cpu", program_costs=True)
    assert eager.device_metrics()["programs"] == table
