"""The slow soaks through the port, held to the reference's on the CPU
(slow-marked: tier-1 does not run them; ``pytest -m soak``).

Twins of tests/test_soak.py:336 (the acceptance soak: a DynamicCluster
under the full fault matrix), tests/test_reshard.py:369 (the hot-key
rebalance A/B and its same-seed replay) and tests/test_witness.py:705 (the
witness-guided against blind retry A/B).  Each runs the reference's soak
and the port's own (``SoakConfig.device`` "cpu") on the same config and
seed and holds the reports equal less tests/test_torch_soak_twins.py's
NAME_MAP and EXCLUDED, then asserts the reference test's claims on the
port's.  The
acceptance soak kills a process, and a killed role's unanswered Reply
draws from the loop's rng when it is collected (both packages): both runs
hold cyclic garbage collection to fixed points (chip_smoke's ``fixed_gc``,
a collection before the first event past each 4th virtual second), as
phase 4z does.
"""

from __future__ import annotations

import contextlib
import importlib.util
import pathlib

import pytest

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_soak_twins_slow", _here / "test_torch_soak_twins.py")
SOAK = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SOAK)
_restore_globals = SOAK._restore_globals
_one_thread = SOAK._one_thread
SMOKE = SOAK.DC.SMOKE
port_soak = SOAK.port_soak

pytestmark = [pytest.mark.slow, pytest.mark.soak]


@contextlib.contextmanager
def fixed_collections():
    """Cyclic garbage collected only at fixed virtual instants, in both
    packages' event loops."""
    from foundationdb_tpu.flow import eventloop as ref_el
    from foundationdb_tpu_torch.flow import eventloop as port_el

    undo = [SMOKE._collect_every(m.EventLoop, SMOKE.RECOVER_GC_EVERY) for m in (ref_el, port_el)]
    try:
        with SMOKE.fixed_gc():
            yield
    finally:
        for u in undo:
            u()


def test_soak_full_matrix_slow():
    """tests/test_soak.py:336 at the reference's FDB_TPU_SOAK_* defaults (1
    virtual minute): the SLO and every phase's floor, the three fault
    kinds, the ratekeeper limiting in every fault window and back to none,
    committed over a quarter of arrivals, and two same-seed port runs'
    transition logs byte-identical; the port's report equals the
    reference's."""
    from foundationdb_tpu.flow.knobs import g_env
    from foundationdb_tpu.workloads import soak as ref_soak
    from foundationdb_tpu_torch.tools.cli import SOAK_DEFAULTS

    def cfg(mod, backend, **extra):
        c = mod.default_config(
            minutes=float(g_env.get("FDB_TPU_SOAK_MINUTES")),
            peak_tps=float(g_env.get("FDB_TPU_SOAK_TPS")),
            seed=g_env.get_int("FDB_TPU_SOAK_SEED"), cluster="dynamic", backend=backend,
            keys=g_env.get_int("FDB_TPU_SOAK_KEYS"),
            zipf_theta=float(g_env.get("FDB_TPU_SOAK_THETA")), faults=True)
        c.slo_commit_p99, c.goodput_floor_frac = 5.0, 0.25
        for k, v in extra.items():
            setattr(c, k, v)
        return c

    with fixed_collections():
        want = ref_soak.run_soak(cfg(ref_soak, g_env.get("FDB_TPU_SOAK_BACKEND")))
        rep = port_soak.run_soak(cfg(port_soak, SOAK_DEFAULTS["backend"], device="cpu"))
        again = port_soak.run_soak(cfg(port_soak, SOAK_DEFAULTS["backend"], device="cpu"))
    SOAK.assert_reports_equal(rep, want)
    assert port_soak.transition_logs_json(rep) == port_soak.transition_logs_json(again)
    assert rep["slo"]["ok"] and all(ph["slo_ok"] for ph in rep["phases"]), rep["slo"]
    assert {f[1] for f in rep["faults"]} == {"kill", "clog", "device_outage"}
    admission = rep["ratekeeper"]["admission_log"]
    for t0, kind, _detail, t1 in rep["faults"]:
        assert SMOKE.limiting_within(admission, t0 - 0.1, t1 + 2.0), (kind, t0, t1)
    assert admission[-1][1] == "none"
    assert rep["totals"]["committed"] > 0.25 * rep["totals"]["arrivals"]


def test_hot_key_rebalance_ab():
    """tests/test_reshard.py:369: the balanced arm recovers at least twice
    the pinned arm's hot-range device goodput, both hold the SLO, the
    balancer moves, and two same-seed balanced soaks' transition logs are
    byte-identical; every arm's report equals the reference's."""
    from foundationdb_tpu.workloads import soak as ref_soak

    kw = dict(minutes=0.35, peak_tps=60.0, seed=3)
    want = ref_soak.run_hot_key_rebalance_ab(**kw)
    ab = port_soak.run_hot_key_rebalance_ab(device="cpu", **kw)
    for arm in ("balanced", "pinned"):
        SOAK.assert_reports_equal(ab["reports"][arm], want["reports"][arm])
    assert {k: v for k, v in ab.items() if k != "reports"} == \
        {k: v for k, v in want.items() if k != "reports"}
    assert ab["recovery_ratio"] >= 2.0 and ab["slo_ok"] and ab["balancer_moves"] >= 1, ab

    def run():
        c = port_soak.hot_key_rebalance_config(**kw)
        c.device = "cpu"
        return port_soak.run_soak(c)

    r1, r2 = run(), run()
    assert port_soak.transition_logs_json(r1) == port_soak.transition_logs_json(r2)
    assert r1["resharding"]["balancer"]["moves"] >= 1
    assert any(v["reshards"] >= 1 for v in r1["resharding"]["resolvers"].values())


def test_contention_ab_guided_beats_blind():
    """tests/test_witness.py:705: witness-guided retry beats blind retry on
    goodput under the high-contention Zipf load, with fewer conflict
    aborts; both arms' reports equal the reference's."""
    from foundationdb_tpu.workloads import soak as ref_soak

    kw = dict(minutes=0.1, peak_tps=100.0, seed=3)
    want = ref_soak.run_contention_ab(**kw)
    ab = port_soak.run_contention_ab(device="cpu", **kw)
    for arm in ("guided", "blind"):
        SOAK.assert_reports_equal(ab["reports"][arm], want["reports"][arm])
    g, b = ab["guided"], ab["blind"]
    assert (g, b) == (want["guided"], want["blind"])
    assert g["hint_retries"] > 0 and b["hint_retries"] == 0
    assert ab["goodput_ratio"] >= 1.0 and g["goodput_tps"] >= b["goodput_tps"]
    assert g["conflicted"] < b["conflicted"]
