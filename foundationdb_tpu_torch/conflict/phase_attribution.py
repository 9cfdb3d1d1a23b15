"""In-step phase attribution of the flat conflict step.

Port of the reference package's ``conflict/phase_attribution.py``.  A
phase is priced by subtractive ablation INSIDE the step: the full step
and each twin with one phase cut out (engine_torch's ablation seams, the
``ablate`` argument) run on the engine's own carried state and one batch,
and a phase costs full minus ablated.  A phase benched alone would price
work the step never does (a phase's inputs materialized for it, a cache
the step keeps warm), so there is no standalone microbench here:

    phase      ablation   what the ablated step skips
    search     nosearch   phase 1's history search (the search kernel)
    fixpoint   nofix      phase 3's fixpoint rounds and their host checks
    merge      nomerge    phases 5-6 entirely (and phase 4's segments)
    evict      noevict    phase 6's eviction
    (kernels)  nokernel   the hand-written kernels: the same arms run the
                          plain non-kernel step, so each phase is priced
                          with and without the kernels (``kernel_ab``)

The arms are ``full``, each phase, and ``plain_full`` with ``plain_<phase>``
(the reference's ``xla_*``): the same arms with ``nokernel``.  Every arm
runs ``engine_torch._blob_core`` on the engine's tensors and never assigns
its results back, so the engine's state is untouched.  The reference sets
and restores its environment flag around a fresh jit per arm; here
``ablate`` is an argument and there is nothing to restore.

The report.  Its deterministic block is ``shapes``, ``full`` and each of
``phases`` (the arm's ``ablate`` tokens, its kernel ``launches`` from
kernels.LAUNCHES, its fixpoint ``host_checks`` and a ``digest`` of its
outputs) and ``kernel_ab`` (``identical``: the plain full arm's outputs
equal the kernel full arm's; the plain arms' blocks).  The reference's
static axis is XLA's FLOP count; PyTorch has none for a step of sorts,
scatters and two hand-written kernels, so the reference's ``flops`` and
``bytes`` (in ``full`` and ``phases``), ``residual_flops``,
``cost_table`` (its cross-check against program_cost_table) and
``kernel_ab``'s ``full_flops``, ``phase_flops`` and ``interpreted`` have
no counterpart.  ``measure=True`` adds ``measured``: each arm run once
warm and then ``repeats`` times (the arms taking turns, the garbage
collector off), the median host wall seconds (the reference's
``full_wall_seconds``/``phase_wall_seconds``; per arm with its range)
and, on a CUDA engine, CUDA-event ms around the arm (``full_device_ms``,
``phase_device_ms``, per arm with its range); phases are full minus
ablated, with evict carved out of merge.  The fixpoint's host checks
sit inside the step, so an arm's CUDA-event span includes the device
idling while the host decides to go on: the fixpoint phase is its rounds
plus their checks.
``kernel_ab`` then carries the kernel and plain ms of the full step and
of each phase.

``record=True`` (the default, as the reference's) records one
``phase.<name>`` span a phase as a child of the engine's
``last_dispatch_span``, with deterministic attributes only: where the
reference puts XLA's ``flops`` and ``share``, the port puts the ablated
arm's ``ablate`` token, its kernel ``launches`` and its fixpoint
``host_checks``.  Wall and CUDA-event times stay in the report.

Tiered engines raise, as in the reference, and so does an engine built
with a non-empty ``ablate`` (the twin of the reference's check that its
flag is unset).
"""

from __future__ import annotations

import gc
import hashlib
from typing import List

import numpy as np
import torch

from ..flow.hotpath import g_hostguard
from ..flow.rng import DeterministicRandom
from ..flow.spans import begin_span
from ..metrics import wall_now
from . import engine_torch as et
from . import kernels
from .types import TransactionConflictInfo

# (phase name, ablation token).  Order matters: "merge" covers phases 5-6,
# so the evict share is carved out of it.
PHASE_ABLATIONS = (
    ("search", "nosearch"),
    ("fixpoint", "nofix"),
    ("merge", "nomerge"),
    ("evict", "noevict"),
)

# The kernel A/B token: every arm runs again on the plain non-kernel step.
NOKERNEL = "nokernel"


def _synthetic_txns(n: int = 24, keyspace: int = 512) -> List[TransactionConflictInfo]:
    """Deterministic batch for shape-only callers (no live stream): the
    reference's, draw for draw."""

    def k(i: int) -> bytes:
        return b"%08d" % i

    rng = DeterministicRandom(1)
    out = []
    for _ in range(n):
        tr = TransactionConflictInfo(read_snapshot=5)
        a = rng.random_int(0, keyspace)
        tr.read_ranges.append((k(a), k(a + 1 + rng.random_int(0, 16))))
        a = rng.random_int(0, keyspace)
        tr.write_ranges.append((k(a), k(a + 1 + rng.random_int(0, 8))))
        out.append(tr)
    return out


def outputs_digest(outputs) -> str:
    """sha256 of a step's outputs (the 9 tensors of _blob_core, or the same
    values read from an engine after a dispatch), dtype and bytes."""
    h = hashlib.sha256()
    for t in outputs:
        a = t.detach().cpu().contiguous().numpy()
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _arm_names():
    """(arm name, ablate tokens) for every arm, the kernel arms first."""
    arms = [("full", frozenset())] + [(ph, frozenset({tok})) for ph, tok in PHASE_ABLATIONS]
    return arms + [("plain_" + name, toks | {NOKERNEL}) for name, toks in arms]


def split_phases(times: dict, prefix: str = "") -> dict:
    """Per-phase times from per-arm times: full minus ablated, evict carved
    out of merge so the phases partition."""
    full = times[prefix + "full"]
    out = {ph: max(0.0, full - times[prefix + ph]) for ph, _tok in PHASE_ABLATIONS}
    out["evict"] = min(out["evict"], out["merge"])
    out["merge"] = max(0.0, out["merge"] - out["evict"])
    return out


def attribute_phases(engine, transactions=None, *, measure: bool = False,
                     repeats: int = 3, record: bool = True) -> dict:
    """Attribute one step of a flat TorchConflictSet across its phases (see
    the module docstring).  The batch is `transactions` (default
    _synthetic_txns()) at now = the engine's oldest version + 8, evicting
    below its oldest version, as the reference picks them.  With `record`,
    the phases become spans under the engine's last dispatch span."""
    if engine.tiered:
        raise ValueError(
            "phase attribution needs the flat engine: the ablation seams live "
            "in the flat step only (the engine's own tiered+ablate rejection)")
    if engine.ablate:
        raise ValueError(
            f"the engine runs with ablate={sorted(engine.ablate)}; attribution "
            "sets each arm's ablation itself")
    mt, mr, mw = engine.bucket_mins
    txns = transactions if transactions is not None else _synthetic_txns()
    pb = et.PackedBatch.from_transactions(
        txns, engine.key_words, min_txn=mt, min_rr=mr, min_wr=mw)
    oldest = engine.oldest_version
    blob_np = np.empty((et.blob_words(pb),), np.uint32)
    et.fill_blob(blob_np, pb, engine._base, oldest + 8, oldest, 1)
    dev = engine.device
    cuda = dev.type == "cuda"
    blob = torch.from_numpy(blob_np.view(np.int32)).to(dev)
    state = (engine._hkeys, engine._hvers, engine._hcount, engine._oldest)
    shapes = dict(txn_cap=pb.txn_cap, rr_cap=pb.rr_cap, wr_cap=pb.wr_cap,
                  h_cap=engine.h_cap, kw1=engine.key_words + 1, amortized=False)
    caps = {k: v for k, v in shapes.items() if k != "amortized"}

    def run(ablate, checks=None):
        def on_sync():
            checks[0] += 1
            return g_hostguard.allowed()

        return et._blob_core(*state, blob, on_sync=None if checks is None else on_sync,
                             ablate=ablate, **caps)

    arms = _arm_names()
    blocks, digests = {}, {}
    for name, ablate in arms:  # this run is also each arm's warm run
        before = dict(kernels.LAUNCHES)
        checks = [0]
        out = run(ablate, checks)
        digests[name] = outputs_digest(out)
        del out  # an arm's H-sized outputs go before the next arm's
        blocks[name] = {
            "ablate": sorted(ablate),
            "launches": {k: kernels.LAUNCHES[k] - before[k] for k in before},
            "host_checks": checks[0],
            "digest": digests[name],
        }
    host = {name: [] for name, _a in arms}
    dms = {name: [] for name, _a in arms}
    if measure:
        # The arms take turns, so that a drift of the host's pace spreads
        # over all of them; no garbage collection inside a timed run.
        gc.collect()
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            for _ in range(repeats):
                for name, ablate in arms:
                    if cuda:
                        torch.cuda.synchronize(dev)
                        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                        a.record()
                    t0 = wall_now()
                    out = run(ablate)
                    if cuda:
                        b.record()
                        torch.cuda.synchronize(dev)
                    host[name].append(wall_now() - t0)
                    if cuda:
                        dms[name].append(a.elapsed_time(b))
                    del out
        finally:
            if gc_was_on:
                gc.enable()
    wall = {name: float(np.median(v)) for name, v in host.items() if v}
    device_ms = {name: float(np.median(v)) for name, v in dms.items() if v}

    phases = [dict(phase=ph, **blocks[ph]) for ph, _tok in PHASE_ABLATIONS]
    report: dict = {
        "shapes": shapes,
        "full": blocks["full"],
        "phases": phases,
        "kernel_ab": {
            "identical": digests["plain_full"] == digests["full"],
            "plain_full": blocks["plain_full"],
            "plain_phases": [dict(phase=ph, **blocks["plain_" + ph])
                             for ph, _tok in PHASE_ABLATIONS],
        },
    }
    if measure:
        report["measured"] = {
            "full_wall_seconds": wall["full"],
            "phase_wall_seconds": split_phases(wall),
            "arm_wall_seconds": wall,
            "arm_wall_seconds_range": {n: [min(v), max(v)] for n, v in host.items()},
            "repeats": repeats,
        }
        kab = report["kernel_ab"]
        kab["measured_full_wall_seconds"] = {"kernels": wall["full"],
                                             "plain": wall["plain_full"]}
        kab["measured_phase_wall_seconds"] = {
            ph: {"kernels": k, "plain": p}
            for (ph, k), p in zip(split_phases(wall).items(), split_phases(wall, "plain_").values())}
        if cuda:
            report["measured"].update(
                full_device_ms=device_ms["full"], phase_device_ms=split_phases(device_ms),
                arm_device_ms=device_ms,
                arm_device_ms_range={n: [min(v), max(v)] for n, v in dms.items()})
            kab["measured_full_device_ms"] = {"kernels": device_ms["full"],
                                              "plain": device_ms["plain_full"]}
            kab["measured_phase_device_ms"] = {
                ph: {"kernels": k, "plain": p}
                for (ph, k), p in zip(split_phases(device_ms).items(),
                                      split_phases(device_ms, "plain_").values())}
    if record:
        _record_phase_spans(engine, phases)
    return report


def _record_phase_spans(engine, phases) -> None:
    """One span a phase under the engine's last dispatch span, with the
    ablated arm's deterministic fields (never a time)."""
    parent = getattr(engine, "last_dispatch_span", None)
    for p in phases:
        begin_span(
            f"phase.{p['phase']}",
            parent=parent,
            attrs={"ablate": p["ablate"], "launches": dict(p["launches"]),
                   "host_checks": p["host_checks"]},
        ).end()
