"""The port's device program registry and its cost table.

Port of the reference's entry-point registry and program cost accounting
(``conflict/engine_jax.py``: ``DEVICE_ENTRY_POINTS``,
``register_entry_point``, ``program_cost_table``, ``cached_program_costs``),
re-exported from engine_torch.  Every program the port runs against the
carried engine state registers here under the reference's name for the
same program, with the reference's argument names and its ``carried``
(state the step replaces) and ``pinned`` (state it reads and keeps) lists:

  flat_step_kernels    engine_torch._blob_core as served
  flat_step            the same with ablate={"nokernel"}
  tiered_step_kernels  engine_torch._tiered_blob_core (a compaction batch)
  compact_body         engine_torch._major_compact
  rebase_body          engine_torch._rebase_core
  grow_body            engine_torch._grow_core
  sharded_step_kernels, sharded_step_tiered
                       parallel/sharded_resolver.py (registered when that
                       module is imported, as the reference does)

The reference's XLA-only ``tiered_step`` and ``sharded_step`` (its
non-kernel tiered and sharded programs) have no port program.

Each registration also carries the reference's structural metadata for
the same entry, with the same values: ``size_classes`` (named dimension
thresholds, descending), ``h_threshold`` (the history's width),
``compaction_gated`` (history-wide work belongs in the major compaction
only), ``work_bound`` (the widest a work op may be) and ``bucket_dims``
(static dim -> (canonical value, bucket floor)).  tools/lint/torchir.py
checks the programs against them.

A registration records a factory and costs nothing at import.  A cost
block holds shape math (``carried_bytes``, ``carried_bytes_total``,
``pinned_bytes_total``, ``argument_bytes_total``), ``"kernel": True`` on
entries that launch a hand-written kernel, and ``memory``: the argument
and output bytes, and on CUDA ``temp``, the device bytes allocated above
the arguments and the new outputs at the peak of one run at the canonical
shapes (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``), on a valid empty history.  The reference's
``flops_per_batch``, ``bytes_accessed_per_batch`` and the ``alias`` and
``generated_code`` sizes come from XLA's analyses and have no counterpart
here.  PyTorch has no compile step: each entry runs once to load its
kernels, then once measured; that run's wall seconds appear only in the
``include_wall`` view, beside a process histogram of them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..metrics import BoundedHistogram, wall_now

# Canonical shapes of the registered programs: the reference's.
EP_TXN, EP_RR, EP_WR = 32, 128, 64
EP_H, EP_D, EP_KW1 = 4096, 256, 4
EP_BUCKET_MIN = 8  # PackedBatch's bucket floor (bucket_mins default)


class DeviceEntryPoint:
    """One registered device program.

    ``factory(device) -> (fn, args, statics)``: ``fn(*args, **statics)``
    runs the program once on tensors that ``factory`` makes on `device`
    (a valid empty history and a canonical batch).  ``arg_names`` name
    ``args`` in order; ``carried`` and ``pinned`` are subsets of them;
    ``kernel`` marks a program that launches a hand-written kernel.  The
    structural metadata (module docstring) defaults to none."""

    def __init__(self, name: str, factory: Callable, *, arg_names, carried=(),
                 pinned=(), kernel: bool = False, size_classes=(), h_threshold: int = 0,
                 compaction_gated: bool = False, work_bound: Optional[int] = None,
                 bucket_dims=None):
        self.name = name
        self.factory = factory
        self.arg_names = tuple(arg_names)
        self.carried = tuple(carried)
        self.pinned = tuple(pinned)
        self.kernel = kernel
        self.size_classes = tuple(size_classes)
        self.h_threshold = h_threshold
        self.compaction_gated = compaction_gated
        self.work_bound = work_bound
        self.bucket_dims = dict(bucket_dims or {})

    def arg_nbytes(self) -> Dict[str, int]:
        """arg name -> bytes, from the canonical arguments' shapes and
        types (built on the CPU: shape math, nothing runs)."""
        _fn, args, _statics = self.factory(torch.device("cpu"))
        if len(args) != len(self.arg_names):
            raise AssertionError(f"{self.name}: {len(args)} args for {self.arg_names}")
        return {n: _nbytes(a) for n, a in zip(self.arg_names, args)}

    def carried_bytes(self) -> Dict[str, int]:
        """Per-buffer bytes of the carried state."""
        sizes = self.arg_nbytes()
        return {n: sizes[n] for n in self.carried}


def _nbytes(x) -> int:
    if not isinstance(x, torch.Tensor):
        return 4  # a host flag, the reference's int32 scalar argument
    return int(x.numel()) * x.element_size()


DEVICE_ENTRY_POINTS: Dict[str, DeviceEntryPoint] = {}


def register_entry_point(name: str, factory: Callable, *, registry=None,
                         **meta) -> DeviceEntryPoint:
    ep = DeviceEntryPoint(name, factory, **meta)
    (DEVICE_ENTRY_POINTS if registry is None else registry)[name] = ep
    return ep


# ---------------------------------------------------------------------------
# the cost table
# ---------------------------------------------------------------------------

# device type -> name -> cost block, computed on first request and kept
# for the process (a status call never pays the runs).
_PROGRAM_COSTS: Dict[str, Dict[str, dict]] = {}
# device type -> name -> wall seconds of the measured run, kept out of the
# deterministic blocks.
_PROGRAM_RUN_WALL: Dict[str, Dict[str, float]] = {}
# Process-wide histogram of the measured runs' wall seconds.
_RUN_WALL_HIST = BoundedHistogram("program_run_wall")


def _outputs(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _outputs(o)]
    return []


def _cost_block(ep: DeviceEntryPoint, dev: torch.device):
    """One entry's block and its run's wall seconds."""
    sizes = ep.arg_nbytes()
    carried = {n: sizes[n] for n in ep.carried}
    blk: dict = {
        "entry": ep.name,
        "carried_bytes": carried,
        "carried_bytes_total": sum(carried.values()),
        "pinned_bytes_total": sum(sizes[n] for n in ep.pinned),
        "argument_bytes_total": sum(sizes.values()),
    }
    if ep.kernel:
        blk["kernel"] = True
    cuda = dev.type == "cuda"
    fn, args, statics = ep.factory(dev)
    fn(*args, **statics)  # loads the kernels (there is no compile step)
    del args
    fn, args, statics = ep.factory(dev)
    arg_ptrs = {a.untyped_storage().data_ptr() for a in args if isinstance(a, torch.Tensor)}
    if cuda:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = wall_now()
    out = _outputs(fn(*args, **statics))
    if cuda:
        torch.cuda.synchronize(dev)
    wall = wall_now() - t0
    # New outputs: a program may hand back an argument (a minor batch's
    # base tier) or update one in place (the sharded steps).
    fresh = {}
    for t in out:
        ptr = t.untyped_storage().data_ptr()
        if ptr not in arg_ptrs:
            fresh[ptr] = t.untyped_storage().nbytes()
    memory = {"argument": sum(sizes.values()), "output": sum(_nbytes(t) for t in out)}
    if cuda:
        memory["temp"] = max(0, torch.cuda.max_memory_allocated(dev) - base
                             - sum(fresh.values()))
    blk["memory"] = memory
    return blk, wall


def program_cost_table(registry=None, include_wall: bool = False, device=None) -> dict:
    """name -> cost block for every registered program, on `device` (None:
    the GPU).  Cached per device type after the first call; entries
    registered later (the sharded steps, on parallel import) are accounted
    on the next call.  A program that fails on this device yields an
    {"error": ...} block instead of sinking the table.  include_wall adds
    each entry's ``run_wall_seconds`` and the process histogram under
    ``_run_wall``."""
    dev = resolve_device(device)
    eps = DEVICE_ENTRY_POINTS if registry is None else registry
    costs = _PROGRAM_COSTS.setdefault(dev.type, {})
    walls = _PROGRAM_RUN_WALL.setdefault(dev.type, {})
    for name, ep in sorted(eps.items()):
        if name in costs:
            continue
        try:
            costs[name], walls[name] = _cost_block(ep, dev)
        except (RuntimeError, ValueError, TypeError) as e:  # recorded per entry
            costs[name] = {"entry": name, "error": f"{type(e).__name__}: {e}"}
            continue
        _RUN_WALL_HIST.add(walls[name])
    out = {n: dict(costs[n]) for n in sorted(eps) if n in costs}
    if include_wall:
        for n in out:
            if n in walls:
                out[n]["run_wall_seconds"] = walls[n]
        out["_run_wall"] = _RUN_WALL_HIST.summary()
    return out


def cached_program_costs(device=None) -> Optional[dict]:
    """The already-computed table (deterministic blocks only) for the type
    of `device` (None: the table computed last), or None when nothing has
    been accounted yet."""
    if device is None:
        if not _PROGRAM_COSTS:
            return None
        costs = list(_PROGRAM_COSTS.values())[-1]
    else:
        costs = _PROGRAM_COSTS.get(torch.device(device).type)
    if not costs:
        return None
    return {n: dict(b) for n, b in sorted(costs.items())}


# ---------------------------------------------------------------------------
# the single-device entries
# ---------------------------------------------------------------------------


def _ep_history(dev, kw1, width):
    """A valid empty history tier: the floor row b"" at FLOOR_REL, INF past
    it; (keys, vers, count)."""
    from . import engine_torch as et
    from . import keys as keylib

    hk = torch.full((kw1, width), keylib.INF_DEV, dtype=torch.int32, device=dev)
    hk[:, 0] = keylib.ZERO_DEV
    hv = torch.full((width,), et.FLOOR_REL, dtype=torch.int32, device=dev)
    return hk, hv, torch.ones((), dtype=torch.int32, device=dev)


def ep_batch(kw1: int = EP_KW1):
    """The canonical PackedBatch: EP_TXN transactions, each reading
    EP_RR // EP_TXN and writing EP_WR // EP_TXN short ranges of 4-byte
    keys, drawn from a fixed seed."""
    from . import engine_torch as et
    from . import keys as keylib

    txn, rr, wr = EP_TXN, EP_RR, EP_WR
    rng = np.random.default_rng(0)
    pb = et.PackedBatch(txn, rr, wr, kw1 - 1)
    for begin, end, owner, n in ((pb.r_begin, pb.r_end, pb.r_txn, rr),
                                 (pb.w_begin, pb.w_end, pb.w_txn, wr)):
        a = rng.integers(0, 1 << 16, n)
        begin[:] = keylib.encode_int_keys(a, kw1 - 1, 4)
        end[:] = keylib.encode_int_keys(a + 1 + rng.integers(0, 8, n), kw1 - 1, 4)
        owner[:] = np.repeat(np.arange(txn, dtype=np.int32), n // txn)
    pb.r_snap[:] = 1
    pb.t_snap[:] = 1
    pb.t_has_reads[:] = True
    pb.t_valid[:] = True
    pb.n_txn, pb.n_r, pb.n_w = txn, rr, wr
    return pb


def _ep_blob(dev, flag: int):
    from . import engine_torch as et

    pb = ep_batch()
    blob = np.empty((et.blob_words(pb),), np.uint32)
    et.fill_blob(blob, pb, 0, 8, 0, flag)
    return torch.from_numpy(blob.view(np.int32).copy()).to(dev)


def _flat_args(dev):
    hk, hv, hc = _ep_history(dev, EP_KW1, EP_H)
    return (hk, hv, hc, torch.zeros((), dtype=torch.int32, device=dev), _ep_blob(dev, 1))


_STEP_STATICS = dict(txn_cap=EP_TXN, rr_cap=EP_RR, wr_cap=EP_WR, h_cap=EP_H, kw1=EP_KW1)


def _ep_flat_step_kernels(dev):
    from . import engine_torch as et

    return et._blob_core, _flat_args(dev), dict(_STEP_STATICS)


def _ep_flat_step(dev):  # torchcheck: ignore[TGX004]: torch.sort has no int32 indices; the nokernel arm's merge sort over H + 2 * wr_cap, a measurement arm
    from . import engine_torch as et

    return et._blob_core, _flat_args(dev), dict(_STEP_STATICS, ablate=frozenset({"nokernel"}))


def _ep_tiered_step_kernels(dev):
    from . import engine_torch as et
    from ..ops.rangequery import build_max_table_np

    hk, hv, hc = _ep_history(dev, EP_KW1, EP_H)
    dk, dv, dc = et._empty_delta(EP_KW1, EP_D, dev)
    maxtab = torch.from_numpy(build_max_table_np(hv.cpu().numpy())).to(dev)
    args = (hk, hv, hc, maxtab, dk, dv, dc, torch.zeros((), dtype=torch.int32, device=dev),
            _ep_blob(dev, 1))
    return et._tiered_blob_core, args, dict(_STEP_STATICS, d_cap=EP_D, do_major=True)


def _ep_compact_body(dev):
    from . import engine_torch as et

    hk, hv, hc = _ep_history(dev, EP_KW1, EP_H)
    dk, dv, dc = et._empty_delta(EP_KW1, EP_D, dev)
    args = (hk, hv, hc, dk, dv, dc, torch.zeros((), dtype=torch.int32, device=dev))
    return et._major_compact, args, dict(H=EP_H, D=EP_D)


def _ep_rebase_body(dev):
    from . import engine_torch as et

    _hk, hv, _hc = _ep_history(dev, EP_KW1, EP_H)
    return et._rebase_core, (hv, torch.ones((), dtype=torch.int32, device=dev)), {}


def _ep_grow_body(dev):
    from . import engine_torch as et
    from . import keys as keylib

    hk, _hv, _hc = _ep_history(dev, EP_KW1, EP_H)
    return et._grow_core, (hk,), dict(pad=EP_H, fill=keylib.INF_DEV)


_FLAT_ARGS = ("hkeys", "hvers", "hcount", "oldest", "blob")
_TIERED_ARGS = ("hkeys", "hvers", "hcount", "maxtab", "dkeys", "dvers", "dcount",
                "oldest", "blob")
_EP_BUCKETS = {
    "txn_cap": (EP_TXN, EP_BUCKET_MIN),
    "rr_cap": (EP_RR, EP_BUCKET_MIN),
    "wr_cap": (EP_WR, EP_BUCKET_MIN),
    "h_cap": (EP_H, 64),
}
_P = 2 * (EP_RR + EP_WR)

register_entry_point("flat_step_kernels", _ep_flat_step_kernels, arg_names=_FLAT_ARGS,
                     carried=_FLAT_ARGS[:4], kernel=True,
                     size_classes=(("H", EP_H), ("P", _P), ("batch", EP_TXN)),
                     h_threshold=EP_H, work_bound=EP_H + 4 * EP_WR, bucket_dims=_EP_BUCKETS)
register_entry_point("flat_step", _ep_flat_step, arg_names=_FLAT_ARGS,
                     carried=_FLAT_ARGS[:4],
                     size_classes=(("H", EP_H), ("P", _P), ("batch", EP_TXN)),
                     h_threshold=EP_H, work_bound=EP_H + 4 * EP_WR, bucket_dims=_EP_BUCKETS)
# Steady state is delta-bounded: history-wide work only in the compaction.
register_entry_point("tiered_step_kernels", _ep_tiered_step_kernels,
                     arg_names=_TIERED_ARGS, carried=_TIERED_ARGS[:8], kernel=True,
                     size_classes=(("H", EP_H), ("P", _P), ("D", EP_D), ("batch", EP_TXN)),
                     h_threshold=EP_H, compaction_gated=True,
                     work_bound=EP_H + EP_D + 4 * EP_WR,
                     bucket_dims=dict(_EP_BUCKETS, d_cap=(EP_D, 64)))
# Runs only inside the tiered step, which owns its state.
register_entry_point("compact_body", _ep_compact_body,
                     arg_names=("hk", "hv", "hc", "dk", "dv", "dc", "new_oldest"),
                     kernel=True, size_classes=(("H", EP_H), ("D", EP_D), ("batch", EP_TXN)),
                     h_threshold=EP_H, work_bound=EP_H + EP_D,
                     bucket_dims=dict(h_cap=(EP_H, 64), d_cap=(EP_D, 64)))
register_entry_point("rebase_body", _ep_rebase_body, arg_names=("vers", "d"),
                     carried=("vers",), size_classes=(("H", EP_H),), h_threshold=EP_H,
                     work_bound=EP_H, bucket_dims=dict(h_cap=(EP_H, 64)))
# The reallocation's output is old + pad rows.
register_entry_point("grow_body", _ep_grow_body, arg_names=("buf",), carried=("buf",),
                     size_classes=(("H", EP_H),), h_threshold=EP_H, work_bound=2 * EP_H,
                     bucket_dims=dict(h_cap=(EP_H, 64)))
