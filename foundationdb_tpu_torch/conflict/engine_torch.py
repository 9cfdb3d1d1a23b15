"""Device conflict engine: whole-batch MVCC conflict detection in PyTorch.

Port of the reference package's single-device engine,
conflict/engine_jax.py, with both of its history modes: flat (one sorted
history) and tiered (a frozen base tier plus a small delta tier, folded
together by a major compaction).  The Resolver's
ResolveTransactionBatchRequest is decided in one device step:

  phase 1      history conflicts: every read range's insertion ranks in the
               sorted history (kernels.phase1_search, the hand-written
               search kernel) + a sparse-table range max of versions
  phases 2-4   point-domain sort of all range endpoints, the intra-batch
               fixpoint (segment-tree stabbing), the committed-write union
  phases 5-6   rank-inversion merge prep, then the hand-written fused
               merge + removeBefore eviction + compaction kernel

Each step is a decide half (phases 1-4 and the witness: decide_flat,
decide_tiered) and a commit half (phases 5-6 and the divergence guard:
commit_flat, commit_tiered), so that the sharded set
(parallel/sharded_resolver.py) can combine every shard's undecided count
before any shard commits; detect_core and detect_core_tiered run the two
back to back.  With ``witness`` off (the reference's FDB_TPU_WITNESS=0)
the step is the reference's witness-free program: no final stabbing for
the witness and no witness vectors.  ``search`` picks the form of the
step's plain multiword searches (the reference's FDB_TPU_SEARCH).

The flat step carries the reference's ablation seams (its FDB_TPU_ABLATE
tokens, here the ``ablate`` argument, a subset of ABLATIONS) for in-step
phase attribution (conflict/phase_attribution.py):

  nosearch   phase 1 skips the history search: i0 = j1 = word 0 mod H
  nofix      phase 3 skips the fixpoint rounds (and their host checks):
             every undecided txn commits, iters = 1
  nomerge    phases 5-6 are skipped: the history comes back unchanged,
             the window advances unconditionally
  noevict    phase 6 evicts nothing (window FLOOR_REL)
  nokernel   the reference's non-kernel step: phase 1 by two plain
             searches, phases 5-6 by the sort-by-target merge
             (_merge_new_segments), the removeBefore rule (_evict_rule)
             and a compaction sort (_compact_to), in plain PyTorch on the
             same device; bit-identical to the kernel step.  Only a
             caller's ``ablate`` reaches it: a kernel that fails to build
             or launch still raises.

The flat step also takes the reference's amortized eviction
(``evict_every`` > 1): the blob's third scalar says whether this batch
evicts, and a batch that does not keeps every merged row (the kernel step
merges against the window FLOOR_REL).

History is a word-major (kw1, h_cap) int32 key buffer (device word encoding,
conflict/keys.py) plus (h_cap,) int32 versions relative to a host-held
base; rows past the live count are INF / FLOOR_REL.  Tiered mode adds a
(kw1, d_cap) delta tier in the same form and the base's sparse max table,
carried across batches (see detect_core_tiered).  Every output — the
verdicts, the abort witness, iters and the carried state — is bit-identical
to the reference step on the same inputs.

Where the reference relies on JAX semantics that PyTorch lacks:
  - multi-key sorts are chains of stable single-key sorts (lex_argsort);
  - out-of-range gathers are clamped and masked scatters go to an explicit
    dump slot (JAX clamps/drops silently, PyTorch raises);
  - the uint32 wraparound of the point-domain tail word is reproduced in
    int64 masked to 32 bits;
  - the fixpoint while_loop runs in fixed chunks of masked rounds with one
    host sync after each chunk; ``iters`` counts only the rounds the
    reference's loop would run;
  - the reference's traced major-compaction cond is a Python ``if`` on the
    host's own compaction flag.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from contextlib import ExitStack, nullcontext
from functools import partial
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..device import is_lost_device, resolve_device
from ..flow.hotpath import GuardedDeviceValue, cuda_sync_debug_mode, g_hostguard, hot_path
from ..flow.spans import begin_span
from ..flow.trace import TraceEvent
from ..metrics import MetricsRegistry
from ..ops.rangequery import (
    build_max_table,
    build_max_table_np,
    build_min_table,
    check_search,
    lex_argsort,
    lex_less,
    range_max,
    range_min,
    searchsorted_1d,
    searchsorted_words,
)
from ..ops.stabbing import INF32, stabbing_min
from . import keys as keylib
from .device_faults import CompileFailed, DeviceOOM, DeviceUnavailable
from .engine_cpu import chunk_encoding
from .engine_cpu_flat import FLOOR_VERSION, FlatCpuConflictSet
from .kernels import fused_merge_evict, phase1_search, phase1_search_tiers
from .regions import region
from .types import COMMITTED, CONFLICT, TOO_OLD, TransactionConflictInfo

FLOOR_REL = -(2**30)  # below every representable snapshot
REBASE_THRESHOLD = 2**29

# Abort-witness sentinel: per-txn witness slots for txns whose final status
# is not CONFLICT carry (FLOOR_REL, WITNESS_NONE_RANGE).
WITNESS_NONE_RANGE = 2**31 - 1

_UNDECIDED = 0
_COMM = 1
_CONF = 2

# Fixpoint rounds run before the first host check of "anything left?", and
# between two later checks.  One first round: at the bench shape most
# batches end after 0-1 rounds, and a masked round past the exit costs the
# host more time to enqueue than a check costs (chip_smoke.py's
# first-chunk sweep).
FIXPOINT_FIRST_CHUNK = 1
FIXPOINT_CHUNK = 4

I32 = torch.int32

# The flat step's ablation seams (module docstring): the reference's
# FDB_TPU_ABLATE tokens.
ABLATIONS = frozenset({"nosearch", "nofix", "nomerge", "noevict", "nokernel"})


def check_ablate(ablate) -> frozenset:
    """`ablate` as a frozenset of ABLATIONS tokens; raises ValueError on any
    other token."""
    out = frozenset(ablate)
    unknown = out - ABLATIONS
    if unknown:
        raise ValueError(f"unknown ablation tokens {sorted(unknown)}; "
                         f"known: {sorted(ABLATIONS)}")
    return out


def _next_pow2(n: int, lo: int) -> int:
    return max(lo, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


# ---------------------------------------------------------------------------
# Host-side batch form (numpy)
# ---------------------------------------------------------------------------


def _unpack_transactions(pb: "PackedBatch") -> List[TransactionConflictInfo]:
    """PackedBatch -> TransactionConflictInfo list (CPU-fallback path only;
    keys come back in their packed fixed-width form, which is the key space
    both engines decide over)."""
    txns = [
        TransactionConflictInfo(
            read_snapshot=int(pb.t_snap[t]), read_ranges=[], write_ranges=[]
        )
        for t in range(pb.n_txn)
    ]
    for i in range(pb.n_r):
        t = int(pb.r_txn[i])
        if t < pb.n_txn:
            txns[t].read_ranges.append((
                keylib.decode_key(pb.r_begin[i], pb.key_words),
                keylib.decode_key(pb.r_end[i], pb.key_words),
            ))
    for i in range(pb.n_w):
        t = int(pb.w_txn[i])
        if t < pb.n_txn:
            txns[t].write_ranges.append((
                keylib.decode_key(pb.w_begin[i], pb.key_words),
                keylib.decode_key(pb.w_end[i], pb.key_words),
            ))
    return txns


def decode_witness(pb, statuses, w_ver, w_rng, base):
    """Decode the witness vectors to the host form: per live txn,
    (absolute conflicting version, read-range ordinal within that txn) —
    or None for non-CONFLICT txns.  The packed read index is global
    (r_txn is ascending and every read range is packed, empty ones
    included), so the per-txn ordinal is the global index minus the txn's
    first packed row."""
    wv = np.asarray(w_ver)
    wr = np.asarray(w_rng)
    r_txn = pb.r_txn[: pb.n_r]
    out: list = []
    for t in range(pb.n_txn):
        if int(statuses[t]) == CONFLICT and int(wr[t]) < WITNESS_NONE_RANGE:
            first = int(np.searchsorted(r_txn, t, side="left"))
            out.append((int(wv[t]) + base, int(wr[t]) - first))
        else:
            out.append(None)
    return out


# Head of a ticket's readback buffer: undecided, iters, hcount, dcount.
_HEAD = 4


class DispatchTicket:
    """One dispatched batch: the packed batch and its versions (what a
    caller needs to re-decide it elsewhere after a divergence), and the
    step's outputs in ONE int32 buffer that a single copy reads back:
    [undecided, iters, hcount, dcount, statuses, w_ver, w_rng] (the last
    three txn_cap long, the witness vectors only from a step with the
    witness on; hcount and dcount are the tiers' row counts after the
    batch, dcount 0 in flat mode).  On CUDA the copy into the pinned
    ``host`` buffer is enqueued right behind the step and ``ready`` is its
    event, so a sync waits for this batch and not for later ones.  ``base``
    is the dispatch-time version base of the witness versions, ``d_cap``
    the dispatch-time delta capacity, and ``added``/``epoch`` date the
    flat row-count bound."""

    __slots__ = ("pb", "now", "new_oldest_version", "out", "host", "ready",
                 "base", "d_cap", "added", "epoch")

    def __init__(self, pb, now, new_oldest_version, out, host, ready, base,
                 d_cap, added, epoch):
        self.pb = pb
        self.now = now
        self.new_oldest_version = new_oldest_version
        self.out = out
        self.host = host
        self.ready = ready
        self.base = base
        self.d_cap = d_cap
        self.added = added
        self.epoch = epoch


class PackedBatch:
    """Host-side (numpy) dense form of a transaction batch, bucketed to
    power-of-two capacities (padding rows carry INF keys and an owner index
    of txn_cap)."""

    def __init__(self, txn_cap, rr_cap, wr_cap, key_words):
        kw1 = key_words + 1
        inf = keylib.INF_WORD
        self.key_words = key_words
        self.txn_cap, self.rr_cap, self.wr_cap = txn_cap, rr_cap, wr_cap
        self.r_begin = np.full((rr_cap, kw1), inf, np.uint32)
        self.r_end = np.full((rr_cap, kw1), inf, np.uint32)
        self.r_txn = np.full((rr_cap,), txn_cap, np.int32)
        self.r_snap = np.zeros((rr_cap,), np.int64)
        self.w_begin = np.full((wr_cap, kw1), inf, np.uint32)
        self.w_end = np.full((wr_cap, kw1), inf, np.uint32)
        self.w_txn = np.full((wr_cap,), txn_cap, np.int32)
        self.t_snap = np.zeros((txn_cap,), np.int64)
        self.t_has_reads = np.zeros((txn_cap,), bool)
        self.t_valid = np.zeros((txn_cap,), bool)
        self.n_txn = 0
        self.n_r = 0
        self.n_w = 0

    @classmethod
    @hot_path(bound="batch")
    def from_transactions(
        cls,
        txns: List[TransactionConflictInfo],
        key_words: int,
        min_txn: int = 8,
        min_rr: int = 8,
        min_wr: int = 8,
    ) -> "PackedBatch":
        n = len(txns)
        nr = sum(len(t.read_ranges) for t in txns)
        nw = sum(len(t.write_ranges) for t in txns)
        pb = cls(
            _next_pow2(n, min_txn),
            _next_pow2(nr, min_rr),
            _next_pow2(nw, min_wr),
            key_words,
        )
        rr_counts = np.fromiter((len(t.read_ranges) for t in txns), np.int64, count=n)
        wr_counts = np.fromiter((len(t.write_ranges) for t in txns), np.int64, count=n)
        snaps = np.fromiter((t.read_snapshot for t in txns), np.int64, count=n)
        pb.t_snap[:n] = snaps
        pb.t_has_reads[:n] = rr_counts > 0
        pb.t_valid[:n] = True
        if nr:
            owner = np.repeat(np.arange(n, dtype=np.int32), rr_counts)
            pb.r_txn[:nr] = owner
            pb.r_snap[:nr] = snaps[owner]
            rkeys = [b for t in txns for (b, _e) in t.read_ranges]
            rkeys += [e for t in txns for (_b, e) in t.read_ranges]
            enc = keylib.encode_keys(rkeys, key_words)
            pb.r_begin[:nr] = enc[:nr]
            pb.r_end[:nr] = enc[nr:]
        if nw:
            pb.w_txn[:nw] = np.repeat(np.arange(n, dtype=np.int32), wr_counts)
            wkeys = [b for t in txns for (b, _e) in t.write_ranges]
            wkeys += [e for t in txns for (_b, e) in t.write_ranges]
            enc = keylib.encode_keys(wkeys, key_words)
            pb.w_begin[:nw] = enc[:nw]
            pb.w_end[:nw] = enc[nw:]
        pb.n_txn, pb.n_r, pb.n_w = n, nr, nw
        return pb

    def bucket(self):
        return (self.txn_cap, self.rr_cap, self.wr_cap)


def _blob_offsets(txn_cap: int, rr_cap: int, wr_cap: int, kw1: int):
    """Field offsets (in uint32 words) of the single-transfer batch blob —
    the same layout (ABI) as the reference engine's blob."""
    sizes = [
        rr_cap * kw1,  # r_begin
        rr_cap * kw1,  # r_end
        wr_cap * kw1,  # w_begin
        wr_cap * kw1,  # w_end
        rr_cap,  # r_txn (i32)
        rr_cap,  # r_snap_rel (i32)
        wr_cap,  # w_txn (i32)
        txn_cap,  # t_snap_rel (i32)
        txn_cap,  # t_flags (bit0 has_reads, bit1 valid)
        3,  # now_rel, new_oldest_rel, and the host's flag (i32): flat,
        #     do_evict (1 unless amortized; read only when amortized);
        #     tiered, do_major (not read on the device)
    ]
    offs, o = [], 0
    for s in sizes:
        offs.append(o)
        o += s
    return offs, o


# ---------------------------------------------------------------------------
# The device step
# ---------------------------------------------------------------------------


def _arange(n, dev):
    return torch.arange(n, dtype=I32, device=dev)


def _cumsum(x):
    return torch.cumsum(x, 0, dtype=I32)


def _compact_to(pos, valid, words, width, count, vers=None):
    """Reorder columns of `words` [kw1, N] (and of `vers` [N], when given)
    so column i lands at pos[i]; invalid columns drop off the end, slots at
    and past `count` are INF (versions FLOOR_REL).  A stable sort by target
    position (positions of valid columns are distinct).  Returns the words,
    or (words, vers)."""
    n = pos.shape[0]
    p = torch.where(valid, pos.to(I32), n + width + 2)
    order = torch.sort(p, stable=True).indices[:width]
    live = _arange(width, words.device) < count
    out = torch.where(live[None, :], words[:, order], keylib.INF_DEV)
    if vers is None:
        return out
    return out, torch.where(live, vers[order], FLOOR_REL)


def _agg_txn(flags, owner, txn_cap):
    """Per-range bool -> per-txn any() over the ranges each txn owns."""
    dev = flags.device
    out = torch.zeros((txn_cap + 1,), dtype=I32, device=dev)
    out.scatter_reduce_(
        0, torch.where(flags, owner, txn_cap).long(), flags.to(I32), "amax",
        include_self=True,
    )
    return out[:txn_cap] != 0


def _resolve_batch(
    r_begin, r_end, r_txn, w_begin, w_end, w_txn, t_valid, status0,
    *, txn_cap, rr_cap, wr_cap, on_sync=None, ablate=frozenset(), witness=True,
):
    """Phases 2-4: point domain, intra-batch fixpoint, committed-write
    segment extraction.  Returns (status, iters, undecided_left, ub, ue,
    seg_valid, ib_flag) — ib_flag is the per-read-range intra-batch
    conflict flag that the abort witness reads, None unless `witness`
    (the witness-free step skips its stabbing).  With ``nofix`` in
    `ablate` the fixpoint's rounds and host checks are skipped and every
    undecided txn commits."""
    dev = r_begin.device
    kw1 = r_begin.shape[0]
    TXN, RR, WR = txn_cap, rr_cap, wr_cap
    P = 2 * RR + 2 * WR
    p_log2 = max(1, math.ceil(math.log2(P)))
    r_valid = r_txn < TXN
    w_valid = w_txn < TXN

    def owner_status(status, owner):
        return status[owner.clamp(0, TXN - 1).long()]

    # ---- phase 2: point domain (ref sortPoints + KeyInfo ordering) ----
    # categories at equal keys sort end-read(0) < end-write(1) <
    # begin-write(2) < begin-read(3)  (ref SkipList.cpp getCharacter :166-170)
    cat = torch.cat([
        torch.full((RR,), 3, dtype=torch.int64, device=dev),
        torch.full((RR,), 0, dtype=torch.int64, device=dev),
        torch.full((WR,), 2, dtype=torch.int64, device=dev),
        torch.full((WR,), 1, dtype=torch.int64, device=dev),
    ])
    pkeys = torch.cat([r_begin, r_end, w_begin, w_end], dim=1)
    # (length << 2) | category as the reference's uint32 computes it,
    # wraparound included: the unsigned length word is device word + 2^31.
    tail_u = pkeys[kw1 - 1].to(torch.int64) + 2**31
    packed_tail = (tail_u * 4 + cat) & 0xFFFFFFFF
    perm = lex_argsort([pkeys[w] for w in range(kw1 - 1)] + [packed_tail])
    pos = torch.empty((P,), dtype=I32, device=dev)
    pos[perm] = _arange(P, dev)
    sorted_len = ((packed_tail[perm] >> 2) - 2**31).to(I32)
    sorted_keys = torch.cat([pkeys[: kw1 - 1][:, perm], sorted_len[None, :]])

    rb_idx = pos[:RR]
    re_idx = pos[RR : 2 * RR]
    wb_idx = pos[2 * RR : 2 * RR + WR]
    we_idx = pos[2 * RR + WR :]

    # ---- phase 3: intra-batch fixpoint (ref checkIntraBatchConflicts) ----
    # Round 1 with no committed-stab, then one stabbing over the frozen
    # round-1 commits, then a residual fixpoint at compact width.
    r_has_slots = re_idx > rb_idx
    hi_r = torch.maximum(re_idx - 1, rb_idx)

    def read_query(stab):
        tab = build_min_table(stab)
        return torch.where(r_has_slots, range_min(tab, rb_idx, hi_r), INF32)

    # -- round 1 --
    act0 = w_valid & (owner_status(status0, w_txn) != _CONF)
    e1 = read_query(stabbing_min(wb_idx, we_idx, w_txn, act0, p_log2))
    E1_t = _agg_txn(r_valid & (e1 < r_txn), r_txn, TXN)
    status1 = torch.where(
        status0 != _UNDECIDED, status0,
        torch.where(E1_t, _UNDECIDED, _COMM).to(I32),
    )

    # -- frozen committed stab + immediate round-2 conflicts --
    com1 = w_valid & (owner_status(status1, w_txn) == _COMM)
    eF = read_query(stabbing_min(wb_idx, we_idx, w_txn, com1, p_log2))
    CF_t = _agg_txn(r_valid & (eF < r_txn), r_txn, TXN)
    status2 = torch.where((status1 == _UNDECIDED) & CF_t, _CONF, status1).to(I32)

    # -- residual compaction --
    RCAP = min(min(RR, WR), max(64, min(RR, WR) >> 4))
    r_res = r_valid & (owner_status(status2, r_txn) == _UNDECIDED)
    w_res = w_valid & (owner_status(status2, w_txn) == _UNDECIDED)
    overflow = (r_res.sum() > RCAP) | (w_res.sum() > RCAP)
    if "nofix" in ablate:
        status = torch.where(status0 == _UNDECIDED, _COMM, status0).to(I32)
        iters = torch.ones((), dtype=I32, device=dev)
    else:
        status, iters = _fixpoint(
            status2, r_res, w_res, rb_idx, re_idx, r_txn, wb_idx, we_idx, w_txn,
            txn_cap=TXN, rcap=RCAP, on_sync=on_sync)
    # Residual overflow is treated like divergence: the host re-decides
    # the batch on the CPU engine against the UNCHANGED history.
    undecided_left = ((status == _UNDECIDED).sum() + overflow.to(torch.int64)).to(I32)

    # Abort witness input: one more stabbing over the FINAL committed
    # writers answers, per read range, whether an earlier committed txn's
    # write intersects it (the CPU engine's `active.intersects`).  Phase 4
    # reads the same committed-writer mask.
    com_fin = w_valid & (owner_status(status, w_txn) == _COMM)
    ib_flag = None
    if witness:
        e_fin = read_query(stabbing_min(wb_idx, we_idx, w_txn, com_fin, p_log2))
        ib_flag = r_valid & (e_fin < r_txn)
    # ``nomerge`` reads no segments: the reference's compiler drops them.
    segs = ((None, None, None) if "nomerge" in ablate
            else _write_segments(sorted_keys, wb_idx, we_idx, com_fin, P=P, wr_cap=WR))
    return (status, iters, undecided_left, *segs, ib_flag)


def _fixpoint(status2, r_res, w_res, rb_idx, re_idx, r_txn, wb_idx, we_idx,
              w_txn, *, txn_cap, rcap, on_sync):
    """Phase 3's residual fixpoint at compact width, from round 2's
    statuses: returns (status, iters).  After each chunk of rounds it
    reads one flag back to the host, inside the scope ``on_sync()`` gives
    (the engine's sanctioned sync): a sync of the port's own, where the
    reference runs its rounds in a device while_loop."""
    dev = status2.device
    TXN, RCAP = txn_cap, rcap
    RP = 4 * RCAP
    rp_log2 = max(1, math.ceil(math.log2(RP)))

    def owner_status(status, owner):
        return status[owner.clamp(0, TXN - 1).long()]

    def compact_1d(valid, cols, width):
        """Stable sort-by-target compaction of parallel int32 columns."""
        rank = torch.where(valid, _cumsum(valid) - 1, valid.shape[0] + width)
        order = torch.sort(rank, stable=True).indices[:width]
        live = _arange(width, dev) < valid.sum()
        return [torch.where(live, c[order], 0) for c in cols], live

    (rb_c, re_c, rt_c), r_live = compact_1d(r_res, (rb_idx, re_idx, r_txn), RCAP)
    (wb_c, we_c, wt_c), w_live = compact_1d(w_res, (wb_idx, we_idx, w_txn), RCAP)
    # Re-rank endpoints into [0, RP): residual endpoints are distinct
    # slots, so ranking the combined endpoint set preserves every
    # intersection predicate.
    pts = torch.cat([rb_c, re_c, wb_c, we_c])
    pad = torch.where(
        torch.cat([r_live, r_live, w_live, w_live]),
        pts,
        2**30 + _arange(RP, dev),
    )
    spts = torch.sort(pad).values
    ranks = searchsorted_1d(spts, pad, "left")
    rb_r, re_r = ranks[:RCAP], ranks[RCAP : 2 * RCAP]
    wb_r, we_r = ranks[2 * RCAP : 3 * RCAP], ranks[3 * RCAP :]
    r_has_c = r_live & (re_r > rb_r)
    hi_c = torch.maximum(re_r - 1, rb_r)

    def residual_query(act):
        tab = build_min_table(stabbing_min(wb_r, we_r, wt_c, act, rp_log2))
        return torch.where(r_has_c, range_min(tab, rb_r, hi_c), INF32)

    def fix_body(status):
        ws = owner_status(status, wt_c)
        ea = residual_query(w_live & (ws != _CONF))
        ec = residual_query(w_live & (ws == _COMM))
        E_t = _agg_txn(r_live & (ea < rt_c), rt_c, TXN)
        C_t = _agg_txn(r_live & (ec < rt_c), rt_c, TXN)
        return torch.where(
            status != _UNDECIDED,
            status,
            torch.where(C_t, _CONF, torch.where(~E_t, _COMM, _UNDECIDED)).to(I32),
        )

    # The reference's while_loop (it from 2, while any undecided and
    # it < RCAP + 2) as masked rounds: a round past the loop's exit leaves
    # status and it unchanged, so chunks of rounds between host checks
    # give exactly the reference's status and iteration count.  The first
    # chunk runs before the first check, so a batch that needs no more
    # rounds than it holds costs one check.
    def looping(status, it):
        return (status == _UNDECIDED).any() & (it < RCAP + 2)

    def rounds(status, it, n):
        for _ in range(n):
            go = looping(status, it)
            status = torch.where(go, fix_body(status), status)
            it = it + go.to(I32)
        return status, it

    status, it = rounds(status2, torch.full((), 2, dtype=I32, device=dev),
                        FIXPOINT_FIRST_CHUNK)
    while True:
        with on_sync() if on_sync is not None else nullcontext():
            go = bool(looping(status, it))
        if not go:
            break
        status, it = rounds(status, it, FIXPOINT_CHUNK)
    return status, it


def _write_segments(sorted_keys, wb_idx, we_idx, com_fin, *, P, wr_cap):
    """Phase 4: the committed writers' union as sorted, coalesced segments
    (ub, ue, seg_valid) of at most wr_cap rows."""
    dev = sorted_keys.device
    WR = wr_cap
    delta = torch.zeros((P + 1,), dtype=I32, device=dev)
    delta.index_add_(0, torch.where(com_fin, wb_idx, P).long(), com_fin.to(I32))
    delta.index_add_(0, torch.where(com_fin, we_idx, P).long(), -com_fin.to(I32))
    cov = _cumsum(delta[:P]) > 0
    prev = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev), cov[:-1]])
    is_start = cov & ~prev
    is_end = ~cov & prev
    seg_of_start = _cumsum(is_start) - 1
    seg_of_end = _cumsum(is_end) - 1
    nseg = is_start.sum(dtype=I32)

    ub = _compact_to(seg_of_start, is_start, sorted_keys, WR, nseg)
    ue = _compact_to(seg_of_end, is_end, sorted_keys, WR, nseg)
    seg_valid = _arange(WR, dev) < nseg

    # Merge touching segments (ue[s-1] == ub[s]): the gap between them is a
    # key-empty slot (same key, different point category), so they are one
    # write range semantically — the CPU engine's interval coalescing.
    chain_start = torch.cat([
        torch.ones((1,), dtype=torch.bool, device=dev),
        ~(ue[:, :-1] == ub[:, 1:]).all(dim=0),
    ]) | ~seg_valid
    chain_id = _cumsum(chain_start) - 1
    is_chain_last = torch.cat([
        chain_start[1:], torch.ones((1,), dtype=torch.bool, device=dev)
    ])
    nseg2 = (chain_start & seg_valid).sum(dtype=I32)
    ub = _compact_to(chain_id, chain_start & seg_valid, ub, WR, nseg2)
    ue = _compact_to(chain_id, is_chain_last & seg_valid, ue, WR, nseg2)
    seg_valid = _arange(WR, dev) < nseg2
    return ub, ue, seg_valid


def _merge_prep(tkeys, tvers, tcount, ub, ue, seg_valid, now_rel, *, width, wr_cap,
                search="", search_stride=512):
    """Phase-5 rank-inversion prep: the sorted new-boundary rows and every
    row's merged position, from two combined searches of the segment
    endpoints into the history (searchsorted_words in the ``search`` mode)
    plus streaming cumsums and histograms — never a full-width sort.
    Returns (new_keys_s, new_vers_s, new_valid_s, keep_old, pos_old,
    pos_new, merged_count)."""
    dev = tkeys.device
    kw1 = tkeys.shape[0]
    H = width
    WR = wr_cap
    both = torch.cat([ub, ue], dim=1)
    both_left = searchsorted_words(tkeys, both, "left", mode=search, stride=search_stride)
    both_right = searchsorted_words(tkeys, both, "right", mode=search, stride=search_stride)
    ub_left, ue_left = both_left[:WR], both_left[WR:]
    ub_right, ue_right = both_right[:WR], both_right[WR:]
    end_val = tvers[(ue_right - 1).clamp(0, H - 1).long()]
    eq_at_ue = (ue_right - ue_left) > 0

    # new boundary entries, interleaved (ub0, ue0, ub1, ue1, ...)
    n_new = 2 * WR
    new_keys = torch.stack([ub, ue], dim=2).reshape(kw1, n_new)
    new_vers = torch.stack(
        [torch.full((WR,), 0, dtype=I32, device=dev) + now_rel, end_val], dim=1
    ).reshape(n_new)
    new_vld = torch.stack([seg_valid, seg_valid & ~eq_at_ue], dim=1).reshape(n_new)
    nk = torch.where(new_vld[None, :], new_keys, keylib.INF_DEV)
    nperm = lex_argsort([nk[w] for w in range(kw1)])
    new_keys_s = nk[:, nperm].contiguous()
    new_vers_s = new_vers[nperm]
    nnew = new_vld.sum(dtype=I32)
    new_valid_s = _arange(n_new, dev) < nnew
    # Ranks of the SORTED new keys by permuting the interleaved ranks
    # (invalid rows carry their raw rank; they are masked at every use).
    t_rank = torch.stack([ub_left, ue_left], dim=1).reshape(n_new)[nperm]
    t_rank_r = torch.stack([ub_right, ue_right], dim=1).reshape(n_new)[nperm]

    # Which old boundaries survive (not overwritten by a segment), and where
    # everything lands in the merged order, by rank inversion: difference
    # arrays over the history rows + cumsums.
    old_valid = _arange(H, dev) < tcount
    seg_diff = torch.zeros((H + 1,), dtype=I32, device=dev)
    seg_diff.index_add_(0, torch.where(seg_valid, ub_left, H).long(), seg_valid.to(I32))
    seg_diff.index_add_(0, torch.where(seg_valid, ue_left, H).long(), -seg_valid.to(I32))
    in_seg = _cumsum(seg_diff[:H]) > 0
    keep_old = old_valid & ~in_seg
    cum_keep = _cumsum(keep_old)  # prefix-inclusive
    # count_new_less[i] = #new keys strictly below old key i, via a
    # histogram of the new keys' right ranks.
    new_hist = torch.zeros((H + 1,), dtype=I32, device=dev)
    new_hist.index_add_(
        0, torch.where(new_valid_s, t_rank_r, H).long(), new_valid_s.to(I32)
    )
    pos_old = cum_keep - 1 + _cumsum(new_hist[:H])
    # removed-prefix at rank k = min(k, tcount) - cum_keep[k-1]
    removed_at_t = torch.minimum(t_rank, tcount) - torch.where(
        t_rank > 0, cum_keep[(t_rank - 1).clamp(0, H - 1).long()], 0
    )
    pos_new = _arange(n_new, dev) + (t_rank - removed_at_t)
    merged_count = keep_old.sum(dtype=I32) + nnew
    return (new_keys_s, new_vers_s, new_valid_s, keep_old, pos_old, pos_new,
            merged_count)


def _merge_evict_fused(tkeys, tvers, tcount, ub, ue, seg_valid, now_rel,
                       window, *, width, wr_cap, search="", search_stride=512):
    """Phases 5+6: merge the batch's segment rows into the history and
    apply the removeBefore eviction rule in one kernel pass, then mask the
    rows past the new count to INF / FLOOR_REL."""
    (new_keys_s, new_vers_s, new_valid_s, keep_old, pos_old, pos_new,
     merged_count) = _merge_prep(
        tkeys, tvers, tcount, ub, ue, seg_valid, now_rel,
        width=width, wr_cap=wr_cap, search=search, search_stride=search_stride,
    )
    ok_keys, ok_vers, out_count = fused_merge_evict(
        tkeys, tvers, keep_old.to(I32), pos_old,
        new_keys_s, new_vers_s, new_valid_s.to(I32), pos_new.contiguous(),
        merged_count, window, width=width,
    )
    live = _arange(width, tkeys.device) < out_count
    out_keys = torch.where(live[None, :], ok_keys, keylib.INF_DEV)
    out_vers = torch.where(live, ok_vers, FLOOR_REL)
    return out_keys, out_vers, out_count


def _merge_new_segments(tkeys, tvers, tcount, ub, ue, seg_valid, now_rel, *,
                        width, wr_cap, search="", search_stride=512):
    """Phase 5 of the non-kernel step (``nokernel``): the same prep as the
    kernel step, then one full-width sort by target position places every
    kept row.  Returns (merged_keys, merged_vers, merged_count), rows past
    the count INF / FLOOR_REL."""
    (new_keys_s, new_vers_s, new_valid_s, keep_old, pos_old, pos_new,
     merged_count) = _merge_prep(
        tkeys, tvers, tcount, ub, ue, seg_valid, now_rel,
        width=width, wr_cap=wr_cap, search=search, search_stride=search_stride,
    )
    merged_keys, merged_vers = _compact_to(
        torch.cat([pos_old, pos_new]), torch.cat([keep_old, new_valid_s]),
        torch.cat([tkeys, new_keys_s], dim=1), width, merged_count,
        vers=torch.cat([tvers, new_vers_s]),
    )
    return merged_keys, merged_vers, merged_count


def _evict_rule(merged_vers, merged_count, new_oldest, width):
    """Phase 6's keep predicate (the removeBefore rule: drop row i > 0 iff
    it and its predecessor are both below the window).  Returns (keep,
    rank, out_count)."""
    idx = _arange(width, merged_vers.device)
    prev_v = torch.cat([
        torch.full((1,), FLOOR_REL, dtype=I32, device=merged_vers.device),
        merged_vers[:-1],
    ])
    keep = (idx < merged_count) & (
        (idx == 0) | (merged_vers >= new_oldest) | (prev_v >= new_oldest))
    return keep, _cumsum(keep) - 1, keep.sum(dtype=I32)


def _merge_evict_plain(tkeys, tvers, tcount, ub, ue, seg_valid, now_rel,
                       new_oldest, do_evict, *, width, wr_cap, evict=True,
                       search="", search_stride=512):
    """Phases 5+6 of the non-kernel step: the sort-by-target merge, then
    the eviction rule's compaction sort, unless ``evict`` is False
    (``noevict``).  With ``do_evict`` (a 0-dim tensor: amortized eviction)
    the merged rows are kept where it is 0, as the reference's cond keeps
    them; the select runs on the device, without a host sync."""
    merged_keys, merged_vers, merged_count = _merge_new_segments(
        tkeys, tvers, tcount, ub, ue, seg_valid, now_rel, width=width, wr_cap=wr_cap,
        search=search, search_stride=search_stride)
    if not evict:
        return merged_keys, merged_vers, merged_count
    keep, rank, out_count = _evict_rule(merged_vers, merged_count, new_oldest, width)
    out_keys, out_vers = _compact_to(rank, keep, merged_keys, width, out_count,
                                     vers=merged_vers)
    if do_evict is None:
        return out_keys, out_vers, out_count
    ev = do_evict != 0
    return (torch.where(ev, out_keys, merged_keys), torch.where(ev, out_vers, merged_vers),
            torch.where(ev, out_count, merged_count))


def _out_status(too_old, status):
    """Final statuses in the reference's enum."""
    return torch.where(
        too_old, TOO_OLD, torch.where(status == _COMM, COMMITTED, CONFLICT)
    ).to(I32)


def _witness_vectors(m, r_hist, hist_conf, ib_flag, r_txn, t_valid, too_old,
                     status, now_rel, *, txn_cap, rr_cap):
    """Per-txn abort witness: (conflicting version, losing read-range
    index) for every final-CONFLICT txn, sentinels elsewhere.  A history
    conflict names its FIRST flagged read range at that range's history
    max; an intra-batch conflict names the first read range intersecting
    an earlier final-committed writer, at `now_rel`."""
    dev = m.device
    TXN, RR = txn_cap, rr_cap
    BIG = WITNESS_NONE_RANGE
    r_idx = _arange(RR, dev)
    hist_conf_r = hist_conf[r_txn.clamp(0, TXN - 1).long()]
    elig = torch.where(hist_conf_r, r_hist, ib_flag)
    sel = torch.full((TXN + 1,), BIG, dtype=I32, device=dev)
    sel.scatter_reduce_(
        0, torch.where(elig, r_txn, TXN).long(), torch.where(elig, r_idx, BIG),
        "amin", include_self=True,
    )
    sel = sel[:TXN]
    sel_ok = sel < BIG
    m_sel = m[sel.clamp(0, RR - 1).long()]
    is_conf = t_valid & ~too_old & (status != _COMM) & sel_ok
    w_ver = torch.where(
        is_conf, torch.where(hist_conf, m_sel, now_rel), FLOOR_REL
    ).to(I32)
    w_rng = torch.where(is_conf, sel, BIG).to(I32)
    return w_ver, w_rng


class Decision(NamedTuple):
    """The decide half of one step: the verdicts in the reference's enum,
    the fixpoint's undecided count and iterations, the witness vectors
    (None in the witness-free step), and the committed-write segments (ub,
    ue, seg_valid) the commit half merges.  Nothing in it changes the
    history."""

    status: torch.Tensor
    undecided: torch.Tensor
    iters: torch.Tensor
    w_ver: Optional[torch.Tensor]
    w_rng: Optional[torch.Tensor]
    ub: torch.Tensor
    ue: torch.Tensor
    seg_valid: torch.Tensor


def _decide(m, r_hist, r_begin, r_end, r_txn, w_begin, w_end, w_txn, t_snap,
            t_has_reads, t_valid, oldest, now_rel, *, txn_cap, rr_cap, wr_cap,
            on_sync, ablate=frozenset(), witness=True):
    """Phases 2-4 and, with `witness`, the witness, from phase 1's
    per-range history max `m` and flags `r_hist`."""
    TXN = txn_cap
    hist_conf = _agg_txn(r_hist, r_txn, TXN)
    too_old = t_valid & t_has_reads & (t_snap < oldest)
    status0 = torch.where(
        ~t_valid, _COMM,
        torch.where(too_old | hist_conf, _CONF, _UNDECIDED),
    ).to(I32)
    status, iters, undecided_left, ub, ue, seg_valid, ib_flag = (
        _resolve_batch(
            r_begin, r_end, r_txn, w_begin, w_end, w_txn, t_valid, status0,
            txn_cap=TXN, rr_cap=rr_cap, wr_cap=wr_cap, on_sync=on_sync,
            ablate=ablate, witness=witness,
        )
    )
    w_ver = w_rng = None
    if witness:
        w_ver, w_rng = _witness_vectors(
            m, r_hist, hist_conf, ib_flag, r_txn, t_valid, too_old, status,
            now_rel, txn_cap=TXN, rr_cap=rr_cap,
        )
    return Decision(_out_status(too_old, status), undecided_left, iters,
                    w_ver, w_rng, ub, ue, seg_valid)


def decide_flat(
    hkeys, hvers, oldest,
    r_begin, r_end, r_txn, r_snap,
    w_begin, w_end, w_txn,
    t_snap, t_has_reads, t_valid,
    now_rel,
    *, txn_cap: int, rr_cap: int, wr_cap: int, h_cap: int, on_sync=None,
    ablate=frozenset(), witness=True, search="", search_stride=512,
) -> Decision:
    """The decide half of the flat step: phase 1 against the history, then
    phases 2-4 and, with `witness`, the witness.  `ablate` takes the seams
    of ABLATIONS (module docstring); phase 1 reads ``nosearch`` and
    ``nokernel``, whose plain searches run in the ``search`` mode."""
    H = h_cap
    r_nonempty = lex_less(r_begin, r_end)
    r_valid = r_txn < txn_cap

    # ---- phase 1: history conflicts (ref checkReadConflictRanges) ----
    if "nosearch" in ablate:
        # The reference's uint32 word 0 mod H: unflip the device word.
        i0 = ((r_begin[0].to(torch.int64) + 2**31) % H).to(I32)
        j1 = i0
    elif "nokernel" in ablate:
        i0 = searchsorted_words(hkeys, r_begin, "right", mode=search,
                                stride=search_stride) - 1
        j1 = searchsorted_words(hkeys, r_end, "left", mode=search,
                                stride=search_stride) - 1
    else:
        i0, j1 = phase1_search(hkeys, r_begin, r_end)
    maxtab = build_max_table(hvers)
    m = range_max(maxtab, i0.clamp(0, H - 1), j1.clamp(0, H - 1))
    r_hist = r_valid & r_nonempty & (j1 >= i0) & (m > r_snap)
    return _decide(
        m, r_hist, r_begin, r_end, r_txn, w_begin, w_end, w_txn, t_snap,
        t_has_reads, t_valid, oldest, now_rel, txn_cap=txn_cap,
        rr_cap=rr_cap, wr_cap=wr_cap, on_sync=on_sync, ablate=ablate,
        witness=witness,
    )


def commit_flat(hkeys, hvers, hcount, oldest, dec: Decision, now_rel,
                new_oldest_rel, undecided, *, h_cap: int, wr_cap: int,
                ablate=frozenset(), do_evict=None, search="", search_stride=512):
    """The commit half of the flat step: phases 5-6 (merge + removeBefore
    eviction, one kernel) and the divergence guard.  `undecided` is the
    count the guard reads: the step's own, or the sum over the shards of a
    sharded step.  If it is not 0 the statuses are unreliable and so is the
    write merge derived from them, so the history reverts UNCHANGED and the
    host re-runs the batch on the CPU engine.  `do_evict` (amortized
    eviction) is the blob's 0-dim flag: where it is 0 the batch evicts
    nothing.  `ablate` takes ``nomerge`` (the history comes back unchanged
    and the window advances without the guard), ``noevict`` and
    ``nokernel``.  The merge prep searches in the ``search`` mode.
    Returns (keys, vers, count, oldest)."""
    if "nomerge" in ablate:
        return hkeys, hvers, hcount, torch.maximum(oldest, new_oldest_rel).to(I32)
    new_oldest = torch.maximum(oldest, new_oldest_rel)
    if "nokernel" in ablate:
        out_keys, out_vers, out_count = _merge_evict_plain(
            hkeys, hvers, hcount, dec.ub, dec.ue, dec.seg_valid, now_rel,
            new_oldest, do_evict, width=h_cap, wr_cap=wr_cap,
            evict="noevict" not in ablate, search=search, search_stride=search_stride,
        )
    else:
        # Eviction is the window: FLOOR_REL keeps every row.
        if "noevict" in ablate:
            window = torch.full((), FLOOR_REL, dtype=I32, device=hkeys.device)
        elif do_evict is not None:
            window = torch.where(do_evict != 0, new_oldest, FLOOR_REL).to(I32)
        else:
            window = new_oldest
        out_keys, out_vers, out_count = _merge_evict_fused(
            hkeys, hvers, hcount, dec.ub, dec.ue, dec.seg_valid, now_rel,
            window, width=h_cap, wr_cap=wr_cap, search=search,
            search_stride=search_stride,
        )
    ok = undecided == 0
    return (
        torch.where(ok, out_keys, hkeys),
        torch.where(ok, out_vers, hvers),
        torch.where(ok, out_count, hcount).to(I32),
        torch.where(ok, new_oldest, oldest).to(I32),
    )


def detect_core(
    hkeys, hvers, hcount, oldest,
    r_begin, r_end, r_txn, r_snap,
    w_begin, w_end, w_txn,
    t_snap, t_has_reads, t_valid,
    now_rel, new_oldest_rel, do_evict=None,
    *, txn_cap: int, rr_cap: int, wr_cap: int, h_cap: int, on_sync=None,
    ablate=frozenset(), witness=True, search="", search_stride=512,
):
    """The flat conflict step (the reference detect_core with kernels on):
    decide_flat then commit_flat.  Key words are in the device encoding;
    scalars are 0-dim int32 tensors.  ``do_evict`` None evicts every
    batch; a 0-dim tensor is amortized eviction's flag.  `ablate` is a
    subset of ABLATIONS (module docstring; the default runs the step as
    served).  Returns (out_keys, out_vers, out_count, new_oldest,
    out_status, undecided_left, iters) + (w_ver, w_rng) with `witness`
    (the witness-free step returns neither, as the reference's).  The
    merge prep, and the ``nokernel`` arm's phase 1, search in the
    ``search`` mode with ``search_stride``.  `on_sync` is a zero-argument
    callable giving the context (a sanctioned sync scope) that each of the
    fixpoint's host checks runs in."""
    srch = dict(search=search, search_stride=search_stride)
    dec = decide_flat(
        hkeys, hvers, oldest, r_begin, r_end, r_txn, r_snap, w_begin, w_end,
        w_txn, t_snap, t_has_reads, t_valid, now_rel, txn_cap=txn_cap,
        rr_cap=rr_cap, wr_cap=wr_cap, h_cap=h_cap, on_sync=on_sync,
        ablate=ablate, witness=witness, **srch,
    )
    state = commit_flat(hkeys, hvers, hcount, oldest, dec, now_rel,
                        new_oldest_rel, dec.undecided, h_cap=h_cap, wr_cap=wr_cap,
                        ablate=ablate, do_evict=do_evict, **srch)
    return state + (dec.status, dec.undecided, dec.iters) + _witness_out(dec)


def _witness_out(dec: Decision) -> tuple:
    """A step's trailing witness outputs: (w_ver, w_rng), or () from the
    witness-free step."""
    return () if dec.w_ver is None else (dec.w_ver, dec.w_rng)


# ---------------------------------------------------------------------------
# Two-tier history: a large sorted BASE tier, frozen between major
# compactions (its sparse max table is carried across batches instead of
# rebuilt), plus a small sorted DELTA tier that absorbs each batch's new
# boundaries.  The delta is a step function whose floor value FLOOR_REL
# means "uncovered"; every other delta value is a write version issued
# while the base was frozen, so it exceeds every base value and the logical
# history is exactly merged(x) = max(base(x), delta(x)).  Phase 1 combines
# per-tier range maxima with max; phases 5-6 merge each batch into the
# delta only.  A major compaction folds the delta into the base, evicts
# below the window, rebuilds the table and empties the delta, on the batches
# the host's row-count bounds pick (delta nearly full, or every
# ``evict_every`` batches), so no device sync decides it.
# ---------------------------------------------------------------------------


def _major_compact_inputs(hk, hv, hc, dk, dv, dc, *, H, D, search="", search_stride=512):
    """fused_merge_evict's arguments for a major compaction (A = the base,
    B = the delta), before the window: (hk, hv, keep_base, pos_base, dk,
    dvals, keep_delta, pos_delta, merged_count).

    Covered delta intervals (value above the floor) take the delta row
    verbatim and drop every base row inside them; uncovered intervals keep
    their base rows; a floor-valued delta row re-anchors the base's value
    at its key (dropped when an equal-key base row already provides it).
    Every per-row quantity comes by rank inversion: delta-sized searches
    into the base (in the ``search`` mode) turned into per-base-row values
    by histograms (slot H is the dump) and cumsums."""
    dev = hk.device
    dvalid = _arange(D, dev) < dc
    dl = searchsorted_words(hk, dk, "left", mode=search, stride=search_stride)
    dr = searchsorted_words(hk, dk, "right", mode=search, stride=search_stride)
    covered = dvalid & (dv > FLOOR_REL)
    # Delta interval j spans base ranks [dl[j], dl[j+1]); the last valid
    # row's interval extends to the end of the live base.
    dl_next = torch.cat([dl[1:], hc.to(I32).reshape(1)])
    cov_diff = torch.zeros((H + 1,), dtype=I32, device=dev)
    cov_diff.index_add_(0, torch.where(covered, dl, H).long(), covered.to(I32))
    cov_diff.index_add_(0, torch.where(covered, dl_next, H).long(), -covered.to(I32))
    in_cov = _cumsum(cov_diff[:H]) > 0
    keep_base = (_arange(H, dev) < hc) & ~in_cov
    ckb = _cumsum(keep_base)  # prefix-inclusive

    eq = (dr - dl) > 0  # an equal-key base row exists
    base_at = hv[(dr - 1).clamp(0, H - 1).long()]  # base value at dk[j]
    is_end = dvalid & (dv == FLOOR_REL)
    keep_delta = dvalid & ((dv > FLOOR_REL) | ~eq)
    dvals = torch.where(is_end, base_at, dv)

    # Merge positions by rank inversion (kept keys never tie: the rules
    # above drop exactly one side of every key collision).
    dhist = torch.zeros((H + 1,), dtype=I32, device=dev)
    dhist.index_add_(0, torch.where(keep_delta, dl, H).long(), keep_delta.to(I32))
    pos_base = (ckb - 1) + _cumsum(dhist[:H])
    cnt_base_less = torch.where(dl > 0, ckb[(dl - 1).clamp(0, H - 1).long()], 0)
    pos_delta = (_cumsum(keep_delta) - 1) + cnt_base_less
    merged_count = keep_base.sum(dtype=I32) + keep_delta.sum(dtype=I32)
    return (hk, hv, keep_base.to(I32), pos_base, dk, dvals, keep_delta.to(I32),
            pos_delta, merged_count)


def _major_compact(hk, hv, hc, dk, dv, dc, new_oldest, *, H, D, search="",
                   search_stride=512):
    """Merge base + delta into a new base tier and evict below the window
    ``new_oldest``, in one fused_merge_evict call; rows past the new count
    are INF / FLOOR_REL."""
    k_keys, k_vers, out_count = fused_merge_evict(
        *_major_compact_inputs(hk, hv, hc, dk, dv, dc, H=H, D=D, search=search,
                               search_stride=search_stride),
        new_oldest, width=H,
    )
    live = _arange(H, hk.device) < out_count
    return (torch.where(live[None, :], k_keys, keylib.INF_DEV),
            torch.where(live, k_vers, FLOOR_REL), out_count)


def _empty_delta(kw1, D, dev):
    """A delta tier holding only its floor row b"" at FLOOR_REL."""
    dk = torch.full((kw1, D), keylib.INF_DEV, dtype=I32, device=dev)
    dk[:, 0] = keylib.ZERO_DEV
    dv = torch.full((D,), FLOOR_REL, dtype=I32, device=dev)
    return dk, dv, torch.ones((), dtype=I32, device=dev)


def decide_tiered(
    hkeys, maxtab, dkeys, dvers, oldest,
    r_begin, r_end, r_txn, r_snap,
    w_begin, w_end, w_txn,
    t_snap, t_has_reads, t_valid,
    now_rel,
    *, txn_cap: int, rr_cap: int, wr_cap: int, h_cap: int, d_cap: int,
    on_sync=None, witness=True,
) -> Decision:
    """The decide half of the two-tier step: phase 1 over both tiers with
    one query sort (merged max = max of the per-tier maxima), then phases
    2-4 and, with `witness`, the witness."""
    H, D = h_cap, d_cap
    r_nonempty = lex_less(r_begin, r_end)
    r_valid = r_txn < txn_cap
    (i0b, j1b), (i0d, j1d) = phase1_search_tiers((hkeys, dkeys), r_begin, r_end)
    mb = range_max(maxtab, i0b.clamp(0, H - 1), j1b.clamp(0, H - 1))
    md = range_max(build_max_table(dvers), i0d.clamp(0, D - 1), j1d.clamp(0, D - 1))
    m = torch.maximum(torch.where(j1b >= i0b, mb, FLOOR_REL),
                      torch.where(j1d >= i0d, md, FLOOR_REL))
    r_hist = r_valid & r_nonempty & (m > r_snap)
    return _decide(
        m, r_hist, r_begin, r_end, r_txn, w_begin, w_end, w_txn, t_snap,
        t_has_reads, t_valid, oldest, now_rel, txn_cap=txn_cap,
        rr_cap=rr_cap, wr_cap=wr_cap, on_sync=on_sync, witness=witness,
    )


def commit_tiered(hkeys, hvers, hcount, maxtab, dkeys, dvers, dcount, oldest,
                  dec: Decision, now_rel, new_oldest_rel, undecided, *,
                  do_major: bool, h_cap: int, d_cap: int, wr_cap: int,
                  search="", search_stride=512):
    """The commit half of the two-tier step: phases 5-6 into the delta only
    (one kernel at width D), the divergence guard on `undecided` (as in
    commit_flat), then the major compaction on the host's flag; the delta
    merge prep and the compaction's searches run in the ``search`` mode.
    Returns
    (base keys, base vers, base count, max table, delta keys, delta vers,
    delta count, new_oldest); on a minor batch the base tensors and the
    table are the very ones passed in."""
    kw1 = hkeys.shape[0]
    H, D = h_cap, d_cap
    new_oldest = torch.maximum(oldest, new_oldest_rel)
    srch = dict(search=search, search_stride=search_stride)
    d_keys, d_vers, d_count = _merge_evict_fused(
        dkeys, dvers, dcount, dec.ub, dec.ue, dec.seg_valid, now_rel, new_oldest,
        width=D, wr_cap=wr_cap, **srch,
    )
    # Divergence guard: the delta merge and the window advance revert
    # BEFORE the compaction, so the host can re-run the batch on the CPU
    # engine against the same logical state.
    ok = undecided == 0
    d_keys = torch.where(ok, d_keys, dkeys)
    d_vers = torch.where(ok, d_vers, dvers)
    d_count = torch.where(ok, d_count, dcount).to(I32)
    new_oldest = torch.where(ok, new_oldest, oldest).to(I32)

    # ---- major compaction on the host's flag alone (never on ok): a
    # diverged batch compacts the reverted delta, which rewrites the same
    # logical step function, so the host's bounds stay true ----
    if do_major:
        with region("compaction", "major"):
            hkeys, hvers, hcount = _major_compact(
                hkeys, hvers, hcount, d_keys, d_vers, d_count, new_oldest, H=H, D=D, **srch,
            )
            maxtab = build_max_table(hvers)
            d_keys, d_vers, d_count = _empty_delta(kw1, D, hkeys.device)
    return hkeys, hvers, hcount.to(I32), maxtab, d_keys, d_vers, d_count, new_oldest


def detect_core_tiered(
    hkeys, hvers, hcount, maxtab, dkeys, dvers, dcount, oldest,
    r_begin, r_end, r_txn, r_snap,
    w_begin, w_end, w_txn,
    t_snap, t_has_reads, t_valid,
    now_rel, new_oldest_rel,
    *, do_major: bool, txn_cap: int, rr_cap: int, wr_cap: int, h_cap: int,
    d_cap: int, on_sync=None, witness=True, search="", search_stride=512,
):
    """The two-tier conflict step (the reference detect_core_tiered with
    kernels on); decision-identical to detect_core.  A minor batch does no
    H-wide sort and no H-wide table build: its base work is the phase-1
    search against the frozen base and the carried max table.
    ``do_major`` is the host's compaction flag.  Returns (base keys, base
    vers, base count, max table, delta keys, delta vers, delta count,
    new_oldest, out_status, undecided_left, iters) + (w_ver, w_rng) with
    `witness`; ``search`` as detect_core's."""
    dec = decide_tiered(
        hkeys, maxtab, dkeys, dvers, oldest, r_begin, r_end, r_txn, r_snap,
        w_begin, w_end, w_txn, t_snap, t_has_reads, t_valid, now_rel,
        txn_cap=txn_cap, rr_cap=rr_cap, wr_cap=wr_cap, h_cap=h_cap,
        d_cap=d_cap, on_sync=on_sync, witness=witness,
    )
    state = commit_tiered(
        hkeys, hvers, hcount, maxtab, dkeys, dvers, dcount, oldest, dec,
        now_rel, new_oldest_rel, dec.undecided, do_major=do_major,
        h_cap=h_cap, d_cap=d_cap, wr_cap=wr_cap, search=search,
        search_stride=search_stride,
    )
    return state + (dec.status, dec.undecided, dec.iters) + _witness_out(dec)


def blob_words(pb: PackedBatch) -> int:
    """Length in uint32 words of a batch's blob (see _blob_offsets)."""
    return _blob_offsets(pb.txn_cap, pb.rr_cap, pb.wr_cap, pb.key_words + 1)[1]


def fill_blob(blob: np.ndarray, pb: PackedBatch, base: int, now: int,
              new_oldest_version: int, flag: int) -> np.ndarray:
    """Write a batch into `blob` (blob_words(pb) uint32 words) in the
    layout of _blob_offsets, byte-identical to the reference engine's blob:
    versions relative to `base`, clipped above the floor; ``flag`` is the
    third scalar.  Returns `blob`."""
    def rel(v):
        return np.clip(v - base, FLOOR_REL + 1, 2**31 - 2)

    r_snap = rel(pb.r_snap).astype(np.int32)
    t_snap = rel(pb.t_snap).astype(np.int32)
    t_flags = pb.t_has_reads.astype(np.uint32) | (pb.t_valid.astype(np.uint32) << 1)
    kw1 = pb.key_words + 1
    rr, wr = pb.rr_cap, pb.wr_cap
    o = 0
    for arr in (pb.r_begin, pb.r_end):
        np.copyto(blob[o : o + kw1 * rr].reshape(kw1, rr), arr.T)
        o += kw1 * rr
    for arr in (pb.w_begin, pb.w_end):
        np.copyto(blob[o : o + kw1 * wr].reshape(kw1, wr), arr.T)
        o += kw1 * wr
    for arr in (
        pb.r_txn.view(np.uint32),
        r_snap.view(np.uint32),
        pb.w_txn.view(np.uint32),
        t_snap.view(np.uint32),
        t_flags,
    ):
        blob[o : o + arr.shape[0]] = arr
        o += arr.shape[0]
    blob[o : o + 3] = np.array(
        [int(rel(now)), int(rel(new_oldest_version)), flag], np.int32
    ).view(np.uint32)
    assert o + 3 == blob.shape[0]
    return blob


def _unpack_blob(blob, txn_cap, rr_cap, wr_cap, kw1):
    """The step inputs from the single-transfer blob (int32 bit patterns
    on the device), key fields flipped into the device word encoding:
    (r_begin, r_end, r_txn, r_snap, w_begin, w_end, w_txn, t_snap,
    t_has_reads, t_valid, now_rel, new_oldest_rel).  The blob's third
    scalar (the host's flag, its last word) is not unpacked here: see
    _blob_core."""
    offs, _total = _blob_offsets(txn_cap, rr_cap, wr_cap, kw1)

    def field(i, n):
        return blob[offs[i] : offs[i] + n]

    def key_field(i, cap):
        return keylib.flip_words(field(i, cap * kw1).reshape(kw1, cap))

    t_flags = field(8, txn_cap)
    scalars = field(9, 3)
    return (
        key_field(0, rr_cap), key_field(1, rr_cap),
        field(4, rr_cap), field(5, rr_cap),
        key_field(2, wr_cap), key_field(3, wr_cap), field(6, wr_cap),
        field(7, txn_cap), (t_flags & 1) > 0, (t_flags & 2) > 0,
        scalars[0], scalars[1],
    )


def _blob_core(hkeys, hvers, hcount, oldest, blob, *, txn_cap, rr_cap,
               wr_cap, h_cap, kw1, on_sync=None, amortized=False,
               ablate=frozenset(), witness=True, search="", search_stride=512):
    """The flat step on one blob.  ``amortized`` reads the blob's last
    word, the host's flag, as do_evict (the reference reads it only then);
    `ablate`, `witness` and ``search`` as detect_core."""
    return detect_core(
        hkeys, hvers, hcount, oldest,
        *_unpack_blob(blob, txn_cap, rr_cap, wr_cap, kw1),
        blob[-1] if amortized else None,
        txn_cap=txn_cap, rr_cap=rr_cap, wr_cap=wr_cap, h_cap=h_cap,
        on_sync=on_sync, ablate=ablate, witness=witness, search=search,
        search_stride=search_stride,
    )


def _tiered_blob_core(hkeys, hvers, hcount, maxtab, dkeys, dvers, dcount,
                      oldest, blob, *, do_major, txn_cap, rr_cap, wr_cap,
                      h_cap, d_cap, kw1, on_sync=None, witness=True, search="",
                      search_stride=512):
    """The tiered step on one blob (the flat layout; its third scalar
    carries ``do_major``)."""
    return detect_core_tiered(
        hkeys, hvers, hcount, maxtab, dkeys, dvers, dcount, oldest,
        *_unpack_blob(blob, txn_cap, rr_cap, wr_cap, kw1),
        do_major=do_major, txn_cap=txn_cap, rr_cap=rr_cap, wr_cap=wr_cap,
        h_cap=h_cap, d_cap=d_cap, on_sync=on_sync, witness=witness, search=search,
        search_stride=search_stride,
    )


def _rebase_core(vers, d):
    """Versions shifted down by the host's rebase amount `d`, floored."""
    return torch.clamp(vers - d, min=FLOOR_REL)


def _grow_core(buf, *, pad: int, fill: int):
    """`buf` with `pad` columns of `fill` appended along its last axis."""
    tail = torch.full((*buf.shape[:-1], pad), fill, dtype=buf.dtype, device=buf.device)
    return torch.cat([buf, tail], dim=-1)


def fold_delta_over_base(bkeys, bvers, dkeys, dvers_rel, base):
    """Fold a decoded delta tier over a decoded base tier into the merged
    logical step function (keys, absolute versions): the host twin of
    _major_compact's rules, without eviction.  ``bvers`` are absolute,
    ``dvers_rel`` relative (FLOOR_REL = uncovered)."""
    n = len(bkeys)
    nd = len(dkeys)
    out_k: list = []
    out_v: list = []
    for j in range(nd):
        lo = dkeys[j]
        hi = dkeys[j + 1] if j + 1 < nd else None
        vrel = int(dvers_rel[j])
        if vrel != FLOOR_REL:
            # Covered interval: the delta value dominates everything under
            # it (a write version issued after the base froze).
            out_k.append(lo)
            out_v.append(vrel + base)
            continue
        i0 = bisect_left(bkeys, lo)
        if not (i0 < n and bkeys[i0] == lo):
            out_k.append(lo)
            out_v.append(bvers[max(0, i0 - 1)])
        i1 = n if hi is None else bisect_left(bkeys, hi)
        out_k.extend(bkeys[i0:i1])
        out_v.extend(bvers[i0:i1])
    return out_k, out_v


# ---------------------------------------------------------------------------
# Host wrapper
# ---------------------------------------------------------------------------


def _counter(name: str):
    """Read-only attribute for one counter of the engine's registry."""
    return property(lambda self: self.metrics.counter(name).value)


class _StagingRing:
    """Host buffers for the blobs of one length, handed out round-robin.
    On CUDA they are pinned, uploads from them do not block, and each
    buffer keeps the event of its last upload, which must have completed
    before the buffer is written again.  On the CPU they are plain numpy
    arrays that the step reads in place."""

    __slots__ = ("views", "pinned", "events", "pos")

    def __init__(self, nwords: int, size: int, cuda: bool):
        if cuda:
            self.pinned = [torch.empty((nwords,), dtype=I32, pin_memory=True)
                           for _ in range(size)]
            self.views = [b.numpy().view(np.uint32) for b in self.pinned]
            self.events = [torch.cuda.Event() for _ in range(size)]
        else:
            self.pinned = self.events = None
            self.views = [np.empty((nwords,), np.uint32) for _ in range(size)]
        self.pos = 0


class TorchConflictSet:
    """Host wrapper owning the device-resident history state.

    ``device=None`` means the GPU (construction raises without one);
    ``device="cpu"`` runs the same step with the kernels' plain twins.

    ``history`` is ``"flat"`` (one sorted history) or ``"tiered"`` (a
    frozen base plus a delta tier of ``delta_cap`` rows, 0 meaning
    ``max(64, h_cap // 8)``, folded into the base by a major compaction
    when the delta may not fit the next batch and every ``evict_every``
    batches; ``evict_every=1`` means on fill only).  In flat mode
    ``evict_every`` > 1 is the reference's amortized eviction: every
    ``evict_every``-th batch evicts below the window and the others keep
    their merged rows (decisions are the same: a row below the window
    conflicts with no snapshot the window admits).  ``pipeline_depth``
    sizes the blob staging ring (depth + 1 buffers per blob length, at
    least 2).  ``ablate`` (a subset of ABLATIONS, flat only) runs every
    dispatch with those seams cut, as the reference's FDB_TPU_ABLATE does;
    phase_attribution.attribute_phases passes its arms per call instead.

    ``witness`` (the reference's FDB_TPU_WITNESS, on by default) makes the
    step compute the per-txn abort witness and the readback decode it into
    ``last_witness``; off, the step runs without the witness's stabbing and
    vectors, the readback is ``_HEAD + txn_cap`` words, and
    ``last_witness`` stays ``[]`` (after a CPU fallback too).  ``search``
    and ``search_stride`` (FDB_TPU_SEARCH, FDB_TPU_SEARCH_STRIDE) pick the
    form of the step's plain multiword searches (ops/rangequery.py
    SEARCH_MODES): the merge prep's, the major compaction's and the
    ``nokernel`` arm's phase 1; the kernels and their plain twins are not
    affected.

    Counters live in ``metrics``, a registry named ``TorchConflict`` with
    the reference engine's counter names; ``batches``, ``fixpoint_rounds``,
    ``cpu_fallbacks``, ``host_syncs``, ``grows`` and ``rebases`` read them.
    ``host_syncs`` counts each blocking device-to-host read (one per batch
    readback, one per fixpoint check, the bound refreshes and diagnostic
    exports) and each wait on a staging buffer's upload that had not
    finished; ``host_allocs`` counts the host buffers the staging ring and
    the readback pool allocate, and stays flat once both are populated.
    Every such read runs in ``_sanctioned_sync``'s scope.

    ``transfer_guard`` (the reference's FDB_TPU_TRANSFER_GUARD, off by
    default) wraps each ticket's ``out`` and ``host`` in GuardedDeviceValue
    proxies that raise TransferGuardError on a host read outside a
    sanctioned scope; on CUDA the sanctioned scopes also turn the sync
    debug mode off inside ConflictSet's armed dispatch.

    Device faults.  ``fault_injector`` (device_faults.DeviceFaultInjector)
    is consulted at the reference's choke points, in its order, before any
    state changes: ``dispatch`` first in dispatch_packed, ``rebase`` when a
    rebase shifts the versions, ``grow`` first in _grow and _grow_delta
    (load_from's grow included), ``compile`` at the first dispatch of a
    shape.  Real device failures map into the same taxonomy: an
    out-of-memory error at grow, rebase or dispatch is ``DeviceOOM``, and a
    lost or reset card (``device.is_lost_device``: four cudaError_t codes)
    in dispatch_packed's step, as the reference maps a JaxRuntimeError
    there, is ``CompileFailed`` at a shape's first dispatch and
    ``DeviceUnavailable`` after it.  Any other exception propagates
    unchanged: a failed kernel build, a kernel launch error (no image for
    this card, a launch configuration it refuses) and any other CUDA error
    are faults of the code or the build, and the breaker would hide them
    behind the CPU mirror.  The readbacks map nothing, as the reference's
    do not: ConflictSet maps a lost card at the pipelined sync itself."""

    batches = _counter("batches")
    fixpoint_rounds = _counter("fixpoint_rounds")
    cpu_fallbacks = _counter("cpu_fallbacks")
    host_syncs = _counter("host_syncs")
    host_allocs = _counter("host_allocs")
    grows = _counter("grows")
    rebases = _counter("rebases")

    def __init__(
        self,
        oldest_version: int = 0,
        key_words: int = 4,
        h_cap: int = 1 << 16,
        device=None,
        bucket_mins: tuple = (8, 8, 8),
        history: str = "flat",
        delta_cap: int = 0,
        evict_every: int = 1,
        pipeline_depth: int = 2,
        ablate=frozenset(),
        witness: bool = True,
        search: str = "",
        search_stride: int = 512,
        transfer_guard: bool = False,
    ):
        if history not in ("flat", "tiered"):
            raise ValueError(f"unknown history mode {history!r}")
        if evict_every < 1:
            raise ValueError(f"evict_every must be at least 1, got {evict_every}")
        check_search(search, search_stride)
        self.witness = witness
        self.transfer_guard = transfer_guard
        self.search, self.search_stride = search, search_stride
        self.ablate = check_ablate(ablate)
        if history == "tiered" and self.ablate:
            raise ValueError("ablate is not supported with history='tiered' (the "
                             "ablation seams live in the flat step only)")
        self.device = resolve_device(device)
        self.key_words = key_words
        self.h_cap = h_cap
        self.bucket_mins = bucket_mins
        self.tiered = history == "tiered"
        # Flat: the eviction cadence (amortized when above 1) and the
        # batches since the last evicting one.  Tiered: the compaction
        # cadence (0 = fill-triggered only) and delta capacity, as the
        # reference derives them from its knobs.
        self.evict_every = evict_every
        self._batches_since_evict = 0
        self.compact_every = evict_every if self.tiered and evict_every > 1 else 0
        self.d_cap = max(64, delta_cap if delta_cap > 0 else h_cap // 8) if self.tiered else 0
        self.pipeline_depth = max(1, pipeline_depth)
        self._base = oldest_version  # absolute version of rel 0
        self.last_witness: list = []
        self.last_iters = 0
        self.metrics = MetricsRegistry("TorchConflict")
        for name in ("retraces", "batches", "transactions", "fixpoint_rounds",
                     "grows", "rebases", "cpu_fallbacks", "rehydrate_keys_total",
                     "rehydrate_keys_encoded", "mirror_sync_keys_encoded",
                     "host_syncs", "host_allocs"):
            self.metrics.counter(name)  # pre-create: snapshots list them all
        if self.tiered:
            self.metrics.counter("major_compactions")
        # Static shape key -> dispatch count; a key's first dispatch is the
        # `compile` fault site.
        self._bucket_dispatches: dict = {}
        self.fault_injector = None
        # Padding occupancy of the last dispatch (live rows / capacity).
        self.last_occupancy: dict = {}
        # The last completed "dispatch" span: the parent phase attribution
        # hangs its per-phase spans from.  None until the first dispatch.
        self.last_dispatch_span = None
        # The seq extent of this engine's host-phase spans (encode,
        # readback, and the ConflictSet's mirror_apply): hub sequence
        # numbers, never wall time, so the Resolver's host_fraction gauge
        # is deterministic.
        self.host_phase_seq = 0
        # Stamp of the MirrorSnapshot this device state equals.
        self._synced_stamp = None
        # Blob staging rings by blob length, the ring and slot of the blob
        # last staged, and pinned readback buffers (with their events) by
        # readback length, free for the next dispatch.
        self._blob_ring: dict = {}
        self._staged = None
        self._readback_pool: dict = {}
        # Flat mode's row-count bound bookkeeping: the running sum of every
        # dispatch's bound increment, and a counter of state adoptions (a
        # ticket from before one cannot tighten the bound).
        self._bound_added = 0
        self._epoch = 0
        self._no_delta = torch.zeros((), dtype=I32, device=self.device)
        self._init_state(oldest_rel=0)

    # -- state management --
    def _init_state(self, oldest_rel: int):
        kw1 = self.key_words + 1
        hkeys = np.full((kw1, self.h_cap), keylib.INF_WORD, np.uint32)
        hkeys[:, 0] = 0  # b"" floor boundary
        hvers = np.full((self.h_cap,), FLOOR_REL, np.int32)
        self._adopt(hkeys, hvers, 1, oldest_rel)

    def _adopt(self, hkeys_u32, hvers_i32, hcount: int, oldest_rel: int):
        dev = self.device
        self._hkeys = torch.from_numpy(
            keylib.to_device_words(hkeys_u32).copy()
        ).to(dev)
        self._hvers = torch.from_numpy(np.array(hvers_i32, np.int32)).to(dev)
        self._hcount = torch.tensor(hcount, dtype=I32, device=dev)
        self._oldest = torch.tensor(oldest_rel, dtype=I32, device=dev)
        # Host-side UPPER BOUND on the boundary count (each batch adds at
        # most 2*wr_cap); the true value is synced only when the bound
        # approaches capacity.
        self._hcount_bound = hcount
        self._epoch += 1
        if self.tiered:
            self._reset_delta_state(hvers_i32)

    def _reset_delta_state(self, hvers_np):
        """(Re)build the tiered extras: the base's max table (on the host),
        an empty delta tier and the host bounds that drive compaction and
        growth without device syncs."""
        dev = self.device
        self._maxtab = torch.from_numpy(build_max_table_np(hvers_np)).to(dev)
        self._dkeys, self._dvers, self._dcount = _empty_delta(
            self.key_words + 1, self.d_cap, dev)
        self._dcount_bound = 1
        self._batches_since_major = 0

    def load_state(self, state) -> None:
        """Adopt a carried state (conflict/state.py ConflictState)."""
        kw1, h_cap = state.hkeys.shape
        if kw1 != self.key_words + 1:
            raise ValueError(f"state has {kw1} key words, engine {self.key_words + 1}")
        self.h_cap = h_cap
        self._base = state.base
        self._hkeys = state.hkeys.to(self.device)
        self._hvers = state.hvers.to(self.device)
        self._hcount = torch.tensor(state.hcount, dtype=I32, device=self.device)
        self._oldest = torch.tensor(state.oldest, dtype=I32, device=self.device)
        self._hcount_bound = state.hcount
        self._epoch += 1
        if self.tiered:
            self._reset_delta_state(state.hvers.cpu().numpy())

    def export_state(self):
        """(hkeys uint32 (kw1, h_cap), hvers int32 (h_cap,), hcount, oldest
        (relative), base) — the numpy form the reference engine holds; in
        tiered mode the base tier."""
        with self._sanctioned_sync("export"):
            return (
                keylib.from_device_words(self._hkeys.cpu().numpy()),
                self._hvers.cpu().numpy().copy(),
                int(self._hcount),
                int(self._oldest),
                self._base,
            )

    @property
    def oldest_version(self) -> int:
        with self._sanctioned_sync("oldest"):
            return int(self._oldest) + self._base

    @property
    def boundary_count(self) -> int:
        """The exact logical boundary count (tiered: the merged view, an
        O(rows) host fold — a diagnostic, not a hot path)."""
        if self.tiered:
            return len(self._merged_host_state()[0])
        with self._sanctioned_sync("boundary count"):
            return int(self._hcount)

    @property
    def boundary_count_bound(self) -> int:
        """A cheap upper bound on the logical boundary count (exact in flat
        mode and right after a major compaction)."""
        with self._sanctioned_sync("boundary count bound"):
            if self.tiered:
                hc, dc = torch.stack([self._hcount, self._dcount]).tolist()
                return hc + dc - 1
            return int(self._hcount)

    def _sanctioned_sync(self, op: str):
        """The scope of one declared blocking device->host read (`op` names
        it), as the reference's: it counts ``host_syncs`` and opens
        ``g_hostguard.allowed()``, the only place a guarded ticket value may
        be read.  On CUDA with ``transfer_guard`` on it also turns the sync
        debug mode off inside the dispatch's armed window, restoring the
        previous mode on exit, an exception's included."""
        self.metrics.counter("host_syncs").add()
        scope = ExitStack()
        scope.enter_context(g_hostguard.allowed())
        if self.arms_cuda_guard:
            scope.enter_context(cuda_sync_debug_mode(0))
        return scope

    @property
    def arms_cuda_guard(self) -> bool:
        """Whether the transfer guard uses CUDA's sync debug mode: on, on
        a CUDA device."""
        return self.transfer_guard and self.device.type == "cuda"

    def _check_fault(self, site: str):
        if self.fault_injector is not None:
            self.fault_injector.check(site)

    def clear(self, version: int):
        self._base = version
        self._init_state(oldest_rel=0)

    def _maybe_grow_or_rebase(self, now: int, wr_cap: int):
        if now - self._base > REBASE_THRESHOLD:
            with self._sanctioned_sync("rebase oldest"):
                d = int(self._oldest)
            if d > 0:
                self._check_fault("rebase")
                self.metrics.counter("rebases").add()
                try:
                    self._hvers = _rebase_core(self._hvers, d)
                    if self.tiered:
                        # Rebase commutes with max: the delta and the
                        # carried table shift by the same constant.
                        self._dvers = _rebase_core(self._dvers, d)
                        self._maxtab = _rebase_core(self._maxtab, d)
                except torch.OutOfMemoryError as e:
                    raise DeviceOOM(f"cuda: {e}", site="rebase") from e
                self._oldest = self._oldest - d
                self._base += d
        if self.tiered:
            return  # tiered growth is decided by _plan_tiered_batch
        # Must-fit guard: this batch's merge adds at most 2*wr_cap rows.
        if self._hcount_bound + 2 * wr_cap + 2 > self.h_cap:
            with self._sanctioned_sync("must-fit count"):
                self._hcount_bound = int(self._hcount)
            if self._hcount_bound + 2 * wr_cap + 2 > self.h_cap:
                self._grow(max(self.h_cap * 2, self.h_cap + 4 * wr_cap))

    def _plan_tiered_batch(self, wr_cap: int) -> int:
        """Compaction and growth planning for one tiered batch; returns
        do_major (0/1).  Driven by row-count UPPER BOUNDS (the delta grows
        by at most 2*wr_cap a batch, the base only at compactions, by at
        most the delta's bound), syncing the true counts only when a
        bound-based trigger fires."""
        add = 2 * wr_cap
        # This batch's merge must fit the delta outright.
        if 2 * add + 8 > self.d_cap:
            self._grow_delta(_next_pow2(2 * add + 8, self.d_cap * 2))
        # A batch of a larger bucket than the ones that filled the delta
        # may not fit although the fill trigger below never fired, and the
        # merge runs before the compaction: sync the true count and grow.
        if self._dcount_bound + add + 2 > self.d_cap:
            with self._sanctioned_sync("delta count"):
                self._dcount_bound = int(self._dcount)
            if self._dcount_bound + add + 2 > self.d_cap:
                self._grow_delta(_next_pow2(self._dcount_bound + add + 2, self.d_cap * 2))
        do_major = 0
        if self.compact_every and self._batches_since_major + 1 >= self.compact_every:
            do_major = 1
        # Fill trigger: compact now if the batch after this one might not
        # fit.
        if self._dcount_bound + 2 * add + 2 > self.d_cap:
            do_major = 1
        if do_major:
            need = self._hcount_bound + self._dcount_bound + add + 2
            if need > self.h_cap:
                # The true counts, once, before paying a grow.
                with self._sanctioned_sync("tier counts"):
                    self._hcount_bound, self._dcount_bound = (
                        torch.stack([self._hcount, self._dcount]).tolist())
                need = self._hcount_bound + self._dcount_bound + add + 2
                if need > self.h_cap:
                    self._grow(max(self.h_cap * 2, _next_pow2(need, self.h_cap)))
        return do_major

    def _grow(self, new_cap: int, rebuild_maxtab: bool = True):
        """Grow the (base) history to new_cap rows.  In tiered mode the
        carried table's level count follows h_cap, so it is rebuilt from
        the grown versions, unless the caller replaces the whole state
        next (load_from)."""
        self._check_fault("grow")
        self.metrics.counter("grows").add()
        pad = new_cap - self.h_cap
        try:
            hkeys = _grow_core(self._hkeys, pad=pad, fill=keylib.INF_DEV)
            hvers = _grow_core(self._hvers, pad=pad, fill=FLOOR_REL)
            maxtab = None
            if self.tiered and rebuild_maxtab:
                with self._sanctioned_sync("max table rebuild"):
                    maxtab = torch.from_numpy(
                        build_max_table_np(hvers.cpu().numpy())).to(self.device)
        except torch.OutOfMemoryError as e:
            raise DeviceOOM(f"cuda: {e}", site="grow") from e
        self._hkeys, self._hvers = hkeys, hvers
        self.h_cap = new_cap
        if maxtab is not None:
            self._maxtab = maxtab

    def _grow_delta(self, new_cap: int):
        """Grow the delta tier (a batch's wr_cap exceeded what it can
        absorb); a grow fault site like _grow."""
        self._check_fault("grow")
        self.metrics.counter("grows").add()
        pad = new_cap - self.d_cap
        try:
            dkeys = _grow_core(self._dkeys, pad=pad, fill=keylib.INF_DEV)
            dvers = _grow_core(self._dvers, pad=pad, fill=FLOOR_REL)
        except torch.OutOfMemoryError as e:
            raise DeviceOOM(f"cuda: {e}", site="grow") from e
        self._dkeys, self._dvers = dkeys, dvers
        self.d_cap = new_cap

    # -- detection --
    def detect(
        self,
        transactions: List[TransactionConflictInfo],
        now: int,
        new_oldest_version: int,
    ) -> List[int]:
        pb = self._pack(transactions)
        statuses = self.detect_packed(pb, now, new_oldest_version)
        return [int(s) for s in statuses[: len(transactions)]]

    def _pack(self, transactions) -> PackedBatch:
        """The batch as a PackedBatch, under an "encode" span (a host
        phase)."""
        mt, mr, mw = self.bucket_mins
        with begin_span("encode", attrs={"n_txn": len(transactions)}) as esp:
            pb = PackedBatch.from_transactions(
                transactions, self.key_words, min_txn=mt, min_rr=mr, min_wr=mw,
            )
        self._note_host_span(esp)
        return pb

    def _note_host_span(self, sp) -> None:
        """Fold a host-phase span into host_phase_seq: its seq extent only
        (a disabled hub's NULL_SPAN adds nothing)."""
        if sp.seq is not None and sp.end_seq is not None:
            self.host_phase_seq += sp.end_seq - sp.seq

    @hot_path(bound="const")
    def _staging_blob(self, nwords: int) -> np.ndarray:
        """The next staging buffer for a blob of nwords (see _StagingRing),
        populating the ring on first use.  On CUDA, a buffer whose last
        upload has not finished is waited for (a host sync)."""
        ring = self._blob_ring.get(nwords)
        if ring is None:
            size = max(2, self.pipeline_depth + 1)
            self.metrics.counter("host_allocs").add(size)
            ring = self._blob_ring[nwords] = _StagingRing(
                nwords, size, self.device.type == "cuda")
        slot = ring.pos
        ring.pos = (slot + 1) % len(ring.views)
        if ring.events is not None and not ring.events[slot].query():
            with self._sanctioned_sync("staging buffer"):
                ring.events[slot].synchronize()
        self._staged = (ring, slot)
        return ring.views[slot]

    def _upload(self, blob: np.ndarray) -> torch.Tensor:
        """The blob just staged, on the device: the buffer itself on the
        CPU; on CUDA a non-blocking copy from its pinned buffer, whose
        event then guards the buffer's reuse."""
        if self.device.type != "cuda":
            return torch.from_numpy(blob.view(np.int32))
        ring, slot = self._staged
        blob_dev = ring.pinned[slot].to(self.device, non_blocking=True)
        ring.events[slot].record()
        return blob_dev

    @hot_path(bound="batch")
    def _pack_blob(self, pb: PackedBatch, now: int, new_oldest_version: int,
                   flag: int = 1) -> np.ndarray:
        """Single contiguous uint32 blob for one-copy dispatch (fill_blob),
        written into a staging buffer.  ``flag`` is the third scalar: in
        flat mode do_evict, in tiered mode the compaction flag."""
        blob = self._staging_blob(blob_words(pb))
        return fill_blob(blob, pb, self._base, now, new_oldest_version, flag)

    def dispatch_packed(self, pb: PackedBatch, now: int,
                        new_oldest_version: int) -> DispatchTicket:
        """Run one batch's step on the device without reading its results
        back; returns its DispatchTicket.  The fixpoint makes its own small
        host checks (one after each chunk of rounds)."""
        self._check_fault("dispatch")
        self._maybe_grow_or_rebase(now, pb.wr_cap)
        # The tiered plan runs before the shape key: a grow changes it.
        do_major = self._plan_tiered_batch(pb.wr_cap) if self.tiered else 0
        kw1 = self.key_words + 1
        amortized = not self.tiered and self.evict_every > 1
        if self.tiered:
            shape_key = (pb.bucket(), self.h_cap, kw1, "tiered", self.d_cap)
        else:
            shape_key = (pb.bucket(), self.h_cap, kw1, amortized)
        first_dispatch = shape_key not in self._bucket_dispatches
        if first_dispatch:
            # Registered only after the dispatch succeeds, so the retry of
            # a faulted first dispatch is a first dispatch again.
            self._check_fault("compile")
        m = self.metrics
        m.counter("batches").add()
        m.counter("transactions").add(pb.n_txn)
        self.last_occupancy = {
            "txn": pb.n_txn / pb.txn_cap,
            "read": pb.n_r / pb.rr_cap,
            "write": pb.n_w / pb.wr_cap,
        }
        if self.tiered:
            # Delta fill, from the bound: no sync on the dispatch path.
            self.last_occupancy["delta"] = self._dcount_bound / self.d_cap
        for axis, occ in self.last_occupancy.items():
            m.histogram(f"{axis}_occupancy").add(occ)
        flag = do_major
        if not self.tiered:
            # The reference's eviction cadence (1: every batch evicts).
            self._batches_since_evict += 1
            flag = 1 if self._batches_since_evict >= self.evict_every else 0
            if flag:
                self._batches_since_evict = 0
        blob = self._pack_blob(pb, now, new_oldest_version, flag)
        # The dispatch span: the upload and the step's enqueue, with the
        # fixpoint's host checks (no readback).  It parents to the batch
        # span on the hub's stack, and phase attribution's spans to it.
        dspan = begin_span("dispatch", attrs={"n_txn": pb.n_txn, "version": now,
                                              "first_dispatch": int(first_dispatch)})
        caps = dict(txn_cap=pb.txn_cap, rr_cap=pb.rr_cap, wr_cap=pb.wr_cap,
                    h_cap=self.h_cap, kw1=kw1,
                    on_sync=partial(self._sanctioned_sync, "fixpoint check"),
                    witness=self.witness, search=self.search,
                    search_stride=self.search_stride)
        try:
            blob_dev = self._upload(blob)
            if self.tiered:
                outs = _tiered_blob_core(
                    self._hkeys, self._hvers, self._hcount, self._maxtab,
                    self._dkeys, self._dvers, self._dcount, self._oldest,
                    blob_dev, do_major=bool(do_major), d_cap=self.d_cap, **caps,
                )
                (hkeys, hvers, hcount, maxtab, dkeys, dvers, dcount, oldest,
                 statuses, undecided, iters), wit = outs[:11], outs[11:]
            else:
                outs = _blob_core(
                    self._hkeys, self._hvers, self._hcount, self._oldest,
                    blob_dev, amortized=amortized, ablate=self.ablate, **caps,
                )
                (hkeys, hvers, hcount, oldest, statuses, undecided, iters), wit = (
                    outs[:7], outs[7:])
                dcount = self._no_delta
            out = torch.cat([torch.stack([undecided, iters, hcount, dcount]),
                             statuses, *wit])
        except torch.OutOfMemoryError as e:
            dspan.end(attrs={"error": "OutOfMemoryError"})
            raise DeviceOOM(f"cuda: {e}", site="dispatch") from e
        except RuntimeError as e:
            # A lost or reset card (and only that: any other error is a
            # fault of the code and propagates) in the step, its launches
            # or the fixpoint's host checks: the reference's mapping of a
            # JaxRuntimeError.  The carried tensors stay as they were; the
            # caller marks the device stale and rehydrates before reuse.
            if not is_lost_device(e):
                raise
            dspan.end(attrs={"error": type(e).__name__})
            kind = CompileFailed if first_dispatch else DeviceUnavailable
            raise kind(f"cuda: {e}", site="compile" if first_dispatch
                       else "dispatch") from e
        dspan.end()
        self.last_dispatch_span = dspan
        self._hkeys, self._hvers, self._hcount, self._oldest = hkeys, hvers, hcount, oldest
        if self.tiered:
            self._maxtab, self._dkeys, self._dvers, self._dcount = maxtab, dkeys, dvers, dcount
        if first_dispatch:
            self._bucket_dispatches[shape_key] = 0
            m.counter("retraces").add()
        self._bucket_dispatches[shape_key] += 1
        add = 2 * pb.wr_cap
        if not self.tiered:
            self._hcount_bound = min(self._hcount_bound + add, self.h_cap)
            self._bound_added += add
        elif do_major:
            # The compaction folded the delta (and this batch's rows) into
            # the base and emptied the delta.
            m.counter("major_compactions").add()
            self._hcount_bound = min(self._hcount_bound + self._dcount_bound + add, self.h_cap)
            self._dcount_bound = 1
            self._batches_since_major = 0
        else:
            self._dcount_bound = min(self._dcount_bound + add, self.d_cap)
            self._batches_since_major += 1
        return self._ticket(pb, now, new_oldest_version, out)

    def _ticket(self, pb, now, new_oldest_version, out) -> DispatchTicket:
        """The ticket of the batch just dispatched.  On CUDA its readback
        buffer's copy into a pinned host buffer (from the free pool, or a
        new one) is enqueued here, behind the step.  With the transfer
        guard on, ``out`` and ``host`` are GuardedDeviceValue proxies, read
        only in a sanctioned scope: ``host`` is in flight until ``ready``
        fires, so an early read of it would be stale, not merely a sync."""
        host = ready = None
        if self.device.type == "cuda":
            pool = self._readback_pool.setdefault(out.shape[0], [])
            if pool:
                host, ready = pool.pop()
            else:
                self.metrics.counter("host_allocs").add()
                host = torch.empty(out.shape, dtype=I32, pin_memory=True)
                ready = torch.cuda.Event()
            host.copy_(out, non_blocking=True)
            ready.record()
        if self.transfer_guard:
            out = GuardedDeviceValue(out, "DispatchTicket.out")
            if host is not None:
                host = GuardedDeviceValue(host, "DispatchTicket.host")
        return DispatchTicket(pb, now, new_oldest_version, out, host, ready,
                              self._base, self.d_cap, self._bound_added, self._epoch)

    @hot_path(bound="batch")
    def _readback(self, ticket: DispatchTicket, pipelined: bool):
        """THE blocking readback of one dispatched batch, shared by
        readback_packed and sync_ticket: one copy of the ticket's buffer
        (on CUDA, a wait for the copy enqueued at dispatch).  Records
        iters, the boundary gauges and the histograms, tightens the host
        bounds, and returns the statuses (None if the fixpoint diverged),
        with the witness decoded into last_witness (``[]`` when the witness
        is off)."""
        with self._sanctioned_sync("ticket readback"):
            if ticket.ready is not None:
                ticket.ready.synchronize()
                arr = np.asarray(ticket.host)
            else:
                arr = np.asarray(ticket.out)
        undecided, iters, hcount, dcount = (int(x) for x in arr[:_HEAD])
        m = self.metrics
        self.last_iters = iters
        m.counter("fixpoint_rounds").add(iters)
        m.histogram("fixpoint_rounds_per_batch").add(iters)
        if self.tiered:
            m.gauge("boundary_count").set(hcount + dcount - 1)
            m.gauge("base_boundaries").set(hcount)
            m.gauge("delta_boundaries").set(dcount)
            # Against the ticket's d_cap: a later dispatch may have grown
            # the delta since.
            m.histogram("delta_occupancy_synced").add(dcount / ticket.d_cap)
            if not pipelined:
                # As the reference: only the unpipelined readback, where no
                # later batch is in flight, resets the bounds to the truth.
                self._hcount_bound, self._dcount_bound = hcount, dcount
        else:
            m.gauge("boundary_count").set(hcount)
            if ticket.epoch == self._epoch:
                # The synced count plus every later dispatch's increment is
                # an upper bound too.  It only spares must-fit syncs: a grow
                # is still decided on the synced truth.
                self._hcount_bound = min(
                    self._hcount_bound, hcount + self._bound_added - ticket.added)
        statuses = None
        if undecided == 0:
            tc = ticket.pb.txn_cap
            statuses = arr[_HEAD : _HEAD + tc].copy()
            self.last_witness = decode_witness(
                ticket.pb, statuses, arr[_HEAD + tc : _HEAD + 2 * tc],
                arr[_HEAD + 2 * tc :], ticket.base,
            ) if self.witness else []
        if ticket.host is not None:
            host = ticket.host
            if isinstance(host, GuardedDeviceValue):
                host = host.unwrap()
            self._readback_pool.setdefault(arr.shape[0], []).append((host, ticket.ready))
            ticket.host = ticket.ready = None
        return statuses

    def detect_packed(self, pb: PackedBatch, now: int, new_oldest_version: int):
        """Run one packed batch; returns numpy statuses [txn_cap]."""
        return self.readback_packed(self.dispatch_packed(pb, now, new_oldest_version))

    def readback_packed(self, ticket: DispatchTicket):
        """The host half of detect_packed for the batch just dispatched:
        one readback; re-decide on the CPU engine if the fixpoint diverged,
        else the verdicts (the witness goes to last_witness).  A "readback"
        span (a host phase) holds the wait, the witness decode and a
        fallback."""
        rsp = begin_span("readback", attrs={"n_txn": ticket.pb.n_txn})
        try:
            statuses = self._readback(ticket, pipelined=False)
            if statuses is None:
                # The step left the logical history untouched: re-decide
                # the batch on the CPU engine against that state and adopt
                # its result.
                return self._fallback_cpu(ticket.pb, ticket.now, ticket.new_oldest_version)
            return statuses
        finally:
            rsp.end()
            self._note_host_span(rsp)

    # -- pipelined dispatch --
    @hot_path(bound="batch")
    def dispatch_txns(
        self,
        transactions: List[TransactionConflictInfo],
        now: int,
        new_oldest_version: int,
    ) -> DispatchTicket:
        """Pack + dispatch one batch without reading its verdicts back;
        sync_ticket does that later.  The carried history advances in
        dispatch order, so the next dispatch already decides against this
        batch's committed writes."""
        pb = self._pack(transactions)
        return self.dispatch_packed(pb, now, new_oldest_version)

    @hot_path(bound="batch")
    def sync_ticket(self, ticket: DispatchTicket):
        """Read one dispatched batch back.  Returns (statuses ndarray
        [txn_cap], diverged): diverged=True means the fixpoint left the
        batch undecided — the step left the logical history UNCHANGED for
        it, so the caller must re-decide this batch (and any dispatched
        after it) on an authoritative CPU engine.  A "readback" span (a host
        phase) holds the wait and the witness decode."""
        rsp = begin_span("readback", attrs={"n_txn": ticket.pb.n_txn})
        try:
            statuses = self._readback(ticket, pipelined=True)
            if statuses is None:
                self.metrics.counter("cpu_fallbacks").add()
                TraceEvent("ConflictFixpointDiverged", severity=30).detail(
                    "n_txn", ticket.pb.n_txn).detail("now", ticket.now).detail(
                    "pipelined", 1).log()
                return None, True
            return statuses, False
        finally:
            rsp.end()
            self._note_host_span(rsp)

    def _fallback_cpu(self, pb: PackedBatch, now: int, new_oldest_version: int):
        self.metrics.counter("cpu_fallbacks").add()
        TraceEvent("ConflictFixpointDiverged", severity=30).detail(
            "n_txn", pb.n_txn).detail("now", now).log()
        cpu = FlatCpuConflictSet()
        self.store_to(cpu)
        statuses = cpu.detect(
            _unpack_transactions(pb), now=now, new_oldest_version=new_oldest_version
        )
        self.load_from(cpu)
        # _unpack_transactions preserves read-range order, so the CPU
        # witness ordinals (and its absolute versions) adopt directly.
        self.last_witness = cpu.last_witness if self.witness else []
        out = np.full((pb.txn_cap,), COMMITTED, np.int32)
        out[: pb.n_txn] = statuses
        return out

    # -- state exchange with the CPU mirror --
    @hot_path(bound="chunks")
    def note_synced(self, snap, fresh=None) -> None:
        """Record that this device state now equals MirrorSnapshot `snap`
        (ConflictSet calls it after every device-served batch), encoding
        any chunk not yet in the encode cache so that a later rehydration
        pays only for chunks created after it.  `fresh` is the mirror's
        take_fresh_chunks() hint (chunks, complete): with it the walk
        covers the chunks created since the last sync (dead ones are
        skipped if unencodable); without it, or when it overflowed, every
        chunk of `snap`.  An unchanged mirror is one stamp compare."""
        if snap.stamp == self._synced_stamp:
            return
        candidates = snap.chunks
        if fresh is not None:
            chunks, complete = fresh
            if complete:
                candidates = chunks
        encoded = 0
        for ch in candidates:
            cache = ch.enc
            if cache is None or self.key_words not in cache:
                try:
                    _ent, n = chunk_encoding(ch, self.key_words)
                except ValueError:
                    continue  # a dead long-key chunk from the hint
                encoded += n
        if encoded:
            self.metrics.counter("mirror_sync_keys_encoded").add(encoded)
        self._synced_stamp = snap.stamp

    def load_from(self, src) -> None:
        """Adopt a CPU-mirror state as device state (in tiered mode as the
        base, with an empty delta and a rebuilt max table).  `src` is a
        MirrorSnapshot (immutable, and its chunks' cached encodings make
        the host work proportional to the chunks changed since the last
        note_synced) or any flat engine exposing keys / vers /
        oldest_version (every key encoded)."""
        chunks = getattr(src, "chunks", None)
        if chunks is not None:
            n = src.boundary_count
            encoded = 0
            ents = []
            for ch in chunks:
                ent, enc_n = chunk_encoding(ch, self.key_words)
                ents.append(ent)
                encoded += enc_n
            keys_enc = np.concatenate([e[0] for e in ents], axis=0)
            vers_abs = np.concatenate([e[1] for e in ents])
            synced_stamp = src.stamp
        else:
            n = encoded = len(src.keys)
            keys_enc = keylib.encode_keys(src.keys, self.key_words)
            vers_abs = np.asarray(src.vers, dtype=np.int64)
            synced_stamp = None
        self.metrics.counter("rehydrate_keys_total").add(n)
        self.metrics.counter("rehydrate_keys_encoded").add(encoded)
        if n + 8 > self.h_cap:
            # No table rebuild: _adopt below rebuilds it from the adopted
            # state.
            self._grow(_next_pow2(n + 8, self.h_cap * 2), rebuild_maxtab=False)
        self._base = src.oldest_version
        kw1 = self.key_words + 1
        hkeys = np.full((kw1, self.h_cap), keylib.INF_WORD, np.uint32)
        hkeys[:, :n] = keys_enc.T
        hvers = np.full((self.h_cap,), FLOOR_REL, np.int32)
        rel = np.clip(vers_abs - self._base, FLOOR_REL, 2**31 - 2)
        rel[vers_abs == FLOOR_VERSION] = FLOOR_REL
        hvers[:n] = rel.astype(np.int32)
        self._adopt(hkeys, hvers, n, 0)
        self._synced_stamp = synced_stamp

    def _host_state(self):
        """(keys, absolute versions, absolute oldest): the (base) history
        decoded to host lists, from one readback."""
        keys_u32, vers, n, oldest, base = self.export_state()
        keys = keylib.decode_keys(np.ascontiguousarray(keys_u32[:, :n].T), self.key_words)
        vers_abs = [FLOOR_VERSION if int(v) == FLOOR_REL else int(v) + base for v in vers[:n]]
        return keys, vers_abs, oldest + base

    def _merged_host_state(self):
        """The logical history as host (keys, absolute versions) lists —
        what mirror_check compares with the mirror: in tiered mode the
        delta folded over the base (fold_delta_over_base)."""
        keys, vers, _oldest = self._host_state()
        if not self.tiered:
            return keys, vers
        with self._sanctioned_sync("delta export"):
            nd = int(self._dcount)
            dk = keylib.from_device_words(self._dkeys[:, :nd].cpu().numpy())
            dvers = self._dvers[:nd].cpu().numpy()
        dkeys = keylib.decode_keys(np.ascontiguousarray(dk.T), self.key_words)
        return fold_delta_over_base(keys, vers, dkeys, dvers, self._base)

    def store_to(self, cpu) -> None:
        """Write the logical history into a flat CPU engine (keys as bytes,
        absolute versions)."""
        cpu.keys, cpu.vers = self._merged_host_state()
        cpu.oldest_version = self.oldest_version


# The device program registry lives in programs.py (its factories import
# this module lazily).
from .programs import (  # noqa: E402
    DEVICE_ENTRY_POINTS,
    cached_program_costs,
    program_cost_table,
    register_entry_point,
)
