"""The two kernels of the conflict step: wrappers, plain twins, launch counts.

Port of the reference package's conflict/kernels.py.  Each kernel is
hand-written CUDA C++ for Hopper (``csrc/``, built by ``_build``) behind a
wrapper that checks its arguments, allocates every output and scratch
buffer, and launches on PyTorch's current stream:

  phase1_ranks        csrc/phase1_search.cu  (phase-1 history search)
  fused_merge_evict   csrc/merge_evict.cu    (phases 5-6 merge + evict)

The rule that picks the path is fixed: a CUDA tensor launches the kernel,
a CPU tensor takes the plain PyTorch twin (``*_reference``, same
signature, same results).  There is no fallback: a kernel that fails to
build or launch raises (a failed launch: ``device.CudaError``, carrying
its cudaError_t as ``code``).  Each wrapper marks its region (regions.py) for
the structural check.  ``LAUNCHES`` counts kernel launches only;
``merge_contract_faults`` reads the merge kernel's count of inputs that
broke the order it relies on.

Key words are int32 in the device encoding of conflict/keys.py.  The
kernels launch at 1-9 and 17 words a key row (key_words up to 8, and 16,
the soak's DynamicCluster width); at another width a CUDA tensor's launch
fails with cudaErrorInvalidValue.
"""

from __future__ import annotations

import functools

import torch

from ..device import CudaError
from ..ops.rangequery import lex_argsort, searchsorted_words
from .regions import note_launch, region

LAUNCHES = {"phase1_ranks": 0, "fused_merge_evict": 0}
# Per CUDA device, the merge kernel's count of order-contract faults
# (read by merge_contract_faults).
_MERGE_FAULTS: dict = {}


def _on_cuda(*tensors) -> bool:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, what: str):
    if err != 0:
        raise CudaError(f"{what}: CUDA error {err} at launch", err)


# ---------------------------------------------------------------------------
# Phase-1 history search
# ---------------------------------------------------------------------------


def phase1_ranks_reference(h_keys, q_keys, q_side):
    """Plain twin of phase1_ranks: both binary searches, picked by side."""
    left = searchsorted_words(h_keys, q_keys, "left")
    right = searchsorted_words(h_keys, q_keys, "right")
    return torch.where(q_side != 0, right, left)


def phase1_ranks(h_keys, q_keys, q_side):
    """Insertion ranks of PRE-SORTED queries into sorted history keys.

    h_keys (kw1, N) int32 word-major, INF-padded past the live count;
    q_keys (kw1, M) int32 SORTED ascending with q_side as the least
    significant sort key; q_side (M,) int32 — 0: left rank (count of rows
    < q), 1: right rank (count of rows <= q).  Returns ranks (M,) int32 in
    the sorted order, equal to searchsorted_words over the full width.
    """
    with region("kernel", "phase1_ranks"):
        kw1, n = h_keys.shape
        m = q_keys.shape[1]
        _check("h_keys", h_keys, torch.int32, (kw1, n))
        _check("q_keys", q_keys, torch.int32, (kw1, m))
        _check("q_side", q_side, torch.int32, (m,))
        if not _on_cuda(h_keys, q_keys, q_side):
            return phase1_ranks_reference(h_keys, q_keys, q_side)
        from . import _build

        lib = _build.load("phase1_search")
        ranks = torch.empty((m,), dtype=torch.int32, device=h_keys.device)
        err = lib.phase1_ranks_launch(
            h_keys.data_ptr(), n, q_keys.data_ptr(), q_side.data_ptr(),
            ranks.data_ptr(), m, kw1, _stream(h_keys.device),
        )
        _raise_on(err, "phase1_ranks")
        LAUNCHES["phase1_ranks"] += 1
        note_launch("phase1_ranks")
        return ranks


def phase1_search_tiers(tiers, r_begin, r_end):
    """(i0, j1) rank pairs for every history tier from ONE shared query
    sort:  i0 = right-rank(r_begin) - 1,  j1 = left-rank(r_end) - 1.

    The two query sets are sorted together once (side is the least
    significant key, so equal-key left queries come first), each tier's
    kernel consumes the sorted stream, and the ranks are scattered back
    to the query order.  Returns [(i0, j1), ...] aligned with `tiers`."""
    kw1, R = r_begin.shape
    dev = r_begin.device
    q = torch.cat([r_end, r_begin], dim=1)
    side = torch.cat([
        torch.zeros((R,), dtype=torch.int32, device=dev),
        torch.ones((R,), dtype=torch.int32, device=dev),
    ])
    perm = lex_argsort([q[w] for w in range(kw1)] + [side])
    q_sorted = q[:, perm].contiguous()
    side_sorted = side[perm].contiguous()
    out = []
    for h in tiers:
        ranks_sorted = phase1_ranks(h, q_sorted, side_sorted)
        ranks = torch.empty_like(ranks_sorted)
        ranks[perm] = ranks_sorted
        out.append((ranks[R:] - 1, ranks[:R] - 1))
    return out


def phase1_search(h_keys, r_begin, r_end):
    """Single-tier form of phase1_search_tiers."""
    ((i0, j1),) = phase1_search_tiers((h_keys,), r_begin, r_end)
    return i0, j1


# ---------------------------------------------------------------------------
# Fused merge-evict-compact
# ---------------------------------------------------------------------------


def fused_merge_evict_reference(
    a_keys, a_vers, a_keep, a_pos,
    b_keys, b_vers, b_keep, b_pos,
    merged_count, window, *, width: int,
):
    """Plain twin of fused_merge_evict: materialize the merge by writing
    each kept row at its position, apply the removeBefore rule, compact.
    Rows at and past the returned count are zero."""
    kw1 = a_keys.shape[0]
    dev = a_keys.device
    mk = torch.zeros((kw1, width), dtype=torch.int32, device=dev)
    mv = torch.zeros((width,), dtype=torch.int32, device=dev)
    for keys, vers, keep, pos in ((a_keys, a_vers, a_keep, a_pos),
                                  (b_keys, b_vers, b_keep, b_pos)):
        sel = (keep != 0) & (pos >= 0) & (pos < width)
        p = pos[sel].long()
        mk[:, p] = keys[:, sel]
        mv[p] = vers[sel]
    idx = torch.arange(width, dtype=torch.int32, device=dev)
    occ = idx < merged_count
    prev = torch.cat([mv[:1], mv[:-1]])
    keep = occ & ~((idx > 0) & (mv < window) & (prev < window))
    rank = (torch.cumsum(keep, 0, dtype=torch.int32) - 1)[keep].long()
    out_keys = torch.zeros_like(mk)
    out_vers = torch.zeros_like(mv)
    out_keys[:, rank] = mk[:, keep]
    out_vers[rank] = mv[keep]
    return out_keys, out_vers, keep.sum(dtype=torch.int32)


def fused_merge_evict(
    a_keys, a_vers, a_keep, a_pos,
    b_keys, b_vers, b_keep, b_pos,
    merged_count, window, *, width: int,
):
    """Merge two position-annotated streams, evict by the removeBefore
    rule against ``window``, and compact.

    a_*: the history (NA rows): keys (kw1, NA) int32, vers/keep/pos (NA,)
    int32 (pos only read where keep != 0; the kernel does not read A's
    pos, which the order below determines).  b_*: the batch's new rows
    likewise.  The kernel relies on the order of the positions: in each
    stream the kept rows' positions strictly increase with the row index,
    and the two streams' kept positions together partition
    [0, merged_count).  Positions at and past ``width`` are dropped.
    On inputs that break the order the kernel's output is undefined; it
    stays in bounds, and each merged slot it found unfilled (or B row off
    its place) adds one to ``merge_contract_faults``.
    merged_count and window are 0-dim int32 tensors on the same device
    (read there, no host sync); window = FLOOR_REL keeps every row.
    Returns (out_keys (kw1, width), out_vers (width,), out_count 0-dim
    int32); rows at and past out_count are UNDEFINED — the caller masks
    them.
    """
    with region("kernel", "fused_merge_evict"):
        kw1, na = a_keys.shape
        nb = b_keys.shape[1]
        _check("a_keys", a_keys, torch.int32, (kw1, na))
        for name, t in (("a_vers", a_vers), ("a_keep", a_keep), ("a_pos", a_pos)):
            _check(name, t, torch.int32, (na,))
        _check("b_keys", b_keys, torch.int32, (kw1, nb))
        for name, t in (("b_vers", b_vers), ("b_keep", b_keep), ("b_pos", b_pos)):
            _check(name, t, torch.int32, (nb,))
        _check("merged_count", merged_count, torch.int32, ())
        _check("window", window, torch.int32, ())
        args = (a_keys, a_vers, a_keep, a_pos, b_keys, b_vers, b_keep, b_pos,
                merged_count, window)
        if not _on_cuda(*args):
            return fused_merge_evict_reference(*args, width=width)
        from . import _build

        lib = _build.load("merge_evict")
        dev = a_keys.device
        # Counters, look-back status words, A's chunk prefix and the dense copy
        # of B's kept rows; the launch clears what needs clearing.
        scratch = torch.empty((_merge_scratch_bytes(na, nb, kw1, width),),
                              dtype=torch.uint8, device=dev)
        out_keys = torch.empty((kw1, width), dtype=torch.int32, device=dev)
        out_vers = torch.empty((width,), dtype=torch.int32, device=dev)
        out_count = torch.empty((), dtype=torch.int32, device=dev)
        faults = _MERGE_FAULTS.get(dev)
        if faults is None:
            faults = _MERGE_FAULTS[dev] = torch.zeros((), dtype=torch.int32, device=dev)
        err = lib.fused_merge_evict_launch(
            *(t.data_ptr() for t in (a_keys, a_vers, a_keep)), na,
            *(t.data_ptr() for t in (b_keys, b_vers, b_keep, b_pos)), nb,
            merged_count.data_ptr(), window.data_ptr(), kw1, width,
            scratch.data_ptr(), out_keys.data_ptr(), out_vers.data_ptr(),
            out_count.data_ptr(), faults.data_ptr(), _stream(dev),
        )
        _raise_on(err, "fused_merge_evict")
        LAUNCHES["fused_merge_evict"] += 1
        note_launch("fused_merge_evict")
        return out_keys, out_vers, out_count


@functools.lru_cache(maxsize=64)
def _merge_scratch_bytes(na: int, nb: int, kw1: int, width: int) -> int:
    from . import _build

    return _build.load("merge_evict").merge_scratch_bytes(na, nb, kw1, width)


def merge_contract_faults(device) -> int:
    """Merged slots that fused_merge_evict's kernel found unfilled, and B
    rows it found off their place, on ``device`` since the last call:
    nonzero only if some call's inputs broke the order contract.  Reading
    waits for the device; the count restarts at 0."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    faults = _MERGE_FAULTS.get(dev)
    if faults is None:
        return 0
    n = int(faults)
    faults.zero_()
    return n
