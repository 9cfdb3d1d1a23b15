"""Dyadic segment-tree interval stabbing: per-slot min over covering intervals.

Given M intervals [lo_i, hi_i) over N = 2^k slots, each with an int32 weight,
computes for every slot the minimum weight among intervals covering it
(+INF where uncovered).  The conflict engine uses it to answer, for every
point of the key space at once, "what is the earliest transaction whose
write covers this point?".

Build: each interval min-updates its O(log N) dyadic cover nodes (the
classic iterative segment-tree range update, vectorized across all
intervals, as ``scatter_reduce_(..., "amin")`` into a flat tree whose last
slot absorbs masked-off updates); a top-down push then folds node values
onto leaves.  Bit-identical to the reference package's ops/stabbing.py.
"""

from __future__ import annotations

import torch

INF32 = 2**31 - 1


def stabbing_min(
    lo: torch.Tensor,
    hi: torch.Tensor,
    weight: torch.Tensor,
    valid: torch.Tensor,
    n_log2: int,
) -> torch.Tensor:
    """Per-slot min weight over covering intervals.

    lo, hi: int32 [M] half-open slot intervals, 0 <= lo <= hi <= N
    weight: int32 [M]; valid: bool [M] (invalid intervals ignored)
    returns int32 [N] (INF32 where uncovered), N = 2^n_log2.
    """
    n = 1 << n_log2
    dev = lo.device
    dump = 2 * n
    # Flat tree: node 1 is root, leaves are [n, 2n); index 2n is a dummy
    # slot for masked-off scatters.
    tree = torch.full((2 * n + 1,), INF32, dtype=torch.int32, device=dev)
    w = torch.where(valid, weight.to(torch.int32), INF32)
    li = torch.where(valid, lo + n, dump).to(torch.int32)
    ri = torch.where(valid, hi + n, dump).to(torch.int32)
    for _ in range(n_log2 + 1):
        active = li < ri
        upd_l = active & (li % 2 == 1)
        tree.scatter_reduce_(
            0, torch.where(upd_l, li, dump).long(),
            torch.where(upd_l, w, INF32), "amin", include_self=True,
        )
        li = li + upd_l.to(torch.int32)
        upd_r = active & (ri % 2 == 1)
        ri = ri - upd_r.to(torch.int32)
        tree.scatter_reduce_(
            0, torch.where(upd_r, ri, dump).long(),
            torch.where(upd_r, w, INF32), "amin", include_self=True,
        )
        li = li // 2
        ri = ri // 2
    # Push node minima down to leaves, level by level.
    for d in range(n_log2):
        lvl = 1 << d
        parents = tree[lvl : 2 * lvl]
        children = tree[2 * lvl : 4 * lvl]
        tree[2 * lvl : 4 * lvl] = torch.minimum(
            children, parents.repeat_interleave(2)
        )
    return tree[n : 2 * n]
