"""Multiword binary search + sparse-table range max/min (word-major layout).

The conflict engine's history is a step function over byte-string keys
digitized as fixed-width vectors of words (see conflict/keys.py; on the
device every word is an int32 in the sign-flipped encoding, so plain
signed comparisons give the unsigned word order).  These helpers answer,
fully vectorized:

  - searchsorted_words: rank of each query key among sorted history keys
    (flat, or the reference's coarse-then-fine "2level" form)
  - range_max over a sparse table: max version within a contiguous index
    span

Key tensors are WORD-MAJOR [W, N].  Word index 0 is MOST significant; the
trailing word (the key length) is the least significant tie-break.

Every function is bit-identical to its counterpart in the reference
package's ops/rangequery.py on the same inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b lexicographically over the LEADING word axis; [W, ...] int32.

    Processes trailing (least significant) words first, so word 0 — the
    most significant — decides last and dominates."""
    lt = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    for w in range(a.shape[0] - 1, -1, -1):
        aw, bw = a[w], b[w]
        lt = (aw < bw) | ((aw == bw) & lt)
    return lt


def lex_leq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    leq = torch.ones(a.shape[1:], dtype=torch.bool, device=a.device)
    for w in range(a.shape[0] - 1, -1, -1):
        aw, bw = a[w], b[w]
        leq = (aw < bw) | ((aw == bw) & leq)
    return leq


def lex_argsort(cols) -> torch.Tensor:
    """Stable permutation sorting rows by several key columns, MOST
    significant first (``jax.lax.sort(..., num_keys=len(cols),
    is_stable=True)``'s order): a chain of stable single-key sorts, least
    significant key first."""
    n = cols[0].shape[0]
    perm = torch.arange(n, device=cols[0].device)
    for c in reversed(cols):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    return perm


def _search_steps(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))) + 1)


# Search strategies of searchsorted_words (the reference's FDB_TPU_SEARCH,
# with FDB_TPU_SEARCH_STRIDE as ``stride``); ranks are identical:
#   ""        flat binary search (the default)
#   "2level"  a bracket in a sampled table (one column every ``stride``
#             rows), then log2(stride) + 1 fine steps in the full table;
#             only on tables of at least _2LEVEL_MIN rows (below it the
#             flat search runs)
SEARCH_MODES = ("", "2level")
_2LEVEL_MIN = 1 << 16


def check_search(mode: str, stride: int) -> None:
    """Raise ValueError unless (mode, stride) is a search strategy."""
    if mode not in SEARCH_MODES:
        raise ValueError(f"unknown search mode {mode!r}; known: {list(SEARCH_MODES)}")
    if stride < 1:
        raise ValueError(f"search stride must be at least 1, got {stride}")


def _bisect(keys, q, cmp, lo, hi, steps):
    """`steps` rounds of the masked binary search of q [W, M] over the
    columns [lo, hi) of keys [W, N]; returns lo."""
    n = keys.shape[1]
    for _ in range(steps):
        active = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        kmid = keys[:, mid.clamp(0, n - 1).long()]
        go_right = cmp(kmid, q)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def _searchsorted_words_2level(keys, q, side, stride):
    """Coarse then fine: each query's rank among the sampled table (every
    ``stride``-th key) brackets its rank in the full table to
    [(clo - 1) * stride, clo * stride], which log2(stride) + 1 fine steps
    resolve."""
    n = keys.shape[1]
    m = q.shape[1]
    coarse = keys[:, ::stride]
    nc = coarse.shape[1]
    cmp = lex_less if side == "left" else lex_leq
    clo = _bisect(coarse, q, cmp, torch.zeros((m,), dtype=torch.int32, device=q.device),
                  torch.full((m,), nc, dtype=torch.int32, device=q.device),
                  _search_steps(nc))
    lo = torch.clamp((clo - 1) * stride, 0, n).to(torch.int32)
    hi = torch.clamp(clo * stride, max=n).to(torch.int32)
    return _bisect(keys, q, cmp, lo, hi, max(1, math.ceil(math.log2(stride)) + 1))


def searchsorted_words(keys: torch.Tensor, q: torch.Tensor, side: str, *,
                       mode: str = "", stride: int = 512) -> torch.Tensor:
    """Insertion ranks of q [W, M] into sorted keys [W, N], int32.

    side='left':  count of keys strictly < q
    side='right': count of keys <= q
    Fixed log2(N)+1 binary-search iterations of vectorized gathers, or
    with ``mode="2level"`` on a table of at least _2LEVEL_MIN rows the
    coarse-then-fine form (see SEARCH_MODES); the ranks are the same.
    """
    check_search(mode, stride)
    _w, n = keys.shape
    if mode == "2level" and n >= _2LEVEL_MIN:
        return _searchsorted_words_2level(keys, q, side, stride)
    m = q.shape[1]
    lo = torch.zeros((m,), dtype=torch.int32, device=q.device)
    hi = torch.full((m,), n, dtype=torch.int32, device=q.device)
    return _bisect(keys, q, lex_less if side == "left" else lex_leq, lo, hi,
                   _search_steps(n))


def searchsorted_1d(keys: torch.Tensor, q: torch.Tensor, side: str) -> torch.Tensor:
    """Insertion ranks of int queries q into 1-D sorted int keys — the
    single-word form of searchsorted_words."""
    n = keys.shape[0]
    lo = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    hi = torch.full(q.shape, n, dtype=torch.int32, device=q.device)
    for _ in range(_search_steps(n)):
        # The active guard stops converged lanes: without it, one extra
        # iteration past lo==hi==n keeps incrementing lo for queries at or
        # beyond the last key whenever n is not a power of two.
        active = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        kmid = keys[mid.clamp(0, n - 1).long()]
        go_right = (kmid <= q) if side == "right" else (kmid < q)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for x >= 1 (x < 1 counts as 1), int32 — exact, by
    an integer bit search (the reference uses count-leading-zeros)."""
    v = torch.clamp(x.to(torch.int32), min=1)
    out = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        big = v >= (1 << s)
        out = out + torch.where(big, s, 0).to(torch.int32)
        v = torch.where(big, v >> s, v)
    return out


def _build_table(values: torch.Tensor, op) -> torch.Tensor:
    """Stacked sparse table [L+1, N]; table[l][i] covers [i, i + 2^l),
    each level the previous one combined with itself shifted by 2^l and
    edge-padded with its last value."""
    n = values.shape[0]
    levels = [values]
    span = 1
    lmax = max(1, math.ceil(math.log2(max(n, 2))))
    for _ in range(lmax):
        prev = levels[-1]
        shifted = torch.cat([prev[span:], prev[-1:].expand(min(span, n))])
        levels.append(op(prev, shifted))
        span *= 2
    return torch.stack(levels)


def build_max_table(values: torch.Tensor) -> torch.Tensor:
    return _build_table(values, torch.maximum)


def build_min_table(values: torch.Tensor) -> torch.Tensor:
    return _build_table(values, torch.minimum)


def build_max_table_np(values: np.ndarray) -> np.ndarray:
    """Host (numpy) twin of build_max_table, bit-identical: the tiered
    engine seeds its carried base table with it without a device pass."""
    values = np.asarray(values, dtype=np.int32)
    n = values.shape[0]
    levels = [values]
    span = 1
    lmax = max(1, math.ceil(math.log2(max(n, 2))))
    for _ in range(lmax):
        prev = levels[-1]
        shifted = np.concatenate(
            [prev[span:], np.broadcast_to(prev[-1:], (min(span, n),))]
        )
        levels.append(np.maximum(prev, shifted))
        span *= 2
    return np.stack(levels)


def _range_query(table, i, j, op):
    """op over values[i..j] inclusive; requires i <= j elementwise
    (i > j reads single cells in range and the caller masks them)."""
    length = j - i + 1
    lev = floor_log2(length)
    lev_l = lev.long()
    left = table[lev_l, i.long()]
    right = table[lev_l, (j - (1 << lev) + 1).long()]
    return op(left, right)


def range_max(table, i, j):
    return _range_query(table, i, j, torch.maximum)


def range_min(table, i, j):
    return _range_query(table, i, j, torch.minimum)
