"""IndexedSet: ordered map with subtree metric sums (order-statistic tree).

The port's own copy of the reference package's ``utils/indexed_set.py``.
Ref: flow/IndexedSet.h — the reference's core container keeps a per-node
`total` of a metric over the subtree, giving O(log n) insert/erase,
range-sum (sumTo/sumRange), and metric-indexed search (index(metric) — the
key where a given amount of metric accumulates).  StorageMetrics' byte
sample rides exactly this to answer bytes-in-range and weighted split
points (StorageMetrics.actor.h:404).

Implementation: a treap (randomized BST) seeded by the caller's
DeterministicRandom so simulation stays seed-reproducible.  Each node
carries (key, weight) and aggregates subtree weight + count.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple


class _Node:
    __slots__ = ("key", "weight", "prio", "left", "right", "sum", "count")

    def __init__(self, key: bytes, weight: int, prio: int):
        self.key = key
        self.weight = weight
        self.prio = prio
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None
        self.sum = weight
        self.count = 1


def _sum(n: Optional[_Node]) -> int:
    return n.sum if n is not None else 0


def _count(n: Optional[_Node]) -> int:
    return n.count if n is not None else 0


def _pull(n: _Node) -> _Node:
    n.sum = n.weight + _sum(n.left) + _sum(n.right)
    n.count = 1 + _count(n.left) + _count(n.right)
    return n


def _merge(a: Optional[_Node], b: Optional[_Node]) -> Optional[_Node]:
    """All keys in a < all keys in b."""
    if a is None:
        return b
    if b is None:
        return a
    if a.prio > b.prio:
        a.right = _merge(a.right, b)
        return _pull(a)
    b.left = _merge(a, b.left)
    return _pull(b)


def _split(n: Optional[_Node], key: bytes) -> Tuple[Optional[_Node], Optional[_Node]]:
    """(keys < key, keys >= key)."""
    if n is None:
        return None, None
    if n.key < key:
        lo, hi = _split(n.right, key)
        n.right = lo
        return _pull(n), hi
    lo, hi = _split(n.left, key)
    n.left = hi
    return lo, _pull(n)


class IndexedSet:
    """Ordered (key -> weight) with O(log n) everything the byte sample
    needs.  Requires an rng with random_int (the port's flow.rng.DeterministicRandom)
    for treap priorities — determinism is a property, not an accident."""

    def __init__(self, rng):
        self.rng = rng
        self.root: Optional[_Node] = None
        self._weights: dict = {}  # key -> weight (O(1) membership)

    def __len__(self) -> int:
        return _count(self.root)

    def __contains__(self, key: bytes) -> bool:
        return key in self._weights

    def get(self, key: bytes) -> Optional[int]:
        return self._weights.get(key)

    # -- updates --
    def set(self, key: bytes, weight: int):
        if key in self._weights:
            self.erase(key)
        self._weights[key] = weight
        node = _Node(key, weight, int(self.rng.random_int(0, 1 << 62)))
        lo, hi = _split(self.root, key)
        self.root = _merge(_merge(lo, node), hi)

    def erase(self, key: bytes):
        if key not in self._weights:
            return
        del self._weights[key]
        lo, rest = _split(self.root, key)
        mid, hi = _split(rest, key + b"\x00")
        # mid holds exactly the erased key's node (keys are unique).
        self.root = _merge(lo, hi)

    def erase_range(self, begin: bytes, end: Optional[bytes]):
        """Drop every key in [begin, end) — O(log n + removed)."""
        lo, rest = _split(self.root, begin)
        if end is None:
            mid, hi = rest, None
        else:
            mid, hi = _split(rest, end)
        for k in _iter_keys(mid):
            del self._weights[k]
        self.root = _merge(lo, hi)

    # -- queries (ref: sumRange / index in IndexedSet.h) --
    def sum_range(self, begin: bytes, end: Optional[bytes]) -> int:
        """Total weight of keys in [begin, end)."""
        return self._sum_below(end) - self._sum_below(begin)

    def _sum_below(self, key: Optional[bytes]) -> int:
        """Total weight of keys strictly below `key` (None = all)."""
        if key is None:
            return _sum(self.root)
        total = 0
        n = self.root
        while n is not None:
            if n.key < key:
                total += n.weight + _sum(n.left)
                n = n.right
            else:
                n = n.left
        return total

    def count_range(self, begin: bytes, end: Optional[bytes]) -> int:
        return self._count_below(end) - self._count_below(begin)

    def _count_below(self, key: Optional[bytes]) -> int:
        if key is None:
            return _count(self.root)
        total = 0
        n = self.root
        while n is not None:
            if n.key < key:
                total += 1 + _count(n.left)
                n = n.right
            else:
                n = n.left
        return total

    def key_at_metric(self, begin: bytes, end: Optional[bytes],
                      metric: int) -> Optional[bytes]:
        """The first key in [begin, end) at which the accumulated weight
        from `begin` EXCEEDS `metric` (ref: IndexedSet::index — the
        weighted-split primitive).  None if the range's total never does."""
        if self.sum_range(begin, end) <= metric:
            return None
        target = self._sum_below(begin) + metric
        # Descend for the first key where sum-below(key inclusive) > target.
        n = self.root
        acc = 0
        result = None
        while n is not None:
            below_incl = acc + _sum(n.left) + n.weight
            if below_incl > target:
                result = n.key
                n = n.left
            else:
                acc = below_incl
                n = n.right
        return result

    def keys_in(self, begin: bytes, end: Optional[bytes]) -> List[bytes]:
        out: List[bytes] = []
        _collect(self.root, begin, end, out)
        return out


def _iter_keys(n: Optional[_Node]) -> Iterator[bytes]:
    if n is None:
        return
    yield from _iter_keys(n.left)
    yield n.key
    yield from _iter_keys(n.right)


def _collect(n: Optional[_Node], begin: bytes, end: Optional[bytes],
             out: List[bytes]):
    if n is None:
        return
    if n.key >= begin:
        _collect(n.left, begin, end, out)
        if end is None or n.key < end:
            out.append(n.key)
    if end is None or n.key < end:
        _collect(n.right, begin, end, out)
