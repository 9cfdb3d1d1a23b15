"""The port's containers: ``RangeMap`` (a coalescing key-range map) and
``indexed_set.IndexedSet`` (an order-statistic treap with weight sums)."""

from .rangemap import RangeMap

__all__ = ["RangeMap"]
