"""RangeMap: a coalescing map from key ranges to values.

The port's own copy of the reference package's ``utils/rangemap.py``.
Ref: fdbclient/KeyRangeMap.h (krm* helpers over a coalesced map keyed by
range-begin; the value at key k is the value of the entry with the largest
begin <= k).  Used for the client location cache, storage ownership, the
proxy's key-server map, and DataDistribution's shard map.

Representation: sorted parallel arrays `begins` / `values`; begins[0] is
always b"" so every key has a value.  A range's extent runs to the next
begin (the last entry extends to +infinity).
"""

from __future__ import annotations

from bisect import bisect_right, bisect_left
from typing import Any, Iterator, List, Optional, Tuple


class RangeMap:
    __slots__ = ("begins", "values")

    def __init__(self, default: Any = None):
        self.begins: List[bytes] = [b""]
        self.values: List[Any] = [default]

    def __getitem__(self, key: bytes) -> Any:
        return self.values[bisect_right(self.begins, key) - 1]

    def range_containing(self, key: bytes) -> Tuple[bytes, Optional[bytes], Any]:
        """(begin, end_or_None, value) of the entry covering `key`."""
        i = bisect_right(self.begins, key) - 1
        end = self.begins[i + 1] if i + 1 < len(self.begins) else None
        return self.begins[i], end, self.values[i]

    def set_range(self, begin: bytes, end: Optional[bytes], value: Any):
        """Assign `value` on [begin, end); end=None means +infinity.
        Neighbouring equal values coalesce (ref: krmSetRangeCoalescing)."""
        assert end is None or begin < end, (begin, end)
        # Value that resumes at `end` (the old value there).
        if end is not None:
            resume = self[end]
        i0 = bisect_left(self.begins, begin)
        if end is None:
            i1 = len(self.begins)
        else:
            i1 = bisect_left(self.begins, end)
        new_b: List[bytes] = [begin]
        new_v: List[Any] = [value]
        if end is not None and not (i1 < len(self.begins) and self.begins[i1] == end):
            new_b.append(end)
            new_v.append(resume)
        self.begins[i0:i1] = new_b
        self.values[i0:i1] = new_v
        self._coalesce_around(i0, i0 + len(new_b))

    def _coalesce_around(self, lo: int, hi: int):
        """Merge equal-valued neighbours in begins[lo-1 : hi+1]."""
        i = max(1, lo - 1)
        stop = min(len(self.begins), hi + 1)
        while i < stop:
            if self.values[i] == self.values[i - 1]:
                del self.begins[i]
                del self.values[i]
                stop -= 1
            else:
                i += 1

    def insert_boundary(self, key: bytes, value: Any):
        """Boundary-entry semantics (ref: the krm* encoding of a range map as
        boundary keys): `value` applies from `key` up to the NEXT existing
        boundary, which is left intact.  Writers emit complete boundary sets
        (begin + resume entries) in one transaction, so applying each entry
        independently converges to the intended map."""
        i = bisect_left(self.begins, key)
        if i < len(self.begins) and self.begins[i] == key:
            self.values[i] = value
        else:
            self.begins.insert(i, key)
            self.values.insert(i, value)

    def intersecting(
        self, begin: bytes, end: Optional[bytes]
    ) -> Iterator[Tuple[bytes, Optional[bytes], Any]]:
        """Yield (clip_begin, clip_end_or_None, value) covering [begin, end),
        clipped to the query range, in key order."""
        i = bisect_right(self.begins, begin) - 1
        while i < len(self.begins):
            b = self.begins[i]
            e = self.begins[i + 1] if i + 1 < len(self.begins) else None
            if end is not None and b >= end:
                return
            cb = max(b, begin)
            ce = e if end is None else (min(e, end) if e is not None else end)
            if ce is None or cb < ce:
                yield cb, ce, self.values[i]
            i += 1

    def items(self) -> Iterator[Tuple[bytes, Optional[bytes], Any]]:
        return self.intersecting(b"", None)

    def __repr__(self):
        return f"RangeMap({list(self.items())!r})"
