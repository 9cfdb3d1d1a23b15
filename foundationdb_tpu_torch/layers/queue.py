"""Queue / vector container recipes over the tuple layer.

The port's own copy of the reference package's ``layers/queue.py``.

Ref: layers/containers (vector.py, highcontention queue) and the
classic FDB queue recipe — the queue uses VERSIONSTAMPED keys so pushes
from any number of clients never conflict with each other (the stamp IS
the global commit order); pops read-and-clear the first item and carry
ordinary conflict semantics (two poppers racing: one retries).  The
vector is a dense index->value subspace with transactional size/swap.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from ..client.types import MutationType, key_after
from .subspace import Subspace


class Queue:
    """Multi-writer FIFO: contention-free push, conflicting pop.

    Keys: sub[(stamp, )] where stamp is the 10-byte commit versionstamp —
    global arrival order with NO key reads on push (the canonical
    versionstamped-key queue recipe; ref: bindings' queue examples and
    layers/containers/highcontention's goal)."""

    def __init__(self, subspace: Subspace):
        self.sub = subspace

    def push(self, tr, value: bytes) -> None:
        # Param = [prefix][10-byte stamp placeholder][pos: 4B LE]; the
        # stamp (8B big-endian version + 2B batch index) replaces the
        # placeholder at commit, so final keys sort in commit order.
        prefix = self.sub.pack()
        key = prefix + b"\x00" * 10 + len(prefix).to_bytes(4, "little")
        tr.atomic_op(MutationType.SET_VERSIONSTAMPED_KEY, key, value)

    async def pop(self, tr) -> Optional[bytes]:
        b, e = self.sub.range()
        rows = await tr.get_range(b, e, limit=1)
        if not rows:
            return None
        tr.clear(rows[0][0])
        return rows[0][1]

    async def peek(self, tr) -> Optional[bytes]:
        b, e = self.sub.range()
        rows = await tr.get_range(b, e, limit=1, snapshot=True)
        return rows[0][1] if rows else None

    async def empty(self, tr) -> bool:
        b, e = self.sub.range()
        return not await tr.get_range(b, e, limit=1)


class Vector:
    """Dense 0-indexed vector: sub[(i,)] = value (ref:
    layers/containers/vector.py's shape, re-derived)."""

    def __init__(self, subspace: Subspace):
        self.sub = subspace

    async def size(self, tr) -> int:
        b, e = self.sub.range()
        rows = await tr.get_range(b, e, limit=1, reverse=True)
        if not rows:
            return 0
        return int(self.sub.unpack(rows[0][0])[0]) + 1

    def set(self, tr, index: int, value: bytes) -> None:
        tr.set(self.sub.pack((index,)), value)

    async def get(self, tr, index: int) -> Optional[bytes]:
        return await tr.get(self.sub.pack((index,)))

    async def push(self, tr, value: bytes) -> int:
        n = await self.size(tr)
        tr.set(self.sub.pack((n,)), value)
        return n

    async def pop(self, tr) -> Optional[bytes]:
        n = await self.size(tr)
        if n == 0:
            return None
        k = self.sub.pack((n - 1,))
        v = await tr.get(k)
        tr.clear(k)
        return v

    async def swap(self, tr, i: int, j: int) -> None:
        ki, kj = self.sub.pack((i,)), self.sub.pack((j,))
        vi, vj = await tr.get(ki), await tr.get(kj)
        if vj is None:
            tr.clear(ki)
        else:
            tr.set(ki, vj)
        if vi is None:
            tr.clear(kj)
        else:
            tr.set(kj, vi)
