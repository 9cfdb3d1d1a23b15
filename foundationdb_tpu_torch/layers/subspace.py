"""Subspace: a fixed key prefix + tuple packing underneath it.

The port's own copy of the reference package's ``layers/subspace.py``.

Ref: bindings/python/fdb/subspace_impl.py — subspaces partition the key
space; sub[x] nests, pack/unpack round-trip tuples under the prefix, and
range() scans everything beneath.
"""

from __future__ import annotations

from typing import Any, Iterable, Tuple

from . import tuple as fdbtuple


class Subspace:
    def __init__(self, prefix_tuple: Iterable[Any] = (), raw_prefix: bytes = b""):
        self._prefix = raw_prefix + fdbtuple.pack(tuple(prefix_tuple))

    @property
    def raw_prefix(self) -> bytes:
        return self._prefix

    def key(self) -> bytes:
        return self._prefix

    def pack(self, t: Iterable[Any] = ()) -> bytes:
        return self._prefix + fdbtuple.pack(tuple(t))

    def unpack(self, key: bytes) -> tuple:
        if not self.contains(key):
            raise ValueError("key is not within this subspace")
        return fdbtuple.unpack(key[len(self._prefix) :])

    def contains(self, key: bytes) -> bool:
        return key.startswith(self._prefix)

    def range(self, t: Iterable[Any] = ()) -> Tuple[bytes, bytes]:
        p = self.pack(t)
        return p + b"\x00", p + b"\xff"

    def subspace(self, t: Iterable[Any]) -> "Subspace":
        return Subspace(raw_prefix=self.pack(t))

    def __getitem__(self, item) -> "Subspace":
        return self.subspace((item,))

    def __repr__(self):
        return f"Subspace(raw_prefix={self._prefix!r})"
