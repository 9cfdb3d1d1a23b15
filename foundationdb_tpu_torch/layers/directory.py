"""Directory layer: a filesystem-like namespace mapping paths to short
allocated key prefixes.

The port's own copy of the reference package's ``layers/directory.py``.

Ref: bindings/python/fdb/directory_impl.py — DirectoryLayer keeps a node
tree under `\xfe` (each node records its children and layer tag), and
allocates content prefixes with the HighContentionAllocator so many
clients can create directories concurrently without conflicting.  This is
a from-scratch implementation of the same semantics (same node-tree idea
and the documented HCA windowing algorithm; the on-disk layout is NOT
byte-compatible with the reference bindings and says so here).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..client.types import MutationType
from ..flow.error import FdbError
from . import tuple as fdbtuple
from .subspace import Subspace


class HighContentionAllocator:
    """Integer id allocator safe under high concurrency (ref:
    HighContentionAllocator in directory_impl.py).  Counters track how full
    the current window is; candidates are probed randomly within the
    window with snapshot reads so concurrent allocators rarely conflict."""

    def __init__(self, subspace: Subspace):
        self.counters = subspace[0]
        self.recent = subspace[1]

    @staticmethod
    def _window_size(start: int) -> int:
        if start < 255:
            return 64
        if start < 65535:
            return 1024
        return 8192

    async def allocate(self, tr) -> int:
        rng = tr.db.process.network.loop.rng
        while True:
            # Current window start = the last counters key.
            rows = await tr.get_range(
                *self.counters.range(), limit=1, reverse=True, snapshot=True
            )
            start = (
                self.counters.unpack(rows[0][0])[0] if rows else 0
            )
            window_advanced = False
            while True:
                if window_advanced:
                    tr.clear_range(
                        self.counters.range()[0], self.counters.pack((start,))
                    )
                    tr.clear_range(
                        self.recent.range()[0], self.recent.pack((start,))
                    )
                tr.atomic_op(
                    MutationType.ADD_VALUE,
                    self.counters.pack((start,)),
                    (1).to_bytes(8, "little"),
                )
                raw = await tr.get(self.counters.pack((start,)), snapshot=True)
                count = int.from_bytes(raw or b"", "little")
                window = self._window_size(start)
                if count * 2 < window:
                    break
                start += window
                window_advanced = True
            while True:
                candidate = start + int(rng.random_int(0, window))
                latest = await tr.get_range(
                    *self.counters.range(), limit=1, reverse=True, snapshot=True
                )
                latest_start = (
                    self.counters.unpack(latest[0][0])[0] if latest else 0
                )
                if latest_start > start:
                    break  # window moved under us; restart
                # NON-snapshot read: two allocators probing the same
                # candidate must conflict at commit (write-write alone
                # would not), so exactly one wins and the loser retries
                # with a new random candidate (ref: the plain
                # tr[recent[candidate]] read in 6.0's allocate).
                taken = await tr.get(self.recent.pack((candidate,)))
                if taken is None:
                    tr.set(self.recent.pack((candidate,)), b"")
                    return candidate


class DirectorySubspace(Subspace):
    """The handle create_or_open returns: a Subspace over the directory's
    allocated prefix plus its path/layer metadata."""

    def __init__(self, path: Tuple[str, ...], prefix: bytes, layer: bytes,
                 directory: "DirectoryLayer"):
        super().__init__(raw_prefix=prefix)
        self.path = path
        self.layer = layer
        self._directory = directory

    def __repr__(self):
        return f"DirectorySubspace(path={self.path}, prefix={self.raw_prefix!r})"


class DirectoryLayer:
    def __init__(self, node_prefix: bytes = b"\xfe", content_prefix: bytes = b""):
        self._node_root = Subspace(raw_prefix=node_prefix)
        self._content_prefix = content_prefix
        self._allocator = HighContentionAllocator(
            self._node_root[b"hca"]
        )

    # -- node helpers: a directory's node is keyed by its prefix --
    def _node(self, prefix: bytes) -> Subspace:
        return self._node_root[prefix]

    def _child_key(self, node: Subspace, name: str) -> bytes:
        return node[0].pack((name,))

    async def _find(self, tr, path: Tuple[str, ...]):
        """(node, prefix) for path, or (None, None)."""
        prefix = b""  # the root directory's conventional prefix
        node = self._node(prefix)
        for name in path:
            child = await tr.get(self._child_key(node, name))
            if child is None:
                return None, None
            prefix = child
            node = self._node(prefix)
        return node, prefix

    async def create_or_open(self, tr, path, layer: bytes = b""):
        return await self._create_or_open(tr, tuple(path), layer, True, True)

    async def create(self, tr, path, layer: bytes = b""):
        return await self._create_or_open(tr, tuple(path), layer, True, False)

    async def open(self, tr, path, layer: bytes = b""):
        return await self._create_or_open(tr, tuple(path), layer, False, True)

    async def _create_or_open(
        self, tr, path: Tuple[str, ...], layer: bytes,
        allow_create: bool, allow_open: bool,
    ):
        if not path:
            raise ValueError("the root directory cannot be opened")
        node, prefix = await self._find(tr, path)
        if node is not None:
            if not allow_open:
                raise FdbError("directory_already_exists")
            existing = await tr.get(node.pack((b"layer",))) or b""
            if layer and existing != layer:
                raise FdbError("directory_incompatible_layer")
            return DirectorySubspace(path, prefix, existing, self)
        if not allow_create:
            raise FdbError("directory_does_not_exist")
        # Create missing parents, then this directory.
        parent_node = self._node(b"")
        for name in path[:-1]:
            child = await tr.get(self._child_key(parent_node, name))
            if child is None:
                sub = await self._create_one(tr, parent_node, name, b"")
                child = sub
            parent_node = self._node(child)
        sub_prefix = await self._create_one(
            tr, parent_node, path[-1], layer
        )
        return DirectorySubspace(path, sub_prefix, layer, self)

    async def _create_one(self, tr, parent_node: Subspace, name: str,
                          layer: bytes) -> bytes:
        vid = await self._allocator.allocate(tr)
        prefix = self._content_prefix + fdbtuple.pack((vid,))
        # The allocated prefix must be virgin (ref: the prefix-free check).
        existing = await tr.get_range(
            prefix, prefix + b"\xff", limit=1, snapshot=True
        )
        if existing:
            raise FdbError("directory_prefix_not_empty")
        tr.set(self._child_key(parent_node, name), prefix)
        node = self._node(prefix)
        tr.set(node.pack((b"layer",)), layer)
        return prefix

    async def exists(self, tr, path) -> bool:
        node, _ = await self._find(tr, tuple(path))
        return node is not None

    async def list(self, tr, path=()) -> List[str]:
        node, _ = await self._find(tr, tuple(path))
        if node is None:
            raise FdbError("directory_does_not_exist")
        rows = await tr.get_range(*node[0].range())
        return [node[0].unpack(k)[0] for k, _v in rows]

    async def move(self, tr, old_path, new_path):
        old_path, new_path = tuple(old_path), tuple(new_path)
        if new_path[: len(old_path)] == old_path:
            raise FdbError("directory_moved_under_itself")
        node, prefix = await self._find(tr, old_path)
        if node is None:
            raise FdbError("directory_does_not_exist")
        if (await self._find(tr, new_path))[0] is not None:
            raise FdbError("directory_already_exists")
        parent_node, _ = await self._find(tr, new_path[:-1])
        if parent_node is None:
            raise FdbError("directory_does_not_exist")
        old_parent, _ = await self._find(tr, old_path[:-1])
        tr.clear(self._child_key(old_parent, old_path[-1]))
        tr.set(self._child_key(parent_node, new_path[-1]), prefix)
        layer = await tr.get(node.pack((b"layer",))) or b""
        return DirectorySubspace(new_path, prefix, layer, self)

    async def remove(self, tr, path) -> bool:
        """Delete the directory, its subdirectories, and ALL content."""
        path = tuple(path)
        if not path:
            raise ValueError("the root directory cannot be removed")
        node, prefix = await self._find(tr, path)
        if node is None:
            return False
        await self._remove_recursive(tr, node, prefix)
        parent_node, _ = await self._find(tr, path[:-1])
        tr.clear(self._child_key(parent_node, path[-1]))
        return True

    async def _remove_recursive(self, tr, node: Subspace, prefix: bytes):
        rows = await tr.get_range(*node[0].range())
        for _k, child_prefix in rows:
            await self._remove_recursive(
                tr, self._node(child_prefix), child_prefix
            )
        # Content + node metadata.
        tr.clear_range(prefix, prefix + b"\xff")
        b, e = self._node(prefix).range()
        tr.clear_range(b, e)
