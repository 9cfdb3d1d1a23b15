"""Copy-on-write B+tree storage engine: datasets larger than RAM.

The port's own copy of the reference package's ``fileio/btree.py``; its
header rides the port's wire codec, whose bytes are the reference's.  The
ssd-class IKeyValueStore (ref: fdbserver/KeyValueStoreSQLite.actor.cpp
fills this role in the reference; fdbserver/IKeyValueStore.h:38 is the
contract).  This is NOT a sqlite port — it is a shadow-paging design in the
LMDB family, chosen because it needs no WAL/rollback journal and its crash
story maps exactly onto the simulator's crash model:

- Fixed-size pages; pages 0/1 are alternating header slots (generation,
  root page, page count, free list, CRC).  Recovery picks the valid header
  with the higher generation.
- Every commit copies each modified node to FRESH pages (never overwriting
  pages the previous durable tree references), syncs the data, then writes
  + syncs one header.  A crash at any point leaves the previous
  generation's tree fully intact.
- Pages freed while building generation G become allocatable at G+1 (once
  header G is durable, no valid recovery can need the G-1 tree).
- A node whose serialization exceeds one page spills into a chained page
  list, so correctness never depends on fit; the size-based split policy
  keeps chains rare (oversized keys/values are the exception, not the rule).
- Reads are synchronous (read_sync) against the durable file plus the
  uncommitted in-memory overlay; memory is bounded by an LRU cache of
  parsed nodes plus the overlay — the tree itself can exceed RAM.

Node pages use a STRICT fixed binary format (length-prefixed fields, CRC
per chunk) and the header body rides the versioned wire codec — a
corrupted or hostile page fails the schema/CRC check loudly instead of
deserializing arbitrary objects (ref: the reference's checksummed page
formats, e.g. sqlite page checksums in KeyValueStoreSQLite.actor.cpp's
role).  Other deviations from the reference engine, by design: no
underfull-node merging and no background vacuum (free-list reuse bounds
steady-state growth; `leaked_pages` counts free-list overflow), count()
is exact only between commits (its one caller is the status doc).
"""

from __future__ import annotations

import zlib
from bisect import bisect_left, bisect_right
from typing import Dict, List, Optional, Tuple

from ..flow.error import FdbError
from ..rpc.wire import WireDecodeError, decode_frame, encode_frame

PAGE_SIZE = 16384  # one 10KB key + node overhead must fit comfortably
HEADER_MAGIC = b"FDBTBT02"  # bumped: strict node format + chunk CRCs
MAX_FREE_IN_HEADER = 1024  # beyond this, pages leak (counted, not lost data)
NODE_FORMAT_V = 1


def _encode_node(leaf: bool, keys: list, vals: list) -> bytes:
    """Strict page body: version, leaf flag, counted length-prefixed keys,
    then leaf values (length-prefixed) or branch child page ids (8B)."""
    parts = [
        bytes((NODE_FORMAT_V, 1 if leaf else 0)),
        len(keys).to_bytes(4, "big"),
    ]
    for k in keys:
        parts.append(len(k).to_bytes(4, "big"))
        parts.append(k)
    if leaf:
        for v in vals:
            parts.append(len(v).to_bytes(4, "big"))
            parts.append(v)
    else:
        for v in vals:
            parts.append(int(v).to_bytes(8, "big"))
    return b"".join(parts)


def _decode_node(data: bytes) -> Tuple[bool, list, list]:
    """Inverse of _encode_node; every bound is checked — malformed input
    raises file_corrupt, never produces an undersized node silently."""
    try:
        if data[0] != NODE_FORMAT_V or data[1] not in (0, 1):
            raise ValueError("bad node header")
        leaf = data[1] == 1
        n = int.from_bytes(data[2:6], "big")
        off = 6
        keys = []
        for _ in range(n):
            ln = int.from_bytes(data[off : off + 4], "big")
            off += 4
            if off + ln > len(data):
                raise ValueError("key overruns page")
            keys.append(data[off : off + ln])
            off += ln
        vals = []
        if leaf:
            for _ in range(n):
                ln = int.from_bytes(data[off : off + 4], "big")
                off += 4
                if off + ln > len(data):
                    raise ValueError("value overruns page")
                vals.append(data[off : off + ln])
                off += ln
        else:
            for _ in range(n + 1):
                if off + 8 > len(data):
                    raise ValueError("child id overruns page")
                vals.append(int.from_bytes(data[off : off + 8], "big"))
                off += 8
        if off != len(data):
            raise ValueError("trailing bytes in node page")
        return leaf, keys, vals
    except (ValueError, IndexError) as e:
        raise FdbError("file_corrupt") from e


class _Node:
    __slots__ = ("leaf", "keys", "vals")

    def __init__(self, leaf: bool, keys: list, vals: list):
        self.leaf = leaf
        self.keys = keys
        # leaf: vals[i] = value bytes for keys[i]
        # branch: vals = len(keys)+1 children, each an int page id (clean,
        #         on disk) or a _Node (dirty, in memory).  Child i covers
        #         [keys[i-1], keys[i]) with -inf/+inf at the edges, matching
        #         bisect_right descent.
        self.vals = vals

    def size_estimate(self) -> int:
        s = 64 + 16 * len(self.keys) + sum(len(k) for k in self.keys)
        if self.leaf:
            s += sum(len(v) for v in self.vals)
        else:
            s += 8 * len(self.vals)
        return s


class BTreeKeyValueStore:
    """IKeyValueStore over a COW B+tree (see module docstring)."""

    def __init__(self, file, page_size: int = PAGE_SIZE, cache_pages: int = 512):
        self._file = file
        self._ps = page_size
        self._cache_cap = cache_pages
        self._cache: Dict[int, _Node] = {}  # clean nodes, LRU by dict order
        self._gen = 0
        self._root = None  # int pid | _Node (dirty) | None (empty tree)
        self._npages = 2  # pages 0/1 reserved for headers
        self._free: List[int] = []  # allocatable now
        self._freed_this: List[int] = []  # allocatable next generation
        self._leaked = 0
        self._n_keys = 0
        # Uncommitted overlay: ordered op log, applied to the tree at
        # commit(); reads resolve through it first.
        self._ops: List[Tuple[str, bytes, bytes]] = []
        # FIFO commit gate (same pattern as DiskQueue.commit): the tree
        # mutation + flush + header write is NOT reentrant — concurrent
        # commits must serialize, each taking whatever ops are buffered at
        # its turn.
        self._commit_chain = None

    # ---------- lifecycle ----------
    @classmethod
    async def open(cls, fs, process, filename: str,
                   page_size: int = PAGE_SIZE,
                   cache_pages: int = 512) -> "BTreeKeyValueStore":
        f = fs.open(process, filename)
        kv = cls(f, page_size=page_size, cache_pages=cache_pages)
        best = None
        for slot in (0, 1):
            hdr = kv._parse_header(f.read_sync(slot * kv._ps, kv._ps))
            if hdr is not None and (best is None or hdr["gen"] > best["gen"]):
                best = hdr
        if best is not None:
            kv._gen = best["gen"]
            kv._root = best["root"]
            kv._npages = best["npages"]
            kv._free = list(best["free"])
            kv._leaked = best["leaked"]
            kv._n_keys = best["n_keys"]
        else:
            # Fresh file: make generation 0 durable so a crash before the
            # first commit still recovers an (empty) store.
            await kv._write_header()
        return kv

    def _parse_header(self, raw: bytes) -> Optional[dict]:
        if len(raw) >= 8 and raw[:6] == b"FDBTBT" and raw[:8] != HEADER_MAGIC:
            # A RECOGNIZED older/newer format must refuse loudly: treating
            # it as "no header" would reinitialize an empty store over real
            # data (the WAL's counterpart raises file_corrupt likewise).
            raise FdbError("file_corrupt")
        if len(raw) < 16 or raw[:8] != HEADER_MAGIC:
            return None
        length = int.from_bytes(raw[8:12], "big")
        crc = int.from_bytes(raw[12:16], "big")
        body = raw[16 : 16 + length]
        if len(body) < length or zlib.crc32(body) != crc:
            return None
        try:
            hdr = decode_frame(body)
            if not isinstance(hdr, dict):
                return None
            return hdr
        except WireDecodeError:
            return None

    async def _write_header(self):
        assert isinstance(self._root, (int, type(None)))
        body = encode_frame(
            {
                "gen": self._gen,
                "root": self._root,
                "npages": self._npages,
                "free": self._free,
                "leaked": self._leaked,
                "n_keys": self._n_keys,
            }
        )
        raw = (
            HEADER_MAGIC
            + len(body).to_bytes(4, "big")
            + zlib.crc32(body).to_bytes(4, "big")
            + body
        )
        assert len(raw) <= self._ps, "header overflowed a page"
        await self._file.write((self._gen % 2) * self._ps, raw)
        await self._file.sync()

    # ---------- page I/O ----------
    def _alloc(self) -> int:
        if self._free:
            return self._free.pop()
        pid = self._npages
        self._npages += 1
        return pid

    def _free_page_chain(self, pid: int):
        """Free a node's first page and its continuation chain."""
        while pid is not None:
            if len(self._freed_this) + len(self._free) < MAX_FREE_IN_HEADER:
                self._freed_this.append(pid)
            else:
                self._leaked += 1
            raw = self._file.read_sync(pid * self._ps, 12)
            nxt = int.from_bytes(raw[4:12], "big")
            pid = (nxt - 1) if nxt else None

    def _cache_put(self, pid: int, node: _Node):
        self._cache[pid] = node
        while len(self._cache) > self._cache_cap:
            self._cache.pop(next(iter(self._cache)))

    def _read_node(self, pid: int) -> _Node:
        node = self._cache.pop(pid, None)
        if node is not None:
            self._cache[pid] = node  # LRU bump
            return node
        chunks = []
        p = pid
        seen = set()
        while p is not None:
            if p in seen:
                # A corrupted nxt pointer forming a cycle must fail, not
                # loop forever (the CRC covers the header too, but belt
                # and braces for a colliding checksum).
                raise FdbError("file_corrupt")
            seen.add(p)
            raw = self._file.read_sync(p * self._ps, self._ps)
            clen = int.from_bytes(raw[:4], "big")
            nxt = int.from_bytes(raw[4:12], "big")
            crc = int.from_bytes(raw[12:16], "big")
            if clen > self._ps - 16:
                raise FdbError("file_corrupt")
            chunk = raw[16 : 16 + clen]
            # CRC spans the chunk header (clen, nxt) AND the payload: a
            # flipped nxt must fail here, not wander the page file.
            if zlib.crc32(raw[:12] + chunk) != crc:
                raise FdbError("file_corrupt")
            chunks.append(chunk)
            p = (nxt - 1) if nxt else None
        leaf, keys, vals = _decode_node(b"".join(chunks))
        node = _Node(leaf, keys, vals)
        self._cache_put(pid, node)
        return node

    async def _write_node(self, node: _Node) -> int:
        assert node.leaf or not any(isinstance(c, _Node) for c in node.vals), (
            "dirty child leaked into serialization; _flush must resolve "
            "children first"
        )
        data = _encode_node(node.leaf, node.keys, node.vals)
        room = self._ps - 16
        chunks = [data[i : i + room] for i in range(0, len(data), room)] or [b""]
        pids = [self._alloc() for _ in chunks]
        if len(chunks) > 1:
            from ..flow.testprobe import test_probe

            test_probe("btree_chained_node")
        for i, chunk in enumerate(chunks):
            nxt = (pids[i + 1] + 1) if i + 1 < len(chunks) else 0
            hdr = len(chunk).to_bytes(4, "big") + nxt.to_bytes(8, "big")
            await self._file.write(
                pids[i] * self._ps,
                hdr + zlib.crc32(hdr + chunk).to_bytes(4, "big") + chunk,
            )
        self._cache_put(pids[0], node)
        return pids[0]

    def _child(self, ptr) -> _Node:
        return ptr if isinstance(ptr, _Node) else self._read_node(ptr)

    def _cow(self, ptr) -> _Node:
        """COW: loading a child for modification.  A clean (on-disk) child's
        pages are freed and a mutable copy returned; a dirty child is
        already exclusively ours."""
        if isinstance(ptr, _Node):
            return ptr
        node = self._read_node(ptr)
        self._cache.pop(ptr, None)
        self._free_page_chain(ptr)
        return _Node(node.leaf, list(node.keys), list(node.vals))

    # ---------- tree ops (in-memory COW, run inside commit) ----------
    def _split_if_needed(self, node: _Node) -> List[Tuple[bytes, _Node]]:
        """[(separator-or-b'', node)] — one entry, or two after a split."""
        if node.size_estimate() <= self._ps - 64 or len(node.keys) < 2:
            return [(b"", node)]
        mid = len(node.keys) // 2
        if node.leaf:
            left = _Node(True, node.keys[:mid], node.vals[:mid])
            right = _Node(True, node.keys[mid:], node.vals[mid:])
            sep = right.keys[0]
        else:
            left = _Node(False, node.keys[:mid], node.vals[: mid + 1])
            right = _Node(False, node.keys[mid + 1 :], node.vals[mid + 1 :])
            sep = node.keys[mid]
        return [(b"", left), (sep, right)]

    def _insert(self, ptr, key: bytes, value: bytes) -> List[Tuple[bytes, _Node]]:
        node = self._cow(ptr)
        if node.leaf:
            i = bisect_left(node.keys, key)
            if i < len(node.keys) and node.keys[i] == key:
                node.vals[i] = value
            else:
                node.keys.insert(i, key)
                node.vals.insert(i, value)
                self._n_keys += 1
            return self._split_if_needed(node)
        i = bisect_right(node.keys, key)
        parts = self._insert(node.vals[i], key, value)
        node.vals[i] = parts[0][1]
        if len(parts) == 2:
            node.keys.insert(i, parts[1][0])
            node.vals.insert(i + 1, parts[1][1])
        return self._split_if_needed(node)

    def _clear(self, ptr, begin: bytes, end: bytes):
        """Remove [begin, end) from the subtree at ptr.
        Returns (new_ptr_or_None, changed) — new_ptr may be the original
        ptr (unchanged), a dirty _Node, or None (subtree emptied)."""
        node = self._child(ptr)
        if node.leaf:
            i = bisect_left(node.keys, begin)
            j = bisect_left(node.keys, end)
            if i == j:
                return ptr, False
            node = self._cow(ptr)
            self._n_keys -= j - i
            del node.keys[i:j]
            del node.vals[i:j]
            return (node, True) if node.keys else (None, True)
        # Branch: child i covers [keys[i-1], keys[i]) (edges open).
        new_children: List = []
        dropped = False
        changed = False
        for ci, child in enumerate(node.vals):
            lo = node.keys[ci - 1] if ci > 0 else None
            hi = node.keys[ci] if ci < len(node.keys) else None
            intersects = (lo is None or lo < end) and (hi is None or hi > begin)
            if not intersects:
                new_children.append(child)
                continue
            sub, sub_changed = self._clear(child, begin, end)
            changed = changed or sub_changed
            if sub is None:
                dropped = True
            else:
                new_children.append(sub)
        if not changed:
            return ptr, False
        node = self._cow(ptr)
        if not new_children:
            return None, True
        if len(new_children) == 1:
            # Collapse the single-child branch: the child replaces us.
            return new_children[0], True
        node.vals = new_children
        if dropped:
            # Separators must be rebuilt: first key of each child from 1..
            # (valid: it is > every key in the preceding child and <= every
            # key in its own).
            node.keys = [self._subtree_first_key(c) for c in new_children[1:]]
        else:
            # No child vanished; the old separators still bound the
            # surviving children correctly — but only keep the ones between
            # surviving children (none vanished, so all of them).
            node.keys = node.keys[: len(new_children) - 1]
        return node, True

    def _subtree_first_key(self, ptr) -> bytes:
        node = self._child(ptr)
        while not node.leaf:
            node = self._child(node.vals[0])
        assert node.keys, "empty leaf survived a clear"
        return node.keys[0]

    # ---------- reads ----------
    def read_value(self, key: bytes) -> Optional[bytes]:
        for op, a, b in reversed(self._ops):  # newest overlay op wins
            if op == "set" and a == key:
                return b
            if op == "clear" and a <= key < b:
                return None
        return self._tree_get(key)

    def _tree_get(self, key: bytes) -> Optional[bytes]:
        if self._root is None:
            return None
        node = self._child(self._root)
        while not node.leaf:
            node = self._child(node.vals[bisect_right(node.keys, key)])
        i = bisect_left(node.keys, key)
        if i < len(node.keys) and node.keys[i] == key:
            return node.vals[i]
        return None

    def _tree_scan(self, begin: bytes, end: bytes, reverse: bool = False):
        """Yield (k, v) of [begin, end) from the durable tree, in order."""
        if self._root is None:
            return

        def rec(node):
            if node.leaf:
                i = bisect_left(node.keys, begin)
                j = bisect_left(node.keys, end)
                rng = range(j - 1, i - 1, -1) if reverse else range(i, j)
                for t in rng:
                    yield node.keys[t], node.vals[t]
                return
            order = range(len(node.vals))
            if reverse:
                order = reversed(order)
            for ci in order:
                lo = node.keys[ci - 1] if ci > 0 else None
                hi = node.keys[ci] if ci < len(node.keys) else None
                if (lo is None or lo < end) and (hi is None or hi > begin):
                    yield from rec(self._child(node.vals[ci]))

        yield from rec(self._child(self._root))

    def _overlay_view(self, begin: bytes, end: bytes):
        """Resolve the op log over [begin, end): surviving sets + the clear
        intervals (a tree key under any clear is masked unless re-set)."""
        sets: Dict[bytes, bytes] = {}
        clears: List[Tuple[bytes, bytes]] = []
        for op, a, b in self._ops:
            if op == "set":
                if begin <= a < end:
                    sets[a] = b
            else:
                lo, hi = max(a, begin), min(b, end)
                if lo < hi:
                    clears.append((lo, hi))
                    for k in [k for k in sets if lo <= k < hi]:
                        del sets[k]
        return sets, clears

    def read_range(
        self,
        begin: bytes,
        end: bytes,
        limit: int = 1 << 30,
        reverse: bool = False,
    ) -> List[Tuple[bytes, bytes]]:
        sets, clears = self._overlay_view(begin, end)
        masked = lambda k: any(lo <= k < hi for lo, hi in clears)  # noqa: E731
        out: List[Tuple[bytes, bytes]] = []
        set_keys = sorted(sets, reverse=reverse)
        si = 0

        def before(a: bytes, b: bytes) -> bool:
            return a < b if not reverse else a > b

        for k, v in self._tree_scan(begin, end, reverse):
            while si < len(set_keys) and before(set_keys[si], k):
                out.append((set_keys[si], sets[set_keys[si]]))
                si += 1
                if len(out) >= limit:
                    return out
            if si < len(set_keys) and set_keys[si] == k:
                out.append((k, sets[k]))
                si += 1
            elif not masked(k):
                out.append((k, v))
            if len(out) >= limit:
                return out
        while si < len(set_keys) and len(out) < limit:
            out.append((set_keys[si], sets[set_keys[si]]))
            si += 1
        return out

    def read_keys_page(
        self, begin: bytes, end: bytes, limit: int, reverse: bool = False
    ) -> List[bytes]:
        return [k for k, _v in self.read_range(begin, end, limit, reverse)]

    def count(self) -> int:
        return self._n_keys  # exact between commits (see module docstring)

    @property
    def leaked_pages(self) -> int:
        return self._leaked

    def file_pages(self) -> int:
        return self._npages

    # ---------- writes ----------
    def set(self, key: bytes, value: bytes):
        self._ops.append(("set", key, value))

    def clear_range(self, begin: bytes, end: bytes):
        self._ops.append(("clear", begin, end))

    async def commit(self):
        from ..flow.future import Promise

        prev = self._commit_chain
        gate = Promise()
        self._commit_chain = gate.future
        if prev is not None:
            await prev
        try:
            await self._commit_locked()
        finally:
            gate.send(None)
            if self._commit_chain is gate.future:
                self._commit_chain = None

    async def _commit_locked(self):
        ops, self._ops = self._ops, []
        for op, a, b in ops:
            if op == "set":
                if self._root is None:
                    self._root = _Node(True, [a], [b])
                    self._n_keys += 1
                    continue
                parts = self._insert(self._root, a, b)
                if len(parts) == 1:
                    self._root = parts[0][1]
                else:
                    self._root = _Node(
                        False, [parts[1][0]], [parts[0][1], parts[1][1]]
                    )
            elif self._root is not None:
                self._root, _changed = self._clear(self._root, a, b)
        if isinstance(self._root, _Node):
            self._root = await self._flush(self._root)  # _root has one writer in flight: the commit chain gate serializes _commit_locked
        await self._file.sync()  # data pages durable before the header
        self._gen += 1
        # Pages freed building this generation go INTO the new header's
        # free list: once that header is durable they are genuinely
        # unreferenced, and a crash BEFORE it recovers the old header
        # (which still references them and never saw this free list).
        # Extending the in-memory list here is safe — no allocation happens
        # between this point and the header write — and deferring it past
        # _write_header (the old ordering) permanently leaked every
        # commit's COW'd working set on each crash: the pages were in
        # neither the tree, nor the durable free list, nor `leaked`.
        self._free.extend(self._freed_this)
        self._freed_this = []
        await self._write_header()

    async def _flush(self, node: _Node) -> int:
        if not node.leaf:
            for i, c in enumerate(node.vals):
                if isinstance(c, _Node):
                    node.vals[i] = await self._flush(c)
        return await self._write_node(node)
