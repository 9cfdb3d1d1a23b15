"""IKeyValueStore + the memory engine (RAM map, disk-queue WAL + snapshot).

The port's own copy of the reference package's ``fileio/kvstore.py``
(modelled on fdbserver/IKeyValueStore.h:38, the set/clear/commit/readValue/
readRange contract: mutations are visible at once, durable when commit()
returns, and on KeyValueStoreMemory.actor.cpp: an in-RAM map whose ops are
logged to a DiskQueue, with a full snapshot pushed into the same queue
every SNAPSHOT_EVERY_BYTES so the log can be popped).  ``open_engine``
opens "memory", "btree" or either with "+compress".
"""

from __future__ import annotations

import zlib
from bisect import bisect_left, insort
from typing import Dict, List, Optional, Tuple

from ..flow.error import FdbError
from ..rpc.network import SimProcess
from .diskqueue import DiskQueue
from .simfile import SimFileSystem

WAL_FORMAT_V = 1


def _enc_pairs(tag: bytes, rows, ops: bool) -> bytes:
    """Strict WAL frame: tag, format version, then length-prefixed pairs
    (op records carry a 1-byte opcode).  No pickle touches the disk — a
    corrupted or hostile record fails the bounds check, it never
    deserializes arbitrary objects (the DiskQueue CRC already covers
    accidental torn writes)."""
    parts = [tag, bytes((WAL_FORMAT_V,))]
    for row in rows:
        if ops:
            op, a, b = row
            parts.append(b"\x00" if op == "set" else b"\x01")
        else:
            a, b = row
        parts.append(len(a).to_bytes(4, "big"))
        parts.append(a)
        parts.append(len(b).to_bytes(4, "big"))
        parts.append(b)
    return b"".join(parts)


def _dec_pairs(payload: bytes, ops: bool):
    """Inverse of _enc_pairs (minus the tag byte, already dispatched)."""
    try:
        if payload[0] != WAL_FORMAT_V:
            raise ValueError("bad WAL format version")
        off = 1
        out = []
        n = len(payload)
        while off < n:
            if ops:
                code = payload[off]
                if code > 1:
                    raise ValueError("bad opcode")
                off += 1
            la = int.from_bytes(payload[off : off + 4], "big")
            off += 4
            if off + la > n:
                raise ValueError("field overruns record")
            a = payload[off : off + la]
            off += la
            lb = int.from_bytes(payload[off : off + 4], "big")
            off += 4
            if off + lb > n:
                raise ValueError("field overruns record")
            b = payload[off : off + lb]
            off += lb
            out.append(("set" if code == 0 else "clear", a, b) if ops else (a, b))
        return out
    except (ValueError, IndexError) as e:
        raise FdbError("file_corrupt") from e


class IKeyValueStore:
    """The storage-engine contract (ref IKeyValueStore.h:38)."""

    def set(self, key: bytes, value: bytes):
        raise NotImplementedError

    def clear_range(self, begin: bytes, end: bytes):
        raise NotImplementedError

    async def commit(self):
        raise NotImplementedError

    def read_value(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def read_range(
        self, begin: bytes, end: bytes, limit: int = 1 << 30
    ) -> List[Tuple[bytes, bytes]]:
        raise NotImplementedError


async def open_engine(engine: str, fs, process, filename: str):
    """Engine factory (ref: openKVStore's type dispatch,
    KeyValueStoreMemory.actor.cpp / KeyValueStoreSQLite.actor.cpp)."""
    if engine.endswith("+compress"):
        return CompressedKeyValueStore(
            await open_engine(engine[: -len("+compress")], fs, process, filename)
        )
    if engine == "memory":
        return await KeyValueStoreMemory.open(fs, process, filename)
    if engine == "btree":
        from .btree import BTreeKeyValueStore

        return await BTreeKeyValueStore.open(fs, process, filename)
    raise ValueError(f"unknown storage engine {engine!r}")


class KeyValueStoreMemory(IKeyValueStore):
    """RAM map + WAL; recovery = last snapshot + subsequent op records."""

    SNAPSHOT_EVERY_BYTES = 1 << 20

    def __init__(self, queue: DiskQueue):
        self._q = queue
        self._data: Dict[bytes, bytes] = {}
        self._keys: List[bytes] = []
        self._uncommitted: List[Tuple[str, bytes, bytes]] = []
        self._seq = queue.popped_seq
        self._bytes_since_snapshot = 0

    # -- lifecycle --
    @classmethod
    async def open(
        cls, fs: SimFileSystem, process: SimProcess, filename: str
    ) -> "KeyValueStoreMemory":
        queue, records = await DiskQueue.open(fs, process, filename)
        kv = cls(queue)
        # Find the last complete snapshot, replay ops after it.
        snap_idx = None
        for i, (_seq, payload) in enumerate(records):
            if payload[:1] == b"S":
                snap_idx = i
        start = 0
        if snap_idx is not None:
            kv._data = dict(_dec_pairs(records[snap_idx][1][1:], ops=False))
            start = snap_idx + 1
        for seq, payload in records[start:]:
            if payload[:1] != b"O":
                continue
            for op, k, v in _dec_pairs(payload[1:], ops=True):
                kv._apply(op, k, v)
        kv._keys = sorted(kv._data)
        kv._seq = records[-1][0] if records else queue.popped_seq
        return kv

    # -- writes --
    def set(self, key: bytes, value: bytes):
        self._uncommitted.append(("set", key, value))
        self._apply("set", key, value, maintain_index=True)

    def clear_range(self, begin: bytes, end: bytes):
        self._uncommitted.append(("clear", begin, end))
        self._apply("clear", begin, end, maintain_index=True)

    def _apply(self, op: str, a: bytes, b: bytes, maintain_index: bool = False):
        if op == "set":
            if maintain_index and a not in self._data:
                insort(self._keys, a)
            self._data[a] = b
        else:
            if maintain_index:
                i = bisect_left(self._keys, a)
                j = bisect_left(self._keys, b)
                for k in self._keys[i:j]:
                    del self._data[k]
                del self._keys[i:j]
            else:
                for k in [k for k in self._data if a <= k < b]:
                    del self._data[k]

    async def commit(self):
        """Durable when returned (ref IKeyValueStore.h:43)."""
        ops, self._uncommitted = self._uncommitted, []
        self._seq += 1
        payload = _enc_pairs(b"O", ops, ops=True)
        self._q.push(self._seq, payload)
        self._bytes_since_snapshot += len(payload)
        await self._q.commit()
        if self._bytes_since_snapshot >= self.SNAPSHOT_EVERY_BYTES:
            await self._snapshot()

    async def _snapshot(self):
        """Push the full map, then pop everything before it (ref: the memory
        engine's interleaved snapshot chunks).

        Two-phase on purpose: the pop (header write) must only become
        durable AFTER the snapshot frame is — the crash model resolves
        pending writes independently, and a surviving popped pointer with a
        dropped snapshot frame would discard acknowledged records.
        """
        self._seq += 1
        self._q.push(
            self._seq, _enc_pairs(b"S", list(self._data.items()), ops=False)
        )
        await self._q.commit()  # phase 1: snapshot frame durable
        self._q.pop(self._seq - 1)
        await self._q.commit()  # phase 2: popped pointer durable
        self._bytes_since_snapshot = 0

    # -- reads --
    def read_value(self, key: bytes) -> Optional[bytes]:
        return self._data.get(key)

    def read_keys_page(
        self, begin: bytes, end: bytes, limit: int, reverse: bool = False
    ) -> List[bytes]:
        """Up to `limit` keys of [begin, end) in scan order (the base-key
        feed for the storage's window-over-base merge)."""
        i = bisect_left(self._keys, begin)
        j = bisect_left(self._keys, end)
        if reverse:
            lo = max(i, j - limit)
            return self._keys[lo:j][::-1]
        return self._keys[i : min(j, i + limit)]

    def count(self) -> int:
        return len(self._keys)

    def read_range(
        self, begin: bytes, end: bytes, limit: int = 1 << 30
    ) -> List[Tuple[bytes, bytes]]:
        i = bisect_left(self._keys, begin)
        j = bisect_left(self._keys, end)
        out = []
        for k in self._keys[i : min(j, i + limit)]:
            out.append((k, self._data[k]))
        return out


class CompressedKeyValueStore(IKeyValueStore):
    """Value-compressing wrapper over any engine (ref: the
    KeyValueStoreCompressTestData wrapper, fdbserver/
    KeyValueStoreCompressTestData.actor.cpp — exercises every caller
    against values whose stored form differs from their logical form).
    Keys stay raw (ordering/range semantics untouched); values zlib."""

    _MAGIC = b"\x01z"  # prefix distinguishes compressed from empty

    def __init__(self, inner):
        self.inner = inner

    # -- writes --
    def set(self, key: bytes, value: bytes):
        self.inner.set(key, self._MAGIC + zlib.compress(value, 1))

    def clear_range(self, begin: bytes, end: bytes):
        self.inner.clear_range(begin, end)

    async def commit(self):
        await self.inner.commit()

    # -- reads --
    def _load(self, raw: Optional[bytes]) -> Optional[bytes]:
        if raw is None:
            return None
        if not raw.startswith(self._MAGIC):
            raise FdbError("file_corrupt")
        try:
            return zlib.decompress(raw[len(self._MAGIC):])
        except zlib.error as e:
            raise FdbError("file_corrupt") from e

    def read_value(self, key: bytes) -> Optional[bytes]:
        return self._load(self.inner.read_value(key))

    def read_range(
        self, begin: bytes, end: bytes, limit: int = 1 << 30
    ) -> List[Tuple[bytes, bytes]]:
        return [
            (k, self._load(v))
            for k, v in self.inner.read_range(begin, end, limit)
        ]

    def read_keys_page(self, *a, **kw):
        return self.inner.read_keys_page(*a, **kw)

    def count(self) -> int:
        return self.inner.count()
