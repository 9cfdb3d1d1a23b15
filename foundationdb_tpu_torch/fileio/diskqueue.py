"""DiskQueue: durable framed log with prefix-durability commit.

The port's own copy of the reference package's ``fileio/diskqueue.py``
(modelled on fdbserver/IDiskQueue.h:28, the push/pop/commit contract:
after commit(), everything pushed before it is durable; after a crash, the
recovered log is a *prefix* of what was pushed, holding at least
everything committed; and on DiskQueue.actor.cpp).  One append file of
CRC-framed records plus a checksummed header page holding the popped
pointer; a torn or corrupted frame ends the recovery scan, which is what
yields prefix durability over the NonDurable crash model.  The bytes on
disk are the reference's.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

from ..rpc.network import SimProcess
from .simfile import SimAsyncFile, SimFileSystem

_MAGIC = 0xD1
_HEADER_SIZE = 64
_FRAME_HDR = struct.Struct("<BQI I")  # magic, seq, len, crc(seq||payload)
_HEADER = struct.Struct("<QQI")  # popped_seq, tail_hint, crc


def _frame_crc(seq: int, payload: bytes) -> int:
    return zlib.crc32(seq.to_bytes(8, "little") + payload) & 0xFFFFFFFF


class DiskQueue:
    def __init__(self, file: SimAsyncFile):
        self._file = file
        self._tail = _HEADER_SIZE  # next write offset
        self._pending: List[Tuple[int, bytes]] = []
        self.popped_seq = 0
        self._header_dirty = False
        # FIFO commit serialization: commit() snapshots _tail and then
        # awaits disk writes; a second commit entering during that await
        # would capture the same tail and clobber the first commit's frames
        # (acked-data loss after recovery).  Callers with multiple actors
        # (e.g. the coordinator's read/write serve loops) are safe.
        self._commit_chain = None

    # -- lifecycle --
    @classmethod
    async def open(
        cls, fs: SimFileSystem, process: SimProcess, filename: str
    ) -> Tuple["DiskQueue", List[Tuple[int, bytes]]]:
        """Open/create; returns (queue, recovered records beyond popped)."""
        f = fs.open(process, filename)
        q = cls(f)
        recovered: List[Tuple[int, bytes]] = []
        img = await f.read(0, f.size())
        if len(img) >= _HEADER.size:
            popped, _tail_hint, crc = _HEADER.unpack_from(img, 0)
            if zlib.crc32(img[:16]) & 0xFFFFFFFF == crc:
                q.popped_seq = popped
        off = _HEADER_SIZE
        while off + _FRAME_HDR.size <= len(img):
            magic, seq, length, crc = _FRAME_HDR.unpack_from(img, off)
            payload = img[off + _FRAME_HDR.size : off + _FRAME_HDR.size + length]
            if (
                magic != _MAGIC
                or len(payload) != length
                or _frame_crc(seq, payload) != crc
            ):
                break  # torn/corrupt frame: the durable prefix ends here
            if seq > q.popped_seq:
                recovered.append((seq, bytes(payload)))
            off += _FRAME_HDR.size + length
        q._tail = off
        # Discard any trash beyond the valid prefix so new frames are never
        # misread as a continuation of a torn one.
        await f.truncate(off)
        return q, recovered

    # -- IDiskQueue contract --
    def push(self, seq: int, payload: bytes):
        """Buffer a record; durable only after the next commit() returns."""
        self._pending.append((seq, payload))

    async def commit(self):
        """Write buffered frames + header, fsync; prefix-durable on return.
        Concurrent calls are serialized FIFO (see __init__)."""
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
        writes = []
        off = self._tail
        for seq, payload in self._pending:
            frame = (
                _FRAME_HDR.pack(
                    _MAGIC, seq, len(payload), _frame_crc(seq, payload)
                )
                + payload
            )
            writes.append((off, frame))
            off += len(frame)
        self._pending = []
        for w_off, data in writes:
            await self._file.write(w_off, data)
        # The commit chain gate serializes _commit_locked, and appends land
        # in _pending, never moving _tail: no other writer races this one.
        self._tail = off
        if self._header_dirty:
            # Clear the flag BEFORE the write's await: a pop() landing
            # while the header is in flight re-dirties it and the NEXT
            # commit persists the newer popped_seq.  Clearing after the
            # await erased that mark — the pop's progress was silently
            # dropped until some unrelated future pop re-dirtied the flag.
            self._header_dirty = False
            body = struct.pack("<QQ", self.popped_seq, self._tail)
            hdr = body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)
            await self._file.write(0, hdr)
        await self._file.sync()

    def pop(self, up_to_seq: int):
        """Logically discard records with seq <= up_to_seq (persisted with
        the next commit; space reclaim is a compaction concern, ref
        DiskQueue's file-ring recycling)."""
        if up_to_seq > self.popped_seq:
            self.popped_seq = up_to_seq
            self._header_dirty = True
