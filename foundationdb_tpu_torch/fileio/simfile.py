"""Simulated async files with crash-durability fault injection.

The port's own copy of the reference package's ``fileio/simfile.py``
(modelled on fdbrpc/IAsyncFile.h:32-63, the async read/write/sync/truncate
contract, and fdbrpc/AsyncFileNonDurable.actor.h: KillMode {NO_CORRUPTION,
DROP_ONLY, FULL_CORRUPTION} at :169, and at :468-484 each unsynced write
independently dropped, applied partially, or bit-corrupted when the owning
machine dies).  This is how crash durability is proven, and the property
the DiskQueue and KV-store recovery rely on.

Durability model: a file holds `durable` bytes plus a list of pending
(offset, data) writes; sync() folds pending into durable.  On machine kill,
pending writes are resolved randomly per KillMode through the loop's
DeterministicRandom, in the reference's order of draws, so one seed gives
the reference's disk.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..flow.error import FdbError
from ..flow.eventloop import TaskPriority
from ..rpc.network import SimNetwork, SimProcess


class KillMode:
    NO_CORRUPTION = 0  # writes always survive (a perfect disk)
    DROP_ONLY = 1  # unsynced writes may vanish, never corrupt
    FULL_CORRUPTION = 2  # unsynced writes may vanish, truncate, or corrupt


class _SimFile:
    """On-"disk" state, owned by the machine (survives process kills)."""

    __slots__ = ("name", "durable", "pending", "open_handles")

    def __init__(self, name: str):
        self.name = name
        self.durable = bytearray()
        # (offset, bytes) in issue order; folded into durable on sync
        self.pending: List[Tuple[int, bytes]] = []
        self.open_handles = 0

    def _apply(self, offset: int, data: bytes):
        end = offset + len(data)
        if len(self.durable) < end:
            self.durable.extend(b"\x00" * (end - len(self.durable)))
        self.durable[offset:end] = data

    def view(self) -> bytes:
        """Contents as seen by readers (pending writes visible, like an OS
        page cache)."""
        img = bytearray(self.durable)
        for off, data in self.pending:
            end = off + len(data)
            if len(img) < end:
                img.extend(b"\x00" * (end - len(img)))
            img[off:end] = data
        return bytes(img)

    def sync(self):
        for off, data in self.pending:
            self._apply(off, data)
        self.pending = []

    def crash(self, rng, kill_mode: int):
        """Resolve pending writes per the kill mode (ref :468-484)."""
        pending, self.pending = self.pending, []
        if kill_mode == KillMode.NO_CORRUPTION:
            for off, data in pending:
                self._apply(off, data)
            return
        for off, data in pending:
            roll = rng.random01()
            if roll < 0.4:
                continue  # dropped entirely
            if kill_mode == KillMode.DROP_ONLY or roll < 0.7:
                if rng.coinflip():
                    self._apply(off, data)  # survived whole
                else:
                    n = rng.random_int(0, len(data) + 1)
                    self._apply(off, data[:n])  # torn write (prefix)
            else:
                # FULL_CORRUPTION: flip bytes somewhere in the write
                buf = bytearray(data)
                if not buf:
                    continue  # nothing to corrupt in a zero-length write
                for _ in range(rng.random_int(1, max(2, len(buf) // 8))):
                    buf[rng.random_int(0, len(buf))] = rng.random_int(0, 256)
                self._apply(off, bytes(buf))


class SimFileSystem:
    """All machines' disks; register with a SimNetwork to get kill hooks."""

    def __init__(self, network: SimNetwork, kill_mode: int = KillMode.FULL_CORRUPTION):
        self.network = network
        self.kill_mode = kill_mode
        # (machine_id, filename) -> _SimFile
        self._files: Dict[Tuple[str, str], _SimFile] = {}

    def open(
        self, process: SimProcess, filename: str, create: bool = True
    ) -> "SimAsyncFile":
        key = (process.machine.machine_id, filename)
        f = self._files.get(key)
        if f is None:
            if not create:
                raise FdbError("file_not_found")
            f = _SimFile(filename)
            self._files[key] = f
        f.open_handles += 1
        return SimAsyncFile(self, process, f)

    def exists(self, process: SimProcess, filename: str) -> bool:
        return (process.machine.machine_id, filename) in self._files

    def delete(self, process: SimProcess, filename: str):
        self._files.pop((process.machine.machine_id, filename), None)

    def crash_machine(self, machine_id: str):
        """Resolve unsynced writes on every file of the machine; call when
        killing a machine (the disk survives, the cache does not)."""
        rng = self.network.loop.rng
        for (mid, _name), f in self._files.items():
            if mid == machine_id:
                f.crash(rng, self.kill_mode)


class SimAsyncFile:
    """Per-process handle; I/O completes after a simulated disk latency
    (ref: IAsyncFile futures; latencies from Sim2's disk model)."""

    def __init__(self, fs: SimFileSystem, process: SimProcess, f: _SimFile):
        self.fs = fs
        self.process = process
        self._f = f

    def _disk_delay(self) -> float:
        rng = self.fs.network.loop.rng
        return 0.00005 + 0.0002 * rng.random01()

    async def read(self, offset: int, length: int) -> bytes:
        await self.fs.network.loop.delay(
            self._disk_delay(), TaskPriority.DiskRead
        )
        self._check_alive()
        return self._f.view()[offset : offset + length]

    def read_sync(self, offset: int, length: int) -> bytes:
        """Zero-virtual-latency page read for engines whose read path is
        synchronous (the btree engine; the reference charges such reads to
        coro threads that likewise block the storage actor)."""
        self._check_alive()
        return self._f.view()[offset : offset + length]

    async def write(self, offset: int, data: bytes):
        await self.fs.network.loop.delay(
            self._disk_delay(), TaskPriority.DiskWrite
        )
        self._check_alive()
        self._f.pending.append((offset, bytes(data)))

    async def sync(self):
        """Everything written before this call is durable after it (ref:
        IAsyncFile::sync ordering contract)."""
        await self.fs.network.loop.delay(
            0.0002 + 0.002 * self.fs.network.loop.rng.random01(),
            TaskPriority.DiskWrite,
        )
        self._check_alive()
        self._f.sync()

    async def truncate(self, size: int):
        """Clip durable and pending state to `size`; must NOT promote
        pending writes to durable (a real ftruncate is not a sync)."""
        await self.fs.network.loop.delay(
            self._disk_delay(), TaskPriority.DiskWrite
        )
        self._check_alive()
        del self._f.durable[size:]
        clipped = []
        for off, data in self._f.pending:
            if off >= size:
                continue
            clipped.append((off, data[: size - off]))
        self._f.pending = clipped

    def size(self) -> int:
        return len(self._f.view())

    def _check_alive(self):
        if not self.process.alive:
            raise FdbError("io_error")
