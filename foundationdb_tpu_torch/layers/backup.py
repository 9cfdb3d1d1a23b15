"""Backup and restore agents over TaskBucket.

The port's own copy of the reference package's ``layers/backup.py``.

Ref: fdbclient/FileBackupAgent.actor.cpp + BackupContainer.actor.cpp —
submitBackup queues a TaskBucket task; agent processes claim range-dump
tasks, write row pages into a backup container, and chain continuation
tasks until the manifest completes; restore replays the container in
batched transactions.

Two backup modes:
- FileBackupAgent: one-shot snapshot at a single read version (restarts
  on transaction_too_old) — the simple image copy.
- ContinuousBackupAgent: snapshot + CONTINUOUS mutation log — registers
  a consumer tag on the source logs (like the reference's `\\xff/backupLog`
  stream feeding log files), tails the merged stream into log-chunk
  files, and supports point-in-time restore at ANY version between the
  snapshot and the last logged chunk (ref: FileBackupAgent's range dumps
  + mutation logs stitched by applyMutations at restore).

The container is a directory of wire-codec page/log files on the cluster's
simulated filesystem (the BlobStore stand-in).
"""

from __future__ import annotations

from typing import List, Optional

from ..client.types import key_after
from ..flow.error import FdbError
from ..rpc.wire import decode_frame, encode_frame
from .subspace import Subspace
from .taskbucket import TaskBucket, TaskBucketExecutor

PAGE_ROWS = 1000


class BackupContainer:
    """A directory of page files + a manifest (ref: BackupContainer's
    kvranges/ + snapshot manifest layout, compacted)."""

    def __init__(self, fs, process, path: str):
        self.fs = fs
        self.process = process
        self.path = path
        self._n = 0

    async def _write_blob(self, name: str, obj) -> str:
        """Length-prefixed wire-codec blob, synced (the twin of _read_blob)."""
        f = self.fs.open(self.process, name)
        blob = encode_frame(obj)
        await f.write(0, len(blob).to_bytes(8, "big") + blob)
        await f.sync()
        return name

    async def write_page(self, index: int, begin: bytes, rows) -> str:
        return await self._write_blob(
            f"{self.path}/range-{index:06d}", (begin, rows)
        )

    async def write_manifest(
        self, version: int, pages: int, begin: bytes = b"", end: bytes = b"\xff"
    ):
        await self.write_manifest2(
            {"version": version, "pages": pages, "begin": begin, "end": end}
        )

    async def _read_blob(self, name: str):
        f = self.fs.open(self.process, name)
        size = f.size()
        if size < 8:
            return None
        img = await f.read(0, size)
        n = int.from_bytes(img[:8], "big")
        if len(img) < 8 + n:
            return None
        return decode_frame(img[8 : 8 + n])

    async def read_manifest(self) -> Optional[dict]:
        if not self.fs.exists(self.process, f"{self.path}/manifest"):
            return None
        return await self._read_blob(f"{self.path}/manifest")

    async def read_page(self, index: int):
        return await self._read_blob(f"{self.path}/range-{index:06d}")

    # -- mutation-log files (ref: the logs/ half of BackupContainer) --
    async def write_log_chunk(self, index: int, begin_ver: int,
                              end_ver: int, entries) -> str:
        """entries: [(version, [Mutation])], versions in (begin_ver,
        end_ver]."""
        return await self._write_blob(
            f"{self.path}/log-{index:06d}", (begin_ver, end_ver, entries)
        )

    async def read_log_chunk(self, index: int):
        return await self._read_blob(f"{self.path}/log-{index:06d}")

    async def delete_blob(self, name: str) -> None:
        self.fs.delete(self.process, name)

    async def delete_log_chunk(self, index: int) -> None:
        await self.delete_blob(f"{self.path}/log-{index:06d}")

    async def write_manifest2(self, manifest: dict):
        """Full-dict manifest writer (continuous backups update it after
        every durable log chunk so the container is restorable at any
        moment)."""
        await self._write_blob(f"{self.path}/manifest", manifest)


class BlobBackupContainer(BackupContainer):
    """BackupContainer over an S3-style blob store (ref: the
    blobstore:// BackupContainer flavor, BackupContainer.actor.cpp +
    fdbrpc/BlobStore.h:34).  Blobs are encoded with the versioned tagged
    wire codec — no pickle crosses the store (a corrupted or hostile
    object fails schema checks instead of executing)."""

    def __init__(self, url: str):
        from ..fileio.blobstore import BlobStoreEndpoint

        # path IS the url: backup tasks round-trip container.path through
        # the task bucket and re-open it via open_container, which must
        # re-dispatch to the blob flavor (query-string knobs are for
        # direct endpoint construction, not container URLs).
        from urllib.parse import urlparse

        if "?" in url:
            raise ValueError("container URLs carry no knob query string")
        if not urlparse(url).path.strip("/"):
            # _object_key strips the first path segment as the bucket; a
            # bucket-less URL would silently shift every object key.
            raise ValueError(
                "container URL must include a bucket: blobstore://host:port/bucket[/path]"
            )
        super().__init__(fs=None, process=None, path=url)
        self.endpoint = BlobStoreEndpoint.from_url(url)

    @staticmethod
    def _object_key(name: str) -> str:
        """blobstore://host:port/bucket/a/b -> a/b (bucket-relative)."""
        from urllib.parse import urlparse

        segs = urlparse(name).path.strip("/").split("/")
        return "/".join(segs[1:])

    async def _write_blob(self, name: str, obj) -> str:
        from ..rpc.wire import encode_frame

        self.endpoint.put_object(self._object_key(name), encode_frame(obj))
        return name

    async def _read_blob(self, name: str):
        from ..flow.error import FdbError
        from ..rpc.wire import decode_frame

        try:
            return decode_frame(
                self.endpoint.get_object(self._object_key(name))
            )
        except FdbError as e:
            if e.name == "file_not_found":
                return None
            raise

    async def read_manifest(self) -> Optional[dict]:
        return await self._read_blob(f"{self.path}/manifest")

    async def delete_blob(self, name: str) -> None:
        self.endpoint.delete_object(self._object_key(name))


def open_container(path: str, fs=None, process=None):
    """Container factory by URL scheme (ref: IBackupContainer::openContainer
    dispatching file:// vs blobstore://, BackupContainer.actor.cpp)."""
    if path.startswith("blobstore://"):
        return BlobBackupContainer(path)
    return BackupContainer(fs, process, path)


class FileBackupAgent:
    """Snapshot backup driver (ref: FileBackupAgent submitBackup :?  +
    the RangeDump task family)."""

    def __init__(
        self,
        db,
        fs,
        store_process=None,
        bucket_prefix: bytes = b"\xff\x02/backup/",
    ):
        # Task state lives in the system keyspace like the reference's
        # (ref: the backup agent's config space under \xff\x02).  The
        # container filesystem is keyed per machine, so all agents write
        # through ONE store process — the stand-in for a shared blobstore
        # endpoint (ref: BlobStoreEndpoint fdbrpc/BlobStore.actor.cpp).
        self.db = db
        self.fs = fs
        self.store_process = store_process or db.process
        self.bucket = TaskBucket(Subspace(raw_prefix=bucket_prefix))

    def container(self, path: str) -> BackupContainer:
        return open_container(path, self.fs, self.store_process)

    async def submit_backup(
        self, container: BackupContainer, begin: bytes = b"", end: bytes = b"\xff"
    ):
        """Queue the snapshot (ref: submitBackup writing the first task)."""

        async def txn(tr):
            tr.options["access_system_keys"] = True
            version = await tr.get_read_version()
            self.bucket.add(
                tr,
                {
                    b"type": b"backup_range",
                    b"path": container.path.encode(),
                    b"begin": begin,
                    b"end": end,
                    b"restart_begin": begin,
                    b"version": b"%d" % version,
                    b"page": b"0",
                },
            )

        await self.db.run(txn)

    def executor(self, db=None) -> TaskBucketExecutor:
        """A backup agent process (run several for parallelism/failover)."""
        return TaskBucketExecutor(
            db or self.db,
            self.bucket,
            {"backup_range": self._run_backup_range},
        )

    async def _run_backup_range(self, db, task) -> List[dict]:
        p = task.params
        container = self.container(p[b"path"].decode())
        begin, end = p[b"begin"], p[b"end"]
        version = int(p[b"version"])
        page = int(p[b"page"])

        async def read_page(tr):
            tr.options["access_system_keys"] = True
            tr.set_read_version(version)
            rows = await tr.get_range(
                begin, end, limit=PAGE_ROWS, snapshot=True
            )
            return rows

        try:
            rows = await db.run(read_page)
        except FdbError as e:
            if e.name != "transaction_too_old":
                raise
            # Snapshot fell out of the MVCC window: restart the whole
            # backup at a fresh version (see module docstring).
            async def fresh(tr):
                return await tr.get_read_version()

            new_version = await db.run(fresh)
            return [
                {
                    b"type": b"backup_range",
                    b"path": p[b"path"],
                    b"begin": p[b"restart_begin"],
                    b"end": end,
                    b"restart_begin": p[b"restart_begin"],
                    b"version": b"%d" % new_version,
                    b"page": b"0",
                }
            ]
        await container.write_page(page, begin, rows)
        if len(rows) >= PAGE_ROWS:
            return [
                {
                    b"type": b"backup_range",
                    b"path": p[b"path"],
                    b"begin": key_after(rows[-1][0]),
                    b"end": end,
                    b"restart_begin": p[b"restart_begin"],
                    b"version": p[b"version"],
                    b"page": b"%d" % (page + 1),
                }
            ]
        await container.write_manifest(
            version, page + 1, p[b"restart_begin"], end
        )
        return []

    async def restore(self, container: BackupContainer, batch_rows: int = 500):
        """Clear the target range and replay the container (ref:
        FileBackupAgent restore tasks, compacted to a client-side loop)."""
        manifest = await container.read_manifest()
        if manifest is None:
            raise FdbError("file_not_found")
        return await apply_snapshot_image(
            self.db, container, manifest, batch_rows
        )


async def apply_snapshot_image(
    db, container: BackupContainer, manifest: dict, batch_rows: int = 500,
    lock_aware: bool = False,
) -> int:
    """Clear the target range and replay the snapshot pages — the shared
    first half of both restore paths (ref: restore clearing restoreRange
    before applying the range files)."""

    def _opts(tr):
        if lock_aware:
            tr.options["lock_aware"] = True

    async def clear_txn(tr):
        _opts(tr)
        tr.clear_range(manifest.get("begin", b""), manifest.get("end", b"\xff"))

    await db.run(clear_txn)
    rows_restored = 0
    for i in range(manifest["pages"]):
        pg = await container.read_page(i)
        if pg is None:
            raise FdbError("file_corrupt")
        _begin, rows = pg
        for off in range(0, max(len(rows), 1), batch_rows):
            chunk = rows[off : off + batch_rows]

            async def txn(tr, chunk=chunk):
                _opts(tr)
                for k, v in chunk:
                    tr.set(k, v)

            if chunk:
                await db.run(txn)
                rows_restored += len(chunk)
    return rows_restored


class ContinuousBackupAgent:
    """Snapshot + continuous mutation log -> point-in-time restore.

    Ref: the FileBackupAgent's full shape (FileBackupAgent.actor.cpp):
    range dumps at a snapshot version PLUS log files carrying every later
    mutation (the reference taps `\xff/backupLog` written by the proxies;
    the rebuild registers a consumer tag and tails the tag-partitioned
    logs through a MergePeekCursor — same stream, pull instead of tap).
    Restore at version V: apply the snapshot image, then every logged
    mutation in (snapshot_version, V], in version order, one transaction
    per version batch (applyMutations' discipline)."""

    def __init__(self, db, fs, src_tlogs, container: BackupContainer,
                 tag: str = "_backup"):
        self.db = db
        self.fs = fs
        self.tlogs = list(src_tlogs)
        self.container = container
        self.tag = tag
        self.snapshot_version = 0
        self.logged_through = 0
        self._chunks = 0  # log chunk files written
        self._cursor = None
        self.stopped = False

    async def _pop_all(self, version: int):
        from ..server.interfaces import TLogPopRequest

        for tl in self.tlogs:
            await tl.pop.get_reply(
                self.db.process, TLogPopRequest(version=version, tag=self.tag)
            )

    async def start(self, begin: bytes = b"", end: bytes = b"\xff") -> int:
        """Register the log floor, then write the snapshot pages at one
        version; the mutation log tails from that version."""
        await self._pop_all(0)
        while True:
            tr = self.db.create_transaction()
            version = await tr.get_read_version()
            try:
                pages = 0
                lo = begin
                while True:
                    rows = await tr.get_range(
                        lo, end, limit=PAGE_ROWS, snapshot=True
                    )
                    await self.container.write_page(pages, lo, rows)
                    pages += 1
                    if len(rows) < PAGE_ROWS:
                        break
                    lo = key_after(rows[-1][0])
                break
            except FdbError as e:
                if e.name != "transaction_too_old":
                    raise
        self.snapshot_version = version
        self.logged_through = version
        await self._write_manifest(begin, end, pages)
        await self._pop_all(version)
        return version

    async def _write_manifest(self, begin: bytes, end: bytes, pages: int):
        self._pages = pages
        self._begin, self._end = begin, end
        prev = await self.container.read_manifest() or {}
        await self.container.write_manifest2(
            {
                "version": self.snapshot_version,
                "pages": pages,
                "begin": begin,
                "end": end,
                "log_chunks": self._chunks,
                "first_log_chunk": prev.get("first_log_chunk", 0),
                "logged_through": self.logged_through,
            }
        )

    async def resnapshot(self) -> int:
        """Fresh snapshot image at a new version (ref: fdbbackup's
        periodic snapshots — what makes `expire` safe: log chunks wholly
        below the NEWEST snapshot are redundant for every restorable
        target and only then may be deleted)."""
        while True:
            tr = self.db.create_transaction()
            version = await tr.get_read_version()
            try:
                pages = 0
                lo = self._begin
                while True:
                    rows = await tr.get_range(
                        lo, self._end, limit=PAGE_ROWS, snapshot=True
                    )
                    await self.container.write_page(pages, lo, rows)
                    pages += 1
                    if len(rows) < PAGE_ROWS:
                        break
                    lo = key_after(rows[-1][0])
                break
            except FdbError as e:
                if e.name != "transaction_too_old":
                    raise
        self.snapshot_version = version
        await self._write_manifest(self._begin, self._end, pages)
        return version

    async def expire(self) -> int:
        """Re-snapshot, then drop every log chunk made redundant by it
        (ref: fdbbackup expire).  Returns chunks deleted."""
        v = await self.resnapshot()
        # The tail must cover the new snapshot before old chunks go: a
        # chunk straddling v still carries needed versions and is kept by
        # expire_container's end_ver check anyway.
        return await expire_container(self.container, v)

    async def tail_once(self) -> int:
        """Pull the merged stream past logged_through into one durable log
        chunk; returns versions captured."""
        from ..rpc.peek_cursor import MergePeekCursor

        if self._cursor is not None and self._cursor.begin != self.logged_through:
            self._cursor = None
        if self._cursor is None:
            self._cursor = MergePeekCursor(
                self.db.process,
                self.tlogs,
                tags=None,  # the full stream: no tag discovery needed
                begin=self.logged_through,
                limit_versions=128,
            )
        entries, horizon = await self._cursor.next_batch()
        flat = [
            (v, self._cursor.flatten(bundle))
            for v, bundle in entries
            if v > self.logged_through
        ]
        if not flat and horizon <= self.logged_through:
            return 0
        if flat:
            await self.container.write_log_chunk(
                self._chunks, self.logged_through, horizon, flat
            )
            self._chunks += 1
        self.logged_through = max(self.logged_through, horizon)
        await self._write_manifest(self._begin, self._end, self._pages)
        await self._pop_all(self.logged_through)
        return len(flat)

    async def run(self, poll: float = 0.05):
        loop = self.db.process.network.loop
        while not self.stopped:
            n = await self.tail_once()
            if n == 0:
                await loop.delay(poll)

    async def atomic_restore(self, target_version: int = None,
                             batch_rows: int = 500) -> int:
        """Restore that is ATOMIC to every observer (ref: the
        BackupAgent atomicRestore the AtomicRestore workload drives):
        lock the database, run the multi-transaction restore lock-aware,
        unlock.  Non-lock-aware readers and writers fail database_locked
        for the duration, so no transaction can ever observe (or
        interleave with) a half-restored range; from the outside the
        restore happens at one point between the lock and the unlock."""
        from ..client.management import lock_database, unlock_database

        uid = await lock_database(self.db)
        try:
            v = await self.restore(
                target_version, batch_rows, lock_aware=True
            )
        finally:
            await unlock_database(self.db, uid)
        return v

    async def restore(self, target_version: int = None,
                      batch_rows: int = 500, lock_aware: bool = False) -> int:
        """Point-in-time restore: snapshot image + logged mutations
        through `target_version` (default: everything logged).  Returns
        the restore version actually applied."""
        from ..client.types import ATOMIC_TYPES, MutationType

        manifest = await self.container.read_manifest()
        if manifest is None:
            raise FdbError("file_not_found")
        snap_v = manifest["version"]
        logged = manifest.get("logged_through", snap_v)
        target = logged if target_version is None else target_version
        if not (snap_v <= target <= logged):
            raise FdbError("restore_invalid_version")
        begin, end = manifest.get("begin", b""), manifest.get("end", b"\xff")
        uend = min(end, b"\xff")  # user-keyspace bound
        await apply_snapshot_image(
            self.db, self.container, manifest, batch_rows,
            lock_aware=lock_aware,
        )

        def in_scope(m):
            if m.type == MutationType.CLEAR_RANGE:
                # A clear whose RANGE overlaps the backup bounds applies
                # (clamped both sides) even when its start key is below
                # `begin` — dropping it would resurrect deleted keys.
                return m.param1 < uend and m.param2 > begin
            return begin <= m.param1 < uend

        # Mutation-log replay in version order through the target
        # (chunks below first_log_chunk were expired — redundant for any
        # target the snapshot-version check above admits).
        for ci in range(manifest.get("first_log_chunk", 0),
                        manifest.get("log_chunks", 0)):
            chunk = await self.container.read_log_chunk(ci)
            if chunk is None:
                raise FdbError("file_corrupt")
            _bv, _ev, entries = chunk
            for version, mutations in entries:
                if version <= snap_v or version > target:
                    continue
                user = [m for m in mutations if in_scope(m)]
                if not user:
                    continue

                async def apply(tr, user=user):
                    if lock_aware:
                        tr.options["lock_aware"] = True
                    for m in user:
                        if m.type == MutationType.SET_VALUE:
                            tr.set(m.param1, m.param2)
                        elif m.type == MutationType.CLEAR_RANGE:
                            tr.clear_range(
                                max(m.param1, begin), min(m.param2, uend)
                            )
                        elif m.type in ATOMIC_TYPES:
                            tr.atomic_op(m.type, m.param1, m.param2)

                await self.db.run(apply)
        return target


async def describe_container(container: BackupContainer) -> dict:
    """Ref: fdbbackup `describe` — summarize restorability: the snapshot
    version, the continuous-log tail, and the restorable window."""
    manifest = await container.read_manifest()
    if manifest is None:
        return {"restorable": False}
    out = dict(manifest)
    out["restorable"] = True
    out["restorable_from"] = manifest["version"]
    out["restorable_to"] = manifest.get("logged_through", manifest["version"])
    # First retained chunk bounds the point-in-time floor after expiry.
    first = manifest.get("first_log_chunk", 0)
    chunks = manifest.get("log_chunks", 0)
    if chunks > first:
        head = await container.read_log_chunk(first)
        if head is not None:
            out["oldest_logged_version"] = head[0]
    return out


async def expire_container(container: BackupContainer,
                           before_version: int) -> int:
    """Ref: fdbbackup `expire --expire-before-version` — delete log chunks
    ENTIRELY below `before_version` (the snapshot image stays: it is the
    restore base).  Restore targets at or above the first retained
    chunk's begin remain valid; returns the number of chunks deleted."""
    manifest = await container.read_manifest()
    if manifest is None:
        return 0
    first = manifest.get("first_log_chunk", 0)
    chunks = manifest.get("log_chunks", 0)
    deleted = 0
    i = first
    while i < chunks:
        chunk = await container.read_log_chunk(i)
        if chunk is None:
            break
        _b, end_ver, _entries = chunk
        if end_ver > before_version:
            break  # this chunk still carries live versions
        await container.delete_log_chunk(i)
        deleted += 1
        i += 1
    if deleted:
        manifest["first_log_chunk"] = i
        await container.write_manifest2(manifest)
    return deleted
