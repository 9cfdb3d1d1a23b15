"""Client-side layers: tuple encoding, subspaces, and the directory layer.

The port's own copy of the reference package's ``layers/__init__.py``:
the same exports; the queue, pubsub and DR modules are imported by name.

Ref: the reference ships these in every language binding
(bindings/python/fdb/tuple.py, subspace_impl.py, directory_impl.py); they
are the idiomatic way applications structure keys on the bare KV API.
"""

from . import tuple  # noqa: A004 - mirrors fdb.tuple's name
from .directory import DirectoryLayer, DirectorySubspace, HighContentionAllocator
from .backup import BackupContainer, FileBackupAgent
from .subspace import Subspace
from .taskbucket import TaskBucket, TaskBucketExecutor
from .tuple import Versionstamp, pack, range_of, unpack

__all__ = [
    "tuple",
    "pack",
    "unpack",
    "range_of",
    "Versionstamp",
    "Subspace",
    "TaskBucket",
    "TaskBucketExecutor",
    "BackupContainer",
    "FileBackupAgent",
    "DirectoryLayer",
    "DirectorySubspace",
    "HighContentionAllocator",
]
