"""The port's virtualized file I/O: the simulated half of the reference
package's ``fileio`` (modelled on fdbrpc/IAsyncFile.h's read/write/sync/
truncate contract and AsyncFileNonDurable.actor.h's crash model: writes
are durable only after sync(); a simulated kill drops, tears or corrupts
each unsynced write).  Files live in a SimFileSystem keyed by machine, so
a rebooted process on the same machine recovers whatever survived on its
"disk".  Over them: the DiskQueue, the memory engine and the COW B-tree.
"""

from .btree import BTreeKeyValueStore
from .diskqueue import DiskQueue
from .kvstore import KeyValueStoreMemory, open_engine
from .simfile import KillMode, SimAsyncFile, SimFileSystem

__all__ = [
    "BTreeKeyValueStore",
    "DiskQueue",
    "KeyValueStoreMemory",
    "KillMode",
    "SimAsyncFile",
    "SimFileSystem",
    "open_engine",
]
