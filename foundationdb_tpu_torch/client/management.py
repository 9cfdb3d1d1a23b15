"""ManagementAPI: cluster configuration as transactions on `\xff/conf`.

The port's own copy of the reference package's ``client/management.py``.

Ref: fdbclient/ManagementAPI.actor.cpp — `configure`, exclude/include are
ordinary transactions on system keys (configKeysPrefix `\xff/conf/`,
excludedServersPrefix); every role learns changes through the mutation
stream, and the cluster controller reacts by recruiting a new generation
when the topology no longer matches (changeConfig -> waitForFullReplication
-> recovery).

Supported here: proxy count (stateless; applied at the next generation),
plus storage exclusion records consumed by DD healing.  Stateful counts
(tlogs/storages) are recorded but not auto-applied — their disks pin them
to machines, and resizing the log set changes tag placement for old
epochs (see tlog.begin_version); that arrives with log-epoch routing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

CONF_PREFIX = b"\xff/conf/"
CONF_END = b"\xff/conf0"
EXCLUDED_PREFIX = b"\xff/conf/excluded/"
EXCLUDED_END = b"\xff/conf/excluded0"

_INT_KEYS = (
    "proxies",
    "resolvers",
    "logs",
    "storage_team_size",
    # Multi-region (ref: the region configuration in DatabaseConfiguration
    # — usable_regions=2 keeps a second region's replica set; satellites
    # are the synchronous full-stream logs in the primary region that make
    # remote failover lossless).  Recorded in `\xff/conf` like the
    # reference; SimCluster(n_satellite_tlogs=..) builds the satellites
    # (the remote region's log router is not ported yet).
    "usable_regions",
    "satellite_logs",
)


def conf_key(name: str) -> bytes:
    return CONF_PREFIX + name.encode()


async def configure(db, **params) -> None:
    """Transactionally set configuration fields, e.g.
    configure(db, proxies=2) (ref: changeConfig ManagementAPI:253)."""

    async def txn(tr):
        tr.options["access_system_keys"] = True
        for name, value in params.items():
            if name not in _INT_KEYS:
                raise ValueError(f"unknown configuration key {name!r}")
            tr.set(conf_key(name), b"%d" % int(value))

    await db.run(txn)


async def get_configuration(db) -> Dict[str, int]:
    out = {}

    async def txn(tr):
        tr.options["access_system_keys"] = True
        rows = await tr.get_range(CONF_PREFIX, CONF_END)
        for k, v in rows:
            name = k[len(CONF_PREFIX):].decode()
            if (
                name.startswith("excluded/")
                or name.startswith("class/")
                or name in ("resolverSplit", "coordinators")
            ):
                continue
            out[name] = int(v.decode())

    await db.run(txn)
    return out


CLASS_PREFIX = b"\xff/conf/class/"
CLASS_END = b"\xff/conf/class0"

VALID_CLASSES = ("unset", "stateless", "transaction", "storage",
                 "coordinator")


async def change_coordinators(db, new_addresses: List[str]) -> None:
    """Request a coordinator quorum change (ref: changeQuorum
    ManagementAPI.actor.cpp:684).  Client-side safety checks here; the
    acting cluster controller performs the movable-state handoff (write
    manifest to the new quorum, fence + forward the old) and the change is
    complete when every election client has retargeted.
    """
    if not new_addresses:
        raise ValueError("empty coordinator set")
    if len(set(new_addresses)) != len(new_addresses):
        raise ValueError("duplicate coordinator address")
    if len(new_addresses) % 2 == 0:
        # An even quorum tolerates no more failures than the next odd size
        # down and doubles the tie surface (the reference warns similarly).
        raise ValueError("coordinator count must be odd")

    async def txn(tr):
        tr.options["access_system_keys"] = True
        tr.set(conf_key("coordinators"), ",".join(new_addresses).encode())

    await db.run(txn)


async def get_requested_coordinators(db) -> Optional[List[str]]:
    out: List[Optional[bytes]] = [None]

    async def txn(tr):
        tr.options["access_system_keys"] = True
        out[0] = await tr.get(conf_key("coordinators"))

    await db.run(txn)
    return out[0].decode().split(",") if out[0] else None


async def set_process_class(db, address: str, process_class: str) -> None:
    """Assign a recruitment class to the worker at `address` (ref: setclass
    fdbcli / processClass in SystemData) — applied at the next generation's
    recruitment."""
    if process_class not in VALID_CLASSES:
        raise ValueError(f"unknown process class {process_class!r}")

    async def txn(tr):
        tr.options["access_system_keys"] = True
        if process_class == "unset":
            tr.clear(CLASS_PREFIX + address.encode())
        else:
            tr.set(CLASS_PREFIX + address.encode(), process_class.encode())

    await db.run(txn)


async def get_process_classes(db) -> Dict[str, str]:
    out: Dict[str, str] = {}

    async def txn(tr):
        tr.options["access_system_keys"] = True
        rows = await tr.get_range(CLASS_PREFIX, CLASS_END)
        out.clear()
        for k, v in rows:
            out[k[len(CLASS_PREFIX):].decode()] = v.decode()

    await db.run(txn)
    return out


async def lock_database(db, uid: Optional[bytes] = None) -> bytes:
    """Lock the database (ref: lockDatabase ManagementAPI.actor.cpp:400):
    writes a UID into `\xff/dbLocked`; every non-lock-aware GRV/commit
    fails database_locked until unlock.  Locking an already-locked
    database with a DIFFERENT uid raises database_locked; same uid is
    idempotent."""
    if uid is None:
        uid = b"%016x" % db.process.network.loop.rng.random_int(1, 1 << 62)
    await _write_lock_record(db, uid, uid)
    return uid


async def _write_lock_record(db, holder_uid: bytes, value: bytes) -> None:
    """Shared lock/unlock writer.  Explicit retry loop: db.run would retry
    database_locked (it is in the client retry set, as in the reference's
    onError), but a CONFLICTING holder must surface — the reference's
    lockDatabase rethrows it before onError (ManagementAPI.actor.cpp:1279).
    Idempotent under commit_unknown_result: rewriting the same value is
    harmless."""
    from ..flow.error import FdbError
    from ..server.system_keys import DB_LOCKED_KEY

    tr = db.create_transaction()
    while True:
        try:
            tr.options["access_system_keys"] = True
            tr.options["lock_aware"] = True
            cur = await tr.get(DB_LOCKED_KEY)
            if cur and cur != holder_uid:
                raise FdbError("database_locked")  # someone else's lock
            tr.set(DB_LOCKED_KEY, value)
            await tr.commit()
            return
        except FdbError as e:
            if e.name == "database_locked":
                raise
            await tr.on_error(e)


async def unlock_database(db, uid: bytes) -> None:
    """Ref: unlockDatabase — only the holder of the lock UID may unlock.
    Writes the empty value (= unlocked; see DB_LOCKED_KEY)."""
    await _write_lock_record(db, uid, b"")


async def exclude_servers(db, storage_ids: List[str]) -> None:
    """Mark storages for removal (ref: excludeServers ManagementAPI:556);
    DD healing treats excluded servers like failed ones — moves their data
    to teammates and unregisters their log tags."""

    async def txn(tr):
        tr.options["access_system_keys"] = True
        for sid in storage_ids:
            tr.set(EXCLUDED_PREFIX + sid.encode(), b"1")

    await db.run(txn)


async def include_servers(db, storage_ids: Optional[List[str]] = None) -> None:
    """Clear exclusion records (ref: includeServers ManagementAPI:606);
    None = include everything."""

    async def txn(tr):
        tr.options["access_system_keys"] = True
        if storage_ids is None:
            tr.clear_range(EXCLUDED_PREFIX, EXCLUDED_END)
        else:
            for sid in storage_ids:
                tr.clear(EXCLUDED_PREFIX + sid.encode())

    await db.run(txn)


async def get_excluded_servers(db) -> List[str]:
    out: List[str] = []

    async def txn(tr):
        tr.options["access_system_keys"] = True
        rows = await tr.get_range(EXCLUDED_PREFIX, EXCLUDED_END)
        out[:] = [k[len(EXCLUDED_PREFIX):].decode() for k, _v in rows]

    await db.run(txn)
    return out


async def version_from_timestamp(db, timestamp: float) -> int:
    """Map a wall-clock time to the LAST commit version known to be at or
    before it, from the CC's TimeKeeper samples (ref: fdbbackup's
    timeKeeperVersionFromDatetime, backup.actor.cpp:1828 — used for
    `restore --timestamp`).  Raises restore_error when no sample covers
    the time (cluster younger than the timestamp, or TimeKeeper
    disabled)."""
    from ..flow.error import FdbError
    from ..server.system_keys import (
        TIME_KEEPER_PREFIX,
        time_keeper_key,
    )

    async def txn(tr):
        tr.options["access_system_keys"] = True
        tr.options["lock_aware"] = True
        rows = await tr.get_range(
            TIME_KEEPER_PREFIX,
            time_keeper_key(max(0, int(timestamp) + 1)),
            limit=1,
            reverse=True,
        )
        return int(rows[0][1]) if rows else None

    v = await db.run(txn)
    if v is None:
        raise FdbError("restore_error")
    return v
