"""System keyspace (`\xff`) encodings: the shard map lives IN the database.

The port's own copy of the reference package's ``server/system_keys.py``;
its values are encoded with the port's wire codec, byte for byte the
reference's.
Ref: fdbclient/SystemData.{h,cpp} — `keyServersKey(k) = \xff/keyServers/ + k`
whose value names the storage teams for the shard beginning at k, and
fdbserver/ApplyMetadataMutation.h — roles learn metadata changes by watching
these keys in the mutation stream itself, so a shard handoff is serialized
with user commits at an exact version.

Rebuild deviation from the reference encoding: each keyServers entry also
carries the shard's END key.  The reference derives extents from entry
adjacency (it reads the authoritative keyspace back); here every storage
applies metadata purely from the mutation stream, so the record must be
self-contained.  A move in flight is (src, dest, end) with dest non-empty;
a settled shard is (team, [], end).

`\xff/serverList/<id>` maps a storage id to its wire-encoded interface (ref:
serverListKeyFor SystemData.cpp), letting every role resolve ids to
endpoints passively from the stream.
"""

from __future__ import annotations

from typing import List, Tuple

from ..rpc.wire import decode_frame, encode_frame

SYSTEM_PREFIX = b"\xff"
KEY_SERVERS_PREFIX = b"\xff/keyServers/"
KEY_SERVERS_END = b"\xff/keyServers0"  # '0' == '/' + 1
SERVER_LIST_PREFIX = b"\xff/serverList/"
SERVER_LIST_END = b"\xff/serverList0"
# The resolver key-space partition (ref: the keyResolvers map the proxies
# maintain, MasterProxyServer.actor.cpp:185; split points move at an exact
# commit version via ResolutionSplitRequest, ResolverInterface.h:108-131).
RESOLVER_SPLIT_KEY = b"\xff/conf/resolverSplit"

# Database lock record (ref: databaseLockedKey fdbclient/SystemData.cpp —
# lockDatabase writes a UID here; proxies reject non-lock-aware work while
# it is non-empty).  Unlock SETS it empty rather than clearing, keeping
# parse_metadata_mutation's no-CLEAR-interpretation policy.
DB_LOCKED_KEY = b"\xff/dbLocked"

# TimeKeeper samples: wall-clock second -> commit version, written by the
# CC on a fixed cadence (ref: timeKeeperPrefixRange SystemData.cpp:411,
# the timeKeeper actor ClusterController.actor.cpp:1625).  Maps restore
# timestamps to versions (fdbbackup's timeKeeperVersionFromDatetime).
TIME_KEEPER_PREFIX = b"\xff\x02/timeKeeper/map/"
TIME_KEEPER_END = b"\xff\x02/timeKeeper/map0"
TIME_KEEPER_DISABLE_KEY = b"\xff\x02/timeKeeper/disable"


def time_keeper_key(t: int) -> bytes:
    return TIME_KEEPER_PREFIX + int(t).to_bytes(8, "big")


def time_keeper_time(sys_key: bytes) -> int:
    assert sys_key.startswith(TIME_KEEPER_PREFIX), sys_key
    return int.from_bytes(sys_key[len(TIME_KEEPER_PREFIX):], "big")


def key_servers_key(key: bytes) -> bytes:
    return KEY_SERVERS_PREFIX + key


def key_servers_begin(sys_key: bytes) -> bytes:
    assert sys_key.startswith(KEY_SERVERS_PREFIX), sys_key
    return sys_key[len(KEY_SERVERS_PREFIX):]


def encode_key_servers(
    src: List[str], dest: List[str], end: bytes
) -> bytes:
    """Shard record for [begin, end): settled on `src` when `dest` is empty,
    else a move src -> dest in flight (ref: keyServersValue's src/dest
    encoding, SystemData.cpp)."""
    return encode_frame((list(src), list(dest), end))


def decode_key_servers(value: bytes) -> Tuple[List[str], List[str], bytes]:
    src, dest, end = decode_frame(value)
    return list(src), list(dest), end


def server_list_key(storage_id: str) -> bytes:
    return SERVER_LIST_PREFIX + storage_id.encode()


def server_list_id(sys_key: bytes) -> str:
    assert sys_key.startswith(SERVER_LIST_PREFIX), sys_key
    return sys_key[len(SERVER_LIST_PREFIX):].decode()


def encode_server_entry(interface) -> bytes:
    """Wire-codec StorageInterface (refs are plain dataclasses of
    endpoint tokens, registered structs in rpc/wire.py)."""
    return encode_frame(interface)


def decode_server_entry(value: bytes):
    return decode_frame(value)


def bounds_from_split_keys(split_keys: List[bytes]) -> List[tuple]:
    """[(lo, hi_or_None)] per resolver from n-1 split points.  The proxies'
    clipping and the balancer's reconstruction of the partition MUST agree
    byte-for-byte, so this is the single definition."""
    split = list(split_keys)
    return list(zip([b""] + split, split + [None]))


def encode_resolver_split(split_keys: List[bytes]) -> bytes:
    return encode_frame(list(split_keys))


def decode_resolver_split(value: bytes) -> List[bytes]:
    return list(decode_frame(value))


def parse_metadata_mutation(m):
    """Shared ApplyMetadataMutation decoder for every role that watches the
    stream (proxy + storages must agree on the shard map byte-for-byte).

    Returns None (not metadata), ("server", id, StorageInterface),
    ("shard", begin, src, dest, end), or ("resolver_split", [split_keys]).
    CLEAR_RANGE over metadata keys is deliberately not interpreted: DD only
    ever overwrites records (clearing one would silently orphan a range —
    if shard-map compaction ever clears boundary entries, both intercept
    sites change here together)."""
    from ..client.types import MutationType

    if m.type != MutationType.SET_VALUE:
        return None
    if m.param1.startswith(SERVER_LIST_PREFIX):
        return ("server", server_list_id(m.param1), decode_server_entry(m.param2))
    if m.param1.startswith(KEY_SERVERS_PREFIX):
        src, dest, end = decode_key_servers(m.param2)
        return ("shard", key_servers_begin(m.param1), src, dest, end)
    if m.param1 == RESOLVER_SPLIT_KEY:
        return ("resolver_split", decode_resolver_split(m.param2))
    if m.param1 == DB_LOCKED_KEY:
        return ("lock", m.param2)  # empty value = unlocked
    return None
