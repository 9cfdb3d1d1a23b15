"""Tag -> tlog placement: which logs hold a tag's mutations.

The port's own copy of the reference package's ``server/log_system.py``;
the reference's ``log_replication_factor`` knob is
``LOG_REPLICATION_FACTOR``, at its default.
Ref: TagPartitionedLogSystem.actor.cpp:63 — each tag is pushed to a
policy-selected subset of tlogs of size tLogReplicationFactor; peek-merge
cursors read a tag back from any of them.  The rebuild's policy is a stable
hash ring (locality-aware policies arrive with multi-DC): tag t lives on
rf consecutive logs starting at crc32(t) mod n.  Broadcast tags (metadata
`_all`, unsharded `_default`) live on every log so any consumer can peek
its full tag set from one log.
"""

from __future__ import annotations

import zlib
from typing import List

from .interfaces import TAG_ALL, TAG_DEFAULT

# Ref: DatabaseConfiguration's tLogReplicationFactor ("double" redundancy),
# clamped to the available log count.
LOG_REPLICATION_FACTOR = 2


def tlogs_for_tag(tag: str, n_tlogs: int) -> List[int]:
    if tag in (TAG_ALL, TAG_DEFAULT):
        return list(range(n_tlogs))
    rf = min(LOG_REPLICATION_FACTOR, n_tlogs)
    h = zlib.crc32(tag.encode()) % n_tlogs
    return [(h + r) % n_tlogs for r in range(rf)]
