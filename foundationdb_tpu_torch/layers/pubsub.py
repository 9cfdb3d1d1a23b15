"""PubSub layer: feeds, inboxes, subscriptions — messages as KV rows.

The port's own copy of the reference package's ``layers/pubsub.py``.

Ref: layers/pubsub/pubsub.py (the reference's sample python layer) and
fdbserver/pubsub.actor.cpp (its vestigial in-server twin).  Re-derived
pull-model design: a post writes ONE row into the feed's subspace at a
versionstamped sequence (no fan-out write amplification); an inbox read
merges, per subscribed feed, everything past the inbox's per-feed
watermark, then advances the watermarks — the reference's "dirty feed"
copy, folded into the read transaction.

Layout (under one Subspace):
  ('f', feed, <stamp>) = message          -- the feed's append log
  ('s', inbox, feed) = b''                -- subscription edge
  ('w', inbox, feed) = last-seen key      -- inbox watermark per feed
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..client.types import MutationType, key_after
from .subspace import Subspace


class PubSub:
    def __init__(self, db, subspace: Optional[Subspace] = None):
        self.db = db
        self.sub = subspace or Subspace(("pubsub",))

    # -- management --
    async def create_feed(self, name: str) -> None:
        async def txn(tr):
            tr.set(self.sub.pack(("meta", "feed", name)), b"")

        await self.db.run(txn)

    async def create_inbox(self, name: str) -> None:
        async def txn(tr):
            tr.set(self.sub.pack(("meta", "inbox", name)), b"")

        await self.db.run(txn)

    async def subscribe(self, inbox: str, feed: str) -> None:
        async def txn(tr):
            if await tr.get(self.sub.pack(("meta", "feed", feed))) is None:
                raise ValueError(f"no such feed {feed!r}")
            tr.set(self.sub.pack(("s", inbox, feed)), b"")

        await self.db.run(txn)

    # -- posting --
    async def post(self, feed: str, contents: bytes) -> None:
        async def txn(tr):
            prefix = self.sub.pack(("f", feed))
            key = prefix + b"\x00" * 10 + len(prefix).to_bytes(4, "little")
            tr.atomic_op(MutationType.SET_VERSIONSTAMPED_KEY, key, contents)

        await self.db.run(txn)

    # -- reading --
    async def get_feed_messages(
        self, feed: str, limit: int = 64
    ) -> List[bytes]:
        async def txn(tr):
            b, e = self.sub.range(("f", feed))
            return [v for _k, v in await tr.get_range(b, e, limit=limit)]

        return await self.db.run(txn)

    async def get_inbox_messages(
        self, inbox: str, limit: int = 64
    ) -> List[Tuple[str, bytes]]:
        """Unseen messages across every subscribed feed, in per-feed
        order, advancing the inbox watermarks (at-most-once per inbox)."""

        async def txn(tr):
            sb, se = self.sub.range(("s", inbox))
            feeds = [
                self.sub.unpack(k)[2] for k, _v in await tr.get_range(sb, se)
            ]
            out: List[Tuple[str, bytes]] = []
            for feed in feeds:
                wkey = self.sub.pack(("w", inbox, feed))
                water = await tr.get(wkey)
                fb, fe = self.sub.range(("f", feed))
                lo = key_after(water) if water else fb
                rows = await tr.get_range(lo, fe, limit=limit - len(out))
                for k, v in rows:
                    out.append((feed, v))
                if rows:
                    tr.set(wkey, rows[-1][0])
                if len(out) >= limit:
                    break
            return out

        return await self.db.run(txn)

    async def list_feeds(self) -> List[str]:
        async def txn(tr):
            b, e = self.sub.range(("meta", "feed"))
            return [self.sub.unpack(k)[2] for k, _v in await tr.get_range(b, e)]

        return await self.db.run(txn)
