"""Sideband: external consistency through a side channel.

The port's own copy of the reference package's ``workloads/sideband.py``.

Ref: fdbserver/workloads/Sideband.actor.cpp — a mutator commits a key and
THEN sends the commit version to a checker through a side channel (a
PromiseStream there; a plain deque here, which is still "outside the
database").  The checker starts a transaction AFTER receiving the
message; serializability + external consistency require its read version
to reach the communicated commit version and the key to be present — a
missing key means a causality violation (a GRV served below an already-
acknowledged commit).
"""

from __future__ import annotations

from collections import deque

from .base import TestWorkload


class SidebandWorkload(TestWorkload):
    name = "sideband"

    def __init__(self, messages: int = 20, prefix: bytes = b"sideband/"):
        self.messages = messages
        self.prefix = prefix
        self.checked = 0
        self.violations = 0

    async def start(self, db, cluster):
        from ..flow.eventloop import all_of

        chan: deque = deque()  # the side channel (mutator -> checker)
        done = {"sending": True}

        async def commit_marker(key: bytes) -> int:
            from ..flow.error import FdbError

            while True:
                tr = db.create_transaction()
                tr.set(key, b"present")
                try:
                    return await tr.commit()
                except FdbError as e:
                    await tr.on_error(e)

        async def mutator():
            for i in range(self.messages):
                key = self.prefix + b"%06d" % i
                version = await commit_marker(key)
                chan.append((i, version))
            done["sending"] = False

        async def checker():
            loop = cluster.loop
            remaining = self.messages
            while remaining > 0:
                if not chan:
                    await loop.delay(0.005)
                    continue
                i, commit_version = chan.popleft()
                key = self.prefix + b"%06d" % i
                # The transaction STARTS after the side message arrived:
                # its read version must cover the acked commit.
                tr = db.create_transaction()
                rv = await tr.get_read_version()
                val = await tr.get(key)
                if rv < commit_version or val != b"present":
                    self.violations += 1
                self.checked += 1
                remaining -= 1

        await all_of(
            [
                db.process.spawn(mutator(), "sideband_mut"),
                db.process.spawn(checker(), "sideband_chk"),
            ]
        )

    async def check(self, db, cluster) -> bool:
        return self.violations == 0 and self.checked == self.messages
