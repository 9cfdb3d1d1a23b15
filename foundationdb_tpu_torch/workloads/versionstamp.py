"""VersionStamp: stamped keys/values must carry the real commit version.

The port's own copy of the reference package's ``workloads/versionstamp.py``.

Ref: fdbserver/workloads/VersionStamp.actor.cpp — transactions write a
SET_VERSIONSTAMPED_KEY row (stamp embedded in the key) and a
SET_VERSIONSTAMPED_VALUE row (stamp as the value) and the check verifies
the landed stamps agree with the versions the commits actually got —
including commits whose result was unknown, which are resolved by reading
the stamp back (the reference re-reads on commit_unknown_result too).
"""

from __future__ import annotations

from ..client.types import MutationType
from .base import TestWorkload

PLACEHOLDER = b"\x00" * 10


class VersionStampWorkload(TestWorkload):
    name = "versionstamp"

    def __init__(self, actors: int = 3, ops: int = 6, prefix: bytes = b"vs/"):
        self.actors = actors
        self.ops = ops
        self.prefix = prefix
        # id -> commit version when the commit reported one (None for
        # commit_unknown_result resolved later by read-back).
        self.known: dict = {}

    def _vkey(self, ident: bytes) -> bytes:
        return self.prefix + b"v/" + ident

    async def start(self, db, cluster):
        from ..flow.eventloop import all_of

        async def actor(aid: int):
            for seq in range(self.ops):
                ident = b"%02d_%04d" % (aid, seq)

                async def op(tr, ident=ident):
                    # Idempotence: the stamped-value row marks the op done.
                    if await tr.get(self._vkey(ident)) is not None:
                        from ..flow.testprobe import test_probe

                        test_probe("versionstamp_retry_found_landed")
                        return False
                    # Key: vs/k/<10-byte stamp><ident>; placeholder offset
                    # is right after the "vs/k/" prefix.
                    kp = self.prefix + b"k/"
                    key_param = (
                        kp + PLACEHOLDER + ident + len(kp).to_bytes(4, "little")
                    )
                    tr.atomic_op(
                        MutationType.SET_VERSIONSTAMPED_KEY, key_param, ident
                    )
                    val_param = PLACEHOLDER + (0).to_bytes(4, "little")
                    tr.atomic_op(
                        MutationType.SET_VERSIONSTAMPED_VALUE,
                        self._vkey(ident),
                        val_param,
                    )
                    return True

                tr = db.create_transaction()
                while True:
                    try:
                        wrote = await op(tr)
                        version = await tr.commit()
                        if wrote and version is not None:
                            self.known[ident] = version
                        break
                    except Exception as e:  # FdbError incl. unknown result
                        from ..flow.error import FdbError

                        if not isinstance(e, FdbError):
                            raise
                        await tr.on_error(e)

        await all_of(
            [db.process.spawn(actor(a), f"vs{a}") for a in range(self.actors)]
        )

    async def check(self, db, cluster) -> bool:
        out = {}

        async def read(tr):
            out["vals"] = await tr.get_range(
                self.prefix + b"v/", self.prefix + b"v0"
            )
            out["keys"] = await tr.get_range(
                self.prefix + b"k/", self.prefix + b"k0"
            )

        await db.run(read)
        vals = {k[len(self.prefix) + 2:]: v for k, v in out["vals"]}
        total = self.actors * self.ops
        if len(vals) != total:
            return False
        # Each stamped value is a 10-byte stamp whose version half must
        # match the version the commit reported (when it reported one).
        for ident, stamp in vals.items():
            if len(stamp) != 10:
                return False
            v = int.from_bytes(stamp[:8], "big")
            if ident in self.known and v != self.known[ident]:
                return False
        # Exactly one stamped key per ident, embedding the same stamp the
        # value row got (same txn => same version + txn number).
        seen = {}
        for k, _v in out["keys"]:
            body = k[len(self.prefix) + 2:]
            stamp, ident = body[:10], body[10:]
            if ident in seen:
                return False  # an op landed twice
            seen[ident] = stamp
        if set(seen) != set(vals):
            return False
        if any(seen[i] != vals[i] for i in seen):
            return False
        # Key order == stamp order: the range scan already returns keys
        # ascending; stamps are the key prefix so they must be sorted.
        stamps = [k for k, _ in out["keys"]]
        return stamps == sorted(stamps)
