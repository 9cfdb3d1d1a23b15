"""Unreadable: reads over pending versionstamped keys must error, never lie.

The port's own copy of the reference package's ``workloads/unreadable.py``.

Ref: fdbserver/workloads/Unreadable.actor.cpp — after a
SET_VERSIONSTAMPED_KEY mutation, any read intersecting the stamp's
placeholder range inside the SAME transaction must raise
accessed_unreadable (the key's final bytes are unknowable before commit);
reads that do not intersect must still succeed.
"""

from __future__ import annotations

from ..client.types import MutationType
from ..flow.error import FdbError
from .base import TestWorkload

PLACEHOLDER = b"\x00" * 10


class UnreadableWorkload(TestWorkload):
    name = "unreadable"

    def __init__(self, rounds: int = 6, prefix: bytes = b"unr/"):
        self.rounds = rounds
        self.prefix = prefix
        self.violations = 0
        self.checked = 0

    async def start(self, db, cluster):
        for r in range(self.rounds):
            await self._round(db, r)

    async def _round(self, db, r: int):
        """One probe round, RETRIED whole on infrastructure errors
        (clogging/recovery/lock windows are not unreadability violations;
        only a read that returns data — or a wrong error — inside a stamp
        range counts)."""
        kp = self.prefix + b"%02d/" % r
        key_param = kp + PLACEHOLDER + len(kp).to_bytes(4, "little")
        tr = db.create_transaction()
        while True:
            probes: list = []
            try:
                if await tr.get(kp + b"!done") is not None:
                    # Unknown-result retry whose first attempt landed: its
                    # probes ran (they precede the commit) but their
                    # outcomes were discarded with the exception; credit
                    # the round so the checked-count gate stays exact.
                    self.checked += 3
                    return
                tr.atomic_op(
                    MutationType.SET_VERSIONSTAMPED_KEY, key_param, b"v"
                )
                # Intersecting reads: point get inside the stamp range and
                # a range scan across it must both raise.
                async def probe_one(op):
                    try:
                        if op == "get":
                            # Inside [kp+\x00*10, kp+\xff*10] — a shorter
                            # key would sort BELOW the range and legally
                            # read.
                            await tr.get(kp + b"\x42" * 10)
                        else:
                            await tr.get_range(kp, kp + b"\xff")
                        return "read_succeeded"  # the violation
                    except FdbError as e:
                        if e.name == "accessed_unreadable":
                            return "ok"
                        raise  # infrastructure error: retry the round

                for op in ("get", "range"):
                    probes.append((op, await probe_one(op)))
                # A disjoint read in the same transaction still works.
                await tr.get(self.prefix + b"elsewhere")
                probes.append(("disjoint", "ok"))
                tr.set(kp + b"!done", b"1")
                await tr.commit()
            except FdbError as e:
                await tr.on_error(e)  # raises if non-retryable
                continue
            for _op, outcome in probes:
                self.checked += 1
                if outcome != "ok":
                    self.violations += 1
            return

    async def check(self, db, cluster) -> bool:
        if self.violations or self.checked != 3 * self.rounds:
            return False

        # Every round's stamped key landed and is readable AFTER commit.
        out = {}

        async def read(tr):
            out["rows"] = await tr.get_range(self.prefix, self.prefix + b"\xff")

        await db.run(read)
        stamped = [
            k for k, _v in out["rows"] if not k.endswith(b"!done")
        ]
        done = [k for k, _v in out["rows"] if k.endswith(b"!done")]
        return len(stamped) >= self.rounds and len(done) == self.rounds
