"""SelectorCorrectness: exhaustive KeySelector resolution sweep.

The port's own copy of the reference package's
``workloads/selector_correctness.py``.

Ref: fdbserver/workloads/SelectorCorrectness.actor.cpp — for a known
keyspace, EVERY selector shape (anchor on/off keys, or_equal both ways,
offsets sweeping negative through positive past both ends) must resolve
exactly as the in-memory model says.  Random workloads sample this space;
this one enumerates it.
"""

from __future__ import annotations

from ..client.types import KeySelector
from .base import TestWorkload
from .write_during_read import clamp_to_prefix, model_get_key


class SelectorCorrectnessWorkload(TestWorkload):
    name = "selector_correctness"

    def __init__(self, nodes: int = 8, max_offset: int = 4,
                 prefix: bytes = b"sel/"):
        self.nodes = nodes
        self.max_offset = max_offset
        self.prefix = prefix
        self.checked = 0
        self.failures = []

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    async def setup(self, db, cluster):
        async def init(tr):
            tr.clear_range(self.prefix, self.prefix + b"\xff")
            for i in range(0, self.nodes, 2):  # every OTHER key present
                tr.set(self._key(i), b"v")

        await db.run(init)
        self.model = {
            self._key(i): b"v" for i in range(0, self.nodes, 2)
        }

    async def start(self, db, cluster):
        # Anchors: every present key, every ABSENT key, and both edges.
        anchors = [self._key(i) for i in range(self.nodes)]
        anchors += [self.prefix, self.prefix + b"\xff", self._key(0) + b"\x00"]
        tr = db.create_transaction()
        for anchor in anchors:
            for or_equal in (False, True):
                for off in range(-self.max_offset, self.max_offset + 1):
                    sel = KeySelector(key=anchor, or_equal=or_equal, offset=off)
                    got = await tr.get_key(sel)
                    want = model_get_key(self.model, sel)
                    got_c = clamp_to_prefix(got, self.prefix)
                    want_c = clamp_to_prefix(want, self.prefix)
                    self.checked += 1
                    if got_c != want_c:
                        self.failures.append(
                            f"({anchor!r},{or_equal},{off}): "
                            f"db={got!r} model={want!r}"
                        )

    async def check(self, db, cluster) -> bool:
        if self.failures:
            import sys

            for f in self.failures[:10]:
                print(f"[selector_correctness] {f}", file=sys.stderr)
        return not self.failures and self.checked > 0
