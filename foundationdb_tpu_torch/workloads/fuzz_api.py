"""FuzzApiCorrectness: random API call sequences vs a predictive model.

The port's own copy of the reference package's ``workloads/fuzz_api.py``.

Ref: fdbserver/workloads/FuzzApiCorrectness.actor.cpp — every client API
entry point is invoked with randomized (frequently illegal) parameters; each
call carries a CONTRACT: either a predicted result (checked byte-exact
against an in-memory model) or a predicted error (checked by name).  The
reference enumerates op classes as TestGet/TestSet/TestClearRange/... with
per-op error tables (e.g. key_outside_legal_range for \\xff.. keys without
ACCESS_SYSTEM_KEYS, key_too_large / value_too_large over the size knobs,
inverted_range for begin > end, client_invalid_operation for malformed
versionstamp params, accessed_unreadable for reading a versionstamped key).

Ops run serially (the concurrency dimension is WriteDuringRead's job);
every txn commits or rolls the model back on conflict, so the model tracks
committed state exactly.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..client.atomic import VALUE_SIZE_LIMIT, apply_atomic
from ..client.transaction import KEY_SIZE_LIMIT, KeySelector, key_after
from ..client.types import MutationType
from ..flow.error import FdbError
from .base import TestWorkload
from .write_during_read import ATOMIC_OPS, clamp_to_prefix, model_get_key


class FuzzApiWorkload(TestWorkload):
    name = "fuzz_api"

    def __init__(
        self,
        nodes: int = 24,
        txns: int = 20,
        ops_per_txn: int = 12,
        prefix: bytes = b"\x02fuzz/",
    ):
        self.nodes = nodes
        self.txns = txns
        self.ops_per_txn = ops_per_txn
        self.prefix = prefix
        self.model: Dict[bytes, bytes] = {}
        self.errors_exercised: set = set()
        self.failures: List[str] = []

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    def _rand_key(self, rng) -> bytes:
        return self._key(int(rng.random_int(0, self.nodes)))

    def _rand_value(self, rng) -> bytes:
        return bytes(
            int(rng.random_int(0, 256))
            for _ in range(int(rng.random_int(0, 16)))
        )

    def _fail(self, msg: str):
        self.failures.append(msg)

    async def _expect_error(self, name: str, thunk):
        """Run thunk; it must raise FdbError(name) (the op contract)."""
        try:
            r = thunk()
            if hasattr(r, "__await__"):
                await r
            self._fail(f"expected {name}, got success")
        except FdbError as e:
            if e.name != name:
                self._fail(f"expected {name}, got {e.name}")
            else:
                self.errors_exercised.add(name)

    async def _one_op(self, tr, staged: Dict[bytes, Optional[bytes]], rng):
        """One random (possibly illegal) op.  `staged` is this txn's RYW
        overlay on self.model; reads check against model+staged."""

        def view(key):
            return staged[key] if key in staged else self.model.get(key)

        r = rng.random01()
        if r < 0.14:  # legal point read
            key = self._rand_key(rng)
            want = view(key)
            got = await tr.get(key)
            if got != want:
                self._fail(f"get({key!r}) = {got!r}, want {want!r}")
        elif r < 0.26:  # legal set
            key, val = self._rand_key(rng), self._rand_value(rng)
            tr.set(key, val)
            staged[key] = val
        elif r < 0.34:  # legal clear / clear_range
            a = int(rng.random_int(0, self.nodes))
            b = min(self.nodes, a + int(rng.random_int(0, 5)))
            ka, kb = self._key(a), self._key(b)
            tr.clear_range(ka, kb)
            # Clear EVERY key in range — committed versionstamped keys sort
            # between node keys and must be cleared from the model too.
            for k in list(self.model) + list(staged):
                if ka <= k < kb:
                    staged[k] = None
        elif r < 0.44:  # legal atomic
            op = ATOMIC_OPS[int(rng.random_int(0, len(ATOMIC_OPS)))]
            key, operand = self._rand_key(rng), self._rand_value(rng)
            tr.atomic_op(op, key, operand)
            staged[key] = apply_atomic(op, view(key), operand)
        elif r < 0.52:  # legal range read
            a = int(rng.random_int(0, self.nodes))
            b = min(self.nodes, a + int(rng.random_int(0, 8)))
            got = await tr.get_range(self._key(a), self._key(b))
            merged = {
                k: v
                for k, v in list(self.model.items())
                if self._key(a) <= k < self._key(b)
            }
            for k, v in staged.items():
                if self._key(a) <= k < self._key(b):
                    if v is None:
                        merged.pop(k, None)
                    else:
                        merged[k] = v
            want = sorted(merged.items())
            if got != want:
                self._fail(f"get_range[{a}:{b}] {len(got)} != {len(want)}")
        elif r < 0.58:  # system write without the option
            await self._expect_error(
                "key_outside_legal_range",
                lambda: tr.set(b"\xff/fuzz", b"x"),
            )
        elif r < 0.64:  # system read without the option
            await self._expect_error(
                "key_outside_legal_range", lambda: tr.get(b"\xff/fuzz")
            )
        elif r < 0.70:  # oversized key
            big = self.prefix + b"k" * (KEY_SIZE_LIMIT + 1)
            await self._expect_error("key_too_large", lambda: tr.set(big, b"v"))
        elif r < 0.76:  # oversized value
            await self._expect_error(
                "value_too_large",
                lambda: tr.set(
                    self._rand_key(rng), b"v" * (VALUE_SIZE_LIMIT + 1)
                ),
            )
        elif r < 0.82:  # inverted clear range
            await self._expect_error(
                "inverted_range",
                lambda: tr.clear_range(self._key(5), self._key(2)),
            )
        elif r < 0.88:  # malformed versionstamp param (bad offset)
            await self._expect_error(
                "client_invalid_operation",
                lambda: tr.atomic_op(
                    MutationType.SET_VERSIONSTAMPED_VALUE,
                    self._rand_key(rng),
                    b"short" + (200).to_bytes(4, "little"),
                ),
            )
        elif r < 0.94:  # read of a versionstamped key -> unreadable
            key = self._rand_key(rng)
            stamp_param = key + b"\x00" * 10 + (len(key)).to_bytes(4, "little")
            tr.atomic_op(
                MutationType.SET_VERSIONSTAMPED_KEY, stamp_param, b"v"
            )
            # Any key inside the possible stamp range is unreadable until
            # commit resolves the stamp.
            await self._expect_error(
                "accessed_unreadable", lambda: tr.get(key + b"\x00" * 10)
            )
            # The stamped key is unknowable pre-commit: mark the txn
            # poisoned — start() commits immediately and resyncs the model
            # from the database.
            self._poisoned = True
        else:  # key selector resolution (legal)
            sel = KeySelector(
                key=self._rand_key(rng),
                or_equal=rng.random01() < 0.5,
                offset=int(rng.random_int(-3, 4)),
            )
            got = await tr.get_key(sel)
            merged = dict(self.model)
            for k, v in staged.items():
                if v is None:
                    merged.pop(k, None)
                else:
                    merged[k] = v
            want = model_get_key(merged, sel)
            got_c = clamp_to_prefix(got, self.prefix)
            want_c = clamp_to_prefix(want, self.prefix)
            if got_c != want_c:
                self._fail(
                    f"get_key({sel.key!r},{sel.or_equal},{sel.offset}) = "
                    f"{got!r}, want {want!r}"
                )

    async def start(self, db, cluster):
        rng = cluster.loop.rng
        for _ in range(self.txns):
            tr = db.create_transaction()
            staged: Dict[bytes, Optional[bytes]] = {}
            self._poisoned = False
            try:
                for _ in range(self.ops_per_txn):
                    await self._one_op(tr, staged, rng)
                    if self._poisoned:
                        # A versionstamped key makes part of the keyspace
                        # unreadable for the rest of this txn; commit now
                        # and resync the model (the stamp is unknowable).
                        break
                await tr.commit()
            except FdbError as e:
                if e.is_retryable_in_transaction() or e.name in (
                    "broken_promise",
                    "commit_unknown_result",
                ):
                    # Roll back the model; unknown results would need the
                    # marker protocol (WriteDuringRead has it) — here we
                    # resync the model from the database instead.
                    await self._resync(db)
                    continue
                raise
            if self._poisoned:
                await self._resync(db)
                continue
            for k, v in staged.items():
                if v is None:
                    self.model.pop(k, None)
                else:
                    self.model[k] = v

    async def _resync(self, db):
        out = {}

        async def read(tr):
            out["rows"] = await tr.get_range(self.prefix, self.prefix + b"\xff")

        await db.run(read)
        self.model = dict(out["rows"])

    async def check(self, db, cluster) -> bool:
        out = {}

        async def read(tr):
            out["rows"] = await tr.get_range(self.prefix, self.prefix + b"\xff")

        await db.run(read)
        db_state = {
            k: v for k, v in out["rows"] if not k.startswith(self.prefix + b"!")
        }
        if db_state != self.model:
            self._fail(
                f"final: db {len(db_state)} keys != model {len(self.model)}"
            )
        if self.failures:
            import sys

            for f in self.failures[:10]:
                print(f"[fuzz_api] FAIL: {f}", file=sys.stderr)
        # The sweep must actually exercise several error contracts.
        return not self.failures and len(self.errors_exercised) >= 3
