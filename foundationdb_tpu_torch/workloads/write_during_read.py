"""WriteDuringRead: RYW semantics under concurrent intra-transaction ops.

The port's own copy of the reference package's
``workloads/write_during_read.py``.

Ref: fdbserver/workloads/WriteDuringRead.actor.cpp — one client maintains a
byte-exact in-memory model of the database (`memory_db` = what this txn's
reads must see, `last_committed_db` = committed state) while issuing many
CONCURRENT operations inside each transaction: point reads, key-selector
resolutions, range reads (limits/reverse), sets, clears, range clears, and
atomic ops.  Every read's result is compared against the model computed at
the moment the read was ISSUED — a write racing with an in-flight read must
not leak into its result (the issue-time RYW snapshot in
client/transaction.py exists to guarantee exactly this).

Deviations from the reference, by design:
- Commits happen between op waves rather than racing ops (the reference
  tolerates transaction_cancelled/used_during_commit storms from the race;
  the used_during_commit guard itself is unit-tested separately).
- commit_unknown_result is resolved definitively by reading back a
  per-transaction marker key (the reference re-initializes the keyspace);
  the client's dummy-commit fence makes the outcome determinate.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..client.atomic import apply_atomic
from ..client.transaction import KeySelector, key_after
from ..client.types import MutationType
from ..flow.error import FdbError
from .base import TestWorkload

ATOMIC_OPS = [
    MutationType.ADD_VALUE,
    MutationType.AND_V2,
    MutationType.OR,
    MutationType.XOR,
    MutationType.MAX,
    MutationType.MIN_V2,
    MutationType.BYTE_MIN,
    MutationType.BYTE_MAX,
    MutationType.APPEND_IF_FITS,
]


def model_get_key(db: Dict[bytes, bytes], sel: KeySelector) -> bytes:
    """KeySelector resolution against a model dict, matching the client's
    documented semantics: index into the sorted key list at (first key
    {>|>=} sel.key) + offset - 1; b"" before the front, b"\\xff" past the
    end (ref: memoryGetKey WriteDuringRead.actor.cpp:118).  Shared by the
    WriteDuringRead and FuzzApi oracles so selector semantics cannot
    drift between them."""
    import bisect

    keys = sorted(db)
    start = key_after(sel.key) if sel.or_equal else sel.key
    idx = bisect.bisect_left(keys, start) + sel.offset - 1
    if idx < 0:
        return b""
    if idx >= len(keys):
        return b"\xff"
    return keys[idx]


def clamp_to_prefix(key: bytes, prefix: bytes) -> bytes:
    """Clamp a resolved key into a workload's prefix span, the way the
    reference clamps to its node range (WriteDuringRead.actor.cpp:148)."""
    return min(max(key, prefix), prefix + b"\xff")


class WriteDuringReadWorkload(TestWorkload):
    name = "write_during_read"

    def __init__(
        self,
        nodes: int = 40,
        txns: int = 12,
        ops_per_wave: int = 8,
        waves_per_txn: int = 3,
        value_size_max: int = 24,
        initial_key_density: float = 0.5,
        prefix: bytes = b"\x02wdr/",
        contention_actors: int = 0,
    ):
        self.nodes = nodes
        self.txns = txns
        self.ops_per_wave = ops_per_wave
        self.waves_per_txn = waves_per_txn
        self.value_size_max = value_size_max
        self.initial_key_density = initial_key_density
        self.prefix = prefix
        # Adversarial contention WITHOUT corrupting the memory model:
        # contender transactions declare write-CONFLICT ranges over the
        # node keys but carry zero mutations — the resolver aborts the
        # driver's overlapping reads (real not_committed outcomes in the
        # history) while the database bytes stay exactly what the model
        # says.  This is how the acceptance matrix gets high-contention
        # conflict decisions out of a single-driver memory-model workload.
        self.contention_actors = contention_actors
        self.marker = prefix + b"!marker"
        # Model state.
        self.memory_db: Dict[bytes, bytes] = {}
        self.last_committed: Dict[bytes, bytes] = {}
        self.success = True
        self.mismatches: List[str] = []
        self.committed_txns = 0
        self.conflicts = 0
        # Per-txn outcome log: the differential acceptance gate runs the
        # same seed under both conflict backends and compares these
        # histories entry by entry (BASELINE.json acceptance).
        self.history: List[tuple] = []

    # --- keys/values ---
    def _key(self, i: int) -> bytes:
        return self.prefix + b"%06d" % i

    def _rand_key(self, rng) -> bytes:
        return self._key(int(rng.random_int(0, self.nodes)))

    def _rand_value(self, rng) -> bytes:
        n = int(rng.random_int(0, self.value_size_max + 1))
        # Varied bytes so atomic and/or/xor do real work.
        return bytes(int(rng.random_int(0, 256)) for _ in range(n))

    def _rand_range(self, rng) -> Tuple[bytes, bytes]:
        a = int(rng.random_int(0, self.nodes))
        span = int(rng.random_int(0, 1 + min(self.nodes - a, 8)))
        return self._key(a), self._key(a + span)

    def _rand_selector(self, rng) -> KeySelector:
        scale = 1 << int(rng.random_int(0, 4))
        return KeySelector(
            key=self._rand_key(rng),
            or_equal=rng.random01() < 0.5,
            offset=int(rng.random_int(-scale, scale + 1)),
        )

    # --- the memory model (mirrors the reference's memoryGet* helpers) ---
    def _model_get(self, db: Dict[bytes, bytes], key: bytes) -> Optional[bytes]:
        return db.get(key)

    def _model_get_key(self, db: Dict[bytes, bytes], sel: KeySelector) -> bytes:
        return model_get_key(db, sel)

    def _model_get_range(
        self,
        db: Dict[bytes, bytes],
        begin: bytes,
        end: bytes,
        limit: int,
        reverse: bool,
    ) -> List[Tuple[bytes, bytes]]:
        keys = sorted(k for k in db if begin <= k < end)
        if reverse:
            keys = keys[::-1]
        return [(k, db[k]) for k in keys[:limit]]

    # --- op coroutines ---
    # Every op starts with a random stagger so writes land WHILE reads are
    # awaiting storage (the whole point of the workload).  After the
    # stagger, a read computes its expected value from the model and issues
    # the db read in the SAME task step (no await between) — matching the
    # client's issue-time RYW snapshot; a write updates the model and the
    # transaction atomically at its own issue point.
    async def _stagger(self, loop, rng):
        await loop.delay(rng.random01() * 0.003)

    async def _op_get(self, tr, rng, loop):
        await self._stagger(loop, rng)
        key = self._rand_key(rng)
        want = self._model_get(self.memory_db, key)
        got = await tr.get(key)
        if got != want:
            self._fail(f"get({key!r}): db={got!r} model={want!r}")

    async def _op_get_key(self, tr, rng, loop):
        await self._stagger(loop, rng)
        sel = self._rand_selector(rng)
        want = self._model_get_key(self.memory_db, sel)
        got = await tr.get_key(sel)
        # Keys outside the workload's prefix belong to other subsystems:
        # clamp both sides the way the reference clamps to its node range
        # (WriteDuringRead.actor.cpp:148 res > getKeyForIndex(nodes)).
        want = clamp_to_prefix(want, self.prefix)
        got = clamp_to_prefix(got, self.prefix)
        if got != want:
            self._fail(
                f"get_key({sel.key!r},{sel.or_equal},{sel.offset}): "
                f"db={got!r} model={want!r}"
            )

    async def _op_get_range(self, tr, rng, loop):
        await self._stagger(loop, rng)
        begin, end = self._rand_range(rng)
        limit = (
            1 << 30
            if rng.random01() < 0.5
            else int(rng.random_int(0, 2 * self.nodes))
        )
        reverse = rng.random01() < 0.3
        want = self._model_get_range(self.memory_db, begin, end, limit, reverse)
        got = await tr.get_range(begin, end, limit=limit, reverse=reverse)
        if got != want:
            self._fail(
                f"get_range({begin!r},{end!r},lim={limit},rev={reverse}): "
                f"db={len(got)} rows model={len(want)} rows; "
                f"first diff {next((p for p in zip(got, want) if p[0] != p[1]), None)}"
            )

    async def _op_set(self, tr, rng, loop):
        await self._stagger(loop, rng)
        key, value = self._rand_key(rng), self._rand_value(rng)
        self.memory_db[key] = value
        tr.set(key, value)

    async def _op_clear(self, tr, rng, loop):
        await self._stagger(loop, rng)
        key = self._rand_key(rng)
        self.memory_db.pop(key, None)
        tr.clear(key)

    async def _op_clear_range(self, tr, rng, loop):
        await self._stagger(loop, rng)
        begin, end = self._rand_range(rng)
        for k in [k for k in self.memory_db if begin <= k < end]:
            del self.memory_db[k]
        tr.clear_range(begin, end)

    async def _op_atomic(self, tr, rng, loop):
        await self._stagger(loop, rng)
        op = ATOMIC_OPS[int(rng.random_int(0, len(ATOMIC_OPS)))]
        key, operand = self._rand_key(rng), self._rand_value(rng)
        new = apply_atomic(op, self.memory_db.get(key), operand)
        if new is None:
            self.memory_db.pop(key, None)
        else:
            self.memory_db[key] = new
        tr.atomic_op(op, key, operand)

    def _fail(self, msg: str):
        self.success = False
        self.mismatches.append(msg)

    # --- phases ---
    async def setup(self, db, cluster):
        rng = cluster.loop.rng

        async def init(tr):
            tr.clear_range(self.prefix, self.prefix + b"\xff")
            self.memory_db = {}
            for i in range(self.nodes):
                if rng.random01() < self.initial_key_density:
                    k, v = self._key(i), self._rand_value(rng)
                    tr.set(k, v)
                    self.memory_db[k] = v

        await db.run(init)
        self.last_committed = dict(self.memory_db)

    async def start(self, db, cluster):
        from ..flow.eventloop import all_of

        rng = cluster.loop.rng
        proc = db.process
        done = {"driver": False}
        contenders = [
            proc.spawn(self._contender(db, cluster, done, c), f"wdr_cont{c}")
            for c in range(self.contention_actors)
        ]
        try:
            await self._drive(db, cluster, rng, proc)
        finally:
            # Contenders must stop even when the driver dies — leaked
            # actors would spin until the simulation's timeout.
            done["driver"] = True
        if contenders:
            await all_of(contenders)

    async def _drive(self, db, cluster, rng, proc):
        from ..flow.eventloop import all_of

        txn_seq = 0
        while txn_seq < self.txns:
            txn_seq += 1
            tr = db.create_transaction()
            marker_val = b"txn%06d" % txn_seq
            tr.set(self.marker, marker_val)
            self.memory_db[self.marker] = marker_val
            try:
                loop = cluster.loop
                for _wave in range(self.waves_per_txn):
                    ops = []
                    for _ in range(self.ops_per_wave):
                        r = rng.random01()
                        if r < 0.18:
                            ops.append(self._op_get(tr, rng, loop))
                        elif r < 0.30:
                            ops.append(self._op_get_key(tr, rng, loop))
                        elif r < 0.48:
                            ops.append(self._op_get_range(tr, rng, loop))
                        elif r < 0.66:
                            ops.append(self._op_set(tr, rng, loop))
                        elif r < 0.76:
                            ops.append(self._op_clear(tr, rng, loop))
                        elif r < 0.84:
                            ops.append(self._op_clear_range(tr, rng, loop))
                        else:
                            ops.append(self._op_atomic(tr, rng, loop))
                    if ops:
                        await all_of(
                            [proc.spawn(o, "wdr_op") for o in ops]
                        )
                await tr.commit()
                self.committed_txns += 1
                self.last_committed = dict(self.memory_db)  # workload model protocol: ops mutate the model only inside the txn window and _drive reconciles at commit/conflict boundaries
                self.history.append(("commit", txn_seq))
            except FdbError as e:
                if e.name == "not_committed":
                    self.conflicts += 1
                    self.memory_db = dict(self.last_committed)
                    self.history.append(("conflict", txn_seq))
                elif e.name == "commit_unknown_result":
                    # The dummy-commit fence has run: the outcome is frozen.
                    # The marker key tells us which way it went.
                    committed = {}

                    async def probe(tr2):
                        committed["marker"] = await tr2.get(self.marker)

                    await db.run(probe)
                    if committed["marker"] == marker_val:
                        self.committed_txns += 1
                        self.last_committed = dict(self.memory_db)
                        self.history.append(("unknown-committed", txn_seq))
                    else:
                        self.memory_db = dict(self.last_committed)  # workload model protocol: rollback runs only in _drive between op batches, with no op coroutine in flight
                        self.history.append(("unknown-lost", txn_seq))
                elif e.is_retryable_in_transaction() or e.name == "broken_promise":
                    self.memory_db = dict(self.last_committed)
                    self.history.append(("retry", txn_seq))
                    await cluster.loop.delay(0.05)
                else:
                    raise

    async def _contender(self, db, cluster, done, cid: int):
        """Write-conflict-only pressure (see __init__): conflicts with the
        driver's reads at the resolver, mutates nothing."""
        from ..flow.error import FdbError

        rng = cluster.loop.rng
        while not done["driver"]:
            tr = db.create_transaction()
            a = int(rng.random_int(0, self.nodes))
            span = 1 + int(rng.random_int(0, 4))
            tr.add_write_conflict_range(self._key(a), self._key(a + span))
            try:
                await tr.get_read_version()
                await tr.commit()
            except FdbError:
                pass  # contender outcomes are irrelevant
            await cluster.loop.delay(0.002 + rng.random01() * 0.01)

    async def check(self, db, cluster) -> bool:
        final = {}

        async def read(tr):
            final["rows"] = await tr.get_range(
                self.prefix, self.prefix + b"\xff"
            )

        await db.run(read)
        want = sorted(self.last_committed.items())
        if final["rows"] != want:
            self._fail(
                f"final state: db={len(final['rows'])} rows, "
                f"model={len(want)} rows"
            )
        if self.mismatches:
            import sys

            for m in self.mismatches[:10]:
                print(f"[write_during_read] MISMATCH: {m}", file=sys.stderr)
        return self.success and self.committed_txns > 0
