"""RyowCorrectness: ordered op sequences inside ONE transaction match an

The port's own copy of the reference package's ``workloads/ryow.py``.
in-memory model exactly.

Ref: fdbserver/workloads/RyowCorrectness.actor.cpp — build a random
sequence of mutations and reads, apply it to a ReadYourWrites transaction
AND to a deterministic in-memory model in the same order; every read
(point, range, limited, reverse, selector) must return byte-exactly what
the model predicts, and the committed database state must equal the
model afterwards.  This is the single-transaction ordered-semantics
complement to WriteDuringRead (concurrency) and FuzzApi (error
contracts).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..client.atomic import apply_atomic
from ..client.types import MutationType
from ..flow.error import FdbError
from .base import TestWorkload

_ATOMICS = [
    MutationType.ADD_VALUE,
    MutationType.AND,
    MutationType.OR,
    MutationType.XOR,
    MutationType.APPEND_IF_FITS,
    MutationType.MAX,
    MutationType.MIN,
    MutationType.BYTE_MAX,
    MutationType.BYTE_MIN,
]


class RyowCorrectnessWorkload(TestWorkload):
    name = "ryow"

    def __init__(self, keyspace: int = 40, txns: int = 10,
                 ops_per_txn: int = 25, prefix: bytes = b"ryow/"):
        self.keyspace = keyspace
        self.txns = txns
        self.ops_per_txn = ops_per_txn
        self.prefix = prefix
        self.reads_checked = 0

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    def _model_range(self, model: Dict[bytes, bytes], b, e, limit, reverse):
        keys = sorted(k for k in model if b <= k < e)
        if reverse:
            keys = keys[::-1]
        return [(k, model[k]) for k in keys[:limit]]

    async def start(self, db, cluster):
        rng = cluster.loop.rng
        model: Dict[bytes, bytes] = {}

        async def seed(tr):
            for i in range(0, self.keyspace, 3):
                v = b"s%d" % i
                tr.set(self._key(i), v)
                model[self._key(i)] = v

        await db.run(seed)

        for t in range(self.txns):
            local = dict(model)  # model of the txn's view
            marker = self.prefix + b"!txn%04d" % t
            tr = db.create_transaction()
            tr.set(marker, b"done")
            local[marker] = b"done"
            try:
                for _ in range(self.ops_per_txn):
                    op = int(rng.random_int(0, 6))
                    i = int(rng.random_int(0, self.keyspace))
                    k = self._key(i)
                    if op == 0:  # set
                        v = b"v%d_%d" % (t, int(rng.random_int(0, 999)))
                        tr.set(k, v)
                        local[k] = v
                    elif op == 1:  # clear
                        tr.clear(k)
                        local.pop(k, None)
                    elif op == 2:  # clear_range
                        j = min(self.keyspace,
                                i + 1 + int(rng.random_int(0, 6)))
                        tr.clear_range(k, self._key(j))
                        for kk in [x for x in local if k <= x < self._key(j)]:
                            del local[kk]
                    elif op == 3:  # atomic op
                        mt = _ATOMICS[int(rng.random_int(0, len(_ATOMICS)))]
                        param = int(rng.random_int(0, 1 << 30)).to_bytes(
                            8, "little"
                        )
                        tr.atomic_op(mt, k, param)
                        local[k] = apply_atomic(mt, local.get(k), param)
                    elif op == 4:  # point read
                        got = await tr.get(k)
                        assert got == local.get(k), (
                            f"txn {t}: get({k}) = {got}, model "
                            f"{local.get(k)}"
                        )
                        self.reads_checked += 1
                    elif op == 5:  # range read (limit, maybe reverse)
                        j = min(self.keyspace,
                                i + 1 + int(rng.random_int(0, 10)))
                        limit = int(rng.random_int(1, 8))
                        reverse = rng.random_int(0, 2) == 0
                        got = await tr.get_range(
                            k, self._key(j), limit=limit, reverse=reverse
                        )
                        want = self._model_range(
                            local, k, self._key(j), limit, reverse
                        )
                        assert got == want, (
                            f"txn {t}: range({k}..{self._key(j)}, "
                            f"limit={limit}, rev={reverse}) = {got[:4]}, "
                            f"model {want[:4]}"
                        )
                        self.reads_checked += 1
                    else:  # snapshot read must see the same (serial txns)
                        got = await tr.get(k, snapshot=True)
                        assert got == local.get(k)
                        self.reads_checked += 1
                await tr.commit()
                model.clear()
                model.update(local)
            except FdbError as e:
                if e.name == "commit_unknown_result":
                    # The txn's marker disambiguates whether it landed.
                    got = {}

                    async def probe(tr2, marker=marker):
                        got["v"] = await tr2.get(marker)

                    await db.run(probe)
                    if got["v"] is not None:
                        model.clear()
                        model.update(local)
                    continue
                if e.name in ("not_committed", "transaction_too_old",
                              "future_version", "broken_promise",
                              "process_behind", "database_locked"):
                    # The same retryable set the client's own on_error
                    # aborts-and-retries on: the txn did NOT commit, the
                    # model keeps the pre-txn state.
                    continue
                raise
        self._final_model = model

    async def check(self, db, cluster) -> bool:
        out = {}

        async def read(tr):
            out["rows"] = await tr.get_range(
                self.prefix, self.prefix + b"\xff"
            )

        await db.run(read)
        got = dict(out["rows"])
        want = self._final_model
        assert got == want, (
            f"committed state diverged from model: "
            f"{sorted(set(got) ^ set(want))[:6]}"
        )
        return self.reads_checked > 0
