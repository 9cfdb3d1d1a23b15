"""Serializability: committed history must equal serial commit-order replay.

The port's own copy of the reference package's ``workloads/serializability.py``.

Ref: fdbserver/workloads/Serializability.actor.cpp — random transactions
whose observed reads are checked against a serial re-execution.  Here every
transaction reads a few registers, writes unique values, and carries a
versionstamped probe; the check replays all committed transactions in
(commit_version, txn_number) order and asserts every transaction's reads
equal the model state at its read version.  Lost updates, stale reads
inside the MVCC window, or wrong conflict decisions all break the replay.

The probe makes commit_unknown_result exact: a retry that finds its own
probe landed parses the 10-byte stamp to recover the true commit version
and batch position instead of guessing (ref: the reference resolves
unknown commits by re-reading too).
"""

from __future__ import annotations

from ..client.types import MutationType
from .base import TestWorkload


class SerializabilityWorkload(TestWorkload):
    name = "serializability"

    def __init__(self, registers: int = 6, actors: int = 3, ops: int = 8,
                 prefix: bytes = b"ser/"):
        self.registers = registers
        self.actors = actors
        self.ops = ops
        self.prefix = prefix
        self.records: list = []  # (rv, cv, tn, reads{k:v}, writes{k:v})

    def _reg(self, i: int) -> bytes:
        return self.prefix + b"r/%02d" % i

    def _probe(self, ident: bytes) -> bytes:
        return self.prefix + b"p/" + ident

    async def start(self, db, cluster):
        from ..flow.eventloop import all_of
        from ..flow.error import FdbError

        rng = cluster.loop.rng

        async def actor(aid: int):
            for seq in range(self.ops):
                ident = b"%02d_%04d" % (aid, seq)
                n_reads = 2 + int(rng.random_int(0, 3))
                read_ks = [
                    self._reg(int(rng.random_int(0, self.registers)))
                    for _ in range(n_reads)
                ]
                write_ks = sorted(
                    {
                        self._reg(int(rng.random_int(0, self.registers)))
                        for _ in range(1 + int(rng.random_int(0, 2)))
                    }
                )
                writes = {k: ident + b"." + k[-2:] for k in write_ks}
                attempt = {}

                async def op(tr, ident=ident, read_ks=read_ks, writes=writes,
                             attempt=attempt):
                    probe = await tr.get(self._probe(ident))
                    if probe is not None:
                        from ..flow.testprobe import test_probe

                        test_probe("serializability_cv_recovered")
                        return probe  # earlier attempt landed; stamp inside
                    rv = await tr.get_read_version()
                    reads = {}
                    for k in sorted(set(read_ks)):
                        reads[k] = await tr.get(k)
                    attempt["rv"] = rv
                    attempt["reads"] = reads
                    for k, v in writes.items():
                        tr.set(k, v)
                    tr.atomic_op(
                        MutationType.SET_VERSIONSTAMPED_VALUE,
                        self._probe(ident),
                        b"\x00" * 10 + (0).to_bytes(4, "little"),
                    )
                    return None

                tr = db.create_transaction()
                cv = tn = None
                while True:
                    try:
                        landed = await op(tr)
                        if landed is not None:
                            cv = int.from_bytes(landed[:8], "big")
                            tn = int.from_bytes(landed[8:10], "big")
                            break
                        version = await tr.commit()
                        cv = version
                        tn = None  # resolved from the probe in check()
                        break
                    except FdbError as e:
                        await tr.on_error(e)
                if "rv" in attempt:
                    self.records.append(
                        (attempt["rv"], cv, tn, ident, attempt["reads"], writes)
                    )

        await all_of(
            [db.process.spawn(actor(a), f"ser{a}") for a in range(self.actors)]
        )

    async def check(self, db, cluster) -> bool:
        out = {}

        async def read(tr):
            out["probes"] = await tr.get_range(
                self.prefix + b"p/", self.prefix + b"p0"
            )
            out["regs"] = await tr.get_range(
                self.prefix + b"r/", self.prefix + b"r0"
            )

        await db.run(read)
        stamp_of = {
            k[len(self.prefix) + 2:]: (
                int.from_bytes(v[:8], "big"),
                int.from_bytes(v[8:10], "big"),
            )
            for k, v in out["probes"]
        }
        # Final records keyed by ident: every landed probe must belong to a
        # recorded commit, with its batch position resolved from the stamp.
        events = []
        for rv, cv, tn, ident, reads, writes in self.records:
            if ident not in stamp_of:
                return False  # committed per the client, probe missing
            pcv, ptn = stamp_of[ident]
            if cv is not None and pcv != cv:
                return False  # probe stamp disagrees with commit version
            events.append((pcv, ptn, rv, reads, writes))
        if len(events) != len(stamp_of):
            return False  # a probe landed for an unrecorded op
        events.sort(key=lambda e: (e[0], e[1]))
        # Serial replay in (commit_version, txn_number) order.  Reads at rv
        # must equal the model after every txn with cv <= rv.
        history = {}  # key -> list of (cv, tn, value), append-ordered
        for pcv, ptn, rv, reads, writes in events:
            for k, want in reads.items():
                got = None
                for hcv, _htn, hv in history.get(k, ()):
                    if hcv <= rv:
                        got = hv
                    else:
                        break
                if got != want:
                    return False
            for k, v in writes.items():
                history.setdefault(k, []).append((pcv, ptn, v))
        # The final database state must equal the replayed model.
        final = {k[-2:]: v for k, v in out["regs"]}
        model = {k[-2:]: hist[-1][2] for k, hist in history.items()}
        return final == model
