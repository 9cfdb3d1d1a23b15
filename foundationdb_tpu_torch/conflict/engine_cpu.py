"""Host conflict engine over chunked immutable runs: the port's CPU mirror.

A copy of the reference package's ``conflict/engine_cpu.py``
(``CpuConflictSet``, ``MirrorSnapshot``, ``chunk_encoding``).  It is the
production CPU path of ``ConflictSet`` and the always-authoritative mirror
behind its circuit breaker.  Same data model as every engine — keys[i]
starts the range [keys[i], keys[i+1]) whose last-committed-write version is
vers[i]; keys[0] is always b"" — but the flat sorted array is split into a
sequence of IMMUTABLE chunks:

  - ``detect``/``apply_batch`` apply a batch's whole committed write union
    as one sweep; only chunks an interval touches are rewritten
    (copy-on-write), untouched chunks keep their identity.
  - window eviction (ref SkipList::removeBefore) rewrites only the chunk
    span that holds a droppable boundary.
  - ``snapshot()`` is O(1): the chunk tuple is already immutable, so a
    snapshot handed to the device engine can never observe a half-mutated
    mirror.
  - ``boundary_count`` is an O(1) maintained count.

Chunks are numpy columns: ``ek`` the device key encoding [n, kw+1] uint32
(conflict/keys.py), ``va`` the int64 versions, ``pfx`` an order-preserving
uint64 prefix (the key's first 8 bytes).  A chunk holding a key longer than
4*key_words bytes keeps bytes primary (``ek is None``) and moves the engine
onto the per-boundary ``*_py`` sweeps, the long-key reference path.

Coalesced apply: with ``coalesce_window`` > 1, ``apply_batch`` queues each
batch's committed write union and folds the queue, in order, at the next
mirror read (snapshot, detect, flat views, counts) or every
``coalesce_window`` batches.  The fold replays the batches one by one
(batch k+1's end values read the state batch k left), so the mirror stays
equal to the device history batch for batch.

Chunk identity is the incremental-sync currency: ``chunk_encoding`` caches
a chunk's device encoding on the chunk, so rehydrating the device from a
snapshot re-encodes only chunks created since the last sync — and nothing
at all when the mirror's key width is the device's.

The live reshard of the sharded set hands chunks over between shards:
``slice_snapshot_chunks`` cuts one snapshot to a key range, adopting every
chunk wholly inside it by reference, and ``engine_from_handoff`` builds a
new shard's engine from such cuts, so a moved range keeps its chunks and
their encodings.

``engine_cpu_flat.FlatCpuConflictSet`` is the flat engine this one is
state-identical to.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import List, Optional, Tuple

import numpy as np

from ..flow.hotpath import hot_path
from . import keys as keylib
from .engine_cpu_flat import FLOOR_VERSION, _IntervalSet
from .types import CONFLICT, COMMITTED, TOO_OLD, TransactionConflictInfo

__all__ = ["CpuConflictSet", "MirrorSnapshot", "chunk_encoding", "engine_from_handoff",
           "slice_snapshot_chunks", "FLOOR_VERSION"]

_PAIR_INF = 1 << 63  # "no droppable pair here" sentinel

DEFAULT_KEY_WORDS = 4
DEFAULT_CHUNK = 256  # target boundaries per chunk


def _pfx_of_key(k: bytes) -> np.uint64:
    """Order-preserving uint64 prefix: the key's first 8 bytes, big-endian,
    zero-padded.  Returned as np.uint64 so searchsorted never compares in
    float64."""
    return np.uint64(int.from_bytes(k[:8].ljust(8, b"\x00"), "big"))


def _pfx_from_ek(ek: np.ndarray) -> np.ndarray:
    """Prefix column from encoded rows: the first two data words are the
    first 8 bytes, zero-padded."""
    w0 = ek[:, 0].astype(np.uint64) << np.uint64(32)
    if ek.shape[1] >= 3:  # key_words >= 2: a second data word exists
        return w0 | ek[:, 1].astype(np.uint64)
    return w0  # key_words == 1: keys are <= 4 bytes, low half is zero


def _pfx_from_keys(keys: list) -> np.ndarray:
    buf = b"".join(k[:8].ljust(8, b"\x00") for k in keys)
    return np.frombuffer(buf, dtype=">u8").astype(np.uint64)


class _Chunk:
    """One immutable run of boundaries as numpy columns (see the module
    docstring).  ``min_pair`` is the smallest max(va[i-1], va[i]) over the
    chunk's internal adjacent pairs: a chunk whose min_pair is at or above
    the window holds nothing to evict.  ``enc`` caches device encodings for
    key widths other than the chunk's own.  ``keys``/``vers`` materialize
    lazily."""

    __slots__ = (
        "ek", "va", "pfx", "kw", "max_ver", "min_pair", "enc",
        "_keys", "_vers", "_key0",
    )

    def __init__(self, keys: list, vers: list, kw: int):
        va = np.asarray(vers, dtype=np.int64)
        try:
            ek = keylib.encode_keys(keys, kw)
        except ValueError:
            ek = None  # long key: bytes stay primary
        pfx = _pfx_from_ek(ek) if ek is not None else _pfx_from_keys(keys)
        self._init_cols(ek, va, pfx, kw)
        self._keys = list(keys)
        self._key0 = self._keys[0]

    @classmethod
    def from_cols(cls, ek, va, pfx, kw: int, mx=None, mp=None) -> "_Chunk":
        ch = object.__new__(cls)
        ch._init_cols(ek, va, pfx, kw, mx, mp)
        ch._keys = None
        ch._key0 = None
        return ch

    def _init_cols(self, ek, va, pfx, kw, mx=None, mp=None) -> None:
        self.ek = ek
        self.va = va
        self.pfx = pfx
        self.kw = kw
        # mx/mp: stats from the caller's bulk reduceat pass.
        self.max_ver = int(va.max()) if mx is None else mx
        if mp is not None:
            self.min_pair = mp
        elif len(va) > 1:
            self.min_pair = int(np.maximum(va[:-1], va[1:]).min())
        else:
            self.min_pair = _PAIR_INF
        self.enc = None
        self._vers = None

    @property
    def keys(self) -> list:
        ks = self._keys
        if ks is None:
            ks = self._keys = keylib.decode_keys(self.ek, self.kw)
        return ks

    @property
    def vers(self) -> list:
        vs = self._vers
        if vs is None:
            vs = self._vers = self.va.tolist()
        return vs

    @property
    def key0(self) -> bytes:
        k0 = self._key0
        if k0 is None:
            if self._keys is not None:
                k0 = self._keys[0]
            else:
                k0 = keylib.decode_key(self.ek[0], self.kw)
            self._key0 = k0
        return k0

    @property
    def last_key(self) -> bytes:
        if self._keys is not None:
            return self._keys[-1]
        return keylib.decode_key(self.ek[-1], self.kw)

    def __len__(self):
        return len(self.va)


def _ch_bisect_rows(ch: _Chunk, qrow: np.ndarray, qpfx, side: str) -> int:
    """Row index where the ENCODED query row would insert (bisect_left /
    bisect_right semantics): searchsorted on the prefix column, refined
    over full encoded rows only inside a tie run.  Requires ch.ek."""
    a = ch.pfx
    lo = int(np.searchsorted(a, qpfx, "left"))
    hi = int(np.searchsorted(a, qpfx, "right"))
    if lo == hi:
        return lo
    rows = ch.ek
    qt = qrow.tolist()
    if side == "left":
        while lo < hi:
            mid = (lo + hi) >> 1
            if rows[mid].tolist() < qt:
                lo = mid + 1
            else:
                hi = mid
    else:
        while lo < hi:
            mid = (lo + hi) >> 1
            if rows[mid].tolist() <= qt:
                lo = mid + 1
            else:
                hi = mid
    return lo


def _ch_bisect_key(ch: _Chunk, k: bytes, side: str) -> int:
    """Byte-key twin of _ch_bisect_rows.  Tie runs refine over already
    materialized byte keys when present, else by encoding the one query
    key, falling back to byte keys for unencodable (long) queries."""
    a = ch.pfx
    qp = _pfx_of_key(k)
    lo = int(np.searchsorted(a, qp, "left"))
    hi = int(np.searchsorted(a, qp, "right"))
    if lo == hi:
        return lo
    if ch._keys is not None or ch.ek is None or len(k) > 4 * ch.kw:
        bis = bisect_left if side == "left" else bisect_right
        return bis(ch.keys, k, lo, hi)
    qrow = keylib.encode_keys([k], ch.kw)[0]
    return _ch_bisect_rows(ch, qrow, ch.pfx[lo], side)


class MirrorSnapshot:
    """O(1) immutable view of a CpuConflictSet at one instant.  ``stamp``
    increases with every mutation of the source engine: equal stamps mean
    identical state, and chunk identity across two snapshots means that key
    range did not change."""

    __slots__ = ("chunks", "oldest_version", "stamp", "boundary_count")

    def __init__(self, chunks: tuple, oldest_version: int, stamp: int,
                 boundary_count: int):
        self.chunks = chunks
        self.oldest_version = oldest_version
        self.stamp = stamp
        self.boundary_count = boundary_count

    def to_flat(self) -> Tuple[list, list]:
        """Materialize (keys, vers) lists — O(H), diagnostic/diff use."""
        ks: list = []
        vs: list = []
        for ch in self.chunks:
            ks.extend(ch.keys)
            vs.extend(ch.vers)
        return ks, vs


class CpuConflictSet:
    """Exact reference-semantics engine over chunked immutable runs.

    ``chunk`` is the target chunk size (tests pass tiny values to force
    many chunks on small histories); ``key_words`` fixes the columnar
    encoding width — the device engine's, so that syncing the device
    re-encodes nothing.  ``coalesce_window`` (see the module docstring)
    defaults to 1: every apply_batch folds at once."""

    def __init__(self, oldest_version: int = 0, chunk: int = DEFAULT_CHUNK,
                 key_words: int = DEFAULT_KEY_WORDS, coalesce_window: int = 1):
        self._oldest = oldest_version
        self.chunk_size = chunk
        self._kw = key_words
        head = _Chunk([b""], [FLOOR_VERSION], self._kw)
        self._chunks: tuple = (head,)
        self._starts: list = [b""]
        self._count = 1
        self._any_long = head.ek is None
        self._stamp = 0
        self._flat: Optional[Tuple[list, list]] = None
        # Concatenated (ek, va, pfx, row offsets) over all chunks — the
        # vectorized sweep/locate workspace, invalidated by _set_chunks.
        self._g: Optional[tuple] = None
        # Per-txn abort witness of the most recent detect().
        self.last_witness: list = []
        self.coalesce_window = coalesce_window
        self._pending: list = []  # queued (active, now, new_oldest)
        # Maintenance telemetry: chunks rewritten, window advances, and
        # window advances that dropped nothing.
        self.chunks_rebuilt = 0
        self.evict_scans = 0
        self.evict_skips = 0
        # Chunks created since the last take_fresh_chunks(): the device
        # sync hint.  Past _FRESH_CAP the list is dropped and the consumer
        # walks every chunk instead.
        self._fresh: list = []
        self._fresh_overflow = False
        # Keys assigned through the ``keys`` setter, waiting for their
        # ``vers`` (store_to-style adoption).
        self._staged_keys: Optional[list] = None

    _FRESH_CAP = 8192

    @property
    def oldest_version(self) -> int:
        # A queued batch only ever advances the window, so the post-fold
        # value is the max over the queue (no fold forced).
        if self._pending:
            return max(self._oldest, max(p[2] for p in self._pending))
        return self._oldest

    @oldest_version.setter
    def oldest_version(self, v: int) -> None:
        self._settle()
        self._oldest = v

    def _track_fresh(self, ch: _Chunk) -> _Chunk:
        if not self._fresh_overflow:
            if len(self._fresh) >= self._FRESH_CAP:
                self._fresh_overflow = True
                self._fresh = []
            else:
                self._fresh.append(ch)
        return ch

    def _new_chunk(self, keys: list, vers: list) -> _Chunk:
        return self._track_fresh(_Chunk(keys, vers, self._kw))

    def _new_chunk_cols(self, ek, va, pfx, mx=None, mp=None) -> _Chunk:
        return self._track_fresh(_Chunk.from_cols(ek, va, pfx, self._kw, mx, mp))

    @hot_path(bound="const")
    def take_fresh_chunks(self):
        """(chunks created since the last take, complete): the device's
        incremental-sync hint.  complete=False means the backlog overflowed
        and the consumer must walk every chunk.  Entries may already be
        dead; consumers treat the list as a superset hint."""
        self._settle()
        fresh, overflow = self._fresh, self._fresh_overflow
        self._fresh, self._fresh_overflow = [], False
        return fresh, not overflow

    # -- snapshots --
    @hot_path(bound="const")
    def snapshot(self) -> MirrorSnapshot:
        """O(1): the chunk tuple is already immutable."""
        self._settle()
        return MirrorSnapshot(self._chunks, self._oldest, self._stamp, self._count)

    @property
    def stamp(self) -> int:
        # Passive read: a queued batch has not mutated the chunks yet.
        return self._stamp

    @property
    def chunk_count(self) -> int:
        self._settle()
        return len(self._chunks)

    @property
    def pending_batches(self) -> int:
        """Queued-but-unfolded apply_batch calls (passive read)."""
        return len(self._pending)

    # -- the coalesce barrier --
    def _settle(self) -> None:
        if self._pending:
            pend, self._pending = self._pending, []
            for active, now, new_oldest in pend:
                self._commit_writes(active, now, new_oldest)

    # -- flat views --
    def _materialize(self) -> Tuple[list, list]:
        self._settle()
        if self._flat is None:
            ks: list = []
            vs: list = []
            for ch in self._chunks:
                ks.extend(ch.keys)
                vs.extend(ch.vers)
            self._flat = (ks, vs)
        return self._flat

    @property
    def keys(self) -> list:
        """Flat boundary-key list (read-only view; cached, O(H) on first
        access after a mutation)."""
        return self._materialize()[0]

    @property
    def vers(self) -> list:
        return self._materialize()[1]

    @keys.setter
    def keys(self, new_keys) -> None:
        """Flat adoption (store_to writes ``keys``, then ``vers``): the keys
        wait for their versions, and the chunks are rebuilt once."""
        self._settle()
        self._staged_keys = list(new_keys)

    @vers.setter
    def vers(self, new_vers) -> None:
        new_vers = list(new_vers)
        ks, self._staged_keys = self._staged_keys, None
        if ks is None or len(ks) != len(new_vers):
            raise ValueError("assign keys, then vers of the same length")
        self._rebuild_from_flat(ks, new_vers)

    def _rebuild_from_flat(self, ks: list, vs: list) -> None:
        """Replace the history with the flat lists (keys[0] == b""), cut
        into chunks of chunk_size boundaries."""
        if not ks or ks[0] != b"":
            raise ValueError("a history starts with the b'' floor boundary")
        c = self.chunk_size
        try:
            ek = keylib.encode_keys(ks, self._kw)
        except ValueError:
            self._set_chunks(tuple(self._new_chunk(ks[i : i + c], vs[i : i + c])
                                   for i in range(0, len(ks), c)))
            return
        va = np.asarray(vs, dtype=np.int64)
        pfx = _pfx_from_ek(ek)
        chunks = []
        for i in range(0, len(ks), c):
            ch = self._new_chunk_cols(ek[i : i + c], va[i : i + c], pfx[i : i + c])
            ch._keys = ks[i : i + c]  # the bytes are known: keep them
            ch._key0 = ch._keys[0]
            chunks.append(ch)
        self._set_chunks(tuple(chunks))

    def _set_chunks(self, chunks: tuple) -> None:
        self._chunks = chunks
        self._starts = [ch.key0 for ch in chunks]
        self._count = sum(len(ch) for ch in chunks)
        self._any_long = any(ch.ek is None for ch in chunks)
        self._stamp += 1
        self._flat = None
        self._g = None

    # -- global columns (the vectorized sweep/locate workspace) --
    def _gcols(self) -> tuple:
        """(ek_g, va_g, pfx_g, off): every chunk's columns concatenated and
        the chunk row offsets (off[-1] == boundary count).  Built lazily and
        reused until the chunk structure changes.  Requires not _any_long."""
        g = self._g
        if g is not None:
            return g
        chunks = self._chunks
        if len(chunks) == 1:
            ch = chunks[0]
            ek_g, va_g, pfx_g = ch.ek, ch.va, ch.pfx
        else:
            ek_g = np.concatenate([ch.ek for ch in chunks])
            va_g = np.concatenate([ch.va for ch in chunks])
            pfx_g = np.concatenate([ch.pfx for ch in chunks])
        off = np.zeros(len(chunks) + 1, np.int64)
        np.cumsum(
            np.fromiter((len(ch) for ch in chunks), np.int64, count=len(chunks)),
            out=off[1:],
        )
        g = self._g = (ek_g, va_g, pfx_g, off)
        return g

    def _g_bisect_rows(self, qrows: np.ndarray, qpfx: np.ndarray, side: str) -> np.ndarray:
        """Global bisect of many encoded query rows at once: two
        searchsorted calls on the prefix column; only queries inside a
        prefix-tie run are refined by a binary search over full rows."""
        ek_g, _, pfx_g, _ = self._gcols()
        pos = np.searchsorted(pfx_g, qpfx, side=side)
        alt = np.searchsorted(pfx_g, qpfx, side=("right" if side == "left" else "left"))
        ties = np.flatnonzero(pos != alt)
        if ties.size:
            left = side == "left"
            for t in ties:
                lo = int(min(pos[t], alt[t]))
                hi = int(max(pos[t], alt[t]))
                q = qrows[t].tolist()
                while lo < hi:
                    mid = (lo + hi) >> 1
                    r = ek_g[mid].tolist()
                    if (r < q) if left else (r <= q):
                        lo = mid + 1
                    else:
                        hi = mid
                pos[t] = lo
        return pos

    # -- history step function --
    def _loc_le(self, k: bytes) -> Tuple[int, int]:
        """(chunk, index) of the greatest boundary <= k."""
        self._settle()
        c = bisect_right(self._starts, k) - 1
        return c, _ch_bisect_key(self._chunks[c], k, "right") - 1

    def _loc_lt(self, k: bytes) -> Tuple[int, int]:
        """(chunk, index) of the greatest boundary < k; requires k > b""."""
        self._settle()
        c = bisect_left(self._starts, k) - 1
        return c, _ch_bisect_key(self._chunks[c], k, "left") - 1

    def _range_max(self, b: bytes, e: bytes) -> int:
        """Max version over [b, e); requires b < e."""
        ci, ii = self._loc_le(b)
        cj, jj = self._loc_lt(e)
        chunks = self._chunks
        if ci == cj:
            return int(chunks[ci].va[ii : jj + 1].max())
        m = int(chunks[ci].va[ii:].max())
        for c in range(ci + 1, cj):
            mv = chunks[c].max_ver
            if mv > m:
                m = mv
        mj = int(chunks[cj].va[: jj + 1].max())
        return m if m > mj else mj

    def _value_at(self, k: bytes) -> int:
        c, i = self._loc_le(k)
        return int(self._chunks[c].va[i])

    # -- ConflictSet ABI (ref fdbserver/ConflictSet.h) --
    def detect(
        self,
        transactions: List[TransactionConflictInfo],
        now: int,
        new_oldest_version: int,
    ) -> List[int]:
        self._settle()  # a mirror read: queued batches must be visible
        statuses: list[int] = [COMMITTED] * len(transactions)
        # Abort witness: per txn, (conflicting write version, losing
        # read-range index) — None unless the final status is CONFLICT.
        witness: list = [None] * len(transactions)

        # Phase 1: too-old + history conflicts (ref checkReadConflictRanges).
        if self._any_long or not self._detect_phase1_cols(transactions, statuses, witness):
            for t, tr in enumerate(transactions):
                if tr.read_snapshot < self._oldest and tr.read_ranges:
                    statuses[t] = TOO_OLD
                    continue
                for i, (rb, re_) in enumerate(tr.read_ranges):
                    if rb < re_:
                        m = self._range_max(rb, re_)
                        if m > tr.read_snapshot:
                            statuses[t] = CONFLICT
                            witness[t] = (m, i)
                            break

        # Phase 2: intra-batch, in order (ref checkIntraBatchConflicts)
        active = _IntervalSet()
        for t, tr in enumerate(transactions):
            if statuses[t] != COMMITTED:
                continue
            hit = next(
                (i for i, (rb, re_) in enumerate(tr.read_ranges)
                 if active.intersects(rb, re_)),
                None,
            )
            if hit is not None:
                statuses[t] = CONFLICT
                witness[t] = (now, hit)
                continue
            for (wb, we) in tr.write_ranges:
                active.add(wb, we)

        self.last_witness = witness
        self._commit_writes(active, now, new_oldest_version)
        return statuses

    def _detect_phase1_cols(self, transactions, statuses: list, witness: list) -> bool:
        """Vectorized phase 1.  Returns False when a query key is too long
        to encode; the caller then runs the per-range loop (the TOO_OLD
        marks made here are idempotent, so the rerun is safe)."""
        qb: list = []
        qe: list = []
        owner: list = []
        ridx: list = []
        for t, tr in enumerate(transactions):
            if tr.read_snapshot < self._oldest and tr.read_ranges:
                statuses[t] = TOO_OLD
                continue
            for i, (rb, re_) in enumerate(tr.read_ranges):
                if rb < re_:
                    qb.append(rb)
                    qe.append(re_)
                    owner.append(t)
                    ridx.append(i)
        nq = len(qb)
        if not nq:
            return True
        try:
            rows = keylib.encode_keys(qb + qe, self._kw)
        except ValueError:
            return False
        qpfx = _pfx_from_ek(rows)
        # loc_le(b) = bisect_right(b) - 1; loc_lt(e) = bisect_left(e) - 1
        ii = self._g_bisect_rows(rows[:nq], qpfx[:nq], "right") - 1
        jj = self._g_bisect_rows(rows[nq:], qpfx[nq:], "left") - 1
        va_g = self._gcols()[1]
        m = va_g[ii]
        for q in np.flatnonzero(jj > ii):
            m[q] = va_g[ii[q] : jj[q] + 1].max()
        snaps = np.fromiter((transactions[t].read_snapshot for t in owner), np.int64, nq)
        # Query order is txn order and range order, so the first hit per
        # txn wins, exactly as the per-range loop breaks.
        for q in np.flatnonzero(m > snaps):
            t = owner[q]
            if statuses[t] == COMMITTED:
                statuses[t] = CONFLICT
                witness[t] = (int(m[q]), ridx[q])
        return True

    @hot_path(bound="chunks")
    def apply_batch(
        self,
        transactions: List[TransactionConflictInfo],
        statuses: List[int],
        now: int,
        new_oldest_version: int,
    ) -> None:
        """Adopt an externally decided batch (the device engine's verdicts):
        merge the committed writes and advance the window exactly as
        detect() would have.  With coalesce_window > 1 the union is queued
        and folded at the next read or every coalesce_window batches."""
        active = _IntervalSet()
        for t, tr in enumerate(transactions):
            if statuses[t] != COMMITTED:
                continue
            for (wb, we) in tr.write_ranges:
                active.add(wb, we)
        if self.coalesce_window > 1:
            self._pending.append((active, now, new_oldest_version))
            if len(self._pending) >= self.coalesce_window:
                self._settle()
            return
        self._settle()  # the window shrank mid-stream: drain first
        self._commit_writes(active, now, new_oldest_version)

    def _commit_writes(self, active: _IntervalSet, now: int, new_oldest_version: int) -> None:
        """Phases 3-4: one batched overwrite sweep for the whole committed
        write union, then the chunk-skipping window eviction."""
        if active.begins:
            self._apply_intervals(active.begins, active.ends, now)
        if new_oldest_version > self._oldest:
            self._oldest = new_oldest_version
            self._evict(new_oldest_version)

    # -- phase 3: batched interval overwrite --
    def _apply_intervals(self, begins: list, ends: list, now: int) -> None:
        """Set the step function to `now` on every [begins[i], ends[i]).
        Intervals are sorted, disjoint and non-touching (the _IntervalSet
        invariant).  The columnar sweep runs unless a chunk or an endpoint
        is too long to encode."""
        if not self._any_long:
            try:
                be = keylib.encode_keys(list(begins) + list(ends), self._kw)
            except ValueError:
                be = None
            if be is not None:
                self._apply_intervals_cols(begins, ends, be, now)
                return
        self._apply_intervals_py(begins, ends, now)

    @hot_path(bound="chunks")
    def _apply_intervals_cols(self, begins: list, ends: list, be: np.ndarray, now: int) -> None:
        """The whole union as one vectorized assembly.  Writing [b, e)
        deletes every boundary in [bisect_left(b), bisect_right(e)) and
        inserts (b, now) and (e, value-in-force-at-e); a boundary equal to b
        or e is reproduced exactly by the delete and reinsert.  Delete
        ranges never interleave, so every output position has a closed
        form.  Only the chunk span the union touches is reassembled;
        chunks outside it are reused by reference."""
        n_int = len(begins)
        bpfx = _pfx_from_ek(be)
        lb = self._g_bisect_rows(be[:n_int], bpfx[:n_int], "left")
        rb = self._g_bisect_rows(be[n_int:], bpfx[n_int:], "right")
        ek_g, va_g, pfx_g, off = self._gcols()
        # Value in force at each e in the pre-batch state: row rb-1.
        end_vals = va_g[rb - 1]
        chunks = self._chunks
        n_chunks = len(chunks)
        c0 = min(n_chunks - 1, int(np.searchsorted(off, lb[0], "right")) - 1)
        c1 = min(n_chunks - 1, int(np.searchsorted(off, rb[-1], "right")) - 1)
        g0 = int(off[c0])
        g1 = int(off[c1 + 1])
        lbl = lb - g0
        rbl = rb - g0
        hs = g1 - g0
        # Keep mask over the span: a row survives iff no delete range
        # covers it.
        d = np.bincount(lbl, minlength=hs + 1).astype(np.int64)
        d -= np.bincount(rbl, minlength=hs + 1)
        kept_idx = np.flatnonzero(np.cumsum(d[:hs]) == 0)
        nk = kept_idx.size
        h2 = nk + 2 * n_int
        out_kept = np.arange(nk) + 2 * np.searchsorted(rbl, kept_idx, "right")
        out_b = np.searchsorted(kept_idx, lbl, "left") + 2 * np.arange(n_int)
        ek2 = np.empty((h2, be.shape[1]), np.uint32)  # perfcheck: ignore[HOT003]: becomes the rebuilt span's chunk columns (retained), so the engine's staging ring (_StagingRing) cannot serve it
        va2 = np.empty(h2, np.int64)  # perfcheck: ignore[HOT003]: retained as chunk columns, see ek2
        pfx2 = np.empty(h2, np.uint64)  # perfcheck: ignore[HOT003]: retained as chunk columns, see ek2
        sk = kept_idx + g0
        ek2[out_kept] = ek_g[sk]
        va2[out_kept] = va_g[sk]
        pfx2[out_kept] = pfx_g[sk]
        ek2[out_b] = be[:n_int]
        va2[out_b] = now
        pfx2[out_b] = bpfx[:n_int]
        out_e = out_b + 1
        ek2[out_e] = be[n_int:]
        va2[out_e] = end_vals
        pfx2[out_e] = bpfx[n_int:]
        out = list(chunks[:c0])
        self._flush_cols(out, [ek2], [va2], [pfx2])
        out.extend(chunks[c1 + 1 :])
        self._set_chunks(tuple(out))

    def _apply_intervals_py(self, begins: list, ends: list, now: int) -> None:
        """The per-boundary sweep: exact for any byte keys, including ones
        past 4*key_words — the long-key path."""
        # Per interval: delete boundaries in [b, e), insert (b, now), insert
        # (e, value_at(e)) unless a boundary already sits at e.
        end_vals = [self._value_at(e) for e in ends]
        chunks = self._chunks
        starts = self._starts
        n_chunks = len(chunks)
        n_int = len(begins)
        out: list = []  # new chunk sequence
        buf_k: list = []  # materialized pairs of the current touched run
        buf_v: list = []
        i = 0  # interval cursor
        in_del = False  # an interval's deletion range is open
        cur_e = b""
        cur_ev = 0
        for c in range(n_chunks):
            ch = chunks[c]
            s = starts[c]
            nxt = starts[c + 1] if c + 1 < n_chunks else None
            if in_del:
                if cur_e <= s:
                    in_del = False
                    i += 1
                elif nxt is not None and cur_e >= nxt:
                    continue
            if not in_del and not (i < n_int and (nxt is None or begins[i] < nxt)):
                # Untouched: reuse by reference.
                self._flush_pairs(out, buf_k, buf_v)
                out.append(ch)
                continue
            # Touched (or a deletion closes inside it): materialize.
            keys, vers = ch.keys, ch.vers
            m = len(keys)
            j = 0
            while j < m:
                k = keys[j]
                if in_del:
                    if k < cur_e:
                        j += 1  # deleted
                        continue
                    if k != cur_e:
                        buf_k.append(cur_e)
                        buf_v.append(cur_ev)
                    in_del = False
                    i += 1
                    continue  # re-examine k outside the deletion
                if i < n_int and begins[i] <= k:
                    buf_k.append(begins[i])
                    buf_v.append(now)
                    in_del = True
                    cur_e = ends[i]
                    cur_ev = end_vals[i]
                    continue  # re-examine k under the new deletion
                buf_k.append(k)
                buf_v.append(vers[j])
                j += 1
            # Tail: intervals starting after the chunk's last boundary but
            # before the next chunk (or anywhere, for the last chunk).
            while True:
                if in_del:
                    if nxt is not None and cur_e >= nxt:
                        break  # deletion spans into the next chunk
                    buf_k.append(cur_e)
                    buf_v.append(cur_ev)
                    in_del = False
                    i += 1
                elif i < n_int and (nxt is None or begins[i] < nxt):
                    buf_k.append(begins[i])
                    buf_v.append(now)
                    in_del = True
                    cur_e = ends[i]
                    cur_ev = end_vals[i]
                else:
                    break
        self._flush_pairs(out, buf_k, buf_v)
        assert not in_del and i == n_int, "interval sweep failed to converge"
        self._set_chunks(tuple(out))

    def _flush_pairs(self, out: list, buf_k: list, buf_v: list) -> None:
        """Re-chunk a run's accumulated (key, ver) pairs into ~chunk_size
        even pieces, append them to `out` and clear the buffers."""
        if not buf_k:
            return
        c = self.chunk_size
        pieces = max(1, (len(buf_k) + c - 1) // c)
        step = (len(buf_k) + pieces - 1) // pieces
        for o in range(0, len(buf_k), step):
            out.append(self._new_chunk(buf_k[o : o + step], buf_v[o : o + step]))
            self.chunks_rebuilt += 1
        del buf_k[:], buf_v[:]

    def _flush_cols(self, out: list, rek: list, rva: list, rpfx: list) -> None:
        """Columnar twin of _flush_pairs (same piece arithmetic, so both
        paths produce the same chunk sequences)."""
        if not rva:
            return
        if len(rva) == 1:
            ek, va, pfx = rek[0], rva[0], rpfx[0]
        else:
            ek = np.concatenate(rek)
            va = np.concatenate(rva)
            pfx = np.concatenate(rpfx)
        rek.clear(), rva.clear(), rpfx.clear()
        n = len(va)
        if n == 0:
            return  # e.g. an eviction span whose every row dropped
        c = self.chunk_size
        pieces = max(1, (n + c - 1) // c)
        step = (n + pieces - 1) // pieces
        starts = np.arange(0, n, step, dtype=np.int64)
        # Per-piece stats in two bulk reduceat passes.  The pair column is
        # masked at piece borders so each minimum sees only internal pairs;
        # INT64_MAX stands in for _PAIR_INF (both read as "nothing
        # provably droppable").
        i64max = np.iinfo(np.int64).max
        mx = np.maximum.reduceat(va, starts)
        mp = np.full(len(starts), i64max, np.int64)
        if n > 1:
            pair = np.maximum(va[:-1], va[1:])
            if len(starts) > 1:
                pair[starts[1:] - 1] = i64max
            ps = starts[starts < n - 1]
            mp[: len(ps)] = np.minimum.reduceat(pair, ps)
        for j, o in enumerate(starts.tolist()):
            out.append(self._new_chunk_cols(
                ek[o : o + step], va[o : o + step], pfx[o : o + step],
                int(mx[j]), int(mp[j]),
            ))
            self.chunks_rebuilt += 1

    # -- phase 4: window eviction --
    def _evict(self, old: int) -> None:
        """Drop boundary i (i > 0) iff vers[i] < old and the ORIGINAL
        vers[i-1] < old (ref SkipList::removeBefore): one keep mask over the
        global version column; only the chunk span bracketing the dropped
        rows is reassembled."""
        if self._any_long:
            self._evict_py(old)
            return
        self.evict_scans += 1
        ek_g, va_g, pfx_g, off = self._gcols()
        prev = np.empty_like(va_g)
        prev[1:] = va_g[:-1]
        prev[0] = old  # row 0 is always kept
        keep = (va_g >= old) | (prev >= old)
        drop = np.flatnonzero(~keep)
        if drop.size == 0:
            self.evict_skips += 1
            # oldest_version advanced: bump the stamp so equal stamps still
            # mean identical state.
            self._stamp += 1
            return
        chunks = self._chunks
        c0 = int(np.searchsorted(off, drop[0], "right")) - 1
        c1 = int(np.searchsorted(off, drop[-1], "right")) - 1
        g0 = int(off[c0])
        g1 = int(off[c1 + 1])
        idx = g0 + np.flatnonzero(keep[g0:g1])
        out = list(chunks[:c0])
        self._flush_cols(out, [ek_g[idx]], [va_g[idx]], [pfx_g[idx]])
        out.extend(chunks[c1 + 1 :])
        self._set_chunks(tuple(out))

    def _evict_py(self, old: int) -> None:
        """Per-boundary eviction — the long-key path."""
        chunks = self._chunks
        self.evict_scans += 1
        out: list = []
        buf_k: list = []  # survivors of the current rewritten run
        buf_v: list = []
        changed = False
        prev_last: Optional[int] = None  # original last version of prev chunk
        for ch in chunks:
            first_pair = _PAIR_INF
            if prev_last is not None:
                v0 = ch.vers[0]
                first_pair = prev_last if prev_last > v0 else v0
            if ch.min_pair >= old and first_pair >= old:
                self._flush_pairs(out, buf_k, buf_v)
                out.append(ch)
            else:
                keys, vers = ch.keys, ch.vers
                for idx in range(len(keys)):
                    v = vers[idx]
                    prev = prev_last if idx == 0 else vers[idx - 1]
                    if prev is None or v >= old or prev >= old:
                        buf_k.append(keys[idx])
                        buf_v.append(v)
                changed = True
            prev_last = ch.vers[-1]
        self._flush_pairs(out, buf_k, buf_v)
        if changed:
            self._set_chunks(tuple(out))
        else:
            self.evict_skips += 1
            self._stamp += 1

    def clear(self, version: int):
        self._pending = []  # clear overrides any queued batches
        self._set_chunks((self._new_chunk([b""], [FLOOR_VERSION]),))
        self._oldest = version

    @property
    def boundary_count(self) -> int:
        """O(1), after folding any queued batches."""
        self._settle()
        return self._count

    # -- columnar views: boundary order without materializing the flat
    # byte keys (the sharded balancer's quantiles read these) --
    def boundary_locate(self, key: bytes, side: str = "left") -> int:
        """Global index of `key` in boundary order (bisect_left /
        bisect_right per `side`): one chunk bisect, one in-chunk column
        bisect and an O(chunks) offset walk."""
        self._settle()
        c = bisect_right(self._starts, key) - 1
        base = 0
        for ch in self._chunks[:c]:
            base += len(ch)
        return base + _ch_bisect_key(self._chunks[c], key, side)

    def boundary_key_at(self, i: int) -> bytes:
        """The i-th boundary key; decodes one row."""
        self._settle()
        for ch in self._chunks:
            if i < len(ch):
                if ch._keys is not None or ch.ek is None:
                    return ch.keys[i]
                return keylib.decode_key(ch.ek[i], ch.kw)
            i -= len(ch)
        raise IndexError("boundary index out of range")


def chunk_encoding(ch, key_words: int):
    """(encoded keys [n, kw1] uint32, abs versions int64) for one immutable
    mirror chunk, cached on the chunk.  Returns (entry, keys_encoded_now):
    a chunk whose ``ek`` already has the requested width returns its live
    columns with zero keys encoded."""
    cache = ch.enc
    if cache is None:
        cache = ch.enc = {}
    ent = cache.get(key_words)
    if ent is not None:
        return ent, 0
    ek = ch.ek
    if ek is not None and ek.shape[1] == key_words + 1:
        ent = (ek, ch.va)
        cache[key_words] = ent
        return ent, 0
    ent = (keylib.encode_keys(ch.keys, key_words), np.asarray(ch.vers, dtype=np.int64))
    cache[key_words] = ent
    return ent, len(ch.keys)


# -- the live-reshard handoff --
def slice_snapshot_chunks(snap: MirrorSnapshot, lo: bytes,
                          hi: Optional[bytes]) -> Tuple[int, list]:
    """(version in force at `lo`, the chunks of `snap` restricted to the
    open interval (lo, hi)); hi=None means +inf.  A chunk wholly inside
    the interval is adopted by reference, so its identity, its columnar
    ``ek`` and its ``enc`` cache survive the move; a chunk straddling `lo`
    or `hi` is cut by column slices.  The snapshot is immutable, so a fault
    during the handoff cannot tear the cut."""
    floor = FLOOR_VERSION
    out: list = []
    for ch in snap.chunks:
        last = ch.last_key
        if last <= lo:
            # Wholly at or below lo: only its last version can be the one
            # in force at lo so far.
            floor = int(ch.va[-1])
            continue
        i = 0
        if ch.key0 <= lo:
            i = _ch_bisect_key(ch, lo, "right")  # first boundary > lo
            floor = int(ch.va[i - 1])
        j = _ch_bisect_key(ch, hi, "left") if hi is not None and last >= hi else len(ch.va)
        if i == 0 and j == len(ch.va):
            out.append(ch)
        elif i < j:
            if ch.ek is not None:
                sl = _Chunk.from_cols(ch.ek[i:j], ch.va[i:j], ch.pfx[i:j], ch.kw)
                if ch._keys is not None:
                    sl._keys = ch._keys[i:j]
                    sl._key0 = sl._keys[0]
                out.append(sl)
            else:
                out.append(_Chunk(ch.keys[i:j], ch.vers[i:j], ch.kw))
        if hi is not None and last >= hi:
            break
    return floor, out


def engine_from_handoff(parts, oldest_version: int, chunk: int = DEFAULT_CHUNK,
                        key_words: int = DEFAULT_KEY_WORDS) -> CpuConflictSet:
    """A shard engine for a new key range, built from immutable snapshot
    cuts of the old shards.  ``parts`` is ``[(snapshot, lo, hi)]`` in key
    order, covering the new range contiguously (hi=None = +inf).  The
    engine is re-anchored at ``b""`` with the version in force at the
    first part's ``lo`` as its floor; interior chunks keep their identity
    and only the chunks at moved split points are cut."""
    eng = CpuConflictSet(oldest_version, chunk=chunk, key_words=key_words)
    chunks: list = []
    first_floor: Optional[int] = None
    for snap, lo, hi in parts:
        floor, chs = slice_snapshot_chunks(snap, lo, hi)
        if first_floor is None:
            first_floor = floor
        chunks.extend(chs)
    head = eng._new_chunk([b""], [FLOOR_VERSION if first_floor is None else first_floor])
    eng._set_chunks(tuple([head] + chunks))
    return eng
