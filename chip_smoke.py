#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole check, ten to fifteen minutes
    python3 chip_smoke.py --profile  # also a host/device time split and a
                                     # torch.profiler table of batches of
                                     # the main paths (flat, amortized and
                                     # tiered); the profiler slows the
                                     # host's launches in every later phase
    python3 chip_smoke.py --stamps   # also the search kernel's time by phase,
                                     # block by block (a -DPHASE1_STAMPS build)

Phases, in order; any failure exits non-zero; each group logs its host
seconds (`phase <name>: ...`):

  1. card      nvidia-smi's name and power limit, torch and CUDA versions
  2. build     nvcc both kernels from foundationdb_tpu_torch/conflict/csrc
  2c. programs the device program cost table (conflict/programs.py) on the
               card: every registered program once at the reference's
               canonical shapes on a valid empty history; its block, the
               bytes it allocates above its arguments and outputs (temp)
               and the run's wall ms
  2g. torchcheck  tools/lint/torchir.py over every registered program on
               the card and on the CPU: a program's findings on the card,
               its host syncs and op count beside the CPU's, and how many
               fingerprint lines differ (printed, not gated: the card's
               torch is not the one the committed baselines come from); a
               kernel program's kernel regions on the card hold its
               launches and their allocations and none of the plain
               twin's ops
  2h. source gate  fdblint (tools/lint/local.py and det101.py: DET001-003,
               DET101, IO001, TRC001, SPN001, ERR001, ENV001) and
               perfcheck (tools/lint/hotpath.py, HOT001-HOT004) from one
               load of the checkout's foundationdb_tpu_torch/ on the
               card's host: counts by rule, suppressed, seconds; any
               unsuppressed finding fails.  Then a planted dispatch->sync
               window on a TorchConflictSet(key_words=2, h_cap=1,024),
               with transfer_guard=True for (a)-(f) and without it for
               (g)-(j): a module written to a temporary file calls
               dispatch_txns (both kernels launch), then a callee under
               torch's sync debug mode "error", then sync_ticket; the
               callee is (a) torch.cuda.synchronize(), (b)
               np.asarray(ticket.host) or (c) ticket.out.item(), for
               fdblint (d) time.time(), (e) random.random() or (f)
               os.environ.get("FDB_TPU_X"), and the hidden syncs (g) `if
               ticket.out[0]:`, (h) `while (ticket.out > 0).any():`, (i)
               a host tensor's copy_(ticket.out) and (j)
               torch.cuda.current_stream().synchronize().  Each variant is
               linted ((a)-(c), (g)-(j): one HOT001 naming the chain
               "drive -> _peek"; (d) DET001 and (e) DET002 with a DET101
               naming that chain; (f) ENV001) and run: prints whether the
               runtime guard (for (g)-(j) the sync debug mode alone)
               caught it; every batch's verdicts equal a CPU run's
  3. kernels   each kernel at the bench shape (history h_cap = 3,145,728
               rows, 65,536-transaction batches, key_words=2) against its
               plain PyTorch twin on the same CUDA tensors, bit for bit;
               CUDA-event medians of kernel, plain twin and (where one
               exists) a single library call, beside the kernel's bound;
               the search also with a warm L2, and bit for bit on a second
               full-width input: 64 distinct word-0 values (the key in
               word 1, so every compare ties on word 0) and Zipf queries;
               the merge also with a warm L2, and bit for bit and timed on
               a second full-width input with heavy eviction (window above
               90% of the versions, runs of up to 1,000 dropped rows);
               then the tiered history's three forms at the tiered4
               shape, bit for bit, cold and warm, beside their bounds: the
               two-tier search (base 3,538,944 rows, delta 655,360, one
               sort of 131,072 queries), the delta merge (A the delta at
               width 655,360, B 131,072 rows) and the major compaction (A
               the base at width 3,538,944, B a 655,360-row delta with
               sparse keep flags, built by the engine's own
               _major_compact_inputs); then both at one shard's shape of
               phase 4s, bit for bit, cold and warm, beside their bounds:
               the search over 1,048,576 rows (358,750 live keys of the
               shard's range) with a batch's read ranges clipped to the
               shard, the merge with A 1,048,576 rows and 15,000 of B's
               131,072 valid
  4. main      ConflictSet(key_words=2, h_cap=3,145,728) at pipeline depth 2
               — the resolver's entry point: CPU mirror, circuit breaker,
               TorchConflictSet behind — on the bench stream (4-byte keys
               uniform in [0, 2e7), range width 1+U[0,10), 1 read + 1 write
               range per txn, detect at now=i+50 evicting below i), driven
               as the Resolver drives it (submit, complete the oldest while
               more than depth - 1 are in flight, drain): 52 warm-up
               batches fill the MVCC window, then 8 timed batches.  Both
               kernels must launch once per timed batch, with no CPU
               fallback, no merge order fault, no growth and a sorted
               history; mirror_check() must read "ok" (device history ==
               mirror at full width); device faults, breaker opens,
               degraded batches and fallback txns must be 0; pipeline
               dispatches must equal the batches submitted.  Prints txn/s,
               the mirror apply and note_synced ms a batch, the host syncs
               and allocations a batch and the device span of a batch
               (CUDA events around each dispatch).  Then the fixpoint's
               first chunk (rounds before its first host check: 1, 2 or
               FIXPOINT_CHUNK) on four more batches from one carried
               state: host checks and device span a batch for each, and
               equal outputs.
  4o. spans    inside phase 4: its 8 timed batches run with the port's own
               SpanHub, TraceCollector and FlightRecorder installed, in
               blocks of 2 that take turns between a disabled hub
               (SpanHub(enabled=False), first) and an enabled one, so the
               engine's last dispatch span is recorded, the pipeline drained
               at each block's end (phase 4's checks and 8 + 8 launches
               hold over them; the later paths hold every batch's verdicts
               and witnesses to phase 4's).  One encode, dispatch, device,
               sync, readback, apply and mirror_apply span a batch of the
               enabled arm, every device span closed and unmarked, device
               spans overlapping on the seq and wall axes, nothing recorded
               by the disabled hub, no trace event or capture.  Prints the
               span counts, each stage's wall extent a batch (median and
               range) beside phase 4's own timers, the overlap,
               host_phase_seq a turn and each arm's txn/s with their ratio,
               and the enabled hub's perfetto_json: its bytes and host ms,
               the schema valid, the device spans on 2 lanes
  4a. attribution  attribute_phases on phase 4's engine (its ~2.7 M-row
               history at h_cap 3,145,728) with one of phase 4's extra
               batches of 65,536 transactions, every arm (full, nosearch,
               nofix, nomerge, noevict, and each again on the plain
               non-kernel step) run once warm and 9 times timed, the arms
               taking turns: the full arm equals the engine's own dispatch
               of the batch, the plain full arm the kernel one, the
               engine's history is unchanged, each kernel arm launches the
               kernels it keeps once a run and a plain arm none, no merge
               order fault.  Prints each arm's CUDA-event and host ms and
               fixpoint host checks, each phase's ms and share of the full
               step, and the kernels' ms against the plain step's per
               phase.  Each arm's device busy time under torch.profiler
               waits for the end of the script (7.), because the profiler
               slows the host's launches for the rest of the process.  On a
               fresh span hub the attribution leaves exactly one
               phase.<name> span a phase, each a child of the engine's last
               dispatch span
  4g. 2level   three TorchConflictSets loaded from phase 4's end state (its
               mirror's snapshot, through load_from): search "" and
               search "2level" at strides 512 and 1024.  One of phase 4's
               extra batches on each: statuses, witnesses and exported
               state identical, one launch of each kernel an arm.  Then the
               step on that state, 1 warm + 5 timed runs an arm, the arms
               taking turns: the CUDA-event span of the step and of the
               merge prep's two searches; and searchsorted_words alone on
               the merge prep's own inputs (3,145,728 rows, 2 x 65,536
               segment endpoints), flat against 2level, bit for bit
  4v. guard    the transfer guard at full width: phase 4's state after its
               warm-up (its mirror's snapshot) in a ConflictSet(
               transfer_guard=True) and an unguarded one at depth 2, each
               rehydrating from it; phase 4's first 4 timed batches on
               both, the sets taking turns: verdicts and witnesses equal
               phase 4's, no TransferGuardError, host syncs a batch
               equal; prints each set's ms a batch (no
               claim), which calls the sync debug mode refuses, and the
               planted reads: np.asarray of a parked ticket's out and host
               raises TransferGuardError, an .item() planted in the guarded
               dispatch raises torch's error (the mode restored), the same
               .item() passes unguarded
  4q. resolver the port's Resolver role on its own event loop: phase 4's
               state after its warm-up in a ConflictSet with phase 4's
               settings (it rehydrates from it at its first batch) behind
               Resolver(n_proxies=2) on SimNetwork(deep_copy=False);
               phase 4's first 4 timed batches as
               ResolveTransactionBatchRequests from proxies p0 and p1 in
               turn, each pair's later batch sent first (the prevVersion
               chain parks it), batch 1 sent again while parked, a state
               transaction in batches 1 and 2: every
               reply's verdicts and witnesses equal phase 4's, the retry
               gets the cached reply (cache_hits 1), the state mutations
               reach the other proxy's next reply, stale_epoch and
               degraded_batches 0, phase 4's launches a batch, 4
               dispatches, queue depth 0, backend "ok", mirror_check "ok",
               4 batches and 262,144 transactions counted.  Prints the wall seconds
               from the first request to the last reply and txn/s through
               the role beside phase 4's (no claim), one deep-copied
               request's host ms, the pipeline gauges and stalls, the
               virtual resolve_seconds p50/p99 and host syncs a batch
  4w. witness-free  phase 4's stream, seed and scale through ConflictSet(
               witness=False): every batch's verdicts equal phase 4's and
               every witness is [], decode_witness never runs (a counter
               around it in this script), and phase 4's checks (launches,
               no fallback, mirror_check "ok", no growth).  Prints phase
               4's columns beside phase 4's own
  4c. coalesced  4w with mirror_coalesce="auto" (a fold every 2 batches at
               depth 2): the same checks, 4 note_synced calls and 4 folds
               in the 8 timed batches; prints the mirror apply, fold and
               note_synced ms beside phase 4's
  4e. amortized  the same stream and seed through ConflictSet(key_words=2,
               h_cap=3,538,944, evict_every=4) at depth 2 (the bench's
               evict4 arm): every batch's verdicts and witnesses equal
               phase 4's, one launch of each kernel a batch (8 + 8 in the
               timed 8), an eviction every 4th batch, mirror_check "ok"
               (below_window_keys printed), no growth, no CPU fallback.
               Prints txn/s and the device span of evicting and keeping
               batches apart
  4t. tiered   the same stream and seed through ConflictSet(history=
               "tiered", evict_every=4, delta_cap=655,360, h_cap=3,538,944)
               at depth 2 (the bench's tiered4 settings): every batch's
               verdicts and witnesses equal phase 4's; compactions on
               batches 4, 8, ... 60, so in the 8 timed batches the search
               launches 16 times and the merge 10 (8 delta merges, 2
               compactions); mirror_check "ok", no merge order fault, no
               CPU fallback, no growth.  Prints txn/s, the device span of
               compaction and minor batches apart, host syncs and
               allocations a batch.
  4s. sharded  the bench stream through ShardedTorchConflictSet at the
               bench's multichip shape (bench.py:547-606) on the one card:
               8 shards split by uniform_int_split_keys(8, 2e7, 4), each
               a history of 1,048,576 rows, driven through detect_packed
               (synchronous), 12 warm-up (SHARD_WARM: under a quarter of the
               window, so the timed batches evict nothing) and 8 timed
               batches.  Each kernel
               must launch exactly 64 times (once a shard a batch), with
               no growth, no CPU fallback, no degraded shard, no merge
               order fault, and mirror_check "ok" on all 8 shards.
               Prints txn/s, the host ms a batch of the batch's unpacking
               for the mirrors, the committed-write clip, the per-shard
               mirror applies and the witness decode,
               the host syncs a batch, and each shard's device span (CUDA
               events around its decide and commit halves); on fresh port
               hubs, one device and one apply span a batch (their wall
               extents printed), no rehydrate span, event or capture
  4r. resharded  phase 4s's set (built with max_shards=16), resharded live
               on the bench stream after its timed batches: split point 3
               (10,000,000) moves to 8,750,000 — live, shards 3 and 4
               moved, 6 mirrors kept — then 4 batches, the first with the
               two lazy rehydrates; then reshard(balance_split_keys(16)) —
               live, all 16 moved, 8 -> 16 shards — and 5 batches, the
               first with 16 rehydrates, the last 3 timed.  Each kernel
               must launch once a shard in every batch, only shards 3 and
               4 rehydrate after the move and every shard after the
               scale-up, with no growth, no CPU fallback, no degraded
               shard, no merge order fault, and mirror_check ok on every
               shard after each step.  Prints both reshard calls' host
               ms, the first batches' ms and their rehydrated keys
               (total and encoded), txn/s over the last 3 batches, host
               ms a batch of unpack, clip, mirror applies and witness
               decode, host syncs a batch, the device span of a batch and
               of a shard, and the occupancy before and after.  On fresh
               port hubs each step gives one ShardReshard event, one
               reshard marker span and one reshard capture, rehydrate
               spans for exactly the shards that rehydrate
  5. vs cpu    TorchConflictSet on a reduced stream on the GPU and on the
               CPU (plain twins): verdicts, witnesses and exported state
               identical
  6. set vs cpu  ConflictSet on the GPU on the same reduced stream at
               depths 1, 2 and 3: verdicts and witnesses identical to a
               ConflictSet(backend="cpu") run; then under a scripted
               injector (dispatch faults 1-3 open the breaker, the first
               probe takes a grow fault, the second rehydrates from a
               MirrorSnapshot and grows): verdicts still identical, the
               breaker walks
               ok -> degraded -> probing -> degraded -> probing -> ok, and
               the injected log and transitions equal the same script's run
               with device="cpu"
  6l. lost card  the lost-card classifier (device.is_lost_device) over
               every cudaError_t code 0-999 the card's runtime names, as
               the launcher's CudaError and as a torch.AcceleratorError
               with and without its error_code: exactly the four codes of
               device.LOST_DEVICE_CODES classify; prints their names and
               strings
  6t. tiered set vs cpu  the same at depths 1-3 with history="tiered",
               evict_every=3 and an 8,192-row delta (it grows at the first
               batch and compacts every third); under dispatch faults 3-6
               (batch 3 a compaction batch, held down through the first
               probe) verdicts identical and the injected log and breaker
               walk equal on cuda and cpu
  6e. ablation and amortized vs cpu  at phase 6's shape (4,096-txn
               batches): every attribution arm's outputs from one engine
               state equal on cuda and cpu, and ConflictSet(evict_every=3)
               under phase 6's fault script equal on cuda and cpu
               (verdicts, witnesses, injected log, breaker walk, counters,
               exported state) and to ConflictSet(backend="cpu")
  6w. settings vs cpu  8 batches of 2,048 transactions on cuda and cpu,
               every batch's verdict and witness digest equal: witness=
               False (TorchConflictSet and 4 shards, flat and tiered),
               mirror_coalesce 2 and "auto" at depths 1-3 (also equal to
               ConflictSet(backend="cpu"), as many note_synced calls), and
               search="2level" at h_cap 1 << 16 (TorchConflictSet and 4
               shards, flat and tiered, also equal to the flat search)
  6s. sharded set vs cpu  ShardedTorchConflictSet with 4 shards on a
               reduced stream, on the GPU and on the CPU, flat and tiered,
               from 4,096 rows a shard (so it grows): a dispatch outage on
               shard 1 over batches 2-4 opens its breaker, a grow outage
               fails its first probe's rehydration; verdicts, witnesses,
               the injected log, every breaker walk and the counters
               equal on cuda and cpu, only shard 1's breaker walks
  6r. resharded set vs cpu  the same 4 shards and stream, flat and tiered,
               on cuda and cpu under a reshard schedule: a boundary move
               after batch 3, a second move after batch 5 that a scripted
               reshard fault on moved shard 2 defers, its retry after
               batch 7, and balance_split_keys scale-ups to 6 and 8 shards
               after batches 8 and 10; verdicts, witnesses, the move log,
               the injected log, every breaker walk, the counters, h_cap
               and d_cap equal on cuda and cpu
  6o. spans vs cpu  phase 6's reduced stream through ConflictSet at
               depths 1 and 2 and through 2 shards, on cuda and on cpu,
               each on fresh port hubs whose clock is the batch index:
               dispatch faults open and close the breaker, a device edit
               planted after batch 7 diverges (mirror_check: the breaker
               opens again and recovers); spans_json() and host_phase_seq
               after every batch, the trace events and every capture's
               artifact_json byte-identical on the two devices, and so
               are perfetto_json and the lines of the CLI's trace-export,
               flightrec and latency
  6v. guard vs cpu  ConflictSet(transfer_guard=True) at depths 1-3 on
               phase 6's stream under a dispatch outage, on cuda and cpu:
               verdicts, witnesses, injected log, breaker walk, mirror and
               device export equal to the unguarded cuda run; at depths 2
               and 3 a parked ticket's read raises TransferGuardError on both
  6q. role vs cpu  phase 6's reduced stream (12 batches of 4,096) as 4q's
               request script through the Resolver over ConflictSet on cuda
               and on cpu at depths 1-3: every reply, its virtual time, the
               role's registry snapshot and conflict_witness equal
  6d. determinism  two fresh ConflictSets with phase 4's settings over the
               first 4 batches of phase 4's stream, each under fresh port
               hubs on a clock that counts its own reads: verdicts and
               witnesses, the export (keys, versions, count, oldest),
               metrics.snapshot() (no wall namespace) and spans_json()
               (no wall stamps) equal; one launch of each kernel a batch
  6c. chaos    (a) phase 4's ConflictSet, stream and seed (52 + 8 batches
               of 65,536 transactions at h_cap 3,145,728, depth 2) under
               the injector's random mode (the port's buggify armed on a
               DeterministicRandom, fire probability 0.05) and an
               open-ended dispatch outage over batches 54-56: every
               batch's verdicts and witnesses equal phase 4's, a legal
               breaker walk that ends ok, device_faults equal to the
               faults injected, at least one rehydration, mirror_check
               "ok", and each kernel launched once in every batch whose
               submit dispatched it and never in a batch the mirror
               served.  Prints the faults by site and kind, the buggify
               coverage, the degraded batches, each rehydration's
               CUDA-event and host ms and keys, a degraded turn's host ms
               against a device-served one's, and txn/s (not a claim).
               On fresh port hubs whose clock is the batch index: one
               DeviceBackendStateChange event and one breaker.<to> marker
               span a transition, a breaker_open capture for each open
               the 5 s cooldown admits (each with its transition and a
               span window), one device span a dispatch, all closed, the
               replayed ones marked.
               (b) the random mode at phase 6's shape (12 batches of
               4,096 transactions) for ConflictSet and a 4-shard
               ShardedTorchConflictSet (per-shard sites), the same seeds
               on cuda and cpu: injected log, breaker walks, counters,
               buggify coverage, verdicts and witnesses equal, and the
               flat set's verdicts equal ConflictSet(backend="cpu")'s
  7. result    phase 4a's arms once more each under torch.profiler, on
               the state they were attributed on: each phase's device busy
               and idle ms; then one JSON line per kernel table (launches: the flat main
               path's; launches_attribution: phase 4a's, every arm's runs;
               launches_witness_free, launches_coalesced: phases 4w's and
               4c's timed batches; launches_amortized: phase 4e's timed
               batches;
               launches_tiered: the tiered one's; launches_sharded:
               the sharded one's; launches_resharded: phase 4r's 9
               batches; launches_chaos: phase 6c(a)'s 60 batches;
               launches_resolver: phase 4q's 4 requests; tiered
               and sharded: those shapes' times), then {"ok": true, ...}

Imports nothing of JAX and nothing of the foundationdb_tpu package.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import hashlib
import importlib.util
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (fp32 peak)
KEYSPACE = 20_000_000
KEY_BYTES = 4
KEY_WORDS = 2
WINDOW = 50
H_CAP = 3_145_728
PER_BATCH = 65_536
WARM = WINDOW + 2
TIMED = 8
LIVE = 2_870_000  # steady-state history boundaries of the bench window
NEW_ROWS = 120_000  # valid new boundaries of one bench batch (of 131,072)
# The bench's tiered4 arm (bench.py:1092-1108): the base sized for three
# uncompacted batches, a delta of 655,360 rows, a compaction every 4th batch.
TIERED_H_CAP = H_CAP + 3 * 2 * PER_BATCH
D_CAP = 655_360
EVICT_EVERY = 4
DELTA_LIVE = 3 * NEW_ROWS  # delta rows just before a compaction
# The bench's multichip arm (bench.py:547-606) on one card: 8 key-range
# shards split evenly over the key space, each a history of
# _next_pow2(H_CAP / 8 + 4 * PER_BATCH) rows.
SHARDS = 8
SHARD_H_CAP = 1 << 20
SHARD_LIVE = LIVE // SHARDS  # steady-state boundaries of one shard
SHARD_NEW_ROWS = NEW_ROWS // SHARDS  # new boundaries one shard takes a batch
# Phase 4s's warm-up, cut from WARM to keep the script inside its time
# limit: its timed batches meet a history of SHARD_WARM batches' writes
# (under a quarter of the window's) and evict nothing.
SHARD_WARM = 12


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int, flush) -> float:
    """Median CUDA-event time of fn() over reps runs, the L2 cache flushed
    before each (the main path finds the history cold).  A GPU-side sleep
    after the flush keeps the host's launch cost out of the window."""
    import torch

    fn()  # warm
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cuda_ms_warm(fn, reps: int) -> float:
    """CUDA-event time of fn() averaged over reps back-to-back runs on the
    same inputs, so the L2 holds what the last run read.  A GPU-side sleep
    first keeps the host's launch cost out of the window."""
    import torch

    fn()  # warm
    torch.cuda._sleep(10_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes: int, nops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# the bench stream
# ---------------------------------------------------------------------------


def gen_packed(et, rng, n_txn, batch_index, keyspace=KEYSPACE):
    """One bench batch: 1 read + 1 write range per txn, int keys uniform in
    [0, keyspace), width 1 + U[0, 10), snapshot = batch index."""
    cap = et._next_pow2(n_txn, 8)
    pb = et.PackedBatch(cap, cap, cap, KEY_WORDS)
    for begin, end, txn in ((pb.r_begin, pb.r_end, pb.r_txn),
                            (pb.w_begin, pb.w_end, pb.w_txn)):
        a = rng.integers(0, keyspace, n_txn, dtype=np.int64)
        b = a + 1 + rng.integers(0, 10, n_txn, dtype=np.int64)
        begin[:n_txn] = et.keylib.encode_int_keys(a, KEY_WORDS, KEY_BYTES)
        end[:n_txn] = et.keylib.encode_int_keys(b, KEY_WORDS, KEY_BYTES)
        txn[:n_txn] = np.arange(n_txn, dtype=np.int32)
    pb.r_snap[:n_txn] = batch_index
    pb.t_snap[:n_txn] = batch_index
    pb.t_has_reads[:n_txn] = True
    pb.t_valid[:n_txn] = True
    pb.n_txn = pb.n_r = pb.n_w = n_txn
    return pb


def gen_txns(T, rng, n_txn, batch_index, keyspace=KEYSPACE):
    """gen_packed's batch (the same draws) as TransactionConflictInfo
    objects with 4-byte big-endian keys, the form a Resolver hands to
    ConflictSet."""
    cols = []
    for _ in range(2):
        a = rng.integers(0, keyspace, n_txn, dtype=np.int64)
        b = a + 1 + rng.integers(0, 10, n_txn, dtype=np.int64)
        for x in (a, b):
            raw = x.astype(">u4").tobytes()
            cols.append([raw[i : i + KEY_BYTES] for i in range(0, len(raw), KEY_BYTES)])
    rb, re_, wb, we = cols
    return [T(batch_index, [(rb[j], re_[j])], [(wb[j], we[j])]) for j in range(n_txn)]


def drive(cs, stream, depth, sink=None, tick=None):
    """The Resolver's discipline over (txns, now, new_oldest) batches:
    submit, complete the oldest while more than depth - 1 are in flight,
    drain.  Returns each batch's (statuses, witness), or hands each to
    sink(statuses, witness) instead; a finished batch's transactions are
    dropped at once.  tick(entry), when given, runs after each batch's
    turn with the entry its submit returned."""
    out, parked = [], []
    sink = sink or (lambda st, w: out.append((st, w)))
    for txns, now, nov in stream:
        entry = cs.pipeline_submit(txns, now, nov)
        parked.append(entry)
        while cs.pipeline_inflight > depth - 1:
            cs.pipeline_complete_oldest()
        while parked and parked[0].done:
            e = parked.pop(0)
            sink(e.statuses, e.witness)
        if tick is not None:
            tick(entry)
    cs.pipeline_drain()
    for e in parked:
        sink(e.statuses, e.witness)
    return out


def digest(statuses, witness) -> str:
    """One batch's verdicts and witnesses as a hash, so that two paths'
    60 batches compare without keeping them."""
    h = hashlib.sha256(np.asarray(statuses, np.int8).tobytes())
    h.update(repr(witness).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# phase 3: kernels at the bench shape
# ---------------------------------------------------------------------------


def sorted_queries(torch, rq, kw1, enc, a, b):
    """One batch's read ranges [a, b) as phase-1 queries: the ends on side 0,
    the begins on side 1, sorted with side as the last key."""
    dev = a.device
    n = a.shape[0]
    q = torch.cat([enc(b), enc(a)], dim=1)
    side = torch.cat([torch.zeros(n, dtype=torch.int32, device=dev),
                      torch.ones(n, dtype=torch.int32, device=dev)])
    perm = rq.lex_argsort([q[w] for w in range(kw1)] + [side])
    return q[:, perm].contiguous(), side[perm].contiguous()


def phase1_against_plain(torch, tk, h, q_s, side_s, what):
    got = tk.phase1_ranks(h, q_s, side_s)
    want = tk.phase1_ranks_reference(h, q_s, side_s)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err != 0:
        raise AssertionError(f"phase1_ranks disagrees with its plain twin on {what} "
                             f"(max |diff| {err})")
    return got, err


def phase1_bound(torch, tiers, q_s):
    """Bytes the search of one sorted query set in every tier of `tiers`
    needs: word 0 of every history row and query; the higher words only
    where word 0 ties (this run's data: a history row whose word 0 some
    query holds, a query whose word 0 some row of some tier holds); the
    sides in, each tier's ranks out.  Returns (bound_ms, bound_by, bytes,
    detail)."""
    kw1, m = q_s.shape
    nbytes = ops = 0
    q_tied = torch.zeros(m, dtype=torch.bool, device=q_s.device)
    h_ties = []
    for h in tiers:
        n = h.shape[1]
        h_ties.append(int(torch.isin(h[0], q_s[0]).sum()))
        q_tied |= torch.isin(q_s[0], h[0])
        nbytes += 4 * (n + (kw1 - 1) * h_ties[-1] + m)
        ops += m * (int(np.ceil(np.log2(n))) + 1) * 2 * kw1
    q_ties = int(q_tied.sum())
    nbytes += 4 * (m + (kw1 - 1) * q_ties + m)
    bound_ms, bound_by = bound(nbytes, ops)
    return (bound_ms, bound_by, nbytes,
            f"history word-0 ties {'/'.join(map(str, h_ties))}, query word-0 ties {q_ties}")


def key_tier(torch, keylib, gen, width, live, keyspace=KEYSPACE):
    """A sorted history tier in the carried layout (device encoding): the
    floor row b"" then live - 1 distinct sorted 4-byte keys in [0,
    keyspace), INF-padded to width."""
    dev = torch.device("cuda")
    keys = torch.randperm(keyspace, device=dev, generator=gen)[: live - 1]
    keys = torch.sort(keys).values.to(torch.int64)
    h = torch.full((KEY_WORDS + 1, width), keylib.INF_DEV, dtype=torch.int32, device=dev)
    h[:, 0] = keylib.ZERO_DEV
    h[0, 1:live] = (keys - 2**31).to(torch.int32)
    h[1, 1:live] = keylib.ZERO_DEV
    h[2, 1:live] = KEY_BYTES - 2**31
    return h


def batch_queries(torch, keylib, rq, gen, hi=None):
    """One bench batch's read ranges as sorted phase-1 queries; with `hi`,
    clipped to the shard [0, hi) as the sharded step clips them."""
    dev = torch.device("cuda")
    kw1 = KEY_WORDS + 1
    a = torch.randint(0, KEYSPACE, (PER_BATCH,), device=dev, generator=gen)
    b = a + 1 + torch.randint(0, 10, (PER_BATCH,), device=dev, generator=gen)
    if hi is not None:
        a, b = a.clamp(max=hi), b.clamp(max=hi)

    def enc(x):
        q = torch.empty((kw1, PER_BATCH), dtype=torch.int32, device=dev)
        q[0] = (x - 2**31).to(torch.int32)
        q[1] = keylib.ZERO_DEV
        q[2] = KEY_BYTES - 2**31
        return q

    return sorted_queries(torch, rq, kw1, enc, a, b)


def bench_search_input(torch, keylib, rq, gen):
    """The search at the bench shape: LIVE rows at h_cap, and one batch's
    read ranges as queries."""
    return (key_tier(torch, keylib, gen, H_CAP, LIVE),) + batch_queries(torch, keylib, rq, gen)


def skewed_search_input(torch, keylib, rq, gen):
    """The search on a second full-width input: word 0 takes only 64 values
    and word 1 carries the key, so nearly every compare ties on word 0, and
    the queries are Zipf-skewed (theta 0.9, the soak workload's default)
    over the history's keys.  Returns (h, q, side, hottest key's count)."""
    dev = torch.device("cuda")
    kw1 = KEY_WORDS + 1
    keys = torch.randperm(KEYSPACE, device=dev, generator=gen)[: LIVE - 1]
    keys = torch.sort(keys).values.to(torch.int64)

    def enc(x):
        q = torch.empty((kw1, x.shape[0]), dtype=torch.int32, device=dev)
        q[0] = (x * 64 // KEYSPACE - 2**31).to(torch.int32)
        q[1] = (x - 2**31).to(torch.int32)
        q[2] = KEY_BYTES - 2**31
        return q

    h = torch.full((kw1, H_CAP), keylib.INF_DEV, dtype=torch.int32, device=dev)
    h[:, 0] = keylib.ZERO_DEV
    h[:, 1:LIVE] = enc(keys)
    weights = torch.arange(1, LIVE, device=dev, dtype=torch.float64) ** -0.9
    hot = torch.randperm(LIVE - 1, device=dev, generator=gen)
    zipf_rank = torch.multinomial(weights, PER_BATCH, replacement=True, generator=gen)
    a = keys[hot[zipf_rank]]
    b = a + 1 + torch.randint(0, 10, (PER_BATCH,), device=dev, generator=gen)
    top = int(torch.bincount(zipf_rank).max())
    return (h,) + sorted_queries(torch, rq, kw1, enc, a, b) + (top,)


def check_phase1(torch, tk, keylib, rq, flush, gen):
    h, q_s, side_s = bench_search_input(torch, keylib, rq, gen)
    got, err = phase1_against_plain(torch, tk, h, q_s, side_s, "the bench shape")
    # Library yardstick: torch.searchsorted over an int64 packing of the
    # words.  Exact here because word 1 is constant across every live row
    # and query at 4-byte keys: pack (word 0, length word); a right rank
    # of p is the left rank of p + 1.
    if not (bool((h[1, :LIVE] == keylib.ZERO_DEV).all())
            and bool((q_s[1] == keylib.ZERO_DEV).all())):
        raise AssertionError("word 1 is not constant; the int64 packing is inexact")
    packed_h = (h[0].to(torch.int64) << 32) | (h[2].to(torch.int64) + 2**31)
    packed_q = (q_s[0].to(torch.int64) << 32) | (q_s[2].to(torch.int64) + 2**31)
    values = packed_q + side_s.to(torch.int64)

    def library():
        return torch.searchsorted(packed_h, values, out_int32=True)

    lib_err = int((library() - got).abs().max())
    if lib_err != 0:
        raise AssertionError(f"library yardstick disagrees (max |diff| {lib_err})")

    ms = cuda_ms(lambda: tk.phase1_ranks(h, q_s, side_s), 20, flush)
    warm_ms = cuda_ms_warm(lambda: tk.phase1_ranks(h, q_s, side_s), 50)
    plain_ms = cuda_ms(lambda: tk.phase1_ranks_reference(h, q_s, side_s), 5, flush)
    library_ms = cuda_ms(library, 20, flush)
    library_warm_ms = cuda_ms_warm(library, 50)
    bound_ms, bound_by, nbytes, detail = phase1_bound(torch, [h], q_s)
    return dict(
        name="phase1_ranks", route="cuda",
        source="foundationdb_tpu_torch/conflict/csrc/phase1_search.cu",
        replaces="foundationdb_tpu/conflict/kernels.py:553",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms, bytes=nbytes,
        detail=f"{detail}; warm L2: kernel_ms {warm_ms:.6f} library_ms {library_warm_ms:.6f}",
    )


def check_phase1_skewed(torch, tk, keylib, rq, flush, gen):
    """The search on the skewed, tie-heavy input, bit for bit against its
    plain twin, and its time and a library call's with the L2 flushed."""
    h, q_s, side_s, top = skewed_search_input(torch, keylib, rq, gen)
    got, err = phase1_against_plain(torch, tk, h, q_s, side_s, "the skewed input")
    # Library yardstick, exact here because word 0 is a function of word 1
    # (the key's bucket) on every row and query: pack (word 1, length word).
    packed_h = (h[1].to(torch.int64) << 32) | (h[2].to(torch.int64) + 2**31)
    packed_q = (q_s[1].to(torch.int64) << 32) | (q_s[2].to(torch.int64) + 2**31)
    values = packed_q + side_s.to(torch.int64)

    def library():
        return torch.searchsorted(packed_h, values, out_int32=True)

    lib_err = int((library() - got).abs().max())
    if lib_err != 0:
        raise AssertionError(f"skewed library yardstick disagrees (max |diff| {lib_err})")
    ms = cuda_ms(lambda: tk.phase1_ranks(h, q_s, side_s), 20, flush)
    library_ms = cuda_ms(library, 20, flush)
    bound_ms, bound_by, nbytes, detail = phase1_bound(torch, [h], q_s)
    log(f"kernel phase1_ranks skewed input (64 word-0 values, Zipf 0.9 queries, "
        f"hottest key {top} of {PER_BATCH} begins): kernel_ms {ms:.6f} library_ms "
        f"{library_ms:.6f} bound_us {bound_ms * 1e3:.3f} ({bound_by}, {nbytes} B) "
        f"max_abs_err {err} ({detail})")


def search_stamps(torch, keylib, rq, flush, gen):
    """--stamps: where the search kernel's time goes, block by block.  Builds
    phase1_search.cu with -DPHASE1_STAMPS (a %globaltimer stamp per block,
    after a barrier, at the start of each numbered phase and at the end),
    runs it on both inputs with the L2 flushed and warm, and prints each
    phase's median, 90th percentile and largest duration over the blocks.
    The stamps add barriers, so this build is not the timed kernel."""
    import ctypes

    from foundationdb_tpu_torch.conflict import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / "libphase1_search_stamps.so"
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-DPHASE1_STAMPS", "-o", str(so),
                          str(_build.CSRC / "phase1_search.cu")],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"stamped search build failed:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, args in _build.SIGNATURES["phase1_search"].items():
        getattr(lib, fn).argtypes = list(args)
        getattr(lib, fn).restype = ctypes.c_int
    lib.phase1_stamps_set.argtypes = [ctypes.c_void_p]
    lib.phase1_stamps_blocks.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    lib.phase1_stamps_blocks.restype = ctypes.c_longlong
    phases = 5  # stamp k opens phase k; stamp 6 ends the kernel
    inputs = (("bench shape", bench_search_input(torch, keylib, rq, gen)),
              ("skewed input", skewed_search_input(torch, keylib, rq, gen)[:3]))
    for label, (h, q_s, side_s) in inputs:
        kw1, n = h.shape
        m = q_s.shape[1]
        blocks = lib.phase1_stamps_blocks(n, m)
        ranks = torch.empty(m, dtype=torch.int32, device="cuda")
        stamps = torch.zeros((blocks, phases + 1), dtype=torch.int64, device="cuda")
        if lib.phase1_stamps_set(stamps.data_ptr()) != 0:
            raise RuntimeError("phase1_stamps_set failed")

        def run():
            err = lib.phase1_ranks_launch(h.data_ptr(), n, q_s.data_ptr(), side_s.data_ptr(),
                                          ranks.data_ptr(), m, kw1,
                                          torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"stamped search: CUDA error {err} at launch")

        for temp in ("cold", "warm"):
            run()
            if temp == "cold":
                flush.zero_()
            run()
            torch.cuda.synchronize()
            t = stamps.cpu().numpy()
            t0 = t[:, 0].min()
            cells = []
            for k in range(phases):
                p50, p90, top = np.percentile(t[:, k + 1] - t[:, k], [50, 90, 100])
                cells.append(f"{k + 1}. {p50:.0f}/{p90:.0f}/{top:.0f}")
            log(f"stamps {label}, L2 {temp}: blocks {blocks}, span {t[:, phases].max() - t0} ns, "
                f"block start p50/max {np.percentile(t[:, 0] - t0, 50):.0f}/"
                f"{(t[:, 0] - t0).max()} ns; per phase p50/p90/max ns: " + "; ".join(cells))


def merge_input(torch, gen, window, drop_run=0, na=H_CAP, live=LIVE, n_b=NEW_ROWS):
    """One full-width merge input.  A: the history's live rows, ~1% of them
    overwritten by the batch's segments (keep = 0), and with drop_run also
    runs of 1 to drop_run dropped rows (one run start in 5,000 rows, ~10%
    of the rows), as after a wide write segment.  B: the batch's sorted new
    boundaries, ~92% valid.  Positions partition [0, merged_count): B's are
    a random sorted subset, A's the rest in order.  Versions uniform in
    [0, 50): window 10 evicts ~4% of the merged rows, about one batch's
    share of a 50-batch window; window 45 puts 90% of the versions below
    it, as after a large removeBefore jump.  A has na rows, live of them
    live (the flat history by default; the tiered delta with na=D_CAP), and
    n_b of B's rows valid.  Returns (args, merged_count)."""
    dev = torch.device("cuda")
    kw1 = KEY_WORDS + 1
    NA, NB = na, 2 * PER_BATCH
    keep_a = torch.zeros(NA, dtype=torch.int32, device=dev)
    keep_a[:live] = (torch.rand(live, device=dev, generator=gen) > 0.01).to(torch.int32)
    if drop_run:
        starts = torch.nonzero(torch.rand(live, device=dev, generator=gen) < 2e-4).flatten()
        ends = starts + torch.randint(1, drop_run + 1, starts.shape, device=dev, generator=gen)
        edge = torch.zeros(live + 1, dtype=torch.int32, device=dev)
        edge.index_add_(0, starts, torch.ones_like(starts, dtype=torch.int32))
        edge.index_add_(0, ends.clamp(max=live), -torch.ones_like(ends, dtype=torch.int32))
        keep_a[:live][torch.cumsum(edge[:live], 0) > 0] = 0
    n_keep_a = int(keep_a.sum())
    keep_b = torch.zeros(NB, dtype=torch.int32, device=dev)
    keep_b[:n_b] = 1
    mc = n_keep_a + n_b
    slots = torch.randperm(mc, device=dev, generator=gen)
    b_slots = torch.sort(slots[:n_b]).values
    in_b = torch.zeros(mc, dtype=torch.bool, device=dev)
    in_b[b_slots] = True
    a_slots = torch.nonzero(~in_b).flatten()
    pos_a = torch.full((NA,), 2**31 - 1, dtype=torch.int32, device=dev)
    pos_a[keep_a != 0] = a_slots.to(torch.int32)
    pos_b = torch.full((NB,), 2**31 - 1, dtype=torch.int32, device=dev)
    pos_b[:n_b] = b_slots.to(torch.int32)

    def words(n):
        return torch.randint(-(2**31), 2**31 - 1, (kw1, n), dtype=torch.int32,
                             device=dev, generator=gen)

    def vers(n):
        return torch.randint(0, 50, (n,), dtype=torch.int32, device=dev, generator=gen)

    args = (words(NA), vers(NA), keep_a, pos_a, words(NB), vers(NB), keep_b, pos_b,
            torch.tensor(mc, dtype=torch.int32, device=dev),
            torch.tensor(window, dtype=torch.int32, device=dev))
    return args, mc


def merge_against_plain(torch, tk, args, width, what):
    """The kernel against its plain twin, bit for bit over the first count
    rows; returns (count, max |diff|)."""
    ok, ov, oc = tk.fused_merge_evict(*args, width=width)
    rk, rv, rc = tk.fused_merge_evict_reference(*args, width=width)
    n = int(rc)
    faults = tk.merge_contract_faults(ok.device)
    if faults:
        raise AssertionError(f"fused_merge_evict found {faults} order faults on {what}")
    if int(oc) != n:
        raise AssertionError(f"fused_merge_evict count {int(oc)} != plain {n} on {what}")
    err = max(int((ok[:, :n].to(torch.int64) - rk[:, :n].to(torch.int64)).abs().max()),
              int((ov[:n].to(torch.int64) - rv[:n].to(torch.int64)).abs().max()))
    if err != 0:
        raise AssertionError(f"fused_merge_evict disagrees with its plain twin on {what} "
                             f"(max |diff| {err})")
    return n, err


def merge_bound(args, mc, n, width):
    """Bytes the merge needs under its order contract: every row's keep
    flag; the merged rows' versions; B's kept positions (A's follow from
    them); the survivors' key words; the two scalars; the survivors' key
    words and versions and the count out.  Returns (bound_ms, bound_by,
    bytes)."""
    kw1, na = args[0].shape
    nb = args[4].shape[1]
    merged = min(mc, width)
    kept_b = int((args[6] != 0).sum())
    nbytes = 4 * (na + nb + merged + kept_b + kw1 * n + 2 + (kw1 + 1) * n + 1)
    return bound(nbytes, 8 * merged) + (nbytes,)


def check_merge(torch, tk, flush, gen):
    width = H_CAP
    args, mc = merge_input(torch, gen, 10)
    n, err = merge_against_plain(torch, tk, args, width, "the bench shape")

    def run():
        return tk.fused_merge_evict(*args, width=width)

    ms = cuda_ms(run, 20, flush)
    warm_ms = cuda_ms_warm(run, 50)
    plain_ms = cuda_ms(lambda: tk.fused_merge_evict_reference(*args, width=width), 5, flush)
    bound_ms, bound_by, nbytes = merge_bound(args, mc, n, width)
    log(f"kernel fused_merge_evict bench shape, warm L2 (50 back-to-back): "
        f"kernel_ms {warm_ms:.6f}")
    # Heavy eviction, bit for bit and timed with the L2 flushed.
    h_args, h_mc = merge_input(torch, gen, 45, drop_run=1000)
    h_n, h_err = merge_against_plain(torch, tk, h_args, width, "the heavy-eviction input")
    h_ms = cuda_ms(lambda: tk.fused_merge_evict(*h_args, width=width), 20, flush)
    h_bound_ms, h_bound_by, h_bytes = merge_bound(h_args, h_mc, h_n, width)
    kept_a = int((h_args[2] != 0).sum())
    log(f"kernel fused_merge_evict heavy-eviction input (window 45 over versions in "
        f"[0, 50), runs of 1-1000 dropped A rows; kept A rows {kept_a}, merged rows "
        f"{h_mc}, surviving rows {h_n}): kernel_ms {h_ms:.6f} bound_us "
        f"{h_bound_ms * 1e3:.3f} ({h_bound_by}, {h_bytes} B) max_abs_err {h_err}")
    del h_args
    return dict(
        name="fused_merge_evict", route="cuda",
        source="foundationdb_tpu_torch/conflict/csrc/merge_evict.cu",
        replaces="foundationdb_tpu/conflict/kernels.py:394",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, bytes=nbytes,
        detail=f"merged rows {mc}, surviving rows {n}; warm L2: kernel_ms {warm_ms:.6f}",
    )


# ---------------------------------------------------------------------------
# phase 3, the tiered history's forms at the tiered4 shape
# ---------------------------------------------------------------------------


def check_phase1_tiers(torch, tk, keylib, rq, flush, gen):
    """The tiered step's phase 1: a base of LIVE rows at TIERED_H_CAP and a
    delta of DELTA_LIVE rows at D_CAP searched with one sorted query set
    (two launches), each bit for bit against the plain twin."""
    base = key_tier(torch, keylib, gen, TIERED_H_CAP, LIVE)
    delta = key_tier(torch, keylib, gen, D_CAP, DELTA_LIVE)
    q_s, side_s = batch_queries(torch, keylib, rq, gen)
    err = max(phase1_against_plain(torch, tk, h, q_s, side_s, f"the tiered {what}")[1]
              for what, h in (("base", base), ("delta", delta)))
    # Library yardstick, exact as in check_phase1: word 1 is constant.
    values = ((q_s[0].to(torch.int64) << 32) | (q_s[2].to(torch.int64) + 2**31)) \
        + side_s.to(torch.int64)
    packed = [(h[0].to(torch.int64) << 32) | (h[2].to(torch.int64) + 2**31)
              for h in (base, delta)]

    def run():
        return [tk.phase1_ranks(h, q_s, side_s) for h in (base, delta)]

    def library():
        return [torch.searchsorted(p, values, out_int32=True) for p in packed]

    for got, lib in zip(run(), library()):
        if not torch.equal(got, lib):
            raise AssertionError("tiered search: library yardstick disagrees")
    out = dict(
        what="two-tier search (base 3,538,944 rows, delta 655,360, 131,072 queries; "
             "2 launches)",
        max_abs_err=err, ms=cuda_ms(run, 20, flush), warm_ms=cuda_ms_warm(run, 50),
        plain_ms=cuda_ms(lambda: [tk.phase1_ranks_reference(h, q_s, side_s)
                                  for h in (base, delta)], 3, flush),
        library_ms=cuda_ms(library, 20, flush),
    )
    out["bound_ms"], out["bound_by"], out["bytes"], out["detail"] = phase1_bound(
        torch, [base, delta], q_s)
    return out


def compaction_input(torch, et, keylib, gen):
    """The major compaction's merge arguments at the tiered4 shape, made by
    the engine's own _major_compact_inputs: a base of LIVE sorted keys at
    TIERED_H_CAP with versions uniform in [0, 50), and a delta at D_CAP laid
    out as write segments leave it: its floor row, then for each of about
    DELTA_LIVE / 2 segments [a, a + 1 + U[0, 10)) a begin row covered at a
    version in 50-52 (above every base version) and an end row at the
    floor.  Where an end row falls on a base key it is dropped, so B's keep
    flags have gaps.  Window 10.  Returns (args, merged_count)."""
    dev = torch.device("cuda")
    kw1 = KEY_WORDS + 1
    H, D = TIERED_H_CAP, D_CAP
    hk = key_tier(torch, keylib, gen, H, LIVE)
    hv = torch.full((H,), et.FLOOR_REL, dtype=torch.int32, device=dev)
    hv[:LIVE] = torch.randint(0, 50, (LIVE,), dtype=torch.int32, device=dev, generator=gen)
    n_seg = (DELTA_LIVE - 1) // 2
    begins = torch.randperm(KEYSPACE - 16, device=dev, generator=gen)[: n_seg + n_seg // 4]
    begins = torch.sort(begins).values
    ends = begins + 1 + torch.randint(0, 10, begins.shape, device=dev, generator=gen)
    apart = torch.cat([ends[:-1] < begins[1:], torch.ones(1, dtype=torch.bool, device=dev)])
    begins, ends = begins[apart][:n_seg], ends[apart][:n_seg]
    rows = torch.stack([begins, ends], dim=1).reshape(-1)
    nd = 1 + rows.shape[0]
    dk = torch.full((kw1, D), keylib.INF_DEV, dtype=torch.int32, device=dev)
    dk[:, 0] = keylib.ZERO_DEV
    dk[0, 1:nd] = (rows.to(torch.int64) - 2**31).to(torch.int32)
    dk[1, 1:nd] = keylib.ZERO_DEV
    dk[2, 1:nd] = KEY_BYTES - 2**31
    dv = torch.full((D,), et.FLOOR_REL, dtype=torch.int32, device=dev)
    dv[1:nd:2] = torch.randint(50, 53, ((nd - 1) // 2,), dtype=torch.int32, device=dev,
                               generator=gen)
    hc = torch.tensor(LIVE, dtype=torch.int32, device=dev)
    dc = torch.tensor(nd, dtype=torch.int32, device=dev)
    args = et._major_compact_inputs(hk, hv, hc, dk, dv, dc, H=H, D=D)
    window = torch.tensor(10, dtype=torch.int32, device=dev)
    return args + (window,), int(args[-1])


def check_tiered_merges(torch, tk, et, keylib, flush, gen):
    """The tiered step's two merges, bit for bit, cold and warm, beside
    their bounds: the delta merge (A the delta at D_CAP, B a batch's
    131,072 rows) and the major compaction (A the base at TIERED_H_CAP,
    B the delta with sparse keep flags)."""
    out = []
    for what, make, width in (
        ("delta merge (A 655,360-row delta, B 131,072 rows)",
         lambda: merge_input(torch, gen, 10, na=D_CAP, live=DELTA_LIVE), D_CAP),
        ("major compaction (A 3,538,944-row base, B 655,360-row delta, sparse keep)",
         lambda: compaction_input(torch, et, keylib, gen), TIERED_H_CAP),
    ):
        args, mc = make()
        n, err = merge_against_plain(torch, tk, args, width, f"the tiered {what}")
        kept_b = args[6] != 0
        # B rows not kept before its last kept one (0 for a dense prefix).
        gaps = int(torch.nonzero(kept_b).max()) + 1 - int(kept_b.sum())
        if width == TIERED_H_CAP and gaps == 0:
            raise AssertionError("the compaction input's delta has no gaps in its kept rows")

        def run():
            return tk.fused_merge_evict(*args, width=width)

        row = dict(
            what=what, max_abs_err=err, ms=cuda_ms(run, 20, flush), warm_ms=cuda_ms_warm(run, 50),
            plain_ms=cuda_ms(lambda: tk.fused_merge_evict_reference(*args, width=width), 3, flush),
            library_ms=None,
        )
        row["bound_ms"], row["bound_by"], row["bytes"] = merge_bound(args, mc, n, width)
        row["detail"] = (f"merged rows {mc}, surviving rows {n}, B kept rows "
                         f"{int(kept_b.sum())} of {args[6].shape[0]}, {gaps} unkept among them")
        out.append(row)
        del args
    return out


def log_shape(name, label, r, card):
    lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.6f}"
    log(f"kernel {name} {label} {r['what']}: kernel_ms {r['ms']:.6f} warm_ms "
        f"{r['warm_ms']:.6f} plain_ms {r['plain_ms']:.6f} bound_us {r['bound_ms'] * 1e3:.3f} "
        f"({r['bound_by']}, {r['bytes']} B) library_ms {lib} max_abs_err "
        f"{r['max_abs_err']} ({r['detail']}) [{card}]")


# ---------------------------------------------------------------------------
# phase 3, one shard of the sharded path
# ---------------------------------------------------------------------------


def check_phase1_shard(torch, tk, keylib, rq, flush, gen):
    """The sharded step's search on shard 0: SHARD_LIVE rows of keys in the
    shard's range [0, KEYSPACE / SHARDS) at SHARD_H_CAP, and a bench
    batch's read ranges clipped to the shard as queries (7 in 8 of them
    collapse onto its upper bound)."""
    hi = KEYSPACE // SHARDS
    h = key_tier(torch, keylib, gen, SHARD_H_CAP, SHARD_LIVE, keyspace=hi)
    q_s, side_s = batch_queries(torch, keylib, rq, gen, hi=hi)
    got, err = phase1_against_plain(torch, tk, h, q_s, side_s, "one shard's history")
    # Library yardstick, exact as in check_phase1: word 1 is constant.
    packed = (h[0].to(torch.int64) << 32) | (h[2].to(torch.int64) + 2**31)
    values = ((q_s[0].to(torch.int64) << 32) | (q_s[2].to(torch.int64) + 2**31)) \
        + side_s.to(torch.int64)

    def library():
        return torch.searchsorted(packed, values, out_int32=True)

    if not torch.equal(library(), got):
        raise AssertionError("shard search: library yardstick disagrees")

    def run():
        return tk.phase1_ranks(h, q_s, side_s)

    out = dict(
        what=f"one shard (history {SHARD_H_CAP:,} rows, {SHARD_LIVE:,} live; "
             f"{2 * PER_BATCH:,} clipped queries)",
        max_abs_err=err, ms=cuda_ms(run, 20, flush), warm_ms=cuda_ms_warm(run, 50),
        plain_ms=cuda_ms(lambda: tk.phase1_ranks_reference(h, q_s, side_s), 3, flush),
        library_ms=cuda_ms(library, 20, flush),
    )
    out["bound_ms"], out["bound_by"], out["bytes"], out["detail"] = phase1_bound(
        torch, [h], q_s)
    return out


def check_merge_shard(torch, tk, flush, gen):
    """The sharded step's merge on one shard: A the shard's history
    (SHARD_LIVE live rows of SHARD_H_CAP), B a batch's 131,072 segment rows
    of which SHARD_NEW_ROWS fall in the shard."""
    width = SHARD_H_CAP
    args, mc = merge_input(torch, gen, 10, na=width, live=SHARD_LIVE, n_b=SHARD_NEW_ROWS)
    n, err = merge_against_plain(torch, tk, args, width, "one shard's history")

    def run():
        return tk.fused_merge_evict(*args, width=width)

    out = dict(
        what=f"one shard (A {width:,} rows, {SHARD_LIVE:,} live; B {2 * PER_BATCH:,} rows, "
             f"{SHARD_NEW_ROWS:,} valid)",
        max_abs_err=err, ms=cuda_ms(run, 20, flush), warm_ms=cuda_ms_warm(run, 50),
        plain_ms=cuda_ms(lambda: tk.fused_merge_evict_reference(*args, width=width), 3, flush),
        library_ms=None,
    )
    out["bound_ms"], out["bound_by"], out["bytes"] = merge_bound(args, mc, n, width)
    out["detail"] = f"merged rows {mc}, surviving rows {n}"
    return out


# ---------------------------------------------------------------------------
# phases 4-5: the engine
# ---------------------------------------------------------------------------


def history_sorted(torch, rq, cs) -> int:
    keys_u32, _vers, n, _oldest, _base = cs.export_state()
    if not 1 <= n <= cs.h_cap:
        raise AssertionError(f"history count {n} outside [1, {cs.h_cap}]")
    from foundationdb_tpu_torch.conflict.keys import INF_WORD, to_device_words

    k = torch.from_numpy(to_device_words(keys_u32[:, :n]).copy())
    if n > 1 and not bool(rq.lex_less(k[:, :-1], k[:, 1:]).all()):
        raise AssertionError("exported history keys are not strictly sorted")
    if not (keys_u32[:, n:] == INF_WORD).all():
        raise AssertionError("history rows past the count are not INF")
    return n


class GcPauses:
    """Wall seconds the interpreter's garbage collector runs while this is
    installed (gc.callbacks)."""

    def __init__(self):
        self.seconds, self._t0 = 0.0, None
        gc.callbacks.append(self)

    def __call__(self, phase, _info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None

    def remove(self) -> float:
        gc.callbacks.remove(self)
        return self.seconds


class DispatchSpans:
    """CUDA events around each dispatch of an engine: a batch's device span,
    from the start of its upload to the end of its readback copy (the
    fixpoint's host checks inside it included), and whether it compacted
    (tiered) or evicted (amortized flat)."""

    def __init__(self, torch, eng):
        self.torch, self.eng, self.spans = torch, eng, []
        self._dispatch = eng.dispatch_packed
        eng.dispatch_packed = self._timed

    def _majors(self) -> int:
        c = self.eng.metrics.counters.get("major_compactions")
        return c.value if c is not None else 0

    def _timed(self, pb, now, new_oldest_version):
        a, b = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
        majors = self._majors()
        a.record()
        ticket = self._dispatch(pb, now, new_oldest_version)
        b.record()
        amortized = not self.eng.tiered and self.eng.evict_every > 1
        special = (self.eng._batches_since_evict == 0 if amortized
                   else self._majors() > majors)
        self.spans.append((a, b, special))
        return ticket

    def remove(self):
        """Stop timing; returns (compaction or evicting spans ms, other
        spans ms)."""
        del self.eng.dispatch_packed
        self.torch.cuda.synchronize()
        major = [a.elapsed_time(b) for a, b, c in self.spans if c]
        minor = [a.elapsed_time(b) for a, b, c in self.spans if not c]
        return major, minor


def bench_batches(T) -> list:
    """The bench stream's WARM + TIMED + 4 batches of PER_BATCH
    transactions (seed 2026), made once and shared by every full-width
    ConflictSet path: building 65,536 transactions takes the host about
    half a second a batch.  The objects are then frozen out of the garbage
    collector's sweeps (gc.freeze), so that a later collection does not
    walk millions of them."""
    rng = np.random.default_rng(2026)
    batches = [gen_txns(T, rng, PER_BATCH, i) for i in range(WARM + TIMED + 4)]
    gc.collect()
    gc.freeze()
    return batches


class DecodeCalls:
    """Counts the calls of engine_torch.decode_witness, and their wall
    seconds, while installed (the witness decode of every batch readback)."""

    def __init__(self, et):
        self.et, self.real, self.calls, self.seconds = et, et.decode_witness, 0, 0.0
        et.decode_witness = self

    def __call__(self, *args):
        t0 = time.perf_counter()
        out = self.real(*args)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out

    def remove(self):
        self.et.decode_witness = self.real


class SettleTimes:
    """Wall seconds of each fold of the mirror's coalesced batches (its
    _settle with batches queued), while installed."""

    def __init__(self, cpu):
        self.cpu, self.real, self.folds = cpu, cpu._settle, []
        cpu._settle = self

    def __call__(self):
        pending = self.cpu.pending_batches
        t0 = time.perf_counter()
        self.real()
        if pending:
            self.folds.append((pending, time.perf_counter() - t0))

    def remove(self):
        del self.cpu._settle


def path_mode(mode: str):
    """(label, ConflictSet settings) of a main-path mode: flat (phase 4),
    amortized (4e, the bench's evict4 arm: room for EVICT_EVERY - 1
    unevicted batches), tiered (4t, the tiered4 arm), witness-free (4w),
    and witness-free with the mirror's coalesced apply (4c)."""
    return {
        "flat": ("main", dict(h_cap=H_CAP)),
        "amortized": ("amortized", dict(h_cap=TIERED_H_CAP, evict_every=EVICT_EVERY)),
        "tiered": ("tiered", dict(h_cap=TIERED_H_CAP, history="tiered",
                                  evict_every=EVICT_EVERY, delta_cap=D_CAP)),
        "witness_free": ("witness-free", dict(h_cap=H_CAP, witness=False)),
        "coalesced": ("coalesced", dict(h_cap=H_CAP, witness=False, mirror_coalesce="auto")),
    }[mode]


def main_path(torch, api, batches, tk, rq, et, profile: bool, mode="flat", want=None,
              obs=None):
    """The bench stream through ConflictSet at depth 2, as a Resolver
    serves it, in one of path_mode's modes, on the bench stream's
    `batches` (bench_batches).  Every mode but the flat one must give
    every batch's verdicts as `want` (phase 4's result), and its witnesses
    too where the witness is on (a witness-free mode's are all []).
    Returns a dict: launches of the timed batches, txn/s, every batch's
    digest (verdicts and witness) and verdict digest, the set, the 4
    extra batches, and the stats its log line prints.  With `obs` (the
    spans, trace and flight_recorder modules), the timed batches are phase
    4o's (SpanArms)."""
    depth = 2
    tiered, amortized = mode == "tiered", mode == "amortized"
    label, settings = path_mode(mode)
    witness = settings.get("witness", True)
    gc.collect()  # an earlier phase's garbage is not this path's cost
    cs = api.ConflictSet(key_words=KEY_WORDS, pipeline_depth=depth, **settings)
    if tiered:
        # A search of both tiers a batch; a delta merge a batch and a
        # compaction every EVICT_EVERY batches (WARM is a multiple of it).
        expect = {"phase1_ranks": 2 * TIMED, "fused_merge_evict": TIMED + TIMED // EVICT_EVERY}
    else:
        expect = {name: TIMED for name in tk.LAUNCHES}
    eng, m = cs._dev, cs._dev.metrics
    window = cs._cpu.coalesce_window
    caps0 = (eng.h_cap, eng.d_cap)
    pairs, last = [], [None]

    def sink(st, w):
        pairs.append((digest(st, w), digest(st, []), len(w)))
        last[0] = st

    stream = [(batches[i], i + WINDOW, i) for i in range(WARM + TIMED + 4)]
    decodes = DecodeCalls(et)
    try:
        t0 = time.perf_counter()
        drive(cs, stream[:WARM], depth, sink=sink)
        torch.cuda.synchronize()
        log(f"{label}: {WARM} warm-up batches through ConflictSet in "
            f"{time.perf_counter() - t0:.3f} s, boundaries (bound) {eng.boundary_count_bound}")
        # The mirror at the end of the warm-up (drained, so current): phase
        # 4v starts its sets from it.
        warm_snapshot = cs._cpu.snapshot() if mode == "flat" else None
        timed, extra = stream[WARM : WARM + TIMED], stream[WARM + TIMED :]
        syncs0, allocs0, rounds0 = eng.host_syncs, eng.host_allocs, eng.fixpoint_rounds
        decodes0 = (decodes.calls, decodes.seconds)
        wall0 = m.snapshot(include_wall=True)["wall"]
        spans = DispatchSpans(torch, eng)
        settles = SettleTimes(cs._cpu)
        gc.collect()
        pauses = GcPauses()
        for name in tk.LAUNCHES:
            tk.LAUNCHES[name] = 0
        arms = SpanArms(*obs) if obs is not None else None
        t0 = time.perf_counter()
        if arms is not None:
            arms.drive(torch, cs, timed, depth, sink)
        else:
            drive(cs, timed, depth, sink=sink)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(tk.LAUNCHES)
        gc_ms = pauses.remove() / TIMED * 1e3
        settles.remove()
        major_ms, minor_ms = spans.remove()
    finally:
        decodes.remove()
    n_decodes = decodes.calls - decodes0[0]
    decode_ms = (decodes.seconds - decodes0[1]) / TIMED * 1e3
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches} in {TIMED} batches, expected {expect}")
    if eng.cpu_fallbacks != 0:
        raise AssertionError(f"{label}: cpu_fallbacks = {eng.cpu_fallbacks}")
    faults = tk.merge_contract_faults("cuda")
    if faults:
        raise AssertionError(f"{label}: the merge found {faults} order faults")
    if (eng.h_cap, eng.d_cap) != caps0:
        raise AssertionError(f"{label}: history grew from (h_cap, d_cap) {caps0} to "
                             f"{(eng.h_cap, eng.d_cap)}")
    if len(pairs) != WARM + TIMED:
        raise AssertionError(f"{label}: {len(pairs)} batches answered of {WARM + TIMED}")
    digests = [d for d, _v, _e in pairs]
    verdicts = [v for _d, v, _e in pairs]
    if witness:
        if any(n != PER_BATCH for _d, _v, n in pairs[WARM:]):
            raise AssertionError(f"{label}: a timed batch came back without its witness")
        if n_decodes != TIMED:
            raise AssertionError(f"{label}: decode_witness ran {n_decodes} times in {TIMED} "
                                 f"timed batches")
    else:
        if any(n for _d, _v, n in pairs):
            raise AssertionError(f"{label}: a witness came back with the witness off")
        if decodes.calls != 0:
            raise AssertionError(f"{label}: decode_witness ran {decodes.calls} times with the "
                                 f"witness off")
    if want is not None:
        mine, theirs = (digests, want["digests"]) if witness else (verdicts, want["verdicts"])
        if mine != theirs:
            first = next(i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b)
            raise AssertionError(f"{label}: batch {first}'s verdicts or witnesses differ from "
                                 f"the flat path's")
    counters = m.snapshot()["counters"]
    for name in ("device_faults", "breaker_opens", "degraded_batches", "cpu_fallback_txns",
                 "pipeline_replayed_batches"):
        if counters[name] != 0:
            raise AssertionError(f"{label}: {name} = {counters[name]}")
    if counters["pipeline_dispatches"] != WARM + TIMED:
        raise AssertionError(f"{label}: pipeline_dispatches {counters['pipeline_dispatches']} "
                             f"!= {WARM + TIMED} batches submitted")
    if tiered and counters["major_compactions"] != (WARM + TIMED) // EVICT_EVERY:
        raise AssertionError(f"{label}: {counters['major_compactions']} compactions in "
                             f"{WARM + TIMED} batches")
    if amortized and len(major_ms) != TIMED // EVICT_EVERY:
        raise AssertionError(f"{label}: {len(major_ms)} evicting batches in the {TIMED} timed")
    wall = m.snapshot(include_wall=True)["wall"]

    def wall_ms(name, samples):
        n = wall[name]["count"] - wall0[name]["count"]
        if n != samples:
            raise AssertionError(f"{label}: {name}: {n} samples in {TIMED} timed batches, "
                                 f"expected {samples}")
        return (wall[name]["seconds"] - wall0[name]["seconds"]) * 1e3

    apply_ms = wall_ms("mirror_apply_seconds", TIMED) / TIMED
    # The synced point moves once a fold: every batch, or every K-th one
    # with the coalesced apply (the warm-up's drain leaves no fold pending).
    synced_calls = TIMED // window
    synced_ms = wall_ms("note_synced_seconds", synced_calls) / TIMED
    if window > 1 and len(settles.folds) != synced_calls:
        raise AssertionError(f"{label}: {len(settles.folds)} folds in {TIMED} timed batches "
                             f"at window {window}")
    fold_ms = sum(t for _n, t in settles.folds) / TIMED * 1e3
    t1 = time.perf_counter()
    report = cs.mirror_check()
    check_s = time.perf_counter() - t1
    if report["status"] != "ok":
        raise AssertionError(f"{label}: mirror_check: {report}")
    n = history_sorted(torch, rq, eng)
    tps = TIMED * PER_BATCH / dt
    if tiered or amortized:
        kinds = ("compaction", "minor") if tiered else ("evicting", "keeping")
        spans_text = (f"{kinds[0]} batches {np.mean(major_ms):.3f} ms ({len(major_ms)}: "
                      f"{', '.join(f'{x:.3f}' for x in major_ms)}), {kinds[1]} batches "
                      f"{np.mean(minor_ms):.3f} ms ({len(minor_ms)}: "
                      f"{', '.join(f'{x:.3f}' for x in minor_ms)})")
    else:
        spans_text = f"{np.mean(minor_ms):.3f} ms"
    s = np.asarray(last[0])
    if not ((s >= 0) & (s <= 2)).all() or not (s == 2).any():
        raise AssertionError(f"{label}: verdicts out of range or none committed")
    stats = dict(tps=tps, ms=dt / TIMED * 1e3, apply_ms=apply_ms, synced_ms=synced_ms,
                 synced_calls=synced_calls, fold_ms=fold_ms, folds=len(settles.folds),
                 decode_ms=decode_ms, decodes=n_decodes, span_ms=float(np.mean(minor_ms)),
                 syncs=(eng.host_syncs - syncs0) / TIMED)
    log(f"{label}: {TIMED} timed batches x {PER_BATCH} txns through ConflictSet "
        f"(depth {depth}, witness {'on' if witness else 'off'}, mirror fold window {window}) "
        f"in {dt:.6f} s: {tps:.1f} txn/s, {dt / TIMED * 1e3:.3f} ms/batch; "
        f"mirror apply {apply_ms:.3f} ms/batch, note_synced {synced_ms:.3f} ms/batch "
        f"({synced_calls} calls), coalesced folds {len(settles.folds)} "
        f"({fold_ms:.3f} ms/batch), witness decode {decode_ms:.3f} ms/batch "
        f"({n_decodes} calls), "
        f"garbage collection {gc_ms:.3f} ms/batch; device span a batch: {spans_text}; "
        f"conflicts {int((s == 0).sum())}/{PER_BATCH} in the last batch, "
        f"{'base rows' if tiered else 'boundaries'} {n}, "
        f"host syncs/batch {stats['syncs']}, "
        f"host allocs in the timed batches {eng.host_allocs - allocs0} "
        f"({allocs0} before), "
        f"fixpoint rounds/batch {(eng.fixpoint_rounds - rounds0) / TIMED}, "
        f"launches {launches}, "
        f"mirror_check ok ({report['boundaries']} boundaries, "
        f"{report.get('below_window_keys', 0)} keys differing only below the window, "
        f"{check_s:.3f} s), "
        f"card {torch.cuda.get_device_name(0)}")
    if want is not None:
        what = "verdicts and witnesses" if witness else "verdicts"
        log(f"{label}: all {len(pairs)} batches' {what} equal the flat path's")
    if arms is not None:
        arms.report(torch, stats)
    packed = [(eng._pack(t), now, nov) for t, now, nov in extra]
    if mode == "flat":
        first_chunk_sweep(torch, et, eng, packed)
    if profile:
        profile_batches(torch, eng, packed, label)
    return dict(launches=launches, tps=tps, digests=digests, verdicts=verdicts, cs=cs,
                extra=extra, stats=stats, warm_snapshot=warm_snapshot)


def log_beside(label, mine, stats, other):
    """One line of PERF.md's section 5 columns for a path (its stats
    `mine`) beside another path's (stats[other])."""
    base = stats[other]
    cols = (("txn/s", "tps", "{:.1f}"), ("ms/batch", "ms", "{:.3f}"),
            ("mirror apply ms/batch", "apply_ms", "{:.3f}"),
            ("note_synced ms/batch", "synced_ms", "{:.3f}"),
            ("note_synced calls", "synced_calls", "{}"),
            ("coalesced fold ms/batch", "fold_ms", "{:.3f}"),
            ("witness decode ms/batch", "decode_ms", "{:.3f}"),
            ("witness decode calls", "decodes", "{}"),
            ("device span ms/batch", "span_ms", "{:.3f}"),
            ("host syncs/batch", "syncs", "{}"))
    log(f"{label} beside {other}: " + "; ".join(
        f"{name} {fmt.format(mine[key])} vs {fmt.format(base[key])}"
        for name, key, fmt in cols))


# Phase 4g's arms: the flat search and the 2level one at two strides.
SEARCH_ARMS = (("flat", "", 512), ("2level/512", "2level", 512),
               ("2level/1024", "2level", 1024))
SEARCH_RUNS = 5  # timed steps an arm, after its warm one, the arms taking turns


class SearchSpans:
    """CUDA events around each call of engine_torch.searchsorted_words while
    installed: in the flat kernel step these are the merge prep's two
    searches of the segment endpoints into the history.  Keeps the first
    call's arguments."""

    def __init__(self, torch, et):
        self.torch, self.et, self.real, self.spans, self.first = (
            torch, et, et.searchsorted_words, [], None)
        et.searchsorted_words = self

    def __call__(self, keys, q, side, **kw):
        if self.first is None:
            self.first = (keys, q)
        a, b = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = self.real(keys, q, side, **kw)
        b.record()
        self.spans.append((a, b))
        return out

    def take(self) -> list:
        """The spans recorded since the last take, in ms."""
        self.torch.cuda.synchronize()
        out = [a.elapsed_time(b) for a, b in self.spans]
        self.spans = []
        return out

    def remove(self):
        self.et.searchsorted_words = self.real


def search_path(torch, et, tk, rq, cs, txns, now, nov):
    """Phase 4g: the 2level search at full width.  One TorchConflictSet an
    arm of SEARCH_ARMS, each loaded from phase 4's end state (its mirror's
    snapshot) through load_from, takes one bench batch: the statuses,
    witnesses and exported state must be identical across the arms, and
    each launches both kernels once.  Then the step on that state and
    batch, SEARCH_RUNS timed runs an arm, the arms taking turns (outputs
    never assigned back): the CUDA-event span of the whole step and of the
    merge prep's two searches.  Last, searchsorted_words alone on the merge
    prep's own inputs (the history and its 2 x 65,536 segment endpoints),
    flat against 2level, bit for bit."""
    gc.collect()
    snap = cs._cpu.snapshot()
    engines, results = {}, {}
    for name, mode, stride in SEARCH_ARMS:
        t0 = time.perf_counter()
        eng = et.TorchConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, search=mode,
                                  search_stride=stride)
        eng.load_from(snap)
        torch.cuda.synchronize()
        engines[name] = (eng, time.perf_counter() - t0)
    pb = engines["flat"][0]._pack(txns)
    kw1 = KEY_WORDS + 1
    blob = torch.from_numpy(et.fill_blob(np.empty((et.blob_words(pb),), np.uint32), pb,
                                         engines["flat"][0]._base, now, nov, 1)
                            .view(np.int32).copy()).cuda()
    states = {name: (eng._hkeys, eng._hvers, eng._hcount, eng._oldest)
              for name, (eng, _t) in engines.items()}
    caps = dict(txn_cap=pb.txn_cap, rr_cap=pb.rr_cap, wr_cap=pb.wr_cap, h_cap=H_CAP, kw1=kw1)
    spans = SearchSpans(torch, et)
    step_ms = {name: [] for name in engines}
    prep_ms = {name: [] for name in engines}
    try:
        for run in range(SEARCH_RUNS + 1):
            for name, mode, stride in SEARCH_ARMS:
                torch.cuda.synchronize()
                spans.take()
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                out = et._blob_core(*states[name], blob, search=mode, search_stride=stride,
                                    **caps)
                b.record()
                b.synchronize()
                searches = spans.take()
                if len(searches) != 2:
                    raise AssertionError(f"search {name}: {len(searches)} searches in a step")
                if run:
                    step_ms[name].append(a.elapsed_time(b))
                    prep_ms[name].append(sum(searches))
                del out
        merge_keys, merge_q = spans.first
    finally:
        spans.remove()
    for name, (eng, load_s) in engines.items():
        before = dict(tk.LAUNCHES)
        st = eng.detect_packed(pb, now, nov)
        launches = {k: tk.LAUNCHES[k] - before[k] for k in before}
        if launches != {k: 1 for k in before}:
            raise AssertionError(f"search {name}: launches {launches} in one batch")
        results[name] = (st.copy(), list(eng.last_witness), eng.export_state())
    want = results["flat"]
    for name, got in results.items():
        if not (np.array_equal(got[0], want[0]) and got[1] == want[1]
                and all(np.array_equal(x, y) for x, y in zip(got[2], want[2]))):
            raise AssertionError(f"search {name}: statuses, witnesses or state differ from flat")
    if tk.merge_contract_faults("cuda"):
        raise AssertionError("search: the merge found order faults")
    for name, (eng, load_s) in engines.items():
        log(f"search {name}: load_from phase 4's snapshot ({snap.boundary_count} keys) "
            f"{load_s * 1e3:.3f} ms; step {np.median(step_ms[name]):.3f} ms CUDA-event "
            f"(median of {SEARCH_RUNS}: {', '.join(f'{x:.3f}' for x in step_ms[name])}), "
            f"merge prep's two searches {np.median(prep_ms[name]):.3f} ms "
            f"({', '.join(f'{x:.3f}' for x in prep_ms[name])}); "
            f"card {torch.cuda.get_device_name(0)}")
    log(f"search: {pb.n_txn} txns on {snap.boundary_count} rows at h_cap {H_CAP}: statuses, "
        f"witnesses and exported state identical across {[a[0] for a in SEARCH_ARMS]}, "
        f"one launch of each kernel an arm")
    alone = {}
    for side in ("left", "right"):
        want_r = rq.searchsorted_words(merge_keys, merge_q, side)
        for name, mode, stride in SEARCH_ARMS:
            got = rq.searchsorted_words(merge_keys, merge_q, side, mode=mode, stride=stride)
            if not torch.equal(got, want_r):
                raise AssertionError(f"search alone {name} {side}: ranks differ from flat")
            alone[(name, side)] = cuda_ms_warm(
                lambda: rq.searchsorted_words(merge_keys, merge_q, side, mode=mode,
                                              stride=stride), 20)
    log(f"search alone: searchsorted_words over {merge_keys.shape[1]} rows x "
        f"{merge_q.shape[1]} queries (the merge prep's), bit for bit; warm ms " + ", ".join(
            f"{name} {side} {alone[(name, side)]:.3f}" for name, _m, _s in SEARCH_ARMS
            for side in ("left", "right")) + f"; card {torch.cuda.get_device_name(0)}")
    del engines, states


# Timed runs of each attribution arm (after its warm run).  On the H100 an
# arm's span varies by up to ~10 ms from run to run (the host's enqueue
# pace), more than some phases take, so 3 runs do not resolve them.
ATTRIBUTION_REPEATS = 9

# The kernels each attribution arm launches once a run: phase 1's search
# unless the arm cuts it (nosearch), the merge unless it cuts phases 5-6
# (nomerge); the plain arms none.
ARM_LAUNCHES = {
    "full": (1, 1), "search": (0, 1), "fixpoint": (1, 1), "merge": (1, 0), "evict": (1, 1),
}


def attribution_path(torch, et, tk, pa, spans, eng, txns):
    """Phase 4a: attribute_phases on phase 4's engine (its full-width
    history) with one of phase 4's extra batches, every arm measured.  The
    full arm must equal the engine's own dispatch of that batch, the plain
    arm the kernel arm; the engine's history must be unchanged; each arm
    must launch the kernels it keeps once a run; on a fresh hub it must
    leave exactly one phase.<name> span a phase, each a child of the
    engine's last dispatch span.  Returns the kernels' launches in the
    attribution and attribution_busy's arguments."""
    gc.collect()

    def history():
        return int(eng._hcount), pa.outputs_digest((eng._hkeys, eng._hvers, eng._hcount,
                                                    eng._oldest))

    before = history()
    for name in tk.LAUNCHES:
        tk.LAUNCHES[name] = 0
    hub, saved = spans.SpanHub(), spans.global_span_hub()
    spans.set_global_span_hub(hub)
    try:
        t0 = time.perf_counter()
        rep = pa.attribute_phases(eng, txns, measure=True, repeats=ATTRIBUTION_REPEATS)
        dt = time.perf_counter() - t0
    finally:
        spans.set_global_span_hub(saved)
    launches = dict(tk.LAUNCHES)
    parent = eng.last_dispatch_span
    phase_spans = hub.spans()
    if (parent is None or parent.span_id is None
            or [sp.name for sp in phase_spans] != [f"phase.{p['phase']}" for p in rep["phases"]]
            or any(sp.parent_id != parent.span_id for sp in phase_spans)
            or [sp.attrs["ablate"] for sp in phase_spans] != [p["ablate"] for p in rep["phases"]]):
        raise AssertionError(f"attribution: phase spans {[sp.to_dict() for sp in phase_spans]} "
                             f"under dispatch span {parent.span_id}")
    if history() != before:
        raise AssertionError("attribution: the engine's history changed")
    if not rep["kernel_ab"]["identical"]:
        raise AssertionError("attribution: the plain full arm differs from the kernel arm")
    arms = dict(full=rep["full"], **{p["phase"]: p for p in rep["phases"]})
    arms.update({f"plain_{p['phase']}": p for p in rep["kernel_ab"]["plain_phases"]})
    arms["plain_full"] = rep["kernel_ab"]["plain_full"]
    for name, blk in arms.items():
        want = (0, 0) if name.startswith("plain_") else ARM_LAUNCHES[name]
        got = (blk["launches"]["phase1_ranks"], blk["launches"]["fused_merge_evict"])
        if got != want:
            raise AssertionError(f"attribution: arm {name} launched {got}, expected {want}")
    runs = 1 + rep["measured"]["repeats"]
    want_total = {"phase1_ranks": 4 * runs, "fused_merge_evict": 4 * runs}
    if launches != want_total:
        raise AssertionError(f"attribution: launches {launches}, expected {want_total}")
    faults = tk.merge_contract_faults("cuda")
    if faults:
        raise AssertionError(f"attribution: the merge found {faults} order faults")
    oldest = eng.oldest_version
    pb = eng._pack(txns)
    # The state the arms ran on, kept for attribution_busy: the engine's
    # own dispatch below moves it on.
    state = tuple(t.clone() for t in (eng._hkeys, eng._hvers, eng._hcount, eng._oldest))
    # The engine's own dispatch of the batch, at the attribution's versions.
    ticket = eng.dispatch_packed(pb, oldest + 8, oldest)
    out, tc = ticket.out, pb.txn_cap
    own = pa.outputs_digest((eng._hkeys, eng._hvers, eng._hcount, eng._oldest,
                             out[4:4 + tc], out[0], out[1], out[4 + tc:4 + 2 * tc],
                             out[4 + 2 * tc:]))
    eng.readback_packed(ticket)
    if own != rep["full"]["digest"]:
        raise AssertionError("attribution: the full arm differs from the engine's dispatch")

    m = rep["measured"]
    kab = rep["kernel_ab"]
    log(f"attribution: {len(txns)} txns (txn_cap {rep['shapes']['txn_cap']}) on phase 4's "
        f"engine, {before[0]} rows at h_cap {eng.h_cap}, {len(arms)} arms x {runs} runs in "
        f"{dt:.3f} s; full arm == the engine's dispatch, plain == kernel arm, history "
        f"unchanged, launches {launches}; card {torch.cuda.get_device_name(0)}")
    log(f"attribution spans: {[sp.name for sp in phase_spans]}, one a phase, each a child of "
        f"the engine's last dispatch span (id {parent.span_id}); attrs "
        f"{[sp.attrs for sp in phase_spans]}")
    for name, blk in arms.items():
        lo, hi = m["arm_device_ms_range"][name]
        log(f"attribution arm {name} (ablate {blk['ablate']}): CUDA-event "
            f"{m['arm_device_ms'][name]:.3f} ms (median of {runs - 1}, range {lo:.3f}-{hi:.3f}), "
            f"host {m['arm_wall_seconds'][name] * 1e3:.3f} ms, fixpoint host checks "
            f"{blk['host_checks']}, launches {blk['launches']}")
    full_ms = m["full_device_ms"]
    for ph, ms in m["phase_device_ms"].items():
        kp = kab["measured_phase_device_ms"][ph]
        log(f"attribution phase {ph}: {ms:.3f} ms CUDA-event ({ms / full_ms:.4f} of the "
            f"full {full_ms:.3f}), host {m['phase_wall_seconds'][ph] * 1e3:.3f} ms; kernels "
            f"{kp['kernels']:.3f} ms against plain {kp['plain']:.3f} ms")
    kf = kab["measured_full_device_ms"]
    log(f"attribution full step: kernels {kf['kernels']:.3f} ms against plain "
        f"{kf['plain']:.3f} ms CUDA-event; host "
        f"{kab['measured_full_wall_seconds']['kernels'] * 1e3:.3f} against "
        f"{kab['measured_full_wall_seconds']['plain'] * 1e3:.3f} ms")
    blob = np.empty((et.blob_words(pb),), np.uint32)
    et.fill_blob(blob, pb, eng._base, oldest + 8, oldest, 1)
    caps = dict(txn_cap=pb.txn_cap, rr_cap=pb.rr_cap, wr_cap=pb.wr_cap, h_cap=eng.h_cap,
                kw1=eng.key_words + 1)
    busy = (state, torch.from_numpy(blob.view(np.int32)).cuda(), caps, rep, arms)
    return launches, busy


def attribution_busy(torch, et, pa, state, blob, caps, rep, arms):
    """Phase 4a's device busy time, run last: every arm once more under
    torch.profiler on the state phase 4a attributed (the profiler slows
    the host's launches for the rest of the process, so no timed phase may
    follow it).  Splits each phase's CUDA-event ms into device work and
    the device's idle while the host enqueues the phase (for the fixpoint,
    also its host checks)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    busy = {}
    for name, blk in arms.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            et._blob_core(*state, blob, ablate=frozenset(blk["ablate"]), **caps)
            torch.cuda.synchronize()
        busy[name] = sum(e.self_device_time_total for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA) / 1e3
    m = rep["measured"]
    phase, plain = pa.split_phases(busy), pa.split_phases(busy, "plain_")
    log("attribution busy (torch.profiler, one run an arm): "
        + ", ".join(f"{name} {ms:.3f} ms" for name, ms in busy.items()))
    for ph, ms in m["phase_device_ms"].items():
        log(f"attribution busy phase {ph}: {ms:.3f} ms CUDA-event, of it device busy "
            f"{phase[ph]:.3f} ms and idle {max(0.0, ms - phase[ph]):.3f} ms; plain step's "
            f"busy {plain[ph]:.3f} ms")
    full = m["full_device_ms"]
    log(f"attribution busy full step: {busy['full']:.3f} ms of {full:.3f} ms CUDA-event "
        f"(idle share {1 - busy['full'] / full:.4f}), plain {busy['plain_full']:.3f} ms of "
        f"{m['arm_device_ms']['plain_full']:.3f}; not in any phase (phases 2-4's sort and "
        f"stabbings, the witness): {busy['full'] - sum(phase.values()):.3f} ms busy; the "
        f"fixpoint's {rep['full']['host_checks']} host check(s) sit in its idle")


def first_chunk_sweep(torch, et, eng, batches):
    """The fixpoint's first chunk — the rounds it runs before its first
    host check: 1, 2 or FIXPOINT_CHUNK — on main-path batches, each step
    run from the same carried state: the host checks and the device span
    (CUDA events around the step) a batch for each, and outputs (state,
    verdicts, iters, witnesses) equal across the choices."""
    default = et.FIXPOINT_FIRST_CHUNK
    kw1 = eng.key_words + 1
    state = (eng._hkeys, eng._hvers, eng._hcount, eng._oldest)
    blobs = []
    for pb, now, nov in batches:
        blob = eng._pack_blob(pb, now, nov)
        blobs.append((pb, torch.from_numpy(blob.view(np.int32).copy()).cuda()))
    first_out = []
    try:
        for first in (1, 2, et.FIXPOINT_CHUNK):
            et.FIXPOINT_FIRST_CHUNK = first
            checks, spans, rounds = [0], [], 0

            def on_sync():
                checks[0] += 1
                return contextlib.nullcontext()

            for j, (pb, blob) in enumerate(blobs):
                torch.cuda.synchronize()
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                out = et._blob_core(*state, blob, txn_cap=pb.txn_cap, rr_cap=pb.rr_cap,
                                    wr_cap=pb.wr_cap, h_cap=eng.h_cap, kw1=kw1,
                                    on_sync=on_sync)
                b.record()
                b.synchronize()
                spans.append(a.elapsed_time(b))
                rounds += int(out[6]) - 2
                if len(first_out) <= j:
                    first_out.append(out)
                elif not all(torch.equal(x, y) for x, y in zip(out, first_out[j])):
                    raise AssertionError(f"first chunk {first}: batch {j}'s outputs differ")
            n = len(blobs)
            log(f"fixpoint first chunk {first}{' (default)' if first == default else ''}: "
                f"{checks[0] / n} host checks/batch, device span {np.mean(spans):.3f} ms/batch "
                f"(each: {', '.join(f'{x:.3f}' for x in spans)}), fixpoint rounds/batch "
                f"{rounds / n}, over {n} main-path batches from one state")
    finally:
        et.FIXPOINT_FIRST_CHUNK = default


def profile_batches(torch, cs, batches, label):
    """Where a main-path batch's time goes: a host-clock split of two
    batches (pack alone; dispatch = pack + upload + step enqueue + the
    fixpoint's host checks; device drain; readback = verdicts + witness
    decode), then torch.profiler over two more for device time by kernel
    and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    half = len(batches) // 2
    for pb, now, nov in batches[:half]:
        t0 = time.perf_counter()
        cs._pack_blob(pb, now, nov)
        t1 = time.perf_counter()
        ticket = cs.dispatch_packed(pb, now=now, new_oldest_version=nov)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        cs.readback_packed(ticket)
        t4 = time.perf_counter()
        log(f"{label} split batch {nov}: pack {1e3 * (t1 - t0):.3f} ms, dispatch "
            f"{1e3 * (t2 - t1):.3f} ms, device drain {1e3 * (t3 - t2):.3f} ms, "
            f"readback+witness decode {1e3 * (t4 - t3):.3f} ms")
    def majors():
        c = cs.metrics.counters.get("major_compactions")
        return c.value if c is not None else 0

    # One profile a batch, so a compaction batch shows apart.
    for pb, now, nov in batches[half:]:
        majors0 = majors()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cs.detect_packed(pb, now=now, new_oldest_version=nov)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        # Device-side events only: an aten op's own row repeats its kernels' time.
        busy_us = sum(e.self_device_time_total for e in events
                      if e.device_type == DeviceType.CUDA)
        log(f"{label} profile batch {nov}{' (compaction)' if majors() > majors0 else ''}: "
            f"wall {wall_ms:.3f} ms under the profiler, device busy {busy_us / 1e3:.3f} ms, "
            f"idle share {1 - busy_us / 1e3 / wall_ms:.4f}")
        # The hand-written kernels as the main path runs them, beside phase
        # 3's cold and warm times (whether the main path finds the history
        # in L2).
        ours = ("phase1_ranks_kernel", "merge_index_kernel", "merge_tiles_kernel")
        for e in events:
            if e.device_type == DeviceType.CUDA and any(k in e.key for k in ours):
                log(f"{label} profile kernel {e.key}: {e.count} launches, "
                    f"{e.self_device_time_total / max(e.count, 1) / 1e3:.6f} ms each")
    log(events.table(sort_by="self_device_time_total", row_limit=40))


def versus_cpu(torch, et):
    n_txn, h_cap, batches, window = 4096, 1 << 16, 12, 4
    rng = np.random.default_rng(7)
    stream = [gen_packed(et, rng, n_txn, i, keyspace=200_000) for i in range(batches)]
    gpu = et.TorchConflictSet(key_words=KEY_WORDS, h_cap=h_cap)
    cpu = et.TorchConflictSet(key_words=KEY_WORDS, h_cap=h_cap, device="cpu")
    conflicts = 0
    for i, pb in enumerate(stream):
        g = gpu.detect_packed(pb, now=i + window, new_oldest_version=i)
        c = cpu.detect_packed(pb, now=i + window, new_oldest_version=i)
        if not (g == c).all():
            raise AssertionError(f"batch {i}: GPU and CPU verdicts differ")
        if gpu.last_witness != cpu.last_witness or gpu.last_iters != cpu.last_iters:
            raise AssertionError(f"batch {i}: GPU and CPU witness/iters differ")
        for a, b in zip(gpu.export_state(), cpu.export_state()):
            if not np.array_equal(a, b):
                raise AssertionError(f"batch {i}: GPU and CPU exported state differ")
        conflicts += int((g[:n_txn] == 0).sum())
    if conflicts == 0:
        raise AssertionError("reduced stream produced no conflicts")
    log(f"vs cpu: {batches} batches x {n_txn} txns identical on GPU and CPU "
        f"(verdicts, witnesses, iters, keys/vers/count/oldest/base); "
        f"{conflicts} conflicts, boundaries {gpu.boundary_count}, "
        f"grows {gpu.grows}, cpu_fallbacks {gpu.cpu_fallbacks}")


# What torch's CUDA check appends to its "CUDA error: <string>" line.
TORCH_CUDA_SUFFIX = ("\nCUDA kernel errors might be asynchronously reported at some other "
                     "API call, so the stacktrace below might be incorrect.\nFor debugging "
                     "consider passing CUDA_LAUNCH_BLOCKING=1\n")


def lost_card_codes(torch):
    """Phase 6l: the lost-card classifier (device.is_lost_device) over every
    cudaError_t code from 0 to 999 that the card's runtime names (its
    string differs from an unassigned code's), each as the three errors
    the port can see: the kernel launcher's CudaError, and a
    torch.AcceleratorError with torch's message for the code, with its
    error_code set and without one.  Exactly device.LOST_DEVICE_CODES must
    classify in each form, and the runtime's names of those codes must be
    the table's.  Returns {code: (name, string)} of the four and the
    count of named codes."""
    from foundationdb_tpu_torch import device

    t0 = time.perf_counter()
    unassigned = device.cuda_error_string(1_000_000)
    if unassigned is None:
        raise AssertionError("lost card: the card's runtime gives no error strings")
    named = {c: device.cuda_error_string(c) for c in range(1000)}
    named = {c: text for c, text in named.items() if text != unassigned}
    forms = {}
    for form in ("launcher CudaError", "AcceleratorError with error_code",
                 "AcceleratorError, its message alone"):
        lost = []
        for c, text in sorted(named.items()):
            if form.startswith("launcher"):
                e = device.CudaError(f"phase1_ranks: CUDA error {c} at launch", c)
            else:
                e = torch.AcceleratorError(f"CUDA error: {text}{TORCH_CUDA_SUFFIX}")
                if form.endswith("error_code"):
                    e.error_code = c
            if device.is_lost_device(e):
                lost.append(c)
        forms[form] = lost
    want = sorted(device.LOST_DEVICE_CODES)
    if any(lost != want for lost in forms.values()):
        raise AssertionError(f"lost card: classified {forms}, want {want}")
    names = {c: device.cuda_error_name(c) for c in want}
    if None not in names.values() and names != device.LOST_DEVICE_CODES:
        raise AssertionError(f"lost card: the runtime names {names}")
    dt = time.perf_counter() - t0
    four = {c: (names[c], named[c]) for c in want}
    log(f"lost card: {len(named)} of the cudaError_t codes 0-999 named by the card's runtime "
        f"(unassigned: {unassigned!r}); exactly {want} classify as a lost card in each form "
        f"({', '.join(forms)}): "
        + "; ".join(f"{c} {n or 'name not read'} {t!r}" for c, (n, t) in four.items())
        + f"; {dt * 1e3:.3f} ms; card {torch.cuda.get_device_name(0)}")
    return {"named": len(named), "lost": four}


def conflictset_vs_cpu(torch, api, T, faults):
    """ConflictSet on the GPU against ConflictSet(backend="cpu") on the
    reduced stream, at depths 1-3 and under a scripted fault plan."""
    n_txn, batches, window = 4096, 12, 4
    rng = np.random.default_rng(7)
    stream = [(gen_txns(T, rng, n_txn, i, keyspace=200_000), i + window, i)
              for i in range(batches)]
    want = drive(api.ConflictSet(backend="cpu", key_words=KEY_WORDS), stream, 1)
    conflicts = sum(int((np.asarray(st) == 0).sum()) for st, _w in want)
    if conflicts == 0:
        raise AssertionError("reduced stream produced no conflicts")
    for depth in (1, 2, 3):
        cs = api.ConflictSet(key_words=KEY_WORDS, h_cap=1 << 16, pipeline_depth=depth)
        if drive(cs, stream, depth) != want:
            raise AssertionError(f"ConflictSet depth {depth}: GPU verdicts/witnesses differ from CPU")
        if cs.mirror_check()["status"] != "ok":
            raise AssertionError(f"ConflictSet depth {depth}: mirror_check failed")
    runs = {}
    for device in ("cuda", "cpu"):
        inj = faults.DeviceFaultInjector()
        for at in (1, 2, 3):
            inj.script("dispatch", at=at)
        inj.script("grow", at=1)
        # 16,384 rows are too few for the mirror the first probe loads, so
        # its rehydration must grow them: the scripted `grow` fault and the
        # breaker walk below check that it did.
        cs = api.ConflictSet(key_words=KEY_WORDS, h_cap=1 << 14, device=device,
                             fault_injector=inj)
        if drive(cs, stream, 2) != want:
            raise AssertionError(f"fault run on {device}: verdicts/witnesses differ from CPU")
        dm = cs.device_metrics()
        walk = [(f, t, r.split(":")[0]) for _s, f, t, r in dm["breaker"]["transitions"]]
        if walk != [("ok", "degraded", "threshold"), ("degraded", "probing", "backoff_elapsed"),
                    ("probing", "degraded", "probe_failed"),
                    ("degraded", "probing", "backoff_elapsed"),
                    ("probing", "ok", "probe_success")]:
            raise AssertionError(f"fault run on {device}: breaker walk {walk}")
        if [site for _seq, site, _kind in inj.injected] != ["dispatch"] * 3 + ["grow"]:
            raise AssertionError(f"fault run on {device}: injected {inj.injected}")
        c = dm["counters"]
        if c["rehydrates"] < 1 or c["rehydrate_keys_total"] <= 1 or c["faults_grow"] != 1:
            raise AssertionError(f"fault run on {device}: counters {c}")
        if cs.mirror_check()["status"] != "ok":
            raise AssertionError(f"fault run on {device}: mirror_check failed")
        runs[device] = (inj.injected, dm["breaker"]["transitions"], c)
    if runs["cuda"][:2] != runs["cpu"][:2]:
        raise AssertionError(f"fault logs differ: cuda {runs['cuda'][:2]} cpu {runs['cpu'][:2]}")
    c = runs["cuda"][2]
    log(f"set vs cpu: {batches} batches x {n_txn} txns through ConflictSet on the GPU at "
        f"depths 1, 2, 3 identical to ConflictSet(backend='cpu') ({conflicts} conflicts); "
        f"fault script: injected {runs['cuda'][0]}, transitions "
        f"{[t[1:] for t in runs['cuda'][1]]}, equal on cuda and cpu; rehydrates "
        f"{c['rehydrates']}, rehydrate keys {c['rehydrate_keys_encoded']} encoded of "
        f"{c['rehydrate_keys_total']}, grows {c['grows']}")


def tiered_conflictset_vs_cpu(torch, api, T, faults):
    """ConflictSet(history="tiered") on the GPU against ConflictSet(
    backend="cpu") on the reduced stream, 18 batches long: compactions
    every third batch and an 8,192-row delta that the first batch grows,
    at depths 1-3; then dispatch faults 3-6 (batch 3 is a compaction batch;
    the fourth fault takes the first probe; the recovered engine compacts
    again), whose injected log and breaker walk must equal the same
    script's run with device="cpu"."""
    n_txn, batches, window = 4096, 18, 4
    rng = np.random.default_rng(7)
    stream = [(gen_txns(T, rng, n_txn, i, keyspace=200_000), i + window, i)
              for i in range(batches)]
    want = drive(api.ConflictSet(backend="cpu", key_words=KEY_WORDS), stream, 1)
    tiers = dict(history="tiered", evict_every=3, delta_cap=8192)
    for depth in (1, 2, 3):
        cs = api.ConflictSet(key_words=KEY_WORDS, h_cap=1 << 16, pipeline_depth=depth, **tiers)
        if drive(cs, stream, depth) != want:
            raise AssertionError(f"tiered ConflictSet depth {depth}: GPU verdicts/witnesses "
                                 f"differ from CPU")
        c = cs.device_metrics()["counters"]
        if c["major_compactions"] < batches // 3 or cs._dev.d_cap <= 8192 or c["grows"] < 1:
            raise AssertionError(f"tiered ConflictSet depth {depth}: compactions "
                                 f"{c['major_compactions']}, d_cap {cs._dev.d_cap}, "
                                 f"grows {c['grows']}")
        if cs.mirror_check()["status"] != "ok":
            raise AssertionError(f"tiered ConflictSet depth {depth}: mirror_check failed")
    runs = {}
    for device in ("cuda", "cpu"):
        inj = faults.DeviceFaultInjector()
        for at in (3, 4, 5, 6):
            inj.script("dispatch", at=at)
        cs = api.ConflictSet(key_words=KEY_WORDS, h_cap=1 << 16, device=device,
                             fault_injector=inj, **tiers)
        if drive(cs, stream, 2) != want:
            raise AssertionError(f"tiered fault run on {device}: verdicts/witnesses differ "
                                 f"from CPU")
        dm = cs.device_metrics()
        walk = [(f, t) for _s, f, t, _r in dm["breaker"]["transitions"]]
        if walk != [("ok", "degraded"), ("degraded", "probing"), ("probing", "degraded"),
                    ("degraded", "probing"), ("probing", "ok")]:
            raise AssertionError(f"tiered fault run on {device}: breaker walk {walk}")
        if [site for _seq, site, _kind in inj.injected] != ["dispatch"] * 4:
            raise AssertionError(f"tiered fault run on {device}: injected {inj.injected}")
        if cs.mirror_check()["status"] != "ok":
            raise AssertionError(f"tiered fault run on {device}: mirror_check failed")
        if dm["counters"]["major_compactions"] < 1:
            raise AssertionError(f"tiered fault run on {device}: no compaction after recovery")
        runs[device] = (inj.injected, dm["breaker"]["transitions"], dm["counters"], dm["tiers"])
    if runs["cuda"][:2] != runs["cpu"][:2] or runs["cuda"][3] != runs["cpu"][3]:
        raise AssertionError(f"tiered fault logs differ: cuda {runs['cuda'][:2]} "
                             f"cpu {runs['cpu'][:2]}")
    c = runs["cuda"][2]
    log(f"tiered set vs cpu: {batches} batches x {n_txn} txns through ConflictSet("
        f"history='tiered', evict_every=3, delta_cap=8192) on the GPU at depths 1, 2, 3 "
        f"identical to ConflictSet(backend='cpu'); fault script: injected "
        f"{runs['cuda'][0]}, transitions {[t[1:] for t in runs['cuda'][1]]}, equal on cuda "
        f"and cpu; compactions {c['major_compactions']}, grows {c['grows']}, rehydrates "
        f"{c['rehydrates']}, tiers {runs['cuda'][3]}")


def program_table(torch, et):
    """Phase 2c: the device program cost table on the card: every
    registered program at its canonical shapes on a valid empty history,
    with the bytes it allocates above its arguments and outputs."""
    t0 = time.perf_counter()
    table = et.program_cost_table(include_wall=True)
    dt = time.perf_counter() - t0
    hist = table.pop("_run_wall")
    if set(table) != set(et.DEVICE_ENTRY_POINTS):
        raise AssertionError(f"programs: table {sorted(table)} != registry "
                             f"{sorted(et.DEVICE_ENTRY_POINTS)}")
    for name, blk in table.items():
        if "error" in blk or "temp" not in blk.get("memory", {}):
            raise AssertionError(f"programs: {name}: {blk}")
        wall = blk.pop("run_wall_seconds")
        log(f"program {name}: temp {blk['memory']['temp']} B, run {wall * 1e3:.3f} ms, "
            f"block {json.dumps(blk, sort_keys=True)}")
    log(f"programs: {len(table)} entries in {dt:.3f} s, run wall {hist}; card "
        f"{torch.cuda.get_device_name(0)}")


def ablation_vs_cpu(torch, api, et, pa, T, faults):
    """Phase 6e: at phase 6's reduced shape, every attribution arm's outputs
    (their digests) equal on cuda and cpu from one engine state; then a
    ConflictSet with amortized eviction (evict_every=3) under phase 6's
    fault script (dispatch faults 1-3, a grow fault at the first probe)
    on cuda and cpu: verdicts and witnesses equal each other's and
    ConflictSet(backend="cpu")'s, and the injected log, breaker walk,
    counters and exported state equal."""
    n_txn, batches, window, keyspace = 4096, 12, 4, 200_000
    rng = np.random.default_rng(7)
    stream = [(gen_txns(T, rng, n_txn, i, keyspace=keyspace), i + window, i)
              for i in range(batches)]
    reports = {}
    for device in ("cuda", "cpu"):
        eng = et.TorchConflictSet(key_words=KEY_WORDS, h_cap=1 << 16, device=device)
        for txns, now, nov in stream[:-1]:
            eng.detect(txns, now, nov)
        reports[device] = pa.attribute_phases(eng, stream[-1][0])
    arms = {}
    for device, rep in reports.items():
        blocks = [rep["full"], rep["kernel_ab"]["plain_full"], *rep["phases"],
                  *rep["kernel_ab"]["plain_phases"]]
        arms[device] = {(tuple(b["ablate"]), b["host_checks"]): b["digest"] for b in blocks}
    if arms["cuda"] != arms["cpu"]:
        diff = [a for a in arms["cuda"] if arms["cuda"][a] != arms["cpu"].get(a)]
        raise AssertionError(f"ablation arms differ on cuda and cpu: {diff}")
    if not reports["cuda"]["kernel_ab"]["identical"]:
        raise AssertionError("ablation arms: the plain full arm differs from the kernel arm")
    want = drive(api.ConflictSet(backend="cpu", key_words=KEY_WORDS), stream, 1)
    runs = {}
    for device in ("cuda", "cpu"):
        inj = faults.DeviceFaultInjector()
        for at in (1, 2, 3):
            inj.script("dispatch", at=at)
        inj.script("grow", at=1)
        cs = api.ConflictSet(key_words=KEY_WORDS, h_cap=1 << 14, device=device,
                             fault_injector=inj, evict_every=3)
        if drive(cs, stream, 2) != want:
            raise AssertionError(f"amortized fault run on {device}: verdicts/witnesses differ "
                                 f"from the CPU backend's")
        dm = cs.device_metrics()
        report = cs.mirror_check()
        if report["status"] != "ok":
            raise AssertionError(f"amortized fault run on {device}: mirror_check {report}")
        counters = dict(dm["counters"])
        counters.pop("host_allocs")  # the pinned readback buffers, CUDA only
        runs[device] = (inj.injected, dm["breaker"]["transitions"], counters,
                        cs._dev.export_state(), report["below_window_keys"])
    a, b = runs["cuda"], runs["cpu"]
    same = [a[0] == b[0], a[1] == b[1], a[2] == b[2],
            all(np.array_equal(x, y) for x, y in zip(a[3], b[3])), a[4] == b[4]]
    if not all(same):
        raise AssertionError(f"amortized fault runs differ on cuda and cpu: {same}")
    walk = [(f, t) for _s, f, t, _r in a[1]]
    log(f"ablation vs cpu: {len(arms['cuda'])} attribution arms at {n_txn} txns equal on cuda "
        f"and cpu (digests of state, verdicts, iters, witnesses), plain == kernel; amortized "
        f"ConflictSet(evict_every=3) under dispatch faults 1-3 and a grow fault: verdicts and "
        f"witnesses equal ConflictSet(backend='cpu'), injected {a[0]}, walk {walk}, counters, "
        f"exported state and below_window_keys {a[4]} equal on cuda and cpu; grows "
        f"{a[2]['grows']}, rehydrates {a[2]['rehydrates']}")


def settings_vs_cpu(torch, api, et, sr, tk, T, keylib):
    """Phase 6w: this slice's settings at a reduced shape, each run on cuda
    and on cpu with every batch's verdicts and witnesses digested: the
    witness-free step (TorchConflictSet flat and tiered, 4 shards flat and
    tiered; last_witness always []), ConflictSet(mirror_coalesce=2 and
    "auto") at depths 1-3 (also equal to ConflictSet(backend="cpu"), with
    as many note_synced calls on both devices), and search="2level" at
    h_cap 1 << 16, the 2level form's least width (TorchConflictSet flat
    and tiered, 4 shards flat and tiered; also equal to the flat search).
    Exported state equal on both devices; the cuda runs launch the
    kernels."""
    n_txn, batches, window, keyspace = 2048, 8, 4, 200_000
    rng = np.random.default_rng(11)
    stream = [(gen_txns(T, rng, n_txn, i, keyspace=keyspace), i + window, i)
              for i in range(batches)]
    split = keylib.uniform_int_split_keys(4, keyspace, KEY_BYTES)
    tiers = dict(history="tiered", evict_every=3, delta_cap=8192)

    def run(make, witness_free=False):
        """Digests of every batch on cuda and cpu, the final exported state
        of each, and the cuda run's kernel launches."""
        out = {}
        for device in ("cuda", "cpu"):
            eng = make(device)
            before = dict(tk.LAUNCHES)
            digests = []
            for txns, now, nov in stream:
                st = eng.detect(txns, now, nov)
                if witness_free and eng.last_witness != []:
                    raise AssertionError("settings: a witness came back with the witness off")
                digests.append(digest(st, eng.last_witness))
            state = (eng._host_state() if hasattr(eng, "_device_shard_state")
                     else eng.export_state())
            out[device] = (digests, state, {k: tk.LAUNCHES[k] - before[k] for k in before})
        (d_g, s_g, l_g), (d_c, s_c, _l) = out["cuda"], out["cpu"]
        same_state = all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(s_g, s_c))
        if d_g != d_c or not same_state:
            raise AssertionError("settings: cuda and cpu differ "
                                 f"({'verdicts or witnesses' if d_g != d_c else 'state'})")
        if min(l_g.values()) < 1:
            raise AssertionError(f"settings: the cuda run launched {l_g}")
        return d_g

    lines = []
    for label, kw in (("flat", {}), ("tiered", tiers)):
        run(lambda dev: et.TorchConflictSet(key_words=KEY_WORDS, h_cap=1 << 14, device=dev,
                                            witness=False, **kw), witness_free=True)
        run(lambda dev: sr.ShardedTorchConflictSet(split, key_words=KEY_WORDS, h_cap=1 << 12,
                                                   device=dev, witness=False, **kw),
            witness_free=True)
        flat = run(lambda dev: et.TorchConflictSet(key_words=KEY_WORDS, h_cap=1 << 16,
                                                   device=dev, **kw))
        two = run(lambda dev: et.TorchConflictSet(key_words=KEY_WORDS, h_cap=1 << 16,
                                                  device=dev, search="2level", **kw))
        if two != flat:
            raise AssertionError(f"settings: 2level {label} differs from the flat search")
        shard_flat = run(lambda dev: sr.ShardedTorchConflictSet(
            split, key_words=KEY_WORDS, h_cap=1 << 16, device=dev, **kw))
        shard_two = run(lambda dev: sr.ShardedTorchConflictSet(
            split, key_words=KEY_WORDS, h_cap=1 << 16, device=dev, search="2level",
            search_stride=1024, **kw))
        if shard_two != shard_flat:
            raise AssertionError(f"settings: 2level sharded {label} differs from the flat search")
        lines.append(f"{label}: witness-free engine and 4 shards, 2level engine and 4 shards")
    want = drive(api.ConflictSet(backend="cpu", key_words=KEY_WORDS), stream, 1)
    for coalesce in (2, "auto"):
        for depth in (1, 2, 3):
            synced = {}
            for device in ("cuda", "cpu"):
                cs = api.ConflictSet(key_words=KEY_WORDS, h_cap=1 << 16, device=device,
                                     pipeline_depth=depth, mirror_coalesce=coalesce)
                if drive(cs, stream, depth) != want:
                    raise AssertionError(f"settings: coalesce {coalesce} depth {depth} on "
                                         f"{device}: verdicts/witnesses differ from the CPU "
                                         f"backend's")
                if cs.mirror_check()["status"] != "ok":
                    raise AssertionError(f"settings: coalesce {coalesce} depth {depth} on "
                                         f"{device}: mirror_check failed")
                wall = cs._dev.metrics.snapshot(include_wall=True)["wall"]
                synced[device] = (wall["note_synced_seconds"]["count"],
                                  cs._dev.export_state())
            (n_g, s_g), (n_c, s_c) = synced["cuda"], synced["cpu"]
            if n_g != n_c or not all(np.array_equal(x, y) for x, y in zip(s_g, s_c)):
                raise AssertionError(f"settings: coalesce {coalesce} depth {depth}: note_synced "
                                     f"calls {n_g} / {n_c} or state differ on cuda and cpu")
            lines.append(f"coalesce {coalesce} depth {depth}: {n_g} note_synced calls")
    log(f"settings vs cpu: {batches} batches x {n_txn} txns identical on cuda and cpu "
        f"(verdict and witness digests, exported state): {'; '.join(lines)}")


# ---------------------------------------------------------------------------
# phases 4s and 6s: the sharded resolver
# ---------------------------------------------------------------------------


class ShardSpans:
    """CUDA events around each half step of each shard: the decide half
    (phases 1-4, with the fixpoint's host checks inside it) and the commit
    half (phases 5-6).  A batch calls every shard's decide, then every
    active shard's commit, each in shard order."""

    def __init__(self, torch, et):
        self.torch, self.et = torch, et
        self.real = {name: getattr(et, name) for name in ("decide_flat", "commit_flat")}
        self.calls = {name: [] for name in self.real}
        for name, fn in self.real.items():
            setattr(et, name, self._timed(name, fn))

    def _timed(self, name, fn):
        def call(*args, **kw):
            a, b = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = fn(*args, **kw)
            b.record()
            self.calls[name].append((a, b))
            return out
        return call

    def remove(self, batches, shards):
        """Stop timing; returns (mean span per shard, mean batch span) in
        ms: a shard's span is its decide plus its commit, a batch's runs
        from shard 0's decide to the last commit."""
        for name, fn in self.real.items():
            setattr(self.et, name, fn)
        self.torch.cuda.synchronize()
        dec, com = self.calls["decide_flat"], self.calls["commit_flat"]
        if len(dec) != batches * shards or len(com) != batches * shards:
            raise AssertionError(f"sharded: {len(dec)} decide and {len(com)} commit calls in "
                                 f"{batches} batches of {shards} shards")
        per_shard = [np.mean([dec[i * shards + s][0].elapsed_time(dec[i * shards + s][1])
                              + com[i * shards + s][0].elapsed_time(com[i * shards + s][1])
                              for i in range(batches)]) for s in range(shards)]
        batch = np.mean([dec[i * shards][0].elapsed_time(com[(i + 1) * shards - 1][1])
                         for i in range(batches)])
        return per_shard, batch


def sharded_path(torch, sr, tk, et, keylib, obs):
    """Phase 4s: the bench stream through ShardedTorchConflictSet(detect_packed)
    at the multichip arm's shape, 8 shards on the one card (room for 16, the
    scale-up of phase 4r), on fresh port hubs (`obs`: the spans, trace and
    flight_recorder modules): one device and one apply span a batch, no
    rehydrate span (the slices start in step with their empty mirrors), no
    trace event, no capture.  Returns the launches of
    the timed batches, the set and the stream's generator, which phase 4r
    continues."""
    gc.collect()
    hubs = PortHubs(*obs)
    rng = np.random.default_rng(2026)
    split = keylib.uniform_int_split_keys(SHARDS, KEYSPACE, KEY_BYTES)
    cs = sr.ShardedTorchConflictSet(split, key_words=KEY_WORDS, h_cap=SHARD_H_CAP,
                                    max_shards=2 * SHARDS)
    if SHARD_H_CAP != et._next_pow2(H_CAP // SHARDS + 4 * PER_BATCH, 8):
        raise AssertionError("SHARD_H_CAP is not the multichip arm's shard history")
    m = cs.metrics
    t0 = time.perf_counter()
    for i in range(SHARD_WARM):
        cs.detect_packed(gen_packed(et, rng, PER_BATCH, i), i + WINDOW, i)
    torch.cuda.synchronize()
    log(f"sharded: {SHARD_WARM} warm-up batches through ShardedTorchConflictSet ({SHARDS} "
        f"shards) in {time.perf_counter() - t0:.3f} s, boundaries {cs.shard_occupancy()}")
    timed = [(gen_packed(et, rng, PER_BATCH, i), i + WINDOW, i)
             for i in range(SHARD_WARM, SHARD_WARM + TIMED)]
    syncs0 = cs.host_syncs
    wall0 = m.snapshot(include_wall=True)["wall"]
    gc.collect()
    spans = ShardSpans(torch, et)
    for name in tk.LAUNCHES:
        tk.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    for pb, now, nov in timed:
        statuses = cs.detect_packed(pb, now, nov)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(tk.LAUNCHES)
    shard_ms, batch_ms = spans.remove(TIMED, SHARDS)
    expect = {name: SHARDS * TIMED for name in tk.LAUNCHES}
    if launches != expect:
        raise AssertionError(f"sharded: launches {launches} in {TIMED} batches, expected {expect}")
    counters = m.snapshot()["counters"]
    for name in ("cpu_fallbacks", "cpu_fallback_txns", "degraded_shard_serves", "grows"):
        if counters[name] != 0:
            raise AssertionError(f"sharded: {name} = {counters[name]}")
    if counters["device_batches"] != SHARD_WARM + TIMED:
        raise AssertionError(f"sharded: {counters['device_batches']} device batches")
    if cs.backend_signal()["shards_degraded"] != 0 or cs.h_cap != SHARD_H_CAP:
        raise AssertionError(f"sharded: {cs.backend_signal()}, h_cap {cs.h_cap}")
    faults = tk.merge_contract_faults("cuda")
    if faults:
        raise AssertionError(f"sharded: the merge found {faults} order faults")
    s = np.asarray(statuses[:PER_BATCH])
    if not ((s >= 0) & (s <= 2)).all() or not (s == 2).any() or not (s == 0).any():
        raise AssertionError("sharded: verdicts out of range, or none committed or conflicting")
    if len(cs.last_witness) != PER_BATCH:
        raise AssertionError("sharded: no witness for the last batch")
    wall = m.snapshot(include_wall=True)["wall"]

    def per_batch_ms(name):
        n = wall[name]["count"] - wall0[name]["count"]
        if n != TIMED:
            raise AssertionError(f"sharded: {name}: {n} samples in {TIMED} timed batches")
        return (wall[name]["seconds"] - wall0[name]["seconds"]) / n * 1e3

    t1 = time.perf_counter()
    report = cs.mirror_check()
    check_s = time.perf_counter() - t1
    if report["status"] != "ok" or any(r["status"] != "ok" for r in report["shards"].values()):
        raise AssertionError(f"sharded: mirror_check: {report}")
    hubs.restore()
    hub = hubs.hub
    reh = hub.spans(name="rehydrate")
    dev, app = hub.spans(name="device"), hub.spans(name="apply")
    if (reh or len(dev) != SHARD_WARM + TIMED or len(app) != SHARD_WARM + TIMED
            or any(set(sp.attrs) != {"version"} for sp in dev)
            or hubs.col.events or hubs.rec.captures):
        raise AssertionError(f"sharded: spans rehydrate {[sp.attrs for sp in reh]}, device "
                             f"{len(dev)}, apply {len(app)}; events {hubs.col.events}, "
                             f"captures {len(hubs.rec.captures)}")
    dev_ms = [(sp.wall_end - sp.wall_start) * 1e3 for sp in dev[-TIMED:]]
    app_ms = [(sp.wall_end - sp.wall_start) * 1e3 for sp in app[-TIMED:]]
    log(f"sharded spans: device {len(dev)} and apply {len(app)} in {SHARD_WARM + TIMED} batches, "
        f"no rehydrate span, trace event or capture; timed batches' wall extent: device median {np.median(dev_ms):.3f} ms "
        f"({min(dev_ms):.3f}-{max(dev_ms):.3f}), apply median {np.median(app_ms):.3f} ms "
        f"({min(app_ms):.3f}-{max(app_ms):.3f})")
    tps = TIMED * PER_BATCH / dt
    log(f"sharded: {TIMED} timed batches x {PER_BATCH} txns through ShardedTorchConflictSet"
        f".detect_packed ({SHARDS} shards, h_cap {SHARD_H_CAP} each) in {dt:.6f} s: "
        f"{tps:.1f} txn/s, {dt / TIMED * 1e3:.3f} ms/batch; host ms/batch: unpack "
        f"{per_batch_ms('unpack_seconds'):.3f}, clip "
        f"{per_batch_ms('clip_seconds'):.3f}, mirror applies "
        f"{per_batch_ms('mirror_apply_seconds'):.3f}, witness decode "
        f"{per_batch_ms('witness_decode_seconds'):.3f}; host syncs/batch "
        f"{(cs.host_syncs - syncs0) / TIMED}; device span a batch {batch_ms:.3f} ms, "
        f"a shard (decide + commit) {', '.join(f'{x:.3f}' for x in shard_ms)} ms; "
        f"conflicts {int((s == 0).sum())}/{PER_BATCH} in the last batch; launches {launches}; "
        f"mirror_check ok on {SHARDS} shards ({sum(r['boundaries'] for r in report['shards'].values())} "
        f"boundaries, {check_s:.3f} s); card {torch.cuda.get_device_name(0)}")
    return launches, cs, rng


def resharded_path(torch, tk, et, cs, rng, obs):
    """Phase 4r: phase 4s's set, after its timed batches, resharded live on
    the bench stream.  A boundary move (split point 3, 10,000,000, to the
    middle of shard 3) and 4 batches, then the scale-up to 16 shards along
    balance_split_keys(16) and 5 batches, the last 3 timed.  On fresh port
    hubs each step gives one ShardReshard event, one reshard marker span
    and one reshard capture, and only the shards that rehydrate leave a
    rehydrate span.  Returns the launches of those 9 batches."""
    m = cs.metrics
    hubs = PortHubs(*obs)

    def step_obs(what, n_steps, rehydrated_shards):
        hub = hubs.hub
        events = [e for e in hubs.col.events if e["Type"].startswith("ShardReshard")]
        caps = [c for c in hubs.rec.captures if c["trigger"] == "reshard"]
        marks = hub.spans(name="reshard")
        reh = [sp.attrs["shard"] for sp in hub.spans(name="rehydrate")]
        if ([e["Type"] for e in events] != ["ShardReshard"] * n_steps or len(caps) != n_steps
                or len(marks) != n_steps or reh != rehydrated_shards
                or any(not c["spans"] or not c["transitions"] for c in caps)):
            raise AssertionError(f"resharded: after the {what}: events {events}, "
                                 f"{len(caps)} captures, marks {[sp.attrs for sp in marks]}, "
                                 f"rehydrate spans {reh}")
        log(f"resharded spans after the {what}: events {events}; reshard captures "
            f"{[c['detail'] for c in caps]}; marker spans {[sp.attrs for sp in marks]}; "
            f"rehydrate spans for shards {reh}")
    next_batch = [SHARD_WARM + TIMED]

    def counters():
        return m.snapshot()["counters"]

    def run_batches(n, shards):
        """n bench batches; each one's host ms (generation excluded) and
        launches, which must be one of each kernel a shard."""
        out = []
        for _ in range(n):
            i = next_batch[0]
            next_batch[0] += 1
            pb = gen_packed(et, rng, PER_BATCH, i)
            before = dict(tk.LAUNCHES)
            t0 = time.perf_counter()
            statuses = cs.detect_packed(pb, i + WINDOW, i)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k: tk.LAUNCHES[k] - before[k] for k in before}
            if launches != {k: shards for k in before}:
                raise AssertionError(f"resharded: batch {i} launched {launches} on {shards} shards")
            s = np.asarray(statuses[:PER_BATCH])
            if not ((s >= 0) & (s <= 2)).all() or not (s == 2).any() or not (s == 0).any():
                raise AssertionError(f"resharded: batch {i}: verdicts out of range")
            out.append(ms)
        return out

    def check_mirrors(shards, what):
        t0 = time.perf_counter()
        report = cs.mirror_check()
        if (report["status"] != "ok" or len(report["shards"]) != shards
                or any(r["status"] != "ok" for r in report["shards"].values())):
            raise AssertionError(f"resharded: mirror_check after the {what}: {report}")
        return time.perf_counter() - t0

    def rehydrated(c0, c1):
        return [c1[f"shard{k}_rehydrates"] - c0[f"shard{k}_rehydrates"] for k in range(cs.n_shards)]

    gc.collect()
    start = time.perf_counter()
    occ0 = cs.shard_occupancy()
    old = list(cs.split_keys)
    if old[3] != (10_000_000).to_bytes(KEY_BYTES, "big"):
        raise AssertionError(f"resharded: split point 3 is {old[3].hex()}")
    new = list(old)
    new[3] = (8_750_000).to_bytes(KEY_BYTES, "big")
    for name in tk.LAUNCHES:
        tk.LAUNCHES[name] = 0
    c0 = counters()
    t0 = time.perf_counter()
    entry = cs.reshard(new, reason="chip_smoke move")
    move_ms = (time.perf_counter() - t0) * 1e3
    if (entry["action"], entry["moved"], entry["reused_mirrors"]) != ("live", [3, 4], 6):
        raise AssertionError(f"resharded: the move {entry}")
    move_rows = run_batches(4, SHARDS)
    c1 = counters()
    if rehydrated(c0, c1) != [1 if k in (3, 4) else 0 for k in range(SHARDS)]:
        raise AssertionError(f"resharded: rehydrates after the move {rehydrated(c0, c1)}")
    keys_total = c1["rehydrate_keys_total"] - c0["rehydrate_keys_total"]
    keys_encoded = c1["rehydrate_keys_encoded"] - c0["rehydrate_keys_encoded"]
    check_move_s = check_mirrors(SHARDS, "move")
    step_obs("move", 1, [3, 4])
    occ1 = cs.shard_occupancy()
    log(f"resharded move: split point 3 {old[3].hex()} -> {new[3].hex()} (live, moved "
        f"{entry['moved']}, {entry['reused_mirrors']} mirrors kept) in {move_ms:.3f} ms of host; "
        f"first batch {move_rows[0]:.3f} ms (2 rehydrates: rehydrate_keys_total +{keys_total}, "
        f"rehydrate_keys_encoded +{keys_encoded}), then "
        f"{', '.join(f'{x:.3f}' for x in move_rows[1:])} ms; {SHARDS} launches of each kernel a batch; mirror_check ok on {SHARDS} shards "
        f"({check_move_s:.3f} s); occupancy {occ0} -> {occ1}")

    gc.collect()
    t0 = time.perf_counter()
    split16 = cs.balance_split_keys(2 * SHARDS)
    t1 = time.perf_counter()
    entry = cs.reshard(split16, reason="chip_smoke scale")
    t2 = time.perf_counter()
    if (entry["action"], entry["moved"], entry["shards"], cs.n_shards) != (
            "live", list(range(2 * SHARDS)), [SHARDS, 2 * SHARDS], 2 * SHARDS):
        raise AssertionError(f"resharded: the scale-up {entry}, {cs.n_shards} shards")
    first = run_batches(1, 2 * SHARDS)
    c2 = counters()
    scale_keys = (c2["rehydrate_keys_total"] - c1["rehydrate_keys_total"],
                  c2["rehydrate_keys_encoded"] - c1["rehydrate_keys_encoded"])
    if rehydrated(c1, c2) != [1] * (2 * SHARDS):
        raise AssertionError(f"resharded: rehydrates after the scale-up {rehydrated(c1, c2)}")
    second = run_batches(1, 2 * SHARDS)
    syncs0 = cs.host_syncs
    wall0 = m.snapshot(include_wall=True)["wall"]
    gc.collect()
    spans = ShardSpans(torch, et)
    timed = run_batches(3, 2 * SHARDS)
    shard_ms, batch_ms = spans.remove(3, 2 * SHARDS)
    wall = m.snapshot(include_wall=True)["wall"]
    c3 = counters()
    for name in ("cpu_fallbacks", "cpu_fallback_txns", "degraded_shard_serves", "grows"):
        if c3[name] != 0:
            raise AssertionError(f"resharded: {name} = {c3[name]}")
    if cs.backend_signal()["shards_degraded"] != 0 or cs.h_cap != SHARD_H_CAP:
        raise AssertionError(f"resharded: {cs.backend_signal()}, h_cap {cs.h_cap}")
    faults = tk.merge_contract_faults("cuda")
    if faults:
        raise AssertionError(f"resharded: the merge found {faults} order faults")
    launches = dict(tk.LAUNCHES)
    check_scale_s = check_mirrors(2 * SHARDS, "scale-up")
    step_obs("scale-up", 2, [3, 4] + list(range(2 * SHARDS)))
    hubs.restore()
    if len(hubs.hub.spans(name="device")) != 9 or len(hubs.hub.spans(name="apply")) != 9:
        raise AssertionError("resharded: not one device and one apply span a batch")

    def per_batch_ms(name):
        if wall[name]["count"] - wall0[name]["count"] != 3:
            raise AssertionError(f"resharded: {name}: not one sample a timed batch")
        return (wall[name]["seconds"] - wall0[name]["seconds"]) / 3 * 1e3

    log(f"resharded scale-up: {SHARDS} -> {2 * SHARDS} shards along balance_split_keys"
        f"({2 * SHARDS}) ({(t1 - t0) * 1e3:.3f} ms) by reshard in {(t2 - t1) * 1e3:.3f} ms of "
        f"host (live, all {2 * SHARDS} moved); first batch {first[0]:.3f} ms ({2 * SHARDS} "
        f"rehydrates, rehydrate_keys_total +{scale_keys[0]}, encoded +{scale_keys[1]}), then "
        f"{second[0]:.3f} ms; last 3 batches {3 * PER_BATCH / sum(timed) * 1e3:.1f} txn/s "
        f"({', '.join(f'{x:.3f}' for x in timed)} ms); host ms/batch: unpack "
        f"{per_batch_ms('unpack_seconds'):.3f}, clip {per_batch_ms('clip_seconds'):.3f}, mirror "
        f"applies {per_batch_ms('mirror_apply_seconds'):.3f}, witness decode "
        f"{per_batch_ms('witness_decode_seconds'):.3f}; host syncs/batch "
        f"{(cs.host_syncs - syncs0) / 3}; device span a batch {batch_ms:.3f} ms, a shard "
        f"{min(shard_ms):.3f}-{max(shard_ms):.3f} ms; {2 * SHARDS} launches of each kernel a "
        f"batch, no growth, fallback or degraded shard; mirror_check ok on {2 * SHARDS} shards "
        f"({check_scale_s:.3f} s); occupancy {occ1} -> {cs.shard_occupancy()}; launches {launches}"
        f"; phase 4r {time.perf_counter() - start:.3f} s in all")
    return launches


def sharded_vs_cpu(torch, sr, faults, keylib):
    """Phase 6s: the sharded set at 4 shards on a reduced stream, on cuda
    and on cpu, flat and tiered, under one per-shard fault script: a
    dispatch outage on shard 1 over batches 2-4 (its third fault opens its
    breaker), then a grow outage on shard 1 during batch 6, its first probe,
    whose rehydration checks the grow site first.  The history starts at
    4,096 rows a shard, so every path grows.  Verdicts, witnesses, the
    injected log, every shard's breaker walk and the counters must be
    equal on the two devices."""
    from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as T

    n_txn, batches, window, keyspace = 2048, 12, 4, 200_000
    rng = np.random.default_rng(7)
    stream = [(gen_txns(T, rng, n_txn, i, keyspace=keyspace), i + window, i)
              for i in range(batches)]
    split = keylib.uniform_int_split_keys(4, keyspace, KEY_BYTES)
    for history in ("flat", "tiered"):
        tiers = dict(history="tiered", evict_every=3, delta_cap=8192) if history == "tiered" else {}
        runs = {}
        for device in ("cuda", "cpu"):
            inj = faults.DeviceFaultInjector()
            cs = sr.ShardedTorchConflictSet(split, key_words=KEY_WORDS, h_cap=1 << 12,
                                            device=device, fault_injector=inj, **tiers)
            out = []
            for i, (txns, now, nov) in enumerate(stream):
                if i == 2:
                    inj.begin_outage("dispatch", shard=1)
                if i == 5:
                    inj.end_outage("dispatch", shard=1)
                if i == 6:
                    inj.begin_outage("grow", shard=1)
                if i == 7:
                    inj.end_outage("grow", shard=1)
                out.append((cs.detect(txns, now, nov), list(cs.last_witness)))
            report = cs.mirror_check()
            if report["status"] != "ok":
                raise AssertionError(f"sharded {history} on {device}: mirror_check {report}")
            dm = cs.device_metrics()
            runs[device] = (out, inj.injected, [b.transitions for b in cs._breakers],
                            dm["counters"], cs.h_cap, cs.d_cap)
        if runs["cuda"] != runs["cpu"]:
            which = [k for k, a, b in zip(("verdicts", "injected", "transitions", "counters",
                                           "h_cap", "d_cap"), runs["cuda"], runs["cpu"]) if a != b]
            raise AssertionError(f"sharded {history}: cuda and cpu differ in {which}")
        out, injected, transitions, c, h_cap, d_cap = runs["cuda"]
        walk = [(f, t) for _s, f, t, _r in transitions[1]]
        if walk != [("ok", "degraded"), ("degraded", "probing"), ("probing", "degraded"),
                    ("degraded", "probing"), ("probing", "ok")]:
            raise AssertionError(f"sharded {history}: shard 1's breaker walk {walk}")
        if any(transitions[s] for s in (0, 2, 3)):
            raise AssertionError(f"sharded {history}: a healthy shard's breaker moved")
        if [site for _q, site, _k in injected] != ["dispatch#s1"] * 3 + ["grow#s1"]:
            raise AssertionError(f"sharded {history}: injected {injected}")
        conflicts = sum(int((np.asarray(v) == 0).sum()) for v, _w in out)
        if conflicts == 0 or c["grows"] < 1 or (history == "tiered" and c["major_compactions"] < 3):
            raise AssertionError(f"sharded {history}: conflicts {conflicts}, counters {c}")
        log(f"sharded {history} vs cpu: {batches} batches x {n_txn} txns, 4 shards, identical "
            f"on cuda and cpu (verdicts, witnesses, injected {injected}, breaker walks, "
            f"counters); shard 1's walk {walk}; {conflicts} conflicts, grows {c['grows']}, "
            f"h_cap {h_cap}, d_cap {d_cap}, degraded shard serves "
            f"{c['degraded_shard_serves']}, shard 1 rehydrates {c['shard1_rehydrates']}"
            + (f", compactions {c['major_compactions']}" if history == "tiered" else ""))


def resharded_vs_cpu(torch, sr, faults, keylib):
    """Phase 6r: a reshard schedule at 4 shards on a reduced stream, on cuda
    and on cpu, flat and tiered: a boundary move after batch 3, after batch
    5 a second move that a scripted `reshard` fault on moved shard 2
    defers, its retry after batch 7, and balance_split_keys scale-ups to 6
    and 8 shards after batches 8 and 10.  Verdicts, witnesses, the move
    log, the injected log, every shard's breaker walk, the counters, h_cap
    and d_cap must be equal on the two devices."""
    from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as T

    n_txn, batches, window, keyspace = 2048, 12, 4, 200_000
    rng = np.random.default_rng(11)
    stream = [(gen_txns(T, rng, n_txn, i, keyspace=keyspace), i + window, i)
              for i in range(batches)]
    split = keylib.uniform_int_split_keys(4, keyspace, KEY_BYTES)
    moves = {3: (60_000, "move"), 5: (80_000, "raced"), 7: (80_000, "retry")}
    for history in ("flat", "tiered"):
        start = time.perf_counter()
        tiers = dict(history="tiered", evict_every=3, delta_cap=8192) if history == "tiered" else {}
        runs = {}
        for device in ("cuda", "cpu"):
            inj = faults.DeviceFaultInjector()
            # Shard 2's second reshard check: the move after batch 5.
            inj.script("reshard", at=2, shard=2)
            cs = sr.ShardedTorchConflictSet(split, key_words=KEY_WORDS, h_cap=1 << 12,
                                            device=device, fault_injector=inj, max_shards=8,
                                            **tiers)
            out = []
            for i, (txns, now, nov) in enumerate(stream):
                out.append((cs.detect(txns, now, nov), list(cs.last_witness)))
                if i in moves:
                    key, reason = moves[i]
                    cs.reshard([split[0], key.to_bytes(KEY_BYTES, "big"), split[2]], reason)
                if i in (8, 10):
                    cs.reshard(cs.balance_split_keys(cs.n_shards + 2), "scale")
            report = cs.mirror_check()
            if report["status"] != "ok" or len(report["shards"]) != 8:
                raise AssertionError(f"resharded {history} on {device}: mirror_check {report}")
            runs[device] = (out, cs.move_log, inj.injected,
                            [b.transitions for b in cs._breakers],
                            cs.device_metrics()["counters"], cs.h_cap, cs.d_cap)
        if runs["cuda"] != runs["cpu"]:
            which = [k for k, a, b in zip(("verdicts", "move_log", "injected", "transitions",
                                           "counters", "h_cap", "d_cap"),
                                          runs["cuda"], runs["cpu"]) if a != b]
            raise AssertionError(f"resharded {history}: cuda and cpu differ in {which}")
        out, move_log, injected, transitions, c, h_cap, d_cap = runs["cuda"]
        actions = [(e["action"], e["shards"], e.get("fault_shard")) for e in move_log]
        if actions != [("live", [4, 4], None), ("deferred", [4, 4], 2), ("live", [4, 4], None),
                       ("live", [4, 6], None), ("live", [6, 8], None)]:
            raise AssertionError(f"resharded {history}: moves {actions}")
        if [site for _q, site, _k in injected] != ["reshard#s2"] or c["reshard_deferred"] != 1:
            raise AssertionError(f"resharded {history}: injected {injected}")
        conflicts = sum(int((np.asarray(v) == 0).sum()) for v, _w in out)
        if conflicts == 0 or (history == "tiered" and c["major_compactions"] < 3):
            raise AssertionError(f"resharded {history}: conflicts {conflicts}, counters {c}")
        log(f"resharded {history} vs cpu: {batches} batches x {n_txn} txns, 4 -> 8 shards, "
            f"identical on cuda and cpu (verdicts, witnesses, move log, injected {injected}, "
            f"breaker walks, counters, h_cap {h_cap}, d_cap {d_cap}); moves {actions}; "
            f"{conflicts} conflicts, reshards {c['reshards']}, moved shards "
            f"{c['reshard_moved_shards']}, rehydrates "
            f"{sum(c[f'shard{k}_rehydrates'] for k in range(8))}, grows {c['grows']}"
            + (f", compactions {c['major_compactions']}" if history == "tiered" else "")
            + f"; {time.perf_counter() - start:.3f} s")


# ---------------------------------------------------------------------------
# phase 6c: chaos on the card
# ---------------------------------------------------------------------------

# The random fault schedule of phase 6c(a): the port's buggify stream and
# the injector's own, and the per-check fire probability of a device site.
# With the open-ended dispatch outage over batches 54-56 (inside the timed
# window 52-59) it fires a handful of faults, two of them when the window
# is full, and lets the breaker close by the last batch.
# Phase 4o: the batches of phase 4's timed window a hub's block runs before
# the pipeline drains (the arms taking turns, half the batches each), and
# the stages counted.
SPAN_BLOCK = 2
SPAN_STAGES = ("encode", "dispatch", "device", "sync", "readback", "apply", "mirror_apply")


class PortHubs:
    """Fresh port SpanHub, TraceCollector and FlightRecorder installed as
    the port's globals (restored by restore()), all three on `clock` when
    one is given."""

    def __init__(self, spans, trace, fr, clock=None, hub=None):
        self.mods = (spans, trace, fr)
        self.saved = (spans.global_span_hub(), trace.global_collector(),
                      trace._global_clock, fr.global_flight_recorder())
        self.hub = hub if hub is not None else spans.SpanHub(clock=clock)
        self.col = trace.TraceCollector(clock=clock)
        self.rec = fr.FlightRecorder(clock=clock)
        spans.set_global_span_hub(self.hub)
        trace.set_global_collector(self.col)
        fr.set_global_flight_recorder(self.rec)

    def restore(self):
        spans, trace, fr = self.mods
        spans.set_global_span_hub(self.saved[0])
        trace.set_global_collector(self.saved[1], clock=self.saved[2])
        fr.set_global_flight_recorder(self.saved[3])


class SpanArms:
    """Phase 4o inside phase 4: its timed batches run in blocks of
    SPAN_BLOCK that take turns between a disabled SpanHub(enabled=False)
    and the port's own SpanHub, with a fresh TraceCollector and
    FlightRecorder installed; the pipeline drains at each block's end, so no
    span straddles a swap.  report() checks and prints the record."""

    def __init__(self, spans, trace, fr):
        self.spans = spans
        self.hubs = PortHubs(spans, trace, fr)
        self.on, self.off = self.hubs.hub, spans.SpanHub(enabled=False)
        self.arms = {"enabled": dict(hub=self.on, s=0.0, n=0, seq=[]),
                     "disabled": dict(hub=self.off, s=0.0, n=0, seq=[])}

    def drive(self, torch, cs, timed, depth, sink):
        """The timed batches, block by block; each block's host seconds go
        to its arm, and host_phase_seq is read after every turn."""
        try:
            for b in range(len(timed) // SPAN_BLOCK):
                # The disabled arm first, so that the engine's last dispatch
                # span (phase 4a's parent) is a recorded one.
                arm = self.arms[("disabled", "enabled")[b % 2]]
                self.spans.set_global_span_hub(arm["hub"])
                turns = [cs.host_phase_seq]
                t0 = time.perf_counter()
                drive(cs, timed[b * SPAN_BLOCK : (b + 1) * SPAN_BLOCK], depth, sink=sink,
                      tick=lambda _e: turns.append(cs.host_phase_seq))
                torch.cuda.synchronize()
                arm["s"] += time.perf_counter() - t0
                arm["n"] += SPAN_BLOCK
                turns.append(cs.host_phase_seq)
                arm["seq"].append([y - x for x, y in zip(turns, turns[1:])])
        finally:
            self.hubs.restore()

    def report(self, torch, stats):
        """Each stage leaves one span a batch of the enabled arm, every
        device span closes clean, the device spans overlap at depth 2 on
        both axes, the disabled hub records nothing and adds nothing to
        host_phase_seq, no trace event or capture appears.  Prints the span
        counts, each stage's wall extent a batch beside phase 4's own timers
        (`stats`), the overlap, host_phase_seq a turn and each arm's txn/s."""
        on, arms, spans = self.on, self.arms, self.spans
        n_on = arms["enabled"]["n"]
        counts = {name: len(on.spans(name=name)) for name in SPAN_STAGES}
        if counts != {name: n_on for name in SPAN_STAGES}:
            raise AssertionError(f"spans: span counts {counts} in {n_on} enabled batches")
        dev = on.spans(name="device")
        if not all(d.done for d in dev) or any(set(d.attrs) != {"version"} for d in dev):
            raise AssertionError(f"spans: a device span is open or marked: "
                                 f"{[d.attrs for d in dev]}")
        overlap = {axis: spans.overlap_efficiency(dev, axis=axis) for axis in ("seq", "wall")}
        if not all(v > 0 for v in overlap.values()):
            raise AssertionError(f"spans: no device overlap at depth 2: {overlap}")
        if self.off.rings or self.off.begun or any(any(x) for x in arms["disabled"]["seq"]):
            raise AssertionError("spans: the disabled hub recorded spans or host phases")
        if self.hubs.col.events or self.hubs.rec.captures:
            raise AssertionError(f"spans: events {self.hubs.col.events}, captures "
                                 f"{len(self.hubs.rec.captures)}")
        card = torch.cuda.get_device_name(0)
        tps = {k: a["n"] * PER_BATCH / a["s"] for k, a in arms.items()}
        log(f"spans: phase 4's {2 * n_on} timed batches in blocks of {SPAN_BLOCK}, a disabled "
            f"and an enabled hub taking turns; span counts a batch (enabled) "
            f"{ {k: v / n_on for k, v in counts.items()} }, every device span closed and "
            f"unmarked, no trace event or capture; card {card}")
        for name in SPAN_STAGES:
            ms = [(sp.wall_end - sp.wall_start) * 1e3 for sp in on.spans(name=name)]
            log(f"spans timeline {name}: wall extent a batch median {np.median(ms):.3f} ms, "
                f"range {min(ms):.3f}-{max(ms):.3f} ms ({len(ms)} spans)")
        log(f"spans timeline beside phase 4's own timers: readback holds the witness decode "
            f"({stats['decode_ms']:.3f} ms a batch), mirror_apply is apply_batch "
            f"({stats['apply_ms']:.3f} ms), dispatch holds the device span's enqueue "
            f"({stats['span_ms']:.3f} ms)")
        log(f"spans overlap of the device spans: seq {overlap['seq']:.4f}, wall "
            f"{overlap['wall']:.4f}; host_phase_seq a turn, enabled blocks "
            f"{arms['enabled']['seq']}, disabled blocks {arms['disabled']['seq']}")
        from foundationdb_tpu_torch.flow import trace_export

        t0 = time.perf_counter()
        blob = trace_export.perfetto_json(on)
        export_ms = (time.perf_counter() - t0) * 1e3
        doc = json.loads(blob)
        errors = trace_export.validate_perfetto(doc)
        lanes = {e["tid"] for e in doc["traceEvents"] if e["ph"] == "B" and e["name"] == "device"}
        if errors or len(lanes) != 2:
            raise AssertionError(f"spans export: {errors[:3]}, device spans on lanes {lanes}")
        log(f"spans export: perfetto_json of the enabled arm's hub {len(blob)} B, "
            f"{doc['otherData']['spans']} spans, in {export_ms:.3f} ms of host; schema valid, "
            f"device spans on {len(lanes)} lanes at depth 2; card {card}")
        log(f"spans cost: enabled {tps['enabled']:.1f} txn/s "
            f"({arms['enabled']['s'] / n_on * 1e3:.3f} ms/batch), disabled "
            f"{tps['disabled']:.1f} txn/s ({arms['disabled']['s'] / arms['disabled']['n'] * 1e3:.3f}"
            f" ms/batch), ratio disabled/enabled {tps['disabled'] / tps['enabled']:.4f}; "
            f"card {card}")


# Phase 6o's fault script: the single set's dispatch down for 3 checks (the
# breaker opens, probes and closes), the sharded set's shard 1 likewise; a
# device edit planted after batch SPANS_PLANT, which mirror_check finds.
SPANS_PLANT = 7


def spans_vs_cpu(torch, api, sr, T, faults, keylib, spans, trace, fr):
    """Phase 6o: phase 6's reduced stream through ConflictSet at depths 1
    and 2 and through 2 shards, on cuda and on cpu, each on fresh port hubs
    whose clock is the batch index: dispatch faults open and close the
    breaker, and a device edit planted after batch SPANS_PLANT diverges
    (mirror_check; the breaker opens again and recovers).  spans_json() and
    host_phase_seq after every batch, the trace events and every capture's
    artifact_json must be byte-identical on the two devices, and so must
    perfetto_json of the hub and the lines of the CLI's trace-export,
    flightrec and latency over the run's globals."""
    from foundationdb_tpu_torch.flow import trace_export
    from foundationdb_tpu_torch.tools.cli import CliProcessor

    n_txn, batches, window, keyspace = 4096, 12, 4, 200_000
    rng = np.random.default_rng(7)
    stream = [(gen_txns(T, rng, n_txn, i, keyspace=keyspace), i + window, i)
              for i in range(batches)]
    split = keylib.uniform_int_split_keys(2, keyspace, KEY_BYTES)

    def run(config, device):
        t = [0.0]
        hubs = PortHubs(spans, trace, fr, clock=lambda: t[0])
        try:
            inj = faults.DeviceFaultInjector()
            if config == "2 shards":
                cs = sr.ShardedTorchConflictSet(split, key_words=KEY_WORDS, h_cap=1 << 14,
                                                device=device, fault_injector=inj)
                inj.script("dispatch", at=3, persist=3, shard=1)
            else:
                depth = int(config[-1])
                cs = api.ConflictSet(key_words=KEY_WORDS, h_cap=1 << 16, device=device,
                                     pipeline_depth=depth, fault_injector=inj)
                inj.script("dispatch", at=3, persist=3)
            per, out = [], []
            for i, (txns, now, nov) in enumerate(stream):
                t[0] = float(i)
                if config == "2 shards":
                    out.append((list(cs.detect(txns, now, nov)), list(cs.last_witness)))
                else:
                    out.append(cs.pipeline_submit(txns, now, nov))
                    while cs.pipeline_inflight > depth - 1:
                        cs.pipeline_complete_oldest()
                if i == SPANS_PLANT:
                    if config == "2 shards":
                        cs._hvers[0, 1] += 1
                    else:
                        cs.pipeline_drain()
                        cs._dev._hvers[1] += 1
                    check = cs.mirror_check()
                    if check["status"] != "diverged":
                        raise AssertionError(f"spans {config} on {device}: the plant: {check}")
                per.append((hubs.hub.spans_json(), getattr(cs, "host_phase_seq", 0)))
            if config != "2 shards":
                cs.pipeline_drain()
                per.append((hubs.hub.spans_json(), cs.host_phase_seq))
                out = [(list(e.statuses), list(e.witness)) for e in out]
            walks = ([b.transitions for b in cs._breakers] if config == "2 shards"
                     else [cs._breaker.transitions])
            arts = [fr.artifact_json(a) for a in hubs.rec.captures]
            cli = CliProcessor()
            lines = {cmd: cli.run_command(cmd) for cmd in ("trace-export", "flightrec",
                                                           "latency")}
            return dict(verdicts=out, per=per, events=json.dumps(hubs.col.events),
                        artifacts=arts, walks=json.loads(json.dumps(walks)),
                        export=trace_export.perfetto_json(hubs.hub), cli=lines,
                        types=[e["Type"] for e in hubs.col.events],
                        triggers=[a["trigger"] for a in hubs.rec.captures])
        finally:
            hubs.restore()

    for config in ("depth 1", "depth 2", "2 shards"):
        runs = {device: run(config, device) for device in ("cuda", "cpu")}
        a, b = runs["cuda"], runs["cpu"]
        for key in ("verdicts", "per", "events", "artifacts", "walks", "export", "cli"):
            if a[key] != b[key]:
                raise AssertionError(f"spans {config}: cuda and cpu differ in {key}")
        doc = json.loads(a["export"])
        if trace_export.validate_perfetto(doc) or a["cli"]["trace-export"] != [a["export"]]:
            raise AssertionError(f"spans {config}: the export is not valid, or not the CLI's")
        walk = [(f, to) for w in a["walks"] for _s, f, to, _r in w]
        if walk.count(("ok", "degraded")) != 2 or walk_end(f"spans {config}", sum(a["walks"], [])) \
                != "ok":
            raise AssertionError(f"spans {config}: breaker walk {a['walks']}")
        if a["types"].count("DeviceBackendStateChange") != len(walk) or \
                a["types"].count("MirrorDivergence") != 1:
            raise AssertionError(f"spans {config}: events {a['types']}")
        if a["triggers"].count("mirror_divergence") != 1 or "breaker_open" not in a["triggers"]:
            raise AssertionError(f"spans {config}: captures {a['triggers']}")
        last = json.loads(a["per"][-1][0])["spans"]
        log(f"spans {config} vs cpu: {batches} batches x {n_txn} txns under dispatch faults and "
            f"a planted divergence after batch {SPANS_PLANT}: spans_json and host_phase_seq after "
            f"every batch, {len(a['types'])} trace events and {len(a['artifacts'])} captures "
            f"byte-identical on cuda and cpu; breaker walk {walk}; events {a['types']}; captures "
            f"{a['triggers']}; spans by role "
            f"{ {r: len(v) for r, v in sorted(last.items())} }; host_phase_seq {a['per'][-1][1]}")
        log(f"spans {config} export and CLI: perfetto_json {len(a['export'])} B "
            f"({doc['otherData']['spans']} spans, schema valid) and the lines of trace-export, "
            f"flightrec ({len(a['cli']['flightrec'])}) and latency ({len(a['cli']['latency'])}) "
            f"byte-identical on cuda and cpu; flightrec: {a['cli']['flightrec'][0]}")


# ---------------------------------------------------------------------------
# phases 2g, 2h, 4v and 6v: the structural check, perfcheck and the transfer guard
# ---------------------------------------------------------------------------

# The aten ops a kernel wrapper's region may hold on the card beside its
# launch: the allocations of its outputs and scratch.
KERNEL_REGION_ALLOCS = frozenset({"empty", "empty_strided", "zeros", "zero_", "new_empty",
                                  "new_zeros", "fill_"})


def torchir_path(torch):
    """Phase 2g: torchcheck (tools/lint/torchir.py) over every registered
    program on cuda and on cpu.  Prints, a program, its findings on the
    card, its syncs and op count beside the CPU's and how many of its
    fingerprint's lines differ from the CPU run's (the card's torch differs
    from the one the committed baselines were made with, so neither
    difference is gated).  A kernel program's kernel regions on the card
    must hold a launch of each kernel and nothing else but allocations:
    none of the plain twin's ops; no other program may have a kernel
    region, and the CPU runs launch nothing."""
    from foundationdb_tpu_torch.tools.lint import torchfingerprint as tfp
    from foundationdb_tpu_torch.tools.lint import torchir

    reg = torchir.default_registry()
    t0 = time.perf_counter()
    runs = {dev: {n: torchir.walk_program(reg[n], dev) for n in sorted(reg)}
            for dev in ("cuda", "cpu")}
    found = {dev: torchir.run_torchcheck(reg, device=dev, runs=runs[dev]) for dev in runs}
    dt = time.perf_counter() - t0
    card = torch.cuda.get_device_name(0)
    for name in sorted(reg):
        fps = {dev: tfp.fingerprint(reg[name], runs[dev][name]) for dev in runs}
        in_kernel = [r.op for r in runs["cuda"][name].rows if r.in_kernel]
        launches = sorted(op for op in in_kernel if op.startswith("launch:"))
        others = sorted(set(in_kernel) - set(launches) - KERNEL_REGION_ALLOCS)
        if reg[name].kernel and (not launches or others):
            raise AssertionError(f"torchir {name}: kernel region on cuda holds launches "
                                 f"{launches} and other ops {others}")
        if not reg[name].kernel and in_kernel:
            raise AssertionError(f"torchir {name}: a kernel region in a plain program")
        if any(r.op.startswith("launch:") for r in runs["cpu"][name].rows):
            raise AssertionError(f"torchir {name}: a launch on the cpu")
        diff = tfp.diff_fingerprints(fps["cpu"], fps["cuda"])
        mine = [f"{f.rule}{' (suppressed)' if f.suppressed else ''}: {f.message}"
                for f in found["cuda"] if f.entry == name]
        log(f"torchir {name} on cuda: findings {mine or 'none'}; syncs cuda "
            f"{json.dumps(fps['cuda']['syncs'], sort_keys=True)}, cpu "
            f"{json.dumps(fps['cpu']['syncs'], sort_keys=True)}; ops cuda "
            f"{fps['cuda']['op_count']}, cpu {fps['cpu']['op_count']}; kernel region on cuda: "
            f"{launches} and {len(in_kernel) - len(launches)} allocations; "
            f"{len(diff)} fingerprint lines differ from the cpu run")
        outside = [ln for ln in diff if "|kernel" not in ln]
        for ln in outside[:8]:
            log(f"torchir {name} cuda vs cpu (outside kernel regions): {ln}")
    problems = tfp.check_baselines(reg, runs=runs["cpu"])
    unsup = {dev: [f.format() for f in found[dev] if not f.suppressed] for dev in found}
    log(f"torchir: {len(reg)} programs on cuda and cpu in {dt:.3f} s; unsuppressed findings "
        f"cuda {len(unsup['cuda'])}, cpu {len(unsup['cpu'])}; the cpu runs against the "
        f"committed baselines: {len(problems)} lines differ (torch {torch.__version__}); "
        f"card {card}")
    for ln in problems[:6]:
        log(f"torchir baseline difference on this host's cpu: {ln}")


def sync_debug_probe(torch, hotpath):
    """Which CUDA calls torch.cuda.set_sync_debug_mode("error") refuses on
    this card and torch: name -> True when the call raised."""
    dev = torch.device("cuda")
    pinned = torch.empty((1 << 16,), dtype=torch.int32, pin_memory=True)
    pageable = torch.empty((1 << 16,), dtype=torch.int32)
    on_dev = torch.ones((1 << 16,), dtype=torch.int32, device=dev)
    other = torch.empty_like(on_dev)
    ev = torch.cuda.Event()

    def truth_if():
        if on_dev[0]:
            return 1
        return 0

    def truth_while():
        while (on_dev > 0).any():
            break

    calls = {
        "Event.synchronize (the staging ring's wait)": lambda: (ev.record(), ev.synchronize()),
        "Event.query": lambda: (ev.record(), ev.query()),
        "Event.wait (a stream waits on the device)": lambda: (ev.record(), ev.wait()),
        "pinned non-blocking upload (the blob)": lambda: pinned.to(dev, non_blocking=True),
        "pinned non-blocking readback (the ticket)": lambda: pinned.copy_(on_dev,
                                                                          non_blocking=True),
        "pageable upload (torch.tensor(..., device=cuda))": lambda: torch.tensor([1, 2], device=dev),
        "Tensor.item()": lambda: on_dev[0].item(),
        "blocking readback (.cpu())": lambda: on_dev.cpu(),
        "torch.cuda.synchronize()": lambda: torch.cuda.synchronize(),
        # The hidden syncs HOT001 flags as truth tests, copy_ and stream syncs:
        "truth test (if t[0]:)": truth_if,
        "truth test (while (t > 0).any():)": truth_while,
        "copy_ to pageable host memory (dst.copy_(t))": lambda: pageable.copy_(on_dev),
        "torch.cuda.current_stream().synchronize()":
            lambda: torch.cuda.current_stream().synchronize(),
        "copy_ on the device (other.copy_(t))": lambda: other.copy_(on_dev),
    }
    seen = {}
    for name, call in calls.items():
        torch.cuda.synchronize()
        try:
            with hotpath.cuda_sync_debug_mode("error"):
                call()
            seen[name] = False
        except RuntimeError:
            seen[name] = True
        if torch.cuda.get_sync_debug_mode() != 0:
            raise AssertionError(f"guard probe: the sync debug mode stayed on after {name}")
    torch.cuda.synchronize()
    return seen


# Phase 2h's planted window: a callee between dispatch_txns and
# sync_ticket, in ten variants: {variant: (imports, the callee's body, the
# rules the source tools must give, sorted; the operation the HOT001
# finding must name, or None; whether it runs on the guarded set, whose
# ticket fields are GuardedDeviceValue proxies, or on an unguarded one,
# where only CUDA's sync debug mode can catch it)}.  Every HOT001 and
# DET101 finding names the chain drive -> _peek.  (g)-(j) are the hidden
# syncs HOT001 flags as truth tests, copy_ and stream syncs.
PLANT_VARIANTS = {
    "a": ("", "return torch.cuda.synchronize()", ("HOT001",), "torch.cuda.synchronize()", True),
    "b": ("", "return np.asarray(ticket.host)", ("HOT001",), "np.asarray() on 'ticket.host'",
          True),
    "c": ("", "return ticket.out.item()", ("HOT001",), ".item() on 'ticket.out'", True),
    "d": ("import time", "return time.time()", ("DET001", "DET101"), None, True),
    "e": ("import random", "return random.random()", ("DET002", "DET002", "DET101"), None,
          True),
    "f": ("import os", 'return os.environ.get("FDB_TPU_X")', ("ENV001",), None, True),
    "g": ("", "if ticket.out[0]: return 1", ("HOT001",), "truth test (if) on 'ticket.out[0]'",
          False),
    "h": ("", "while (ticket.out > 0).any(): break", ("HOT001",),
          "truth test (while) on '(ticket.out > 0).any()'", False),
    "i": ("", 'return torch.empty_like(ticket.out, device="cpu").copy_(ticket.out)',
          ("HOT001",), ".copy_() on 'ticket.out'", False),
    "j": ("", "return torch.cuda.current_stream().synchronize()", ("HOT001",),
          "torch.cuda.current_stream().synchronize() waits", False),
}
PLANT_SOURCE = '''\
import numpy as np
import torch
{imports}
from foundationdb_tpu_torch.flow.hotpath import cuda_sync_debug_mode


def _peek(ticket):
    {body}


def drive(engine, txns, now, new_oldest_version, parked):
    ticket = engine.dispatch_txns(txns, now, new_oldest_version)
    parked.append(ticket)
    with cuda_sync_debug_mode("error"):
        _peek(ticket)
    return engine.sync_ticket(ticket)
'''
PLANT_TXNS = 256
PLANT_KEYSPACE = 4096


def plant_caught(variant, findings):
    """Whether a variant's unsuppressed findings ("RULE message") are
    exactly its own: its rules, the chain named, its operation named."""
    _imports, _body, rules, op, _guarded = PLANT_VARIANTS[variant]
    chained = [m for m in findings if m.split()[0] in ("HOT001", "DET101")]
    return (tuple(sorted(m.split()[0] for m in findings)) == rules
            and all("(chain: drive -> _peek)" in m for m in chained)
            and (op is None or all(op in m for m in chained)))


def planted_window(torch, et, tk, T, lint_source, variants):
    """Phase 2h's plant: each of `variants` (keys of PLANT_VARIANTS) in
    PLANT_SOURCE, linted by the source tools, then imported from a
    temporary file and run on the card, one batch a variant after a
    warm-up batch, on a TorchConflictSet(key_words=2, h_cap=1 << 10) with
    transfer_guard=True or without it, as the variant says.  The callee
    runs under torch's sync debug mode "error".  Returns, a variant, the
    unsuppressed findings ("RULE message"), the guard's error (None if the
    run passed), the batch's verdicts and the kernels' launches; the
    verdicts are held to the same batches of a CPU twin of each set."""
    rng = np.random.default_rng(14)
    sets = {}
    for guarded in sorted({PLANT_VARIANTS[v][4] for v in variants}):
        eng = et.TorchConflictSet(key_words=KEY_WORDS, h_cap=1 << 10, device="cuda",
                                  transfer_guard=guarded)
        cpu = et.TorchConflictSet(key_words=KEY_WORDS, h_cap=1 << 10, device="cpu")
        txns = gen_txns(T, rng, PLANT_TXNS, 0, PLANT_KEYSPACE)
        got = eng.sync_ticket(eng.dispatch_txns(txns, 10, 0))[0][:PLANT_TXNS].tolist()
        if got != cpu.detect(txns, 10, 0):
            raise AssertionError("plant: the warm-up batch's verdicts differ from the cpu's")
        sets[guarded] = (eng, cpu)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, variant in enumerate(sorted(variants)):
            imports, body, _rules, _op, guarded = PLANT_VARIANTS[variant]
            eng, cpu = sets[guarded]
            src = PLANT_SOURCE.format(imports=imports, body=body)
            found = [f for f in lint_source(src, "window.py") if not f.suppressed]
            path = os.path.join(tmp, f"planted_{variant}.py")
            with open(path, "w", encoding="utf-8") as fh:
                fh.write(src)
            spec = importlib.util.spec_from_file_location(f"planted_{variant}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            now = 11 + i
            txns = gen_txns(T, rng, PLANT_TXNS, now - 2, PLANT_KEYSPACE)
            before = dict(tk.LAUNCHES)
            parked, error = [], None
            try:
                statuses, diverged = mod.drive(eng, txns, now, 0, parked)
            except RuntimeError as e:
                error = f"{type(e).__name__}: {str(e).splitlines()[0]}"
                statuses, diverged = eng.sync_ticket(parked[0])
            if torch.cuda.get_sync_debug_mode() != 0:
                raise AssertionError(f"plant ({variant}): the sync debug mode "
                                     "stayed armed")
            verdicts = statuses[:PLANT_TXNS].tolist()
            if diverged or verdicts != cpu.detect(txns, now, 0):
                raise AssertionError(f"plant ({variant}): the batch's verdicts "
                                     "differ from the cpu's")
            out[variant] = {
                "findings": [f"{f.rule} {f.message}" for f in found],
                "guard": error,
                "aborted": sum(1 for v in verdicts if v != 0),
                "launches": {k: tk.LAUNCHES[k] - before[k] for k in before},
            }
    return out


def source_gate_path(torch, et, tk, T):
    """Phase 2h: the whole source gate (fdblint and perfcheck, one load of
    the tree) over the checkout's port, then the planted window
    (planted_window) in all ten variants.  Fails on an unsuppressed
    finding in the port, on a variant whose findings are not its own
    (plant_caught), and on a planted dispatch that does not launch both
    kernels.  What the
    runtime guard catches is printed, not gated."""
    from foundationdb_tpu_torch.tools.lint import runner

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "foundationdb_tpu_torch")
    t0 = time.perf_counter()
    by_tool = runner.run_source_tools(root)
    dt = time.perf_counter() - t0
    card = torch.cuda.get_device_name(0)
    for line in runner.format_tool_counts(by_tool):
        log(f"source gate: {line}")
    log(f"source gate: fdblint and perfcheck over foundationdb_tpu_torch/ in {dt:.3f} s on "
        f"the card's host (torch {torch.__version__}); card {card}")
    unsup = [f"[{tool}] {f.format()}" for tool, fs in sorted(by_tool.items())
             for f in fs if not f.suppressed]
    if unsup:
        raise AssertionError(f"source gate: {len(unsup)} unsuppressed finding(s): {unsup[:4]}")
    t0 = time.perf_counter()
    plant = planted_window(torch, et, tk, T, runner.lint_source, PLANT_VARIANTS)
    dt = time.perf_counter() - t0
    for variant, r in sorted(plant.items()):
        _imports, body, rules, _op, guarded = PLANT_VARIANTS[variant]
        if not plant_caught(variant, r["findings"]):
            raise AssertionError(f"plant ({variant}) {body}: findings {r['findings']}")
        chain = any(m.split()[0] in ("HOT001", "DET101") for m in r["findings"])
        what = " ".join(rules) + (", chain drive -> _peek" if chain else "")
        if min(r["launches"].values()) < 1:
            raise AssertionError(f"plant ({variant}): launches {r['launches']}")
        guard = "runtime guard" if guarded else "sync debug mode (unguarded set)"
        log(f"plant ({variant}) {body} between dispatch_txns and sync_ticket: static "
            f"caught ({what}); {guard} "
            + (f"caught ({r['guard']})" if r["guard"] else "did not catch (the run passed)")
            + f"; {r['aborted']} of {PLANT_TXNS} aborted, equal to the cpu's; launches "
            f"{r['launches']}; card {card}")
    log(f"plant: {len(plant)} variants in {dt:.3f} s; card {card}")
    return plant


GUARD_BATCHES = 4


def guard_path(torch, api, et, ecpu, hotpath, T, batches, main):
    """Phase 4v: the transfer guard at full width.  Phase 4's state at the
    end of its warm-up (its mirror's snapshot then; each set rehydrates
    from it at its first batch, as 4g's engines load_from phase 4's end
    state) in a guarded and an unguarded ConflictSet at depth 2; phase
    4's first GUARD_BATCHES timed batches through both, the sets taking
    turns batch by batch.  Every batch's verdicts and witnesses equal
    phase 4's, no TransferGuardError, host syncs a batch equal between the
    sets; prints each set's host ms a batch (no claim).  Then what the
    card's sync debug mode refuses, and the planted reads: np.asarray of a
    parked ticket's out and host raises TransferGuardError, and an .item()
    planted in the guarded dispatch raises torch's error, with the mode
    restored after it; the same .item() in the unguarded set's dispatch
    passes."""
    gc.collect()
    snap = main["warm_snapshot"]
    sets = {}
    for label, guard in (("guarded", True), ("unguarded", False)):
        cs = api.ConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, pipeline_depth=2,
                             transfer_guard=guard)
        cs._cpu = ecpu.engine_from_handoff([(snap, b"", None)], snap.oldest_version,
                                           key_words=KEY_WORDS)
        sets[label] = cs
    if sets["guarded"]._cpu.snapshot().to_flat() != snap.to_flat():
        raise AssertionError("guard: the loaded mirror differs from phase 4's")
    stream = [(batches[i], i + WINDOW, i) for i in range(WARM, WARM + GUARD_BATCHES)]
    parked = {k: [] for k in sets}
    secs = {k: 0.0 for k in sets}
    syncs0 = {k: cs._dev.host_syncs for k, cs in sets.items()}
    for txns, now, nov in stream:
        for label, cs in sets.items():
            t0 = time.perf_counter()
            parked[label].append(cs.pipeline_submit(txns, now, nov))
            while cs.pipeline_inflight > 1:
                cs.pipeline_complete_oldest()
            torch.cuda.synchronize()
            secs[label] += time.perf_counter() - t0
    for label, cs in sets.items():
        t0 = time.perf_counter()
        cs.pipeline_drain()
        torch.cuda.synchronize()
        secs[label] += time.perf_counter() - t0
    n = len(stream)
    want = main["digests"][WARM:WARM + n]
    for label, cs in sets.items():
        got = [digest(e.statuses, e.witness) for e in parked[label]]
        if got != want:
            first = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            raise AssertionError(f"guard {label}: batch {WARM + first}'s verdicts or "
                                 f"witnesses differ from phase 4's")
        c = cs.device_metrics()["counters"]
        if c["rehydrates"] != 1 or c["device_faults"] or c["degraded_batches"]:
            raise AssertionError(f"guard {label}: counters {c}")
        if cs.mirror_check()["status"] != "ok":
            raise AssertionError(f"guard {label}: mirror_check")
    syncs = {k: (cs._dev.host_syncs - syncs0[k]) / n for k, cs in sets.items()}
    if syncs["guarded"] != syncs["unguarded"]:
        raise AssertionError(f"guard: host syncs a batch {syncs}")
    card = torch.cuda.get_device_name(0)
    log(f"guard: phase 4's batches {WARM}-{WARM + n - 1} x {PER_BATCH} txns from phase 4's "
        f"state after its warm-up ({snap.boundary_count} keys) through a guarded and an "
        f"unguarded ConflictSet at depth 2 (each rehydrating once), taking turns: verdicts "
        f"and witnesses equal phase 4's, no TransferGuardError; host syncs a batch "
        f"{syncs}; host ms a batch (the first with the rehydration) "
        + ", ".join(f"{k} {secs[k] / n * 1e3:.3f}" for k in sets) + f"; card {card}")
    seen = sync_debug_probe(torch, hotpath)
    log(f"guard: the sync debug mode \"error\" refuses: "
        f"{sorted(k for k, v in seen.items() if v)}; lets pass: "
        f"{sorted(k for k, v in seen.items() if not v)}; card {card}")
    # The planted reads, on small batches after the stream.
    rng = np.random.default_rng(99)
    g, u = sets["guarded"], sets["unguarded"]
    now, nov = stream[-1][1] + 1, stream[-1][2] + 1
    entry = g.pipeline_submit(gen_txns(T, rng, 256, now - WINDOW), now, nov)
    if entry.done or g.pipeline_inflight != 1:
        raise AssertionError("guard: the planted batch is not parked")
    for field in ("out", "host"):
        try:
            np.asarray(getattr(entry.ticket, field))
        except hotpath.TransferGuardError as e:
            if f"DispatchTicket.{field}" not in str(e):
                raise AssertionError(f"guard: the planted read's error names {e}") from e
        else:
            raise AssertionError(f"guard: np.asarray(ticket.{field}) of a parked batch passed")
    g.pipeline_drain()
    real = et._blob_core

    def planted(*args, **kwargs):
        args[4][0].item()  # a hidden host read of the blob inside the dispatch
        return real(*args, **kwargs)

    et._blob_core = planted
    try:
        entry = u.pipeline_submit(gen_txns(T, rng, 256, now - WINDOW), now + 1, nov + 1)
        u.pipeline_drain()
        try:
            g.pipeline_submit(gen_txns(T, rng, 256, now - WINDOW), now + 1, nov + 1)
        except RuntimeError as e:
            if isinstance(e, hotpath.TransferGuardError):
                raise
            message = str(e).splitlines()[0]
        else:
            raise AssertionError("guard: an .item() planted in the armed dispatch passed")
    finally:
        et._blob_core = real
    if torch.cuda.get_sync_debug_mode() != 0 or not entry.done:
        raise AssertionError("guard: the sync debug mode stayed armed, or the unguarded "
                             "set's planted batch did not complete")
    log(f"guard: planted np.asarray(ticket.out) and (ticket.host) of a parked batch raised "
        f"TransferGuardError; an .item() planted in the guarded dispatch raised "
        f"RuntimeError({message!r}), the mode back at 0 after it; the same .item() passed "
        f"in the unguarded set; card {card}")


# ---------------------------------------------------------------------------
# phases 4q and 6q: the Resolver role on the port's event loop
# ---------------------------------------------------------------------------

# A role run's requests: proxies p0 and p1 take turns (batch j from
# p{j % 2}), and within each pair the later batch is sent first, so the
# prevVersion chain parks it.  The proxy of batch ROLE_RETRY_AT sends its
# request a second time right after the original (a retry while parked),
# and the batches of ROLE_STATE_AT carry one state transaction each, which
# the other proxy's next reply must carry.  Sends are ROLE_SEND_GAP
# virtual seconds apart, above the network's latency (at most 0.5 ms), so
# they arrive in the order sent.
ROLE_RETRY_AT = 1
ROLE_STATE_AT = (1, 2)
ROLE_SEND_GAP = 0.001
# Phase 4q's requests: half of phase 4's timed batches, to keep the
# script inside its time target.
ROLE_BATCHES = TIMED // 2


def role_requests(stream, epoch_begin):
    """(send order, requests) of a role run over (txns, now, new_oldest)
    batches: one ResolveTransactionBatchRequest a batch on the version
    chain that starts at epoch_begin."""
    from foundationdb_tpu_torch.client.types import Mutation, MutationType
    from foundationdb_tpu_torch.server.interfaces import ResolveTransactionBatchRequest

    reqs, prev = [], epoch_begin
    for j, (txns, now, _nov) in enumerate(stream):
        state = ([(0, [Mutation(MutationType.SET_VALUE, b"\xff/conf/role%d" % j, b"v%d" % j)])]
                 if j in ROLE_STATE_AT else [])
        reqs.append(ResolveTransactionBatchRequest(
            prev_version=prev, version=now, last_received_version=epoch_begin,
            transactions=txns, state_txns=state, proxy_id=f"p{j % 2}"))
        prev = now
    order = []
    for j in range(0, len(reqs) - 1, 2):
        order += [j + 1] * (2 if j + 1 == ROLE_RETRY_AT else 1) + [j]
    if len(reqs) % 2:
        order.append(len(reqs) - 1)
    return order, reqs


def role_run(cs, stream, epoch_begin, window, seed=17):
    """Serve a stream's requests (role_requests) through the port's
    Resolver(n_proxies=2) over `cs` on a fresh port EventLoop and
    SimNetwork(deep_copy=False).  Returns the role, the requests, every
    batch's reply, the retry's reply, each reply's virtual time, the wall
    seconds from the first send to the last reply, and the role's
    snapshot_json, conflict_witness and signal_snapshot at the end."""
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.metrics import wall_now
    from foundationdb_tpu_torch.rpc.network import SimNetwork
    from foundationdb_tpu_torch.server.resolver import Resolver

    loop = el.EventLoop(seed)
    el.set_event_loop(loop)
    try:
        net = SimNetwork(loop, deep_copy=False)
        role = Resolver(net.process("resolver"), conflict_set=cs, n_proxies=2,
                        epoch_begin_version=epoch_begin,
                        max_write_transaction_life_versions=window)
        proxies = net.process("proxies")
        iface = role.interface()
        order, reqs = role_requests(stream, epoch_begin)
        futs, vt, last = {}, {}, [None]

        async def send_all():
            for j in order:
                key = j if j not in futs else ("retry", j)
                f = iface.resolve.get_reply(proxies, reqs[j])

                def arrived(_f, key=key):
                    vt[key] = loop.now()
                    last[0] = wall_now()

                f.add_callback(arrived)
                futs[key] = f
                await loop.delay(ROLE_SEND_GAP)
            return [await futs[k] for k in sorted(futs, key=str)]

        w0 = wall_now()
        loop.run_until(proxies.spawn(send_all(), "proxies"), timeout_vt=60.0)
        replies = [futs[j].get() for j in range(len(reqs))]
        return dict(role=role, reqs=reqs, replies=replies,
                    retry=futs[("retry", ROLE_RETRY_AT)].get(),
                    vt=[vt[j] for j in range(len(reqs))] + [vt[("retry", ROLE_RETRY_AT)]],
                    wall=last[0] - w0, snapshot=role.metrics.snapshot_json(),
                    witness=json.dumps(role.conflict_witness(), sort_keys=True),
                    signals=role.signal_snapshot())
    finally:
        el.set_event_loop(None)


def role_checks(label, run, n_txn):
    """The role's own records after a run: one cache hit (the retry got the
    original's reply), the state transactions in the other proxy's next
    reply and nowhere else, no stale epoch and no degraded batch, nothing
    queued, the backend ok, and every batch and transaction counted."""
    role, reqs, replies = run["role"], run["reqs"], run["replies"]
    c = role.metrics.snapshot()["counters"]
    n = len(reqs)
    if run["retry"] is not replies[ROLE_RETRY_AT]:
        raise AssertionError(f"{label}: the retry did not get the original's cached reply")
    if c["cache_hits"] != 1 or c["stale_epoch"] or c["degraded_batches"]:
        raise AssertionError(f"{label}: counters {c}")
    if c["batches"] != n or c["transactions"] != n * n_txn:
        raise AssertionError(f"{label}: the registry counts {c['batches']} batches and "
                             f"{c['transactions']} transactions")
    for j, rep in enumerate(replies):
        want = []
        for s in ROLE_STATE_AT:
            if s + 1 < n and j == s + 1:
                committed = int(replies[s].committed[0]) == 2
                want.append((reqs[s].version, [(committed, reqs[s].state_txns[0][1])]))
        if rep.state_mutations != want:
            raise AssertionError(f"{label}: batch {j}'s state mutations {rep.state_mutations}, "
                                 f"expected {want}")
        if rep.degraded:
            raise AssertionError(f"{label}: batch {j} came back degraded")
    sig = run["signals"]
    if role.queue_depth != 0 or sig.queue_depth != 0 or sig.backend_state != "ok":
        raise AssertionError(f"{label}: queue depth {role.queue_depth}, signals {sig}")


def resolver_path(torch, api, ecpu, tk, spans, trace, fr, batches, main):
    """Phase 4q: the Resolver role over phase 4's state and timed batches.
    Phase 4's mirror at the end of its warm-up in one ConflictSet with
    phase 4's settings (it rehydrates from it at its first batch), behind
    the port's Resolver(n_proxies=2) on a port SimNetwork(deep_copy=False)
    and EventLoop, on fresh port hubs.  Phase 4's first ROLE_BATCHES timed
    batches arrive as ResolveTransactionBatchRequests from two proxies
    (role_requests): every
    reply's verdicts and witnesses equal phase 4's, the retry is answered
    from the reply cache, the state transactions reach the other proxy,
    both kernels launch as in phase 4 and the set dispatches every batch,
    mirror_check reads "ok".  Prints the wall seconds and txn/s through the
    role beside phase 4's (no claim), one deep-copied request's host ms,
    the pipeline gauges and stalls, the virtual resolve_seconds
    percentiles and the host syncs a batch.  Returns the launches."""
    from foundationdb_tpu_torch.metrics import wall_now

    gc.collect()
    snap = main["warm_snapshot"]
    cs = api.ConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, pipeline_depth=2)
    cs._cpu = ecpu.engine_from_handoff([(snap, b"", None)], snap.oldest_version,
                                       key_words=KEY_WORDS)
    n = ROLE_BATCHES
    stream = [(batches[i], i + WINDOW, i) for i in range(WARM, WARM + n)]
    epoch = WARM - 1 + WINDOW
    _order, reqs = role_requests(stream[:1], epoch)
    t0 = wall_now()
    copy.deepcopy(reqs[0])
    copy_ms = (wall_now() - t0) * 1e3
    del reqs
    gc.collect()
    eng = cs._dev
    syncs0, dispatches0 = eng.host_syncs, eng.metrics.counter("pipeline_dispatches").value
    hubs = PortHubs(spans, trace, fr)
    for name in tk.LAUNCHES:
        tk.LAUNCHES[name] = 0
    try:
        run = role_run(cs, stream, epoch, WINDOW)
        torch.cuda.synchronize()
    finally:
        hubs.restore()
    launches = dict(tk.LAUNCHES)
    label = "resolver"
    expect = {k: v * n // TIMED for k, v in main["launches"].items()}
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches} in {n} batches, expected {expect} "
                             f"(phase 4's {main['launches']} in {TIMED})")
    role_checks(label, run, PER_BATCH)
    got = [digest(rep.committed, rep.witnesses) for rep in run["replies"]]
    want = main["digests"][WARM:WARM + n]
    if got != want:
        first = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        raise AssertionError(f"{label}: batch {WARM + first}'s verdicts or witnesses differ "
                             f"from phase 4's")
    dispatches = eng.metrics.counter("pipeline_dispatches").value - dispatches0
    c = cs.device_metrics()["counters"]
    if dispatches != n or c["rehydrates"] != 1 or c["device_faults"] or c["degraded_batches"]:
        raise AssertionError(f"{label}: {dispatches} dispatches, counters {c}")
    if eng.cpu_fallbacks != 0:
        raise AssertionError(f"{label}: cpu_fallbacks = {eng.cpu_fallbacks}")
    if len(hubs.hub.spans(name="resolve_batch")) != n:
        raise AssertionError(f"{label}: {len(hubs.hub.spans(name='resolve_batch'))} "
                             f"resolve_batch spans")
    report = cs.mirror_check()
    if report["status"] != "ok":
        raise AssertionError(f"{label}: mirror_check: {report}")
    snap_role = run["role"].metrics.snapshot()
    g, cn = snap_role["gauges"], snap_role["counters"]
    rs = snap_role["histograms"]["resolve_seconds"]
    rehy = sum(s.wall_end - s.wall_start for s in hubs.hub.spans(name="rehydrate"))
    n_txn = n * PER_BATCH
    card = torch.cuda.get_device_name(0)
    log(f"{label}: {n} requests x {PER_BATCH} txns from 2 proxies (each pair's later "
        f"batch sent first, one retry while parked, state transactions in batches "
        f"{list(ROLE_STATE_AT)}) through Resolver(n_proxies=2) over ConflictSet(depth 2) from "
        f"phase 4's state after its warm-up ({snap.boundary_count} keys) on "
        f"SimNetwork(deep_copy=False): replies equal phase 4's verdicts and witnesses, cache "
        f"hits {cn['cache_hits']}, state mutations in the other proxy's next reply, "
        f"stale_epoch {cn['stale_epoch']}, degraded_batches {cn['degraded_batches']}, "
        f"launches {launches}, pipeline_dispatches {dispatches}, mirror_check ok; "
        f"card {card}")
    log(f"{label}: wall {run['wall']:.6f} s from the first request to the last reply: "
        f"{n_txn / run['wall']:.1f} txn/s through the role ({run['wall'] / n * 1e3:.3f} "
        f"ms/request), {n_txn / (run['wall'] - rehy):.1f} txn/s less the first batch's "
        f"rehydration ({rehy * 1e3:.3f} ms), beside phase 4's {main['tps']:.1f} txn/s "
        f"(ConflictSet alone, its {TIMED} timed batches; no claim); one deep-copied request "
        f"{copy_ms:.3f} ms on the host; pipeline_overlap_efficiency "
        f"{g['pipeline_overlap_efficiency']}, host_fraction {g['host_fraction']}, device "
        f"stalls {cn['pipeline_device_stalls']}, host stalls {cn['pipeline_host_stalls']}; "
        f"resolve_seconds (virtual) p50 {rs['median']} p99 {rs['p99']}; host syncs/batch "
        f"{(eng.host_syncs - syncs0) / n}; replies at virtual "
        f"{[round(t, 6) for t in run['vt']]}; card {card}")
    return launches


def roles_vs_cpu(torch, api, T, spans, trace, fr):
    """Phase 6q: phase 6's reduced stream (12 batches of 4,096
    transactions) as role_requests through the port's Resolver over
    ConflictSet on cuda and on cpu at depths 1-3, each on fresh port hubs
    and a fresh loop of one seed: every reply, its virtual time, the
    role's snapshot_json and conflict_witness equal on the two devices,
    and role_checks on each."""
    n_txn, n_batches, window = 4096, 12, 4
    rng = np.random.default_rng(7)
    stream = [(gen_txns(T, rng, n_txn, i, keyspace=200_000), i + window, i)
              for i in range(n_batches)]
    conflicts = 0
    for depth in (1, 2, 3):
        runs = {}
        for device in ("cuda", "cpu"):
            cs = api.ConflictSet(key_words=KEY_WORDS, h_cap=1 << 16, pipeline_depth=depth,
                                 device=device)
            hubs = PortHubs(spans, trace, fr)
            try:
                run = role_run(cs, stream, window - 1, window)
            finally:
                hubs.restore()
            role_checks(f"role depth {depth} on {device}", run, n_txn)
            replies = [([int(x) for x in r.committed], list(r.witnesses), r.degraded,
                        r.state_mutations) for r in run["replies"]]
            runs[device] = (replies, run["vt"], run["snapshot"], run["witness"])
        if runs["cuda"] != runs["cpu"]:
            which = [k for k, a, b in zip(("replies", "virtual times", "snapshot",
                                           "conflict_witness"), runs["cuda"], runs["cpu"])
                     if a != b]
            raise AssertionError(f"role depth {depth}: cuda and cpu differ in {which}")
        conflicts = sum(r[0].count(0) for r in runs["cuda"][0])
    if conflicts == 0:
        raise AssertionError("role: the reduced stream produced no conflicts")
    log(f"role vs cpu: {n_batches} requests x {n_txn} txns from 2 proxies (reordered pairs, a "
        f"retry, 2 state transactions) through Resolver over ConflictSet at depths 1, 2, 3: "
        f"replies, their virtual times, the registry's snapshot and conflict_witness equal on "
        f"cuda and cpu ({conflicts} conflicts); card {torch.cuda.get_device_name(0)}")


def guard_vs_cpu(torch, api, T, faults, hotpath):
    """Phase 6v: the guard at phase 6's reduced shape: ConflictSet(
    transfer_guard=True) at depths 1-3 under phase 6o's dispatch fault, on
    cuda and on cpu, against the same run unguarded on cuda: verdicts,
    witnesses, the injected log, the breaker walk and the exported state
    equal; at depths 2 and 3 np.asarray of the first parked ticket's out
    raises TransferGuardError on both devices."""
    n_txn, batches, window, keyspace = 4096, 12, 4, 200_000
    rng = np.random.default_rng(7)
    stream = [(gen_txns(T, rng, n_txn, i, keyspace=keyspace), i + window, i)
              for i in range(batches)]

    def run(device, depth, guard):
        inj = faults.DeviceFaultInjector()
        inj.script("dispatch", at=3, persist=3)
        cs = api.ConflictSet(key_words=KEY_WORDS, h_cap=1 << 16, device=device,
                             pipeline_depth=depth, fault_injector=inj, transfer_guard=guard)
        entries, raised = [], 0
        for txns, now, nov in stream:
            entries.append(cs.pipeline_submit(txns, now, nov))
            if guard and not raised and not entries[-1].done:
                try:
                    np.asarray(entries[-1].ticket.out)
                except hotpath.TransferGuardError:
                    raised = 1
            while cs.pipeline_inflight > depth - 1:
                cs.pipeline_complete_oldest()
        cs.pipeline_drain()
        keys, vers = cs._dev._merged_host_state()
        return dict(verdicts=[(list(e.statuses), list(e.witness), e.degraded) for e in entries],
                    injected=inj.injected, walk=cs._breaker.transitions,
                    state=(list(cs._cpu.keys), list(cs._cpu.vers), keys, vers,
                           cs._dev.oldest_version),
                    raised=raised)

    for depth in (1, 2, 3):
        want = run("cuda", depth, False)
        for device in ("cuda", "cpu"):
            got = run(device, depth, True)
            for key in ("verdicts", "injected", "walk", "state"):
                if got[key] != want[key]:
                    raise AssertionError(f"guard depth {depth} on {device}: {key} differs "
                                         f"from the unguarded cuda run")
            if got["raised"] != (depth > 1):
                raise AssertionError(f"guard depth {depth} on {device}: the planted read "
                                     f"raised {got['raised']} times")
        planted = ("np.asarray of the first parked ticket's out raised TransferGuardError on "
                   "both" if depth > 1 else "no ticket is parked at depth 1")
        log(f"guard vs cpu depth {depth}: {batches} batches x {n_txn} txns under a dispatch "
            f"outage, transfer_guard on cuda and cpu equal to the unguarded cuda run "
            f"(verdicts, witnesses, injected {want['injected']}, breaker walk "
            f"{[t[1:3] for t in want['walk']]}, mirror and device export); {planted}")


DETERMINISM_BATCHES = 4


def determinism_run(torch, api, tk, spans, trace, fr, stream, settings):
    """One fresh ConflictSet(**settings) at depth 2 over `stream`, driven
    as a Resolver drives it, under fresh port hubs on a clock that counts
    its own reads.  Returns every batch's digest (verdicts and witness),
    the export's digest (keys, versions, count, oldest), the metrics
    snapshot (no wall namespace), spans_json() (no wall stamps) and each
    kernel's launches."""
    ticks = itertools.count()
    hubs = PortHubs(spans, trace, fr, clock=lambda: float(next(ticks)))
    try:
        cs = api.ConflictSet(pipeline_depth=2, **settings)
        for name in tk.LAUNCHES:
            tk.LAUNCHES[name] = 0
        batches = [digest(st, w) for st, w in drive(cs, stream, 2)]
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES)
        keys, vers, n, oldest, base = cs._dev.export_state()
        h = hashlib.sha256(np.ascontiguousarray(keys[:, :n]).tobytes())
        h.update(np.ascontiguousarray(vers[:n]).tobytes())
        h.update(repr((n, oldest, base)).encode())
        return {"batches": batches, "export": h.hexdigest(),
                "snapshot": cs._dev.metrics.snapshot(), "spans": hubs.hub.spans_json(),
                "launches": launches, "rows": n}
    finally:
        hubs.restore()


def determinism_path(torch, api, tk, spans, trace, fr, batches):
    """Phase 6d: two fresh ConflictSets with phase 4's settings over the
    first DETERMINISM_BATCHES full-width batches of phase 4's stream must
    give equal verdicts and witnesses, export, metrics snapshot and spans
    (the wall namespace and span wall stamps left out), with one launch of
    each kernel a batch in each run."""
    card = torch.cuda.get_device_name(0)
    stream = [(batches[i], i + WINDOW, i) for i in range(DETERMINISM_BATCHES)]
    settings = dict(key_words=KEY_WORDS, **path_mode("flat")[1])
    t0 = time.perf_counter()
    runs = [determinism_run(torch, api, tk, spans, trace, fr, stream, settings)
            for _ in range(2)]
    dt = time.perf_counter() - t0
    expect = {name: DETERMINISM_BATCHES for name in tk.LAUNCHES}
    for r in runs:
        if r["launches"] != expect:
            raise AssertionError(f"determinism: launches {r['launches']}, expected {expect}")
    a, b = runs
    for key in ("batches", "export", "snapshot", "spans"):
        if a[key] != b[key]:
            raise AssertionError(f"determinism: the two runs' {key} differ")
    n_spans = a["spans"].count('"name"')
    log(f"determinism: two fresh ConflictSets over phase 4's first {DETERMINISM_BATCHES} "
        f"batches of {PER_BATCH} txns equal: verdicts and witnesses, export ({a['rows']} rows), "
        f"metrics snapshot ({len(a['snapshot']['counters'])} counters, "
        f"{len(a['snapshot']['histograms'])} histograms), spans_json ({n_spans} spans, "
        f"{len(a['spans'])} B); launches {a['launches']} a run; {dt:.3f} s for both; "
        f"card {card}")
    return runs


CHAOS_BUGGIFY_SEED = 6
CHAOS_INJECTOR_SEED = 7
CHAOS_FIRE = 0.05
CHAOS_OUTAGE = range(WARM + 2, WARM + 5)
LEGAL_WALK = {("ok", "degraded"), ("degraded", "probing"), ("probing", "ok"),
              ("probing", "degraded")}
CHAOS_COUNTERS = ("device_faults", "breaker_opens", "breaker_probes", "breaker_closes",
                  "degraded_batches", "rehydrates", "rehydrate_keys_total",
                  "rehydrate_keys_encoded", "cpu_fallback_txns", "pipeline_dispatches",
                  "pipeline_replayed_batches")


def walk_end(label, transitions) -> str:
    """The breaker's last state, after checking that its transitions are a
    legal walk of the state machine from ok."""
    prev = "ok"
    for _seq, frm, to, _reason in transitions:
        if frm != prev or (frm, to) not in LEGAL_WALK:
            raise AssertionError(f"{label}: illegal breaker walk {transitions}")
        prev = to
    return prev


class RehydrateSpans:
    """CUDA events and the host clock around each rehydration of a
    ConflictSet's device history from its mirror, with the keys it loaded."""

    def __init__(self, torch, cs):
        self.torch, self.cs, self.spans = torch, cs, []
        self._rehydrate = cs._rehydrate_from_mirror
        cs._rehydrate_from_mirror = self._timed

    def _timed(self):
        keys = self.cs._dev.metrics.counter("rehydrate_keys_total")
        k0 = keys.value
        a, b = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        self._rehydrate()
        b.record()
        self.spans.append((a, b, time.perf_counter() - t0, keys.value - k0))

    def remove(self):
        """Stop timing; returns [(CUDA-event ms, host ms, keys)]."""
        del self.cs._rehydrate_from_mirror
        self.torch.cuda.synchronize()
        return [(a.elapsed_time(b), host * 1e3, k) for a, b, host, k in self.spans]


def chaos_path(torch, api, batches, tk, faults, buggify, DR, want, obs):
    """Phase 6c(a): phase 4's set, stream and seed under the port's random
    faults at full width.  The buggify sites are armed (activated
    probability 1.0) on a DeterministicRandom, the injector runs in random
    mode, and an open-ended dispatch outage holds batches CHAOS_OUTAGE.
    Every batch's verdicts and witnesses must equal phase 4's (`want`), the
    breaker must walk legally back to ok, each fault must be counted, the
    mirror must check ok, and each kernel must launch once in every batch
    whose submit dispatched it and never in a batch the mirror served.  On
    fresh port hubs whose clock is the batch index: one
    DeviceBackendStateChange event and one breaker.<to> marker span a
    transition, a breaker_open capture for every open the cooldown admits
    (each holding its transition and a span window), every device span
    closed, the replayed ones marked.  Returns the kernels' launches in the
    run."""
    depth = 2
    gc.collect()
    vt = [0.0]
    hubs = PortHubs(*obs, clock=lambda: vt[0])
    buggify.set_buggify_enabled(True, DR(CHAOS_BUGGIFY_SEED), activated_probability=1.0)
    inj = faults.DeviceFaultInjector(rng=DR(CHAOS_INJECTOR_SEED), fire_probability=CHAOS_FIRE)
    cs = api.ConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, pipeline_depth=depth,
                         fault_injector=inj)
    def stream():
        for i in range(WARM + TIMED):
            vt[0] = float(i)
            if i == CHAOS_OUTAGE.start:
                inj.begin_outage("dispatch")
            if i == CHAOS_OUTAGE.stop:
                inj.end_outage("dispatch")
            yield batches[i], i + WINDOW, i

    turns = []  # (batch, kind, seconds, launches so far, rehydrations so far)
    clock = [time.perf_counter()]

    def tick(entry):
        now = time.perf_counter()
        kind = "degraded" if entry.done else "device"  # parked = dispatched
        turns.append((len(turns), kind, now - clock[0], dict(tk.LAUNCHES), len(spans.spans)))
        clock[0] = now

    digests = []
    spans = RehydrateSpans(torch, cs)
    for name in tk.LAUNCHES:
        tk.LAUNCHES[name] = 0
    prev_launches = dict(tk.LAUNCHES)
    t0 = clock[0] = time.perf_counter()
    drive(cs, stream(), depth, sink=lambda st, w: digests.append(digest(st, w)), tick=tick)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(tk.LAUNCHES)
    counters = cs._dev.metrics.snapshot()["counters"]
    reh = spans.remove()
    buggify_cov = buggify.coverage()
    buggify.set_buggify_enabled(False)
    hubs.restore()

    if digests != want:
        first = next(i for i, (a, b) in enumerate(zip(digests, want)) if a != b)
        raise AssertionError(f"chaos: batch {first}'s verdicts or witnesses differ from phase 4's")
    transitions = cs._breaker.transitions
    if walk_end("chaos", transitions) != "ok":
        raise AssertionError(f"chaos: the breaker ends {cs._breaker.state}")
    injected = inj.injected
    if not injected or counters["device_faults"] != len(injected):
        raise AssertionError(f"chaos: {len(injected)} faults injected, device_faults "
                             f"{counters['device_faults']}")
    if counters["rehydrates"] < 1 or len(reh) != counters["rehydrates"]:
        raise AssertionError(f"chaos: rehydrates {counters['rehydrates']}, timed {len(reh)}")
    if not any(site.startswith("device_fault_") for site in buggify_cov["fired_counts"]):
        raise AssertionError(f"chaos: no device fault site fired: {buggify_cov}")
    for i, kind, _s, after, _r in turns:
        before = prev_launches
        for name in tk.LAUNCHES:
            n = after[name] - before[name]
            if n != (1 if kind == "device" else 0):
                raise AssertionError(f"chaos: batch {i} ({kind}) launched {name} {n} times")
        prev_launches = after
    dispatches = counters["pipeline_dispatches"]
    replayed = counters["pipeline_replayed_batches"]
    if any(v != dispatches for v in launches.values()):
        raise AssertionError(f"chaos: launches {launches} != {dispatches} dispatches")
    order_faults = tk.merge_contract_faults("cuda")
    if order_faults:
        raise AssertionError(f"chaos: the merge found {order_faults} order faults")
    t1 = time.perf_counter()
    report = cs.mirror_check()
    check_s = time.perf_counter() - t1
    if report["status"] != "ok":
        raise AssertionError(f"chaos: mirror_check {report}")
    obs_line = chaos_observed(hubs, transitions, counters)

    by_site = {}
    for _seq, site, kind in injected:
        by_site[f"{site}:{kind}"] = by_site.get(f"{site}:{kind}", 0) + 1
    degraded = [i for i, kind, _s, _l, _r in turns if kind == "degraded"]
    # A turn's host time: its submit (dispatch, or the mirror's detect)
    # and the completion of the batch before it.
    device_ms = [s * 1e3 for i, kind, s, _l, r in turns
                 if kind == "device" and r == (turns[i - 1][4] if i else 0)]
    degraded_ms = [s * 1e3 for _i, kind, s, _l, _r in turns if kind == "degraded"]
    timed = turns[WARM:WARM + TIMED]
    timed_s = sum(s for _i, _k, s, _l, _r in timed)
    log(f"chaos: {WARM + TIMED} batches x {PER_BATCH} txns through ConflictSet(h_cap "
        f"{H_CAP}, depth {depth}) under random faults (fire probability {CHAOS_FIRE}, "
        f"buggify seed {CHAOS_BUGGIFY_SEED}, injector seed {CHAOS_INJECTOR_SEED}) and a "
        f"dispatch outage over batches {CHAOS_OUTAGE.start}-{CHAOS_OUTAGE.stop - 1}, in "
        f"{dt:.3f} s: {(WARM + TIMED) * PER_BATCH / dt:.1f} txn/s over the run, "
        f"{TIMED * PER_BATCH / timed_s:.1f} over the timed window (not a claim); every "
        f"batch's verdicts and witnesses equal phase 4's; card {torch.cuda.get_device_name(0)}")
    log(f"chaos: faults {len(injected)} by site and kind {by_site}; injected {injected}; "
        f"buggify coverage {buggify_cov}")
    log(f"chaos: breaker walk {[t[1:] + [t[0]] for t in transitions]}; counters "
        f"{ {k: counters[k] for k in CHAOS_COUNTERS} }")
    log(f"chaos: degraded batches {degraded} ({len(degraded)}); replayed {replayed}; "
        f"device-served {dispatches - replayed}; launches {launches} = dispatches "
        f"{dispatches}, one a dispatching batch, none a degraded one")
    log("chaos: rehydrations (CUDA-event ms, host ms, keys): "
        + "; ".join(f"{d:.3f}, {h:.3f}, {k}" for d, h, k in reh))
    log(f"chaos: host ms a turn: device-served {np.mean(device_ms):.3f} (median "
        f"{np.median(device_ms):.3f}, {len(device_ms)} turns without a rehydration), degraded "
        f"{np.mean(degraded_ms):.3f} (median {np.median(degraded_ms):.3f}, "
        f"{len(degraded_ms)} turns); each turn "
        + ", ".join(f"{i} {k} {s * 1e3:.0f}" for i, k, s, _l, _r in turns))
    log(f"chaos: mirror_check ok ({report['boundaries']} boundaries, {check_s:.3f} s)")
    log(obs_line)
    return launches


def chaos_observed(hubs, transitions, counters) -> str:
    """Phase 6c(a)'s span, event and capture checks; returns its log line."""
    events = [e for e in hubs.col.events if e["Type"] == "DeviceBackendStateChange"]
    if [[e["seq"], e["from"], e["to"], e["reason"]] for e in events] != transitions:
        raise AssertionError(f"chaos: DeviceBackendStateChange events {events} against the "
                             f"transitions {transitions}")
    marks = hubs.hub.spans(role="DeviceBreaker")
    if [sp.name for sp in marks] != [f"breaker.{t[2]}" for t in transitions]:
        raise AssertionError(f"chaos: breaker marker spans {[sp.name for sp in marks]}")
    # The opens the cooldown admits, on the batch-index clock.
    admitted, last = [], None
    for e in events:
        if (e["from"], e["to"]) == ("ok", "degraded"):
            if last is None or not 0 <= e["Time"] - last < hubs.rec.cooldown:
                admitted.append(e["seq"])
                last = e["Time"]
    caps = [c for c in hubs.rec.captures if c["trigger"] == "breaker_open"]
    if [c["detail"]["seq"] for c in caps] != admitted[-hubs.rec.captures.maxlen:]:
        raise AssertionError(f"chaos: breaker_open captures {[c['detail'] for c in caps]}, "
                             f"admitted opens {admitted}")
    for c in caps:
        if (c["transitions"][-1][0] != c["detail"]["seq"]
                or c["transitions"][-1][1:3] != ["ok", "degraded"]
                or not any(c["spans"].values())):
            raise AssertionError(f"chaos: a capture lacks its transition or spans: {c['detail']}")
    dev = hubs.hub.spans(name="device")
    replayed = sum("replayed" in sp.attrs for sp in dev)
    faulted = sum("fault" in sp.attrs for sp in dev)
    if (not all(sp.done for sp in dev) or len(dev) != counters["pipeline_dispatches"]
            or replayed != counters["pipeline_replayed_batches"]):
        raise AssertionError(f"chaos: {len(dev)} device spans ({replayed} replayed) against "
                             f"{counters['pipeline_dispatches']} dispatches "
                             f"({counters['pipeline_replayed_batches']} replayed)")
    return (f"chaos spans and events: {len(events)} DeviceBackendStateChange events and "
            f"breaker marker spans, one a transition; breaker_open captures at breaker seqs "
            f"{[c['detail']['seq'] for c in caps]} (opens admitted by the {hubs.rec.cooldown} s "
            f"cooldown on the batch-index clock: {admitted}), each with its transition and "
            f"{sum(len(v) for v in caps[0]['spans'].values()) if caps else 0} spans in the first; "
            f"device spans {len(dev)}, all closed: {replayed} replayed (a parked batch behind a "
            f"faulted dispatch), {faulted} with fault (a dispatch fault raises before its "
            f"batch's device span opens)")


def chaos_vs_cpu(torch, api, sr, T, faults, buggify, DR, keylib):
    """Phase 6c(b): the random mode at phase 6's reduced shape (12 batches of
    4,096 transactions), for ConflictSet and for a 4-shard
    ShardedTorchConflictSet (per-shard sites), on cuda and on cpu from the
    same seeds: the injected log, every breaker walk, the counters, the
    verdicts and the witnesses must be equal, and the flat set's verdicts
    equal ConflictSet(backend="cpu")'s."""
    n_txn, batches, window, keyspace = 4096, 12, 4, 200_000
    rng = np.random.default_rng(7)
    stream = [(gen_txns(T, rng, n_txn, i, keyspace=keyspace), i + window, i)
              for i in range(batches)]
    want = drive(api.ConflictSet(backend="cpu", key_words=KEY_WORDS), stream, 1)
    split = keylib.uniform_int_split_keys(4, keyspace, KEY_BYTES)
    for kind in ("flat", "sharded"):
        runs = {}
        for device in ("cuda", "cpu"):
            buggify.set_buggify_enabled(True, DR(4), activated_probability=1.0)
            inj = faults.DeviceFaultInjector(rng=DR(104), fire_probability=0.3)
            if kind == "flat":
                cs = api.ConflictSet(key_words=KEY_WORDS, h_cap=1 << 14, device=device,
                                     fault_injector=inj)
                out = drive(cs, stream, 2)
                breakers = [cs._breaker]
                counters = dict(cs.device_metrics()["counters"])
                # The pinned readback buffers, which only a CUDA run has.
                counters.pop("host_allocs")
            else:
                cs = sr.ShardedTorchConflictSet(split, key_words=KEY_WORDS, h_cap=1 << 12,
                                                device=device, fault_injector=inj)
                out = [(cs.detect(txns, now, nov), list(cs.last_witness))
                       for txns, now, nov in stream]
                breakers = cs._breakers
                counters = cs.device_metrics()["counters"]
            for k, b in enumerate(breakers):
                walk_end(f"chaos {kind} on {device}, breaker {k}", b.transitions)
            runs[device] = (out, inj.injected, [b.transitions for b in breakers], counters,
                            buggify.coverage())
        buggify.set_buggify_enabled(False)
        if runs["cuda"] != runs["cpu"]:
            which = [k for k, a, b in zip(("verdicts", "injected", "transitions", "counters",
                                           "coverage"), runs["cuda"], runs["cpu"]) if a != b]
            raise AssertionError(f"chaos {kind}: cuda and cpu differ in {which}")
        out, injected, transitions, c, cov = runs["cuda"]
        if kind == "flat" and out != want:
            raise AssertionError("chaos flat: verdicts/witnesses differ from the CPU backend's")
        if not injected or not any(transitions):
            raise AssertionError(f"chaos {kind}: injected {injected}, transitions {transitions}")
        sites = sorted({site for _q, site, _k in injected})
        log(f"chaos {kind} vs cpu: {batches} batches x {n_txn} txns"
            + (", 4 shards" if kind == "sharded" else "")
            + f", random faults (fire probability 0.3), identical on cuda and cpu "
            f"(verdicts, witnesses, injected log of {len(injected)} faults at sites {sites}, "
            f"breaker walks {[[t[1:3] for t in w] for w in transitions]}, counters, coverage "
            f"{cov['fired_counts']}); grows {c['grows']}")


# ---------------------------------------------------------------------------


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from foundationdb_tpu_torch.conflict import _build, api
    from foundationdb_tpu_torch.conflict import device_faults as faults
    from foundationdb_tpu_torch.conflict import engine_cpu as ecpu
    from foundationdb_tpu_torch.conflict import engine_torch as et
    from foundationdb_tpu_torch.conflict import keys as keylib
    from foundationdb_tpu_torch.conflict import kernels as tk
    from foundationdb_tpu_torch.conflict import phase_attribution as pa
    from foundationdb_tpu_torch.conflict.types import TransactionConflictInfo as T
    from foundationdb_tpu_torch.flow import buggify
    from foundationdb_tpu_torch.flow import flight_recorder as fr
    from foundationdb_tpu_torch.flow import hotpath
    from foundationdb_tpu_torch.flow import spans
    from foundationdb_tpu_torch.flow import trace
    from foundationdb_tpu_torch.flow.rng import DeterministicRandom as DR
    from foundationdb_tpu_torch.ops import rangequery as rq
    from foundationdb_tpu_torch.parallel import sharded_resolver as sr

    profile = "--profile" in argv
    stamps = "--stamps" in argv
    clock = [time.perf_counter()] * 2

    def phase_done(name):
        """Log a phase's host seconds and the script's so far."""
        now = time.perf_counter()
        log(f"phase {name}: {now - clock[1]:.1f} s ({now - clock[0]:.1f} s in all)")
        clock[1] = now

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"card: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # 2. build
    secs, logs = _build.timed_build()
    for name, text in logs.items():
        log(f"build {name}:\n{text.strip()}")
    log(f"build: {secs:.3f} s")
    # 2c. the program table on the card; 2g. the structural check there
    program_table(torch, et)
    torchir_path(torch)
    # 2h. the source gate (fdblint and perfcheck) over the port, and the
    # planted window
    source_gate_path(torch, et, tk, T)

    # 3. kernels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device="cuda")
    rows = [check_phase1(torch, tk, keylib, rq, flush, gen),
            check_merge(torch, tk, flush, gen)]
    check_phase1_skewed(torch, tk, keylib, rq, flush, gen)
    rows[0]["tiered"] = [check_phase1_tiers(torch, tk, keylib, rq, flush, gen)]
    rows[1]["tiered"] = check_tiered_merges(torch, tk, et, keylib, flush, gen)
    rows[0]["sharded"] = [check_phase1_shard(torch, tk, keylib, rq, flush, gen)]
    rows[1]["sharded"] = [check_merge_shard(torch, tk, flush, gen)]
    if stamps:
        search_stamps(torch, keylib, rq, flush, gen)
    del flush
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.6f}"
        log(f"kernel {r['name']}: kernel_ms {r['ms']:.6f} plain_ms {r['plain_ms']:.6f} "
            f"bound_us {r['bound_ms'] * 1e3:.3f} ({r['bound_by']}, {r['bytes']} B) "
            f"library_ms {lib} max_abs_err {r['max_abs_err']} ({r['detail']}) "
            f"[{kind}, {smi}]")
        for t in r["tiered"]:
            log_shape(r["name"], "tiered", t, f"{kind}, {smi}")
        for t in r["sharded"]:
            log_shape(r["name"], "sharded", t, f"{kind}, {smi}")
    phase_done("1-3")

    # 4. the main path, flat; 4a. its step attributed by phase; 4g. the
    # 2level search from its end state; then 4w (witness-free), 4c
    # (witness-free, coalesced mirror apply), 4e (amortized flat eviction)
    # and 4t (tiered)
    batches = bench_batches(T)
    obs = (spans, trace, fr)
    main = main_path(torch, api, batches, tk, rq, et, profile, obs=obs)
    launches, digests = main["launches"], main["digests"]
    phase_done("4 and 4o")
    launches_attribution, busy = attribution_path(torch, et, tk, pa, spans, main["cs"]._dev,
                                                  main["extra"][0][0])
    search_path(torch, et, tk, rq, main["cs"], *main["extra"][1])
    del main["cs"], main["extra"]
    phase_done("4a and 4g")
    guard_path(torch, api, et, ecpu, hotpath, T, batches, main)
    phase_done("4v")
    # 4q. the Resolver role over phase 4's state and timed batches
    launches_resolver = resolver_path(torch, api, ecpu, tk, spans, trace, fr, batches, main)
    del main["warm_snapshot"]
    phase_done("4q")
    others, stats = {}, {"main": main["stats"]}
    for mode in ("witness_free", "coalesced", "amortized", "tiered"):
        run = main_path(torch, api, batches, tk, rq, et, profile, mode=mode, want=main)
        label = path_mode(mode)[0]
        stats[label] = run["stats"]
        if mode == "witness_free":
            log_beside(label, stats[label], stats, "main")
        if mode == "coalesced":
            log_beside(label, stats[label], stats, "main")
            log_beside(label, stats[label], stats, "witness-free")
        others[mode] = run["launches"]
        del run
        phase_done({"witness_free": "4w", "coalesced": "4c", "amortized": "4e",
                    "tiered": "4t"}[mode])
    # 4s. the sharded resolver's main path; 4r. resharded live
    launches_sharded, sharded_set, rng = sharded_path(torch, sr, tk, et, keylib, obs)
    phase_done("4s")
    launches_resharded = resharded_path(torch, tk, et, sharded_set, rng, obs)
    del sharded_set
    phase_done("4r")
    # 5-6. held against the CPU
    versus_cpu(torch, et)
    conflictset_vs_cpu(torch, api, T, faults)
    lost_card_codes(torch)
    tiered_conflictset_vs_cpu(torch, api, T, faults)
    ablation_vs_cpu(torch, api, et, pa, T, faults)
    settings_vs_cpu(torch, api, et, sr, tk, T, keylib)
    sharded_vs_cpu(torch, sr, faults, keylib)
    resharded_vs_cpu(torch, sr, faults, keylib)
    phase_done("5-6r")
    spans_vs_cpu(torch, api, sr, T, faults, keylib, spans, trace, fr)
    phase_done("6o")
    guard_vs_cpu(torch, api, T, faults, hotpath)
    phase_done("6v")
    roles_vs_cpu(torch, api, T, spans, trace, fr)
    phase_done("6q")
    # 6d. two runs of one stream on the card give equal records
    determinism_path(torch, api, tk, spans, trace, fr, batches)
    phase_done("6d")
    # 6c. chaos on the card: random faults at full width, then replayed
    # on cuda and cpu at the reduced shape
    launches_chaos = chaos_path(torch, api, batches, tk, faults, buggify, DR, digests, obs)
    del batches
    chaos_vs_cpu(torch, api, sr, T, faults, buggify, DR, keylib)
    phase_done("6c")
    # 4a's device busy under the profiler, after every timed phase
    attribution_busy(torch, et, pa, *busy)
    phase_done("busy")
    del busy

    # 7. result
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    shape_keys = ("what", "max_abs_err", "ms", "warm_ms", "plain_ms", "bound_ms",
                  "bound_by", "library_ms")
    for r in rows:
        r["launches"] = launches[r["name"]]
    log(json.dumps({"kernels": [
        dict({k: r[k] for k in keys}, launches_tiered=others["tiered"][r["name"]],
             launches_amortized=others["amortized"][r["name"]],
             launches_witness_free=others["witness_free"][r["name"]],
             launches_coalesced=others["coalesced"][r["name"]],
             launches_attribution=launches_attribution[r["name"]],
             launches_sharded=launches_sharded[r["name"]],
             launches_resharded=launches_resharded[r["name"]],
             launches_chaos=launches_chaos[r["name"]],
             launches_resolver=launches_resolver[r["name"]],
             tiered=[{k: t[k] for k in shape_keys} for t in r["tiered"]],
             sharded=[{k: t[k] for k in shape_keys} for t in r["sharded"]])
        for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
