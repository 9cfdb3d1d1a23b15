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
               phase 4's first 2 timed batches as
               ResolveTransactionBatchRequests from proxies p0 and p1, the
               later batch sent first (the prevVersion chain parks it),
               batch 1 sent again while parked, a state transaction in
               batch 0: every
               reply's verdicts and witnesses equal phase 4's, the retry
               gets the cached reply (cache_hits 1), the state mutation
               reaches the other proxy's reply, stale_epoch and
               degraded_batches 0, phase 4's launches a batch, 2
               dispatches, queue depth 0, backend "ok", mirror_check "ok",
               2 batches and 131,072 transactions counted.  Prints the wall seconds
               from the first request to the last reply and txn/s through
               the role beside phase 4's (no claim), one deep-copied
               request's host ms, the pipeline gauges and stalls, the
               virtual resolve_seconds p50/p99 and host syncs a batch
  4k. cluster  the commit path through the port's SimCluster(n_proxies=2,
               n_tlogs=2, n_storages=1, buggify=False) on
               SimNetwork(deep_copy=False): resolver 0's set is 4q's
               (phase 4's state after its warm-up); one empty commit lifts
               the committed version above that state's newest, then 2
               waves (4 took 80.9 s on an H100's host), wave k
               phase 4's timed batch 52 + k as 65,536
               commits (its read and write range and one SET_VALUE of the
               write range's begin key) alternating between the proxies,
               so each proxy cuts one full batch of 32,768, read at the
               GRV taken before wave k - 1: every resolve request replayed
               through a host CpuConflictSet from the same state gives the
               same verdicts and witnesses, each acknowledged commit gets
               its batch's version and each conflicted one not_committed
               with its witness's version and read range, the key range
               read back in pages equals the acknowledged writes, both
               tlogs acknowledged every version with its SET_VALUEs, one
               launch of each kernel a batch, 0 faults, degraded batches
               and fallbacks, mirror_check "ok", the proxies count every
               commit and conflict, acked_commit marks the last ack.
               Prints commits/s beside phase 4's txn/s (no claim), each
               wave's wall by the proxies' phase spans, the conflict
               set's and the storage apply's share, the read-back, host
               syncs a batch, the conflict rate and the batch versions
  4n. client   the client on 4k's cluster and set, right after 4k's
               waves: clients from c.database() run the Cycle workload on a
               ring of 4,096 nodes (keys b"c/%04d", 6 bytes: 4k's key_words=2
               set takes 8), loaded by 64 transactions that read every key
               they set (so the client adds no 14-byte self-conflict key),
               then 1,024 actors x 2 read-modify-write ops, once from
               Database(witness_retry=False) and once from
               Database(witness_retry=True), each followed by the ring's
               check.  Every resolve request replayed through 4k's host
               CpuConflictSet gives the same verdicts and witnesses; in the
               load and in each arm each kernel launches once a resolve
               batch, every batch is a device dispatch, and no fault,
               degraded batch or fallback happens and no batch meets the
               long-key side table.  Prints for each arm the commits, not_committed,
               retries and witness_hint_retries, the GRV calls against the
               proxies' GRV requests, the resolve batches and their sizes,
               the wall and commits/s beside 4k's and phase 4's (no claim)
  4f. durable  FoundationDB's restarting test on SimCluster(durable=True,
               buggify=False) (the port's fileio: simulated files under
               KillMode.FULL_CORRUPTION, the tlog's disk queue and spill
               B-tree, the storage's memory engine): resolver 0's set is
               a ConflictSet with phase 4's settings and transfer_guard=
               True from phase 4's warm-up state, lifted past its newest
               version by one empty commit; 4n's ring (4,096 nodes, loaded
               by 64 transactions that read what they set), then twice
               1,024 actors x 2 Cycle ops, one more commit held in flight
               at the set, crash_and_recover() (every process killed, each
               unsynced write settled by the loop's rng, an epoch jump of
               100,000,000 versions, the recovery transaction) and the
               ring's check.  Each ring one cycle and equal to every
               acknowledged commit's writes applied in version order;
               every batch the set decided, before and after each crash,
               replayed equal on a host CpuConflictSet from the same
               state; every batch on the card and every ticket synced
               once, in order (the one in flight at a kill by the next
               Resolver); launches = pipeline_dispatches = batches; no
               fault, degraded batch, fallback or long-key batch;
               mirror_check "ok"; the first batch after each recovery
               drops every older row (about 2.9 M after the first crash).
               Prints each arm's commits, not_committed, retries, batches,
               wall and commits/s beside 4n's arms (no claim), each
               recovery's host seconds, records replayed, disk bytes by
               machine, in-flight batches and evicted rows, and rebases
  4m. acceptance  RandomReadWrite (BASELINE.json config 3), WriteDuringRead
               (config 2) and FuzzApi through the client on SimCluster(
               n_proxies=1, buggify=False) over a card set at key_words=4
               and phase 4's h_cap: every resolve request replayed equal on
               the host, each kernel once a resolve batch, the long-key
               side table exactly where the replay says; prints each
               step's commits, conflicts, retries, batches and commits/s
               (no claim)
  4b. admission  admission control and data distribution on
               SimCluster(n_proxies=2, n_tlogs=2, n_storages=3,
               buggify=False) over a card set with phase 4's settings and
               warm-up state and a fault injector: the port's Ratekeeper
               on both proxies, 4n's ring, then 48 clients x 48 Cycle ops
               beside RandomMoveKeysWorkload(moves=6) and a DD role, with a
               dispatch outage held 0.25 virtual s: the rate ok, at most
               the degraded cap while the breaker is open, ok again; the
               read versions within each rate's budget; every resolve
               request replayed equal on the host; each kernel once in a
               card-served batch and never in a mirror-served one; the
               long-key side table exactly where the replay says; every
               acknowledged write on every storage of its shard's team.
               Prints the rate's samples, transitions, read versions by
               rate, commits/s by state, DD's moves and splits (no claim)
  4w. witness-free  phase 4's timed batches through ConflictSet(
               witness=False), its mirror from phase 4's state after the
               warm-up (the device rehydrated from it before the timed
               batches, as in 4c, 4e and 4t; the warm-up replay was 60-70
               s of each): every batch's verdicts equal phase 4's and
               every witness is [], decode_witness never runs (a counter
               around it in this script), and phase 4's checks (launches,
               no fallback, mirror_check "ok", no growth).  Prints phase
               4's columns beside phase 4's own
  4c. coalesced  4w with mirror_coalesce="auto" (a fold every 2 batches at
               depth 2): the same checks, 4 note_synced calls and 4 folds
               in the 8 timed batches; prints the mirror apply, fold and
               note_synced ms beside phase 4's
  4e. amortized  phase 4's timed batches through ConflictSet(key_words=2,
               h_cap=3,538,944, evict_every=4) at depth 2 (the bench's
               evict4 arm), from phase 4's state after the warm-up as 4w:
               every batch's verdicts and witnesses
               equal phase 4's, one launch of each kernel a batch (8 + 8
               in the timed 8), an eviction every 4th batch, mirror_check
               "ok" (below_window_keys printed), no growth, no CPU
               fallback.  Prints txn/s and the device span of evicting and
               keeping batches apart
  4t. tiered   phase 4's timed batches through ConflictSet(history=
               "tiered", evict_every=4, delta_cap=655,360, h_cap=3,538,944)
               at depth 2 (the bench's tiered4 settings), from phase 4's
               state after the warm-up as 4e: every batch's verdicts and
               witnesses equal phase 4's; compactions on the 4th and 8th
               timed batches (phase 4's 55 and 59), so the search
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
  6k. cluster vs cpu  the commit script of tests/test_torch_cluster.py
               (commit_script: GRVs, sets, a clear, atomic adds,
               versionstamps, a conflict, a state transaction, a too-old
               commit, reads at several versions, a future read, a watch)
               through SimCluster(n_proxies=2, n_resolvers=2, n_tlogs=2,
               buggify=True) with resolver 0's ConflictSet (the CPU
               differential's shape: key_words 3, h_cap 1,024) at depths
               1-3 (the too-old tail after 6 s of virtual idle at depth 3
               only), on cuda and on cpu: every reply and its virtual
               time, the
               sequencer, tlogs, storage window, every role's registry
               snapshot and each resolver's witness block and state equal
  6n. client vs cpu  one client script through SimCluster(n_resolvers=2,
               n_proxies=2, buggify=True) at depths 1-3 on cuda and on cpu,
               every resolver over ConflictSet(key_words=4, h_cap=1,024):
               a ResolverBalancer(min_ops=10, ratio=1.2) round every 0.15 s
               beside run_workloads of Cycle (the reference's own setup,
               whose blind writes carry 14-byte self-conflict keys),
               AtomicLedger, WriteSkew and LockDatabase (lock and unlock):
               every read, commit, error and retry with its virtual time,
               the clients' state, the ring, the balancer's splits and
               moves, the workloads, the roles' registries and the loop's
               end equal on the two devices; each ring one cycle, at least
               one move; on cuda each kernel launched once in every
               resolve batch and the card served every one (the
               balancer's 20-byte resolverSplit key, past the card's 16,
               goes through the long-key side table: those batches are
               counted, and none is served by the host)
  6f. durable vs cpu  4f's script at the reference rig's shape (key_words
               3, h_cap 1,024; a 64-node ring, 32 actors x 2 ops, two
               crashes) through SimCluster(durable=True, buggify=True) at
               depths 1-3, on cuda and on cpu: every read, commit and retry
               with its virtual time, every file's bytes and pending writes
               on every machine after each crash, the batches in flight at
               each kill, every batch's verdicts and witnesses, the
               storage's rows, the tlog, the exported set state and the
               loop's end and next rng draw equal
  6m. acceptance vs cpu  configs 2 and 3 at the reference's exact shapes
               and seeds through the port's SimCluster at depths 1-3 on
               cuda and on cpu: the records equal, and at depth 1 equal to
               the host engine's
  6b. admission vs cpu  the twins of tests/test_ratekeeper.py's resolver
               signals case and tests/test_dd_role.py's hot-shard case at
               their seeds through SimCluster at depths 1-3, and a 4-shard
               ShardedTorchConflictSet with one shard faulting under a
               Ratekeeper, on cuda and on cpu: every read, commit and
               retry, the rate series and transitions, DD's log, each
               storage's rows and the loop's end equal; the sharded rate
               0.8125 x max_tps while the sick shard's breaker is open
  6d. determinism  two fresh ConflictSets with phase 4's settings over the
               first 4 batches of phase 4's stream, each under fresh port
               hubs on a clock that counts its own reads: verdicts and
               witnesses, the export (keys, versions, count, oldest),
               metrics.snapshot() (no wall namespace) and spans_json()
               (no wall stamps) equal; one launch of each kernel a batch
  6c. chaos    (a) phase 4's ConflictSet, stream and seed (its 8 timed
               batches of 65,536 transactions from its state after the
               warm-up, at h_cap 3,145,728, depth 2) under
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
               batches; launches_chaos: phase 6c(a)'s 8 batches;
               launches_resolver: phase 4q's 2 requests;
               launches_cluster: phase 4k's, over its batches_cluster
               resolve batches, empty_batches_cluster of them empty (an
               empty batch launches both kernels too); launches_client:
               phase 4n's (the ring's load and both arms), over its
               batches_client resolve batches; launches_workloads: phase
               4m's three steps, over its batches_workloads;
               launches_durable: phase 4f's, over its batches_durable
               resolve batches; launches_admission: phase 4b's, over its
               batches_admission card-served resolve batches
               (degraded_batches_admission served by the mirror); tiered and
               sharded: those shapes' times), then {"ok": true, ...}

Imports nothing of JAX and nothing of the foundationdb_tpu package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
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


def warm_engine(ecpu, snap):
    """A host engine holding `snap` (phase 4's state after its warm-up
    batches), as a handoff loads it: the mirror a set starts from."""
    return ecpu.engine_from_handoff([(snap, b"", None)], snap.oldest_version,
                                    key_words=KEY_WORDS)


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
              obs=None, warm_from=None, ecpu=None):
    """The bench stream through ConflictSet at depth 2, as a Resolver
    serves it, in one of path_mode's modes, on the bench stream's
    `batches` (bench_batches).  Every mode but the flat one must give
    every batch's verdicts as `want` (phase 4's result), and its witnesses
    too where the witness is on (a witness-free mode's are all []).
    Returns a dict: launches of the timed batches, txn/s, every batch's
    digest (verdicts and witness) and verdict digest, the set, the 4
    extra batches, and the stats its log line prints.  With `obs` (the
    spans, trace and flight_recorder modules), the timed batches are phase
    4o's (SpanArms).  With `warm_from` (phase 4's mirror snapshot after its
    warm-up; `ecpu` the engine_cpu module) the set's mirror starts from it
    and the device rehydrates from it before the timed batches, in place
    of the WARM warm-up batches (a depth cut: phase 4's batches 52-59
    still meet a full window)."""
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
    n_warm = 0 if warm_from is not None else WARM
    decodes = DecodeCalls(et)
    try:
        t0 = time.perf_counter()
        if warm_from is not None:
            cs._cpu = warm_engine(ecpu, warm_from)
            cs._cpu.coalesce_window = window
            cs._rehydrate_from_mirror()  # what the first dispatch would do, before the clock
            torch.cuda.synchronize()
            log(f"{label}: from phase 4's state after its {WARM} warm-up batches "
                f"({warm_from.boundary_count} keys, rehydrated onto the card) in "
                f"{time.perf_counter() - t0:.3f} s")
        else:
            drive(cs, stream[:WARM], depth, sink=sink)
            torch.cuda.synchronize()
            log(f"{label}: {WARM} warm-up batches through ConflictSet in "
                f"{time.perf_counter() - t0:.3f} s, boundaries (bound) "
                f"{eng.boundary_count_bound}")
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
    if len(pairs) != n_warm + TIMED:
        raise AssertionError(f"{label}: {len(pairs)} batches answered of {n_warm + TIMED}")
    digests = [d for d, _v, _e in pairs]
    verdicts = [v for _d, v, _e in pairs]
    if witness:
        if any(n != PER_BATCH for _d, _v, n in pairs[n_warm:]):
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
        theirs = theirs[WARM - n_warm : WARM + TIMED]
        if mine != theirs:
            first = next(i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b)
            raise AssertionError(f"{label}: batch {first + WARM - n_warm}'s verdicts or "
                                 f"witnesses differ from the flat path's")
    counters = m.snapshot()["counters"]
    for name in ("device_faults", "breaker_opens", "degraded_batches", "cpu_fallback_txns",
                 "pipeline_replayed_batches"):
        if counters[name] != 0:
            raise AssertionError(f"{label}: {name} = {counters[name]}")
    if counters["pipeline_dispatches"] != n_warm + TIMED:
        raise AssertionError(f"{label}: pipeline_dispatches {counters['pipeline_dispatches']} "
                             f"!= {n_warm + TIMED} batches submitted")
    if tiered and counters["major_compactions"] != (n_warm + TIMED) // EVICT_EVERY:
        raise AssertionError(f"{label}: {counters['major_compactions']} compactions in "
                             f"{n_warm + TIMED} batches")
    if amortized and len(major_ms) != TIMED // EVICT_EVERY:
        raise AssertionError(f"{label}: {len(major_ms)} evicting batches in the {TIMED} timed")
    wall = m.snapshot(include_wall=True)["wall"]

    def wall_ms(name, samples):
        # A set started from phase 4's state has timed nothing before.
        w0 = wall0.get(name, {"count": 0, "seconds": 0.0})
        n = wall[name]["count"] - w0["count"]
        if n != samples:
            raise AssertionError(f"{label}: {name}: {n} samples in {TIMED} timed batches, "
                                 f"expected {samples}")
        return (wall[name]["seconds"] - w0["seconds"]) * 1e3

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
        cs._cpu = warm_engine(ecpu, snap)
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
# Phase 4q's requests: one pair of phase 4's timed batches, to keep the
# script inside its 900 s time target (with 8 the script read 958.3 s on
# an NVIDIA H100 80GB HBM3's host, with 4 and phase 4k 907.0 s), with the
# retry of batch 1 and one state transaction, in batch 0, which batch 1's
# reply carries to proxy p1.
ROLE_BATCHES = 2
ROLE_STATE_4Q = (0,)


def role_requests(stream, epoch_begin, state_at=ROLE_STATE_AT):
    """(send order, requests) of a role run over (txns, now, new_oldest)
    batches: one ResolveTransactionBatchRequest a batch on the version
    chain that starts at epoch_begin."""
    from foundationdb_tpu_torch.client.types import Mutation, MutationType
    from foundationdb_tpu_torch.server.interfaces import ResolveTransactionBatchRequest

    reqs, prev = [], epoch_begin
    for j, (txns, now, _nov) in enumerate(stream):
        state = ([(0, [Mutation(MutationType.SET_VALUE, b"\xff/conf/role%d" % j, b"v%d" % j)])]
                 if j in state_at else [])
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


def role_run(cs, stream, epoch_begin, window, seed=17, state_at=ROLE_STATE_AT):
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
        order, reqs = role_requests(stream, epoch_begin, state_at)
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


def role_checks(label, run, n_txn, state_at=ROLE_STATE_AT):
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
        for s in state_at:
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
    cs._cpu = warm_engine(ecpu, snap)
    n = ROLE_BATCHES
    stream = [(batches[i], i + WINDOW, i) for i in range(WARM, WARM + n)]
    epoch = WARM - 1 + WINDOW
    _order, reqs = role_requests(stream[:1], epoch, ROLE_STATE_4Q)
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
        run = role_run(cs, stream, epoch, WINDOW, state_at=ROLE_STATE_4Q)
        torch.cuda.synchronize()
    finally:
        hubs.restore()
    launches = dict(tk.LAUNCHES)
    label = "resolver"
    expect = {k: v * n // TIMED for k, v in main["launches"].items()}
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches} in {n} batches, expected {expect} "
                             f"(phase 4's {main['launches']} in {TIMED})")
    role_checks(label, run, PER_BATCH, ROLE_STATE_4Q)
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
        f"{list(ROLE_STATE_4Q)}) through Resolver(n_proxies=2) over ConflictSet(depth 2) from "
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


# ---------------------------------------------------------------------------
# phases 4k and 6k: the commit path through the port's SimCluster
# ---------------------------------------------------------------------------

# Phase 4k's waves: phase 4's timed batches WARM .. WARM + CLUSTER_WAVES - 1,
# each PER_BATCH commits sent at once and alternating between the two
# proxies, so that each proxy cuts one full batch of PER_BATCH // 2 =
# 32,768 a wave (commit_transaction_batch_count_max, the proxy's cap).
# Two waves, not four: four took 80.9 s on an NVIDIA H100 80GB HBM3's host
# (11.4-16.9 s a wave), above the phase's 60 s.
CLUSTER_WAVES = 2
CLUSTER_PAGE = 10_000  # rows a page of 4k's read-back
# Phase 6k's pipeline depths, and the one that runs commit_script's
# too-old tail.  The tail's 6 s of virtual idle cut about 96 of a run's 112
# resolve dispatches, and the whole script at depths 1-3 on both devices
# took 19.1-30.4 s on an NVIDIA H100 80GB HBM3's host, above the phase's
# 15 s; so depths 1 and 2 run the script without its tail.
CLUSTER_VS_CPU_DEPTHS = (1, 2, 3)
CLUSTER_VS_CPU_TAIL_DEPTH = 3


def norm(v):
    """A package-free form of a value: dataclasses as (class name,
    fields), enums as ints (so either package's roles give one record)."""
    import dataclasses
    from enum import IntEnum

    if isinstance(v, IntEnum):
        return int(v)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                tuple((f.name, norm(getattr(v, f.name))) for f in dataclasses.fields(v)))
    if isinstance(v, (list, tuple)):
        return type(v)(norm(x) for x in v)
    if isinstance(v, dict):
        return {norm(k): norm(x) for k, x in v.items()}
    return v


def vstamp_param(prefix: bytes, suffix: bytes = b"") -> bytes:
    """A SET_VERSIONSTAMPED_* parameter: 10 placeholder bytes after
    `prefix`, then the 4-byte little-endian offset of the stamp."""
    return prefix + b"\x00" * 10 + suffix + len(prefix).to_bytes(4, "little")


def commit_script(c, types, itf, too_old=True):
    """The commit path's script of raw requests through a SimCluster `c`
    (the port's, or any cluster with its roles' request streams; `types`
    and `itf` are the matching client types and interfaces modules), from
    one client process: GRVs; commits with SET_VALUE, CLEAR_RANGE, atomic
    adds, a versionstamped key and value, a read-write conflict (t3) and
    (with `too_old`) a too-old commit and read after 6 s; a state
    transaction on \\xff/conf/x; get_value and get_key_values (forward,
    reverse, limited) at several versions, a read 0.4 s of versions ahead,
    and a watch.  Returns every reply as
    (label, virtual time, "reply", payload) or (label, virtual time,
    "error", name, detail), payloads through norm()."""
    loop = c.loop
    M, MT = types.Mutation, types.MutationType
    client = c.net.process("client")
    proxies = [p.interface() for p in c.proxies]
    ss = c.storage.interface()
    out = []

    def txn(snap, reads=(), writes=(), muts=()):
        return itf.CommitTransactionRequest(transaction=types.CommitTransactionRef(
            read_snapshot=snap, read_conflict_ranges=list(reads),
            write_conflict_ranges=list(writes), mutations=list(muts)))

    async def call(label, stream, req):
        try:
            v = await stream.get_reply(client, req)
        except Exception as e:  # noqa: BLE001 - the roles' FdbError
            out.append((label, loop.now(), "error", e.name, norm(getattr(e, "detail", None))))
            return None
        out.append((label, loop.now(), "reply", norm(v)))
        return v

    def point(key):
        return (key, key + b"\x00")

    async def script():
        await loop.delay(0.01)
        v0 = await call("grv0", proxies[0].get_consistent_read_version, itf.GetReadVersionRequest())
        one = (1).to_bytes(8, "little")
        await call("t1", proxies[0].commit, txn(
            v0, writes=[point(b"a"), point(b"b"), point(b"c1"), point(b"c2"), point(b"cnt"),
                        (b"vs", b"vt"), point(b"vsv")],
            muts=[M(MT.SET_VALUE, b"a", b"1"), M(MT.SET_VALUE, b"b", b"2"),
                  M(MT.SET_VALUE, b"c1", b"x"), M(MT.SET_VALUE, b"c2", b"y"),
                  M(MT.ADD_VALUE, b"cnt", one),
                  M(MT.SET_VERSIONSTAMPED_KEY, vstamp_param(b"vs"), b"k"),
                  M(MT.SET_VERSIONSTAMPED_VALUE, b"vsv", vstamp_param(b"s", b"!"))]))
        # Three at once, on the proxies in turn: a clear and an add, a
        # read of `a` at v0 (written after it: not_committed), another add.
        fs = []
        for i, t in enumerate((
            txn(v0, writes=[(b"c", b"d"), point(b"cnt")],
                muts=[M(MT.CLEAR_RANGE, b"c", b"d"), M(MT.ADD_VALUE, b"cnt", one)]),
            txn(v0, reads=[point(b"a")], writes=[point(b"z")],
                muts=[M(MT.SET_VALUE, b"z", b"no")]),
            txn(v0, writes=[point(b"cnt")], muts=[M(MT.ADD_VALUE, b"cnt", one)]),
        )):
            fs.append(client.spawn(call(f"t{2 + i}", proxies[i % len(proxies)].commit, t)))
        for f in fs:
            await f
        # A state transaction: its metadata key reaches the other proxies
        # through every resolver.
        await call("state", proxies[-1].commit, txn(
            v0, writes=[point(b"\xff/conf/x")], muts=[M(MT.SET_VALUE, b"\xff/conf/x", b"1")]))
        v1 = await call("grv1", proxies[-1].get_consistent_read_version,
                        itf.GetReadVersionRequest())
        for label, ver in (("v0", v0), ("v1", v1)):
            for key in (b"a", b"cnt", b"vsv", b"c1", b"z"):
                await call(f"get {key!r} @{label}", ss.get_value,
                           itf.GetValueRequest(key=key, version=ver))
            await call(f"range @{label}", ss.get_key_values,
                       itf.GetKeyValuesRequest(begin=b"", end=b"\xff", version=ver))
        await call("range reverse", ss.get_key_values,
                   itf.GetKeyValuesRequest(begin=b"", end=b"\xff", version=v1, reverse=True))
        await call("range limit 2", ss.get_key_values,
                   itf.GetKeyValuesRequest(begin=b"b", end=b"\xff", version=v1, limit=2))
        await call("range reverse limit 2", ss.get_key_values,
                   itf.GetKeyValuesRequest(begin=b"", end=b"v", version=v1, limit=2,
                                           reverse=True))
        # A read 0.4 s of versions ahead: the storage catches up on the
        # proxies' idle batches and answers.
        fut = client.spawn(call("future", ss.get_value,
                                itf.GetValueRequest(key=b"a", version=v1 + 400_000)))
        watch = client.spawn(call("watch", ss.watch_value,
                                  itf.WatchValueRequest(key=b"a", value=b"1", version=v1)))
        await loop.delay(0.05)
        await call("t5", proxies[0].commit, txn(
            v1, reads=[point(b"a")], writes=[point(b"a")], muts=[M(MT.SET_VALUE, b"a", b"3")]))
        await watch
        await fut
        if too_old:
            await loop.delay(6.0)
            await call("too old", proxies[0].commit, txn(
                v0, reads=[point(b"b")], writes=[point(b"q")],
                muts=[M(MT.SET_VALUE, b"q", b"1")]))
            await call("get @v0 late", ss.get_value, itf.GetValueRequest(key=b"a", version=v0))
        v2 = await call("grv2", proxies[0].get_consistent_read_version,
                        itf.GetReadVersionRequest())
        await call("range @v2", ss.get_key_values,
                   itf.GetKeyValuesRequest(begin=b"", end=b"\xff\xff", version=v2))

    c.run_until(client.spawn(script(), "script"), timeout_vt=60.0)
    return out


def cluster_record(c, types, itf, export, too_old=True) -> dict:
    """commit_script's replies through `c` and the cluster's state after
    it: the sequencer's version and committed version, each tlog's
    versions, entries and pops, the storage's window (keys, version chains,
    clears) and byte sample, every proxy's and resolver's registry
    snapshot, the proxies' latency samples, each resolver's
    conflict_witness and its set's state (`export(set)`), and the loop's
    end time with its rng's next draw."""
    replies = commit_script(c, types, itf, too_old)
    st = c.storage.store
    return dict(
        replies=replies,
        sequencer=(c.sequencer.version, c.sequencer.committed.get()),
        tlogs=[(t.versions, norm(t.entries), t.popped_tags, t.popped, t.durable.get(),
                t.known_committed, t._mem_bytes) for t in c.tlogs],
        storage=(norm(st.kv), st.sorted_keys, list(st.clears), c.storage.version.get(),
                 c.storage.durable_version, c.storage.input_bytes,
                 c.storage.byte_sample.idx.keys_in(b"", None),
                 c.storage.byte_sample.bytes_in(b"", None)),
        proxies=[p.metrics.snapshot_json() for p in c.proxies],
        proxy_latency=[{k: s.summary() for k, s in p.latency_samples.items()}
                       for p in c.proxies],
        resolvers=[r.metrics.snapshot_json() for r in c.resolvers],
        witness=[r.conflict_witness() for r in c.resolvers],
        sets=[export(r.conflicts) for r in c.resolvers],
        end=(c.loop.now(), c.loop.rng.random_int(0, 1 << 30)),
    )


def set_state(ecpu, cs):
    """A ConflictSet's mirror (keys, versions, oldest) and, with a device
    engine, its exported device state."""
    mirror = (list(cs._cpu.keys), list(cs._cpu.vers), cs._cpu.oldest_version)
    if cs._dev is None:
        return mirror
    out = ecpu.CpuConflictSet()
    cs._dev.store_to(out)
    return mirror, (list(out.keys), list(out.vers), out.oldest_version)


class Recorded:
    """A RequestStreamRef stand-in, on the script's side of a role: every
    request sent through it and the reply's future, in send order."""

    def __init__(self, ref, log):
        self.ref, self.log = ref, log

    def get_reply(self, src, request):
        f = self.ref.get_reply(src, request)
        self.log.append((request, f))
        return f


class WallCalls:
    """Wall seconds inside the named methods of one object (instance
    attributes wrapping the bound methods; remove() restores them)."""

    def __init__(self, obj, names):
        from foundationdb_tpu_torch.metrics import wall_now

        self.obj, self.names, self.seconds = obj, names, 0.0
        for name in names:
            inner = getattr(obj, name)

            def timed(*a, _inner=inner, **kw):
                t0 = wall_now()
                try:
                    return _inner(*a, **kw)
                finally:
                    self.seconds += wall_now() - t0

            setattr(obj, name, timed)

    def remove(self):
        for name in self.names:
            delattr(self.obj, name)


def cluster_path(torch, api, ecpu, tk, spans, trace, fr, batches, main):
    """Phase 4k: the commit path through the port's SimCluster on the card.
    SimCluster(n_proxies=2, n_tlogs=2, n_storages=1, buggify=False) with
    resolver 0's set a ConflictSet with phase 4's settings rehydrated from
    phase 4's warm-up state (as 4q's), on SimNetwork(deep_copy=False) and
    fresh port hubs.  After 1 ms of virtual time one empty commit (the
    cluster's first batch, as a recovery transaction) lifts the committed
    version above the snapshot's newest; then CLUSTER_WAVES waves, wave k
    phase 4's timed batch WARM + k as PER_BATCH commits (its read and
    write range, one SET_VALUE of the write range's begin key to 8 bytes
    (wave, index)) alternating between the proxies, read at the GRV taken
    before wave k - 1 (wave 0 at its own).  Checks: every resolve request
    the resolver served (recorded on the proxies' side) replayed through a
    host CpuConflictSet rehydrated from the same snapshot gives the same
    verdicts and witnesses; each acknowledged commit's reply is its batch's
    version and each conflicted one gets not_committed with the witness's
    version and its read range; the whole key range read back in pages
    equals the acknowledged writes applied in version and batch order;
    both tlogs acknowledged every committed version with as many
    SET_VALUEs as commits acknowledged there; phase 4's launches a batch,
    pipeline_dispatches = batches, no fault, degraded batch or fallback,
    mirror_check "ok"; the proxies' registries count the waves; the
    acked_commit mark is the last acknowledged version.  Prints commits/s
    through the cluster beside phase 4's txn/s, each wave's wall by the
    proxies' phase spans, the conflict set's share of it, the storage's
    apply and the read-back, host syncs a batch, the conflict rate, the
    batch versions and the commit latency p50/p99 (virtual).  Returns the
    launches, the resolve batches, the empty ones among them and what
    phase 4n goes on with: the cluster, its set and engine, the host
    replay (a Replay past every batch so far) and 4k's commits/s."""
    import dataclasses
    import struct

    from foundationdb_tpu_torch.client.types import CommitTransactionRef, Mutation, MutationType
    from foundationdb_tpu_torch.conflict.types import COMMITTED, CONFLICT
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.flow import sim_validation
    from foundationdb_tpu_torch.flow.future import Promise
    from foundationdb_tpu_torch.metrics import wall_now
    from foundationdb_tpu_torch.server import interfaces as itf
    from foundationdb_tpu_torch.server.cluster import SimCluster

    gc.collect()
    label = "cluster"
    snap = main["warm_snapshot"]
    newest = max(ch.max_ver for ch in snap.chunks)
    cs = api.ConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, pipeline_depth=2)
    cs._cpu = warm_engine(ecpu, snap)
    eng = cs._dev
    syncs0, dispatches0 = eng.host_syncs, eng.metrics.counter("pipeline_dispatches").value
    half = PER_BATCH // 2
    waves = [batches[WARM + w] for w in range(CLUSTER_WAVES)]
    t_setup = wall_now()
    # The requests, made before the clock starts; each wave's snapshot is
    # set when its GRV is known.
    reqs = [[itf.CommitTransactionRequest(transaction=CommitTransactionRef(
        read_snapshot=0, read_conflict_ranges=t.read_ranges,
        write_conflict_ranges=t.write_ranges,
        mutations=[Mutation(MutationType.SET_VALUE, t.write_ranges[0][0],
                            struct.pack(">II", w, i))]))
        for i, t in enumerate(txns)] for w, txns in enumerate(waves)]
    hubs = PortHubs(spans, trace, fr)
    for name in tk.LAUNCHES:
        tk.LAUNCHES[name] = 0
    c = None
    try:
        c = SimCluster(seed=23, conflict_set=cs, n_proxies=2, n_tlogs=2, n_storages=1,
                       buggify=False)
        c.net.deep_copy = False  # before the first request, as 4q's network
        loop = c.loop
        resolves, pushes = [], [[] for _ in c.tlogs]
        for p in c.proxies:
            p.resolvers = [dataclasses.replace(r, resolve=Recorded(r.resolve, resolves))
                           for r in p.resolvers]
            p.tlogs = [dataclasses.replace(t, commit=Recorded(t.commit, pushes[i]))
                       for i, t in enumerate(p.tlogs)]
        in_set = WallCalls(cs, ("pipeline_submit", "pipeline_complete_oldest", "pipeline_drain"))
        in_apply = WallCalls(c.storage, ("_apply",))
        client = c.net.process("client")
        proxies = [p.interface() for p in c.proxies]

        def wait(fut):
            return loop.run_until(fut, timeout_vt=loop.now() + 60.0)

        wait(loop.delay(0.001))
        first = wait(proxies[0].commit.get_reply(client, itf.CommitTransactionRequest(
            transaction=CommitTransactionRef())))
        if first <= newest:
            raise AssertionError(f"{label}: the first batch's version {first} is not above the "
                                 f"snapshot's newest {newest}")
        grvs, walls, outcomes, split = [], [], [], []
        phase_names = ("get_version", "resolution", "log_push", "reply")
        seen = {n: 0 for n in phase_names}
        set_s0, apply_s0 = in_set.seconds, in_apply.seconds
        t_first = None
        for w in range(CLUSTER_WAVES):
            grvs.append(wait(proxies[0].get_consistent_read_version.get_reply(
                client, itf.GetReadVersionRequest())))
            snap_v = grvs[max(w - 1, 0)]
            for r in reqs[w]:
                r.transaction.read_snapshot = snap_v
            done, left, last = Promise(), [PER_BATCH], [None]

            def arrived(_f):
                left[0] -= 1
                if left[0] == 0:
                    last[0] = wall_now()
                    done.send(None)

            t0 = wall_now()
            t_first = t_first or t0
            futs = []
            for i, r in enumerate(reqs[w]):
                f = proxies[i % 2].commit.get_reply(client, r)
                f.add_callback(arrived)
                futs.append(f)
            wait(done.future)
            walls.append(last[0] - t0)
            outcomes.append(futs)
            row = {}
            for n in phase_names:
                got = hubs.hub.spans(name=n)
                row[n] = sum(s.wall_end - s.wall_start for s in got[seen[n]:])
                seen[n] = len(got)
            row["set"] = in_set.seconds - set_s0
            row["apply"] = in_apply.seconds - apply_s0
            set_s0, apply_s0 = in_set.seconds, in_apply.seconds
            split.append(row)
        t_last = last[0]
        torch.cuda.synchronize()
        # The read-back: the whole key range at the last committed version,
        # in pages.
        vf = wait(proxies[0].get_consistent_read_version.get_reply(
            client, itf.GetReadVersionRequest()))
        t0 = wall_now()
        got, begin, pages = {}, b"", 0
        while True:
            page = wait(c.storage.interface().get_key_values.get_reply(
                client, itf.GetKeyValuesRequest(begin=begin, end=b"\xff", version=vf,
                                                limit=CLUSTER_PAGE)))
            pages += 1
            got.update(page.data)
            if not page.more:
                break
            begin = page.data[-1][0] + b"\x00"
        read_s = wall_now() - t0
        in_set.remove()
        in_apply.remove()
    finally:
        hubs.restore()
        el.set_event_loop(None)
    launches = dict(tk.LAUNCHES)
    t_checks = wall_now()

    # Verdicts: the served requests replayed on the host from the snapshot.
    window = c.resolver.max_write_transaction_life_versions
    rp = Replay(warm_engine(ecpu, snap), window)
    rp.log = resolves
    served = rp.replay(label)
    if len(served) != len(resolves):
        raise AssertionError(f"{label}: {len(resolves) - len(served)} resolve requests "
                             f"unanswered")
    nonempty = [(q, f.get()) for q, f in served if q.transactions]
    empty = len(served) - len(nonempty)
    sizes = sorted(len(q.transactions) for q, _r in nonempty)
    if sizes != [1] + [half] * (2 * CLUSTER_WAVES):
        raise AssertionError(f"{label}: batch sizes {sizes}, expected one of 1 and "
                             f"{2 * CLUSTER_WAVES} of {half}")
    # Outcomes: each client transaction found in its batch by its ranges.
    where = {}
    for q, rep in nonempty:
        for t, tr in enumerate(q.transactions):
            key = (tuple(tr.read_ranges), tuple(tr.write_ranges), tr.read_snapshot)
            if key in where:
                raise AssertionError(f"{label}: two transactions share ranges {key}")
            where[key] = (q.version, t, rep)
    acks, acked_at = [], {}
    n_conflict = 0
    for w, futs in enumerate(outcomes):
        for i, f in enumerate(futs):
            tr = reqs[w][i].transaction
            ver, t, rep = where[(tuple(tr.read_conflict_ranges), tuple(tr.write_conflict_ranges),
                                 tr.read_snapshot)]
            status = int(rep.committed[t])
            if status == COMMITTED:
                if f.is_error() or f.get() != ver:
                    raise AssertionError(f"{label}: wave {w} txn {i} committed at {ver}, reply "
                                         f"{f.error() if f.is_error() else f.get()}")
                acks.append((ver, t, tr.mutations[0]))
                acked_at[ver] = acked_at.get(ver, 0) + 1
            elif status == CONFLICT:
                n_conflict += 1
                e = f.error() if f.is_error() else None
                wit = rep.witnesses[t]
                want = {"version": int(wit[0]), "retry_version": ver,
                        "range": tr.read_conflict_ranges[wit[1]]}
                if e is None or e.name != "not_committed" or e.detail != want:
                    raise AssertionError(f"{label}: wave {w} txn {i} conflicted at {ver}: "
                                         f"{e!r} {getattr(e, 'detail', None)}, expected {want}")
            else:
                raise AssertionError(f"{label}: wave {w} txn {i}: status {status}")
    want_map = {}
    for _v, _t, m in sorted(acks, key=lambda a: (a[0], a[1])):
        want_map[m.param1] = m.param2
    if got != want_map:
        extra = len(set(got) - set(want_map))
        missing = len(set(want_map) - set(got))
        wrong = sum(1 for k in set(got) & set(want_map) if got[k] != want_map[k])
        raise AssertionError(f"{label}: read-back differs from the acknowledged writes: "
                             f"{extra} extra keys, {missing} missing, {wrong} wrong values")
    # Both logs: every committed version acknowledged, its SET_VALUEs
    # counted.
    versions = sorted(q.version for q, _f in served)
    for i, log_ in enumerate(pushes):
        held = {}
        for q, f in log_:
            if f.is_error() or f.get() != q.version:
                raise AssertionError(f"{label}: tlog {i} answered version {q.version} with "
                                     f"{f.error() if f.is_error() else f.get()}")
            held[q.version] = len({seq for items in q.tagged.values() for seq, m in items
                                   if m.type == MutationType.SET_VALUE})
        if sorted(held) != versions:
            raise AssertionError(f"{label}: tlog {i} holds versions {sorted(held)}, the "
                                 f"resolver served {versions}")
        bad = [v for v in versions if held[v] != acked_at.get(v, 0)]
        if bad:
            raise AssertionError(f"{label}: tlog {i}'s SET_VALUEs differ from the acks at {bad}")
        if c.tlogs[i].durable.get() < versions[-1]:
            raise AssertionError(f"{label}: tlog {i} durable at {c.tlogs[i].durable.get()}")
    # The conflict set and the launches.
    n_batches = len(served)
    per = {k: v // TIMED for k, v in main["launches"].items()}
    expect = {k: v * n_batches for k, v in per.items()}
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches} in {n_batches} batches "
                             f"({empty} empty), expected {expect}")
    dispatches = eng.metrics.counter("pipeline_dispatches").value - dispatches0
    cm = cs.device_metrics()["counters"]
    if dispatches != n_batches or cm["device_faults"] or cm["degraded_batches"]:
        raise AssertionError(f"{label}: {dispatches} dispatches, counters {cm}")
    if eng.cpu_fallbacks != 0:
        raise AssertionError(f"{label}: cpu_fallbacks = {eng.cpu_fallbacks}")
    t_mirror = wall_now()
    report = cs.mirror_check()
    if report["status"] != "ok":
        raise AssertionError(f"{label}: mirror_check: {report}")
    t_mirror = wall_now() - t_mirror
    # The proxies' registries and the acked_commit mark.
    counters = [p.metrics.snapshot()["counters"] for p in c.proxies]
    tot = {k: sum(x[k] for x in counters) for k in ("committed", "conflicted", "too_old")}
    if (tot["committed"] != len(acks) + 1 or tot["conflicted"] != n_conflict
            or tot["too_old"] or len(acks) + n_conflict != CLUSTER_WAVES * PER_BATCH):
        raise AssertionError(f"{label}: the proxies count {tot}; {len(acks)} acks and "
                             f"{n_conflict} conflicts seen")
    mark = sim_validation.marked(c.loop, "acked_commit")
    if mark != max(v for v, _t, _m in acks):
        raise AssertionError(f"{label}: acked_commit marked {mark}, last ack "
                             f"{max(v for v, _t, _m in acks)}")
    lat = [p.latency_samples["commit"] for p in c.proxies]
    commits = CLUSTER_WAVES * PER_BATCH
    card = torch.cuda.get_device_name(0)
    wall = t_last - t_first
    log(f"{label}: SimCluster(n_proxies=2, n_tlogs=2, n_storages=1, buggify=False) over "
        f"ConflictSet(depth 2) from phase 4's state after its warm-up ({snap.boundary_count} "
        f"keys, newest version {newest}) on SimNetwork(deep_copy=False); one empty commit at "
        f"version {first}, then {CLUSTER_WAVES} waves of {PER_BATCH} commits (phase 4's batches "
        f"{WARM}..{WARM + CLUSTER_WAVES - 1}) from 2 proxies: {n_batches} resolve batches "
        f"({empty} empty) of sizes {sizes}, verdicts and witnesses equal the host set's replay, "
        f"{len(acks)} acknowledged at their batch's version, {n_conflict} not_committed with "
        f"the witness's version and range, {len(got)} keys read back in {pages} pages equal "
        f"the acknowledged writes, both tlogs hold every version and SET_VALUE, launches "
        f"{launches}, pipeline_dispatches {dispatches}, mirror_check ok; card {card}")
    log(f"{label}: wall {wall:.6f} s from the first commit sent to the last reply: "
        f"{commits / wall:.1f} commits/s through the cluster ({len(acks) / wall:.1f} "
        f"acknowledged/s) beside phase 4's {main['tps']:.1f} txn/s (ConflictSet alone; no "
        f"claim); conflict rate {n_conflict / commits:.6f}; host syncs/batch "
        f"{(eng.host_syncs - syncs0) / n_batches}; batch versions {versions}; commit latency "
        f"(virtual) p50 {[s.percentile(0.5) for s in lat]} p99 "
        f"{[s.percentile(0.99) for s in lat]}; read-back {read_s:.6f} s ({len(got)} keys, "
        f"{pages} pages); card {card}")
    log(f"{label}: the phase's host seconds: building the requests and the cluster and the "
        f"first commit {t_first - t_setup:.3f}, the waves {wall:.3f}, the read-back "
        f"{read_s:.3f}, the replay and checks {wall_now() - t_checks - t_mirror:.3f}, "
        f"mirror_check {t_mirror:.3f}")
    for w, (wl, row) in enumerate(zip(walls, split)):
        log(f"{label}: wave {w}: wall {wl:.6f} s; the proxies' phase spans (summed over both "
            f"proxies' batches) get_version {row['get_version']:.6f} resolution "
            f"{row['resolution']:.6f} log_push {row['log_push']:.6f} reply {row['reply']:.6f} "
            f"s; inside the conflict set {row['set']:.6f} s (share {row['set'] / wl:.4f}); "
            f"the storage's apply {row['apply']:.6f} s; GRV {grvs[w]}, read at "
            f"{grvs[max(w - 1, 0)]}")
    # Phase 4n goes on from here: the cluster, its set and the host replay.
    run = dict(cluster=c, set=cs, engine=eng, replay=rp, commits_per_s=commits / wall)
    del reqs, outcomes, pushes
    gc.collect()
    return launches, n_batches, empty, run


def clusters_vs_cpu(torch, api, ecpu, spans, trace, fr):
    """Phase 6k: commit_script through the port's SimCluster(n_proxies=2,
    n_resolvers=2, n_tlogs=2, buggify=True) with resolver 0's set a
    ConflictSet at the CPU differential's shape (key_words 3, h_cap 1,024,
    bucket_mins (32, 128, 64); the script's keys reach 12 bytes) at
    CLUSTER_VS_CPU_DEPTHS, on cuda and on cpu (resolver 1 builds its own
    set on the same device), each on fresh port hubs and a fresh loop of
    one seed: every reply and its virtual time, the storage, the tlogs,
    every role's registry snapshot and each resolver's conflict_witness and
    set state equal on the two devices.  Only CLUSTER_VS_CPU_TAIL_DEPTH runs
    the script's too-old tail."""
    from foundationdb_tpu_torch.client import types
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.server import interfaces as itf
    from foundationdb_tpu_torch.server.cluster import SimCluster

    from foundationdb_tpu_torch.metrics import wall_now

    n_conflicts, n_replies, secs = 0, 0, {}
    for depth in CLUSTER_VS_CPU_DEPTHS:
        runs = {}
        for device in ("cuda", "cpu"):
            t0 = wall_now()
            cs = api.ConflictSet(key_words=3, h_cap=1 << 10, bucket_mins=(32, 128, 64),
                                 pipeline_depth=depth, device=device)
            hubs = PortHubs(spans, trace, fr)
            try:
                c = SimCluster(seed=41, conflict_set=cs, n_proxies=2, n_resolvers=2,
                               n_tlogs=2, buggify=True, device=device)
                runs[device] = cluster_record(c, types, itf, lambda s: set_state(ecpu, s),
                                              too_old=depth == CLUSTER_VS_CPU_TAIL_DEPTH)
            finally:
                hubs.restore()
                el.set_event_loop(None)
            secs[(depth, device)] = round(wall_now() - t0, 3)
        if runs["cuda"] != runs["cpu"]:
            which = [k for k in runs["cpu"] if runs["cuda"][k] != runs["cpu"][k]]
            raise AssertionError(f"cluster depth {depth}: cuda and cpu differ in {which}")
        n_conflicts += sum(1 for r in runs["cuda"]["replies"]
                           if r[2] == "error" and r[3] == "not_committed")
        n_replies += len(runs["cuda"]["replies"])
    log(f"cluster vs cpu: commit_script ({n_replies} replies, {n_conflicts} not_committed "
        f"in all) through SimCluster(n_proxies=2, n_resolvers=2, n_tlogs=2, buggify=True) "
        f"at depths {CLUSTER_VS_CPU_DEPTHS} (the too-old tail at depth "
        f"{CLUSTER_VS_CPU_TAIL_DEPTH}): replies and their virtual times, "
        f"storage, tlogs, registries, witnesses and set state equal on cuda and cpu; host "
        f"seconds a run {secs}; card {torch.cuda.get_device_name(0)}")


# ---------------------------------------------------------------------------
# phases 4n and 6n: the client (Database, Transaction) on the port's cluster
# ---------------------------------------------------------------------------

# Phase 4n's ring: CLIENT_NODES nodes under b"c/%04d" (6-byte keys, 7 with
# key_after, inside the 8 bytes of 4k's key_words=2 set), loaded by
# CLIENT_LOAD_TXNS transactions that read every key they set (so the client
# adds no self-conflict key), then CLIENT_ACTORS actors of CLIENT_OPS Cycle
# operations each, once with witness_retry off and once on.  Two ops, not
# eight: at eight 4n took 106.2 s on an NVIDIA H100 80GB HBM3's host (the
# arms 44.3 and 37.2 s, 554 resolve batches), above its 45 s, so the ops
# were halved twice.
CLIENT_NODES = 4096
CLIENT_ACTORS = 1024
CLIENT_OPS = 2
CLIENT_LOAD_TXNS = 64
CLIENT_PREFIX = b"c/"
# Phase 6n's pipeline depths and its sets' shape: the Resolver's default
# key_words=4, so the client's 14-byte self-conflict keys fit the card, at
# the CPU differential's h_cap.  Its script's sizes (client_script) were
# cut by a third after 21.9 s on an NVIDIA H100 80GB HBM3's host, above
# the phase's 15 s.
CLIENT_VS_CPU_DEPTHS = (1, 2, 3)
CLIENT_SET_KW = dict(key_words=4, h_cap=1 << 10, bucket_mins=(32, 128, 64))


class ClientLog:
    """Every point read, range read, commit and retry of one package's
    client: wraps the Transaction class of `txmod` (its get, get_range,
    commit and on_error; remove() restores them).  `counts` counts each
    call by (method, outcome); with `record`, `events` also holds each as
    (method, virtual time, client process, arguments, outcome...), payloads
    through norm() and errors as ("error", name, detail); on_error's
    outcome is the retry count before it and the read version it left
    (a witness hint seeds it)."""

    def __init__(self, txmod, record=True):
        T = txmod.Transaction
        self.T, self.record, self.events, self.counts = T, record, [], {}
        self.saved = {n: T.__dict__[n] for n in ("get", "get_range", "commit", "on_error")}
        for name, args in (("get", lambda a, kw: (a, kw)),
                           ("get_range", lambda a, kw: (a, kw)),
                           ("commit", lambda a, kw: ())):
            setattr(T, name, self._wrap(name, args))
        setattr(T, "on_error", self._on_error())

    def emit(self, tr, method, outcome, *rest):
        key = (method, outcome)
        self.counts[key] = self.counts.get(key, 0) + 1
        if self.record:
            proc = tr.db.process
            self.events.append((method, proc.network.loop.now(), proc.name)
                               + tuple(norm(x) for x in rest))

    def _wrap(self, name, args):
        inner, log = self.saved[name], self

        async def call(tr, *a, **kw):
            try:
                v = await inner(tr, *a, **kw)
            except Exception as e:  # noqa: BLE001 - the client's FdbError, re-raised
                if getattr(e, "name", None) is None:
                    raise
                log.emit(tr, name, e.name, args(a, kw), "error", e.name, e.detail)
                raise
            log.emit(tr, name, "ok", args(a, kw), v)
            return v

        return call

    def _on_error(self):
        inner, log = self.saved["on_error"], self

        async def on_error(tr, e):
            retries = tr._retries
            try:
                await inner(tr, e)
            except Exception:  # noqa: BLE001 - not retryable: re-raised
                log.emit(tr, "on_error", "raised", e.name, e.detail, retries)
                raise
            log.emit(tr, "on_error", e.name, e.name, e.detail, retries, tr._read_version)

        return on_error

    def remove(self):
        for name, fn in self.saved.items():
            setattr(self.T, name, fn)


def client_state(dbs) -> list:
    """Each client's state after a run: its process, witness_hint_retries,
    latency samples, round-robin counters, GRV lanes, location cache (the
    teams by storage id) and queue model."""

    def team(v):
        return v if v is None else tuple(getattr(i, "storage_id", "") for i in v)

    return [(db.process.name, db.witness_hint_retries,
             {k: s.summary() for k, s in db.latency_samples.items()},
             sorted(db._proxy_rr.items()), sorted(db._grv_lanes),
             [(b, e, team(v)) for b, e, v in db._loc_cache.items()],
             sorted(db.queue_model._latency.items()), sorted(db.queue_model._penalty.items()))
            for db in dbs]


@contextlib.contextmanager
def resolver_sets(cluster_mod, make_set):
    """While open, every Resolver the SimCluster of `cluster_mod` builds
    without a conflict set of its own gets `make_set()`."""
    base = cluster_mod.Resolver

    class Resolver(base):
        def __init__(self, process, conflict_set=None, **kw):
            super().__init__(process, conflict_set=conflict_set or make_set(), **kw)

    cluster_mod.Resolver = Resolver
    try:
        yield
    finally:
        cluster_mod.Resolver = base


def tracked_databases(c) -> list:
    """Every Database `c.database()` makes from now on, in order."""
    dbs, make = [], c.database

    def database(name="", **kw):
        db = make(name, **kw)
        dbs.append(db)
        return db

    c.database = database
    return dbs


def ring_ok(ring) -> bool:
    """Following the successors from node 0 visits every node once."""
    seen, cur = set(), 0
    for _ in range(len(ring)):
        if cur in seen:
            return False
        seen.add(cur)
        cur = ring[cur]
    return cur == 0 and len(seen) == len(ring)


def client_script(c, wl):
    """Phase 6n's client script through a SimCluster `c` (either package's;
    `wl` is its workloads module): a ResolverBalancer(min_ops=10, ratio=1.2)
    round every 0.15 s while run_workloads drives a Cycle ring of 8 nodes
    (its own setup, whose blind writes carry the client's self-conflict
    keys), an AtomicLedger, WriteSkew rounds and a LockDatabase lock and
    unlock, all concurrent; then the ring read back.  Returns the balancer,
    the workloads and the ring's rows."""
    db = c.database("script")
    bal = c.resolver_balancer(min_ops=10, ratio=1.2)
    stop = []

    async def balance():
        while not stop:
            await bal.run_once()
            await c.loop.delay(0.15)

    task = db.process.spawn(balance(), "balancer")
    loads = [wl.CycleWorkload(nodes=8, ops=4, actors=3), wl.AtomicLedgerWorkload(ops=4),
             wl.WriteSkewWorkload(rounds=3), wl.LockDatabaseWorkload(at=0.1, hold=0.2)]
    wl.run_workloads(c, loads)
    stop.append(True)
    c.run_until(task, timeout_vt=2000.0)
    out = {}

    async def read(tr):
        out["rows"] = await tr.get_range(b"cycle/", b"cycle0")

    c.run_all([(db, db.run(read))])
    return bal, loads, out["rows"]


def client_record(c, wl, txmod) -> dict:
    """client_script's record through `c`: every read, commit and retry
    (ClientLog), each client's state, the ring, the balancer's splits and
    moves, the workloads' own records, the proxies' resolver bounds and
    registry snapshots, the resolvers' snapshots and witness blocks, the
    buggify coverage, and the loop's end time with its rng's next draw."""
    log = ClientLog(txmod)
    dbs = tracked_databases(c)
    try:
        bal, loads, rows = client_script(c, wl)
    finally:
        log.remove()
    return dict(
        events=log.events,
        clients=client_state(dbs),
        ring=[int(v) for _k, v in rows],
        balancer=(bal.split_keys, bal.moves),
        workloads=[(w.name, norm({k: v for k, v in vars(w).items()})) for w in loads],
        proxies=[(p.resolver_bounds, p.locked_uid, p.metrics.snapshot_json()) for p in c.proxies],
        resolvers=[r.metrics.snapshot_json() for r in c.resolvers],
        witness=[r.conflict_witness() for r in c.resolvers],
        coverage=c.buggify_coverage.snapshot_json(),
        end=(c.loop.now(), c.loop.rng.random_int(0, 1 << 30)),
    )


def long_key_counts(cs) -> dict:
    """A ConflictSet's long-key counters: the batches that used the
    long-key side table ("side") and those of them the host served whole
    ("host"); both are 0 on a set that never met a key past the card's
    width."""
    c = cs.device_metrics()["counters"]
    return dict(side=c.get("long_key_batches", 0), host=c.get("long_key_host_batches", 0))


class Replay:
    """The resolve requests the proxies send (a Recorded log), replayed in
    version order through a host CpuConflictSet: every served reply's
    verdicts and witnesses must equal the host's.  replay(label) takes
    the answered requests not yet replayed, in version order, up to the
    first unanswered one, and returns them."""

    def __init__(self, host, window):
        self.host, self.window = host, window
        self.log, self.done = [], 0

    def replay(self, label):
        todo = sorted(self.log[self.done:], key=lambda rf: rf[0].version)
        ready = list(itertools.takewhile(lambda rf: rf[1].is_ready(), todo))
        for q, f in ready:
            rep = f.get()
            st = self.host.detect(q.transactions, q.version, q.version - self.window)
            if digest(rep.committed, rep.witnesses) != digest(st, list(self.host.last_witness)):
                raise AssertionError(f"{label}: batch at version {q.version} "
                                     f"({len(q.transactions)} txns from {q.proxy_id}): verdicts "
                                     f"or witnesses differ from the host set's")
        self.log[self.done:] = ready + todo[len(ready):]
        self.done += len(ready)
        return ready


def client_path(torch, tk, spans, trace, fr, run, main):
    """Phase 4n: the client on 4k's cluster and set, right after 4k's
    waves.  A Cycle ring of CLIENT_NODES nodes loaded by CLIENT_LOAD_TXNS
    transactions that read every key they set, then two arms on the same
    cluster, one after the other: CycleWorkload(CLIENT_NODES, CLIENT_OPS,
    CLIENT_ACTORS)'s start from c.database(witness_retry=False), then from
    c.database(witness_retry=True), each followed by the workload's check.
    Every resolve request is replayed on 4k's host CpuConflictSet (the
    verdicts and witnesses equal); in each arm the kernels launch once a
    resolve batch, every batch is a device dispatch, no fault, degraded
    batch, fallback or key-width refusal or pin.  Prints for each arm the
    commits, not_committed, retries and witness_hint_retries, the GRV calls
    against the GRV requests the proxies saw, the resolve batches and
    their sizes, the launches, the wall and commits/s beside 4k's and
    phase 4's (no claim).  Returns the launches and batches of both
    arms."""
    from foundationdb_tpu_torch import workloads as wl
    from foundationdb_tpu_torch.client import transaction as txmod
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.flow.eventloop import all_of
    from foundationdb_tpu_torch.metrics import wall_now

    label = "client"
    c, cs, eng, rp = run["cluster"], run["set"], run["engine"], run["replay"]
    card = torch.cuda.get_device_name(0)
    loop = c.loop
    el.set_event_loop(loop)
    hubs = PortHubs(spans, trace, fr)
    totals = {"launches": {n: 0 for n in tk.LAUNCHES}, "batches": 0, "rates": {}}
    try:
        def wait(fut, budget=600.0):
            return loop.run_until(fut, timeout_vt=loop.now() + budget)

        def settle():
            """Run the loop until every request sent is answered, then
            replay them; returns the replayed requests."""
            for _ in range(1000):
                if all(f.is_ready() for _q, f in rp.log[rp.done:]):
                    break
                wait(loop.delay(0.001))
            else:
                raise AssertionError(f"{label}: resolve requests still unanswered")
            return rp.replay(label)

        def counters():
            m = cs.device_metrics()["counters"]
            return dict(launches=dict(tk.LAUNCHES), grv=sum(
                p.stats.counter("grv_requests").value for p in c.proxies),
                dispatches=eng.metrics.counter("pipeline_dispatches").value,
                faults=m["device_faults"], degraded=m["degraded_batches"],
                fallbacks=eng.cpu_fallbacks, **long_key_counts(cs))

        ring = wl.CycleWorkload(nodes=CLIENT_NODES, ops=CLIENT_OPS, actors=CLIENT_ACTORS,
                                prefix=CLIENT_PREFIX)
        loader = c.database("client_loader")
        keys = [ring._key(i) for i in range(CLIENT_NODES)]
        chunk = CLIENT_NODES // CLIENT_LOAD_TXNS

        def load(part):
            async def txn(tr):
                for i in part:
                    await tr.get(keys[i])  # the read covers the write
                    tr.set(keys[i], b"%04d" % ((i + 1) % CLIENT_NODES))
            return loader.run(txn)

        t0 = wall_now()
        before = counters()
        for name in tk.LAUNCHES:
            tk.LAUNCHES[name] = 0
        wait(all_of([loader.process.spawn(load(range(j, j + chunk)), "load")
                     for j in range(0, CLIENT_NODES, chunk)]))
        loaded = settle()
        after = counters()
        load_s = wall_now() - t0
        check_arm(label, "load", before, after, loaded)
        for k, v in after["launches"].items():
            totals["launches"][k] += v
        totals["batches"] += len(loaded)
        for arm, hint in (("off", False), ("on", True)):
            db = c.database(f"client_{arm}", witness_retry=hint)
            calls = [0]
            inner = db.batched_read_version

            async def grv(flags, _inner=inner):
                calls[0] += 1
                return await _inner(flags)

            db.batched_read_version = grv
            log_ = ClientLog(txmod, record=False)
            before = counters()
            for name in tk.LAUNCHES:
                tk.LAUNCHES[name] = 0
            v0 = loop.now()
            t0 = wall_now()
            try:
                wait(db.process.spawn(ring.start(db, c), f"cycle_{arm}"))
            finally:
                log_.remove()
            wall = wall_now() - t0
            vt = loop.now() - v0
            t1 = wall_now()
            ok = wait(db.process.spawn(ring.check(db, c), f"check_{arm}"))
            check_s = wall_now() - t1
            if not ok:
                raise AssertionError(f"{label} {arm}: the ring is no longer one cycle")
            served = settle()
            after = counters()
            check_arm(label, arm, before, after, served)
            for k, v in after["launches"].items():
                totals["launches"][k] += v
            totals["batches"] += len(served)
            n = log_.counts
            commits = n.get(("commit", "ok"), 0)
            if commits != CLIENT_ACTORS * CLIENT_OPS:
                raise AssertionError(f"{label} {arm}: {commits} commits, counts {n}")
            retries = sum(v for (m, o), v in n.items() if m == "on_error" and o != "raised")
            totals["rates"][arm] = commits / wall
            sizes = sorted(len(q.transactions) for q, _f in served)
            nonempty = [s for s in sizes if s]
            log(f"{label} {arm}: Database(witness_retry={hint}): {CLIENT_ACTORS} actors x "
                f"{CLIENT_OPS} Cycle ops on {CLIENT_NODES} nodes: {commits} commits, "
                f"{n.get(('commit', 'not_committed'), 0)} not_committed, {retries} retries "
                f"({ {o: v for (m, o), v in sorted(n.items()) if m == 'on_error'} }), "
                f"witness_hint_retries {db.witness_hint_retries}; GRV calls {calls[0]} against "
                f"{after['grv'] - before['grv']} GRV requests at the proxies; "
                f"{len(served)} resolve batches ({len(sizes) - len(nonempty)} empty), sizes "
                f"min {nonempty[0] if nonempty else 0} median "
                f"{nonempty[len(nonempty) // 2] if nonempty else 0} max "
                f"{nonempty[-1] if nonempty else 0}, {sum(sizes)} transactions; launches "
                f"{after['launches']} = {after['dispatches'] - before['dispatches']} device "
                f"dispatches = batches; fallbacks, degraded, faults and long-key side-table "
                f"batches 0; every batch's verdicts and witnesses equal the host "
                f"replay; the ring one cycle (check {check_s:.3f} s); card {card}")
            log(f"{label} {arm}: wall {wall:.6f} s ({vt:.6f} s virtual): "
                f"{commits / wall:.1f} commits/s through the client beside 4k's "
                f"{run['commits_per_s']:.1f} commits/s and phase 4's {main['tps']:.1f} txn/s "
                f"(no claim); latency p50/p99 (virtual) grv "
                f"{db.latency_samples['grv'].percentile(0.5)} / "
                f"{db.latency_samples['grv'].percentile(0.99)}, commit "
                f"{db.latency_samples['commit'].percentile(0.5)} / "
                f"{db.latency_samples['commit'].percentile(0.99)}; card {card}")
        log(f"{label}: ring load {load_s:.3f} s ({CLIENT_LOAD_TXNS} transactions reading "
            f"every key they set, {len(loaded)} resolve batches)")
    finally:
        hubs.restore()
        el.set_event_loop(None)
    return totals


def check_arm(label, arm, before, after, served):
    """One 4n step's device checks: each kernel launched once a resolve
    batch, every batch a device dispatch, nothing faulted, degraded or fell
    back, and no key past the card's width met the long-key side table."""
    n = len(served)
    if any(v != n for v in after["launches"].values()):
        raise AssertionError(f"{label} {arm}: launches {after['launches']} in {n} batches")
    delta = {k: after[k] - before[k] for k in ("dispatches", "faults", "degraded", "fallbacks",
                                                "side", "host")}
    if delta != dict(dispatches=n, faults=0, degraded=0, fallbacks=0, side=0, host=0):
        raise AssertionError(f"{label} {arm}: {n} batches, counters moved {delta}")


def clients_vs_cpu(torch, api, tk, spans, trace, fr):
    """Phase 6n: client_script through the port's SimCluster(n_resolvers=2,
    n_proxies=2, buggify=True) at CLIENT_VS_CPU_DEPTHS, on cuda and on cpu,
    every resolver over a ConflictSet of CLIENT_SET_KW at that depth, each
    run on fresh port hubs and a fresh loop of one seed: the records equal
    on the two devices, the ring a single cycle, the balancer moved at
    least once; on cuda each kernel launched once in every resolve batch,
    every one of them served by the card: the balancer's 20-byte
    \\xff/conf/resolverSplit, above the card's 16, goes through the
    long-key side table, whose batches are counted.  Returns the launches,
    the resolve batches and the side-table batches over the cuda runs."""
    from foundationdb_tpu_torch import workloads as wl
    from foundationdb_tpu_torch.client import transaction as txmod
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.metrics import wall_now
    from foundationdb_tpu_torch.server import cluster as cm

    tot = dict(launches={n: 0 for n in tk.LAUNCHES}, device=0, batches=0, side=0)
    secs, moves, events = {}, [], 0
    for depth in CLIENT_VS_CPU_DEPTHS:
        runs = {}
        for device in ("cuda", "cpu"):
            t0 = wall_now()
            sets = []

            def make_set():
                sets.append(api.ConflictSet(device=device, pipeline_depth=depth,
                                            **CLIENT_SET_KW))
                return sets[-1]

            hubs = PortHubs(spans, trace, fr)
            for name in tk.LAUNCHES:
                tk.LAUNCHES[name] = 0
            try:
                with resolver_sets(cm, make_set):
                    c = cm.SimCluster(seed=43, n_proxies=2, n_resolvers=2, buggify=True,
                                      device=device)
                runs[device] = client_record(c, wl, txmod)
            finally:
                hubs.restore()
                el.set_event_loop(None)
            secs[(depth, device)] = round(wall_now() - t0, 3)
            if device == "cuda":
                batches = sum(r.metrics.counter("batches").value for r in c.resolvers)
                served = sum(s.device_metrics()["counters"]["batches"] for s in sets)
                longs = [long_key_counts(s) for s in sets]
                launches = dict(tk.LAUNCHES)
                if any(v != batches for v in launches.values()) or served != batches:
                    raise AssertionError(f"client depth {depth}: launches {launches}, "
                                         f"{served} batches served by the card of {batches}")
                if any(lk["host"] for lk in longs):
                    raise AssertionError(f"client depth {depth}: long-key batches {longs}")
                for s in sets:
                    cm_ = s.device_metrics()["counters"]
                    if cm_["device_faults"] or cm_["degraded_batches"] or cm_["cpu_fallbacks"]:
                        raise AssertionError(f"client depth {depth}: counters {cm_}")
                for k, v in launches.items():
                    tot["launches"][k] += v
                tot["device"] += served
                tot["batches"] += batches
                tot["side"] += sum(lk["side"] for lk in longs)
        if runs["cuda"] != runs["cpu"]:
            which = [k for k in runs["cpu"] if runs["cuda"][k] != runs["cpu"][k]]
            raise AssertionError(f"client depth {depth}: cuda and cpu differ in {which}")
        rec = runs["cuda"]
        if not ring_ok(rec["ring"]) or rec["balancer"][1] < 1:
            raise AssertionError(f"client depth {depth}: ring {rec['ring']}, balancer "
                                 f"{rec['balancer']}")
        moves.append(rec["balancer"][1])
        events += len(rec["events"])
    log(f"client vs cpu: client_script (a ResolverBalancer beside Cycle, AtomicLedger, "
        f"WriteSkew and LockDatabase; {events} reads, commits and retries in all) through "
        f"SimCluster(n_resolvers=2, n_proxies=2, buggify=True), every resolver over "
        f"ConflictSet({CLIENT_SET_KW}) at depths {CLIENT_VS_CPU_DEPTHS}: every read, commit, "
        f"error and retry with its virtual time, the clients' state, the ring, the "
        f"balancer's splits and moves {moves}, the workloads, proxies, resolvers, "
        f"coverage and the loop's end equal on cuda and cpu; the rings single cycles; on "
        f"cuda launches {tot['launches']} = {tot['device']} batches served by the card = "
        f"{tot['batches']} resolve batches, {tot['side']} of them through the long-key side "
        f"table (the 20-byte resolverSplit key), none served by the host; "
        f"host seconds a run {secs}; card {torch.cuda.get_device_name(0)}")
    return tot


# ---------------------------------------------------------------------------
# phases 4f and 6f: the durable commit path, crashed and recovered
# ---------------------------------------------------------------------------

# Phase 4f: FoundationDB's restarting test as the reference's
# tests/test_restarting.py models it (run Cycle, kill every process, check
# the ring after the restart), on SimCluster(durable=True) over a card set
# with phase 4's settings, at 4n's shapes: the ring's load, then twice
# CLIENT_ACTORS actors x CLIENT_OPS ops, a crash_and_recover() and the
# ring's check.
DURABLE_SHAPE = dict(nodes=CLIENT_NODES, actors=CLIENT_ACTORS, ops=CLIENT_OPS,
                     load_txns=CLIENT_LOAD_TXNS, crashes=2)
DURABLE_SEED = 31
# Phase 6f: the same script at the reference rig's small shape, on cuda and
# on cpu at each depth.
DURABLE_VS_CPU_SHAPE = dict(nodes=64, actors=32, ops=2, load_txns=8, crashes=2)
DURABLE_VS_CPU_DEPTHS = (1, 2, 3)
DURABLE_SET_KW = dict(key_words=3, h_cap=1 << 10, bucket_mins=(32, 128, 64))


class SetLog:
    """Every batch a ConflictSet `cs` decides, on its side of the Resolver:
    wraps the instance's pipeline_submit (depths 2-3), _detect (depth 1)
    and pipeline_complete_oldest (remove() restores them).  `batches` holds
    [txns, now, new_oldest_version, entry] in decision order (entry: the
    InflightBatch, or a synchronous decision's (statuses, witness));
    `parked` the entries dispatched without a sync and `synced` the entry
    each pipeline_complete_oldest retired, in order; `rows` the device
    history's row count after each synced batch (by the entry's id)."""

    NAMES = ("pipeline_submit", "_detect", "pipeline_complete_oldest")

    def __init__(self, cs):
        self.cs, self.batches, self.parked, self.synced, self.rows = cs, [], [], [], {}
        inner = {n: getattr(cs, n) for n in self.NAMES}
        nested = [0]

        def pipeline_submit(txns, now, new_oldest_version):
            nested[0] += 1
            try:
                entry = inner["pipeline_submit"](txns, now, new_oldest_version)
            finally:
                nested[0] -= 1
            self.batches.append([txns, now, new_oldest_version, entry])
            if not entry.done:
                self.parked.append(entry)
            return entry

        def _detect(txns, now, new_oldest_version):
            statuses = inner["_detect"](txns, now, new_oldest_version)
            if not nested[0]:
                self.batches.append([txns, now, new_oldest_version,
                                     (list(statuses), list(cs.last_witness))])
            return statuses

        def pipeline_complete_oldest():
            entry = cs._pipe[0]
            self.synced.append(entry)
            inner["pipeline_complete_oldest"]()
            if entry.done:
                # Set from the batch's readback, with no sync of its own.
                self.rows[id(entry)] = cs._dev.metrics.gauge("boundary_count").value

        for n, fn in zip(self.NAMES, (pipeline_submit, _detect, pipeline_complete_oldest)):
            setattr(cs, n, fn)

    def outcome(self, i):
        """Batch i's (statuses, witness), or None while it is parked."""
        entry = self.batches[i][3]
        if isinstance(entry, tuple):
            return entry
        return (list(entry.statuses), list(entry.witness)) if entry.done else None

    def record(self) -> list:
        """(now, new_oldest_version, transactions, outcome) a batch."""
        return [(b[1], b[2], len(b[0]), norm(self.outcome(i))) for i, b in enumerate(self.batches)]

    def remove(self):
        for n in self.NAMES:
            delattr(self.cs, n)


class Acks:
    """The commits one package's client acknowledged: wraps the commit of
    `txmod`'s Transaction (remove() restores it); `acks` holds each as (its
    committed version, its mutations as (type, param1, param2)), in the
    order the commits returned, and `times` its virtual time and wall
    seconds (wall_now) when it returned."""

    def __init__(self, txmod):
        from foundationdb_tpu_torch.metrics import wall_now

        self.T = txmod.Transaction
        self.inner = self.T.__dict__["commit"]
        self.acks, self.times = [], []
        inner, acks, times = self.inner, self.acks, self.times

        async def commit(tr):
            v = await inner(tr)
            acks.append((tr.committed_version,
                         [(int(m.type), m.param1, m.param2) for m in tr.mutations]))
            times.append((tr.db.process.network.loop.now(), wall_now()))
            return v

        self.T.commit = commit

    def remove(self):
        self.T.commit = self.inner


def disk_state(fs, full=True):
    """Every machine's files in a SimFileSystem: with `full`, (machine,
    name) -> the durable bytes and the pending (offset, bytes) writes;
    without, machine -> the bytes on its disk (pending writes included)."""
    if full:
        return {k: (bytes(f.durable), [(o, bytes(d)) for o, d in f.pending])
                for k, f in sorted(fs._files.items())}
    out = {}
    for (mid, _name), f in sorted(fs._files.items()):
        end = max([len(f.durable)] + [o + len(d) for o, d in f.pending])
        out[mid] = out.get(mid, 0) + end
    return out


@contextlib.contextmanager
def fixed_gc():
    """While open, cyclic garbage is collected only where the code calls
    gc.collect(), never at the allocator's thresholds.  A role killed by a
    crash leaves its cancelled actors in cycles, and an unanswered Reply
    among them sends broken_promise when collected, which draws a latency
    from the loop's rng: when the collector runs would move every later
    draw.  durable_script collects after each crash while this is open."""
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def durable_script(c, wl, txmod, shape, setlog, export=None, full=True, on=None) -> dict:
    """The restarting test through a durable SimCluster `c` (either
    package's; `wl` and `txmod` are its workloads and client.transaction
    modules) whose resolver 0's set `setlog` watches (a SetLog): a Cycle
    ring of shape["nodes"] nodes under CLIENT_PREFIX, loaded by
    shape["load_txns"] transactions that read every key they set; then
    shape["crashes"] times: shape["actors"] actors x shape["ops"] Cycle
    ops from a new client, at depths 2-3 one more commit sent and the loop
    stepped until the set holds it (or its batch) in flight,
    crash_and_recover(), the workload's check and
    the ring read back through the client, which must equal every
    acknowledged commit's writes applied in version order.  `on(event,
    k)` is called at "loaded", and for arm k at "arm", "armed", "crash",
    "recovered" and "checked".  Returns the record: every read, commit
    and retry with its virtual time (with `full`), the acknowledged
    commits, each arm's commit, conflict and retry counts, the set's
    in-flight batches at each kill, the disks after each crash (`full`:
    every file's bytes and pending writes; else each machine's bytes),
    each ring read back, the set's batches and outcomes, the storage's
    window and engine rows, the sequencer, the set's state (`export`),
    and the loop's end time with its rng's next draw."""
    loop = c.loop
    on = on or (lambda event, k: None)
    nodes, load_txns = shape["nodes"], shape["load_txns"]
    log_, acks = ClientLog(txmod, record=full), None
    rec = dict(arms=[], inflight=[], disks=[], rings=[])
    try:
        acks = Acks(txmod)

        def wait(fut):
            return loop.run_until(fut, timeout_vt=loop.now() + 2000.0)

        ring = wl.CycleWorkload(nodes=nodes, ops=shape["ops"], actors=shape["actors"],
                                prefix=CLIENT_PREFIX)
        keys = [ring._key(i) for i in range(nodes)]
        loader = c.database("durable_loader")

        def load(part):
            async def txn(tr):
                for i in part:
                    await tr.get(keys[i])  # the read covers the write
                    tr.set(keys[i], b"%04d" % ((i + 1) % nodes))
            return loader.run(txn)

        step = nodes // load_txns
        wait(loader.process.spawn(_every([
            loader.process.spawn(load(range(j, j + step)), "load")
            for j in range(0, nodes, step)]), "loads"))
        on("loaded", None)
        for k in range(shape["crashes"]):
            db = c.database(f"durable_{k}")
            before = dict(log_.counts)
            on("arm", k)
            wait(db.process.spawn(ring.start(db, c), f"cycle_{k}"))
            on("armed", k)
            n = {key: v - before.get(key, 0) for key, v in log_.counts.items()}
            rec["arms"].append(dict(
                commits=n.get(("commit", "ok"), 0),
                not_committed=n.get(("commit", "not_committed"), 0),
                retries=sum(v for (m, o), v in n.items() if m == "on_error" and o != "raised")))
            if rec["arms"][-1]["commits"] != shape["actors"] * shape["ops"]:
                raise AssertionError(f"durable arm {k}: counts {n}")
            if setlog.cs.pipeline_depth > 1:
                # Kill with a batch in flight: one more commit (a key off
                # the ring, read first so the client adds no self-conflict
                # key), the loop stepped until the set holds a dispatched,
                # unsynced batch.
                probe = db.process.spawn(_probe(db, CLIENT_PREFIX[:1] + b"f/%d" % k), "probe")
                for _ in range(100_000):
                    if setlog.cs.pipeline_inflight or probe.is_ready():
                        break
                    loop.run_one()
            rec["inflight"].append(setlog.cs.pipeline_inflight)
            on("crash", k)
            c.crash_and_recover()
            if not gc.isenabled():
                gc.collect()  # the old roles' garbage, at a fixed point (fixed_gc)
            rec["disks"].append(disk_state(c.fs, full))
            on("recovered", k)
            if not wait(db.process.spawn(ring.check(db, c), f"check_{k}")):
                raise AssertionError(f"durable crash {k}: the ring is no longer one cycle")
            out = {}

            async def read(tr):
                out["rows"] = await tr.get_range(CLIENT_PREFIX, CLIENT_PREFIX + b"\xff")

            wait(db.process.spawn(db.run(read), f"read_{k}"))
            want = {}
            for _v, muts in sorted(acks.acks, key=lambda a: a[0]):
                for t, key, val in muts:
                    if t == 0 and key.startswith(CLIENT_PREFIX):  # SET_VALUE
                        want[key] = val
            got = dict(out["rows"])
            if got != want:
                bad = sorted(set(got) ^ set(want)) + sorted(
                    x for x in set(got) & set(want) if got[x] != want[x])
                raise AssertionError(f"durable crash {k}: the ring read back differs from the "
                                     f"acknowledged writes at {len(bad)} keys, e.g. {bad[:3]}")
            rec["rings"].append(sorted(got.items()))
            on("checked", k)
        rec["acks"] = list(acks.acks)
    finally:
        if acks is not None:
            acks.remove()
        log_.remove()
    st = c.storage.store
    kv = c.storage.kvstore
    rec.update(
        events=log_.events,
        batches=setlog.record(),
        storage=(norm(st.kv), st.sorted_keys, list(st.clears), c.storage.version.get(),
                 c.storage.durable_version, kv.read_range(b"", b"\xff\xff\xff", 1 << 30)),
        sequencer=(c.sequencer.version, c.sequencer.committed.get()),
        tlog=(c.tlog.versions, norm(c.tlog.entries), c.tlog.popped, c.tlog.durable.get(),
              c.tlog.spilled_through),
        set=export(setlog.cs) if export is not None else None,
        end=(loop.now(), loop.rng.random_int(0, 1 << 30)),
    )
    return rec


async def _probe(db, key):
    """One read-then-write commit of `key`: its outcome's name."""
    tr = db.create_transaction()
    try:
        await tr.get(key)
        tr.set(key, b"1")
        await tr.commit()
        return "committed"
    except Exception as e:  # noqa: BLE001 - the client's FdbError
        return e.name


async def _every(futures):
    """Wait for every future, in order (either package's loop)."""
    for f in futures:
        await f


def durable_path(torch, api, ecpu, tk, spans, trace, fr, main, rates):
    """Phase 4f: the restarting test (durable_script at DURABLE_SHAPE) on
    SimCluster(durable=True, buggify=False) with its file system's default
    KillMode.FULL_CORRUPTION, SimNetwork(deep_copy=False) and fresh port
    hubs, garbage collected at fixed points (fixed_gc); resolver 0's set a
    ConflictSet with phase 4's settings and the transfer guard on,
    rehydrated from phase 4's warm-up state (as 4k's), and one empty
    commit first that lifts the committed version above the state's
    newest.  Checks: each ring one cycle after each crash and equal
    to the acknowledged writes; every batch the set decided, before and
    after each crash, replayed on a host CpuConflictSet rehydrated from the
    same state gives the same verdicts and witnesses; every batch
    dispatched to the card and each dispatched ticket synced exactly once
    and in order (the one in flight at each kill by the next Resolver);
    phase 4's launches a batch, pipeline_dispatches = batches; no fault,
    degraded batch, fallback or long-key batch; mirror_check "ok"; the
    first batch after each recovery drops every older row.  Prints for
    each arm the commits, not_committed, retries, resolve batches, wall
    and commits/s beside 4n's arms (`rates`); for each recovery its host
    seconds, the records each disk queue replayed, the bytes on each
    machine's disk, the batches in flight at the kill and the rows the
    first batch after it evicted; the rebases.  Returns the launches and
    the resolve batches."""
    from foundationdb_tpu_torch import workloads as wl
    from foundationdb_tpu_torch.client import transaction as txmod
    from foundationdb_tpu_torch.client.types import CommitTransactionRef
    from foundationdb_tpu_torch.fileio import KillMode, diskqueue
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.metrics import wall_now
    from foundationdb_tpu_torch.server import interfaces as itf
    from foundationdb_tpu_torch.server.cluster import SimCluster

    gc.collect()
    label = "durable"
    card = torch.cuda.get_device_name(0)
    snap = main["warm_snapshot"]
    newest = max(ch.max_ver for ch in snap.chunks)
    cs = api.ConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, pipeline_depth=2,
                         transfer_guard=True)
    cs._cpu = warm_engine(ecpu, snap)
    eng = cs._dev
    syncs0, rebases0 = eng.host_syncs, eng.rebases
    dispatches0 = eng.metrics.counter("pipeline_dispatches").value
    counters0 = dict(cs.device_metrics()["counters"])
    hubs = PortHubs(spans, trace, fr)
    opened = diskqueue.DiskQueue.__dict__["open"]
    replayed = []

    async def counted(cls, fs, process, filename):
        q, records = await opened.__func__(cls, fs, process, filename)
        if replayed:
            replayed[-1][filename] = len(records)
        return q, records

    marks, at = {}, {}
    setlog = None
    for name in tk.LAUNCHES:
        tk.LAUNCHES[name] = 0
    t0 = wall_now()
    try:
        c = SimCluster(seed=DURABLE_SEED, durable=True, conflict_set=cs, buggify=False)
        c.net.deep_copy = False  # before the first request, as 4k's network
        kill_mode = next(k for k, v in vars(KillMode).items() if v == c.fs.kill_mode)
        loop = c.loop
        setlog = SetLog(cs)
        client = c.net.process("client")
        loop.run_until(loop.delay(0.001), timeout_vt=60.0)
        first = loop.run_until(c.proxy.interface().commit.get_reply(
            client, itf.CommitTransactionRequest(transaction=CommitTransactionRef())),
            timeout_vt=60.0)
        if first <= newest:
            raise AssertionError(f"{label}: the first batch's version {first} is not above the "
                                 f"snapshot's newest {newest}")

        def on(event, k):
            marks[(event, k)] = wall_now()
            at[(event, k)] = len(setlog.batches)
            if event == "crash":
                replayed.append({})

        diskqueue.DiskQueue.open = classmethod(counted)
        with fixed_gc():  # the draws after a crash do not hang on the collector
            rec = durable_script(c, wl, txmod, DURABLE_SHAPE, setlog, full=False, on=on)
        diskqueue.DiskQueue.open = opened
        t_end = wall_now()
        cs.pipeline_drain()
    finally:
        diskqueue.DiskQueue.open = opened
        if setlog is not None:
            setlog.remove()
        hubs.restore()
        el.set_event_loop(None)
    launches = dict(tk.LAUNCHES)
    t_checks = wall_now()
    # Every batch on the card, every ticket synced once and in order.
    n = len(setlog.batches)
    if len(setlog.parked) != n or len(setlog.synced) != n or any(
            a is not b for a, b in zip(setlog.parked, setlog.synced)) or cs.pipeline_inflight:
        raise AssertionError(f"{label}: {n} batches, {len(setlog.parked)} dispatched, "
                             f"{len(setlog.synced)} synced, {cs.pipeline_inflight} in flight")
    per = {k: v // TIMED for k, v in main["launches"].items()}
    dispatches = eng.metrics.counter("pipeline_dispatches").value - dispatches0
    if launches != {k: v * n for k, v in per.items()} or dispatches != n:
        raise AssertionError(f"{label}: launches {launches}, {dispatches} dispatches in {n} "
                             f"batches")
    cm = cs.device_metrics()["counters"]
    moved = {k: cm.get(k, 0) - counters0.get(k, 0)
             for k in ("device_faults", "degraded_batches", "cpu_fallbacks", "long_key_batches",
                       "long_key_host_batches")}
    if any(moved.values()) or eng.cpu_fallbacks:
        raise AssertionError(f"{label}: counters moved {moved}, cpu_fallbacks "
                             f"{eng.cpu_fallbacks}")
    # The host replay of every batch from the same state.
    host = warm_engine(ecpu, snap)
    for i, (txns, now, oldest, entry) in enumerate(setlog.batches):
        st = host.detect(txns, now, oldest)
        if digest(entry.statuses, entry.witness) != digest(st, list(host.last_witness)):
            raise AssertionError(f"{label}: batch {i} at version {now} ({len(txns)} txns): "
                                 f"verdicts or witnesses differ from the host set's")
    t_mirror = wall_now()
    report = cs.mirror_check()
    if report["status"] != "ok":
        raise AssertionError(f"{label}: mirror_check: {report}")
    t_mirror = wall_now() - t_mirror
    # The first batch after each recovery: every older row dropped.
    evicted = []
    for k in range(DURABLE_SHAPE["crashes"]):
        i = at[("crash", k)]
        prev, first_after = setlog.batches[i - 1], setlog.batches[i]
        before, after = setlog.rows[id(prev[3])], setlog.rows[id(first_after[3])]
        writes = sum(len(t.write_ranges) for t in first_after[0])
        if first_after[2] <= prev[1] or after > 2 * writes + 2:
            raise AssertionError(f"{label}: crash {k}: the first batch after it (version "
                                 f"{first_after[1]}, removeBefore {first_after[2]}, {writes} "
                                 f"writes) keeps {after} of {before} rows")
        evicted.append(dict(version=first_after[1], remove_before=first_after[2], rows=before,
                            kept=after, writes=writes))
    arm_walls = [marks[("armed", k)] - marks[("arm", k)] for k in range(len(rec["arms"]))]
    log(f"{label}: SimCluster(durable=True, buggify=False, KillMode.{kill_mode}) over "
        f"ConflictSet(depth 2, transfer_guard=True) from phase 4's state after its warm-up "
        f"({snap.boundary_count} keys, newest version {newest}) on SimNetwork(deep_copy=False); "
        f"one empty commit at version {first}, then a ring of {DURABLE_SHAPE['nodes']} nodes "
        f"loaded by {DURABLE_SHAPE['load_txns']} transactions, and {DURABLE_SHAPE['crashes']} "
        f"times {DURABLE_SHAPE['actors']} actors x {DURABLE_SHAPE['ops']} Cycle ops, a "
        f"crash_and_recover() and the ring's check: each ring one cycle and equal to the "
        f"acknowledged writes ({len(rec['acks'])} acknowledged commits); {n} resolve batches, "
        f"verdicts and witnesses equal the host replay, every ticket synced once and in order, "
        f"launches {launches} = pipeline_dispatches {dispatches} = batches; faults, degraded "
        f"batches, fallbacks and long-key batches 0; mirror_check ok; card {card}")
    for k, (arm, wall) in enumerate(zip(rec["arms"], arm_walls)):
        batches = at[("armed", k)] - at[("arm", k)]
        log(f"{label} arm {k}: {arm['commits']} commits, {arm['not_committed']} not_committed, "
            f"{arm['retries']} retries, {batches} resolve batches; wall {wall:.6f} s, "
            f"{arm['commits'] / wall:.1f} commits/s beside 4n's arms "
            f"{ {a: round(r, 1) for a, r in rates.items()} } commits/s (no claim); card {card}")
    for k, ev in enumerate(evicted):
        secs = marks[("recovered", k)] - marks[("crash", k)]
        log(f"{label} recovery {k}: {secs:.6f} host s for crash_and_recover(); records "
            f"replayed by each disk queue {replayed[k]}; bytes on each machine's disk "
            f"{rec['disks'][k]}; batches in flight at the kill {rec['inflight'][k]}; the first "
            f"batch after it (version {ev['version']}, removeBefore {ev['remove_before']}, "
            f"{ev['writes']} write ranges) merged away all {ev['rows']} rows of the history "
            f"before it, keeping {ev['kept']}; check {marks[('checked', k)] - marks[('recovered', k)]:.6f} s")
    log(f"{label}: rebases {eng.rebases - rebases0}; host syncs/batch "
        f"{(eng.host_syncs - syncs0) / n:.3f}; the phase's host seconds: the script "
        f"{t_end - t0:.3f}, the replay and checks {wall_now() - t_checks - t_mirror:.3f}, "
        f"mirror_check {t_mirror:.3f}")
    del setlog, host, c
    gc.collect()
    return launches, n


def durables_vs_cpu(torch, api, ecpu, tk, spans, trace, fr):
    """Phase 6f: durable_script at DURABLE_VS_CPU_SHAPE through
    SimCluster(durable=True, buggify=True) with resolver 0 over a
    ConflictSet of DURABLE_SET_KW at DURABLE_VS_CPU_DEPTHS, on cuda and on
    cpu, each on fresh port hubs and a fresh loop of one seed: every read,
    commit and retry with its virtual time, every file's bytes and pending
    writes on every machine after each crash, the set's in-flight batches
    at each kill and every batch it decided, the storage's window and
    engine rows, the tlog, the exported set state and the loop's end equal
    on the two devices; on cuda each kernel launched once a batch the card
    served, and the card served every batch."""
    from foundationdb_tpu_torch import workloads as wl
    from foundationdb_tpu_torch.client import transaction as txmod
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.metrics import wall_now
    from foundationdb_tpu_torch.server.cluster import SimCluster

    tot = dict(launches={n: 0 for n in tk.LAUNCHES}, batches=0)
    secs, inflight = {}, {}
    for depth in DURABLE_VS_CPU_DEPTHS:
        runs = {}
        for device in ("cuda", "cpu"):
            t0 = wall_now()
            cs = api.ConflictSet(device=device, pipeline_depth=depth, **DURABLE_SET_KW)
            hubs = PortHubs(spans, trace, fr)
            for name in tk.LAUNCHES:
                tk.LAUNCHES[name] = 0
            setlog = SetLog(cs)
            try:
                with fixed_gc():
                    c = SimCluster(seed=47, durable=True, conflict_set=cs, buggify=True,
                                   device=device)
                    runs[device] = durable_script(c, wl, txmod, DURABLE_VS_CPU_SHAPE, setlog,
                                                  export=lambda s: set_state(ecpu, s))
            finally:
                setlog.remove()
                hubs.restore()
                el.set_event_loop(None)
            secs[(depth, device)] = round(wall_now() - t0, 3)
            if device == "cuda":
                n = len(setlog.batches)
                cm = cs.device_metrics()["counters"]
                launches = dict(tk.LAUNCHES)
                if any(v != n for v in launches.values()) or cm["batches"] != n:
                    raise AssertionError(f"durable depth {depth}: launches {launches}, "
                                         f"{cm['batches']} batches served by the card of {n}")
                if cm["device_faults"] or cm["degraded_batches"] or cm["cpu_fallbacks"]:
                    raise AssertionError(f"durable depth {depth}: counters {cm}")
                for k, v in launches.items():
                    tot["launches"][k] += v
                tot["batches"] += n
        if runs["cuda"] != runs["cpu"]:
            which = [k for k in runs["cpu"] if runs["cuda"][k] != runs["cpu"][k]]
            raise AssertionError(f"durable depth {depth}: cuda and cpu differ in {which}")
        inflight[depth] = runs["cuda"]["inflight"]
    log(f"durable vs cpu: durable_script ({DURABLE_VS_CPU_SHAPE}) through "
        f"SimCluster(durable=True, buggify=True) over ConflictSet({DURABLE_SET_KW}) at depths "
        f"{DURABLE_VS_CPU_DEPTHS}: every read, commit and retry with its virtual time, every "
        f"file's bytes and pending writes after each crash, the batches in flight at each kill "
        f"{inflight}, every batch's verdicts and witnesses, the storage, the tlog, the set's "
        f"state and the loop's end equal on cuda and cpu; the rings one cycle; on cuda "
        f"launches {tot['launches']} = {tot['batches']} batches, all served by the card; host "
        f"seconds a run {secs}; card {torch.cuda.get_device_name(0)}")
    return tot


# ---------------------------------------------------------------------------
# phases 4m and 6m: the acceptance workloads through the client
# ---------------------------------------------------------------------------

# Phase 4m's cluster: one proxy, so that the resolver sees whole batches, and
# one resolver over a card set at the Resolver's key width (16 bytes: the
# workloads' keys are 11-13 bytes and the client's self-conflict keys 14)
# with phase 4's presized flat history; the Resolver's defaults otherwise.
ACCEPT_KEY_WORDS = 4
ACCEPT_SEED = 29
# Step 1, BASELINE.json config 3 (RandomReadWrite, 1 resolver, 10k-txn
# batches, uniform keys, low contention): 10,240 single-transaction actors
# spawned together over 400,000 nodes (an in-batch read meets an earlier
# write of the batch about 7% of the time), after the workload's setup
# population (every fourth node, b"init") loaded in transactions of at most
# ACCEPT_LOAD_SETS sets.
ACCEPT_RRW = dict(nodes=400_000, actors=10_240, txns_per_actor=1)
ACCEPT_LOAD_SETS = 4096
# Step 2, config 2 (WriteDuringRead, small keyspace, high contention): the
# acceptance shape with 100 transactions instead of 10.  Step 3: FuzzApi at
# its test shape.
ACCEPT_WDR = dict(nodes=25, contention_actors=3, txns=100)
ACCEPT_FUZZ = dict(nodes=20, txns=15)
# Phase 6m: configs 2 and 3 at the reference's exact acceptance shapes and
# seeds (tests/test_acceptance_matrix.py), on cuda and cpu at each depth, at
# phase 6n's set shape.
ACCEPT_VS_CPU_DEPTHS = (1, 2, 3)
ACCEPT_TIMEOUT = 30000.0  # virtual s, the reference tests' run_workloads timeout
ACCEPT_CONFIGS = {
    "config 2": dict(seed=9001, prefix=b"\x02wdr/", cluster=dict(n_proxies=2),
                     load=("WriteDuringReadWorkload",
                           dict(nodes=25, txns=10, contention_actors=3))),
    "config 3": dict(seed=9002, prefix=b"rrw/", cluster=dict(n_proxies=2),
                     load=("RandomReadWriteWorkload",
                           dict(nodes=120, actors=3, txns_per_actor=6))),
}


def final_state(c, prefix):
    """Every row under `prefix` on SimCluster `c`, read by a fresh client in
    one transaction (tests/test_acceptance_matrix.py's _final_state)."""
    db = c.database("final_reader")

    async def read():
        tr = db.create_transaction()
        return await tr.get_range(prefix, prefix + b"\xff")

    return c.run_until(db.process.spawn(read(), "final"), timeout_vt=5000.0)


def acceptance_record(c, wl, txmod, config) -> dict:
    """One of ACCEPT_CONFIGS through run_workloads on a SimCluster `c` (of
    either package; `wl` and `txmod` its workloads and client modules):
    every read, commit and retry (ClientLog), each client's state, the
    workload's record (its attributes after the run), whether its check
    held, the final state under its prefix read by a fresh client in one
    transaction, the proxies' and resolvers' registries and the resolvers'
    witness blocks, and the loop's end time with its rng's next draw."""
    cfg = ACCEPT_CONFIGS[config]
    name, kw = cfg["load"]
    log_ = ClientLog(txmod)
    dbs = tracked_databases(c)
    w = getattr(wl, name)(**kw)
    try:
        try:
            wl.run_workloads(c, [w], timeout_vt=ACCEPT_TIMEOUT)
            check = True
        except AssertionError as e:  # the runner's assert on a check's False
            if "check failed" not in str(e):
                raise
            check = False
        state = final_state(c, cfg["prefix"])
    finally:
        log_.remove()
    return dict(
        events=log_.events,
        clients=client_state(dbs),
        workload=norm(dict(vars(w))),
        check=check,
        state=state,
        proxies=[p.metrics.snapshot_json() for p in c.proxies],
        resolvers=[r.metrics.snapshot_json() for r in c.resolvers],
        witness=[r.conflict_witness() for r in c.resolvers],
        end=(c.loop.now(), c.loop.rng.random_int(0, 1 << 30)),
    )


class SideShadow:
    """Which resolve batches a ConflictSet's long-key side table must take,
    worked out from the requests and their replies alone, in version
    order: a batch holding a key longer than the card's `width` bytes, or
    one with a read that meets a live region, the width-byte prefix of a
    long end that a committed transaction wrote at a version the window
    still holds (conflict/long_keys.py's rule)."""

    def __init__(self, width, window):
        self.width, self.window = width, window
        self.live, self.oldest = [], 0  # (lo, hi or None, version)

    def _region(self, k):
        t = k[: self.width].rstrip(b"\xff")
        return k[: self.width], (t[:-1] + bytes([t[-1] + 1]) if t else None)

    def count(self, served):
        """(batches with a key past the width, batches the side table takes)
        of the replayed requests `served`, after every earlier call's."""
        from foundationdb_tpu_torch.conflict.types import COMMITTED

        w, long_, side = self.width, 0, 0
        for q, f in served:
            self.live = [r for r in self.live if r[2] >= self.oldest]
            txns = q.transactions
            has_long = any(len(k) > w for t in txns
                           for b, e in t.read_ranges + t.write_ranges for k in (b, e))
            meets = any(lo < e and (hi is None or b < hi) for t in txns
                        for b, e in t.read_ranges for lo, hi, _v in self.live)
            long_ += has_long
            side += has_long or meets
            for t, st in zip(txns, f.get().committed):
                if st != COMMITTED:
                    continue
                for b, e in t.write_ranges:
                    if b >= e:
                        continue
                    if len(b) > w:
                        self.live.append((*self._region(b), q.version))
                    if len(e) > w and not (len(b) > w and b[:w] == e[:w]):
                        self.live.append((*self._region(e), q.version))
            self.oldest = q.version - self.window
        return long_, side


def acceptance_path(torch, api, ecpu, tk, spans, trace, fr, main, rates):
    """Phase 4m: the acceptance workloads through the client on a card set
    at full width.  SimCluster(n_proxies=1, n_resolvers=1, buggify=False)
    over ConflictSet(key_words=ACCEPT_KEY_WORDS, h_cap=H_CAP) on the card
    (the Resolver's defaults otherwise, depth 2), on SimNetwork(deep_copy=
    False) and fresh port hubs; three steps on the one cluster, each
    after the last: (1) RandomReadWriteWorkload(ACCEPT_RRW)'s setup rows
    loaded in transactions of ACCEPT_LOAD_SETS sets, then its start and
    check; (2) WriteDuringReadWorkload(ACCEPT_WDR) through run_workloads,
    its check holding with no mismatch and conflicts; (3)
    FuzzApiWorkload(ACCEPT_FUZZ) through run_workloads.  Every resolve
    request is replayed on a host CpuConflictSet (verdicts and witnesses
    equal); in each step each kernel launches once a resolve batch, every
    batch is a device dispatch, no fault, degraded batch or fallback, no
    batch served by the host, and the long-key side table takes exactly
    the batches SideShadow names from the replay (none in steps 1 and 2);
    mirror_check "ok" at the end.  Prints for each step the
    commits, not_committed and retries, the resolve batches and their
    sizes, the launches, the wall and commits/s beside 4k's and phase 4's
    (no claim; RandomReadWrite's over its start, its check apart).  Returns the launches and batches of all three steps."""
    import dataclasses

    from foundationdb_tpu_torch import workloads as wl
    from foundationdb_tpu_torch.client import transaction as txmod
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.flow.eventloop import all_of
    from foundationdb_tpu_torch.metrics import wall_now
    from foundationdb_tpu_torch.server.cluster import SimCluster

    gc.collect()
    label = "acceptance"
    card = torch.cuda.get_device_name(0)
    width = ACCEPT_KEY_WORDS * 4
    t_build = wall_now()
    cs = api.ConflictSet(key_words=ACCEPT_KEY_WORDS, h_cap=H_CAP)
    eng = cs._dev
    hubs = PortHubs(spans, trace, fr)
    totals = {"launches": {n: 0 for n in tk.LAUNCHES}, "batches": 0, "rates": {}}
    try:
        c = SimCluster(seed=ACCEPT_SEED, conflict_set=cs, n_proxies=1, n_resolvers=1,
                       buggify=False)
        c.net.deep_copy = False  # before the first request, as 4k's network
        loop = c.loop
        resolves = []
        for p in c.proxies:
            p.resolvers = [dataclasses.replace(r, resolve=Recorded(r.resolve, resolves))
                           for r in p.resolvers]
        rp = Replay(ecpu.CpuConflictSet(key_words=ACCEPT_KEY_WORDS),
                    c.resolver.max_write_transaction_life_versions)
        rp.log = resolves
        shadow = SideShadow(width, rp.window)
        build_s = wall_now() - t_build

        def wait(fut, budget=3000.0):
            return loop.run_until(fut, timeout_vt=loop.now() + budget)

        def settle():
            for _ in range(1000):
                if all(f.is_ready() for _q, f in rp.log[rp.done:]):
                    break
                wait(loop.delay(0.001))
            else:
                raise AssertionError(f"{label}: resolve requests still unanswered")
            return rp.replay(label)

        def counters():
            m = cs.device_metrics()["counters"]
            return dict(launches=dict(tk.LAUNCHES),
                        dispatches=eng.metrics.counter("pipeline_dispatches").value,
                        faults=m["device_faults"], degraded=m["degraded_batches"],
                        fallbacks=eng.cpu_fallbacks, **long_key_counts(cs))

        def step(name, run, split=None):
            """Run `run()` from zeroed launches, settle and replay its
            resolve requests, check the card's counters; returns its
            ClientLog counts, wall and batch sizes.  `split`, when given,
            holds the seconds of the run's start and check and the
            start's commits, filled by `run`: its commits/s is then over
            the start alone."""
            log_ = ClientLog(txmod, record=False)
            before = counters()
            for n in tk.LAUNCHES:
                tk.LAUNCHES[n] = 0
            v0, t0 = loop.now(), wall_now()
            try:
                run()
            finally:
                log_.remove()
            wall, vt = wall_now() - t0, loop.now() - v0
            served = settle()
            after = counters()
            n = len(served)
            long_, side = shadow.count(served)
            if any(v != n for v in after["launches"].values()):
                raise AssertionError(f"{label} {name}: launches {after['launches']} in {n} "
                                     f"batches")
            delta = {k: after[k] - before[k] for k in ("dispatches", "faults", "degraded",
                                                        "fallbacks", "side", "host")}
            if delta != dict(dispatches=n, faults=0, degraded=0, fallbacks=0, side=side,
                             host=0):
                raise AssertionError(f"{label} {name}: {n} batches ({long_} with a key past "
                                     f"{width} bytes, {side} for the side table), counters "
                                     f"moved {delta}")
            for k, v in after["launches"].items():
                totals["launches"][k] += v
            totals["batches"] += n
            counts = log_.counts
            commits = counts.get(("commit", "ok"), 0)
            retries = sum(v for (m, o), v in counts.items() if m == "on_error" and o != "raised")
            sizes = sorted(len(q.transactions) for q, _f in served)
            nonempty = [s for s in sizes if s]
            log(f"{label} {name}: {commits} commits, "
                f"{counts.get(('commit', 'not_committed'), 0)} not_committed, {retries} retries "
                f"({ {o: v for (m, o), v in sorted(counts.items()) if m == 'on_error'} }); {n} "
                f"resolve batches ({n - len(nonempty)} empty), sizes min "
                f"{nonempty[0] if nonempty else 0} median "
                f"{nonempty[len(nonempty) // 2] if nonempty else 0} max "
                f"{nonempty[-1] if nonempty else 0}, {sum(sizes)} transactions; launches "
                f"{after['launches']} = {delta['dispatches']} device dispatches = batches; every "
                f"batch's verdicts and witnesses equal the host replay; faults, degraded, "
                f"fallbacks and host-served batches 0, long-key side-table batches "
                f"{delta['side']} = the replay's ({long_} with a key past {width} bytes, the "
                f"rest reading a live region); card {card}")
            if split is None:
                rate = f"{commits / wall:.1f} commits/s through the client over the step"
            else:
                rate = (f"{split['commits'] / split['start']:.1f} commits/s through the client "
                        f"over its start ({split['commits']} commits in {split['start']:.6f} s; "
                        f"its check {split['check']:.6f} s apart)")
            log(f"{label} {name}: wall {wall:.6f} s ({vt:.6f} s virtual): {rate} beside 4k's "
                f"{rates['cluster']:.1f} commits/s and phase 4's {main['tps']:.1f} txn/s "
                f"(no claim); card {card}")
            return counts, wall, sizes

        # Step 1: RandomReadWrite.
        rrw = wl.RandomReadWriteWorkload(**ACCEPT_RRW)
        db = c.database("rrw")
        keys = [rrw._key(i) for i in range(0, rrw.nodes, 4)]  # the setup's rows

        def load(part):
            async def txn(tr):
                for k in part:
                    tr.set(k, b"init")
            return db.run(txn)

        step("rrw load", lambda: wait(all_of([
            db.process.spawn(load(keys[j:j + ACCEPT_LOAD_SETS]), "rrw_load")
            for j in range(0, len(keys), ACCEPT_LOAD_SETS)])))
        phases = {}

        def start_and_check():
            t0 = wall_now()
            wait(db.process.spawn(rrw.start(db, c), "rrw_start"))
            t1 = wall_now()
            phases["ok"] = wait(db.process.spawn(rrw.check(db, c), "rrw_check"))
            phases.update(start=t1 - t0, check=wall_now() - t1, commits=rrw.committed)

        _counts, _wall, sizes = step("rrw", start_and_check, split=phases)
        if not phases["ok"] or rrw.committed != rrw.actors * rrw.txns_per_actor:
            raise AssertionError(f"{label} rrw: check {phases['ok']}, {rrw.committed} committed")
        big = [s for s in sizes if s]
        log(f"{label} rrw: RandomReadWriteWorkload({ACCEPT_RRW}) after its {len(keys)} setup "
            f"rows in transactions of at most {ACCEPT_LOAD_SETS} sets: {rrw.committed} "
            f"committed; start {phases['start']:.3f} s, check ok in {phases['check']:.3f} s; "
            f"resolve batches of 10,000 transactions or more: "
            f"{sum(s >= 10_000 for s in big)} of {len(big)} (the proxy's 2 ms batch interval "
            f"cuts them; the workload and proxy are as they are)")
        # Step 2: WriteDuringRead.
        wdr = wl.WriteDuringReadWorkload(**ACCEPT_WDR)
        step("wdr", lambda: wl.run_workloads(c, [wdr]))
        if wdr.mismatches or not wdr.conflicts or not wdr.committed_txns:
            raise AssertionError(f"{label} wdr: mismatches {wdr.mismatches[:3]}, conflicts "
                                 f"{wdr.conflicts}, committed {wdr.committed_txns}")
        log(f"{label} wdr: WriteDuringReadWorkload({ACCEPT_WDR}): the memory model held "
            f"(mismatches 0), {wdr.committed_txns} committed and {wdr.conflicts} conflicted of "
            f"the driver's {wdr.txns} (history by outcome "
            f"{ {k: sum(h[0] == k for h in wdr.history) for k in sorted({h[0] for h in wdr.history})} })")
        # Step 3: FuzzApi.
        fuzz = wl.FuzzApiWorkload(**ACCEPT_FUZZ)
        step("fuzz", lambda: wl.run_workloads(c, [fuzz]))
        if fuzz.failures or len(fuzz.errors_exercised) < 3:
            raise AssertionError(f"{label} fuzz: failures {fuzz.failures[:3]}, errors "
                                 f"{fuzz.errors_exercised}")
        log(f"{label} fuzz: FuzzApiWorkload({ACCEPT_FUZZ}): no failed contract, errors "
            f"exercised {sorted(fuzz.errors_exercised)}")
        t_mirror = wall_now()
        report = cs.mirror_check()
        if report["status"] != "ok":
            raise AssertionError(f"{label}: mirror_check: {report}")
        log(f"{label}: SimCluster(n_proxies=1, n_resolvers=1, buggify=False) over "
            f"ConflictSet(key_words={ACCEPT_KEY_WORDS}, h_cap={H_CAP}, depth "
            f"{cs.pipeline_depth}) built in {build_s:.3f} s; launches {totals['launches']} = "
            f"{totals['batches']} resolve batches over the three steps; mirror_check ok "
            f"({report['boundaries']} boundaries, {wall_now() - t_mirror:.3f} s); card {card}")
    finally:
        hubs.restore()
        el.set_event_loop(None)
    del c, cs, eng, rp
    gc.collect()
    return totals


def acceptance_vs_cpu(torch, api, tk, spans, trace, fr):
    """Phase 6m: ACCEPT_CONFIGS (configs 2 and 3 at the reference's exact
    acceptance shapes and seeds) through the port's SimCluster at
    ACCEPT_VS_CPU_DEPTHS, every resolver over a ConflictSet of
    CLIENT_SET_KW at that depth on cuda and on cpu, each run on fresh port
    hubs and a fresh loop: the records (acceptance_record) equal on the
    two devices; at depth 1 also the host engine's (conflict_backend=
    "cpu") reads, commits, retries, workload record, check and final
    state, the reference's acceptance bar; config 2's check holding at
    depth 1 with no mismatch and conflicts, config 3's 18 commits at every
    depth; on cuda each kernel launched once in every resolve batch, every
    one served by the card, nothing faulted, degraded or fell back.
    Returns the launches and resolve batches over the cuda runs."""
    from foundationdb_tpu_torch import workloads as wl
    from foundationdb_tpu_torch.client import transaction as txmod
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.metrics import wall_now
    from foundationdb_tpu_torch.server import cluster as cm

    tot = dict(launches={n: 0 for n in tk.LAUNCHES}, batches=0)
    secs, checks, outcomes = {}, {}, {}
    for depth in ACCEPT_VS_CPU_DEPTHS:
        for config, cfg in ACCEPT_CONFIGS.items():
            runs = {}
            for device in ("cuda", "cpu", "host") if depth == 1 else ("cuda", "cpu"):
                t0 = wall_now()
                sets = []

                def make_set():
                    sets.append(api.ConflictSet(device=device, pipeline_depth=depth,
                                                **CLIENT_SET_KW))
                    return sets[-1]

                hubs = PortHubs(spans, trace, fr)
                for name in tk.LAUNCHES:
                    tk.LAUNCHES[name] = 0
                try:
                    if device == "host":
                        c = cm.SimCluster(seed=cfg["seed"], conflict_backend="cpu",
                                          **cfg["cluster"])
                    else:
                        with resolver_sets(cm, make_set):
                            c = cm.SimCluster(seed=cfg["seed"], device=device, **cfg["cluster"])
                    runs[device] = acceptance_record(c, wl, txmod, config)
                finally:
                    hubs.restore()
                    el.set_event_loop(None)
                secs[(config, depth, device)] = round(wall_now() - t0, 3)
                if device == "cuda":
                    batches = sum(r.metrics.counter("batches").value for r in c.resolvers)
                    served = sum(s.device_metrics()["counters"]["batches"] for s in sets)
                    launches = dict(tk.LAUNCHES)
                    if any(v != batches for v in launches.values()) or served != batches:
                        raise AssertionError(f"acceptance {config} depth {depth}: launches "
                                             f"{launches}, {served} batches served by the card "
                                             f"of {batches}")
                    for s in sets:
                        cm_ = s.device_metrics()["counters"]
                        if (cm_["device_faults"] or cm_["degraded_batches"]
                                or cm_["cpu_fallbacks"] or cm_.get("long_key_batches", 0)):
                            raise AssertionError(f"acceptance {config} depth {depth}: "
                                                 f"counters {cm_}")
                    for k, v in launches.items():
                        tot["launches"][k] += v
                    tot["batches"] += batches
            if runs["cuda"] != runs["cpu"]:
                which = [k for k in runs["cpu"] if runs["cuda"][k] != runs["cpu"][k]]
                raise AssertionError(f"acceptance {config} depth {depth}: cuda and cpu differ "
                                     f"in {which}")
            rec = runs["cuda"]
            if depth == 1:
                same = ("events", "workload", "check", "state")
                which = [k for k in same if runs["host"][k] != rec[k]]
                if which:
                    raise AssertionError(f"acceptance {config} depth 1: the set and the host "
                                         f"engine differ in {which}")
            w = dict(rec["workload"])
            if config == "config 2":
                if w["mismatches"] or (depth == 1 and not (rec["check"] and w["conflicts"])):
                    raise AssertionError(f"acceptance {config} depth {depth}: check "
                                         f"{rec['check']}, {w['mismatches'][:3]}, history "
                                         f"{w['history']}")
                outcomes[(config, depth)] = (w["committed_txns"], w["conflicts"])
            else:
                if w["committed"] != 18 or not rec["check"]:
                    raise AssertionError(f"acceptance {config} depth {depth}: check "
                                         f"{rec['check']}, {w['committed']} committed")
                outcomes[(config, depth)] = (w["committed"], 0)
            checks[(config, depth)] = rec["check"]
    log(f"acceptance vs cpu: configs 2 and 3 at the reference's acceptance shapes "
        f"({ {k: v['load'] for k, v in ACCEPT_CONFIGS.items()} }) through SimCluster(n_proxies=2), "
        f"every resolver over ConflictSet({CLIENT_SET_KW}) at depths {ACCEPT_VS_CPU_DEPTHS}: "
        f"every read, commit, error and retry with its virtual time, the clients' state, the "
        f"workload's record and check, the final state, the proxies, resolvers and the loop's "
        f"end equal on cuda and cpu; at depth 1 the reads, commits, retries, record, check and "
        f"final state also equal the host engine's; (committed, conflicts) {outcomes}; checks "
        f"{checks}; on cuda launches {tot['launches']} = {tot['batches']} resolve batches, every "
        f"one served by the card; host seconds a run {secs}; card {torch.cuda.get_device_name(0)}")
    return tot


# ---------------------------------------------------------------------------
# phases 4b and 6b: admission control and data distribution
# ---------------------------------------------------------------------------


class DDLog:
    """Every move, split, auto_split and auto_merge of one package's
    DataDistributor (the class in `ddmod`; remove() restores it): `events`
    holds each as (method, virtual start, virtual end, arguments, outcome
    or ("error", exception type, message)), payloads through norm();
    `walls` the host seconds of each, in the same order."""

    NAMES = ("move", "split", "auto_split", "auto_merge")

    def __init__(self, ddmod):
        from foundationdb_tpu_torch.metrics import wall_now

        D = ddmod.DataDistributor
        self.D, self.events, self.walls = D, [], []
        self.saved = {n: D.__dict__[n] for n in self.NAMES}
        for name in self.NAMES:
            inner = self.saved[name]

            async def call(dd, *a, _name=name, _inner=inner, **kw):
                loop, w0 = dd.loop, wall_now()
                t0 = loop.now()
                try:
                    v = await _inner(dd, *a, **kw)
                except Exception as e:  # noqa: BLE001 - recorded, re-raised
                    self.events.append((_name, t0, loop.now(), norm((a, kw)),
                                        ("error", type(e).__name__, str(e))))
                    self.walls.append(wall_now() - w0)
                    raise
                self.events.append((_name, t0, loop.now(), norm((a, kw)), norm(v)))
                self.walls.append(wall_now() - w0)
                return v

            setattr(D, name, call)

    def remove(self):
        for name, fn in self.saved.items():
            setattr(self.D, name, fn)


def dd_state(c) -> list:
    """Each storage of SimCluster `c` after a run: its id, whether its
    process is alive, its window (every key's version chain, the clears)
    and the ranges it owns."""
    return [(s.storage_id, s.process.alive, norm(s.store.kv), list(s.store.clears),
             [(b, e, v) for b, e, v in s.owned.items()]) for s in c.storages]


def recorded_ratekeeper(rkmod):
    """The Ratekeeper class of `rkmod` whose instances keep every RateInfo
    they set, with its virtual time, in ``series``."""

    class Recorded(rkmod.Ratekeeper):
        def __setattr__(self, key, value):
            if key == "rate":
                self.__dict__.setdefault("series", []).append(
                    (self.process.network.loop.now(), dataclasses.asdict(value)))
            super().__setattr__(key, value)

    return Recorded


class RateTap:
    """A RatekeeperInterface stand-in on a proxy's side: every rate fetch
    passes to `iface`, and `log` gets (virtual time, tps) when its reply
    arrives, the moment the proxy starts to spend at that rate."""

    def __init__(self, iface, loop, log):
        self.get_rate = self
        self.iface, self.loop, self.log = iface, loop, log

    def get_reply(self, src, request):
        f = self.iface.get_rate.get_reply(src, request)

        def arrived(f):
            if not f.is_error():
                self.log.append((self.loop.now(), f.get().tps))

        f.add_callback(arrived)
        return f


class ReleaseTap:
    """Proxy `p`'s GRV latency sample, standing in for it: the virtual time
    of each read version `p` releases (its sample, added as the reply goes
    out) is appended to `log`."""

    def __init__(self, p, log):
        self.sample, self.loop, self.log = p.latency_samples["grv"], p.process.network.loop, log
        p.latency_samples["grv"] = self

    def add(self, x):
        self.log.append(self.loop.now())
        self.sample.add(x)

    def __getattr__(self, name):
        return getattr(self.sample, name)


def grv_spans(fetched, released, end):
    """One proxy's read-version releases by the rate it spent at: its rate
    fetches `fetched` ((time, tps), in order) cut [first fetch, end) into
    spans of one rate; returns [(tps, start, stop, releases)] with equal
    neighbours merged."""
    spans = []
    for i, (t, tps) in enumerate(fetched):
        stop = fetched[i + 1][0] if i + 1 < len(fetched) else end
        n = sum(t <= r < stop for r in released)
        if spans and spans[-1][0] == tps:
            spans[-1] = (tps, spans[-1][1], stop, spans[-1][3] + n)
        else:
            spans.append((tps, t, stop, n))
    return spans


def grv_within_budget(spans, edge) -> bool:
    """Each span's releases at most its rate times its length, plus the
    budget's burst (a tenth of a second at that rate, test_grv_rate_limited's
    bound) and `edge`: the proxy spends the budget for a batch of requests
    before the batch's sequencer round trip, so one batch (at most one
    request a client) spent at the rate before goes out after the edge."""
    return all(n <= tps * (b - a) + max(1.0, 0.1 * tps) + edge for tps, a, b, n in spans)


# Phase 4b: admission control and data distribution at full width.  4n's
# ring (CLIENT_NODES nodes under CLIENT_PREFIX, loaded by CLIENT_LOAD_TXNS
# transactions that read what they set); then Cycle ops beside
# RandomMoveKeysWorkload(moves=ADMIT_MOVES) and a DD role, and a dispatch
# outage that begins once the arm has ADMIT_OUTAGE[0] of its commits and
# is held ADMIT_OUTAGE[1] virtual s.  The arm is ADMIT_CLIENTS clients of
# one actor each (each attempt asks for its own read version) x ADMIT_OPS
# ops, not 4n's 1,024 actors x 2 ops: those end 0.065 virtual s after they
# start (a CPU run of this script), before the proxies' next rate fetch
# (every 0.1 s), and one client's actors share each read version, so no
# rate could bind them.
ADMIT_SEED = 37
ADMIT_CLIENTS = 48
ADMIT_OPS = 48
ADMIT_MOVES = 6
ADMIT_OUTAGE = (0.25, 0.25)
# At 64 clients the script took 977.5 s on an NVIDIA H100 80GB HBM3's host
# (4b 39.8 s of it), past its 900 s target, so 48.  The ratekeeper samples every 0.05 s.  max_tps (each
# proxy's budget) is set as the reference's make_rated_cluster sets it:
# without a rate the arm makes about 4,050 attempts a virtual second,
# 1,800-2,300 read versions a proxy (a CPU run of this script), so the open
# cap (4,000 a proxy) does not bind and the degraded cap (1,000) does.
ADMIT_MAX_TPS = 4000.0
ADMIT_SAMPLE = 0.05
ADMIT_DD = dict(tracker_interval=0.5)  # tests/test_dd_role.py's fast_dd


def admission_script(c, cs, inj, shape, max_tps=ADMIT_MAX_TPS, on=None) -> dict:
    """Phase 4b's script through the port's SimCluster `c`, whose resolver
    0 serves over ConflictSet `cs` with fault injector `inj`: a Ratekeeper
    (every RateInfo kept) over the cluster's tlogs, storages, resolvers
    and proxies at `max_tps`, attached to every proxy through a RateTap;
    the ring's load; RandomMoveKeysWorkload's setup, a DD role at ADMIT_DD
    kept inactive while the workload's moves run (the workload holds the
    move lock, as FoundationDB's RandomMoveKeys takes DD's MoveKeysLock);
    then concurrently CycleWorkload(nodes, ops, actors=1) from each of
    shape["clients"] clients, the workload's moves and the outage
    (`inj.begin_outage("dispatch")` once the arm has shape["outage"][0] of
    its commits, ended shape["outage"][1] virtual s later); then the loop runs
    until the breaker and the rate are "ok" again and DD has no move queued,
    in flight or half done; the role stops.  `on(event)` is called at
    "loaded", "arm", "outage", "restored", "armed" and "settled".
    Returns the record: the ratekeeper, the rate series, transitions, each
    proxy's rate fetches and releases, the breaker's walk, the workload's
    and role's counts, DDLog's events and walls, the arm's ClientLog counts
    and acknowledged commits, the outage's virtual times, and the ring's
    rows read back by a fresh client."""
    from foundationdb_tpu_torch import workloads as wl
    from foundationdb_tpu_torch.client import transaction as txmod
    from foundationdb_tpu_torch.flow.eventloop import all_of
    from foundationdb_tpu_torch.flow import testprobe
    from foundationdb_tpu_torch.server import data_distribution as ddmod
    from foundationdb_tpu_torch.server import ratekeeper as rkmod

    loop = c.loop
    on = on or (lambda event: None)
    rk = recorded_ratekeeper(rkmod)(
        c.master_proc, c.tlogs, c.storages, resolvers=c.resolvers, proxies=c.proxies,
        max_tps=max_tps, sample_interval=ADMIT_SAMPLE)
    fetched, released = [[] for _ in c.proxies], [[] for _ in c.proxies]
    for i, p in enumerate(c.proxies):
        p.ratekeeper = RateTap(rk.interface(), loop, fetched[i])
        ReleaseTap(p, released[i])
    nodes, n_load = shape["nodes"], shape["load_txns"]
    # One actor a client, so that each attempt asks for its own read version.
    ring = wl.CycleWorkload(nodes=nodes, ops=shape["ops"], actors=1, prefix=CLIENT_PREFIX)
    keys = [ring._key(i) for i in range(nodes)]
    rec = dict(marks={})
    log_, acks, ddlog = ClientLog(txmod, record=False), None, DDLog(ddmod)
    deferred0 = testprobe.hit_sites.get("grv_batch_deferred", 0)
    try:
        acks = Acks(txmod)

        def wait(fut, budget=3000.0):
            return loop.run_until(fut, timeout_vt=loop.now() + budget)

        def mark(event):
            rec["marks"][event] = loop.now()
            on(event)

        loader = c.database("admission_loader")

        def load(part):
            async def txn(tr):
                for i in part:
                    await tr.get(keys[i])  # the read covers the write
                    tr.set(keys[i], b"%04d" % ((i + 1) % nodes))
            return loader.run(txn)

        step = nodes // n_load
        wait(all_of([loader.process.spawn(load(range(j, j + step)), "load")
                     for j in range(0, nodes, step)]))
        mark("loaded")
        db = c.database("admission")
        rmk = wl.RandomMoveKeysWorkload(moves=shape["moves"], prefix=CLIENT_PREFIX, nodes=nodes)
        wait(db.process.spawn(rmk.setup(db, c), "rmk_setup"))
        lock = [True]
        role = c.dd_role(active_fn=lambda: not lock[0], **ADMIT_DD)
        want = shape["clients"] * shape["ops"]
        committed0 = dict(log_.counts)

        def commits():
            return log_.counts.get(("commit", "ok"), 0) - committed0.get(("commit", "ok"), 0)

        async def moves():
            await rmk.start(db, c)
            lock[0] = False  # the workload's moves done: DD's lock back to the role
            mark("moved")

        async def outage():
            while commits() < want * shape["outage"][0]:
                await loop.delay(0.001)
            inj.begin_outage("dispatch")
            mark("outage")
            await loop.delay(shape["outage"][1])
            inj.end_outage("dispatch")
            mark("restored")

        clients = [c.database(f"admission{i}") for i in range(shape["clients"])]

        async def cycle():
            await all_of([d.process.spawn(ring.start(d, c), "cycle") for d in clients])
            mark("armed")

        mark("arm")
        wait(all_of([db.process.spawn(cycle(), "cycle"), db.process.spawn(moves(), "moves"),
                     db.process.spawn(outage(), "outage")]))
        counts = {k: v - committed0.get(k, 0) for k, v in log_.counts.items()}

        async def settled():
            while True:
                smap = await role.dd.read_shard_map()
                if (cs._breaker.state == "ok" and rk.rate.backend_state == "ok"
                        and not role._queue and not role._inflight
                        and not any(d for _b, _e, _t, d in smap)):
                    return smap
                await loop.delay(0.25)

        smap = wait(db.process.spawn(settled(), "settled"))
        role.stop()
        wait(loop.delay(0.5))  # every proxy's map past the last move
        mark("settled")
        checker = c.database("admission_checker")
        ok = wait(checker.process.spawn(ring.check(checker, c), "ring_check"))
        out = {}

        async def read(tr):
            out["rows"] = await tr.get_range(CLIENT_PREFIX, CLIENT_PREFIX + b"\xff")

        wait(checker.process.spawn(checker.run(read), "ring_read"))
        rec.update(
            ring_ok=ok, rows=out["rows"], shard_map=smap, counts=counts,
            acks=list(acks.acks), ack_times=list(acks.times), performed=rmk.performed,
            role=dict(moves=role.moves_done, heals=role.heals_done, splits=role.splits_done,
                      merges=role.merges_done),
            deferred=testprobe.hit_sites.get("grv_batch_deferred", 0) - deferred0)
    finally:
        if acks is not None:
            acks.remove()
        log_.remove()
        ddlog.remove()
    rec.update(
        rk=rk, series=rk.__dict__.get("series", []), transitions=rk.transition_log_json(),
        fetched=fetched, released=released, breaker=[list(t) for t in cs._breaker.transitions],
        dd_events=ddlog.events, dd_walls=ddlog.walls, end=loop.now())
    return rec


def admission_checks(label, rec, c, max_tps, edge, frac=0.25) -> dict:
    """Phase 4b's checks of admission_script's record `rec` on cluster `c`
    (the replay and the launches are the caller's): the ring one cycle and
    equal to the acknowledged writes; each acknowledged write read back,
    through the final shard map, from every storage of its shard's team;
    the rate "ok" before the outage and after the breaker closed, at most
    frac x max_tps with `limiting` "backend_degraded" while it was open;
    the transitions ok -> degraded -> ok; each proxy's releases within the
    budget of each rate it spent at (grv_within_budget, `edge` requests
    across each edge) and some at the degraded rate; at least one move and
    one split.
    Returns the states' spans of each proxy and the series' states."""
    from foundationdb_tpu_torch.server import interfaces as itf

    if not rec["ring_ok"]:
        raise AssertionError(f"{label}: the ring is no longer one cycle")
    want = {}
    for _v, muts in sorted(rec["acks"], key=lambda a: a[0]):
        for t, key, val in muts:
            if t == 0 and key.startswith(CLIENT_PREFIX):  # SET_VALUE
                want[key] = val
    got = dict(rec["rows"])
    if got != want:
        raise AssertionError(f"{label}: the ring read back differs from the acknowledged writes "
                             f"at {len(set(got) ^ set(want))} keys")
    # Every storage of each user shard's team holds the shard's rows.
    loop = c.loop
    by_id = {s.storage_id: s for s in c.storages}
    version = c.proxies[0].committed.get()
    reader = c.net.process("admission_replicas")
    teams = 0
    for b, e, team, dest in rec["shard_map"]:
        if dest:
            raise AssertionError(f"{label}: shard {b!r} still moving to {dest}")
        lo, hi = max(b, CLIENT_PREFIX), min(e or b"\xff", CLIENT_PREFIX + b"\xff")
        if b >= b"\xff" or lo >= hi:
            continue
        shard = {k: v for k, v in want.items() if lo <= k < hi}
        for sid in team:
            rep = loop.run_until(by_id[sid].interface().get_key_values.get_reply(
                reader, itf.GetKeyValuesRequest(begin=lo, end=hi, version=version,
                                                limit=1 << 30)),
                timeout_vt=loop.now() + 60.0)
            if dict(rep.data) != shard:
                raise AssertionError(f"{label}: {sid} serves {len(rep.data)} rows of shard "
                                     f"[{lo!r}, {hi!r}), the acknowledged writes {len(shard)}")
        teams += 1
    # The rate in each state.
    t_out, t_back = rec["marks"]["outage"], rec["marks"]["restored"]
    states = [(t, r["backend_state"], r["tps"], r["limiting"]) for t, r in rec["series"]]
    before = [s for s in states if s[0] <= t_out]
    if not before or any(s[1] != "ok" or s[2] != max_tps for s in before):
        raise AssertionError(f"{label}: the rate before the outage {before[-3:]}")
    sick = [s for s in states if s[1] != "ok"]
    if not sick or any(s[2] > frac * max_tps or s[3] != "backend_degraded" for s in sick):
        raise AssertionError(f"{label}: the rate while the breaker was open {sick[:3]}")
    if states[-1][1:] != ("ok", max_tps, "none") or sick[-1][0] < t_back - ADMIT_SAMPLE:
        raise AssertionError(f"{label}: the rate after the outage {states[-1]}, the last "
                             f"degraded sample at {sick[-1][0]}, the outage ended {t_back}")
    walk = [(f, t) for _n, f, t, _r in json.loads(rec["transitions"])]
    if walk != [("none", "backend_degraded"), ("backend_degraded", "none")]:
        raise AssertionError(f"{label}: transitions {rec['transitions']}")
    spans = [grv_spans(f, r, rec["end"]) for f, r in zip(rec["fetched"], rec["released"])]
    if not all(grv_within_budget(s, edge) for s in spans):
        raise AssertionError(f"{label}: releases over budget: {spans}")
    if not any(tps < max_tps and n for s in spans for tps, _a, _b, n in s):
        raise AssertionError(f"{label}: no read version went out at the degraded rate: {spans}")
    done = [e for e in rec["dd_events"] if not (isinstance(e[4], tuple) and e[4][:1] == ("error",))]
    moves = [e for e in done if e[0] == "move"]
    splits = [e for e in done if e[0] == "split"]
    if not moves or not splits:
        raise AssertionError(f"{label}: {len(moves)} moves and {len(splits)} splits")
    return dict(spans=spans, states=states, teams=teams)


class SubmitLaunches:
    """Each batch a ConflictSet `cs` admits through pipeline_submit (an
    instance attribute wrapping it; remove() restores it): `turns` holds
    (dispatched to the card, the kernels' launches during the submit)."""

    def __init__(self, cs, tk):
        self.cs, self.turns = cs, []
        inner = cs.pipeline_submit

        def submit(txns, now, new_oldest_version):
            before = dict(tk.LAUNCHES)
            entry = inner(txns, now, new_oldest_version)
            self.turns.append((not entry.done,
                               {k: tk.LAUNCHES[k] - before[k] for k in before}))
            return entry

        cs.pipeline_submit = submit

    def remove(self):
        del self.cs.pipeline_submit


def admission_replay_checks(label, c, cs, host, resolves, n_first, counters0, turns, inj):
    """Phase 4b's checks that need no card: every resolve request of
    `resolves` (a Recorded log; the first `n_first` before the script)
    replayed in version order on `host` (a CpuConflictSet holding the set's
    starting state) gives the served verdicts and witnesses; each batch the
    script submitted (`turns`, SubmitLaunches's) is one resolve request, and
    those dispatched to the card are the set's pipeline_dispatches since
    `counters0`; the long-key side table took exactly the batches
    SideShadow names from the replay and served none on the host alone; the
    faults are the injector's, and the breaker opened and closed once.
    Returns the replayed requests, the batches with a long key and those
    for the side table, the counters moved and the card-dispatched
    batches."""
    window = c.resolver.max_write_transaction_life_versions
    rp = Replay(host, window)
    rp.log = resolves
    served = rp.replay(label)
    if len(served) != len(resolves):
        raise AssertionError(f"{label}: {len(resolves) - len(served)} resolve requests "
                             f"unanswered")
    shadow = SideShadow(cs._long.width, window)
    shadow.count(served[:n_first])
    long_, side = shadow.count(served[n_first:])
    cm = cs.device_metrics()["counters"]
    moved = {k: cm.get(k, 0) - counters0.get(k, 0)
             for k in ("pipeline_dispatches", "device_faults", "degraded_batches",
                       "long_key_batches", "long_key_host_batches", "breaker_opens",
                       "breaker_closes", "rehydrates")}
    device = sum(d for d, _l in turns)
    if len(turns) != len(served) - n_first or moved["pipeline_dispatches"] != device:
        raise AssertionError(f"{label}: {len(turns)} batches submitted ({device} to the card), "
                             f"{len(served) - n_first} resolve requests, pipeline_dispatches "
                             f"{moved['pipeline_dispatches']}")
    if moved["long_key_batches"] != side or moved["long_key_host_batches"]:
        raise AssertionError(f"{label}: long-key side-table batches {moved['long_key_batches']} "
                             f"(host-served {moved['long_key_host_batches']}), the replay's {side}")
    if moved["device_faults"] != len(inj.injected) or not inj.injected or \
            moved["breaker_opens"] != 1 or moved["breaker_closes"] != 1:
        raise AssertionError(f"{label}: {len(inj.injected)} faults injected, counters {moved}")
    return served, long_, side, moved, device


def admission_path(torch, api, ecpu, tk, faults, spans, trace, fr, main, rates):
    """Phase 4b: admission control and data distribution at full width.
    SimCluster(n_proxies=2, n_tlogs=2, n_storages=3, buggify=False) on
    SimNetwork(deep_copy=False) and fresh port hubs, resolver 0's set a
    ConflictSet with phase 4's settings and a DeviceFaultInjector,
    rehydrated from phase 4's warm-up state (as 4f's), one empty commit
    lifting it past the state's newest version; then admission_script at
    ADMIT_* (a Ratekeeper at ADMIT_MAX_TPS on every proxy, the ring,
    RandomMoveKeys, a DD role, the dispatch outage).  Checks
    (admission_checks, and): every resolve request replayed on a host
    CpuConflictSet from the same state gives the same verdicts and
    witnesses; each kernel launched once in every batch the card served
    and never in one the mirror served, launches = pipeline_dispatches;
    the long-key side table took exactly the batches SideShadow names from
    the replay, none host-served; faults = the outage's dispatches.  Prints
    the commits, not_committed and retries, the resolve batches and
    sizes, the rate's samples, the transitions, each proxy's read versions
    by rate, commits/s in the ok and degraded spans beside 4n's arms
    (`rates`), DD's moves, splits and merges with each one's virtual and
    host seconds, the side-table batches and the phase's host seconds.
    Returns the launches, the card-served and the mirror-served batches."""
    from foundationdb_tpu_torch.client.types import CommitTransactionRef
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.metrics import wall_now
    from foundationdb_tpu_torch.server import interfaces as itf
    from foundationdb_tpu_torch.server.cluster import SimCluster

    gc.collect()
    label = "admission"
    card = torch.cuda.get_device_name(0)
    t_start = wall_now()
    snap = main["warm_snapshot"]
    newest = max(ch.max_ver for ch in snap.chunks)
    inj = faults.DeviceFaultInjector()
    cs = api.ConflictSet(key_words=KEY_WORDS, h_cap=H_CAP, pipeline_depth=2,
                         fault_injector=inj)
    cs._cpu = warm_engine(ecpu, snap)
    eng = cs._dev
    hubs = PortHubs(spans, trace, fr)
    shape = dict(nodes=CLIENT_NODES, load_txns=CLIENT_LOAD_TXNS, clients=ADMIT_CLIENTS,
                 ops=ADMIT_OPS, moves=ADMIT_MOVES, outage=ADMIT_OUTAGE)
    walls, sub = {}, None
    try:
        c = SimCluster(seed=ADMIT_SEED, conflict_set=cs, n_proxies=2, n_tlogs=2, n_storages=3,
                       buggify=False)
        c.net.deep_copy = False  # before the first request, as 4k's network
        loop = c.loop
        resolves = []
        for p in c.proxies:
            p.resolvers = [dataclasses.replace(r, resolve=Recorded(r.resolve, resolves))
                           for r in p.resolvers]
        client = c.net.process("client")
        loop.run_until(loop.delay(0.001), timeout_vt=60.0)
        first = loop.run_until(c.proxy.interface().commit.get_reply(
            client, itf.CommitTransactionRequest(transaction=CommitTransactionRef())),
            timeout_vt=60.0)
        if first <= newest:
            raise AssertionError(f"{label}: the first batch's version {first} is not above the "
                                 f"snapshot's newest {newest}")
        n_first = len(resolves)
        counters0 = dict(cs.device_metrics()["counters"])
        sub = SubmitLaunches(cs, tk)
        for name in tk.LAUNCHES:
            tk.LAUNCHES[name] = 0
        t0 = wall_now()
        rec = admission_script(c, cs, inj, shape, on=lambda e: walls.__setitem__(e, wall_now()))
        cs.pipeline_drain()
        t_script = wall_now() - t0
        launches = dict(tk.LAUNCHES)
    finally:
        if sub is not None:
            sub.remove()
        hubs.restore()
        el.set_event_loop(None)
    t_checks = wall_now()
    checked = admission_checks(label, rec, c, ADMIT_MAX_TPS, edge=ADMIT_CLIENTS)
    served, long_, side, moved, device = admission_replay_checks(
        label, c, cs, warm_engine(ecpu, snap), resolves, n_first, counters0, sub.turns, inj)
    turns = sub.turns
    bad = [(j, d, k) for j, (d, k) in enumerate(turns)
           if any(v != (1 if d else 0) for v in k.values())]
    if bad or any(v != device for v in launches.values()):
        raise AssertionError(f"{label}: launches {launches}, {device} batches dispatched to the "
                             f"card of {len(turns)}; batches whose launches are not one a card "
                             f"batch and none a mirror batch: {bad[:3]}")
    t_checks = wall_now() - t_checks
    # Prints.
    n = rec["counts"]
    retries = sum(v for (m_, o), v in n.items() if m_ == "on_error" and o != "raised")
    sizes = sorted(len(q.transactions) for q, _f in served[n_first:])
    nonempty = [x for x in sizes if x]
    log(f"{label}: SimCluster(n_proxies=2, n_tlogs=2, n_storages=3, buggify=False) over "
        f"ConflictSet(depth 2) from phase 4's state after its warm-up ({snap.boundary_count} "
        f"keys) with a DeviceFaultInjector, on SimNetwork(deep_copy=False); one empty commit at "
        f"version {first}; Ratekeeper(max_tps={ADMIT_MAX_TPS}, sample_interval={ADMIT_SAMPLE}) "
        f"on both proxies; a ring of {CLIENT_NODES} nodes loaded by {CLIENT_LOAD_TXNS} "
        f"transactions, then {ADMIT_CLIENTS} clients x {ADMIT_OPS} Cycle ops beside "
        f"RandomMoveKeysWorkload(moves={ADMIT_MOVES}) and a DD role ({ADMIT_DD}), a dispatch "
        f"outage from {ADMIT_OUTAGE[0]:.0%} of the arm's commits for {ADMIT_OUTAGE[1]} virtual s; "
        f"card {card}")
    log(f"{label}: {n.get(('commit', 'ok'), 0)} commits, "
        f"{n.get(('commit', 'not_committed'), 0)} not_committed, {retries} retries "
        f"({ {o: v for (m_, o), v in sorted(n.items()) if m_ == 'on_error'} }); "
        f"{len(sizes)} resolve batches ({len(sizes) - len(nonempty)} empty), sizes min "
        f"{nonempty[0] if nonempty else 0} median {nonempty[len(nonempty) // 2] if nonempty else 0} "
        f"max {nonempty[-1] if nonempty else 0}; {device} served by the card, "
        f"{len(turns) - device} by the mirror; launches {launches} = pipeline_dispatches "
        f"{moved['pipeline_dispatches']}, one a card batch and none a mirror batch; every "
        f"batch's verdicts and witnesses equal the host replay; faults {moved['device_faults']}, "
        f"degraded batches {moved['degraded_batches']}, rehydrations {moved['rehydrates']}; "
        f"long-key side-table batches {moved['long_key_batches']} = the replay's ({long_} with "
        f"a key past {KEY_WORDS * 4} bytes, the rest reading a live region), host-served 0")
    runs, last = [], None
    for t, r in rec["series"]:
        key = (r["tps"], r["limiting"], r["backend_state"])
        if key != last:
            runs.append([round(t, 6), round(t, 6), *key, 1])
            last = key
        else:
            runs[-1][1] = round(t, 6)
            runs[-1][5] += 1
    log(f"{label}: the rate's {len(rec['series'])} samples as runs [first, last virtual s, tps, "
        f"limiting, backend_state, samples]: {runs}; transitions {rec['transitions']}; the "
        f"breaker {[(t[1], t[2]) for t in rec['breaker']]}; the outage "
        f"{rec['marks']['outage']:.6f}-{rec['marks']['restored']:.6f} virtual s")
    for i, sp in enumerate(checked["spans"]):
        log(f"{label}: proxy {i}'s read versions by the rate it spent at [tps, from, to, released, "
            f"released a virtual s]: "
            f"{[(tps, round(a, 6), round(b, 6), k, round(k / (b - a), 1) if b > a else None) for tps, a, b, k in sp]}; "
            f"batch lane: released 0, deferred {rec['deferred']}")
    spans_ok = [(rec["marks"]["arm"], rec["marks"]["outage"])]
    sick_at = [t for t, st, _tps, _l in checked["states"] if st != "ok"]
    back = max(b for sp in checked["spans"] for tps, _a, b, _k in sp if tps < ADMIT_MAX_TPS)
    spans_deg = [(min(a for sp in checked["spans"] for tps, a, _b, _k in sp if tps < ADMIT_MAX_TPS),
                  back)]
    spans_ok.append((back, rec["marks"]["armed"]))

    def per_s(bounds):
        """Commits in the virtual spans `bounds`, over the host seconds
        from each span's first commit to its last, and the spans' virtual
        length."""
        n, wall = 0, 0.0
        for a, b in bounds:
            got = [w for v, w in rec["ack_times"] if a <= v < b]
            n += len(got)
            wall += got[-1] - got[0] if got else 0.0
        return n, (n / wall if wall > 0 else None), sum(b - a for a, b in bounds)

    for name, bounds in (("ok", spans_ok), ("degraded", spans_deg)):
        k, cps, vt = per_s(bounds)
        log(f"{label} {name}: {k} commits in {[(round(a, 6), round(b, 6)) for a, b in bounds]} "
            f"virtual s ({vt} s), {cps if cps is None else round(cps, 1)} commits/s of host "
            f"time beside 4n's arms { {a: round(r, 1) for a, r in rates.items()} } commits/s "
            f"(no claim); the rate's first degraded sample at {sick_at[0] if sick_at else None}")
    dd = [(e[0], round(e[1], 6), round(e[2], 6), e[3], e[4], round(w, 6))
          for e, w in zip(rec["dd_events"], rec["dd_walls"])]
    log(f"{label}: DD (RandomMoveKeys {rec['performed']} moves; the role {rec['role']}): "
        f"[method, virtual start, virtual end, arguments, outcome, host s]: {dd}; the final "
        f"shard map {[(b, e, t) for b, e, t, _d in rec['shard_map']]}; every acknowledged write "
        f"read back from each storage of its shard's team ({checked['teams']} user shards)")
    log(f"{label}: the phase's host seconds: the set and cluster "
        f"{t0 - t_start:.3f}, the script {t_script:.3f} (the ring's load "
        f"{walls['loaded'] - t0:.3f}, the arm {walls['armed'] - walls['arm']:.3f}, to settled "
        f"{walls['settled'] - walls['armed']:.3f}), the replay and checks {t_checks:.3f}; "
        f"card {card}")
    del c, cs, eng
    gc.collect()
    return launches, device, len(turns) - device


# Phase 6b: the depths, the settings of tests/test_dd_role.py's hot-shard
# case and the sharded spring's split points and rate.
ADMIT_VS_CPU_DEPTHS = (1, 2, 3)
HOT_DD = dict(tracker_interval=0.5, shard_max_bytes=3000, shard_min_bytes=0)
SPRING_SPLITS = [b"\x40", b"\x80", b"\xc0"]
SPRING_MAX_TPS = 4000.0


def signals_record(c, rkmod, txmod) -> dict:
    """tests/test_ratekeeper.py's test_resolver_signals_feed_ratekeeper
    through the port's SimCluster `c`: a Ratekeeper (max_tps 100,000, every
    RateInfo kept) over the tlog, the storage and the resolvers on the
    proxy; 20 writes, 0.6 virtual s; the resolver's signal snapshot and its
    `signals` reply.  Returns the record: every read, commit and retry, the
    rate series, the transitions, both signals less the wall-derived
    cpu_mirror_tps, the resolvers' registries and witness blocks, the
    loop's end."""
    rk = recorded_ratekeeper(rkmod)(c.master_proc, [c.tlog], [c.storage], max_tps=100000.0)
    c.proxy.ratekeeper = rk.interface()
    rk.resolvers = list(c.resolvers)
    db = c.database()
    log_ = ClientLog(txmod)
    out = {}
    try:
        async def writes():
            for i in range(20):
                tr = db.create_transaction()
                tr.set(b"rs%02d" % i, b"v")
                await tr.commit()
            await c.loop.delay(0.6)

        c.run_all([(db, writes())], timeout_vt=100.0)

        async def probe():
            out["sig"] = await c.resolver.interface().signals.get_reply(db.process, None)

        c.run_until(db.process.spawn(probe(), "probe"), timeout_vt=50.0)
    finally:
        log_.remove()

    def signal(x):
        return {k: v for k, v in dataclasses.asdict(x).items() if k != "cpu_mirror_tps"}

    return dict(events=log_.events, series=rk.series, transitions=rk.transition_log_json(),
                snap=signal(c.resolver.signal_snapshot()), sig=signal(out["sig"]),
                resolvers=[r.metrics.snapshot_json() for r in c.resolvers],
                witness=[r.conflict_witness() for r in c.resolvers],
                end=(c.loop.now(), c.loop.rng.random_int(0, 1 << 30)))


def hot_shard_record(c, ddmod, txmod) -> dict:
    """tests/test_dd_role.py's test_hot_shard_splits_and_rebalances through
    the port's SimCluster `c` (two storages): the shard map seeded on ss0
    and split at \\xff, a DD role at HOT_DD, four transactions of 60 40-byte
    writes under b"h", the loop run until the role split a shard and ss1
    holds one, the rows read back.  Returns the record: every read, commit
    and retry, DD's log (DDLog), each storage's rows and owned ranges, the
    role's counts, the rows, the resolvers' witness blocks, the loop's
    end."""
    log_, ddlog = ClientLog(txmod), DDLog(ddmod)
    db = c.database()
    dd = c.data_distributor()
    loop = c.loop
    out = {}
    try:
        async def place():
            await dd.register_storages(dd.storages)
            await dd.seed(["ss0"])
            await dd.split(b"\xff")

        c.run_until(db.process.spawn(place()), timeout_vt=500.0)
        role = c.dd_role(dd, **HOT_DD)
        for j in range(4):
            async def txn(tr, j=j):
                for i in range(60):
                    tr.set(b"h%d%03d" % (j, i), b"x" * 40)

            c.run_all([(db, db.run(txn))], timeout_vt=500.0)

        async def rebalanced():
            while True:
                per = {}
                for b, _e, team, dest in await dd.read_shard_map():
                    if b < b"\xff" and not dest:
                        for sid in team:
                            per[sid] = per.get(sid, 0) + 1
                if role.splits_done >= 1 and per.get("ss1", 0) >= 1:
                    return True
                await loop.delay(0.25)

        out["ok"] = c.run_until(db.process.spawn(rebalanced()), timeout_vt=900.0)

        async def read(tr):
            out["rows"] = await tr.get_range(b"h", b"i")

        c.run_all([(db, db.run(read))], timeout_vt=500.0)
        role.stop()
    finally:
        log_.remove()
        ddlog.remove()
    return dict(events=log_.events, moves=ddlog.events, state=dd_state(c),
                role=(role.moves_done, role.splits_done, role.merges_done), ok=out["ok"],
                rows=out["rows"], witness=[r.conflict_witness() for r in c.resolvers],
                end=(loop.now(), loop.rng.random_int(0, 1 << 30)))


def spring_record(c, rkmod, txmod, max_tps=SPRING_MAX_TPS) -> dict:
    """The breaker driving the rate, through the port's SimCluster `c`
    whose resolver's set has a scripted fault: a Ratekeeper at `max_tps`
    sampling every 0.05 s over the tlogs, storages, resolvers and proxies
    on every proxy; one client commits a write every 0.1 s, 16 of them
    spread over the key space, noting the resolver's backend state after
    each.  Returns the record: the rate series, the transitions, the
    states, every read, commit and retry, the loop's end."""
    rk = recorded_ratekeeper(rkmod)(c.master_proc, c.tlogs, c.storages, sample_interval=0.05,
                                    resolvers=c.resolvers, proxies=c.proxies, max_tps=max_tps)
    for p in c.proxies:
        p.ratekeeper = rk.interface()
    db = c.database()
    log_ = ClientLog(txmod)
    states = []
    try:
        async def writes():
            for i in range(16):
                tr = db.create_transaction()
                tr.set(bytes([(i * 53) % 256]) + b"/%02d" % i, b"v")
                await tr.commit()
                states.append(c.resolver.signal_snapshot().backend_state)
                await c.loop.delay(0.1)

        c.run_all([(db, writes())], timeout_vt=100.0)
    finally:
        log_.remove()
    return dict(series=rk.series, transitions=rk.transition_log_json(), states=states,
                events=log_.events, end=(c.loop.now(), c.loop.rng.random_int(0, 1 << 30)))


def spring_checks(label, rec, max_tps, cap):
    """The rate `max_tps` before and after the breaker walk, at most `cap`
    with limiting "backend_degraded" while it was not "ok", and the
    transitions none -> backend_degraded -> none."""
    states = [(r["backend_state"], r["tps"], r["limiting"]) for _t, r in rec["series"]]
    sick = [x for x in states if x[0] != "ok"]
    walk = [(f, t) for _n, f, t, _r in json.loads(rec["transitions"])]
    if (not sick or any(t > cap * (1 + 1e-12) or lim != "backend_degraded" for _s, t, lim in sick)
            or states[0] != ("ok", max_tps, "none") or states[-1] != states[0]
            or walk != [("none", "backend_degraded"), ("backend_degraded", "none")]):
        raise AssertionError(f"{label}: the rate {states}, transitions {rec['transitions']}")
    return sick


def card_served(label, sets, launches, tot) -> int:
    """A cuda run's card checks over its ConflictSets `sets`: each kernel
    launched once in every batch, every batch served by the card, nothing
    faulted, degraded, fell back or was host-served for its long keys.
    Adds the launches and batches to `tot`; returns the long-key
    side-table batches."""
    served = sum(s.device_metrics()["counters"]["batches"] for s in sets)
    counters = [s.device_metrics()["counters"] for s in sets]
    if served == 0 or any(v != served for v in launches.values()) or any(
            c["device_faults"] or c["degraded_batches"] or c["cpu_fallbacks"]
            or c.get("long_key_host_batches", 0) for c in counters):
        raise AssertionError(f"{label}: launches {launches}, {served} batches served by the "
                             f"card, counters {counters}")
    for k, v in launches.items():
        tot["launches"][k] += v
    tot["batches"] += served
    return sum(c.get("long_key_batches", 0) for c in counters)


def admission_vs_cpu(torch, api, sr, tk, faults, spans, trace, fr):
    """Phase 6b: on cuda and on cpu, each on fresh port hubs and a fresh
    loop: signals_record (seed 73) and hot_shard_record (seed 173, two
    storages) through the port's SimCluster with every resolver over a
    ConflictSet of CLIENT_SET_KW at each of ADMIT_VS_CPU_DEPTHS; and
    spring_record (seed 75) over a 4-shard ShardedTorchConflictSet split at
    SPRING_SPLITS whose shard 1 faults at its 3rd-5th dispatches.  The
    records equal on the two devices: every read, commit and retry with
    its virtual time, the rate series and the transitions, DD's log, each
    storage's rows and owned ranges (so the final \\xff/keyServers/ rows),
    the witness blocks, the loop's end and next draw.  The hot shard split
    and rebalanced; the sharded rate is ((4 - 1) + 1 x 0.25) / 4 = 0.8125
    of SPRING_MAX_TPS while shard 1's breaker is open, and whole again
    after.  On cuda each kernel launched once in every resolve batch, the
    card serving every one, the DD's system keys through the long-key side
    table and none host-served.  Returns the launches and batches over the
    cuda runs."""
    from foundationdb_tpu_torch.client import transaction as txmod
    from foundationdb_tpu_torch.flow import eventloop as el
    from foundationdb_tpu_torch.metrics import wall_now
    from foundationdb_tpu_torch.server import cluster as cm
    from foundationdb_tpu_torch.server import data_distribution as ddmod
    from foundationdb_tpu_torch.server import ratekeeper as rkmod

    tot = dict(launches={n: 0 for n in tk.LAUNCHES}, batches=0)
    secs, side = {}, {}

    def run(device, seed, script, make_set=None, conflict_set=None, **kw):
        hubs = PortHubs(spans, trace, fr)
        sets = []
        for name in tk.LAUNCHES:
            tk.LAUNCHES[name] = 0
        t0 = wall_now()
        try:
            if make_set is not None:
                def made():
                    sets.append(make_set())
                    return sets[-1]

                with resolver_sets(cm, made):
                    c = cm.SimCluster(seed=seed, device=device, **kw)
            else:
                c = cm.SimCluster(seed=seed, conflict_set=conflict_set, device=device, **kw)
            rec = script(c)
        finally:
            hubs.restore()
            el.set_event_loop(None)
        return rec, sets, dict(tk.LAUNCHES), round(wall_now() - t0, 3)

    for depth in ADMIT_VS_CPU_DEPTHS:
        for name, seed, script, kw in (
                ("signals", 73, lambda c: signals_record(c, rkmod, txmod), {}),
                ("hot shard", 173, lambda c: hot_shard_record(c, ddmod, txmod),
                 dict(n_storages=2))):
            runs = {}
            for device in ("cuda", "cpu"):
                rec, sets, launches, secs[(name, depth, device)] = run(
                    device, seed, script, make_set=lambda device=device: api.ConflictSet(
                        device=device, pipeline_depth=depth, **CLIENT_SET_KW), **kw)
                runs[device] = rec
                if device == "cuda":
                    side[(name, depth)] = card_served(f"{name} depth {depth}", sets, launches,
                                                      tot)
            if runs["cuda"] != runs["cpu"]:
                which = [k for k in runs["cpu"] if runs["cuda"][k] != runs["cpu"][k]]
                raise AssertionError(f"{name} depth {depth}: cuda and cpu differ in {which}")
            if name == "hot shard" and (not runs["cuda"]["ok"] or len(runs["cuda"]["rows"]) != 240):
                raise AssertionError(f"hot shard depth {depth}: {runs['cuda']['role']}, "
                                     f"{len(runs['cuda']['rows'])} rows")
            if name == "signals" and runs["cuda"]["snap"]["backend_state"] != "ok":
                raise AssertionError(f"signals depth {depth}: {runs['cuda']['snap']}")
    hot = runs["cuda"]
    runs = {}
    for device in ("cuda", "cpu"):
        inj = faults.DeviceFaultInjector()
        inj.script("dispatch", at=3, persist=3, shard=1)
        cs = sr.ShardedTorchConflictSet(SPRING_SPLITS, device=device, fault_injector=inj,
                                        **CLIENT_SET_KW)
        runs[device], _sets, launches, secs[("sharded spring", None, device)] = run(
            device, 75, lambda c: spring_record(c, rkmod, txmod), conflict_set=cs,
            buggify=False)
        if device == "cuda" and (not all(launches.values()) or len(inj.injected) != 3):
            raise AssertionError(f"sharded spring: launches {launches}, injected {inj.injected}")
    if runs["cuda"] != runs["cpu"]:
        which = [k for k in runs["cpu"] if runs["cuda"][k] != runs["cpu"][k]]
        raise AssertionError(f"sharded spring: cuda and cpu differ in {which}")
    sick = spring_checks("sharded spring", runs["cuda"], SPRING_MAX_TPS,
                         0.8125 * SPRING_MAX_TPS)
    if any(r != ("degraded", 0.8125 * SPRING_MAX_TPS, "backend_degraded") for r in sick):
        raise AssertionError(f"sharded spring: the degraded samples {sick}")
    log(f"admission vs cpu: the twins of test_resolver_signals_feed_ratekeeper (seed 73) and "
        f"test_hot_shard_splits_and_rebalances (seed 173) through SimCluster with every resolver "
        f"over ConflictSet({CLIENT_SET_KW}) at depths {ADMIT_VS_CPU_DEPTHS}, and the sharded "
        f"spring (seed 75: 4 shards, shard 1 faulting at its 3rd-5th dispatches): every read, "
        f"commit and retry with its virtual time, the rate series and transitions, DD's log "
        f"(the last hot-shard run: {len(hot['moves'])} calls, the role's moves, splits and "
        f"merges {hot['role']}), each storage's rows and owned ranges, the witnesses and the "
        f"loop's end equal on cuda and cpu; the sharded rate "
        f"{sick[0][1]} = 0.8125 x {SPRING_MAX_TPS} in {len(sick)} samples, then whole, "
        f"transitions {runs['cuda']['transitions']}; on cuda launches {tot['launches']} = "
        f"{tot['batches']} batches, all served by the card, long-key side-table batches "
        f"{side}, none host-served; host seconds a run {secs}; card "
        f"{torch.cuda.get_device_name(0)}")
    return tot


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


def chaos_path(torch, api, ecpu, batches, tk, faults, buggify, DR, want, obs, warm_from):
    """Phase 6c(a): phase 4's set, stream and seed under the port's random
    faults at full width, from phase 4's state after its warm-up
    (`warm_from`, rehydrated onto the card before the clock starts) over
    its timed batches WARM .. WARM + TIMED - 1.  The buggify sites are
    armed (activated probability 1.0) on a DeterministicRandom, the
    injector runs in random mode, and an open-ended dispatch outage holds
    batches CHAOS_OUTAGE.
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
    cs._cpu = warm_engine(ecpu, warm_from)
    t_warm = time.perf_counter()
    cs._rehydrate_from_mirror()  # what the first dispatch would do, before the clock
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t_warm
    rehydrates0 = cs._dev.metrics.counter("rehydrates").value
    first = WARM

    def stream():
        for i in range(first, WARM + TIMED):
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

    if digests != want[first:WARM + TIMED]:
        bad = first + next(i for i, (a, b) in enumerate(zip(digests, want[first:])) if a != b)
        raise AssertionError(f"chaos: batch {bad}'s verdicts or witnesses differ from phase 4's")
    transitions = cs._breaker.transitions
    if walk_end("chaos", transitions) != "ok":
        raise AssertionError(f"chaos: the breaker ends {cs._breaker.state}")
    injected = inj.injected
    if not injected or counters["device_faults"] != len(injected):
        raise AssertionError(f"chaos: {len(injected)} faults injected, device_faults "
                             f"{counters['device_faults']}")
    if not reh or len(reh) != counters["rehydrates"] - rehydrates0:
        raise AssertionError(f"chaos: rehydrates {counters['rehydrates']} (the warm start's "
                             f"{rehydrates0}), timed {len(reh)}")
    if not any(site.startswith("device_fault_") for site in buggify_cov["fired_counts"]):
        raise AssertionError(f"chaos: no device fault site fired: {buggify_cov}")
    for j, kind, _s, after, _r in turns:
        i = first + j
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
    degraded = [first + i for i, kind, _s, _l, _r in turns if kind == "degraded"]
    # A turn's host time: its submit (dispatch, or the mirror's detect)
    # and the completion of the batch before it.
    device_ms = [s * 1e3 for i, kind, s, _l, r in turns
                 if kind == "device" and r == (turns[i - 1][4] if i else 0)]
    degraded_ms = [s * 1e3 for _i, kind, s, _l, _r in turns if kind == "degraded"]
    n_run = WARM + TIMED - first
    log(f"chaos: from phase 4's state after its {WARM} warm-up batches "
        f"({warm_from.boundary_count} keys, rehydrated onto the card in {t_warm:.3f} s), "
        f"batches {first}-{WARM + TIMED - 1} x {PER_BATCH} txns through ConflictSet(h_cap "
        f"{H_CAP}, depth {depth}) under random faults (fire probability {CHAOS_FIRE}, "
        f"buggify seed {CHAOS_BUGGIFY_SEED}, injector seed {CHAOS_INJECTOR_SEED}) and a "
        f"dispatch outage over batches {CHAOS_OUTAGE.start}-{CHAOS_OUTAGE.stop - 1}, in "
        f"{dt:.3f} s: {n_run * PER_BATCH / dt:.1f} txn/s over the run (not a claim); every "
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
        + ", ".join(f"{first + i} {k} {s * 1e3:.0f}" for i, k, s, _l, _r in turns))
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
    phase_done("4q")
    # 4k. the commit path through the port's SimCluster over the same state
    launches_cluster, batches_cluster, empty_cluster, cluster_run = cluster_path(
        torch, api, ecpu, tk, spans, trace, fr, batches, main)
    phase_done("4k")
    # 4n. the client (Database, Transaction, a Cycle ring) on 4k's cluster
    client = client_path(torch, tk, spans, trace, fr, cluster_run, main)
    rates = {"cluster": cluster_run["commits_per_s"]}
    del cluster_run
    gc.collect()
    phase_done("4n")
    # 4f. the durable commit path: the restarting test, crashed and recovered
    launches_durable, batches_durable = durable_path(torch, api, ecpu, tk, spans, trace, fr,
                                                     main, client["rates"])
    phase_done("4f")
    # 4m. the acceptance workloads (RandomReadWrite, WriteDuringRead, FuzzApi)
    # through the client on a full-width card set of their own
    workloads = acceptance_path(torch, api, ecpu, tk, spans, trace, fr, main, rates)
    phase_done("4m")
    # 4b. admission control and data distribution under a dispatch outage
    launches_admission, batches_admission, degraded_admission = admission_path(
        torch, api, ecpu, tk, faults, spans, trace, fr, main, client["rates"])
    phase_done("4b")
    others, stats = {}, {"main": main["stats"]}
    for mode in ("witness_free", "coalesced", "amortized", "tiered"):
        # Each starts from phase 4's state after its warm-up, rehydrated
        # onto the card, instead of replaying the WARM batches (a depth
        # cut: the replay was 60-70 s of each mode's 77-88 s).  The timed
        # batches are phase 4's 52-59 as before, and compactions (4t) and
        # evictions (4e) fall on the same ones, WARM being a multiple of
        # EVICT_EVERY.
        run = main_path(torch, api, batches, tk, rq, et, profile, mode=mode, want=main,
                        warm_from=main["warm_snapshot"], ecpu=ecpu)
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
    clusters_vs_cpu(torch, api, ecpu, spans, trace, fr)
    phase_done("6k")
    clients_vs_cpu(torch, api, tk, spans, trace, fr)
    phase_done("6n")
    durables_vs_cpu(torch, api, ecpu, tk, spans, trace, fr)
    phase_done("6f")
    acceptance_vs_cpu(torch, api, tk, spans, trace, fr)
    phase_done("6m")
    admission_vs_cpu(torch, api, sr, tk, faults, spans, trace, fr)
    phase_done("6b")
    # 6d. two runs of one stream on the card give equal records
    determinism_path(torch, api, tk, spans, trace, fr, batches)
    phase_done("6d")
    # 6c. chaos on the card: random faults at full width from phase 4's
    # state after its warm-up (a depth cut: replaying the WARM batches took
    # 60-70 s of the run's ~81), then replayed on cuda and cpu at the
    # reduced shape
    launches_chaos = chaos_path(torch, api, ecpu, batches, tk, faults, buggify, DR, digests, obs,
                                main["warm_snapshot"])
    del batches, main["warm_snapshot"]
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
             launches_cluster=launches_cluster[r["name"]],
             batches_cluster=batches_cluster, empty_batches_cluster=empty_cluster,
             launches_client=client["launches"][r["name"]],
             batches_client=client["batches"],
             launches_workloads=workloads["launches"][r["name"]],
             batches_workloads=workloads["batches"],
             launches_durable=launches_durable[r["name"]],
             batches_durable=batches_durable,
             launches_admission=launches_admission[r["name"]],
             batches_admission=batches_admission,
             degraded_batches_admission=degraded_admission,
             tiered=[{k: t[k] for k in shape_keys} for t in r["tiered"]],
             sharded=[{k: t[k] for k in shape_keys} for t in r["sharded"]])
        for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
