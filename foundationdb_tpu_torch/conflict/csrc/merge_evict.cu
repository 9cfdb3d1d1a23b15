// Fused merge + removeBefore eviction + compaction (phases 5-6 of the
// Resolver's conflict step), for Hopper (sm_90a).
//
// Replaces: foundationdb_tpu/conflict/kernels.py::fused_merge_evict and its
// Pallas body _merge_kernel_body (pallas_call at kernels.py:394).  Same
// function: two position-annotated streams — A (the history rows, with a
// keep mask) and B (the batch's sorted new boundaries) — each kept row
// carrying its merged position.  Row p of the merged order is dropped iff
// p > 0 and vers[p] and vers[p-1] are both < window (the reference's
// removeBefore rule; window = FLOOR keeps every row), and the survivors
// are compacted.  Positions at and past width are dropped, so the live
// rows are [0, min(merged_count, width)).  Rows at and past the returned
// count are undefined: the caller masks them.
//
// The order it relies on (the TPU kernel relies on it too): in each
// stream the kept rows' positions strictly increase with the row index,
// and the two streams' kept positions together partition
// [0, merged_count).  So the rows of merged tile t, positions [tT, tT+T),
// are a contiguous run of each stream's kept rows: if b0 kept B rows lie
// below tT, the tile's first A row is A's kept row number tT - b0, and
// A's rows fill the tile's slots that B's rows leave free, in order.  A's
// positions are never read.  Nothing else is assumed of B: its kept rows
// need not be a prefix (the tiered history's major compaction drops delta
// rows whose end marker meets an equal base key).  Inputs that break the
// order leave a slot that no row fills, or put a B row outside its tile:
// the kernel then reads and writes nothing out of bounds, writes zeros
// for the unfilled slot, and adds one to a fault count per such slot,
// which the caller can read.
//
// What bounds it on this card: bytes.  Under that order the function
// needs every row's keep flag, the versions of the kept rows (the rule
// reads each merged row's and its predecessor's), B's kept positions (A's
// follow from them), the survivors' key words (an evicted row's are never
// needed), the two scalars, and the survivors' key words and versions out.
// At the bench shape (kw1 = 3, 3,145,728 A rows and 131,072 B rows;
// 2,961,251 merged rows, 120,000 of them from B; 2,842,752 survive) that
// is 105,029,272 B: 31.4 us at 3.35 TB/s.  The work per row is a handful
// of integer operations.
//
// Design: each merged tile gathers its own rows; nothing is scattered and
// re-read, and there is no merged scratch buffer.  Two kernels on one
// stream, after one memset that clears the counters and status words:
//  1. Index pass (merge_index_kernel).  B's blocks copy B's kept rows
//     densely (keys, version, position), in order.  A's blocks read A's
//     keep flags, coalesced, count them with __ballot_sync/__popc and
//     write the kept rows before every chunk of kChunk rows.
//  2. Merge pass (merge_tiles_kernel), one block per tile of kTile merged
//     rows.  Two warps find b0 and b1, the kept B rows below the tile's two
//     ends, by 32-ary ballot search over the dense B positions; a warp
//     finds the chunk that holds A's kept row tT - b0 - 1 the same way.
//     The block places its B rows at slot pos - tT and A's rows in the
//     free slots, in order (as the TPU kernel places rows with its one-hot
//     matmul), reading A's keep flags from the chunk's start and the
//     versions of the rows it takes.  It applies the removeBefore rule,
//     ranks the survivors with a block scan and publishes their count;
//     their key words load (an evicted row's are never read) while it
//     looks back for its output offset; then it writes them, coalesced.
// Counts become offsets by a single-pass decoupled look-back (Merrill and
// Garland, 2016): a block publishes its count, then sums its
// predecessors' published values back to the nearest inclusive prefix,
// and publishes its own.  Blocks take their numbers from an atomic
// counter, not from blockIdx, so a block waits only on blocks that took a
// lower number and so have started: no deadlock, whatever the scheduler
// does.
//
// The rule at a tile's first slot needs the version of merged row tT - 1,
// which the TPU kernel carries across its in-order grid.  Here the tile
// reads that row itself: B's kept row b0 - 1 if its position is tT - 1,
// else A's kept row tT - b0 - 1, where the tile's A scan starts.  Carrying
// it in the look-back record instead would make each tile's count wait on
// its predecessor's, and chain every tile of the grid.
//
// Traffic at the bench shape: A's keep flags in the index pass (12.6 MB)
// and again in each tile, in windows of kScan from its chunk's start; the
// kept rows' versions and the survivors' key words once; the dense B copy
// written and read once; every survivor written once: ~120 MB, against
// the 224 MB of the scatter / count / scan / write design it replaces and
// the 105 MB the function needs.  What holds it back
// is latency, not bytes: a tile's dependent chain (three searches, the
// flag windows, the versions) has a long tail under load, and a tile's
// look-back waits on the slowest of the predecessors in flight with it
// (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // every block: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;               // merged rows per merge-pass block
constexpr int kTileSlabs = kTile / kThreads;
constexpr int kTilesPerSm = 5;            // merge blocks an SM holds (caps registers)
constexpr int kChunk = 256;               // A rows per chunk-prefix entry
constexpr int kChunkSlabs = kChunk / kThreads;
constexpr int kScan = 2048;               // keep flags a merge tile reads at a time
constexpr int kScanSlabs = kScan / kThreads;
constexpr int kSeg = 8192;                // A rows per index-pass block
constexpr int kSegSlabs = kSeg / kThreads;
constexpr int kBSeg = 1024;               // B rows per index-pass block
constexpr int kBSegSlabs = kBSeg / kThreads;
constexpr int kMaxWords = 17;             // key_words 16 (widths 1-9 and 17 built)
constexpr int kLookDepth = 4;             // status words a lane reads per look-back round
constexpr unsigned kPauseMin = 64;        // polling pause, ns, doubling
constexpr unsigned kPauseMax = 1024;
constexpr int32_t kFree = INT32_MAX;      // a slot no row holds
constexpr unsigned kFull = 0xffffffffu;

// Look-back status words: flag in the high half, value in the low half.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

struct Scratch {
  unsigned* counters;               // [0] index-pass blocks, [1] merge tiles
  int32_t* nb_kept;                 // kept B rows, written by the last B block
  unsigned long long* status_a;     // index pass, A blocks
  unsigned long long* status_b;     // index pass, B blocks
  unsigned long long* status_m;     // merge pass, tiles
  int32_t* chunk_prefix;            // kept A rows before each chunk
  int64_t chunks;
  int32_t* d_keys;                  // dense kept B rows: keys [kw1][nb]
  int32_t* d_vers;
  int32_t* d_pos;
  int64_t nb;
};

__host__ __device__ inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

// Byte offsets of the scratch buffer's parts.  The memset clears [0, reset).
struct Layout {
  int64_t blocks_a, blocks_b, tiles, chunks;
  size_t status, chunk_prefix, d_keys, d_vers, d_pos, reset, total;
};

Layout layout(int64_t na, int64_t nb, int kw1, int64_t width) {
  Layout l;
  l.blocks_a = ceil_div(na, kSeg);
  l.blocks_b = ceil_div(nb, kBSeg);
  l.tiles = ceil_div(width, kTile);
  l.chunks = ceil_div(na, kChunk);
  l.status = 64;  // counters and nb_kept first
  l.reset = l.status + 8 * static_cast<size_t>(l.blocks_a + l.blocks_b + l.tiles);
  l.chunk_prefix = align256(l.reset);
  l.d_keys = align256(l.chunk_prefix + 4 * static_cast<size_t>(l.chunks));
  l.d_vers = align256(l.d_keys + 4 * static_cast<size_t>(kw1) * nb);
  l.d_pos = align256(l.d_vers + 4 * static_cast<size_t>(nb));
  l.total = align256(l.d_pos + 4 * static_cast<size_t>(nb));
  return l;
}

// Status words: flag and value share one 64-bit word, so a reader never
// sees one without the other, and nothing else is handed over through
// them.  Relaxed device-scope accesses suffice; acquire and release would
// only make each wait on the thread's other memory traffic.
__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Decoupled look-back, in two halves.  publish: lane 0 stores block t's
// aggregate (block 0's is already its inclusive prefix).  look_back, by
// one whole warp once t's aggregate is out: sums the chain's published
// values before t back to the nearest inclusive prefix, kLookDepth * 32
// status words a round, publishes t's inclusive prefix and returns the
// sum (in every lane).
__device__ __forceinline__ void publish(unsigned long long* status, int64_t t, int32_t agg) {
  store_status(status + t, (t == 0 ? kInclusive : kAggregate) | static_cast<uint32_t>(agg));
}

__device__ int32_t look_back(unsigned long long* status, int64_t t, int32_t agg) {
  if (t == 0) return 0;
  const int lane = threadIdx.x & 31;
  constexpr int kReach = 32 * kLookDepth;
  int32_t before = 0;
  for (int64_t j0 = t - 1;; j0 -= kReach) {
    // Lane l reads the words at distances l * kLookDepth + q from j0;
    // words before block 0 read as an inclusive prefix of 0.
    unsigned long long w[kLookDepth];
#pragma unroll
    for (int q = 0; q < kLookDepth; ++q) {
      const int64_t j = j0 - lane * kLookDepth - q;
      w[q] = j >= 0 ? load_status(status + j) : kInclusive;
    }
    // Wait until every word nearer than the nearest inclusive prefix (all
    // of them, if there is none) is published; only those are summed.
    // Every block in reach has started, so the wait ends.
    int nearest;
    for (unsigned pause = kPauseMin;; pause = pause < kPauseMax ? 2 * pause : pause) {
      nearest = kReach;
      int unpublished = kReach;
#pragma unroll
      for (int q = kLookDepth - 1; q >= 0; --q) {
        const unsigned long long flag = w[q] >> 32;
        if (flag == 2) nearest = lane * kLookDepth + q;
        if (flag == 0) unpublished = lane * kLookDepth + q;
      }
      nearest = __reduce_min_sync(kFull, nearest);
      unpublished = __reduce_min_sync(kFull, unpublished);
      if (unpublished == kReach || unpublished > nearest) break;
      __nanosleep(pause);  // polling without it slows the index pass by a quarter
#pragma unroll
      for (int q = 0; q < kLookDepth; ++q) {
        if ((w[q] >> 32) == 0) w[q] = load_status(status + j0 - lane * kLookDepth - q);
      }
    }
    int32_t v = 0;
#pragma unroll
    for (int q = 0; q < kLookDepth; ++q) {
      if (lane * kLookDepth + q <= nearest) v += static_cast<int32_t>(static_cast<uint32_t>(w[q]));
    }
    before += __reduce_add_sync(kFull, v);
    if (nearest < kReach) break;
  }
  if (lane == 0) store_status(status + t, kInclusive | static_cast<uint32_t>(before + agg));
  return before;
}

// Block-wide exclusive ranks of flags laid out in slabs: flag i of thread
// x is element i * kThreads + x.  Returns the block's count.  s_cnt holds
// I * kWarps + 1 ints; on return s_cnt[i * kWarps + w] is the number of
// set flags before warp w's part of slab i (so s_cnt[i * kWarps] is the
// count before slab i), until the next call.
template <int I>
__device__ __forceinline__ int32_t block_rank(const bool (&f)[I], int32_t (&rank)[I],
                                              int32_t* s_cnt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const unsigned b = __ballot_sync(kFull, f[i]);
    rank[i] = __popc(b & lower);
    if (lane == 0) s_cnt[i * kWarps + warp] = __popc(b);
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int kN = I * kWarps;
    constexpr int kPer = (kN + 31) / 32;  // entries per lane, in order
    int32_t v[kPer];
    int32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = lane * kPer + k;
      v[k] = e < kN ? s_cnt[e] : 0;
      sum += v[k];
    }
    int32_t x = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    int32_t run = x - sum;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = lane * kPer + k;
      if (e < kN) s_cnt[e] = run;
      run += v[k];
    }
    if (lane == 31) s_cnt[kN] = x;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < I; ++i) rank[i] += s_cnt[i * kWarps + warp];
  const int32_t total = s_cnt[I * kWarps];
  __syncthreads();
  return total;
}

// First index in [0, n) whose value is >= x, or n, over an ascending
// array; one whole warp.  Each round the lanes probe 32 evenly spaced entries and a ballot
// keeps the gap the answer lies in: 120K entries take four rounds and a
// last probe.
__device__ int64_t warp_lower_bound(const int32_t* a, int64_t n, int64_t x) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t i = lo + (lane + 1) * step - 1;
    const bool less = i < hi && __ldcg(a + i) < x;
    const int c = __popc(__ballot_sync(kFull, less));
    const int64_t next = lo + (c + 1) * step - 1;  // the first probe >= x
    if (next < hi) hi = next;
    lo += c * step;
  }
  const int64_t i = lo + lane;
  const bool less = i < hi && __ldcg(a + i) < x;
  return lo + __popc(__ballot_sync(kFull, less));
}

__device__ __forceinline__ int64_t live_rows(const int32_t* merged_count, int64_t width) {
  const int64_t mc = *merged_count;
  return mc < width ? (mc > 0 ? mc : 0) : width;
}

struct Index {
  const int32_t* a_keep;
  int64_t na;
  const int32_t *b_keys, *b_vers, *b_keep, *b_pos;
  int64_t nb;
  Scratch sc;
};

// B block j: the dense copy of its kept rows, loaded together, then stored.
template <int KW>
__device__ void index_b(const Index& x, int64_t j, int64_t blocks_b, int32_t* s_cnt,
                        int32_t& s_before) {
  const Scratch& sc = x.sc;
  const int64_t seg = j * kBSeg;
  bool f[kBSegSlabs];
  int32_t rank[kBSegSlabs], pos[kBSegSlabs], ver[kBSegSlabs], key[kBSegSlabs][KW];
#pragma unroll
  for (int i = 0; i < kBSegSlabs; ++i) {
    const int64_t r = seg + i * kThreads + threadIdx.x;
    f[i] = r < x.nb && x.b_keep[r] != 0;
    if (f[i]) {
      pos[i] = x.b_pos[r];
      ver[i] = x.b_vers[r];
#pragma unroll
      for (int w = 0; w < KW; ++w) key[i][w] = x.b_keys[w * x.nb + r];
    }
  }
  const int32_t count = block_rank(f, rank, s_cnt);
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) publish(sc.status_b, j, count);
    const int32_t before = look_back(sc.status_b, j, count);
    if (threadIdx.x == 0) s_before = before;
  }
  __syncthreads();
  const int32_t before = s_before;
#pragma unroll
  for (int i = 0; i < kBSegSlabs; ++i) {
    if (!f[i]) continue;
    const int64_t d = before + rank[i];
#pragma unroll
    for (int w = 0; w < KW; ++w) sc.d_keys[w * x.nb + d] = key[i][w];
    sc.d_vers[d] = ver[i];
    sc.d_pos[d] = pos[i];
  }
  if (j == blocks_b - 1 && threadIdx.x == 0) *sc.nb_kept = before + count;
}

// A block j: the kept rows before each of its chunks.
__device__ void index_a(const Index& x, int64_t j, int32_t* s_cnt, int32_t& s_before) {
  const Scratch& sc = x.sc;
  const int64_t seg = j * kSeg;
  bool f[kSegSlabs];
  int32_t rank[kSegSlabs];
#pragma unroll
  for (int i = 0; i < kSegSlabs; ++i) {
    const int64_t r = seg + i * kThreads + threadIdx.x;
    f[i] = r < x.na && x.a_keep[r] != 0;
  }
  const int32_t count = block_rank(f, rank, s_cnt);
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) publish(sc.status_a, j, count);
    const int32_t before = look_back(sc.status_a, j, count);
    if (threadIdx.x == 0) s_before = before;
  }
  __syncthreads();
  constexpr int kChunksPerSeg = kSeg / kChunk;
  const int64_t c = seg / kChunk + threadIdx.x;
  if (threadIdx.x < kChunksPerSeg && c < sc.chunks) {
    sc.chunk_prefix[c] = s_before + s_cnt[threadIdx.x * kChunkSlabs * kWarps];
  }
}

// Index pass.  B's few blocks take the first numbers (their chain is the
// longer one: count, look back, copy), then A's.
template <int KW>
__global__ void __launch_bounds__(kThreads) merge_index_kernel(Index x) {
  __shared__ int32_t s_cnt[kSegSlabs * kWarps + 1];
  __shared__ unsigned s_id;
  __shared__ int32_t s_before;
  if (threadIdx.x == 0) s_id = atomicAdd(x.sc.counters, 1u);
  __syncthreads();
  const int64_t blocks_b = ceil_div(x.nb, kBSeg);
  const int64_t id = s_id;
  if (id < blocks_b) {
    index_b<KW>(x, id, blocks_b, s_cnt, s_before);
  } else {
    index_a(x, id - blocks_b, s_cnt, s_before);
  }
}

struct Tiles {
  const int32_t *a_keys, *a_vers, *a_keep;
  int64_t na;
  const int32_t *merged_count, *window;
  int64_t width;
  Scratch sc;
  int32_t *out_keys, *out_vers, *out_count;
  int32_t* faults;  // slots the order contract left unfilled, B rows off their tile
};

// Merge pass: one block per tile of kTile merged rows, numbered in the
// order the blocks start.
template <int KW>
__global__ void __launch_bounds__(kThreads, kTilesPerSm) merge_tiles_kernel(Tiles a) {
  extern __shared__ int32_t smem[];
  int32_t* s_vers = smem;           // [kTile] by slot
  int32_t* s_src = smem + kTile;    // [kTile] by slot: A row, or -1 - dense B row
  int32_t* s_list = s_src + kTile;  // the free slots in order, later the survivors'
  __shared__ int32_t s_cnt[(kScanSlabs > kTileSlabs ? kScanSlabs : kTileSlabs) * kWarps + 1];
  __shared__ unsigned s_tile;
  __shared__ int64_t s_b[2], s_chunk;
  __shared__ int32_t s_chunk_prefix, s_pred_a, s_pred_b, s_out;
  __shared__ bool s_pred_is_b;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const Scratch& sc = a.sc;
  if (tid == 0) s_tile = atomicAdd(sc.counters + 1, 1u);
#pragma unroll
  for (int i = 0; i < kTileSlabs; ++i) {
    s_src[i * kThreads + tid] = kFree;
    s_vers[i * kThreads + tid] = 0;
  }
  const int64_t live = live_rows(a.merged_count, a.width);
  const int32_t win = *a.window;
  __syncthreads();
  const int64_t t = s_tile;
  const int64_t base = t * kTile;
  if (base >= live) {
    if (t == 0 && tid == 0) *a.out_count = 0;  // nothing is live
    return;  // no tile before the last live one waits on this one
  }
  const int64_t end = base + kTile < live ? base + kTile : live;
  const int n_slots = static_cast<int>(end - base);
  const int64_t nbk = *sc.nb_kept;

  // 1. The kept B rows below each end of the tile.
  if (warp < 2) {
    const int64_t b = warp_lower_bound(sc.d_pos, nbk, warp == 0 ? base : end);
    if ((tid & 31) == 0) s_b[warp] = b;
  }
  __syncthreads();
  const int64_t b0 = s_b[0], b1 = s_b[1];
  const int64_t a0 = base - b0;  // A's kept rows below the tile
  const int64_t a_rows = n_slots - (b1 - b0);
  // A's scan starts at the kept row before the tile's first when there is
  // one (its version may be the slot-0 predecessor).
  const int64_t target = a0 > 0 ? a0 - 1 : 0;
  const int64_t need = sc.chunks > 0 ? a_rows + (a0 > 0 ? 1 : 0) : 0;

  // 2. The chunk holding A's kept row `target`, the slot-0 predecessor
  //    from B, B's rows at their slots; then the free slots, in order, for
  //    A's rows.
  if (warp == 0) {
    if (need > 0) {
      const int64_t c = warp_lower_bound(sc.chunk_prefix, sc.chunks, target + 1) - 1;
      if (tid == 0) {
        s_chunk = c;
        s_chunk_prefix = sc.chunk_prefix[c];
      }
    }
  } else if (tid == 32) {
    s_pred_is_b = false;
    if (b0 > 0 && sc.d_pos[b0 - 1] == base - 1) {
      s_pred_is_b = true;
      s_pred_b = sc.d_vers[b0 - 1];
    }
  } else if (warp >= 2) {
    for (int64_t k = tid - 64; k < b1 - b0; k += kThreads - 64) {
      const int64_t d = b0 + k;
      const int64_t slot = sc.d_pos[d] - base;
      if (slot < 0 || slot >= n_slots) {  // B's positions are not increasing
        atomicAdd(a.faults, 1);
        continue;
      }
      s_src[slot] = static_cast<int32_t>(-1 - d);
      s_vers[slot] = sc.d_vers[d];
    }
  }
  __syncthreads();
  {
    bool f[kTileSlabs];
    int32_t rank[kTileSlabs];
#pragma unroll
    for (int i = 0; i < kTileSlabs; ++i) {
      const int s = i * kThreads + tid;
      f[i] = s < n_slots && s_src[s] == kFree;
    }
    block_rank(f, rank, s_cnt);
#pragma unroll
    for (int i = 0; i < kTileSlabs; ++i) {
      if (f[i]) s_list[rank[i]] = i * kThreads + tid;
    }
  }

  // 3. A's kept rows [target, target + need): their versions, scanning the
  //    keep flags from the chunk's start kScan flags at a time; the next
  //    window's flags load while this one's versions do.
  if (need > 0) {
    const int64_t first = target - s_chunk_prefix;  // its rank from the scan start
    const int64_t last = first + need;
    const int64_t skip = first + (a0 > 0 ? 1 : 0);  // rank of the tile's first A row
    int64_t row = s_chunk * kChunk;
    int64_t seen = 0;  // kept rows before `row`
    bool f[kScanSlabs];
    int32_t rank[kScanSlabs];
#pragma unroll
    for (int i = 0; i < kScanSlabs; ++i) {
      const int64_t r = row + i * kThreads + tid;
      f[i] = r < a.na && a.a_keep[r] != 0;
    }
    for (;;) {
      const int32_t count = block_rank(f, rank, s_cnt);
      const bool more = seen + count < last && row + kScan < a.na;
      bool take[kScanSlabs];
      int32_t ver[kScanSlabs];
#pragma unroll
      for (int i = 0; i < kScanSlabs; ++i) {
        const int64_t k = seen + rank[i];
        take[i] = f[i] && k >= first && k < last;
        if (take[i]) ver[i] = a.a_vers[row + i * kThreads + tid];
      }
      if (more) {
#pragma unroll
        for (int i = 0; i < kScanSlabs; ++i) {
          const int64_t r = row + kScan + i * kThreads + tid;
          f[i] = r < a.na && a.a_keep[r] != 0;
        }
      }
#pragma unroll
      for (int i = 0; i < kScanSlabs; ++i) {
        if (!take[i]) continue;
        const int64_t k = seen + rank[i] - skip;
        if (k < 0) {
          s_pred_a = ver[i];
          continue;
        }
        const int slot = s_list[k];
        s_vers[slot] = ver[i];
        s_src[slot] = static_cast<int32_t>(row + i * kThreads + tid);
      }
      seen += count;
      row += kScan;
      if (!more) break;
    }
  }
  __syncthreads();

  // 4. removeBefore over the tile's slots, and the survivors' slots in order.
  const int32_t pred = s_pred_is_b ? s_pred_b : s_pred_a;
  int32_t survivors;
  {
    bool keep[kTileSlabs];
    int32_t rank[kTileSlabs];
#pragma unroll
    for (int i = 0; i < kTileSlabs; ++i) {
      const int s = i * kThreads + tid;
      keep[i] = false;
      if (s < n_slots) {
        const int32_t v = s_vers[s];
        const int32_t pv = s > 0 ? s_vers[s - 1] : pred;
        keep[i] = base + s == 0 || !(v < win && pv < win);
        if (s_src[s] == kFree) atomicAdd(a.faults, 1);  // no row filled it
      }
    }
    survivors = block_rank(keep, rank, s_cnt);
    if (tid == 0) publish(sc.status_m, t, survivors);
#pragma unroll
    for (int i = 0; i < kTileSlabs; ++i) {
      if (keep[i]) s_list[rank[i]] = i * kThreads + tid;
    }
  }
  __syncthreads();

  // 5. The survivors' key words load while warp 0 looks back for the
  //    tile's output offset; then the writes, coalesced.
  int32_t ver[kTileSlabs], key[kTileSlabs][KW];
#pragma unroll
  for (int i = 0; i < kTileSlabs; ++i) {
    const int k = i * kThreads + tid;
    if (k < survivors) {
      const int s = s_list[k];
      const int32_t src = s_src[s];
      ver[i] = s_vers[s];
      if (src == kFree) {
#pragma unroll
        for (int w = 0; w < KW; ++w) key[i][w] = 0;
      } else if (src >= 0) {
#pragma unroll
        for (int w = 0; w < KW; ++w) key[i][w] = a.a_keys[w * a.na + src];
      } else {
#pragma unroll
        for (int w = 0; w < KW; ++w) key[i][w] = sc.d_keys[w * sc.nb + (-1 - src)];
      }
    }
  }
  if (tid < 32) {
    const int32_t before = look_back(sc.status_m, t, survivors);
    if (tid == 0) {
      s_out = before;
      if (end == live) *a.out_count = before + survivors;  // the last live tile
    }
  }
  __syncthreads();
  const int64_t out0 = s_out;
#pragma unroll
  for (int i = 0; i < kTileSlabs; ++i) {
    const int k = i * kThreads + tid;
    if (k < survivors) {
      const int64_t o = out0 + k;
      a.out_vers[o] = ver[i];
#pragma unroll
      for (int w = 0; w < KW; ++w) a.out_keys[w * a.width + o] = key[i][w];
    }
  }
}

template <int KW>
cudaError_t launch(const Index& x, const Tiles& a, int64_t tiles, cudaStream_t s) {
  const int64_t blocks = ceil_div(x.na, kSeg) + ceil_div(x.nb, kBSeg);
  if (blocks > 0) {
    merge_index_kernel<KW><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(x);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  constexpr int kSmem = 3 * kTile * 4;  // 24 KB: under the 48 KB default
  merge_tiles_kernel<KW><<<static_cast<unsigned>(tiles), kThreads, kSmem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long merge_scratch_bytes(long long na, long long nb, int kw1,
                                         long long width) {
  return static_cast<long long>(layout(na, nb, kw1, width).total);
}

// A's positions are not an argument: A's rows fill the slots B leaves free.
extern "C" int fused_merge_evict_launch(
    const void* a_keys, const void* a_vers, const void* a_keep, long long na,
    const void* b_keys, const void* b_vers,
    const void* b_keep, const void* b_pos, long long nb,
    const void* merged_count, const void* window, int kw1, long long width,
    void* scratch, void* out_keys, void* out_vers, void* out_count,
    void* faults, void* stream) {
  // Rows are indexed in int32 in shared memory, as positions are.
  if (kw1 < 1 || kw1 > kMaxWords || width < 1 || na < 0 || nb < 0 ||
      na > INT32_MAX || nb > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(na, nb, kw1, width);
  char* base = static_cast<char*>(scratch);
  Scratch sc;
  sc.counters = reinterpret_cast<unsigned*>(base);
  sc.nb_kept = reinterpret_cast<int32_t*>(base + 8);
  sc.status_a = reinterpret_cast<unsigned long long*>(base + l.status);
  sc.status_b = sc.status_a + l.blocks_a;
  sc.status_m = sc.status_b + l.blocks_b;
  sc.chunk_prefix = reinterpret_cast<int32_t*>(base + l.chunk_prefix);
  sc.chunks = l.chunks;
  sc.d_keys = reinterpret_cast<int32_t*>(base + l.d_keys);
  sc.d_vers = reinterpret_cast<int32_t*>(base + l.d_vers);
  sc.d_pos = reinterpret_cast<int32_t*>(base + l.d_pos);
  sc.nb = nb;
  const cudaError_t err = cudaMemsetAsync(scratch, 0, l.reset, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const Index x{i32(a_keep), na, i32(b_keys), i32(b_vers), i32(b_keep), i32(b_pos), nb, sc};
  const Tiles a{i32(a_keys), i32(a_vers), i32(a_keep), na, i32(merged_count), i32(window),
                width, sc, static_cast<int32_t*>(out_keys), static_cast<int32_t*>(out_vers),
                static_cast<int32_t*>(out_count), static_cast<int32_t*>(faults)};
  switch (kw1) {
    case 1: return static_cast<int>(launch<1>(x, a, l.tiles, s));
    case 2: return static_cast<int>(launch<2>(x, a, l.tiles, s));
    case 3: return static_cast<int>(launch<3>(x, a, l.tiles, s));
    case 4: return static_cast<int>(launch<4>(x, a, l.tiles, s));
    case 5: return static_cast<int>(launch<5>(x, a, l.tiles, s));
    case 6: return static_cast<int>(launch<6>(x, a, l.tiles, s));
    case 7: return static_cast<int>(launch<7>(x, a, l.tiles, s));
    case 8: return static_cast<int>(launch<8>(x, a, l.tiles, s));
    // The soak's widths: the sharded soak's key_words 8 and a
    // DynamicCluster's 16 (its system keys).  Others are not built.
    case 9: return static_cast<int>(launch<9>(x, a, l.tiles, s));
    case 17: return static_cast<int>(launch<17>(x, a, l.tiles, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
