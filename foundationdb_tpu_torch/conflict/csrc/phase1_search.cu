// Phase-1 history search of the Resolver's conflict step, for Hopper (sm_90a).
//
// Replaces: foundationdb_tpu/conflict/kernels.py::phase1_ranks and its
// Pallas body _search_kernel_body.  Same function: the insertion rank of
// every query key into the sorted, word-major, INF-padded history keys —
// side 0 counts rows < q, side 1 counts rows <= q — over the full buffer
// width N, padding included (equal to searchsorted_words).
//
// What bounds it on this card: bytes.  The search needs word 0 of every
// history row and query, the higher words only where word 0 ties, the sides
// and the ranks.  At the bench shape (3 words x 3,145,728 rows, 131,072
// queries) that is 14.46 MB, ~4.3 us at 3.35 TB/s.  A binary search per
// query instead runs ~22 dependent loads at scattered addresses, a chain of
// memory latencies and not a stream of bytes.
//
// Design: the sorted search of merge-path libraries.  The history rows and
// the sorted queries form one merged sequence in the order that defines the
// rank (a side-0 query before the rows equal to it, a side-1 query after
// them); a query's rank is the number of rows before it there.  One launch:
//  1. Partition.  Block b owns the merged items [b*kDiag, (b+1)*kDiag), so
//     every block gets kDiag items however skewed the keys are (hot keys put
//     thousands of queries in one place).  One warp finds where each end of
//     that diagonal crosses the two inputs, with full multiword compares,
//     32-ary: the lanes probe 32 evenly spaced points and a ballot keeps the
//     interval between the last probe before the diagonal and the first one
//     after it.  131K queries take four dependent steps.
//  2. Stream.  Once both ends are known to within kEarly queries (two steps),
//     the block copies one word of every row its span may cover into shared
//     memory with coalesced 16-byte cp.async loads, while the two warps take
//     the last steps; then the same word of its queries.  The word is the
//     first one on which those rows may differ: word 0, unless the two probe
//     rows that bracket them share a prefix (keys with a common prefix, a
//     hot range of few word-0 values), and then the word after it.  The
//     block's queries lie between those two rows, so they share it too.
//  3. That word.  Each thread searches its queries in shared memory, two at
//     a time in lockstep.  A row whose word differs from the query's is
//     decided there; the rows that tie it form a run.  A run of one row, the
//     common tie, is settled by its higher words and the query's, read
//     from device memory together, for that row alone.
//  4. Higher words.  Longer runs, and every run when the block holds more
//     queries than a lockstep batch per thread, go on word by word: the block
//     stages word w of the rows its open runs span and of the queries that
//     hold them, and narrows each run on it.  A run left open ties the query
//     on every word, and the query's side picks its end.
//  In 3 and 4 a thread reuses the result of its query one batch earlier when
//  the inputs match, so a block of hot keys searches each key once.
//
// Key words are int32 in the port's device encoding (the uint32 word with
// its sign bit flipped), so signed compares give the unsigned order.
// Word 0 is the most significant; the first differing word decides, which
// is the reference's lex_less/lex_leq (trailing word first, word 0 last).

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef PHASE1_STAMPS
// A diagnostic build (nvcc -DPHASE1_STAMPS; chip_smoke.py --stamps): thread
// 0 of each block writes %globaltimer after a barrier at the start of each
// numbered phase of the kernel and at its end, into the buffer given to
// phase1_stamps_set.  The barriers make this build a little slower than
// the plain one.
constexpr int kStamps = 6;  // phases 1-5 start, then the kernel's end
__device__ long long* g_stamps;
#define STAMP(k)                                                          \
  do {                                                                    \
    __syncthreads();                                                      \
    if (threadIdx.x == 0) {                                               \
      long long t_;                                                       \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));              \
      g_stamps[blockIdx.x * kStamps + (k) - 1] = t_;                      \
    }                                                                     \
  } while (0)
#else
#define STAMP(k) do {} while (0)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 2;      // searches a thread runs in lockstep
constexpr int kDiag = 6656;    // merged items (rows + queries) per block
constexpr int kEarly = 128;    // partition width at which the stream starts
constexpr int kPad = 8;        // slack of a staged range for 16-byte alignment
// Shared memory: the staged rows (the span plus up to 2 * kEarly), one
// word of the block's queries, and the queries' states; the span plus the
// queries is kDiag.  54 KB, four blocks to an SM.
constexpr size_t kSmemBytes = (2 * kDiag + 2 * kEarly + 4 * kPad) * sizeof(int32_t);
static_assert(kDiag < (1 << 16), "a run's ends are packed in 16 bits each");

__device__ __forceinline__ int cmp(int32_t a, int32_t b) {
  return (a < b) ? -1 : ((a > b) ? 1 : 0);
}

// Whether history row r comes before query j in the merged order: the sign
// of (h[:, r] - q[:, j]) — word 0 first, the higher words together only on
// a tie — and the query's side on a full tie.  The row's words it read are
// left in hw: all of them on a word-0 tie (tied), else word 0.
template <int KW1>
__device__ __forceinline__ bool row_first(const int32_t* __restrict__ h, int64_t n,
                                          int64_t r, const int32_t* __restrict__ q,
                                          int64_t m, int64_t j,
                                          const int32_t* __restrict__ q_side, int32_t* hw,
                                          bool& tied) {
  hw[0] = __ldg(h + r);
  int c = cmp(hw[0], __ldg(q + j));
  tied = c == 0;
  if (c == 0) {
    int32_t qw[KW1];
#pragma unroll
    for (int w = 1; w < KW1; ++w) {
      hw[w] = __ldg(h + w * n + r);
      qw[w] = __ldg(q + w * m + j);
    }
#pragma unroll
    for (int w = 1; w < KW1; ++w) {
      if (c == 0) c = cmp(hw[w], qw[w]);
    }
  }
  return c < 0 || (c == 0 && __ldg(q_side + j) != 0);
}

// Narrows [lo, hi], which holds the number of queries among the first d
// items of the merged order, until it is at most `width` wide (0: exact),
// by one warp (every lane gets the same interval).  Query p is among them
// iff history row d-1-p does not come before it; that holds for p below
// the answer and fails from it on, so each step's ballot is a prefix of
// the lanes.
// With kEdge, the lane whose probe last moved the end asked for writes
// that probe row's words to edge (shared memory) and their count (1, or
// KW1 on a word-0 tie) to *edge_words; 0 where no probe moved it.  For hi
// the row is d-1-hi, just before the rows the answer may leave; for lo it
// is d-lo, just after them.  kEdge needs width >= 32: the last step, one
// probe per candidate, moves both ends and is not tracked.
template <int KW1, bool kEdge>
__device__ __forceinline__ void merge_path_narrow(
    const int32_t* __restrict__ h, int64_t n, const int32_t* __restrict__ q, int64_t m,
    const int32_t* __restrict__ q_side, int64_t d, int lane, int64_t width, int64_t& lo,
    int64_t& hi, bool edge_at_hi, int32_t* edge, int* edge_words) {
  const unsigned all = 0xffffffffu;
  int32_t hw[KW1] = {}, keep[KW1] = {};
  int owner = -1, kept = 0;
  bool tied;
  while (hi - lo > width) {
    const int64_t len = hi - lo;
    if (len <= 32) {  // last step: one probe per candidate
      const bool in = lane < len && !row_first<KW1>(h, n, d - 1 - (lo + lane), q, m,
                                                    lo + lane, q_side, hw, tied);
      lo += __popc(__ballot_sync(all, in));
      hi = lo;
      break;
    }
    // Probe k at lo + (k+1)*len/33: 32 distinct points inside [lo, hi).
    const int64_t p = lo + ((lane + 1) * len) / 33;
    const bool in = !row_first<KW1>(h, n, d - 1 - p, q, m, p, q_side, hw, tied);
    const int c = __popc(__ballot_sync(all, in));
    const int64_t new_lo = c > 0 ? lo + (c * len) / 33 + 1 : lo;
    hi = c < 32 ? lo + ((c + 1) * len) / 33 : hi;
    lo = new_lo;
    if (kEdge) {  // lane c set hi, lane c - 1 set lo
      const int src = edge_at_hi ? c : c - 1;
      if (src >= 0 && src < 32) {
        owner = src;
        if (lane == src) {
          kept = tied ? KW1 : 1;
#pragma unroll
          for (int v = 0; v < KW1; ++v) keep[v] = hw[v];
        }
      }
    }
  }
  if (kEdge && lane == (owner < 0 ? 0 : owner)) {
    *edge_words = kept;
#pragma unroll
    for (int v = 0; v < KW1; ++v) edge[v] = keep[v];
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts copying one word of history rows [lo, hi) (lo >= i0) into shared
// memory and returns where row i0 sits there: span[off + k] holds row
// i0 + k, off = i0 - base, base being i0 rounded down to a 16-byte address
// of that word's row.  Whole quads inside the row go by cp.async, the ragged
// ends word by word; the caller waits.
__device__ __forceinline__ int stage_rows(const int32_t* __restrict__ row, int64_t n,
                                          int64_t i0, int64_t lo, int64_t hi,
                                          int32_t* span) {
  const int64_t base =
      i0 - static_cast<int64_t>((reinterpret_cast<uintptr_t>(row + i0) & 15) >> 2);
  const int64_t quads = (hi - base + 3) >> 2;
  for (int64_t t = ((lo - base) >> 2) + threadIdx.x; t < quads; t += kThreads) {
    const int64_t g = base + 4 * t;
    if (g >= 0 && g + 4 <= n) {
      cp_async16(span + 4 * t, row + g);
    } else {
      for (int k = 0; k < 4; ++k) {
        if (g + k >= lo && g + k < hi) span[4 * t + k] = __ldg(row + g + k);
      }
    }
  }
  return static_cast<int>(i0 - base);
}

// rows[lo, hi) is sorted: the first index whose value is >= x (lower) or
// > x (upper).
__device__ __forceinline__ int lower_bound(const int32_t* rows, int lo, int hi, int32_t x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rows[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const int32_t* rows, int lo, int hi, int32_t x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rows[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Lower bounds in rows[0, cnt) of the keys x[u] with want[u] set, at once:
// branch-free, the same steps for every key, so their shared-memory loads
// overlap.
__device__ __forceinline__ void lower_bounds(const int32_t* rows, int cnt, const int32_t* x,
                                             const bool* want, int* a) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) a[u] = 0;
  if (cnt == 0) return;
  for (int len = cnt; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (want[u] && rows[a[u] + half] < x[u]) a[u] += half;
    }
    len -= half;
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) a[u] += want[u] && rows[a[u]] < x[u];
}

// The end of the run of rows equal to x that starts at a (rows[a] == x),
// galloping from a, so a run of one row costs one more probe.
__device__ __forceinline__ int run_end(const int32_t* rows, int a, int hi, int32_t x) {
  int l = a + 1, r = a + 1, reach = 1;
  while (r < hi && rows[r] == x) {
    l = r + 1;
    reach <<= 1;
    r = a + reach < hi ? a + reach : hi;
  }
  return upper_bound(rows, l, r, x);
}

// A query's state inside its block: the run [a, b) of span rows equal to it
// on the words compared so far.  a == b once a word decides.
__device__ __forceinline__ uint32_t pack(int a, int b) {
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 16);
}
__device__ __forceinline__ int run_a(uint32_t s) { return s & 0xffff; }
__device__ __forceinline__ int run_b(uint32_t s) { return s >> 16; }

// Settles the batch's runs of one row: words w..KW1-1 of the row and of the
// query, read from device memory together, decide; a full tie goes by the
// query's side.  Afterwards a == b for each of them.
template <int KW1>
__device__ __forceinline__ void settle(const int32_t* __restrict__ h, int64_t n, int64_t i0,
                                       const int32_t* __restrict__ q, int64_t m, int64_t j0,
                                       int first, int nq, int w, const bool* right, int* a,
                                       int* b) {
  constexpr int kHigher = KW1 > 1 ? KW1 - 1 : 1;
  constexpr int kChunk = kHigher * kBatch <= 8 ? kBatch : 1;  // bounds the registers held
#pragma unroll
  for (int c0 = 0; c0 < kBatch; c0 += kChunk) {
    int32_t hw[kChunk][kHigher], qw[kChunk][kHigher];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int k = c0 + u;
      if (first + k * kThreads < nq && b[k] == a[k] + 1) {
#pragma unroll
        for (int v = 1; v < KW1; ++v) {
          if (v >= w) {
            hw[u][v - 1] = __ldg(h + v * n + i0 + a[k]);
            qw[u][v - 1] = __ldg(q + v * m + j0 + first + k * kThreads);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int k = c0 + u;
      if (first + k * kThreads < nq && b[k] == a[k] + 1) {
        int c = 0;
#pragma unroll
        for (int v = 1; v < KW1; ++v) {
          if (v >= w && c == 0) c = cmp(hw[u][v - 1], qw[u][v - 1]);
        }
        if (c < 0 || (c == 0 && right[k])) a[k] = b[k]; else b[k] = a[k];
      }
    }
  }
}

// The block's open runs: how many, the rows they span, and the queries
// that hold them.
struct Open {
  int count, lo, hi, qlo, qhi;
};

__device__ __forceinline__ void open_reset(Open& o) {
  o.count = 0;
  o.lo = o.qlo = kDiag;
  o.hi = o.qhi = 0;
}

// Adds one thread's open runs to the block's, one shared atomic per warp.
__device__ __forceinline__ void open_add(Open& block, const Open& mine) {
  const unsigned all = 0xffffffffu;
  const int count = __reduce_add_sync(all, mine.count);
  const int lo = __reduce_min_sync(all, mine.lo);
  const int hi = __reduce_max_sync(all, mine.hi);
  const int qlo = __reduce_min_sync(all, mine.qlo);
  const int qhi = __reduce_max_sync(all, mine.qhi);
  if ((threadIdx.x & 31) == 0 && count > 0) {
    atomicAdd(&block.count, count);
    atomicMin(&block.lo, lo);
    atomicMax(&block.hi, hi);
    atomicMin(&block.qlo, qlo);
    atomicMax(&block.qhi, qhi);
  }
}

__device__ __forceinline__ void open_note(Open& mine, int i, int a, int b) {
  if (b > a) {
    ++mine.count;
    mine.lo = min(mine.lo, a);
    mine.hi = max(mine.hi, b);
    mine.qlo = min(mine.qlo, i);
    mine.qhi = max(mine.qhi, i + 1);
  }
}

// Phases 3-5 of one block (the kernel below): the span's rows and the
// block's queries, which all share words 0..kw-1, with word kw of each
// staged in shared memory (span[rows + k] row i0 + k, qs[qx + i] query
// j0 + i).
template <int KW1>
__device__ __forceinline__ void search_span(
    const int32_t* __restrict__ h_keys, int64_t n, const int32_t* __restrict__ q_keys,
    const int32_t* __restrict__ q_side, int32_t* __restrict__ ranks, int64_t m, int64_t i0,
    int64_t j0, int nq, int cnt, int32_t* span, int rows, int32_t* qs, int qx,
    uint32_t* state, Open& open, const bool* right, bool settle_now, int kw) {
  STAMP(3);
  // 3. Word kw decides every query that no row of the span ties; a query
  // that ties keeps its run of tied rows.
  // Queries arrive sorted, so a thread's query often has the word of its
  // query one batch earlier (hot keys, common prefixes): it reuses that
  // run instead of searching again.
  Open mine;
  open_reset(mine);
  const int step = kBatch * kThreads;
  for (int first = threadIdx.x; first < nq; first += step) {
    int32_t x[kBatch];
    int a[kBatch], b[kBatch];
    bool want[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = first + u * kThreads;
      x[u] = i < nq ? qs[qx + i] : 0;
      const bool again = i < nq && i >= step && qs[qx + i - step] == x[u];
      const uint32_t s = again ? state[i - step] : 0;
      a[u] = run_a(s);
      b[u] = run_b(s);
      want[u] = i < nq && !again;
    }
    int lb[kBatch];
    lower_bounds(span + rows, cnt, x, want, lb);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (want[u]) {
        const bool tie = lb[u] < cnt && span[rows + lb[u]] == x[u];
        a[u] = lb[u];
        b[u] = tie ? run_end(span + rows, lb[u], cnt, x[u]) : lb[u];
      }
    }
    if (settle_now) settle<KW1>(h_keys, n, i0, q_keys, m, j0, first, nq, kw + 1, right, a, b);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = first + u * kThreads;
      if (i < nq) {
        state[i] = pack(a[u], b[u]);
        open_note(mine, i, a[u], b[u]);
      }
    }
  }
  open_add(open, mine);
  __syncthreads();

  STAMP(4);
  // 4. The higher words, for the tied runs alone: the block stages word w
  // of the rows its open runs span and of the queries that hold them, and
  // narrows every run on it.
#pragma unroll 1
  for (int w = kw + 1; w < KW1; ++w) {
    const Open now = open;
    __syncthreads();
    if (now.count == 0) break;
    rows = stage_rows(h_keys + w * n, n, i0, i0 + now.lo, i0 + now.hi, span);
    qx = stage_rows(q_keys + w * m, m, j0, j0 + now.qlo, j0 + now.qhi, qs);
    if (threadIdx.x == 0) open_reset(open);
    cp_async_wait_all();
    __syncthreads();
    open_reset(mine);
    // A run narrows the same way as the run one batch earlier if both held
    // the same rows (then the two queries agree on words 0..w-1) and the
    // queries agree on word w.
    uint32_t seen_run[kBatch], seen_to[kBatch];
    int32_t seen_x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) seen_run[u] = 0;
    for (int first = threadIdx.x + now.qlo / step * step; first < now.qhi; first += step) {
      int a[kBatch], b[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = first + u * kThreads;
        const uint32_t s = i < now.qhi ? state[i] : 0;
        a[u] = run_a(s);
        b[u] = run_b(s);
        if (b[u] > a[u]) {
          const int32_t x = qs[qx + i];
          if (s == seen_run[u] && x == seen_x[u]) {
            a[u] = run_a(seen_to[u]);
            b[u] = run_b(seen_to[u]);
          } else {
            const int lb = lower_bound(span + rows, a[u], b[u], x);
            const bool tie = lb < b[u] && span[rows + lb] == x;
            b[u] = tie ? run_end(span + rows, lb, b[u], x) : lb;
            a[u] = lb;
            seen_run[u] = s;
            seen_x[u] = x;
            seen_to[u] = pack(a[u], b[u]);
          }
        }
      }
      if (settle_now) settle<KW1>(h_keys, n, i0, q_keys, m, j0, first, nq, w + 1, right, a, b);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = first + u * kThreads;
        if (i < now.qhi) {
          state[i] = pack(a[u], b[u]);
          open_note(mine, i, a[u], b[u]);
        }
      }
    }
    open_add(open, mine);
    __syncthreads();
  }

  STAMP(5);
  // 5. A run still open ties the query on every word: its side picks the end.
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < nq) {
      const uint32_t s = state[i];
      ranks[j0 + i] = static_cast<int32_t>(i0 + (right[u] ? run_b(s) : run_a(s)));
    }
  }
#pragma unroll 4
  for (int i = threadIdx.x + kBatch * kThreads; i < nq; i += kThreads) {
    const uint32_t s = state[i];
    const bool r = __ldg(q_side + j0 + i) != 0;
    ranks[j0 + i] = static_cast<int32_t>(i0 + (r ? run_b(s) : run_a(s)));
  }
}

template <int KW1>
__global__ void __launch_bounds__(kThreads, 4)
phase1_ranks_kernel(const int32_t* __restrict__ h_keys, int64_t n,
                    const int32_t* __restrict__ q_keys,
                    const int32_t* __restrict__ q_side,
                    int32_t* __restrict__ ranks, int64_t m) {
  extern __shared__ int4 smem_raw[];
  int32_t* span = reinterpret_cast<int32_t*>(smem_raw);
  __shared__ int64_t bounds[2][2];  // each end's interval, kEarly wide
  __shared__ int64_t exact[2];      // each end's query count
  __shared__ int32_t edge_sm[2][KW1];  // the rows bracketing the span's rows
  __shared__ int edge_n[2];         // and how many of their words are known
  __shared__ Open open;

  STAMP(1);
  // 1. Where this block's diagonal starts and ends: warp 0 and warp 1, each
  // first to within kEarly queries, then exactly.
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kDiag;
  const int64_t d1 = d0 + kDiag < n + m ? d0 + kDiag : n + m;
  const int warp = threadIdx.x >> 5;
  const int64_t d = warp == 0 ? d0 : d1;
  int64_t lo = d > n ? d - n : 0;
  int64_t hi = d < m ? d : m;
  if (warp < 2) {
    merge_path_narrow<KW1, true>(h_keys, n, q_keys, m, q_side, d, threadIdx.x & 31, kEarly,
                                 lo, hi, warp == 0, edge_sm[warp], &edge_n[warp]);
    if ((threadIdx.x & 31) == 0) {
      bounds[warp][0] = lo;
      bounds[warp][1] = hi;
    }
  }
  __syncthreads();

  STAMP(2);
  // 2. Word kw of the rows the span may cover into shared memory, while
  // warps 0 and 1 finish the partition; then word kw of the block's queries.
  // kw is the first word on which those rows may differ: rows r0 - 1 and
  // r1, which the partition's probes read, bracket them, so all of them
  // share the words before the first one where the two differ (keys with
  // a common prefix).  So do the block's queries, which lie between row
  // i0 - 1 >= r0 - 1 and row i0 + cnt <= r1 in the merged order.  0 where
  // the probes did not read the higher words.
  const int64_t r0 = d0 - bounds[0][1];  // first row the span may start at
  const int64_t r1 = d1 - bounds[1][0];  // last row it may end at
  int kw = 0;
  if (edge_n[0] == KW1 && edge_n[1] == KW1) {
    while (kw < KW1 - 1 && edge_sm[0][kw] == edge_sm[1][kw]) ++kw;
  }
  const int staged = stage_rows(h_keys + kw * n, n, r0, r0, r1, span);
  if (warp < 2) {
    merge_path_narrow<KW1, false>(h_keys, n, q_keys, m, q_side, d, threadIdx.x & 31, 0, lo,
                                  hi, false, nullptr, nullptr);
    if ((threadIdx.x & 31) == 0) exact[warp] = lo;
  }
  __syncthreads();
  const int64_t j0 = exact[0], i0 = d0 - j0;
  const int nq = static_cast<int>(exact[1] - j0);      // queries [j0, j0 + nq)
  const int cnt = static_cast<int>(d1 - exact[1] - i0);  // rows [i0, i0 + cnt)
  // span[rows + k] holds row i0 + k, qs[qx + i] query j0 + i, state[i] its
  // run; the staged rows are at most the span plus 2 * kEarly.
  int rows = staged + static_cast<int>(i0 - r0);
  int32_t* qs = span + ((r1 - r0 + kPad + 3) & ~3);
  uint32_t* state = reinterpret_cast<uint32_t*>(qs + nq + kPad);
  int qx = stage_rows(q_keys + kw * m, m, j0, j0, j0 + nq, qs);
  // Where one batch per thread covers the block's queries, a run of one row
  // is settled on the spot; otherwise it waits for the block's next word.
  const bool settle_now = nq <= kBatch * kThreads;
  if (threadIdx.x == 0) open_reset(open);
  bool right[kBatch];  // sides of this thread's first batch of queries
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int i = threadIdx.x + u * kThreads;
    right[u] = i < nq && __ldg(q_side + j0 + i) != 0;
  }
  cp_async_wait_all();
  __syncthreads();

  // The rest, compiled apart for word 0 (the common case) and a later word.
  if (kw == 0) {
    search_span<KW1>(h_keys, n, q_keys, q_side, ranks, m, i0, j0, nq, cnt, span, rows, qs, qx,
                     state, open, right, settle_now, 0);
  } else {
    search_span<KW1>(h_keys, n, q_keys, q_side, ranks, m, i0, j0, nq, cnt, span, rows, qs, qx,
                     state, open, right, settle_now, kw);
  }
  STAMP(6);
}

template <int KW1>
cudaError_t launch(const void* h_keys, long long n, const void* q_keys, const void* q_side,
                   void* ranks, long long m, cudaStream_t stream) {
  // Once per instantiation; a failure is returned on every launch.
  static const cudaError_t attr = cudaFuncSetAttribute(
      phase1_ranks_kernel<KW1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return attr;
  const unsigned blocks = static_cast<unsigned>((n + m + kDiag - 1) / kDiag);
  phase1_ranks_kernel<KW1><<<blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const int32_t*>(h_keys), n, static_cast<const int32_t*>(q_keys),
      static_cast<const int32_t*>(q_side), static_cast<int32_t*>(ranks), m);
  return cudaGetLastError();
}

}  // namespace

extern "C" int phase1_ranks_launch(const void* h_keys, long long n,
                                   const void* q_keys, const void* q_side,
                                   void* ranks, long long m, int kw1,
                                   void* stream) {
  if (n < 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kw1) {
    case 1: return static_cast<int>(launch<1>(h_keys, n, q_keys, q_side, ranks, m, st));
    case 2: return static_cast<int>(launch<2>(h_keys, n, q_keys, q_side, ranks, m, st));
    case 3: return static_cast<int>(launch<3>(h_keys, n, q_keys, q_side, ranks, m, st));
    case 4: return static_cast<int>(launch<4>(h_keys, n, q_keys, q_side, ranks, m, st));
    case 5: return static_cast<int>(launch<5>(h_keys, n, q_keys, q_side, ranks, m, st));
    case 6: return static_cast<int>(launch<6>(h_keys, n, q_keys, q_side, ranks, m, st));
    case 7: return static_cast<int>(launch<7>(h_keys, n, q_keys, q_side, ranks, m, st));
    case 8: return static_cast<int>(launch<8>(h_keys, n, q_keys, q_side, ranks, m, st));
    // The soak's widths: the sharded soak's key_words 8 and a
    // DynamicCluster's 16 (its system keys).  Others are not built.
    case 9: return static_cast<int>(launch<9>(h_keys, n, q_keys, q_side, ranks, m, st));
    case 17: return static_cast<int>(launch<17>(h_keys, n, q_keys, q_side, ranks, m, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef PHASE1_STAMPS
// The stamp buffer: kStamps int64 per block, for phase1_stamps_blocks(n, m)
// blocks.
extern "C" int phase1_stamps_set(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));
}
extern "C" long long phase1_stamps_blocks(long long n, long long m) {
  return (n + m + kDiag - 1) / kDiag;
}
#endif
