// Phase-1 history search of the Resolver's conflict step, for Hopper (sm_90a).
//
// Replaces: foundationdb_tpu/conflict/kernels.py::phase1_ranks and its
// Pallas body _search_kernel_body.  Same function: the insertion rank of
// every query key into the sorted, word-major, INF-padded history keys —
// side 0 counts rows < q, side 1 counts rows <= q — over the full buffer
// width N, padding included (equal to searchsorted_words).
//
// What bounds it on this card: the history table.  At the bench shape it is
// 3 words x 3,145,728 rows x 4 B = 37.7 MB, read by 131,072 queries; the
// least time is that table read once from HBM (~12 us at 3.35 TB/s).  A
// binary search instead reads ~22 rows per query at dependent addresses, so
// this kernel is bound by memory latency, not bandwidth.
//
// Design.  The TPU kernel streams history tiles in grid order and carries a
// cursor of resolved queries in SMEM; that is only correct on an in-order
// grid.  Here every thread owns one query and runs its own multiword
// lexicographic binary search, so no block depends on another.  The
// queries arrive sorted, so neighbouring threads walk nearly the same path:
// the upper levels of the search hit the same rows (served from L1/L2) and
// the warp's loads stay close together.  A block-cooperative version that
// co-ranks a chunk's first and last query and streams that span through
// shared memory is the faster design for a later change.
//
// Key words are int32 in the port's device encoding (the uint32 word with
// its sign bit flipped), so signed compares give the unsigned order.
// Word 0 is the most significant; the first differing word decides, which
// is the reference's lex_less/lex_leq (trailing word first, word 0 last).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWords = 8;
constexpr int kThreads = 256;

__global__ void phase1_ranks_kernel(const int32_t* __restrict__ h_keys,
                                    int64_t n,
                                    const int32_t* __restrict__ q_keys,
                                    const int32_t* __restrict__ q_side,
                                    int32_t* __restrict__ ranks, int64_t m,
                                    int kw1) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int32_t q[kMaxWords];
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    q[w] = w < kw1 ? q_keys[w * m + i] : 0;
  }
  const bool right = q_side[i] != 0;
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    int c = 0;  // sign of (h[mid] - q), lexicographic
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      if (w < kw1 && c == 0) {
        const int32_t hw = __ldg(h_keys + w * n + mid);
        c = (hw < q[w]) ? -1 : ((hw > q[w]) ? 1 : 0);
      }
    }
    const bool go_right = right ? (c <= 0) : (c < 0);
    if (go_right) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  ranks[i] = static_cast<int32_t>(lo);
}

}  // namespace

extern "C" int phase1_ranks_launch(const void* h_keys, long long n,
                                   const void* q_keys, const void* q_side,
                                   void* ranks, long long m, int kw1,
                                   void* stream) {
  if (kw1 < 1 || kw1 > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((m + kThreads - 1) / kThreads);
  phase1_ranks_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(h_keys), n,
      static_cast<const int32_t*>(q_keys), static_cast<const int32_t*>(q_side),
      static_cast<int32_t*>(ranks), m, kw1);
  return static_cast<int>(cudaGetLastError());
}
