// Fused merge + removeBefore eviction + compaction (phases 5-6 of the
// Resolver's conflict step), for Hopper (sm_90a).
//
// Replaces: foundationdb_tpu/conflict/kernels.py::fused_merge_evict and its
// Pallas body _merge_kernel_body.  Same function: two position-annotated
// streams — A (the history rows, with a keep mask) and B (the batch's
// sorted new boundaries) — each kept row carrying its merged position
// (positions partition [0, merged_count)).  Row p of the merged order is
// dropped iff p > 0 and vers[p] and vers[p-1] are both < window (the
// reference's removeBefore rule; window = FLOOR keeps every row), and the
// survivors are compacted.  Rows at and past the returned count are
// undefined: the caller masks them.
//
// What bounds it on this card: bytes.  At the bench shape it reads A
// (3 key words + vers + keep + pos, 6 x 4 B x 3,145,728 = 75.5 MB) and B
// (3.1 MB) and writes up to 50.3 MB of output — about 38 us at 3.35 TB/s.
// The work per row is a handful of integer operations.
//
// Design.  The TPU kernel places rows with a one-hot MXU matmul over 16-bit
// halves and carries write cursors and the predecessor version in SMEM
// across an in-order grid.  Neither carries over: positions are known, so
// rows are written straight to them, and blocks run in no order, so output
// offsets come from a scan.  Four launches on one stream:
//   1. scatter   every kept A row and B row to its merged position in a
//                (kw1+1, width) scratch buffer (coalesced reads, scattered
//                4-byte writes; A positions are increasing, so A's writes
//                stay mostly sequential)
//   2. count     per tile of kTile merged rows, keep[p] from vers[p] and
//                vers[p-1] — for a tile's first row that is the previous
//                tile's last row, read straight from the scratch buffer —
//                and the tile's survivor count (__syncthreads_count)
//   3. scan      one block: exclusive scan of the tile counts (the TPU
//                kernel's output cursor) and the total count
//   4. write     each tile recomputes keep, ranks its survivors with a
//                warp-ballot block scan, and writes them at its offset
// The scratch round trip doubles the traffic of a single-pass design; a
// decoupled look-back that fuses 2-4 is the faster design for a later
// change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;        // merged rows per tile = threads per block
constexpr int kScanThreads = 1024;
constexpr int kMaxWords = 8;

__global__ void scatter_rows(const int32_t* __restrict__ keys,
                             const int32_t* __restrict__ vers,
                             const int32_t* __restrict__ keep,
                             const int32_t* __restrict__ pos, int64_t n,
                             int kw1, int32_t* __restrict__ s_keys,
                             int32_t* __restrict__ s_vers, int64_t width) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || keep[i] == 0) return;
  const int64_t p = pos[i];
  if (p < 0 || p >= width) return;
  for (int w = 0; w < kw1; ++w) s_keys[w * width + p] = keys[w * n + i];
  s_vers[p] = vers[i];
}

__device__ __forceinline__ bool keep_row(const int32_t* __restrict__ s_vers,
                                         int64_t p, int64_t live,
                                         int32_t window) {
  if (p >= live) return false;
  if (p == 0) return true;
  return !(s_vers[p] < window && s_vers[p - 1] < window);
}

__device__ __forceinline__ int64_t live_rows(const int32_t* merged_count,
                                             int64_t width) {
  const int64_t mc = *merged_count;
  return mc < width ? mc : width;
}

__global__ void tile_counts_kernel(const int32_t* __restrict__ s_vers,
                                   const int32_t* __restrict__ merged_count,
                                   const int32_t* __restrict__ window,
                                   int64_t width,
                                   int32_t* __restrict__ counts) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  const bool k = keep_row(s_vers, p, live_rows(merged_count, width), *window);
  const int n = __syncthreads_count(k);
  if (threadIdx.x == 0) counts[blockIdx.x] = n;
}

// Exclusive scan of `counts` [n] into `offsets`, total into *total.  One
// block walks the array in chunks of kScanThreads, carrying the running sum.
__global__ void scan_counts_kernel(const int32_t* __restrict__ counts,
                                   int64_t n, int32_t* __restrict__ offsets,
                                   int32_t* __restrict__ total) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  __shared__ int32_t carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < n; base += kScanThreads) {
    const int64_t i = base + threadIdx.x;
    const int32_t v = i < n ? counts[i] : 0;
    int32_t x = v;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int32_t s = lane < kScanThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += y;
      }
      if (lane < kScanThreads / 32) warp_sums[lane] = s;  // inclusive
    }
    __syncthreads();
    const int32_t before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (i < n) offsets[i] = carry + before;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry += before + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void write_survivors_kernel(
    const int32_t* __restrict__ s_keys, const int32_t* __restrict__ s_vers,
    const int32_t* __restrict__ merged_count,
    const int32_t* __restrict__ window, int64_t width, int kw1,
    const int32_t* __restrict__ offsets, int32_t* __restrict__ out_keys,
    int32_t* __restrict__ out_vers) {
  __shared__ int32_t warp_tot[kTile / 32];
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  const bool k = keep_row(s_vers, p, live_rows(merged_count, width), *window);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, k);
  if (lane == 0) warp_tot[warp] = __popc(ballot);
  __syncthreads();
  if (!k) return;
  int32_t rank = __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) rank += warp_tot[w];
  const int64_t o = static_cast<int64_t>(offsets[blockIdx.x]) + rank;
  for (int w = 0; w < kw1; ++w) out_keys[w * width + o] = s_keys[w * width + p];
  out_vers[o] = s_vers[p];
}

inline unsigned blocks_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

extern "C" int merge_tile_rows() { return kTile; }

extern "C" int fused_merge_evict_launch(
    const void* a_keys, const void* a_vers, const void* a_keep,
    const void* a_pos, long long na, const void* b_keys, const void* b_vers,
    const void* b_keep, const void* b_pos, long long nb,
    const void* merged_count, const void* window, int kw1, long long width,
    void* s_keys, void* s_vers, void* tile_counts, void* tile_offsets,
    void* out_keys, void* out_vers, void* out_count, void* stream) {
  if (kw1 < 1 || kw1 > kMaxWords || width < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* mc = static_cast<const int32_t*>(merged_count);
  const auto* win = static_cast<const int32_t*>(window);
  auto* sk = static_cast<int32_t*>(s_keys);
  auto* sv = static_cast<int32_t*>(s_vers);
  auto* counts = static_cast<int32_t*>(tile_counts);
  auto* offsets = static_cast<int32_t*>(tile_offsets);
  const int64_t tiles = (width + kTile - 1) / kTile;
  cudaError_t err;

  if (na > 0) {
    scatter_rows<<<blocks_for(na, kTile), kTile, 0, s>>>(
        static_cast<const int32_t*>(a_keys), static_cast<const int32_t*>(a_vers),
        static_cast<const int32_t*>(a_keep), static_cast<const int32_t*>(a_pos),
        na, kw1, sk, sv, width);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (nb > 0) {
    scatter_rows<<<blocks_for(nb, kTile), kTile, 0, s>>>(
        static_cast<const int32_t*>(b_keys), static_cast<const int32_t*>(b_vers),
        static_cast<const int32_t*>(b_keep), static_cast<const int32_t*>(b_pos),
        nb, kw1, sk, sv, width);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  tile_counts_kernel<<<static_cast<unsigned>(tiles), kTile, 0, s>>>(
      sv, mc, win, width, counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_counts_kernel<<<1, kScanThreads, 0, s>>>(
      counts, tiles, offsets, static_cast<int32_t*>(out_count));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  write_survivors_kernel<<<static_cast<unsigned>(tiles), kTile, 0, s>>>(
      sk, sv, mc, win, width, kw1, offsets, static_cast<int32_t*>(out_keys),
      static_cast<int32_t*>(out_vers));
  return static_cast<int>(cudaGetLastError());
}
