// Fused warm-cache lookup for Hopper (sm_90a), all tables in one launch.
//
// Replaces the TPU kernel repro/kernels/embedding_bag/fused.py::_fused_kernel
// (its pl.pallas_call at fused.py:266), which the tiered parameter server
// launches once per table (repro/ps/server.py:362).
//
// What it computes, for every table t and bag b of a batch, from a host-built
// slot map (slot -1 = MISS, <= -2 = PAD, [0, K) = hot-block row,
// [K, K+C) = warm-cache slot + K):
//  * the raw (weighted) per-bag SUM of the hot and warm rows, with MISS and
//    PAD positions contributing nothing; the mean is an eager epilogue in
//    the wrapper, as on the TPU path;
//  * the miss list: the distinct missing row ids, ascending, and the flat
//    positions b*L+i of every MISS, ascending, and their two counts.
//
// What bounds it on an H100. Each hit reads one D-wide row and does D adds;
// the floor is those rows' bytes, once each, plus the slot map. As in
// embedding_bag.cu, the caches serve most repeats of hot rows, and the
// earlier register-ring design (72 registers, 24 warps an SM) was held
// back by the loop's cost, at a fifth of its byte bound. So the
// gather-and-pool pass runs the core shared with embedding_bag.cu
// (bag_common.cuh): one warp per bag over grid (ceil(B / bags_per_block),
// T), rows staged in a shared-memory ring by cp.async, slots turned into
// row addresses and bitmasks 32 at a time, unrolled chunks, a branch-free
// compensated add, no weight work for unweighted bags. The slot map is read
// once, streaming: the staging of each window of 32 slots also does the
// bag's share of the miss list. What still bounds it is the loop: the
// bit-exact compensated add per hit (PERF.md). A bag with no miss comes
// out bit for bit as the embedding-bag kernel pools it, which is what lets
// the tiered backend equal the device backend.
//
// The miss list without a sequential grid. The TPU kernel keeps running
// miss counters in SMEM from one sequential grid step to the next and
// dedupes with a scan over the rows already emitted. Blocks on the card run
// in no order, so:
//  * the gather-and-pool pass writes each bag's count of MISS positions and
//    sets one bit per missing row in a [T, ceil(R/32)] bitmap (atomicOr;
//    the wrapper zeroes it first);
//  * a second kernel, one block per table, scans the bag counts, so that
//    every bag writes its positions at its own offset (miss_pos comes out
//    ascending), then scans the bitmap words' popcounts, so that every word
//    writes its set bits' row ids at its own offset (miss_rows comes out
//    distinct and ascending, the order the TPU wrapper's np.sort gives).
// Nothing depends on the order in which blocks run: the lists are
// deterministic.
//
// Bad input is never dereferenced: a slot >= K + C, or a MISS whose row id
// lies outside [0, R), makes its bag NaN (as embedding_bag.cu does for a bad
// index) and is left out of the miss list.
//
// Plain-C interface, built with nvcc into a shared library and called from
// Python through ctypes (fused.py): one entry per kernel. The launches go on
// the caller's stream, do not synchronise and allocate nothing.

#include "bag_common.cuh"

namespace {

using bag_common::Entry;
using bag_common::kBad;
using bag_common::kFull;
using bag_common::kMaxBagsPerBlock;
using bag_common::kSkip;

constexpr int kListThreads = 1024;  // one block per table in the list pass
constexpr int kMiss = -1;

struct Params {
  const void* cache;            // [T', C, D] warm payload, rows contiguous
  long long cache_table_stride;
  long long cache_row_stride;
  long long num_cache;          // C
  const void* hot;              // [T', K, D] hot block, or null
  long long hot_table_stride;
  long long hot_row_stride;
  long long num_hot;            // K
  long long num_rows;           // R (row ids are valid in [0, R))
  const int* slots;             // [B, T, L] contiguous
  const int* rows;              // [B, T, L] contiguous, raw row ids
  const float* weights;         // [B, T, L] contiguous, or null
  void* out;                    // [B, T, D] contiguous, raw sums
  int* bag_miss;                // [T, B] MISS count per bag
  unsigned* bitmap;             // [T, words] one bit per missing row
  long long words;              // ceil(R / 32)
  long long batch;              // B
  int num_tables;               // T
  int pooling;                  // L
  int dim;                      // D
  int bags_per_block;
};

__device__ __forceinline__ bool valid_row(int row, long long num_rows) {
  return row >= 0 && (long long)row < num_rows;
}

// Slot q of one bag -> the address of its row ([0, K+C)), kSkip for a MISS
// or PAD, kBad for input it must not trust. On the first column pass a
// MISS also sets its row's bit and counts towards the bag's misses.
template <typename T, bool WEIGHTED> struct FusedSource {
  const int* slot;
  const int* rowid;
  const float* w;
  const T* cache;
  const T* hot;
  unsigned* bits;
  long long cache_row_stride, hot_row_stride, num_hot, num_cache, num_rows;
  int misses;  // this lane's MISS positions, first pass only
  __device__ __forceinline__ Entry entry(int q, bool first_pass) {
    const int s = __ldcs(slot + q);
    const float wv = WEIGHTED ? __ldcs(w + q) : 1.f;
    if (s >= 0) {
      if ((long long)s >= num_hot + num_cache) return {kBad, wv};
      const T* src = s < num_hot ? hot + s * hot_row_stride
                                 : cache + (s - num_hot) * cache_row_stride;
      return {reinterpret_cast<uintptr_t>(src), wv};
    }
    if (s != kMiss) return {kSkip, wv};  // PAD
    const int row = __ldcs(rowid + q);
    if (!valid_row(row, num_rows)) return {kBad, wv};
    if (first_pass) {
      atomicOr(bits + (row >> 5), 1u << (row & 31));
      ++misses;
    }
    return {kSkip, wv};
  }
};

template <typename T, bool VEC, bool WEIGHTED, int DEPTH>
__global__ void __launch_bounds__(32 * kMaxBagsPerBlock,
                                         bag_common::kMinBlocksPerSM)
    fused_kernel(const Params p) {
  extern __shared__ __align__(16) char smem[];
  using S = bag_common::Slice<T, VEC>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * p.bags_per_block + warp;
  if (b >= p.batch) return;  // the ragged edge of B; uniform across the warp
  const int t = blockIdx.y;
  const int L = p.pooling;
  const long long bag = b * p.num_tables + t;
  FusedSource<T, WEIGHTED> src{
      p.slots + bag * L,
      p.rows + bag * L,
      WEIGHTED ? p.weights + bag * L : nullptr,
      static_cast<const T*>(p.cache) + t * p.cache_table_stride,
      p.hot ? static_cast<const T*>(p.hot) + t * p.hot_table_stride : nullptr,
      p.bitmap + t * p.words,
      p.cache_row_stride, p.hot_row_stride, p.num_hot, p.num_cache,
      p.num_rows, 0};
  T* out = static_cast<T*>(p.out) + bag * p.dim;
  char* mine =
      smem + warp * bag_common::warp_smem_bytes(DEPTH, WEIGHTED, VEC);
  bag_common::pool_bag<T, VEC, WEIGHTED, DEPTH>(
      src, L, p.dim, mine,
      [=](int col, float* acc, float) { S::store(out + col, acc); });
  const int misses = __reduce_add_sync(kFull, src.misses);
  if (lane == 0) p.bag_miss[(long long)t * p.batch + b] = misses;
}

// Exclusive prefix sum of v over the block; *total gets the block's sum.
// Every thread of the block must call it. scratch holds 33 ints.
__device__ int block_exclusive_scan(int v, int* total, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    const int mine = lane < nwarps ? scratch[lane] : 0;
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane < nwarps) scratch[lane] = incl - mine;
    if (lane == 31) scratch[32] = incl;
  }
  __syncthreads();
  const int result = scratch[warp] + x - v;
  *total = scratch[32];
  __syncthreads();  // scratch is reused by the next call
  return result;
}

// One block per table: turn the bag counts and the bitmap into the two
// ascending miss lists and their counts.
__global__ void __launch_bounds__(kListThreads)
    miss_list_kernel(const Params p, int* miss_rows, int* miss_pos,
                     int* counts, long long capacity) {
  __shared__ int scratch[33];
  __shared__ int offset[kListThreads];
  __shared__ int count[kListThreads];
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int L = p.pooling;
  const unsigned below = (1u << lane) - 1u;  // lanes under this one
  int* pos_out = miss_pos + t * capacity;
  int* row_out = miss_rows + t * capacity;

  // Positions: the bags' counts, scanned a tile of bags at a time; then each
  // warp writes its bags' MISS positions at their offsets, in order.
  int occurrences = 0;
  for (long long tile = 0; tile < p.batch; tile += blockDim.x) {
    const long long b = tile + threadIdx.x;
    const int c = b < p.batch ? p.bag_miss[(long long)t * p.batch + b] : 0;
    int tile_total;
    const int excl = block_exclusive_scan(c, &tile_total, scratch);
    offset[threadIdx.x] = occurrences + excl;
    count[threadIdx.x] = c;
    __syncthreads();
    for (int j = warp; j < (int)blockDim.x; j += nwarps) {
      const long long bb = tile + j;
      if (bb >= p.batch || count[j] == 0) continue;
      const long long bag = bb * p.num_tables + t;
      const int* slot = p.slots + bag * L;
      const int* rowid = p.rows + bag * L;
      int off = offset[j];
      for (int i0 = 0; i0 < L; i0 += 32) {
        const int i = i0 + lane;
        const bool miss = i < L && slot[i] == kMiss &&
                          valid_row(rowid[i], p.num_rows);
        const unsigned mask = __ballot_sync(kFull, miss);
        if (miss) pos_out[off + __popc(mask & below)] = (int)(bb * L + i);
        off += __popc(mask);
      }
    }
    occurrences += tile_total;
    __syncthreads();  // offset/count are rewritten by the next tile
  }

  // Distinct rows: the bitmap words' popcounts, scanned a tile at a time;
  // each word writes its set bits' row ids at its offset, lowest first.
  int distinct = 0;
  const unsigned* bits = p.bitmap + t * p.words;
  for (long long tile = 0; tile < p.words; tile += blockDim.x) {
    const long long wi = tile + threadIdx.x;
    unsigned word = wi < p.words ? bits[wi] : 0u;
    int tile_total;
    int off = distinct + block_exclusive_scan(__popc(word), &tile_total,
                                              scratch);
    while (word) {
      const int k = __ffs(word) - 1;
      row_out[off++] = (int)(wi * 32 + k);
      word &= word - 1u;
    }
    distinct += tile_total;
  }
  if (threadIdx.x == 0) {
    counts[2 * t] = distinct;
    counts[2 * t + 1] = occurrences;
  }
}

// The instantiation launched last, for *_last_launch_info. Diagnostic only:
// every launch writes it, unsynchronised, so it is read only after launches
// made from one thread (chip_smoke.py's parity, parity_fused and
// kernel_diag); launches from the sharded backend's shard threads race on
// it harmlessly and nothing reads it then.
bag_common::LaunchRecord g_last;

}  // namespace

using bag_common::aligned16;

extern "C" {

// The gather-and-pool pass over every table. dtype: 0 = float32,
// 1 = bfloat16. prefetch_distance asks for the ring depth (row slots per
// warp; the kernel takes the largest power of two <= it in [2, 16]).
// bag_miss and bitmap are outputs the caller allocates, the bitmap zeroed.
// Returns a cudaError_t (0 = launched).
int fused_lookup_pool(const void* cache, long long cache_table_stride,
                      long long cache_row_stride, long long num_cache,
                      const void* hot, long long hot_table_stride,
                      long long hot_row_stride, long long num_hot,
                      long long num_rows, const int* slots, const int* rows,
                      const float* weights, void* out, int* bag_miss,
                      unsigned* bitmap, long long words, long long batch,
                      int num_tables, int pooling, int dim, int dtype,
                      int bags_per_block, int prefetch_distance,
                      void* stream) {
  if (batch <= 0 || num_tables <= 0 || dim <= 0) return cudaSuccess;
  if (bags_per_block < 1 || bags_per_block > kMaxBagsPerBlock ||
      prefetch_distance < 1 || num_tables > 65535 || pooling < 0 ||
      batch * pooling > 0x7fffffffLL || num_rows > 0x7fffffffLL ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const long long blocks = (batch + bags_per_block - 1) / bags_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  Params p{cache,    cache_table_stride, cache_row_stride, num_cache,
           hot,      hot_table_stride,   hot_row_stride,   num_hot,
           num_rows, slots,              rows,             weights,
           out,      bag_miss,           bitmap,           words,
           batch,    num_tables,         pooling,          dim,
           bags_per_block};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long item = dtype == 0 ? 4 : 2;
  const bool vec = (dim * item) % 16 == 0 &&
                   (cache_row_stride * item) % 16 == 0 &&
                   (cache_table_stride * item) % 16 == 0 &&
                   (hot_row_stride * item) % 16 == 0 &&
                   (hot_table_stride * item) % 16 == 0 && aligned16(cache) &&
                   aligned16(hot) && aligned16(out);
  const dim3 grid((unsigned)blocks, (unsigned)num_tables);
  const dim3 block(32 * bags_per_block);
  return bag_common::instantiate(
      dtype, vec, weights != nullptr, bag_common::ring_depth(prefetch_distance),
      [&](auto t, auto v, auto w, auto d) {
        using T = typename decltype(t)::type;
        constexpr bool VEC = decltype(v)::value, WEIGHTED = decltype(w)::value;
        constexpr int DEPTH = decltype(d)::value;
        const size_t smem = (size_t)bags_per_block *
                            bag_common::warp_smem_bytes(DEPTH, WEIGHTED, VEC);
        return bag_common::launch_with_smem(
            fused_kernel<T, VEC, WEIGHTED, DEPTH>, grid, block, smem, s,
            g_last, VEC ? DEPTH : 0, bags_per_block, p);
      });
}

// The miss-list pass over the gather-and-pool pass's bag_miss and bitmap,
// after it on the same stream: miss_rows, miss_pos ([T, capacity]) and
// counts ([T, 2]) are outputs the caller allocates. Returns a cudaError_t.
int fused_lookup_lists(const int* slots, const int* rows, long long num_rows,
                       int* bag_miss, unsigned* bitmap, long long words,
                       int* miss_rows, int* miss_pos, int* counts,
                       long long capacity, long long batch, int num_tables,
                       int pooling, void* stream) {
  if (batch <= 0 || num_tables <= 0) return cudaSuccess;
  if (num_tables > 65535 || pooling < 0 || capacity < batch * pooling ||
      batch * pooling > 0x7fffffffLL || num_rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Params p{};
  p.num_rows = num_rows;
  p.slots = slots;
  p.rows = rows;
  p.bag_miss = bag_miss;
  p.bitmap = bitmap;
  p.words = words;
  p.batch = batch;
  p.num_tables = num_tables;
  p.pooling = pooling;
  miss_list_kernel<<<num_tables, kListThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      p, miss_rows, miss_pos, counts, capacity);
  return cudaGetLastError();
}

// Registers, resident blocks per SM and the rest of
// bag_common::launch_info for the gather-and-pool instantiation launched
// last.
int fused_lookup_last_launch_info(int* out) {
  return bag_common::launch_info(g_last, out);
}

const char* fused_lookup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
