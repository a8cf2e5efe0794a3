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
// What bounds it on an H100: bytes from device memory. Each hit reads one
// D-wide row and does D multiply-adds; the slot map is read once, and the
// row ids only at MISS positions. So the gather-and-pool pass has the shape
// of embedding_bag.cu: one warp per bag, 16-byte lane loads (a D=128 f32
// row is one coalesced 512-byte warp load), and a register ring keeping PD
// row loads of the bag in flight, over grid (ceil(B / bags_per_block), T).
// The arithmetic is that kernel's, from bag_common.cuh: products rounded
// once, Neumaier-compensated f32 sums in lookup order. A bag with no miss
// therefore comes out bit for bit as the embedding-bag kernel pools it,
// which is what lets the tiered backend equal the device backend.
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
// Python through ctypes (fused.py). The launches go on the caller's stream,
// do not synchronise and allocate nothing.

#include "bag_common.cuh"

namespace {

using bag_common::add_compensated;
using bag_common::kFull;
using bag_common::Slice;

constexpr int kMaxDistance = 16;
constexpr int kMaxBagsPerBlock = 8;
constexpr int kListThreads = 1024;  // one block per table in the list pass
constexpr int kMiss = -1;
constexpr int kSkip = -1;  // effective slot: nothing to load or add
constexpr int kBad = -3;   // effective slot: the bag becomes NaN

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

// Slot -> what the pooling loop does with the position: a row to load
// ([0, K+C)), kSkip for a MISS or PAD, kBad for input it must not trust.
__device__ __forceinline__ int effective_slot(const Params& p, int slot,
                                              int row) {
  if (slot >= 0) return (long long)slot < p.num_hot + p.num_cache ? slot : kBad;
  if (slot == kMiss) return valid_row(row, p.num_rows) ? kSkip : kBad;
  return kSkip;  // PAD
}

template <typename T, bool VEC, int PD>
__global__ void __launch_bounds__(32 * kMaxBagsPerBlock)
    fused_kernel(const Params p) {
  using S = Slice<T, VEC>;
  constexpr int N = S::N;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * p.bags_per_block + warp;
  if (b >= p.batch) return;  // the ragged edge of B; uniform across the warp
  const int t = blockIdx.y;
  const int L = p.pooling;
  const long long bag = b * p.num_tables + t;
  const int* slot = p.slots + bag * L;
  const int* rowid = p.rows + bag * L;
  const float* w = p.weights ? p.weights + bag * L : nullptr;
  const T* cache = static_cast<const T*>(p.cache) + t * p.cache_table_stride;
  const T* hot = p.hot ? static_cast<const T*>(p.hot) + t * p.hot_table_stride
                       : nullptr;
  T* out = static_cast<T*>(p.out) + bag * p.dim;
  unsigned* bits = p.bitmap + t * p.words;

  // The miss list's share of this bag: its MISS count, and one bit per
  // missing row. Reads the row ids at MISS positions only.
  int misses = 0;
  for (int i0 = 0; i0 < L; i0 += 32) {
    const int i = i0 + lane;
    bool miss = false;
    if (i < L && slot[i] == kMiss) {
      const int row = rowid[i];
      miss = valid_row(row, p.num_rows);
      if (miss) atomicOr(bits + (row >> 5), 1u << (row & 31));
    }
    misses += __popc(__ballot_sync(kFull, miss));
  }
  if (lane == 0) p.bag_miss[(long long)t * p.batch + b] = misses;

  const int slices = p.dim / N;
  for (int c0 = 0; c0 < slices; c0 += 32) {
    const bool active = c0 + lane < slices;
    const int col = (c0 + lane) * N;  // this lane's first element in a row

    // Lookups [base, base+32) and [base+32, base+64): one slot per lane.
    auto load_slot = [&](int q) {
      if (q >= L) return kSkip;
      const int s = slot[q];
      return effective_slot(p, s, s == kMiss ? rowid[q] : 0);
    };
    int base = 0;
    int cur_e = load_slot(lane);
    int nxt_e = load_slot(32 + lane);
    float cur_w = (w && lane < L) ? w[lane] : 1.f;
    float nxt_w = (w && 32 + lane < L) ? w[32 + lane] : 1.f;

    auto slot_at = [&](int q) {  // q - base < 64; q is uniform across the warp
      const int o = q - base;
      return __shfl_sync(kFull, o < 32 ? cur_e : nxt_e, o & 31);
    };
    auto fetch = [&](S& s, int e) {
      if (!active || e < 0) return;  // a MISS, PAD or bad slot loads nothing
      s.load(e < p.num_hot ? hot + e * p.hot_row_stride + col
                           : cache + (e - p.num_hot) * p.cache_row_stride + col);
    };

    float acc[N], comp[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = comp[i] = 0.f;

    S ring[PD];
#pragma unroll
    for (int k = 0; k < PD; ++k)
      if (k < L) fetch(ring[k], slot_at(k));

    for (int q0 = 0; q0 < L; q0 += PD) {
#pragma unroll
      for (int k = 0; k < PD; ++k) {
        const int q = q0 + k;  // ring[k] holds lookup q
        if (q >= L) break;
        if (q - base == 32) {  // slide the slot window by one chunk
          base += 32;
          cur_e = nxt_e;
          cur_w = nxt_w;
          const int nq = base + 32 + lane;
          nxt_e = load_slot(nq);
          nxt_w = (w && nq < L) ? w[nq] : 1.f;
        }
        const int o = q - base;
        const int e = __shfl_sync(kFull, cur_e, o);
        const float wv = __shfl_sync(kFull, cur_w, o);  // 1 when unweighted
        if (e >= 0) {
#pragma unroll
          for (int i = 0; i < N; ++i)
            add_compensated(acc[i], comp[i], __fmul_rn(ring[k].get(i), wv));
        } else if (e == kBad) {
#pragma unroll
          for (int i = 0; i < N; ++i)
            add_compensated(acc[i], comp[i], bag_common::quiet_nan());
        }
        if (q + PD < L) fetch(ring[k], slot_at(q + PD));
      }
    }

#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += comp[i];
    if (active) S::store(out + col, acc);
  }
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

template <typename T, bool VEC>
void launch(const Params& p, int distance, dim3 grid, dim3 block,
            cudaStream_t stream) {
  switch (distance) {
    case 1: fused_kernel<T, VEC, 1><<<grid, block, 0, stream>>>(p); break;
    case 2: fused_kernel<T, VEC, 2><<<grid, block, 0, stream>>>(p); break;
    case 4: fused_kernel<T, VEC, 4><<<grid, block, 0, stream>>>(p); break;
    case 8: fused_kernel<T, VEC, 8><<<grid, block, 0, stream>>>(p); break;
    default: fused_kernel<T, VEC, 16><<<grid, block, 0, stream>>>(p); break;
  }
}

}  // namespace

using bag_common::aligned16;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. bag_miss, bitmap, miss_rows, miss_pos
// and counts are scratch and outputs the caller allocates; the bitmap must
// be zero. Returns a cudaError_t (0 = both kernels launched).
int fused_lookup_launch(const void* cache, long long cache_table_stride,
                        long long cache_row_stride, long long num_cache,
                        const void* hot, long long hot_table_stride,
                        long long hot_row_stride, long long num_hot,
                        long long num_rows, const int* slots, const int* rows,
                        const float* weights, void* out, int* bag_miss,
                        unsigned* bitmap, long long words, int* miss_rows,
                        int* miss_pos, int* counts, long long capacity,
                        long long batch, int num_tables, int pooling, int dim,
                        int dtype, int bags_per_block, int prefetch_distance,
                        void* stream) {
  if (batch <= 0 || num_tables <= 0 || dim <= 0) return cudaSuccess;
  const long long blocks = (batch + bags_per_block - 1) / bags_per_block;
  if (bags_per_block < 1 || bags_per_block > kMaxBagsPerBlock ||
      num_tables > 65535 || pooling < 0 || blocks > 0x7fffffffLL ||
      capacity < batch * pooling || batch * pooling > 0x7fffffffLL ||
      num_rows > 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Params p{cache,    cache_table_stride, cache_row_stride, num_cache,
           hot,      hot_table_stride,   hot_row_stride,   num_hot,
           num_rows, slots,              rows,             weights,
           out,      bag_miss,           bitmap,           words,
           batch,    num_tables,         pooling,          dim,
           bags_per_block};
  const long long item = dtype == 0 ? 4 : 2;
  const bool vec = (dim * item) % 16 == 0 &&
                   (cache_row_stride * item) % 16 == 0 &&
                   (cache_table_stride * item) % 16 == 0 &&
                   (hot_row_stride * item) % 16 == 0 &&
                   (hot_table_stride * item) % 16 == 0 && aligned16(cache) &&
                   aligned16(hot) && aligned16(out);
  const int distance = bag_common::ring_depth(prefetch_distance, kMaxDistance);
  const dim3 grid((unsigned)blocks, (unsigned)num_tables);
  const dim3 block(32 * bags_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec) launch<float, true>(p, distance, grid, block, s);
    else launch<float, false>(p, distance, grid, block, s);
  } else {
    if (vec) launch<__nv_bfloat16, true>(p, distance, grid, block, s);
    else launch<__nv_bfloat16, false>(p, distance, grid, block, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  miss_list_kernel<<<num_tables, kListThreads, 0, s>>>(p, miss_rows, miss_pos,
                                                       counts, capacity);
  return cudaGetLastError();
}

const char* fused_lookup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
