// Embedding-bag gather-reduce for Hopper (sm_90a), all tables in one launch.
//
// Replaces the TPU kernel repro/kernels/embedding_bag/kernel.py::_bag_kernel
// (its pl.pallas_call at kernel.py:194), which the JAX package vmaps over
// the tables (repro/storage/device.py:144-150).
//
// What bounds it on an H100. A lookup reads one D-wide row and does D adds
// (multiply-adds when weighted): about 0.25 FLOP per byte of f32 row, so
// the floor is the distinct rows' bytes from device memory. But on med_hot
// traffic the caches serve most repeats of a row, and the earlier design,
// a register ring of row loads at 80 registers a thread (3 blocks, 24 warps
// an SM), took 11.4 ms at the serve shape where rows that L2 holds still
// took 9.4 ms: the loop, not device memory, was the limit (PERF.md). So
// the design cuts what the loop costs and raises the warps that hide it:
//  * one warp per bag, the lanes splitting a row into 16-byte slices (a
//    D=128 f32 row is one 512-byte pass of the warp);
//  * rows staged in a shared-memory ring of `depth` slots per warp by
//    cp.async, depth-1 lookups ahead, so the ring costs no registers: 40
//    registers, 6 blocks of 8 warps an SM;
//  * indices read 32 at a time, one a lane, turned into row addresses once
//    and kept with two bitmasks per window; read and written as streaming
//    data;
//  * a leaner loop: unrolled chunks with constant slot offsets, no weight,
//    product or weight sum for unweighted bags, Kahan's compensated add
//    (four f32 operations an element, bag_common.cuh);
//  * grid = (ceil(B / bags_per_block), T): one launch writes pooled [B, T, D].
// What is left: the loop's instructions where the caches serve the rows,
// and on served traffic the repeats that reach device memory (PERF.md).
// Rows below num_hot are read through the separate `hot` operand (the
// hot-first prefix of each table). Pinning it in L2 with a persisting
// access-policy window (paper §IV-C) is later work.
//
// Sums accumulate in f32 in lookup order, like the Pallas fori_loop, with
// Kahan's compensated add: med_hot bags repeat hot rows many times, and
// the rounding errors of a plain 150-term chain then add up coherently (at
// the serve shape they broke the 2·eps·Σ|w·x| rule against the plain
// version); Kahan's sum stays within (2u + O(L·u²))·Σ|w·x| of the exact
// one (u = eps/2), half the rule. The fused and ragged kernels pool through
// the same function, which is what keeps the tiered backend's bags equal to
// this kernel's bit for bit. Results are written in the table's type. A weighted mean
// divides by max(sum(w), 1e-9), an unweighted one by L. An index outside
// [0, R) is never dereferenced: it contributes NaN, as jnp.take's default
// fill does. Every table offset is 64-bit: T*R*D reaches 1.6e10 elements at
// the production size.
//
// Plain-C interface, built into the port's one shared library and called from
// Python through ctypes (kernel.py). The launch goes on the caller's stream,
// does not synchronise and allocates nothing.

#include "bag_common.cuh"

namespace {

using bag_common::Entry;
using bag_common::kBad;
using bag_common::kMaxBagsPerBlock;


struct Params {
  const void* tables;           // [T', R, D], rows contiguous
  long long table_stride;       // elements between tables
  long long row_stride;         // elements between rows
  const void* hot;              // hot-first prefix [T', K, D] (may alias tables)
  long long hot_table_stride;
  long long hot_row_stride;
  long long num_hot;            // K
  long long num_rows;           // R
  const int* indices;           // [B, T, L] contiguous, hot-first remapped
  const float* weights;         // [B, T, L] contiguous, or null
  void* out;                    // [B, T, D] contiguous, table dtype
  long long batch;              // B
  int num_tables;               // T
  int pooling;                  // L
  int dim;                      // D
  int mean;
  int bags_per_block;
};

// Lookup q of one bag -> the address of its row, or kBad.
template <typename T, bool WEIGHTED> struct BagSource {
  const int* idx;
  const float* w;
  const T* tab;
  const T* hot;
  long long row_stride, hot_row_stride, num_hot, num_rows;
  __device__ __forceinline__ Entry entry(int q, bool) const {
    const int row = __ldcs(idx + q);
    const float wv = WEIGHTED ? __ldcs(w + q) : 1.f;
    if (row < 0 || (long long)row >= num_rows) return {kBad, wv};
    const T* src = row < num_hot ? hot + row * hot_row_stride
                                 : tab + row * row_stride;
    return {reinterpret_cast<uintptr_t>(src), wv};
  }
};

template <typename T, bool VEC, bool WEIGHTED, int DEPTH>
__global__ void __launch_bounds__(32 * kMaxBagsPerBlock,
                                         bag_common::kMinBlocksPerSM)
    bag_kernel(const Params p) {
  extern __shared__ __align__(16) char smem[];
  using S = bag_common::Slice<T, VEC>;
  const int warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * p.bags_per_block + warp;
  if (b >= p.batch) return;  // the ragged edge of B; uniform across the warp
  const int t = blockIdx.y;
  const int L = p.pooling;
  const long long bag = b * p.num_tables + t;
  const BagSource<T, WEIGHTED> src{
      p.indices + bag * L,
      WEIGHTED ? p.weights + bag * L : nullptr,
      static_cast<const T*>(p.tables) + t * p.table_stride,
      static_cast<const T*>(p.hot) + t * p.hot_table_stride,
      p.row_stride, p.hot_row_stride, p.num_hot, p.num_rows};
  T* out = static_cast<T*>(p.out) + bag * p.dim;
  const bool mean = p.mean;
  char* mine =
      smem + warp * bag_common::warp_smem_bytes(DEPTH, WEIGHTED, VEC);
  bag_common::pool_bag<T, VEC, WEIGHTED, DEPTH>(
      src, L, p.dim, mine, [=](int col, float* acc, float wsum) {
        if (mean) {
          const float denom = WEIGHTED ? fmaxf(wsum, 1e-9f) : (float)L;
#pragma unroll
          for (int i = 0; i < S::N; ++i) acc[i] = acc[i] / denom;
        }
        S::store(out + col, acc);
      });
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

// dtype: 0 = float32, 1 = bfloat16. prefetch_distance asks for the ring
// depth (row slots per warp; the kernel takes the largest power of two <= it
// in [2, 16]). Returns a cudaError_t (0 = launched).
int embedding_bag_launch(const void* tables, long long table_stride,
                         long long row_stride, const void* hot,
                         long long hot_table_stride, long long hot_row_stride,
                         long long num_hot, long long num_rows,
                         const int* indices, const float* weights, void* out,
                         long long batch, int num_tables, int pooling, int dim,
                         int dtype, int mean, int bags_per_block,
                         int prefetch_distance, void* stream) {
  if (batch <= 0 || num_tables <= 0 || dim <= 0) return cudaSuccess;
  if (bags_per_block < 1 || bags_per_block > kMaxBagsPerBlock ||
      prefetch_distance < 1 || num_tables > 65535 || pooling < 0 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const long long blocks = (batch + bags_per_block - 1) / bags_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  Params p{tables,  table_stride, row_stride, hot,    hot_table_stride,
           hot_row_stride, num_hot, num_rows, indices, weights,
           out,     batch,        num_tables, pooling, dim,
           mean,    bags_per_block};
  const long long item = dtype == 0 ? 4 : 2;
  const bool vec = (dim * item) % 16 == 0 && (row_stride * item) % 16 == 0 &&
                   (table_stride * item) % 16 == 0 &&
                   (hot_row_stride * item) % 16 == 0 &&
                   (hot_table_stride * item) % 16 == 0 && aligned16(tables) &&
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
            bag_kernel<T, VEC, WEIGHTED, DEPTH>, grid, block, smem,
            static_cast<cudaStream_t>(stream), g_last, VEC ? DEPTH : 0,
            bags_per_block, p);
      });
}

// Registers, resident blocks per SM and the rest of
// bag_common::launch_info for the last instantiation launched.
int embedding_bag_last_launch_info(int* out) {
  return bag_common::launch_info(g_last, out);
}

const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
