// Sum-pooled embedding bags over tables of different sizes, with a bag
// length of its own for each table, in one launch (Hopper, sm_90a).
//
// Replaces no TPU kernel: the JAX package stacks equal tables [T, R, D]
// and has no ragged path. It was added for MLPerf's DLRM-DCNv2, whose 26
// tables hold 3 to 40 M rows (204 M in all: a [T, R_max, D] stack would
// be 266 GB in bf16) and whose bags take 1 to 100 lookups a table.
//
// Layout. The tables are one flat buffer [sum R_t, D]; table t's rows are
// [row_offsets[t], row_offsets[t + 1]). A sample's ids are one row of
// indices [B, C]: table t's at columns [col_offsets[t], col_offsets[t +
// 1]), each in [0, R_t). Pooled bags are written as float32 [B, T, D]
// whatever the tables' type (bf16 rows are widened as they are read).
//
// What bounds it on an H100: the bytes of the distinct rows, as for the
// stacked kernel (embedding_bag.cu); the gather-and-pool core is the same
// (bag_common::pool_bag: one warp a bag, a cp.async ring in shared memory,
// Kahan's compensated f32 sum in lookup order, within (2u + O(L·u²))·Σ|x|
// of the exact sum, u = eps/2), so with equal tables and bag lengths this
// kernel's f32 sums are the stacked kernel's bit for bit.
//
// Spreading uneven bags. A block pools `bags_per_block` bags of ONE table,
// so its warps carry equal work and a 100-lookup bag is never the
// critical path of a block of one-lookup bags. The grid is (ceil(B /
// bags_per_block), T), and grid row y pools table table_order[y]: the
// tables sorted by bag length, longest first. Blocks are handed to the
// SMs in order of their linear index, so the long bags start first and
// the short ones fill the SMs as the long ones drain (longest processing
// time first), rather than a long table's blocks arriving last and
// running alone.
//
// An id outside [0, R_t) is never dereferenced: it contributes NaN, as
// the stacked kernel's do. Plain-C interface, compiled into the same
// library as embedding_bag.cu (whose embedding_bag_error_string reads
// this file's error codes too) and loaded with ctypes (library.py); the
// launch goes on the caller's stream, does not synchronise and allocates
// nothing.

#include "bag_common.cuh"

namespace {

using bag_common::Entry;
using bag_common::kBad;
using bag_common::kMaxBagsPerBlock;

struct Params {
  const void* tables;             // [sum R_t, D], rows contiguous
  long long row_stride;           // elements between rows
  const long long* row_offsets;   // [T + 1]
  const int* col_offsets;         // [T + 1]
  const int* table_order;         // [T]: the table of each grid row
  const int* indices;             // [B, C] contiguous
  float* out;                     // [B, T, D] contiguous
  long long batch;                // B
  int num_tables;                 // T
  int cols;                       // C = col_offsets[T]
  int dim;                        // D
  int bags_per_block;
};

// Lookup q of one bag -> the address of its row, or kBad.
template <typename T> struct RaggedSource {
  const int* idx;
  const T* tab;
  long long row_stride, num_rows;
  __device__ __forceinline__ Entry entry(int q, bool) const {
    const int row = __ldcs(idx + q);
    if (row < 0 || (long long)row >= num_rows) return {kBad, 1.f};
    return {reinterpret_cast<uintptr_t>(tab + row * row_stride), 1.f};
  }
};

// A lane's f32 sums to the output: 16-byte streaming stores where the
// vector path gives a lane 4 or 8 values, one store each otherwise.
template <int N>
__device__ __forceinline__ void store_f32(float* p, const float* acc) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      __stcs(reinterpret_cast<float4*>(p + i),
             make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = acc[i];
  }
}

template <typename T, bool VEC, int DEPTH>
__global__ void __launch_bounds__(32 * kMaxBagsPerBlock,
                                  bag_common::kMinBlocksPerSM)
    ragged_bag_kernel(const Params p) {
  extern __shared__ __align__(16) char smem[];
  using S = bag_common::Slice<T, VEC>;
  const int warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * p.bags_per_block + warp;
  if (b >= p.batch) return;  // the ragged edge of B; uniform across the warp
  const int t = p.table_order[blockIdx.y];
  const int col = p.col_offsets[t];
  const int L = p.col_offsets[t + 1] - col;
  const long long base = p.row_offsets[t];
  const RaggedSource<T> src{
      p.indices + b * p.cols + col,
      static_cast<const T*>(p.tables) + base * p.row_stride, p.row_stride,
      p.row_offsets[t + 1] - base};
  float* out = p.out + (b * p.num_tables + t) * p.dim;
  char* mine =
      smem + warp * bag_common::warp_smem_bytes(DEPTH, false, VEC);
  bag_common::pool_bag<T, VEC, false, DEPTH>(
      src, L, p.dim, mine,
      [=](int c, float* acc, float) { store_f32<S::N>(out + c, acc); });
}

// The instantiation launched last, for ragged_bag_last_launch_info (read
// only after launches made from one thread).
bag_common::LaunchRecord g_last;

}  // namespace

using bag_common::aligned16;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (the tables'; the output is float32).
// prefetch_distance asks for the ring depth, as embedding_bag_launch's.
// Returns a cudaError_t (0 = launched).
int ragged_bag_launch(const void* tables, long long row_stride,
                      const long long* row_offsets, const int* col_offsets,
                      const int* table_order, const int* indices, float* out,
                      long long batch, int num_tables, int cols, int dim,
                      int dtype, int bags_per_block, int prefetch_distance,
                      void* stream) {
  if (batch <= 0 || num_tables <= 0 || dim <= 0) return cudaSuccess;
  if (bags_per_block < 1 || bags_per_block > kMaxBagsPerBlock ||
      prefetch_distance < 1 || num_tables > 65535 || cols < 0 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const long long blocks = (batch + bags_per_block - 1) / bags_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Params p{tables,  row_stride, row_offsets, col_offsets,
                 table_order, indices, out,      batch,
                 num_tables,  cols,    dim,      bags_per_block};
  const long long item = dtype == 0 ? 4 : 2;
  const bool vec = (dim * item) % 16 == 0 && (row_stride * item) % 16 == 0 &&
                   aligned16(tables) && aligned16(out);
  const dim3 grid((unsigned)blocks, (unsigned)num_tables);
  const dim3 block(32 * bags_per_block);
  const int depth = bag_common::ring_depth(prefetch_distance);
  auto pick = [&](auto t, auto v, auto, auto d) {
    using T = typename decltype(t)::type;
    constexpr bool VEC = decltype(v)::value;
    constexpr int DEPTH = decltype(d)::value;
    const size_t smem = (size_t)bags_per_block *
                        bag_common::warp_smem_bytes(DEPTH, false, VEC);
    return bag_common::launch_with_smem(
        ragged_bag_kernel<T, VEC, DEPTH>, grid, block, smem,
        static_cast<cudaStream_t>(stream), g_last, VEC ? DEPTH : 0,
        bags_per_block, p);
  };
  auto by_path = [&](auto t) {
    using bag_common::Bool;
    return vec ? bag_common::pick_depth(pick, t, Bool<true>{}, Bool<false>{},
                                        depth)
               : bag_common::pick_depth(pick, t, Bool<false>{},
                                        Bool<false>{}, depth);
  };
  return dtype == 0 ? by_path(bag_common::Type<float>{})
                    : by_path(bag_common::Type<__nv_bfloat16>{});
}

// Registers, resident blocks per SM and the rest of
// bag_common::launch_info for the last instantiation launched.
int ragged_bag_last_launch_info(int* out) {
  return bag_common::launch_info(g_last, out);
}

}  // extern "C"
