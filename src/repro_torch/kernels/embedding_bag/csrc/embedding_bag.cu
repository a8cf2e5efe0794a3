// Embedding-bag gather-reduce for Hopper (sm_90a), all tables in one launch.
//
// Replaces the TPU kernel repro/kernels/embedding_bag/kernel.py::_bag_kernel
// (its pl.pallas_call at kernel.py:194), which the JAX package vmaps over
// the tables (repro/storage/device.py:144-150).
//
// What bounds it on an H100: bytes from device memory. A lookup reads one
// D-wide row and does D adds (multiply-adds when weighted): about 0.25 FLOP
// per byte of f32 row, far below the card's ridge point. So the design is
// about getting the row bytes in quickly:
//  * one warp per bag; the lanes split the row into 16-byte vectors, so a
//    D=128 f32 row is one coalesced 512-byte load of the warp;
//  * a register ring keeps PD row loads of the bag in flight (software
//    prefetch, paper §IV-B): the load for lookup q+PD is issued as soon as
//    lookup q is consumed, across the 32-lookup index chunks;
//  * the warp reads its bag's indices and weights 32 at a time, one per
//    lane, and broadcasts each with __shfl_sync;
//  * grid = (ceil(B / bags_per_block), T): one launch writes pooled [B, T, D].
// Rows below num_hot are read through the separate `hot` operand (the
// hot-first prefix of each table). Pinning it in L2 with a persisting
// access-policy window (paper §IV-C) is later work.
//
// Sums accumulate in f32 in lookup order, like the Pallas fori_loop, with
// Neumaier compensation: med_hot bags repeat hot rows many times, and the
// rounding errors of a plain 150-term chain then add up coherently (at the
// serve shape they broke the 2·eps·Σ|w·x| rule against the plain version).
// The compensation costs a few flops per element, free in a kernel this
// far below the ridge point. Results are written in the table's type. A weighted mean divides by max(sum(w), 1e-9),
// an unweighted one by L. An index outside [0, R) is never dereferenced: it
// contributes NaN, as jnp.take's default fill does. Every table offset is
// 64-bit: T*R*D reaches 1.6e10 elements at the production size.
//
// The slice type, the compensated add and the NaN fill live in
// bag_common.cuh, shared with fused_lookup.cu.
//
// Plain-C interface, built with nvcc into a shared library and called from
// Python through ctypes (kernel.py). The launch goes on the caller's stream,
// does not synchronise and allocates nothing.

#include "bag_common.cuh"

namespace {

using bag_common::add_compensated;
using bag_common::kFull;
using bag_common::Slice;

constexpr int kMaxDistance = 16;
constexpr int kMaxBagsPerBlock = 8;  // 256 threads: room for a 16-deep ring

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

template <typename T, bool VEC, int PD>
__global__ void __launch_bounds__(32 * kMaxBagsPerBlock) bag_kernel(const Params p) {
  using S = Slice<T, VEC>;
  constexpr int N = S::N;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * p.bags_per_block + warp;
  if (b >= p.batch) return;  // the ragged edge of B; uniform across the warp
  const int t = blockIdx.y;
  const int L = p.pooling;
  const long long bag = b * p.num_tables + t;
  const int* idx = p.indices + bag * L;
  const float* w = p.weights ? p.weights + bag * L : nullptr;
  const T* tab = static_cast<const T*>(p.tables) + t * p.table_stride;
  const T* hot = static_cast<const T*>(p.hot) + t * p.hot_table_stride;
  T* out = static_cast<T*>(p.out) + bag * p.dim;
  const int slices = p.dim / N;

  for (int c0 = 0; c0 < slices; c0 += 32) {
    const bool active = c0 + lane < slices;
    const int col = (c0 + lane) * N;  // this lane's first element in a row

    // Lookups [base, base+32) and [base+32, base+64): one index per lane.
    int base = 0;
    int cur_i = lane < L ? idx[lane] : 0;
    int nxt_i = 32 + lane < L ? idx[32 + lane] : 0;
    float cur_w = (w && lane < L) ? w[lane] : 1.f;
    float nxt_w = (w && 32 + lane < L) ? w[32 + lane] : 1.f;

    auto row_at = [&](int q) {  // q - base < 64; q is uniform across the warp
      const int o = q - base;
      return __shfl_sync(kFull, o < 32 ? cur_i : nxt_i, o & 31);
    };
    auto in_range = [&](int row) {
      return row >= 0 && (long long)row < p.num_rows;
    };
    auto fetch = [&](S& s, int row) {
      if (!active) return;
      if (!in_range(row)) row = 0;  // never read out of bounds
      s.load(row < p.num_hot ? hot + row * p.hot_row_stride + col
                             : tab + row * p.row_stride + col);
    };

    float acc[N], comp[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = comp[i] = 0.f;
    float wsum = 0.f, wcomp = 0.f;

    S ring[PD];
#pragma unroll
    for (int k = 0; k < PD; ++k)
      if (k < L) fetch(ring[k], row_at(k));

    for (int q0 = 0; q0 < L; q0 += PD) {
#pragma unroll
      for (int k = 0; k < PD; ++k) {
        const int q = q0 + k;  // ring[k] holds lookup q
        if (q >= L) break;
        if (q - base == 32) {  // slide the index window by one chunk
          base += 32;
          cur_i = nxt_i;
          cur_w = nxt_w;
          const int nq = base + 32 + lane;
          nxt_i = nq < L ? idx[nq] : 0;
          nxt_w = (w && nq < L) ? w[nq] : 1.f;
        }
        const int o = q - base;
        const int row = __shfl_sync(kFull, cur_i, o);
        float wv = __shfl_sync(kFull, cur_w, o);  // 1 when unweighted
        if (!in_range(row)) wv = bag_common::quiet_nan();
        add_compensated(wsum, wcomp, wv);
#pragma unroll
        for (int i = 0; i < N; ++i)
          add_compensated(acc[i], comp[i], __fmul_rn(ring[k].get(i), wv));
        if (q + PD < L) fetch(ring[k], row_at(q + PD));
      }
    }

#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += comp[i];
    if (p.mean) {
      const float denom = w ? fmaxf(wsum + wcomp, 1e-9f) : (float)L;
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = acc[i] / denom;
    }
    if (active) S::store(out + col, acc);
  }
}

template <typename T, bool VEC>
void launch(const Params& p, int distance, dim3 grid, dim3 block,
            cudaStream_t stream) {
  switch (distance) {
    case 1: bag_kernel<T, VEC, 1><<<grid, block, 0, stream>>>(p); break;
    case 2: bag_kernel<T, VEC, 2><<<grid, block, 0, stream>>>(p); break;
    case 4: bag_kernel<T, VEC, 4><<<grid, block, 0, stream>>>(p); break;
    case 8: bag_kernel<T, VEC, 8><<<grid, block, 0, stream>>>(p); break;
    default: bag_kernel<T, VEC, 16><<<grid, block, 0, stream>>>(p); break;
  }
}

}  // namespace

using bag_common::aligned16;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int embedding_bag_launch(const void* tables, long long table_stride,
                         long long row_stride, const void* hot,
                         long long hot_table_stride, long long hot_row_stride,
                         long long num_hot, long long num_rows,
                         const int* indices, const float* weights, void* out,
                         long long batch, int num_tables, int pooling, int dim,
                         int dtype, int mean, int bags_per_block,
                         int prefetch_distance, void* stream) {
  if (batch <= 0 || num_tables <= 0 || dim <= 0) return cudaSuccess;
  const long long blocks = (batch + bags_per_block - 1) / bags_per_block;
  if (bags_per_block < 1 || bags_per_block > kMaxBagsPerBlock || num_tables > 65535 ||
      pooling < 0 || blocks > 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
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
  return cudaGetLastError();
}

const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
