// Exact maximum-inner-product search: the K best rows of a bf16 corpus for
// each of up to 32 float32 queries, in one pass over the rows and one merge
// (Hopper, sm_90a; f32 on the FFMA pipes, no tensor cores).
//
// Replaces no TPU kernel: the JAX package has no retrieval. It is HSTU's
// retrieval stage (Zhai et al., arXiv:2402.17152, §2.1 and §4): each user's
// query against every item row, the K largest scores kept. A library
// computes it only by writing every score (torch.mm on rows widened to f32,
// then torch.topk), U x R floats and twice the rows' bytes; here no score
// leaves the chip, and the bound is the rows' bytes, read once.
//
// The score. s(u, r) = fmaf over d = 0 .. dim - 1, in that order, of
// queries[u][d] and rows[r][d] widened to f32, from 0: one rounding a step,
// so the plain version (ref.py) reproduces it bit for bit in float64.
// -0 becomes +0. Order: score descending, then row ascending, as one
// 64-bit key a (score, row): the score's bits made monotone in the high
// word, ~row in the low word; keys of distinct rows never tie, so the
// K best are one set, whatever the order they are met in.
//
// The scan (mips_scan_kernel<Q>, Q = 16 or 32 queries held). A persistent
// block per SM walks tiles of 64 x 256 / Q rows (1,024 or 512; tile
// blockIdx.x, + gridDim.x, ...), each in stages of 16 dims: 32 bytes of
// each row, four stages deep. One thread loads a stage with the tensor
// memory accelerator (TMA: boxes of 256 rows x 16 dims, rows past the
// corpus zero-filled, each row's 256-byte line promoted into L2 so that
// its next stages come from L2), its completion counted on the stage's
// mbarrier, so the warps that score issue no copies; the map's 32-byte
// swizzle swaps the two 16-byte units of row r where (r >> 2) & 1, so
// that a quarter warp's 16-byte reads of 8 consecutive rows fall in 8
// distinct bank groups. (Copies issued by every thread, 16 bytes each,
// took about as long as the scoring and did not overlap it.) The queries
// sit in shared memory dim-major. A thread scores 8 rows (slot, slot + S,
// ..., slot + 7 S, S = the tile's rows / 8) against 8 queries (its warp's
// group, read by the whole warp at once): 64 FFMA a dim for 48 bytes read
// from shared memory. On an H100 at 700 W, at 16 queries and 50 M rows of
// 512, the scoring alone and the loads alone each take about 25 ms (49 %
// of the f32 peak; 2.0 TB/s) and overlap.
// After a tile's last stage each score is offered to its query's list:
// the block keeps, for each query, a list of keys in device memory
// (kListCap = 2048) and theta, the K-th best key of the list once it holds
// K; a key beats theta or is dropped. A list takes at most a tile's rows
// of keys a tile, so when fewer slots are left it is compacted: sorted
// (bitonic, in shared memory) and cut to its K best, theta their last.
// theta is the K-th best of the rows the block has met, so no dropped row
// can be among the K best of the corpus. At the end each list is cut to
// its sorted K best (fewer where the block met fewer rows) and its length
// written.
//
// The merge (mips_merge_kernel). One block a query runs through every
// block's list, kMergeKeys - K keys at a time beside the K best so far,
// sorts them (bitonic) and keeps the first K; the K best are written as
// row ids (int32) and scores (float32), best first.
//
// Plain-C interface, compiled into the port's one library (library.py);
// the two launches go on the caller's stream, do not synchronise and
// allocate nothing: the caller hands the lists ([max_grid][users][kListCap]
// u64) and their lengths ([max_grid][users] int32). Error codes are
// cudaError_t, read through embedding_bag_error_string.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;          // scan: 8 warps
constexpr int kRowsPerThread = 8;
constexpr int kQueriesPerThread = 8;
constexpr int kChunkDims = 16;         // dims a stage
constexpr int kChunkBytes = kChunkDims * 2;  // of one bf16 row: 2 units
constexpr int kStages = 4;
constexpr int kBoxRows = 256;          // rows of one TMA box
constexpr int kListCap = 2048;         // keys a (block, query) list
constexpr int kQueryBytes = 64 * 1024;  // the queries' shared memory, at most
constexpr int kMergeThreads = 1024;
constexpr int kMergeKeys = 8192;       // keys a merge sort
constexpr int kMaxK = 1024;

struct ScanParams {
  long long n_rows;      // the rows themselves are the kernel's tensor map
  int dim;               // a multiple of kChunkDims
  const float* queries;  // [users, dim]
  int users;
  int k;
  long long tiles;       // ceil(n_rows / Shape<Q>::kTileRows)
  unsigned long long* lists;  // [gridDim.x][users][kListCap]
  int* lengths;               // [gridDim.x][users]
};

struct MergeParams {
  const unsigned long long* lists;
  const int* lengths;
  int blocks;            // the scan's grid
  int users;
  int k;
  int* ids;              // [users, k]
  float* scores;         // [users, k]
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

// The producer's arrival: the phase completes when `bytes` have landed.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// One box of the map, at (dim, row), into shared memory at dst.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int dim, int row,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(dim), "r"(row),
      "r"(smem_addr(bar))
      : "memory");
}

// The key of (score, row): larger is better.
__device__ __forceinline__ unsigned long long make_key(float s,
                                                       long long row) {
  unsigned u = __float_as_uint(s + 0.0f);  // -0 -> +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xffffffffu - (unsigned)row);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_row(unsigned long long key) {
  return (int)(0xffffffffu - (unsigned)key);
}

// Sort buf[0, N) descending, N a power of two, by the whole block.
template <int N>
__device__ void bitonic_sort_desc(unsigned long long* buf) {
  for (int size = 2; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < N / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const unsigned long long a = buf[lo], b = buf[hi];
        if ((a < b) == desc) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Cut a list to its sorted K best (all of it where it holds fewer), by
// the whole block; theta becomes the K-th best once there are K.
__device__ void compact(unsigned long long* list, int* length,
                        unsigned long long* theta, int k,
                        unsigned long long* buf) {
  const int n = *length;
  for (int i = threadIdx.x; i < kListCap; i += blockDim.x)
    buf[i] = i < n ? list[i] : 0ull;
  __syncthreads();
  bitonic_sort_desc<kListCap>(buf);
  const int keep = min(n, k);
  for (int i = threadIdx.x; i < keep; i += blockDim.x) list[i] = buf[i];
  if (threadIdx.x == 0) {
    *length = keep;
    if (keep == k) *theta = buf[k - 1];
  }
  __syncthreads();
}

// The scan's shape for Q queries held: 8 queries a thread, Q / 8 groups
// of warps, each thread 8 rows of its group's S slots.
template <int Q>
struct Shape {
  static constexpr int kGroups = Q / kQueriesPerThread;
  static constexpr int kSlots = kThreads / kGroups;
  static constexpr int kTileRows = kSlots * kRowsPerThread;
  static constexpr int kStageBytes = kTileRows * kChunkBytes;
  static constexpr int kBoxes = kTileRows / kBoxRows;
  // stages (1,024-byte aligned for the swizzle), queries, the sort
  // buffer, the stages' mbarriers, theta and the lists' lengths; and the
  // slack to align the stages
  static size_t smem(int dim) {
    return 1024 + (size_t)kStages * kStageBytes + (size_t)dim * Q * 4 +
           (size_t)kListCap * 8 + kStages * 8 + Q * 8 + Q * 4;
  }
};

template <int Q>
__global__ void __launch_bounds__(kThreads, 1)
    mips_scan_kernel(const __grid_constant__ CUtensorMap rows_map,
                     const ScanParams p) {
  using S = Shape<Q>;
  constexpr int kSlots = S::kSlots, kTileRows = S::kTileRows;
  constexpr int kStageBytes = S::kStageBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* stages =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* qs = reinterpret_cast<float*>(stages + kStages * kStageBytes);
  unsigned long long* sortbuf =
      reinterpret_cast<unsigned long long*>(qs + p.dim * Q);
  unsigned long long* full = sortbuf + kListCap;  // a stage has landed
  unsigned long long* theta = full + kStages;
  int* length = reinterpret_cast<int*>(theta + Q);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // qs[d * Q + u] = queries[u][d]; queries past `users` are 0
  for (int i = tid; i < p.dim * Q; i += kThreads) {
    const int d = i / Q, u = i % Q;
    qs[i] = u < p.users ? p.queries[(long long)u * p.dim + d] : 0.f;
  }
  if (tid < Q) {
    theta[tid] = 0ull;  // below every key: the first K keys all pass
    length[tid] = 0;
  }
  unsigned long long* lists =
      p.lists + (long long)blockIdx.x * p.users * kListCap;

  const int chunks = p.dim / kChunkDims;
  const long long mine = (p.tiles - 1 - blockIdx.x) / gridDim.x + 1;
  const long long steps = mine * chunks;

  // stage s: tile blockIdx.x + (s / chunks) gridDim.x, dims of chunk
  // s % chunks, by thread 0 (its boxes: rows row0 + 256 b)
  const CUtensorMap* map = &rows_map;
  auto issue = [&](long long s) {
    const int at = (int)(s % kStages);
    unsigned char* dst = stages + at * kStageBytes;
    const int row0 =
        (int)((blockIdx.x + (s / chunks) * gridDim.x) * kTileRows);
    const int col = (int)(s % chunks) * kChunkDims;
    mbar_expect(&full[at], kStageBytes);
#pragma unroll
    for (int b = 0; b < S::kBoxes; ++b)
      tma_load_2d(dst + b * kBoxRows * kChunkBytes, map, col,
                  row0 + b * kBoxRows, &full[at]);
  };

  // this thread: queries g * 8 .. g * 8 + 7 and rows slot + i * kSlots
  const int g = tid / kSlots, slot = tid % kSlots;
  const int swz = (slot >> 2) & 1;  // kSlots is a multiple of 8
  float acc[kRowsPerThread][kQueriesPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kQueriesPerThread; ++j) acc[i][j] = 0.f;

  __syncthreads();  // the queries, the barriers and the lists' state
  if (tid == 0)
    for (int s = 0; s < kStages - 1 && s < steps; ++s) issue(s);
  for (long long s = 0; s < steps; ++s) {
    __syncthreads();  // stage s - 1 is read by every thread: refill it
    if (tid == 0 && s + kStages - 1 < steps) issue(s + kStages - 1);
    mbar_wait(&full[s % kStages], (unsigned)((s / kStages) & 1));
    const unsigned char* st = stages + (int)(s % kStages) * kStageBytes;
    const int chunk = (int)(s % chunks);
    const float* qc = qs + chunk * kChunkDims * Q + g * kQueriesPerThread;
#pragma unroll
    for (int unit = 0; unit < 2; ++unit) {
      uint4 w[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        w[i] = *reinterpret_cast<const uint4*>(
            st + (slot + i * kSlots) * kChunkBytes + ((unit ^ swz) << 4));
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float* qd = qc + (unit * 8 + e) * Q;
        const float4 qa = *reinterpret_cast<const float4*>(qd);
        const float4 qb = *reinterpret_cast<const float4*>(qd + 4);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const unsigned word = e < 2 ? w[i].x
                                : e < 4 ? w[i].y
                                : e < 6 ? w[i].z
                                        : w[i].w;
          // element e of the unit: the low half of its word, then the high
          const float x = __uint_as_float((e & 1) ? (word & 0xffff0000u)
                                                  : (word << 16));
          acc[i][0] = fmaf(qa.x, x, acc[i][0]);
          acc[i][1] = fmaf(qa.y, x, acc[i][1]);
          acc[i][2] = fmaf(qa.z, x, acc[i][2]);
          acc[i][3] = fmaf(qa.w, x, acc[i][3]);
          acc[i][4] = fmaf(qb.x, x, acc[i][4]);
          acc[i][5] = fmaf(qb.y, x, acc[i][5]);
          acc[i][6] = fmaf(qb.z, x, acc[i][6]);
          acc[i][7] = fmaf(qb.w, x, acc[i][7]);
        }
      }
    }
    if (chunk != chunks - 1) continue;

    // the tile is scored: offer each score to its query's list
    const long long row0 =
        (blockIdx.x + (s / chunks) * gridDim.x) * kTileRows + slot;
#pragma unroll
    for (int j = 0; j < kQueriesPerThread; ++j) {
      const int u = g * kQueriesPerThread + j;
      if (u < p.users) {
        unsigned long long* list = lists + (long long)u * kListCap;
        const unsigned long long th = theta[u];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const long long row = row0 + i * kSlots;
          const unsigned long long key = make_key(acc[i][j], row);
          if (row < p.n_rows && key > th)
            list[atomicAdd(&length[u], 1)] = key;
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) acc[i][j] = 0.f;
    }
    __syncthreads();  // the lists and their lengths are complete
    for (int u = 0; u < p.users; ++u)
      if (length[u] > kListCap - kTileRows)  // uniform across the block
        compact(lists + (long long)u * kListCap, &length[u], &theta[u], p.k,
                sortbuf);
  }
  __syncthreads();
  for (int u = 0; u < p.users; ++u) {
    compact(lists + (long long)u * kListCap, &length[u], &theta[u], p.k,
            sortbuf);
    if (tid == 0) p.lengths[(long long)blockIdx.x * p.users + u] = length[u];
  }
}

__global__ void __launch_bounds__(kMergeThreads)
    mips_merge_kernel(const MergeParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(smem);
  const int u = blockIdx.x, k = p.k;
  // slot b * k + i: key i of block b's list (0 past its length)
  const long long total = (long long)p.blocks * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) buf[i] = 0ull;
  for (long long base = 0; base < total; base += kMergeKeys - k) {
    for (int i = threadIdx.x; i < kMergeKeys - k; i += blockDim.x) {
      const long long slot = base + i;
      unsigned long long key = 0ull;
      if (slot < total) {
        const long long b = slot / k;
        const int at = (int)(slot - b * k);
        const long long list = b * p.users + u;
        if (at < p.lengths[list]) key = p.lists[list * kListCap + at];
      }
      buf[k + i] = key;
    }
    __syncthreads();
    bitonic_sort_desc<kMergeKeys>(buf);
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    p.ids[(long long)u * k + i] = key_row(buf[i]);
    p.scores[(long long)u * k + i] = key_score(buf[i]);
  }
}

// What was launched last, for mips_topk_last_launch_info.
struct Record {
  const void* fn = nullptr;
  size_t smem = 0;
  int threads = 0;
  int queries = 0;
  int grid = 0;
};
Record g_last;
std::mutex g_mutex;

// cuTensorMapEncodeTiled, from the driver through the runtime (the
// library links no driver library).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
EncodeTiled g_encode = nullptr;

// The corpus [n_rows, dim] bf16 as boxes of 256 rows x 16 dims.
cudaError_t encode_rows(CUtensorMap* map, const void* rows, long long n_rows,
                        int dim) {
  if (!g_encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorNotSupported;
    g_encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t size[2] = {(cuuint64_t)dim, (cuuint64_t)n_rows};
  const cuuint64_t stride[1] = {(cuuint64_t)dim * 2};
  const cuuint32_t box[2] = {kChunkDims, kBoxRows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = g_encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(rows), size,
      stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int Q>
int launch_scan(const CUtensorMap& map, const ScanParams& p, int grid,
                cudaStream_t stream) {
  const size_t smem = Shape<Q>::smem(p.dim);
  auto fn = mips_scan_kernel<Q>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  g_last = {reinterpret_cast<const void*>(fn), smem, kThreads, Q, grid};
  fn<<<grid, kThreads, smem, stream>>>(map, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched). The K = k best rows of `rows` for
// each query, best first: ids [users, k] int32, scores [users, k] float32.
// lists: [max_grid][users][2048] u64 and lengths: [max_grid][users] int32,
// scratch the scan fills and the merge reads; the scan takes max_grid
// blocks, or one a tile where the corpus has fewer tiles (of 1,024 rows
// for up to 16 users, 512 for more).
int mips_topk_launch(const float* queries, int users, int dim,
                     const void* rows, long long n_rows, int k, void* lists,
                     void* lengths, int max_grid, int* ids, float* scores,
                     void* stream) {
  const int q = users <= 16 ? 16 : 32;
  const long long tile_rows =
      q == 16 ? Shape<16>::kTileRows : Shape<32>::kTileRows;
  const long long tiles = (n_rows + tile_rows - 1) / tile_rows;
  if (users < 1 || users > 32 || dim < kChunkDims || dim % kChunkDims ||
      (long long)dim * q * 4 > kQueryBytes || k < 1 || k > kMaxK ||
      n_rows < k || n_rows > 0x7fffffffLL || max_grid < 1 ||
      (reinterpret_cast<uintptr_t>(rows) & 15u))
    return cudaErrorInvalidValue;
  const int grid = (int)(tiles < max_grid ? tiles : max_grid);
  const ScanParams sp{n_rows,
                      dim,
                      queries,
                      users,
                      k,
                      tiles,
                      static_cast<unsigned long long*>(lists),
                      static_cast<int*>(lengths)};
  const auto s = static_cast<cudaStream_t>(stream);
  std::lock_guard<std::mutex> hold(g_mutex);
  CUtensorMap map;
  int err = encode_rows(&map, rows, n_rows, dim);
  if (err != cudaSuccess) return err;
  err = q == 16 ? launch_scan<16>(map, sp, grid, s)
                : launch_scan<32>(map, sp, grid, s);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)kMergeKeys * 8;
  err = cudaFuncSetAttribute(mips_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const MergeParams mp{static_cast<const unsigned long long*>(lists),
                       static_cast<const int*>(lengths),
                       grid,
                       users,
                       k,
                       ids,
                       scores};
  mips_merge_kernel<<<users, kMergeThreads, smem, s>>>(mp);
  return cudaGetLastError();
}

// out[0..6] = registers per thread, resident blocks per SM, local (spill)
// bytes per thread, static shared bytes, dynamic shared bytes, queries
// held (16 or 32), blocks launched; of the scan launched last.
int mips_topk_last_launch_info(int* out) {
  std::lock_guard<std::mutex> hold(g_mutex);
  if (!g_last.fn) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, g_last.fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, g_last.fn, g_last.threads, g_last.smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = blocks;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = (int)g_last.smem;
  out[5] = g_last.queries;
  out[6] = g_last.grid;
  return cudaSuccess;
}

}  // extern "C"
