// DLRM's dot interaction for Hopper (sm_90a), one launch a batch:
//   z[b] = [x_0 | <x_i, x_j> for 0 <= i < j < F, in row-major order]
// where x_0 = bottom_out[b] (the bottom MLP's output) and x_1..x_{F-1} =
// pooled[b] (the embedding bags), each D wide. z is the top MLP's input
// [B, D + F(F-1)/2], the pairs in torch.triu_indices(F, F, 1) order, as
// jnp.triu_indices.
//
// It replaces no TPU kernel: repro/models/dlrm.py DLRM._interact is plain
// jnp (a concatenate, an einsum and a triu gather), and the port first ran
// it as four library calls: a cat, a cuBLAS bmm over all F x F products
// (the Gram matrix), a gather of its upper triangle and a second cat. At
// the serve shape (B = 2048, F = 251, D = 128, f32) that took 1.64-1.72 ms
// a batch on an NVIDIA H100 80GB HBM3 at 700 W, about 15 % of the layer's
// bound (PERF.md): half of the products fell below the diagonal, and the
// 516 MB Gram matrix, the 263 MB concatenation and the gathered pairs went
// through device memory only to be read back.
//
// What bounds it on an H100. C(251, 2) = 31,375 pairs of 2D - 1 = 255 FLOP
// a sample is 16.4 GFLOP a batch: 0.246 ms at the 67 TFLOP/s of f32 FMAs
// outside the tensor cores. Each input row read once (263 MB) and each
// output row written once (258 MB) take 0.156 ms at 3.35 TB/s. So f32 FMAs
// bound it, and the design spends the instruction slots on them:
//  * full f32 FMAs on the CUDA cores, summed in order of d (no TF32, 3xTF32
//    or bf16 tensor-core products: those are a different result);
//  * one block a sample at a time, persistent over the batch. A thread owns
//    a tile of 8 rows i x 12 columns j of pairs, its 96 sums in registers,
//    as an SGEMM micro-kernel: every 4 columns of D it reads 8 + 12 16-byte
//    vectors from shared memory for 384 FMAs. Only tiles that hold a pair
//    i < j are computed (F = 251: 352 tiles, 93 % of their products are
//    pairs), one a thread, in row-major order;
//  * a block is at most 12 warps: 3 a scheduler, at 168 registers a thread,
//    hold the 96 sums and both operand vectors without spilling (17 warps
//    of 8 x 8 tiles were capped at 96 registers and spilled). F = 251 takes
//    11 warps and one pass; a larger F takes more passes over its rows;
//  * the sample is walked along D in chunks of 64 columns, all F rows at
//    once, through two stages, one filled while the other is read, by bulk
//    copies (the TMA unit: one instruction a row's 256 bytes, counted on
//    the stage's mbarrier; 16-byte cp.async copies cost 0.04 ms more), so
//    loads overlap the FMAs and the next sample's first chunk loads under
//    this one's last. A stage keeps the rows row-major with one spare slot
//    a row and one every 4 rows, so that the 12-row tiles of 8 consecutive
//    lanes start in 8 different bank groups;
//  * each warp writes its sums through 1.5 KB of shared memory, one tile
//    row at a time, so that a store instruction writes 32 consecutive pair
//    columns (z's row stride is odd, so rows are only 4-byte aligned);
//  * small F (F <= 32, such as F = 9, D = 64, 36 pairs) leaves these tiles
//    mostly idle, and device memory bounds it instead: there one warp takes
//    a sample, holds its rows in shared memory and gives each lane its
//    pairs, 8 samples a block. The path is picked from F and D alone.
// Both paths take float32 or bfloat16, accumulate in f32 and store in the
// input type; rows that are not 16-byte aligned (or bf16) are loaded
// element by element instead of by bulk copies. x_0 is copied into z
// unchanged.
//
// Plain-C interface, built into the port's one shared library and called from
// Python through ctypes (kernel.py). The launch goes on the caller's stream,
// does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kRows = 8;             // rows i of a thread's tile of pairs
constexpr int kCols = 12;            // columns j of a thread's tile
constexpr int kMaxThreads = 384;     // 12 warps: 3 a scheduler, 168 registers
constexpr int kStages = 2;           // chunks in flight
constexpr int kScratchFloats = 32 * kCols;  // a warp's staging, one tile row
constexpr int kSmallMaxF = 32;       // the one-warp-a-sample path
constexpr int kSmallWarps = 8;       // samples a block on that path
constexpr int kSmallBlockBytes = 48 * 1024;
constexpr int kMaxFeatures = 1024;   // kernel.py MAX_FEATURES

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One-dimensional bulk copies (the TMA unit) that report their bytes to an
// mbarrier in shared memory, and the barrier's init, arrival and wait.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct Params {
  const void* bottom;  // [B, D] contiguous: x_0 of each sample
  const void* pooled;  // [B, F - 1, D] contiguous: x_1 .. x_{F-1}
  void* out;           // [B, D + F(F-1)/2] contiguous
  long long batch;     // B
  int features;        // F
  int dim;             // D
};

// Column of pair (i, j), i < j, in z's row.
__device__ __forceinline__ long long pair_col(int i, int j, int F, int D) {
  return D + (long long)i * (2 * F - i - 1) / 2 + (j - i - 1);
}

// ---------------------------------------------------------------- tiled --

// Shape of a tiled launch, fixed for the whole batch.
struct Tiling {
  int row_tiles;    // tiles of 8 rows i that pair with a later row
  int col_tiles;    // tiles of 12 columns j: ceil(F / 12)
  int items;        // (row tile, column tile) pairs holding a pair i < j
  int rows;         // rows a stage holds: those of every tile
  int chunks;       // ceil(D / KC)
  int passes;       // ceil(items / threads)
};

// The first column tile that holds a pair with row tile I: its last column
// 12 J + 11 must pass the tile's first row 8 I.
__host__ __device__ __forceinline__ int first_col_tile(int I) {
  const int need = kRows * I - (kCols - 2);
  return need > 0 ? (need + kCols - 1) / kCols : 0;
}

// A stage holds a chunk of KC columns of every row, row-major in 16-byte
// slots: row r's KC / 4 slots start at slot r (KC / 4 + 1) + r / 4. The
// spare slot a row and a spare slot every 4 rows put the 12-row tiles of 8
// consecutive column tiles (J = j .. j + 7, rows 12 J + s) in 8 different
// bank groups, and keep each tile's rows at fixed offsets from its first.
template <int KC>
__host__ __device__ __forceinline__ int row_slot(int r) {
  return r * (KC / 4 + 1) + r / 4;
}

// A block's position in its walk over (sample, pass, chunk), and the stage
// that chunk goes to.
struct Walk {
  long long b;
  int pass, chunk, stage;
};

template <typename T, int KC, bool BULK>
__global__ void __launch_bounds__(kMaxThreads, 1)
    tiled_kernel(const Params p, const Tiling g) {
  constexpr int kSlots = KC / 4;              // 16-byte slots of a row
  constexpr int kShift = KC == 64 ? 4 : KC == 32 ? 3 : KC == 16 ? 2 : KC == 8 ? 1 : 0;
  static_assert(kSlots == 1 << kShift, "KC is 4, 8, 16, 32 or 64");
  extern __shared__ __align__(16) float4 smem[];
  const int F = p.features, D = p.dim;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31;
  const int stage_slots = row_slot<KC>(g.rows);
  float* scratch = reinterpret_cast<float*>(smem + kStages * stage_slots) +
                   (tid >> 5) * kScratchFloats;
  const long long ld = D + (long long)F * (F - 1) / 2;

  // Rows F .. of the tiles are never loaded: zero them in every stage once,
  // so that their products are finite (they are never stored).
  const int pad = (g.rows - F) * kSlots;
  for (int q = tid; q < kStages * pad; q += nthreads) {
    const int r = F + (q % pad) / kSlots;
    smem[(q / pad) * stage_slots + row_slot<KC>(r) + q % kSlots] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // Where each stage's bulk copies report their bytes, and the parity of
  // the phase each stage waits for next (bit s for stage s).
  __shared__ unsigned long long landed[kStages];
  unsigned parity = 0;
  if constexpr (BULK) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&landed[s]);
      mbar_fence_init();
    }
    __syncthreads();
  }

  // Chunk w.chunk of pass w.pass over sample w.b into stage w.stage. With
  // BULK, one bulk copy a row (4 KC contiguous bytes), counted on the
  // stage's mbarrier; else element by element, 4 columns a thread at a
  // time, zero past D.
  auto fetch = [&](const Walk& w) {
    if (w.b >= p.batch) return;
    const int k0 = w.chunk * KC;
    const T* x0 = static_cast<const T*>(p.bottom) + w.b * D;
    const T* xs = static_cast<const T*>(p.pooled) + w.b * (F - 1) * D;
    float4* dst = smem + w.stage * stage_slots;
    if constexpr (BULK) {
      const unsigned bytes = 4u * min(KC, D - k0);
      fence_async_smem();  // after this stage's reads by the last chunk
      if (tid == 0) mbar_expect(&landed[w.stage], bytes * F);
      for (int r = tid; r < F; r += nthreads)
        bulk_copy(dst + row_slot<KC>(r),
                  (r == 0 ? x0 : xs + (long long)(r - 1) * D) + k0, bytes,
                  &landed[w.stage]);
    } else {
      for (int q = tid; q < F << kShift; q += nthreads) {
        const int r = q >> kShift;
        const int k = k0 + 4 * (q & (kSlots - 1));
        if (k >= D) continue;
        const T* src = (r == 0 ? x0 : xs + (long long)(r - 1) * D) + k;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = k + e < D ? to_float(src[e]) : 0.f;
        dst[row_slot<KC>(r) + (q & (kSlots - 1))] =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  // The next position of the block's walk: chunks within a pass, passes
  // within a sample, samples gridDim.x apart; stages in turn.
  auto advance = [&](Walk& w) {
    if (++w.chunk == g.chunks) {
      w.chunk = 0;
      if (++w.pass == g.passes) {
        w.pass = 0;
        w.b += gridDim.x;
      }
    }
    if (++w.stage == kStages) w.stage = 0;
  };

  Walk cur{blockIdx.x, 0, 0, 0}, ahead = cur;
  for (int s = 0; s < kStages - 1; ++s) {
    fetch(ahead);
    advance(ahead);
  }

  float acc[kRows][kCols];
  int tile_i = 0, tile_j = 0, tile_pass = -1;
  bool active = false;
  for (; cur.b < p.batch; advance(cur)) {
    // every thread is done with the chunk before `cur`, whose stage the
    // copies of chunk `ahead` reuse; then chunk `cur` has landed
    __syncthreads();
    fetch(ahead);
    advance(ahead);
    if constexpr (BULK) {
      mbar_wait(&landed[cur.stage], (parity >> cur.stage) & 1u);
      parity ^= 1u << cur.stage;
    }

    const int c = cur.chunk;
    if (c == 0) {
      if (cur.pass != tile_pass) {
        // this thread's tile in the pass, row-major over the row tiles
        int rem = cur.pass * nthreads + tid;
        active = rem < g.items;
        int i = 0;
        while (active && rem >= g.col_tiles - first_col_tile(i))
          rem -= g.col_tiles - first_col_tile(i++);
        tile_i = i;
        tile_j = first_col_tile(i) + rem;
        tile_pass = cur.pass;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int s = 0; s < kCols; ++s) acc[r][s] = 0.f;
    }
    if (active) {
      const float4* stage = smem + cur.stage * stage_slots;
      const float4* A = stage + row_slot<KC>(kRows * tile_i);
      const float4* B = stage + row_slot<KC>(kCols * tile_j);
      const int groups = (min(KC, D - c * KC) + 3) / 4;
#pragma unroll 1
      for (int q = 0; q < groups; ++q, ++A, ++B) {
        float4 a[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) a[r] = A[row_slot<KC>(r)];
#pragma unroll
        for (int s = 0; s < kCols; ++s) {
          const float4 bv = B[row_slot<KC>(s)];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r][s] = fmaf(a[r].x, bv.x, acc[r][s]);
            acc[r][s] = fmaf(a[r].y, bv.y, acc[r][s]);
            acc[r][s] = fmaf(a[r].z, bv.z, acc[r][s]);
            acc[r][s] = fmaf(a[r].w, bv.w, acc[r][s]);
          }
        }
      }
    }
    if (c != g.chunks - 1) continue;

    // the pass is summed: write it out, one tile row at a time through this
    // warp's scratch; lane l stores element e = l + 32 m of the 32 x 12
    // block, column j = 12 J + e % 12 of the tile (I, J) of lane e / 12, for
    // rows i = 8 I + r below j; its column in z moves by F - i - 2 from row
    // i to i + 1
    T* out = static_cast<T*>(p.out) + cur.b * ld;
    if (cur.pass == 0) {
      const T* x0 = static_cast<const T*>(p.bottom) + cur.b * D;
      for (int k = tid; k < D; k += nthreads) out[k] = x0[k];
    }
    const int mine = active ? (tile_i << 16) | tile_j : -1;
    int owner[kCols], pcol[kCols];
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      const int e = 32 * m + lane;
      const int o = __shfl_sync(0xffffffffu, mine, e / kCols);
      const int j = kCols * (o & 0xffff) + e % kCols;
      // row i of the pair and its column j, packed; -1 where there is none
      owner[m] = o >= 0 && j < F ? (kRows * (o >> 16)) << 16 | j : -1;
      pcol[m] = (int)pair_col(kRows * (o >> 16), j, F, D);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float4* w = reinterpret_cast<float4*>(scratch + kCols * lane);
#pragma unroll
      for (int v = 0; v < kCols / 4; ++v)
        w[v] = make_float4(acc[r][4 * v], acc[r][4 * v + 1],
                           acc[r][4 * v + 2], acc[r][4 * v + 3]);
      __syncwarp();
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        const int i = (owner[m] >> 16) + r;
        if (owner[m] >= 0 && i < (owner[m] & 0xffff))
          out[pcol[m]] = from_float<T>(scratch[32 * m + lane]);
        pcol[m] += F - i - 2;
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------- small --

// One warp a sample: its F rows in shared memory at an odd row stride (so
// the lanes' rows fall in different banks), each lane the pairs
// lane, lane + 32, ...
template <typename T>
__global__ void __launch_bounds__(32 * kSmallWarps)
    small_kernel(const Params p, int stride) {
  extern __shared__ float rows[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kSmallWarps + warp;
  if (b >= p.batch) return;  // uniform across the warp
  const int F = p.features, D = p.dim;
  const long long ld = D + (long long)F * (F - 1) / 2;
  float* x = rows + warp * F * stride;
  T* out = static_cast<T*>(p.out) + b * ld;
  const T* x0 = static_cast<const T*>(p.bottom) + b * D;
  for (int k = lane; k < D; k += 32) {
    const T v = x0[k];
    out[k] = v;
    x[k] = to_float(v);
  }
  const T* xs = static_cast<const T*>(p.pooled) + b * (F - 1) * D;
  for (int r = 1; r < F; ++r)
    for (int k = lane; k < D; k += 32)
      x[r * stride + k] = to_float(xs[(r - 1) * D + k]);
  __syncwarp();
  const int pairs = F * (F - 1) / 2;
  for (int q = lane; q < pairs; q += 32) {
    int i = 0, rem = q;
    while (rem >= F - 1 - i) rem -= F - 1 - i++;
    const float* xi = x + i * stride;
    const float* xj = x + (i + 1 + rem) * stride;
    float sum = 0.f;
#pragma unroll 4
    for (int k = 0; k < D; ++k) sum = fmaf(xi[k], xj[k], sum);
    out[D + q] = from_float<T>(sum);
  }
}

// ------------------------------------------------------------------ host --

struct LaunchRecord {
  const void* fn = nullptr;
  int threads = 0;
  size_t smem = 0;
  int path = 0;   // 0 small, 1 tiled
  int chunk = 0;  // columns of D a chunk
  int passes = 0;
  int grid = 0;
};
LaunchRecord g_last;
std::mutex g_mutex;  // guards g_last

// Blocks of `fn` the device holds at once: the persistent grid.
cudaError_t resident_blocks(const void* fn, int threads, size_t smem,
                            int* out) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  return cudaSuccess;
}

template <typename... KArgs, typename... Args>
int launch(void (*fn)(KArgs...), int grid, int threads, size_t smem,
           cudaStream_t stream, const Args&... args) {
  fn<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T>
int launch_small(const Params& p, cudaStream_t stream) {
  const int stride = p.dim | 1;
  const size_t smem = (size_t)kSmallWarps * p.features * stride * 4;
  const long long blocks = (p.batch + kSmallWarps - 1) / kSmallWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  g_last = {reinterpret_cast<const void*>(small_kernel<T>),
            32 * kSmallWarps, smem, 0, 0, 1, (int)blocks};
  return launch(small_kernel<T>, (int)blocks, 32 * kSmallWarps, smem, stream,
                p, stride);
}

template <typename T, int KC, bool BULK>
int launch_tiled(const Params& p, const Tiling& g, int threads, size_t smem,
                 cudaStream_t stream) {
  const auto fn = tiled_kernel<T, KC, BULK>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int resident = 0;
  const cudaError_t err = resident_blocks(
      reinterpret_cast<const void*>(fn), threads, smem, &resident);
  if (err != cudaSuccess) return err;
  const int grid = (int)(p.batch < resident ? p.batch : resident);
  g_last = {reinterpret_cast<const void*>(fn), threads, smem, 1, KC,
            g.passes, grid};
  return launch(fn, grid, threads, smem, stream, p, g);
}

// The tiled path: 64 columns of D a chunk where two such stages fit in
// shared memory (F up to about 370), else 8.
template <typename T>
int launch_tiled(const Params& p, cudaStream_t stream) {
  Tiling g;
  g.row_tiles = (p.features - 1 + kRows - 1) / kRows;
  g.col_tiles = (p.features + kCols - 1) / kCols;
  g.items = 0;
  for (int i = 0; i < g.row_tiles; ++i)
    g.items += g.col_tiles - first_col_tile(i);
  g.rows = max(kRows * g.row_tiles, kCols * g.col_tiles);
  const int threads = min(kMaxThreads, max(32, (g.items + 31) / 32 * 32));
  g.passes = max(1, (g.items + threads - 1) / threads);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  const size_t scratch = (size_t)(threads / 32) * kScratchFloats * 4;
  const size_t wide = (size_t)kStages * row_slot<64>(g.rows) * 16 + scratch;
  const size_t narrow = (size_t)kStages * row_slot<8>(g.rows) * 16 + scratch;
  const bool bulk = sizeof(T) == 4 && p.dim % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(p.bottom) & 15u) == 0 &&
                    (reinterpret_cast<uintptr_t>(p.pooled) & 15u) == 0;
  // (the stages' mbarriers take a few static bytes beside them)
  if (wide + 64 <= (size_t)optin) {
    g.chunks = (p.dim + 63) / 64;
    return bulk ? launch_tiled<T, 64, true>(p, g, threads, wide, stream)
                : launch_tiled<T, 64, false>(p, g, threads, wide, stream);
  }
  if (narrow + 64 > (size_t)optin) return cudaErrorInvalidValue;
  g.chunks = (p.dim + 7) / 8;
  return bulk ? launch_tiled<T, 8, true>(p, g, threads, narrow, stream)
              : launch_tiled<T, 8, false>(p, g, threads, narrow, stream);
}

template <typename T>
int launch_dtype(const Params& p, cudaStream_t stream) {
  const int stride = p.dim | 1;
  if (p.features <= kSmallMaxF &&
      (size_t)kSmallWarps * p.features * stride * 4 <= kSmallBlockBytes)
    return launch_small<T>(p, stream);
  return launch_tiled<T>(p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int dot_interaction_launch(const void* bottom, const void* pooled, void* out,
                           long long batch, int features, int dim, int dtype,
                           void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (features < 1 || features > kMaxFeatures || dim < 1 ||
      dim + (long long)features * (features - 1) / 2 > 0x7fffffffLL ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const Params p{bottom, pooled, out, batch, features, dim};
  const auto s = static_cast<cudaStream_t>(stream);
  std::lock_guard<std::mutex> hold(g_mutex);
  return dtype == 0 ? launch_dtype<float>(p, s)
                    : launch_dtype<__nv_bfloat16>(p, s);
}

// out[0..9] = registers per thread, resident blocks per SM, local (spill)
// bytes per thread, static shared bytes, threads a block, dynamic shared
// bytes, path (0 one warp a sample, 1 tiled), columns of D a chunk, passes
// a sample, blocks launched.
int dot_interaction_last_launch_info(int* out) {
  std::lock_guard<std::mutex> hold(g_mutex);
  if (!g_last.fn) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, g_last.fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, g_last.fn,
                                                      g_last.threads,
                                                      g_last.smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = blocks;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = g_last.threads;
  out[5] = (int)g_last.smem;
  out[6] = g_last.path;
  out[7] = g_last.chunk;
  out[8] = g_last.passes;
  out[9] = g_last.grid;
  return cudaSuccess;
}

}  // extern "C"
