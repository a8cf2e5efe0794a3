// HSTU's pointwise attention over jagged user sequences, one launch a layer,
// and the time codes its layers read, one launch a forward (Hopper, sm_90a;
// f32 on the FFMA pipes, no tensor cores).
//
// Replaces no TPU kernel: the JAX package has no HSTU. The operator is that
// of Zhai et al., "Actions Speak Louder than Words" (arXiv:2402.17152, §3):
// for each user, head and query token i of the user's sequence,
//
//   out_i = sum_j  SiLU(alpha * q_i . k_j + rab(i, j)) / N * mask(i, j) * v_j
//   rab(i, j) = p[j - i + N - 1] + w[bucket(|t_i - t_j|)]
//
// with N the configured longest sequence, p and w shared by the heads, and
// bucket(x) = clamp(floor(ln(max(x, 1)) / 0.301), 0, B) taken from
// `thresholds`: thresholds[b] is the least integer x with bucket(x) >= b
// (thresholds[0] = 0), computed once on the host, so that the card and the
// plain version put every integer |dt| in the same bucket. There is no
// softmax: each pair's weight is final as soon as it is computed, so the
// kernel keeps no running maximum and rescales nothing.
//
// The mask. A user's sequence is n_h history tokens, then m candidates.
// A history token sees the history tokens up to itself (causal); a
// candidate sees the whole history and itself, and no other candidate.
//
// Layout. Token rows live in two regions: every user's history tokens in
// user order (user u's at [hist_offsets[u], hist_offsets[u + 1])), then,
// from row hist_total, every user's candidates in user order (user u's at
// hist_total + [cand_offsets[u], cand_offsets[u + 1])). q, k and v are
// [rows, heads * D] column blocks of one buffer with a row stride of `ld`
// floats; out is [rows, heads * D] with a row stride of out_ld.
//
// Time codes. The bucket and the mask depend on neither the head nor the
// layer, so hstu_time_codes_kernel computes them once a forward, one byte
// a pair: bucket(|t_i - t_j|) where the mask lets the pair in, and kMasked
// (255) where it keeps the pair out or where i or j lies past the user's
// end; so B is at most 254. A user of n tokens has T = ceil(n / 64) query
// tiles, and its codes are the lower triangle of 64 x 64 tiles: tile (a,
// b), b <= a, is code tile base(u) + a (a + 1) / 2 + b, where base(u) sums
// the triangles of the users before u (code_base, from the offsets on the
// card). Inside a tile the codes are thread-major: the 16 codes of thread
// t = 16 ty + tx (rows ty + 16 r, columns tx + 16 c) are bytes 16 t + 4 r
// + c, so a thread fetches its codes of a tile in one 16-byte load.
//
// The work. A block takes one (user, head, tile of 64 queries) and walks
// the key tiles of 64 from the sequence's start to its own diagonal,
// skipping the tiles of candidates that are not its own, which the mask
// leaves empty. Per key tile: K and V are copied into shared memory
// (cp.async, rows past the sequence's end zero-filled; V lands while S
// is computed) and the thread's 16 codes are loaded, S = Q K^T is
// register-tiled (4 x 4 pairs a thread, 16-byte shared loads along d), the
// bias gather by the codes, SiLU, 1/N and the mask are applied in
// registers, A is written over K's shared memory, and O += A V (4 rows x
// D/16 columns a thread). Q stays in shared memory for the whole walk.
// About 100 KB of shared memory a block at D = 128, so two blocks share an
// SM and overlap one's copies with the other's arithmetic.
//
// Balance. The work of a query tile grows with its index, and the users of
// one batch differ 16-fold in length. The grid is one-dimensional, in the
// order (tile from the last, user, head), so the longest tiles of every
// user start first and short ones fill the SMs as they drain; a block whose
// tile lies past its user's end returns at once.
//
// Plain-C interface, compiled into the port's one library (library.py);
// the launches go on the caller's stream, do not synchronise and allocate
// nothing. Error codes are cudaError_t, read through
// embedding_bag_error_string.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <mutex>

namespace {

constexpr int kBM = 64;        // queries a block
constexpr int kBN = 64;        // keys a tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPad = 4;        // floats after each Q and K row in shared memory
constexpr int kMasked = 255;   // the code of a pair the mask keeps out
constexpr int kTileCodes = kBM * kBN / 16;  // uint4s of codes a tile
constexpr float kLog2ToBucket = 0.69314718055994531f / 0.301f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  long long ld;                 // floats between rows of q, k and v
  const int* hist_offsets;      // [users + 1]
  const int* cand_offsets;      // [users + 1]
  int users;
  long long hist_total;         // rows of the history region
  const uint4* codes;           // the forward's time codes
  const float* pos_bias;        // [2N - 1]
  const float* time_bias;       // [buckets + 1]
  int buckets;
  float* out;
  long long out_ld;
  int heads;
  int max_seq_len;              // N
  int max_tiles;                // query tiles of the longest user
  float alpha;
  float inv_n;
};

struct CodeParams {
  const int* hist_offsets;      // [users + 1]
  const int* cand_offsets;      // [users + 1]
  int users;
  long long hist_total;
  const long long* times;       // [rows]
  const long long* thresholds;  // [buckets + 1]
  int buckets;
  uint4* codes;                 // [tiles * kTileCodes]
};

template <int D>
struct Smem {
  static constexpr int kQStride = D + kPad;
  static constexpr int kAStride = kBN + kPad;
  static constexpr size_t kQ = (size_t)kBM * kQStride * 4;
  static constexpr size_t kK = (size_t)kBN * kQStride * 4;  // K, then A
  static constexpr size_t kV = (size_t)kBN * D * 4;
  static constexpr size_t kPos = 128 * 4;
  static size_t bytes(int buckets) {
    return kQ + kK + kV + kPos + (size_t)(buckets + 1) * 4;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int size = valid ? 16 : 0;  // 0: zero-fill the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The row of local token r of a user: history first, then candidates.
__device__ __forceinline__ long long row_of(int r, int n_h, long long hist0,
                                            long long cand0) {
  return r < n_h ? hist0 + r : cand0 + (r - n_h);
}

// Query tiles of user u: ceil(n / 64).
__device__ __forceinline__ int user_tiles(const int* hist_offsets,
                                          const int* cand_offsets, int u) {
  const int n = hist_offsets[u + 1] - hist_offsets[u] + cand_offsets[u + 1] -
                cand_offsets[u];
  return (n + kBM - 1) / kBM;
}

// Code tiles of user u: its triangle of query tiles.
__device__ __forceinline__ long long user_triangle(const int* hist_offsets,
                                                   const int* cand_offsets,
                                                   int u) {
  const long long t = user_tiles(hist_offsets, cand_offsets, u);
  return t * (t + 1) / 2;
}

// The first code tile of user u: the triangles of the users before it,
// summed by the calling warp (all 32 lanes call; each gets the sum).
__device__ __forceinline__ long long code_base(const int* hist_offsets,
                                               const int* cand_offsets,
                                               int u) {
  long long base = 0;
  for (int v = threadIdx.x & 31; v < u; v += 32)
    base += user_triangle(hist_offsets, cand_offsets, v);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) base += __shfl_xor_sync(~0u, base, o);
  return base;
}

// The user whose triangle holds code tile `tile`, and the user's first
// code tile in *base; `users` if the tile lies past the layout. By the
// calling warp (all 32 lanes call; each gets the answer): an inclusive
// scan of 32 users' triangles at a time.
__device__ __forceinline__ int find_user(const int* hist_offsets,
                                         const int* cand_offsets, int users,
                                         long long tile, long long* base) {
  const int lane = threadIdx.x & 31;
  long long run = 0;
  for (int u0 = 0; u0 < users; u0 += 32) {
    const long long tri =
        u0 + lane < users
            ? user_triangle(hist_offsets, cand_offsets, u0 + lane)
            : 0;
    long long incl = tri;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += y;
    }
    // the first lane whose running sum passes the tile (a user of no
    // tiles adds nothing, so it is never the first)
    const unsigned hit = __ballot_sync(~0u, tile < run + incl);
    if (hit) {
      const int at = __ffs(hit) - 1;
      *base = run + __shfl_sync(~0u, incl - tri, at);
      return u0 + at;
    }
    run += __shfl_sync(~0u, incl, 31);
  }
  return users;
}

// bucket(x) for x = |t_i - t_j|: a first guess from a fast log, then one
// step to the thresholds, which decide. The guess is within 1e-6 of
// ln(x) / 0.301 (the fast log2 and the rounding of x to f32), so it lies
// at most one bucket from the exact one, and one step both ways suffices.
// th[0] = 0 and th[buckets + 1] is a sentinel no x reaches, so the step
// needs no test of b's range.
__device__ __forceinline__ unsigned time_bucket(unsigned long long x,
                                                const unsigned long long* th,
                                                int buckets) {
  int b = (int)(__log2f((float)max(x, 1ull)) * kLog2ToBucket);
  b = min(max(b, 0), buckets);
  return (unsigned)(b + (x >= th[b + 1]) - (x < th[b]));
}

// One block a code tile; the grid walks the users' triangles in order.
__global__ void __launch_bounds__(kThreads)
    hstu_time_codes_kernel(const CodeParams p) {
  __shared__ long long qt[kBM], kt[kBN];
  __shared__ unsigned long long th[kMasked + 1];
  const long long tile = blockIdx.x;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int e = tid; e <= p.buckets + 1; e += kThreads)
    th[e] = e <= p.buckets ? (unsigned long long)p.thresholds[e] : ~0ull;
  long long base = 0;
  const int user =
      find_user(p.hist_offsets, p.cand_offsets, p.users, tile, &base);
  if (user == p.users) return;  // uniform across the block
  // (a, b) of the triangle's entry tile - base, b <= a
  const long long local = tile - base;
  int a = (int)((sqrt(8.0 * (double)local + 1.0) - 1.0) * 0.5);
  while ((long long)(a + 1) * (a + 2) / 2 <= local) ++a;
  while ((long long)a * (a + 1) / 2 > local) --a;
  const int b = (int)(local - (long long)a * (a + 1) / 2);

  const int hist_lo = p.hist_offsets[user];
  const int n_h = p.hist_offsets[user + 1] - hist_lo;
  const int cand_lo = p.cand_offsets[user];
  const int n = n_h + (p.cand_offsets[user + 1] - cand_lo);
  const long long hist0 = hist_lo, cand0 = p.hist_total + cand_lo;
  const int q0 = a * kBM, k0 = b * kBN;
  if (tid < kBM + kBN) {
    // rows past the user's end read its last token's time (their codes
    // are kMasked)
    const int r = tid < kBM ? q0 + tid : k0 + tid - kBM;
    const long long t = p.times[row_of(min(r, n - 1), n_h, hist0, cand0)];
    if (tid < kBM)
      qt[tid] = t;
    else
      kt[tid - kBM] = t;
  }
  __syncthreads();

  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + tx + 16 * c;
      const long long dt = qt[ty + 16 * r] - kt[tx + 16 * c];
      const unsigned long long x = dt < 0 ? 0ull - (unsigned long long)dt
                                          : (unsigned long long)dt;
      const bool in =
          i < n && j < n && (i >= n_h ? (j < n_h || j == i) : j <= i);
      w[r] |= (in ? time_bucket(x, th, p.buckets) : kMasked) << (8 * c);
    }
  }
  p.codes[tile * kTileCodes + tid] = make_uint4(w[0], w[1], w[2], w[3]);
}

// 64 rows of one head's D columns, local tokens [r0, r0 + 64), into shared
// memory rows of `stride` floats; rows at or past n are zero-filled.
template <int D>
__device__ __forceinline__ void copy_tile(float* dst, int stride,
                                          const float* src, long long ld,
                                          int r0, int n, int n_h,
                                          long long hist0, long long cand0) {
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < kBM * kChunks; idx += kThreads) {
    const int r = idx / kChunks, ch = idx % kChunks;
    const int local = r0 + r;
    const bool valid = local < n;
    const float* from =
        valid ? src + row_of(local, n_h, hist0, cand0) * ld + ch * 4 : src;
    cp_async16(dst + r * stride + ch * 4, from, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    hstu_attention_kernel(const Params p) {
  using S = Smem<D>;
  constexpr int kQS = S::kQStride, kAS = S::kAStride;
  constexpr int kCols = D / 64;  // float4 column chunks of O a thread
  extern __shared__ __align__(16) char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = reinterpret_cast<float*>(smem + S::kQ);  // K, then A
  float* vs = reinterpret_cast<float*>(smem + S::kQ + S::kK);
  float* pos = reinterpret_cast<float*>(smem + S::kQ + S::kK + S::kV);
  float* tw =
      reinterpret_cast<float*>(smem + S::kQ + S::kK + S::kV + S::kPos);

  const int bid = blockIdx.x;
  const int head = bid % p.heads;
  const int rest = bid / p.heads;
  const int user = rest % p.users;
  const int tile = p.max_tiles - 1 - rest / p.users;
  const int hist_lo = p.hist_offsets[user];
  const int n_h = p.hist_offsets[user + 1] - hist_lo;
  const int cand_lo = p.cand_offsets[user];
  const int n = n_h + (p.cand_offsets[user + 1] - cand_lo);
  const int q0 = tile * kBM;
  if (q0 >= n) return;  // uniform across the block
  const long long hist0 = hist_lo, cand0 = p.hist_total + cand_lo;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long col = (long long)head * D;

  copy_tile<D>(qs, kQS, p.q + col, p.ld, q0, n, n_h, hist0, cand0);
  for (int b = tid; b <= p.buckets; b += kThreads) tw[b] = p.time_bias[b];
  // this thread's codes in code tile (tile, 0); key tile k0 / 64 follows
  const uint4* codes =
      p.codes + (code_base(p.hist_offsets, p.cand_offsets, user) +
                 (long long)tile * (tile + 1) / 2) * kTileCodes + tid;

  float o[4][kCols * 4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCols * 4; ++c) o[r][c] = 0.f;

  for (int k0 = 0; k0 <= q0; k0 += kBN) {
    if (k0 >= n_h && k0 != q0) continue;  // others' candidates: all masked
    __syncthreads();  // the last tile's A and V are read
    // two groups (Q's copies join the first tile's K): S waits for K
    // only, and V lands while S is computed
    copy_tile<D>(ks, kQS, p.k + col, p.ld, k0, n, n_h, hist0, cand0);
    cp_async_commit();
    copy_tile<D>(vs, D, p.v + col, p.ld, k0, n, n_h, hist0, cand0);
    cp_async_commit();
    const uint4 code = __ldg(codes + (long long)(k0 / kBN) * kTileCodes);
    if (tid < 127) {
      // p[j - i + N - 1] for j - i in [k0 - q0 - 63, k0 - q0 + 63]
      const int at = p.max_seq_len - 1 + k0 - q0 - 63 + tid;
      pos[tid] = at >= 0 && at < 2 * p.max_seq_len - 1 ? p.pos_bias[at] : 0.f;
    }
    cp_async_wait<1>();
    __syncthreads();

    // S = Q K^T: queries ty + 16 r, keys tx + 16 c
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(qs + (ty + 16 * r) * kQS + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * kQS + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qv[r].x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv[r].y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv[r].z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv[r].w, kv[c].w, s[r][c]);
        }
    }
    // the bias, SiLU, 1/N and the mask, in registers, by the codes
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const unsigned word = r == 0   ? code.x
                            : r == 1 ? code.y
                            : r == 2 ? code.z
                                     : code.w;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned b = (word >> (8 * c)) & 0xffu;
        float a = 0.f;
        if (b != kMasked) {
          // p[j - i + N - 1] for i = q0 + ty + 16 r, j = k0 + tx + 16 c
          const float rab = pos[tx + 16 * c - ty - 16 * r + 63] + tw[b];
          const float x = fmaf(s[r][c], p.alpha, rab);
          a = __fdividef(x, 1.f + __expf(-x)) * p.inv_n;
        }
        s[r][c] = a;
      }
    }
    __syncthreads();  // every thread is done with K
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) ks[(ty + 16 * r) * kAS + tx + 16 * c] = s[r][c];
    cp_async_wait<0>();
    __syncthreads();

    // O += A V: rows ty + 16 r, columns tx * 4 + 64 c (+0..3)
#pragma unroll 2
    for (int kk = 0; kk < kBN; kk += 4) {
      float4 av[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        av[r] = *reinterpret_cast<const float4*>(ks + (ty + 16 * r) * kAS + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 vv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          vv[c] = *reinterpret_cast<const float4*>(vs + (kk + e) * D +
                                                   tx * 4 + 64 * c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = e == 0 ? av[r].x
                          : e == 1 ? av[r].y
                          : e == 2 ? av[r].z
                                   : av[r].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            o[r][4 * c + 0] = fmaf(a, vv[c].x, o[r][4 * c + 0]);
            o[r][4 * c + 1] = fmaf(a, vv[c].y, o[r][4 * c + 1]);
            o[r][4 * c + 2] = fmaf(a, vv[c].z, o[r][4 * c + 2]);
            o[r][4 * c + 3] = fmaf(a, vv[c].w, o[r][4 * c + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= n) continue;
    float* dst = p.out + row_of(i, n_h, hist0, cand0) * p.out_ld + col;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      *reinterpret_cast<float4*>(dst + tx * 4 + 64 * c) =
          make_float4(o[r][4 * c], o[r][4 * c + 1], o[r][4 * c + 2],
                      o[r][4 * c + 3]);
  }
}

// What was launched last (the build, head_dim 0, or the attention), for
// hstu_attention_last_launch_info.
struct Record {
  const void* fn = nullptr;
  size_t smem = 0;
  int head_dim = 0;
  int grid = 0;
};
Record g_last;
std::mutex g_mutex;

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <int D>
int launch(const Params& p, long long blocks, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes(p.buckets);
  auto fn = hstu_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  g_last = {reinterpret_cast<const void*>(fn), smem, D, (int)blocks};
  fn<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched). Writes the layout's `tiles` code
// tiles (its users' triangles, summed) to `codes`, 16-byte aligned.
int hstu_time_codes_launch(const int* hist_offsets, const int* cand_offsets,
                           int users, long long hist_total,
                           const long long* times,
                           const long long* thresholds, int buckets,
                           void* codes, long long tiles, void* stream) {
  if (users <= 0 || tiles <= 0) return cudaSuccess;
  if (buckets < 0 || buckets >= kMasked || tiles > 0x7fffffffLL ||
      !aligned16(codes))
    return cudaErrorInvalidValue;
  const CodeParams p{hist_offsets, cand_offsets, users,   hist_total,
                     times,        thresholds,   buckets, static_cast<uint4*>(codes)};
  std::lock_guard<std::mutex> hold(g_mutex);
  g_last = {reinterpret_cast<const void*>(hstu_time_codes_kernel), 0, 0,
            (int)tiles};
  hstu_time_codes_kernel<<<(unsigned)tiles, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// Returns a cudaError_t (0 = launched). head_dim is 128; `codes` are the
// layout's, written by hstu_time_codes_launch.
int hstu_attention_launch(const float* q, const float* k, const float* v,
                          long long ld, const int* hist_offsets,
                          const int* cand_offsets, int users,
                          long long hist_total, const void* codes,
                          const float* pos_bias, const float* time_bias,
                          int buckets, float* out, long long out_ld,
                          int heads, int head_dim, int max_seq_len,
                          int max_tiles, void* stream) {
  if (users <= 0 || max_tiles <= 0) return cudaSuccess;
  if (heads < 1 || max_seq_len < 1 || buckets < 0 || buckets >= kMasked ||
      head_dim != 128 || ld % 4 || out_ld % 4 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(out) ||
      !aligned16(codes) ||
      (long long)max_tiles * kBM > (long long)max_seq_len + kBM - 1)
    return cudaErrorInvalidValue;
  const long long blocks = (long long)heads * users * max_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Params p{q,           k,          v,
                 ld,          hist_offsets, cand_offsets,
                 users,       hist_total, static_cast<const uint4*>(codes),
                 pos_bias,    time_bias,  buckets,
                 out,         out_ld,     heads,
                 max_seq_len, max_tiles,
                 1.f / sqrtf((float)head_dim), 1.f / (float)max_seq_len};
  const auto s = static_cast<cudaStream_t>(stream);
  std::lock_guard<std::mutex> hold(g_mutex);
  return launch<128>(p, blocks, s);
}

// out[0..6] = registers per thread, resident blocks per SM, local (spill)
// bytes per thread, static shared bytes, dynamic shared bytes, head dim
// (0 for the build), blocks launched; of the kernel launched last.
int hstu_attention_last_launch_info(int* out) {
  std::lock_guard<std::mutex> hold(g_mutex);
  if (!g_last.fn) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, g_last.fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, g_last.fn,
                                                      kThreads, g_last.smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = blocks;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = (int)g_last.smem;
  out[5] = g_last.head_dim;
  out[6] = g_last.grid;
  return cudaSuccess;
}

}  // extern "C"
