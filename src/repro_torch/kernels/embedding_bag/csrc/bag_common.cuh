// The gather-and-pool core shared by the embedding-bag kernel
// (embedding_bag.cu), the fused warm-cache lookup kernel (fused_lookup.cu)
// and the ragged-tables kernel (ragged_bag.cu), written for Hopper (sm_90a).
//
// All three pool one bag per warp with the same instructions in the same
// order: a lane's 16-byte share of each row, products with the lookup's
// weight rounded once (__fmul_rn, weighted bags only), and a compensated
// f32 sum taken in lookup order (Kahan's, add_compensated). That is what
// lets the tiered backend's pooled output equal the device backend's bit
// for bit: a bag that the fused kernel pools whole, and a bag that the cold
// path recomputes through the embedding-bag kernel, go through this one
// function.
//
// What bounds the kernels on an H100. The floor is the bytes of the
// distinct rows (about 0.25 FLOP per byte of f32 row, far under the ridge
// point). On hot traffic the caches serve most repeats, so the first limit
// is the instructions the loop spends per lookup, of which the compensated
// add is the largest part (16 FADDs of about 43 warp instructions a lookup
// of a D=128 f32 row), and then each row's pass through shared memory
// (PERF.md). So:
//  * rows are staged in shared memory by asynchronous copies (cp.async,
//    16 bytes a lane), into a per-warp ring of DEPTH row slots filled
//    DEPTH-1 lookups ahead of the pooling loop (the paper's prefetching,
//    §IV-B). The ring costs no registers, so registers no longer cap the
//    resident warps (the paper's occupancy finding, §III-C);
//  * a bag's lookups are staged 32 at a time: each lane turns one index
//    into a row address (or "skip", or "bad") and writes it to a per-warp
//    table in shared memory, and two ballots turn the window into bitmasks
//    kept in registers; the loop reads an address only to copy its row,
//    and branches on a register bit;
//  * the loop runs in unrolled chunks of max(DEPTH, 8) lookups, so slot
//    offsets are constants and only the bag's last chunk checks its end;
//  * the compensated add is Kahan's recurrence, four f32 operations and no
//    branch, whose result is within (2u + O(L·u²))·Σ|x| of the exact sum
//    (u = eps/2; Goldberg 1991, Theorem 8): half of the 2·eps·Σ|w·x| rule
//    the kernels are held to, where a plain f32 chain of a bag's repeats
//    breaks it;
//  * unweighted bags (WEIGHTED=false) carry no weight, no product and no
//    weight sum;
//  * indices, slots and weights are read, and outputs written, as streaming
//    accesses (evict-first), so single-use traffic does not push rows out
//    of L2.
// Rows whose bytes are not a multiple of 16 (or not 16-byte aligned) take a
// scalar path with direct loads: one element a lane, no ring.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace bag_common {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWindow = 32;           // lookups staged at once, one a lane
constexpr int kEntries = 2 * kWindow; // staged entries live in a warp
constexpr int kSliceBytes = 16;       // one lane's share of a row per copy
constexpr int kRowPass = 32 * kSliceBytes;  // bytes of a row a warp covers
constexpr int kMaxBagsPerBlock = 8;
constexpr int kMinBlocksPerSM = 6;  // 48 warps: at most 40 registers a thread
constexpr int kMinRingDepth = 2;    // one copy in flight at least
constexpr int kMaxRingDepth = 16;
// a staged entry: a row's address, or one of these
constexpr uintptr_t kSkip = 0;  // nothing to add (a MISS or PAD slot)
constexpr uintptr_t kBad = 1;   // input not to be trusted: the bag is NaN

// Shared bytes one warp holds: the row ring (vector path only), the staged
// row addresses and, for weighted bags, the staged weights.
__host__ __device__ constexpr int warp_smem_bytes(int depth, bool weighted,
                                                  bool vec) {
  return (vec ? depth * kRowPass : 0) + kEntries * 8 +
         (weighted ? kEntries * 4 : 0);
}

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

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}

// s - c carries a sum, c being the excess of s over it; add x (Kahan's
// recurrence: four operations, no branch). The intrinsics keep nvcc from
// contracting or reassociating it, which would drop the compensation.
__device__ __forceinline__ void add_compensated(float& s, float& c, float x) {
  const float y = __fsub_rn(x, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

// The sum that (s, c) carries, rounded once.
__device__ __forceinline__ float fold_compensated(float s, float c) {
  return __fsub_rn(s, c);
}

// What a kernel tells the core about lookup q of a bag: where its row
// starts (or kSkip / kBad) and its weight.
struct Entry {
  uintptr_t row;
  float w;
};

__device__ __forceinline__ void cp_async16(void* smem, uintptr_t gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One lane's share of a row: a 16-byte vector, or a single element where
// the row's bytes are not a multiple of 16.
template <typename T, bool VEC> struct Slice;

template <typename T> struct Slice<T, true> {
  static constexpr int N = kSliceBytes / sizeof(T);
  static __device__ __forceinline__ void unpack(int4 raw, float* x) {
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_float(v[i]);
  }
  static __device__ __forceinline__ void store(T* p, const float* acc) {
    alignas(16) T v[N];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = from_float<T>(acc[i]);
    __stcs(reinterpret_cast<int4*>(p), *reinterpret_cast<const int4*>(v));
  }
};

template <typename T> struct Slice<T, false> {
  static constexpr int N = 1;
  static __device__ __forceinline__ void store(T* p, const float* acc) {
    *p = from_float<T>(acc[0]);
  }
};

// Stage lookups [32w, 32w + 32) of the bag: lane l asks the kernel for
// lookup 32w + l and writes the answer into the warp's entry table. The
// entries of window w - 2, which this overwrites, are no longer read.
// `special` gets one bit per lookup that loads no row (kSkip, kBad, or past
// the bag's end), `bad` one per kBad.
template <bool WEIGHTED, class Src>
__device__ __forceinline__ void stage_window(Src& src, int w, int L, int lane,
                                             uintptr_t* ent, float* wts,
                                             bool first_pass,
                                             unsigned& special,
                                             unsigned& bad) {
  const int q = w * kWindow + lane;
  const Entry e = q < L ? src.entry(q, first_pass) : Entry{kSkip, 0.f};
  special = __ballot_sync(kFull, e.row <= kBad);
  bad = __ballot_sync(kFull, e.row == kBad);
  __syncwarp();
  ent[q & (kEntries - 1)] = e.row;
  if (WEIGHTED) wts[q & (kEntries - 1)] = e.w;
  __syncwarp();
}

// Add lookup q's contribution x (already widened to f32) to (acc, comp).
template <int N, bool WEIGHTED>
__device__ __forceinline__ void accumulate(const float* x, float wv,
                                           float* acc, float* comp) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    add_compensated(acc[i], comp[i], WEIGHTED ? __fmul_rn(x[i], wv) : x[i]);
}

template <int N>
__device__ __forceinline__ void accumulate_nan(float* acc, float* comp) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    add_compensated(acc[i], comp[i], quiet_nan());
}

// One pass of a warp over the L lookups of its bag, for the lane's share
// `col_bytes` of every row (the vector path: one 16-byte slice a lane).
// `ring` is the warp's DEPTH x 512-byte row ring: lookup j goes to slot
// j % DEPTH, copied DEPTH-1 lookups ahead of its use into the slot that
// lookup j - DEPTH left. The loop runs in chunks of U = max(DEPTH, 8)
// lookups, unrolled, so every slot offset is a constant; which lookups
// load no row is read from the staged windows' bitmasks, kept in
// registers, and only the last chunk checks the bag's end. wsum/wcomp get the compensated weight sum in
// lookup order (weighted bags; unused otherwise).
template <typename T, bool WEIGHTED, int DEPTH, class Src>
__device__ __forceinline__ void pool_pass_vec(
    Src& src, int L, int lane, bool active, int col_bytes, char* ring,
    uintptr_t* ent, float* wts, bool first_pass, float* acc, float* comp,
    float& wsum, float& wcomp) {
  static_assert((DEPTH & (DEPTH - 1)) == 0 && DEPTH >= 2 && DEPTH <= 32,
                "ring depth: a power of two in [2, 32]");
  using S = Slice<T, true>;
  constexpr int N = S::N;
  constexpr int U = DEPTH > 8 ? DEPTH : 8;  // lookups a chunk; divides 32
  char* my_slot = ring + lane * kSliceBytes;
  // masks of the window being pooled (cur) and of the newest one staged
  unsigned cur_sp, cur_bad, next_sp, next_bad;
  auto stage = [&](int w) {
    stage_window<WEIGHTED>(src, w, L, lane, ent, wts, first_pass, next_sp,
                           next_bad);
  };
  // copy lookup j into `slot` unless its `special` bit says it loads nothing
  auto issue = [&](int j, int slot, bool special) {
    if (active && !special)
      cp_async16(my_slot + slot * kRowPass,
                 ent[j & (kEntries - 1)] + col_bytes);
    cp_async_commit();  // one group per lookup, empty where nothing loads
  };
  stage(0);
  cur_sp = next_sp;
  cur_bad = next_bad;
#pragma unroll
  for (int k = 0; k < DEPTH - 1; ++k) issue(k, k, (cur_sp >> k) & 1u);
  auto chunk = [&](int q0, auto tail) {
    const int base = q0 & (kWindow - 1);
    if (base == 0) {
      cur_sp = next_sp;
      cur_bad = next_bad;
    }
    // this chunk copies lookups [q0 + DEPTH - 1, q0 + U + DEPTH - 1),
    // which cross into a new window exactly when q0 + U starts one
    if (((q0 + U) & (kWindow - 1)) == 0) stage((q0 + U) / kWindow);
    const unsigned issue_sp = static_cast<unsigned>(
        ((static_cast<unsigned long long>(next_sp) << 32) | cur_sp) >>
        (base + DEPTH - 1));
    const unsigned sp = cur_sp >> base, bad = cur_bad >> base;
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int q = q0 + k;  // in slot k % DEPTH
      if (decltype(tail)::value && q >= L) break;
      issue(q + DEPTH - 1, (k + DEPTH - 1) & (DEPTH - 1),
            (issue_sp >> k) & 1u);
      cp_async_wait<DEPTH - 1>();
      if (!((sp >> k) & 1u)) {
        const float wv = WEIGHTED ? wts[q & (kEntries - 1)] : 1.f;
        if (WEIGHTED) add_compensated(wsum, wcomp, wv);
        float x[N];
        S::unpack(*reinterpret_cast<const int4*>(
                      my_slot + (k & (DEPTH - 1)) * kRowPass),
                  x);
        accumulate<N, WEIGHTED>(x, wv, acc, comp);
      } else if ((bad >> k) & 1u) {
        if (WEIGHTED) add_compensated(wsum, wcomp, quiet_nan());
        accumulate_nan<N>(acc, comp);
      }
    }
  };
  int q0 = 0;
  for (; q0 + U <= L; q0 += U) chunk(q0, std::false_type{});
  if (q0 < L) chunk(q0, std::true_type{});
  cp_async_wait<0>();
}

// The scalar path: one element a lane, loaded directly.
template <typename T, bool WEIGHTED, class Src>
__device__ __forceinline__ void pool_pass_scalar(
    Src& src, int L, int lane, bool active, int col_bytes, uintptr_t* ent,
    float* wts, bool first_pass, float* acc, float* comp, float& wsum,
    float& wcomp) {
  unsigned special, bad;  // unused: the scalar path reads the entries
  for (int q = 0; q < L; ++q) {
    if ((q & (kWindow - 1)) == 0)
      stage_window<WEIGHTED>(src, q / kWindow, L, lane, ent, wts, first_pass,
                             special, bad);
    const uintptr_t row = ent[q & (kEntries - 1)];
    const float wv = WEIGHTED ? wts[q & (kEntries - 1)] : 1.f;
    if (WEIGHTED) add_compensated(wsum, wcomp, row == kBad ? quiet_nan() : wv);
    if (row > kBad) {
      const float x =
          active ? to_float(*reinterpret_cast<const T*>(row + col_bytes)) : 0.f;
      accumulate<1, WEIGHTED>(&x, wv, acc, comp);
    } else if (row == kBad) {
      accumulate_nan<1>(acc, comp);
    }
  }
}

// Pool one bag with one warp: every 512-byte pass of the row (D=128 f32
// is one pass), each pass over all L lookups, then `finish(out_col,
// acc, wsum)` turns the f32 sums into the lane's output and stores them.
// `smem` is the warp's share of the block's dynamic shared memory.
template <typename T, bool VEC, bool WEIGHTED, int DEPTH, class Src,
          class Finish>
__device__ __forceinline__ void pool_bag(Src& src, int L, int dim, char* smem,
                                         Finish finish) {
  using S = Slice<T, VEC>;
  constexpr int N = S::N;
  const int lane = threadIdx.x & 31;
  char* ring = smem;
  uintptr_t* ent =
      reinterpret_cast<uintptr_t*>(smem + (VEC ? DEPTH * kRowPass : 0));
  float* wts = reinterpret_cast<float*>(ent + kEntries);
  const int slices = dim / N;
  for (int c0 = 0; c0 < slices; c0 += 32) {
    const bool active = c0 + lane < slices;
    const int col = (c0 + lane) * N;  // this lane's first element in a row
    const int col_bytes = col * (int)sizeof(T);
    float acc[N], comp[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = comp[i] = 0.f;
    float wsum = 0.f, wcomp = 0.f;
    if constexpr (VEC)
      pool_pass_vec<T, WEIGHTED, DEPTH>(src, L, lane, active, col_bytes, ring,
                                        ent, wts, c0 == 0, acc, comp, wsum,
                                        wcomp);
    else
      pool_pass_scalar<T, WEIGHTED>(src, L, lane, active, col_bytes, ent, wts,
                                    c0 == 0, acc, comp, wsum, wcomp);
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = fold_compensated(acc[i], comp[i]);
    if (active) finish(col, acc, fold_compensated(wsum, wcomp));
  }
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// The largest power of two <= requested, clamped to
// [kMinRingDepth, kMaxRingDepth].
inline int ring_depth(int requested) {
  int depth = kMinRingDepth;
  while (depth * 2 <= requested && depth * 2 <= kMaxRingDepth) depth *= 2;
  return depth;
}

// What was launched last: the instantiation, its block size and dynamic
// shared memory, so that the library's info query can report the
// registers and the resident blocks per SM of exactly that kernel.
struct LaunchRecord {
  const void* fn = nullptr;
  int threads = 0;
  size_t smem = 0;
  int depth = 0;
  int bags_per_block = 0;
};

// out[0..6] = registers per thread, resident blocks per SM, local (spill)
// bytes per thread, static shared bytes, ring depth, bags per block,
// dynamic shared bytes per block.
inline int launch_info(const LaunchRecord& r, int* out) {
  if (!r.fn) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, r.fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, r.fn,
                                                      r.threads, r.smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = blocks;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = r.depth;
  out[5] = r.bags_per_block;
  out[6] = (int)r.smem;
  return cudaSuccess;
}

template <typename T> struct Type { using type = T; };
template <bool B> using Bool = std::integral_constant<bool, B>;
template <int D> using Depth = std::integral_constant<int, D>;

template <class Pick, class T, class V, class W>
int pick_depth(Pick& pick, T t, V v, W w, int depth) {
  if constexpr (!V::value) {
    return pick(t, v, w, Depth<kMinRingDepth>{});  // the scalar path: no ring
  } else {
    switch (depth) {
      case 2: return pick(t, v, w, Depth<2>{});
      case 4: return pick(t, v, w, Depth<4>{});
      case 8: return pick(t, v, w, Depth<8>{});
      default: return pick(t, v, w, Depth<kMaxRingDepth>{});
    }
  }
}

// The instantiations both kernels have: every dtype (0 = float32,
// 1 = bfloat16), path (vector or scalar), weighting and, on the vector
// path, ring depth. Calls pick(Type<T>, Bool<VEC>, Bool<WEIGHTED>,
// Depth<DEPTH>) for the one a launch needs and returns its result.
template <class Pick>
int instantiate(int dtype, bool vec, bool weighted, int depth, Pick pick) {
  auto by_weighting = [&](auto t, auto v) {
    return weighted ? pick_depth(pick, t, v, Bool<true>{}, depth)
                    : pick_depth(pick, t, v, Bool<false>{}, depth);
  };
  auto by_path = [&](auto t) {
    return vec ? by_weighting(t, Bool<true>{}) : by_weighting(t, Bool<false>{});
  };
  return dtype == 0 ? by_path(Type<float>{}) : by_path(Type<__nv_bfloat16>{});
}

// Launch `fn` with `smem` bytes of dynamic shared memory, raising the
// kernel's limit first where it is above the default 48 KB; a refusal
// comes back as the error code. Records the launch for launch_info.
template <typename... KArgs, typename... Args>
int launch_with_smem(void (*fn)(KArgs...), dim3 grid, dim3 block, size_t smem,
                     cudaStream_t stream, LaunchRecord& rec, int depth,
                     int bags_per_block, const Args&... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  rec = {reinterpret_cast<const void*>(fn), (int)block.x, smem, depth,
         bags_per_block};
  fn<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace bag_common
