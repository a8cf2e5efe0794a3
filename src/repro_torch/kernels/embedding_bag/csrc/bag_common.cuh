// Pieces shared by the embedding-bag kernel (embedding_bag.cu) and the
// fused warm-cache lookup kernel (fused_lookup.cu).
//
// Both kernels pool one bag per warp with the same arithmetic: 16-byte lane
// loads of a row, products with the lookup's weight rounded once
// (__fmul_rn), and a Neumaier-compensated f32 sum taken in lookup order.
// Keeping that arithmetic in one place is what lets the tiered backend's
// pooled output equal the device backend's bit for bit: a bag that the
// fused kernel pools whole, and a bag that the cold path recomputes
// through the embedding-bag kernel, go through the same instructions in
// the same order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bag_common {

constexpr unsigned kFull = 0xffffffffu;

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

// One lane's share of a row: a 16-byte vector, or a single element where
// the row's bytes are not a multiple of 16.
template <typename T, bool VEC> struct Slice;

template <typename T> struct Slice<T, true> {
  static constexpr int N = 16 / sizeof(T);
  int4 raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = __ldg(reinterpret_cast<const int4*>(p));
  }
  __device__ __forceinline__ float get(int i) const {
    return to_float(reinterpret_cast<const T*>(&raw)[i]);
  }
  static __device__ __forceinline__ void store(T* p, const float* acc) {
    alignas(16) T v[N];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = from_float<T>(acc[i]);
    *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(v);
  }
};

template <typename T> struct Slice<T, false> {
  static constexpr int N = 1;
  T raw;
  __device__ __forceinline__ void load(const T* p) { raw = *p; }
  __device__ __forceinline__ float get(int) const { return to_float(raw); }
  static __device__ __forceinline__ void store(T* p, const float* acc) {
    *p = from_float<T>(acc[0]);
  }
};

// s + c carries a sum; add y to it with the rounding error kept in c.
__device__ __forceinline__ void add_compensated(float& s, float& c, float y) {
  const float t = __fadd_rn(s, y);
  c += fabsf(s) >= fabsf(y) ? __fadd_rn(s - t, y) : __fadd_rn(y - t, s);
  s = t;
}

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// The largest power of two <= requested, clamped to [1, max_distance].
inline int ring_depth(int requested, int max_distance) {
  int distance = 1;
  while (distance * 2 <= requested && distance * 2 <= max_distance)
    distance *= 2;
  return distance;
}

}  // namespace bag_common
