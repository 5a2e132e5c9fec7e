// Shared helpers for the port's kernels: float <-> storage-type
// conversion (f32 or bf16; arithmetic is always f32) and a 16-byte-or-
// smaller vector of VEC values for coalesced loads along channels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cyt {

// dtype codes shared with the Python wrappers (ops/_build.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// torch's leaky_relu: x > 0 ? x : x * slope, in f32
__device__ __forceinline__ float leaky(float m, float slope) {
  return m > 0.f ? m : m * slope;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace cyt
