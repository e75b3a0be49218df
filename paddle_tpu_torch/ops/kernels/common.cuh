// Shared helpers for the port's CUDA kernels: element conversions through
// the intrinsics, and vector loads of a row slice converted to f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes passed by the Python wrappers (ops/kernels/__init__.py)
enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return (float)x;  // exact
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// Load N consecutive elements starting at p (aligned to N * sizeof(T)
// bytes) and convert them to f32, in 16-, 8- or 4-byte transactions.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&o)[N]) {
  constexpr int BYTES = int(sizeof(T)) * N;
  constexpr int PER16 = 16 / int(sizeof(T));
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < PER16; ++j) o[i * PER16 + j] = to_f<T>(t[j]);
    }
  } else if constexpr (BYTES == 8) {
    uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = to_f<T>(t[j]);
  } else if constexpr (BYTES == 4) {
    uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = to_f<T>(t[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = to_f<T>(p[j]);
  }
}
