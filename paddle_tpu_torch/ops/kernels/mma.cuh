// Tensor-core helpers shared by the flash-attention kernels: 2-byte element
// pairs packed into the 32-bit registers of mma.sync / wgmma A fragments.
#pragma once

#include "common.cuh"

template <typename T>
__device__ __forceinline__ uint32_t pack2(T lo, T hi) {
  return (uint32_t)(*reinterpret_cast<const uint16_t*>(&lo)) |
         ((uint32_t)(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2<T>(from_f<T>(lo), from_f<T>(hi));
}
