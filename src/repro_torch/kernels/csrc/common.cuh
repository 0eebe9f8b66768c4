// Shared helpers for the port's Hopper kernels (sm_90a).
//
// Every kernel is reached through a plain C function that launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for arguments it does not take).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with kernels/build.py
enum ReproDtype { REPRO_F32 = 0, REPRO_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// VEC elements moved as one aligned vector access (16 bytes for the
// widest packs: 8 x bf16 or 4 x fp32).
template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The tile width a head dim runs in: the narrowest of 16, 32, 64 and 128
// that holds it (hd a multiple of 8), else 0.  A kernel built at the tile
// width zero-fills the columns past hd on load and never stores them.
static inline int tile_width(int hd) {
  if (hd < 8 || hd > 128 || hd % 8 != 0) return 0;
  return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : 128;
}
