// Helpers shared by the kernels of repro_torch (included, never built alone).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr float kNegInf = -1e30f;   // the JAX kernels' NEG_INF: finite, so
                                    // exp(kNegInf - m) underflows to 0

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One 16-byte vector of T: VEC elements, loaded and widened to fp32.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int VEC = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
  __device__ __forceinline__ static float to_float(float x) { return x; }
  __device__ __forceinline__ static float from_float(float x) { return x; }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src, float* dst) {
    uint4 v = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x; dst[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ __forceinline__ static __nv_bfloat16 from_float(float x) { return __float2bfloat16(x); }
};

// 16 int8 values: the quantized pool's vector, widened to fp32 (the caller
// applies the tile's scale).
template <> struct Vec<int8_t> {
  static constexpr int VEC = 16;
  __device__ __forceinline__ static void load(const int8_t* src, float* dst) {
    int4 v = *reinterpret_cast<const int4*>(src);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(b[i]);
  }
};

}  // namespace repro_torch
