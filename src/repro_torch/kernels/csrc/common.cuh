// Helpers shared by the kernels: 16-byte vector loads of fp32 or
// bf16 rows, converted to fp32 in registers, and typed scalar stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes passed from Python (ops.py: _DTYPE_CODE)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// 16 bytes of T: the raw register type and its element count
template <typename T> struct Vec16;

template <> struct Vec16<float> {
  using raw = float4;
  static constexpr int N = 4;
  __device__ __forceinline__ static void to_float(const raw& r, float* f) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
};

template <> struct Vec16<__nv_bfloat16> {
  using raw = uint4;
  static constexpr int N = 8;
  __device__ __forceinline__ static void to_float(const raw& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

template <typename T>
__device__ __forceinline__ typename Vec16<T>::raw load16(const T* p) {
  return __ldg(reinterpret_cast<const typename Vec16<T>::raw*>(p));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// log2(e): scores are kept in base 2 so the softmax uses exp2f
constexpr float kLog2e = 1.4426950408889634f;
// finite "minus infinity" of the running max, as the reference kernels use
constexpr float kNegBig = -1e30f;

}  // namespace repro
