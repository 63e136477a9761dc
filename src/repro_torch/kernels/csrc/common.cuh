// Helpers shared by the kernels: 16-byte vector loads of fp32 or
// bf16 rows, converted to fp32 in registers, typed scalar stores, and the
// tensor-core and asynchronous-copy instructions (sm_80 and later) with
// the fp32 -> tf32 split that lets TF32 products reach fp32 accuracy.
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

// --- tensor cores: TF32 products at fp32 accuracy (3xTF32) ---------------

// x = hi + lo for 3xTF32 (the split CUTLASS's OpMultiplyAddFastF32 uses):
// hi is x rounded to tf32 (10 mantissa bits, to nearest with ties away from
// zero: an integer add and a mask, for finite x), lo = x - hi exactly in
// fp32, and the tensor cores read lo's top 19 bits, so lo enters truncated
// to tf32.  hi * hi' + hi * lo' + lo * hi' then carries ~21 of fp32's 24
// bits, and each tf32 x tf32 product is exact in fp32.  (cvt.rna.tf32.f32
// rounds the same way but compiles to a NaN-safe sequence several times
// longer.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a * b on the tensor cores: one warp, m16n8k8, tf32 operands, fp32
// accumulators.  With g = lane / 4 and t = lane % 4: a = {A[g][t],
// A[g+8][t], A[g][t+4], A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, d = {D[g][2t],
// D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --- asynchronous copies, global -> shared --------------------------------

// 16 bytes, bypassing L1; with !valid the 16 bytes are zero-filled and src
// is not read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// the least power of two >= n (n >= 1), at compile time
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// log2(e): scores are kept in base 2 so the softmax uses exp2f
constexpr float kLog2e = 1.4426950408889634f;
// finite "minus infinity" of the running max, as the reference kernels use
constexpr float kNegBig = -1e30f;

}  // namespace repro
