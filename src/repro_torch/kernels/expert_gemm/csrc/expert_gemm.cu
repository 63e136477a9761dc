// Grouped expert product of the MoE layer: y[e] = x[e] @ w[e] for every
// expert e, over the row tiles of its capacity slots that hold an occupied
// slot.  fp32 on the CUDA cores (sm_90a).
//
// It replaces no TPU kernel: the reference leaves the expert product to
// XLA's batched matmul over every slot of every expert.  It was added
// because the served prefill's dispatch fills each expert's `cap` slots
// from the front (`models/moe.py::_sorted_dispatch`: slots [0, count_e)
// hold its kept pairs, the rest are zero rows), and at capacity factor
// 1.25 a third to two thirds of the slots are empty, which a batched
// matmul multiplies all the same.
//
// Bound: fp32 FFMA at 67 TFLOP/s over the FLOPs the function needs,
// 2 * K * N * sum_e count_e.  The rows it computes past the counts, up to
// whole row tiles (sum_e ceil(count_e / kBM) * kBM in all), are the tile
// choice's waste and count against the kernel.  The bytes (the expert
// weights once, x's occupied rows, y) are a few percent of that time at
// the MoE prefill's shapes.
//
// Design: a static grid over (column tile, row tile, expert).  A block
// reads its expert's count; a row tile that starts at or past it writes
// zeros to its output tile and returns.  Any other tile is a SIMT GEMM of
// kBM = 64 rows x kBN = 256 columns by four warps, each thread 8 x 16
// outputs as 4 x 4 blocks read from shared memory as float4s, with the
// next k's fragments loaded while this k's FMAs run.  x and w reach shared
// memory through a four-stage cp.async ring of 16 k a stage: x transposed
// into k-major rows by 4-byte copies (as the align1 SIMT kernels of cuBLAS
// load it), w by 16-byte copies, each thread's copy addresses worked out
// once.  Rows of a tile past the count are zero-filled by the copies (the
// dispatch leaves them zero in x too), so they come out as 0.  Each output
// is one fp32 accumulator summed by fmaf over k in ascending order from 0:
// no split-K, no TF32.  A batched SIMT GEMM without split-K sums in that
// order too, so the occupied rows can equal torch.bmm's bit for bit.
//
// Measured against torch.bmm on the H100 (PERF.md section 6): 64-row tiles
// skip twice as finely as 128-row ones at no loss per FLOP; 16 k a stage,
// four stages and double-buffered fragments each won a few percent.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsM = 2, kWarpsN = 2;     // a warp: 32 x 128 outputs
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kTM = 8, kTN = 16;            // a thread: 8 x 16 outputs
constexpr int kBM = kWarpsM * 4 * kTM;      // 64: the tile a block skips
constexpr int kBN = kWarpsN * 8 * kTN;      // 256
constexpr int kBK = 16;                     // k a stage
constexpr int kStages = 4;
constexpr int kLdA = kBM + 4;               // x's k-major rows, padded
constexpr int kStageA = kBK * kLdA, kStageB = kBK * kBN;   // floats
constexpr int kSmemBytes = kStages * (kStageA + kStageB) * 4;

// 4 bytes through L1 / 16 bytes past it; with !valid zero-filled, src not
// read
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// x: [E, C, K], w: [E, K, N], y: [E, C, N], all fp32 contiguous, N % 4 == 0
// and w and y 16-byte aligned; counts: [E] int32, each expert's occupied
// slots (a prefix of its C).
__global__ void __launch_bounds__(kThreads, 2)
expert_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ counts, float* __restrict__ y,
                   int C, int K, int N) {
  const int e = blockIdx.z;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int count = min(max(counts[e], 0), C);
  float* ye = y + (size_t)e * C * N;

  if (row0 >= count) {            // no occupied slot in this row tile
    const int rows = min(kBM, C - row0);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < rows * (kBN / 4); i += kThreads) {
      const int r = i / (kBN / 4), c = col0 + (i % (kBN / 4)) * 4;
      if (c < N)
        *reinterpret_cast<float4*>(ye + (size_t)(row0 + r) * N + c) = z;
    }
    return;
  }

  extern __shared__ __align__(16) float smem[];
  float* As = smem;                           // [stage][k][kLdA]
  float* Bs = smem + kStages * kStageA;       // [stage][k][kBN]
  const float* xe = x + (size_t)e * C * K;
  const float* we = w + (size_t)e * K * N;

  // Each thread's copies of a stage: x's element (row m_a + q * kRA, k
  // kk_a) for q < kQA, w's four (k kk_b + q * kRB, columns c_b ...) for
  // q < kQB; fixed for the block but for the stage's k0.
  constexpr int kQA = kBM * kBK / kThreads, kRA = kThreads / kBK;
  constexpr int kQB = kBK * kBN / 4 / kThreads, kRB = kThreads / (kBN / 4);
  const int kk_a = tid % kBK, m_a = tid / kBK;
  const int qa_n = min(kQA, max(0, (count - row0 - m_a + kRA - 1) / kRA));
  const float* a_src = xe + (size_t)(row0 + m_a) * K + kk_a;
  const size_t a_step = (size_t)kRA * K;
  const uint32_t a_dst = static_cast<uint32_t>(
      __cvta_generic_to_shared(As + kk_a * kLdA + m_a));
  const int c_b = (tid % (kBN / 4)) * 4, kk_b = tid / (kBN / 4);
  const bool col_ok = col0 + c_b < N;
  const float* b_src = we + (size_t)kk_b * N + col0 + c_b;
  const size_t b_step = (size_t)kRB * N;
  const uint32_t b_dst = static_cast<uint32_t>(
      __cvta_generic_to_shared(Bs + kk_b * kBN + c_b));

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    const bool whole = k0 + kBK <= K;
#pragma unroll
    for (int q = 0; q < kQA; ++q) {
      const bool ok = q < qa_n && (whole || k0 + kk_a < K);
      cp_async4(a_dst + (stage * kStageA + q * kRA) * 4,
                ok ? a_src + k0 + q * a_step : xe, ok);
    }
#pragma unroll
    for (int q = 0; q < kQB; ++q) {
      const bool ok = col_ok && (whole || k0 + kk_b + q * kRB < K);
      cp_async16(b_dst + (stage * kStageB + q * kRB * kBN) * 4,
                 ok ? b_src + (size_t)k0 * N + q * b_step : we, ok);
    }
  };

  // a thread's rows: ra + {0..3} and 16 below; its columns: ca + {0..3}
  // and every 32 to the right
  const int warp = tid / 32, lane = tid % 32;
  const int ra = (warp / kWarpsN) * (4 * kTM) + (lane / 8) * 4;
  const int ca = (warp % kWarpsN) * (8 * kTN) + (lane % 8) * 4;
  auto fragments = [&](const float* as, const float* bs, int k,
                       float (&a)[kTM], float (&b)[kTN]) {
#pragma unroll
    for (int i = 0; i < kTM / 4; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(as + k * kLdA + ra + i * 16);
      a[4 * i] = v.x; a[4 * i + 1] = v.y; a[4 * i + 2] = v.z; a[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < kTN / 4; ++j) {
      const float4 v =
          *reinterpret_cast<const float4*>(bs + k * kBN + ca + j * 32);
      b[4 * j] = v.x; b[4 * j + 1] = v.y; b[4 * j + 2] = v.z; b[4 * j + 3] = v.w;
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int kt_n = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_n) load(s, s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  float a[2][kTM], b[2][kTN];
  fragments(As, Bs, 0, a[0], b[0]);
  for (int kt = 0; kt < kt_n; ++kt) {
    const float* as = As + (kt % kStages) * kStageA;
    const float* bs = Bs + (kt % kStages) * kStageB;
    const float* as_next = As + ((kt + 1) % kStages) * kStageA;
    const float* bs_next = Bs + ((kt + 1) % kStages) * kStageB;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      if (k == kBK - 1) {
        // stage kt + 1 is in, and every thread has read its last
        // fragments of stage kt - 1, which the next copies overwrite
        cp_async_wait<kStages - 2>();
        __syncthreads();
      }
      if (k + 1 < kBK)
        fragments(as, bs, k + 1, a[(k + 1) & 1], b[(k + 1) & 1]);
      else if (kt + 1 < kt_n)
        fragments(as_next, bs_next, 0, a[(k + 1) & 1], b[(k + 1) & 1]);
      if (k == 0) {
        if (kt + kStages - 1 < kt_n)
          load((kt + kStages - 1) % kStages, kt + kStages - 1);
        cp_async_commit();
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] = fmaf(a[k & 1][i], b[k & 1][j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ra + (i / 4) * 16 + i % 4;
    if (r >= C) continue;
    float* yr = ye + (size_t)r * N;
#pragma unroll
    for (int j = 0; j < kTN / 4; ++j) {
      const int c = col0 + ca + j * 32;
      if (c < N)
        *reinterpret_cast<float4*>(yr + c) = make_float4(
            acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
            acc[i][4 * j + 3]);
    }
  }
}

}  // namespace

extern "C" {

// the row tile: ops.py's ROW_TILE, checked by the wrapper once
int expert_gemm_row_tile() { return kBM; }

// x: [E, C, K], w: [E, K, N], y: [E, C, N], fp32 contiguous, N % 4 == 0,
// w and y 16-byte aligned; counts: [E] int32 on the device.  Enqueues one
// kernel on `stream` and returns the CUDA error of the launch (0 on
// success).
int expert_gemm(const void* x, const void* w, const void* counts, void* y,
                int E, int C, int K, int N, void* stream) {
  if (E < 1 || C < 1 || K < 1 || N < 1 || N % 4 != 0 || E > 65535 ||
      (C + kBM - 1) / kBM > 65535 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      expert_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  expert_gemm_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int*>(counts), static_cast<float*>(y), C, K, N);
  return static_cast<int>(cudaGetLastError());
}

const char* expert_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
