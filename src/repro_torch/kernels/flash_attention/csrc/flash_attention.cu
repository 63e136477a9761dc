// Causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
//   (body _flash_kernel), reached through
//   repro/kernels/flash_attention/ops.py::flash_attention.
//
// What bounds it on the H100: operations.  Causal attention does
// 2*2*Sq*Sk*hd/2 FLOP per (b, q-head) on inputs it reads once, hundreds of
// FLOP per byte.  The fp32 tolerance of the reference tests (2e-5) rules
// out TF32 tensor cores, so the arithmetic is plain fp32 FMA and the bound
// is the card's 67 TFLOP/s fp32 rate.  What the design does about it:
//   - one CTA per (q tile, q head, batch); the KV loop stops at the
//     diagonal, so the upper triangle costs nothing, and the element mask
//     runs only on tiles that cross the diagonal or the end of the keys;
//   - GQA is native: q head h reads kv head h / g, nothing is repeated;
//   - Q, K and V tiles are staged in shared memory in fp32 and each thread
//     computes a 4x4 block of scores and a 4 x hd/16 block of the output
//     from 16-byte shared loads, so FMAs, not loads, fill the issue slots;
//   - the running softmax (m, l) and the output stay in registers in fp32;
//     P reuses the K tile's shared memory, which keeps a CTA at ~100 KB and
//     two CTAs per SM;
//   - the heaviest q tiles (last rows, most keys) are launched first.
// Later redesigns (ROADMAP B2): bf16 through wgmma with TMA-fed tiles, and
// a warp-specialised pipeline that overlaps the tile loads with the math.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int BQ = 64;   // query rows per CTA
constexpr int BK = 64;   // keys per tile
constexpr int PS = BK + 4;  // row stride of the P tile (conflict-free stores)

template <int HD>
struct Smem {
  static constexpr int QS = HD + 4;  // row stride of Q and K tiles
  // the K tile's region, which holds the P tile once S is computed
  static constexpr int KP = BK * QS > BQ * PS ? BK * QS : BQ * PS;
  static constexpr int kFloats = BQ * QS + KP + BK * HD;
  static constexpr int kBytes = kFloats * sizeof(float);
};

// Copy rows [row0, row0 + rows) of one head into shared memory as fp32
// (row stride `dst_stride`), zero-filling rows at or past `limit`.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride,
                                          const T* src, int64_t row_stride,
                                          int row0, int limit, float mul) {
  using V = Vec16<T>;
  constexpr int CH = HD / V::N;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    float f[V::N];
    if (row0 + r < limit) {
      V::to_float(load16(src + (int64_t)(row0 + r) * row_stride + c * V::N), f);
    } else {
#pragma unroll
      for (int e = 0; e < V::N; ++e) f[e] = 0.f;
    }
    float* d = dst + r * dst_stride + c * V::N;
#pragma unroll
    for (int e = 0; e < V::N; e += 4)
      *reinterpret_cast<float4*>(d + e) =
          make_float4(f[e] * mul, f[e + 1] * mul, f[e + 2] * mul, f[e + 3] * mul);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
             int hq, int g, float scale, int q_sb, int q_ss, int q_sh,
             int k_sb, int k_ss, int k_sh, int v_sb, int v_ss, int v_sh) {
  constexpr int QS = Smem<HD>::QS;
  constexpr int DV = HD / 16;        // output columns per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BQ][QS], scaled, base 2
  float* sK = sQ + BQ * QS;                     // [BK][QS]; P [BQ][PS] after S
  float* sV = sK + Smem<HD>::KP;                // [BK][HD]

  const int qt = gridDim.x - 1 - blockIdx.x;    // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / g;
  const int q0 = qt * BQ;
  const int tr = threadIdx.x / 16;   // rows tr*4 .. tr*4+3
  const int tc = threadIdx.x % 16;   // score cols tc + 16c; out cols below

  load_tile<T, HD, BQ>(sQ, QS, q + (int64_t)b * q_sb + (int64_t)h * q_sh,
                       q_ss, q0, sq, scale * kLog2e);

  float m[4], l[4], o[4][DV];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegBig;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DV; ++e) o[r][e] = 0.f;
  }

  // keys 0 .. min(sk, q0 + BQ) - 1 can be seen by this tile's rows
  const int k_end = min(sk, q0 + BQ);
  const int n_tiles = (k_end + BK - 1) / BK;
  const T* kbase = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
  const T* vbase = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's P and V are consumed
    load_tile<T, HD, BK>(sK, QS, kbase, k_ss, k0, sk, 1.f);
    load_tile<T, HD, BK>(sV, HD, vbase, v_ss, k0, sk, 1.f);
    __syncthreads();

    // S = Q K^T for rows tr*4+r and cols tc+16c
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(sQ + (tr * 4 + r) * QS + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(sK + (tc + 16 * c) * QS + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qv[r].x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv[r].y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv[r].z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv[r].w, kv[c].w, s[r][c]);
        }
    }

    // element mask where the tile crosses the diagonal or the end of keys
    if (k0 + BK - 1 > q0 || k0 + BK > sk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = q0 + tr * 4 + r, col = k0 + tc + 16 * c;
          if (col > row || col >= sk) s[r][c] = kNegBig;
        }
    }

    // online softmax; a row's 16 column threads are lanes of one half-warp
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < DV; ++e) o[r][e] *= alpha;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = exp2f(s[r][c] - mn);
        l[r] += s[r][c];
      }
    }

    __syncthreads();  // every thread is done reading the K tile
    float* sP = sK;   // [BQ][PS]
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sP[(tr * 4 + r) * PS + tc + 16 * c] = s[r][c];
    __syncthreads();

    // O += P V for rows tr*4+r; columns: DV >= 4 as 16-byte chunks
    // tc + 16j, else DV consecutive columns from tc*DV
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pv[r] = *reinterpret_cast<const float4*>(sP + (tr * 4 + r) * PS + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float vv[DV];
        const float* vrow = sV + (kk + i) * HD;
        if constexpr (DV >= 4) {
#pragma unroll
          for (int j = 0; j < DV / 4; ++j) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + (tc + 16 * j) * 4);
            vv[4 * j] = x.x; vv[4 * j + 1] = x.y; vv[4 * j + 2] = x.z; vv[4 * j + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < DV; ++e) vv[e] = vrow[tc * DV + e];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = i == 0 ? pv[r].x : i == 1 ? pv[r].y : i == 2 ? pv[r].z : pv[r].w;
#pragma unroll
          for (int e = 0; e < DV; ++e) o[r][e] = fmaf(p, vv[e], o[r][e]);
        }
      }
    }
  }

  // finish: the row sums live spread over the row's 16 threads
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
    const int row = q0 + tr * 4 + r;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = out + (((int64_t)b * sq + row) * hq + h) * HD;
#pragma unroll
    for (int e = 0; e < DV; ++e) {
      const int col = DV >= 4 ? (tc + 16 * (e / 4)) * 4 + e % 4 : tc * DV + e;
      store(orow + col, o[r][e] * inv);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int batch, sq, sk, hq, g;
  float scale;
  int q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t launch(const Args& a) {
  constexpr int bytes = Smem<HD>::kBytes;
  // above 48 KB a block's shared memory must be opted into (per device, so
  // on every launch: it is a host-side attribute write)
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid((a.sq + BQ - 1) / BQ, a.hq, a.batch);
  flash_kernel<T, HD><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.sq, a.sk, a.hq,
      a.g, a.scale, a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb,
      a.v_ss, a.v_sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Args& a, int hd) {
  switch (hd) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: [B, Sq, Hq, hd]; k, v: [B, Sk, Hkv, hd], each with unit stride on hd
// and the given element strides for b, s and h; out: [B, Sq, Hq, hd]
// contiguous.  Causal: query i sees keys j <= i.  Returns the CUDA error of
// the launch (0 on success); the kernel runs on `stream`.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int dtype, int batch, int sq, int sk, int hq, int g,
                    int hd, float scale, int q_sb, int q_ss, int q_sh,
                    int k_sb, int k_ss, int k_sh, int v_sb, int v_ss,
                    int v_sh, void* stream) {
  if (batch < 1 || sq < 1 || sk < 1 || hq < 1 || g < 1 || hq % g != 0)
    return cudaErrorInvalidValue;
  Args a{q, k, v, out, batch, sq, sk, hq, g, scale,
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
         static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == kFloat32) err = dispatch_hd<float>(a, hd);
  else if (dtype == kBFloat16) err = dispatch_hd<__nv_bfloat16>(a, hd);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
