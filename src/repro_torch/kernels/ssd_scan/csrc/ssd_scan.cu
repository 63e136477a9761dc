// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   repro/kernels/ssd_scan/ssd_scan.py::ssd_pallas (body _ssd_kernel),
//   reached through repro/kernels/ssd_scan/ops.py::ssd.
//
// Per (batch b, head h), over chunks of Q steps, with cum = cumsum(dt*a)
// inside the chunk and the state S [P, N] carried from chunk to chunk:
//   y_q = sum_{k<=q} (C_q . B_k) exp(cum_q - cum_k) dt_k x_k
//         + exp(cum_q) C_q . S                         (S from before the chunk)
//   S   = exp(cum_{Q-1}) S + sum_k exp(cum_{Q-1} - cum_k) dt_k x_k (x) B_k
// Heads share B and C by group (group h / (H/G)).
//
// What bounds it on the H100: operations.  At the full-width mamba2-780m
// prefill (B=4, L=1024, H=48, P=64, G=1, N=128, Q=128) the work is about
// 8 GFLOP (the C.S and state-update products, Q*N*P each per chunk and head,
// dominate) on ~112 MB of inputs and outputs: ~0.12 ms at the 67 TFLOP/s
// fp32 rate against ~0.03 ms for the bytes.  The reference's fp32 tolerances
// (y 2e-5, state 1e-4) rule out TF32, so the arithmetic is plain fp32 FMA on
// CUDA cores.  What the design does about it:
//   - the TPU grid's sequential chunk axis becomes a loop inside one CTA per
//     (head, batch); the state stays in shared memory for the whole sequence
//     and never goes through device memory;
//   - a chunk's x and B rows are staged once in shared memory as fp32; C is
//     staged 64 query rows at a time, so Q=128, N=128, P=64 fits in ~202 KB;
//   - every product is a register-tiled loop over shared memory (4x4 score
//     tiles, 4 x P/16 output tiles, N/16 x P/16 state tiles per thread) fed
//     by 16-byte loads, and the score tile skips key blocks above the
//     diagonal;
//   - exp(cum_q - cum_k) is taken only where k <= q, so it never overflows,
//     and never as a ratio of two exponentials, which would underflow;
//   - inputs are read in place through strides ([B,L,H,P], [B,L,G,N]): the
//     reference's transposes are not made.  The initial state seeds S at the
//     first chunk, and a ragged last chunk is read as zero rows with dt = 0,
//     the reference's identity padding, so no input is copied.
// Later redesigns: compute C.B^T once per (batch, group, chunk) instead of
// once per head, split P across CTAs for more than B*H CTAs, and tensor
// cores for bf16.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int QT = 64;   // query rows of one score tile
constexpr int kScanBlock = 16;  // block of the cumsum order (ref.py::_cumsum)

template <int P, int N>
struct Layout {
  static constexpr int XS = P + 4;  // row stride of x [Q][XS]
  static constexpr int BS = N + 4;  // row stride of B [Q][BS] and C [QT][BS]
  static constexpr int SS = P + 4;  // row stride of the state, kept as [N][SS]
  // shared floats for chunk length q: x, B, C tile, state, score tile
  // [QT][q + 4], then cum, exp(cum), dt and the state-update weights
  static constexpr int floats(int q) {
    return q * XS + q * BS + (q < QT ? q : QT) * BS + N * SS +
           (q < QT ? q : QT) * (q + 4) + 4 * q;
  }
};

// Copy rows [0, rows) of a [rows][COLS] slab (row stride `row_stride`
// elements) into shared memory as fp32 (row stride `dst_stride`), rows at or
// past `limit` as zeros.
template <typename T, int COLS>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride,
                                          const T* src, int64_t row_stride,
                                          int rows, int limit) {
  using V = Vec16<T>;
  constexpr int CH = COLS / V::N;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    float f[V::N];
    if (r < limit) {
      V::to_float(load16(src + (int64_t)r * row_stride + c * V::N), f);
    } else {
#pragma unroll
      for (int e = 0; e < V::N; ++e) f[e] = 0.f;
    }
    float* d = dst + r * dst_stride + c * V::N;
#pragma unroll
    for (int e = 0; e < V::N; e += 4)
      *reinterpret_cast<float4*>(d + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

// W consecutive floats from shared memory (W in 1, 2, 4, 8)
template <int W>
__device__ __forceinline__ void load_w(const float* p, float* out) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    }
  } else if constexpr (W == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
    out[0] = p[0];
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ init,
           float* __restrict__ y, float* __restrict__ state, int seqlen,
           int heads, int rep, int q, int x_sb, int x_sl, int x_sh,
           int dt_sb, int dt_sl, int dt_sh, int b_sb, int b_sl, int b_sg,
           int c_sb, int c_sl, int c_sg) {
  using Lay = Layout<P, N>;
  constexpr int XS = Lay::XS, BS = Lay::BS, SS = Lay::SS;
  constexpr int DV = P / 16;  // y and state columns (p) per thread
  constexpr int NR = N / 16;  // state rows (n) per thread
  const int qt = min(q, QT);
  const int GS = q + 4;       // row stride of the score tile
  extern __shared__ float4 smem4[];
  float* sX = reinterpret_cast<float*>(smem4);  // [q][XS]
  float* sB = sX + q * XS;                      // [q][BS]
  float* sC = sB + q * BS;                      // [qt][BS], rows q0..q0+qt-1
  float* sS = sC + qt * BS;                     // [N][SS], the state S^T
  float* sG = sS + N * SS;                      // [qt][GS]
  float* sCum = sG + qt * GS;                   // [q] cumsum(dt*a)
  float* sEc = sCum + q;                        // [q] exp(cum)
  float* sDt = sEc + q;                         // [q] dt
  float* sW = sDt + q;                          // [q] exp(cum_last - cum) dt

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tr = tid / 16;  // rows tr*4 .. tr*4+3 of the score and y tiles
  const int tc = tid % 16;  // score cols tc + 16c; y and state cols tc*DV + e
  const float ah = a[h];

  const T* xh = x + (int64_t)b * x_sb + (int64_t)h * x_sh;
  const float* dth = dt + (int64_t)b * dt_sb + (int64_t)h * dt_sh;
  const T* bh = bm + (int64_t)b * b_sb + (int64_t)(h / rep) * b_sg;
  const T* ch = cm + (int64_t)b * c_sb + (int64_t)(h / rep) * c_sg;
  const int64_t y_sl = (int64_t)heads * P;               // y: [B, L, H, P]
  float* yh = y + (int64_t)b * seqlen * y_sl + (int64_t)h * P;
  const int64_t s_off = ((int64_t)b * heads + h) * P * N;  // state: [B,H,P,N]

  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    sS[n * SS + p] = init != nullptr ? init[s_off + i] : 0.f;
  }

  const int n_chunks = (seqlen + q - 1) / q;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int l0 = ci * q;
    const int lim = min(q, seqlen - l0);  // rows at or past lim: zero, dt = 0
    __syncthreads();  // the previous chunk is done with sX, sB, sS, sW
    load_rows<T, P>(sX, XS, xh + (int64_t)l0 * x_sl, x_sl, q, lim);
    load_rows<T, N>(sB, BS, bh + (int64_t)l0 * b_sl, b_sl, q, lim);
    if (tid < q) sDt[tid] = tid < lim ? dth[(int64_t)(l0 + tid) * dt_sl] : 0.f;
    __syncthreads();
    if (tid < 32) {
      // cum = cumsum(dt*a), summed in the oracle's order (ref.py::_cumsum):
      // left to right within blocks of 16 steps (one lane each), the blocks'
      // totals likewise, then each block offset by the totals before it.
      // y is ill-conditioned in cum, so the order is kept exactly: _rn
      // intrinsics keep the compiler from fusing the products into FMAs.
      const int nb = q / kScanBlock;  // at most 8
      float run = 0.f;
      if (tid < nb) {
#pragma unroll
        for (int j = 0; j < kScanBlock; ++j) {
          const int k = tid * kScanBlock + j;
          const float adt = __fmul_rn(sDt[k], ah);
          run = j == 0 ? adt : __fadd_rn(run, adt);
          sCum[k] = run;
        }
      }
      float before = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float t = __shfl_sync(0xffffffffu, run, i);
        if (i < tid && i < nb) before = i == 0 ? t : __fadd_rn(before, t);
      }
      if (tid < nb && tid > 0) {
#pragma unroll
        for (int j = 0; j < kScanBlock; ++j)
          sCum[tid * kScanBlock + j] = __fadd_rn(sCum[tid * kScanBlock + j], before);
      }
      __syncwarp();
      const float last = sCum[q - 1];
      for (int k = tid; k < q; k += 32) {
        sEc[k] = expf(sCum[k]);
        sW[k] = expf(last - sCum[k]) * sDt[k];
      }
    }

    for (int q0 = 0; q0 < q; q0 += qt) {
      __syncthreads();  // sCum, sEc, sW are in; the last tile is done with sC, sG
      load_rows<T, N>(sC, BS, ch + (int64_t)(l0 + q0) * c_sl, c_sl, qt, lim - q0);
      __syncthreads();
      const int kend = q0 + qt;  // keys this tile's rows can see
      const bool rows_in = tr * 4 < qt;

      // scores G[q][k] = (C_q . B_k) exp(cum_q - cum_k) dt_k for k <= q, else 0
      if (rows_in) {
        for (int k0 = 0; k0 < kend; k0 += 64) {
          const int ncv = min(4, (kend - k0) / 16);  // column groups in range
          float s[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
          for (int n = 0; n < N; n += 4) {
            float4 cv[4], bv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              cv[r] = *reinterpret_cast<const float4*>(sC + (tr * 4 + r) * BS + n);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              bv[c] = c < ncv ? *reinterpret_cast<const float4*>(sB + (k0 + tc + 16 * c) * BS + n)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                s[r][c] = fmaf(cv[r].x, bv[c].x, s[r][c]);
                s[r][c] = fmaf(cv[r].y, bv[c].y, s[r][c]);
                s[r][c] = fmaf(cv[r].z, bv[c].z, s[r][c]);
                s[r][c] = fmaf(cv[r].w, bv[c].w, s[r][c]);
              }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int qq = q0 + tr * 4 + r;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (c >= ncv) continue;
              const int kk = k0 + tc + 16 * c;
              const float g = kk <= qq ? s[r][c] * expf(sCum[qq] - sCum[kk]) * sDt[kk] : 0.f;
              sG[(tr * 4 + r) * GS + kk] = g;
            }
          }
        }
      }
      __syncthreads();

      // y rows q0 + tr*4 + r, cols tc*DV + e:  G x  +  exp(cum_q) C S
      if (rows_in) {
        float acc[4][DV], off[4][DV];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < DV; ++e) acc[r][e] = off[r][e] = 0.f;
#pragma unroll 2
        for (int k = 0; k < kend; k += 4) {
          float4 gv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            gv[r] = *reinterpret_cast<const float4*>(sG + (tr * 4 + r) * GS + k);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float xv[DV];
            load_w<DV>(sX + (k + i) * XS + tc * DV, xv);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float g = lane_of(gv[r], i);
#pragma unroll
              for (int e = 0; e < DV; ++e) acc[r][e] = fmaf(g, xv[e], acc[r][e]);
            }
          }
        }
#pragma unroll 2
        for (int n = 0; n < N; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = *reinterpret_cast<const float4*>(sC + (tr * 4 + r) * BS + n);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float sv[DV];
            load_w<DV>(sS + (n + i) * SS + tc * DV, sv);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float cc = lane_of(cv[r], i);
#pragma unroll
              for (int e = 0; e < DV; ++e) off[r][e] = fmaf(cc, sv[e], off[r][e]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = q0 + tr * 4 + r;
          if (row >= lim) continue;
          const float ec = sEc[row];
          float* yr = yh + (int64_t)(l0 + row) * y_sl + tc * DV;
#pragma unroll
          for (int e = 0; e < DV; ++e) yr[e] = acc[r][e] + ec * off[r][e];
        }
      }
    }
    __syncthreads();  // every y row has read the old state

    // S^T[n][p] = exp(cum_last) S^T[n][p] + sum_k B[k][n] (w_k x[k][p]),
    // rows n = tr*NR + r and cols p = tc*DV + e owned by this thread
    {
      const float decay = sEc[q - 1];
      float acc[NR][DV];
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int e = 0; e < DV; ++e) acc[r][e] = 0.f;
#pragma unroll 4
      for (int k = 0; k < q; ++k) {
        const float w = sW[k];
        float xv[DV], bv[NR];
        load_w<DV>(sX + k * XS + tc * DV, xv);
        load_w<NR>(sB + k * BS + tr * NR, bv);
#pragma unroll
        for (int e = 0; e < DV; ++e) xv[e] *= w;
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int e = 0; e < DV; ++e) acc[r][e] = fmaf(bv[r], xv[e], acc[r][e]);
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float* srow = sS + (tr * NR + r) * SS + tc * DV;
#pragma unroll
        for (int e = 0; e < DV; ++e) srow[e] = fmaf(srow[e], decay, acc[r][e]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    state[s_off + i] = sS[n * SS + p];
  }
}

struct Args {
  const void *x, *dt, *a, *b, *c, *init;
  void *y, *state;
  int batch, seqlen, heads, groups, chunk;
  int x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, b_sg, c_sb, c_sl, c_sg;
  cudaStream_t stream;
};

constexpr int kMaxDevices = 64;

template <typename T, int P, int N>
cudaError_t launch(const Args& a) {
  // Above 48 KB a block's shared memory must be opted into, once per kernel
  // and device.  The largest chunk's size covers every smaller chunk.
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(
        ssd_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<P, N>::floats(128) * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  const int bytes = Layout<P, N>::floats(a.chunk) * static_cast<int>(sizeof(float));
  dim3 grid(a.heads, a.batch);
  ssd_kernel<T, P, N><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.a), static_cast<const T*>(a.b),
      static_cast<const T*>(a.c), static_cast<const float*>(a.init),
      static_cast<float*>(a.y), static_cast<float*>(a.state), a.seqlen,
      a.heads, a.heads / a.groups, a.chunk, a.x_sb, a.x_sl, a.x_sh, a.dt_sb,
      a.dt_sl, a.dt_sh, a.b_sb, a.b_sl, a.b_sg, a.c_sb, a.c_sl, a.c_sg);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_n(const Args& a, int n) {
  switch (n) {
    case 16: return launch<T, P, 16>(a);
    case 32: return launch<T, P, 32>(a);
    case 64: return launch<T, P, 64>(a);
    case 128: return launch<T, P, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_p(const Args& a, int p, int n) {
  switch (p) {
    case 16: return dispatch_n<T, 16>(a, n);
    case 32: return dispatch_n<T, 32>(a, n);
    case 64: return dispatch_n<T, 64>(a, n);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: [B, L, H, P]; b, c: [B, L, G, N] (x, b, c of one dtype, unit stride on
// the last axis, the given element strides for batch, step and head/group);
// dt: [B, L, H] fp32 with the given strides; a: [H] fp32; init: [B, H, P, N]
// fp32 contiguous, or null for a zero state.  Writes y: [B, L, H, P] and
// state: [B, H, P, N], both fp32 contiguous.  Returns the CUDA error of the
// launch (0 on success); the kernel runs on `stream`.
int ssd_scan(const void* x, const void* dt, const void* a, const void* b,
             const void* c, const void* init, void* y, void* state, int dtype,
             int batch, int seqlen, int heads, int groups, int p, int n,
             int chunk, int x_sb, int x_sl, int x_sh, int dt_sb, int dt_sl,
             int dt_sh, int b_sb, int b_sl, int b_sg, int c_sb, int c_sl,
             int c_sg, void* stream) {
  if (batch < 1 || seqlen < 1 || heads < 1 || groups < 1 || heads % groups != 0 ||
      (chunk != 16 && chunk != 32 && chunk != 64 && chunk != 128))
    return cudaErrorInvalidValue;
  Args args{x, dt, a, b, c, init, y, state, batch, seqlen, heads, groups, chunk,
            x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, b_sg,
            c_sb, c_sl, c_sg, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == kFloat32) err = dispatch_p<float>(args, p, n);
  else if (dtype == kBFloat16) err = dispatch_p<__nv_bfloat16>(args, p, n);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
