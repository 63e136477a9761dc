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
// dominate) on ~118 MB of inputs and outputs: ~0.12 ms at the 67 TFLOP/s
// fp32 rate against ~0.035 ms for the bytes.  The reference's fp32
// tolerances (y 2e-5, state 1e-4) rule out TF32, so the arithmetic is plain
// fp32 FMA on CUDA cores, and the card is filled only if there are many more
// CTAs than the B*H = 192 of a loop over the chunks.  So the scan runs as
// the four phases of the oracle's decomposition (ref.py::ssd_ref), each a
// kernel, in order on one stream, under the one entry point `ssd_scan`:
//   1. ssd_cb_kernel: C.B^T once per (batch, chunk, group), not per head,
//      over the lower triangle of 64x64 tiles only, into scratch
//      cb [B, nc, G, Q, Q] (upper entries of a diagonal tile are 0);
//   2. ssd_chunk_state_kernel, one CTA per (head, chunk, batch): the chunk's
//      own state contribution dS_c = sum_k exp(cum_last - cum_k) dt_k
//      x_k (x) B_k into scratch states [B, H, nc, P, N], and
//      exp(cum_last) into decay [B, H, nc]; the keys pass through shared
//      memory 64 rows at a time (53 KB);
//   3. ssd_state_pass_kernel, one thread per 4 state entries, sequential
//      over the chunks: S = exp(cum_last) S + dS_c (the fmaf of the
//      one-kernel design), from the initial state or zero; it overwrites
//      dS_c in place with the chunk's incoming state S_prev_c and writes
//      the final state;
//   4. ssd_chunk_scan_kernel, one CTA per (head, chunk and 64-row query
//      tile, batch): y = exp(cum_q) (C . S_prev_c) + (cb o L o dt_k) . x,
//      reading C.B^T from phase 1; each thread's score.x loop stops at its
//      own rows' diagonal.
// The scratch round trip (dS and S_prev, ~200 MB of traffic at full width)
// is the price of the chunk-parallel phases 2 and 4; it stays under the
// operations bound's time.  Within each phase:
//   - every product is a register-tiled loop over shared memory (4x4 score
//     tiles, 4 x P/16 output tiles, N/16 x P/16 state tiles per thread) fed
//     by 16-byte loads, and key tiles above the diagonal are skipped;
//   - global loads are issued kBatch at a time per thread before any is
//     stored to shared memory, so their latencies overlap;
//   - cum is recomputed by every CTA that needs it, in the oracle's order
//     (chunk_cumsum), so phases 2 and 4 see the same bits;
//   - exp(cum_q - cum_k) is taken only where k <= q, so it never overflows,
//     and never as a ratio of two exponentials, which would underflow;
//   - inputs are read in place through strides ([B,L,H,P], [B,L,G,N]): the
//     reference's transposes are not made.  The initial state seeds phase 3,
//     and a ragged last chunk is read as zero rows with dt = 0, the
//     reference's identity padding, so no input is copied;
//   - the scratch is allocated by the caller; the kernels allocate nothing.
// Later redesigns: tensor cores for bf16.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int QT = 64;          // query rows and key columns of one tile
constexpr int kScanBlock = 16;  // block of the cumsum order (ref.py::_cumsum)
constexpr int kBatch = 4;       // global loads a thread keeps in flight

// element strides of the inputs: x [B,L,H,P], dt [B,L,H], b and c [B,L,G,N]
struct Strides {
  int x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, b_sg, c_sb, c_sl, c_sg;
};

// Shared-memory row strides (floats): padded by 4 to spread banks
template <int P, int N>
struct Layout {
  static constexpr int XS = P + 4;  // x [k][XS]
  static constexpr int BS = N + 4;  // B and C [row][BS]
  static constexpr int SS = P + 4;  // state, kept as S^T [N][SS]
  __host__ __device__ static constexpr int tile(int q) {
    return q < QT ? q : QT;
  }
  // phase 1: the C and B rows of one tile
  __host__ __device__ static constexpr int cb_floats(int q) {
    return 2 * tile(q) * BS;
  }
  // phase 2: x (scaled by w) and B of one pass of tile(q) keys, then cum,
  // dt and the weights
  __host__ __device__ static constexpr int state_floats(int q) {
    return tile(q) * XS + tile(q) * BS + 3 * q;
  }
  // phase 4: C tile and S^T, then (same space) the score tile [qt][q + 4]
  // and x; then cum, exp(cum) and dt
  __host__ __device__ static constexpr int scan_floats(int q) {
    return (tile(q) * BS + N * SS > tile(q) * (q + 4) + q * XS
                ? tile(q) * BS + N * SS
                : tile(q) * (q + 4) + q * XS) + 3 * q;
  }
};

// Copy rows [0, rows) of a [rows][COLS] slab (row stride `row_stride`
// elements) into shared memory as fp32 (row stride `dst_stride`), rows at or
// past `limit` as zeros.  Each thread issues kBatch 16-byte loads before it
// stores any, so their latencies overlap.
template <typename T, int COLS>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride,
                                          const T* src, int64_t row_stride,
                                          int rows, int limit) {
  using V = Vec16<T>;
  constexpr int CH = COLS / V::N;  // 16-byte chunks per row
  const int total = rows * CH;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kThreads) {
    typename V::raw raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, r = i / CH, c = i % CH;
      if (i < total && r < limit)
        raw[u] = load16(src + (int64_t)r * row_stride + c * V::N);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, r = i / CH, c = i % CH;
      if (i >= total) continue;
      float f[V::N];
      if (r < limit) {
        V::to_float(raw[u], f);
      } else {
#pragma unroll
        for (int e = 0; e < V::N; ++e) f[e] = 0.f;
      }
      float* d = dst + r * dst_stride + c * V::N;
#pragma unroll
      for (int e = 0; e < V::N; e += 4)
        *reinterpret_cast<float4*>(d + e) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
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

// Load a chunk's dt (rows at or past lim: 0) into sDt[0, q)
__device__ __forceinline__ void load_dt(float* sDt, const float* dth,
                                        int64_t dt_sl, int l0, int q, int lim) {
  for (int k = threadIdx.x; k < q; k += kThreads)
    sDt[k] = k < lim ? dth[(int64_t)(l0 + k) * dt_sl] : 0.f;
}

// cum = cumsum(dt*a) over one chunk, called by the 32 lanes of warp 0,
// summed in the oracle's order (ref.py::_cumsum): left to right within
// blocks of 16 steps (one lane each), the blocks' totals likewise, then each
// block offset by the totals before it.  y is ill-conditioned in cum, so the
// order is kept exactly: _rn intrinsics keep the compiler from fusing the
// products into FMAs.  Every CTA that needs cum computes the same bits.
__device__ __forceinline__ void chunk_cumsum(const float* sDt, float ah,
                                             float* sCum, int q) {
  const int lane = threadIdx.x;
  const int nb = q / kScanBlock;  // at most 8
  float run = 0.f;
  if (lane < nb) {
#pragma unroll
    for (int j = 0; j < kScanBlock; ++j) {
      const int k = lane * kScanBlock + j;
      const float adt = __fmul_rn(sDt[k], ah);
      run = j == 0 ? adt : __fadd_rn(run, adt);
      sCum[k] = run;
    }
  }
  float before = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float t = __shfl_sync(0xffffffffu, run, i);
    if (i < lane && i < nb) before = i == 0 ? t : __fadd_rn(before, t);
  }
  if (lane < nb && lane > 0) {
#pragma unroll
    for (int j = 0; j < kScanBlock; ++j)
      sCum[lane * kScanBlock + j] = __fadd_rn(sCum[lane * kScanBlock + j], before);
  }
  __syncwarp();
}

// Phase 1.  Grid (lower-triangle tiles, nc, B*G).  cb[b, c, g][q][k] =
// C_q . B_k for k <= q (0 above the diagonal inside a diagonal tile).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
              float* __restrict__ cb, int seqlen, int groups, int q,
              Strides st) {
  constexpr int BS = N + 4;
  const int t = min(q, QT);
  // tiles in the order (0,0), (1,0), (1,1), (2,0), ...
  int ti = 0, tj = blockIdx.x;
  while (tj > ti) { tj -= ti + 1; ++ti; }
  const int ci = blockIdx.y, b = blockIdx.z / groups, gi = blockIdx.z % groups;
  const int nc = gridDim.y;
  const int l0 = ci * q, lim = min(q, seqlen - l0);
  extern __shared__ float4 smem4[];
  float* sC = reinterpret_cast<float*>(smem4);  // [t][BS], query rows
  float* sB = sC + t * BS;                      // [t][BS], key rows
  load_rows<T, N>(sC, BS, cm + (int64_t)b * st.c_sb + (int64_t)gi * st.c_sg +
                              (int64_t)(l0 + ti * t) * st.c_sl,
                  st.c_sl, t, lim - ti * t);
  load_rows<T, N>(sB, BS, bm + (int64_t)b * st.b_sb + (int64_t)gi * st.b_sg +
                              (int64_t)(l0 + tj * t) * st.b_sl,
                  st.b_sl, t, lim - tj * t);
  __syncthreads();
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  if (tr * 4 >= t) return;
  const int ncv = t / 16;  // column groups of 16 in the tile
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
      bv[c] = c < ncv ? *reinterpret_cast<const float4*>(sB + (tc + 16 * c) * BS + n)
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
  float* out = cb + (((int64_t)b * nc + ci) * groups + gi) * q * q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qq = ti * t + tr * 4 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= ncv) continue;
      const int kk = tj * t + tc + 16 * c;
      out[(int64_t)qq * q + kk] = kk <= qq ? s[r][c] : 0.f;
    }
  }
}

// Phase 2.  Grid (H, nc, B).  states[b, h, c][p][n] = dS_c, the chunk's own
// contribution sum_k B[k][n] (w_k x[k][p]) with w_k = exp(cum_last - cum_k)
// dt_k, and decay[b, h, c] = exp(cum_last).  The keys go through shared
// memory in passes of tile(q) rows.  Two CTAs an SM: held to three (85
// registers), the product loop spills.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ a, const T* __restrict__ bm,
                       float* __restrict__ states, float* __restrict__ decay,
                       int seqlen, int heads, int rep, int q, Strides st) {
  using Lay = Layout<P, N>;
  constexpr int XS = Lay::XS, BS = Lay::BS;
  constexpr int DV = P / 16;  // state columns (p) per thread
  constexpr int NR = N / 16;  // state rows (n) per thread
  const int kt = Lay::tile(q);
  extern __shared__ float4 smem4[];
  float* sX = reinterpret_cast<float*>(smem4);  // [kt][XS], then w_k x_k
  float* sB = sX + kt * XS;                     // [kt][BS]
  float* sDt = sB + kt * BS;                    // [q]
  float* sCum = sDt + q;                        // [q]
  float* sW = sCum + q;                         // [q]

  const int h = blockIdx.x, ci = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int tid = threadIdx.x;
  const int l0 = ci * q, lim = min(q, seqlen - l0);
  const T* xh = x + (int64_t)b * st.x_sb + (int64_t)h * st.x_sh + (int64_t)l0 * st.x_sl;
  const T* bh = bm + (int64_t)b * st.b_sb + (int64_t)(h / rep) * st.b_sg +
                (int64_t)l0 * st.b_sl;
  load_dt(sDt, dt + (int64_t)b * st.dt_sb + (int64_t)h * st.dt_sh, st.dt_sl, l0, q, lim);
  __syncthreads();
  if (tid < 32) {
    chunk_cumsum(sDt, a[h], sCum, q);
    const float last = sCum[q - 1];
    for (int k = tid; k < q; k += 32) sW[k] = expf(last - sCum[k]) * sDt[k];
    if (tid == 0) decay[((int64_t)b * heads + h) * nc + ci] = expf(last);
  }

  // dS^T[n][p] for rows n = tr*NR + r and cols p = tc*DV + e
  const int tr = tid / 16, tc = tid % 16;
  float acc[NR][DV];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[r][e] = 0.f;
  for (int k0 = 0; k0 < q; k0 += kt) {
    __syncthreads();  // sW is in; the last pass is done with sX, sB
    load_rows<T, P>(sX, XS, xh + (int64_t)k0 * st.x_sl, st.x_sl, kt, lim - k0);
    load_rows<T, N>(sB, BS, bh + (int64_t)k0 * st.b_sl, st.b_sl, kt, lim - k0);
    __syncthreads();
    for (int i = tid; i < kt * P; i += kThreads) sX[(i / P) * XS + i % P] *= sW[k0 + i / P];
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kt; ++k) {
      float xv[DV], bv[NR];
      load_w<DV>(sX + k * XS + tc * DV, xv);
      load_w<NR>(sB + k * BS + tr * NR, bv);
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int e = 0; e < DV; ++e) acc[r][e] = fmaf(bv[r], xv[e], acc[r][e]);
    }
  }
  float* out = states + (((int64_t)b * heads + h) * nc + ci) * P * N;
#pragma unroll
  for (int e = 0; e < DV; ++e) {
    float* row = out + (int64_t)(tc * DV + e) * N + tr * NR;
    if constexpr (NR % 4 == 0) {
#pragma unroll
      for (int r = 0; r < NR; r += 4)
        *reinterpret_cast<float4*>(row + r) =
            make_float4(acc[r][e], acc[r + 1][e], acc[r + 2][e], acc[r + 3][e]);
    } else {
#pragma unroll
      for (int r = 0; r < NR; ++r) row[r] = acc[r][e];
    }
  }
}

// Phase 3.  Grid (ceil(P*N/4 / kThreads), H, B); each thread carries 4
// entries of one (batch, head) state across the chunks, in place:
// states[.., c] goes from dS_c to S_prev_c.
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                      const float* __restrict__ init, float* __restrict__ state,
                      int heads, int nc, int pn4) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= pn4) return;
  const int64_t bh = (int64_t)blockIdx.z * heads + blockIdx.y;
  float4* s4 = reinterpret_cast<float4*>(states) + bh * nc * pn4 + i;
  const float* dec = decay + bh * nc;
  float4 s = init != nullptr ? reinterpret_cast<const float4*>(init)[bh * pn4 + i]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 d = s4[0];
  for (int c = 0; c < nc; ++c) {
    const float4 next = c + 1 < nc ? s4[(int64_t)(c + 1) * pn4] : d;
    const float e = dec[c];
    s4[(int64_t)c * pn4] = s;
    s.x = fmaf(s.x, e, d.x);
    s.y = fmaf(s.y, e, d.y);
    s.z = fmaf(s.z, e, d.z);
    s.w = fmaf(s.w, e, d.w);
    d = next;
  }
  reinterpret_cast<float4*>(state)[bh * pn4 + i] = s;
}

// Phase 4.  Grid (H, nc * Q/qt, B), qt = min(Q, 64) query rows per CTA.
// y rows q0 + tr*RT + r, cols tc*DV + e:
//   exp(cum_q) (C_q . S_prev)  +  sum_{k<=q} cb[q][k] exp(cum_q - cum_k) dt_k x_k
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 3)
ssd_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a, const T* __restrict__ cm,
                      const float* __restrict__ cb,
                      const float* __restrict__ states, float* __restrict__ y,
                      int seqlen, int heads, int rep, int q, Strides st) {
  using Lay = Layout<P, N>;
  constexpr int XS = Lay::XS, BS = Lay::BS, SS = Lay::SS;
  constexpr int DV = P / 16;  // y columns (p) per thread
  constexpr int RT = QT / 16;  // y rows per thread
  const int qt = Lay::tile(q), nqt = q / qt;
  const int GS = q + 4;       // row stride of the score tile
  extern __shared__ float4 smem4[];
  float* sC = reinterpret_cast<float*>(smem4);  // [qt][BS]    (stage 1)
  float* sS = sC + qt * BS;                     // [N][SS]     (stage 1)
  float* sG = reinterpret_cast<float*>(smem4);  // [qt][GS]    (stage 2)
  float* sX = sG + qt * GS;                     // [kend][XS]  (stage 2)
  float* sCum = reinterpret_cast<float*>(smem4) + Lay::scan_floats(q) - 3 * q;
  float* sEc = sCum + q;                        // [q] exp(cum)
  float* sDt = sEc + q;                         // [q]

  const int h = blockIdx.x, ci = blockIdx.y / nqt, b = blockIdx.z;
  const int q0 = (blockIdx.y % nqt) * qt;
  const int nc = gridDim.y / nqt;
  const int tid = threadIdx.x;
  const int l0 = ci * q, lim = min(q, seqlen - l0);
  const int kend = q0 + qt;  // keys this tile's rows can see
  const int g = h / rep;

  // stage 1: C . S_prev, scaled by exp(cum_q)
  load_rows<T, N>(sC, BS, cm + (int64_t)b * st.c_sb + (int64_t)g * st.c_sg +
                              (int64_t)(l0 + q0) * st.c_sl, st.c_sl, qt, lim - q0);
  {
    // S_prev [P][N] into S^T [N][SS]: lanes take 16 p's x 2 adjacent n4's,
    // so the 16-byte reads pair up into 32-byte sectors and the transposed
    // shared-memory writes hit 32 distinct banks
    const float4* sp = reinterpret_cast<const float4*>(
        states + (((int64_t)b * heads + h) * nc + ci) * P * N);
    constexpr int total = P * N / 4;
    for (int f0 = tid; f0 < total; f0 += kBatch * kThreads) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int f = f0 + u * kThreads, rest = f >> 1;
        if (f < total) v[u] = sp[(rest % P) * (N / 4) + 2 * (rest / P) + (f & 1)];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int f = f0 + u * kThreads, rest = f >> 1, p = rest % P;
        const int n4 = 2 * (rest / P) + (f & 1);
        if (f >= total) continue;
        sS[(4 * n4 + 0) * SS + p] = v[u].x;
        sS[(4 * n4 + 1) * SS + p] = v[u].y;
        sS[(4 * n4 + 2) * SS + p] = v[u].z;
        sS[(4 * n4 + 3) * SS + p] = v[u].w;
      }
    }
  }
  load_dt(sDt, dt + (int64_t)b * st.dt_sb + (int64_t)h * st.dt_sh, st.dt_sl, l0, q, lim);
  __syncthreads();
  if (tid < 32) {
    chunk_cumsum(sDt, a[h], sCum, q);
    for (int k = tid; k < q; k += 32) sEc[k] = expf(sCum[k]);
  }

  const int tr = tid / 16;  // rows tr*RT .. tr*RT+RT-1 of the tile
  const int tc = tid % 16;  // cols tc*DV .. tc*DV+DV-1
  const bool rows_in = tr * RT < qt;
  float acc[RT][DV];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[r][e] = 0.f;
  if (rows_in) {
#pragma unroll 2
    for (int n = 0; n < N; n += 4) {
      float4 cv[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
        cv[r] = *reinterpret_cast<const float4*>(sC + (tr * RT + r) * BS + n);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float sv[DV];
        load_w<DV>(sS + (n + i) * SS + tc * DV, sv);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float cc = lane_of(cv[r], i);
#pragma unroll
          for (int e = 0; e < DV; ++e) acc[r][e] = fmaf(cc, sv[e], acc[r][e]);
        }
      }
    }
  }
  __syncthreads();  // sCum and sEc are in; every thread is done with sC, sS
  if (rows_in) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float ec = sEc[q0 + tr * RT + r];
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[r][e] *= ec;
    }
  }

  // stage 2: scores G[r][k] = cb[q][k] exp(cum_q - cum_k) dt_k for k <= q,
  // else 0, then G . x
  const float* cbr = cb + (((int64_t)b * nc + ci) * (heads / rep) + g) * q * q +
                     (int64_t)q0 * q;
  const int kv = kend / 4;  // float4s of a score row
  for (int i0 = tid; i0 < qt * kv; i0 += kBatch * kThreads) {
    float4 cv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < qt * kv)
        cv[u] = *reinterpret_cast<const float4*>(cbr + (int64_t)(i / kv) * q + 4 * (i % kv));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, r = i / kv, k0 = 4 * (i % kv), qq = q0 + r;
      if (i >= qt * kv) continue;
      float gg[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + j;
        gg[j] = k <= qq ? lane_of(cv[u], j) * expf(sCum[qq] - sCum[k]) * sDt[k] : 0.f;
      }
      *reinterpret_cast<float4*>(sG + r * GS + k0) = make_float4(gg[0], gg[1], gg[2], gg[3]);
    }
  }
  load_rows<T, P>(sX, XS, x + (int64_t)b * st.x_sb + (int64_t)h * st.x_sh +
                              (int64_t)l0 * st.x_sl, st.x_sl, kend, lim);
  __syncthreads();
  if (!rows_in) return;
  // this thread's rows see keys up to q0 + tr*RT + RT - 1 only
#pragma unroll 2
  for (int k = 0; k < q0 + tr * RT + RT; k += 4) {
    float4 gv[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
      gv[r] = *reinterpret_cast<const float4*>(sG + (tr * RT + r) * GS + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float xv[DV];
      load_w<DV>(sX + (k + i) * XS + tc * DV, xv);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float gg = lane_of(gv[r], i);
#pragma unroll
        for (int e = 0; e < DV; ++e) acc[r][e] = fmaf(gg, xv[e], acc[r][e]);
      }
    }
  }
  const int64_t y_sl = (int64_t)heads * P;  // y: [B, L, H, P]
  float* yh = y + (int64_t)b * seqlen * y_sl + (int64_t)h * P;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = q0 + tr * RT + r;
    if (row >= lim) continue;
    float* yr = yh + (int64_t)(l0 + row) * y_sl + tc * DV;
#pragma unroll
    for (int e = 0; e < DV; ++e) yr[e] = acc[r][e];
  }
}

struct Args {
  const void *x, *dt, *a, *b, *c, *init;
  void *y, *state, *cb, *states, *decay;
  int batch, seqlen, heads, groups, chunk;
  Strides st;
  cudaStream_t stream;
};

constexpr int kMaxDevices = 64;

template <typename T, int P, int N>
cudaError_t launch(const Args& a) {
  using Lay = Layout<P, N>;
  constexpr int F = static_cast<int>(sizeof(float));
  // Above 48 KB a block's shared memory must be opted into, once per kernel
  // and device.  The largest chunk's size covers every smaller chunk.
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    constexpr auto smem = cudaFuncAttributeMaxDynamicSharedMemorySize;
    err = cudaFuncSetAttribute(ssd_cb_kernel<T, N>, smem, Lay::cb_floats(128) * F);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_chunk_state_kernel<T, P, N>, smem,
                                 Lay::state_floats(128) * F);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<T, P, N>, smem,
                                 Lay::scan_floats(128) * F);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  const int q = a.chunk, nc = (a.seqlen + q - 1) / q;
  const int nt = q / Lay::tile(q);  // query tiles per chunk
  const int rep = a.heads / a.groups;
  const T* x = static_cast<const T*>(a.x);
  const T* bm = static_cast<const T*>(a.b);
  const T* cm = static_cast<const T*>(a.c);
  const float* dt = static_cast<const float*>(a.dt);
  const float* av = static_cast<const float*>(a.a);
  float* cb = static_cast<float*>(a.cb);
  float* states = static_cast<float*>(a.states);
  float* decay = static_cast<float*>(a.decay);

  ssd_cb_kernel<T, N><<<dim3(nt * (nt + 1) / 2, nc, a.batch * a.groups),
                        kThreads, Lay::cb_floats(q) * F, a.stream>>>(
      bm, cm, cb, a.seqlen, a.groups, q, a.st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_state_kernel<T, P, N><<<dim3(a.heads, nc, a.batch), kThreads,
                                    Lay::state_floats(q) * F, a.stream>>>(
      x, dt, av, bm, states, decay, a.seqlen, a.heads, rep, q, a.st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr int pn4 = P * N / 4;
  ssd_state_pass_kernel<<<dim3((pn4 + kThreads - 1) / kThreads, a.heads, a.batch),
                          kThreads, 0, a.stream>>>(
      states, decay, static_cast<const float*>(a.init),
      static_cast<float*>(a.state), a.heads, nc, pn4);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_scan_kernel<T, P, N><<<dim3(a.heads, nc * nt, a.batch), kThreads,
                                   Lay::scan_floats(q) * F, a.stream>>>(
      x, dt, av, cm, cb, states, static_cast<float*>(a.y), a.seqlen, a.heads,
      rep, q, a.st);
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
// state: [B, H, P, N], both fp32 contiguous.  Scratch, fp32 contiguous, with
// nc = ceil(L / chunk): cb [B, nc, G, chunk, chunk], states [B, H, nc, P, N],
// decay [B, H, nc].  Enqueues four kernels on `stream` and returns the CUDA
// error of the launches (0 on success).
int ssd_scan(const void* x, const void* dt, const void* a, const void* b,
             const void* c, const void* init, void* y, void* state, void* cb,
             void* states, void* decay, int dtype, int batch, int seqlen,
             int heads, int groups, int p, int n, int chunk, int x_sb,
             int x_sl, int x_sh, int dt_sb, int dt_sl, int dt_sh, int b_sb,
             int b_sl, int b_sg, int c_sb, int c_sl, int c_sg, void* stream) {
  if (batch < 1 || seqlen < 1 || heads < 1 || groups < 1 || heads % groups != 0 ||
      (chunk != 16 && chunk != 32 && chunk != 64 && chunk != 128) ||
      batch > 65535 || batch * groups > 65535 ||
      (int64_t)((seqlen + chunk - 1) / chunk) * (chunk / (chunk < QT ? chunk : QT)) > 65535)
    return cudaErrorInvalidValue;
  Args args{x, dt, a, b, c, init, y, state, cb, states, decay,
            batch, seqlen, heads, groups, chunk,
            {x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, b_sg, c_sb, c_sl, c_sg},
            static_cast<cudaStream_t>(stream)};
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
