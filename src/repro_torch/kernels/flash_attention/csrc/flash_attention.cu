// Causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
//   (body _flash_kernel), reached through
//   repro/kernels/flash_attention/ops.py::flash_attention.
//
// What bounds it on the H100: operations.  Causal attention does
// 2*2*Sq*Sk*hd/2 FLOP per (b, q-head) on inputs it reads once, hundreds of
// FLOP per byte.  Both products run on the tensor cores in TF32
// (mma.sync m16n8k8).  Plain TF32 keeps 10 mantissa bits and misses the
// reference's 2e-5 fp32 tolerance by ~80x, so every fp32 operand is split
// as x = hi + lo (hi = x rounded to tf32, lo = x - hi, which the tensor
// cores truncate to tf32) and each product is hi*lo' + lo*hi' + hi*hi'
// (3xTF32, the small terms first), accumulated in fp32.  Its error against
// an fp64 computation stays at fp32's own, also where a peaky softmax
// (inputs x3) moves both (chip_smoke.py phase 2).  The fp32 bound is 3x
// the FLOP over the 495 TFLOP/s TF32 rate.  bf16 is exact in tf32 (lo = 0):
// Q.K^T takes one pass, P.V two (P is fp32 and keeps its split); its bound
// is the FLOP over the 989 TFLOP/s bf16 rate, which this TF32 route cannot
// approach.
// What the design does about it:
//   - one CTA of four warps per (q tile of 64 rows, q head, batch); each
//     warp owns 16 query rows, so a warp's S tile (16 x 64 keys) and its
//     output (16 x hd) are mma accumulators in registers;
//   - P never leaves registers: P.V sums over keys, so its k index follows
//     the S accumulators' layout (keys 2t, 2t+1 of each 8-key group go to
//     columns t, t+4) and V's B fragment reads its rows in that order;
//   - the other free indices are chosen for 16-byte shared loads: the d
//     order of Q.K^T (thread t reads d = 4E*blk + E*t .. +E, E elements of
//     16 bytes, as its k columns t and t+4 of E/2 k-steps) and the output
//     columns of P.V (thread g reads hd = 8W*c + W*g .. +W of a V row), so
//     a thread stores 2W consecutive output columns;
//   - row pads make those loads conflict-free: Q and K rows of 128 bytes
//     or more padded to end at 64 mod 128 bytes (two rows per 8-lane
//     phase; bf16 at hd=96 already does, 192 bytes), V rows plus 16 bytes
//     (rows 2t, 2t+1 and column groups g of a phase land in distinct banks);
//   - W divides the hd/8 output n tiles (hd=96 in bf16: 4 of 12, so a
//     thread stores 8 bf16, 16 bytes); a tile row is copied by a power of
//     two of threads (hd=96: 32 in fp32, 16 in bf16, for its 24 or 12
//     16-byte chunks; the rest idle), so every thread's copies advance by
//     one constant stride;
//   - K and V tiles of 64 keys arrive by cp.async (16 bytes, zero-filled
//     past the end of the keys), staggered: V_t lands while S_t = Q K_t^T
//     and the softmax run, K_{t+1} while P V_t runs.  Two barriers a tile,
//     one buffer each (~105 KB a CTA at hd=128 fp32), so two CTAs (eight
//     warps) share an SM; double-buffering both would need ~178 KB and
//     leave one CTA of four warps an SM;
//   - the split is made per warp as a fragment is loaded (an integer add
//     and mask for hi, a subtract for lo: three ALU operations an element),
//     which keeps the tiles single-sized in shared memory;
//   - the KV loop stops at the diagonal, so the upper triangle costs
//     nothing, and the element mask runs only on tiles that cross the
//     diagonal or the end of the keys; GQA is native: q head h reads kv
//     head h / g;
//   - scores are scaled by scale*log2(e) after Q.K^T (bf16 Q stays exact in
//     tf32) and the online softmax (m, l) uses exp2f, in fp32;
//   - the q tile is the grid's slowest index and runs from the last (most
//     keys) to the first, so the heaviest CTAs of every head start first.
// Tried on the H100 and slower: 128-row CTAs of eight warps (one an SM),
// 32-key tiles at three CTAs an SM, skipping a warp's masked n tiles on the
// diagonal (the early exit breaks the unrolled schedule), and cvt.rna for
// the split; ordering the passes over independent accumulators by hand
// changed nothing (the compiler already interleaves them).  What bounds it
// now is the rate of mma.sync itself: fp32 and bf16 take about the same
// time per mma, so the time follows the pass count.  Later redesigns
// (ROADMAP B2): wgmma with TMA-fed tiles (tf32 wgmma needs K-major
// operands, so V transposed), and warp specialisation.
#include <type_traits>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 128;  // four warps
constexpr int BQ = 64;         // query rows per CTA, 16 a warp
constexpr int BK = 64;         // keys per tile

constexpr int cmin(int a, int b) { return a < b ? a : b; }
// the largest w' <= w, halving from w, that divides n
__host__ __device__ constexpr int divisor_at_most(int w, int n) {
  return n % w == 0 ? w : divisor_at_most(w / 2, n);
}

template <typename T, int HD>
struct Cfg {
  static constexpr int kSize = static_cast<int>(sizeof(T));
  // fp32 operands are split into hi + lo; bf16 ones are exact in tf32
  static constexpr bool kSplit = std::is_same<T, float>::value;
  // Q.K^T: a thread loads E consecutive d of a row (16 bytes, or hd / 4),
  // its k columns t and t+4 of E / 2 k-steps
  static constexpr int E = cmin(16 / kSize, HD / 4);
  static constexpr int NT = HD / 8;  // n tiles of the output
  // P.V: a thread loads W consecutive output columns of a V row (up to 16
  // bytes), W dividing NT
  static constexpr int W = divisor_at_most(cmin(16 / kSize, NT), NT);
  // Q and K rows of 128 bytes or more end at 64 mod 128 bytes
  static constexpr int kRowBytes = HD * kSize;
  static constexpr int LDQK =
      HD + (kRowBytes >= 128 ? (192 - kRowBytes % 128) % 128 / kSize : 0);
  static constexpr int LDV = HD + 16 / kSize;
  static constexpr int kBytes = ((BQ + BK) * LDQK + BK * LDV) * kSize;
  static_assert(E % 2 == 0 && HD % (4 * E) == 0 && NT % W == 0, "tiling");
};

// Raw register type of B bytes
template <int B> struct Raw;
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// N consecutive elements of T from shared memory, as fp32
template <typename T, int N>
__device__ __forceinline__ void lds(const T* p, float (&f)[N]) {
  using R = typename Raw<N * static_cast<int>(sizeof(T))>::type;
  const R r = *reinterpret_cast<const R*>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&r);
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = __uint_as_float(w[i]);
  } else {  // bf16 is the upper half of an fp32
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// N consecutive elements of T to global memory (N * sizeof(T) a multiple
// of 8 bytes, aligned to it)
template <typename T, int N>
__device__ __forceinline__ void stg(T* p, const float (&f)[N]) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
  } else {
    uint32_t w[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (N >= 8) {
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
        reinterpret_cast<uint4*>(p)[i] =
            make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    }
  }
}

// Start copying rows [row0, row0 + ROWS) of one head into shared memory
// (row stride `ld` elements), zero-filling rows at or past `limit`.  LANES
// threads (a power of two) share a row; a thread copies one 16-byte column
// chunk of every (kThreads / LANES)-th row, so its addresses advance by a
// constant stride, and a row's threads past its CH chunks copy nothing.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int row_stride, int row0,
                                          int limit) {
  constexpr int PER = 16 / static_cast<int>(sizeof(T));
  constexpr int CH = HD / PER;         // 16-byte chunks per row
  constexpr int LANES = pow2_at_least(CH);
  constexpr int RPI = kThreads / LANES;  // rows per pass
  static_assert(HD % PER == 0 && kThreads % LANES == 0 && ROWS % RPI == 0,
                "whole passes");
  const int r = threadIdx.x / LANES, c = threadIdx.x % LANES;
  if (c >= CH) return;
  const T* s = src + (int64_t)(row0 + r) * row_stride + c * PER;
  T* d = dst + r * ld + c * PER;
#pragma unroll
  for (int it = 0; it < ROWS / RPI; ++it) {
    const bool ok = row0 + r + it * RPI < limit;
    cp_async16(d + it * RPI * ld,
               ok ? s + (int64_t)it * RPI * row_stride : src, ok);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
             int hq, int g, float scale, int q_sb, int q_ss, int q_sh,
             int k_sb, int k_ss, int k_sh, int v_sb, int v_ss, int v_sh) {
  using C = Cfg<T, HD>;
  constexpr int E = C::E, W = C::W, NT = C::NT;
  constexpr int LDQK = C::LDQK, LDV = C::LDV;
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);  // [BQ][LDQK]
  T* sK = sQ + BQ * LDQK;               // [BK][LDQK]
  T* sV = sK + BK * LDQK;               // [BK][LDV]

  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / g;
  const int q0 = qt * BQ;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int r0 = threadIdx.x / 32 * 16 + gid;  // rows r0, r0 + 8 of the tile

  const T* kbase = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
  const T* vbase = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;
  // keys 0 .. min(sk, q0 + BQ) - 1 can be seen by this tile's rows
  const int k_end = min(sk, q0 + BQ);
  const int n_tiles = (k_end + BK - 1) / BK;

  load_tile<T, HD, BQ>(sQ, LDQK, q + (int64_t)b * q_sb + (int64_t)h * q_sh,
                       q_ss, q0, sq);
  load_tile<T, HD, BK>(sK, LDQK, kbase, k_ss, 0, sk);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  float o[NT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    cp_async_wait<0>();
    __syncthreads();  // K_t (and Q) landed; every warp is done with V_{t-1}
    load_tile<T, HD, BK>(sV, LDV, vbase, v_ss, k0, sk);
    cp_async_commit();

    // S = Q K_t^T: n tile j holds keys k0 + 8j .. + 7
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int blk = 0; blk < HD / (4 * E); ++blk) {
      const int d = 4 * E * blk + E * tig;
      float qa[E], qb[E];
      lds<T, E>(sQ + r0 * LDQK + d, qa);
      lds<T, E>(sQ + (r0 + 8) * LDQK + d, qb);
      uint32_t ahi[E / 2][4], alo[E / 2][4];
#pragma unroll
      for (int kk = 0; kk < E / 2; ++kk) {
        const float a[4] = {qa[2 * kk], qb[2 * kk], qa[2 * kk + 1],
                            qb[2 * kk + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (C::kSplit) split_tf32(a[e], ahi[kk][e], alo[kk][e]);
          else ahi[kk][e] = __float_as_uint(a[e]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float kr[E];
        lds<T, E>(sK + (j * 8 + gid) * LDQK + d, kr);
#pragma unroll
        for (int kk = 0; kk < E / 2; ++kk) {
          if constexpr (C::kSplit) {
            uint32_t h0, l0, h1, l1;
            split_tf32(kr[2 * kk], h0, l0);
            split_tf32(kr[2 * kk + 1], h1, l1);
            mma_tf32(s[j], alo[kk], h0, h1);
            mma_tf32(s[j], ahi[kk], l0, l1);
            mma_tf32(s[j], ahi[kk], h0, h1);
          } else {
            mma_tf32(s[j], ahi[kk], __float_as_uint(kr[2 * kk]),
                     __float_as_uint(kr[2 * kk + 1]));
          }
        }
      }
    }

    // base-2 scores; element mask where the tile crosses the diagonal or
    // the end of the keys.  s[j][e]: row r0 + 8 (e / 2), key 8j + 2t + e % 2
    const bool edge = k0 + BK - 1 > q0 || k0 + BK > sk;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= sl2;
        if (edge) {
          const int row = q0 + r0 + 8 * (e / 2);
          const int col = k0 + 8 * j + 2 * tig + e % 2;
          if (col > row || col >= sk) s[j][e] = -INFINITY;
        }
      }

    // online softmax for rows r0 (i = 0) and r0 + 8 (i = 1); a row's 64
    // scores lie on the four lanes of a quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[i], mx);
      const float base = mn == -INFINITY ? 0.f : mn;  // a row all masked
      const float alpha = exp2f(m[i] - base);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[j][2 * i] = exp2f(s[j][2 * i] - base);
        s[j][2 * i + 1] = exp2f(s[j][2 * i + 1] - base);
        sum += s[j][2 * i] + s[j][2 * i + 1];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }

    cp_async_wait<0>();
    __syncthreads();  // V_t landed; every warp is done with K_t
    if (t + 1 < n_tiles)
      load_tile<T, HD, BK>(sK, LDQK, kbase, k_ss, k0 + BK, sk);
    cp_async_commit();

    // O += P V_t.  k-step j = S's n tile j: A = {P[g][2t], P[g+8][2t],
    // P[g][2t+1], P[g+8][2t+1]} straight from the accumulators, so B's k
    // rows t, t+4 are the keys 8j + 2t, 8j + 2t + 1; n tile
    // n = c * W + w, column g of it is hd column 8W*c + W*g + w
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
      uint32_t phi[4], plo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(p[e], phi[e], plo[e]);
      const T* vrow = sV + (8 * j + 2 * tig) * LDV + W * gid;
#pragma unroll
      for (int c = 0; c < NT / W; ++c) {
        float va[W], vb[W];
        lds<T, W>(vrow + 8 * W * c, va);
        lds<T, W>(vrow + LDV + 8 * W * c, vb);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          float(&acc)[4] = o[c * W + w];
          if constexpr (C::kSplit) {
            uint32_t h0, l0, h1, l1;
            split_tf32(va[w], h0, l0);
            split_tf32(vb[w], h1, l1);
            mma_tf32(acc, plo, h0, h1);
            mma_tf32(acc, phi, l0, l1);
            mma_tf32(acc, phi, h0, h1);
          } else {
            const uint32_t b0 = __float_as_uint(va[w]);
            const uint32_t b1 = __float_as_uint(vb[w]);
            mma_tf32(acc, plo, b0, b1);
            mma_tf32(acc, phi, b0, b1);
          }
        }
      }
    }
  }

  // finish: a row's sum lies on the four lanes of its quad; this thread
  // holds output columns 8W*c + 2W*t .. + 2W of rows r0 and r0 + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = q0 + r0 + 8 * i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + (((int64_t)b * sq + row) * hq + h) * HD + 2 * W * tig;
#pragma unroll
    for (int c = 0; c < NT / W; ++c) {
      float f[2 * W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        f[w] = o[c * W + w][2 * i] * inv;
        f[W + w] = o[c * W + w][2 * i + 1] * inv;
      }
      stg<T, 2 * W>(orow + 8 * W * c, f);
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
  constexpr int bytes = Cfg<T, HD>::kBytes;
  // above 48 KB a block's shared memory must be opted into (per device, so
  // on every launch: it is a host-side attribute write)
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid(a.hq, a.batch, (a.sq + BQ - 1) / BQ);
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
    case 96: return launch<T, 96>(a);
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
  if (batch < 1 || sq < 1 || sk < 1 || hq < 1 || g < 1 || hq % g != 0 ||
      batch > 65535 || (sq + BQ - 1) / BQ > 65535)
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
