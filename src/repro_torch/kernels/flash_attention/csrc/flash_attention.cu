// Causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
//   (body _flash_kernel), reached through
//   repro/kernels/flash_attention/ops.py::flash_attention.
//
// Two routes, one for each input type; both compute the reference's
// arithmetic: S = Q.K^T with fp32 accumulation, scaled, an fp32 online
// softmax (m, l) in base 2, P.V with fp32 accumulation of an fp32 P, the
// output divided by max(l, 1e-30) and rounded to the input type.  GQA is
// native (q head h reads kv head h / g); the KV loop stops at the diagonal
// and only tiles that cross it or the end of the keys are masked; the q
// tile is the grid's slowest index and runs from the last (most keys) to
// the first, so the heaviest CTAs of every head start first.  The fp32
// route also has a sliding window (`flash_window_kernel`, the same body):
// query i sees keys i - W < j <= i, a q tile's loop starts at the first key
// tile its first row sees, so whole tiles below the band are never loaded
// (the work is ~S (W + 64) a head, not S^2 / 2), and the tiles that cross
// the band's lower edge are masked as the diagonal's are.
//
// === bf16: flash_wgmma_kernel (wgmma, TMA, a producer warpgroup) ===
// What bounds it on the H100: operations.  Causal attention does
// 2*2*Sq*Sk*hd/2 FLOP per (b, q-head) on inputs it reads once.  Q.K^T is
// one bf16 pass (bf16 products are exact in fp32).  P is fp32 in the
// reference; one bf16 rounding of P is ~3e-3 off it (the CPU emulation,
// PERF.md), so P enters as bf16 hi + lo (hi = bf16(P), lo = bf16(P - hi))
// in two passes into one fp32 accumulator.  The design's bound is
// therefore 1.5x the FLOP at the 989 TFLOP/s bf16 rate.  The only
// instruction that reaches that rate is wgmma, fed from shared memory.
// What the design does about it:
//   - a CTA owns one (q head, batch, q tile of 64 rows): one consumer
//     warpgroup and one producer warpgroup, whose first thread issues
//     every TMA load; the producer keeps 24 registers (setmaxnreg) and
//     the consumer takes the rest, 232, so two CTAs (80 KB of shared
//     memory each at hd=128) share an SM;
//   - tensor maps over the model's [B, S, H, hd] layout through its
//     strides, made on the host per call (cuTensorMapEncodeTiled comes
//     through cudaGetDriverEntryPoint, so nothing links libcuda): Q arrives
//     once, K and V tiles of 64 keys into rings of two stages, each stage
//     with a full and an empty mbarrier.  TMA fills rows past S with
//     zeros, so a ragged end needs only the score mask;
//   - a row of hd bf16 is cut into chunks of the swizzle span: 128 B where
//     hd*2 is a multiple of it (hd 64, 128: one or two boxes of 64
//     columns), else 64 B (hd 32; hd 96 as three boxes of 32 columns: one
//     tensor map and one descriptor layout for all its chunks) or 32 B (hd
//     16).  Each chunk is one TMA box into its own 1024-byte aligned
//     region, swizzled, and the wgmma descriptors take the same swizzle;
//   - S = Q.K^T is wgmma m64n64k16 with A = Q and B = K both from shared
//     memory, K-major (hd contiguous): a k-step moves both descriptors 32
//     bytes along a chunk's rows; its first k-step overwrites S;
//   - O += P.V is wgmma m64n{hd}k16 with A = P from registers: the S
//     accumulator of m64n64 packed to bf16 pairs is the A fragment of four
//     k16 steps (S's n tiles 2kk, 2kk+1), as FlashAttention-3 does, so P
//     never leaves registers.  B = V from shared memory MN-major (hd
//     contiguous; the descriptor's transpose bit): chunk regions of 64 keys
//     are the leading (N) offset, 8-key groups the stride;
//   - the softmax runs in fp32 in registers on the wgmma accumulator
//     layout (a row's 64 scores on the four lanes of a quad), in base 2
//     (scores scaled by scale*log2(e); ex2.approx.ftz, one MUFU op);
//   - per tile the softmax of S_t, then P_t V_t and S_{t+1} issued behind
//     one fence and waited for together; the SM's other CTA runs its
//     softmax while these run on the tensor cores;
//   - epilogue: O / l rounded to bf16 is written into the warpgroup's part
//     of the Q tile (Q is no longer read), in the box's swizzled layout,
//     and leaves by one TMA store a chunk, which clips rows past Sq;
//   - W = 1 (64-row q tiles): at S=64 (the lm-forward module) a 128-row
//     tile is half empty, and at S=1024 two CTAs of one warpgroup an SM
//     beat one CTA of two.
// Times (tools/flash_variants.py, device ms, NVIDIA H100 80GB HBM3 at
// 700 W; llama3.2-3b's B=4 S=1024 24/8 heads / the lm-forward module's
// B=8 S=64): this design 0.1024 / 0.0116, SDPA 0.0690 / 0.0162.
// Tried and slower: W = 2, 0.1213 / 0.0157; a lone producer warp with
// setmaxnreg hung the CTA (setmaxnreg moves a warpgroup's registers);
// the softmax of tile t beside P_{t-1} V_{t-1} (FA3's overlap within a
// warpgroup): ptxas serialized every wgmma of the kernel (C7513), in
// whatever order the waits stood.  What bounds it now (the same script,
// each part taken out in turn): the second P.V pass costs 0.016 ms, the
// softmax 0.023, all of P.V 0.026, Q.K^T 0.015, the K/V loads 0.002; the
// rest, ~0.04 ms, is a warpgroup waiting on its own wgmma and the
// per-CTA prologue and epilogue.
// Later (ROADMAP B2): FA3's ping-pong of two warpgroups' softmax and
// wgmma within one CTA, a persistent grid, and a GQA group's g heads in
// one CTA at short S.
//
// === fp32: flash_kernel<float, HD> (mma.sync, 3xTF32) ===
// What bounds it on the H100: operations, as TF32 tensor-core passes.
// Plain TF32 keeps 10 mantissa bits and misses the reference's 2e-5 fp32
// tolerance by ~80x, so every fp32 operand is split as x = hi + lo (hi =
// x rounded to tf32, lo = x - hi, which the tensor cores truncate to
// tf32) and each product is hi*lo' + lo*hi' + hi*hi' (3xTF32, the small
// terms first), accumulated in fp32.  The tensor cores round their sums
// toward zero, so each key tile's P.V is summed in fresh accumulators and
// added to O in fp32 (below).  Its error against an fp64 computation
// stays at fp32's own, at 4096 keys too (3.5e-6 of the largest output
// against the plain version's 3.0e-6) and where a peaky softmax (inputs
// x3) moves both (chip_smoke.py phase 2).  Its bound is 3x the FLOP over
// the 495 TFLOP/s TF32 rate.
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
//     phase), V rows plus 16 bytes (rows 2t, 2t+1 and column groups g of a
//     phase land in distinct banks);
//   - W divides the hd/8 output n tiles; a tile row is copied by a power
//     of two of threads (hd=96: 32 for its 24 16-byte chunks; the rest
//     idle), so every thread's copies advance by one constant stride;
//   - K and V tiles of 64 keys arrive by cp.async (16 bytes, zero-filled
//     past the end of the keys), staggered: V_t lands while S_t = Q K_t^T
//     and the softmax run, K_{t+1} while P V_t runs.  Two barriers a tile,
//     one buffer each (~105 KB a CTA at hd=128), so two CTAs (eight warps)
//     share an SM; double-buffering both would need ~178 KB and leave one
//     CTA of four warps an SM;
//   - the split is made per warp as a fragment is loaded (an integer add
//     and mask for hi, a subtract for lo: three ALU operations an element),
//     which keeps the tiles single-sized in shared memory;
//   - scores are scaled by scale*log2(e) after Q.K^T.
// Tried on the H100 and slower: 128-row CTAs of eight warps (one an SM),
// 32-key tiles at three CTAs an SM, skipping a warp's masked n tiles on the
// diagonal (the early exit breaks the unrolled schedule), cvt.rna for
// the split, and a fresh accumulator for each k-step of P.V (255
// registers, 21% slower at 4096 keys; a group of W n tiles a tile takes
// 253 at hd=128 and costs 0.3%); ordering the passes over independent
// accumulators by hand changed nothing (the compiler already interleaves
// them).  What bounds it now is the rate of mma.sync itself.  Later
// (ROADMAP B2): TF32 wgmma (K-major operands only, so V transposed in
// shared memory, hi/lo tiles).  The template keeps the element type of
// its first version; only fp32 is instantiated.
#include <cuda.h>  // CUtensorMap and its enums; no libcuda is linked

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

// The body of both fp32 kernels.  WINDOW: query i sees only the keys
// i - window < j <= i, so a q tile's key loop starts at the tile that holds
// its first row's first key, and the tiles that cross the band's lower edge
// are masked besides those on the diagonal; without it `window` is unused
// and the loop is the causal one.
template <typename T, int HD, bool WINDOW>
__device__ __forceinline__ void flash_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int sq, int sk, int hq, int g, float scale, int q_sb,
    int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb, int v_ss,
    int v_sh, int window) {
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
  // and, in a window, none before q0 - window + 1 (the tile's first row's)
  const int t_first = WINDOW ? max(0, q0 - window + 1) / BK : 0;

  load_tile<T, HD, BQ>(sQ, LDQK, q + (int64_t)b * q_sb + (int64_t)h * q_sh,
                       q_ss, q0, sq);
  load_tile<T, HD, BK>(sK, LDQK, kbase, k_ss, t_first * BK, sk);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  float o[NT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int t = t_first; t < n_tiles; ++t) {
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
    // the end of the keys (in a window, or the band's lower edge: a key at
    // or below the last row's row - window).  s[j][e]: row r0 + 8 (e / 2),
    // key 8j + 2t + e % 2
    const bool edge = k0 + BK - 1 > q0 || k0 + BK > sk ||
                      (WINDOW && k0 + window <= q0 + BQ - 1);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= sl2;
        if (edge) {
          const int row = q0 + r0 + 8 * (e / 2);
          const int col = k0 + 8 * j + 2 * tig + e % 2;
          if (col > row || col >= sk || (WINDOW && col + window <= row))
            s[j][e] = -INFINITY;
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
    // n = c * W + w, column g of it is hd column 8W*c + W*g + w.  O
    // accumulated through the tensor cores over every tile drifted by up
    // to an ulp a k-step (4e-5 of O at 4096 keys), so a group of W n
    // tiles sums this tile's k-steps in fresh accumulators, added to O in
    // fp32 (P is split again for each group)
#pragma unroll
    for (int c = 0; c < NT / W; ++c) {
      float pv[W][4];
#pragma unroll
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[w][e] = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        uint32_t phi[4], plo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(p[e], phi[e], plo[e]);
        const T* vrow = sV + (8 * j + 2 * tig) * LDV + W * gid + 8 * W * c;
        float va[W], vb[W];
        lds<T, W>(vrow, va);
        lds<T, W>(vrow + LDV, vb);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          if constexpr (C::kSplit) {
            uint32_t h0, l0, h1, l1;
            split_tf32(va[w], h0, l0);
            split_tf32(vb[w], h1, l1);
            mma_tf32(pv[w], plo, h0, h1);
            mma_tf32(pv[w], phi, l0, l1);
            mma_tf32(pv[w], phi, h0, h1);
          } else {
            const uint32_t b0 = __float_as_uint(va[w]);
            const uint32_t b1 = __float_as_uint(vb[w]);
            mma_tf32(pv[w], plo, b0, b1);
            mma_tf32(pv[w], phi, b0, b1);
          }
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[c * W + w][e] += pv[w][e];
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

// causal: query i sees keys j <= i
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
             int hq, int g, float scale, int q_sb, int q_ss, int q_sh,
             int k_sb, int k_ss, int k_sh, int v_sb, int v_ss, int v_sh) {
  flash_body<T, HD, false>(q, k, v, out, sq, sk, hq, g, scale, q_sb, q_ss,
                           q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, 0);
}

// causal within a window: query i sees keys i - window < j <= i (a symbol
// of its own, so that a device trace tells the two apart)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_window_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int sq,
                    int sk, int hq, int g, float scale, int q_sb, int q_ss,
                    int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
                    int v_ss, int v_sh, int window) {
  flash_body<T, HD, true>(q, k, v, out, sq, sk, hq, g, scale, q_sb, q_ss,
                          q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, window);
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int batch, sq, sk, hq, g;
  float scale;
  int q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int window;  // 0: causal
  cudaStream_t stream;
};

// fp32 route
template <typename T, int HD>
cudaError_t launch(const Args& a) {
  constexpr int bytes = Cfg<T, HD>::kBytes;
  dim3 grid(a.hq, a.batch, (a.sq + BQ - 1) / BQ);
  // above 48 KB a block's shared memory must be opted into (per device, so
  // on every launch: it is a host-side attribute write)
  if (a.window > 0) {
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_window_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return attr;
    flash_window_kernel<T, HD><<<grid, kThreads, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.out), a.sq, a.sk, a.hq,
        a.g, a.scale, a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb,
        a.v_ss, a.v_sh, a.window);
    return cudaGetLastError();
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
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

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed tiles, a producer warpgroup
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed (the
// spin loop in one asm block, as CUTLASS writes it)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a box of a 4-d tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// a box of shared memory to a 4-d tensor map (elements past the tensor's
// extent are not written)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The compiler does not know that wgmma reads and writes its register
// operands asynchronously: an empty asm that "writes" each register pins
// it between the issue and the wait, so no use of it moves across them
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma shared-memory matrix descriptor: the start address, the leading
// and stride byte offsets (in 16-byte units, 14 bits each) and the swizzle
// mode (bits 62-63: 1 = 128 B, 2 = 64 B, 3 = 32 B).  Adding n to it moves
// the start address by 16 n bytes (smem addresses fit the 14 bits with room)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(mode) << 62;
}

// D[64 x 64] = A[64 x 16] B[16 x 64] + (accumulate ? D : 0): A and B in
// shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x N] += A[64 x 16] B[16 x N]: A in registers (bf16 pairs, the
// m64k16 A fragment), B in shared memory MN-major (the transpose bit set)
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Consumer warpgroups a CTA (64 query rows each); 2 was tried (the note
// above)
constexpr int kW = 1;
constexpr int kStages = 2;  // the K and V rings

// Tiles and layouts of the bf16 kernel at head dim HD with W consumer
// warpgroups.  A row of HD bf16 is cut into NCH column chunks of SWB bytes
// (the swizzle span: 128 B where HD * 2 is a multiple of it, else 64 or 32);
// every tile is stored chunk by chunk, [chunk][rows][SWB bytes], each chunk
// region 1024-byte aligned and swizzled as the TMA box that fills it.
template <int HD, int W>
struct Wg {
  static constexpr int kRowBytes = HD * 2;
  static constexpr int SWB = kRowBytes % 128 == 0 ? 128
                             : kRowBytes % 64 == 0 ? 64
                                                   : 32;
  static constexpr int CW = SWB / 2;    // columns a chunk (the TMA box's)
  static constexpr int NCH = HD / CW;   // chunks a row
  static constexpr uint32_t kMode = SWB == 128 ? 1 : SWB == 64 ? 2 : 3;
  static constexpr int kTile = 64 * kRowBytes;      // a 64-row tile
  static constexpr int kQChunk = 64 * W * SWB;      // a Q chunk region
  static constexpr int kQBytes = W * kTile;
  static constexpr int kBars = 1 + 4 * kStages;
  static constexpr int kSmem = kQBytes + 2 * kStages * kTile + 8 * kBars +
                               1024;  // + the alignment of the base
  // one producer warpgroup: setmaxnreg moves registers a warpgroup at a
  // time (a lone producer warp's setmaxnreg hung the CTA), and only its
  // first thread issues loads
  static constexpr int kThreads = 128 * W + 128;
  static constexpr int kMinCtas = W == 1 ? 2 : 1;
  // registers a thread at launch: what __launch_bounds__ leaves (65536 over
  // the threads of kMinCtas CTAs, in units of 8), and at most 168, which
  // ptxas gives a kernel with setmaxnreg (sm_90a, CUDA 12.8); launch_bf16
  // refuses a kernel that got fewer.  The producer warpgroup keeps
  // kProducer, and the consumers take what it gives back, up to kConsumer
  static constexpr int kLaunchRegs =
      cmin(65536 / (kThreads * kMinCtas) / 8 * 8, 168);
  static constexpr int kProducer = 24;
  static constexpr int kConsumer =
      cmin(240, (kLaunchRegs + (kLaunchRegs - kProducer) / W) / 8 * 8);
  static_assert(HD % CW == 0 && HD % 16 == 0 && CW % 16 == 0, "chunks");
  static_assert(kSmem <= 232448, "shared memory");
  static_assert(W * (kConsumer - kLaunchRegs) <= kLaunchRegs - kProducer,
                "setmaxnreg asks for no more than the producer gives back");
};

// byte offset of (row, byte x) in a chunk region of SWB-byte rows, as the
// TMA swizzle places it: the 16-byte group index (bits 4..) XOR the row's
// bits above 128 bytes (bits 7..), over log2(SWB / 16) bits
template <int SWB>
__device__ __forceinline__ uint32_t swizzled(int row, int x) {
  const uint32_t off = row * SWB + x;
  return off ^ (((off >> 7) & (SWB / 16 - 1)) << 4);
}

// 2^x, one MUFU.EX2: subnormal results flush to 0 (a softmax weight or a
// rescale under 2^-126 of the row's max is 0 in fp32's sum anyway)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The consumer's steps, on one warpgroup's 64 query rows.

// S = Q K^T of one K stage into sc (its first k-step overwrites sc),
// issued and committed (not waited for).  k-step kk reads 16 columns: chunk 16 kk / CW, at 32 (kk % (CW /
// 16)) bytes into its rows.  dq, dk: descriptors of the warpgroup's Q rows
// and of the stage's K tile, chunk 0
template <int HD, int W>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint64_t dq,
                                         uint64_t dk) {
  using C = Wg<HD, W>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk / (C::CW / 16), x = 32 * (kk % (C::CW / 16));
    wgmma_ss_n64(sc, dq + ((c * C::kQChunk + x) >> 4),
                 dk + ((c * 64 * C::SWB + x) >> 4), kk > 0);
  }
  wgmma_commit();
}

// O += P_lo V + P_hi V (the small terms first) of one V stage, issued and
// committed; k-step kk reads the 16 V rows of keys 16 kk .. + 15.  dv: the
// stage's V tile
template <int HD, int W>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         uint32_t (&phi)[16],
                                         uint32_t (&plo)[16], uint64_t dv) {
  constexpr int SWB = Wg<HD, W>::SWB;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<HD>(o, *reinterpret_cast<const uint32_t(*)[4]>(plo + 4 * kk),
                 dv + ((kk * 16 * SWB) >> 4));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<HD>(o, *reinterpret_cast<const uint32_t(*)[4]>(phi + 4 * kk),
                 dv + ((kk * 16 * SWB) >> 4));
  wgmma_commit();
}

// The scores of the tile of keys k0 .. k0 + 63 (sc, this thread's rows r0
// and r0 + 8; the warpgroup's first row q0w) to P as bf16 hi + lo (hi =
// bf16(P), lo = bf16(P - hi)); the running max m and sum l move on, and
// alpha is what O must be scaled by
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             uint32_t (&hi)[16],
                                             uint32_t (&lo)[16], int k0,
                                             int q0w, int r0, int tq4, int sk,
                                             float sl2) {
  // base-2 scores; the element mask where the tile crosses the diagonal or
  // the end of the keys.  sc[4 j + e]: row r0 + 8 (e / 2), key k0 + 8 j +
  // 2 tq4 + e % 2
  const bool edge = k0 + 63 > q0w || k0 + 64 > sk;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * sl2;
      if (edge) {
        const int row = r0 + 8 * (e / 2);
        const int col = k0 + 8 * j + 2 * tq4 + e % 2;
        if (col > row || col >= sk) x = -INFINITY;
      }
      sc[4 * j + e] = x;
    }
  // online softmax for rows r0 (i = 0) and r0 + 8 (i = 1); a row's 64
  // scores lie on the four lanes of a quad
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[i], mx);
    const float base = mn == -INFINITY ? 0.f : mn;  // a row all masked
    alpha[i] = exp2_ftz(m[i] - base);
    m[i] = mn;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j + 2 * i] = exp2_ftz(sc[4 * j + 2 * i] - base);
      sc[4 * j + 2 * i + 1] = exp2_ftz(sc[4 * j + 2 * i + 1] - base);
      sum += sc[4 * j + 2 * i] + sc[4 * j + 2 * i + 1];
    }
    l[i] = l[i] * alpha[i] + sum;
  }
  // the A fragment of P.V's k-step kk (keys 16 kk .. + 15) is S's n tiles
  // 2 kk and 2 kk + 1: sc[8 kk .. 8 kk + 7] as four bf16 pairs
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(sc[2 * i], sc[2 * i + 1]);
    const __nv_bfloat162 l2 =
        __floats2bfloat162_rn(sc[2 * i] - __low2float(h2),
                              sc[2 * i + 1] - __high2float(h2));
    hi[i] = *reinterpret_cast<const uint32_t*>(&h2);
    lo[i] = *reinterpret_cast<const uint32_t*>(&l2);
  }
}

// Causal GQA flash attention, bf16 in and out, fp32 softmax and
// accumulation.  Grid (q heads, batch, q tiles of 64 W rows); W consumer
// warpgroups (threads 0 .. 128 W - 1, 64 query rows each) and one producer
// warp (the last).
template <int HD, int W>
__global__ void __launch_bounds__(Wg<HD, W>::kThreads, Wg<HD, W>::kMinCtas)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to, int sq, int sk,
                   int g, float scale) {
  using C = Wg<HD, W>;
  constexpr int SWB = C::SWB, CW = C::CW, NCH = C::NCH;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;  // [NCH][64 W][SWB]
  uint8_t* const q_tile = smem_raw + (sQ - raw);
  const uint32_t sK = sQ + C::kQBytes;           // [kStages][NCH][64][SWB]
  const uint32_t sV = sK + kStages * C::kTile;   // [kStages][NCH][64][SWB]
  const uint32_t bars = sV + kStages * C::kTile;
  // barriers: Q full, then per stage K full, V full, K empty, V empty
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * kStages + s); };

  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / g;
  const int q0 = qt * 64 * W;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 128 * W);  // every consumer thread arrives
      mbar_init(v_empty(s), 128 * W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * W) {
    // the producer: Q once, then K and V tiles of 64 keys into the rings,
    // each load as soon as the consumers have released its stage.  Rows
    // past the end of q or k/v arrive as zeros.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(C::kProducer));
    if (threadIdx.x == 128 * W) {
      const int n_tiles = (min(sk, q0 + 64 * W) + 63) / 64;
      mbar_expect_tx(q_full, C::kQBytes);
      for (int w = 0; w < W; ++w)
        for (int c = 0; c < NCH; ++c)
          tma_load(sQ + c * C::kQChunk + w * 64 * SWB, &tq, q_full, c * CW,
                   h, q0 + 64 * w, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages, round = t / kStages;
        if (round > 0) mbar_wait(k_empty(s), (round - 1) & 1);
        mbar_expect_tx(k_full(s), C::kTile);
        for (int c = 0; c < NCH; ++c)
          tma_load(sK + s * C::kTile + c * 64 * SWB, &tk, k_full(s), c * CW,
                   kvh, 64 * t, b);
        if (round > 0) mbar_wait(v_empty(s), (round - 1) & 1);
        mbar_expect_tx(v_full(s), C::kTile);
        for (int c = 0; c < NCH; ++c)
          tma_load(sV + s * C::kTile + c * 64 * SWB, &tv, v_full(s), c * CW,
                   kvh, 64 * t, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::kConsumer));
    const int wg = warp / 4;             // this consumer warpgroup
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, gq = lane / 4, tq4 = lane % 4;
    const int q0w = q0 + 64 * wg;        // its first query row
    // this thread's accumulator rows: r0 and r0 + 8 (the wgmma D layout:
    // warp w of the group holds rows 16 w .. 16 w + 15)
    const int r0 = q0w + 16 * (tid / 32) + gq;
    const int n_tiles = (min(sk, q0w + 64) + 63) / 64;
    const float sl2 = scale * kLog2e;
    // descriptors: Q and K K-major (rows of SWB bytes, 8-row groups
    // 8 SWB apart); V MN-major (hd contiguous: 64-key chunk regions 64 SWB
    // apart, 8-key groups 8 SWB apart)
    const uint64_t dq =
        gmma_desc(sQ + wg * 64 * SWB, 16, 8 * SWB, C::kMode);
    const uint64_t dk0 = gmma_desc(sK, 16, 8 * SWB, C::kMode);
    const uint64_t dv0 = gmma_desc(sV, 64 * SWB, 8 * SWB, C::kMode);

    float o[HD / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float sc[32];                // S of the current tile, then its P
    uint32_t phi[16], plo[16];   // P of the current tile, bf16 hi and lo
    auto dk = [&](int t) { return dk0 + ((t % kStages) * C::kTile >> 4); };
    auto dv = [&](int t) { return dv0 + ((t % kStages) * C::kTile >> 4); };
    auto parity = [](int t) { return static_cast<uint32_t>(t / kStages & 1); };

    // Tile by tile: the softmax turns S_t into P_t, then P_t V_t and
    // S_{t+1} = Q K_{t+1}^T are issued together and waited for together;
    // the other CTA on the SM runs its softmax meanwhile.  Every register
    // a wgmma reads is written before the fence, with no wgmma in flight
    // (ptxas serialized every wgmma of the kernel when one tile's softmax
    // ran beside the previous tile's P.V)
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    issue_qk<HD, W>(sc, dq, dk(0));
    wgmma_wait<0>();
    pin(sc);
    mbar_arrive(k_empty(0));
    for (int t = 0; t < n_tiles; ++t) {
      float alpha[2];
      softmax_tile(sc, m, l, alpha, phi, plo, 64 * t, q0w, r0, tq4, sk, sl2);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      const bool next = t + 1 < n_tiles;
      mbar_wait(v_full(t % kStages), parity(t));
      if (next) mbar_wait(k_full((t + 1) % kStages), parity(t + 1));
      pin(o);
      pin(phi);
      pin(plo);
      issue_pv<HD, W>(o, phi, plo, dv(t));
      if (next) issue_qk<HD, W>(sc, dq, dk(t + 1));
      wgmma_wait<0>();
      pin(o);
      pin(phi);
      pin(plo);
      pin(sc);
      mbar_arrive(v_empty(t % kStages));
      if (next) mbar_arrive(k_empty((t + 1) % kStages));
    }

    // finish: a row's sum lies on the four lanes of its quad.  The rows go
    // back through this warpgroup's part of the Q tile, in its swizzled
    // layout, and out by one TMA store a chunk (rows past sq not written)
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.f / fmaxf(l[i], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * tq4;
      const int c = col / CW, x = 2 * (col % CW);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 64 * wg + 16 * (tid / 32) + gq + 8 * i;
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
        *reinterpret_cast<__nv_bfloat162*>(
            q_tile + c * C::kQChunk + swizzled<SWB>(row, x)) = v;
      }
    }
    // the generic-proxy writes must be visible to the TMA (async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (tid == 0) {
      for (int c = 0; c < NCH; ++c)
        tma_store(&to, sQ + c * C::kQChunk + wg * 64 * SWB, c * CW, h, q0w,
                  b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // the CTA's shared memory must outlive the store's reads of it; its
      // writes complete before the kernel does
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (so the
// library links no libcuda); nullptr where it is missing
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map over [batch, seq, heads, HD] bf16 with the given element
// strides (hd's is 1), read in boxes of CW columns x 64 rows of one (batch,
// head); rows past `seq` read as zeros.  A dim of extent 1 with stride 0
// takes 16 bytes (its coordinate is always 0; TMA wants a nonzero one).
template <int HD>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int batch, int seq,
                     int heads, int sb, int ss, int sh) {
  using C = Wg<HD, kW>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  auto bytes = [](int extent, int stride) {
    return extent == 1 && stride == 0 ? cuuint64_t{16}
                                      : static_cast<cuuint64_t>(stride) * 2;
  };
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {bytes(heads, sh), bytes(seq, ss),
                                 bytes(batch, sb)};
  const cuuint32_t box[4] = {C::CW, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = C::SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : C::SWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_bf16(const Args& a) {
  using C = Wg<HD, kW>;
  const auto kernel = flash_wgmma_kernel<HD, kW>;
  // setmaxnreg moves registers between the warps of a CTA: refuse to
  // launch if the kernel was given fewer at launch than the moves assume
  static const cudaError_t regs = [kernel] {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    return attr.numRegs < C::kLaunchRegs ? cudaErrorInvalidConfiguration
                                         : cudaSuccess;
  }();
  if (regs != cudaSuccess) return regs;
  CUtensorMap mq, mk, mv, mo;
  cudaError_t e;
  if ((e = make_map<HD>(&mq, a.q, a.batch, a.sq, a.hq, a.q_sb, a.q_ss,
                        a.q_sh)) != cudaSuccess ||
      (e = make_map<HD>(&mk, a.k, a.batch, a.sk, a.hq / a.g, a.k_sb, a.k_ss,
                        a.k_sh)) != cudaSuccess ||
      (e = make_map<HD>(&mv, a.v, a.batch, a.sk, a.hq / a.g, a.v_sb, a.v_ss,
                        a.v_sh)) != cudaSuccess ||
      (e = make_map<HD>(&mo, a.out, a.batch, a.sq, a.hq, a.sq * a.hq * HD,
                        a.hq * HD, HD)) != cudaSuccess)
    return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.hq, a.batch, (a.sq + 64 * kW - 1) / (64 * kW));
  kernel<<<grid, C::kThreads, C::kSmem, a.stream>>>(mq, mk, mv, mo, a.sq, a.sk,
                                                   a.g, a.scale);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const Args& a, int hd) {
  switch (hd) {
    case 16: return launch_bf16<16>(a);
    case 32: return launch_bf16<32>(a);
    case 64: return launch_bf16<64>(a);
    case 96: return launch_bf16<96>(a);
    case 128: return launch_bf16<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: [B, Sq, Hq, hd]; k, v: [B, Sk, Hkv, hd], each with unit stride on hd
// and the given element strides for b, s and h; out: [B, Sq, Hq, hd]
// contiguous.  Causal: query i sees keys j <= i, and with `window` > 0 only
// those with j > i - window (fp32 only: `flash_window_kernel`).  fp32 runs
// the mma.sync kernel, bf16 the wgmma one (whose tensor maps need 16-byte
// aligned pointers and strides).  Returns the CUDA error of the launch, or
// of making its tensor maps (0 on success); the kernel runs on `stream`.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int dtype, int batch, int sq, int sk, int hq, int g,
                    int hd, float scale, int q_sb, int q_ss, int q_sh,
                    int k_sb, int k_ss, int k_sh, int v_sb, int v_ss,
                    int v_sh, int window, void* stream) {
  if (batch < 1 || sq < 1 || sk < 1 || hq < 1 || g < 1 || hq % g != 0 ||
      batch > 65535 || (sq + BQ - 1) / BQ > 65535 || window < 0 ||
      (window > 0 && dtype != kFloat32))
    return cudaErrorInvalidValue;
  Args a{q, k, v, out, batch, sq, sk, hq, g, scale,
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, window,
         static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == kFloat32) err = dispatch_hd<float>(a, hd);
  else if (dtype == kBFloat16) err = dispatch_bf16(a, hd);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
