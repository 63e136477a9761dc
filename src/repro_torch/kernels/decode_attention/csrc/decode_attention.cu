// Decode attention for Hopper (sm_90a): one query token per (batch, q-head)
// against the model's KV cache, with a valid prefix `length`.
//
// Replaces the TPU kernel
//   repro/kernels/decode_attention/decode_attention.py::decode_attention_bhd
//   (body _decode_kernel), reached through
//   repro/kernels/decode_attention/ops.py::decode_attention.
//
// What bounds it on the H100: device-memory bytes.  Every valid K and V row
// is read once and serves only the g = Hq/Hkv query heads of its kv head, so
// the kernel does about g FLOP per byte, far below the card's fp32 ridge of
// ~20 FLOP/byte (67 TFLOP/s over 3.35 TB/s).  Reading at HBM rate needs
// several MB of loads in flight across the card (Little's law: 3.35 TB/s
// times ~1 us), and at decode B*Hkv is small (32 at the llama3.2-3b serving
// shape, on 132 SMs).  What the design does about it:
//   - the KV rows of one (batch, kv head) are split across the `splits` CTAs
//     of one thread-block cluster (up to 8, the portable cluster size); the
//     caller picks `splits` from B*Hkv and the SM count only, and each CTA
//     computes its contiguous share of [0, length) itself, so the grid does
//     not change with the position;
//   - each CTA holds all g query heads of its kv head, so each K/V row
//     crosses the memory bus once, not g times;
//   - the cache is read in place, in the model's [B, S, Hkv, hd] layout,
//     through strides: no transposed or padded copy of the cache;
//   - rows at or past `length` are never read;
//   - `length` is read from device memory, once by each CTA before it
//     computes its rows, and clamped to [1, S]: a decode step captured in
//     a CUDA graph advances it without a new launch;
//   - each lane loads 16 bytes of a row, a warp covers 32*16 bytes of rows
//     per step and keeps kUnroll steps in flight (256 CTAs keep ~4 MB of
//     loads outstanding at fp32, hd = 128), and the running softmax (m, l,
//     acc) stays in registers in fp32.  A row's lanes are a power of two
//     (the butterfly sums and the merge of a warp's rows need it): where
//     hd / (16 bytes) is not one (hd = 96: 24 slices in fp32, 12 in bf16),
//     the row takes the next power of two of lanes (32, 16) and the lanes
//     past its slices re-read slice 0 (the same address as a busy lane, no
//     extra traffic) under a zero query, so they add 0 to every score and
//     their accumulators are never stored.  kUnroll = 2 keeps the fp32 hd = 128
//     kernel at 80 registers, so three CTAs fit on an SM and a whole
//     cluster of 8 always finds room; a deeper unroll or a register
//     prefetch of the next step measured slower on the H100;
//   - g = 16 (nemotron-h: 32 q heads on 2 kv heads) would need twice the
//     G = 8 instance's registers (already 140-142, one CTA an SM), so its
//     q heads are split over QS = 2 CTAs of 8 each, a grid dimension
//     beside the kv head (grid y = Hkv * QS): each CTA reads the kv
//     head's rows for its 8 q heads, the pair's second read of a row
//     mostly from L2.  QS is a template parameter, 1 for g <= 8, whose
//     instances compute their indices exactly as before;
//   - the splits are merged without another launch and without scratch in
//     device memory: each CTA leaves its partial (m, l, acc) in its own
//     shared memory, and after a cluster barrier every CTA of the cluster
//     reads all partials through distributed shared memory, rescales them
//     and writes its share of the output; a second barrier keeps the shared
//     memory alive until every peer has read it.  A split with no rows keeps
//     m = kNegBig and l = 0, and adds exp2(kNegBig - m) = 0.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

using namespace repro;
namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kUnroll = 2;
constexpr int kMaxSplits = 8;  // the portable cluster size

// T: q/cache/out type.  HD: head dim.  G: a bound on the q heads a CTA
// holds, g / QS (registers are sized by G, the loops are guarded by the
// runtime count; up to G = 4 the launch bound keeps at least two CTAs on an
// SM).  QS: CTAs sharing a kv head's g q heads.  Grid (splits, Hkv * QS,
// B); the `splits` CTAs along x form one cluster.
template <typename T, int HD, int G, int QS>
__global__ void __launch_bounds__(kWarps * 32, G <= 4 ? 2 : 1)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int hkv, int g,
              const int* __restrict__ length_ptr, int s_max, float scale,
              int k_sb, int k_ss, int k_sh, int v_sb, int v_ss, int v_sh) {
  using V = Vec16<T>;
  constexpr int VEC = V::N;            // elements per lane per row
  constexpr int PARTS = HD / VEC;      // 16-byte slices of a row
  constexpr int LPK = pow2_at_least(PARTS);  // lanes per row
  constexpr int RPW = 32 / LPK;        // rows per warp step
  constexpr int SLOTS = kWarps * RPW;  // rows per CTA step
  static_assert(HD % VEC == 0 && LPK <= 32 && 32 % LPK == 0 &&
                    (LPK & (LPK - 1)) == 0,
                "a row must be whole 16-byte slices on at most 32 lanes");

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int kvh = blockIdx.y / QS, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPK;          // which row of the warp step
  const int part = lane % LPK;         // which 16-byte slice of the row
  const bool busy = part < PARTS;      // lanes past the row's slices idle
  const int slice = busy ? part : 0;
  const int slot = warp * RPW + sub;
  const int hq = hkv * g;
  // this CTA's q heads: [h0, h0 + g / QS), the kv head's share
  const int h0 = kvh * g + (blockIdx.y % QS) * (g / QS);
  g /= QS;

  // the valid prefix, read once and clamped to the cache's rows
  const int length = min(max(__ldg(length_ptr), 1), s_max);
  // this CTA's rows [row0, row1): share = ceil(length / splits) each, the
  // last shares shorter or empty (ops.py::split_rows computes the same)
  const int share = (length + splits - 1) / splits;
  const int row0 = min(length, rank * share);
  const int row1 = min(length, row0 + share);

  // this lane's slice of the g query heads, scaled into base 2
  float qf[G][VEC];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi < g) {
      const T* qp = q + ((int64_t)b * hq + h0 + gi) * HD + slice * VEC;
      V::to_float(load16(qp), qf[gi]);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qf[gi][e] = busy ? qf[gi][e] * (scale * kLog2e) : 0.f;
    }
  }

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegBig;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[gi][e] = 0.f;
  }

  const T* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh + slice * VEC;
  const T* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh + slice * VEC;

  for (int base = row0; base < row1; base += SLOTS * kUnroll) {
    // issue every load of the step before using any of them; rows past
    // row1 re-read the share's last row and are masked below
    typename V::raw kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = min(base + u * SLOTS + slot, row1 - 1);
      kr[u] = load16(kb + (int64_t)j * k_ss);
      vr[u] = load16(vb + (int64_t)j * v_ss);
    }
    // scores of the step's rows, reduced over the row's lanes
    float s[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[VEC];
      V::to_float(kr[u], kf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qf[gi][e], kf[e], d);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u][gi] = d;
      }
    }
    // one online-softmax update for the step's valid rows
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi >= g) continue;
      float mn = m[gi];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (base + u * SLOTS + slot < row1) mn = fmaxf(mn, s[u][gi]);
      const float alpha = exp2f(m[gi] - mn);
      l[gi] *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[gi][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (base + u * SLOTS + slot >= row1) continue;
        const float p = exp2f(s[u][gi] - mn);
        float vf[VEC];
        V::to_float(vr[u], vf);
        l[gi] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[gi][e] = fmaf(p, vf[e], acc[gi][e]);
      }
      m[gi] = mn;
    }
  }

  // merge the warp's rows-per-step streams (lanes LPK apart)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi >= g) continue;
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[gi], off);
      const float mn = fmaxf(m[gi], mo);
      const float a = exp2f(m[gi] - mn), c = exp2f(mo - mn);
      l[gi] = l[gi] * a + lo * c;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
        acc[gi][e] = acc[gi][e] * a + ao * c;
      }
      m[gi] = mn;
    }
  }

  // merge the warps through shared memory into this CTA's partial
  __shared__ float sm_m[kWarps][G], sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][HD];
  __shared__ float part_m[G], part_l[G];
  __shared__ float part_acc[G][HD];
  if (sub == 0 && busy) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi >= g) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][gi][part * VEC + e] = acc[gi][e];
      if (part == 0) {
        sm_m[warp][gi] = m[gi];
        sm_l[warp][gi] = l[gi];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < g * HD; idx += blockDim.x) {
    const int gi = idx / HD, d = idx % HD;
    float mx = kNegBig;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][gi]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(sm_m[w][gi] - mx);
      lsum += sm_l[w][gi] * c;
      asum += sm_acc[w][gi][d] * c;
    }
    part_acc[gi][d] = asum;
    if (d == 0) {
      part_m[gi] = mx;
      part_l[gi] = lsum;
    }
  }

  // merge the cluster's partials through distributed shared memory; each
  // CTA writes every splits-th block of the [g, hd] output
  cluster.sync();
  for (int idx = rank * blockDim.x + threadIdx.x; idx < g * HD;
       idx += splits * blockDim.x) {
    const int gi = idx / HD, d = idx % HD;
    float mx = kNegBig;
    for (int r = 0; r < splits; ++r)
      mx = fmaxf(mx, *cluster.map_shared_rank(&part_m[gi], r));
    float lsum = 0.f, asum = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float c = exp2f(*cluster.map_shared_rank(&part_m[gi], r) - mx);
      lsum += *cluster.map_shared_rank(&part_l[gi], r) * c;
      asum += *cluster.map_shared_rank(&part_acc[gi][d], r) * c;
    }
    store(out + ((int64_t)b * hq + h0 + gi) * HD + d,
          asum / fmaxf(lsum, 1e-30f));
  }
  cluster.sync();  // no CTA leaves while a peer may still read its partial
}

struct Args {
  const void *q, *k, *v;
  void* out;
  const int* length;
  int batch, hkv, g, s_max, splits;
  float scale;
  int k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  cudaStream_t stream;
};

template <typename T, int HD, int G, int QS = 1>
cudaError_t launch(const Args& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.hkv * QS, a.batch);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_kernel<T, HD, G, QS>, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.hkv, a.g, a.length, a.s_max, a.scale,
      a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_g(const Args& a) {
  if (a.g <= 1) return launch<T, HD, 1>(a);
  if (a.g <= 2) return launch<T, HD, 2>(a);
  if (a.g <= 4) return launch<T, HD, 4>(a);
  if (a.g <= 8) return launch<T, HD, 8>(a);
  if (a.g == 16) return launch<T, HD, 8, 2>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_hd(const Args& a, int hd) {
  switch (hd) {
    case 16: return dispatch_g<T, 16>(a);
    case 32: return dispatch_g<T, 32>(a);
    case 64: return dispatch_g<T, 64>(a);
    case 96: return dispatch_g<T, 96>(a);
    case 128: return dispatch_g<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, out: [B, Hkv*g, hd] contiguous.  k, v: [B, S, Hkv, hd] with unit stride
// on hd and the given element strides for b, s and h; `s_max` is S.
// `length`: one int32 in device memory, the valid prefix, which the kernel
// clamps to [1, S].  `splits` CTAs (one cluster, 1..8) share each (batch,
// kv head, CTA of its q heads); g is 1..8, or 16 (two CTAs of 8).  Returns
// the CUDA error of the launch (0 on success); the kernel runs on `stream`.
int decode_attention(const void* q, const void* k, const void* v, void* out,
                     int dtype, int batch, int hkv, int g, int hd,
                     const void* length, int s_max, int splits, float scale,
                     int k_sb, int k_ss, int k_sh, int v_sb, int v_ss,
                     int v_sh, void* stream) {
  if (batch < 1 || hkv < 1 || g < 1 || length == nullptr || s_max < 1 ||
      splits < 1 || splits > kMaxSplits)
    return cudaErrorInvalidValue;
  Args a{q, k, v, out, static_cast<const int*>(length), batch, hkv, g,
         s_max, splits, scale,
         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
         static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == kFloat32) err = dispatch_hd<float>(a, hd);
  else if (dtype == kBFloat16) err = dispatch_hd<__nv_bfloat16>(a, hd);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
