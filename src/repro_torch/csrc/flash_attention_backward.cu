// Flash attention backward for Hopper (sm_90a), f32: dQ, dK and dV of the
// forward of flash_attention.cu (causal and sliding-window masks, the
// gemma2 logit softcap, GQA/MQA, queries right-aligned to the KV tail),
// f32 FMAs on the CUDA cores, so every product stays exact in f32 (TF32
// would keep 10 bits).  bf16 inputs go to the tensor-core kernels of
// flash_attention_backward_bf16.cu.
//
// Replaces: the gradient XLA derives for the reference's jnp attention
// (src/repro/models/layers.py, attention_forward with use_flash=False,
// _sdpa); the reference's Pallas kernel
// (src/repro/kernels/flash_attention.py) is forward only, and the
// reference trains through the jnp path.
//
// Contract (src/repro_torch/kernels/ref.py flash_attention_backward): with
// s = q.k / sqrt(hd) in f32, optionally s_c = tanh(s / cap) * cap, P the
// softmax of the masked s_c over each query row,
//     dV = P^T dO,  dP = dO V^T,  D = rowsum(dO * O),
//     dS = P * (dP - D)  [* (1 - tanh^2(s / cap))],
//     dQ = dS K / sqrt(hd),  dK = dS^T Q / sqrt(hd),
// dK and dV summed over the g query heads that share a KV head; every
// product and sum is an f32 FMA.
//
// Bound on this card: operations.  The band's backward is 2.5 times the
// forward's 4 * hd flops a (query, key) pair (dS needs Q.K^T and dO.V^T
// again, then dV, dK and dQ); at the training shape (8, 10, 512, 256)
// over one KV head, causal, 26.9 GFLOP: 0.40 ms at the f32 FMA peak.
//
// Design: three kernels in one call, no atomics, deterministic.
//   (a) lse_delta: one CTA per (query tile, head, batch), laid out as the
//       forward kernel (a warp holds 8 query rows, a lane one key of a
//       32-key tile); it recomputes each row's log-sum-exp over the band
//       only (unless the caller hands it the forward's) and forms
//       D = rowsum(dO * O).  Both go to an f32 scratch.
//   (b) dkdv: one CTA per (key tile of 32, KV head, batch), 8 warps.  The
//       tile's K and V stay in shared memory; the CTA walks every query
//       tile the band sends to these keys, for each of the g query heads:
//       a score pass (a lane per key, 8 query rows a warp) writes P and dS
//       to shared memory, then an accumulation pass adds P^T dO and dS^T Q
//       into dV and dK, which stay in registers (a warp holds 4 keys, a
//       lane hd / 32 columns of each).
//   (c) dq: one CTA per (query tile, head, batch), as (a): each key tile
//       of the band gives dS (the score pass of (b)) and dQ += dS K, held
//       in registers as the forward holds its output.
// Q is pre-scaled by 1 / sqrt(hd) as it is loaded, so dK needs no scale
// and dQ takes it once at the end.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;          // query rows a warp holds in a score pass
constexpr int kBK = 32;           // keys a tile: one a lane in a score pass
constexpr int kWarpsB = 8;        // warps of a dkdv CTA
constexpr int kKeysWarp = kBK / kWarpsB;  // keys a dkdv warp accumulates
constexpr int kBQB = kWarpsB * kRows;     // query rows a dkdv tile
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// element strides of (batch, head, seq) of q, k, v, o, do, dq, dk, dv; hd
// is contiguous
struct Strides {
  long long x[24];
};
enum { Q = 0, K = 3, V = 6, O = 9, DO = 12, DQ = 15, DK = 18, DV = 21 };

struct Shape {
  int Hq, group, Sq, Skv, causal, window;
  float scale, softcap;
  int lse_given;     // the caller's lse holds the forward's: (a) forms D only
};

// rows x HD f32 (row stride `stride`) -> shared [rows][LD], each times
// `mul`; rows at or past `valid` are zero-filled.  16-byte loads.
template <int HD, int LD, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride, int rows,
                                          int valid, float mul) {
  constexpr int kPerRow = HD / 4;
  for (int idx = threadIdx.x; idx < rows * kPerRow; idx += THREADS) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      val = __ldg(reinterpret_cast<const float4*>(src + r * stride + c));
      val = make_float4(val.x * mul, val.y * mul, val.z * mul, val.w * mul);
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

// Whether query position `qpos` sees key `kpos` (< Skv checked by the
// caller).
__device__ __forceinline__ bool keeps(const Shape& sh, int qpos, int kpos) {
  bool ok = true;
  if (sh.causal) ok = kpos <= qpos;
  if (sh.window) ok = ok && qpos - kpos < sh.window;
  return ok;
}

// The softcapped score and, with a softcap, its derivative factor
// 1 - tanh^2 (1 without one).
__device__ __forceinline__ float capped(float s, float softcap, float& dcap) {
  if (softcap > 0.f) {
    const float t = tanhf(s / softcap);
    dcap = 1.f - t * t;
    return t * softcap;
  }
  dcap = 1.f;
  return s;
}

// x[i] = A row (r0 + i) . B row `lane` over HD for the warp's 8 rows: A in
// shared [.][HD] (broadcast reads), B in shared [kBK][HD + 4] (a lane's own
// row, conflict-free 16-byte reads).
template <int HD>
__device__ __forceinline__ void dot_rows(const float* A, const float* Bm,
                                         int r0, int lane, float* x) {
  constexpr int kLD = HD + 4;
#pragma unroll
  for (int i = 0; i < kRows; ++i) x[i] = 0.f;
  const float4* b4 = reinterpret_cast<const float4*>(Bm + lane * kLD);
#pragma unroll 4
  for (int d4 = 0; d4 < HD / 4; ++d4) {
    const float4 bb = b4[d4];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 aa = reinterpret_cast<const float4*>(A + (r0 + i) * HD)[d4];
      x[i] = fmaf(aa.x, bb.x, x[i]);
      x[i] = fmaf(aa.y, bb.y, x[i]);
      x[i] = fmaf(aa.z, bb.z, x[i]);
      x[i] = fmaf(aa.w, bb.w, x[i]);
    }
  }
}

// (s, dp) of the warp's 8 rows against the lane's key: s = Q.K, dp = dO.V
// in one walk over HD.
template <int HD>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int r0, int lane, float* s,
                                       float* dp) {
  constexpr int kLD = HD + 4;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    s[i] = 0.f;
    dp[i] = 0.f;
  }
  const float4* k4 = reinterpret_cast<const float4*>(Ks + lane * kLD);
  const float4* v4 = reinterpret_cast<const float4*>(Vs + lane * kLD);
#pragma unroll 2
  for (int d4 = 0; d4 < HD / 4; ++d4) {
    const float4 kk = k4[d4];
    const float4 vv = v4[d4];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 qq = reinterpret_cast<const float4*>(Qs + (r0 + i) * HD)[d4];
      const float4 gg = reinterpret_cast<const float4*>(dOs + (r0 + i) * HD)[d4];
      s[i] = fmaf(qq.x, kk.x, s[i]);
      s[i] = fmaf(qq.y, kk.y, s[i]);
      s[i] = fmaf(qq.z, kk.z, s[i]);
      s[i] = fmaf(qq.w, kk.w, s[i]);
      dp[i] = fmaf(gg.x, vv.x, dp[i]);
      dp[i] = fmaf(gg.y, vv.y, dp[i]);
      dp[i] = fmaf(gg.z, vv.z, dp[i]);
      dp[i] = fmaf(gg.w, vv.w, dp[i]);
    }
  }
}

// The keys a query tile [q0, q0 + rows) may see: [k_begin, k_end), k_begin
// a multiple of kBK.
__device__ __forceinline__ void key_band(const Shape& sh, int q0, int rows,
                                         int& k_begin, int& k_end) {
  const int offset = sh.Skv - sh.Sq;
  const int pos_lo = q0 + offset;
  const int pos_hi = min(q0 + rows, sh.Sq) - 1 + offset;
  k_end = sh.causal ? min(sh.Skv, pos_hi + 1) : sh.Skv;
  k_begin = (sh.window ? max(0, pos_lo - sh.window + 1) : 0) / kBK * kBK;
}

// ---------------------------------------------------------------------
// (a) per query row: D = rowsum(dO * O) and, unless given, lse over the
// band
// ---------------------------------------------------------------------
template <int HD, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    lse_delta(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ o, const float* __restrict__ dout,
              float* __restrict__ lse, float* __restrict__ delta,
              Strides st, Shape sh) {
  constexpr int kThreads = WARPS * 32;
  constexpr int kBQ = WARPS * kRows;
  constexpr int kLDK = HD + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][HD]
  float* Ks = Qs + kBQ * HD;                     // [kBK][kLDK]
  const long long* x = st.x;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  const int hk = h / sh.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRows;
  const int offset = sh.Skv - sh.Sq;
  const long long row_base = ((long long)b * sh.Hq + h) * sh.Sq;

  // D for the warp's rows, each a warp reduction over HD
#pragma unroll 1
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    if (row >= sh.Sq) break;
    const float* orow = o + b * x[O] + h * x[O + 1] + row * x[O + 2];
    const float* grow = dout + b * x[DO] + h * x[DO + 1] + row * x[DO + 2];
    float acc = 0.f;
    for (int c = lane; c < HD; c += 32)
      acc = fmaf(orow[c], grow[c], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) delta[row_base + row] = acc;
  }
  if (sh.lse_given) return;

  load_tile<HD, HD, kThreads>(Qs, q + b * x[Q] + h * x[Q + 1] + q0 * x[Q + 2],
                              x[Q + 2], kBQ, min(kBQ, sh.Sq - q0), sh.scale);
  int k_begin, k_end;
  key_band(sh, q0, kBQ, k_begin, k_end);
  const float* kp = k + b * x[K] + hk * x[K + 1];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();  // the previous tile's readers are done
    const int valid = min(kBK, sh.Skv - kt);
    load_tile<HD, kLDK, kThreads>(Ks, kp + kt * x[K + 2], x[K + 2], kBK,
                                     valid, 1.f);
    __syncthreads();
    float s[kRows];
    dot_rows<HD>(Qs, Ks, r0, lane, s);
    const int kpos = kt + lane;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + r0 + i + offset;
      const bool ok = lane < valid && keeps(sh, qpos, kpos);
      float dcap;
      const float xs = capped(s[i], sh.softcap, dcap);
      float mx = ok ? xs : kNegInf;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float ps = ok ? expf(xs - m_new) : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(kFull, ps, off);
      l[i] = l[i] * expf(m[i] - m_new) + ps;
      m[i] = m_new;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + r0 + i;
      if (row < sh.Sq) lse[row_base + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
    }
  }
}

// ---------------------------------------------------------------------
// (b) per key tile: dK and dV over every query tile and head of the band
// ---------------------------------------------------------------------
template <int HD>
constexpr int dkdv_smem() {
  return 4 * (2 * kBK * (HD + 4) + 2 * kBQB * HD + 2 * kBQB * kBK + 2 * kBQB);
}

template <int HD>
__global__ void __launch_bounds__(kWarpsB * 32)
    dkdv(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         float* __restrict__ dk, float* __restrict__ dv, Strides st, Shape sh) {
  constexpr int kThreads = kWarpsB * 32;
  constexpr int kLDK = HD + 4;
  constexpr int kCols = HD / 32;  // columns a lane accumulates
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [kBK][kLDK]
  float* Vs = Ks + kBK * kLDK;                   // [kBK][kLDK]
  float* Qs = Vs + kBK * kLDK;                   // [kBQB][HD], scaled
  float* dOs = Qs + kBQB * HD;                   // [kBQB][HD]
  float* Ps = dOs + kBQB * HD;                   // [kBQB][kBK]
  float* dSs = Ps + kBQB * kBK;                  // [kBQB][kBK]
  float* Ls = dSs + kBQB * kBK;                  // [kBQB] lse
  float* Ds = Ls + kBQB;                         // [kBQB] D
  const long long* x = st.x;
  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * kBK;   // the first key tiles see the most rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRows;
  const int kw = warp * kKeysWarp;   // this warp's keys in the accumulation
  const int offset = sh.Skv - sh.Sq;
  const int kvalid = min(kBK, sh.Skv - k0);

  load_tile<HD, kLDK, kThreads>(Ks, k + b * x[K] + hk * x[K + 1] + k0 * x[K + 2],
                                   x[K + 2], kBK, kvalid, 1.f);
  load_tile<HD, kLDK, kThreads>(Vs, v + b * x[V] + hk * x[V + 1] + k0 * x[V + 2],
                                   x[V + 2], kBK, kvalid, 1.f);
  // the query rows whose band reaches these keys
  const int q_lo = sh.causal ? max(0, k0 - offset) : 0;
  const int q_hi = sh.window ? min(sh.Sq, k0 + kBK - 1 + sh.window - offset)
                             : sh.Sq;

  float adk[kKeysWarp][kCols], adv[kKeysWarp][kCols];
#pragma unroll
  for (int kk = 0; kk < kKeysWarp; ++kk) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      adk[kk][c] = 0.f;
      adv[kk][c] = 0.f;
    }
  }
  const int kpos = k0 + lane;
  for (int g = 0; g < sh.group; ++g) {
    const int h = hk * sh.group + g;
    const long long row_base = ((long long)b * sh.Hq + h) * sh.Sq;
    for (int qt = q_lo; qt < q_hi; qt += kBQB) {
      const int rows = min(kBQB, q_hi - qt);
      __syncthreads();  // the previous tile's readers are done
      load_tile<HD, HD, kThreads>(Qs, q + b * x[Q] + h * x[Q + 1] + qt * x[Q + 2],
                                     x[Q + 2], kBQB, rows, sh.scale);
      load_tile<HD, HD, kThreads>(
          dOs, dout + b * x[DO] + h * x[DO + 1] + qt * x[DO + 2], x[DO + 2],
          kBQB, rows, 1.f);
      for (int r = threadIdx.x; r < kBQB; r += kThreads) {
        Ls[r] = r < rows ? lse[row_base + qt + r] : 0.f;
        Ds[r] = r < rows ? delta[row_base + qt + r] : 0.f;
      }
      __syncthreads();

      // score pass: P and dS of the warp's 8 rows against the lane's key
      float s[kRows], dp[kRows];
      scores<HD>(Qs, dOs, Ks, Vs, r0, lane, s, dp);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r0 + i;
        const bool ok = r < rows && lane < kvalid &&
                        keeps(sh, qt + r + offset, kpos);
        float dcap;
        const float xs = capped(s[i], sh.softcap, dcap);
        const float p = ok ? expf(xs - Ls[r]) : 0.f;
        Ps[r * kBK + lane] = p;
        dSs[r * kBK + lane] = p * (dp[i] - Ds[r]) * dcap;
      }
      __syncthreads();

      // accumulation: dV += P^T dO, dK += dS^T Q for the warp's 4 keys
#pragma unroll 2
      for (int r = 0; r < rows; ++r) {
        const float4 pp = reinterpret_cast<const float4*>(Ps + r * kBK + kw)[0];
        const float4 dd = reinterpret_cast<const float4*>(dSs + r * kBK + kw)[0];
        const float pk[kKeysWarp] = {pp.x, pp.y, pp.z, pp.w};
        const float dk4[kKeysWarp] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float go = dOs[r * HD + lane + 32 * c];
          const float qq = Qs[r * HD + lane + 32 * c];
#pragma unroll
          for (int kk = 0; kk < kKeysWarp; ++kk) {
            adv[kk][c] = fmaf(pk[kk], go, adv[kk][c]);
            adk[kk][c] = fmaf(dk4[kk], qq, adk[kk][c]);
          }
        }
      }
    }
  }

  float* dkp = dk + b * x[DK] + hk * x[DK + 1];
  float* dvp = dv + b * x[DV] + hk * x[DV + 1];
#pragma unroll
  for (int kk = 0; kk < kKeysWarp; ++kk) {
    const int key = k0 + kw + kk;
    if (key < sh.Skv) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dkp[key * x[DK + 2] + lane + 32 * c] = adk[kk][c];
        dvp[key * x[DV + 2] + lane + 32 * c] = adv[kk][c];
      }
    }
  }
}

// ---------------------------------------------------------------------
// (c) per query tile: dQ over the band
// ---------------------------------------------------------------------
template <int HD, int WARPS>
constexpr int dq_smem() {
  return 4 * (2 * WARPS * kRows * HD + 2 * kBK * (HD + 4) +
              WARPS * kRows * kBK);
}

template <int HD, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, Strides st, Shape sh) {
  constexpr int kThreads = WARPS * 32;
  constexpr int kBQ = WARPS * kRows;
  constexpr int kLDK = HD + 4;
  constexpr int kCols = HD / 32;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][HD], scaled
  float* dOs = Qs + kBQ * HD;                    // [kBQ][HD]
  float* Ks = dOs + kBQ * HD;                    // [kBK][kLDK]
  float* Vs = Ks + kBK * kLDK;                   // [kBK][kLDK]
  float* dSs = Vs + kBK * kLDK;                  // [kBQ][kBK]
  const long long* x = st.x;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  const int hk = h / sh.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRows;
  const int offset = sh.Skv - sh.Sq;
  const long long row_base = ((long long)b * sh.Hq + h) * sh.Sq;
  const int nrows = min(kBQ, sh.Sq - q0);

  load_tile<HD, HD, kThreads>(Qs, q + b * x[Q] + h * x[Q + 1] + q0 * x[Q + 2],
                                 x[Q + 2], kBQ, nrows, sh.scale);
  load_tile<HD, HD, kThreads>(dOs, dout + b * x[DO] + h * x[DO + 1] + q0 * x[DO + 2],
                                 x[DO + 2], kBQ, nrows, 1.f);
  float L[kRows], D[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    L[i] = row < sh.Sq ? lse[row_base + row] : 0.f;
    D[i] = row < sh.Sq ? delta[row_base + row] : 0.f;
  }
  int k_begin, k_end;
  key_band(sh, q0, kBQ, k_begin, k_end);
  const float* kp = k + b * x[K] + hk * x[K + 1];
  const float* vp = v + b * x[V] + hk * x[V + 1];
  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();  // the previous tile's readers are done
    const int valid = min(kBK, sh.Skv - kt);
    load_tile<HD, kLDK, kThreads>(Ks, kp + kt * x[K + 2], x[K + 2], kBK,
                                     valid, 1.f);
    load_tile<HD, kLDK, kThreads>(Vs, vp + kt * x[V + 2], x[V + 2], kBK,
                                     valid, 1.f);
    __syncthreads();
    float s[kRows], dp[kRows];
    scores<HD>(Qs, dOs, Ks, Vs, r0, lane, s, dp);
    const int kpos = kt + lane;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i;
      const bool ok = r < nrows && lane < valid &&
                      keeps(sh, q0 + r + offset, kpos);
      float dcap;
      const float xs = capped(s[i], sh.softcap, dcap);
      const float p = ok ? expf(xs - L[i]) : 0.f;
      dSs[r * kBK + lane] = p * (dp[i] - D[i]) * dcap;
    }
    __syncwarp();
    // acc += dS K over the tile's keys
#pragma unroll 2
    for (int j4 = 0; j4 < kBK / 4; ++j4) {
      float4 dd[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        dd[i] = reinterpret_cast<const float4*>(dSs + (r0 + i) * kBK)[j4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* krow = Ks + (j4 * 4 + jj) * kLDK + lane;
        float kv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) kv[c] = krow[32 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float d = jj == 0 ? dd[i].x
                        : jj == 1 ? dd[i].y
                        : jj == 2 ? dd[i].z
                                  : dd[i].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(d, kv[c], acc[i][c]);
        }
      }
    }
  }

  float* dqp = dq + b * x[DQ] + h * x[DQ + 1];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    if (row < sh.Sq) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        dqp[row * x[DQ + 2] + lane + 32 * c] = acc[i][c] * sh.scale;
    }
  }
}

template <int HD>
constexpr int lse_smem(int warps) {
  return 4 * (warps * kRows * HD + kBK * (HD + 4));
}

template <int HD, int WARPS>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, const Strides& st, const Shape& sh, int B, int Hkv,
           cudaStream_t s) {
  constexpr int kBQ = WARPS * kRows;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  const dim3 rows_grid(sh.Hq, (sh.Sq + kBQ - 1) / kBQ, B);

  auto ka = lse_delta<HD, WARPS>;
  constexpr int sa = lse_smem<HD>(WARPS);
  cudaError_t e = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, sa);
  if (e != cudaSuccess) return (int)e;
  ka<<<rows_grid, WARPS * 32, sa, s>>>(qt, kt, static_cast<const float*>(o), dot,
                                        lse, delta, st, sh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto kb = dkdv<HD>;
  constexpr int sb = dkdv_smem<HD>();
  e = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           sb);
  if (e != cudaSuccess) return (int)e;
  kb<<<dim3(Hkv, (sh.Skv + kBK - 1) / kBK, B), kWarpsB * 32, sb, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
      st, sh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto kc = dq_kernel<HD, WARPS>;
  constexpr int sc = dq_smem<HD, WARPS>();
  e = cudaFuncSetAttribute(kc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           sc);
  if (e != cudaSuccess) return (int)e;
  kc<<<rows_grid, WARPS * 32, sc, s>>>(qt, kt, vt, dot, lse, delta,
                                        static_cast<float*>(dq), st, sh);
  return (int)cudaGetLastError();
}

int dispatch(int hd, const void* q, const void* k, const void* v,
             const void* o, const void* dout, void* dq, void* dk, void* dv,
             float* lse, float* delta, const Strides& st, const Shape& sh,
             int B, int Hkv, cudaStream_t s) {
  // the row kernels (a) and (c): 8 warps (64 query rows) a CTA; hd = 256
  // takes 4 so that (c)'s Q, dO, K and V tiles fit in shared memory
  switch (hd) {
    case 32:
      return launch<32, 8>(q, k, v, o, dout, dq, dk, dv, lse, delta, st,
                              sh, B, Hkv, s);
    case 64:
      return launch<64, 8>(q, k, v, o, dout, dq, dk, dv, lse, delta, st,
                              sh, B, Hkv, s);
    case 128:
      return launch<128, 8>(q, k, v, o, dout, dq, dk, dv, lse, delta, st,
                               sh, B, Hkv, s);
    case 256:
      return launch<256, 4>(q, k, v, o, dout, dq, dk, dv, lse, delta, st,
                               sh, B, Hkv, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, hd), k/v (B, Hkv, Skv, hd), o and dout like q, dq like q,
// dk/dv like k, all f32, each addressed by the 24 element strides in
// `strides` (q, k, v, o, dout, dq, dk, dv; batch, head, seq); hd in {32,
// 64, 128, 256} is contiguous; every pointer and stride is a multiple of
// 16 bytes.  lse and delta: f32 (B, Hq, Sq); lse holds the forward's
// log-sum-exp if lse_given, else it is scratch like delta.  Returns a
// cudaError_t code (0 on success).  Three launches, in order.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, void* dq, void* dk,
                        void* dv, void* lse, void* delta,
                        const long long* strides, int B, int Hq, int Hkv,
                        int Sq, int Skv, int hd, float scale, int causal,
                        int window, float softcap, int lse_given,
                        void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv < Sq) return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 24; ++i) st.x[i] = strides[i];
  const Shape sh{Hq,    Hq / Hkv, Sq,      Skv,      causal,
                 window, scale,    softcap, lse_given};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(delta);
  return dispatch(hd, q, k, v, o, dout, dq, dk, dv, l, d, st, sh, B,
                         Hkv, s);
}

}  // extern "C"
