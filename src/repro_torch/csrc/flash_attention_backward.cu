// Flash attention backward for Hopper (sm_90a), f32: dQ, dK and dV of the
// forward of flash_attention.cu (causal and sliding-window masks, the
// gemma2 logit softcap, GQA/MQA, queries right-aligned to the KV tail, hd
// in {32, 64, 80, 128, 256}, bidirectional (causal = 0) or causal),
// every product on the tensor cores in 3xTF32 (tf32x3.cuh: each operand
// split hi / lo, ~21-22 bits a product, sums in f32).  bf16 inputs go to
// the wgmma kernels of flash_attention_backward_bf16.cu.
//
// Replaces: the gradient XLA derives for the reference's jnp attention
// (src/repro/models/layers.py, attention_forward with use_flash=False,
// _sdpa); the reference's Pallas kernel
// (src/repro/kernels/flash_attention.py) is forward only, and the
// reference trains through the jnp path.
//
// Contract (src/repro_torch/kernels/ref.py flash_attention_backward): with
// s = q.k / sqrt(hd) in f32, optionally s_c = tanh(s / cap) * cap,
// P = exp(s_c - LSE) over the unmasked keys of each query row (LSE the
// forward's, natural log, f32 (B, Hq, Sq)),
//     dV = P^T dO,  dP = dO V^T,  D = rowsum(dO * O),
//     dS = P * (dP - D)  [* (1 - tanh^2(s / cap))],
//     dQ = dS K / sqrt(hd),  dK = dS^T Q / sqrt(hd),
// dK and dV summed over the g query heads that share a KV head.
//
// Bound on this card: operations.  The band's backward is 2.5 times the
// forward's 4 * hd flops a (query, key) pair (S and dP again, then dV, dK
// and dQ).  In f32 FMAs that is flops / 67 TFLOP/s; f32-accurate on the
// tensor cores, three TF32 products each, flops / 165 TFLOP/s.  At the
// training check's (1, 10, 2176, 256) over one KV head, window 2,048:
// 60.4 GFLOP, 0.366 ms (3xTF32) against 0.90 ms (FMA).  This design does
// 7 products a pair, not 5: dQ's kernel forms S and dP again rather than
// take dS from the dK/dV kernel, which buys determinism without atomics;
// and mma.sync, its TF32 path, reaches ~317 of the 495 TFLOP/s
// (launch/profile_mma_peak.py).
//
// Design: three launches in one call (two where no key tile is split),
// deterministic (no atomics; every sum in a fixed order).  Tiles sit in
// shared memory in f32 at a padded pitch (tf32x3.cuh); every product is
// mma.sync m16n8k8 in 3xTF32 with each operand split as it is loaded.
//   (a) dq: one CTA per (64 query rows, head, batch), longest tiles first.
//       It first forms D = rowsum(dO * O) for its rows (into the scratch,
//       for (b)), keeps Q and dO in shared memory and streams 16-key K and
//       V tiles through a two-stage cp.async ring (hd = 256: 66 + 66 + 2 x
//       33 KB and a 16 KB exchange).  8 warps in 4 pairs, a pair per 16
//       rows and a warp per half of hd: each warp forms its half of the
//       contraction of S = Q K^T and dP = dO V^T (16 x 16), the pair swaps
//       halves through shared memory on a named barrier and adds them in
//       one order, so both hold the same dS, and each adds dS K into its
//       half of dQ (16 x hd / 2: 64 f32 a lane at hd = 256; a warp of the
//       whole width held 128 and left one warp a sub-partition).  dS's
//       accumulator is, as it stands, the A fragment over keys.
//   (b) dkdv: a CTA holds one 64-key tile's K and V (132 KB at hd = 256)
//       and walks a run of the band's steps, a step one 16-row query tile
//       of one head, its Q, dO, LSE and D through a two-stage cp.async
//       ring.  8 warps in 4 pairs, a pair per 16 keys, so that each warp
//       keeps one 16 x hd accumulator: the even warp forms S^T = K Q^T,
//       P^T, and dV += P^T dO; the odd one dP^T = V dO^T, takes P^T (times
//       the softcap's factor) from its partner lane for lane through
//       shared memory on a named barrier, and forms dS^T and dK += dS^T Q.
//       The band is spread over the card as in the bf16 backward (its
//       planning, at this kernel's tiles): a key tile's steps (g heads x
//       its query tiles; under MQA the first key tile has many times the
//       last one's) are cut into runs of at most `chunk` steps, `chunk`
//       the one of least estimated time (whole waves of the SMs times the
//       longest run); a key tile of one run writes dK and dV itself, the
//       runs of a longer one write f32 partials.
//   (c) sum: the partials of each split key tile, in run order.
// Masks are applied element by element on every tile; (a) and (b) walk
// only the tiles the band touches.  Loads past Sq or Skv read zeros.

#include <math.h>

#include <algorithm>
#include <mutex>
#include <vector>

#include "tf32x3.cuh"

namespace {

constexpr int kKT = 64;            // keys of a dK/dV tile
constexpr int kStep = 16;          // query rows of a dK/dV step
constexpr int kPairs = kKT / 16;   // warp pairs of a dK/dV CTA
constexpr int kThreadsKV = 64 * kPairs;
constexpr int kQT = 64;            // query rows of a dQ tile
constexpr int kThreadsQ = 256;     // 4 pairs of 16 rows
constexpr int kBK = 16;            // keys of a dQ key tile
// the most steps of a dK/dV run.  A run's error grows with its length
// (the tensor cores' f32 accumulation is not rounded to nearest, so each
// mma3 biases dK and dV by up to an ulp of the accumulator): against an
// f64 backward, runs of ~2,000 steps read 1.85 times the f32 limit at
// (1, 32:4, 4096, 128), runs of ~130 steps 0.12.  The runs' partials are
// summed in f32 by (c).
constexpr int kMaxRun = 64;

// element strides of (batch, head, seq) of q, k, v, o, do, dq, dk, dv; hd
// is contiguous
struct Strides {
  long long x[24];
};
enum { Q = 0, K = 3, V = 6, O = 9, DO = 12, DQ = 15, DK = 18, DV = 21 };

struct Shape {
  int Hq, group, Sq, Skv, causal, window;
  float scale, softcap;
  int n_kt;      // dK/dV key tiles
  int chunk;     // the most steps of a dK/dV CTA
  int n_runs;    // dK/dV CTAs of one (batch, KV head)
};

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

// The query steps whose rows see some key of key tile j:
// [qt_lo, qt_lo + n_qt) in kStep-row tiles.
__host__ __device__ __forceinline__ void key_band(const Shape& sh, int j,
                                                  int& qt_lo, int& n_qt) {
  const int k0 = j * kKT;
  const int k_last = imin(k0 + kKT, sh.Skv) - 1;
  const int offset = sh.Skv - sh.Sq;
  const int q_lo = sh.causal ? imax(0, k0 - offset) : 0;
  const int q_hi = sh.window ? imin(sh.Sq, k_last + sh.window - offset)
                             : sh.Sq;             // exclusive
  qt_lo = q_lo / kStep;
  n_qt = q_hi > q_lo ? (q_hi + kStep - 1) / kStep - qt_lo : 0;
}

// steps of key tile j, and the runs they are cut into
__host__ __device__ __forceinline__ int tile_steps(const Shape& sh, int j) {
  int lo, n;
  key_band(sh, j, lo, n);
  return n * sh.group;
}
__host__ __device__ __forceinline__ int tile_runs(int steps, int chunk) {
  return steps > chunk ? (steps + chunk - 1) / chunk : 1;
}

// Whether query position `qpos` sees key `kpos` (< Skv checked by the
// caller).
__device__ __forceinline__ bool keeps(const Shape& sh, int qpos, int kpos) {
  bool ok = true;
  if (sh.causal) ok = kpos <= qpos;
  if (sh.window) ok = ok && qpos - kpos < sh.window;
  return ok;
}

// The softcapped score of the scaled s and, with a softcap, its
// derivative factor 1 - tanh^2 (1 without one).
__device__ __forceinline__ float capped(float s, float softcap, float& dcap) {
  if (softcap > 0.f) {
    const float t = tanhf(s / softcap);
    dcap = 1.f - t * t;
    return t * softcap;
  }
  dcap = 1.f;
  return s;
}

// ---------------------------------------------------------------------
// (a) per query tile: D for its rows, then dQ over the band
// ---------------------------------------------------------------------
template <int HD>
constexpr int dq_smem() {
  // Q, dO; two stages of K, V; D; the S / dP exchange
  return 4 * ((2 * kQT + 2 * 2 * kBK) * kPitchRows<HD> + kQT +
              kThreadsQ / 32 * 16 * 32);
}
static_assert(dq_smem<256>() <= 232448, "dq shared memory");

template <int HD>
__global__ void __launch_bounds__(kThreadsQ, 1)
    flash_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ o,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      float* __restrict__ delta, float* __restrict__ dq,
                      Strides st, Shape sh) {
  constexpr int kHalf = HD / 2;     // hd columns a warp of a pair takes
  constexpr int kOT = kHalf / 8;
  constexpr int LR = kPitchRows<HD>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kQT][LR]
  float* dOs = Qs + kQT * LR;                    // [kQT][LR]
  float* KV = dOs + kQT * LR;                    // stage s: K, then V [kBK][LR]
  float* Ds = KV + 2 * 2 * kBK * LR;             // [kQT]
  float* xchg = Ds + kQT;                        // [warp][16][32]
  const long long* x = st.x;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQT;  // longest tiles first
  const int hk = h / sh.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp >> 1, half = warp & 1;
  const int r0 = pair * 16;                 // the pair's rows in the tile
  const int c0 = half * kHalf;              // this warp's hd columns
  const int offset = sh.Skv - sh.Sq;
  const long long row_base = ((long long)b * sh.Hq + h) * sh.Sq;
  const int nrows = imin(kQT, sh.Sq - q0);

  // the keys any row of this tile may see, in whole tiles
  const int pos_lo = q0 + offset, pos_hi = q0 + nrows - 1 + offset;
  const int k_end = sh.causal ? imin(sh.Skv, pos_hi + 1) : sh.Skv;
  const int k_begin =
      (sh.window ? imax(0, pos_lo - sh.window + 1) : 0) / kBK * kBK;
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;
  const float* kp = k + b * x[K] + hk * x[K + 1];
  const float* vp = v + b * x[V] + hk * x[V + 1];
  auto load_kv = [&](int i) {
    const int kt = k_begin + i * kBK;
    const int valid = imin(kBK, sh.Skv - kt);
    float* Ks = KV + (i & 1) * 2 * kBK * LR;
    load_tile_async<HD, LR, kThreadsQ>(Ks, kp + kt * x[K + 2], x[K + 2], kBK,
                                       valid);
    load_tile_async<HD, LR, kThreadsQ>(Ks + kBK * LR, vp + kt * x[V + 2],
                                       x[V + 2], kBK, valid);
    cp_async_commit();
  };
  load_tile_async<HD, LR, kThreadsQ>(
      Qs, q + b * x[Q] + h * x[Q + 1] + q0 * x[Q + 2], x[Q + 2], kQT, nrows);
  load_tile_async<HD, LR, kThreadsQ>(
      dOs, dout + b * x[DO] + h * x[DO + 1] + q0 * x[DO + 2], x[DO + 2], kQT,
      nrows);
  if (n_tiles > 0) load_kv(0);
  else cp_async_commit();

  // D = rowsum(dO * O) of the tile's rows, 8 a warp, a warp reduction each
#pragma unroll 1
  for (int i = 0; i < kQT / (kThreadsQ / 32); ++i) {
    const int r = warp * (kQT / (kThreadsQ / 32)) + i;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < sh.Sq) {
      const float* orow = o + b * x[O] + h * x[O + 1] + row * x[O + 2];
      const float* grow = dout + b * x[DO] + h * x[DO + 1] + row * x[DO + 2];
      for (int c = lane; c < HD; c += 32) acc = fmaf(orow[c], grow[c], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kFullMask, acc, off);
      if (lane == 0) delta[row_base + row] = acc;
    }
    if (lane == 0) Ds[r] = acc;
  }
  __syncthreads();
  float L[2], D[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    L[r] = row < sh.Sq ? lse[row_base + row] : 0.f;
    D[r] = Ds[r0 + g + 8 * r];
  }

  float acc[kOT][4];
#pragma unroll
  for (int n = 0; n < kOT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int qpos0 = q0 + r0 + g + offset;
  float* mine = xchg + warp * 16 * 32;
  const float* other = xchg + (warp ^ 1) * 16 * 32;
  const float* qa = Qs + (r0 + g) * LR + 2 * t;    // Q's and dO's A
  const float* ga = dOs + (r0 + g) * LR + 2 * t;

  for (int i = 0; i < n_tiles; ++i) {
    const int kt = k_begin + i * kBK;
    cp_async_wait<0>();
    __syncthreads();        // tile i landed; every warp is done with i - 1
    if (i + 1 < n_tiles) load_kv(i + 1);
    const float* Ks = KV + (i & 1) * 2 * kBK * LR;
    const float* kb = Ks + g * LR + 2 * t;              // K's B, by rows
    const float* vb = kb + kBK * LR;                    // V's B, by rows
    const float* kc = Ks + 2 * t * LR + g;              // K's B, by columns

    // this warp's half of the contraction over hd: S = Q K^T and dP =
    // dO V^T (16 x 16), two accumulator sets on alternate 8-column steps
    float s[2][2][4], dp[2][2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[u][j][e] = dp[u][j][e] = 0.f;
#pragma unroll 2
    for (int c = c0; c < c0 + kHalf / 16 * 16; c += 16) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const FragA aq = frag_a<LR>(qa, c + 8 * u);
        const FragA ag = frag_a<LR>(ga, c + 8 * u);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma3(s[u][j], aq, frag_b_rows(kb + 8 * j * LR, c + 8 * u));
          mma3(dp[u][j], ag, frag_b_rows(vb + 8 * j * LR, c + 8 * u));
        }
      }
    }
    if constexpr (kHalf % 16 != 0) {
      // hd = 80: a half of 40 columns ends in a fifth 8-column step
      const int c = c0 + kHalf - 8;
      const FragA aq = frag_a<LR>(qa, c);
      const FragA ag = frag_a<LR>(ga, c);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma3(s[0][j], aq, frag_b_rows(kb + 8 * j * LR, c));
        mma3(dp[0][j], ag, frag_b_rows(vb + 8 * j * LR, c));
      }
    }
    // the pair swaps halves; both add them in one order (low half first),
    // so both hold the same S and dP bit for bit
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[0][j][e] += s[1][j][e];
        dp[0][j][e] += dp[1][j][e];
        mine[(j * 4 + e) * 32 + lane] = s[0][j][e];
        mine[(8 + j * 4 + e) * 32 + lane] = dp[0][j][e];
      }
    }
    bar_sync(1 + pair, 64);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float so = other[(j * 4 + e) * 32 + lane];
        const float po = other[(8 + j * 4 + e) * 32 + lane];
        const float sf = half ? so + s[0][j][e] : s[0][j][e] + so;
        const float pf = half ? po + dp[0][j][e] : dp[0][j][e] + po;
        const int kpos = kt + 8 * j + 2 * t + (e & 1);
        const int qpos = qpos0 + (e >> 1) * 8;
        const bool ok = qpos - offset < sh.Sq && kpos < sh.Skv &&
                        keeps(sh, qpos, kpos);
        float dcap;
        const float xs = capped(sf * sh.scale, sh.softcap, dcap);
        const float p = ok ? expf(xs - L[e >> 1]) : 0.f;
        s[0][j][e] = p * (pf - D[e >> 1]) * dcap;     // dS
      }
    }
    // dQ[:, this half] += dS K[:, this half] over the tile's 16 keys
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const FragA a = acc_as_a(s[0][j]);
#pragma unroll
      for (int n = 0; n < kOT; ++n)
        mma3(acc[n], a, frag_b_cols<LR>(kc, 8 * j, c0 + 8 * n));
    }
  }
  cp_async_wait<0>();

  float* dqp = dq + b * x[DQ] + h * x[DQ + 1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= sh.Sq) continue;
    float* drow = dqp + row * x[DQ + 2] + c0;
#pragma unroll
    for (int n = 0; n < kOT; ++n)
      *reinterpret_cast<float2*>(drow + 8 * n + 2 * t) = make_float2(
          acc[n][2 * r] * sh.scale, acc[n][2 * r + 1] * sh.scale);
  }
}

// ---------------------------------------------------------------------
// (b) per key tile: dK and dV over a run of the band's steps
// ---------------------------------------------------------------------
template <int HD>
constexpr int dkdv_smem() {
  // K, V; two stages of Q, dO; two stages of LSE, D; the P^T exchange
  return 4 * ((2 * kKT + 2 * 2 * kStep) * kPitchRows<HD> + 2 * 2 * kStep +
              kPairs * 32 * 8);
}
static_assert(dkdv_smem<256>() <= 232448, "dkdv shared memory");

template <int HD>
__global__ void __launch_bounds__(kThreadsKV, 1)
    flash_bwd_dkdv_tf32(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float* __restrict__ partial, Strides st, Shape sh) {
  constexpr int kOT = HD / 8;
  constexpr int LR = kPitchRows<HD>;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [kKT][LR]
  float* Vs = Ks + kKT * LR;                     // [kKT][LR]
  float* QD = Vs + kKT * LR;                     // stage s: Q, then dO
  float* stats = QD + 2 * 2 * kStep * LR;        // stage s: LSE, then D
  float* xchg = stats + 2 * 2 * kStep;           // [pair][8][32]
  const long long* x = st.x;

  // this CTA's key tile j and its run [it0, it0 + n) of the tile's steps
  const int hk = blockIdx.y, b = blockIdx.z;
  int j = 0, first = 0, steps = 0, runs = 1;
  for (;; ++j) {
    steps = tile_steps(sh, j);
    runs = tile_runs(steps, sh.chunk);
    if ((int)blockIdx.x < first + runs || j == sh.n_kt - 1) break;
    first += runs;
  }
  const int run = blockIdx.x - first;
  const int it0 = (int)((long long)run * steps / runs);
  const int n = (int)((long long)(run + 1) * steps / runs) - it0;
  int qt_lo, n_qt;
  key_band(sh, j, qt_lo, n_qt);
  const int k0 = j * kKT;
  const int offset = sh.Skv - sh.Sq;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp >> 1, odd = warp & 1;
  const int key0 = pair * 16;              // the pair's keys in the tile

  const int kvalid = imin(kKT, sh.Skv - k0);
  load_tile_async<HD, LR, kThreadsKV>(
      Ks, k + b * x[K] + hk * x[K + 1] + k0 * x[K + 2], x[K + 2], kKT, kvalid);
  load_tile_async<HD, LR, kThreadsKV>(
      Vs, v + b * x[V] + hk * x[V + 1] + k0 * x[V + 2], x[V + 2], kKT, kvalid);
  // step i of the run: head hk * group + (it0 + i) / n_qt, query rows from
  // (qt_lo + (it0 + i) % n_qt) * kStep
  auto load_step = [&](int i) {
    const int it = it0 + i;
    const int h = hk * sh.group + it / n_qt;
    const int r0 = (qt_lo + it % n_qt) * kStep;
    const int rows = imin(kStep, sh.Sq - r0);
    float* Qst = QD + (i & 1) * 2 * kStep * LR;
    load_tile_async<HD, LR, kThreadsKV>(
        Qst, q + b * x[Q] + h * x[Q + 1] + r0 * x[Q + 2], x[Q + 2], kStep,
        rows);
    load_tile_async<HD, LR, kThreadsKV>(
        Qst + kStep * LR, dout + b * x[DO] + h * x[DO + 1] + r0 * x[DO + 2],
        x[DO + 2], kStep, rows);
    if (threadIdx.x < 2 * kStep) {
      const int r = threadIdx.x % kStep;
      const float* src = (threadIdx.x < kStep ? lse : delta) +
                         ((long long)b * sh.Hq + h) * sh.Sq + r0;
      cp_async4(stats + (i & 1) * 2 * kStep + threadIdx.x,
                r < rows ? src + r : src, r < rows);
    }
    cp_async_commit();
  };
  if (n > 0) load_step(0);
  else cp_async_commit();

  // the warp's accumulator: dV (even warp) or dK (odd warp), 16 keys x HD
  float acc[kOT][4];
#pragma unroll
  for (int c = 0; c < kOT; ++c)
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  float* xw = xchg + pair * 8 * 32;
  // S^T = K Q^T (even warp) or dP^T = V dO^T (odd): K's or V's A fragments
  const float* ka = (odd ? Vs : Ks) + (key0 + g) * LR + 2 * t;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<0>();
    __syncthreads();        // step i landed; every warp is done with i - 1
    if (i + 1 < n) load_step(i + 1);
    const int it = it0 + i;
    const int r0 = (qt_lo + it % n_qt) * kStep;   // the step's first row
    const float* Qst = QD + (i & 1) * 2 * kStep * LR;
    const float* dOst = Qst + kStep * LR;
    const float* Lst = stats + (i & 1) * 2 * kStep;
    const float* Dst = Lst + kStep;
    // Q's (even) or dO's (odd) B by rows, for the 16 x 16 S^T or dP^T;
    // dO's (even: dV) or Q's (odd: dK) B by columns, for the accumulation
    const float* br = (odd ? dOst : Qst) + g * LR + 2 * t;
    const float* bc = (odd ? Qst : dOst) + 2 * t * LR + g;
    float s[2][2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[u][jj][e] = 0.f;
#pragma unroll 2
    for (int c = 0; c < HD; c += 16) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const FragA a = frag_a<LR>(ka, c + 8 * u);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          mma3(s[u][jj], a, frag_b_rows(br + 8 * jj * LR, c + 8 * u));
      }
    }
    // accumulator (key g / g + 8, row 8 jj + 2t / + 1)
    if (!odd) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 8 * jj + 2 * t + (e & 1);
          const int kpos = k0 + key0 + g + 8 * (e >> 1);
          const int qpos = r0 + row + offset;
          const bool ok = r0 + row < sh.Sq && kpos < sh.Skv &&
                          keeps(sh, qpos, kpos);
          float dcap;
          const float xs =
              capped((s[0][jj][e] + s[1][jj][e]) * sh.scale, sh.softcap, dcap);
          const float p = ok ? expf(xs - Lst[row]) : 0.f;
          s[0][jj][e] = p;
          xw[(jj * 4 + e) * 32 + lane] = p * dcap;
        }
      }
      bar_arrive(1 + pair, 64);
      // dV += P^T dO over the step's 16 rows
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const FragA a = acc_as_a(s[0][jj]);
#pragma unroll
        for (int c = 0; c < kOT; ++c)
          mma3(acc[c], a, frag_b_cols<LR>(bc, 8 * jj, 8 * c));
      }
    } else {
      bar_sync(1 + pair, 64);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 8 * jj + 2 * t + (e & 1);
          s[0][jj][e] = xw[(jj * 4 + e) * 32 + lane] *
                        (s[0][jj][e] + s[1][jj][e] - Dst[row]);
        }
      }
      // dK += dS^T Q over the step's 16 rows
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const FragA a = acc_as_a(s[0][jj]);
#pragma unroll
        for (int c = 0; c < kOT; ++c)
          mma3(acc[c], a, frag_b_cols<LR>(bc, 8 * jj, 8 * c));
      }
    }
  }
  cp_async_wait<0>();

  const float mul = odd ? sh.scale : 1.f;
  if (runs == 1) {
    const int o = odd ? DK : DV;
    float* dst = (odd ? dk : dv) + b * x[o] + hk * x[o + 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + key0 + g + 8 * r;
      if (key >= sh.Skv) continue;
      float* row = dst + key * x[o + 2];
#pragma unroll
      for (int c = 0; c < kOT; ++c)
        *reinterpret_cast<float2*>(row + 8 * c + 2 * t) =
            make_float2(acc[c][2 * r] * mul, acc[c][2 * r + 1] * mul);
    }
  } else {
    // f32 partials, [run][dV, dK][key][column], scaled
    float* dst = partial +
                 ((((long long)b * gridDim.y + hk) * sh.n_runs + blockIdx.x) *
                      2 + odd) * kKT * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* row = dst + (key0 + g + 8 * r) * HD;
#pragma unroll
      for (int c = 0; c < kOT; ++c)
        *reinterpret_cast<float2*>(row + 8 * c + 2 * t) =
            make_float2(acc[c][2 * r] * mul, acc[c][2 * r + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------
// (c) per key tile of several runs: dV and dK, the runs summed in order
// ---------------------------------------------------------------------
template <int HD>
constexpr int kSumBlocks = 2 * kKT * HD / 4 / 256;   // blocks a key tile
static_assert(2 * kKT * 80 / 4 % 256 == 0, "whole sum blocks at hd = 80");

template <int HD>
__global__ void __launch_bounds__(256)
    flash_bwd_dkdv_sum_tf32(const float* __restrict__ partial,
                            float* __restrict__ dk, float* __restrict__ dv,
                            Strides st, Shape sh) {
  const int j = blockIdx.x / kSumBlocks<HD>, hk = blockIdx.y, b = blockIdx.z;
  int first = 0;
  for (int jj = 0; jj < j; ++jj)
    first += tile_runs(tile_steps(sh, jj), sh.chunk);
  const int runs = tile_runs(tile_steps(sh, j), sh.chunk);
  if (runs == 1) return;                 // (b) wrote this tile itself
  const int i = (blockIdx.x % kSumBlocks<HD>) * 256 + threadIdx.x;
  const int part = i / (kKT * HD / 4);   // 0: dV, 1: dK
  const int row = i / (HD / 4) % kKT, col = i % (HD / 4) * 4;
  const int key = j * kKT + row;
  if (key >= sh.Skv) return;
  const float* src = partial +
                     ((((long long)b * gridDim.y + hk) * sh.n_runs + first) *
                          2 + part) * kKT * HD + row * HD + col;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = 0; r < runs; ++r) {
    const float4 u = *reinterpret_cast<const float4*>(src + r * 2 * kKT * HD);
    a = make_float4(a.x + u.x, a.y + u.y, a.z + u.z, a.w + u.w);
  }
  const long long* x = st.x;
  const int o = part ? DK : DV;
  *reinterpret_cast<float4*>((part ? dk : dv) + b * x[o] + hk * x[o + 1] +
                             key * x[o + 2] + col) = a;
}

// The launch plan of one shape: the run length that spreads the dK/dV
// work over the card's SMs (the bf16 backward's planning, at this
// kernel's tiles), and the scratch.
struct Plan {
  Shape sh;                // scale and softcap unset
  long long rows;          // D's values, B * Hq * Sq rounded up to 4
  long long partials;      // f32 partial values (0: no key tile is split)
};

Plan make_plan(int B, int Hq, int Hkv, int Sq, int Skv, int hd, int causal,
               int window, int n_sm) {
  Plan p;
  Shape& sh = p.sh;
  sh = Shape{Hq, Hq / Hkv, Sq, Skv, causal, window, 0.f, 0.f,
             (Skv + kKT - 1) / kKT, 1, 0};
  std::vector<int> steps(sh.n_kt);
  long long total = 0;
  int longest = 0;
  for (int j = 0; j < sh.n_kt; ++j) {
    steps[j] = tile_steps(sh, j);
    total += steps[j];
    longest = imax(longest, steps[j]);
  }
  total *= (long long)B * Hkv;
  // the run length of least estimated time: whole waves of the SMs (a
  // last wave of a few CTAs costs a full one) times the longest run plus
  // two steps for a CTA's own K/V loads and stores, plus two more for the
  // sum's launch when a tile is split; ties to the longer run.  Runs from
  // a quarter of a step a CTA up to 4 times that, and at most kMaxRun.
  int lo = imax(2, (int)((total + 4LL * n_sm - 1) / (4LL * n_sm)));
  const int hi = imin(kMaxRun, imax(lo, imin(longest, 4 * lo)));
  lo = imin(lo, hi);
  long long best = -1;
  for (int c = lo; c <= hi; ++c) {
    int n = 0;
    for (int j = 0; j < sh.n_kt; ++j) n += tile_runs(steps[j], c);
    const long long ctas = (long long)n * B * Hkv;
    const long long cost =
        (ctas + n_sm - 1) / n_sm * (c + 2) + (n > sh.n_kt ? 2 : 0);
    if (best < 0 || cost <= best) {
      best = cost;
      sh.chunk = c;
      sh.n_runs = n;
    }
  }
  p.rows = ((long long)B * Hq * Sq + 3) / 4 * 4;   // partials 16-byte aligned
  p.partials = sh.n_runs > sh.n_kt
                   ? (long long)B * Hkv * sh.n_runs * 2 * kKT * hd : 0;
  return p;
}

// make_plan for the current device, the last shape's kept: a training
// step calls the backward of one shape many times
Plan plan_for(int B, int Hq, int Hkv, int Sq, int Skv, int hd, int causal,
              int window) {
  static std::mutex mu;
  static int last[9] = {-1};
  static Plan plan;
  static int sms[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = 0;
  const int key[9] = {B, Hq, Hkv, Sq, Skv, hd, causal, window, dev};
  std::lock_guard<std::mutex> lock(mu);
  if (std::equal(key, key + 9, last)) return plan;
  int n_sm = dev < 64 ? sms[dev] : 0;
  if (n_sm == 0) {
    if (cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      n_sm = 132;
    if (dev < 64) sms[dev] = n_sm;
  }
  plan = make_plan(B, Hq, Hkv, Sq, Skv, hd, causal, window, n_sm);
  std::copy(key, key + 9, last);
  return plan;
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* dq, float* dk,
           float* dv, float* scratch, const Strides& st, const Plan& p, int B,
           int Hkv, cudaStream_t s) {
  const Shape& sh = p.sh;
  float* delta = scratch;
  float* partial = delta + p.rows;

  cudaError_t e = allow_smem<flash_bwd_dq_tf32<HD>>(dq_smem<HD>());
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_tf32<HD>
      <<<dim3(sh.Hq, (sh.Sq + kQT - 1) / kQT, B), kThreadsQ, dq_smem<HD>(),
         s>>>(q, k, v, o, dout, lse, delta, dq, st, sh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = allow_smem<flash_bwd_dkdv_tf32<HD>>(dkdv_smem<HD>());
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_tf32<HD>
      <<<dim3(sh.n_runs, Hkv, B), kThreadsKV, dkdv_smem<HD>(), s>>>(
          q, k, v, dout, lse, delta, dk, dv, partial, st, sh);
  e = cudaGetLastError();
  if (e != cudaSuccess || !p.partials) return (int)e;

  flash_bwd_dkdv_sum_tf32<HD>
      <<<dim3(sh.n_kt * kSumBlocks<HD>, Hkv, B), 256, 0, s>>>(partial, dk, dv,
                                                               st, sh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 scratch values a flash_attention_bwd call of this shape needs: D of
// every row, then the dK/dV partials (-1 for a shape it refuses).
long long flash_attention_bwd_scratch(int B, int Hq, int Hkv, int Sq, int Skv,
                                      int hd, int causal, int window) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv < Sq) return -1;
  const Plan p = plan_for(B, Hq, Hkv, Sq, Skv, hd, causal, window);
  return p.rows + p.partials;
}

// q (B, Hq, Sq, hd), k/v (B, Hkv, Skv, hd), o and dout like q, dq like q,
// dk/dv like k, all f32, each addressed by the 24 element strides in
// `strides` (q, k, v, o, dout, dq, dk, dv; batch, head, seq); hd in {32,
// 64, 80, 128, 256} is contiguous; every pointer and stride is a multiple of
// 16 bytes.  lse: the forward's f32 (B, Hq, Sq) log-sum-exp (contiguous).
// scratch: flash_attention_bwd_scratch(...) f32 values.  Returns a
// cudaError_t code (0 on success).  Two or three launches, in order.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* dq, void* dk, void* dv, void* scratch,
                        const long long* strides, int B, int Hq, int Hkv,
                        int Sq, int Skv, int hd, float scale, int causal,
                        int window, float softcap, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv < Sq) return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 24; ++i) st.x[i] = strides[i];
  Plan p = plan_for(B, Hq, Hkv, Sq, Skv, hd, causal, window);
  p.sh.scale = scale;
  p.sh.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* gf = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  float* w = static_cast<float*>(scratch);
  switch (hd) {
    case 32:
      return launch<32>(qf, kf, vf, of, gf, lf, dqf, dkf, dvf, w, st, p, B,
                        Hkv, s);
    case 64:
      return launch<64>(qf, kf, vf, of, gf, lf, dqf, dkf, dvf, w, st, p, B,
                        Hkv, s);
    case 80:    // HuBERT: dq's halves of 40 columns, 5 n-tiles each
      return launch<80>(qf, kf, vf, of, gf, lf, dqf, dkf, dvf, w, st, p, B,
                        Hkv, s);
    case 128:
      return launch<128>(qf, kf, vf, of, gf, lf, dqf, dkf, dvf, w, st, p, B,
                         Hkv, s);
    case 256:
      return launch<256>(qf, kf, vf, of, gf, lf, dqf, dkf, dvf, w, st, p, B,
                         Hkv, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
