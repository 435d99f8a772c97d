// Flash attention (forward), f32, for Hopper (sm_90a): online softmax over
// key tiles with causal / sliding-window masks, the gemma2 logit softcap
// and GQA/MQA (kv head = h / group), queries right-aligned to the KV tail,
// hd in {32, 64, 80, 128, 256}, bidirectional (causal = 0) or causal.
// bf16 inputs go to the wgmma kernel of flash_attention_bf16.cu.
//
// Replaces: src/repro/kernels/flash_attention.py, function flash_attention
// (the Pallas kernel: grid (B, Hq, Sq/bq, Skv/bk), the running (m, l, acc)
// in VMEM scratch across the sequential KV grid steps).
//
// Contract (that kernel's _kernel and src/repro/kernels/ref.py
// flash_attention): s = q.k / sqrt(hd) in f32; optionally
// s = tanh(s / cap) * cap; query i sits at position i + Skv - Sq, key j at
// j; causal keeps j <= pos(i), a window w keeps pos(i) - j < w; masked
// scores take no part (p = 0); the output is acc / max(l, 1e-30).  Skv >=
// Sq, so every query row sees at least one key.  Given an lse pointer,
// each row's log-sum-exp m + log(max(l, 1e-30)) goes there (f32, (B, Hq,
// Sq)) for the backward; without an output pointer only that (P.V skipped).
//
// Bound on this card: operations.  The unmasked band needs 4 * hd flops a
// (query, key) pair (Q.K^T and P.V).  On the CUDA cores in f32 FMAs that
// is flops / 67 TFLOP/s; the tensor cores do TF32 at 495 TFLOP/s but keep
// 11 bits, so f32 accuracy costs three TF32 products each (3xTF32,
// tf32x3.cuh): flops / 165 TFLOP/s, 2.5 times below the FMA bound.  At
// phase 4b's prefill (2, 10, 2176, 256), window 2,048: 48.3 GFLOP, 0.293 ms
// (3xTF32) against 0.72 ms (FMA).  mma.sync, the TF32 path this kernel
// takes, reaches ~317 TFLOP/s on the card
// (launch/profile_mma_peak.py), so ~0.46 ms is the floor of this design;
// the splits and the softmax take issue slots beside it.
//
// Design: one CTA per (128 query rows, head, batch), longest tiles first,
// 8 warps of 16 rows (two a sub-partition of the SM: one is latency-bound
// on its mma chains and splits).  The Pallas grid's sequential KV axis is
// a loop in the CTA over only the key tiles the mask touches.  Q (128 x
// hd) stays in shared memory; 16-key K and V tiles stream through a
// two-stage cp.async ring (hd = 256: Q 132 KB + 2 x (K 16.5 + V 16.3 KB) =
// 198 KB, one CTA an SM), each at a padded pitch (tf32x3.cuh), so that
// every fragment load is conflict-free and an immediate offset from a
// pointer computed once.  Q.K^T and P.V run on mma.sync m16n8k8 in
// 3xTF32, every operand split hi / lo in registers as it is loaded, so
// shared memory holds each tile once in f32 (wgmma's TF32 B operand must
// come from shared memory K-major: V transposed, and hi and lo copies of
// each tile, past 227 KB at hd = 256).  S (16 x 16 a warp) and the output
// (16 x hd: 128 f32 a lane at hd = 256) stay in registers; the row
// statistics are reductions over a lane quad.  P goes from its accumulator
// straight into P.V's A fragments: the accumulator's key pair (2t, 2t + 1)
// is the A fragment's (t, t + 4) once V's B fragments read rows 2t and
// 2t + 1 (tf32x3.cuh), so no shuffle and no trip through shared memory.
// Q.K^T alternates two accumulator sets over the hd steps (more mma chains
// in flight), and the output's rescaling is skipped once a warp's row
// maxima stop moving.  Heads that share a KV head read the same K/V bytes,
// which L2 serves (heads are the fastest grid axis).  (A variant of 16
// warps, each pair splitting hd and swapping halves of S, spilled at its
// 128 registers and ran 10 % slower.)

#include <math.h>

#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * 16;   // query rows a CTA
constexpr int kBK = 16;            // keys a tile
constexpr int kNT = kBK / 8;       // n-tiles of S
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {  // element strides of (batch, head, seq); hd is contiguous
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

template <int HD>
constexpr int smem_bytes() {   // Q; two stages of K, V
  return 4 * (kBQ * kPitchRows<HD> +
              2 * kBK * (kPitchRows<HD> + kPitchCols<HD>));
}
static_assert(smem_bytes<256>() <= 232448, "shared memory");

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, Strides st, int group, int Sq,
                   int Skv, float scale, int causal, int window,
                   float softcap) {
  constexpr int kOT = HD / 8;       // n-tiles of the output
  constexpr int LR = kPitchRows<HD>, LC = kPitchCols<HD>;
  constexpr int kStage = kBK * (LR + LC);
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][LR]
  float* KV = Qs + kBQ * LR;                     // stage s: K [kBK][LR], V [kBK][LC]

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  const int hk = h / group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int offset = Skv - Sq;  // queries right-aligned to the KV tail
  const float* kp = k + b * st.kb + hk * st.kh;
  const float* vp = v + b * st.vb + hk * st.vh;

  // the keys any row of this tile may see, in whole tiles
  const int pos_lo = q0 + offset;
  const int pos_hi = min(q0 + kBQ, Sq) - 1 + offset;
  const int k_end = causal ? min(Skv, pos_hi + 1) : Skv;
  const int k_begin = (window ? max(0, pos_lo - window + 1) : 0) / kBK * kBK;
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

  auto load_kv = [&](int i) {
    const int kt = k_begin + i * kBK;
    const int valid = min(kBK, Skv - kt);
    float* Ks = KV + (i & 1) * kStage;
    load_tile_async<HD, LR, kThreads>(Ks, kp + kt * st.ks, st.ks, kBK, valid);
    load_tile_async<HD, LC, kThreads>(Ks + kBK * LR, vp + kt * st.vs, st.vs,
                                      kBK, valid);
    cp_async_commit();
  };
  load_tile_async<HD, LR, kThreads>(
      Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, kBQ,
      min(kBQ, Sq - q0));
  load_kv(0);

  // rows g and g + 8 of the warp's 16: running max, sum, output
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kOT][4];
#pragma unroll
  for (int n = 0; n < kOT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int qpos0 = q0 + r0 + g + offset;   // row g's position; g + 8: + 8
  const int wpos = q0 + r0 + offset;        // the warp's first row's
  const float* qa = Qs + (r0 + g) * LR + 2 * t;   // Q's A fragments

  for (int i = 0; i < n_tiles; ++i) {
    const int kt = k_begin + i * kBK;
    cp_async_wait<0>();
    __syncthreads();        // tile i landed; every warp is done with i - 1
    if (i + 1 < n_tiles) load_kv(i + 1);   // into i - 1's stage
    const float* Ks = KV + (i & 1) * kStage;
    const float* kb = Ks + g * LR + 2 * t;              // K's B, by rows
    const float* vb = Ks + kBK * LR + 2 * t * LC + g;   // V's B, by columns

    // S = Q K^T over hd, two accumulator sets on alternate steps
    float s[2][kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[0][j][e] = s[1][j][e] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 16) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const FragA a = frag_a<LR>(qa, c + 8 * u);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma3(s[u][j], a, frag_b_rows(kb + 8 * j * LR, c + 8 * u));
      }
    }

    // online softmax over rows g (e = 0, 1) and g + 8 (e = 2, 3), in log2
    // units; the masks are tested only on a tile the warp's rows do not
    // all see whole
    const bool whole = kt + kBK <= Skv &&
                       (!causal || kt + kBK - 1 <= wpos) &&
                       (!window || wpos + 15 - kt < window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (!whole) {
          const int kpos = kt + 8 * j + 2 * t + (e & 1);
          const int qpos = qpos0 + (e >> 1) * 8;
          ok = kpos < Skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window) ok = ok && qpos - kpos < window;
        }
        float x = (s[0][j][e] + s[1][j][e]) * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        x = ok ? x * kLog2e : kNegInf;
        s[0][j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[0][j][e];
        const float p = x > 0.5f * kNegInf ? exp2f(x - m[e >> 1]) : 0.f;
        s[0][j][e] = p;
        ps[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ps[r] += __shfl_xor_sync(kFullMask, ps[r], 1);
      ps[r] += __shfl_xor_sync(kFullMask, ps[r], 2);
      l[r] = l[r] * corr[r] + ps[r];
    }

    if (o != nullptr) {
      // O = O * corr + P V: P's accumulator is the A fragment over keys;
      // once the rows' maxima settle, corr is 1 and the scaling is skipped
      if (__any_sync(kFullMask, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < kOT; ++n) {
          acc[n][0] *= corr[0];
          acc[n][1] *= corr[0];
          acc[n][2] *= corr[1];
          acc[n][3] *= corr[1];
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const FragA a = acc_as_a(s[0][j]);
#pragma unroll
        for (int n = 0; n < kOT; ++n)
          mma3(acc[n], a, frag_b_cols<LC>(vb, 8 * j, 8 * n));
      }
    }
  }

  const long long row_base = ((long long)b * gridDim.x + h) * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && t == 0)
      lse[row_base + row] = (m[r] + log2f(denom)) * kLn2;
    if (o == nullptr) continue;
    float* orow = o + b * st.ob + h * st.oh + row * st.os;
    const float inv = 1.f / denom;
#pragma unroll
    for (int n = 0; n < kOT; ++n) {
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
          make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, const Strides& st, int B, int Hq, int group, int Sq,
           int Skv, float scale, int causal, int window, float softcap,
           cudaStream_t s) {
  constexpr int kSmem = smem_bytes<HD>();
  const cudaError_t attr = allow_smem<flash_fwd_tf32<HD>>(kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(Hq, (Sq + kBQ - 1) / kBQ, B);
  flash_fwd_tf32<HD><<<grid, kThreads, kSmem, s>>>(
      q, k, v, o, lse, st, group, Sq, Skv, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, hd), k/v (B, Hkv, Skv, hd), o like q, all f32, each
// addressed by the 12 element strides in `strides` (q, k, v, o; batch,
// head, seq); hd in {32, 64, 80, 128, 256} is contiguous; every pointer and
// stride is a multiple of 16 bytes.  o: NULL for the log-sum-exp alone.
// lse: NULL, or f32 (B, Hq, Sq) for each row's log-sum-exp.  Returns a
// cudaError_t code (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, void* lse, const long long* strides, int B,
                        int Hq, int Hkv, int Sq, int Skv, int hd, float scale,
                        int causal, int window, float softcap,
                        void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv < Sq) return (int)cudaErrorInvalidValue;
  const long long* x = strides;
  const Strides st{x[0], x[1], x[2], x[3], x[4],  x[5],
                   x[6], x[7], x[8], x[9], x[10], x[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  const int group = Hq / Hkv;
  switch (hd) {
    case 32:
      return launch<32>(qf, kf, vf, of, lf, st, B, Hq, group, Sq, Skv, scale,
                        causal, window, softcap, s);
    case 64:
      return launch<64>(qf, kf, vf, of, lf, st, B, Hq, group, Sq, Skv, scale,
                        causal, window, softcap, s);
    case 80:    // HuBERT: 5 k-steps of 16, 10 output n-tiles
      return launch<80>(qf, kf, vf, of, lf, st, B, Hq, group, Sq, Skv, scale,
                        causal, window, softcap, s);
    case 128:
      return launch<128>(qf, kf, vf, of, lf, st, B, Hq, group, Sq, Skv, scale,
                         causal, window, softcap, s);
    case 256:
      return launch<256>(qf, kf, vf, of, lf, st, B, Hq, group, Sq, Skv, scale,
                         causal, window, softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
