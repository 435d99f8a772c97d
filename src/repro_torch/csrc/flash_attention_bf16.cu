// Flash attention (forward) for bf16 on Hopper's tensor cores (sm_90a):
// online softmax over 64-key tiles with causal / sliding-window masks, the
// gemma2 logit softcap and GQA/MQA (kv head = h / group), queries
// right-aligned to the KV tail, ragged Sq and Skv, hd in {32, 64, 80, 128,
// 256}, (B, H, S, hd) tensors addressed by their strides, bidirectional
// (causal = 0) or causal.  f32 inputs go to the 3xTF32 kernel of
// flash_attention.cu.
//
// Replaces: src/repro/kernels/flash_attention.py, function flash_attention
// (the Pallas kernel: grid (B, Hq, Sq/bq, Skv/bk), the running (m, l, acc)
// in VMEM scratch across the sequential KV grid steps).
//
// Contract (that kernel's _kernel and src/repro/kernels/ref.py
// flash_attention): s = (q.k) / sqrt(hd) in f32 (bf16 products are exact
// in f32; the scale is applied to the f32 scores, not to q in bf16, since
// at hd = 32, 80 and 128 it is not a power of two); optionally
// s = tanh(s / cap) * cap, before the mask; query i sits at position
// i + Skv - Sq, key j at j; causal keeps j <= pos(i), a window w keeps
// pos(i) - j < w; masked scores take no part (p = 0); the output is
// acc / max(l, 1e-30) rounded to bf16.  One deliberate difference: p is
// rounded to bf16 for P.V, as the tensor cores take it (the reference
// keeps p in f32); l sums the f32 p.  The result stays within one bf16
// rounding of the plain version plus 4e-3.
//
// Bound on this card: operations.  The unmasked band of (query, key)
// pairs needs 4 * hd flops each (Q.K^T and P.V); at the RecurrentGemma-2B
// prefill shape ((2, 10, 4096, 256) over (2, 1, 4096, 256), window 2048)
// that is 128.9 GFLOP, 0.130 ms at the bf16 tensor-core peak (989
// TFLOP/s); the bytes (63 MB) take 0.019 ms.
//
// Design, for that bound:
// - Both products run on wgmma with f32 accumulators: S = Q.K^T with Q and
//   K from shared memory, O += P.V with P from registers (the S
//   accumulator's layout is the A-operand layout, so P never touches
//   shared memory) and V from shared memory, MN-major.
// - A CTA is two consumer warpgroups of 64 query rows each (128 rows) and
//   one producer warpgroup.  The producer's one thread keeps a ring of
//   K/V tiles (64 keys x hd, bf16, 128-byte swizzled; 2 stages at
//   hd = 256, 4 below) full with TMA copies signalled on mbarriers, so
//   the next tile's load overlaps this tile's math; both consumers read
//   each tile.  setmaxnreg moves registers from the producer (40) to the
//   consumers (232): the hd = 256 O accumulator alone is 128 f32 a
//   thread.
// - Only the key tiles the band touches are walked, and a warpgroup skips
//   a tile its own rows do not see; the per-element mask runs only on the
//   diagonal, window-edge and ragged tiles.  Query tiles run longest first
//   and the query heads of one KV head are neighbouring CTAs, so L2 serves
//   their shared K and V (4 MB per batch at the serving shape).
// - TMA fills rows past Sq or Skv with zeros; those keys are masked and
//   those rows are not stored.
// - Head dim 80 (HuBERT) runs in the 128-wide tiles: the tensor maps
//   declare the true inner dimension, so TMA fills columns 80..127 with
//   zeros; Q.K^T and the row statistics do not change, P.V gives zeros
//   there, and only the first 80 columns are stored.  The tile does 1.6
//   times the tensor-core work of an exact one (wgmma has no N = 80 for
//   P.V and the swizzle chunks are 64 wide).
// - Given an lse pointer, each row's natural-log log-sum-exp goes there
//   (f32, (B, Hq, Sq)) for the backward: (m + log2 l) ln 2 from the running
//   max and sum in log2 units.  Without an output pointer the kernel
//   computes only that (no P.V): the backward's LSE pass when the caller
//   has none.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 2;                 // warpgroups of 64 query rows
constexpr int kBQ = 64 * kConsumers;          // query rows per CTA
constexpr int kBK = 64;                       // keys per tile
constexpr int kThreads = 128 * (kConsumers + 1);

template <int HD>
struct Fwd {
  static constexpr int kBytes = Tile<HD>::kBytes;
  static constexpr int kStages = HD == 256 ? 2 : 4;
  // Q of both consumers, the K and V rings, mbarriers, 1024-byte alignment
  static constexpr int kSmem = 1024 + (kConsumers + 2 * kStages) * kBytes + 128;
};

// Grid (Hq, query tiles of kBQ rows, B), longest tiles first.  Scores are
// kept in log2 units: x = s * scale * log2(e) (or the softcapped score
// times log2(e)), p = exp2(x - m).  HD is the tile's width, W <= HD the
// head dim (the columns stored).
template <int HD, int W>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, long long ob, long long oh,
                   long long os, float* __restrict__ lse, int group, int Sq,
                   int Skv, float scale, int causal, int window,
                   float softcap) {
  using C = Tile<HD>;
  using F = Fwd<HD>;
  extern __shared__ uint8_t smem[];
  const uint32_t sQ = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sK = sQ + kConsumers * C::kBytes;
  const uint32_t sV = sK + F::kStages * C::kBytes;
  const uint32_t q_full = sV + F::kStages * C::kBytes;
  const uint32_t full = q_full + 8;                 // + 8 * stage
  const uint32_t empty = full + 8 * F::kStages;     // + 8 * stage

  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int offset = Skv - Sq;
  // the key tiles any row of this CTA may see
  const int pos_lo = q0 + offset;
  const int pos_hi = min(q0 + kBQ, Sq) - 1 + offset;
  const int k_end = causal ? min(Skv, pos_hi + 1) : Skv;
  const int k_begin = (window ? max(0, pos_lo - window + 1) : 0) / kBK * kBK;
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < F::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 4);     // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_full, kConsumers * C::kBytes);
      for (int w = 0; w < kConsumers; ++w) {
        for (int c = 0; c < HD / C::kCols; ++c) {
          tma_load(sQ + w * C::kBytes + c * C::kChunkBytes, &qmap, q_full,
                   c * C::kCols, q0 + 64 * w, h, b);
        }
      }
      const int hk = h / group;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % F::kStages;
        if (i >= F::kStages) mbar_wait(empty + 8 * s, (i / F::kStages - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * C::kBytes);
        const int kt = k_begin + i * kBK;
        for (int c = 0; c < HD / C::kCols; ++c) {
          const uint32_t off = s * C::kBytes + c * C::kChunkBytes;
          tma_load(sK + off, &kmap, full + 8 * s, c * C::kCols, kt, hk, b);
          tma_load(sV + off, &vmap, full + 8 * s, c * C::kCols, kt, hk, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = threadIdx.x % 32;
    const int r0 = 64 * wg + 16 * (threadIdx.x / 32 % 4) + lane / 4;
    const int kc = 2 * (lane % 4);   // this thread's columns of an 8-column group
    const int wq_lo = q0 + 64 * wg;
    const int wpos_lo = wq_lo + offset;
    const int wpos_hi = min(wq_lo + 64, Sq) - 1 + offset;
    const int pos0 = q0 + r0 + offset;  // rows r0 and r0 + 8
    const float scale_log2 = scale * kLog2e;
    const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
    const uint32_t sQw = sQ + wg * C::kBytes;

    float acc[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % F::kStages;
      const int kt = k_begin + i * kBK;
      mbar_wait(full + 8 * s, (i / F::kStages) & 1);
      const bool live = wq_lo < Sq && (!causal || kt <= wpos_hi) &&
                        (!window || wpos_lo - (kt + kBK - 1) < window);
      if (live) {
        // S = Q K^T (64 x 64), K-major operands, hd / 16 steps of 16
        float sc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = 0.f;
        wgmma_fence();
        wgmma_abt<HD>(sc, sQw, sK + s * C::kBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scale, softcap, mask (only where the mask cuts this tile); the
        // thread holds rows r0 (e & 2 == 0) and r0 + 8, columns
        // 8 (e / 4) + kc + (e & 1)
        const bool edge = !((!causal || kt + kBK - 1 <= wpos_lo) &&
                            (!window || wpos_hi - kt < window) &&
                            kt + kBK <= Skv);
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          float x = softcap > 0.f ? softcap * tanhf(sc[e] * cap_in) * kLog2e
                                  : sc[e] * scale_log2;
          if (edge) {
            const int key = kt + 8 * (e / 4) + kc + (e & 1);
            const int pos = pos0 + ((e & 2) ? 8 : 0);
            bool ok = key < Skv;
            if (causal) ok = ok && key <= pos;
            if (window) ok = ok && pos - key < window;
            if (!ok) x = -INFINITY;
          }
          sc[e] = x;
          if (e & 2) {
            mx1 = fmaxf(mx1, x);
          } else {
            mx0 = fmaxf(mx0, x);
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {   // the 4 lanes of a row
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        // a row with no key seen yet subtracts 0 (exp2(-inf) = 0)
        const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
        const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
        const float corr0 = exp2f(m0 - mu0), corr1 = exp2f(m1 - mu1);
        m0 = mn0;
        m1 = mn1;

        // P (bf16, as the A operand of P.V) and this thread's share of l
        uint32_t pa[kBK / 16][4];
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const float mu = (e & 2) ? mu1 : mu0;
          const float p0 = exp2f(sc[e] - mu), p1 = exp2f(sc[e + 1] - mu);
          if (e & 2) {
            ps1 += p0 + p1;
          } else {
            ps0 += p0 + p1;
          }
          pa[e / 8][e % 8 / 2] = pack_bf16(p0, p1);
        }
        l0 = l0 * corr0 + ps0;
        l1 = l1 * corr1 + ps1;
        if (o != nullptr) {
#pragma unroll
          for (int e = 0; e < HD / 2; ++e) acc[e] *= (e & 2) ? corr1 : corr0;

          // O += P V, V MN-major: 16 keys a step, hd wide
          wgmma_fence();
          wgmma_a_tile<HD>(acc, pa, sV + s * C::kBytes);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(acc);
        }
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const int row = q0 + r0;
    if (lse != nullptr && kc == 0) {
      float* lrow = lse + ((long long)b * gridDim.x + h) * Sq + row;
      if (row < Sq) lrow[0] = (m0 + log2f(d0)) * kLn2;
      if (row + 8 < Sq) lrow[8] = (m1 + log2f(d1)) * kLn2;
    }
    if (o == nullptr) return;
    __nv_bfloat16* out = o + b * ob + h * oh + row * os + kc;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      if (row < Sq) {
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16(acc[4 * j] / d0, acc[4 * j + 1] / d0);
      }
      if (row + 8 < Sq) {
        *reinterpret_cast<uint32_t*>(out + 8 * os + 8 * j) =
            pack_bf16(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
      }
    }
  }
}

template <int HD, int W = HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const long long* st, int B, int Hq, int Hkv, int Sq, int Skv,
           float scale, int causal, int window, float softcap,
           cudaStream_t s) {
  CUtensorMap qm, km, vm;
  if (!encoder()) return (int)cudaErrorNotSupported;
  const cudaError_t bound = bind_device(q);
  if (bound != cudaSuccess) return (int)bound;
  if (!make_map<HD, W>(&qm, q, Sq, Hq, B, st) ||
      !make_map<HD, W>(&km, k, Skv, Hkv, B, st + 3) ||
      !make_map<HD, W>(&vm, v, Skv, Hkv, B, st + 6)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kern = flash_fwd_bf16<HD, W>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Fwd<HD>::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hq, (Sq + kBQ - 1) / kBQ, B);
  kern<<<grid, kThreads, Fwd<HD>::kSmem, s>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11], lse,
      Hq / Hkv, Sq, Skv, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, hd), k/v (B, Hkv, Skv, hd), o like q, all bf16, each
// addressed by the 12 element strides in `strides` (q, k, v, o; batch,
// head, seq); hd in {32, 64, 80, 128, 256} is contiguous; every pointer and
// stride is a multiple of 16 bytes.  lse: NULL, or f32 (B, Hq, Sq) for
// each row's log-sum-exp; o may be NULL when lse is not (the LSE alone).
// Returns a cudaError_t code (0 on success).
int flash_attention_bf16_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const long long* strides,
                             int B, int Hq,
                             int Hkv, int Sq, int Skv, int hd, float scale,
                             int causal, int window, float softcap,
                             void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv < Sq) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, l, strides, B, Hq, Hkv, Sq, Skv, scale,
                        causal, window, softcap, s);
    case 64:
      return launch<64>(q, k, v, o, l, strides, B, Hq, Hkv, Sq, Skv, scale,
                        causal, window, softcap, s);
    case 80:    // in 128-wide tiles, columns 80..127 zero
      return launch<128, 80>(q, k, v, o, l, strides, B, Hq, Hkv, Sq, Skv,
                             scale, causal, window, softcap, s);
    case 128:
      return launch<128>(q, k, v, o, l, strides, B, Hq, Hkv, Sq, Skv, scale,
                         causal, window, softcap, s);
    case 256:
      return launch<256>(q, k, v, o, l, strides, B, Hq, Hkv, Sq, Skv, scale,
                         causal, window, softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
