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
// - Head dim 80 (HuBERT X-Large's 16 bidirectional heads) has a kernel of
//   its own, flash_fwd_bf16_hd80 below: at this width the tile's two
//   products (320 tensor-core clocks of an SM a warpgroup tile) and its
//   4,096 exp2s (256 clocks of the SM's MUFU) are of one size, so the
//   bound is whichever of them is not hidden under the other.
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
// times log2(e)), p = exp2(x - m).
template <int HD>
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
    for (int j = 0; j < HD / 8; ++j) {
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

// ---------------------------------------------------------------------
// Head dim 80: exact-width tiles, the softmax under the tensor cores
// ---------------------------------------------------------------------
// At hd = 80 a warpgroup's 64 x 128 tile is two products of 640
// tensor-core clocks of an SM together (Q.K^T in 5 k-steps of 16, P.V in 8
// m64n80k16 steps) and 8,192 exp2s, 512 clocks of the SM's MUFU: run back
// to back they cost their sum, and the 128-wide tiles of the other head
// dims would multiply 48 zero columns.  So:
// - The tiles are exactly 80 wide: five 16-column chunks in the 32-byte
//   swizzle (Tile<80>), one TMA box each; a K or V tile is 128 rows of
//   each chunk (64 keys a tile measured slower: twice the per-tile work
//   of barriers, row maxima and rescales for the same products).
// - Each consumer holds its 64 query rows in registers as the A operand
//   of S = Q.K^T (20 registers, read once from device memory), so both
//   products read only K or V from shared memory, and the host encodes no
//   Q map.
// - Each consumer issues the next tile's S and this tile's O += P.V back
//   to back, waits for S alone (wgmma.wait_group 1) and forms the next P
//   (max, exp2, row sums, in place in S's registers) while P.V runs; O is
//   rescaled, and P packed into the A-operand registers, once P.V has
//   landed: ptxas serializes every wgmma of a kernel whose wgmma inputs
//   are written while a wgmma is in flight, or that has a wgmma on a
//   branch.  So every live tile issues both products, the first a P.V of
//   zeros, and the LSE-only mode is its own instantiation (kOut false: no
//   P.V at all).  A K/V stage is released when its P.V is done.
// - Two consumer warpgroups (64 query rows each) share every K/V tile;
//   their products and exp2s interleave on the SM as well (three, at 160
//   registers a thread, spill at 128-key tiles; making the two take turns
//   at issuing their products, with named barriers, measured no faster).
// What bounds it on the card is none of these alone: removing the exp2s,
// either product or the K/V loads each took 2-10 % off its time
// (PERF.md section 6), so the per-tile chain of waits and dependent
// reductions of one warpgroup, with only two warpgroups to hide it, is
// the limit.
// The contract is flash_fwd_bf16's (p rounded to bf16 for P.V, l the f32
// sum, the LSE, the LSE-only mode, masks, softcap, GQA, alignment).
struct Fwd80 {
  static constexpr int kNC = 2;                           // consumers
  static constexpr int kBN = 128;                         // keys a tile
  static constexpr int kChunk = kBN * 32;                 // kBN rows of a chunk
  static constexpr int kKVBytes = 5 * kChunk;             // a K or V tile
  static constexpr int kStages = 4;
  static constexpr int kThreads = 128 * (kNC + 1);
  static constexpr int kBQ = 64 * kNC;
  static constexpr int kSmem = 1024 + 2 * kStages * kKVBytes + 128;
};

// S (64 x 128) = Q K^T: Q's fragments in registers, K 128 rows of five
// chunks
__device__ __forceinline__ void qk_hd80(float (&d)[64],
                                        const uint32_t (&qf)[5][4],
                                        uint32_t sk) {
  using T = Tile<80>;
#pragma unroll
  for (int kk = 0; kk < 5; ++kk) {
    wgmma_rs_n128_k(d, qf[kk],
                    desc(sk + kk * Fwd80::kChunk, 16, T::kSBO, T::kLayout),
                    kk > 0);
  }
}

// O (64 x 80) += P (64 x 128, registers) V (128 rows of five chunks,
// MN-major)
__device__ __forceinline__ void pv_hd80(float (&o)[40],
                                        const uint32_t (&a)[8][4],
                                        uint32_t sv) {
  using T = Tile<80>;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    wgmma_rs_n80(o, a[j], desc(sv + j * 16 * T::kSwizzle, Fwd80::kChunk,
                               T::kSBO, T::kLayout));
  }
}

template <bool kOut>
__global__ void __launch_bounds__(Fwd80::kThreads, 1)
    flash_fwd_bf16_hd80(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __nv_bfloat16* __restrict__ q, long long qb,
                        long long qh, long long qs,
                        __nv_bfloat16* __restrict__ o, long long ob,
                        long long oh, long long os, float* __restrict__ lse,
                        int group, int Sq, int Skv, float scale, int causal,
                        int window, float softcap) {
  constexpr int HD = 80;
  using C = Tile<HD>;
  using F = Fwd80;
  constexpr int NC = F::kNC, BN = F::kBN;
  extern __shared__ uint8_t smem[];
  const uint32_t sK = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sV = sK + F::kStages * F::kKVBytes;
  const uint32_t full = sV + F::kStages * F::kKVBytes;   // + 8 * stage
  const uint32_t empty = full + 8 * F::kStages;          // + 8 * stage

  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F::kBQ;
  const int offset = Skv - Sq;
  const int pos_lo = q0 + offset;
  const int pos_hi = min(q0 + F::kBQ, Sq) - 1 + offset;
  const int k_end = causal ? min(Skv, pos_hi + 1) : Skv;
  const int k_begin = (window ? max(0, pos_lo - window + 1) : 0) / BN * BN;
  const int n_tiles = (k_end - k_begin + BN - 1) / BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NC * 4);             // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == NC * 128) {
      const int hk = h / group;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % F::kStages;
        if (i >= F::kStages) mbar_wait(empty + 8 * s, (i / F::kStages - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * F::kKVBytes);
        const int kt = k_begin + i * BN;
        for (int c = 0; c < HD / C::kCols; ++c) {
          const uint32_t off = s * F::kKVBytes + c * F::kChunk;
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
    // x = the raw score (no softcap: times `mul` in log2 units, folded
    // into the exp2's FMA) or the softcapped score in log2 units
    const float mul = softcap > 0.f ? 1.f : scale * kLog2e;
    const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
    const float cap_out = softcap * kLog2e;
    uint32_t qf[5][4];              // this warpgroup's Q, the A of Q.K^T
    load_frags80(qf, q + b * qb + h * qh, qs, wq_lo, Sq, threadIdx.x % 128);

    float acc[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    uint32_t pa[BN / 16][4] = {};   // P of the tile whose P.V is pending
    int pend = -1;                  // that tile's ring stage (-1: none yet)

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % F::kStages;
      const int kt = k_begin + i * BN;
      mbar_wait(full + 8 * s, (i / F::kStages) & 1);
      const bool live = wq_lo < Sq && (!causal || kt <= wpos_hi) &&
                        (!window || wpos_lo - (kt + BN - 1) < window);
      if (!live) {
        if (lane == 0) mbar_arrive(empty + 8 * s);
        continue;
      }
      // S = Q K^T of this tile, then the pending tile's O += P V
      float sc[BN / 2];
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) sc[e] = 0.f;
      wgmma_fence();
      qk_hd80(sc, qf, sK + s * F::kKVBytes);
      wgmma_commit();
      if constexpr (kOut) {
        // the first live tile adds P = 0 times its own V
        wgmma_fence();
        pv_hd80(acc, pa, sV + (pend >= 0 ? pend : s) * F::kKVBytes);
        wgmma_commit();
        wgmma_wait<1>();                       // S has landed, P.V runs on
      } else {
        wgmma_wait<0>();
      }
      fence_regs(sc);

      // softcap, mask (only where the mask cuts this tile); the thread
      // holds rows r0 (e & 2 == 0) and r0 + 8, columns
      // 8 (e / 4) + kc + (e & 1)
      if (softcap > 0.f) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e)
          sc[e] = cap_out * tanhf(sc[e] * cap_in);
      }
      const bool edge = !((!causal || kt + BN - 1 <= wpos_lo) &&
                          (!window || wpos_hi - kt < window) &&
                          kt + BN <= Skv);
      if (edge) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          const int key = kt + 8 * (e / 4) + kc + (e & 1);
          const int pos = pos0 + ((e & 2) ? 8 : 0);
          bool ok = key < Skv;
          if (causal) ok = ok && key <= pos;
          if (window) ok = ok && pos - key < window;
          if (!ok) sc[e] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        if (e & 2) {
          mx1 = fmaxf(mx1, sc[e]);
        } else {
          mx0 = fmaxf(mx0, sc[e]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {   // the 4 lanes of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * mul), mn1 = fmaxf(m1, mx1 * mul);
      // a row with no key seen yet subtracts 0 (exp2(-inf) = 0)
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float corr0 = exp2_ftz(m0 - mu0), corr1 = exp2_ftz(m1 - mu1);
      m0 = mn0;
      m1 = mn1;

      // this tile's p, in place (f32), and l
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        sc[e] = exp2_ftz(fmaf(sc[e], mul, (e & 2) ? -mu1 : -mu0));
        if (e & 2) {
          ps1 += sc[e];
        } else {
          ps0 += sc[e];
        }
      }
      l0 = l0 * corr0 + ps0;
      l1 = l1 * corr1 + ps1;
      if constexpr (kOut) {
        wgmma_wait<0>();
        fence_regs(acc);
        fence_frag(pa);
        if (pend >= 0 && lane == 0) mbar_arrive(empty + 8 * pend);
#pragma unroll
        for (int e = 0; e < HD / 2; ++e) acc[e] *= (e & 2) ? corr1 : corr0;
        // P (bf16, the A operand of its P.V), written while no wgmma runs
#pragma unroll
        for (int e = 0; e < BN / 2; e += 2)
          pa[e / 8][e % 8 / 2] = pack_bf16(sc[e], sc[e + 1]);
        pend = s;
      } else if (lane == 0) {           // the LSE alone: V is never read
        mbar_arrive(empty + 8 * s);
      }
    }
    if constexpr (kOut) {
      // the last live tile's P.V (a warpgroup with none, all its rows past
      // Sq, adds zeros it never stores; every copy has landed by now)
      wgmma_fence();
      pv_hd80(acc, pa, sV + (pend >= 0 ? pend : 0) * F::kKVBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (pend >= 0 && lane == 0) mbar_arrive(empty + 8 * pend);
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
    if constexpr (!kOut) return;
    const float i0 = 1.f / d0, i1 = 1.f / d1;
    __nv_bfloat16* out = o + b * ob + h * oh + row * os + kc;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (row < Sq) {
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16(acc[4 * j] * i0, acc[4 * j + 1] * i0);
      }
      if (row + 8 < Sq) {
        *reinterpret_cast<uint32_t*>(out + 8 * os + 8 * j) =
            pack_bf16(acc[4 * j + 2] * i1, acc[4 * j + 3] * i1);
      }
    }
  }
}

// hd 80: K and V maps of BN-row boxes, Q read by the consumers themselves
int launch_hd80(const void* q, const void* k, const void* v, void* o,
                float* lse, const long long* st, int B, int Hq, int Hkv,
                int Sq, int Skv, float scale, int causal, int window,
                float softcap, cudaStream_t s) {
  using F = Fwd80;
  static int done[kMaxDevices], lse_done[kMaxDevices];
  CUtensorMap km, vm;
  if (!encoder()) return (int)cudaErrorNotSupported;
  int dev = -1;
  cudaError_t err = bind_device(q, &dev);
  if (err != cudaSuccess) return (int)err;
  if (!make_map<80>(&km, k, Skv, Hkv, B, st + 3, F::kBN) ||
      !make_map<80>(&vm, v, Skv, Hkv, B, st + 6, F::kBN)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kern = o != nullptr ? flash_fwd_bf16_hd80<true>
                           : flash_fwd_bf16_hd80<false>;
  err = smem_once(o != nullptr ? done : lse_done, dev, kern, F::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hq, (Sq + F::kBQ - 1) / F::kBQ, B);
  kern<<<grid, F::kThreads, F::kSmem, s>>>(
      km, vm, static_cast<const __nv_bfloat16*>(q), st[0], st[1], st[2],
      static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11], lse, Hq / Hkv,
      Sq, Skv, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

// The tensor maps and the launch of one call; the shared-memory attribute
// is set once per device.
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const long long* st, int B, int Hq, int Hkv, int Sq, int Skv,
           float scale, int causal, int window, float softcap,
           cudaStream_t s) {
  static int done[kMaxDevices];
  CUtensorMap qm, km, vm;
  if (!encoder()) return (int)cudaErrorNotSupported;
  int dev = -1;
  cudaError_t err = bind_device(q, &dev);
  if (err != cudaSuccess) return (int)err;
  if (!make_map<HD>(&qm, q, Sq, Hq, B, st) ||
      !make_map<HD>(&km, k, Skv, Hkv, B, st + 3) ||
      !make_map<HD>(&vm, v, Skv, Hkv, B, st + 6)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kern = flash_fwd_bf16<HD>;
  err = smem_once(done, dev, kern, Fwd<HD>::kSmem);
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
    case 80:    // exact-width tiles, flash_fwd_bf16_hd80
      return launch_hd80(q, k, v, o, l, strides, B, Hq, Hkv, Sq, Skv, scale,
                         causal, window, softcap, s);
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
