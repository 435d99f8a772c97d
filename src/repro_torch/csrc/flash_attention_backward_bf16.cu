// Flash attention backward for bf16 on Hopper's tensor cores (sm_90a):
// dQ, dK and dV of flash_attention_bf16.cu's forward (causal and
// sliding-window masks, the gemma2 logit softcap, GQA/MQA, queries
// right-aligned to the KV tail, ragged Sq and Skv, hd in {32, 64, 80, 128,
// 256}, (B, H, S, hd) tensors addressed by their strides, bidirectional
// (causal = 0) or causal).  f32 inputs go to the 3xTF32 kernels of
// flash_attention_backward.cu.
//
// Replaces: the gradient XLA derives for the reference's jnp attention
// (src/repro/models/layers.py, attention_forward with use_flash=False,
// _sdpa); the reference's Pallas kernel (src/repro/kernels/
// flash_attention.py) is forward only, and the reference trains through
// the jnp path.
//
// Contract (src/repro_torch/kernels/ref.py flash_attention_backward):
// with s = q.k / sqrt(hd) in f32, optionally s_c = tanh(s / cap) * cap,
// P = exp(s_c - LSE) over the unmasked keys of each query row,
//     dV = P^T dO,  dP = dO V^T,  D = rowsum(dO * O),
//     dS = P * (dP - D)  [* (1 - tanh^2(s / cap))],
//     dQ = dS K / sqrt(hd),  dK = dS^T Q / sqrt(hd),
// dK and dV summed over the g query heads that share a KV head; outputs
// in bf16.  LSE is the forward's (natural log, f32 (B, Hq, Sq)).  Every
// product runs on wgmma with f32 accumulators; P and dS are rounded to
// bf16 as its A operand (the forward rounds P the same way), every sum
// stays f32.
//
// Bound on this card: operations.  The band's backward is 2.5 times the
// forward's 4 * hd flops a (query, key) pair (Q.K^T and dO.V^T again,
// then dV, dK and dQ); at the training shape (8, 10, 512, 256) over one
// KV head, causal, 26.9 GFLOP: 0.027 ms at the bf16 tensor-core peak.
// dQ's own kernel recomputes S and dP (7 products a pair, not 5): that
// buys determinism without atomics.
//
// Design: four launches in one call, deterministic (no atomics; every sum
// in a fixed order).
//   (a) prep: a warp a query row (half a warp at hd 80): D =
//       rowsum(dO * O), the LSE times log2(e), both f32 and padded to whole
//       64-row tiles (pad rows 0), so that (b) copies a tile's 64 values
//       with one bulk copy.
//   (b) dkdv: a CTA holds one 64-key tile's K and V in shared memory and
//       walks a run of the band's (query tile, head) steps; a producer
//       thread TMA-loads each step's Q and dO tiles (128-byte swizzle) and
//       their LSE and D through an mbarrier ring.  Two consumer warpgroups
//       split the work so that each keeps one 64 x hd f32 accumulator (128
//       registers a thread at hd = 256, under the 255 limit): warpgroup 0
//       forms S^T = K Q^T, P^T = exp2(S^T - LSE) and dV += P^T dO;
//       warpgroup 1 forms dP^T = V dO^T, takes P^T (times the softcap's
//       factor, f32) from warpgroup 0 through a double-buffered exchange
//       in shared memory (named barriers), forms dS^T and dK += dS^T Q.
//       P^T and dS^T never leave registers as wgmma operands: the
//       accumulator's layout is the A-operand layout.
//   (c) sum: the band is spread evenly over the card: a key tile's steps
//       (g heads x its query tiles; under MQA the first key tile has 8
//       times the last one's) are cut into runs of at most `chunk` steps,
//       `chunk` the one of least estimated time (whole waves of the SMs,
//       since a last wave of a few CTAs costs a full one, times the
//       longest run), the longest key tiles first.  A key tile of one run writes dK and dV itself;
//       the runs of a longer one write f32 partials (row-major, mostly
//       still in L2), which (c) sums in run order, 8 columns a thread.
//   (d) dq: one CTA per (64-row query tile, head, batch), longest tiles
//       first: Q and dO stay in shared memory, a producer keeps a K/V ring
//       full; two consumer warpgroups take alternate key tiles, so that
//       one's products overlap the other's dS: S = Q K^T and dP = dO V^T
//       back to back on wgmma, dS (bf16, in registers), dQ += dS K; at the
//       end warpgroup 0 adds warpgroup 1's dQ (a fixed order).
// (b) and (d) walk only the tiles the band touches and mask element by
// element only on the diagonal, window-edge and ragged tiles; TMA reads
// rows past Sq or Skv as zeros.
//
// Head dim 80 (HuBERT X-Large) runs in exact 80-wide tiles (Tile<80>: five
// 16-column chunks in the 32-byte swizzle).  A step's four products there
// are 640 tensor-core clocks of an SM a warpgroup, its 4,096 exp2s 256
// clocks of the MUFU and its dS as many FMA-pipe clocks again, so what
// bounds it is how much of the exp and dS work hides under the products:
//   (b') flash_bwd_dkdv_hd80 replaces (b): both 64 x 80 f32 accumulators
//       fit one warpgroup (80 registers a thread), so each consumer
//       warpgroup owns its own 64-key tile (a CTA 128 keys) and forms S^T,
//       P^T, dP^T, dS^T, dV and dK itself: no P^T exchange, no barrier
//       between the warpgroups, and each Q, dO, LSE and D tile the
//       producer loads serves 128 keys.  S^T and dP^T are issued as two
//       groups: P^T's exp2s run while dP^T is on the tensor cores, dS^T
//       while dV is, and dV and dK run on under the next step's wait and
//       issue; a step whose query tile sees none of the warpgroup's keys
//       waits for them and frees their stage first, since under GQA a
//       dead tile is `group` steps and the ring has only kStages.  Runs
//       and their in-order sum (c) are (b)'s, over 128-key blocks.
//   (d) at hd 80 waits for S alone, forms P while dP runs, and leaves
//       dQ += dS K in flight until its next tile's S has landed.
//   Both have a softcap instantiation of their own (kCap), so without one
//   the scale folds into the exp2's FMA.  Issuing the next step's S and dP
//   before this step's last product (a deeper software pipeline) made
//   ptxas serialize every wgmma of the kernel, and K, V (or Q, dO) as
//   register A operands cost more than the shared-memory reads they saved
//   (PERF.md section 6).
// 1/sqrt(80) is not a power of two: the scale multiplies the f32 scores
// and the f32 dK and dQ sums, never a bf16 operand.

#include <math.h>

#include <algorithm>
#include <mutex>
#include <vector>

#include "hopper.cuh"

namespace {

constexpr int kB = 64;             // keys a key tile, rows a query tile

// element strides of (batch, head, seq) of q, k, v, o, do, dq, dk, dv; hd
// is contiguous
struct Strides {
  long long x[24];
};
enum { Q = 0, K = 3, V = 6, O = 9, DO = 12, DQ = 15, DK = 18, DV = 21 };

struct Shape {
  int Hq, group, Sq, Skv, causal, window;
  float scale, softcap;
  int Sq_pad;    // Sq rounded up to whole query tiles
  int kblock;    // keys of a dK/dV CTA: 64, or 128 at hd 80 (b')
  int n_kt;      // key blocks of kblock keys
  int chunk;     // the most (query tile, head) steps of a dK/dV CTA
  int n_runs;    // dK/dV CTAs of one (batch, KV head)
};

template <int HD>
struct Bwd {
  static constexpr int kBytes = Tile<HD>::kBytes;
  static constexpr int kStages = HD == 256 ? 2 : 4;
  static constexpr int kExchange = 32 * 128 * 4;   // one P^T buffer, bytes
  static constexpr int kRowStats = 2 * kB * 4;     // LSE and D of a tile
  // dkdv: K, V, the Q and dO rings, 2 exchange buffers, the LSE/D ring,
  // mbarriers, 1024-byte alignment
  static constexpr int kSmemKV = 1024 + (2 + 2 * kStages) * kBytes +
                                 2 * kExchange + kStages * kRowStats + 128;
  // dq: Q, dO, the K and V rings, mbarriers, alignment
  static constexpr int kSmemQ = 1024 + (2 + 2 * kStages) * kBytes + 128;
  // dkdv_hd80: two K and two V tiles, the Q and dO rings, the LSE/D ring,
  // mbarriers, alignment
  static constexpr int kSmemOwn = 1024 + (4 + 2 * kStages) * kBytes +
                                  kStages * kRowStats + 128;
};
static_assert(Bwd<256>::kSmemKV <= 232448, "dkdv shared memory");

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

// The query tiles whose rows see some key of key block j:
// [qt_lo, qt_lo + n_qt).
__host__ __device__ __forceinline__ void key_band(const Shape& sh, int j,
                                                  int& qt_lo, int& n_qt) {
  const int k0 = j * sh.kblock;
  const int k_last = imin(k0 + sh.kblock, sh.Skv) - 1;
  const int offset = sh.Skv - sh.Sq;
  const int q_lo = sh.causal ? imax(0, k0 - offset) : 0;
  const int q_hi = sh.window ? imin(sh.Sq, k_last + sh.window - offset)
                             : sh.Sq;             // exclusive
  qt_lo = q_lo / kB;
  n_qt = q_hi > q_lo ? (q_hi + kB - 1) / kB - qt_lo : 0;
}

// (query tile, head) steps of key tile j, and the runs they are cut into
__host__ __device__ __forceinline__ int tile_steps(const Shape& sh, int j) {
  int lo, n;
  key_band(sh, j, lo, n);
  return n * sh.group;
}
__host__ __device__ __forceinline__ int tile_runs(int steps, int chunk) {
  return steps > chunk ? (steps + chunk - 1) / chunk : 1;
}

// this thread's rows (row, row + 8) and first column of a 64-row wgmma
// accumulator: element e sits at row + 8 (e & 2 ? 1 : 0), column
// 8 (e / 4) + kc + (e & 1)
__device__ __forceinline__ int acc_row(int t) {
  return 16 * (t / 32) + (t % 32) / 4;
}
__device__ __forceinline__ int acc_col(int t) { return 2 * (t % 4); }

// a 64 x HD accumulator times `mul` -> bf16 rows [row0, row0 + 64) of out
// (row stride rs), rows at or past `limit` skipped
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long rs,
                                           int row0, int limit, int t,
                                           const float (&acc)[HD / 2],
                                           float mul) {
  const int row = row0 + acc_row(t);
  __nv_bfloat16* p = out + row * rs + acc_col(t);
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (row < limit) {
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    }
    if (row + 8 < limit) {
      *reinterpret_cast<uint32_t*>(p + 8 * rs + 8 * j) =
          pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
    }
  }
}

// The score in log2 units and, with a softcap, its derivative factor
// 1 - tanh^2 (the forward's formula, so that exp2(x - LSE log2 e) is the
// forward's p).
__device__ __forceinline__ float score_log2(float s, float scale_log2,
                                            float cap_in, float softcap,
                                            float& dcap) {
  if (softcap > 0.f) {
    const float t = tanhf(s * cap_in);
    dcap = 1.f - t * t;
    return softcap * t * kLog2e;
  }
  dcap = 1.f;
  return s * scale_log2;
}

// p = exp2(the score in log2 units - l2), l2 the row's LSE in log2 units,
// and with a softcap (kCap) its derivative factor; without one the scale
// folds into the exp2's FMA
template <bool kCap>
__device__ __forceinline__ float prob(float s, float l2, float scale_log2,
                                      float cap_in, float softcap,
                                      float& dcap) {
  if constexpr (kCap) {
    return exp2_ftz(score_log2(s, scale_log2, cap_in, softcap, dcap) - l2);
  } else {
    dcap = 1.f;
    return exp2_ftz(fmaf(s, scale_log2, -l2));
  }
}

__device__ __forceinline__ bool sees(const Shape& sh, int query, int key) {
  const int pos = query + sh.Skv - sh.Sq;
  bool ok = query < sh.Sq && key < sh.Skv;
  if (sh.causal) ok = ok && key <= pos;
  if (sh.window) ok = ok && pos - key < sh.window;
  return ok;
}

// Whether the mask cuts the (64 queries from q0) x (64 keys from k0) tile.
__device__ __forceinline__ bool edge_tile(const Shape& sh, int q0, int k0) {
  const int offset = sh.Skv - sh.Sq;
  return !(q0 + kB <= sh.Sq && k0 + kB <= sh.Skv &&
           (!sh.causal || k0 + kB - 1 <= q0 + offset) &&
           (!sh.window || q0 + kB - 1 + offset - k0 < sh.window));
}

// Whether some query of that tile sees some key of it.
__device__ __forceinline__ bool live_tile(const Shape& sh, int q0, int k0) {
  const int offset = sh.Skv - sh.Sq;
  const int pos_hi = imin(q0 + kB, sh.Sq) - 1 + offset;
  const int k_hi = imin(k0 + kB, sh.Skv) - 1;
  return q0 < sh.Sq && k0 < sh.Skv && (!sh.causal || k0 <= pos_hi) &&
         (!sh.window || q0 + offset - k_hi < sh.window);
}

// ---------------------------------------------------------------------
// (a) per query row: D and the LSE in log2 units, padded
// ---------------------------------------------------------------------
// lanes of a warp that read one row: 16 at hd 80 (its 10 uint4 of O and
// of dO), two rows a warp; a whole warp at the other head dims
template <int HD>
constexpr int kPrepLanes = HD == 80 ? 16 : 32;

template <int HD>
__global__ void __launch_bounds__(256)
    flash_bwd_prep(const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ lse2,
                   float* __restrict__ delta, Strides st, Shape sh,
                   long long rows) {
  constexpr int kLanes = kPrepLanes<HD>;
  const long long r = (long long)blockIdx.x * (256 / kLanes) +
                      threadIdx.x / kLanes;
  if (kLanes == 32 && r >= rows) return;    // a whole warp past the end
  const int lane = threadIdx.x % kLanes;
  const long long bh = r / sh.Sq_pad;
  const int q = (int)(r % sh.Sq_pad);
  // both rows of a warp reach the shuffles, a row past the end or past Sq
  // with d = 0
  const bool live = r < rows && q < sh.Sq;
  float d = 0.f, l = 0.f;
  if (live) {
    const long long b = bh / sh.Hq, h = bh % sh.Hq;
    const long long* x = st.x;
    const __nv_bfloat16* orow = o + b * x[O] + h * x[O + 1] + q * x[O + 2];
    const __nv_bfloat16* grow = dout + b * x[DO] + h * x[DO + 1] + q * x[DO + 2];
    for (int c = lane * 8; c < HD; c += 8 * kLanes) {
      const uint4 ov = __ldg(reinterpret_cast<const uint4*>(orow + c));
      const uint4 gv = __ldg(reinterpret_cast<const uint4*>(grow + c));
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(o2[i]);
        const float2 g = __bfloat1622float2(g2[i]);
        d = fmaf(a.x, g.x, d);
        d = fmaf(a.y, g.y, d);
      }
    }
    l = lse[bh * sh.Sq + q] * kLog2e;
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    d += __shfl_xor_sync(0xffffffffu, d, off);
  if (lane == 0 && r < rows) {
    lse2[r] = l;
    delta[r] = d;
  }
}

// A 64 x HD accumulator's rows as f32 partials of this run: [run][dV,
// dK][key row of the block][column], `part` 0 dV, 1 dK, the thread's rows
// `row` and row + 8 of the block
template <int HD>
__device__ __forceinline__ void store_partial(float* partial, int b, int hk,
                                              int Hkv, const Shape& sh,
                                              int part, int row, int kc,
                                              const float (&acc)[HD / 2]) {
  float* dst = partial +
               (((((long long)b * Hkv + hk) * sh.n_runs + blockIdx.x) * 2 +
                 part) * sh.kblock + row) * HD + kc;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<float2*>(dst + 8 * j) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(dst + 8 * HD + 8 * j) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------
// (b) per run of a key tile's steps: dK and dV
// ---------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkdv(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap,
                   const float* __restrict__ lse2,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv,
                   float* __restrict__ partial, Strides st, Shape sh) {
  using T = Tile<HD>;
  using C = Bwd<HD>;
  extern __shared__ uint8_t smem[];
  uint8_t* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  const uint32_t sK = smem_addr(base);
  const uint32_t sV = sK + C::kBytes;
  const uint32_t sQ = sV + C::kBytes;                  // + stage * kBytes
  const uint32_t sdO = sQ + C::kStages * C::kBytes;    // + stage * kBytes
  float* xchg = reinterpret_cast<float*>(base + (2 + 2 * C::kStages) * C::kBytes);
  float* stats = xchg + 2 * 32 * 128;                  // + stage * 2 kB
  const uint32_t kv_full = smem_addr(stats + C::kStages * 2 * kB);
  const uint32_t full = kv_full + 8;                   // + 8 * stage
  const uint32_t empty = full + 8 * C::kStages;        // + 8 * stage

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
  const int k0 = j * sh.kblock;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);     // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * C::kBytes);
      for (int c = 0; c < HD / T::kCols; ++c) {
        tma_load(sK + c * T::kChunkBytes, &kmap, kv_full, c * T::kCols, k0,
                 hk, b);
        tma_load(sV + c * T::kChunkBytes, &vmap, kv_full, c * T::kCols, k0,
                 hk, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % C::kStages;
        if (i >= C::kStages) mbar_wait(empty + 8 * s, (i / C::kStages - 1) & 1);
        const int it = it0 + i;
        const int q0 = (qt_lo + it / sh.group) * kB;
        const int h = hk * sh.group + it % sh.group;
        mbar_expect_tx(full + 8 * s, 2 * C::kBytes + C::kRowStats);
        for (int c = 0; c < HD / T::kCols; ++c) {
          const uint32_t off = s * C::kBytes + c * T::kChunkBytes;
          tma_load(sQ + off, &qmap, full + 8 * s, c * T::kCols, q0, h, b);
          tma_load(sdO + off, &domap, full + 8 * s, c * T::kCols, q0, h, b);
        }
        const long long row = ((long long)b * sh.Hq + h) * sh.Sq_pad + q0;
        const uint32_t sS = smem_addr(stats + s * 2 * kB);
        bulk_load(sS, lse2 + row, kB * 4, full + 8 * s);
        bulk_load(sS + kB * 4, delta + row, kB * 4, full + 8 * s);
      }
    }
  } else {
    // ---- consumers: warpgroup 0 P^T and dV, warpgroup 1 dS^T and dK ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int kr = acc_row(t), kc = acc_col(t);  // rows: keys, cols: queries
    float acc[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;
    mbar_wait(kv_full, 0);

    if (wg == 0) {
      const float scale_log2 = sh.scale * kLog2e;
      const float cap_in = sh.softcap > 0.f ? sh.scale / sh.softcap : 0.f;
      for (int i = 0; i < n; ++i) {
        const int s = i % C::kStages;
        mbar_wait(full + 8 * s, (i / C::kStages) & 1);
        const int q0 = (qt_lo + (it0 + i) / sh.group) * kB;
        // S^T = K Q^T (64 keys x 64 queries)
        float sc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = 0.f;
        wgmma_fence();
        wgmma_abt<HD>(sc, sK, sQ + s * C::kBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // P^T; P^T times the softcap's factor goes to warpgroup 1
        const int pb = i & 1;
        if (i >= 2) bar_sync(3 + pb, 256);   // buffer pb read (step i - 2)
        float* out = xchg + pb * 32 * 128 + t;
        const float* L = stats + s * 2 * kB;
        const bool edge = edge_tile(sh, q0, k0);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int qi = 8 * (e / 4) + kc + (e & 1);
          float dcap;
          const float x = score_log2(sc[e], scale_log2, cap_in, sh.softcap,
                                     dcap);
          float p = exp2f(x - L[qi]);
          if (edge && !sees(sh, q0 + qi, k0 + kr + ((e & 2) ? 8 : 0)))
            p = 0.f;
          out[e * 128] = p * dcap;
          sc[e] = p;
        }
        bar_arrive(1 + pb, 256);
        uint32_t pa[4][4];
#pragma unroll
        for (int e = 0; e < 32; e += 2)
          pa[e / 8][e % 8 / 2] = pack_bf16(sc[e], sc[e + 1]);

        // dV += P^T dO
        wgmma_fence();
        wgmma_a_tile<HD>(acc, pa, sdO + s * C::kBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    } else {
      for (int i = 0; i < n; ++i) {
        const int s = i % C::kStages;
        mbar_wait(full + 8 * s, (i / C::kStages) & 1);
        // dP^T = V dO^T (64 keys x 64 queries)
        float dp[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) dp[e] = 0.f;
        wgmma_fence();
        wgmma_abt<HD>(dp, sV, sdO + s * C::kBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dp);

        // dS^T = P^T (dP^T - D), P^T from warpgroup 0
        const int pb = i & 1;
        bar_sync(1 + pb, 256);
        const float* in = xchg + pb * 32 * 128 + t;
        const float* D = stats + s * 2 * kB + kB;
        uint32_t da[4][4];
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int qi = 8 * (e / 4) + kc;
          da[e / 8][e % 8 / 2] =
              pack_bf16(in[e * 128] * (dp[e] - D[qi]),
                        in[(e + 1) * 128] * (dp[e + 1] - D[qi + 1]));
        }
        if (i + 2 < n) bar_arrive(3 + pb, 256);  // warpgroup 0 refills pb

        // dK += dS^T Q
        wgmma_fence();
        wgmma_a_tile<HD>(acc, da, sQ + s * C::kBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    }

    const long long* x = st.x;
    if (runs == 1) {
      __nv_bfloat16* dst = wg == 0 ? dv + b * x[DV] + hk * x[DV + 1]
                                   : dk + b * x[DK] + hk * x[DK + 1];
      store_rows<HD>(dst, wg == 0 ? x[DV + 2] : x[DK + 2], k0, sh.Skv, t,
                     acc, wg == 0 ? 1.f : sh.scale);
    } else {
      // f32 partials, [run][dV, dK][key][column]
      store_partial<HD>(partial, b, hk, gridDim.y, sh, wg, kr, kc, acc);
    }
  }
}

// ---------------------------------------------------------------------
// (b') hd 80, per run of a 128-key block's steps: each consumer
// warpgroup dK and dV of its own 64 keys
// ---------------------------------------------------------------------
template <int HD, bool kCap>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkdv_hd80(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap domap,
                        const float* __restrict__ lse2,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv,
                        float* __restrict__ partial, Strides st, Shape sh) {
  using T = Tile<HD>;
  using C = Bwd<HD>;
  extern __shared__ uint8_t smem[];
  uint8_t* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  const uint32_t sK = smem_addr(base);                 // + wg * kBytes
  const uint32_t sV = sK + 2 * C::kBytes;              // + wg * kBytes
  const uint32_t sQ = sV + 2 * C::kBytes;              // + stage * kBytes
  const uint32_t sdO = sQ + C::kStages * C::kBytes;    // + stage * kBytes
  float* stats = reinterpret_cast<float*>(base + (4 + 2 * C::kStages) * C::kBytes);
  const uint32_t kv_full = smem_addr(stats + C::kStages * 2 * kB);
  const uint32_t full = kv_full + 8;                   // + 8 * stage
  const uint32_t empty = full + 8 * C::kStages;        // + 8 * stage

  // this CTA's key block j and its run [it0, it0 + n) of the block's steps
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
  const int k0 = j * sh.kblock;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);     // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 4 * C::kBytes);
      for (int w = 0; w < 2; ++w) {
        for (int c = 0; c < HD / T::kCols; ++c) {
          const uint32_t off = w * C::kBytes + c * T::kChunkBytes;
          tma_load(sK + off, &kmap, kv_full, c * T::kCols, k0 + kB * w, hk, b);
          tma_load(sV + off, &vmap, kv_full, c * T::kCols, k0 + kB * w, hk, b);
        }
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % C::kStages;
        if (i >= C::kStages) mbar_wait(empty + 8 * s, (i / C::kStages - 1) & 1);
        const int it = it0 + i;
        const int q0 = (qt_lo + it / sh.group) * kB;
        const int h = hk * sh.group + it % sh.group;
        mbar_expect_tx(full + 8 * s, 2 * C::kBytes + C::kRowStats);
        for (int c = 0; c < HD / T::kCols; ++c) {
          const uint32_t off = s * C::kBytes + c * T::kChunkBytes;
          tma_load(sQ + off, &qmap, full + 8 * s, c * T::kCols, q0, h, b);
          tma_load(sdO + off, &domap, full + 8 * s, c * T::kCols, q0, h, b);
        }
        const long long row = ((long long)b * sh.Hq + h) * sh.Sq_pad + q0;
        const uint32_t sS = smem_addr(stats + s * 2 * kB);
        bulk_load(sS, lse2 + row, kB * 4, full + 8 * s);
        bulk_load(sS + kB * 4, delta + row, kB * 4, full + 8 * s);
      }
    }
  } else {
    // ---- consumer warpgroup wg: keys kw0 .. kw0 + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int kr = acc_row(t), kc = acc_col(t);  // rows: keys, cols: queries
    const int kw0 = k0 + kB * wg;
    const uint32_t sKw = sK + wg * C::kBytes, sVw = sV + wg * C::kBytes;
    const float scale_log2 = sh.scale * kLog2e;
    const float cap_in = sh.softcap > 0.f ? sh.scale / sh.softcap : 0.f;
    float dka[HD / 2], dva[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) dka[e] = dva[e] = 0.f;
    uint32_t pa[4][4] = {}, da[4][4] = {};  // P^T, dS^T: A operands of dV, dK
    int pend = -1;                 // the stage whose dV and dK are in flight
    mbar_wait(kv_full, 0);

    for (int i = 0; i < n; ++i) {
      const int s = i % C::kStages;
      mbar_wait(full + 8 * s, (i / C::kStages) & 1);
      const int q0 = (qt_lo + (it0 + i) / sh.group) * kB;
      if (!live_tile(sh, q0, kw0)) {
        // release the last live step's stage too: with GQA a dead query
        // tile is `group` steps, and the producer refills that stage
        // kStages steps on
        if (pend >= 0) {
          wgmma_wait<0>();
          fence_regs(dka);
          fence_regs(dva);
          if (lane == 0) mbar_arrive(empty + 8 * pend);
          pend = -1;
        }
        if (lane == 0) mbar_arrive(empty + 8 * s);
        continue;
      }
      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries)
      float sc[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
      wgmma_fence();
      wgmma_abt<HD>(sc, sKw, sQ + s * C::kBytes);
      wgmma_commit();
      wgmma_abt<HD>(dp, sVw, sdO + s * C::kBytes);
      wgmma_commit();
      wgmma_wait<1>();     // S^T, and the last step's dV and dK, landed
      fence_regs(sc);
      fence_frag(pa);
      fence_frag(da);
      if (pend >= 0 && lane == 0) mbar_arrive(empty + 8 * pend);

      // P^T (bf16, dV's A operand); sc keeps P^T times the softcap factor
      const float* L = stats + s * 2 * kB;
      const float* D = L + kB;
      const bool edge = edge_tile(sh, q0, kw0);
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int qi = 8 * (e / 4) + kc;
        const float2 l2 = *reinterpret_cast<const float2*>(L + qi);
        float p[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float dcap;
          p[u] = prob<kCap>(sc[e + u], u ? l2.y : l2.x, scale_log2, cap_in,
                            sh.softcap, dcap);
          if (edge && !sees(sh, q0 + qi + u, kw0 + kr + ((e & 2) ? 8 : 0)))
            p[u] = 0.f;
          sc[e + u] = kCap ? p[u] * dcap : p[u];
        }
        pa[e / 8][e % 8 / 2] = pack_bf16(p[0], p[1]);
      }
      // dV += P^T dO
      wgmma_fence();
      wgmma_a_tile<HD>(dva, pa, sdO + s * C::kBytes);
      wgmma_commit();
      wgmma_wait<1>();     // dP^T landed; dV runs on
      fence_regs(dp);

      // dS^T = P^T (dP^T - D), bf16, dK's A operand
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(D + 8 * (e / 4) + kc);
        da[e / 8][e % 8 / 2] = pack_bf16(sc[e] * (dp[e] - d2.x),
                                         sc[e + 1] * (dp[e + 1] - d2.y));
      }
      // dK += dS^T Q
      wgmma_fence();
      wgmma_a_tile<HD>(dka, da, sQ + s * C::kBytes);
      wgmma_commit();
      pend = s;
    }
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
    if (pend >= 0 && lane == 0) mbar_arrive(empty + 8 * pend);

    const long long* x = st.x;
    if (runs == 1) {
      store_rows<HD>(dv + b * x[DV] + hk * x[DV + 1], x[DV + 2], kw0, sh.Skv,
                     t, dva, 1.f);
      store_rows<HD>(dk + b * x[DK] + hk * x[DK + 1], x[DK + 2], kw0, sh.Skv,
                     t, dka, sh.scale);
    } else {
      store_partial<HD>(partial, b, hk, gridDim.y, sh, 0, kB * wg + kr, kc,
                        dva);
      store_partial<HD>(partial, b, hk, gridDim.y, sh, 1, kB * wg + kr, kc,
                        dka);
    }
  }
}

// ---------------------------------------------------------------------
// (c) per key block of several runs: dV and dK, the runs summed in order
// ---------------------------------------------------------------------
// threads of 8 columns each that one key block's dV and dK take
template <int HD, int KB>
constexpr int kSumThreads = 2 * KB * HD / 8;

template <int HD, int KB>
__global__ void __launch_bounds__(256)
    flash_bwd_dkdv_sum(const float* __restrict__ partial,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, Strides st, Shape sh) {
  constexpr int kBlocks = kSumThreads<HD, KB> / 256;  // blocks a key block
  const int j = blockIdx.x / kBlocks, hk = blockIdx.y, b = blockIdx.z;
  int first = 0;
  for (int jj = 0; jj < j; ++jj) first += tile_runs(tile_steps(sh, jj), sh.chunk);
  const int runs = tile_runs(tile_steps(sh, j), sh.chunk);
  if (runs == 1) return;                 // (b) wrote this block itself
  const int i = (blockIdx.x % kBlocks) * 256 + threadIdx.x;
  const int part = i / (KB * HD / 8);    // 0: dV, 1: dK
  const int row = i / (HD / 8) % KB, col = i % (HD / 8) * 8;
  const int key = j * KB + row;
  if (key >= sh.Skv) return;
  const float* src = partial +
                     (((((long long)b * gridDim.y + hk) * sh.n_runs + first) *
                           2 + part) * KB + row) * HD + col;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
  for (int r = 0; r < runs; ++r) {
    const float4* p = reinterpret_cast<const float4*>(src + r * 2 * KB * HD);
    const float4 u = p[0], w = p[1];
    a = make_float4(a.x + u.x, a.y + u.y, a.z + u.z, a.w + u.w);
    c = make_float4(c.x + w.x, c.y + w.y, c.z + w.z, c.w + w.w);
  }
  const long long* x = st.x;
  const int o = part ? DK : DV;
  const float m = part ? sh.scale : 1.f;
  __nv_bfloat16* dst = (part ? dk : dv) + b * x[o] + hk * x[o + 1] +
                       key * x[o + 2] + col;
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16(a.x * m, a.y * m), pack_bf16(a.z * m, a.w * m),
                 pack_bf16(c.x * m, c.y * m), pack_bf16(c.z * m, c.w * m));
}

// ---------------------------------------------------------------------
// (d) per query tile: dQ over the band
// ---------------------------------------------------------------------
template <int HD, bool kCap>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap,
                 const float* __restrict__ lse2,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, Strides st, Shape sh) {
  using T = Tile<HD>;
  using C = Bwd<HD>;
  extern __shared__ uint8_t smem[];
  uint8_t* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  const uint32_t sQ = smem_addr(base);
  const uint32_t sdO = sQ + C::kBytes;
  const uint32_t sK = sdO + C::kBytes;                 // + stage * kBytes
  const uint32_t sV = sK + C::kStages * C::kBytes;     // + stage * kBytes
  const uint32_t q_full = sV + C::kStages * C::kBytes;
  const uint32_t full = q_full + 8;                    // + 8 * stage
  const uint32_t empty = full + 8 * C::kStages;        // + 8 * stage
  // warpgroup 1's dQ, handed to warpgroup 0 over the emptied K/V ring
  float* handoff = reinterpret_cast<float*>(base + 2 * C::kBytes);
  static_assert(2 * C::kStages * C::kBytes >= 64 * HD * 4, "dQ hand-off");

  const int h = blockIdx.x, b = blockIdx.z;
  const int hk = h / sh.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;    // longest tiles first
  const int offset = sh.Skv - sh.Sq;
  const int pos_lo = q0 + offset;
  const int pos_hi = imin(q0 + kB, sh.Sq) - 1 + offset;
  const int k_end = sh.causal ? imin(sh.Skv, pos_hi + 1) : sh.Skv;
  const int k_begin =
      (sh.window ? imax(0, pos_lo - sh.window + 1) : 0) / kB * kB;
  const int n_tiles = (k_end - k_begin + kB - 1) / kB;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);     // the warps of the tile's warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * C::kBytes);
      for (int c = 0; c < HD / T::kCols; ++c) {
        tma_load(sQ + c * T::kChunkBytes, &qmap, q_full, c * T::kCols, q0, h,
                 b);
        tma_load(sdO + c * T::kChunkBytes, &domap, q_full, c * T::kCols, q0,
                 h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::kStages;
        if (i >= C::kStages) mbar_wait(empty + 8 * s, (i / C::kStages - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * C::kBytes);
        const int kt = k_begin + i * kB;
        for (int c = 0; c < HD / T::kCols; ++c) {
          const uint32_t off = s * C::kBytes + c * T::kChunkBytes;
          tma_load(sK + off, &kmap, full + 8 * s, c * T::kCols, kt, hk, b);
          tma_load(sV + off, &vmap, full + 8 * s, c * T::kCols, kt, hk, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: rows q0 .. q0 + 63, key tiles i with
    // i % 2 == wg, so that one's products overlap the other's dS ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int qr = acc_row(t), kc = acc_col(t);   // rows: queries, cols: keys
    const long long rb = ((long long)b * sh.Hq + h) * sh.Sq_pad + q0 + qr;
    const float L0 = lse2[rb], L1 = lse2[rb + 8];
    const float D0 = delta[rb], D1 = delta[rb + 8];
    const float scale_log2 = sh.scale * kLog2e;
    const float cap_in = sh.softcap > 0.f ? sh.scale / sh.softcap : 0.f;
    float acc[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;

    mbar_wait(q_full, 0);
    if constexpr (HD == 80) {
      // S and dP issued as two groups: P forms while dP runs, and dQ += dS
      // K runs on until the next tile's S has landed
      uint32_t da[4][4] = {};
      int pend = -1;        // the stage whose dQ product is in flight
      for (int i = wg; i < n_tiles; i += 2) {
        const int s = i % C::kStages;
        const int kt = k_begin + i * kB;
        mbar_wait(full + 8 * s, (i / C::kStages) & 1);
        float sc[32], dp[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
        wgmma_fence();
        wgmma_abt<HD>(sc, sQ, sK + s * C::kBytes);
        wgmma_commit();
        wgmma_abt<HD>(dp, sdO, sV + s * C::kBytes);
        wgmma_commit();
        wgmma_wait<1>();    // S, and the last tile's dQ product, landed
        fence_regs(sc);
        fence_frag(da);
        if (pend >= 0 && lane == 0) mbar_arrive(empty + 8 * pend);

        // P [* softcap factor], f32, in sc
        const bool edge = edge_tile(sh, q0, kt);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const bool hi = (e & 2) != 0;
          float dcap;
          float p = prob<kCap>(sc[e], hi ? L1 : L0, scale_log2, cap_in,
                               sh.softcap, dcap);
          if (edge && !sees(sh, q0 + qr + (hi ? 8 : 0),
                            kt + 8 * (e / 4) + kc + (e & 1)))
            p = 0.f;
          sc[e] = kCap ? p * dcap : p;
        }
        wgmma_wait<0>();    // dP landed
        fence_regs(dp);
        // dS = P (dP - D), bf16, as the A operand of dQ += dS K
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const float d = (e & 2) ? D1 : D0;
          da[e / 8][e % 8 / 2] = pack_bf16(sc[e] * (dp[e] - d),
                                           sc[e + 1] * (dp[e + 1] - d));
        }
        wgmma_fence();
        wgmma_a_tile<HD>(acc, da, sK + s * C::kBytes);
        wgmma_commit();
        pend = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (pend >= 0 && lane == 0) mbar_arrive(empty + 8 * pend);
    } else {
    for (int i = wg; i < n_tiles; i += 2) {
      const int s = i % C::kStages;
      const int kt = k_begin + i * kB;
      mbar_wait(full + 8 * s, (i / C::kStages) & 1);
      // S = Q K^T and dP = dO V^T (64 queries x 64 keys), one group
      float sc[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
      wgmma_fence();
      wgmma_abt<HD>(sc, sQ, sK + s * C::kBytes);
      wgmma_abt<HD>(dp, sdO, sV + s * C::kBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // dS = P (dP - D) [* softcap factor], bf16, as the A operand
      const bool edge = edge_tile(sh, q0, kt);
      uint32_t da[4][4];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        float ds[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const bool hi = (e & 2) != 0;
          float dcap;
          const float xs = score_log2(sc[e + u], scale_log2, cap_in,
                                      sh.softcap, dcap);
          float p = exp2f(xs - (hi ? L1 : L0));
          if (edge && !sees(sh, q0 + qr + (hi ? 8 : 0),
                            kt + 8 * (e / 4) + kc + u))
            p = 0.f;
          ds[u] = p * dcap * (dp[e + u] - (hi ? D1 : D0));
        }
        da[e / 8][e % 8 / 2] = pack_bf16(ds[0], ds[1]);
      }

      // dQ += dS K, K MN-major
      wgmma_fence();
      wgmma_a_tile<HD>(acc, da, sK + s * C::kBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    }

    // dQ = warpgroup 0's sum + warpgroup 1's, in that order; every tile
    // has been read, so the K/V ring holds the hand-off
    bar_sync(1, 256);
    float* hand = handoff + t;
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) hand[e * 128] = acc[e];
    }
    bar_sync(2, 256);
    if (wg == 0) {
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) acc[e] += hand[e * 128];
      const long long* x = st.x;
      store_rows<HD>(dq + b * x[DQ] + h * x[DQ + 1], x[DQ + 2], q0, sh.Sq, t,
                     acc, sh.scale);
    }
  }
}

// The launch plan of one shape: the run length that spreads the dK/dV
// work over the card's SMs, and the scratch.
struct Plan {
  Shape sh;                // scale and softcap unset
  long long stat_rows;     // B * Hq * Sq_pad
  long long partials;      // f32 partial values (0: no key tile is split)
};

Plan make_plan(int B, int Hq, int Hkv, int Sq, int Skv, int hd, int causal,
               int window, int n_sm) {
  Plan p;
  Shape& sh = p.sh;
  const int kblock = hd == 80 ? 2 * kB : kB;     // (b') or (b)
  sh = Shape{Hq, Hq / Hkv, Sq, Skv, causal, window, 0.f, 0.f,
             (Sq + kB - 1) / kB * kB, kblock, (Skv + kblock - 1) / kblock, 1,
             0};
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
  // one step for a CTA's own loads and stores; ties to the longer run
  // (fewer partials).  Runs from a quarter of a step a CTA up to 4 times
  // that.
  const int lo = imax(2, (int)((total + 4LL * n_sm - 1) / (4LL * n_sm)));
  const int hi = imax(lo, imin(longest, 4 * lo));
  long long best = -1;
  for (int c = lo; c <= hi; ++c) {
    int n = 0;
    for (int j = 0; j < sh.n_kt; ++j) n += tile_runs(steps[j], c);
    const long long ctas = (long long)n * B * Hkv;
    const long long cost = (ctas + n_sm - 1) / n_sm * (c + 1);
    if (best < 0 || cost <= best) {
      best = cost;
      sh.chunk = c;
      sh.n_runs = n;
    }
  }
  p.stat_rows = (long long)B * Hq * sh.Sq_pad;
  p.partials = sh.n_runs > sh.n_kt
                   ? (long long)B * Hkv * sh.n_runs * 2 * kblock * hd : 0;
  return p;
}

// make_plan for the current device, the last shape's kept: a training
// step calls the backward of one shape many times, twice a call
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
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* scratch, const Strides& st, const Plan& p, int B, int Hkv,
           cudaStream_t s) {
  using C = Bwd<HD>;
  // (b') at hd 80, (b) else; the shared-memory attributes are set once
  // per device
  constexpr bool own = HD == 80;
  constexpr int kb_smem = own ? C::kSmemOwn : C::kSmemKV;
  constexpr int kb_rows = own ? 2 * kB : kB;
  // the softcap's own instantiations at hd 80 (kCap); other head dims
  // read it at run time
  static int kb_done[kMaxDevices], kd_done[kMaxDevices];
  static int kb_cap_done[kMaxDevices], kd_cap_done[kMaxDevices];
  const Shape& sh = p.sh;
  const long long* x = st.x;
  CUtensorMap qm, km, vm, dom;
  if (!encoder()) return (int)cudaErrorNotSupported;
  int dev = -1;
  cudaError_t e = bind_device(q, &dev);
  if (e != cudaSuccess) return (int)e;
  if (!make_map<HD>(&qm, q, sh.Sq, sh.Hq, B, x + Q) ||
      !make_map<HD>(&km, k, sh.Skv, Hkv, B, x + K) ||
      !make_map<HD>(&vm, v, sh.Skv, Hkv, B, x + V) ||
      !make_map<HD>(&dom, dout, sh.Sq, sh.Hq, B, x + DO)) {
    return (int)cudaErrorInvalidValue;
  }
  float* lse2 = scratch;
  float* delta = lse2 + p.stat_rows;
  float* partial = delta + p.stat_rows;
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);

  constexpr int prep_rows = 256 / kPrepLanes<HD>;    // rows a block
  flash_bwd_prep<HD><<<(unsigned)((p.stat_rows + prep_rows - 1) / prep_rows),
                       256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, lse2, delta, st, sh,
      p.stat_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 kb_grid(sh.n_runs, Hkv, B);
  const bool cap = sh.softcap > 0.f;
  if constexpr (own) {
    auto kb = cap ? flash_bwd_dkdv_hd80<HD, true>
                  : flash_bwd_dkdv_hd80<HD, false>;
    e = smem_once(cap ? kb_cap_done : kb_done, dev, kb, kb_smem);
    if (e != cudaSuccess) return (int)e;
    kb<<<kb_grid, 384, kb_smem, s>>>(qm, km, vm, dom, lse2, delta, dkp, dvp,
                                     partial, st, sh);
  } else {
    e = smem_once(kb_done, dev, flash_bwd_dkdv<HD>, kb_smem);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dkdv<HD><<<kb_grid, 384, kb_smem, s>>>(
        qm, km, vm, dom, lse2, delta, dkp, dvp, partial, st, sh);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  if (p.partials) {
    flash_bwd_dkdv_sum<HD, kb_rows>
        <<<dim3(sh.n_kt * (kSumThreads<HD, kb_rows> / 256), Hkv, B), 256, 0,
           s>>>(partial, dkp, dvp, st, sh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }

  auto kd = flash_bwd_dq<HD, false>;
  if constexpr (own) {
    if (cap) kd = flash_bwd_dq<HD, true>;
  }
  e = smem_once(own && cap ? kd_cap_done : kd_done, dev, kd, C::kSmemQ);
  if (e != cudaSuccess) return (int)e;
  kd<<<dim3(sh.Hq, sh.Sq_pad / kB, B), 384, C::kSmemQ, s>>>(
      qm, km, vm, dom, lse2, delta, dqp, st, sh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 scratch values a flash_attention_bf16_bwd call of this shape needs
// (-1 for a shape it refuses).
long long flash_attention_bf16_bwd_scratch(int B, int Hq, int Hkv, int Sq,
                                           int Skv, int hd, int causal,
                                           int window) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv < Sq) return -1;
  const Plan p = plan_for(B, Hq, Hkv, Sq, Skv, hd, causal, window);
  return 2 * p.stat_rows + p.partials;
}

// q (B, Hq, Sq, hd), k/v (B, Hkv, Skv, hd), o and dout like q, dq like q,
// dk/dv like k, all bf16, each addressed by the 24 element strides in
// `strides` (q, k, v, o, dout, dq, dk, dv; batch, head, seq); hd in {32,
// 64, 80, 128, 256} is contiguous; every pointer and stride is a multiple of
// 16 bytes.  lse: the forward's f32 (B, Hq, Sq) log-sum-exp (contiguous).
// scratch: flash_attention_bf16_bwd_scratch(...) f32 values.  Returns a
// cudaError_t code (0 on success).  Three or four launches, in order.
int flash_attention_bf16_bwd(const void* q, const void* k, const void* v,
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
  const float* l = static_cast<const float*>(lse);
  float* w = static_cast<float*>(scratch);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, dout, l, dq, dk, dv, w, st, p, B, Hkv, s);
    case 64:
      return launch<64>(q, k, v, o, dout, l, dq, dk, dv, w, st, p, B, Hkv, s);
    case 80:    // exact-width tiles, dK/dV by (b')
      return launch<80>(q, k, v, o, dout, l, dq, dk, dv, w, st, p, B, Hkv, s);
    case 128:
      return launch<128>(q, k, v, o, dout, l, dq, dk, dv, w, st, p, B, Hkv, s);
    case 256:
      return launch<256>(q, k, v, o, dout, l, dq, dk, dv, w, st, p, B, Hkv, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
