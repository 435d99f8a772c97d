// Flash attention (forward) for bf16 on Hopper's tensor cores (sm_90a):
// online softmax over 64-key tiles with causal / sliding-window masks, the
// gemma2 logit softcap and GQA/MQA (kv head = h / group), queries
// right-aligned to the KV tail, ragged Sq and Skv, hd in {32, 64, 128,
// 256}, (B, H, S, hd) tensors addressed by their strides.  f32 inputs go to
// the FMA kernel of flash_attention.cu.
//
// Replaces: src/repro/kernels/flash_attention.py, function flash_attention
// (the Pallas kernel: grid (B, Hq, Sq/bq, Skv/bk), the running (m, l, acc)
// in VMEM scratch across the sequential KV grid steps).
//
// Contract (that kernel's _kernel and src/repro/kernels/ref.py
// flash_attention): s = (q.k) / sqrt(hd) in f32 (bf16 products are exact
// in f32; the scale is applied to the f32 scores, not to q in bf16, since
// at hd = 32 and 128 it is not a power of two); optionally
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

#include <cuda.h>          // CUtensorMap and its enums (libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 2;                 // warpgroups of 64 query rows
constexpr int kBQ = 64 * kConsumers;          // query rows per CTA
constexpr int kBK = 64;                       // keys per tile
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory tiles of 64 rows x HD bf16, stored as HD / kCols column
// chunks of 64 rows x kSwizzle bytes, each row's 16-byte units swizzled by
// the row (TMA's and wgmma's 128- or 64-byte swizzle).
template <int HD>
struct Tile {
  static constexpr int kSwizzle = HD >= 64 ? 128 : 64;   // bytes of a chunk row
  static constexpr int kCols = kSwizzle / 2;             // bf16 of a chunk row
  static constexpr int kChunkBytes = 64 * kSwizzle;
  static constexpr int kBytes = 64 * HD * 2;
  static constexpr int kStages = HD == 256 ? 2 : 4;
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;  // wgmma B128 / B64
  // Q of both consumers, the K and V rings, mbarriers, 1024-byte alignment
  static constexpr int kSmem = 1024 + (kConsumers + 2 * kStages) * kBytes + 128;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// box (kCols, 64, 1, 1) of a (hd, S, H, B) map at (c0, c1, c2, c3) -> dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the accumulator is read only after the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64) = A (64 x 16, shared, K-major) * B (64 x 16, shared, K-major)
// + D if scale_d, else + 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32) += A (64 x 16, registers) * B (16 x 32, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128) += A (64 x 16, registers) * B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256) += A (64 x 16, registers) * B (16 x 256, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 32) {
    wgmma_rs_n32(o, a, db);
  } else if constexpr (HD == 64) {
    wgmma_rs_n64(o, a, db);
  } else if constexpr (HD == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n256(o, a, db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Grid (Hq, query tiles of kBQ rows, B), longest tiles first.  Scores are
// kept in log2 units: x = s * scale * log2(e) (or the softcapped score
// times log2(e)), p = exp2(x - m).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, long long ob, long long oh,
                   long long os, int group, int Sq, int Skv, float scale,
                   int causal, int window, float softcap) {
  using C = Tile<HD>;
  extern __shared__ uint8_t smem[];
  const uint32_t sQ = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sK = sQ + kConsumers * C::kBytes;
  const uint32_t sV = sK + C::kStages * C::kBytes;
  const uint32_t q_full = sV + C::kStages * C::kBytes;
  const uint32_t full = q_full + 8;                 // + 8 * stage
  const uint32_t empty = full + 8 * C::kStages;     // + 8 * stage

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
    for (int s = 0; s < C::kStages; ++s) {
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
        const int s = i % C::kStages;
        if (i >= C::kStages) mbar_wait(empty + 8 * s, (i / C::kStages - 1) & 1);
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
    constexpr uint32_t kSBO = 8 * C::kSwizzle;      // 8 rows of a chunk

    float acc[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % C::kStages;
      const int kt = k_begin + i * kBK;
      mbar_wait(full + 8 * s, (i / C::kStages) & 1);
      const bool live = wq_lo < Sq && (!causal || kt <= wpos_hi) &&
                        (!window || wpos_lo - (kt + kBK - 1) < window);
      if (live) {
        // S = Q K^T (64 x 64), K-major operands, hd / 16 steps of 16
        float sc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = 0.f;
        const uint32_t sKs = sK + s * C::kBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk * 16 / C::kCols) * C::kChunkBytes +
                               (kk * 16 % C::kCols) * 2;
          wgmma_ss_n64(sc, desc(sQw + off, 16, kSBO, C::kLayout),
                       desc(sKs + off, 16, kSBO, C::kLayout), kk > 0);
        }
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
#pragma unroll
        for (int e = 0; e < HD / 2; ++e) acc[e] *= (e & 2) ? corr1 : corr0;

        // O += P V, V MN-major: 16 keys a step, hd wide
        const uint32_t sVs = sV + s * C::kBytes;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j) {
          wgmma_pv<HD>(acc, pa[j],
                       desc(sVs + j * 16 * C::kSwizzle, C::kChunkBytes, kSBO,
                            C::kLayout));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (hd, S, H, B) map of a bf16 (B, H, S, hd) tensor with element strides
// st = (batch, head, seq), boxes of (cols, 64, 1, 1); rows past S read 0.
bool make_map(CUtensorMap* map, const void* ptr, int hd, long long S,
              long long H, long long B, const long long* st, int cols,
              CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int Hq, int Hkv, int Sq, int Skv,
           float scale, int causal, int window, float softcap,
           cudaStream_t s) {
  using C = Tile<HD>;
  const CUtensorMapSwizzle sw = C::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                   : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap qm, km, vm;
  if (!encoder()) return (int)cudaErrorNotSupported;
  if (!make_map(&qm, q, HD, Sq, Hq, B, st, C::kCols, sw) ||
      !make_map(&km, k, HD, Skv, Hkv, B, st + 3, C::kCols, sw) ||
      !make_map(&vm, v, HD, Skv, Hkv, B, st + 6, C::kCols, sw)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kern = flash_fwd_bf16<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hq, (Sq + kBQ - 1) / kBQ, B);
  kern<<<grid, kThreads, C::kSmem, s>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11],
      Hq / Hkv, Sq, Skv, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, hd), k/v (B, Hkv, Skv, hd), o like q, all bf16, each
// addressed by the 12 element strides in `strides` (q, k, v, o; batch,
// head, seq); hd in {32, 64, 128, 256} is contiguous; every pointer and
// stride is a multiple of 16 bytes.  Returns a cudaError_t code (0 on
// success).
int flash_attention_bf16_fwd(const void* q, const void* k, const void* v,
                             void* o, const long long* strides, int B, int Hq,
                             int Hkv, int Sq, int Skv, int hd, float scale,
                             int causal, int window, float softcap,
                             void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv < Sq) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, strides, B, Hq, Hkv, Sq, Skv, scale,
                        causal, window, softcap, s);
    case 64:
      return launch<64>(q, k, v, o, strides, B, Hq, Hkv, Sq, Skv, scale,
                        causal, window, softcap, s);
    case 128:
      return launch<128>(q, k, v, o, strides, B, Hq, Hkv, Sq, Skv, scale,
                         causal, window, softcap, s);
    case 256:
      return launch<256>(q, k, v, o, strides, B, Hq, Hkv, Sq, Skv, scale,
                         causal, window, softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
