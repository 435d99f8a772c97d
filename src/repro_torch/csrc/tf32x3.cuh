// f32-accurate matrix products on Hopper's tensor cores (3xTF32), shared
// by the f32 attention kernels (flash_attention.cu,
// flash_attention_backward.cu): warp-level mma.sync m16n8k8 on TF32 with
// f32 accumulators, f32 tiles in shared memory, cp.async copies.  Each
// including source is its own library, so everything here has internal
// linkage.
//
// 3xTF32 (CUTLASS's OpMultiplyAddFastF32): each f32 operand x is split in
// registers as it is loaded into hi = x rounded to TF32 (cvt.rna, 11
// significant bits) and lo = x - hi (exact in f32; the tensor core reads
// its top 11 bits).  a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi: the missing
// a_lo.b_lo and the cut of lo are ~2^-22 of the product, and each TF32
// product is exact in f32, so a product keeps ~21-22 bits against f32's
// 24 (one TF32 product alone keeps ~11).  Sums stay f32.
//
// Fragments of mma.m16n8k8 (g = lane / 4, t = lane % 4; PTX ISA):
//   A 16x8 (row-major):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                        a3 (g + 8, t + 4)
//   B 8x8 (k x n):       b0 (t, g), b1 (t + 4, g)
//   C 16x8:              c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                        c3 (g + 8, 2t + 1)
// A product's contraction index k may be permuted as long as A and B
// agree.  Here the k-step's logical k = t and t + 4 are the physical
// columns 2t and 2t + 1: then a0/a2 (and b0/b1 of a row-stored B) are one
// 8-byte load, and an accumulator's (2t, 2t + 1) pair is, as it stands,
// the A fragment of a product that contracts over those columns (P.V, dS.K,
// P^T.dO, dS^T.Q: no shuffle), with the B rows 2t and 2t + 1.
//
// The split rounds in integer ops ((bits + 0x1000) & ~0x1fff: nearest,
// ties away, cvt.rna's rule without its infinity test, which the compiler
// emits as five instructions) and takes lo with one f32 subtraction.
//
// Shared-memory tiles: rows x HD f32 at a padded row pitch, so that every
// fragment load is an immediate offset from a pointer a thread computes
// once.  A pitch of HD + 8 words (8 mod 32) makes the 8-byte loads along a
// row (rows g, columns 2t) hit 32 distinct banks; HD + 4 (4 mod 32) does
// so for the 4-byte loads down a column (rows 2t and 2t + 1, column g).  A
// tile read both ways takes HD + 8, and its column loads two wavefronts.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

template <int HD>
constexpr int kPitchRows = HD + 8;   // tiles read along rows
template <int HD>
constexpr int kPitchCols = HD + 4;   // tiles read only down columns

// x -> (hi, lo): hi rounded to TF32, lo = x - hi
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

struct FragA {  // a 16x8 A fragment, split
  uint32_t hi[4], lo[4];
};
struct FragB {  // an 8x8 B fragment, split
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// A of the k-step at column c, from p = &tile[r0 + g][2t] (pitch LD): rows
// r0.. r0 + 15
template <int LD>
__device__ __forceinline__ FragA frag_a(const float* p, int c) {
  const float2 x = *reinterpret_cast<const float2*>(p + c);
  const float2 y = *reinterpret_cast<const float2*>(p + 8 * LD + c);
  return split_a(x.x, y.x, x.y, y.y);
}

// B[k][n] = tile[n0 + n][c + k], from p = &tile[n0 + g][2t]: a product
// that contracts over the tile's columns (Q.K^T: K's rows are the n)
__device__ __forceinline__ FragB frag_b_rows(const float* p, int c) {
  const float2 x = *reinterpret_cast<const float2*>(p + c);
  return split_b(x.x, x.y);
}

// B[k][n] = tile[k0 + k][n0 + n], from p = &tile[2t][g] (pitch LD): a
// product that contracts over the tile's rows (P.V: V's rows are the k),
// rows k0 + 2t and k0 + 2t + 1
template <int LD>
__device__ __forceinline__ FragB frag_b_cols(const float* p, int k0, int n0) {
  return split_b(p[k0 * LD + n0], p[(k0 + 1) * LD + n0]);
}

// The A fragment of the accumulator tile c (16 x 8, rows g / g + 8,
// columns 2t / 2t + 1) contracted over its columns
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// ---------------------------------------------------------------------
// cp.async: 16- and 4-byte copies global -> shared, zero-filled past
// the data
// ---------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x HD f32 from src (row stride `stride` elements, 16-byte aligned)
// into a tile of pitch LD; rows at or past `valid` read as zeros.  The
// caller commits.
template <int HD, int LD, int THREADS>
__device__ __forceinline__ void load_tile_async(float* dst, const float* src,
                                                long long stride, int rows,
                                                int valid) {
  constexpr int kPerRow = HD / 4;
  for (int i = threadIdx.x; i < rows * kPerRow; i += THREADS) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, ok ? src + r * stride + c : src, ok);
  }
}

// named barriers: `threads` threads (a multiple of 32) of the CTA meet
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// cudaFuncSetAttribute(Kernel, max dynamic shared memory) once a device
// and kernel: a call on the host path of every launch costs microseconds
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static bool done[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

}  // namespace
