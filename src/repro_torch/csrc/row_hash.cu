// Per-row 64-bit FNV-1a over (value row, accumulator row) bytes, for
// Hopper (sm_90a).  The delta-save hash of the sharded writer fleet.
//
// Replaces: src/repro/kernels/row_hash.py, function row_hash (the Pallas
// kernel: one grid step per block of rows folds a host-staged (n, m)
// uint64 word matrix, m words per row).
//
// Contract (src/repro/kernels/ref.py rows_to_words + row_hash): each row's
// value bytes, then its accumulator bytes, each part zero-padded to a
// multiple of 8 bytes and read as little-endian 64-bit words w; from the
// offset basis 14695981039346656037, h = (h ^ w) * 1099511628211 (mod
// 2^64) for every word in order.  The result is the uint64 bits in an
// int64 output.
//
// Design: one thread per row, reading both parts straight from the
// tables' device memory (no staged word matrix).  A part whose row is `b`
// bytes folds ceil(b/8) words; the last word carries zeros beyond byte b.
// Loads are as wide as the row's alignment allows: 8-byte words when the
// row length and base are multiples of 8 (f32 d=16: 64 bytes), else
// 4-byte halves (the f32 accumulator: one 4-byte load, zeros high; f32
// d=9: 36 bytes), else 2-byte or single bytes.
//
// Bound on this card: bytes.  The function must read n*(b_values +
// b_accs) bytes and write 8n; for the largest Kaggle table that is
// 10,131,227 * (64 + 4 + 8) = 770 MB.  One thread per row strides 64
// bytes between neighbouring threads, so a warp's loads of one word touch
// 32 different 64-byte segments; the other words of the row follow in
// the same sectors, which L1/L2 serve.  A later version could stage rows
// through shared memory with coalesced 16-byte loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kOffset = 14695981039346656037ull;
constexpr unsigned long long kPrime = 1099511628211ull;

// Fold one part of one row: `b` bytes at `p`, read in units of U bytes
// (b % U == 0 and p is U-aligned), U * (8 / U) = 8 bytes per word.
template <int U>
__device__ __forceinline__ unsigned long long fold(
    unsigned long long h, const unsigned char* __restrict__ p, long long b) {
  using T = typename std::conditional<
      U == 8, unsigned long long,
      typename std::conditional<
          U == 4, unsigned int,
          typename std::conditional<U == 2, unsigned short,
                                    unsigned char>::type>::type>::type;
  const T* q = reinterpret_cast<const T*>(p);
  const long long units = b / U;
  constexpr int per_word = 8 / U;
  for (long long u0 = 0; u0 < units; u0 += per_word) {
    unsigned long long w = 0;
#pragma unroll
    for (int k = 0; k < per_word; ++k) {
      if (u0 + k < units) {
        w |= (unsigned long long)q[u0 + k] << (8 * U * k);
      }
    }
    h = (h ^ w) * kPrime;
  }
  return h;
}

__device__ __forceinline__ unsigned long long fold_any(
    unsigned long long h, const unsigned char* p, long long b, int unit) {
  switch (unit) {
    case 8: return fold<8>(h, p, b);
    case 4: return fold<4>(h, p, b);
    case 2: return fold<2>(h, p, b);
    default: return fold<1>(h, p, b);
  }
}

__global__ void row_hash_kernel(const unsigned char* __restrict__ values,
                                long long vb, int vu,
                                const unsigned char* __restrict__ accs,
                                long long ab, int au, long long n,
                                long long* __restrict__ out) {
  long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  unsigned long long h = kOffset;
  if (vb) h = fold_any(h, values + row * vb, vb, vu);
  if (ab) h = fold_any(h, accs + row * ab, ab, au);
  out[row] = (long long)h;
}

// Widest load unit that divides the row length and the base address.
int load_unit(const void* p, long long b) {
  uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int u = 8; u > 1; u /= 2) {
    if (b % u == 0 && a % u == 0) return u;
  }
  return 1;
}

}  // namespace

extern "C" {

// values: n rows of vb bytes; accs: n rows of ab bytes (either may be
// 0 bytes, then its pointer is not read); out: n int64.  Returns a
// cudaError_t code (0 on success).
int row_hash(const void* values, long long vb, const void* accs,
             long long ab, long long n, void* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vu = vb ? load_unit(values, vb) : 1;
  const int au = ab ? load_unit(accs, ab) : 1;
  const long long blocks = (n + kThreads - 1) / kThreads;
  row_hash_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const unsigned char*>(values), vb, vu,
      static_cast<const unsigned char*>(accs), ab, au, n,
      static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
