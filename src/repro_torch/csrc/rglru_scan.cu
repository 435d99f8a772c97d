// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rglru_scan.py, function rglru_scan (the
// Pallas kernel: grid (B, w/bw, S/bs), time innermost and sequential, the
// f32 carry in VMEM scratch, an associative scan inside each time block).
//
// Contract (src/repro/kernels/ref.py rglru_scan): a, b (B, S, w) of one
// dtype (f32 or bf16), h_0 = 0, the carry in f32, h_t = a_t * h_{t-1} +
// b_t with the product rounded before the sum (as the plain version's two
// separate operations round), the output (B, S, w) in a's dtype.
//
// Design: one thread per (batch, channel), sequential over time.
// Neighbouring threads take neighbouring channels, so every load and
// store of a warp is one contiguous run.  The time loop runs in chunks of
// kUnroll steps: the next chunk's a and b loads are issued before the
// current chunk's chain of dependent multiply-adds, so their latency hides
// behind it.
//
// Bound on this card: bytes.  The function reads a and b and writes h
// once each: 3 * B * S * w * itemsize, 251.7 MB at the RecurrentGemma-2B
// prefill shape (2, 4096, 2560) in f32, 0.075 ms at 3.35 TB/s.  With one
// thread per channel that shape has only 5,120 threads, so this kernel is
// latency-bound: what keeps bytes in flight is the unrolled prefetch.  A
// two-pass chunked scan (chunk carries, then a fix-up) would spread time
// across more threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // one warp per block: spread over every SM
constexpr int kUnroll = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           long long t0, int S, int w,
                                           float* av, float* bv) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (t0 + u < S) {
      av[u] = to_f32(a[(t0 + u) * w]);
      bv[u] = to_f32(b[(t0 + u) * w]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ h, int B, int S, int w) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)B * w) return;
  const long long base = (idx / w) * S * w + idx % w;
  a += base;
  b += base;
  h += base;
  float av[kUnroll], bv[kUnroll], an[kUnroll], bn[kUnroll];
  load_chunk(a, b, 0, S, w, av, bv);
  float carry = 0.f;
  for (long long t0 = 0; t0 < S; t0 += kUnroll) {
    if (t0 + kUnroll < S) load_chunk(a, b, t0 + kUnroll, S, w, an, bn);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
        store(h + (t0 + u) * w, carry);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = an[u];
      bv[u] = bn[u];
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* h, int B, int S, int w,
           cudaStream_t s) {
  const long long blocks = ((long long)B * w + kThreads - 1) / kThreads;
  rglru_scan_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      B, S, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b, h: contiguous (B, S, w), all f32 (bf16 == 0) or all bf16.
// Returns a cudaError_t code (0 on success).
int rglru_scan(const void* a, const void* b, void* h, int B, int S, int w,
               int bf16, void* stream) {
  if (B <= 0 || S <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(a, b, h, B, S, w, s);
  return launch<float>(a, b, h, B, S, w, s);
}

}  // extern "C"
