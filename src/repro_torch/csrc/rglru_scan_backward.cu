// Gradient of the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t for
// Hopper (sm_90a).
//
// Replaces: the gradient XLA derives for the reference's jnp scan
// (src/repro/models/rglru.py, rglru_scan, an associative scan); the
// reference's Pallas kernel (src/repro/kernels/rglru_scan.py) is forward
// only, and the reference trains through the jnp scan.
//
// Contract (src/repro_torch/kernels/ref.py rglru_scan_backward): a, h, dh
// (B, S, w), contiguous, one dtype (f32 or bf16); h is the forward's
// output, dh its gradient.  One reverse f32 chain per (batch, channel):
//     g_t = dh_t + a_{t+1} * g_{t+1}   (g_{S+1} = 0)
//     db_t = g_t,   da_t = g_t * h_{t-1}   (h_0 = 0)
// with the product rounded before the sum (no contraction into an FMA),
// as the plain version's separate operations round, so da and db (in a's
// dtype) equal it bit for bit.
//
// Bound on this card: bytes.  The function reads a, h and dh and writes da
// and db once each: 5 * B * S * w * itemsize, 210 MB at the training
// shape (8, 512, 2560) in f32, 0.063 ms at 3.35 TB/s.  Every step of a
// chain depends on the one before, so what sets the time is how many
// loads are in flight while the chains run.
//
// Design: one thread a chain, walking t from S - 1 down to 0; a warp's 32
// threads are 32 adjacent channels of one batch row, so every load and
// store is one contiguous 128-byte (f32) line.  The loop runs in groups
// of kGroup steps: the next group's a, h and dh are loaded into registers
// before the current group's chain steps run, so a group's loads are in
// flight behind the previous group's arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 16;      // chain steps whose loads are issued at once
constexpr int kThreads = 32;    // chains a block: one warp, so that B * w /
                                // 32 blocks spread over every SM even at B = 2

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Loads of group `t_hi` (steps t_hi, t_hi - 1, ..., down to t_hi - kGroup
// + 1, those below 0 skipped): a_t, h_{t-1} (none at t = 0) and dh_t.
template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ a,
                                           const T* __restrict__ h,
                                           const T* __restrict__ dh,
                                           long long base, int t_hi, int w,
                                           float* xa, float* xh, float* xd) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int t = t_hi - u;
    if (t >= 0) {
      const long long o = base + (long long)t * w;
      xa[u] = to_f32(a[o]);
      xd[u] = to_f32(dh[o]);
      if (t > 0) xh[u] = to_f32(h[o - w]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                          const T* __restrict__ dh, T* __restrict__ da,
                          T* __restrict__ db, int S, int w, int blocks_row) {
  const int batch = blockIdx.x / blocks_row;
  const int c = (blockIdx.x - batch * blocks_row) * kThreads + threadIdx.x;
  if (c >= w) return;
  const long long base = (long long)batch * S * w + c;
  float g = 0.f;
  float a_next = 0.f;           // a_{t+1}; its product with g_{S+1} = 0 is 0
  float xa[kGroup] = {}, xh[kGroup] = {}, xd[kGroup] = {};
  float ya[kGroup] = {}, yh[kGroup] = {}, yd[kGroup] = {};
  load_group(a, h, dh, base, S - 1, w, xa, xh, xd);
#pragma unroll 1
  for (int t_hi = S - 1; t_hi >= 0; t_hi -= kGroup) {
    if (t_hi - kGroup >= 0)
      load_group(a, h, dh, base, t_hi - kGroup, w, ya, yh, yd);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int t = t_hi - u;
      if (t >= 0) {
        g = t == S - 1 ? xd[u] : __fadd_rn(__fmul_rn(a_next, g), xd[u]);
        const long long o = base + (long long)t * w;
        store(db + o, g);
        store(da + o, t > 0 ? __fmul_rn(g, xh[u]) : 0.f);
        a_next = xa[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      xa[u] = ya[u];
      xh[u] = yh[u];
      xd[u] = yd[u];
    }
  }
}

template <typename T>
int launch(const void* a, const void* h, const void* dh, void* da, void* db,
           int B, int S, int w, cudaStream_t s) {
  const int blocks_row = (w + kThreads - 1) / kThreads;
  const long long blocks = (long long)B * blocks_row;
  rglru_scan_bwd_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(dh), static_cast<T*>(da), static_cast<T*>(db), S,
      w, blocks_row);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a, h, dh, da, db: contiguous (B, S, w), all f32 (bf16 == 0) or all bf16.
// Returns a cudaError_t code (0 on success).  One launch.
int rglru_scan_backward(const void* a, const void* h, const void* dh,
                        void* da, void* db, int B, int S, int w, int bf16,
                        void* stream) {
  if (B <= 0 || S <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(a, h, dh, da, db, B, S, w, s);
  return launch<float>(a, h, dh, da, db, B, S, w, s);
}

}  // extern "C"
