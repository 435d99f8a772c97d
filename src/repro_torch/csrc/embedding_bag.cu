// Embedding-bag forward (gather + sum-pool) and its backward (scatter-add)
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/embedding_bag.py, function embedding_bag
// (the Pallas kernel, forward only).  The backward replaces the gradient
// XLA derives for jnp.sum(table[idx], 1) (src/repro/models/dlrm.py:82):
// a dense (N, d) table gradient, zero where a row was not looked up.
//
// Bound on this card: bytes.  The forward reads B*hot rows of d values
// and writes B rows; at the DLRM path's shape (B=512, hot=1, d=16, f32)
// that is about 66 KB per table, a few microseconds of HBM time, so a
// launch costs more than its traffic: the kernel is launch-bound.  Its
// design does the one thing that matters for the bytes it does move:
// each thread owns one 16-byte chunk of a row (float4 for f32, 8 bf16)
// so a row is read with full-width vector loads, and accumulates over
// `hot` in f32 in registers.  Fusing the 26 tables into one launch is
// the next step and is not done here.
//
// The backward is one thread per (lookup, 16-byte chunk of the f32
// gradient): it atomically adds the output gradient into the dense
// gradient the wrapper zeroed.  Ids repeat under Zipf traffic, so the
// order of the atomic adds, and with it the last bits of a row's
// gradient, varies from run to run.
//
// Ids outside [0, n_rows) contribute nothing (forward and backward).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One thread per (bag, 16-byte chunk of the output row).
template <typename T>
__global__ void embedding_bag_fwd_kernel(const T* __restrict__ table,
                                         const int32_t* __restrict__ idx,
                                         T* __restrict__ out,
                                         long long n_rows, int batch, int hot,
                                         int chunks) {
  constexpr int VEC = 16 / sizeof(T);
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * chunks) return;
  int b = (int)(t / chunks);
  int c = (int)(t % chunks);
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  const int32_t* bag = idx + (long long)b * hot;
  for (int j = 0; j < hot; ++j) {
    long long id = bag[j];
    if (id < 0 || id >= n_rows) continue;
    const uint4* row = reinterpret_cast<const uint4*>(table + id * (long long)chunks * VEC);
    uint4 raw = __ldg(row + c);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] += to_f32(v[k]);
  }
  uint4 packed;
  T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
  for (int k = 0; k < VEC; ++k) o[k] = from_f32<T>(acc[k]);
  reinterpret_cast<uint4*>(out + (long long)b * chunks * VEC)[c] = packed;
}

// One thread per (lookup, 4-float chunk of the f32 gradient row).
__global__ void embedding_bag_bwd_kernel(const float* __restrict__ grad_out,
                                         const int32_t* __restrict__ idx,
                                         float* __restrict__ grad_table,
                                         long long n_rows, int batch, int hot,
                                         int chunks) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long n_lookups = (long long)batch * hot;
  if (t >= n_lookups * chunks) return;
  long long lookup = t / chunks;
  int c = (int)(t % chunks);
  long long id = idx[lookup];
  if (id < 0 || id >= n_rows) return;
  long long b = lookup / hot;
  float4 g = reinterpret_cast<const float4*>(grad_out + b * chunks * 4)[c];
  float* dst = grad_table + id * (long long)chunks * 4 + c * 4;
  atomicAdd(dst + 0, g.x);
  atomicAdd(dst + 1, g.y);
  atomicAdd(dst + 2, g.z);
  atomicAdd(dst + 3, g.w);
}

constexpr int kThreads = 256;

template <typename T>
int launch_fwd(const void* table, const void* idx, void* out, long long n_rows,
               int batch, int hot, int d, void* stream) {
  int chunks = d * (int)sizeof(T) / 16;
  long long total = (long long)batch * chunks;
  if (total > 0) {
    unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    embedding_bag_fwd_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)table, (const int32_t*)idx, (T*)out, n_rows, batch, hot, chunks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table (n_rows, d) f32, idx (batch, hot) i32 -> out (batch, d) f32.
// d*4 must be a multiple of 16 and the pointers 16-byte aligned.
int embedding_bag_fwd_f32(const void* table, const void* idx, void* out,
                          long long n_rows, int batch, int hot, int d,
                          void* stream) {
  return launch_fwd<float>(table, idx, out, n_rows, batch, hot, d, stream);
}

// The same for bf16 tables: f32 accumulation, bf16 store.
int embedding_bag_fwd_bf16(const void* table, const void* idx, void* out,
                           long long n_rows, int batch, int hot, int d,
                           void* stream) {
  return launch_fwd<__nv_bfloat16>(table, idx, out, n_rows, batch, hot, d, stream);
}

// grad_out (batch, d) f32, idx (batch, hot) i32; adds into grad_table
// (n_rows, d) f32, which the caller zeroed.  d must be a multiple of 4.
int embedding_bag_bwd_f32(const void* grad_out, const void* idx,
                          void* grad_table, long long n_rows, int batch,
                          int hot, int d, void* stream) {
  int chunks = d / 4;
  long long total = (long long)batch * hot * chunks;
  if (total > 0) {
    unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    embedding_bag_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)grad_out, (const int32_t*)idx, (float*)grad_table,
        n_rows, batch, hot, chunks);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
