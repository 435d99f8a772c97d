// Embedding-bag forward (gather + sum-pool) and its backward (scatter-add)
// for Hopper (sm_90a), over all of a model's tables in one launch each.
//
// Replaces: src/repro/kernels/embedding_bag.py, function embedding_bag
// (the Pallas kernel, forward only, one table per call).  The backward
// replaces the gradient XLA derives for jnp.sum(table[idx], 1)
// (src/repro/models/dlrm.py:82): a dense (N_t, d) gradient per table,
// zero where a row was not looked up.
//
// Bound on this card: bytes.  The forward reads B*T*hot rows of d values
// and B*T*hot ids and writes B*T rows; at the DLRM path's shape (26
// Criteo-Kaggle tables, B = 512, hot = 1, d = 16, f32) that is about
// 1.7 MB, half a microsecond of HBM time.  One launch per table made the
// step pay 26 launches and 26 wrapper calls on the host for that work, so
// both kernels take every table at once: the tables' pointers and row
// counts go by value in the kernel's parameters (Tables, at most
// kMaxTables, 16 bytes a table), with no host-to-device copy and nothing
// cached across calls (the optimizer rebinds the tables every step).
//
// Forward: one thread per (bag, table, 16-byte chunk of the output row):
// a row is read with full-width vector loads (float4 for f32, 8 bf16) and
// summed over `hot` in f32 in registers; neighbouring threads write
// neighbouring chunks of the (B, T, d) output.
//
// Backward: one thread per (bag, table, lookup, 4-float chunk) atomically
// adds the output gradient into its table's dense f32 gradient, which the
// wrapper zeroed.  grad_out is read in place through its (bag, table)
// strides.  Ids repeat under Zipf traffic, so the order of the atomic
// adds, and with it the last bits of a row's gradient, varies from run to
// run.
//
// Ids outside [0, N_t) contribute nothing (forward and backward).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxTables = 64;
constexpr int kThreads = 256;

// by value in the kernel's parameter space: 16 bytes a table
struct Tables {
  const void* ptr[kMaxTables];
  long long rows[kMaxTables];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One thread per (bag, table, 16-byte chunk of the output row).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    embedding_bags_fwd(const Tables tabs, const int32_t* __restrict__ idx,
                       T* __restrict__ out, int batch, int n_tables, int hot,
                       int chunks) {
  constexpr int VEC = 16 / sizeof(T);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * n_tables * chunks) return;
  const long long bag = t / chunks;           // b * n_tables + table
  const int c = (int)(t % chunks);
  const int table = (int)(bag % n_tables);
  const uint4* rows = reinterpret_cast<const uint4*>(tabs.ptr[table]);
  const long long n_rows = tabs.rows[table];
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  const int32_t* ids = idx + bag * hot;
  for (int j = 0; j < hot; ++j) {
    const long long id = ids[j];
    if (id < 0 || id >= n_rows) continue;
    const uint4 raw = __ldg(rows + id * chunks + c);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] += to_f32(v[k]);
  }
  uint4 packed;
  T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
  for (int k = 0; k < VEC; ++k) o[k] = from_f32<T>(acc[k]);
  reinterpret_cast<uint4*>(out)[t] = packed;
}

// One thread per (bag, table, lookup, 4-float chunk of the f32 gradient).
__global__ void __launch_bounds__(kThreads)
    embedding_bags_bwd(const float* __restrict__ grad_out, long long gs_bag,
                       long long gs_table, const int32_t* __restrict__ idx,
                       const Tables grads, int batch, int n_tables, int hot,
                       int chunks) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long lookups = (long long)batch * n_tables * hot;
  if (t >= lookups * chunks) return;
  const long long lookup = t / chunks;        // (b * n_tables + table) * hot + j
  const int c = (int)(t % chunks);
  const long long bag = lookup / hot;
  const int table = (int)(bag % n_tables);
  const long long b = bag / n_tables;
  const long long id = idx[lookup];
  if (id < 0 || id >= grads.rows[table]) return;
  const float4 g = *reinterpret_cast<const float4*>(
      grad_out + b * gs_bag + table * gs_table + c * 4);
  float* dst = static_cast<float*>(const_cast<void*>(grads.ptr[table])) +
               (id * chunks + c) * 4;
  atomicAdd(dst + 0, g.x);
  atomicAdd(dst + 1, g.y);
  atomicAdd(dst + 2, g.z);
  atomicAdd(dst + 3, g.w);
}

bool fill(Tables* tabs, const long long* ptrs, const long long* rows,
          int n_tables) {
  if (n_tables < 1 || n_tables > kMaxTables) return false;
  for (int i = 0; i < n_tables; ++i) {
    tabs->ptr[i] = reinterpret_cast<const void*>(ptrs[i]);
    tabs->rows[i] = rows[i];
  }
  return true;
}

unsigned blocks_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// T = n_tables <= 64 tables (ptrs[i], rows[i] x d), one dtype (bf16 != 0:
// bf16, else f32), each row d values in whole 16-byte chunks, 16-byte
// aligned; idx (batch, T, hot) int32 contiguous -> out (batch, T, d)
// contiguous, f32 sums stored in the tables' dtype.
// Returns a cudaError_t code (0 on success).
int embedding_bags_fwd_launch(const long long* ptrs, const long long* rows,
                              int n_tables, const void* idx, void* out,
                              int batch, int hot, int d, int bf16,
                              void* stream) {
  Tables tabs;
  if (!fill(&tabs, ptrs, rows, n_tables)) return (int)cudaErrorInvalidValue;
  const int chunks = d * (bf16 ? 2 : 4) / 16;
  const long long total = (long long)batch * n_tables * chunks;
  if (total > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16) {
      embedding_bags_fwd<__nv_bfloat16><<<blocks_for(total), kThreads, 0, s>>>(
          tabs, static_cast<const int32_t*>(idx),
          static_cast<__nv_bfloat16*>(out), batch, n_tables, hot, chunks);
    } else {
      embedding_bags_fwd<float><<<blocks_for(total), kThreads, 0, s>>>(
          tabs, static_cast<const int32_t*>(idx), static_cast<float*>(out),
          batch, n_tables, hot, chunks);
    }
  }
  return (int)cudaGetLastError();
}

// grad_out (batch, T, d) f32, element strides (gs_bag, gs_table, 1), rows
// 16-byte aligned; idx (batch, T, hot) int32 contiguous; adds into the T
// dense f32 gradients (ptrs[i], rows[i] x d), which the caller zeroed.
// d must be a multiple of 4.
int embedding_bags_bwd_launch(const void* grad_out, long long gs_bag,
                              long long gs_table, const void* idx,
                              const long long* ptrs, const long long* rows,
                              int n_tables, int batch, int hot, int d,
                              void* stream) {
  Tables grads;
  if (!fill(&grads, ptrs, rows, n_tables)) return (int)cudaErrorInvalidValue;
  const int chunks = d / 4;
  const long long total = (long long)batch * n_tables * hot * chunks;
  if (total > 0) {
    embedding_bags_bwd<<<blocks_for(total), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(grad_out), gs_bag, gs_table,
        static_cast<const int32_t*>(idx), grads, batch, n_tables, hot,
        chunks);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
