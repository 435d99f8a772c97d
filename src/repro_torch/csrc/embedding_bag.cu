// Embedding-bag forward (gather + sum-pool) and its backward (scatter-add)
// for Hopper (sm_90a), over all of a model's tables in one launch each
// (one per group of 64 tables).
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
// Any width and alignment: where a table's rows are not whole 16-byte
// chunks or do not start 16-byte aligned (f32 with d = 3, bf16 with
// d = 4, a view that starts mid-row; for the backward, an output gradient
// whose rows are not whole aligned float4s), the launcher is told so and
// both kernels take one element a thread instead of one chunk, with the
// same sums in the same order.  The host side picks the path from the
// shapes and pointers.
//
// Any number of tables: more than kMaxTables go in groups of kMaxTables,
// one launch a group (the DLRM path's 26 tables are one group).
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

// The (bag, table-in-group, unit) of thread t, where a unit is a 16-byte
// chunk (vector path) or one element: bag = b * n_tables + t0 + g.
struct Place {
  long long bag;
  int g, unit;
};
__device__ __forceinline__ Place place(long long t, int per_row, int n_group,
                                       int n_tables, int t0) {
  const long long q = t / per_row;            // b * n_group + g
  const int g = (int)(q % n_group);
  return {(q / n_group) * n_tables + t0 + g, g, (int)(t % per_row)};
}

// Forward.  VEC: one thread per 16-byte chunk of an output row, rows read
// and written as uint4; else one thread per element.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    embedding_bags_fwd(const Tables tabs, const int32_t* __restrict__ idx,
                       T* __restrict__ out, int batch, int n_tables, int t0,
                       int n_group, int hot, int per_row) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;  // values a thread sums
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * n_group * per_row) return;
  const Place at = place(t, per_row, n_group, n_tables, t0);
  const long long n_rows = tabs.rows[at.g];
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  const int32_t* ids = idx + at.bag * hot;
  for (int j = 0; j < hot; ++j) {
    const long long id = ids[j];
    if (id < 0 || id >= n_rows) continue;
    if (VEC) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(tabs.ptr[at.g]) +
                              id * per_row + at.unit);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] += to_f32(v[k]);
    } else {
      acc[0] += to_f32(__ldg(static_cast<const T*>(tabs.ptr[at.g]) +
                             id * per_row + at.unit));
    }
  }
  if (VEC) {
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = from_f32<T>(acc[k]);
    reinterpret_cast<uint4*>(out)[at.bag * per_row + at.unit] = packed;
  } else {
    out[at.bag * per_row + at.unit] = from_f32<T>(acc[0]);
  }
}

// Backward.  VEC: one thread per (lookup, 4-float chunk), grad_out rows
// read as float4; else one thread per (lookup, element), read through the
// element stride gs_elem.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    embedding_bags_bwd(const float* __restrict__ grad_out, long long gs_bag,
                       long long gs_table, long long gs_elem,
                       const int32_t* __restrict__ idx, const Tables grads,
                       int batch, int n_tables, int t0, int n_group, int hot,
                       int d) {
  const int per_row = VEC ? d / 4 : d;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * n_group * hot * per_row) return;
  const int unit = (int)(t % per_row);
  const long long q = t / per_row;            // (b * n_group + g) * hot + j
  const int j = (int)(q % hot);
  const Place at = place(q / hot, 1, n_group, n_tables, t0);
  const long long id = idx[at.bag * hot + j];
  if (id < 0 || id >= grads.rows[at.g]) return;
  const long long b = at.bag / n_tables;
  const int table = t0 + at.g;
  const float* src = grad_out + b * gs_bag + table * gs_table;
  float* dst = static_cast<float*>(const_cast<void*>(grads.ptr[at.g])) +
               id * d;
  if (VEC) {
    const float4 g = *reinterpret_cast<const float4*>(src + unit * 4);
    atomicAdd(dst + unit * 4 + 0, g.x);
    atomicAdd(dst + unit * 4 + 1, g.y);
    atomicAdd(dst + unit * 4 + 2, g.z);
    atomicAdd(dst + unit * 4 + 3, g.w);
  } else {
    atomicAdd(dst + unit, src[unit * gs_elem]);
  }
}

void fill(Tables* tabs, const long long* ptrs, const long long* rows,
          int n) {
  for (int i = 0; i < n; ++i) {
    tabs->ptr[i] = reinterpret_cast<const void*>(ptrs[i]);
    tabs->rows[i] = rows[i];
  }
}

unsigned blocks_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

template <typename T, bool VEC>
void launch_fwd(const Tables& tabs, const void* idx, void* out, int batch,
                int n_tables, int t0, int n_group, int hot, int per_row,
                cudaStream_t s) {
  const long long total = (long long)batch * n_group * per_row;
  if (total > 0)
    embedding_bags_fwd<T, VEC><<<blocks_for(total), kThreads, 0, s>>>(
        tabs, static_cast<const int32_t*>(idx), static_cast<T*>(out), batch,
        n_tables, t0, n_group, hot, per_row);
}

}  // namespace

extern "C" {

// n_tables tables (ptrs[i], rows[i] x d), one dtype (bf16 != 0: bf16, else
// f32); idx (batch, T, hot) int32 contiguous -> out (batch, T, d)
// contiguous, f32 sums stored in the tables' dtype.  vec != 0: every row
// is whole 16-byte chunks, 16-byte aligned (the caller checked); else the
// element path.  One launch per group of kMaxTables tables.
// Returns a cudaError_t code (0 on success).
int embedding_bags_fwd_launch(const long long* ptrs, const long long* rows,
                              int n_tables, const void* idx, void* out,
                              int batch, int hot, int d, int bf16, int vec,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_row = vec ? d * (bf16 ? 2 : 4) / 16 : d;
  for (int t0 = 0; t0 < n_tables; t0 += kMaxTables) {
    const int n_group = n_tables - t0 < kMaxTables ? n_tables - t0
                                                   : kMaxTables;
    Tables tabs;
    fill(&tabs, ptrs + t0, rows + t0, n_group);
    if (bf16 && vec)
      launch_fwd<__nv_bfloat16, true>(tabs, idx, out, batch, n_tables, t0,
                                      n_group, hot, per_row, s);
    else if (bf16)
      launch_fwd<__nv_bfloat16, false>(tabs, idx, out, batch, n_tables, t0,
                                       n_group, hot, per_row, s);
    else if (vec)
      launch_fwd<float, true>(tabs, idx, out, batch, n_tables, t0, n_group,
                              hot, per_row, s);
    else
      launch_fwd<float, false>(tabs, idx, out, batch, n_tables, t0, n_group,
                               hot, per_row, s);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// grad_out (batch, T, d) f32, element strides (gs_bag, gs_table, gs_elem);
// idx (batch, T, hot) int32 contiguous; adds into the T dense f32
// gradients (ptrs[i], rows[i] x d), which the caller zeroed.  vec != 0:
// d % 4 == 0, gs_elem == 1 and every grad_out row a whole aligned float4
// run (the caller checked); else the element path.  One launch per group
// of kMaxTables tables.
int embedding_bags_bwd_launch(const void* grad_out, long long gs_bag,
                              long long gs_table, long long gs_elem,
                              const void* idx, const long long* ptrs,
                              const long long* rows, int n_tables, int batch,
                              int hot, int d, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_row = vec ? d / 4 : d;
  for (int t0 = 0; t0 < n_tables; t0 += kMaxTables) {
    const int n_group = n_tables - t0 < kMaxTables ? n_tables - t0
                                                   : kMaxTables;
    Tables grads;
    fill(&grads, ptrs + t0, rows + t0, n_group);
    const long long total = (long long)batch * n_group * hot * per_row;
    if (total > 0) {
      const float* g = static_cast<const float*>(grad_out);
      const int32_t* ids = static_cast<const int32_t*>(idx);
      if (vec)
        embedding_bags_bwd<true><<<blocks_for(total), kThreads, 0, s>>>(
            g, gs_bag, gs_table, gs_elem, ids, grads, batch, n_tables, t0,
            n_group, hot, d);
      else
        embedding_bags_bwd<false><<<blocks_for(total), kThreads, 0, s>>>(
            g, gs_bag, gs_table, gs_elem, ids, grads, batch, n_tables, t0,
            n_group, hot, d);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
