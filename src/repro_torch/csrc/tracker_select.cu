// Fused CPR-MFU counter update + segment-wise top-k row selection for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/tracker_select.py, function tracker_select
// (the Pallas kernel; one grid step per segment that histograms the
// pending ids against its row range, runs k argmax rounds, and writes
// back the counters with the picks cleared).
//
// Two launches here:
//   (a) fold: one thread per pending id, atomicAdd into the counters;
//       ids outside [0, N) match nothing.  Skipped when no ids are pending
//       (the emulator folds counts in its train step).
//   (b) select: one block per segment loads its `seg` counters into
//       shared memory (the last segment's padding rows count -1), runs `k`
//       rounds of a block argmax whose ties go to the lowest row, writes
//       the segment's k global row ids, and writes the counters back with
//       the picked rows cleared.
//
// Bound on this card: bytes.  The function must read and write N*4 bytes
// of counters and write n_seg*k*4 bytes of ids (40.5 MB + 40.5 MB + 5 MB
// for the largest Kaggle table).  The k rounds run on shared memory, so
// device memory sees each counter once in each direction (twice more
// when pending ids force a copy before the fold).  The k sequential
// block reductions are the kernel's own cost; a later version could keep
// the top-k in registers per warp.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kSelectThreads = 256;
constexpr int kFoldThreads = 256;

__global__ void tracker_fold_kernel(int32_t* __restrict__ counts,
                                    const int32_t* __restrict__ ids,
                                    long long n_ids, long long n_rows) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_ids) return;
  long long id = ids[t];
  if (id >= 0 && id < n_rows) atomicAdd(counts + id, 1);
}

// (value, position) argmax with ties to the lower position.
__device__ __forceinline__ void better(int& v, int& p, int ov, int op) {
  if (ov > v || (ov == v && op < p)) { v = ov; p = op; }
}

// counts_in and counts_out may alias (in-place select after a fold).
__global__ void tracker_select_kernel(const int32_t* counts_in,
                                      int32_t* counts_out,
                                      int32_t* __restrict__ out_ids,
                                      long long n_rows, int seg, int k) {
  extern __shared__ int32_t work[];          // seg counters of this segment
  __shared__ int warp_v[kSelectThreads / 32];
  __shared__ int warp_p[kSelectThreads / 32];
  const long long lo = (long long)blockIdx.x * seg;
  for (int i = threadIdx.x; i < seg; i += blockDim.x) {
    long long row = lo + i;
    work[i] = row < n_rows ? counts_in[row] : -1;   // padding rows: -1
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int j = 0; j < k; ++j) {
    int v = INT_MIN, p = INT_MAX;
    for (int i = threadIdx.x; i < seg; i += blockDim.x) better(v, p, work[i], i);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      int ov = __shfl_down_sync(0xffffffffu, v, off);
      int op = __shfl_down_sync(0xffffffffu, p, off);
      better(v, p, ov, op);
    }
    if (lane == 0) { warp_v[wid] = v; warp_p[wid] = p; }
    __syncthreads();
    if (threadIdx.x == 0) {
      int bv = warp_v[0], bp = warp_p[0];
      for (int w = 1; w < kSelectThreads / 32; ++w) better(bv, bp, warp_v[w], warp_p[w]);
      out_ids[(long long)blockIdx.x * k + j] = (int32_t)(lo + bp);
      work[bp] = INT_MIN;                    // picked: below every count
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < seg; i += blockDim.x) {
    long long row = lo + i;
    if (row < n_rows) counts_out[row] = work[i] == INT_MIN ? 0 : counts_in[row];
  }
}

}  // namespace

extern "C" {

// counts (n_rows,) i32 -> new_counts (n_rows,) i32 and ids (n_seg*k,) i32.
// pending (n_pending,) i32 ids are folded in first (may be 0 long).
// 1 <= k <= seg; seg*4 bytes of shared memory per block.
int tracker_select(const void* counts, const void* pending, long long n_pending,
                   void* new_counts, void* ids, long long n_rows, int seg,
                   int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long n_seg = (n_rows + seg - 1) / seg;
  const int32_t* src = (const int32_t*)counts;
  if (n_pending > 0) {
    // the fold must not touch the caller's counters: fold into the output
    // and select in place from there (each block owns its segment)
    cudaMemcpyAsync(new_counts, counts, n_rows * sizeof(int32_t),
                    cudaMemcpyDeviceToDevice, s);
    unsigned blocks = (unsigned)((n_pending + kFoldThreads - 1) / kFoldThreads);
    tracker_fold_kernel<<<blocks, kFoldThreads, 0, s>>>(
        (int32_t*)new_counts, (const int32_t*)pending, n_pending, n_rows);
    src = (const int32_t*)new_counts;
  }
  if (n_seg > 0) {
    tracker_select_kernel<<<(unsigned)n_seg, kSelectThreads,
                            seg * sizeof(int32_t), s>>>(
        src, (int32_t*)new_counts, (int32_t*)ids, n_rows, seg, k);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
