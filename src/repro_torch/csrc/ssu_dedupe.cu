// CPR-SSU reservoir update (dedupe + merge + random evict) for Hopper
// (sm_90a): multi-block and exact.
//
// Replaces: src/repro/kernels/ssu_dedupe.py, function ssu_dedupe_evict
// (the Pallas kernel: one block that sorts the whole union).  The TPU
// design assumed a reservoir of thousands of ids.  At full Criteo-Kaggle
// width the largest table's reservoir has rn = 1,266,403 slots, so the
// union cannot be sorted inside one block's 227 KB of shared memory.
// This version gets the same answer from what the reference body computes:
//
//   K1  one block: sort the nc candidates in shared memory (bitonic), drop
//       those found in the sorted reservoir (binary search), compact the
//       live ones (block scan) and place each at its merge-path rank in
//       `combined` (its rank among live candidates + the number of live
//       reservoir ids below it).  Counts the live entries; flags overflow.
//   K2  one thread per slot: place each live reservoir id at its merge rank
//       (its index + the number of live candidates below it) and fill the
//       tail of `combined` with EMPTY.  `combined` now equals the
//       reference's sort(concat(buf, cand)).
//   Without overflow (live <= rn) the answer is combined[:rn] (K6).
//   With overflow the rn smallest (score, position) keys survive, as the
//   reference's stable argsort keeps them:
//   K3  4 passes of an 8-bit radix select over the order-preserving bits
//       of each slot's score (EMPTY slots score +inf) find the rn-th
//       smallest score T and how many slots equal to T must be kept;
//   K4-K6  count the slots below T and equal to T per tile, scan the
//       tile counts, and compact the kept slots in position order.  Since
//       `combined` is sorted, position order is the sorted output.
//
// Bound on this card: bytes, and they depend on the case.  Without
// overflow (the steady state of a run) the answer reads the lb live ids
// of buf and cand (nc*4) and writes rn*4; the scores are never needed.
// With overflow it also reads the live slots' scores ((lb+lc)*4).  For the
// largest Kaggle table (rn = 1,266,403, nc = 256) that is about 7.6 MB
// (half-full reservoir, 2.3 us at 3.35 TB/s) or 15.2 MB (full, 4.5 us).
// This version moves `combined` and the scores several times (K2 write,
// 4 histogram passes, 2 compaction passes) and runs 14 small launches, so
// expect it well above the bound; without overflow K3-K5 exit at once.
//
// Preconditions (as the reference's): buf sorted ascending with EMPTY
// (INT32_MAX) padding at the end; scores finite; nc <= 8192.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int32_t kEmpty = INT_MAX;
constexpr int kThreads = 1024;                // blocks of K1, K4-K6
constexpr int kItems = 4;                     // slots per thread in K4/K6
constexpr int kTile = kThreads * kItems;
constexpr int kHistThreads = 256;
constexpr int kStateWords = 16;
constexpr int kHistWords = 4 * 256;

struct State {
  int32_t lb;          // live ids in buf
  int32_t lc;          // live candidates after the dedupe
  int32_t live;        // lb + lc
  int32_t overflow;    // live > rn
  uint32_t prefix;     // radix select: bits of T found so far
  uint32_t mask;       // which bits of prefix are fixed
  uint32_t k_rem;      // rank still to find below the prefix
};

__device__ __forceinline__ int lower_bound(const int32_t* a, int n, int32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Exclusive prefix sum over the block; *total gets the block's sum.
// Every thread of the block must call it.
__device__ int block_excl_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int w = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < n_warps) warp_sums[lane] = w;
  }
  __syncthreads();
  int before = (wid > 0 ? warp_sums[wid - 1] : 0) + x - v;
  *total = warp_sums[n_warps - 1];
  __syncthreads();
  return before;
}

// Order-preserving bits of a slot's keep-score (EMPTY slots: +inf).
__device__ __forceinline__ uint32_t key_at(const int32_t* combined,
                                           const float* scores, int p) {
  float f = combined[p] != kEmpty ? scores[p] : INFINITY;
  if (f == 0.f) f = 0.f;               // -0 and +0 tie, as in the reference
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void ssu_cand_kernel(const int32_t* __restrict__ buf,
                                const int32_t* __restrict__ cand,
                                int rn, int nc, int P, State* st,
                                int32_t* __restrict__ cm_live,
                                int32_t* __restrict__ combined) {
  extern __shared__ int32_t s[];
  __shared__ int warp_sums[32];
  __shared__ int lb_sh;
  const int tid = threadIdx.x;
  for (int i = tid; i < P; i += blockDim.x) s[i] = i < nc ? cand[i] : kEmpty;
  if (tid == 0) lb_sh = lower_bound(buf, rn, kEmpty);
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {             // bitonic sort, ascending
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P; i += blockDim.x) {
        int ixj = i ^ j;
        if (ixj > i) {
          int32_t a = s[i], b = s[ixj];
          bool up = (i & k) == 0;
          if ((a > b) == up) { s[i] = b; s[ixj] = a; }
        }
      }
      __syncthreads();
    }
  }
  const int lb = lb_sh;
  const int E = (P + blockDim.x - 1) / blockDim.x;
  const int c0 = min(tid * E, P), c1 = min(c0 + E, P);
  int n_live = 0;
  for (int i = c0; i < c1; ++i) {                // drop ids already present
    int32_t v = s[i];
    if (v == kEmpty) continue;
    int pos = lower_bound(buf, rn, v);
    if (pos < rn && buf[pos] == v) s[i] = kEmpty; else ++n_live;
  }
  int lc;
  int rank = block_excl_scan(n_live, warp_sums, &lc);
  for (int i = c0; i < c1; ++i) {
    int32_t v = s[i];
    if (v == kEmpty) continue;
    cm_live[rank] = v;
    combined[rank + lower_bound(buf, lb, v)] = v;
    ++rank;
  }
  if (tid == 0) {
    st->lb = lb;
    st->lc = lc;
    st->live = lb + lc;
    st->overflow = lb + lc > rn;
    st->prefix = 0u;
    st->mask = 0u;
    st->k_rem = (uint32_t)rn;
  }
}

__global__ void ssu_merge_kernel(const int32_t* __restrict__ buf,
                                 const State* st,
                                 const int32_t* __restrict__ cm_live,
                                 int32_t* __restrict__ combined, int M) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= M) return;
  const int lb = st->lb, lc = st->lc, live = st->live;
  if (p < lb) {
    int32_t v = buf[p];
    combined[p + lower_bound(cm_live, lc, v)] = v;
  }
  if (p >= live) combined[p] = kEmpty;
}

__global__ void ssu_hist_kernel(const int32_t* __restrict__ combined,
                                const float* __restrict__ scores,
                                const State* st, uint32_t* hist, int M,
                                int shift) {
  if (!st->overflow) return;
  __shared__ uint32_t h[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) h[i] = 0u;
  __syncthreads();
  const uint32_t prefix = st->prefix, mask = st->mask;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < M;
       p += gridDim.x * blockDim.x) {
    uint32_t key = key_at(combined, scores, p);
    if ((key & mask) == prefix) atomicAdd(&h[(key >> shift) & 0xffu], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    if (h[i]) atomicAdd(&hist[i], h[i]);
}

__global__ void ssu_pick_kernel(State* st, const uint32_t* hist, int shift) {
  if (threadIdx.x != 0 || !st->overflow) return;
  const uint32_t k = st->k_rem;
  uint32_t cum = 0u;
  for (uint32_t b = 0; b < 256u; ++b) {
    uint32_t c = hist[b];
    if (cum + c >= k) {
      st->prefix |= b << shift;
      st->mask |= 0xffu << shift;
      st->k_rem = k - cum;
      return;
    }
    cum += c;
  }
}

__global__ void ssu_count_kernel(const int32_t* __restrict__ combined,
                                 const float* __restrict__ scores,
                                 const State* st, int32_t* blk_less,
                                 int32_t* blk_eq, int M) {
  if (!st->overflow) return;
  __shared__ int warp_sums[32];
  const uint32_t T = st->prefix;
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  int nl = 0, ne = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    int p = base + q;
    if (p < M) {
      uint32_t key = key_at(combined, scores, p);
      nl += key < T;
      ne += key == T;
    }
  }
  int tl, te;
  block_excl_scan(nl, warp_sums, &tl);
  block_excl_scan(ne, warp_sums, &te);
  if (threadIdx.x == 0) { blk_less[blockIdx.x] = tl; blk_eq[blockIdx.x] = te; }
}

__global__ void ssu_scan_blocks_kernel(const State* st, int32_t* blk_less,
                                       int32_t* blk_eq, int nb) {
  if (!st->overflow) return;
  __shared__ int warp_sums[32];
  int carry_l = 0, carry_e = 0;
  for (int base = 0; base < nb; base += blockDim.x) {
    int i = base + threadIdx.x;
    int vl = i < nb ? blk_less[i] : 0;
    int ve = i < nb ? blk_eq[i] : 0;
    int tl, te;
    int bl = block_excl_scan(vl, warp_sums, &tl);
    int be = block_excl_scan(ve, warp_sums, &te);
    if (i < nb) { blk_less[i] = carry_l + bl; blk_eq[i] = carry_e + be; }
    carry_l += tl;
    carry_e += te;
  }
}

__global__ void ssu_write_kernel(const int32_t* __restrict__ combined,
                                 const float* __restrict__ scores,
                                 const State* st, const int32_t* blk_less,
                                 const int32_t* blk_eq,
                                 int32_t* __restrict__ out, int rn, int M) {
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  if (!st->overflow) {                           // out = combined[:rn]
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      int p = base + q;
      if (p < rn) out[p] = combined[p];
    }
    return;
  }
  __shared__ int warp_sums[32];
  const uint32_t T = st->prefix;
  const int need = (int)st->k_rem;               // slots equal to T to keep
  uint32_t keys[kItems];
  int nl = 0, ne = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    int p = base + q;
    keys[q] = p < M ? key_at(combined, scores, p) : 0xffffffffu;
    if (p < M) { nl += keys[q] < T; ne += keys[q] == T; }
  }
  int tl, te;
  int rl = blk_less[blockIdx.x] + block_excl_scan(nl, warp_sums, &tl);
  int re = blk_eq[blockIdx.x] + block_excl_scan(ne, warp_sums, &te);
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    int p = base + q;
    if (p >= M) break;
    if (keys[q] < T) {
      out[rl + min(re, need)] = combined[p];
      ++rl;
    } else if (keys[q] == T) {
      if (re < need) out[rl + re] = combined[p];
      ++re;
    }
  }
}

int n_tiles(int M) { return (M + kTile - 1) / kTile; }

}  // namespace

extern "C" {

// int32 words of scratch that ssu_dedupe_evict needs for (rn, nc).
long long ssu_scratch_words(int rn, int nc) {
  int M = rn + nc;
  return kStateWords + kHistWords + (long long)M + (nc > 0 ? nc : 1) +
         2LL * n_tiles(M);
}

// buf (rn,) i32 sorted + EMPTY-padded, cand (nc,) i32, scores (rn+nc,) f32
// -> out (rn,) i32 sorted.  scratch: ssu_scratch_words(rn, nc) int32 words.
int ssu_dedupe_evict(const void* buf, const void* cand, const void* scores,
                     void* out, void* scratch, int rn, int nc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int M = rn + nc;
  const int nb = n_tiles(M);
  int P = 1;
  while (P < nc) P <<= 1;
  int32_t* w = (int32_t*)scratch;
  State* st = (State*)w;
  uint32_t* hist = (uint32_t*)(w + kStateWords);
  int32_t* combined = w + kStateWords + kHistWords;
  int32_t* cm_live = combined + M;
  int32_t* blk_less = cm_live + (nc > 0 ? nc : 1);
  int32_t* blk_eq = blk_less + nb;
  const int32_t* b = (const int32_t*)buf;
  const float* sc = (const float*)scores;

  cudaMemsetAsync(w, 0, (kStateWords + kHistWords) * sizeof(int32_t), s);
  ssu_cand_kernel<<<1, kThreads, P * sizeof(int32_t), s>>>(
      b, (const int32_t*)cand, rn, nc, P, st, cm_live, combined);
  ssu_merge_kernel<<<(M + 255) / 256, 256, 0, s>>>(b, st, cm_live, combined, M);
  int hist_blocks = (M + kHistThreads - 1) / kHistThreads;
  if (hist_blocks > 1024) hist_blocks = 1024;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    ssu_hist_kernel<<<hist_blocks, kHistThreads, 0, s>>>(
        combined, sc, st, hist + 256 * pass, M, shift);
    ssu_pick_kernel<<<1, 32, 0, s>>>(st, hist + 256 * pass, shift);
  }
  ssu_count_kernel<<<nb, kThreads, 0, s>>>(combined, sc, st, blk_less, blk_eq, M);
  ssu_scan_blocks_kernel<<<1, kThreads, 0, s>>>(st, blk_less, blk_eq, nb);
  ssu_write_kernel<<<nb, kThreads, 0, s>>>(combined, sc, st, blk_less, blk_eq,
                                          (int32_t*)out, rn, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
