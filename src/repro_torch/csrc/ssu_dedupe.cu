// CPR-SSU reservoir update (dedupe + merge + random evict) for Hopper
// (sm_90a): one cooperative launch, exact.
//
// Replaces: src/repro/kernels/ssu_dedupe.py, function ssu_dedupe_evict
// (the Pallas kernel: one block that sorts the whole union).  At full
// Criteo-Kaggle width the largest table's reservoir has rn = 1,266,403
// slots, so the union cannot be sorted in one block's shared memory.  The
// kernel gets the same answer from what the reference body computes, with
// `combined` (the sorted union) never written out: its slot o holds the
// live candidate whose merge position is o, else buf[o - c] (c = live
// candidates placed before o) while that is a live id, else EMPTY.
//
// One cooperative launch, one 1024-thread block per SM, phases separated
// by grid-wide barriers:
//   1  every block sorts the raw candidates in shared memory (bitonic)
//      and keeps each value once, dropping EMPTY: the `unique` the caller
//      used to run.  The grid's warps then look the unique candidates up
//      in the reservoir, one warp each, by a 32-ary search (one load per
//      lane per step: ~5 dependent loads at rn = 1.27 M instead of ~21),
//      writing each one's lower bound or "present"; one warp finds lb,
//      the count of live reservoir ids.
//                                                          [grid barrier]
//   2  every block compacts the live candidates and their merge positions
//      (rank + lower bound) into shared memory.  Without overflow (live =
//      lb + lc <= rn, the steady state of a run) each block writes its own
//      slice of `out` = combined[:rn], 4 slots a thread from reservoir ids
//      loaded together, and the kernel ends: one launch, one barrier.
//   3  overflow: the rn smallest (score, position) keys of positions [0,
//      live) survive, as the reference's stable argsort keeps them (every
//      position below `live` is live; EMPTY scores +inf and never makes
//      it).  4 passes of an 8-bit radix select over the order-preserving
//      bits of the scores (-0 ties +0) find the rn-th smallest key T and how
//      many keys equal to T are kept.        [a grid barrier after each pass]
//      Each block counts its slice's keys below T and equal to T [barrier],
//      then writes its kept slots in position order, which is the sorted
//      order of the output.
//
// Bound on this card: bytes, and they depend on the case.  Without
// overflow the answer reads the lb live ids of buf and the nc candidates
// and writes rn*4; the scores are never needed.  With overflow it also
// reads the live slots' scores.  For the largest Kaggle table (rn =
// 1,266,403, nc = 256) that is about 7.6 MB (half-full reservoir, 2.3 us
// at 3.35 TB/s) or 15.2 MB (full, 4.5 us).  Without overflow the kernel
// moves just those bytes; the rest of its time is the launch, the sort,
// the search's dependent loads and one grid barrier, a fixed cost of a
// few microseconds.
//
// Preconditions (as the reference's): buf sorted ascending with EMPTY
// (INT32_MAX) padding at the end; scores finite; nc <= 8192.  Candidates
// come in any order, repeats allowed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int32_t kEmpty = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;              // consecutive slots a thread handles
constexpr int kBlocksPerSM = 1;
constexpr int kMaxGrid = 2048;
constexpr int kMetaWords = 1;
constexpr int kHistWords = 4 * 256;
constexpr int kMaxCand = 8192;

struct Params {
  const int32_t* buf;
  const int32_t* cand;
  const float* scores;
  int32_t* out;
  int32_t* cpos;       // [P]: lower bound in buf of each unique candidate,
                       //      -1 where it is present
  int32_t* meta;       // [kMetaWords]: lb
  uint32_t* hist;      // [4][256]: the radix passes' histograms
  int32_t* blk;        // [2 * grid]: each block's keys below / equal to T
  int rn, nc, P;
};

__device__ __forceinline__ int lower_bound(const int32_t* a, int n, int32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First p in [0, n] with a[p] >= v (a sorted), the same in every lane,
// and whether a[p] == v.  Each step splits [lo, hi] at 31 pivots, one
// load per lane.
__device__ int warp_lower_bound(const int32_t* a, int n, int32_t v, int lane,
                                bool* found) {
  int lo = 0, hi = n;      // a[i] < v for i < lo; a[i] >= v for i >= hi
  while (hi - lo >= 32) {
    const long long span = hi - lo;
    bool less = false;
    if (lane < 31) less = a[lo + (int)(span * (lane + 1) / 32)] < v;
    const int c = __popc(__ballot_sync(kFull, less));
    const int nlo = c ? lo + (int)(span * c / 32) + 1 : lo;
    if (c < 31) hi = lo + (int)(span * (c + 1) / 32);
    lo = nlo;
  }
  const int i = lo + lane;
  const bool in = i <= hi && i < n;
  const int32_t x = in ? a[i] : 0;
  *found = __ballot_sync(kFull, in && x == v) != 0u;
  return lo + __popc(__ballot_sync(kFull, in && x < v));
}

// Exclusive prefix sum over the block; *total gets the block's sum.
// Every thread of the block must call it.
__device__ int block_excl_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  int before = (wid > 0 ? warp_sums[wid - 1] : 0) + x - v;
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return before;
}

// Order-preserving bits of a keep-score; -0 and +0 tie, as in the reference.
__device__ __forceinline__ uint32_t score_key(float f) {
  if (f == 0.f) f = 0.f;
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The union's slot o; c counts the live candidates placed before o and
// moves past the one placed at o.
struct Union {
  const int32_t* buf;
  const int32_t* live;     // live candidates, sorted (shared memory)
  const int32_t* mpos;     // their slots in the union (shared memory)
  int lb, lc;
  __device__ __forceinline__ int32_t at(int o, int& c) const {
    if (c < lc && mpos[c] == o) return live[c++];
    const int q = o - c;
    return q < lb ? buf[q] : kEmpty;
  }
};

__global__ void __launch_bounds__(kThreads, kBlocksPerSM) ssu_kernel(Params a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int32_t sm[];
  int32_t* srt = sm;              // [P] sorted candidates; later the live ones
  int32_t* uq = sm + a.P;         // [P] unique candidates
  int32_t* mpos = sm + 2 * a.P;   // [P] the live ones' slots in the union
  __shared__ int warp_sums[32];
  __shared__ uint32_t h[256];
  __shared__ int sh[4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = a.P, rn = a.rn;

  // ---- 1. sort, unique, look up ----
  // bitonic sort of the candidates padded with EMPTY to P, then each
  // value kept once (block scan)
  for (int i = tid; i < P; i += kThreads) srt[i] = i < a.nc ? a.cand[i] : kEmpty;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P / 2; i += kThreads) {
        const int x = ((i & ~(j - 1)) << 1) | (i & (j - 1)), y = x | j;
        const int32_t u = srt[x], w = srt[y];
        if ((u > w) == ((x & size) == 0)) { srt[x] = w; srt[y] = u; }
      }
      __syncthreads();
    }
  }
  int nu;                                 // unique candidates, in uq
  {
    const int E = (P + kThreads - 1) / kThreads;
    const int i0 = min(tid * E, P), i1 = min(i0 + E, P);
    int n = 0;
    for (int i = i0; i < i1; ++i)
      n += srt[i] != kEmpty && (i == 0 || srt[i] != srt[i - 1]);
    int r = block_excl_scan(n, warp_sums, &nu);
    for (int i = i0; i < i1; ++i)
      if (srt[i] != kEmpty && (i == 0 || srt[i] != srt[i - 1])) uq[r++] = srt[i];
    __syncthreads();
  }
  const int gw = blockIdx.x * kWarps + warp, n_gw = gridDim.x * kWarps;
  for (int u = gw; u < nu; u += n_gw) {
    bool found;
    const int p = warp_lower_bound(a.buf, rn, uq[u], lane, &found);
    if (lane == 0) a.cpos[u] = found ? -1 : p;
  }
  if (gw == n_gw - 1) {
    bool found;
    const int lb = warp_lower_bound(a.buf, rn, kEmpty, lane, &found);
    if (lane == 0) a.meta[0] = lb;
  }
  if (blockIdx.x == 0)
    for (int i = tid; i < kHistWords; i += kThreads) a.hist[i] = 0u;
  grid.sync();

  // ---- 2. the live candidates and their slots; no overflow: write ----
  const int lb = __ldcg(a.meta);
  const int Eu = (nu + kThreads - 1) / kThreads;
  const int u0 = min(tid * Eu, nu), u1 = min(u0 + Eu, nu);
  int n = 0;
  for (int u = u0; u < u1; ++u) n += __ldcg(a.cpos + u) >= 0;
  int lc;
  int r = block_excl_scan(n, warp_sums, &lc);
  for (int u = u0; u < u1; ++u) {
    const int p = __ldcg(a.cpos + u);
    if (p >= 0) { srt[r] = uq[u]; mpos[r] = r + p; ++r; }
  }
  __syncthreads();
  const Union uni{a.buf, srt, mpos, lb, lc};
  const int live = lb + lc;
  if (live <= rn) {                      // out = combined[:rn]
    const long long chunk = ((long long)rn + (long long)kSlots * gridDim.x - 1) /
                            ((long long)kSlots * gridDim.x) * kSlots;
    const int o0 = (int)min((long long)blockIdx.x * chunk, (long long)rn);
    const int o1 = (int)min((long long)o0 + chunk, (long long)rn);
    const bool vec = ((uintptr_t)a.out & 15) == 0;
    for (int base = o0 + tid * kSlots; base < o1; base += kThreads * kSlots) {
      int c = lower_bound(mpos, lc, base);
      // the reservoir ids these slots can hold, buf[q .. q + kSlots), loaded
      // at once: each slot takes the next one unless a candidate sits there
      const int q = base - c;
      int32_t b[kSlots], v[kSlots];
#pragma unroll
      for (int e = 0; e < kSlots; ++e) b[e] = q + e < lb ? a.buf[q + e] : kEmpty;
      int used = 0;
#pragma unroll
      for (int e = 0; e < kSlots; ++e) {
        if (c < lc && mpos[c] == base + e) {
          v[e] = srt[c++];
        } else {
          int32_t x = b[0];
#pragma unroll
          for (int f = 1; f < kSlots; ++f) x = used == f ? b[f] : x;
          v[e] = x;
          ++used;
        }
      }
#pragma unroll
      for (int e = 0; e < kSlots; e += 4) {
        if (vec && base + e + 4 <= o1) {
          *reinterpret_cast<int4*>(a.out + base + e) =
              make_int4(v[e], v[e + 1], v[e + 2], v[e + 3]);
        } else {
#pragma unroll
          for (int f = e; f < e + 4; ++f) if (base + f < o1) a.out[base + f] = v[f];
        }
      }
    }
    return;
  }

  // ---- 3. overflow: radix select of the rn-th smallest key ----
  const long long per = ((long long)live + gridDim.x - 1) / gridDim.x;
  const int s0 = (int)min((long long)blockIdx.x * per, (long long)live);
  const int s1 = (int)min((long long)s0 + per, (long long)live);
  uint32_t prefix = 0u, mask = 0u, k_rem = (uint32_t)rn;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int i = tid; i < 256; i += kThreads) h[i] = 0u;
    __syncthreads();
    for (int base = s0; base < s1; base += kThreads) {
      const int o = base + tid;
      bool act = false;
      uint32_t bin = 0u;
      if (o < s1) {
        const uint32_t key = score_key(a.scores[o]);
        act = (key & mask) == prefix;
        bin = (key >> shift) & 0xffu;
      }
      const unsigned am = __ballot_sync(kFull, act);
      if (act) {                         // one atomic per distinct bin
        const unsigned peers = __match_any_sync(am, bin);
        if (lane == __ffs(peers) - 1) atomicAdd(&h[bin], (uint32_t)__popc(peers));
      }
    }
    __syncthreads();
    for (int i = tid; i < 256; i += kThreads)
      if (h[i]) atomicAdd(a.hist + 256 * pass + i, h[i]);
    grid.sync();
    if (warp == 0) {                     // every block finds the same digit
      uint32_t cnt[8], sum = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = __ldcg(a.hist + 256 * pass + 8 * lane + j);
        sum += cnt[j];
      }
      uint32_t inc = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        uint32_t y = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += y;
      }
      uint32_t cum = inc - sum;
      if (cum < k_rem && k_rem <= inc) {
        for (int j = 0; j < 8; ++j) {
          if (cum + cnt[j] >= k_rem) {
            sh[0] = 8 * lane + j;
            sh[1] = (int)(k_rem - cum);
            break;
          }
          cum += cnt[j];
        }
      }
    }
    __syncthreads();
    prefix |= (uint32_t)sh[0] << shift;
    mask |= 0xffu << shift;
    k_rem = (uint32_t)sh[1];
    __syncthreads();
  }

  // ---- ordered compaction: key < T kept; of key == T the first `need` ----
  const uint32_t T = prefix;
  const int need = (int)k_rem;
  int nl = 0, ne = 0;
  for (int o = s0 + tid; o < s1; o += kThreads) {
    const uint32_t key = score_key(a.scores[o]);
    nl += key < T;
    ne += key == T;
  }
  int tl, te;
  block_excl_scan(nl, warp_sums, &tl);
  block_excl_scan(ne, warp_sums, &te);
  if (tid == 0) { a.blk[blockIdx.x] = tl; a.blk[gridDim.x + blockIdx.x] = te; }
  grid.sync();
  if (warp == 0) {
    int bl = 0, be = 0;
    for (int b = lane; b < (int)blockIdx.x; b += 32) {
      bl += __ldcg(a.blk + b);
      be += __ldcg(a.blk + gridDim.x + b);
    }
    bl = __reduce_add_sync(kFull, bl);
    be = __reduce_add_sync(kFull, be);
    if (lane == 0) { sh[2] = bl; sh[3] = be; }
  }
  __syncthreads();
  int rl = sh[2], re = sh[3];
  for (int base = s0; base < s1; base += kThreads * kSlots) {
    const int o = base + tid * kSlots;
    uint32_t keys[kSlots];
    int cl = 0, ce = 0;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      keys[q] = o + q < s1 ? score_key(a.scores[o + q]) : 0xffffffffu;
      cl += o + q < s1 && keys[q] < T;
      ce += o + q < s1 && keys[q] == T;
    }
    int tl2, te2;
    int xl = rl + block_excl_scan(cl, warp_sums, &tl2);
    int xe = re + block_excl_scan(ce, warp_sums, &te2);
    int c = o < s1 ? lower_bound(mpos, lc, o) : 0;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      if (o + q >= s1) break;
      const int32_t v = uni.at(o + q, c);
      if (keys[q] < T) {
        a.out[xl + min(xe, need)] = v;
        ++xl;
      } else if (keys[q] == T) {
        if (xe < need) a.out[xl + xe] = v;
        ++xe;
      }
    }
    rl += tl2;
    re += te2;
  }
}

// Candidate slots in shared memory: a power of 2 (the bitonic sort's).
int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// int32 words of scratch that ssu_dedupe_evict needs for nc candidates.
long long ssu_scratch_words(int nc) {
  return (long long)pow2_at_least(nc) + kMetaWords + kHistWords + 2 * kMaxGrid;
}

// buf (rn,) i32 sorted + EMPTY-padded, cand (nc,) i32 in any order,
// scores (rn+nc,) f32 -> out (rn,) i32 sorted.  scratch:
// ssu_scratch_words(nc) int32 words, nothing in it read before the
// kernel writes it.  One cooperative launch.
int ssu_dedupe_evict(const void* buf, const void* cand, const void* scores,
                     void* out, void* scratch, int rn, int nc, void* stream) {
  if (nc > kMaxCand || rn < 1) return (int)cudaErrorInvalidValue;
  const int P = pow2_at_least(nc);
  const size_t smem = 3 * (size_t)P * sizeof(int32_t);
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  // the grid for (device, P): as many blocks as fit on the card at once
  static int grid_of[64][14];
  int log_p = 0;
  while ((1 << log_p) < P) ++log_p;
  int grid = dev < 64 ? grid_of[dev][log_p] : 0;
  if (grid == 0) {
    // dynamic shared memory past what a block gets without opting in
    e = cudaFuncSetAttribute(ssu_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(3 * kMaxCand * sizeof(int32_t)));
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ssu_kernel,
                                                      kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    grid = per_sm < kBlocksPerSM ? per_sm * sms : kBlocksPerSM * sms;
    if (grid > kMaxGrid) grid = kMaxGrid;
    if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    if (dev < 64) grid_of[dev][log_p] = grid;
  }
  int32_t* w = (int32_t*)scratch;
  Params p{(const int32_t*)buf, (const int32_t*)cand, (const float*)scores,
           (int32_t*)out, w, w + P, (uint32_t*)(w + P + kMetaWords),
           w + P + kMetaWords + kHistWords, rn, nc, P};
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)ssu_kernel, grid, kThreads,
                                  args, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
