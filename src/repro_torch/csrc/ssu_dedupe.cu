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
// by grid-wide barriers.  Up to kTile = 8,192 candidates (the path's
// steady state):
//   1  every block sorts the raw candidates in shared memory (bitonic)
//      and keeps each value once, dropping EMPTY: the `unique` the caller
//      used to run.  The grid's warps then look the unique candidates up
//      in the reservoir, one warp each, by a 32-ary search (one load per
//      lane per step: ~5 dependent loads at rn = 1.27 M instead of ~21),
//      writing each one's lower bound or "present"; one warp finds lb,
//      the count of live reservoir ids.
//                                                          [grid barrier]
//   2  every block compacts the live candidates and their merge positions
//      (rank + lower bound) into shared memory.
// More candidates than that (the tiled path) do not fit one block's
// shared memory, so they are cut into tiles of kTiledTile = 2,048 (a
// smaller tile sorts in fewer barrier stages, and each block's share of
// the cross-tile searches does not grow with the tile count):
//   T1 a block per tile sorts and dedupes it as in 1 and writes it sorted
//      to scratch.                                         [grid barrier]
//   T2 a block per tile marks the values an earlier tile also holds (a
//      binary search of each earlier tile's values in this one, in shared
//      memory); the grid's threads look every tile value up in the
//      reservoir (a thread each: there are more candidates than warps).
//                                                          [grid barrier]
//   T3 a block per tile compacts its live values (in no earlier tile, not
//      in the reservoir; a value is live in one tile only) and ranks them
//      among all live candidates: its index in the tile plus, from each
//      other tile, the live values below it (each such value adds one at
//      its lower bound in this tile; a prefix sum spreads it).  It writes
//      each live candidate and its merge position at its rank in scratch.
//                                                          [grid barrier]
// Both paths go on from the sorted live candidates and their merge
// positions (shared memory or scratch):
//   W  without overflow (live = lb + lc <= rn, the steady state of a run)
//      each block writes its own slice of `out` = combined[:rn], 4 slots a
//      thread from reservoir ids loaded together, reading only the live
//      candidates whose merge positions fall in its slice, and the kernel
//      ends.
//   O  overflow: the rn smallest (score, position) keys of positions [0,
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
// few microseconds.  The tiled path adds two grid barriers, scratch
// traffic of a few words a candidate and (nt - 1) * kTiledTile binary
// searches in shared memory a tile, twice.
//
// Preconditions (as the reference's): buf sorted ascending with EMPTY
// (INT32_MAX) padding at the end; scores finite; rn + nc < 2^31.
// Candidates come in any order, repeats allowed.

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
constexpr int kMetaWords = 2;
constexpr int kHistWords = 4 * 256;
constexpr int kTile = 8192;            // candidates one block sorts at once
constexpr int kTiledTile = 2048;       // candidates a tile of the tiled path
constexpr int kTiledGrid = 14;         // grid_of's entry for the tiled path

struct Params {
  const int32_t* buf;
  const int32_t* cand;
  const float* scores;
  int32_t* out;
  int32_t* meta;       // [kMetaWords]: lb; lc (tiled path)
  uint32_t* hist;      // [4][256]: the radix passes' histograms
  int32_t* blk;        // [2 * grid]: each block's keys below / equal to T
  // up to kTile candidates:
  int32_t* cpos;       // [P]: lower bound in buf of each unique candidate,
                       //      -1 where it is present
  // tiled path, nt tiles:
  int32_t* tval;       // [nt][kTiledTile]: each tile's unique values, sorted
  int32_t* tdup;       // [nt][kTiledTile]: 1 where an earlier tile holds it
  int32_t* tpos;       // [nt][kTiledTile]: as cpos, for each tile value
  int32_t* tcount;     // [nt]: unique values in each tile
  int32_t* live;       // [nc]: the live candidates, sorted
  int32_t* mpos;       // [nc]: their slots in the union
  int rn, nc, P, nt;
};

// A load of what other blocks wrote before a grid barrier (global
// scratch, G) or of this block's shared memory.
template <bool G>
__device__ __forceinline__ int32_t ld(const int32_t* p) {
  if constexpr (G) return __ldcg(p); else return *p;
}

// First p in [lo, hi] with a[p] >= v (a sorted).
template <bool G>
__device__ __forceinline__ int lower_bound(const int32_t* a, int lo, int hi,
                                           int32_t v) {
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (ld<G>(a + mid) < v) lo = mid + 1; else hi = mid;
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

// Sorts cand[0, n) padded with EMPTY to P (a power of 2) in srt (bitonic)
// and writes each value once, EMPTY dropped, to uq; returns how many.
// Every thread of the block must call it.
__device__ int sort_unique(const int32_t* cand, int n, int P, int32_t* srt,
                           int32_t* uq, int* warp_sums) {
  const int tid = threadIdx.x;
  for (int i = tid; i < P; i += kThreads) srt[i] = i < n ? cand[i] : kEmpty;
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
  const int E = (P + kThreads - 1) / kThreads;
  const int i0 = min(tid * E, P), i1 = min(i0 + E, P);
  int m = 0, nu;
  for (int i = i0; i < i1; ++i)
    m += srt[i] != kEmpty && (i == 0 || srt[i] != srt[i - 1]);
  int r = block_excl_scan(m, warp_sums, &nu);
  for (int i = i0; i < i1; ++i)
    if (srt[i] != kEmpty && (i == 0 || srt[i] != srt[i - 1])) uq[r++] = srt[i];
  __syncthreads();
  return nu;
}

// Order-preserving bits of a keep-score; -0 and +0 tie, as in the reference.
__device__ __forceinline__ uint32_t score_key(float f) {
  if (f == 0.f) f = 0.f;
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The union's slot o; c counts the live candidates placed before o and
// moves past the one placed at o.
template <bool G>
struct Union {
  const int32_t* buf;
  const int32_t* live;     // live candidates, sorted
  const int32_t* mpos;     // their slots in the union
  int lb, lc;
  __device__ __forceinline__ int32_t at(int o, int& c) const {
    if (c < lc && ld<G>(mpos + c) == o) return ld<G>(live + c++);
    const int q = o - c;
    return q < lb ? buf[q] : kEmpty;
  }
};

// Phases W and O, from the sorted live candidates and their merge
// positions (this block's shared memory, or scratch when G).
template <bool G>
__device__ void place(const Params& a, cg::grid_group& grid,
                      const int32_t* live_c, const int32_t* mpos, int lb,
                      int lc, int* warp_sums) {
  __shared__ uint32_t h[256];
  __shared__ int sh[4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rn = a.rn;
  const Union<G> uni{a.buf, live_c, mpos, lb, lc};
  const int live = lb + lc;
  if (live <= rn) {                      // out = combined[:rn]
    const long long chunk = ((long long)rn + (long long)kSlots * gridDim.x - 1) /
                            ((long long)kSlots * gridDim.x) * kSlots;
    const int o0 = (int)min((long long)blockIdx.x * chunk, (long long)rn);
    const int o1 = (int)min((long long)o0 + chunk, (long long)rn);
    // the live candidates placed in this slice
    const int c_lo = lower_bound<G>(mpos, 0, lc, o0);
    const int c_hi = lower_bound<G>(mpos, c_lo, lc, o1);
    const bool vec = ((uintptr_t)a.out & 15) == 0;
    for (int base = o0 + tid * kSlots; base < o1; base += kThreads * kSlots) {
      int c = lower_bound<G>(mpos, c_lo, c_hi, base);
      // the reservoir ids these slots can hold, buf[q .. q + kSlots), loaded
      // at once: each slot takes the next one unless a candidate sits there
      const int q = base - c;
      int32_t b[kSlots], v[kSlots];
#pragma unroll
      for (int e = 0; e < kSlots; ++e) b[e] = q + e < lb ? a.buf[q + e] : kEmpty;
      int used = 0;
#pragma unroll
      for (int e = 0; e < kSlots; ++e) {
        if (c < c_hi && ld<G>(mpos + c) == base + e) {
          v[e] = ld<G>(live_c + c++);
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

  // ---- O. overflow: radix select of the rn-th smallest key ----
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
  // the live candidates placed in this slice
  const int c_lo = lower_bound<G>(mpos, 0, lc, s0);
  const int c_hi = lower_bound<G>(mpos, c_lo, lc, s1);
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
    int c = o < s1 ? lower_bound<G>(mpos, c_lo, c_hi, o) : 0;
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

// Up to kTile candidates: phases 1 and 2, then W or O.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) ssu_kernel(Params a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int32_t sm[];
  int32_t* srt = sm;              // [P] sorted candidates; later the live ones
  int32_t* uq = sm + a.P;         // [P] unique candidates
  int32_t* mpos = sm + 2 * a.P;   // [P] the live ones' slots in the union
  __shared__ int warp_sums[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rn = a.rn;

  // ---- 1. sort, unique, look up ----
  const int nu = sort_unique(a.cand, a.nc, a.P, srt, uq, warp_sums);
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

  // ---- 2. the live candidates and their slots ----
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
  place<false>(a, grid, srt, mpos, lb, lc, warp_sums);
}

// More than kTile candidates: phases T1-T3, then W or O.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    ssu_tiled_kernel(Params a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int32_t sm[];
  // [kTiledTile] each; per phase: the tile sorted, its values, its live
  // values, their positions and the other tiles' counts between them
  int32_t* s0 = sm;
  int32_t* s1 = sm + kTiledTile;
  int32_t* s2 = sm + 2 * kTiledTile;
  __shared__ int warp_sums[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rn = a.rn, nt = a.nt;

  // ---- T1. each tile sorted and deduped into scratch ----
  for (int t = blockIdx.x; t < nt; t += gridDim.x) {
    const long long tb = (long long)t * kTiledTile;
    const int n = sort_unique(a.cand + tb,
                              (int)min((long long)kTiledTile, a.nc - tb),
                              kTiledTile, s0, s1, warp_sums);
    for (int i = tid; i < kTiledTile; i += kThreads) {
      a.tval[tb + i] = i < n ? s1[i] : kEmpty;
      a.tdup[tb + i] = 0;
    }
    if (tid == 0) a.tcount[t] = n;
    __syncthreads();
  }
  const int gw = blockIdx.x * kWarps + warp, n_gw = gridDim.x * kWarps;
  if (gw == n_gw - 1) {
    bool found;
    const int lb = warp_lower_bound(a.buf, rn, kEmpty, lane, &found);
    if (lane == 0) a.meta[0] = lb;
  }
  if (blockIdx.x == 0) {
    for (int i = tid; i < kHistWords; i += kThreads) a.hist[i] = 0u;
    if (tid == 0) a.meta[1] = 0;
  }
  grid.sync();

  // ---- T2. values an earlier tile holds; every value in the reservoir ----
  for (int t = blockIdx.x; t < nt; t += gridDim.x) {
    if (t == 0) continue;
    const long long tb = (long long)t * kTiledTile;
    const int n = __ldcg(a.tcount + t);
    for (int i = tid; i < n; i += kThreads) s0[i] = __ldcg(a.tval + tb + i);
    __syncthreads();
    for (int s = 0; s < t; ++s) {
      const long long sb = (long long)s * kTiledTile;
      const int ns = __ldcg(a.tcount + s);
      for (int j = tid; j < ns; j += kThreads) {
        const int32_t u = __ldcg(a.tval + sb + j);
        const int p = lower_bound<false>(s0, 0, n, u);
        if (p < n && s0[p] == u) a.tdup[tb + p] = 1;
      }
    }
    __syncthreads();
  }
  const long long n_slots = (long long)nt * kTiledTile;
  for (long long g = (long long)blockIdx.x * kThreads + tid; g < n_slots;
       g += (long long)gridDim.x * kThreads) {
    if ((int)(g % kTiledTile) >= __ldcg(a.tcount + g / kTiledTile)) continue;
    const int32_t v = __ldcg(a.tval + g);
    const int p = lower_bound<false>(a.buf, 0, rn, v);
    a.tpos[g] = p < rn && a.buf[p] == v ? -1 : p;
  }
  grid.sync();

  // ---- T3. each tile's live values ranked among all, into scratch ----
  constexpr int E = kTiledTile / kThreads;
  for (int t = blockIdx.x; t < nt; t += gridDim.x) {
    const long long tb = (long long)t * kTiledTile;
    const int n = __ldcg(a.tcount + t), i0 = tid * E;
    int m = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = i0 + e;
      m += i < n && __ldcg(a.tdup + tb + i) == 0 &&
           __ldcg(a.tpos + tb + i) >= 0;
    }
    int mt;                              // live values of this tile
    int r = block_excl_scan(m, warp_sums, &mt);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = i0 + e;
      if (i < n && __ldcg(a.tdup + tb + i) == 0) {
        const int p = __ldcg(a.tpos + tb + i);
        if (p >= 0) { s0[r] = __ldcg(a.tval + tb + i); s1[r] = p; ++r; }
      }
    }
    for (int i = tid; i < kTiledTile; i += kThreads) s2[i] = 0;
    if (tid == 0) atomicAdd(a.meta + 1, mt);
    __syncthreads();
    // s2[i]: the other tiles' live values between s0[i - 1] and s0[i]
    for (int s = 0; s < nt; ++s) {
      if (s == t) continue;
      const long long sb = (long long)s * kTiledTile;
      const int ns = __ldcg(a.tcount + s);
      for (int j = tid; j < ns; j += kThreads) {
        if (__ldcg(a.tdup + sb + j) != 0 || __ldcg(a.tpos + sb + j) < 0)
          continue;
        const int p = lower_bound<false>(s0, 0, mt, __ldcg(a.tval + sb + j));
        if (p < mt) atomicAdd(s2 + p, 1);
      }
    }
    __syncthreads();
    int d = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) d += i0 + e < mt ? s2[i0 + e] : 0;
    int total;
    int below = block_excl_scan(d, warp_sums, &total);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = i0 + e;
      if (i < mt) {
        below += s2[i];
        const int rank = i + below;
        a.live[rank] = s0[i];
        a.mpos[rank] = rank + s1[i];
      }
    }
    __syncthreads();
  }
  grid.sync();
  place<true>(a, grid, a.live, a.mpos, __ldcg(a.meta), __ldcg(a.meta + 1),
              warp_sums);
}

// Candidate slots in shared memory: a power of 2 (the bitonic sort's).
int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

long long tiles_of(int nc) {
  return ((long long)nc + kTiledTile - 1) / kTiledTile;
}

}  // namespace

extern "C" {

// int32 words of scratch that ssu_dedupe_evict needs for nc candidates.
long long ssu_scratch_words(int nc) {
  const long long common = kMetaWords + kHistWords + 2 * kMaxGrid;
  if (nc <= kTile) return common + pow2_at_least(nc);
  return common + 3 * tiles_of(nc) * kTiledTile + tiles_of(nc) + 2LL * nc;
}

// buf (rn,) i32 sorted + EMPTY-padded, cand (nc,) i32 in any order,
// scores (rn+nc,) f32 -> out (rn,) i32 sorted.  scratch:
// ssu_scratch_words(nc) int32 words, nothing in it read before the
// kernel writes it.  One cooperative launch.
int ssu_dedupe_evict(const void* buf, const void* cand, const void* scores,
                     void* out, void* scratch, int rn, int nc, void* stream) {
  if (nc < 0 || rn < 1 || (long long)rn + nc >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool tiled = nc > kTile;
  const int P = tiled ? kTiledTile : pow2_at_least(nc);
  const size_t smem = 3 * (size_t)P * sizeof(int32_t);
  const void* kernel = tiled ? (const void*)ssu_tiled_kernel
                             : (const void*)ssu_kernel;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  // the grid for (device, P or tiled): as many blocks as fit at once
  static int grid_of[64][kTiledGrid + 1];
  int slot = kTiledGrid;
  if (!tiled) for (slot = 0; (1 << slot) < P; ++slot) {}
  int grid = dev < 64 ? grid_of[dev][slot] : 0;
  if (grid == 0) {
    // dynamic shared memory past what a block gets without opting in
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(3 * kTile * sizeof(int32_t)));
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    grid = per_sm < kBlocksPerSM ? per_sm * sms : kBlocksPerSM * sms;
    if (grid > kMaxGrid) grid = kMaxGrid;
    if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    if (dev < 64) grid_of[dev][slot] = grid;
  }
  int32_t* w = (int32_t*)scratch;
  Params p{};
  p.buf = (const int32_t*)buf;
  p.cand = (const int32_t*)cand;
  p.scores = (const float*)scores;
  p.out = (int32_t*)out;
  p.meta = w;
  p.hist = (uint32_t*)(w + kMetaWords);
  p.blk = w + kMetaWords + kHistWords;
  int32_t* rest = p.blk + 2 * kMaxGrid;
  p.rn = rn;
  p.nc = nc;
  p.P = P;
  if (!tiled) {
    p.cpos = rest;
  } else {
    const long long slots = tiles_of(nc) * kTiledTile;
    p.nt = (int)tiles_of(nc);
    p.tval = rest;
    p.tdup = rest + slots;
    p.tpos = rest + 2 * slots;
    p.tcount = rest + 3 * slots;
    p.live = p.tcount + p.nt;
    p.mpos = p.live + nc;
  }
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kernel, grid, kThreads, args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
