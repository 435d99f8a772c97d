// Fused CPR-MFU counter update + segment-wise top-k row selection for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/tracker_select.py, function tracker_select
// (the Pallas kernel; one grid step per segment that histograms the
// pending ids against its row range, runs k argmax rounds, and writes
// back the counters with the picks cleared).
//
// Launches:
//   (a) fold (only when ids are pending; the emulator folds counts in its
//       train step): the counters are copied to the output, then one
//       thread per pending id atomically adds 1; ids outside [0, N) match
//       nothing.  The select then runs in place on the output.
//   (b) select: a team of W warps owns one `seg`-row segment and holds it
//       in registers, 4*G counters a thread (W = 1 and G = 4 for seg <= 512,
//       the main path: one warp, 16 counters a lane, four segments a
//       block).  Thread t of a team of T threads holds the rows
//       4*(g*T + t) + e of its segment (g < G, e < 4), so each load or
//       store of a group is one coalesced 16-byte access per thread where
//       the segment start is aligned, scalar at ragged edges.  Padding
//       rows of the last segment count -1; slots past `seg` hold INT_MIN
//       and come after every row in the tie order, so they are never
//       picked (k <= seg).
//
// The selection is a bitwise radix select of the k-th largest key, with
// no shared-memory rounds: each count maps to an order-preserving
// unsigned key; the bits above the highest bit in which the segment's
// largest and smallest keys differ are common, and each lower bit is
// fixed by one team-wide count (`__reduce_add_sync`).  The loop stops
// once the undecided bucket holds exactly as many rows as are still to be
// picked.  Then every row above the bucket is picked, and of the bucket
// the rows with the lowest positions, found by an exclusive team prefix in
// row order.  The selection order is (count descending, row ascending) --
// the reference's k argmax rounds, i.e. a stable descending sort -- so the
// bucket's picks come last, in row order, each written at its prefix; only
// the picks above the bucket are sorted, as packed 64-bit keys in shared
// memory (bitonic).  The counters go back once, the picks zeroed.
//
// Wider segments (seg > 16384, past what a team holds in registers):
//   (c) select, wide: a block of kWideThreads threads per segment reads
//       the counters from device memory.  Four passes of an 8-bit radix
//       select (a 256-bin histogram in shared memory, warp-aggregated
//       adds) fix the k-th largest key P exactly, and how many rows equal
//       to it are picked (kr).  One pass then writes the bucket's picks
//       (the kr lowest-positioned rows equal to P) in row order, by a
//       block-wide prefix, and gathers the rows above P into a scratch
//       area of device memory as packed (~key, position) keys, which a
//       bitonic sort of the block puts in selection order.  A last pass
//       writes the counters back, the picks cleared.  It reads each
//       counter six times; no main-path call takes it (seg <= 512 there).
//
// Bound on this card: bytes.  The function must read and write N*4 bytes
// of counters and write n_seg*k*4 bytes of ids (40.5 MB + 40.5 MB + 5 MB
// for the largest Kaggle table, 0.0257 ms at 3.35 TB/s).  Each counter
// crosses device memory once in each direction (twice more when pending
// ids force the copy before the fold); the select itself runs on
// registers with warp votes and reductions, so with one warp per segment
// there is no block barrier in it at all.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kFoldThreads = 256;
constexpr int kWarpTeams = 4;            // segments per block when W == 1
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemWithoutOptIn = 48 * 1024;

__global__ void tracker_fold_kernel(int32_t* __restrict__ counts,
                                    const int32_t* __restrict__ ids,
                                    long long n_ids, long long n_rows) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_ids) return;
  long long id = ids[t];
  if (id >= 0 && id < n_rows) atomicAdd(counts + id, 1);
}

// Order-preserving unsigned key of an int32 count.
__device__ __forceinline__ uint32_t key_of(int32_t v) {
  return (uint32_t)v ^ 0x80000000u;
}

// Reductions and scans over a team of W warps.  W == 1: warp intrinsics
// only.  W > 1 (the team is the block): warp results meet in shared
// memory, double-buffered so that one barrier per call suffices.
template <int W>
struct Team {
  uint32_t* red;               // [2][32], W > 1 only
  unsigned long long* red64;   // [2][32], W > 1 only
  int parity, parity64, lane, wid;

  __device__ void sync() const {
    if (W == 1) __syncwarp(); else __syncthreads();
  }
  template <int Op>            // 0 sum, 1 max, 2 min
  __device__ uint32_t reduce(uint32_t x) {
    x = Op == 0 ? __reduce_add_sync(kFull, x)
      : Op == 1 ? __reduce_max_sync(kFull, x) : __reduce_min_sync(kFull, x);
    if (W == 1) return x;
    uint32_t* r = red + 32 * parity;
    parity ^= 1;
    if (lane == 0) r[wid] = x;
    __syncthreads();
    uint32_t s = r[0];
#pragma unroll
    for (int w = 1; w < W; ++w)
      s = Op == 0 ? s + r[w] : Op == 1 ? max(s, r[w]) : min(s, r[w]);
    return s;
  }
  // Exclusive prefix sum in thread order; *total gets the team's sum.
  __device__ unsigned long long excl_scan(unsigned long long x,
                                          unsigned long long* total) {
    unsigned long long inc = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      unsigned long long y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    if (W == 1) {
      *total = __shfl_sync(kFull, inc, 31);
      return inc - x;
    }
    unsigned long long* r = red64 + 32 * parity64;
    parity64 ^= 1;
    if (lane == 31) r[wid] = inc;
    __syncthreads();
    unsigned long long before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      unsigned long long s = r[w];
      if (w < wid) before += s;
      all += s;
    }
    *total = all;
    return before + inc - x;
  }
};

// counts_in and counts_out may alias (in-place select after a fold): a
// team reads its whole segment before it writes any of it.
template <int W, int G>
__global__ void __launch_bounds__(W == 1 ? 32 * kWarpTeams : 32 * W)
tracker_select_kernel(const int32_t* counts_in, int32_t* counts_out,
                      int32_t* __restrict__ out_ids, long long n_rows,
                      long long n_seg, int seg, int k, int max_sort,
                      int vec_ok) {
  constexpr int T = 32 * W;                 // threads of a team
  constexpr int kTeams = W == 1 ? kWarpTeams : 1;
  constexpr int V = 4 * G;                  // counters a thread holds
  extern __shared__ unsigned long long sort_buf[];   // kTeams * max_sort
  __shared__ uint32_t red[W == 1 ? 1 : 64];
  __shared__ unsigned long long red64[W == 1 ? 1 : 64];

  const int team_id = threadIdx.x / T;
  const int t = threadIdx.x % T;
  Team<W> team{red, red64, 0, 0, (int)(threadIdx.x & 31), t >> 5};
  const long long s = (long long)blockIdx.x * kTeams + team_id;
  if (s >= n_seg) return;                   // W == 1 only: a whole warp
  unsigned long long* sbuf = sort_buf + (size_t)team_id * max_sort;
  const long long lo = s * seg;
  const bool vec = vec_ok && (lo & 3) == 0;

  int32_t v[V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int p0 = 4 * (g * T + t);
    const long long r0 = lo + p0;
    if (vec && p0 + 4 <= seg && r0 + 4 <= n_rows) {
      const int4 x = *reinterpret_cast<const int4*>(counts_in + r0);
      v[4 * g] = x.x; v[4 * g + 1] = x.y; v[4 * g + 2] = x.z;
      v[4 * g + 3] = x.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + e;
        v[4 * g + e] = p >= seg ? INT_MIN
                     : lo + p < n_rows ? counts_in[lo + p] : -1;
      }
    }
  }

  // ---- radix select: after the loop the picks are the rows whose key
  // bits under M exceed P, and the kr lowest-positioned rows equal to P
  uint32_t mx = 0u, mn = 0xffffffffu;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mx = max(mx, key_of(v[i]));
    mn = min(mn, key_of(v[i]));
  }
  mx = team.template reduce<1>(mx);
  mn = team.template reduce<2>(mn);
  const uint32_t diff = mx ^ mn;
  uint32_t M = diff ? ~(0xffffffffu >> __clz(diff)) : 0xffffffffu;
  uint32_t P = mx & M;
  int kr = k, bucket = V * T;
  for (int b = 31 - __clz(diff); b >= 0 && bucket != kr; --b) {
    const uint32_t Mb = M | (1u << b), Pb = P | (1u << b);
    uint32_t c = 0;
#pragma unroll
    for (int i = 0; i < V; ++i) c += (key_of(v[i]) & Mb) == Pb;
    c = team.template reduce<0>(c);
    if ((int)c >= kr) {
      P = Pb;
      bucket = (int)c;
    } else {
      kr -= (int)c;
      bucket -= (int)c;
    }
    M = Mb;
  }

  // ---- bucket rows in row order: group g of every thread precedes group
  // g + 1; 16-bit fields hold each group's count (at most 4*T <= 4096)
  unsigned long long eq = 0;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      eq += (unsigned long long)((key_of(v[4 * g + e]) & M) == P) << (16 * g);
  unsigned long long eq_total;
  const unsigned long long eq_before = team.excl_scan(eq, &eq_total);
  // Where every bit was fixed the bucket holds one key, T, and its picks
  // come last in selection order, in row order: they are written here.  The
  // n_above picks above it are sorted below.  Where the loop stopped early
  // the bucket (all of it picked) may hold several keys: it is sorted too.
  const bool exact = M == 0xffffffffu;
  const int n_above = exact ? k - kr : k;
  int32_t* seg_ids = out_ids + s * k;
  uint32_t picked = 0u, above = 0u;
  int n_mine = 0, group_base = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    int r = group_base + (int)((eq_before >> (16 * g)) & 0xffffu);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * g + e;
      const uint32_t km = key_of(v[i]) & M;
      if (km > P || (!exact && km == P)) {
        above |= 1u << i;
        ++n_mine;
      } else if (km == P) {
        if (r < kr) {
          picked |= 1u << i;
          seg_ids[n_above + r] = (int32_t)(lo + 4 * (g * T + t) + e);
        }
        ++r;
      }
    }
    group_base += (int)((eq_total >> (16 * g)) & 0xffffu);
  }
  picked |= above;

  // ---- counters back once, picks cleared
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int p0 = 4 * (g * T + t);
    const long long r0 = lo + p0;
    int32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = (picked >> (4 * g + e)) & 1u ? 0 : v[4 * g + e];
    if (vec && p0 + 4 <= seg && r0 + 4 <= n_rows) {
      *reinterpret_cast<int4*>(counts_out + r0) =
          make_int4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (p0 + e < seg && r0 + e < n_rows) counts_out[r0 + e] = w[e];
    }
  }
  if (n_above == 0) return;                 // team-uniform

  // ---- the picks above the bucket in selection order: ascending
  // (~key, position), a bitonic sort of n_above keys padded to a power of 2
  const int n_sort = n_above == 1 ? 1 : 1 << (32 - __clz(n_above - 1));
  unsigned long long n_total;               // == n_above
  int slot = (int)team.excl_scan((unsigned long long)n_mine, &n_total);
#pragma unroll
  for (int i = 0; i < V; ++i)
    if ((above >> i) & 1u) {
      const uint32_t pos = 4u * ((i / 4) * T + t) + (i % 4);
      sbuf[slot++] = ((unsigned long long)(~key_of(v[i])) << 32) | pos;
    }
  for (int i = n_above + t; i < n_sort; i += T) sbuf[i] = ~0ull;
  team.sync();
  for (int size = 2; size <= n_sort; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int i = t; i < n_sort / 2; i += T) {
        const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int b = a | j;
        const unsigned long long x = sbuf[a], y = sbuf[b];
        if ((x > y) == ((a & size) == 0)) { sbuf[a] = y; sbuf[b] = x; }
      }
      team.sync();
    }
  }
  for (int i = t; i < n_above; i += T)
    seg_ids[i] = (int32_t)(lo + (uint32_t)sbuf[i]);
}

constexpr int kWideThreads = 1024;
constexpr int kWideMaxSeg = 32 * 32 * 16;   // widest segment a team holds

// Exclusive prefix sum in thread order over the block; *total gets the
// block's sum.  `sums` holds 32 words of shared memory.
__device__ unsigned long long block_excl_scan(unsigned long long x,
                                              unsigned long long* sums,
                                              unsigned long long* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  unsigned long long inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) sums[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    unsigned long long w = lane < n_warps ? sums[lane] : 0ull;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    sums[lane] = w;                       // inclusive, by warp
  }
  __syncthreads();
  const unsigned long long before = wid ? sums[wid - 1] : 0ull;
  *total = sums[n_warps - 1];
  __syncthreads();                        // `sums` is reused by the caller
  return before + inc - x;
}

__device__ __forceinline__ int32_t wide_count(const int32_t* c, long long lo,
                                              int p, long long n_rows) {
  return lo + p < n_rows ? c[lo + p] : -1;   // padding rows count -1
}

// One block per segment of any width.  counts_in and counts_out may alias:
// the block reads its whole segment before the last pass writes it.
// scratch: max_sort 64-bit words a segment.
__global__ void __launch_bounds__(kWideThreads)
tracker_select_wide_kernel(const int32_t* counts_in, int32_t* counts_out,
                           int32_t* __restrict__ out_ids,
                           unsigned long long* scratch, long long n_rows,
                           int seg, int k, int max_sort) {
  __shared__ unsigned hist[256];
  __shared__ unsigned long long sums[32];
  __shared__ unsigned s_digit;
  __shared__ int s_kr, s_last;
  const int t = threadIdx.x, T = blockDim.x, lane = t & 31;
  const long long s = blockIdx.x;
  const long long lo = s * seg;

  // ---- radix select, 8 bits a pass: P is the k-th largest key, kr the
  // number of rows equal to it that are picked (1 <= kr)
  uint32_t P = 0u, M = 0u;
  int kr = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = t; i < 256; i += T) hist[i] = 0u;
    __syncthreads();
    for (int p0 = 0; p0 < seg; p0 += T) {   // block-uniform trip count
      const int p = p0 + t;
      unsigned bin = 256u;                  // no bin
      if (p < seg) {
        const uint32_t key = key_of(wide_count(counts_in, lo, p, n_rows));
        if ((key & M) == P) bin = (key >> shift) & 255u;
      }
      const unsigned peers = __match_any_sync(kFull, bin);
      if (bin != 256u && __ffs(peers) - 1 == lane)
        atomicAdd(&hist[bin], (unsigned)__popc(peers));
    }
    __syncthreads();
    if (t == 0) {
      int r = kr;
      unsigned digit = 0u;
      for (int d = 255; d >= 0; --d) {
        const int c = (int)hist[d];
        if (c >= r) { digit = (unsigned)d; break; }
        r -= c;
      }
      s_digit = digit;
      s_kr = r;
    }
    __syncthreads();
    P |= s_digit << shift;
    M |= 0xffu << shift;
    kr = s_kr;
  }

  // ---- one pass in row order: the bucket's picks at their prefix, the
  // rows above P gathered for the sort
  const int n_above = k - kr;
  unsigned long long* sbuf = scratch + (size_t)s * max_sort;
  int32_t* seg_ids = out_ids + s * k;
  if (t == 0) s_last = -1;
  unsigned long long base_eq = 0ull, base_above = 0ull;
  for (int p0 = 0; p0 < seg; p0 += T) {
    const int p = p0 + t;
    const uint32_t key = p < seg ? key_of(wide_count(counts_in, lo, p, n_rows))
                                 : 0u;
    const bool eq = p < seg && key == P, above = p < seg && key > P;
    unsigned long long total;
    const unsigned long long before = block_excl_scan(
        ((unsigned long long)above << 32) | (unsigned long long)eq, sums,
        &total);
    if (eq) {
      const unsigned long long r = base_eq + (before & 0xffffffffull);
      if (r < (unsigned long long)kr) {
        seg_ids[n_above + r] = (int32_t)(lo + p);
        if (r == (unsigned long long)(kr - 1)) s_last = p;
      }
    }
    if (above)
      sbuf[base_above + (before >> 32)] =
          ((unsigned long long)(~key) << 32) | (unsigned)p;
    base_eq += total & 0xffffffffull;
    base_above += total >> 32;
  }
  __syncthreads();
  const int last = s_last;

  // ---- the picks above P in selection order: ascending (~key, position)
  if (n_above > 0) {
    const int n_sort = n_above == 1 ? 1 : 1 << (32 - __clz(n_above - 1));
    for (int i = n_above + t; i < n_sort; i += T) sbuf[i] = ~0ull;
    __syncthreads();
    for (int size = 2; size <= n_sort; size <<= 1) {
      for (int j = size >> 1; j > 0; j >>= 1) {
        for (int i = t; i < n_sort / 2; i += T) {
          const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1));
          const int b = a | j;
          const unsigned long long x = sbuf[a], y = sbuf[b];
          if ((x > y) == ((a & size) == 0)) { sbuf[a] = y; sbuf[b] = x; }
        }
        __syncthreads();
      }
    }
    for (int i = t; i < n_above; i += T)
      seg_ids[i] = (int32_t)(lo + (uint32_t)sbuf[i]);
  }

  // ---- counters back, picks cleared
  for (int p = t; p < seg && lo + p < n_rows; p += T) {
    const int32_t v = counts_in[lo + p];
    const uint32_t key = key_of(v);
    counts_out[lo + p] = key > P || (key == P && p <= last) ? 0 : v;
  }
}

long long next_pow2(long long x) {
  long long p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <int W, int G>
cudaError_t launch_select(const int32_t* src, int32_t* dst, int32_t* ids,
                          long long n_rows, long long n_seg, int seg, int k,
                          cudaStream_t s) {
  constexpr int kTeams = W == 1 ? kWarpTeams : 1;
  int max_sort = 1;
  while (max_sort < k) max_sort <<= 1;
  const size_t smem = (size_t)kTeams * max_sort * sizeof(unsigned long long);
  if (smem > (size_t)kSmemWithoutOptIn) {
    cudaError_t e = cudaFuncSetAttribute(
        tracker_select_kernel<W, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int vec_ok = ((uintptr_t)src % 16 == 0) && ((uintptr_t)dst % 16 == 0);
  const unsigned blocks = (unsigned)((n_seg + kTeams - 1) / kTeams);
  tracker_select_kernel<W, G><<<blocks, 32 * W * kTeams, smem, s>>>(
      src, dst, ids, n_rows, n_seg, seg, k, max_sort, vec_ok);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch the select needs, in 64-bit words: the wide path's sort area
// (a power of two >= k a segment), none for seg <= 16384.
long long tracker_select_scratch_words(long long n_rows, int seg, int k) {
  if (seg <= kWideMaxSeg) return 0;
  return (n_rows + seg - 1) / seg * next_pow2(k);
}

// counts (n_rows,) i32 -> new_counts (n_rows,) i32 and ids (n_seg*k,) i32.
// pending (n_pending,) i32 ids are folded in first (may be 0 long).
// 1 <= k <= seg; scratch holds tracker_select_scratch_words(n_rows, seg, k)
// words (may be null where that is 0).
int tracker_select(const void* counts, const void* pending, long long n_pending,
                   void* new_counts, void* ids, void* scratch,
                   long long n_rows, int seg, int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long n_seg = (n_rows + seg - 1) / seg;
  const int32_t* src = (const int32_t*)counts;
  if (n_pending > 0) {
    // the fold must not touch the caller's counters: fold into the output
    // and select in place from there (each team owns its segment)
    cudaMemcpyAsync(new_counts, counts, n_rows * sizeof(int32_t),
                    cudaMemcpyDeviceToDevice, s);
    unsigned blocks = (unsigned)((n_pending + kFoldThreads - 1) / kFoldThreads);
    tracker_fold_kernel<<<blocks, kFoldThreads, 0, s>>>(
        (int32_t*)new_counts, (const int32_t*)pending, n_pending, n_rows);
    src = (const int32_t*)new_counts;
  }
  if (n_seg == 0) return (int)cudaGetLastError();
  int32_t* dst = (int32_t*)new_counts;
  int32_t* out = (int32_t*)ids;
  cudaError_t e;
  if (seg <= 128)       e = launch_select<1, 1>(src, dst, out, n_rows, n_seg, seg, k, s);
  else if (seg <= 256)  e = launch_select<1, 2>(src, dst, out, n_rows, n_seg, seg, k, s);
  else if (seg <= 512)  e = launch_select<1, 4>(src, dst, out, n_rows, n_seg, seg, k, s);
  else if (seg <= 1024) e = launch_select<2, 4>(src, dst, out, n_rows, n_seg, seg, k, s);
  else if (seg <= 2048) e = launch_select<4, 4>(src, dst, out, n_rows, n_seg, seg, k, s);
  else if (seg <= 4096) e = launch_select<8, 4>(src, dst, out, n_rows, n_seg, seg, k, s);
  else if (seg <= 8192) e = launch_select<16, 4>(src, dst, out, n_rows, n_seg, seg, k, s);
  else if (seg <= kWideMaxSeg) e = launch_select<32, 4>(src, dst, out, n_rows, n_seg, seg, k, s);
  else {
    tracker_select_wide_kernel<<<(unsigned)n_seg, kWideThreads, 0, s>>>(
        src, dst, out, (unsigned long long*)scratch, n_rows, seg, k,
        (int)next_pow2(k));
    e = cudaGetLastError();
  }
  return (int)e;
}

}  // extern "C"
