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

// counts (n_rows,) i32 -> new_counts (n_rows,) i32 and ids (n_seg*k,) i32.
// pending (n_pending,) i32 ids are folded in first (may be 0 long).
// 1 <= k <= seg <= 16384 (32 warps x 32 lanes x 16 counters).
int tracker_select(const void* counts, const void* pending, long long n_pending,
                   void* new_counts, void* ids, long long n_rows, int seg,
                   int k, void* stream) {
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
  else if (seg <= 16384) e = launch_select<32, 4>(src, dst, out, n_rows, n_seg, seg, k, s);
  else e = cudaErrorInvalidValue;
  return (int)e;
}

}  // extern "C"
