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
//     db_t = g_t,   da_t = g_t * h_{t-1}   (da_0 = 0)
// with the product rounded before the sum (no contraction into an FMA),
// as the plain version's separate operations round, so da and db (in a's
// dtype) equal it bit for bit.
//
// Bound on this card: bytes.  The function reads a, h and dh and writes da
// and db once each: 5 * B * S * w * itemsize, 210 MB at the training
// shape (8, 512, 2560) in f32, 0.063 ms at 3.35 TB/s.  Every step of a
// chain depends on the one before, and B * w chains are all the
// parallelism there is (20,480 at the training shape, 5,120 at (2, 4096,
// 2560)): what sets the time is how many bytes are in flight while the
// chains run, and how few instructions a step costs.
//
// Design: the forward's (rglru_scan.cu), run downward in time.  A block
// owns C adjacent channels of one batch row (C a multiple of 8, planned so
// that the B * ceil(w / C) blocks cover the SMs once: 160 channels, 128
// blocks at (8, 512, 2560); 40 channels, 128 blocks at (2, 4096, 2560)),
// one chain thread a channel, plus four loader warps and four storer
// warps.  Time is cut into tiles of kT steps (64 x 64, or 16 x 256 for
// blocks of more than 64 channels: the layout is fixed at compile time, so
// every shared-memory address in a tile is a constant offset).
//  - The loaders keep a ring of kStages input tiles full with cp.async,
//    from the last tile down to the first: a_t, dh_t and h_{t-1} (the h
//    rows one step below, so the chain reads all three at one offset; h_0's
//    row below does not exist and is not read).  Copies are 16 or 4 bytes
//    where the rows' alignment allows (vec_bytes), else element loads.  A
//    tile is announced on a "full" mbarrier once its copies land and
//    handed back on an "empty" one once the chains have read it.  The
//    chains never issue a copy.
//  - The chains walk each tile from its last row to its first, each group
//    of kGroup steps' a, dh and h read while the previous group runs, and
//    write da and db into one of kOutStages output tiles in shared memory
//    (announced on "ofull" once written).
//  - The storers copy each output tile to device memory as whole rows of
//    16-byte (or 4-byte, or element) stores, then hand the tile back on
//    "oempty".  So no warp stores a step's 32 channels by itself: in bf16
//    those were 64-byte half lines, two a step.
// Shared memory, f32: kStages * 3 input tiles + kOutStages * 2 output
// tiles of 4,096 elements each = (3 * 3 + 2 * 2) * 16 KB = 208 KB, plus
// 128 bytes of mbarriers: 213,120 bytes of the 232,448 a block may have
// (bf16: 106,624).  Two input tiles are in flight while the chains read
// the third (30 KB of copies each in f32 at the 40 and 160 channels of the
// shapes above).  Deeper rings measured no faster on the H100 (4 input
// tiles and 1 output tile in f32, 6 and 2 in bf16; bf16 at (2, 4096, 2560)
// took twice as long: PERF.md section 6).

#include "ring.cuh"

namespace {

constexpr int kStages = 3;          // input tiles in the ring
constexpr int kOutStages = 2;       // output tiles staged for the storers
constexpr int kGroup = 8;           // chain steps read from a tile at once
constexpr int kLoaders = 128;       // loader threads a block (four warps)
constexpr int kStorers = 128;       // storer threads a block (four warps)
constexpr int kMaxChains = 256;     // channels (chain threads) a block holds
constexpr int kBarBytes = 128;      // the mbarriers, before the tiles
constexpr int kMaxDev = 64;

template <int R>
__host__ __device__ constexpr int tile_steps() { return R == 64 ? 64 : 16; }

// The rows a thread copies of a tile's rows [0, tn) and columns [0, cn),
// VEC-byte chunks (or elements): column chunks k0, k0 + kstep, ... of
// rows r0, r0 + rstep, ... with `threads` threads sharing a tile.
template <typename T, int VEC>
struct Share {
  int k0, kstep, r0, rstep;
  __device__ Share(int lt, int cn, int threads, int kT) {
    constexpr int E = per_copy<T, VEC>();
    const int per_row = (cn + E - 1) / E;
    kstep = min(per_row, threads);
    rstep = threads / kstep;
    k0 = lt % kstep;
    r0 = lt < rstep * kstep ? lt / kstep : kT;   // idle when past the rows
  }
};

// Issue one thread's copies of rows [first, tn) of a tile of `src` (tile
// row tt at element offset base + tt * w) into `dst` (rows `R` elements
// apart); columns [0, cn).  VEC = 0: element loads.
template <typename T, int VEC, int R>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          long long base, int first, int tn,
                                          int cn, int w, const Share<T, VEC>& m,
                                          T* dst) {
  constexpr int E = per_copy<T, VEC>();
  for (int tt = m.r0; tt < tn; tt += m.rstep) {
    if (tt < first) continue;
    for (int col = m.k0 * E; col < cn; col += m.kstep * E) {
      const T* p = src + (base + (long long)tt * w + col);
      if constexpr (VEC > 0) {
        cp_async<VEC>(dst + tt * R + col, p,
                      min(E, cn - col) * (int)sizeof(T));
      } else {
        dst[tt * R + col] = *p;
      }
    }
  }
}

// One thread's stores of rows [0, tn) of an output tile `src` (rows R
// elements apart) to `dst` (tile row tt at element offset base + tt * w).
// With VEC > 0 every row is whole chunks: VEC = 16 takes rows of a
// multiple of 16 bytes and a block's first column is a multiple of 8
// elements, so cn is a multiple of the chunk (VEC = 4: bf16 rows of even
// w, f32 chunks of one element).
template <typename T, int VEC, int R>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           long long base, int tn, int cn,
                                           int w, const Share<T, VEC>& m,
                                           const T* src) {
  constexpr int E = per_copy<T, VEC>();
  for (int tt = m.r0; tt < tn; tt += m.rstep) {
    for (int col = m.k0 * E; col < cn; col += m.kstep * E) {
      T* p = dst + (base + (long long)tt * w + col);
      const T* q = src + tt * R + col;
      if constexpr (VEC == 16) {
        *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(q);
      } else if constexpr (VEC == 4) {
        *reinterpret_cast<uint32_t*>(p) =
            *reinterpret_cast<const uint32_t*>(q);
      } else {
        *p = *q;
      }
    }
  }
}

// One step of a chain, at tile row tt: g = a_{t+1} * g + dh_t, the product
// rounded before the sum; db_t = g, da_t = g * h_{t-1}.
template <typename T, int R>
__device__ __forceinline__ void step(float a, float d, float hp, float& g,
                                     float& a_next, T* oda, T* odb, int tt) {
  g = __fadd_rn(__fmul_rn(a_next, g), d);
  store(odb + tt * R, g);
  store(oda + tt * R, __fmul_rn(g, hp));
  a_next = a;
}

// A whole tile of one chain (its a, dh and h R elements apart), from the
// last row down, unrolled: each group of kGroup steps' inputs are read
// before the previous group runs.
template <typename T, int R>
__device__ __forceinline__ void chain_tile(const T* sa, const T* sd,
                                           const T* sh, float& g,
                                           float& a_next, T* oda, T* odb) {
  constexpr int kT = tile_steps<R>();
  float xa[kGroup], xd[kGroup], xh[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int tt = kT - 1 - u;
    xa[u] = to_f32(sa[tt * R]);
    xd[u] = to_f32(sd[tt * R]);
    xh[u] = to_f32(sh[tt * R]);
  }
#pragma unroll
  for (int t = 0; t < kT; t += kGroup) {
    float ya[kGroup], yd[kGroup], yh[kGroup];
    if (t + kGroup < kT) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int tt = kT - 1 - (t + kGroup + u);
        ya[u] = to_f32(sa[tt * R]);
        yd[u] = to_f32(sd[tt * R]);
        yh[u] = to_f32(sh[tt * R]);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      step<T, R>(xa[u], xd[u], xh[u], g, a_next, oda, odb, kT - 1 - t - u);
    if (t + kGroup < kT) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        xa[u] = ya[u];
        xd[u] = yd[u];
        xh[u] = yh[u];
      }
    }
  }
}

template <typename T, int VEC, int R>
__global__ void __launch_bounds__(kMaxChains + kLoaders + kStorers)
    rglru_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                          const T* __restrict__ dh, T* __restrict__ da,
                          T* __restrict__ db, int S, int w, int C, int G) {
  constexpr int kT = tile_steps<R>();
  constexpr int kTile = kT * R;                  // elements of one array
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // input i landed
  uint64_t* empty = full + kStages;                     // input i read
  uint64_t* ofull = empty + kStages;                    // output i written
  uint64_t* oempty = ofull + kOutStages;                // output i stored
  T* ring = reinterpret_cast<T*>(smem + kBarBytes);     // [kStages][3][kT][R]
  T* out = ring + kStages * 3 * kTile;             // [kOutStages][2][kT][R]
  const int batch = blockIdx.x / G, grp = blockIdx.x - batch * G;
  const int c0 = grp * C, cn = min(C, w - c0);
  const int chains = blockDim.x - kLoaders - kStorers;  // chain threads
  const long long row0 = (long long)batch * S * w + c0;
  const int n_tiles = (S + kT - 1) / kT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kLoaders);
      mbar_init(empty + s, chains);
    }
    for (int o = 0; o < kOutStages; ++o) {
      mbar_init(ofull + o, chains);
      mbar_init(oempty + o, kStorers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The i-th tile walked is tile n_tiles - 1 - i: steps [t0, t0 + tn).
  if (threadIdx.x >= chains + kStorers) {       // loaders: keep the ring full
    const Share<T, VEC> m(threadIdx.x - chains - kStorers, cn, kLoaders, kT);
#pragma unroll 1
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(empty + s, (i / kStages - 1) & 1);
      const int t0 = (n_tiles - 1 - i) * kT, tn = min(kT, S - t0);
      const long long base = row0 + (long long)t0 * w;
      T* sa = ring + s * 3 * kTile;
      load_rows<T, VEC, R>(a, base, 0, tn, cn, w, m, sa);
      load_rows<T, VEC, R>(dh, base, 0, tn, cn, w, m, sa + kTile);
      // h_{t-1}: the rows one step below; none below step 0
      load_rows<T, VEC, R>(h, base - w, t0 == 0 ? 1 : 0, tn, cn, w, m,
                           sa + 2 * kTile);
      if constexpr (VEC > 0) mbar_arrive_on_copies(full + s);
      else mbar_arrive(full + s);
    }
    if constexpr (VEC > 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  if (threadIdx.x >= chains) {                  // storers: drain the outputs
    const Share<T, VEC> m(threadIdx.x - chains, cn, kStorers, kT);
#pragma unroll 1
    for (int i = 0; i < n_tiles; ++i) {
      const int o = i % kOutStages;
      mbar_wait(ofull + o, (i / kOutStages) & 1);
      const int t0 = (n_tiles - 1 - i) * kT, tn = min(kT, S - t0);
      const long long base = row0 + (long long)t0 * w;
      const T* so = out + o * 2 * kTile;
      store_rows<T, VEC, R>(da, base, tn, cn, w, m, so);
      store_rows<T, VEC, R>(db, base, tn, cn, w, m, so + kTile);
      mbar_arrive(oempty + o);
    }
    return;
  }

  const int j = threadIdx.x;                    // chains: one channel each
  // g_{S+1} = -0 and a_{S+1} = 0 make the first step's g exactly dh_{S-1}
  // (-0 + x is x for every x, zeros of either sign included)
  float g = -0.f, a_next = 0.f;
#pragma unroll 1
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages, o = i % kOutStages;
    mbar_wait(full + s, (i / kStages) & 1);
    if (i >= kOutStages) mbar_wait(oempty + o, (i / kOutStages - 1) & 1);
    const int t0 = (n_tiles - 1 - i) * kT, tn = min(kT, S - t0);
    const T* sa = ring + s * 3 * kTile + j;
    T* oda = out + o * 2 * kTile + j;
    if (j < cn) {
      if (tn == kT) {
        chain_tile<T, R>(sa, sa + kTile, sa + 2 * kTile, g, a_next, oda,
                         oda + kTile);
      } else {
        for (int tt = tn - 1; tt >= 0; --tt)
          step<T, R>(to_f32(sa[tt * R]), to_f32(sa[kTile + tt * R]),
                     to_f32(sa[2 * kTile + tt * R]), g, a_next, oda,
                     oda + kTile, tt);
      }
      // step 0 took h's unloaded row below it: da_0 is 0
      if (t0 == 0) store(oda, 0.f);
    }
    mbar_arrive(empty + s);
    mbar_arrive(ofull + o);
  }
}

template <typename T, int VEC, int R>
int launch(const void* a, const void* h, const void* dh, void* da, void* db,
           int S, int w, int C, int G, long long blocks, int dev,
           cudaStream_t s) {
  static bool opted[kMaxDev];
  constexpr size_t smem = kBarBytes + (size_t)(kStages * 3 + kOutStages * 2) *
                                          tile_steps<R>() * R * sizeof(T);
  auto kernel = rglru_scan_bwd_kernel<T, VEC, R>;
  if (dev >= kMaxDev || !opted[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDev) opted[dev] = true;
  }
  const int threads = (C + 31) / 32 * 32 + kLoaders + kStorers;
  kernel<<<(unsigned)blocks, threads, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(dh), static_cast<T*>(da), static_cast<T*>(db), S,
      w, C, G);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_layout(const void* a, const void* h, const void* dh, void* da,
                  void* db, int B, int S, int w, int dev, int n_sm,
                  cudaStream_t s) {
  const int C = plan_channels(B, w, n_sm, kMaxChains);
  const int G = (w + C - 1) / C;
  const long long blocks = (long long)B * G;
  if (C <= 64)
    return launch<T, VEC, 64>(a, h, dh, da, db, S, w, C, G, blocks, dev, s);
  return launch<T, VEC, 256>(a, h, dh, da, db, S, w, C, G, blocks, dev, s);
}

template <typename T>
int launch_vec(const void* a, const void* h, const void* dh, void* da,
               void* db, int B, int S, int w, int dev, int n_sm,
               cudaStream_t s) {
  const uintptr_t bits = (uintptr_t)a | (uintptr_t)h | (uintptr_t)dh |
                         (uintptr_t)da | (uintptr_t)db |
                         (uintptr_t)((long long)w * sizeof(T));
  switch (vec_bytes(bits)) {
    case 16:
      return launch_layout<T, 16>(a, h, dh, da, db, B, S, w, dev, n_sm, s);
    case 4:
      return launch_layout<T, 4>(a, h, dh, da, db, B, S, w, dev, n_sm, s);
    default:
      return launch_layout<T, 0>(a, h, dh, da, db, B, S, w, dev, n_sm, s);
  }
}

}  // namespace

extern "C" {

// a, h, dh, da, db: contiguous (B, S, w), all f32 (bf16 == 0) or all bf16.
// Returns a cudaError_t code (0 on success).  One launch.
int rglru_scan_backward(const void* a, const void* h, const void* dh,
                        void* da, void* db, int B, int S, int w, int bf16,
                        void* stream) {
  if (B <= 0 || S <= 0 || w <= 0) return 0;
  int dev, n_sm;
  const cudaError_t e = current_sms(&dev, &n_sm);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_vec<__nv_bfloat16>(a, h, dh, da, db, B, S, w, dev, n_sm, s);
  return launch_vec<float>(a, h, dh, da, db, B, S, w, dev, n_sm, s);
}

}  // extern "C"
