// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rglru_scan.py, function rglru_scan (the
// Pallas kernel: grid (B, w/bw, S/bs), time innermost and sequential, the
// f32 carry in VMEM scratch, an associative scan inside each time block).
//
// Contract (src/repro/kernels/ref.py rglru_scan): a, b (B, S, w) of one
// dtype (f32 or bf16), h_0 = 0, the carry in f32, h_t = a_t * h_{t-1} +
// b_t with the product rounded before the sum (as the plain version's two
// separate operations round), the output (B, S, w) in a's dtype, bit for
// bit.  So each (batch, channel) keeps one sequential chain in that order:
// a chunked two-pass scan would reassociate the products and change the
// last bits.
//
// Bound on this card: bytes.  The function reads a and b and writes h
// once each: 3 * B * S * w * itemsize, 251.7 MB at the RecurrentGemma-2B
// prefill shape (2, 4096, 2560) in f32, 0.075 ms at 3.35 TB/s.  But B * w
// = 5,120 chains of S = 4,096 dependent steps each are all the
// parallelism there is, and every step of a chain is a few instructions
// on one thread: what sets the time is how few cycles a step costs and
// how far ahead of the chains the loads run.
//
// Design: a block owns C adjacent channels of one batch row (C a multiple
// of 8, chosen so that the B * ceil(w / C) blocks cover the SMs once:
// 40 channels, 128 blocks at the prefill shape), one chain thread a
// channel, plus four loader warps.  The loaders keep a ring of kStages
// time tiles (kT steps x R channels of a and b) full with cp.async (16 or
// 4 bytes a copy, whichever the rows' alignment allows; the ragged end
// of a row is a copy of fewer source bytes; rows that are not 4-byte
// aligned, bf16 with odd w, take plain loads), each tile announced on an
// mbarrier once its copies land and handed back on another once the
// chains have read it.  The chains never issue a copy.  The tile's layout
// is fixed at compile time (64 x 64, or 16 x 256 for blocks of more than
// 64 channels), so every shared-memory read is a constant offset and a
// whole tile is one unrolled, branch-free run of steps, each group of 8
// steps' a and b read while the previous group runs.  Each step's h goes
// straight to device memory: a warp's 32 adjacent channels are one
// contiguous store.  The ring's helpers are in ring.cuh, shared with the
// backward (rglru_scan_backward.cu).

#include "ring.cuh"

namespace {

constexpr int kStages = 4;          // tiles in the ring (kStages - 1 in flight)
constexpr int kGroup = 8;           // chain steps read from a tile at once
constexpr int kLoaders = 128;       // loader threads a block (four warps)
constexpr int kMaxChains = 256;     // channels (chain threads) a block holds
constexpr int kBarBytes = 128;      // the ring's mbarriers, before the ring
constexpr int kMaxDev = 64;

// A tile is kT(R) time steps of rows R elements apart (R >= the block's
// channels): 64 x 64 or 16 x 256, so the ring is 128 KB in f32, 64 KB in
// bf16, and every shared-memory address in a tile is a constant offset.
template <int R>
__host__ __device__ constexpr int tile_steps() { return R == 64 ? 64 : 16; }

// Issue one loader thread's copies of a tile: rows [t0, t0 + tn) of
// channels [c0, c0 + cn) of a and b (element offset `base` = (batch * S +
// t0) * w + c0) into the tile's a and b halves, rows `row` elements
// apart.  The thread copies column chunks k0, k0 + kstep, ... of rows r0,
// r0 + rstep, ...  VEC = 0: plain loads.
template <typename T, int VEC>
__device__ __forceinline__ void load_tile(const T* __restrict__ a,
                                          const T* __restrict__ b,
                                          long long base, int tn, int cn,
                                          int w, int row, int k0,
                                          int kstep, int r0, int rstep,
                                          T* sa, T* sb) {
  constexpr int E = per_copy<T, VEC>();
  for (int tt = r0; tt < tn; tt += rstep) {
    for (int col = k0 * E; col < cn; col += kstep * E) {
      const long long src = base + (long long)tt * w + col;
      const int dst = tt * row + col;
      if constexpr (VEC > 0) {
        const int bytes = min(E, cn - col) * (int)sizeof(T);
        cp_async<VEC>(sa + dst, a + src, bytes);
        cp_async<VEC>(sb + dst, b + src, bytes);
      } else {
        sa[dst] = a[src];
        sb[dst] = b[src];
      }
    }
  }
}

// One step of a chain: h = a * h + b, the product rounded before the sum.
template <typename T>
__device__ __forceinline__ void step(float a, float b, float& carry, T*& o,
                                     int w) {
  carry = __fadd_rn(__fmul_rn(a, carry), b);
  store(o, carry);
  o += w;
}

// A whole tile of one chain (its a and b R elements apart), unrolled: each
// group of kGroup steps' a and b are read before the previous group runs.
template <typename T, int R>
__device__ __forceinline__ void chain_tile(const T* sa, const T* sb,
                                           float& carry, T*& o, int w) {
  constexpr int kT = tile_steps<R>();
  float xa[kGroup], xb[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    xa[u] = to_f32(sa[u * R]);
    xb[u] = to_f32(sb[u * R]);
  }
#pragma unroll
  for (int t = 0; t < kT; t += kGroup) {
    float ya[kGroup], yb[kGroup];
    if (t + kGroup < kT) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        ya[u] = to_f32(sa[(t + kGroup + u) * R]);
        yb[u] = to_f32(sb[(t + kGroup + u) * R]);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) step(xa[u], xb[u], carry, o, w);
    if (t + kGroup < kT) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        xa[u] = ya[u];
        xb[u] = yb[u];
      }
    }
  }
}

template <typename T, int VEC, int R>
__global__ void __launch_bounds__(kMaxChains + kLoaders)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ h, int S, int w, int C, int G) {
  constexpr int kT = tile_steps<R>();
  constexpr int kTile = kT * R;                         // elements of a (or b)
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // tile s landed
  uint64_t* empty = full + kStages;                     // tile s consumed
  T* ring = reinterpret_cast<T*>(smem + kBarBytes);     // [kStages][2][kT][R]
  const int batch = blockIdx.x / G, g = blockIdx.x - batch * G;
  const int c0 = g * C, cn = min(C, w - c0);
  const int chains = blockDim.x - kLoaders;             // chain threads
  const long long row0 = (long long)batch * S * w + c0;
  const int n_tiles = (S + kT - 1) / kT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kLoaders);
      mbar_init(empty + s, chains);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= chains) {          // loader warps: keep the ring full
    const int lt = threadIdx.x - chains;
    const int per_row = (cn + per_copy<T, VEC>() - 1) / per_copy<T, VEC>();
    const int kstep = min(per_row, kLoaders), rstep = kLoaders / kstep;
    const int k0 = lt % kstep, r0 = lt < rstep * kstep ? lt / kstep : kT;
#pragma unroll 1
    for (int k = 0; k < n_tiles; ++k) {
      const int s = k % kStages;
      if (k >= kStages) mbar_wait(empty + s, (k / kStages - 1) & 1);
      T* sa = ring + s * 2 * kTile;
      const int t0 = k * kT;
      load_tile<T, VEC>(a, b, row0 + (long long)t0 * w, min(kT, S - t0), cn,
                        w, R, k0, kstep, r0, rstep, sa, sa + kTile);
      if constexpr (VEC > 0) mbar_arrive_on_copies(full + s);
      else mbar_arrive(full + s);
    }
    if constexpr (VEC > 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int j = threadIdx.x;            // chain threads: one channel each
  float carry = 0.f;
  T* o = h + row0 + j;
#pragma unroll 1
  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % kStages;
    mbar_wait(full + s, (k / kStages) & 1);
    const T* sa = ring + s * 2 * kTile + j;
    const T* sb = sa + kTile;
    const int tn = min(kT, S - k * kT);
    if (j < cn) {
      if (tn == kT) {
        chain_tile<T, R>(sa, sb, carry, o, w);
      } else {
        for (int t = 0; t < tn; ++t)
          step(to_f32(sa[t * R]), to_f32(sb[t * R]), carry, o, w);
      }
    }
    mbar_arrive(empty + s);
  }
}

template <typename T, int VEC, int R>
int launch(const void* a, const void* b, void* h, int S, int w, int C, int G,
           long long blocks, int dev, cudaStream_t s) {
  static bool opted[kMaxDev];
  constexpr size_t smem =
      kBarBytes + (size_t)kStages * 2 * tile_steps<R>() * R * sizeof(T);
  auto kernel = rglru_scan_kernel<T, VEC, R>;
  if (dev >= kMaxDev || !opted[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDev) opted[dev] = true;
  }
  const int threads = (C + 31) / 32 * 32 + kLoaders;
  kernel<<<(unsigned)blocks, threads, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      S, w, C, G);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_layout(const void* a, const void* b, void* h, int B, int S, int w,
                  int dev, int n_sm, cudaStream_t s) {
  const int C = plan_channels(B, w, n_sm, kMaxChains);
  const int G = (w + C - 1) / C;
  const long long blocks = (long long)B * G;
  if (C <= 64)
    return launch<T, VEC, 64>(a, b, h, S, w, C, G, blocks, dev, s);
  return launch<T, VEC, 256>(a, b, h, S, w, C, G, blocks, dev, s);
}

template <typename T>
int launch_vec(const void* a, const void* b, void* h, int B, int S, int w,
               int dev, int n_sm, cudaStream_t s) {
  const uintptr_t bits = (uintptr_t)a | (uintptr_t)b |
                         (uintptr_t)((long long)w * sizeof(T));
  switch (vec_bytes(bits)) {
    case 16: return launch_layout<T, 16>(a, b, h, B, S, w, dev, n_sm, s);
    case 4: return launch_layout<T, 4>(a, b, h, B, S, w, dev, n_sm, s);
    default: return launch_layout<T, 0>(a, b, h, B, S, w, dev, n_sm, s);
  }
}

}  // namespace

extern "C" {

// a, b, h: contiguous (B, S, w), all f32 (bf16 == 0) or all bf16.
// Returns a cudaError_t code (0 on success).  One launch.
int rglru_scan(const void* a, const void* b, void* h, int B, int S, int w,
               int bf16, void* stream) {
  if (B <= 0 || S <= 0 || w <= 0) return 0;
  int dev, n_sm;
  const cudaError_t e = current_sms(&dev, &n_sm);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_vec<__nv_bfloat16>(a, b, h, B, S, w, dev, n_sm, s);
  return launch_vec<float>(a, b, h, B, S, w, dev, n_sm, s);
}

}  // extern "C"
