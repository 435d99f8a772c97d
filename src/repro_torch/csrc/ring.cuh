// Building blocks shared by the RG-LRU scan kernels (rglru_scan.cu and
// rglru_scan_backward.cu): element conversions, cp.async copies into a
// ring of shared-memory tiles, mbarriers that announce and hand back the
// ring's slots, the widest copy a set of rows allows, and the plan that
// spreads a (B, S, w) scan's channels over the SMs.  Each including source
// is its own library, so everything here has internal linkage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of `bytes` (<= VEC) source bytes into a VEC-byte slot; the
// rest of the slot is zero-filled.
template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const uint32_t d = smem_addr(dst);
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(VEC), "r"(bytes));
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// One arrival on `bar` once this thread's cp.async copies so far have
// landed.
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Elements a copy of a tile row: VEC bytes, or one element (plain loads).
template <typename T, int VEC>
__host__ __device__ constexpr int per_copy() {
  return VEC > 0 ? VEC / (int)sizeof(T) : 1;
}

// The widest copy (16 or 4 bytes; 0 = element by element) that every row
// starts aligned to.  `bits`: the base pointers and the row stride in
// bytes, or-ed together.  Block columns start at multiples of 8 elements,
// so these decide.
inline int vec_bytes(uintptr_t bits) {
  return (bits & 15) == 0 ? 16 : (bits & 3) == 0 ? 4 : 0;
}

// The device and its SM count (cached per device).
inline cudaError_t current_sms(int* dev, int* n_sm) {
  constexpr int kMaxDev = 64;
  static int sms[kMaxDev];
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  *n_sm = *dev < kMaxDev ? sms[*dev] : 0;
  if (*n_sm == 0) {
    e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, *dev);
    if (e != cudaSuccess) return e;
    if (*dev < kMaxDev) sms[*dev] = *n_sm;
  }
  return cudaSuccess;
}

// Channels a block (a multiple of 8, at most max_chains) so that the B *
// ceil(w / C) blocks cover the SMs about once.
inline int plan_channels(int B, int w, int n_sm, int max_chains) {
  const int per_row = n_sm / B > 0 ? n_sm / B : 1;
  int C = (w + per_row - 1) / per_row;
  C = (C + 7) / 8 * 8;
  return C > max_chains ? max_chains : C;
}

}  // namespace
