"""What the card's warp-level tensor-core path (``mma.sync``) delivers in
TF32, the path of the f32 attention kernels (``csrc/tf32x3.cuh``).

    PYTHONPATH=src python -m repro_torch.launch.profile_mma_peak

Builds a small probe with ``nvcc`` into ``build/repro_torch/mma_peak/``
and prints the card's name and power limit, then the rate of
``mma.sync.m16n8k8`` TF32 products from registers (8 independent
accumulator chains a warp, one CTA an SM at 4, 8 and 16 warps), the
rate of ``cvt.rna.tf32.f32`` and of the integer rounding the kernels use
instead, each in warp instructions a second per SM.  A 3xTF32 product
costs three TF32 products, so f32-accurate attention can run at most at
a third of the first rate.  Needs a GPU and the CUDA toolkit.
"""
from __future__ import annotations

import subprocess

from repro_torch.kernels import _build

SOURCE = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                 "r"(b[1]));
}
__global__ void mma_loop(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, 3, 4}, b[2] = {5, threadIdx.x};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) mma(d[c], a, b);
  float s = 0;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <bool CVT>
__global__ void round_loop(float* out, int iters) {
  float x = threadIdx.x * 1.1f;
  uint32_t acc = 0;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      uint32_t h;
      if (CVT) asm volatile("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(x + u));
      else h = (__float_as_uint(x + u) + 0x1000u) & 0xffffe000u;
      acc ^= h;
    }
    x += 1.f;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
template <typename F>
float ms_of(F launch) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  launch(16); cudaDeviceSynchronize();
  cudaEventRecord(e0); launch(4096); cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}
int main() {
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out; cudaMalloc(&out, sms * 512 * 4);
  for (int w : {4, 8, 16}) {
    float ms = ms_of([&](int n) { mma_loop<<<sms, w * 32>>>(out, n); });
    printf("mma.sync m16n8k8 tf32, %d warps an SM: %.1f TFLOP/s\n", w,
           2048.0 * 8 * 4096 * w * sms / ms / 1e9);
  }
  for (int w : {8, 16}) {
    float a = ms_of([&](int n) { round_loop<true><<<sms, w * 32>>>(out, n); });
    float b = ms_of([&](int n) { round_loop<false><<<sms, w * 32>>>(out, n); });
    printf("%d warps an SM: cvt.rna.tf32 %.2f, integer rounding %.2f G "
           "roundings (warp instructions) a second per SM\n", w,
           8.0 * 4096 * w / a / 1e6, 8.0 * 4096 * w / b / 1e6);
  }
  printf("%s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
"""


def main() -> None:
    out = _build.BUILD_ROOT / "mma_peak"
    out.mkdir(parents=True, exist_ok=True)
    src, exe = out / "mma_peak.cu", out / "mma_peak"
    src.write_text(SOURCE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                       "-fPIC")]
    subprocess.run([_build._nvcc(), *flags, "-o", str(exe), str(src)],
                   check=True, capture_output=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
