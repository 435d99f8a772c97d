// Flash attention (forward), f32, for Hopper (sm_90a): online softmax over
// key tiles with causal / sliding-window masks, the gemma2 logit softcap
// and GQA/MQA (kv head = h / group), queries right-aligned to the KV tail.
// bf16 inputs go to the tensor-core kernel of flash_attention_bf16.cu; f32
// stays on the CUDA cores, so its products are f32 FMAs (no TF32).
//
// Replaces: src/repro/kernels/flash_attention.py, function flash_attention
// (the Pallas kernel: grid (B, Hq, Sq/bq, Skv/bk), the running (m, l, acc)
// in VMEM scratch across the sequential KV grid steps).
//
// Contract (that kernel's _kernel and src/repro/kernels/ref.py
// flash_attention): q scaled by 1/sqrt(hd) in f32; s = q.k in f32;
// optionally s = tanh(s / cap) * cap; query i sits at position
// i + Skv - Sq, key j at j; causal keeps j <= pos(i), a window w keeps
// pos(i) - j < w; masked scores take no part (p = 0); the output is
// acc / max(l, 1e-30) cast to q's dtype.  Skv >= Sq, so every query row
// sees at least one key.  Given an lse pointer, each row's log-sum-exp
// m + log(max(l, 1e-30)) goes there (f32, (B, Hq, Sq)) for the backward.
//
// Design: one CTA per (query tile of 8 rows per warp, head, batch).  The
// Pallas grid's sequential KV axis becomes a loop inside the CTA, which
// runs only over the key tiles the causal / window mask touches (the TPU
// kernel still DMAs the masked ones).  Q (pre-scaled), the K tile and the
// V tile sit in shared memory as f32; heads that share a KV head read the
// same K/V bytes, which L2 serves (heads are the fastest grid axis, so
// they run side by side).  In Q.K^T each lane owns one key of the 32-key
// tile and each warp 8 query rows: a row's softmax statistics are a warp
// reduction.  In P.V each lane owns hd/32 output columns of the warp's 8
// rows, so the (8 x hd) f32 accumulator stays in registers.  Products are
// f32 FMAs on the CUDA cores.
//
// Bound on this card: operations.  The unmasked band of (query, key)
// pairs needs 4 * hd flops each (Q.K^T and P.V); at the RecurrentGemma-2B
// prefill shape that is 128.9 GFLOP, 1.93 ms at the f32 FMA peak
// (67 TFLOP/s).  Shared memory bandwidth: Q.K^T issues one conflict-free
// 16-byte K load and 8 broadcast Q loads per 32 FMAs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;          // query rows per warp
constexpr int kBK = 32;           // keys per tile: one per lane in Q.K^T
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

struct Strides {  // element strides of (batch, head, seq); hd is contiguous
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// One 16-byte load as 4 f32 values.
__device__ __forceinline__ void unpack(const uint4& w, float* out, float) {
  out[0] = __uint_as_float(w.x);
  out[1] = __uint_as_float(w.y);
  out[2] = __uint_as_float(w.z);
  out[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// rows x HD elements (row stride `stride`) -> shared f32 [rows][LD], each
// times `mul`; rows at or past `valid` are zero-filled.  16-byte loads.
template <typename T, int HD, int LD, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int rows,
                                          int valid, float mul) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int idx = threadIdx.x; idx < rows * kPerRow; idx += THREADS) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    float vals[kVec];
    if (r < valid) {
      unpack(__ldg(reinterpret_cast<const uint4*>(src + r * stride + c)),
             vals, T());
#pragma unroll
      for (int j = 0; j < kVec; ++j) vals[j] *= mul;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) vals[j] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * LD + c);
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j) {
      d[j] = make_float4(vals[4 * j], vals[4 * j + 1], vals[4 * j + 2],
                         vals[4 * j + 3]);
    }
  }
}

template <int HD, int WARPS>
constexpr int smem_bytes() {
  return 4 * (WARPS * kRows * HD + kBK * (HD + 4) + kBK * HD +
              WARPS * kRows * kBK);
}

template <typename T, int HD, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, Strides st, int group, int Sq,
              int Skv, float scale, int causal, int window, float softcap) {
  constexpr int kThreads = WARPS * 32;
  constexpr int kBQ = WARPS * kRows;
  constexpr int kLDK = HD + 4;    // K row pitch: 16-byte lane loads, no conflicts
  constexpr int kCols = HD / 32;  // output columns per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][HD]
  float* Ks = Qs + kBQ * HD;                     // [kBK][kLDK]
  float* Vs = Ks + kBK * kLDK;                   // [kBK][HD]
  float* Ps = Vs + kBK * HD;                     // [kBQ][kBK]

  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  const int hk = h / group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * kRows;
  const int offset = Skv - Sq;  // queries right-aligned to the KV tail

  const T* kp = k + b * st.kb + hk * st.kh;
  const T* vp = v + b * st.vb + hk * st.vh;
  load_tile<T, HD, HD, kThreads>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs,
                                 st.qs, kBQ, min(kBQ, Sq - q0), scale);

  // the keys any row of this tile may see
  const int pos_lo = q0 + offset;
  const int pos_hi = min(q0 + kBQ, Sq) - 1 + offset;
  const int k_end = causal ? min(Skv, pos_hi + 1) : Skv;
  const int k_begin = (window ? max(0, pos_lo - window + 1) : 0) / kBK * kBK;

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();  // the previous tile's readers are done
    const int valid = min(kBK, Skv - kt);
    load_tile<T, HD, kLDK, kThreads>(Ks, kp + kt * st.ks, st.ks, kBK, valid,
                                     1.f);
    load_tile<T, HD, HD, kThreads>(Vs, vp + kt * st.vs, st.vs, kBK, valid,
                                   1.f);
    __syncthreads();

    // s = Q K^T for this warp's rows and this lane's key
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(Ks + lane * kLDK);
#pragma unroll 4
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kk = k4[d4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qq = reinterpret_cast<const float4*>(Qs + (r0 + i) * HD)[d4];
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    // online softmax: one row per register, reduced across the warp
    const int kpos = kt + lane;
    float corr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + r0 + i + offset;
      bool ok = lane < valid;
      if (causal) ok = ok && kpos <= qpos;
      if (window) ok = ok && qpos - kpos < window;
      float x = s[i];
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      float mx = ok ? x : kNegInf;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float p = ok ? expf(x - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ps += __shfl_xor_sync(kFull, ps, off);
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + ps;
      m[i] = m_new;
      Ps[(r0 + i) * kBK + lane] = p;
    }
    __syncwarp();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr[i];
    }
#pragma unroll 2
    for (int j4 = 0; j4 < kBK / 4; ++j4) {
      float4 pp[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pp[i] = reinterpret_cast<const float4*>(Ps + (r0 + i) * kBK)[j4];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j4 * 4 + jj) * HD + lane;
        float vv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) vv[c] = vrow[32 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float pv = jj == 0 ? pp[i].x
                         : jj == 1 ? pp[i].y
                         : jj == 2 ? pp[i].z
                                   : pp[i].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* op = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    if (row < Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
      if (lse != nullptr && lane == 0)
        lse[((long long)b * gridDim.x + h) * Sq + row] = m[i] + logf(denom);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        store(op + row * st.os + lane + 32 * c, acc[i][c] / denom);
      }
    }
  }
}

template <typename T, int HD, int WARPS>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Strides& st, int B, int Hq, int group, int Sq, int Skv,
           float scale, int causal, int window, float softcap,
           cudaStream_t s) {
  constexpr int kBQ = WARPS * kRows;
  constexpr int kSmem = smem_bytes<HD, WARPS>();
  auto kern = flash_fwd<T, HD, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hq, (Sq + kBQ - 1) / kBQ, B);
  kern<<<grid, WARPS * 32, kSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, st, group, Sq, Skv,
      scale,
      causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             float* lse, const Strides& st, int B, int Hq, int group,
             int Sq, int Skv, float scale, int causal, int window,
             float softcap, cudaStream_t s) {
  // 8 warps (64 query rows) per CTA; hd = 256 takes 4 so that two CTAs
  // (2 x 100.5 KB of shared memory) fit on one SM
  switch (hd) {
    case 32:
      return launch<T, 32, 8>(q, k, v, o, lse, st, B, Hq, group, Sq, Skv,
                              scale, causal, window, softcap, s);
    case 64:
      return launch<T, 64, 8>(q, k, v, o, lse, st, B, Hq, group, Sq, Skv,
                              scale, causal, window, softcap, s);
    case 128:
      return launch<T, 128, 8>(q, k, v, o, lse, st, B, Hq, group, Sq, Skv,
                               scale, causal, window, softcap, s);
    case 256:
      return launch<T, 256, 4>(q, k, v, o, lse, st, B, Hq, group, Sq, Skv,
                               scale, causal, window, softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, hd), k/v (B, Hkv, Skv, hd), o like q, all f32, each
// addressed by the 12 element strides in `strides` (q, k, v, o; batch,
// head, seq); hd in {32, 64, 128, 256} is contiguous; every pointer and
// stride is a multiple of 16 bytes.  lse: NULL, or f32 (B, Hq, Sq) for
// each row's log-sum-exp.  Returns a cudaError_t code (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, void* lse, const long long* strides, int B,
                        int Hq, int Hkv, int Sq, int Skv, int hd, float scale,
                        int causal, int window, float softcap,
                        void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv < Sq) return (int)cudaErrorInvalidValue;
  const long long* x = strides;
  const Strides st{x[0], x[1], x[2], x[3], x[4],  x[5],
                   x[6], x[7], x[8], x[9], x[10], x[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  return dispatch<float>(hd, q, k, v, o, static_cast<float*>(lse), st, B, Hq,
                         group, Sq, Skv, scale, causal, window, softcap, s);
}

}  // extern "C"
