// Kernel K1: plain scaled-dot multi-head attention forward with an online
// softmax (flash attention), for Hopper (sm_90a), with optional
// attention-weight dropout (training).
//
// Replaces the TPU kernel viet_tts_tpu/ops/pallas_attention.py
// `_plain_kernel` (launched by `_plain_pallas` through `_call_flash`).
// Same function: ctx = softmax(q k^T * scale, padding keys -> -1e9) v, plus
// the per-row logsumexp that a backward pass needs.
//
// What bounds it on the H100: at the decoder shape (B=16, H=2, T=1008,
// D=128) one call does 4*B*H*Tp^2*D = 17 GFLOP against about 66 MB of fp32
// inputs and outputs, some 260 FLOP per byte: it is bound by operations.
// This first version runs both products on the fp32 CUDA cores, not the
// tensor cores, so its ceiling is the 67 TFLOP/s fp32 rate.
//
// Design: one block of 256 threads per (64-query tile, head, batch row).
// The query tile stays in shared memory; the block walks over 64-key
// tiles, staging K and V in shared memory, and keeps the running max and
// denominator in shared memory and the (64, D) accumulator in registers
// (4 rows x D/16 columns a thread). The (T, T) score matrix never reaches
// device memory. Inputs are fp32 or bf16 in the JAX package's feature-last
// (B, T, H, D) layout, read in place with row stride H*D; all arithmetic is
// fp32.
//
// Masking reproduces the TPU kernel exactly. The JAX wrapper pads T to
// Tp (the next multiple of 32) with zero q/k/v rows and pad = 1; here those
// Tp - T keys are virtual: they score MASK_NEG = -1e9 and carry v = 0, so a
// query whose keys are all padding gets the uniform average over all Tp
// keys, as in the dense softmax. Key slots past Tp (the ragged last tile)
// get -inf and weigh nothing.
//
// Dropout (dropout_p > 0) follows the JAX package's semantics: the
// denominator l accumulates the UNdropped weights (dropout acts after the
// softmax), and the context sums p * keep / (1 - p) * v. The keep bits come
// from dropout_hash.cuh, addressed per (batch row, head, query, key), so the
// backward kernels (flash_attention_bwd.cu) regenerate them with their own
// tilings. With dropout_p = 0 no bit is drawn and the kernel is the
// inference kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 256;
constexpr float kMaskNeg = -1.0e9f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Qs and Ks rows padded to D+1 floats (no bank conflicts across rows),
  // Vs (BK, D), S (BQ, BK+1), and three per-row vectors (m, l, corr).
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ pad,
                     float* __restrict__ out, float* __restrict__ lse, int H,
                     int Tq, int Tp, float scale, uint32_t drop_thresh,
                     float inv_keep, int use_dropout, uint64_t seed) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int SP = kBK + 1;
  constexpr int DJ = D / 16;  // accumulator columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * DP;
  float* Vs = Ks + kBK * DP;
  float* S = Vs + kBK * D;
  float* m_s = S + kBQ * SP;
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row_stride = (size_t)H * D;
  const size_t base = (size_t)b * Tq * row_stride + (size_t)h * D;
  const float* padb = pad + (size_t)b * Tq;
  const uint32_t drop_key = vt_dropout_key(seed, b, h);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[r * DP + d] =
        (q0 + r < Tq) ? to_float(q[base + (size_t)(q0 + r) * row_stride + d])
                      : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // (ty, tx) owns query rows ty*4 .. ty*4+3; for the scores the key columns
  // tx + 16*j (j < 4), for the accumulator the feature columns tx + 16*j.
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Tp; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks / Vs / S are no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < Tq;  // keys in [Tq, Tp) are zero rows
      const size_t off = base + (size_t)(k0 + r) * row_stride + d;
      Ks[r * DP + d] = in ? to_float(k[off]) : 0.f;
      Vs[r * D + d] = in ? to_float(v[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int key = k0 + c;
      const bool beyond = key >= Tp;
      const bool masked = !beyond && (key >= Tq || padb[key] > 0.5f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float val = s[i][j] * scale;
        if (masked) val = kMaskNeg;
        if (beyond) val = -INFINITY;
        S[(ty * 4 + i) * SP + c] = val;
      }
    }
    __syncthreads();

    // online-softmax update: four threads per query row
    {
      const int r = tid / 4, part = tid % 4;
      float mx = -INFINITY;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, S[r * SP + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);  // finite: key k0 < Tp exists
      float sum = 0.f;
      for (int c = part; c < kBK; c += 4) {
        const float p = expf(S[r * SP + c] - m_new);
        sum += p;  // the denominator takes the undropped weight
        float pv = p;
        if (use_dropout)
          pv = vt_dropout_keep(drop_key, q0 + r, k0 + c, drop_thresh)
                   ? p * inv_keep
                   : 0.f;
        S[r * SP + c] = pv;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = (m_prev == -INFINITY) ? 0.f : expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = S[(ty * 4 + i) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Tq) continue;
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    float* ob = out + base + (size_t)(q0 + r) * row_stride;
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[tx + 16 * j] = acc[i][j] * inv;
    if (tx == 0)
      lse[((size_t)b * H + h) * Tq + q0 + r] = m_s[r] + logf(fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* pad, float* out, float* lse, int B, int Tq,
                   int Tp, int H, float scale, uint32_t thresh, float inv_keep,
                   int use_dropout, uint64_t seed, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pad, out, lse, H, Tq, Tp, scale, thresh,
      inv_keep, use_dropout, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const float* pad, float* out, float* lse, int B,
                       int Tq, int Tp, int H, int D, float scale,
                       uint32_t thresh, float inv_keep, int use_dropout,
                       uint64_t seed, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, pad, out, lse, B, Tq, Tp, H, scale,
                           thresh, inv_keep, use_dropout, seed, stream);
    case 64:
      return launch<T, 64>(q, k, v, pad, out, lse, B, Tq, Tp, H, scale,
                           thresh, inv_keep, use_dropout, seed, stream);
    case 128:
      return launch<T, 128>(q, k, v, pad, out, lse, B, Tq, Tp, H, scale,
                            thresh, inv_keep, use_dropout, seed, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v: (B, T, H, D) contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// pad: (B, T) fp32, 1.0 at padding keys. Tp >= T: keys in [T, Tp) are
// treated as zero rows with pad = 1. out: (B, T, H, D) fp32. lse: (B, H, T)
// fp32. dropout_p in [0, 1): attention-weight dropout keyed by `seed`
// (dropout_hash.cuh; B, H and T below 2^16). Returns the launch's
// cudaError_t (0 = success).
int vt_flash_attn_fwd(const void* q, const void* k, const void* v,
                      const float* pad, float* out, float* lse, int B, int T,
                      int Tp, int H, int D, int is_bf16, float scale,
                      double dropout_p, uint64_t seed, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || Tp < T || T >= 65536 || B >= 65536 ||
      H >= 65536 || !(dropout_p >= 0.0 && dropout_p < 1.0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int use_dropout = dropout_p > 0.0;
  const uint32_t thresh = vt_dropout_thresh(dropout_p);
  const float inv_keep = (float)(1.0 / (1.0 - dropout_p));
  if (is_bf16)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, pad, out, lse, B, T, Tp, H,
                                          D, scale, thresh, inv_keep,
                                          use_dropout, seed, s);
  return (int)dispatch_d<float>(q, k, v, pad, out, lse, B, T, Tp, H, D, scale,
                                thresh, inv_keep, use_dropout, seed, s);
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
