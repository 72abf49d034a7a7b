// Kernels K3a (bwd_q) and K3b (bwd_kv): the FlashAttention-2 backward of
// plain scaled-dot multi-head attention (kernel K1, the instance of
// xl2_fwd_kernel with no position term in flash_xl_attention.cu), for
// Hopper (sm_90a), with the forward's attention-weight dropout.
//
// Replace the TPU kernels viet_tts_tpu/ops/pallas_attention.py
// `_plain_bwd_q_kernel` (launched by `_plain_bwd_pallas` through
// `_call_bwd_q`) and `_plain_bwd_kv_kernel` (through `_call_bwd_kv`). Same
// function: with raw scores s = q k^T, the forward's logsumexp lse and
// delta_i = sum_d g_id out_id (computed outside, as the JAX package does),
//   p   = exp(s * scale - lse)                 (0 at padding keys)
//   ds  = p * (dp * m / keep - delta) * scale  (0 at padding keys)
//   dq  = ds k,   dk = ds^T q,   dv = (p * m / keep)^T g,
// where dp = g v^T and m the forward's dropout keep bit (dropout_hash.cuh).
//
// What bounds it on the H100: at the decoder's training shape (B=8, H=2,
// T=512, D=128) bwd_q does 6*B*H*T^2*D = 3.2 GFLOP (s, dp and dq) and bwd_kv
// 8*B*H*T^2*D = 4.3 GFLOP (s, dp, dv and dk) against 8.4 MB of fp32 inputs
// and outputs each: some 400-500 FLOP per byte, bound by operations. This
// first version runs every product on the fp32 CUDA cores (67 TFLOP/s), not
// the tensor cores.
//
// Design. On the TPU the grid runs in order and carries the dq (or dk, dv)
// accumulator in VMEM from one grid step to the next; here a loop inside
// each block takes that place, and no two blocks write the same output, so
// there are no atomics and the result is deterministic.
//  - bwd_q: one block of 256 threads per (64-query tile, head, batch row)
//    keeps the tile's q and g in shared memory, walks over 64-key tiles
//    (k and v staged in shared memory), forms s and dp in registers (a 4x4
//    patch per thread), writes ds to shared memory and accumulates
//    dq = ds k in registers (4 rows x D/16 columns a thread).
//  - bwd_kv: one block per (64-key tile, head, batch row) keeps k and v,
//    walks over 64-query tiles, writes (p m / keep)^T and ds^T to shared
//    memory and accumulates dv and dk in registers.
// At D=128 in fp32 the four staged (64, D) tiles and the two score tiles
// take 150 KB (bwd_q) and 166 KB (bwd_kv) of shared memory: both opt into
// dynamic shared memory above 48 KB, one block per SM.
//
// Layout and masking mirror K1: q/k/v/g are read in place from the JAX
// package's feature-last (B, T, H, D) layout (row stride H*D). The JAX
// wrapper pads T to Tp (next multiple of 32); the keys in [T, Tp) are
// virtual (v = 0, dead, so ds = 0 and their dk, dv are not outputs) and the
// query rows in [T, Tp) carry g = 0, so both loops stop at T. bf16 streams
// mirror `_mx`: p m / keep and ds are rounded to bf16 before the products
// they feed, with fp32 accumulation.
//
// A batch row whose keys are all padding: every logit is MASK_NEG, so the
// forward's softmax is uniform, 1/Tp per key. Its lse, -1e9 + log Tp,
// rounds to -1e9 in fp32 (the spacing there is 64), and exp(s - lse) would
// give 1 per key: the TPU kernel's dv is Tp times too large on such a row.
// These kernels detect the row (no live key in the batch row) and use
// p = 1/Tp, the dense gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <type_traits>

#include "dropout_hash.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The stream dtype's rounding of an fp32 intermediate (the JAX `_mx`).
template <typename T>
__device__ __forceinline__ float to_stream(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16(x));
  return x;
}

struct DropArgs {
  uint32_t thresh;
  float inv_keep;
  int use;
  uint64_t seed;
};

// True when batch row b has no live key (block-wide; every thread calls).
__device__ __forceinline__ bool row_all_dead(const float* padb, int Tq) {
  int live = 0;
  for (int j = threadIdx.x; j < Tq; j += blockDim.x) live |= padb[j] <= 0.5f;
  return !__syncthreads_or(live);
}

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t base, size_t row_stride,
                                          int r0, int Tq, int D, int DP) {
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * DP + d] = (r0 + r < Tq)
                          ? to_float(src[base + (size_t)(r0 + r) * row_stride + d])
                          : 0.f;
  }
}

template <int D>
constexpr size_t smem_q_bytes() {
  // Qs, Gs, Ks, Vs (64, D+1); dS (64, 65); lse, delta (64); dead (64)
  return sizeof(float) * (4 * 64 * (D + 1) + kBQ * (kBK + 1) + 3 * 64);
}

template <int D>
constexpr size_t smem_kv_bytes() {
  // Ks, Vs, Qs, Gs (64, D+1); Pt, dSt (64, 65); lse, delta (64); dead (64)
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * kBK * (kBQ + 1) + 3 * 64);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ g,
                       const float* __restrict__ pad,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dq,
                       int H, int Tq, int Tp, float scale, DropArgs drop) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int SP = kBK + 1;
  constexpr int DJ = D / 16;

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + kBQ * DP;
  float* Ks = Gs + kBQ * DP;
  float* Vs = Ks + kBK * DP;
  float* dS = Vs + kBK * DP;
  float* lse_s = dS + kBQ * SP;
  float* del_s = lse_s + kBQ;
  float* dead_s = del_s + kBQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row_stride = (size_t)H * D;
  const size_t base = (size_t)b * Tq * row_stride + (size_t)h * D;
  const float* padb = pad + (size_t)b * Tq;
  const size_t rbase = ((size_t)b * H + h) * Tq;
  const uint32_t drop_key = vt_dropout_key(drop.seed, b, h);

  // a fully padded batch row has ds = 0 everywhere: its dq is 0
  const bool all_dead = row_all_dead(padb, Tq);

  load_tile(Qs, q, base, row_stride, q0, Tq, D, DP);
  load_tile(Gs, g, base, row_stride, q0, Tq, D, DP);
  if (tid < kBQ) {
    const bool in = q0 + tid < Tq;
    lse_s[tid] = in ? lse[rbase + q0 + tid] : 0.f;
    del_s[tid] = in ? delta[rbase + q0 + tid] : 0.f;
  }

  const int ty = tid / 16, tx = tid % 16;
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Tq && !all_dead; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks / Vs / dS are no longer read
    load_tile(Ks, k, base, row_stride, k0, Tq, D, DP);
    load_tile(Vs, v, base, row_stride, k0, Tq, D, DP);
    if (tid < kBK) {
      const int key = k0 + tid;
      dead_s[tid] = (key >= Tq || padb[key] > 0.5f) ? 1.f : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], gg[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * DP + d];
        gg[i] = Gs[(ty * 4 + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = Ks[(tx + 16 * j) * DP + d];
        vv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(gg[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const bool row_in = q0 + r < Tq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (row_in && dead_s[c] == 0.f) {
          const float p = expf(s[i][j] * scale - lse_s[r]);
          float dpm = dp[i][j];
          if (drop.use)
            dpm = vt_dropout_keep(drop_key, q0 + r, k0 + c, drop.thresh)
                      ? dpm * drop.inv_keep
                      : 0.f;
          ds = to_stream<T>(p * (dpm - del_s[r]) * scale);
        }
        dS[r * SP + c] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = dS[(ty * 4 + i) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kk = Ks[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(w[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Tq) continue;
    float* ob = dq + base + (size_t)(q0 + r) * row_stride;
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[tx + 16 * j] = acc[i][j];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ pad,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, int H,
                        int Tq, int Tp, float scale, DropArgs drop) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int SP = kBQ + 1;
  constexpr int DJ = D / 16;

  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * DP;
  float* Qs = Vs + kBK * DP;
  float* Gs = Qs + kBQ * DP;
  float* Pt = Gs + kBQ * DP;   // (key, query): p * m / keep
  float* dSt = Pt + kBK * SP;  // (key, query): ds
  float* lse_s = dSt + kBK * SP;
  float* del_s = lse_s + kBQ;
  float* dead_s = del_s + kBQ;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row_stride = (size_t)H * D;
  const size_t base = (size_t)b * Tq * row_stride + (size_t)h * D;
  const float* padb = pad + (size_t)b * Tq;
  const size_t rbase = ((size_t)b * H + h) * Tq;
  const uint32_t drop_key = vt_dropout_key(drop.seed, b, h);
  const float inv_tp = 1.f / (float)Tp;

  const bool all_dead = row_all_dead(padb, Tq);

  load_tile(Ks, k, base, row_stride, k0, Tq, D, DP);
  load_tile(Vs, v, base, row_stride, k0, Tq, D, DP);
  if (tid < kBK) {
    const int key = k0 + tid;
    dead_s[tid] = (key >= Tq || padb[key] > 0.5f) ? 1.f : 0.f;
  }

  // (ty, tx) owns keys ty*4 .. ty*4+3; for the scores the query columns
  // tx + 16*j, for the accumulators the feature columns tx + 16*j.
  const int ty = tid / 16, tx = tid % 16;
  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int q0 = 0; q0 < Tq; q0 += kBQ) {
    __syncthreads();  // the previous tile's Qs / Gs / Pt / dSt are no longer read
    load_tile(Qs, q, base, row_stride, q0, Tq, D, DP);
    load_tile(Gs, g, base, row_stride, q0, Tq, D, DP);
    if (tid < kBQ) {
      const bool in = q0 + tid < Tq;
      lse_s[tid] = in ? lse[rbase + q0 + tid] : 0.f;
      del_s[tid] = in ? delta[rbase + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kk[4], vv[4], a[4], gg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kk[i] = Ks[(ty * 4 + i) * DP + d];
        vv[i] = Vs[(ty * 4 + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = Qs[(tx + 16 * j) * DP + d];
        gg[j] = Gs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kk[i], a[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gg[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ty * 4 + i;  // key within the tile
      const bool key_in = k0 + c < Tq;
      const bool dead = dead_s[c] != 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;  // query within the tile
        float pv = 0.f, ds = 0.f;
        if (key_in && q0 + r < Tq) {
          float p;
          if (all_dead)
            p = inv_tp;  // uniform softmax over all Tp keys (see the header)
          else
            p = dead ? 0.f : expf(s[i][j] * scale - lse_s[r]);
          float m = 1.f;
          if (drop.use)
            m = vt_dropout_keep(drop_key, q0 + r, k0 + c, drop.thresh)
                    ? drop.inv_keep
                    : 0.f;
          pv = to_stream<T>(p * m);
          if (!dead) ds = to_stream<T>(p * (dp[i][j] * m - del_s[r]) * scale);
        }
        Pt[c * SP + r] = pv;
        dSt[c * SP + r] = ds;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < kBQ; ++r) {
      float wp[4], ws[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wp[i] = Pt[(ty * 4 + i) * SP + r];
        ws[i] = dSt[(ty * 4 + i) * SP + r];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float gg = Gs[r * DP + tx + 16 * j];
        const float qq = Qs[r * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][j] = fmaf(wp[i], gg, acc_v[i][j]);
          acc_k[i][j] = fmaf(ws[i], qq, acc_k[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty * 4 + i;
    if (k0 + c >= Tq) continue;
    const size_t off = base + (size_t)(k0 + c) * row_stride;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + 16 * j] = acc_k[i][j];
      dv[off + tx + 16 * j] = acc_v[i][j];
    }
  }
}

template <typename T, int D>
cudaError_t launch_q(const void* q, const void* k, const void* v,
                     const void* g, const float* pad, const float* lse,
                     const float* delta, float* dq, int B, int Tq, int Tp,
                     int H, float scale, DropArgs drop, cudaStream_t stream) {
  constexpr size_t smem = smem_q_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_q_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_bwd_q_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), pad, lse, delta, dq,
      H, Tq, Tp, scale, drop);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_kv(const void* q, const void* k, const void* v,
                      const void* g, const float* pad, const float* lse,
                      const float* delta, float* dk, float* dv, int B, int Tq,
                      int Tp, int H, float scale, DropArgs drop,
                      cudaStream_t stream) {
  constexpr size_t smem = smem_kv_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBK - 1) / kBK, H, B);
  flash_bwd_kv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), pad, lse, delta, dk,
      dv, H, Tq, Tp, scale, drop);
  return cudaGetLastError();
}

bool bad_args(int B, int T, int Tp, int H, double dropout_p) {
  return B <= 0 || H <= 0 || T <= 0 || Tp < T || T >= 65536 || B >= 65536 ||
         H >= 65536 || !(dropout_p >= 0.0 && dropout_p < 1.0);
}

DropArgs drop_args(double dropout_p, uint64_t seed) {
  DropArgs a;
  a.thresh = vt_dropout_thresh(dropout_p);
  a.inv_keep = (float)(1.0 / (1.0 - dropout_p));
  a.use = dropout_p > 0.0;
  a.seed = seed;
  return a;
}

}  // namespace

extern "C" {

// q, k, v, g: (B, T, H, D) contiguous, fp32 (is_bf16 = 0) or bf16
// (is_bf16 = 1). pad: (B, T) fp32, 1.0 at padding keys. lse, delta:
// (B, H, T) fp32. Tp >= T: the forward's padded length (keys in [T, Tp) are
// virtual). dropout_p and seed: the forward's. dq: (B, T, H, D) fp32.
// Returns the launch's cudaError_t (0 = success).
int vt_flash_attn_bwd_q(const void* q, const void* k, const void* v,
                        const void* g, const float* pad, const float* lse,
                        const float* delta, float* dq, int B, int T, int Tp,
                        int H, int D, int is_bf16, float scale,
                        double dropout_p, uint64_t seed, void* stream) {
  if (bad_args(B, T, Tp, H, dropout_p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropArgs drop = drop_args(dropout_p, seed);
#define VT_Q(TYPE, DIM) \
  launch_q<TYPE, DIM>(q, k, v, g, pad, lse, delta, dq, B, T, Tp, H, scale, drop, s)
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 64: return (int)VT_Q(float, 32);
    case 65: return (int)VT_Q(__nv_bfloat16, 32);
    case 128: return (int)VT_Q(float, 64);
    case 129: return (int)VT_Q(__nv_bfloat16, 64);
    case 256: return (int)VT_Q(float, 128);
    case 257: return (int)VT_Q(__nv_bfloat16, 128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VT_Q
}

// As vt_flash_attn_bwd_q; dk, dv: (B, T, H, D) fp32.
int vt_flash_attn_bwd_kv(const void* q, const void* k, const void* v,
                         const void* g, const float* pad, const float* lse,
                         const float* delta, float* dk, float* dv, int B,
                         int T, int Tp, int H, int D, int is_bf16, float scale,
                         double dropout_p, uint64_t seed, void* stream) {
  if (bad_args(B, T, Tp, H, dropout_p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropArgs drop = drop_args(dropout_p, seed);
#define VT_KV(TYPE, DIM)                                                   \
  launch_kv<TYPE, DIM>(q, k, v, g, pad, lse, delta, dk, dv, B, T, Tp, H, \
                       scale, drop, s)
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 64: return (int)VT_KV(float, 32);
    case 65: return (int)VT_KV(__nv_bfloat16, 32);
    case 128: return (int)VT_KV(float, 64);
    case 129: return (int)VT_KV(__nv_bfloat16, 64);
    case 256: return (int)VT_KV(float, 128);
    case 257: return (int)VT_KV(__nv_bfloat16, 128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VT_KV
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
