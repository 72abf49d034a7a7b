// Kernel K7 bwd-kv: the key side of the FlashAttention-2 backward of the
// espnet "latest" relative-position attention (kernel K7, the K7 instance
// of xl2_fwd_kernel in flash_xl_attention.cu), for Hopper (sm_90a), with
// the forward's attention-weight dropout.
//
// Replaces the TPU kernel viet_tts_tpu/ops/pallas_attention.py
// `_rel_bwd_kv_kernel` (launched by `_rel_bwd_pallas` through
// `_call_bwd_kv`). Same function: with the logits l_ij = (qc_i . k_j +
// g_i . t_j) * scale, the forward's logsumexp lse, delta_i = sum_d gout_id
// out_id (computed outside, as the JAX package does) and m the forward's
// keep bit over (1 - p) (dropout_hash.cuh),
//   p    = exp(l - lse)                   (0 at padded keys)
//   ds   = p * (gout_i . v_j * m - delta_i) * scale   (0 at padded keys)
//   dk = ds^T qc,  dv = (p m)^T gout,  and, when the table needs a
//   gradient, dt = sum over (b, h) of ds^T g.
// K7 bwd-q (dqc = ds k, dg = ds t, TPU `_rel_bwd_q_kernel`) runs on the
// tensor cores as K7's instance of the K5 / K6 bwd-q kernels
// (flash_xl_attention_bwd.cu, position kind kPosRel).
//
// Design. On the TPU the grid runs in order and carries each accumulator in
// VMEM from one grid step to the next (the table's gradient across the whole
// (B, H, query) sweep); here a loop inside each block takes that place, no
// two blocks write the same output, so there are no atomics and the result
// is deterministic. One block per (64-key tile, head, batch row) keeps the
// key side [k | t] and v, walks the 32-query tiles, writes (p m)^T and ds^T
// to shared memory and accumulates dk and dv in registers (4 keys x D/16
// columns a thread each); 212 KB of shared memory. With a table gradient
// it also adds each query tile's ds^T g into the block's (64, E) slice of
// a per-(b, h) fp32 partial, which `rel_bwd_dtab_kernel` sums over
// (b, h). The conformer's table is the constant sinusoid table, so
// training never asks for it.
//
// What bounds it on the H100: at the decoder's training shape (B=8, H=2,
// T=512, D=128, E=256) the data needs 2*B*H*T^2*(4D + E) = 6.4 GFLOP (the
// logits, gout . v, dk and dv) against ~20 MB of inputs and outputs: bound
// by operations. It runs every product on the fp32 CUDA cores (67
// TFLOP/s), with register tiles fed from shared memory.
//
// Padding follows the forward: the Tp - T tail keys are virtual (dead,
// v = 0, not outputs) and the query rows past T carry a zero cotangent, so
// the loops stop at T. bf16 streams mirror the JAX `_mx`: p m and ds are
// rounded to bf16 before the products they feed, with fp32 accumulation.
//
// A batch row whose keys are all padding: every logit is MASK_NEG, so the
// forward's softmax is uniform, 1/Tp per key. Its lse, -1e9 + log Tp,
// rounds to -1e9 in fp32 (the spacing there is 64), and exp(l - lse) would
// give 1 per key: the TPU kernel's dv is Tp times too large on such a row.
// This kernel detects the row (no live key in the batch row) and uses
// p = 1/Tp, the dense gradient; its ds, and so dk, are 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "dropout_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;  // query rows per tile
constexpr int kBK = 64;  // keys per tile

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

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

struct DropArgs {
  uint32_t thresh;
  float inv_keep;
  int use;
  uint64_t seed;
};

__device__ __forceinline__ float keep_scale(const DropArgs& drop, uint32_t key,
                                            int i, int j) {
  if (!drop.use) return 1.f;
  return vt_dropout_keep(key, i, j, drop.thresh) ? drop.inv_keep : 0.f;
}

// True when batch row b has no live key (block-wide; every thread calls).
__device__ __forceinline__ bool row_all_dead(const float* padb, int Tq) {
  int live = 0;
  for (int j = threadIdx.x; j < Tq; j += blockDim.x) live |= padb[j] <= 0.5f;
  return !__syncthreads_or(live);
}

// Rows r0 .. r0 + rows - 1 of [a | b] into dst (row stride ds): a is a
// (B, T, H, DA) stream at `base_a`, row stride `rs_a`; b is either a
// (B, T, H, DB) stream or the (T, DB) table (rs_b = DB, base_b = 0). Rows
// past Tq are zero.
template <typename T, int DA, int DB>
__device__ __forceinline__ void load_rows(float* dst, int ds, const T* a,
                                          size_t base_a, size_t rs_a,
                                          const T* b, size_t base_b,
                                          size_t rs_b, int r0, int rows,
                                          int Tq) {
  constexpr int W = DA + DB;
  for (int i = threadIdx.x; i < rows * W; i += kThreads) {
    const int r = i / W, c = i % W, row = r0 + r;
    float val = 0.f;
    if (row < Tq)
      val = c < DA ? to_float(a[base_a + (size_t)row * rs_a + c])
                   : to_float(b[base_b + (size_t)row * rs_b + (c - DA)]);
    dst[r * ds + c] = val;
  }
}

template <int D, int E>
constexpr size_t smem_kv_bytes() {
  // KT (BK, D+E+4); VS (BK, D+4); QG (BQ, D+E+4); GO (BQ, D+4);
  // Pt, dSt (BK, BQ+1); lse, delta (BQ); dead (BK)
  return sizeof(float) * (kBK * (D + E + 4) + kBK * (D + 4) +
                          kBQ * (D + E + 4) + kBQ * (D + 4) +
                          2 * kBK * (kBQ + 1) + 2 * kBQ + kBK);
}

template <typename T, int D, int E>
__global__ void __launch_bounds__(kThreads)
    rel_bwd_kv_kernel(const T* __restrict__ qc, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const T* __restrict__ table, const T* __restrict__ gout,
                      const float* __restrict__ pad,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ dtab_part,
                      int H, int Tq, int Tp, float scale, DropArgs drop) {
  static_assert(D % 16 == 0 && E % 16 == 0, "D and E must be multiples of 16");
  constexpr int W = D + E;
  constexpr int QS = W + 4;
  constexpr int DS = D + 4;
  constexpr int SP = kBQ + 1;
  constexpr int DJ = D / 16;

  extern __shared__ __align__(16) float smem[];
  float* KT = smem;
  float* VS = KT + kBK * QS;
  float* QG = VS + kBK * DS;
  float* GO = QG + kBQ * QS;
  float* Pt = GO + kBQ * DS;   // (key, query): p * m
  float* dSt = Pt + kBK * SP;  // (key, query): ds
  float* lse_s = dSt + kBK * SP;
  float* del_s = lse_s + kBQ;
  float* dead_s = del_s + kBQ;

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * Tq * rs + (size_t)h * D;
  const size_t rse = (size_t)H * E;
  const size_t base_e = (size_t)b * Tq * rse + (size_t)h * E;
  const float* padb = pad + (size_t)b * Tq;
  const size_t rbase = ((size_t)b * H + h) * Tq;
  const uint32_t drop_key = vt_dropout_key(drop.seed, b, h);
  const float inv_tp = 1.f / (float)Tp;
  float* tpart = dtab_part == nullptr
                     ? nullptr
                     : dtab_part + ((size_t)b * H + h) * Tq * E;

  const bool all_dead = row_all_dead(padb, Tq);

  load_rows<T, D, E>(KT, QS, k, base, rs, table, 0, E, j0, kBK, Tq);
  load_rows<T, D, 0>(VS, DS, v, base, rs, v, 0, 0, j0, kBK, Tq);
  if (tid < kBK) {
    const int kj = j0 + tid;
    dead_s[tid] = (kj >= Tq || padb[kj] > 0.5f) ? 1.f : 0.f;
  }

  // (ty, tx): keys ty*4 + i; for the logits the query columns tx + 16*j,
  // for the accumulators the feature columns tx + 16*j
  const int ty = tid / 16, tx = tid % 16;
  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int i0 = 0; i0 < Tq; i0 += kBQ) {
    __syncthreads();  // the previous tile's QG / GO / Pt / dSt are no longer read
    load_rows<T, D, E>(QG, QS, qc, base, rs, g, base_e, rse, i0, kBQ, Tq);
    load_rows<T, D, 0>(GO, DS, gout, base, rs, gout, 0, 0, i0, kBQ, Tq);
    if (tid < kBQ) {
      const bool in = i0 + tid < Tq;
      lse_s[tid] = in ? lse[rbase + i0 + tid] : 0.f;
      del_s[tid] = in ? delta[rbase + i0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < W; e += 4) {
      float4 q4[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        q4[j] = *reinterpret_cast<const float4*>(&QG[(tx + 16 * j) * QS + e]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 k4 =
            *reinterpret_cast<const float4*>(&KT[(ty * 4 + i) * QS + e]);
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = dot4(k4, q4[j], s[i][j]);
      }
    }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 g4[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        g4[j] = *reinterpret_cast<const float4*>(&GO[(tx + 16 * j) * DS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(&VS[(ty * 4 + i) * DS + d]);
#pragma unroll
        for (int j = 0; j < 2; ++j) dp[i][j] = dot4(v4, g4[j], dp[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ty * 4 + i, kj = j0 + c;
      const bool dead = dead_s[c] != 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = tx + 16 * j, qi = i0 + r;
        float pv = 0.f, ds = 0.f;
        if (kj < Tq && qi < Tq) {
          float p;
          if (all_dead)
            p = inv_tp;  // uniform softmax over all Tp keys (see the header)
          else
            p = dead ? 0.f : expf(s[i][j] * scale - lse_s[r]);
          const float m = keep_scale(drop, drop_key, qi, kj);
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
        const float gg = GO[r * DS + tx + 16 * j];
        const float qq = QG[r * QS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][j] = fmaf(wp[i], gg, acc_v[i][j]);
          acc_k[i][j] = fmaf(ws[i], qq, acc_k[i][j]);
        }
      }
    }
    if (tpart != nullptr) {
      // dt_j += sum_i ds_ij g_i over this query tile; one thread owns each
      // (key, column) of the block's slice for the whole sweep, so the
      // first tile writes it and the others add to it
      for (int idx = tid; idx < kBK * E; idx += kThreads) {
        const int c = idx / E, e = idx % E, kj = j0 + c;
        if (kj >= Tq) continue;
        float sum = 0.f;
#pragma unroll 4
        for (int r = 0; r < kBQ; ++r)
          sum = fmaf(dSt[c * SP + r], QG[r * QS + D + e], sum);
        float* dst = tpart + (size_t)kj * E + e;
        *dst = i0 == 0 ? sum : *dst + sum;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = j0 + ty * 4 + i;
    if (kj >= Tq) continue;
    const size_t off = base + (size_t)kj * rs;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + 16 * j] = acc_k[i][j];
      dv[off + tx + 16 * j] = acc_v[i][j];
    }
  }
}

// dt (T, E) = the sum of the per-(b, h) partials.
__global__ void __launch_bounds__(kThreads)
    rel_bwd_dtab_kernel(const float* __restrict__ dtab_part,
                        float* __restrict__ dtab, int BH, int Tq, int E) {
  const size_t n = (size_t)Tq * E;
  for (size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * kThreads) {
    float sum = 0.f;
    for (int bh = 0; bh < BH; ++bh) sum += dtab_part[(size_t)bh * n + idx];
    dtab[idx] = sum;
  }
}

template <typename T, int D, int E>
cudaError_t launch_kv(const void* qc, const void* k, const void* v,
                      const void* g, const void* table, const void* gout,
                      const float* pad, const float* lse, const float* delta,
                      float* dk, float* dv, float* dtab_part, float* dtab,
                      int B, int Tq, int Tp, int H, float scale, DropArgs drop,
                      cudaStream_t stream) {
  constexpr size_t smem = smem_kv_bytes<D, E>();
  static_assert(smem <= 232448, "bwd-kv tiles exceed a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      rel_bwd_kv_kernel<T, D, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBK - 1) / kBK, H, B);
  rel_bwd_kv_kernel<T, D, E><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qc), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const T*>(table), static_cast<const T*>(gout), pad, lse,
      delta, dk, dv, dtab_part, H, Tq, Tp, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess || dtab_part == nullptr) return err;
  const size_t n = (size_t)Tq * E;
  const int blocks = (int)((n + kThreads - 1) / kThreads < 4096
                               ? (n + kThreads - 1) / kThreads
                               : 4096);
  rel_bwd_dtab_kernel<<<blocks, kThreads, 0, stream>>>(dtab_part, dtab, B * H,
                                                        Tq, E);
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

// K7 bwd-kv. qc, k, v, gout: (B, T, H, D); g: (B, T, H, E); table: (T, E);
// all contiguous and one dtype, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// (D, E) is (128, 256), the JETS width. pad: (B, T) fp32, 1.0 at padding
// keys. lse, delta: (B, H, T) fp32. Tp >= T: the forward's padded length
// (keys in [T, Tp) are virtual). dropout_p and seed: the forward's. dk, dv:
// (B, T, H, D) fp32. dtab_part null: no table gradient; else scratch
// (B * H, T, E) fp32 and dtab (T, E) fp32. Returns the first cudaError_t.
int vt_flash_rel_bwd_kv(const void* qc, const void* k, const void* v,
                        const void* g, const void* table, const void* gout,
                        const float* pad, const float* lse,
                        const float* delta, float* dk, float* dv,
                        float* dtab_part, float* dtab, int B, int T, int Tp,
                        int H, int D, int E, int is_bf16, float scale,
                        double dropout_p, uint64_t seed, void* stream) {
  if (bad_args(B, T, Tp, H, dropout_p) || E != 256 ||
      (dtab_part == nullptr) != (dtab == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropArgs drop = drop_args(dropout_p, seed);
#define VT_KV(TYPE, DIM)                                                   \
  launch_kv<TYPE, DIM, 256>(qc, k, v, g, table, gout, pad, lse, delta, dk, \
                            dv, dtab_part, dtab, B, T, Tp, H, scale, drop, s)
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
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
