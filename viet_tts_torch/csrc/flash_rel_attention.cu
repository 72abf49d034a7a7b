// Kernel K7 forward: espnet "latest" relative-position attention (the JETS
// conformer stacks' self-attention) with an online softmax, for Hopper
// (sm_90a), with optional attention-weight dropout (training).
//
// Replaces the TPU kernel viet_tts_tpu/ops/pallas_attention.py `_rel_kernel`
// (launched by `_rel_pallas` through `_call_flash`). Same function:
//   logit_ij = (qc_i . k_j + g_i . t_j) * scale,  MASK_NEG = -1e9 at padded
//   keys,  ctx_i = sum_j softmax_j(logit_ij) v_j,
// plus the per-row logsumexp that the backward needs. qc = q + pos_bias_u,
// k, v: (B, T, H, D); g: the pre-rotated position queries (B, T, H, E); t:
// the negative half of the symmetric sinusoid table, (T, E), one table for
// every (batch row, head). Inputs are fp32 or bf16 in the JAX package's
// feature-last layouts, read in place; all arithmetic is fp32.
//
// Design. The logit is plain attention whose query side is [qc_i | g_i]
// (D + E = 384 wide at the JETS width, D = 128, E = 256) and whose key side
// is [k_j | t_j]; the values stay D wide. So this is K1's design
// (flash_attention.cu) with a second key-side operand: one block of 256
// threads per (32-query tile, head, batch row) keeps the tile's [qc | g]
// rows in shared memory (32 x 388 floats, 50 KB) and walks the 64-key
// tiles with the online softmax. Per key tile it stages v (64, D) and the
// key side in 64-column chunks (the k columns, then the table's; the table
// rows a tile reads are shared by all B * H blocks of a query tile, about 1
// MB at T = 1008, so they come from L2). Each thread keeps a 2 x 4 patch of
// logits and a 2 x D/16 patch of the context accumulator in registers. The
// (T, T) logits never reach device memory. At bq = bk = 64 the whole-width
// tiles would need ~224 KB of the 227 KB a block may have; with 32 query
// rows and the key side chunked a block takes 106 KB, so two fit on an SM.
//
// What bounds it on the H100: at the decoder's serving shape (B=16, H=2,
// T=1008) one call does 2*B*H*T^2*(2D + E) = 33 GFLOP (the [qc|g].[k|t]
// logits and the weighted sum of v) against ~50 MB of inputs: bound by
// operations. This first version runs every product on the fp32 CUDA cores
// (ceiling 67 TFLOP/s), not the tensor cores.
//
// Masking reproduces the TPU kernel. The JAX wrapper pads T to Tp (the next
// multiple of 32) with zero rows and marks the tail as padded keys; here
// the Tp - T tail keys are virtual: they add (Tp - T) * exp(MASK_NEG - m)
// to the denominator and nothing to the context (v = 0), so a row whose
// keys are all padding averages v over all Tp keys, as the TPU kernel and
// the dense path do.
//
// Dropout (dropout_p > 0) follows the JAX package's semantics, as K1 does:
// the softmax denominator takes the undropped weights, the context sums
// p * keep / (1 - p) * v. The keep bit of weight (i, j) is
// dropout_hash.cuh's keep(seed, b, h, i, j), which depends on no tile size,
// so the backward kernels (flash_rel_attention_bwd.cu) draw the same bits
// with their own tilings. With dropout_p = 0 no bit is drawn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kCH = 64;  // key-side columns staged at a time
constexpr int kCS = kCH + 4;
constexpr float kMaskNeg = -1.0e9f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int D, int E>
constexpr size_t smem_bytes() {
  // QG (BQ, D+E+4) the [qc | g] rows; KT (BK, CH+4) a chunk of [k | t];
  // VS (BK, D); S (BQ, BK+1); m / l / corr (BQ each). Rows read as float4
  // are padded by 4 floats: 16-byte aligned, and the 8 threads of a quarter
  // warp reading 8 rows hit 8 different bank groups.
  return sizeof(float) * (kBQ * (D + E + 4) + kBK * kCS + kBK * D +
                          kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int D, int E>
__global__ void __launch_bounds__(kThreads)
    rel_fwd_kernel(const T* __restrict__ qc, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ g,
                   const T* __restrict__ table, const float* __restrict__ pad,
                   float* __restrict__ out, float* __restrict__ lse, int H,
                   int Tq, int Tp, float scale, uint32_t drop_thresh,
                   float inv_keep, int use_dropout, uint64_t seed) {
  static_assert(D % kCH == 0 && E % kCH == 0, "D and E must be multiples of 64");
  constexpr int W = D + E;
  constexpr int QS = W + 4;
  constexpr int SP = kBK + 1;
  constexpr int DJ = D / 16;

  extern __shared__ __align__(16) float smem[];
  float* QG = smem;
  float* KT = QG + kBQ * QS;
  float* VS = KT + kBK * kCS;
  float* S = VS + kBK * D;
  float* m_s = S + kBQ * SP;
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rs = (size_t)H * D;  // row stride of (B, T, H, D)
  const size_t base = (size_t)b * Tq * rs + (size_t)h * D;
  const size_t rse = (size_t)H * E;  // row stride of (B, T, H, E)
  const size_t base_e = (size_t)b * Tq * rse + (size_t)h * E;
  const float* padb = pad + (size_t)b * Tq;
  const uint32_t drop_key = vt_dropout_key(seed, b, h);

  for (int i = tid; i < kBQ * W; i += kThreads) {
    const int r = i / W, c = i % W, qi = i0 + r;
    float val = 0.f;
    if (qi < Tq)
      val = c < D ? to_float(qc[base + (size_t)qi * rs + c])
                  : to_float(g[base_e + (size_t)qi * rse + (c - D)]);
    QG[r * QS + c] = val;
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // (ty, tx): query rows ty*2 + a, key columns tx + 16*c, accumulator
  // columns tx + 16*j
  const int ty = tid / 16, tx = tid % 16;
  float acc[2][DJ];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[a][j] = 0.f;

  for (int j0 = 0; j0 < Tq; j0 += kBK) {
    __syncthreads();  // the previous tile's KT / VS / S are no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      VS[r * D + d] =
          (j0 + r < Tq) ? to_float(v[base + (size_t)(j0 + r) * rs + d]) : 0.f;
    }

    float s[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 1
    for (int c0 = 0; c0 < W; c0 += kCH) {
      if (c0 > 0) __syncthreads();  // the previous chunk of KT is read
      for (int i = tid; i < kBK * kCH; i += kThreads) {
        const int r = i / kCH, e = i % kCH, kj = j0 + r;
        float val = 0.f;
        if (kj < Tq)
          val = c0 < D ? to_float(k[base + (size_t)kj * rs + c0 + e])
                       : to_float(table[(size_t)kj * E + (c0 - D) + e]);
        KT[r * kCS + e] = val;
      }
      __syncthreads();
#pragma unroll 4
      for (int e = 0; e < kCH; e += 4) {
        float4 k4[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          k4[c] = *reinterpret_cast<const float4*>(&KT[(tx + 16 * c) * kCS + e]);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float4 q4 =
              *reinterpret_cast<const float4*>(&QG[(ty * 2 + a) * QS + c0 + e]);
#pragma unroll
          for (int c = 0; c < 4; ++c) s[a][c] = dot4(q4, k4[c], s[a][c]);
        }
      }
    }

#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = ty * 2 + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c, kj = j0 + col;
        float val;
        if (kj >= Tq)
          val = -INFINITY;  // the tail is added in closed form below
        else if (padb[kj] > 0.5f)
          val = kMaskNeg;
        else
          val = s[a][c] * scale;
        S[r * SP + col] = val;
      }
    }
    __syncthreads();

    // online-softmax update: eight threads per query row; every tile holds
    // a real key (logit >= MASK_NEG), so m_new is finite
    {
      constexpr int TPR = kThreads / kBQ;
      const int r = tid / TPR, part = tid % TPR;
      float mx = -INFINITY;
      for (int c = part; c < kBK; c += TPR) mx = fmaxf(mx, S[r * SP + c]);
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < kBK; c += TPR) {
        const float p = expf(S[r * SP + c] - m_new);
        sum += p;  // the denominator takes the undropped weight
        float pv = p;
        if (use_dropout)
          pv = vt_dropout_keep(drop_key, i0 + r, j0 + c, drop_thresh)
                   ? p * inv_keep
                   : 0.f;
        S[r * SP + c] = pv;
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (part == 0) {
        const float corr = (m_prev == -INFINITY) ? 0.f : expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float corr = c_s[ty * 2 + a];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[a][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float p0 = S[(ty * 2) * SP + c];
      const float p1 = S[(ty * 2 + 1) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = VS[c * D + tx + 16 * j];
        acc[0][j] = fmaf(p0, vv, acc[0][j]);
        acc[1][j] = fmaf(p1, vv, acc[1][j]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int r = ty * 2 + a;
    if (i0 + r >= Tq) continue;
    const float m = m_s[r];
    // the Tp - T virtual tail keys: logit MASK_NEG, v = 0
    const float l = l_s[r] + (float)(Tp - Tq) * expf(kMaskNeg - m);
    const float inv = l > 0.f ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    float* ob = out + base + (size_t)(i0 + r) * rs;
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[tx + 16 * j] = acc[a][j] * inv;
    if (tx == 0)
      lse[((size_t)b * H + h) * Tq + i0 + r] = m + logf(fmaxf(l, 1e-30f));
  }
}

template <typename T, int D, int E>
cudaError_t launch(const void* qc, const void* k, const void* v, const void* g,
                   const void* table, const float* pad, float* out, float* lse,
                   int B, int Tq, int Tp, int H, float scale, uint32_t thresh,
                   float inv_keep, int use_dropout, uint64_t seed,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, E>();
  cudaError_t err = cudaFuncSetAttribute(
      rel_fwd_kernel<T, D, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  rel_fwd_kernel<T, D, E><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qc), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const T*>(table), pad, out, lse, H, Tq, Tp, scale, thresh,
      inv_keep, use_dropout, seed);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qc, k, v: (B, T, H, D); g: (B, T, H, E); table: (T, E); all contiguous and
// one dtype, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1). (D, E) is (128, 256),
// the JETS width. pad: (B, T) fp32, 1.0 at padding keys. Tp >= T: keys in
// [T, Tp) are padded zero rows. out: (B, T, H, D) fp32; lse: (B, H, T) fp32.
// dropout_p in [0, 1): attention-weight dropout keyed by `seed`
// (dropout_hash.cuh; B, H and T below 2^16). Returns the launch's
// cudaError_t (0 = success).
int vt_flash_rel_fwd(const void* qc, const void* k, const void* v,
                     const void* g, const void* table, const float* pad,
                     float* out, float* lse, int B, int T, int Tp, int H,
                     int D, int E, int is_bf16, float scale, double dropout_p,
                     uint64_t seed, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || Tp < T || T >= 65536 || B >= 65536 ||
      H >= 65536 || !(dropout_p >= 0.0 && dropout_p < 1.0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int use_dropout = dropout_p > 0.0;
  const uint32_t thresh = vt_dropout_thresh(dropout_p);
  const float inv_keep = (float)(1.0 / (1.0 - dropout_p));
#define VT_REL(TYPE, DIM, EDIM)                                            \
  launch<TYPE, DIM, EDIM>(qc, k, v, g, table, pad, out, lse, B, T, Tp, H, \
                          scale, thresh, inv_keep, use_dropout, seed, s)
  if (E != 256) return (int)cudaErrorInvalidValue;
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 256: return (int)VT_REL(float, 128, 256);
    case 257: return (int)VT_REL(__nv_bfloat16, 128, 256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VT_REL
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
