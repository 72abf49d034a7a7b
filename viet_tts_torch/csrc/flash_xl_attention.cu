// Kernels K4, K5 and K6: Transformer-XL relative-position attention forward
// (the FS2 conformer's self-attention; K6 also the JETS conformer's legacy
// rel-pos flavour) with an online softmax, for Hopper (sm_90a).
//
// Replace the TPU kernels of viet_tts_tpu/ops/pallas_attention.py:
//   K4 `_xl3_kernel` (launched by `_xl3_pallas`), the projected-table form;
//   K5 `_xl2_kernel` (`_xl2_pallas` through `_call_flash`), one position
//      stream rotated inside the kernel;
//   K6 `_xl_kernel` (`_xl_pallas` through `_call_flash`), two pre-rotated
//      position streams.
// All three compute ctx_i = sum_j softmax_j(logit_ij) v_j with
//   logit_ij = (qc_i . k_j + pos_ij) * scale, MASK_NEG = -1e9 at padded keys,
//   pos_ij   = P_i(j)  for j <= i  (the past term)
//            = 0       for j == i + 1
//            = F_i(j)  for j >= i + 2 (the future term: the XL shift makes
//                                      row i read row i + 1's scores),
// and emit the per-row logsumexp beside the fp32 context. Inputs are fp32 or
// bf16 in the JAX package's feature-last layouts, read in place; all
// arithmetic is fp32.
//
// K4: P_i(j) = qv_i . p_{T-1-i+j} and F_i(j) = qv_{i+1} . p_{j-i-2}, with p
// the projected table (T, H, D). The TPU keeps the whole (tp, tp) score tile
// in VMEM and shears it with lane rolls, over p left-padded to tp (a multiple
// of 128) and read at (j-i-1) mod tp and (j-i-2+d_pad) mod tp. Written out,
// those indices are T-1-(i-j) and j-i-2 for every real key (no wrap-around
// reaches a key below T), and the wrapper's tail keys score 2*MASK_NEG, so
// they weigh exactly 0 even in a row whose keys are all padding. Here the
// kernel tiles queries and keys (64 x 64) and never forms the tail: for a
// tile it stages the band of 127 rows of p that the tile's offsets j - i
// reach, once for the past and once for the future term (only where the tile
// has such pairs), and dots qv (and qv one row down) with them directly.
//
// K5 and K6: P_i(j) = gA_i . t_j and F_i(j) = gB_i . t_j against the raw
// sinusoid table t (T, E), E = d_model = 384. K6 reads gA and gB. K5 reads
// g = K_h(q + v_bias) and rotates its (2m, 2m+1) pairs per row, gA_i =
// rot(g_i, (T-1-i) w_m) and gB_i = rot(g_{i+1}, -(i+2) w_m), w_m =
// exp(m * (-2 ln 10000 / E)): the TPU kernel's own formula
// (`_xl2_cos_sin`), with the accurate expf and sincosf (angles reach
// ~2000 rad). The pair layout is the interleaved one of the inputs; the TPU
// de-interleaves it for its lanes, which changes no dot product. Row i's gB
// needs g_{i+1}, which lies past the query tile for its last row: the block
// reads it from device memory. The rotated (32, E) tiles of gA and gB stay in
// shared memory for the block's whole key sweep: 2 * 32 * 388 * 4 B = 99 KB
// (at bq = 64 they would need 199 KB of the 227 KB a block may have, so the
// query tile is 32 rows); the table is staged per key tile in chunks of 64
// columns. A key tile wholly past (or wholly future) of the query tile
// computes only the term it selects. The wrapper pads T to Tp (a multiple
// of 32) and marks the tail as padded keys; here the Tp - T tail keys are
// virtual: they add (Tp - T) * exp(MASK_NEG - m) to the denominator and
// nothing to the context, so a row whose keys are all padding averages v
// over all Tp keys, as the TPU kernel and the dense path do.
//
// What bounds them on the H100: at the decoder shape (B=16, H=8, T=1008,
// D=48, E=384) K5 does 2*B*H*T^2*(D + E + D) = 1.25e11 FLOP of dot products
// against ~260 MB of inputs: bound by operations. This first version runs
// every product on the fp32 CUDA cores (ceiling 67 TFLOP/s), with register
// tiles fed from shared memory; no (T, T) matrix reaches device memory.
//
// Attention-weight dropout (training, dropout_p > 0) follows the JAX
// package's semantics, as K1 does: the softmax denominator takes the
// undropped weights, the context sums p * keep / (1 - p) * v. The keep bit of
// weight (i, j) is dropout_hash.cuh's keep(seed, b, h, i, j), which depends on
// no tile size, so the backward kernels (flash_xl_attention_bwd.cu) draw the
// same bits with their own tilings. With dropout_p = 0 no bit is drawn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "xl_rotation.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kMaskNeg = -1.0e9f;

struct DropArgs {
  uint32_t thresh;
  float inv_keep;
  int use;
  uint64_t seed;
};

DropArgs drop_args(double dropout_p, uint64_t seed) {
  DropArgs a;
  a.thresh = vt_dropout_thresh(dropout_p);
  a.inv_keep = (float)(1.0 / (1.0 - dropout_p));
  a.use = dropout_p > 0.0;
  a.seed = seed;
  return a;
}

// Dropout on a tile of softmax numerators S (BQ, BK), row stride SP, after
// the online-softmax step has summed them: each weight is kept and scaled
// by 1 / (1 - p), or zeroed. Query i0 + r, key j0 + c.
template <int BQ, int BK>
__device__ __forceinline__ void drop_tile(float* S, int SP, const DropArgs& drop,
                                          uint32_t key, int i0, int j0,
                                          int tid) {
  for (int i = tid; i < BQ * BK; i += kThreads) {
    const int r = i / BK, c = i % BK;
    S[r * SP + c] = vt_dropout_keep(key, i0 + r, j0 + c, drop.thresh)
                        ? S[r * SP + c] * drop.inv_keep
                        : 0.f;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A value rounded to the stream dtype (the TPU kernel casts the rotated
// streams to the table's dtype before its matrix unit takes them).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One online-softmax step over a (BQ, BK) tile of logits in S (row stride
// SP): the running max m_s and denominator l_s per row are updated, S is
// replaced by exp(logit - m_new), and c_s holds each row's correction factor
// exp(m_prev - m_new) for the accumulator. kThreads / BQ threads a row.
// Every tile holds a real key (logit >= MASK_NEG), so m_new is finite.
template <int BQ, int BK>
__device__ __forceinline__ void softmax_step(float* S, int SP, float* m_s,
                                             float* l_s, float* c_s,
                                             int tid) {
  constexpr int TPR = kThreads / BQ;
  const int r = tid / TPR, part = tid % TPR;
  float mx = -INFINITY;
  for (int c = part; c < BK; c += TPR) mx = fmaxf(mx, S[r * SP + c]);
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float m_prev = m_s[r];
  const float m_new = fmaxf(m_prev, mx);
  float sum = 0.f;
  for (int c = part; c < BK; c += TPR) {
    const float p = expf(S[r * SP + c] - m_new);
    sum += p;
    S[r * SP + c] = p;
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

// ---------------------------------------------------------------------------
// K4: xl3, projected table
// ---------------------------------------------------------------------------

constexpr int kBQ3 = 64;
constexpr int kBK3 = 64;
constexpr int kBand = kBQ3 + kBK3 - 1;  // offsets j - i one tile reaches

template <int D>
constexpr size_t xl3_smem_bytes() {
  // QC (BQ, D+1), QV (BQ+1, D+1), KS (BK, D+1), VS (BK, D), two bands
  // (127, D+1), S (BQ, BK+1), m / l / corr (BQ each)
  return sizeof(float) * (kBQ3 * (D + 1) + (kBQ3 + 1) * (D + 1) +
                          kBK3 * (D + 1) + kBK3 * D + 2 * kBand * (D + 1) +
                          kBQ3 * (kBK3 + 1) + 3 * kBQ3);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    xl3_fwd_kernel(const T* __restrict__ qc, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ qv,
                   const T* __restrict__ p, const float* __restrict__ pad,
                   float* __restrict__ out, float* __restrict__ lse, int H,
                   int Tq, float scale, DropArgs drop) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int SP = kBK3 + 1;
  constexpr int DJ = D / 16;

  extern __shared__ __align__(16) float smem[];
  float* QC = smem;
  float* QV = QC + kBQ3 * DP;
  float* KS = QV + (kBQ3 + 1) * DP;
  float* VS = KS + kBK3 * DP;
  float* PP = VS + kBK3 * D;
  float* PF = PP + kBand * DP;
  float* S = PF + kBand * DP;
  float* m_s = S + kBQ3 * SP;
  float* l_s = m_s + kBQ3;
  float* c_s = l_s + kBQ3;

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kBQ3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rs = (size_t)H * D;  // row stride of (B, T, H, D)
  const size_t base = (size_t)b * Tq * rs + (size_t)h * D;
  const float* padb = pad + (size_t)b * Tq;
  const uint32_t drop_key = vt_dropout_key(drop.seed, b, h);

  for (int i = tid; i < (kBQ3 + 1) * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const bool in = i0 + r < Tq;
    const size_t off = base + (size_t)(i0 + r) * rs + d;
    QV[r * DP + d] = in ? to_float(qv[off]) : 0.f;
    if (r < kBQ3) QC[r * DP + d] = in ? to_float(qc[off]) : 0.f;
  }
  if (tid < kBQ3) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // (ty, tx): query rows ty*4 + a, key columns tx*4 + c (contiguous, so the
  // 16 (a, c) pairs reach only 7 band rows); accumulator columns tx + 16*j
  const int ty = tid / 16, tx = tid % 16;
  const int u0 = 4 * tx - 4 * ty + kBQ3 - 4;  // band row of (a, c) = u0+c-a+3
  float acc[4][DJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[a][j] = 0.f;

  for (int j0 = 0; j0 < Tq; j0 += kBK3) {
    const bool need_past = j0 <= i0 + kBQ3 - 1;     // some j <= i
    const bool need_fut = j0 + kBK3 - 1 >= i0 + 2;  // some j >= i + 2
    __syncthreads();  // the previous tile's KS / VS / bands / S are read
    for (int i = tid; i < kBK3 * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = j0 + r < Tq;
      const size_t off = base + (size_t)(j0 + r) * rs + d;
      KS[r * DP + d] = in ? to_float(k[off]) : 0.f;
      VS[r * D + d] = in ? to_float(v[off]) : 0.f;
    }
    // band row u holds p[c] with c = T-1-i+j (past) or j-i-2 (future) for
    // the pairs with (j - j0) - (i - i0) = u - (BQ - 1); rows outside
    // [0, T) are never selected and stay 0
    const int c_past = Tq - 1 - i0 - (kBQ3 - 1) + j0;
    const int c_fut = j0 - i0 - (kBQ3 - 1) - 2;
    for (int i = tid; i < kBand * D; i += kThreads) {
      const int u = i / D, d = i % D;
      if (need_past) {
        const int c = c_past + u;
        PP[u * DP + d] =
            (c >= 0 && c < Tq) ? to_float(p[((size_t)c * H + h) * D + d]) : 0.f;
      }
      if (need_fut) {
        const int c = c_fut + u;
        PF[u * DP + d] =
            (c >= 0 && c < Tq) ? to_float(p[((size_t)c * H + h) * D + d]) : 0.f;
      }
    }
    __syncthreads();

    float s[4][4], sp[4][4], sf[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = sp[a][c] = sf[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float q4[4], k4[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) q4[a] = QC[(ty * 4 + a) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) k4[c] = KS[(tx * 4 + c) * DP + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(q4[a], k4[c], s[a][c]);
      float qv5[5];
#pragma unroll
      for (int a = 0; a < 5; ++a) qv5[a] = QV[(ty * 4 + a) * DP + d];
      if (need_past) {
        float band[7];
#pragma unroll
        for (int t = 0; t < 7; ++t) band[t] = PP[(u0 + t) * DP + d];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            sp[a][c] = fmaf(qv5[a], band[c - a + 3], sp[a][c]);
      }
      if (need_fut) {
        float band[7];
#pragma unroll
        for (int t = 0; t < 7; ++t) band[t] = PF[(u0 + t) * DP + d];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            sf[a][c] = fmaf(qv5[a + 1], band[c - a + 3], sf[a][c]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty * 4 + a, qi = i0 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx * 4 + c, kj = j0 + col;
        float val;
        if (kj >= Tq) {
          val = -INFINITY;  // past the last key: weighs nothing
        } else if (padb[kj] > 0.5f) {
          val = kMaskNeg;
        } else {
          const float pos =
              kj <= qi ? sp[a][c] : (kj >= qi + 2 ? sf[a][c] : 0.f);
          val = (s[a][c] + pos) * scale;
        }
        S[r * SP + col] = val;
      }
    }
    __syncthreads();
    softmax_step<kBQ3, kBK3>(S, SP, m_s, l_s, c_s, tid);
    __syncthreads();
    if (drop.use) {
      drop_tile<kBQ3, kBK3>(S, SP, drop, drop_key, i0, j0, tid);
      __syncthreads();
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float corr = c_s[ty * 4 + a];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[a][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK3; ++c) {
      float pr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pr[a] = S[(ty * 4 + a) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = VS[c * D + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][j] = fmaf(pr[a], vv, acc[a][j]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty * 4 + a;
    if (i0 + r >= Tq) continue;
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    float* ob = out + base + (size_t)(i0 + r) * rs;
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[tx + 16 * j] = acc[a][j] * inv;
    if (tx == 0)
      lse[((size_t)b * H + h) * Tq + i0 + r] = m_s[r] + logf(fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// K5 (ROTATE) and K6: xl2 / xl, position streams against the raw table
// ---------------------------------------------------------------------------

constexpr int kBQ2 = 32;
constexpr int kBK2 = 64;
constexpr int kEC = 64;  // table columns staged at a time
constexpr int kTS = kEC + 4;

template <int D>
size_t xl2_smem_bytes(int E) {
  // GA, GB (BQ, E+4); QC (BQ, D+4); KS (BK, D+4); VS (BK, D);
  // TS (BK, EC+4); S (BQ, BK+1); m / l / corr (BQ each). Rows of the float4
  // operands are padded by 4 floats: 16-byte aligned, and the 8 threads of
  // a quarter warp reading 8 rows hit 8 different bank groups.
  return sizeof(float) * (2 * kBQ2 * (E + 4) + kBQ2 * (D + 4) +
                          kBK2 * (D + 4) + kBK2 * D + kBK2 * kTS +
                          kBQ2 * (kBK2 + 1) + 3 * kBQ2);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T, int D, bool ROTATE>
__global__ void __launch_bounds__(kThreads)
    xl2_fwd_kernel(const T* __restrict__ qc, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ ga,
                   const T* __restrict__ gb, const T* __restrict__ table,
                   const float* __restrict__ pad, float* __restrict__ out,
                   float* __restrict__ lse, int H, int Tq, int Tp, int E,
                   float scale, float freq_coef, DropArgs drop) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int DS = D + 4;
  constexpr int SP = kBK2 + 1;
  constexpr int DJ = D / 16;
  const int ES = E + 4;

  extern __shared__ __align__(16) float smem[];
  float* GA = smem;
  float* GB = GA + kBQ2 * ES;
  float* QC = GB + kBQ2 * ES;
  float* KS = QC + kBQ2 * DS;
  float* VS = KS + kBK2 * DS;
  float* TS = VS + kBK2 * D;
  float* S = TS + kBK2 * kTS;
  float* m_s = S + kBQ2 * SP;
  float* l_s = m_s + kBQ2;
  float* c_s = l_s + kBQ2;

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kBQ2;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * Tq * rs + (size_t)h * D;
  const size_t rse = (size_t)H * E;  // row stride of (B, T, H, E)
  const size_t base_e = (size_t)b * Tq * rse + (size_t)h * E;
  const float* padb = pad + (size_t)b * Tq;
  const uint32_t drop_key = vt_dropout_key(drop.seed, b, h);

  for (int i = tid; i < kBQ2 * D; i += kThreads) {
    const int r = i / D, d = i % D;
    QC[r * DS + d] =
        (i0 + r < Tq) ? to_float(qc[base + (size_t)(i0 + r) * rs + d]) : 0.f;
  }
  if (ROTATE) {
    // gA_i = rot(g_i, (T-1-i) w), gB_i = rot(g_{i+1}, -(i+2) w); rows past
    // the sequence are zero rows (the wrapper's padding)
    const int half = E / 2;
    for (int i = tid; i < kBQ2 * half; i += kThreads) {
      const int r = i / half, m = i % half;
      const int qi = i0 + r;
      const VtXl2Angles ang = vt_xl2_angles(Tq, qi, m, freq_coef);
      const float ca = ang.ca, sa = ang.sa, cb = ang.cb, sb = ang.sb;
      float ge = 0.f, go = 0.f, ne = 0.f, no = 0.f;
      if (qi < Tq) {
        const size_t off = base_e + (size_t)qi * rse + 2 * m;
        ge = to_float(ga[off]);
        go = to_float(ga[off + 1]);
      }
      if (qi + 1 < Tq) {
        const size_t off = base_e + (size_t)(qi + 1) * rse + 2 * m;
        ne = to_float(ga[off]);
        no = to_float(ga[off + 1]);
      }
      const float2 a2 = vt_rot(ge, go, ca, sa), b2 = vt_rot(ne, no, cb, sb);
      GA[r * ES + 2 * m] = round_to<T>(a2.x);
      GA[r * ES + 2 * m + 1] = round_to<T>(a2.y);
      GB[r * ES + 2 * m] = round_to<T>(b2.x);
      GB[r * ES + 2 * m + 1] = round_to<T>(b2.y);
    }
  } else {
    for (int i = tid; i < kBQ2 * E; i += kThreads) {
      const int r = i / E, e = i % E;
      const bool in = i0 + r < Tq;
      const size_t off = base_e + (size_t)(i0 + r) * rse + e;
      GA[r * ES + e] = in ? to_float(ga[off]) : 0.f;
      GB[r * ES + e] = in ? to_float(gb[off]) : 0.f;
    }
  }
  if (tid < kBQ2) {
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

  for (int j0 = 0; j0 < Tq; j0 += kBK2) {
    const bool need_past = j0 <= i0 + kBQ2 - 1;
    const bool need_fut = j0 + kBK2 - 1 >= i0 + 2;
    __syncthreads();
    for (int i = tid; i < kBK2 * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = j0 + r < Tq;
      const size_t off = base + (size_t)(j0 + r) * rs + d;
      KS[r * DS + d] = in ? to_float(k[off]) : 0.f;
      VS[r * D + d] = in ? to_float(v[off]) : 0.f;
    }
    __syncthreads();

    float s[2][4], pa[2][4], pb[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = pa[a][c] = pb[a][c] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 q4[2], k4[4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        q4[a] = *reinterpret_cast<const float4*>(&QC[(ty * 2 + a) * DS + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        k4[c] = *reinterpret_cast<const float4*>(&KS[(tx + 16 * c) * DS + d]);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = dot4(q4[a], k4[c], s[a][c]);
    }

    for (int e0 = 0; e0 < E; e0 += kEC) {
      __syncthreads();  // the previous chunk of TS is read
      for (int i = tid; i < kBK2 * kEC; i += kThreads) {
        const int r = i / kEC, e = i % kEC;
        TS[r * kTS + e] = (j0 + r < Tq)
                              ? to_float(table[(size_t)(j0 + r) * E + e0 + e])
                              : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int e = 0; e < kEC; e += 4) {
        float4 t4[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          t4[c] = *reinterpret_cast<const float4*>(&TS[(tx + 16 * c) * kTS + e]);
        if (need_past) {
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const float4 g4 =
                *reinterpret_cast<const float4*>(&GA[(ty * 2 + a) * ES + e0 + e]);
#pragma unroll
            for (int c = 0; c < 4; ++c) pa[a][c] = dot4(g4, t4[c], pa[a][c]);
          }
        }
        if (need_fut) {
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const float4 g4 =
                *reinterpret_cast<const float4*>(&GB[(ty * 2 + a) * ES + e0 + e]);
#pragma unroll
            for (int c = 0; c < 4; ++c) pb[a][c] = dot4(g4, t4[c], pb[a][c]);
          }
        }
      }
    }

#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = ty * 2 + a, qi = i0 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c, kj = j0 + col;
        float val;
        if (kj >= Tq) {
          val = -INFINITY;  // the tail is added in closed form below
        } else if (padb[kj] > 0.5f) {
          val = kMaskNeg;
        } else {
          const float pos =
              kj <= qi ? pa[a][c] : (kj >= qi + 2 ? pb[a][c] : 0.f);
          val = (s[a][c] + pos) * scale;
        }
        S[r * SP + col] = val;
      }
    }
    __syncthreads();
    softmax_step<kBQ2, kBK2>(S, SP, m_s, l_s, c_s, tid);
    __syncthreads();
    if (drop.use) {
      drop_tile<kBQ2, kBK2>(S, SP, drop, drop_key, i0, j0, tid);
      __syncthreads();
    }

#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float corr = c_s[ty * 2 + a];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[a][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK2; ++c) {
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

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_xl3(const void* qc, const void* k, const void* v,
                       const void* qv, const void* p, const float* pad,
                       float* out, float* lse, int B, int Tq, int H,
                       float scale, DropArgs drop, cudaStream_t stream) {
  constexpr size_t smem = xl3_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      xl3_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBQ3 - 1) / kBQ3, H, B);
  xl3_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qc), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(qv),
      static_cast<const T*>(p), pad, out, lse, H, Tq, scale, drop);
  return cudaGetLastError();
}

template <typename T, int D, bool ROTATE>
cudaError_t launch_xl2(const void* qc, const void* k, const void* v,
                       const void* ga, const void* gb, const void* table,
                       const float* pad, float* out, float* lse, int B, int Tq,
                       int Tp, int H, int E, float scale, DropArgs drop,
                       cudaStream_t stream) {
  const size_t smem = xl2_smem_bytes<D>(E);
  cudaError_t err = cudaFuncSetAttribute(
      xl2_fwd_kernel<T, D, ROTATE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float freq_coef = (float)(-2.0 * log(10000.0) / (double)E);
  dim3 grid((Tq + kBQ2 - 1) / kBQ2, H, B);
  xl2_fwd_kernel<T, D, ROTATE><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qc), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(ga),
      static_cast<const T*>(gb), static_cast<const T*>(table), pad, out, lse,
      H, Tq, Tp, E, scale, freq_coef, drop);
  return cudaGetLastError();
}

bool bad_sizes(int B, int T, int H, double dropout_p) {
  return B <= 0 || H <= 0 || T <= 0 || B >= 65536 || H >= 65536 ||
         T >= 65536 || !(dropout_p >= 0.0 && dropout_p < 1.0);
}

template <bool ROTATE>
int xl2_entry(const void* qc, const void* k, const void* v, const void* ga,
              const void* gb, const void* table, const float* pad, float* out,
              float* lse, int B, int T, int Tp, int H, int D, int E,
              int is_bf16, float scale, double dropout_p, uint64_t seed,
              void* stream) {
  if (bad_sizes(B, T, H, dropout_p) || Tp < T || E <= 0 || E % kEC != 0 ||
      xl2_smem_bytes<64>(E) > 232448 ||
      (D == 128 && (ROTATE || xl2_smem_bytes<128>(E) > 232448)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropArgs drop = drop_args(dropout_p, seed);
#define VT_XL2(TYPE, DIM)                                                    \
  launch_xl2<TYPE, DIM, ROTATE>(qc, k, v, ga, gb, table, pad, out, lse, B, T, \
                                Tp, H, E, scale, drop, s)
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 96: return (int)VT_XL2(float, 48);
    case 97: return (int)VT_XL2(__nv_bfloat16, 48);
    case 128: return (int)VT_XL2(float, 64);
    case 129: return (int)VT_XL2(__nv_bfloat16, 64);
    default: break;
  }
  // D = 128 (the JETS conformer's legacy rel-pos flavour, E = 256): the
  // two-stream kernel K6 only
  if constexpr (!ROTATE) {
    switch (D * 2 + (is_bf16 ? 1 : 0)) {
      case 256: return (int)VT_XL2(float, 128);
      case 257: return (int)VT_XL2(__nv_bfloat16, 128);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
#undef VT_XL2
}

}  // namespace

extern "C" {

// K4. qc, k, v, qv: (B, T, H, D) contiguous, fp32 (is_bf16 = 0) or bf16;
// p: (T, H, D) in the same dtype; pad: (B, T) fp32, 1.0 at padding keys;
// out: (B, T, H, D) fp32; lse: (B, H, T) fp32. dropout_p in [0, 1):
// attention-weight dropout keyed by `seed` (dropout_hash.cuh). Returns the
// cudaError_t.
int vt_flash_xl3_fwd(const void* qc, const void* k, const void* v,
                     const void* qv, const void* p, const float* pad,
                     float* out, float* lse, int B, int T, int H, int D,
                     int is_bf16, float scale, double dropout_p, uint64_t seed,
                     void* stream) {
  if (bad_sizes(B, T, H, dropout_p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropArgs drop = drop_args(dropout_p, seed);
#define VT_XL3(TYPE, DIM) \
  launch_xl3<TYPE, DIM>(qc, k, v, qv, p, pad, out, lse, B, T, H, scale, drop, s)
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 96: return (int)VT_XL3(float, 48);
    case 97: return (int)VT_XL3(__nv_bfloat16, 48);
    case 128: return (int)VT_XL3(float, 64);
    case 129: return (int)VT_XL3(__nv_bfloat16, 64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VT_XL3
}

// K5. qc, k, v: (B, T, H, D); g: (B, T, H, E) unrotated; table: (T, E); all
// one dtype. Tp >= T: keys in [T, Tp) are padded zero rows. E a multiple of
// 64. Other arguments as K4.
int vt_flash_xl2_fwd(const void* qc, const void* k, const void* v,
                     const void* g, const void* table, const float* pad,
                     float* out, float* lse, int B, int T, int Tp, int H,
                     int D, int E, int is_bf16, float scale, double dropout_p,
                     uint64_t seed, void* stream) {
  return xl2_entry<true>(qc, k, v, g, nullptr, table, pad, out, lse, B, T, Tp,
                         H, D, E, is_bf16, scale, dropout_p, seed, stream);
}

// K6. gA, gB: (B, T, H, E) pre-rotated; other arguments as K5 (dropout
// included: the two-stream tiles draw the keep bit of the same (b, h, i, j)
// as K5's, and flash_xl_attention_bwd.cu's K6 bwd-q / bwd-kv draw it
// again), and D may also be 128.
int vt_flash_xl_fwd(const void* qc, const void* k, const void* v,
                    const void* ga, const void* gb, const void* table,
                    const float* pad, float* out, float* lse, int B, int T,
                    int Tp, int H, int D, int E, int is_bf16, float scale,
                    double dropout_p, uint64_t seed, void* stream) {
  return xl2_entry<false>(qc, k, v, ga, gb, table, pad, out, lse, B, T, Tp, H,
                          D, E, is_bf16, scale, dropout_p, seed, stream);
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
