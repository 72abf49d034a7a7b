// The pieces that the flash forward (flash_xl_attention.cu: K1, K4-K7)
// and backward (flash_xl_attention_bwd.cu: K4 bwd, K5-K7 bwd-q / bwd-kv)
// kernels share: stream-element conversions, the attention-weight dropout
// arguments, the tensor-core building blocks (cp.async tile staging, the
// 3xTF32 split, mma.sync m16n8k8 TF32 and its fragments), the
// position-term kinds of the flash templates, and K5's rotation pass,
// which writes the rotated streams that both K5 forward and K5 bwd-q read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "dropout_hash.cuh"
#include "xl_rotation.cuh"

namespace {

// The position term of the flash templates (xl2_fwd_kernel, the bwd-q and
// dtab kernels), a template argument, so that it also names each instance
// and a profile tells the kernels apart:
constexpr int kPosXl = 0;     // K6: gA . t (past), gB . t (future), 0 at j = i + 1
constexpr int kPosXlRot = 1;  // K5: the same on the rotation pass's streams
constexpr int kPosRel = 2;    // K7: g . t at every key
constexpr int kPosNone = 3;   // K1: no position term (xl2_fwd_kernel only)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The stream dtype's rounding of an fp32 intermediate (the JAX `_mx`).
template <typename T>
__device__ __forceinline__ float to_stream(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// An fp32 value as a stream element.
template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16_rn(x);
  else
    return x;
}

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

// m / keep of weight (i, j): 1 without dropout, else 1 / (1 - p) or 0.
__device__ __forceinline__ float keep_scale(const DropArgs& drop, uint32_t key,
                                            int i, int j) {
  if (!drop.use) return 1.f;
  return vt_dropout_keep(key, i, j, drop.thresh) ? drop.inv_keep : 0.f;
}

// Row stride of a staged tile of X columns read by 64-bit fragment loads:
// an 8-element pad keeps every row 16-byte aligned for cp.async and, in
// fp32, puts the 8 rows of a fragment on distinct banks.
__host__ __device__ constexpr int tile_ld(int x) { return x + 8; }
// ... and of one read by scalar loads down its rows (k by n): 16 bytes of
// pad, 4 fp32 words, so that rows 2t and 2t+1 of a fragment miss each
// other's banks.
template <typename T, int X>
__host__ __device__ constexpr int tile_ld_nn() {
  return X + 16 / (int)sizeof(T);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows r0 .. r0 + R - 1 (zero rows from nrows on) and columns c0 .. c0 + C
// - 1 of a row-major matrix (row stride `stride` elements) into dst (R, ld),
// 16 bytes a copy by NT threads; the caller commits the group.
template <typename T, int R, int C, int NT>
__device__ __forceinline__ void cp_tile(T* dst, int ld, const T* src,
                                        size_t stride, int r0, int nrows,
                                        int c0) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int PER_ROW = C / V;
  static_assert(C % V == 0, "a tile row is whole 16-byte copies");
  for (int idx = threadIdx.x; idx < R * PER_ROW; idx += NT) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * V;
    const bool in = r0 + r < nrows;
    cp_async16(dst + r * ld + c,
               in ? src + (size_t)(r0 + r) * stride + c0 + c : src,
               in ? 16 : 0);
  }
}

// x = hi + lo, each a TF32 value (3xTF32): hi is x rounded to nearest
// (ties away, cvt.rna's rounding) on the bit pattern, lo the exact rest
// x - hi with its 13 low bits cleared (truncated). Integer and fp32 ops at
// the full rate, where cvt.rna.tf32.f32 issues at a quarter of it. Without
// SPLIT x is a bf16 value, exact in TF32: hi = x.
template <bool SPLIT>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if constexpr (SPLIT) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// Two consecutive stream elements as fp32 (one 64- or 32-bit load).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b on the tensor cores: 3xTF32 (lo hi + hi lo + hi hi, the small
// terms first) with SPLIT, else one TF32 product (bf16 operands).
template <bool SPLIT>
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4],
                                     const uint32_t al[4],
                                     const uint32_t bh[2],
                                     const uint32_t bl[2]) {
  if constexpr (SPLIT) {
    mma_tf32(c, al, bh);
    mma_tf32(c, ah, bl);
  }
  mma_tf32(c, ah, bh);
}

// Fragments of m16n8k8. The contraction order inside each 8-step is free,
// so every operand takes the same permutation of it: the fragment's k slot
// t is the tile's column (or row) k0 + 2t and slot t + 4 is k0 + 2t + 1.
// Slots (t, t+4) are then two neighbouring elements, one 64-bit load, and
// the accumulator layout (columns 2t, 2t+1) is an A fragment as it stands.

// The A fragment (16 x 8, row-major) at rows m0.., columns k0.. of a staged
// tile (ld elements a row): lane (g, t) holds rows g and g + 8, columns
// k0 + 2t and k0 + 2t + 1, in slots (g, t), (g+8, t), (g, t+4), (g+8, t+4).
template <bool SPLIT, typename T>
__device__ __forceinline__ void frag_a(const T* A, int ld, int m0, int k0,
                                       int lane, uint32_t ah[4],
                                       uint32_t al[4]) {
  const int g = lane >> 2, t = lane & 3;
  const T* p = A + (m0 + g) * ld + k0 + 2 * t;
  const float2 r0 = load2(p), r1 = load2(p + 8 * ld);
  split_tf32<SPLIT>(r0.x, ah[0], al[0]);
  split_tf32<SPLIT>(r1.x, ah[1], al[1]);
  split_tf32<SPLIT>(r0.y, ah[2], al[2]);
  split_tf32<SPLIT>(r1.y, ah[3], al[3]);
}

// The B fragment (8 x 8, k by n) at columns n0.., depth k0.. of a tile
// staged with n as its rows (B^T row-major): lane (g, t) holds column
// n0 + g at depths k0 + 2t, k0 + 2t + 1.
template <bool SPLIT, typename T>
__device__ __forceinline__ void frag_b_nt(const T* Bt, int ld, int n0, int k0,
                                          int lane, uint32_t bh[2],
                                          uint32_t bl[2]) {
  const int g = lane >> 2, t = lane & 3;
  const float2 r = load2(Bt + (n0 + g) * ld + k0 + 2 * t);
  split_tf32<SPLIT>(r.x, bh[0], bl[0]);
  split_tf32<SPLIT>(r.y, bh[1], bl[1]);
}

// The same fragment from a tile staged with k as its rows (B row-major).
template <bool SPLIT, typename T>
__device__ __forceinline__ void frag_b_nn(const T* Bm, int ld, int n0, int k0,
                                          int lane, uint32_t bh[2],
                                          uint32_t bl[2]) {
  const int g = lane >> 2, t = lane & 3;
  const T* p = Bm + (k0 + 2 * t) * ld + n0 + g;
  split_tf32<SPLIT>(to_float(p[0]), bh[0], bl[0]);
  split_tf32<SPLIT>(to_float(p[ld]), bh[1], bl[1]);
}

constexpr int kRotThreads = 256;

// K5 only: gA_i = rot(g2_i, A_i), gB_i = rot(g2_{i+1}, B_i), rounded to the
// stream dtype (both K5 forward and bwd-q read them); one thread a pair.
template <typename T>
__global__ void __launch_bounds__(kRotThreads)
    xl2_rotate_kernel(const T* __restrict__ g2, T* __restrict__ ga,
                          T* __restrict__ gb, int B, int H, int Tq, int E,
                          float freq_coef) {
  const int half = E / 2;
  const size_t n = (size_t)B * Tq * H * half;
  const size_t rse = (size_t)H * E;
  for (size_t idx = (size_t)blockIdx.x * kRotThreads + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * kRotThreads) {
    const int m = (int)(idx % half);
    const size_t bih = idx / half;  // (b, i, h)
    const int qi = (int)((bih / H) % Tq);
    const size_t off = bih * E + 2 * m;
    const VtXl2Angles ang = vt_xl2_angles(Tq, qi, m, freq_coef);
    const float2 a2 =
        vt_rot(to_float(g2[off]), to_float(g2[off + 1]), ang.ca, ang.sa);
    float ne = 0.f, no = 0.f;
    if (qi + 1 < Tq) {
      ne = to_float(g2[off + rse]);
      no = to_float(g2[off + rse + 1]);
    }
    const float2 b2 = vt_rot(ne, no, ang.cb, ang.sb);
    ga[off] = from_float<T>(a2.x);
    ga[off + 1] = from_float<T>(a2.y);
    gb[off] = from_float<T>(b2.x);
    gb[off + 1] = from_float<T>(b2.y);
  }
}

// Launches xl2_rotate_kernel over the (B, T, H, E / 2) pairs of g2 on
// stream: gA and gB (B, T, H, E) in g2's dtype.
template <typename T>
cudaError_t launch_xl2_rotate(const T* g2, T* ga, T* gb, int B, int H, int Tq,
                              int E, cudaStream_t stream) {
  const float freq_coef = (float)(-2.0 * log(10000.0) / (double)E);
  const size_t n_pairs = (size_t)B * Tq * H * (E / 2);
  const size_t blocks = (n_pairs + kRotThreads - 1) / kRotThreads;
  const int grid =
      (int)(blocks < 132 * 8 ? (blocks > 0 ? blocks : 1) : 132 * 8);
  xl2_rotate_kernel<T><<<grid, kRotThreads, 0, stream>>>(g2, ga, gb, B, H, Tq,
                                                         E, freq_coef);
  return cudaGetLastError();
}

}  // namespace
