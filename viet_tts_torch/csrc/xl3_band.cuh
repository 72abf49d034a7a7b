// K4's position logits in band form, shared by its tensor-core forward
// (xl3_fwd_band_kernel, flash_xl_attention.cu) and its backward's ds
// kernel (xl3_bwd_ds_kernel, flash_xl_attention_bwd.cu).
//
// K4's position term of pair (i, j) reads the projected table p (T, H, D)
// at an offset of rel = j - i: pos_ij = qv_i . p_{T-1+rel} for rel <= 0
// (the past), qv_{i+1} . p_{rel-2} for rel >= 2 (the future; the XL shift
// makes row i read row i + 1's scores), 0 at rel = 1. The pairs of a
// (64-query tile qt, 64-key tile kt) reach the 127 offsets rel = 64 (kt -
// qt) + u - 63, band column u in [0, 127). Staged as a (128, D) tile (the
// band; row 127 and the rel = 1 row zero), p becomes a matrix operand:
// X = qv band^T gives the logits in (row, offset) space, and a shear
// through shared memory, W[r][c] = X[r][c - r + 63], puts them in (row,
// key) space. A tile wholly in the past has only past columns, one wholly
// in the future only future ones, the diagonal tile both, split at u = 64
// (u_split below: columns from u_split on are future).

#pragma once

#include "xl_mma.cuh"

namespace {

constexpr int kX3 = 64;           // query rows and keys a tile
constexpr int kX3Band = 2 * kX3;  // band columns: a tile's 127 offsets j - i and a zero one

// Band columns below u_split are past, the rest future (the zero column
// rel = 1 is u_split itself when in range).
__host__ __device__ __forceinline__ int xl3_u_split(int kt, int qt) {
  return kX3 - kX3 * (kt - qt);
}

// The band of p that key tile kt of query tile qt reaches, by cp.async
// into BC (kX3Band, tile_ld(D)) from NT threads; the caller commits. Row u
// holds p_{T-1+rel} (past) or p_{rel-2} (future); zero at rel = 1, at
// u = 127 and where the row falls outside [0, T).
template <typename T, int D, int NT>
__device__ __forceinline__ void xl3_stage_band(T* BC, const T* p, int H, int h, int Tq,
                                               int kt, int qt) {
  constexpr int LD = tile_ld(D);
  constexpr int V = 16 / (int)sizeof(T), PER_ROW = D / V;
  for (int idx = threadIdx.x; idx < kX3Band * PER_ROW; idx += NT) {
    const int u = idx / PER_ROW, c = (idx % PER_ROW) * V;
    const int rel = kX3 * (kt - qt) + u - (kX3 - 1);
    const int row = rel >= 2 ? rel - 2 : Tq - 1 + rel;
    const bool in = u < kX3Band - 1 && rel != 1 && row >= 0 && row < Tq;
    cp_async16(BC + u * LD + c, in ? p + ((size_t)row * H + h) * D + c : p, in ? 16 : 0);
  }
}

// The position logits of one warp's pairs, rows r0 .. r0 + 15 and keys
// c0 .. c0 + NK - 1 of the tile, as band products on the tensor cores:
// X = qv band^T over the past columns and qv_{+1} band^T over the future
// ones (QV holds the tile's 65 rows of qv, tile_ld(D) a row), only over
// the band columns those pairs reach ([c0 + 48 - r0, c0 + NK + 62 - r0]),
// sheared into W[r * ldw + c] (c = u + r - 63) for exactly the warp's own
// (row, key) pairs: the warp reads back only what it wrote (__syncwarp).
template <bool SPLIT, typename T, int D, int NK>
__device__ __forceinline__ void xl3_band_logits(const T* QV, const T* BC, float* W, int ldw,
                                                int r0, int c0, int u_split, int lane) {
  constexpr int LD = tile_ld(D);
  const int g4 = lane >> 2, t4 = lane & 3;
  const int xlo = c0 + kX3 - 16 - r0, xhi = c0 + NK + kX3 - 2 - r0;
#pragma unroll
  for (int n0 = 0; n0 < kX3Band / 8; n0 += 4) {
    if (8 * n0 > xhi || 8 * n0 + 31 < xlo) continue;
    // 32 columns share one kind: u_split is a multiple of 64
    const T* A = QV + (8 * n0 >= u_split ? LD : 0);  // qv_{i+1} for the future
    float x[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) x[j][c] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 8) {
      uint32_t ah[4], al[4];
      frag_a<SPLIT>(A, LD, r0, k0, lane, ah, al);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u0 = 8 * (n0 + j);
        if (u0 > xhi || u0 + 7 < xlo) continue;
        uint32_t bh[2], bl[2];
        frag_b_nt<SPLIT>(BC, LD, u0, k0, lane, bh, bl);
        mma3<SPLIT>(x[j], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = r0 + g4 + 8 * (c >> 1);
        const int col = 8 * (n0 + j) + 2 * t4 + (c & 1) + r - (kX3 - 1);
        if (col >= c0 && col < c0 + NK) W[r * ldw + col] = x[j][c];
      }
  }
}

}  // namespace
