// Kernels K4 bwd (xl3), K5 bwd-q / bwd-kv (xl2) and K6 bwd-q / bwd-kv (xl):
// the backward of the Transformer-XL attention (flash_xl_attention.cu) of
// the FS2 conformer and of the JETS conformer's legacy rel-pos flavour, for
// Hopper (sm_90a), with the forward's attention-weight dropout.
//
// Replace the TPU kernels of viet_tts_tpu/ops/pallas_attention.py:
//   K4 bwd     `_xl3_bwd_kernel` (launched by `_xl3_bwd_pallas`);
//   K5 bwd-q   `_xl2_bwd_q_kernel` (`_xl2_bwd_pallas` through `_call_bwd_q`);
//   K5 bwd-kv  `_xl2_bwd_kv_kernel` (`_xl2_bwd_pallas` through `_call_bwd_kv`);
//   K6 bwd-q   `_xl_bwd_q_kernel` (`_xl_bwd_pallas` through `_call_bwd_q`);
//   K6 bwd-kv  `_xl_bwd_kv_kernel` (`_xl_bwd_pallas` through `_call_bwd_kv`).
// With the forward's logits l_ij = (qc_i . k_j + pos_ij) * scale, its
// logsumexp lse_i and delta_i = sum_d g_id out_id (computed outside, as the
// JAX package does):
//   p   = exp(l - lse)                          (0 at padding keys)
//   ds  = p * (dp * m / keep - delta) * scale   (0 at padding keys)
//   dqc = ds k,   dk = ds^T qc,   dv = (p * m / keep)^T g,
// dp = g v^T, m the forward's keep bit (dropout_hash.cuh). The position term
// takes the rest of ds, split by the XL select into its past part dsA
// (j <= i) and its future part dsB (j >= i + 2):
//   K4: pos_ij = qv_i . p_{T-1-i+j} (past), qv_{i+1} . p_{j-i-2} (future), so
//       dqv_i = sum_j dsA_ij p_{T-1-i+j} + sum_j dsB_{i-1,j} p_{j-i-1} and
//       dp_c  = sum_{b,i,j} [T-1-i+j = c] dsA_ij qv_i
//             + sum_{b,i,j} [j-i-2 = c] dsB_ij qv_{i+1}, a sum along the
//       diagonals of every (query, key) tile and over the batch;
//   K5 / K6: pos_ij = gA_i . t_j (past), gB_i . t_j (future), so
//       dgA_i = sum_j dsA_ij t_j, dgB_i = sum_j dsB_ij t_j and
//       dt_j = sum_{b,h,i} dsA_ij gA_i + dsB_ij gB_i. K6 takes gA and gB
//       as inputs and returns dgA and dgB. K5 builds them from one stream,
//       gA_i = rot(g_i, A_i), gB_i = rot(g_{i+1}, B_i) (xl_rotation.cuh),
//       so its dg_i = rot^-1(dgA_i, A_i) + rot^-1(dgB_{i-1}, B_{i-1}).
//
// Design. On the TPU the grids run in order and carry sums from one grid
// step to the next in VMEM: K4 keeps the whole (T, T) tile and accumulates
// dp over the batch axis of its grid; K5's bwd-q keeps the whole-T query
// tile; K5 and K6 bwd-kv carry dt across the batch and head axes of their
// grids. Here blocks run in parallel, so a loop inside each block takes the
// place of the sequential axis, no two blocks write one output, and sums
// across blocks go through fp32 partials and a second pass: no atomics, the
// result is deterministic.
//  - K4 is one entry of three passes: `xl3_bwd_q_kernel`, one block per
//    (64-query tile, head, batch row) walking the 64-key tiles, gives dqc,
//    the two parts of dqv, and the tile's dp partial (each diagonal of a
//    (query, key) tile is one offset c, summed over its <= 64 pairs and
//    added into the block's own (T, D) slice); `xl3_bwd_kv_kernel`, one
//    block per (64-key tile, head, batch row) walking the query tiles,
//    gives dk and dv; `xl3_bwd_reduce_kernel` sums the dp partials over
//    batch rows and query tiles and adds row i-1's future part into dqv_i.
//    Both main kernels stage the 127-row band of p that a tile's offsets
//    j - i reach, as the forward does.
//  - K5 / K6 bwd-q run on the tensor cores, in two kernels so that no
//    E-wide accumulator lives inside the flash loop (Q1, Q2 below; K5 adds
//    an elementwise rotation before and its inverse after): at E = 384 the
//    E-wide products are 84 % of the work, and on the fp32 CUDA cores alone
//    they bound it above SDPA's whole backward. Every product is
//    `mma.sync.m16n8k8` TF32 with fp32
//    accumulation. fp32 streams take 3xTF32: x = hi + lo, hi rounded to
//    nearest (ties away, cvt.rna's rounding, done with integer ops: the cvt
//    instruction issues at a quarter of the rate), lo the exact rest with
//    its low 13 bits cleared, a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b; one
//    TF32 product keeps ~3 digits over E = 384 and misses the fp32 limit
//    of 1e-4 (tests/test_torch_xl_bwd_precision.py). bf16 streams are
//    exact in TF32 (8 mantissa bits of 11), and so is ds, rounded to bf16
//    as `_mx` does: one TF32 product per term, exact, with the fp32 path's
//    code. (Deviation from m16n8k16 bf16: one code path for both dtypes;
//    the training path runs fp32.)
//    * Q1 is two launches. `xl2_bwd_q1_pos_kernel`: the position logits of
//      every (64-query, 64-key) tile, pos = gA t^T (past) / gB t^T (future)
//      / 0, into a (B, H, T, Ts) fp32 scratch S (Ts = T rounded up to 128);
//      a tile wholly in the past forms only gA t^T, one in the future only
//      gB t^T; gA, gB and the table staged once a (query tile, key tile),
//      in 32-column chunks by cp.async two stages deep. It is its own
//      kernel because a query tile's E-wide rows (gA and gB, 196 KB at 64
//      rows, E = 384, fp32) cannot stay beside a staged table tile; the
//      cost is one write and one read of S (264 MB at (8, 8, 1008), 0.16
//      ms at 3.35 TB/s). `xl2_bwd_q1_ds_kernel`: one block a (64-query
//      tile, head, batch row), four warps of 16 rows, walking the 64-key
//      tiles (k, v by cp.async two stages deep; qc, g staged once): s =
//      pos + qc k^T, dp = g v^T, ds in the accumulators' layout, written
//      over the logits in S, and dqc += ds k with ds as the A operand
//      straight from the registers (see the fragments' permutation).
//    * Q2, `xl2_bwd_q2_kernel`: dgA = (ds o past) t and dgB = (ds o
//      future) t as a tensor-core product; one block a (64-query tile,
//      64-column table tile, A or B, (b, h)) walks only the 32-key chunks
//      its mask reaches (j <= i, j >= i + 2: half the dense work), masking
//      ds as its fragments load on the chunks across the diagonal.
//    * K5: `xl2_rotate_kernel` (xl_mma.cuh, shared with the forward)
//      writes gA, gB (stream dtype) before Q1; Q2 writes dgA into dg2 and dgB
//      into a scratch, and `xl2_bwd_unrotate_kernel` forms dg2_i =
//      rot^-1(dgA_i, A_i) + rot^-1(dgB_{i-1}, B_{i-1}) in place. K6 reads
//      gA, gB and writes dgA, dgB.
//    * The wrapper allocates S (and K5's gA, gB and dgB) with torch.empty;
//      the kernels allocate nothing. S adds 0.26 GB at (8, 8, 1008) and
//      0.54 GB at (4, 8, 2048); K5's streams another 0.30 GB at (8, 8, 1008).
//    * Budget, each instance at 128 threads a block (ptxas -v, sm_90a, the
//      CUDA toolkit of the H100 machine; no spill in any instance; blocks an
//      SM = the least of what registers and shared memory allow; unchanged
//      since the helpers moved to xl_mma.cuh):
//        kernel        dtype  D      smem B    regs  blocks/SM
//        q1_pos        fp32   -      61,440    123   3
//        q1_pos        bf16   -      30,720    114   4
//        q1_ds         fp32   48     86,016    168   2
//        q1_ds         fp32   64    110,592    231   2
//        q1_ds         fp32   128   208,896    254   1
//        q1_ds         bf16   48     43,008    164   3
//        q1_ds         bf16   64     55,296    168   3
//        q1_ds         bf16   128   104,448    228   2
//        q2            fp32   -      37,888     88   5
//        q2            bf16   -      29,696    117   4
//        rotate (xl_mma.cuh) / unrotate (256 threads): no shared memory,
//        28-30 registers (a 32-byte frame for sincosf's slow path).
//      Tiles: q1_pos (64 queries, 64 keys), E in chunks of 32; q1_ds (64
//      queries) by 64-key tiles; q2 (64 queries, 64 table columns) by
//      32-key chunks. Shared memory does not depend on E; E a multiple of
//      64 (q2's column tile). What bounds them, measured (H100, PR 7):
//      q1_pos and q2 issue about 40 other instructions (the fragment loads
//      and the hi / lo split) for every 24 mma.sync of a 3xTF32 k-step, and
//      run at ~25 % of the TF32 rate; tiles of 128 x 64 and 128 x 128, three
//      cp.async stages and an L2-friendlier grid order for q2 each moved
//      them by under 5 %, so neither L2 traffic nor load latency is the
//      limit. q1_ds splits every k and v element in all four warps. The next
//      step is wgmma with the operands split once into shared memory.
//  - K5 / K6 bwd-kv (`xl2_bwd_kv_kernel`): one block per (64-key tile, head,
//    batch row) walks 32-query tiles (K5 rotating each tile's gA and gB as
//    the forward does, K6 reading them) and gives dk and dv; with
//    `want_dtab` it also adds each (key tile, query tile)'s dt into the
//    block's (64, E) slice of a per-(b, h) partial, which
//    `xl2_bwd_dtab_kernel` sums. The conformers' table is the constant
//    sinusoid table, so training never asks for dt.
//  - A key tile wholly in the past of a query tile (every pair j <= i)
//    forms only the gA . t products, one wholly in the future only gB . t.
//  - K6 also runs at D = 128 (the JETS conformer, E = 256): bwd-kv then
//    needs 203 KB of shared memory, one block an SM.
//
// What bounds them on the H100: at the training shapes (FS2: B=8, H=8,
// D=48; K4 at T=512, K5 at T=1008, E=384) the data needs 2*B*H*T^2*8D =
// 12.9 GFLOP for K4 bwd (s, the position term, g v, dqc, dk, dv, dqv, dp),
// 2*B*H*T^2*(3D + 2E) = 119 GFLOP for K5 bwd-q and 2*B*H*T^2*(4D + E) = 75
// GFLOP for K5 bwd-kv (K6 the same), against tens to hundreds of MB: bound
// by operations. K4 bwd and K5 / K6 bwd-kv run every product on the fp32
// CUDA cores (67 TFLOP/s), with register tiles fed from shared memory;
// K5 / K6 bwd-q on the tensor cores (495 TFLOP/s TF32, three products a
// term for fp32 streams: 0.72 ms for K5 bwd-q at (8, 1008) if the tensor
// cores were the only limit; see the budget above for what is).
//
// Padding follows the forward. K4: keys past T are never formed (the
// reference scores them 2*MASK_NEG: weight exactly 0). K5 / K6: the Tp - T
// tail keys are virtual (dead, v = 0). A batch row whose keys are all
// padding has the uniform softmax, 1/T (K4) or 1/Tp (K5, K6), and lse =
// -1e9 + log n rounds to -1e9 in fp32, where exp(l - lse) would give 1:
// these kernels detect the row and use the uniform weight, the dense
// gradient (the TPU kernels' dv is n times too large there, as K3 notes
// for K1). bf16 streams mirror `_mx`: p m / keep and ds are rounded to
// bf16 before the products they feed, with fp32 accumulation; every
// gradient is written in fp32.

#include <limits.h>

#include "xl_mma.cuh"

namespace {

constexpr int kThreads = 256;

// True when batch row b has no live key (block-wide; every thread calls).
__device__ __forceinline__ bool row_all_dead(const float* padb, int Tq) {
  int live = 0;
  for (int j = threadIdx.x; j < Tq; j += blockDim.x) live |= padb[j] <= 0.5f;
  return !__syncthreads_or(live);
}

// Rows r0 .. r0 + n - 1 of a (B, T, H, X) stream (row stride rs, this
// (b, h)'s offset base) into dst (n, ld) as fp32; rows outside [0, Tq) are 0.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          size_t base, size_t rs, int r0,
                                          int n, int Tq, int X) {
  for (int i = threadIdx.x; i < n * X; i += kThreads) {
    const int r = i / X, x = i % X, row = r0 + r;
    dst[r * ld + x] = (row >= 0 && row < Tq)
                          ? to_float(src[base + (size_t)row * rs + x])
                          : 0.f;
  }
}

// Per-row lse and delta of rows r0 .. r0 + n - 1 (0 past Tq).
__device__ __forceinline__ void load_row_stats(float* lse_s, float* del_s,
                                               const float* lse,
                                               const float* delta,
                                               size_t rbase, int r0, int n,
                                               int Tq) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const bool in = r0 + r < Tq;
    lse_s[r] = in ? lse[rbase + r0 + r] : 0.f;
    del_s[r] = in ? delta[rbase + r0 + r] : 0.f;
  }
}

// 1.0 for keys j0 .. j0 + n - 1 that are padding or past Tq.
__device__ __forceinline__ void load_dead(float* dead_s, const float* padb,
                                          int j0, int n, int Tq) {
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const int key = j0 + c;
    dead_s[c] = (key >= Tq || padb[key] > 0.5f) ? 1.f : 0.f;
  }
}

// ---------------------------------------------------------------------------
// K4 bwd: xl3, projected table
// ---------------------------------------------------------------------------

constexpr int kBQ3 = 64;
constexpr int kBK3 = 64;
constexpr int kBand = kBQ3 + kBK3 - 1;  // offsets j - i one tile reaches

// Rows c0 .. c0 + 126 of the head-h slice of p (T, H, D) into a band
// (127, ld); rows outside [0, Tq) are never selected and stay 0.
template <typename T>
__device__ __forceinline__ void load_band(float* dst, int ld, const T* p,
                                          int c0, int Tq, int H, int h,
                                          int D) {
  for (int i = threadIdx.x; i < kBand * D; i += kThreads) {
    const int u = i / D, d = i % D, c = c0 + u;
    dst[u * ld + d] =
        (c >= 0 && c < Tq) ? to_float(p[((size_t)c * H + h) * D + d]) : 0.f;
  }
}

// Shared memory of both K4 bwd main kernels: QC, GS, KS, VS (64, D+1);
// QV (65, D+1); the past and future bands (127, D+1); two (64, 65) score
// tiles; lse, delta, dead (64 each).
template <int D>
constexpr size_t xl3_bwd_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + 65 * (D + 1) +
                          2 * kBand * (D + 1) + 2 * 64 * 65 + 3 * 64);
}

// The forward's four products on one (64 query, 64 key) tile, as the
// forward kernel computes them (same order of summation): thread (ty, tx)
// holds queries 4 ty + a and keys 4 tx + c. s = qc . k, pos = the XL select
// of qv . band (past) and qv_{+1} . band (future), dv = g . v.
template <int D>
__device__ __forceinline__ void xl3_tile_products(
    const float* QC, const float* QV, const float* GS, const float* KS,
    const float* VS, const float* PP, const float* PF, bool need_past,
    bool need_fut, int i0, int j0, int ty, int tx, float s[4][4],
    float pos[4][4], float dv[4][4]) {
  constexpr int DP = D + 1;
  const int u0 = 4 * tx - 4 * ty + kBQ3 - 4;  // band row of (a, c) = u0+c-a+3
  float sp[4][4], sf[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = sp[a][c] = sf[a][c] = dv[a][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float q4[4], g4[4], k4[4], v4[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      q4[a] = QC[(ty * 4 + a) * DP + d];
      g4[a] = GS[(ty * 4 + a) * DP + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      k4[c] = KS[(tx * 4 + c) * DP + d];
      v4[c] = VS[(tx * 4 + c) * DP + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(q4[a], k4[c], s[a][c]);
        dv[a][c] = fmaf(g4[a], v4[c], dv[a][c]);
      }
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
    const int qi = i0 + ty * 4 + a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kj = j0 + tx * 4 + c;
      pos[a][c] = kj <= qi ? sp[a][c] : (kj >= qi + 2 ? sf[a][c] : 0.f);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    xl3_bwd_q_kernel(const T* __restrict__ qc, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ qv,
                     const T* __restrict__ p, const T* __restrict__ g,
                     const float* __restrict__ pad,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dqc,
                     float* __restrict__ dqv_a, float* __restrict__ dqv_b,
                     float* __restrict__ dp_part, int H, int Tq, float scale,
                     DropArgs drop) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int SP = kBK3 + 1;
  constexpr int DJ = D / 16;

  extern __shared__ __align__(16) float smem[];
  float* QC = smem;
  float* GS = QC + kBQ3 * DP;
  float* KS = GS + kBQ3 * DP;
  float* VS = KS + kBK3 * DP;
  float* QV = VS + kBK3 * DP;
  float* PP = QV + (kBQ3 + 1) * DP;
  float* PF = PP + kBand * DP;
  float* dS = PF + kBand * DP;
  float* lse_s = dS + 2 * kBQ3 * SP;
  float* del_s = lse_s + kBQ3;
  float* dead_s = del_s + kBQ3;

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kBQ3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * Tq * rs + (size_t)h * D;
  const float* padb = pad + (size_t)b * Tq;
  const size_t rbase = ((size_t)b * H + h) * Tq;
  const uint32_t drop_key = vt_dropout_key(drop.seed, b, h);
  // this block's (T, D) slice of the dp partials (B, n_qtiles, H, T, D)
  float* part =
      dp_part + (((size_t)b * gridDim.x + blockIdx.x) * H + h) * Tq * D;

  // a fully padded batch row has ds = 0 everywhere: dqc, dqv and its dp
  // share are 0
  const bool all_dead = row_all_dead(padb, Tq);

  load_rows(QC, DP, qc, base, rs, i0, kBQ3, Tq, D);
  load_rows(GS, DP, g, base, rs, i0, kBQ3, Tq, D);
  load_rows(QV, DP, qv, base, rs, i0, kBQ3 + 1, Tq, D);
  load_row_stats(lse_s, del_s, lse, delta, rbase, i0, kBQ3, Tq);

  const int ty = tid / 16, tx = tid % 16;
  float acc_q[4][DJ], acc_a[4][DJ], acc_b[4][DJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_q[a][j] = acc_a[a][j] = acc_b[a][j] = 0.f;

  for (int j0 = 0; j0 < Tq && !all_dead; j0 += kBK3) {
    const bool need_past = j0 <= i0 + kBQ3 - 1;
    const bool need_fut = j0 + kBK3 - 1 >= i0 + 2;
    const int c_past = Tq - 1 - i0 - (kBQ3 - 1) + j0;
    const int c_fut = j0 - i0 - (kBQ3 - 1) - 2;
    __syncthreads();  // the previous tile's KS / VS / bands / dS are read
    load_rows(KS, DP, k, base, rs, j0, kBK3, Tq, D);
    load_rows(VS, DP, v, base, rs, j0, kBK3, Tq, D);
    load_dead(dead_s, padb, j0, kBK3, Tq);
    if (need_past) load_band(PP, DP, p, c_past, Tq, H, h, D);
    if (need_fut) load_band(PF, DP, p, c_fut, Tq, H, h, D);
    __syncthreads();

    float s[4][4], pos[4][4], dv[4][4];
    xl3_tile_products<D>(QC, QV, GS, KS, VS, PP, PF, need_past, need_fut, i0,
                         j0, ty, tx, s, pos, dv);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty * 4 + a, qi = i0 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx * 4 + c;
        float ds = 0.f;
        if (qi < Tq && dead_s[col] == 0.f) {
          const float pr = expf((s[a][c] + pos[a][c]) * scale - lse_s[r]);
          const float m = keep_scale(drop, drop_key, qi, j0 + col);
          ds = to_stream<T>(pr * (dv[a][c] * m - del_s[r]) * scale);
        }
        dS[r * SP + col] = ds;
      }
    }
    __syncthreads();

    // dqc += ds k; dqv (own row) += dsA band_past; dqv (next row) += dsB
    // band_fut. Thread (ty, tx): rows 4 ty + a, features tx + 16 j.
#pragma unroll 2
    for (int col = 0; col < kBK3; ++col) {
      const int kj = j0 + col;
      float w[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) w[a] = dS[(ty * 4 + a) * SP + col];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kk = KS[col * DP + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc_q[a][j] = fmaf(w[a], kk, acc_q[a][j]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty * 4 + a, qi = i0 + r, u = col - r + kBQ3 - 1;
        if (need_past && kj <= qi) {
#pragma unroll
          for (int j = 0; j < DJ; ++j)
            acc_a[a][j] = fmaf(w[a], PP[u * DP + tx + 16 * j], acc_a[a][j]);
        } else if (need_fut && kj >= qi + 2) {
#pragma unroll
          for (int j = 0; j < DJ; ++j)
            acc_b[a][j] = fmaf(w[a], PF[u * DP + tx + 16 * j], acc_b[a][j]);
        }
      }
    }

    // dp partial: diagonal u of the tile (pairs (a, u - 63 + a)) is the
    // offset j - i = j0 - i0 + u - 63, wholly past, the zero diagonal or
    // wholly future, and lands on c_past + u or c_fut + u. Past diagonals
    // first, then future ones: two diagonals of the two kinds may share an
    // offset c, and one thread at a time owns an address.
    for (int fut = 0; fut < 2; ++fut) {
      if (fut) __syncthreads();
      if (fut ? !need_fut : !need_past) continue;
      const int c0 = fut ? c_fut : c_past;
      for (int idx = tid; idx < kBand * D; idx += kThreads) {
        const int u = idx / D, d = idx % D;
        const int rel = j0 - i0 + u - (kBQ3 - 1);
        const int c = c0 + u;
        if ((fut ? rel < 2 : rel > 0) || c < 0 || c >= Tq) continue;
        const int a_lo = u < kBQ3 - 1 ? kBQ3 - 1 - u : 0;
        const int a_hi = u > kBK3 - 1 ? kBand - 1 - u : kBQ3 - 1;
        float sum = 0.f;
        for (int a = a_lo; a <= a_hi; ++a)
          sum = fmaf(dS[a * SP + u - (kBQ3 - 1) + a], QV[(a + fut) * DP + d],
                     sum);
        part[(size_t)c * D + d] += sum;
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = i0 + ty * 4 + a;
    if (qi >= Tq) continue;
    const size_t off = base + (size_t)qi * rs;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dqc[off + tx + 16 * j] = acc_q[a][j];
      dqv_a[off + tx + 16 * j] = acc_a[a][j];
      dqv_b[off + tx + 16 * j] = acc_b[a][j];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    xl3_bwd_kv_kernel(const T* __restrict__ qc, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ qv,
                      const T* __restrict__ p, const T* __restrict__ g,
                      const float* __restrict__ pad,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv_out, int H, int Tq, float scale,
                      DropArgs drop) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int SP = kBQ3 + 1;
  constexpr int DJ = D / 16;

  extern __shared__ __align__(16) float smem[];
  float* QC = smem;
  float* GS = QC + kBQ3 * DP;
  float* KS = GS + kBQ3 * DP;
  float* VS = KS + kBK3 * DP;
  float* QV = VS + kBK3 * DP;
  float* PP = QV + (kBQ3 + 1) * DP;
  float* PF = PP + kBand * DP;
  float* Pt = PF + kBand * DP;  // (key, query): p * m / keep
  float* dSt = Pt + kBK3 * SP;  // (key, query): ds
  float* lse_s = dSt + kBK3 * SP;
  float* del_s = lse_s + kBQ3;
  float* dead_s = del_s + kBQ3;

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kBK3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * Tq * rs + (size_t)h * D;
  const float* padb = pad + (size_t)b * Tq;
  const size_t rbase = ((size_t)b * H + h) * Tq;
  const uint32_t drop_key = vt_dropout_key(drop.seed, b, h);
  const float p_uniform = 1.f / (float)Tq;  // a fully padded row's weight

  const bool all_dead = row_all_dead(padb, Tq);

  load_rows(KS, DP, k, base, rs, j0, kBK3, Tq, D);
  load_rows(VS, DP, v, base, rs, j0, kBK3, Tq, D);
  load_dead(dead_s, padb, j0, kBK3, Tq);

  // scores: queries 4 ty + a, keys 4 tx + c; accumulators: keys 4 ty + i,
  // features tx + 16 j
  const int ty = tid / 16, tx = tid % 16;
  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int i0 = 0; i0 < Tq; i0 += kBQ3) {
    const bool need_past = j0 <= i0 + kBQ3 - 1;
    const bool need_fut = j0 + kBK3 - 1 >= i0 + 2;
    __syncthreads();  // the previous tile's QC / GS / QV / bands / Pt are read
    load_rows(QC, DP, qc, base, rs, i0, kBQ3, Tq, D);
    load_rows(GS, DP, g, base, rs, i0, kBQ3, Tq, D);
    load_rows(QV, DP, qv, base, rs, i0, kBQ3 + 1, Tq, D);
    load_row_stats(lse_s, del_s, lse, delta, rbase, i0, kBQ3, Tq);
    if (need_past)
      load_band(PP, DP, p, Tq - 1 - i0 - (kBQ3 - 1) + j0, Tq, H, h, D);
    if (need_fut) load_band(PF, DP, p, j0 - i0 - (kBQ3 - 1) - 2, Tq, H, h, D);
    __syncthreads();

    float s[4][4], pos[4][4], dv[4][4];
    xl3_tile_products<D>(QC, QV, GS, KS, VS, PP, PF, need_past, need_fut, i0,
                         j0, ty, tx, s, pos, dv);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty * 4 + a, qi = i0 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx * 4 + c, kj = j0 + col;
        float pv = 0.f, ds = 0.f;
        if (qi < Tq && kj < Tq) {
          const bool dead = dead_s[col] != 0.f;
          const float m = keep_scale(drop, drop_key, qi, kj);
          float pr;
          if (all_dead)
            pr = p_uniform;  // the dense gradient (see the header)
          else
            pr = dead ? 0.f
                      : expf((s[a][c] + pos[a][c]) * scale - lse_s[r]);
          pv = to_stream<T>(pr * m);
          if (!dead) ds = to_stream<T>(pr * (dv[a][c] * m - del_s[r]) * scale);
        }
        Pt[col * SP + r] = pv;
        dSt[col * SP + r] = ds;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < kBQ3; ++r) {
      float wp[4], ws[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wp[i] = Pt[(ty * 4 + i) * SP + r];
        ws[i] = dSt[(ty * 4 + i) * SP + r];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float gg = GS[r * DP + tx + 16 * j];
        const float qq = QC[r * DP + tx + 16 * j];
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
    const int kj = j0 + ty * 4 + i;
    if (kj >= Tq) continue;
    const size_t off = base + (size_t)kj * rs;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + 16 * j] = acc_k[i][j];
      dv_out[off + tx + 16 * j] = acc_v[i][j];
    }
  }
}

// dp (T, H, D) = the sum of the partials over batch rows and query tiles;
// dqv_i += dqv_b_{i-1} (row i-1's future term read qv_i).
__global__ void __launch_bounds__(kThreads)
    xl3_bwd_reduce_kernel(const float* __restrict__ dp_part,
                          float* __restrict__ dp, float* __restrict__ dqv,
                          const float* __restrict__ dqv_b, int B, int nq,
                          int H, int Tq, int D) {
  const size_t n_dp = (size_t)Tq * H * D;
  const size_t n_qv = (size_t)B * Tq * H * D;
  const size_t rs = (size_t)H * D;
  for (size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
       idx < n_dp + n_qv; idx += (size_t)gridDim.x * kThreads) {
    if (idx < n_dp) {
      const size_t c = idx / rs, h = (idx / D) % H, d = idx % D;
      float sum = 0.f;
      for (int bq = 0; bq < B * nq; ++bq)
        sum += dp_part[((size_t)bq * H + h) * Tq * D + c * D + d];
      dp[idx] = sum;
    } else {
      const size_t j = idx - n_dp;
      if ((j / rs) % Tq >= 1) dqv[j] += dqv_b[j - rs];
    }
  }
}

// ---------------------------------------------------------------------------
// K5 bwd (ROTATE: one position stream rotated in the kernel) and K6 bwd
// (two pre-rotated streams)
// ---------------------------------------------------------------------------

constexpr int kBQk = 32;  // bwd-kv query rows per tile
constexpr int kBK2 = 64;  // bwd-kv keys per tile
constexpr int kEC = 64;   // bwd-kv table columns staged at a time
constexpr int kTS = kEC + 4;

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The rotated streams gA, gB of query rows i0 .. i0 + n - 1 into GA, GB
// (n, ES), rounded to the stream dtype, exactly as the forward kernel
// builds them; rows past Tq (and g_{i+1} past Tq) are zero rows.
template <typename T>
__device__ __forceinline__ void rotate_rows(float* GA, float* GB, int ES,
                                            const T* g, size_t base_e,
                                            size_t rse, int i0, int n, int Tq,
                                            int E, float freq_coef) {
  const int half = E / 2;
  for (int i = threadIdx.x; i < n * half; i += kThreads) {
    const int r = i / half, m = i % half, qi = i0 + r;
    const VtXl2Angles ang = vt_xl2_angles(Tq, qi, m, freq_coef);
    float ge = 0.f, go = 0.f, ne = 0.f, no = 0.f;
    if (qi < Tq) {
      const size_t off = base_e + (size_t)qi * rse + 2 * m;
      ge = to_float(g[off]);
      go = to_float(g[off + 1]);
    }
    if (qi + 1 < Tq) {
      const size_t off = base_e + (size_t)(qi + 1) * rse + 2 * m;
      ne = to_float(g[off]);
      no = to_float(g[off + 1]);
    }
    const float2 a2 = vt_rot(ge, go, ang.ca, ang.sa);
    const float2 b2 = vt_rot(ne, no, ang.cb, ang.sb);
    GA[r * ES + 2 * m] = to_stream<T>(a2.x);
    GA[r * ES + 2 * m + 1] = to_stream<T>(a2.y);
    GB[r * ES + 2 * m] = to_stream<T>(b2.x);
    GB[r * ES + 2 * m + 1] = to_stream<T>(b2.y);
  }
}

// Columns e0 .. e0 + 63 of table rows j0 .. j0 + 63 into TS (64, kTS).
template <typename T>
__device__ __forceinline__ void load_table_chunk(float* TS, const T* table,
                                                 int j0, int e0, int Tq,
                                                 int E) {
  for (int i = threadIdx.x; i < kBK2 * kEC; i += kThreads) {
    const int r = i / kEC, e = i % kEC;
    TS[r * kTS + e] =
        (j0 + r < Tq) ? to_float(table[(size_t)(j0 + r) * E + e0 + e]) : 0.f;
  }
}

template <int D>
size_t xl2_bwd_kv_smem_bytes(int E) {
  // GA, GB (32, E+4); QC, GS (32, D+4); KS, VS (64, D+4); TS (64, 68);
  // Pt, dSt (64, 33); lse, delta (32); dead (64)
  return sizeof(float) * (2 * kBQk * (E + 4) + 2 * kBQk * (D + 4) +
                          2 * kBK2 * (D + 4) + kBK2 * kTS +
                          2 * kBK2 * (kBQk + 1) + 2 * kBQk + kBK2);
}

// ---------------------------------------------------------------------------
// K5 / K6 bwd-q on the tensor cores: Q1 (pos, then ds and dqc) and Q2 (dgA,
// dgB), with K5's rotations before and after (see the header)
// ---------------------------------------------------------------------------

constexpr int kTC = 64;           // Q1 ds: query rows and keys a tile; Q2: table columns
constexpr int kKC = 32;           // contraction chunk of the pos and Q2 kernels
constexpr int kTCThreads = 128;   // Q1 ds: four warps of 16 query rows
// Q1 pos: (query rows, keys) a block, cp.async stages; a warp a 32 x 32 tile
constexpr int kPosBM = 64, kPosBN = 64, kPosStages = 2;
constexpr int kPosThreads = (kPosBM / 32) * (kPosBN / 32) * 32;
// Q2: query rows a block (by kTC table columns), cp.async stages
constexpr int kQ2BM = 64, kQ2Stages = 2;
constexpr int kMaxGridZ = 65535;  // a grid's z limit
constexpr int kQ2Threads = (kQ2BM / 32) * (kTC / 32) * 32;
// S's row length Ts: T rounded up to a multiple of every key tile
constexpr int kTsAlign = 128;
static_assert(kTsAlign % kPosBN == 0 && kTsAlign % kTC == 0, "Ts covers whole key tiles");


// The scratch of ds (and first of the position logits): (B, H, T, Ts), Ts
// the key tiles' cover of T.
inline int ds_cols(int Tq) { return (Tq + kTsAlign - 1) / kTsAlign * kTsAlign; }

// Shared memory of each kernel.
template <typename T>
constexpr size_t xl2_bwd_pos_smem_bytes() {
  // kPosStages stages of the gA, gB chunks (kPosBM, 32) and the table
  // chunk (kPosBN, 32)
  return sizeof(T) * kPosStages * (2 * kPosBM + kPosBN) * tile_ld(kKC);
}
template <typename T, int D>
constexpr size_t xl2_bwd_ds_smem_bytes() {
  // QC, GS (64, D) and two stages of KS, VS (64, D)
  return sizeof(T) * 6 * kTC * tile_ld(D);
}
template <typename T>
constexpr size_t xl2_bwd_dg_smem_bytes() {
  // kQ2Stages stages of the ds chunk (kQ2BM, 32) fp32 and the table chunk
  // (32, 64)
  return kQ2Stages * (sizeof(float) * kQ2BM * tile_ld(kKC) +
                      sizeof(T) * kKC * tile_ld_nn<T, kTC>());
}


// Q1, first kernel: the position logits of every (kPosBM-query,
// kPosBN-key) tile, pos_ij = gA_i . t_j (j <= i), gB_i . t_j (j >= i + 2),
// 0 (j = i + 1), into the scratch S (B, H, T, Ts). A tile wholly in the
// past forms only gA . t, one wholly in the future only gB . t. The E
// contraction walks 32-column chunks of gA / gB and the table, staged once
// each by cp.async kPosStages deep. A warp a 32 x 32 tile of the output.
template <typename T>
__global__ void __launch_bounds__(kPosThreads)
    xl2_bwd_q1_pos_kernel(const T* __restrict__ ga, const T* __restrict__ gb,
                          const T* __restrict__ table, float* __restrict__ S,
                          int H, int Tq, int Ts, int E, int bh0) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int LD = tile_ld(kKC);
  constexpr int TA = kPosBM * LD, TB = kPosBN * LD;
  constexpr int STAGE = 2 * TA + TB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // [stage][gA, gB, table]

  const int j0 = blockIdx.x * kPosBN, i0 = blockIdx.y * kPosBM;
  const int bh = bh0 + blockIdx.z, b = bh / H, h = bh % H;
  const bool need_past = j0 <= i0 + kPosBM - 1;
  const bool need_fut = j0 + kPosBN - 1 >= i0 + 2;
  const size_t rse = (size_t)H * E;
  const size_t base_e = (size_t)b * Tq * rse + (size_t)h * E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / (kPosBN / 32) * 32, wn = warp % (kPosBN / 32) * 32;

  auto stage = [&](int s, int e0) {
    T* st = sm + s * STAGE;
    if (need_past)
      cp_tile<T, kPosBM, kKC, kPosThreads>(st, LD, ga + base_e, rse, i0, Tq, e0);
    if (need_fut)
      cp_tile<T, kPosBM, kKC, kPosThreads>(st + TA, LD, gb + base_e, rse, i0, Tq,
                                           e0);
    cp_tile<T, kPosBN, kKC, kPosThreads>(st + 2 * TA, LD, table, E, j0, Tq, e0);
  };

  float acc_a[2][4][4], acc_b[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc_a[mi][ni][c] = acc_b[mi][ni][c] = 0.f;

  const int n_chunks = E / kKC;
#pragma unroll
  for (int s = 0; s < kPosStages - 1; ++s) {
    if (s < n_chunks) stage(s, s * kKC);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<kPosStages - 2>();
    __syncthreads();  // chunk ch has landed; chunk ch - 1's stage is free
    if (ch + kPosStages - 1 < n_chunks)
      stage((ch + kPosStages - 1) % kPosStages, (ch + kPosStages - 1) * kKC);
    cp_async_commit();
    const T* st = sm + (ch % kPosStages) * STAGE;
#pragma unroll
    for (int k0 = 0; k0 < kKC; k0 += 8) {
      uint32_t bhi[4][2], blo[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        frag_b_nt<SPLIT>(st + 2 * TA, LD, wn + ni * 8, k0, lane, bhi[ni],
                         blo[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t ah[4], al[4];
        if (need_past) {
          frag_a<SPLIT>(st, LD, wm + mi * 16, k0, lane, ah, al);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma3<SPLIT>(acc_a[mi][ni], ah, al, bhi[ni], blo[ni]);
        }
        if (need_fut) {
          frag_a<SPLIT>(st + TA, LD, wm + mi * 16, k0, lane, ah, al);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma3<SPLIT>(acc_b[mi][ni], ah, al, bhi[ni], blo[ni]);
        }
      }
    }
  }

  const int g = lane >> 2, t = lane & 3;
  float* Sb = S + (size_t)bh * Tq * Ts;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qi = i0 + wm + mi * 16 + g + 8 * hf;
      if (qi >= Tq) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int kj = j0 + wn + ni * 8 + 2 * t;
        float out[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = 2 * hf + q;
          out[q] = kj + q <= qi ? acc_a[mi][ni][c]
                                : (kj + q >= qi + 2 ? acc_b[mi][ni][c] : 0.f);
        }
        *reinterpret_cast<float2*>(&Sb[(size_t)qi * Ts + kj]) =
            make_float2(out[0], out[1]);
      }
    }
}

// Q1, second kernel: one block a (64-query tile, head, batch row), four
// warps of 16 query rows each, walking the 64-key tiles (k, v staged by
// cp.async two stages deep; qc and g staged once). Per key tile: s = pos +
// qc k^T and dp = g v^T on the tensor cores (the position logits read from
// S, the next tile's loaded into registers while this one computes), ds in
// the accumulators' layout, written over the logits in S, and dqc += ds k
// with ds as the A operand straight from the registers: the key order
// inside each 8-key step is permuted (slot t <-> key 2t, slot t+4 <-> key
// 2t+1) so that the accumulator layout is the A fragment's.
template <typename T, int D>
__global__ void __launch_bounds__(kTCThreads)
    xl2_bwd_q1_ds_kernel(const T* __restrict__ qc, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ pad,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ S,
                         float* __restrict__ dqc, int H, int Tq, int Ts,
                         float scale, DropArgs drop) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int LD = tile_ld(D);
  constexpr int TILE = kTC * LD;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* QC = reinterpret_cast<T*>(smem_raw);
  T* GS = QC + TILE;
  T* KV = GS + TILE;  // [stage][k, v]

  const int i0 = blockIdx.x * kTC, h = blockIdx.y, b = blockIdx.z;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * Tq * rs + (size_t)h * D;
  const float* padb = pad + (size_t)b * Tq;
  const size_t rbase = ((size_t)b * H + h) * Tq;
  float* Sb = S + rbase * Ts;
  const uint32_t drop_key = vt_dropout_key(drop.seed, b, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;  // the warp's rows of the tile
  int qi[2];
  float lse_r[2], del_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    qi[hf] = i0 + r0 + g4 + 8 * hf;
    const bool in = qi[hf] < Tq;
    lse_r[hf] = in ? lse[rbase + qi[hf]] : 0.f;
    del_r[hf] = in ? delta[rbase + qi[hf]] : 0.f;
  }

  cp_tile<T, kTC, D, kTCThreads>(QC, LD, qc + base, rs, i0, Tq, 0);
  cp_tile<T, kTC, D, kTCThreads>(GS, LD, g + base, rs, i0, Tq, 0);
  cp_tile<T, kTC, D, kTCThreads>(KV, LD, k + base, rs, 0, Tq, 0);
  cp_tile<T, kTC, D, kTCThreads>(KV + TILE, LD, v + base, rs, 0, Tq, 0);
  cp_async_commit();

  // the position logits of this thread's accumulator slots, key tile j0
  float pos[8][4];
  auto load_pos = [&](int j0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const bool in = qi[hf] < Tq;
      const float* row = Sb + (size_t)(in ? qi[hf] : 0) * Ts + j0 + 2 * t4;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const float2 p2 = in ? *reinterpret_cast<const float2*>(row + ni * 8)
                             : make_float2(0.f, 0.f);
        pos[ni][2 * hf] = p2.x;
        pos[ni][2 * hf + 1] = p2.y;
      }
    }
  };
  load_pos(0);

  float acc_q[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_q[nd][c] = 0.f;

  const int n_tiles = (Tq + kTC - 1) / kTC;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int j0 = kt * kTC;
    if (kt + 1 < n_tiles) {
      T* nxt = KV + ((kt + 1) & 1) * 2 * TILE;
      cp_tile<T, kTC, D, kTCThreads>(nxt, LD, k + base, rs, j0 + kTC, Tq, 0);
      cp_tile<T, kTC, D, kTCThreads>(nxt + TILE, LD, v + base, rs, j0 + kTC, Tq, 0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* KS = KV + (kt & 1) * 2 * TILE;
    const T* VS = KS + TILE;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[ni][c] = pos[ni][c];
        dp[ni][c] = 0.f;
      }
    if (kt + 1 < n_tiles) load_pos(j0 + kTC);  // in flight while we compute
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 8) {
      uint32_t qh[4], ql[4], gh[4], gl[4];
      frag_a<SPLIT>(QC, LD, r0, k0, lane, qh, ql);
      frag_a<SPLIT>(GS, LD, r0, k0, lane, gh, gl);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        uint32_t bhi[2], blo[2];
        frag_b_nt<SPLIT>(KS, LD, ni * 8, k0, lane, bhi, blo);
        mma3<SPLIT>(s[ni], qh, ql, bhi, blo);
        frag_b_nt<SPLIT>(VS, LD, ni * 8, k0, lane, bhi, blo);
        mma3<SPLIT>(dp[ni], gh, gl, bhi, blo);
      }
    }

    // ds (0 at dead keys and rows past T), in the accumulator layout
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int kj = j0 + ni * 8 + 2 * t4;
      bool dead[2];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        dead[q] = kj + q >= Tq || padb[kj + q] > 0.5f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int hf = c >> 1, q = c & 1;
        float ds = 0.f;
        if (!dead[q] && qi[hf] < Tq) {
          const float pr = expf(s[ni][c] * scale - lse_r[hf]);
          const float m = keep_scale(drop, drop_key, qi[hf], kj + q);
          ds = to_stream<T>(pr * (dp[ni][c] * m - del_r[hf]) * scale);
        }
        s[ni][c] = ds;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (qi[hf] < Tq)
          *reinterpret_cast<float2*>(&Sb[(size_t)qi[hf] * Ts + kj]) =
              make_float2(s[ni][2 * hf], s[ni][2 * hf + 1]);
    }

    // dqc += ds k: key step ni holds keys j0 + 8 ni + (2t, 2t+1) in slots
    // (t, t+4) of the A fragment
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      uint32_t ah[4], al[4];
      split_tf32<SPLIT>(s[ni][0], ah[0], al[0]);
      split_tf32<SPLIT>(s[ni][2], ah[1], al[1]);
      split_tf32<SPLIT>(s[ni][1], ah[2], al[2]);
      split_tf32<SPLIT>(s[ni][3], ah[3], al[3]);
      const T* krow = KS + (ni * 8 + 2 * t4) * LD + g4;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t bhi[2], blo[2];
        split_tf32<SPLIT>(to_float(krow[nd * 8]), bhi[0], blo[0]);
        split_tf32<SPLIT>(to_float(krow[LD + nd * 8]), bhi[1], blo[1]);
        mma3<SPLIT>(acc_q[nd], ah, al, bhi, blo);
      }
    }
    __syncthreads();  // the stage is read before it is refilled
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (qi[hf] >= Tq) continue;
    float* out = dqc + base + (size_t)qi[hf] * rs + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<float2*>(out + nd * 8) =
          make_float2(acc_q[nd][2 * hf], acc_q[nd][2 * hf + 1]);
  }
}

// Q2: dgA = (ds o past) t and dgB = (ds o future) t, a tensor-core product
// with the masks applied as the ds fragments are read. One block a
// (kQ2BM-query tile, 64-column table tile, A or B, (b, h)), the table
// tiles and A / B of one query tile adjacent in the grid so that they
// share its ds rows in L2; it walks only the 32-key chunks its mask
// reaches, j <= i (A) or j >= i + 2 (B), ds and the table staged by
// cp.async kQ2Stages deep. A warp a 32 x 32 tile of the output. dg_out
// gets dgA (K5: before its rotation), dgb_out dgB.
template <typename T>
__global__ void __launch_bounds__(kQ2Threads)
    xl2_bwd_q2_kernel(const float* __restrict__ S, const T* __restrict__ table,
                      float* __restrict__ dg_out, float* __restrict__ dgb_out,
                      int H, int Tq, int Ts, int E, int bh0) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int LDA = tile_ld(kKC);
  constexpr int LDB = tile_ld_nn<T, kTC>();  // table chunk (32 keys, 64 columns)
  constexpr int TA = kQ2BM * LDA, TB = kKC * LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);          // [stage] ds
  T* Bs = reinterpret_cast<T*>(As + kQ2Stages * TA);       // [stage] table

  const int e0 = (blockIdx.x >> 1) * kTC;
  const bool fut = blockIdx.x & 1;
  const int i0 = blockIdx.y * kQ2BM;
  const int bh = bh0 + blockIdx.z, b = bh / H, h = bh % H;
  const float* Sb = S + (size_t)bh * Tq * Ts;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / (kTC / 32) * 32, wn = warp % (kTC / 32) * 32;
  const int g4 = lane >> 2, t4 = lane & 3;

  // key chunks: past [0, min(i0 + BM, T)), future [i0 + 2, T)
  const int jlo = fut ? (i0 + 2) / kKC * kKC : 0;
  const int jhi = fut ? Tq : min(i0 + kQ2BM, Tq);
  const int n_chunks = jhi > jlo ? (jhi - jlo + kKC - 1) / kKC : 0;

  auto stage = [&](int s, int jc) {
    cp_tile<float, kQ2BM, kKC, kQ2Threads>(As + s * TA, LDA, Sb, Ts, i0, Tq, jc);
    cp_tile<T, kKC, kTC, kQ2Threads>(Bs + s * TB, LDB, table, E, jc, Tq, e0);
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kQ2Stages - 1; ++s) {
    if (s < n_chunks) stage(s, jlo + s * kKC);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int jc = jlo + ch * kKC;
    cp_async_wait<kQ2Stages - 2>();
    __syncthreads();  // chunk ch has landed; chunk ch - 1's stage is free
    if (ch + kQ2Stages - 1 < n_chunks)
      stage((ch + kQ2Stages - 1) % kQ2Stages, jc + (kQ2Stages - 1) * kKC);
    cp_async_commit();
    const float* A = As + (ch % kQ2Stages) * TA;
    const T* Bm = Bs + (ch % kQ2Stages) * TB;
    // a chunk across the mask's edge masks its ds as the fragments load:
    // slot c of (mi, k0) holds key - query = rel0 + k0 - 16 mi + (c >> 1)
    // - 8 (c & 1)
    const bool edge = fut ? jc < i0 + kQ2BM + 1 : jc + kKC - 1 > i0;
    const int rel0 = jc + 2 * t4 - (i0 + wm + g4);
#pragma unroll
    for (int k0 = 0; k0 < kKC; k0 += 8) {
      uint32_t bhi[4][2], blo[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        frag_b_nn<SPLIT>(Bm, LDB, wn + ni * 8, k0, lane, bhi[ni], blo[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* p = A + (wm + mi * 16 + g4) * LDA + k0 + 2 * t4;
        const float2 r0 = load2(p), r1 = load2(p + 8 * LDA);
        float x[4] = {r0.x, r1.x, r0.y, r1.y};  // slots (g, t) (g+8, t) (g, t+4) (g+8, t+4)
        if (edge) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int rel = rel0 + k0 - 16 * mi + (c >> 1) - 8 * (c & 1);
            if (fut ? rel < 2 : rel > 0) x[c] = 0.f;
          }
        }
        uint32_t ah[4], al[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) split_tf32<SPLIT>(x[c], ah[c], al[c]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma3<SPLIT>(acc[mi][ni], ah, al, bhi[ni], blo[ni]);
      }
    }
  }

  float* out = fut ? dgb_out : dg_out;
  const size_t rse = (size_t)H * E;
  const size_t base_e = (size_t)b * Tq * rse + (size_t)h * E;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qi = i0 + wm + mi * 16 + g4 + 8 * hf;
      if (qi >= Tq) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<float2*>(
            &out[base_e + (size_t)qi * rse + e0 + wn + ni * 8 + 2 * t4]) =
            make_float2(acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]);
    }
}

// K5 only: dg_i = rot^-1(dgA_i, A_i) + rot^-1(dgB_{i-1}, B_{i-1}), in place
// over dg (which holds dgA); one thread a pair.
__global__ void __launch_bounds__(kThreads)
    xl2_bwd_unrotate_kernel(float* __restrict__ dg,
                            const float* __restrict__ dgb, int B, int H, int Tq,
                            int E, float freq_coef) {
  const int half = E / 2;
  const size_t n = (size_t)B * Tq * H * half;
  const size_t rse = (size_t)H * E;
  for (size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * kThreads) {
    const int m = (int)(idx % half);
    const size_t bih = idx / half;
    const int qi = (int)((bih / H) % Tq);
    const size_t off = bih * E + 2 * m;
    const VtXl2Angles ang = vt_xl2_angles(Tq, qi, m, freq_coef);
    float2 out = vt_rot_inv(dg[off], dg[off + 1], ang.ca, ang.sa);
    if (qi >= 1) {
      const VtXl2Angles prev = vt_xl2_angles(Tq, qi - 1, m, freq_coef);
      const float2 fb =
          vt_rot_inv(dgb[off - rse], dgb[off - rse + 1], prev.cb, prev.sb);
      out.x += fb.x;
      out.y += fb.y;
    }
    dg[off] = out.x;
    dg[off + 1] = out.y;
  }
}

// ga, gb as in launch_xl2_bwd_q.
template <typename T, int D, bool ROTATE>
__global__ void __launch_bounds__(kThreads)
    xl2_bwd_kv_kernel(const T* __restrict__ qc, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ ga,
                      const T* __restrict__ gb, const T* __restrict__ table,
                      const T* __restrict__ g,
                      const float* __restrict__ pad,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv_out,
                      float* __restrict__ dtab_part, int H, int Tq, int Tp,
                      int E, float scale, float freq_coef, DropArgs drop) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int DS = D + 4;
  constexpr int SP = kBQk + 1;
  constexpr int DJ = D / 16;
  const int ES = E + 4;

  extern __shared__ __align__(16) float smem[];
  float* GA = smem;
  float* GB = GA + kBQk * ES;
  float* QC = GB + kBQk * ES;
  float* GS = QC + kBQk * DS;
  float* KS = GS + kBQk * DS;
  float* VS = KS + kBK2 * DS;
  float* TS = VS + kBK2 * DS;
  float* Pt = TS + kBK2 * kTS;  // (key, query): p * m / keep
  float* dSt = Pt + kBK2 * SP;  // (key, query): ds
  float* lse_s = dSt + kBK2 * SP;
  float* del_s = lse_s + kBQk;
  float* dead_s = del_s + kBQk;

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kBK2;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * Tq * rs + (size_t)h * D;
  const size_t rse = (size_t)H * E;
  const size_t base_e = (size_t)b * Tq * rse + (size_t)h * E;
  const float* padb = pad + (size_t)b * Tq;
  const size_t rbase = ((size_t)b * H + h) * Tq;
  const uint32_t drop_key = vt_dropout_key(drop.seed, b, h);
  const float p_uniform = 1.f / (float)Tp;  // a fully padded row's weight
  // this block's (64, E) slice of the dt partials (B * H, T, E), or null
  float* tpart = dtab_part == nullptr
                     ? nullptr
                     : dtab_part + ((size_t)b * H + h) * Tq * E;

  const bool all_dead = row_all_dead(padb, Tq);

  load_rows(KS, DS, k, base, rs, j0, kBK2, Tq, D);
  load_rows(VS, DS, v, base, rs, j0, kBK2, Tq, D);
  load_dead(dead_s, padb, j0, kBK2, Tq);

  // scores: queries 2 ty + a, keys tx + 16 c; accumulators: keys 4 ty + i,
  // features tx + 16 j
  const int ty = tid / 16, tx = tid % 16;
  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int i0 = 0; i0 < Tq; i0 += kBQk) {
    const bool need_past = j0 <= i0 + kBQk - 1;
    const bool need_fut = j0 + kBK2 - 1 >= i0 + 2;
    __syncthreads();  // the previous tile's GA / GB / QC / GS / Pt are read
    load_rows(QC, DS, qc, base, rs, i0, kBQk, Tq, D);
    load_rows(GS, DS, g, base, rs, i0, kBQk, Tq, D);
    load_row_stats(lse_s, del_s, lse, delta, rbase, i0, kBQk, Tq);
    if constexpr (ROTATE) {
      rotate_rows(GA, GB, ES, ga, base_e, rse, i0, kBQk, Tq, E, freq_coef);
    } else {
      load_rows(GA, ES, ga, base_e, rse, i0, kBQk, Tq, E);
      load_rows(GB, ES, gb, base_e, rse, i0, kBQk, Tq, E);
    }
    __syncthreads();

    float s[2][4], dv[2][4], pa[2][4], pb[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dv[a][c] = pa[a][c] = pb[a][c] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 q4[2], g4[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        q4[a] = *reinterpret_cast<const float4*>(&QC[(ty * 2 + a) * DS + d]);
        g4[a] = *reinterpret_cast<const float4*>(&GS[(ty * 2 + a) * DS + d]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = (tx + 16 * c) * DS + d;
        const float4 k4 = *reinterpret_cast<const float4*>(&KS[row]);
        const float4 v4 = *reinterpret_cast<const float4*>(&VS[row]);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          s[a][c] = dot4(q4[a], k4, s[a][c]);
          dv[a][c] = dot4(g4[a], v4, dv[a][c]);
        }
      }
    }
    for (int e0 = 0; e0 < E; e0 += kEC) {
      __syncthreads();  // the previous chunk of TS is read
      load_table_chunk(TS, table, j0, e0, Tq, E);
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
            const float4 a4 =
                *reinterpret_cast<const float4*>(&GA[(ty * 2 + a) * ES + e0 + e]);
#pragma unroll
            for (int c = 0; c < 4; ++c) pa[a][c] = dot4(a4, t4[c], pa[a][c]);
          }
        }
        if (need_fut) {
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const float4 b4 =
                *reinterpret_cast<const float4*>(&GB[(ty * 2 + a) * ES + e0 + e]);
#pragma unroll
            for (int c = 0; c < 4; ++c) pb[a][c] = dot4(b4, t4[c], pb[a][c]);
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
        float pv = 0.f, ds = 0.f;
        if (qi < Tq && kj < Tq) {
          const bool dead = dead_s[col] != 0.f;
          const float m = keep_scale(drop, drop_key, qi, kj);
          float pr;
          if (all_dead) {
            pr = p_uniform;  // the dense gradient (see the header)
          } else if (dead) {
            pr = 0.f;
          } else {
            const float pos =
                kj <= qi ? pa[a][c] : (kj >= qi + 2 ? pb[a][c] : 0.f);
            pr = expf((s[a][c] + pos) * scale - lse_s[r]);
          }
          pv = to_stream<T>(pr * m);
          if (!dead) ds = to_stream<T>(pr * (dv[a][c] * m - del_s[r]) * scale);
        }
        Pt[col * SP + r] = pv;
        dSt[col * SP + r] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kBQk; ++r) {
      float wp[4], ws[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wp[i] = Pt[(ty * 4 + i) * SP + r];
        ws[i] = dSt[(ty * 4 + i) * SP + r];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float gg = GS[r * DS + tx + 16 * j];
        const float qq = QC[r * DS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][j] = fmaf(wp[i], gg, acc_v[i][j]);
          acc_k[i][j] = fmaf(ws[i], qq, acc_k[i][j]);
        }
      }
    }
    if (tpart != nullptr) {
      // dt_j += sum_i dsA_ij gA_i + dsB_ij gB_i over this query tile; one
      // thread owns each (key, column) of the block's slice
      for (int idx = tid; idx < kBK2 * E; idx += kThreads) {
        const int c = idx / E, e = idx % E, kj = j0 + c;
        if (kj >= Tq) continue;
        float sum = 0.f;
        for (int r = 0; r < kBQk; ++r) {
          const int qi = i0 + r;
          const float w = dSt[c * SP + r];
          if (kj <= qi)
            sum = fmaf(w, GA[r * ES + e], sum);
          else if (kj >= qi + 2)
            sum = fmaf(w, GB[r * ES + e], sum);
        }
        tpart[(size_t)kj * E + e] += sum;
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
      dv_out[off + tx + 16 * j] = acc_v[i][j];
    }
  }
}

// dt (T, E) = the sum of the per-(b, h) partials.
__global__ void __launch_bounds__(kThreads)
    xl2_bwd_dtab_kernel(const float* __restrict__ dtab_part,
                        float* __restrict__ dtab, int BH, int Tq, int E) {
  const size_t n = (size_t)Tq * E;
  for (size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * kThreads) {
    float sum = 0.f;
    for (int bh = 0; bh < BH; ++bh) sum += dtab_part[(size_t)bh * n + idx];
    dtab[idx] = sum;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int grid_for(size_t n) {
  const size_t blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 8 ? (blocks > 0 ? blocks : 1) : 132 * 8);
}

template <typename T, int D>
cudaError_t launch_xl3_bwd(const void* qc, const void* k, const void* v,
                           const void* qv, const void* p, const void* g,
                           const float* pad, const float* lse,
                           const float* delta, float* dqc, float* dk,
                           float* dv, float* dqv, float* dqv_b,
                           float* dp_part, float* dp, int B, int Tq, int H,
                           float scale, DropArgs drop, cudaStream_t stream) {
  constexpr size_t smem = xl3_bwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      xl3_bwd_q_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(xl3_bwd_kv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int nq = (Tq + kBQ3 - 1) / kBQ3;
  const T* Qc = static_cast<const T*>(qc);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  const T* Qv = static_cast<const T*>(qv);
  const T* P = static_cast<const T*>(p);
  const T* G = static_cast<const T*>(g);
  xl3_bwd_q_kernel<T, D><<<dim3(nq, H, B), kThreads, smem, stream>>>(
      Qc, K, V, Qv, P, G, pad, lse, delta, dqc, dqv, dqv_b, dp_part, H, Tq,
      scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  xl3_bwd_kv_kernel<T, D><<<dim3((Tq + kBK3 - 1) / kBK3, H, B), kThreads, smem,
                            stream>>>(Qc, K, V, Qv, P, G, pad, lse, delta, dk,
                                      dv, H, Tq, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  xl3_bwd_reduce_kernel<<<grid_for((size_t)(1 + B) * Tq * H * D), kThreads, 0,
                          stream>>>(dp_part, dp, dqv, dqv_b, B, nq, H, Tq, D);
  return cudaGetLastError();
}

// K5 (ROTATE): rotate, Q1 pos, Q1 ds, Q2, unrotate; K6: Q1 pos, Q1 ds, Q2.
// ga: K5's g2 or K6's gA; gb: K6's gB. dg: K5's dg2 or K6's dgA; dgb: K6's
// dgB or K5's scratch for it. gab: K5's rotated streams (2, B, T, H, E) in
// the stream dtype; s: the ds scratch (B, H, T, ds_cols(T)) fp32.
template <typename T, int D, bool ROTATE>
cudaError_t launch_xl2_bwd_q(const void* qc, const void* k, const void* v,
                             const void* ga, const void* gb,
                             const void* table, const void* g,
                             const float* pad, const float* lse,
                             const float* delta, float* dqc, float* dg,
                             float* dgb, void* gab, float* s, int B, int Tq,
                             int H, int E, float scale, DropArgs drop,
                             cudaStream_t stream) {
  constexpr size_t smem_pos = xl2_bwd_pos_smem_bytes<T>();
  constexpr size_t smem_ds = xl2_bwd_ds_smem_bytes<T, D>();
  constexpr size_t smem_dg = xl2_bwd_dg_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      xl2_bwd_q1_pos_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_pos);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(xl2_bwd_q1_ds_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_ds);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(xl2_bwd_q2_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dg);
  if (err != cudaSuccess) return err;
  const float freq_coef = (float)(-2.0 * log(10000.0) / (double)E);
  const size_t n_pairs = (size_t)B * Tq * H * (E / 2);
  const T* GA = static_cast<const T*>(ga);
  const T* GB = static_cast<const T*>(gb);
  const T* Tab = static_cast<const T*>(table);
  if constexpr (ROTATE) {
    T* ra = static_cast<T*>(gab);
    T* rb = ra + (size_t)B * Tq * H * E;
    err = launch_xl2_rotate<T>(GA, ra, rb, B, H, Tq, E, stream);
    if (err != cudaSuccess) return err;
    GA = ra;
    GB = rb;
  }
  const int Ts = ds_cols(Tq), BH = B * H;
  // Q1 pos and Q2 put (b, h) on grid.z: one launch for each kMaxGridZ of
  // them (one launch unless B * H passes 65535).
  for (int bh0 = 0; bh0 < BH; bh0 += kMaxGridZ) {
    xl2_bwd_q1_pos_kernel<T>
        <<<dim3((Tq + kPosBN - 1) / kPosBN, (Tq + kPosBM - 1) / kPosBM,
                BH - bh0 < kMaxGridZ ? BH - bh0 : kMaxGridZ),
           kPosThreads, smem_pos, stream>>>(GA, GB, Tab, s, H, Tq, Ts, E, bh0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  xl2_bwd_q1_ds_kernel<T, D>
      <<<dim3((Tq + kTC - 1) / kTC, H, B), kTCThreads, smem_ds, stream>>>(
          static_cast<const T*>(qc), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(g), pad, lse, delta,
          s, dqc, H, Tq, Ts, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (int bh0 = 0; bh0 < BH; bh0 += kMaxGridZ) {
    xl2_bwd_q2_kernel<T>
        <<<dim3(2 * E / kTC, (Tq + kQ2BM - 1) / kQ2BM,
                BH - bh0 < kMaxGridZ ? BH - bh0 : kMaxGridZ),
           kQ2Threads, smem_dg, stream>>>(s, Tab, dg, dgb, H, Tq, Ts, E, bh0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (!ROTATE) return cudaSuccess;
  xl2_bwd_unrotate_kernel<<<grid_for(n_pairs), kThreads, 0, stream>>>(
      dg, dgb, B, H, Tq, E, freq_coef);
  return cudaGetLastError();
}

template <typename T, int D, bool ROTATE>
cudaError_t launch_xl2_bwd_kv(const void* qc, const void* k, const void* v,
                              const void* ga, const void* gb,
                              const void* table, const void* g,
                              const float* pad, const float* lse,
                              const float* delta, float* dk, float* dv,
                              float* dtab_part, float* dtab, int B, int Tq,
                              int Tp, int H, int E, float scale, DropArgs drop,
                              cudaStream_t stream) {
  const size_t smem = xl2_bwd_kv_smem_bytes<D>(E);
  cudaError_t err = cudaFuncSetAttribute(
      xl2_bwd_kv_kernel<T, D, ROTATE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float freq_coef = (float)(-2.0 * log(10000.0) / (double)E);
  xl2_bwd_kv_kernel<T, D, ROTATE><<<dim3((Tq + kBK2 - 1) / kBK2, H, B),
                                    kThreads, smem, stream>>>(
      static_cast<const T*>(qc), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(ga),
      static_cast<const T*>(gb), static_cast<const T*>(table),
      static_cast<const T*>(g), pad, lse, delta, dk, dv, dtab_part, H, Tq, Tp,
      E, scale, freq_coef, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess || dtab_part == nullptr) return err;
  xl2_bwd_dtab_kernel<<<grid_for((size_t)Tq * E), kThreads, 0, stream>>>(
      dtab_part, dtab, B * H, Tq, E);
  return cudaGetLastError();
}

bool bad_args(int B, int T, int H, double dropout_p) {
  return B <= 0 || H <= 0 || T <= 0 || T >= 65536 || B >= 65536 ||
         H >= 65536 || !(dropout_p >= 0.0 && dropout_p < 1.0);
}

// E a multiple of 64 whose bwd-kv shared memory fits a block at head dim D
// (bwd-q's does not depend on E).
bool bad_e(int E, int D) {
  if (E <= 0 || E % kEC != 0) return true;
  const size_t kv = D == 128 ? xl2_bwd_kv_smem_bytes<128>(E)
                             : xl2_bwd_kv_smem_bytes<64>(E);
  return kv > 232448;
}

// One K5 (ROTATE) or K6 bwd-q call at the built head dims: 48 and 64, and
// 128 for K6 (the JETS conformer's legacy rel-pos flavour).
template <bool ROTATE>
int xl2_bwd_q_entry(const void* qc, const void* k, const void* v,
                    const void* ga, const void* gb, const void* table,
                    const void* g, const float* pad, const float* lse,
                    const float* delta, float* dqc, float* dg, float* dgb,
                    void* gab, float* s, int B, int T, int H, int D, int E,
                    int is_bf16, float scale, double dropout_p, uint64_t seed,
                    void* stream) {
  if (bad_args(B, T, H, dropout_p) || bad_e(E, D) ||
      (long long)B * H > INT_MAX - kMaxGridZ)  // int (b, h); no such batch fits
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropArgs drop = drop_args(dropout_p, seed);
#define VT_XL2Q(TYPE, DIM)                                                  \
  launch_xl2_bwd_q<TYPE, DIM, ROTATE>(qc, k, v, ga, gb, table, g, pad, lse, \
                                      delta, dqc, dg, dgb, gab, s, B, T, H, \
                                      E, scale, drop, st)
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 96: return (int)VT_XL2Q(float, 48);
    case 97: return (int)VT_XL2Q(__nv_bfloat16, 48);
    case 128: return (int)VT_XL2Q(float, 64);
    case 129: return (int)VT_XL2Q(__nv_bfloat16, 64);
    default: break;
  }
  if constexpr (!ROTATE) {
    switch (D * 2 + (is_bf16 ? 1 : 0)) {
      case 256: return (int)VT_XL2Q(float, 128);
      case 257: return (int)VT_XL2Q(__nv_bfloat16, 128);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
#undef VT_XL2Q
}

// One K5 (ROTATE) or K6 bwd-kv launch, head dims as xl2_bwd_q_entry.
template <bool ROTATE>
int xl2_bwd_kv_entry(const void* qc, const void* k, const void* v,
                     const void* ga, const void* gb, const void* table,
                     const void* g, const float* pad, const float* lse,
                     const float* delta, float* dk, float* dv,
                     float* dtab_part, float* dtab, int B, int T, int Tp,
                     int H, int D, int E, int is_bf16, float scale,
                     double dropout_p, uint64_t seed, void* stream) {
  if (bad_args(B, T, H, dropout_p) || bad_e(E, D) || Tp < T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropArgs drop = drop_args(dropout_p, seed);
#define VT_XL2KV(TYPE, DIM)                                                 \
  launch_xl2_bwd_kv<TYPE, DIM, ROTATE>(qc, k, v, ga, gb, table, g, pad, lse, \
                                       delta, dk, dv, dtab_part, dtab, B, T, \
                                       Tp, H, E, scale, drop, s)
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 96: return (int)VT_XL2KV(float, 48);
    case 97: return (int)VT_XL2KV(__nv_bfloat16, 48);
    case 128: return (int)VT_XL2KV(float, 64);
    case 129: return (int)VT_XL2KV(__nv_bfloat16, 64);
    default: break;
  }
  if constexpr (!ROTATE) {
    switch (D * 2 + (is_bf16 ? 1 : 0)) {
      case 256: return (int)VT_XL2KV(float, 128);
      case 257: return (int)VT_XL2KV(__nv_bfloat16, 128);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
#undef VT_XL2KV
}

}  // namespace

extern "C" {

// K4 bwd. qc, k, v, qv, g: (B, T, H, D) contiguous, fp32 (is_bf16 = 0) or
// bf16; p: (T, H, D), same dtype; pad: (B, T) fp32, 1.0 at padding keys;
// lse, delta: (B, H, T) fp32; dropout_p and seed: the forward's. Outputs,
// fp32: dqc, dk, dv, dqv (B, T, H, D); dp (T, H, D). Scratch, fp32: dqv_b
// (B, T, H, D) and dp_part (B, ceil(T / 64), H, T, D), zero-filled by the
// caller. Returns the first cudaError_t of the three launches.
int vt_flash_xl3_bwd(const void* qc, const void* k, const void* v,
                     const void* qv, const void* p, const void* g,
                     const float* pad, const float* lse, const float* delta,
                     float* dqc, float* dk, float* dv, float* dqv, float* dp,
                     float* dqv_b, float* dp_part, int B, int T, int H, int D,
                     int is_bf16, float scale, double dropout_p, uint64_t seed,
                     void* stream) {
  if (bad_args(B, T, H, dropout_p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropArgs drop = drop_args(dropout_p, seed);
#define VT_XL3B(TYPE, DIM)                                                  \
  launch_xl3_bwd<TYPE, DIM>(qc, k, v, qv, p, g, pad, lse, delta, dqc, dk, dv, \
                            dqv, dqv_b, dp_part, dp, B, T, H, scale, drop, s)
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 96: return (int)VT_XL3B(float, 48);
    case 97: return (int)VT_XL3B(__nv_bfloat16, 48);
    case 128: return (int)VT_XL3B(float, 64);
    case 129: return (int)VT_XL3B(__nv_bfloat16, 64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VT_XL3B
}

// K5 bwd-q. qc, k, v, g: (B, T, H, D); g2: (B, T, H, E) the forward's
// unrotated position stream; table: (T, E); all one dtype. pad, lse, delta,
// dropout_p, seed as K4 bwd. Outputs, fp32: dqc (B, T, H, D), dg2
// (B, T, H, E). Scratch: gab (2, B, T, H, E) in the stream dtype, dgb
// (B, T, H, E) fp32, s (B, H, T, 128 * ceil(T / 128)) fp32. E a multiple of
// 64. Returns the first cudaError_t of the five launches.
int vt_flash_xl2_bwd_q(const void* qc, const void* k, const void* v,
                       const void* g2, const void* table, const void* g,
                       const float* pad, const float* lse, const float* delta,
                       float* dqc, float* dg2, void* gab, float* dgb, float* s,
                       int B, int T, int H, int D, int E, int is_bf16,
                       float scale, double dropout_p, uint64_t seed,
                       void* stream) {
  return xl2_bwd_q_entry<true>(qc, k, v, g2, nullptr, table, g, pad, lse,
                               delta, dqc, dg2, dgb, gab, s, B, T, H, D, E,
                               is_bf16, scale, dropout_p, seed, stream);
}

// K5 bwd-kv. Inputs as K5 bwd-q; Tp >= T the forward's padded length (the
// keys in [T, Tp) are virtual). Outputs, fp32: dk, dv (B, T, H, D); with
// dtab_part non-null (scratch (B * H, T, E) fp32, zero-filled by the
// caller) also dtab (T, E).
int vt_flash_xl2_bwd_kv(const void* qc, const void* k, const void* v,
                        const void* g2, const void* table, const void* g,
                        const float* pad, const float* lse,
                        const float* delta, float* dk, float* dv,
                        float* dtab_part, float* dtab, int B, int T, int Tp,
                        int H, int D, int E, int is_bf16, float scale,
                        double dropout_p, uint64_t seed, void* stream) {
  return xl2_bwd_kv_entry<true>(qc, k, v, g2, nullptr, table, g, pad, lse,
                                delta, dk, dv, dtab_part, dtab, B, T, Tp, H,
                                D, E, is_bf16, scale, dropout_p, seed, stream);
}

// K6 bwd-q. qc, k, v, g: (B, T, H, D); gA, gB: (B, T, H, E) the forward's
// pre-rotated streams; table: (T, E); all one dtype; D in {48, 64, 128}.
// pad, lse, delta, dropout_p, seed as K4 bwd. Outputs, fp32: dqc
// (B, T, H, D), dgA and dgB (B, T, H, E). Scratch: s as K5 bwd-q's.
// Returns the first cudaError_t of the three launches.
int vt_flash_xl_bwd_q(const void* qc, const void* k, const void* v,
                      const void* ga, const void* gb, const void* table,
                      const void* g, const float* pad, const float* lse,
                      const float* delta, float* dqc, float* dga, float* dgb,
                      float* s, int B, int T, int H, int D, int E, int is_bf16,
                      float scale, double dropout_p, uint64_t seed,
                      void* stream) {
  return xl2_bwd_q_entry<false>(qc, k, v, ga, gb, table, g, pad, lse, delta,
                                dqc, dga, dgb, nullptr, s, B, T, H, D, E,
                                is_bf16, scale, dropout_p, seed, stream);
}

// K6 bwd-kv. Inputs as K6 bwd-q, Tp as K5 bwd-kv. Outputs, fp32: dk, dv
// (B, T, H, D); with dtab_part non-null (scratch (B * H, T, E) fp32,
// zero-filled by the caller) also dtab (T, E).
int vt_flash_xl_bwd_kv(const void* qc, const void* k, const void* v,
                       const void* ga, const void* gb, const void* table,
                       const void* g, const float* pad, const float* lse,
                       const float* delta, float* dk, float* dv,
                       float* dtab_part, float* dtab, int B, int T, int Tp,
                       int H, int D, int E, int is_bf16, float scale,
                       double dropout_p, uint64_t seed, void* stream) {
  return xl2_bwd_kv_entry<false>(qc, k, v, ga, gb, table, g, pad, lse, delta,
                                 dk, dv, dtab_part, dtab, B, T, Tp, H, D, E,
                                 is_bf16, scale, dropout_p, seed, stream);
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
