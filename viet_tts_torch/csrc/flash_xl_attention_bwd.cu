// Kernels K3a / K3b (plain), K4 bwd (xl3), K5 bwd-q / bwd-kv (xl2), K6
// bwd-q / bwd-kv (xl) and K7 bwd-q / bwd-kv (rel): the backward of the
// plain scaled-dot attention of JETS (K1), of the Transformer-XL attention
// (flash_xl_attention.cu) of the FS2 conformer and of the JETS conformer's
// legacy rel-pos flavour, and of the JETS conformer's espnet "latest"
// rel-pos attention, for Hopper (sm_90a), with the forward's
// attention-weight dropout.
//
// Replace the TPU kernels of viet_tts_tpu/ops/pallas_attention.py:
//   K3a        `_plain_bwd_q_kernel` (`_plain_bwd_pallas` through `_call_bwd_q`);
//   K3b        `_plain_bwd_kv_kernel` (`_plain_bwd_pallas` through `_call_bwd_kv`);
//   K4 bwd     `_xl3_bwd_kernel` (launched by `_xl3_bwd_pallas`);
//   K5 bwd-q   `_xl2_bwd_q_kernel` (`_xl2_bwd_pallas` through `_call_bwd_q`);
//   K5 bwd-kv  `_xl2_bwd_kv_kernel` (`_xl2_bwd_pallas` through `_call_bwd_kv`);
//   K6 bwd-q   `_xl_bwd_q_kernel` (`_xl_bwd_pallas` through `_call_bwd_q`);
//   K6 bwd-kv  `_xl_bwd_kv_kernel` (`_xl_bwd_pallas` through `_call_bwd_kv`);
//   K7 bwd-q   `_rel_bwd_q_kernel` (`_rel_bwd_pallas` through `_call_bwd_q`);
//   K7 bwd-kv  `_rel_bwd_kv_kernel` (`_rel_bwd_pallas` through `_call_bwd_kv`).
// With the forward's logits l_ij = (qc_i . k_j + pos_ij) * scale, its
// logsumexp lse_i and delta_i = sum_d g_id out_id (computed outside, as the
// JAX package does):
//   p   = exp(l - lse)                          (0 at padding keys)
//   ds  = p * (dp * m / keep - delta) * scale   (0 at padding keys)
//   dqc = ds k,   dk = ds^T qc,   dv = (p * m / keep)^T g,
// dp = g v^T, m the forward's keep bit (dropout_hash.cuh). K3 has no
// position term (pos = 0; qc is q). The position term of the others
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
//  - K4 bwd runs on the tensor cores in three launches: `xl3_bwd_ds_kernel`
//    (see its comment), one block a (64-query tile, head, batch row)
//    walking the 64-key tiles, forms s, the position logits as band
//    products (qv against the 127 rows of p that a tile's offsets j - i
//    reach, read back along the tile's diagonals), g v^T, ds, dqc, the two
//    parts of dqv and the tile's partial of the table's gradient dp (ds in
//    band form against qv), and writes ds and P = p m / keep into two
//    (B, H, T, Ts) fp32 scratches; bwd-kv's kernel (`xl2_bwd_kv_kernel`,
//    K4's instance) forms dk = ds^T qc and dv = P^T g from them; and
//    `xl3_bwd_reduce_kernel` sums the dp partials over batch rows and query
//    tiles and adds row i-1's future part into dqv_i. K4 runs at T <= 512
//    (`XL3_MAX_T`), so the scratches are small (67 MB each at (8, 8, 512)).
//  - The K5 / K6 backward runs on the tensor cores, in stages that share
//    two fp32 scratches: Q1 and Q2 give bwd-q's dqc and dgA / dgB, then
//    bwd-kv gives dk and dv, and dtab (only on demand) the table's
//    gradient, from what Q1 left in the scratches (K5 adds an elementwise
//    rotation before Q1 and its inverse after Q2). Q1 / Q2 are two kernels
//    so that no E-wide accumulator lives inside the flash loop: at E = 384
//    the E-wide products are 84 % of bwd-q's work. bwd-kv reads p m / keep
//    and ds from the scratches instead of forming them again: the position
//    logits are two thirds of its work at E = 384, and Q1 has formed them
//    already. Every product is `mma.sync.m16n8k8` TF32 with fp32
//    accumulation. fp32 streams take 3xTF32: x = hi + lo, hi rounded to
//    nearest (ties away, cvt.rna's rounding, done with integer ops: the cvt
//    instruction issues at a quarter of the rate), lo the exact rest with
//    its low 13 bits cleared, a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b; one
//    TF32 product keeps ~3 digits and misses the fp32 limit of 1e-4, over
//    E = 384 in bwd-q and over the T-long contractions of dk and dv
//    (tests/test_torch_xl_bwd_precision.py). bf16 streams are exact in
//    TF32 (8 mantissa bits of 11), and so are ds and p m / keep, rounded to
//    bf16 as `_mx` does: one TF32 product per term, exact, with the fp32
//    path's code. (Deviation from m16n8k16 bf16: one code path for both
//    dtypes; the training path runs fp32.)
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
//      straight from the registers (see the fragments' permutation). When
//      bwd-kv follows it also writes P = p m / keep into a second scratch
//      shaped like S (a fully padded batch row: m / Tp, the dense weight).
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
//    * K7 bwd-q (the TPU's `_rel_bwd_q_kernel` is `_xl_bwd_q_kernel` with
//      pos = g t^T at every key): Q1 pos and Q2 take the position kind as
//      a template argument (xl_mma.cuh's kPosXl for K5 and K6, kPosRel for
//      K7): K7's Q1 pos forms one g t^T pass a tile, written at every key;
//      Q1 ds is K6's at D = 128 (with P when bwd-kv follows); K7's Q2
//      forms dg = ds t over every key, one block a (64-query tile,
//      64-column table tile, (b, h)), no A / B axis and no mask. At the
//      training shape (8, 2, 512) that is 8 x 4 x 16 = 512 blocks of 128
//      threads. K7 pads T to Tp (a multiple of 32) as K5 / K6 do: the
//      Tp - T tail keys are virtual, never formed.
//    * K7 bwd-kv (the TPU's `_rel_bwd_kv_kernel` forms the logits over
//      D + E again, then g_out . v, dk and dv: 4D + E a pair) is K6's
//      bwd-kv at D = 128 on the ds and P scratches of K7's Q1, so it forms
//      no logit: two D-wide products a pair. Its table gradient, dt_j =
//      sum over (b, h, i) of ds_ij g_i at every key, is the dtab kernel's
//      K7 instance (kPosRel: one stream, no mask).
//    * bwd-kv, `xl2_bwd_kv_kernel`: dv = P^T g and dk = ds^T qc; one block
//      a (64-key tile, head, batch row) walks the 32-row query chunks, P,
//      ds, g and qc staged by cp.async three stages deep; eight warps, each
//      one product for 32 keys and half of D, the keys as M so that the A
//      fragment is the staged (query, key) tile read transposed. It forms
//      two D-wide products a pair and reads the two scratches once: bound
//      by their bytes (0.53 GB at (8, 8, 1008), 0.16 ms at 3.35 TB/s).
//    * dtab, `xl2_bwd_dtab_kernel` (with `want_dtab` only: the conformers'
//      table is the constant sinusoid table, so training never asks for
//      it): dt = (ds o past)^T gA + (ds o future)^T gB (K7: ds^T g), Q2's
//      product transposed, the keys as M, the (b, h, query) rows as the
//      contraction; one block a (64-key tile, 64-column tile, share of the
//      (b, h)), the shares summed by `xl2_bwd_dtab_sum_kernel` when the
//      (key, column) tiles alone would not fill the card.
//    * The wrapper allocates S, P (and K5's gA, gB and dgB, and dtab's
//      partials) with torch.empty; the kernels allocate nothing. S and P
//      add 0.26 GB each at (8, 8, 1008) and 0.54 GB each at (4, 8, 2048);
//      K5's streams another 0.30 GB at (8, 8, 1008).
//    * Budget (ptxas -v, sm_90a, the CUDA toolkit of the H100 machine; no
//      spill in any instance; blocks an SM = the least of what registers
//      and shared memory allow; q1_ds takes the P write as a template flag,
//      so that bwd-q alone runs none of its code):
//        kernel        dtype  D      smem B    regs  blocks/SM  threads
//        q1_pos        fp32   -      61,440    123   3          128
//        q1_pos        bf16   -      30,720    114   4          128
//        q1_ds         fp32   48     86,016    168   2          128
//        q1_ds         fp32   64    110,592    231   2          128
//        q1_ds         fp32   128   208,896    254   1          128
//        q1_ds         bf16   48     43,008    164   3          128
//        q1_ds         bf16   64     55,296    168   3          128
//        q1_ds         bf16   128   104,448    228   2          128
//        q1_ds, P      fp32   48 / 64 / 128    166 / 225 / 253  (as above)
//        q1_ds, P      bf16   48 / 64 / 128    164 / 172 / 223  (64: 2)
//        q2            fp32   -      37,888     88   5          128
//        q2            bf16   -      29,696    117   4          128
//        q1_pos, K7    fp32   -      40,960    125   4          128
//        q1_pos, K7    bf16   -      20,480    120   4          128
//        q2, K7        fp32   -      37,888     95   5          128
//        q2, K7        bf16   -      29,696     94   5          128
//        kv            fp32   48     92,160     96   2          256
//        kv            fp32   64    104,448    102   2          256
//        kv            fp32   128   153,600    146   1          256
//        kv            bf16   48     73,728     80   3          256
//        kv            bf16   64     79,872    104   2          256
//        kv            bf16   128   104,448    124   2          256
//        dtab          fp32   -      52,224     93   4          128
//        dtab          bf16   -      35,840     90   5          128
//        dtab, K7      fp32   -      34,816     78   6          128
//        dtab, K7      bf16   -      26,624     78   6          128
//        K4 ds         fp32   48    134,368    222   1          256
//        K4 ds         fp32   64    163,104    246   1          256
//        K4 ds         bf16   48     84,080    202   1          256
//        K4 ds         bf16   64     98,448    232   1          256
//        (K4's bwd-kv instance: kv's registers; reduce: grid-stride.)
//        K3 q1_ds      fp32   32     61,440    126   2          256
//        K3 q1_ds      fp32   64    110,592    255   1          256
//        K3 q1_ds      fp32   128   208,896    255   1          256
//        K3 q1_ds      bf16   32     30,720    120   2          256
//        K3 q1_ds      bf16   64     55,296    126   2          256
//        K3 q1_ds      bf16   128   104,448    188   1          256
//        K3 q1_ds, P   fp32   32 / 64 / 128    127 / 227 / 255  (2 / 1 / 1)
//        K3 q1_ds, P   bf16   32 / 64 / 128    118 / 146 / 169  (2 / 1 / 1)
//        K3 kv         fp32   32     79,872    109   2          256
//        K3 kv         fp32   64    104,448    125   2          256
//        K3 kv         fp32   128   153,600    227   1          256
//        K3 kv         bf16   32     67,584     66   3          256
//        K3 kv         bf16   64     79,872    104   2          256
//        K3 kv         bf16   128   104,448    124   2          256
//        (K3's fp32 instances with their slice and chunk sums.)
//      K4's ds kernel with four warps of 16 rows (all the keys each) took
//      0.91 ms at (8, 8, 512) fp32, one warp on each of an SM's four
//      schedulers; eight warps, each half of the keys, take 0.47 ms
//      (tools/time_xl_bwd.py, H100).
//        rotate (xl_mma.cuh) / unrotate (256 threads): no shared memory,
//        28-30 registers (a 32-byte frame for sincosf's slow path).
//      Shared memory does not depend on E; E a multiple of 64 (the column
//      tile of q2 and dtab). What bounds q1_pos and q2, measured (H100):
//      q1_pos and q2 issue about 40 other instructions (the fragment loads
//      and the hi / lo split) for every 24 mma.sync of a 3xTF32 k-step, and
//      run at ~25 % of the TF32 rate; tiles of 128 x 64 and 128 x 128, three
//      cp.async stages and an L2-friendlier grid order for q2 each moved
//      them by under 5 %, so neither L2 traffic nor load latency is the
//      limit. q1_ds splits every k and v element in all four warps. The next
//      step is wgmma with the operands split once into shared memory.
//  - K3 (the TPU's `_plain_bwd_q_kernel` forms s, dp and dq, and
//    `_plain_bwd_kv_kernel` forms s and dp again, then dk and dv: 14 BHTLD
//    FLOP a pair against the function's 10) is the template's instance
//    with no position term, in two launches on the two scratches: Q1 ds
//    with POS = kPosNone (no Q1 pos launch, no position logits read: s
//    starts at 0) forms s, dp, ds, P and dq = ds k in one walk over the
//    keys, then bwd-kv (K5 / K6 / K7's kernel, K3's instance
//    kKvFromPlain) forms dk = ds^T q and dv = P^T g from the scratches:
//    10 BHTLD FLOP. K3's Q1 ds runs eight warps a block: at the JETS
//    decoder's (8, 2, 512), D = 128, fp32, a block's 208,896 B of shared
//    memory admit one block an SM and the grid is 128 blocks, under one
//    wave, so four warps leave one warp on each of an SM's schedulers. The
//    two warp groups share the block's 64 query rows and walk alternate
//    key tiles, each with one k / v stage of its own (the same six (64, D)
//    tiles as the four-warp body's two stages), and sum their dq partials
//    through shared memory at the end (xl2_bwd_ds_split). Measured in one
//    call (tools/time_xl_bwd.py, H100, dropout 0.2, no slice sums in
//    either): eight warps 0.104 ms a launch at (8, 2, 512) against 0.126
//    for the four-warp body with s from 0; at (8, 2, 64), one key tile, 22
//    us against 19 (the second group idles). Every key tile below T is
//    walked (no live_end skip: bwd-kv reads every scratch cell below T).
//    Built at D in {32, 64, 128}, the widths K1 takes.
//  - A key tile wholly in the past of a query tile (every pair j <= i)
//    forms only the gA . t products, one wholly in the future only gB . t.
//  - K6 also runs at D = 128 (the JETS conformer, E = 256).
//
// What bounds them on the H100: K3 at the JETS decoder's training shape
// (B=8, H=2, T=512, D=128) needs 2*B*H*T^2*5D = 5.4 GFLOP (s, dp, dq, dk,
// dv), 0.033 ms under 3xTF32, against 16.8 MB of fp32 streams in and 12.6
// MB of gradients out (0.009 ms); Q1 writes the two scratches (16.8 MB
// each) and bwd-kv reads them, 0.020 ms more. At the training shapes (FS2:
// B=8, H=8, D=48; K4 at T=512, K5 at T=1008, E=384) the data needs
// 2*B*H*T^2*8D = 12.9 GFLOP for K4 bwd (s, the position term, g v, dqc,
// dk, dv, dqv, dp),
// 2*B*H*T^2*(3D + 2E) = 119 GFLOP for K5 bwd-q and, with bwd-kv reading
// Q1's scratches, 2*B*H*T^2*2D = 12.5 GFLOP for bwd-kv against 0.53 GB (K6
// the same). All run on the tensor cores (495 TFLOP/s TF32, three products
// a term for fp32 streams): 0.08 ms for K4 bwd at (8, 512), 0.72 ms for K5
// bwd-q at (8, 1008) if the tensor cores were the only limit, 0.08 ms for
// bwd-kv, which its 0.16 ms of scratch bytes bound instead. K4's band
// products pad its position work to 128 band columns for a tile's 64 keys
// (skipping the columns a warp's rows do not reach), about 1.5 times the
// function's operations in all. K7 bwd-q at the JETS training decoder (B=8,
// H=2, T=512, D=128, E=256) needs 2*B*H*T^2*(3D + 2E) = 7.5 GFLOP, 0.046 ms
// under 3xTF32; K7 bwd-kv there reads the two scratches and its streams
// (~50 MB, 0.015 ms at 3.35 TB/s) for 2*B*H*T^2*2D = 2.1 GFLOP (0.013 ms
// under 3xTF32): bound by those bytes, as K5 / K6's bwd-kv.
//
// Padding follows the forward. K4: keys past T are never formed (the
// reference scores them 2*MASK_NEG: weight exactly 0). K5 / K6 / K7: the
// Tp - T tail keys are virtual (dead, v = 0). A batch row whose keys are all
// padding has the uniform softmax, 1/T (K4) or 1/Tp (K5, K6, K7), and lse =
// -1e9 + log n rounds to -1e9 in fp32, where exp(l - lse) would give 1:
// these kernels detect the row and use the uniform weight, the dense
// gradient (the TPU kernels' dv is n times too large there, as K3 notes
// for K1). bf16 streams mirror `_mx`: p m / keep and ds are rounded to
// bf16 before the products they feed, with fp32 accumulation; every
// gradient is written in fp32.

#include <limits.h>

#include "xl3_band.cuh"
#include "xl_mma.cuh"

namespace {

constexpr int kThreads = 256;

// True when batch row b has no live key (block-wide; every thread calls).
__device__ __forceinline__ bool row_all_dead(const float* padb, int Tq) {
  int live = 0;
  for (int j = threadIdx.x; j < Tq; j += blockDim.x) live |= padb[j] <= 0.5f;
  return !__syncthreads_or(live);
}

// ---------------------------------------------------------------------------
// K5 / K6 backward on the tensor cores: Q1 (pos, then ds, dqc and P) and Q2
// (dgA, dgB), with K5's rotations before and after, then bwd-kv and dtab
// from Q1's scratches (see the header)
// ---------------------------------------------------------------------------

constexpr int kTC = 64;           // Q1 ds: query rows and keys a tile; Q2: table columns
constexpr int kKC = 32;           // contraction chunk of the pos and Q2 kernels
constexpr int kTCThreads = 128;   // Q1 ds: four warps of 16 query rows
constexpr int kQ1SplitThreads = 2 * kTCThreads;  // K3's Q1 ds: two groups of four
// Q1 pos: (query rows, keys) a block, cp.async stages; a warp a 32 x 32 tile
constexpr int kPosBM = 64, kPosBN = 64, kPosStages = 2;
constexpr int kPosThreads = (kPosBM / 32) * (kPosBN / 32) * 32;
// Q2: query rows a block (by kTC table columns), cp.async stages
constexpr int kQ2BM = 64, kQ2Stages = 2;
constexpr int kMaxGridZ = 65535;  // a grid's z limit
constexpr int kQ2Threads = (kQ2BM / 32) * (kTC / 32) * 32;
// bwd-kv: keys a block, query rows a stage, cp.async stages; eight warps,
// (dv or dk) x (32-key half) x (half of D)
constexpr int kKvBN = 64, kKvBQ = 32, kKvStages = 3;
constexpr int kKvThreads = 256;
// bwd-kv's instances, by the kernel that wrote its scratches
constexpr int kKvFromQ1 = 0;     // K5 / K6 / K7's Q1 ds
constexpr int kKvFromXl3 = 1;    // K4's ds kernel
constexpr int kKvFromPlain = 2;  // K3's Q1 ds (chunk sums)
// dtab: keys a block (by kTC table columns; a warp a 32 x 32 tile), query
// rows a stage, cp.async stages
constexpr int kDtBN = 64, kDtBQ = 32, kDtStages = 2;
constexpr int kDtThreads = (kDtBN / 32) * (kTC / 32) * 32;
// S's row length Ts: T rounded up to a multiple of every key tile
constexpr int kTsAlign = 128;
static_assert(kTsAlign % kPosBN == 0 && kTsAlign % kTC == 0 && kTsAlign % kKvBN == 0 &&
                  kTsAlign % kDtBN == 0,
              "Ts covers whole key tiles");


// The scratch of ds (and first of the position logits), and bwd-kv's of
// P: (B, H, T, Ts), Ts the key tiles' cover of T.
inline int ds_cols(int Tq) { return (Tq + kTsAlign - 1) / kTsAlign * kTsAlign; }

// Shared memory of each kernel.
template <typename T, int POS>
constexpr size_t xl2_bwd_pos_smem_bytes() {
  // kPosStages stages of the gA, gB chunks (kPosBM, 32) (K7: the one g
  // chunk) and the table chunk (kPosBN, 32)
  return sizeof(T) * kPosStages * ((POS == kPosRel ? 1 : 2) * kPosBM + kPosBN) *
         tile_ld(kKC);
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
template <typename T, int D>
constexpr size_t xl2_bwd_kv_smem_bytes() {
  // kKvStages stages of the P and ds tiles (kKvBQ, kKvBN) fp32 and the g
  // and qc rows (kKvBQ, D)
  return kKvStages * kKvBQ * (2 * sizeof(float) * tile_ld_nn<float, kKvBN>() +
                              2 * sizeof(T) * tile_ld_nn<T, D>());
}
template <typename T, int POS>
constexpr size_t xl2_bwd_dtab_smem_bytes() {
  // kDtStages stages of the ds tile (kDtBQ, kDtBN) fp32 and the gA, gB
  // rows (kDtBQ, 64 columns) (K7: the one g)
  return kDtStages * kDtBQ * (sizeof(float) * tile_ld_nn<float, kDtBN>() +
                              (POS == kPosRel ? 1 : 2) * sizeof(T) * tile_ld_nn<T, kTC>());
}

// The A fragment (16 x 8) at rows m0.., depths k0.. of A = X^T, from a
// tile X staged with the depth as its rows (ld fp32 words a row): lane
// (g, t) gets rows g and g + 8 at depths k0 + 2t and k0 + 2t + 1, in
// frag_a's slots (g, t), (g+8, t), (g, t+4), (g+8, t+4). Four scalar
// loads; an ld of 4 mod 16 words (tile_ld_nn) puts the 32 lanes of each
// on distinct banks.
__device__ __forceinline__ void load_a_t(const float* X, int ld, int m0, int k0,
                                         int lane, float x[4]) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = X + (k0 + 2 * t) * ld + m0 + g;
  x[0] = p[0];
  x[1] = p[8];
  x[2] = p[ld];
  x[3] = p[ld + 8];
}


// Q1, first kernel: the position logits of every (kPosBM-query,
// kPosBN-key) tile, pos_ij = gA_i . t_j (j <= i), gB_i . t_j (j >= i + 2),
// 0 (j = i + 1), into the scratch S (B, H, T, Ts). A tile wholly in the
// past forms only gA . t, one wholly in the future only gB . t. The E
// contraction walks 32-column chunks of gA / gB and the table, staged once
// each by cp.async kPosStages deep. A warp a 32 x 32 tile of the output.
// POS: kPosXl for K5 (on the rotation pass's streams) and K6; kPosRel for
// K7, pos_ij = g_i . t_j at every key (ga = g, gb unused): one pass a tile.
template <typename T, int POS>
__global__ void __launch_bounds__(kPosThreads)
    xl2_bwd_q1_pos_kernel(const T* __restrict__ ga, const T* __restrict__ gb,
                          const T* __restrict__ table, float* __restrict__ S,
                          int H, int Tq, int Ts, int E, int bh0) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr bool REL = POS == kPosRel;
  constexpr int LD = tile_ld(kKC);
  constexpr int TA = kPosBM * LD, TB = kPosBN * LD;
  constexpr int NA = REL ? 1 : 2;  // position streams staged
  constexpr int STAGE = NA * TA + TB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // [stage][gA, gB (not K7), table]

  const int j0 = blockIdx.x * kPosBN, i0 = blockIdx.y * kPosBM;
  const int bh = bh0 + blockIdx.z, b = bh / H, h = bh % H;
  const bool need_past = REL || j0 <= i0 + kPosBM - 1;
  const bool need_fut = !REL && j0 + kPosBN - 1 >= i0 + 2;
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
    cp_tile<T, kPosBN, kKC, kPosThreads>(st + NA * TA, LD, table, E, j0, Tq, e0);
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
        frag_b_nt<SPLIT>(st + NA * TA, LD, wn + ni * 8, k0, lane, bhi[ni],
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
          out[q] = REL || kj + q <= qi
                       ? acc_a[mi][ni][c]
                       : (kj + q >= qi + 2 ? acc_b[mi][ni][c] : 0.f);
        }
        *reinterpret_cast<float2*>(&Sb[(size_t)qi * Ts + kj]) =
            make_float2(out[0], out[1]);
      }
    }
}

// What a lane of Q1 ds keeps of its two query rows and their batch row.
struct Q1Rows {
  int qi[2];             // the lane's two query rows
  float lse[2], del[2];  // their logsumexp and delta
  const float* padb;     // the batch row's pad mask
  float* Sb;             // the (b, h) rows of S and P
  float* Pb;
  bool all_dead;
  float p_uniform;  // a fully padded row's weight, 1 / Tp
  uint32_t drop_key;
};

// Q1 ds, the two halves of a key tile's work for a warp's 16 query rows
// r0 .. r0 + 15 (its lanes' rows qi[0], qi[1]): first s (holding the
// position logits, or 0) += qc k^T and dp = g v^T on the tensor cores, from
// the staged qc, g (QC, GS) and the tile's k, v (KS, VS); then ds and P in
// the accumulators' layout, ds written over s and into S, P into the
// second scratch (WITH_P), and dqc += ds k with ds as the A operand
// straight from the registers: the key order inside each 8-key step is
// permuted (slot t <-> key 2t, slot t+4 <-> key 2t+1) so that the
// accumulator layout is the A fragment's. P = p m / keep, rounded to the
// stream dtype; a batch row whose keys are all padding (all_dead) gets the
// uniform weight m / Tp (the dense gradient) at every key below T; keys
// past T get 0.
//
// CHUNK_SUMS (K3's fp32 instances): each 32-wide slice of D is summed in
// accumulators of its own and added into s and dp in fp32, as K3's bwd-kv
// sums its row chunks (see xl2_bwd_kv_kernel): mma.sync's fp32
// accumulation drops the low bits of each addend aligned to the
// accumulator, and K3's dk sums those losses in dp over the query rows.
// Without the slice sums the card test at T = 1008 (B H = 64, dropout
// 0.2) missed the fp32 limit on dk (1.38e-4); with them it passes. At the
// JETS decoder's (8, 512) dq, dk and dv come within 4.2e-6, 1.2e-5 and
// 1.2e-5 of an fp64 reference, against 1.3e-5, 3.4e-5 and 3.7e-5 without
// them (the fp32 plain version: 3.4e-6, 1.2e-5, 1.4e-5), for ~6 % of Q1's
// time (tools/probe_bwd_sums.py, H100). bf16 streams (limit 2e-2) need
// none.
template <bool SPLIT, typename T, int D, bool CHUNK_SUMS>
__device__ __forceinline__ void q1_products(float (&s)[8][4], float (&dp)[8][4], const T* QC,
                                            const T* GS, const T* KS, const T* VS, int r0,
                                            int lane) {
  constexpr int LD = tile_ld(D);
  constexpr int KC = CHUNK_SUMS ? 32 : D;  // the slice of D a sum takes
  static_assert(D % KC == 0, "D is whole slices");
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int c = 0; c < 4; ++c) dp[ni][c] = 0.f;
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += KC) {
    float ps[8][4], pd[8][4];  // the slice's sums (CHUNK_SUMS)
    auto& ss = CHUNK_SUMS ? ps : s;
    auto& sd = CHUNK_SUMS ? pd : dp;
    if constexpr (CHUNK_SUMS) {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) ps[ni][c] = pd[ni][c] = 0.f;
    }
#pragma unroll
    for (int k0 = d0; k0 < d0 + KC; k0 += 8) {
      uint32_t qh[4], ql[4], gh[4], gl[4];
      frag_a<SPLIT>(QC, LD, r0, k0, lane, qh, ql);
      frag_a<SPLIT>(GS, LD, r0, k0, lane, gh, gl);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        uint32_t bhi[2], blo[2];
        frag_b_nt<SPLIT>(KS, LD, ni * 8, k0, lane, bhi, blo);
        mma3<SPLIT>(ss[ni], qh, ql, bhi, blo);
        frag_b_nt<SPLIT>(VS, LD, ni * 8, k0, lane, bhi, blo);
        mma3<SPLIT>(sd[ni], gh, gl, bhi, blo);
      }
    }
    if constexpr (CHUNK_SUMS) {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[ni][c] += ps[ni][c];
          dp[ni][c] += pd[ni][c];
        }
    }
  }
}

template <bool SPLIT, typename T, int D, bool WITH_P>
__device__ __forceinline__ void q1_ds_dq(float (&s)[8][4], const float (&dp)[8][4],
                                         float (&acc_q)[D / 8][4], const T* KS,
                                         const Q1Rows& rw, int j0, int Tq, int Ts,
                                         float scale, const DropArgs& drop, int lane) {
  constexpr int LD = tile_ld(D);
  constexpr int ND = D / 8;
  const int g4 = lane >> 2, t4 = lane & 3;
  // ds (0 at dead keys and rows past T) and P, in the accumulator layout
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int kj = j0 + ni * 8 + 2 * t4;
    bool dead[2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
      dead[q] = kj + q >= Tq || rw.padb[kj + q] > 0.5f;
    float pv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int hf = c >> 1, q = c & 1;
      float ds = 0.f;
      pv[c] = 0.f;
      if (rw.qi[hf] < Tq && (!dead[q] || (rw.all_dead && kj + q < Tq))) {
        const float m = keep_scale(drop, rw.drop_key, rw.qi[hf], kj + q);
        if (dead[q]) {
          pv[c] = to_stream<T>(rw.p_uniform * m);
        } else {
          const float pr = expf(s[ni][c] * scale - rw.lse[hf]);
          ds = to_stream<T>(pr * (dp[ni][c] * m - rw.del[hf]) * scale);
          pv[c] = to_stream<T>(pr * m);
        }
      }
      s[ni][c] = ds;
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (rw.qi[hf] >= Tq) continue;
      const size_t off = (size_t)rw.qi[hf] * Ts + kj;
      *reinterpret_cast<float2*>(&rw.Sb[off]) = make_float2(s[ni][2 * hf], s[ni][2 * hf + 1]);
      if constexpr (WITH_P)
        *reinterpret_cast<float2*>(&rw.Pb[off]) = make_float2(pv[2 * hf], pv[2 * hf + 1]);
    }
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
}

// A lane's Q1Rows for the warp's rows r0.. of query tile i0, head h, batch
// row b (all_dead is block-wide: every thread calls).
template <bool WITH_P>
__device__ __forceinline__ Q1Rows q1_rows(const float* pad, const float* lse,
                                          const float* delta, float* S, float* P, int b,
                                          int h, int H, int Tq, int Ts, int Tp, int i0,
                                          int r0, const DropArgs& drop, int lane) {
  Q1Rows rw;
  const size_t rbase = ((size_t)b * H + h) * Tq;
  rw.padb = pad + (size_t)b * Tq;
  rw.Sb = S + rbase * Ts;
  rw.Pb = WITH_P ? P + rbase * Ts : nullptr;
  rw.all_dead = WITH_P && row_all_dead(rw.padb, Tq);
  rw.p_uniform = 1.f / (float)Tp;
  rw.drop_key = vt_dropout_key(drop.seed, b, h);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    rw.qi[hf] = i0 + r0 + (lane >> 2) + 8 * hf;
    const bool in = rw.qi[hf] < Tq;
    rw.lse[hf] = in ? lse[rbase + rw.qi[hf]] : 0.f;
    rw.del[hf] = in ? delta[rbase + rw.qi[hf]] : 0.f;
  }
  return rw;
}

// dqc rows of a lane's accumulators (this lane's columns of rows qi).
template <int D>
__device__ __forceinline__ void q1_write_dq(float* dqc, size_t base, size_t rs,
                                            const float (&acc_q)[D / 8][4], const Q1Rows& rw,
                                            int Tq, int lane) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (rw.qi[hf] >= Tq) continue;
    float* out = dqc + base + (size_t)rw.qi[hf] * rs + 2 * (lane & 3);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(out + nd * 8) =
          make_float2(acc_q[nd][2 * hf], acc_q[nd][2 * hf + 1]);
  }
}

// K3's Q1 ds with eight warps a block (xl2_bwd_q1_ds_kernel's POS =
// kPosNone). The two warp groups of four share the block's 64
// query rows (qc and g staged once) and split its key tiles: group w / 4
// walks tiles w / 4, w / 4 + 2, ..., with one k / v stage of its own, so
// that where shared memory lets one block onto an SM (fp32, D = 128:
// 208,896 B) the SM runs eight warps, not four. A group's next v is in
// flight during its ds and dq, its next k after them, and the other group
// computes meanwhile. The groups' dqc partials meet in shared memory after
// the walk. Each group writes ds and P at its own keys.
template <typename T, int D, bool WITH_P>
__device__ __forceinline__ void xl2_bwd_ds_split(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ pad, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ S, float* __restrict__ P,
    float* __restrict__ dq, int H, int Tq, int Ts, int Tp, float scale, DropArgs drop) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int LD = tile_ld(D);
  constexpr int TILE = kTC * LD;
  constexpr int ND = D / 8;
  constexpr int GT = kTCThreads;  // a warp group's threads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* QC = reinterpret_cast<T*>(smem_raw);
  T* GS = QC + TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp >> 2, gtid = threadIdx.x & (GT - 1);
  T* KS = GS + (1 + 2 * grp) * TILE;  // the group's k and v stage
  T* VS = KS + TILE;
  const int i0 = blockIdx.x * kTC, h = blockIdx.y, b = blockIdx.z;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * Tq * rs + (size_t)h * D;
  const int r0 = (warp & 3) * 16;  // the warp's rows of the tile
  const Q1Rows rw = q1_rows<WITH_P>(pad, lse, delta, S, P, b, h, H, Tq, Ts, Tp, i0, r0, drop,
                                    lane);
  const int n_tiles = (Tq + kTC - 1) / kTC;
  // the group's four warps (named barrier 1 + grp; __syncthreads is 0)
  auto group_sync = [&] {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(kTCThreads) : "memory");
  };

  cp_tile<T, kTC, D, 2 * GT>(QC, LD, q + base, rs, i0, Tq, 0);
  cp_tile<T, kTC, D, 2 * GT>(GS, LD, g + base, rs, i0, Tq, 0);
  if (grp < n_tiles) {
    cp_tile_by<T, kTC, D, GT>(gtid, KS, LD, k + base, rs, grp * kTC, Tq, 0);
    cp_tile_by<T, kTC, D, GT>(gtid, VS, LD, v + base, rs, grp * kTC, Tq, 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // qc, g and each group's first tile have landed

  float acc_q[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_q[nd][c] = 0.f;

  for (int kt = grp; kt < n_tiles; kt += 2) {
    const int j0 = kt * kTC;
    const bool more = kt + 2 < n_tiles;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[ni][c] = 0.f;
    q1_products<SPLIT, T, D, SPLIT>(s, dp, QC, GS, KS, VS, r0, lane);
    group_sync();  // the group's warps have read v
    if (more) cp_tile_by<T, kTC, D, GT>(gtid, VS, LD, v + base, rs, j0 + 2 * kTC, Tq, 0);
    cp_async_commit();
    q1_ds_dq<SPLIT, T, D, WITH_P>(s, dp, acc_q, KS, rw, j0, Tq, Ts, scale, drop, lane);
    if (more) {
      group_sync();  // ... and k
      cp_tile_by<T, kTC, D, GT>(gtid, KS, LD, k + base, rs, j0 + 2 * kTC, Tq, 0);
      cp_async_commit();
      cp_async_wait<0>();
      group_sync();  // the group's next k and v have landed
    }
  }

  // group 1's dqc partial meets group 0's in shared memory, over the staged
  // tiles (no copy is in flight: the last tiles staged none)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);  // (64, D), row pitch LD
  const int g4 = lane >> 2, t4 = lane & 3;
  if (grp) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<float2*>(red + (r0 + g4 + 8 * hf) * LD + nd * 8 + 2 * t4) =
            make_float2(acc_q[nd][2 * hf], acc_q[nd][2 * hf + 1]);
  }
  __syncthreads();
  if (grp) return;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const float2 o = *reinterpret_cast<const float2*>(red + (r0 + g4 + 8 * hf) * LD +
                                                        nd * 8 + 2 * t4);
      acc_q[nd][2 * hf] += o.x;
      acc_q[nd][2 * hf + 1] += o.y;
    }
  q1_write_dq<D>(dq, base, rs, acc_q, rw, Tq, lane);
}

// Q1, second kernel: one block a (64-query tile, head, batch row), four
// warps of 16 query rows each, walking the 64-key tiles (k, v staged by
// cp.async two stages deep; qc and g staged once). Per key tile: s = pos +
// qc k^T and dp = g v^T on the tensor cores (the position logits read from
// S, the next tile's loaded into registers while this one computes), then
// ds, written over the logits in S, dqc += ds k and, WITH_P (bwd-kv
// follows), P into a second scratch shaped like S (q1_products, q1_ds_dq).
// WITH_P is a template flag, so that bwd-q alone runs the kernel without
// the P path's code. POS names the instance: kPosXl for every kind with a
// position term (K5, K6 and K7 share it: Q1 pos has written their logits
// into S); kPosNone for K3 (the plain attention: no position logits, s
// starts at 0, S holds only ds), whose instance runs eight warps
// (xl2_bwd_ds_split; with four, the body below with s from 0, it took
// 0.126 ms at (8, 2, 512) against 0.104, see the header).
template <typename T, int D, bool WITH_P, int POS>
__global__ void __launch_bounds__(POS == kPosNone ? kQ1SplitThreads : kTCThreads)
    xl2_bwd_q1_ds_kernel(const T* __restrict__ qc, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ pad,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ S,
                         float* __restrict__ P, float* __restrict__ dqc, int H,
                         int Tq, int Ts, int Tp, float scale, DropArgs drop) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  static_assert(POS == kPosXl || POS == kPosNone, "Q1 ds reads S's logits or none");
  if constexpr (POS == kPosNone) {
    xl2_bwd_ds_split<T, D, WITH_P>(qc, k, v, g, pad, lse, delta, S, P, dqc, H, Tq, Ts, Tp,
                                   scale, drop);
    return;
  }
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int r0 = warp * 16;  // the warp's rows of the tile
  const Q1Rows rw = q1_rows<WITH_P>(pad, lse, delta, S, P, b, h, H, Tq, Ts, Tp, i0, r0, drop,
                                    lane);

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
      const bool in = rw.qi[hf] < Tq;
      const float* row = rw.Sb + (size_t)(in ? rw.qi[hf] : 0) * Ts + j0 + 2 * t4;
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
      for (int c = 0; c < 4; ++c) s[ni][c] = pos[ni][c];
    if (kt + 1 < n_tiles) load_pos(j0 + kTC);  // in flight while we compute
    q1_products<SPLIT, T, D, false>(s, dp, QC, GS, KS, VS, r0, lane);
    q1_ds_dq<SPLIT, T, D, WITH_P>(s, dp, acc_q, KS, rw, j0, Tq, Ts, scale, drop, lane);
    __syncthreads();  // the stage is read before it is refilled
  }
  q1_write_dq<D>(dqc, base, rs, acc_q, rw, Tq, lane);
}

// Q2: dgA = (ds o past) t and dgB = (ds o future) t, a tensor-core product
// with the masks applied as the ds fragments are read. One block a
// (kQ2BM-query tile, 64-column table tile, A or B, (b, h)), the table
// tiles and A / B of one query tile adjacent in the grid so that they
// share its ds rows in L2; it walks only the 32-key chunks its mask
// reaches, j <= i (A) or j >= i + 2 (B), ds and the table staged by
// cp.async kQ2Stages deep. A warp a 32 x 32 tile of the output. dg_out
// gets dgA (K5: before its rotation), dgb_out dgB. K7 (POS = kPosRel):
// dg = ds t over every key, no mask, no A / B axis, dgb_out unused.
template <typename T, int POS>
__global__ void __launch_bounds__(kQ2Threads)
    xl2_bwd_q2_kernel(const float* __restrict__ S, const T* __restrict__ table,
                      float* __restrict__ dg_out, float* __restrict__ dgb_out,
                      int H, int Tq, int Ts, int E, int bh0) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr bool REL = POS == kPosRel;
  constexpr int LDA = tile_ld(kKC);
  constexpr int LDB = tile_ld_nn<T, kTC>();  // table chunk (32 keys, 64 columns)
  constexpr int TA = kQ2BM * LDA, TB = kKC * LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);          // [stage] ds
  T* Bs = reinterpret_cast<T*>(As + kQ2Stages * TA);       // [stage] table

  const int e0 = (REL ? blockIdx.x : blockIdx.x >> 1) * kTC;
  const bool fut = !REL && (blockIdx.x & 1);
  const int i0 = blockIdx.y * kQ2BM;
  const int bh = bh0 + blockIdx.z, b = bh / H, h = bh % H;
  const float* Sb = S + (size_t)bh * Tq * Ts;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / (kTC / 32) * 32, wn = warp % (kTC / 32) * 32;
  const int g4 = lane >> 2, t4 = lane & 3;

  // key chunks: past [0, min(i0 + BM, T)), future [i0 + 2, T), K7 [0, T)
  const int jlo = fut ? (i0 + 2) / kKC * kKC : 0;
  const int jhi = REL || fut ? Tq : min(i0 + kQ2BM, Tq);
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
    const bool edge = !REL && (fut ? jc < i0 + kQ2BM + 1 : jc + kKC - 1 > i0);
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

// bwd-kv: dv_j = sum_i P_ij g_i and dk_j = sum_i ds_ij qc_i over every
// query row i, from the scratches Q1 ds writes (P = p m / keep and ds, both
// (B, H, T, Ts) fp32, already rounded to the stream dtype): no position
// product, no exp, no dropout hash, no rotation. One block a (kKvBN-key
// tile, head, batch row) walks the kKvBQ-row query chunks, the P and ds
// tiles and the g and qc rows staged by cp.async kKvStages deep. Each
// product is m16n8k8 with the keys as M: the A fragment is the staged
// (query, key) tile read transposed (load_a_t), the B fragment the staged
// (query, feature) rows. Warp w forms dv (w < 4, from P and g) or dk (from
// ds and qc) for keys 32 ((w >> 1) & 1) .. + 31 and features
// (D / 2) (w & 1) .. + D / 2 - 1. SRC names the kernel that wrote the
// scratches, so that a profile tells the instances apart: kKvFromQ1 (K5,
// K6 and K7's Q1 ds), kKvFromXl3 (K4's xl3_bwd_ds_kernel), kKvFromPlain
// (K3's Q1 ds). K3's fp32 instances also sum each staged chunk's kKvBQ
// rows in an accumulator of their own and add that into the running sum
// in fp32: mma.sync's fp32 accumulation drops the low bits of each addend
// aligned to the accumulator, and over T = 512 rows into one accumulator
// that left dv 9.7e-5 from an fp64 reference at the JETS decoder's
// training inputs (8, 512), 1.05e-4 from the plain version, past the fp32
// limit of 1e-4; with the chunk sums 1.2e-5, as close as the plain
// version itself (cuBLAS in fp32: 1.4e-5). A fourth product (lo lo)
// changed no digit of it, so the products are not the cause. The chunk
// sums cost ~3 % of the kernel's time there (tools/probe_bwd_sums.py,
// H100). The other instances are left as they were.
template <typename T, int D, int SRC>
__global__ void __launch_bounds__(kKvThreads)
    xl2_bwd_kv_kernel(const T* __restrict__ qc, const T* __restrict__ g,
                      const float* __restrict__ S, const float* __restrict__ P,
                      float* __restrict__ dk, float* __restrict__ dv, int H,
                      int Tq, int Ts) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr bool CHUNK_SUMS = SPLIT && SRC == kKvFromPlain;
  constexpr int LDA = tile_ld_nn<float, kKvBN>();
  constexpr int LDB = tile_ld_nn<T, D>();
  constexpr int TA = kKvBQ * LDA, TB = kKvBQ * LDB;
  constexpr int NI = D / 16;  // 8-feature steps a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);          // [stage][P, ds]
  T* Bs = reinterpret_cast<T*>(As + kKvStages * 2 * TA);   // [stage][g, qc]

  const int j0 = blockIdx.x * kKvBN, h = blockIdx.y, b = blockIdx.z;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * Tq * rs + (size_t)h * D;
  const size_t soff = ((size_t)b * H + h) * Tq * Ts;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int prod = warp >> 2;  // 0: dv, 1: dk
  const int wm = ((warp >> 1) & 1) * 32, wn = (warp & 1) * (D / 2);
  const int g4 = lane >> 2, t4 = lane & 3;

  auto stage = [&](int s, int i0) {
    float* a = As + s * 2 * TA;
    T* bm = Bs + s * 2 * TB;
    cp_tile<float, kKvBQ, kKvBN, kKvThreads>(a, LDA, P + soff, Ts, i0, Tq, j0);
    cp_tile<float, kKvBQ, kKvBN, kKvThreads>(a + TA, LDA, S + soff, Ts, i0, Tq, j0);
    cp_tile<T, kKvBQ, D, kKvThreads>(bm, LDB, g + base, rs, i0, Tq, 0);
    cp_tile<T, kKvBQ, D, kKvThreads>(bm + TB, LDB, qc + base, rs, i0, Tq, 0);
  };

  float acc[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

  const int n_chunks = (Tq + kKvBQ - 1) / kKvBQ;
#pragma unroll
  for (int s = 0; s < kKvStages - 1; ++s) {
    if (s < n_chunks) stage(s, s * kKvBQ);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<kKvStages - 2>();
    __syncthreads();  // chunk ch has landed; chunk ch - 1's stage is free
    if (ch + kKvStages - 1 < n_chunks)
      stage((ch + kKvStages - 1) % kKvStages, (ch + kKvStages - 1) * kKvBQ);
    cp_async_commit();
    const float* A = As + (ch % kKvStages) * 2 * TA + prod * TA;
    const T* Bm = Bs + (ch % kKvStages) * 2 * TB + prod * TB;
    float part[2][NI][4];  // the chunk's sum (CHUNK_SUMS)
    auto& sum = CHUNK_SUMS ? part : acc;
    if constexpr (CHUNK_SUMS) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[mi][ni][c] = 0.f;
    }
#pragma unroll
    for (int k0 = 0; k0 < kKvBQ; k0 += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float x[4];
        load_a_t(A, LDA, wm + mi * 16, k0, lane, x);
#pragma unroll
        for (int c = 0; c < 4; ++c) split_tf32<SPLIT>(x[c], ah[mi][c], al[mi][c]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        uint32_t bhi[2], blo[2];
        frag_b_nn<SPLIT>(Bm, LDB, wn + ni * 8, k0, lane, bhi, blo);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma3<SPLIT>(sum[mi][ni], ah[mi], al[mi], bhi, blo);
      }
    }
    if constexpr (CHUNK_SUMS) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][ni][c] += part[mi][ni][c];
    }
  }

  float* out = prod ? dk : dv;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int kj = j0 + wm + mi * 16 + g4 + 8 * hf;
      if (kj >= Tq) continue;
      float* row = out + base + (size_t)kj * rs + wn + 2 * t4;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        *reinterpret_cast<float2*>(row + ni * 8) =
            make_float2(acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]);
    }
}

// One 8-row depth step of the dtab kernel: acc += (ds o mask)^T rows, the
// rows (gA or gB) staged at Bm. x holds the step's two ds fragments (as
// load_a_t reads them); slot c of fragment mi is the pair at key - query =
// rel + 16 mi + 8 (c & 1) - (c >> 1), zeroed (with edge) where the past
// (key <= query) or the future (key >= query + 2) mask is off.
template <bool SPLIT, typename T>
__device__ __forceinline__ void dtab_step(float (&acc)[2][4][4],
                                          const float (&x)[2][4], const T* Bm,
                                          int ldb, int wn, int k0, int lane,
                                          int rel, bool edge, bool fut) {
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float y = x[mi][c];
      if (edge) {
        const int r = rel + 16 * mi + 8 * (c & 1) - (c >> 1);
        if (fut ? r < 2 : r > 0) y = 0.f;
      }
      split_tf32<SPLIT>(y, ah[mi][c], al[mi][c]);
    }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    uint32_t bhi[2], blo[2];
    frag_b_nn<SPLIT>(Bm, ldb, wn + ni * 8, k0, lane, bhi, blo);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) mma3<SPLIT>(acc[mi][ni], ah[mi], al[mi], bhi, blo);
  }
}

// dtab_j = sum over (b, h) and query rows i of dsA_ij gA_i + dsB_ij gB_i,
// from Q1's ds scratch and the rotated streams (K5: bwd-q's gab; K6: its
// inputs): a tensor-core product with the keys as M, the table columns as
// N and the (b, h, query) rows as the contraction, ds masked to j <= i
// (past) or j >= i + 2 (future) as its fragments load. One block a
// (kDtBN-key tile, kTC-column tile, share of bh_per (b, h)), four warps of
// 32 keys x 32 columns; it walks the kDtBQ-row query chunks of each of its
// (b, h), staging the ds tile and only the gA / gB rows that the chunk's
// masks reach by cp.async kDtStages deep. part: this share's sum, partial
// blockIdx.z of (n_split, T, E). K7 (POS = kPosRel): dtab_j = sum over
// (b, h) and rows i of ds_ij g_i at every key, one stream (ga = g), no
// mask. (POS kPosXl serves K5, on the rotated streams, and K6.)
template <typename T, int POS>
__global__ void __launch_bounds__(kDtThreads)
    xl2_bwd_dtab_kernel(const float* __restrict__ S, const T* __restrict__ ga,
                        const T* __restrict__ gb, float* __restrict__ part,
                        int BH, int bh_per, int H, int Tq, int Ts, int E) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr bool REL = POS == kPosRel;
  constexpr int NB = REL ? 1 : 2;  // position streams staged
  constexpr int LDA = tile_ld_nn<float, kDtBN>();
  constexpr int LDB = tile_ld_nn<T, kTC>();
  constexpr int TA = kDtBQ * LDA, TB = kDtBQ * LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);         // [stage] ds
  T* Bs = reinterpret_cast<T*>(As + kDtStages * TA);      // [stage][gA, gB (not K7)]

  const int j0 = blockIdx.x * kDtBN, e0 = blockIdx.y * kTC;
  const int bh_lo = blockIdx.z * bh_per;
  const int n_bh = min(BH - bh_lo, bh_per);
  const int nq = (Tq + kDtBQ - 1) / kDtBQ;
  const int n_chunks = n_bh * nq;
  const size_t rse = (size_t)H * E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / (kTC / 32) * 32, wn = warp % (kTC / 32) * 32;
  const int g4 = lane >> 2, t4 = lane & 3;

  // chunk c: (b, h) = bh_lo + c / nq, query rows i0 = kDtBQ (c % nq) ..;
  // the past term reaches it when some i >= j0, the future one when some
  // i <= j0 + kDtBN - 3 (K7's one term reaches every chunk)
  auto stage = [&](int s, int c) {
    const int bh = bh_lo + c / nq, i0 = (c % nq) * kDtBQ;
    const size_t base_e = (size_t)(bh / H) * Tq * rse + (size_t)(bh % H) * E;
    T* bm = Bs + s * NB * TB;
    cp_tile<float, kDtBQ, kDtBN, kDtThreads>(As + s * TA, LDA, S + (size_t)bh * Tq * Ts,
                                            Ts, i0, Tq, j0);
    if (REL || i0 + kDtBQ - 1 >= j0)
      cp_tile<T, kDtBQ, kTC, kDtThreads>(bm, LDB, ga + base_e, rse, i0, Tq, e0);
    if (!REL && i0 <= j0 + kDtBN - 3)
      cp_tile<T, kDtBQ, kTC, kDtThreads>(bm + TB, LDB, gb + base_e, rse, i0, Tq, e0);
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kDtStages - 1; ++s) {
    if (s < n_chunks) stage(s, s);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<kDtStages - 2>();
    __syncthreads();  // chunk ch has landed; chunk ch - 1's stage is free
    if (ch + kDtStages - 1 < n_chunks)
      stage((ch + kDtStages - 1) % kDtStages, ch + kDtStages - 1);
    cp_async_commit();
    const int i0 = (ch % nq) * kDtBQ;
    const bool past = REL || i0 + kDtBQ - 1 >= j0, fut = !REL && i0 <= j0 + kDtBN - 3;
    // chunks across the diagonal mask their ds as the fragments load (K7
    // masks none)
    const bool edge_past = !REL && j0 + kDtBN - 1 > i0, edge_fut = j0 < i0 + kDtBQ + 1;
    const float* A = As + (ch % kDtStages) * TA;
    const T* BA = Bs + (ch % kDtStages) * NB * TB;
#pragma unroll
    for (int k0 = 0; k0 < kDtBQ; k0 += 8) {
      float x[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) load_a_t(A, LDA, wm + mi * 16, k0, lane, x[mi]);
      const int rel = j0 + wm + g4 - (i0 + k0 + 2 * t4);
      if (past) dtab_step<SPLIT>(acc, x, BA, LDB, wn, k0, lane, rel, edge_past, false);
      if (fut) dtab_step<SPLIT>(acc, x, BA + TB, LDB, wn, k0, lane, rel, edge_fut, true);
    }
  }

  float* out = part + (size_t)blockIdx.z * Tq * E;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int kj = j0 + wm + mi * 16 + g4 + 8 * hf;
      if (kj >= Tq) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<float2*>(&out[(size_t)kj * E + e0 + wn + ni * 8 + 2 * t4]) =
            make_float2(acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]);
    }
}

// dtab (T, E) = the sum of the dtab kernel's n_split partials.
__global__ void __launch_bounds__(kThreads)
    xl2_bwd_dtab_sum_kernel(const float* __restrict__ part,
                            float* __restrict__ dtab, int n_split, int Tq,
                            int E) {
  const size_t n = (size_t)Tq * E;
  for (size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * kThreads) {
    float sum = 0.f;
    for (int z = 0; z < n_split; ++z) sum += part[(size_t)z * n + idx];
    dtab[idx] = sum;
  }
}

// ---------------------------------------------------------------------------
// K4 bwd on the tensor cores: the ds kernel (ds, P, dqc, dqv and the
// table's partials), bwd-kv (K5 / K6's kernel, K4's instance) on its
// scratches, and the reduce pass
// ---------------------------------------------------------------------------

// kX3 (query rows and keys a tile) and kX3Band (band columns) are
// xl3_band.cuh's, shared with K4's forward
constexpr int kX3Threads = 256;      // eight warps: 16 query rows x half of the keys each
constexpr int kX3LDW = kX3Band + 4;  // the fp32 band tile's row pitch, 4 mod 16 words

// Rows of one block's table partial (a (batch row, query tile, head)): 64
// a key tile and 64 more (the ds kernel's carry).
__host__ __device__ inline int xl3_part_rows(int Tq) {
  return kX3 * ((Tq + kX3 - 1) / kX3 + 1);
}

template <typename T, int D>
constexpr size_t xl3_bwd_ds_smem_bytes() {
  // QC, GS, KS, VS (64, D), QV (65, D) and the band of p (128, D) in the
  // stream dtype; the band tile W (64, 128) in fp32. After the tile loop
  // the first 3 * 64 * D floats hold the key halves' partial dqc and dqv.
  return sizeof(T) * (5 * kX3 + 1 + kX3Band) * tile_ld(D) +
         sizeof(float) * kX3 * kX3LDW;
}
static_assert(xl3_bwd_ds_smem_bytes<__nv_bfloat16, 48>() >= sizeof(float) * 3 * kX3 * 64,
              "the smallest instance holds the partials of the widest one");

// One block a (64-query tile qt, head, batch row), eight warps: warp w
// holds query rows 16 (w % 4) .. + 15 and the keys of half w / 4 of each
// key tile (its pair, w ^ 4, the other half). It walks the 64-key tiles kt
// (k, v and the band of p staged by cp.async, the next tile's in flight
// during the table product; qc, g and qv staged once). Key tile kt's pairs
// reach 127 offsets rel = j - i = 64 (kt - qt) + u - 63, band column u in
// [0, 127): each past column (rel <= 0) reads p_{T-1+rel} against qv_i,
// each future one (rel >= 2) p_{rel-2} against qv_{i+1}, the column rel = 1
// is zero. A tile wholly in the past has only past columns, one wholly in
// the future only future ones, the diagonal tile both, split at u = 64.
// Per key tile:
//  - the position logits as a band product, X = qv band^T (past columns)
//    and qv_{+1} band^T (future), over the band columns the warp's pairs
//    reach, sheared into W (row r, key c = u + r - 63);
//  - s = pos + qc k^T and dp = g v^T; ds and P = p m / keep in the
//    accumulators' layout, written into the scratches S and P (B, H, T,
//    Ts) fp32 that bwd-kv reads (a fully padded batch row: P = m / T, K4's
//    dense weight; ds = 0);
//  - dqc += ds k over the warp's keys, ds the A operand from the registers
//    (xl_mma.cuh's permuted k order);
//  - ds sheared back into band form in W (column u of row r = the pair
//    (r, u + r - 63); 0 outside the row's band and at rel = 1), then, each
//    warp over half of its rows' band columns, dqv (own row) += W_past band
//    and dqv_b (row i's future term, added into row i + 1 by the reduce
//    pass) += W_future band;
//  - the table's partial G = W^T qv (past columns) or W^T qv_{+1}
//    (future), the 128 band columns as M and the 64 rows as the
//    contraction: warp w forms columns 16 (w % 4).. (lo) and 64 + 16 (w %
//    4).. (hi) for half w / 4 of D. Column u of tile kt and column u + 64
//    of tile kt - 1 hold one offset c (same kind), so hi is carried in
//    registers to the next tile's lo, and a block writes each of its
//    partial's rows L = 64 kt + u once (no zero fill, no atomics): L < 64
//    (qt + 1) is past offset c = T - 64 (qt + 1) + L, the rest future
//    c = L - 64 qt - 65.
// At the end the two key halves' partial dqc and dqv meet in shared memory.
// Skipped: band columns a warp's pairs do not reach, and the table
// product's row steps that hold no pair of a column block.
template <typename T, int D>
__global__ void __launch_bounds__(kX3Threads)
    xl3_bwd_ds_kernel(const T* __restrict__ qc, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ qv,
                      const T* __restrict__ p, const T* __restrict__ g,
                      const float* __restrict__ pad,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ S,
                      float* __restrict__ P, float* __restrict__ dqc,
                      float* __restrict__ dqv_a, float* __restrict__ dqv_b,
                      float* __restrict__ part, int H, int Tq, int Ts,
                      float scale, DropArgs drop) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int LD = tile_ld(D);
  constexpr int TILE = kX3 * LD;
  constexpr int ND = D / 8;
  constexpr int NH = ND / 2;  // 8-column steps of the warp's half of D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* QC = reinterpret_cast<T*>(smem_raw);
  T* GS = QC + TILE;
  T* KS = GS + TILE;
  T* VS = KS + TILE;
  T* QV = VS + TILE;            // rows i0 .. i0 + 64
  T* BC = QV + (kX3 + 1) * LD;  // the band of p, kX3Band rows
  float* W = reinterpret_cast<float*>(BC + kX3Band * LD);  // (64, kX3LDW)

  const int qt = blockIdx.x, i0 = qt * kX3, h = blockIdx.y, b = blockIdx.z;
  const int nt = (Tq + kX3 - 1) / kX3;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * Tq * rs + (size_t)h * D;
  const float* padb = pad + (size_t)b * Tq;
  const size_t rbase = ((size_t)b * H + h) * Tq;
  float* Sb = S + rbase * Ts;
  float* Pb = P + rbase * Ts;
  float* blk = part + (((size_t)b * nt + qt) * H + h) * xl3_part_rows(Tq) * D;
  const bool all_dead = row_all_dead(padb, Tq);
  const float p_uniform = 1.f / (float)Tq;  // a fully padded row's weight
  const uint32_t drop_key = vt_dropout_key(drop.seed, b, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int r0 = (warp & 3) * 16;  // the warp's rows of the tile
  const int hk = warp >> 2;        // its half of the keys (and of D)
  const int c0 = hk * (kX3 / 2);   // its first key of a tile
  // the band columns the warp's rows reach ([63 - r, 126 - r] for row r)
  const int ulo = kX3 - 16 - r0, uhi = kX3Band - 2 - r0;
  // where the key halves split the contraction over the rows' band
  // columns (dqv): five 8-column steps each
  const int umid = ((ulo + uhi + 1) / 2 + 4) / 8 * 8;
  int qi[2];
  float lse_r[2], del_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    qi[hf] = i0 + r0 + g4 + 8 * hf;
    const bool in = qi[hf] < Tq;
    lse_r[hf] = in ? lse[rbase + qi[hf]] : 0.f;
    del_r[hf] = in ? delta[rbase + qi[hf]] : 0.f;
  }

  // k, v and the band of p of key tile kt (the caller commits)
  auto stage = [&](int kt) {
    cp_tile<T, kX3, D, kX3Threads>(KS, LD, k + base, rs, kt * kX3, Tq, 0);
    cp_tile<T, kX3, D, kX3Threads>(VS, LD, v + base, rs, kt * kX3, Tq, 0);
    xl3_stage_band<T, D, kX3Threads>(BC, p, H, h, Tq, kt, qt);
  };

  cp_tile<T, kX3, D, kX3Threads>(QC, LD, qc + base, rs, i0, Tq, 0);
  cp_tile<T, kX3, D, kX3Threads>(GS, LD, g + base, rs, i0, Tq, 0);
  cp_tile<T, kX3 + 1, D, kX3Threads>(QV, LD, qv + base, rs, i0, Tq, 0);
  stage(0);
  cp_async_commit();

  float acc_q[ND][4], acc_a[ND][4], acc_b[ND][4], carry[NH][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc_q[nd][c] = acc_a[nd][c] = acc_b[nd][c] = 0.f;
      if (nd < NH) carry[nd][c] = 0.f;
    }

  // rows 64 kt + r0 + (g, g + 8), the warp's half of D, of the partial
  auto write_part = [&](int kt, const float (&x)[NH][4]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float* row = blk + (size_t)(kX3 * kt + r0 + g4 + 8 * hf) * D + hk * (D / 2) + 2 * t4;
#pragma unroll
      for (int nd = 0; nd < NH; ++nd)
        *reinterpret_cast<float2*>(row + nd * 8) =
            make_float2(x[nd][2 * hf], x[nd][2 * hf + 1]);
    }
  };

  for (int kt = 0; kt < nt; ++kt) {
    const int j0 = kt * kX3;
    const int u_split = xl3_u_split(kt, qt);
    cp_async_wait<0>();
    __syncthreads();  // tile kt's k, v and band have landed; W is free

    // the position logits of the warp's pairs, sheared into W[r][c]
    // (c = u + r - 63)
    xl3_band_logits<SPLIT, T, D, kX3 / 2>(QV, BC, W, kX3LDW, r0, c0, u_split, lane);
    __syncwarp();

    // s = pos + qc k^T, dp = g v^T over the warp's 32 keys
    float s[4][4], dp[4][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* row = W + (r0 + g4 + 8 * hf) * kX3LDW + c0 + 2 * t4;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float2 p2 = *reinterpret_cast<const float2*>(row + ni * 8);
        s[ni][2 * hf] = p2.x;
        s[ni][2 * hf + 1] = p2.y;
        dp[ni][2 * hf] = dp[ni][2 * hf + 1] = 0.f;
      }
    }
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 8) {
      uint32_t qh[4], ql[4], gh[4], gl[4];
      frag_a<SPLIT>(QC, LD, r0, k0, lane, qh, ql);
      frag_a<SPLIT>(GS, LD, r0, k0, lane, gh, gl);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        uint32_t bhi[2], blo[2];
        frag_b_nt<SPLIT>(KS, LD, c0 + ni * 8, k0, lane, bhi, blo);
        mma3<SPLIT>(s[ni], qh, ql, bhi, blo);
        frag_b_nt<SPLIT>(VS, LD, c0 + ni * 8, k0, lane, bhi, blo);
        mma3<SPLIT>(dp[ni], gh, gl, bhi, blo);
      }
    }

    // ds (0 at dead keys and rows past T) and P, in the accumulator layout
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int kj = j0 + c0 + ni * 8 + 2 * t4;
      bool dead[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) dead[q] = kj + q >= Tq || padb[kj + q] > 0.5f;
      float pv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int hf = c >> 1, q = c & 1;
        float ds = 0.f;
        pv[c] = 0.f;
        if (qi[hf] < Tq && (!dead[q] || (all_dead && kj + q < Tq))) {
          const float m = keep_scale(drop, drop_key, qi[hf], kj + q);
          if (dead[q]) {
            pv[c] = to_stream<T>(p_uniform * m);
          } else {
            const float pr = expf(s[ni][c] * scale - lse_r[hf]);
            ds = to_stream<T>(pr * (dp[ni][c] * m - del_r[hf]) * scale);
            pv[c] = to_stream<T>(pr * m);
          }
        }
        s[ni][c] = ds;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (qi[hf] >= Tq) continue;
        const size_t off = (size_t)qi[hf] * Ts + kj;
        *reinterpret_cast<float2*>(&Sb[off]) =
            make_float2(s[ni][2 * hf], s[ni][2 * hf + 1]);
        *reinterpret_cast<float2*>(&Pb[off]) =
            make_float2(pv[2 * hf], pv[2 * hf + 1]);
      }
    }

    // dqc += ds k: key step ni holds keys c0 + 8 ni + (2t, 2t+1) in slots
    // (t, t+4) of the A fragment
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      uint32_t ah[4], al[4];
      split_tf32<SPLIT>(s[ni][0], ah[0], al[0]);
      split_tf32<SPLIT>(s[ni][2], ah[1], al[1]);
      split_tf32<SPLIT>(s[ni][1], ah[2], al[2]);
      split_tf32<SPLIT>(s[ni][3], ah[3], al[3]);
      const T* krow = KS + (c0 + ni * 8 + 2 * t4) * LD + g4;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t bhi[2], blo[2];
        split_tf32<SPLIT>(to_float(krow[nd * 8]), bhi[0], blo[0]);
        split_tf32<SPLIT>(to_float(krow[LD + nd * 8]), bhi[1], blo[1]);
        mma3<SPLIT>(acc_q[nd], ah, al, bhi, blo);
      }
    }

    // ds in band form: the two key halves of a row write disjoint columns,
    // over position logits the other half may not have read yet
    __syncthreads();
    for (int idx = lane; idx < 16 * kX3; idx += 32) {
      // 0 outside each row's band: left of it (half 0), right of it (half 1)
      const int r = r0 + idx / kX3, e = idx % kX3;
      if ((e < kX3 - 1 - r) == (hk == 0)) W[r * kX3LDW + (hk ? e + kX3 : e)] = 0.f;
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = r0 + g4 + 8 * (c >> 1), col = c0 + ni * 8 + 2 * t4 + (c & 1);
        const bool zero = j0 + col == i0 + r + 1;  // rel = 1: no position term
        W[r * kX3LDW + col - r + kX3 - 1] = zero ? 0.f : s[ni][c];
      }
    __syncthreads();  // the rows' bands are whole

    // dqv (own row) += W_past band, dqv_b += W_future band, over the
    // warp's half of its rows' band columns
    auto dqv_step = [&](float (&acc)[ND][4], int u0) {
      uint32_t ah[4], al[4];
      frag_a<SPLIT>(W, kX3LDW, r0, u0, lane, ah, al);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t bhi[2], blo[2];
        frag_b_nn<SPLIT>(BC, LD, nd * 8, u0, lane, bhi, blo);
        mma3<SPLIT>(acc[nd], ah, al, bhi, blo);
      }
    };
    const int u_first = hk ? umid : ulo / 8 * 8, u_end = hk ? uhi + 1 : umid;
    for (int u0 = u_first; u0 < min(u_split, u_end); u0 += 8) dqv_step(acc_a, u0);
    for (int u0 = max(u_first, u_split); u0 < u_end; u0 += 8) dqv_step(acc_b, u0);

    __syncthreads();  // k, v and the band are read
    if (kt + 1 < nt) {
      stage(kt + 1);
      cp_async_commit();
    }

    // the table's partial: G[u] = sum_r W[r][u] qv_r (past) or qv_{r+1}
    // (future); lo columns r0.., hi 64 + r0..; row r reaches columns
    // [63 - r, 126 - r], so lo needs rows >= 48 - r0 and hi rows <= 62 - r0
    const int um_lo = r0, um_hi = kX3 + r0;
    const T* B_lo = QV + (um_lo >= u_split ? LD : 0) + hk * (D / 2);
    const T* B_hi = QV + (um_hi >= u_split ? LD : 0) + hk * (D / 2);
    float gh_acc[NH][4];
#pragma unroll
    for (int nd = 0; nd < NH; ++nd)
#pragma unroll
      for (int c = 0; c < 4; ++c) gh_acc[nd][c] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < kX3; k0 += 8) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half ? k0 > kX3 - 2 - r0 : k0 + 7 < kX3 - 16 - r0) continue;
        float x[4];
        load_a_t(W, kX3LDW, half ? um_hi : um_lo, k0, lane, x);
        uint32_t ah[4], al[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) split_tf32<SPLIT>(x[c], ah[c], al[c]);
#pragma unroll
        for (int nd = 0; nd < NH; ++nd) {
          uint32_t bhi[2], blo[2];
          frag_b_nn<SPLIT>(half ? B_hi : B_lo, LD, nd * 8, k0, lane, bhi, blo);
          mma3<SPLIT>(half ? gh_acc[nd] : carry[nd], ah, al, bhi, blo);
        }
      }
    }
    write_part(kt, carry);  // lo plus the previous tile's hi
#pragma unroll
    for (int nd = 0; nd < NH; ++nd)
#pragma unroll
      for (int c = 0; c < 4; ++c) carry[nd][c] = gh_acc[nd][c];
  }
  write_part(nt, carry);

  // the key halves' partial dqc, dqv and dqv_b meet in shared memory (no
  // copy is in flight: the last tile staged none)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);  // [3][64][D]
  auto slot = [&](int a, int hf, int nd) {
    return red + ((size_t)a * kX3 + r0 + g4 + 8 * hf) * D + nd * 8 + 2 * t4;
  };
  if (hk) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        *reinterpret_cast<float2*>(slot(0, hf, nd)) =
            make_float2(acc_q[nd][2 * hf], acc_q[nd][2 * hf + 1]);
        *reinterpret_cast<float2*>(slot(1, hf, nd)) =
            make_float2(acc_a[nd][2 * hf], acc_a[nd][2 * hf + 1]);
        *reinterpret_cast<float2*>(slot(2, hf, nd)) =
            make_float2(acc_b[nd][2 * hf], acc_b[nd][2 * hf + 1]);
      }
  }
  __syncthreads();
  if (hk) return;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (qi[hf] >= Tq) continue;
    const size_t off = base + (size_t)qi[hf] * rs + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const float2 q2 = *reinterpret_cast<const float2*>(slot(0, hf, nd));
      const float2 a2 = *reinterpret_cast<const float2*>(slot(1, hf, nd));
      const float2 b2 = *reinterpret_cast<const float2*>(slot(2, hf, nd));
      *reinterpret_cast<float2*>(dqc + off + nd * 8) =
          make_float2(acc_q[nd][2 * hf] + q2.x, acc_q[nd][2 * hf + 1] + q2.y);
      *reinterpret_cast<float2*>(dqv_a + off + nd * 8) =
          make_float2(acc_a[nd][2 * hf] + a2.x, acc_a[nd][2 * hf + 1] + a2.y);
      *reinterpret_cast<float2*>(dqv_b + off + nd * 8) =
          make_float2(acc_b[nd][2 * hf] + b2.x, acc_b[nd][2 * hf + 1] + b2.y);
    }
  }
}

// dp (T, H, D) = the ds kernel's table partials summed over batch rows and
// query tiles (row L of query tile qt's partial is past offset c = T - 64
// (qt + 1) + L for L < 64 (qt + 1), else future offset c = L - 64 qt -
// 65); dqv_i += dqv_b_{i-1} (row i-1's future term read qv_i).
__global__ void __launch_bounds__(kThreads)
    xl3_bwd_reduce_kernel(const float* __restrict__ part,
                          float* __restrict__ dp, float* __restrict__ dqv,
                          const float* __restrict__ dqv_b, int B, int H,
                          int Tq, int D) {
  const int nt = (Tq + kX3 - 1) / kX3, rows = xl3_part_rows(Tq);
  const size_t n_dp = (size_t)Tq * H * D;
  const size_t n_qv = (size_t)B * Tq * H * D;
  const size_t rs = (size_t)H * D;
  for (size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
       idx < n_dp + n_qv; idx += (size_t)gridDim.x * kThreads) {
    if (idx < n_dp) {
      const int c = (int)(idx / rs), h = (int)((idx / D) % H), d = (int)(idx % D);
      float sum = 0.f;
      for (int bq = 0; bq < B * nt; ++bq) {
        const int qt = bq % nt;
        const float* blk = part + ((size_t)bq * H + h) * rows * D + d;
        const int lp = c - Tq + kX3 * (qt + 1);
        if (lp >= 0) sum += blk[(size_t)lp * D];
        const int lf = c + kX3 * qt + kX3 + 1;
        if (lf < rows) sum += blk[(size_t)lf * D];
      }
      dp[idx] = sum;
    } else {
      const size_t j = idx - n_dp;
      if ((j / rs) % Tq >= 1) dqv[j] += dqv_b[j - rs];
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int grid_for(size_t n) {
  const size_t blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 8 ? (blocks > 0 ? blocks : 1) : 132 * 8);
}

// Q1: (K5, POS = kPosXlRot) the rotation pass g2 -> gab, then Q1 pos and
// Q1 ds. ga: K5's g2, K6's gA or K7's g; gb: K6's gB (K5, K7: unused).
// gab: K5's rotated streams (2, B, T, H, E) in the stream dtype; s, p: the
// scratches (B, H, T, ds_cols(T)) fp32, p null when no bwd-kv follows.
template <typename T, int D, int POS>
cudaError_t launch_xl2_bwd_q1(const void* qc, const void* k, const void* v,
                              const void* ga, const void* gb,
                              const void* table, const void* g,
                              const float* pad, const float* lse,
                              const float* delta, float* dqc, void* gab,
                              float* s, float* p, int B, int Tq, int Tp, int H,
                              int E, float scale, DropArgs drop,
                              cudaStream_t stream) {
  // K5 and K6 share one Q1 pos instance (K5 reads the rotated streams)
  constexpr int QPOS = POS == kPosRel ? kPosRel : kPosXl;
  constexpr size_t smem_pos = xl2_bwd_pos_smem_bytes<T, QPOS>();
  constexpr size_t smem_ds = xl2_bwd_ds_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      xl2_bwd_q1_pos_kernel<T, QPOS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_pos);
  if (err != cudaSuccess) return err;
  const auto ds_kernel = p == nullptr ? xl2_bwd_q1_ds_kernel<T, D, false, kPosXl>
                                      : xl2_bwd_q1_ds_kernel<T, D, true, kPosXl>;
  err = cudaFuncSetAttribute(ds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_ds);
  if (err != cudaSuccess) return err;
  const T* GA = static_cast<const T*>(ga);
  const T* GB = static_cast<const T*>(gb);
  if constexpr (POS == kPosXlRot) {
    T* ra = static_cast<T*>(gab);
    T* rb = ra + (size_t)B * Tq * H * E;
    err = launch_xl2_rotate<T>(GA, ra, rb, B, H, Tq, E, stream);
    if (err != cudaSuccess) return err;
    GA = ra;
    GB = rb;
  }
  const int Ts = ds_cols(Tq), BH = B * H;
  // Q1 pos, Q2 and dtab put (b, h) on grid.z: one launch for each
  // kMaxGridZ of them (one launch unless B * H passes 65535).
  for (int bh0 = 0; bh0 < BH; bh0 += kMaxGridZ) {
    xl2_bwd_q1_pos_kernel<T, QPOS>
        <<<dim3((Tq + kPosBN - 1) / kPosBN, (Tq + kPosBM - 1) / kPosBM,
                BH - bh0 < kMaxGridZ ? BH - bh0 : kMaxGridZ),
           kPosThreads, smem_pos, stream>>>(GA, GB, static_cast<const T*>(table), s,
                                            H, Tq, Ts, E, bh0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ds_kernel<<<dim3((Tq + kTC - 1) / kTC, H, B), kTCThreads, smem_ds, stream>>>(
          static_cast<const T*>(qc), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(g), pad, lse, delta,
          s, p, dqc, H, Tq, Ts, Tp, scale, drop);
  return cudaGetLastError();
}

// Q2 and, for K5 (POS = kPosXlRot), the inverse rotations. dg: K5's dg2,
// K6's dgA or K7's dg; dgb: K6's dgB, K5's scratch for it (K7: unused).
template <typename T, int POS>
cudaError_t launch_xl2_bwd_q2(const float* s, const void* table, float* dg,
                              float* dgb, int B, int Tq, int H, int E,
                              cudaStream_t stream) {
  // K5 and K6 share one Q2 instance; K7 has no A / B axis
  constexpr int QPOS = POS == kPosRel ? kPosRel : kPosXl;
  constexpr size_t smem_dg = xl2_bwd_dg_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(xl2_bwd_q2_kernel<T, QPOS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dg);
  if (err != cudaSuccess) return err;
  const int Ts = ds_cols(Tq), BH = B * H;
  for (int bh0 = 0; bh0 < BH; bh0 += kMaxGridZ) {
    xl2_bwd_q2_kernel<T, QPOS>
        <<<dim3((QPOS == kPosRel ? 1 : 2) * E / kTC, (Tq + kQ2BM - 1) / kQ2BM,
                BH - bh0 < kMaxGridZ ? BH - bh0 : kMaxGridZ),
           kQ2Threads, smem_dg, stream>>>(s, static_cast<const T*>(table), dg,
                                          dgb, H, Tq, Ts, E, bh0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if constexpr (POS != kPosXlRot) return cudaSuccess;
  const float freq_coef = (float)(-2.0 * log(10000.0) / (double)E);
  xl2_bwd_unrotate_kernel<<<grid_for((size_t)B * Tq * H * (E / 2)), kThreads,
                            0, stream>>>(dg, dgb, B, H, Tq, E, freq_coef);
  return cudaGetLastError();
}

template <typename T, int D, int SRC>
cudaError_t launch_xl2_bwd_kv(const void* qc, const void* g, const float* s,
                              const float* p, float* dk, float* dv, int B,
                              int Tq, int H, cudaStream_t stream) {
  constexpr size_t smem = xl2_bwd_kv_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      xl2_bwd_kv_kernel<T, D, SRC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  xl2_bwd_kv_kernel<T, D, SRC>
      <<<dim3((Tq + kKvBN - 1) / kKvBN, H, B), kKvThreads, smem, stream>>>(
          static_cast<const T*>(qc), static_cast<const T*>(g), s, p, dk, dv, H,
          Tq, ds_cols(Tq));
  return cudaGetLastError();
}

// K3's Q1 (the plain attention's: no position term, so no Q1 pos launch):
// ds into s, dq and, when p is not null (bwd-kv follows), P into p.
template <typename T, int D>
cudaError_t launch_plain_bwd_q1(const void* q, const void* k, const void* v, const void* g,
                                const float* pad, const float* lse, const float* delta,
                                float* dq, float* s, float* p, int B, int Tq, int Tp, int H,
                                float scale, DropArgs drop, cudaStream_t stream) {
  constexpr size_t smem = xl2_bwd_ds_smem_bytes<T, D>();
  static_assert(sizeof(float) * kTC * tile_ld(D) <= smem,
                "xl2_bwd_ds_split's dq partial fits over the staged tiles");
  const auto kernel = p == nullptr ? xl2_bwd_q1_ds_kernel<T, D, false, kPosNone>
                                   : xl2_bwd_q1_ds_kernel<T, D, true, kPosNone>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Tq + kTC - 1) / kTC, H, B), kQ1SplitThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), pad, lse, delta, s, p, dq, H, Tq, ds_cols(Tq), Tp, scale, drop);
  return cudaGetLastError();
}

// K4 bwd: the ds kernel, bwd-kv on its scratches s (ds) and pm (P), then
// the reduce pass (dp from the partials, dqv += the shifted dqv_b).
template <typename T, int D>
cudaError_t launch_xl3_bwd(const void* qc, const void* k, const void* v,
                           const void* qv, const void* p, const void* g,
                           const float* pad, const float* lse,
                           const float* delta, float* dqc, float* dk,
                           float* dv, float* dqv, float* dqv_b, float* part,
                           float* dp, float* s, float* pm, int B, int Tq, int H,
                           float scale, DropArgs drop, cudaStream_t stream) {
  constexpr size_t smem = xl3_bwd_ds_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      xl3_bwd_ds_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  xl3_bwd_ds_kernel<T, D>
      <<<dim3((Tq + kX3 - 1) / kX3, H, B), kX3Threads, smem, stream>>>(
          static_cast<const T*>(qc), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(qv),
          static_cast<const T*>(p), static_cast<const T*>(g), pad, lse, delta,
          s, pm, dqc, dqv, dqv_b, part, H, Tq, ds_cols(Tq), scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_xl2_bwd_kv<T, D, kKvFromXl3>(qc, g, s, pm, dk, dv, B, Tq, H, stream);
  if (err != cudaSuccess) return err;
  xl3_bwd_reduce_kernel<<<grid_for((size_t)(1 + B) * Tq * H * D), kThreads, 0,
                          stream>>>(part, dp, dqv, dqv_b, B, H, Tq, D);
  return cudaGetLastError();
}

// part: (n_split, T, E) fp32 scratch, unused when n_split is 1 (the
// kernel then writes dtab itself). POS: kPosXl (K5, K6) or kPosRel (K7).
template <typename T, int POS>
cudaError_t launch_xl2_bwd_dtab(const float* s, const void* ga, const void* gb,
                                float* part, float* dtab, int n_split,
                                int bh_per, int B, int Tq, int H, int E,
                                cudaStream_t stream) {
  constexpr size_t smem = xl2_bwd_dtab_smem_bytes<T, POS>();
  cudaError_t err = cudaFuncSetAttribute(
      xl2_bwd_dtab_kernel<T, POS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  float* out = n_split == 1 ? dtab : part;
  xl2_bwd_dtab_kernel<T, POS>
      <<<dim3((Tq + kDtBN - 1) / kDtBN, E / kTC, n_split), kDtThreads, smem,
         stream>>>(s, static_cast<const T*>(ga), static_cast<const T*>(gb), out,
                   B * H, bh_per, H, Tq, ds_cols(Tq), E);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  xl2_bwd_dtab_sum_kernel<<<grid_for((size_t)Tq * E), kThreads, 0, stream>>>(
      part, dtab, n_split, Tq, E);
  return cudaGetLastError();
}

bool bad_args(int B, int T, int H, double dropout_p) {
  return B <= 0 || H <= 0 || T <= 0 || T >= 65536 || B >= 65536 ||
         H >= 65536 || !(dropout_p >= 0.0 && dropout_p < 1.0);
}

// ... and for K5 / K6, whose kernels index (b, h) as one int (no such
// batch fits the card)
bool bad_xl_args(int B, int T, int H, double dropout_p) {
  return bad_args(B, T, H, dropout_p) || (long long)B * H > INT_MAX - kMaxGridZ;
}

// No kernel's shared memory depends on E; Q2 and dtab take 64-column table
// tiles. 512 is the widest table the card tests hold.
constexpr int kMaxEBwd = 512;
bool bad_e(int E) { return E <= 0 || E % kTC != 0 || E > kMaxEBwd; }

// The built head dims of position kind pos (kPosXl K6, kPosXlRot K5,
// kPosRel K7): 48 and 64 for K5 and K6, 128 for K6 and K7 (the JETS
// conformer's two rel-pos flavours).
bool bad_head(int D, int pos) {
  if (pos == kPosRel) return D != 128;
  return !(D == 48 || D == 64 || (D == 128 && pos == kPosXl));
}
bool bad_pos(int pos) { return pos != kPosXl && pos != kPosXlRot && pos != kPosRel; }

// One bwd-q Q1 launch sequence of position kind POS, by head dim and dtype.
template <int POS>
int q1_entry(const void* qc, const void* k, const void* v, const void* ga,
             const void* gb, const void* table, const void* g, const float* pad,
             const float* lse, const float* delta, float* dqc, void* gab, float* s,
             float* p, int B, int T, int Tp, int H, int D, int E, int is_bf16,
             float scale, DropArgs drop, cudaStream_t st) {
#define VT_Q1(TYPE, DIM)                                                        \
  launch_xl2_bwd_q1<TYPE, DIM, POS>(qc, k, v, ga, gb, table, g, pad, lse, delta, \
                                    dqc, gab, s, p, B, T, Tp, H, E, scale, drop, \
                                    st)
  if constexpr (POS != kPosRel) {
    switch (D * 2 + (is_bf16 ? 1 : 0)) {
      case 96: return (int)VT_Q1(float, 48);
      case 97: return (int)VT_Q1(__nv_bfloat16, 48);
      case 128: return (int)VT_Q1(float, 64);
      case 129: return (int)VT_Q1(__nv_bfloat16, 64);
      default: break;
    }
  }
  if constexpr (POS != kPosXlRot) {
    switch (D * 2 + (is_bf16 ? 1 : 0)) {
      case 256: return (int)VT_Q1(float, 128);
      case 257: return (int)VT_Q1(__nv_bfloat16, 128);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
#undef VT_Q1
}

template <int POS>
int q2_entry(const float* s, const void* table, float* dg, float* dgb, int B,
             int T, int H, int E, int is_bf16, cudaStream_t st) {
  if (is_bf16)
    return (int)launch_xl2_bwd_q2<__nv_bfloat16, POS>(s, table, dg, dgb, B, T, H, E, st);
  return (int)launch_xl2_bwd_q2<float, POS>(s, table, dg, dgb, B, T, H, E, st);
}

}  // namespace

extern "C" {

// K4 bwd. qc, k, v, qv, g: (B, T, H, D) contiguous, fp32 (is_bf16 = 0) or
// bf16; p: (T, H, D), same dtype; pad: (B, T) fp32, 1.0 at padding keys;
// lse, delta: (B, H, T) fp32; dropout_p and seed: the forward's. Outputs,
// fp32: dqc, dk, dv, dqv (B, T, H, D); dp (T, H, D). Scratch, fp32, none
// of it zero-filled: dqv_b (B, T, H, D); part (B, ceil(T / 64), H,
// 64 (ceil(T / 64) + 1), D); s and pm (B, H, T, 128 ceil(T / 128)).
// Returns the first cudaError_t of the three launches.
int vt_flash_xl3_bwd(const void* qc, const void* k, const void* v,
                     const void* qv, const void* p, const void* g,
                     const float* pad, const float* lse, const float* delta,
                     float* dqc, float* dk, float* dv, float* dqv, float* dp,
                     float* dqv_b, float* part, float* s, float* pm, int B,
                     int T, int H, int D, int is_bf16, float scale,
                     double dropout_p, uint64_t seed, void* stream) {
  if (bad_args(B, T, H, dropout_p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropArgs drop = drop_args(dropout_p, seed);
#define VT_XL3B(TYPE, DIM)                                                   \
  launch_xl3_bwd<TYPE, DIM>(qc, k, v, qv, p, g, pad, lse, delta, dqc, dk, dv, \
                            dqv, dqv_b, part, dp, s, pm, B, T, H, scale, drop, \
                            st)
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 96: return (int)VT_XL3B(float, 48);
    case 97: return (int)VT_XL3B(__nv_bfloat16, 48);
    case 128: return (int)VT_XL3B(float, 64);
    case 129: return (int)VT_XL3B(__nv_bfloat16, 64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VT_XL3B
}

// The K5 (pos = 1) / K6 (pos = 0) backward in four stages that share the
// scratch s and bwd-kv's p, (B, H, T, 128 * ceil(T / 128)) fp32 each: Q1,
// then Q2 (bwd-q's dg), bwd-kv (dk, dv) and dtab in any order; K7's bwd-q
// (pos = 2) as Q1 and Q2. Streams qc, k, v, g (the cotangent):
// (B, T, H, D); K5's g2 (ga; gb null), K6's gA, gB or K7's g (ga; gb
// null): (B, T, H, E); table (T, E); all one dtype, E a multiple of 64 up
// to 512, D in {48, 64} (K6 also 128; K7 128 only). pad, lse, delta,
// dropout_p, seed as K4 bwd; Tp >= T the forward's padded length (the keys
// in [T, Tp) are virtual).
//
// Q1: dqc (B, T, H, D) fp32; K5 writes its rotated streams into gab
// (2, B, T, H, E), stream dtype; p null when no bwd-kv follows. Returns
// the first cudaError_t of its launches.
int vt_xl_bwd_q1(const void* qc, const void* k, const void* v, const void* ga,
                 const void* gb, const void* table, const void* g,
                 const float* pad, const float* lse, const float* delta,
                 float* dqc, void* gab, float* s, float* p, int B, int T,
                 int Tp, int H, int D, int E, int is_bf16, int pos,
                 float scale, double dropout_p, uint64_t seed, void* stream) {
  if (bad_xl_args(B, T, H, dropout_p) || bad_e(E) || bad_pos(pos) || bad_head(D, pos) ||
      Tp < T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropArgs drop = drop_args(dropout_p, seed);
#define VT_Q1E(POS)                                                                  \
  q1_entry<POS>(qc, k, v, ga, gb, table, g, pad, lse, delta, dqc, gab, s, p, B, T, Tp, \
                H, D, E, is_bf16, scale, drop, st)
  switch (pos) {
    case kPosXl: return VT_Q1E(kPosXl);
    case kPosXlRot: return VT_Q1E(kPosXlRot);
    default: return VT_Q1E(kPosRel);
  }
#undef VT_Q1E
}

// Q2: dg (B, T, H, E) fp32, K5's dg2, K6's dgA or K7's dg; dgb (same
// shape) K6's dgB or K5's scratch (K7: unused, may be null).
int vt_xl_bwd_q2(const float* s, const void* table, float* dg, float* dgb,
                 int B, int T, int H, int E, int is_bf16, int pos,
                 void* stream) {
  if (bad_xl_args(B, T, H, 0.0) || bad_e(E) || bad_pos(pos) ||
      (pos != kPosRel && dgb == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pos) {
    case kPosXl: return q2_entry<kPosXl>(s, table, dg, dgb, B, T, H, E, is_bf16, st);
    case kPosXlRot: return q2_entry<kPosXlRot>(s, table, dg, dgb, B, T, H, E, is_bf16, st);
    default: return q2_entry<kPosRel>(s, table, dg, dgb, B, T, H, E, is_bf16, st);
  }
}

// bwd-kv: dk, dv (B, T, H, D) fp32 from Q1's s and p and the streams qc, g.
int vt_xl_bwd_kv(const void* qc, const void* g, const float* s, const float* p,
                 float* dk, float* dv, int B, int T, int H, int D, int is_bf16,
                 void* stream) {
  if (bad_xl_args(B, T, H, 0.0) || bad_head(D, kPosXl)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VT_KV(TYPE, DIM) \
  launch_xl2_bwd_kv<TYPE, DIM, kKvFromQ1>(qc, g, s, p, dk, dv, B, T, H, st)
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 96: return (int)VT_KV(float, 48);
    case 97: return (int)VT_KV(__nv_bfloat16, 48);
    case 128: return (int)VT_KV(float, 64);
    case 129: return (int)VT_KV(__nv_bfloat16, 64);
    case 256: return (int)VT_KV(float, 128);
    case 257: return (int)VT_KV(__nv_bfloat16, 128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VT_KV
}

// K3's Q1 (K3a; with bwd-kv after it on s and p, K3b), the plain
// attention's backward: q, k, v, g (the cotangent of ctx in the stream
// dtype) (B, T, H, D), fp32 (is_bf16 = 0) or bf16, D in {32, 64, 128}; pad,
// lse, delta, dropout_p, seed as K4 bwd; Tp >= T the forward's padded
// length (the keys in [T, Tp) are virtual). Outputs, fp32: dq (B, T, H, D);
// ds into s and, when p is not null, P = p m / keep into p, both scratches
// (B, H, T, 128 ceil(T / 128)). Returns the launch's cudaError_t.
int vt_flash_attn_bwd_q1(const void* q, const void* k, const void* v, const void* g,
                         const float* pad, const float* lse, const float* delta, float* dq,
                         float* s, float* p, int B, int T, int Tp, int H, int D, int is_bf16,
                         float scale, double dropout_p, uint64_t seed, void* stream) {
  if (bad_args(B, T, H, dropout_p) || Tp < T) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropArgs drop = drop_args(dropout_p, seed);
#define VT_K3(TYPE, DIM)                                                                    \
  (int)launch_plain_bwd_q1<TYPE, DIM>(q, k, v, g, pad, lse, delta, dq, s, p, B, T, Tp, H, \
                                      scale, drop, st)
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 64: return VT_K3(float, 32);
    case 65: return VT_K3(__nv_bfloat16, 32);
    case 128: return VT_K3(float, 64);
    case 129: return VT_K3(__nv_bfloat16, 64);
    case 256: return VT_K3(float, 128);
    case 257: return VT_K3(__nv_bfloat16, 128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VT_K3
}

// K3b's bwd-kv on the scratches s (ds) and p (P) of K3's Q1 (run with p):
// dk = ds^T q, dv = P^T g, (B, T, H, D) fp32; q, g and D as K3's Q1.
int vt_flash_attn_bwd_kv(const void* q, const void* g, const float* s, const float* p,
                         float* dk, float* dv, int B, int T, int H, int D, int is_bf16,
                         void* stream) {
  if (bad_args(B, T, H, 0.0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VT_K3KV(TYPE, DIM) \
  (int)launch_xl2_bwd_kv<TYPE, DIM, kKvFromPlain>(q, g, s, p, dk, dv, B, T, H, st)
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 64: return VT_K3KV(float, 32);
    case 65: return VT_K3KV(__nv_bfloat16, 32);
    case 128: return VT_K3KV(float, 64);
    case 129: return VT_K3KV(__nv_bfloat16, 64);
    case 256: return VT_K3KV(float, 128);
    case 257: return VT_K3KV(__nv_bfloat16, 128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VT_K3KV
}

// dtab (T, E) fp32 from Q1's s and the rotated streams ga, gb (K5: the two
// halves of gab; K6: gA, gB), the (b, h) split into n_split shares of
// bh_per; part: (n_split, T, E) fp32 scratch (unused, may be null, when
// n_split is 1). gb null selects K7's form: ga is K7's g, and dtab_j sums
// ds_ij g_i at every key (no past / future mask).
int vt_xl_bwd_dtab(const float* s, const void* ga, const void* gb, float* part,
                   float* dtab, int n_split, int bh_per, int B, int T, int H,
                   int E, int is_bf16, void* stream) {
  if (bad_xl_args(B, T, H, 0.0) || bad_e(E) || n_split < 1 || n_split > kMaxGridZ ||
      bh_per < 1 || (long long)n_split * bh_per < (long long)B * H ||
      (long long)(n_split - 1) * bh_per >= (long long)B * H ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VT_DT(TYPE, POS) \
  (int)launch_xl2_bwd_dtab<TYPE, POS>(s, ga, gb, part, dtab, n_split, bh_per, B, T, H, E, st)
  if (gb == nullptr) return is_bf16 ? VT_DT(__nv_bfloat16, kPosRel) : VT_DT(float, kPosRel);
  return is_bf16 ? VT_DT(__nv_bfloat16, kPosXl) : VT_DT(float, kPosXl);
#undef VT_DT
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
