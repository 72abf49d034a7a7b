// Kernels K1, K4, K5, K6 and K7 forward: plain scaled-dot attention (K1,
// the JETS transformer stacks'), Transformer-XL relative-position attention
// (the FS2 conformer's self-attention; K6 also the JETS conformer's legacy
// rel-pos flavour) and espnet "latest" relative-position attention (K7,
// the JETS conformer's), with an online softmax, for Hopper (sm_90a).
//
// Replace the TPU kernels of viet_tts_tpu/ops/pallas_attention.py:
//   K1 `_plain_kernel` (`_plain_pallas` through `_call_flash`), no position
//      term;
//   K4 `_xl3_kernel` (launched by `_xl3_pallas`), the projected-table form;
//   K5 `_xl2_kernel` (`_xl2_pallas` through `_call_flash`), one position
//      stream rotated inside the kernel;
//   K6 `_xl_kernel` (`_xl_pallas` through `_call_flash`), two pre-rotated
//      position streams;
//   K7 `_rel_kernel` (`_rel_pallas` through `_call_flash`), one position
//      stream against the table at every key.
// K4, K5 and K6 compute ctx_i = sum_j softmax_j(logit_ij) v_j with
//   logit_ij = (qc_i . k_j + pos_ij) * scale, MASK_NEG = -1e9 at padded keys,
//   pos_ij   = P_i(j)  for j <= i  (the past term)
//            = 0       for j == i + 1
//            = F_i(j)  for j >= i + 2 (the future term: the XL shift makes
//                                      row i read row i + 1's scores),
// and emit the per-row logsumexp beside the fp32 context. K7 is the same
// function with pos_ij = g_i . t_j at every key (the TPU's `_rel_kernel` is
// `_xl_kernel` without the select): qc = q + pos_bias_u, g the pre-rotated
// position queries (B, T, H, E), t the negative half of the symmetric
// sinusoid table (T, E). K1 is the same function with pos_ij = 0 (qc = q),
// at D in {32, 64, 128}; the backward kernels K3a / K3b
// (flash_attention_bwd.cu) read its lse. Inputs are fp32 or bf16 in the JAX
// package's feature-last layouts, read in place; all arithmetic is fp32.
//
// K4: P_i(j) = qv_i . p_{T-1-i+j} and F_i(j) = qv_{i+1} . p_{j-i-2}, with p
// the projected table (T, H, D). The TPU keeps the whole (tp, tp) score tile
// in VMEM and shears it with lane rolls, over p left-padded to tp (a multiple
// of 128) and read at (j-i-1) mod tp and (j-i-2+d_pad) mod tp. Written out,
// those indices are T-1-(i-j) and j-i-2 for every real key (no wrap-around
// reaches a key below T), and the wrapper's tail keys score 2*MASK_NEG, so
// they weigh exactly 0 even in a row whose keys are all padding. Here the
// kernel (`xl3_fwd_band_kernel`, below) tiles queries and keys (64 x 64)
// and never forms the tail: for a tile it stages the band of the 127 rows
// of p that the tile's offsets j - i reach, forms the position logits as a
// tensor-core product of qv (qv one row down for the future columns) with
// the band, and shears them from (row, offset) into (row, key) space
// through shared memory (xl3_band.cuh, which K4 bwd's ds kernel shares);
// then qc k^T and the flash loop's back half, as K5 / K6 / K7.
//
// K5 and K6: P_i(j) = gA_i . t_j and F_i(j) = gB_i . t_j against the raw
// sinusoid table t (T, E), E = d_model = 384. K6 reads gA and gB. K5 reads
// g = K_h(q + v_bias) and rotates its (2m, 2m+1) pairs per row, gA_i =
// rot(g_i, (T-1-i) w_m) and gB_i = rot(g_{i+1}, -(i+2) w_m), w_m =
// exp(m * (-2 ln 10000 / E)): the TPU kernel's own formula
// (`_xl2_cos_sin`), with the accurate expf and sincosf (angles reach
// ~2000 rad). The pair layout is the interleaved one of the inputs; the TPU
// de-interleaves it for its lanes, which changes no dot product. The
// wrapper pads T to Tp (a multiple of 32) and marks the tail as padded
// keys; here the Tp - T tail keys are virtual: they add (Tp - T) *
// exp(MASK_NEG - m) to the denominator and nothing to the context, so a row
// whose keys are all padding averages v over all Tp keys, as the TPU kernel
// and the dense path do; keys past T inside a key tile score -inf. K7 and
// K1 pad the same way (their JAX wrappers do).
//
// What bounds K1 / K4 / K5 / K6 / K7 on the H100: at the decoder shape (B=16,
// H=8, T=1008, D=48, E=384) K5 does 2*B*H*T^2*(D + E + D) = 1.25e11 FLOP of
// dot products against ~260 MB of inputs: bound by operations, 80 % of them
// the E-wide position products; K7 at its serving shape (B=16, H=2, T=1008,
// D=128, E=256) 33 GFLOP against ~50 MB; K4 at the FS2 training decoder (B=8,
// H=8, T=512, D=48) 2*B*H*T^2*3D = 4.8 GFLOP against ~40 MB (its band products
// pad the position work to ~1.3x); K1 at the JETS decoder (B=16, H=2, T=1008,
// D=128) 4*B*H*T^2*D = 17 GFLOP against ~66 MB, 260 FLOP a byte (fewer on
// ragged rows, whose padded key tiles it skips). So every product runs on the
// tensor cores, `mma.sync.m16n8k8` TF32 with fp32 accumulation (xl_mma.cuh):
// fp32 streams in 3xTF32 (one TF32 product misses the fp32 limits on ctx and
// lse: tests/test_torch_xl_fwd_precision.py for K5,
// tests/test_torch_rel_fwd_precision.py for K7,
// tests/test_torch_xl3_fwd_precision.py for K4,
// tests/test_torch_flash_fwd_precision.py for K1), bf16 streams in one TF32
// product, exact for bf16 values (and p rounded to bf16, as the JAX `_mx`
// rounds it; m16n8k16 bf16 would run twice the rate but a second code path).
// The K1 / K5 / K6 / K7 kernel (`xl2_fwd_kernel`, below) is one flash loop for
// all four, the position term's form (POS) a template argument (K1's kPosNone
// has none: its instance runs `xl2_fwd_no_pos`, k and v staged without
// chunks, then the same back half): a block a (64-query tile, head, batch
// row), four warps of 16 rows (eight, 128 rows, for fp32 at D = 128 when that
// grid fills the card: at (8, 512, H=2) it would make 64 blocks for 132 SMs,
// so the launcher takes four warps there); a query tile's E-wide gA / gB rows
// (196 KB at 64 rows, E = 384, fp32) do not stay in shared memory but stream
// in 32-column chunks beside the key tile's table chunk, two stages deep; a
// key tile forms only the position terms its pairs select (K7: one pass, added
// at every key), and no (T, T) array reaches device memory. A block walks the
// key tiles up to its batch row's last live key only: in a row with a live
// key, m >= that key's logit, so a padded key's exp(MASK_NEG - m) is 0.0 in
// fp32 and the skip is exact (a row with no live key walks every tile: its
// weights are uniform over Tp); the serving paths pass ragged pad masks. K5
// first runs the rotation pass (xl_mma.cuh's `xl2_rotate_kernel`, K5 bwd-q's
// too) into a scratch gab (2, B, T, H, E) in the stream dtype that the wrapper
// allocates: sincosf once a pair, not once a key tile. Budget (ptxas -v,
// sm_90a, the CUDA toolkit of the H100 machine; blocks an SM = the least of
// what registers and shared memory allow; no spill; 16 more bytes of static
// shared memory for live_end):
//   dtype  D    warps  smem B    regs K5 / K6 / K7  blocks/SM
//   fp32   48   4       82,944   168 / 168 / -      2
//   fp32   64   4       95,232   202 / 202 / -      2
//   fp32   128  8      199,680   - / 254 / 185      1
//   fp32   128  4      144,384   - / 254 / 204      1
//   bf16   48   4       41,984   168 / 168 / -      3
//   bf16   64   4       48,128   168 / 168 / -      3
//   bf16   128  4       72,704   - / 254 / 168      2
//   rotation pass (256 threads): 28-29 registers, a 32-byte frame for
//   sincosf's slow path.
// K1 (POS = kPosNone, `xl2_fwd_no_pos`, four warps; no chunk stages, so K1
// at fp32, D = 128 fits two blocks an SM where K7 fits one):
//   dtype  D    smem B    regs  blocks/SM
//   fp32   32    29,696   128   4
//   fp32   64    54,272   128   4
//   fp32   128  103,424   168   2
//   bf16   32    15,360    96   5
//   bf16   64    27,648   128   4
//   bf16   128   52,224   168   3
// Eight warps a block for K1 (128 rows, one block an SM at fp32, D = 128)
// took 0.331 ms at the JETS call's (16, 1008) ragged shape and 0.431 with
// every row full, four 0.325 and 0.404 (tools/time_xl_fwd.py, H100): four.
// At the JETS training decoder (8, 512) K1's 128 four-warp blocks leave one
// block an SM, under one wave.
// K4 (`xl3_fwd_band_kernel`, four warps of 16 rows, every key of a tile
// each; no static shared memory):
//   dtype  D    smem B    regs  blocks/SM
//   fp32   48   102,624   200   2
//   fp32   64   127,264   212   1
//   bf16   48    60,528   128   3
//   bf16   64    72,848   128   3
// At fp32, D = 48 (the FS2 width) two blocks an SM fit both budgets; the
// eight-warp split of K4 bwd's ds kernel (each warp half the keys, two
// online-softmax states a row to merge) would forgo that and walk ~1.5x
// the band columns a pair.
// What bounds it, measured (H100, tools/time_xl_fwd.py): at D = 48 eight
// warps a block lost 12-32 % to four, three cp.async stages moved it <= 2 %,
// 16-column chunks (which spill under a three-block register cap) lost
// 10-75 %: not the loads' latency; like bwd-q, it reaches ~20-25 % of the
// 3xTF32 bound, and wgmma is its next step.
//
// Attention-weight dropout (training, dropout_p > 0) follows the JAX
// package's semantics: the softmax denominator takes the undropped weights,
// the context sums p * keep / (1 - p) * v. The keep bit of weight (i, j) is
// dropout_hash.cuh's keep(seed, b, h, i, j), which depends on no tile size,
// so the backward kernels (flash_xl_attention_bwd.cu; K1's in
// flash_attention_bwd.cu) draw the same bits with their own tilings. With
// dropout_p = 0 no bit is drawn.

#include "xl3_band.cuh"
#include "xl_mma.cuh"

namespace {

constexpr float kMaskNeg = -1.0e9f;

// ---------------------------------------------------------------------------
// the flash loop's back half, shared by K4 (xl3_fwd_band_kernel) and K5 /
// K6 / K7 (xl2_fwd_kernel)
// ---------------------------------------------------------------------------

// One 64-key tile in the accumulators' layout of a warp's 16 query rows
// (lane (g, t): rows qi[0] and qi[1] = qi[0] + 8, keys j0 + 8 ni + 2t and
// + 1 in s[ni][0..3]): s holds the tile's raw scores (qc k^T + pos). Keys
// past T weigh nothing (-inf), padded keys score MASK_NEG, the rest s *
// scale. The running max m_r and this lane's part of the denominator l_r
// (undropped) take the tile, o is rescaled, and o += p v with p =
// exp(logit - m) * keep / (1 - p), rounded to the stream dtype (the JAX
// `_mx`), as the A operand straight from the registers (xl_mma.cuh's
// permuted k order; frag_b_nn reads v's rows, ldv a row, in that order).
// Every tile holds a real key (logit >= MASK_NEG), so the max is finite.
template <bool SPLIT, typename T, int ND>
__device__ __forceinline__ void flash_tile_softmax_pv(
    float (&s)[8][4], float (&o)[ND][4], float (&m_r)[2], float (&l_r)[2],
    const T* VS, int ldv, const float* padb, int Tq, int j0, const int (&qi)[2],
    float scale, const DropArgs& drop, uint32_t drop_key, int lane) {
  const int t4 = lane & 3;
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kj = j0 + ni * 8 + 2 * t4 + (q & 1);
      float x;
      if (kj >= Tq)
        x = -INFINITY;
      else if (padb[kj] > 0.5f)
        x = kMaskNeg;
      else
        x = s[ni][q] * scale;
      s[ni][q] = x;
      mx[q >> 1] = fmaxf(mx[q >> 1], x);
    }
  float corr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    corr[hf] = expf(m_r[hf] - mx[hf]);
    m_r[hf] = mx[hf];
    l_r[hf] *= corr[hf];
  }
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float p = expf(s[ni][q] - mx[q >> 1]);
      l_r[q >> 1] += p;
      const int kj = j0 + ni * 8 + 2 * t4 + (q & 1);
      s[ni][q] = to_stream<T>(p * keep_scale(drop, drop_key, qi[q >> 1], kj));
    }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int q = 0; q < 4; ++q) o[nd][q] *= corr[q >> 1];
  // key step ni holds keys j0 + 8 ni + (2t, 2t+1) in slots (t, t+4) of the
  // A fragment
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    uint32_t ah[4], al[4];
    split_tf32<SPLIT>(s[ni][0], ah[0], al[0]);
    split_tf32<SPLIT>(s[ni][2], ah[1], al[1]);
    split_tf32<SPLIT>(s[ni][1], ah[2], al[2]);
    split_tf32<SPLIT>(s[ni][3], ah[3], al[3]);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      uint32_t bh[2], bl[2];
      frag_b_nn<SPLIT>(VS, ldv, nd * 8, ni * 8, lane, bh, bl);
      mma3<SPLIT>(o[nd], ah, al, bh, bl);
    }
  }
}

// The flash loop's end: each row's denominator summed over its quad, plus
// n_tail virtual keys (logit MASK_NEG, v = 0: K5 / K6 / K7's Tp - T tail;
// K4 has none), ctx = o / l into orow + qi * rs (fp32) and lse = m + log l
// into lse_row[qi], for the rows below T.
template <int ND>
__device__ __forceinline__ void flash_finish(const float (&o)[ND][4], const float (&m_r)[2],
                                             float (&l_r)[2], int n_tail, float* out,
                                             size_t rs, float* lse_row, const int (&qi)[2],
                                             int Tq, int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l_r[hf] += __shfl_xor_sync(0xffffffffu, l_r[hf], 1);
    l_r[hf] += __shfl_xor_sync(0xffffffffu, l_r[hf], 2);
    if (qi[hf] >= Tq) continue;
    const float m = m_r[hf];
    const float l = l_r[hf] + (float)n_tail * expf(kMaskNeg - m);
    const float inv = l > 0.f ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    float* orow = out + (size_t)qi[hf] * rs + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<float2*>(orow + nd * 8) =
          make_float2(o[nd][2 * hf] * inv, o[nd][2 * hf + 1] * inv);
    if (t4 == 0) lse_row[qi[hf]] = m + logf(fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// K4 on the tensor cores: the band-form logits of xl3_band.cuh (shared with
// K4 bwd's ds kernel), then the flash back half above
// ---------------------------------------------------------------------------

constexpr int kX3FwdThreads = 128;  // four warps of 16 query rows, every key each
constexpr int kX3FwdLDW = kX3 + 4;  // W's row pitch (fp32): the tile's 64 keys

template <typename T, int D>
constexpr size_t xl3_fwd_smem_bytes() {
  // QC (64, D), QV (65, D), KS (64, D) and the band of p (128, D) read by
  // fragment loads, VS (64, D) read down its rows, all in the stream
  // dtype; W (64, 64) fp32, the sheared position logits
  return sizeof(T) * ((3 * kX3 + 1 + kX3Band) * tile_ld(D) + kX3 * tile_ld_nn<T, D>()) +
         sizeof(float) * kX3 * kX3FwdLDW;
}

// One block a (64-query tile qt, head, batch row), four warps: warp w owns
// query rows 16w .. 16w + 15 and every key of each 64-key tile kt it
// walks. qc and qv (65 rows: the future term reads qv_{i+1}) are staged
// once; k and the band of p (xl3_stage_band) are one cp.async group, v a
// second, each in flight during the other half of the previous tile. Per
// key tile: the position logits of the warp's pairs as band products
// (xl3_band_logits: qv band^T over the past columns, qv_{+1} band^T over
// the future ones, only the band columns its rows reach), sheared into the
// warp's rows of W; s = W + qc k^T on the tensor cores; then the online
// softmax, the keep bits and p v in registers (flash_tile_softmax_pv). Keys
// past T are never formed (the reference scores them 2 MASK_NEG: weight
// exactly 0), so a row whose keys are all padding averages v over the T
// real keys, with lse = MASK_NEG + log T, as the plain version.
template <typename T, int D>
__global__ void __launch_bounds__(kX3FwdThreads)
    xl3_fwd_band_kernel(const T* __restrict__ qc, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ qv,
                        const T* __restrict__ p, const float* __restrict__ pad,
                        float* __restrict__ out, float* __restrict__ lse, int H,
                        int Tq, float scale, DropArgs drop) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int NT = kX3FwdThreads;
  constexpr int LD = tile_ld(D);
  constexpr int LDV = tile_ld_nn<T, D>();
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* QC = reinterpret_cast<T*>(smem_raw);
  T* QV = QC + kX3 * LD;  // rows i0 .. i0 + 64
  T* KS = QV + (kX3 + 1) * LD;
  T* BC = KS + kX3 * LD;  // the band of p, kX3Band rows
  T* VS = BC + kX3Band * LD;
  float* W = reinterpret_cast<float*>(VS + kX3 * LDV);  // (64, kX3FwdLDW)

  const int qt = blockIdx.x, i0 = qt * kX3, h = blockIdx.y, b = blockIdx.z;
  const int nt = (Tq + kX3 - 1) / kX3;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * Tq * rs + (size_t)h * D;
  const float* padb = pad + (size_t)b * Tq;
  const uint32_t drop_key = vt_dropout_key(drop.seed, b, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;  // the warp's rows of the tile
  const int qi[2] = {i0 + r0 + g4, i0 + r0 + g4 + 8};

  cp_tile<T, kX3, D, NT>(QC, LD, qc + base, rs, i0, Tq, 0);
  cp_tile<T, kX3 + 1, D, NT>(QV, LD, qv + base, rs, i0, Tq, 0);
  cp_tile<T, kX3, D, NT>(KS, LD, k + base, rs, 0, Tq, 0);
  xl3_stage_band<T, D, NT>(BC, p, H, h, Tq, 0, qt);
  cp_async_commit();
  cp_tile<T, kX3, D, NT>(VS, LDV, v + base, rs, 0, Tq, 0);
  cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nd][c] = 0.f;
  // running max and this lane's part of the denominator, rows g4, g4 + 8
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  for (int kt = 0; kt < nt; ++kt) {
    const int j0 = kt * kX3;
    cp_async_wait<1>();
    __syncthreads();  // tile kt's k and band have landed (its v may not have)

    xl3_band_logits<SPLIT, T, D, kX3>(QV, BC, W, kX3FwdLDW, r0, 0, xl3_u_split(kt, qt),
                                      lane);
    __syncwarp();
    float s[8][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* row = W + (r0 + g4 + 8 * hf) * kX3FwdLDW + 2 * t4;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const float2 p2 = *reinterpret_cast<const float2*>(row + ni * 8);
        s[ni][2 * hf] = p2.x;
        s[ni][2 * hf + 1] = p2.y;
      }
    }
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 8) {
      uint32_t ah[4], al[4];
      frag_a<SPLIT>(QC, LD, r0, k0, lane, ah, al);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        uint32_t bh[2], bl[2];
        frag_b_nt<SPLIT>(KS, LD, ni * 8, k0, lane, bh, bl);
        mma3<SPLIT>(s[ni], ah, al, bh, bl);
      }
    }

    __syncthreads();  // every warp has read this tile's k and band
    if (kt + 1 < nt) {
      cp_tile<T, kX3, D, NT>(KS, LD, k + base, rs, j0 + kX3, Tq, 0);
      xl3_stage_band<T, D, NT>(BC, p, H, h, Tq, kt + 1, qt);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile kt's v has landed

    flash_tile_softmax_pv<SPLIT, T, ND>(s, o, m_r, l_r, VS, LDV, padb, Tq, j0, qi, scale,
                                        drop, drop_key, lane);

    __syncthreads();  // every warp is past this tile's p v
    if (kt + 1 < nt) cp_tile<T, kX3, D, NT>(VS, LDV, v + base, rs, j0 + kX3, Tq, 0);
    cp_async_commit();
  }
  flash_finish<ND>(o, m_r, l_r, 0, out + base, rs, lse + ((size_t)b * H + h) * Tq, qi, Tq,
                   lane);
}

// ---------------------------------------------------------------------------
// K5 and K6 on the tensor cores (K5 after the rotation pass)
// ---------------------------------------------------------------------------

constexpr int kFBK = 64;  // keys a tile
constexpr int kFKC = 32;  // E columns a chunk of the position product

// Warps a block, each 16 query rows: eight for fp32 at D = 128 with a
// position term, where a block's shared memory lets one block onto an SM,
// so that it runs eight warps and not four; four elsewhere (two blocks an
// SM; K1 at fp32, D = 128 too, whose block holds no chunk stages). The
// launcher also takes four at fp32, D = 128 when eight would leave SMs
// idle.
template <typename T, int D, int POS>
constexpr int xl2_fwd_warps() {
  return POS != kPosNone && sizeof(T) == 4 && D == 128 ? 8 : 4;
}

template <typename T, int D, int POS, int NW>
constexpr size_t xl2_fwd_smem_bytes() {
  // QC (BQ, D), KS (64, D) read by 64-bit fragment loads, VS (64, D) read
  // down its rows, and, with a position term, two stages of a chunk: the
  // stream's (BQ, 32) and the table's (64, 32). Independent of E.
  constexpr int BQ = 16 * NW;
  return sizeof(T) * ((BQ + kFBK) * tile_ld(D) + kFBK * tile_ld_nn<T, D>() +
                      (POS == kPosNone ? 0 : 2 * (BQ + kFBK) * tile_ld(kFKC)));
}

// One past the last live key (pad <= 0.5) of a batch row, or Tq when the
// row has none: its weights are uniform over every key, so every tile is
// walked. Block-wide; every thread calls it.
__device__ __forceinline__ int live_end(const float* padb, int Tq) {
  __shared__ int end_s;
  if (threadIdx.x == 0) end_s = 0;
  __syncthreads();
  int end = 0;
  for (int j = Tq - 1 - (int)threadIdx.x; j >= 0; j -= (int)blockDim.x)
    if (padb[j] <= 0.5f) {
      end = j + 1;
      break;
    }
  if (end > 0) atomicMax(&end_s, end);
  __syncthreads();
  return end_s > 0 ? end_s : Tq;
}

// K1 (xl2_fwd_kernel's POS = kPosNone): a block a (16 NW-query tile, head,
// batch row), warp w owning query rows 16w .. 16w + 15, walking the 64-key
// tiles up to the batch row's last live key (`live_end`). Per key tile:
// s = q k^T, then the online softmax, the keep bits and p v
// (flash_tile_softmax_pv), as the position kinds do after their position
// term. k and v each ride a cp.async group of their own (K4's pipeline):
// the next tile's k is in flight during this tile's p v, the next tile's v
// during its q k^T; one buffer each, so that at fp32, D = 128 two
// four-warp blocks fit an SM (two stages of each would leave room for one).
template <typename T, int D, int NW>
__device__ __forceinline__ void xl2_fwd_no_pos(const T* __restrict__ q, const T* __restrict__ k,
                                               const T* __restrict__ v,
                                               const float* __restrict__ pad,
                                               float* __restrict__ out, float* __restrict__ lse,
                                               int H, int Tq, int Tp, float scale,
                                               DropArgs drop) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int BQ = 16 * NW, NT = 32 * NW;
  constexpr int LD = tile_ld(D);
  constexpr int LDV = tile_ld_nn<T, D>();
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* QC = reinterpret_cast<T*>(smem_raw);
  T* KS = QC + BQ * LD;
  T* VS = KS + kFBK * LD;

  const int i0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * Tq * rs + (size_t)h * D;
  const float* padb = pad + (size_t)b * Tq;
  const uint32_t drop_key = vt_dropout_key(drop.seed, b, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;  // the warp's rows of the tile
  const int qi[2] = {i0 + r0 + (lane >> 2), i0 + r0 + (lane >> 2) + 8};
  const int n_tiles = (live_end(padb, Tq) + kFBK - 1) / kFBK;

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nd][c] = 0.f;
  // running max and this lane's part of the denominator, rows qi[0], qi[1]
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  cp_tile<T, BQ, D, NT>(QC, LD, q + base, rs, i0, Tq, 0);
  cp_tile<T, kFBK, D, NT>(KS, LD, k + base, rs, 0, Tq, 0);
  cp_async_commit();
  cp_tile<T, kFBK, D, NT>(VS, LDV, v + base, rs, 0, Tq, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int j0 = kt * kFBK;
    cp_async_wait<1>();
    __syncthreads();  // tile kt's k has landed (its v may not have)
    float s[8][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[ni][c] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 8) {
      uint32_t ah[4], al[4];
      frag_a<SPLIT>(QC, LD, r0, k0, lane, ah, al);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        uint32_t bh[2], bl[2];
        frag_b_nt<SPLIT>(KS, LD, ni * 8, k0, lane, bh, bl);
        mma3<SPLIT>(s[ni], ah, al, bh, bl);
      }
    }
    __syncthreads();  // every warp has read this tile's k
    if (kt + 1 < n_tiles) cp_tile<T, kFBK, D, NT>(KS, LD, k + base, rs, j0 + kFBK, Tq, 0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile kt's v has landed
    flash_tile_softmax_pv<SPLIT, T, ND>(s, o, m_r, l_r, VS, LDV, padb, Tq, j0, qi, scale,
                                        drop, drop_key, lane);
    __syncthreads();  // every warp is past this tile's p v
    if (kt + 1 < n_tiles) cp_tile<T, kFBK, D, NT>(VS, LDV, v + base, rs, j0 + kFBK, Tq, 0);
    cp_async_commit();
  }
  flash_finish<ND>(o, m_r, l_r, Tp - Tq, out + base, rs, lse + ((size_t)b * H + h) * Tq, qi,
                   Tq, lane);
}

// One block a (16 NW-query tile, head, batch row); warp w owns query rows
// 16w .. 16w + 15 of the tile and walks the 64-key tiles up to the batch
// row's last live key (`live_end`). Per key tile (K5 / K6):
// s = qc k^T, then the position term, gA t^T where some j <= i and gB t^T
// where some j >= i + 2, each over E in 32-column chunks of the stream and
// the table, into a second accumulator that is added into s where its
// select holds (a tile wholly in the past forms only gA t^T, one wholly in
// the future only gB t^T; a tile across the diagonal both, one after the
// other); then the online softmax in the accumulator layout (row max and
// sum over the quad's four lanes), the keep bits, and o += p v with p as
// the A operand straight from the registers (the permuted k order of
// xl_mma.cuh). The chunks stream by cp.async two stages deep across the
// key tiles; k (the next tile's, once every warp has read this one's) and
// v (this tile's, once every warp is past the last p v) ride in the
// chunks' groups. K7 (POS = kPosRel) forms one pass of g t^T a key tile,
// straight into s, added at every key. K5 and K6 run one body (kPosXlRot
// only names K5's instance: its streams come from the rotation pass).
// K1's instance (POS = kPosNone) runs xl2_fwd_no_pos, above.
template <typename T, int D, int POS, int NW>
__global__ void __launch_bounds__(32 * NW)
    xl2_fwd_kernel(const T* __restrict__ qc, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ ga,
                   const T* __restrict__ gb, const T* __restrict__ table,
                   const float* __restrict__ pad, float* __restrict__ out,
                   float* __restrict__ lse, int H, int Tq, int Tp, int E,
                   float scale, DropArgs drop) {
  if constexpr (POS == kPosNone) {
    xl2_fwd_no_pos<T, D, NW>(qc, k, v, pad, out, lse, H, Tq, Tp, scale, drop);
    return;
  }
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr bool REL = POS == kPosRel;
  constexpr int BQ = 16 * NW, NT = 32 * NW;
  constexpr int LD = tile_ld(D);
  constexpr int LDV = tile_ld_nn<T, D>();
  constexpr int LDC = tile_ld(kFKC);
  constexpr int CA = BQ * LDC;    // a chunk's stream tile
  constexpr int CB = kFBK * LDC;  // ... and its table tile
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* QC = reinterpret_cast<T*>(smem_raw);
  T* KS = QC + BQ * LD;
  T* VS = KS + kFBK * LD;
  T* CS = VS + kFBK * LDV;  // [stage][stream chunk, table chunk]

  const int i0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * Tq * rs + (size_t)h * D;
  const size_t rse = (size_t)H * E;
  const size_t base_e = (size_t)b * Tq * rse + (size_t)h * E;
  const float* padb = pad + (size_t)b * Tq;
  const uint32_t drop_key = vt_dropout_key(drop.seed, b, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;  // the warp's rows of the tile
  const int qi[2] = {i0 + r0 + g4, i0 + r0 + g4 + 8};
  const int n_tiles = (live_end(padb, Tq) + kFBK - 1) / kFBK;
  const int n_ch = E / kFKC;

  // the position terms key tile j0 needs, each a pass of n_ch chunks (K7:
  // one, read from ga)
  auto has_past = [&](int j0) { return REL || j0 <= i0 + BQ - 1; };
  auto has_fut = [&](int j0) { return !REL && j0 + kFBK - 1 >= i0 + 2; };
  auto n_chunks = [&](int kt) {
    return (has_past(kt * kFBK) + has_fut(kt * kFBK)) * n_ch;
  };
  // the next chunk to stage: chunk lc of key tile lkt (the past pass first)
  int lkt = 0, lc = 0;
  auto stage_next = [&](int stage) {
    if (lkt >= n_tiles) return;
    const int j0 = lkt * kFBK;
    const bool past = lc < n_ch && has_past(j0);
    const int e0 = (lc % n_ch) * kFKC;
    T* dst = CS + stage * (CA + CB);
    cp_tile<T, BQ, kFKC, NT>(dst, LDC, (REL || past ? ga : gb) + base_e, rse, i0,
                             Tq, e0);
    cp_tile<T, kFBK, kFKC, NT>(dst + CA, LDC, table, E, j0, Tq, e0);
    if (++lc == n_chunks(lkt)) {
      lc = 0;
      ++lkt;
    }
  };

  cp_tile<T, BQ, D, NT>(QC, LD, qc + base, rs, i0, Tq, 0);
  cp_tile<T, kFBK, D, NT>(KS, LD, k + base, rs, 0, Tq, 0);
  cp_tile<T, kFBK, D, NT>(VS, LDV, v + base, rs, 0, Tq, 0);
  stage_next(0);
  cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nd][c] = 0.f;
  // running max and this lane's part of the denominator, rows g4, g4 + 8
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  int st = 0;  // the stage of the chunk in hand

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int j0 = kt * kFBK;
    const bool past = has_past(j0);
    const int nc = n_chunks(kt);
    float s[8][4], acc[8][4];
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<0>();
      __syncthreads();  // chunk c has landed; the other stage is free
      stage_next(st ^ 1);
      if (c == 0 && kt > 0)  // every warp is past tile kt - 1's p v
        cp_tile<T, kFBK, D, NT>(VS, LDV, v + base, rs, j0, Tq, 0);
      if (c == 1 && kt + 1 < n_tiles)  // every warp has read this tile's k
        cp_tile<T, kFBK, D, NT>(KS, LD, k + base, rs, j0 + kFBK, Tq, 0);
      cp_async_commit();

      if (c == 0) {
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[ni][q] = 0.f;
#pragma unroll
        for (int k0 = 0; k0 < D; k0 += 8) {
          uint32_t ah[4], al[4];
          frag_a<SPLIT>(QC, LD, r0, k0, lane, ah, al);
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            uint32_t bh[2], bl[2];
            frag_b_nt<SPLIT>(KS, LD, ni * 8, k0, lane, bh, bl);
            mma3<SPLIT>(s[ni], ah, al, bh, bl);
          }
        }
      }
      const int cc = c % n_ch;
      if (!REL && cc == 0) {
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[ni][q] = 0.f;
      }
      const T* A = CS + st * (CA + CB);
#pragma unroll
      for (int k0 = 0; k0 < kFKC; k0 += 8) {
        uint32_t ah[4], al[4];
        frag_a<SPLIT>(A, LDC, r0, k0, lane, ah, al);
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          uint32_t bh[2], bl[2];
          frag_b_nt<SPLIT>(A + CA, LDC, ni * 8, k0, lane, bh, bl);
          mma3<SPLIT>(REL ? s[ni] : acc[ni], ah, al, bh, bl);
        }
      }
      if (!REL && cc == n_ch - 1) {  // a term is complete: add it where it selects
        const bool is_past = past && c < n_ch;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int kj = j0 + ni * 8 + 2 * t4 + (q & 1), i = qi[q >> 1];
            if (is_past ? kj <= i : kj >= i + 2) s[ni][q] += acc[ni][q];
          }
      }
      st ^= 1;
    }

    // the logits, the online softmax and p v; keys past T weigh nothing
    // (the Tp - T tail is added at the end)
    flash_tile_softmax_pv<SPLIT, T, ND>(s, o, m_r, l_r, VS, LDV, padb, Tq, j0, qi, scale,
                                        drop, drop_key, lane);
  }
  flash_finish<ND>(o, m_r, l_r, Tp - Tq, out + base, rs, lse + ((size_t)b * H + h) * Tq, qi,
                   Tq, lane);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_xl3_fwd(const void* qc, const void* k, const void* v,
                           const void* qv, const void* p, const float* pad,
                           float* out, float* lse, int B, int Tq, int H,
                           float scale, DropArgs drop, cudaStream_t stream) {
  constexpr size_t smem = xl3_fwd_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      xl3_fwd_band_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  xl3_fwd_band_kernel<T, D>
      <<<dim3((Tq + kX3 - 1) / kX3, H, B), kX3FwdThreads, smem, stream>>>(
          static_cast<const T*>(qc), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(qv),
          static_cast<const T*>(p), pad, out, lse, H, Tq, scale, drop);
  return cudaGetLastError();
}

// The SMs of the current card (cached).
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n <= 0)
      n = 132;  // the H100 SXM's
  }
  return n;
}

// One xl2_fwd_kernel launch of NW warps a block.
template <typename T, int D, int POS, int NW>
cudaError_t launch_xl2_fwd(const T* qc, const T* k, const T* v, const T* ga,
                           const T* gb, const T* table, const float* pad,
                           float* out, float* lse, int B, int Tq, int Tp, int H,
                           int E, float scale, DropArgs drop,
                           cudaStream_t stream) {
  constexpr size_t smem = xl2_fwd_smem_bytes<T, D, POS, NW>();
  cudaError_t err = cudaFuncSetAttribute(
      xl2_fwd_kernel<T, D, POS, NW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int BQ = 16 * NW;
  xl2_fwd_kernel<T, D, POS, NW>
      <<<dim3((Tq + BQ - 1) / BQ, H, B), 32 * NW, smem, stream>>>(
          qc, k, v, ga, gb, table, pad, out, lse, H, Tq, Tp, E, scale, drop);
  return cudaGetLastError();
}

// K5 (kPosXlRot): the rotation pass writes gA, gB into gab (2, B, T, H, E),
// then the kernel reads them; K6: the kernel reads ga, gb; K7: ga is g, gb
// unused; K1 (kPosNone): no ga, gb, table (E unused). Eight warps a block
// where xl2_fwd_warps says so and that grid covers the card's SMs, else
// four.
template <typename T, int D, int POS>
cudaError_t launch_xl2(const void* qc, const void* k, const void* v,
                       const void* ga, const void* gb, const void* table,
                       void* gab, const float* pad, float* out, float* lse,
                       int B, int Tq, int Tp, int H, int E, float scale,
                       DropArgs drop, cudaStream_t stream) {
  const T* GA = static_cast<const T*>(ga);
  const T* GB = static_cast<const T*>(gb);
  if constexpr (POS == kPosXlRot) {
    T* ra = static_cast<T*>(gab);
    T* rb = ra + (size_t)B * Tq * H * E;
    cudaError_t err = launch_xl2_rotate<T>(GA, ra, rb, B, H, Tq, E, stream);
    if (err != cudaSuccess) return err;
    GA = ra;
    GB = rb;
  }
#define VT_XL2_NW(NW)                                                         \
  launch_xl2_fwd<T, D, POS, NW>(                                              \
      static_cast<const T*>(qc), static_cast<const T*>(k),                    \
      static_cast<const T*>(v), GA, GB, static_cast<const T*>(table), pad,    \
      out, lse, B, Tq, Tp, H, E, scale, drop, stream)
  constexpr int NW = xl2_fwd_warps<T, D, POS>();
  if constexpr (NW > 4) {
    const long long wide = (long long)((Tq + 16 * NW - 1) / (16 * NW)) * H * B;
    if (wide < sm_count()) return VT_XL2_NW(4);
  }
  return VT_XL2_NW(NW);
#undef VT_XL2_NW
}

bool bad_sizes(int B, int T, int H, double dropout_p) {
  return B <= 0 || H <= 0 || T <= 0 || B >= 65536 || H >= 65536 ||
         T >= 65536 || !(dropout_p >= 0.0 && dropout_p < 1.0);
}

// K5 and K6 at D in {48, 64} (K6 also 128); K7 at D = 128 only.
template <int POS>
int xl2_entry(const void* qc, const void* k, const void* v, const void* ga,
              const void* gb, const void* table, void* gab, const float* pad,
              float* out, float* lse, int B, int T, int Tp, int H, int D, int E,
              int is_bf16, float scale, double dropout_p, uint64_t seed,
              void* stream) {
  // E in whole 64-column steps (the chunks' 32 and the rotation's pairs)
  if (bad_sizes(B, T, H, dropout_p) || Tp < T || E <= 0 || E % 64 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropArgs drop = drop_args(dropout_p, seed);
#define VT_XL2(TYPE, DIM)                                                  \
  launch_xl2<TYPE, DIM, POS>(qc, k, v, ga, gb, table, gab, pad, out, lse, \
                             B, T, Tp, H, E, scale, drop, s)
  if constexpr (POS != kPosRel) {
    switch (D * 2 + (is_bf16 ? 1 : 0)) {
      case 96: return (int)VT_XL2(float, 48);
      case 97: return (int)VT_XL2(__nv_bfloat16, 48);
      case 128: return (int)VT_XL2(float, 64);
      case 129: return (int)VT_XL2(__nv_bfloat16, 64);
      default: break;
    }
  }
  // D = 128 (the JETS conformer, E = 256): K6 (the legacy rel-pos flavour)
  // and K7 (the latest)
  if constexpr (POS != kPosXlRot) {
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

// K1. q, k, v: (B, T, H, D) contiguous, fp32 (is_bf16 = 0) or bf16
// (is_bf16 = 1), D in {32, 64, 128}. pad: (B, T) fp32, 1.0 at padding keys.
// Tp >= T: keys in [T, Tp) are treated as zero rows with pad = 1. out:
// (B, T, H, D) fp32. lse: (B, H, T) fp32. dropout_p in [0, 1):
// attention-weight dropout keyed by `seed` (dropout_hash.cuh; B, H and T
// below 2^16). Returns the launch's cudaError_t (0 = success).
int vt_flash_attn_fwd(const void* q, const void* k, const void* v,
                      const float* pad, float* out, float* lse, int B, int T,
                      int Tp, int H, int D, int is_bf16, float scale,
                      double dropout_p, uint64_t seed, void* stream) {
  if (bad_sizes(B, T, H, dropout_p) || Tp < T) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropArgs drop = drop_args(dropout_p, seed);
#define VT_K1(TYPE, DIM)                                                       \
  launch_xl2<TYPE, DIM, kPosNone>(q, k, v, nullptr, nullptr, nullptr, nullptr, \
                                  pad, out, lse, B, T, Tp, H, 0, scale, drop, s)
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 64: return (int)VT_K1(float, 32);
    case 65: return (int)VT_K1(__nv_bfloat16, 32);
    case 128: return (int)VT_K1(float, 64);
    case 129: return (int)VT_K1(__nv_bfloat16, 64);
    case 256: return (int)VT_K1(float, 128);
    case 257: return (int)VT_K1(__nv_bfloat16, 128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VT_K1
}

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
#define VT_XL3(TYPE, DIM)                                                       \
  launch_xl3_fwd<TYPE, DIM>(qc, k, v, qv, p, pad, out, lse, B, T, H, scale, drop, \
                            s)
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
// 64. Scratch: gab (2, B, T, H, E) in the stream dtype (the rotated gA,
// gB). Other arguments as K4. Returns the first cudaError_t of the two
// launches.
int vt_flash_xl2_fwd(const void* qc, const void* k, const void* v,
                     const void* g, const void* table, void* gab,
                     const float* pad, float* out, float* lse, int B, int T,
                     int Tp, int H, int D, int E, int is_bf16, float scale,
                     double dropout_p, uint64_t seed, void* stream) {
  return xl2_entry<kPosXlRot>(qc, k, v, g, nullptr, table, gab, pad, out, lse,
                              B, T, Tp, H, D, E, is_bf16, scale, dropout_p,
                              seed, stream);
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
  return xl2_entry<kPosXl>(qc, k, v, ga, gb, table, nullptr, pad, out, lse, B,
                           T, Tp, H, D, E, is_bf16, scale, dropout_p, seed,
                           stream);
}

// K7. qc, k, v: (B, T, H, D); g: (B, T, H, E) the pre-rotated position
// queries; table: (T, E) the negative half of the symmetric table; all one
// dtype. D = 128 (the JETS width), E a multiple of 64. Other arguments as
// K5 (Tp >= T, the keys in [T, Tp) padded zero rows). Returns the
// cudaError_t.
int vt_flash_rel_fwd(const void* qc, const void* k, const void* v,
                     const void* g, const void* table, const float* pad,
                     float* out, float* lse, int B, int T, int Tp, int H,
                     int D, int E, int is_bf16, float scale, double dropout_p,
                     uint64_t seed, void* stream) {
  return xl2_entry<kPosRel>(qc, k, v, g, nullptr, table, nullptr, pad, out, lse,
                            B, T, Tp, H, D, E, is_bf16, scale, dropout_p, seed,
                            stream);
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
