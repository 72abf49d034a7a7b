// Kernel K2: one HiFi-GAN multi-receptive-field (MRF) resblock stage, for
// Hopper (sm_90a). Inference only.
//
// Replaces the TPU kernel viet_tts_tpu/ops/pallas_vocoder.py
// `fused_mrf_stage` (body `_make_kernel` / `_conv_tap_packed`). Same
// function: for each block (k = 3, 7, 11) and each dilation d (1, 3, 5),
//   h += conv_{k,1}(leaky(conv_{k,d}(leaky(h))))
// with zeros re-imposed outside [0, seq_len) after every conv; the stage
// output is the mean of the blocks' h.
//
// What bounds it on the H100: 252 * B * T * C^2 FLOP a stage at the default
// MRF (two k-tap convs per (block, dilation), k summing to 21) against a
// stage input and output of 8 bytes per (B, T, C) element: 31.5 * C, about
// 2,000 FLOP per byte at C = 64, so it is bound by operations. fp32 streams
// need three TF32 products a term (3xTF32: one TF32 product misses the fp32
// limit of 1e-4 by 10x, tests/test_torch_mrf_precision.py), so the bound is
// 3 * FLOP / 495 TFLOP/s on the tensor cores.
//
// Design: the TPU kernel keeps a whole 1144-row time tile and all 18 convs'
// weights (2 MB at C = 64) resident in VMEM. A Hopper block has 227 KB of
// shared memory, so here one launch runs one (block, dilation) pair, both
// convs, with conv1's output kept in shared memory:
// - a block owns S = TT - 2 * pad2 output rows (TT = 16384 / C: 256 rows at
//   C = 64, 512 at C = 32) and stages a window of TT + 2 * pad1 rows of the
//   pair's input by cp.async, zeroed outside [0, seq_len), then applies
//   leaky in place (pad1 = (k - 1) / 2 * d, pad2 = (k - 1) / 2);
// - conv1 is an implicit GEMM on that window: M = TT rows of y (the S
//   output rows and pad2 halo rows each side), N = C, K = C a tap, the A
//   tile of tap j the window shifted by j * d rows; its accumulators stay in
//   registers until the last tap, then y = leaky(mask(acc + bias1)) is
//   written over the window (which no warp reads any more);
// - conv2 is the same GEMM on y (shift j rows a tap); of its TT rows the
//   first S are the block's outputs (the last 2 * pad2 read past y's rows
//   and are dropped); the epilogue fuses bias2, the mask, the residual add
//   and the running block mean.
// Every product is mma.sync.m16n8k8 TF32 in 3xTF32 (xl_mma.cuh). The
// weights are split into TF32 hi / lo once, by the wrapper, and packed in
// fragment order (ops/fused_mrf.py:pack_weights): a lane's B fragment, hi
// and lo, is one 16-byte shared-memory load. Each tap (C x C, 32 KB hi + lo
// at C = 64) streams through a two-stage cp.async ring, the next tap in
// flight while the current one multiplies; the two convs' 2k taps are one
// stream. The activations stay fp32 in shared memory (half the bytes of a
// hi / lo copy, which would not fit beside the ring at TT = 256) and are
// split at the fragment load; each A fragment feeds C / 8 n-tiles x 3
// products. Eight warps, each 16 * (128 / C) rows by all C columns (64
// accumulators a thread). Shared memory at C = 64, k = 11, d = 5: a 306-row
// window (88 KB) + two taps (64 KB), one block an SM; at C = 32, 104 KB,
// two blocks an SM. A stage is 9 launches (one a pair) on two ping-pong
// (B, T, C) scratches and the output; y never leaves shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "xl_mma.cuh"

namespace {

constexpr int kMrfWarps = 8;
constexpr int kMrfThreads = 32 * kMrfWarps;

// m-tiles (16 rows) a warp holds: MT x C / 8 n-tiles = 64 accumulators
__host__ __device__ constexpr int mrf_mt(int C) { return 128 / C; }
// rows of conv1's y tile and of conv2's computed rows: 16384 / C
__host__ __device__ constexpr int mrf_tile(int C) {
  return kMrfWarps * 16 * mrf_mt(C);
}
// floats of one packed tap: (C / 8)^2 fragments x 32 lanes x (hi, hi, lo, lo)
__host__ __device__ constexpr int mrf_tap_floats(int C) { return 2 * C * C; }

size_t mrf_smem_bytes(int C, int pad1) {
  return sizeof(float) * ((size_t)(mrf_tile(C) + 2 * pad1) * tile_ld(C) +
                          2 * (size_t)mrf_tap_floats(C));
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : slope * x;
}

template <int C>
__device__ __forceinline__ void stage_tap(float* dst, const float* src) {
  constexpr int N16 = mrf_tap_floats(C) / 4;
  for (int i = threadIdx.x; i < N16; i += kMrfThreads)
    cp_async16(dst + 4 * i, src + 4 * i, 16);
}

// one block an SM at C = 64 (shared memory), two below (128 registers)
template <int C>
__global__ void __launch_bounds__(kMrfThreads, C == 64 ? 1 : 2)
    mrf_pair_kernel(const float* __restrict__ src, const float* __restrict__ wp,
                    const float* __restrict__ b1, const float* __restrict__ b2,
                    float* __restrict__ hout, const float* accin,
                    float* accout, float acc_div, int T, int seq_len, int K,
                    int dil, float slope) {
  constexpr int MT = mrf_mt(C), NT = C / 8, TT = mrf_tile(C);
  constexpr int LD = tile_ld(C), TAP = mrf_tap_floats(C), PER_ROW = C / 4;
  extern __shared__ __align__(16) float smem[];
  const int p1 = (K - 1) / 2 * dil, p2 = (K - 1) / 2;
  const int rows = TT + 2 * p1;
  float* X = smem;              // (rows, LD): leaky(window), then leaky(y)
  float* Wb = X + rows * LD;    // two packed taps
  const int S = TT - 2 * p2;    // output rows of this block
  const int b = blockIdx.y;
  const int o0 = blockIdx.x * S;
  const float* srcb = src + (size_t)b * T * C;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = (tid >> 5) * 16 * MT;  // the warp's first row

  // window row w is time o0 - p2 - p1 + w
  const int tw0 = o0 - p2 - p1;
  for (int i = tid; i < rows * PER_ROW; i += kMrfThreads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    const int t = tw0 + r;
    const bool in = t >= 0 && t < seq_len;
    cp_async16(X + r * LD + c, in ? srcb + (size_t)t * C + c : srcb,
               in ? 16 : 0);
  }
  stage_tap<C>(Wb, wp);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < rows * PER_ROW; i += kMrfThreads) {
    float4* p = reinterpret_cast<float4*>(X + (i / PER_ROW) * LD +
                                          (i % PER_ROW) * 4);
    float4 v = *p;
    v.x = leaky(v.x, slope);
    v.y = leaky(v.y, slope);
    v.z = leaky(v.z, slope);
    v.w = leaky(v.w, slope);
    *p = v;
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // taps 0 .. K - 1 are conv1's, K .. 2K - 1 conv2's
  const int ntaps = 2 * K;
  for (int j = 0; j < ntaps; ++j) {
    cp_async_wait<0>();
    // tap j has landed for every thread; no warp reads tap j - 1's buffer
    // (nor, at j == K, the window) any more
    __syncthreads();
    if (j + 1 < ntaps) {
      stage_tap<C>(Wb + ((j + 1) & 1) * TAP, wp + (size_t)(j + 1) * TAP);
      cp_async_commit();
    }
    if (j == K) {
      // conv1 done: y row r (time o0 - p2 + r) = leaky(mask(acc + b1))
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + 16 * mt + g + 8 * hf;
          const int ty = o0 - p2 + r;
          const bool valid = ty >= 0 && ty < seq_len;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int c = 8 * nt + 2 * t4;
            float2 y;
            y.x = valid ? leaky(acc[mt][nt][2 * hf] + b1[c], slope) : 0.f;
            y.y = valid ? leaky(acc[mt][nt][2 * hf + 1] + b1[c + 1], slope)
                        : 0.f;
            *reinterpret_cast<float2*>(X + r * LD + c) = y;
            acc[mt][nt][2 * hf] = 0.f;
            acc[mt][nt][2 * hf + 1] = 0.f;
          }
        }
      __syncthreads();
    }
    const float* A = X + (j < K ? j * dil : j - K) * LD;
    const float* Wt = Wb + (j & 1) * TAP;
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        frag_a<true>(A, LD, r0 + 16 * mt, 8 * ks, lane, ah[mt], al[mt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float4 w = *reinterpret_cast<const float4*>(
            Wt + ((ks * NT + nt) * 32 + lane) * 4);
        const uint32_t bh[2] = {__float_as_uint(w.x), __float_as_uint(w.y)};
        const uint32_t bl[2] = {__float_as_uint(w.z), __float_as_uint(w.w)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3<true>(acc[mt][nt], ah[mt], al[mt], bh, bl);
      }
    }
  }

  // conv2 row r is output time o0 + r; rows S .. TT - 1 read past y's rows
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 16 * mt + g + 8 * hf;
      const int t = o0 + r;
      if (r >= S || t >= T) continue;
      const bool valid = t < seq_len;
      const size_t o = ((size_t)b * T + t) * C;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = 8 * nt + 2 * t4;
        float2 h = make_float2(0.f, 0.f);
        if (valid) {
          const float2 res = *reinterpret_cast<const float2*>(src + o + c);
          h.x = res.x + (acc[mt][nt][2 * hf] + b2[c]);
          h.y = res.y + (acc[mt][nt][2 * hf + 1] + b2[c + 1]);
        }
        if (hout != nullptr) *reinterpret_cast<float2*>(hout + o + c) = h;
        if (accout != nullptr) {
          float2 a = make_float2(0.f, 0.f);
          if (accin != nullptr) a = *reinterpret_cast<const float2*>(accin + o + c);
          a.x = (a.x + h.x) / acc_div;
          a.y = (a.y + h.y) / acc_div;
          *reinterpret_cast<float2*>(accout + o + c) = a;
        }
      }
    }
}

template <int C>
cudaError_t launch(const float* src, const float* wp, const float* b1,
                   const float* b2, float* hout, const float* accin,
                   float* accout, float acc_div, int B, int T, int seq_len,
                   int K, int dil, float slope, cudaStream_t stream) {
  const int p1 = (K - 1) / 2 * dil, p2 = (K - 1) / 2;
  const int S = mrf_tile(C) - 2 * p2;
  const size_t smem = mrf_smem_bytes(C, p1);
  if (S <= 0 || smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mrf_pair_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + S - 1) / S, B);
  mrf_pair_kernel<C><<<grid, kMrfThreads, smem, stream>>>(
      src, wp, b1, b2, hout, accin, accout, acc_div, T, seq_len, K, dil,
      slope);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One (block, dilation) pair of an MRF stage, fp32, (B, T, C) contiguous:
//   y[t] = (0 <= t < seq_len) ? bias1 + sum_{tap, ci} leaky(src[t + tap*dil
//          - pad1, ci]) * w1[tap, ci, co] : 0
//   h[t] = (t < seq_len) ? src[t] + bias2 + sum_{tap, ci} leaky(y[t + tap
//          - pad2, ci]) * w2[tap, ci, co] : 0
// with src read as zero outside [0, seq_len), pad1 = (K - 1) / 2 * dil and
// pad2 = (K - 1) / 2. wp holds w1's K taps then w2's K taps, each split
// into TF32 hi / lo and packed in fragment order (ops/fused_mrf.py
// `pack_weights`). Epilogue (each pointer may be null):
//   hout:   hout[t] = h
//   accout: accout[t] = ((accin ? accin[t] : 0) + h) / acc_div
// hout must not alias src (a block reads a halo of src that its neighbours
// write); accin may alias accout (read and written by the same thread).
// Returns the launch's cudaError_t (0 = success).
int vt_mrf_pair(const float* src, const float* wp, const float* b1,
                const float* b2, float* hout, const float* accin,
                float* accout, float acc_div, int B, int T, int C,
                int seq_len, int K, int dil, float slope, void* stream) {
  if (B <= 0 || T <= 0 || K <= 0 || K % 2 == 0 || dil <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16:
      return (int)launch<16>(src, wp, b1, b2, hout, accin, accout, acc_div,
                             B, T, seq_len, K, dil, slope, s);
    case 32:
      return (int)launch<32>(src, wp, b1, b2, hout, accin, accout, acc_div,
                             B, T, seq_len, K, dil, slope, s);
    case 64:
      return (int)launch<64>(src, wp, b1, b2, hout, accin, accout, acc_div,
                             B, T, seq_len, K, dil, slope, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
