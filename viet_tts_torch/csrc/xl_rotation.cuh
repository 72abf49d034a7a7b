// The per-row Givens rotations of kernel K5 (xl2), shared by its forward
// (flash_xl_attention.cu) and its backward (flash_xl_attention_bwd.cu) so
// that both compute the same rotated streams bit for bit.
//
// Row i of the query stream g = K_h(q + v_bias) turns into
//   gA_i = rot(g_i,     (T-1-i) w_m)   (the past term)
//   gB_i = rot(g_{i+1}, -(i+2) w_m)    (the future term)
// with w_m = exp(m * (-2 ln 10000 / E)) for the (2m, 2m+1) pair: the TPU
// kernel's own formula (viet_tts_tpu/ops/pallas_attention.py:_xl2_cos_sin),
// in fp32 with the accurate expf and sincosf (the angles reach ~2000 rad at
// T = 1008; fast-math would lose them).

#pragma once

struct VtXl2Angles {
  float ca, sa, cb, sb;
};

// The rotation of pair m of row qi; Tq the real sequence length.
__device__ __forceinline__ VtXl2Angles vt_xl2_angles(int Tq, int qi, int m,
                                                     float freq_coef) {
  VtXl2Angles r;
  const float w = expf((float)m * freq_coef);
  sincosf((((float)Tq - 1.0f) - (float)qi) * w, &r.sa, &r.ca);
  sincosf(-((float)qi + 2.0f) * w, &r.sb, &r.cb);
  return r;
}

// rot((e, o), angle) with (c, s) = (cos, sin) of the angle, and its inverse
// (the transpose, rotating by -angle), which carries a gradient back.
__device__ __forceinline__ float2 vt_rot(float e, float o, float c, float s) {
  return make_float2(e * c - o * s, e * s + o * c);
}
__device__ __forceinline__ float2 vt_rot_inv(float e, float o, float c,
                                             float s) {
  return make_float2(e * c + o * s, o * c - e * s);
}
