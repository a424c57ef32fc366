// The activation quantizer of the int8 kernels: the code
// rint(clip(v / alpha, 0, 1) * (qlvl - 1)) of a float v, or on the offset
// grid of shift k > 0 the signed code clip(rint(v / alpha * (qlvl - 1)),
// -k, qlvl - 1 - k), as quant.py's act_codes computes them (float32,
// rounded after the divide and after the multiply, half to even), found by
// thresholds where a call has at most 4 levels.  K1 (qconv3d_int8.cu)
// quantizes a float input and its quant epilogue's output with it, K2
// (stem_s2d.cu) its output for the next conv, K3 (qmatmul_int8.cu) its
// float input.
#pragma once

#include <cuda_runtime.h>

namespace {

// the activation code of v: rint(clip(v / alpha, 0, 1) * qmax), or with
// an offset k > 0 clip(rint(v / alpha * qmax), -k, qmax - k)
__device__ __forceinline__ int act_code(float v, float alpha, float qmax,
                                        int k = 0) {
  if (k == 0) {
    const float q = fminf(fmaxf(__fdiv_rn(v, alpha), 0.0f), 1.0f);
    return static_cast<int>(rintf(__fmul_rn(q, qmax)));
  }
  const float r = rintf(__fmul_rn(__fdiv_rn(v, alpha), qmax));
  return static_cast<int>(
      fminf(fmaxf(r, static_cast<float>(-k)), qmax - static_cast<float>(k)));
}

// The quantizer of one call: with `thresh`, t[j] is the least v whose code
// is j + 1 - k or more (NaN past the last code: no v reaches it)
struct Quant {
  float alpha, qmax;
  float t[3];
  int k;
  bool thresh;
};

// The least float v with act_code(v) >= c, for alpha in [2^-60, 2^60]:
// act_code is monotone in v, so of the 32 consecutive floats around
// alpha (c - 0.5) / qmax (in increasing order, one per lane: a negative
// float's bits grow as it falls), the first that reaches c is it, when
// the first lane's does not.  All 32 lanes call it; `found` is false when
// the window misses.
__device__ __forceinline__ float code_threshold(int c, float alpha,
                                                float qmax, int k,
                                                bool& found) {
  const float mid =
      __fmul_rn(__fdiv_rn(static_cast<float>(c) - 0.5f, qmax), alpha);
  const int step = static_cast<int>(threadIdx.x & 31u) - 16;
  const float v = __uint_as_float(__float_as_uint(mid) +
                                  static_cast<unsigned>(mid < 0.0f ? -step
                                                                   : step));
  const unsigned hit =
      __ballot_sync(0xffffffffu, act_code(v, alpha, qmax, k) >= c);
  found = hit != 0 && (hit & 1u) == 0;
  return __shfl_sync(0xffffffffu, v, found ? __ffs(hit) - 1 : 0);
}

// The quantizer of one call, the same in every warp: thresholds for at
// most 4 levels and alpha in [2^-60, 2^60], where the window finds them
// all; else every value takes act_code's divide.  k: the offset grid's
// shift, 0 for the unsigned grid.
__device__ Quant quant_setup(float alpha, int qlvl, int k = 0) {
  Quant q;
  q.alpha = alpha;
  q.qmax = static_cast<float>(qlvl - 1);
  q.k = k;
  q.thresh = qlvl <= 4 && alpha >= 0x1p-60f && alpha <= 0x1p60f;
  const bool few = q.thresh;  // uniform over the block
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q.t[c] = __int_as_float(0x7fffffff);
    if (few && c + 1 < qlvl) {
      bool found;
      q.t[c] = code_threshold(c + 1 - k, alpha, q.qmax, k, found);
      q.thresh = q.thresh && found;
    }
  }
  return q;
}

// act_code(v), by the thresholds where the call has them: the lowest code
// and the count of thresholds v reaches, the same code by monotony, with
// no divide (NaN reaches none: the lowest code)
__device__ __forceinline__ int code_of(float v, const Quant& q) {
  return q.thresh ? (v >= q.t[0]) + (v >= q.t[1]) + (v >= q.t[2]) - q.k
                  : act_code(v, q.alpha, q.qmax, q.k);
}

}  // namespace
