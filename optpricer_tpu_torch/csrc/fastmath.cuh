// Bias-free float32 exp / log / inverse normal CDF and the bit reversal.
//
// Straight port of optpricer_tpu/ops/fastmath.py (exp32, log32, norminv32)
// and optpricer_tpu/ops/pallas_mc.py:_bitrev32; the plain torch forms are in
// optpricer_tpu_torch/ops/fastmath.py. No expf/logf/__expf and no fast-math:
// the point of these polynomials is that they carry no systematic bias.
// nvcc may contract a multiply-add into an FMA, which moves a result by an
// ulp at most against the plain forms.
#pragma once

#include <cstdint>

namespace optpricer {

__device__ __forceinline__ float exp32(float x) {
  const float t = x * 1.4426950408889634f;
  const float n = floorf(t + 0.5f);
  const float f = t - n;
  float p = 1.5252733804059840e-05f;
  p = p * f + 1.5403530393381610e-04f;
  p = p * f + 1.3333558146428443e-03f;
  p = p * f + 9.618129107628477e-03f;
  p = p * f + 5.550410866482158e-02f;
  p = p * f + 2.402265069591007e-01f;
  p = p * f + 6.931471805599453e-01f;
  p = p * f + 1.0f;
  const float scale = __int_as_float((static_cast<int>(n) + 127) << 23);
  return p * scale;
}

__device__ __forceinline__ float log32(float u) {
  const int bits = __float_as_int(u);
  int e = (bits >> 23) - 127;
  float m = __int_as_float((bits & 0x7FFFFF) | (127 << 23));
  const bool big = m > 1.4142135623730951f;
  if (big) {
    m *= 0.5f;
    e += 1;
  }
  const float ef = static_cast<float>(e);
  const float s = (m - 1.0f) / (m + 1.0f);
  const float s2 = s * s;
  float poly = 1.0f / 9.0f;
  poly = poly * s2 + 1.0f / 7.0f;
  poly = poly * s2 + 1.0f / 5.0f;
  poly = poly * s2 + 1.0f / 3.0f;
  poly = poly * s2 + 1.0f;
  const float ln_m = 2.0f * s * poly;
  return ef * 0.693145751953125f + (ln_m + ef * 1.428606765330187e-06f);
}

__device__ __forceinline__ float norminv32(float u) {
  const float x = 2.0f * u - 1.0f;
  const float onem = 4.0f * u * (1.0f - u);
  const float w = -log32(fmaxf(onem, 1.1920929e-7f));
  float p;
  if (w < 5.0f) {
    const float c = w - 2.5f;
    p = 2.81022636e-08f;
    p = p * c + 3.43273939e-07f;
    p = p * c + -3.5233877e-06f;
    p = p * c + -4.39150654e-06f;
    p = p * c + 0.00021858087f;
    p = p * c + -0.00125372503f;
    p = p * c + -0.00417768164f;
    p = p * c + 0.246640727f;
    p = p * c + 1.50140941f;
  } else {
    const float t = sqrtf(w) - 3.0f;
    p = -0.000200214257f;
    p = p * t + 0.000100950558f;
    p = p * t + 0.00134934322f;
    p = p * t + -0.00367342844f;
    p = p * t + 0.00573950773f;
    p = p * t + -0.0076224613f;
    p = p * t + 0.00943887047f;
    p = p * t + 1.00167406f;
    p = p * t + 2.83297682f;
  }
  return 1.4142135623730951f * p * x;
}

__device__ __forceinline__ uint32_t bitrev32(uint32_t v) {
  return __brev(v);
}

}  // namespace optpricer
