// The camera basis per Euler triple, with glibc 2.36's sinf and cosf: the
// per-angle logic of camera.cu, __host__ __device__ (dda.cuh's VX_HD) so
// that g++ builds the same source into camera_host.cpp for the CPU tests.
//
// The JAX reference computes its camera basis with XLA:CPU's sin and cos,
// which are glibc's sinf and cosf; CUDA's sinf and cosf are another
// algorithm and differ in the last bit at some angles, which moves every
// primary ray of a frame.  glibc_sincosf below is glibc's x86-64 FMA build
// (sysdeps/ieee754/flt-32/s_sinf.c, s_cosf.c, sincosf.h, sincosf_data.c),
// step for step as core/libm.py writes it in torch:
//   - the float32 argument goes to double;
//   - |x| < pi/4 (by the top 12 bits): the polynomial on x itself, with
//     the tiny-argument return below 2^-12;
//   - |x| < 120: reduce_fast, n = ((int)(x * 2/pi * 2^24) + 2^23) >> 24 and
//     r = x - n * pi/2 in one fused step;
//   - otherwise reduce_large: the mantissa times a 96-bit window of 4/pi in
//     integer arithmetic, y's sign folded into the quadrant of the signs;
//   - the sine or cosine polynomial of r by n & 1, signs by q & 3, the
//     negated cosine table by q & 2, every a + b * c fused (fma), rounded
//     once to float.
// Every other op rounds on its own: nvcc --fmad=false, g++
// -ffp-contract=off (kernels/build.py).
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "dda.cuh"

namespace vx {

struct SinCosF {
  float s, c;
};

VX_HD uint32_t float_bits(float f) {
  uint32_t u;
  memcpy(&u, &f, sizeof u);
  return u;
}

// sinf_poly: the sine (even n) or cosine (odd n) polynomial of r, with the
// sign of the table's quadrant q (sign = {1, -1, -1, 1}) and table[1]'s
// negated cosine coefficients for q & 2.
VX_HD double sincosf_poly(double r, int q, bool cosine) {
  const double sgn = ((q & 3) == 1 || (q & 3) == 2) ? -1.0 : 1.0;
  const double neg = (q & 2) ? -1.0 : 1.0;
  const double x = r * sgn, x2 = r * r;
  if (!cosine) {
    const double x3 = x * x2, x5 = x3 * x2;
    const double s1 = fma(x2, -0x1.994eb3774cf24p-13, 0x1.1107605230bc4p-7);
    return fma(x5, s1, fma(x3, -0x1.555545995a603p-3, x));
  }
  const double x4 = x2 * x2, x6 = x4 * x2;
  const double c2 = fma(x2, 0x1.99343027bf8c3p-16 * neg, -0x1.6c087e89a359dp-10 * neg);
  const double c1 = fma(x2, -0x1.ffffffd0c621cp-2 * neg, 0x1p0 * neg);
  return fma(x6, c2, fma(x4, 0x1.55553e1068f19p-5 * neg, c1));
}

// reduce_large: r in [-pi/4, pi/4] and the quadrant n of |x| from the
// float32 bits xi (|x| >= 120), through a 32x96 -> 128-bit product with
// the 192-bit table of 4/pi.
VX_HD double sincosf_reduce_large(uint32_t xi, int* np) {
  const uint32_t inv_pio4[24] = {
      0xa2,       0xa2f9,     0xa2f983,   0xa2f9836e, 0xf9836e4e, 0x836e4e44,
      0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
      0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62,
      0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041};
  const uint32_t* arr = &inv_pio4[(xi >> 26) & 15];
  const int shift = (xi >> 23) & 7;
  xi = ((xi & 0xffffff) | 0x800000) << shift;
  uint64_t res0 = (uint32_t)(xi * arr[0]);
  const uint64_t res1 = (uint64_t)xi * arr[4];
  const uint64_t res2 = (uint64_t)xi * arr[8];
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  const uint64_t n = (res0 + (1ULL << 61)) >> 62;
  res0 -= n << 62;
  *np = (int)n;
  return (double)(int64_t)res0 * 0x1.921FB54442D18p-62;
}

// glibc's (sinf(y), cosf(y)) for finite y (NaN for inf and NaN).
VX_HD SinCosF glibc_sincosf(float y) {
  const uint32_t bits = float_bits(y);
  const uint32_t top = (bits >> 20) & 0x7ff;
  if (top < 0x398) return {y, 1.0f};  // |y| < 2^-12
  if (top >= 0x7f8) return {y - y, y - y};
  double r;
  int n, q;
  if (top < 0x3f4) {  // |y| < pi/4
    r = (double)y;
    n = q = 0;
  } else if (top < 0x42f) {  // |y| < 120: reduce_fast
    const double x = (double)y;
    n = q = ((int32_t)(x * 0x1.45F306DC9C883p+23) + 0x800000) >> 24;
    r = fma(-(double)n, 0x1.921FB54442D18p0, x);
  } else {
    r = sincosf_reduce_large(bits, &n);
    q = n + (int)(bits >> 31);
  }
  return {(float)sincosf_poly(r, q, (n & 1) != 0), (float)sincosf_poly(r, q, (n & 1) == 0)};
}

// render/camera.py::get_directions for one (pitch, yaw, roll): out[0:3] =
// -forward, out[3:6] = -up, out[6:9] = right, with forward = (cos p sin y,
// -sin p, cos p cos y), right = (cos y, 0, -sin y) and up = forward x right
// (camera.py::_cross's products and differences).
VX_HD void camera_basis(const float* e, float* out) {
  const SinCosF p = glibc_sincosf(e[0]), w = glibc_sincosf(e[1]);
  const float f[3] = {p.c * w.s, -p.s, p.c * w.c};
  const float rt[3] = {w.c, 0.0f, -w.s};
  const float u[3] = {f[1] * rt[2] - f[2] * rt[1], f[2] * rt[0] - f[0] * rt[2],
                      f[0] * rt[1] - f[1] * rt[0]};
  for (int k = 0; k < 3; ++k) {
    out[k] = -f[k];
    out[3 + k] = -u[k];
    out[6 + k] = rt[k];
  }
}

}  // namespace vx
