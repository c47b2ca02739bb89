// Worldgen noise, per point: the scalar form of voxelengine_tpu_torch/ops/
// noise.py (hash_u32, random_float, random_int_grid, f32_to_u32_sat, grad,
// fade, lerp, perlin_noise, repeater_perlin) for W1 (terrain.cu).
//
// Same bit-level semantics as ops/noise.py and the reference's cuda_noise
// header (cuda_noise.cuh:44-71,115-118,161-200,565-629), op by op in its
// order:
//   - integer hashing is uint32 with wraparound;
//   - float -> uint32 follows CUDA's saturating (unsigned)f: truncation
//     toward zero, negatives and NaN to 0, 2^32 and above to UINT_MAX
//     (spelled out, since the host compiler's cast is undefined there);
//   - every float op is float32, rounded on its own: nvcc --fmad=false and
//     g++ -ffp-contract=off, IEEE division, no fast-math (kernels/build.py);
//   - the reference's quirks: repeater_perlin ignores its seed (octave i
//     uses (i + 38) * 27389482, wrapping as int32), the octave scale and
//     amplitude are carried as float32, and grad aliases hash entries
//     0xC-0xF onto 0, 9, 1 and 11.
// native/golden_noise.json holds golden values of every function here.
//
// Every function is __host__ __device__ (dda.cuh's VX_HD): nvcc builds it
// into terrain.cu, g++ into the host library of the CPU tests
// (terrain_host.cpp).
#pragma once

#include <math.h>

#include "dda.cuh"

namespace vx {

// 6-round avalanche integer hash (cuda_noise.cuh:44-54).
VX_HD unsigned int hash_u32(unsigned int s) {
  s = (s + 0x7ED55D16u) + (s << 12);
  s = (s ^ 0xC761C23Cu) ^ (s >> 19);
  s = (s + 0x165667B1u) + (s << 5);
  s = (s + 0xD3A2646Cu) ^ (s << 9);
  s = (s + 0xFD7046C5u) + (s << 3);
  s = (s ^ 0xB55A4F09u) ^ (s >> 16);
  return s;
}

// CUDA's (unsigned)f: truncate toward zero, saturate.
VX_HD unsigned int f32_to_u32_sat(float x) {
  if (!(x > 0.0f)) return 0u;  // negatives, zeros, NaN
  if (x >= 4294967296.0f) return 0xFFFFFFFFu;
  return (unsigned int)x;
}

// Random float in [0, 1] (cuda_noise.cuh:65-71): hash / 2^32, the float
// of 0xFFFFFFFF.
VX_HD float random_float(unsigned int seed) { return (float)hash_u32(seed) / 4294967296.0f; }

// Random uint32 for a grid coordinate (cuda_noise.cuh:115-118).
VX_HD unsigned int random_int_grid(float x, float y, float z, float seed) {
  return hash_u32(f32_to_u32_sat(x * 1723.0f + y * 93241.0f + z * 149812.0f + 3824.0f + seed));
}

VX_HD float lerp(float a, float b, float r) { return a * (1.0f - r) + b * r; }

VX_HD float fade(float t) { return t * t * t * (t * (t * 6.0f - 15.0f) + 10.0f); }

// Gradient dot product keyed by h & 0xF (cuda_noise.cuh:173-195), 0xC-0xF
// aliased onto 0, 9, 1, 11; ops/noise.py::grad's form: (1 - 2 b0) * first
// + (1 - 2 b1) * second with first, second the pair of (x, y, z) that the
// entry's group picks.
VX_HD float grad(unsigned int h, float x, float y, float z) {
  int i = (int)(h & 0xFu);
  i = i == 12 ? 0 : i == 13 ? 9 : i == 14 ? 1 : i == 15 ? 11 : i;
  const float b0 = (float)(i & 1), b1 = (float)((i >> 1) & 1);
  const int g = i >> 2;  // 0: (x, y)  1: (x, z)  2: (y, z)
  const float first = g == 2 ? y : x, second = g == 0 ? y : z;
  return (1.0f - 2.0f * b0) * first + (1.0f - 2.0f * b1) * second;
}

// Trilinear-faded 8-corner gradient noise (cuda_noise.cuh:565-613); the
// seed converted to float like the reference's (float)seed.
VX_HD float perlin_noise(float px, float py, float pz, float scale, int seed) {
  const float fseed = (float)seed;
  px = px * scale;
  py = py * scale;
  pz = pz * scale;
  const float ix = floorf(px), iy = floorf(py), iz = floorf(pz);
  const float x = px - ix, y = py - iy, z = pz - iz;
  const float u = fade(x), v = fade(y), w = fade(z);
  auto corner = [&](float ox, float oy, float oz) {
    return grad(random_int_grid(ix + ox, iy + oy, iz + oz, fseed), x - ox, y - oy, z - oz);
  };
  const float x00 = lerp(corner(0.0f, 0.0f, 0.0f), corner(1.0f, 0.0f, 0.0f), u);
  const float x10 = lerp(corner(0.0f, 1.0f, 0.0f), corner(1.0f, 1.0f, 0.0f), u);
  const float x01 = lerp(corner(0.0f, 0.0f, 1.0f), corner(1.0f, 0.0f, 1.0f), u);
  const float x11 = lerp(corner(0.0f, 1.0f, 1.0f), corner(1.0f, 1.0f, 1.0f), u);
  const float y0 = lerp(x00, x10, v);
  const float y1 = lerp(x01, x11, v);
  return lerp(y0, y1, w);
}

// Perlin fBm (cuda_noise.cuh:615-629); no seed argument: octave i uses
// (i + 38) * 27389482 as int32 (reference quirk).
VX_HD float repeater_perlin(float px, float py, float pz, float scale, int n, float lacunarity,
                            float decay) {
  float acc = 0.0f, sc = scale, amp = 1.0f;
  for (int i = 0; i < n; ++i) {
    const int seed = (int)((unsigned int)(i + 38) * 27389482u);
    acc = acc + perlin_noise(px * sc, py * sc, pz * sc, 1.0f, seed) * amp;
    sc = sc * lacunarity;
    amp = amp * decay;
  }
  return acc;
}

// The terrain's height threshold at integer voxel coords
// (worldgen/terrain.py::terrain_density, VoxelWorldBuilder.cu:17-34):
// max(repeater_perlin((x, y, z) * 0.005, 1, -, octaves, 2, 0.5) * 1000, 0).
VX_HD float terrain_t(int x, int y, int z, int octaves) {
  const float t =
      repeater_perlin((float)x * 0.005f, (float)y * 0.005f, (float)z * 0.005f, 1.0f, octaves, 2.0f,
                      0.5f) * 1000.0f;
  return t > 0.0f ? t : 0.0f;
}

// worldgen/terrain.py::solid_at: solid iff y <= t.
VX_HD bool terrain_solid(int x, int y, int z, int octaves) {
  return !((float)y > terrain_t(x, y, z, octaves));
}

}  // namespace vx
