// Per-voxel logic of W1, the terrain slab kernel (terrain.cu): which voxel
// bit b of a chunk's brick stands for, and whether it is solid.
//
// A brick's bit b, in the brick layout's order (core/layout.py::
// sample_index over an f x f x f brick), is the voxel brick_voxel(b) of
// its chunk: the inverse of sample_index (position_from_sample_index) for
// LINEAR, TILED_LINEAR and TILED_MORTON; the tiled layouts need f % 8 == 0,
// as core/brickmap.py::choose_layout ensures.  Bits at and past f^3 (the
// tail of the last word of a brick whose f^3 is not a multiple of 32) are
// 0, as core/brickmap.py::_slab_to_chunks pads them.
//
// __host__ __device__ (dda.cuh's VX_HD): nvcc builds it into terrain.cu,
// g++ into the host library of the CPU tests (terrain_host.cpp).
#pragma once

#include "dda.cuh"
#include "noise.cuh"

namespace vx {

VX_HD int compact1by2(int x) {
  x &= 0x00249249;
  x = (x ^ (x >> 2)) & 0x000C30C3;
  x = (x ^ (x >> 4)) & 0x0000F00F;
  x = (x ^ (x >> 8)) & 0x000000FF;
  return x;
}

// Voxel (l[0], l[1], l[2]) = (x, y, z) of bit b < f^3 of an f^3 brick in
// `layout` (core/layout.py::position_from_sample_index).
VX_HD void brick_voxel(int b, int f, int layout, int* l) {
  if (layout == LAYOUT_LINEAR) {
    l[0] = b % f;
    l[1] = (b / f) % f;
    l[2] = b / (f * f);
    return;
  }
  const int tiles = f >> 3, tile = b >> 9, fine = b & 511;
  const int tx = tile % tiles, ty = (tile / tiles) % tiles, tz = tile / (tiles * tiles);
  if (layout == LAYOUT_TILED_MORTON) {
    l[0] = tx * 8 + compact1by2(fine);
    l[1] = ty * 8 + compact1by2(fine >> 1);
    l[2] = tz * 8 + compact1by2(fine >> 2);
  } else {
    l[0] = tx * 8 + (fine & 7);
    l[1] = ty * 8 + ((fine >> 3) & 7);
    l[2] = tz * 8 + (fine >> 6);
  }
}

// One z-slab of chunks: world rows z0 .. z0 + factor, chunks (cy, cx) in
// row-major order, chunk c at (c % chunks_x, c / chunks_x).
struct SlabParams {
  int z0;
  int factor;
  int chunks_x;      // X / factor
  int wpb;           // words per brick, ceil(factor^3 / 32)
  int brick_layout;  // BrickLayout
  int octaves;
};

// Bit b of chunk c's brick: whether it is a solid voxel, and that voxel's
// chunk-local (x, y, z) in l (left as is for a tail bit, which is 0).
VX_HD bool slab_bit(const SlabParams& S, int c, int b, int* l) {
  const int f = S.factor;
  if (b >= f * f * f) return false;
  brick_voxel(b, f, S.brick_layout, l);
  return terrain_solid((c % S.chunks_x) * f + l[0], (c / S.chunks_x) * f + l[1], S.z0 + l[2],
                       S.octaves);
}

// The noise probe's arguments (terrain.cu::vx_noise_points).
struct NoiseArgs {
  int kind;  // 0 hash, 1 random_float, 2 perlin, 3 repeater_perlin, 4 terrain_t, 5 solid
  const void* in;  // uint32[n] (kinds 0, 1), f32[n, 3] (2, 3) or i32[n, 3] (4, 5)
  float scale;
  int seed;
  int octaves;
  float lacunarity, decay;
  float* fout;          // kinds 1-4
  unsigned int* uout;   // kinds 0, 5
};

// Point i of the noise probe.
VX_HD void noise_point(const NoiseArgs& A, int i) {
  const unsigned int* u = static_cast<const unsigned int*>(A.in);
  const float* p = static_cast<const float*>(A.in) + 3 * i;
  const int* v = static_cast<const int*>(A.in) + 3 * i;
  switch (A.kind) {
    case 0: A.uout[i] = hash_u32(u[i]); break;
    case 1: A.fout[i] = random_float(u[i]); break;
    case 2: A.fout[i] = perlin_noise(p[0], p[1], p[2], A.scale, A.seed); break;
    case 3: A.fout[i] = repeater_perlin(p[0], p[1], p[2], A.scale, A.octaves, A.lacunarity, A.decay); break;
    case 4: A.fout[i] = terrain_t(v[0], v[1], v[2], A.octaves); break;
    default: A.uout[i] = terrain_solid(v[0], v[1], v[2], A.octaves); break;
  }
}

}  // namespace vx
