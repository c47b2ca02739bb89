// Per-ray setup of the traversals: normalize, move to chunk units, clip to
// the world AABB, edge pad.
//
// The scalar form of voxelengine_tpu_torch/ops/trace.py::_ray_setup and
// _edge_pad (with ops/aabb.py::ray_aabb), which the JAX wrappers run in XLA
// before their Pallas kernels (voxelengine_tpu/ops/pallas_trace.py:487-497,
// VolumeRaytracer.cu:354-381).  Every operation is the plain version's, in
// its order and separately rounded, so the results are its bits: the norm
// summed x*x + y*y + z*z (core/exact.py::dot3), an IEEE square root and
// IEEE divisions (nvcc --fmad=false without fast-math, g++
// -ffp-contract=off), and torch.minimum / torch.maximum's NaN propagation in
// the slab test.
//
// __host__ __device__ like dda.cuh: gridtrace.cu runs it inside K2 and K3,
// dda_host.cpp on the CPU for the tests.
#pragma once

#include <math.h>

#include "dda.cuh"

namespace vx {

// torch.minimum / torch.maximum: NaN if either side is NaN.
VX_HD float nan_min(float a, float b) { return (a != a || b != b) ? a + b : (b < a ? b : a); }
VX_HD float nan_max(float a, float b) { return (a != a || b != b) ? a + b : (b > a ? b : a); }

struct RaySetup {
  float sx, sy, sz;     // start in chunk units, clipped to the world AABB
  float dx, dy, dz;     // normalized direction
  float snx, sny, snz;  // world-entry normal (0 for a start inside the world)
  int active;           // starts inside the world or enters it
  int padx, pady, padz; // edge pad: the start cell on a maximal face, d < 0
};

// (ox, oy, oz) the origin in voxels, (vx, vy, vz) the direction as given
// (not normalized), factor the voxels per chunk edge (1 for a dense grid),
// (gx, gy, gz) the grid in chunks.
VX_HD RaySetup ray_setup(float ox, float oy, float oz, float vx, float vy, float vz, int factor,
                         int gx, int gy, int gz) {
  RaySetup s;
  // _normalize: v / sqrt(x*x + y*y + z*z)
  const float len = sqrtf(vx * vx + vy * vy + vz * vz);
  s.dx = vx / len; s.dy = vy / len; s.dz = vz / len;
  const float ff = (float)factor;
  const float px = ox / ff, py = oy / ff, pz = oz / ff;
  const float gfx = (float)gx, gfy = (float)gy, gfz = (float)gz;
  const bool inside = px >= 0.0f && px < gfx && py >= 0.0f && py < gfy && pz >= 0.0f && pz < gfz;
  // ray_aabb(start, d, eps, gdims - eps), eps = FLT_EPS_DDA (config.py);
  // a zero direction component becomes FLT_EPSILON before the reciprocal
  const float eps = 1e-6f, flt_eps = 1.1920929e-07f;
  const float ivx = 1.0f / (s.dx == 0.0f ? flt_eps : s.dx);
  const float ivy = 1.0f / (s.dy == 0.0f ? flt_eps : s.dy);
  const float ivz = 1.0f / (s.dz == 0.0f ? flt_eps : s.dz);
  const float lx = (eps - px) * ivx, hx = (gfx - eps - px) * ivx;
  const float ly = (eps - py) * ivy, hy = (gfy - eps - py) * ivy;
  const float lz = (eps - pz) * ivz, hz = (gfz - eps - pz) * ivz;
  const float t1x = nan_min(lx, hx), t1y = nan_min(ly, hy), t1z = nan_min(lz, hz);
  const float t_min = nan_max(nan_max(t1x, t1y), t1z);
  const float t_max = nan_min(nan_min(nan_max(lx, hx), nan_max(ly, hy)), nan_max(lz, hz));
  const bool whit = t_max >= nan_max(t_min, 0.0f);
  const bool is_x = t_min == t1x, is_y = !is_x && t_min == t1y;
  if (inside || !whit) {
    s.sx = px; s.sy = py; s.sz = pz;
  } else {
    s.sx = px + t_min * s.dx; s.sy = py + t_min * s.dy; s.sz = pz + t_min * s.dz;
  }
  s.snx = !inside && is_x ? (ivx < 0.0f ? -1.0f : 1.0f) : 0.0f;
  s.sny = !inside && is_y ? (ivy < 0.0f ? -1.0f : 1.0f) : 0.0f;
  s.snz = !inside && !is_x && !is_y ? (ivz < 0.0f ? -1.0f : 1.0f) : 0.0f;
  s.active = inside || whit;
  // _edge_pad on the truncated start cell
  const bool on_edge = (int)s.sx == gx || (int)s.sy == gy || (int)s.sz == gz;
  s.padx = on_edge && s.dx < 0.0f; s.pady = on_edge && s.dy < 0.0f; s.padz = on_edge && s.dz < 0.0f;
  return s;
}

}  // namespace vx
