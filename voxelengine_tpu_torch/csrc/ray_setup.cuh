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
// bigtrace.cu and bmtrace.cu inside K1's and K4's rays and record entries
// (trace_ray_full below), dda_host.cpp on the CPU for the tests.
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

// A ray of global memory read through the read-only data path on the card.
VX_HD float ldgf(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// ops/trace.py::kernel_result's hit_imm fix-up of a walk's result r, for a
// ray given by `ray(o, v)` (its origin in voxels and raw direction): a hit
// at the ray's start reports the clipped start in voxels (start_c * factor,
// one rounding) and the world-entry normal.  The setup is computed again
// from the ray, so nothing of it is live across the walk (a hit_imm ray is
// rare).
template <class Ray>
VX_HD void fix_hit_imm(const TraceParams& P, const Ray& ray, TraceResult& r) {
  if (r.flags & 2) {
    float o[3], v[3];
    ray(o, v);
    const RaySetup s = ray_setup(o[0], o[1], o[2], v[0], v[1], v[2], P.factor, P.gx, P.gy, P.gz);
    const float ff = (float)P.factor;
    r.px = s.sx * ff; r.py = s.sy * ff; r.pz = s.sz * ff;
    r.nx = s.snx; r.ny = s.sny; r.nz = s.snz;
  }
}

// ray_init of the ray whose origin (voxels) and raw direction are o and v,
// set up over P's grid (ray_setup): the start of a walk that a loop of its
// own advances (K5's rays entry).  False for an inactive ray.
VX_HD bool ray_init_of(const TraceParams& P, RayState& S, const float* o, const float* v) {
  const RaySetup s = ray_setup(ldgf(o), ldgf(o + 1), ldgf(o + 2), ldgf(v), ldgf(v + 1), ldgf(v + 2), P.factor,
                               P.gx, P.gy, P.gz);
  return ray_init(S, s.sx, s.sy, s.sz, s.dx, s.dy, s.dz, s.active, s.padx, s.pady, s.padz);
}

// The ray of row i of origins and raw directions at row strides os and rs
// (3, or 0 for one row shared by every ray), as a fix_hit_imm `ray`.
struct RayOf {
  const float* origins;
  int os;
  const float* rays;
  int rs;
  long long i;
  VX_HD void operator()(float* o, float* v) const {
    for (int k = 0; k < 3; ++k) o[k] = ldgf(origins + os * i + k);
    for (int k = 0; k < 3; ++k) v[k] = ldgf(rays + rs * i + k);
  }
};

// K1's and K4's rays entries for one ray: ops/bigtrace.py::trace_brickmap_k1
// and ops/trace2.py::_trace_brickmap_kernel whole.  ray_setup at the
// brickmap's factor (ops/trace.py::_ray_setup and _edge_pad), the walk,
// and ops/trace.py::kernel_result's hit_imm fix-up: a hit at the ray's start
// reports the clipped start in voxels (start_c * factor, one rounding) and
// the world-entry normal.  `ray(o, v)` writes the ray's origin (voxels) and
// raw direction; the fix-up asks for them again and computes the setup
// again instead of keeping either live across the walk, whose loop runs at
// the production builds' 64-register cap; a hit_imm ray is rare.  A ray
// that is cheap to rebuild (secondary.cuh's) keeps nothing of it live.
template <bool MACRO = false, bool DIAG = false, class Fetch, class Ray>
VX_HD TraceResult trace_ray_of(const TraceParams& P, const Fetch& F, const Ray& ray, int* diag = nullptr) {
  TraceResult r;
  {
    float o[3], v[3];
    ray(o, v);
    const RaySetup s = ray_setup(o[0], o[1], o[2], v[0], v[1], v[2], P.factor, P.gx, P.gy, P.gz);
    r = trace_ray<MACRO, DIAG>(P, F, s.sx, s.sy, s.sz, s.dx, s.dy, s.dz, s.active, s.padx, s.pady,
                               s.padz, diag);
  }
  fix_hit_imm(P, ray, r);
  return r;
}

// trace_ray_of for a ray given by its values.
template <bool MACRO = false, bool DIAG = false, class Fetch>
VX_HD TraceResult trace_ray_full(const TraceParams& P, const Fetch& F, float ox, float oy, float oz,
                                 float vx, float vy, float vz, int* diag = nullptr) {
  return trace_ray_of<MACRO, DIAG>(
      P, F,
      [&](float* o, float* v) {
        o[0] = ox; o[1] = oy; o[2] = oz;
        v[0] = vx; v[1] = vy; v[2] = vz;
      },
      diag);
}

// Ray i's position, normal and steps, as every brickmap kernel stores them.
VX_HD void store_ray(const TraceResult& r, int i, float* pos, float* normal, int* steps) {
  pos[3 * i] = r.px; pos[3 * i + 1] = r.py; pos[3 * i + 2] = r.pz;
  normal[3 * i] = r.nx; normal[3 * i + 1] = r.ny; normal[3 * i + 2] = r.nz;
  steps[i] = r.steps;
}

// The rays of a K1 or K4 walk, in one of three forms, and how a ray's
// result is stored (store(r, i, pos, normal, steps)):
//   PreparedRays: the ray setup done by the caller (start in chunk units,
//     normalized direction, active, edge pad); flags = hit | hit_imm << 1,
//     the fix-up left to the caller, position, normal and steps as
//     store_ray (no launcher: the host twins vx_trace_host and
//     vx_trace_brickmap_{dense,compact}_host, dda_host.cpp, which hold the
//     loop to the JAX kernels on their own prepared inputs);
//   OriginRays: origins (voxels) and raw directions, f32[n, 3] at a row
//     stride of 3, or 0 for one row shared by every ray (primary_rays
//     broadcasts the origin, or an orthographic frame's direction);
//     trace_ray_full does the setup and the fix-up; hit is one byte, 0 or 1,
//     the bool tensor the wrapper returns, the rest as store_ray (the
//     *_rays entries: ops/trace.py::TraceOut's fields);
//   OriginRaysRecord: OriginRays whose store writes the ray API's result
//     record (the *_record entries: engine/raytracer.py::RayTraceResults's
//     fields, below).
// (secondary.cuh's SecondaryRays is the fourth form: SECONDARY true, it
// builds its rays and stores its own outputs.)
struct PreparedRays {
  static constexpr bool SECONDARY = false;
  const float* start;
  const float* dir;
  const int* active;
  const int* pad;
  int* flags;

  template <bool MACRO, bool DIAG, class Fetch>
  VX_HD TraceResult trace(const TraceParams& P, const Fetch& F, int i, int* diag) const {
    return trace_ray<MACRO, DIAG>(P, F, ldgf(start + 3 * i), ldgf(start + 3 * i + 1),
                                  ldgf(start + 3 * i + 2), ldgf(dir + 3 * i), ldgf(dir + 3 * i + 1),
                                  ldgf(dir + 3 * i + 2), ldg(active + i), ldg(pad + 3 * i),
                                  ldg(pad + 3 * i + 1), ldg(pad + 3 * i + 2), diag);
  }
  VX_HD void store(const TraceResult& r, int i, float* pos, float* normal, int* steps) const {
    flags[i] = r.flags;
    store_ray(r, i, pos, normal, steps);
  }
};

struct OriginRays {
  static constexpr bool SECONDARY = false;
  const float* origins;
  int os;  // row stride: 3, or 0
  const float* rays;
  int rs;
  unsigned char* hit;

  template <bool MACRO, bool DIAG, class Fetch>
  VX_HD TraceResult trace(const TraceParams& P, const Fetch& F, int i, int* diag) const {
    const float* o = origins + (long long)os * i;
    const float* v = rays + (long long)rs * i;
    return trace_ray_full<MACRO, DIAG>(P, F, ldgf(o), ldgf(o + 1), ldgf(o + 2), ldgf(v), ldgf(v + 1),
                                       ldgf(v + 2), diag);
  }
  VX_HD void store(const TraceResult& r, int i, float* pos, float* normal, int* steps) const {
    hit[i] = (unsigned char)(r.flags & 1);
    store_ray(r, i, pos, normal, steps);
  }
};

// engine/raytracer.py::results_from_trace in the thread that walked the
// ray, on the walk's result r, with its arithmetic (each product and sum
// separately rounded, --fmad=false / -ffp-contract=off): `hit` (OriginRays')
// is `valid`, one byte; pos takes hit_point, the hit position or (inf, inf,
// inf) on a miss; normal and steps as store_ray; distance the IEEE square
// root of (o - p) . (o - p) summed x + y + z (core/exact.py's sqrt_rn of
// dot3: a float64 root rounded to float32 is the float32 root), 0 on a
// miss; voxel_index floor(p + 0.5 n) as int32, then z (X Y) + y X + x in
// uint32 arithmetic read as int32 (the wrap the plain version makes
// through int64 and a mask), 0 on a miss.  X and Y are the world's size in
// voxels.  The origin is read again here, after the walk, as the setup
// read it, so nothing of it is live across the walk's loop.
struct OriginRaysRecord : OriginRays {
  float* distance;
  int* voxel_index;
  int wx, wy;

  VX_HD void store(const TraceResult& r, int i, float* hit_point, float* normal, int* steps) const {
    const bool h = (r.flags & 1) != 0;
    hit[i] = (unsigned char)h;
    hit_point[3 * i] = h ? r.px : INFINITY;
    hit_point[3 * i + 1] = h ? r.py : INFINITY;
    hit_point[3 * i + 2] = h ? r.pz : INFINITY;
    normal[3 * i] = r.nx; normal[3 * i + 1] = r.ny; normal[3 * i + 2] = r.nz;
    steps[i] = r.steps;
    float dist = 0.0f;
    int index = 0;
    if (h) {
      const float* o = origins + (long long)os * i;
      const float dx = ldgf(o) - r.px, dy = ldgf(o + 1) - r.py, dz = ldgf(o + 2) - r.pz;
      dist = sqrtf(dx * dx + dy * dy + dz * dz);
      const unsigned cx = (unsigned)(int)floorf(r.px + 0.5f * r.nx);
      const unsigned cy = (unsigned)(int)floorf(r.py + 0.5f * r.ny);
      const unsigned cz = (unsigned)(int)floorf(r.pz + 0.5f * r.nz);
      const unsigned X = (unsigned)wx;
      index = (int)(cz * (X * (unsigned)wy) + cy * X + cx);
    }
    distance[i] = dist;
    voxel_index[i] = index;
  }
};

}  // namespace vx
