// The shading's secondary rays of one primary ray, built, walked and
// reduced in one thread: K1's and K4's secondary entries (bigtrace.cu,
// bmtrace.cu) and their host twins (dda_host.cpp).
//
// It has no TPU kernel of its own: the JAX package builds these rays and
// reduces AO with XLA ops fused around the Pallas K1 in its jitted frame
// (voxelengine_tpu/render/frame.py:245-293, 378-420).  Its plain version is
// ops/secondary.py::secondary_plain, the eager body the CPU runs.  Per kind,
// in the plain version's order, every float op rounded as it rounds it
// (nvcc --fmad=false without fast-math, g++ -ffp-contract=off):
//   - SHADOW: origin position + L * 0.01 (L * 0.01 first, as torch), the
//     direction L as given (the walk normalizes it), cfg.max_steps; writes
//     (hit, steps);
//   - REFLECTION: n = -normal (Renderer.cu:212), direction
//     i - (2 n) (n . i) (render/shading.py::reflect), origin position +
//     n * 0.01, cfg.max_steps; writes (hit, position, normal);
//   - AO: for sample s, seed py * W + px + s * 1000 + (frame + 1) * 7919 as
//     uint32 (the int32 wrap), random_float of seed, seed * 10, seed * 100
//     (noise.cuh) times 2 minus 1, divided by its correctly rounded length,
//     reflected where (sd . n) < 0, walked 8 steps from position + n * 0.01;
//     falloff 1 - min(1 / max(|hit - position| * 10, 1e-6), 1) on a hit,
//     else 1, summed in sample order from 0, divided by ao_samples; writes
//     that factor (f32).
// Each walk is the rays entries' (ray_setup.cuh::trace_ray_of: the setup,
// the walk, the hit_imm fix-up), with less of the ray live across it than
// they keep: the position, normal and pixel are read again where needed (L1
// holds them), and the AO loop keeps its sum, the sample index and the
// fix-up's position.
//
// The ray builders (shadow_ray, reflection_ray, ao_sample) and the AO
// falloff (ao_falloff) are also secondary.cu's, which builds a kind's rays
// for a caller's tracer and reduces AO's samples from what it returns
// (secondary_build_ray, secondary_ao below): the fused entries and those
// two share this one source.
#pragma once

#include <stdint.h>

#include "noise.cuh"
#include "ray_setup.cuh"
#include "shade.cuh"

namespace vx {

// The kinds (kernels/build.py::SECONDARY_KINDS, in this order).
enum SecondaryKind { SEC_SHADOW = 0, SEC_REFLECTION = 1, SEC_AO = 2 };

// A secondary launch's inputs and outputs (device memory on the card).
struct SecondaryArgs {
  const float* pos;    // the primary trace's position, f32[n, 3]
  const float* nrm;    // its normal, the trace's sign convention
  const float* dirs;   // the primary rays' raw directions (REFLECTION), row stride ds: 3 or 0
  int ds;
  const int64_t* px;   // the final pixel (AO's seed)
  const int64_t* py;
  const float* light;  // f32[3], the Environment's light direction (SHADOW)
  int width;
  uint32_t seed_frame;  // (frame + 1) * 7919 mod 2^32
  int ao_samples;
  unsigned char* hit;  // SHADOW, REFLECTION: one byte a ray, 0 or 1
  float* out_pos;      // REFLECTION: f32[n, 3]
  float* out_nrm;      // REFLECTION: f32[n, 3]
  int* steps;          // SHADOW: i32[n]
  float* ao;           // AO: f32[n]
};

// The shadow ray of the primary ray whose position is p: origin p + L *
// 0.01 (L * 0.01 rounded first), direction L.
VX_HD void shadow_ray(const SecondaryArgs& A, const float* p, float* o, float* v) {
  for (int k = 0; k < 3; ++k) v[k] = ldgf(A.light + k);
  for (int k = 0; k < 3; ++k) o[k] = ldgf(p + k) + v[k] * 0.01f;
}

// The mirror bounce of primary ray i (position p): n = -normal, direction
// i - (2 n) (n . i) of the ray's raw direction, origin p + n * 0.01.
VX_HD void reflection_ray(const SecondaryArgs& A, const float* p, int i, float* o, float* v) {
  const float* m = A.nrm + 3 * (long long)i;
  const float* dir = A.dirs + (long long)A.ds * i;
  float n[3], d[3];
  for (int k = 0; k < 3; ++k) n[k] = -ldgf(m + k);
  for (int k = 0; k < 3; ++k) d[k] = ldgf(dir + k);
  reflect3(d, n, v);
  for (int k = 0; k < 3; ++k) o[k] = ldgf(p + k) + n[k] * 0.01f;
}

// AO sample s of ray i: its origin o and direction sd (normalized,
// flipped into the normal's hemisphere).
VX_HD void ao_sample(const SecondaryArgs& A, int i, int s, float* o, float* sd) {
  const float* p = A.pos + 3 * (long long)i;
  const float* m = A.nrm + 3 * (long long)i;
  const uint32_t seed = (uint32_t)((uint64_t)A.py[i] * (uint64_t)(int64_t)A.width + (uint64_t)A.px[i]);
  const uint32_t si = seed + (uint32_t)s * 1000u + A.seed_frame;
  sd[0] = random_float(si) * 2.0f - 1.0f;
  sd[1] = random_float(si * 10u) * 2.0f - 1.0f;
  sd[2] = random_float(si * 100u) * 2.0f - 1.0f;
  const float len = sqrtf(dot3f(sd, sd));
  for (int k = 0; k < 3; ++k) sd[k] = sd[k] / len;
  float n[3];
  for (int k = 0; k < 3; ++k) n[k] = -ldgf(m + k);
  if (dot3f(sd, n) < 0.0f) {
    float t[3];
    reflect3(sd, n, t);
    for (int k = 0; k < 3; ++k) sd[k] = t[k];
  }
  for (int k = 0; k < 3; ++k) o[k] = ldgf(p + k) + n[k] * 0.01f;
}

// What an AO sample that hit at (hx, hy, hz) adds for the primary position
// p: 1 - min(1 / max(|h - p| * 10, 1e-6), 1) (a miss adds 1).
VX_HD float ao_falloff(float hx, float hy, float hz, const float* p) {
  const float v3[3] = {hx - ldgf(p), hy - ldgf(p + 1), hz - ldgf(p + 2)};
  const float dist = sqrtf(dot3f(v3, v3));
  return 1.0f - clamp_max_t(1.0f / clamp_min_t(dist * 10.0f, 1e-6f), 1.0f);
}

// Ray i's kind of secondary rays, walked and stored.  A shadow or
// reflection ray is built by a function that trace_ray_of calls again for
// the hit_imm fix-up, so nothing of it stays live across the walk; an AO
// ray keeps the three floats of the fix-up's position instead (its hash
// costs more to redo than they to keep).
template <int KIND, bool MACRO, class Fetch>
VX_HD void secondary_ray(const TraceParams& P, const Fetch& F, const SecondaryArgs& A, int i) {
  const float* p = A.pos + 3 * (long long)i;
  if constexpr (KIND == SEC_SHADOW) {
    const TraceResult r = trace_ray_of<MACRO>(P, F, [&](float* o, float* v) { shadow_ray(A, p, o, v); });
    A.hit[i] = (unsigned char)(r.flags & 1);
    A.steps[i] = r.steps;
  } else if constexpr (KIND == SEC_REFLECTION) {
    const TraceResult r = trace_ray_of<MACRO>(P, F, [&](float* o, float* v) { reflection_ray(A, p, i, o, v); });
    A.hit[i] = (unsigned char)(r.flags & 1);
    float* op = A.out_pos + 3 * (long long)i;
    float* on = A.out_nrm + 3 * (long long)i;
    op[0] = r.px; op[1] = r.py; op[2] = r.pz;
    on[0] = r.nx; on[1] = r.ny; on[2] = r.nz;
  } else {
    float occ = 0.0f;
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int s = 0; s < A.ao_samples; ++s) {
      float o[3], v[3];
      ao_sample(A, i, s, o, v);
      const RaySetup st = ray_setup(o[0], o[1], o[2], v[0], v[1], v[2], P.factor, P.gx, P.gy, P.gz);
      // the hit_imm fix-up's position (trace_ray_of's; AO reads no normal),
      // three floats live across the walk in place of the ray
      const float ff = (float)P.factor;
      const float hx = st.sx * ff, hy = st.sy * ff, hz = st.sz * ff;
      const TraceResult r = trace_ray<MACRO>(P, F, st.sx, st.sy, st.sz, st.dx, st.dy, st.dz, st.active,
                                             st.padx, st.pady, st.padz);
      float add = 1.0f;
      if (r.flags & 1) {
        const bool imm = r.flags & 2;
        add = ao_falloff(imm ? hx : r.px, imm ? hy : r.py, imm ? hz : r.pz, p);
      }
      occ = occ + add;
    }
    A.ao[i] = occ / (float)A.ao_samples;
  }
}

// The rays a kind traces for n primary rays, as secondary.cu builds them
// for a caller's tracer: ray j of M (M = n for SHADOW and REFLECTION, n *
// ao_samples for AO) is kind's ray of primary ray j, or for AO sample s = j
// / n of primary ray j % n (sample-major: the n rays of sample 0, then of
// sample 1, ...).  Writes its origin o and raw direction v.
VX_HD void secondary_build_ray(int kind, const SecondaryArgs& A, int n, long long j, float* o, float* v) {
  if (kind == SEC_AO) {
    ao_sample(A, (int)(j % n), (int)(j / n), o, v);
  } else if (kind == SEC_SHADOW) {
    shadow_ray(A, A.pos + 3 * j, o, v);
  } else {
    reflection_ray(A, A.pos + 3 * j, (int)j, o, v);
  }
}

// Primary ray i's AO factor (its position: pos + 3 i) from a caller's
// trace of secondary_build_ray's AO rays (hit one byte, position f32[M,
// 3]): the falloff of samples 0, 1,
// ... summed in that order and divided by ao_samples, as the fused entries
// reduce it.  A shadow or a reflection needs no reduce: what shading reads
// of it is the trace's own hit, steps, position and normal.
VX_HD float secondary_ao(const float* pos, int ao_samples, const unsigned char* t_hit, const float* t_pos, int n,
                         int i) {
  const float* p = pos + 3 * (long long)i;
  float occ = 0.0f;
  for (int s = 0; s < ao_samples; ++s) {
    const long long j = (long long)s * n + i;
    float add = 1.0f;
    if (t_hit[j]) add = ao_falloff(t_pos[3 * j], t_pos[3 * j + 1], t_pos[3 * j + 2], p);
    occ = occ + add;
  }
  return occ / (float)ao_samples;
}

// The rays of a secondary launch (ray_setup.cuh's PreparedRays and
// OriginRays are the other forms): the kernels call run() where the other
// forms trace and store.
template <int KIND>
struct SecondaryRays {
  static constexpr bool SECONDARY = true;
  SecondaryArgs A;

  template <bool MACRO, class Fetch>
  VX_HD void run(const TraceParams& P, const Fetch& F, int i) const {
    secondary_ray<KIND, MACRO>(P, F, A, i);
  }
};

// body(SecondaryRays<kind>{A}); an unknown kind returns 1
// (cudaErrorInvalidValue).
template <class Body>
inline int with_secondary_kind(int kind, const SecondaryArgs& A, const Body& body) {
  switch (kind) {
    case SEC_SHADOW: return body(SecondaryRays<SEC_SHADOW>{A});
    case SEC_REFLECTION: return body(SecondaryRays<SEC_REFLECTION>{A});
    case SEC_AO: return body(SecondaryRays<SEC_AO>{A});
  }
  return 1;
}

}  // namespace vx

// The secondary entries' arguments (bigtrace.cu, bmtrace.cu, dda_host.cpp):
// the kind and SecondaryArgs' inputs first, its outputs last.
#define VX_SECONDARY_PARAMS                                                                                 \
  int kind, const float *pos, const float *nrm, const float *dirs, int ds, const int64_t *px,             \
      const int64_t *py, const float *light, int width, int seed_frame, int ao_samples
#define VX_SECONDARY_OUTS unsigned char *hit, float *out_pos, float *out_nrm, int *steps, float *ao
#define VX_SECONDARY_ARGS                                                                                   \
  vx::SecondaryArgs {                                                                                       \
    pos, nrm, dirs, ds, px, py, light, width, (uint32_t)seed_frame, ao_samples, hit, out_pos, out_nrm,    \
        steps, ao                                                                                           \
  }
// SecondaryArgs of VX_SECONDARY_PARAMS alone, no outputs (secondary.cu's build entry).
#define VX_SECONDARY_IN_ARGS                                                                                \
  vx::SecondaryArgs {                                                                                       \
    pos, nrm, dirs, ds, px, py, light, width, (uint32_t)seed_frame, ao_samples, nullptr, nullptr, nullptr, \
        nullptr, nullptr                                                                                    \
  }
