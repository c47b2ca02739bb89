// One round of the z-sharded walk for one ray: K4-slab's per-ray logic
// (zslab.cu) and its host build (dda_host.cpp).
//
// A world partitioned into coarse-z slabs, one per rank, traces each ray on
// the rank whose slab holds its coarse cell
// (voxelengine_tpu_torch/parallel/distributed.py).  A round runs dda.cuh's
// loop (ray_iterate, K4's DenseSlotFetch addressing) against the rank's slab
// and stops a ray when it hits, leaves the grid, spends its budget or
// reaches the slab's boundary: then the ray PAUSES with its RayState intact,
// and the neighbour slab resumes it in the next round from that state.  The
// plain version is voxelengine_tpu_torch/ops/trace.py::run_slab, the JAX
// package's _run_loop(slab=) (voxelengine_tpu/ops/trace.py:221-262).
//
// Where the pause goes: at the top of an iteration, before ray_iterate reads
// any table word.  The loop fuses an ascend with its coarse step, and a
// coarse step may leave the slab; the cell it enters is read in the NEXT
// iteration, which this check stops first.  A fine walk never pauses: its
// chunk is in the slab.  A coarse cell outside the full grid (with its edge
// pads) is not paused: ray_iterate ends the ray there as a miss, as the whole
// grid would.  The edge pad cell cz == gz belongs to the last slab, which
// reads it clamped as the whole grid does.  The answer depends only on the
// level and the coarse cell, and only its z can turn it from stay to pause
// (a step in x or y keeps the slab, or leaves the grid, which is no pause):
// so slab_walk asks before a ray's first iteration and after each iteration
// that ends at the coarse level in another coarse z than it started from
// (a coarse step in z, or an ascend whose step is in z), and nowhere else.
//
// A paused ray travels as STATE_WORDS int32 words (floats bitcast, the
// flags packed): the whole RayState, so the resumed walk is the one the
// single-device walk would have run.  Its iteration count restarts at each
// round, as the JAX loop's does.  A ray that is done writes no state row.
//
// The batch form (zslab.cu's vx_zslab_rays; ray_setup.cuh): round 0 takes
// the whole batch's origins and raw directions, sets every ray up over the
// whole grid and walks only the rays whose entry cell lies in the slab
// (slab_owns, the ownership of parallel/distributed.py), and a ray that is
// done gets the hit_imm fix-up (ray_setup.cuh::fix_hit_imm, its setup
// computed again from the batch's origin and direction); a later round
// takes the handed-on state rows with each ray's index in the batch (a
// handed-on ray has taken a step, so it cannot end at its entry cell and
// needs no fix-up).  A ray that is done is stored at its index in the
// batch.
#pragma once

#include <string.h>

#include "dda.cuh"
#include "ray_setup.cuh"

namespace vx {

// One ray's state on the wire (pack_state below); status codes of a round.
constexpr int STATE_WORDS = 35;
// SLAB_OTHER: a batch-form ray another slab owns (or none: it misses the grid).
enum SlabStatus { SLAB_DONE = 0, SLAB_PAUSED = 1, SLAB_OTHER = 2 };

// The rank's slab of a LINEAR dense-slot world: chunks (x, y, z0 .. z0 +
// slab_gz - 1), meta and bricks indexed by the slab-local chunk index.
struct SlabFetch {
  const int* meta;
  const int* bricks;
  int gx, gy;      // chunk grid (x, y)
  int z0, slab_gz; // the slab's first chunk row and its depth
  int wpb;         // words per brick
  VX_HD int cell(int cx, int cy, int cz) const {
    return cx + gx * (cy + gy * clampi(cz - z0, 0, slab_gz - 1));
  }
  VX_HD int load(bool fine, int i) const { return ldg((fine ? bricks : meta) + i); }
  VX_HD int brick_base(int c) const { return c * wpb; }
};

// Whether the ray pauses before its next iteration: a coarse cell inside
// the full grid (edge pads included) whose z is not the slab's.
VX_HD bool slab_pause(const TraceParams& P, const SlabFetch& F, const RayState& S) {
  if (S.fine) return false;
  const bool in_range = (unsigned)S.cx < (unsigned)(P.gx + (S.cpad & 1)) &&
                        (unsigned)S.cy < (unsigned)(P.gy + ((S.cpad >> 1) & 1)) &&
                        (unsigned)S.cz < (unsigned)(P.gz + (S.cpad >> 2));
  const bool last = F.z0 + F.slab_gz == P.gz;
  const bool resident = (S.cz >= F.z0 && S.cz < F.z0 + F.slab_gz) || (last && S.cz == P.gz);
  return in_range && !resident;
}

VX_HD int f2i(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_int(f);
#else
  int i;
  memcpy(&i, &f, sizeof i);
  return i;
#endif
}

VX_HD float i2f(int i) {
#ifdef __CUDA_ARCH__
  return __int_as_float(i);
#else
  float f;
  memcpy(&f, &i, sizeof f);
  return f;
#endif
}

// RayState <-> STATE_WORDS words, in the struct's order.
VX_HD void pack_state(const RayState& S, int* w) {
  const float fl[] = {S.sx, S.sy, S.sz, S.dx, S.dy, S.dz, S.ivx, S.ivy, S.ivz, S.tdx, S.tdy, S.tdz};
  for (int k = 0; k < 12; ++k) w[k] = f2i(fl[k]);
  w[12] = S.cpad;
  w[13] = S.cx; w[14] = S.cy; w[15] = S.cz;
  w[16] = f2i(S.tx); w[17] = f2i(S.ty); w[18] = f2i(S.tz);
  w[19] = f2i(S.tlast);
  w[20] = S.ccx; w[21] = S.ccy; w[22] = S.ccz;
  w[23] = f2i(S.ctx); w[24] = f2i(S.cty); w[25] = f2i(S.ctz);
  w[26] = (S.fine ? 1 : 0) | (S.paired ? 2 : 0) | (S.hit ? 4 : 0);
  w[27] = S.steps;
  w[28] = S.bbase;
  w[29] = S.fpad;
  w[30] = S.nrm;
  w[31] = f2i(S.fsx); w[32] = f2i(S.fsy); w[33] = f2i(S.fsz);
  w[34] = S.it;
}

VX_HD void unpack_state(RayState& S, const int* w) {
  S.sx = i2f(w[0]); S.sy = i2f(w[1]); S.sz = i2f(w[2]);
  S.dx = i2f(w[3]); S.dy = i2f(w[4]); S.dz = i2f(w[5]);
  S.ivx = i2f(w[6]); S.ivy = i2f(w[7]); S.ivz = i2f(w[8]);
  S.tdx = i2f(w[9]); S.tdy = i2f(w[10]); S.tdz = i2f(w[11]);
  S.cpad = w[12];
  S.cx = w[13]; S.cy = w[14]; S.cz = w[15];
  S.tx = i2f(w[16]); S.ty = i2f(w[17]); S.tz = i2f(w[18]);
  S.tlast = i2f(w[19]);
  S.ccx = w[20]; S.ccy = w[21]; S.ccz = w[22];
  S.ctx = i2f(w[23]); S.cty = i2f(w[24]); S.ctz = i2f(w[25]);
  S.fine = w[26] & 1; S.paired = (w[26] >> 1) & 1; S.hit = (w[26] >> 2) & 1;
  S.steps = w[27];
  S.bbase = w[28];
  S.fpad = w[29];
  S.nrm = w[30];
  S.fsx = i2f(w[31]); S.fsy = i2f(w[32]); S.fsz = i2f(w[33]);
  S.it = w[34];
}

// Run a started or resumed ray until it is done or pauses at the slab's
// boundary (module note: the pause is asked only where its answer can
// change); returns SlabStatus.
VX_HD int slab_walk(const TraceParams& P, const SlabFetch& F, RayState& S) {
  if (slab_pause(P, F, S)) return SLAB_PAUSED;
  for (;;) {
    const int cz = S.fine ? S.ccz : S.cz;  // the coarse z before the iteration
    if (ray_iterate(P, F, S)) return SLAB_DONE;
    if (!S.fine && S.cz != cz && slab_pause(P, F, S)) return SLAB_PAUSED;
  }
}

// One ray's round.  `in` is the ray's handed-on state (STATE_WORDS words;
// its iteration count restarts), or null to start the ray from the ray
// setup's start, direction, active flag and edge pad, as K4 does.  A ray
// that pauses writes its state to `out`; a ray that is done writes its
// result to `r` (zeros for a ray that never started) and leaves `out` as it
// was.  Returns SlabStatus.
VX_HD int slab_round(const TraceParams& P, const SlabFetch& F, const int* in, const float* start,
                     const float* dir, int active, const int* pad, int* out, TraceResult& r) {
  RayState S;
  const TraceResult none = {0, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0};
  r = none;
  if (in != nullptr) {
    unpack_state(S, in);
    S.it = 0;
  } else if (!ray_init(S, start[0], start[1], start[2], dir[0], dir[1], dir[2], active, pad[0], pad[1],
                       pad[2])) {
    return SLAB_DONE;
  }
  const int status = slab_walk(P, F, S);
  if (status == SLAB_PAUSED)
    pack_state(S, out);
  else
    r = ray_result(P, S);
  return status;
}

// Whether this slab owns a ray whose set-up start lies at chunk-unit z
// `sz`: the slab of its entry cell (int)sz, floor-divided by the slab's
// depth and clamped into the grid's slabs, as parallel/distributed.py's
// ownership computes it.
VX_HD bool slab_owns(const TraceParams& P, const SlabFetch& F, float sz) {
  const int cz = (int)sz;
  int q = cz / F.slab_gz;
  if (cz % F.slab_gz != 0 && cz < 0) --q;
  return clampi(q, 0, P.gz / F.slab_gz - 1) == F.z0 / F.slab_gz;
}

// Round 0 of a batch-form ray given by `ray(o, v)` (its origin in voxels
// and raw direction): the ray setup over the whole grid and, for a ray this
// slab owns, slab_round's walk; a paused ray's state goes to `out`, a ray
// that is done gets the hit_imm fix-up in r.  Returns SlabStatus,
// SLAB_OTHER (nothing written) for a ray the slab does not own.
template <class Ray>
VX_HD int slab_round_rays(const TraceParams& P, const SlabFetch& F, const Ray& ray, int* out, TraceResult& r) {
  RayState S;
  {
    float o[3], v[3];
    ray(o, v);
    const RaySetup s = ray_setup(o[0], o[1], o[2], v[0], v[1], v[2], P.factor, P.gx, P.gy, P.gz);
    if (!s.active || !slab_owns(P, F, s.sz)) return SLAB_OTHER;
    ray_init(S, s.sx, s.sy, s.sz, s.dx, s.dy, s.dz, s.active, s.padx, s.pady, s.padz);
  }
  const int status = slab_walk(P, F, S);
  if (status == SLAB_PAUSED) {
    pack_state(S, out);
    return status;
  }
  r = ray_result(P, S);
  fix_hit_imm(P, ray, r);
  return status;
}

}  // namespace vx
