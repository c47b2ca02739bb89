// The record instantiation of K1's loop: one ray's walk with every
// iteration's state stored, the port's RECORD_INTERSECTED_POINTS
// (DDATestCpp.cpp:15-25) and the counterpart of
// voxelengine_tpu/ops/crossing_trace.py::trace_ray_crossings, which runs
// the TPU kernel's loop body (_trace_inner, diag build) on one ray.
//
// record_crossings runs dda.cuh's ray_init, then ray_iterate<MACRO, true>
// (the DIAG build, so the 10 counters are _trace_inner's) until the ray is
// done, and after every iteration stores one row of C_FIELDS int32 words
// (floats as their bit patterns) in the order of CrossingField.  K1 keeps
// no fine-walk state while the ray is at the coarse level, and no fine
// position or fine step count at all; the row carries them as
// _trace_inner's carry holds them:
//   - the coarse cell and tMax: the parked ones during a fine walk;
//   - the fine cell and tMax: the last ones of the most recent fine walk
//     (0 before the first descend), unchanged by an ascend or a hit;
//   - the point: the fine walk's start at a descend, the entry point of the
//     last fine step after one (rebuilt as ray_result rebuilds a hit's);
//   - fsteps: fine steps since the descend; bslot: the brick slot of the
//     most recent descend (0 before the first, as _trace_inner's carry starts);
//   - state: active | fine << 1 | hit << 2 | hit_imm << 3, after the
//     iteration (a hit leaves the fine level, as in _trace_inner).
// ops/crossing_trace.py turns these rows, one per K1 event, into
// _trace_inner's rows.  Every function is __host__ __device__: crossings.cu
// builds it for the card, dda_host.cpp for the host.
#pragma once

#include <string.h>

#include "dda.cuh"

namespace vx {

enum CrossingField {
  C_CCX, C_CCY, C_CCZ, C_CTX, C_CTY, C_CTZ,
  C_FCX, C_FCY, C_FCZ, C_FTX, C_FTY, C_FTZ,
  C_PX, C_PY, C_PZ, C_STEPS, C_FSTEPS, C_STATE, C_BSLOT,
  C_DIAG,  // D_STALL .. D_ADJSTALL, cumulative
  C_FIELDS = C_DIAG + D_ITERS
};

VX_HD int bits_of(float v) {
#ifdef __CUDA_ARCH__
  return __float_as_int(v);
#else
  int i;
  memcpy(&i, &v, sizeof i);
  return i;
#endif
}

// Record ray (sx..padz, as ray_init takes them) into rows[max_rows *
// C_FIELDS]; returns the number of rows written (0 for an inactive ray) and
// stores the ray's result, which is K1's for the same ray, in *res.
template <bool MACRO, class Fetch>
VX_HD int record_crossings(const TraceParams& P, const Fetch& F, float sx, float sy, float sz,
                           float dx, float dy, float dz, int active, int padx, int pady, int padz,
                           int max_rows, int* rows, TraceResult* res) {
  RayState S;
  const TraceResult none = {0, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0};
  *res = none;
  if (!ray_init(S, sx, sy, sz, dx, dy, dz, active, padx, pady, padz)) return 0;
  int diag[D_COUNT] = {};
  int fc[3] = {0, 0, 0}, fsteps = 0, bslot = 0;
  float ft[3] = {0.0f, 0.0f, 0.0f}, pt[3] = {0.0f, 0.0f, 0.0f};
  const int stx = dx > 0.0f ? 1 : -1, sty = dy > 0.0f ? 1 : -1, stz = dz > 0.0f ? 1 : -1;
  int n = 0;
  while (n < max_rows && S.it < P.iter_limit) {
    const bool was_fine = S.fine;
    const bool done = ray_iterate<MACRO, true>(P, F, S, diag);
    if (S.fine && !was_fine) {  // descend
      fsteps = 0;
      bslot = S.bbase / F.wpb;
      pt[0] = S.fsx; pt[1] = S.fsy; pt[2] = S.fsz;
    } else if (S.fine && !S.hit) {  // fine step: its entry point, as ray_result
      const int a = S.nrm & 3;
      ++fsteps;
      pt[0] = a == 0 ? (float)(stx > 0 ? S.cx : S.cx + 1) : S.fsx + S.tlast * S.dx;
      pt[1] = a == 1 ? (float)(sty > 0 ? S.cy : S.cy + 1) : S.fsy + S.tlast * S.dy;
      pt[2] = a == 2 ? (float)(stz > 0 ? S.cz : S.cz + 1) : S.fsz + S.tlast * S.dz;
    }
    int cc[3] = {S.cx, S.cy, S.cz};
    float ct[3] = {S.tx, S.ty, S.tz};
    if (S.fine) {
      fc[0] = S.cx; fc[1] = S.cy; fc[2] = S.cz;
      ft[0] = S.tx; ft[1] = S.ty; ft[2] = S.tz;
      cc[0] = S.ccx; cc[1] = S.ccy; cc[2] = S.ccz;
      ct[0] = S.ctx; ct[1] = S.cty; ct[2] = S.ctz;
    }
    int* r = rows + (long long)n * C_FIELDS;
    for (int k = 0; k < 3; ++k) {
      r[C_CCX + k] = cc[k];
      r[C_CTX + k] = bits_of(ct[k]);
      r[C_FCX + k] = fc[k];
      r[C_FTX + k] = bits_of(ft[k]);
      r[C_PX + k] = bits_of(pt[k]);
    }
    r[C_STEPS] = S.steps;
    r[C_FSTEPS] = fsteps;
    r[C_STATE] = (done ? 0 : 1) | (S.fine && !S.hit ? 2 : 0) | (S.hit ? 4 : 0) |
                 (S.hit && (S.nrm & NRM_IMM) ? 8 : 0);
    r[C_BSLOT] = bslot;
    for (int k = 0; k < D_ITERS; ++k) r[C_DIAG + k] = diag[k];
    ++n;
    if (done) break;
  }
  *res = ray_result(P, S);
  return n;
}

}  // namespace vx
