// Per-ray single-level DDA over a dense packed bit grid (K2, K3).
//
// The scalar form of voxelengine_tpu_torch/ops/trace.py::trace_grid and of
// the TPU kernels voxelengine_tpu/ops/pallas_trace.py::_grid_kernel_vpu and
// _grid_kernel (pallas_trace.py:93-197,329-435): from the world-clipped
// start, step cell by cell with the reference's tie-break
// (VolumeRaytracer.cu:293-313) and max-edge pad until an occupied cell
// (hit), leaving the grid (miss) or max_steps steps.  Where the TPU code
// writes BIG = 3.4e38 for a zero direction component this writes INFINITY,
// as trace_grid does.
//
// The word fetch is a template parameter, the only difference between K2
// and K3:
//   WordFetch  (K2): words[w] from the int32 words;
//   LimbFetch  (K3): four uint8 limb planes [4, R*128], the word rebuilt as
//                    b0 | b1 << 8 | b2 << 16 | b3 << 24 (words_to_limb_rows).
// The grid is read in its own layout, TILED_MORTON included, so no layout
// conversion precedes the kernel.
//
// Every function here is __host__ __device__ (see dda.cuh): nvcc builds it
// into gridtrace.cu, g++ into the host library of the CPU tests.
#pragma once

#include "dda.cuh"

namespace vx {

struct GridParams {
  int X, Y, Z;    // grid dims in voxels; X*Y*Z < 2^31 (the wrapper checks)
  int layout;     // BrickLayout of the bit index
  int max_steps;  // step budget
};

struct GridResult {
  int hit;
  float px, py, pz;
  float nx, ny, nz;
  int steps;
};

struct WordFetch {
  const int* words;
  VX_HD int operator()(int w) const { return words[w]; }
};

struct LimbFetch {
  const unsigned char* limbs;  // [4, plane]
  long long plane;             // words per limb plane (R * 128)
  VX_HD int operator()(int w) const {
    const unsigned int b0 = limbs[w], b1 = limbs[plane + w], b2 = limbs[2 * plane + w],
                       b3 = limbs[3 * plane + w];
    return (int)(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
  }
};

// Trace one ray.  (sx, sy, sz) is the world-clipped start in voxel units,
// (dx, dy, dz) the normalized direction and (padx, pady, padz) the edge pad,
// all from the wrapper's ray setup.  Position and normal are those of the
// last step; the wrapper replaces them for a hit at the start cell.
template <class Fetch>
VX_HD GridResult trace_grid_ray(const GridParams& P, const Fetch& F,
                                float sx, float sy, float sz, float dx, float dy, float dz,
                                int active, int padx, int pady, int padz) {
  GridResult r = {0, sx, sy, sz, 0.0f, 0.0f, 0.0f, 0};
  if (!active) return r;
  const int stx = dx > 0.0f ? 1 : -1, sty = dy > 0.0f ? 1 : -1, stz = dz > 0.0f ? 1 : -1;
  const float tdx = dx != 0.0f ? fabsf(1.0f / dx) : INFINITY;
  const float tdy = dy != 0.0f ? fabsf(1.0f / dy) : INFINITY;
  const float tdz = dz != 0.0f ? fabsf(1.0f / dz) : INFINITY;
  int cx = (int)sx, cy = (int)sy, cz = (int)sz;  // trunc toward zero
  float tx = init_tmax(cx, stx, sx, dx);
  float ty = init_tmax(cy, sty, sy, dy);
  float tz = init_tmax(cz, stz, sz, dz);
  // every pass either ends the ray or takes a step, and the budget ends it
  // after max_steps steps
  for (;;) {
    const bool in_range = cx >= 0 && cx < P.X + padx && cy >= 0 && cy < P.Y + pady &&
                          cz >= 0 && cz < P.Z + padz;
    if (!in_range) break;  // left the grid: miss
    const int bit = sample_index(clampi(cx, 0, P.X - 1), clampi(cy, 0, P.Y - 1),
                                 clampi(cz, 0, P.Z - 1), P.X, P.Y, P.layout);
    if ((F(bit >> 5) >> (bit & 31)) & 1) {
      r.hit = 1;
      break;
    }
    const int a = axis_pick(tx, ty, tz);
    const float tc = a == 0 ? tx : (a == 1 ? ty : tz);
    r.px = a == 0 ? (float)(cx + (stx > 0 ? 1 : 0)) : sx + tc * dx;
    r.py = a == 1 ? (float)(cy + (sty > 0 ? 1 : 0)) : sy + tc * dy;
    r.pz = a == 2 ? (float)(cz + (stz > 0 ? 1 : 0)) : sz + tc * dz;
    if (a == 0) { cx += stx; tx = tx + tdx; }
    else if (a == 1) { cy += sty; ty = ty + tdy; }
    else { cz += stz; tz = tz + tdz; }
    r.nx = a == 0 ? (float)stx : 0.0f;
    r.ny = a == 1 ? (float)sty : 0.0f;
    r.nz = a == 2 ? (float)stz : 0.0f;
    if (++r.steps >= P.max_steps) break;
  }
  return r;
}

}  // namespace vx
