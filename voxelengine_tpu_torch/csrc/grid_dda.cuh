// Per-ray single-level DDA over a dense packed bit grid (K2, K3).
//
// The scalar form of voxelengine_tpu_torch/ops/trace.py::trace_grid and of
// the TPU kernels voxelengine_tpu/ops/pallas_trace.py::_grid_kernel_vpu and
// _grid_kernel (pallas_trace.py:93-197,329-435): from the world-clipped
// start, step cell by cell with the reference's tie-break
// (VolumeRaytracer.cu:293-313) and max-edge pad until an occupied cell
// (hit), leaving the grid (miss) or max_steps steps.  Where the TPU code
// writes BIG = 3.4e38 for a zero direction component this writes INFINITY,
// as trace_grid does.  trace_grid_full adds the wrapper's ray setup
// (ray_setup.cuh) before the walk and its zero-step fix-up after it, so one
// kernel computes trace_grid_vpu whole.
//
// The step is built as dda.cuh's for K1: the loop keeps no position or
// normal, only the last step's axis and crossing time, and rebuilds both
// once at the end with the same expressions; the advance is selects, not a
// three-way branch; the range test is one unsigned compare an axis; the bit
// index's layout is a template parameter; of the clamps only the upper one
// survives (a cell past the grid is in range only on a padded axis).
//
// The word fetch is a template parameter, the only difference between K2
// and K3:
//   WordFetch   (K2): words[w] from the int32 words, read through the
//                     read-only path on the card;
//   LimbFetch   (K3, global): four uint8 limb planes [4, R*128], the word
//                     rebuilt as b0 | b1 << 8 | b2 << 16 | b3 << 24
//                     (words_to_limb_rows) at every step;
//   SharedWordFetch (K3, staged): words[w] from a copy of the words that a
//                     block rebuilt from the planes once (limb_words16) into
//                     its shared memory: one shared load a step.
// The grid is read in its own layout, TILED_MORTON included, so no layout
// conversion precedes the kernel.
//
// Every function here is __host__ __device__ (see dda.cuh): nvcc builds it
// into gridtrace.cu, g++ into the host library of the CPU tests.
#pragma once

#include "dda.cuh"
#include "ray_setup.cuh"

namespace vx {

struct GridParams {
  int X, Y, Z;    // grid dims in voxels; X*Y*Z < 2^31 (the wrapper checks)
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
  VX_HD int operator()(int w) const { return ldg(words + w); }
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

struct SharedWordFetch {
  const int* words;  // shared memory on the card: a plain load
  VX_HD int operator()(int w) const { return words[w]; }
};

// The 16 bytes at p as four little-endian words: one 16-byte load on the
// card (p 16-byte aligned), four byte-assembled words on the host.
VX_HD void load16(const unsigned char* p, unsigned int* w) {
#ifdef __CUDA_ARCH__
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
#else
  for (int k = 0; k < 4; ++k)
    w[k] = p[4 * k] | (p[4 * k + 1] << 8) | (p[4 * k + 2] << 16) | ((unsigned int)p[4 * k + 3] << 24);
#endif
}

// Words 16q .. 16q+15 rebuilt from the four limb planes [4, plane] (plane a
// multiple of 16, the planes 16-byte aligned): one 16-byte load a plane,
// then word j = byte j of plane 0 | byte j of plane 1 << 8 | ... (the
// staging of K3's shared-memory instantiation).
VX_HD void limb_words16(const unsigned char* limbs, long long plane, int q, int* out) {
  unsigned int b[4][4];
  for (int k = 0; k < 4; ++k) load16(limbs + k * plane + 16LL * q, b[k]);
  for (int j = 0; j < 16; ++j) {
    const int s = (j & 3) * 8, i = j >> 2;
    out[j] = (int)(((b[0][i] >> s) & 0xFFu) | (((b[1][i] >> s) & 0xFFu) << 8) |
                   (((b[2][i] >> s) & 0xFFu) << 16) | (((b[3][i] >> s) & 0xFFu) << 24));
  }
}

// Trace one ray.  (sx, sy, sz) is the world-clipped start in voxel units,
// (dx, dy, dz) the normalized direction and (padx, pady, padz) the edge pad,
// all from the ray setup.  Position and normal are those of the last step
// (the start and 0 before any); trace_grid_full replaces them for a hit at
// the start cell.
template <int LAYOUT, class Fetch>
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
  // 0 <= c < dim + pad, as one unsigned compare an axis
  const unsigned hx = (unsigned)(P.X + padx), hy = (unsigned)(P.Y + pady),
                 hz = (unsigned)(P.Z + padz);
  int a = 0;          // axis of the last step
  float tlast = 0.0f; // its crossing time
  int steps = 0;
  // every pass either ends the ray or takes a step, and the budget ends it
  // after max_steps steps
  for (;;) {
    if (!((unsigned)cx < hx && (unsigned)cy < hy && (unsigned)cz < hz)) break;  // miss
    const int bit = sample_index_t<LAYOUT>(mini(cx, P.X - 1), mini(cy, P.Y - 1),
                                           mini(cz, P.Z - 1), P.X, P.Y);
    if ((F(bit >> 5) >> (bit & 31)) & 1) {
      r.hit = 1;
      break;
    }
    a = axis_pick(tx, ty, tz);
    tlast = pick3(a, tx, ty, tz);
    cx += a == 0 ? stx : 0;
    cy += a == 1 ? sty : 0;
    cz += a == 2 ? stz : 0;
    tx = a == 0 ? tx + tdx : tx;
    ty = a == 1 ? ty + tdy : ty;
    tz = a == 2 ? tz + tdz : tz;
    if (++steps >= P.max_steps) break;
  }
  r.steps = steps;
  if (steps > 0) {
    // the entry point of the last step: the crossed face on its axis (the
    // cell it left, on the side it crossed), start + tlast * d on the others
    r.px = a == 0 ? (float)(stx > 0 ? cx : cx + 1) : sx + tlast * dx;
    r.py = a == 1 ? (float)(sty > 0 ? cy : cy + 1) : sy + tlast * dy;
    r.pz = a == 2 ? (float)(stz > 0 ? cz : cz + 1) : sz + tlast * dz;
    r.nx = a == 0 ? (float)stx : 0.0f;
    r.ny = a == 1 ? (float)sty : 0.0f;
    r.nz = a == 2 ? (float)stz : 0.0f;
  }
  return r;
}

// trace_grid_vpu for one ray (ops/gridtrace.py): the ray setup from the
// origin and the raw direction, the walk, and the zero-step fix-up (a hit at
// the start cell reports the clipped start, which the walk already holds,
// and the world-entry normal; pallas_trace.py:538-544).
template <int LAYOUT, class Fetch>
VX_HD GridResult trace_grid_full(const GridParams& P, const Fetch& F, float ox, float oy, float oz,
                                 float vx, float vy, float vz) {
  const RaySetup s = ray_setup(ox, oy, oz, vx, vy, vz, 1, P.X, P.Y, P.Z);
  GridResult r = trace_grid_ray<LAYOUT>(P, F, s.sx, s.sy, s.sz, s.dx, s.dy, s.dz, s.active,
                                        s.padx, s.pady, s.padz);
  if (r.hit && r.steps == 0) {
    r.nx = s.snx; r.ny = s.sny; r.nz = s.snz;
  }
  return r;
}

// A layout as a type, for with_layout.
template <int V>
struct LayoutTag {
  static constexpr int value = V;
};

// fn(LayoutTag<L>{}) for the runtime layout L: the host's choice of a
// kernel's layout instantiation.
template <class Fn>
inline int with_layout(int layout, Fn&& fn) {
  if (layout == LAYOUT_LINEAR) return fn(LayoutTag<LAYOUT_LINEAR>{});
  if (layout == LAYOUT_TILED_MORTON) return fn(LayoutTag<LAYOUT_TILED_MORTON>{});
  return fn(LayoutTag<LAYOUT_TILED_LINEAR>{});
}

}  // namespace vx
